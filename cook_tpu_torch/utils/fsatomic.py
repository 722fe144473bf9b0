"""The port's copy of ``cook_tpu/utils/fsatomic.py`` (imports re-rooted).

Atomic durable small-file writes shared by the fencing machinery.

Three components persist a monotonic counter with identical durability
needs — the store's shared-dir epoch claim, the elector's election-epoch
mint, and the journal write-generation bump.  One implementation keeps
the ordering rule (write temp → flush → fsync → rename) in one place.

Locking contract: these helpers fsync and therefore BLOCK.  The one
caller allowed to invoke them while holding a named lock is the store's
checkpoint/fence path under the ``store`` lock — an allowlisted
blocking-under-lock site, because snapshot-then-truncate must be atomic
against concurrent writers.  The global lock-order contract (which lock
may nest inside which, and which blocking ops are allowed where) has
ONE home: the ``cook_tpu/utils/locks.py`` module docstring and its
``ALLOWED_BLOCKING`` table (docs/ANALYSIS.md) — it used to live only in
CHANGES.md prose.  ``cs lint`` enforces the static half; the tier-1
lock sanitizer enforces it at runtime.
"""

from __future__ import annotations

import os
from typing import Optional


def read_int_file(path: str, default: Optional[int] = None
                  ) -> Optional[int]:
    """The integer in ``path``, or ``default`` when missing/corrupt."""
    try:
        with open(path, encoding="utf-8") as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return default


def write_atomic_text(path: str, text: str) -> None:
    """Durably replace ``path`` with ``text``: temp file, fsync, rename,
    fsync of the containing directory.  A power loss leaves either the
    old or the new content, never a torn or REGRESSED one — POSIX does
    not guarantee the rename itself survives power loss without the
    directory fsync.

    The temp name is writer-unique (pid + thread id): two concurrent
    writers of the SAME path (e.g. the elector's position-publisher
    thread racing the promotion path on one candidate file) must each
    rename their own temp — a shared ``.tmp`` name let one writer's
    os.replace consume the other's temp file and crash it with
    FileNotFoundError.  The temp is DOT-PREFIXED: consumers that scan
    directories by filename prefix (the elector's candidate sidecars)
    must never parse a crash-orphaned temp as a live entry."""
    import threading
    head, tail = os.path.split(path)
    tmp = os.path.join(
        head, f".{tail}.tmp.{os.getpid()}.{threading.get_ident()}")
    # lazy import: fsatomic must stay import-light (the fencing paths
    # pull it in before most of the package exists)
    from .faults import injector as _faults
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            _faults.fire(
                "fsatomic.fsync",
                lambda: OSError(5, "injected fsync failure on "
                                   "atomic-write temp"))
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # unique temp names are never reused by later writers, so a
        # failed write must clean its own up or they accumulate
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # some filesystems refuse directory fsync; best effort


def write_atomic_int(path: str, value: int) -> None:
    """:func:`write_atomic_text` for the monotonic counters (election
    epochs, journal generations) that must never regress across
    crashes."""
    write_atomic_text(path, str(value))
