"""The port's copy of ``cook_tpu/state/integrity.py`` (imports re-rooted).

WAL v2 integrity envelope: CRC32C-sealed, length-framed journal lines.

Every durability argument before this module rested on the torn-*tail*
excision discipline: a crash can only truncate the journal, so replay
stops at the first unparseable line and excises it.  ALICE (OSDI'14)
showed that crash-consistency protocols break at byte boundaries nobody
tested, and a mid-file bit-flip, a short write that still parses, or a
lying fsync ("Can Applications Recover from fsync Failures?", ATC'20)
all *pass* the torn-tail check while silently discarding every record
after the damage.  This module closes that hole:

- :func:`seal_record` wraps one journal record in a **v2 frame**::

      v2 <payload-bytes> <crc32c-hex> <json-payload>\\n

  The length field makes a short write detectable even when the
  truncated JSON happens to parse; the CRC32C (Castagnoli, the iSCSI /
  ext4 / Btrfs polynomial) catches bit rot.  ``json.dumps`` never emits
  raw newlines, so the one-line-per-record journal shape (and every
  newline-based offset scan, e.g. replication's
  ``_trimmed_journal_bytes``) is unchanged.

- :func:`scan_journal` replays a journal distinguishing **torn tail**
  (an incomplete final frame — excise, exactly as before) from
  **mid-file corruption** (a complete-but-invalid frame, or garbage
  with valid records after it — refuse and report, never silently
  truncate committed records).  Legacy v1 plain-JSON lines still parse,
  so journals and mirrors written before this module replay unchanged.

- :func:`write_manifest` / :func:`verify_snapshot` give checkpoints a
  checksummed manifest (``snapshot.manifest.json``) verified at load;
  a mismatch falls back to the previous checkpoint + its rotated
  journal (``Store.checkpoint`` keeps ``snapshot.prev.json`` /
  ``journal.prev.jsonl`` for exactly this).

- :func:`hygiene_sweep` unlinks crash-orphaned ``.tmp.`` atomic-write
  leftovers and stale poison markers at ``Store.open`` — a SIGKILL
  mid-publish used to leave them forever.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..utils.metrics import registry

#: v2 frame marker.  A v1 record is a bare JSON object line, so the
#: first byte of every legacy record is ``{`` — the ``v2 `` prefix can
#: never collide with one.
V2_PREFIX = b"v2 "

#: minimum age before the boot-time hygiene sweep unlinks an orphaned
#: temp/marker: a LIVE writer's in-flight ``.tmp.`` must survive a
#: concurrent open of a shared dir (config.StorageConfig overrides).
HYGIENE_MIN_AGE_S = 60.0


def _make_crc32c_table() -> List[int]:
    # reflected Castagnoli polynomial (0x1EDC6F41 bit-reversed)
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _make_crc32c_table()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    table = _CRC32C_TABLE
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


try:  # native Castagnoli when the wheel is present (~800x the pure-
    # Python table loop — the journal append and scrub paths CRC every
    # payload byte, so this is worth a soft dependency)
    from google_crc32c import extend as _crc32c_extend

    def crc32c(data: bytes, crc: int = 0) -> int:
        """CRC-32C (Castagnoli) of ``data``, optionally continuing a
        running checksum ``crc``."""
        return _crc32c_extend(crc, bytes(data))
except ImportError:  # pragma: no cover — exercised via _crc32c_py tests
    crc32c = _crc32c_py


def seal_record(rec: Dict[str, Any]) -> str:
    """Serialize one journal record into its checksummed v2 frame (the
    ONE blessed appender — the ``cs lint`` journal-raw-write pass
    rejects journal writes that bypass it)."""
    payload = json.dumps(rec)
    data = payload.encode("utf-8")
    return f"v2 {len(data)} {crc32c(data):08x} {payload}\n"


class FrameError(ValueError):
    """One journal line failed to parse.  ``complete`` distinguishes the
    two causes replay must treat differently: an INCOMPLETE frame (short
    payload, truncated header — the shape a torn write produces) may be
    excised when it is the file's final line; a COMPLETE frame whose CRC
    or length check fails can only be corruption (torn writes produce
    prefixes, and a prefix never carries the full declared payload), so
    it is corruption even at the tail."""

    def __init__(self, reason: str, complete: bool):
        super().__init__(reason)
        self.complete = complete


def parse_journal_line(text: bytes) -> Dict[str, Any]:
    """Parse one stripped journal line (v2 sealed frame or legacy v1
    bare JSON) into its record dict.  Raises :class:`FrameError`."""
    if text.startswith(V2_PREFIX):
        parts = text.split(b" ", 3)
        if len(parts) < 4:
            raise FrameError("v2 frame header truncated", complete=False)
        _, length_b, crc_b, payload = parts
        try:
            length = int(length_b)
            crc = int(crc_b, 16)
        except ValueError:
            raise FrameError("v2 frame header unparseable",
                             complete=False) from None
        if len(payload) < length:
            raise FrameError(
                f"v2 frame short: {len(payload)} < declared {length}",
                complete=False)
        if len(payload) > length:
            raise FrameError(
                f"v2 frame long: {len(payload)} > declared {length}",
                complete=True)
        actual = crc32c(payload)
        if actual != crc:
            raise FrameError(
                f"v2 frame crc mismatch: {actual:08x} != {crc:08x}",
                complete=True)
        try:
            return json.loads(payload)
        except json.JSONDecodeError as e:
            # crc passed but json failed: the frame was SEALED that way,
            # i.e. a writer bug, not disk damage — still refuse loudly
            raise FrameError(f"v2 payload unparseable: {e}",
                             complete=True) from None
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        # a v1 line carries no frame, so parse failure cannot tell torn
        # from flipped — mid-file position (the caller's call) is the
        # only disambiguator
        raise FrameError(f"v1 record unparseable: {e}",
                         complete=False) from None


class JournalCorruptionError(RuntimeError):
    """Mid-file (or complete-frame) journal damage: replay refuses to
    silently truncate committed records after the damage point.  The
    repair path (state/repair.py) pulls the range from a synced peer;
    docs/DEPLOY.md carries the operator runbook."""

    def __init__(self, path: str, offset: int, reason: str):
        super().__init__(
            f"journal corruption in {path} at byte {offset}: {reason}")
        self.path = path
        self.offset = offset
        self.reason = reason


class ScanResult:
    """:func:`scan_journal`'s outcome.  Iterable as the legacy
    ``(records, good, size)`` triple so existing unpack sites and tests
    keep working; ``corrupt_offset``/``reason`` carry the new verdict."""

    __slots__ = ("records", "good", "size", "corrupt_offset", "reason")

    def __init__(self, records: List[Dict[str, Any]], good: int,
                 size: int, corrupt_offset: Optional[int] = None,
                 reason: str = ""):
        self.records = records
        self.good = good
        self.size = size
        self.corrupt_offset = corrupt_offset
        self.reason = reason

    @property
    def corrupt(self) -> bool:
        return self.corrupt_offset is not None

    def __iter__(self):
        yield self.records
        yield self.good
        yield self.size


def scan_journal(path: str) -> ScanResult:
    """Parse a journal file (v1 and v2 records interleaved) into
    records.  ``good`` marks the byte offset after the last valid
    record.  Verdicts:

    - a final line that is an INCOMPLETE frame (no trailing newline, or
      a v2 frame shorter than its declared length, or unparseable v1
      JSON) is a **torn tail**: records stop there, ``corrupt`` is
      False — the caller excises it exactly as before this module;
    - an invalid line with MORE lines after it, or a COMPLETE v2 frame
      whose CRC/length check fails (even at the tail — torn writes only
      produce prefixes), is **corruption**: ``corrupt_offset`` marks
      the damage and the caller must refuse-and-repair, never silently
      truncate the committed records beyond it."""
    if not os.path.exists(path):
        return ScanResult([], 0, 0)
    with open(path, "rb") as f:
        data = f.read()
    records: List[Dict[str, Any]] = []
    good = 0
    lines = data.splitlines(keepends=True)
    for i, line in enumerate(lines):
        if not line.endswith(b"\n"):
            break  # torn tail: a crash mid-append
        text = line.strip()
        if text:
            try:
                records.append(parse_journal_line(text))
            except FrameError as e:
                if e.complete or i < len(lines) - 1:
                    return ScanResult(records, good, len(data),
                                      corrupt_offset=good, reason=str(e))
                break  # incomplete final frame: torn tail
        good += len(line)
    return ScanResult(records, good, len(data))


def verify_window(path: str, offset: int, max_bytes: int
                  ) -> ScanResult:
    """Incremental frame verification for the background scrub: check
    the journal window ``[offset, offset+max_bytes)`` line by line
    without materializing records.  Returns a :class:`ScanResult` whose
    ``records`` list is empty, ``good`` is the verified offset (never
    past an incomplete tail frame — the live appender finishes it), and
    ``corrupt_offset`` marks damage exactly as :func:`scan_journal`.
    ``size`` is the file size at read time."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(max_bytes)
    except OSError:
        return ScanResult([], offset, 0)
    good = offset
    lines = data.splitlines(keepends=True)
    for i, line in enumerate(lines):
        if not line.endswith(b"\n"):
            break  # window or file ends mid-frame: verify next pass
        text = line.strip()
        if text:
            try:
                parse_journal_line(text)
            except FrameError as e:
                at_eof = good + len(line) >= size
                if e.complete or i < len(lines) - 1 or not at_eof:
                    return ScanResult([], good, size,
                                      corrupt_offset=good, reason=str(e))
                break  # incomplete tail frame mid-append
        good += len(line)
    return ScanResult([], good, size)


# --------------------------------------------------------------- manifest
def manifest_path(snap_path: str) -> str:
    base = snap_path[:-len(".json")] if snap_path.endswith(".json") \
        else snap_path
    return base + ".manifest.json"


def write_manifest(snap_path: str, text: str) -> None:
    """Record the checkpoint snapshot's size + CRC32C beside it
    (``snapshot.manifest.json``), atomically.  The manifest is written
    AFTER the snapshot: a crash between the two leaves a manifest that
    describes the previous snapshot, which fails verification and falls
    back to the previous-checkpoint chain — a correct (idempotent
    re-replay) state, never a silently wrong one."""
    from ..utils.fsatomic import write_atomic_text
    data = text.encode("utf-8")
    write_atomic_text(manifest_path(snap_path), json.dumps(
        {"size": len(data), "crc32c": f"{crc32c(data):08x}"}))


def verify_snapshot(snap_path: str) -> Optional[bool]:
    """Check ``snap_path`` against its manifest.  True = verified,
    False = mismatch (fall back), None = no manifest (a legacy dir or a
    replication mirror — the manifest is node-local — loads unverified,
    exactly as before this module)."""
    mpath = manifest_path(snap_path)
    try:
        with open(mpath, encoding="utf-8") as f:
            man = json.loads(f.read())
    except (OSError, json.JSONDecodeError):
        return None
    try:
        with open(snap_path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    return (len(data) == int(man.get("size", -1))
            and f"{crc32c(data):08x}" == str(man.get("crc32c")))


# ---------------------------------------------------------------- hygiene
#: poison/staleness markers the sweep may clear once they are old: a
#: mirror's corruption marker survives the repair that obsoleted it
#: only until the next store/view open.
_SWEEPABLE_MARKERS = ("mirror_poisoned",)


def hygiene_sweep(directory: str,
                  min_age_s: Optional[float] = None) -> int:
    """Unlink crash-orphaned atomic-write temps (dot-prefixed,
    ``.tmp.``-infixed — utils/fsatomic.py's writer-unique naming) and
    stale poison markers in ``directory``.  Only entries older than
    ``min_age_s`` go: a live writer's in-flight temp in a shared dir
    must survive.  Returns the count, also published as
    ``cook_storage_hygiene_removed_total``."""
    if min_age_s is None:
        min_age_s = HYGIENE_MIN_AGE_S
    removed = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    now = time.time()
    for name in names:
        orphan_tmp = name.startswith(".") and ".tmp." in name
        if not (orphan_tmp or name in _SWEEPABLE_MARKERS):
            continue
        p = os.path.join(directory, name)
        try:
            if now - os.stat(p).st_mtime < min_age_s:
                continue
            os.unlink(p)
            removed += 1
        except OSError:
            continue
    if removed:
        registry.counter_inc("cook_storage_hygiene_removed",
                             value=float(removed))
    return removed
