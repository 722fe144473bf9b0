"""The port's copy of ``cook_tpu/state/repair.py`` (imports re-rooted).

Repair a damaged persistence directory from a synced replication peer.

:func:`Store.open <cook_tpu_torch.state.store.Store.open>` REFUSES a journal
with mid-file corruption (a complete frame whose CRC32C fails, or
garbage with valid records after it) instead of silently truncating the
committed records beyond the damage — see state/integrity.py.  This
module is the other half of that contract: the records the local disk
lost are still byte-identical on every synced mirror (the framed-TCP
replication fsyncs whole frames), so healing is a pull, not a guess.

The flow (docs/DEPLOY.md corrupted-journal runbook):

1. quarantine the damaged files (``journal.jsonl.corrupt`` /
   ``snapshot.json.corrupt`` — kept for forensics, out of replay's way);
2. full-resync from the most-advanced synced peer over the existing
   catch-up carrier (:func:`~cook_tpu_torch.state.replication.
   catch_up_from_peer` — Viewstamped Replication's view-change state
   transfer);
3. reopen: the pulled snapshot + journal replay verifies clean.

Mirror-side healing lives on the view itself
(:meth:`~cook_tpu_torch.state.read_replica.FollowerReadView.repair_from_peer`),
because the view must also re-base off the poisoned store.
"""

from __future__ import annotations

import os
from typing import Any, Iterable, Optional, Tuple

from ..utils.metrics import registry
from .integrity import JournalCorruptionError
from .store import Store

#: quarantine suffix for damaged persistence files — never parsed by
#: any replay path, swept only by operators
CORRUPT_SUFFIX = ".corrupt"


def quarantine(directory: str) -> None:
    """Move the damaged generation out of replay's way (journal,
    snapshot + manifest, prev chain, resync markers), keeping the bytes
    under ``*.corrupt`` names for forensics.  After this the directory
    is a blank slate a peer resync can safely fill."""
    for name in ("journal.jsonl", "journal.prev.jsonl",
                 "snapshot.json", "snapshot.manifest.json",
                 "snapshot.prev.json", "snapshot.prev.manifest.json"):
        src = os.path.join(directory, name)
        try:
            if os.path.exists(src):
                os.replace(src, src + CORRUPT_SUFFIX)
        except OSError:
            pass
    # a stale resync identity would make the follower transfer resume
    # instead of full-resyncing onto the blank slate
    for marker in ("repl_token", "repl_synced", "repl_following",
                   "mirror_poisoned"):
        try:
            os.unlink(os.path.join(directory, marker))
        except OSError:
            pass


def repair_from_peers(directory: str,
                      peers: Iterable[Tuple[str, int]],
                      timeout_s: float = 30.0) -> bool:
    """Quarantine ``directory`` and pull a full resync from the first
    reachable peer (callers order ``peers`` most-advanced first — the
    election medium's candidate positions under
    :func:`~cook_tpu_torch.state.replication.rank_key` give that order).
    True once a peer's transfer reached its head (the synced marker)."""
    quarantine(directory)
    for host, port in peers:
        try:
            from .replication import catch_up_from_peer
            if catch_up_from_peer(host, int(port), directory, 0,
                                  timeout_s=timeout_s):
                registry.counter_inc("cook_storage_repair",
                                     labels={"kind": "peer"})
                return True
        except Exception:
            continue  # dead peer: the next-ranked one may still serve
    return False


def open_with_repair(directory: str,
                     peers: Iterable[Tuple[str, int]] = (),
                     fsync: bool = False,
                     epoch: Optional[Any] = None,
                     shared: bool = True,
                     partition: Optional[int] = None,
                     timeout_s: float = 30.0) -> Store:
    """:meth:`Store.open` with the repair path armed: a
    :class:`JournalCorruptionError` at replay triggers one
    quarantine-and-pull round from ``peers`` before reopening.  With no
    peers (or none reachable) the corruption error propagates — silent
    truncation is exactly what this subsystem exists to forbid."""
    try:
        return Store.open(directory, fsync=fsync, epoch=epoch,
                          shared=shared, partition=partition)
    except JournalCorruptionError:
        peers = list(peers)
        if not peers or not repair_from_peers(directory, peers,
                                              timeout_s=timeout_s):
            raise
        return Store.open(directory, fsync=fsync, epoch=epoch,
                          shared=shared, partition=partition)
