"""The port's copy of ``cook_tpu/state/read_replica.py`` (imports re-rooted).

Follower read fleet: a LIVE read-only store over a replication mirror.

The :class:`~cook_tpu_torch.state.replication.ReplicationFollower` mirrors
the leader's journal BYTES into a local directory — byte-identical, but
inert: the standby could promote, yet served nothing.  This module
promotes the mirror to a live store (the ZooKeeper observer / non-voting
read replica shape, Hunt et al., USENIX ATC'10): a
:class:`FollowerReadView` tails the mirrored ``journal.jsonl`` and feeds
each record through the store's own replay path
(:meth:`Store._apply_journal_record`, with the same epoch-fence skipping
as :meth:`Store._replay_records`) into a local read-only :class:`Store`
the follower's REST layer serves GETs from.

The staleness contract (docs/DEPLOY.md):

- every follower-served response carries ``X-Cook-Replication-Offset``
  (applied journal bytes) and ``X-Cook-Replication-Age-Ms`` (an upper
  bound on how long the view has been behind its mirror);
- writes keep 307-redirecting to the leader, whose write responses carry
  ``X-Cook-Commit-Offset``;
- read-your-writes: a client threads its last commit offset back as
  ``X-Cook-Min-Offset``; a behind follower waits briefly
  (:meth:`wait_offset`), then redirects the read to the leader.

The mirror can be RE-BASED underneath the view (leader checkpoint →
full resync: new snapshot + fresh journal, new ``repl_token``): the view
detects the base change and rebuilds its store wholesale, swapping it
atomically and notifying ``on_swap`` subscribers (the REST layer points
``api.store`` at the fresh object).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.locks import named_lock
from ..utils.metrics import registry
from .integrity import FrameError, parse_journal_line
from .store import Store, _scan_journal


def _read_text(path: str) -> str:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return ""


class FollowerReadView:
    """Tail a mirror directory into a live read-only :class:`Store`.

    Thread-safe for readers: queries go through the store's own lock,
    and the apply loop installs record batches under that same lock.
    ``store`` is replaced wholesale only on a mirror re-base; consumers
    that cache the reference subscribe via ``on_swap``."""

    def __init__(self, directory: str, interval_s: float = 0.02,
                 on_swap: Optional[Callable[[Store], None]] = None,
                 start: bool = True,
                 partition_id: Optional[int] = None):
        self.directory = str(directory)
        self.interval_s = max(float(interval_s), 0.001)
        #: partition this view mirrors in a partitioned write plane
        #: (state/partition.py): the replica store carries the id (lock
        #: family, metric labels) and the token wait-gate satisfies only
        #: entries QUALIFIED with this partition — an offset from a
        #: sibling partition's journal proves nothing here.  None = the
        #: classic single-journal plane.
        self.partition_id = partition_id
        self._on_swap: List[Callable[[Store], None]] = []
        if on_swap is not None:
            self._on_swap.append(on_swap)
        self._journal = os.path.join(self.directory, "journal.jsonl")
        self._stop = threading.Event()
        # ranks BELOW "store" (utils/locks.py): _rebuild holds _mu while
        # replaying into the fresh store under that store's own lock
        self._mu = named_lock("read_replica")
        # staleness bookkeeping
        self.applied_records = 0
        self.rebuilds = 0
        self._caught_up_ts = time.time()
        self._offset_cv = threading.Condition()
        self.store: Store = Store(partition=partition_id)
        self._offset = 0
        self._max_ep = 0
        self._base_sig: Any = None
        #: non-None when the mirror bytes failed frame verification
        #: (``{"offset", "reason"}``): the view STOPS advancing and
        #: serves only the verified prefix until repair_from_peer (or a
        #: clean re-base) heals the mirror — poisoned state is never
        #: served as fresh
        self.corrupt: Optional[Dict[str, Any]] = None
        self._rebuild()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._apply_loop, daemon=True,
                name="cook-follower-apply")
            self._thread.start()

    # ---------------------------------------------------------------- state
    @property
    def offset(self) -> int:
        """Applied journal bytes (whole records only) — the follower's
        serving position, returned as X-Cook-Replication-Offset."""
        return self._offset

    def mirror_offset(self) -> int:
        """Raw mirrored journal bytes on disk (the native follower's
        write position) — the local apply target."""
        try:
            return os.path.getsize(self._journal)
        except OSError:
            return 0

    def lag_bytes(self) -> int:
        """Mirrored-but-unapplied bytes.  The mirror itself is pushed by
        the leader's stream, so this approximates 'behind the leader by N
        bytes' up to one network round."""
        return max(0, self.mirror_offset() - self._offset)

    def age_ms(self) -> float:
        """Upper bound on staleness: ~0 while the view keeps catching
        its mirror's head every tick, else time since it last did."""
        return max(0.0, (time.time() - self._caught_up_ts) * 1000.0)

    def stats(self) -> Dict[str, Any]:
        return {"offset": self._offset,
                "mirror_offset": self.mirror_offset(),
                "lag_bytes": self.lag_bytes(),
                "age_ms": round(self.age_ms(), 1),
                "applied_records": self.applied_records,
                "rebuilds": self.rebuilds,
                **({"corrupt": self.corrupt} if self.corrupt else {}),
                **({"partition": f"p{self.partition_id}"}
                   if self.partition_id is not None else {})}

    def on_swap(self, fn: Callable[[Store], None]) -> None:
        self._on_swap.append(fn)
        fn(self.store)

    @property
    def applied_epoch(self) -> int:
        """Highest election epoch applied from the mirror — qualifies
        the offset space a read-your-writes token compares against."""
        return self._max_ep

    def _satisfies(self, epoch: Optional[int], offset: int) -> bool:
        """Does the view's position cover a ``<epoch>:<offset>`` token?
        A HIGHER applied epoch covers any lower-epoch token outright
        (every determinate commit survives into later epochs' journals
        by the no-loss guarantee); the same epoch compares offsets; a
        lower applied epoch means this mirror is still in a previous
        leadership's offset space — its numerically-larger byte count
        proves nothing about the token's commit."""
        if epoch is None:
            return self._offset >= offset
        if self._max_ep != epoch:
            return self._max_ep > epoch
        return self._offset >= offset

    def wait_token(self, epoch: Optional[int], offset: int,
                   timeout_s: float = 1.0) -> bool:
        """Read-your-writes gate: block until the token's position is
        APPLIED (not merely mirrored).  False on timeout — the caller
        redirects the read to the leader."""
        deadline = time.time() + max(timeout_s, 0.0)
        with self._offset_cv:
            while not self._satisfies(epoch, offset):
                remaining = deadline - time.time()
                if remaining <= 0:
                    return self._satisfies(epoch, offset)
                self._offset_cv.wait(min(remaining, 0.05))
        return True

    def wait_offset(self, offset: int, timeout_s: float = 1.0) -> bool:
        """Offset-only form of :meth:`wait_token`."""
        return self.wait_token(None, offset, timeout_s=timeout_s)

    def wait_commit_token(self, token: str, timeout_s: float = 1.0
                          ) -> bool:
        """Vector-aware read-your-writes gate (the partitioned plane's
        X-Cook-Min-Offset form, state/partition.py):

        - an entry qualified with THIS view's partition waits like
          :meth:`wait_token`;
        - an entry for a SIBLING partition with bytes committed cannot
          be verified against this mirror (its offsets live in another
          journal's space) — False, the caller redirects to the leader;
          a zero-offset sibling entry is vacuously satisfied;
        - a partitionless (legacy) entry is satisfiable only by a
          partitionless view, and vice versa — an unqualified offset
          does not name which journal it measures.

        Raises ValueError on garbage (callers surface 400)."""
        from .partition import parse_token_vector
        entries = parse_token_vector(token)
        deadline = time.time() + max(timeout_s, 0.0)
        for part, ep, off in entries:
            if part is None:
                if self.partition_id is not None:
                    return False
            elif self.partition_id is None:
                return False
            elif part != self.partition_id:
                if off > 0:
                    return False
                continue
            remaining = max(deadline - time.time(), 0.0)
            if not self.wait_token(ep, off, timeout_s=remaining):
                return False
        return True

    # ---------------------------------------------------------------- apply
    def _base_signature(self) -> Any:
        """Identity of the mirror BASE: the follower's resync token plus
        the snapshot's stat — either changing means the journal byte
        space re-based (full resync after a leader checkpoint / a new
        leader's mirror) and incremental offsets are meaningless."""
        token = _read_text(os.path.join(self.directory, "repl_token"))
        try:
            st = os.stat(os.path.join(self.directory, "snapshot.json"))
            snap_sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            snap_sig = None
        return (token, snap_sig)

    def _mark_corrupt(self, offset: int, reason: str) -> None:
        """First sighting of mirror damage: remember it (the view stops
        advancing and keeps serving the verified prefix), count it, and
        drop a ``mirror_poisoned`` marker so the daemon's health surface
        and the boot hygiene sweep can see it across restarts."""
        if self.corrupt is not None:
            return
        self.corrupt = {"offset": offset, "reason": reason}
        registry.counter_inc("cook_journal_corruption",
                             labels={"source": "mirror"})
        try:
            with open(os.path.join(self.directory, "mirror_poisoned"),
                      "w", encoding="utf-8") as f:
                f.write(f"{offset} {reason}\n")
        except OSError:
            pass

    def _clear_corrupt(self) -> None:
        if self.corrupt is None:
            return
        self.corrupt = None
        try:
            os.unlink(os.path.join(self.directory, "mirror_poisoned"))
        except OSError:
            pass

    def _rebuild(self) -> None:
        """Full rebuild from snapshot + journal (the Store.replay_only
        shape, with the epoch high-water mark kept for later incremental
        applies).  A mirror whose journal fails frame verification
        rebuilds to the verified PREFIX and marks itself corrupt — the
        re-base path is also how a repaired mirror (new repl_token)
        comes back clean."""
        with self._mu:
            self._base_sig = self._base_signature()
            snap = os.path.join(self.directory, "snapshot.json")
            store = (Store.restore(_read_text(snap),
                                   partition=self.partition_id)
                     if os.path.exists(snap)
                     else Store(partition=self.partition_id))
            scan = _scan_journal(self._journal)
            records, good = scan.records, scan.good
            max_ep = store._replay_records(records)
            swapped = store is not self.store
            self.store = store
            self._max_ep = max_ep
            with self._offset_cv:
                self._offset = good
                self._offset_cv.notify_all()
            self.rebuilds += 1
            self._caught_up_ts = time.time()
            if scan.corrupt:
                self._mark_corrupt(scan.corrupt_offset or good,
                                   scan.reason)
            else:
                self._clear_corrupt()
        if swapped:
            for fn in self._on_swap:
                fn(store)

    def poll(self) -> int:
        """One apply tick (also the test hook): detect re-base, else
        parse and apply the mirrored records beyond the applied offset.
        Returns the number of records applied (rebuilds count as 0)."""
        sig = self._base_signature()
        size = self.mirror_offset()
        if sig != self._base_sig or size < self._offset:
            self._rebuild()
            return 0
        if self.corrupt is not None:
            # poisoned mirror: hold the verified prefix and wait for a
            # re-base (repair_from_peer writes a new repl_token, which
            # the sig check above turns into a clean rebuild) — applying
            # past the damage would serve records whose provenance the
            # CRC just disproved
            return 0
        if size <= self._offset:
            self._caught_up_ts = time.time()
            return 0
        try:
            with open(self._journal, "rb") as f:
                f.seek(self._offset)
                data = f.read(size - self._offset)
        except OSError:
            return 0
        applied = 0
        good = self._offset
        recs: List[Dict[str, Any]] = []
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break  # torn tail: the mirror is mid-record
            text = line.strip()
            if text:
                try:
                    recs.append(parse_journal_line(text))
                except FrameError as e:
                    # a COMPLETE line that fails frame verification is
                    # mirror corruption, not a mid-append race: the
                    # native follower only splits lines mid-frame
                    # (before the newline), and those park on the
                    # endswith check above
                    self._mark_corrupt(good, str(e))
                    break
            good += len(line)
        store = self.store
        if recs:
            # the store's own replay owns the epoch-fence skip rule;
            # applied under the store lock so concurrent REST readers
            # see whole records
            with store._lock:
                self._max_ep = store._replay_records(recs, self._max_ep)
            applied = len(recs)
        self.applied_records += applied
        with self._offset_cv:
            self._offset = good
            self._offset_cv.notify_all()
        if good >= size:
            # caught the head AS OF this tick's start: staleness is
            # bounded by one poll interval.  Comparing against the LIVE
            # mirror head instead would never reset under a sustained
            # write stream (the mirror always advances during the
            # apply), ratcheting the reported age far above the real
            # one-tick lag.
            self._caught_up_ts = time.time()
        return applied

    def repair_from_peer(self, host: str, port: int,
                         timeout_s: float = 30.0) -> bool:
        """Heal a corrupt mirror by pulling a fresh full resync from a
        synced peer over the framed-TCP catch-up carrier
        (:func:`cook_tpu_torch.state.replication.catch_up_from_peer`).  The
        damaged journal is quarantined as ``journal.jsonl.corrupt``
        (forensics; docs/DEPLOY.md runbook) and the resync markers are
        cleared so the transfer starts from the peer's snapshot.  The
        resync mints a NEW ``repl_token`` — the next poll sees the base
        change and rebuilds the view from the healed bytes, clearing the
        poisoned state.  The caller must ensure the native follower that
        normally feeds this mirror is detached for the duration: two
        writers on one mirror directory is never safe."""
        from .replication import catch_up_from_peer
        d = self.directory
        try:
            os.replace(os.path.join(d, "journal.jsonl"),
                       os.path.join(d, "journal.jsonl.corrupt"))
        except OSError:
            pass
        for marker in ("repl_token", "repl_synced", "repl_following"):
            try:
                os.unlink(os.path.join(d, marker))
            except OSError:
                pass
        ok = catch_up_from_peer(host, int(port), d, 0,
                                timeout_s=timeout_s)
        if ok:
            registry.counter_inc("cook_storage_repair",
                                 labels={"kind": "peer"})
            self._rebuild()
        return ok

    def _apply_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception:
                # the view must never die silently — a transient read
                # race with the native mirror writer resolves next tick
                pass
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
