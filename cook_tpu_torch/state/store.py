"""The port's copy of ``cook_tpu/state/store.py`` (imports re-rooted).

Transactional in-memory state store with guard transactions and a tx feed.

Plays the role of the reference's Datomic peer + transactor
(reference: scheduler/src/cook/datomic.clj, schema.clj db-fns,
metatransaction/core.clj):

- **All-or-nothing transactions** with an undo log; a guard raising
  :class:`AbortTransaction` rolls everything back (the reference's
  ":job/allowed-to-start? aborts the txn" discipline, schema.clj:1311-1325).
- **Tx-report feed**: subscribers receive the event list of every committed
  transaction (reference: create-tx-report-mult datomic.clj:49, consumed by
  monitor-tx-report-queue scheduler.clj:378-448 to kill orphaned instances).
- **Commit latch**: batch-submitted jobs stay invisible to queries until the
  latch commits (reference: metatransactions + :job/commit-latch schema.clj:28).
- **Snapshot/restore**: full-state JSON round-trip; a new leader resumes by
  re-reading state (SURVEY.md section 5 checkpoint/resume).
- **Durable redo journal**: every committed transaction's write/delete set is
  appended as one JSON line; :meth:`Store.open` replays snapshot + journal so
  a restarted leader re-reads everything, like the reference's leader
  re-reading Datomic (mesos.clj:296-313). :meth:`checkpoint` compacts.
"""

from __future__ import annotations

import copy
import errno
import json
import os
import threading
import time
from contextlib import nullcontext
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..utils import tracing
from ..utils.locks import named_lock, named_rlock
from ..utils.metrics import registry as _metrics
from . import machines
from .integrity import (
    JournalCorruptionError,
    ScanResult,
    hygiene_sweep,
    scan_journal,
    seal_record,
    verify_snapshot,
    verify_window,
    write_manifest,
)
from .schema import (
    Application,
    fast_clone,
    Checkpoint,
    CheckpointMode,
    Constraint,
    DruMode,
    Group,
    GroupPlacementType,
    Instance,
    InstanceStatus,
    Job,
    JobState,
    Pool,
    QuotaEntry,
    Resources,
    SchedulerKind,
    ShareEntry,
    now_ms,
    to_json,
)


class StaleEpochError(RuntimeError):
    """A deposed leader attempted to touch a journal another leader has
    fenced at a higher election epoch."""


class StorageFullError(OSError):
    """ENOSPC on the journal write path.  A CLEAN abort: the torn
    fragment (if any) was excised, nothing installed, the store keeps
    serving reads — the REST layer maps this to 503 and escalates the
    admission controller to its shed-writes stage (sched/admission.py)
    instead of the daemon dying on a full disk.  Subclasses OSError so
    every pre-existing ``except OSError`` around an append still
    catches a full disk."""


class ReplicationTimeout(RuntimeError):
    """Sync replication refused the transaction BEFORE its record was
    written anywhere (the CP quorum gate, or the stream down pre-write):
    a clean abort — nothing on disk, nothing installed, safe to retry."""


class ReplicationIndeterminate(RuntimeError):
    """Sync replication could not CONFIRM the transaction: the record is
    durable in the local journal and may or may not have reached a
    mirror.  The transaction IS applied locally (excising the record
    would resurrect it as a phantom commit on a mirror that did fsync it
    before a failover), but the caller must report the
    outcome as ambiguous: if this leader survives, the record re-syncs
    and the commit stands; if a mirror that missed it promotes, the
    commit is lost.  Journal replay resolves it on the next open either
    way.  REST surfaces this as HTTP 504 with an ``indeterminate`` body;
    retries are safe — submission is idempotent on job uuid."""


class AbortTransaction(Exception):
    """Raised inside a transaction to roll back all of its writes."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class TxEvent:
    __slots__ = ("kind", "data")

    def __init__(self, kind: str, **data: Any):
        self.kind = kind
        self.data = data

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TxEvent({self.kind}, {self.data})"


class _Txn:
    """One open transaction: copy-on-write views over the store's entity maps."""

    #: peeked store entities spot-checked per txn (``__debug__`` only):
    #: mutation by a guard is deterministic, so checking the first few
    #: catches it without taxing 1000-launch batches
    _PEEK_CHECKS = 8

    def __init__(self, store: "Store"):
        self._store = store
        self._writes: Dict[Tuple[str, str], Any] = {}
        self._deletes: set = set()
        self.events: List[TxEvent] = []
        # latch registrations/releases applied atomically with the commit
        self.latch_registrations: List[Tuple[str, List[str]]] = []
        self.latch_pops: List[str] = []
        # (table, key, entity, fingerprint) of peeked LIVE store entities,
        # re-verified at commit (__debug__ only; see peek())
        self._peeks: List[Tuple[str, str, Any, str]] = []

    def _get(self, table: str, key: str, for_write: bool,
             clone: bool = True) -> Any:
        wk = (table, key)
        if wk in self._deletes:
            return None
        if wk in self._writes:
            return self._writes[wk]
        ent = getattr(self._store, "_" + table).get(key)
        if ent is None:
            return None
        if not clone:
            # peek mode: a guard that only INSPECTS must not pay the
            # defensive copy; the caller promises not to mutate
            return ent
        # Reads are deep-copied too: a transaction fn mutating a read-returned
        # entity must not leak into the store outside the write log (the
        # all-or-nothing guarantee would silently break on abort otherwise).
        ent = fast_clone(ent)
        if for_write:
            self._writes[wk] = ent
        return ent

    # -- reads (txn-local view) ---------------------------------------------
    def job(self, uuid: str) -> Optional[Job]:
        return self._get("jobs", uuid, for_write=False)

    def instance(self, task_id: str) -> Optional[Instance]:
        return self._get("instances", task_id, for_write=False)

    def group(self, uuid: str) -> Optional[Group]:
        return self._get("groups", uuid, for_write=False)

    def instances_of(self, job: Job) -> Dict[str, Instance]:
        return {tid: inst for tid in job.instances
                if (inst := self._get("instances", tid, for_write=False)) is not None}

    # -- writes --------------------------------------------------------------
    def job_w(self, uuid: str) -> Optional[Job]:
        return self._get("jobs", uuid, for_write=True)

    def instance_w(self, task_id: str) -> Optional[Instance]:
        return self._get("instances", task_id, for_write=True)

    def group_w(self, uuid: str) -> Optional[Group]:
        return self._get("groups", uuid, for_write=True)

    def put(self, table: str, key: str, entity: Any) -> None:
        self._deletes.discard((table, key))
        self._writes[(table, key)] = entity

    def delete(self, table: str, key: str) -> None:
        self._writes.pop((table, key), None)
        self._deletes.add((table, key))

    def peek(self, table: str, key: str) -> Any:
        """Txn-consistent READ-ONLY view WITHOUT the defensive clone.
        For guards that only inspect: _get's copy-on-read exists so a
        mutating txn fn can't leak into the store, but a guard that
        mutates nothing pays the full entity clone for every launch.
        The caller MUST NOT mutate the returned entity — under
        ``__debug__`` a fingerprint taken here is re-checked at commit
        (``_verify_peeks``), so a guard that breaks the promise fails the
        transaction loudly instead of silently corrupting committed
        state outside the undo log."""
        ent = self._get(table, key, for_write=False, clone=False)
        if __debug__ and ent is not None \
                and (table, key) not in self._writes \
                and len(self._peeks) < self._PEEK_CHECKS:
            # only LIVE store entities are frozen; a peek that resolved
            # to this txn's own write intent may be legally mutated via
            # the _w accessors afterwards
            self._peeks.append((table, key, ent, repr(ent)))
        return ent

    def _verify_peeks(self) -> None:
        """``__debug__``-mode commit check: no peeked store entity was
        mutated (peek's no-clone contract, spot-checked)."""
        for table, key, ent, fp in self._peeks:
            if repr(ent) != fp:
                raise AssertionError(
                    f"peeked entity {table}/{key} was mutated inside the "
                    "transaction: peek()/peek_instances_of return LIVE "
                    "store entities; use the *_w accessors for writes")

    def peek_instances_of(self, job: Job) -> Dict[str, Instance]:
        """``instances_of`` for read-only guards (no defensive clones):
        one definition of "a job's instances as this txn sees them"."""
        return {tid: inst for tid in job.instances
                if (inst := self.peek("instances", tid)) is not None}

    def abort(self, reason: str) -> None:
        raise AbortTransaction(reason)

    def event(self, kind: str, **data: Any) -> None:
        self.events.append(TxEvent(kind, **data))

    def create_new_jobs(self, jobs: List[Job], now: int,
                        committed: bool) -> List[str]:
        """Bulk insert of FRESH jobs — the hottest write path at the
        1M-job design point.  Owns the same bookkeeping put()/event()
        do, with the per-call wrapper overhead hoisted out of the loop;
        living on _Txn keeps the writes/deletes/events invariants in one
        class (the never-in-both rule, delete-then-recreate legality)."""
        writes, deletes, events = self._writes, self._deletes, self.events
        existing = self._store._jobs
        for job in jobs:
            u = job.uuid
            key = ("jobs", u)
            if (u in existing and key not in deletes) or key in writes:
                # same visibility rule as self.job(): deletes shadow the
                # store, so same-txn delete-then-recreate stays legal
                self.abort(f"duplicate job uuid {u}")
            deletes.discard(key)
            job = fast_clone(job)
            if not job.submit_time_ms:
                job.submit_time_ms = now
            job.last_waiting_start_ms = job.submit_time_ms
            job.committed = committed
            writes[key] = job
            events.append(TxEvent("job-created", uuid=u,
                                  user=job.user, pool=job.pool,
                                  **({"trace": job.trace_id}
                                     if job.trace_id else {})))
        return [j.uuid for j in jobs]

    # -- composite ops shared by several public store methods ---------------
    def recompute_job_state(self, job: Job) -> None:
        """Re-derive job state from instances; emits job-state event on change
        (reference: :job/update-state side of :instance/update-state)."""
        # next_job_state only READS the instances — the non-cloning view
        # saves one Instance clone per live attempt on every status update
        new_state, reason = machines.next_job_state(
            job, self.peek_instances_of(job))
        if new_state is not job.state:
            old = job.state
            job.state = new_state
            if new_state is JobState.WAITING:
                job.last_waiting_start_ms = self._store.clock()
            self.event("job-state", uuid=job.uuid, old=old.value,
                       new=new_state.value, reason=reason)


#: group-commit batch-size histogram bounds (records per durability round)
_GC_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                     512.0)


class _CommitWaiter:
    """One transaction's slot in a group-commit batch: resolved by the
    committer with this txn's outcome (None = confirmed committed, else
    the exception to raise) plus the shared round's cost breakdown so the
    waiter can attribute it into its own request trace."""

    __slots__ = ("offset", "done", "error", "batch_size", "fsync_s",
                 "ack_s", "stage")

    def __init__(self, offset: int, stage: "_GroupCommitStage"):
        self.offset = offset
        self.stage = stage
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.batch_size = 0
        self.fsync_s = 0.0
        self.ack_s = 0.0


class _GroupCommitStage:
    """Commit-latch group commit (the Gray/DeWitt lineage — amortize one
    log force across concurrent writers; the same move the fused cycle
    makes batching a whole match cycle's launches into one txn).

    Records are already WRITTEN + FLUSHED in commit order under the store
    lock when they reach this stage — a failed write still aborts cleanly
    inline.  What moves here is the expensive durability tail: ONE
    ``os.fsync`` and ONE ``repl.wait_acked(max offset)`` per batch
    instead of per transaction, with per-transaction outcomes
    (committed / :class:`ReplicationIndeterminate`)
    demultiplexed back to each waiter.  A clean abort can no longer
    happen past this point: once a record is flushed and installed (and
    later transactions may have built on it), an unconfirmed fsync or
    ack is INDETERMINATE, never excised.

    Lock order: committers hold the store lock when enqueueing (store
    lock -> stage condvar); the committer thread takes the store lock
    only with the condvar released — no cycle."""

    def __init__(self, store: "Store", window_ms: float = 0.5,
                 max_batch: int = 256):
        self._store = store
        self.window_s = max(float(window_ms), 0.0) / 1000.0
        self.max_batch = max(int(max_batch), 1)
        self._cv = threading.Condition()
        self._pending: List[_CommitWaiter] = []
        self._stopped = False
        # advisory counters (single writer: the committer thread)
        self.batches = 0
        self.commits = 0
        self.indeterminate = 0
        self.max_batch_seen = 0
        _pl = store.partition_label()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="cook-group-commit" + (f"-{_pl}" if _pl else ""))
        self._thread.start()

    def enqueue(self, offset: int) -> _CommitWaiter:
        w = _CommitWaiter(int(offset), self)
        with self._cv:
            if self._stopped:
                # a closing store can no longer confirm durability; the
                # record is journaled+flushed, so the honest outcome is
                # the ambiguous one, not a hang
                w.error = ReplicationIndeterminate(
                    "store closing: group-commit durability unconfirmed")
                w.done.set()
                return w
            self._pending.append(w)
            self._cv.notify()
        return w

    def wait(self, w: _CommitWaiter) -> Optional[BaseException]:
        """Block until the waiter's batch resolves; returns the outcome
        exception (None = confirmed).  Bounded: the committer's own
        timeouts resolve every batch, but a committer death must not
        hang every writer forever."""
        timeout = max(60.0, float(self._store._repl_timeout_s) * 4)
        if not w.done.wait(timeout=timeout):
            return ReplicationIndeterminate(
                "group-commit round did not resolve in time; the record "
                "is journaled and flushed but durability is unconfirmed")
        return w.error

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            pending = len(self._pending)
        _pl = self._store.partition_label()
        return {"pending": pending, "batches": self.batches,
                "commits": self.commits,
                "indeterminate": self.indeterminate,
                "max_batch": self.max_batch_seen,
                "window_ms": round(self.window_s * 1000.0, 3),
                **({"partition": _pl} if _pl else {})}

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------ committer
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stopped:
                    self._cv.wait()
                if not self._pending:
                    return  # stopped and drained
                if self.window_s > 0 and not self._stopped \
                        and len(self._pending) < self.max_batch:
                    # coalescing window: stragglers arriving during the
                    # previous round's fsync/ack already batched; this
                    # only catches near-simultaneous committers
                    self._cv.wait(self.window_s)
                batch = self._pending[:self.max_batch]
                del self._pending[:len(batch)]
            self._commit_batch(batch)

    def _commit_batch(self, batch: List[_CommitWaiter]) -> None:
        from ..utils.faults import injector as _faults
        from ..utils.metrics import registry
        store = self._store
        target = max(w.offset for w in batch)
        n = len(batch)
        err: Optional[BaseException] = None
        fsync_s = ack_s = 0.0
        if store._journal_fsync:
            t0 = time.perf_counter()
            try:
                _faults.fire(
                    "store.journal.fsync",
                    lambda: OSError("injected journal fsync failure"))
                with store._lock:
                    f = store._journal_file
                if f is None:
                    # the store CLOSED under the stage (close() drains
                    # the committer first, so this only happens when
                    # that join timed out): no checkpoint covered the
                    # batch — the honest outcome is the ambiguous one,
                    # never a silently-skipped fsync reported committed
                    raise RuntimeError("journal closed mid-batch")
                os.fsync(f.fileno())
            except ValueError:
                # checkpoint() closed/swapped the journal between this
                # batch's writes and the fsync (a plain close() drains
                # this stage before touching the file): the atomic
                # snapshot — written under the store lock AFTER these
                # records installed, with its own fsync discipline —
                # durably covers every one, so the batch is confirmed
                pass
            except Exception as e:
                err = ReplicationIndeterminate(
                    "group-commit fsync failed; the batch is flushed to "
                    f"the OS but unconfirmed on disk: {e}")
            fsync_s = time.perf_counter() - t0
        srv = store._repl_server
        if err is None and srv is not None and store._repl_sync:
            t0 = time.perf_counter()
            acked = False
            try:
                _faults.fire(
                    "repl.ack",
                    lambda: ReplicationIndeterminate(
                        "injected replication ack loss"))
                acked = srv.wait_acked(target, store._repl_timeout_s)
            except ReplicationIndeterminate as e:
                err = e
            ack_s = time.perf_counter() - t0
            if err is None:
                if not acked and store._commit_offset < target:
                    # a checkpoint() interleaved between this batch's
                    # writes and the ack wait: the journal offset space
                    # re-based (followers full-resync from the new
                    # snapshot, which — written under the store lock
                    # AFTER these writes installed — covers every
                    # record), so the old-space target is unreachable
                    # by construction, not unconfirmed.  Same reasoning
                    # as the fsync half's closed-file case.
                    acked = True
                if not acked:
                    err = ReplicationIndeterminate(
                        "followers did not ack within "
                        f"{store._repl_timeout_s}s; the batch is in the "
                        "local journal and MAY be mirrored — it stands "
                        "if this leader survives and resolves at the "
                        "next failover replay otherwise")
                elif (store._repl_min_followers > 0
                      and srv.synced_follower_count
                      < store._repl_min_followers):
                    # same post-wait quorum recheck as the inline path
                    err = ReplicationIndeterminate(
                        "follower lost during ack wait; quorum below "
                        f"{store._repl_min_followers} — the batch is "
                        "journaled locally and may be mirrored")
        _pl = store.partition_label()
        registry.observe("cook_group_commit_batch_size", float(n),
                         buckets=_GC_BATCH_BUCKETS,
                         # per-partition series in the partitioned plane
                         # (docs/OBSERVABILITY.md); the classic plane's
                         # unlabeled series stays wire-identical
                         labels={"partition": _pl} if _pl else None)
        self.batches += 1
        self.max_batch_seen = max(self.max_batch_seen, n)
        if err is None:
            self.commits += n
        else:
            self.indeterminate += n
        for w in batch:
            w.batch_size = n
            w.fsync_s = fsync_s
            w.ack_s = ack_s
            w.error = err
            w.done.set()


#: The journal record-kind PROTOCOL REGISTRY — the one static home of
#: every top-level key a journal record may carry (docs/ROBUSTNESS.md
#: replay-completeness contract).  The `cs lint` journal-record pass
#: (cook_tpu/analysis/summaries.py) statically diffs this table against
#: (a) every key written at a ``journal_file.write(json.dumps(...))``
#: site and (b) every key handled by ``_apply_journal_record`` /
#: ``_replay_records`` — so a new record kind cannot ship without a
#: replay handler (it would silently vanish on leader replay, on
#: checkpoint re-seed, and on the read-replica tail), and a retired
#: kind cannot linger here undocumented.  Each value states the
#: kind's replay + checkpoint semantics.
JOURNAL_RECORD_KINDS: Dict[str, str] = {
    "tx": "transaction id high-water mark; applied by "
          "_apply_journal_record, re-derived from the snapshot after a "
          "checkpoint compaction",
    "ep": "election-epoch qualifier; drives the fence-skip rule in "
          "_replay_records (one home, shared with the read-replica "
          "tail) — lower-epoch records after a higher-epoch one were "
          "appended by a deposed leader and never committed",
    "barrier": "leader-takeover no-op marking the epoch boundary "
               "(open_exclusive); consumed by _replay_records, never "
               "applied as state",
    "w": "entity writes (table/key -> json); replayed by "
         "_apply_journal_record, absorbed into the snapshot at "
         "checkpoint",
    "d": "entity deletes (table/key); replayed by "
         "_apply_journal_record, absorbed into the snapshot at "
         "checkpoint",
    "lr": "latch registrations (latch uuid -> job uuids); replayed by "
          "_apply_journal_record, snapshot carries the latch table",
    "lp": "latch pops; replayed by _apply_journal_record",
    "a": "per-job audit docs (utils/audit.py) riding their txn record "
         "or a flush_audit advisory batch; replayed into the audit "
         "trail, RE-SEEDED into the fresh journal at checkpoint "
         "(the snapshot carries no audit lane), and applied by the "
         "read-replica tail so follower timeline GETs work",
}


class Store:
    """Thread-safe entity store. All mutation goes through :meth:`transact`."""

    def __init__(self, partition: Optional[int] = None) -> None:
        #: partition index when this store is one shard of a partitioned
        #: write plane (state/partition.py): scopes the lock names into
        #: the ``store[pN]`` rank family, qualifies the commit token with
        #: ``pN:`` (its own offset space — offsets are NEVER comparable
        #: across partitions), and labels the per-partition metrics.
        #: None = the classic single-store plane, wire-compatible with
        #: every prior round (P=1 compatibility mode).
        self.partition = partition
        _sfx = f"[p{partition}]" if partition is not None else ""
        # named+ranked for the lock-order sanitizer (utils/locks.py owns
        # the global acquisition-order contract; docs/ANALYSIS.md) —
        # partitioned stores get sibling-suffixed names so cross-partition
        # nesting is a reported violation from day one
        self._lock = named_rlock("store" + _sfx)
        # Injectable clock for every entity timestamp (submit/start/end/
        # queue-time); the simulator swaps in its virtual clock so recorded
        # wait times stay in trace time instead of mixing epochs.
        self.clock = now_ms
        self._jobs: Dict[str, Job] = {}
        self._instances: Dict[str, Instance] = {}
        self._groups: Dict[str, Group] = {}
        self._pools: Dict[str, Pool] = {}
        self._shares: Dict[str, ShareEntry] = {}   # key: f"{user}/{pool}"
        self._quotas: Dict[str, QuotaEntry] = {}   # key: f"{user}/{pool}"
        # dynamic config documents (reference: the DB-backed no-restart
        # config planes — rebalancer params at rebalancer.clj:535-557)
        self._configs: Dict[str, Dict[str, Any]] = {}
        # crash-consistent launch intents: one record per instance whose
        # backend dispatch has not been confirmed yet, written in the SAME
        # transaction as the instance (docs/ROBUSTNESS.md).  A leader that
        # dies between match and launch-ack leaves the intent in the
        # journal; startup reconciliation sweeps intents against actual
        # cluster state so the task is exactly-once relaunched or refunded
        # — never duplicated, never lost.
        self._intents: Dict[str, Dict[str, Any]] = {}
        self._latches: Dict[str, List[str]] = {}   # latch uuid -> job uuids
        self._tx_id = 0
        self._subscribers: List[Callable[[int, List[TxEvent]], None]] = []
        # Commit-ordered event delivery (the reference's tx-report *queue*):
        # events enqueue under the main lock and drain under _notify_lock, so
        # subscribers always observe transactions in tx_id order.
        self._event_queue: List[Tuple[int, List[TxEvent]]] = []
        self._notify_lock = named_lock("store.notify" + _sfx)
        self._draining = threading.local()
        # durable redo journal (attached via attach_journal / Store.open)
        self._journal_file = None
        self._journal_path: Optional[str] = None
        self._journal_dir: Optional[str] = None
        self._journal_fsync = False
        self._journal_poisoned = False
        # election-epoch fencing for a SHARED journal directory (the
        # reference's Datomic transactor is a networked store any new
        # leader re-reads, mesos.clj:153-328; here the journal dir is the
        # shared medium, so a deposed-but-alive leader must be prevented
        # from appending records a successor would replay)
        self._journal_epoch: Optional[int] = None
        self._epoch_path: Optional[str] = None
        self._epoch_stat: Optional[Tuple[int, int]] = None
        # socket journal replication (state/replication.py): when attached
        # with sync=True, a transaction only commits once every connected
        # follower fsynced its journal record (networked-durability slot,
        # reference: datomic.clj:79 out-of-process store)
        self._repl_server = None
        self._repl_sync = False
        self._repl_timeout_s = 5.0
        self._repl_min_followers = 0
        # byte offset of the journal end after the most recent committed
        # record — the leader's commit position, returned on REST write
        # responses (X-Cook-Commit-Offset) so clients can demand
        # read-your-writes from the follower fleet
        self._commit_offset = 0
        # group-commit admission batching (docs/PERFORMANCE.md): when
        # enabled, concurrent transactions' fsync + replication ack
        # rounds are amortized by a single committer thread
        self._group_commit: Optional[_GroupCommitStage] = None
        # True when the journal DIRECTORY is shared between leader hosts
        # (the shared-directory topology: fencing protects concurrent appenders).  False for
        # a local fenced journal in the replication topology, where a
        # failed append may safely truncate (no concurrent appender).
        self._journal_shared = True
        # storage-integrity bookkeeping (docs/ROBUSTNESS.md WAL v2): the
        # background scrub's verified frontier + corruption/repair
        # counters, the boot hygiene sweep's removal count, and ENOSPC
        # clean aborts — surfaced on GET /debug/storage and the monitor's
        # storage sweep
        self._scrub_offset = 0
        self._scrub_corruptions = 0
        self._scrub_repairs = 0
        self._scrub_last_ts = 0.0
        self._hygiene_removed = 0
        self._enospc_aborts = 0
        # per-job scheduling audit trail (utils/audit.py): lifecycle
        # events feed off this store's tx events and are journaled
        # atomically with their transaction ("a" key on the txn record);
        # decision paths record advisory events directly and
        # flush_audit() journals them once per cycle.  Store-scoped (not
        # a module global) so a promoted leader's replayed trail is
        # genuinely its own, not a leak from the deposed process.
        from ..utils.audit import AuditTrail
        self.audit = AuditTrail(clock=lambda: self.clock())
        # fed through the commit-ordered subscriber queue (FIRST in the
        # list, ahead of any scheduler subscription): recording inline
        # after the lock release could interleave two transactions'
        # lifecycle events out of commit order (e.g. "instance: running"
        # before "launched"), diverging from the journal's "a"-record
        # order a promoted leader would replay
        self._subscribers.append(
            lambda _tx_id, events: self.audit.on_tx_events(events))

    # ------------------------------------------------------------------ txns
    def transact(self, fn: Callable[[_Txn], Any]) -> Any:
        """Run ``fn`` transactionally. Its writes are installed atomically on
        normal return; AbortTransaction rolls back and re-raises.

        :class:`ReplicationIndeterminate` is the one exception that does
        NOT roll back: the record is already durable in the local journal
        (and possibly on a mirror), so the writes install locally and the
        exception re-raises for the caller to report the ambiguous
        outcome (docs/DEPLOY.md indeterminate-commit contract).

        Under group commit the record is written+flushed (and the writes
        installed) inside the lock as always, but the fsync/replication-
        ack round resolves on the shared committer AFTER the lock is
        released — this thread blocks on its waiter and re-raises the
        demuxed outcome, so callers observe the same contract with the
        expensive tail amortized across concurrent committers."""
        indeterminate: Optional[ReplicationIndeterminate] = None
        waiter: Optional[_CommitWaiter] = None
        with self._lock:
            if self._journal_poisoned:
                raise RuntimeError(
                    "journal poisoned by a failed append; reopen the store")
            txn = _Txn(self)
            result = fn(txn)  # AbortTransaction propagates; nothing installed
            if __debug__:
                txn._verify_peeks()
            self._tx_id += 1
            # Write-ahead: journal BEFORE installing, so a failed append
            # (disk full, bad fd) aborts the transaction instead of leaving
            # committed in-memory state that silently vanishes on replay.
            # A torn tail line is truncated by recovery on the next open.
            if self._journal_file is not None and (
                    txn._writes or txn._deletes or txn.latch_registrations
                    or txn.latch_pops):
                try:
                    waiter = self._journal_append(txn)
                except ReplicationIndeterminate as e:
                    indeterminate = e  # locally durable: install below
            for (table, key), ent in txn._writes.items():
                getattr(self, "_" + table)[key] = ent
            for table, key in txn._deletes:
                getattr(self, "_" + table).pop(key, None)
            for latch, uuids in txn.latch_registrations:
                self._latches.setdefault(latch, []).extend(uuids)
            for latch in txn.latch_pops:
                self._latches.pop(latch, None)
            if txn.events:
                self._event_queue.append((self._tx_id, txn.events))
        self._drain_events()
        if waiter is not None:
            err = waiter.stage.wait(waiter)
            # attribute the SHARED round's cost into this request's own
            # trace/phase breakdown (rest/instrument.py PHASE_SPANS):
            # the committer measured it once; every waiter reports it
            if tracing.tracer.io_spans \
                    and tracing.tracer.current() is not None:
                if waiter.fsync_s:
                    tracing.tracer.record_finished(
                        "journal.fsync", waiter.fsync_s,
                        batch=waiter.batch_size, offset=waiter.offset)
                if waiter.ack_s:
                    tracing.tracer.record_finished(
                        "repl.ack_wait", waiter.ack_s,
                        batch=waiter.batch_size, offset=waiter.offset)
            if err is not None and indeterminate is None:
                indeterminate = err if isinstance(
                    err, ReplicationIndeterminate) \
                    else ReplicationIndeterminate(str(err))
        if indeterminate is not None:
            raise indeterminate
        return result

    def _journal_append(self, txn: _Txn) -> None:
        """Append one committed transaction to the redo journal (caller holds
        the store lock, so records are in commit order).  Returns a
        :class:`_CommitWaiter` when the durability tail (fsync +
        replication ack) was handed to the group-commit stage — transact
        blocks on it outside the lock — and None when it completed
        inline.

        On a failed append the torn fragment is truncated away so later
        appends stay parseable; if even the truncate fails the journal is
        poisoned (closed) and every subsequent transact raises — recovery
        only repairs a torn TAIL, so writing anything after an unexcised
        fragment would silently discard it and everything later on replay.
        """
        if self._journal_epoch is not None:
            self._check_fence()
        rec: Dict[str, Any] = {"tx": self._tx_id}
        if self._journal_epoch is not None:
            rec["ep"] = self._journal_epoch
        if txn._writes:
            rec["w"] = {f"{table}/{key}": to_json(ent)
                        for (table, key), ent in txn._writes.items()}
        if txn._deletes:
            rec["d"] = [f"{table}/{key}" for table, key in txn._deletes]
        if txn.latch_registrations:
            rec["lr"] = txn.latch_registrations
        if txn.latch_pops:
            rec["lp"] = txn.latch_pops
        if txn.events and self.audit.enabled and self.audit.journal:
            # lifecycle audit docs ride the SAME record as their
            # transaction: replay (and a promoted mirror's replay)
            # rebuilds the per-job timeline with zero extra appends
            from ..utils.audit import tx_event_to_audit
            ts = self.clock()
            docs = []
            for e in txn.events:
                wire = tx_event_to_audit(e)
                if wire is not None:
                    uuid, kind, data = wire
                    docs.append({"u": uuid, "k": kind, "t": ts,
                                 **({"d": data} if data else {})})
            if docs:
                rec["a"] = docs
        f = self._journal_file
        # every append flushes, so the buffer is empty here and tell() is
        # the true end-of-good-records offset
        good_offset = f.tell()
        from ..utils.faults import injector as _faults
        # Pre-write replication gates: failures HERE are clean aborts —
        # the record exists nowhere, so nothing to excise and no phantom
        # possible.  The CP quorum gate moved ahead of the write for
        # exactly that reason: refusing AFTER the write would leave a
        # record some catching-up follower may already be pulling.
        if self._repl_server is not None:
            _faults.fire(
                "repl.stream",
                lambda: ReplicationTimeout("injected replication "
                                           "stream fault"))
            if (self._repl_sync and self._repl_min_followers > 0 and
                    self._repl_server.synced_follower_count
                    < self._repl_min_followers):
                # SYNCED followers: one mid-catch-up neither acks nor
                # counts, else the CP gate would pass while wait_acked
                # ignores it (vacuous durability)
                raise ReplicationTimeout(
                    f"{self._repl_server.synced_follower_count} "
                    "synced follower(s) < required "
                    f"{self._repl_min_followers}")
        # request-path I/O spans (docs/OBSERVABILITY.md serving plane):
        # opened only under an ACTIVE trace — a REST write's http.request
        # root or a scheduler cycle — so bare-store bulk loads and
        # background status txns stay span-free.  tracer.io_spans is the
        # rest_plane bench's A/B gate for exactly this instrumentation.
        _io = tracing.tracer.io_spans and tracing.tracer.current() is not None
        # group commit engages only when there is a durability tail to
        # amortize (an fsync or a sync replication ack); otherwise the
        # inline path below already ends at the flush
        _gc = self._group_commit if (
            self._group_commit is not None
            and (self._journal_fsync
                 or (self._repl_server is not None and self._repl_sync))
        ) else None
        # the ONE blessed appender: every record leaves through
        # seal_record's checksummed v2 frame (state/integrity.py) — the
        # `cs lint` journal-raw-write pass rejects journal writes that
        # bypass it, because an unsealed line replays as v1 and forfeits
        # mid-file corruption detection for itself and its era
        line = seal_record(rec)
        waiter: Optional[_CommitWaiter] = None
        try:
            with (tracing.span("journal.append", bytes=len(line),
                               fsync=(self._journal_fsync and _gc is None)
                               or None)
                  if _io else nullcontext()):
                _faults.fire(
                    "store.journal.append",
                    lambda: OSError("injected journal write failure"))
                _faults.fire(
                    "store.journal.enospc",
                    lambda: OSError(errno.ENOSPC,
                                    "injected disk full on append"))
                if _faults.should_fire("store.journal.torn_write"):
                    # a PREFIX of the frame lands, then the write fails —
                    # exactly the shape a crash mid-append leaves on
                    # disk, driving the except-handler's excision
                    cut = _faults.point_arg("store.journal.torn_write")
                    cut = int(cut) if cut is not None else len(line) // 2
                    # injected torn PREFIX of an already-sealed frame
                    # cs-lint: allow=journal-raw-write
                    f.write(line[:max(1, min(cut, len(line) - 1))])
                    f.flush()
                    raise OSError("injected torn journal write")
                f.write(line)
                f.flush()
                if _faults.should_fire("store.journal.bitflip"):
                    # silent bit rot inside the just-written frame: no
                    # error surfaces here by design — detection belongs
                    # to the CRC at scrub/replay time, never to the
                    # happy path
                    self._flip_bit(good_offset, len(line))
                if self._journal_fsync and _gc is None:
                    if _faults.should_fire("store.journal.fsync_lie"):
                        # the ATC'20 lie: fsync reports EIO, the page
                        # cache silently DROPS the dirty frame, and the
                        # next fsync succeeds as if nothing happened.
                        # Model the loss before raising; the abort path
                        # must not count this record as committed.
                        f.seek(good_offset)
                        f.truncate(good_offset)
                        raise OSError(errno.EIO, "injected fsync lie")
                    _faults.fire(
                        "store.journal.fsync",
                        lambda: OSError("injected journal fsync failure"))
                    os.fsync(f.fileno())
            self._commit_offset = f.tell()
            if self._repl_server is not None:
                # From here on the record is durable locally and visible
                # to followers: an unconfirmed ack is a first-class
                # INDETERMINATE outcome, not an abort.  Excising the
                # record (as an abort once did) could resurrect it as a
                # phantom commit on a mirror that fsynced it before a
                # failover — "aborted" must imply "nowhere".
                # Poked inline even under group commit: followers start
                # pulling while the batch coalesces.
                self._repl_server.poke()
            if _gc is not None:
                # the durability tail (fsync + ack) resolves on the
                # shared committer; transact blocks on the waiter AFTER
                # releasing the store lock and demuxes the outcome
                waiter = _gc.enqueue(self._commit_offset)
            elif self._repl_server is not None and self._repl_sync:
                with (tracing.span(
                        "repl.ack_wait", offset=f.tell(),
                        timeout_s=self._repl_timeout_s)
                      if _io else nullcontext()):
                    _faults.fire(
                        "repl.ack",
                        lambda: ReplicationIndeterminate(
                            "injected replication ack loss"))
                    acked = self._repl_server.wait_acked(
                        f.tell(), self._repl_timeout_s)
                if not acked:
                    raise ReplicationIndeterminate(
                        "followers did not ack within "
                        f"{self._repl_timeout_s}s; the record is in "
                        "the local journal and MAY be mirrored — "
                        "the commit stands if this leader survives "
                        "and resolves at the next failover replay "
                        "otherwise")
                if (self._repl_min_followers > 0 and
                        self._repl_server.synced_follower_count
                        < self._repl_min_followers):
                    # re-check AFTER the wait: a follower dying
                    # between the gate and the ack makes wait_acked
                    # pass vacuously (empty quorum) — that must not
                    # count as a confirmed CP commit
                    raise ReplicationIndeterminate(
                        "follower lost during ack wait; quorum "
                        f"below {self._repl_min_followers} — the "
                        "record is journaled locally and may be "
                        "mirrored")
        except ReplicationIndeterminate:
            raise  # durable locally: transact installs, caller reports
        except Exception as e:
            try:
                if self._journal_epoch is not None and self._journal_shared:
                    # SHARED journal: our tell() may be stale (a successor
                    # could have appended past it) — truncating would chop
                    # its records.  Poison instead; replay's torn-tail and
                    # stale-epoch handling repair the file on next open.
                    # (A LOCAL fenced journal — the replication topology —
                    # has no concurrent appender, so truncation is safe.)
                    raise OSError("fenced journal: no truncate")
                f.seek(good_offset)
                f.truncate(good_offset)
                self._bump_journal_gen()
            except Exception:
                # can't excise the torn fragment: poison the journal so no
                # later record can be appended after it
                self._journal_file = None
                self._journal_poisoned = True
                try:
                    f.close()
                except Exception:
                    pass
            if isinstance(e, OSError) and e.errno == errno.ENOSPC:
                # disk full is an OPERATIONAL condition, not disk damage:
                # the excision above already made it a clean abort, so
                # surface a typed error the REST layer maps to 503 +
                # admission write-shed instead of a dead daemon
                self._enospc_aborts += 1
                _metrics.counter_inc("cook_storage_enospc")
                raise StorageFullError(str(e)) from e
            raise
        return waiter

    def _flip_bit(self, start: int, length: int) -> None:
        """Flip one bit inside the journal byte range ``[start,
        start+length)`` — the ``store.journal.bitflip`` fault body,
        modeling silent media corruption UNDER a live appender.  The
        armed point's ``arg`` picks the byte offset within the frame
        (default: mid-payload, past the header so the CRC — not the
        frame parser — must catch it)."""
        if not self._journal_path or length <= 0:
            return
        from ..utils.faults import injector as _faults
        off = _faults.point_arg("store.journal.bitflip")
        off = int(off) if off is not None else length // 2
        off = max(0, min(off, length - 2))  # keep the newline intact
        try:
            with open(self._journal_path, "r+b") as bf:
                bf.seek(start + off)
                b = bf.read(1)
                if not b:
                    return
                bf.seek(start + off)
                bf.write(bytes([b[0] ^ 0x40]))
        except OSError:
            pass

    def enable_group_commit(self, window_ms: float = 0.5,
                            max_batch: int = 256) -> bool:
        """Arm the group-commit stage (docs/PERFORMANCE.md): concurrent
        write transactions share one journal fsync + one replication ack
        round, with per-request outcomes demultiplexed.  Returns False
        (a no-op) on a store without an attached journal — there is no
        durability tail to amortize.  Idempotent."""
        with self._lock:
            if self._group_commit is not None:
                return True
            if self._journal_file is None:
                return False
            self._group_commit = _GroupCommitStage(
                self, window_ms=window_ms, max_batch=max_batch)
        return True

    def disable_group_commit(self) -> None:
        """Drain and stop the committer; later transactions go back to
        inline fsync/ack."""
        with self._lock:
            gc, self._group_commit = self._group_commit, None
        if gc is not None:
            gc.stop()

    def group_commit_stats(self) -> Optional[Dict[str, Any]]:
        """Committer counters for /debug/replication and the monitor
        sweep (None when group commit is off)."""
        gc = self._group_commit
        return gc.stats() if gc is not None else None

    def commit_offset(self) -> int:
        """Journal byte offset after the most recently committed record.
        0 on journal-less stores."""
        return self._commit_offset

    def partition_label(self) -> Optional[str]:
        """``"p<i>"`` on a partitioned shard, None on the classic
        single-store plane — the metric-label / token-prefix form."""
        return f"p{self.partition}" if self.partition is not None else None

    def commit_token(self) -> str:
        """The read-your-writes token leader write responses carry
        (X-Cook-Commit-Offset; docs/DEPLOY.md): ``<epoch>:<offset>`` on
        epoch-fenced journals, bare ``<offset>`` otherwise.  The epoch
        qualifies the OFFSET SPACE — a follower still mirroring a
        previous leadership must not satisfy a new-space token just
        because its old-space byte count is numerically larger (every
        leadership change mints a higher epoch, and a determinate
        commit survives into every later epoch's journal by the no-loss
        guarantee).

        On a PARTITIONED shard the token is additionally qualified
        ``p<partition>:<epoch>:<offset>`` — the partition names the
        journal the offset lives in; two partitions' offsets are never
        comparable (state/partition.py owns the vector form clients
        carry)."""
        if self._journal_epoch is not None:
            token = f"{self._journal_epoch}:{self._commit_offset}"
        else:
            token = str(self._commit_offset)
        if self.partition is not None:
            return f"p{self.partition}:{token}"
        return token

    def flush_audit(self) -> int:
        """Journal the audit trail's pending ADVISORY events (ranked
        positions, skip/defer attributions) as one ``{"a": [...]}``
        record — called once per scheduler cycle, so pre-failover
        decision context survives a leader kill the same way entity
        state does (lifecycle events already rode their own txn
        records).  The advisory lane must never hurt the store: a
        fenced/deposed leader drops the flush silently, and a failed
        append excises its torn fragment with the same truncate/poison
        discipline as _journal_append (a torn audit line would merge
        with the NEXT committed record at replay and lose it).
        Returns the number of events journaled."""
        self.audit.publish_metrics()
        if not (self.audit.enabled and self.audit.journal) \
                or self._journal_file is None or self._journal_poisoned:
            # no durability to provide: drop the pending refs WITHOUT
            # serializing them (the in-memory lanes keep everything)
            self.audit.discard_pending()
            return 0
        with self._lock:
            if self._journal_file is None or self._journal_poisoned:
                self.audit.discard_pending()
                return 0
            if self._journal_epoch is not None:
                try:
                    self._check_fence()
                except StaleEpochError:
                    return 0  # deposed: advisory events just drop
            # drain UNDER the store lock (store lock -> audit lock is
            # the one ordering used everywhere): drained-but-unappended
            # events outside the lock could race a concurrent
            # checkpoint()'s re-seed and land in the fresh journal twice
            recs = self.audit.drain_durable()
            if not recs:
                return 0
            if not self._write_audit_record_locked(recs):
                return 0
        return len(recs)

    def _write_audit_record_locked(self, recs: List[Dict[str, Any]]
                                   ) -> bool:
        """Append one ``{"a": [...]}`` record; caller holds the store
        lock and has fence-checked.  Shares _journal_append's torn-write
        discipline (truncate the fragment, or poison when it can't be
        excised — a torn line would merge with the NEXT committed
        record at replay and lose it) and honors the fsync setting.
        Returns False on failure (advisory loss, store stays healthy)."""
        f = self._journal_file
        rec: Dict[str, Any] = {"a": recs}
        if self._journal_epoch is not None:
            rec["ep"] = self._journal_epoch
        good_offset = f.tell()
        try:
            f.write(seal_record(rec))
            f.flush()
            if self._journal_fsync:
                os.fsync(f.fileno())
        except Exception:
            try:
                if self._journal_epoch is not None \
                        and self._journal_shared:
                    raise OSError("fenced journal: no truncate")
                f.seek(good_offset)
                f.truncate(good_offset)
                self._bump_journal_gen()
            except Exception:
                self._journal_file = None
                self._journal_poisoned = True
                try:
                    f.close()
                except Exception:
                    pass
            return False
        self._commit_offset = f.tell()
        if self._repl_server is not None:
            # audit records mirror like any journal bytes, but are
            # never waited on — audit must not add commit latency
            self._repl_server.poke()
        return True

    def _bump_journal_gen(self) -> None:
        """Advance ``<dir>/journal_gen`` after ANY journal truncation.
        The replication server folds this counter into its mirror-base
        token, so a truncate-then-reappend (an excised aborted record
        replaced by a later commit of equal byte length) forces followers
        to full-resync instead of silently accepting diverged bytes at
        the same offset."""
        if not self._journal_dir:
            return
        from ..utils.fsatomic import read_int_file, write_atomic_int
        path = os.path.join(self._journal_dir, "journal_gen")
        write_atomic_int(path, (read_int_file(path, 0) or 0) + 1)

    def _drain_events(self) -> None:
        """Deliver queued events in commit order. Whoever holds _notify_lock
        drains everything; other committers' events ride along in order.
        A subscriber that itself transacts enqueues new events and returns —
        the outer drain loop delivers them after the current round, keeping
        every subscriber's view in tx_id order (and avoiding re-entry)."""
        if getattr(self._draining, "active", False):
            return
        while not self._notify_lock.acquire(blocking=False):
            # Another thread is draining and will deliver our events — unless
            # it is just exiting; spin until the queue empties or we win the
            # lock (waiting blocking would serialize commits behind callbacks).
            with self._lock:
                if not self._event_queue:
                    return
            time.sleep(0)
        self._draining.active = True
        try:
            while True:
                with self._lock:
                    if not self._event_queue:
                        return
                    tx_id, events = self._event_queue.pop(0)
                    subscribers = list(self._subscribers)
                for sub in subscribers:
                    sub(tx_id, events)
        finally:
            self._draining.active = False
            self._notify_lock.release()

    def subscribe(self, fn: Callable[[int, List[TxEvent]], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def ensure_index(self):
        """The columnar rank-path projection (state/index.py), attached on
        first use and kept fresh off the tx feed."""
        with self._lock:
            if getattr(self, "_index", None) is None:
                from .index import ColumnarIndex
                self._index = ColumnarIndex(self)
            return self._index

    # ----------------------------------------------------------- submission
    def create_jobs(self, jobs: Iterable[Job], groups: Iterable[Group] = (),
                    latch: Optional[str] = None) -> List[str]:
        """Batch-submit jobs. With ``latch``, jobs are invisible until
        :meth:`commit_latch` (metatransaction semantics)."""
        jobs = list(jobs)

        def _create(txn: _Txn) -> List[str]:
            now = self.clock()  # one clock read per batch, not per job
            for group in groups:
                existing = txn.group(group.uuid)
                if existing is not None:
                    merged = txn.group_w(group.uuid)
                    merged.jobs.extend(j for j in group.jobs if j not in merged.jobs)
                else:
                    txn.put("groups", group.uuid, fast_clone(group))
            uuids = txn.create_new_jobs(jobs, now,
                                        committed=latch is None)
            if latch is not None:
                # applied atomically with the commit, so a snapshot or a
                # concurrent commit_latch can never observe the jobs without
                # their latch entry (which would strand them uncommitted)
                txn.latch_registrations.append((latch, uuids))
            return uuids

        return self.transact(_create)

    def commit_jobs(self, uuids: List[str]) -> int:
        """Mark already-present jobs committed (visible) directly — the
        idempotent-resubmission healer: a replication-indeterminate
        submission can leave jobs created but their latch never
        committed; the client's retry (same uuids) lands here and makes
        them visible instead of stranding them forever."""

        def _commit(txn: _Txn) -> int:
            n = 0
            target = set(uuids)
            for uuid in uuids:
                job = txn.job(uuid)
                if job is not None and not job.committed:
                    job = txn.job_w(uuid)
                    job.committed = True
                    txn.event("job-committed", uuid=uuid)
                    n += 1
            # reap latches the indeterminate submission stranded: once
            # every member is committed (or gone), commit_latch will
            # never pop the entry, and it would otherwise leak into
            # every future checkpoint and replay
            for latch, members in self._latches.items():
                if all(u in target
                       or (j := txn.peek("jobs", u)) is None or j.committed
                       for u in members):
                    txn.latch_pops.append(latch)
            return n

        return self.transact(_commit)

    def commit_latch(self, latch: str) -> None:
        def _commit(txn: _Txn) -> None:
            # transact holds the store lock while fn runs, so the read of
            # _latches and the pop below are atomic with the job writes
            uuids = self._latches.get(latch, [])
            txn.latch_pops.append(latch)
            for uuid in uuids:
                job = txn.job_w(uuid)
                if job is not None:
                    job.committed = True
                    txn.event("job-committed", uuid=uuid)

        self.transact(_commit)

    def discard_latched(self, latch: str) -> int:
        """Abort a latched (still-invisible) sub-batch: delete its
        uncommitted jobs, scrub them out of any group they were merged
        into (dropping groups left empty), and pop the latch.  The
        rollback half of the partitioned facade's cross-partition
        fan-out (state/partition.py): when a LATER partition's
        sub-batch aborts, the earlier partitions' latched jobs were
        never observable — deleting them restores all-or-nothing
        submission semantics.  Jobs already committed (a concurrent
        commit_latch/commit_jobs won the race) are left alone."""

        def _discard(txn: _Txn) -> int:
            doomed = set()
            for uuid in self._latches.get(latch, []):
                job = txn.job(uuid)
                if job is not None and not job.committed:
                    txn.delete("jobs", uuid)
                    doomed.add(uuid)
            if doomed:
                for guuid in list(self._groups):
                    g = txn.group(guuid)
                    if g is None or not (set(g.jobs) & doomed):
                        continue
                    keep = [u for u in g.jobs if u not in doomed]
                    if keep:
                        txn.group_w(guuid).jobs = keep
                    else:
                        txn.delete("groups", guuid)
            txn.latch_pops.append(latch)
            return len(doomed)

        return self.transact(_discard)

    # -------------------------------------------------------------- launches
    def launch_instance(self, job_uuid: str, task_id: str, hostname: str,
                        slave_id: str = "", compute_cluster: str = "",
                        ports: Optional[List[int]] = None,
                        node_location: str = "") -> Instance:
        """Create an instance under the allowed-to-start guard; aborts (and
        therefore blocks the backend launch) if the job state moved
        (reference: scheduler.clj:987-1009 + schema.clj:1311-1325).
        Single-entry form of :meth:`launch_instances` (one body, one
        invariant)."""
        insts, failures = self.launch_instances([dict(
            job_uuid=job_uuid, task_id=task_id, hostname=hostname,
            slave_id=slave_id, compute_cluster=compute_cluster,
            ports=ports, node_location=node_location)])
        if failures:
            raise AbortTransaction(failures[0][1])
        return insts[0]

    def launch_instances(self, entries: List[Dict[str, Any]]
                         ) -> Tuple[List[Instance], List[Tuple[str, str]]]:
        """Batched launch guard: ONE transaction for a whole match cycle's
        launches (reference: launch-matched-tasks! builds every task txn and
        transacts once, scheduler.clj:810-1009), instead of a lock/journal/
        event-drain round per task.  Jobs whose allowed-to-start guard fails
        are skipped and reported — the transactional invariant (guard
        failure blocks the backend launch) holds per job.

        ``entries``: dicts with job_uuid, task_id, hostname and optional
        slave_id, compute_cluster, ports, node_location, gang (gang group
        uuid).  Entries sharing a ``gang`` are all-or-nothing: one
        member's guard denial fails every member in the same transaction
        — no partial gang ever launches (docs/GANG.md).  Returns
        (created instances, [(job_uuid, deny-reason), ...])."""

        def _launch_all(txn: _Txn):
            out: List[Instance] = []
            failures: List[Tuple[str, str]] = []
            t = self.clock()  # one clock read per batch (as create_jobs)
            # the enclosing scheduler cycle's trace: recorded on every
            # launched audit event so /debug/trace?job= can pull the
            # cycle flamegraph that placed the job next to its
            # submission request track (docs/OBSERVABILITY.md)
            _cur = tracing.tracer.current()
            cycle_trace = _cur.trace_id if _cur is not None else None
            # pass 1 — guards only (peek, no writes): gang atomicity needs
            # every member's verdict BEFORE any member's instance is put
            denied: Dict[int, str] = {}
            seen_jobs: set = set()
            for i, e in enumerate(entries):
                # the sequential guard used to catch a duplicate job via
                # its freshly-created live instance; the two-pass form
                # must deny it explicitly
                if e["job_uuid"] in seen_jobs:
                    denied[i] = "duplicate-in-batch"
                    continue
                seen_jobs.add(e["job_uuid"])
                # guard on a non-cloning PEEK: taking write intent first
                # would install (and journal) the unchanged entity even
                # when the guard denies — a lingering denied job would
                # append a no-op record to the redo journal every match
                # cycle — and a cloning read would pay a full Job copy
                # per launch just to inspect it (the hot path at 1000+
                # launches/cycle; txn.job_w below still owns the single
                # defensive clone for the mutation)
                job = txn.peek("jobs", e["job_uuid"])
                if job is None:
                    denied[i] = "no-such-job"
                    continue
                deny = machines.allowed_to_start(
                    job, txn.peek_instances_of(job))
                if deny is not None:
                    denied[i] = deny
            # gang propagation: any denied member denies its whole gang
            by_gang: Dict[str, List[int]] = {}
            for i, e in enumerate(entries):
                g = e.get("gang")
                if g:
                    by_gang.setdefault(g, []).append(i)
            for g, idxs in by_gang.items():
                bad = [i for i in idxs if i in denied]
                if bad:
                    reason = denied[bad[0]]
                    for i in idxs:
                        denied.setdefault(
                            i, f"gang-member-denied:{reason}")
            # pass 2 — create instances for the allowed entries
            for i, e in enumerate(entries):
                if i in denied:
                    failures.append((e["job_uuid"], denied[i]))
                    continue
                job = txn.job_w(e["job_uuid"])
                hostname = e["hostname"]
                inst = Instance(
                    task_id=e["task_id"], job_uuid=e["job_uuid"],
                    hostname=hostname,
                    slave_id=e.get("slave_id") or hostname,
                    compute_cluster=e.get("compute_cluster", ""),
                    status=InstanceStatus.UNKNOWN, start_time_ms=t,
                    ports=e.get("ports") or [],
                    node_location=e.get("node_location", ""),
                    queue_time_ms=max(0, t - job.last_waiting_start_ms))
                txn.put("instances", e["task_id"], inst)
                # launch intent, atomic with the instance: the dispatch to
                # the backend has NOT happened yet.  Cleared by the first
                # status update or an explicit clear_launch_intents after
                # the backend acked; swept by leader-startup reconciliation
                # against actual cluster state otherwise.
                txn.put("intents", e["task_id"], {
                    "task_id": e["task_id"], "job_uuid": e["job_uuid"],
                    "compute_cluster": e.get("compute_cluster", ""),
                    "hostname": hostname, "created_ms": t,
                    # gang group uuid: leader-startup reconciliation
                    # sweeps a gang's intents as one unit (refund any ->
                    # refund all, docs/GANG.md)
                    **({"gang": e["gang"]} if e.get("gang") else {})})
                job.instances.append(e["task_id"])
                job.state = JobState.RUNNING
                txn.event("instance-created", task_id=e["task_id"],
                          job=e["job_uuid"], hostname=hostname,
                          **({"gang": e["gang"]} if e.get("gang")
                             else {}),
                          **({"trace": job.trace_id}
                             if job.trace_id else {}),
                          **({"cycle_trace": cycle_trace}
                             if cycle_trace else {}))
                txn.event("job-state", uuid=e["job_uuid"], old="waiting",
                          new="running", reason=None)
                out.append(inst)
            return out, failures

        return self.transact(_launch_all)

    def update_instance_status(self, task_id: str, new_status: InstanceStatus,
                               reason_code: Optional[int] = None,
                               exit_code: Optional[int] = None,
                               preempted: bool = False,
                               hostname: Optional[str] = None) -> bool:
        """Instance state machine + job writeback (reference:
        :instance/update-state schema.clj:1242-1308). Returns False when the
        transition is illegal (stale status updates are dropped, not errors)."""

        def _update(txn: _Txn) -> bool:
            inst = txn.instance_w(task_id)
            if inst is None:
                return False
            # any backend status proves the dispatch reached the cluster:
            # the launch intent has served its purpose (guarded so the
            # common no-intent case journals nothing extra)
            if task_id in self._intents:
                txn.delete("intents", task_id)
            if inst.status is new_status:
                # Redelivered status (k8s watch replays, mesos re-sends): a
                # pure no-op — must not overwrite end_time/reason/exit_code.
                return True
            if not machines.instance_transition_allowed(inst.status, new_status):
                return False
            old = inst.status
            inst.status = new_status
            if hostname:
                # direct-mode backends report placement with the first status
                inst.hostname = hostname
                if not inst.slave_id:
                    inst.slave_id = hostname
            if reason_code is not None:
                inst.reason_code = reason_code
            if exit_code is not None:
                inst.exit_code = exit_code
            if preempted:
                inst.preempted = True
            if new_status in (InstanceStatus.SUCCESS, InstanceStatus.FAILED):
                inst.end_time_ms = self.clock()
            if new_status is InstanceStatus.RUNNING and inst.mesos_start_time_ms is None:
                inst.mesos_start_time_ms = self.clock()
            if old is not new_status:
                txn.event("instance-status", task_id=task_id, job=inst.job_uuid,
                          old=old.value, new=new_status.value, reason=reason_code)
            job = txn.job_w(inst.job_uuid)
            if job is not None:
                txn.recompute_job_state(job)
            return True

        return self.transact(_update)

    def clear_launch_intents(self, task_ids: List[str]) -> int:
        """Confirm backend dispatch: drop the launch intents for
        ``task_ids`` (a no-op — no transaction at all — for ids whose
        intent was already cleared by a status update)."""
        with self._lock:
            live = [t for t in task_ids if t in self._intents]
        if not live:
            return 0

        def _clear(txn: _Txn) -> int:
            for t in live:
                intent = self._intents.get(t)
                txn.delete("intents", t)
                if intent is not None:
                    # intent -> ack on the job's audit timeline (the
                    # backend confirmed the dispatch; docs/OBSERVABILITY)
                    txn.event("launch-ack", task_id=t,
                              job=intent.get("job_uuid", ""))
            return len(live)

        return self.transact(_clear)

    def launch_intents(self) -> List[Dict[str, Any]]:
        """Open launch intents (dispatch not yet confirmed), oldest first."""
        with self._lock:
            out = [dict(v) for v in self._intents.values()]
        out.sort(key=lambda r: r.get("created_ms", 0))
        return out

    def update_instance_progress(self, task_id: str, progress: int,
                                 message: str = "", sequence: int = 0) -> bool:
        """Progress writeback, monotone by sequence: reordered updates are
        dropped rather than regressing progress (reference: progress
        aggregator keeps latest-by-sequence, progress.clj:34-99)."""

        def _update(txn: _Txn) -> bool:
            inst = txn.instance_w(task_id)
            if inst is None:
                return False
            if sequence < inst.progress_sequence:
                return False
            inst.progress_sequence = sequence
            inst.progress = progress
            if message:
                inst.progress_message = message
            return True

        return self.transact(_update)

    def set_dynamic_config(self, key: str, value: Dict[str, Any]) -> None:
        """Store a dynamic config document (reference: the DB-backed
        no-restart config planes; rebalancer params at
        rebalancer.clj:535-557 are re-read from the DB every cycle)."""

        def _set(txn: _Txn) -> None:
            txn.put("configs", key, dict(value))
            txn.event("config-changed", key=key)

        self.transact(_set)

    def update_dynamic_config(self, key: str,
                              updates: Dict[str, Any]) -> Dict[str, Any]:
        """Atomic read-merge-write of a dynamic config document: concurrent
        updaters of different parameters cannot clobber each other."""

        def _update(txn: _Txn) -> Dict[str, Any]:
            current = dict(txn._get("configs", key, for_write=False) or {})
            current.update(updates)
            txn.put("configs", key, current)
            txn.event("config-changed", key=key)
            return current

        return self.transact(_update)

    def dynamic_config(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            v = self._configs.get(key)
            return dict(v) if v is not None else None

    def update_instance_ports(self, task_id: str, ports) -> bool:
        """Assigned host-port writeback (reference: instance ports land in
        Datomic from the task launch, schema.clj instance :instance/ports)."""

        def _update(txn: _Txn) -> bool:
            inst = txn.instance_w(task_id)
            if inst is None:
                return False
            inst.ports = list(ports)
            return True

        return self.transact(_update)

    def update_instance_sandbox(self, task_id: str,
                                sandbox_directory: Optional[str] = None,
                                output_url: Optional[str] = None) -> bool:
        """Sandbox/file-server writeback (reference: the sandbox publisher
        batches task->sandbox-dir aggregates into Datomic,
        mesos/sandbox.clj:222-353)."""

        def _update(txn: _Txn) -> bool:
            inst = txn.instance_w(task_id)
            if inst is None:
                return False
            if sandbox_directory is not None:
                inst.sandbox_directory = sandbox_directory
            if output_url is not None:
                inst.output_url = output_url
            return True

        return self.transact(_update)

    def kill_job(self, job_uuid: str) -> bool:
        """User kill: mark killed + recompute state; the tx feed's
        job-state->completed event triggers instance kills in the scheduler
        (reference: monitor-tx-report-queue scheduler.clj:405-447)."""

        def _kill(txn: _Txn) -> bool:
            job = txn.job_w(job_uuid)
            if job is None:
                return False
            if job.state is JobState.COMPLETED:
                return True
            job.user_killed = True
            txn.recompute_job_state(job)
            return True

        return self.transact(_kill)

    def set_placement_investigation(self, job_uuid: str,
                                    under_investigation: Optional[bool] = None,
                                    failure: Optional[Dict] = None) -> bool:
        """Update the unscheduled-explainer investigation state (reference:
        :job/under-investigation + :job/last-fenzo-placement-failure,
        unscheduled.clj check-fenzo-placement + fenzo_utils.clj:75-99)."""

        def _set(txn: _Txn) -> bool:
            job = txn.job_w(job_uuid)
            if job is None:
                return False
            if under_investigation is not None:
                job.under_investigation = under_investigation
            if failure is not None:
                job.last_placement_failure = failure
            return True

        return self.transact(_set)

    def retry_job(self, job_uuid: str, retries: int) -> bool:
        """Set max-retries; resurrect a completed job back to waiting if it
        now has attempts left (reference: tools.clj retry-job!)."""

        def _retry(txn: _Txn) -> bool:
            job = txn.job_w(job_uuid)
            if job is None:
                return False
            job.max_retries = retries
            if job.state is JobState.COMPLETED and not job.user_killed:
                insts = txn.instances_of(job)
                has_success = any(i.status is InstanceStatus.SUCCESS for i in insts.values())
                if not has_success and job.attempts_used(insts) < retries:
                    job.state = JobState.WAITING
                    job.last_waiting_start_ms = self.clock()
                    txn.event("job-state", uuid=job_uuid, old="completed",
                              new="waiting", reason="retry")
            return True

        return self.transact(_retry)

    # --------------------------------------------------------------- queries
    def job(self, uuid: str) -> Optional[Job]:
        with self._lock:
            job = self._jobs.get(uuid)
            return fast_clone(job) if job is not None else None

    def jobs_bulk(self, uuids) -> List[Optional[Job]]:
        """Deep-copied reads of many jobs under ONE lock acquisition (the
        per-cycle considerable-prefix materialization does ~1000 reads;
        per-call locking costs more than the copies)."""
        with self._lock:
            return [fast_clone(j) if (j := self._jobs.get(u)) is not None
                    else None for u in uuids]

    # -- borrowed reads -----------------------------------------------------
    # Commits install whole replacement objects (transact's write loop), so
    # a borrowed reference is always a complete, never-again-mutated entity.
    # Callers must treat it as FROZEN: read fields, never mutate or retain
    # past their own critical section.  This is the no-deepcopy path for
    # trusted high-frequency internals (the columnar index's tx-event
    # handler runs for every event of every transaction).
    def job_ref(self, uuid: str) -> Optional[Job]:
        return self._jobs.get(uuid)

    def instance_ref(self, task_id: str) -> Optional[Instance]:
        return self._instances.get(task_id)

    def instance(self, task_id: str) -> Optional[Instance]:
        with self._lock:
            inst = self._instances.get(task_id)
            return fast_clone(inst) if inst is not None else None

    def group(self, uuid: str) -> Optional[Group]:
        with self._lock:
            g = self._groups.get(uuid)
            return fast_clone(g) if g is not None else None

    def group_is_gang(self, uuid: Optional[str]) -> bool:
        """Gang-membership test without the ``group()`` clone — the
        completion hooks consult this for every grouped terminal job,
        gang or not, so it must not pay a deep copy of the member list."""
        if not uuid:
            return False
        with self._lock:
            g = self._groups.get(uuid)
            return bool(g is not None and getattr(g, "gang", False))

    def gang_size(self, uuid: Optional[str]) -> int:
        """Clone-free gang size: 0 for missing or non-gang groups.  The
        per-cycle admission path consults this once per distinct group,
        so ordinary placement groups must not pay a member-list copy."""
        if not uuid:
            return 0
        with self._lock:
            g = self._groups.get(uuid)
            if g is None or not getattr(g, "gang", False):
                return 0
            return int(getattr(g, "gang_size", 0) or 0)

    def gang_live_members(self, uuid: Optional[str]) -> int:
        """Clone-free count of a gang's members with a LIVE instance
        (unknown/running) — the elastic subsystem's "current size" of a
        running gang (docs/GANG.md elasticity).  0 for missing or
        non-gang groups."""
        if not uuid:
            return 0
        with self._lock:
            g = self._groups.get(uuid)
            if g is None or not getattr(g, "gang", False):
                return 0
            live = 0
            for member_uuid in g.jobs:
                j = self._jobs.get(member_uuid)
                if j is None:
                    continue
                if any((i := self._instances.get(t)) is not None
                       and i.status in (InstanceStatus.UNKNOWN,
                                        InstanceStatus.RUNNING)
                       for t in j.instances):
                    live += 1
            return live

    def gang_admission_size(self, uuid: Optional[str]) -> int:
        """Cohort size queue admission must reserve for this group
        (docs/GANG.md): 0 for non-gang groups; ``gang_size`` for rigid
        gangs (unchanged all-or-nothing semantics); for ELASTIC gangs,
        ``gang_min`` while the gang is not yet satisfied, and 0 once it
        runs at >= gang_min live members — a satisfied elastic gang's
        remaining waiting members admit like group-less singles (the
        grow path), no cohort semantics."""
        if not uuid:
            return 0
        from .schema import gang_bounds, gang_is_elastic
        with self._lock:
            g = self._groups.get(uuid)
            if g is None or not getattr(g, "gang", False):
                return 0
            if not gang_is_elastic(g):
                return int(getattr(g, "gang_size", 0) or 0)
            lo, _hi = gang_bounds(g)
            live = 0
            for member_uuid in g.jobs:
                j = self._jobs.get(member_uuid)
                if j is None:
                    continue
                if any((i := self._instances.get(t)) is not None
                       and i.status in (InstanceStatus.UNKNOWN,
                                        InstanceStatus.RUNNING)
                       for t in j.instances):
                    live += 1
                    if live >= lo:
                        return 0  # satisfied: members grow as singles
            return lo

    def gang_growth_headroom(self, uuid: Optional[str]) -> float:
        """How many MORE members this gang may legally admit
        (docs/GANG.md elasticity): ``gang_max - live`` for elastic
        gangs, floored at 0; infinity for rigid/non-gang groups (their
        admission is bounded by the cohort contract, not a cap).  The
        grow path and surplus-single admission consume this so a gang
        never runs past its declared maximum."""
        if not uuid:
            return float("inf")
        from .schema import gang_bounds, gang_is_elastic
        with self._lock:
            g = self._groups.get(uuid)
            if g is None or not gang_is_elastic(g):
                return float("inf")
            _lo, hi = gang_bounds(g)
            live = 0
            for member_uuid in g.jobs:
                j = self._jobs.get(member_uuid)
                if j is None:
                    continue
                if any((i := self._instances.get(t)) is not None
                       and i.status in (InstanceStatus.UNKNOWN,
                                        InstanceStatus.RUNNING)
                       for t in j.instances):
                    live += 1
            return float(max(hi - live, 0))

    def elastic_gang_groups(self) -> List[Group]:
        """Clone of every ELASTIC gang group with at least one live or
        waiting member job — the resize pass's scan set (docs/GANG.md
        elasticity).  Cheap for non-elastic workloads: the elastic test
        is clone-free and ordinary groups are skipped outright."""
        from .schema import gang_is_elastic
        out: List[Group] = []
        with self._lock:
            for g in self._groups.values():
                if not gang_is_elastic(g):
                    continue
                if any((j := self._jobs.get(u)) is not None
                       and j.state is not JobState.COMPLETED
                       for u in g.jobs):
                    out.append(fast_clone(g))
        return out

    def gang_groups_of(self, jobs) -> Dict[str, Group]:
        """The gang Groups these jobs' ``group`` fields reference, one
        lookup per distinct group — the shared gang-membership test for
        every consumer (scheduler resume/autoscale/direct matching, the
        matcher's launch cohorts, the rebalancer's whole-gang closures),
        so the semantics can't drift between call sites."""
        out: Dict[str, Group] = {}
        seen: set = set()
        for job in jobs:
            guuid = getattr(job, "group", None)
            if not guuid or guuid in seen:
                continue
            seen.add(guuid)
            with self._lock:
                g = self._groups.get(guuid)
                # gang test under the lock so ordinary placement groups
                # never pay the member-list clone
                if g is not None and getattr(g, "gang", False):
                    out[guuid] = fast_clone(g)
        return out

    def jobs_where(self, pred: Callable[[Job], bool],
                   clone: bool = True) -> List[Job]:
        """``clone=False`` returns the LIVE entities (collected under
        the lock, list itself fresh): read-only by contract, for
        aggregate sweeps over tens of thousands of jobs where per-job
        fast_clone dominates the walk (the monitor's gauge sweep was
        ~450 ms of pure cloning at 20k pending jobs — long enough to
        convoy the serving plane it is supposed to protect).  Callers
        must not mutate, and must tolerate fields changing underneath
        them between reads (gauges do; decision paths must clone)."""
        with self._lock:
            if clone:
                return [fast_clone(j) for j in self._jobs.values()
                        if j.committed and pred(j)]
            return [j for j in self._jobs.values()
                    if j.committed and pred(j)]

    def pending_jobs(self, pool: Optional[str] = None,
                     clone: bool = True) -> List[Job]:
        """Committed waiting jobs (reference: queries.clj get-pending-job-ents)."""
        return self.jobs_where(
            lambda j: j.state is JobState.WAITING and (pool is None or j.pool == pool),
            clone=clone)

    def running_jobs(self, pool: Optional[str] = None) -> List[Job]:
        return self.jobs_where(
            lambda j: j.state is JobState.RUNNING and (pool is None or j.pool == pool))

    def running_instances(self, pool: Optional[str] = None,
                          clone: bool = True) -> List[Tuple[Job, Instance]]:
        """(job, instance) for live instances (reference: tools.clj
        get-running-task-ents — includes unknown + running).
        ``clone=False``: live read-only entities, same contract as
        :meth:`jobs_where`."""
        with self._lock:
            out = []
            for inst in self._instances.values():
                if inst.status not in (InstanceStatus.UNKNOWN, InstanceStatus.RUNNING):
                    continue
                job = self._jobs.get(inst.job_uuid)
                if job is None or (pool is not None and job.pool != pool):
                    continue
                out.append((fast_clone(job), fast_clone(inst)) if clone
                           else (job, inst))
            return out

    def user_summary(self) -> Dict[str, Dict[str, float]]:
        """Bounded per-user summary of this store's committed jobs —
        the ONLY payload partitions exchange for cross-partition
        invariants (per-user quotas, the monitor's global DRU view;
        state/partition.py UserSummaryExchange): pending/running counts
        and running resource sums, NEVER job state.  Computed under the
        lock without entity clones (one pass over the jobs table, a few
        floats per distinct user)."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for j in self._jobs.values():
                if not j.committed:
                    continue
                if j.state is JobState.WAITING:
                    key = "pending"
                elif j.state is JobState.RUNNING:
                    key = "running"
                else:
                    continue
                u = out.setdefault(j.user, {
                    "pending": 0.0, "running": 0.0,
                    "cpus": 0.0, "mem": 0.0, "gpus": 0.0})
                u[key] += 1
                if key == "running":
                    u["cpus"] += j.resources.cpus
                    u["mem"] += j.resources.mem
                    u["gpus"] += j.resources.gpus
        return out

    def user_usage(self, pool: Optional[str] = None) -> Dict[str, Dict[str, float]]:
        """Per-user aggregate usage of running jobs (reference: scheduler.clj
        user->usage)."""
        usage: Dict[str, Dict[str, float]] = {}
        for job, _inst in self.running_instances(pool):
            u = usage.setdefault(job.user, {"count": 0.0, "cpus": 0.0, "mem": 0.0, "gpus": 0.0})
            u["count"] += 1
            u["cpus"] += job.resources.cpus
            u["mem"] += job.resources.mem
            u["gpus"] += job.resources.gpus
        return usage

    # ----------------------------------------------------- pools/shares/quota
    def put_pool(self, pool: Pool) -> None:
        self.transact(lambda txn: txn.put("pools", pool.name, pool))

    def pools(self) -> List[Pool]:
        with self._lock:
            return [fast_clone(p) for p in self._pools.values()]

    def pool(self, name: str) -> Optional[Pool]:
        with self._lock:
            p = self._pools.get(name)
            return fast_clone(p) if p is not None else None

    def set_share(self, user: str, pool: str, resources: Dict[str, float],
                  reason: str = "") -> None:
        entry = ShareEntry(user, pool, dict(resources), reason)
        self.transact(lambda txn: txn.put("shares", f"{user}/{pool}", entry))

    def get_share(self, user: str, pool: str) -> Dict[str, float]:
        """Share with 'default'-user then MAX_VALUE fallback per resource
        (reference: share.clj get-share :105)."""
        with self._lock:
            entry = self._shares.get(f"{user}/{pool}")
            default = self._shares.get(f"default/{pool}")
        out: Dict[str, float] = {}
        for dim in ("cpus", "mem", "gpus"):
            if entry and dim in entry.resources:
                out[dim] = entry.resources[dim]
            elif default and dim in default.resources:
                out[dim] = default.resources[dim]
            else:
                out[dim] = float("inf")  # stands in for Double/MAX_VALUE
        return out

    def retract_share(self, user: str, pool: str) -> None:
        self.transact(lambda txn: txn.delete("shares", f"{user}/{pool}"))

    def set_quota(self, user: str, pool: str, resources: Dict[str, float],
                  count: float = float("inf"), reason: str = "") -> None:
        entry = QuotaEntry(user, pool, dict(resources), count, reason)
        self.transact(lambda txn: txn.put("quotas", f"{user}/{pool}", entry))

    def get_quota(self, user: str, pool: str) -> Dict[str, float]:
        """Quota map incl. :count, default-user fallback, infinite default
        (reference: quota.clj get-quota :82)."""
        with self._lock:
            entry = self._quotas.get(f"{user}/{pool}")
            default = self._quotas.get(f"default/{pool}")
        out: Dict[str, float] = {}
        for dim in ("cpus", "mem", "gpus"):
            if entry and dim in entry.resources:
                out[dim] = entry.resources[dim]
            elif default and dim in default.resources:
                out[dim] = default.resources[dim]
            else:
                out[dim] = float("inf")
        if entry is not None:
            out["count"] = entry.count
        elif default is not None:
            out["count"] = default.count
        else:
            out["count"] = float("inf")
        return out

    def retract_quota(self, user: str, pool: str) -> None:
        self.transact(lambda txn: txn.delete("quotas", f"{user}/{pool}"))

    def shares(self) -> List[ShareEntry]:
        with self._lock:
            return list(self._shares.values())

    def quotas(self) -> List[QuotaEntry]:
        with self._lock:
            return list(self._quotas.values())

    # ------------------------------------------------------ snapshot/restore
    def snapshot(self) -> str:
        """Serialize full state to JSON (leader handoff / checkpoint)."""
        with self._lock:
            state = {
                "tx_id": self._tx_id,
                "jobs": {k: to_json(v) for k, v in self._jobs.items()},
                "instances": {k: to_json(v) for k, v in self._instances.items()},
                "groups": {k: to_json(v) for k, v in self._groups.items()},
                "pools": {k: to_json(v) for k, v in self._pools.items()},
                "shares": {k: to_json(v) for k, v in self._shares.items()},
                "quotas": {k: to_json(v) for k, v in self._quotas.items()},
                "configs": {k: to_json(v) for k, v in self._configs.items()},
                "intents": {k: dict(v) for k, v in self._intents.items()},
                "latches": dict(self._latches),
            }
        return json.dumps(state)

    @classmethod
    def restore(cls, blob: str, partition: Optional[int] = None) -> "Store":
        state = json.loads(blob)
        store = cls(partition=partition)
        store._tx_id = state["tx_id"]
        for table in ("jobs", "instances", "groups", "pools", "shares",
                      "quotas", "configs", "intents"):
            target = getattr(store, "_" + table)
            for k, v in state.get(table, {}).items():
                target[k] = _entity_from_json(table, v)
        store._latches = {k: list(v) for k, v in state.get("latches", {}).items()}
        return store

    # ------------------------------------------------------- epoch fencing
    def _check_fence(self) -> None:
        """Refuse the append when another leader has claimed a higher epoch
        (caller holds the store lock).  One os.stat per append; the epoch
        file is only re-read when its (mtime_ns, ino) changed."""
        try:
            st = os.stat(self._epoch_path)
            sig = (st.st_mtime_ns, st.st_ino)
        except FileNotFoundError:
            return  # nobody has fenced (or fence file removed): allow
        if sig == self._epoch_stat:
            return
        self._epoch_stat = sig
        current = self._read_epoch_file()
        if current is not None and current > self._journal_epoch:
            # deposed: poison so no later append can slip through either
            f, self._journal_file = self._journal_file, None
            self._journal_poisoned = True
            try:
                if f is not None:
                    f.close()
            except Exception:
                pass
            raise StaleEpochError(
                f"journal fenced at epoch {current}; this leader holds "
                f"epoch {self._journal_epoch}")

    def _read_epoch_file(self) -> Optional[int]:
        try:
            with open(self._epoch_path, encoding="utf-8") as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return None

    def _claim_epoch(self, directory: str, epoch) -> int:
        """Claim leadership of the journal dir at ``epoch`` ("auto" = one
        above the current fence).  Raises StaleEpochError when a higher
        epoch is already fenced."""
        self._epoch_path = os.path.join(directory, "epoch")
        current = self._read_epoch_file() or 0
        if epoch == "auto":
            epoch = current + 1
        epoch = int(epoch)
        if current > epoch:
            raise StaleEpochError(
                f"journal dir fenced at epoch {current} > claimed {epoch}")
        if epoch > current:
            from ..utils.fsatomic import write_atomic_int
            write_atomic_int(self._epoch_path, epoch)
        st = os.stat(self._epoch_path)
        self._epoch_stat = (st.st_mtime_ns, st.st_ino)
        self._journal_epoch = epoch
        return epoch

    def attach_fence_authority(self, path: str) -> None:
        """Point the append-time fence check at a SHARED epoch authority
        (the election dir's minted counter) instead of the node-local
        ``<dir>/epoch`` claim file.  In the socket-replication topology
        the journal directory is node-local, so nothing ever bumps the
        local epoch file — without this, a deposed-but-alive leader's
        appends and checkpoints would pass the fence forever and only
        replay-time epoch skipping on the promoted mirror would protect
        the cluster.  With it, the first append after a successor mints
        a higher epoch raises :class:`StaleEpochError` and poisons the
        journal (same contract as the shared-dir topology)."""
        with self._lock:
            self._epoch_path = path
            self._epoch_stat = None  # force a re-read on the next append

    # ------------------------------------------------------- durable journal
    def attach_journal(self, path: str, fsync: bool = False) -> None:
        """Start appending every committed transaction to ``path`` as one
        JSON line. With ``fsync``, each record is fsynced (durable against
        power loss, not just process crash)."""
        with self._lock:
            self._journal_path = path
            self._journal_fsync = fsync
            self._journal_file = open(path, "a", encoding="utf-8")
            try:
                self._commit_offset = max(self._commit_offset,
                                          os.path.getsize(path))
            except OSError:
                pass

    def attach_replication(self, server, sync: bool = True,
                           timeout_s: float = 5.0,
                           min_followers: int = 0) -> None:
        """Stream this store's journal to followers via a running
        :class:`~cook_tpu.state.replication.ReplicationServer` over the
        native framed-TCP carrier.  With ``sync`` (the default), a
        transaction only reports determinate success after every synced
        follower fsynced its record; an unconfirmed ack raises
        :class:`ReplicationIndeterminate` (the record stays journaled
        and applied locally — the ambiguous-outcome contract).
        ``min_followers`` > 0 refuses commits BEFORE writing anything
        when fewer synced followers are connected
        (:class:`ReplicationTimeout`, a clean abort — CP mode; the
        default 0 keeps a lone leader available, like the reference's
        single transactor)."""
        with self._lock:
            self._repl_server = server
            self._repl_sync = sync
            self._repl_timeout_s = timeout_s
            self._repl_min_followers = min_followers

    @classmethod
    def open(cls, directory: str, fsync: bool = False,
             epoch=None, shared: bool = True,
             partition: Optional[int] = None) -> "Store":
        """Open a durable store rooted at ``directory`` (snapshot.json +
        journal.jsonl): load the snapshot if present, replay the journal,
        resume appending. The equivalent of a new leader re-reading Datomic
        (reference: mesos.clj:296-313 — replay nothing, just re-read).

        With ``epoch`` (an election epoch int, or "auto" for one above the
        current fence) the directory is treated as SHARED across leader
        hosts: the claim is written to ``<dir>/epoch`` before replay,
        stale-epoch records interleaved by a deposed leader are skipped
        during replay, and every future append re-checks the fence — a
        paused-then-woken old leader gets StaleEpochError instead of
        corrupting the successor's journal.

        ``shared=False`` marks a fenced journal whose DIRECTORY is
        node-local (the socket-replication topology, where epochs come
        from the shared election authority instead): failed appends may
        then safely truncate, since no other process appends to it.

        A journal with MID-FILE corruption (a failed CRC on a complete
        v2 frame, or garbage with valid records after it) raises
        :class:`~cook_tpu.state.integrity.JournalCorruptionError`
        instead of silently truncating the committed records beyond the
        damage; :func:`cook_tpu.state.repair.open_with_repair` wraps
        this with the pull-from-synced-peer path.  A torn TAIL is still
        excised exactly as before."""
        os.makedirs(directory, exist_ok=True)
        journal_path = os.path.join(directory, "journal.jsonl")
        removed = hygiene_sweep(directory)
        store, prev_records = cls._restore_base(directory, partition)
        store._hygiene_removed = removed
        store._journal_dir = directory
        if epoch is None:
            scan = _scan_journal(journal_path)
            if scan.corrupt:
                raise _corruption_error(journal_path, scan, "leader")
            store._replay_records(prev_records + scan.records)
            if scan.good < scan.size:
                with open(journal_path, "r+b") as f:
                    f.truncate(scan.good)
                store._bump_journal_gen()
            store.attach_journal(journal_path, fsync=fsync)
            return store
        # SHARED-dir takeover. Order matters:
        #   claim epoch -> repair torn tail -> append an epoch BARRIER ->
        #   replay to EOF.
        # The barrier (a no-op record at our epoch) makes any lower-epoch
        # record that lands after it positionally follow a higher-ep
        # record, so every future replay skips it; records that raced in
        # BEFORE the barrier are replayed by us and by every successor
        # alike, so all leaders agree on the committed prefix.
        store._journal_shared = shared
        store._claim_epoch(directory, epoch)
        scan = _scan_journal(journal_path)
        if scan.corrupt:
            raise _corruption_error(journal_path, scan, "leader")
        if scan.good < scan.size:
            # a torn fragment would merge with the barrier line and stop
            # every future replay there — excise it first
            with open(journal_path, "r+b") as f:
                f.truncate(scan.good)
            store._bump_journal_gen()
        store.attach_journal(journal_path, fsync=fsync)
        store._journal_file.write(seal_record(
            {"ep": store._journal_epoch, "barrier": True}))
        store._journal_file.flush()
        if fsync:
            os.fsync(store._journal_file.fileno())
        store._commit_offset = store._journal_file.tell()
        records, _good, _size = _scan_journal(journal_path)
        store._replay_records(prev_records + records)
        return store

    @classmethod
    def _restore_base(cls, directory: str, partition: Optional[int]
                      ) -> Tuple["Store", List[Dict[str, Any]]]:
        """Load the checkpoint snapshot, verified against its manifest
        (state/integrity.py).  Returns ``(store, prev_records)``:
        normally the restored snapshot and no extra records; on a
        manifest mismatch, the PREVIOUS checkpoint generation
        (``snapshot.prev.json`` + the journal rotated at the last
        checkpoint, ``journal.prev.jsonl``) — that chain replays to at
        least the damaged snapshot's state, re-applying any already-
        absorbed records idempotently.  A directory with no manifest
        (legacy, or a replication mirror — manifests are node-local)
        loads unverified exactly as before.  Raises
        :class:`JournalCorruptionError` when no generation verifies."""
        snap_path = os.path.join(directory, "snapshot.json")
        verdict = verify_snapshot(snap_path)
        if verdict is not False:
            if os.path.exists(snap_path):
                with open(snap_path, encoding="utf-8") as f:
                    return cls.restore(f.read(), partition=partition), []
            return cls(partition=partition), []
        _metrics.counter_inc("cook_journal_corruption",
                             labels={"source": "snapshot"})
        prev = os.path.join(directory, "snapshot.prev.json")
        if os.path.exists(prev) and verify_snapshot(prev) is not False:
            with open(prev, encoding="utf-8") as f:
                store = cls.restore(f.read(), partition=partition)
            pscan = scan_journal(
                os.path.join(directory, "journal.prev.jsonl"))
            if pscan.corrupt:
                raise _corruption_error(
                    os.path.join(directory, "journal.prev.jsonl"),
                    pscan, "leader")
            return store, pscan.records
        raise JournalCorruptionError(
            snap_path, 0, "checkpoint manifest mismatch and no usable "
            "previous checkpoint — repair from a synced peer "
            "(docs/DEPLOY.md corrupted-journal runbook)")

    def _replay_records(self, records: List[Dict[str, Any]],
                        max_ep: int = 0) -> int:
        """Apply scanned journal records with epoch-fence skipping: a
        record with a lower epoch than one already seen was appended by a
        deposed leader after its successor fenced — never committed from
        the cluster's point of view.  ``max_ep`` seeds (and the return
        value carries) the epoch high-water mark so an INCREMENTAL
        replayer — the follower read view's apply loop
        (state/read_replica.py) — shares this exact skip rule across
        calls instead of re-implementing it."""
        for rec in records:
            ep = rec.get("ep")
            if ep is not None and ep < max_ep:
                continue
            if ep is not None:
                max_ep = ep
            if not rec.get("barrier"):
                self._apply_journal_record(rec)
        return max_ep

    @classmethod
    def replay_only(cls, directory: str,
                    partition: Optional[int] = None) -> "Store":
        """Load snapshot + journal WITHOUT attaching the journal: the
        follower/read-replica view of a SHARED data dir.  A follower must
        never append (its writes would interleave with the leader's), so
        transactions on this store stay in memory only — leader-only
        writes are 307-redirected at the REST layer anyway.

        Raises :class:`JournalCorruptionError` on mid-file damage — a
        follower must refuse to serve (or promote) poisoned state, not
        silently drop the records beyond the corruption."""
        journal_path = os.path.join(directory, "journal.jsonl")
        store, prev_records = cls._restore_base(directory, partition)
        scan = _scan_journal(journal_path)
        if scan.corrupt:
            raise _corruption_error(journal_path, scan, "mirror")
        store._replay_records(prev_records + scan.records)
        return store

    def _apply_journal_record(self, rec: Dict[str, Any]) -> None:
        for tk, v in rec.get("w", {}).items():
            table, key = tk.split("/", 1)
            getattr(self, "_" + table)[key] = _entity_from_json(table, v)
        for tk in rec.get("d", []):
            table, key = tk.split("/", 1)
            getattr(self, "_" + table).pop(key, None)
        for latch, uuids in rec.get("lr", []):
            self._latches.setdefault(latch, []).extend(uuids)
        for latch in rec.get("lp", []):
            self._latches.pop(latch, None)
        if rec.get("a"):
            # per-job audit docs (utils/audit.py): a promoted leader's
            # replay rebuilds pre-failover timelines from these
            self.audit.load(rec["a"])
        self._tx_id = rec.get("tx", self._tx_id)

    def checkpoint(self) -> None:
        """Compact the journal: atomically write a fresh snapshot, then
        truncate the journal. Safe at any point — the snapshot covers every
        journaled transaction."""
        if self._journal_dir is None or self._journal_file is None:
            raise ValueError(
                "checkpoint() requires an open store from Store.open")
        with self._lock:
            if self._journal_epoch is not None:
                # a deposed leader's graceful shutdown must not overwrite
                # the shared snapshot with stale state / truncate the
                # successor's journal
                self._check_fence()
            snap_path = os.path.join(self._journal_dir, "snapshot.json")
            # keep the PREVIOUS checkpoint generation reachable
            # (snapshot.prev.json + the journal rotated below): a later
            # manifest mismatch on the new snapshot falls back to that
            # chain (_restore_base), which replays to the same state.
            # Hard links BEFORE the replace keep every crash window
            # recoverable — the live snapshot.json is never unlinked.
            self._rotate_prev(snap_path)
            # writer-unique temp + directory fsync (utils/fsatomic.py):
            # a shared ".tmp" name let a deposed leader's last-gasp
            # checkpoint race the successor's on the same temp file
            from ..utils.fsatomic import write_atomic_text
            snap_text = self.snapshot()
            write_atomic_text(snap_path, snap_text)
            # manifest AFTER snapshot: a crash between the two leaves a
            # manifest describing the old content → verification fails →
            # fallback to the prev chain, which is correct (idempotent
            # re-replay), never silently wrong
            write_manifest(snap_path, snap_text)
            self._journal_file.close()
            try:
                # rotate instead of truncating: journal.prev.jsonl is the
                # fallback chain's second half (and the quarantine target
                # when a scrub-detected corruption forced this checkpoint)
                os.replace(self._journal_path,
                           os.path.join(self._journal_dir,
                                        "journal.prev.jsonl"))
            except OSError:
                pass  # fresh dir, or exotic fs: "w" below truncates
            self._journal_file = open(self._journal_path, "w",
                                      encoding="utf-8")
            # the commit position re-bases with the compacted journal
            # (followers full-resync on the new mirror token; a stale
            # read-your-writes token just redirects to the leader)
            self._commit_offset = 0
            self._scrub_offset = 0
            if self.audit.enabled and self.audit.journal:
                # the snapshot carries no audit lane — re-seed the
                # compacted journal with the (bounded) current trail so
                # timeline continuity survives compaction too.  Pending
                # durable events are marked flushed FIRST: the re-seed
                # already carries them, and leaving them pending would
                # journal them a second time at the next flush_audit
                # (duplicated on every later replay)
                self.audit.discard_pending()
                docs = self.audit.export_wire()
                if docs:
                    # same torn-write excision/poison + fsync discipline
                    # as every other audit append: a bare write here
                    # could leave a torn fragment at the fresh journal's
                    # head that swallows the next committed txn record
                    self._write_audit_record_locked(docs)

    def _rotate_prev(self, snap_path: str) -> None:
        """Preserve the current snapshot (+ its manifest) under the
        ``.prev`` names via hard links, so the atomic replace that
        follows never orphans the only verified generation.  Best
        effort: a filesystem without links just shortens the fallback
        chain, it never breaks the primary path."""
        from .integrity import manifest_path
        prev = os.path.join(self._journal_dir, "snapshot.prev.json")
        for src, dst in ((snap_path, prev),
                         (manifest_path(snap_path), manifest_path(prev))):
            if not os.path.exists(src):
                continue
            try:
                tmp = dst + ".lnk"
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                os.link(src, tmp)
                os.replace(tmp, dst)
            except OSError:
                pass

    # ------------------------------------------------------ integrity scrub
    def scrub(self, max_bytes: int = 1 << 20,
              repair: bool = True) -> Dict[str, Any]:
        """One background-scrub step (sched/monitor.py's storage sweep
        drives this): verify the next ``max_bytes`` of journal frames
        beyond the last verified offset (CRC + length framing,
        state/integrity.py) WITHOUT the store lock — the window scan
        reads the path independently and only advances past complete
        valid lines, so a live appender's in-flight tail just waits for
        the next pass.

        On corruption the leader SELF-HEALS when ``repair`` is set: the
        in-memory state is authoritative (every committed record was
        applied before its bytes could rot on disk), so a checkpoint()
        rewrites a fresh verified snapshot and rotates the damaged
        journal aside as ``journal.prev.jsonl`` (kept for forensics;
        docs/DEPLOY.md runbook).  Mirrors repair from peers instead —
        their memory is not authoritative (state/repair.py)."""
        path = self._journal_path
        if not path or self._journal_file is None:
            return {"enabled": False}
        try:
            if os.path.getsize(path) < self._scrub_offset:
                self._scrub_offset = 0  # checkpoint rotated the journal
        except OSError:
            return {"enabled": False}
        max_bytes = int(max_bytes)
        res = verify_window(path, self._scrub_offset, max_bytes)
        while (not res.corrupt and res.good == self._scrub_offset
               and res.size - self._scrub_offset > max_bytes):
            # one frame is larger than the window: a fixed-size pass
            # would sit on it forever.  Grow until the frame fits (an
            # incomplete TAIL frame is excluded by the size check — the
            # live appender finishes that one).
            max_bytes *= 2
            res = verify_window(path, self._scrub_offset, max_bytes)
        self._scrub_last_ts = time.time()
        if not res.corrupt:
            self._scrub_offset = res.good
            return {"enabled": True, "corrupt": False,
                    "verified_offset": self._scrub_offset,
                    "journal_bytes": res.size}
        self._scrub_corruptions += 1
        _metrics.counter_inc("cook_journal_corruption",
                             labels={"source": "scrub"})
        doc: Dict[str, Any] = {
            "enabled": True, "corrupt": True,
            "corrupt_offset": res.corrupt_offset, "reason": res.reason,
            "verified_offset": self._scrub_offset,
            "journal_bytes": res.size, "repaired": False}
        if repair and not self._journal_poisoned:
            try:
                self.checkpoint()
                self._scrub_repairs += 1
                _metrics.counter_inc("cook_storage_repair",
                                     labels={"kind": "checkpoint"})
                doc["repaired"] = True
            except Exception as e:
                # fenced/deposed or the rewrite itself failed: leave the
                # damage reported, never half-heal
                doc["repair_error"] = str(e)
        return doc

    def storage_stats(self) -> Dict[str, Any]:
        """The ``GET /debug/storage`` document for this store (one per
        partition in the partitioned plane): scrub frontier, corruption
        and repair counters, checkpoint manifest verdict."""
        doc: Dict[str, Any] = {
            "journal_bytes": self._commit_offset,
            "journal_poisoned": self._journal_poisoned,
            "scrub_verified_offset": self._scrub_offset,
            "scrub_corruptions": self._scrub_corruptions,
            "scrub_repairs": self._scrub_repairs,
            "scrub_age_s": (round(time.time() - self._scrub_last_ts, 1)
                            if self._scrub_last_ts else None),
            "hygiene_removed": self._hygiene_removed,
            "enospc_aborts": self._enospc_aborts,
        }
        if self.partition is not None:
            doc["partition"] = f"p{self.partition}"
        if self._journal_dir:
            snap = os.path.join(self._journal_dir, "snapshot.json")
            verdict = verify_snapshot(snap)
            if verdict is None:
                doc["manifest"] = ("missing" if os.path.exists(snap)
                                   else "no-checkpoint")
            else:
                doc["manifest"] = "ok" if verdict else "mismatch"
        return doc

    def close(self) -> None:
        self.disable_group_commit()  # drain waiters before the fd goes
        with self._lock:
            if self._journal_file is not None:
                self._journal_file.close()
                self._journal_file = None


def _corruption_error(path: str, scan: ScanResult,
                      source: str) -> JournalCorruptionError:
    """Count + build the refuse-and-repair verdict for a corrupt scan
    (``source`` labels who found it: leader replay, mirror replay, or
    the background scrub)."""
    _metrics.counter_inc("cook_journal_corruption",
                         labels={"source": source})
    return JournalCorruptionError(
        path, scan.corrupt_offset or 0, scan.reason)


def _scan_journal(path: str) -> ScanResult:
    """Parse a journal file into records — the store-local name every
    consumer imports; the framing/CRC logic lives in
    :func:`cook_tpu.state.integrity.scan_journal` (v1 + v2 records, the
    torn-tail vs mid-file-corruption verdict).  The result still
    unpacks as the legacy ``(records, good, size)`` triple."""
    return scan_journal(path)


def _entity_from_json(table: str, v: Dict[str, Any]) -> Any:
    """Inverse of ``to_json`` per entity table (shared by snapshot restore
    and journal replay)."""
    if table == "jobs":
        return _job_from_json(v)
    v = dict(v)
    if table == "instances":
        v["status"] = InstanceStatus(v["status"])
        return Instance(**v)
    if table == "groups":
        v["placement_type"] = GroupPlacementType(v["placement_type"])
        return Group(**v)
    if table == "pools":
        v["dru_mode"] = DruMode(v["dru_mode"])
        v["scheduler"] = SchedulerKind(v["scheduler"])
        return Pool(**v)
    if table == "shares":
        return ShareEntry(**v)
    if table == "quotas":
        v["count"] = float(v["count"]) if v["count"] is not None else float("inf")
        return QuotaEntry(**v)
    if table in ("configs", "intents"):
        return v  # plain dicts: dynamic config documents / launch intents
    raise ValueError(f"unknown entity table {table}")


def _job_from_json(v: Dict[str, Any]) -> Job:
    v = dict(v)
    v["state"] = JobState(v["state"])
    v["resources"] = Resources(**v["resources"])
    v["constraints"] = [Constraint(**c) for c in v.get("constraints") or []]
    if v.get("application"):
        v["application"] = Application(**v["application"])
    if v.get("checkpoint"):
        c = dict(v["checkpoint"])
        c["mode"] = CheckpointMode(c["mode"])
        v["checkpoint"] = Checkpoint(**c)
    v["mea_culpa_failures"] = {int(k): int(n) for k, n in (v.get("mea_culpa_failures") or {}).items()}
    return Job(**v)
