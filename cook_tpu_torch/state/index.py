"""The port's copy of ``cook_tpu/state/index.py`` (imports re-rooted).

Columnar rank-path index: the store's query/cache layer, TPU-first.

The reference keeps Guava caches of entity attributes so the rank cycle
doesn't re-read Datomic per job (reference: caches.clj, cached_queries.clj,
tools.clj:876-973).  Here the same role is filled by an incrementally
maintained *columnar* projection — numpy columns of exactly the fields the
DRU rank kernel packs — so a cycle at the 1M-task design point never
materializes Python entities at all: membership is
updated O(delta) off the store's tx-event feed, and building the kernel
inputs is pure vectorized numpy over the live rows.

Layout
------
jobs table (append-only static columns + a mutable pending flag):
  res f32[N,4] (cpus, mem, gpus, 1.0) | prio i32 | submit i64 |
  uuid U36 | user U64 | pool U32 | pending bool
live-instances table (swap-remove):
  job_row i64 | start i64 | task_id -> slot map

``rank_arrays(pool)`` produces the unpadded RankInputs columns in exactly
the order the entity path (sched/ranker.build_user_tasks +
ops/host_prep.pack_rank_inputs) produces them: users sorted by name, tasks
within a user by the feature key (-priority, start, submit, uuid)
(reference: tools.clj task->feature-vector :614-632, dru.clj:123).
"""

from __future__ import annotations

import itertools
import re
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..utils.locks import named_lock
from .schema import (
    DISK_TYPE_LABEL,
    GPU_MODEL_LABEL,
    InstanceStatus,
    JobState,
)

F32 = np.float32
# pending tasks sort after every running task (reference: pending tasks get
# Long/MAX_VALUE start in the feature vector)
PENDING_START = np.int64(2**62)

_LIVE = (InstanceStatus.UNKNOWN, InstanceStatus.RUNNING)

# composite sort key for the per-pool incremental order cache, packed as
# fixed-width big-endian byte strings so every comparison is one memcmp
# (numpy structured-dtype comparisons cost 3-4x more in the searchsorted
# merge).  Field order IS the comparison order and must equal the lexsort
# key order below: (uid, -prio, start, submit, uuid-hi, uuid-lo), each
# field sign-biased into unsigned big-endian bytes so byte order equals
# numeric order.  At fixed width the S-dtype's trailing-NUL-stripping
# compare is exactly memcmp: two keys differing only in trailing zeros
# cannot exist (both are the full 40 bytes), and at the first differing
# byte both stripped forms still disagree there.
_KEY_NBYTES = 40
_KEY_DT = np.dtype(f"S{_KEY_NBYTES}")

# canonical lowercase uuid: ONLY this form sorts identically as a string
# and as a 128-bit integer (int(h, 16) would also accept uppercase/'0x'/
# signed forms whose string order differs — those force the string sort)
_CANON_UUID = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")


class FusedSnapshot(NamedTuple):
    """One pool's fused-cycle pack snapshot, taken under a single index
    lock hold (every field is mutually consistent).  Base arrays are
    views of the live buffers: row values never mutate, and growth/
    compaction REPLACE buffers rather than moving rows in place, so the
    views stay valid; ``compactions`` keys device-side mirrors of the
    res/disk base columns (unchanged counter = row indices stable)."""

    arrays: Dict[str, np.ndarray]   # pending/valid/is_first (+ first_idx/
    #                                 user_rank/usage unless compact)
    rows_s: np.ndarray              # i64[T] sorted absolute base rows
    uuid_base: np.ndarray           # U36[n] by row
    user_base: np.ndarray           # U64[n] by row
    res_base: np.ndarray            # f32[n, 4] (cpus, mem, gpus, 1) by row
    disk_base: np.ndarray           # f32[n] by row
    users: List[str]                # distinct users in segment order
    job_res: Optional[np.ndarray]   # f32[T, 4] demand; None when compact
    complex_s: np.ndarray           # bool[T] entity-constraint rows
    owner_rows: Dict[str, int]      # reservation owner uuid -> base row
    compactions: int                # index compaction epoch at snapshot


class PackDelta(NamedTuple):
    """One consumer's drained per-pool delta batch (see
    :meth:`ColumnarIndex.pack_delta`): the tx-event feed compacted into
    the row set a device-resident pack consumer must reconcile, plus an
    explicit compaction-epoch fence.  ``rows``/``tombstones`` are base
    row ids valid ONLY within ``epoch``; a ``fence`` means row ids were
    remapped (compaction), the user-id space shifted, or sorted mode
    flipped — the consumer must full-repack, never scatter."""

    epoch: int              # index compaction epoch the row ids live in
    fence: bool             # True -> full repack required
    rows: np.ndarray        # i64[k] rows touched since the last drain
    tombstones: np.ndarray  # i64[m] rows that LEFT the pack (pending off
    #                         or live instance removed); subset semantics:
    #                         also present in ``rows``
    version: int            # the pool's pack version at drain time


def _is_complex(job) -> bool:
    """True when the job needs entity-level treatment in the fused cycle's
    constraint build: user constraints, group placement, checkpoint
    locality, estimated-completion, novel-host (any prior instance), or the
    gpu-model / disk-type affinity labels (state/schema.py
    GPU_MODEL_LABEL / DISK_TYPE_LABEL).  Plain jobs — the vast majority at
    the 1M design point — get a fully vectorized mask instead."""
    return bool(job.constraints or job.group is not None
                or job.checkpoint is not None
                or job.expected_runtime_ms
                or job.instances
                or GPU_MODEL_LABEL in job.labels
                or DISK_TYPE_LABEL in job.labels)


def _grow(arr: np.ndarray, n: int) -> np.ndarray:
    if n <= len(arr):
        return arr
    new = np.zeros((max(n, 2 * len(arr), 1024),) + arr.shape[1:],
                   dtype=arr.dtype)
    new[:len(arr)] = arr
    return new


def _fit_str(arr: np.ndarray, value: str) -> np.ndarray:
    """Widen a fixed-width string column when a value wouldn't fit —
    numpy silently truncates on assignment, and a truncated pool/user name
    would make its rows invisible to equality scans."""
    if len(value) <= arr.dtype.itemsize // 4:  # U-dtype: 4 bytes per char
        return arr
    return arr.astype(f"<U{max(len(value), 2 * (arr.dtype.itemsize // 4))}")


class ColumnarIndex:
    """Attach with ``ColumnarIndex(store)``; reads ``store`` internals once
    under its lock for the initial scan, then stays fresh off the tx feed."""

    def __init__(self, store):
        self.store = store
        # named for the lock-order sanitizer (utils/locks.py contract)
        self._lock = named_lock("index")
        self._n = 0
        # bumped ONLY by _maybe_compact (row remap); consumers holding a
        # (compactions, rows_s) snapshot know base rows < their snapshot's
        # n are content-stable while the counter is unchanged
        self.compactions = 0
        self._row: Dict[str, int] = {}
        self._res = np.zeros((1024, 4), dtype=F32)
        self._disk = np.zeros(1024, dtype=F32)
        self._complex = np.zeros(1024, dtype=bool)
        self._prio = np.zeros(1024, dtype=np.int32)
        # integer sort keys: string lexsort over (uuid, user) costs ~2.3x
        # the all-int sort at 100k+ rows.  _uid is an order-preserving user
        # id (rank of the user name among all known users; new names shift
        # later ids — rare, one vectorized pass); _uhi/_ulo are the uuid's
        # two 64-bit halves (canonical hex uuids sort identically as
        # strings and as 128-bit ints).  _sortable goes False if any uuid
        # is non-canonical, falling back to the string sort.
        self._uid = np.zeros(1024, dtype=np.int32)
        self._uhi = np.zeros(1024, dtype=np.uint64)
        self._ulo = np.zeros(1024, dtype=np.uint64)
        self._user_names: List[str] = []  # sorted; position = user id
        self._sortable = True
        self._submit = np.zeros(1024, dtype=np.int64)
        self._uuid = np.zeros(1024, dtype="<U36")
        self._user = np.zeros(1024, dtype="<U64")
        self._pool = np.zeros(1024, dtype="<U32")
        self._pending = np.zeros(1024, dtype=bool)
        self._done = np.zeros(1024, dtype=bool)  # job reached COMPLETED
        self._dead = 0  # count of done rows (compaction trigger)
        # live instances (swap-remove keeps the arrays dense)
        self._inst_slot: Dict[str, int] = {}
        self._inst_task: List[str] = []
        self._inst_job_row = np.zeros(1024, dtype=np.int64)
        self._inst_start = np.zeros(1024, dtype=np.int64)
        self._ninst = 0
        # per-pool incremental sorted order: pool -> {"kb": sorted _KEY_DT
        # byte-key array, "st": i64 start per entry, "uid": i32 user id
        # per entry, "rows": row index per entry, "log": ordered
        # (+1/-1, row, start) delta journal}.  The full lexsort is ~40 ms
        # at the 100k design point and re-ran every cycle; scheduling churn
        # only touches O(launched) rows, so the order is repaired by
        # searchsorted merge instead.
        self._ord: Dict[str, Dict] = {}
        # ---- delta feed (device-resident pack consumers) ----
        # consumer id -> {"pools": {pool: {"rows": set, "tombs": set}},
        #                 "fence_seen": {pool: fence_version}}
        self._consumers: Dict[int, Dict] = {}
        self._consumer_ids = itertools.count(1)
        # bumped on EVERY event that touches a pool's pack (membership,
        # pending flips, instance churn); cheap equality token for "has
        # anything about this pool changed since my last pack"
        self._pool_version: Dict[str, int] = {}
        # bumped on global order invalidations: compaction (row remap),
        # user-id shift (cached keys embed ids), sorted-mode flip
        self._fence_version = 0
        self._attach()

    # ------------------------------------------------------------ lifecycle
    def _attach(self) -> None:
        with self.store._lock:
            # the index lock is uncontended at construction, but the
            # row-sync helpers run lock-held BY CONTRACT (`caller holds
            # self._lock`) — hold it so the contract is call-site-true
            # here too, not just on the tx-feed path (store -> index is
            # the declared rank order, utils/locks.py)
            with self._lock:
                self._bulk_attach_jobs(list(self.store._jobs.values()))
                for inst in self.store._instances.values():
                    if inst.status in _LIVE:
                        self._add_instance_raw(inst)
            self.store.subscribe(self._on_events)

    def _bulk_attach_jobs(self, jobs) -> None:
        """Vectorized initial scan: one array build per COLUMN instead of
        one `_sync_job_raw` call per row (the per-row path stays for the
        incremental tx feed, where it is the right shape).  At the 1M-job
        design point (BASELINE config 5) this is the difference between
        ~18 s and a few seconds of index attach.  Caller holds
        self._lock (the attach path takes it; the helpers this calls
        are lock-held by the same contract)."""
        if not jobs or self._n:
            for job in jobs:  # non-empty index: incremental semantics
                self._sync_job_raw(job)
            return
        n = len(jobs)
        # 25% headroom: sizing to exactly n would guarantee a full
        # 13-column reallocation (hundreds of MB at 1M rows) on the very
        # first job submitted after attach
        cap = max(1024, n + n // 4)
        self._row = {j.uuid: i for i, j in enumerate(jobs)}
        self._n = n
        res = np.zeros((cap, 4), dtype=F32)
        res[:n, 0] = [j.resources.cpus for j in jobs]
        res[:n, 1] = [j.resources.mem for j in jobs]
        res[:n, 2] = [j.resources.gpus for j in jobs]
        res[:n, 3] = 1.0
        self._res = res
        self._disk = np.zeros(cap, dtype=F32)
        self._disk[:n] = [j.resources.disk for j in jobs]
        self._prio = np.zeros(cap, dtype=np.int32)
        self._prio[:n] = [j.priority for j in jobs]
        self._submit = np.zeros(cap, dtype=np.int64)
        self._submit[:n] = [j.submit_time_ms for j in jobs]
        uuids = [j.uuid for j in jobs]
        self._uuid = np.zeros(cap, dtype="<U36")
        self._uuid[:n] = uuids
        users = [j.user for j in jobs]
        # dtype fitted up front (the per-row path uses _fit_str): a name
        # longer than the column width would silently truncate
        ulen = max(64, max((len(u) for u in users), default=1))
        self._user = np.zeros(cap, dtype=f"<U{ulen}")
        self._user[:n] = users
        pools = [j.pool for j in jobs]
        plen = max(32, max((len(p) for p in pools), default=1))
        self._pool = np.zeros(cap, dtype=f"<U{plen}")
        self._pool[:n] = pools
        self._pending = np.zeros(cap, dtype=bool)
        self._pending[:n] = [j.committed and j.state is JobState.WAITING
                             for j in jobs]
        self._done = np.zeros(cap, dtype=bool)
        self._done[:n] = [j.state is JobState.COMPLETED for j in jobs]
        self._dead = int(self._done[:n].sum())
        self._complex = np.zeros(cap, dtype=bool)
        self._complex[:n] = [_is_complex(j) for j in jobs]
        # order-preserving user ids in ONE pass (vs per-row bisect+shift)
        self._user_names = sorted(set(users))
        name_pos = {u: i for i, u in enumerate(self._user_names)}
        self._uid = np.zeros(cap, dtype=np.int32)
        self._uid[:n] = [name_pos[u] for u in users]
        # canonical-uuid sort keys, per row exactly as _sync_job_raw: a
        # canonical row gets its key even when a non-canonical neighbor
        # disables sorted mode (consumers gate on _sortable)
        self._uhi = np.zeros(cap, dtype=np.uint64)
        self._ulo = np.zeros(cap, dtype=np.uint64)
        hi, lo = self._uhi, self._ulo
        for i, u in enumerate(uuids):
            if _CANON_UUID.match(u):
                h = u.replace("-", "")
                hi[i] = int(h[:16], 16)
                lo[i] = int(h[16:], 16)
            else:
                self._sortable = False

    def _sync_job_raw(self, job) -> None:
        """Insert-or-update one job row (caller holds self._lock or is the
        single-threaded attach scan)."""
        row = self._row.get(job.uuid)
        if row is None:
            row = self._n
            self._n += 1
            self._res = _grow(self._res, self._n)
            self._disk = _grow(self._disk, self._n)
            self._complex = _grow(self._complex, self._n)
            self._prio = _grow(self._prio, self._n)
            self._submit = _grow(self._submit, self._n)
            self._uuid = _grow(self._uuid, self._n)
            self._user = _grow(self._user, self._n)
            self._pool = _grow(self._pool, self._n)
            self._pending = _grow(self._pending, self._n)
            self._done = _grow(self._done, self._n)
            self._uid = _grow(self._uid, self._n)
            self._uhi = _grow(self._uhi, self._n)
            self._ulo = _grow(self._ulo, self._n)
            self._row[job.uuid] = row
            r = job.resources
            self._res[row] = (r.cpus, r.mem, r.gpus, 1.0)
            self._disk[row] = r.disk
            self._prio[row] = job.priority
            self._uid[row] = self._user_id(job.user, new_row=row)
            if _CANON_UUID.match(job.uuid):
                h = job.uuid.replace("-", "")
                self._uhi[row] = np.uint64(int(h[:16], 16))
                self._ulo[row] = np.uint64(int(h[16:], 16))
            elif self._sortable:
                # sorted-mode flip: cached byte keys and resident row
                # orders are built on the int-key order — fence them
                self._sortable = False
                self._fence_all()
            self._submit[row] = job.submit_time_ms
            self._uuid[row] = job.uuid
            self._user = _fit_str(self._user, job.user)
            self._user[row] = job.user
            self._pool = _fit_str(self._pool, job.pool)
            self._pool[row] = job.pool
        was_pending = bool(self._pending[row])
        now_pending = job.committed and job.state is JobState.WAITING
        if now_pending != was_pending:
            pool = str(self._pool[row])
            e = self._ord.get(pool)
            if e is not None:
                e["log"].append((1 if now_pending else -1, int(row),
                                 int(PENDING_START)))
        self._pending[row] = now_pending
        self._complex[row] = _is_complex(job)
        done = job.state is JobState.COMPLETED
        if done != self._done[row]:
            self._dead += 1 if done else -1  # retry paths resurrect rows
            self._done[row] = done
        # delta feed: every synced row is a touch; leaving the pending
        # set is a tombstone (the resident pack row becomes a running or
        # dead row, never a stale pending scatter)
        self._touch_row(str(self._pool[row]), row,
                        tomb=was_pending and not now_pending)

    def _user_id(self, user: str, new_row: Optional[int] = None) -> int:
        """Order-preserving user id (caller holds self._lock).  A new name
        inserts into the sorted list and shifts every later id up — one
        vectorized pass, and only when a never-seen user first submits.
        ``new_row`` is the not-yet-assigned row this id is FOR: its slot
        still holds uid 0 and must not count as a shifted existing key
        (it would fence/clear on every first-in-sort-order user)."""
        import bisect
        pos = bisect.bisect_left(self._user_names, user)
        if pos < len(self._user_names) and self._user_names[pos] == user:
            return pos
        self._user_names.insert(pos, user)
        shift = self._uid[:self._n] >= pos
        if new_row is not None and new_row < self._n:
            shift[new_row] = False
        if shift.any():
            self._uid[:self._n][shift] += 1
            self._ord.clear()  # cached keys embed the shifted ids
            self._fence_all()  # so do resident consumers' sorted orders
        return pos

    def _add_instance_raw(self, inst) -> None:
        row = self._row.get(inst.job_uuid)
        if row is None or inst.task_id in self._inst_slot:
            return
        slot = self._ninst
        self._ninst += 1
        self._inst_job_row = _grow(self._inst_job_row, self._ninst)
        self._inst_start = _grow(self._inst_start, self._ninst)
        if slot < len(self._inst_task):
            self._inst_task[slot] = inst.task_id
        else:
            self._inst_task.append(inst.task_id)
        self._inst_job_row[slot] = row
        self._inst_start[slot] = inst.start_time_ms
        self._inst_slot[inst.task_id] = slot
        pool = str(self._pool[row])
        e = self._ord.get(pool)
        if e is not None:
            e["log"].append((1, int(row), int(inst.start_time_ms)))
        self._touch_row(pool, int(row))

    def _remove_instance_raw(self, task_id: str) -> None:
        slot = self._inst_slot.pop(task_id, None)
        if slot is None:
            return
        row = self._inst_job_row[slot]
        pool = str(self._pool[row])
        e = self._ord.get(pool)
        if e is not None:
            e["log"].append((-1, int(row), int(self._inst_start[slot])))
        self._touch_row(pool, int(row), tomb=True)
        last = self._ninst - 1
        if slot != last:
            self._inst_job_row[slot] = self._inst_job_row[last]
            self._inst_start[slot] = self._inst_start[last]
            moved = self._inst_task[last]
            self._inst_task[slot] = moved
            self._inst_slot[moved] = slot
        self._ninst = last

    # ------------------------------------------------------------ delta feed
    def attach_pack_consumer(self) -> int:
        """Register a device-resident pack consumer: from now on every tx
        event that touches a pool's pack is journaled for this consumer
        (row ids + tombstones + fences) until :meth:`pack_delta` drains
        it.  Consumers attach cold (their first pack is a full build), so
        the journal starts empty."""
        with self._lock:
            cid = next(self._consumer_ids)
            self._consumers[cid] = {"pools": {}, "fence_seen": {}}
            return cid

    def detach_pack_consumer(self, cid: int) -> None:
        with self._lock:
            self._consumers.pop(cid, None)

    def pack_delta(self, cid: int, pool: str) -> PackDelta:
        """Drain one pool's journaled delta batch for a consumer: the
        compact per-cycle change feed of the incremental-view-maintenance
        path (McSherry-style deltas, not rebuilds).  A ``fence``
        (compaction row remap, user-id shift, sorted-mode flip) means the
        consumer's resident row ids are invalid — full repack."""
        with self._lock:
            c = self._consumers.get(cid)
            if c is None:  # detached/unknown: behave as a permanent fence
                return PackDelta(self.compactions, True,
                                 np.zeros(0, dtype=np.int64),
                                 np.zeros(0, dtype=np.int64), -1)
            fence = self._fence_version > c["fence_seen"].get(pool, 0)
            c["fence_seen"][pool] = self._fence_version
            d = c["pools"].pop(pool, None)
            rows = np.fromiter(d["rows"], dtype=np.int64,
                               count=len(d["rows"])) if d else \
                np.zeros(0, dtype=np.int64)
            tombs = np.fromiter(d["tombs"], dtype=np.int64,
                                count=len(d["tombs"])) if d else \
                np.zeros(0, dtype=np.int64)
            return PackDelta(self.compactions, fence, rows, tombs,
                             self._pool_version.get(pool, 0))

    def _touch_row(self, pool: str, row: int, tomb: bool = False) -> None:
        """Journal one row touch for every attached consumer (caller
        holds self._lock)."""
        self._pool_version[pool] = self._pool_version.get(pool, 0) + 1
        for c in self._consumers.values():
            d = c["pools"].get(pool)
            if d is None:
                d = c["pools"][pool] = {"rows": set(), "tombs": set()}
            d["rows"].add(int(row))
            if tomb:
                d["tombs"].add(int(row))

    def _fence_all(self) -> None:
        """Global order invalidation (caller holds self._lock): every
        consumer must full-repack every pool before trusting row ids or
        cached keys again."""
        self._fence_version += 1

    # ------------------------------------------------------------ tx events
    def _on_events(self, tx_id: int, events) -> None:
        # borrowed (no-deepcopy) reads: this handler runs for every event of
        # every transaction, and only copies scalar fields into columns
        with self._lock:
            for e in events:
                kind = e.kind
                if kind in ("job-created", "job-committed", "job-state"):
                    job = self.store.job_ref(e.data.get("uuid"))
                    if job is not None:
                        self._sync_job_raw(job)
                elif kind == "instance-created":
                    inst = self.store.instance_ref(e.data.get("task_id"))
                    if inst is not None and inst.status in _LIVE:
                        self._add_instance_raw(inst)
                    if inst is not None:
                        # the job now has a prior instance: novel-host (and
                        # checkpoint locality on restart) may apply
                        row = self._row.get(inst.job_uuid)
                        if row is not None:
                            self._complex[row] = True
                elif kind == "instance-status":
                    tid = e.data.get("task_id")
                    inst = self.store.instance_ref(tid)
                    if inst is None or inst.status not in _LIVE:
                        self._remove_instance_raw(tid)
                    elif inst.status in _LIVE:
                        # replays / resurrect paths: make sure it's tracked
                        self._add_instance_raw(inst)

    # ------------------------------------------------------------- queries
    def rank_arrays(self, pool: str,
                    ) -> Optional[Tuple[Dict[str, np.ndarray], np.ndarray,
                                        np.ndarray, List[str]]]:
        """Unpadded RankInputs columns for one pool, plus the sorted-order
        uuid and user arrays (kernel order positions -> job uuid/user) and
        the pool's distinct users in segment order.  None when the pool has
        no pending jobs (matching the entity path's early-out)."""
        with self._lock:
            got = self._rank_rows_locked(pool)
            if got is None:
                return None
            arrays, rows_s, user_s, seg_start = got
            if user_s is None:  # order-cache path skips the full gather
                user_s = self._user[rows_s]
            return (arrays, self._uuid[rows_s], user_s,
                    list(user_s[seg_start]))

    def _key_fields(self, rows: np.ndarray, start: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(byte keys, start, uid) for (row, start) task entries (caller
        holds _lock).  Keys are fixed-width big-endian byte strings —
        each field sign-biased so that one memcmp equals the lexsort
        field comparison order below."""
        n = len(rows)
        kb = np.empty((n, _KEY_NBYTES), dtype=np.uint8)
        uid = self._uid[rows].astype(np.int32, copy=True)
        st = np.ascontiguousarray(start, dtype=np.int64)

        def be32(x, off):  # i64-safe signed -> biased big-endian u32
            kb[:, off:off + 4] = (x.astype(np.int64) + 2**31) \
                .astype(">u4").view(np.uint8).reshape(n, 4)

        def be64(x, off):  # u64 (sign bit pre-flipped for signed) -> BE
            kb[:, off:off + 8] = x.astype(">u8").view(np.uint8) \
                .reshape(n, 8)

        be32(uid, 0)
        be32(-self._prio[rows], 4)  # int32 negation, as in the lexsort
        be64(st.astype(np.uint64) ^ np.uint64(1 << 63), 8)
        be64(self._submit[rows].astype(np.uint64) ^ np.uint64(1 << 63), 16)
        be64(self._uhi[rows], 24)
        be64(self._ulo[rows], 32)
        return kb.reshape(-1).view(_KEY_DT), st, uid

    def _repair_order(self, e: Dict) -> None:
        """Apply the journaled (row, start) add/del deltas to one pool's
        cached sorted order by searchsorted merge — O(churn log n + n
        memcpy) instead of the full O(n log n) lexsort.  The memcpy tail
        runs in native/pack.cpp when the toolchain built it (one merge
        pass over the four parallel arrays) and falls back to
        np.delete/np.insert otherwise.

        The journal is order-preserving: an entry added and removed between
        two ranks (launch then completion inside one cycle) must cancel,
        not apply as a del-miss followed by a stale insert."""
        adds: Dict[Tuple[int, int], int] = {}
        dels: List[Tuple[int, int]] = []
        for op, row, start in e["log"]:
            k = (row, start)
            if op > 0:
                adds[k] = adds.get(k, 0) + 1
            elif adds.get(k, 0) > 0:
                adds[k] -= 1  # cancels a not-yet-applied add
            else:
                dels.append(k)
        e["log"] = []
        if not dels and not adds:
            return
        kb, st, uid, rows = e["kb"], e["st"], e["uid"], e["rows"]
        del_pos = np.zeros(0, dtype=np.int64)
        if dels:
            drows = np.array([r for r, _ in dels], dtype=np.int64)
            dstart = np.array([s for _, s in dels], dtype=np.int64)
            dkb, _dst, _duid = self._key_fields(drows, dstart)
            dkb = dkb[np.argsort(dkb, kind="stable")]
            pos = np.searchsorted(kb, dkb, side="left")
            # identical keys (same job, same start) form a run: the k-th
            # duplicate delete takes the k-th entry of the run
            for i in range(1, len(pos)):
                if pos[i] <= pos[i - 1] and dkb[i] == dkb[i - 1]:
                    pos[i] = pos[i - 1] + 1
            # a miss means the entry predates the cache; `pos` is already
            # sorted (nondecreasing from sorted needles, strictly advanced
            # within equal-key runs)
            ok = pos < len(kb)
            if ok.any():
                ok[ok] = kb[pos[ok]] == dkb[ok]
            del_pos = pos[ok].astype(np.int64)
        add_list = [k for k, c in adds.items() for _ in range(c)]
        if add_list:
            arows = np.array([r for r, _ in add_list], dtype=np.int64)
            astart = np.array([s for _, s in add_list], dtype=np.int64)
            akb, ast, auid = self._key_fields(arows, astart)
            aorder = np.argsort(akb, kind="stable")
            akb, ast, auid, arows = \
                akb[aorder], ast[aorder], auid[aorder], arows[aorder]
            # insertion points in the POST-delete array, computed without
            # materializing it: entries before a side="left" boundary are
            # strictly smaller, so deletions below the boundary shift it
            # down one-for-one
            ins = np.searchsorted(kb, akb, side="left")
            if len(del_pos):
                ins = ins - np.searchsorted(del_pos, ins, side="left")
        else:
            akb = ast = auid = arows = None
            ins = np.zeros(0, dtype=np.int64)
        from ..native.pack import order_merge
        e["kb"], e["st"], e["uid"], e["rows"] = order_merge(
            kb, st, uid, rows, del_pos, ins, akb, ast, auid, arows)

    def _rank_rows_locked(self, pool: str, skip_usage: bool = False):
        """Shared body of rank_arrays/fused_arrays (caller holds _lock):
        returns (arrays, sorted row indices, sorted users, segment starts)."""
        if self._maybe_compact():
            self._ord.clear()  # row indices were remapped
        n = self._n
        if self._sortable:
            e = self._ord.get(pool)
            if e is not None:
                self._repair_order(e)
                rows_s = e["rows"]
                pending = e["st"] == PENDING_START
                if not pending.any():
                    return None  # no pending jobs (entity-path early-out)
                return self._rank_arrays_tail(rows_s, pending,
                                              uid_s=e["uid"],
                                              skip_usage=skip_usage)
        pool_match = self._pool[:n] == pool
        prow = np.flatnonzero(pool_match & self._pending[:n])
        if prow.size == 0:
            return None
        ijr = self._inst_job_row[:self._ninst]
        ilive = np.flatnonzero(pool_match[ijr]) if self._ninst else \
            np.zeros(0, dtype=np.int64)
        irow = ijr[ilive]
        rows = np.concatenate([prow, irow])
        start = np.concatenate([
            np.full(prow.size, PENDING_START, dtype=np.int64),
            self._inst_start[:self._ninst][ilive]])
        pending = np.zeros(rows.size, dtype=bool)
        pending[:prow.size] = True

        if self._sortable:
            # all-integer sort keys (uuid halves + user id): ~2.3x faster
            # than the string lexsort at the 100k+ design point, identical
            # order (canonical uuids sort the same as their 128-bit value,
            # user ids are name-rank)
            order = np.lexsort((self._ulo[rows], self._uhi[rows],
                                self._submit[rows], start,
                                -self._prio[rows], self._uid[rows]))
        else:
            order = np.lexsort((self._uuid[rows], self._submit[rows], start,
                                -self._prio[rows], self._user[rows]))
        rows_s = rows[order]
        if self._sortable:
            # seed the incremental order cache for the next cycles
            kb, st_s, uid_s = self._key_fields(rows_s, start[order])
            self._ord[pool] = {"kb": kb, "st": st_s, "uid": uid_s,
                               "rows": rows_s.copy(), "log": []}
        user_s = self._user[rows_s]
        return self._rank_arrays_tail(rows_s, pending[order], user_s=user_s,
                                      skip_usage=skip_usage)

    def _rank_arrays_tail(self, rows_s: np.ndarray, pending_s: np.ndarray,
                          user_s: Optional[np.ndarray] = None,
                          uid_s: Optional[np.ndarray] = None,
                          skip_usage: bool = False):
        """Segment bookkeeping + column gathers for already-sorted rows
        (``pending_s`` in sorted order); shared by the lexsort path and the
        incremental order-cache path.  Segment boundaries come from
        ``uid_s`` (int compare) when given — an order-preserving id change
        is exactly a user change — else from the user strings.

        The full sorted user-string column is NOT materialized here: a
        U64 gather is ~25 MB of unicode copying at the 100k design point
        and segment boundaries only need the int ids.  Callers that want
        user strings gather the slice they need from ``self._user``."""
        if user_s is None and uid_s is None:
            user_s = self._user[rows_s]
        first = np.ones(rows_s.size, dtype=bool)
        if uid_s is not None:
            first[1:] = uid_s[1:] != uid_s[:-1]
        else:
            first[1:] = user_s[1:] != user_s[:-1]
        seg_start = np.flatnonzero(first)
        arrays = {
            "pending": pending_s,
            "valid": np.ones(rows_s.size, dtype=bool),
            "is_first": first,
        }
        if not skip_usage:
            # the compact device path re-derives first_idx/user_rank ON
            # DEVICE from the is_first flag bit (parallel/sharded
            # expand_compact) and gathers res via the base mirror; only
            # the legacy/rank paths pay these [T]-sized builds
            seg_id = np.cumsum(first) - 1
            arrays["first_idx"] = seg_start.astype(np.int32)[seg_id]
            arrays["user_rank"] = seg_id.astype(np.int32)
            arrays["usage"] = self._res[rows_s]
        return (arrays, rows_s, user_s, seg_start)

    def fused_arrays(self, pool: str, owner_uuids=None,
                     compact: bool = False):
        """rank_arrays plus the fused cycle's extra columns, all in the same
        sorted row order: ``job_res`` f32[n,4] = (cpus, mem, gpus, disk) —
        the match kernel's per-row resource demand — and ``complex`` bool[n]
        marking rows whose job needs entity-level constraint handling
        (see _is_complex).  None when the pool has no pending jobs.

        uuid/user columns are returned as BASE-array snapshots plus
        ``rows_s`` instead of materialized sorted gathers: unicode gathers
        cost ~40 MB of copying per cycle at 100k rows, while the cycle
        reads ~1k prefix uuids.  The snapshots stay valid forever: row
        values for uuid/user/res never mutate, and growth/compaction
        REPLACE the buffers (``_grow``, ``_maybe_compact``) rather than
        moving rows in place.

        ``owner_uuids`` (reservation owners) are resolved to base rows
        UNDER THE SAME LOCK HOLD as the snapshot: a later ``rows_for``
        call could race a compaction and compare remapped row ids against
        the pre-compaction ``rows_s``.

        With ``compact=True`` (the production device path) the [T]-sized
        usage/job_res gathers are SKIPPED entirely: the driver mirrors the
        immutable res/disk base columns on device (keyed on
        ``compactions``) and gathers by ``rows_s`` there, so the host
        never builds per-task resource columns at all."""
        with self._lock:
            got = self._rank_rows_locked(pool, skip_usage=compact)
            if got is None:
                return None
            arrays, rows_s, _user_s, seg_start = got
            if compact:
                job_res = None
            else:
                # reuse the usage gather (same _res rows) instead of a
                # second full-column fancy-index
                job_res = np.concatenate(
                    [arrays["usage"][:, :3], self._disk[rows_s][:, None]],
                    axis=1).astype(F32)
            owner_rows = {u: r for u in (owner_uuids or ())
                          if (r := self._row.get(u)) is not None}
            return FusedSnapshot(
                arrays=arrays, rows_s=rows_s,
                uuid_base=self._uuid[:self._n],
                user_base=self._user[:self._n],
                res_base=self._res[:self._n],
                disk_base=self._disk[:self._n],
                users=list(self._user[rows_s[seg_start]]),
                job_res=job_res, complex_s=self._complex[rows_s],
                owner_rows=owner_rows, compactions=self.compactions)

    def rows_for(self, uuids) -> np.ndarray:
        """Base-row indices for the given job uuids (unknown uuids are
        skipped).  Lets hot-path membership tests run on int64 rows instead
        of gathering string columns (e.g. reservation owners in the fused
        pack)."""
        with self._lock:
            return np.array([r for u in uuids
                             if (r := self._row.get(u)) is not None],
                            dtype=np.int64)

    def pool_usage_base(self, pool: str) -> np.ndarray:
        """Summed (cpus, mem, gpus, count) of the pool's live instances —
        the running-usage base of filter-based-on-quota
        (scheduler.clj:2134) without entity materialization."""
        with self._lock:
            if self._ninst == 0:
                return np.zeros(4, dtype=F32)
            ijr = self._inst_job_row[:self._ninst]
            mask = self._pool[:self._n][ijr] == pool
            return self._res[ijr[mask]].sum(axis=0).astype(F32) \
                if mask.any() else np.zeros(4, dtype=F32)

    def _maybe_compact(self) -> bool:
        """Drop rows of completed jobs with no live instances once they are
        the majority — bounds memory on a long-lived leader (caller holds
        self._lock).  Returns True when a compaction ran (row indices were
        remapped, so cached orders are stale)."""
        if self._dead < 4096 or self._dead * 2 < self._n:
            return False
        n = self._n
        # keep live rows plus anything a live instance still references; a
        # dropped job that ever transitions again is re-inserted by its
        # job-state event (the handler refetches the entity)
        keep = ~self._done[:n]
        keep[self._inst_job_row[:self._ninst]] = True
        new_rows = np.flatnonzero(keep)
        remap = np.full(n, -1, dtype=np.int64)
        remap[new_rows] = np.arange(new_rows.size)
        for arr_name in ("_res", "_disk", "_complex", "_prio", "_submit",
                         "_uuid", "_user", "_pool", "_pending", "_done",
                         "_uid", "_uhi", "_ulo"):
            arr = getattr(self, arr_name)
            setattr(self, arr_name, arr[:n][new_rows].copy())
        self._row = {u: int(remap[r]) for u, r in self._row.items()
                     if remap[r] >= 0}
        self._inst_job_row[:self._ninst] = remap[
            self._inst_job_row[:self._ninst]]
        self._n = new_rows.size
        self._dead = int(self._done[:self._n].sum())
        # row indices were remapped: device-resident base mirrors keyed on
        # this counter must fully resync (growth, by contrast, preserves
        # row indices and never bumps it), and every delta consumer's
        # resident rows are invalid — fence, never scatter stale rows
        self.compactions += 1
        self._fence_all()
        return True
