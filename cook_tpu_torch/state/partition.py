"""The port's copy of ``cook_tpu/state/partition.py``: the partitioned
write plane, which shards the store and its journal by pool group.

- :class:`PartitionMap` — a deterministic, config-declared ``pool →
  partition`` routing map, validated at boot and persisted next to the
  partition directories so a re-partitioned reopen fails loudly instead
  of silently stranding jobs in the wrong journal.
- :class:`PartitionedStore` — a facade over P :class:`~.store.Store`
  instances, each with its OWN journal file, fsync stream, group-commit
  stage (``_GroupCommitStage`` runs per partition, so concurrent
  batches on different partitions force their logs in parallel),
  replication topology, and leader lease.  Single-pool writes route
  straight to the owning partition; cross-partition reads fan out and
  merge.  Fan-out is STRICTLY SEQUENTIAL — each partition's lock is
  released before the next is touched (the ``store[pN]`` sibling-lock
  rule in utils/locks.py is the sanitizer-enforced form of that
  contract).
- **Partition-qualified commit tokens** — the epoch-qualified
  read-your-writes tokens become ``(partition, epoch, offset)`` triples
  on the wire (``p0:3:128``); :meth:`PartitionedStore.commit_token`
  returns the comma-joined VECTOR of every partition's position, the
  client carries the per-partition maximum, and the follower wait-gate
  satisfies each entry against the mirror of that entry's partition
  (offsets are NEVER comparable across partitions).
- :class:`UserSummaryExchange` — cross-partition invariants (per-user
  quotas, the monitor's global DRU view) exchange bounded PER-USER
  summaries between partitions — counts and resource sums, never job
  state — with an explicit, asserted staleness window.
- :class:`PartitionedReadView` — a standby's live read plane over P
  mirrored partition directories (state/read_replica.py per shard), with
  the per-partition token wait-gate.

``P=1`` is the compatibility mode: one partition, classic lock names are
the only difference callers can observe, and the node keeps using the
plain :class:`Store` unless partitioning is configured.  A partitioned
node runs its scheduler on the entity path (``PartitionedStore.
ensure_index`` refuses the columnar index), so its leader's cycle is the
dense-mask K1-K6 chain on the card.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..utils.locks import named_lock
from .schema import Group, Job, Pool, QuotaEntry, ShareEntry
from .store import (
    AbortTransaction,
    Instance,
    ReplicationIndeterminate,
    Store,
)

#: pool name reserved for cross-partition control documents (the global
#: per-user quota plane): always routed to partition 0, visible to every
#: partition through the summary-exchange enforcement path
GLOBAL_POOL = "*"

#: routing-map sidecar persisted next to the partition directories
PARTITION_MAP_FILE = "partition_map.json"


class PartitionRoutingError(ValueError):
    """A write that cannot be routed: a gang/group spanning partitions,
    or a persisted routing map that disagrees with the configured one."""


class SummaryStalenessError(RuntimeError):
    """The cross-shard user-summary table could not be brought under
    its staleness bound (a peer shard's table is too old): global
    enforcement reads must fail loudly rather than consume a view
    whose window the quota refusal would then misquote."""


class PartitionMap:
    """Deterministic ``pool → partition`` routing.

    ``pools`` declares explicit pool groups (pool name → partition
    index, validated at construction); every undeclared pool hashes
    stably (crc32 mod count) so any process — REST node, standby,
    client tooling — computes the same owner without coordination."""

    def __init__(self, count: int = 1,
                 pools: Optional[Dict[str, int]] = None):
        count = int(count)
        if count < 1:
            raise ValueError(f"partition count must be >= 1, got {count}")
        self.count = count
        self.pools: Dict[str, int] = {}
        for pool, idx in (pools or {}).items():
            if not isinstance(idx, int) or isinstance(idx, bool) \
                    or not 0 <= idx < count:
                raise ValueError(
                    f"partition for pool {pool!r} must be an int in "
                    f"[0, {count}), got {idx!r}")
            self.pools[str(pool)] = idx

    def partition_of(self, pool: str) -> int:
        if pool == GLOBAL_POOL:
            return 0  # cross-partition control documents live on p0
        idx = self.pools.get(pool)
        if idx is not None:
            return idx
        return zlib.crc32(pool.encode()) % self.count

    def to_doc(self) -> Dict[str, Any]:
        return {"count": self.count, "pools": dict(self.pools)}

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "PartitionMap":
        return cls(count=doc.get("count", 1), pools=doc.get("pools"))


# --------------------------------------------------------------- tokens
def parse_token_entry(entry: str) -> Tuple[Optional[int], Optional[int],
                                           int]:
    """One commit-token entry → ``(partition, epoch, offset)``.
    Accepted forms: ``p<P>:<epoch>:<offset>``, ``p<P>:<offset>``,
    ``<epoch>:<offset>``, ``<offset>`` (partition/epoch None when
    absent).  Raises ValueError on garbage."""
    part: Optional[int] = None
    if entry.startswith("p"):
        head, sep, rest = entry.partition(":")
        if not sep:
            raise ValueError(f"malformed token entry {entry!r}")
        part = int(head[1:])
        entry = rest
    if ":" in entry:
        ep, _, off = entry.partition(":")
        return part, int(ep), int(off)
    return part, None, int(entry)


def parse_token_vector(token: str) -> List[Tuple[Optional[int],
                                                 Optional[int], int]]:
    """A comma-joined commit-token vector → entry triples.  A legacy
    single token parses to a one-entry list with partition None."""
    return [parse_token_entry(e.strip())
            for e in token.split(",") if e.strip()]


class UserSummaryExchange:
    """Bounded per-user summaries exchanged between partitions.

    Cross-partition invariants must never ship job state between
    partitions (that would rebuild the single write funnel this module
    removes); what crosses is one small dict per user — pending/running
    counts and running resource sums (:meth:`Store.user_summary`) —
    refreshed lazily with an explicit staleness bound.  Consumers that
    enforce (the global per-user quota refusal) assert the window; the
    monitor's global DRU view reads the same merged table.

    ``peer_fetch`` (the sharded controllers) feeds the tables of
    REMOTE shard processes into the same merge: a zero-arg callable
    returning ``[(users_table, age_s), ...]`` — one entry per peer
    shard, each table stamped with how old it already was when fetched
    (socket carrier locally, ICI/DCN collectives on a real mesh).  The
    merged table's staleness then includes the OLDEST peer age, so the
    bound consumers quote covers the whole fleet, not just the local
    sweep.  With ``assert_bound`` a sweep that cannot get the table
    under ``max_age_s`` raises :class:`SummaryStalenessError` instead
    of serving silently-stale enforcement state."""

    def __init__(self, partitions: List[Store], max_age_s: float = 1.0,
                 peer_fetch: Optional[Callable[
                     [], List[Tuple[Dict[str, Dict[str, float]], float]]]]
                 = None,
                 assert_bound: bool = False):
        self._partitions = partitions
        self._peer_fetch = peer_fetch
        self.assert_bound = bool(assert_bound)
        self.peer_tables = 0       # peers merged into the last sweep
        self.peer_age_s = 0.0      # oldest peer table age at last sweep
        self.max_age_s = max(float(max_age_s), 0.0)
        self._mu = named_lock("partition.summaries")
        # serializes whole sweeps (sweep → install under _mu): two
        # racing refreshes could otherwise install an OLDER sweep over
        # a newer one while stamping it fresh — the staleness the
        # quota refusal quotes must never lie
        self._refresh_mu = named_lock("partition.summaries.refresh")
        self._merged: Dict[str, Dict[str, float]] = {}
        self._refreshed_at: float = float("-inf")
        self.refreshes = 0

    def staleness_s(self) -> float:
        """Seconds since the merged table was last recomputed (inf
        before the first refresh) — the asserted window bound."""
        return time.monotonic() - self._refreshed_at

    def _sweep_locked(self) -> None:
        """Merge every partition's user summary, plus peer shard tables
        when a carrier is attached (caller holds _refresh_mu)."""
        summaries = [p.user_summary() for p in self._partitions]
        peer_age = 0.0
        peers: List[Dict[str, Dict[str, float]]] = []
        if self._peer_fetch is not None:
            for table, age_s in self._peer_fetch():
                peers.append(table)
                peer_age = max(peer_age, max(float(age_s), 0.0))
        merged: Dict[str, Dict[str, float]] = {}
        for summary in summaries + peers:
            for user, u in summary.items():
                m = merged.setdefault(user, {
                    "pending": 0.0, "running": 0.0,
                    "cpus": 0.0, "mem": 0.0, "gpus": 0.0})
                for k, v in u.items():
                    m[k] += v
        with self._mu:
            self._merged = merged
            # a peer table that was already age_s old when it crossed
            # the wire backdates the whole merge: staleness_s() is the
            # fleet-wide bound, never just the local sweep's
            self._refreshed_at = time.monotonic() - peer_age
            self.peer_tables = len(peers)
            self.peer_age_s = peer_age
            self.refreshes += 1

    def refresh(self) -> None:
        """Recompute the merged table: one sequential sweep, each
        partition's summary taken under ITS lock only (no sibling
        nesting — the summaries themselves are the exchange payload).
        Sweeps are serialized so a stalled sweep can never overwrite a
        newer table while stamping it fresh."""
        with self._refresh_mu:
            self._sweep_locked()

    def _ensure_fresh(self) -> None:
        """Refresh when past the window — double-checked under the
        sweep lock so a herd of enforcement reads does one sweep, not
        one each."""
        if self.staleness_s() > self.max_age_s:
            with self._refresh_mu:
                if self.staleness_s() > self.max_age_s:
                    self._sweep_locked()
            if self.assert_bound and self.staleness_s() > self.max_age_s:
                # even a fresh sweep could not get under the window
                # (a peer shard's table is too old — dead peer, wedged
                # carrier): enforcement must not pretend it has a
                # current global view
                raise SummaryStalenessError(
                    f"cross-shard user summary is {self.staleness_s():.3f}s "
                    f"stale (bound {self.max_age_s}s; oldest peer table "
                    f"{self.peer_age_s:.3f}s, {self.peer_tables} peers "
                    "merged)")

    def merged(self) -> Dict[str, Dict[str, float]]:
        """The cross-partition per-user table, refreshed when older
        than ``max_age_s`` (the bounded-staleness contract)."""
        self._ensure_fresh()
        with self._mu:
            return {u: dict(v) for u, v in self._merged.items()}

    def user_totals(self, user: str) -> Dict[str, float]:
        # one user's entry, one small copy — this sits on the REST
        # write hot path (check_user_quota per submission); copying the
        # whole merged table there would scale with total users
        self._ensure_fresh()
        with self._mu:
            u = self._merged.get(user)
            return dict(u) if u else {
                "pending": 0.0, "running": 0.0,
                "cpus": 0.0, "mem": 0.0, "gpus": 0.0}

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            return {"users": len(self._merged),
                    "refreshes": self.refreshes,
                    "max_age_s": self.max_age_s,
                    "peer_tables": self.peer_tables,
                    "peer_age_s": round(self.peer_age_s, 4),
                    "staleness_s": round(min(self.staleness_s(), 1e12),
                                         4)}


class _PartitionedAudit:
    """The facade's audit surface: per-job lanes live on the partition
    that journaled them; pool-keyed planes route; aggregate stats and
    configuration fan out."""

    def __init__(self, ps: "PartitionedStore"):
        self._ps = ps

    @property
    def enabled(self) -> bool:
        return any(s.audit.enabled for s in self._ps.partitions)

    def configure(self, conf) -> None:
        for store in self._ps.partitions:
            store.audit.configure(conf)

    def record(self, uuid: str, kind: str, data=None, **kw) -> None:
        store = self._ps._route_job(uuid)
        if store is not None:
            store.audit.record(uuid, kind, data, **kw)

    def set_user_dru(self, pool: str, table: Dict[str, float]) -> None:
        self._ps._for_pool(pool).audit.set_user_dru(pool, table)

    def ranked(self, uuids, positions, pool: str, users=None) -> None:
        # a rank cycle is per pool, and a pool lives on ONE partition
        self._ps._for_pool(pool).audit.ranked(uuids, positions, pool,
                                              users=users)

    def skips(self, mapping: Dict[str, Any],
              pool: Optional[str] = None) -> None:
        if pool is not None:
            self._ps._for_pool(pool).audit.skips(mapping, pool=pool)
            return
        # poolless attribution (gang resets): split items per owning
        # partition by job membership
        for store in self._ps.partitions:
            sub: Dict[str, List[Any]] = {}
            for reason, items in mapping.items():
                keep = [it for it in items
                        if (it[0] if isinstance(it, tuple) else it)
                        in store._jobs]
                if keep:
                    sub[reason] = keep
            if sub:
                store.audit.skips(sub)

    def last_reasons(self, uuids) -> Dict[str, Optional[str]]:
        out: Dict[str, Optional[str]] = {u: None for u in uuids}
        by_part: Dict[int, List[str]] = {}
        for u in uuids:
            p = self._ps._partition_of_job(u)
            if p is not None:
                by_part.setdefault(p, []).append(u)
        for p, batch in by_part.items():
            out.update(self._ps.partitions[p].audit.last_reasons(batch))
        return out

    def publish_metrics(self) -> None:
        for store in self._ps.partitions:
            store.audit.publish_metrics()

    def timeline(self, uuid: str) -> List[Dict[str, Any]]:
        p = self._ps._partition_of_job(uuid)
        if p is not None:
            return self._ps.partitions[p].audit.timeline(uuid)
        for store in self._ps.partitions:
            tl = store.audit.timeline(uuid)
            if tl:
                return tl
        return []

    def user_dru(self, pool: str, user: str):
        return self._ps._for_pool(pool).audit.user_dru(pool, user)

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"jobs": 0, "pending_durable": 0,
                               "shed_advisory": False, "shed_count": 0,
                               "by_kind": {}}
        for store in self._ps.partitions:
            s = store.audit.stats()
            out["jobs"] += s.get("jobs", 0)
            out["pending_durable"] += s.get("pending_durable", 0)
            out["shed_advisory"] |= bool(s.get("shed_advisory"))
            out["shed_count"] += s.get("shed_count", 0)
            for k, v in (s.get("by_kind") or {}).items():
                out["by_kind"][k] = out["by_kind"].get(k, 0) + v
        return out

    def skip_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for store in self._ps.partitions:
            for k, v in store.audit.skip_counts().items():
                out[k] = out.get(k, 0) + v
        return out


class PartitionedStore:
    """Facade over P partition :class:`Store` shards (module doc).

    Write routing: pool-carrying writes go straight to the owning
    partition; entity-keyed writes (job uuid / task id) resolve the
    owner by membership probe (P is small; the probe is one dict hit
    per partition).  Reads fan out sequentially and merge.  A
    cross-partition batch is NOT one atomic transaction — each
    partition's sub-batch keeps the all-or-nothing guarantee, and
    client retries stay idempotent on job uuid (the same contract an
    indeterminate commit already forces on the wire)."""

    def __init__(self, partitions: List[Store], pmap: PartitionMap,
                 summary_max_age_s: float = 1.0):
        if len(partitions) != pmap.count:
            raise ValueError(
                f"{len(partitions)} stores for a {pmap.count}-partition "
                "map")
        for i, store in enumerate(partitions):
            if store.partition != i:
                raise ValueError(
                    f"store at slot {i} carries partition id "
                    f"{store.partition!r}; open each shard with "
                    "partition=i")
        self.partitions = partitions
        self.pmap = pmap
        self.summaries = UserSummaryExchange(
            partitions, max_age_s=summary_max_age_s)
        self._directory: Optional[str] = None

    # ------------------------------------------------------------- open
    @classmethod
    def open(cls, directory: str, pmap: PartitionMap,
             fsync: bool = False, epoch=None, shared: bool = True,
             summary_max_age_s: float = 1.0) -> "PartitionedStore":
        """Open (or create) a partitioned data dir: one ``p<i>/``
        shard directory per partition, each a full durable Store
        (snapshot + journal + optional epoch fence — the per-partition
        lease claim).  The routing map is persisted at the root and
        re-validated on every open: silently reopening P shards under a
        different map would strand every previously-routed pool."""
        os.makedirs(directory, exist_ok=True)
        map_path = os.path.join(directory, PARTITION_MAP_FILE)
        if os.path.exists(map_path):
            with open(map_path, encoding="utf-8") as f:
                persisted = json.load(f)
            if persisted.get("count") != pmap.count \
                    or (persisted.get("pools") or {}) != pmap.pools:
                raise PartitionRoutingError(
                    f"partition map mismatch: directory {directory!r} "
                    f"was laid out as {persisted}, configured "
                    f"{pmap.to_doc()} — re-partitioning requires an "
                    "explicit migration, not a reopen")
        else:
            from ..utils.fsatomic import write_atomic_text
            write_atomic_text(map_path, json.dumps(pmap.to_doc()))
        stores = [Store.open(os.path.join(directory, f"p{i}"),
                             fsync=fsync, epoch=epoch, shared=shared,
                             partition=i)
                  for i in range(pmap.count)]
        ps = cls(stores, pmap, summary_max_age_s=summary_max_age_s)
        ps._directory = directory
        return ps

    # ---------------------------------------------------------- routing
    def _for_pool(self, pool: str) -> Store:
        return self.partitions[self.pmap.partition_of(pool)]

    def _partition_of_job(self, uuid: str) -> Optional[int]:
        # membership probe: a bare dict hit per partition (GIL-atomic;
        # commits install whole replacement objects, so a hit is a
        # complete entity and a miss is authoritative at probe time)
        for i, store in enumerate(self.partitions):
            if uuid in store._jobs:
                return i
        return None

    def _partition_of_instance(self, task_id: str) -> Optional[int]:
        for i, store in enumerate(self.partitions):
            if task_id in store._instances:
                return i
        return None

    def _route_job(self, uuid: str) -> Optional[Store]:
        p = self._partition_of_job(uuid)
        return self.partitions[p] if p is not None else None

    def _route_instance(self, task_id: str) -> Optional[Store]:
        p = self._partition_of_instance(task_id)
        return self.partitions[p] if p is not None else None

    # ------------------------------------------------------------ clock
    @property
    def clock(self) -> Callable[[], int]:
        return self.partitions[0].clock

    @clock.setter
    def clock(self, fn: Callable[[], int]) -> None:
        for store in self.partitions:
            store.clock = fn

    @property
    def audit(self) -> _PartitionedAudit:
        return _PartitionedAudit(self)

    # ------------------------------------------------------- submission
    def create_jobs(self, jobs: Iterable[Job], groups: Iterable[Group] = (),
                    latch: Optional[str] = None) -> List[str]:
        """Route each job to its pool's partition; one transaction per
        TOUCHED partition (a single-pool batch — the hot path the REST
        fleet routes — stays exactly one transaction on one journal).
        Groups ride with their member jobs and must not span partitions
        (a gang split across journals could never launch atomically).
        Indeterminate outcomes demux PER PARTITION: sub-batches on
        healthy partitions commit determinately; the ambiguous ones
        re-raise after every partition was attempted.

        All-or-nothing across partitions: duplicates are pre-checked
        against EVERY partition before anything mutates, and an abort
        that still fires mid-fan-out (a concurrent same-uuid race)
        rolls the earlier partitions' latched sub-batches back
        (:meth:`Store.discard_latched` — they were never visible), so a
        409 keeps meaning "nothing was created", exactly as on the
        single store.  The latchless direct-call path keeps only
        per-partition atomicity (callers that want the full guarantee
        pass a latch, as the REST tier always does)."""
        jobs = list(jobs)
        for job in jobs:
            if self._partition_of_job(job.uuid) is not None:
                # the same check create_new_jobs makes per shard, made
                # BEFORE any shard mutates: a cross-partition batch
                # must not strand sub-batches behind a late duplicate
                raise AbortTransaction(f"duplicate job uuid {job.uuid}")
        by_part: Dict[int, List[Job]] = {}
        for job in jobs:
            by_part.setdefault(
                self.pmap.partition_of(job.pool), []).append(job)
        groups_by_part: Dict[int, List[Group]] = {}
        members = {j.uuid: j for j in jobs}
        for group in groups:
            owner: Optional[int] = None
            for uuid in group.jobs:
                j = members.get(uuid)
                if j is None:
                    continue
                p = self.pmap.partition_of(j.pool)
                if owner is None:
                    owner = p
                elif owner != p:
                    raise PartitionRoutingError(
                        f"group {group.uuid} spans partitions {owner} "
                        f"and {p}: a group's jobs must share a pool "
                        "group (declare the pools in the same "
                        "partition)")
            # a MERGE into an existing group must land on the partition
            # already holding it (membership probe, as _route_job)
            existing = next((i for i, s in enumerate(self.partitions)
                             if group.uuid in s._groups), None)
            if existing is not None:
                if owner is not None and owner != existing:
                    raise PartitionRoutingError(
                        f"group {group.uuid} lives on partition "
                        f"{existing} but its new jobs route to "
                        f"{owner}: a group's pools may not change "
                        "partition")
                owner = existing
            groups_by_part.setdefault(
                owner if owner is not None else 0, []).append(group)
        indeterminate: Optional[ReplicationIndeterminate] = None
        done: List[int] = []
        for p in sorted(set(by_part) | set(groups_by_part)):
            try:
                self.partitions[p].create_jobs(
                    by_part.get(p, []), groups=groups_by_part.get(p, ()),
                    latch=latch)
                done.append(p)
            except ReplicationIndeterminate as e:
                # locally durable on that partition: keep going — the
                # other partitions' writers must not be held hostage
                indeterminate = e
                done.append(p)
            except AbortTransaction:
                # a duplicate raced past the pre-check (or the shard
                # refused for its own reasons): earlier partitions'
                # sub-batches are latched-invisible — roll them back so
                # the abort means NOTHING was created
                if latch is not None:
                    for q in done:
                        try:
                            self.partitions[q].discard_latched(latch)
                        except Exception:
                            # best-effort: a partition that cannot
                            # confirm the discard leaves its jobs
                            # latched-invisible; the client's
                            # idempotent retry path still heals them
                            pass
                raise
        if indeterminate is not None:
            raise ReplicationIndeterminate(
                f"partitioned submission partially unconfirmed: "
                f"{indeterminate}")
        return [j.uuid for j in jobs]

    def commit_jobs(self, uuids: List[str]) -> int:
        by_part: Dict[int, List[str]] = {}
        for uuid in uuids:
            p = self._partition_of_job(uuid)
            if p is not None:
                by_part.setdefault(p, []).append(uuid)
        return sum(self.partitions[p].commit_jobs(batch)
                   for p, batch in sorted(by_part.items()))

    def commit_latch(self, latch: str) -> None:
        for store in self.partitions:
            if latch in store._latches:
                store.commit_latch(latch)

    # --------------------------------------------------------- launches
    def launch_instance(self, job_uuid: str, task_id: str, hostname: str,
                        **kw) -> Instance:
        store = self._route_job(job_uuid)
        if store is None:
            raise AbortTransaction("no-such-job")
        return store.launch_instance(job_uuid, task_id, hostname, **kw)

    def launch_instances(self, entries: List[Dict[str, Any]]
                         ) -> Tuple[List[Instance],
                                    List[Tuple[str, str]]]:
        by_part: Dict[int, List[Dict[str, Any]]] = {}
        failures: List[Tuple[str, str]] = []
        gang_part: Dict[str, int] = {}
        for e in entries:
            p = self._partition_of_job(e["job_uuid"])
            if p is None:
                failures.append((e["job_uuid"], "no-such-job"))
                continue
            g = e.get("gang")
            if g:
                if gang_part.setdefault(g, p) != p:
                    raise PartitionRoutingError(
                        f"gang {g} spans partitions — group routing "
                        "admitted a cross-partition gang")
            by_part.setdefault(p, []).append(e)
        out: List[Instance] = []
        for p, batch in sorted(by_part.items()):
            insts, fails = self.partitions[p].launch_instances(batch)
            out.extend(insts)
            failures.extend(fails)
        return out, failures

    def update_instance_status(self, task_id: str, *a, **kw) -> bool:
        store = self._route_instance(task_id)
        return store.update_instance_status(task_id, *a, **kw) \
            if store is not None else False

    def update_instance_progress(self, task_id: str, *a, **kw) -> bool:
        store = self._route_instance(task_id)
        return store.update_instance_progress(task_id, *a, **kw) \
            if store is not None else False

    def update_instance_ports(self, task_id: str, ports) -> bool:
        store = self._route_instance(task_id)
        return store.update_instance_ports(task_id, ports) \
            if store is not None else False

    def update_instance_sandbox(self, task_id: str, **kw) -> bool:
        store = self._route_instance(task_id)
        return store.update_instance_sandbox(task_id, **kw) \
            if store is not None else False

    def clear_launch_intents(self, task_ids: List[str]) -> int:
        return sum(store.clear_launch_intents(task_ids)
                   for store in self.partitions)

    def launch_intents(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for store in self.partitions:
            out.extend(store.launch_intents())
        out.sort(key=lambda r: r.get("created_ms", 0))
        return out

    def kill_job(self, job_uuid: str) -> bool:
        store = self._route_job(job_uuid)
        return store.kill_job(job_uuid) if store is not None else False

    def retry_job(self, job_uuid: str, retries: int) -> bool:
        store = self._route_job(job_uuid)
        return store.retry_job(job_uuid, retries) \
            if store is not None else False

    def set_placement_investigation(self, job_uuid: str, **kw) -> bool:
        store = self._route_job(job_uuid)
        return store.set_placement_investigation(job_uuid, **kw) \
            if store is not None else False

    # --------------------------------------------------- dynamic config
    # control-plane documents are global: partition 0 is the authority
    # (the same slot the GLOBAL_POOL quota plane uses)
    def set_dynamic_config(self, key: str, value: Dict[str, Any]) -> None:
        self.partitions[0].set_dynamic_config(key, value)

    def update_dynamic_config(self, key: str,
                              updates: Dict[str, Any]) -> Dict[str, Any]:
        return self.partitions[0].update_dynamic_config(key, updates)

    def dynamic_config(self, key: str) -> Optional[Dict[str, Any]]:
        return self.partitions[0].dynamic_config(key)

    # ---------------------------------------------------------- queries
    def job(self, uuid: str) -> Optional[Job]:
        store = self._route_job(uuid)
        return store.job(uuid) if store is not None else None

    def jobs_bulk(self, uuids) -> List[Optional[Job]]:
        # keep the batched-read contract the scheduler's hot paths
        # rely on: ONE lock round + clone pass per touched partition,
        # not a probe + lock per uuid
        uuids = list(uuids)
        out: List[Optional[Job]] = [None] * len(uuids)
        by_part: Dict[int, List[int]] = {}
        for i, u in enumerate(uuids):
            p = self._partition_of_job(u)
            if p is not None:
                by_part.setdefault(p, []).append(i)
        for p, idxs in sorted(by_part.items()):
            got = self.partitions[p].jobs_bulk([uuids[i] for i in idxs])
            for i, j in zip(idxs, got):
                out[i] = j
        return out

    def job_ref(self, uuid: str) -> Optional[Job]:
        for store in self.partitions:
            j = store.job_ref(uuid)
            if j is not None:
                return j
        return None

    def instance_ref(self, task_id: str) -> Optional[Instance]:
        for store in self.partitions:
            i = store.instance_ref(task_id)
            if i is not None:
                return i
        return None

    def instance(self, task_id: str) -> Optional[Instance]:
        store = self._route_instance(task_id)
        return store.instance(task_id) if store is not None else None

    def group(self, uuid: str) -> Optional[Group]:
        for store in self.partitions:
            g = store.group(uuid)
            if g is not None:
                return g
        return None

    def group_is_gang(self, uuid: Optional[str]) -> bool:
        return any(store.group_is_gang(uuid) for store in self.partitions)

    def gang_size(self, uuid: Optional[str]) -> int:
        for store in self.partitions:
            n = store.gang_size(uuid)
            if n:
                return n
        return 0

    def gang_groups_of(self, jobs) -> Dict[str, Group]:
        out: Dict[str, Group] = {}
        for store in self.partitions:
            out.update(store.gang_groups_of(jobs))
        return out

    def gang_live_members(self, uuid: Optional[str]) -> int:
        # a gang lives whole inside ONE partition (group routing refuses
        # cross-partition gangs), so the first non-gang-free shard wins
        for store in self.partitions:
            if store.group_is_gang(uuid):
                return store.gang_live_members(uuid)
        return 0

    def gang_admission_size(self, uuid: Optional[str]) -> int:
        for store in self.partitions:
            if store.group_is_gang(uuid):
                return store.gang_admission_size(uuid)
        return 0

    def gang_growth_headroom(self, uuid: Optional[str]) -> float:
        for store in self.partitions:
            if store.group_is_gang(uuid):
                return store.gang_growth_headroom(uuid)
        return float("inf")

    def elastic_gang_groups(self) -> List[Group]:
        out: List[Group] = []
        for store in self.partitions:
            out.extend(store.elastic_gang_groups())
        return out

    def jobs_where(self, pred: Callable[[Job], bool],
                   clone: bool = True) -> List[Job]:
        out: List[Job] = []
        for store in self.partitions:
            out.extend(store.jobs_where(pred, clone=clone))
        return out

    def pending_jobs(self, pool: Optional[str] = None,
                     clone: bool = True) -> List[Job]:
        if pool is not None:
            # single-pool fast path: one partition owns the pool
            return self._for_pool(pool).pending_jobs(pool, clone=clone)
        out: List[Job] = []
        for store in self.partitions:
            out.extend(store.pending_jobs(clone=clone))
        return out

    def running_jobs(self, pool: Optional[str] = None) -> List[Job]:
        if pool is not None:
            return self._for_pool(pool).running_jobs(pool)
        out: List[Job] = []
        for store in self.partitions:
            out.extend(store.running_jobs())
        return out

    def running_instances(self, pool: Optional[str] = None,
                          clone: bool = True
                          ) -> List[Tuple[Job, Instance]]:
        if pool is not None:
            return self._for_pool(pool).running_instances(pool, clone=clone)
        out: List[Tuple[Job, Instance]] = []
        for store in self.partitions:
            out.extend(store.running_instances(clone=clone))
        return out

    def user_usage(self, pool: Optional[str] = None
                   ) -> Dict[str, Dict[str, float]]:
        if pool is not None:
            return self._for_pool(pool).user_usage(pool)
        merged: Dict[str, Dict[str, float]] = {}
        for store in self.partitions:
            for user, u in store.user_usage().items():
                m = merged.setdefault(user, {"count": 0.0, "cpus": 0.0,
                                             "mem": 0.0, "gpus": 0.0})
                for k, v in u.items():
                    m[k] = m.get(k, 0.0) + v
        return merged

    # ------------------------------------------------ pools/shares/quota
    def put_pool(self, pool: Pool) -> None:
        self._for_pool(pool.name).put_pool(pool)

    def pools(self) -> List[Pool]:
        out: List[Pool] = []
        for store in self.partitions:
            out.extend(store.pools())
        return out

    def pool(self, name: str) -> Optional[Pool]:
        return self._for_pool(name).pool(name)

    def set_share(self, user: str, pool: str, resources, reason: str = ""
                  ) -> None:
        self._for_pool(pool).set_share(user, pool, resources, reason)

    def get_share(self, user: str, pool: str) -> Dict[str, float]:
        return self._for_pool(pool).get_share(user, pool)

    def retract_share(self, user: str, pool: str) -> None:
        self._for_pool(pool).retract_share(user, pool)

    def set_quota(self, user: str, pool: str, resources,
                  count: float = float("inf"), reason: str = "") -> None:
        self._for_pool(pool).set_quota(user, pool, resources,
                                       count=count, reason=reason)

    def get_quota(self, user: str, pool: str) -> Dict[str, float]:
        return self._for_pool(pool).get_quota(user, pool)

    def retract_quota(self, user: str, pool: str) -> None:
        self._for_pool(pool).retract_quota(user, pool)

    def shares(self) -> List[ShareEntry]:
        out: List[ShareEntry] = []
        for store in self.partitions:
            out.extend(store.shares())
        return out

    def quotas(self) -> List[QuotaEntry]:
        out: List[QuotaEntry] = []
        for store in self.partitions:
            out.extend(store.quotas())
        return out

    # ------------------------------------- cross-partition invariants
    def check_user_quota(self, user: str, n_new: int) -> Optional[str]:
        """The cross-partition per-user quota gate (docs/DEPLOY.md): a
        finite ``count`` quota on the reserved pool ``"*"`` caps the
        user's TOTAL footprint (pending + running) across every
        partition.  Enforcement reads the summary exchange — bounded
        staleness, never job state — so a user at quota on partitions
        {0,1} is refused on BOTH, by whichever REST node asks.  Returns
        None when allowed, else the refusal message."""
        quota = self.get_quota(user, GLOBAL_POOL)
        cap = quota.get("count", float("inf"))
        if cap == float("inf"):
            return None
        totals = self.summaries.user_totals(user)
        have = totals["pending"] + totals["running"]
        if have + n_new > cap:
            return (f"global quota exceeded for user {user}: "
                    f"{int(have)} jobs across {self.pmap.count} "
                    f"partition(s) + {n_new} new > count quota "
                    f"{int(cap)} (summary staleness "
                    f"{self.summaries.staleness_s():.3f}s, bound "
                    f"{self.summaries.max_age_s}s)")
        return None

    # ------------------------------------------------------- durability
    def subscribe(self, fn: Callable[[int, List[Any]], None]) -> None:
        for store in self.partitions:
            store.subscribe(fn)

    def ensure_index(self):
        raise NotImplementedError(
            "the columnar index is per-store; the partitioned facade "
            "serves the entity path (configure columnar_index=False "
            "with partitions, or run P=1 compatibility mode)")

    def enable_group_commit(self, window_ms: float = 0.5,
                            max_batch: int = 256) -> bool:
        ok = True
        for store in self.partitions:
            ok = store.enable_group_commit(
                window_ms=window_ms, max_batch=max_batch) and ok
        return ok

    def disable_group_commit(self) -> None:
        for store in self.partitions:
            store.disable_group_commit()

    def group_commit_stats(self) -> Optional[Dict[str, Any]]:
        per = [store.group_commit_stats() for store in self.partitions]
        live = [s for s in per if s is not None]
        if not live:
            return None
        return {
            "pending": sum(s["pending"] for s in live),
            "batches": sum(s["batches"] for s in live),
            "commits": sum(s["commits"] for s in live),
            "indeterminate": sum(s["indeterminate"] for s in live),
            "max_batch": max(s["max_batch"] for s in live),
            "window_ms": live[0]["window_ms"],
            "per_partition": per,
        }

    def commit_offset(self) -> int:
        """Total journaled bytes across partitions — a LIVENESS datum
        (is anything journaled / did it advance), NEVER a position to
        compare offsets against: per-partition positions live in the
        commit-token vector (each partition is its own offset space)."""
        return sum(store.commit_offset() for store in self.partitions)

    def commit_token(self) -> str:
        """The partition-qualified token VECTOR: each journaled
        partition's ``p<i>:<epoch>:<offset>`` position, comma-joined.
        Write responses carry the vector (cheap at small P) so a client
        holds read-your-writes over every partition it may have
        touched; the follower wait-gate satisfies entries per
        partition.  Partitions with zero journaled bytes are omitted —
        there is nothing to read behind them, and their entry would
        force a single-partition follower to redirect for no reason."""
        return ",".join(store.commit_token()
                        for store in self.partitions
                        if store.commit_offset() > 0)

    def flush_audit(self) -> int:
        return sum(store.flush_audit() for store in self.partitions)

    def checkpoint(self) -> None:
        for store in self.partitions:
            store.checkpoint()

    def partition_stats(self) -> List[Dict[str, Any]]:
        """Per-partition observability block (/debug/replication
        ``partitions``, the monitor's labeled gauges): journal head,
        epoch, group-commit stage state, declared pools."""
        declared: Dict[int, List[str]] = {}
        for pool, idx in self.pmap.pools.items():
            declared.setdefault(idx, []).append(pool)
        out = []
        for i, store in enumerate(self.partitions):
            out.append({
                "partition": f"p{i}",
                "journal_bytes": store.commit_offset(),
                "epoch": store._journal_epoch,
                "group_commit": store.group_commit_stats(),
                "declared_pools": sorted(declared.get(i, [])),
            })
        return out

    def close(self) -> None:
        for store in self.partitions:
            store.close()


def substores(store) -> List[Store]:
    """The physical shards behind ``store``: the partition list of a
    :class:`PartitionedStore`, else the store itself — the one idiom
    for call sites that iterate raw entity tables under the store lock
    (they must take each partition's lock in turn, never nested)."""
    return list(getattr(store, "partitions", None) or [store])


class PartitionedReadView:
    """A standby's live read plane over P mirrored partition dirs: one
    :class:`~.read_replica.FollowerReadView` per partition, a
    :class:`PartitionedStore` facade over the per-partition view stores
    for merged GETs, and the per-partition token wait-gate.

    The facade is REBUILT on any member view's store swap (mirror
    re-base) — ``on_swap`` subscribers get the fresh facade, exactly
    like the single-view contract."""

    def __init__(self, directory: str, pmap: PartitionMap,
                 interval_s: float = 0.02,
                 on_swap: Optional[Callable[[Any], None]] = None,
                 start: bool = True):
        from .read_replica import FollowerReadView
        self.directory = str(directory)
        self.pmap = pmap
        self._on_swap: List[Callable[[Any], None]] = []
        if on_swap is not None:
            self._on_swap.append(on_swap)
        self.views = [
            FollowerReadView(os.path.join(directory, f"p{i}"),
                             interval_s=interval_s, start=start,
                             partition_id=i)
            for i in range(pmap.count)]
        self.store = self._build_facade()
        for view in self.views:
            view.on_swap(self._member_swapped)

    def _build_facade(self) -> PartitionedStore:
        # each member view's replica store was born with its partition
        # id (FollowerReadView(partition_id=...)), so routing and lock
        # families stay coherent through rebuilds
        return PartitionedStore(
            [view.store for view in self.views], self.pmap)

    def _member_swapped(self, _store) -> None:
        self.store = self._build_facade()
        for fn in self._on_swap:
            fn(self.store)

    def on_swap(self, fn: Callable[[Any], None]) -> None:
        self._on_swap.append(fn)
        fn(self.store)

    # ------------------------------------------------------- staleness
    @property
    def offset(self) -> int:
        return sum(view.offset for view in self.views)

    def lag_bytes(self) -> int:
        return sum(view.lag_bytes() for view in self.views)

    def age_ms(self) -> float:
        return max(view.age_ms() for view in self.views)

    def stats(self) -> Dict[str, Any]:
        return {
            "offset": self.offset,
            "lag_bytes": self.lag_bytes(),
            "age_ms": round(self.age_ms(), 1),
            "applied_records": sum(v.applied_records
                                   for v in self.views),
            "rebuilds": sum(v.rebuilds for v in self.views),
            "partitions": [dict(v.stats(), partition=f"p{i}")
                           for i, v in enumerate(self.views)],
        }

    # ------------------------------------------------- token wait-gate
    def wait_commit_token(self, token: str, timeout_s: float = 1.0
                          ) -> bool:
        """Satisfy a commit-token VECTOR per partition: each
        ``(partition, epoch, offset)`` entry waits against the mirror
        of THAT partition (legacy partitionless entries can only be
        satisfied by a partitionless view — redirect).  False on any
        unsatisfied entry (caller redirects to the leader)."""
        entries = parse_token_vector(token)
        deadline = time.monotonic() + max(timeout_s, 0.0)
        for part, ep, off in entries:
            if part is None or not 0 <= part < len(self.views):
                return False
            remaining = max(deadline - time.monotonic(), 0.0)
            if not self.views[part].wait_token(ep, off,
                                               timeout_s=remaining):
                return False
        return True

    def wait_token(self, epoch: Optional[int], offset: int,
                   timeout_s: float = 1.0) -> bool:
        """Legacy single-entry gate: a partitionless token cannot name
        which partition's offset space it lives in — unsatisfiable
        here (the leader is the only safe server for it)."""
        return False

    def stop(self) -> None:
        for view in self.views:
            view.stop()
