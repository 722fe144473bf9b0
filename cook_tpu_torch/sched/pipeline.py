"""The port of ``cook_tpu/sched/pipeline.py``: pipelined optimistic match
cycles, overlapping the card's cycle with the host's apply (the Omega
shape — Schwarzkopf et al., EuroSys'13 — over the fused cycle).

The synchronous driver (sched/fused.py) serializes every cycle:
pack -> upload -> dispatch -> fetch -> transactional launch, and the card
sits idle while the host runs the launch path.

One :meth:`PipelinedCycleDriver.step` at depth 2:

1. **fetch** the in-flight cycle *k* — its compact outputs have been
   copying device->host into pinned memory since last step, behind an
   event (``FusedCycleDriver.dispatch_group``), so the wait is on that
   event alone;
2. **stage + dispatch** cycle *k+1* against the store snapshot — which is
   *optimistically stale*: cycle *k*'s launches haven't been applied yet.
   Two host-side corrections keep the speculation coherent
   (``FusedCycleDriver.stage`` hooks):

   - cycle *k*'s fetched launch candidates are masked out of *k+1*'s
     ``launch_ok`` (back-to-back cycles must not fight over the head of
     the queue), and
   - the resources those candidates will consume are subtracted from
     *k+1*'s staged offer availability, so speculative placements stay
     feasible;

3. **apply** cycle *k* — the guard transaction and backend launch calls
   run on the host *while the card computes k+1*.  Before launching, an
   Omega-style **reconciliation** (``fused.reconcile`` span) re-validates
   every candidate against the live store: a candidate whose job is no
   longer WAITING is dropped — never double-launched — and pruned from
   the published queue; a candidate whose host availability was consumed
   by an untracked overlapped launch falls back to unmatched and retries
   next cycle.  Drops are counted (``conflicts_state``,
   ``conflicts_resources``, ``cook_pipeline_conflicts_total``).

The store's transactional launch guard remains the hard backstop
underneath: even a reconciliation bug cannot double-launch.

Nothing here synchronizes the card: the overlap comes from the card's
asynchrony alone.  ``pipeline.depth = 0`` never constructs this class.
Depths above 2 add speculation: intermediate cycles are dispatched before
their predecessors are fetched, so their candidates can't be masked and
the conflict-drop rate rises.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import PipelineConfig
from ..state.schema import Job, JobState
from ..utils import tracing
from ..utils.flight import recorder as _flight
from ..utils.metrics import registry
from .fused import F32, FusedCycleDriver, _GroupDispatch, _StagedCycle
from .matcher import MatchCycleResult


class _InFlight:
    """One optimistic cycle between dispatch and apply."""

    __slots__ = ("id", "staged", "dispatches", "fetched", "exclude",
                 "consumed", "tokens_spent", "delta", "knows", "staged_tx")

    def __init__(self, id_: int, staged: _StagedCycle,
                 dispatches: List[_GroupDispatch], staged_tx: int = -1):
        self.id = id_
        self.staged = staged
        self.dispatches = dispatches
        self.staged_tx = staged_tx
        self.fetched = False
        # computed at fetch: per-pool candidate footprint for masking the
        # NEXT stage -- pool name -> ("rows"|"uuids", epoch, ids) -- and
        # the per-host resources those candidates will consume
        self.exclude: Dict[str, tuple] = {}
        self.consumed: Dict[tuple, np.ndarray] = {}
        # pool name -> user -> launch-rate tokens this entry's assigned
        # candidates will spend (one per launch); subtracted from the
        # NEXT stage's staged token budgets so overlapped cycles cannot
        # hand the same user depth-x the configured per-cycle rate
        self.tokens_spent: Dict[str, Dict[str, float]] = {}
        # per-host overdraft this cycle's staged avail did NOT see:
        # launches applied after this cycle staged by entries whose
        # candidates were not already subtracted at stage time
        self.delta: Dict[tuple, np.ndarray] = {}
        # ids of in-flight entries whose candidate footprint WAS
        # subtracted from this entry's staged avail (no double charge)
        self.knows: set = set()


class PipelinedCycleDriver:
    """Drives FusedCycleDriver's stage/dispatch/fetch/apply phases as a
    depth-k pipeline.  ``step(scheduler)`` has the same signature and
    return contract as ``FusedCycleDriver.step``; the first call behaves
    like the sync driver (stage, dispatch, fetch, apply the same cycle)
    and additionally leaves the next cycle's dispatch in flight."""

    def __init__(self, fused: FusedCycleDriver,
                 config: Optional[PipelineConfig] = None):
        self.fused = fused
        self.config = config or PipelineConfig()
        self.depth = max(1, self.config.depth)
        self._inflight: "deque[_InFlight]" = deque()
        self._ids = itertools.count(1)
        # lifetime conflict counters
        self.conflicts_state = 0
        self.conflicts_resources = 0

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Drop all in-flight speculation (a failed cycle, leader
        handoff).  Safe: an unapplied dispatch has transacted nothing —
        its candidates are still WAITING and re-enter the next cycle."""
        self._inflight.clear()

    def inflight(self) -> int:
        return len(self._inflight)

    # ------------------------------------------------------------------ step
    def step(self, scheduler) -> Tuple[Dict[str, List[Job]],
                                       Dict[str, MatchCycleResult]]:
        registry.gauge_set("cook_pipeline_depth", float(self.depth))
        if not self._inflight:
            entry = self._stage_dispatch(scheduler)
            self._inflight.append(entry)
        head = self._inflight[0]
        self._fetch(head)
        # keep depth-1 speculative dispatches in flight while the head's
        # launches are applied below: the card computes cycle k+1 while
        # the host transacts cycle k
        while len(self._inflight) < self.depth:
            self._inflight.append(self._stage_dispatch(
                scheduler, after=[e for e in self._inflight if e.fetched]))
        _flight.note_pipeline(self.depth, len(self._inflight) - 1)
        self._inflight.popleft()
        queues, results = self._apply(scheduler, head)
        launched = sum(len(r.launched_task_ids) for r in results.values())
        if launched == 0 and self._inflight \
                and self._store_tx() != head.staged_tx:
            # Empty-head promotion: the speculative head predated a store
            # mutation and produced nothing — but the next in-flight
            # cycle was staged THIS step from the current store and is
            # already computing.  Apply it now instead of idling a whole
            # cadence tick: an unproductive pipeline has nothing to hide,
            # so the extra fetch costs what the sync driver always paid.
            nxt = self._inflight.popleft()
            self._fetch(nxt)
            q2, r2 = self._apply(scheduler, nxt)
            queues.update(q2)
            results.update(r2)
            while len(self._inflight) < self.depth - 1:
                self._inflight.append(self._stage_dispatch(
                    scheduler,
                    after=[e for e in self._inflight if e.fetched]))
        return queues, results

    def _store_tx(self) -> int:
        return getattr(self.fused.store, "_tx_id", -1)

    # ----------------------------------------------------------------- stage
    def _stage_dispatch(self, scheduler,
                        after: Optional[List[_InFlight]] = None) -> _InFlight:
        """Stage a cycle off the current store, masked by the candidate
        footprints of every fetched-but-unapplied entry in ``after``, and
        dispatch all its groups (the output copies start rolling)."""
        exclude: Dict[str, tuple] = {}
        avail_delta: Dict[tuple, np.ndarray] = {}
        token_delta: Dict[str, Dict[str, float]] = {}
        knows = set()
        for e in after or []:
            knows.add(e.id)
            # per-pool MERGE (a plain update would keep only the last
            # entry's mask when several fetched entries cover one pool)
            for pool_name, (kind, epoch, ids) in e.exclude.items():
                cur = exclude.get(pool_name)
                if cur is None:
                    exclude[pool_name] = (kind, epoch, ids)
                elif cur[0] == kind == "rows" and cur[1] == epoch:
                    exclude[pool_name] = (
                        "rows", epoch, np.union1d(cur[2], ids))
                elif cur[0] == kind == "uuids":
                    exclude[pool_name] = ("uuids", -1, cur[2] | ids)
                # mixed kinds / mismatched epochs: keep the newer mask
                # (reconciliation absorbs the unmasked remainder)
                else:
                    exclude[pool_name] = (kind, epoch, ids)
            for key, vec in e.consumed.items():
                cur = avail_delta.get(key)
                avail_delta[key] = vec if cur is None else cur + vec
            for pool_name, spent in e.tokens_spent.items():
                cur_pool = token_delta.setdefault(pool_name, {})
                for user, n in spent.items():
                    cur_pool[user] = cur_pool.get(user, 0.0) + n
        staged_tx = self._store_tx()
        staged = self.fused.stage(scheduler, exclude=exclude or None,
                                  avail_delta=avail_delta or None,
                                  token_delta=token_delta or None)
        dispatches = []
        for sg in staged.groups:
            with tracing.span("cycle.match", pools=len(sg.group),
                              tasks=sg.T, hosts=sg.H, gpu=sg.gpu_mode):
                dispatches.append(self.fused.dispatch_group(sg))
        entry = _InFlight(next(self._ids), staged, dispatches,
                          staged_tx=staged_tx)
        entry.knows = knows
        return entry

    # ----------------------------------------------------------------- fetch
    def _fetch(self, entry: _InFlight) -> None:
        if entry.fetched:
            return
        for gd in entry.dispatches:
            with tracing.span("cycle.match", pools=len(gd.sg.group),
                              tasks=gd.sg.T, hosts=gd.sg.H,
                              gpu=gd.sg.gpu_mode):
                self.fused.fetch_group(gd)
        entry.fetched = True
        self._candidate_footprint(entry)

    def _candidate_footprint(self, entry: _InFlight) -> None:
        """From the fetched outputs, the footprint the NEXT stage must
        speculate around: which queue rows (columnar pack) or job uuids
        (entity pack) are about to launch, and how much of each host
        they will consume.

        A PARTIAL gang among the candidates will be reset by the
        all-or-nothing reduction at apply — it launches nothing — so
        masking its members out of the next stage would let the two
        in-flight cycles hold complementary halves of the gang forever.
        Only COMPLETE gang cohorts enter the exclusion/consumption
        footprint."""
        for gd in entry.dispatches:
            cand_row, cand_assign, _qpos, _nq = gd.fetched[:4]
            for i, pp in enumerate(gd.sg.group):
                sel = np.flatnonzero((cand_row[i] >= 0)
                                     & (cand_assign[i] >= 0))
                if not len(sel):
                    continue
                hosts = cand_assign[i][sel].astype(np.int64)
                # clip padding hosts defensively (mirrors _apply_pool)
                ok = hosts < len(pp.offers)
                sel, hosts = sel[ok], hosts[ok]
                if not len(sel):
                    continue
                if pp.columnar:
                    rows = pp.rows_s[cand_row[i][sel]]
                    uuids = [str(u) for u in pp.uuid_base[rows]]
                    keep = self._whole_gang_mask(pp, uuids)
                    sel, hosts, rows = sel[keep], hosts[keep], rows[keep]
                    if not len(sel):
                        continue
                    entry.exclude[pp.pool.name] = (
                        "rows", pp.base_compactions, rows)
                    res = np.concatenate(
                        [pp.res_base[rows][:, :3],
                         pp.disk_base[rows][:, None]], axis=1).astype(F32)
                    users = [str(u) for u in pp.user_base[rows]]
                else:
                    jobs = [pp.id2job[pp.task_ids[r]]
                            for r in cand_row[i][sel]]
                    keep = self._whole_gang_mask(
                        pp, [j.uuid for j in jobs])
                    sel, hosts = sel[keep], hosts[keep]
                    jobs = [j for j, k in zip(jobs, keep) if k]
                    if not len(sel):
                        continue
                    entry.exclude[pp.pool.name] = (
                        "uuids", -1, frozenset(j.uuid for j in jobs))
                    res = np.array(
                        [[j.resources.cpus, j.resources.mem,
                          j.resources.gpus, j.resources.disk]
                         for j in jobs], dtype=F32)
                    users = [j.user for j in jobs]
                spent = entry.tokens_spent.setdefault(pp.pool.name, {})
                for user in users:
                    spent[user] = spent.get(user, 0.0) + 1.0
                for j, h in enumerate(hosts):
                    o = pp.offers[int(h)]
                    key = (o.cluster, o.hostname)
                    cur = entry.consumed.get(key)
                    entry.consumed[key] = (res[j] if cur is None
                                           else cur + res[j])

    def _whole_gang_mask(self, pp, uuids) -> np.ndarray:
        """bool mask over assigned candidates keeping non-gang jobs and
        COMPLETE gang cohorts; members of partial cohorts are dropped
        from the speculation footprint (they cannot launch — the
        reduction resets them at apply).  Membership is derived from the
        pack context's gang groups, so the mask never reads the store."""
        n = len(uuids)
        keep = np.ones(n, dtype=bool)
        groups = getattr(pp.ctx, "groups", None) if pp.ctx else None
        if not groups:
            return keep
        gang_of: Dict[str, str] = {}
        for guuid, g in groups.items():
            if getattr(g, "gang", False):
                for member_uuid in getattr(g, "jobs", None) or ():
                    gang_of[member_uuid] = guuid
        if not gang_of:
            return keep
        counts: Dict[str, int] = {}
        member_gang = [gang_of.get(u) for u in uuids]
        for guuid in member_gang:
            if guuid is not None:
                counts[guuid] = counts.get(guuid, 0) + 1
        partial = {guuid for guuid, c in counts.items()
                   if c < int(getattr(groups[guuid], "gang_size", 0) or 0)}
        if partial:
            for i, guuid in enumerate(member_gang):
                if guuid in partial:
                    keep[i] = False
        return keep

    # ----------------------------------------------------------------- apply
    def _apply(self, scheduler, entry: _InFlight
               ) -> Tuple[Dict[str, List[Job]], Dict[str, MatchCycleResult]]:
        queues: Dict[str, List[Job]] = {p.name: []
                                        for p in entry.staged.pools}
        results: Dict[str, MatchCycleResult] = {}
        reconciler = self._make_reconciler(entry)
        for gd in entry.dispatches:
            self.fused.apply_group(scheduler, gd, queues, results,
                                   reconciler=reconciler)
        # propagate this entry's ACTUAL launch consumption to in-flight
        # entries that did not already subtract its candidate footprint
        # at stage time (depth > 2, or a stage that raced this apply)
        consumed: Dict[tuple, np.ndarray] = {}
        for result in results.values():
            launched = set(result.launched_job_uuids)
            for job, offer in result.matched:
                if job.uuid not in launched:
                    continue
                vec = np.array([job.resources.cpus, job.resources.mem,
                                job.resources.gpus, job.resources.disk],
                               dtype=F32)
                key = (offer.cluster, offer.hostname)
                cur = consumed.get(key)
                consumed[key] = vec if cur is None else cur + vec
        if consumed:
            for other in self._inflight:
                if entry.id in other.knows:
                    continue  # footprint already subtracted at stage
                for key, vec in consumed.items():
                    cur = other.delta.get(key)
                    other.delta[key] = vec if cur is None else cur + vec
        return queues, results

    def _make_reconciler(self, entry: _InFlight):
        """The pre-launch re-validation hook handed to _apply_pool: state
        check against the live store + per-host feasibility against the
        overdraft this entry's staged avail never saw."""

        def reconcile(pp, cand_jobs, cand_host):
            n = len(cand_jobs)
            state_drop = np.zeros(n, dtype=bool)
            res_drop = np.zeros(n, dtype=bool)
            # state: still WAITING?  (columnar candidates were just
            # refetched by _apply_pool's jobs_bulk, so this is current;
            # the entity pack's candidates are stale clones — refetch)
            fresh = cand_jobs if pp.columnar else \
                self.fused.store.jobs_bulk([j.uuid for j in cand_jobs])
            for i, job in enumerate(fresh):
                if job is None or job.state is not JobState.WAITING:
                    state_drop[i] = True
            # resources: replay the kernel's placements against the
            # staged availability minus the untracked overdraft; slots
            # are in admission order, so the drop is deterministic
            if entry.delta and pp.offers:
                H = len(pp.offers)
                over = np.zeros((H, 4), dtype=F32)
                hit = False
                for h, o in enumerate(pp.offers):
                    d = entry.delta.get((o.cluster, o.hostname))
                    if d is not None:
                        over[h] = d
                        hit = True
                if hit:
                    headroom = np.maximum(
                        pp.avail[:H].astype(np.float64) - over, 0.0)
                    # the gang pass's rescue/refill re-places against
                    # availability too — hand it the same overdraft-
                    # adjusted view or it can refill a host this very
                    # reconcile just protected
                    pp.avail_headroom = headroom.astype(F32)
                    used = np.zeros((H, 4), dtype=np.float64)
                    for i, job in enumerate(cand_jobs):
                        h = int(cand_host[i])
                        if h < 0 or state_drop[i]:
                            continue
                        req = np.array([job.resources.cpus,
                                        job.resources.mem,
                                        job.resources.gpus,
                                        job.resources.disk])
                        if np.any(used[h] + req > headroom[h] + 1e-6):
                            res_drop[i] = True
                        else:
                            used[h] += req
            ns, nr = int(state_drop.sum()), int(res_drop.sum())
            if ns:
                registry.counter_inc("cook_pipeline_conflicts", float(ns),
                                     {"reason": "state"})
                self.conflicts_state += ns
            if nr:
                registry.counter_inc("cook_pipeline_conflicts", float(nr),
                                     {"reason": "resources"})
                self.conflicts_resources += nr
            if ns or nr:
                _flight.note_pipeline_conflicts(ns + nr)
                # per-job attribution of the drops (utils/audit.py)
                from ..utils import audit as _audit
                _audit.note_skips(self.fused.store.audit, {
                    "pipeline-conflict": [
                        (cand_jobs[i].uuid,
                         {"why": "state" if state_drop[i]
                          else "resources"})
                        for i in np.flatnonzero(state_drop | res_drop)],
                }, pool=pp.pool.name)
            return state_drop, res_drop

        return reconcile
