"""The port of ``cook_tpu/sched/matcher.py``: the match cycle, ranked
queue x cluster offers -> launched tasks.

Host half of the reference's match path (reference: handle-fenzo-pool
scheduler.clj:1554, handle-resource-offers! :1339, launch-matched-tasks!
:1028) around the batched match kernels:

  considerable selection (quota filter + cap)  -> constraint mask compile
  -> kernel dispatch (greedy / auction / cpu)  -> within-batch group check
  -> transactional launch guard                -> cluster launch under
                                                  kill-lock read side

Head-of-queue fairness backoff is preserved host-side
(scheduler.clj:1613-1651): while the head of the queue can't match, the
number of considerable jobs shrinks so the cheap tail can't starve it.

The device dispatch is the module functions :func:`resolve_backend`,
:func:`dispatch`, :func:`_dispatch_device` and :func:`_run_kernel`
(``Matcher._dispatch`` :604 and below, as plain functions over numpy):
greedy through kernel K5, the auction and the waterfill over K2, on the
``device`` the ``Matcher`` was given.  The reference's ``try/except``
around the device dispatch, which fell back to the host greedy, is not
ported: a failure on the card raises.  ``backend="cpu"`` still runs the
numpy greedy golden, as in the JAX package: that is a backend the caller
chooses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..cluster.base import ComputeCluster, LaunchSpec, Offer
from ..config import Config, MatcherConfig
from ..ops import host_prep, reference_impl
from ..ops import telemetry
from ..ops.match import (MatchInputs, auction_match_kernel,
                         greedy_match_kernel, waterfill_match_kernel)
from ..state.schema import InstanceStatus, Job, Reasons, new_uuid
from ..state.store import Store
from ..utils import audit, tracing
from ..utils.metrics import LATENCY_BUCKETS, registry
from .constraints import (
    LOCATION_ATTRIBUTE,
    ConstraintContext,
    build_constraint_mask,
    validate_group_placement,
)

F32 = np.float32


@dataclass
class MatchCycleResult:
    considered: int = 0
    matched: List[Tuple[Job, Offer]] = field(default_factory=list)
    launched_task_ids: List[str] = field(default_factory=list)
    launched_job_uuids: List[str] = field(default_factory=list)
    unmatched: List[Job] = field(default_factory=list)
    head_matched: bool = True
    launch_failures: List[Tuple[str, str]] = field(default_factory=list)
    # True when the producer already removed this cycle's launches from the
    # pool's pending queue (the fused driver prunes by exact queue position;
    # the scheduler's generic isin-based prune then skips the pool)
    queue_pruned: bool = False
    # gang group uuid -> {"size", "matched", "missing",
    # "topology_blocked"} for gangs that could not place whole this
    # cycle (ops/gang.py; feeds the unscheduled explainer's
    # "waiting on N gang members" reason, docs/GANG.md)
    gang_partial: Dict[str, Dict] = field(default_factory=dict)


class _BackoffState:
    """Per-pool num-considerable backoff (scheduler.clj:1613-1651)."""

    def __init__(self, cap: int):
        self.num_considerable = cap
        self.floor_iterations = 0

    def update(self, mc: MatcherConfig, head_matched: bool) -> None:
        if head_matched:
            self.num_considerable = mc.max_jobs_considered
            self.floor_iterations = 0
        else:
            shrunk = int(self.num_considerable * mc.scaleback)
            self.num_considerable = max(1, shrunk)
            if self.num_considerable == 1:
                self.floor_iterations += 1
                if self.floor_iterations >= mc.floor_iterations_before_reset:
                    self.num_considerable = mc.max_jobs_considered
                    self.floor_iterations = 0


class Matcher:
    def __init__(self, store: Store, config: Config, plugins=None,
                 rate_limits=None, device="cuda"):
        from ..policy import PluginRegistry, RateLimits
        self.store = store
        self.config = config
        # the device the split path's kernels run on
        self.device = resolve_device(device)
        self.plugins = plugins or PluginRegistry()
        self.rate_limits = rate_limits or RateLimits()
        self._backoff: Dict[str, _BackoffState] = {}
        # pool -> {group uuid -> {"size", "reason"}} for gangs deferred at
        # ADMISSION (before any match ran): the unscheduled-jobs explainer
        # reads this — such gangs never reach the match pass, so they have
        # no gang_partial entry to explain them
        self.last_admission_deferred: Dict[str, Dict[str, Dict]] = {}
        # elastic resize plane (sched/elastic.ElasticManager, set by the
        # scheduler): meters grow admissions of satisfied elastic gangs
        # by the optimizer's per-pool budget.  None = unmetered growth.
        self.elastic = None
        # adaptive-admission controller (sched/admission.py, set by the
        # scheduler): its 0-1 level also scales the considerable window,
        # so a browned-out cell stops paying full-queue match work.
        # None = no admission throttle.
        self.admission = None

    def admission_limit(self, pool_name: str, ranked: List[Job],
                        limit: int) -> int:
        """Scale the considerable window by the admission level and
        attribute the cut (bounded by the window, never [T]-sized) as
        ``admission-throttled`` skips — `cs why` answers "why is my job
        waiting" during brownout from the same audit lane as every
        other throttle."""
        ctrl = self.admission
        if ctrl is None or ctrl.level >= 1.0 or limit <= 1:
            return limit
        scaled = max(1, int(limit * ctrl.level))
        if scaled < limit:
            cut = ranked[scaled:limit]
            if cut:
                from ..utils import audit as _audit
                _audit.note_skips(self.store.audit, {
                    "admission-throttled": [
                        (j.uuid, {"level": round(ctrl.level, 3),
                                  "stage": ctrl.stage})
                        for j in cut]}, pool=pool_name)
        return scaled

    # ------------------------------------------------------------ selection
    def considerable_jobs(self, pool_name: str, ranked: List[Job],
                          limit: int) -> List[Job]:
        """Quota-filtered prefix of the ranked queue (reference:
        pending-jobs->considerable-jobs scheduler.clj:729: usage of running
        jobs + jobs earlier in the queue must stay below the user's quota;
        the accumulator includes skipped jobs, tools.clj:899-915)."""
        if limit <= 0:
            return []
        from ..policy import pool_user_key
        launch_rl = self.rate_limits.job_launch
        usage: Dict[str, np.ndarray] = {}
        for job, _inst in self.store.running_instances(pool_name):
            u = usage.setdefault(job.user, np.zeros(4, dtype=F32))
            u += [job.resources.cpus, job.resources.mem, job.resources.gpus, 1.0]
        out: List[Job] = []
        user_tokens: Dict[str, float] = {}
        user_seen: Dict[str, int] = {}
        # gang-cohort admission (docs/GANG.md): an all-or-nothing gang
        # whose members cannot ALL clear this cycle's throttles would
        # otherwise admit a partial cohort every cycle — matched, then
        # reset by the reduction, forever.  A gang's FIRST member decides
        # for the whole cohort: enough rate-limit tokens for the cohort
        # size and enough room under the considerable cap, or every
        # member waits this cycle (tokens refill; the cap resets).
        # ELASTIC gangs (docs/GANG.md elasticity) reserve only gang_min
        # — members beyond the cohort admit as surplus SINGLES, and a
        # gang already running at >= min (admission size 0) routes its
        # waiting members straight to the grow path below.
        gang_size_of: Dict[str, int] = {}
        gang_deferred: set = set()
        gang_reserved: set = set()
        # groups whose cohort reservation was fully consumed: later
        # members of the same (elastic) gang are surplus singles
        gang_cohort_done: set = set()
        if self.elastic is not None:
            self.elastic.start_pool_cycle(pool_name)
        # outstanding considerable-cap slots held for admitted gangs whose
        # later members have not been reached yet (group -> remaining);
        # singles must not eat a sibling's slot mid-cohort
        slots_reserved: Dict[str, int] = {}
        # a gang whose full cohort is not even in this cycle's ranked
        # queue (a member completed, or was ranked out) can never fully
        # admit — defer it outright instead of reserving slots it will
        # strand for the rest of the scan
        ranked_members: Dict[str, int] = {}
        for job in ranked:
            if job.group is not None:
                ranked_members[job.group] = \
                    ranked_members.get(job.group, 0) + 1
        # head-of-line skip reasons for the cycle's flight record AND the
        # per-job audit lanes: reason -> [uuid | (uuid, extra)], so the
        # aggregate histogram and the per-job attribution come from ONE
        # structure (utils/audit.note_skips; attribution parity)
        skips: Dict[str, List] = {}

        def _skip(reason: str, job, **extra) -> None:
            skips.setdefault(reason, []).append(
                (job.uuid, extra) if extra else job.uuid)
        # group uuid -> why the cohort was withheld, for the explainer
        deferred_why: Dict[str, Dict] = {}

        def _defer(group: str, reason: str) -> None:
            gang_deferred.add(group)
            deferred_why.setdefault(group, {
                "size": gang_size_of.get(group, 0), "reason": reason})

        def _sink_cohort(job, cohort: int, reason: str) -> None:
            """A member denial sinks its whole cohort: defer the gang,
            release its token/slot reservation (nothing from it launches,
            so a later same-user single may use them), and strip
            already-admitted siblings."""
            _defer(job.group, reason)
            slots_reserved.pop(job.group, None)
            if launch_rl.enforce and job.group in gang_reserved:
                user_seen[job.user] = max(
                    user_seen.get(job.user, 0) - cohort, 0)
            stripped = [j for j in out if j.group == job.group]
            if stripped:
                out[:] = [j for j in out if j.group != job.group]
                for j in stripped:
                    _skip("gang-deferred", j, why=reason)

        # group uuid -> is-a-gang, for the grow path (admission size 0
        # covers both plain groups and SATISFIED elastic gangs; only the
        # latter are metered by the optimizer's grow budget)
        gang_flag: Dict[str, bool] = {}
        # growth headroom left per elastic gang this cycle (gang_max -
        # live - the cohort reserved here): surplus singles and grow
        # members consume it so a gang never admits past its declared
        # maximum (docs/GANG.md elasticity)
        gang_headroom: Dict[str, float] = {}

        def _growth_headroom(group: str) -> float:
            h = gang_headroom.get(group)
            if h is None:
                h = self.store.gang_growth_headroom(group) \
                    - gang_size_of.get(group, 0)
                gang_headroom[group] = h = max(h, 0.0)
            return h

        for job in ranked:
            cohort = 1
            if job.group is not None:
                size = gang_size_of.get(job.group)
                if size is None:
                    # cohort size the admission must reserve: gang_size
                    # for rigid gangs, gang_min for unsatisfied elastic
                    # ones, 0 once an elastic gang runs satisfied (its
                    # members grow like singles, docs/GANG.md)
                    size = self.store.gang_admission_size(job.group)
                    gang_size_of[job.group] = size
                if size:
                    if job.group not in gang_deferred \
                            and ranked_members.get(job.group, 0) < size:
                        _defer(job.group, "members-missing")
                    if job.group in gang_deferred:
                        _skip("gang-deferred", job)
                        continue
                    if job.group in gang_cohort_done:
                        # elastic surplus single beyond the cohort:
                        # capped by the gang's growth headroom
                        if _growth_headroom(job.group) < 1:
                            _skip("gang-at-max", job)
                            continue
                        gang_headroom[job.group] -= 1
                        cohort = 1
                    else:
                        cohort = size
                else:
                    is_gang = gang_flag.get(job.group)
                    if is_gang is None:
                        is_gang = self.store.group_is_gang(job.group)
                        gang_flag[job.group] = is_gang
                    if is_gang:
                        # satisfied elastic gang: the member grows like
                        # a single — capped at gang_max, then metered
                        # by the optimizer's per-pool grow budget
                        if _growth_headroom(job.group) < 1:
                            _skip("gang-at-max", job)
                            continue
                        if self.elastic is not None \
                                and not self.elastic.admit_grow(pool_name):
                            _skip("gang-grow-deferred", job)
                            continue
                        gang_headroom[job.group] -= 1
            quota = self.store.get_quota(job.user, pool_name)
            qvec = np.array([quota.get("cpus", np.inf), quota.get("mem", np.inf),
                             quota.get("gpus", np.inf), quota.get("count", np.inf)],
                            dtype=F32)
            u = usage.setdefault(job.user, np.zeros(4, dtype=F32))
            u += [job.resources.cpus, job.resources.mem, job.resources.gpus, 1.0]
            if not np.all(u <= qvec):
                _skip("over-quota", job)
                if cohort > 1:
                    _sink_cohort(job, cohort, "member-denied")
                continue
            # gang cohort reservation: the FIRST member clears both the
            # considerable cap and the per-user launch-rate tokens for the
            # WHOLE cohort and reserves them (reference:
            # filter-pending-jobs-for-ratelimit tools.clj:940-970, extended
            # to cohorts); siblings ride the reservation with no per-member
            # check.  A gang straddling either budget defers whole —
            # admitting partial would match, then burn on the reduction
            # every cycle.
            if cohort > 1 and job.group not in gang_reserved:
                if len(out) + sum(slots_reserved.values()) + cohort > limit:
                    _defer(job.group, "considerable-cap")
                    _skip("gang-deferred", job, why="considerable-cap")
                    continue
                if launch_rl.enforce:
                    tokens = user_tokens.setdefault(
                        job.user,
                        launch_rl.get_token_count(
                            pool_user_key(pool_name, job.user)))
                    seen = user_seen.get(job.user, 0)
                    if seen + cohort > int(tokens):
                        _defer(job.group, "rate-limited")
                        _skip("gang-deferred", job, why="rate-limited")
                        continue
                    user_seen[job.user] = seen + cohort
                gang_reserved.add(job.group)
                slots_reserved[job.group] = cohort
            elif cohort == 1:
                # per-user-per-pool launch rate limit: each user passes at
                # most token-count jobs per cycle; the accumulator includes
                # skipped jobs
                if launch_rl.enforce:
                    tokens = user_tokens.setdefault(
                        job.user,
                        launch_rl.get_token_count(
                            pool_user_key(pool_name, job.user)))
                    seen = user_seen.get(job.user, 0)
                    user_seen[job.user] = seen + 1
                    if seen >= int(tokens):
                        # a fractional token is not a launch
                        _skip("rate-limited", job)
                        continue
                # singles fill remaining slots but never the ones held
                # for a reserved gang's unseen members
                if slots_reserved and \
                        len(out) + sum(slots_reserved.values()) >= limit:
                    _skip("cap-reserved", job)
                    continue
            # launch-filter plugin with cached accept/defer verdicts
            if not self.plugins.launch_allowed(job):
                _skip("launch-filtered", job)
                if cohort > 1:
                    _sink_cohort(job, cohort, "member-denied")
                continue
            out.append(job)
            if cohort > 1:
                rem = slots_reserved.get(job.group, 0) - 1
                if rem > 0:
                    slots_reserved[job.group] = rem
                else:
                    slots_reserved.pop(job.group, None)
                    # an elastic gang's members past the reserved
                    # cohort admit as surplus singles (rigid gangs
                    # never have extra ranked members to reach this)
                    gang_cohort_done.add(job.group)
            if len(out) >= limit:
                break
        # hard cohort guarantee: a gang that did not FULLY admit (a
        # launch filter denied one member, or the cap's break landed
        # mid-cohort behind same-rank fillers) is withheld whole — a
        # partial cohort would match and then be reset by the reduction
        # every cycle, burning capacity forever
        if gang_size_of and any(gang_size_of.values()):
            admitted: Dict[str, int] = {}
            for j in out:
                if j.group is not None and gang_size_of.get(j.group):
                    admitted[j.group] = admitted.get(j.group, 0) + 1
            short = {g for g, n in admitted.items()
                     if n < gang_size_of[g]}
            if short:
                for j in out:
                    if j.group in short:
                        _skip("gang-deferred", j, why="partial-admission")
                out = [j for j in out if j.group not in short]
                for g in short:
                    deferred_why.setdefault(g, {
                        "size": gang_size_of.get(g, 0),
                        "reason": "partial-admission"})
        self.last_admission_deferred[pool_name] = deferred_why
        if skips:
            audit.note_skips(self.store.audit, skips, pool=pool_name)
        return out

    # -------------------------------------------------------------- context
    def _constraint_context(self, jobs: List[Job],
                            reserved_hosts: Optional[Dict[str, str]] = None
                            ) -> ConstraintContext:
        ec = self.config.estimated_completion
        ec_on = (ec.expected_runtime_multiplier is not None
                 and ec.host_lifetime_mins is not None)
        ctx = ConstraintContext(
            reserved_hosts=dict(reserved_hosts or {}),
            max_tasks_per_host=self.config.max_tasks_per_host,
            host_lifetime_mins=ec.host_lifetime_mins if ec_on else None)
        for job in jobs:
            full = self.store.job(job.uuid)
            if full is None:
                continue
            failed = set()
            node_lost_runtimes = [0.0]
            for tid in full.instances:
                inst = self.store.instance(tid)
                if inst is not None and inst.status is InstanceStatus.FAILED:
                    # a launch cancelled before the backend ever saw it
                    # (crash-window refund, reconcile sweep) proves nothing
                    # about the host; novel-host-excluding it would livelock
                    # single-host relaunches after a leader crash.  Same
                    # for a gang-policy sibling kill (gang-member-lost):
                    # the host did nothing wrong and the gang NEEDS it to
                    # relaunch whole (docs/GANG.md)
                    if inst.reason_code not in (
                            Reasons.CANCELLED_DURING_LAUNCH.code,
                            Reasons.GANG_MEMBER_LOST.code):
                        failed.add(inst.hostname)
                    if (inst.reason_code == Reasons.NODE_LOST.code
                            and inst.end_time_ms and inst.start_time_ms):
                        node_lost_runtimes.append(
                            inst.end_time_ms - inst.start_time_ms)
            if failed:
                ctx.failed_hosts[job.uuid] = failed
            # checkpoint locality: a restarted checkpointed job is pinned to
            # the location its previous instance ran in (reference:
            # constraints.clj:218-240); the location was snapshotted from the
            # offer at launch time (Instance.node_location)
            if full.checkpoint is not None:
                for tid in reversed(full.instances):
                    prior = self.store.instance(tid)
                    if prior is not None and prior.node_location:
                        ctx.checkpoint_locations[full.uuid] = \
                            prior.node_location
                        break
            # estimated-completion end time: max of scaled expected runtime
            # and prior node-lost runtimes, capped so a job that nearly fills
            # a host lifetime still accepts young hosts
            # (build-estimated-completion-constraint, constraints.clj:408)
            if ec_on:
                expected = (full.expected_runtime_ms or 0) \
                    * ec.expected_runtime_multiplier
                max_expected = max([expected] + node_lost_runtimes)
                if max_expected > 0:
                    longest = (ec.host_lifetime_mins
                               - ec.agent_start_grace_period_mins) * 60_000
                    ctx.estimated_end_ms[job.uuid] = int(
                        self.store.clock() + min(max_expected, longest))
            if job.group:
                group = self.store.group(job.group)
                if group is not None and job.group not in ctx.groups:
                    ctx.groups[job.group] = group
                    # list, not set: BALANCED frequencies count cotasks per
                    # host with multiplicity
                    hosts = []
                    for member_uuid in group.jobs:
                        member = self.store.job(member_uuid)
                        if member is None:
                            continue
                        for tid in member.instances:
                            inst = self.store.instance(tid)
                            if inst is not None and inst.status in (
                                    InstanceStatus.UNKNOWN, InstanceStatus.RUNNING):
                                hosts.append(inst.hostname)
                    if hosts:
                        ctx.group_running_hosts[job.group] = hosts
        return ctx

    def _fill_cotask_host_attributes(self, ctx: ConstraintContext,
                                     pool_name: str, offers: List[Offer],
                                     clusters: Dict[str, ComputeCluster]
                                     ) -> None:
        """Attribute maps for running-cotask hosts that are NOT in the offer
        set (fully-packed hosts emit no offer): without them, balanced /
        attribute-equals groups would silently ignore those cotasks."""
        needed = {hn for hosts in ctx.group_running_hosts.values()
                  for hn in hosts}
        needed -= {o.hostname for o in offers}
        if not needed:
            return
        for cluster in clusters.values():
            try:
                all_hosts = cluster.hosts(pool_name)
            except Exception:
                continue
            for h in all_hosts:
                if h.hostname in needed:
                    ctx.host_attributes[h.hostname] = h.attributes

    # ----------------------------------------------------------------- match
    def match_pool(self, pool_name: str, ranked: List[Job],
                   offers: List[Offer],
                   clusters: Dict[str, ComputeCluster],
                   reserved_hosts: Optional[Dict[str, str]] = None
                   ) -> MatchCycleResult:
        mc = self.config.matcher_for_pool(pool_name)
        backoff = self._backoff.setdefault(
            pool_name, _BackoffState(mc.max_jobs_considered))
        result = MatchCycleResult()
        limit = self.admission_limit(
            pool_name, ranked, min(backoff.num_considerable,
                                   mc.max_jobs_considered))
        considerable = self.considerable_jobs(pool_name, ranked, limit)
        result.considered = len(considerable)
        # per-job rank attribution for the admitted candidates (bounded
        # by the considerable cap): queue position this cycle + the
        # user's cached DRU (utils/audit.py)
        self.store.audit.ranked(
            [j.uuid for j in considerable], range(len(considerable)),
            pool_name, users=[j.user for j in considerable])
        if not considerable or not offers:
            result.unmatched = considerable
            # an empty cycle leaves the backoff state untouched
            return result

        ctx = self._constraint_context(considerable, reserved_hosts)
        self._fill_cotask_host_attributes(ctx, pool_name, offers, clusters)
        cmask = build_constraint_mask(considerable, offers, ctx)
        job_res = [[j.resources.cpus, j.resources.mem, j.resources.gpus,
                    j.resources.disk] for j in considerable]
        avail = [[o.available.cpus, o.available.mem, o.available.gpus,
                  o.available.disk] for o in offers]
        cap = [[o.capacity.cpus, o.capacity.mem, o.capacity.gpus,
                o.capacity.disk] for o in offers]

        with tracing.span("match.schedule-once", pool=pool_name,
                          backend=self.resolve_backend(mc, len(considerable)),
                          jobs=len(considerable), offers=len(offers)):
            assign = self._dispatch(mc, job_res, cmask, avail, cap)
            assign = validate_group_placement(considerable, assign, offers, ctx)
            # gang all-or-nothing reduction + same-cycle refill of the
            # freed capacity (structural no-op without gang members);
            # satisfied elastic gangs' waiting members bypass the
            # reduction — they are the grow path (docs/GANG.md)
            from ..ops.gang import apply_gang_cycle
            from .elastic import satisfied_gangs
            assign, gstats = apply_gang_cycle(
                considerable, assign, offers, ctx.groups,
                job_res=np.asarray(job_res, dtype=F32),
                cmask_fn=lambda: cmask,
                avail=np.asarray(avail, dtype=F32),
                capacity=np.asarray(cap, dtype=F32),
                device=self.device if mc.backend != "cpu" else False,
                audit_trail=self.store.audit, audit_pool=pool_name,
                satisfied=satisfied_gangs(self.store, ctx.groups))
            if gstats is not None:
                result.gang_partial = gstats.partial
        self.record_placement_failures(considerable, assign, offers, ctx)

        # head-of-queue backoff bookkeeping
        result.head_matched = bool(assign[0] >= 0)
        backoff.update(mc, result.head_matched)

        for j, job in enumerate(considerable):
            h = int(assign[j])
            if h < 0:
                result.unmatched.append(job)
            else:
                result.matched.append((job, offers[h]))
        self._launch(pool_name, result, clusters)
        audit.note_skips(self.store.audit, {
            "unmatched": [j.uuid for j in result.unmatched],
            "launch-failed": [(u, {"why": why})
                              for u, why in result.launch_failures],
        }, pool=pool_name)
        return result

    def record_placement_failures(self, jobs: List[Job], assign: np.ndarray,
                                  offers: List[Offer],
                                  ctx: ConstraintContext) -> None:
        """Persist per-host failure summaries for unmatched jobs the
        explainer put under investigation (reference:
        record-placement-failures! fenzo_utils.clj:75-99)."""
        from .constraints import explain_placement_failure
        for j, job in enumerate(jobs):
            if int(assign[j]) >= 0:
                continue
            fresh = self.store.job(job.uuid)
            if fresh is None or not fresh.under_investigation:
                continue
            summary = explain_placement_failure(job, offers, ctx)
            self.store.set_placement_investigation(
                job.uuid, under_investigation=False, failure=summary)

    @staticmethod
    def resolve_backend(mc: MatcherConfig, num_jobs: int) -> str:
        """Concrete kernel for ``auto`` (:func:`resolve_backend`)."""
        return resolve_backend(mc, num_jobs)

    def _dispatch(self, mc: MatcherConfig, job_res, cmask, avail, cap
                  ) -> np.ndarray:
        """assign i32[J] on the matcher's device (:func:`dispatch`); a
        failure raises."""
        return dispatch(mc, job_res, cmask, avail, cap, device=self.device)

    # ---------------------------------------------------------------- launch
    def _launch(self, pool_name: str, result: MatchCycleResult,
                clusters: Dict[str, ComputeCluster]) -> None:
        """Transactional guard then cluster launch (reference:
        launch-matched-tasks! scheduler.clj:1028: the store transaction
        failing MUST block the backend launch)."""
        from ..policy import pool_user_key
        cluster_rl = self.rate_limits.cluster_launch
        launch_rl = self.rate_limits.job_launch
        cluster_budget: Dict[str, float] = {}
        by_cluster: Dict[str, List[LaunchSpec]] = {}
        entries: List[Dict] = []
        by_task: Dict[str, Tuple[Job, Offer]] = {}
        # gang cohorts launch atomically: every member clears the
        # per-cluster rate limit together or the whole gang waits, and
        # the entries carry the gang uuid so the guard transaction (and
        # the crash-recovery intent sweep) treats them as one unit
        gangs = self.store.gang_groups_of(j for j, _o in result.matched)
        # units preserve match order: singles as-is, gang cohorts whole
        units: List[List[Tuple[Job, Offer]]] = []
        cohort_by_gang: Dict[str, List[Tuple[Job, Offer]]] = {}
        for job, offer in result.matched:
            guuid = job.group if job.group in gangs else None
            if guuid is None:
                units.append([(job, offer)])
            else:
                cohort = cohort_by_gang.get(guuid)
                if cohort is None:
                    cohort = cohort_by_gang[guuid] = []
                    units.append(cohort)
                cohort.append((job, offer))
        for unit in units:
            # per-compute-cluster launch rate limit (reference:
            # filter-matches-for-ratelimit scheduler.clj:887) — applied
            # to the whole unit: a gang partially over the limit would
            # otherwise launch partial
            if cluster_rl.enforce:
                need: Dict[str, int] = {}
                for _job, offer in unit:
                    need[offer.cluster] = need.get(offer.cluster, 0) + 1
                ok = True
                for cname, n in need.items():
                    budget = cluster_budget.setdefault(
                        cname, cluster_rl.get_token_count(cname))
                    if budget < n:
                        ok = False
                if not ok:
                    result.unmatched.extend(job for job, _o in unit)
                    guuid = unit[0][0].group \
                        if unit[0][0].group in gangs else None
                    if guuid:
                        # surface the wait to the unscheduled explainer:
                        # the gang MATCHED but the cluster launch budget
                        # cannot cover the whole cohort yet (tokens
                        # refill; permanent only if the bucket is
                        # smaller than the gang)
                        result.gang_partial.setdefault(guuid, {
                            "size": len(unit), "matched": len(unit),
                            "missing": 0, "topology_blocked": False,
                            "rate_limited": True})
                    continue
                for cname, n in need.items():
                    cluster_budget[cname] -= n
            guuid = unit[0][0].group if unit[0][0].group in gangs else None
            for job, offer in unit:
                task_id = new_uuid()
                entries.append(dict(
                    job_uuid=job.uuid, task_id=task_id,
                    hostname=offer.hostname,
                    slave_id=offer.slave_id, compute_cluster=offer.cluster,
                    node_location=offer.attributes.get(
                        LOCATION_ATTRIBUTE, ""),
                    **({"gang": guuid} if guuid else {})))
                by_task[task_id] = (job, offer)
        # ONE guard transaction for the whole cycle's launches (reference:
        # launch-matched-tasks! transacts all task txns at once,
        # scheduler.clj:810-1009); per-job guard failures are reported and
        # those jobs never reach a backend
        insts, failures = self.store.launch_instances(entries)
        result.launch_failures.extend(failures)
        for inst in insts:
            job, offer = by_task[inst.task_id]
            # launch-time wait histogram: the queue-latency SLO's
            # companion (monitor samples pending ages; this records the
            # realized wait of every job that actually launched)
            registry.observe("cook_queue_latency_seconds",
                             inst.queue_time_ms / 1000.0,
                             labels={"pool": pool_name},
                             buckets=LATENCY_BUCKETS)
            launch_rl.spend(pool_user_key(pool_name, job.user))
            cluster_rl.spend(offer.cluster)
            env = job.env
            if job.trace_id:
                # propagate the submission's trace context to the agent
                # executor (W3C traceparent in the task env): the exec
                # span the wrapper opens joins the job's client-minted
                # trace, so the fleet trace collector can stitch client
                # submit -> leader txn -> agent exec onto one timeline
                # (docs/OBSERVABILITY.md)
                env = {**env, "COOK_TRACEPARENT":
                       tracing.make_traceparent(job.trace_id)}
            guuid = job.group if job.group in gangs else None
            if guuid:
                # executors gate on the gang barrier via the task env
                # (docs/GANG.md); the scheduler's barrier state is the
                # authoritative mirror on /group.  Elastic gangs also
                # see their legal size range so the workload can adapt
                # to resize events (COOK_GANG_RESIZE_* protocol,
                # agent/executor.py).
                from ..state.schema import gang_bounds, gang_is_elastic
                g = gangs.get(guuid)
                env = {**env, "COOK_GANG_UUID": guuid,
                       "COOK_GANG_SIZE":
                           str(getattr(g, "gang_size", 0) or 0)}
                if gang_is_elastic(g):
                    lo, hi = gang_bounds(g)
                    env["COOK_GANG_MIN"] = str(lo)
                    env["COOK_GANG_MAX"] = str(hi)
                    # sandbox-relative advisory file the agent executor
                    # appends resize events to (SIGUSR1 says "look",
                    # the file says what; agent/executor.py)
                    env["COOK_GANG_RESIZE_FILE"] = \
                        ".cook-gang-resize.jsonl"
            by_cluster.setdefault(offer.cluster, []).append(LaunchSpec(
                task_id=inst.task_id, job_uuid=job.uuid,
                hostname=offer.hostname, slave_id=offer.slave_id,
                resources=job.resources, env=env, port_count=job.ports,
                container=job.container))
            result.launched_task_ids.append(inst.task_id)
            result.launched_job_uuids.append(job.uuid)
        # per-cluster launches fan out in parallel (reference: future per
        # cluster, scheduler.clj:1034-1048) — one slow backend must not
        # serialize the others
        def launch_on(cluster, specs):
            from ..utils.retry import breakers
            cluster.kill_lock.acquire_read()
            try:
                with tracing.span("cluster.launch-tasks", pool=pool_name,
                                  cluster=cluster.name, tasks=len(specs)):
                    cluster.launch_tasks(pool_name, specs)
            except Exception:
                # a whole-batch dispatch failure counts against the
                # cluster's breaker; the intents stay open so a crash or
                # restart reconciles them (refund, never duplicate)
                breakers.get(cluster.name).record_failure()
                raise
            finally:
                cluster.kill_lock.release_read()
            # dispatch acked by the backend: confirm the launch intents
            # (tasks whose status already arrived were cleared in-line)
            self.store.clear_launch_intents([s.task_id for s in specs])

        targets = [(clusters[name], specs)
                   for name, specs in by_cluster.items() if name in clusters]
        if len(targets) == 1:
            launch_on(*targets[0])
        elif targets:
            import contextvars
            import threading
            errors: List[BaseException] = []

            def launch_guarded(cluster, specs):
                try:
                    launch_on(cluster, specs)
                except BaseException as e:  # propagate after join
                    errors.append(e)

            # copy_context: the per-cluster launch spans (and their
            # flight-record attribution) stay nested under the calling
            # cycle's trace instead of starting orphan root traces
            threads = [threading.Thread(
                target=contextvars.copy_context().run,
                args=(launch_guarded,) + t,
                name=f"launch-{t[0].name}")
                for t in targets]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            if errors:
                # surface like the sequential path would: first failure wins
                raise errors[0]


def resolve_backend(mc: MatcherConfig, num_jobs: int) -> str:
    """The concrete kernel for ``auto``: the bit-exact greedy while the
    job count is at most ``auto_large_j_threshold``; beyond it the
    waterfill ("throughput") or the auction with its waterfill tail
    ("tight")."""
    if mc.backend == "tpu-auction-pallas":  # mutated after validation
        return "tpu-auction"
    if mc.backend == "tpu-megakernel":
        # a cycle backend: when the split path runs, it matches with the
        # greedy, the assignment the fused cycle computes
        return "tpu-greedy"
    if mc.backend != "auto":
        return mc.backend
    if num_jobs <= mc.auto_large_j_threshold:
        return "tpu-greedy"
    return "tpu-auction" if mc.auto_packing == "tight" else "tpu-waterfill"


def dispatch(mc: MatcherConfig, job_res, cmask, avail, cap,
             device="cuda") -> np.ndarray:
    """assign i32[J]: each job's host index, or -1.  ``job_res`` [J, 4],
    ``cmask`` bool[J, H], ``avail`` and ``cap`` [H, 4], as numpy or
    lists."""
    job_res = np.asarray(job_res, dtype=F32).reshape(-1, 4)
    avail = np.asarray(avail, dtype=F32).reshape(-1, 4)
    cap = np.asarray(cap, dtype=F32).reshape(-1, 4)
    cmask = np.asarray(cmask, dtype=bool)
    if mc.backend == "cpu":
        return reference_impl.greedy_match(job_res, cmask, avail, cap)
    return _dispatch_device(mc, job_res, cmask, avail, cap,
                            resolve_device(device))


def _dispatch_device(mc, job_res, cmask, avail, cap, dev) -> np.ndarray:
    backend = resolve_backend(mc, len(job_res))
    if backend == "tpu-waterfill" and mc.backend == "auto" and len(job_res):
        # the waterfill's mask support is safety-only (a sparse row's few
        # allowed hosts can be probed over): dense rows go through the
        # waterfill, the constrained minority through the exact greedy
        # against the availability the waterfill left
        sparse = cmask.mean(axis=1) < mc.sparse_cmask_density
        if sparse.any():
            assign = np.full(len(job_res), -1, dtype=np.int32)
            avail_left = avail
            didx = np.flatnonzero(~sparse)
            if didx.size:
                a, avail_left = _run_kernel(
                    "tpu-waterfill", mc, job_res[didx], cmask[didx],
                    avail_left, cap, dev)
                assign[didx] = a
            sidx = np.flatnonzero(sparse)
            a, _ = _run_kernel("tpu-greedy", mc, job_res[sidx], cmask[sidx],
                               avail_left, cap, dev)
            assign[sidx] = a
            return assign
    return _run_kernel(backend, mc, job_res, cmask, avail, cap, dev)[0]


def _run_kernel(backend: str, mc: MatcherConfig, job_res, cmask, avail,
                cap, dev):
    """One kernel call on ``dev``; returns (assign over the real jobs,
    remaining availability over the real hosts), as numpy."""
    from ..utils.faults import injector as _faults
    _faults.fire("kernel.dispatch")
    arrays = host_prep.pack_match_inputs(job_res, cmask, avail, cap)
    telemetry.count_transfer("h2d", sum(
        getattr(a, "nbytes", 0) for a in arrays.values()))
    inp = MatchInputs(*(torch.from_numpy(arrays[k]).to(dev) for k in (
        "job_res", "constraint_mask", "avail", "capacity", "valid")))
    if backend == "tpu-auction":
        assign, left = auction_match_kernel(
            inp, num_prefs=mc.auction_num_prefs,
            num_rounds=mc.auction_num_rounds,
            num_refresh=mc.auction_num_refresh,
            min_refresh_gain=mc.auction_min_refresh_gain)
        # the waterfill places the auction's leftovers; placed jobs keep
        # their hosts, baked into the availability the tail sees
        tail_assign, left = waterfill_match_kernel(
            inp._replace(avail=left, valid=inp.valid & (assign < 0)),
            num_rounds=mc.waterfill_num_rounds,
            num_compaction=mc.waterfill_num_compaction)
        assign = torch.where(assign < 0, tail_assign, assign)
    elif backend == "tpu-waterfill":
        assign, left = waterfill_match_kernel(
            inp, num_rounds=mc.waterfill_num_rounds,
            num_compaction=mc.waterfill_num_compaction)
    else:
        assign, left = greedy_match_kernel(inp)
    with telemetry.sync_wait("match.fetch"):
        assign_np = assign.cpu().numpy()
        left_np = left.cpu().numpy()
    telemetry.count_transfer("d2h", assign_np.nbytes + left_np.nbytes)
    return assign_np[:arrays["num_jobs"]], left_np[:len(avail)]
