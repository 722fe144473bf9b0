"""The port of ``cook_tpu/sched/rebalancer.py``: the rebalancer cycle,
periodic preemption to restore fair share.

Host half of the reference's rebalancer (reference: rebalancer.clj
rebalance :434, init-state :222-266, next-state :270-309): build the DRU
state of all running tasks, walk the top pending jobs, and for each ask the
preemption search for the host whose minimum-DRU victim set is maximal;
apply decisions by transacting preempted-by-rebalancer failures (mea-culpa)
and kill the tasks under the cluster write lock.

``backend="tpu"`` keeps the reference's name and means the device path:
``ops/rebalance.preemption_kernel`` (its segmented sum through kernel K2
on a card, the plain version on the CPU) on the ``device`` the
``Rebalancer`` was given; each decision comes back in one device-to-host
transfer.  ``backend="cpu"`` is the numpy reference
(``ops/reference_impl.preemption_decision``).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..cluster.base import ComputeCluster, Offer
from ..config import Config
from ..state.schema import (
    DruMode,
    Instance,
    InstanceStatus,
    Job,
    Reasons,
    Resources,
    job_usage,
    add_usage,
    below_quota,
)
from ..state.store import Store
from .constraints import ConstraintContext, build_constraint_mask
from .ranker import _job_feature_key

F32 = np.float32


def effective_rebalancer_params(config: Config, store: Store):
    """Static file config overlaid with the store's dynamic document
    (reference: rebalancer params re-read from the DB every cycle,
    rebalancer.clj:539-544).  Module-level so API nodes without a
    scheduler report the same truth they accept updates against."""
    import dataclasses
    params = config.rebalancer
    override = store.dynamic_config("rebalancer")
    if not override:
        return params
    known = {f.name for f in dataclasses.fields(params)}
    return dataclasses.replace(
        params, **{k: v for k, v in override.items() if k in known})


def read_decision(out, n: int):
    """``(found, spare_only, host, decision_dru, victim_mask[:n])`` of a
    ``RebalanceDecision``, read back in ONE device-to-host transfer: the
    four scalars and the mask packed into one i32 vector (the f32 DRU by
    its bit pattern)."""
    packed = torch.cat([
        out.found.reshape(1).to(torch.int32),
        out.spare_only.reshape(1).to(torch.int32),
        out.host.reshape(1).to(torch.int32),
        out.decision_dru.reshape(1).to(torch.float32).view(torch.int32),
        out.victim_mask[:n].to(torch.int32)]).cpu().numpy()
    dru = float(packed[3:4].view(np.float32)[0])
    return (bool(packed[0]), bool(packed[1]), int(packed[2]), dru,
            packed[4:].astype(bool))


@dataclass
class PreemptionDecision:
    job_uuid: str
    hostname: str
    victim_task_ids: List[str]
    dru: float
    spare_only: bool = False
    # fairness observability (docs/OBSERVABILITY.md): the DRU facts that
    # justified the decision — per-victim DRU at decision time, the
    # beneficiary's pending DRU, and which victims were only taken by a
    # whole-gang closure (they label cook_preemptions_total{reason} and
    # land on both sides' audit timelines)
    victim_drus: Dict[str, float] = field(default_factory=dict)
    pending_dru: float = 0.0
    gang_victim_ids: List[str] = field(default_factory=list)
    # ELASTIC shrink victims (docs/GANG.md elasticity): surplus members
    # of elastic gangs shed through the checkpoint/grace protocol
    # instead of the immediate preempt kill — their gangs keep running
    # at >= gang_min, no whole-gang closure
    shrink_task_ids: List[str] = field(default_factory=list)


@dataclass
class _Task:
    task_id: str
    job: Job
    inst: Instance
    dru: float = 0.0


class _State:
    """Mutable cycle state (reference: rebalancer State record)."""

    def __init__(self, store: Store, pool_name: str, dru_mode: DruMode,
                 running: List[Tuple[Job, Instance]],
                 spare: Dict[str, Resources]):
        self.pool_name = pool_name
        self.gpu_mode = dru_mode is DruMode.GPU
        self.store = store
        # user -> tasks in comparator order (running only)
        self.user_tasks: Dict[str, List[_Task]] = {}
        # gang bookkeeping (docs/GANG.md): task -> gang group uuid and
        # gang -> member tasks, so victims are priced and expanded at
        # whole-gang granularity — preemption must never strand a
        # partial gang
        self.gang_of_task: Dict[str, str] = {}
        self.gang_tasks: Dict[str, List[str]] = {}
        # elastic gangs (docs/GANG.md elasticity): effective minimum per
        # gang, so the decision loop can shed SURPLUS members (live -
        # min, net of shrinks already pending a grace deadline) instead
        # of closing the whole gang
        self.gang_lo: Dict[str, int] = {}
        self.gang_elastic: set = set()
        gang_groups: Dict[str, bool] = {}
        for job, inst in running:
            self.user_tasks.setdefault(job.user, []).append(
                _Task(inst.task_id, job, inst))
            if job.group is not None:
                is_gang = gang_groups.get(job.group)
                if is_gang is None:
                    g = store.group(job.group)
                    is_gang = bool(g is not None
                                   and getattr(g, "gang", False))
                    gang_groups[job.group] = is_gang
                    if is_gang:
                        from ..state.schema import (gang_bounds,
                                                    gang_is_elastic)
                        self.gang_lo[job.group] = gang_bounds(g)[0]
                        if gang_is_elastic(g):
                            self.gang_elastic.add(job.group)
                if is_gang:
                    self.gang_of_task[inst.task_id] = job.group
                    self.gang_tasks.setdefault(
                        job.group, []).append(inst.task_id)
        # surplus shrink budget per elastic gang, consumed as decisions
        # shed members this cycle
        self.gang_surplus: Dict[str, int] = {
            g: max(len(self.gang_tasks.get(g, ())) - self.gang_lo[g], 0)
            for g in self.gang_elastic}
        for user, tasks in self.user_tasks.items():
            tasks.sort(key=lambda t: _job_feature_key(t.job, t.inst))
        self.shares: Dict[str, Tuple[float, float, float]] = {}
        for user in self.user_tasks:
            s = store.get_share(user, pool_name)
            self.shares[user] = (s["cpus"], s["mem"], s["gpus"])
        for user in self.user_tasks:
            self._recompute_user(user)
        self.spare: Dict[str, Resources] = dict(spare)
        self.preempted_ids: set = set()

    def _share(self, user: str) -> Tuple[float, float, float]:
        if user not in self.shares:
            s = self.store.get_share(user, self.pool_name)
            self.shares[user] = (s["cpus"], s["mem"], s["gpus"])
        return self.shares[user]

    def _recompute_user(self, user: str) -> None:
        """Per-user cumulative DRU (reference: dru.clj:50-80)."""
        share = np.asarray(self._share(user), dtype=F32)
        cum = np.zeros(3, dtype=F32)
        for t in self.user_tasks.get(user, []):
            cum = cum + np.array([t.job.resources.cpus, t.job.resources.mem,
                                  t.job.resources.gpus], dtype=F32)
            if self.gpu_mode:
                t.dru = float(cum[2] / share[2])
            else:
                t.dru = float(max(cum[1] / share[1], cum[0] / share[0]))

    def pending_job_dru(self, job: Job) -> float:
        """Nearest-task dru + the job's own increment (reference:
        compute-pending-default-job-dru rebalancer.clj:182-209)."""
        user = job.user
        tasks = self.user_tasks.get(user, [])
        key = _job_feature_key(job, None)
        keys = [_job_feature_key(t.job, t.inst) for t in tasks]
        i = bisect.bisect_right(keys, key)
        nearest = tasks[i - 1].dru if i > 0 else 0.0
        share = self._share(user)
        if self.gpu_mode:
            return nearest + job.resources.gpus / share[2]
        return max(nearest + job.resources.mem / share[1],
                   nearest + job.resources.cpus / share[0])

    def job_below_quota(self, job: Job) -> bool:
        """Would the job fit its user's quota if launched (rebalancer.clj
        job-below-quota :212-221)."""
        usage = job_usage(job)
        for t in self.user_tasks.get(job.user, []):
            usage = add_usage(usage, job_usage(t.job))
        quota = self.store.get_quota(job.user, self.pool_name)
        return below_quota(quota, usage)

    def all_tasks(self) -> List[_Task]:
        return [t for tasks in self.user_tasks.values() for t in tasks]

    def apply_decision(self, job: Job, hostname: str,
                       victims: List[_Task]) -> None:
        """next-state (rebalancer.clj:270-309): remove victims, add the
        pending job as a virtual running task, update spare, rescore."""
        changed = {job.user}
        for v in victims:
            changed.add(v.job.user)
            self.user_tasks[v.job.user].remove(v)
            self.preempted_ids.add(v.task_id)
        virtual = _Task(
            task_id=f"virtual-{job.uuid}", job=job,
            inst=Instance(task_id=f"virtual-{job.uuid}", job_uuid=job.uuid,
                          hostname=hostname,
                          status=InstanceStatus.RUNNING,
                          start_time_ms=2**62))
        lst = self.user_tasks.setdefault(job.user, [])
        lst.append(virtual)
        lst.sort(key=lambda t: _job_feature_key(t.job, t.inst))
        for user in changed:
            self._recompute_user(user)
        # each victim's capacity frees on ITS OWN host (identical to the
        # old single-host sum when all victims share the target host —
        # always true for non-gang decisions — but a whole-gang closure
        # spans hosts and must not credit them all to the target)
        for v in victims:
            self.spare[v.inst.hostname] = \
                self.spare.get(v.inst.hostname, Resources()) \
                + v.job.resources
        self.spare[hostname] = \
            self.spare.get(hostname, Resources()) - job.resources


class Rebalancer:
    def __init__(self, store: Store, config: Config, backend: str = "tpu",
                 device="cuda"):
        self.store = store
        self.config = config
        self.backend = backend
        # the device the preemption search runs on (backend "tpu")
        self.device = resolve_device(device)
        # elastic resize plane (sched/elastic.ElasticManager, attached
        # by the scheduler): surplus members of elastic gangs shrink
        # through the checkpoint/grace protocol instead of dying with a
        # whole-gang closure.  None = pre-elastic behavior.
        self.elastic = None

    def effective_params(self):
        """Per-cycle parameter resolution: the store's dynamic config
        document overrides the static file config, exactly the reference's
        read-params-from-the-DB-every-cycle (rebalancer.clj:539-544) — a
        no-restart tuning plane."""
        return effective_rebalancer_params(self.config, self.store)

    def rebalance_pool(self, pool_name: str, dru_mode: DruMode,
                       pending_ranked: List[Job],
                       clusters: Dict[str, ComputeCluster]
                       ) -> List[PreemptionDecision]:
        params = self.effective_params()
        if not pending_ranked:
            return []
        running = self.store.running_instances(pool_name)
        spare: Dict[str, Resources] = {}
        offers_by_host: Dict[str, Offer] = {}
        for cluster in clusters.values():
            if not cluster.accepts_pool(pool_name):
                continue
            # hosts() covers fully-utilized hosts with their true
            # capacity/attributes so constraints evaluate correctly there
            for offer in cluster.hosts(pool_name):
                offers_by_host[offer.hostname] = offer
            for offer in cluster.pending_offers(pool_name):
                spare[offer.hostname] = offer.available
                offers_by_host[offer.hostname] = offer
        state = _State(self.store, pool_name, dru_mode, running, spare)
        if self.elastic is not None and state.gang_elastic:
            # members already pending a grace shrink are not surplus
            # twice: shedding "surplus" that is mid-shrink would take
            # the gang below gang_min once both kills execute
            pending = self.elastic.pending_shrinks()
            for tid, entry in pending.items():
                g = entry.get("gang")
                if g in state.gang_surplus:
                    state.gang_surplus[g] = max(
                        state.gang_surplus[g] - 1, 0)

        decisions: List[PreemptionDecision] = []
        budget = params.max_preemption
        task_by_id = {t.task_id: t for t in state.all_tasks()}
        for job in pending_ranked:
            if budget <= 0:
                break
            decision = self._decide(state, job, params, offers_by_host)
            if decision is None:
                continue
            victims = decision[1]
            hostname = decision[0]
            # the beneficiary's DRU BEFORE the decision mutates state:
            # the victim/beneficiary delta is the fairness justification
            pending_dru = state.pending_job_dru(job)
            direct = {v.task_id for v in victims}
            # SHRINK instead of closure (docs/GANG.md elasticity): an
            # elastic gang whose chosen victims fit inside its surplus
            # budget sheds exactly those members through the grace
            # protocol and keeps running at >= gang_min — no closure.
            # Victims beyond the surplus close the whole gang as before.
            shrink_ids: List[str] = []
            if victims and state.gang_elastic:
                per_gang: Dict[str, int] = {}
                for v in victims:
                    g = state.gang_of_task.get(v.task_id)
                    if g in state.gang_elastic:
                        per_gang[g] = per_gang.get(g, 0) + 1
                shrink_gangs = {
                    g for g, n in per_gang.items()
                    if n <= state.gang_surplus.get(g, 0)}
                for g in shrink_gangs:
                    state.gang_surplus[g] -= per_gang[g]
                shrink_ids = [v.task_id for v in victims
                              if state.gang_of_task.get(v.task_id)
                              in shrink_gangs]
            else:
                shrink_gangs = set()
            # whole-gang closure (docs/GANG.md): preempting any member
            # kills its entire gang — across hosts — so the decision can
            # never strand a partial gang holding fragmented capacity
            if victims and state.gang_of_task:
                seen = {v.task_id for v in victims}
                for v in list(victims):
                    g = state.gang_of_task.get(v.task_id)
                    if g is None or g in shrink_gangs:
                        continue
                    for tid in state.gang_tasks.get(g, ()):
                        if tid in seen or tid in state.preempted_ids:
                            continue
                        mate = task_by_id.get(tid)
                        if mate is not None:
                            victims.append(mate)
                            seen.add(tid)
            victim_drus = {v.task_id: round(float(v.dru), 4)
                           for v in victims}
            state.apply_decision(job, hostname, victims)
            decisions.append(PreemptionDecision(
                job_uuid=job.uuid, hostname=hostname,
                victim_task_ids=[v.task_id for v in victims],
                dru=decision[2], spare_only=not victims,
                victim_drus=victim_drus,
                pending_dru=round(float(pending_dru), 4),
                gang_victim_ids=[v.task_id for v in victims
                                 if v.task_id not in direct],
                shrink_task_ids=shrink_ids))
            if victims:
                budget -= 1
        self._execute(decisions, clusters)
        return [d for d in decisions if d.victim_task_ids]

    # ----------------------------------------------------------------- core
    def _decide(self, state: _State, job: Job, params,
                offers_by_host: Dict[str, Offer]
                ) -> Optional[Tuple[str, List["_Task"], float]]:
        pending_dru = state.pending_job_dru(job)
        job_ok_quota = state.job_below_quota(job)

        tasks = state.all_tasks()
        # whole-gang pricing (docs/GANG.md): preempting any member kills
        # the whole gang, so a member's effective DRU for eligibility,
        # scan order, and the decision score is its gang's MINIMUM — the
        # gang is never cheaper than its most-protected member
        gang_min: Dict[str, float] = {}
        if state.gang_of_task:  # gang-free clusters skip the O(tasks) pass
            for t in tasks:
                g = state.gang_of_task.get(t.task_id)
                if g is not None:
                    cur = gang_min.get(g)
                    gang_min[g] = t.dru if cur is None else min(cur, t.dru)

        def edru(t: "_Task") -> float:
            g = state.gang_of_task.get(t.task_id)
            if g is None:
                return t.dru
            # elastic gangs with shrink surplus price members at their
            # OWN dru — the post-shrink cost of the decision is one
            # member, not the whole gang (docs/GANG.md elasticity);
            # once the surplus is consumed the gang-min floor returns
            if state.gang_surplus.get(g, 0) > 0:
                return t.dru
            return gang_min[g]
        # only hosts with a backend inventory entry are preemption targets:
        # a host known solely from a running task has no attribute/capacity
        # facts, so constraint evaluation there would be guesswork
        hostnames = sorted(set(offers_by_host.keys()))
        if not hostnames:
            return None
        host_index = {h: i for i, h in enumerate(hostnames)}

        # eligibility (rebalancer.clj:340-348)
        def ok(t: _Task) -> bool:
            if t.task_id in state.preempted_ids or t.task_id.startswith("virtual-"):
                return False
            if self.elastic is not None \
                    and self.elastic.shrinking(t.task_id):
                return False  # already mid-grace: its capacity is spoken for
            if t.inst.hostname not in host_index:
                return False  # no backend inventory for this host
            if not (job_ok_quota or t.job.user == job.user):
                return False
            d = edru(t)
            if d < params.safe_dru_threshold:
                return False
            return (d - pending_dru) > params.min_dru_diff

        # host constraint check with the match-side compiler
        offers = [offers_by_host[h] for h in hostnames]
        ctx = ConstraintContext(
            max_tasks_per_host=None)  # preemption frees slots; skip count cap
        host_ok = build_constraint_mask([job], offers, ctx)[0]

        order = sorted(range(len(tasks)),
                       key=lambda i: (host_index.get(tasks[i].inst.hostname, 0),
                                      -edru(tasks[i]), i))
        demand = np.array([job.resources.cpus, job.resources.mem,
                           job.resources.gpus, 0.0], dtype=F32)
        spare_arr = np.zeros((len(hostnames), 4), dtype=F32)
        for h, name in enumerate(hostnames):
            s = state.spare.get(name, Resources())
            spare_arr[h] = [s.cpus, s.mem, s.gpus, 0.0]

        # gpu feasibility only matters when requested; padding col 3 unused
        task_dru = np.array([edru(tasks[i]) for i in order], dtype=F32)
        task_res = np.array(
            [[tasks[i].job.resources.cpus, tasks[i].job.resources.mem,
              tasks[i].job.resources.gpus, 0.0] for i in order], dtype=F32) \
            if order else np.zeros((0, 4), dtype=F32)
        task_host = np.array(
            [host_index.get(tasks[i].inst.hostname, 0) for i in order],
            dtype=np.int32)
        eligible = np.array([ok(tasks[i]) for i in order], dtype=bool)

        if self.backend == "cpu" or len(order) == 0:
            from ..ops.reference_impl import preemption_decision
            res = preemption_decision(task_dru, task_res, task_host, eligible,
                                      spare_arr, host_ok, demand)
            if res is None:
                return None
            host, victim_pos, dru = res
            victims = [tasks[order[p]] for p in victim_pos]
            return hostnames[host], victims, float(dru)

        from ..ops.padding import bucket, pad_to
        from ..ops.rebalance import RebalanceInputs, preemption_kernel
        T = bucket(len(order))
        host_start = np.ones(len(order), dtype=bool)
        host_start[1:] = task_host[1:] != task_host[:-1]
        dev = self.device
        inp = RebalanceInputs(*(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (pad_to(task_dru, T), pad_to(task_res, T),
                      pad_to(task_host, T),
                      pad_to(host_start, T, fill=True),
                      pad_to(eligible, T, fill=False), spare_arr,
                      host_ok, demand)))
        found, spare_only, host, dru, mask = read_decision(
            preemption_kernel(inp, device=dev), len(order))
        if not found:
            return None
        if spare_only:
            return hostnames[host], [], float("inf")
        victims = [tasks[order[p]] for p in np.nonzero(mask)[0]]
        return hostnames[host], victims, dru

    # -------------------------------------------------------------- execute
    def _execute(self, decisions: List[PreemptionDecision],
                 clusters: Dict[str, ComputeCluster]) -> None:
        """Transact preemptions then kill under the write lock (reference:
        rebalancer.clj:482-533).  Both sides of every decision land on
        the audit trail with the DRU delta that justified it: the victim
        records who preempted it and at what DRU, the beneficiary
        records whose capacity it received (docs/OBSERVABILITY.md)."""
        audit = self.store.audit
        for d in decisions:
            gang_mates = set(d.gang_victim_ids)
            shrinks = set(d.shrink_task_ids)
            for tid in d.victim_task_ids:
                inst = self.store.instance(tid)
                if inst is None:
                    continue
                if tid in shrinks and self.elastic is not None \
                        and self.elastic.enabled:
                    # elastic surplus member: checkpoint/grace shrink
                    # instead of the immediate kill — the gang runs on
                    # at its post-shrink size (docs/GANG.md elasticity)
                    job = self.store.job(inst.job_uuid)
                    self.elastic.request_shrink(
                        tid, inst.job_uuid,
                        job.group if job is not None else "",
                        inst.compute_cluster, clusters,
                        reason="pressure",
                        facts={"by": d.job_uuid,
                               "dru": d.victim_drus.get(tid),
                               "beneficiary_dru": d.pending_dru})
                    continue
                self.store.update_instance_status(
                    tid, InstanceStatus.FAILED,
                    reason_code=Reasons.PREEMPTED_BY_REBALANCER.code,
                    preempted=True)
                audit.record(inst.job_uuid, "preempted", {
                    "task": tid, "by": d.job_uuid,
                    "host": inst.hostname,
                    "dru": d.victim_drus.get(tid),
                    "beneficiary_dru": d.pending_dru,
                    **({"gang_closure": True} if tid in gang_mates
                       else {})}, durable=True)
                cluster = clusters.get(inst.compute_cluster)
                if cluster is not None:
                    cluster.safe_kill_task(tid)
            if d.victim_task_ids:
                audit.record(d.job_uuid, "preemption-benefit", {
                    "victims": len(d.victim_task_ids),
                    "host": d.hostname, "dru": d.pending_dru,
                    "victim_dru_min": min(d.victim_drus.values())
                    if d.victim_drus else None}, durable=True)
