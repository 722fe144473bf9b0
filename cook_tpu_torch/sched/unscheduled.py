"""The port's copy of ``cook_tpu/sched/unscheduled.py`` (imports re-rooted):
it reads the port's ``RankedQueue``.

Why-is-my-job-pending explainer.

Mirrors the reference's unscheduled-jobs reasons (reference:
scheduler/src/cook/unscheduled.clj reasons :172 — exhausted retries,
quota/share limits, queue position with jobs-ahead, launch rate limit,
plugin filter, placement failure; fenzo_utils.clj:21-99 for the
placement-failure summary).  Each reason is {reason, data}; several can
apply at once.

Placement failures use the reference's two-step "under investigation"
workflow: the first ask flags the job (:job/under-investigation), the next
match cycle records a per-host failure census for it
(Matcher.record_placement_failures), and subsequent asks present the
detailed host counts per cause.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..state.schema import (
    InstanceStatus,
    Job,
    JobState,
    add_usage,
    below_quota,
    job_usage,
)
from ..state.store import Store

# constraint name -> human message (reference: unscheduled.clj
# constraint-name->message)
CONSTRAINT_MESSAGES = {
    "novel_host_constraint": "Job already ran on this host.",
    "gpu_host_constraint": "Host has no GPU support.",
    "non_gpu_host_constraint":
        "Host is reserved for jobs that need GPU support.",
    "attribute-equals-host-placement-group-constraint":
        "Host had a different attribute than other jobs in the group.",
    "unique_host_constraint": "Group cotask already runs on this host.",
    "balanced-host-placement-group-constraint":
        "Placing here would unbalance the group's spread.",
    "rebalancer_reservation_constraint":
        "Host is reserved for a preempting job.",
    "checkpoint_locality_constraint":
        "Host is outside the job's prior checkpoint location.",
    "max_tasks_per_host_constraint": "Host is at its task-count limit.",
    "disk_type_constraint": "Host has a different disk type.",
    "gpu_model_constraint": "Host has a different GPU model.",
    "gang_topology_constraint":
        "Host is outside every topology domain (slice) large enough "
        "for the whole gang.",
}


def placement_failure_for_user(summary: Dict) -> List[Dict]:
    """Serialized failure census -> presentation rows (reference:
    fenzo-failures-for-user, unscheduled.clj)."""
    rows: List[Dict] = []
    for dim, n in (summary.get("resources") or {}).items():
        rows.append({"reason": f"Not enough {dim} available.",
                     "host_count": n})
    for name, n in (summary.get("constraints") or {}).items():
        rows.append({"reason": CONSTRAINT_MESSAGES.get(name, name),
                     "host_count": n})
    return rows


def _limit_excess(limits: Dict[str, float], usage: Dict[str, float]) -> Dict:
    """How usage would exceed limits (reference:
    how-job-would-exceed-resource-limits, unscheduled.clj): returns
    {dim: {"limit": l, "usage": u}} for each exceeded dimension."""
    out = {}
    for dim, lim in limits.items():
        if lim != float("inf") and usage.get(dim, 0.0) > lim:
            out[dim] = {"limit": lim, "usage": usage.get(dim, 0.0)}
    return out


def job_reasons(store: Store, job: Job,
                scheduler=None,
                queue_limits=None) -> List[Dict]:
    """Compute unscheduled reasons for a waiting job."""
    reasons: List[Dict] = []
    if job.state is not JobState.WAITING:
        reasons.append({"reason": f"The job is {job.state.value}.", "data": {}})
        return reasons
    if not job.committed:
        reasons.append({
            "reason": "The job is not yet committed (its submission batch "
                      "has not completed).",
            "data": {}})
        return reasons

    # exhausted retries (reference: check-exhausted-retries)
    instances = {t: store.instance(t) for t in job.instances}
    instances = {t: i for t, i in instances.items() if i is not None}
    attempts = job.attempts_used(instances)
    if attempts >= job.max_retries:
        reasons.append({
            "reason": "Job has exhausted its maximum number of retries.",
            "data": {"max_retries": job.max_retries,
                     "instance_count": attempts}})
    else:
        failures = sum(1 for i in instances.values()
                       if i.status is InstanceStatus.FAILED)
        if failures:
            reasons.append({
                "reason": "The job has failed instances and is waiting to "
                          "retry.",
                "data": {"failures": failures,
                         "max_retries": job.max_retries}})

    # user quota and share limits (reference: check-exceeds-limit applied to
    # both quota and share read-fns)
    usage = job_usage(job)
    for other, _inst in store.running_instances(job.pool):
        if other.user == job.user:
            usage = add_usage(usage, job_usage(other))
    quota = store.get_quota(job.user, job.pool)
    if not below_quota(quota, usage):
        reasons.append({
            "reason": "The job would cause you to exceed resource quotas.",
            "data": _limit_excess(quota, usage)})
    share = store.get_share(job.user, job.pool)
    share_excess = _limit_excess(share, usage)
    if share_excess:
        reasons.append({
            "reason": "The job would cause you to exceed resource shares.",
            "data": share_excess})

    # queue limits
    if queue_limits is not None:
        # probe with one hypothetical job: at exactly the limit, n=0 would
        # pass and the reason would never surface
        msg = queue_limits.check_submission(job.pool, job.user, 1)
        if msg:
            reasons.append({"reason": "You have reached the limit of jobs "
                                      "you can have in the queue.",
                            "data": {"detail": msg}})

    if scheduler is not None:
        # admission brownout (sched/admission.py): under saturation the
        # matcher's considerable window is scaled down by the admission
        # level, so a job can be at the FRONT of its share and still wait
        # — "cs why" must say so instead of "just waiting for its turn"
        ctrl = getattr(scheduler, "admission", None)
        if ctrl is not None and ctrl.level < 1.0:
            reasons.append({
                "reason": "The scheduler is throttling admissions while "
                          "the cluster recovers from overload; fewer "
                          "jobs are considered each cycle.",
                "data": {"kind": "admission-throttled",
                         "level": round(ctrl.level, 3),
                         "stage": ctrl.stage,
                         "stage_name": ctrl.state().get("stage_name"),
                         "worst_resource": ctrl.worst_resource}})
        # launch rate limit
        rl = scheduler.rate_limits.job_launch
        if rl.enforce:
            from ..policy import pool_user_key
            key = pool_user_key(job.pool, job.user)
            if rl.get_token_count(key) <= 0:
                reasons.append({
                    "reason": "You are currently rate limited on how many "
                              "jobs you launch per minute.",
                    "data": {"seconds_until_out_of_debt":
                             rl.time_until_out_of_debt_s(key)}})
        # queue position + the jobs ahead (reference: check-queue-position
        # returns up to 10 uuids of the USER'S OWN jobs ahead in line —
        # never another user's uuids)
        queue = scheduler.pending_queues.get(job.pool, [])
        from .ranker import RankedQueue
        if isinstance(queue, RankedQueue):
            # columnar queue: pure numpy scans — no entity materialization
            # regardless of queue depth or position
            import numpy as np
            hits = np.flatnonzero(queue.uuids == job.uuid)
            position = int(hits[0]) if hits.size else None
            own_ahead = (list(queue.uuids[:position][
                queue.users[:position] == job.user])
                if position is not None and position > 0 else [])
        else:
            position = next((i for i, j in enumerate(queue)
                             if j.uuid == job.uuid), None)
            own_ahead = ([j.uuid for j in queue[:position]
                          if j.user == job.user]
                         if position is not None and position > 0 else [])
        if position is not None and position > 0:
            if own_ahead:
                reasons.append({
                    "reason": f"You have {len(own_ahead)} other jobs ahead "
                              "in the queue.",
                    "data": {"queue_position": position,
                             "queue_length": len(queue),
                             "jobs": own_ahead[:10]}})
        # launch-filter plugin verdict (reference: check-plugin-filter)
        plugins = getattr(scheduler, "plugins", None)
        if plugins is not None and plugins.launch_filters \
                and not plugins.launch_allowed(job):
            reasons.append({
                "reason": "The launch filter plugin is blocking the job "
                          "launch.",
                "data": {"plugins": [type(f).__name__
                                     for f in plugins.launch_filters]}})
        # gang reasons (docs/GANG.md): all-or-nothing placement means a
        # member can be individually placeable yet waiting on its gang
        last = getattr(scheduler, "last_match_results", {}).get(job.pool)
        if job.group is not None:
            group = store.group(job.group)
            if group is not None and getattr(group, "gang", False):
                gp = (getattr(last, "gang_partial", None) or {}).get(
                    job.group) if last is not None else None
                if gp and gp.get("rate_limited"):
                    reasons.append({
                        "reason": "The gang matched but is waiting for "
                                  "enough cluster launch-rate budget to "
                                  "launch all members together.",
                        "data": dict(gp)})
                elif gp and gp.get("topology_blocked"):
                    reasons.append({
                        "reason": "No slice of size "
                                  f"{gp['size']} satisfies the gang's "
                                  "topology request "
                                  f"({group.gang_topology}).",
                        "data": dict(gp)})
                elif gp:
                    reasons.append({
                        "reason": f"Waiting on {gp['missing']} of "
                                  f"{gp['size']} gang members to be "
                                  "placeable in the same cycle.",
                        "data": dict(gp)})
                else:
                    # deferred at ADMISSION (tokens/cap/denied member):
                    # the gang never reached the match pass, so there is
                    # no gang_partial entry to explain it
                    matcher = getattr(scheduler, "matcher", None)
                    adm = (getattr(matcher, "last_admission_deferred", {})
                           .get(job.pool, {}).get(job.group)
                           if matcher is not None else None)
                    if adm:
                        texts = {
                            "rate-limited":
                                "The gang is waiting for enough "
                                "launch-rate tokens to admit all "
                                f"{adm['size']} members together.",
                            "considerable-cap":
                                "The gang is waiting for enough room in "
                                "the scheduling cycle to consider all "
                                f"{adm['size']} members together.",
                            "members-missing":
                                "A gang member is no longer in the "
                                "pending queue, so the gang cannot be "
                                "admitted whole.",
                            "member-denied":
                                "A gang member is blocked from launching "
                                "(launch filter or quota), holding the "
                                "whole gang.",
                            "partial-admission":
                                "The gang could not be admitted whole "
                                "this cycle.",
                        }
                        reasons.append({
                            "reason": texts.get(
                                adm["reason"],
                                "The gang was deferred at admission."),
                            "data": dict(adm)})
        # placement failure: the two-step under-investigation workflow
        # (reference: check-fenzo-placement unscheduled.clj)
        unmatched_last_cycle = last is not None and any(
            j.uuid == job.uuid for j in last.unmatched)
        if job.last_placement_failure:
            reasons.append({
                "reason": "The job couldn't be placed on any available "
                          "hosts.",
                "data": {"reasons": placement_failure_for_user(
                    job.last_placement_failure)}})
        elif unmatched_last_cycle:
            if not job.under_investigation:
                store.set_placement_investigation(
                    job.uuid, under_investigation=True)
            reasons.append({
                "reason": "The job is now under investigation. Check back "
                          "in a minute for more details!",
                "data": {}})
    if not reasons:
        reasons.append({
            "reason": "The job is just waiting for its turn. "
                      "Check back soon!",
            "data": {}})
    return reasons
