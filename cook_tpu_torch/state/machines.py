"""The port's copy of ``cook_tpu/state/machines.py`` (imports re-rooted).

Pure state-machine transition functions for jobs and instances.

These mirror the reference's transactional Datomic db-fns
(reference: schema.clj :instance/update-state :1242-1308 and
:job/update-state :1202-1239) as pure functions over entity values.  The
store applies them inside a transaction so the "txn aborts if state moved"
discipline is preserved (SURVEY.md section 5, race handling #4).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .schema import (
    Instance,
    InstanceStatus,
    Job,
    JobState,
    Reasons,
)

# Legal instance transitions (reference: schema.clj:1242-1308). A transition
# request to the current state is a no-op; anything not listed is rejected.
_INSTANCE_TRANSITIONS = {
    InstanceStatus.UNKNOWN: {InstanceStatus.RUNNING, InstanceStatus.SUCCESS, InstanceStatus.FAILED},
    InstanceStatus.RUNNING: {InstanceStatus.SUCCESS, InstanceStatus.FAILED},
    InstanceStatus.SUCCESS: set(),
    InstanceStatus.FAILED: set(),
}


def instance_transition_allowed(cur: InstanceStatus, new: InstanceStatus) -> bool:
    return new is cur or new in _INSTANCE_TRANSITIONS[cur]


def next_job_state(
    job: Job,
    instances: Dict[str, Instance],
) -> Tuple[JobState, Optional[str]]:
    """Recompute job state from its instances.

    Returns (state, reason) where reason explains a COMPLETED verdict.
    Mirrors :job/update-state (schema.clj:1202-1239):
      - any live (unknown/running) instance  -> RUNNING
      - a successful instance                -> COMPLETED
      - all attempts consumed                -> COMPLETED
      - user killed the job                  -> COMPLETED
      - otherwise                            -> WAITING (retry)
    """
    if job.user_killed:
        return JobState.COMPLETED, "user-killed"
    success = False
    live = False
    for tid in job.instances:
        inst = instances.get(tid)
        if inst is None:
            continue
        if inst.status is InstanceStatus.SUCCESS:
            success = True
        elif inst.status in (InstanceStatus.UNKNOWN, InstanceStatus.RUNNING):
            live = True
    if success:
        return JobState.COMPLETED, "success"
    if live:
        return JobState.RUNNING, None
    if job.attempts_used(instances) >= job.max_retries:
        return JobState.COMPLETED, "attempts-consumed"
    return JobState.WAITING, None


def allowed_to_start(job: Job, instances: Dict[str, Instance]) -> Optional[str]:
    """Launch guard (reference: :job/allowed-to-start? schema.clj:1311-1325).

    Returns None when the job may start a new instance, else a rejection
    reason string.  Applied inside the launch transaction so a concurrent
    kill/complete aborts the launch (scheduler.clj:987-1009 invariant).
    """
    if job.state is not JobState.WAITING:
        return f"job-state-{job.state.value}"
    if not job.committed:
        return "uncommitted"
    for tid in job.instances:
        inst = instances.get(tid)
        if inst is not None and inst.status in (InstanceStatus.UNKNOWN, InstanceStatus.RUNNING):
            return "has-live-instance"
    return None


def classify_failure(reason_code: Optional[int]) -> Tuple[bool, Optional[int]]:
    """Return (mea_culpa?, failure_limit) for a failure reason code."""
    reason = Reasons.by_code(reason_code if reason_code is not None else Reasons.UNKNOWN.code)
    return reason.mea_culpa, reason.failure_limit


def gang_failure_action(group, reason_code: Optional[int],
                        failed_member_state: JobState,
                        live_members: Optional[int] = None) -> str:
    """What the gang policy does when one member's instance fails
    (docs/GANG.md).  Pure so the scheduler's tx-event handler stays a
    thin dispatcher.

    Returns one of:

    - ``"none"`` — not a gang, or the failure IS a gang-policy kill
      (``gang-member-lost``) or an elastic resize shrink
      (``gang-resized``): reacting to our own kills would cascade;
      also chosen for an ELASTIC gang that still holds ``gang_min``
      live members after the failure (``live_members``, counted by the
      caller post-transition) — the gang absorbs the loss as a shrink
      instead of tearing down work that is legal at its current size;
    - ``"requeue"`` — kill the gang's other live instances mea-culpa
      (``gang-member-lost``) so the whole gang returns to WAITING and
      relaunches atomically (the default policy);
    - ``"kill"`` — kill the whole gang's jobs outright.  Chosen when the
      group's policy says so, and FORCED when the failed member's job
      went terminal (retries exhausted, user kill): its siblings could
      otherwise wait forever on a gang that can never be whole again
      (elastic gangs still above ``gang_min`` excepted — they run on
      legally without the terminal member).
    """
    from .schema import GANG_POLICY_KILL, gang_bounds, gang_is_elastic
    if group is None or not getattr(group, "gang", False):
        return "none"
    if reason_code in (Reasons.GANG_MEMBER_LOST.code,
                       Reasons.GANG_RESIZED.code):
        return "none"
    if gang_is_elastic(group) and live_members is not None \
            and live_members >= gang_bounds(group)[0]:
        return "none"
    if failed_member_state is JobState.COMPLETED:
        return "kill"
    if getattr(group, "gang_policy", "") == GANG_POLICY_KILL:
        return "kill"
    return "requeue"


def gang_status(store, group,
                cache: Optional[Dict[str, Dict]] = None) -> Dict:
    """Gang placement status computed from the store (docs/GANG.md):
    members placed (live instance) / running, and the barrier state —
    ``None`` until any member launches, ``"pending"`` while members are
    coming up, ``"released"`` once every member has STARTED: currently
    RUNNING, or completed after a run (a short member can exit SUCCESS
    before the last member comes up — requiring everyone simultaneously
    RUNNING would misreport such gangs as forever "pending"; this also
    makes a gang whose members all ran and finished stay "released").
    Derived on demand so it survives leader handoffs.  ``cache`` (group
    uuid -> status) lets batch queries compute each gang once instead
    of once per member job."""
    if cache is not None and group.uuid in cache:
        return cache[group.uuid]
    placed = running = started = 0
    for member_uuid in group.jobs:
        member = store.job(member_uuid)
        if member is None:
            continue
        insts = [i for t in member.instances
                 if (i := store.instance(t)) is not None]
        if any(i.status in (InstanceStatus.UNKNOWN,
                            InstanceStatus.RUNNING) for i in insts):
            placed += 1
        if any(i.status is InstanceStatus.RUNNING for i in insts):
            running += 1
            started += 1
        elif member.state is JobState.COMPLETED and any(
                # the member DID run at some point: SUCCESS, or a
                # terminal instance that reached RUNNING (start stamp)
                i.status is InstanceStatus.SUCCESS
                or i.mesos_start_time_ms for i in insts):
            started += 1
    from .schema import gang_bounds, gang_is_elastic
    size = group.gang_size or len(group.jobs)
    # elastic gangs make the barrier at gang_min STARTED members — the
    # gang is legally whole at any count in [min, max] (docs/GANG.md
    # elasticity); rigid gangs read lo == size, unchanged
    lo, hi = gang_bounds(group)
    barrier = None
    if started >= (lo or size):
        barrier = "released"
    elif placed:
        barrier = "pending"
    out = {"size": size,
           "topology": group.gang_topology,
           "policy": group.gang_policy,
           "members_placed": placed,
           "members_running": running,
           "barrier": barrier}
    if gang_is_elastic(group):
        out["min"] = lo
        out["max"] = hi
    if cache is not None:
        cache[group.uuid] = out
    return out
