"""The port's copy of ``cook_tpu/sched/elastic.py`` (imports re-rooted).

Elastic gangs: the resize plane between placement and cluster goodput.

The gang subsystem (docs/GANG.md) placed a gang at exactly ``gang_size``
or not at all.  Long-running elastic training jobs (Pollux, OSDI'21;
Gandiva, OSDI'18) want the shape this module adds: a gang declares
``gang_min <= size <= gang_max`` and

- **places** whole at any member count in ``[min, max]`` (the segment
  reduction in ``ops/gang.py`` gates on min; surplus members keep their
  placements);
- **grows** into spare capacity: once a gang runs at >= min live
  members ("satisfied"), its remaining waiting members admit like
  group-less singles — the ordinary match path IS the grow mechanism,
  metered by the per-pool grow budget the optimizer loop sets;
- **shrinks** under pressure instead of dying: the rebalancer prices an
  elastic gang's surplus members individually (post-shrink size) and
  sheds them through the checkpoint/grace protocol below rather than
  killing the whole gang.

Checkpoint/grace shrink protocol (the agent side lives in
``agent/executor.py``):

1. the scheduler picks a surplus member and calls
   :meth:`ElasticManager.request_shrink`;
2. the member's cluster gets a best-effort ``notify_task`` (the agent
   delivers SIGUSR1 to the task's process group and appends a
   ``shrink`` event to the ``COOK_GANG_RESIZE_FILE`` advertised in the
   task environment) so the workload can checkpoint;
3. after ``elastic.shrink_grace_seconds`` the member's instance is
   transacted FAILED with the mea-culpa ``gang-resized`` reason and
   backend-killed.  The gang policy never reacts to ``gang-resized``
   (the gang stays whole at its post-shrink size), and the member —
   back in WAITING — is the first candidate to grow the gang again
   when capacity frees.

A leader crash between (2) and (3) loses only the in-memory deadline:
the victim keeps running, and the successor's rebalancer/optimizer
re-decides — a shrink can be delayed by failover, never half-applied
(the ``sim --chaos --elastic`` leg asserts exactly this).

The per-pool **grow budgets** and **shrink pressure** are the levers
the real optimizer loop (``sched/optimizer.py`` GoodputOptimizer)
actually pulls; both default to "unbounded grow, no pressure" so a
deployment without the optimizer behaves like plain elastic matching.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..state.schema import (
    InstanceStatus,
    Reasons,
    gang_bounds,
    gang_is_elastic,
)
from ..utils.metrics import registry

#: lock rank 18 (utils/locks.py contract table): below ``store`` (20)
#: so an accidental store call under the ledger lock still acquires in
#: ascending rank — by design the ledger sections hold no other lock.
_LOCK_NAME = "elastic"

INF = float("inf")


def satisfied_gangs(store, groups: Dict[str, object]) -> Optional[set]:
    """Group uuids of ELASTIC gangs in ``groups`` currently running at
    >= gang_min live members — their waiting members are the grow path
    (docs/GANG.md elasticity).  None when no group is elastic, so the
    rigid-only workload pays one generator scan and no store reads
    (decision-parity guard: rigid packs are built identically)."""
    elastic = [g for g in groups.values() if gang_is_elastic(g)]
    if not elastic:
        return None
    out = set()
    for g in elastic:
        lo, _hi = gang_bounds(g)
        if store.gang_live_members(g.uuid) >= lo:
            out.add(g.uuid)
    return out or None


class ElasticManager:
    """Resize ledger + budgets: pending grace shrinks, per-pool grow
    budgets / shrink pressure (set by the optimizer), and the
    ``cook_gang_resize_total`` accounting.  Owned by the scheduler;
    shared with the rebalancer (shrink-instead-of-kill) and the match
    paths (grow metering)."""

    def __init__(self, store, elastic_config=None):
        from ..utils.locks import named_lock
        self.store = store
        self.config = elastic_config
        self._mu = named_lock(_LOCK_NAME)
        # task_id -> {"deadline_ms", "gang", "cluster", "reason"}
        self._pending: Dict[str, Dict] = {}
        # optimizer-set levers (pool -> value); absent = default
        self.grow_budget: Dict[str, float] = {}
        self.shrink_pressure: Dict[str, int] = {}
        # per-cycle grow slots left (reset by start_pool_cycle)
        self._grow_left: Dict[str, float] = {}
        self.grows = 0
        self.shrinks = 0
        self.grace_expiries = 0

    # ------------------------------------------------------------- config
    @property
    def enabled(self) -> bool:
        return self.config is None or getattr(self.config, "enabled", True)

    def _grace_ms(self) -> float:
        if self.config is None:
            return 0.0
        return float(getattr(self.config, "shrink_grace_seconds", 0.0)) \
            * 1000.0

    # ---------------------------------------------------------- grow plane
    def start_pool_cycle(self, pool: str) -> None:
        """Reset the pool's per-cycle grow meter to the optimizer's
        budget (unbounded when the optimizer set none)."""
        self._grow_left[pool] = self.grow_budget.get(pool, INF)

    def admit_grow(self, pool: str) -> bool:
        """Consume one grow slot for ``pool`` this cycle; False when the
        optimizer's budget is exhausted (the member waits a cycle with
        the ``gang-grow-deferred`` skip reason)."""
        left = self._grow_left.get(pool, INF)
        if left <= 0:
            return False
        self._grow_left[pool] = left - 1
        return True

    def note_grow(self, pool: str, n: int = 1,
                  reason: str = "capacity") -> None:
        """A satisfied gang gained ``n`` launched members (observed off
        the launch tx events, so the rigid path pays nothing)."""
        self.grows += n
        registry.counter_inc("cook_gang_resize", float(n),
                             labels={"direction": "grow",
                                     "reason": reason})

    # -------------------------------------------------------- shrink plane
    def request_shrink(self, task_id: str, job_uuid: str, gang_uuid: str,
                       cluster_name: str, clusters: Dict,
                       reason: str = "pressure",
                       facts: Optional[Dict] = None) -> bool:
        """Begin the checkpoint/grace shrink of one surplus member: the
        agent is notified (SIGUSR1 + resize-file event, best-effort),
        the decision lands on the member's audit timeline, and the kill
        executes after the grace deadline (immediately at grace 0).
        Idempotent per task; False when the task is already shrinking."""
        now = self.store.clock()
        grace_ms = self._grace_ms()
        with self._mu:
            if task_id in self._pending:
                return False
            self._pending[task_id] = {
                "deadline_ms": now + grace_ms, "gang": gang_uuid,
                "cluster": cluster_name, "reason": reason,
                "job": job_uuid}
        self.shrinks += 1
        registry.counter_inc("cook_gang_resize",
                             labels={"direction": "shrink",
                                     "reason": reason})
        self.store.audit.record(job_uuid, "gang-resize", {
            "direction": "shrink", "task": task_id, "gang": gang_uuid,
            "reason": reason, "grace_ms": grace_ms,
            **(facts or {})}, durable=True)
        cluster = clusters.get(cluster_name)
        if cluster is not None:
            try:
                cluster.notify_task(task_id, {
                    "kind": "gang-resize", "direction": "shrink",
                    "gang": gang_uuid, "grace_ms": grace_ms,
                    "reason": reason})
            except Exception:  # pragma: no cover - notify is best-effort
                pass
        if grace_ms <= 0:
            self._execute_shrink(task_id, clusters)
        return True

    def _execute_shrink(self, task_id: str, clusters: Dict) -> None:
        with self._mu:
            entry = self._pending.pop(task_id, None)
        if entry is None:
            return
        inst = self.store.instance(task_id)
        if inst is None or inst.status not in (InstanceStatus.UNKNOWN,
                                               InstanceStatus.RUNNING):
            return  # completed/killed during the grace window: no-op
        # authoritative store transition first (single-writer
        # discipline), then the backend kill — exactly _kill_instance's
        # order, with the resize-specific mea-culpa reason
        self.store.update_instance_status(
            task_id, InstanceStatus.FAILED,
            reason_code=Reasons.GANG_RESIZED.code, preempted=True)
        cluster = clusters.get(entry["cluster"])
        if cluster is not None:
            try:
                cluster.safe_kill_task(task_id)
            except Exception:  # pragma: no cover - reapers converge it
                pass

    def sweep(self, clusters: Dict,
              now_ms: Optional[int] = None) -> List[str]:
        """Execute every pending shrink whose grace deadline passed
        (docs/ROBUSTNESS.md "checkpoint-grace expiry").  Returns the
        task ids shed this sweep."""
        now = now_ms if now_ms is not None else self.store.clock()
        with self._mu:
            due = [tid for tid, e in self._pending.items()
                   if e["deadline_ms"] <= now]
        for tid in due:
            self.grace_expiries += 1
            self._execute_shrink(tid, clusters)
        return due

    def pending_shrinks(self) -> Dict[str, Dict]:
        with self._mu:
            return {tid: dict(e) for tid, e in self._pending.items()}

    def shrinking(self, task_id: str) -> bool:
        with self._mu:
            return task_id in self._pending

    # ------------------------------------------------- optimizer pressure
    def apply_pressure(self, pool: str, clusters: Dict,
                       decision_facts: Optional[Dict] = None) -> int:
        """Shed up to ``shrink_pressure[pool]`` surplus members of the
        pool's elastic gangs — the optimizer's shrink lever.  Surplus =
        live members above gang_min; the newest-launched members go
        first (they hold the least progress).  Returns the number of
        shrinks requested; the pressure is consumed by what it sheds."""
        budget = int(self.shrink_pressure.get(pool, 0))
        if budget <= 0:
            return 0
        # members already pending a grace shrink are NOT surplus twice:
        # their kills are committed, and shedding "surplus" that is
        # mid-shrink would take the gang below gang_min once every
        # pending kill executes (same netting the rebalancer does)
        with self._mu:
            pending_by_gang: Dict[str, int] = {}
            for e in self._pending.values():
                g = e.get("gang")
                pending_by_gang[g] = pending_by_gang.get(g, 0) + 1
        shed = 0
        for group in self.store.elastic_gang_groups():
            if shed >= budget:
                break
            lo, _hi = gang_bounds(group)
            live: List[Tuple[int, str, str, str, str]] = []
            for member_uuid in group.jobs:
                job = self.store.job(member_uuid)
                if job is None or job.pool != pool:
                    continue
                for tid in job.instances:
                    inst = self.store.instance(tid)
                    if inst is not None and inst.status in (
                            InstanceStatus.UNKNOWN,
                            InstanceStatus.RUNNING):
                        live.append((inst.start_time_ms or 0, tid,
                                     member_uuid, inst.compute_cluster,
                                     group.uuid))
            surplus = len(live) - lo - pending_by_gang.get(group.uuid, 0)
            if surplus <= 0:
                continue
            live.sort(reverse=True)  # newest first: least progress lost
            for start_ms, tid, member_uuid, cluster_name, guuid \
                    in live[:min(surplus, budget - shed)]:
                if self.shrinking(tid):
                    continue
                if self.request_shrink(
                        tid, member_uuid, guuid, cluster_name, clusters,
                        reason="optimizer", facts=decision_facts):
                    shed += 1
        if shed:
            self.shrink_pressure[pool] = max(budget - shed, 0)
        return shed

    # ------------------------------------------------------------ surfaces
    def debug(self) -> Dict:
        with self._mu:
            pending = {tid: {k: v for k, v in e.items()}
                       for tid, e in self._pending.items()}
        return {
            "enabled": self.enabled,
            "pending_shrinks": pending,
            "grow_budget": {p: (None if b == INF else b)
                            for p, b in self.grow_budget.items()},
            "shrink_pressure": dict(self.shrink_pressure),
            "grows": self.grows,
            "shrinks": self.shrinks,
            "grace_expiries": self.grace_expiries,
        }
