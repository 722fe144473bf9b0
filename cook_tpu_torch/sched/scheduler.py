"""The port of ``cook_tpu/sched/scheduler.py``'s cycle surface: the
scheduler wires store, clusters, ranker, matcher, rebalancer and the
production cycle driver.

The equivalent of the reference's leader process (reference:
create-datomic-scheduler scheduler.clj:2473-2522 + the cycle triggers
mesos.clj:89-110).  Cycles are explicit ``step_*`` methods:

 - ``step_cycle``: the production cycle, every non-direct pool's rank +
   admission + match in one fused dispatch (kernels K1-K6 on a card),
   through the pipelined driver at ``config.pipeline.depth`` > 0 (the
   default, 2) or the synchronous driver at 0;
 - ``step_rank`` / ``step_match``: the split cycle (``Ranker``,
   ``Matcher``);
 - ``step_rebalance``: the preemption cycle (``Rebalancer``).

Every device entry point runs on ``device`` (default ``"cuda"``; without
a card that default raises).  A failed fused cycle degrades as the
reference's does: the pipeline and the device-resident state are dropped
and that cycle runs the split path (``step_rank`` + ``step_match``) on the
same device, so on a card kernels K2, K3 and K5 still place it.  A failure
of the split path itself reaches the caller.

``step_resize`` (the elastic resize pass), ``step_reapers`` and the
monitor's ``sweep`` (``sched/monitor.py``, which also feeds the adaptive
``AdmissionController`` of ``sched/admission.py`` when
``config.admission.enabled``) complete the leader's loop, and ``run()``
drives all of them on wall-clock threads like the reference's chime
channels.

Responsibilities wired here:
 - status updates: cluster backends -> store state machines, optionally
   through the sharded status queue (``native.make_watch_queue``)
 - tx-feed side effects: job completed -> kill its live instances
   (reference: monitor-tx-report-queue scheduler.clj:378-448)
 - the gang policy and gang barrier bookkeeping
 - per-pool rank queue (reference: pool-name->pending-jobs-atom)
 - direct-mode pools: backpressure submission without matching
   (reference: handle-kubernetes-scheduler-pool scheduler.clj:1747)
 - reapers: lingering-task killer (max-runtime, scheduler.clj:1888-1953)
   and straggler handler (scheduler.clj:1955-1986, group.clj)

Not ported (each named in ROADMAP.md, queue 1): the optimizer
(``step_optimize``; the constructor raises when ``config.optimizer`` is
set) and ``warmup_kernels`` (the constructor raises when the pipeline's
warmup or compilation-cache knobs are set).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import resolve_device
from ..cluster.base import ComputeCluster, LaunchSpec
from ..config import Config, refuse_unported
from ..state.schema import (
    InstanceStatus,
    Job,
    JobState,
    Pool,
    Reasons,
    SchedulerKind,
    new_uuid,
    now_ms,
)
from ..state.store import AbortTransaction, Store
from ..utils import tracing
from ..utils.flight import recorder as flight_recorder
from .matcher import MatchCycleResult, Matcher, _BackoffState
from .ranker import Ranker
from .rebalancer import Rebalancer


class Scheduler:
    def __init__(self, store: Store, config: Optional[Config] = None,
                 clusters: Optional[List[ComputeCluster]] = None,
                 rank_backend: str = "tpu", plugins=None, rate_limits=None,
                 status_queue_shards: Optional[int] = None,
                 shard_id: Optional[int] = None, device="cuda"):
        from ..policy import PluginRegistry, RateLimits
        self.store = store
        self.config = config or Config()
        # the device every device path of this scheduler runs on
        self.device = resolve_device(device)
        # the reference's planes this port does not have raise here (the
        # node's boot makes the same check) instead of being ignored
        refuse_unported(self.config)
        # sharded-controller identity (one partition = one process = one
        # mesh shard).  Process-wide, not per-scheduler: a shard worker
        # runs exactly one scheduler, and everything the shard emits —
        # CycleRecords, spans — must carry the same id whether or not it
        # passed through this object.
        self.shard_id = shard_id
        if shard_id is not None:
            from ..utils import flight
            flight.set_shard(shard_id)
        # fault-injection + breaker policy are config planes the scheduler
        # owns applying (docs/ROBUSTNESS.md): arming is explicit opt-in
        from ..utils.faults import injector as _faults
        from ..utils.retry import breakers as _breakers
        if self.config.faults.enabled:
            _faults.configure({"seed": self.config.faults.seed,
                               "points": self.config.faults.points})
        _breakers.configure(
            failure_threshold=self.config.circuit_breaker.failure_threshold,
            reset_timeout_s=self.config.circuit_breaker.reset_timeout_s)
        self.breakers = _breakers
        # per-job audit trail knobs (utils/audit.py): the trail lives on
        # the store (it must survive into a successor's replay), the
        # scheduler owns applying the config like faults/breakers
        store.audit.configure(self.config.audit)
        self.plugins = plugins or PluginRegistry()
        self.rate_limits = rate_limits or RateLimits()
        self.clusters: Dict[str, ComputeCluster] = {}
        self.ranker = Ranker(store, self.config, backend=rank_backend,
                             device=self.device)
        self.matcher = Matcher(store, self.config, plugins=self.plugins,
                               rate_limits=self.rate_limits,
                               device=self.device)
        self.rebalancer = Rebalancer(store, self.config, backend=rank_backend,
                                     device=self.device)
        # elastic resize plane (sched/elastic.py, docs/GANG.md
        # elasticity): grace-shrink ledger + the grow/shrink budgets the
        # optimizer loop sets; shared with the matcher (grow metering)
        # and the rebalancer (shrink-instead-of-kill)
        from .elastic import ElasticManager
        self.elastic = ElasticManager(store, self.config.elastic)
        if self.config.elastic.enabled:
            self.matcher.elastic = self.elastic
            self.rebalancer.elastic = self.elastic
        # the optimizer loop is not ported (refuse_unported)
        self.optimizer_cycler = None
        from .monitor import Monitor
        self.monitor = Monitor(store, config=self.config)
        # launch-token saturation input (sched/fleet.py): the sweep
        # reads the same buckets the matcher admits against
        self.monitor.rate_limits = self.rate_limits
        # adaptive admission + brownout ladder (sched/admission.py):
        # leader-only — the controller recovers any journaled brownout
        # stage at construction, and each monitor sweep feeds it the
        # saturation gauges.  None when the section is disabled.
        self.admission = None
        if self.config.admission.enabled:
            from .admission import AdmissionController
            self.admission = AdmissionController(
                store, self.config, rate_limits=self.rate_limits)
            self.monitor.admission = self.admission
            # head-of-queue scaleback: the matcher shrinks its
            # considerable window by the admission level under pressure
            self.matcher.admission = self.admission
        from .heartbeat import HeartbeatTracker
        self.heartbeats = HeartbeatTracker(self.config.heartbeat_timeout_ms)
        # Heartbeat stamps and reaper sweeps follow the store's injectable
        # clock (one patch point: the simulator swaps store.clock for its
        # virtual clock and everything stays in one timebase).
        self.clock = lambda: self.store.clock()
        # pool -> ranked pending jobs, refreshed by the rank cycle
        self.pending_queues: Dict[str, List[Job]] = {}
        # pool -> last MatchCycleResult, feeds the unscheduled explainer
        self.last_match_results: Dict[str, MatchCycleResult] = {}
        # job uuid -> reserved hostname from the rebalancer
        self.reserved_hosts: Dict[str, str] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # fused production cycle driver, created lazily on first step_cycle;
        # _pipeline wraps it when config.pipeline.depth > 0 (the pipelined
        # optimistic driver, sched/pipeline.py)
        self._fused = None
        self._pipeline = None
        # GC discipline for the production cycle: with 100k+ live entities
        # the interpreter's automatic gen2 collections (full scans of a
        # multi-million-object heap) land mid-cycle and double the p99.
        # step_cycle pauses automatic collection for its duration and
        # schedules a proactive collect + freeze OUTSIDE the cycle (in
        # flush_status_updates / the next idle point).  Entities are
        # acyclic, so ordinary refcounting frees them regardless; the
        # cycle-collector is only needed for rare cyclic garbage.
        self.gc_discipline = True
        self._gc_cycles = 0
        self._gc_collect_due = False
        # gang scheduling bookkeeping (docs/GANG.md): task -> gang group
        # uuid (populated from the launch event's gang tag, so non-gang
        # traffic pays nothing), and per-gang barrier state — a gang's
        # barrier "releases" when every member is RUNNING; the wait is
        # observed on cook_gang_barrier_wait_ms
        self._gang_of_task: Dict[str, str] = {}
        self._gang_barrier: Dict[str, Dict] = {}
        # groups whose gang policy is mid-reaction: our own kill_job
        # calls commit synchronously and re-enter _on_tx_events, which
        # must not count (or act) as a fresh policy reaction
        self._gang_policy_active: set = set()
        # backend class -> whether autoscale() takes a gangs= kwarg; the
        # backend set is fixed at construction, so probe each class once
        self._autoscale_takes_gangs: Dict[type, bool] = {}
        # task_id -> first-seen-orphaned ms (reaper grace bookkeeping)
        self._orphan_first_seen: Dict[str, int] = {}
        # Side-effect worker: cluster kills requested from a thread that
        # already holds that cluster's kill-lock read side (e.g. a tx-event
        # delivered during a launch) must run elsewhere or they self-deadlock.
        self._side_effects: "queue.Queue" = queue.Queue()
        self._side_effect_thread: Optional[threading.Thread] = None
        # Optional sharded in-order status processing (the reference's 19
        # hash-sharded agents, scheduler.clj:2370-2396; native C++ executor
        # when available). None = synchronous, for deterministic stepping.
        self._status_queue = None
        if status_queue_shards:
            from ..native import make_watch_queue
            self._status_queue = make_watch_queue(
                self._apply_status_payload, status_queue_shards)
        store.subscribe(self._on_tx_events)
        for cluster in clusters or []:
            self.add_cluster(cluster)
        if not store.pools():
            store.put_pool(Pool(name=self.config.default_pool))
        # Resume path: instances already live in a reopened store predate
        # this scheduler's tx subscription, so watch them now.
        running = store.running_instances()
        gangs = store.gang_groups_of(j for j, _i in running)
        for _job, inst in running:
            self.heartbeats.watch(inst.task_id, self.clock())
            # re-learn gang membership so barrier release + gang policy
            # keep working across a leader handoff
            if _job.group in gangs:
                self._gang_of_task[inst.task_id] = _job.group
                self._gang_barrier.setdefault(
                    _job.group, {"first_live_ms": self.clock(),
                                 "released": False})
        # Crash-consistency: sweep launch intents the previous leader left
        # open (died between match and launch-ack) against actual cluster
        # state — refund or adopt, never duplicate, never lose.
        self.reconcile_launch_intents()

    # ---------------------------------------------------------------- wiring
    def add_cluster(self, cluster: ComputeCluster) -> None:
        cluster.initialize(self._on_status_update)
        self.clusters[cluster.name] = cluster

    def launchable_clusters(self, pool_name: str) -> List[ComputeCluster]:
        """Clusters accepting ``pool_name`` whose circuit breaker allows
        launches.  A tripped breaker's cluster contributes no offers, so
        the matcher routes its demand at healthy clusters; the skip is
        noted on the cycle record (a degraded cycle explains itself)."""
        out: List[ComputeCluster] = []
        skipped = 0
        for cluster in list(self.clusters.values()):
            if not cluster.accepts_pool(pool_name):
                continue
            if not self.breakers.get(cluster.name).allow():
                skipped += 1
                continue
            out.append(cluster)
        if skipped:
            flight_recorder.note_fault("breaker-open", skipped)
        return out

    def reconcile_launch_intents(self) -> int:
        """Leader-startup sweep of open launch intents (store records for
        dispatches never confirmed).  For each intent:

        - instance missing or already past UNKNOWN -> the dispatch (or
          its failure) was observed; just drop the intent;
        - owning cluster positively knows the task -> adopt (drop intent,
          status updates flow normally);
        - owning cluster positively does NOT know the task, or is gone ->
          the crash window hit between match and launch-ack: fail the
          instance mea-culpa (CANCELLED_DURING_LAUNCH) so the job
          relaunches exactly once with no retry-budget charge;
        - cluster cannot enumerate its tasks -> leave the verdict to that
          backend's own reconciliation (remote NODE_LOSTs unknown tasks on
          reconnect) and drop the intent.

        Gang intents (tagged with their gang group uuid) are swept as
        ONE unit: any member refunded refunds every member still in the
        crash window — the sweep rolls back or adopts whole gangs, never
        leaving a partial gang live (docs/GANG.md).  Members already
        past the window are cleaned up by the gang policy reacting to
        the refunds' failure events.
        """
        swept = 0
        to_clear: List[str] = []
        # verdict pass: (task_id, refund?, gang uuid, cluster known task?)
        verdicts: List[Tuple[str, bool, str, Optional[bool]]] = []
        for intent in self.store.launch_intents():
            task_id = intent["task_id"]
            inst = self.store.instance(task_id)
            if inst is not None and inst.status is InstanceStatus.UNKNOWN:
                cluster = self.clusters.get(
                    intent.get("compute_cluster", ""))
                enumerate_tasks = getattr(cluster, "running_task_ids", None)
                known = None
                if enumerate_tasks is not None:
                    try:
                        ids = enumerate_tasks()
                        # None = the backend cannot POSITIVELY enumerate
                        # right now (e.g. an agent unreachable at
                        # startup): absence proves nothing, defer
                        known = (task_id in set(ids)
                                 if ids is not None else None)
                    except Exception:
                        known = None
                verdicts.append((task_id, known is False or cluster is None,
                                 intent.get("gang", ""), known))
            else:
                to_clear.append(task_id)
            swept += 1
        refund_gangs = {g for _t, refund, g, _k in verdicts if g and refund}
        for task_id, refund, gang, known in verdicts:
            if refund or gang in refund_gangs:
                # the refund's status update deletes the intent in
                # its own transaction; no separate clear needed
                self.store.update_instance_status(
                    task_id, InstanceStatus.FAILED,
                    reason_code=Reasons.CANCELLED_DURING_LAUNCH.code)
                if not refund:
                    # a gang-mate dragged down by a refunded sibling:
                    # the backend may know it (known True) or be unable
                    # to say (known None — an unreachable agent could
                    # still be running it); either way issue the
                    # idempotent backend kill so no zombie double-runs
                    # the work when the gang relaunches
                    inst = self.store.instance(task_id)
                    if inst is not None:
                        self._cluster_kill(inst.compute_cluster, task_id)
            else:
                to_clear.append(task_id)
        # ONE transaction for every adopt/drop (a crash can leave
        # hundreds of intents; per-intent journaled txns would serialize
        # the new leader's startup)
        self.store.clear_launch_intents(to_clear)
        if swept:
            from ..utils.metrics import registry
            registry.counter_inc("cook_launch_intents_swept", float(swept))
            flight_recorder.note_fault("launch-intents-swept", swept)
        return swept

    def _on_status_update(self, task_id: str, status: InstanceStatus,
                          reason_code: Optional[int], exit_code=None,
                          preempted: bool = False, hostname=None) -> None:
        payload = (status, reason_code, exit_code, preempted, hostname)
        if self._status_queue is not None:
            self._status_queue.submit(task_id, payload)
        else:
            self._apply_status_payload(task_id, payload)

    def _apply_status_payload(self, task_id: str, payload) -> None:
        status, reason_code, exit_code, preempted, hostname = payload
        if status is InstanceStatus.RUNNING:
            self.heartbeats.beat(task_id, self.clock())
        self.store.update_instance_status(
            task_id, status, reason_code=reason_code, exit_code=exit_code,
            preempted=preempted, hostname=hostname)

    def heartbeat(self, task_id: str) -> None:
        """Explicit liveness signal from an executor/sidecar (progress
        frames route here too, matching the reference where any framework
        message resets the heartbeat timer, heartbeat.clj:100-123)."""
        from ..utils.faults import injector as _faults
        if _faults.should_fire("agent.heartbeat"):
            return  # injected delivery loss: the frame never arrives
        self.heartbeats.beat(task_id, self.clock())

    def flush_status_updates(self) -> None:
        if self._status_queue is not None:
            self._status_queue.flush()
        self.maintain_gc()

    def maintain_gc(self) -> None:
        """Proactive full collection at an idle point (see gc_discipline in
        __init__): freeze afterwards so the stable entity heap is never
        re-scanned — acyclic entities free by refcount anyway.  Called by
        the production cycle loop after each step_cycle and by
        flush_status_updates (tests/bench pacing)."""
        if self._gc_collect_due:
            self._gc_collect_due = False
            import gc
            gc.collect()
            gc.freeze()

    def _on_tx_events(self, tx_id: int, events) -> None:
        """Kill live instances of jobs that reached completed — covers user
        kills and retroactive cleanup (scheduler.clj:405-447)."""
        for e in events:
            if e.kind == "job-state" and e.data.get("new") == "completed":
                job = self.store.job(e.data["uuid"])
                if job is None:
                    continue
                for tid in job.instances:
                    inst = self.store.instance(tid)
                    if inst is None or inst.status not in (
                            InstanceStatus.UNKNOWN, InstanceStatus.RUNNING):
                        continue
                    # ensure the store converges even with a dead backend
                    self.store.update_instance_status(
                        tid, InstanceStatus.FAILED,
                        reason_code=Reasons.KILLED_BY_USER.code)
                    self._cluster_kill(inst.compute_cluster, tid)
                # a gang member that went terminal WITHOUT ever succeeding
                # (user kill while WAITING, say) breaks its gang for good.
                # Instance-failure events cover members that had
                # instances, but a WAITING kill emits none — take the
                # rest of the gang down here or the siblings would sit
                # gang-deferred forever.  (Members that completed after a
                # SUCCESS are normal staggered finishes, not a break; a
                # redundant call is a no-op once every member is
                # terminal.)
                if self.store.group_is_gang(job.group) and not any(
                        (i := self.store.instance(t)) is not None
                        and i.status is InstanceStatus.SUCCESS
                        for t in job.instances):
                    self._apply_gang_policy(job, None)
            if e.kind == "job-state" and e.data.get("new") in (
                    "running", "completed"):
                # consume rebalancer reservations once the job launches —
                # or release them if the job dies while still waiting
                self.reserved_hosts.pop(e.data.get("uuid"), None)
            if e.kind == "instance-created":
                # start the heartbeat clock at launch (heartbeat.clj:92)
                self.heartbeats.watch(e.data["task_id"], self.clock())
                # gang bookkeeping rides the event's gang tag so the
                # non-gang launch path fetches nothing extra
                guuid = e.data.get("gang")
                if guuid:
                    self._gang_of_task[e.data["task_id"]] = guuid
                    st = self._gang_barrier.setdefault(
                        guuid, {"first_live_ms": self.clock(),
                                "released": False})
                    if st.get("released"):
                        # a member launched AFTER the barrier released:
                        # a satisfied ELASTIC gang grew into capacity
                        # (docs/GANG.md elasticity).  Gated on
                        # elasticity: a rigid gang relaunching after a
                        # whole-gang requeue also lands here (the
                        # barrier entry persists released), and that is
                        # a retry, not a resize.
                        from ..state.schema import gang_is_elastic
                        group = self.store.group(guuid)
                        if group is not None and gang_is_elastic(group):
                            job = self.store.job(e.data.get("job", ""))
                            self.elastic.note_grow(
                                job.pool if job is not None else "")
            if e.kind == "instance-status" and e.data.get("new") == "running":
                guuid = self._gang_of_task.get(e.data["task_id"])
                if guuid:
                    self._maybe_release_gang_barrier(guuid)
            if e.kind == "instance-status" and e.data.get("new") in (
                    "success", "failed"):
                self.heartbeats.forget(e.data["task_id"])
                self._gang_of_task.pop(e.data["task_id"], None)
                # InstanceCompletionHandler plugins (plugins/definitions.clj)
                inst = self.store.instance(e.data["task_id"])
                job = self.store.job(e.data["job"]) if inst else None
                if inst is not None and job is not None:
                    self.plugins.on_instance_completion(job, inst)
                if (e.data.get("new") == "failed" and job is not None
                        and self.store.group_is_gang(job.group)):
                    self._apply_gang_policy(job, e.data.get("reason"))
                if (job is not None and job.group is not None
                        and job.group in self._gang_barrier
                        and job.state is JobState.COMPLETED):
                    # retire the barrier entry once the whole gang is
                    # terminal — it would otherwise leak one dict entry
                    # per finished gang for the leader's lifetime
                    group = self.store.group(job.group)
                    if group is not None and all(
                            (m := self.store.job(u)) is None
                            or m.state is JobState.COMPLETED
                            for u in group.jobs):
                        self._gang_barrier.pop(job.group, None)

    # ------------------------------------------------------------------ gangs
    def _apply_gang_policy(self, failed_job: Job,
                           reason_code: Optional[int]) -> None:
        """A gang member's instance failed: run the configured gang
        policy (state/machines.gang_failure_action, docs/GANG.md).
        ``requeue`` (default) kills every sibling's live instances with
        the mea-culpa ``gang-member-lost`` reason so the WHOLE gang
        returns to WAITING and relaunches atomically; ``kill`` — or a
        member whose job went terminal — takes the whole gang down.
        An ELASTIC gang still holding >= gang_min live members absorbs
        the loss as an implicit shrink instead (docs/GANG.md
        elasticity); the live count is only fetched for elastic groups
        so rigid gangs pay nothing new."""
        from ..state import machines
        from ..state.schema import gang_is_elastic
        group = self.store.group(failed_job.group)
        live = self.store.gang_live_members(group.uuid) \
            if group is not None and gang_is_elastic(group) else None
        action = machines.gang_failure_action(group, reason_code,
                                              failed_job.state,
                                              live_members=live)
        if action == "none":
            if live is not None \
                    and reason_code not in (Reasons.GANG_RESIZED.code,
                                            Reasons.GANG_MEMBER_LOST.code):
                # an elastic gang absorbed a member failure as a shrink
                from ..utils.metrics import registry
                registry.counter_inc("cook_gang_resize", labels={
                    "direction": "shrink", "reason": "member-lost"})
            return
        if action == "requeue" and any(
                u != failed_job.uuid
                and (m := self.store.job(u)) is not None
                and m.state is JobState.COMPLETED
                for u in group.jobs):
            # a sibling that already finished (a short member exiting
            # SUCCESS mid-gang is a normal staggered finish) can never
            # run again, so the gang can never re-admit whole —
            # requeueing would strand the live members in WAITING
            # forever behind a members-missing deferral
            action = "kill"
        if group.uuid in self._gang_policy_active:
            return
        self._gang_policy_active.add(group.uuid)
        try:
            self._run_gang_policy(group, action, failed_job)
        finally:
            self._gang_policy_active.discard(group.uuid)

    def _run_gang_policy(self, group, action: str, failed_job: Job) -> None:
        # collect what there actually is to do FIRST: a whole-gang
        # failure (e.g. rebalancer preemption of the full closure)
        # delivers one failure event per member, and only the first
        # should count as a policy reaction — the rest find nothing
        # left to kill and must not inflate the metric or re-loop
        if action == "kill":
            targets = [u for u in group.jobs
                       if (m := self.store.job(u)) is not None
                       and m.state is not JobState.COMPLETED]
            if not targets:
                return
            self._gang_barrier.pop(group.uuid, None)
            from ..utils.metrics import registry
            registry.counter_inc("cook_gang_policy_kills",
                                 labels={"action": action})
            for member_uuid in targets:
                try:
                    self.store.kill_job(member_uuid)
                except Exception:  # pragma: no cover - converges next sweep
                    pass
            return
        live: List[Tuple[str, str]] = []  # (task_id, cluster)
        for member_uuid in group.jobs:
            if member_uuid == failed_job.uuid:
                continue
            member = self.store.job(member_uuid)
            if member is None:
                continue
            for tid in member.instances:
                mi = self.store.instance(tid)
                if mi is not None and mi.status in (
                        InstanceStatus.UNKNOWN, InstanceStatus.RUNNING):
                    live.append((tid, mi.compute_cluster))
        if not live:
            return
        self._gang_barrier.pop(group.uuid, None)  # barrier re-arms
        from ..utils.metrics import registry
        registry.counter_inc("cook_gang_policy_kills",
                             labels={"action": action})
        for tid, cluster_name in live:
            # authoritative store transition first (single-writer
            # discipline, like _kill_instance), then the backend kill
            self.store.update_instance_status(
                tid, InstanceStatus.FAILED,
                reason_code=Reasons.GANG_MEMBER_LOST.code)
            self._cluster_kill(cluster_name, tid)

    def _maybe_release_gang_barrier(self, guuid: str) -> None:
        """Release the gang's barrier once every REQUIRED member has
        STARTED — currently RUNNING, or already finished a run (a short
        member can exit SUCCESS before the last member comes up;
        requiring all members to be simultaneously RUNNING would then
        block release forever).  Rigid gangs require every member;
        ELASTIC gangs make the barrier at ``gang_min`` started members
        (docs/GANG.md elasticity — the gang is legally whole there).
        The wait (first launch -> barrier) is observed on
        ``cook_gang_barrier_wait_ms``."""
        st = self._gang_barrier.get(guuid)
        if st is None or st.get("released"):
            return
        group = self.store.group(guuid)
        if group is None:
            return
        from ..state.schema import gang_bounds
        need = gang_bounds(group)[0] or len(group.jobs)
        started_n = 0
        for member_uuid in group.jobs:
            member = self.store.job(member_uuid)
            if member is None:
                continue
            started = any(
                (mi := self.store.instance(tid)) is not None
                and (mi.status is InstanceStatus.RUNNING
                     or (member.state is JobState.COMPLETED
                         and (mi.status is InstanceStatus.SUCCESS
                              or mi.mesos_start_time_ms)))
                for tid in member.instances)
            if started:
                started_n += 1
                if started_n >= need:
                    break
        if started_n < need:
            return
        st["released"] = True
        st["released_ms"] = self.clock()
        from ..utils.metrics import registry
        registry.observe(
            "cook_gang_barrier_wait_ms",
            float(max(self.clock() - st["first_live_ms"], 0)),
            buckets=(1.0, 10.0, 100.0, 1000.0, 10_000.0, 60_000.0,
                     600_000.0))

    # ---------------------------------------------------------------- cycles
    def step_rank(self) -> Dict[str, List[Job]]:
        """Rank cycle across all schedulable pools (reference: rank-jobs +
        reset! pool-name->pending-jobs-atom, scheduler.clj:2286-2296)."""
        queues: Dict[str, List[Job]] = {}
        with flight_recorder.cycle(kind="rank"), tracing.span("rank.cycle"):
            for pool in self.store.pools():
                if pool.state != "active":
                    continue
                with tracing.span("rank.pool", pool=pool.name) as sp:
                    ranked = self.ranker.rank_pool(pool.name, pool.dru_mode)
                    sp.set_tag("jobs", len(ranked))
                queues[pool.name] = self._filter_offensive_jobs(ranked)
        self.pending_queues = queues
        return queues

    def _filter_offensive_jobs(self, ranked: List[Job]) -> List[Job]:
        """Drop jobs whose mem/cpus exceed the configured limits and abort
        them off-cycle, returning the inoffensive rest immediately
        (reference: filter-offensive-jobs + make-offensive-job-stifler,
        scheduler.clj:2205-2257)."""
        limits = self.config.offensive_job_limits
        if limits is None:
            return ranked
        max_mem_mb = limits.memory_gb * 1024.0
        from .ranker import RankedQueue
        if isinstance(ranked, RankedQueue):
            # columnar path: vectorized over the resource columns, no
            # full-queue entity materialization
            import numpy as np
            bad = ((ranked.resources[:, 1] > max_mem_mb)
                   | (ranked.resources[:, 0] > limits.cpus))
            if not bad.any():
                return ranked
            self._stifle_offensive(
                [j for j in (self.store.job(u)
                             for u in ranked.uuids[bad]) if j is not None])
            return ranked.filtered(~bad)
        offensive = [j for j in ranked
                     if j.resources.mem > max_mem_mb
                     or j.resources.cpus > limits.cpus]
        if not offensive:
            return ranked
        offensive_uuids = {j.uuid for j in offensive}
        self._stifle_offensive(offensive)
        return [j for j in ranked if j.uuid not in offensive_uuids]

    def _stifle_offensive(self, offensive: List[Job]) -> None:
        """Abort offensive jobs off-cycle (the stifler thread)."""
        if not offensive:
            return

        def stifle():
            for job in offensive:
                try:
                    self.store.kill_job(job.uuid)
                except Exception:
                    pass
        threading.Thread(target=stifle, daemon=True,
                         name="offensive-job-stifler").start()

    def _ensure_fused(self):
        """The fused driver (and, at pipeline_depth > 0, the pipelined
        optimistic wrapper around it), created lazily."""
        if self._fused is None:
            from .fused import FusedCycleDriver
            self._fused = FusedCycleDriver(
                self.store, self.config, self.matcher, self.plugins,
                self.rate_limits, device=self.device,
                shard_id=self.shard_id)
            if self.config.pipeline.depth > 0:
                from .pipeline import PipelinedCycleDriver
                self._pipeline = PipelinedCycleDriver(
                    self._fused, self.config.pipeline)
            # gauge emitted for BOTH drivers: a depth-0 deployment must
            # read 0 on /metrics, not be indistinguishable from a broken
            # scrape (docs/OBSERVABILITY.md documents "0 = sync")
            from ..utils.metrics import registry
            registry.gauge_set("cook_pipeline_depth",
                               float(self.config.pipeline.depth))
        return self._pipeline or self._fused

    def step_cycle(self) -> Dict[str, MatchCycleResult]:
        """PRODUCTION cycle: rank + admission + match for every active
        non-direct pool in ONE fused device dispatch
        (sched/fused.FusedCycleDriver: ``megacycle``, kernels K1-K6 on a
        card), then the transactional launch path on host.  Direct
        (Kenzo) pools keep the host path (there is no match kernel to
        fuse).

        With ``config.pipeline.depth > 0`` the dispatch is pipelined
        (sched/pipeline.py): while this cycle's launches are applied, the
        next cycle's kernels are already computing on the card against an
        optimistically-stale snapshot, reconciled host-side before launch.

        A failure inside the driver degrades the cycle to the split path
        (``step_rank`` + ``step_match``, on the scheduler's device): the
        in-flight speculation and every device-resident buffer are dropped
        first (nothing was transacted, so the next fused cycle starts
        cold).
        """
        driver = self._ensure_fused()
        with flight_recorder.cycle(kind="fused") as rec:
            import gc
            gc_paused = self.gc_discipline and gc.isenabled()
            if gc_paused:
                gc.disable()
            degraded = False
            try:
                with tracing.span("fused.cycle"):
                    queues, results = driver.step(self)
            except Exception:
                # device dispatch failed (a CUDA error, a lost card, an
                # injected fault): degrade to the split path for this
                # cycle instead of skipping scheduling entirely
                import logging
                logging.getLogger(__name__).exception(
                    "fused cycle failed; degrading to the split path")
                from ..utils.metrics import registry
                registry.counter_inc("cook_kernel_fallback",
                                     labels={"kernel": "fused.pool_cycle"})
                flight_recorder.note_fault("fused.dispatch-fallback")
                if self._pipeline is not None:
                    # in-flight speculation may reference the failed
                    # device state; drop it (nothing was transacted)
                    self._pipeline.reset()
                # resident buffers may live on the failed device state
                # too: rebuild them from scratch next fused cycle — and
                # the split-path Ranker this very degrade runs has its
                # own device base mirror to shed
                self._fused.reset_resident()
                self.ranker.reset_device_state()
                degraded = True
            finally:
                if gc_paused:
                    gc.enable()
                    self._gc_cycles += 1
                    # collect after the FIRST cycle (freeze the heap the
                    # warm-up built) and then every 10th
                    if self._gc_cycles == 1 or self._gc_cycles % 10 == 0:
                        self._gc_collect_due = True
            if degraded:
                # split path: rank, then match (which owns direct pools,
                # per-pool autoscaling, and last_match_results updates)
                self.step_rank()
                results = self.step_match()
                if rec is not None:
                    rec.pools = len(results)
                    rec.jobs_considered = sum(r.considered
                                              for r in results.values())
                    rec.jobs_placed = sum(len(r.launched_task_ids)
                                          for r in results.values())
                return results
            # direct pools: host rank + backpressure submission
            for pool in self.store.pools():
                if pool.state != "active" \
                        or pool.scheduler is not SchedulerKind.DIRECT:
                    continue
                ranked = self._filter_offensive_jobs(
                    self.ranker.rank_pool(pool.name, pool.dru_mode))
                queues[pool.name] = ranked
                results[pool.name] = self._match_direct(pool.name, ranked)
            # queues were computed pre-launch; prune the jobs this cycle
            # launched so consumers (rebalancer, /queue, direct pools) see
            # current state.  Pools whose producer already dropped launches
            # by exact queue position (fused _apply_pool) are skipped — the
            # full-queue isin scan is O(T) string work at the 100k+ scale.
            launched_uuids = set()
            for pool_name, result in results.items():
                if result.queue_pruned:
                    continue
                launched_uuids.update(result.launched_job_uuids)
            if launched_uuids:
                from .ranker import RankedQueue

                def prune(q):
                    if isinstance(q, RankedQueue):
                        # columnar: vectorized, no full-queue
                        # materialization
                        import numpy as np
                        return q.filtered(~np.isin(q.uuids,
                                                   list(launched_uuids)))
                    return [j for j in q if j.uuid not in launched_uuids]
                queues = {p: (q if results.get(p) is not None
                              and results[p].queue_pruned else prune(q))
                          for p, q in queues.items()}
            self.pending_queues = queues
            for pool_name, result in results.items():
                self._autoscale(pool_name, result)
            self.last_match_results.update(results)
            if rec is not None:
                rec.pools = len(results)
                rec.jobs_considered = sum(r.considered
                                          for r in results.values())
                rec.jobs_placed = sum(len(r.launched_task_ids)
                                      for r in results.values())
        # once per cycle: journal the trail's pending advisory events so
        # decision context survives a leader failover (utils/audit.py;
        # a no-op without a journal or with nothing pending)
        self.store.flush_audit()
        return results

    def step_match(self, pool_name: Optional[str] = None
                   ) -> Dict[str, MatchCycleResult]:
        """Match cycle for one pool (or all), consuming the ranked queues."""
        results: Dict[str, MatchCycleResult] = {}
        pools = ([p for p in self.store.pools() if p.name == pool_name]
                 if pool_name else self.store.pools())
        with flight_recorder.cycle(kind="match") as rec:
            # per-stage launches: the split path (also joined by a
            # degraded fused cycle, which then reads "mixed")
            flight_recorder.note_path("split")
            for pool in pools:
                if pool.state != "active":
                    continue
                ranked = self.pending_queues.get(pool.name, [])
                with tracing.span("scheduler.pool-handler", pool=pool.name):
                    if pool.scheduler is SchedulerKind.DIRECT:
                        results[pool.name] = self._match_direct(pool.name,
                                                                ranked)
                        continue
                    offers = []
                    for cluster in self.launchable_clusters(pool.name):
                        offers.extend(cluster.pending_offers(pool.name))
                    result = self.matcher.match_pool(
                        pool.name, ranked, offers, self.clusters,
                        reserved_hosts=self.reserved_hosts)
                    results[pool.name] = result
                    self._autoscale(pool.name, result)
            if rec is not None:
                rec.pools = len(results)
                rec.jobs_considered = sum(r.considered
                                          for r in results.values())
                rec.jobs_placed = sum(len(r.launched_task_ids)
                                      for r in results.values())
        self.last_match_results.update(results)
        self.store.flush_audit()
        return results

    def _autoscale(self, pool_name: str, result: MatchCycleResult) -> None:
        """Post-match autoscaling: surface unmatched demand as synthetic
        pods, reap placeholders for jobs that launched (reference:
        trigger-autoscaling! scheduler.clj:1178-1283).

        The demand is routed to ONE healthy (circuit-breaker-aware)
        autoscaling cluster: fanning it out verbatim to every accepting
        cluster double-provisioned — two clusters would both synthesize
        full-size placeholder pod sets for the same unmatched jobs.
        Placeholders are still reaped on EVERY cluster (the routing
        choice may move between cycles).  Gang demand is sized as
        whole-slice synthetic pod sets with co-location affinity
        (docs/GANG.md)."""
        if not self.config.autoscaling_enabled:
            return
        launched_jobs = list(result.launched_job_uuids)
        scalers = [c for c in self.clusters.values()
                   if getattr(c, "autoscale", None) is not None
                   and c.accepts_pool(pool_name)]
        if launched_jobs:
            for cluster in scalers:
                cluster.reap_synthetic_pods(launched_jobs)
        if not result.unmatched:
            return
        healthy = [c for c in scalers if self.breakers.get(c.name).allow()]
        if not healthy:
            return
        gangs: Dict[str, Dict] = {
            g.uuid: {"size": g.gang_size, "topology": g.gang_topology}
            for g in self.store.gang_groups_of(result.unmatched).values()}
        # deterministic routing: first healthy cluster in registration
        # order that can actually absorb the demand (a stable choice
        # keeps placeholder ownership from flapping).  A scaler at its
        # pod cap creates nothing WITHOUT raising, so its breaker never
        # opens — fall through to the next healthy scaler, but only
        # with the jobs the target does NOT already hold placeholders
        # for (re-surfacing covered jobs elsewhere would recreate the
        # double-provisioning this routing exists to prevent)
        remaining = list(result.unmatched)
        for target in healthy:
            # signature-probe once per backend class (catching TypeError
            # around the executed call would mask TypeErrors raised
            # INSIDE the backend and silently re-run it without gang
            # sizing)
            takes_gangs = self._autoscale_takes_gangs.get(type(target))
            if takes_gangs is None:
                import inspect
                try:
                    takes_gangs = "gangs" in inspect.signature(
                        target.autoscale).parameters
                except (TypeError, ValueError):
                    takes_gangs = False
                self._autoscale_takes_gangs[type(target)] = takes_gangs
            if takes_gangs:
                created = target.autoscale(pool_name, remaining,
                                           now_ms=now_ms(),
                                           gangs=gangs or None)
            else:
                created = target.autoscale(pool_name, remaining,
                                           now_ms=now_ms())
            if created:
                # budget permitting, autoscale covers every missing unit
                # it was handed; anything cut at the pod cap is caught
                # next cycle, when created drops to 0 and the coverage
                # probe routes the uncovered rest onward
                return
            probe = getattr(target, "synthetic_pods_for", None)
            if probe is None:
                # backend can't report placeholder ownership — assume
                # it absorbed the demand rather than fan out
                return
            covered = set(probe([j.uuid for j in remaining]))
            # a gang partially covered here (members reaped while the
            # cluster sits at its pod budget) stays routed here WHOLE:
            # forwarding just the uncovered members would have the next
            # cluster synthesize a partial gang pod set — the split-slice
            # provisioning the all-or-none pod-set logic exists to avoid
            held = {j.group for j in remaining
                    if j.group in gangs and j.uuid in covered}
            remaining = [j for j in remaining
                         if j.uuid not in covered and j.group not in held]
            if not remaining:
                return
            # at the pod cap with uncovered demand: fall through with
            # only the uncovered jobs

    def _match_direct(self, pool_name: str, ranked: List[Job]
                      ) -> MatchCycleResult:
        """Direct (Kenzo) mode: submit up to the backends' backpressure
        capacity and let the backend place (scheduler.clj:1728-1771)."""
        result = MatchCycleResult()
        clusters = self.launchable_clusters(pool_name)
        mc = self.config.matcher_for_pool(pool_name)
        # the fused path's head-of-queue scaleback + admission scaling
        # apply here too: an unmatchable head job shrinks the window,
        # and a brownout shrinks it further (scheduler.clj:1613-1651)
        backoff = self.matcher._backoff.setdefault(
            pool_name, _BackoffState(mc.max_jobs_considered))
        window = self.matcher.admission_limit(
            pool_name, ranked,
            min(backoff.num_considerable, mc.max_jobs_considered))
        if not clusters:
            # no launchable backend (none configured, or every breaker
            # open): the real demand must still be visible — a
            # capacity-of-zero truncation would report considered=0 /
            # unmatched=0 and hide the whole backlog for the outage
            considerable = self.matcher.considerable_jobs(
                pool_name, ranked, window)
            result.considered = len(considerable)
            result.unmatched = considerable
            # backend outage, not a head-of-queue problem: like the
            # fused path's no-offers cycle, backoff state is untouched
            result.head_matched = False
            from ..utils import audit as _audit
            _audit.note_skips(self.store.audit, {
                "unmatched": [j.uuid for j in result.unmatched]},
                pool=pool_name)
            return result
        capacity = sum(c.max_launchable(pool_name) for c in clusters)
        considerable = self.matcher.considerable_jobs(
            pool_name, ranked, min(capacity, window))
        result.considered = len(considerable)
        from ..policy import pool_user_key
        launch_rl = self.rate_limits.job_launch
        cluster_rl = self.rate_limits.cluster_launch
        cluster_budget = {c.name: cluster_rl.get_token_count(c.name)
                          for c in clusters} if cluster_rl.enforce else None
        i = 0
        gangs = self.store.gang_groups_of(considerable)
        for job in considerable:
            # direct (backend-places) mode has no all-or-nothing match
            # pass, so a gang member submitted here could come up partial
            # — gangs are BATCH-pool-only (docs/GANG.md) and wait instead
            if job.group in gangs:
                result.unmatched.append(job)
                continue
            cluster = clusters[i % len(clusters)]
            i += 1
            if cluster_budget is not None:
                if cluster_budget[cluster.name] < 1:
                    result.unmatched.append(job)
                    continue
                cluster_budget[cluster.name] -= 1
            task_id = new_uuid()
            try:
                self.store.launch_instance(job.uuid, task_id, hostname="",
                                           compute_cluster=cluster.name)
            except AbortTransaction as e:
                result.launch_failures.append((job.uuid, e.reason))
                continue
            launch_rl.spend(pool_user_key(pool_name, job.user))
            cluster_rl.spend(cluster.name)
            cluster.kill_lock.acquire_read()
            try:
                cluster.launch_tasks(pool_name, [LaunchSpec(
                    task_id=task_id, job_uuid=job.uuid, hostname="",
                    slave_id="", resources=job.resources, env=job.env,
                    port_count=job.ports, container=job.container)])
            finally:
                cluster.kill_lock.release_read()
            result.launched_task_ids.append(task_id)
            result.launched_job_uuids.append(job.uuid)
        # one batched intent-confirm for the cycle's direct launches (a
        # per-task clear would journal one transaction per job)
        self.store.clear_launch_intents(result.launched_task_ids)
        launched = set(result.launched_job_uuids)
        result.head_matched = bool(
            considerable and considerable[0].uuid in launched)
        if considerable:
            backoff.update(mc, result.head_matched)
        from ..utils import audit as _audit
        _audit.note_skips(self.store.audit, {
            "unmatched": [j.uuid for j in result.unmatched],
            "launch-failed": [(u, {"why": why})
                              for u, why in result.launch_failures],
        }, pool=pool_name)
        return result

    def step_rebalance(self) -> Dict[str, list]:
        """Preemption cycle (reference: start-rebalancer! rebalancer.clj:559)."""
        if not self.rebalancer.effective_params().enabled:
            return {}
        decisions: Dict[str, list] = {}
        with flight_recorder.cycle(kind="rebalance") as rec:
            for pool in self.store.pools():
                if pool.state != "active":
                    continue
                with tracing.span("rebalancer.pool", pool=pool.name):
                    pool_decisions = self.rebalancer.rebalance_pool(
                        pool.name, pool.dru_mode,
                        self.pending_queues.get(pool.name, []), self.clusters)
                if pool_decisions:
                    decisions[pool.name] = pool_decisions
                    victims = sum(len(d.victim_task_ids)
                                  for d in pool_decisions)
                    if victims:
                        from ..utils.metrics import registry
                        # preemption ATTRIBUTION (docs/OBSERVABILITY.md):
                        # direct fair-share victims vs gang-closure mates
                        # taken only because a sibling was chosen
                        closure = sum(len(d.gang_victim_ids)
                                      for d in pool_decisions)
                        if victims - closure:
                            registry.counter_inc(
                                "cook_preemptions",
                                float(victims - closure),
                                {"pool": pool.name,
                                 "reason": "fair-share"})
                        if closure:
                            registry.counter_inc(
                                "cook_preemptions", float(closure),
                                {"pool": pool.name,
                                 "reason": "gang-closure"})
                        flight_recorder.note_preemptions(victims)
                    for d in pool_decisions:
                        if len(d.victim_task_ids) > 1:
                            self.reserved_hosts[d.job_uuid] = d.hostname
            if rec is not None:
                rec.pools = len(decisions)
        self.store.flush_audit()
        return decisions

    # --------------------------------------------------------------- elastic
    def step_resize(self) -> Dict[str, int]:
        """Per-cycle elastic resize pass (docs/GANG.md elasticity):
        execute grace-expired shrinks, then shed standing optimizer
        shrink pressure per pool.  Growth needs no step of its own —
        satisfied elastic gangs grow through the ordinary match path,
        metered by the optimizer's per-pool grow budget.  Structural
        no-op (empty ledger, zero pressure) for rigid-only workloads."""
        if not self.config.elastic.enabled:
            return {}
        out: Dict[str, int] = {}
        swept = self.elastic.sweep(self.clusters)
        if swept:
            out["_grace_expired"] = len(swept)
        if any(self.elastic.shrink_pressure.values()):
            for pool in self.store.pools():
                if pool.state != "active":
                    continue
                shed = self.elastic.apply_pressure(pool.name, self.clusters)
                if shed:
                    out[pool.name] = shed
        return out

    # --------------------------------------------------------------- reapers
    def step_reapers(self, current_ms: Optional[int] = None) -> List[str]:
        """Kill tasks over their max runtime (lingering-task killer,
        scheduler.clj:1888-1953) and straggler instances per group quantile
        rule (scheduler.clj:1955-1986)."""
        current = current_ms if current_ms is not None else self.clock()
        killed: List[str] = []
        # ONE materializing scan shared by every reaper: each
        # running_instances() call deep-clones the full live set under the
        # store lock, so repeating it per-reaper at the 100k design point
        # would stall concurrent transactions
        running = self.store.running_instances()
        for job, inst in running:
            if job.max_runtime_ms and inst.start_time_ms and \
                    current - inst.start_time_ms > job.max_runtime_ms:
                self._kill_instance(inst.task_id, Reasons.MAX_RUNTIME_EXCEEDED.code)
                killed.append(inst.task_id)
        # the snapshot is shared, so downstream reapers must skip tasks an
        # earlier reaper already killed this tick (a stale entry would get
        # a duplicate kill RPC and a duplicate task_id in the result)
        done = set(killed)
        killed.extend(self._reap_orphaned_cluster_instances(
            current, running, skip=done))
        done.update(killed)
        killed.extend(self._reap_stragglers(current, running, skip=done))
        if self.config.heartbeat_enabled:
            for task_id in self.heartbeats.expired(current):
                self._kill_instance(task_id, Reasons.HEARTBEAT_LOST.code)
                self.heartbeats.forget(task_id)
                killed.append(task_id)
        return killed

    def _reap_orphaned_cluster_instances(self, current_ms: int,
                                         running=None,
                                         skip=frozenset()) -> List[str]:
        """Fail (NODE_LOST, mea-culpa) running instances whose compute
        cluster this scheduler does not have — the previous leader's
        in-process backend after a failover, or a dynamically deleted
        cluster.  A grace window tolerates a cluster being re-added
        (reference contract: a new leader re-reads all state and
        reconciles what its backends can't account for,
        mesos.clj:296-313 + scheduler.clj:1828-1878)."""
        grace_ms = self.config.orphaned_cluster_grace_seconds * 1000.0
        missing = self._orphan_first_seen
        failed: List[str] = []
        live = set()
        if running is None:
            running = self.store.running_instances()
        for _job, inst in running:
            if inst.task_id in skip:
                continue
            if inst.compute_cluster and \
                    inst.compute_cluster not in self.clusters:
                live.add(inst.task_id)
                first = missing.setdefault(inst.task_id, current_ms)
                if current_ms - first >= grace_ms:
                    missing.pop(inst.task_id, None)
                    self.store.update_instance_status(
                        inst.task_id, InstanceStatus.FAILED,
                        reason_code=Reasons.NODE_LOST.code)
                    failed.append(inst.task_id)
        for tid in list(missing):
            if tid not in live:
                missing.pop(tid)  # cluster came back (or task finished)
        return failed

    def _reap_stragglers(self, current_ms: int,
                         running=None, skip=frozenset()) -> List[str]:
        killed: List[str] = []
        groups: Dict[str, List] = {}
        if running is None:
            running = self.store.running_instances()
        for job, inst in running:
            if inst.task_id in skip:
                continue
            if job.group:
                groups.setdefault(job.group, []).append((job, inst))
        for group_uuid, members in groups.items():
            group = self.store.group(group_uuid)
            if group is None or group.straggler_quantile is None \
                    or group.straggler_multiplier is None:
                continue
            runtimes = []
            for member_uuid in group.jobs:
                member = self.store.job(member_uuid)
                if member is None:
                    continue
                for tid in member.instances:
                    mi = self.store.instance(tid)
                    if mi is not None and mi.status is InstanceStatus.SUCCESS \
                            and mi.end_time_ms:
                        runtimes.append(mi.end_time_ms - mi.start_time_ms)
            if not runtimes:
                continue
            runtimes.sort()
            q_idx = min(len(runtimes) - 1,
                        int(group.straggler_quantile * len(runtimes)))
            threshold = runtimes[q_idx] * group.straggler_multiplier
            for job, inst in members:
                if current_ms - inst.start_time_ms > threshold:
                    self._kill_instance(inst.task_id, Reasons.STRAGGLER.code)
                    killed.append(inst.task_id)
        return killed

    # ------------------------------------------------------------------ kills
    def kill_instance(self, task_id: str, reason_code: int) -> None:
        """Public single-instance kill: authoritative store transition first,
        then the backend kill (used by reapers, the rebalancer, and the REST
        instance-kill endpoint)."""
        self._kill_instance(task_id, reason_code)

    def _kill_instance(self, task_id: str, reason_code: int) -> None:
        inst = self.store.instance(task_id)
        if inst is None:
            return
        # transact the authoritative reason first so the backend's own kill
        # status arrives stale and is dropped (single-writer discipline)
        self.store.update_instance_status(task_id, InstanceStatus.FAILED,
                                          reason_code=reason_code)
        self._cluster_kill(inst.compute_cluster, task_id)

    def _cluster_kill(self, cluster_name: str, task_id: str) -> None:
        """Kill on the backend; defers to the side-effect worker when the
        calling thread holds the cluster's kill-lock read side (a write
        acquire there would self-deadlock)."""
        cluster = self.clusters.get(cluster_name)
        if cluster is None:
            return
        if cluster.kill_lock.holds_read():
            self._ensure_side_effect_worker()
            self._side_effects.put((cluster, task_id))
        else:
            cluster.safe_kill_task(task_id)

    def _ensure_side_effect_worker(self) -> None:
        if self._side_effect_thread is not None \
                and self._side_effect_thread.is_alive():
            return

        def worker():
            while not self._stop.is_set():
                try:
                    cluster, task_id = self._side_effects.get(timeout=0.5)
                except queue.Empty:
                    continue
                try:
                    cluster.safe_kill_task(task_id)
                except Exception:  # pragma: no cover
                    import logging
                    logging.getLogger(__name__).exception("deferred kill failed")
                finally:
                    self._side_effects.task_done()

        self._side_effect_thread = threading.Thread(target=worker, daemon=True)
        self._side_effect_thread.start()

    def drain_side_effects(self, timeout_s: float = 5.0) -> bool:
        """Block until every queued deferred backend kill has been
        processed — determinism hook for tests and the chaos simulator
        (gang-policy sibling kills defer when the triggering event fires
        under a cluster's kill-lock read side).  Returns False on
        timeout."""
        if self._side_effect_thread is None:
            return True
        q = self._side_effects
        deadline = time.time() + timeout_s
        with q.all_tasks_done:
            while q.unfinished_tasks:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                q.all_tasks_done.wait(remaining)
        return True

    # ------------------------------------------------------------- wall clock
    def run(self) -> None:
        """Start background cycle threads (the chime equivalent)."""
        cfg = self.config

        def loop(interval, fn) -> None:
            # interval may be a callable so dynamically-tunable cadences
            # (the rebalancer's no-restart interval-seconds) take effect on
            # the next tick instead of being frozen at startup
            while not self._stop.wait(interval() if callable(interval)
                                      else interval):
                try:
                    fn()
                except Exception:  # pragma: no cover - cycle errors are logged
                    import logging
                    logging.getLogger(__name__).exception("cycle failed")

        if cfg.cycle_mode == "fused" and self.ranker.backend != "cpu":
            # production path: one fused rank+match dispatch per cycle,
            # followed by the idle-point GC maintenance (gc_discipline)
            def fused_tick():
                self.step_cycle()
                self.maintain_gc()
            specs = [(cfg.match_interval_seconds, fused_tick)]
        else:
            specs = [(cfg.rank_interval_seconds, self.step_rank),
                     (cfg.match_interval_seconds, self.step_match)]
        specs += [
            (lambda: self.rebalancer.effective_params().interval_seconds,
             self.step_rebalance),
            (cfg.lingering_task_interval_seconds, self.step_reapers),
            (cfg.monitor_interval_seconds, self.monitor.sweep),
        ]
        if cfg.elastic.enabled:
            specs.append((cfg.elastic.resize_interval_seconds,
                          self.step_resize))
        for interval, fn in specs:
            t = threading.Thread(target=loop, args=(interval, fn), daemon=True)
            t.start()
            self._threads.append(t)
        # the optimizer's loop (the reference's last spec) is refused at
        # construction: see refuse_unported

    def shutdown(self) -> None:
        """Stop the loops ``run`` started and the side-effect worker."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
