"""The port's copy of ``cook_tpu/sim/chaos.py`` (imports re-rooted).

``run_chaos`` takes ``device`` (default ``"cuda"``, which raises without
a card) and hands it to both leaders' ``Scheduler``s.  Its split legs
(no pipeline depth, no resident pack) keep the reference's
``rank_backend="cpu"`` and ``default_matcher.backend="cpu"``, which rank
and match with the numpy reference and launch no kernel; its fused legs
(``pipeline_depth > 0`` or ``resident``) run the K1-K6 cycle on
``device``.  ``run_failover_chaos``, ``run_partition_chaos`` and
``run_partition_chaos_procs`` build no ``Scheduler`` and touch no
device, as in the reference: they take no ``device``.

The leader kill's ``_LeaderCrash`` is a ``BaseException``: it passes
through ``Scheduler.step_cycle``'s degrade handler, the pipeline's
``step``, ``flight_recorder.cycle`` and ``ops/cuda_lib.recording()``.
At depth 2 the dead leader leaves a dispatch in flight (its pinned
buffer, event and side-stream fetch); all of that hangs off the dead
``Scheduler`` (its pipeline and fused driver), nothing module-level in
``sched/fused.py``, ``sched/pipeline.py`` or ``ops/delta.py`` holds it,
so the successor's driver builds its resident pair cold.

Chaos-mode simulator: a workload driven under an injected fault
schedule, with the robustness invariants asserted, not assumed.

The fault-injection counterpart of the faster-than-real-time simulator
(Basiri et al., *Chaos Engineering*, IEEE Software 2016; Borg treats
failover/requeue behavior as first-class tested behavior, Verma et al.,
EuroSys 2015): replay a generated trace against the REAL scheduler +
store + fake cluster on a virtual clock while injecting

- **node loss** — a loaded host's tasks all fail ``NODE_LOST``
  (mea-culpa) on a fixed cadence;
- **launch RPC faults** — ``utils/faults.py`` point ``cluster.launch``
  rejects backend launches with a seeded probability (mea-culpa
  ``pod-submission-failed``), feeding the per-cluster circuit breaker;
- **one leader kill + promotion** — the leader "crashes" between the
  match transaction and the backend launch-ack (the classic
  crash-consistency window), the journal is reopened the way a promoted
  follower re-reads state, and scheduling resumes.

Invariants checked (violations are collected, not raised, so a run
reports everything it broke):

1. every job reaches a terminal state;
2. retry budgets are only consumed by non-mea-culpa failures (chaos only
   injects mea-culpa faults, so every job must end with
   ``attempts_used == 0``);
3. no job ever has two concurrently-live instances (checked every tick,
   and cross-checked against the backend's running set);
4. promotion loses zero committed transactions: the reopened store's
   state equals the pre-crash store's state, byte-for-value, and the
   final journal replays to exactly the final in-memory state.

Run it:  ``python -m cook_tpu_torch.sim --chaos [--seed N] [--device cpu]``
or ``pytest tests/test_torch_chaos.py``; see docs/ROBUSTNESS.md.
"""

from __future__ import annotations

import json
import os
import random
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import resolve_device
from ..cluster.fake import FakeCluster
from ..config import Config
from ..sched.scheduler import Scheduler
from ..state.integrity import JournalCorruptionError
from ..state.schema import InstanceStatus, JobState, Reasons
from ..state.store import Store
from ..utils.faults import injector
from ..utils.flight import recorder as flight_recorder
from ..utils.retry import breakers
from .simulator import (
    generate_example_hosts,
    generate_example_trace,
    load_hosts,
    load_trace,
)


@dataclass
class ChaosConfig:
    seed: int = 0
    n_jobs: int = 40
    n_users: int = 4
    n_hosts: int = 8
    submit_span_ms: int = 30_000
    job_duration_ms: int = 6_000
    tick_ms: int = 1_000
    # fault schedule.  node_loss_max stays BELOW n_hosts: the novel-host
    # constraint permanently excludes a job's failed hosts, so losing
    # every host at least once could make an unlucky job unschedulable
    # forever — a real small-cluster liveness hazard, but not the
    # invariant under test here
    node_loss_every_ms: int = 9_000
    node_loss_max: int = 5
    rpc_fault_probability: float = 0.15
    # cap on injected RPC rejects: each reject marks one host failed for
    # the job (novel-host), so an unbounded storm over a small pool can
    # legitimately exclude every host for an unlucky job
    rpc_fault_max: Optional[int] = None
    leader_kill_at_ms: Optional[int] = 15_000
    # breaker policy (virtual-clock): small threshold so chaos actually
    # exercises trip + half-open heal inside a short run
    breaker_failure_threshold: int = 3
    breaker_reset_timeout_s: float = 5.0
    max_virtual_ms: int = 30 * 60 * 1000
    data_dir: Optional[str] = None   # journal dir; tempdir when None
    # > 0 drives the PRODUCTION pipelined fused cycle (sched/pipeline.py,
    # Scheduler.step_cycle) under the fault schedule instead of the split
    # host path — the no-duplicate-live-instances invariant is checked
    # every tick against the overlapped optimistic dispatches
    pipeline_depth: int = 0
    # gang chaos (docs/GANG.md): n_gangs all-or-nothing groups of
    # gang_size members ride the trace; hosts get slice-id topology
    # attributes in gang_size-sized slices, and the zero-partial-gangs
    # invariant is checked every tick — node loss, launch-RPC faults,
    # and a leader kill landing mid-gang-launch must all leave either a
    # whole gang or no gang, never a partial one
    n_gangs: int = 0
    gang_size: int = 3
    gang_topology: bool = True
    # one gang is timed to submit just before the leader kill so the
    # crash window reliably lands inside a gang launch
    gang_at_kill: bool = True
    # ELASTIC gang chaos (docs/GANG.md elasticity): gangs declare
    # gang_min = max(1, gang_size // 2) and may legally run anywhere in
    # [min, size].  The zero-partial invariant becomes "live == 0 or
    # live (+completed) >= gang_min" every tick; a grace SHRINK is
    # requested just before the leader kill so the crash window races
    # the resize ledger — the shrink may be delayed by failover (the
    # in-memory deadline dies with the leader) but must never be
    # half-applied or lose a member
    elastic: bool = False
    # resident-mode chaos (docs/PERFORMANCE.md): drive the
    # fused cycle off the columnar index with the DEVICE-RESIDENT pack
    # on (the production wire form), optionally storming the
    # delta.extract / delta.apply fault points — every hit must degrade
    # that cycle to a clean full repack (cook_kernel_fallback_total,
    # cook_resident_repack_total{reason="fault"}) while scheduling
    # continues, and the leader kill's journal-replay promotion must
    # rebuild the resident pack from scratch on the successor's driver
    resident: bool = False
    delta_fault_probability: float = 0.0
    # overload chaos (docs/ROBUSTNESS.md): run the admission
    # controller in the loop — a small launch-token bucket on the
    # virtual clock drives saturation genuinely, monitor sweeps run
    # every tick, and the brownout ladder engages BEFORE the leader
    # kill.  The invariant under test: the promoted leader's controller
    # restores the journaled brownout stage (the flip rode the
    # dynamic-config journal record), so a failover mid-brownout never
    # resets the ladder to "everything open" under standing overload
    overload: bool = False
    overload_launch_rate_per_min: float = 30.0
    overload_launch_burst: float = 2.0
    # disk-fault chaos (docs/ROBUSTNESS.md WAL v2): silent bit flips on
    # the leader's journal stream at this per-append probability
    # (``store.journal.bitflip``).  The leader-kill leg then asserts
    # the storage-integrity contract end to end: the scrub self-heal
    # detects and repairs every flip (checkpoint from the in-memory
    # authority), and promotion replays with zero committed-txn loss —
    # a flip the scrub missed would REFUSE the successor's open
    disk_fault_probability: float = 0.0


@dataclass
class ChaosResult:
    total: int = 0
    completed: int = 0
    gangs: int = 0
    gang_requeues: int = 0
    # elastic chaos (docs/GANG.md elasticity)
    elastic_grows: int = 0
    elastic_shrinks: int = 0
    shrink_at_kill: str = ""   # outcome of the shrink racing the kill
    violations: List[str] = field(default_factory=list)
    node_losses: int = 0
    rpc_faults: int = 0
    delta_faults: int = 0
    # audit-trail continuity (docs/OBSERVABILITY.md): True when the
    # promoted leader's journal replay reconstructed a pre-kill job's
    # full timeline (submit -> ranked -> launched) — `cs why` keeps
    # answering across the failover
    audit_timeline_ok: bool = True
    leader_kills: int = 0
    intents_open_at_kill: int = 0
    relaunched_after_kill: int = 0
    breaker_trips: int = 0
    user_retries_charged: int = 0
    makespan_ms: int = 0
    flight: Dict = field(default_factory=dict)
    # overload chaos: the ladder's state across the failover
    brownout_stage_at_kill: int = -1
    brownout_stage_recovered: int = -1
    min_admission_level: float = 1.0
    # disk-fault chaos: journal corruptions the pre-promotion scrub
    # detected and healed (each one was a silent bit flip the CRC
    # envelope caught)
    disk_corruptions_healed: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> Dict:
        return {
            "ok": self.ok,
            "jobs_total": self.total,
            "jobs_completed": self.completed,
            "gangs": self.gangs,
            "gang_requeues": self.gang_requeues,
            "elastic_grows": self.elastic_grows,
            "elastic_shrinks": self.elastic_shrinks,
            "shrink_at_kill": self.shrink_at_kill,
            "violations": list(self.violations),
            "node_losses": self.node_losses,
            "rpc_faults": self.rpc_faults,
            "delta_faults": self.delta_faults,
            "audit_timeline_ok": self.audit_timeline_ok,
            "leader_kills": self.leader_kills,
            "intents_open_at_kill": self.intents_open_at_kill,
            "relaunched_after_kill": self.relaunched_after_kill,
            "breaker_trips": self.breaker_trips,
            "user_retries_charged": self.user_retries_charged,
            "makespan_virtual_s": self.makespan_ms / 1000.0,
            "brownout_stage_at_kill": self.brownout_stage_at_kill,
            "brownout_stage_recovered": self.brownout_stage_recovered,
            "min_admission_level": round(self.min_admission_level, 4),
            "disk_corruptions_healed": self.disk_corruptions_healed,
            "flight": self.flight,
        }


def _scrub_heal(store: Store, result: "ChaosResult") -> None:
    """Drain the background-scrub contract over the whole journal in
    one call: disarm the flip point, then scrub windows until the file
    verifies end to end, healing every CRC hit via the checkpoint
    self-repair (state/store.py Store.scrub)."""
    injector.disarm("store.journal.bitflip")
    while True:
        doc = store.scrub(max_bytes=1 << 20, repair=True)
        if doc.get("corrupt"):
            result.disk_corruptions_healed += 1
            if not doc.get("repaired"):
                result.violations.append(
                    "disk-fault scrub detected corruption but failed "
                    f"to self-heal: {doc}")
                return
            continue
        if not doc.get("enabled") or doc.get("verified_offset", 0) \
                >= doc.get("journal_bytes", 0):
            return


class _LeaderCrash(BaseException):
    """Simulated process death mid-launch.  BaseException so no
    defensive ``except Exception`` on the dispatch path can swallow the
    'crash' and ack the launch anyway."""


def _scheduler_config(cc: ChaosConfig) -> Config:
    cfg = Config()
    if cc.pipeline_depth > 0 or cc.resident:
        # production fused cycle under chaos (pipelined when depth > 0):
        # overlapped optimistic dispatches + reconciliation are exactly
        # what the duplicate-live invariant must hold against
        cfg.cycle_mode = "fused"
        cfg.pipeline.depth = cc.pipeline_depth
    else:
        # deterministic host path: the chaos run asserts scheduling
        # INVARIANTS, not kernel behavior (kernel fallback has its own
        # tests)
        cfg.cycle_mode = "split"
        cfg.pipeline.depth = 0
    # resident mode needs the columnar compact wire form; otherwise the
    # entity pack keeps chaos deterministic as before
    cfg.columnar_index = bool(cc.resident)
    cfg.resident_pack = bool(cc.resident)
    cfg.default_matcher.backend = "cpu"
    cfg.circuit_breaker.failure_threshold = cc.breaker_failure_threshold
    cfg.circuit_breaker.reset_timeout_s = cc.breaker_reset_timeout_s
    if cc.overload:
        # admission ladder in the loop (sched/admission.py), tuned so
        # the stage flips land well before the leader kill
        cfg.admission.enabled = True
        cfg.admission.stage_hold_seconds = 4.0
    return cfg


def run_chaos(cc: Optional[ChaosConfig] = None,
              device="cuda") -> ChaosResult:
    cc = cc or ChaosConfig()
    # refuse a missing card before any process-wide plane is armed
    device = resolve_device(device)
    data_dir = cc.data_dir or tempfile.mkdtemp(prefix="cook-chaos-")
    rng = random.Random(cc.seed)
    trace = load_trace(generate_example_trace(
        cc.n_jobs, n_users=cc.n_users, seed=cc.seed,
        span_ms=cc.submit_span_ms, duration_ms=cc.job_duration_ms))
    hosts = load_hosts(generate_example_hosts(cc.n_hosts, seed=cc.seed))

    # gang workload (docs/GANG.md): n_gangs groups of gang_size members,
    # uniform duration (members complete together), hosts carved into
    # gang_size-wide topology slices
    from ..state.schema import Group, Job, Resources
    gang_jobs: List[Job] = []
    gang_sets: List[tuple] = []  # (submit_ms, [jobs], Group)
    gang_index: Dict[str, List[str]] = {}
    if cc.n_gangs > 0:
        if cc.gang_topology:
            for i, h in enumerate(hosts):
                h.attributes["slice-id"] = f"s{i // cc.gang_size}"
        t0 = trace[0].submit_time_ms if trace else 0
        for k in range(cc.n_gangs):
            submit = t0 + (k + 1) * cc.submit_span_ms // (cc.n_gangs + 1)
            if (cc.gang_at_kill and k == cc.n_gangs - 1
                    and cc.leader_kill_at_ms is not None):
                # the last gang lands just before the leader kill so the
                # crash window reliably interrupts a gang launch
                submit = max(t0, t0 + cc.leader_kill_at_ms - cc.tick_ms)
            guuid = f"gang-{k}"
            members = [Job(
                uuid=f"{guuid}-m{i}", user=f"gang{k % cc.n_users}",
                command="sim", group=guuid,
                resources=Resources(cpus=2.0, mem=256.0),
                max_retries=3, submit_time_ms=submit,
                labels={"sim/duration_ms": str(cc.job_duration_ms)})
                for i in range(cc.gang_size)]
            gang_min = max(1, cc.gang_size // 2) if cc.elastic else 0
            group = Group(
                uuid=guuid, gang=True, gang_size=cc.gang_size,
                gang_min=gang_min,
                gang_max=cc.gang_size if cc.elastic else 0,
                gang_topology="slice-id" if cc.gang_topology else None,
                jobs=[m.uuid for m in members])
            gang_jobs.extend(members)
            gang_sets.append((submit, members, group))
            gang_index[guuid] = [m.uuid for m in members]
        gang_sets.sort(key=lambda s: s[0])

    result = ChaosResult(total=len(trace) + len(gang_jobs),
                         gangs=cc.n_gangs)
    if not trace and not gang_jobs:
        return result

    now_box = [trace[0].submit_time_ms if trace else gang_sets[0][0]]
    clock = lambda: now_box[0]  # noqa: E731 - one timebase for everything

    # process-global planes: seed/arm for this run, restore after
    injector.clear()
    injector.reseed(cc.seed)
    breakers.reset()
    breakers.configure(failure_threshold=cc.breaker_failure_threshold,
                       reset_timeout_s=cc.breaker_reset_timeout_s,
                       clock=lambda: now_box[0] / 1000.0)
    if cc.rpc_fault_probability > 0:
        injector.arm("cluster.launch",
                     probability=cc.rpc_fault_probability,
                     max_fires=cc.rpc_fault_max)
    if cc.delta_fault_probability > 0:
        # resident-pack kernel faults: extraction and scatter-apply each
        # degrade that cycle to a full repack, never kill it (both armed
        # at the configured per-call probability, as --delta-faults
        # documents)
        injector.arm("delta.extract",
                     probability=cc.delta_fault_probability)
        injector.arm("delta.apply",
                     probability=cc.delta_fault_probability)
    if cc.disk_fault_probability > 0:
        # silent media rot under the live appender: no error surfaces
        # at flip time by design — the CRC envelope must catch it at
        # scrub/replay (state/integrity.py)
        injector.arm("store.journal.bitflip",
                     probability=cc.disk_fault_probability)
    flight_seq0 = flight_recorder.last_seq()

    cfg = _scheduler_config(cc)
    store = Store.open(data_dir)
    store.clock = clock
    cluster = FakeCluster("chaos", hosts)
    cluster.job_durations_ms = {
        j.uuid: int(j.labels["sim/duration_ms"])
        for j in list(trace) + gang_jobs}
    # overload mode: a small launch-token bucket on the virtual clock is
    # the genuine saturation driver the monitor sweep reads (the same
    # RateLimits object survives the failover — token debt is leader
    # memory, the journaled brownout STAGE is the durable part)
    rate_limits = None
    if cc.overload:
        from ..policy import RateLimits, TokenBucketRateLimiter
        rate_limits = RateLimits(job_launch=TokenBucketRateLimiter(
            cc.overload_launch_rate_per_min, cc.overload_launch_burst,
            enforce=True, clock=lambda: now_box[0] / 1000.0))
    scheduler = Scheduler(store, cfg, [cluster], rank_backend="cpu",
                          rate_limits=rate_limits, device=device)

    def check_single_live(when: str) -> None:
        live_by_job: Dict[str, int] = {}
        for job, inst in store.running_instances():
            live_by_job[job.uuid] = live_by_job.get(job.uuid, 0) + 1
        for uuid, n in live_by_job.items():
            if n > 1:
                result.violations.append(
                    f"{when}: job {uuid} has {n} live instances")
        # backend cross-check: every task the cluster runs maps to a
        # still-live store instance (no zombie double-running attempt)
        for tid in cluster.running_task_ids():
            inst = store.instance(tid)
            if inst is None or inst.status not in (
                    InstanceStatus.UNKNOWN, InstanceStatus.RUNNING):
                result.violations.append(
                    f"{when}: cluster runs {tid} but store says "
                    f"{inst.status.value if inst else 'missing'}")

    # the elastic legal minimum (docs/GANG.md elasticity); None = rigid
    gang_lo = max(1, cc.gang_size // 2) if cc.elastic else None

    def check_no_partial_gang(when: str) -> None:
        """THE gang invariant (docs/GANG.md): at every consistent point,
        a gang is whole or absent — never a strict subset of members
        holding capacity while the rest wait.  ELASTIC gangs relax
        "whole" to "at least gang_min live (or wound down to
        completion)": any live count in [min, size] is a legal size,
        below min is the same partial-gang hazard as before."""
        for guuid, member_uuids in gang_index.items():
            live = completed = known = 0
            for uuid in member_uuids:
                j = store.job(uuid)
                if j is None:
                    continue
                known += 1
                if any((mi := store.instance(t)) is not None
                       and mi.status in (InstanceStatus.UNKNOWN,
                                         InstanceStatus.RUNNING)
                       for t in j.instances):
                    live += 1
                elif j.state is JobState.COMPLETED:
                    completed += 1
            whole = known if gang_lo is None else min(known, gang_lo)
            if known and live and live + completed < whole:
                result.violations.append(
                    f"{when}: gang {guuid} partial — {live} live + "
                    f"{completed} completed of {known} members "
                    f"(requires {whole})")

    def fail_one_node() -> None:
        if result.node_losses >= cc.node_loss_max:
            return
        with cluster._lock:
            loaded: Dict[str, List[str]] = {}
            for tid, t in cluster._tasks.items():
                loaded.setdefault(t.spec.hostname, []).append(tid)
        if not loaded:
            return
        host = rng.choice(sorted(loaded))
        result.node_losses += 1
        for tid in loaded[host]:
            cluster.fail_task(tid, Reasons.NODE_LOST.code)

    # jobs whose dispatch the leader kill interrupted, with their
    # instance counts at kill time: a post-kill instance PROVES the
    # refund->relaunch path ran (reported as relaunched_after_kill)
    crashed_jobs: Dict[str, int] = {}

    def find_surplus_member():
        """A (task_id, job_uuid, gang_uuid) of a RUNNING elastic gang
        member above gang_min — a legal grace-shrink victim."""
        for guuid, member_uuids in gang_index.items():
            live = []
            for uuid in member_uuids:
                j = store.job(uuid)
                if j is None:
                    continue
                for t in j.instances:
                    mi = store.instance(t)
                    if mi is not None and mi.status in (
                            InstanceStatus.UNKNOWN,
                            InstanceStatus.RUNNING):
                        live.append((t, uuid))
            if gang_lo is not None and len(live) > gang_lo:
                tid, uuid = live[-1]
                return tid, uuid, guuid
        return None

    def kill_leader_and_promote() -> None:
        nonlocal store, scheduler
        result.leader_kills += 1
        stage_at_kill = (scheduler.admission.stage
                         if scheduler.admission is not None else -1)
        # elastic: open a grace shrink RIGHT before the crash so the
        # kill window races the resize ledger (docs/GANG.md elasticity:
        # a shrink may be DELAYED by failover — the in-memory deadline
        # dies with the leader — but never half-applied)
        racing_shrink = None
        if cc.elastic:
            victim = find_surplus_member()
            if victim is not None:
                tid, juuid, guuid = victim
                scheduler.elastic.request_shrink(
                    tid, juuid, guuid, cluster.name, scheduler.clusters,
                    reason="chaos-race")
                racing_shrink = tid
        # crash INSIDE the match->launch window: the guard transaction
        # (instances + intents) commits, the backend dispatch never lands
        orig_launch = FakeCluster.launch_tasks

        def crash(self, pool, specs):
            raise _LeaderCrash()

        FakeCluster.launch_tasks = crash
        try:
            if cc.pipeline_depth > 0 or cc.resident:
                scheduler.step_cycle()
            else:
                scheduler.step_rank()
                scheduler.step_match()
        except _LeaderCrash:
            pass
        finally:
            FakeCluster.launch_tasks = orig_launch
        open_intents = store.launch_intents()
        result.intents_open_at_kill = len(open_intents)
        for intent in open_intents:
            j = store.job(intent["job_uuid"])
            if j is not None:
                crashed_jobs[j.uuid] = len(j.instances)
        # audit-continuity probe: a job LAUNCHED in an earlier (fully
        # flushed) cycle — after promotion its timeline must replay
        # whole from the journal.  Crash-window jobs are excluded: their
        # launch rode the txn record, but the interrupted cycle's
        # advisory flush legitimately never ran.
        probe_uuid = next(
            (j.uuid for j, _i in store.running_instances()
             if j.uuid not in crashed_jobs), None)
        if cc.disk_fault_probability > 0:
            # drain the background-scrub contract before the crash: the
            # injected flips are SILENT, so promotion only survives if
            # the CRC scrub detects every one and self-heals (checkpoint
            # from the in-memory authority).  A missed flip refuses the
            # successor's open below — that's the violation under test.
            _scrub_heal(store, result)
        pre = json.loads(store.snapshot())
        store.close()  # crash-equivalent: no checkpoint, journal as-is
        # promotion: the successor re-reads everything the dead leader
        # committed (snapshot + journal replay)
        try:
            store = Store.open(data_dir)
        except JournalCorruptionError as e:
            # a flip the scrub heal missed: committed history is
            # unreadable — record the contract violation, then restore
            # the pre-crash snapshot so the rest of the run still
            # reports its other invariants
            result.violations.append(
                "promotion refused the journal after the scrub heal: "
                f"{e}")
            from ..state.repair import quarantine
            from ..utils.fsatomic import write_atomic_text
            quarantine(data_dir)
            write_atomic_text(
                os.path.join(data_dir, "snapshot.json"),
                json.dumps(pre))
            store = Store.open(data_dir)
        post = json.loads(store.snapshot())
        # tx_id counts every transaction including write-free ones (an
        # all-deny launch guard journals nothing); entity state is the
        # committed truth being compared
        pre.pop("tx_id", None)
        post.pop("tx_id", None)
        if post != pre:
            result.violations.append(
                "promotion lost committed transactions: replayed state "
                "differs from the pre-crash store")
        if probe_uuid is not None:
            # the NEW store's trail was rebuilt purely from journal
            # replay (the old process's in-memory trail died with it):
            # `cs why` on a pre-kill job must still show the lifecycle
            kinds = {e["kind"] for e in store.audit.timeline(probe_uuid)}
            expect = {"submitted", "ranked", "launched"}
            if cc.overload and stage_at_kill >= 1:
                # brownout stage >= 1 sheds ADVISORY observability: the
                # ranked lane's advisory flushes fold by design
                # (utils/audit.py shed_advisory) — only the journal-
                # transaction-backed kinds must survive the failover
                expect = {"submitted", "launched"}
            missing = expect - kinds
            if missing:
                result.audit_timeline_ok = False
                result.violations.append(
                    f"audit trail lost across failover: job "
                    f"{probe_uuid} timeline missing {sorted(missing)} "
                    f"after promotion (has {sorted(kinds)})")
        store.clock = clock
        # the new leader adopts the (still-running) cluster and sweeps
        # the open launch intents in its constructor
        scheduler = Scheduler(store, cfg, [cluster], rank_backend="cpu",
                              rate_limits=rate_limits, device=device)
        if cc.overload:
            # the promoted controller must RESTORE the journaled
            # brownout stage (sched/admission.py restore()): a failover
            # mid-brownout that reset the ladder would reopen every
            # shed path under standing overload — the metastable trap
            recovered = (scheduler.admission.stage
                         if scheduler.admission is not None else -1)
            result.brownout_stage_at_kill = stage_at_kill
            result.brownout_stage_recovered = recovered
            if recovered != stage_at_kill:
                result.violations.append(
                    f"promotion lost the brownout stage: was "
                    f"{stage_at_kill} at kill, restored {recovered}")
        if racing_shrink is not None:
            # never half-applied: after promotion the victim is either
            # UNTOUCHED (ledger + deadline died with the leader — the
            # shrink was delayed) or cleanly shed with the mea-culpa
            # gang-resized reason; anything else is a violation
            mi = store.instance(racing_shrink)
            if mi is None:
                result.violations.append(
                    "shrink-at-kill: victim instance vanished")
                result.shrink_at_kill = "lost"
            elif mi.status in (InstanceStatus.UNKNOWN,
                               InstanceStatus.RUNNING):
                result.shrink_at_kill = "delayed"
            elif mi.reason_code == Reasons.GANG_RESIZED.code:
                result.shrink_at_kill = "applied"
            elif mi.status is InstanceStatus.SUCCESS:
                result.shrink_at_kill = "completed"
            else:
                result.violations.append(
                    f"shrink-at-kill: victim {racing_shrink} ended "
                    f"{mi.status.value}/{mi.reason_code} — neither "
                    "delayed nor a clean gang-resized shed")
                result.shrink_at_kill = "corrupt"

    pending = list(trace)
    pending_gangs = list(gang_sets)
    last_submits = [s[0] for s in pending_gangs]
    if pending:
        last_submits.append(pending[-1].submit_time_ms)
    deadline = max(last_submits) + cc.max_virtual_ms
    start_ms = now_box[0]
    next_node_loss = start_ms + cc.node_loss_every_ms
    kill_at = (start_ms + cc.leader_kill_at_ms
               if cc.leader_kill_at_ms is not None else None)
    # elastic: drive ordinary grace shrinks through the run (up to 3,
    # spaced so at least one grace window expires AWAY from the leader
    # kill and actually executes; the kill gets its own racing shrink)
    shrink_at = (start_ms + (cc.leader_kill_at_ms or 20_000) // 2
                 if cc.elastic else None)
    shrinks_requested = 0
    breaker = breakers.get(cluster.name)
    last_breaker_state = breaker.state

    while now_box[0] <= deadline:
        now = now_box[0]
        while pending and pending[0].submit_time_ms <= now:
            store.create_jobs([pending.pop(0)])
        while pending_gangs and pending_gangs[0][0] <= now:
            _t, members, group = pending_gangs.pop(0)
            store.create_jobs(members, groups=[group])
        if kill_at is not None and now >= kill_at:
            kill_at = None
            kill_leader_and_promote()
        if now >= next_node_loss:
            next_node_loss = now + cc.node_loss_every_ms
            fail_one_node()
        if cc.pipeline_depth > 0 or cc.resident:
            scheduler.step_cycle()
        else:
            scheduler.step_rank()
            scheduler.step_match()
        scheduler.step_reapers(current_ms=now)
        if cc.overload:
            # the production control loop: each sweep recomputes the
            # saturation layer and steps the admission controller
            scheduler.monitor.sweep()
            if scheduler.admission is not None:
                result.min_admission_level = min(
                    result.min_admission_level,
                    scheduler.admission.level)
        if cc.elastic:
            # a mid-run grace shrink well before the kill: the grace
            # deadline expires through step_resize ticks on the virtual
            # clock while node loss + RPC faults keep firing
            if shrink_at is not None and now >= shrink_at:
                victim = find_surplus_member()
                if victim is not None:
                    tid, juuid, guuid = victim
                    scheduler.elastic.request_shrink(
                        tid, juuid, guuid, cluster.name,
                        scheduler.clusters, reason="chaos")
                    shrinks_requested += 1
                    shrink_at = (None if shrinks_requested >= 3
                                 else now + 8_000)
            scheduler.step_resize()
        state = breaker.state
        if state == "open" and last_breaker_state != "open":
            result.breaker_trips += 1
        last_breaker_state = state
        # deferred backend kills (gang-policy siblings killed while the
        # launch path held the kill-lock read side) must land before the
        # tick's invariants are judged
        scheduler.drain_side_effects()
        check_single_live(f"t={now}")
        check_no_partial_gang(f"t={now}")
        if result.violations:
            break  # a broken invariant only compounds; stop and report
        now_box[0] = now + cc.tick_ms
        cluster.advance_to(now_box[0])
        if not pending and not pending_gangs and not store.jobs_where(
                lambda j: j.state is not JobState.COMPLETED):
            break

    result.makespan_ms = now_box[0] - start_ms
    result.rpc_faults = injector.active().get(
        "cluster.launch", {}).get("fires", 0)
    result.delta_faults = sum(
        injector.active().get(p, {}).get("fires", 0)
        for p in ("delta.extract", "delta.apply"))
    # MEASURED relaunches: a crash-window job gained an instance after
    # the kill (the refund->relaunch path actually ran, not assumed)
    result.relaunched_after_kill = sum(
        1 for uuid, n_at_kill in crashed_jobs.items()
        if (j := store.job(uuid)) is not None
        and len(j.instances) > n_at_kill)

    check_no_partial_gang("final")
    # gang requeues actually exercised (observed, not assumed): count
    # the gang-member-lost sibling kills the policy transacted
    for uuids in gang_index.values():
        for uuid in uuids:
            j = store.job(uuid)
            if j is None:
                continue
            result.gang_requeues += sum(
                1 for t in j.instances
                if (mi := store.instance(t)) is not None
                and mi.reason_code == Reasons.GANG_MEMBER_LOST.code)
            if cc.elastic:
                # shrinks observed as transacted gang-resized sheds
                result.elastic_shrinks += sum(
                    1 for t in j.instances
                    if (mi := store.instance(t)) is not None
                    and mi.reason_code == Reasons.GANG_RESIZED.code)
    if cc.elastic:
        result.elastic_grows = scheduler.elastic.grows

    # terminal-state + retry-budget invariants
    for job in list(trace) + gang_jobs:
        stored = store.job(job.uuid)
        if stored is None:
            result.violations.append(f"job {job.uuid} vanished")
            continue
        if stored.state is JobState.COMPLETED:
            result.completed += 1
            # every finished job's audit timeline tells its whole story
            # (submit -> ... -> terminal), across the mid-run failover
            kinds = {e["kind"]
                     for e in store.audit.timeline(job.uuid)}
            if not {"submitted", "terminal"} <= kinds:
                result.audit_timeline_ok = False
                result.violations.append(
                    f"job {job.uuid} completed with an incomplete audit "
                    f"timeline: {sorted(kinds)}")
        else:
            result.violations.append(
                f"job {job.uuid} not terminal: {stored.state.value}")
        insts = {t: i for t in stored.instances
                 if (i := store.instance(t)) is not None}
        charged = stored.attempts_used(insts)
        result.user_retries_charged += charged
        if charged:
            # chaos injects only mea-culpa failures; any consumed budget
            # means a cluster fault was charged to the user
            result.violations.append(
                f"job {job.uuid}: {charged} user retr"
                f"{'y' if charged == 1 else 'ies'} consumed by "
                "injected (mea-culpa) failures")

    # the journal IS the state: a fresh replay must reproduce the final
    # store exactly (what the NEXT promotion would read).  Under disk
    # faults the scrub heal runs first — flips injected since the last
    # sweep would otherwise (correctly) refuse this replay.
    if cc.disk_fault_probability > 0:
        _scrub_heal(store, result)
    final_live = json.loads(store.snapshot())
    try:
        final_replayed = json.loads(
            Store.replay_only(data_dir).snapshot())
    except JournalCorruptionError as e:
        final_replayed = None
        result.violations.append(
            f"final journal replay refused after scrub heal: {e}")
    if final_replayed is not None:
        final_live.pop("tx_id", None)
        final_replayed.pop("tx_id", None)
        if final_live != final_replayed:
            result.violations.append(
                "final journal replay diverges from the live store")

    result.flight = flight_recorder.summary(since_seq=flight_seq0)
    if cc.overload:
        # the controller flips process-global planes (request-capture
        # ring); a run ending mid-brownout must not leak the shed
        from ..rest.instrument import request_log
        request_log.capture = True
    store.close()
    injector.clear()
    breakers.reset()
    return result


# --------------------------------------------------------------------------
# Multi-standby failover chaos: the quorum-aware promotion protocol under
# fire (candidate ranking, standby→standby delta pull, old-leader fencing,
# indeterminate commits), over REAL socket replication — native framed-TCP
# mirrors, real journals, real fencing files (docs/DEPLOY.md).
# --------------------------------------------------------------------------

@dataclass
class FailoverChaosConfig:
    seed: int = 0
    #: "sigkill" — the leader process dies outright (store closed, server
    #: gone); "partition" — the leader stays ALIVE but cut off, and must
    #: end up fenced end-to-end (journal append, replication serving,
    #: REST writes)
    leader_mode: str = "sigkill"
    #: which standby wins the election lock race: "advanced" (the synced
    #: one — promotes directly), "laggard" (must pull the delta from the
    #: advanced peer first), or None (seeded coin flip)
    winner: Optional[str] = None
    n_jobs_before_lag: int = 15    # committed while BOTH standbys synced
    n_jobs_after_lag: int = 10     # committed while standby B lags
    inject_indeterminate: bool = True
    ack_timeout_s: float = 5.0
    data_root: Optional[str] = None
    #: leader-side group-commit admission batching (state/store.py):
    #: concurrent submissions share one fsync + one replication ack
    #: round.  The scenario adds two concurrent phases — a healthy batch
    #: (all members must commit and survive the failover) and a batch
    #: whose ack round is fault-lost mid-flight (every waiter must
    #: resolve committed or indeterminate, never hang or silently drop;
    #: the records reached the synced mirror either way, so ALL must
    #: survive the failover)
    group_commit: bool = True
    group_commit_writers: int = 4


@dataclass
class FailoverChaosResult:
    violations: List[str] = field(default_factory=list)
    committed: int = 0
    winner: str = ""
    winner_was_laggard: bool = False
    delta_pulled: bool = False
    laggard_converged: bool = False
    indeterminate_commits: int = 0
    fenced_appends_rejected: int = 0
    fenced_rest_writes_rejected: int = 0
    # group-commit accounting: durability rounds the stage ran, the
    # demuxed outcome histogram of the concurrent phases, and waiters
    # that never resolved (must stay 0 — the never-silently-dropped
    # contract)
    group_commit_batches: int = 0
    group_commit_outcomes: Dict[str, int] = field(default_factory=dict)
    group_commit_unresolved: int = 0
    # True when the promoted store's replayed audit trail carries the
    # pre-failover jobs' timelines (journal-backed lane mirrored over
    # socket replication, docs/OBSERVABILITY.md)
    audit_timeline_ok: bool = True

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> Dict:
        return {
            "ok": self.ok, "violations": list(self.violations),
            "committed": self.committed, "winner": self.winner,
            "winner_was_laggard": self.winner_was_laggard,
            "delta_pulled": self.delta_pulled,
            "laggard_converged": self.laggard_converged,
            "indeterminate_commits": self.indeterminate_commits,
            "fenced_appends_rejected": self.fenced_appends_rejected,
            "fenced_rest_writes_rejected":
                self.fenced_rest_writes_rejected,
            "audit_timeline_ok": self.audit_timeline_ok,
            "group_commit_batches": self.group_commit_batches,
            "group_commit_outcomes": dict(self.group_commit_outcomes),
            "group_commit_unresolved": self.group_commit_unresolved,
        }


def _failover_job(i: int):
    from ..state.schema import Job, Resources
    return Job(uuid=f"00000000-0000-4000-8000-{i:012d}", user="chaos",
               command=f"echo {i}", resources=Resources(cpus=1, mem=64))


def _journal_bytes(d: str) -> int:
    import os
    try:
        return os.path.getsize(os.path.join(d, "journal.jsonl"))
    except OSError:
        return 0


def _wait(pred, timeout_s: float = 15.0) -> bool:
    import time
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return bool(pred())


# --------------------------------------------------------------------------
# Partitioned write-plane chaos: kill ONE partition's leader mid-batch and
# prove the sibling partitions' commit streams never stall while the
# victim's standby promotes via the candidate ranking — zero
# committed transactions lost, per-partition indeterminate demux asserted
# (docs/DEPLOY.md "partitioned write plane").
# --------------------------------------------------------------------------

@dataclass
class PartitionChaosConfig:
    seed: int = 0
    partitions: int = 2
    #: which partition's leader is killed mid-batch
    victim: int = 0
    #: committed per partition before the fault schedule starts
    jobs_before: int = 8
    #: concurrent writers per phase (the group-commit batch width)
    writers: int = 3
    #: how long the sibling writer threads keep streaming commits
    #: through the kill + promotion window
    sibling_stream_s: float = 2.0
    ack_timeout_s: float = 5.0
    data_root: Optional[str] = None
    group_commit: bool = True
    #: True (the default): each partition leader is a
    #: REAL shard worker process (sched/shard.py) and the victim is
    #: SIGKILLed — journal stops mid-write exactly as a host loss.
    #: False keeps the original thread-based in-process variant.
    process_kill: bool = True


@dataclass
class PartitionChaosResult:
    violations: List[str] = field(default_factory=list)
    partitions: int = 0
    committed: int = 0
    committed_by_partition: Dict[str, int] = field(default_factory=dict)
    victim_indeterminate: int = 0
    sibling_commits_during_promotion: int = 0
    sibling_errors: int = 0
    promotion_window_s: float = 0.0
    promoted_epoch: int = 0
    unresolved_writers: int = 0
    #: whether the victim loss was a real SIGKILL of a worker process
    process_kill: bool = False

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> Dict:
        return {
            "ok": self.ok, "violations": list(self.violations),
            "partitions": self.partitions,
            "committed": self.committed,
            "committed_by_partition": dict(self.committed_by_partition),
            "victim_indeterminate": self.victim_indeterminate,
            "sibling_commits_during_promotion":
                self.sibling_commits_during_promotion,
            "sibling_errors": self.sibling_errors,
            "promotion_window_s": round(self.promotion_window_s, 3),
            "promoted_epoch": self.promoted_epoch,
            "unresolved_writers": self.unresolved_writers,
            "process_kill": self.process_kill,
        }


def run_partition_chaos(cc: Optional[PartitionChaosConfig] = None
                        ) -> PartitionChaosResult:
    """One partition-leader loss under write load, over REAL per-
    partition socket replication (each partition: its own journal,
    fsync stream, group-commit stage, ReplicationServer, synced
    standby, and lease epoch — the N-leases-over-P-partitions layout):

    1. P partition leaders + one synced standby each; a
       :class:`~cook_tpu_torch.state.partition.PartitionedStore` facade
       routes per-pool writes;
    2. a concurrent batch on the VICTIM partition has its replication
       ack fault-lost mid-flight — every waiter must demux committed or
       indeterminate (never hang), and ONLY the victim partition's
       writers may see the ambiguous outcome;
    3. the victim's leader dies; sibling partitions' writer threads
       keep streaming commits THROUGH the whole promotion window —
       zero sibling errors, nonzero sibling commits inside the window
       (the commit stream never stalls);
    4. the victim's standby promotes via the failover machinery (candidate
       position, promotion gate, epoch 2 fencing) and must hold EVERY
       committed-or-indeterminate transaction (zero loss — the
       indeterminate records reached the synced mirror before the ack
       was lost);
    5. the rebuilt facade serves every committed job from every
       partition.
    """
    import os
    import tempfile
    import threading
    import time as _time

    from ..state import replication as repl
    from ..state.partition import PartitionedStore, PartitionMap
    from ..state.schema import Pool
    from ..state.store import ReplicationIndeterminate
    from ..utils.fsatomic import write_atomic_int

    cc = cc or PartitionChaosConfig()
    result = PartitionChaosResult(partitions=cc.partitions)
    if cc.partitions < 2:
        result.violations.append("partition chaos needs >= 2 partitions")
        return result
    if not 0 <= cc.victim < cc.partitions:
        result.violations.append(f"victim {cc.victim} out of range")
        return result
    if not repl.replication_available():
        result.violations.append("native replication library unavailable")
        return result
    root = cc.data_root or tempfile.mkdtemp(prefix="cook-partchaos-")
    election = os.path.join(root, "election")
    os.makedirs(election, exist_ok=True)
    pools = {f"pool-p{p}": p for p in range(cc.partitions)}
    pmap = PartitionMap(count=cc.partitions, pools=pools)
    committed: Dict[int, List[str]] = {p: [] for p in range(cc.partitions)}
    cleanup = []
    stores: List[Store] = []
    servers = []
    followers = []

    def _job(p: int, i: int):
        from ..state.schema import Job, Resources
        return Job(uuid=f"0000000{p}-0000-4000-8000-{i:012d}",
                   user=f"chaos{p}", command=f"echo {i}",
                   pool=f"pool-p{p}",
                   resources=Resources(cpus=1, mem=64))

    try:
        # ---- per-partition leadership: leader + synced standby -------
        from ..sched.election import partition_lock_path
        for p in range(cc.partitions):
            authority = partition_lock_path(election, p) + ".epoch"
            write_atomic_int(authority, 1)
            d_leader = os.path.join(root, f"p{p}", "leader")
            store = Store.open(d_leader, epoch=1, shared=False,
                               partition=p)
            store.attach_fence_authority(authority)
            srv = repl.ReplicationServer(d_leader, 0)
            srv.epoch = 1
            srv.partition = p
            cleanup.append(srv.stop)
            store.attach_replication(srv, sync=True,
                                     timeout_s=cc.ack_timeout_s)
            if cc.group_commit:
                store.enable_group_commit(window_ms=2.0)
            d_standby = os.path.join(root, f"p{p}", "standby")
            f = repl.ReplicationFollower("127.0.0.1", srv.port, d_standby)
            cleanup.append(f.stop)
            repl.record_followed_epoch(d_standby, 1)
            stores.append(store)
            servers.append(srv)
            followers.append(f)
        for p, srv in enumerate(servers):
            if not _wait(lambda s=srv: s.synced_follower_count >= 1):
                result.violations.append(
                    f"partition {p} standby never synced")
                return result
        facade = PartitionedStore(stores, pmap)
        for name in pools:
            facade.put_pool(Pool(name=name))
        for p in range(cc.partitions):
            for i in range(cc.jobs_before):
                job = _job(p, i)
                facade.create_jobs([job])
                committed[p].append(job.uuid)

        # ---- victim batch with a fault-lost ack ----------------------
        outcomes: List[tuple] = []

        def victim_writer(i: int):
            job = _job(cc.victim, 10_000 + i)
            try:
                stores[cc.victim].create_jobs([job])
                outcomes.append(("committed", job.uuid))
            except ReplicationIndeterminate:
                outcomes.append(("indeterminate", job.uuid))
            except Exception as e:
                outcomes.append((f"unexpected:{type(e).__name__}",
                                 job.uuid))

        injector.arm("repl.ack", probability=1.0, max_fires=1)
        try:
            threads = [threading.Thread(target=victim_writer, args=(i,))
                       for i in range(cc.writers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30.0)
        finally:
            injector.disarm("repl.ack")
        result.unresolved_writers += sum(1 for t in threads
                                         if t.is_alive())
        for outcome, uuid in outcomes:
            if outcome == "indeterminate":
                result.victim_indeterminate += 1
                committed[cc.victim].append(uuid)  # on the synced mirror
            elif outcome == "committed":
                committed[cc.victim].append(uuid)
            else:
                result.violations.append(
                    f"victim-batch writer got {outcome}")
        if not result.victim_indeterminate:
            result.violations.append(
                "injected ack loss demuxed no indeterminate outcome on "
                "the victim partition")

        # sibling writers must see the fault-point ONLY on the victim:
        # arm/disarm above is global, so their phase runs after disarm —
        # what stays per-partition is the demux (asserted below: zero
        # sibling indeterminates while their streams run through the
        # victim's whole promotion window)

        # ---- sibling streams through the kill + promotion ------------
        stop_siblings = threading.Event()
        sibling_log: List[tuple] = []  # (ts, partition, uuid | error)
        sibling_errors = [0]

        def sibling_writer(p: int):
            i = 20_000
            while not stop_siblings.is_set():
                job = _job(p, i)
                i += 1
                try:
                    stores[p].create_jobs([job])
                    sibling_log.append((_time.monotonic(), p, job.uuid))
                except Exception as e:
                    sibling_errors[0] += 1
                    sibling_log.append(
                        (_time.monotonic(), p,
                         f"error:{type(e).__name__}"))
                    return

        sibling_threads = [threading.Thread(target=sibling_writer,
                                            args=(p,))
                           for p in range(cc.partitions)
                           if p != cc.victim]
        for t in sibling_threads:
            t.start()
        _time.sleep(0.1)  # streams flowing before the kill

        # ---- kill the victim's leader (sigkill-equivalent) -----------
        kill_ts = _time.monotonic()
        if not _wait(lambda: followers[cc.victim].offset
                     >= _journal_bytes(os.path.join(
                         root, f"p{cc.victim}", "leader"))):
            result.violations.append(
                "victim standby never reached the head pre-kill")
        followers[cc.victim].stop()
        servers[cc.victim].stop()
        stores[cc.victim].close()  # crash: no checkpoint

        # ---- promote the victim's standby (failover machinery, lease p)
        d_standby = os.path.join(root, f"p{cc.victim}", "standby")
        pos = repl.candidate_position(d_standby)
        if not pos.get("synced"):
            result.violations.append(
                f"victim standby position not synced: {pos}")
        authority = partition_lock_path(election, cc.victim) + ".epoch"
        write_atomic_int(authority, 2)
        try:
            repl.assert_promotable(d_standby)
        except RuntimeError as e:
            result.violations.append(f"promotion gate refused: {e}")
            return result
        promoted = Store.open(d_standby, epoch=2, shared=False,
                              partition=cc.victim)
        promoted.attach_fence_authority(authority)
        cleanup.append(promoted.close)
        result.promoted_epoch = 2
        promote_ts = _time.monotonic()
        result.promotion_window_s = promote_ts - kill_ts

        # siblings keep streaming a little past the promotion, then stop
        deadline = _time.monotonic() + max(
            0.0, cc.sibling_stream_s - (promote_ts - kill_ts))
        while _time.monotonic() < deadline and not sibling_errors[0]:
            _time.sleep(0.01)
        stop_siblings.set()
        for t in sibling_threads:
            t.join(timeout=30.0)
        result.unresolved_writers += sum(1 for t in sibling_threads
                                         if t.is_alive())
        result.sibling_errors = sibling_errors[0]
        in_window = [e for e in sibling_log
                     if kill_ts <= e[0] <= promote_ts
                     and not str(e[2]).startswith("error:")]
        result.sibling_commits_during_promotion = len(in_window)
        if sibling_errors[0]:
            result.violations.append(
                f"{sibling_errors[0]} sibling writer(s) errored during "
                "the victim's failover — sibling partitions must keep "
                "committing uninterrupted")
        if not in_window:
            result.violations.append(
                "no sibling commit landed inside the victim's promotion "
                "window — the sibling commit stream stalled")
        for ts, p, uuid in sibling_log:
            if not str(uuid).startswith("error:"):
                committed[p].append(uuid)

        # ---- zero loss: promoted store + rebuilt facade --------------
        for uuid in committed[cc.victim]:
            if promoted.job(uuid) is None:
                result.violations.append(
                    f"victim-partition commit {uuid} lost by the "
                    "promotion")
        new_stores = list(stores)
        new_stores[cc.victim] = promoted
        facade = PartitionedStore(new_stores, pmap)
        for p, uuids in committed.items():
            result.committed_by_partition[f"p{p}"] = len(uuids)
            result.committed += len(uuids)
            for uuid in uuids:
                if facade.job(uuid) is None:
                    result.violations.append(
                        f"committed job {uuid} (partition {p}) missing "
                        "from the rebuilt facade")
                    break
    finally:
        for fn in reversed(cleanup):
            try:
                fn()
            except Exception:
                pass
        for store in stores:
            try:
                store.close()
            except Exception:
                pass
        injector.disarm("repl.ack")
    return result


def run_partition_chaos_procs(cc: Optional[PartitionChaosConfig] = None
                              ) -> PartitionChaosResult:
    """The multi-CONTROLLER form of :func:`run_partition_chaos`: each
    partition's leader is a real shard worker PROCESS (``python -m
    cook_tpu_torch.sched.shard``, sched/shard.py store role — own
    journal, fence authority, group commit, sync socket replication),
    the parent mirrors each journal with a synced standby follower,
    and the victim partition's worker is lost to a real ``SIGKILL``
    mid-batch.  The same invariants as the thread-based variant, now
    across process boundaries:

    - the fault-lost replication ack (armed INSIDE the victim process)
      demuxes every concurrent writer to committed or indeterminate —
      never a hang, never a silent drop;
    - sibling shard processes keep committing THROUGH the kill and the
      whole promotion window (zero errors, nonzero in-window commits);
    - the victim's standby promotes via the candidate ranking
      (candidate position, promotion gate, epoch-2 fencing) and holds
      every committed-or-indeterminate transaction — zero loss;
    - every sibling partition still serves every commit it acked.
    """
    import os
    import signal as _signal
    import tempfile
    import threading
    import time as _time

    from ..sched.election import partition_lock_path
    from ..sched.shard import ShardSupervisor, rpc
    from ..state import replication as repl
    from ..state.schema import Job, Resources
    from ..state.schema import to_json as _to_json
    from ..state.store import Store
    from ..utils.fsatomic import write_atomic_int

    cc = cc or PartitionChaosConfig()
    result = PartitionChaosResult(partitions=cc.partitions,
                                  process_kill=True)
    if cc.partitions < 2:
        result.violations.append("partition chaos needs >= 2 partitions")
        return result
    if not 0 <= cc.victim < cc.partitions:
        result.violations.append(f"victim {cc.victim} out of range")
        return result
    if not repl.replication_available():
        result.violations.append("native replication library unavailable")
        return result
    root = cc.data_root or tempfile.mkdtemp(prefix="cook-partchaos-")
    election = os.path.join(root, "election")
    os.makedirs(election, exist_ok=True)
    committed: Dict[int, List[str]] = {p: [] for p in range(cc.partitions)}

    def _job(p: int, i: int) -> Dict:
        return _to_json(Job(
            uuid=f"0000000{p}-0000-4000-8000-{i:012d}",
            user=f"chaos{p}", command=f"echo {i}", pool=f"pool-p{p}",
            resources=Resources(cpus=1, mem=64)))

    per_shard = []
    for p in range(cc.partitions):
        authority = partition_lock_path(election, p) + ".epoch"
        write_atomic_int(authority, 1)
        per_shard.append({
            "role": "store", "data_dir": os.path.join(root, f"p{p}",
                                                      "leader"),
            "authority": authority, "epoch": 1, "replicate": True,
            "group_commit": cc.group_commit,
            "ack_timeout_s": cc.ack_timeout_s})
    sup = ShardSupervisor(cc.partitions, {"role": "store"},
                          root=os.path.join(root, "run"),
                          per_shard=per_shard)
    followers = []
    promoted = None
    try:
        sup.start()
        # ---- parent-side synced standby per partition worker ---------
        for p in range(cc.partitions):
            d_standby = os.path.join(root, f"p{p}", "standby")
            f = repl.ReplicationFollower(
                "127.0.0.1", int(sup.procs[p].addr["repl_port"]), d_standby)
            repl.record_followed_epoch(d_standby, 1)
            followers.append(f)
        for p in range(cc.partitions):
            if not _wait(lambda p=p: sup.rpc(
                    p, {"cmd": "repl_status"})["synced_followers"] >= 1):
                result.violations.append(
                    f"partition {p} standby never synced")
                return result
            sup.rpc(p, {"cmd": "put_pool", "name": f"pool-p{p}"})
            for i in range(cc.jobs_before):
                doc = _job(p, i)
                sup.rpc(p, {"cmd": "submit", "jobs": [doc]})
                committed[p].append(doc["uuid"])

        # ---- victim batch with the ack fault armed IN the worker -----
        sup.rpc(cc.victim, {"cmd": "arm_fault", "point": "repl.ack",
                            "probability": 1.0, "max_fires": 1})
        outcomes: List[tuple] = []

        def victim_writer(i: int):
            doc = _job(cc.victim, 10_000 + i)
            try:
                resp = sup.rpc(cc.victim, {"cmd": "submit", "jobs": [doc]},
                               timeout_s=cc.ack_timeout_s + 25.0)
                outcomes.append((resp["outcome"], doc["uuid"]))
            except Exception as e:
                outcomes.append((f"unexpected:{type(e).__name__}",
                                 doc["uuid"]))

        threads = [threading.Thread(target=victim_writer, args=(i,))
                   for i in range(cc.writers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        result.unresolved_writers += sum(1 for t in threads if t.is_alive())
        for outcome, uuid in outcomes:
            if outcome in ("indeterminate", "committed"):
                if outcome == "indeterminate":
                    result.victim_indeterminate += 1
                committed[cc.victim].append(uuid)  # on the synced mirror
            else:
                result.violations.append(f"victim-batch writer got {outcome}")
        if not result.victim_indeterminate:
            result.violations.append(
                "injected ack loss demuxed no indeterminate outcome on "
                "the victim partition")

        # ---- sibling streams through the kill + promotion ------------
        stop_siblings = threading.Event()
        sibling_log: List[tuple] = []
        sibling_errors = [0]

        def sibling_writer(p: int):
            i = 20_000
            port = sup.procs[p].port
            while not stop_siblings.is_set():
                doc = _job(p, i)
                i += 1
                try:
                    rpc(port, {"cmd": "submit", "jobs": [doc]},
                        timeout_s=30.0)
                    sibling_log.append((_time.monotonic(), p, doc["uuid"]))
                except Exception as e:
                    sibling_errors[0] += 1
                    sibling_log.append((_time.monotonic(), p,
                                        f"error:{type(e).__name__}"))
                    return

        sibling_threads = [threading.Thread(target=sibling_writer, args=(p,))
                           for p in range(cc.partitions) if p != cc.victim]
        for t in sibling_threads:
            t.start()
        _time.sleep(0.1)  # streams flowing before the kill

        # ---- REAL process kill of the victim's worker ----------------
        if not _wait(lambda: followers[cc.victim].offset
                     >= sup.rpc(cc.victim,
                                {"cmd": "repl_status"})["journal_bytes"]):
            result.violations.append(
                "victim standby never reached the head pre-kill")
        kill_ts = _time.monotonic()
        sup.kill(cc.victim, _signal.SIGKILL)
        followers[cc.victim].stop()

        # ---- promote the standby (failover machinery, parent side) --
        d_standby = os.path.join(root, f"p{cc.victim}", "standby")
        pos = repl.candidate_position(d_standby)
        if not pos.get("synced"):
            result.violations.append(
                f"victim standby position not synced: {pos}")
        authority = partition_lock_path(election, cc.victim) + ".epoch"
        write_atomic_int(authority, 2)
        try:
            repl.assert_promotable(d_standby)
        except RuntimeError as e:
            result.violations.append(f"promotion gate refused: {e}")
            return result
        promoted = Store.open(d_standby, epoch=2, shared=False,
                              partition=cc.victim)
        promoted.attach_fence_authority(authority)
        result.promoted_epoch = 2
        promote_ts = _time.monotonic()
        result.promotion_window_s = promote_ts - kill_ts

        # siblings stream a little past the promotion, then stop
        deadline = _time.monotonic() + max(
            0.0, cc.sibling_stream_s - (promote_ts - kill_ts))
        while _time.monotonic() < deadline and not sibling_errors[0]:
            _time.sleep(0.01)
        stop_siblings.set()
        for t in sibling_threads:
            t.join(timeout=60.0)
        result.unresolved_writers += sum(1 for t in sibling_threads
                                         if t.is_alive())
        result.sibling_errors = sibling_errors[0]
        in_window = [e for e in sibling_log
                     if kill_ts <= e[0] <= promote_ts
                     and not str(e[2]).startswith("error:")]
        result.sibling_commits_during_promotion = len(in_window)
        if sibling_errors[0]:
            result.violations.append(
                f"{sibling_errors[0]} sibling writer(s) errored during "
                "the victim's failover — sibling shard processes must "
                "keep committing uninterrupted")
        if not in_window:
            result.violations.append(
                "no sibling commit landed inside the victim's promotion "
                "window — the sibling commit stream stalled")
        for _ts, p, uuid in sibling_log:
            if not str(uuid).startswith("error:"):
                committed[p].append(uuid)

        # ---- zero loss: promoted store + live sibling workers --------
        for uuid in committed[cc.victim]:
            if promoted.job(uuid) is None:
                result.violations.append(
                    f"victim-partition commit {uuid} lost by the "
                    "promotion")
        for p, uuids in committed.items():
            result.committed_by_partition[f"p{p}"] = len(uuids)
            result.committed += len(uuids)
            if p == cc.victim:
                continue
            for uuid in uuids:
                if not sup.rpc(p, {"cmd": "job", "uuid": uuid})["found"]:
                    result.violations.append(
                        f"committed job {uuid} (partition {p}) missing "
                        "from its shard worker after the failover")
                    break
    finally:
        for f in followers:
            try:
                f.stop()
            except Exception:
                pass
        if promoted is not None:
            try:
                promoted.close()
            except Exception:
                pass
        sup.stop()
    return result


def run_failover_chaos(cc: Optional[FailoverChaosConfig] = None
                       ) -> FailoverChaosResult:
    """One full quorum-aware failover under an adverse schedule:

    1. leader + two synced standbys, sync replication;
    2. standby B drops off (once-synced-then-lagged) and the leader
       keeps committing — including one commit whose ack is fault-lost
       (``repl.ack``): a first-class INDETERMINATE outcome;
    3. the leader dies (``sigkill``) or is partitioned (``partition``);
    4. a seeded lock race decides the election winner; the candidate
       ranking must still make the BEST-SYNCED position the authority —
       a laggard winner pulls the delta from the advanced peer before
       opening its store;
    5. the loser re-follows the winner and must converge
       byte-identically;
    6. (partition mode) the deposed leader's journal appends AND REST
       writes must be rejected — no split brain.

    Invariants are collected as violations, not raised, so one run
    reports everything it broke.

    It builds no ``Scheduler`` and touches no device (as in the
    reference), so it takes no ``device``: what it exercises on a
    machine with a card is the native replication library
    (``native/repl.cpp``, built into ``build/native/``) and the REST
    fence."""
    import json as _json
    import os
    import random
    import tempfile
    import urllib.error
    import urllib.request

    import threading

    from ..state import replication as repl
    from ..state.store import (ReplicationIndeterminate,
                               ReplicationTimeout, StaleEpochError)
    from ..utils.fsatomic import read_int_file, write_atomic_int

    def _concurrent_submits(store, base_i: int, n: int, outcomes: list):
        """n concurrent single-job submissions (one group-commit batch's
        worth of independent REST writers); each thread records its
        demuxed outcome — the never-silently-dropped contract is
        'every thread appends exactly one entry'."""
        def worker(i: int):
            job = _failover_job(base_i + i)
            try:
                store.create_jobs([job])
                outcomes.append(("committed", job.uuid))
            except ReplicationIndeterminate:
                outcomes.append(("indeterminate", job.uuid))
            except (StaleEpochError, ReplicationTimeout, RuntimeError):
                # clean refusals: nothing journaled (or the journal was
                # already poisoned by an earlier fence) — safe to retry
                outcomes.append(("aborted", job.uuid))
            except Exception as e:  # a waiter must never die opaquely
                outcomes.append((f"unexpected:{type(e).__name__}",
                                 job.uuid))
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        return threads

    cc = cc or FailoverChaosConfig()
    result = FailoverChaosResult()
    if not repl.replication_available():
        result.violations.append("native replication library unavailable")
        return result
    rng = random.Random(cc.seed)
    root = cc.data_root or tempfile.mkdtemp(prefix="cook-failover-")
    d_leader = os.path.join(root, "leader")
    d_a = os.path.join(root, "standby-a")
    d_b = os.path.join(root, "standby-b")
    epoch_authority = os.path.join(root, "election", "cook-leader.lock"
                                                     ".epoch")
    os.makedirs(os.path.dirname(epoch_authority), exist_ok=True)
    write_atomic_int(epoch_authority, 1)

    committed: List[str] = []
    cleanup = []
    try:
        # ---- epoch-1 leadership: leader + two synced standbys --------
        store = Store.open(d_leader, epoch=1, shared=False)
        store.attach_fence_authority(epoch_authority)
        srv = repl.ReplicationServer(d_leader, 0)
        srv.epoch = 1
        cleanup.append(srv.stop)
        store.attach_replication(srv, sync=True,
                                 timeout_s=cc.ack_timeout_s)
        if cc.group_commit:
            # a wide coalescing window so the concurrent phases reliably
            # share durability rounds (production default is sub-ms)
            store.enable_group_commit(window_ms=5.0)
        fa = repl.ReplicationFollower("127.0.0.1", srv.port, d_a)
        fb = repl.ReplicationFollower("127.0.0.1", srv.port, d_b)
        cleanup += [fa.stop, fb.stop]
        repl.record_followed_epoch(d_a, 1)
        repl.record_followed_epoch(d_b, 1)
        if not _wait(lambda: srv.synced_follower_count >= 2):
            result.violations.append("standbys never synced")
            return result
        for i in range(cc.n_jobs_before_lag):
            store.create_jobs([_failover_job(i)])
            committed.append(_failover_job(i).uuid)
        if cc.group_commit:
            # ---- healthy group-commit batch: concurrent writers share
            # durability rounds; every member commits and must survive
            # the failover like any other committed transaction
            outcomes: list = []
            threads = _concurrent_submits(store, 500_000,
                                          cc.group_commit_writers,
                                          outcomes)
            for t in threads:
                t.join(timeout=30.0)
            result.group_commit_unresolved += sum(
                1 for t in threads if t.is_alive())
            for outcome, uuid in outcomes:
                result.group_commit_outcomes[outcome] = \
                    result.group_commit_outcomes.get(outcome, 0) + 1
                if outcome == "committed":
                    committed.append(uuid)
                else:
                    result.violations.append(
                        f"healthy group-commit writer got {outcome}")
            gstats = store.group_commit_stats() or {}
            if gstats.get("max_batch", 0) < 2:
                result.violations.append(
                    "concurrent submissions never shared a group-commit "
                    f"durability round: {gstats}")
        # ---- standby B lags (once-synced-then-lagged candidate) ------
        if not _wait(lambda: os.path.exists(
                os.path.join(d_b, "repl_synced"))):
            result.violations.append("standby B never got its marker")
        fb.stop()
        # the server only notices the dead conn when the next append's
        # JDATA send fails — the first post-lag commit flushes it out
        # (wait_acked unblocks the moment the worker erases the conn)
        n = cc.n_jobs_before_lag
        for i in range(n, n + cc.n_jobs_after_lag):
            store.create_jobs([_failover_job(i)])
            committed.append(_failover_job(i).uuid)
        if srv.synced_follower_count != 1:
            result.violations.append(
                "server still counts the lagged standby as synced after "
                f"{cc.n_jobs_after_lag} commits")
        if cc.inject_indeterminate:
            # one commit's ack is lost AFTER the record is durable: the
            # store must report indeterminate, NOT excise the record —
            # standby A pulls it anyway, so the failover must keep it
            # (the phantom-commit hole)
            amb = _failover_job(n + cc.n_jobs_after_lag)
            injector.arm("repl.ack", probability=1.0, max_fires=1)
            try:
                store.create_jobs([amb])
                result.violations.append(
                    "injected ack loss did not surface as indeterminate")
            except ReplicationIndeterminate:
                result.indeterminate_commits += 1
                committed.append(amb.uuid)  # it IS on the synced mirror
            finally:
                injector.disarm("repl.ack")
            if store.job(amb.uuid) is None:
                result.violations.append(
                    "indeterminate commit was rolled back locally")
        if cc.group_commit:
            # ---- ack lost MID-BATCH: the leader's durability round for
            # a whole batch of concurrent writers fails (the shape a
            # leader death mid-group-commit leaves behind).  Every
            # waiter must resolve — the faulted round's members all
            # demux indeterminate, any straggler batch commits — and
            # since each record was written+streamed to the synced
            # mirror before its ack round, ALL must survive failover.
            outcomes2: list = []
            injector.arm("repl.ack", probability=1.0, max_fires=1)
            try:
                threads = _concurrent_submits(store, 600_000,
                                              cc.group_commit_writers,
                                              outcomes2)
                for t in threads:
                    t.join(timeout=30.0)
            finally:
                injector.disarm("repl.ack")
            result.group_commit_unresolved += sum(
                1 for t in threads if t.is_alive())
            saw_indeterminate = False
            for outcome, uuid in outcomes2:
                result.group_commit_outcomes[outcome] = \
                    result.group_commit_outcomes.get(outcome, 0) + 1
                if outcome == "indeterminate":
                    saw_indeterminate = True
                    committed.append(uuid)  # on the synced mirror
                elif outcome == "committed":
                    committed.append(uuid)
                else:
                    result.violations.append(
                        f"mid-batch ack loss: writer got {outcome} "
                        "(must be committed or indeterminate)")
            if not saw_indeterminate:
                result.violations.append(
                    "injected mid-batch ack loss demuxed no "
                    "indeterminate outcome to its waiters")
            if result.group_commit_unresolved:
                result.violations.append(
                    f"{result.group_commit_unresolved} group-commit "
                    "waiter(s) never resolved (silently dropped)")
            gstats = store.group_commit_stats() or {}
            result.group_commit_batches = int(gstats.get("batches", 0))
        result.committed = len(committed)
        if not _wait(lambda: fa.offset >= _journal_bytes(d_leader)):
            result.violations.append("standby A never reached the head")

        # ---- leader loss ---------------------------------------------
        # either way the standbys lose their stream (fa released so a
        # winning candidate can reopen d_a as its own store/server)
        fa.stop()
        old_store = None
        if cc.leader_mode == "sigkill":
            srv.stop()
            store.close()
        else:  # partition: alive but cut off from the standbys
            old_store = store
            cleanup.append(store.close)  # incl. its group-commit stage
        pos_a = dict(repl.candidate_position(d_a), ts=None)
        pos_b = dict(repl.candidate_position(d_b), ts=None)
        if repl.rank_key(pos_a) <= repl.rank_key(pos_b):
            result.violations.append(
                f"ranking failed to order the synced-ahead candidate "
                f"first: {pos_a} vs {pos_b}")
        # ---- election: a seeded lock race, then candidate ranking ----
        winner = cc.winner or rng.choice(["advanced", "laggard"])
        result.winner = winner
        result.winner_was_laggard = winner == "laggard"
        write_atomic_int(epoch_authority, 2)
        if winner == "laggard":
            # B won the lock but A's position is strictly ahead: B must
            # pull the delta from A over the carrier before promoting
            ahead = repl.choose_successor(pos_b, {"a": pos_a})
            if ahead is None or ahead[0] != "a":
                result.violations.append(
                    f"laggard winner did not choose the advanced peer "
                    f"({ahead!r})")
            catchup_srv = repl.ReplicationServer(d_a, 0)
            cleanup.append(catchup_srv.stop)
            if not repl.catch_up_from_peer("127.0.0.1", catchup_srv.port,
                                           d_b, pos_a["offset"]):
                result.violations.append("delta pull from peer failed")
            else:
                result.delta_pulled = True
            catchup_srv.stop()
            d_winner, d_loser = d_b, d_a
        else:
            if repl.choose_successor(pos_a, {"b": pos_b}) is not None:
                result.violations.append(
                    "advanced winner was told to catch up from a "
                    "lagging peer")
            d_winner, d_loser = d_a, d_b
        try:
            repl.assert_promotable(d_winner)
        except RuntimeError as e:
            result.violations.append(f"promotion gate refused the "
                                     f"winner: {e}")
            return result
        promoted = Store.open(d_winner, epoch=2, shared=False)
        promoted.attach_fence_authority(epoch_authority)
        new_srv = repl.ReplicationServer(d_winner, 0)
        new_srv.epoch = 2
        cleanup.append(new_srv.stop)
        promoted.attach_replication(new_srv, sync=True,
                                    timeout_s=cc.ack_timeout_s)
        # ---- zero loss ----------------------------------------------
        for uuid in committed:
            if promoted.job(uuid) is None:
                result.violations.append(
                    f"committed job {uuid} lost by the failover")
            elif not any(
                    e["kind"] == "submitted"
                    for e in promoted.audit.timeline(uuid)):
                # the audit lane rode the mirrored journal bytes: the
                # winner's replay must reconstruct each committed job's
                # timeline too (a laggard winner gets it via delta pull)
                result.audit_timeline_ok = False
                result.violations.append(
                    f"audit timeline for committed job {uuid} lost by "
                    "the failover")
        # ---- the loser re-follows the winner and converges ----------
        loser_f = repl.ReplicationFollower("127.0.0.1", new_srv.port,
                                           d_loser)
        cleanup.append(loser_f.stop)
        repl.record_followed_epoch(d_loser, 2)
        promoted.create_jobs([_failover_job(999_999)])  # post-failover tx
        result.laggard_converged = _wait(
            lambda: open(os.path.join(d_loser, "journal.jsonl"),
                         "rb").read()
            == open(os.path.join(d_winner, "journal.jsonl"), "rb").read()
            if os.path.exists(os.path.join(d_loser, "journal.jsonl"))
            else False)
        if not result.laggard_converged:
            result.violations.append(
                "the losing standby did not converge on the winner")
        loser_f.stop()
        # ---- fencing the deposed-but-alive leader -------------------
        if old_store is not None:
            try:
                old_store.create_jobs([_failover_job(666_666)])
                result.violations.append(
                    "deposed leader's journal append was accepted")
            except StaleEpochError:
                result.fenced_appends_rejected += 1
            srv.fence()
            if srv.wait_acked(10 ** 9, timeout_s=0.01):
                result.violations.append(
                    "fenced replication server confirmed an ack wait")
            # REST write path flips the moment the epoch is superseded
            from ..rest.api import ApiServer, CookApi
            api = CookApi(old_store)
            api.fence_guard = lambda: (
                (read_int_file(epoch_authority) or 0)
                > (old_store._journal_epoch or 0))
            rest = ApiServer(api)
            rest.start()
            cleanup.append(rest.stop)
            req = urllib.request.Request(
                rest.url + "/jobs", method="POST",
                data=_json.dumps({"jobs": [{"command": "x"}]}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Cook-User": "chaos"})
            try:
                urllib.request.urlopen(req, timeout=5)
                result.violations.append(
                    "deposed leader accepted a REST write")
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    result.fenced_rest_writes_rejected += 1
                else:
                    result.violations.append(
                        f"deposed leader's REST write got {e.code}, "
                        "not 503")
            # no split brain: the deposed leader holds no commit the
            # successor lacks (its last accepted tx was pre-partition)
            if old_store.job(_failover_job(666_666).uuid) is not None:
                result.violations.append(
                    "fenced append landed in the deposed leader's store")
        promoted.close()
    finally:
        for fn in reversed(cleanup):
            try:
                fn()
            except Exception:
                pass
        injector.disarm("repl.ack")
    return result
