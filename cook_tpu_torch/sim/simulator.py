"""The port's copy of ``cook_tpu/sim/simulator.py`` (imports re-rooted).

``Simulator`` and ``run_pipeline_parity`` take ``device`` (default
``"cuda"``) and hand it to the ``Scheduler``: every device path of the
replay (the fused cycle, the split ranker and matcher of
``backend="tpu"``, the preemption search) runs there.  ``backend``
keeps the reference's meaning: it picks the rank and matcher backends
and the default cycle mode, never the device.

Faster-than-real-time trace-replay simulator.

The port of the reference's simulator (reference:
scheduler/test/cook/test/zz_simulator.clj:355-718 + docs/simulator.md and the
mesos_mock offer fabricator): replay a JSON job trace against the *real*
scheduler wired to the fake cluster on a virtual clock.  Time advances only
between events, so runs compare *decisions*, not wall time; the wall-clock
cost of each rank/match cycle is recorded separately as the performance
metric (BASELINE.md: match-cycle p50/p99 + placements/sec).

Trace format (one job per entry):
  {"uuid": ..., "user": "u1", "submit_time": ms, "duration": ms,
   "cpus": 1.0, "mem": 100.0, "gpus": 0, "priority": 50, "pool": "default"}
Host file: [{"hostname": "h1", "cpus": 8, "mem": 8192, "gpus": 0, ...}]
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..cluster.fake import FakeCluster, FakeHost
from ..config import Config
from ..sched.scheduler import Scheduler
from ..state.schema import InstanceStatus, Job, JobState, Resources, new_uuid
from ..state.store import Store


@dataclass
class SimResult:
    completed: int = 0
    total: int = 0
    preemptions: int = 0
    makespan_ms: int = 0
    wait_times_ms: List[int] = field(default_factory=list)
    match_wall_ms: List[float] = field(default_factory=list)
    rank_wall_ms: List[float] = field(default_factory=list)
    placements: int = 0
    task_records: List[Dict] = field(default_factory=list)
    # flight-recorder aggregate over this run's cycles (utils/flight.py):
    # cycle count/percentiles, recompiles, transfer bytes, skip reasons
    flight: Dict = field(default_factory=dict)
    # per-job audit-trail aggregate (utils/audit.py): jobs tracked +
    # event counts by kind — sanity that attribution engaged
    audit: Dict = field(default_factory=dict)
    # goodput aggregate (docs/GANG.md elasticity; the optimizer loop's
    # replay score and the elastic_cycle bench read this): busy-capacity
    # fraction, placed-gang-member fraction, resize counts, and the
    # never-placed demand the autoscale decision sizes against
    goodput: Dict = field(default_factory=dict)

    def summary(self) -> Dict:
        wt = np.asarray(self.wait_times_ms or [0])
        mw = np.asarray(self.match_wall_ms or [0.0])
        rw = np.asarray(self.rank_wall_ms or [0.0])
        wall_s = (np.sum(mw) + np.sum(rw)) / 1000.0
        return {
            "jobs_total": self.total,
            "jobs_completed": self.completed,
            "preemptions": self.preemptions,
            "makespan_virtual_s": self.makespan_ms / 1000.0,
            "wait_time_p50_s": float(np.percentile(wt, 50)) / 1000.0,
            "wait_time_p99_s": float(np.percentile(wt, 99)) / 1000.0,
            "match_cycle_p50_ms": float(np.percentile(mw, 50)),
            "match_cycle_p99_ms": float(np.percentile(mw, 99)),
            "rank_cycle_p50_ms": float(np.percentile(rw, 50)),
            "placements": self.placements,
            "placements_per_wall_s": (self.placements / wall_s
                                      if wall_s > 0 else float("inf")),
            "flight": self.flight,
            "audit": self.audit,
            "goodput": self.goodput,
        }


def load_trace(entries: List[Dict]) -> List[Job]:
    jobs = []
    for e in entries:
        jobs.append(Job(
            uuid=e.get("uuid") or new_uuid(),
            user=e["user"],
            command=e.get("command", "sim"),
            resources=Resources(cpus=float(e.get("cpus", 1.0)),
                                mem=float(e.get("mem", 100.0)),
                                gpus=float(e.get("gpus", 0.0))),
            priority=int(e.get("priority", 50)),
            max_retries=int(e.get("max_retries", 3)),
            pool=e.get("pool", "default"),
            submit_time_ms=int(e["submit_time"]),
            labels={"sim/duration_ms": str(int(e.get("duration", 1000)))},
        ))
    jobs.sort(key=lambda j: j.submit_time_ms)
    return jobs


def load_hosts(entries: List[Dict]) -> List[FakeHost]:
    return [FakeHost(
        hostname=e["hostname"],
        capacity=Resources(cpus=float(e.get("cpus", 8.0)),
                           mem=float(e.get("mem", 8192.0)),
                           gpus=float(e.get("gpus", 0.0))),
        pool=e.get("pool", "default"),
        attributes=dict(e.get("attributes", {})),
        gpu_model=e.get("gpu_model", ""))
        for e in entries]


class Simulator:
    def __init__(self, trace: List[Job], hosts: List[FakeHost],
                 config: Optional[Config] = None, backend: str = "tpu",
                 rank_interval_ms: int = 5000, match_interval_ms: int = 1000,
                 rebalance_interval_ms: int = 30000,
                 cycle_mode: Optional[str] = None,
                 groups: Optional[Dict[str, object]] = None,
                 rate_limits=None, device="cuda"):
        self.trace = trace
        # gang groups keyed by uuid (docs/GANG.md): members referencing
        # a group here are CO-SUBMITTED as one batch with the Group at
        # the earliest member's submit time — gangs never trickle in
        self.groups = dict(groups or {})
        self.config = config or Config()
        if backend == "cpu":
            self.config.default_matcher.backend = "cpu"
        self.store = Store()
        self.cluster = FakeCluster("sim", hosts)
        self.scheduler = Scheduler(self.store, self.config, [self.cluster],
                                   rank_backend=backend,
                                   rate_limits=rate_limits,
                                   device=device)
        # overload-replay hooks (sim/overload.py): ``admit`` gates each
        # trace submission like the REST front door would (return False
        # = shed, the uuid lands in ``shed_job_uuids`` instead of the
        # store); ``on_tick`` runs once per loop iteration on the
        # virtual clock (the overload harness drives monitor sweeps —
        # and thus the admission controller — through it)
        self.admit = None
        self.on_tick = None
        self.shed_job_uuids: List[str] = []
        self.rank_interval_ms = rank_interval_ms
        self.match_interval_ms = match_interval_ms
        self.rebalance_interval_ms = rebalance_interval_ms
        # "fused": drive the production one-dispatch cycle
        # (Scheduler.step_cycle) instead of split rank/match steps.
        # Default follows Config.cycle_mode, except the no-JAX cpu backend
        # which only has the split path.
        if cycle_mode is None:
            cycle_mode = "split" if backend == "cpu" else self.config.cycle_mode
        self.cycle_mode = cycle_mode
        # job uuid -> virtual duration; the fake cluster resolves durations
        # at launch time through this shared mapping
        self._job_durations: Dict[str, int] = {}
        self.cluster.job_durations_ms = self._job_durations

    def run(self, until_ms: Optional[int] = None,
            max_virtual_ms: int = 24 * 3600 * 1000) -> SimResult:
        from ..utils.flight import recorder as flight_recorder
        result = SimResult(total=len(self.trace))
        if not self.trace:
            return result
        # the flight-recorder summary covers only THIS run's cycles
        flight_seq0 = flight_recorder.last_seq()
        pending = list(self.trace)
        now = pending[0].submit_time_ms
        # every stamp (queue/start/end times, heartbeats, reaper sweeps)
        # follows the store clock; one patch keeps the whole system in
        # virtual trace time
        self.store.clock = lambda: now
        next_rank = now
        next_match = now
        next_rebalance = now + self.rebalance_interval_ms
        deadline = until_ms if until_ms is not None \
            else pending[-1].submit_time_ms + max_virtual_ms
        start_ms = now

        elastic_on = getattr(self.config.elastic, "enabled", False) \
            and self.scheduler.elastic is not None
        while now <= deadline:
            # deliver submissions due now
            while pending and pending[0].submit_time_ms <= now:
                job = pending.pop(0)
                if self.admit is not None and not self.admit(job, now):
                    self.shed_job_uuids.append(job.uuid)
                    continue
                self._job_durations[job.uuid] = int(
                    job.labels["sim/duration_ms"])
                if job.group and job.group in self.groups:
                    # gang cohort: pull the siblings forward and submit
                    # the whole gang with its Group in one batch (gangs
                    # are co-submitted, REST enforces exactly this)
                    cohort = [job] + [j for j in pending
                                      if j.group == job.group]
                    pending = [j for j in pending
                               if j.group != job.group]
                    for m in cohort:
                        self._job_durations[m.uuid] = int(
                            m.labels["sim/duration_ms"])
                    self.store.create_jobs(
                        cohort, groups=[self.groups[job.group]])
                else:
                    self.store.create_jobs([job])
            # cycles (virtual-time frozen during computation)
            if now >= next_rank and self.cycle_mode != "fused":
                t0 = time.perf_counter()
                self.scheduler.step_rank()
                result.rank_wall_ms.append((time.perf_counter() - t0) * 1000)
                next_rank = now + self.rank_interval_ms
            if now >= next_match:
                t0 = time.perf_counter()
                if self.cycle_mode == "fused":
                    match_results = self.scheduler.step_cycle()
                else:
                    match_results = self.scheduler.step_match()
                result.match_wall_ms.append((time.perf_counter() - t0) * 1000)
                for res in match_results.values():
                    result.placements += len(res.launched_task_ids)
                next_match = now + self.match_interval_ms
            if now >= next_rebalance:
                # split mode re-ranks so the rebalancer sees post-launch
                # queues; the fused cycle already pruned launched jobs
                if self.cycle_mode != "fused":
                    self.scheduler.step_rank()
                decisions = self.scheduler.step_rebalance()
                for pool_decisions in decisions.values():
                    for d in pool_decisions:
                        result.preemptions += len(d.victim_task_ids)
                next_rebalance = now + self.rebalance_interval_ms
            self.scheduler.step_reapers(current_ms=now)
            if self.on_tick is not None:
                self.on_tick(now)
            if elastic_on:
                # elastic resize plane (docs/GANG.md elasticity): execute
                # grace-expired shrinks and the optimizer's standing
                # shrink pressure on the virtual clock
                self.scheduler.step_resize()

            # advance the clock to the next interesting moment
            candidates = [next_rank, next_match, next_rebalance]
            if pending:
                candidates.append(pending[0].submit_time_ms)
            completion = self._next_completion_ms()
            if completion is not None:
                candidates.append(completion)
            nxt = min(candidates)
            if nxt <= now:
                nxt = now + self.match_interval_ms
            now = nxt
            self.cluster.advance_to(now)
            if not pending and self._all_done():
                break

        # harvest
        result.flight = flight_recorder.summary(since_seq=flight_seq0)
        result.audit = self.store.audit.stats()
        result.makespan_ms = now - start_ms
        for job in self.trace:
            stored = self.store.job(job.uuid)
            if stored is None:
                continue
            if stored.state is JobState.COMPLETED:
                result.completed += 1
            for tid in stored.instances:
                inst = self.store.instance(tid)
                if inst is None:
                    continue
                result.task_records.append({
                    "job": job.uuid, "user": job.user, "task": tid,
                    "host": inst.hostname,
                    "status": inst.status.value,
                    "start": inst.start_time_ms, "end": inst.end_time_ms,
                    "wait_ms": inst.queue_time_ms,
                    "preempted": inst.preempted,
                })
                if inst.queue_time_ms is not None:
                    result.wait_times_ms.append(inst.queue_time_ms)
        result.goodput = self._goodput(result, now)
        return result

    def _goodput(self, result: SimResult, now: int) -> Dict:
        """Goodput aggregate over the finished run (docs/GANG.md
        elasticity): ``util`` — busy cpu-seconds as a fraction of
        capacity cpu-seconds over the makespan; ``gang_goodput`` —
        placed gang-member-seconds as a fraction of the member-seconds a
        fully-placed gang workload would have run (the bench's
        placed-member goodput, higher when elastic gangs run at partial
        strength instead of waiting whole); plus resize counts and the
        never-placed cpu demand the autoscale decision sizes against."""
        span_ms = max(result.makespan_ms, 1)
        cap_cpus = sum(h.capacity.cpus
                       for h in self.cluster._hosts.values())
        by_uuid = {j.uuid: j for j in self.trace}
        busy_cpu_ms = 0.0
        member_ms = 0.0
        placed_jobs = set()
        for r in result.task_records:
            if r.get("start") is None:
                continue
            placed_jobs.add(r["job"])
            job = by_uuid.get(r["job"])
            if job is None:
                continue
            dur = (r["end"] or now) - r["start"]
            if dur <= 0:
                continue
            busy_cpu_ms += dur * job.resources.cpus
            if job.group and job.group in self.groups:
                member_ms += dur
        gang_members = 0
        demand_ms = 0.0
        for j in self.trace:
            if j.group and j.group in self.groups:
                gang_members += 1
                demand_ms += int(j.labels.get("sim/duration_ms", 0))
        unplaced_cpus = sum(
            j.resources.cpus for j in self.trace
            if j.uuid not in placed_jobs)
        mgr = self.scheduler.elastic
        out = {
            "util": (busy_cpu_ms / (cap_cpus * span_ms)
                     if cap_cpus > 0 else 0.0),
            "unplaced_cpus": unplaced_cpus,
            "preemptions": result.preemptions,
            "grows": getattr(mgr, "grows", 0),
            "shrinks": getattr(mgr, "shrinks", 0),
        }
        if gang_members:
            # placed member-time over DEMANDED member-time: 1.0 = every
            # member ran exactly its duration; a rigid gang waiting
            # whole scores 0 where an elastic one running at gang_min
            # already banks min/size
            out["gang_goodput"] = (member_ms / demand_ms
                                   if demand_ms > 0 else 0.0)
            out["gang_members"] = gang_members
        return out

    def _next_completion_ms(self) -> Optional[int]:
        with self.cluster._lock:
            times = [t.started_at_ms + t.duration_ms
                     for t in self.cluster._tasks.values()
                     if t.duration_ms is not None]
        return min(times) if times else None

    def _all_done(self) -> bool:
        return not self.store.jobs_where(
            lambda j: j.state is not JobState.COMPLETED)


def generate_example_trace(n_jobs: int = 200, n_users: int = 6,
                           seed: int = 0, span_ms: int = 60_000,
                           duration_ms: int = 10_000) -> List[Dict]:
    """Statistical workload generator (reference: simulator/ subproject)."""
    rng = np.random.default_rng(seed)
    return [{
        "user": f"user{int(rng.integers(0, n_users)):02d}",
        "submit_time": int(rng.integers(0, span_ms)),
        "duration": int(rng.exponential(duration_ms)) + 100,
        "cpus": float(rng.integers(1, 8)),
        "mem": float(rng.integers(64, 2048)),
        "priority": int(rng.integers(0, 100)),
    } for _ in range(n_jobs)]


def generate_example_hosts(n_hosts: int = 20, seed: int = 0) -> List[Dict]:
    rng = np.random.default_rng(seed)
    return [{"hostname": f"host{i:03d}",
             "cpus": float(rng.choice([8, 16, 32])),
             "mem": float(rng.choice([8192, 16384, 32768]))}
            for i in range(n_hosts)]


def run_pipeline_parity(seed: int = 0, n_jobs: int = 60, n_hosts: int = 10,
                        depth: int = 2, backend: str = "tpu",
                        span_ms: int = 60_000,
                        duration_ms: int = 10_000,
                        device="cuda") -> Dict:
    """Deterministic pipelined-vs-sync parity harness (docs/PERFORMANCE.md):
    two identical seeded worlds driven through the PRODUCTION fused cycle
    (Scheduler.step_cycle), one with ``pipeline_depth=0`` (strictly
    synchronous) and one pipelined at ``depth``.  Asserted by
    tests/test_pipeline.py and runnable standalone
    (``python -m cook_tpu_torch.sim --parity-pipeline``):

    - both runs complete every job;
    - both runs LAUNCH the same job set (the per-cycle schedule may
      differ by the pipeline's one-cycle speculation, the work may not);
    - no job ever holds two live instances (store-level re-check);
    - the pipelined run's reconciliation conflict drops are reported
      (zero expected here: the speculation mask makes back-to-back
      cycles disjoint, and a single-threaded sim has no racing writers).
    """
    from ..utils.flight import recorder as _flight

    def run_one(d: int):
        cfg = Config()
        cfg.pipeline.depth = d
        entries = generate_example_trace(n_jobs, seed=seed,
                                         span_ms=span_ms,
                                         duration_ms=duration_ms)
        # FIXED uuids: load_trace otherwise mints fresh ones, and the two
        # runs' launched sets must be comparable by identity
        for i, e in enumerate(entries):
            e["uuid"] = f"00000000-0000-4000-8000-{i:012d}"
        trace = load_trace(entries)
        hosts = load_hosts(generate_example_hosts(n_hosts, seed=seed))
        seq0 = _flight.last_seq()
        sim = Simulator(trace, hosts, config=cfg, backend=backend,
                        cycle_mode="fused", device=device)
        res = sim.run()
        flight = _flight.summary(since_seq=seq0)
        launched = {r["job"] for r in res.task_records}
        # store-level duplicate-live re-check (the chaos harness checks
        # per-tick; end-state must hold too)
        dup = []
        for job in sim.store.jobs_where(lambda j: True):
            live = [t for t in job.instances
                    if (i := sim.store.instance(t)) is not None
                    and i.status.value in ("unknown", "running")]
            if len(live) > 1:
                dup.append(job.uuid)
        return res, launched, flight, dup

    res_sync, launched_sync, _fl_sync, dup_sync = run_one(0)
    res_pipe, launched_pipe, fl_pipe, dup_pipe = run_one(depth)
    return {
        "ok": (launched_sync == launched_pipe
               and res_sync.completed == res_sync.total
               and res_pipe.completed == res_pipe.total
               and not dup_sync and not dup_pipe),
        "jobs": n_jobs,
        "depth": depth,
        "sync_completed": res_sync.completed,
        "pipelined_completed": res_pipe.completed,
        "launched_equal": launched_sync == launched_pipe,
        "launched_only_sync": sorted(launched_sync - launched_pipe),
        "launched_only_pipelined": sorted(launched_pipe - launched_sync),
        "duplicate_live": sorted(dup_sync + dup_pipe),
        "pipelined_conflicts": fl_pipe.get("pipeline_conflicts", 0),
        "sync_placements": res_sync.placements,
        "pipelined_placements": res_pipe.placements,
    }
