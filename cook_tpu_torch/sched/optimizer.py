"""Scheduling optimizer: protocols + the real goodput loop, the port of
``cook_tpu/sched/optimizer.py``.

Two things differ from the JAX package, both stated where they live:

* the replays run on the scheduler's device (``Scheduler.device``):
  the JAX package replays on ``Simulator(..., backend="cpu")``, whose
  matcher is the numpy greedy golden; here the replay's matcher is
  pinned to ``tpu-greedy``, so ``step_match`` places through kernel K5
  (``sched/matcher.dispatch``) on a card.  K5 computes the golden's
  assignment bit for bit, so the decisions are the JAX package's; the
  replay's ranker and rebalancer stay the numpy ``cpu`` backends, as
  there (:meth:`GoodputOptimizer._replay`);
* a factory path in the JAX package (``cook_tpu.`` ...) is refused
  (:func:`_load_factory`): importing it would load JAX into the node.

Parity with the reference's optimizer subsystem (reference:
scheduler/src/cook/scheduler/optimizer.clj): ``HostFeed``/``Optimizer``
protocols, dummy implementations, a validated ``Schedule`` shape, and a
cycle driver.  The reference left the loop observational (TODO at
mesos.clj:258-267: schedule validated then dropped); this module closes
that gap with :class:`GoodputOptimizer` — the decision plane above the
elastic-gang resize machinery (sched/elastic.py, docs/GANG.md
elasticity):

1. **capture** recent traffic per pool from the live store (waiting +
   recently-submitted jobs, measured durations, elastic gang groups)
   and the pool's real host inventory;
2. **replay** it through ``sim/`` faster than real time, once per
   candidate lever setting (per-pool grow budget x shrink pressure),
   with metric writes suppressed (``registry.suppressed()``) so the
   simulated schedulers never pollute the production exposition;
3. **score** each replay on goodput (busy-capacity fraction + placed
   gang-member fraction) minus an unfairness penalty weighted by the
   LIVE fairness plane (per-user DRU table + wait-phase split,
   docs/OBSERVABILITY.md);
4. **decide** per-pool grow budgets, shrink pressure, a preemption
   budget, and an autoscale target — applied to the scheduler by
   ``Scheduler.step_optimize`` and journaled durably onto every
   affected elastic gang member's audit timeline
   (``optimizer-decision`` events, ``cs why`` renders them).

Factories are config-driven dotted paths, mirroring the reference's
``lazy-load-var`` create-fn loading (optimizer.clj:115-124).
"""

from __future__ import annotations

import importlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class HostInfo:
    """A purchasable host class (reference: optimizer.clj HostInfo schema)."""
    count: int
    instance_type: str
    cpus: float
    mem: float
    gpus: Optional[float] = None

    def validate(self) -> None:
        if self.count < 0:
            raise ValueError(f"HostInfo.count must be >= 0, got {self.count}")
        if self.cpus <= 0 or self.mem <= 0:
            raise ValueError("HostInfo cpus/mem must be positive")
        if self.gpus is not None and self.gpus <= 0:
            raise ValueError("HostInfo gpus, when present, must be positive")


class HostFeed:
    """Service producing info on hosts that can be purchased
    (reference: optimizer.clj:33 defprotocol HostFeed)."""

    def get_available_host_info(self) -> List[HostInfo]:
        raise NotImplementedError


class Optimizer:
    """Tool producing a schedule to execute
    (reference: optimizer.clj:57 defprotocol Optimizer).

    ``produce_schedule(queue, running, available, host_infos)`` returns
    ``{millis_in_future: {"suggested-matches": {HostInfo: [job uuids]}}}``.
    """

    def produce_schedule(self, queue: List[Any], running: List[Any],
                         available: List[Any],
                         host_infos: List[HostInfo]) -> Dict:
        raise NotImplementedError


class DummyHostFeed(HostFeed):
    """Returns no purchasable hosts (reference: create-dummy-host-feed)."""

    def __init__(self, config: Optional[Dict] = None):
        self.config = config or {}

    def get_available_host_info(self) -> List[HostInfo]:
        return []


class DummyOptimizer(Optimizer):
    """Returns an empty schedule (reference: create-dummy-optimizer)."""

    def __init__(self, config: Optional[Dict] = None):
        self.config = config or {}

    def produce_schedule(self, queue, running, available, host_infos):
        return {0: {"suggested-matches": {}}}


# ------------------------------------------------------------------ goodput

@dataclass
class PoolDecision:
    """One optimizer cycle's levers for one pool (docs/GANG.md
    elasticity; surfaced on ``GET /debug/optimizer`` and journaled as
    ``optimizer-decision`` audit events on affected gang members)."""

    pool: str
    #: per-cycle grow slots for satisfied elastic gangs; None = unmetered
    grow_budget: Optional[int]
    #: surplus members to shed via the grace protocol this interval
    shrink_pressure: int
    #: dynamic rebalancer ``max_preemption`` suggestion; None = leave the
    #: operator's setting alone
    preemption_budget: Optional[int]
    #: suggested TOTAL host count for the pool (autoscale target; the
    #: legacy Schedule shape carries the delta as a HostInfo suggestion)
    autoscale_hosts: int
    #: winning replay's predicted goodput in [0, ~2] (utilization +
    #: placed-gang-member fraction)
    predicted_goodput: float
    #: the pool's goodput right now (busy capacity fraction)
    current_goodput: float
    objective: float
    replayed_jobs: int
    candidates: int
    #: per-candidate replay scores, for the debug surface
    scores: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "pool": self.pool, "grow_budget": self.grow_budget,
            "shrink_pressure": self.shrink_pressure,
            "preemption_budget": self.preemption_budget,
            "autoscale_hosts": self.autoscale_hosts,
            "predicted_goodput": round(self.predicted_goodput, 4),
            "current_goodput": round(self.current_goodput, 4),
            "objective": round(self.objective, 4),
            "replayed_jobs": self.replayed_jobs,
            "candidates": self.candidates,
            "scores": {k: round(v, 4) for k, v in self.scores.items()},
        }


_GOODPUT_KEYS = {
    "lookback_seconds", "max_replay_jobs", "max_replay_hosts",
    "replay_horizon_seconds", "grow_budgets", "shrink_pressures",
    "fairness_weight", "preemption_budget_cap", "set_preemption_budget",
    "default_duration_ms",
}


class GoodputOptimizer(Optimizer):
    """The real optimizer loop (module docstring): sim-replay candidate
    grow/shrink lever settings per pool and pick the argmax of
    goodput - fairness penalty.  Config keys are boot-validated
    (unknown keys fail construction, i.e. daemon boot)."""

    def __init__(self, config: Optional[Dict] = None):
        conf = dict(config or {})
        unknown = set(conf) - _GOODPUT_KEYS
        if unknown:
            raise ValueError(
                f"unknown goodput optimizer key(s): {sorted(unknown)}")
        self.config = conf
        self.lookback_seconds = float(conf.get("lookback_seconds", 900.0))
        self.max_replay_jobs = int(conf.get("max_replay_jobs", 200))
        self.max_replay_hosts = int(conf.get("max_replay_hosts", 64))
        self.replay_horizon_seconds = float(
            conf.get("replay_horizon_seconds", 600.0))
        #: candidate per-cycle grow budgets; None = unmetered growth
        self.grow_budgets: List[Optional[int]] = [
            (None if g is None else int(g))
            for g in conf.get("grow_budgets", [0, 2, None])]
        self.shrink_pressures: List[int] = [
            int(s) for s in conf.get("shrink_pressures", [0, 2])]
        self.fairness_weight = float(conf.get("fairness_weight", 0.25))
        self.preemption_budget_cap = int(
            conf.get("preemption_budget_cap", 128))
        self.set_preemption_budget = bool(
            conf.get("set_preemption_budget", True))
        self.default_duration_ms = int(
            conf.get("default_duration_ms", 60_000))
        self.last_decisions: Dict[str, PoolDecision] = {}

    # ------------------------------------------------------- legacy protocol
    def produce_schedule(self, queue, running, available, host_infos):
        """The reference Schedule shape, carrying this loop's autoscale
        suggestions: one HostInfo per pool that wants more hosts, mapped
        to (up to 32 of) the jobs still waiting there."""
        matches: Dict[HostInfo, List] = {}
        for pool, d in self.last_decisions.items():
            extra = d.autoscale_hosts - d.scores.get("_current_hosts", 0)
            if extra <= 0:
                continue
            uuids = [getattr(j, "uuid", j) for j in queue
                     if getattr(j, "pool", pool) == pool][:32]
            matches[HostInfo(count=int(extra),
                             instance_type=f"{pool}-class",
                             cpus=max(d.scores.get("_host_cpus", 8.0), 1.0),
                             mem=max(d.scores.get("_host_mem", 8192.0),
                                     1.0))] = uuids
        return {0: {"suggested-matches": matches}}

    # ----------------------------------------------------------- world build
    def _pool_world(self, scheduler, pool_name: str, now_ms: int):
        """Capture the pool's recent traffic + host inventory as a
        replayable world: plain job entries (rebased submit times,
        measured-or-estimated durations), elastic/gang group specs, and
        FakeHost inventory.  Everything is plain data so each candidate
        replay builds FRESH Job/Group objects."""
        from ..state.schema import JobState
        store = scheduler.store
        horizon_ms = self.lookback_seconds * 1000.0
        cutoff = now_ms - horizon_ms

        def keep(j):
            if j.pool != pool_name:
                return False
            if j.state is not JobState.COMPLETED:
                return True
            return (j.submit_time_ms or 0) >= cutoff

        jobs = store.jobs_where(keep)
        jobs.sort(key=lambda j: j.submit_time_ms or 0)
        # gang groups whose members ride the replay (cohort semantics
        # must replay too, or the elastic levers meter nothing)
        group_uuids = {j.group for j in jobs if j.group}
        groups: Dict[str, Dict] = {}
        for guuid in group_uuids:
            g = store.group(guuid)
            if g is not None and getattr(g, "gang", False):
                groups[guuid] = {
                    "gang_size": g.gang_size, "gang_min": g.gang_min,
                    "gang_max": g.gang_max,
                    "gang_topology": g.gang_topology,
                    "gang_policy": g.gang_policy}
        if len(jobs) > self.max_replay_jobs:
            # keep newest, but never split a gang's cohort
            kept = {j.uuid for j in jobs[-self.max_replay_jobs:]}
            kept_groups = {j.group for j in jobs
                           if j.group and j.uuid in kept}
            jobs = [j for j in jobs
                    if j.uuid in kept
                    or (j.group and j.group in kept_groups)]
        t0 = min((j.submit_time_ms or 0) for j in jobs) if jobs else 0
        entries = []
        for j in jobs:
            duration = self._estimate_duration(store, j, now_ms)
            entries.append({
                "uuid": j.uuid, "user": j.user,
                "submit_ms": max(int((j.submit_time_ms or 0) - t0), 0),
                "duration_ms": duration, "group": j.group,
                "cpus": j.resources.cpus, "mem": j.resources.mem,
                "gpus": j.resources.gpus, "priority": j.priority})
        hosts = []
        for cluster in scheduler.clusters.values():
            if not cluster.accepts_pool(pool_name):
                continue
            for offer in cluster.hosts(pool_name):
                hosts.append({
                    "hostname": offer.hostname,
                    "cpus": offer.capacity.cpus,
                    "mem": offer.capacity.mem,
                    "gpus": offer.capacity.gpus,
                    "attributes": dict(offer.attributes)})
                if len(hosts) >= self.max_replay_hosts:
                    break
            if len(hosts) >= self.max_replay_hosts:
                break
        return entries, groups, hosts

    def _estimate_duration(self, store, job, now_ms: int) -> int:
        """Measured duration when the job ran; elapsed-so-far for
        running jobs (a lower bound is honest enough for replay);
        config default otherwise."""
        best = None
        for tid in job.instances:
            inst = store.instance(tid)
            if inst is None or not inst.start_time_ms:
                continue
            if inst.end_time_ms:
                best = max(best or 0, inst.end_time_ms - inst.start_time_ms)
            else:
                best = max(best or 0, now_ms - inst.start_time_ms)
        d = int(best) if best else self.default_duration_ms
        return max(d, 100)

    # --------------------------------------------------------------- replay
    def _replay(self, entries: List[Dict], groups: Dict[str, Dict],
                hosts: List[Dict], grow: Optional[int],
                shrink: int, device="cuda") -> Dict[str, float]:
        """One candidate replay: fresh world, levers applied, metrics
        suppressed, scored.  Returns the replay measurements.

        The split cycle of the ``cpu`` backend (numpy ranker and
        rebalancer) with its matcher pinned to ``tpu-greedy``: the
        matches run through K5 on ``device`` (the scheduler's), where
        the JAX package runs the numpy greedy golden, which K5 equals
        bit for bit."""
        from ..config import Config
        from ..sim.simulator import Simulator, load_hosts
        from ..state.schema import Group, Job, Resources
        from ..utils.metrics import registry

        jobs = [Job(uuid=e["uuid"], user=e["user"], command="replay",
                    resources=Resources(cpus=e["cpus"], mem=e["mem"],
                                        gpus=e["gpus"]),
                    priority=e["priority"], group=e["group"],
                    submit_time_ms=e["submit_ms"],
                    labels={"sim/duration_ms": str(e["duration_ms"])})
                for e in entries]
        jobs.sort(key=lambda j: j.submit_time_ms)
        members: Dict[str, List[str]] = {}
        for j in jobs:
            if j.group in groups:
                members.setdefault(j.group, []).append(j.uuid)
        gang_groups = {
            guuid: Group(uuid=guuid, gang=True,
                         gang_size=g["gang_size"] or len(members[guuid]),
                         gang_min=g["gang_min"], gang_max=g["gang_max"],
                         gang_topology=g["gang_topology"],
                         gang_policy=g["gang_policy"],
                         jobs=list(members[guuid]))
            for guuid, g in groups.items() if guuid in members}
        cfg = Config()
        cfg.elastic.shrink_grace_seconds = 0.0  # replay sheds immediately
        sim = Simulator(jobs, load_hosts(hosts), config=cfg,
                        backend="cpu", groups=gang_groups, device=device)
        # the cpu backend set the numpy golden; K5 is the same greedy
        cfg.default_matcher.backend = "tpu-greedy"
        if grow is not None:
            sim.scheduler.elastic.grow_budget["default"] = float(grow)
        if shrink:
            sim.scheduler.elastic.shrink_pressure["default"] = int(shrink)
        with registry.suppressed():
            res = sim.run(max_virtual_ms=int(
                self.replay_horizon_seconds * 1000))
        m = dict(res.goodput)
        m["wait_unfairness"] = self._wait_unfairness(res)
        m["completed"] = res.completed
        return m

    @staticmethod
    def _wait_unfairness(res) -> float:
        """Spread of per-user mean wait, normalized by the overall mean
        — the replay-side fairness term the live DRU bias weights."""
        import numpy as np
        by_user: Dict[str, List[float]] = {}
        for r in res.task_records:
            if r.get("wait_ms") is not None:
                by_user.setdefault(r["user"], []).append(r["wait_ms"])
        if len(by_user) < 2:
            return 0.0
        means = np.array([float(np.mean(v)) for v in by_user.values()])
        overall = float(np.mean(means))
        if overall <= 0:
            return 0.0
        return float(np.std(means)) / overall

    # --------------------------------------------------------------- decide
    def optimize(self, scheduler) -> Dict[str, PoolDecision]:
        """One full decision cycle over every active pool (module
        docstring steps 1-4; application/journaling is the scheduler's
        ``step_optimize``)."""
        store = scheduler.store
        now_ms = store.clock()
        decisions: Dict[str, PoolDecision] = {}
        for pool in store.pools():
            if pool.state != "active":
                continue
            d = self._optimize_pool(scheduler, pool.name, now_ms)
            if d is not None:
                decisions[pool.name] = d
        self.last_decisions = decisions
        return decisions

    def _optimize_pool(self, scheduler, pool_name: str,
                       now_ms: int) -> Optional[PoolDecision]:
        entries, groups, hosts = self._pool_world(
            scheduler, pool_name, now_ms)
        if not entries or not hosts:
            return None
        # POOL-LOCAL elastic presence: only pools whose own replay world
        # carries an elastic gang pay the candidate sweep — the levers
        # meter nothing anywhere else
        elastic_present = any(
            not ((g["gang_min"] or g["gang_size"])
                 == (g["gang_max"] or g["gang_size"])
                 == g["gang_size"])
            for g in groups.values())
        # the LIVE fairness plane biases the penalty: users over share
        # (DRU >= 1) mean unfair replays should hurt more
        dru = scheduler.store.audit.user_dru_table(pool_name)
        over_share = sum(1 for v in dru.values() if v >= 1.0)
        fairness_bias = 1.0 + (over_share / len(dru) if dru else 0.0)
        if elastic_present:
            candidates: List[Tuple[Optional[int], int]] = [
                (g, s) for g in self.grow_budgets
                for s in self.shrink_pressures]
            # evaluation order doubles as the tie-break: strict > below
            # keeps the FIRST of equal scores, and equal goodput should
            # keep the least-restrictive levers (unmetered growth, no
            # pressure), not freeze growth for nothing
            candidates.sort(key=lambda c: (
                0 if c[0] is None else 1, -(c[0] or 0), c[1]))
        else:
            # nothing to meter: a single baseline replay still yields
            # the autoscale/preemption decision
            candidates = [(None, 0)]
        best = None
        scores: Dict[str, float] = {}
        device = getattr(scheduler, "device", "cuda")
        for grow, shrink in candidates:
            try:
                m = self._replay(entries, groups, hosts, grow, shrink,
                                 device=device)
            except Exception:
                log.exception("optimizer replay failed (pool=%s grow=%s "
                              "shrink=%s)", pool_name, grow, shrink)
                continue
            goodput = m.get("util", 0.0) + m.get("gang_goodput", 0.0)
            obj = goodput - self.fairness_weight * fairness_bias \
                * m.get("wait_unfairness", 0.0)
            scores[f"grow={grow},shrink={shrink}"] = obj
            if best is None or obj > best[0]:
                best = (obj, grow, shrink, m)
        if best is None:
            return None
        obj, grow, shrink, m = best
        current = self._current_goodput(scheduler, pool_name)
        n_hosts = len(hosts)
        host_cpus = (sum(h["cpus"] for h in hosts) / n_hosts) or 1.0
        # autoscale: capacity to absorb the replay's never-placed demand
        unplaced = m.get("unplaced_cpus", 0.0)
        extra_hosts = int(unplaced // host_cpus) if unplaced > 0 else 0
        # preemption budget: only when the live plane shows users over
        # share AND the winning replay still preempted under pressure
        budget = None
        if self.set_preemption_budget and over_share \
                and m.get("preemptions", 0) > 0:
            budget = min(int(m["preemptions"]) * 2,
                         self.preemption_budget_cap)
        scores["_current_hosts"] = float(n_hosts)
        scores["_host_cpus"] = host_cpus
        scores["_host_mem"] = (sum(h["mem"] for h in hosts) / n_hosts) or 1.0
        return PoolDecision(
            pool=pool_name, grow_budget=grow, shrink_pressure=shrink,
            preemption_budget=budget,
            autoscale_hosts=n_hosts + extra_hosts,
            predicted_goodput=m.get("util", 0.0) + m.get("gang_goodput", 0.0),
            current_goodput=current, objective=obj,
            replayed_jobs=len(entries), candidates=len(candidates),
            scores=scores)

    @staticmethod
    def _current_goodput(scheduler, pool_name: str) -> float:
        """Busy-capacity fraction right now, from the pool's offers."""
        cap = busy = 0.0
        for cluster in scheduler.clusters.values():
            if not cluster.accepts_pool(pool_name):
                continue
            for offer in cluster.hosts(pool_name):
                cap += offer.capacity.cpus
                busy += max(offer.capacity.cpus - offer.available.cpus, 0.0)
        return busy / cap if cap > 0 else 0.0


def validate_schedule(schedule: Dict) -> None:
    """Structural validation of a Schedule (reference: optimizer.clj Schedule
    schema + s/validate at :111)."""
    if not isinstance(schedule, dict):
        raise ValueError("schedule must be a dict of time-period -> step")
    for period_ms, step in schedule.items():
        if not isinstance(period_ms, int) or period_ms < 0:
            raise ValueError(f"schedule key {period_ms!r} is not a "
                             "non-negative integer of millis-in-future")
        if not isinstance(step, dict) or "suggested-matches" not in step:
            raise ValueError(f"schedule step at {period_ms} is missing "
                             "'suggested-matches'")
        matches = step["suggested-matches"]
        if not isinstance(matches, dict):
            raise ValueError("suggested-matches must map HostInfo -> [uuid]")
        for host_info, uuids in matches.items():
            if not isinstance(host_info, HostInfo):
                raise ValueError(f"suggested-matches key {host_info!r} is "
                                 "not a HostInfo")
            host_info.validate()
            if not isinstance(uuids, (list, tuple)):
                raise ValueError("suggested-matches values must be lists of "
                                 "job uuids")


def optimizer_cycle(get_queue: Callable[[], List[Any]],
                    get_running: Callable[[], List[Any]],
                    get_offers: Callable[[], List[Any]],
                    host_feed: HostFeed,
                    optimizer: Optimizer) -> Dict:
    """One optimizer cycle (reference: optimizer-cycle! optimizer.clj:90-113):
    gather queue/running/host info, produce a schedule, validate it."""
    queue = get_queue()
    running = get_running()
    # Offer integration with pools is not implemented in the reference
    # either (optimizer.clj:106); pass the empty set for parity.
    available: List[Any] = []
    host_infos = host_feed.get_available_host_info()
    for info in host_infos:
        if not isinstance(info, HostInfo):
            raise ValueError(f"host feed produced non-HostInfo {info!r}")
        info.validate()
    schedule = optimizer.produce_schedule(queue, running, available,
                                          host_infos)
    validate_schedule(schedule)
    return schedule


def _load_factory(dotted: str) -> Callable:
    """Resolve 'pkg.module.fn' (reference: lazy-load-var).  A path in
    the JAX package is refused, never rewritten: the message names the
    port's counterpart."""
    module_name, _, attr = dotted.rpartition(".")
    if not module_name:
        raise ValueError(f"factory path {dotted!r} must be module.attr")
    if module_name == "cook_tpu" or module_name.startswith("cook_tpu."):
        counterpart = "cook_tpu_torch" + dotted[len("cook_tpu"):]
        raise ValueError(
            f"optimizer factory {dotted!r} is in the JAX package, which "
            f"the port never imports; use {counterpart!r}")
    return getattr(importlib.import_module(module_name), attr)


@dataclass
class OptimizerConfig:
    """Config-driven construction (reference: start-optimizer-cycles!
    construct, optimizer.clj:118-123).  The default optimizer is the
    REAL :class:`GoodputOptimizer` loop; the dummies remain for parity
    tests and as explicit opt-outs.  ``interval_seconds`` is validated
    at build time: the cycler's wait loop divides work by it, and a
    non-positive interval would spin or never fire."""
    host_feed_create_fn: str = \
        "cook_tpu_torch.sched.optimizer.DummyHostFeed"
    host_feed_config: Dict = field(default_factory=dict)
    optimizer_create_fn: str = \
        "cook_tpu_torch.sched.optimizer.GoodputOptimizer"
    optimizer_config: Dict = field(default_factory=dict)
    interval_seconds: float = 30.0

    def __post_init__(self):
        if float(self.interval_seconds) <= 0:
            raise ValueError("optimizer interval_seconds must be > 0, "
                             f"got {self.interval_seconds!r}")

    @classmethod
    def from_conf(cls, conf: Dict) -> "OptimizerConfig":
        """Boot-validated daemon conf section (daemon.py "optimizer"):
        unknown keys and a non-positive interval fail the boot, like the
        replication/pipeline/serving/partitions sections around it."""
        cfg = cls()
        for k, v in (conf or {}).items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown optimizer key {k!r}")
            setattr(cfg, k, type(getattr(cfg, k))(v)
                    if not isinstance(getattr(cfg, k), dict) else dict(v))
        cfg.__post_init__()
        # factory construction validates the nested optimizer_config
        # (GoodputOptimizer rejects unknown keys) at boot, not first use
        cfg.build()
        return cfg

    def build(self) -> "OptimizerCycler":
        self.__post_init__()
        host_feed = _load_factory(self.host_feed_create_fn)(
            self.host_feed_config)
        optimizer = _load_factory(self.optimizer_create_fn)(
            self.optimizer_config)
        return OptimizerCycler(host_feed, optimizer, self.interval_seconds)


class OptimizerCycler:
    """Periodic driver (reference: start-optimizer-cycles! optimizer.clj:115).
    Errors are logged-and-swallowed per cycle, matching the reference's
    error-handler."""

    def __init__(self, host_feed: HostFeed, optimizer: Optimizer,
                 interval_seconds: float = 30.0):
        self.host_feed = host_feed
        self.optimizer = optimizer
        self.interval_seconds = interval_seconds
        self.last_schedule: Optional[Dict] = None
        self.last_error: Optional[Exception] = None
        self.cycles = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_cycle(self, get_queue, get_running,
                  get_offers=lambda: [], _observe: bool = True
                  ) -> Optional[Dict]:
        from ..utils.metrics import registry
        t0 = time.perf_counter()
        try:
            self.last_schedule = optimizer_cycle(
                get_queue, get_running, get_offers,
                self.host_feed, self.optimizer)
            self.last_error = None
        except Exception as e:
            log.warning("Error running optimizer cycle", exc_info=e)
            self.last_error = e
            return None
        finally:
            self.cycles += 1
            if _observe:
                registry.observe("cook_optimizer_cycle_seconds",
                                 time.perf_counter() - t0)
        return self.last_schedule

    def run_scheduler_cycle(self, scheduler) -> Dict[str, "PoolDecision"]:
        """One full cycle against a live scheduler: the goodput decision
        pass first (when the optimizer implements ``optimize``), then
        the legacy observational schedule — which for
        :class:`GoodputOptimizer` renders the fresh decisions' autoscale
        suggestions.  Decision application/journaling stays with the
        caller (``Scheduler.step_optimize``)."""
        from ..utils.metrics import registry
        t0 = time.perf_counter()
        decisions: Dict[str, PoolDecision] = {}
        if hasattr(self.optimizer, "optimize"):
            try:
                decisions = self.optimizer.optimize(scheduler) or {}
            except Exception as e:
                log.warning("Error running goodput decision pass",
                            exc_info=e)
                self.last_error = e
                self.cycles += 1
                registry.observe("cook_optimizer_cycle_seconds",
                                 time.perf_counter() - t0)
                return {}

        def get_queue():
            return [j for q in scheduler.pending_queues.values()
                    for j in q]

        def get_running():
            return scheduler.store.running_instances()

        self.run_cycle(get_queue, get_running, _observe=False)
        registry.observe("cook_optimizer_cycle_seconds",
                         time.perf_counter() - t0)
        return decisions

    def start(self, get_queue, get_running, get_offers=lambda: []) -> None:
        def loop():
            # first cycle IMMEDIATELY: waiting a full interval before
            # cycle 1 left last_schedule None for interval_seconds after
            # every boot (the /debug/optimizer surface read as dead)
            self.run_cycle(get_queue, get_running, get_offers)
            while not self._stop.wait(self.interval_seconds):
                self.run_cycle(get_queue, get_running, get_offers)
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="optimizer-cycler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
