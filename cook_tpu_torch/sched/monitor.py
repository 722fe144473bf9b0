"""The port's copy of ``cook_tpu/sched/monitor.py`` (imports re-rooted).

User/pool gauge sweeper.

Parity with the reference's monitor (reference: scheduler/src/cook/
monitor.clj:35-207 set-stats-counters!): per pool, compute per-user
running/waiting resource stats, derive **starved** users (waiting users
whose running usage is below their fair share on every dimension),
**waiting-under-quota** users (waiting users whose running usage is below
their quota on every dimension), **hungry** (waiting but not starved) and
**satisfied** (running and not waiting) user counts, and publish everything
as gauges — including an aggregated pseudo-user ``all`` and zeroing of
series for users that disappeared since the previous sweep
(clear-old-counters!, monitor.clj:137-156).

The sweep is also the SLO layer (config.SloConfig): per-pool pending-age
distributions vs the queue-latency objective and the flight recorder's
recent cycle durations vs the cycle-duration objective, published as
``cook_slo_objective_seconds`` / ``cook_slo_breach_ratio`` /
``cook_slo_burn_rate`` gauges plus a sampled
``cook_queue_latency_seconds`` histogram — the alerting surface every
perf PR is judged against (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..config import Config, SloConfig
from ..state.store import Store
from ..utils.metrics import LATENCY_BUCKETS, MetricsRegistry
from ..utils.metrics import registry as default_registry

_STAT_DIMS = ("cpus", "mem", "jobs")


def _job_stats(jobs_with_user: List[Tuple[str, float, float]]
               ) -> Dict[str, Dict[str, float]]:
    """[(user, cpus, mem)] -> user -> {cpus, mem, jobs} (reference:
    get-job-stats monitor.clj:40-57)."""
    stats: Dict[str, Dict[str, float]] = {}
    for user, cpus, mem in jobs_with_user:
        s = stats.setdefault(user, {"cpus": 0.0, "mem": 0.0, "jobs": 0.0})
        s["cpus"] += cpus
        s["mem"] += mem
        s["jobs"] += 1
    return stats


def _with_aggregate(stats: Dict[str, Dict[str, float]]
                    ) -> Dict[str, Dict[str, float]]:
    """Add the pseudo-user 'all' summing every user (add-aggregated-stats,
    monitor.clj:59-68)."""
    total = {"cpus": 0.0, "mem": 0.0, "jobs": 0.0}
    for s in stats.values():
        for k in _STAT_DIMS:
            total[k] += s.get(k, 0.0)
    out = dict(stats)
    out["all"] = total
    return out


def compute_starved_stats(store: Store, pool_name: str,
                          running: Dict[str, Dict[str, float]],
                          waiting: Dict[str, Dict[str, float]]
                          ) -> Dict[str, Dict[str, float]]:
    """Waiting users whose running usage is strictly below their share on
    every share dimension; starvation = min(waiting, share - running)
    (get-starved-job-stats, monitor.clj:70-90)."""
    out: Dict[str, Dict[str, float]] = {}
    for user in waiting:
        share = store.get_share(user, pool_name)
        used = running.get(user, {})
        promised = {k: share.get(k, float("inf")) for k in ("cpus", "mem")}
        if all(used.get(k, 0.0) < v for k, v in promised.items()):
            out[user] = {
                k: min(waiting[user].get(k, 0.0),
                       promised.get(k, float("inf")) - used.get(k, 0.0))
                for k in _STAT_DIMS if k != "jobs"}
            out[user]["jobs"] = waiting[user].get("jobs", 0.0)
    return out


def compute_waiting_under_quota_stats(store: Store, pool_name: str,
                                      running: Dict[str, Dict[str, float]],
                                      waiting: Dict[str, Dict[str, float]]
                                      ) -> Dict[str, Dict[str, float]]:
    """Waiting users whose running usage is strictly below quota on every
    quota dimension; amount = min(waiting, max(quota - running, 0))
    (get-waiting-under-quota-job-stats, monitor.clj:92-117)."""
    out: Dict[str, Dict[str, float]] = {}
    for user in waiting:
        quota = store.get_quota(user, pool_name)
        used = running.get(user, {})
        promised = {"cpus": quota.get("cpus", float("inf")),
                    "mem": quota.get("mem", float("inf")),
                    "jobs": quota.get("count", float("inf"))}
        if all(used.get(k, 0.0) < v for k, v in promised.items()):
            out[user] = {
                k: min(waiting[user].get(k, 0.0),
                       max(promised[k] - used.get(k, 0.0), 0.0))
                for k in _STAT_DIMS}
    return out


class Monitor:
    """Periodic stats sweeper publishing per-user per-pool gauges
    (start-collecting-stats, monitor.clj:209)."""

    def __init__(self, store: Store,
                 registry: Optional[MetricsRegistry] = None,
                 config: Optional[Config] = None):
        self.store = store
        self.registry = registry if registry is not None else default_registry
        self.slo: SloConfig = (config.slo if config is not None
                               else SloConfig())
        self.config: Config = config if config is not None else Config()
        # fleet observability plane (sched/fleet.py): the scheduler
        # wires its rate limiters in (launch-token saturation input) and
        # the daemon attaches a FleetScraper; both stay None in
        # store-only constructions (tests, the simulator)
        self.rate_limits = None
        self.read_view = None
        self.fleet = None
        # adaptive-admission control loop (sched/admission.py): the
        # scheduler wires its AdmissionController in when the admission
        # section enables it; each sweep's saturation gauges feed ONE
        # decide() step.  None = no adaptive admission (default).
        self.admission = None
        # (pool, state) -> {user -> stats} from the previous sweep, so
        # series for vanished users can be zeroed
        self._previous: Dict[Tuple[str, str], Dict[str, Dict]] = {}
        # metric-cardinality guard (utils/metrics.py): the sweep folds
        # per-user families to top-K-by-usage + an "other" bucket itself;
        # the registry cap is the hard backstop should any publisher
        # emit user-labeled series unfolded.  The window is scoped per
        # (pool, state) for cook_user_resource — the four per-state
        # publishes have DISJOINT user sets, so a shared per-pool window
        # would overflow at populations near the fold cap — and sized
        # 2*cap+16 so one sweep's own writes can never fold: the live
        # publish is <= cap+2 series (top-K + "all" + "other") and the
        # departed-user zero-writes are <= the previous sweep's cap+2.
        cap = max(int(self.slo.max_user_series), 1)
        self.registry.set_label_cap("cook_user_resource", "user",
                                    cap * 2 + 16,
                                    scope=("pool", "state"))
        self.registry.set_label_cap("cook_user_dru", "user",
                                    cap * 2 + 16, scope=("pool",))
        self.registry.set_label_cap("cook_user_global_jobs", "user",
                                    cap * 2 + 16)
        # endpoints that have ever carried traffic: quiet ones must be
        # re-published at 0 each sweep, or one slow request's burn-rate
        # gauge would stick at its breach value forever
        self._http_endpoints: Set[str] = set()
        # storage-integrity scrub cadence gate: the sweep runs every
        # monitor interval but a scrub step only at the configured
        # scrub_interval_seconds
        self._last_scrub_ts = 0.0

    # ------------------------------------------------------------- one sweep
    def sweep(self) -> Dict[str, Dict[str, int]]:
        """Recompute and publish all gauges; returns per-pool user counts
        (total/starved/hungry/satisfied/waiting_under_quota) for tests and
        structured logging."""
        out: Dict[str, Dict[str, int]] = {}
        # DRU series are re-derived whole each sweep (top-K churns):
        # clear-then-set keeps the exported set exactly the live one,
        # and the cardinality-guard admission window resets so THIS
        # sweep's top-K claims the slots (without the reset, the
        # first-ever cap*8 users would hold them forever and every later
        # heavy user would fold into "other"; utils/metrics.py contract)
        self.registry.gauge_clear("cook_user_dru")
        for metric in ("cook_user_resource", "cook_user_dru"):
            self.registry.reset_label_window(metric, "user")
        for pool in self.store.pools():
            out[pool.name] = self._sweep_pool(pool)
        self._sweep_cycle_slo()
        self._sweep_http_slo()
        self._sweep_serving()
        self._sweep_storage()
        saturation = self._sweep_saturation()
        admission = self.admission
        if admission is not None:
            # the adaptive-admission control loop runs at the sweep
            # cadence off the SAME saturation computation the gauges
            # publish — the operator's dashboard and the controller can
            # never disagree about the input signal
            admission.decide(saturation)
        fleet = self.fleet
        if fleet is not None:
            # monitor-driven federation (sched/fleet.py): the scraper
            # self-gates to its own interval, so the sweep cadence and
            # the scrape cadence stay independently configurable
            fleet.maybe_scrape()
        return out

    def _sweep_saturation(self) -> Dict[str, float]:
        """The derived 0-1 saturation layer (sched/fleet.py formulas):
        recomputed from live counters each sweep and published as
        ``cook_saturation{resource=}`` — the admission-control input
        contract (sched/admission.py consumes the returned dict), also
        surfaced on /debug/health + /debug/fleet."""
        from .fleet import compute_saturation, publish_saturation
        saturation = compute_saturation(self.config, store=self.store,
                                        read_view=self.read_view,
                                        rate_limits=self.rate_limits)
        publish_saturation(saturation, self.registry)
        return saturation

    def _sweep_storage(self) -> None:
        """Storage-integrity sweep (docs/ROBUSTNESS.md "WAL v2"): drive
        one incremental CRC32C scrub step per journal shard at the
        configured cadence (:meth:`Store.scrub`) and publish the
        verified frontier as ``cook_storage_scrub_offset_bytes`` —
        corruption/repair events count at the detection sites themselves
        (``cook_journal_corruption_total`` /
        ``cook_storage_repair_total``), so a sweep that finds nothing
        costs one bounded read per shard and no counter churn."""
        import time as _time
        scfg = getattr(self.config, "storage", None)
        if scfg is not None and not scfg.scrub_enabled:
            return
        interval = (scfg.scrub_interval_seconds if scfg is not None
                    else 30.0)
        chunk = scfg.scrub_chunk_bytes if scfg is not None else 1 << 20
        repair = (scfg.checkpoint_on_corruption if scfg is not None
                  else True)
        now = _time.time()
        if now - self._last_scrub_ts < interval:
            return
        self._last_scrub_ts = now
        from ..state.partition import substores
        shards = substores(self.store)
        partitioned = len(shards) > 1 or (
            shards and shards[0] is not self.store)
        for shard in shards:
            scrub = getattr(shard, "scrub", None)
            if scrub is None:
                continue
            doc = scrub(max_bytes=chunk, repair=repair)
            if not doc.get("enabled"):
                continue
            pl = getattr(shard, "partition_label", lambda: None)()
            labels = {"partition": pl} if partitioned and pl else None
            self.registry.gauge_set(
                "cook_storage_scrub_offset_bytes",
                float(doc.get("verified_offset", 0)), labels=labels)

    def _sweep_serving(self) -> None:
        """Leader serving-plane gauges: the journal commit position (the
        read-your-writes token's upper bound, which follower staleness
        is measured against) and the group-commit stage's live state —
        the batch-size HISTOGRAM is recorded by the committer itself
        per batch (cook_group_commit_batch_size); the sweep publishes
        the queue depth a stuck committer would show."""
        from ..state.partition import substores
        shards = substores(self.store)
        partitioned = len(shards) > 1 or (
            shards and shards[0] is not self.store)
        for shard in shards:
            # one gauge per shard, partition-labeled on the partitioned
            # plane (each partition's journal is its own offset space —
            # summing heads across partitions would be the exact
            # mis-comparison the token vector exists to prevent)
            pl = getattr(shard, "partition_label", lambda: None)()
            labels = {"partition": pl} if partitioned and pl else None
            co = getattr(shard, "commit_offset", None)
            if co is not None and co():
                self.registry.gauge_set("cook_journal_head_bytes",
                                        float(co()), labels=labels)
            gc_stats = getattr(shard, "group_commit_stats", None)
            gc = gc_stats() if gc_stats is not None else None
            if gc is not None:
                self.registry.gauge_set("cook_group_commit_pending",
                                        float(gc["pending"]),
                                        labels=labels)
        summaries = getattr(self.store, "summaries", None)
        if summaries is not None:
            # the monitor's GLOBAL view on a partitioned plane: per-user
            # total footprint across every partition, read from the
            # bounded-staleness summary exchange (counts, never job
            # state) — top-K folding is the registry cap's job here
            merged = summaries.merged()
            top = sorted(merged.items(),
                         key=lambda kv: -(kv[1]["pending"]
                                          + kv[1]["running"]))
            self.registry.gauge_clear("cook_user_global_jobs")
            for user, u in top[:self.slo.max_user_series]:
                self.registry.gauge_set(
                    "cook_user_global_jobs",
                    u["pending"] + u["running"],
                    labels={"user": user})

    def _sweep_pool(self, pool) -> Dict[str, int]:
        from ..state.schema import DruMode
        pool_name = pool.name
        # clone=False: the sweep only READS (user, resources, wait
        # ages) to fold into gauges — cloning 20k+ jobs per sweep was
        # most of the sweep's cost, and a monitor that burns half a
        # core under queue pressure is feeding the very saturation it
        # reports (store.jobs_where contract)
        pending = self.store.pending_jobs(pool_name, clone=False)
        running = self.store.running_instances(pool_name, clone=False)
        running_stats = _job_stats([
            (job.user, job.resources.cpus, job.resources.mem)
            for job, _inst in running])
        waiting_stats = _job_stats([
            (job.user, job.resources.cpus, job.resources.mem)
            for job in pending])
        self._sweep_queue_slo(pool_name, pending)
        # fairness plane (docs/OBSERVABILITY.md): per-user DRU (actual
        # usage normalized by share), published top-K + cached on the
        # audit trail for rank-event context, and the wait-phase split
        # of the pending queue (fairness vs capacity vs constraints)
        gpu_usage = None
        if pool.dru_mode is DruMode.GPU:
            # GPU pools rank/rebalance on the gpus dimension — the DRU
            # gauge must price the same dimension or it diverges from
            # what the rebalancer actually preempts against
            gpu_usage = {}
            for job, _inst in running:
                gpu_usage[job.user] = \
                    gpu_usage.get(job.user, 0.0) + job.resources.gpus
        dru = self._sweep_user_dru(pool_name, running_stats,
                                   waiting_stats, gpu_usage=gpu_usage)
        self._sweep_wait_phases(pool_name, pending, dru)
        starved = compute_starved_stats(
            self.store, pool_name, running_stats, waiting_stats)
        under_quota = compute_waiting_under_quota_stats(
            self.store, pool_name, running_stats, waiting_stats)

        running_users = set(running_stats)
        waiting_users = set(waiting_stats)
        counts = {
            "total": len(running_users | waiting_users),
            "starved": len(starved),
            "waiting_under_quota": len(under_quota),
            "hungry": len(waiting_users - set(starved)),
            "satisfied": len(running_users - waiting_users),
        }
        for state, stats in (("running", running_stats),
                             ("waiting", waiting_stats),
                             ("starved", starved),
                             ("waiting-under-quota", under_quota)):
            self._publish_state(pool_name, state, stats)
        for state, value in counts.items():
            self.registry.gauge_set(
                "cook_user_state_count", float(value),
                labels={"pool": pool_name, "state": state.replace("_", "-")})
        return counts

    def _fold_tail(self, stats: Dict[str, Dict[str, float]]
                   ) -> Dict[str, Dict[str, float]]:
        """Top-K-by-usage + an aggregated ``other`` bucket past the
        per-user series cap (SloConfig.max_user_series): the fairness
        gauges stay bounded at millions-of-users scale, with the folded
        tail still visible in aggregate
        (``cook_metrics_dropped_labels_total`` counts registry-level
        folds from any publisher that skips this)."""
        cap = max(int(self.slo.max_user_series), 1)
        if len(stats) <= cap:
            return stats
        ranked = sorted(
            stats.items(),
            key=lambda kv: -(kv[1].get("cpus", 0.0) + kv[1].get("mem", 0.0)))
        out = dict(ranked[:cap])
        other = {k: 0.0 for k in _STAT_DIMS}
        for _u, s in ranked[cap:]:
            for k in _STAT_DIMS:
                other[k] += s.get(k, 0.0)
        out["other"] = other
        return out

    def _sweep_user_dru(self, pool_name: str,
                        running_stats: Dict[str, Dict[str, float]],
                        waiting_stats: Dict[str, Dict[str, float]],
                        gpu_usage: Optional[Dict[str, float]] = None
                        ) -> Dict[str, float]:
        """Per-user DRU = usage normalized by share on the pool's DRU
        dimension(s) — the fair-share position the rebalancer prices
        preemption against (rebalancer._recompute_user), now visible as
        a gauge next to the share itself.  ``gpu_usage`` non-None marks
        a DruMode.GPU pool: DRU is gpus/share like the rebalancer's,
        not cpus/mem.  Every user's value is cached on the audit trail
        (rank events and ``cs why`` attach it); only the top-K +
        ``other`` (max of the tail) are exported as series."""
        dru: Dict[str, float] = {}
        for user in set(running_stats) | set(waiting_stats):
            share = self.store.get_share(user, pool_name)
            if gpu_usage is not None:
                sg = share.get("gpus")
                dru[user] = (gpu_usage.get(user, 0.0) / sg
                             if sg and sg != float("inf") else 0.0)
                continue
            used = running_stats.get(user, {})
            vals = [used.get(dim, 0.0) / share[dim]
                    for dim in ("cpus", "mem")
                    if share.get(dim) and share[dim] != float("inf")]
            dru[user] = max(vals) if vals else 0.0
        # wholesale replace: departed users age out of the cache instead
        # of accumulating for the leader's lifetime
        self.store.audit.set_user_dru(pool_name, dru)
        cap = max(int(self.slo.max_user_series), 1)
        top = sorted(dru.items(), key=lambda kv: -kv[1])
        for user, v in top[:cap]:
            self.registry.gauge_set("cook_user_dru", round(v, 6),
                                    {"pool": pool_name, "user": user})
        if len(top) > cap:
            self.registry.gauge_set(
                "cook_user_dru", round(top[cap][1], 6),
                {"pool": pool_name, "user": "other"})
        return dru

    def _sweep_wait_phases(self, pool_name: str, pending,
                           dru: Dict[str, float]) -> None:
        """Split the pending queue's current waits by WHY (utils/audit.
        wait_phase): ``fairness`` (quota / rate limit / gang admission /
        at-or-over share), ``constraints`` (placement-constraint or
        topology blocked), ``capacity`` (placeable, no room).  Each
        phase gets its own latency histogram + job-count gauge and its
        own queue-latency SLO breach ratio, so "users are waiting" pages
        name the mechanism before anyone opens a timeline."""
        from ..utils.audit import wait_phase
        now_ms = self.store.clock()
        # ONE lock hold for the whole queue's reasons: a per-job
        # last_reason() would pay 100k lock round-trips contending with
        # the scheduler's hot-path record() calls
        reasons = self.store.audit.last_reasons(
            [j.uuid for j in pending])
        by_phase: Dict[str, list] = {
            "fairness": [], "capacity": [], "constraints": []}
        for j in pending:
            reason = reasons.get(j.uuid)
            # the persisted placement-failure census refines "couldn't
            # place" into constraints-vs-capacity, but it is STICKY
            # (never cleared once set) — a fresher fairness-side skip
            # reason from the audit trail must win over it, or a job
            # that failed placement once and is now quota-throttled
            # would misreport as capacity forever
            if reason is None or reason == "unmatched":
                lpf = j.last_placement_failure
                if lpf:
                    reason = ("constraints" if lpf.get("constraints")
                              else "unmatched")
            phase = wait_phase(reason, dru.get(j.user, 0.0) >= 1.0)
            age = (now_ms - (j.last_waiting_start_ms
                             or j.submit_time_ms)) / 1000.0
            by_phase[phase].append(age)
        obj = self.slo.queue_latency_objective_s
        for phase, ages in by_phase.items():
            labels = {"pool": pool_name, "phase": phase}
            self.registry.gauge_set("cook_wait_phase_jobs",
                                    float(len(ages)), labels)
            self.registry.observe_many("cook_wait_phase_seconds", ages,
                                       labels, buckets=LATENCY_BUCKETS)
            breach = sum(1 for a in ages if a > obj)
            self._publish_slo(f"queue-latency-{phase}", obj,
                              breach / len(ages) if ages else 0.0,
                              pool=pool_name)

    def _publish_state(self, pool_name: str, state: str,
                       stats: Dict[str, Dict[str, float]]) -> None:
        key = (pool_name, state)
        stats = self._fold_tail(stats)
        previous: Set[str] = set(self._previous.get(key, {}))
        with_all = _with_aggregate(stats) if stats else {
            "all": {k: 0.0 for k in _STAT_DIMS}}
        # LIVE series first, vanished-user zeroing after: the
        # cardinality window admits first-come, and the zero-writes for
        # departed users must never crowd this sweep's top-K out of it
        self._previous[key] = dict(stats)
        for user, s in with_all.items():
            for dim in _STAT_DIMS:
                self.registry.gauge_set(
                    "cook_user_resource", float(s.get(dim, 0.0)),
                    labels={"pool": pool_name, "user": user, "state": state,
                            "resource": dim})
        for user in previous - set(with_all):
            for dim in _STAT_DIMS:
                self.registry.gauge_set(
                    "cook_user_resource", 0.0,
                    labels={"pool": pool_name, "user": user, "state": state,
                            "resource": dim})

    # ------------------------------------------------------------------- SLO
    def _publish_slo(self, slo_name: str, objective_s: float,
                     breach_ratio: float,
                     pool: Optional[str] = None,
                     extra: Optional[Dict[str, str]] = None) -> None:
        labels = {"slo": slo_name}
        if pool is not None:
            labels["pool"] = pool
        if extra:
            labels.update(extra)
        self.registry.gauge_set("cook_slo_objective_seconds", objective_s,
                                labels=labels)
        self.registry.gauge_set("cook_slo_breach_ratio", breach_ratio,
                                labels=labels)
        budget = max(self.slo.error_budget, 1e-9)
        self.registry.gauge_set("cook_slo_burn_rate", breach_ratio / budget,
                                labels=labels)

    def _sweep_queue_slo(self, pool_name: str, pending) -> None:
        """Pending-age distribution vs the queue-latency objective.  Ages
        are sampled at sweep time (a job still waiting counts against the
        SLO *now*, not only once it finally launches — the launch-time
        wait histogram is observed separately by the matcher).  The age
        basis is the CURRENT wait (last_waiting_start_ms, the same basis
        the store stamps queue_time_ms from): a retried job re-enters the
        queue with a fresh clock, it does not inherit hours of prior
        runtime as instant SLO breach."""
        now_ms = self.store.clock()
        ages = [(now_ms - (j.last_waiting_start_ms or j.submit_time_ms))
                / 1000.0 for j in pending]
        self.registry.observe_many("cook_queue_age_seconds", ages,
                                   labels={"pool": pool_name},
                                   buckets=LATENCY_BUCKETS)
        obj = self.slo.queue_latency_objective_s
        breach = sum(1 for a in ages if a > obj)
        ratio = breach / len(ages) if ages else 0.0
        self._publish_slo("queue-latency", obj, ratio, pool=pool_name)

    def _sweep_http_slo(self) -> None:
        """Per-endpoint request-latency burn rates off the serving
        plane's RED window (rest/instrument.py): each sweep drains the
        since-last-sweep per-endpoint (requests, over-objective) counts
        and publishes an ``endpoint-latency`` SLO series per endpoint
        template — the alerting surface the serving plane's admission
        batching is judged against.  Endpoint labels are templates
        (bounded); quiet endpoints publish nothing this sweep."""
        from ..rest.instrument import request_log
        obj = self.slo.endpoint_latency_objective_s
        window = request_log.drain_slo_window()
        self._http_endpoints |= set(window)
        for endpoint in self._http_endpoints:
            count, breach = window.get(endpoint, (0, 0))
            # endpoints quiet since the last sweep publish a clean 0 —
            # same discipline as _sweep_queue_slo's every-pool publish
            self._publish_slo("endpoint-latency", obj,
                              breach / count if count else 0.0,
                              extra={"endpoint": endpoint})

    def _sweep_cycle_slo(self) -> None:
        """Cycle-duration burn rate over the flight recorder's recent
        window (fused/match cycles only — rank/rebalance cadences have
        their own budgets and would dilute the signal)."""
        from ..utils.flight import recorder
        obj = self.slo.cycle_duration_objective_s
        # kind-filtered BEFORE the window cut: rank/rebalance records
        # interleave with the match cadence and would otherwise silently
        # shrink the configured window
        durations = recorder.recent_durations(("fused", "match"),
                                              self.slo.cycle_window)
        breach = sum(1 for d in durations if d > obj * 1000.0)
        ratio = breach / len(durations) if durations else 0.0
        self._publish_slo("cycle-duration", obj, ratio)
