"""The port's configuration: a copy of ``cook_tpu/config.py``, with the
same names, defaults and validation, so that a config file means the
same in both packages.  ``MatcherConfig`` is the port's own (its
backend table and deprecation path; no metrics registry).  The ``tpu-*``
backend names keep the JAX package's spelling; in the port they name the
same kernels on the card."""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Pattern

BACKENDS = ("auto", "tpu-greedy", "tpu-auction", "tpu-waterfill",
            "tpu-megakernel", "cpu")


@dataclass
class MatcherConfig:
    """Per-pool matcher knobs (reference: default-fenzo-scheduler-config
    config.clj:110-117).

    ``backend``: "auto" = greedy up to ``auto_large_j_threshold`` jobs,
    then waterfill or auction per ``auto_packing``; "tpu-greedy" =
    bit-exact greedy (kernel K5 on the card); "tpu-auction" = top-K
    adaptive auction + waterfill tail; "tpu-waterfill" = prefix packing
    with no J x H work; "tpu-megakernel" = the fused cycle, whose split
    path matches with the greedy; "cpu" = the numpy greedy golden."""

    backend: str = "auto"
    auto_large_j_threshold: int = 2000
    # above the threshold: "throughput" -> waterfill (lowest latency,
    # looser packing), "tight" -> adaptive auction + waterfill tail
    auto_packing: str = "throughput"
    # cmask rows below this density are "constrained" jobs: the auto
    # backend's waterfill path routes them to the exact greedy
    sparse_cmask_density: float = 0.5
    max_jobs_considered: int = 1000
    # head-of-queue fairness backoff (scheduler.clj:1613-1651)
    scaleback: float = 0.95
    floor_iterations_before_warn: int = 10
    floor_iterations_before_reset: int = 1000
    # auction: num_refresh is an upper bound; the refresh loop exits once
    # a pass admits fewer than auction_min_refresh_gain new jobs
    auction_num_prefs: int = 16
    auction_num_rounds: int = 8
    auction_num_refresh: int = 64
    auction_min_refresh_gain: int = 16
    waterfill_num_rounds: int = 32
    # tightness-improving migration rounds after waterfill converges
    # (upper bound; exits when no move lands)
    waterfill_num_compaction: int = 16

    def __post_init__(self):
        # validate and migrate at config time, not per match cycle
        if self.backend == "tpu-auction-pallas":
            logging.getLogger(__name__).warning(
                "DEPRECATED matcher backend tpu-auction-pallas was removed; "
                "rewriting to tpu-auction — update the config")
            self.backend = "tpu-auction"
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown matcher backend {self.backend!r}")
        if self.auto_packing not in ("throughput", "tight"):
            raise ValueError(f"unknown auto_packing "
                             f"{self.auto_packing!r} (throughput|tight)")


@dataclass
class RebalancerConfig:
    """Preemption-cycle parameters (reference: rebalancer.clj:535-557
    dynamic Datomic params)."""

    enabled: bool = True
    interval_seconds: float = 120.0
    safe_dru_threshold: float = 1.0
    min_dru_diff: float = 0.5
    max_preemption: int = 64


@dataclass
class OffensiveJobLimits:
    """A job is offensive iff its required mem or cpus exceeds these limits;
    offensive jobs are stifled out of the rank queue and aborted
    (reference: filter-offensive-jobs scheduler.clj:2205-2229)."""

    memory_gb: float = float("inf")
    cpus: float = float("inf")


@dataclass
class PoolQuota:
    """Pool-level global caps (reference: tools.clj global-pool-quota)."""

    cpus: float = float("inf")
    mem: float = float("inf")
    gpus: float = float("inf")
    count: float = float("inf")


@dataclass
class TaskConstraints:
    """Submission-time per-task limits (reference: config.clj:398-407
    :task-constraints defaults + validate-and-munge-job rest/api.clj:1070-1096).
    ``None`` disables a check; the reference's conservative defaults for the
    resource caps are commented — operators opt in because the right cap is
    deployment-specific."""

    retry_limit: Optional[int] = 20          # config.clj:403
    max_ports: Optional[int] = 5             # config.clj:405
    cpus: Optional[float] = None             # reference default: 4
    memory_gb: Optional[float] = None        # reference default: 12
    command_length_limit: Optional[int] = None
    # docker parameter allow-list; None = the conservative built-in
    # default (rest/api.py DEFAULT_DOCKER_PARAMETERS_ALLOWED — benign
    # task-shape keys only, privilege-bearing flags denied)
    docker_parameters_allowed: Optional[List[str]] = None


@dataclass
class SloConfig:
    """Service-level objectives published by the monitor sweep
    (sched/monitor.py) as burn-rate gauges on /metrics.

    Burn rate = breach fraction / error budget: 1.0 means errors arrive
    exactly at the rate that exhausts the budget over the SLO window,
    >1 burns faster (page), <1 is healthy.  Objectives are deployment
    policy, so both knobs are plain config."""

    # a pending job older than this breaches the queue-latency SLO
    queue_latency_objective_s: float = 300.0
    # a scheduler cycle slower than this breaches the cycle-duration SLO
    cycle_duration_objective_s: float = 1.0
    # allowed breach fraction (0.01 = 99% of cycles/jobs within objective)
    error_budget: float = 0.01
    # how many recent flight-recorder cycles the cycle-duration burn
    # rate is computed over
    cycle_window: int = 100
    # per-user metric families are capped at this many distinct user
    # label values per pool (top-K by usage; the tail folds into an
    # "other" series) so fairness gauges can't blow up the Prometheus
    # registry at millions-of-users scale (utils/metrics.py label caps,
    # cook_metrics_dropped_labels_total)
    max_user_series: int = 1000
    # a REST request slower than this breaches its endpoint-latency SLO
    # (per-endpoint burn rates off the serving-plane RED metrics,
    # rest/instrument.py; docs/OBSERVABILITY.md)
    endpoint_latency_objective_s: float = 0.5


@dataclass
class FaultInjectionConfig:
    """Deterministic fault injection (utils/faults.py).  Off by default;
    arming is an operator/chaos decision.  ``points`` maps fault-point
    name -> {"probability": p, "schedule": [call indices],
    "max_fires": n} (see utils/faults.py for the point registry)."""

    enabled: bool = False
    seed: int = 0
    points: Dict[str, Dict] = field(default_factory=dict)


@dataclass
class ReplicationConfig:
    """Socket journal replication + coordinated failover knobs (the
    daemon's ``"replication"`` conf section; state/replication.py,
    docs/DEPLOY.md).  Parsed through :meth:`from_conf` so a typo'd knob
    fails the BOOT instead of silently running with defaults while the
    operator believes durability/failover policy is set."""

    listen_port: int = 0               # 0 = pick a free port, publish it
    sync: bool = True                  # commit = fsynced on every synced
    #                                    follower (False = async mirror)
    ack_timeout_seconds: float = 5.0
    min_sync_followers: int = 0        # > 0 = CP mode (refuse lone commits)
    advertise_host: str = ""           # "" = the daemon's bind host
    # coordinated promotion (quorum-aware failover): how long the
    # election winner waits collecting candidate positions before
    # deciding whether it must first pull a delta from a better-synced
    # peer (Raft's vote comparison expressed over the election medium)
    candidacy_window_seconds: float = 1.0
    # how often standbys publish their replication position
    position_interval_seconds: float = 0.5
    # a candidate position older than this is a dead node's ghost and is
    # ignored by the ranking (and by catch-up failure handling)
    position_stale_seconds: float = 10.0
    # how long the winner tries to pull the delta from a live
    # better-synced peer before failing the takeover (exit nonzero so
    # that peer can win instead)
    catchup_timeout_seconds: float = 30.0

    @classmethod
    def from_conf(cls, conf: Dict) -> "ReplicationConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown replication key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                # bool("false") is True — a templated string here would
                # silently invert the operator's durability policy
                if not isinstance(v, bool):
                    raise ValueError(
                        f"replication key {k!r} must be a JSON boolean, "
                        f"got {v!r}")
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(default)(v))
        return cfg


@dataclass
class ServingConfig:
    """Serving-plane scale-out knobs (the daemon's ``"serving"`` conf
    section inside ``"scheduler"``; boot-validated like PipelineConfig):
    the follower read fleet (state/read_replica.py — standbys serve
    bounded-staleness GETs from a live journal-applied store) and the
    leader's group-commit admission batching (state/store.py — concurrent
    write transactions share ONE journal fsync + ONE replication ack
    round).  docs/DEPLOY.md "read fleet", docs/PERFORMANCE.md
    "group commit"."""

    #: standbys answer job/group/instance/queue/unscheduled/timeline GETs
    #: from their live-applied mirror (staleness surfaced per response via
    #: X-Cook-Replication-Offset / -Age-Ms) instead of 307-redirecting.
    #: Writes always redirect to the leader.
    follower_reads: bool = True
    #: how long the follower's apply loop sleeps between journal polls —
    #: the steady-state staleness floor (the mirror itself is pushed by
    #: the leader; this only bounds the local apply cadence)
    apply_interval_seconds: float = 0.02
    #: read-your-writes: a follower behind a client's X-Cook-Min-Offset
    #: token waits up to this long for its mirror to catch up before
    #: 307-redirecting the read to the leader
    min_offset_wait_seconds: float = 1.0
    #: leader write path: amortize journal fsync + replication ack across
    #: concurrent committers (one durability round per batch, outcomes
    #: demultiplexed per transaction — incl. the indeterminate-outcome
    #: contract).  Engages only on stores with a journal attached.
    group_commit: bool = True
    #: coalescing window: after the first waiter arrives the committer
    #: waits this long for stragglers before draining the batch.  0 =
    #: drain immediately (whatever accumulated during the previous
    #: round's fsync/ack still batches).
    group_commit_window_ms: float = 0.5
    #: hard per-batch cap (a full batch drains without waiting)
    group_commit_max_batch: int = 256

    def __post_init__(self):
        if not isinstance(self.group_commit_max_batch, int) \
                or self.group_commit_max_batch < 1:
            raise ValueError("serving group_commit_max_batch must be an "
                             f"int >= 1, got {self.group_commit_max_batch!r}")
        for k in ("apply_interval_seconds", "min_offset_wait_seconds",
                  "group_commit_window_ms"):
            if float(getattr(self, k)) < 0:
                raise ValueError(f"serving {k} must be >= 0")

    @classmethod
    def from_conf(cls, conf: Dict) -> "ServingConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown serving key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"serving key {k!r} must be a JSON "
                                     f"boolean, got {v!r}")
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class FleetConfig:
    """Fleet observability plane (sched/fleet.py; the daemon's
    ``"fleet"`` conf section, boot-validated like the sections around
    it): metrics federation over the election candidate registry,
    cross-process trace stitching, and the saturation-signal layer —
    docs/OBSERVABILITY.md "Debugging the fleet", docs/DEPLOY.md
    scrape topology."""

    #: run the FleetScraper at all (the monitor sweep drives it); off =
    #: /metrics/fleet serves only this process and /debug/fleet reports
    #: federation disabled
    enabled: bool = True
    #: minimum seconds between federation sweeps — the monitor sweep
    #: fires more often than this; the scraper self-gates
    scrape_interval_seconds: float = 10.0
    #: per-member /metrics fetch timeout; an unreachable member costs at
    #: most this per sweep and surfaces as ``up=0`` data, never a gap
    scrape_timeout_seconds: float = 2.0
    #: per-member /debug/trace/spans fetch timeout for the stitched
    #: fleet trace export
    trace_fanout_timeout_seconds: float = 2.0
    #: federated series kept per member per sweep; the excess is folded
    #: into ``cook_fleet_dropped_series{instance=}`` (the
    #: registry's cardinality discipline applied at fleet scale)
    max_series_per_member: int = 4096
    #: hard cap on members per sweep (registry entries past it are
    #: skipped and counted) — a corrupt candidate registry must not turn
    #: one sweep into an unbounded fan-out
    max_members: int = 64
    #: static extra members ``[{"instance":, "url":, "role":}]`` merged
    #: over the candidate registry — agents or off-registry processes
    #: that expose /metrics but never campaign
    members: List[Dict] = field(default_factory=list)
    #: saturation gauges at/above this are "hot" on /debug/health +
    #: /debug/fleet — the red line the adaptive-admission consumer
    #: (ROADMAP item 3) will shed against
    saturation_red_line: float = 0.8
    #: follower-staleness normalization: saturation 1.0 == the read
    #: view's apply age reaching this (also flips a follower's
    #: /debug/health to unhealthy)
    staleness_red_line_seconds: float = 5.0
    #: audit-queue normalization: saturation 1.0 == this many durable
    #: audit events still buffered for the journal
    audit_queue_red_line: int = 4096
    #: journal-head normalization: saturation 1.0 == the live journal
    #: growing to this many bytes since the last checkpoint compaction
    journal_head_red_line_bytes: int = 256 * 1024 * 1024

    def __post_init__(self):
        for k in ("scrape_interval_seconds", "scrape_timeout_seconds",
                  "trace_fanout_timeout_seconds",
                  "staleness_red_line_seconds"):
            if float(getattr(self, k)) <= 0:
                raise ValueError(f"fleet {k} must be > 0")
        for k in ("max_series_per_member", "max_members",
                  "audit_queue_red_line", "journal_head_red_line_bytes"):
            v = getattr(self, k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(f"fleet {k} must be an int >= 1, "
                                 f"got {v!r}")
        if not 0.0 < float(self.saturation_red_line) <= 1.0:
            raise ValueError("fleet saturation_red_line must be in "
                             f"(0, 1], got {self.saturation_red_line!r}")
        for m in self.members:
            if not isinstance(m, dict) or not m.get("url"):
                raise ValueError("fleet members entries must be objects "
                                 f"with a \"url\", got {m!r}")

    @classmethod
    def from_conf(cls, conf: Dict) -> "FleetConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown fleet key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"fleet key {k!r} must be a JSON "
                                     f"boolean, got {v!r}")
                setattr(cfg, k, v)
            elif k == "members":
                if not isinstance(v, list):
                    raise ValueError("fleet members must be a list of "
                                     "{instance, url, role} objects")
                cfg.members = [dict(m) for m in v]
            else:
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class PartitionConfig:
    """Partitioned write plane (state/partition.py; the daemon's
    ``"partitions"`` conf section inside ``"scheduler"``, boot-validated
    like the sections around it).  ``count=1`` is the compatibility
    default: the daemon keeps the classic single Store and nothing on
    the wire changes.  ``count>1`` shards the store + journal into
    per-pool-group partitions, each with its own fsync stream,
    group-commit stage, and lease claim (docs/DEPLOY.md "partitioned
    write plane")."""

    #: number of write-plane partitions (journals, fsync streams,
    #: group-commit stages, leases)
    count: int = 1
    #: explicit pool → partition routing (the config-declared pool
    #: groups); pools not listed hash deterministically.  Validated at
    #: boot: every index must be in [0, count).
    pools: Dict[str, int] = field(default_factory=dict)
    #: staleness bound of the cross-partition per-user summary exchange
    #: (quota enforcement / global DRU view read through it)
    summary_max_age_seconds: float = 1.0
    #: controller shard processes (one partition block = one
    #: process = one mesh shard).  0 = unsharded (this daemon owns every
    #: partition in-process, the classic plane); N > 0 declares an
    #: N-process topology and must divide ``count`` evenly.  Validated
    #: against the mesh pool layout at boot
    #: (parallel.mesh.validate_shard_alignment).
    shards: int = 0
    #: operator-declared pool -> mesh shard table, cross-checked at boot
    #: against the PartitionMap routing — a pool declared on a shard
    #: other than the one its write-plane partition belongs to is a
    #: config error (double-owned / orphaned resident buffers), refused
    #: at daemon start.
    shard_pools: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if not isinstance(self.count, int) or isinstance(self.count, bool) \
                or self.count < 1:
            raise ValueError(
                f"partitions count must be an int >= 1, got {self.count!r}")
        for pool, idx in (self.pools or {}).items():
            if not isinstance(idx, int) or isinstance(idx, bool) \
                    or not 0 <= idx < self.count:
                raise ValueError(
                    f"partitions.pools[{pool!r}] must be an int in "
                    f"[0, {self.count}), got {idx!r}")
        if float(self.summary_max_age_seconds) < 0:
            raise ValueError(
                "partitions summary_max_age_seconds must be >= 0")
        if not isinstance(self.shards, int) or isinstance(self.shards, bool) \
                or self.shards < 0:
            raise ValueError(
                f"partitions shards must be an int >= 0, got {self.shards!r}")
        if self.shards:
            if self.count % self.shards != 0:
                raise ValueError(
                    f"partitions.count ({self.count}) must divide evenly "
                    f"over partitions.shards ({self.shards}): every "
                    "controller shard owns an equal contiguous partition "
                    "block")
        for pool, idx in (self.shard_pools or {}).items():
            if not isinstance(idx, int) or isinstance(idx, bool) \
                    or idx < 0 or (self.shards and idx >= self.shards):
                raise ValueError(
                    f"partitions.shard_pools[{pool!r}] must be an int in "
                    f"[0, {self.shards or '#shards'}), got {idx!r}")
        if self.shard_pools and not self.shards:
            raise ValueError(
                "partitions.shard_pools declared without partitions.shards")

    @classmethod
    def from_conf(cls, conf: Dict) -> "PartitionConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown partitions key {k!r}")
            if k == "pools":
                if not isinstance(v, dict):
                    raise ValueError("partitions.pools must be a map of "
                                     "pool name to partition index")
                cfg.pools = {str(p): i for p, i in v.items()}
            elif k == "shard_pools":
                if not isinstance(v, dict):
                    raise ValueError("partitions.shard_pools must be a map "
                                     "of pool name to mesh shard index")
                cfg.shard_pools = {str(p): i for p, i in v.items()}
            else:
                default = getattr(cfg, k)
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class PipelineConfig:
    """Pipelined fused-cycle driver + compile-warmup knobs (the daemon's
    ``"pipeline"`` conf section; sched/pipeline.py, docs/PERFORMANCE.md).
    Parsed through :meth:`from_conf` so a typo'd knob fails the BOOT like
    ReplicationConfig — a silently-defaulted depth would let an operator
    believe the sync path is pinned when it isn't (or vice versa)."""

    #: cycles in flight concurrently.  0 = strictly synchronous
    #: FusedCycleDriver (today's pre-pipeline behavior, bit-for-bit);
    #: 2 = the production default: while cycle k's launches are applied
    #: on host, cycle k+1's fused kernel is already computing on device
    #: against the pre-apply snapshot (Omega-style optimistic cycles,
    #: reconciled host-side before launch).  >2 is allowed but adds
    #: speculation: intermediate unfetched cycles' candidates can't be
    #: masked out of later stages, so the conflict-drop rate rises.
    depth: int = 2
    #: JAX persistent compilation cache directory ("" = disabled): fused
    #: cycle executables survive process restarts, so a failover or
    #: rolling restart re-traces but never re-COMPILES (the 16.5 s
    #: first-call spikes in BENCH_r05 land at boot, inside warmup, or
    #: not at all — never inside a live cycle).
    compilation_cache_dir: str = ""
    #: boot-time warmup sweep: pre-compile (and execute once, with
    #: zeroed inputs) the compact fused cycle at the bucket grid implied
    #: by these design points.  0 disables warmup.  ``warmup_tasks`` /
    #: ``warmup_hosts`` are the expected steady-state maxima (padded up
    #: to their power-of-two buckets, ops/padding.py); ``warmup_users``
    #: sizes the per-user table bucket (minimum 8).
    warmup_tasks: int = 0
    warmup_hosts: int = 0
    warmup_users: int = 8
    #: True = warm EVERY bucket up to the targets (cold-start ramp
    #: traffic hits warm executables at every scale); False = only the
    #: target buckets.
    warmup_sweep: bool = False
    #: also warm the gpu DRU-mode variant of the cycle (pools with
    #: dru_mode=gpu compile a separate kernel)
    warmup_gpu: bool = False

    def __post_init__(self):
        if not isinstance(self.depth, int) or self.depth < 0:
            raise ValueError(
                f"pipeline depth must be an int >= 0, got {self.depth!r}")
        for k in ("warmup_tasks", "warmup_hosts", "warmup_users"):
            v = getattr(self, k)
            if not isinstance(v, int) or v < 0:
                raise ValueError(f"pipeline {k} must be an int >= 0, "
                                 f"got {v!r}")

    @classmethod
    def from_conf(cls, conf: Dict) -> "PipelineConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown pipeline key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"pipeline key {k!r} must be a JSON "
                                     f"boolean, got {v!r}")
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class AuditConfig:
    """Per-job scheduling audit trail knobs (utils/audit.py; the daemon's
    ``"audit"`` conf section, validated like PipelineConfig so a typo'd
    knob fails the boot).  docs/OBSERVABILITY.md."""

    #: record per-job decision events at all.  Off = the trail records
    #: nothing and `cs why` falls back to the stateless explainer.
    enabled: bool = True
    #: cap on jobs with a live event lane; the oldest-CREATED lane is
    #: evicted past this (insertion order, not LRU — the hot path skips
    #: per-event touch bookkeeping; the earliest submissions are the
    #: likeliest terminal)
    max_jobs: int = 100_000
    #: per-job event cap; repeated advisory events (ranked position,
    #: same-reason skips) coalesce into one counted event, and lifecycle
    #: events are evicted last
    per_job_events: int = 64
    #: journal durable events (lifecycle atomically with their txn,
    #: advisory once per cycle) so timelines survive leader failover;
    #: a store without an attached journal ignores this
    journal: bool = True

    def __post_init__(self):
        for k in ("max_jobs", "per_job_events"):
            v = getattr(self, k)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"audit {k} must be an int >= 1, "
                                 f"got {v!r}")

    @classmethod
    def from_conf(cls, conf: Dict) -> "AuditConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown audit key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"audit key {k!r} must be a JSON "
                                     f"boolean, got {v!r}")
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class HttpConfig:
    """Serving-plane request observability knobs (rest/instrument.py;
    the daemon's ``"http"`` conf section, boot-validated like
    PipelineConfig so a typo'd knob fails the boot).
    docs/OBSERVABILITY.md."""

    #: request instrumentation master switch: ``http.request`` spans, the
    #: per-endpoint RED metrics, and the /debug/requests capture rings.
    #: Request ids (X-Cook-Request-Id) are always minted/echoed — they
    #: are part of the error contract, not observability overhead.
    observe: bool = True
    #: recent-request ring size (every request, newest evicts oldest)
    request_log: int = 256
    #: a request at least this slow is captured in the slow ring with its
    #: per-phase breakdown ("why was this POST slow")
    slow_request_ms: float = 500.0
    #: slow-ring size
    slow_log: int = 64

    def __post_init__(self):
        for k in ("request_log", "slow_log"):
            v = getattr(self, k)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"http {k} must be an int >= 1, "
                                 f"got {v!r}")

    @classmethod
    def from_conf(cls, conf: Dict) -> "HttpConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown http key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"http key {k!r} must be a JSON "
                                     f"boolean, got {v!r}")
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class ElasticConfig:
    """Elastic-gang resize knobs (sched/elastic.py; the daemon's
    ``"elastic"`` conf section, boot-validated like the sections around
    it).  docs/GANG.md elasticity."""

    #: master switch: off = elastic bounds are still validated/stored
    #: but the resize plane (grow metering, grace shrinks, rebalancer
    #: shrink-instead-of-kill) never engages
    enabled: bool = True
    #: checkpoint grace between the shrink notification (SIGUSR1 +
    #: COOK_GANG_RESIZE_FILE event) and the member's kill.  0 = shed
    #: immediately (tests/sim).
    shrink_grace_seconds: float = 5.0
    #: resize-pass cadence when driven by wall-clock threads (the fused
    #: cycle also sweeps every cycle)
    resize_interval_seconds: float = 5.0

    def __post_init__(self):
        for k in ("shrink_grace_seconds", "resize_interval_seconds"):
            if float(getattr(self, k)) < 0:
                raise ValueError(f"elastic {k} must be >= 0")

    @classmethod
    def from_conf(cls, conf: Dict) -> "ElasticConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown elastic key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"elastic key {k!r} must be a JSON "
                                     f"boolean, got {v!r}")
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class AdmissionConfig:
    """Layered admission control + saturation-driven brownout (the
    daemon's ``"admission"`` conf section inside ``"scheduler"``,
    boot-validated like the sections around it).  The front door
    (rest/api.py) token-buckets submissions per user and requests per
    IP; the monitor-driven ``sched.admission.AdmissionController`` maps
    the six ``cook_saturation`` gauges to a 0-1 admission level with
    hysteresis (DAGOR-style feedback admission) and walks the brownout
    ladder — observability detail sheds first, then reads degrade to
    bounded-stale follower serves, then low-priority writes shed, and
    committed writes + scheduling decisions never shed.  docs/DEPLOY.md
    "overload runbook", docs/ROBUSTNESS.md "brownout ladder"."""

    #: master switch: off = no submission buckets, no adaptive level,
    #: no brownout (the pre-existing launch-rate tokens still apply)
    enabled: bool = False
    #: per-user submission token refill (jobs/minute); 0 = unlimited.
    #: The ADAPTIVE level scales this down under pressure.
    submissions_per_minute: float = 0.0
    #: per-user bucket size (burst); 0 = same as submissions_per_minute
    submission_burst: float = 0.0
    #: per-IP request refill for the serving plane; 0 = fall back to the
    #: daemon's top-level ``ip_requests_per_minute`` knob (both feed the
    #: same exemption list: /metrics, /debug/*, health probes never
    #: rate-limit so observability survives the incident)
    ip_requests_per_minute: float = 0.0
    #: GLOBAL per-user pending-job cap enforced at submission across
    #: partitions by riding the bounded UserSummaryExchange per-user
    #: summaries (never job state); 0 = off
    max_user_pending: int = 0
    #: adaptive level floor: even fully saturated, this fraction of the
    #: configured refill survives (never starve to a hard zero — the
    #: metastable-failure guard: some traffic must drain to recover)
    level_floor: float = 0.1
    #: worst-gauge saturation above which the level starts declining
    engage_saturation: float = 0.8
    #: saturation below which the level recovers; the [release, engage)
    #: band is the hysteresis dead zone (no flapping at the threshold)
    release_saturation: float = 0.6
    #: per-sweep level decrement at full pressure (scaled by how far the
    #: worst gauge sits past the engage threshold)
    decrease_step: float = 0.2
    #: per-sweep level increment while below the release threshold
    #: (recovery is gradual so admitted load ramps, not steps)
    recover_step: float = 0.05
    #: brownout ladder thresholds on the admission level, strictly
    #: descending: stage 1 (advisory observability detail sheds: audit
    #: advisory-flush folds, slow-ring capture off) ...
    observability_shed_level: float = 0.75
    #: ... stage 2 (follower reads serve bounded-stale: relaxed
    #: min-offset gate, honest X-Cook-Replication-Age-Ms) ...
    stale_reads_level: float = 0.5
    #: ... stage 3 (low-priority writes shed with 429).  Committed
    #: writes and scheduling decisions degrade last or never.
    shed_writes_level: float = 0.25
    #: recovery dwell: the level must hold ABOVE a stage's threshold
    #: this long before the stage steps back down (escalation is
    #: immediate; de-escalation is damped)
    stage_hold_seconds: float = 10.0
    #: stage 3 sheds submissions whose every job has priority below this
    shed_priority_below: int = 50
    #: stage >= 2: the follower's min-offset wait gate shrinks to this
    #: fraction of serving.min_offset_wait_seconds (bounded-stale serves
    #: stop queueing reads behind replication under overload)
    relaxed_offset_wait_factor: float = 0.1

    def __post_init__(self):
        for k in ("submissions_per_minute", "submission_burst",
                  "ip_requests_per_minute", "stage_hold_seconds"):
            if float(getattr(self, k)) < 0:
                raise ValueError(f"admission {k} must be >= 0")
        if not isinstance(self.max_user_pending, int) \
                or self.max_user_pending < 0:
            raise ValueError("admission max_user_pending must be an "
                             f"int >= 0, got {self.max_user_pending!r}")
        if not isinstance(self.shed_priority_below, int):
            raise ValueError("admission shed_priority_below must be an "
                             f"int, got {self.shed_priority_below!r}")
        if not (0.0 <= self.level_floor < 1.0):
            raise ValueError("admission level_floor must be in [0, 1)")
        if not (0.0 < self.release_saturation < self.engage_saturation
                <= 1.0):
            raise ValueError(
                "admission thresholds must satisfy 0 < "
                "release_saturation < engage_saturation <= 1, got "
                f"{self.release_saturation!r} / {self.engage_saturation!r}")
        for k in ("decrease_step", "recover_step"):
            if not (0.0 < float(getattr(self, k)) <= 1.0):
                raise ValueError(f"admission {k} must be in (0, 1]")
        if not (0.0 < self.shed_writes_level < self.stale_reads_level
                < self.observability_shed_level < 1.0):
            raise ValueError(
                "admission brownout levels must be strictly descending "
                "in (0, 1): observability_shed_level > stale_reads_level "
                "> shed_writes_level")
        if not (0.0 <= self.relaxed_offset_wait_factor <= 1.0):
            raise ValueError(
                "admission relaxed_offset_wait_factor must be in [0, 1]")

    @classmethod
    def from_conf(cls, conf: Dict) -> "AdmissionConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown admission key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"admission key {k!r} must be a JSON "
                                     f"boolean, got {v!r}")
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class StorageConfig:
    """Storage-integrity plane (the daemon's ``"storage"`` conf section;
    docs/ROBUSTNESS.md "WAL v2"): the monitor's background scrub
    incrementally re-verifies journal CRC32C frames
    (:meth:`~cook_tpu.state.store.Store.scrub`), a leader self-heals
    scrub-detected corruption by checkpointing (its memory is
    authoritative), and the boot hygiene sweep's minimum orphan age is
    tunable for shared-dir topologies."""

    #: master switch for the monitor-driven background scrub sweep
    scrub_enabled: bool = True
    #: seconds between scrub steps (each step verifies one chunk; the
    #: monitor sweep itself runs on monitor_interval_seconds, so the
    #: effective cadence is the max of the two)
    scrub_interval_seconds: float = 30.0
    #: journal bytes verified per scrub step — bounds the read burst a
    #: step may impose on the journal disk
    scrub_chunk_bytes: int = 1 << 20
    #: leader self-heal: checkpoint (fresh verified snapshot, damaged
    #: journal rotated aside) when the scrub finds corruption.  Off =
    #: detect-and-report only (the operator repairs per docs/DEPLOY.md).
    checkpoint_on_corruption: bool = True
    #: minimum age before the boot hygiene sweep unlinks an orphaned
    #: ``.tmp.`` atomic-write leftover or stale poison marker — a LIVE
    #: writer's in-flight temp in a shared dir must survive
    hygiene_min_age_seconds: float = 60.0
    #: per-peer timeout for the quarantine-and-pull repair path
    #: (state/repair.py)
    repair_timeout_seconds: float = 30.0

    def __post_init__(self):
        for k in ("scrub_interval_seconds", "hygiene_min_age_seconds"):
            if float(getattr(self, k)) < 0:
                raise ValueError(f"storage {k} must be >= 0")
        if not isinstance(self.scrub_chunk_bytes, int) \
                or self.scrub_chunk_bytes <= 0:
            raise ValueError("storage scrub_chunk_bytes must be an "
                             f"int > 0, got {self.scrub_chunk_bytes!r}")
        if float(self.repair_timeout_seconds) <= 0:
            raise ValueError("storage repair_timeout_seconds must be > 0")

    @classmethod
    def from_conf(cls, conf: Dict) -> "StorageConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown storage key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"storage key {k!r} must be a JSON "
                                     f"boolean, got {v!r}")
                setattr(cfg, k, v)
            else:
                setattr(cfg, k, type(default)(v))
        cfg.__post_init__()
        return cfg


@dataclass
class FederationConfig:
    """Multi-cell front-door tier (the daemon's top-level
    ``"federation"`` conf section; presence of the section makes the
    process a stateless ROUTER node — no store, no journal, no
    election, no scheduler).  Boot-validated like every other section:
    a typo'd knob or malformed cell entry fails the boot, never routes
    half-configured.  docs/DEPLOY.md "multi-cell federation"."""

    #: the cells this router fronts: objects with ``id`` + ``url``
    #: (required) and optional ``tier`` (``standard``/``spot``),
    #: ``attributes`` (data-locality string pairs) and ``weight``
    #: (relative capacity for load scoring).  At least one.
    cells: List[Dict] = field(default_factory=list)
    #: job label key carrying a data-locality demand: a job labeled
    #: ``{"cell-attribute/region": "us-east"}`` (for the default
    #: ``"cell-attribute/"`` prefix) routes only to cells whose
    #: attributes match every such pair; a label naming the reserved
    #: key ``cell-attribute/cell`` pins the batch to that cell id
    locality_label_prefix: str = "cell-attribute/"
    #: staleness bound on the federated per-user summary merge — the
    #: window every global-enforcement refusal quotes (asserted: an
    #: unmeetable bound raises, never silently serves)
    summary_max_age_seconds: float = 5.0
    #: GLOBAL per-user pending-job cap across every cell (0 = off);
    #: enforced at the front door off the federated summaries
    max_user_pending: int = 0
    #: GLOBAL per-user dominant-share ceiling in [0, 1] (0 = off): a
    #: user whose dominant resource share of the federation's running
    #: total exceeds this sheds NEW submissions with 429 until usage
    #: drains — the DRU fair-share floor, lifted to the federation
    max_user_dominant_share: float = 0.0
    #: routing mode: ``"load"`` scores cells by weight, in-flight
    #: demand and saturation; ``"goodput"`` additionally replays each
    #: candidate cell's recent routed traffic through ``sim/`` and
    #: routes to argmax predicted goodput (costlier per decision)
    route_mode: str = "load"
    #: consecutive transport failures that open a cell's breaker (the
    #: whole cell's traffic then reroutes until a half-open probe heals)
    breaker_failures: int = 3
    #: seconds an open cell breaker waits before the half-open probe
    breaker_reset_seconds: float = 5.0
    #: per-proxied-request timeout against a cell
    request_timeout_seconds: float = 5.0
    #: score multiplier applied to ``spot``-tier cells so standard
    #: capacity absorbs steady demand first, in (0, 1]
    spot_penalty: float = 0.5
    #: bounded commit ledger: most recent ACCEPTED submission batches
    #: remembered per router for outage re-route and uuid->cell read
    #: routing (oldest evicted first; eviction is counted, never silent)
    ledger_max_batches: int = 10000
    #: recent routed batches replayed per candidate cell in goodput
    #: route mode
    goodput_window: int = 32

    def __post_init__(self):
        if not isinstance(self.cells, list):
            raise ValueError("federation cells must be a list of "
                             "{id, url, ...} objects")
        seen = set()
        for entry in self.cells:
            if not isinstance(entry, dict):
                raise ValueError(
                    f"federation cell entry must be an object, got "
                    f"{entry!r}")
            unknown = set(entry) - {"id", "url", "tier", "attributes",
                                    "weight"}
            if unknown:
                raise ValueError(
                    f"unknown federation cell key(s) "
                    f"{sorted(unknown)!r}")
            if not entry.get("id") or not entry.get("url"):
                raise ValueError(
                    "federation cell entries require id and url, got "
                    f"{entry!r}")
            cid = str(entry["id"])
            if "/" in cid or "," in cid:
                # "/" qualifies token entries and "," joins the vector:
                # either in a cell id would make session tokens
                # ambiguous (federation/tokens.py)
                raise ValueError(f"federation cell id {cid!r} must not "
                                 "contain '/' or ','")
            if not str(entry["url"]).startswith(("http://", "https://")):
                raise ValueError(f"federation cell {cid!r} url must be "
                                 f"http(s), got {entry['url']!r}")
            if entry.get("tier", "standard") not in ("standard", "spot"):
                raise ValueError(
                    f"federation cell {cid!r} tier must be 'standard' "
                    f"or 'spot', got {entry['tier']!r}")
            if not isinstance(entry.get("attributes", {}), dict):
                raise ValueError(f"federation cell {cid!r} attributes "
                                 "must be an object")
            if float(entry.get("weight", 1.0)) <= 0:
                raise ValueError(
                    f"federation cell {cid!r} weight must be > 0")
            if cid in seen:
                raise ValueError(
                    f"duplicate federation cell id {cid!r}")
            seen.add(cid)
        if self.route_mode not in ("load", "goodput"):
            raise ValueError("federation route_mode must be 'load' or "
                             f"'goodput', got {self.route_mode!r}")
        if not self.locality_label_prefix:
            raise ValueError(
                "federation locality_label_prefix must be non-empty")
        for k in ("summary_max_age_seconds", "breaker_reset_seconds"):
            if float(getattr(self, k)) < 0:
                raise ValueError(f"federation {k} must be >= 0")
        if float(self.request_timeout_seconds) <= 0:
            raise ValueError(
                "federation request_timeout_seconds must be > 0")
        if not isinstance(self.max_user_pending, int) \
                or self.max_user_pending < 0:
            raise ValueError("federation max_user_pending must be an "
                             f"int >= 0, got {self.max_user_pending!r}")
        if not (0.0 <= float(self.max_user_dominant_share) <= 1.0):
            raise ValueError("federation max_user_dominant_share must "
                             "be in [0, 1]")
        if not (0.0 < float(self.spot_penalty) <= 1.0):
            raise ValueError("federation spot_penalty must be in (0, 1]")
        for k in ("breaker_failures", "ledger_max_batches",
                  "goodput_window"):
            if not isinstance(getattr(self, k), int) \
                    or getattr(self, k) < 1:
                raise ValueError(f"federation {k} must be an int >= 1, "
                                 f"got {getattr(self, k)!r}")

    @classmethod
    def from_conf(cls, conf: Dict) -> "FederationConfig":
        cfg = cls()
        for k, v in conf.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown federation key {k!r}")
            default = getattr(cfg, k)
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(f"federation key {k!r} must be a "
                                     f"JSON boolean, got {v!r}")
                setattr(cfg, k, v)
            elif isinstance(default, list):
                if not isinstance(v, list):
                    raise ValueError(f"federation key {k!r} must be a "
                                     f"JSON array, got {v!r}")
                setattr(cfg, k, list(v))
            else:
                setattr(cfg, k, type(default)(v))
        if not cfg.cells:
            # a router fronting zero cells would accept nothing and
            # route nowhere — a config mistake, not a deployment
            raise ValueError("federation requires at least one cell "
                             "({id, url} entries under federation.cells)")
        cfg.__post_init__()
        return cfg


@dataclass
class CircuitBreakerConfig:
    """Per-compute-cluster launch circuit breaker (utils/retry.py):
    ``failure_threshold`` consecutive backend failures open the breaker
    (the matcher routes launches to healthy clusters); a half-open probe
    after ``reset_timeout_s`` discovers recovery."""

    failure_threshold: int = 5
    reset_timeout_s: float = 30.0


@dataclass
class EstimatedCompletionConfig:
    """estimated-completion constraint knobs (reference:
    config/estimated-completion-config, constraints.clj:408-432). Disabled
    unless both multiplier and host_lifetime_mins are set."""
    expected_runtime_multiplier: Optional[float] = None
    host_lifetime_mins: Optional[int] = None
    agent_start_grace_period_mins: int = 10


@dataclass
class Config:
    rank_interval_seconds: float = 5.0         # mesos.clj:108
    match_interval_seconds: float = 1.0        # target-per-pool-match-interval
    max_over_quota_jobs: int = 100             # config.clj:413-416
    # "fused": production path — one device dispatch runs rank+admission+
    # match for all pools (sched/fused.py); "split": host-driven per-pool
    # step_rank/step_match (CPU fallback, deterministic tests)
    cycle_mode: str = "fused"
    # rank straight off the incrementally-maintained columnar projection of
    # the store (state/index.py) instead of materializing entities per
    # cycle; the entity path remains the CPU-fallback/parity mode
    columnar_index: bool = True
    # keep the fused cycle's stacked [P, T] wire arrays (row permutation +
    # admission flags) RESIDENT on device across cycles, scatter-applying
    # per-cycle deltas extracted off the index's tx-event feed instead of
    # re-uploading the world (ops/delta.py; docs/PERFORMANCE.md).  Full
    # repacks happen only on compaction fences, bucket regrows, or kernel
    # faults.  Decision-identical to the rebuild path; only engages with
    # columnar_index=True (the compact wire form).
    resident_pack: bool = True
    # quantized compact wire (ops/quant.py; docs/PERFORMANCE.md wire
    # negotiation table): narrow each per-cycle h2d field to the
    # smallest dtype its domain admits THIS cycle — delta-coded i8/i16
    # rows, u16 fixed-point host stacks, bitpacked host flags — but only
    # where the round trip is bit-exact; overflowing domains ship wide
    # automatically.  Engages on the megakernel dispatch path and the
    # delta feed's scatter values; never changes a decision.
    quantized_wire: bool = True
    default_pool: str = "default"
    # pool-regex -> matcher config, first match wins (config.clj:798)
    pool_matchers: List[tuple] = field(default_factory=list)
    default_matcher: MatcherConfig = field(default_factory=MatcherConfig)
    rebalancer: RebalancerConfig = field(default_factory=RebalancerConfig)
    # pool name -> global quota; pool -> quota-group name for cross-pool caps
    pool_quotas: Dict[str, PoolQuota] = field(default_factory=dict)
    quota_groups: Dict[str, str] = field(default_factory=dict)
    quota_group_quotas: Dict[str, PoolQuota] = field(default_factory=dict)
    max_tasks_per_host: Optional[int] = None
    estimated_completion: EstimatedCompletionConfig = field(
        default_factory=EstimatedCompletionConfig)
    task_constraints: TaskConstraints = field(default_factory=TaskConstraints)
    # synthetic-pod autoscaling after each match cycle (scheduler.clj:1178)
    autoscaling_enabled: bool = False
    # reapers (scheduler.clj:1888-2016)
    lingering_task_interval_seconds: float = 30.0
    # dotted factory paths POST /compute-clusters/{name} may instantiate
    # (the daemon seeds this with its static cluster specs' factories);
    # empty = dynamic cluster CREATION disabled
    cluster_factory_allowlist: List[str] = field(default_factory=list)
    # a running instance whose compute cluster is GONE (the previous
    # leader's in-process backend, a deleted dynamic cluster) is failed
    # NODE_LOST (mea-culpa) after this grace window — long enough for a
    # dynamic re-add, short enough that failover retries promptly
    orphaned_cluster_grace_seconds: float = 30.0
    straggler_interval_seconds: float = 30.0
    # user/pool gauge sweeper (monitor.clj:209)
    monitor_interval_seconds: float = 30.0
    # queue-latency / cycle-duration SLOs exposed on /metrics
    slo: SloConfig = field(default_factory=SloConfig)
    # deterministic fault injection + launch circuit breakers
    # (docs/ROBUSTNESS.md); the scheduler applies both at construction
    faults: FaultInjectionConfig = field(
        default_factory=FaultInjectionConfig)
    circuit_breaker: CircuitBreakerConfig = field(
        default_factory=CircuitBreakerConfig)
    # pipelined fused-cycle driver + compile-cache warmup
    # (sched/pipeline.py, docs/PERFORMANCE.md); depth=0 pins the
    # strictly-synchronous driver
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    # per-job scheduling audit trail (utils/audit.py; the "why isn't my
    # job running" lane, docs/OBSERVABILITY.md)
    audit: AuditConfig = field(default_factory=AuditConfig)
    # serving-plane request observability: http.request spans, RED
    # metrics, /debug/requests capture rings (rest/instrument.py)
    http: HttpConfig = field(default_factory=HttpConfig)
    # serving-plane scale-out: follower read fleet + leader group-commit
    # admission batching (state/read_replica.py, state/store.py)
    serving: ServingConfig = field(default_factory=ServingConfig)
    # fleet observability plane: metrics federation + stitched traces +
    # saturation signals (sched/fleet.py, docs/OBSERVABILITY.md)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    # partitioned write plane: per-pool-group store/journal shards with
    # independent fsync streams + leases (state/partition.py); count=1 =
    # the classic single-store plane
    partitions: PartitionConfig = field(default_factory=PartitionConfig)
    # elastic-gang resize plane (sched/elastic.py, docs/GANG.md
    # elasticity): grace-shrink protocol + optimizer-set budgets
    elastic: ElasticConfig = field(default_factory=ElasticConfig)
    # layered admission control + saturation-driven brownout
    # (sched/admission.py, policy/rate_limit.py; docs/DEPLOY.md
    # "overload runbook")
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    # storage-integrity plane: background CRC scrub + corruption
    # self-heal + hygiene-sweep tuning (state/integrity.py,
    # state/repair.py; docs/ROBUSTNESS.md "WAL v2")
    storage: StorageConfig = field(default_factory=StorageConfig)
    # the real optimizer loop (sched/optimizer.py): a
    # ``sched.optimizer.OptimizerConfig`` when the daemon's "optimizer"
    # conf section enables it, else None (loop off).  Held untyped here
    # because config.py must not import the sched package (cycle); the
    # daemon boot-validates the section via OptimizerConfig.from_conf.
    optimizer: Optional[object] = None
    # executor heartbeat timeout killer (mesos/heartbeat.clj:66-147);
    # disabled by default like the reference (marked deprecated there)
    heartbeat_enabled: bool = False
    heartbeat_timeout_ms: int = 60_000
    # offensive-job stifling in the rank cycle (scheduler.clj:2205-2257);
    # None disables the filter
    offensive_job_limits: Optional[OffensiveJobLimits] = None

    # pool-regex planes (reference: config.clj pools
    # {:default-containers [{:pool-regex :container}], :default-env,
    # :valid-gpu-models}); first match wins, None/missing = not configured
    default_containers: List[tuple] = field(default_factory=list)
    default_envs: List[tuple] = field(default_factory=list)
    valid_gpu_models: List[tuple] = field(default_factory=list)
    # operator k8s policy mirrored into /settings on EVERY node (api-only
    # followers included); the k8s backends receive the same values as
    # constructor kwargs (reference: config :kubernetes
    # :disallowed-container-paths / :disallowed-var-names)
    kubernetes_disallowed_container_paths: List[str] = \
        field(default_factory=list)
    kubernetes_disallowed_var_names: List[str] = field(default_factory=list)

    _compiled: List[tuple] = field(default_factory=list, repr=False)

    def _pool_match(self, table: List[tuple], pool_name: str):
        for rx, val in table:
            if re.search(rx, pool_name):
                return val
        return None

    def default_container_for_pool(self, pool_name: str) -> Optional[Dict]:
        """reference: get-default-container-for-pool, rest/api.clj:719"""
        return self._pool_match(self.default_containers, pool_name)

    def default_env_for_pool(self, pool_name: str) -> Dict[str, str]:
        return self._pool_match(self.default_envs, pool_name) or {}

    def gpu_models_for_pool(self, pool_name: str) -> Optional[List[str]]:
        """reference: get-gpu-models-on-pool, rest/api.clj:724"""
        return self._pool_match(self.valid_gpu_models, pool_name)

    def matcher_for_pool(self, pool_name: str) -> MatcherConfig:
        if not self._compiled and self.pool_matchers:
            self._compiled = [(re.compile(rx), mc) for rx, mc in self.pool_matchers]
        for rx, mc in self._compiled:
            if rx.search(pool_name):
                return mc
        return self.default_matcher

    def pool_quota(self, pool_name: str) -> Optional[PoolQuota]:
        return self.pool_quotas.get(pool_name)


def refuse_unported(config: Config, optimizer: bool = False) -> None:
    """The reference's optional scheduler planes this port does not have
    raise here instead of being silently ignored.  One check for the
    ``Scheduler``'s constructor and the daemon's boot
    (``daemon.build_scheduler_config``, where ``optimizer`` says the
    config file has an ``"optimizer"`` section), so the two refusals
    cannot drift apart."""
    if optimizer or config.optimizer is not None:
        raise NotImplementedError(
            "the goodput optimizer loop (config.optimizer) is not "
            "ported: see ROADMAP.md, queue 1, item 7c")
    pl = config.pipeline
    if pl.warmup_tasks or pl.warmup_hosts or pl.compilation_cache_dir:
        raise NotImplementedError(
            "the boot-time warmup and the compilation cache "
            "(pipeline.warmup_tasks / warmup_hosts / "
            "compilation_cache_dir) are not ported: see ROADMAP.md, "
            "queue 1, item 7e ('warmup_kernels')")
