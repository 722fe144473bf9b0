"""The port's copy of ``cook_tpu/daemon.py``: ``python -m cook_tpu_torch
--config cook.json``.  It adds a ``device`` (the ``--device`` flag, else
the config's top-level ``"device"`` key, else ``"cuda"``), resolved at
boot before the listener binds on every node that may lead, so a node
without its card exits nonzero and never serves; the elected leader's
``Scheduler`` runs on it.  A ``"federation"`` section makes the node the
stateless front door over N cells (``federation/``), as the reference's
does; its router resolves ``device`` only in the goodput route mode,
whose replays match through K5 there, so a load-mode front door boots
without a card.  ``partitions.count > 1``
opens the partitioned write plane (``state/partition``: one journal a
partition under ``<data_dir>/p<i>/``) and pins the scheduler to the
entity path, as the reference's node does.  A cluster or optimizer
factory in the JAX package (``cook_tpu.`` ...) is refused at boot: importing
it would load JAX into the node.  The clusters a node builds are the
port's fake backend, its remote backend
(``cook_tpu_torch.cluster.remote.factory``:
``cook_agentd`` agents over the repo-root ``native/transport.cpp``) and
its Kubernetes backend (``cook_tpu_torch.cluster.k8s.compute_cluster.
factory``); ``election.mode = "k8s-lease"`` elects over a Lease object
through the port's ``RealKubernetesApi``.

Process shell: config file -> store -> election -> clusters -> scheduler
-> REST, serving until leadership loss.

The equivalent of the reference's ``-main`` component graph (reference:
scheduler/src/cook/components.clj:345-365 -main + eager component compile
:257-343) and its leader-selector lifecycle (mesos.clj:153-328): every node
serves the REST API immediately; one node wins the election and becomes the
scheduler; on leadership loss the process EXITS NONZERO so a supervisor
restarts it clean (mesos.clj:296-313 System/exit).  ``api_only`` nodes never
campaign and 307-redirect leader-only requests (config.clj:692).

Config file is JSON or TOML:

    {
      "port": 12321,
      "host": "127.0.0.1",
      "data_dir": "/var/lib/cook",        # durable store (snapshot+journal)
      "election_dir": "/var/lib/cook",    # lock shared by contending nodes
      "api_only": false,
      "admins": ["admin"],
      "impersonators": [],
      "basic_auth_users": null,           # {"user": "password"} or null=open
      "device": "cuda",                   # the leader's torch device
      "clusters": [
        {"factory": "cook_tpu_torch.cluster.fake.factory",
         "kwargs": {"name": "fake-1", "n_hosts": 4}},
        {"factory": "cook_tpu_torch.cluster.remote.factory",
         "kwargs": {"name": "native-1",
                    "endpoints": [["node-a", 7070]],
                    "progress_url": "http://this-node:12321"}},
        {"factory": "cook_tpu_torch.cluster.k8s.compute_cluster.factory",
         "kwargs": {"name": "k8s-1", "api_url": "https://apiserver"}}
      ],
      "election": {"mode": "k8s-lease", "base_url": "https://apiserver"},
      "plugins": {},                      # PluginRegistry.from_config spec
      "scheduler": {"cycle_mode": "fused", "rank_backend": "tpu", ...}
    }
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import re
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import resolve_device
from .config import Config
from .parallel.mesh import validate_shard_alignment
from .policy import PluginRegistry, QueueLimits, RateLimits
from .rest.api import (ApiError, ApiServer, CookApi,
                       check_container_wire_bytes, check_env_wire_bytes)
from .sched import Scheduler
from .sched.election import FileLeaderElector
from .state.partition import PartitionedStore, PartitionMap
from .state.store import Store

# Config fields settable straight from the "scheduler" config section.
_SCALAR_CONFIG_FIELDS = (
    "rank_interval_seconds", "match_interval_seconds", "max_over_quota_jobs",
    "cycle_mode", "default_pool", "autoscaling_enabled",
    "lingering_task_interval_seconds", "straggler_interval_seconds",
    "monitor_interval_seconds", "max_tasks_per_host", "heartbeat_enabled",
    "heartbeat_timeout_ms", "orphaned_cluster_grace_seconds",
    "columnar_index", "resident_pack", "quantized_wire",
)


def load_config_file(path: str) -> Dict:
    text = Path(path).read_text()
    if path.endswith(".toml"):
        import tomllib
        return tomllib.loads(text)
    return json.loads(text)


def build_scheduler_config(spec: Dict) -> Config:
    cfg = Config()
    for key in _SCALAR_CONFIG_FIELDS:
        if key in spec and hasattr(cfg, key):
            setattr(cfg, key, spec[key])
    if "default_matcher" in spec:
        for k, v in spec["default_matcher"].items():
            if not hasattr(cfg.default_matcher, k):
                # a typo'd KEY silently keeping the default would let an
                # operator believe a knob is set (e.g. "auto_paking")
                raise ValueError(
                    f"unknown default_matcher key {k!r}")
            setattr(cfg.default_matcher, k, v)
        # setattr bypasses dataclass construction: re-validate so a
        # typo'd backend/auto_packing VALUE also fails the BOOT
        cfg.default_matcher.__post_init__()
    if "rebalancer" in spec:
        for k, v in spec["rebalancer"].items():
            if hasattr(cfg.rebalancer, k):
                setattr(cfg.rebalancer, k, v)
    if "task_constraints" in spec:
        # submission-time limits (reference: config.clj :task-constraints)
        for k, v in spec["task_constraints"].items():
            if hasattr(cfg.task_constraints, k):
                setattr(cfg.task_constraints, k, v)
    if "slo" in spec:
        # queue-latency / cycle-duration objectives (docs/OBSERVABILITY.md)
        for k, v in spec["slo"].items():
            if not hasattr(cfg.slo, k):
                raise ValueError(f"unknown slo key {k!r}")
            setattr(cfg.slo, k, v)
    if "faults" in spec:
        # deterministic fault injection (docs/ROBUSTNESS.md): arming from
        # config is explicit chaos opt-in, applied by the scheduler at
        # takeover.  A typo'd knob must fail the boot, not silently arm
        # nothing while the operator believes chaos is running.
        for k, v in spec["faults"].items():
            if not hasattr(cfg.faults, k):
                raise ValueError(f"unknown faults key {k!r}")
            setattr(cfg.faults, k, v)
        cfg.faults.enabled = bool(spec["faults"].get(
            "enabled", bool(cfg.faults.points)))
    if "circuit_breaker" in spec:
        for k, v in spec["circuit_breaker"].items():
            if not hasattr(cfg.circuit_breaker, k):
                raise ValueError(f"unknown circuit_breaker key {k!r}")
            setattr(cfg.circuit_breaker, k, v)
    if "pipeline" in spec:
        # pipelined fused cycles + compile-cache warmup
        # (docs/PERFORMANCE.md): a typo'd knob fails the BOOT — a
        # silently-defaulted depth would run a driver the operator
        # didn't choose
        from .config import PipelineConfig
        cfg.pipeline = PipelineConfig.from_conf(spec["pipeline"])
    if "audit" in spec:
        # per-job scheduling audit trail (docs/OBSERVABILITY.md); a
        # typo'd knob fails the boot like the pipeline section
        from .config import AuditConfig
        cfg.audit = AuditConfig.from_conf(spec["audit"])
    if "http" in spec:
        # serving-plane request observability (docs/OBSERVABILITY.md);
        # boot-validated like the pipeline/audit sections
        from .config import HttpConfig
        cfg.http = HttpConfig.from_conf(spec["http"])
    if "serving" in spec:
        # serving-plane scale-out: follower read fleet + group-commit
        # admission batching (docs/DEPLOY.md, docs/PERFORMANCE.md); a
        # typo'd knob fails the boot like the sections above
        from .config import ServingConfig
        cfg.serving = ServingConfig.from_conf(spec["serving"])
    if "partitions" in spec:
        # partitioned write plane (docs/DEPLOY.md): pool-group store/
        # journal shards; the routing map is validated HERE so a typo'd
        # index fails the boot, not the first submission to that pool
        from .config import PartitionConfig
        cfg.partitions = PartitionConfig.from_conf(spec["partitions"])
    if "elastic" in spec:
        # elastic-gang resize plane (docs/GANG.md elasticity): grace
        # window + resize cadence; a typo'd knob fails the boot like
        # the sections above
        from .config import ElasticConfig
        cfg.elastic = ElasticConfig.from_conf(spec["elastic"])
    if "optimizer" in spec:
        # the goodput optimizer loop (sched/optimizer.py): factories,
        # interval, and the nested goodput knobs are ALL validated at
        # boot — from_conf constructs the cycler once, so a typo'd
        # candidate list, a non-positive interval or a factory in the
        # JAX package fails here, not at the first cycle half a minute
        # into leadership
        from .sched.optimizer import OptimizerConfig
        cfg.optimizer = OptimizerConfig.from_conf(spec["optimizer"])
    if "fleet" in spec:
        # fleet observability plane (docs/OBSERVABILITY.md): federation
        # scrape cadence, trace fan-out timeout, static extra members,
        # and the saturation red lines; a typo'd knob fails the boot
        # like the sections above
        from .config import FleetConfig
        cfg.fleet = FleetConfig.from_conf(spec["fleet"])
    if "admission" in spec:
        # layered admission + brownout ladder (docs/ROBUSTNESS.md,
        # docs/DEPLOY.md overload runbook): per-user/per-IP buckets,
        # the adaptive level's hysteresis band, and the stage
        # thresholds are ALL validated at boot — a typo'd knob or an
        # out-of-order ladder must fail here, not during the first
        # overload it was configured to survive
        from .config import AdmissionConfig
        cfg.admission = AdmissionConfig.from_conf(spec["admission"])
    if "storage" in spec:
        # storage-integrity plane (docs/ROBUSTNESS.md "WAL v2"): scrub
        # cadence/chunk, corruption self-heal, hygiene-sweep age; a
        # typo'd knob fails the boot like the sections above
        from .config import StorageConfig
        cfg.storage = StorageConfig.from_conf(spec["storage"])
        from .state import integrity as _integrity
        # Store.open's hygiene sweep runs before any config object is
        # reachable from the store, so the knob lands module-level
        _integrity.HYGIENE_MIN_AGE_S = \
            float(cfg.storage.hygiene_min_age_seconds)
    k8s = spec.get("kubernetes") or {}
    cfg.kubernetes_disallowed_container_paths = list(
        k8s.get("disallowed_container_paths", []))
    cfg.kubernetes_disallowed_var_names = list(
        k8s.get("disallowed_var_names", []))
    # pool-regex planes (reference config shape: [{"pool-regex": ...,
    # "container"/"env"/"valid-models": ...}])
    for conf_key, attr, value_key in (
            ("default_containers", "default_containers", "container"),
            ("default_envs", "default_envs", "env"),
            ("valid_gpu_models", "valid_gpu_models", "valid-models")):
        table = []
        for e in spec.get(conf_key) or []:
            rx, val = e.get("pool-regex"), e.get(value_key)
            if rx is None or val is None:
                print(f"cook_tpu: ignoring malformed {conf_key} entry "
                      f"{e!r} (needs pool-regex + {value_key})",
                      file=sys.stderr)
                continue
            try:
                # fail the BOOT on a bad pattern, not every submission
                re.compile(rx)
            except re.error as exc:
                raise ValueError(
                    f"invalid pool-regex {rx!r} in {conf_key}: {exc}")
            _check_plane_wire_bytes(conf_key, value_key, val)
            table.append((rx, val))
        setattr(cfg, attr, table)
    return cfg


def _check_plane_wire_bytes(conf_key: str, value_key: str, val) -> None:
    """Fail the BOOT when a pool-default container/env embeds NUL or the
    \\x1e wire separator — otherwise every job in the pool would be
    refused at the transport guard (or 500 at submission), an opaque
    failure for a purely operator-side mistake."""
    try:
        if value_key == "env":
            if not isinstance(val, dict):
                # check_env_wire_bytes skips non-dicts, but a list here
                # would TypeError every submission to the pool — fail boot
                raise ApiError(400, "env must be a map of VAR to value")
            check_env_wire_bytes(val)
        elif value_key == "container":
            check_container_wire_bytes(val)
    except ApiError as exc:
        raise ValueError(f"{conf_key}: {exc.message}") from exc


def build_authenticators(conf: Dict) -> Optional[List]:
    """Authentication chain from config (reference: the auth middleware
    selection, components.clj:266-284 + config :authorization).

    Keys: ``gssapi_service`` ("HTTP") enables SPNEGO/Kerberos validation
    (needs the gssapi package + a keytab; construction fails the boot
    fast when they're absent), ``hmac_ticket_secret`` enables the KDC-free
    signed-ticket scheme, ``basic_auth_users`` a password table.  Any of
    them configured makes authentication mandatory; none = open
    (trusted-header) mode handled by CookApi itself."""
    from .rest.auth import (BasicAuthenticator, GssapiAuthenticator,
                            HmacTokenAuthenticator)
    chain: List = []
    if conf.get("gssapi_service"):
        chain.append(GssapiAuthenticator(service=conf["gssapi_service"]))
    if conf.get("hmac_ticket_secret"):
        chain.append(HmacTokenAuthenticator(conf["hmac_ticket_secret"]))
    if conf.get("basic_auth_users") and chain:
        # with a chain, basic joins it; alone, CookApi's own basic path
        # (the basic_auth_users kwarg) keeps handling it
        chain.append(BasicAuthenticator(conf["basic_auth_users"]))
    return chain or None


def check_cluster_factory(path: str) -> None:
    """Refuse a cluster factory that lives in the JAX package: importing
    ``cook_tpu.cluster.fake.factory`` would load the JAX package, and JAX
    with it, into the node.  The path is never rewritten silently; the
    message names the port's counterpart."""
    module = path.rpartition(".")[0]
    if module == "cook_tpu" or module.startswith("cook_tpu."):
        counterpart = "cook_tpu_torch" + path[len("cook_tpu"):]
        raise ValueError(
            f"cluster factory {path!r} is in the JAX package, which the "
            f"port never imports; use {counterpart!r}")


def build_clusters(specs: List[Dict], store: Store,
                   config: Optional[Config] = None) -> List:
    """Dotted-path cluster factories, the analog of the reference's
    factory-fn template instantiation (compute_cluster.clj:483-497).

    ``config`` threads the operator's scheduler-level k8s policy
    (disallowed container paths / var names) into any k8s backend that
    didn't receive its own explicit kwargs — config is the cross-node
    source of truth (/settings reports it on every node)."""
    clusters = []
    for spec in specs or []:
        path = spec["factory"]
        check_cluster_factory(path)
        module, _, attr = path.rpartition(".")
        factory = getattr(importlib.import_module(module), attr)
        kwargs = dict(spec.get("kwargs", {}))
        cluster = factory(store=store, **kwargs)
        if config is not None \
                and hasattr(cluster, "disallowed_container_paths"):
            # the scheduler-level policy is a GLOBAL FLOOR: every k8s
            # backend enforces it in addition to its own kwargs, so the
            # /settings union reports exactly what is enforced
            cluster.disallowed_container_paths |= set(
                config.kubernetes_disallowed_container_paths)
            cluster.disallowed_var_names |= set(
                config.kubernetes_disallowed_var_names)
        clusters.append(cluster)
    return clusters


class CookDaemon:
    """One node's lifecycle.  ``run()`` blocks until shutdown and returns
    the process exit code (nonzero on leadership loss, the supervisor
    restart contract)."""

    def __init__(self, conf: Dict, port_override: Optional[int] = None,
                 api_only: Optional[bool] = None, device=None):
        self.conf = conf
        # the torch device the elected leader's Scheduler runs on: the
        # argument, else the config's "device", else the card; resolved
        # in start() before the listener binds
        self.device = device if device is not None \
            else conf.get("device", "cuda")
        self.host = conf.get("host", "127.0.0.1")
        self.port = port_override if port_override is not None \
            else int(conf.get("port", 0))
        self.api_only = bool(conf.get("api_only", False)
                             if api_only is None else api_only)
        self.data_dir = conf.get("data_dir")
        self.exit_code = 0
        self._done = threading.Event()
        self._lock = threading.Lock()
        self.store: Optional[Store] = None
        self.scheduler: Optional[Scheduler] = None
        self.api: Optional[CookApi] = None
        self.server: Optional[ApiServer] = None
        self.elector: Optional[FileLeaderElector] = None
        # socket journal replication (state/replication.py): leader serves
        # its local journal; standbys mirror it into THEIR local data_dir
        self.repl_server = None
        self.repl_follower = None
        self._repl_stop = threading.Event()
        self._repl_thread: Optional[threading.Thread] = None
        # coordinated promotion (quorum-aware failover): a standby also
        # serves its own mirror (standby→standby catch-up) and publishes
        # its replication position into the election medium
        self.standby_server = None
        self._node_id: str = ""
        self._fence_thread: Optional[threading.Thread] = None
        # follower read fleet (state/read_replica.py): a standby's live
        # journal-applied store, served by the REST layer with the
        # bounded-staleness contract (docs/DEPLOY.md)
        self.read_view = None
        # monotonic timestamp of the last NOT-superseded fence verdict
        # (_fence_superseded's short-TTL cache)
        self._fence_cache: Optional[float] = None
        # fleet observability plane (sched/fleet.py): federation scraper
        # + trace fan-out over the candidate registry's topology
        self.fleet = None
        # multi-cell federation front door (federation/): a "federation"
        # conf section makes this process a stateless router over N
        # cells — no store, no journal, no election
        self.federation = None

    # -------------------------------------------------------------- assembly
    def start(self) -> None:
        conf = self.conf
        # ------------------------------------------------ federation role
        fed = conf.get("federation")
        if fed is not None:
            # the front door is sovereign-cell-agnostic by construction:
            # combining it with cell state in one process would couple
            # the router's availability to one cell's journal — exactly
            # the blast-radius federation exists to remove.  Refuse the
            # combination at boot, like every other conf contradiction.
            clashing = [k for k in ("scheduler", "clusters", "replication",
                                    "shared_data_dir", "data_dir",
                                    "election_dir", "election")
                        if conf.get(k)]
            if clashing:
                raise ValueError(
                    "a \"federation\" section makes this process a "
                    "stateless front-door router; it cannot also carry "
                    f"cell state (drop {', '.join(sorted(clashing))} or "
                    "run them as separate cell daemons — docs/DEPLOY.md "
                    "multi-cell federation)")
            from .federation.rest import build_federation_node
            # boot-validates the section (FederationConfig.from_conf):
            # unknown keys, malformed cells, bad tiers all fail HERE; the
            # goodput route mode resolves the device here too
            self.federation = build_federation_node(
                fed, host=self.host, port=self.port, device=self.device)
            self.federation.start()
            self.node_url = self.federation.url
            self._node_id = f"{self.host}-{self.federation.port}"
            from .utils import tracing
            tracing.set_process_identity(self._node_id)
            return
        self._refuse_jax_factories()
        # shared_data_dir: the data dir is on shared storage reachable from
        # every scheduler host (the Datomic-transactor slot).  Followers
        # load a replay-only view (no journal attach — their appends would
        # interleave with the leader's); the election winner re-opens
        # FENCED at the next epoch in _on_leadership, which also replays
        # everything the previous leader committed.
        sd = conf.get("shared_data_dir")
        self.shared_data = bool(sd)
        if isinstance(sd, str) and sd:
            # shared_data_dir may BE the path (the name invites it).  It
            # always wins over data_dir: fencing a node-local dir while
            # the operator believes shared-journal failover is active
            # would silently lose ALL state on the first real failover.
            if self.data_dir and self.data_dir != sd:
                print(f"cook_tpu: shared_data_dir={sd!r} overrides "
                      f"data_dir={self.data_dir!r} (HA state must live "
                      "on the shared path)", flush=True)
            self.data_dir = sd
        # "replication": {...} — HA over SEPARATE node-local data dirs:
        # the leader streams its journal to standbys over the native
        # framed-TCP carrier (no shared filesystem; the Datomic
        # networked-store slot, datomic.clj:79).  Mutually exclusive with
        # shared_data_dir, which wins (both configured would double-apply).
        self.repl_conf = dict(conf.get("replication") or {})
        self.replication = bool(self.repl_conf) and not self.shared_data \
            and bool(self.data_dir)
        if self.replication:
            from .config import ReplicationConfig
            # a typo'd knob fails the BOOT, like the scheduler sections
            self.repl_cfg = ReplicationConfig.from_conf(self.repl_conf)
        if self.repl_conf and self.shared_data:
            print("cook_tpu: replication ignored (shared_data_dir wins)",
                  flush=True)
        if self.repl_conf and not self.shared_data and not self.data_dir:
            # silently running a pure in-memory store while the operator
            # believes sync replication protects the state would lose
            # everything on the first restart
            raise ValueError("replication requires a data_dir (the "
                             "local journal to replicate)")
        sched_spec = dict(conf.get("scheduler", {}))
        self.sched_config = build_scheduler_config(sched_spec)
        # partitioned write plane (docs/DEPLOY.md): P > 1 shards the
        # store + journal by pool group.  Config is validated at boot;
        # P = 1 keeps the classic single Store (compatibility mode).
        pc = self.sched_config.partitions
        self.partitioned = pc.count > 1
        if self.partitioned:
            if self.shared_data or self.replication:
                # each partition carries its OWN replication topology;
                # wiring P topologies through one daemon's follower
                # loop is the multi-host half of this plane and ships
                # with the federation work — refusing beats silently
                # mirroring one journal of P
                raise ValueError(
                    "partitions.count > 1 is not yet supported together "
                    "with shared_data_dir/replication in one daemon; "
                    "run the partitioned plane standalone (per-partition "
                    "replication is exercised by sim --chaos-failover "
                    "--partitions)")
            if self.sched_config.columnar_index \
                    or self.sched_config.resident_pack:
                # the columnar projection is per-store; the partitioned
                # facade serves the entity path
                print("cook_tpu: partitions>1 pins columnar_index/"
                      "resident_pack off (entity path)", flush=True)
                self.sched_config.columnar_index = False
                self.sched_config.resident_pack = False
            pmap = PartitionMap(count=pc.count, pools=pc.pools)
            if pc.shards or pc.shard_pools:
                # the PartitionMap pool groups and the controller
                # shards' pool layout must be the SAME partition — a
                # mismatched declaration silently double-owns or orphans
                # a pool's resident buffers, so it fails the boot here
                # with the offending pool named (ShardAlignmentError is
                # a ValueError: same config-error surface as the
                # sections around it)
                validate_shard_alignment(pmap, pc.shards or 1,
                                         pc.shard_pools)
        if not self.api_only:
            # a node that may lead runs its Scheduler on this device: a
            # missing card fails the boot here, before the listener binds
            # and before any state is opened, never a fall back to the CPU
            self.device = resolve_device(self.device)
        if self.partitioned:
            if not self.data_dir:
                self.store = PartitionedStore(
                    [Store(partition=i) for i in range(pc.count)], pmap,
                    summary_max_age_s=pc.summary_max_age_seconds)
            else:
                # per-partition lease claims: each shard dir fences at
                # its own epoch (the N-leases-over-P-partitions layout)
                self.store = PartitionedStore.open(
                    self.data_dir, pmap,
                    summary_max_age_s=pc.summary_max_age_seconds)
        elif not self.data_dir:
            self.store = Store()
        elif self.shared_data or self.replication:
            # follower view until elected (replication: the native
            # follower mirrors the leader's bytes into this same local
            # dir; the election winner re-opens fenced in _on_leadership)
            os.makedirs(self.data_dir, exist_ok=True)
            self.store = Store.replay_only(self.data_dir)
        else:
            self.store = Store.open(self.data_dir)
        # dynamic cluster creation may instantiate exactly the factories
        # the operator already declared (plus an explicit allowlist)
        self.sched_config.cluster_factory_allowlist = sorted(
            {c["factory"] for c in conf.get("clusters", [])}
            | set(conf.get("cluster_factory_allowlist", [])))
        self.rank_backend = sched_spec.get("rank_backend", "tpu")
        self.plugins = PluginRegistry.from_config(conf.get("plugins", {}))
        self.rate_limits = RateLimits()
        self.queue_limits = QueueLimits(store=self.store)

        # REST serves on every node from the start (api-only nodes 307
        # leader-only requests via the elector's published URL)
        self.api = CookApi(
            self.store, scheduler=None, config=self.sched_config,
            plugins=self.plugins, rate_limits=self.rate_limits,
            queue_limits=self.queue_limits,
            admins=conf.get("admins"), impersonators=conf.get("impersonators"),
            basic_auth_users=conf.get("basic_auth_users"),
            authenticators=build_authenticators(conf),
            cors_origins=conf.get("cors_origins"),
            ip_requests_per_minute=conf.get("ip_requests_per_minute"))
        self.server = ApiServer(self.api, host=self.host, port=self.port)
        self.server.start()
        self.node_url = f"http://{self.host}:{self.server.port}"
        self._node_id = f"{self.host}-{self.server.port}"
        # this process's span identity: every span recorded from here on
        # carries it, so the fleet-stitched Perfetto export renders this
        # node as its own process track (docs/OBSERVABILITY.md)
        from .utils import tracing
        tracing.set_process_identity(self._node_id)
        self.api.instance = self._node_id

        election = conf.get("election", {})
        if election.get("mode") == "k8s-lease":
            # distributed election over the cluster backend's Lease object
            # (the ZK/Curator slot; no extra infrastructure needed)
            from .cluster.k8s.real_api import RealKubernetesApi
            from .sched.election import LeaseLeaderElector
            api = RealKubernetesApi(
                namespace=election.get("namespace", "cook"),
                kubeconfig=election.get("kubeconfig"),
                base_url=election.get("base_url"),
                token=election.get("token"),
                verify_tls=election.get("verify_tls", True))
            self.elector = LeaseLeaderElector(
                api, identity=election.get("identity") or self.node_url,
                node_url=self.node_url,
                lease_name=election.get("lease_name",
                                        "cook-scheduler-leader"),
                duration_s=float(election.get("duration_seconds", 15.0)),
                on_leadership=self._on_leadership, on_loss=self._on_loss)
        else:
            election_dir = conf.get("election_dir") or self.data_dir
            if not election_dir:
                # no explicit election_dir and no data_dir: a
                # single-process election with nothing to share.  The
                # old fallback was the cwd, which littered
                # cook-leader.lock{,.epoch,.leader} into whatever
                # directory the process (or a test) started from; a
                # per-process tempdir keeps the same semantics with no
                # droppings
                import tempfile
                election_dir = tempfile.mkdtemp(prefix="cook-election-")
            self.elector = FileLeaderElector(
                str(Path(election_dir) / "cook-leader.lock"), self.node_url,
                on_leadership=self._on_leadership, on_loss=self._on_loss)
        self.api.elector = self.elector
        self.api.node_url = self.node_url
        if self.sched_config.fleet.enabled:
            # metrics federation + fleet trace fan-out share ONE
            # topology source: the election medium's candidate registry
            # (standbys publish url/ts there each position interval),
            # plus any statically-configured extra members
            from .sched.fleet import FleetScraper
            from .state.replication import known_members
            fleet_cfg = self.sched_config.fleet
            self.fleet = FleetScraper(
                fleet_cfg,
                members_fn=lambda: known_members(
                    self.elector, self._node_id, self.node_url,
                    leader=self.scheduler is not None,
                    extra=fleet_cfg.members))
            self.api.fleet = self.fleet
        if self.replication:
            if not conf.get("election_dir"):
                # without an explicit SHARED election dir the elector
                # falls back to the node-local data_dir: every node wins
                # its own private election and promotes — split brain
                # with zero mirroring, silently
                raise ValueError(
                    "replication requires an explicit election_dir "
                    "(a path shared by every scheduler host — the "
                    "election authority)")
            if not hasattr(self.elector, "lock_path"):
                # the replication address is published through the file
                # elector's directory; proceeding would mean standbys
                # never mirror while sync commits pass vacuously — the
                # operator believes in durability that does not exist
                raise ValueError(
                    "replication requires the file-based elector "
                    "(election_dir); the k8s-lease elector does not "
                    "publish a replication address")
            # build the native library NOW, outside any lock: the first
            # ReplicationFollower/Server construction otherwise triggers
            # a g++ compile (up to ~3 min) inside _lock, stalling a
            # concurrent _on_leadership promotion for the whole build
            from .state.replication import replication_available
            if not replication_available():
                raise ValueError(
                    "replication requires the native toolchain "
                    "(libcookrepl failed to build — see stderr)")
            self.api.repl_dir = self.data_dir  # /debug/replication panel
            self._repl_thread = threading.Thread(
                target=self._follow_leader_loop, daemon=True)
            self._repl_thread.start()
            if self.sched_config.serving.follower_reads:
                # promote the byte mirror to a LIVE read store: this
                # standby serves bounded-staleness GETs instead of
                # redirecting them (ROADMAP item 1's read fleet).
                # Subscribe via on_swap() AFTER the assignments — the
                # method invokes the callback immediately with the
                # view's store, so api.store is re-pointed even when
                # the mirror never re-bases again (a restarted standby
                # resuming an intact mirror by delta would otherwise
                # serve the frozen boot-time replay forever)
                from .state.read_replica import FollowerReadView
                self.read_view = FollowerReadView(
                    self.data_dir,
                    interval_s=self.sched_config.serving
                    .apply_interval_seconds)
                self.api.read_view = self.read_view
                self.read_view.on_swap(self._on_view_swap)
        elif self.data_dir and not self.shared_data:
            # single-node durable leader: the group-commit stage
            # amortizes fsync across concurrent REST writers
            self._maybe_enable_group_commit()
        if not self.api_only:
            self.elector.campaign()

    def _refuse_jax_factories(self) -> None:
        """Boot-time refusals of a factory in the JAX package, checked
        before any state is opened or any port binds."""
        conf = self.conf
        for spec in conf.get("clusters") or []:
            check_cluster_factory(spec["factory"])
        for path in conf.get("cluster_factory_allowlist") or []:
            check_cluster_factory(path)

    def _on_view_swap(self, store: Store) -> None:
        """The read view rebuilt its store (initial build / mirror
        re-base): the REST layer must serve the fresh object.  A
        promoted leader ignores late swaps — promotion owns the store."""
        if self.scheduler is None and self.read_view is not None:
            self.store = store
            self.api.store = store
            self.queue_limits.store = store

    def _maybe_enable_group_commit(self) -> None:
        sv = self.sched_config.serving
        if sv.group_commit and self.store is not None:
            self.store.enable_group_commit(
                window_ms=sv.group_commit_window_ms,
                max_batch=sv.group_commit_max_batch)

    def _on_leadership(self) -> None:
        """PROCESS-GLOBAL TRANSITION: this node becomes THE scheduler
        (reference: LeaderSelectorListener.takeLeadership mesos.clj:193)."""
        try:
            # Takeover BLOCKS under the daemon's role lock by design:
            # journal replay + fsync, peer catch-up, and one-time
            # native-library builds must all complete before this node
            # may serve — the lock IS the promotion barrier, and role
            # flips are rare (election cadence, not request cadence).
            # The transitive-blocking pragmas below acknowledge each
            # blocking subtree (docs/ANALYSIS.md).
            with self._lock:
                if self.replication:
                    # cs-lint: allow=lock-transitive-blocking
                    self._promote_replicated()
                elif self.shared_data and self.data_dir:
                    # take over the SHARED journal: claim the next epoch
                    # (fencing out the previous leader's late appends) and
                    # replay everything it committed, then serve queries
                    # from the fenced store
                    # cs-lint: allow=lock-transitive-blocking
                    self.store = Store.open(self.data_dir, epoch="auto")
                    self.api.store = self.store
                    self.queue_limits.store = self.store
                    self._maybe_enable_group_commit()
                clusters = build_clusters(self.conf.get("clusters", []),
                                          self.store,
                                          config=self.sched_config)
                # cs-lint: allow=lock-transitive-blocking
                self.scheduler = Scheduler(
                    self.store, self.sched_config, clusters,
                    rank_backend=self.rank_backend, plugins=self.plugins,
                    rate_limits=self.rate_limits, device=self.device)
                self.scheduler.run()
                self.api.scheduler = self.scheduler
                if self.fleet is not None:
                    # the leader's monitor sweep drives federation
                    # scrapes (followers run no Monitor; their /metrics
                    # and /debug/fleet nudge the self-gated scraper)
                    self.scheduler.monitor.fleet = self.fleet
        except Exception:
            # A failed takeover (bad cluster factory, store corruption...)
            # must NOT leave this node holding the leader lock with no
            # scheduler: exit nonzero so the supervisor restarts us and a
            # peer can win the election.
            import traceback
            traceback.print_exc()
            self.exit_code = 1
            self._done.set()

    def _promote_replicated(self) -> None:
        """Become the leader of a socket-replicated deployment —
        COORDINATED promotion (quorum-aware failover, docs/DEPLOY.md):

        1. stop mirroring, publish this node's final replication
           position, and hold a candidacy window so every live standby's
           position is on the table;
        2. rank candidates by ``(synced, epoch, offset)`` (Raft's vote
           comparison, Ongaro & Ousterhout §5.4.1); if a synced peer is
           strictly ahead, pull the missing delta from it over the
           framed-TCP carrier first (Viewstamped Replication's
           view-change state transfer) — winning the lock race must not
           mean losing the tail only the most-advanced mirror holds;
        3. re-open the local mirror FENCED at the election epoch, with
           the fence authority pointed at the SHARED election epoch file
           so a later successor's mint fences this leader's appends,
           checkpoints, and REST writes end-to-end;
        4. serve replication to the next generation — losers re-follow
           the address published here.

        The reference equivalent is the new leader re-reading the
        networked store (mesos.clj:153-328)."""
        from .state import replication as repl
        if self.read_view is not None:
            # the promoted store owns the directory now; the read view's
            # replica store is superseded by the authoritative open below
            self.read_view.stop()
            self.read_view = None
            self.api.read_view = None
        if self.repl_follower is not None:
            self.repl_follower.stop()
            self.repl_follower = None
            self.api.repl_follower = None
        cfg = self.repl_cfg
        # ---- candidacy window: collect peer positions, rank, catch up
        my_pos = repl.candidate_position(self.data_dir)
        self.elector.publish_candidate(self._node_id, dict(
            my_pos, url=self.node_url, ts=time.time()))
        if cfg.candidacy_window_seconds > 0:
            self._repl_stop.wait(cfg.candidacy_window_seconds)
        peers = {nid: pos
                 for nid, pos in self.elector.read_candidates().items()
                 if nid != self._node_id}
        ahead = repl.choose_successor(my_pos, peers,
                                      stale_s=cfg.position_stale_seconds)
        if ahead is not None and not my_pos.get("synced"):
            # a live SYNCED candidate holds state this node lacks (we
            # are genesis or mid-catch-up): winning the lock race must
            # not install an empty/partial authority over it
            raise RuntimeError(
                f"candidate {ahead[0]} is synced ahead of this "
                "unsynced node; yielding the takeover")
        if ahead is not None:
            peer_id, pos = ahead
            host, _, port = str(pos.get("catchup", "")).rpartition(":")
            print(f"cook_tpu: candidate {peer_id} is ahead "
                  f"(epoch {pos.get('epoch')}, offset "
                  f"{pos.get('offset')} > {my_pos.get('offset')}); "
                  f"pulling delta from {host}:{port}", flush=True)
            if not host or not repl.catch_up_from_peer(
                    host, int(port or 0), self.data_dir,
                    int(pos.get("offset") or 0),
                    timeout_s=cfg.catchup_timeout_seconds):
                # the better-synced peer is live but unreachable: failing
                # the takeover (exit nonzero, lock released) lets THAT
                # peer win with its longer log instead of us truncating
                # history it holds
                raise RuntimeError(
                    f"could not catch up from better-synced candidate "
                    f"{peer_id} at {pos.get('catchup')!r}; yielding the "
                    "takeover so it can win")
        # Promotion gate (see assert_promotable): refusing raises into
        # _on_leadership's failed-takeover path — exit nonzero, lock
        # released, a synced peer wins instead.
        repl.assert_promotable(self.data_dir)
        self.elector.clear_candidate(self._node_id)
        if self.standby_server is not None:
            # the real replication server replaces the catch-up server
            self.standby_server.stop()
            self.standby_server = None
        epoch = self.elector.epoch if self.elector is not None else None
        self.store = Store.open(self.data_dir,
                                epoch=epoch if epoch is not None
                                else "auto", shared=False)
        authority = self._epoch_authority_path()
        if authority is not None:
            # fence against the SHARED election epoch, not the local
            # claim file nobody else writes: a successor's mint must
            # reject this node's late appends/checkpoints
            self.store.attach_fence_authority(str(authority))
        self.api.store = self.store
        self.queue_limits.store = self.store
        self.repl_server = repl.ReplicationServer(
            self.data_dir, int(cfg.listen_port))
        self.repl_server.epoch = self.store._journal_epoch
        self.store.attach_replication(
            self.repl_server, sync=bool(cfg.sync),
            timeout_s=float(cfg.ack_timeout_seconds),
            min_followers=int(cfg.min_sync_followers))
        self.api.repl_server = self.repl_server  # surfaced in GET /info
        self.api.fence_guard = self._fence_superseded
        # write-path admission batching: one fsync + one ack round per
        # batch of concurrent REST submissions (docs/PERFORMANCE.md)
        self._maybe_enable_group_commit()
        host = cfg.advertise_host or self.host
        self._publish_repl_addr(f"{host}:{self.repl_server.port}",
                                self.store._journal_epoch)
        self._fence_thread = threading.Thread(
            target=self._fence_watch_loop, daemon=True,
            name="repl-fence-watch")
        self._fence_thread.start()
        print(f"cook_tpu: replication leader serving "
              f"{host}:{self.repl_server.port} "
              f"(epoch {self.store._journal_epoch})", flush=True)

    def _repl_addr_path(self) -> Optional[Path]:
        lock = getattr(self.elector, "lock_path", None)
        return Path(str(lock) + ".repl") if lock is not None else None

    def _epoch_authority_path(self) -> Optional[Path]:
        return getattr(self.elector, "epoch_path", None)

    def _publish_repl_addr(self, addr: str,
                           epoch: Optional[int] = None) -> None:
        path = self._repl_addr_path()
        if path is None:
            return
        from .utils.fsatomic import write_atomic_text
        write_atomic_text(str(path), json.dumps(
            {"addr": addr, "epoch": epoch}))

    def _read_repl_addr(self) -> "tuple[Optional[str], Optional[int]]":
        """(addr, leader epoch) from the published file; tolerates the
        pre-coordination plain ``host:port`` format."""
        path = self._repl_addr_path()
        try:
            text = path.read_text().strip() if path else ""
        except OSError:
            return None, None
        if not text:
            return None, None
        try:
            doc = json.loads(text)
            return doc.get("addr") or None, doc.get("epoch")
        except ValueError:
            return text, None  # legacy plain address

    def _fence_superseded(self) -> bool:
        """True once a successor minted a HIGHER election epoch than the
        one this leader's store is fenced at — the REST write path flips
        to 503/redirect immediately (journal fencing alone only rejects
        the next append; reads of a stale leader are the client's
        redirect problem, writes must never be accepted).

        The NOT-superseded verdict is cached for a short TTL: every
        write AND every token-bearing read consults this guard, and a
        per-request epoch-file read would tax exactly the hot path the
        read fleet exists to lighten.  A fenced verdict is never cached
        stale — once True it recomputes (and stays True, since epochs
        only grow)."""
        now = time.monotonic()
        cached = self._fence_cache
        if cached is not None and now - cached < 0.25:
            return False
        authority = self._epoch_authority_path()
        store = self.store
        if authority is None or store is None \
                or store._journal_epoch is None:
            return False
        from .utils.fsatomic import read_int_file
        current = read_int_file(str(authority))
        superseded = current is not None and current > store._journal_epoch
        if not superseded:
            self._fence_cache = now
        return superseded

    def _fence_watch_loop(self) -> None:
        """Leader-side watchdog: a partitioned-but-alive deposed leader
        must stop SERVING, not just fail its next append — fence the
        replication server (standbys re-point at the successor's
        published address) and exit nonzero for the supervisor."""
        while not self._repl_stop.is_set():
            if self.repl_server is None:
                return
            if self._fence_superseded():
                print("cook_tpu: superseded by a higher election epoch; "
                      "fencing and exiting", flush=True)
                try:
                    self.repl_server.fence()
                except Exception:
                    pass
                self._on_loss()
                return
            self._repl_stop.wait(1.0)

    def _follow_leader_loop(self) -> None:
        """Standby side: keep a native follower mirroring whichever node
        currently publishes the replication address (re-pointing on
        failover), until this node is elected itself.  Each tick also
        publishes this standby's replication position ``(epoch, offset,
        synced)`` plus a catch-up address into the election medium — the
        inputs coordinated promotion ranks candidates by."""
        from .state import replication as repl
        cfg = self.repl_cfg
        current = None
        last_publish = 0.0
        while not self._repl_stop.is_set():
            if self.elector is not None and self.elector.is_leader:
                return  # _on_leadership owns (and stopped) the follower
            addr, leader_epoch = self._read_repl_addr()
            if addr and addr != current:
                try:
                    with self._lock:
                        if self.elector is not None \
                                and self.elector.is_leader:
                            return
                        if self.repl_follower is not None:
                            self.repl_follower.stop()
                        host, _, port = addr.rpartition(":")
                        if leader_epoch is not None:
                            # ranking orders mirrors of DIFFERENT
                            # leaderships by this epoch; the fsync'd
                            # epoch write and the follower's one-time
                            # native build block under the role lock by
                            # design — re-follow is the same rare
                            # transition as promotion above
                            # cs-lint: allow=lock-transitive-blocking
                            repl.record_followed_epoch(self.data_dir,
                                                       leader_epoch)
                        # cs-lint: allow=lock-transitive-blocking
                        self.repl_follower = repl.ReplicationFollower(
                            host, int(port), self.data_dir)
                        self.api.repl_follower = self.repl_follower
                        current = addr
                except Exception as e:
                    # a transient native-build failure or malformed
                    # address must not kill the standby's only mirror
                    # thread for the life of the process (sync commits
                    # would pass vacuously with zero mirrors) — log and
                    # retry on the next tick
                    print(f"cook_tpu: replication follower for {addr!r} "
                          f"failed ({e}); retrying", file=sys.stderr)
            now = time.time()
            if self.elector is not None and self.elector.is_leader:
                return  # promotion raced this tick: no stale publishes
            if now - last_publish >= cfg.position_interval_seconds:
                last_publish = now
                try:
                    if self.standby_server is None:
                        # serve our own mirror for standby→standby
                        # catch-up (the winner pulls its missing delta
                        # from whichever candidate is most advanced)
                        self.standby_server = repl.ReplicationServer(
                            self.data_dir, 0)
                    pos = repl.candidate_position(self.data_dir)
                    pos.update(
                        catchup=f"{cfg.advertise_host or self.host}:"
                                f"{self.standby_server.port}",
                        url=self.node_url, ts=now)
                    self.elector.publish_candidate(self._node_id, pos)
                except Exception as e:
                    print(f"cook_tpu: candidate-position publish failed "
                          f"({e}); retrying", file=sys.stderr)
            self._repl_stop.wait(0.5)

    def _on_loss(self) -> None:
        """Leadership lost -> exit nonzero; the supervisor restarts us
        (mesos.clj:296-313)."""
        self.exit_code = 1
        self._done.set()

    # ------------------------------------------------------------- lifecycle
    def run(self) -> int:
        self.start()
        signal.signal(signal.SIGTERM, self._sigterm)
        signal.signal(signal.SIGINT, self._sigterm)
        role = " (federation router)" if self.federation is not None \
            else (" (api-only)" if self.api_only else " (campaigning)")
        print(f"cook_tpu: serving {self.node_url}" + role, flush=True)
        self._done.wait()
        self.shutdown()
        return self.exit_code

    def _sigterm(self, _signum, _frame) -> None:
        self.exit_code = 0
        self._done.set()

    def shutdown(self) -> None:
        if self.federation is not None:
            self.federation.stop()
            self.federation = None
            return
        with self._lock:
            if self.scheduler is not None:
                self.scheduler.shutdown()
                for cluster in self.scheduler.clusters.values():
                    shutdown = getattr(cluster, "shutdown", None)
                    if shutdown:
                        try:
                            shutdown()
                        except Exception:
                            pass
        self._repl_stop.set()
        if self.read_view is not None:
            self.read_view.stop()
            self.read_view = None
        if self._repl_thread is not None:
            self._repl_thread.join(timeout=2.0)
        if self._fence_thread is not None:
            self._fence_thread.join(timeout=2.0)
        if self.repl_follower is not None:
            self.repl_follower.stop()
            self.repl_follower = None
        if self.standby_server is not None:
            self.standby_server.stop()
            self.standby_server = None
        if self.elector is not None and self._node_id:
            try:
                self.elector.clear_candidate(self._node_id)
            except Exception:
                pass
        if self.elector is not None:
            # resign AFTER scheduler stop; suppress on_loss (clean exit)
            self.elector.on_loss = None
            self.elector.resign()
        if self.server is not None:
            self.server.stop()
        if self.repl_server is not None:
            # after the final checkpoint would be better still, but
            # followers full-resync on reconnect anyway; stop last so
            # late acks don't block scheduler shutdown above
            self.repl_server.stop()
            self.repl_server = None
        if self.store is not None and self.data_dir:
            try:
                self.store.checkpoint()
            except Exception:
                pass


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m cook_tpu_torch",
        description="cook_tpu_torch scheduler node (leader-elected)")
    parser.add_argument("--config", required=True,
                        help="JSON or TOML config file")
    parser.add_argument("--port", type=int, default=None,
                        help="override the configured REST port")
    parser.add_argument("--api-only", action="store_true", default=None,
                        help="serve the API without campaigning for leader")
    parser.add_argument("--device", default=None,
                        help="torch device the leader's scheduler runs on "
                             "(default: the config's \"device\", else "
                             "cuda; cpu runs the plain PyTorch path)")
    args = parser.parse_args(argv)
    conf = load_config_file(args.config)
    daemon = CookDaemon(conf, port_override=args.port,
                        api_only=args.api_only, device=args.device)
    return daemon.run()
