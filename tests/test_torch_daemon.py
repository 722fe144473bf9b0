"""The port's node (``cook_tpu_torch/daemon.py``, ``python -m
cook_tpu_torch``) against the JAX package's on the CPU.

- ``build_scheduler_config`` gives the same ``Config`` as the reference's
  on the specs of ``tests/test_daemon.py``, on the example configs'
  scheduler sections and on a TOML file, and raises the reference's type
  and message on each config error;
- the production example's scheduler section (the optimizer, the
  pipeline's warmup and compilation cache included) builds the
  reference's ``Config``, the optimizer's factories named in the port;
  a node boots with each of those planes, and with the whole section;
- a federation section beside cell state (the reference's refusal),
  the port's own refusals (a cluster or optimizer factory in the JAX
  package) and the default device without a card each fail the boot
  before a port binds;
- a node with ``partitions.count = 2`` and one fake cluster a pool
  routes, pins the entity path and places jobs as the reference node
  does; with replication, or with ``shard_pools`` that disagree with
  its partition map, it is refused with the reference's error;
- a node under ``election.mode = "k8s-lease"`` against the port's
  ``MockApiServer`` leads and holds the lease, and refuses replication
  with the reference's message; the production example boots with its
  own election section; a node whose cluster is the port's Kubernetes
  backend places jobs as pods, the reference node's pairs; and two
  node processes of each package over one mock take the lease over
  from a SIGKILLed leader alike;
- both packages' ``CookDaemon`` on one config, with every loop's interval
  at 3,600 s and a pinned store clock, take the same submissions through
  their own ``JobClient``; three hand-driven ``step_cycle``s must launch
  the same (job uuid, hostname) pairs, and ``/jobs``, ``/queue`` and
  ``/usage`` must answer equal bodies after the random ids are renamed
  (``test_torch_rest.Stack.norm``);
- a data dir the reference wrote boots the port's node, which serves the
  same bodies;
- the reference's subprocess scenarios (``tests/test_daemon.py``) run on
  ``python -m cook_tpu_torch --device cpu``, and the child imports
  neither ``jax`` nor ``cook_tpu``.

Every test starts and ends with both packages' process-wide planes in
their default state: the request log, the metrics registry, the circuit
breakers, the fault injector, the span identity and the storage
hygiene age that a ``"storage"`` section sets.
"""

import dataclasses
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from test_torch_driver import PORT, REF
from test_torch_monitor import fresh_request_log
from test_torch_rest import Stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pkg(m):
    ns = types.SimpleNamespace(m=m, root=m.root)
    for name, mod in (("daemon", "daemon"), ("client", "client"),
                      ("instrument", "rest.instrument"),
                      ("metrics", "utils.metrics"), ("retry", "utils.retry"),
                      ("faults", "utils.faults"),
                      ("tracing", "utils.tracing"),
                      ("integrity", "state.integrity")):
        setattr(ns, name, importlib.import_module(f"{m.root}.{mod}"))
    return ns


SIDES = (pkg(REF), pkg(PORT))
R, P = SIDES
HYGIENE = {p.root: p.integrity.HYGIENE_MIN_AGE_S for p in SIDES}


def fresh_planes():
    for p in SIDES:
        # a node's cycles leave host-clock durations in the package's
        # flight recorder, which the admission ladder reads as cycle_p99
        importlib.import_module(f"{p.root}.utils.flight").recorder.reset()
        fresh_request_log(p)
        p.metrics.registry.reset()
        p.retry.breakers.reset()
        p.faults.injector.clear()
        p.tracing.set_process_identity("cook")
        p.integrity.HYGIENE_MIN_AGE_S = HYGIENE[p.root]


@pytest.fixture(autouse=True)
def _fresh_planes():
    fresh_planes()
    yield
    fresh_planes()


# ------------------------------------------------ build_scheduler_config
SPECS = {
    "task_constraints_and_planes": {
        "task_constraints": {"docker_parameters_allowed": ["env"],
                             "max_ports": 4, "unknown_key_ignored": True},
        "default_containers": [
            {"pool-regex": "^p$", "container": {"image": "i:1"}},
            {"pool-regex": ".*"}],
        "valid_gpu_models": [
            {"pool-regex": "^gpu", "valid-models": ["a100"]}]},
    "clean_env_plane": {"default_envs": [
        {"pool-regex": ".*", "env": {"A": "line1\nline2"}}]},
    "matcher_knobs": {"default_matcher": {
        "auto_packing": "tight", "auto_large_j_threshold": 500}},
    "matcher_deprecated_backend": {"default_matcher": {
        "backend": "tpu-auction-pallas"}},
    "storage": {"storage": {"scrub_interval_seconds": 5,
                            "scrub_chunk_bytes": 65536,
                            "hygiene_min_age_seconds": 120}},
    "example_cook": json.load(open(os.path.join(
        REPO, "examples", "cook.json")))["scheduler"],
    # the production example less its optimizer section, whose factory
    # defaults name each package's own module
    # (test_production_example_builds_as_the_reference)
    "example_production": {
        k: v for k, v in json.load(open(os.path.join(
            REPO, "examples", "cook-production.json")))["scheduler"].items()
        if k != "optimizer"},
}

REFUSED_SPECS = {
    "env_wire_bytes": {"default_envs": [
        {"pool-regex": ".*", "env": {"A": "x\x1eB=y"}}]},
    "container_nul": {"default_containers": [
        {"pool-regex": ".*", "container": {"image": "img\x00"}}]},
    "bad_regex": {"default_envs": [{"pool-regex": "(", "env": {}}]},
    "auto_packing_value": {"default_matcher": {"auto_packing": "Tight"}},
    "backend_value": {"default_matcher": {"backend": "tpu-watrfill"}},
    "matcher_key": {"default_matcher": {"auto_paking": "tight"}},
    "storage_key": {"storage": {"scrub_chnk_bytes": 1}},
    "storage_bool": {"storage": {"scrub_enabled": "false"}},
    "storage_chunk": {"storage": {"scrub_chunk_bytes": 0}},
    "storage_repair": {"storage": {"repair_timeout_seconds": 0}},
    "slo_key": {"slo": {"queue_p99": 1}},
    "pipeline_key": {"pipeline": {"dept": 2}},
}


def _asdict(cfg):
    out = dataclasses.asdict(cfg)
    out.pop("_compiled", None)
    return out


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_build_scheduler_config_equal(name):
    out = []
    for p in SIDES:
        cfg = p.daemon.build_scheduler_config(json.loads(json.dumps(
            SPECS[name])))
        out.append((_asdict(cfg), p.integrity.HYGIENE_MIN_AGE_S))
    assert out[0] == out[1]


def test_build_scheduler_config_from_toml_equal(tmp_path):
    path = tmp_path / "cook.toml"
    path.write_text(
        'port = 0\n[scheduler]\nmatch_interval_seconds = 2.5\n'
        'cycle_mode = "fused"\n[scheduler.default_matcher]\n'
        'auto_packing = "tight"\n[scheduler.rebalancer]\n'
        'interval_seconds = 60.0\n')
    out = []
    for p in SIDES:
        conf = p.daemon.load_config_file(str(path))
        out.append((conf, _asdict(p.daemon.build_scheduler_config(
            conf["scheduler"]))))
    assert out[0] == out[1]
    assert out[0][1]["match_interval_seconds"] == 2.5


@pytest.mark.parametrize("name", sorted(REFUSED_SPECS))
def test_build_scheduler_config_refusals_equal(name):
    out = [_outcome(lambda: p.daemon.build_scheduler_config(
        json.loads(json.dumps(REFUSED_SPECS[name])))) for p in SIDES]
    assert out[0] == out[1]
    assert out[0][0] == "ValueError"


def test_production_example_builds_as_the_reference():
    """The whole production scheduler section, optimizer and pipeline
    included: the same Config, but for the optimizer's two factory
    paths, which name each package's module."""
    spec = json.load(open(os.path.join(
        REPO, "examples", "cook-production.json")))["scheduler"]
    out = [_asdict(p.daemon.build_scheduler_config(
        json.loads(json.dumps(spec)))) for p in SIDES]
    for k in ("host_feed_create_fn", "optimizer_create_fn"):
        ref = out[0]["optimizer"].pop(k)
        assert out[1]["optimizer"].pop(k) == \
            "cook_tpu_torch" + ref[len("cook_tpu"):]
    assert out[0] == out[1]
    assert out[1]["pipeline"]["warmup_tasks"] == 131072
    assert out[1]["optimizer"]["interval_seconds"] == 60.0


# ------------------------------------------------ refusals at boot
def node_conf(tmp_path, root="cook_tpu_torch", name="node", n_hosts=4,
              **extra):
    conf = {"host": "127.0.0.1", "port": 0,
            "data_dir": str(tmp_path / f"data-{name}"),
            "election_dir": str(tmp_path),
            "admins": ["admin"],
            "clusters": [{"factory": f"{root}.cluster.fake.factory",
                          "kwargs": {"name": "node-parity",
                                     "n_hosts": n_hosts}}],
            "scheduler": {"match_interval_seconds": 3600.0,
                          "rank_interval_seconds": 3600.0,
                          "monitor_interval_seconds": 3600.0,
                          "lingering_task_interval_seconds": 3600.0,
                          "rebalancer": {"interval_seconds": 3600.0}}}
    conf.update(extra)
    return conf


def _sched(**section):
    return lambda conf: conf["scheduler"].update(section)


REFUSALS = {
    "federation": (lambda conf: conf.update(federation={"cells": []}),
                   ValueError, "stateless front-door router; it cannot "
                   "also carry cell state"),
    "jax_optimizer_factory": (
        _sched(optimizer={"optimizer_create_fn":
                          "cook_tpu.sched.optimizer.GoodputOptimizer"}),
        ValueError, "cook_tpu_torch.sched.optimizer.GoodputOptimizer"),
    "jax_factory": (
        lambda conf: conf["clusters"][0].update(
            factory="cook_tpu.cluster.fake.factory"),
        ValueError, "cook_tpu_torch.cluster.fake.factory"),
    "jax_remote_factory": (
        lambda conf: conf["clusters"][0].update(
            factory="cook_tpu.cluster.remote.factory"),
        ValueError, "cook_tpu_torch.cluster.remote.factory"),
    "jax_k8s_factory": (
        lambda conf: conf["clusters"][0].update(
            factory="cook_tpu.cluster.k8s.compute_cluster.factory"),
        ValueError, "cook_tpu_torch.cluster.k8s.compute_cluster.factory"),
    "jax_factory_allowlisted": (
        lambda conf: conf.update(
            cluster_factory_allowlist=["cook_tpu.cluster.fake.factory"]),
        ValueError, "JAX package"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_port_refusals_fire_before_a_port_binds(name, tmp_path):
    edit, exc, match = REFUSALS[name]
    conf = node_conf(tmp_path)
    edit(conf)
    d = P.daemon.CookDaemon(conf, device="cpu")
    with pytest.raises(exc, match=match):
        d.start()
    assert d.server is None and d.elector is None
    assert "jax" not in d.__class__.__module__


@pytest.mark.parametrize("path", [
    "cook_tpu.cluster.fake.factory", "cook_tpu.cluster.remote.factory",
    "cook_tpu.cluster.k8s.compute_cluster.factory"])
def test_refused_factory_names_a_counterpart_that_imports(path):
    with pytest.raises(ValueError) as e:
        P.daemon.check_cluster_factory(path)
    counterpart = "cook_tpu_torch" + path[len("cook_tpu"):]
    assert repr(counterpart) in str(e.value)
    P.daemon.check_cluster_factory(counterpart)
    module, _, attr = counterpart.rpartition(".")
    assert callable(getattr(importlib.import_module(module), attr))


def _wait_leader(d, timeout=60.0):
    deadline = time.time() + timeout
    while d.scheduler is None:
        assert time.time() < deadline, "the node never led"
        assert d.exit_code == 0, "takeover failed"
        time.sleep(0.02)
    return d.scheduler


PORTED_PLANES = {
    "optimizer": _sched(optimizer={
        "interval_seconds": 3600.0,
        "optimizer_config": {"max_replay_jobs": 10,
                             "grow_budgets": [None],
                             "shrink_pressures": [0]}}),
    "warmup": _sched(pipeline={"warmup_tasks": 64, "warmup_hosts": 64}),
    "compilation_cache": _sched(pipeline={"compilation_cache_dir": "c"}),
}


@pytest.mark.parametrize("name", sorted(PORTED_PLANES))
def test_ported_planes_boot(name, tmp_path, monkeypatch):
    """A node takes each plane it refused before this port had it: the
    optimizer loop cycles at once and decides (one replay, the pool's
    decision, as the reference's); the warmup runs at the takeover; the
    compilation cache becomes the kernels' build directory."""
    from cook_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    conf = node_conf(tmp_path)
    PORTED_PLANES[name](conf)
    if name == "compilation_cache":
        conf["scheduler"]["pipeline"]["compilation_cache_dir"] = \
            str(tmp_path / "kernel-cache")
    d = P.daemon.CookDaemon(conf, device="cpu")
    d.start()
    try:
        sched = _wait_leader(d)
        if name == "optimizer":
            deadline = time.time() + 30.0
            while sched.optimizer_cycler is None \
                    or sched.optimizer_cycler.cycles < 1:
                assert time.time() < deadline, "the optimizer never cycled"
                time.sleep(0.02)
            assert sched.optimizer_cycler.last_error is None
        elif name == "warmup":
            assert sched._fused is not None
            assert sched.config.pipeline.warmup_tasks == 64
        else:
            assert cuda_lib.BUILD_DIR == (tmp_path / "kernel-cache").resolve()
    finally:
        d.shutdown()


def test_node_boots_on_the_production_scheduler_section(tmp_path,
                                                       monkeypatch):
    """The node on ``examples/cook-production.json``'s scheduler section
    and its ``"clusters"`` entry, which now goes through
    ``cook_tpu_torch.cluster.remote.factory`` (the file names the JAX
    package's module) with its endpoints pointed at two local
    ``cook_agentd`` agents named as the file's, and its ``progress_url``
    kept, and the file's own ``election`` section, the k8s lease, with
    its ``base_url`` pointed at the port's ``MockApiServer``.  What a
    CPU test cannot hold is replaced: the compilation cache in a
    temporary directory, and the warmup at 1,024 tasks x 256 hosts (the
    file's 131,072 x 8,192 runs on the card, ``chip_smoke.py`` phase T).
    It leads, holds the file's lease, warms, offers both agents, and its
    optimizer cycles."""
    from cook_tpu_torch.cluster.k8s.mock_apiserver import MockApiServer
    from cook_tpu_torch.cluster.remote import LocalAgentProcess
    from cook_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    example = json.load(open(os.path.join(
        REPO, "examples", "cook-production.json")))
    prod = example["scheduler"]
    prod["pipeline"].update(compilation_cache_dir=str(tmp_path / "cache"),
                            warmup_tasks=1024, warmup_hosts=256)
    [cluster] = example["clusters"]
    assert cluster["factory"] == "cook_tpu.cluster.remote.factory"
    cluster["factory"] = "cook_tpu_torch.cluster.remote.factory"
    agents = [LocalAgentProcess(h, workdir=str(tmp_path / "agents"))
              for h, _port in cluster["kwargs"]["endpoints"]]
    cluster["kwargs"]["endpoints"] = [["127.0.0.1", a.port] for a in agents]
    mock = MockApiServer().start()
    election = dict(example["election"], base_url=mock.base_url)
    assert election["mode"] == "k8s-lease"
    conf = node_conf(tmp_path)
    conf["clusters"] = [cluster]
    conf["election"] = election
    conf["scheduler"] = {**prod, **conf["scheduler"]}
    d = P.daemon.CookDaemon(conf, device="cpu")
    d.start()
    try:
        sched = _wait_leader(d)
        lease = d.elector.api.get_lease(election["lease_name"])
        assert (lease.holder, lease.holder_url, lease.transitions,
                lease.duration_s) == (d.node_url, d.node_url, 1,
                                      election["duration_seconds"])
        assert d.elector.api.namespace == election["namespace"]
        assert sched._fused is not None
        assert sched.config.elastic.enabled
        remote = sched.clusters["native-1"]
        assert type(remote).__module__ == "cook_tpu_torch.cluster.remote"
        assert remote.progress_url == "http://this-node:12321"
        assert sorted(o.hostname for o in remote.pending_offers(
            "default")) == ["node-a", "node-b"]
        deadline = time.time() + 60.0
        while sched.optimizer_cycler is None \
                or sched.optimizer_cycler.cycles < 1:
            assert time.time() < deadline, "the optimizer never cycled"
            time.sleep(0.05)
        assert sched.optimizer_cycler.last_error is None
        assert cuda_lib.BUILD_DIR == (tmp_path / "cache").resolve()
    finally:
        d.shutdown()
        for a in agents:
            a.stop()
        mock.close()


def test_default_device_without_a_card_fails_the_boot(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    d = P.daemon.CookDaemon(node_conf(tmp_path))
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        d.start()
    assert d.server is None and d.store is None
    # the config's "device" key is read when no argument is given
    d = P.daemon.CookDaemon(node_conf(tmp_path, device="cpu"))
    d.start()
    try:
        assert str(d.device) == "cpu"
    finally:
        d.shutdown()
    # an api-only node never leads, so it needs no card
    d = P.daemon.CookDaemon(node_conf(tmp_path, name="api"), api_only=True)
    d.start()
    try:
        assert d.server is not None and d.scheduler is None
    finally:
        d.shutdown()


# ------------------------------------------------ in-process parity
T0 = 1_700_000_000_000


def job_uuid(i):
    return f"00000000-0000-4000-8000-{i:012d}"


def boot(p, conf, timeout=60.0):
    kw = {"device": "cpu"} if p is P else {}
    d = p.daemon.CookDaemon(conf, **kw)
    d.start()
    deadline = time.time() + timeout
    while d.scheduler is None:
        assert time.time() < deadline, f"{p.root} node never led"
        assert d.exit_code == 0, f"{p.root} takeover failed"
        time.sleep(0.02)
    return d


def as_stack(p, d):
    """``test_torch_rest.Stack``'s requests, id renaming and ``step`` over
    a node's own server, store and scheduler."""
    s = Stack.__new__(Stack)
    s.p, s.m = p, p.m
    s.server, s.store, s.sched = d.server, d.store, d.scheduler
    s.seq, s.names = 0, {}
    return s


def submit(p, d, batches):
    c = p.client.JobClient(d.node_url, user="alice")
    c.throttle_retries = 0
    for b, users in enumerate(batches):
        for u, user in enumerate(users):
            c.user = user
            c.submit([{"uuid": job_uuid(100 * b + 10 * u + k),
                       "command": "true",
                       "cpus": 1.0 + (k % 3), "mem": 256.0 * (1 + k % 2),
                       "priority": 50 + k} for k in range(4)])


def bodies(s, uuids):
    return [s.call("GET", "/jobs", params={"uuid": uuids}, user="admin"),
            s.call("GET", "/queue", user="admin"),
            s.call("GET", "/usage", params={"user": "alice"}),
            s.call("GET", "/usage", params={"user": "bob"})]


def drive(p, conf, steps=3):
    d = boot(p, conf)
    try:
        now = [T0]
        d.store.clock = lambda: now[0]
        s = as_stack(p, d)
        submit(p, d, [["alice", "bob"], ["bob"], ["carol", "alice"]])
        launched = []
        for _ in range(steps):
            launched.append(s.step())
            now[0] += 1_000
        uuids = sorted(j.uuid for j in d.store.jobs_where(lambda j: True))
        return launched, bodies(s, uuids), uuids
    finally:
        d.shutdown()


def partitioned_conf(tmp_path, root, **partitions):
    """``node_conf`` with a partitions section and one fake cluster a pool:
    prod and research declared on p0 and p1, default hashed (to p1)."""
    conf = node_conf(tmp_path / root, root)
    conf["clusters"] = [{"factory": f"{root}.cluster.fake.factory",
                         "kwargs": {"name": f"part-{pool}", "n_hosts": 3,
                                    "pool": pool}}
                        for pool in PARTITION_POOLS]
    conf["scheduler"]["partitions"] = {
        "count": 2, "pools": {"prod": 0, "research": 1}, **partitions}
    return conf


PARTITION_POOLS = ("prod", "research", "default")


def drive_partitioned(p, conf, steps=3):
    d = boot(p, conf)
    try:
        now = [T0]
        d.store.clock = lambda: now[0]
        s = as_stack(p, d)
        for pool in PARTITION_POOLS:
            d.store.put_pool(p.m.Pool(name=pool))
        c = p.client.JobClient(d.node_url, user="alice")
        c.throttle_retries = 0
        for k in range(18):
            c.user = ("alice", "bob", "carol")[k % 3]
            c.submit([{"uuid": job_uuid(k), "command": "true",
                       "cpus": 1.0 + k % 4, "mem": 512.0 * (1 + k % 3),
                       "priority": 50 + k}], pool=PARTITION_POOLS[k % 3])
        tokens = sorted(e[0] for e in PARTITION_VECTOR[p.root](
            c.last_commit_offset))
        launched = []
        for _ in range(steps):
            launched.append(s.step())
            now[0] += 1_000
        uuids = sorted(j.uuid for j in d.store.jobs_where(lambda j: True))
        repl = s.call("GET", "/debug/replication", user="admin")[1]
        return {"pinned": (d.sched_config.columnar_index,
                           d.sched_config.resident_pack),
                "store": type(d.store).__name__,
                "dirs": sorted(os.listdir(conf["data_dir"])),
                "partition_of": [d.store._partition_of_job(u)
                                 for u in uuids],
                "tokens": tokens, "launched": launched,
                "partitions": [(x["partition"], x["declared_pools"],
                                x["journal_bytes"] > 0)
                               for x in repl["partitions"]],
                "bodies": bodies(s, uuids), "uuids": uuids}
    finally:
        d.shutdown()


PARTITION_VECTOR = {
    p.root: importlib.import_module(
        f"{p.root}.state.partition").parse_token_vector for p in SIDES}


def test_partitioned_nodes_route_and_place_equally(tmp_path):
    """A node with ``partitions.count = 2`` and one fake cluster a pool
    opens ``p0`` and ``p1``, pins the entity path, routes each pool's
    jobs to its partition's journal and places them: its (job uuid,
    hostname) pairs, bodies and ``/debug/replication`` partitions are
    the reference node's."""
    out = [drive_partitioned(p, partitioned_conf(tmp_path, p.root))
           for p in SIDES]
    assert out[1] == out[0]
    assert out[0]["pinned"] == (False, False)
    assert out[0]["store"] == "PartitionedStore"
    assert out[0]["dirs"] == ["p0", "p1", "partition_map.json"]
    assert set(out[0]["partition_of"]) == {0, 1}
    assert sum(len(v) for step in out[0]["launched"]
               for v in step.values()) == 18
    assert {pool for step in out[0]["launched"] for pool in step} \
        == set(PARTITION_POOLS)


def test_partitions_with_replication_refused_as_the_reference(tmp_path):
    out = []
    for p in SIDES:
        conf = partitioned_conf(tmp_path, p.root)
        conf["replication"] = {"listen_port": 0}
        d = p.daemon.CookDaemon(conf, **({"device": "cpu"} if p is P
                                         else {}))
        with pytest.raises(ValueError) as e:
            d.start()
        assert d.server is None and d.store is None
        out.append(str(e.value))
    assert out[1] == out[0] and "partitions" in out[0]


def test_misaligned_shard_pools_refused_naming_the_pool(tmp_path):
    out = []
    for p in SIDES:
        conf = partitioned_conf(tmp_path, p.root, shards=2,
                                shard_pools={"research": 0})
        d = p.daemon.CookDaemon(conf, **({"device": "cpu"} if p is P
                                         else {}))
        mesh = importlib.import_module(f"{p.root}.parallel.mesh")
        with pytest.raises(mesh.ShardAlignmentError) as e:
            d.start()
        assert d.server is None and d.store is None
        out.append(str(e.value))
    assert out[1] == out[0] and "'research'" in out[0]


def test_in_process_nodes_launch_and_answer_equally(tmp_path):
    out = [drive(p, node_conf(tmp_path / p.root, p.root)) for p in SIDES]
    assert out[0][2] == out[1][2] and len(out[0][2]) == 20
    assert out[0][0] == out[1][0]
    assert sum(len(v) for step in out[0][0] for v in step.values()) > 0
    assert out[0][1] == out[1][1]
    assert all(status == 200 for status, _body in out[0][1])


REMOTE_JOBS = [
    # (command, executor, max_retries)
    ("true", None, 1),
    ("echo out", None, 1),
    ("exit 3", None, 2),
    ('echo "progress: 40 half"; echo "progress: 90 nearly"', "cook", 1),
    ("echo 'progress: 15 begun'; exit 4", "cook", 1),
    ("true", "cook", 1),
    ("sleep 0.2", None, 1),
    ("echo \"$COOK_INSTANCE_NUM\"; exit 0", None, 1),
]


def remote_conf(tmp_path, root, agents):
    conf = node_conf(tmp_path / root, root)
    conf["clusters"] = [{"factory": f"{root}.cluster.remote.factory",
                         "kwargs": {"name": "node-remote",
                                    "endpoints": [["127.0.0.1", a.port]
                                                  for a in agents],
                                    "kill_grace_ms": 300}}]
    return conf


def drive_remote(p, tmp_path):
    """Two agents ``r-0``/``r-1`` of 3 cpus; REST submissions from two
    users (some under ``executor: "cook"``, one long job killed through
    REST); ``step_cycle`` by hand, each step waiting for its tasks to
    end.  The launched pairs by step, ``/usage`` while the long job runs,
    and ``/jobs`` and ``/usage`` once every task ended."""
    workdir = tmp_path / "agents"  # one path on both sides: the sandboxes
    remote = importlib.import_module(f"{p.root}.cluster.remote")
    agents = [remote.LocalAgentProcess(f"r-{i}", cpus=3.0, mem=4096.0,
                                       workdir=str(workdir))
              for i in range(2)]
    try:
        d = boot(p, remote_conf(tmp_path, p.root, agents))
        try:
            now = [T0]
            d.store.clock = lambda: now[0]
            cluster = d.scheduler.clusters["node-remote"]
            cluster.progress_url = d.node_url
            s = as_stack(p, d)
            c = p.client.JobClient(d.node_url, user="alice")
            c.throttle_retries = 0
            uuids = []
            for k, (cmd, executor, retries) in enumerate(REMOTE_JOBS):
                c.user = ("alice", "bob")[k % 2]
                spec = {"uuid": job_uuid(k), "command": cmd, "cpus": 1.0,
                        "mem": 128.0 + k, "priority": 50 + k,
                        "max_retries": retries}
                if executor:
                    spec["executor"] = executor
                uuids += c.submit([spec])
            c.user = "carol"
            long_job = c.submit([{"uuid": job_uuid(99),
                                  "command": "sleep 60", "cpus": 1.0,
                                  "mem": 64.0, "priority": 99}])[0]
            uuids.append(long_job)

            def tasks_ended():
                # every task but the long job's has ended, on the agents
                # and in the store (whose clock stamps the end time)
                long_task = d.store.job(long_job).instances[-1:]
                live = cluster.running_task_ids() or []
                stored = [i.task_id for _j, i in
                          d.store.running_instances()]
                return all(x in ([], long_task) for x in (live, stored))

            launched, usage_running = [], None
            for _ in range(6):
                launched.append(s.step())
                deadline = time.time() + 30
                while not tasks_ended():
                    assert time.time() < deadline, "tasks never ended"
                    time.sleep(0.05)
                now[0] += 1_000
                if usage_running is None and d.store.job(long_job).instances:
                    deadline = time.time() + 30
                    while d.store.instance(d.store.job(
                            long_job).instances[-1]).status.value \
                            != "running":
                        assert time.time() < deadline
                        time.sleep(0.05)
                    usage_running = [
                        s.call("GET", "/usage", params={"user": u})
                        for u in ("alice", "bob", "carol")]
            c.user = "carol"
            c.kill([long_job])
            deadline = time.time() + 30
            while cluster.running_task_ids():
                assert time.time() < deadline, "the kill never landed"
                time.sleep(0.05)
            # every executor job's progress frames have landed
            deadline = time.time() + 30
            want = {job_uuid(3): 90, job_uuid(4): 15}
            while any((d.store.instance(d.store.job(u).instances[-1])
                       .progress or 0) != v for u, v in want.items()):
                assert time.time() < deadline, "progress never landed"
                time.sleep(0.05)
            slave = {a.hostname: f"{a.hostname}:{a.port}" for a in agents}
            got = s.call("GET", "/jobs", params={"uuid": sorted(uuids)},
                         user="admin")
            text = json.dumps(got)
            for host, sid in slave.items():
                text = text.replace(sid, f"{host}:PORT")
            final_usage = [s.call("GET", "/usage", params={"user": u})
                           for u in ("alice", "bob", "carol")]
            return launched, usage_running, json.loads(text), final_usage
        finally:
            d.shutdown()
    finally:
        for a in agents:
            a.stop()


def test_remote_nodes_launch_real_processes_equally(tmp_path):
    """Both packages' nodes over their own remote backend and agents:
    equal launched pairs by step, equal ``/usage`` while a job runs and
    after, and equal ``/jobs`` bodies once every task ended (states,
    exit codes, progress, sandboxes)."""
    out = [drive_remote(p, tmp_path) for p in SIDES]
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    assert out[1][2] == out[0][2]
    assert out[1][3] == out[0][3]
    launched, _usage, (status, jobs), _final = out[0]
    assert status == 200
    assert sum(len(v) for step in launched for v in step.values()) >= 10
    by_uuid = {j["uuid"]: j for j in jobs}
    assert by_uuid[job_uuid(0)]["state"] == "success"
    assert by_uuid[job_uuid(2)]["state"] == "failed"
    assert [i["exit_code"] for i in by_uuid[job_uuid(2)]["instances"]] \
        == [3, 3]
    assert by_uuid[job_uuid(3)]["instances"][0]["progress"] == 90
    assert by_uuid[job_uuid(99)]["state"] == "failed"


def mock_of(p, n_nodes=0, cpus=4.0, mem=4096.0):
    """``p``'s own ``MockApiServer`` with nodes ``k-0`` ... over plain
    HTTP."""
    mock_mod = importlib.import_module(
        f"{p.root}.cluster.k8s.mock_apiserver")
    fake_mod = importlib.import_module(f"{p.root}.cluster.k8s.fake_api")
    mock = mock_mod.MockApiServer().start()
    for i in range(n_nodes):
        mock.fake.add_node(fake_mod.FakeNode(name=f"k-{i}", cpus=cpus,
                                             mem=mem))
    return mock


def lease_conf(mock, **extra):
    return {"mode": "k8s-lease", "base_url": mock.base_url,
            "lease_name": "cook-scheduler-leader", **extra}


def lease_of(p, mock, name="cook-scheduler-leader"):
    real = importlib.import_module(f"{p.root}.cluster.k8s.real_api")
    api = real.RealKubernetesApi(base_url=mock.base_url)
    return api.get_lease(name)


def test_node_leads_and_holds_the_k8s_lease(tmp_path):
    """Each package's node under ``election.mode = "k8s-lease"`` against
    its own package's ``MockApiServer``: it leads, the lease names it
    with the reference's transitions rule, its renewals move
    ``renewTime``, and a clean shutdown empties the holder."""
    def scenario(p):
        mock = mock_of(p)
        try:
            conf = node_conf(tmp_path / p.root, p.root,
                             election=lease_conf(mock,
                                                 duration_seconds=15))
            d = boot(p, conf)
            try:
                assert type(d.elector).__name__ == "LeaseLeaderElector"
                assert type(d.elector.api).__module__ == \
                    f"{p.root}.cluster.k8s.real_api"
                first = lease_of(p, mock)
                deadline = time.time() + 15
                while lease_of(p, mock).renew_time_s <= first.renew_time_s:
                    assert time.time() < deadline, "no renewal"
                    time.sleep(0.1)
                renewed = lease_of(p, mock)
                held = [(x.holder == d.node_url, x.holder_url == d.node_url,
                         x.transitions, x.duration_s)
                        for x in (first, renewed)]
                leader = d.elector.is_leader, d.elector.epoch
            finally:
                d.shutdown()
            after = lease_of(p, mock)
            return held, leader, (after.holder, after.holder_url,
                                  after.transitions)
        finally:
            mock.close()
    out = [scenario(p) for p in SIDES]
    assert out[1] == out[0]
    assert out[0] == ([(True, True, 1, 15.0)] * 2, (True, 1), ("", "", 1))


def test_k8s_lease_refuses_replication_as_the_reference(tmp_path):
    """Replication publishes its address through the file elector: a
    node under the k8s lease with a ``"replication"`` section fails its
    boot with the reference's error."""
    def scenario(p, tmp):
        mock = mock_of(p)
        d = None
        try:
            conf = node_conf(tmp / p.root, p.root,
                             election=lease_conf(mock),
                             replication={"listen_port": 0, "sync": True})
            kw = {"device": "cpu"} if p is P else {}
            d = p.daemon.CookDaemon(conf, **kw)
            got = _outcome(d.start)
            return got, d.scheduler is None
        finally:
            if d is not None and d.server is not None:
                d.server.stop()
            mock.close()
    out = [scenario(p, tmp_path) for p in SIDES]
    assert out[1] == out[0]
    assert out[0][0][0] == "ValueError"
    assert "file-based elector" in out[0][0][1]


K8S_NODES, K8S_JOBS = 3, 10


def k8s_conf(tmp_path, root, mock, **extra):
    conf = node_conf(tmp_path / root, root, **extra)
    conf["clusters"] = [{
        "factory": f"{root}.cluster.k8s.compute_cluster.factory",
        "kwargs": {"name": "node-k8s", "api_url": mock.base_url,
                   "rest_url": "http://this-node:12321"}}]
    return conf


def drive_k8s(p, tmp_path):
    """A node whose one cluster is ``p``'s Kubernetes backend over ``p``'s
    mock with 3 nodes of 4 cpus: REST submissions from two users, then
    three hand-driven ``step_cycle``s, the mock's kubelet stepping and
    finishing every running pod between them.  The launched pairs by
    step, the pods' (job, node) pairs on the mock, and ``/jobs`` once
    every job ended."""
    mock = mock_of(p, K8S_NODES)
    try:
        d = boot(p, k8s_conf(tmp_path, p.root, mock))
        try:
            now = [T0]
            d.store.clock = lambda: now[0]
            s = as_stack(p, d)
            c = p.client.JobClient(d.node_url, user="alice")
            c.throttle_retries = 0
            uuids = []
            for k in range(K8S_JOBS):
                c.user = ("alice", "bob")[k % 2]
                uuids += c.submit([{"uuid": job_uuid(k), "command": "true",
                                    "cpus": 1.0 + k % 3, "mem": 256.0,
                                    "priority": 50 + k,
                                    "max_retries": 2}])
            store = d.store

            def settled(want):
                insts = [store.instance(t) for u in uuids
                         for t in store.job(u).instances]
                return all(i.status.value in want for i in insts)

            launched, pods = [], []
            for step in range(3):
                launched.append(s.step())
                pods.append(sorted((x.labels.get("cook/job"), x.node_name)
                                   for x in mock.fake.pods()))
                mock.fake.step()
                mock.fake.step()
                deadline = time.time() + 30
                while not settled(("running", "success", "failed")):
                    assert time.time() < deadline, "pods never ran"
                    time.sleep(0.05)
                for x in mock.fake.pods():
                    if x.phase == "Running":
                        k = int(x.labels["cook/job"][-12:])
                        mock.fake.finish_pod(x.name,
                                             exit_code=3 if k == 4 else 0)
                # the controller writes a status back before it deletes
                # the pod: wait for both, so each step's pods are its own
                deadline = time.time() + 30
                while not settled(("success", "failed")) or any(
                        x.phase not in ("Pending", "Running")
                        for x in mock.fake.pods()):
                    assert time.time() < deadline, "pods never ended"
                    time.sleep(0.05)
                now[0] += 1_000
            body = s.call("GET", "/jobs", params={"uuid": sorted(uuids)},
                          user="admin")
            return launched, pods, body, sorted(
                x.name for x in mock.fake.pods())
        finally:
            d.shutdown()
    finally:
        mock.close()


def test_k8s_cluster_nodes_place_jobs_as_pods_equally(tmp_path):
    """Both packages' nodes over their own Kubernetes backend and mock:
    equal launched pairs by step, equal pods on the mock, and equal
    ``/jobs`` once every pod ended (one job's pods exit 3: it retries
    once and fails)."""
    out = [drive_k8s(p, tmp_path) for p in SIDES]
    assert out[1] == out[0]
    launched, pods, (status, jobs), left = out[0]
    assert status == 200 and left == []
    assert sum(len(v) for step in launched for v in step.values()) \
        == K8S_JOBS + 1
    assert {x[1] for step in pods for x in step} <= {
        f"k-{i}" for i in range(K8S_NODES)}
    by_uuid = {j["uuid"]: j for j in jobs}
    assert [i["exit_code"] for i in by_uuid[job_uuid(4)]["instances"]] \
        == [3, 3]
    assert by_uuid[job_uuid(4)]["state"] == "failed"
    assert all(j["state"] == "success" for u, j in by_uuid.items()
               if u != job_uuid(4))


def test_reference_data_dir_boots_the_port_node(tmp_path):
    """The reference node writes its journal (submissions, launches) and
    shuts down; the port's node boots on the same data dir and serves
    the same ``/jobs`` and ``/usage`` bodies."""
    conf = node_conf(tmp_path, "cook_tpu")
    launched, ref_bodies, uuids = drive(R, conf)
    assert sum(len(v) for step in launched for v in step.values()) > 0
    conf = node_conf(tmp_path, "cook_tpu_torch")
    d = boot(P, conf)
    try:
        d.store.clock = lambda: T0 + 3_000
        got = bodies(as_stack(P, d), uuids)
    finally:
        d.shutdown()
    # /queue is the ranker's published queue: a node that has just taken
    # over has not ranked yet, so only the store's own bodies compare
    del got[1], ref_bodies[1]
    assert got == ref_bodies


def test_replicated_standby_promotes_with_every_job(tmp_path):
    """Socket replication between two port nodes in process: the standby
    mirrors and serves follower reads, and promotes with every job when
    the leader shuts down."""
    from cook_tpu_torch.state.replication import replication_available
    if not replication_available():
        pytest.skip("C++ toolchain unavailable")

    def conf(name):
        c = node_conf(tmp_path, name=name, n_hosts=2)
        c["replication"] = {"listen_port": 0, "sync": True,
                            "candidacy_window_seconds": 0.2,
                            "position_interval_seconds": 0.1}
        c["scheduler"]["serving"] = {"follower_reads": True}
        return c

    def wait_for(pred, timeout=20.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        return bool(pred())

    a = boot(P, conf("a"))
    b = None
    try:
        b = P.daemon.CookDaemon(conf("b"), device="cpu")
        b.start()
        assert wait_for(lambda: a.repl_server is not None
                        and a.repl_server.synced_follower_count >= 1)
        client = P.client.JobClient(a.node_url, user="alice")
        uuids = client.submit([{"command": "sleep 999", "cpus": 1,
                                "mem": 64} for _ in range(3)])
        panel = client.debug_replication()
        assert panel["role"] == "leader" and panel["epoch"] == 1
        assert b.read_view is not None
        assert wait_for(lambda: b.read_view.offset
                        >= a.store.commit_offset())
        reader = P.client.JobClient(b.node_url, user="alice")
        reader.last_commit_offset = client.last_commit_offset
        assert {j["uuid"] for j in reader.query(uuids)} == set(uuids)
        standby_panel = reader.debug_replication()
        assert standby_panel["position"]["synced"]
        a.shutdown()
        assert wait_for(lambda: b.scheduler is not None, timeout=30)
        client_b = P.client.JobClient(b.node_url, user="alice")
        assert {j["uuid"] for j in client_b.query(uuids)} == set(uuids)
        assert client_b.debug_replication()["epoch"] == 2
        assert str(b.scheduler.device) == "cpu"
    finally:
        if b is not None:
            b.shutdown()
        a.shutdown()


# ------------------------------------------------ subprocess scenarios
def write_config(tmp_path, node, election_dir, **extra):
    conf = {
        "host": "127.0.0.1", "port": 0,
        "data_dir": str(tmp_path / f"data-{node}"),
        "election_dir": str(election_dir),
        "admins": ["admin"],
        "clusters": [{"factory": "cook_tpu_torch.cluster.fake.factory",
                      "kwargs": {"name": f"fake-{node}", "n_hosts": 2}}],
        "scheduler": {"match_interval_seconds": 0.1,
                      "rank_interval_seconds": 0.1},
    }
    conf.update(extra)
    path = tmp_path / f"cook-{node}.json"
    path.write_text(json.dumps(conf))
    return str(path)


def spawn(config_path, *extra, device="cpu", python=()):
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    env.pop("JAX_PLATFORMS", None)
    argv = [sys.executable, *python, "-m", "cook_tpu_torch", "--config",
            config_path, *extra]
    if device is not None:
        argv += ["--device", device]
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO,
                            env=env)


def wait_serving(proc, timeout=60):
    """The node URL from the banner; the lines read on the way are kept
    in ``proc.seen``."""
    proc.seen = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        proc.seen.append(line)
        if not line:
            if proc.poll() is not None:
                raise AssertionError(
                    f"node exited rc={proc.returncode} before serving")
            time.sleep(0.05)
            continue
        if line.startswith("cook_tpu: serving "):
            return line.split()[2]
    raise AssertionError("node did not start serving in time")


def get(url, timeout=5, redirect=True):
    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **kw):
            return None
    opener = urllib.request.build_opener() if redirect else \
        urllib.request.build_opener(NoRedirect)
    req = urllib.request.Request(url, headers={"X-Cook-User": "admin"})
    return opener.open(req, timeout=timeout)


def post(url, payload=None, timeout=5):
    req = urllib.request.Request(
        url, data=json.dumps(payload or {}).encode(),
        headers={"X-Cook-User": "admin", "Content-Type": "application/json"},
        method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def wait_leader(url, timeout=30) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with get(f"{url}/info") as r:
                if json.load(r).get("leader"):
                    return True
        except (urllib.error.URLError, OSError):
            pass
        time.sleep(0.2)
    return False


def wait_state(url, uuid, want, timeout=30):
    deadline = time.time() + timeout
    state = None
    while time.time() < deadline:
        with get(f"{url}/jobs/{uuid}") as r:
            state = json.load(r)["status"]
        if state == want:
            return state
        time.sleep(0.1)
    return state


@pytest.fixture
def procs():
    running = []
    yield running
    for p in running:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10)


def test_no_card_exits_nonzero_before_serving(tmp_path, procs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = spawn(write_config(tmp_path, "a", tmp_path), device=None)
    procs.append(p)
    out, _ = p.communicate(timeout=60)
    assert p.returncode != 0
    assert "device 'cuda'" in out and "serving" not in out


def test_lifecycle_submit_and_clean_exit(tmp_path, procs):
    """The reference's lifecycle scenario; the child runs under ``-X
    importtime``, whose report must name neither ``jax`` nor a module
    of ``cook_tpu``."""
    p = spawn(write_config(tmp_path, "a", tmp_path),
              python=("-X", "importtime"))
    procs.append(p)
    url = wait_serving(p)
    assert wait_leader(url), "single node must take leadership"
    uuid = "00000000-0000-0000-0000-00000000da3e"
    with post(f"{url}/jobs", {"jobs": [{
            "uuid": uuid, "command": "true", "cpus": 1.0,
            "mem": 64.0}]}) as r:
        assert r.status in (200, 201)
    assert wait_state(url, uuid, "running") == "running"
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=30)
    assert p.returncode == 0
    lines = "".join(p.seen).splitlines() + out.splitlines()
    imported = [line.rsplit("|", 1)[-1].strip() for line in lines
                if line.startswith("import time:")]
    assert "cook_tpu_torch.daemon" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("jax", "jaxlib", "cook_tpu")]


def test_ha_failover_and_shutdown_leader(tmp_path, procs):
    pa = spawn(write_config(tmp_path, "a", tmp_path))
    procs.append(pa)
    url_a = wait_serving(pa)
    assert wait_leader(url_a)
    pb = spawn(write_config(tmp_path, "b", tmp_path))
    procs.append(pb)
    url_b = wait_serving(pb)
    deadline = time.time() + 10
    status, location = None, ""
    while time.time() < deadline:
        try:
            with get(f"{url_b}/queue", redirect=False) as r:
                status = r.status
        except urllib.error.HTTPError as e:
            status, location = e.code, e.headers.get("Location", "")
            if status == 307:
                break
        time.sleep(0.2)
    assert status == 307 and location.startswith(url_a)
    pa.kill()
    pa.wait(timeout=10)
    assert wait_leader(url_b), "follower did not take over"
    try:
        with post(f"{url_b}/shutdown-leader") as r:
            assert r.status == 200
    except (urllib.error.URLError, OSError):
        pass
    assert pb.wait(timeout=30) == 1


def test_api_only_never_leads(tmp_path, procs):
    pa = spawn(write_config(tmp_path, "a", tmp_path))
    procs.append(pa)
    url_a = wait_serving(pa)
    assert wait_leader(url_a)
    # an api-only node never leads, so the default device needs no card
    pb = spawn(write_config(tmp_path, "b", tmp_path), "--api-only",
               device=None)
    procs.append(pb)
    url_b = wait_serving(pb)
    with get(f"{url_b}/info") as r:
        assert json.load(r).get("leader") is False
    pa.kill()
    pa.wait(timeout=10)
    time.sleep(1.5)
    with get(f"{url_b}/info") as r:
        assert json.load(r).get("leader") is False
    assert pb.poll() is None


def test_kill9_mid_flight_restart_resumes(tmp_path, procs):
    election = tmp_path / "election"
    election.mkdir()
    cfg = write_config(tmp_path, "crash", election)
    p1 = spawn(cfg)
    procs.append(p1)
    url = wait_serving(p1)
    assert wait_leader(url)
    with post(f"{url}/jobs", {"jobs": [
            {"command": "sleep 999", "cpus": 1, "mem": 64}
            for _ in range(4)]}) as r:
        uuids = json.load(r)["jobs"]
    assert wait_state(url, uuids[0], "running") == "running"
    os.kill(p1.pid, signal.SIGKILL)
    p1.wait(timeout=10)
    p2 = spawn(cfg)
    procs.append(p2)
    url2 = wait_serving(p2)
    assert wait_leader(url2)
    for uuid in uuids:
        with get(f"{url2}/jobs/{uuid}") as r:
            assert json.load(r)["state"] in ("waiting", "running")
    with post(f"{url2}/jobs", {"jobs": [
            {"command": "sleep 999", "cpus": 1, "mem": 64}]}) as r:
        [fresh] = json.load(r)["jobs"]
    assert wait_state(url2, fresh, "running") == "running"


TAKEOVER_JOBS = 6


def spawn_node(root, config_path):
    """``python -m <root> --config ...``: the port's on the CPU, the
    reference's with JAX on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    argv = [sys.executable, "-m", root, "--config", config_path]
    if root == "cook_tpu_torch":
        env.pop("JAX_PLATFORMS", None)
        argv += ["--device", "cpu"]
    else:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=REPO,
                            env=env)


def takeover(p, tmp_path, procs):
    """Two nodes of ``p`` as processes over one shared data dir, each
    under the k8s lease (2 s) on ``p``'s own mock: ``node-a`` leads and
    ``node-b`` stands by; the leader's fake cluster is drained and
    ``TAKEOVER_JOBS`` jobs wait; ``node-a`` is SIGKILLed.  Who holds the
    lease and at which transition, the shared journal's epoch after
    each takeover, who leads by ``/info``, and the jobs' final states."""
    mock = mock_of(p)
    try:
        home = tmp_path / p.root
        home.mkdir()
        shared = home / "shared"

        def config(name):
            conf = {"host": "127.0.0.1", "port": 0,
                    "shared_data_dir": str(shared), "admins": ["admin"],
                    "election": lease_conf(mock, identity=f"node-{name}",
                                           duration_seconds=2),
                    "clusters": [{
                        "factory": f"{p.root}.cluster.fake.factory",
                        "kwargs": {"name": "node-fake", "n_hosts": 2,
                                   "default_task_duration_ms": 200,
                                   "auto_advance": True}}],
                    "scheduler": {"match_interval_seconds": 0.1,
                                  "rank_interval_seconds": 0.1}}
            path = home / f"cook-{name}.json"
            path.write_text(json.dumps(conf))
            return str(path)

        def lease():
            x = lease_of(p, mock)
            return (x.holder, x.transitions) if x is not None else None

        def epoch():
            return (shared / "epoch").read_text().strip()

        a = spawn_node(p.root, config("a"))
        procs.append(a)
        url_a = wait_serving(a, timeout=120)
        assert wait_leader(url_a, timeout=60), f"{p.root}: a never led"
        out = {"a_leads": (lease(), epoch())}
        b = spawn_node(p.root, config("b"))
        procs.append(b)
        url_b = wait_serving(b, timeout=120)
        with get(f"{url_b}/info") as r:
            out["b_standby"] = json.load(r)["leader"]
        with post(f"{url_a}/compute-clusters/node-fake",
                  {"state": "draining"}) as r:
            assert r.status in (200, 201)
        uuids = [job_uuid(500 + k) for k in range(TAKEOVER_JOBS)]
        with post(f"{url_a}/jobs", {"jobs": [
                {"uuid": u, "command": "true", "cpus": 1.0, "mem": 64.0}
                for u in uuids]}) as r:
            assert r.status in (200, 201)
        time.sleep(0.5)
        out["waiting"] = [wait_state(url_a, u, "waiting", timeout=5)
                          for u in uuids]
        a.send_signal(signal.SIGKILL)
        a.wait(timeout=10)
        assert wait_leader(url_b, timeout=60), f"{p.root}: b never led"
        out["b_leads"] = (lease(), epoch())
        out["final"] = [wait_state(url_b, u, "completed", timeout=60)
                        for u in uuids]
        b.send_signal(signal.SIGTERM)
        b.wait(timeout=30)
        out["b_exit"] = b.returncode
        out["released"] = lease()
        return out
    finally:
        mock.close()


def test_k8s_lease_takeover_after_sigkill_as_the_reference(tmp_path, procs):
    """Each package's node pair over its own mock: the standby leads once
    the SIGKILLed leader's lease expires and places every waiting job;
    who leads, the lease transitions, the journal epochs and the final
    job states are equal for the two packages."""
    out = [takeover(p, tmp_path, procs) for p in SIDES]
    assert out[1] == out[0]
    assert out[0]["a_leads"] == (("node-a", 1), "1")
    assert out[0]["b_standby"] is False
    assert out[0]["waiting"] == ["waiting"] * TAKEOVER_JOBS
    assert out[0]["b_leads"] == (("node-b", 2), "2")
    assert out[0]["final"] == ["completed"] * TAKEOVER_JOBS
    assert out[0]["released"] == ("", 2)
