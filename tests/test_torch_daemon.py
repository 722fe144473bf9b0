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
- the port's own refusals (a federation section, ``partitions.count >
  1``, the k8s lease election, a cluster or optimizer factory in the
  JAX package) and the default device without a card each fail the
  boot before a port binds;
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
                   NotImplementedError, "item 11"),
    "partitions": (_sched(partitions={"count": 2}),
                   NotImplementedError, "item 11"),
    "k8s_lease": (lambda conf: conf.update(election={"mode": "k8s-lease"}),
                  NotImplementedError, "item 11"),
    "jax_optimizer_factory": (
        _sched(optimizer={"optimizer_create_fn":
                          "cook_tpu.sched.optimizer.GoodputOptimizer"}),
        ValueError, "cook_tpu_torch.sched.optimizer.GoodputOptimizer"),
    "jax_factory": (
        lambda conf: conf["clusters"][0].update(
            factory="cook_tpu.cluster.fake.factory"),
        ValueError, "cook_tpu_torch.cluster.fake.factory"),
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
    as it stands, but for what a CPU test cannot hold: the fake
    cluster and the file election in place of the remote backend and
    the k8s lease (queue 1, item 11), the compilation cache in a
    temporary directory, and the warmup at 1,024 tasks x 256 hosts (the
    file's 131,072 x 8,192 runs on the card, ``chip_smoke.py`` phase T).
    It leads, warms, and its optimizer cycles."""
    from cook_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", cuda_lib.BUILD_DIR)
    prod = json.load(open(os.path.join(
        REPO, "examples", "cook-production.json")))["scheduler"]
    prod["pipeline"].update(compilation_cache_dir=str(tmp_path / "cache"),
                            warmup_tasks=1024, warmup_hosts=256)
    conf = node_conf(tmp_path)
    conf["scheduler"] = {**prod, **conf["scheduler"]}
    d = P.daemon.CookDaemon(conf, device="cpu")
    d.start()
    try:
        sched = _wait_leader(d)
        assert sched._fused is not None
        assert sched.config.elastic.enabled
        deadline = time.time() + 60.0
        while sched.optimizer_cycler is None \
                or sched.optimizer_cycler.cycles < 1:
            assert time.time() < deadline, "the optimizer never cycled"
            time.sleep(0.05)
        assert sched.optimizer_cycler.last_error is None
        assert cuda_lib.BUILD_DIR == (tmp_path / "cache").resolve()
    finally:
        d.shutdown()


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


def test_in_process_nodes_launch_and_answer_equally(tmp_path):
    out = [drive(p, node_conf(tmp_path / p.root, p.root)) for p in SIDES]
    assert out[0][2] == out[1][2] and len(out[0][2]) == 20
    assert out[0][0] == out[1][0]
    assert sum(len(v) for step in out[0][0] for v in step.values()) > 0
    assert out[0][1] == out[1][1]
    assert all(status == 200 for status, _body in out[0][1])


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
