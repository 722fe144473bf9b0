"""The port's remote backend (``cook_tpu_torch/cluster/remote.py``) against
the JAX package's (``cook_tpu/cluster/remote.py``) on the CPU.

Every case of ``tests/test_remote_cluster.py`` runs on both packages,
each over its own ``cook_agentd`` (``LocalAgentProcess``: the reference's
built into ``native/build/``, the port's into ``build/native/``, both
from the repo-root ``native/transport.cpp``) with equal hostnames and
capacities, and compares what a caller sees: each task's status sequence
(state, reason code, exit code), the offers (available, capacity, task
count), ``running_task_ids``, the sandbox and port writeback, the
``\\x1e``/NUL refusal, ``compile_fetch_prelude``'s string and
``_task_command``'s command and environment, equal but for the
executor's module name.  One difference is held as such: the port's
callbacks come from one delivery thread, the reference's from each
agent's pump thread.  The cases that schedule run the port's
``Scheduler(device="cpu")`` and give the reference's launched (job uuid,
hostname) pairs and final job states.  The multi-user REST case of
``tests/test_multi_user.py`` runs on both too.

The C++ toolchain (g++) is on every machine these tests run on, so no
case skips for it.
"""

import importlib
import json
import os
import subprocess
import threading
import time
import types
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def side(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("remote", "cluster.remote"), ("base", "cluster.base"),
                      ("state", "state"), ("schema", "state.schema"),
                      ("config", "config"), ("sched", "sched"),
                      ("rest", "rest"), ("client", "client"),
                      ("retry", "utils.retry"), ("faults", "utils.faults")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    ns.kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
    return ns


SIDES = (side("cook_tpu"), side("cook_tpu_torch"))
R, P = SIDES


def fresh_planes():
    # launches go through each package's process-wide breaker of the
    # cluster's name, and the fault point is process-wide too; a
    # scheduler's cycles leave host-clock durations in the package's
    # flight recorder, which the admission ladder reads as cycle_p99
    for p in SIDES:
        p.retry.breakers.reset()
        p.faults.injector.clear()
        importlib.import_module(f"{p.root}.utils.flight").recorder.reset()


@pytest.fixture(autouse=True)
def _fresh_planes():
    fresh_planes()
    yield
    fresh_planes()


def both(scenario, *args, **kw):
    """``scenario(p, *args, **kw)`` on the reference, then on the port;
    asserts the two observations equal and returns the reference's."""
    out = [scenario(p, *args, **kw) for p in SIDES]
    assert out[1] == out[0]
    return out[0]


def wait_for(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


class Agents:
    """One package's agents, started from its own ``LocalAgentProcess``
    under ``workdir`` (a sandbox is ``workdir/hostname/task_id``)."""

    def __init__(self, p, workdir, *specs):
        self.procs = []
        try:
            for hostname, kw in specs:
                self.procs.append(p.remote.LocalAgentProcess(
                    hostname, workdir=str(workdir), **kw))
        except BaseException:
            self.stop()
            raise

    @property
    def endpoints(self):
        return [("127.0.0.1", a.port) for a in self.procs]

    def stop(self):
        for a in self.procs:
            a.stop()


def recorder(out):
    """A status callback appending (task, state, reason, exit code,
    hostname) with each package's enum as its value."""
    def cb(tid, st, rc, **kw):
        out.append((tid, st.value, rc, kw.get("exit_code"),
                    kw.get("hostname")))
    return cb


def seq_of(updates, tid):
    return [u[1:] for u in updates if u[0] == tid]


def offers_of(cluster, pool="default"):
    return sorted((o.hostname, o.available.cpus, o.available.mem,
                   o.capacity.cpus, o.capacity.mem, o.task_count, o.pool,
                   o.cluster, o.id)
                  for o in cluster.pending_offers(pool))


def scheduler(p, store, cluster):
    cfg = p.config.Config()
    cfg.default_matcher.backend = "cpu"
    return p.sched.Scheduler(store, cfg, [cluster], rank_backend="cpu",
                             **p.kw)


def uid(i):
    return f"00000000-0000-4000-8000-{i:012d}"


def pairs_of(store, res):
    return sorted((store.instance(t).job_uuid, store.instance(t).hostname)
                  for r in res.values() for t in r.launched_task_ids)


def final_states(store, uuids):
    """Each job's state and its instances' (status, reason, exit code)."""
    out = {}
    for u in uuids:
        job = store.job(u)
        insts = [store.instance(t) for t in job.instances]
        out[u] = (job.state.value,
                  [(i.status.value, i.reason_code, i.exit_code,
                    i.hostname, bool(i.sandbox_directory)) for i in insts])
    return out


# --------------------------------------------------------- pure functions
URIS = {
    "none": [],
    "blank": [{"value": "  "}],
    "local_executable": [{"value": "/opt/tools/run.sh", "executable": True}],
    "file_archive": [{"value": "file:///data/set.tar", "extract": True}],
    "http": [{"value": "https://example.org/a/b.bin"}],
    "quoted": [{"value": "/p with space/it's.sh", "executable": True,
                "extract": True}, {"value": "http://h/x y"}],
}


@pytest.mark.parametrize("name", sorted(URIS))
def test_compile_fetch_prelude_equal(name):
    out = [p.remote.compile_fetch_prelude(URIS[name]) for p in SIDES]
    assert out[0] == out[1]
    assert bool(out[0]) == (name not in ("none", "blank"))


def _command_world(p):
    """A store whose jobs cover every branch of ``_task_command``."""
    S = p.state
    store = S.Store()
    res = p.schema.Resources
    jobs = [
        S.Job(uuid=uid(1), user="u", command="echo plain", max_retries=3,
              resources=res(cpus=1.0, mem=128.0)),
        S.Job(uuid=uid(2), user="u", command="echo grouped", group=uid(90),
              resources=res(cpus=2.0, mem=256.0, gpus=1.0)),
        S.Job(uuid=uid(3), user="u", command="echo 'progress: 5'",
              executor="cook", progress_regex_string=r"step (\d+)",
              progress_output_file="prog.txt",
              env={"PYTHONPATH": "/job/lib"},
              uris=[{"value": "/opt/t.sh", "executable": True}],
              resources=res(cpus=1.5, mem=64.0)),
        S.Job(uuid=uid(4), user="u", command="true", executor="cook",
              resources=res(cpus=1.0, mem=32.0)),
        S.Job(uuid=uid(5), user="u", command="",
              resources=res(cpus=1.0, mem=32.0)),
    ]
    store.create_jobs(jobs, groups=[S.Group(uuid=uid(90), name="g")])
    # a second attempt: COOK_INSTANCE_NUM counts the prior one
    store.launch_instance(uid(1), "t1-0", hostname="h", compute_cluster="c")
    store.update_instance_status(
        "t1-0", p.schema.InstanceStatus.FAILED,
        reason_code=p.schema.Reasons.NON_ZERO_EXIT.code)
    store.launch_instance(uid(1), "t1-1", hostname="h", compute_cluster="c")
    store.launch_instance(uid(3), "t3-0", hostname="h", compute_cluster="c")
    return store


@pytest.mark.parametrize("progress_url", ["", "http://node:12321"])
def test_task_command_equal_but_for_the_executor_module(progress_url):
    out = []
    for p in SIDES:
        store = _command_world(p)
        cluster = p.remote.RemoteComputeCluster(
            "c", [], store=store, progress_url=progress_url,
            executor_python="/usr/bin/python3")
        got = {}
        for i in (1, 2, 3, 4, 5, 6):
            spec = p.base.LaunchSpec(
                task_id=f"t{i}", job_uuid=uid(i), hostname="h",
                slave_id="", resources=p.schema.Resources(cpus=1, mem=1))
            got[i] = cluster._task_command(spec)
        # no store: the bare transport runs "true"
        got["bare"] = p.remote.RemoteComputeCluster("c", [])._task_command(
            spec)
        out.append(got)
    ref, port = out
    for k, (cmd, env) in ref.items():
        if cmd is not None:
            cmd = cmd.replace("-m cook_tpu.agent.executor ",
                              "-m cook_tpu_torch.agent.executor ")
        assert port[k] == (cmd, env), k
    assert ref[5] == (None, {}) and ref[6] == (None, {})
    assert "cook_tpu_torch.agent.executor" in port[3][0]
    assert port[3][1]["PYTHONPATH"] == REPO + ":/job/lib"
    assert port[1][1]["COOK_INSTANCE_NUM"] == "1"
    assert port[2][1]["COOK_JOB_GROUP_UUID"] == uid(90)
    assert port[2][1]["COOK_JOB_GPUS"] == "1.0"
    assert ("COOK_PROGRESS_URL" in port[3][1]) == bool(progress_url)


def test_factory_and_build_paths():
    def scenario(p):
        c = p.remote.factory(store=None, name="n1",
                             endpoints=[["127.0.0.1", "7070"]], pool="gpu",
                             kill_grace_ms=250, progress_url="http://x")
        return (c.name, c.pool, c._endpoints, c.kill_grace_ms,
                c.progress_url, c.executor_python, c.executor_pythonpath,
                c.running_task_ids(), c.pending_offers("gpu"))
    got = both(scenario)
    assert got[2] == [("127.0.0.1", 7070)] and got[6] == REPO
    # each package builds the one source into its own directory
    assert P.remote._SRC == R.remote._SRC
    assert str(P.remote._LIB) == os.path.join(REPO, "build", "native",
                                              "libcooktransport.so")
    assert str(P.remote._AGENTD) == os.path.join(REPO, "build", "native",
                                                 "cook_agentd")
    assert P.remote.native_available() and R.remote.native_available()


def test_no_toolchain_raises_and_never_runs_elsewhere(monkeypatch, tmp_path):
    """Without the toolchain ``native_available()`` is False, and an
    ``AgentConnection`` or a ``LocalAgentProcess`` raises."""
    def scenario(p):
        monkeypatch.setattr(p.remote, "_load", lambda: None)
        monkeypatch.setattr(p.remote, "build_agentd", lambda: None)
        out = [p.remote.native_available()]
        for make in (lambda: p.remote.AgentConnection("127.0.0.1", 1),
                     lambda: p.remote.LocalAgentProcess(
                         "x", workdir=str(tmp_path))):
            try:
                make()
                out.append("constructed")
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        return out
    assert both(scenario)[0] is False


# --------------------------------------------------------- the connection
def test_registered_info(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root,
                        ("nodeA", {"cpus": 4.0, "mem": 4096.0}))
        try:
            conn = p.remote.AgentConnection(*agents.endpoints[0])
            got = (conn.hostname, conn.capacity.cpus, conn.capacity.mem,
                   conn.capacity.gpus, conn.running_at_connect,
                   conn.agent_id.split(":")[0], conn.connected)
            conn.close()
            return got + (conn.connected,)
        finally:
            agents.stop()
    assert both(scenario)[0] == "nodeA"


def _events(conn, n, timeout_ms=3000):
    out = []
    while len(out) < n:
        ev = conn.poll(timeout_ms=timeout_ms)
        assert ev is not None, f"timed out, got {out}"
        out.append(ev)
    return out


def test_launch_status_stream(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        try:
            conn = p.remote.AgentConnection(*agents.endpoints[0])
            assert conn.launch("t-ok", "echo out; echo err >&2; exit 0",
                               1, 64)
            evs = _events(conn, 2)
            sandbox = evs[1][4]
            conn.close()
            return ([e[:4] for e in evs],
                    os.path.relpath(sandbox, tmp_path / p.root),
                    open(sandbox + "/stdout").read(),
                    open(sandbox + "/stderr").read())
        finally:
            agents.stop()
    got = both(scenario)
    assert got[0][1] == ["STATUS", "t-ok", "finished", "0"]


def test_launch_refuses_wire_delimiter_in_fields(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        try:
            conn = p.remote.AgentConnection(*agents.endpoints[0])
            out = [
                conn.launch("t-evil-param", "true", 1, 64, image="img",
                            params=[{"key": "env",
                                     "value": "A=B\x1eprivileged="}]),
                conn.launch("t-evil-env", "true", 1, 64,
                            env={"GOOD": "x\x1eBAD=y"}),
                conn.launch("t-evil-vol", "true", 1, 64, image="img",
                            volumes=["/a:/b\x1e/etc:/host-etc"]),
                conn.launch("t-evil-nul", "true", 1, 64, env={"A": "x\x00"}),
                conn.launch("t-evil-cmd", "echo hi\x00", 1, 64),
                conn.launch("t-evil-id\x1e", "true", 1, 64),
                conn.launch("t-clean", "true", 1, 64, env={"GOOD": "val"})]
            # only the clean launch reaches the agent
            out.append([e[1:3] for e in _events(conn, 2)])
            conn.close()
            return out
        finally:
            agents.stop()
    assert both(scenario)[:7] == [False] * 6 + [True]


def test_nonzero_exit_is_failed(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        try:
            conn = p.remote.AgentConnection(*agents.endpoints[0])
            conn.launch("t-bad", "exit 3", 1, 64)
            got = [e[:4] for e in _events(conn, 2)]
            conn.close()
            return got
        finally:
            agents.stop()
    assert both(scenario)[1] == ["STATUS", "t-bad", "failed", "3"]


def test_kill_escalation(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        try:
            conn = p.remote.AgentConnection(*agents.endpoints[0])
            conn.launch(
                "t-stuck",
                "trap '' TERM; touch ready; while true; do sleep 0.2; done",
                1, 64)
            ev = conn.poll(timeout_ms=3000)
            first = ev[:3]
            assert wait_for(lambda: os.path.exists(ev[4] + "/ready"))
            conn.kill("t-stuck", grace_ms=300)
            terminal = None
            for _ in range(40):
                e = conn.poll(timeout_ms=500)
                if e and e[1] == "t-stuck" and e[2] != "running":
                    terminal = e[:4]
                    break
            conn.close()
            return first, terminal
        finally:
            agents.stop()
    assert both(scenario)[1] == ["STATUS", "t-stuck", "killed",
                                 str(128 + 9)]


def test_reconcile_replays_state(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        try:
            c1 = p.remote.AgentConnection(*agents.endpoints[0])
            c1.launch("t-live", "sleep 30", 1, 64)
            assert c1.poll(timeout_ms=3000)[2] == "running"
            c2 = p.remote.AgentConnection(*agents.endpoints[0])
            at_connect = c2.running_at_connect
            c2.reconcile()
            seen = []
            while True:
                ev = c2.poll(timeout_ms=3000)
                assert ev is not None
                if ev[0] == "RECONCILE_DONE":
                    break
                seen.append(ev[:3])
            c1.kill("t-live", grace_ms=100)
            c1.close()
            c2.close()
            return at_connect, seen
        finally:
            agents.stop()
    at_connect, seen = both(scenario)
    assert at_connect == ["t-live"]
    assert ["STATUS", "t-live", "running"] in seen


# --------------------------------------------------------- the cluster
def _spec(p, tid, job_uuid, host, cpus=1.0, mem=64.0, **kw):
    return p.base.LaunchSpec(task_id=tid, job_uuid=job_uuid, hostname=host,
                             slave_id="",
                             resources=p.schema.Resources(cpus=cpus, mem=mem),
                             **kw)


def test_offers_track_consumption(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}), ("nodeB", {}))
        updates = []
        cluster = p.remote.RemoteComputeCluster(
            "remote-1", agents.endpoints, kill_grace_ms=300)
        try:
            cluster.initialize(recorder(updates))
            got = [offers_of(cluster), offers_of(cluster, "other")]
            cluster.launch_tasks("default", [
                _spec(p, "t-c1", "j1", "nodeA", cpus=1.5, mem=512.0),
                _spec(p, "t-c2", "j2", "nodeB", cpus=0.5, mem=100.0)])
            got += [offers_of(cluster), sorted(cluster.running_task_ids())]
            assert wait_for(lambda: sum(u[1] == "success"
                                        for u in updates) == 2)
            got += [offers_of(cluster), cluster.running_task_ids(),
                    seq_of(updates, "t-c1"), seq_of(updates, "t-c2")]
            return got
        finally:
            cluster.shutdown()
            agents.stop()
    got = both(scenario)
    assert [o[1] for o in got[2]] == [2.5, 3.5]
    assert [o[1] for o in got[4]] == [4.0, 4.0]


def test_callbacks_come_from_one_delivery_thread(tmp_path):
    """The port delivers every agent's events on one thread, in arrival
    order; the reference calls back on each agent's pump thread."""
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}), ("nodeB", {}))
        names, updates = [], []
        rec = recorder(updates)

        def cb(*a, **kw):
            names.append(threading.current_thread().name)
            rec(*a, **kw)
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints)
        try:
            cluster.initialize(cb)
            cluster.launch_tasks("default", [
                _spec(p, f"t-{i}", f"j{i}", ("nodeA", "nodeB")[i % 2])
                for i in range(6)])
            assert wait_for(lambda: len(updates) == 12)
            return (sorted(set(names)),
                    {f"t-{i}": seq_of(updates, f"t-{i}") for i in range(6)})
        finally:
            cluster.shutdown()
            agents.stop()
    (ref_names, ref_seqs), (port_names, port_seqs) = [
        scenario(p) for p in SIDES]
    assert port_seqs == ref_seqs
    assert ref_names == ["agent-pump-nodeA", "agent-pump-nodeB"]
    assert port_names == ["agent-delivery-remote-1"]


def test_agent_loss_is_node_lost(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeB", {}))
        store = p.state.Store()
        job = p.state.Job(uuid=uid(1), user="alice", command="sleep 60",
                          pool="default",
                          resources=p.schema.Resources(cpus=1.0, mem=64.0))
        store.create_jobs([job])
        updates = []
        cluster = p.remote.RemoteComputeCluster(
            "remote-1", agents.endpoints, store=store, kill_grace_ms=300)
        try:
            cluster.initialize(recorder(updates))
            cluster.launch_tasks("default", [
                _spec(p, "t-lost", job.uuid, "nodeB")])
            assert wait_for(lambda: ("t-lost", "running")
                            in [u[:2] for u in updates])
            agents.procs[0].proc.kill()  # the node dies hard
            assert wait_for(lambda: len(seq_of(updates, "t-lost")) == 2)
            return (seq_of(updates, "t-lost"), offers_of(cluster),
                    cluster.running_task_ids())
        finally:
            cluster.shutdown()
            agents.stop()
    seq, offers, running = both(scenario)
    assert seq[1][:2] == ("failed", R.schema.Reasons.NODE_LOST.code)
    assert offers == [] and running == []


def test_unreachable_endpoint_does_not_block_healthy(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        cluster = p.remote.RemoteComputeCluster(
            "remote-1", [("127.0.0.1", 1)] + agents.endpoints)
        try:
            cluster.initialize(lambda *a, **k: None)
            got = (offers_of(cluster), cluster.running_task_ids())
            # the endpoint connects later: the enumeration is complete
            cluster._failed_endpoints.clear()
            return got + (cluster.running_task_ids(),)
        finally:
            cluster.shutdown()
            agents.stop()
    offers, running, later = both(scenario)
    assert [o[0] for o in offers] == ["nodeA"]
    assert running is None and later == []


def test_restart_adopts_live_tasks(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        store = p.state.Store()
        job = p.state.Job(uuid=uid(1), user="a", command="sleep 30",
                          pool="default",
                          resources=p.schema.Resources(cpus=2.0, mem=256.0))
        store.create_jobs([job])
        updates = []
        c1 = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                           store=store)
        c2 = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                           store=store)
        try:
            c1.initialize(recorder(updates))
            store.launch_instance(job.uuid, "t-adopt", hostname="nodeA",
                                  compute_cluster="remote-1")
            c1.launch_tasks("default", [p.base.LaunchSpec(
                task_id="t-adopt", job_uuid=job.uuid, hostname="nodeA",
                slave_id="", resources=job.resources)])
            assert wait_for(lambda: ("t-adopt", "running")
                            in [u[:2] for u in updates])
            c2.initialize(lambda *a, **k: None)
            got = (offers_of(c2), c2.running_task_ids())
            c1.kill_task("t-adopt")
            assert wait_for(lambda: len(seq_of(updates, "t-adopt")) == 2)
            return got + (seq_of(updates, "t-adopt"),)
        finally:
            c1.shutdown()
            c2.shutdown()
            agents.stop()
    offers, running, seq = both(scenario)
    assert offers[0][1] == 2.0 and offers[0][5] == 1
    assert running == ["t-adopt"]
    assert seq[1][:2] == ("failed", R.schema.Reasons.KILLED_BY_USER.code)


def test_store_reconcile_marks_unknown_tasks_node_lost(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        store = p.state.Store()
        job = p.state.Job(uuid=uid(1), user="a", command="sleep 30",
                          pool="default",
                          resources=p.schema.Resources(cpus=1.0, mem=64.0))
        store.create_jobs([job])
        store.launch_instance(job.uuid, "t-ghost", hostname="gone-node",
                              compute_cluster="remote-1")
        store.update_instance_status("t-ghost",
                                     p.schema.InstanceStatus.RUNNING)
        # another cluster's live task is not this backend's to reconcile
        other = p.state.Job(uuid=uid(2), user="a", command="sleep 30",
                            pool="default",
                            resources=p.schema.Resources(cpus=1.0, mem=64.0))
        store.create_jobs([other])
        store.launch_instance(other.uuid, "t-other", hostname="x",
                              compute_cluster="remote-2")
        store.update_instance_status("t-other",
                                     p.schema.InstanceStatus.RUNNING)
        updates = []
        cluster = p.remote.RemoteComputeCluster(
            "remote-1", agents.endpoints, store=store)
        try:
            cluster.initialize(recorder(updates))
            return updates
        finally:
            cluster.shutdown()
            agents.stop()
    assert both(scenario) == [("t-ghost", "failed",
                               R.schema.Reasons.NODE_LOST.code, None,
                               "gone-node")]


def test_missing_job_command_fails_launch(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        updates = []
        cluster = p.remote.RemoteComputeCluster(
            "remote-1", agents.endpoints, store=p.state.Store())
        try:
            cluster.initialize(recorder(updates))
            cluster.launch_tasks("default", [
                _spec(p, "t-nocmd", "no-such-job", "nodeA"),
                _spec(p, "t-nohost", "no-such-job", "nodeZ")])
            return updates, offers_of(cluster), cluster.running_task_ids()
        finally:
            cluster.shutdown()
            agents.stop()
    updates, offers, running = both(scenario)
    code = R.schema.Reasons.CONTAINER_LAUNCH_FAILED.code
    assert [u[:3] for u in updates] == [("t-nocmd", "failed", code),
                                        ("t-nohost", "failed", code)]
    assert offers[0][1] == 4.0 and running == []


def test_injected_rpc_fault_fails_the_launch_and_counts(tmp_path):
    """The ``remote.rpc`` fault point: the RPC never lands, the task is
    CONTAINER_LAUNCH_FAILED, and the cluster's breaker counts a failure
    (a success once the point is spent)."""
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        updates = []
        cluster = p.remote.RemoteComputeCluster("remote-rpc",
                                                agents.endpoints)
        p.faults.injector.arm("remote.rpc", schedule=[0, 1])
        try:
            cluster.initialize(recorder(updates))
            cluster.launch_tasks("default", [
                _spec(p, f"t-{i}", f"j{i}", "nodeA") for i in range(3)])
            breaker = p.retry.breakers.get("remote-rpc").to_doc()
            assert wait_for(lambda: len(seq_of(updates, "t-2")) == 2)
            return ([seq_of(updates, f"t-{i}") for i in range(3)],
                    {k: breaker[k] for k in ("state", "failures")
                     if k in breaker})
        finally:
            cluster.shutdown()
            agents.stop()
    seqs, _breaker = both(scenario)
    code = R.schema.Reasons.CONTAINER_LAUNCH_FAILED.code
    assert seqs[0] == seqs[1] == [("failed", code, None, "nodeA")]
    assert [s[0] for s in seqs[2]] == ["running", "success"]


def test_late_running_replay_after_terminal_is_dropped(tmp_path):
    """``_on_status``'s terminal memory: a replayed ``running`` after a
    terminal status neither re-adopts the task nor reaches the
    callback."""
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        updates = []
        cluster = p.remote.RemoteComputeCluster("remote-1",
                                                agents.endpoints)
        try:
            cluster.initialize(recorder(updates))
            conn = cluster._agents["nodeA"]
            cluster._on_status(conn, "t-x", "finished", 0, "")
            cluster._on_status(conn, "t-x", "running", 0, "")
            cluster._on_status(conn, "t-y", "running", 0, "")
            cluster._on_status(conn, "t-z", "memlimit", 137, "")
            cluster._on_status(conn, "t-w", "killed", 143, "")
            return updates, cluster.running_task_ids(), offers_of(cluster)
        finally:
            cluster.shutdown()
            agents.stop()
    updates, running, _offers = both(scenario)
    assert [u[:2] for u in updates] == [("t-x", "success"),
                                        ("t-y", "running"),
                                        ("t-z", "failed"), ("t-w", "failed")]
    assert running == ["t-y"]


# --------------------------------------------------------- the scheduler
def test_end_to_end_real_processes(tmp_path):
    """submit -> rank -> match -> native launch -> real /bin/sh -> status
    -> completed, with sandbox writeback; the port's pump and delivery
    threads never enter torch."""
    entered = []

    def watch(frame, event, arg):
        if event == "call" and threading.current_thread().name.startswith(
                ("agent-pump-", "agent-delivery-")):
            mod = frame.f_globals.get("__name__", "")
            if mod.split(".")[0] == "torch":
                entered.append(mod)

    def scenario(p):
        agents = Agents(p, tmp_path / "agents", ("nodeA", {}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        if p is P:
            threading.setprofile(watch)
        try:
            sched = scheduler(p, store, cluster)
            marker = tmp_path / f"ran-{p.root}.txt"
            good = p.state.Job(uuid=uid(1), user="alice",
                               command=f"echo done > {marker}",
                               pool="default",
                               resources=p.schema.Resources(cpus=1.0,
                                                            mem=128.0))
            bad = p.state.Job(uuid=uid(2), user="bob", command="exit 7",
                              pool="default", max_retries=1,
                              resources=p.schema.Resources(cpus=1.0,
                                                           mem=128.0))
            store.create_jobs([good, bad])
            sched.step_rank()
            res = sched.step_match()
            pairs = pairs_of(store, res)

            def settled():
                sched.flush_status_updates()
                return all(store.job(u).state.value == "completed"
                           for u in (uid(1), uid(2)))
            assert wait_for(settled)
            return (pairs, final_states(store, [uid(1), uid(2)]),
                    marker.read_text())
        finally:
            threading.setprofile(None)
            cluster.shutdown()
            agents.stop()
    pairs, states, text = both(scenario)
    assert pairs == [(uid(1), "nodeA"), (uid(2), "nodeA")]
    assert states[uid(2)][1][0][:3] == ("failed",
                                        R.schema.Reasons.NON_ZERO_EXIT.code,
                                        7)
    assert text == "done\n"
    assert entered == []


def test_kill_running_job(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster(
            "remote-1", agents.endpoints, store=store, kill_grace_ms=300)
        try:
            sched = scheduler(p, store, cluster)
            job = p.state.Job(uuid=uid(1), user="alice", command="sleep 60",
                              pool="default",
                              resources=p.schema.Resources(cpus=1.0,
                                                           mem=128.0))
            store.create_jobs([job])
            sched.step_rank()
            res = sched.step_match()
            pairs = pairs_of(store, res)
            [tid] = res["default"].launched_task_ids

            def running():
                sched.flush_status_updates()
                return store.instance(tid).status.value == "running"
            assert wait_for(running)
            store.kill_job(job.uuid)

            def dead():
                sched.flush_status_updates()
                return (store.job(job.uuid).state.value == "completed"
                        and cluster.running_task_ids() == [])
            assert wait_for(dead)
            return pairs, final_states(store, [uid(1)])
        finally:
            cluster.shutdown()
            agents.stop()
    pairs, states = both(scenario)
    assert states[uid(1)][1][0][:2] == (
        "failed", R.schema.Reasons.KILLED_BY_USER.code)


def _run_jobs(p, store, cluster, jobs, timeout=15.0):
    sched = scheduler(p, store, cluster)
    store.create_jobs(jobs)
    sched.step_rank()
    res = sched.step_match()

    def done():
        sched.flush_status_updates()
        return all(store.job(j.uuid).state.value == "completed"
                   for j in jobs)
    assert wait_for(done, timeout=timeout)
    return pairs_of(store, res), final_states(store, [j.uuid for j in jobs])


def test_ports_assigned_and_recorded(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root,
                        ("nodeP", {"ports_begin": 21000, "ports_end": 21010}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        out = tmp_path / f"ports-{p.root}.txt"
        probe = tmp_path / f"env-{p.root}.txt"
        res = p.schema.Resources
        try:
            jobs = [p.state.Job(
                        uuid=uid(1), user="alice", ports=2,
                        command=f'echo "$PORT0 $PORT1 $COOK_PORT0" > {out}',
                        env={"MY_VAR": "my-value"}, pool="default",
                        resources=res(cpus=1.0, mem=64.0)),
                    p.state.Job(
                        uuid=uid(2), user="alice",
                        command=f'echo "$MY_VAR" > {probe}',
                        env={"MY_VAR": "my-value"}, pool="default",
                        resources=res(cpus=1.0, mem=64.0))]
            pairs, states = _run_jobs(p, store, cluster, jobs)
            inst = store.instance(store.job(uid(1)).instances[-1])
            return (pairs, states, sorted(inst.ports),
                    sorted(int(x) for x in out.read_text().split()[:2]),
                    int(out.read_text().split()[2]) == inst.ports[0],
                    probe.read_text())
        finally:
            cluster.shutdown()
            agents.stop()
    got = both(scenario)
    assert len(got[2]) == 2 and all(21000 <= x < 21010 for x in got[2])
    assert got[3] == got[2] and got[4] and got[5] == "my-value\n"


def test_port_exhaustion_fails_launch(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root,
                        ("nodeQ", {"ports_begin": 22000, "ports_end": 22001}))
        try:
            conn = p.remote.AgentConnection(*agents.endpoints[0])
            ok = conn.launch("t-ports", "sleep 5", 1, 64, port_count=2)
            ev = conn.poll(timeout_ms=3000)
            conn.close()
            return ok, ev[:3]
        finally:
            agents.stop()
    assert both(scenario) == (True, ["STATUS", "t-ports", "failed"])


def test_ports_released_after_terminal(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root,
                        ("nodeR", {"ports_begin": 23000, "ports_end": 23001}))
        try:
            conn = p.remote.AgentConnection(*agents.endpoints[0])
            seen = []
            for tid in ("t-a", "t-b"):
                assert conn.launch(tid, "true", 1, 64, port_count=1)
                evs = _events(conn, 2)
                seen.append([[e[1], e[2], e[3], e[5]] for e in evs])
            conn.close()
            return seen
        finally:
            agents.stop()
    seen = both(scenario)
    assert seen[1][0] == ["t-b", "running", "0", "23000"]


def _fake_runtime(tmp_path, name):
    record = tmp_path / f"{name}-args.txt"
    fake_rt = tmp_path / f"{name}-docker"
    # records its argv, then execs the trailing `/bin/sh -c <cmd>`
    fake_rt.write_text(
        "#!/bin/sh\n"
        f'echo "$@" > {record}\n'
        'while [ "$1" != "/bin/sh" ] && [ $# -gt 0 ]; do shift; done\n'
        'exec "$@"\n')
    fake_rt.chmod(0o755)
    return record, fake_rt


def test_container_launch_uses_runtime(tmp_path):
    def scenario(p):
        record, rt = _fake_runtime(tmp_path, p.root)
        agents = Agents(p, tmp_path / "agents",
                        ("nodeC", {"container_runtime": str(rt)}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        # one path on both sides: the runtime's recorded argv names it
        out = tmp_path / "cout.txt"
        out.unlink(missing_ok=True)
        try:
            pairs, states = _run_jobs(p, store, cluster, [p.state.Job(
                uuid=uid(1), user="alice",
                command=f"echo from-container > {out}",
                container={"image": "busybox:1.36",
                           "volumes": ["/data:/mnt/data"]},
                pool="default",
                resources=p.schema.Resources(cpus=1.0, mem=64.0))])
            args = record.read_text()
            # the recorded argv names the per-task sandbox: keep the part
            # after the runtime's own verb, less the random task id
            task = store.job(uid(1)).instances[-1]
            return (pairs, states, out.read_text(),
                    args.replace(task, "TASK"))
        finally:
            cluster.shutdown()
            agents.stop()
    pairs, states, text, args = both(scenario)
    assert text == "from-container\n"
    assert "run" in args and "busybox:1.36" in args
    assert "/data:/mnt/data" in args


def test_no_runtime_runs_command_directly(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeD", {}))
        try:
            conn = p.remote.AgentConnection(*agents.endpoints[0])
            assert conn.launch("t-c", "true", 1, 64, image="busybox")
            got = [e[1:4] for e in _events(conn, 2)]
            conn.close()
            return got
        finally:
            agents.stop()
    assert both(scenario)[1] == ["t-c", "finished", "0"]


def test_local_uri_copied_executable_and_archive_extracted(tmp_path):
    tool = tmp_path / "tool.sh"
    tool.write_text("#!/bin/sh\necho tool-ran\n")
    archive = tmp_path / "data.tar"
    (tmp_path / "payload.txt").write_text("payload\n")
    subprocess.run(["tar", "-cf", str(archive), "-C", str(tmp_path),
                    "payload.txt"], check=True)

    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        out = tmp_path / f"uri-{p.root}.txt"
        try:
            pairs, states = _run_jobs(p, store, cluster, [p.state.Job(
                uuid=uid(1), user="alice",
                command=f"./tool.sh > {out}; cat payload.txt >> {out}",
                uris=[{"value": str(tool), "executable": True},
                      {"value": f"file://{archive}", "extract": True}],
                pool="default",
                resources=p.schema.Resources(cpus=1.0, mem=64.0))])
            return pairs, states, out.read_text()
        finally:
            cluster.shutdown()
            agents.stop()
    pairs, states, text = both(scenario)
    assert states[uid(1)][1][-1][0] == "success"
    assert text == "tool-ran\npayload\n"


def test_missing_uri_fails_task_before_command(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        marker = tmp_path / f"never-{p.root}.txt"
        try:
            pairs, states = _run_jobs(p, store, cluster, [p.state.Job(
                uuid=uid(1), user="alice", command=f"echo ran > {marker}",
                uris=[{"value": str(tmp_path / "does-not-exist.bin")}],
                max_retries=1, pool="default",
                resources=p.schema.Resources(cpus=1.0, mem=64.0))])
            return pairs, states, marker.exists()
        finally:
            cluster.shutdown()
            agents.stop()
    pairs, states, ran = both(scenario)
    assert all(i[0] == "failed" for i in states[uid(1)][1]) and not ran


# --------------------------------------------------------- the executor
def test_executor_cook_tracks_progress_through_rest(tmp_path):
    """``executor: "cook"`` wraps the command in each package's executor;
    its progress lines land on the instance through POST /progress."""
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        sched = scheduler(p, store, cluster)
        srv = p.rest.ApiServer(p.rest.CookApi(store, scheduler=sched))
        srv.start()
        cluster.progress_url = f"http://127.0.0.1:{srv.port}"
        try:
            job = p.state.Job(
                uuid=uid(1), user="alice",
                command='echo "progress: 30 warming"; sleep 0.3; '
                        'echo "progress: 80 almost"; sleep 0.2',
                executor="cook", pool="default",
                resources=p.schema.Resources(cpus=1.0, mem=128.0))
            store.create_jobs([job])
            sched.step_rank()
            pairs = pairs_of(store, sched.step_match())

            def done():
                sched.flush_status_updates()
                return store.job(job.uuid).state.value == "completed"
            assert wait_for(done, timeout=30)
            inst = store.instance(store.job(job.uuid).instances[-1])
            stdout = open(os.path.join(inst.sandbox_directory,
                                       "stdout")).read()
            return (pairs, final_states(store, [uid(1)]), inst.progress,
                    inst.progress_message, stdout)
        finally:
            srv.stop()
            cluster.shutdown()
            agents.stop()
    got = both(scenario)
    assert got[2:4] == (80, "almost")


def test_kill_cook_executor_job_kills_workload(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster(
            "remote-1", agents.endpoints, store=store, kill_grace_ms=6000)
        pidfile = tmp_path / f"workload-{p.root}.pid"
        try:
            sched = scheduler(p, store, cluster)
            job = p.state.Job(uuid=uid(1), user="alice",
                              command=f"echo $$ > {pidfile}; sleep 300",
                              executor="cook", pool="default",
                              resources=p.schema.Resources(cpus=1.0,
                                                           mem=128.0))
            store.create_jobs([job])
            sched.step_rank()
            pairs = pairs_of(store, sched.step_match())
            assert wait_for(lambda: pidfile.exists()
                            and pidfile.read_text().strip(), timeout=20)
            workload_pid = int(pidfile.read_text())
            store.kill_job(job.uuid)

            def done():
                sched.flush_status_updates()
                return store.job(job.uuid).state.value == "completed"
            assert wait_for(done, timeout=20)

            def workload_gone():
                try:
                    os.kill(workload_pid, 0)
                    return False
                except ProcessLookupError:
                    return True
            return (pairs, final_states(store, [uid(1)]),
                    wait_for(workload_gone, timeout=10))
        finally:
            cluster.shutdown()
            agents.stop()
    assert both(scenario)[2] is True


def test_over_limit_killed_under_limit_survives(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root,
                        ("memnode", {"cpus": 4, "mem": 4096}))
        store = p.state.Store()
        hog = ("python3 -c \"import time\nx=[]\n"
               "for i in range(400): x.append(' '*1048576)\n"
               "time.sleep(60)\"")
        res = p.schema.Resources
        store.create_jobs([
            p.state.Job(uuid=uid(1), user="u", command=hog,
                        resources=res(cpus=1.0, mem=32.0)),
            p.state.Job(uuid=uid(2), user="u", command="sleep 2",
                        resources=res(cpus=1.0, mem=256.0))])
        cluster = p.remote.RemoteComputeCluster("mem-test", agents.endpoints,
                                                store=store)
        updates = []
        try:
            cluster.initialize(recorder(updates))
            cluster.launch_tasks("default", [
                _spec(p, "mem-hog", uid(1), "memnode", mem=32.0)])
            cluster.launch_tasks("default", [
                _spec(p, "mem-ok", uid(2), "memnode", mem=256.0)])
            assert wait_for(lambda: len(seq_of(updates, "mem-hog")) == 2
                            and len(seq_of(updates, "mem-ok")) == 2,
                            timeout=30)
            return [(s[0], s[1]) for s in seq_of(updates, "mem-hog")], \
                seq_of(updates, "mem-ok")
        finally:
            cluster.shutdown()
            agents.stop()
    hog, ok = both(scenario)
    assert hog[1] == ("failed", R.schema.Reasons.MEMORY_LIMIT_EXCEEDED.code)
    assert [s[0] for s in ok] == ["running", "success"]


def test_cook_env_vars_visible_to_task(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {"cpus": 4.0}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        out_plain = tmp_path / f"plain-{p.root}.env"
        out_grp = tmp_path / f"grouped-{p.root}.env"
        dump = "env | grep ^COOK_ | grep -v ^COOK_SANDBOX | sort > {out}"
        res = p.schema.Resources
        sched = scheduler(p, store, cluster)
        plain = p.state.Job(uuid=uid(1), user="alice",
                            command=dump.format(out=out_plain),
                            pool="default",
                            resources=res(cpus=1.0, mem=128.0))
        grouped = p.state.Job(uuid=uid(2), user="alice", group=uid(90),
                              command=dump.format(out=out_grp),
                              pool="default",
                              resources=res(cpus=2.0, mem=256.0, gpus=0.0))
        store.create_jobs([plain, grouped],
                          groups=[p.state.Group(uuid=uid(90), name="g1")])
        try:
            sched.step_rank()
            pairs = pairs_of(store, sched.step_match())

            def settled():
                sched.flush_status_updates()
                return all(store.job(u).state.value == "completed"
                           for u in (uid(1), uid(2)))
            assert wait_for(settled)

            def env_of(path, uuid):
                task = store.job(uuid).instances[-1]
                return sorted(line.replace(task, "TASK") for line in
                              path.read_text().strip().splitlines())
            return (pairs, env_of(out_plain, uid(1)),
                    env_of(out_grp, uid(2)))
        finally:
            cluster.shutdown()
            agents.stop()
    pairs, plain, grouped = both(scenario)
    assert f"COOK_JOB_UUID={uid(1)}" in plain
    assert "COOK_INSTANCE_UUID=TASK" in plain
    assert "COOK_INSTANCE_NUM=0" in plain and "COOK_JOB_CPUS=1.0" in plain
    assert "COOK_JOB_MEM_MB=128.0" in plain
    assert not any(x.startswith(("COOK_JOB_GROUP_UUID", "COOK_JOB_GPUS"))
                   for x in plain)
    assert f"COOK_JOB_GROUP_UUID={uid(90)}" in grouped


def test_parameters_reach_runtime_argv(tmp_path):
    def scenario(p):
        record, rt = _fake_runtime(tmp_path, p.root)
        agents = Agents(p, tmp_path / "agents",
                        ("nodeP", {"container_runtime": str(rt)}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        try:
            pairs, states = _run_jobs(p, store, cluster, [p.state.Job(
                uuid=uid(1), user="alice", command="true",
                container={"image": "busybox:1.36",
                           "parameters": [
                               {"key": "workdir", "value": "/tmp"},
                               {"key": "env", "value": "FOO=bar"}]},
                pool="default",
                resources=p.schema.Resources(cpus=1.0, mem=64.0))])
            task = store.job(uid(1)).instances[-1]
            return pairs, states, record.read_text().replace(task, "TASK")
        finally:
            cluster.shutdown()
            agents.stop()
    pairs, states, args = both(scenario)
    assert "--workdir /tmp" in args and "--env FOO=bar" in args
    assert args.index("--workdir") < args.index("busybox:1.36")


def test_nested_container_form_over_rest(tmp_path):
    def scenario(p):
        agents = Agents(p, tmp_path / p.root, ("nodeA", {}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("remote-1", agents.endpoints,
                                                store=store)
        sched = scheduler(p, store, cluster)
        srv = p.rest.ApiServer(p.rest.CookApi(store, scheduler=sched))
        srv.start()
        try:
            client = p.client.JobClient(srv.url, user="alice")
            [uuid] = client.submit([{
                "uuid": uid(1), "command": "true", "cpus": 1, "mem": 64,
                "container": {"type": "docker",
                              "docker": {"image": "busybox:nested",
                                         "parameters": [
                                             {"key": "workdir",
                                              "value": "/x"}]}}}])
            job = store.job(uuid)
            return (job.container, client.job(uuid)["container"])
        finally:
            srv.stop()
            cluster.shutdown()
            agents.stop()
    container, shown = both(scenario)
    assert container["image"] == "busybox:nested"
    assert container["parameters"] == [{"key": "workdir", "value": "/x"}]
    assert shown["docker"]["image"] == "busybox:nested"


def test_three_users_through_rest_and_native_agent(tmp_path):
    """``tests/test_multi_user.py``'s real-process case: three users
    submit over REST, one cycle places all three on one agent, each
    job's marker holds its user and its REST body says success."""
    def scenario(p):
        agents = Agents(p, tmp_path / p.root,
                        ("mu-node", {"cpus": 8.0, "mem": 8192.0}))
        store = p.state.Store()
        cluster = p.remote.RemoteComputeCluster("native-1", agents.endpoints,
                                                store=store)
        sched = scheduler(p, store, cluster)
        srv = p.rest.ApiServer(p.rest.CookApi(store, scheduler=sched,
                                              admins=["admin"]))
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"

        def rq(method, path, user, body=None):
            data = json.dumps(body).encode() if body is not None else None
            req = urllib.request.Request(
                base + path, data=data, method=method,
                headers={"Content-Type": "application/json",
                         "X-Cook-User": user})
            return json.loads(urllib.request.urlopen(req).read())

        try:
            uuids = {}
            for i, user in enumerate(("alice", "bob", "carol")):
                marker = tmp_path / f"{user}-{p.root}.out"
                uuids[user] = rq("POST", "/jobs", user, {"jobs": [
                    {"uuid": uid(i + 1), "command": f"echo {user} > {marker}",
                     "cpus": 1.0, "mem": 128.0}]})["jobs"][0]
            sched.step_rank()
            pairs = pairs_of(store, sched.step_match())

            def states():
                sched.flush_status_updates()
                return {u: rq("GET", f"/jobs/{uid_}", u)["state"]
                        for u, uid_ in uuids.items()}
            assert wait_for(lambda: all(s == "success"
                                        for s in states().values()))
            bodies = {u: [i["status"] for i in
                          rq("GET", f"/jobs/{uid_}", u)["instances"]]
                      for u, uid_ in uuids.items()}
            markers = {u: (tmp_path / f"{u}-{p.root}.out").read_text()
                       for u in uuids}
            return pairs, states(), bodies, markers
        finally:
            srv.stop()
            cluster.shutdown()
            agents.stop()
    pairs, states, bodies, markers = both(scenario)
    assert len(pairs) == 3
    assert set(states.values()) == {"success"}
    assert markers == {u: u + "\n" for u in ("alice", "bob", "carol")}
