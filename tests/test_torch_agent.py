"""The port's task executor (``cook_tpu_torch/agent/executor.py``) against
the JAX package's (``cook_tpu/agent/executor.py``) on the CPU.

The executor cases of ``tests/test_agent.py`` run on both packages and
compare what a caller sees: ``ProgressWatcher`` on the same lines; the
exit codes, the sandbox files, the kill escalation and the process-tree
kill of ``TaskExecutor``; the explicit progress file; progress posted
to each package's own REST (the port's ``Scheduler(device="cpu")``);
the elastic resize relay of ``tests/test_elastic.py``; and the
traceparent adoption of ``tests/test_fleet_obs.py`` through ``python -m
<package>.agent.executor``.  ``python -X importtime -m
cook_tpu_torch.agent.executor true`` loads no ``torch``, ``jax`` or
``cook_tpu`` module: an agent host needs no PyTorch.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time
import types
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def side(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("agent", "agent"), ("executor", "agent.executor"),
                      ("cluster", "cluster"), ("state", "state"),
                      ("config", "config"), ("sched", "sched"),
                      ("rest", "rest"), ("client", "client"),
                      ("tracing", "utils.tracing"),
                      ("fleet", "sched.fleet")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    ns.kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
    return ns


SIDES = (side("cook_tpu"), side("cook_tpu_torch"))
R, P = SIDES


@pytest.fixture(autouse=True)
def _fresh_recorders():
    # a REST scheduler's cycles leave host-clock durations in the
    # package's flight recorder, which the admission ladder reads as
    # cycle_p99
    yield
    for root in ("cook_tpu", "cook_tpu_torch"):
        importlib.import_module(f"{root}.utils.flight").recorder.reset()


def both(scenario, *args, **kw):
    out = [scenario(p, *args, **kw) for p in SIDES]
    assert out[1] == out[0]
    return out[0]


def wait_for(pred, timeout=10.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def test_exports_and_default_regex_equal():
    names = ("DEFAULT_PROGRESS_REGEX", "ProgressWatcher", "TaskExecutor",
             "rest_progress_publisher", "SandboxFileServer")
    for n in names:
        assert hasattr(P.agent, n)
    assert P.agent.DEFAULT_PROGRESS_REGEX == R.agent.DEFAULT_PROGRESS_REGEX
    assert P.agent.TaskExecutor is P.executor.TaskExecutor


# --------------------------------------------------------- ProgressWatcher
LINES = {
    "percent_and_message": (None, ["progress: 25 loading data\n",
                                   "no progress here\n",
                                   "progress: 80% training\n"]),
    "clamped": (None, ["progress: 150 overshoot", "progress: -3 under",
                       "progress 7.9"]),
    "custom_regex": (r"\[(\d+)/100\]", ["step [42/100] done", "[x/100]"]),
    "message_capped": (None, ["progress: 50 " + "m" * 600]),
    "no_message_group": (r"pct=(\d+)", ["pct=12 trailing text"]),
    "bad_number": (r"p=([\d.]+)", ["p=1.2.3", "p=9"]),
}


@pytest.mark.parametrize("name", sorted(LINES))
def test_progress_watcher_equal(name):
    regex, lines = LINES[name]

    def scenario(p):
        seen = []
        kw = {} if regex is None else {"regex": regex}
        w = p.agent.ProgressWatcher(
            publish=lambda s, pct, m: seen.append((s, pct, m)), **kw)
        for line in lines:
            w.observe_line(line)
        return seen, w.sequence, w.last_percent, w.last_message
    seen, *_ = both(scenario)
    if name == "percent_and_message":
        assert seen == [(1, 25, "loading data"), (2, 80, "training")]
    if name == "clamped":
        assert [s[1] for s in seen] == [100, 7]


# --------------------------------------------------------- TaskExecutor
def test_runs_and_captures_output(tmp_path):
    def scenario(p):
        sb = tmp_path / p.root
        ex = p.agent.TaskExecutor(
            "echo out-line; echo err-line >&2; echo $COOK_WORKDIR; exit 0",
            sandbox=str(sb))
        ex.start()
        code = ex.wait(timeout_s=10)
        return (code, (sb / "stdout").read_text().replace(str(sb), "SB"),
                (sb / "stderr").read_text(), (sb / "exit_code").read_text())
    assert both(scenario) == (0, "out-line\nSB\n", "err-line\n", "0")


@pytest.mark.parametrize("command,code", [("exit 7", 7), ("true", 0),
                                          ("kill -9 $$", -9)])
def test_exit_codes(tmp_path, command, code):
    def scenario(p):
        ex = p.agent.TaskExecutor(command, sandbox=str(tmp_path / p.root))
        ex.start()
        return ex.wait(timeout_s=10), ex.running
    assert both(scenario) == (code, False)


def test_progress_from_stdout(tmp_path):
    def scenario(p):
        seen = []
        ex = p.agent.TaskExecutor(
            "echo 'progress: 10 start'; echo 'progress: 90 almost'",
            sandbox=str(tmp_path / p.root),
            progress_publish=lambda s, pct, m: seen.append((s, pct, m)))
        ex.start()
        ex.wait(timeout_s=10)
        return seen
    assert both(scenario) == [(1, 10, "start"), (2, 90, "almost")]


def test_kill_escalation_sigterm_trapped(tmp_path):
    def scenario(p):
        ex = p.agent.TaskExecutor(
            "trap '' TERM; touch ready; while true; do sleep 0.1; done",
            sandbox=str(tmp_path / p.root), kill_grace_period_s=0.5)
        ex.start()
        assert wait_for(lambda: (tmp_path / p.root / "ready").exists())
        was_running = ex.running
        t0 = time.time()
        code = ex.kill()
        return was_running, ex.running, code, time.time() - t0 < 10
    # the trap holds through the grace period, so SIGKILL ends it
    assert both(scenario) == (True, False, -signal.SIGKILL, True)


def test_kill_takes_down_process_tree(tmp_path):
    def scenario(p):
        ex = p.agent.TaskExecutor("sleep 300 & sleep 300 & wait",
                                  sandbox=str(tmp_path / p.root),
                                  kill_grace_period_s=0.5)
        ex.start()
        time.sleep(0.3)
        pgid = os.getpgid(ex.process.pid)
        code = ex.kill()
        live = "unchecked"
        deadline = time.time() + 5
        while time.time() < deadline:
            out = subprocess.run(["ps", "-o", "pid=,stat=", "-g", str(pgid)],
                                 capture_output=True, text=True)
            live = [line for line in out.stdout.splitlines()
                    if line.strip() and "Z" not in line.split()[1]]
            if not live:
                break
            time.sleep(0.1)
        return code, live
    assert both(scenario) == (-signal.SIGTERM, [])


def test_explicit_progress_file_watched(tmp_path):
    def scenario(p):
        updates = []
        sb = tmp_path / p.root
        ex = p.agent.TaskExecutor(
            'echo $EXECUTOR_PROGRESS_OUTPUT_FILE > where; '
            'echo "progress: 25 quarter" > prog.txt; sleep 0.4; '
            'echo "progress: 75 three-quarters" >> prog.txt; sleep 0.3',
            sandbox=str(sb), progress_file="prog.txt",
            progress_publish=lambda seq, pct, msg: updates.append(
                (pct, msg)))
        ex.start()
        code = ex.wait(timeout_s=10)
        wait_for(lambda: len(updates) >= 2, timeout=3)
        return (code, sorted(updates),
                (sb / "where").read_text().replace(str(sb), "SB"))
    assert both(scenario) == (0, [(25, "quarter"), (75, "three-quarters")],
                              "SB/prog.txt\n")


def test_executor_resize_relay(tmp_path):
    """``tests/test_elastic.py``'s resize relay: the advisory is appended
    to the resize file, advertised to the task before the fork, and
    SIGUSR1 reaches the task's process group."""
    def scenario(p):
        sb = tmp_path / p.root
        ex = p.agent.TaskExecutor(
            "echo $COOK_GANG_RESIZE_FILE > where; "
            "trap 'echo usr1 > got; exit 0' USR1; touch ready; "
            "while true; do sleep 0.05; done",
            sandbox=str(sb), resize_file=".cook-gang-resize.jsonl")
        ex.start()
        try:
            assert wait_for(lambda: (sb / "ready").exists())
            ex.notify_resize({"kind": "gang-resize", "direction": "shrink"})
            lines = (sb / ".cook-gang-resize.jsonl").read_text().splitlines()
            event = json.loads(lines[0])
            code = ex.wait(timeout_s=10)
            return (len(lines), event["kind"], event["direction"],
                    "ts" in event, code, (sb / "got").read_text(),
                    (sb / "where").read_text().replace(str(sb), "SB"))
        finally:
            if ex.running:
                ex.kill()
    assert both(scenario) == (1, "gang-resize", "shrink", True, 0, "usr1\n",
                              "SB/.cook-gang-resize.jsonl\n")


def test_progress_posted_to_rest_api(tmp_path):
    """Progress from the executor reaches each package's own REST and
    lands on the instance."""
    def scenario(p):
        store = p.state.Store()
        cluster = p.cluster.FakeCluster(
            "c", [p.cluster.FakeHost("h0", p.state.Resources(cpus=8,
                                                             mem=8192))])
        cfg = p.config.Config()
        cfg.default_matcher.backend = "cpu"
        sched = p.sched.Scheduler(store, cfg, [cluster], rank_backend="cpu",
                                  **p.kw)
        server = p.rest.ApiServer(p.rest.CookApi(store, scheduler=sched))
        server.start()
        try:
            [uuid] = store.create_jobs([p.state.Job(
                uuid="00000000-0000-4000-8000-000000000001", user="u",
                command="x", resources=p.state.Resources(cpus=1, mem=10))])
            sched.step_rank()
            [tid] = sched.step_match()["default"].launched_task_ids
            ex = p.agent.TaskExecutor(
                "echo 'progress: 55 crunching'; echo 'progress: 60 more'",
                sandbox=str(tmp_path / p.root),
                progress_publish=p.agent.rest_progress_publisher(server.url,
                                                                 tid))
            ex.start()
            ex.wait(timeout_s=10)
            assert wait_for(lambda: store.instance(tid).progress == 60)
            inst = store.instance(tid)
            return uuid, inst.progress, inst.progress_message
        finally:
            server.stop()
    assert both(scenario)[1:] == (60, "more")


# --------------------------------------------------------- python -m
def _run_module(root, argv, env_extra, cwd, python=()):
    env = dict(os.environ)
    env.pop("COOK_TRACEPARENT", None)
    env.update(env_extra)
    env["PYTHONPATH"] = os.pathsep.join(
        x for x in (REPO, env.get("PYTHONPATH")) if x)
    return subprocess.run(
        [sys.executable, *python, "-m", f"{root}.agent.executor", *argv],
        env=env, cwd=str(cwd), timeout=60, capture_output=True)


def test_module_exit_code_and_usage(tmp_path):
    def scenario(p):
        sb = tmp_path / p.root
        run = _run_module(p.root, ["echo", "hi;", "exit", "3"],
                          {"COOK_SANDBOX": str(sb)}, tmp_path)
        usage = _run_module(p.root, [], {}, tmp_path)
        return (run.returncode, (sb / "stdout").read_text(),
                usage.returncode,
                usage.stderr.decode().replace(p.root, "PKG"))
    got = both(scenario)
    assert got[:3] == (3, "hi\n", 2)
    assert "python -m PKG.agent.executor" in got[3]


def test_module_forwards_sigterm_to_the_workload(tmp_path):
    """The agent kills a task by signalling the wrapper: the wrapper
    escalates on the workload's own session.

    The wrapper exits with how its workload ended: killed by SIGTERM, or
    by SIGKILL once the 2 s grace lapsed, which a loaded host can make
    either side reach; so the two packages are compared on the
    wrapper reporting a killed workload (an exit status over 128), the
    grace's host-clock outcome left out.  The workload is gone once its
    pid names no process or a zombie (its parent, the wrapper, has
    exited, and whoever adopts it reaps it when it gets to it)."""
    def scenario(p):
        sb = tmp_path / p.root
        sb.mkdir()
        env = dict(os.environ, COOK_SANDBOX=str(sb),
                   PYTHONPATH=REPO)
        env.pop("COOK_TRACEPARENT", None)
        proc = subprocess.Popen(
            [sys.executable, "-m", f"{p.root}.agent.executor",
             "echo $$ > pid; sleep 300"], env=env, cwd=str(tmp_path))
        try:
            assert wait_for(lambda: (sb / "pid").exists()
                            and (sb / "pid").read_text().strip(), 30)
            pid = int((sb / "pid").read_text())
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=30)

            def gone():
                try:
                    os.kill(pid, 0)
                    with open(f"/proc/{pid}/stat") as f:
                        return f.read().rsplit(")", 1)[1].split()[0] == "Z"
                except (ProcessLookupError, FileNotFoundError):
                    return True
            return code > 128, wait_for(gone, 30.0)
        finally:
            if proc.poll() is None:
                proc.kill()
    killed, gone = both(scenario)
    assert killed is True and gone is True


def test_traceparent_adoption_through_the_module(tmp_path):
    """``tests/test_fleet_obs.py``'s agent leg: a client-minted trace is
    propagated into the executor through ``COOK_TRACEPARENT``; the
    wrapper opens ``agent.exec`` under it as ``agent-<hostname>`` and
    retains the spans in the sandbox, and the leader's stitched export
    of that trace shows the client, the leader and the agent tracks."""
    def scenario(p):
        store = p.state.Store()
        cluster = p.cluster.FakeCluster(
            "c", [p.cluster.FakeHost("h0", p.state.Resources(cpus=8,
                                                             mem=8192))])
        cfg = p.config.Config()
        cfg.default_matcher.backend = "cpu"
        cfg.fleet.scrape_interval_seconds = 0.01
        sched = p.sched.Scheduler(store, cfg, [cluster], rank_backend="cpu",
                                  **p.kw)
        api = p.rest.CookApi(store, scheduler=sched, config=cfg)
        api.instance = "leader-1"
        srv = p.rest.ApiServer(api)
        srv.start()
        members = {"leader-1": {"url": srv.url, "role": "leader",
                                "self": True}}
        api.fleet = p.fleet.FleetScraper(cfg.fleet, lambda: dict(members))
        tracer = p.tracing.tracer
        try:
            with p.tracing.scoped_identity("client-cli"):
                with tracer.span("client.submit") as root:
                    trace_id = root.trace_id
                    client = p.client.JobClient(srv.url, user="alice")
                    uuid = client.submit_one("echo hi")
            sandbox = tmp_path / p.root / "sandbox"
            run = _run_module(p.root, ["echo", "ran"], {
                "COOK_SANDBOX": str(sandbox), "COOK_TASK_ID": "task-1",
                "COOK_TRACEPARENT": p.tracing.make_traceparent(trace_id),
                "COOK_HOSTNAME": "h0"}, tmp_path)
            assert run.returncode == 0, run.stderr.decode()
            docs = [json.loads(line) for line in
                    (sandbox / "trace_spans.jsonl").read_text().splitlines()]
            exec_doc = next(d for d in docs if d["span"] == "agent.exec")
            tracer.finished.extend(docs)
            assert wait_for(lambda: tracer.traces(trace_id))
            with urllib.request.urlopen(
                    f"{srv.url}/debug/trace?trace_id={trace_id}",
                    timeout=10) as resp:
                trace = json.loads(resp.read())
            tracks = sorted(e["args"]["name"] for e in trace["traceEvents"]
                            if e["ph"] == "M" and e["name"] == "process_name")
            return (store.job(uuid) is not None,
                    exec_doc["trace_id"] == trace_id, exec_doc["proc"],
                    exec_doc["exit_code"], exec_doc["task"],
                    sorted(d["span"] for d in docs),
                    (sandbox / "stdout").read_text(), tracks)
        finally:
            srv.stop()
    got = both(scenario)
    assert got[:5] == (True, True, "agent-h0", 0, "task-1")
    assert {"client-cli", "leader-1", "agent-h0"} <= set(got[7])


def test_executor_module_loads_no_torch(tmp_path):
    """``python -X importtime -m cook_tpu_torch.agent.executor true``:
    exit 0, and no ``torch``, ``jax`` or ``cook_tpu`` module in the
    report (an agent host needs no PyTorch)."""
    run = _run_module("cook_tpu_torch", ["true"],
                      {"COOK_SANDBOX": str(tmp_path / "sb")}, tmp_path,
                      python=("-X", "importtime"))
    assert run.returncode == 0, run.stderr.decode()
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in run.stderr.decode().splitlines()
                if line.startswith("import time:")]
    assert "cook_tpu_torch.agent.executor" in imported
    assert not [m for m in imported
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "cook_tpu",
                                       "numpy")]
