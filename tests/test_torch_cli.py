"""The port's ``cs`` (``cook_tpu_torch/cli``), its sandbox file server
(``cook_tpu_torch/agent``) and its live-system simulator
(``cook_tpu_torch/sim/system.py``) against the JAX package's on the CPU.

One port node (``CookDaemon`` in process, ``device="cpu"``, the default
fused cycle) serves the module.  The reference's ``cs`` and the port's
``cs`` run the same script of ``tests/test_cli_surface.py``'s families
(submit, raw, show, wait, jobs, kill and their errors) against it, each
in process through its ``main(argv)``; each step's exit code, stdout and
stderr must be equal after the uuids and the user names each side minted
are renamed by first appearance.  Job bodies that ``show`` and ``wait``
print carry host-clock times, so they compare on the fields a submission
fixes and on the final state.
"""

import importlib
import io
import json
import re
import sys
import time
import types
from pathlib import Path

import pytest

from test_torch_daemon import fresh_planes, node_conf
from test_torch_driver import PORT, REF


def pkg(m):
    ns = types.SimpleNamespace(m=m, root=m.root)
    for name, mod in (("cli", "cli.main"), ("system", "sim.system"),
                      ("file_server", "agent.file_server"),
                      ("daemon", "daemon"), ("client", "client")):
        setattr(ns, name, importlib.import_module(f"{m.root}.{mod}"))
    return ns


SIDES = (pkg(REF), pkg(PORT))
R, P = SIDES
UUID = re.compile(r"\b[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}\b")


@pytest.fixture(scope="module")
def node(tmp_path_factory):
    fresh_planes()
    tmp = tmp_path_factory.mktemp("cli-node")
    conf = node_conf(tmp, name="cli")
    conf["clusters"][0]["kwargs"] = {
        "name": "cli-alpha", "n_hosts": 3, "cpus": 4.0, "mem": 4096.0,
        "default_task_duration_ms": 300, "auto_advance": True}
    conf["scheduler"].update(match_interval_seconds=0.1,
                             rank_interval_seconds=0.1)
    d = P.daemon.CookDaemon(conf, device="cpu")
    d.start()
    deadline = time.time() + 60
    while d.scheduler is None:
        assert time.time() < deadline and d.exit_code == 0
        time.sleep(0.02)
    yield d
    d.shutdown()
    fresh_planes()


class Side:
    """One package's ``cs`` against the node; renames what it minted."""

    def __init__(self, p, node, tmp_path, monkeypatch):
        self.p, self.node = p, node
        self.names = {}
        self.tag = p.root.replace("_", "")
        monkeypatch.setattr(p.cli, "CONFIG_PATH", tmp_path / ".cs.json")
        monkeypatch.setenv("HOME", str(tmp_path))
        monkeypatch.setenv("COOK_URL", node.node_url)
        self.monkeypatch = monkeypatch

    def user(self, name):
        return f"{name}-{self.tag}"

    def norm(self, text):
        text = text.replace(f"-{self.tag}", "-USER")
        return UUID.sub(lambda m: self.names.setdefault(
            m.group(0), f"uuid-{len(self.names)}"), text)

    def run(self, *argv, stdin="", user="alice"):
        """(rc, stdout, stderr) of ``cs argv`` with ``stdin``."""
        self.monkeypatch.setenv("COOK_USER", self.user(user))
        out = io.TextIOWrapper(io.BytesIO(), encoding="utf-8")
        err = io.StringIO()
        self.monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
        self.monkeypatch.setattr(sys, "stdout", out)
        self.monkeypatch.setattr(sys, "stderr", err)
        try:
            rc = self.p.cli.main(list(argv))
        finally:
            out.flush()
            self.monkeypatch.setattr(sys, "stdout", sys.__stdout__)
            self.monkeypatch.setattr(sys, "stderr", sys.__stderr__)
        return rc, out.buffer.getvalue().decode(), err.getvalue()


# fields of a job body a submission fixes, and the settled state
JOB_FIELDS = ("name", "command", "user", "cpus", "mem", "priority", "pool",
              "max_retries", "env")


def job_view(body, settled=True):
    jobs = json.loads(body)
    out = []
    for j in jobs:
        row = {k: j.get(k) for k in JOB_FIELDS}
        row["keys"] = sorted(j)
        if settled:
            row["state"] = j["state"]
            row["instances"] = [i["status"] for i in j["instances"]]
        out.append(row)
    return out


def script(s):
    """The families of ``tests/test_cli_surface.py``; returns the log."""
    log = []

    def step(*argv, stdin="", user="alice", view=None):
        rc, out, err = s.run(*argv, stdin=stdin, user=user)
        if view is not None and rc == 0:
            out = json.dumps(view(out))
        log.append((argv[0], rc, s.norm(out), s.norm(err)))
        return rc, out

    # stdin submit: one command, several, none
    rc, out = step("submit", "--cpus", "1", "--mem", "64",
                   stdin="echo from-stdin\n")
    one = out.split()
    step("wait", *one, "--timeout", "30", view=job_view)
    rc, out = step("submit", "--cpus", "1", "--mem", "64",
                   stdin="echo one\necho two\necho three\n")
    three = out.split()
    step("wait", *three, "--timeout", "30", view=job_view)
    step("submit", stdin="")
    # raw submit: an object, a list, its errors
    spec = {"command": "true", "cpus": 1, "mem": 64, "name": "rawjob"}
    rc, out = step("submit", "--raw", stdin=json.dumps(spec))
    raw = out.split()
    step("submit", "--raw", stdin=json.dumps([spec, dict(spec,
                                                         name="rawjob2")]))
    step("show", *raw, view=lambda b: job_view(b, settled=False))
    step("submit", "--raw", stdin="{not json")
    step("submit", "--raw", "echo", "hi", stdin="{}")
    # piping: jobs -1 into show and kill
    subs = [step("submit", "--cpus", "1", "--mem", "64", "--env",
                 "COOK_FAKE_DURATION_MS=999999", "sleep", "999",
                 user="piper")[1].strip() for _ in range(2)]
    rc, listed = step("jobs", "-1", "--state", "waiting+running",
                      user="piper")
    assert set(subs) <= set(listed.split())
    step("show", stdin=listed, user="piper",
         view=lambda b: sorted(s.norm(j["uuid"]) for j in json.loads(b)))
    step("kill", stdin="\n".join(subs), user="piper")
    step("show", stdin="")
    # errors: bogus uuids, malformed and duplicate refs, double dash
    step("kill", "00000000-0000-0000-0000-0000000b0605")
    step("show", "not-a-uuid")
    step("show", *raw[:1], *raw[:1])
    step("submit", "--cpus", "1", "--mem", "64", "--", "echo", "--dash")
    return log


def test_cs_families_print_the_same(node, tmp_path, monkeypatch):
    logs = [script(Side(p, node, tmp_path, monkeypatch)) for p in SIDES]
    assert len(logs[0]) == len(logs[1])
    for a, b in zip(*logs):
        assert a == b
    assert [rc for _c, rc, _o, _e in logs[0]].count(0) >= 10


def test_cs_lint_prints_the_same(node, tmp_path, monkeypatch):
    """``cs lint --json`` with the port's defaults (its own tree, its own
    baseline, the repo's ``docs/``) gives the exit code and the document
    that the reference's ``cs lint --json`` gives on the same tree, after
    the scanned package's name; a dirty tree exits 1 on both."""
    port_tree = str(Path(P.cli.__file__).parent.parent)
    got = []
    for p, argv in ((R, ("lint", "--json", "--root", port_tree)),
                    (P, ("lint", "--json"))):
        rc, out, err = Side(p, node, tmp_path, monkeypatch).run(*argv)
        doc = json.loads(out)
        for f in doc["findings"] + doc["suppressed"]:
            f["message"] = f["message"].replace(
                " is used in cook_tpu_torch/ ", " is used in cook_tpu/ ")
        got.append((rc, doc, err))
    assert got[1] == got[0]
    rc, doc, _err = got[1]
    assert rc == 0 and doc["ok"] and len(doc["lock_edges"]) == 18
    assert doc["summary"]["suppressed"] == len(doc["suppressed"]) > 7
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        "import os\n\nclass S:\n    def bad(self):\n"
        "        with self._lock:\n            os.fsync(3)\n")
    empty = tmp_path / "b.json"
    empty.write_text('{"suppressions": []}')
    dirty = [Side(p, node, tmp_path, monkeypatch).run(
        "lint", "--root", str(pkg), "--baseline", str(empty))
        for p in SIDES]
    assert dirty[1] == dirty[0] and dirty[1][0] == 1
    assert "[lock-blocking-call]" in dirty[1][1]


# ------------------------------------------------ sandbox commands
@pytest.fixture
def sandbox(node, tmp_path):
    """A finished job whose instance's output_url is the port's sandbox
    file server over a directory of files."""
    root = tmp_path / "sandbox"
    (root / "logs").mkdir(parents=True)
    (root / "stdout").write_text("".join(f"line {i}\n" for i in range(50)))
    (root / "logs" / "err.txt").write_bytes(b"\x00\x01 binary\n")
    srv = P.file_server.SandboxFileServer(str(root))
    srv.start()
    c = P.client.JobClient(node.node_url, user="sandboxer")
    [uuid] = c.submit([{"command": "true", "cpus": 1, "mem": 64}])
    deadline = time.time() + 30
    while not node.store.job(uuid).instances:
        assert time.time() < deadline
        time.sleep(0.05)
    task = node.store.job(uuid).instances[-1]
    node.store.update_instance_sandbox(task, sandbox_directory=str(root),
                                       output_url=srv.url)
    yield uuid
    srv.stop()


SANDBOX_CMDS = {
    "cat": ("cat", "{uuid}", "stdout"),
    "cat_binary": ("cat", "{uuid}", "logs/err.txt"),
    "tail": ("tail", "{uuid}", "stdout", "--lines", "7"),
    "tail_small_reads": ("tail", "{uuid}", "stdout", "--lines", "3",
                         "--bytes", "5"),
    "ls": ("ls", "{uuid}", "--json"),
    "ls_subdir": ("ls", "{uuid}", "logs", "--json"),
    "cat_missing": ("cat", "{uuid}", "nope"),
}


@pytest.mark.parametrize("name", sorted(SANDBOX_CMDS))
def test_cs_sandbox_commands_against_the_port_file_server(
        name, node, sandbox, tmp_path, monkeypatch):
    argv = [a.format(uuid=sandbox) for a in SANDBOX_CMDS[name]]
    out = []
    for p in SIDES:
        s = Side(p, node, tmp_path, monkeypatch)
        try:
            got = s.run(*argv, user="sandboxer")
        except Exception as e:   # both sides raise alike on a 404
            got = (type(e).__name__, str(e))
        if name.startswith("ls") and got[0] == 0:
            got = (0, [{k: v for k, v in e.items() if k != "mtime"}
                       for e in json.loads(got[1])], got[2])
        out.append(got)
    assert out[0] == out[1]
    if name == "tail":
        assert out[1][1] == "".join(f"line {i}\n" for i in range(43, 50))
    assert P.file_server.MAX_READ_LENGTH == R.file_server.MAX_READ_LENGTH


# ------------------------------------------------ the live-system simulator
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_schedule_equal(seed):
    args = (3 + seed % 3, 5, 10.0, seed, f"s{seed}")
    assert R.system.generate_schedule(*args) == \
        P.system.generate_schedule(*args, mean_duration_ms=2000.0)


@pytest.mark.parametrize("seed", [0, 3])
def test_build_report_equal(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(40):
        submit = int(rng.integers(0, 10_000))
        job = {"uuid": f"j{i}", "user": f"u{i % 4}", "submit_ms": submit,
               "intended_duration_ms": float(rng.integers(50, 3000)),
               "state": "failed" if i % 9 == 0 else "success",
               "preempted": int(i % 11 == 0)}
        if i % 13:
            job["start_ms"] = submit + int(rng.integers(1, 500))
            if i % 7:
                job["finish_ms"] = job["start_ms"] + int(
                    rng.integers(50, 4000))
        jobs.append(job)
    results = {"label": "r", "jobs": jobs, "errors": ["x"]}
    assert R.system.build_report(results) == P.system.build_report(results)


def test_simulate_against_the_port_node(node, tmp_path, capsys):
    sched = tmp_path / "sched.json"
    res = tmp_path / "res.json"
    assert P.system.main(["generate", "-f", str(sched), "--users", "3",
                          "--jobs-per-user", "3", "--duration-s", "1",
                          "--mean-job-duration-ms", "200"]) == 0
    assert P.system.main(["simulate", "-f", str(sched), "--url",
                          node.node_url, "--out", str(res),
                          "--settle-timeout-s", "60"]) == 0
    capsys.readouterr()
    assert P.system.main(["report", "-f", str(res)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["jobs_total"] == 9 and report["finished"] == 9
    assert report["never_scheduled"] == [] and report["submit_errors"] == []
    assert report["overall"]["wait"]["count"] == 9
