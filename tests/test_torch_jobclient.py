"""The port's native job client (``cook_tpu_torch/native/jobclient.py``
over the repo-root ``native/jobclient.cpp``) against the JAX package's,
on the CPU, each over its own package's REST node.

Every scenario of ``tests/test_native_jobclient.py`` runs once on each
side: a ``Store`` with a pinned clock, a fake cluster of two hosts, a
``Scheduler`` on the split CPU path (``rank_backend="cpu"``, the
``"cpu"`` matcher; the port's on ``device="cpu"``), a ``CookApi`` behind
an ``ApiServer`` on port 0, and that package's ``NativeJobClient``.  Each
scenario returns a transcript (every client call's result, or its
exception by type, message and HTTP status, and the placements of each
cycle), and the two transcripts must be equal: every comparison is
exact.  Job uuids and task ids come from ``uuid.uuid4()`` in the
server's ``new_uuid``; :func:`seeded_uuids` hands both sides one seeded
sequence there, inside the test only; the random 16- and 32-digit
request ids are renamed by order of first appearance (:func:`norm`).

The port's library builds into ``build/native``, which git ignores, and
never into the reference's ``native/build``; both sides' bindings load
that one build of the same source (:func:`_one_library`).
"""

import importlib
import random
import re
import sys
import threading
import time
import types
import uuid as uuid_mod
from contextlib import contextmanager
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
T0 = 1_700_000_000_000


def pkg(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("cluster", "cluster"), ("config", "config"),
                      ("policy", "policy"), ("rest", "rest"),
                      ("sched", "sched"), ("state", "state"),
                      ("jc", "native.jobclient")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


REF, PORT = pkg("cook_tpu"), pkg("cook_tpu_torch")
SIDES = (REF, PORT)



@pytest.fixture(scope="module", autouse=True)
def _one_library():
    """Both sides load the library the port's helper builds (under a
    private name, renamed into place): the reference's helper compiles
    straight into its target, and a worker that loads that file while
    another writes it fails.  The bindings stay each package's own."""
    if not PORT.jc.native_available():
        pytest.skip("no C++ toolchain")
    with pytest.MonkeyPatch.context() as mp:
        if not REF.jc._lib_tried:
            mp.setattr(REF.jc, "_LIB", PORT.jc._LIB)
        if not REF.jc.native_available():
            pytest.skip("the reference's binding could not load it")
        yield


@contextmanager
def seeded_uuids(p, callers=("state.schema", "client"), seed=0):
    """``uuid.uuid4()`` called from ``p``'s ``callers`` modules answers
    from one seeded sequence; every other caller keeps the random one."""
    real = uuid_mod.uuid4
    rng = random.Random(seed)
    names = {f"{p.root}.{c}" for c in callers}

    def uuid4():
        if sys._getframe(1).f_globals.get("__name__") in names:
            return uuid_mod.UUID(int=rng.getrandbits(128), version=4)
        return real()

    uuid_mod.uuid4 = uuid4
    try:
        yield
    finally:
        uuid_mod.uuid4 = real


class World:
    """The reference test's ``system`` fixture, on one package: a node
    of ``n_hosts`` fake hosts on the split CPU path, serving REST."""

    def __init__(self, p, n_hosts=2, cpus=8, mem=8192, per_user_limit=None,
                 **api_kw):
        self.p = p
        self.store = p.state.Store()
        self.store.clock = lambda: T0
        self.cluster = p.cluster.FakeCluster(
            "fake-1", [p.cluster.FakeHost(
                f"h{i}", p.state.Resources(cpus=cpus, mem=mem))
                for i in range(n_hosts)])
        cfg = p.config.Config()
        cfg.default_matcher.backend = "cpu"
        kw = {"device": "cpu"} if p is PORT else {}
        self.sched = p.sched.Scheduler(self.store, cfg, [self.cluster],
                                       rank_backend="cpu", **kw)
        if per_user_limit is not None:
            api_kw["queue_limits"] = p.policy.QueueLimits(
                self.store, per_user_limit=per_user_limit)
        self.api = p.rest.CookApi(self.store, scheduler=self.sched,
                                  **api_kw)
        self.server = p.rest.ApiServer(self.api)
        self.server.start()

    def client(self, user="alice", **kw):
        return self.p.jc.NativeJobClient(self.server.host, self.server.port,
                                         user=user, **kw)

    def launch(self):
        """``step_rank`` then ``step_match``: the launched (job uuid,
        hostname) pairs of the default pool."""
        self.sched.step_rank()
        tids = self.sched.step_match()["default"].launched_task_ids
        return tids, sorted((self.store.instance(t).job_uuid,
                             self.store.instance(t).hostname)
                            for t in tids)

    def close(self):
        self.server.stop()


#: request and trace ids the tracing layer mints at random on each side
RANDOM_ID = re.compile(r"\b[0-9a-f]{32}\b|\b[0-9a-f]{16}\b")


def norm(value, names=None):
    """``value`` with each random request or trace id in its strings
    renamed by order of first appearance."""
    names = {} if names is None else names
    if isinstance(value, str):
        return RANDOM_ID.sub(lambda m: names.setdefault(
            m.group(0), f"id-{len(names)}"), value)
    if isinstance(value, (list, tuple)):
        return [norm(v, names) for v in value]
    if isinstance(value, dict):
        return {k: norm(v, names) for k, v in value.items()}
    return value


def caught(fn):
    """``fn()``'s result, or its exception as (type, message, status)."""
    try:
        return ["ok", fn()]
    except Exception as e:  # noqa: BLE001 - the transcript records it
        return ["raised", type(e).__name__, str(e),
                getattr(e, "status", None)]


JOB = {"command": "true", "cpus": 1.0, "mem": 128.0}


# ----------------------------------------------------------------- scripts
def s_submit_query_roundtrip(w):
    with w.client() as c:
        [uuid] = c.submit([JOB])
        jobs = c.query([uuid])
        assert [j["state"] for j in jobs] == ["waiting"]
        return [uuid, jobs]


def s_batched_submit(w):
    with w.client() as c:
        uuids = c.submit([dict(JOB) for _ in range(5)])
        assert len(set(uuids)) == 5
        return [uuids, c.query(uuids)]


def s_kill(w):
    with w.client() as c:
        [uuid] = c.submit([JOB])
        out = [caught(lambda: c.kill([uuid]))]
        [job] = c.query([uuid])
        assert job["state"] == "failed"
        return out + [job]


def s_retry_resurrects_failed_job(w):
    with w.client() as c:
        [uuid] = c.submit([dict(JOB, max_retries=1)])
        [tid], pairs = w.launch()
        w.cluster.complete_task(tid, exit_code=3)
        out = [pairs, c.query([uuid])]
        out.append(caught(lambda: c.retry(uuid, retries=5)))
        [job] = c.query([uuid])
        assert job["state"] == "waiting"
        return out + [job]


def s_wait_for_completion(w):
    with w.client() as c:
        [uuid] = c.submit([JOB])
        done = threading.Event()
        got = []

        def drive():
            [tid], pairs = w.launch()
            got.append(pairs)
            time.sleep(0.3)
            w.cluster.complete_task(tid)
            done.set()

        t = threading.Thread(target=drive)
        t.start()
        jobs = c.wait([uuid], timeout_s=10.0, poll_s=0.05)
        t.join()
        assert done.is_set() and jobs[0]["state"] == "success"
        return [got, jobs]


def s_wait_timeout(w):
    with w.client() as c:
        [uuid] = c.submit([JOB])
        return [caught(lambda: c.wait([uuid], timeout_s=0.3,
                                      poll_s=0.05))]


def s_listener_sees_state_changes(w):
    with w.client() as c:
        [uuid] = c.submit([JOB])
        seen = []
        c.listen([uuid], lambda u, s: seen.append((u, s)), interval_s=0.05)
        time.sleep(0.2)
        [tid], pairs = w.launch()
        time.sleep(0.2)
        w.cluster.complete_task(tid)
        deadline = time.time() + 5.0
        while time.time() < deadline and (uuid, "success") not in seen:
            time.sleep(0.05)
        states = [s for u, s in seen if u == uuid]
        assert states == ["waiting", "running", "success"]
        return [pairs, states]


def s_impersonation(w):
    with w.client(user="proxy", impersonate="carol") as c:
        [uuid] = c.submit([JOB])
        [job] = c.query([uuid])
        assert job["user"] == "carol"
        return [job]


def s_http_error_surfaces(w):
    with w.client() as c:
        got = caught(lambda: c.retry("00000000-0000-0000-0000-000000000000",
                                     retries=2))
        assert got[0] == "raised" and got[3] == 404
        return [got]


def s_generic_request(w):
    with w.client() as c:
        status, body = c.request("GET", "/info")
        assert status == 200
        return [status, body]


def s_group_submit_query_kill(w):
    g = "99999999-aaaa-bbbb-cccc-eeeeeeeeeeee"
    with w.client() as c:
        uuids = c.submit(
            [{"command": "sleep 999", "cpus": 1, "mem": 64, "group": g}
             for _ in range(2)],
            groups=[{"uuid": g, "name": "native-grp"}])
        _tids, pairs = w.launch()
        [grp] = c.group([g], detailed=True)
        assert sorted(grp["jobs"]) == sorted(uuids)
        out = [uuids, pairs, grp, caught(lambda: c.kill_groups([g]))]
        return out + [c.query(uuids)]


SCRIPTS = {name[2:]: fn for name, fn in sorted(globals().items())
           if name.startswith("s_")}


def native_world(p):
    return World(p, per_user_limit=100, admins=["admin"],
                 impersonators=["proxy"])


def run_both(script, world=native_world):
    """``script`` once on each side's world: the two transcripts."""
    out = []
    for p in SIDES:
        with seeded_uuids(p):
            w = world(p)
            try:
                out.append(norm(script(w)))
            finally:
                w.close()
    return out


# ------------------------------------------------------------------- tests
def test_every_reference_scenario_has_a_script():
    ref = (REPO / "tests/test_native_jobclient.py").read_text()
    names = {n[len("test_"):] for n in
             (line.split("(")[0].split()[-1] for line in ref.splitlines()
              if line.lstrip().startswith("def test_"))}
    assert names == set(SCRIPTS)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scenario_parity(name):
    ref, port = run_both(SCRIPTS[name])
    assert port == ref


def test_port_builds_into_its_own_directory():
    """The port's library lands in the repo's ``build/native``, which git
    ignores, under a private name renamed into place; the reference's
    ``native/build`` is never the port's target."""
    assert PORT.jc._LIB == REPO / "build" / "native" / "libcookjobclient.so"
    assert PORT.jc._SRC == REPO / "native" / "jobclient.cpp"
    assert PORT.jc._SRC == REF.jc._SRC
    assert PORT.jc._LIB.exists()
    assert "/build/" in (REPO / ".gitignore").read_text().split()


def test_port_raises_without_a_toolchain(monkeypatch, tmp_path):
    """With no g++ on the path and no library built, the port's client
    raises ``RuntimeError``, as the reference's does."""
    jc = PORT.jc
    monkeypatch.setattr(jc, "_LIB", tmp_path / "libcookjobclient.so")
    monkeypatch.setattr(jc, "_lib_handle", None)
    monkeypatch.setattr(jc, "_lib_tried", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not jc.native_available()
    with pytest.raises(RuntimeError, match="unavailable"):
        jc.NativeJobClient("127.0.0.1", 1)
    assert list(tmp_path.iterdir()) == []
