"""The port's REST plane (``cook_tpu_torch/rest``), its unscheduled
explainer and its client against the JAX package's on the CPU.

Each world builds both stacks in process: a ``Store`` with a pinned
clock, a fake cluster, a ``Scheduler`` (the port's on ``device="cpu"``;
the reference's fused XLA cycle on ``JAX_PLATFORMS=cpu``), a ``CookApi``
behind an ``ApiServer`` on port 0, and each package's own ``JobClient``.
The same request script runs on both; every request sends a fixed
``X-Cook-Request-Id`` and every job and group has a fixed uuid.  For each
request the status code and the JSON body must be equal, after
:meth:`Stack.norm` renames the ids that ``new_uuid()`` mints (task ids,
random on both sides) by order of first appearance.  A ``step_cycle``
between requests must launch the same (job uuid, hostname) pairs.

The worlds are the cases of ``tests/test_rest.py``, ``tests/test_auth.py``
and ``tests/test_http_obs.py``.
"""

import base64
import gzip
import http.client
import importlib
import json
import re
import time
import types
import urllib.parse

import numpy as np
import pytest

from test_torch_driver import PORT, REF
from test_torch_monitor import fresh_request_log


def pkg(m):
    ns = types.SimpleNamespace(m=m, root=m.root)
    for name, mod in (("api", "rest.api"), ("auth", "rest.auth"),
                      ("instrument", "rest.instrument"),
                      ("task_stats", "rest.task_stats"),
                      ("client", "client"),
                      ("scheduler", "sched.scheduler"),
                      ("unscheduled", "sched.unscheduled"),
                      ("faults", "utils.faults")):
        setattr(ns, name, importlib.import_module(f"{m.root}.{mod}"))
    return ns


SIDES = (pkg(REF), pkg(PORT))
T0 = 1_700_000_000_000
CLUSTER = "rest-parity"
# ids minted at random on each side: uuid4 task ids, and the 16- and
# 32-digit trace and span ids of the tracing layer
RANDOM_ID = re.compile(
    r"\b(?!00000000-)[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}"
    r"-[0-9a-f]{12}\b|\b[0-9a-f]{32}\b|\b[0-9a-f]{16}\b")


@pytest.fixture(autouse=True)
def _fresh_request_logs():
    # CookApi configures each package's request log; a brownout turns its
    # capture off.  Both start and end every test in their default state.
    for p in SIDES:
        fresh_request_log(p)
    yield
    for p in SIDES:
        fresh_request_log(p)


def job_uuid(i, tag=0):
    return f"00000000-0000-4000-{0x8000 + tag:04x}-{i:012d}"


def group_uuid(i):
    return f"00000000-0000-4000-9000-{i:012d}"


class Stack:
    """One package's REST deployment, driven over HTTP."""

    def __init__(self, p, n_hosts=3, cfg_fn=None, per_user_limit=100,
                 **api_kw):
        m = self.m = p.m
        self.p = p
        self.now = [T0]
        self.store = m.Store()
        self.store.clock = lambda: self.now[0]
        # a cluster name no other test file uses: its circuit breaker, in
        # each package's process-wide breaker registry, is this file's own
        self.cluster = m.FakeCluster(
            CLUSTER, [m.FakeHost(f"h{i}", m.Resources(cpus=8.0, mem=8192.0))
                      for i in range(n_hosts)])
        cfg = m.Config()
        cfg.pipeline.depth = 0
        if cfg_fn is not None:
            cfg_fn(m, cfg)
        kw = {"device": "cpu"} if p.root == "cook_tpu_torch" else {}
        self.sched = p.scheduler.Scheduler(self.store, cfg, [self.cluster],
                                           **kw)
        api_kw.setdefault("queue_limits", m.QueueLimits(
            self.store, per_user_limit=per_user_limit))
        api_kw.setdefault("admins", ["admin"])
        api_kw.setdefault("impersonators", ["proxy"])
        self.api = p.api.CookApi(self.store, scheduler=self.sched,
                                 config=cfg, **api_kw)
        self.server = p.api.ApiServer(self.api)
        self.server.start()
        self.seq = 0
        self.names = {}

    def close(self):
        self.server.stop()

    # ------------------------------------------------------------ requests
    def norm(self, value):
        """``value`` with every id ``new_uuid()`` minted renamed
        ``id-<k>`` by order of first appearance on this stack."""
        def sub(s):
            return RANDOM_ID.sub(
                lambda mt: self.names.setdefault(
                    mt.group(0), f"id-{len(self.names)}"), s)
        if isinstance(value, str):
            return sub(value)
        if isinstance(value, list):
            return [self.norm(v) for v in value]
        if isinstance(value, dict):
            return {sub(k) if isinstance(k, str) else k: self.norm(v)
                    for k, v in value.items()}
        return value

    def raw(self, method, path, body=None, user="alice", headers=None):
        """(status, response headers, raw bytes) of one request."""
        self.seq += 1
        hdrs = {"X-Cook-Request-Id": f"req-{self.seq:05d}"}
        if user is not None:
            hdrs["X-Cook-User"] = user
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        hdrs.update(headers or {})
        conn = http.client.HTTPConnection(self.server.host, self.server.port,
                                          timeout=60)
        try:
            conn.request(method, path, body=data, headers=hdrs)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def call(self, method, path, body=None, user="alice", headers=None,
             params=None):
        """(status, normalized JSON body or text) of one request."""
        if params:
            path += "?" + urllib.parse.urlencode(params, doseq=True)
        status, hdrs, data = self.raw(method, path, body, user, headers)
        ctype = hdrs.get("Content-Type", "")
        if hdrs.get("Content-Encoding") == "gzip":
            data = gzip.decompress(data)
        if "json" in ctype and data:
            return status, self.norm(json.loads(data))
        return status, self.norm(data.decode(errors="replace"))

    def settle(self, timeout_s=10.0):
        """Wait until this package's request log holds no request in
        flight.  A handler writes its response before it records the
        request (``RequestObserver.end`` runs after ``_respond``), so the
        client can read a reply while the server's thread has not yet
        counted it; a snapshot taken then holds one request more in
        flight and one fewer in ``recent``, a host-scheduling reading."""
        log = self.p.instrument.request_log
        deadline = time.monotonic() + timeout_s
        while log.snapshot(0)["totals"]["inflight"] > 0:
            assert time.monotonic() < deadline, "a request stayed in flight"
            time.sleep(0.002)

    def client(self, user="alice", **kw):
        c = self.p.client.JobClient(self.server.url, user=user, **kw)
        c.throttle_retries = 0
        return c

    # ------------------------------------------------------------ the cycle
    def step(self):
        """One ``step_cycle``: the launched (job uuid, hostname) pairs
        by pool."""
        out = {}
        for pool, res in sorted(self.sched.step_cycle().items()):
            pairs = []
            for t in res.launched_task_ids:
                inst = self.store.instance(t)
                pairs.append((inst.job_uuid, inst.hostname))
            out[pool] = sorted(pairs)
        return out

    def task(self, uuid):
        return self.store.job(uuid).instances[-1]

    def advance(self, ms):
        self.now[0] += ms


def run_both(script, stack_kw=lambda p: {}):
    """Run ``script(stack, log)`` on both packages, each stack built with
    ``stack_kw(package)``; return each side's log of observations."""
    logs = []
    for p in SIDES:
        s = Stack(p, **stack_kw(p))
        log = []
        try:
            script(s, log)
        finally:
            s.close()
        logs.append(log)
    return logs


def spec(i, tag=0, **kw):
    out = {"uuid": job_uuid(i, tag), "command": f"echo {i}", "cpus": 1.0,
           "mem": 128.0, "max_retries": 2}
    out.update(kw)
    return out


# ------------------------------------------------------------- worlds
def _jobs_lifecycle(s, log):
    """tests/test_rest.py TestJobsEndpoint, TestRetrySemantics,
    TestListEndpoint, TestInstanceKill: submit, query, a cycle, status
    updates, kill and retry."""
    specs = [spec(i, name=f"job-{i}", cpus=1.0 + i % 3,
                  mem=100.0 + 37 * i, priority=10 * i) for i in range(6)]
    log.append(s.call("POST", "/jobs", {"jobs": specs[:4]}))
    log.append(s.call("POST", "/jobs", {"jobs": specs[4:]}, user="bob"))
    log.append(s.call("GET", f"/jobs/{job_uuid(0)}"))
    log.append(s.call("GET", "/jobs", params={"uuid": [job_uuid(i)
                                                       for i in (1, 4, 2)]}))
    log.append(s.call("GET", "/jobs", params={"user": "alice",
                                              "state": "waiting"}))
    log.append(s.call("GET", "/rawscheduler",
                      params={"job": [job_uuid(0), job_uuid(5)]}))
    s.advance(1_000)
    log.append(s.step())
    log.append(s.call("GET", "/jobs", params={"uuid": [job_uuid(i)
                                                       for i in range(6)]}))
    s.advance(2_000)
    s.cluster.complete_task(s.task(job_uuid(0)))
    s.cluster.fail_task(s.task(job_uuid(1)), 1003)
    log.append(s.call("GET", f"/jobs/{job_uuid(0)}"))
    log.append(s.call("GET", f"/instances/{s.task(job_uuid(2))}"))
    log.append(s.call("GET", "/list", params={"user": "alice",
                                              "state": "running+success",
                                              "limit": 5}))
    log.append(s.call("DELETE", "/jobs", params={"uuid": job_uuid(4)},
                      user="alice"))
    log.append(s.call("DELETE", "/jobs", params={"uuid": job_uuid(4)},
                      user="bob"))
    log.append(s.call("DELETE", "/instances",
                      params={"uuid": s.task(job_uuid(2))}))
    s.advance(500)
    log.append(s.call("PUT", "/retry", {"job": job_uuid(1), "retries": 5}))
    log.append(s.call("PUT", "/retry", {"job": job_uuid(1), "increment": 1}))
    log.append(s.call("PUT", "/retry", {"job": job_uuid(3), "retries": 0}))
    log.append(s.call("PUT", "/retry", {"job": job_uuid(99)}))
    log.append(s.call("PUT", "/retry", {"retries": 3}))
    s.advance(1_000)
    log.append(s.step())
    log.append(s.call("GET", "/jobs", params={"uuid": [job_uuid(i)
                                                       for i in range(6)]}))
    client = s.client()
    log.append(s.norm(client.job(job_uuid(2))))
    log.append(sorted(j["uuid"] for j in client.jobs(user="alice")))
    log.append(s.norm(client.kill([job_uuid(3)])))


def _task_constraints(m, cfg):
    cfg.task_constraints = m.TaskConstraints(
        cpus=16.0, memory_gb=4.0, max_ports=5, retry_limit=20,
        command_length_limit=1_000)


def _validation(s, log):
    """Each submission the validators refuse, with its message
    (tests/test_rest.py TestJobsEndpoint, TestTaskConstraints,
    TestExtendedJobAttrs)."""
    log.append(s.call("POST", "/jobs", {"jobs": [spec(0)]}))
    bad = [
        {"command": "a", "cpus": "x"},
        {"cpus": 1.0},
        spec(1, priority=101),
        spec(2, cpus=-1.0),
        spec(3, mem=0.0),
        spec(4, max_retries=10_000),
        spec(5, cpus=1e6),
        spec(6, uuid="not-a-uuid"),
        spec(0),
        spec(7, constraints=[["host"]]),
        spec(8, command="x" * 100_000),
        spec(9, command="a\x00b"),
        spec(10, env={"A": "b\nc"}),
        spec(11, ports=1_000),
        spec(12, uris=[{"value": "http://x", "executable": True,
                        "extract": True}]),
        spec(13, pool="no-such-pool"),
        spec(14, container={"type": "docker",
                            "docker": {"image": "i", "parameters": [
                                {"key": "privileged", "value": "true"}]}}),
        spec(15, group=group_uuid(77)),
        spec(16, gpus=-2),
    ]
    for b in bad:
        log.append(s.call("POST", "/jobs", {"jobs": [b]}))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(20), {"cpus": "x"}]}))
    log.append(s.call("GET", f"/jobs/{job_uuid(20)}"))
    log.append(s.call("POST", "/jobs", {"nope": 1}))
    log.append(s.call("POST", "/jobs", {"jobs": []}))
    log.append(s.call("GET", "/jobs/not-a-uuid"))
    log.append(s.call("GET", f"/jobs/{job_uuid(999)}"))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(30)]},
                      user="proxy", headers={"X-Cook-Impersonate": "carol"}))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(31)]},
                      user="alice", headers={"X-Cook-Impersonate": "carol"}))
    log.append(s.call("GET", f"/jobs/{job_uuid(30)}"))


def _admin_and_queue(s, log):
    """tests/test_rest.py TestAdminEndpoints, TestUnscheduledExplainer,
    TestUsageGroupBreakdown, TestInstanceStats, TestUnscheduledPartial:
    shares, quotas, the queue, the explainer, usage and task stats."""
    admin = "admin"
    log.append(s.call("POST", "/share", {"user": "alice", "pool": "default",
                                         "share": {"cpus": 4.0,
                                                   "mem": 2048.0},
                                         "reason": "t"}, user=admin))
    log.append(s.call("POST", "/share", {"user": "alice", "share": {}},
                      user="bob"))
    log.append(s.call("POST", "/quota", {"user": "bob", "pool": "default",
                                         "quota": {"cpus": 3.0, "count": 2},
                                         "reason": "t"}, user=admin))
    log.append(s.call("GET", "/share", params={"user": "alice"}))
    log.append(s.call("GET", "/quota", params={"user": "bob"}))
    jobs = [spec(i, cpus=1.0 + i % 2, mem=256.0 + i, name=f"train-{i}")
            for i in range(8)]
    log.append(s.call("POST", "/jobs", {"jobs": jobs[:5]}))
    log.append(s.call("POST", "/jobs", {"jobs": jobs[5:]}, user="bob"))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(
        20, cpus=64.0, mem=100.0)]}, user="carol"))
    s.advance(1_000)
    log.append(s.step())
    s.advance(4_000)
    for i in (0, 5):
        s.cluster.complete_task(s.task(job_uuid(i)))
    s.cluster.fail_task(s.task(job_uuid(1)), 1003)
    s.advance(1_000)
    log.append(s.call("GET", "/queue", user=admin))
    log.append(s.call("GET", "/queue", user="alice"))
    log.append(s.call("GET", "/unscheduled_jobs",
                      params={"job": [job_uuid(i) for i in (2, 6, 7, 20)]}))
    log.append(s.call("GET", "/unscheduled_jobs",
                      params={"job": [job_uuid(7), job_uuid(555)],
                              "partial": "true"}))
    log.append(s.call("GET", "/unscheduled_jobs",
                      params={"job": [job_uuid(555)]}))
    log.append(s.call("GET", "/usage", params={"user": "alice"}))
    log.append(s.call("GET", "/usage", params={"user": "bob",
                                               "group_breakdown": "true"}))
    log.append(s.call("GET", "/usage", params={"pool": "default"},
                      user=admin))
    now = s.now[0]
    for status in ("success", "failed", "running"):
        log.append(s.call("GET", "/stats/instances", params={
            "status": status, "start": str(now - 3_600_000),
            "end": str(now + 3_600_000)}, user=admin))
    log.append(s.call("GET", "/stats/instances", params={
        "status": "success", "start": str(now - 3_600_000),
        "end": str(now + 3_600_000), "name": "train-*"}, user=admin))
    log.append(s.call("GET", "/stats/instances", params={
        "status": "bogus", "start": "1", "end": "2"}, user=admin))
    log.append(s.call("GET", "/stats/instances", params={
        "status": "success", "start": "5", "end": "1"}, user=admin))
    log.append(s.call("GET", "/info"))
    log.append(s.call("GET", "/pools"))
    log.append(s.call("GET", "/failure_reasons"))
    log.append(s.call("GET", "/settings"))
    log.append(s.call("POST", "/progress/" + s.task(job_uuid(2)),
                      {"progress_percent": 50, "progress_message": "half",
                       "progress_sequence": 1}, user=None))
    log.append(s.call("GET", "/instances/" + s.task(job_uuid(2))))
    client = s.client(admin)
    log.append(s.norm(client.usage(user="alice")))
    log.append(s.norm(client.unscheduled_jobs([job_uuid(6)])))
    log.append(s.norm(client.queue()))


def _groups(s, log):
    """tests/test_rest.py TestGroupEndpoints, TestGroupSubmissionSpec and
    TestGangEndpoints."""
    g = [group_uuid(i) for i in range(4)]
    log.append(s.call("POST", "/jobs", {
        "jobs": [spec(i, group=g[0]) for i in range(2)],
        "groups": [{"uuid": g[0], "name": "mygroup"}]}))
    log.append(s.call("POST", "/jobs", {
        "jobs": [spec(10 + i, group=g[1]) for i in range(2)],
        "groups": [{"uuid": g[1], "name": "placed",
                    "host_placement": {"type": "unique"},
                    "straggler_handling": {
                        "type": "quantile-deviation",
                        "parameters": {"quantile": 0.5,
                                       "multiplier": 2.0}}}]}))
    log.append(s.call("POST", "/jobs", {
        "jobs": [spec(20 + i, group=g[2]) for i in range(3)],
        "groups": [{"uuid": g[2], "gang": {"size": 3}}]}))
    for k, gang in enumerate([{"size": 0}, {"size": "two"},
                              {"size": 2, "policy": "explode"},
                              {"size": 2, "topology": ""},
                              {"size": 2, "bogus": True}, {"size": 3}]):
        log.append(s.call("POST", "/jobs", {
            "jobs": [spec(40 + 2 * k, group=g[3]),
                     spec(41 + 2 * k, group=g[3])],
            "groups": [{"uuid": g[3], "gang": gang}]}))
    log.append(s.call("POST", "/jobs", {
        "jobs": [spec(30, group=g[3])],
        "groups": [{"uuid": g[3], "gang": {"size": 2}}]}))
    log.append(s.call("POST", "/jobs", {
        "jobs": [spec(31, group=g[3])],
        "groups": [{"uuid": g[3],
                    "host_placement": {"type": "attribute-equals"}}]}))
    log.append(s.call("POST", "/jobs", {
        "jobs": [spec(32, group=g[3])],
        "groups": [{"uuid": g[3], "host_placement": {"type": "bogus"}}]}))
    s.advance(1_000)
    log.append(s.step())
    log.append(s.call("GET", "/group", params={"uuid": g[:3]}))
    log.append(s.call("GET", "/group", params={"uuid": g[1],
                                                "detailed": "true"}))
    log.append(s.call("GET", "/group", params={"uuid": group_uuid(50)}))
    log.append(s.call("GET", "/group", params={
        "uuid": [g[0], group_uuid(50)], "partial": "true"}))
    log.append(s.call("DELETE", "/group", params={"uuid": g[1]}))
    log.append(s.call("PUT", "/retry", {"groups": [g[1]], "retries": 3}))
    log.append(s.call("GET", "/group", params={"uuid": g[1]}))
    log.append(s.norm(s.client().group([g[0]], detailed=True)))


def _basic_auth(s, log):
    """tests/test_rest.py TestAuthAndCors.test_basic_auth_verified_mode
    and tests/test_auth.py test_mixed_chain_basic_fallback."""
    good = base64.b64encode(b"alice:s3cret").decode()
    bad = base64.b64encode(b"alice:wrong").decode()
    for hdrs, user in (({}, None), ({"Authorization": f"Basic {bad}"}, None),
                       ({}, "alice"),
                       ({"Authorization": f"Basic {good}"}, None)):
        log.append(s.call("GET", "/jobs", params={"user": "alice"},
                          user=user, headers=hdrs))
        log.append(s.raw("GET", "/jobs?user=alice", user=user,
                         headers=hdrs)[1].get("WWW-Authenticate"))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(0)]}, user=None,
                      headers={"Authorization": f"Basic {good}"}))
    c = s.client("anonymous", basic_auth=("alice", "s3cret"))
    log.append(s.norm(c.job(job_uuid(0))["user"]))
    bad_client = s.client("anonymous", basic_auth=("alice", "nope"))
    with pytest.raises(s.p.client.JobClientError) as ei:
        bad_client.jobs(user="alice")
    log.append((ei.value.status, s.norm(ei.value.body)))


def _token_auth(s, log):
    """tests/test_auth.py test_token_auth_end_to_end: a token chain; no
    credentials 401, the trusted header refused, an expired or forged
    token 401, and a non-admin's admin request 403."""
    [minter] = s.api.auth_chain.authenticators
    tok = minter.mint("alice")
    hdr = {"Authorization": f"Bearer {tok}"}
    log.append(s.call("POST", "/jobs", {"jobs": [spec(0)]}, user=None,
                      headers=hdr))
    log.append(s.call("GET", f"/jobs/{job_uuid(0)}", user=None, headers=hdr))
    log.append(s.call("GET", "/jobs", user=None))
    log.append(s.call("GET", "/jobs", user="mallory"))
    log.append(s.raw("GET", "/jobs", user="mallory")[1].get(
        "WWW-Authenticate"))
    log.append(s.call("GET", "/jobs", user=None, headers={
        "Authorization": "Bearer " + minter.mint("alice", ttl_s=-1)}))
    forged = s.p.auth.HmacTokenAuthenticator("other").mint("alice")
    log.append(s.call("GET", "/jobs", user=None,
                      headers={"Authorization": f"Bearer {forged}"}))
    log.append(s.call("GET", "/queue", user=None, headers=hdr))
    log.append(s.call("POST", "/share", {"user": "alice", "share": {}},
                      user=None, headers=hdr))
    admin = {"Authorization": "Bearer " + minter.mint("admin")}
    log.append(s.call("GET", "/queue", user=None, headers=admin))
    c = s.client("anonymous", token=tok)
    log.append(s.norm(c.job(job_uuid(0))["user"]))
    with pytest.raises(s.p.client.JobClientError) as ei:
        s.client("anonymous").jobs()
    log.append((ei.value.status, s.norm(ei.value.body)))


def _http_obs(s, log):
    """tests/test_http_obs.py: request ids on success and error, unknown
    paths, the request log (redaction, totals), gzip, /debug/health."""
    status, hdrs, _ = s.raw("GET", "/info")
    log.append((status, hdrs.get("X-Cook-Request-Id")))
    log.append(s.call("GET", "/no/such/path"))
    log.append(s.call("GET", "/jobs/" + job_uuid(1)))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(0)]}))
    log.append(s.call("GET", "/jobs", params={"user": "alice",
                                              "token": "sekrit"}))
    s.settle()
    snap = s.call("GET", "/debug/requests", params={"limit": 50})
    # The slow ring holds the requests whose host-clock duration reached
    # the threshold, so which requests it holds is a host-clock reading
    # (under load either side's may hold one the other's does not).  Its
    # rule is held on each side: it is the recent requests at or over the
    # threshold, in order.  Then it leaves the comparison.
    body = snap[1]
    slow = body.pop("slow")
    threshold = body["slow_threshold_ms"]
    assert all(r["duration_ms"] >= threshold for r in slow)
    assert all(r in slow for r in body["recent"]
               if r["duration_ms"] >= threshold)
    # durations are host-clock times; the rest of each record is equal
    for rec in body["recent"]:
        for k in ("ts", "duration_ms", "phases_ms", "trace_id"):
            rec.pop(k, None)
    # The ring is in the order the handler threads recorded the requests,
    # each after its response: a request the client sent next, on another
    # connection, can be recorded first (host scheduling, on either side).
    # Its rule is held on each side: it holds every request sent before
    # the snapshot, oldest first, each at most one place from its place in
    # sending order.  Then the records are compared in request-id order.
    sent = [f"req-{k:05d}" for k in range(1, s.seq)]
    ring = [r["request_id"] for r in body["recent"]]
    assert sorted(ring) == sent, ring
    assert all(abs(sent.index(rid) - i) <= 1
               for i, rid in enumerate(ring)), ring
    body["recent"].sort(key=lambda r: r["request_id"])
    snap[1]["totals"].pop("requests_s")
    snap[1]["totals"].pop("phases_s")
    log.append(snap)
    for path in (f"/jobs/{job_uuid(0)}", "/info", "/settings"):
        gz = s.raw("GET", path, headers={"Accept-Encoding": "gzip"})
        log.append((gz[0], gz[1].get("Content-Encoding"), gz[2]))
    plain = s.raw("GET", f"/jobs/{job_uuid(0)}",
                  headers={"Accept-Encoding": "gzip;q=0"})
    log.append((plain[0], plain[1].get("Content-Encoding"), plain[2]))
    s.settle()
    status, health = s.call("GET", "/debug/health")
    # Each package's process-wide planes hold what every earlier test on
    # the same worker left there, so they are left out: the lock monitor
    # (the reference's is armed for the whole session by tests/conftest.py;
    # each side's static_edges come from its own analysis package, on a
    # background thread, and are compared on their own below), the
    # metrics registry (burn rates, the pipeline-depth gauge,
    # the repack counters) and "healthy", which reads both; the breaker
    # registry is kept for this stack's own cluster
    for k in ("locks", "slo_burn_rates", "pipeline_depth",
              "resident_repacks", "healthy"):
        health.pop(k)
    health["breakers"] = {k: v for k, v in health["breakers"].items()
                          if k == CLUSTER}
    # host-clock readings: the cycle p99 behind the saturation gauge and
    # the request log's summed durations
    health["saturation"].pop("cycle_p99")
    health["saturation_hot"] = [r for r in health["saturation_hot"]
                                if r != "cycle_p99"]
    health["http"].pop("requests_s")
    health["http"].pop("phases_s")
    log.append((status, health))


def _limits(s, log):
    """tests/test_rest.py test_submission_rate_limit and
    test_queue_limit_rejects: a submission bucket that never refills
    (429 with its reason and scope) and the per-user queue limit (422)."""
    s.sched.rate_limits.job_submission = \
        s.m.TokenBucketRateLimiter(tokens_per_minute=0.001, bucket_size=5,
                                   clock=lambda: s.now[0] / 1000.0)
    for i in range(3):
        log.append(s.call("POST", "/jobs", {"jobs": [spec(i)]}))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(3), spec(4)]}))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(10 + i)
                                                 for i in range(4)]},
                      user="bob"))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(20 + i)
                                                 for i in range(3)]},
                      user="carol"))
    log.append(s.call("POST", "/jobs", {"jobs": [spec(23)]}, user="carol"))
    with pytest.raises(s.p.client.JobClientError) as ei:
        s.client().submit([{"command": "x", "uuid": job_uuid(30)}])
    log.append((ei.value.status, ei.value.reason, ei.value.scope))
    log.append(s.step())
    # alice's queue is empty again: her bucket now runs out first
    for i in range(40, 43):
        log.append(s.call("POST", "/jobs", {"jobs": [spec(i)]}))
    with pytest.raises(s.p.client.JobClientError) as ei:
        s.client().submit([{"command": "x", "uuid": job_uuid(50)}])
    log.append((ei.value.status, ei.value.reason, ei.value.scope))


WORLDS = {
    "jobs": (_jobs_lifecycle, None),
    "validation": (_validation, lambda p: {"cfg_fn": _task_constraints}),
    "admin": (_admin_and_queue, None),
    "groups": (_groups, None),
    "basic-auth": (_basic_auth, lambda p: {
        "basic_auth_users": {"alice": "s3cret"}}),
    "token-auth": (_token_auth, lambda p: {
        "authenticators": [p.auth.HmacTokenAuthenticator("topsecret")]}),
    "http-obs": (_http_obs, None),
    "limits": (_limits, lambda p: {"per_user_limit": 3}),
}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_rest_script_parity(name):
    script, stack_kw = WORLDS[name]
    ref, port = run_both(script, stack_kw or (lambda p: {}))
    assert len(ref) > 5
    for k, (a, b) in enumerate(zip(ref, port)):
        assert b == a, (k, first_difference(a, b))
    assert len(port) == len(ref)


def first_difference(a, b, path=""):
    """The path of the first place two JSON-like values differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=str):
            if a.get(k, "<absent>") != b.get(k, "<absent>"):
                return first_difference(a.get(k, "<absent>"),
                                        b.get(k, "<absent>"), f"{path}/{k}")
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) \
            and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
    return f"{path}: {a!r} != {b!r}"


# ------------------------------------------------- the modules directly
def test_route_table_and_endpoint_template():
    ref, port = (p.api.API_ROUTES for p in SIDES)
    assert port == ref
    probes = []
    for method, path, _summary, _leader in ref:
        filled = re.sub(r"\{[^}]+\}", job_uuid(7), path)
        for m in (method, "GET", "PATCH"):
            probes += [(m, path), (m, filled), (m, filled + "/extra"),
                       (m, filled.rstrip("/") + "x")]
    probes += [("GET", "/"), ("GET", ""), ("GET", "//jobs"),
               ("POST", "/no/such/path"), ("GET", "/jobs/a/b/c")]
    got = [tuple(p.instrument.endpoint_template(m, x) for p in SIDES)
           for m, x in probes]
    assert all(a == b for a, b in got)
    assert {a for a, _ in got} > {"{unmatched}", "/jobs/{uuid}"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_redact_params_and_gzip_helpers(seed):
    rng = np.random.default_rng(seed)
    keys = ["token", "Password", "AUTHORIZATION", "secret", "uuid", "user",
            "state", "q"]
    params = {}
    for k in keys:
        n = int(rng.integers(1, 12))
        params[k] = ["x" * int(rng.integers(0, 100)) + str(i)
                     for i in range(n)]
    ref, port = (p.instrument.redact_params(params) for p in SIDES)
    assert port == ref
    assert ref["Password"][0] == "[redacted]"
    headers = [None, "", "gzip", "GZIP;q=0", "deflate, gzip;q=0.5",
               "*;q=0", "br", "gzip;q=abc", "*", " gzip ; q=1.0"]
    for h in headers:
        assert SIDES[1].instrument.wants_gzip(h) == \
            SIDES[0].instrument.wants_gzip(h), h
    data = rng.bytes(int(rng.integers(0, 5000))) + b'{"a": 1}' * 50
    assert SIDES[1].instrument.gzip_body(data) == \
        SIDES[0].instrument.gzip_body(data)


def _seeded_system(p, seed):
    """A stack with a seeded history, built through the store: four
    users with shares and quotas, a cycle, finished, failed and killed
    tasks, and jobs still waiting."""
    s = Stack(p, n_hosts=2)
    rng = np.random.default_rng(seed)
    m = s.m
    s.store.set_share("u1", "default", {"cpus": 2.0, "mem": 1024.0})
    s.store.set_quota("u2", "default", {"cpus": 3.0}, count=2.0)
    jobs = []
    for i in range(24):
        jobs.append(m.Job(
            uuid=job_uuid(i, seed), user=f"u{i % 4}", command="x",
            name=f"{'train' if i % 3 else 'serve'}-{i}",
            priority=int(rng.integers(0, 100)), max_retries=1,
            resources=m.Resources(cpus=float(rng.integers(1, 6)) + 0.25,
                                  mem=float(rng.integers(64, 3000))),
            submit_time_ms=T0 + i))
    s.store.create_jobs(jobs)
    s.advance(1_000)
    s.step()
    s.advance(int(rng.integers(1_000, 60_000)))
    running = [j for j in jobs if s.store.job(j.uuid).instances]
    for k, j in enumerate(running):
        if k % 3 == 0:
            s.cluster.complete_task(s.task(j.uuid))
        elif k % 3 == 1:
            s.cluster.fail_task(s.task(j.uuid), 1003)
    s.store.kill_job(jobs[-1].uuid)
    s.advance(5_000)
    s.sched.step_rank()
    return s, jobs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_task_stats_and_job_reasons(seed):
    out = []
    for p in SIDES:
        s, jobs = _seeded_system(p, seed)
        try:
            now = s.now[0]
            got = []
            for status in p.task_stats.ALLOWED_STATUSES:
                for window, name in (((now - 3_600_000, now + 1), None),
                                     ((T0 + 500, T0 + 2_000), None),
                                     ((now - 3_600_000, now + 1),
                                      "train-*")):
                    params = {"status": [status],
                              "start": [str(window[0])],
                              "end": [str(window[1])]}
                    if name:
                        params["name"] = [name]
                    v = p.task_stats.validate_params(params)
                    got.append(s.norm(p.task_stats.get_stats(
                        s.store, v["status"], v["start_ms"], v["end_ms"],
                        v["name_fn"], now_ms=now)))
            for bad in ({"status": ["x"]}, {"status": ["running"]},
                        {"status": ["running"], "start": ["9"],
                         "end": ["10"]},
                        {"status": ["running"], "name": ["a b"],
                         "start": [str(now)], "end": [str(now + 1)]},
                        {"status": ["running"], "start": [str(now)],
                         "end": [str(now + 40 * 86_400_000)]}):
                with pytest.raises(p.task_stats.StatsParamError) as ei:
                    p.task_stats.validate_params(bad)
                got.append(str(ei.value))
            got.append(p.task_stats.parse_time_ms(
                "2023-11-14T22:13:20Z", "start"))
            for j in jobs:
                got.append(s.norm(p.unscheduled.job_reasons(
                    s.store, s.store.job(j.uuid), scheduler=s.sched,
                    queue_limits=s.api.queue_limits)))
        finally:
            s.close()
        out.append(got)
    assert out[1] == out[0]
    assert any(r and "quota" in json.dumps(r) for r in out[0])


# ------------------------------------------------ the lock-edge diff
def test_debug_health_static_edges_equal_the_references():
    """After the same requests and cycle on each side, and once each
    package's static edge set has landed (the reference tests' wait:
    ``static_edge_families(wait=True)``), ``/debug/health`` reports the
    port's static edges equal to the reference's, with the diff against
    the observed edges beside them."""
    out = []
    for p in SIDES:
        summaries = importlib.import_module(f"{p.root}.analysis.summaries")
        s = Stack(p)
        try:
            s.call("POST", "/jobs", {"jobs": [
                {"uuid": job_uuid(i), "command": "x", "cpus": 1,
                 "mem": 64} for i in range(3)]})
            s.step()
            first = s.call("GET", "/debug/health")
            static = summaries.static_edge_families(wait=True)
            status, health = s.call("GET", "/debug/health")
        finally:
            s.close()
        assert first[0] == status == 200
        assert first[1]["locks"]["static_edges"] in ("computing", static)
        lk = health["locks"]
        assert lk["static_edges"] == static
        observed = set(lk["observed_edges"])
        assert lk["unexercised_edges"] == sorted(set(static) - observed)
        assert lk["observed_only_edges"] == sorted(observed - set(static))
        out.append(lk)
    assert out[1]["static_edges"] == out[0]["static_edges"]
    assert len(out[1]["static_edges"]) == 18
    assert out[1]["observed_only_edges"] == []
    assert "store.notify->store" in out[1]["observed_edges"]


def test_repl_dir_answers_501(tmp_path):
    """A ``repl_dir`` (the daemon sets it on a replicated node) puts the
    mirror's candidate position on ``/debug/replication``, as the
    reference does.  (The name is older than the port of
    ``state/replication``, when the port answered 501 here.)"""
    d = tmp_path / "mirror"
    d.mkdir()
    (d / "repl_token").write_text("tok")
    (d / "journal.jsonl").write_bytes(b'{"tx": 1}\n{"torn')
    (d / "repl_epoch").write_text("3")
    out = []
    for p in SIDES:
        s = Stack(p)
        try:
            s.api.repl_dir = str(d)
            out.append(s.call("GET", "/debug/replication", user="admin"))
        finally:
            s.close()
    assert out[0] == out[1]
    status, body = out[1]
    assert status == 200
    assert body["position"] == {"epoch": 3, "offset": 10, "synced": False,
                                "began": True}


def test_cluster_factory_answers_501_and_403_as_the_reference():
    """``POST /compute-clusters/{name}``: a factory off the allowlist is
    403, a non-admin is 403, and an allowlisted factory builds the
    cluster through the daemon's ``build_clusters`` as the reference
    does.  (The name is older than the port of the daemon, when the
    port answered 501 for an allowlisted factory.)"""
    out = []
    for p in SIDES:
        factory = f"{p.root}.cluster.fake.factory"

        def allow(m, cfg):
            cfg.cluster_factory_allowlist = ["fake", factory]

        s = Stack(p, cfg_fn=allow)
        try:
            out.append(s.call("POST", "/compute-clusters/extra",
                              {"factory": "not-allowed"}, user="admin"))
            out.append(s.call("POST", "/compute-clusters/extra",
                              {"factory": factory}, user="bob"))
            out.append(s.call("POST", f"/compute-clusters/{CLUSTER}",
                              {"state": "draining"}, user="admin"))
            out.append(s.call("POST", "/compute-clusters/extra",
                              {"factory": factory,
                               "kwargs": {"n_hosts": 2}}, user="admin"))
            out.append(sorted(s.sched.clusters))
            out.append(s.step())
        finally:
            s.close()
        out.append(None)
    n = len(out) // 2
    assert out[n:] == out[:n]
    assert out[0][0] == 403 and out[1][0] == 403
    assert out[3] == (200, {"name": "extra", "state": "running",
                            "created": True})


def test_cluster_factory_in_the_jax_package_is_refused():
    """The port's REST create path reaches the daemon's refusal of a
    factory in the JAX package (importing it would load JAX)."""
    def allow(m, cfg):
        cfg.cluster_factory_allowlist = ["cook_tpu.cluster.fake.factory"]

    s = Stack(SIDES[1], cfg_fn=allow)
    try:
        status, body = s.call("POST", "/compute-clusters/extra",
                              {"factory": "cook_tpu.cluster.fake.factory"},
                              user="admin")
    finally:
        s.close()
    assert status == 422
    assert "cook_tpu_torch.cluster.fake.factory" in body["error"]
