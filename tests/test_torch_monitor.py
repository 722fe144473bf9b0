"""The port's monitor plane (``sched/monitor.py``, ``sched/fleet.py``)
against the JAX package's on the CPU.

Each world is built twice from one numpy seed, once with ``cook_tpu``'s
classes and once with ``cook_tpu_torch``'s, with a virtual store clock.
Each side's ``Monitor`` publishes into a fresh ``MetricsRegistry`` of
its own package; the sweep's returned counts and the whole registry
exposition (the per-user resource, DRU and state-count families with the
folded ``other`` bucket, the SLO series, the queue-age and wait-phase
histograms, the saturation gauges) must be equal, as text.  The cycle
durations the SLO and ``cycle_p99`` read come from each package's flight
recorder; both are given the same durations.  The worlds are the
reference's own (``tests/test_monitor.py``, ``tests/test_fleet_obs.py``),
seeded ones, and ``Scheduler`` worlds after a few cycles.
"""

import importlib
import types

import numpy as np
import pytest

from test_torch_driver import PORT, REF
from test_torch_scheduler import WORLDS, make_world, step


def pkg(m):
    """The modules of one package the tests drive."""
    root = m.root
    ns = types.SimpleNamespace(m=m)
    for name, mod in (("monitor", "sched.monitor"), ("fleet", "sched.fleet"),
                      ("metrics", "utils.metrics"), ("flight", "utils.flight"),
                      ("audit", "utils.audit"),
                      ("instrument", "rest.instrument"),
                      ("rate_limit", "policy.rate_limit")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


SIDES = (pkg(REF), pkg(PORT))

# cycle durations (ms) both flight recorders report to the sweep
DURATIONS = [120.0, 940.0, 1650.0, 300.0, 2100.0, 80.0, 999.0]


def fresh_request_log(p):
    """Put one package's ``request_log`` singleton into its whole default
    state: a file run earlier on the same worker may have left it
    configured (ring lengths, ``slow_ms``) or switched off (``enabled``,
    and ``capture``, which a brownout turns off), and ``reset()`` alone
    clears only the rings and totals."""
    log = p.instrument.request_log
    log.configure(p.m.HttpConfig())
    log.enabled = True
    log.capture = True
    log.reset()


@pytest.fixture(autouse=True)
def _same_cycle_history(monkeypatch):
    for p in SIDES:
        monkeypatch.setattr(
            p.flight.recorder, "recent_durations",
            lambda kinds, limit: DURATIONS[-limit:] if limit > 0 else [])
        fresh_request_log(p)
    yield
    for p in SIDES:
        fresh_request_log(p)


def job(m, uuid, user, cpus=1.0, mem=100.0, pool="default", gpus=0.0,
        submit=1000):
    return m.Job(uuid=uuid, user=user, command="x", pool=pool,
                 resources=m.Resources(cpus=cpus, mem=mem, gpus=gpus),
                 submit_time_ms=submit)


def run_job(m, store, uuid, host="h0"):
    store.launch_instance(uuid, f"task-{uuid}", host)
    store.update_instance_status(f"task-{uuid}", m.InstanceStatus.RUNNING)


def both(build, sweeps=1, between=None, config=None):
    """``build(m, store)`` on both packages, then ``sweeps`` monitor
    sweeps (``between(m, store, i)`` after sweep i).  Returns each
    side's (sweep results, exposition after each sweep)."""
    out = []
    for p in SIDES:
        m = p.m
        store = m.Store()
        now = [2_000_000]
        store.clock = lambda: now[0]
        store.put_pool(m.Pool(name="default"))
        build(m, store)
        reg = p.metrics.MetricsRegistry()
        cfg = config(m) if config else None
        mon = p.monitor.Monitor(store, reg, config=cfg)
        res, texts = [], []
        for i in range(sweeps):
            res.append(mon.sweep())
            texts.append(reg.expose())
            if between is not None:
                between(m, store, i)
            now[0] += 45_000
        out.append((res, texts))
    return out


# ----------------------------------------------- the reference's worlds
def _classification(m, store):
    store.create_jobs([job(m, "a1", "alice", cpus=4),
                       job(m, "a2", "alice", cpus=1)])
    run_job(m, store, "a1")
    store.set_share("alice", "default", {"cpus": 2.0, "mem": 1e9})
    store.create_jobs([job(m, "b1", "bob", cpus=1)])
    store.set_share("bob", "default", {"cpus": 10.0, "mem": 1e9})
    store.create_jobs([job(m, "c1", "carol", cpus=1)])
    run_job(m, store, "c1")


def _under_quota_count(m, store):
    store.create_jobs([job(m, "q1", "erin"), job(m, "q2", "erin")])
    run_job(m, store, "q1")
    store.set_quota("erin", "default", {"cpus": 100.0, "mem": 1e9},
                    count=1)


def _stale_zeroed(m, store):
    store.create_jobs([job(m, "g1", "frank")])


def _kill_frank(m, store, i):
    if i == 0:
        store.kill_job("g1")


REFERENCE_WORLDS = {
    "classification": (_classification, None),
    "waiting_under_quota_count": (_under_quota_count, None),
    "stale_series_zeroed": (_stale_zeroed, _kill_frank),
}


@pytest.mark.parametrize("name", sorted(REFERENCE_WORLDS))
def test_sweep_parity_on_reference_worlds(name):
    build, between = REFERENCE_WORLDS[name]
    (ra, ta), (rb, tb) = both(build, sweeps=2, between=between)
    assert ra == rb
    assert ta == tb
    assert "cook_user_resource" in tb[0] and "cook_saturation" in tb[0]


def test_starvation_amount_parity():
    out = []
    for p in SIDES:
        m = p.m
        store = m.Store()
        store.put_pool(m.Pool(name="default"))
        store.create_jobs([job(m, "r1", "dave", cpus=2),
                           job(m, "w1", "dave", cpus=8)])
        run_job(m, store, "r1")
        store.set_share("dave", "default", {"cpus": 5.0, "mem": 1e9})
        store.set_quota("dave", "default", {"cpus": 6.0}, count=4)
        running = {"dave": {"cpus": 2.0, "mem": 100.0, "jobs": 1.0}}
        waiting = {"dave": {"cpus": 8.0, "mem": 100.0, "jobs": 1.0}}
        out.append((
            p.monitor.compute_starved_stats(store, "default", running,
                                            waiting),
            p.monitor.compute_waiting_under_quota_stats(
                store, "default", running, waiting),
            p.monitor._job_stats([("dave", 2.0, 100.0), ("eve", 1.5, 3.0),
                                  ("dave", 0.5, 1.0)])))
    assert out[0] == out[1]
    assert out[1][0]["dave"]["cpus"] == 3.0


# ----------------------------------------------------- seeded worlds
def _seeded(seed, n_users, gpu_pool):
    def build(m, store):
        rng = np.random.default_rng(seed)
        if gpu_pool:
            store.put_pool(m.Pool(name="gpu", dru_mode=m.DruMode.GPU))
        jobs, run = [], []
        for i in range(n_users * 4):
            user = f"u{int(rng.integers(0, n_users)):02d}"
            pool = "gpu" if gpu_pool and i % 3 == 0 else "default"
            j = job(m, f"00000000-0000-0000-0000-{i:012d}", user,
                    cpus=float(rng.integers(1, 9)) + 0.5,
                    mem=float(rng.integers(64, 4096)), pool=pool,
                    gpus=float(rng.integers(1, 3)) if pool == "gpu" else 0.0,
                    submit=1_000 + int(rng.integers(0, 1_900_000)))
            jobs.append(j)
            if rng.random() < 0.45:
                run.append(j.uuid)
        store.create_jobs(jobs)
        for k, u in enumerate(run):
            run_job(m, store, u, host=f"h{k % 7}")
        for u in range(n_users):
            user = f"u{u:02d}"
            if rng.random() < 0.6:
                store.set_share(user, "default",
                                {"cpus": float(rng.integers(2, 40)),
                                 "mem": float(rng.integers(512, 40_000))})
            if gpu_pool and rng.random() < 0.6:
                store.set_share(user, "gpu",
                                {"gpus": float(rng.integers(1, 6))})
            if rng.random() < 0.4:
                store.set_quota(user, "default",
                                {"cpus": float(rng.integers(4, 60))},
                                count=float(rng.integers(1, 8)))
        # skip reasons on some waiting jobs: the wait-phase split
        audit = importlib.import_module(f"{m.root}.utils.audit")
        waiting = [j.uuid for j in jobs if j.uuid not in set(run)]
        reasons = sorted(audit.FAIRNESS_REASONS)[:2] + \
            sorted(audit.CONSTRAINT_REASONS)[:1] + ["unmatched"]
        picks = rng.integers(0, len(reasons) + 1, len(waiting))
        mapping = {r: [u for u, k in zip(waiting, picks) if k == n]
                   for n, r in enumerate(reasons)}
        audit.note_skips(store.audit, mapping, pool="default")
    return build


def _seeded_between(m, store, i):
    """Between sweeps: a user's jobs finish, another's are killed."""
    running = store.running_instances()
    for _job, inst in running[:3]:
        store.update_instance_status(inst.task_id, m.InstanceStatus.SUCCESS)
    waiting = store.pending_jobs("default")
    for j in waiting[:2]:
        store.kill_job(j.uuid)


def _small_fold(m):
    cfg = m.Config()
    cfg.slo.max_user_series = 5
    return cfg


@pytest.mark.parametrize("seed,n_users,gpu_pool,fold", [
    (0, 4, False, False), (1, 30, False, True), (2, 30, True, True),
    (3, 12, True, False)])
def test_sweep_parity_on_seeded_worlds(seed, n_users, gpu_pool, fold):
    (ra, ta), (rb, tb) = both(_seeded(seed, n_users, gpu_pool), sweeps=3,
                              between=_seeded_between,
                              config=_small_fold if fold else None)
    assert ra == rb
    assert ta == tb
    if fold:
        assert 'user="other"' in tb[0]
    assert 'cook_wait_phase_jobs{phase="constraints"' in tb[0]


def test_http_slo_parity():
    """The endpoint-latency SLO reads each package's ``request_log``: the
    same requests on both sides give the same burn series, and a quiet
    endpoint is re-published at 0 on the next sweep."""
    texts = []
    for p in SIDES:
        m = p.m
        store = m.Store()
        store.clock = lambda: 5_000
        store.put_pool(m.Pool(name="default"))
        reg = p.metrics.MetricsRegistry()
        mon = p.monitor.Monitor(store, reg)
        log = p.instrument.request_log
        for k, (ep, dur) in enumerate([("/jobs", 0.2), ("/jobs", 3.5),
                                       ("/queue", 0.1), ("/jobs", 0.4)]):
            log.begin()
            log.end(method="GET", endpoint=ep, status=200, duration_s=dur,
                    phases={"journal.append": 0.01}, params={"a": ["1"]},
                    request_id=f"r{k}", trace_id=None, user="u",
                    bytes_in=10, bytes_out=20, objective_s=1.0)
        mon.sweep()
        first = reg.expose()
        mon.sweep()
        texts.append((first, reg.expose(), log.snapshot(limit=0)))
    assert texts[0] == texts[1]
    assert 'endpoint="/jobs"' in texts[1][0]


# --------------------------------------------------------- saturation
def _saturation_inputs(p, depth):
    m = p.m
    store = m.Store()
    store.clock = lambda: 7_000
    store.put_pool(m.Pool(name="default"))
    store.create_jobs([job(m, f"j{i}", "alice") for i in range(4)])
    for i in range(depth):
        store.audit.record(f"j{i % 4}", "note", {"i": i}, durable=True)
    lim = p.rate_limit.TokenBucketRateLimiter(
        tokens_per_minute=0.0001, bucket_size=10, clock=lambda: 50.0)
    lim.spend("default/alice", 4)
    lim.spend("default/bob", 9)
    rl = m.RateLimits(job_launch=lim)

    class ReadView:
        def age_ms(self):
            return 1_250.0

    return store, rl, ReadView()


@pytest.mark.parametrize("audit_depth", [0, 37])
def test_saturation_parity(audit_depth):
    out = []
    for p in SIDES:
        cfg = p.m.Config()
        cfg.fleet.audit_queue_red_line = 100
        cfg.fleet.staleness_red_line_seconds = 5.0
        store, rl, view = _saturation_inputs(p, audit_depth)
        got = [p.fleet.compute_saturation(cfg),
               p.fleet.compute_saturation(cfg, store=store, read_view=view,
                                          rate_limits=rl)]
        reg = p.metrics.MetricsRegistry()
        p.fleet.publish_saturation(got[1], reg)
        p.fleet.publish_saturation({"cycle_p99": 3.7, "audit_queue": -2.0,
                                    "launch_tokens": float("nan")}, reg)
        out.append((got, reg.expose()))
    assert out[0] == out[1]
    sat = out[1][0][1]
    assert sat["launch_tokens"] == pytest.approx(0.9)
    assert sat["audit_queue"] == pytest.approx(audit_depth / 100)
    assert sat["follower_staleness"] == pytest.approx(0.25)
    assert 0 < sat["cycle_p99"] <= 1


# ------------------------------------------------------------- storage
def _journaled(m, path):
    store = m.Store.open(str(path))
    store.put_pool(m.Pool(name="default"))
    store.create_jobs([job(m, "s1", "alice")])
    return store


def test_storage_scrub_cadence_and_switch_parity(tmp_path):
    """The scrub step advances each side's frontier to its journal's
    end, a long interval gates the second sweep, and the disable switch
    never scrubs; every step publishes the same gauge on both sides."""
    out = []
    for p in SIDES:
        m = p.m
        store = _journaled(m, tmp_path / m.root)
        try:
            run_job(m, store, "s1")
            steps = []
            cfg = m.Config()
            cfg.storage.scrub_interval_seconds = 3600.0
            reg = p.metrics.MetricsRegistry()
            mon = p.monitor.Monitor(store, reg, config=cfg)
            mon.sweep()
            st = store.storage_stats()
            steps.append(st["scrub_verified_offset"] == st["journal_bytes"])
            first = st["scrub_verified_offset"]
            store.create_jobs([job(m, "s2", "alice")])
            mon.sweep()
            steps.append(store.storage_stats()["scrub_verified_offset"]
                         == first)
            off = m.Config()
            off.storage.scrub_enabled = False
            off.storage.scrub_interval_seconds = 0.0
            reg2 = p.metrics.MetricsRegistry()
            p.monitor.Monitor(store, reg2, config=off).sweep()
            steps.append(store.storage_stats()["scrub_verified_offset"]
                         == first)
            steps.append("cook_storage_scrub_offset_bytes" in reg.expose())
            steps.append("cook_storage_scrub_offset_bytes" in reg2.expose())
            out.append(steps)
        finally:
            store.close()
    assert out[0] == out[1] == [True, True, True, True, False]


# ----------------------------------------------------- scheduler worlds
@pytest.mark.parametrize("name", ["plain", "two_pools", "offensive"])
def test_scheduler_monitor_parity(name):
    """``Scheduler.monitor`` after cycles of a scheduled world: the same
    counts and the same exposition (DRU from real usage, wait phases from
    the cycles' own skip reasons and placement failures, launch tokens
    from the scheduler's limiter)."""
    spec = WORLDS[name]
    sides = [make_world(m, spec, depth=0) for m in (REF, PORT)]
    regs = []
    for p, w in zip(SIDES, sides):
        reg = p.metrics.MetricsRegistry()
        w.sched.monitor = p.monitor.Monitor(w.store, reg, config=w.cfg)
        w.sched.monitor.rate_limits = w.sched.rate_limits
        regs.append(reg)
    for c in range(3):
        res = [w.sched.monitor.sweep() for w in sides]
        assert res[0] == res[1], f"sweep {c}"
        assert regs[0].expose() == regs[1].expose(), f"sweep {c}"
        for w in sides:
            step(w)
            w.churn(4)
            w.now[0] += 30_000


# ------------------------------------------------------- federation
def _fetch(expositions):
    def fetch(url, timeout_s):
        base = url.split("/metrics")[0].split("/debug")[0]
        body = expositions[base]
        if isinstance(body, Exception):
            raise body
        return body
    return fetch


def _members(*urls, roles=None):
    return {f"m{i}": {"url": u, "role": (roles or {}).get(f"m{i}", "member")}
            for i, u in enumerate(urls)}


def _burn(p, v):
    return p.metrics.format_sample(
        "cook_slo_burn_rate", {"slo": "queue-latency", "pool": "default"},
        v) + "\n"


# name -> (FleetConfig kwargs, members, member -> exposition); each
# exposition is a function of the package (its format_sample)
FLEET_CASES = {
    "relabel": ({}, _members("http://a", "http://b",
                             roles={"m0": "leader", "m1": "follower"}),
                lambda p: {"http://a": "cook_jobs_waiting 3\n",
                           "http://b": "cook_jobs_waiting 7\n"}),
    "label_collision": ({}, _members("http://a"), lambda p: {
        "http://a": p.metrics.format_sample(
            "cook_remote", {"instance": "z9", "role": "leader"}, 1.0)
        + "\n"}),
    "unreachable": ({}, _members("http://up", "http://down"), lambda p: {
        "http://up": "cook_x 1\n",
        "http://down": ConnectionError("refused")}),
    "series_cap": ({"max_series_per_member": 10}, _members("http://a"),
                   lambda p: {"http://a": "".join(
                       f'cook_s{{i="{i}"}} 1\n' for i in range(50))}),
    "burn_max": ({}, _members("http://a", "http://b"), lambda p: {
        "http://a": _burn(p, 0.5), "http://b": _burn(p, 2.0)}),
    "max_members": ({"max_members": 2},
                    _members(*[f"http://h{i}" for i in range(5)]),
                    lambda p: {f"http://h{i}": "cook_x 1\n"
                               for i in range(5)}),
    "saturation_and_staleness": ({}, _members("http://a", "http://b"),
                                 lambda p: {
        "http://a": 'cook_saturation{resource="cycle_p99"} 0.9\n'
                    'cook_saturation{resource="audit_queue"} 0.1\n',
        "http://b": "cook_follower_staleness_seconds 3.5\n"}),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_scraper_parity(case):
    kw, members, bodies = FLEET_CASES[case]
    out = []
    for p in SIDES:
        cfg = p.m.FleetConfig(scrape_interval_seconds=0.01, **kw)
        reg = p.metrics.MetricsRegistry()
        scraper = p.fleet.FleetScraper(cfg, lambda: dict(members),
                                       fetch=_fetch(bodies(p)), registry=reg)
        records = scraper.scrape(now=100.0)
        out.append((records, scraper.merged_exposition(now=100.0),
                    scraper.fleet_doc(now=100.0), reg.expose()))
    assert out[0] == out[1]


def test_fleet_scraper_gates_and_folds_parity():
    """``maybe_scrape``'s interval gate and the instance cardinality
    guard over a churning membership."""
    out = []
    for p in SIDES:
        reg = p.metrics.MetricsRegistry()
        calls = []
        gated = p.fleet.FleetScraper(
            p.m.FleetConfig(scrape_interval_seconds=100.0),
            lambda: calls.append(1) or {}, registry=reg)
        gates = [gated.maybe_scrape(now=t) for t in (1000.0, 1001.0, 1101.0)]
        current = {}
        churn = p.fleet.FleetScraper(
            p.m.FleetConfig(scrape_interval_seconds=0.01, max_members=1),
            lambda: dict(current), fetch=_fetch({"http://a": "cook_x 1\n"}),
            registry=reg)
        for i in range(40):
            current.clear()
            current[f"churn-{i:03d}"] = {"url": "http://a"}
            churn.scrape(now=100.0 + i)
        out.append((gates, len(calls), reg.expose()))
    assert out[0] == out[1]
    assert out[1][0] == [True, False, True]
    assert 'instance="other"' in out[1][2]


def test_collect_trace_parity():
    local = [{"span": "a", "trace_id": "t", "span_id": "l1",
              "proc": "leader", "start": 1.0, "duration_ms": 1.0}]
    remote = ('{"spans": [{"span": "b", "trace_id": "t", "span_id": "r1", '
              '"proc": "follower", "start": 1.0, "duration_ms": 1.0}, '
              '{"span": "a", "trace_id": "t", "span_id": "l1", '
              '"proc": "leader", "start": 1.0, "duration_ms": 1.0}]}')

    def fetch(url, timeout_s):
        if "dead" in url:
            raise OSError("down")
        return remote

    members = {"f1": {"url": "http://f1"}, "f2": {"url": "http://dead"},
               "f3": {}}
    out = [p.fleet.collect_trace("t", members, fetch=fetch,
                                 local_spans=list(local)) for p in SIDES]
    assert out[0] == out[1]
    assert {d["span_id"] for d in out[1][0]} == {"l1", "r1"}
