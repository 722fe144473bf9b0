"""The goodput optimizer (``cook_tpu_torch/sched/optimizer.py``) and the
``Scheduler``'s optimizer plane against the JAX package's on the CPU.

Each world is built in both packages from one seed, with fixed job
uuids, fixed submit times and a pinned store clock, so ``now_ms`` and
every duration estimate are the same on both sides and the decisions,
``scores`` included, compare exactly (as ``PoolDecision.to_dict()``).
The elastic shrink sheds the newest of the members launched in one
cycle, a tie that the random task ids break in either package; the
tests draw ``uuid.uuid4`` from a counter, so task ids follow launch
order on both sides and the replays are deterministic.
The port's replays run on the scheduler's device (the CPU here); the
reference's on its numpy goldens.  Modelled on the reference's
``tests/test_optimizer.py`` and ``tests/test_elastic.py``.
"""

import dataclasses
import json
import os
import threading
import time

import pytest

import cook_tpu.sched
import cook_tpu.sched.optimizer as ropt
import cook_tpu_torch.sched
import cook_tpu_torch.sched.optimizer as popt
from test_torch_driver import PORT, REF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = {REF.root: ropt, PORT.root: popt}
T0 = 1_000_000


def registry(m):
    import importlib
    return importlib.import_module(f"{m.root}.utils.metrics").registry


@pytest.fixture(autouse=True)
def _ordered_task_ids(monkeypatch):
    import itertools
    import uuid
    counter = itertools.count(1)
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=next(counter), version=4))


@pytest.fixture(autouse=True)
def _fresh_registries():
    for m in (REF, PORT):
        registry(m).reset()
    yield
    for m in (REF, PORT):
        registry(m).reset()


def system(m, n_hosts=3, cpus=4.0, opt_conf=None, shares=None):
    """The reference's ``tests/test_elastic.make_system`` (split cycle,
    cpu backends, entity pack) with a pinned clock and an optimizer."""
    cfg = m.Config()
    cfg.cycle_mode = "split"
    cfg.pipeline.depth = 0
    cfg.elastic.shrink_grace_seconds = 0.0
    cfg.default_matcher.backend = "cpu"
    cfg.columnar_index = False
    conf = {"max_replay_jobs": 40, "grow_budgets": [0, 2, None],
            "shrink_pressures": [0, 2], "replay_horizon_seconds": 60.0,
            "default_duration_ms": 5000}
    conf.update(opt_conf or {})
    cfg.optimizer = OPT[m.root].OptimizerConfig(optimizer_config=conf)
    store = m.Store()
    now = [T0]
    store.clock = lambda: now[0]
    hosts = [m.FakeHost(f"h{i}", m.Resources(cpus=cpus, mem=4096.0))
             for i in range(n_hosts)]
    cluster = m.FakeCluster("fake", hosts)
    if m is REF:
        sched = cook_tpu.sched.Scheduler(store, cfg, [cluster],
                                         rank_backend="cpu")
    else:
        sched = cook_tpu_torch.sched.Scheduler(store, cfg, [cluster],
                                               rank_backend="cpu",
                                               device="cpu")
    for user, share in (shares or {}).items():
        store.set_share(user, "default", share)
    return store, cluster, sched, now


def gang(m, store, guuid="g1", size=6, lo=2, cpus=4.0, at=0):
    group = m.Group(uuid=guuid, gang=True, gang_size=size, gang_min=lo,
                    gang_max=size, jobs=[])
    jobs = [m.Job(uuid=f"{guuid}-m{i}", user="train", command="x",
                  max_retries=5, resources=m.Resources(cpus=cpus, mem=1024.0),
                  group=guuid, submit_time_ms=T0 - 60_000 + at + i)
            for i in range(size)]
    group.jobs = [j.uuid for j in jobs]
    store.create_jobs(jobs, groups=[group])
    return jobs


def batch(m, store, n, user="batch", cpus=1.3, at=0):
    jobs = [m.Job(uuid=f"{user}-{i}", user=user, command="x",
                  max_retries=3, resources=m.Resources(cpus=cpus, mem=512.7),
                  submit_time_ms=T0 - 30_000 + at + i) for i in range(n)]
    store.create_jobs(jobs)
    return jobs


def step(sched):
    sched.step_rank()
    return sched.step_match()


def elastic_world(m):
    """An elastic gang (6 of 4 cpus, min 2) beside batch jobs on three
    4-cpu hosts; two cycles with a finished batch task between them."""
    store, cluster, sched, now = system(m)
    batch(m, store, 3)
    gang(m, store)
    step(sched)
    now[0] += 20_000
    done = sorted(t for t, _j in _running(store) if
                  store.instance(t).job_uuid.startswith("batch"))
    if done:
        cluster.complete_task(done[0])
    step(sched)
    now[0] += 10_000
    return store, cluster, sched, now


def _running(store):
    return [(inst.task_id, job) for job, inst in store.running_instances()]


def over_share_world(m):
    """No elastic gang (one baseline replay): a user over its share (DRU
    >= 1 on the live fairness plane, which biases the unfairness
    penalty), a second user arriving behind it, and a third whose jobs
    no host can hold, so the replay leaves demand unplaced and the
    decision asks for more hosts."""
    store, cluster, sched, now = system(
        m, n_hosts=2, opt_conf={"replay_horizon_seconds": 120.0},
        shares={"alice": {"cpus": 0.5, "mem": 256.0},
                "bob": {"cpus": 64.0, "mem": 65536.0}})
    batch(m, store, 6, user="alice", cpus=2.1)
    step(sched)
    now[0] += 60_000
    batch(m, store, 5, user="bob", cpus=1.7, at=100)
    batch(m, store, 2, user="carol", cpus=6.0, at=200)
    sched.monitor.sweep()
    return store, cluster, sched, now


WORLDS = {"elastic": elastic_world, "over_share": over_share_world}


def decisions_of(decisions):
    return {pool: d.to_dict() for pool, d in decisions.items()}


def schedule_of(schedule):
    """The legacy Schedule, comparable across packages."""
    out = {}
    for period, s in (schedule or {}).items():
        out[period] = sorted(
            ((dataclasses.astuple(h), tuple(u))
             for h, u in s["suggested-matches"].items()))
    return out


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_optimize_decisions_match_the_reference(name):
    got = []
    for m in (REF, PORT):
        store, cluster, sched, now = WORLDS[name](m)
        cyc = sched._ensure_optimizer()
        d = cyc.optimizer.optimize(sched)
        got.append((decisions_of(d), schedule_of(
            cyc.optimizer.produce_schedule(
                [j for q in sched.pending_queues.values() for j in q],
                [], [], []))))
    assert got[0] == got[1]
    assert got[1][0], "no decision"


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_step_optimize_applies_as_the_reference(name):
    """The applied levers: grow budget, shrink pressure (and the shed it
    starts), the rebalancer's dynamic ``max_preemption``, the
    ``cook_pool_goodput`` gauge and the durable ``optimizer-decision``
    facts on every elastic member's timeline."""
    got = []
    for m in (REF, PORT):
        store, cluster, sched, now = WORLDS[name](m)
        d = sched.step_optimize()
        timeline = {}
        for group in store.elastic_gang_groups():
            for u in group.jobs:
                timeline[u] = [e.get("facts", e) for e in
                               store.audit.timeline(u)
                               if e["kind"] == "optimizer-decision"]
        gauge = [v for lab, v in registry(m).series("cook_pool_goodput")]
        live = sorted((store.instance(t).job_uuid,
                       store.instance(t).status.name)
                      for t, _j in _running(store))
        got.append(dict(
            decisions=decisions_of(d),
            grow=dict(sched.elastic.grow_budget),
            shrink=dict(sched.elastic.shrink_pressure),
            dynamic=store.dynamic_config("rebalancer"),
            gauge=gauge, timeline=timeline, live=live,
            cycles=sched.optimizer_cycler.cycles))
    assert got[0] == got[1]
    assert got[1]["gauge"], "no goodput gauge"
    if name == "elastic":
        assert any(got[1]["timeline"].values())


def test_over_share_world_asks_for_hosts():
    store, cluster, sched, now = over_share_world(PORT)
    assert max(store.audit.user_dru_table("default").values()) >= 1.0
    d = sched.step_optimize()["default"]
    assert d.candidates == 1 and d.grow_budget is None
    assert d.autoscale_hosts > 2
    schedule = sched.optimizer_cycler.last_schedule
    (info, uuids), = schedule[0]["suggested-matches"].items()
    assert info.count == d.autoscale_hosts - 2
    assert uuids


def test_no_shrink_decision_revokes_standing_pressure():
    """The reference's ``test_no_shrink_decision_revokes_standing_
    pressure`` on both packages."""
    for m in (REF, PORT):
        store, cluster, sched, now = system(m, n_hosts=6)
        sched.elastic.shrink_pressure["default"] = 2
        d = OPT[m.root].PoolDecision(
            pool="default", grow_budget=None, shrink_pressure=0,
            preemption_budget=None, autoscale_hosts=6,
            predicted_goodput=1.0, current_goodput=1.0, objective=1.0,
            replayed_jobs=0, candidates=1)
        cyc = type("C", (), {"cycles": 1})()
        sched._apply_optimizer_decisions({"default": d}, cyc)
        assert "default" not in sched.elastic.shrink_pressure


def test_replays_do_not_pollute_metrics():
    store, cluster, sched, now = elastic_world(PORT)
    reg = registry(PORT)

    def resize_count():
        return sum(v for (n, _l), v in reg._counters.items()
                   if n == "cook_gang_resize")
    before = resize_count()
    sched.step_optimize()
    assert resize_count() == before


def test_run_starts_the_optimizer_immediately():
    """``run``'s optimizer loop cycles at once, not after a full
    interval (3,600 s here), as the reference's does."""
    for m in (REF, PORT):
        store, cluster, sched, now = system(m)
        sched.config.optimizer.interval_seconds = 3600.0
        for attr in ("rank_interval_seconds", "match_interval_seconds",
                     "monitor_interval_seconds",
                     "lingering_task_interval_seconds"):
            setattr(sched.config, attr, 3600.0)
        gang(m, store, size=4)
        step(sched)
        sched.run()
        try:
            deadline = time.time() + 30.0
            while sched.optimizer_cycler is None \
                    or sched.optimizer_cycler.cycles < 1:
                assert time.time() < deadline, \
                    f"{m.root}: the optimizer never cycled after run()"
                time.sleep(0.02)
        finally:
            sched.shutdown()
        assert sched.optimizer_cycler.last_error is None


def test_step_optimize_without_a_config_is_a_no_op():
    for m in (REF, PORT):
        store, cluster, sched, now = system(m)
        sched.config.optimizer = None
        assert sched.step_optimize() == {}
        assert sched.optimizer_cycler is None


# ------------------------------------------------------- configuration
PROD = json.load(open(os.path.join(REPO, "examples",
                                   "cook-production.json")))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(cfg)}


def test_from_conf_defaults_name_the_port():
    cfg = popt.OptimizerConfig()
    assert cfg.host_feed_create_fn == \
        "cook_tpu_torch.sched.optimizer.DummyHostFeed"
    assert cfg.optimizer_create_fn == \
        "cook_tpu_torch.sched.optimizer.GoodputOptimizer"
    cyc = cfg.build()
    assert isinstance(cyc.optimizer, popt.GoodputOptimizer)
    assert isinstance(cyc.host_feed, popt.DummyHostFeed)


def test_from_conf_of_the_production_section_matches_the_reference():
    section = PROD["scheduler"]["optimizer"]
    ref = ropt.OptimizerConfig.from_conf(json.loads(json.dumps(section)))
    got = popt.OptimizerConfig.from_conf(json.loads(json.dumps(section)))
    a, b = _fields(ref), _fields(got)
    for k in ("host_feed_create_fn", "optimizer_create_fn"):
        assert b[k] == "cook_tpu_torch" + a.pop(k)[len("cook_tpu"):]
        b.pop(k)
    assert a == b
    ra, pa = ref.build().optimizer, got.build().optimizer
    assert vars(ra) == vars(pa)
    assert got.interval_seconds == 60.0


REJECTED = {
    "unknown_key": {"intervall_seconds": 30},
    "interval_zero": {"interval_seconds": 0},
    "interval_negative": {"interval_seconds": -3},
    "unknown_goodput_key": {"optimizer_config": {"grow_budget": [1]}},
    "bad_grow_budget": {"optimizer_config": {"grow_budgets": ["x"]}},
    "bad_factory_path": {"optimizer_create_fn": "nodots"},
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_from_conf_rejections_match_the_reference(name):
    out = []
    for mod in (ropt, popt):
        try:
            mod.OptimizerConfig.from_conf(json.loads(json.dumps(
                REJECTED[name])))
            out.append(("ok", ""))
        except Exception as e:
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]
    assert out[0][0] == "ValueError"


@pytest.mark.parametrize("key", ["optimizer_create_fn",
                                 "host_feed_create_fn"])
def test_a_factory_in_the_jax_package_is_refused(key):
    with pytest.raises(ValueError, match="cook_tpu_torch.sched.optimizer"):
        popt.OptimizerConfig.from_conf(
            {key: "cook_tpu.sched.optimizer.GoodputOptimizer"})


def test_cycler_first_cycle_is_immediate():
    cyc = popt.OptimizerCycler(popt.DummyHostFeed(), popt.DummyOptimizer(),
                               interval_seconds=3600.0)
    cyc.start(lambda: [], lambda: [])
    deadline = time.time() + 5.0
    while cyc.last_schedule is None and time.time() < deadline:
        time.sleep(0.01)
    cyc.stop()
    assert cyc.last_schedule == {0: {"suggested-matches": {}}}
    assert cyc.cycles >= 1


def test_cycler_swallows_errors_like_the_reference():
    class Boom(popt.Optimizer):
        def produce_schedule(self, *a):
            raise RuntimeError("boom")
    cyc = popt.OptimizerCycler(popt.DummyHostFeed(), Boom())
    assert cyc.run_cycle(lambda: [], lambda: []) is None
    assert isinstance(cyc.last_error, RuntimeError)
    assert cyc.cycles == 1


def test_schedule_validation_matches_the_reference():
    cases = [None, {-1: {}}, {0: {}}, {0: {"suggested-matches": []}},
             {0: {"suggested-matches": {"h": []}}},
             {0: {"suggested-matches": {}}}]
    for case in cases:
        out = []
        for mod in (ropt, popt):
            try:
                mod.validate_schedule(case)
                out.append("ok")
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1], case
    for mod in (ropt, popt):
        with pytest.raises(ValueError):
            mod.validate_schedule({0: {"suggested-matches": {
                mod.HostInfo(count=-1, instance_type="x", cpus=1, mem=1):
                    []}}})


def test_optimizer_cycle_passes_queue_and_hosts():
    seen = {}

    class Spy(popt.Optimizer):
        def produce_schedule(self, queue, running, available, host_infos):
            seen.update(queue=queue, running=running, infos=host_infos)
            return {0: {"suggested-matches": {}}}

    class Feed(popt.HostFeed):
        def get_available_host_info(self):
            return [popt.HostInfo(count=2, instance_type="m", cpus=4.0,
                                  mem=8.0)]
    out = popt.optimizer_cycle(lambda: ["j1"], lambda: ["r1"], lambda: [],
                               Feed(), Spy())
    assert out == {0: {"suggested-matches": {}}}
    assert seen["queue"] == ["j1"] and seen["running"] == ["r1"]
    assert seen["infos"][0].count == 2


def test_daemon_builds_the_optimizer_section():
    """``build_scheduler_config`` takes the section through
    ``OptimizerConfig.from_conf`` (boot-validated), as the reference's
    does; a Scheduler built from it cycles."""
    from cook_tpu_torch import daemon
    spec = {"optimizer": {"interval_seconds": 5.0, "optimizer_config": {
        "max_replay_jobs": 10, "grow_budgets": [None],
        "shrink_pressures": [0]}}}
    cfg = daemon.build_scheduler_config(spec)
    assert isinstance(cfg.optimizer, popt.OptimizerConfig)
    assert cfg.optimizer.interval_seconds == 5.0
    with pytest.raises(ValueError, match="unknown goodput"):
        daemon.build_scheduler_config(
            {"optimizer": {"optimizer_config": {"bogus": 1}}})
    with pytest.raises(ValueError, match="JAX package"):
        daemon.build_scheduler_config({"optimizer": {
            "optimizer_create_fn":
                "cook_tpu.sched.optimizer.GoodputOptimizer"}})


def test_optimizer_threads_stop_with_the_scheduler():
    store, cluster, sched, now = system(PORT)
    sched.config.optimizer.interval_seconds = 0.05
    sched.run()
    time.sleep(0.2)
    sched.shutdown()
    alive = [t for t in sched._threads if t.is_alive()]
    assert not alive
    assert sched.optimizer_cycler.cycles >= 1
    assert threading.active_count() >= 1
