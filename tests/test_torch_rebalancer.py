"""The port's rebalancer (``cook_tpu_torch/sched/rebalancer.py``, through
``Scheduler.step_rebalance``) against the JAX package's on the CPU.

Each world is built twice from one seed with fixed job uuids, once with
``cook_tpu``'s classes and once with ``cook_tpu_torch``'s (``device=
"cpu"``), on both rank backends: ``"tpu"`` (the preemption search of
``ops/rebalance``: the JAX kernel on one side, the port's PyTorch search
over K2's plain version on the other) and ``"cpu"`` (the numpy
reference on both).  The decisions must be equal — beneficiary, host,
victims (by job uuid, in order), ``dru``, the beneficiary's DRU, the
victims' DRUs, the gang-closure and elastic-shrink victims — and so must
the reservations and every instance's state afterwards.
"""

import numpy as np
import pytest

import cook_tpu.sched
import cook_tpu_torch.sched
from test_torch_driver import PORT, REF


def scheduler(m, store, cfg, clusters, backend):
    if backend == "cpu":
        cfg.default_matcher.backend = "cpu"
    if m is REF:
        return cook_tpu.sched.Scheduler(store, cfg, clusters,
                                        rank_backend=backend)
    return cook_tpu_torch.sched.Scheduler(store, cfg, clusters,
                                          rank_backend=backend, device="cpu")


def job(m, uid, user, cpus=4.0, mem=4096.0, priority=50, **kw):
    return m.Job(uuid=f"00000000-0000-0000-0000-{uid:012d}", user=user,
                 command="x", resources=m.Resources(cpus=cpus, mem=mem),
                 priority=priority, submit_time_ms=1000 + uid, **kw)


def rebalancer_config(m, safe=0.0, diff=0.0, most=10):
    return m.Config(rebalancer=m.RebalancerConfig(
        safe_dru_threshold=safe, min_dru_diff=diff, max_preemption=most))


def split_step(sched):
    sched.step_rank()
    return sched.step_match()


def decisions_of(store, decisions):
    """pool -> decisions with every task id replaced by its job uuid."""
    def jobs(tids):
        return [store.instance(t).job_uuid for t in tids]
    return {pool: [(d.job_uuid, d.hostname, jobs(d.victim_task_ids), d.dru,
                    d.spare_only, d.pending_dru,
                    sorted((store.instance(t).job_uuid, v)
                           for t, v in d.victim_drus.items()),
                    jobs(d.gang_victim_ids), jobs(d.shrink_task_ids))
                   for d in ds]
            for pool, ds in decisions.items()}


def instance_states(store):
    """Every instance as (job uuid, host, status, reason, preempted)."""
    out = []
    for j in store.jobs_where(lambda j: True):
        for t in j.instances:
            i = store.instance(t)
            out.append((j.uuid, i.hostname, i.status.value, i.reason_code,
                        bool(i.preempted)))
    return sorted(out)


def compare(build, backend, after=None):
    """Build the world with both packages, run one ``step_rebalance`` on
    each; decisions, reservations and instance states must be equal.
    Returns the port's (store, sched, decisions)."""
    got = []
    for m in (REF, PORT):
        store, sched = build(m, backend)
        decisions = sched.step_rebalance()
        sched.drain_side_effects()
        if after is not None:
            after(m, store, sched)
        got.append((decisions_of(store, decisions),
                    sorted(sched.reserved_hosts.items()),
                    instance_states(store), store, sched, decisions))
    ref, port = got
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    return port[3], port[4], port[5]


# ------------------------------------ tests/test_rebalance.py's worlds
def full_cluster(m, backend, cfg=None):
    """alice fills the cluster; bob's job waits."""
    store = m.Store()
    cluster = m.FakeCluster("fake-1", [
        m.FakeHost(f"h{i}", m.Resources(cpus=8, mem=8192))
        for i in range(2)])
    sched = scheduler(m, store, cfg or rebalancer_config(m), [cluster],
                      backend)
    store.set_share("default", "default", {"cpus": 8.0, "mem": 8192.0})
    store.create_jobs([job(m, i, "alice") for i in range(4)])
    assert len(split_step(sched)["default"].launched_task_ids) == 4
    store.create_jobs([job(m, 10, "bob")])
    assert split_step(sched)["default"].launched_task_ids == []
    sched.step_rank()
    return store, sched


def multi_victim(m, backend):
    store = m.Store()
    cluster = m.FakeCluster("fake-1", [
        m.FakeHost("h0", m.Resources(cpus=8, mem=8192))])
    sched = scheduler(m, store, rebalancer_config(m), [cluster], backend)
    store.set_share("default", "default", {"cpus": 8.0, "mem": 8192.0})
    store.set_share("bob", "default", {"cpus": 32.0, "mem": 32768.0})
    store.create_jobs([job(m, i, "alice", cpus=4.0, mem=4096.0)
                       for i in range(2)])
    split_step(sched)
    store.create_jobs([job(m, 10, "bob", cpus=8.0, mem=8192.0)])
    sched.step_rank()
    return store, sched


def _with(cfg_fn):
    def build(m, backend):
        return full_cluster(m, backend, cfg_fn(m))
    return build


CYCLE_WORLDS = {
    "fair_share": full_cluster,
    "min_dru_diff": _with(lambda m: rebalancer_config(m, diff=10.0)),
    "safe_dru_threshold": _with(lambda m: rebalancer_config(m, safe=100.0)),
    "multi_victim": multi_victim,
}


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("name", sorted(CYCLE_WORLDS))
def test_rebalance_cycle_parity(name, backend):
    store, sched, decisions = compare(CYCLE_WORLDS[name], backend)
    if name in ("min_dru_diff", "safe_dru_threshold"):
        assert decisions == {}
    else:
        assert len(decisions["default"]) == 1


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_over_quota_user_cannot_preempt(backend):
    def build(m, backend):
        store, sched = full_cluster(m, backend)
        store.set_quota("bob", "default", {"cpus": 1.0})
        return store, sched

    _s, _sched, decisions = compare(build, backend)
    assert decisions == {}


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_victims_preempted_and_beneficiary_launches(backend):
    """The victim fails ``preempted`` and requeues; the next split cycle
    launches bob, on both sides."""
    launched = []

    def after(m, store, sched):
        res = split_step(sched)["default"]
        launched.append(sorted(store.instance(t).job_uuid
                               for t in res.launched_task_ids))

    store, _sched, decisions = compare(full_cluster, backend, after)
    d = decisions["default"][0]
    victim = store.instance(d.victim_task_ids[0])
    assert victim.preempted
    assert victim.reason_code == PORT.Reasons.PREEMPTED_BY_REBALANCER.code
    assert launched[0] == launched[1]
    assert d.job_uuid in launched[1]


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_multi_victim_reservation(backend):
    """Two victims reserve the host for bob; bob launches there and the
    reservation is consumed."""
    def after(m, store, sched):
        assert sched.reserved_hosts == {job(m, 10, "bob").uuid: "h0"}
        res = split_step(sched)["default"]
        assert [store.instance(t).job_uuid
                for t in res.launched_task_ids] == [job(m, 10, "bob").uuid]

    compare(multi_victim, backend, after)


# ------------------------------------------------------- gangs, elastic
def gang_closure(m, backend):
    """alice's gang of two runs across both hosts beside her singles;
    preempting a member takes the whole gang (a closure victim on the
    other host)."""
    store = m.Store()
    cluster = m.FakeCluster("fake-1", [
        m.FakeHost(f"h{i}", m.Resources(cpus=8, mem=8192))
        for i in range(2)])
    sched = scheduler(m, store, rebalancer_config(m), [cluster], backend)
    store.set_share("default", "default", {"cpus": 8.0, "mem": 8192.0})
    g = m.Group(uuid="55555555-0000-0000-0000-000000000000", gang=True,
                gang_size=2, jobs=[])
    members = [job(m, 20 + i, "alice", cpus=6.0, mem=6144.0, priority=10,
                   group=g.uuid) for i in range(2)]
    g.jobs = [j.uuid for j in members]
    store.create_jobs(members, groups=[g])
    store.create_jobs([job(m, i, "alice", cpus=1.0, mem=1024.0,
                           priority=90) for i in range(2)])
    assert len(split_step(sched)["default"].launched_task_ids) == 4
    store.create_jobs([job(m, 10, "bob", cpus=6.0, mem=6144.0)])
    sched.step_rank()
    return store, sched


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_gang_closure_parity(backend):
    _s, _sched, decisions = compare(gang_closure, backend)
    assert any(d.gang_victim_ids for d in decisions["default"])


def elastic_shrink(m, backend, lo=1):
    """An elastic gang of two (gang_min 1) fills both hosts; a starved
    user's job sheds the surplus member through the shrink protocol."""
    store = m.Store()
    cluster = m.FakeCluster("fake", [
        m.FakeHost(f"h{i}", m.Resources(cpus=4.0, mem=4096.0))
        for i in range(2)])
    cfg = rebalancer_config(m, most=5)
    cfg.elastic.shrink_grace_seconds = 0.0
    sched = scheduler(m, store, cfg, [cluster], backend)
    store.set_share("default", "default", {"cpus": 1.0, "mem": 1.0})
    g = m.Group(uuid="66666666-0000-0000-0000-000000000000", gang=True,
                gang_size=2, gang_min=lo, gang_max=2, jobs=[])
    members = [job(m, 30 + i, "hog", cpus=4.0, mem=1024.0, group=g.uuid,
                   max_retries=5) for i in range(2)]
    g.jobs = [j.uuid for j in members]
    store.create_jobs(members, groups=[g])
    assert len(split_step(sched)["default"].launched_task_ids) == 2
    store.create_jobs([job(m, 40, "starved", cpus=4.0, mem=512.0)])
    sched.step_rank()
    return store, sched


@pytest.mark.parametrize("lo", [1, 2])
@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_elastic_shrink_parity(backend, lo):
    """gang_min 1: one surplus member shrinks, no closure; gang_min 2
    (rigid bounds): the whole gang closes."""
    _s, _sched, decisions = compare(
        lambda m, b: elastic_shrink(m, b, lo=lo), backend)
    ds = decisions["default"]
    shrunk = [t for d in ds for t in d.shrink_task_ids]
    assert (len(shrunk) == 1) == (lo == 1)


# --------------------------------------------------------- random worlds
def random_world(seed):
    def build(m, backend):
        rng = np.random.default_rng(seed)
        store = m.Store()
        n_hosts = int(rng.integers(2, 7))
        cluster = m.FakeCluster("fake-1", [
            m.FakeHost(f"h{i}", m.Resources(
                cpus=float(rng.choice([8, 16])),
                mem=float(rng.choice([8192, 16384]))))
            for i in range(n_hosts)])
        cfg = rebalancer_config(
            m, safe=float(rng.choice([0.0, 0.5, 1.0])),
            diff=float(rng.choice([0.0, 0.25, 0.5])),
            most=int(rng.choice([1, 3, 10])))
        sched = scheduler(m, store, cfg, [cluster], backend)
        users = [f"u{k}" for k in range(int(rng.integers(2, 5)))]
        for u in users:
            c = float(rng.choice([2.0, 8.0, 16.0]))
            store.set_share(u, "default", {"cpus": c, "mem": c * 1024.0})
        uid = 0
        for _wave in range(2):
            batch = []
            for _ in range(int(rng.integers(4, 12))):
                batch.append(job(
                    m, uid, users[int(rng.integers(0, 2))],
                    cpus=float(rng.integers(1, 6)),
                    mem=float(rng.integers(1, 6)) * 1024.0,
                    priority=int(rng.integers(0, 100))))
                uid += 1
            store.create_jobs(batch)
            split_step(sched)
        late = []
        for _ in range(int(rng.integers(1, 6))):
            late.append(job(m, uid, users[int(rng.integers(0, len(users)))],
                            cpus=float(rng.integers(1, 8)),
                            mem=float(rng.integers(1, 8)) * 1024.0,
                            priority=int(rng.integers(0, 100))))
            uid += 1
        store.create_jobs(late)
        sched.step_rank()
        return store, sched
    return build


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("seed", range(20))
def test_random_world_parity(seed, backend):
    compare(random_world(seed), backend)


def test_random_worlds_preempt():
    """The seeded worlds are not all idle: several of them decide."""
    n = 0
    for seed in range(20):
        store, sched = random_world(seed)(PORT, "tpu")
        n += bool(sched.step_rebalance())
    assert n >= 5


def test_decision_read_back_in_one_transfer(monkeypatch):
    """The device branch reads each decision back with one transfer:
    ``read_decision`` is called once per search and packs the four
    scalars and the mask."""
    import cook_tpu_torch.sched.rebalancer as rb
    calls = []
    real = rb.read_decision

    def spy(out, n):
        got = real(out, n)
        calls.append(got)
        return got

    monkeypatch.setattr(rb, "read_decision", spy)
    store, sched = full_cluster(PORT, "tpu")
    decisions = sched.step_rebalance()["default"]
    assert len(calls) >= 1
    found, spare_only, _host, dru, mask = calls[0]
    assert found and not spare_only and mask.sum() == 1
    assert dru == decisions[0].dru
