"""The port's ``Scheduler`` against the JAX package's on the CPU.

Each world of ``tests/test_torch_driver.py`` is built twice from one numpy
seed, once with ``cook_tpu``'s classes and once with ``cook_tpu_torch``'s.
Both sides are a ``Scheduler`` with ``rank_backend="tpu"`` (the port's on
``device="cpu"``: the plain K1-K6 chain; the reference's the fused XLA
cycle, since the Pallas megacycle cannot run on this JAX), driven through
``step_cycle`` at pipeline depth 0 (the synchronous driver) and 2 (the
pipelined driver, the default), with and without status shards.  Every
step must launch the same ``(job uuid, hostname)`` pairs per pool, give
the same ``MatchCycleResult`` counts and publish the same queues (job
uuids in order).  Between steps tasks finish and jobs arrive, the same on
both sides.
"""

import threading

import numpy as np
import pytest

import cook_tpu.sched
import cook_tpu_torch.sched
from test_torch_driver import (PORT, REF, WORLDS, World, _hosts, counts,
                               launched, states, uuid)


def make_world(m, spec, seed=3, depth=2, shards=None, rank_backend="tpu",
               device="cpu"):
    """``World`` with a ``Scheduler`` of the world's package on both
    sides, at pipeline ``depth`` and ``status_queue_shards=shards``."""
    w = World.__new__(World)
    w.m, w.spec = m, spec
    w.now = [1_000_000]
    w.rng = np.random.default_rng(seed)
    cfg = m.Config()
    cfg.pipeline.depth = depth
    if rank_backend == "cpu":
        cfg.default_matcher.backend = "cpu"
    w.plugins = m.PluginRegistry()
    w.rate_limits = m.RateLimits()
    store = w.store = m.Store()
    store.clock = lambda: w.now[0]
    for p in spec.get("pools", ["default"]):
        store.put_pool(m.Pool(name=p))
    spec.get("setup", lambda w, cfg: None)(w, cfg)
    w.cfg = cfg
    w.hosts = spec.get("hosts", _hosts)(m, w.rng)
    w.cluster = m.FakeCluster("fake-1", w.hosts)
    w.jobs = []
    w.submit(spec.get("n_jobs", 24), tag=0)
    spec.get("after_submit", lambda w: None)(w)
    kw = dict(rank_backend=rank_backend, plugins=w.plugins,
              rate_limits=w.rate_limits, status_queue_shards=shards)
    if m is REF:
        w.sched = cook_tpu.sched.Scheduler(store, cfg, [w.cluster], **kw)
    else:
        w.sched = cook_tpu_torch.sched.Scheduler(store, cfg, [w.cluster],
                                                 device=device, **kw)
    return w


def settle(w):
    """Join the offensive-job stiflers and apply the queued status
    updates, so both sides see the same store."""
    for t in threading.enumerate():
        if t.name == "offensive-job-stifler":
            t.join()
    w.sched.flush_status_updates()


def step(w):
    res = w.sched.step_cycle()
    settle(w)
    return res


def queues(w):
    """pool -> the published queue's job uuids in order."""
    out = {}
    for pool, q in w.sched.pending_queues.items():
        out[pool] = ([str(u) for u in q.uuids] if hasattr(q, "uuids")
                     else [j.uuid for j in q])
    return out


def drive(spec, depth, shards, steps=4, seed=3, arrive=5, fn=step):
    """Both sides ``steps`` times through ``fn``; every step equal.
    Returns (ref world, port world, total launched)."""
    ref = make_world(REF, spec, seed, depth, shards)
    port = make_world(PORT, spec, seed, depth, shards)
    total = 0
    for c in range(steps):
        ra, rb = fn(ref), fn(port)
        la, lb = launched(ref, ra), launched(port, rb)
        assert la == lb, f"step {c}"
        assert counts(ra) == counts(rb), f"step {c}"
        assert queues(ref) == queues(port), f"step {c}"
        assert states(ref) == states(port), f"step {c}"
        total += sum(len(v) for v in lb.values())
        spec.get("between", lambda w, c: None)(ref, c)
        spec.get("between", lambda w, c: None)(port, c)
        ref.churn(arrive)
        port.churn(arrive)
        settle(ref)
        settle(port)
    assert total > 0, "no step launched anything"
    return ref, port, total


@pytest.mark.parametrize("shards", [None, 2])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_step_cycle_parity(name, depth, shards):
    ref, port, _n = drive(WORLDS[name], depth, shards)
    assert (port.sched._pipeline is None) == (depth == 0)
    if depth:
        assert (port.sched._pipeline.conflicts_state,
                port.sched._pipeline.conflicts_resources) == \
            (ref.sched._pipeline.conflicts_state,
             ref.sched._pipeline.conflicts_resources)


def split_step(w):
    w.sched.step_rank()
    res = w.sched.step_match()
    settle(w)
    return res


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("name", ["plain", "offensive", "rack_gang",
                                  "two_pools"])
def test_step_rank_and_match_parity(name, backend):
    """The split cycle on both rank backends: each step's launches,
    counts and queues equal the reference's."""
    spec = WORLDS[name]
    ref = make_world(REF, spec, depth=0, rank_backend=backend)
    port = make_world(PORT, spec, depth=0, rank_backend=backend)
    for c in range(3):
        ra, rb = split_step(ref), split_step(port)
        assert launched(ref, ra) == launched(port, rb), f"step {c}"
        assert counts(ra) == counts(rb), f"step {c}"
        assert queues(ref) == queues(port), f"step {c}"
        ref.churn(4)
        port.churn(4)


def _direct_pool(w, cfg):
    w.store.put_pool(w.m.Pool(name="direct",
                              scheduler=w.m.SchedulerKind.DIRECT))


def _direct_hosts(m, rng):
    return _hosts(m, rng) + [
        m.FakeHost(hostname=f"d{i}", pool="direct",
                   capacity=m.Resources(cpus=8.0, mem=8192.0))
        for i in range(2)]


DIRECT = {"setup": _direct_pool, "pools": ["default", "direct"],
          "spread": True, "hosts": _direct_hosts}


@pytest.mark.parametrize("depth", [0, 2])
def test_direct_pool_parity(depth):
    """A direct (backend-places) pool beside a matched one: the direct
    pool's launches go through ``_match_direct`` on both sides."""
    _ref, port, _n = drive(DIRECT, depth, None)
    assert any(port.store.job(j.uuid).instances for j in port.jobs
               if j.pool == "direct")


def _gang_fail(w, c):
    """After the first step one member of the rack gang fails: the gang
    policy requeues the whole gang (its siblings' instances fail
    ``gang-member-lost``)."""
    if c != 0:
        return
    job = w.store.job(uuid(0xB, 0))
    w.cluster.fail_task(job.instances[-1], w.m.Reasons.NODE_LOST.code)


@pytest.mark.parametrize("depth", [0, 2])
def test_gang_member_failure_parity(depth):
    spec = {**WORLDS["rack_gang"], "between": _gang_fail}
    ref, port, _n = drive(spec, depth, None)
    for w in (ref, port):
        w.sched.drain_side_effects()
    reasons = [sorted(p.store.instance(t).reason_code or 0
                      for t in p.store.job(uuid(0xB, i)).instances)
               for p in (ref, port) for i in range(3)]
    assert reasons[:3] == reasons[3:]
    lost = PORT.Reasons.GANG_MEMBER_LOST.code
    assert any(lost in r for r in reasons[3:])


@pytest.mark.parametrize("depth", [0, 2])
def test_resume_with_live_instances(depth):
    """A scheduler built over a store with live instances (a leader
    handoff) watches them and schedules on from there, as the
    reference's does."""
    spec = WORLDS["rack_gang"]
    sides = []
    for m in (REF, PORT):
        w = make_world(m, spec, depth=depth)
        step(w)
        w.sched.shutdown()
        kw = dict(rank_backend="tpu", plugins=w.plugins,
                  rate_limits=w.rate_limits)
        cluster = m.FakeCluster("fake-2", w.hosts)
        if m is REF:
            w.sched = cook_tpu.sched.Scheduler(w.store, w.cfg, [cluster],
                                               **kw)
        else:
            w.sched = cook_tpu_torch.sched.Scheduler(
                w.store, w.cfg, [cluster], device="cpu", **kw)
        w.cluster = cluster
        sides.append(w)
    ref, port = sides
    assert port.sched.heartbeats.tracked_count() == \
        ref.sched.heartbeats.tracked_count() > 0
    gang_jobs = [sorted((w.store.instance(t).job_uuid, g)
                        for t, g in w.sched._gang_of_task.items())
                 for w in (ref, port)]
    assert gang_jobs[0] == gang_jobs[1] and gang_jobs[1]
    for c in range(2):
        ref.churn(3)
        port.churn(3)
        ra, rb = step(ref), step(port)
        assert launched(ref, ra) == launched(port, rb), f"step {c}"
        assert counts(ra) == counts(rb), f"step {c}"


def test_default_device_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cook_tpu_torch.sched.Scheduler(PORT.Store(), PORT.Config())
    from cook_tpu_torch.sched.rebalancer import Rebalancer
    with pytest.raises(RuntimeError, match="cuda"):
        Rebalancer(PORT.Store(), PORT.Config())


@pytest.mark.parametrize("knob", ["admission", "warmup", "cache"])
def test_unported_planes_raise(knob):
    cfg = PORT.Config()
    if knob == "admission":
        cfg.admission.enabled = True
    elif knob == "warmup":
        cfg.pipeline.warmup_tasks = 64
        cfg.pipeline.warmup_hosts = 64
    else:
        cfg.pipeline.compilation_cache_dir = "cache"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cook_tpu_torch.sched.Scheduler(PORT.Store(), cfg, device="cpu")


@pytest.mark.parametrize("depth", [0, 2])
def test_failed_dispatch_raises_resets_and_recovers(depth):
    """An injected ``fused.dispatch`` fault on the second step reaches
    the caller; the pipeline and the device-resident state are dropped,
    nothing falls back, and the next step launches what a scheduler that
    never failed launches from the same store (a twin world whose
    scheduler is built afresh over its store at that point)."""
    from cook_tpu_torch.utils.faults import injector
    from cook_tpu_torch.utils.metrics import registry
    spec = WORLDS["plain"]
    failed = make_world(PORT, spec, depth=depth)
    twin = make_world(PORT, spec, depth=depth)
    for w in (failed, twin):
        step(w)
        w.churn(5)
        settle(w)
    fallbacks = sum(v for _l, v in registry.series("cook_kernel_fallback"))
    injector.clear()
    injector.arm("fused.dispatch", schedule=[0])
    try:
        with pytest.raises(Exception, match="fused.dispatch"):
            failed.sched.step_cycle()
    finally:
        injector.clear()
    sched = failed.sched
    assert not sched._fused._resident and not sched._fused._pack_cache
    assert sched._fused._mirror.capacity == 0
    assert sched.ranker._mirror is None
    if depth:
        assert sched._pipeline.inflight() == 0
    assert sum(v for _l, v in registry.series("cook_kernel_fallback")) \
        == fallbacks
    assert not failed.sched.last_match_results or \
        states(failed) == states(twin)
    twin.sched.shutdown()
    twin.sched = cook_tpu_torch.sched.Scheduler(
        twin.store, twin.cfg, [twin.cluster], rank_backend="tpu",
        plugins=twin.plugins, rate_limits=twin.rate_limits, device="cpu")
    assert states(failed) == states(twin)
    ra, rb = step(twin), step(failed)
    assert launched(twin, ra) == launched(failed, rb)
    assert counts(ra) == counts(rb)
    assert sum(len(v) for v in launched(failed, rb).values()) > 0
