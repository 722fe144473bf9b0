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
import types

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


@pytest.mark.parametrize("knob", ["optimizer", "warmup", "cache"])
def test_unported_planes_raise(knob):
    cfg = PORT.Config()
    if knob == "optimizer":
        # any value: the loop is refused before the config is read
        cfg.optimizer = object()
    elif knob == "warmup":
        cfg.pipeline.warmup_tasks = 64
        cfg.pipeline.warmup_hosts = 64
    else:
        cfg.pipeline.compilation_cache_dir = "cache"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cook_tpu_torch.sched.Scheduler(PORT.Store(), cfg, device="cpu")


def _fallbacks(m, kernel):
    from importlib import import_module
    registry = import_module(f"{m.root}.utils.metrics").registry
    return sum(v for lab, v in registry.series("cook_kernel_fallback")
               if lab.get("kernel") == kernel)


@pytest.mark.parametrize("depth", [0, 2])
def test_failed_dispatch_degrades_like_the_reference(depth):
    """An injected ``fused.dispatch`` fault on the second step degrades
    that cycle to the split path on both sides: the same launched pairs
    and counts, one ``cook_kernel_fallback{kernel="fused.pool_cycle"}``
    and the ``fused.dispatch-fallback`` note on the cycle's flight
    record; the pipeline and the device-resident state are dropped, and
    the following unarmed step matches the reference's too."""
    from importlib import import_module
    spec = WORLDS["plain"]
    ref = make_world(REF, spec, depth=depth)
    port = make_world(PORT, spec, depth=depth)
    for w in (ref, port):
        step(w)
        w.churn(5)
        settle(w)
    injectors = [import_module(f"{m.root}.utils.faults").injector
                 for m in (REF, PORT)]
    recorders = [import_module(f"{m.root}.utils.flight").recorder
                 for m in (REF, PORT)]
    before = [_fallbacks(m, "fused.pool_cycle") for m in (REF, PORT)]
    for inj in injectors:
        inj.clear()
        inj.arm("fused.dispatch", schedule=[0])
    try:
        ra, rb = step(ref), step(port)
    finally:
        for inj in injectors:
            inj.clear()
    assert launched(ref, ra) == launched(port, rb)
    assert counts(ra) == counts(rb)
    assert sum(len(v) for v in launched(port, rb).values()) > 0
    assert [_fallbacks(m, "fused.pool_cycle") - b
            for m, b in zip((REF, PORT), before)] == [1, 1]
    last = [rec.recent(limit=1)[0] for rec in recorders]
    for r in last:
        assert r["kind"] == "fused"
        assert r["faults"].get("fused.dispatch-fallback") == 1
    assert [(r["path"], r["pools"], r["jobs_considered"], r["jobs_placed"])
            for r in last][0] == \
        [(r["path"], r["pools"], r["jobs_considered"], r["jobs_placed"])
         for r in last][1]
    sched = port.sched
    assert not sched._fused._resident and not sched._fused._pack_cache
    assert sched._fused._mirror.capacity == 0
    if depth:
        assert sched._pipeline.inflight() == 0
    assert states(ref) == states(port)
    for w in (ref, port):
        w.churn(3)
        settle(w)
    ra, rb = step(ref), step(port)
    assert launched(ref, ra) == launched(port, rb)
    assert counts(ra) == counts(rb)
    assert queues(ref) == queues(port)
    assert sum(len(v) for v in launched(port, rb).values()) > 0


# ------------------------------------------------------- elastic resize
def elastic_system(m, n_hosts=6, grace_s=0.0, size=4, lo=2, hi=None):
    """The reference's ``tests/test_elastic.py`` system: split cycle on
    the cpu backend, ``n_hosts`` 4-cpu hosts, one elastic gang ``g1``."""
    cfg = m.Config()
    cfg.cycle_mode = "split"
    cfg.pipeline.depth = 0
    cfg.elastic.shrink_grace_seconds = grace_s
    cfg.default_matcher.backend = "cpu"
    cfg.columnar_index = False
    store = m.Store()
    now = [1000.0]
    store.clock = lambda: now[0]
    hosts = [m.FakeHost(f"h{i}", m.Resources(cpus=4.0, mem=4096.0))
             for i in range(n_hosts)]
    cluster = m.FakeCluster("fake", hosts)
    sched = _scheduler(m, store, cfg, [cluster], rank_backend="cpu")
    group = m.Group(uuid="g1", gang=True, gang_size=size, gang_min=lo,
                    gang_max=hi if hi is not None else size, jobs=[])
    jobs = [m.Job(uuid=f"g1-m{i}", user="train", command="x",
                  max_retries=5, resources=m.Resources(cpus=4.0, mem=1024.0),
                  group="g1") for i in range(size)]
    group.jobs = [j.uuid for j in jobs]
    store.create_jobs(jobs, groups=[group])
    return types.SimpleNamespace(m=m, store=store, cluster=cluster,
                                 sched=sched, now=now, jobs=jobs)


def _scheduler(m, store, cfg, clusters, **kw):
    if m is REF:
        return cook_tpu.sched.Scheduler(store, cfg, clusters, **kw)
    return cook_tpu_torch.sched.Scheduler(store, cfg, clusters,
                                          device="cpu", **kw)


def split(s):
    s.sched.step_rank()
    return s.sched.step_match()


def job_states(s, anonymous=False):
    """Every job's state and its instances' (status, reason) in order —
    comparable across packages (task ids are random).  ``anonymous``
    drops the job uuids and sorts: the elastic pressure sheds the newest
    of members launched in one cycle, a tie its task ids break."""
    out = []
    for j in sorted(s.store.jobs_where(lambda _j: True, clone=False),
                    key=lambda j: j.uuid):
        insts = [s.store.instance(t) for t in j.instances]
        out.append((j.uuid, j.state.name,
                    [(i.status.name, i.reason_code) for i in insts]))
    return sorted(o[1:] for o in out) if anonymous else out


def _last_task(s, res):
    """The task of the last job (by uuid) this result launched."""
    tids = res["default"].launched_task_ids
    return max(tids, key=lambda t: s.store.instance(t).job_uuid)


def _grace_shrink(s):
    trace = []
    tid = _last_task(s, split(s))
    inst = s.store.instance(tid)
    trace.append(s.sched.elastic.request_shrink(
        tid, inst.job_uuid, "g1", "fake", s.sched.clusters,
        reason="pressure", facts={"by": "test"}))
    trace.append(s.sched.elastic.request_shrink(
        tid, inst.job_uuid, "g1", "fake", s.sched.clusters))
    trace.append(s.cluster.notifications[tid][0]["kind"])
    for dt in (4000, 2000):
        s.now[0] += dt
        trace.append((s.sched.step_resize(), job_states(s)))
    trace.append(s.store.gang_live_members("g1"))
    return trace


def _zero_grace(s):
    tid = _last_task(s, split(s))
    inst = s.store.instance(tid)
    s.sched.elastic.request_shrink(tid, inst.job_uuid, "g1", "fake",
                                   s.sched.clusters)
    return [job_states(s), s.sched.step_resize()]


def _pressure_surplus(s):
    split(s)
    trace = [s.store.gang_live_members("g1")]
    s.sched.elastic.shrink_pressure["default"] = 5
    for _ in range(2):
        trace.append((s.sched.step_resize(), job_states(s, anonymous=True),
                      s.store.gang_live_members("g1")))
    return trace


def _pressure_nets_pending(s):
    res = split(s)
    tids = sorted(res["default"].launched_task_ids,
                  key=lambda t: s.store.instance(t).job_uuid)
    for tid in tids[:2]:
        inst = s.store.instance(tid)
        s.sched.elastic.request_shrink(tid, inst.job_uuid, "g1", "fake",
                                       s.sched.clusters)
    s.sched.elastic.shrink_pressure["default"] = 2
    trace = [s.sched.elastic.apply_pressure("default", s.sched.clusters)]
    s.now[0] += 61_000
    trace.append((s.sched.step_resize(), job_states(s),
                  s.store.gang_live_members("g1")))
    return trace


def _regrow_to_max(s):
    trace = []
    for _ in range(3):
        split(s)
    trace.append(s.store.gang_live_members("g1"))
    s.sched.elastic.shrink_pressure["default"] = 1
    trace.append((s.sched.step_resize(), job_states(s, anonymous=True)))
    for _ in range(3):
        split(s)
    trace.append((s.store.gang_live_members("g1"),
                  job_states(s, anonymous=True)))
    return trace


def _rigid_noop(s):
    split(s)
    return [s.sched.step_resize(), job_states(s)]


def _disabled(s):
    split(s)
    s.sched.config.elastic.enabled = False
    s.sched.elastic.shrink_pressure["default"] = 3
    return [s.sched.step_resize(), job_states(s)]


RESIZE_WORLDS = {
    "grace_shrink": ({"grace_s": 5.0}, _grace_shrink),
    "zero_grace": ({}, _zero_grace),
    "pressure_sheds_only_surplus": ({"lo": 3}, _pressure_surplus),
    "pressure_nets_out_pending": ({"grace_s": 60.0},
                                  _pressure_nets_pending),
    "regrow_to_max": ({"n_hosts": 8, "size": 8, "hi": 4}, _regrow_to_max),
    "rigid_noop": ({"n_hosts": 3, "size": 2, "lo": 2}, _rigid_noop),
    "disabled": ({}, _disabled),
}


@pytest.mark.parametrize("name", sorted(RESIZE_WORLDS))
def test_step_resize_parity(name):
    """``step_resize`` on the reference's elastic worlds
    (``tests/test_elastic.py``): each side's results, job and instance
    states and live gang members equal after every step."""
    kw, fn = RESIZE_WORLDS[name]
    traces = [fn(elastic_system(m, **kw)) for m in (REF, PORT)]
    assert traces[0] == traces[1]
    if name == "grace_shrink":
        assert traces[1][3][0] == {} and traces[1][4][0] == \
            {"_grace_expired": 1}
    elif name == "regrow_to_max":
        assert traces[1][0] == 4 and traces[1][2][0] == 4


# ---------------------------------------------------------------- reapers
def reaper_system(m, n_hosts=2, heartbeat=False, clusters=True):
    cfg = m.Config()
    cfg.default_matcher.backend = "cpu"
    cfg.heartbeat_enabled = heartbeat
    cfg.heartbeat_timeout_ms = 1000
    cfg.orphaned_cluster_grace_seconds = 30.0
    store = m.Store()
    now = [10_000_000]
    store.clock = lambda: now[0]
    cluster = m.FakeCluster("fake-1", [
        m.FakeHost(hostname=f"h{i}", capacity=m.Resources(cpus=8.0,
                                                           mem=8192.0))
        for i in range(n_hosts)])
    sched = _scheduler(m, store, cfg, [cluster] if clusters else [],
                       rank_backend="cpu")
    return types.SimpleNamespace(m=m, store=store, cluster=cluster,
                                 sched=sched, now=now, jobs=[])


def _submit(s, n, tag, **kw):
    m = s.m
    jobs = [m.Job(uuid=uuid(tag, i), user=f"u{i % 2}", command="x",
                  resources=m.Resources(cpus=1.0, mem=64.0),
                  submit_time_ms=1000 + i, **kw) for i in range(n)]
    s.store.create_jobs(jobs)
    s.jobs += jobs
    return jobs


def _reaped(s, current):
    """The reapers' kills as job uuids, in order, and the states."""
    killed = s.sched.step_reapers(current_ms=current)
    return [s.store.instance(t).job_uuid for t in killed], job_states(s)


def _max_runtime(s):
    _submit(s, 3, 1, max_runtime_ms=10, max_retries=1)
    _submit(s, 2, 2)
    split(s)
    return [_reaped(s, s.now[0] + 5), _reaped(s, s.now[0] + 100)]


def _heartbeat(s):
    _submit(s, 3, 1, max_retries=5)
    split(s)
    tids = sorted((t for j in s.jobs for t in s.store.job(j.uuid).instances),
                  key=lambda t: s.store.instance(t).job_uuid)
    base = s.sched.heartbeats.last_beat(tids[0])
    s.sched.heartbeats.beat(tids[1], base + 4500)
    return [_reaped(s, base + 500), _reaped(s, base + 5000),
            s.sched.heartbeats.tracked_count()]


def _orphans(s):
    m = s.m
    [j] = _submit(s, 1, 1)
    s.store.launch_instance(j.uuid, "t1", hostname="h",
                            compute_cluster="gone-cluster")
    s.store.update_instance_status("t1", m.InstanceStatus.RUNNING)
    t0 = s.now[0]
    trace = [_reaped(s, t) for t in (t0, t0 + 29_000)]
    # a successor starts mid-grace: it re-arms the window
    s.sched = _scheduler(m, s.store, s.sched.config, [], rank_backend="cpu")
    trace += [_reaped(s, t) for t in (t0 + 45_000, t0 + 74_000,
                                      t0 + 76_000)]
    return trace


def _stragglers(s):
    m = s.m
    g = m.Group(uuid="55555555-0000-0000-0000-000000000000", name="g",
                straggler_quantile=0.5, straggler_multiplier=2.0)
    jobs = [m.Job(uuid=uuid(3, i), user="u0", command="x", group=g.uuid,
                  resources=m.Resources(cpus=1.0, mem=64.0), max_retries=3,
                  submit_time_ms=1000 + i) for i in range(6)]
    g.jobs = [j.uuid for j in jobs]
    s.store.create_jobs(jobs, groups=[g])
    s.jobs += jobs
    split(s)
    tids = sorted((t for j in jobs for t in s.store.job(j.uuid).instances),
                  key=lambda t: s.store.instance(t).job_uuid)
    for n, tid in enumerate(tids[:3]):
        s.now[0] += 1000 * (n + 1)
        s.cluster.complete_task(tid, exit_code=0)
    start = s.store.instance(tids[3]).start_time_ms
    return [_reaped(s, start + 4000), _reaped(s, start + 20_000)]


def _killed_once(s):
    """A task over its max runtime on a vanished cluster, in a group with
    a straggler rule: every reaper would kill it, it is killed (and
    listed) once."""
    m = s.m
    g = m.Group(uuid="66666666-0000-0000-0000-000000000000", name="g",
                straggler_quantile=0.0, straggler_multiplier=1.0)
    jobs = [m.Job(uuid=uuid(4, i), user="u0", command="x", group=g.uuid,
                  resources=m.Resources(cpus=1.0, mem=64.0), max_retries=3,
                  max_runtime_ms=50, submit_time_ms=1000 + i)
            for i in range(3)]
    g.jobs = [j.uuid for j in jobs]
    s.store.create_jobs(jobs, groups=[g])
    s.jobs += jobs
    s.store.launch_instance(jobs[0].uuid, "t-done", hostname="h0",
                            compute_cluster="fake-1")
    s.store.update_instance_status("t-done", m.InstanceStatus.RUNNING)
    s.now[0] += 10
    s.store.update_instance_status("t-done", m.InstanceStatus.SUCCESS)
    for k, j in enumerate(jobs[1:]):
        s.store.launch_instance(j.uuid, f"t{k}", hostname="h",
                                compute_cluster="gone-cluster")
        s.store.update_instance_status(f"t{k}", m.InstanceStatus.RUNNING)
    t0 = s.now[0]
    out = [_reaped(s, t0), _reaped(s, t0 + 31_000)]
    assert len(out[1][0]) == len(set(out[1][0])) == 2
    return out


REAPER_WORLDS = {
    "max_runtime": ({}, _max_runtime),
    "heartbeat": ({"heartbeat": True}, _heartbeat),
    "heartbeat_disabled": ({}, _heartbeat),
    "orphan_grace_rearm": ({"clusters": False}, _orphans),
    "stragglers": ({}, _stragglers),
    "killed_once": ({}, _killed_once),
}


@pytest.mark.parametrize("name", sorted(REAPER_WORLDS))
def test_step_reapers_parity(name):
    """``step_reapers`` on the reference's reaper worlds
    (``tests/test_e2e.py``, ``tests/test_heartbeat.py``,
    ``tests/test_robustness.py``) and the straggler rule: the same jobs'
    tasks killed in the same order with the same reasons."""
    kw, fn = REAPER_WORLDS[name]
    traces = [fn(reaper_system(m, **kw)) for m in (REF, PORT)]
    assert traces[0] == traces[1]
    kills = [t[0] for t in traces[1] if isinstance(t, tuple)]
    assert any(kills) == (name != "heartbeat_disabled")


# -------------------------------------------------------------------- run
def _fast_loops(elastic):
    def setup(w, cfg):
        cfg.match_interval_seconds = cfg.rank_interval_seconds = 0.05
        cfg.lingering_task_interval_seconds = 0.05
        cfg.monitor_interval_seconds = 0.05
        cfg.rebalancer.interval_seconds = 0.05
        cfg.elastic.enabled = elastic
        cfg.elastic.resize_interval_seconds = 0.05
    return {**WORLDS["plain"], "setup": setup}


@pytest.mark.parametrize("mode", ["fused", "split", "elastic"])
def test_run_starts_the_reference_loops(mode):
    """``run()`` starts the reference's loop set for the config (the
    optimizer's aside, which the port refuses at construction), every
    loop completes a call on its interval, and ``shutdown()`` joins
    them.  One cycle runs before ``run()``, so the reference's first
    compile is not inside the loops."""
    import threading
    spec = _fast_loops(mode == "elastic")
    backend = "cpu" if mode == "split" else "tpu"
    ran = []
    for m in (REF, PORT):
        w = make_world(m, spec, depth=0, rank_backend=backend)
        if mode == "split":
            split_step(w)
        else:
            step(w)
        seen = {}
        done = threading.Event()
        want = {"step_cycle" if mode != "split" else "step_match",
                "step_reapers", "sweep", "step_rebalance"}
        if mode == "elastic":
            want.add("step_resize")

        def counted(name, fn):
            def call(*a, **k):
                out = fn(*a, **k)
                seen[name] = seen.get(name, 0) + 1
                if want <= set(seen):
                    done.set()
                return out
            return call
        for name in ("step_cycle", "step_rank", "step_match", "step_reapers",
                     "step_rebalance", "step_resize"):
            setattr(w.sched, name, counted(name, getattr(w.sched, name)))
        w.sched.monitor.sweep = counted("sweep", w.sched.monitor.sweep)
        try:
            w.sched.run()
            n_threads = len(w.sched._threads)
            assert done.wait(10.0), sorted(seen)
        finally:
            w.sched.shutdown()
        assert not any(t.is_alive() for t in w.sched._threads)
        ran.append((n_threads, "step_cycle" in seen, "step_rank" in seen,
                    "step_resize" in seen))
    assert ran[0] == ran[1]
    assert ran[1][0] == (5 if mode == "split" else 4) + (mode == "elastic")
