"""The port's pipelined driver (``cook_tpu_torch/sched/pipeline.py``)
against the JAX package's on the CPU.

The scenarios of ``tests/test_pipeline.py`` (``TestReconciliation``,
``TestDepthZeroSyncPath``) run as parity cases: the same world, built
from one seed with fixed job uuids, goes through ``cook_tpu``'s
``Scheduler`` (``rank_backend="tpu"``) and ``cook_tpu_torch``'s
(``device="cpu"``), and the launched ``(job uuid, hostname)`` pairs of
every step and the conflict counters must be equal.  Beside them: a
depth-3 pipeline, the empty-head promotion, and the partial-gang mask
that keeps a gang's members out of the speculation footprint.
"""

import types

import numpy as np
import pytest

import cook_tpu.sched
import cook_tpu.sched.pipeline
import cook_tpu_torch.sched
import cook_tpu_torch.sched.pipeline
from test_torch_driver import (PORT, REF, WORLDS, _junk_jobs, _junk_pool,
                               _kill_junk, _rate_limit, counts, launched)
from test_torch_scheduler import drive, make_world, step


def build_world(m, n_jobs=10, n_hosts=4, depth=2, host_cpus=16.0, seed=5,
                rate_limits=None, user=None):
    """``tests/test_pipeline.py::build_world`` with the package ``m``."""
    rng = np.random.default_rng(seed)
    cfg = m.Config()
    cfg.pipeline.depth = depth
    store = m.Store()
    store.put_pool(m.Pool(name="default"))
    hosts = [m.FakeHost(hostname=f"h{i}",
                        capacity=m.Resources(cpus=host_cpus, mem=16384.0))
             for i in range(n_hosts)]
    cluster = m.FakeCluster("fake-1", hosts)
    kw = dict(rank_backend="tpu")
    if rate_limits is not None:
        kw["rate_limits"] = rate_limits
    if m is REF:
        sched = cook_tpu.sched.Scheduler(store, cfg, [cluster], **kw)
    else:
        sched = cook_tpu_torch.sched.Scheduler(store, cfg, [cluster],
                                               device="cpu", **kw)
    jobs = [m.Job(uuid=f"00000000-0000-0000-0000-{i:012d}",
                  user=user or f"user{i % 3}", command="true",
                  pool="default", priority=int(rng.integers(0, 100)),
                  resources=m.Resources(cpus=1.0, mem=128.0),
                  submit_time_ms=1000 + i)
             for i in range(n_jobs)]
    store.create_jobs(jobs)
    return types.SimpleNamespace(m=m, store=store, sched=sched,
                                 cluster=cluster, jobs=jobs)


def pairs(w, res):
    return launched(w, res)


def live_counts(store):
    out = {}
    for job, _inst in store.running_instances():
        out[job.uuid] = out.get(job.uuid, 0) + 1
    return out


def conflicts(w):
    drv = w.sched._pipeline
    return (drv.conflicts_state, drv.conflicts_resources)


def both(scenario, **kw):
    """Run ``scenario(world)`` on both packages; it returns a list of
    per-step launched pairs.  Those and the conflict counters must be
    equal.  Returns the port's world."""
    ref = build_world(REF, **kw)
    port = build_world(PORT, **kw)
    got_ref, got_port = scenario(ref), scenario(port)
    assert got_ref == got_port
    assert conflicts(ref) == conflicts(port)
    return port


class TestDepthZeroSyncPath:
    def test_depth0_is_sync_driver(self):
        w = build_world(PORT, depth=0)
        w.sched.step_cycle()
        assert w.sched._pipeline is None

    def test_depth0_and_depth2_same_decisions(self):
        def run(m, depth):
            w = build_world(m, depth=depth)
            w.sched.step_cycle()
            return {j.uuid: (w.store.job(j.uuid).state.value,
                             tuple(sorted(
                                 w.store.instance(t).hostname
                                 for t in w.store.job(j.uuid).instances)))
                    for j in w.jobs}

        assert run(PORT, 0) == run(PORT, 2) == run(REF, 2)


class TestReconciliation:
    def test_candidate_killed_between_pack_and_apply(self):
        def scenario(w):
            out = [pairs(w, w.sched.step_cycle())]
            launched_1 = set(live_counts(w.store))
            waiting = [j for j in w.jobs if j.uuid not in launched_1]
            assert waiting
            victim = waiting[0]
            w.store.kill_job(victim.uuid)
            for tid in [i.task_id for _j, i in w.store.running_instances()]:
                w.store.update_instance_status(
                    tid, w.m.InstanceStatus.SUCCESS)
            out.append(pairs(w, w.sched.step_cycle()))
            job = w.store.job(victim.uuid)
            assert job.state is not w.m.JobState.RUNNING
            assert not job.instances
            q = w.sched.pending_queues.get("default", [])
            assert victim.uuid not in {str(u) for u in q.uuids}
            return out

        port = both(scenario, n_jobs=8, n_hosts=3, host_cpus=1.0)
        assert conflicts(port)[0] >= 1

    def test_candidate_launched_by_overlapped_actor(self):
        def scenario(w):
            out = [pairs(w, w.sched.step_cycle())]
            launched_1 = set(live_counts(w.store))
            victim = [j for j in w.jobs if j.uuid not in launched_1][0]
            w.store.launch_instance(victim.uuid, "race-task-1",
                                    hostname="h0", compute_cluster="fake-1")
            out.append(pairs(w, w.sched.step_cycle()))
            out.append(pairs(w, w.sched.step_cycle()))
            assert w.store.job(victim.uuid).instances == ["race-task-1"]
            assert max(live_counts(w.store).values(), default=0) <= 1
            return out

        both(scenario, n_jobs=8, n_hosts=3, host_cpus=1.0)

    @pytest.mark.parametrize("depth", [0, 2, 3])
    def test_launch_rate_budget_not_doubled_by_overlap(self, depth):
        """Each step's launches and ``MatchCycleResult`` counts equal the
        reference's: the staged token budgets carry the in-flight
        cycles' spends, so no step matches jobs its budget cannot
        launch."""
        def scenario(w):
            out = []
            for _ in range(3):
                res = w.sched.step_cycle()
                out.append((pairs(w, res), counts(res)))
            assert sum(len(p) for r, _c in out for p in r.values()) == 2
            return out

        for m in (REF, PORT):
            rl = m.RateLimits(job_launch=m.TokenBucketRateLimiter(
                tokens_per_minute=0.0, bucket_size=2.0))
            w = build_world(m, n_jobs=6, depth=depth, rate_limits=rl,
                            user="one-user")
            got = scenario(w)
            if m is REF:
                want = got
        assert got == want

    def test_quiet_store_zero_conflicts(self):
        def scenario(w):
            out = [pairs(w, w.sched.step_cycle()) for _ in range(4)]
            assert conflicts(w) == (0, 0)
            assert max(live_counts(w.store).values(), default=0) <= 1
            for j in w.jobs:
                assert len(w.store.job(j.uuid).instances) == 1
            return out

        both(scenario, n_jobs=12, n_hosts=4)

    def test_empty_head_promotion(self):
        """The head was staged before a task finished and launches
        nothing; the cycle staged this step sees the freed host and is
        applied in the same step, as the sync driver would launch it."""
        def scenario(w):
            out = [pairs(w, w.sched.step_cycle())]
            assert sum(len(p) for p in out[0].values()) == 1
            for tid in [i.task_id for _j, i in w.store.running_instances()]:
                w.cluster.complete_task(tid, exit_code=0)
            out.append(pairs(w, w.sched.step_cycle()))
            assert sum(len(p) for p in out[1].values()) == 1
            assert w.sched._pipeline.inflight() == 1
            return out

        both(scenario, n_jobs=3, n_hosts=1, host_cpus=1.0)


@pytest.mark.parametrize("name", ["plain", "rate_limit", "rack_gang",
                                  "two_pools"])
def test_depth3_parity(name):
    """Depth 3: two speculative cycles in flight, the second staged
    before the first is fetched; launches, counts, queues and conflict
    counters equal the reference's."""
    ref, port, _n = drive(WORLDS[name], depth=3, shards=None)
    assert port.sched._pipeline.depth == 3
    assert conflicts(port) == conflicts(ref)


def _compaction_rate_limit(w, cfg):
    _junk_pool(w, cfg)
    _rate_limit(w, cfg)


def test_compaction_under_rate_limit_parity():
    """The index compacts between two stages at depth 2, so the next
    stage's speculation mask (row ids of the old epoch) is skipped and
    only the in-flight token spends keep the launch-rate budget: every
    step equals the reference's."""
    spec = {"setup": _compaction_rate_limit, "after_submit": _junk_jobs,
            "between": _kill_junk}
    ref, port, _n = drive(spec, depth=2, shards=None)
    assert port.store.ensure_index().compactions == 1
    assert conflicts(port) == conflicts(ref)


@pytest.mark.parametrize("name", ["rate_limit", "plain"])
def test_stage_hooks_parity(name):
    """``FusedCycleDriver.stage``'s speculation hooks on their own: the
    same exclusion rows, avail delta and token delta give the same
    launch bits, flags, availability and token budgets as the
    reference's ``stage``, and each hook changes what it should."""
    got = []
    for m in (REF, PORT):
        w = make_world(m, WORLDS[name], depth=0)
        drv = w.sched._ensure_fused()
        epoch = w.store.ensure_index().compactions
        plain = drv.stage(w.sched).groups[0].group[0]
        rows = plain.rows_s[:3]
        exclude = ("rows", epoch, rows)
        hosts = {("fake-1", "h0"): np.array([4.0, 1024.0, 0.0, 0.0],
                                            dtype=np.float32)}
        pp = drv.stage(w.sched, exclude={"default": exclude},
                       avail_delta=hosts,
                       token_delta={"default": {"user0": 1.0}}
                       ).groups[0].group[0]
        got.append((plain, pp))
    (ref_plain, ref_pp), (port_plain, port_pp) = got
    for a, b in ((ref_pp, port_pp), (ref_plain, port_plain)):
        np.testing.assert_array_equal(a.launch_ok, b.launch_ok)
        np.testing.assert_array_equal(a.flags, b.flags)
        np.testing.assert_array_equal(a.avail, b.avail)
        np.testing.assert_array_equal(a.tokens_u, b.tokens_u)
    assert port_pp.launch_ok[:3].sum() == 0 and port_plain.launch_ok[:3].all()
    assert (port_pp.avail[0] < port_plain.avail[0]).any()
    if name == "rate_limit":
        assert (port_pp.tokens_u < port_plain.tokens_u).any()


def _gang_pp(m, sizes):
    """A packed pool whose context holds gangs of the given declared
    sizes (members g<k>-<i>) and one plain group."""
    groups = {}
    for k, size in enumerate(sizes):
        groups[f"g{k}"] = m.Group(uuid=f"g{k}", name=f"g{k}", gang=True,
                                  gang_size=size,
                                  jobs=[f"g{k}-{i}" for i in range(size)])
    groups["plain"] = m.Group(uuid="plain", name="plain",
                              jobs=["p-0", "p-1"])
    return types.SimpleNamespace(ctx=types.SimpleNamespace(groups=groups))


@pytest.mark.parametrize("uuids", [
    ["g0-0", "g0-1", "g0-2", "x", "g1-0"],
    ["g0-0", "x", "g1-0", "g1-1", "p-0"],
    ["x", "y"],
    []])
def test_partial_gang_mask(uuids):
    """``_whole_gang_mask``: complete gang cohorts and non-gang jobs stay
    in the footprint, members of partial cohorts leave it — as the
    reference decides."""
    want = cook_tpu.sched.pipeline.PipelinedCycleDriver._whole_gang_mask(
        None, _gang_pp(REF, [3, 2]), uuids)
    got = cook_tpu_torch.sched.pipeline.PipelinedCycleDriver \
        ._whole_gang_mask(None, _gang_pp(PORT, [3, 2]), uuids)
    np.testing.assert_array_equal(got, want)


def _two_rack_gang(w):
    """A rack gang of four (one member a host, three hosts a rack) that
    fits whole on no rack this step: partial on device, dropped at
    apply, never in the next stage's footprint."""
    m = w.m
    g = m.Group(uuid="44444444-0000-0000-0000-000000000000", name="part",
                gang=True, gang_size=4, gang_topology="rack")
    members = []
    for i in range(4):
        j = m.Job(uuid=f"00000000-0000-0000-00ff-{i:012d}", user="user1",
                  command="true", pool="default", priority=99,
                  resources=m.Resources(cpus=12.0, mem=2048.0),
                  group=g.uuid, submit_time_ms=400 + i)
        g.jobs.append(j.uuid)
        members.append(j)
    w.store.create_jobs(members, groups=[g])
    w.jobs += members


def test_partial_gang_world_parity():
    """A world whose gang is partial on the card every cycle, at depth
    2: launches and conflicts equal the reference's, and no gang member
    ever launches."""
    ref, port, _n = drive({"after_submit": _two_rack_gang}, depth=2,
                          shards=None)
    assert conflicts(port) == conflicts(ref)
    assert not any(port.store.job(f"00000000-0000-0000-00ff-{i:012d}")
                   .instances for i in range(4))


def test_lazy_queue_fetch_waits_on_its_own_cycle(monkeypatch):
    """The published queue's rows are fetched through ``fetch_rows``
    with the event of the dispatch that produced them, and only when a
    consumer touches the queue."""
    import cook_tpu_torch.sched.fused as fused
    calls = []
    real = fused.fetch_rows

    def spy(dev_rows, n, done, stream):
        calls.append((n, done))
        return real(dev_rows, n, done, stream)

    monkeypatch.setattr(fused, "fetch_rows", spy)
    w = make_world(PORT, WORLDS["plain"], depth=2)
    step(w)
    assert calls == []
    q = w.sched.pending_queues["default"]
    n = len(q)
    uuids = list(q.uuids)
    assert len(uuids) == n and len(calls) == 1
    list(q.uuids)
    assert len(calls) == 1
