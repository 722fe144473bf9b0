"""The port's production cycle driver against the JAX package's on the
CPU.

Each world is built twice from one numpy seed, once with ``cook_tpu``'s
classes and once with ``cook_tpu_torch``'s, with fixed job uuids and a
virtual store clock.  The reference side is ``cook_tpu``'s ``Scheduler``
(``rank_backend="tpu"``, ``pipeline.depth = 0``: its fused XLA cycle,
since the Pallas megakernel cannot run on this JAX) driven through
``step_cycle``; the port's side is ``FusedCycleDriver.step`` on
``device="cpu"`` (the plain K1-K6 chain), given :class:`StandIn` for the
scheduler.  Every cycle must launch the same ``(job uuid, hostname)``
pairs per pool and give the same ``MatchCycleResult`` counts (exact:
decisions are integers and strings; task ids come from ``new_uuid()``
and are never compared).  Between cycles tasks finish and new jobs
arrive, the same on both sides.
"""

import threading
import types

import numpy as np
import pytest

import cook_tpu.cluster
import cook_tpu.config
import cook_tpu.policy
import cook_tpu.policy.plugins
import cook_tpu.policy.rate_limit
import cook_tpu.state
import cook_tpu.state.schema
import cook_tpu.utils.retry
import cook_tpu_torch.cluster
import cook_tpu_torch.config
import cook_tpu_torch.policy
import cook_tpu_torch.policy.plugins
import cook_tpu_torch.policy.rate_limit
import cook_tpu_torch.state
import cook_tpu_torch.state.schema
import cook_tpu_torch.utils.retry
from cook_tpu.sched import Scheduler
from cook_tpu_torch.ops import telemetry
from cook_tpu_torch.sched.fused import FusedCycleDriver
from cook_tpu_torch.sched.matcher import Matcher


def _pkg(root, cluster, config, policy, plugins, rate_limit, state, schema,
         retry):
    ns = types.SimpleNamespace(root=root)
    for mod in (cluster, config, policy, plugins, rate_limit, state, schema):
        for k in dir(mod):
            if not k.startswith("_"):
                setattr(ns, k, getattr(mod, k))
    ns.breakers = retry.breakers
    return ns


REF = _pkg("cook_tpu", cook_tpu.cluster, cook_tpu.config, cook_tpu.policy,
           cook_tpu.policy.plugins, cook_tpu.policy.rate_limit,
           cook_tpu.state, cook_tpu.state.schema, cook_tpu.utils.retry)
PORT = _pkg("cook_tpu_torch", cook_tpu_torch.cluster, cook_tpu_torch.config,
            cook_tpu_torch.policy, cook_tpu_torch.policy.plugins,
            cook_tpu_torch.policy.rate_limit, cook_tpu_torch.state,
            cook_tpu_torch.state.schema, cook_tpu_torch.utils.retry)


class StandIn:
    """What ``FusedCycleDriver.step`` reads off a scheduler
    (``cook_tpu/sched/scheduler.py:214-235``, ``:639-651``): the
    clusters, the reserved hosts, the breaker-filtered launchable
    clusters and the offensive-job stifler (synchronous here).  Status
    updates from the clusters go straight to the store, and a job that
    launches or completes gives up its reservation, as the scheduler's
    transaction hook does."""

    def __init__(self, m, store, clusters):
        self.m = m
        self.store = store
        self.clusters = {}
        self.reserved_hosts = {}
        for c in clusters:
            c.initialize(self._on_status_update)
            self.clusters[c.name] = c
        store.subscribe(self._on_tx_events)

    def _on_status_update(self, task_id, status, reason_code, exit_code=None,
                          preempted=False, hostname=None):
        self.store.update_instance_status(
            task_id, status, reason_code=reason_code, exit_code=exit_code,
            preempted=preempted, hostname=hostname)

    def _on_tx_events(self, tx_id, events):
        for e in events:
            if e.kind == "job-state" and e.data.get("new") in (
                    "running", "completed"):
                self.reserved_hosts.pop(e.data.get("uuid"), None)

    def launchable_clusters(self, pool_name):
        return [c for c in list(self.clusters.values())
                if c.accepts_pool(pool_name)
                and self.m.breakers.get(c.name).allow()]

    def _stifle_offensive(self, offensive):
        for job in offensive:
            self.store.kill_job(job.uuid)


def uuid(tag, i):
    return f"00000000-0000-0000-{tag:04x}-{i:012d}"


class World:
    """One side of a parity run: the store, clusters and cycle of one
    package, built from a spec and a seed."""

    def __init__(self, m, spec, seed, resident=True, quantized=True):
        self.m, self.spec = m, spec
        self.now = [1_000_000]
        self.rng = np.random.default_rng(seed)
        cfg = m.Config()
        cfg.pipeline.depth = 0
        cfg.resident_pack = resident
        cfg.quantized_wire = quantized
        self.plugins = m.PluginRegistry()
        self.rate_limits = m.RateLimits()
        store = self.store = m.Store()
        store.clock = lambda: self.now[0]
        for p in spec.get("pools", ["default"]):
            store.put_pool(m.Pool(name=p))
        spec.get("setup", lambda w, cfg: None)(self, cfg)
        self.cfg = cfg
        self.hosts = spec.get("hosts", _hosts)(m, self.rng)
        self.cluster = m.FakeCluster("fake-1", self.hosts)
        self.jobs = []
        self.submit(spec.get("n_jobs", 24), tag=0)
        spec.get("after_submit", lambda w: None)(self)
        if m is REF:
            self.sched = Scheduler(store, cfg, [self.cluster],
                                   rank_backend="tpu", plugins=self.plugins,
                                   rate_limits=self.rate_limits)
        else:
            self.sched = StandIn(m, store, [self.cluster])
            matcher = Matcher(store, cfg, plugins=self.plugins,
                              rate_limits=self.rate_limits, device="cpu")
            self.driver = FusedCycleDriver(store, cfg, matcher, self.plugins,
                                           self.rate_limits, device="cpu")

    def job(self, tag, i, **kw):
        m, rng = self.m, self.rng
        pools = self.spec.get("pools", ["default"])
        pool = pools[i % len(pools)] if self.spec.get("spread") else pools[0]
        kw.setdefault("resources", m.Resources(
            cpus=float(rng.integers(1, 4)) + 0.25,
            mem=float(rng.integers(128, 1024)) + 0.5))
        kw.setdefault("priority", int(rng.integers(0, 100)))
        return m.Job(uuid=uuid(tag, i), user=f"user{i % 3}", command="true",
                     pool=kw.pop("pool", pool), max_retries=3,
                     submit_time_ms=1000 + 100 * tag + i, **kw)

    def submit(self, n, tag):
        jobs = [self.job(tag, i) for i in range(n)]
        self.store.create_jobs(jobs)
        self.jobs += jobs

    def cycle(self):
        if self.m is REF:
            res = self.sched.step_cycle()
            for t in threading.enumerate():
                if t.name == "offensive-job-stifler":
                    t.join()
        else:
            _queues, res = self.driver.step(self.sched)
        return res

    def churn(self, k):
        """Between cycles: the clock moves on, the running tasks of the
        first two jobs by uuid finish (one fails) and ``k`` jobs arrive."""
        self.now[0] += 60_000
        running = []
        for j in sorted(self.jobs, key=lambda j: j.uuid):
            job = self.store.job(j.uuid)
            for tid in job.instances:
                inst = self.store.instance(tid)
                if inst.status is self.m.InstanceStatus.RUNNING:
                    running.append(tid)
        for n, tid in enumerate(running[:2]):
            self.cluster.complete_task(tid, exit_code=n)
        self.submit(k, tag=k + len(self.jobs))


def launched(w, res):
    """pool -> sorted (job uuid, hostname) pairs launched this cycle."""
    out = {}
    for pool, r in res.items():
        pairs = []
        for tid in r.launched_task_ids:
            inst = w.store.instance(tid)
            pairs.append((inst.job_uuid, inst.hostname))
        out[pool] = sorted(pairs)
    return out


def counts(res):
    return {pool: (r.considered, len(r.matched), len(r.launched_task_ids),
                   len(r.unmatched), r.head_matched,
                   sorted(j.uuid for j in r.unmatched),
                   sorted(r.gang_partial), len(r.launch_failures))
            for pool, r in res.items()}


def states(w):
    return {j.uuid: w.store.job(j.uuid).state.value for j in w.jobs}


def _fallbacks():
    from cook_tpu.utils.metrics import registry
    return sum(v for _l, v in registry.series("cook_kernel_fallback"))


def run_parity(spec, seed=3, cycles=3, resident=True, quantized=True,
               arrive=5):
    """Drive both worlds ``cycles`` times; every cycle's launches and
    counts must be equal, and the reference must never degrade to its
    split path.  Returns the port's world."""
    fallbacks = _fallbacks()
    ref = World(REF, spec, seed, resident, quantized)
    port = World(PORT, spec, seed, resident, quantized)
    assert [j.uuid for j in ref.jobs] == [j.uuid for j in port.jobs]
    total = 0
    for c in range(cycles):
        ra, rb = ref.cycle(), port.cycle()
        la, lb = launched(ref, ra), launched(port, rb)
        assert la == lb, f"cycle {c}"
        assert counts(ra) == counts(rb), f"cycle {c}"
        assert states(ref) == states(port), f"cycle {c}"
        total += sum(len(v) for v in lb.values())
        spec.get("between", lambda w, c: None)(ref, c)
        spec.get("between", lambda w, c: None)(port, c)
        ref.churn(arrive)
        port.churn(arrive)
    assert total > 0, "no cycle launched anything"
    assert _fallbacks() == fallbacks, "the reference degraded"
    return port


def _hosts(m, rng, n=6):
    return [m.FakeHost(hostname=f"h{i}",
                       capacity=m.Resources(cpus=16.0, mem=16384.0),
                       attributes={"rack": f"r{i % 2}"})
            for i in range(n)]


def _quota(w, cfg):
    w.store.set_quota("user0", "default", {"cpus": 4.0, "mem": 2048.0},
                      count=3.0)
    w.store.set_quota("user1", "default", {}, count=2.0)


def _pool_group_quota(w, cfg):
    cfg.pool_quotas = {"default": w.m.PoolQuota(cpus=20.0)}
    cfg.quota_groups = {"default": "g1", "beta": "g1"}
    cfg.quota_group_quotas = {"g1": w.m.PoolQuota(cpus=28.0, count=14.0)}


def _two_pool_hosts(m, rng):
    return _hosts(m, rng) + [
        m.FakeHost(hostname=f"b{i}", pool="beta",
                   capacity=m.Resources(cpus=16.0, mem=16384.0))
        for i in range(3)]


def _rate_limit(w, cfg):
    w.rate_limits = w.m.RateLimits(job_launch=w.m.TokenBucketRateLimiter(
        tokens_per_minute=0.0, bucket_size=2.0))


def _plugin(w, cfg):
    m = w.m

    class RejectUser1:
        def check(self, job):
            return (m.PluginResult.rejected("user1 deferred")
                    if job.user == "user1" else m.PluginResult.accepted())

    w.plugins.launch_filters.append(RejectUser1())


def _backoff(w, cfg):
    cfg.default_matcher = w.m.MatcherConfig(max_jobs_considered=5)


def _offensive(w, cfg):
    cfg.offensive_job_limits = w.m.OffensiveJobLimits(cpus=3.0,
                                                      memory_gb=16.0)


def _running_usage(w, cfg):
    w.store.set_quota("user0", "default", {}, count=4.0)


def _pinned_greedy(w, cfg):
    cfg.default_matcher = w.m.MatcherConfig(backend="tpu-greedy")


def _three_pool_group(w, cfg):
    cfg.quota_groups = {"default": "g", "beta": "g", "gamma": "g"}
    cfg.quota_group_quotas = {"g": w.m.PoolQuota(cpus=40.5, count=20.0)}


def _three_pool_hosts(m, rng):
    return _hosts(m, rng, 5) + [
        m.FakeHost(hostname=f"{p[0]}{i}", pool=p,
                   capacity=m.Resources(cpus=12.0, mem=12288.0))
        for p in ("beta", "gamma") for i in range(3)]


def _unique_group(w):
    m = w.m
    g = m.Group(uuid="11111111-0000-0000-0000-000000000000", name="g",
                placement_type=m.GroupPlacementType.UNIQUE)
    members = []
    for i in range(4):
        j = m.Job(uuid=uuid(0xA, i), user="user0", command="true",
                  pool="default", resources=m.Resources(cpus=1.0, mem=64.0),
                  group=g.uuid, submit_time_ms=3000 + i)
        g.jobs.append(j.uuid)
        members.append(j)
    w.store.create_jobs(members, groups=[g])
    w.jobs += members


def _rack_gang(w):
    m = w.m
    g = m.Group(uuid="22222222-0000-0000-0000-000000000000", name="gang",
                gang=True, gang_size=3, gang_topology="rack")
    members = []
    for i in range(3):
        j = m.Job(uuid=uuid(0xB, i), user="user2", command="true",
                  pool="default", priority=90,
                  resources=m.Resources(cpus=6.0, mem=2048.0),
                  group=g.uuid, submit_time_ms=500 + i)
        g.jobs.append(j.uuid)
        members.append(j)
    w.store.create_jobs(members, groups=[g])
    w.jobs += members


def _dropped_gang(w):
    """A rack gang of four that no rack can hold whole (three hosts a
    rack, one member a host): K6 drops it every cycle, the rescue pass
    cannot pack it, and the refill re-offers its capacity."""
    m = w.m
    g = m.Group(uuid="33333333-0000-0000-0000-000000000000", name="wide",
                gang=True, gang_size=4, gang_topology="rack")
    members = []
    for i in range(4):
        j = m.Job(uuid=uuid(0xE, i), user="user1", command="true",
                  pool="default", priority=95,
                  resources=m.Resources(cpus=10.0, mem=4096.0),
                  group=g.uuid, submit_time_ms=600 + i)
        g.jobs.append(j.uuid)
        members.append(j)
    w.store.create_jobs(members, groups=[g])
    w.jobs += members


def _checkpoint_hosts(m, rng):
    return [m.FakeHost(hostname=f"h{i}",
                       capacity=m.Resources(cpus=16.0, mem=16384.0),
                       attributes={"location": "lA" if i < 3 else "lB",
                                   "rack": f"r{i % 2}"})
            for i in range(6)]


def _checkpoint_job(w):
    m = w.m
    j = m.Job(uuid=uuid(0xC, 0), user="user1", command="true",
              pool="default", max_retries=5, priority=99,
              resources=m.Resources(cpus=1.0, mem=128.0),
              checkpoint=m.Checkpoint(), submit_time_ms=10)
    w.store.create_jobs([j])
    w.jobs.append(j)


def _fail_checkpointed(w, c):
    """After the first cycle the checkpointed job's instance is lost:
    its retry must land in the same location on both sides."""
    if c != 0:
        return
    job = w.store.job(uuid(0xC, 0))
    tid = job.instances[-1]
    w.cluster.fail_task(tid, w.m.Reasons.NODE_LOST.code)


def _junk_pool(w, cfg):
    w.store.put_pool(w.m.Pool(name="junk", state="inactive"))


def _junk_jobs(w):
    """Enough parked jobs in an inactive pool that killing them all
    makes the index compact (4,096 dead rows and half the table)."""
    m = w.m
    w.junk = [m.Job(uuid=uuid(0xD, i), user="junk", command="true",
                    pool="junk", resources=m.Resources(cpus=1.0, mem=64.0),
                    submit_time_ms=1)
              for i in range(4_200)]
    w.store.create_jobs(w.junk)


def _kill_junk(w, c):
    """Between cycles 0 and 1: the parked jobs die, and the next pack
    compacts the index (the row ids remap mid-run)."""
    if c == 0:
        for j in w.junk:
            w.store.kill_job(j.uuid)


WORLDS = {
    "plain": {},
    "user_quota": {"setup": _quota},
    "pool_group_quota": {"setup": _pool_group_quota,
                         "pools": ["default", "beta"], "spread": True,
                         "hosts": _two_pool_hosts},
    "rate_limit": {"setup": _rate_limit},
    "plugin_filter": {"setup": _plugin},
    "backoff_cap": {"setup": _backoff},
    "offensive": {"setup": _offensive},
    "running_usage": {"setup": _running_usage, "n_jobs": 12},
    "two_pools": {"pools": ["default", "beta"], "spread": True,
                  "hosts": _two_pool_hosts},
    "unique_group": {"n_jobs": 6, "after_submit": _unique_group},
    "rack_gang": {"after_submit": _rack_gang},
    "dropped_gang": {"after_submit": _dropped_gang},
    "checkpoint": {"hosts": _checkpoint_hosts,
                   "after_submit": _checkpoint_job,
                   "between": _fail_checkpointed},
    "pinned_greedy": {"setup": _pinned_greedy},
    "compaction": {"setup": _junk_pool, "after_submit": _junk_jobs,
                   "between": _kill_junk},
    "ragged_three_pools": {"setup": _three_pool_group,
                           "pools": ["default", "beta", "gamma"],
                           "spread": True, "n_jobs": 30,
                           "hosts": _three_pool_hosts},
}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_driver_parity(name):
    run_parity(WORLDS[name])


@pytest.mark.parametrize("resident,quantized",
                         [(False, True), (True, False), (False, False)])
@pytest.mark.parametrize("name", ["plain", "rack_gang"])
def test_driver_parity_wire_modes(name, resident, quantized):
    run_parity(WORLDS[name], resident=resident, quantized=quantized)


def test_compaction_mid_run_resyncs_the_mirror():
    """The index compacts between cycles 0 and 1: the base mirror and
    the resident wire take a full upload, and later cycles still equal
    the reference's."""
    telemetry.reset_all()
    port = run_parity(WORLDS["compaction"], cycles=3)
    assert port.store.ensure_index().compactions == 1
    assert telemetry.events().get("resident.repack.compaction") == 1


def test_gang_world_uses_the_fused_verdicts(monkeypatch):
    """The rack gang stages a gang wire and places whole, on one rack,
    from K6's verdicts: the host reduction is never called."""
    from cook_tpu_torch.ops import reference_impl

    def no_host_reduction(*a, **k):
        raise AssertionError("the host gang reduction ran")

    monkeypatch.setattr(reference_impl, "gang_reduce", no_host_reduction)
    port = run_parity(WORLDS["rack_gang"], cycles=1)
    hosts = [port.store.instance(t).hostname
             for i in range(3)
             for t in port.store.job(uuid(0xB, i)).instances]
    assert len(hosts) == 3
    racks = {h.attributes["rack"] for h in port.hosts if h.hostname in hosts}
    assert len(racks) == 1


def test_checkpoint_retry_keeps_its_location():
    port = run_parity(WORLDS["checkpoint"], cycles=2)
    job = port.store.job(uuid(0xC, 0))
    first, second = (port.store.instance(t) for t in job.instances[:2])
    assert second.node_location == first.node_location


def test_default_device_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    store = PORT.Store()
    cfg = PORT.Config()
    with pytest.raises(RuntimeError, match="cuda"):
        Matcher(store, cfg)
    matcher = Matcher(store, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        FusedCycleDriver(store, cfg, matcher, PORT.PluginRegistry(),
                         PORT.RateLimits())


def test_driver_device_must_be_the_matchers():
    # the split match and the gang reduction run on the matcher's device
    store, cfg = PORT.Store(), PORT.Config()
    matcher = Matcher(store, cfg, device="cpu")
    with pytest.raises(ValueError, match="matcher"):
        FusedCycleDriver(store, cfg, matcher, PORT.PluginRegistry(),
                         PORT.RateLimits(), device="meta")


def _entity_pack(w, cfg):
    cfg.columnar_index = False


def test_entity_pack_cycle_matches_the_reference():
    """``columnar_index=False`` packs off the entities and runs the
    dense-mask cycle; it launches what the reference's entity pack
    launches (more worlds in tests/test_torch_dense_cycle.py)."""
    port = run_parity({"setup": _entity_pack})
    staged = port.driver.stage(port.sched)
    assert not staged.groups[0].group[0].columnar
    assert staged.groups[0].dense


def test_resident_wire_takes_the_delta_path():
    """From the second cycle on, some cycle ships only a scatter delta."""
    telemetry.reset_all()
    run_parity(WORLDS["plain"], cycles=3)
    ev = telemetry.events()
    assert ev.get("resident.repack.cold") == 1
    assert ev.get("resident.delta_rows", 0) > 0


@pytest.mark.parametrize("where", ["megacycle", "sync_resident",
                                   "mirror"])
def test_a_failure_inside_the_driver_raises(monkeypatch, where):
    """A failed launch, resident scatter or base-mirror sync reaches the
    caller: nothing falls back to a plain cycle, the CPU or a repack,
    and nothing launches."""
    import cook_tpu_torch.sched.fused as fused
    from cook_tpu_torch.ops.delta import DeviceBaseMirror

    def boom(*a, **k):
        raise RuntimeError(f"injected {where} failure")

    target = {"megacycle": (fused, "mesh_megacycle"),
              "sync_resident": (fused, "sync_resident"),
              "mirror": (DeviceBaseMirror, "sync")}[where]
    monkeypatch.setattr(*target, boom)
    w = World(PORT, WORLDS["plain"], 3)
    with pytest.raises(RuntimeError, match=f"injected {where}"):
        w.cycle()
    assert not w.store.running_instances()
