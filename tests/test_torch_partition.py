"""The port's partitioned write plane (``cook_tpu_torch/state/partition.py``,
the mesh's host helpers in ``cook_tpu_torch/parallel/mesh.py`` and the
node with ``partitions.count > 1``) against the JAX package's on the CPU.

Each case of ``tests/test_partition.py`` but the partition-leader-loss
chaos run (held against the reference in ``tests/test_torch_chaos.py``
with the other chaos modes) and each case of
``tests/test_sharded.py::TestShardAlignment`` runs as one script on both
packages: the script holds the reference test's rules on each side and
logs what a caller sees (routing, tokens, refusals with their type and
message, REST statuses and bodies, gauges); the two logs must be equal.
What a log leaves out is a host-clock reading (the summary exchange's
staleness in a quota refusal) and the ids each side mints at random
(renamed by first appearance) or the side's own temporary directory.
Then a partitioned data dir written by either package is reopened by
the other.

Every test starts and ends with both packages' process-wide planes in
their default state (``test_torch_daemon.fresh_planes``); the port's
lock monitor must record no violation (two partitions' store locks may
never nest) across the file.
"""

import importlib
import json
import os
import re
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from test_torch_daemon import fresh_planes
from test_torch_rest import RANDOM_ID

MODULES = (("partition", "state.partition"), ("store", "state.store"),
           ("schema", "state.schema"), ("read_replica", "state.read_replica"),
           ("api", "rest.api"), ("client", "client"),
           ("monitor", "sched.monitor"), ("metrics", "utils.metrics"),
           ("election", "sched.election"), ("daemon", "daemon"),
           ("mesh", "parallel.mesh"), ("config", "config"),
           ("locks", "utils.locks"))


def pkg(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in MODULES:
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


SIDES = (pkg("cook_tpu"), pkg("cook_tpu_torch"))
R, P = SIDES


@pytest.fixture(autouse=True)
def _fresh_planes():
    fresh_planes()
    yield
    fresh_planes()


@pytest.fixture(scope="module", autouse=True)
def _port_locks_silent():
    before = set(P.locks.monitor.check())
    yield
    new = [v for v in P.locks.monitor.check() if v not in before]
    assert not new, "\n\n".join(new)


# ------------------------------------------------------------ the log
class Log:
    """What one side's script saw, normalized: the side's temporary
    directory becomes ``<tmp>``, every id minted at random ``id-<k>`` by
    first appearance, and the staleness a quota refusal quotes (a host
    clock reading) ``<s>``."""

    def __init__(self, tmp):
        self.tmp = str(tmp)
        self.items = []
        self.names = {}

    def norm(self, value):
        if isinstance(value, str):
            value = value.replace(self.tmp, "<tmp>")
            value = re.sub(r"staleness \d+\.\d+s", "staleness <s>s", value)
            return RANDOM_ID.sub(lambda mt: self.names.setdefault(
                mt.group(0), f"id-{len(self.names)}"), value)
        if isinstance(value, (list, tuple)):
            return [self.norm(v) for v in value]
        if isinstance(value, dict):
            return {self.norm(k): self.norm(v) for k, v in value.items()}
        return value

    def add(self, *values):
        for v in values:
            self.items.append(self.norm(v))

    def outcome(self, fn):
        """``("ok", result)`` or ``("raises", type name, message)``."""
        try:
            got = ("ok", fn())
        except Exception as e:  # noqa: BLE001 - the outcome is the datum
            got = ("raises", type(e).__name__, str(e))
        self.add(got)
        return got


def run_both(script, tmp_path):
    logs = []
    for p in SIDES:
        d = tmp_path / p.root
        d.mkdir()
        log = Log(d)
        script(p, d, log)
        logs.append(log.items)
    assert logs[0], "the script logged nothing"
    for k, (a, b) in enumerate(zip(*logs)):
        assert b == a, k
    assert len(logs[1]) == len(logs[0])


# ------------------------------------------------------------ helpers
def make_job(p, i, user="alice", pool="default", group=None):
    return p.schema.Job(uuid=f"00000000-0000-0000-0000-{i:012d}", user=user,
                        pool=pool, command=f"echo {i}", group=group,
                        resources=p.schema.Resources(cpus=1, mem=64))


def uuid_of(i):
    return f"00000000-0000-0000-0000-{i:012d}"


def wait_for(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return bool(pred())


def two_partition_store(p, d=None, fsync=False):
    """P=2 facade with pools alpha->p0, beta->p1 (durable when ``d``)."""
    part = p.partition
    pmap = part.PartitionMap(count=2, pools={"alpha": 0, "beta": 1})
    if d is None:
        ps = part.PartitionedStore([p.store.Store(partition=0),
                                    p.store.Store(partition=1)], pmap)
    else:
        ps = part.PartitionedStore.open(str(d), pmap, fsync=fsync)
    ps.put_pool(p.schema.Pool(name="alpha"))
    ps.put_pool(p.schema.Pool(name="beta"))
    return ps


def uuids(jobs):
    return sorted(j.uuid for j in jobs)


def as_json(p, entries):
    return sorted((p.schema.to_json(e) for e in entries),
                  key=lambda x: json.dumps(x, sort_keys=True))


def serving(p, api):
    server = p.api.ApiServer(api)
    server.start()
    return server


# ------------------------------------------------------------ routing map
def map_declared_groups_and_stable_hash(p, d, log):
    part = p.partition
    pmap = part.PartitionMap(count=4, pools={"prod": 0, "batch": 3})
    got = [pmap.partition_of(x) for x in
           ["prod", "batch", "default"] + [f"pool-{i}" for i in range(64)]]
    assert got[:2] == [0, 3] and set(got) <= set(range(4))
    log.add(got, pmap.to_doc(),
            part.PartitionMap.from_doc(pmap.to_doc()).to_doc(),
            pmap.partition_of("pool-7")
            == part.PartitionMap(count=4).partition_of("pool-7"))


def map_global_pool_routes_to_p0(p, d, log):
    part = p.partition
    got = [part.PartitionMap(count=c).partition_of(part.GLOBAL_POOL)
           for c in range(1, 9)]
    assert got == [0] * 8
    log.add(part.GLOBAL_POOL, got)


def map_boot_validation(p, d, log):
    Map = p.partition.PartitionMap
    for kw in ({"count": 0}, {"count": -1}, {"count": 2, "pools": {"x": 2}},
               {"count": 2, "pools": {"x": "0"}},
               {"count": 2, "pools": {"x": True}},
               {"count": "3", "pools": {"x": 2}}):
        log.outcome(lambda: Map(**kw).to_doc())


def map_persisted_mismatch_refuses_reopen(p, d, log):
    part = p.partition
    pmap = part.PartitionMap(count=2, pools={"a": 1})
    part.PartitionedStore.open(str(d / "d"), pmap).close()
    log.add(json.load(open(d / "d" / part.PARTITION_MAP_FILE)))
    got = log.outcome(lambda: part.PartitionedStore.open(
        str(d / "d"), part.PartitionMap(count=2, pools={"a": 0})))
    assert got[:2] == ("raises", "PartitionRoutingError")
    log.outcome(lambda: part.PartitionedStore.open(
        str(d / "d"), part.PartitionMap(count=3, pools={"a": 1})))
    # the identical map reopens fine
    part.PartitionedStore.open(str(d / "d"), pmap).close()
    log.add(sorted(os.listdir(d / "d")))


# ------------------------------------------------------------ routing
def routing_writes_by_pool_reads_fan_out(p, d, log):
    ps = two_partition_store(p, d / "d")
    ps.create_jobs([make_job(p, 1, pool="alpha"), make_job(p, 2, pool="beta"),
                    make_job(p, 3, pool="alpha")])
    log.add([ps._partition_of_job(uuid_of(i)) for i in (1, 2, 3)],
            uuids(ps.pending_jobs()), uuids(ps.pending_jobs("beta")),
            ps.job(uuid_of(2)).pool, ps.kill_job(uuid_of(2)),
            ps.kill_job("no-such-uuid"), ps.job("no-such-uuid") is None)
    ps.close()
    # each shard replays independently: jobs landed in the right journal
    for i in (0, 1):
        shard = p.store.Store.replay_only(str(d / "d" / f"p{i}"))
        log.add(uuids(shard.jobs_where(lambda j: True)))


def routing_launches_and_status(p, d, log):
    ps = two_partition_store(p)
    ps.create_jobs([make_job(p, 1, pool="alpha"),
                    make_job(p, 2, pool="beta")])
    insts, failures = ps.launch_instances([
        dict(job_uuid=uuid_of(1), task_id="t1", hostname="h1"),
        dict(job_uuid=uuid_of(2), task_id="t2", hostname="h2"),
        dict(job_uuid="ghost", task_id="t3", hostname="h3")])
    running = p.schema.InstanceStatus.RUNNING
    log.add(sorted(i.task_id for i in insts), failures,
            sorted(i["task_id"] for i in ps.launch_intents()),
            ps.update_instance_status("t2", running),
            ps.instance("t2").status.value,
            ps.update_instance_status("ghost-task", running),
            ps.clear_launch_intents(["t1"]),
            [ps._partition_of_instance(t) for t in ("t1", "t2", "t3")],
            sorted(j.uuid for j in ps.running_jobs()))
    log.outcome(lambda: ps.launch_instance("ghost", "t9", "h9"))


def routing_group_spanning_partitions_refused(p, d, log):
    ps = two_partition_store(p)
    jobs = [make_job(p, 1, pool="alpha", group="g1"),
            make_job(p, 2, pool="beta", group="g1")]
    group = p.schema.Group(uuid="g1", gang=True, gang_size=2,
                           jobs=[j.uuid for j in jobs])
    got = log.outcome(lambda: ps.create_jobs(jobs, groups=[group]))
    assert got[:2] == ("raises", "PartitionRoutingError")
    log.add(ps.pending_jobs() == [], ps.group("g1") is None)


def routing_latch_commits_across_partitions(p, d, log):
    ps = two_partition_store(p)
    ps.create_jobs([make_job(p, 1, pool="alpha"),
                    make_job(p, 2, pool="beta")], latch="L")
    log.add(uuids(ps.pending_jobs()))  # invisible until the latch
    ps.commit_latch("L")
    log.add(uuids(ps.pending_jobs()))


def routing_cross_partition_abort_all_or_nothing(p, d, log):
    ps = two_partition_store(p, d / "d")
    ps.create_jobs([make_job(p, 3, pool="beta")])
    # the pre-check: an existing uuid on p1 refuses before p0 journals
    log.outcome(lambda: ps.create_jobs([make_job(p, 4, pool="alpha"),
                                        make_job(p, 3, pool="beta")],
                                       latch="L0"))
    log.add(ps.job(uuid_of(4)) is None)
    # a mid-fan-out abort (a duplicate only p1 sees) rolls p0 back
    a = make_job(p, 1, pool="alpha", group="ga")
    grp = p.schema.Group(uuid="ga", jobs=[a.uuid])
    log.outcome(lambda: ps.create_jobs(
        [a, make_job(p, 2, pool="beta"), make_job(p, 2, pool="beta")],
        groups=[grp], latch="L1"))
    log.add(ps.job(a.uuid) is None, ps.group("ga") is None,
            "L1" in ps.partitions[0]._latches)
    ps.create_jobs([make_job(p, 1, pool="alpha"),
                    make_job(p, 2, pool="beta")], latch="L2")
    ps.commit_latch("L2")
    log.add(uuids(ps.pending_jobs()))
    ps.close()


def routing_shares_quotas_pools(p, d, log):
    ps = two_partition_store(p)
    ps.set_share("alice", "beta", {"cpus": 4.0})
    ps.set_quota("alice", "alpha", {"cpus": 8.0}, count=10)
    log.add(ps.get_share("alice", "beta"),
            ps.partitions[1].get_share("alice", "beta"),
            ps.partitions[0].get_share("alice", "beta"),
            ps.get_quota("alice", "alpha"), sorted(x.name for x in ps.pools()),
            ps.pool("beta").name, ps.user_usage(),
            as_json(p, ps.shares()), as_json(p, ps.quotas()))
    ps.retract_share("alice", "beta")
    ps.retract_quota("alice", "alpha")
    log.add(as_json(p, ps.shares()), as_json(p, ps.quotas()))


def routing_dynamic_config_on_p0(p, d, log):
    ps = two_partition_store(p)
    ps.set_dynamic_config("rebalancer", {"max-preemption": 4})
    log.add(ps.dynamic_config("rebalancer"),
            ps.partitions[0].dynamic_config("rebalancer"),
            ps.partitions[1].dynamic_config("rebalancer"),
            ps.update_dynamic_config("rebalancer", {"min-dru": 1.5}))


# ------------------------------------------------------------ tokens
def tokens_store_forms(p, d, log):
    Store = p.store.Store
    plain = Store.open(str(d / "a"))
    plain.create_jobs([make_job(p, 1)])
    part = Store.open(str(d / "b"), partition=3)
    part.create_jobs([make_job(p, 2)])
    fenced = Store.open(str(d / "c"), epoch=5, partition=1)
    fenced.create_jobs([make_job(p, 3)])
    for s in (plain, part, fenced):
        off = s.commit_offset()
        assert off > 0
        log.add(s.commit_token().replace(str(off), "<offset>"))
        s.close()


def tokens_facade_vector_omits_untouched(p, d, log):
    part = p.partition
    ps = two_partition_store(p, d / "d")
    log.add([e[0] for e in part.parse_token_vector(ps.commit_token())])
    before = {e[0]: e for e in part.parse_token_vector(ps.commit_token())}
    ps.create_jobs([make_job(p, 1, pool="beta")])
    after = {e[0]: e for e in part.parse_token_vector(ps.commit_token())}
    log.add(sorted(after), after[1][2] > before[1][2],
            after[0] == before[0],
            ps.commit_offset() == sum(s.commit_offset()
                                      for s in ps.partitions))
    ps.close()
    fresh = part.PartitionedStore.open(
        str(d / "e"), part.PartitionMap(count=3))
    log.add(fresh.commit_token(), fresh.commit_offset())
    fresh.close()


def tokens_parse_vector_forms(p, d, log):
    parse = p.partition.parse_token_vector
    for token in ("p0:3:128,p1:64", "7:99", "99", " p2:5 , 7 ,", "",
                  "pX:1", "p1", "p0:a:1", "x:1"):
        log.outcome(lambda: parse(token))
    log.outcome(lambda: p.partition.parse_token_entry("p12:0:4096"))


def tokens_client_merges_per_partition(p, d, log):
    c = p.client.JobClient("http://x")
    for token in ("p0:1:100", "p1:1:50", "p1:2:10", "p0:1:90", "4:77",
                  "p1:2:10", "p0:3:5,p2:1:1"):
        c._merge_commit_token(token)
        log.add(c.last_commit_offset)


# ------------------------------------------------- cross-partition quota
def quota_refused_on_both_partitions(p, d, log):
    ps = two_partition_store(p)
    ps.set_quota("alice", p.partition.GLOBAL_POOL, {}, count=4)
    ps.create_jobs([make_job(p, i, pool="alpha") for i in (1, 2)]
                   + [make_job(p, i, pool="beta") for i in (3, 4)])
    for _pool in ("alpha", "beta"):
        msg = ps.check_user_quota("alice", 1)
        assert msg and "global quota" in msg
        log.add(msg)
    log.add(ps.check_user_quota("alice", 0), ps.check_user_quota("bob", 4),
            ps.summaries.merged(), ps.summaries.user_totals("carol"))
    stats = ps.summaries.stats()
    assert 0 <= stats.pop("staleness_s") <= ps.summaries.max_age_s + 5.0
    log.add(stats)


def quota_staleness_window_bounded(p, d, log):
    # the window's rule, not its readings: served inside it, refreshed
    # past it (1 s, so a loaded host keeps two calls inside)
    ps = two_partition_store(p)
    ps.summaries.max_age_s = 1.0
    ps.set_quota("alice", p.partition.GLOBAL_POOL, {}, count=1)
    ps.create_jobs([make_job(p, 1, pool="alpha")])
    log.add(ps.summaries.refreshes, ps.check_user_quota("alice", 1))
    refreshes = ps.summaries.refreshes
    msg = ps.check_user_quota("alice", 1)
    log.add(ps.summaries.refreshes - refreshes, msg)
    assert ps.summaries.staleness_s() <= 1.0 + 5.0
    time.sleep(1.05)
    ps.check_user_quota("alice", 1)
    log.add(ps.summaries.refreshes - refreshes)
    ps.summaries.refresh()
    log.add(ps.summaries.refreshes - refreshes)


def quota_rest_submission_refused_422(p, d, log):
    ps = two_partition_store(p, d / "d")
    ps.summaries.max_age_s = 0.0
    ps.set_quota("alice", p.partition.GLOBAL_POOL, {}, count=2)
    server = serving(p, p.api.CookApi(ps))
    try:
        client = p.client.JobClient(server.url, user="alice")
        log.add(len(client.submit([{"command": "x"}], pool="alpha")),
                len(client.submit([{"command": "x"}], pool="beta")))
        for pool in ("beta", "alpha"):
            with pytest.raises(p.client.JobClientError) as e:
                client.submit([{"command": "x"}], pool=pool)
            assert e.value.status == 422
            log.add(e.value.status, e.value.message)
        # bob has no global quota
        bob = p.client.JobClient(server.url, user="bob")
        log.add(len(bob.submit([{"command": "x"}] * 3, pool="beta")))
    finally:
        server.stop()
        ps.close()


def quota_idempotent_retry_not_refused(p, d, log):
    ps = two_partition_store(p, d / "d")
    ps.summaries.max_age_s = 0.0
    ps.set_quota("alice", p.partition.GLOBAL_POOL, {}, count=2)
    server = serving(p, p.api.CookApi(ps))
    try:
        client = p.client.JobClient(server.url, user="alice")
        got = client.submit([{"command": "x"}, {"command": "x"}],
                            pool="alpha")
        retried = client.submit([{"uuid": u, "command": "x"} for u in got],
                                pool="alpha", idempotent=True)
        log.add(sorted(retried) == sorted(got))
        with pytest.raises(p.client.JobClientError) as e:
            client.submit([{"command": "x"}], pool="alpha")
        log.add(e.value.status, e.value.message)
    finally:
        server.stop()
        ps.close()


# ------------------------------------------------- group commit, monitor
def group_commit_concurrent_per_partition(p, d, log):
    ps = two_partition_store(p, d / "d", fsync=True)
    log.add(ps.enable_group_commit(window_ms=5.0))
    errs = []

    def submit(i):
        try:
            ps.create_jobs([make_job(p, 100 + i,
                                     pool="alpha" if i % 2 == 0 else "beta")])
        except Exception as e:  # pragma: no cover - failure detail
            errs.append(e)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs, errs
    stats = ps.group_commit_stats()
    # how many rounds the committers took is a host-timing reading
    log.add(stats["commits"], stats["indeterminate"], stats["pending"],
            stats["window_ms"], stats["batches"] >= 2,
            [(s["partition"], s["commits"]) for s in stats["per_partition"]])
    ps.close()
    for i in (0, 1):
        shard = p.store.Store.replay_only(str(d / "d" / f"p{i}"))
        log.add(uuids(j for j in shard.jobs_where(lambda j: True)
                      if j.uuid.startswith("00000000")))


def group_commit_metrics_partition_label(p, d, log):
    ps = two_partition_store(p, d / "d", fsync=True)
    ps.enable_group_commit(window_ms=0.0)
    ps.create_jobs([make_job(p, 1, pool="alpha")])
    assert wait_for(lambda: (ps.group_commit_stats() or {})
                    .get("batches", 0) >= 1)
    text = p.metrics.registry.expose()
    log.add([f'cook_group_commit_batch_size_count{{partition="p{i}"}}'
             in text for i in (0, 1)])
    ps.disable_group_commit()
    log.add(ps.group_commit_stats())
    ps.close()


def monitor_journal_heads_and_global_users(p, d, log):
    ps = two_partition_store(p, d / "d")
    ps.summaries.max_age_s = 0.0
    ps.create_jobs([make_job(p, 1, pool="alpha"), make_job(p, 2, pool="beta"),
                    make_job(p, 3, user="bob", pool="beta")])
    reg = p.metrics.MetricsRegistry()
    p.monitor.Monitor(ps, registry=reg).sweep()
    heads = {dict(lbl).get("partition"): v
             for lbl, v in reg.series("cook_journal_head_bytes")}
    log.add(sorted(heads), [heads[f"p{i}"] == ps.partitions[i].commit_offset()
                            for i in (0, 1)],
            sorted((dict(lbl)["user"], v)
                   for lbl, v in reg.series("cook_user_global_jobs")))
    ps.close()


def repl_servers_surface_per_partition(p, d, log):
    root = str(d / "d")
    ps = two_partition_store(p, d / "d")
    ps.create_jobs([make_job(p, 1, pool="alpha"), make_job(p, 2, pool="beta")])

    class StubRepl:
        fenced = False

        def __init__(self, i):
            self.partition = i
            self.port = 7000 + i
            self.directory = os.path.join(root, f"p{i}")
            self.synced_follower_count = 1

        def min_acked(self):
            return 0

        def status(self):
            return [{"id": f"f{self.partition}", "acked": 0, "synced": True}]

    api = p.api.CookApi(ps)
    api.partition_repl_servers = [StubRepl(0), StubRepl(1)]
    server = serving(p, api)
    try:
        c = p.client.JobClient(server.url, user="u")
        blocks = c.debug_replication()["partition_replication"]
        log.add([(b["partition"], b["synced_followers"], b["port"])
                 for b in blocks])
        lag = [ln for ln in c.metrics().splitlines()
               if ln.startswith("cook_replication_lag_bytes{")]
        log.add([re.sub(r" [0-9.e+]+$", "", ln) for ln in sorted(lag)],
                all(float(ln.rsplit(" ", 1)[1]) > 0 for ln in lag))
    finally:
        server.stop()
        ps.close()


# ------------------------------------- the follower wait-gate over REST
class StubElector:
    def __init__(self, url):
        self.url = url

    def leader_url(self):
        return self.url


class PartitionedRest:
    """A partitioned leader's REST, and a follower's over a
    ``PartitionedReadView`` tailing the leader's shard directories."""

    def __init__(self, p, d):
        part = p.partition
        self.dir = str(d / "d")
        self.pmap = part.PartitionMap(count=2, pools={"alpha": 0, "beta": 1})
        self.store = part.PartitionedStore.open(self.dir, self.pmap)
        self.store.put_pool(p.schema.Pool(name="alpha"))
        self.store.put_pool(p.schema.Pool(name="beta"))
        self.leader = serving(p, p.api.CookApi(self.store))
        self.view = part.PartitionedReadView(self.dir, self.pmap,
                                             interval_s=0.005)
        self.api = p.api.CookApi(self.view.store,
                                 elector=StubElector(self.leader.url),
                                 node_url="http://follower-node")
        self.api.read_view = self.view
        self.view.on_swap(lambda s: setattr(self.api, "store", s))
        self.server = serving(p, self.api)

    def close(self):
        self.server.stop()
        self.leader.stop()
        self.view.stop()
        self.store.close()


def with_rest(script):
    def run(p, d, log):
        rest = PartitionedRest(p, d)
        try:
            script(p, rest, log)
        finally:
            rest.close()
    run.__name__ = script.__name__
    return run


def get(url, headers=None):
    """(status, headers, body) of one GET, redirects not followed."""
    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **kw):
            return None

    req = urllib.request.Request(
        url, headers={"X-Cook-User": "alice", **(headers or {})})
    try:
        resp = urllib.request.build_opener(NoRedirect).open(req, timeout=10)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), None
    return resp.status, dict(resp.headers), json.load(resp)


@with_rest
def rest_leader_writes_carry_token_vector(p, rest, log):
    client = p.client.JobClient(rest.leader.url, user="alice")
    client.submit([{"command": "x"}], pool="beta")
    entries = p.partition.parse_token_vector(client.last_commit_offset)
    log.add(sorted(e[0] for e in entries))
    client.submit([{"command": "x"}], pool="alpha")
    log.add(sorted(e[0] for e in p.partition.parse_token_vector(
        client.last_commit_offset)))


@with_rest
def rest_vector_token_through_partitioned_follower(p, rest, log):
    writer = p.client.JobClient(rest.leader.url, user="alice")
    [uuid] = writer.submit([{"command": "x"}], pool="beta")
    reader = p.client.JobClient(rest.server.url, user="alice")
    reader.last_commit_offset = writer.last_commit_offset
    [job] = reader.query([uuid])
    log.add(job["uuid"] == uuid, job["pool"], job["status"])
    assert rest.api.follower_reads >= 1 \
        or reader.last_replication_offset is None


@with_rest
def rest_right_partition_follower_satisfies_entry(p, rest, log):
    rest.store.create_jobs([make_job(p, 50, pool="beta")])
    token = rest.store.partitions[1].commit_token()
    log.add(token.startswith("p1:"))
    for pid in (1, 0):
        view = p.read_replica.FollowerReadView(
            f"{rest.dir}/p{pid}", interval_s=0.005, partition_id=pid)
        api = p.api.CookApi(view.store, elector=StubElector(rest.leader.url),
                            node_url="http://f")
        api.read_view = view
        api.config.serving.min_offset_wait_seconds = 0.2
        view.on_swap(lambda s, a=api: setattr(a, "store", s))
        server = serving(p, api)
        if pid == 1:
            # the wait-gate's 0.2 s is not a catch-up budget on a loaded
            # host: the mirror catches up first, then the gate is read
            assert wait_for(lambda: view.offset
                            >= rest.store.partitions[1].commit_offset())
        try:
            status, hdrs, body = get(server.url + f"/jobs/{uuid_of(50)}",
                                     headers={"X-Cook-Min-Offset": token})
            log.add(pid, status, "X-Cook-Replication-Offset" in hdrs,
                    (hdrs.get("Location") or "").startswith(rest.leader.url),
                    body and body["uuid"])
        finally:
            server.stop()
            view.stop()


@with_rest
def rest_legacy_token_on_partitioned_follower_redirects(p, rest, log):
    rest.api.config.serving.min_offset_wait_seconds = 0.05
    rest.store.create_jobs([make_job(p, 60, pool="alpha")])
    status, hdrs, _ = get(rest.server.url + f"/jobs/{uuid_of(60)}",
                          headers={"X-Cook-Min-Offset": "17"})
    log.add(status, hdrs["Location"].startswith(rest.leader.url),
            rest.view.wait_token(None, 17, timeout_s=0.0),
            rest.view.wait_commit_token("p7:1", timeout_s=0.0))


@with_rest
def rest_debug_replication_partitions_block(p, rest, log):
    rest.store.create_jobs([make_job(p, 70, pool="beta")])
    _, _, doc = get(rest.leader.url + "/debug/replication")
    parts = doc["partitions"]
    log.add([(x["partition"], x["declared_pools"], x["epoch"])
             for x in parts],
            [x["journal_bytes"] == s.commit_offset()
             for x, s in zip(parts, rest.store.partitions)])
    ex = doc["summary_exchange"]
    assert ex.pop("staleness_s") >= 0
    log.add(sorted(ex))
    _, _, health = get(rest.leader.url + "/debug/health")
    log.add([x["partition"] for x in health["replication"]["partitions"]])


@with_rest
def rest_follower_stats_are_per_partition(p, rest, log):
    rest.store.create_jobs([make_job(p, 80, pool="alpha"),
                            make_job(p, 81, pool="beta")])
    assert wait_for(lambda: rest.view.offset >= rest.store.commit_offset())
    _, _, doc = get(rest.server.url + "/debug/replication")
    log.add([x["partition"] for x in doc["serving"]["partitions"]],
            rest.view.offset == rest.store.commit_offset(),
            rest.view.lag_bytes())
    _, _, body = get(rest.server.url + f"/jobs/{uuid_of(81)}")
    log.add(body["uuid"], body["pool"])


# ------------------------------------------------------------ leases
def leases_are_independent(p, d, log):
    el = p.election
    a = el.PartitionLeaseSet(str(d), 2, "http://a")
    b = el.PartitionLeaseSet(str(d), 2, "http://b")
    log.add(a.electors[0]._try_acquire(), a.electors[1]._try_acquire())
    a.electors[0]._leader = a.electors[1]._leader = True
    log.add(b.electors[0]._try_acquire(), b.electors[1]._try_acquire(),
            a.led_partitions(), b.leader_url(0))
    a.resign(partition=0)
    log.add(a.led_partitions(), b.electors[0]._try_acquire())
    b.electors[0]._leader = True
    log.add(b.led_partitions(), b.leader_url(1), b.epoch(0), a.epoch(1),
            os.path.basename(el.partition_lock_path(str(d), 1)))
    a.resign()
    b.resign()


# ------------------------------------------------------------ the node
def node_conf(p, d, **partitions):
    return {"host": "127.0.0.1", "port": 0,
            "data_dir": str(d / "data"),
            "election_dir": str(d / "election"),
            "clusters": [{"factory": f"{p.root}.cluster.fake.factory",
                          "kwargs": {"name": "fake-1", "n_hosts": 2}}],
            "scheduler": {"rank_backend": "cpu", "cycle_mode": "split",
                          "match_interval_seconds": 3600.0,
                          "rank_interval_seconds": 3600.0,
                          "monitor_interval_seconds": 3600.0,
                          "rebalancer": {"interval_seconds": 3600.0},
                          "partitions": partitions}}


def new_node(p, conf):
    kw = {"device": "cpu"} if p is P else {}
    return p.daemon.CookDaemon(conf, **kw)


def lead(node, timeout=60.0):
    node.start()
    deadline = time.time() + timeout
    while node.scheduler is None:
        assert time.time() < deadline, "the node never led"
        assert node.exit_code == 0, "the takeover failed"
        time.sleep(0.02)


def node_boot_validation(p, d, log):
    build = p.daemon.build_scheduler_config
    for spec in ({"partitions": {"count": 2, "pools": {"x": 5}}},
                 {"partitions": {"typo": 1}},
                 {"partitions": {"count": 0}},
                 {"partitions": {"count": 2, "summary_max_age_seconds": -1}}):
        log.outcome(lambda: build(spec).partitions.count)
    cfg = build({"partitions": {"count": 2, "pools": {"x": 1},
                                "summary_max_age_seconds": 0.5}})
    log.add(cfg.partitions.count, cfg.partitions.pools,
            cfg.partitions.summary_max_age_seconds)


def node_partitioned_serves_and_routes(p, d, log):
    node = new_node(p, node_conf(p, d, count=2,
                                 pools={"alpha": 0, "beta": 1}))
    lead(node)
    try:
        log.add(type(node.store).__name__, node.partitioned,
                node.sched_config.columnar_index,
                node.sched_config.resident_pack,
                sorted(os.listdir(d / "data")))
        client = p.client.JobClient(node.node_url, user="alice")
        got = client.submit([{"command": "x", "pool": "beta"}], pool="beta")
        log.add(sorted(e[0] for e in p.partition.parse_token_vector(
            client.last_commit_offset)),
            node.store._partition_of_job(got[0]))
        got = client.submit([{"command": "x"}], pool="alpha")
        log.add(node.store._partition_of_job(got[0]))
        doc = client.debug_replication()
        log.add([(x["partition"], x["declared_pools"])
                 for x in doc["partitions"]])
    finally:
        node.shutdown()


def node_partitions_with_replication_refused(p, d, log):
    conf = node_conf(p, d, count=2)
    conf["replication"] = {"listen_port": 0}
    node = new_node(p, conf)
    got = log.outcome(node.start)
    assert got[:2] == ("raises", "ValueError") and "partitions" in got[2]
    log.add(node.server is None)
    conf = node_conf(p, d, count=2)
    conf["shared_data_dir"] = str(d / "shared")
    log.outcome(new_node(p, conf).start)


# ------------------------------------- test_sharded.py::TestShardAlignment
def align_contiguous_blocks(p, d, log):
    sop = p.mesh.shard_of_partition
    log.add([sop(i, 8, 2) for i in range(8)], [sop(i, 4, 4) for i in range(4)],
            [sop(i, 6, 3) for i in range(6)])
    for args in ((0, 4, 0), (4, 4, 2), (-1, 4, 2), (0, 6, 4)):
        log.outcome(lambda: sop(*args))
    log.add(p.mesh.POOL_AXIS, p.mesh.DCN_AXIS)


def align_derived_layout_and_declared_agreement(p, d, log):
    pmap = p.partition.PartitionMap(count=4, pools={f"pool{i}": i
                                                    for i in range(4)})
    v = p.mesh.validate_shard_alignment
    log.add(v(pmap, 2), v(pmap, 2, {"pool0": 0, "pool1": 0, "pool2": 1,
                                    "pool3": 1}),
            v(pmap, 4), v(pmap, 1, {"other": 0}),
            [p.mesh.shard_of_pool(pmap, x, 2)
             for x in ("pool0", "pool3", "other", "*")])


def align_mismatched_declaration_is_config_error(p, d, log):
    pmap = p.partition.PartitionMap(count=4, pools={f"pool{i}": i
                                                    for i in range(4)})
    got = log.outcome(lambda: p.mesh.validate_shard_alignment(
        pmap, 2, {"pool1": 1}))
    assert got[:2] == ("raises", "ShardAlignmentError")
    assert "pool1" in got[2] and "shard" in got[2]
    log.add(issubclass(p.mesh.ShardAlignmentError, ValueError))


def align_indivisible_partition_count_refused(p, d, log):
    pmap = p.partition.PartitionMap(count=3, pools={f"pool{i}": i
                                                    for i in range(3)})
    log.outcome(lambda: p.mesh.validate_shard_alignment(pmap, 2))
    log.outcome(lambda: p.mesh.validate_shard_alignment(pmap, 0))


def align_declared_shard_out_of_range(p, d, log):
    pmap = p.partition.PartitionMap(count=4, pools={f"pool{i}": i
                                                    for i in range(4)})
    log.outcome(lambda: p.mesh.validate_shard_alignment(pmap, 2,
                                                        {"pool0": 2}))
    log.outcome(lambda: p.mesh.validate_shard_alignment(pmap, 2,
                                                        {"pool0": -1}))


def align_partition_config_validates_shards(p, d, log):
    PC = p.config.PartitionConfig
    for kw in ({"count": 4, "pools": {"a": 0}, "shards": 2,
                "shard_pools": {"a": 0}},
               {"count": 3, "pools": {"a": 0}, "shards": 2},
               {"count": 4, "pools": {"a": 0}, "shards": 2,
                "shard_pools": {"a": 5}},
               {"count": 4, "pools": {"a": 0}, "shard_pools": {"a": 0}}):
        log.outcome(lambda: PC(**kw).shards)


def align_daemon_boot_rejects_misaligned_layout(p, d, log):
    conf = node_conf(p, d, count=4, pools={f"pool{i}": i for i in range(4)},
                     shards=2, shard_pools={"pool3": 0})
    node = new_node(p, conf)
    got = log.outcome(node.start)
    assert got[:2] == ("raises", "ShardAlignmentError") and "pool3" in got[2]
    # refused before the listener binds and before any state is opened
    log.add(node.server is None, node.store is None,
            os.path.exists(d / "data"))


def align_daemon_boot_accepts_aligned_layout(p, d, log):
    conf = node_conf(p, d, count=4, pools={f"pool{i}": i for i in range(4)},
                     shards=2, shard_pools={"pool0": 0, "pool3": 1})
    node = new_node(p, conf)
    before = set(threading.enumerate())
    lead(node)
    try:
        log.add(type(node.store).__name__, sorted(os.listdir(d / "data")))
    finally:
        node.shutdown()
    if p is P:
        # the node's loops, its listener and its campaign end with
        # shutdown(); what stays is each partition's group-commit
        # committer, which lives with its store, as a one-store node's
        def left():
            return [t.name for t in threading.enumerate()
                    if t not in before and t.is_alive()
                    and not t.name.startswith("cook-group-commit-p")]
        assert wait_for(lambda: not left(), timeout=10.0), left()


CASES = {f.__name__: f for f in (
    map_declared_groups_and_stable_hash, map_global_pool_routes_to_p0,
    map_boot_validation, map_persisted_mismatch_refuses_reopen,
    routing_writes_by_pool_reads_fan_out, routing_launches_and_status,
    routing_group_spanning_partitions_refused,
    routing_latch_commits_across_partitions,
    routing_cross_partition_abort_all_or_nothing,
    routing_shares_quotas_pools, routing_dynamic_config_on_p0,
    tokens_store_forms, tokens_facade_vector_omits_untouched,
    tokens_parse_vector_forms, tokens_client_merges_per_partition,
    quota_refused_on_both_partitions, quota_staleness_window_bounded,
    quota_rest_submission_refused_422, quota_idempotent_retry_not_refused,
    group_commit_concurrent_per_partition,
    group_commit_metrics_partition_label,
    monitor_journal_heads_and_global_users,
    repl_servers_surface_per_partition,
    rest_leader_writes_carry_token_vector,
    rest_vector_token_through_partitioned_follower,
    rest_right_partition_follower_satisfies_entry,
    rest_legacy_token_on_partitioned_follower_redirects,
    rest_debug_replication_partitions_block,
    rest_follower_stats_are_per_partition,
    leases_are_independent,
    node_boot_validation, node_partitioned_serves_and_routes,
    node_partitions_with_replication_refused,
    align_contiguous_blocks, align_derived_layout_and_declared_agreement,
    align_mismatched_declaration_is_config_error,
    align_indivisible_partition_count_refused,
    align_declared_shard_out_of_range,
    align_partition_config_validates_shards,
    align_daemon_boot_rejects_misaligned_layout,
    align_daemon_boot_accepts_aligned_layout)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_partition_parity(name, tmp_path):
    run_both(CASES[name], tmp_path)


# ------------------------------------- a data dir across the packages
@pytest.mark.parametrize("writer", ["cook_tpu", "cook_tpu_torch"])
def test_partitioned_data_dir_reopens_in_the_other_package(writer, tmp_path):
    """A partitioned data dir that one package wrote (jobs on both
    partitions, a latch committed, a launch, a status, a kill, a global
    quota) opens in the other with the same jobs in the same states and
    partitions, and both refuse a changed map with the same error."""
    w, r = (R, P) if writer == "cook_tpu" else (P, R)
    d = str(tmp_path / "d")
    ps = two_partition_store(w, d)
    ps.set_quota("alice", w.partition.GLOBAL_POOL, {}, count=9)
    ps.create_jobs([make_job(w, i, pool=("alpha", "beta")[i % 2])
                    for i in range(6)], latch="L")
    ps.commit_latch("L")
    ps.create_jobs([make_job(w, 10, user="bob", pool="gamma")])
    ps.launch_instances([dict(job_uuid=uuid_of(1), task_id="t1",
                              hostname="h1")])
    ps.update_instance_status("t1", w.schema.InstanceStatus.RUNNING)
    ps.kill_job(uuid_of(2))
    ps.close()

    def seen(p):
        pmap = p.partition.PartitionMap(count=2,
                                        pools={"alpha": 0, "beta": 1})
        store = p.partition.PartitionedStore.open(d, pmap)
        try:
            jobs = sorted(store.jobs_where(lambda j: True),
                          key=lambda j: j.uuid)
            return ([(j.uuid, j.user, j.pool, j.state.value,
                      store._partition_of_job(j.uuid),
                      [store.instance(t).status.value for t in j.instances])
                     for j in jobs],
                    store.get_quota("alice", "*"), sorted(
                        x.name for x in store.pools()),
                    [s.commit_offset() > 0 for s in store.partitions])
        finally:
            store.close()

    got = [seen(p) for p in SIDES]
    assert got[0] == got[1]
    assert len(got[0][0]) == 7 and got[0][0][1][3] == "running"
    refusals = []
    for p in SIDES:
        with pytest.raises(p.partition.PartitionRoutingError) as e:
            p.partition.PartitionedStore.open(
                d, p.partition.PartitionMap(count=2, pools={"alpha": 1}))
        refusals.append((type(e.value).__name__, str(e.value)))
    assert refusals[0] == refusals[1]
