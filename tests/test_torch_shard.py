"""The port's sharded controller processes (``cook_tpu_torch/sched/
shard.py``) against the JAX package's (``cook_tpu/sched/shard.py``) on
the CPU.

Every case of ``tests/test_sharded.py`` that ``tests/test_torch_partition.
py`` (the alignment cases) and ``tests/test_torch_daemon.py`` (the node's
boot refusals) do not already hold runs on both packages with the same
outcome: the shard telemetry (flight records, the ``by_shard`` roll-up,
``/debug/cycles``), the peer summary exchange, and the process
topologies (disjoint pool blocks, one against two processes, the flight
and trace stitch, cross-shard totals and a dead peer's staleness).  The
port's topology launches exactly the reference's set on the same world,
with the split cycle on the CPU at one and two shards and with the fused
cycle at two.  A store-role worker of each package answers one command
script alike.  The framed-JSON wire helpers are held on both packages.

The process-kill failover (``TestProcessKillFailover``) drives the
chaos simulator, which the port does not have yet.

Worker processes import torch (a few seconds each here), so each
topology is built once for the tests that read it and stopped in a
``finally``.
"""

import importlib
import json
import socket
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest

from test_torch_daemon import fresh_planes

pytestmark = pytest.mark.sharded

REPO = Path(__file__).resolve().parents[1]
WORLD = {"n_jobs": 24, "n_users": 3, "hosts_per_pool": 3, "seed": 3}
#: fewer, smaller hosts than the jobs need: some jobs wait, so the
#: launched set depends on the ranking
TIGHT = {"n_jobs": 40, "n_users": 4, "hosts_per_pool": 2, "seed": 11,
         "host_cpus": 5.0, "host_mem": 2000.0}
CPU_CFG = {"backend": "cpu", "rank_backend": "cpu", "cycle_mode": "split"}
#: the default fused cycle, resident and quantized wire, depth 0
FUSED_CFG = {"resident": True, "quantized": True}
POOLS = ["pool0", "pool1", "pool2", "pool3"]

MODULES = (("shard", "sched.shard"), ("flight", "utils.flight"),
           ("partition", "state.partition"), ("state", "state"),
           ("api", "rest.api"), ("store", "state.store"),
           ("schema", "state.schema"), ("election", "sched.election"),
           ("fsatomic", "utils.fsatomic"))


def pkg(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in MODULES:
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


SIDES = (pkg("cook_tpu"), pkg("cook_tpu_torch"))
R, P = SIDES
IDS = [s.root for s in SIDES]


@pytest.fixture(autouse=True)
def _fresh_planes():
    fresh_planes()
    yield
    fresh_planes()


def topology(p, n, world, cfg, root, **kw):
    """``sched_topology`` of package ``p``; the port's workers on the
    CPU."""
    if p is P:
        kw.setdefault("device", "cpu")
    return p.shard.sched_topology(n, POOLS, world, cfg=cfg, root=str(root),
                                  **kw)


def drive(sup, cycles=3):
    sup.broadcast({"cmd": "cycle", "n": cycles}, timeout_s=300)
    return sup.collect_decisions()


def decisions(p, n, world, cfg, root):
    sup = topology(p, n, world, cfg, root)
    try:
        return drive(sup)
    finally:
        sup.stop()


# ------------------------------------------------------------ the wire
@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_frames_are_length_prefixed_json(side):
    a, b = socket.socketpair()
    with a, b:
        side.shard.send_msg(a, {"cmd": "ping", "n": [1, 2]})
        head = b.recv(4)
        (n,) = struct.unpack(">I", head)
        body = b.recv(n)
        assert json.loads(body) == {"cmd": "ping", "n": [1, 2]}
        side.shard.send_msg(a, {"x": "é" * 3})
        assert side.shard.recv_msg(b) == {"x": "é" * 3}


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_frame_limit_and_short_frames_refused(side):
    assert side.shard._FRAME_MAX == 64 * 1024 * 1024
    a, b = socket.socketpair()
    with a, b:
        a.sendall(struct.pack(">I", side.shard._FRAME_MAX + 1))
        with pytest.raises(ValueError, match="exceeds"):
            side.shard.recv_msg(b)
    a, b = socket.socketpair()
    with b:
        a.sendall(struct.pack(">I", 10) + b"{}")
        a.close()
        with pytest.raises(ConnectionError, match="mid-frame"):
            side.shard.recv_msg(b)


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_rpc_raises_a_worker_error_and_addr_file_times_out(side, tmp_path):
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        with conn:
            req = side.shard.recv_msg(conn)
            side.shard.send_msg(conn, {"ok": False,
                                       "error": f"no {req['cmd']}"})
    t = threading.Thread(target=serve)
    t.start()
    try:
        with pytest.raises(RuntimeError, match="'nope' failed: no nope"):
            side.shard.rpc(srv.getsockname()[1], {"cmd": "nope"},
                           timeout_s=5.0)
    finally:
        t.join(5.0)
        srv.close()
    with pytest.raises(TimeoutError, match="never appeared"):
        side.shard.read_addr_file(str(tmp_path / "none.json"), 0.1)
    (tmp_path / "a.json").write_text(json.dumps({"port": 7, "pid": 1}))
    assert side.shard.read_addr_file(str(tmp_path / "a.json"), 1.0) == \
        {"port": 7, "pid": 1}


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_shard_pools_are_contiguous_blocks(side):
    assert side.shard.shard_pools(POOLS, 0, 2) == ["pool0", "pool1"]
    assert side.shard.shard_pools(POOLS, 1, 2) == ["pool2", "pool3"]
    assert side.shard.shard_pools(POOLS, 3, 4) == ["pool3"]


def test_world_builders_match_the_reference():
    def doc(p):
        jobs = p.shard.build_world_jobs(TIGHT, POOLS)
        hosts = p.shard.build_world_hosts(TIGHT, POOLS[:2])
        cfg = p.shard.config_from_spec(FUSED_CFG)
        return ([(j.uuid, j.user, j.pool, j.priority, j.resources.cpus,
                  j.resources.mem, j.submit_time_ms) for j in jobs],
                [(h.hostname, h.pool, h.capacity.cpus, h.capacity.mem)
                 for h in hosts],
                (cfg.cycle_mode, cfg.default_matcher.backend,
                 cfg.pipeline.depth, cfg.resident_pack, cfg.quantized_wire))
    assert doc(P) == doc(R)


def test_usage_error_and_device_in_every_spec(tmp_path):
    assert P.shard.main([]) == 2
    sup = P.shard.ShardSupervisor(2, {"role": "sched"}, root=str(tmp_path))
    assert sup.base_spec["device"] == "cuda"
    sup = P.shard.ShardSupervisor(2, {"role": "sched"}, root=str(tmp_path),
                                  device="cpu")
    assert sup.base_spec["device"] == "cpu"


def test_worker_without_a_card_fails_its_boot(tmp_path):
    """The worker's default device is the card: without one its boot
    raises before it announces an address; nothing moves to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    spec = {"role": "sched", "pools": POOLS, "world": WORLD, "cfg": CPU_CFG,
            "shard": 0, "n_shards": 1,
            "addr_file": str(tmp_path / "addr.json")}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    run = subprocess.run(
        [sys.executable, "-m", "cook_tpu_torch.sched.shard",
         str(tmp_path / "spec.json")], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert run.returncode != 0
    assert "cuda" in run.stderr
    assert not (tmp_path / "addr.json").exists()


# ------------------------------------------------------- shard telemetry
def telemetry_script(p):
    """``TestShardTelemetry``'s four cases on package ``p``."""
    flight, out = p.flight, {}
    flight.set_shard(3)
    try:
        rec = flight.CycleRecord(1, "fused")
        out["record"] = (rec.shard, rec.to_doc()["shard"])
    finally:
        flight.set_shard(None)
    out["unset"] = flight.CycleRecord(2, "fused").shard
    rec = flight.FlightRecorder()
    try:
        for shard in (0, 0, 1):
            flight.set_shard(shard)
            with rec.cycle("fused"):
                pass
    finally:
        flight.set_shard(None)
    by_shard = rec.summary()["by_shard"]
    out["by_shard"] = {k: v["cycles"] for k, v in by_shard.items()}
    assert by_shard["1"]["cycle_ms_p99"] >= by_shard["1"]["cycle_ms_p50"] \
        >= 0.0
    plain = flight.FlightRecorder()
    with plain.cycle("fused"):
        pass
    out["unsharded"] = "by_shard" in plain.summary()
    flight.set_shard(2)
    try:
        with flight.recorder.cycle("fused"):
            pass
        server = p.api.ApiServer(p.api.CookApi(p.state.Store()))
        server.start()
        try:
            body = json.load(urllib.request.urlopen(
                server.url + "/debug/cycles?limit=5"))
        finally:
            server.stop()
    finally:
        flight.set_shard(None)
    out["endpoint"] = ("2" in body["by_shard"], body["cycles"][-1]["shard"])
    return out


def test_shard_telemetry_matches_the_reference():
    got = [telemetry_script(p) for p in SIDES]
    assert got[1] == got[0]
    assert got[1] == {"record": (3, 3), "unset": None,
                      "by_shard": {"0": 2, "1": 1}, "unsharded": False,
                      "endpoint": (True, 2)}


# ------------------------------------------------ the peer summary exchange
def exchange_script(p):
    """``TestPeerSummaryExchange``'s four cases on package ``p``."""
    uid = [0]

    def store(user_jobs):
        s = p.state.Store()
        s.put_pool(p.state.Pool(name="default"))
        for user, n in user_jobs.items():
            for _ in range(n):
                uid[0] += 1
                s.create_jobs([p.state.Job(
                    uuid=f"00000000-0000-4000-8000-{uid[0]:012d}",
                    user=user, command="true",
                    resources=p.state.Resources(cpus=1, mem=64))])
        return s

    X, Err = p.partition.UserSummaryExchange, \
        p.partition.SummaryStalenessError
    out = {}
    peer = {"alice": {"pending": 3.0, "running": 1.0}}
    ex = X([store({"alice": 2})], max_age_s=5.0,
           peer_fetch=lambda: [(peer, 0.0)])
    t = ex.user_totals("alice")
    out["merge"] = (t["pending"], t["running"], ex.stats()["peer_tables"])
    ex = X([store({"alice": 1})], max_age_s=0.5,
           peer_fetch=lambda: [({}, 10.0)], assert_bound=True)
    try:
        ex.user_totals("alice")
        out["backdated"] = None
    except Err as e:
        out["backdated"] = type(e).__name__
    ex = X([store({"alice": 1})], max_age_s=0.5,
           peer_fetch=lambda: [({}, 10.0)])
    out["not_asserted"] = (ex.user_totals("alice")["pending"],
                           ex.staleness_s() >= 10.0)
    ex = X([store({"alice": 1})], max_age_s=0.5,
           peer_fetch=lambda: [({}, 0.0)], assert_bound=True)
    out["fresh"] = ex.user_totals("alice")["pending"]
    return out


def test_peer_summary_exchange_matches_the_reference():
    got = [exchange_script(p) for p in SIDES]
    assert got[1] == got[0]
    assert got[1] == {"merge": (5.0, 1.0, 1),
                      "backdated": "SummaryStalenessError",
                      "not_asserted": (1.0, True), "fresh": 1.0}


@pytest.mark.parametrize("side", SIDES, ids=IDS)
def test_peer_feed_of_an_unseen_dead_peer_is_unbounded(side, tmp_path):
    """A peer whose address never appears contributes an empty table of
    infinite age; the feed skips its own shard."""
    feed = side.shard.PeerSummaryFeed(
        [str(tmp_path / "self.json"), str(tmp_path / "gone.json")], 0,
        timeout_s=0.1)
    assert feed() == [({}, float("inf"))]
    assert feed.fetch_errors == 1


# ------------------------------------------------- process topologies
class TestShardedTopology:
    """One 2-process CPU topology of the port for the class (worker
    boots dominate), the reference's decisions on the same world beside
    it.  The dead-peer test kills shard 1 and stays last."""

    @pytest.fixture(scope="class")
    def topo(self, tmp_path_factory):
        sup = topology(P, 2, WORLD, CPU_CFG,
                       tmp_path_factory.mktemp("port2"),
                       summary_max_age_s=0.4)
        try:
            yield sup
        finally:
            sup.stop()

    def test_workers_own_disjoint_pool_blocks(self, topo):
        assert topo.procs[0].addr["pools"] == ["pool0", "pool1"]
        assert topo.procs[1].addr["pools"] == ["pool2", "pool3"]
        specs = [json.loads(Path(sp.spec_file).read_text())
                 for sp in topo.procs]
        assert [s["device"] for s in specs] == ["cpu", "cpu"]
        assert [s["shard"] for s in specs] == [0, 1]

    def test_parity_with_the_reference_one_vs_two_processes(self, topo,
                                                            tmp_path):
        """The same world through one and two processes of each package
        launches one set: states and sorted hostnames a job."""
        got2 = drive(topo)
        got1 = decisions(P, 1, WORLD, CPU_CFG, tmp_path / "p1")
        ref1 = decisions(R, 1, WORLD, CPU_CFG, tmp_path / "r1")
        ref2 = decisions(R, 2, WORLD, CPU_CFG, tmp_path / "r2")
        assert len(got1) == WORLD["n_jobs"]
        assert any(h for _s, h in got1.values()), "nothing launched"
        assert got2 == got1 == ref1 == ref2

    def test_flight_and_trace_stitch_across_shards(self, topo):
        drive(topo, cycles=2)
        flight = topo.collect_flight()
        assert set(flight) == {0, 1}
        for shard, summary in flight.items():
            assert set(summary["by_shard"]) == {str(shard)}
            assert summary["by_shard"][str(shard)]["cycles"] >= 2
        trace = topo.collect_trace("test-stitch")
        pids = {ev["pid"] for ev in trace["traceEvents"]}
        names = {ev["args"]["name"] for ev in trace["traceEvents"]
                 if ev.get("ph") == "M" and ev.get("name") == "process_name"}
        assert len(pids) == 2
        assert {"shard-0", "shard-1"} <= names
        members = trace["otherData"]["members"]
        assert all(m["ok"] and m["spans"] > 0 for m in members)
        assert trace["otherData"]["fleet"] is True

    def test_exchange_stats_and_local_summaries(self, topo):
        stats = [topo.rpc(i, {"cmd": "exchange_stats"})["stats"]
                 for i in (0, 1)]
        assert all(isinstance(s, dict) for s in stats)
        with pytest.raises(RuntimeError, match="unknown cmd"):
            topo.rpc(0, {"cmd": "bogus"})
        assert topo.rpc(1, {"cmd": "ping"})["shard"] == 1

    def test_cross_shard_user_totals_and_dead_peer_staleness(self, topo):
        local = [topo.rpc(i, {"cmd": "summary"})["users"] for i in (0, 1)]
        want = sum(local[i].get("user0", {}).get("pending", 0.0)
                   + local[i].get("user0", {}).get("running", 0.0)
                   for i in (0, 1))
        resp = topo.rpc(0, {"cmd": "user_totals", "user": "user0"})
        assert resp["totals"]["pending"] + resp["totals"]["running"] == \
            pytest.approx(want)
        assert resp["staleness_s"] <= 0.4
        topo.kill(1)
        deadline = time.monotonic() + 10.0
        stale = None
        while time.monotonic() < deadline:
            resp = topo.rpc(0, {"cmd": "user_totals", "user": "user0"})
            if "stale" in resp:
                stale = resp["stale"]
                break
            time.sleep(0.1)
        assert stale is not None, "staleness bound never tripped"
        assert "max_age" in stale or "stale" in stale.lower()


def test_tight_world_parity_and_submit(tmp_path):
    """A world that does not fit (jobs wait): one and two processes of
    the port launch the reference's set, and a job submitted to a
    running shard is placed by its next cycle."""
    ref = decisions(R, 2, TIGHT, CPU_CFG, tmp_path / "r")
    sup = topology(P, 2, TIGHT, CPU_CFG, tmp_path / "p")
    try:
        got = drive(sup)
        waiting = [u for u, (s, _h) in got.items() if s == "waiting"]
        assert waiting, "every job fit"
        assert got == ref
        doc = P.schema.to_json(P.schema.Job(
            uuid="00000000-0000-4000-8000-999999999999", user="late",
            command="true", pool="pool3",
            resources=P.schema.Resources(cpus=0.5, mem=16.0),
            submit_time_ms=5000))
        assert sup.rpc(1, {"cmd": "submit", "jobs": [doc]})["created"] == 1
        sup.rpc(1, {"cmd": "cycle", "n": 1})
        after = sup.collect_decisions()
        assert "00000000-0000-4000-8000-999999999999" in after
    finally:
        sup.stop()
    assert decisions(P, 1, TIGHT, CPU_CFG, tmp_path / "p1") == ref


def test_fused_cycle_topology_matches_the_reference(tmp_path):
    """The default fused cycle (resident and quantized wire, depth 0) at
    two shards: the port's workers on the CPU (the stage chain's plain
    versions) launch the reference's set on the tight world."""
    ref = decisions(R, 2, TIGHT, FUSED_CFG, tmp_path / "r")
    sup = topology(P, 2, TIGHT, FUSED_CFG, tmp_path / "p")
    try:
        got = drive(sup)
        flight = sup.collect_flight()
    finally:
        sup.stop()
    assert got == ref
    assert any(h for _s, h in got.values())
    # every cycle ran the fused path; none degraded to the split one
    for summary in flight.values():
        assert summary["by_kind"] == {"fused": 3}
        assert summary["faults"] == {}


# ------------------------------------------------------ the store role
def store_script(p, root: Path, replicate: bool):
    """One store-role worker of package ``p``: the failover harness's
    commands; the responses less ports, pids and journal sizes."""
    election = root / "election"
    election.mkdir(parents=True)
    authority = p.election.partition_lock_path(str(election), 0) + ".epoch"
    p.fsatomic.write_atomic_int(authority, 1)
    sup = p.shard.ShardSupervisor(1, {"role": "store"},
                                  root=str(root / "run"), per_shard=[{
                                      "role": "store",
                                      "data_dir": str(root / "p0"),
                                      "authority": authority, "epoch": 1,
                                      "replicate": replicate,
                                      "group_commit": True,
                                      "ack_timeout_s": 1.0}])
    out = []

    def job(i):
        return p.schema.to_json(p.schema.Job(
            uuid=f"00000000-0000-4000-8000-{i:012d}", user="chaos0",
            command=f"echo {i}", pool="pool-p0",
            resources=p.schema.Resources(cpus=1, mem=64)))
    try:
        sup.start()
        out.append(sorted(k for k in sup.procs[0].addr
                          if k not in ("port", "pid", "repl_port")))
        out.append("repl_port" in sup.procs[0].addr)
        out.append(sup.rpc(0, {"cmd": "ping"})["role"])
        out.append(sup.rpc(0, {"cmd": "put_pool", "name": "pool-p0"}))
        for i in range(3):
            out.append(sup.rpc(0, {"cmd": "submit", "jobs": [job(i)]}))
        out.append(sup.rpc(0, {"cmd": "job",
                               "uuid": "00000000-0000-4000-8000-"
                                       "000000000001"}))
        out.append(sup.rpc(0, {"cmd": "job", "uuid": "nope"}))
        status = sup.rpc(0, {"cmd": "repl_status"})
        out.append((status["synced_followers"], status["journal_bytes"] > 0))
        out.append(sup.rpc(0, {"cmd": "arm_fault", "point": "repl.ack",
                               "probability": 1.0, "max_fires": 1}))
        out.append(sup.rpc(0, {"cmd": "submit", "jobs": [job(9)]}))
        try:
            sup.rpc(0, {"cmd": "bogus"})
        except RuntimeError as e:
            out.append(str(e))
    finally:
        sup.stop()
    return out


@pytest.mark.parametrize("replicate", [True, False])
def test_store_worker_answers_as_the_reference(replicate, tmp_path):
    got = [store_script(p, tmp_path / p.root, replicate) for p in SIDES]
    assert got[1] == got[0]
    assert got[1][2] == "store"
    assert got[1][3] == {"ok": True}
