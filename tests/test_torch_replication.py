"""The port's HA state plane (``sched/election``, ``state/replication``,
``state/read_replica``, ``state/repair``, ``sim/crashpoint``) against the
JAX package's on the CPU.

Both packages write one journal format, so most cases cross the
packages: the port's replication server feeds the reference's follower
and the reverse, and the mirrored bytes must equal the leader's; the
port's and the reference's file electors contend for one lock.  The
pure failover functions give equal outputs on the cases of
``tests/test_failover.py``, and the crash-point matrix gives equal
summaries.  Each package has its own fault injector and metrics
registry; every test starts and ends with both injectors clear.
"""

import importlib
import os
import shutil
import threading
import time
import types

import pytest


def pkg(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("repl", "state.replication"),
                      ("read_replica", "state.read_replica"),
                      ("repair", "state.repair"),
                      ("store", "state.store"), ("schema", "state.schema"),
                      ("integrity", "state.integrity"),
                      ("election", "sched.election"),
                      ("crashpoint", "sim.crashpoint"),
                      ("k8s_fake", "cluster.k8s.fake_api"),
                      ("faults", "utils.faults")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


REF, PORT = pkg("cook_tpu"), pkg("cook_tpu_torch")
SIDES = (REF, PORT)

needs_native = pytest.mark.skipif(
    not (REF.repl.replication_available()
         and PORT.repl.replication_available()),
    reason="C++ toolchain unavailable")


@pytest.fixture(autouse=True)
def _clear_injectors():
    for p in SIDES:
        p.faults.injector.clear()
    yield
    for p in SIDES:
        p.faults.injector.clear()


def make_job(p, i, user="alice"):
    return p.schema.Job(uuid=f"00000000-0000-0000-0000-{i:012d}", user=user,
                        command=f"echo {i}",
                        resources=p.schema.Resources(cpus=1, mem=64))


def journal(d):
    try:
        with open(os.path.join(d, "journal.jsonl"), "rb") as f:
            return f.read()
    except FileNotFoundError:
        return b""


def wait_for(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# ------------------------------------------------ the failover functions
def _genesis(d):
    pass


def _token_never_synced(d):
    (d / "repl_token").write_text("tok")
    (d / "journal.jsonl").write_bytes(b'{"tx": 1}\n{"torn')


def _following_epoch(d):
    _token_never_synced(d)
    (d / "repl_epoch").write_text("3")


def _synced(d):
    _following_epoch(d)
    (d / "repl_synced").write_text("1")


def _following_only(d):
    (d / "repl_following").write_text("1")


MIRRORS = {"genesis": _genesis, "token_never_synced": _token_never_synced,
           "following_epoch": _following_epoch, "synced": _synced,
           "following_only": _following_only}


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the type and message are the outcome
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("mirror", sorted(MIRRORS))
def test_candidate_position_and_promotable_equal(mirror, tmp_path):
    out = []
    for p in SIDES:
        d = tmp_path / p.root
        d.mkdir()
        MIRRORS[mirror](d)
        out.append((p.repl.candidate_position(str(d)),
                    _outcome(lambda: p.repl.assert_promotable(str(d)))))
    assert out[0] == out[1]


POSITIONS = [
    {"synced": False, "epoch": 9, "offset": 10 ** 9},
    {"synced": True, "epoch": 1, "offset": 10},
    {"synced": True, "epoch": 2, "offset": 5},
    {"synced": True, "epoch": 2, "offset": 50},
    {"synced": True, "epoch": 2, "offset": 200, "ts": 95.0},
    {"synced": True, "epoch": 2, "offset": 999, "ts": 0.0},
    {"epoch": 4},
]

SUCCESSOR_CASES = {
    "prefers_ahead_synced": (
        {"synced": True, "epoch": 2, "offset": 100},
        {"never-synced": POSITIONS[0], "lagged": POSITIONS[3],
         "ahead": {"synced": True, "epoch": 2, "offset": 200},
         "older-leadership": {"synced": True, "epoch": 1,
                              "offset": 10 ** 9}}, {}),
    "none_when_best": (
        {"synced": True, "epoch": 2, "offset": 100},
        {"b": {"synced": True, "epoch": 2, "offset": 100},
         "c": {"synced": False, "epoch": 3, "offset": 999}}, {}),
    "stale_ghost": (
        {"synced": True, "epoch": 2, "offset": 100}, {"g": POSITIONS[5]},
        {"now": 100.0, "stale_s": 10.0}),
    "fresh_peer": (
        {"synced": True, "epoch": 2, "offset": 100}, {"g": POSITIONS[4]},
        {"now": 100.0, "stale_s": 10.0}),
    "unsynced_me": (
        {"synced": False, "epoch": 0, "offset": 0},
        {"a": POSITIONS[1], "b": POSITIONS[2]}, {}),
}


@pytest.mark.parametrize("case", sorted(SUCCESSOR_CASES))
def test_choose_successor_equal(case):
    me, peers, kw = SUCCESSOR_CASES[case]
    out = [p.repl.choose_successor(me, peers, **kw) for p in SIDES]
    assert out[0] == out[1]


def test_rank_key_orders_equally():
    out = [sorted(range(len(POSITIONS)),
                  key=lambda i: p.repl.rank_key(POSITIONS[i]))
           for p in SIDES]
    assert out[0] == out[1]
    assert [p.repl.rank_key(x) for x in POSITIONS for p in (REF,)] == \
        [p.repl.rank_key(x) for x in POSITIONS for p in (PORT,)]


def test_known_members_equal(tmp_path):
    out = []
    now = time.time()
    for p in SIDES:
        el = p.election.FileLeaderElector(str(tmp_path / "cook-leader.lock"),
                                          "http://n0")
        el.publish_candidate("n1", {"url": "http://n1", "ts": now})
        el.publish_candidate("n2", {"url": "http://n2", "ts": 0.0})
        members = p.repl.known_members(
            el, "n0", "http://n0", leader=True,
            extra=[{"instance": "agent-9", "url": "http://n9"}])
        members["n0"].pop("ts")   # this node's own entry: the host clock
        out.append(members)
        el.clear_candidate("n1")
        el.clear_candidate("n2")
    assert out[0] == out[1]


# ------------------------------------------------ replication across
DIRECTIONS = {"port_to_ref": (PORT, REF), "ref_to_port": (REF, PORT)}


def _sync_commit(lead, follow, a, b):
    store = lead.store.Store.open(a, epoch=1, shared=False)
    with lead.repl.ReplicationServer(a) as srv:
        store.attach_replication(srv, sync=True)
        with follow.repl.ReplicationFollower("127.0.0.1", srv.port, b):
            assert wait_for(lambda: srv.synced_follower_count >= 1)
            store.create_jobs([make_job(lead, i) for i in range(50)])
            # sync mode: committed implies on the mirror
            assert journal(b) == journal(a)
    return 50


def _late_joiner(lead, follow, a, b):
    store = lead.store.Store.open(a, epoch=1, shared=False)
    store.create_jobs([make_job(lead, i) for i in range(200)])
    with lead.repl.ReplicationServer(a) as srv:
        store.attach_replication(srv, sync=True)
        with follow.repl.ReplicationFollower("127.0.0.1", srv.port, b) as f:
            assert f.wait_offset(len(journal(a)))
    return 200


def _checkpoint_resync(lead, follow, a, b):
    store = lead.store.Store.open(a, epoch=1, shared=False)
    with lead.repl.ReplicationServer(a) as srv:
        store.attach_replication(srv, sync=True)
        with follow.repl.ReplicationFollower("127.0.0.1", srv.port, b):
            assert wait_for(lambda: srv.synced_follower_count >= 1)
            store.create_jobs([make_job(lead, i) for i in range(30)])
            store.checkpoint()
            store.create_jobs([make_job(lead, i) for i in range(30, 40)])
            assert wait_for(
                lambda: journal(b) == journal(a) and os.path.exists(
                    os.path.join(b, "snapshot.json")))
    with open(os.path.join(a, "snapshot.json"), "rb") as fa, \
            open(os.path.join(b, "snapshot.json"), "rb") as fb:
        assert fa.read() == fb.read()
    return 40


SCENARIOS = {"sync_commit": _sync_commit, "late_joiner": _late_joiner,
             "checkpoint_resync": _checkpoint_resync}


@needs_native
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_replication_across_packages(direction, scenario, tmp_path):
    lead, follow = DIRECTIONS[direction]
    a, b = str(tmp_path / "leader"), str(tmp_path / "mirror")
    n = SCENARIOS[scenario](lead, follow, a, b)
    assert journal(b) == journal(a) and journal(a)
    # the mirror replays to the same jobs in both packages
    for p in SIDES:
        replica = p.store.Store.replay_only(b)
        assert len(replica.jobs_where(lambda j: True)) == n


@needs_native
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_catch_up_from_peer_across_packages(direction, tmp_path):
    """A standby pulls its missing delta from a peer's mirror server
    (coordinated promotion's state transfer) across the packages."""
    lead, follow = DIRECTIONS[direction]
    a, b = str(tmp_path / "peer"), str(tmp_path / "me")
    store = lead.store.Store.open(a, epoch=1, shared=False)
    store.create_jobs([make_job(lead, i) for i in range(25)])
    with lead.repl.ReplicationServer(a, 0) as srv:
        assert follow.repl.catch_up_from_peer("127.0.0.1", srv.port, b,
                                              len(journal(a)),
                                              timeout_s=10.0)
    assert journal(b) == journal(a)


# ------------------------------------------------ follower read view
def _seeded_journal(p, d, n_jobs, checkpoint_at=None):
    store = p.store.Store.open(d, fsync=False)
    for k, op in enumerate(p.crashpoint.build_ops(n_jobs)):
        p.crashpoint.apply_op(store, op)
        if checkpoint_at is not None and k == checkpoint_at:
            store.checkpoint()
    store.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("n_jobs,checkpoint_at", [(3, None), (6, None),
                                                   (6, 7)])
def test_follower_read_view_digests_equal(writer, n_jobs, checkpoint_at,
                                          tmp_path):
    d = str(tmp_path / "journal")
    _seeded_journal(REF if writer == "ref" else PORT, d, n_jobs,
                    checkpoint_at)
    digests = []
    for p in SIDES:
        view = p.read_replica.FollowerReadView(d, start=False)
        try:
            view.poll()
            assert view.corrupt is None
            digests.append((p.crashpoint.state_digest(view.store),
                            view.offset))
        finally:
            view.stop()
    assert digests[0] == digests[1]
    assert digests[0][0]


# ------------------------------------------------ repair
def _flip(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x40]))


@pytest.mark.parametrize("with_peer", [False, True])
def test_open_with_repair_and_quarantine_equal(with_peer, tmp_path):
    if with_peer and not PORT.repl.replication_available():
        pytest.skip("C++ toolchain unavailable")
    pristine = str(tmp_path / "pristine")
    _seeded_journal(REF, pristine, 5)
    out = []
    for p in SIDES:
        d = str(tmp_path / f"bad-{p.root}")
        shutil.copytree(pristine, d)
        _flip(os.path.join(d, "journal.jsonl"))
        if with_peer:
            with PORT.repl.ReplicationServer(pristine, 0) as srv:
                res = _outcome(lambda: p.crashpoint.state_digest(
                    p.repair.open_with_repair(
                        d, peers=[("127.0.0.1", srv.port)],
                        timeout_s=10.0)))
            files = sorted(f for f in os.listdir(d)
                           if not f.startswith("."))
        else:
            res = _outcome(lambda: p.repair.open_with_repair(d))
            res = (res[0], res[1].replace(d, "<dir>"))
            p.repair.quarantine(d)
            files = sorted(os.listdir(d))
        out.append((res, files, journal(d) == journal(pristine)))
    assert out[0] == out[1]
    if with_peer:
        assert out[0][0][0] == "ok" and out[0][2]
    else:
        assert out[0][0][0] == "JournalCorruptionError"


# ------------------------------------------------ election
def test_file_electors_single_winner_and_takeover(tmp_path):
    """A reference elector and a port elector contend for one lock:
    exactly one wins, the other takes over on resign, and the epoch file
    counts both leaderships."""
    lock = str(tmp_path / "cook-leader.lock")
    won = {p.root: threading.Event() for p in SIDES}
    els = {p.root: p.election.FileLeaderElector(
        lock, f"http://{p.root}", on_leadership=won[p.root].set,
        poll_interval_s=0.02) for p in SIDES}
    try:
        els["cook_tpu_torch"].campaign()
        assert won["cook_tpu_torch"].wait(5)
        els["cook_tpu"].campaign()
        time.sleep(0.2)
        assert not won["cook_tpu"].is_set()
        assert [e.is_leader for e in els.values()] == [False, True]
        for e in els.values():
            assert e.leader_url() == "http://cook_tpu_torch"
        els["cook_tpu_torch"].resign()
        assert won["cook_tpu"].wait(5)
        assert els["cook_tpu"].epoch == els["cook_tpu_torch"].epoch + 1
        for e in els.values():
            assert e.leader_url() == "http://cook_tpu"
    finally:
        for e in els.values():
            e.resign()


def test_file_elector_sidecars_round_trip(tmp_path):
    lock = str(tmp_path / "cook-leader.lock")
    ref = REF.election.FileLeaderElector(lock, "http://a")
    port = PORT.election.FileLeaderElector(lock, "http://b")
    ref.publish_candidate("node/a:1", {"epoch": 2, "offset": 10})
    port.publish_candidate("node-b", {"epoch": 2, "offset": 20,
                                      "synced": True})
    assert ref.read_candidates() == port.read_candidates()
    assert sorted(port.read_candidates().values(),
                  key=lambda x: x["offset"])[0] == {"epoch": 2,
                                                    "offset": 10}
    port.clear_candidate("node/a:1")
    assert list(ref.read_candidates().values()) == [
        {"epoch": 2, "offset": 20, "synced": True}]
    assert PORT.election.partition_lock_path(str(tmp_path), 3) == \
        REF.election.partition_lock_path(str(tmp_path), 3)


def test_lease_electors_over_the_reference_fake_api():
    """Each package's lease electors take turns on its own package's
    fake Kubernetes API under one pinned clock, and each step's outcome
    (won, epoch, leader url, candidates) is equal for the two packages
    run separately."""
    def script(m):
        api = m.k8s_fake.FakeKubernetesApi()
        now = [1000.0]
        events = []
        mk = lambda ident: m.election.LeaseLeaderElector(  # noqa: E731
            api, identity=ident, node_url=f"http://{ident}",
            duration_s=10.0, clock=lambda: now[0],
            on_leadership=lambda: events.append(("lead", ident)),
            on_loss=lambda: events.append(("loss", ident)))
        a, b = mk("a"), mk("b")
        out = [a.try_once(), b.try_once(), a.epoch, a.leader_url()]
        a.publish_candidate("b", {"offset": 5})
        out.append(b.read_candidates())
        now[0] += 11.0            # a's lease lapses
        out += [b.try_once(), b.epoch, a.try_once(), b.leader_url()]
        b.resign()
        out += [a.try_once(), a.epoch, a.leader_url(), events]
        return out

    assert script(REF) == script(PORT)


# ------------------------------------------------ the crash-point matrix
def test_run_crashpoints_equal():
    out = [p.crashpoint.run_crashpoints(n_jobs=4).summary() for p in SIDES]
    assert out[0] == out[1]
    assert out[0]["ok"] and out[0]["cases"] > 100
