"""The port's chaos simulator (``cook_tpu_torch/sim/chaos.py``) against
the JAX package's (``cook_tpu/sim/chaos.py``) on the CPU.

Each call site of a chaos run in the reference's tests (``test_chaos``,
``test_pipeline``, ``test_resident``, ``test_gang``, ``test_elastic``,
``test_overload``, ``test_audit``, ``test_failover``, ``test_partition``
and ``test_sharded``) runs here at its own config and seed on both
packages, the port with ``device="cpu"`` where the function takes one
(its fused legs run the plain versions of K1-K6), and the reference
test's assertions hold on the port's result.

- ``run_chaos``: ``summary()`` less ``flight`` (host-clock cycle times)
  is equal, and so is every job's instance sequence in the final journal
  (hostname, status, reason code, start and end on the virtual clock;
  task ids are ``new_uuid()``, random on both sides; the generated
  trace's job uuids are fixed on both).
- The failover and partition modes: the fields no thread timing decides
  are equal (:data:`FAILOVER_FIELDS`, :data:`PARTITION_FIELDS`); the
  timed ones (commit counts, group-commit batching, the promotion
  window) are held on each side to the reference test's inequalities.
- The CLI: ``main([... "--device", "cpu"])`` against the reference's
  ``main`` on ``--chaos --seed 7``, ``--overload --chaos`` and the other
  chaos worlds ``chip_smoke.py``'s CH2 runs (:data:`CLI_MODES`).
- A data dir that either package's ``run_chaos`` wrote is replayed by
  the other (``Store.replay_only``) to the writer's own replay.

The injector draws its fires in call order, so equal summaries also say
that the port fires ``cluster.launch``, ``delta.extract``,
``delta.apply`` and ``store.journal.bitflip`` as often as the reference.
Every test starts and ends with both packages' process-wide planes in
their default state (``test_torch_daemon.fresh_planes``), and both
flight recorders' ``recent_durations`` read one fixed list (the overload
leg's ladder reads ``cycle_p99`` from them).
"""

import importlib
import json
import tempfile
import types

import pytest

from test_torch_daemon import fresh_planes

pytestmark = pytest.mark.chaos


def pkg(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("chaos", "sim.chaos"), ("main", "sim.__main__"),
                      ("store", "state.store"), ("flight", "utils.flight"),
                      ("repl", "state.replication")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


REF, PORT = pkg("cook_tpu"), pkg("cook_tpu_torch")
SIDES = (REF, PORT)
DEV = {"device": "cpu"}

needs_native = pytest.mark.skipif(
    not (REF.repl.replication_available()
         and PORT.repl.replication_available()),
    reason="C++ toolchain unavailable")

# the failover and partition summaries' fields that no thread timing
# decides
FAILOVER_FIELDS = ("ok", "violations", "winner", "winner_was_laggard",
                   "delta_pulled", "laggard_converged",
                   "indeterminate_commits", "fenced_appends_rejected",
                   "fenced_rest_writes_rejected", "audit_timeline_ok",
                   "group_commit_unresolved")
PARTITION_FIELDS = ("ok", "violations", "partitions", "promoted_epoch",
                    "unresolved_writers", "sibling_errors", "process_kill")


def _with_uuids(generate):
    def trace(*args, **kw):
        return [dict(e, uuid=f"00000000-0000-4000-8000-{i:012d}")
                for i, e in enumerate(generate(*args, **kw))]
    return trace


@pytest.fixture(autouse=True)
def _fresh_planes(monkeypatch):
    for p in SIDES:
        monkeypatch.setattr(
            p.flight.recorder, "recent_durations",
            lambda kinds, limit: [20.0] * max(int(limit), 0))
        # a generated trace has no uuids (load_trace mints random ones):
        # fix them, so that the two sides' jobs can be paired
        monkeypatch.setattr(p.chaos, "generate_example_trace",
                            _with_uuids(p.chaos.generate_example_trace))
    fresh_planes()
    yield
    fresh_planes()


def _no_flight(summary):
    return {k: v for k, v in summary.items() if k != "flight"}


def instance_sequences(side, data_dir):
    """Every job's instances in order, read back from the final journal:
    (hostname, status, reason code, start, end)."""
    store = side.store.Store.replay_only(str(data_dir))
    out = {}
    for job in sorted(store.jobs_where(lambda j: True),
                      key=lambda j: j.uuid):
        out[job.uuid] = [
            (i.hostname, i.status.value, i.reason_code, i.start_time_ms,
             i.end_time_ms)
            for t in job.instances
            if (i := store.instance(t)) is not None]
    return out


def chaos_pair(tmp_path, **kw):
    """``run_chaos`` at one config on both packages; the port's result
    after the parity checks."""
    runs = {}
    for side in SIDES:
        d = tmp_path / side.root
        cc = side.chaos.ChaosConfig(data_dir=str(d), **kw)
        res = side.chaos.run_chaos(cc, **({} if side is REF else DEV))
        runs[side.root] = (res, instance_sequences(side, d))
    (ref, ref_seq), (port, port_seq) = runs["cook_tpu"], \
        runs["cook_tpu_torch"]
    assert _no_flight(port.summary()) == _no_flight(ref.summary())
    assert ref_seq and port_seq == ref_seq
    return port


# ------------------------------------------------------------ run_chaos
def smoke(r):
    # tests/test_chaos.py::test_chaos_smoke
    assert r.ok, r.violations
    assert r.completed == r.total
    assert r.leader_kills == 1
    assert r.node_losses > 0
    assert r.rpc_faults > 0
    assert r.intents_open_at_kill > 0
    assert r.user_retries_charged == 0


def disk_faults(r):
    # tests/test_chaos.py::test_chaos_disk_faults_heal_before_promotion
    assert r.ok, r.violations
    assert r.completed == r.total
    assert r.leader_kills == 1
    assert r.disk_corruptions_healed > 0


def pipelined(r):
    # tests/test_pipeline.py::TestPipelinedChaos
    assert r.ok, r.violations
    assert r.completed == r.total


def resident(r):
    # tests/test_resident.py::test_chaos_resident_leader_kill_and_delta_
    # faults
    assert r.ok, r.violations
    assert r.completed == r.total
    assert r.leader_kills == 1
    assert r.delta_faults > 0
    assert r.flight["full_repacks"] >= r.delta_faults + 2


def gangs(r):
    # tests/test_gang.py::TestGangChaos
    assert r.ok, r.violations[:5]
    assert r.completed == r.total
    assert r.leader_kills == 1
    assert r.gang_requeues > 0


def elastic(r):
    # tests/test_elastic.py::TestElasticChaos
    assert r.ok, r.violations[:5]
    assert r.completed == r.total
    assert r.leader_kills == 1
    assert r.elastic_shrinks >= 1
    assert r.shrink_at_kill in ("delayed", "applied", "completed")


def overload(r):
    # tests/test_overload.py::TestChaosOverload
    assert r.ok, r.violations
    assert r.min_admission_level < 1.0
    assert r.brownout_stage_at_kill >= 1
    assert r.brownout_stage_recovered == r.brownout_stage_at_kill


def audit(r):
    # tests/test_audit.py::test_chaos_leader_kill_keeps_timelines
    assert r.ok, r.violations
    assert r.leader_kills == 1
    assert r.audit_timeline_ok


GANG_WORLD = dict(seed=7, n_jobs=20, n_hosts=9, n_gangs=3, gang_size=3,
                  rpc_fault_probability=0.2, rpc_fault_max=6,
                  node_loss_max=3)
CHAOS_CASES = {
    "smoke_seed7": (dict(seed=7), smoke),
    "disk_faults": (dict(seed=7, disk_fault_probability=0.25),
                    disk_faults),
    "pipelined": (dict(seed=7, n_jobs=14, n_hosts=6, submit_span_ms=12_000,
                       job_duration_ms=3_000, node_loss_every_ms=6_000,
                       node_loss_max=2, rpc_fault_probability=0.1,
                       rpc_fault_max=3, leader_kill_at_ms=8_000,
                       pipeline_depth=2), pipelined),
    "resident_delta_faults": (dict(seed=7, resident=True,
                                   rpc_fault_probability=0.0,
                                   delta_fault_probability=0.3), resident),
    "gangs_depth0": (dict(GANG_WORLD, pipeline_depth=0), gangs),
    "gangs_depth2": (dict(GANG_WORLD, pipeline_depth=2), gangs),
    "elastic": (dict(seed=0, elastic=True, n_gangs=2), elastic),
    "overload": (dict(seed=7, overload=True), overload),
    "audit_timelines": (dict(seed=2, n_jobs=10, n_users=2, n_hosts=4,
                             submit_span_ms=8_000, job_duration_ms=3_000,
                             leader_kill_at_ms=5_000,
                             node_loss_every_ms=10 ** 9,
                             rpc_fault_probability=0.0), audit),
}


@pytest.mark.parametrize("case", sorted(CHAOS_CASES))
def test_run_chaos_matches_the_reference(case, tmp_path):
    kw, check = CHAOS_CASES[case]
    check(chaos_pair(tmp_path, **kw))


def test_run_chaos_is_deterministic_as_the_reference(tmp_path):
    """tests/test_chaos.py::test_chaos_is_deterministic: the same seed
    twice on the port gives the same counters, and they are the
    reference's."""
    a = chaos_pair(tmp_path / "a", seed=3)
    b = PORT.chaos.run_chaos(PORT.chaos.ChaosConfig(
        seed=3, data_dir=str(tmp_path / "b")), **DEV)
    assert (a.ok, a.completed, a.node_losses, a.rpc_faults,
            a.intents_open_at_kill, a.makespan_ms) == \
        (b.ok, b.completed, b.node_losses, b.rpc_faults,
         b.intents_open_at_kill, b.makespan_ms)


def test_run_chaos_refuses_a_missing_card_before_arming(monkeypatch):
    """The default device is the card: without one ``run_chaos`` raises
    before it arms any process-wide plane."""
    import torch

    from cook_tpu_torch.utils.faults import injector
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        PORT.chaos.run_chaos(PORT.chaos.ChaosConfig(seed=7))
    assert injector.active() == {}


# ---------------------------------------------------- failover and partition
@needs_native
@pytest.mark.parametrize("mode,winner", [("sigkill", "laggard"),
                                         ("partition", "advanced")])
def test_failover_chaos_matches_the_reference(mode, winner, tmp_path):
    """tests/test_failover.py's two tier-1 failover runs."""
    out = {}
    for side in SIDES:
        r = side.chaos.run_failover_chaos(side.chaos.FailoverChaosConfig(
            seed=7, leader_mode=mode, winner=winner,
            data_root=str(tmp_path / side.root)))
        assert r.ok, r.violations
        assert r.laggard_converged
        if mode == "sigkill":
            assert r.winner_was_laggard and r.delta_pulled
            assert r.indeterminate_commits == 1
        else:
            assert not r.winner_was_laggard and not r.delta_pulled
            assert r.fenced_appends_rejected == 1
            assert r.fenced_rest_writes_rejected == 1
        # thread-timed: which concurrent writers share the faulted round
        s = r.summary()
        outcomes = s["group_commit_outcomes"]
        assert sum(outcomes.values()) == 8
        assert outcomes.get("indeterminate", 0) >= 1
        assert set(outcomes) <= {"committed", "indeterminate"}
        assert s["group_commit_batches"] >= 1
        out[side.root] = {k: s[k] for k in FAILOVER_FIELDS}
    assert out["cook_tpu_torch"] == out["cook_tpu"]


def _partition_timed(r, cc):
    # the fields thread timing decides, held to the reference test's
    # inequalities and to their own accounting
    assert r.victim_indeterminate >= 1
    assert r.sibling_commits_during_promotion >= 1
    assert r.promotion_window_s >= 0.0
    assert r.committed == sum(r.committed_by_partition.values())
    assert r.committed >= cc.partitions * cc.jobs_before


@needs_native
def test_partition_chaos_matches_the_reference(tmp_path):
    """tests/test_partition.py::test_partition_leader_loss_chaos: the
    in-process partitioned failover."""
    out = {}
    for side in SIDES:
        cc = side.chaos.PartitionChaosConfig(
            seed=1, partitions=2, data_root=str(tmp_path / side.root))
        r = side.chaos.run_partition_chaos(cc)
        assert r.ok, r.violations
        assert r.sibling_errors == 0
        assert r.unresolved_writers == 0
        assert r.promoted_epoch == 2
        _partition_timed(r, cc)
        out[side.root] = {k: r.summary()[k] for k in PARTITION_FIELDS}
    assert out["cook_tpu_torch"] == out["cook_tpu"]


@needs_native
@pytest.mark.sharded
def test_partition_chaos_procs_matches_the_reference(tmp_path):
    """tests/test_sharded.py::TestProcessKillFailover::test_sigkill_
    failover_smoke: each partition leader a shard worker process of its
    own package (the port's ``python -m cook_tpu_torch.sched.shard``),
    the victim lost to a real SIGKILL."""
    out = {}
    for side in SIDES:
        cc = side.chaos.PartitionChaosConfig(
            partitions=2, jobs_before=2, writers=2, sibling_stream_s=0.8,
            data_root=str(tmp_path / side.root))
        r = side.chaos.run_partition_chaos_procs(cc)
        assert r.ok, r.violations
        assert r.process_kill is True
        assert r.promoted_epoch == 2
        assert r.sibling_errors == 0
        assert r.summary()["process_kill"] is True
        _partition_timed(r, cc)
        out[side.root] = {k: r.summary()[k] for k in PARTITION_FIELDS}
    assert out["cook_tpu_torch"] == out["cook_tpu"]


# ------------------------------------------------------------------ CLI
def _main(side, argv, capsys):
    rc = side.main.main(argv)
    out, _err = capsys.readouterr()
    return rc, _no_flight(json.loads(out))


# the chaos modes as the CLI reaches them (chip_smoke.py's CH2 worlds)
CLI_MODES = {
    "chaos_seed7": ["--chaos", "--seed", "7"],
    "overload_chaos": ["--overload", "--chaos"],
    "pipelined": ["--chaos", "--seed", "7", "--jobs", "14", "--n-hosts",
                  "6", "--leader-kill-at-ms", "8000",
                  "--pipeline-depth", "2"],
    "resident_delta_faults": ["--chaos", "--seed", "7", "--resident",
                              "--delta-faults", "0.3"],
    "gangs_depth2": ["--chaos", "--seed", "7", "--jobs", "20",
                     "--n-hosts", "9", "--gangs", "3", "--gang-size", "3",
                     "--pipeline-depth", "2"],
    "elastic": ["--chaos", "--elastic"],
    "disk_faults": ["--chaos", "--seed", "7", "--disk-faults", "0.25"],
}


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_main_chaos_modes_match_the_reference(mode, capsys, monkeypatch,
                                              tmp_path):
    argv = CLI_MODES[mode]
    # the CLI's run_chaos journals into a fresh temporary directory
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref = _main(REF, argv, capsys)
    port = _main(PORT, argv + ["--device", "cpu"], capsys)
    assert port == ref
    assert ref[0] == 0 and ref[1]["ok"]


# ------------------------------------------------------- state carried across
def test_data_dirs_read_across_packages(tmp_path):
    """A resident, depth-2 world under journal bit flips: each package's
    ``Store.replay_only`` reads the data dir the other's ``run_chaos``
    wrote, to the writer's own replay less ``tx_id``."""
    kw = dict(seed=7, resident=True, pipeline_depth=2,
              disk_fault_probability=0.25)
    r = chaos_pair(tmp_path, **kw)
    assert r.ok, r.violations
    assert r.disk_corruptions_healed > 0
    for writer, reader in ((REF, PORT), (PORT, REF)):
        d = str(tmp_path / writer.root)
        own = json.loads(writer.store.Store.replay_only(d).snapshot())
        other = json.loads(reader.store.Store.replay_only(d).snapshot())
        own.pop("tx_id", None)
        other.pop("tx_id", None)
        assert own["jobs"] and other == own
