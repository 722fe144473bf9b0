"""The port's simulator (``cook_tpu_torch/sim``) against the JAX
package's on the CPU.

The reference side runs as ``tests/test_simulator.py`` runs it
(``JAX_PLATFORMS=cpu``: its fused XLA cycle and split kernels on the
CPU); the port side runs with ``device="cpu"`` (the plain PyTorch
versions of K1-K6).  Every world is built on both sides from one numpy
seed with fixed job uuids.  The task records must be equal less the task
id (``new_uuid()``, random on both sides), and so must ``summary()``
less :data:`HOST_CLOCK` and :data:`TRANSFER_TELEMETRY`.
"""

import importlib
import json
import types

import numpy as np
import pytest
import torch

from test_torch_monitor import fresh_request_log


def pkg(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("sim", "sim"), ("simulator", "sim.simulator"),
                      ("workload", "sim.workload"),
                      ("overload", "sim.overload"), ("main", "sim.__main__"),
                      ("schema", "state.schema"), ("config", "config"),
                      ("instrument", "rest.instrument"),
                      ("retry", "utils.retry")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


REF, PORT = pkg("cook_tpu"), pkg("cook_tpu_torch")
DEV = {"device": "cpu"}

# summary() fields read off the host's clock: wall times of the cycles
# and the rates derived from them
HOST_CLOCK = ("match_cycle_p50_ms", "match_cycle_p99_ms",
              "rank_cycle_p50_ms", "placements_per_wall_s")
FLIGHT_HOST_CLOCK = ("cycle_ms_p50", "cycle_ms_p99", "detail_ms",
                     "sync_wait_ms")
# the flight summary's accounting of each implementation's own device
# work: XLA's compiles and the bytes each package's staging moves (the
# JAX wire and the port's tensors are laid out differently); neither is
# a scheduling decision
TRANSFER_TELEMETRY = ("recompiles", "h2d_bytes", "d2h_bytes")


@pytest.fixture(autouse=True)
def _fresh_planes():
    # the overload replay's admission controller drives each package's
    # request log, and every simulator launches through the process-wide
    # circuit breaker of its cluster "sim": both start and end every test
    # in their default state, whatever ran before on the worker
    sides = [types.SimpleNamespace(m=p.config, instrument=p.instrument)
             for p in (REF, PORT)]

    def fresh():
        for side, p in zip(sides, (REF, PORT)):
            fresh_request_log(side)
            p.retry.breakers.get("sim").reset()

    fresh()
    yield
    fresh()


def comparable(summary):
    out = {k: v for k, v in summary.items() if k not in HOST_CLOCK}
    out["flight"] = {k: v for k, v in summary["flight"].items()
                     if k not in FLIGHT_HOST_CLOCK + TRANSFER_TELEMETRY}
    return out


def records(result):
    return [{k: v for k, v in r.items() if k != "task"}
            for r in result.task_records]


def fixed_uuids(entries, tag=0):
    for i, e in enumerate(entries):
        e["uuid"] = f"00000000-0000-4000-{0x8000 + tag:04x}-{i:012d}"
    return entries


# ------------------------------------------------------------ workload
WORKLOAD_SPEC = {  # tests/test_workload.py's spec
    "seed": 7,
    "horizon_ms": 600_000,
    "user_classes": [
        {"name": "batch", "users": 3, "arrival_rate_per_min": 6.0,
         "duration_ms": {"dist": "lognormal", "mu": 9.5, "sigma": 0.5},
         "cpus": {"dist": "choice", "values": [1, 2, 4],
                  "weights": [0.6, 0.3, 0.1]},
         "mem": {"dist": "uniform", "low": 128, "high": 1024},
         "priority": {"dist": "constant", "value": 50}},
        {"name": "interactive", "users": 2, "arrival_rate_per_min": 2.0,
         "duration_ms": {"dist": "exponential", "scale": 20_000},
         "cpus": 1.0, "mem": 256.0,
         "priority": {"dist": "constant", "value": 90}},
    ],
}


def seeded_spec(seed):
    """A workload spec drawn from ``seed``: every distribution kind, two
    to four user classes, one of them in a second pool."""
    rng = np.random.default_rng(seed)
    dists = [
        lambda: {"dist": "lognormal", "mu": float(rng.uniform(7, 10)),
                 "sigma": float(rng.uniform(0.2, 1.0))},
        lambda: {"dist": "exponential", "scale": float(rng.uniform(1e3,
                                                                   4e4))},
        lambda: {"dist": "uniform", "low": 500.0, "high": 9000.0},
        lambda: float(rng.integers(500, 5000)),
    ]
    classes = []
    for c in range(int(rng.integers(2, 5))):
        classes.append({
            "name": f"c{c}", "users": int(rng.integers(1, 5)),
            "arrival_rate_per_min": float(rng.uniform(0.5, 12.0)),
            "pool": "beta" if c == 1 else "default",
            "duration_ms": dists[int(rng.integers(0, len(dists)))](),
            "cpus": {"dist": "choice", "values": [1, 2, 3],
                     "weights": [float(w) for w in rng.uniform(0.1, 1, 3)]},
            "mem": {"dist": "uniform", "low": 64.0,
                    "high": float(rng.integers(256, 4096))},
            "gpus": {"dist": "constant", "value": 0},
            "priority": {"dist": "choice", "values": [10, 50, 120]},
        })
    return {"seed": int(rng.integers(0, 1000)),
            "horizon_ms": int(rng.integers(60_000, 400_000)),
            "user_classes": classes}


SPECS = {"reference": WORKLOAD_SPEC, "seeded-1": seeded_spec(1),
         "seeded-2": seeded_spec(2)}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_generate_trace_and_hosts_equal(name):
    spec = SPECS[name]
    for seed in (None, 5):
        assert PORT.workload.generate_trace(spec, seed=seed) == \
            REF.workload.generate_trace(spec, seed=seed)
    assert len(REF.workload.generate_trace(spec)) > 10
    for kw in ({}, {"cpus": 8.0, "mem": 32768.0, "gpus": 1.0,
                    "pool": "beta"}):
        assert PORT.workload.generate_hosts(7, **kw) == \
            REF.workload.generate_hosts(7, **kw)
    assert PORT.simulator.generate_example_trace(50, seed=len(name)) == \
        REF.simulator.generate_example_trace(50, seed=len(name))
    assert PORT.simulator.generate_example_hosts(9, seed=len(name)) == \
        REF.simulator.generate_example_hosts(9, seed=len(name))


# --------------------------------------------------------- simulator
def _example(p, seed):
    entries = fixed_uuids(p.simulator.generate_example_trace(
        60, n_users=5, seed=seed, span_ms=30_000, duration_ms=8_000))
    hosts = p.simulator.generate_example_hosts(6, seed=seed)
    return p.simulator.load_trace(entries), \
        p.simulator.load_hosts(hosts), None


def _fill_then_wait(p, seed):
    """One user fills the cluster, a second arrives later: the
    rebalancer preempts (tests/test_rebalance.py's shape)."""
    rng = np.random.default_rng(seed)
    entries = [{"user": "alice", "submit_time": int(rng.integers(0, 500)),
                "duration": 120_000, "cpus": 4.0, "mem": 512.0}
               for _ in range(12)]
    entries += [{"user": "bob", "submit_time": 5_000 + 100 * i,
                 "duration": int(rng.integers(2_000, 9_000)),
                 "cpus": 4.0, "mem": 512.0} for i in range(6)]
    hosts = [{"hostname": f"h{i}", "cpus": 16, "mem": 8192}
             for i in range(3)]
    return p.simulator.load_trace(fixed_uuids(entries, 1)), \
        p.simulator.load_hosts(hosts), None


def _gangs(p, seed, elastic=False):
    """Three gang groups of three co-submitted members among background
    jobs; ``elastic`` gives each gang a minimum of 2 and a maximum of 4
    (docs/GANG.md elasticity) under a zero shrink grace."""
    S = p.schema
    rng = np.random.default_rng(seed)
    jobs, groups = [], {}
    for g in range(3):
        guuid = f"00000000-0000-4000-9{g:03d}-000000000000"
        size = 4 if elastic else 3
        members = [S.Job(
            uuid=f"00000000-0000-4000-9{g:03d}-{i:012d}", user=f"u{g}",
            command="x", group=guuid,
            resources=S.Resources(cpus=float(rng.integers(1, 4)),
                                  mem=256.0),
            submit_time_ms=g * 3000,
            labels={"sim/duration_ms": str(int(rng.integers(4000, 9000)))})
            for i in range(size)]
        groups[guuid] = S.Group(
            uuid=guuid, gang=True, gang_size=size,
            gang_min=2 if elastic else 0, gang_max=size if elastic else 0,
            jobs=[m.uuid for m in members])
        jobs.extend(members)
    for b in range(14):
        jobs.append(S.Job(
            uuid=f"00000000-0000-4000-a000-{b:012d}", user=f"u{b % 4}",
            command="x",
            resources=S.Resources(cpus=float(rng.integers(1, 3)),
                                  mem=128.0),
            submit_time_ms=int(rng.integers(0, 12_000)),
            labels={"sim/duration_ms": str(int(rng.integers(2000, 6000)))}))
    jobs.sort(key=lambda j: j.submit_time_ms)
    hosts = p.simulator.load_hosts(
        [{"hostname": f"h{i}", "cpus": 6, "mem": 8192} for i in range(4)])
    return jobs, hosts, groups


def _elastic(p, seed):
    return _gangs(p, seed, elastic=True)


def _eager_rebalancer(p, cfg):
    # tests/test_rebalance.py's thresholds and share: any DRU gap preempts
    cfg.rebalancer = p.config.RebalancerConfig(
        safe_dru_threshold=0.0, min_dru_diff=0.0, max_preemption=10)
    return lambda sim: sim.store.set_share(
        "default", "default", {"cpus": 16.0, "mem": 8192.0})


WORLDS = {"example": (_example, 1, None),
          "fill-then-wait": (_fill_then_wait, 2, _eager_rebalancer),
          "gangs": (_gangs, 3, None), "elastic": (_elastic, 4, None)}
MODES = ("fused0", "fused2", "split", "cpu")


def run_world(p, name, mode, **kw):
    build, seed, setup = WORLDS[name]
    trace, hosts, groups = build(p, seed)
    cfg = p.config.Config()
    after = setup(p, cfg) if setup is not None else None
    cfg.elastic.shrink_grace_seconds = 0.0
    backend, cycle_mode = "tpu", "fused"
    if mode.startswith("fused"):
        cfg.pipeline.depth = int(mode[-1])
    elif mode == "split":
        cycle_mode = "split"
    else:
        backend, cycle_mode = "cpu", None
    sim = p.simulator.Simulator(trace, hosts, config=cfg, backend=backend,
                                cycle_mode=cycle_mode, groups=groups,
                                rank_interval_ms=1000, **kw)
    if after is not None:
        after(sim)
    return sim.run()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_simulator_run_parity(name, mode):
    ref = run_world(REF, name, mode)
    port = run_world(PORT, name, mode, **DEV)
    assert records(port) == records(ref)
    assert comparable(port.summary()) == comparable(ref.summary())
    assert ref.completed == ref.total
    if name == "fill-then-wait":
        assert ref.preemptions > 0
    if name in ("gangs", "elastic"):
        assert "gang_goodput" in ref.goodput


@pytest.mark.parametrize("depth,seed", [(2, 3), (1, 5)])
def test_run_pipeline_parity_equal(depth, seed):
    kw = dict(seed=seed, n_jobs=50, n_hosts=8, depth=depth)
    ref = REF.simulator.run_pipeline_parity(**kw)
    port = PORT.simulator.run_pipeline_parity(**kw, **DEV)
    assert port == ref
    assert ref["ok"]


@pytest.mark.parametrize("admission", [True, False])
def test_run_overload_equal(admission):
    kw = dict(horizon_ms=20_000, admission=admission)
    ref = REF.overload.run_overload(**kw)
    port = PORT.overload.run_overload(**kw, **DEV)
    assert port == ref
    assert ref["ok"]
    if admission:
        assert ref["admission"]["max_stage"] >= 1
    assert PORT.instrument.request_log.capture is True


# --------------------------------------------------------------- CLI
def _main(p, argv, capsys):
    rc = p.main.main(argv)
    out, _err = capsys.readouterr()
    return rc, out


@pytest.mark.parametrize("backend", ["tpu", "cpu"])
def test_main_workload_and_emit_trace(tmp_path, capsys, backend):
    # one pool: the generated hosts serve "default" only
    spec = dict(WORKLOAD_SPEC, horizon_ms=120_000)
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    outs = {}
    for p, extra in ((REF, []), (PORT, ["--device", "cpu"])):
        emitted = tmp_path / f"{p.root}.trace.json"
        csv_path = tmp_path / f"{p.root}.csv"
        rc, out = _main(p, ["--workload", str(spec_path), "--seed", "3",
                            "--emit-trace", str(emitted), "--n-hosts", "6",
                            "--backend", backend, "--out", str(csv_path)]
                        + extra, capsys)
        assert rc == 0
        outs[p.root] = (emitted.read_bytes(),
                        comparable(json.loads(out)),
                        _csv_rows(csv_path))
    assert outs["cook_tpu_torch"] == outs["cook_tpu"]


def _csv_rows(path):
    # the job and task columns hold new_uuid() ids (a generated trace has
    # no uuids), random on both sides; the rows keep the trace's order
    lines = path.read_text().splitlines()
    return [",".join(c for i, c in enumerate(line.split(","))
                     if i not in (0, 2)) for line in lines]


def test_main_parity_pipeline_and_overload_modes(capsys, monkeypatch):
    # the overload replay's admission ladder reads cycle_p99 from the
    # flight recorder's host-clock cycle durations
    # (sched/fleet.compute_saturation): both packages read one fixed
    # list, so a slow cycle under a loaded worker cannot move either
    # side's ladder
    for root in (REF.root, PORT.root):
        recorder = importlib.import_module(f"{root}.utils.flight").recorder
        monkeypatch.setattr(
            recorder, "recent_durations",
            lambda kinds, limit: [20.0] * max(int(limit), 0))
    for argv in (["--parity-pipeline", "--jobs", "30", "--n-hosts", "6"],
                 ["--overload", "--overload-multiple", "4"]):
        ref = _main(REF, argv, capsys)
        port = _main(PORT, argv + ["--device", "cpu"], capsys)
        assert port == ref
        assert ref[0] == 0


CELL_OUTAGE = {
    "--chaos --cell-outage": ["--chaos", "--cell-outage", "--cells", "3"],
    "--chaos --cell-outage (2 cells)": ["--chaos", "--cell-outage"],
    "--cell-outage": ["--cell-outage", "--jobs", "30", "--n-hosts", "6"],
}


@pytest.mark.parametrize("flag", sorted(CELL_OUTAGE))
def test_cell_outage_modes_match_the_reference(flag, capsys):
    """``--chaos --cell-outage`` runs the outage drill
    (``sim/federation.py``) and prints the reference's summary, byte for
    byte; ``--cell-outage`` without ``--chaos``, which the reference
    ignores, falls through to the default replay on both sides (its
    summary less the host-clock fields)."""
    argv = CELL_OUTAGE[flag]
    ref = _main(REF, argv, capsys)
    port = _main(PORT, argv + ["--device", "cpu"], capsys)
    assert ref[0] == 0 and port[0] == ref[0]
    if "--chaos" in argv:
        assert port[1] == ref[1]
        summary = json.loads(ref[1])
        assert summary["ok"] and summary["cells"] == (
            3 if "--cells" in argv else 2)
    else:
        assert comparable(json.loads(port[1])) == \
            comparable(json.loads(ref[1]))


def test_crashpoints_mode_matches_the_reference(capsys):
    """``--crashpoints`` runs the crash-point matrix and exits 0 with the
    reference's summary."""
    argv = ["--crashpoints", "--jobs", "2", "--crashpoint-stride", "3"]
    ref = _main(REF, argv, capsys)
    port = _main(PORT, argv + ["--device", "cpu"], capsys)
    assert port == ref
    summary = json.loads(ref[1])
    assert ref[0] == 0 and summary["ok"] and summary["violations"] == []


# ------------------------------------------------------ default device
def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


ENTRY_POINTS = {
    "Simulator": lambda: PORT.simulator.Simulator(
        *(_example(PORT, 1)[:2])),
    "run_pipeline_parity": lambda: PORT.simulator.run_pipeline_parity(
        n_jobs=5, n_hosts=2),
    "run_overload": lambda: PORT.overload.run_overload(horizon_ms=1_000),
    "main": lambda: PORT.main.main(["--jobs", "5", "--n-hosts", "2"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_without_a_card_raises(entry):
    _no_card()
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        ENTRY_POINTS[entry]()
