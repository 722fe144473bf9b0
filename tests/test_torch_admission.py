"""The port's adaptive admission (``sched/admission.py``) against the JAX
package's on the CPU.

The controller is driven through the same saturation sequences on both
packages (the reference's cases of ``tests/test_overload.py`` and seeded
ones); after every step the level, stage, worst resource, transitions,
the journaled dynamic-config document, ``stage_from_store`` and the shed
side effects must be equal.  Then a ``Scheduler`` of each package with
``config.admission.enabled`` runs the split cycle at an admission level
below 1: the considerable window shrinks to ``int(window * level)`` and
the cut is written as ``admission-throttled`` skips; launched pairs,
counts and each job's skip events must equal the reference's, on both
rank backends and for a direct pool.
"""

import importlib

import numpy as np
import pytest

from test_torch_driver import PORT, REF, launched, counts
from test_torch_scheduler import WORLDS, DIRECT, make_world, settle

SIDES = [(m, importlib.import_module(f"{m.root}.sched.admission"))
         for m in (REF, PORT)]


class _Obs:
    capture = True


def controllers(**admission_kw):
    """One controller a package over a fresh store with a virtual clock
    (the reference's ``make_controller``)."""
    out = []
    for m, adm in SIDES:
        store = m.Store()
        clk = [1_000_000]
        store.clock = lambda clk=clk: clk[0]
        cfg = m.Config()
        cfg.admission.enabled = True
        for k, v in admission_kw.items():
            setattr(cfg.admission, k, v)
        out.append((adm.AdmissionController(store, cfg, request_obs=_Obs()),
                    store, clk, adm))
    return out


def observe(side):
    ctrl, store, _clk, adm = side
    return (ctrl.level, ctrl.stage, ctrl.worst_resource, ctrl.worst_value,
            ctrl.state(), list(ctrl.transitions),
            store.dynamic_config(adm.CONFIG_KEY),
            adm.stage_from_store(store), store.audit.shed_advisory,
            ctrl.request_obs.capture)


def drive(sides, seq):
    """``seq``: (clock advance ms, saturation dict) steps, on both sides;
    every step's observation equal."""
    for n, (dt, sat) in enumerate(seq):
        for ctrl, _store, clk, _adm in sides:
            clk[0] += dt
            ctrl.decide(dict(sat))
        assert observe(sides[0]) == observe(sides[1]), f"step {n}"
    return observe(sides[1])


CASES = {
    "dead_zone": ({}, [(0, {"cpu": s})
                       for s in (0.7, 0.79, 0.61, 0.75, 0.79, 0.61)]),
    "engage_edge": ({}, [(0, {"cpu": 0.8})]),
    "deeper_overload": ({}, [(0, {"cpu": 1.0})]),
    "floor": ({}, [(0, {"cpu": 1.0})] * 50),
    "recovery": ({}, [(0, {"mem": 1.0})] * 10 + [(0, {"mem": 0.0})] * 100),
    "stage_order": ({}, [(0, {"queue": 1.0})] * 6),
    "multi_stage_jump": ({"decrease_step": 1.0}, [(0, {"cpu": 1.0})]),
    "dwell_deescalation": ({"recover_step": 1.0, "stage_hold_seconds": 10.0},
                           [(0, {"cpu": 1.0})] * 6
                           + [(10_001, {"cpu": 0.0})] * 8),
    "brief_dip": ({"recover_step": 1.0, "stage_hold_seconds": 10.0},
                  [(0, {"cpu": 1.0})] * 6 + [(3_000, {"cpu": 0.0})] * 2),
    "empty_gauges": ({}, [(0, {})] * 3 + [(0, {"cpu": 1.0})] * 3
                     + [(0, {})] * 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_controller_parity_on_reference_cases(case):
    kw, seq = CASES[case]
    final = drive(controllers(**kw), seq)
    level, stage = final[0], final[1]
    if case == "dead_zone":
        assert level == 1.0 and stage == 0 and final[5] == []
    elif case == "stage_order":
        assert [(t["from_name"], t["to_name"]) for t in final[5]] == [
            ("none", "shed-observability"),
            ("shed-observability", "stale-reads"),
            ("stale-reads", "shed-writes")]
    elif case == "dwell_deescalation":
        assert stage == 0 and final[8] is False
    elif case == "brief_dip":
        assert stage == 3


@pytest.mark.parametrize("seed", range(6))
def test_controller_parity_on_seeded_sequences(seed):
    rng = np.random.default_rng(seed)
    kw = {"stage_hold_seconds": float(rng.integers(1, 20)),
          "recover_step": float(rng.choice([0.05, 0.1, 0.5])),
          "decrease_step": float(rng.choice([0.1, 0.2, 0.6]))}
    resources = ["cycle_p99", "audit_queue", "launch_tokens",
                 "group_commit_queue"]
    seq = []
    for _ in range(80):
        sat = {r: float(rng.random() ** float(rng.choice([0.3, 1.0, 3.0])))
               for r in resources if rng.random() < 0.8}
        seq.append((int(rng.integers(0, 8_000)), sat))
    drive(controllers(**kw), seq)


def test_force_shed_writes_and_restore_parity():
    sides = controllers(stage_hold_seconds=5.0)
    drive(sides, [(0, {"cpu": 0.9})] * 2)
    for ctrl, _store, _clk, _adm in sides:
        ctrl.force_shed_writes("disk-full")
    assert observe(sides[0]) == observe(sides[1])
    assert sides[1][0].stage == 3
    for ctrl, _store, _clk, _adm in sides:
        ctrl.force_shed_writes("disk-full")   # already at stage 3: no-op
    assert observe(sides[0]) == observe(sides[1])
    drive(sides, [(6_000, {"cpu": 0.0})] * 30)
    # a successor over the same store resumes at the journaled stage
    sides[0][0].decide({"cpu": 1.0})
    sides[1][0].decide({"cpu": 1.0})
    restored = []
    for ctrl, store, _clk, adm in sides:
        again = adm.AdmissionController(store, ctrl.config,
                                        request_obs=_Obs())
        restored.append((again.level, again.stage, again.request_obs.capture,
                         store.audit.shed_advisory))
    assert restored[0] == restored[1]


def test_level_scales_submission_refill_parity():
    out = []
    for (ctrl, _store, _clk, _adm), (m, _a) in zip(controllers(), SIDES):
        rl = m.TokenBucketRateLimiter(60.0, 60.0, clock=lambda: 0.0)
        ctrl.rate_limits = m.RateLimits(job_submission=rl)
        scales = []
        for sat in [1.0, 1.0, 0.9, 0.0, 0.0]:
            ctrl.decide({"cpu": sat})
            scales.append(rl.refill_scale)
        out.append(scales)
    assert out[0] == out[1]
    assert out[1][-1] < 1.0


# -------------------------------------------------------- the scheduler
def _admission(spec, window):
    setup = spec.get("setup", lambda w, cfg: None)

    def with_admission(w, cfg):
        setup(w, cfg)
        cfg.admission.enabled = True
        cfg.default_matcher.max_jobs_considered = window
    return {**spec, "setup": with_admission}


def _throttled(w):
    """job uuid -> its admission-throttled skip events' data, in order."""
    out = {}
    for j in w.jobs:
        evs = [e["data"] for e in w.store.audit.timeline(j.uuid)
               if e["kind"] == "skip"
               and e["data"].get("reason") == "admission-throttled"]
        if evs:
            out[j.uuid] = evs
    return out


@pytest.mark.parametrize("level", [0.5, 1.0])
@pytest.mark.parametrize("backend", ["tpu", "cpu"])
@pytest.mark.parametrize("name", ["plain", "direct"])
def test_scheduler_split_cycle_under_admission(name, backend, level):
    spec = _admission(DIRECT if name == "direct" else WORLDS[name], 10)
    sides = [make_world(m, spec, depth=0, rank_backend=backend)
             for m in (REF, PORT)]
    for w in sides:
        assert w.sched.matcher.admission is w.sched.admission
        assert w.sched.monitor.admission is w.sched.admission
        w.sched.admission.level = level
    total = 0
    for c in range(3):
        res = []
        for w in sides:
            w.sched.step_rank()
            res.append(w.sched.step_match())
            settle(w)
        assert launched(sides[0], res[0]) == launched(sides[1], res[1]), c
        assert counts(res[0]) == counts(res[1]), c
        total += sum(len(v) for v in launched(sides[1], res[1]).values())
        for w in sides:
            w.churn(6)
            settle(w)
    throttled = [_throttled(w) for w in sides]
    assert throttled[0] == throttled[1]
    assert total > 0
    assert bool(throttled[1]) == (level < 1.0)
    if level < 1.0:
        considered = [r.considered for r in res[1].values()]
        assert max(considered) <= int(10 * level)


def test_scheduler_sweep_drives_the_controller():
    """The monitor sweep feeds the controller: with the cycle-duration
    objective far below the cycles' durations both sides walk the level
    down identically."""
    spec = _admission(WORLDS["plain"], 10)
    sides = [make_world(m, spec, depth=0) for m in (REF, PORT)]
    for w in sides:
        w.cfg.slo.cycle_duration_objective_s = 1e-9
    for c in range(3):
        for w in sides:
            w.sched.step_rank()
            w.sched.step_match()
            settle(w)
            w.sched.monitor.sweep()
        states = [w.sched.admission.state() for w in sides]
        assert [s["stage"] for s in states] == [states[1]["stage"]] * 2
        assert states[0]["level"] == states[1]["level"] < 1.0
