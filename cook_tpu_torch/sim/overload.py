"""The port's copy of ``cook_tpu/sim/overload.py`` (imports re-rooted);
``run_overload`` takes ``device`` (default ``"cuda"``) for its
``Simulator``.  Its ``backend="cpu"`` ranks and matches with the numpy
reference, as the reference's does.

Faster-than-real-time overload replay (docs/ROBUSTNESS.md).

The admission plane's proof harness: synthesize a Borg-trace-shaped
workload — heavy-tailed users (a couple of heavy hitters dominating
offered load over a long light tail), lognormal service times — at a
configurable multiple of sustainable capacity, replay it through the
REAL scheduler with the admission controller enabled, and report what
the brownout ladder actually did:

- the front door sheds excess offered load (per-user token buckets whose
  refill the controller scales by the admission level), so ADMITTED work
  keeps completing instead of every submission timing out together — the
  goodput-under-overload property (DAGOR, SoCC '18; metastable-failure
  avoidance, Bronson et al., HotOS '21);
- saturation is driven GENUINELY: a small launch-token bucket on the
  virtual clock saturates under pressure exactly the way the production
  monitor sweep reads it (sched/fleet.py ``launch_tokens``), no gauges
  are faked;
- brownout stages must engage in shed order (observability -> stale
  reads -> writes) and every flip is journaled via the dynamic-config
  plane (sched/admission.py);
- zero committed-write loss: every ADMITTED job exists in the store and
  reaches a terminal state; shed jobs were refused up front with an
  attributable reason, never accepted-then-dropped.

Run it: ``python -m cook_tpu_torch.sim --overload [--overload-multiple N]``;
asserted by tests/test_overload.py and benched by the ``overload`` leg
in bench.py (docs/BENCH_CPU_r17_overload.json).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..config import Config
from ..policy import RateLimits, TokenBucketRateLimiter, submission_limiter
from .simulator import Simulator, load_hosts, load_trace
from .workload import generate_hosts, generate_trace

#: heavy-tailed user mix (offered-load share, user count) — two heavy
#: hitters carry half the load, a long tail of light users the rest,
#: the shape cluster traces actually have (Borg trace; PAPER.md)
USER_MIX = (("heavy", 2, 0.50), ("medium", 6, 0.35), ("light", 16, 0.15))


def overload_spec(offered_per_min: float, horizon_ms: int = 45_000,
                  duration_mu: float = 8.0, duration_sigma: float = 0.6,
                  seed: int = 17) -> Dict:
    """A workload spec totalling ``offered_per_min`` arrivals across the
    heavy-tailed :data:`USER_MIX`; lognormal service times (median
    ``e**duration_mu`` ms)."""
    classes = []
    for name, users, share in USER_MIX:
        classes.append({
            "name": name, "users": users,
            "arrival_rate_per_min": offered_per_min * share / users,
            "duration_ms": {"dist": "lognormal", "mu": duration_mu,
                            "sigma": duration_sigma},
            "cpus": {"dist": "choice", "values": [1, 2],
                     "weights": [0.8, 0.2]},
            "mem": {"dist": "uniform", "low": 64, "high": 512},
            # a slice of every class is low-priority — the stage-3
            # write shed needs sheddable traffic to act on
            "priority": {"dist": "choice", "values": [10, 50, 80],
                         "weights": [0.3, 0.5, 0.2]},
        })
    return {"seed": seed, "horizon_ms": int(horizon_ms),
            "user_classes": classes}


def _overload_config(stage_hold_s: float) -> Config:
    cfg = Config()
    cfg.default_matcher.backend = "cpu"
    cfg.admission.enabled = True
    # per-user front-door budget: generous for the light tail, a hard
    # wall for the heavy hitters once the level scales refill down
    cfg.admission.submissions_per_minute = 60.0
    cfg.admission.submission_burst = 10.0
    cfg.admission.stage_hold_seconds = float(stage_hold_s)
    return cfg


def run_overload(offered_multiple: float = 10.0,
                 sustainable_per_min: float = 60.0,
                 n_hosts: int = 3, horizon_ms: int = 30_000,
                 launch_rate_per_min: float = 30.0,
                 launch_burst: float = 2.0,
                 sweep_interval_ms: int = 1_000,
                 stage_hold_s: float = 4.0,
                 seed: int = 17,
                 admission: bool = True,
                 max_virtual_ms: int = 20 * 60 * 1000,
                 device="cuda") -> Dict:
    """Replay ``offered_multiple`` x sustainable offered load through the
    real scheduler, admission controller in the loop (or bypassed with
    ``admission=False`` for the melt-down baseline), and summarize the
    ladder's behavior.  Deterministic for a given seed: the virtual
    clock drives arrivals, sweeps, bucket refills, and stage dwell."""
    spec = overload_spec(offered_multiple * sustainable_per_min,
                         horizon_ms=horizon_ms, seed=seed)
    trace = load_trace(generate_trace(spec, seed=seed))
    hosts = load_hosts(generate_hosts(n_hosts, cpus=8.0, mem=32768.0))

    cfg = _overload_config(stage_hold_s)
    cfg.admission.enabled = bool(admission)

    # one virtual timebase for EVERYTHING: the sim run patches
    # store.clock, and the token buckets read the same box in seconds
    now_box = [trace[0].submit_time_ms / 1000.0 if trace else 0.0]
    clock_s = lambda: now_box[0]  # noqa: E731 - one timebase
    launch_rl = TokenBucketRateLimiter(
        launch_rate_per_min, launch_burst, enforce=True, clock=clock_s)
    limits = RateLimits(job_launch=launch_rl)
    limits.job_submission = submission_limiter(
        cfg.admission if admission else None, clock=clock_s)

    sim = Simulator(trace, hosts, config=cfg, backend="cpu",
                    rate_limits=limits, device=device)
    ctrl = sim.scheduler.admission
    shed: Dict[str, int] = {}
    min_level = [1.0]
    next_sweep = [trace[0].submit_time_ms if trace else 0]

    def admit(job, now_ms: int) -> bool:
        now_box[0] = now_ms / 1000.0
        ac = cfg.admission
        stage = ctrl.stage if ctrl is not None else 0
        if ac.enabled and stage >= 3 \
                and job.priority < ac.shed_priority_below:
            shed["brownout-shed"] = shed.get("brownout-shed", 0) + 1
            return False
        rl = limits.job_submission
        if getattr(rl, "enforce", False) and not rl.try_spend(job.user):
            shed["rate-limited"] = shed.get("rate-limited", 0) + 1
            return False
        return True

    def tick(now_ms: int) -> None:
        now_box[0] = now_ms / 1000.0
        if now_ms >= next_sweep[0]:
            sim.scheduler.monitor.sweep()
            if ctrl is not None:
                min_level[0] = min(min_level[0], ctrl.level)
            next_sweep[0] = now_ms + sweep_interval_ms

    sim.admit = admit
    sim.on_tick = tick
    try:
        res = sim.run(max_virtual_ms=max_virtual_ms)
    finally:
        # the controller flips process-global planes (request-capture
        # ring, audit advisory shed); a run that ENDS mid-brownout must
        # not leak the shed into the caller's process
        from ..rest.instrument import request_log
        request_log.capture = True
        sim.store.audit.shed_advisory = False

    admitted = res.total - len(sim.shed_job_uuids)
    # zero committed-write loss: every admitted job is in the store and
    # reached a terminal state; sheds were refused up front, never
    # accepted-then-dropped
    lost = [j.uuid for j in trace
            if j.uuid not in set(sim.shed_job_uuids)
            and sim.store.job(j.uuid) is None]
    transitions = list(ctrl.transitions) if ctrl is not None else []
    first_engaged: Dict[int, int] = {}
    for t in transitions:
        for k in range(1, int(t["to"]) + 1):
            first_engaged.setdefault(k, t["ts_ms"])
    engaged = sorted(first_engaged)
    # shed order: observability (1) never engages AFTER stale reads (2),
    # which never engages after the write shed (3) — the ladder is
    # monotone even across multi-threshold jumps
    order_ok = all(
        first_engaged[a] <= first_engaged[b]
        for a, b in zip(engaged, engaged[1:]))
    wt = np.asarray(res.wait_times_ms or [0])
    summary = {
        "offered": res.total,
        "offered_multiple": offered_multiple,
        "admitted": admitted,
        "shed": dict(sorted(shed.items())),
        "shed_total": len(sim.shed_job_uuids),
        "completed": res.completed,
        "completion_rate_of_admitted": (res.completed / admitted
                                        if admitted else 1.0),
        "committed_writes_lost": len(lost),
        "wait_p50_s": float(np.percentile(wt, 50)) / 1000.0,
        "wait_p99_s": float(np.percentile(wt, 99)) / 1000.0,
        "makespan_virtual_s": res.makespan_ms / 1000.0,
        "admission": {
            "enabled": bool(admission),
            "min_level": round(min_level[0], 4),
            "final_level": round(ctrl.level, 4) if ctrl else None,
            "max_stage": max((int(t["to"]) for t in transitions),
                             default=0),
            "final_stage": ctrl.stage if ctrl else 0,
            "transitions": len(transitions),
            "stage_order_ok": order_ok,
            "stages_engaged": engaged,
        },
    }
    summary["ok"] = (not lost
                     and order_ok
                     and (not admission or summary["admission"]
                          ["max_stage"] >= 1 or admitted == res.total)
                     and summary["completion_rate_of_admitted"] > 0.95)
    return summary
