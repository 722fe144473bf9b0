"""The port's copy of ``cook_tpu/sim/workload.py`` (numpy only).

Statistical workload generator for the simulator.

The port of the reference's system simulator concept (reference:
simulator/README.md:1-6 — generate statistical workloads against a
fully-stood-up scheduler and report wait times): instead of replaying a
recorded trace, synthesize one from per-user-class distributions — Poisson
arrivals per user, pluggable duration/resource/priority distributions —
then feed it to :class:`cook_tpu_torch.sim.Simulator` and read wait-time
percentiles off ``SimResult.summary()``.

Spec format (JSON-friendly):
  {"seed": 42, "horizon_ms": 3600000,
   "user_classes": [
     {"name": "batch", "users": 5, "arrival_rate_per_min": 6.0,
      "pool": "default",
      "duration_ms": {"dist": "lognormal", "mu": 10.0, "sigma": 1.0},
      "cpus":     {"dist": "choice", "values": [1, 2, 4],
                   "weights": [0.6, 0.3, 0.1]},
      "mem":      {"dist": "uniform", "low": 128, "high": 4096},
      "priority": {"dist": "constant", "value": 50}}]}

Distributions: constant(value), uniform(low, high), lognormal(mu, sigma),
exponential(scale), choice(values[, weights]).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def sample(spec, rng: np.random.Generator, size: int) -> np.ndarray:
    """Draw ``size`` samples from a distribution spec (scalars allowed)."""
    if isinstance(spec, (int, float)):
        return np.full(size, float(spec))
    dist = spec.get("dist", "constant")
    if dist == "constant":
        return np.full(size, float(spec["value"]))
    if dist == "uniform":
        return rng.uniform(float(spec["low"]), float(spec["high"]), size)
    if dist == "lognormal":
        return rng.lognormal(float(spec["mu"]), float(spec["sigma"]), size)
    if dist == "exponential":
        return rng.exponential(float(spec["scale"]), size)
    if dist == "choice":
        values = np.asarray(spec["values"], dtype=float)
        weights = spec.get("weights")
        p = None
        if weights is not None:
            p = np.asarray(weights, dtype=float)
            p = p / p.sum()
        return rng.choice(values, size=size, p=p)
    raise ValueError(f"unknown distribution {dist!r}")


def _poisson_arrivals(rate_per_ms: float, horizon_ms: int,
                      rng: np.random.Generator) -> np.ndarray:
    """Arrival times of a Poisson process on [0, horizon)."""
    if rate_per_ms <= 0:
        return np.empty(0)
    expected = rate_per_ms * horizon_ms
    # draw enough exponential gaps to cover the horizon w.h.p., then trim
    n = max(16, int(expected + 6 * np.sqrt(expected) + 16))
    gaps = rng.exponential(1.0 / rate_per_ms, n)
    times = np.cumsum(gaps)
    while times.size and times[-1] < horizon_ms:  # tail top-up, rare
        extra = rng.exponential(1.0 / rate_per_ms, n)
        times = np.concatenate([times, times[-1] + np.cumsum(extra)])
    return times[times < horizon_ms]


def generate_trace(spec: Dict, seed: Optional[int] = None) -> List[Dict]:
    """Synthesize simulator trace entries from a workload spec.

    Deterministic for a given (spec, seed); entries are sorted by
    submit_time and match the Simulator/load_trace schema.
    """
    rng = np.random.default_rng(
        seed if seed is not None else spec.get("seed", 0))
    horizon_ms = int(spec.get("horizon_ms", 3_600_000))
    entries: List[Dict] = []
    for cls in spec.get("user_classes", []):
        name = cls.get("name", "class")
        n_users = int(cls.get("users", 1))
        rate_per_ms = float(cls.get("arrival_rate_per_min", 1.0)) / 60_000.0
        for u in range(n_users):
            user = f"{name}{u:03d}"
            arrivals = _poisson_arrivals(rate_per_ms, horizon_ms, rng)
            k = arrivals.size
            if k == 0:
                continue
            durations = sample(cls.get("duration_ms", 60_000), rng, k)
            cpus = sample(cls.get("cpus", 1.0), rng, k)
            mem = sample(cls.get("mem", 128.0), rng, k)
            gpus = sample(cls.get("gpus", 0.0), rng, k)
            priority = sample(cls.get("priority", 50), rng, k)
            for i in range(k):
                entries.append({
                    "user": user,
                    "submit_time": int(arrivals[i]),
                    "duration": max(1, int(durations[i])),
                    "cpus": float(cpus[i]),
                    "mem": float(mem[i]),
                    "gpus": float(gpus[i]),
                    "priority": int(np.clip(priority[i], 0, 100)),
                    "pool": cls.get("pool", "default"),
                })
    entries.sort(key=lambda e: e["submit_time"])
    return entries


def generate_hosts(n: int, cpus: float = 16.0, mem: float = 65536.0,
                   gpus: float = 0.0, pool: str = "default") -> List[Dict]:
    """Uniform host fleet for quick experiments."""
    return [{"hostname": f"host{i:04d}", "cpus": cpus, "mem": mem,
             "gpus": gpus, "pool": pool} for i in range(n)]
