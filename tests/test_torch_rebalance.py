"""The port's preemption-victim search against the JAX package on the CPU.

``preemption_kernel`` (its segmented sum through the K2 stage wrapper,
here the plain version) is held against
``cook_tpu.ops.rebalance.preemption_kernel`` and against
``reference_impl.preemption_decision`` on the randomized worlds of
``tests/test_rebalance.py`` and on NaN, tie, +inf and all-ineligible
worlds.  ``found``, ``spare_only``, ``host``, ``victim_mask`` and
``decision_dru`` are equal bit for bit (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import rebalance as jreb
from cook_tpu.ops import reference_impl as jref
from cook_tpu.ops.padding import bucket, pad_to
from cook_tpu_torch.ops import rebalance as treb
from cook_tpu_torch.ops import reference_impl as tref
from cook_tpu_torch.ops import telemetry

F32 = np.float32
FIELDS = ("found", "spare_only", "host", "victim_mask", "decision_dru")


def inputs(task_dru, task_res, task_host, eligible, spare, host_ok, demand):
    """Sorted by (host, -dru, index) and padded as the rebalancer builds
    them; returns (numpy fields, the sort order)."""
    task_dru = np.asarray(task_dru, F32)
    order = sorted(range(len(task_dru)),
                   key=lambda i: (task_host[i], -task_dru[i], i))
    task_dru = task_dru[order]
    task_res = np.asarray(task_res, F32).reshape(-1, 4)[order]
    task_host = np.asarray(task_host, np.int32)[order]
    eligible = np.asarray(eligible, bool)[order]
    host_start = np.ones(len(order), bool)
    host_start[1:] = task_host[1:] != task_host[:-1]
    T = bucket(len(order))
    return dict(
        task_dru=pad_to(task_dru, T), task_res=pad_to(task_res, T),
        task_host=pad_to(task_host, T),
        host_start=pad_to(host_start, T, fill=True),
        eligible=pad_to(eligible, T, fill=False),
        spare=np.asarray(spare, F32), host_ok=np.asarray(host_ok, bool),
        demand=np.asarray(demand, F32)), order


def both(f):
    want = jreb.preemption_kernel(jreb.RebalanceInputs(
        **{k: jnp.asarray(v) for k, v in f.items()}))
    got = treb.preemption_kernel(treb.RebalanceInputs(
        **{k: torch.from_numpy(v) for k, v in f.items()}), device="cpu")
    plain = treb.preemption_plain(treb.RebalanceInputs(
        **{k: torch.from_numpy(v) for k, v in f.items()}))
    for name in FIELDS:
        g = getattr(got, name).numpy()
        for w in (np.asarray(getattr(want, name)),
                  getattr(plain, name).numpy()):
            assert g.dtype == w.dtype, name
            if g.dtype == F32:
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
                np.testing.assert_array_equal(
                    g.view(np.uint32)[~np.isnan(g)],
                    w.view(np.uint32)[~np.isnan(w)])
            else:
                np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def decision(got, order, n):
    """The kernel's decision in the golden's form."""
    if not bool(got.found):
        return None
    if bool(got.spare_only):
        return int(got.host), [], float("inf")
    mask = got.victim_mask.numpy()[:n]
    return (int(got.host), sorted(order[p] for p in np.flatnonzero(mask)),
            float(got.decision_dru))


def golden(args, ref=tref):
    res = ref.preemption_decision(
        np.asarray(args[0], F32), np.asarray(args[1], F32).reshape(-1, 4),
        np.asarray(args[2]), np.asarray(args[3], bool),
        np.asarray(args[4], F32), np.asarray(args[5], bool),
        np.asarray(args[6], F32))
    if res is None:
        return None
    host, victims, dru = res
    return host, sorted(victims), dru


def random_world(seed):
    """``tests/test_rebalance.py``'s randomized world."""
    rng = np.random.default_rng(seed)
    T, H = int(rng.integers(1, 60)), int(rng.integers(1, 12))
    task_dru = rng.random(T).astype(F32) * 4
    task_res = np.stack([
        rng.integers(1, 8, T), rng.integers(64, 1024, T),
        np.zeros(T), np.zeros(T)], axis=1).astype(F32)
    task_host = rng.integers(0, H, T)
    eligible = rng.random(T) < 0.8
    spare = np.stack([
        rng.integers(0, 6, H), rng.integers(0, 512, H),
        np.zeros(H), np.zeros(H)], axis=1).astype(F32)
    host_ok = rng.random(H) < 0.9
    demand = np.array([rng.integers(2, 12), rng.integers(128, 2048), 0, 0],
                      dtype=F32)
    return (task_dru, task_res, task_host, eligible, spare, host_ok, demand)


@pytest.mark.parametrize("seed", range(16))
def test_randomized_worlds_match_jax_and_golden(seed):
    args = random_world(seed)
    f, order = inputs(*args)
    got = both(f)
    want = golden(args)
    assert want == golden(args, jref)
    k = decision(got, order, len(args[0]))
    if want is None:
        assert k is None
    else:
        assert k[0] == want[0] and k[1] == want[1]
        assert np.float32(k[2]) == np.float32(want[2])


def _hosts_world(dru, host, H=3, eligible=None, spare=None, demand=None):
    n = len(dru)
    res = np.tile(np.array([[2, 200, 0, 0]], F32), (n, 1))
    return (np.asarray(dru, F32), res, np.asarray(host),
            np.ones(n, bool) if eligible is None else np.asarray(eligible),
            np.zeros((H, 4), F32) if spare is None else spare,
            np.ones(H, bool), np.array([4, 400, 0, 0], F32)
            if demand is None else demand)


@pytest.mark.parametrize("name,args", [
    # a zero-share user's 0/0 DRU is NaN: NaN wins the argmax, and
    # NaN > -inf is False, so no task decision is found
    ("nan_only", _hosts_world([np.nan, np.nan, 1.0, 1.0], [0, 0, 1, 1])),
    ("nan_and_finite", _hosts_world([3.0, np.nan, 2.0, 5.0, 1.0, 1.0],
                                    [0, 0, 1, 1, 2, 2])),
    ("ties_lowest_host", _hosts_world([2.0, 2.0, 2.0, 2.0, 2.0, 2.0],
                                      [2, 2, 0, 0, 1, 1])),
    ("plus_inf", _hosts_world([np.inf, np.inf, 3.0, 3.0], [1, 1, 0, 0])),
    ("neg_zero", _hosts_world([-0.0, -0.0, 0.0, 0.0], [0, 0, 1, 1])),
    ("all_ineligible", _hosts_world([1.0, 2.0, 3.0], [0, 1, 2],
                                    eligible=[False] * 3)),
    ("spare_beats_tasks", _hosts_world(
        [9.0, 9.0], [0, 0], spare=np.array([[0, 0, 0, 0], [0, 0, 0, 0],
                                            [5, 500, 0, 0]], F32))),
])
def test_edge_worlds_match_jax(name, args):
    f, order = inputs(*args)
    got = both(f)
    if name == "nan_only":
        assert not bool(got.found)
    if name == "ties_lowest_host":
        assert int(got.host) == 0
    if name == "spare_beats_tasks":
        assert bool(got.spare_only) and int(got.host) == 2
    if name == "all_ineligible":
        assert not bool(got.found) and not got.victim_mask.any()
    if not np.isnan(args[0]).any():
        want = golden(args)
        assert decision(got, order, len(args[0])) == want


@pytest.mark.parametrize("x", [
    [1.0, np.nan, 3.0, np.nan], [2.0, 2.0, 1.0], [-np.inf, -np.inf],
    [np.inf, 1.0, np.inf], [-0.0, 0.0], [np.nan]])
def test_first_max_is_jnp_argmax(x):
    x = np.asarray(x, F32)
    assert int(treb.first_max(torch.from_numpy(x))) == int(jnp.argmax(x))
    b = x > 1.5
    assert int(treb.first_max(torch.from_numpy(b))) == int(jnp.argmax(b))


def test_preemption_on_cpu_launches_nothing_and_defaults_to_cuda():
    f, _ = inputs(*random_world(3))
    t = treb.RebalanceInputs(**{k: torch.from_numpy(v) for k, v in f.items()})
    telemetry.reset_all()
    treb.preemption_kernel(t, device="cpu")
    assert telemetry.snapshot()["scan"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            treb.preemption_kernel(t)
