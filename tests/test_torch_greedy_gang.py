"""The fused K5+K6 stage (``ops/match.greedy_gang``: the greedy
assignment with the gang reduction as its epilogue) on the CPU, through
its plain version, against the JAX package's ``greedy_assign`` on the
structured mask followed by ``_gang_reduce_candidates``; and where
``greedy_plan`` puts K6's counts.  Exact equality throughout.  The
kernel runs only on the card (``chip_smoke.py``, phases A, B and F).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import match as jmatch
from cook_tpu.ops.pallas_cycle import _gang_reduce_candidates
from cook_tpu_torch.ops import match as tmatch
from cook_tpu_torch.ops import telemetry

F32 = np.float32


def _world(seed, P=2, C=40, H=24, E=3, G=8, T=96, members=True):
    """K5's inputs in the cycle's layout and gang wires: 10% of the
    slots empty (cand_row -1), gangs whose gang_min some placements
    meet and some miss, topology rows with unknown (-1) hosts."""
    rng = np.random.default_rng(seed)
    res_c = np.stack([rng.random((P, C)) * 4.1 + 0.1,
                      rng.random((P, C)) * 600 + 3.3,
                      (rng.random((P, C)) < 0.3) * 1.0,
                      rng.random((P, C)) * 10], -1).astype(F32)
    valid = rng.random((P, C)) < 0.9
    res_c *= valid[..., None]
    gpu_c = res_c[..., 2] > 0
    eid = np.where(rng.random((P, C)) < 0.2, rng.integers(0, E, (P, C)), -1)
    host_gpu = rng.random((P, H)) < 0.3
    blocked = rng.random((P, H)) < 0.1
    exc = rng.random((P, E, H)) < 0.5
    cap = np.stack([np.full((P, H), 16.0), np.full((P, H), 4096.0),
                    host_gpu * 4.0, np.full((P, H), 100.0)], -1).astype(F32)
    avail = (cap * rng.choice([0.25, 0.5, 1.0], (P, H, 1))).astype(F32)
    cand_row = np.stack([rng.permutation(T)[:C] for _ in range(P)]) \
        .astype(np.int32)
    cand_row[rng.random((P, C)) < 0.1] = -1
    gang_id = np.full((P, T), -1, np.int32)
    if members:
        gang_id[rng.random((P, T)) < 0.6] = 0
        gang_id[gang_id == 0] = rng.integers(0, G, int((gang_id == 0).sum()))
    gang_size = rng.integers(1, 5, (P, G)).astype(np.int32)
    gang_size[:, -1:] = 2 ** 30           # a gang that can never complete
    gang_attr = rng.integers(0, 2, (P, G)).astype(np.int32)
    host_topo = np.stack([np.zeros((P, H)), rng.integers(0, 3, (P, H))], 1) \
        .astype(np.int32)
    host_topo[:, 1, rng.random(H) < 0.15] = -1
    k5 = (res_c, valid.astype(np.uint8), gpu_c.astype(np.uint8),
          eid.astype(np.int32), host_gpu.astype(np.uint8),
          blocked.astype(np.uint8), exc, avail, cap)
    return k5, (cand_row, gang_id, gang_size, gang_attr, host_topo)


def _jax(k5, gang):
    res_c, valid, gpu_c, eid, host_gpu, blocked, exc, avail, cap = k5
    cand_row, gang_id, gang_size, gang_attr, host_topo = gang
    outs = []
    for p in range(res_c.shape[0]):
        base = np.where(gpu_c[p][:, None] != 0, host_gpu[p][None] != 0,
                        host_gpu[p][None] == 0) & (blocked[p][None] == 0)
        mask = np.where((eid[p] >= 0)[:, None],
                        exc[p][np.maximum(eid[p], 0)], base) \
            & (valid[p][:, None] != 0)
        assign, _ = jax.jit(jmatch.greedy_assign)(
            jnp.asarray(res_c[p]), jnp.asarray(mask),
            jnp.asarray(valid[p] != 0), jnp.asarray(avail[p]),
            jnp.asarray(cap[p]))
        g, d = jax.jit(_gang_reduce_candidates)(
            jnp.asarray(cand_row[p]), assign, jnp.asarray(gang_id[p]),
            jnp.asarray(gang_size[p]), jnp.asarray(gang_attr[p]),
            jnp.asarray(host_topo[p]))
        outs.append((np.asarray(assign), np.asarray(g),
                     np.asarray(d).astype(np.int32)))
    return [np.stack(o) for o in zip(*outs)]


def _torch(k5, gang):
    return [t.numpy() for t in tmatch.greedy_gang(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in k5 + gang))]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fused_plain_equals_jax_greedy_then_gang_reduction(seed):
    k5, gang = _world(seed)
    want = _jax(k5, gang)
    got = _torch(k5, gang)
    for name, a, b in zip(("assign", "cand_gang", "cand_dropped"), got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assign, cand_gang, dropped = got
    # the worlds reach every verdict: kept members, dropped members
    assert (dropped == 1).any() and ((cand_gang >= 0) & (dropped == 0)).any()
    assert (gang[0] == -1).any()
    # the fused stage's first output is K5's, unchanged
    np.testing.assert_array_equal(
        assign, tmatch.greedy(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in k5)).numpy())


def test_fused_plain_one_gang_no_members():
    """G = 1 with no member: nothing dropped, cand_gang = assign."""
    k5, gang = _world(7, G=1, members=False)
    want = _jax(k5, gang)
    got = _torch(k5, gang)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got[2].any()
    np.testing.assert_array_equal(got[1], got[0])


def test_fused_stage_counts_nothing_on_the_cpu():
    k5, gang = _world(3)
    telemetry.reset_all()
    _torch(k5, gang)
    counts = telemetry.snapshot()
    assert counts["greedy"] == 0 and counts["gang"] == 0


@pytest.mark.parametrize("C,H", [(1024, 8192), (64, 50), (64, 300_000),
                                 (1024, 65_536), (256, 100_000)])
@pytest.mark.parametrize("G", [1, 8, 1024, 20_000])
def test_greedy_plan_places_gang_counts(C, H, G):
    """K6's counts (12 bytes a gang) go to the launch's dynamic shared
    memory where they fit, else to a scratch buffer of 3 P G ints; the
    rest of the plan is K5's own."""
    P = 4
    plan = tmatch.greedy_plan(P, C, H, G)
    alone = tmatch.greedy_plan(P, C, H)
    assert plan[:10] == alone[:10]
    assert alone.gangs == 0 and not alone.gang_in_smem \
        and alone.gang_scratch_ints == 0
    assert plan.gangs == G
    fits = 12 * G <= plan.smem_bytes
    assert plan.gang_in_smem == fits
    assert plan.gang_scratch_ints == (0 if fits else 3 * P * G)


def test_greedy_plan_gang_placement_by_g():
    # the design point: 12 KB of counts fit the 54 KB the chain leaves
    assert tmatch.greedy_plan(4, 1024, 8192, 1024).gang_in_smem
    # slices in device memory leave little shared memory: scratch
    plan = tmatch.greedy_plan(1, 64, 300_000, 1024)
    assert not plan.gang_in_smem and plan.gang_scratch_ints == 3 * 1024
    assert tmatch.greedy_plan(1, 64, 300_000, 8).gang_in_smem
    with pytest.raises(ValueError):
        tmatch.greedy_plan(1, 64, 50, -1)
