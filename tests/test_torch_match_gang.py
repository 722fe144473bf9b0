"""cook_tpu_torch greedy assignment and gang reduction against the JAX
package and the numpy goldens on the CPU: ``greedy_assign`` (ties broken
at the lowest host, rows where no host fits), the batched K5 stage with
the structured mask, and ``gang_reduce_body`` (count and topology
gates).  Exact equality throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import gang as jgang
from cook_tpu.ops import match as jmatch
from cook_tpu.ops import reference_impl as jref
from cook_tpu_torch.ops import gang as tgang
from cook_tpu_torch.ops import match as tmatch
from cook_tpu_torch.ops import reference_impl as tref

F32 = np.float32


def _match_case(seed, J=48, H=40):
    rng = np.random.default_rng(seed)
    job_res = np.stack([rng.random(J) * 5.3 + 0.1, rng.random(J) * 700 + 9.7,
                        (rng.random(J) < 0.2) * 1.0, rng.random(J) * 30],
                       -1).astype(F32)
    job_res[5] = [1e6, 1, 0, 0]           # fits nowhere
    cap = np.stack([rng.choice([8.0, 16.0], H), rng.choice([2048.0, 4096.0], H),
                    rng.choice([0.0, 4.0], H), np.full(H, 500.0)],
                   -1).astype(F32)
    avail = cap.copy()
    avail[::3] *= 0.5
    avail[::2] = avail[0]                 # identical hosts: fitness ties
    cap[::2] = cap[0]
    mask = rng.random((J, H)) < 0.7
    mask[7] = False                       # masked everywhere
    valid = np.ones(J, bool)
    valid[-4:] = False
    return job_res, mask, valid, avail, cap


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_assign_matches_jax_and_golden(seed):
    job_res, mask, valid, avail, cap = _match_case(seed)
    want, want_avail = jax.jit(jmatch.greedy_assign)(
        jnp.asarray(job_res), jnp.asarray(mask), jnp.asarray(valid),
        jnp.asarray(avail), jnp.asarray(cap))
    got, got_avail = tmatch.greedy_assign(
        torch.from_numpy(job_res), torch.from_numpy(mask),
        torch.from_numpy(valid), torch.from_numpy(avail),
        torch.from_numpy(cap))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_avail.numpy().view(np.uint32),
                                  np.asarray(want_avail).view(np.uint32))
    golden = tref.greedy_match(job_res, mask & valid[:, None], avail, cap)
    np.testing.assert_array_equal(got.numpy(), golden)
    np.testing.assert_array_equal(
        golden, jref.greedy_match(job_res, mask & valid[:, None], avail, cap))
    assert got[5] == -1 and got[7] == -1 and (got.numpy()[-4:] == -1).all()


def test_greedy_stage_composes_structured_mask():
    """K5's plain version (batched pools, mask from gpu isolation,
    blocked hosts and exception rows) equals per-pool greedy_assign on
    the dense mask the JAX cycle composes."""
    rng = np.random.default_rng(3)
    P, C, H, E = 2, 24, 32, 3
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
    got = tmatch.greedy(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        res_c, valid.astype(np.uint8), gpu_c.astype(np.uint8),
        eid.astype(np.int32), host_gpu.astype(np.uint8),
        blocked.astype(np.uint8), exc, avail, cap))).numpy()
    for p in range(P):
        base = np.where(gpu_c[p][:, None], host_gpu[p][None],
                        ~host_gpu[p][None]) & ~blocked[p][None]
        mask = np.where((eid[p] >= 0)[:, None], exc[p][np.maximum(eid[p], 0)],
                        base) & valid[p][:, None]
        want, _ = jax.jit(jmatch.greedy_assign)(
            jnp.asarray(res_c[p]), jnp.asarray(mask), jnp.asarray(valid[p]),
            jnp.asarray(avail[p]), jnp.asarray(cap[p]))
        np.testing.assert_array_equal(got[p], np.asarray(want))
    assert (got >= 0).any() and (got == -1).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gang_reduce_matches_golden_and_jax(seed):
    rng = np.random.default_rng(seed)
    J, G, H = 64, 8, 16
    assign = np.where(rng.random(J) < 0.8, rng.integers(0, H, J), -1) \
        .astype(np.int32)
    gang_id = np.where(rng.random(J) < 0.6, rng.integers(0, 6, J), -1) \
        .astype(np.int32)
    gang_size = np.array([2, 3, 4, 5, 2, 1, 2 ** 30, 2 ** 30], np.int32)
    gang_attr = np.array([0, 1, 1, 0, 1, 0, 0, 0], np.int32)
    host_topo = np.stack([np.zeros(H), rng.integers(0, 2, H)]) \
        .astype(np.int32)
    host_topo[1, 3] = -1                  # attribute missing on a host
    want_a, want_d = jref.gang_reduce(assign, gang_id, gang_size, gang_attr,
                                      host_topo)
    got_a, got_d = tgang.gang_reduce_body(*(torch.from_numpy(a) for a in (
        assign, gang_id, gang_size, gang_attr, host_topo)))
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    jax_a, jax_d = jax.jit(jgang.gang_reduce_body)(*(jnp.asarray(a) for a in (
        assign, gang_id, gang_size, gang_attr, host_topo)))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(jax_a))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(jax_d))
    np.testing.assert_array_equal(
        tref.gang_reduce(assign, gang_id, gang_size, gang_attr, host_topo)[0],
        want_a)
