"""cook_tpu_torch scan primitives against the JAX package on the CPU.

The port must reproduce the JAX package's float summation orders bit
for bit: ``lax.associative_scan``'s odd/even recursion
(``segmented_cumsum``), ``jnp.cumsum``'s blocked-16 order on XLA:CPU
(``prefix_sum_xla_cpu``) and the windows-of-32 order of an axis
``jnp.sum`` (``window32_sum``).  Inputs are non-dyadic floats, so an
order mistake changes bits.  Exact equality (tolerance 0) throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import scan as jscan
from cook_tpu_torch.ops import scan as tscan

F32 = np.float32


def _bits(a):
    return np.asarray(a, dtype=F32).view(np.uint32)


def _vals(rng, shape):
    return (rng.random(shape) * 7.3 + 0.01).astype(F32)


@pytest.mark.parametrize("T", [1, 2, 3, 7, 64, 100, 513, 5000])
def test_segmented_cumsum_matches_associative_scan(T):
    rng = np.random.default_rng(T)
    x = _vals(rng, (T, 4))
    f = rng.random(T) < 0.05
    f[0] = True
    want = jax.jit(jscan.segmented_cumsum)(jnp.asarray(x), jnp.asarray(f))
    got = tscan.segmented_cumsum(torch.from_numpy(x), torch.from_numpy(f))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_segmented_cumsum_by_first_idx_batched_dim():
    rng = np.random.default_rng(1)
    x = _vals(rng, (3, 300, 4))
    is_first = rng.random((3, 300)) < 0.1
    is_first[:, 0] = True
    _, first_idx = jscan.user_segments_from_flags(jnp.asarray(is_first), 1)
    want = jax.jit(jax.vmap(jscan.segmented_cumsum_by_first_idx))(
        jnp.asarray(x), first_idx)
    got = tscan.segmented_cumsum_by_first_idx(
        torch.from_numpy(x), torch.from_numpy(np.array(first_idx)), dim=1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("T", [5, 16, 17, 100, 256, 5000])
def test_prefix_sum_matches_jnp_cumsum(T):
    # T=5000: blocks of 16 -> 313 totals -> 20 -> 2, three recursion levels
    rng = np.random.default_rng(T)
    x = _vals(rng, (2, T, 4))
    want = jax.jit(jax.vmap(lambda a: jnp.cumsum(a, axis=0)))(jnp.asarray(x))
    got = tscan.prefix_sum_xla_cpu(torch.from_numpy(x), dim=1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("T", [8, 64, 512, 4096])
def test_window32_sum_matches_jnp_sum(T):
    rng = np.random.default_rng(T)
    x = _vals(rng, (3, T, 4))
    want = jax.jit(jax.vmap(lambda a: jnp.sum(a, axis=0)))(jnp.asarray(x))
    got = tscan.window32_sum(torch.from_numpy(x), dim=1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_user_segments_from_flags():
    rng = np.random.default_rng(2)
    is_first = rng.random((2, 200)) < 0.1
    is_first[1, 0] = False   # rows before the first start
    ur, fi = jscan.user_segments_from_flags(jnp.asarray(is_first), axis=1)
    tur, tfi = tscan.user_segments_from_flags(torch.from_numpy(is_first),
                                              dim=1)
    np.testing.assert_array_equal(tur.numpy(), np.asarray(ur))
    np.testing.assert_array_equal(tfi.numpy(), np.asarray(fi))


def test_lexsort_matches_jnp_lexsort_with_nan_zero_inf():
    rng = np.random.default_rng(3)
    key2 = rng.integers(0, 5, (3, 64))
    key1 = rng.random((3, 64)).astype(F32)
    key1[0, 3] = np.nan
    key1[0, 9] = -np.nan
    key1[1, 4] = np.inf
    key1[1, 5] = -np.inf
    key1[2, :6] = 0.0
    key1[2, 6] = -0.0
    want = np.stack([np.asarray(jnp.lexsort(
        (jnp.arange(64), jnp.asarray(key2[i]), jnp.asarray(key1[i]))))
        for i in range(3)])
    got = tscan.lexsort((torch.from_numpy(key2), torch.from_numpy(key1)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op,reverse", [("sum", False), ("sum", True),
                                        ("min", True)])
def test_int_scan_stage_plain(op, reverse):
    """K2's integer scan on CPU tensors takes its plain version."""
    rng = np.random.default_rng(4)
    x = rng.integers(-50, 50, (2, 300)).astype(np.int32)
    got = tscan.int_scan(torch.from_numpy(x), op=op, reverse=reverse,
                         offset=-1).numpy()
    v = x[:, ::-1] if reverse else x
    v = np.cumsum(v, 1) if op == "sum" else np.minimum.accumulate(v, 1)
    want = (v[:, ::-1] if reverse else v) - 1
    np.testing.assert_array_equal(got, want)


def test_seg_scan_stage_plain_masks_rows():
    """K2's segmented scan keeps rows whose flags hold ``mon`` and not
    ``moff`` (usage * (valid & ~pending))."""
    rng = np.random.default_rng(5)
    x = _vals(rng, (2, 128, 4))
    start = (rng.random((2, 128)) < 0.1).astype(np.uint8)
    start[:, 0] = 1
    flags = rng.integers(0, 32, (2, 128)).astype(np.uint8)
    keep = ((flags & 2) != 0) & ((flags & 1) == 0)
    want = jax.jit(jax.vmap(jscan.segmented_cumsum))(
        jnp.asarray(x * keep[..., None]), jnp.asarray(start != 0))
    got = tscan.seg_scan(torch.from_numpy(x), torch.from_numpy(start),
                         torch.from_numpy(flags), 2, 1)
    np.testing.assert_array_equal(_bits(got), _bits(want))
