"""The port's split ranker against the JAX package on the CPU.

``rank_kernel``, ``rank_kernel_compact`` (through the K2/K3 stage
wrappers, here their plain versions), ``pool_quota_mask`` and
``user_quota_mask`` are held against ``cook_tpu.ops.dru``'s jitted
kernels on seeded worlds with NaN DRUs (zero-usage tasks of a
zero-share user), +inf DRUs, the over-quota limit, gpu mode and ragged
T.  Orders, masks and counts are equal, DRUs equal bit for bit
(tolerance 0); the pool mask also equals
``reference_impl.filter_pool_quota``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import dru as jdru
from cook_tpu.ops import reference_impl as jref
from cook_tpu_torch.ops import dru as tdru
from cook_tpu_torch.ops import reference_impl as tref
from cook_tpu_torch.ops import telemetry

F32 = np.float32


def _same_f32(a, b):
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(a.view(np.uint32)[~np.isnan(a)],
                                  b.view(np.uint32)[~np.isnan(b)])


def _compact_world(seed, T, U=12, N=None):
    """(rows, flags, res_base, shares_u, quota_u): user-contiguous rows
    into a base table, a zero-share user with zero-usage tasks (NaN), a
    zero-share user with usage (+inf), padding after the live rows."""
    rng = np.random.default_rng(seed)
    live = T - T // 7
    N = N or 2 * T
    uid = np.sort(rng.integers(0, U, live))
    first = np.zeros(T, bool)
    first[0] = True
    first[1:live] = uid[1:] != uid[:-1]
    pend = np.zeros(T, bool)
    pend[:live] = rng.random(live) < 0.7
    valid = np.zeros(T, bool)
    valid[:live] = True
    rows = np.zeros(T, np.int32)
    rows[:live] = rng.choice(N, live, replace=False)
    res = np.stack([rng.random(N) * 3.7 + 0.1, rng.random(N) * 900 + 17.3,
                    (rng.random(N) < 0.2) * 1.0, np.ones(N)], -1).astype(F32)
    ur = np.cumsum(first[:live]) - 1
    res[rows[:live][ur == 2], :3] = 0.0
    shares = (rng.random((U, 3)) * 50 + 10).astype(F32)
    shares[2] = 0.0
    shares[3] = 0.0
    quota = (rng.random((U, 4)) * [40, 9000, 4, 60] + [5, 1000, 1, 5]) \
        .astype(F32)
    flags = (pend * 1 + valid * 2 + first * 16).astype(np.uint8)
    return rows, flags, res, shares, quota


def _expanded(rows, flags, res, shares, quota):
    """RankInputs fields of the compact world, as the JAX package
    derives them."""
    is_first = (flags & 16) != 0
    user_rank = (np.cumsum(is_first) - 1).astype(np.int32)
    first_idx = np.maximum.accumulate(
        np.where(is_first, np.arange(len(flags)), 0)).astype(np.int32)
    ur = np.clip(user_rank, 0, shares.shape[0] - 1)
    return dict(usage=res[rows], quota=quota[ur], shares=shares[ur],
                first_idx=first_idx, user_rank=user_rank,
                pending=(flags & 1) != 0, valid=(flags & 2) != 0)


def _check_rank(got, want):
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    _same_f32(got.dru.numpy(), want.dru)
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    assert int(got.num_ranked) == int(want.num_ranked)


CASES = [(0, 384, False, 100), (1, 1_000, False, 2), (2, 257, True, 5),
         (3, 4_097, False, 1), (4, 64, True, 100)]


@pytest.mark.parametrize("seed,T,gpu_mode,max_over", CASES)
def test_rank_kernel_matches_jax(seed, T, gpu_mode, max_over):
    a = _expanded(*_compact_world(seed, T))
    want = jdru.rank_kernel(jdru.RankInputs(
        **{k: jnp.asarray(v) for k, v in a.items()}), gpu_mode=gpu_mode,
        max_over_quota_jobs=max_over)
    got = tdru.rank_kernel(tdru.RankInputs(
        **{k: torch.from_numpy(v) for k, v in a.items()}),
        gpu_mode=gpu_mode, max_over_quota_jobs=max_over, device="cpu")
    _check_rank(got, want)
    dru = np.asarray(want.dru)
    if not gpu_mode:
        assert np.isnan(dru).any() and np.isinf(dru).any()
    if max_over < 100:
        assert not np.asarray(want.keep)[a["valid"]].all()


@pytest.mark.parametrize("seed,T,gpu_mode,max_over", CASES)
def test_rank_kernel_compact_matches_jax(seed, T, gpu_mode, max_over):
    rows, flags, res, shares, quota = _compact_world(seed, T)
    want = jdru.rank_kernel_compact(jdru.CompactRankInputs(
        rows=jnp.asarray(rows), flags=jnp.asarray(flags),
        res_base=jnp.asarray(res), shares_u=jnp.asarray(shares),
        quota_u=jnp.asarray(quota)), gpu_mode=gpu_mode,
        max_over_quota_jobs=max_over)
    got = tdru.rank_kernel_compact(tdru.CompactRankInputs(
        *(torch.from_numpy(x) for x in (rows, flags, res, shares, quota))),
        gpu_mode=gpu_mode, max_over_quota_jobs=max_over, device="cpu")
    _check_rank(got, want)


def test_compact_clips_user_rank_and_pads_with_last_user():
    """More segments than table rows: the user rank is clipped to U - 1
    before the gathers; padding rows inherit the last segment."""
    rows, flags, res, shares, quota = _compact_world(9, 500, U=40)
    shares, quota = shares[:5], quota[:5]
    want = jdru.rank_kernel_compact(jdru.CompactRankInputs(
        *(jnp.asarray(x) for x in (rows, flags, res, shares, quota))))
    got = tdru.rank_kernel_compact(tdru.CompactRankInputs(
        *(torch.from_numpy(x) for x in (rows, flags, res, shares, quota))),
        device="cpu")
    _check_rank(got, want)


def test_rank_matches_rank_body_plain_version():
    a = _expanded(*_compact_world(5, 2_000))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    order, num, dru, keep, _ = tdru.rank_body(*t.values(), False, 3)
    got = tdru.rank_kernel(tdru.RankInputs(**t), max_over_quota_jobs=3,
                           device="cpu")
    assert torch.equal(got.order, order) and torch.equal(got.keep, keep)
    assert int(got.num_ranked) == int(num)
    _same_f32(got.dru.numpy(),
              torch.where(keep, dru, float("inf")).numpy())


def _queue(seed, J):
    rng = np.random.default_rng(seed)
    usage = np.stack([rng.random(J) * 3.7 + 0.1, rng.random(J) * 900 + 17.3,
                      (rng.random(J) < 0.3) * 1.0, np.ones(J)],
                     -1).astype(F32)
    valid = rng.random(J) < 0.9
    valid[J - J // 9:] = False
    return rng, usage, valid


@pytest.mark.parametrize("J", [1, 15, 16, 17, 100, 257, 4_096, 5_003])
def test_pool_quota_mask_matches_jax(J):
    rng, usage, valid = _queue(J, J)
    base = np.array([3.3, 170.1, 1.0, 4.0], F32)
    quota = (usage * valid[:, None]).sum(0) * 0.6 + base
    want = np.asarray(jdru.pool_quota_mask(
        jnp.asarray(usage), jnp.asarray(base), jnp.asarray(quota.astype(F32)),
        jnp.asarray(valid)))
    t = [torch.from_numpy(x) for x in (usage, base, quota.astype(F32),
                                       valid)]
    got = tdru.pool_quota_mask(*t, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdru.pool_quota_mask_plain(*t).numpy(),
                                  want)
    if J > 100:
        assert 0 < want.sum() < valid.sum()
    golden = valid & tref.filter_pool_quota(usage * valid[:, None], base,
                                            quota.astype(F32))
    np.testing.assert_array_equal(
        golden, valid & jref.filter_pool_quota(usage * valid[:, None], base,
                                               quota.astype(F32)))
    if J <= 16:      # a sequential sum is jnp.cumsum's order only here
        np.testing.assert_array_equal(got, golden)


@pytest.mark.parametrize("J,U", [(1, 1), (50, 3), (384, 12), (4_097, 40)])
def test_user_quota_mask_matches_jax(J, U):
    rng, usage, valid = _queue(100 + J, J)
    uid = np.sort(rng.integers(0, U, J))
    first = np.ones(J, bool)
    first[1:] = uid[1:] != uid[:-1]
    user_rank = (np.cumsum(first) - 1).astype(np.int32)
    first_idx = np.maximum.accumulate(
        np.where(first, np.arange(J), 0)).astype(np.int32)
    nu = int(user_rank.max()) + 1
    base = (rng.random((nu, 4)) * [5, 900, 1, 5]).astype(F32)
    quota = (rng.random((nu, 4)) * [40, 9000, 4, 60]).astype(F32)[user_rank]
    args = (usage, user_rank, first_idx, base, quota, valid)
    want = np.asarray(jdru.user_quota_mask(*(jnp.asarray(x) for x in args)))
    t = [torch.from_numpy(x) for x in args]
    got = tdru.user_quota_mask(*t, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdru.user_quota_mask_plain(*t).numpy(),
                                  want)
    if J > 50:
        assert 0 < want.sum() < valid.sum()


def test_split_rank_on_cpu_launches_nothing():
    rows, flags, res, shares, quota = _compact_world(6, 300)
    telemetry.reset_all()
    tdru.rank_kernel_compact(tdru.CompactRankInputs(
        *(torch.from_numpy(x) for x in (rows, flags, res, shares, quota))),
        device="cpu")
    assert telemetry.snapshot()["scan"] == 0
    assert telemetry.snapshot()["sort"] == 0


def test_rank_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rows, flags, res, shares, quota = _compact_world(7, 64)
    cinp = tdru.CompactRankInputs(
        *(torch.from_numpy(x) for x in (rows, flags, res, shares, quota)))
    a = {k: torch.from_numpy(v) for k, v in _expanded(
        rows, flags, res, shares, quota).items()}
    calls = [
        lambda: tdru.rank_kernel_compact(cinp),
        lambda: tdru.rank_kernel(tdru.RankInputs(**a)),
        lambda: tdru.pool_quota_mask(a["usage"], a["usage"][0], a["quota"][0],
                                     a["valid"]),
        lambda: tdru.user_quota_mask(a["usage"], a["user_rank"],
                                     a["first_idx"], a["quota"], a["quota"],
                                     a["valid"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
