"""cook_tpu_torch rank and admission against the JAX package on the CPU:
``rank_body`` (DRU ranking with over-quota limiting; a zero-share user
gives NaN and inf DRUs) and ``considerable_body`` (finite pool, group
and user quotas and launch-rate tokens, so admission binds).  Decisions
and DRU bits must be identical (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import considerable as jcons
from cook_tpu.ops import dru as jdru
from cook_tpu.ops import reference_impl as jref
from cook_tpu_torch.ops import considerable as tcons
from cook_tpu_torch.ops import dru as tdru
from cook_tpu_torch.ops import host_prep as thp
from cook_tpu_torch.ops import reference_impl as tref

F32 = np.float32


def _rank_inputs(seed, T=384, U=12):
    rng = np.random.default_rng(seed)
    uid = np.sort(rng.integers(0, U, T))
    first = np.zeros(T, bool)
    first[0] = True
    first[1:] = uid[1:] != uid[:-1]
    user_rank = np.cumsum(first).astype(np.int32) - 1
    first_idx = np.maximum.accumulate(
        np.where(first, np.arange(T), 0)).astype(np.int32)
    usage = np.stack([rng.random(T) * 3.7 + 0.1, rng.random(T) * 900 + 17.3,
                      (rng.random(T) < 0.1) * 1.0, np.ones(T)], -1).astype(F32)
    z = user_rank == 2          # zero-usage tasks of a zero-share user
    usage[z, :2] = 0.0
    shares = (rng.random((U, 3)) * 50 + 10).astype(F32)[user_rank]
    shares[z] = 0.0
    shares[user_rank == 3] = 0.0  # positive usage over zero share: inf
    quota = (rng.random((U, 4)) * [40, 9000, 4, 60] + [5, 1000, 1, 5]) \
        .astype(F32)[user_rank]
    pending = rng.random(T) < 0.7
    valid = np.ones(T, bool)
    valid[-20:] = False
    return dict(usage=usage, quota=quota, shares=shares, first_idx=first_idx,
                user_rank=user_rank, pending=pending, valid=valid)


@pytest.mark.parametrize("seed,gpu_mode,max_over", [(0, False, 100),
                                                    (1, False, 3),
                                                    (2, True, 5)])
def test_rank_body_matches_jax(seed, gpu_mode, max_over):
    a = _rank_inputs(seed)
    fn = jax.jit(jdru.rank_body, static_argnums=(7, 8))
    want = fn(*(jnp.asarray(a[k]) for k in a), gpu_mode, max_over)
    got = tdru.rank_body(*(torch.from_numpy(a[k]) for k in a), gpu_mode,
                         max_over)
    order, num_ranked, dru, keep, rankable = want
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(order))
    assert int(got[1]) == int(num_ranked)
    np.testing.assert_array_equal(got[2].numpy().view(np.uint32)[
        ~np.isnan(got[2].numpy())], np.asarray(dru).view(np.uint32)[
        ~np.isnan(np.asarray(dru))])
    np.testing.assert_array_equal(np.isnan(got[2].numpy()),
                                  np.isnan(np.asarray(dru)))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(keep))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(rankable))
    if not gpu_mode:
        assert np.isnan(np.asarray(dru)[a["user_rank"] == 2]).any()
        assert np.isinf(np.asarray(dru)[a["user_rank"] == 3]).all()


def test_rank_body_matches_numpy_golden():
    """Packed by host_prep, ranked by rank_body: the reference's heap
    merge of per-user DRU streams gives the same order."""
    rng = np.random.default_rng(7)
    users, shares, quotas = [], {}, {}
    tid = 0
    for u in range(6):
        n = int(rng.integers(3, 20))
        usage = np.stack([rng.random(n) * 3.1 + 0.2,
                          rng.random(n) * 700 + 33.3, np.zeros(n),
                          np.ones(n)], -1).astype(F32)
        users.append(tref.UserTasks(f"u{u}", list(range(tid, tid + n)), usage,
                                    list(rng.random(n) < 0.6)))
        tid += n
        shares[f"u{u}"] = tuple(rng.random(3) * 40 + 5)
        quotas[f"u{u}"] = np.full(4, np.inf, F32)
    arrays, task_ids = thp.pack_rank_inputs(users, shares, quotas)
    got = tdru.rank_body(*(torch.from_numpy(arrays[k]) for k in (
        "usage", "quota", "shares", "first_idx", "user_rank", "pending",
        "valid")), False, 100)
    order = got[0].numpy()[:int(got[1])]
    want = jref.rank_by_dru(users, shares, quotas)
    assert [task_ids[i] for i in order] == [t for t, _ in want]
    assert tref.rank_by_dru(users, shares, quotas) == want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_considerable_body_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, U = 384, 10
    user = rng.integers(0, U, T).astype(np.int32)
    usage = np.stack([rng.random(T) * 3.7 + 0.1, rng.random(T) * 900 + 17.3,
                      (rng.random(T) < 0.1) * 1.0, np.ones(T)], -1).astype(F32)
    quota = (rng.random((U, 4)) * [60, 20000, 6, 60] + [5, 1000, 1, 5]) \
        .astype(F32)[user]
    run_base = (rng.random((U, 4)) * [8, 3000, 1, 5]).astype(F32)[user]
    tokens = np.floor(rng.random(U) * 9 + 1).astype(F32)[user]
    tokens[user == 0] = np.inf
    args = dict(
        usage_r=usage, quota_r=quota, user_r=user, run_base_r=run_base,
        tokens_r=tokens, launch_ok_r=rng.random(T) < 0.9,
        enqueue_ok_r=rng.random(T) < 0.95, rankable_r=rng.random(T) < 0.8,
        pool_base=np.array([20.3, 5000.7, 1, 30], F32),
        pool_quota=np.array([400, 90000, 20, 300], F32),
        group_base=np.array([30.1, 7000.3, 2, 40], F32),
        group_quota=np.array([420, 95000, 25, 320], F32),
        num_considerable=np.int32(40))
    want = jax.jit(jcons.considerable_body)(
        **{k: jnp.asarray(v) for k, v in args.items()})
    got = tcons.considerable_body(
        **{k: torch.as_tensor(v) for k, v in args.items()})
    for name in ("match_valid", "queue_ok", "accepted"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    # the caps bind: some rankable rows are queued, some are not
    q = np.asarray(want.queue_ok)
    assert 0 < q.sum() < args["rankable_r"].sum()
    assert 0 < np.asarray(want.accepted).sum() < q.sum()
