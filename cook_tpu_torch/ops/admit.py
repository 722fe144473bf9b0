"""Kernel K4: the elementwise stages of the cycle between its scans and
sorts (``csrc/admit.cu``), replacing those steps inside
``cook_tpu/ops/pallas_cycle.py::_kernel``:

* rank_body's over-quota limit and DRU (``cook_tpu/ops/dru.py:85-103``);
* considerable_body's admission tests in rank order
  (``cook_tpu/ops/considerable.py:86-111``), with per_user_prefix's
  gathers and scatters (``:47-62``);
* ``_compact_admitted`` and ``_compact_outputs``
  (``cook_tpu/parallel/sharded.py:292,355``).

Every tensor is batched [S, T(, 4)] over the pools.  Boolean results are
u8 0/1.  The plain versions repeat the JAX arithmetic exactly (masks as
float multiplies by 1 and 0, comparisons in f32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .delta import FLAG_ENQUEUE_OK, FLAG_LAUNCH_OK, FLAG_PENDING, FLAG_VALID

KERNEL = "admit"

# bits of the rank-order byte from gather()
R_LAUNCH, R_ENQUEUE, R_RANKABLE = 1, 2, 4

_U8, _I32, _F32 = torch.uint8, torch.int32, torch.float32


def _bit(flags, b):
    return (flags & b) != 0


def _u8(x):
    return x.to(_U8)


def _empty(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


# ------------------------------------------------------------ rank_body
def _rank_over_plain(cum, quota, flags):
    return _u8(torch.any(cum > quota, dim=-1) & _bit(flags, FLAG_VALID))


@cuda_lib.stage(KERNEL, _rank_over_plain, (_F32, _F32, _U8))
def rank_over(cum, quota, flags):
    """over = any(cum_all > quota) & valid."""
    S, n, _ = cum.shape
    out = _empty((S, n), _U8, cum)
    cuda_lib.call("k4_rank_over", KERNEL, cum.data_ptr(), quota.data_ptr(),
                  flags.data_ptr(), out.data_ptr(), S, n)
    return out


def _rank_keep_plain(usage, flags, over_cnt, max_over):
    valid = _bit(flags, FLAG_VALID)
    keep = valid & (over_cnt <= max_over)
    xk = (usage * valid.to(_F32)[..., None]) * keep.to(_F32)[..., None]
    return _u8(keep), xk


@cuda_lib.stage(KERNEL, _rank_keep_plain, (_F32, _U8, _I32))
def rank_keep(usage, flags, over_cnt, max_over):
    """keep = valid & over_cnt <= max_over; xk = usage * valid * keep."""
    S, n, _ = usage.shape
    keep = _empty((S, n), _U8, usage)
    xk = torch.empty_like(usage)
    cuda_lib.call("k4_rank_keep", KERNEL, usage.data_ptr(), flags.data_ptr(),
                  over_cnt.data_ptr(), int(max_over), keep.data_ptr(),
                  xk.data_ptr(), S, n)
    return keep, xk


def _rank_dru_plain(cum, shares, keep, flags, gpu_mode):
    if gpu_mode:
        dru = cum[..., 2] / shares[..., 2]
    else:
        dru = torch.maximum(cum[..., 1] / shares[..., 1],
                            cum[..., 0] / shares[..., 0])
    return dru, _u8((keep != 0) & _bit(flags, FLAG_PENDING))


@cuda_lib.stage(KERNEL, _rank_dru_plain, (_F32, _F32, _U8, _U8))
def rank_dru(cum, shares, keep, flags, gpu_mode):
    """dru (NaN-propagating max of the cpu and mem shares, or the gpu
    share) and rankable = keep & pending."""
    S, n, _ = cum.shape
    dru = _empty((S, n), _F32, cum)
    rankable = _empty((S, n), _U8, cum)
    cuda_lib.call("k4_rank_dru", KERNEL, cum.data_ptr(), shares.data_ptr(),
                  keep.data_ptr(), flags.data_ptr(), int(bool(gpu_mode)),
                  dru.data_ptr(), rankable.data_ptr(), S, n)
    return dru, rankable


# ---------------------------------------------------- considerable_body
class RankOrder(NamedTuple):
    usage_r: torch.Tensor     # f32[S, T, 4]
    quota_r: torch.Tensor     # f32[S, T, 4]
    user_r: torch.Tensor      # i32[S, T]
    run_base_r: torch.Tensor  # f32[S, T, 4]
    tokens_r: torch.Tensor    # f32[S, T]
    bits_r: torch.Tensor      # u8[S, T] R_* bits
    pend_usage: torch.Tensor  # f32[S, T, 4] usage_r * rankable_r


def _gather_plain(order, usage, quota, user_rank, cum_run, seg_last, tokens,
                  flags, rankable):
    o = order.long()

    def g(x):
        if x.ndim == 3:
            return torch.gather(x, 1, o[..., None].expand(-1, -1, x.shape[2]))
        return torch.gather(x, 1, o)

    run_base = torch.gather(
        cum_run, 1, seg_last.long()[..., None].expand(-1, -1, 4))
    usage_r = g(usage)
    rk = g(rankable)
    f = g(flags)
    bits = (_u8(_bit(f, FLAG_LAUNCH_OK)) * R_LAUNCH
            + _u8(_bit(f, FLAG_ENQUEUE_OK)) * R_ENQUEUE
            + _u8(rk != 0) * R_RANKABLE)
    return RankOrder(usage_r, g(quota), g(user_rank), g(run_base),
                     g(tokens), bits, usage_r * (rk != 0).to(_F32)[..., None])


@cuda_lib.stage(KERNEL, _gather_plain,
                (_I32, _F32, _F32, _I32, _F32, _I32, _F32, _U8, _U8))
def gather(order, usage, quota, user_rank, cum_run, seg_last, tokens, flags,
           rankable):
    """Permute the admission inputs into rank order; the running base is
    each row's segment total ``cum_run[seg_last]``."""
    S, n, _ = usage.shape
    out = RankOrder(_empty((S, n, 4), _F32, usage),
                    _empty((S, n, 4), _F32, usage),
                    _empty((S, n), _I32, usage),
                    _empty((S, n, 4), _F32, usage),
                    _empty((S, n), _F32, usage),
                    _empty((S, n), _U8, usage),
                    _empty((S, n, 4), _F32, usage))
    cuda_lib.call("k4_gather", KERNEL, order.data_ptr(), usage.data_ptr(),
                  quota.data_ptr(), user_rank.data_ptr(), cum_run.data_ptr(),
                  seg_last.data_ptr(), tokens.data_ptr(), flags.data_ptr(),
                  rankable.data_ptr(), *(t.data_ptr() for t in out), S, n)
    return out


def _queue_plain(cum_pool, pool_base, pool_quota, group_base, group_quota,
                 bits_r):
    pq = torch.all(cum_pool + pool_base[:, None, :] <= pool_quota[:, None, :],
                   dim=-1)
    gq = torch.all(cum_pool + group_base[:, None, :]
                   <= group_quota[:, None, :], dim=-1)
    return _u8(_bit(bits_r, R_RANKABLE) & pq & gq & _bit(bits_r, R_ENQUEUE))


@cuda_lib.stage(KERNEL, _queue_plain, (_F32,) * 5 + (_U8,))
def queue(cum_pool, pool_base, pool_quota, group_base, group_quota, bits_r):
    """queue_ok: rankable, within the pool and quota-group caps, and not
    host-stifled."""
    S, n, _ = cum_pool.shape
    out = _empty((S, n), _U8, cum_pool)
    cuda_lib.call("k4_queue", KERNEL, cum_pool.data_ptr(),
                  pool_base.data_ptr(), pool_quota.data_ptr(),
                  group_base.data_ptr(), group_quota.data_ptr(),
                  bits_r.data_ptr(), out.data_ptr(), S, n)
    return out


def _user_gather_plain(perm, usage_r, queue_ok, user_r):
    p = perm.long()
    vals = torch.gather(usage_r, 1, p[..., None].expand(-1, -1, 4)) \
        * torch.gather(queue_ok, 1, p).to(_F32)[..., None]
    u = torch.gather(user_r, 1, p)
    first = torch.ones_like(u, dtype=torch.bool)
    first[:, 1:] = u[:, 1:] != u[:, :-1]
    return vals, _u8(first)


@cuda_lib.stage(KERNEL, _user_gather_plain, (_I32, _F32, _U8, _I32))
def user_gather(perm, usage_r, queue_ok, user_r):
    """User-major values ``usage_r * queue_ok`` and segment starts."""
    S, n, _ = usage_r.shape
    vals = torch.empty_like(usage_r)
    first = _empty((S, n), _U8, usage_r)
    cuda_lib.call("k4_user_gather", KERNEL, perm.data_ptr(),
                  usage_r.data_ptr(), queue_ok.data_ptr(), user_r.data_ptr(),
                  vals.data_ptr(), first.data_ptr(), S, n)
    return vals, first


def _user_quota_plain(perm, cum_s, run_base_r, quota_r, queue_ok):
    p = perm.long()
    idx4 = p[..., None].expand(-1, -1, 4)
    q_s = (torch.gather(queue_ok, 1, p) != 0) & torch.all(
        cum_s + torch.gather(run_base_r, 1, idx4)
        <= torch.gather(quota_r, 1, idx4), dim=-1)
    q = torch.zeros_like(queue_ok)
    q.scatter_(1, p, _u8(q_s))
    return q, _u8(q_s)


@cuda_lib.stage(KERNEL, _user_quota_plain, (_I32, _F32, _F32, _F32, _U8))
def user_quota(perm, cum_s, run_base_r, quota_r, queue_ok):
    """quota_ok = queue_ok & cum_user + run_base <= quota, in rank order
    and in user-major order."""
    S, n, _ = cum_s.shape
    q = _empty((S, n), _U8, cum_s)
    q_s = _empty((S, n), _U8, cum_s)
    cuda_lib.call("k4_user_quota", KERNEL, perm.data_ptr(), cum_s.data_ptr(),
                  run_base_r.data_ptr(), quota_r.data_ptr(),
                  queue_ok.data_ptr(), q.data_ptr(), q_s.data_ptr(), S, n)
    return q, q_s


def _accept_plain(perm, cnt_s, tokens_r, quota_ok, bits_r):
    p = perm.long()
    ok_s = (torch.gather(quota_ok, 1, p) != 0) \
        & (cnt_s.to(_F32) <= torch.floor(torch.gather(tokens_r, 1, p))) \
        & _bit(torch.gather(bits_r, 1, p), R_LAUNCH)
    out = torch.zeros_like(quota_ok)
    out.scatter_(1, p, _u8(ok_s))
    return out


@cuda_lib.stage(KERNEL, _accept_plain, (_I32, _I32, _F32, _U8, _U8))
def accept(perm, cnt_s, tokens_r, quota_ok, bits_r):
    """accepted = quota_ok & count <= floor(tokens) & launch_ok."""
    S, n = cnt_s.shape
    out = _empty((S, n), _U8, cnt_s)
    cuda_lib.call("k4_accept", KERNEL, perm.data_ptr(), cnt_s.data_ptr(),
                  tokens_r.data_ptr(), quota_ok.data_ptr(), bits_r.data_ptr(),
                  out.data_ptr(), S, n)
    return out


def _match_valid_plain(accepted, adm, num_considerable):
    return _u8((accepted != 0) & (adm <= num_considerable[:, None]))


@cuda_lib.stage(KERNEL, _match_valid_plain, (_U8, _I32, _I32))
def match_valid(accepted, adm, num_considerable):
    """The head-of-queue cap on the admitted prefix."""
    S, n = accepted.shape
    out = _empty((S, n), _U8, accepted)
    cuda_lib.call("k4_match_valid", KERNEL, accepted.data_ptr(),
                  adm.data_ptr(), num_considerable.data_ptr(),
                  out.data_ptr(), S, n)
    return out


# ----------------------------------------------------------- compaction
class Compacted(NamedTuple):
    queue_rows: torch.Tensor  # i32[S, T]
    n_queue: torch.Tensor     # i32[S]
    cand_row: torch.Tensor    # i32[S, C]
    cand_qpos: torch.Tensor   # i32[S, C]
    res_c: torch.Tensor       # f32[S, C, 4]
    valid_c: torch.Tensor     # u8[S, C]
    gpu_c: torch.Tensor       # u8[S, C]
    eid_c: torch.Tensor       # i32[S, C]


def _compact_plain(order, mv, kk, queue_ok, qp, job_res, exc_id, C):
    S, n = order.shape
    dev = order.device
    k = kk - 1
    slot = torch.where((mv != 0) & (k < C), k, C).long()
    sel = torch.full((S, C + 1), n, dtype=_I32, device=dev)
    iota = torch.arange(n, dtype=_I32, device=dev).expand(S, n)
    sel.scatter_(1, slot, iota)
    sel = sel[:, :C]
    qslot = torch.where(queue_ok != 0, qp - 1, n).long()
    queue_rows = torch.full((S, n + 1), n, dtype=_I32, device=dev)
    queue_rows.scatter_(1, qslot, order)
    v = sel < n
    cl = torch.clamp(sel, max=n - 1).long()
    ti = torch.gather(order, 1, cl)
    til = ti.long()
    neg = torch.full_like(ti, -1)
    rows = torch.gather(job_res, 1, til[..., None].expand(-1, -1, 4))
    return Compacted(
        queue_rows=queue_rows[:, :n], n_queue=qp[:, n - 1].contiguous(),
        cand_row=torch.where(v, ti, neg),
        cand_qpos=torch.where(v, torch.gather(qp, 1, cl) - 1, neg),
        res_c=rows * v.to(_F32)[..., None], valid_c=_u8(v),
        gpu_c=_u8(rows[..., 2] > 0), eid_c=torch.gather(exc_id, 1, til))


@cuda_lib.stage(KERNEL, _compact_plain,
                (_I32, _U8, _I32, _U8, _I32, _F32, _I32))
def compact(order, mv, kk, queue_ok, qp, job_res, exc_id, C):
    """The admitted rows compacted into C slots (rank order kept), the
    queue as a rank-ordered row list, and each slot's match inputs.
    ``kk``/``qp`` are the inclusive prefix counts of ``mv``/``queue_ok``."""
    S, n = order.shape
    sel = _empty((S, C), _I32, order)
    out = Compacted(_empty((S, n), _I32, order), _empty((S,), _I32, order),
                    _empty((S, C), _I32, order), _empty((S, C), _I32, order),
                    _empty((S, C, 4), _F32, order),
                    _empty((S, C), _U8, order), _empty((S, C), _U8, order),
                    _empty((S, C), _I32, order))
    cuda_lib.call("k4_compact", KERNEL, order.data_ptr(), mv.data_ptr(),
                  kk.data_ptr(), queue_ok.data_ptr(), qp.data_ptr(),
                  job_res.data_ptr(), exc_id.data_ptr(), sel.data_ptr(),
                  *(t.data_ptr() for t in out), S, n, C)
    return out
