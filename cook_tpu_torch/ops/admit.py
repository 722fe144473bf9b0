"""Kernel K4: the elementwise stages of the cycle between its scans and
sorts, replacing those steps inside
``cook_tpu/ops/pallas_cycle.py::_kernel``:

* rank_body's over-quota limit and DRU (``cook_tpu/ops/dru.py:85-103``);
* considerable_body's admission tests in rank order
  (``cook_tpu/ops/considerable.py:86-111``), with per_user_prefix's
  gathers and scatters (``:47-62``);
* ``_compact_admitted`` and ``_compact_outputs``
  (``cook_tpu/parallel/sharded.py:292,355``).

Every stage sits between two K2 scans, so on the card it runs inside
the K2 launch beside it, as that scan's prologue (a gather, a mask) or
epilogue (the admission test, a scatter): ``csrc/admit.cuh``, launched
by the ``k24_*`` entries of ``csrc/scan.cu``.  The wrappers below are
those fused launches; each one's plain version is the composition of
the scan's plain version and the stage's (``_rank_over_plain`` after
``_seg_scan_plain``, and so on).  Only the compact outputs
(``csrc/admit.cu``, ``k4_compact_slots``) launch on their own.

Every tensor is batched [S, T(, 4)] over the pools.  Boolean results are
u8 0/1.  The plain versions repeat the JAX arithmetic exactly (masks as
float multiplies by 1 and 0, comparisons in f32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib, scan
from .delta import FLAG_ENQUEUE_OK, FLAG_LAUNCH_OK, FLAG_PENDING, FLAG_VALID

KERNEL = "admit"

# bits of the rank-order byte (the queue stage's bits_r)
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
    """over = any(cum_all > quota) & valid."""
    return _u8(torch.any(cum > quota, dim=-1) & _bit(flags, FLAG_VALID))


def _rank_keep_plain(usage, flags, over_cnt, max_over):
    """keep = valid & over_cnt <= max_over; xk = usage * valid * keep."""
    valid = _bit(flags, FLAG_VALID)
    keep = valid & (over_cnt <= max_over)
    xk = (usage * valid.to(_F32)[..., None]) * keep.to(_F32)[..., None]
    return _u8(keep), xk


def _rank_dru_plain(cum, shares, keep, flags, gpu_mode):
    """dru (NaN-propagating max of the cpu and mem shares, or the gpu
    share) and rankable = keep & pending."""
    if gpu_mode:
        dru = cum[..., 2] / shares[..., 2]
    else:
        dru = torch.maximum(cum[..., 1] / shares[..., 1],
                            cum[..., 0] / shares[..., 0])
    return dru, _u8((keep != 0) & _bit(flags, FLAG_PENDING))


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
    """Permute the admission inputs into rank order; the running base is
    each row's segment total ``cum_run[seg_last]``."""
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


def _queue_plain(cum_pool, pool_base, pool_quota, group_base, group_quota,
                 bits_r):
    """queue_ok: rankable, within the pool and quota-group caps, and not
    host-stifled."""
    pq = torch.all(cum_pool + pool_base[:, None, :] <= pool_quota[:, None, :],
                   dim=-1)
    gq = torch.all(cum_pool + group_base[:, None, :]
                   <= group_quota[:, None, :], dim=-1)
    return _u8(_bit(bits_r, R_RANKABLE) & pq & gq & _bit(bits_r, R_ENQUEUE))


def _user_gather_plain(perm, usage_r, queue_ok, user_r):
    """User-major values ``usage_r * queue_ok`` and segment starts."""
    p = perm.long()
    vals = torch.gather(usage_r, 1, p[..., None].expand(-1, -1, 4)) \
        * torch.gather(queue_ok, 1, p).to(_F32)[..., None]
    u = torch.gather(user_r, 1, p)
    first = torch.ones_like(u, dtype=torch.bool)
    first[:, 1:] = u[:, 1:] != u[:, :-1]
    return vals, _u8(first)


def _user_quota_plain(perm, cum_s, run_base_r, quota_r, queue_ok):
    """quota_ok = queue_ok & cum_user + run_base <= quota, in rank order
    and in user-major order."""
    p = perm.long()
    idx4 = p[..., None].expand(-1, -1, 4)
    q_s = (torch.gather(queue_ok, 1, p) != 0) & torch.all(
        cum_s + torch.gather(run_base_r, 1, idx4)
        <= torch.gather(quota_r, 1, idx4), dim=-1)
    q = torch.zeros_like(queue_ok)
    q.scatter_(1, p, _u8(q_s))
    return q, _u8(q_s)


def _accept_plain(perm, cnt_s, tokens_r, quota_ok, bits_r):
    """accepted = quota_ok & count <= floor(tokens) & launch_ok."""
    p = perm.long()
    ok_s = (torch.gather(quota_ok, 1, p) != 0) \
        & (cnt_s.to(_F32) <= torch.floor(torch.gather(tokens_r, 1, p))) \
        & _bit(torch.gather(bits_r, 1, p), R_LAUNCH)
    out = torch.zeros_like(quota_ok)
    out.scatter_(1, p, _u8(ok_s))
    return out


def _match_valid_plain(accepted, adm, num_considerable):
    """The head-of-queue cap on the admitted prefix."""
    return _u8((accepted != 0) & (adm <= num_considerable[:, None]))


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
    """The admitted rows compacted into C slots (rank order kept), the
    queue as a rank-ordered row list, and each slot's match inputs.
    ``kk``/``qp`` are the inclusive prefix counts of ``mv``/``queue_ok``."""
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


# ------------------------------------ the fused K2 launches (K4 inside)
def _rows16(**tensors):
    """The kernels move f32 [.., 4] rows as 16-byte vectors."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be 16-byte aligned")


def _rank_over_fused(usage, start, flags, quota):
    cum_all = scan._seg_scan_plain(usage, start, flags, FLAG_VALID, 0)
    return _rank_over_plain(cum_all, quota, flags)


@cuda_lib.stage(scan.KERNEL, _rank_over_fused, (_F32, _U8, _U8, _F32))
def rank_over(usage, start, flags, quota):
    """over (u8 [S, T]) from cum_all = seg_scan(usage * valid, start),
    in one K2 launch; cum_all is not stored."""
    S, n, _ = usage.shape
    cuda_lib.check(quota, _F32, (S, n, 4), "quota")
    _rows16(usage=usage, quota=quota)
    over = _empty((S, n), _U8, usage)
    scan.k2_launch("k24_rank_over", S, n, 4, "seg", usage.device,
                   usage.data_ptr(), start.data_ptr(), flags.data_ptr(),
                   quota.data_ptr(), over.data_ptr())
    return over


def _rank_keep_fused(over, start, usage, flags, max_over):
    return _rank_keep_plain(usage, flags, scan._seg_count_plain(over, 1, start),
                            max_over)


@cuda_lib.stage(scan.KERNEL, _rank_keep_fused, (_U8, _U8, _F32, _U8))
def rank_keep(over, start, usage, flags, max_over):
    """(keep, xk) from over_cnt = seg_count(over, start), in one K2
    launch."""
    S, n = over.shape
    cuda_lib.check(usage, _F32, (S, n, 4), "usage")
    _rows16(usage=usage)
    keep = _empty((S, n), _U8, over)
    xk = torch.empty_like(usage)
    scan.k2_launch("k24_rank_keep", S, n, 1, "seg", over.device,
                   over.data_ptr(), start.data_ptr(), usage.data_ptr(),
                   flags.data_ptr(), int(max_over), keep.data_ptr(),
                   xk.data_ptr())
    return keep, xk


def _rank_dru_fused(xk, start, shares, keep, flags, gpu_mode):
    return _rank_dru_plain(scan._seg_scan_plain(xk, start), shares, keep,
                           flags, gpu_mode)


@cuda_lib.stage(scan.KERNEL, _rank_dru_fused, (_F32, _U8, _F32, _U8, _U8))
def rank_dru(xk, start, shares, keep, flags, gpu_mode):
    """(dru, rankable) from cum = seg_scan(xk, start), in one K2
    launch."""
    S, n, _ = xk.shape
    cuda_lib.check(shares, _F32, (S, n, 3), "shares")
    _rows16(xk=xk)
    dru = _empty((S, n), _F32, xk)
    rankable = _empty((S, n), _U8, xk)
    scan.k2_launch("k24_rank_dru", S, n, 4, "seg", xk.device, xk.data_ptr(),
                   start.data_ptr(), shares.data_ptr(), keep.data_ptr(),
                   flags.data_ptr(), int(bool(gpu_mode)), dru.data_ptr(),
                   rankable.data_ptr())
    return dru, rankable


class Queued(NamedTuple):
    """The admission inputs in rank order and queue_ok."""
    usage_r: torch.Tensor     # f32[S, T, 4]
    quota_r: torch.Tensor     # f32[S, T, 4]
    user_r: torch.Tensor      # i32[S, T]
    run_base_r: torch.Tensor  # f32[S, T, 4]
    tokens_r: torch.Tensor    # f32[S, T]
    bits_r: torch.Tensor      # u8[S, T] R_* bits
    queue_ok: torch.Tensor    # u8[S, T]


def _queue_fused(order, usage, quota, user_rank, cum_run, seg_last, tokens,
                 flags, rankable, pool_base, pool_quota, group_base,
                 group_quota):
    r = _gather_plain(order, usage, quota, user_rank, cum_run, seg_last,
                      tokens, flags, rankable)
    cum_pool = scan._prefix16_plain(r.pend_usage)
    return Queued(*r[:6], _queue_plain(cum_pool, pool_base, pool_quota,
                                       group_base, group_quota, r.bits_r))


@cuda_lib.stage(scan.KERNEL, _queue_fused,
                (_I32, _F32, _F32, _I32, _F32, _I32, _F32, _U8, _U8)
                + (_F32,) * 4)
def queue(order, usage, quota, user_rank, cum_run, seg_last, tokens, flags,
          rankable, pool_base, pool_quota, group_base, group_quota):
    """The rank-order gather as the prologue of cum_pool = prefix16(
    pend_usage), queue_ok as its epilogue: one K2 launch; pend_usage and
    cum_pool are not stored."""
    S, n, _ = usage.shape
    out = Queued(_empty((S, n, 4), _F32, usage),
                 _empty((S, n, 4), _F32, usage),
                 _empty((S, n), _I32, usage),
                 _empty((S, n, 4), _F32, usage),
                 _empty((S, n), _F32, usage),
                 _empty((S, n), _U8, usage),
                 _empty((S, n), _U8, usage))
    for name, t in (("pool_base", pool_base), ("pool_quota", pool_quota),
                    ("group_base", group_base),
                    ("group_quota", group_quota)):
        cuda_lib.check(t, _F32, (S, 4), name)
    _rows16(usage=usage, quota=quota, cum_run=cum_run)
    scan.k2_launch("k24_queue", S, n, 4, "blocked", usage.device,
                   order.data_ptr(), usage.data_ptr(), quota.data_ptr(),
                   user_rank.data_ptr(), cum_run.data_ptr(),
                   seg_last.data_ptr(), tokens.data_ptr(), flags.data_ptr(),
                   rankable.data_ptr(), pool_base.data_ptr(),
                   pool_quota.data_ptr(), group_base.data_ptr(),
                   group_quota.data_ptr(), *(t.data_ptr() for t in out))
    return out


def _user_quota_fused(perm, usage_r, queue_ok, user_r, run_base_r, quota_r):
    vals, ufirst = _user_gather_plain(perm, usage_r, queue_ok, user_r)
    cum_s = scan._seg_scan_plain(vals, ufirst)
    q, q_s = _user_quota_plain(perm, cum_s, run_base_r, quota_r, queue_ok)
    return ufirst, q, q_s


@cuda_lib.stage(scan.KERNEL, _user_quota_fused,
                (_I32, _F32, _U8, _I32, _F32, _F32))
def user_quota(perm, usage_r, queue_ok, user_r, run_base_r, quota_r):
    """(ufirst, quota_ok, quota_ok_s): the user-major gather as the
    prologue of cum_s = seg_scan(vals, ufirst), the user quota test and
    its scatter by ``perm`` as its epilogue; one K2 launch."""
    S, n = perm.shape
    _rows16(usage_r=usage_r, run_base_r=run_base_r, quota_r=quota_r)
    ufirst = _empty((S, n), _U8, perm)
    q = _empty((S, n), _U8, perm)
    q_s = _empty((S, n), _U8, perm)
    scan.k2_launch("k24_user_quota", S, n, 4, "seg", perm.device,
                   perm.data_ptr(), usage_r.data_ptr(), queue_ok.data_ptr(),
                   user_r.data_ptr(), run_base_r.data_ptr(),
                   quota_r.data_ptr(), ufirst.data_ptr(), q.data_ptr(),
                   q_s.data_ptr())
    return ufirst, q, q_s


def _accept_fused(quota_ok_s, ufirst, perm, tokens_r, quota_ok, bits_r):
    cnt_s = scan._seg_count_plain(quota_ok_s, 1, ufirst)
    return _accept_plain(perm, cnt_s, tokens_r, quota_ok, bits_r)


@cuda_lib.stage(scan.KERNEL, _accept_fused, (_U8, _U8, _I32, _F32, _U8, _U8))
def accept(quota_ok_s, ufirst, perm, tokens_r, quota_ok, bits_r):
    """accepted from cnt_s = seg_count(quota_ok_s, ufirst), scattered by
    ``perm``; one K2 launch."""
    S, n = perm.shape
    out = _empty((S, n), _U8, perm)
    scan.k2_launch("k24_accept", S, n, 1, "seg", perm.device,
                   quota_ok_s.data_ptr(), ufirst.data_ptr(), perm.data_ptr(),
                   tokens_r.data_ptr(), quota_ok.data_ptr(), bits_r.data_ptr(),
                   out.data_ptr())
    return out


def _match_valid_fused(accepted, num_considerable):
    adm = scan._int_scan_plain(accepted, bit=1)
    return _match_valid_plain(accepted, adm, num_considerable)


@cuda_lib.stage(scan.KERNEL, _match_valid_fused, (_U8, _I32))
def match_valid(accepted, num_considerable):
    """mv from adm = int_scan(accepted); one K2 launch (adm is not
    stored)."""
    S, n = accepted.shape
    cuda_lib.check(num_considerable, _I32, (S,), "num_considerable")
    out = _empty((S, n), _U8, accepted)
    scan.k2_launch("k24_match_valid", S, n, 1, "int", accepted.device,
                   accepted.data_ptr(), num_considerable.data_ptr(),
                   out.data_ptr())
    return out


def _compact_fused(order, mv, queue_ok, job_res, exc_id, C):
    kk = scan._int_scan_plain(mv, bit=1)
    qp = scan._int_scan_plain(queue_ok, bit=1)
    return _compact_plain(order, mv, kk, queue_ok, qp, job_res, exc_id, C)


@cuda_lib.stage(KERNEL, _compact_fused, (_I32, _U8, _U8, _F32, _I32))
def compact(order, mv, queue_ok, job_res, exc_id, C):
    """The compaction: kk and qp (the prefix counts of ``mv`` and
    ``queue_ok``) as one two-column K2 launch whose epilogue scatters the
    admitted rows to their slots and the queue rows to their positions,
    then K4's one launch of its own for the compact outputs."""
    S, n = order.shape
    sel = _empty((S, C), _I32, order)
    kk = _empty((S, n), _I32, order)
    qp = _empty((S, n), _I32, order)
    out = Compacted(_empty((S, n), _I32, order), _empty((S,), _I32, order),
                    _empty((S, C), _I32, order), _empty((S, C), _I32, order),
                    _empty((S, C, 4), _F32, order),
                    _empty((S, C), _U8, order), _empty((S, C), _U8, order),
                    _empty((S, C), _I32, order))
    scan.k2_launch("k24_compact", S, n, 2, "int", order.device, mv.data_ptr(),
                   queue_ok.data_ptr(), order.data_ptr(), C, kk.data_ptr(),
                   qp.data_ptr(), sel.data_ptr(), out.queue_rows.data_ptr())
    cuda_lib.call("k4_compact_slots", KERNEL, sel.data_ptr(), kk.data_ptr(),
                  order.data_ptr(), qp.data_ptr(), job_res.data_ptr(),
                  exc_id.data_ptr(), *(t.data_ptr() for t in out), S, n, C)
    return out
