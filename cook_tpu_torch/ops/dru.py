"""DRU (Dominant Resource Usage) fair-share ranking
(``cook_tpu/ops/dru.py``).

Per user, tasks in the user's order: cum = segmented prefix sum of
(cpus, mem, gpus, count); dru = max(cum_mem / share_mem, cum_cpus /
share_cpus) (or cum_gpus / share_gpus in gpu mode).  Pending survivors
of the over-quota limit are sorted ascending by (dru, user_rank,
position).

:func:`rank_body` is the plain PyTorch version, which the fused cycle
uses on the CPU.  The split ranker (:func:`rank_kernel`,
:func:`rank_kernel_compact`) and the quota masks run the same math
through the stage wrappers of kernels K2 (``scan.seg_scan``,
``scan.seg_count``, ``scan.prefix16``) and K3 (``sort.sort_rank``): on
the card their kernels, on the CPU their plain versions.  The rest is
PyTorch code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from . import scan, sort
from .delta import FLAG_PENDING, FLAG_USER_FIRST, FLAG_VALID
from .padding import take
from .scan import lexsort, segmented_cumsum_by_first_idx

class RankInputs(NamedTuple):
    """One pool's rank inputs, user-contiguous (running tasks first
    within each user, then that user's pending jobs in priority
    order)."""

    usage: torch.Tensor       # f32[T, 4] per-task (cpus, mem, gpus, 1)
    quota: torch.Tensor       # f32[T, 4] the task's user's quota
    shares: torch.Tensor      # f32[T, 3] the user's DRU divisors
    first_idx: torch.Tensor   # i32[T] index of the user's first task
    user_rank: torch.Tensor   # i32[T] dense rank of the user, in [-1, T)
    pending: torch.Tensor     # bool[T]
    valid: torch.Tensor       # bool[T] False for padding


class RankResult(NamedTuple):
    order: torch.Tensor       # i32[T] task indices; ranked pending first
    dru: torch.Tensor         # f32[T] DRU (+inf for dropped / padding)
    keep: torch.Tensor        # bool[T] survived over-quota limiting
    num_ranked: torch.Tensor  # i32[] ranked pending tasks


class CompactRankInputs(NamedTuple):
    """The split rank path's compact wire: the sorted row permutation
    and one flags byte a task; resource columns come from the device
    base mirror, shares and quota from per-user tables."""

    rows: torch.Tensor        # i32[T] base row per sorted position
    flags: torch.Tensor       # u8[T] ops/delta FLAG_* bits
    res_base: torch.Tensor    # f32[N, 4] base mirror
    shares_u: torch.Tensor    # f32[U, 3] per-user DRU divisors
    quota_u: torch.Tensor     # f32[U, 4] per-user quota


def segment_cumsum(x: torch.Tensor, first_idx: torch.Tensor) -> torch.Tensor:
    """Per-segment inclusive prefix sum for contiguous segments, in
    ``lax.associative_scan``'s order (``first_idx[t]`` is the first
    element of t's segment)."""
    return segmented_cumsum_by_first_idx(x, first_idx)


def rank_body(usage, quota, shares, first_idx, user_rank, pending, valid,
              gpu_mode: bool, max_over_quota_jobs: int):
    """One pool: returns (order, num_ranked, dru, keep, rankable)."""
    usage = usage * valid[:, None]
    cum_all = segmented_cumsum_by_first_idx(usage, first_idx)
    over = torch.any(cum_all > quota, dim=-1) & valid
    over_cnt = segmented_cumsum_by_first_idx(over.to(torch.int32), first_idx)
    keep = valid & (over_cnt <= max_over_quota_jobs)
    cum = segmented_cumsum_by_first_idx(usage * keep[:, None], first_idx)
    if gpu_mode:
        dru = cum[:, 2] / shares[:, 2]
    else:
        # torch.maximum propagates NaN, as jnp.maximum does
        dru = torch.maximum(cum[:, 1] / shares[:, 1],
                            cum[:, 0] / shares[:, 0])
    rankable = keep & pending
    sort_dru = torch.where(rankable, dru, torch.full_like(dru, float("inf")))
    # stable: equal (dru, user_rank) keep position order
    order = lexsort((user_rank, sort_dru)).to(torch.int32)
    num_ranked = rankable.to(torch.int32).sum()
    return order, num_ranked, dru, keep, rankable


def _starts(first_idx: torch.Tensor) -> torch.Tensor:
    """u8[1, T] segment starts from first_idx."""
    t = torch.arange(first_idx.shape[0], dtype=first_idx.dtype,
                     device=first_idx.device)
    return (first_idx == t).to(torch.uint8)[None]


def rank_staged(usage, quota, shares, first_idx, user_rank, pending, valid,
                gpu_mode: bool, max_over_quota_jobs: int):
    """:func:`rank_body` through the stage wrappers: the segmented sums
    through K2 ``seg_scan``, the over-quota count through K2
    ``seg_count``, the sort through K3 ``sort_rank``.  Same outputs."""
    start = _starts(first_idx)
    usage = usage * valid[:, None]
    cum_all = scan.seg_scan_columns(usage, start)
    over = torch.any(cum_all > quota, dim=-1) & valid
    over_cnt = scan.seg_count(over.to(torch.uint8)[None], 1, start)[0]
    keep = valid & (over_cnt <= max_over_quota_jobs)
    cum = scan.seg_scan_columns(usage * keep[:, None], start)
    if gpu_mode:
        dru = cum[:, 2] / shares[:, 2]
    else:
        dru = torch.maximum(cum[:, 1] / shares[:, 1],
                            cum[:, 0] / shares[:, 0])
    rankable = keep & pending
    order = sort.sort_rank(dru[None].contiguous(),
                           rankable.to(torch.uint8)[None],
                           user_rank.to(torch.int32)[None].contiguous())[0]
    num_ranked = rankable.to(torch.int32).sum()
    return order, num_ranked, dru, keep, rankable


def _to(dev, *ts):
    return tuple(t.to(dev) for t in ts)


def rank_kernel(inp: RankInputs, *, gpu_mode: bool = False,
                max_over_quota_jobs: int = 100,
                device="cuda") -> RankResult:
    """Rank one pool's tasks by DRU (``cook_tpu/ops/dru.py:112``).
    ``user_rank`` must lie in [-1, T), the range K3's key holds."""
    dev = resolve_device(device)
    inp = RankInputs(*_to(dev, *inp))
    T = inp.usage.shape[0]
    if dev.type == "cuda" and bool(((inp.user_rank < -1)
                                    | (inp.user_rank >= T)).any()):
        raise ValueError(f"rank_kernel: user_rank outside [-1, {T})")
    order, num_ranked, dru, keep, _ = rank_staged(
        *inp, gpu_mode, max_over_quota_jobs)
    return RankResult(order=order, dru=torch.where(keep, dru, float("inf")),
                      keep=keep, num_ranked=num_ranked)


def expand_compact_rank(inp: CompactRankInputs) -> RankInputs:
    """The rank inputs of the compact wire: usage gathered from the base
    mirror, first_idx / user_rank from the USER_FIRST bits (padding rows
    inherit the last user segment), shares and quota from the per-user
    tables at the user rank clipped to [0, U - 1]."""
    usage = take(inp.res_base, inp.rows)
    flags = inp.flags
    pending = (flags & FLAG_PENDING) != 0
    valid = (flags & FLAG_VALID) != 0
    user_rank, first_idx = scan.user_segments_from_flags(
        (flags & FLAG_USER_FIRST) != 0)
    ur = torch.clamp(user_rank, 0, inp.shares_u.shape[0] - 1).long()
    return RankInputs(usage=usage, quota=inp.quota_u[ur],
                      shares=inp.shares_u[ur], first_idx=first_idx,
                      user_rank=user_rank, pending=pending, valid=valid)


def rank_kernel_compact(inp: CompactRankInputs, *, gpu_mode: bool = False,
                        max_over_quota_jobs: int = 100,
                        device="cuda") -> RankResult:
    """:func:`rank_kernel` over the compact wire
    (``cook_tpu/ops/dru.py:145``); decision-identical to it on the
    expanded arrays."""
    dev = resolve_device(device)
    r = expand_compact_rank(CompactRankInputs(*_to(dev, *inp)))
    order, num_ranked, dru, keep, _ = rank_staged(
        *r, gpu_mode, max_over_quota_jobs)
    return RankResult(order=order, dru=torch.where(keep, dru, float("inf")),
                      keep=keep, num_ranked=num_ranked)


def _pool_quota(job_usage, base_usage, quota, valid, prefix):
    cum = prefix((job_usage * valid[:, None])[None].contiguous())[0] \
        + base_usage[None, :]
    return valid & torch.all(cum <= quota[None, :], dim=-1)


def pool_quota_mask(job_usage, base_usage, quota, valid,
                    device="cuda") -> torch.Tensor:
    """Pool-level quota filter over the ranked pending queue
    (``cook_tpu/ops/dru.py:170``): a job is kept while the usage of all
    jobs ahead of it, kept or not, plus ``base_usage`` stays within
    ``quota``.  The cumulative sum is ``jnp.cumsum``'s blocked-16 order,
    K2 ``prefix16``."""
    return _pool_quota(*_to(resolve_device(device), job_usage, base_usage,
                            quota, valid), scan.prefix16)


def pool_quota_mask_plain(job_usage, base_usage, quota, valid):
    """The plain version, on the inputs' device."""
    return _pool_quota(job_usage, base_usage, quota, valid,
                       lambda x: scan.prefix_sum_xla_cpu(x, dim=1))


def _user_quota(job_usage, user_rank, first_idx, base_usage, quota, valid,
                seg_sum):
    cum = seg_sum(job_usage * valid[:, None], _starts(first_idx))
    total = cum + take(base_usage, user_rank)
    return valid & torch.all(total <= quota, dim=-1)


def user_quota_mask(job_usage, user_rank, first_idx, base_usage, quota,
                    valid, device="cuda") -> torch.Tensor:
    """Per-user quota filter over a user-contiguous job list
    (``cook_tpu/ops/dru.py:185``): ``base_usage`` f32[U, 4] running
    usage per user, gathered at ``user_rank``; ``quota`` f32[J, 4]."""
    return _user_quota(*_to(resolve_device(device), job_usage, user_rank,
                            first_idx, base_usage, quota, valid),
                       scan.seg_scan_columns)


def user_quota_mask_plain(job_usage, user_rank, first_idx, base_usage,
                          quota, valid):
    """The plain version, on the inputs' device."""
    return _user_quota(job_usage, user_rank, first_idx, base_usage, quota,
                       valid, lambda x, start: scan.segmented_cumsum(
                           x, start[0] != 0))
