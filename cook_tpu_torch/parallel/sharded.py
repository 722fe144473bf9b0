"""The fused pool cycle (rank -> considerable -> match) over P pools on
one device, plain PyTorch: the single-device form of
``cook_tpu/parallel/sharded.py``'s ``make_pool_cycle(..., structured=True,
compact=True)``.  The all_gather of every pool's running usage becomes a
direct sum over the pools.

This is the plain version of the whole cycle; on the card
``ops/pallas_cycle.megacycle`` runs the same math as CUDA stage kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import dru as dru_ops
from ..ops import match as match_ops
from ..ops.considerable import considerable_body
from ..ops.delta import (FLAG_ENQUEUE_OK, FLAG_LAUNCH_OK, FLAG_PENDING,
                         FLAG_USER_FIRST, FLAG_VALID)
from ..ops.scan import (segmented_cumsum_by_first_idx,
                        user_segments_from_flags, window32_sum)


class CompactPoolCycleInputs(NamedTuple):
    """The compact wire, stacked on a leading pool axis."""

    rows: torch.Tensor        # i32[P, T] base row per sorted position
    flags: torch.Tensor       # u8[P, T] FLAG_* bits
    res_base: torch.Tensor    # f32[N, 4] (cpus, mem, gpus, 1)
    disk_base: torch.Tensor   # f32[N]
    tokens_u: torch.Tensor    # f32[P, U]
    shares_u: torch.Tensor    # f32[P, U, 3]
    quota_u: torch.Tensor     # f32[P, U, 4]
    num_considerable: torch.Tensor  # i32[P]
    pool_quota: torch.Tensor  # f32[P, 4]
    group_quota: torch.Tensor  # f32[P, 4]
    group_id: torch.Tensor    # i32[P]
    host_gpu: torch.Tensor    # bool[P, H]
    host_blocked: torch.Tensor  # bool[P, H]
    exc_rows: torch.Tensor    # i32[P, E] task positions, -1 pad
    exc_mask: torch.Tensor    # bool[P, E, H]
    avail: torch.Tensor       # f32[P, H, 4]
    capacity: torch.Tensor    # f32[P, H, 4]


class StructuredPoolCycleInputs(NamedTuple):
    usage: torch.Tensor
    quota: torch.Tensor
    shares: torch.Tensor
    first_idx: torch.Tensor
    user_rank: torch.Tensor
    pending: torch.Tensor
    valid: torch.Tensor
    enqueue_ok: torch.Tensor
    launch_ok: torch.Tensor
    tokens: torch.Tensor
    num_considerable: torch.Tensor
    pool_quota: torch.Tensor
    group_quota: torch.Tensor
    group_id: torch.Tensor
    job_res: torch.Tensor
    host_gpu: torch.Tensor
    host_blocked: torch.Tensor
    exc_id: torch.Tensor
    exc_mask: torch.Tensor
    avail: torch.Tensor
    capacity: torch.Tensor


class PoolCycleResult(NamedTuple):
    order: torch.Tensor        # i32[P, T]
    num_ranked: torch.Tensor   # i32[P]
    dru: torch.Tensor          # f32[P, T]
    queue_rows: torch.Tensor   # i32[P, T]
    n_queue: torch.Tensor      # i32[P]
    cand_row: torch.Tensor     # i32[P, C]
    cand_assign: torch.Tensor  # i32[P, C]
    cand_qpos: torch.Tensor    # i32[P, C]
    pool_base: torch.Tensor    # f32[P, 4]
    group_base: torch.Tensor   # f32[P, 4]


_DTYPES = {
    "rows": torch.int32, "flags": torch.uint8, "res_base": torch.float32,
    "disk_base": torch.float32, "tokens_u": torch.float32,
    "shares_u": torch.float32, "quota_u": torch.float32,
    "num_considerable": torch.int32, "pool_quota": torch.float32,
    "group_quota": torch.float32, "group_id": torch.int32,
    "host_gpu": torch.bool, "host_blocked": torch.bool,
    "exc_rows": torch.int32, "exc_mask": torch.bool,
    "avail": torch.float32, "capacity": torch.float32,
}


def compact_inputs_from_numpy(fields: dict, device="cuda"
                              ) -> CompactPoolCycleInputs:
    """The port's CompactPoolCycleInputs from numpy arrays holding the
    fields of the JAX package's CompactPoolCycleInputs."""
    dev = resolve_device(device)
    return CompactPoolCycleInputs(**{
        k: torch.as_tensor(np.asarray(fields[k])).to(dev, _DTYPES[k])
        for k in CompactPoolCycleInputs._fields})


def expand_compact(inp: CompactPoolCycleInputs) -> StructuredPoolCycleInputs:
    """Expansion of the compact wire (pool axis kept)."""
    P, T = inp.rows.shape
    rows = inp.rows.long()
    usage = inp.res_base[rows]                                 # [P, T, 4]
    disk = inp.disk_base[rows]                                 # [P, T]
    flags = inp.flags
    pending = (flags & FLAG_PENDING) != 0
    valid = (flags & FLAG_VALID) != 0
    enqueue_ok = (flags & FLAG_ENQUEUE_OK) != 0
    launch_ok = (flags & FLAG_LAUNCH_OK) != 0
    is_first = (flags & FLAG_USER_FIRST) != 0
    job_res = torch.cat([usage[..., :3], disk[..., None]], dim=-1) \
        * pending[..., None]
    user_rank, first_idx = user_segments_from_flags(is_first, dim=1)
    ur = torch.clamp(user_rank, 0, inp.tokens_u.shape[1] - 1).long()
    tokens = torch.gather(inp.tokens_u, 1, ur)
    pidx = torch.arange(P, device=rows.device)[:, None]
    shares = inp.shares_u[pidx, ur]
    quota = inp.quota_u[pidx, ur]
    E = inp.exc_rows.shape[1]
    slot = torch.where(inp.exc_rows >= 0, inp.exc_rows, T).long()
    exc_id = torch.full((P, T + 1), -1, dtype=torch.int32, device=rows.device)
    eids = torch.arange(E, dtype=torch.int32,
                        device=rows.device).expand(P, E)
    exc_id.scatter_(1, slot, eids)
    exc_id = exc_id[:, :T]
    return StructuredPoolCycleInputs(
        usage=usage, quota=quota, shares=shares, first_idx=first_idx,
        user_rank=user_rank, pending=pending, valid=valid,
        enqueue_ok=enqueue_ok, launch_ok=launch_ok, tokens=tokens,
        num_considerable=inp.num_considerable, pool_quota=inp.pool_quota,
        group_quota=inp.group_quota, group_id=inp.group_id,
        job_res=job_res, host_gpu=inp.host_gpu,
        host_blocked=inp.host_blocked, exc_id=exc_id,
        exc_mask=inp.exc_mask, avail=inp.avail, capacity=inp.capacity)


def _segment_totals(cum: torch.Tensor, first_idx: torch.Tensor):
    """Each contiguous segment's total (the inclusive prefix at its last
    row) broadcast to every row of the segment."""
    T = first_idx.shape[0]
    pos = torch.arange(T, dtype=torch.int32, device=cum.device)
    is_last = torch.cat([first_idx[1:] != first_idx[:-1],
                         torch.ones(1, dtype=torch.bool, device=cum.device)])
    marks = torch.where(is_last, pos, T - 1)
    seg_last = torch.flip(torch.cummin(torch.flip(marks, [0]), 0).values, [0])
    return cum[seg_last.long()]


def _user_running_base(usage, pending, valid, first_idx):
    """f32[T, 4]: each task's user's total RUNNING usage in the pool."""
    run_usage = usage * (valid & ~pending)[:, None]
    cum_run = segmented_cumsum_by_first_idx(run_usage, first_idx)
    return _segment_totals(cum_run, first_idx)


def _compact_admitted(order, match_valid, cap: int):
    """The admitted rows (rank order) compacted into a ``cap`` prefix:
    (sel rank positions, T for empty; task rows; valid)."""
    T = match_valid.shape[0]
    k = torch.cumsum(match_valid.to(torch.int32), 0, dtype=torch.int32) - 1
    slot = torch.where(match_valid & (k < cap), k, cap).long()
    sel = torch.full((cap + 1,), T, dtype=torch.int32, device=order.device)
    sel[slot] = torch.arange(T, dtype=torch.int32, device=order.device)
    sel = sel[:cap]
    valid = sel < T
    task_idx = order[torch.clamp(sel, max=T - 1).long()]
    return sel, task_idx, valid


def _rank_admit(usage, quota, shares, first_idx, user_rank, pending, valid,
                enqueue_ok, launch_ok, tokens, num_considerable,
                pool_quota, group_quota, pool_base, group_base,
                gpu_mode: bool, max_over_quota_jobs: int):
    order, num_ranked, dru, _keep, rankable = dru_ops.rank_body(
        usage, quota, shares, first_idx, user_rank, pending, valid,
        gpu_mode, max_over_quota_jobs)
    run_base = _user_running_base(usage, pending, valid, first_idx)
    o = order.long()
    cr = considerable_body(
        usage_r=usage[o], quota_r=quota[o], user_r=user_rank[o],
        run_base_r=run_base[o], tokens_r=tokens[o],
        launch_ok_r=launch_ok[o], enqueue_ok_r=enqueue_ok[o],
        rankable_r=rankable[o], pool_base=pool_base, pool_quota=pool_quota,
        group_base=group_base, group_quota=group_quota,
        num_considerable=num_considerable)
    return order, num_ranked, dru, cr


def _match_tail(order, cr, job_res, mask_of, avail, capacity, cap: int):
    """Compact -> compose masks -> greedy match."""
    sel, task_idx, valid_c = _compact_admitted(order, cr.match_valid, cap)
    ti = task_idx.long()
    res_c = job_res[ti] * valid_c[:, None]
    mask_c = mask_of(ti) & valid_c[:, None]
    assign_c, _avail = match_ops.greedy_assign(res_c, mask_c, valid_c,
                                               avail, capacity)
    return sel, task_idx, valid_c, assign_c


def _compact_outputs(order, queue_ok, sel, task_idx, valid_c, assign_c,
                     T: int):
    """Queue membership as a rank-ordered row list, plus per-slot (row,
    host, queue position)."""
    qpos = torch.cumsum(queue_ok.to(torch.int32), 0, dtype=torch.int32) - 1
    n_queue = queue_ok.to(torch.int32).sum()
    slot = torch.where(queue_ok, qpos, T).long()
    queue_rows = torch.full((T + 1,), T, dtype=torch.int32,
                            device=order.device)
    queue_rows[slot] = order
    queue_rows = queue_rows[:T]
    neg = torch.full_like(task_idx, -1)
    cand_row = torch.where(valid_c, task_idx, neg)
    cand_assign = torch.where(valid_c, assign_c, neg)
    cand_qpos = torch.where(valid_c, qpos[torch.clamp(sel, max=T - 1).long()],
                            neg)
    return queue_rows, n_queue, cand_row, cand_assign, cand_qpos


def _pool_cycle_structured(usage, quota, shares, first_idx, user_rank,
                           pending, valid, enqueue_ok, launch_ok, tokens,
                           num_considerable, pool_quota, group_quota,
                           pool_base, group_base, job_res, host_gpu,
                           host_blocked, exc_id, exc_mask, avail, capacity,
                           gpu_mode: bool, max_over_quota_jobs: int,
                           considerable_cap: Optional[int] = None):
    """One pool's fused cycle with the structured mask: per-row masks are
    composed only for the compacted rows."""
    T = pending.shape[0]
    order, num_ranked, dru, cr = _rank_admit(
        usage, quota, shares, first_idx, user_rank, pending, valid,
        enqueue_ok, launch_ok, tokens, num_considerable, pool_quota,
        group_quota, pool_base, group_base, gpu_mode, max_over_quota_jobs)
    cap = T if considerable_cap is None else min(considerable_cap, T)

    def mask_of(ti):
        gpu_rows = job_res[ti, 2] > 0
        base = torch.where(gpu_rows[:, None], host_gpu[None, :],
                           ~host_gpu[None, :]) & ~host_blocked[None, :]
        eid = exc_id[ti]
        rows = exc_mask[torch.clamp(eid, min=0).long()]
        return torch.where((eid >= 0)[:, None], rows, base)

    sel, task_idx, valid_c, assign_c = _match_tail(
        order, cr, job_res, mask_of, avail, capacity, cap)
    compact = _compact_outputs(order, cr.queue_ok, sel, task_idx, valid_c,
                               assign_c, T)
    return (order, num_ranked, dru) + compact


def pool_bases(usage, pending, valid, group_id):
    """Every pool's running usage and its quota group's total: f32[P, 4]
    each, summed in XLA:CPU's orders (windows of 32 over tasks; pools in
    order) so the port's caps see the reference's bits."""
    run = usage * (valid & ~pending)[..., None]
    pool_base = window32_sum(run, dim=1)[:, :4]
    same = (group_id[None, :] == group_id[:, None]) & (group_id[:, None] >= 0)
    group_base = torch.stack([
        window32_sum(pool_base * same[p][:, None], dim=0)
        for p in range(pool_base.shape[0])])
    return pool_base, group_base


def pool_cycle(inp: CompactPoolCycleInputs, *, considerable_cap: int,
               gpu_mode: bool = False, max_over_quota_jobs: int = 100,
               device="cuda") -> PoolCycleResult:
    """The fused cycle over P pools on one device (plain PyTorch)."""
    dev = resolve_device(device)
    inp = CompactPoolCycleInputs(*(t.to(dev) for t in inp))
    s = expand_compact(inp)
    pool_base, group_base = pool_bases(s.usage, s.pending, s.valid,
                                       s.group_id)
    outs = []
    for p in range(inp.rows.shape[0]):
        outs.append(_pool_cycle_structured(
            s.usage[p], s.quota[p], s.shares[p], s.first_idx[p],
            s.user_rank[p], s.pending[p], s.valid[p], s.enqueue_ok[p],
            s.launch_ok[p], s.tokens[p], s.num_considerable[p],
            s.pool_quota[p], s.group_quota[p], pool_base[p], group_base[p],
            s.job_res[p], s.host_gpu[p], s.host_blocked[p], s.exc_id[p],
            s.exc_mask[p], s.avail[p], s.capacity[p], gpu_mode,
            max_over_quota_jobs, considerable_cap))
    cols = [torch.stack(c) for c in zip(*outs)]
    return PoolCycleResult(*cols, pool_base, group_base)
