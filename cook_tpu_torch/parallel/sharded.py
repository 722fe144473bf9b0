"""The fused pool cycle (rank -> considerable -> match) over P pools:
``cook_tpu/parallel/sharded.py``, in its three input forms: the compact
wire (the columnar pack's), the structured mask, and the dense bool[P,
T, H] constraint mask of :class:`PoolCycleInputs` (the entity pack's;
``_pool_cycle_one``, ``single_pool_cycle``).

On one device ``pool_cycle`` and ``dense_pool_cycle`` are the plain
versions of the whole cycle, the reference's all_gather of every pool's
running usage a direct sum over the pools; on the card
``ops/pallas_cycle.megacycle`` runs the same math as CUDA stage kernels
(the dense form through ``ops/pallas_cycle.dense_wire``).

Over a mesh (``parallel/mesh``), :func:`make_pool_cycle` and
:func:`mesh_megacycle` run each slot's contiguous pool block on its
device, and cross-device copies play the reference's two collectives:
the gather of every pool's running base and group id, over which each
pool's quota-group base is summed (:func:`group_bases`), and the gather
of the matched usage with the sum of the placements.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import dru as dru_ops
from ..ops import match as match_ops
from ..ops import quant
from ..ops.considerable import considerable_body
from ..ops.delta import (FLAG_ENQUEUE_OK, FLAG_LAUNCH_OK, FLAG_PENDING,
                         FLAG_USER_FIRST, FLAG_VALID)
from ..ops.scan import (segmented_cumsum_by_first_idx,
                        user_segments_from_flags, window32_sum)

INF = float("inf")


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


class PoolCycleInputs(NamedTuple):
    """Per-pool padded arrays with the DENSE constraint mask, stacked on
    a leading pool axis [P, ...] (the entity pack's form).  Pending rows
    double as match candidates (job_res/cmask); running rows have
    pending=False."""

    usage: torch.Tensor        # f32[P, T, 4] (cpus, mem, gpus, 1)
    quota: torch.Tensor        # f32[P, T, 4]
    shares: torch.Tensor       # f32[P, T, 3]
    first_idx: torch.Tensor    # i32[P, T]
    user_rank: torch.Tensor    # i32[P, T]
    pending: torch.Tensor      # bool[P, T]
    valid: torch.Tensor        # bool[P, T]
    enqueue_ok: torch.Tensor   # bool[P, T] False = host-stifled job
    launch_ok: torch.Tensor    # bool[P, T] launch-plugin verdicts
    tokens: torch.Tensor       # f32[P, T] user launch-rate budget
    num_considerable: torch.Tensor  # i32[P] backoff cap
    pool_quota: torch.Tensor   # f32[P, 4]
    group_quota: torch.Tensor  # f32[P, 4]
    group_id: torch.Tensor     # i32[P] quota-group id, -1 = none
    job_res: torch.Tensor      # f32[P, T, 4] (cpus, mem, gpus, disk)
    cmask: torch.Tensor        # bool[P, T, H]
    avail: torch.Tensor        # f32[P, H, 4]
    capacity: torch.Tensor     # f32[P, H, 4]


_DENSE_DTYPES = {
    "usage": torch.float32, "quota": torch.float32, "shares": torch.float32,
    "first_idx": torch.int32, "user_rank": torch.int32,
    "pending": torch.bool, "valid": torch.bool, "enqueue_ok": torch.bool,
    "launch_ok": torch.bool, "tokens": torch.float32,
    "num_considerable": torch.int32, "pool_quota": torch.float32,
    "group_quota": torch.float32, "group_id": torch.int32,
    "job_res": torch.float32, "cmask": torch.bool, "avail": torch.float32,
    "capacity": torch.float32,
}


def dense_inputs_from_numpy(fields: dict, device="cuda") -> PoolCycleInputs:
    """The port's PoolCycleInputs from numpy arrays holding the fields of
    the JAX package's PoolCycleInputs."""
    dev = resolve_device(device)
    return PoolCycleInputs(**{
        k: torch.as_tensor(np.asarray(fields[k])).to(dev, _DENSE_DTYPES[k])
        for k in PoolCycleInputs._fields})


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


def _pool_cycle_one(usage, quota, shares, first_idx, user_rank, pending,
                    valid, enqueue_ok, launch_ok, tokens, num_considerable,
                    pool_quota, group_quota, pool_base, group_base,
                    job_res, cmask, avail, capacity,
                    gpu_mode: bool, max_over_quota_jobs: int,
                    considerable_cap: Optional[int] = None):
    """One pool's full rank -> considerable -> match with a DENSE
    bool[T, H] constraint mask.  ``considerable_cap`` bounds the match
    problem (it must be >= the dynamic ``num_considerable`` or over-cap
    admitted rows stay unmatched this cycle).  Returns the reference's
    tuple: (order, num_ranked, dru, assign [T] in rank order,
    match_valid, queue_ok, accepted, matched_usage) + the compact
    outputs."""
    T = pending.shape[0]
    order, num_ranked, dru, cr = _rank_admit(
        usage, quota, shares, first_idx, user_rank, pending, valid,
        enqueue_ok, launch_ok, tokens, num_considerable, pool_quota,
        group_quota, pool_base, group_base, gpu_mode, max_over_quota_jobs)
    cap = T if considerable_cap is None else min(considerable_cap, T)
    sel, task_idx, valid_c, assign_c = _match_tail(
        order, cr, job_res, lambda ti: cmask[ti], avail, capacity, cap)
    # scatter back to rank order; sentinel slots (sel == T) drop out
    assign = torch.full((T + 1,), -1, dtype=torch.int32, device=order.device)
    assign[sel.long()] = assign_c
    assign = assign[:T]
    res_c = job_res[task_idx.long()] * valid_c[:, None]
    matched = assign_c >= 0
    matched_usage = window32_sum(res_c * matched[:, None], dim=0)[:4]
    compact = _compact_outputs(order, cr.queue_ok, sel, task_idx, valid_c,
                               assign_c, T)
    return (order, num_ranked, dru, assign, cr.match_valid, cr.queue_ok,
            cr.accepted, matched_usage) + compact


def single_pool_cycle(usage, quota, shares, first_idx, user_rank, pending,
                      valid, job_res, cmask, avail, capacity,
                      gpu_mode: bool = False, max_over_quota_jobs: int = 100,
                      enqueue_ok=None, launch_ok=None, tokens=None,
                      num_considerable=None, pool_quota=None,
                      group_quota=None, group_base=None,
                      considerable_cap: Optional[int] = None):
    """One pool's fused rank + considerable + match step on the tensors'
    device, with permissive admission defaults.  Returns (order,
    num_ranked, dru, assign)."""
    T = pending.shape[0]
    dev = pending.device
    ones = torch.ones((T,), dtype=torch.bool, device=dev)
    enqueue_ok = ones if enqueue_ok is None else enqueue_ok
    launch_ok = ones if launch_ok is None else launch_ok
    tokens = (torch.full((T,), INF, dtype=torch.float32, device=dev)
              if tokens is None else tokens)
    num_considerable = (torch.tensor(T, dtype=torch.int32, device=dev)
                        if num_considerable is None else num_considerable)
    pool_quota = (torch.full((4,), INF, dtype=torch.float32, device=dev)
                  if pool_quota is None else pool_quota)
    group_quota = (torch.full((4,), INF, dtype=torch.float32, device=dev)
                   if group_quota is None else group_quota)
    pool_base = window32_sum(usage * (valid & ~pending)[:, None], dim=0)[:4]
    group_base = pool_base if group_base is None else group_base
    (order, num_ranked, dru, assign, *_rest) = _pool_cycle_one(
        usage, quota, shares, first_idx, user_rank, pending, valid,
        enqueue_ok, launch_ok, tokens, num_considerable, pool_quota,
        group_quota, pool_base, group_base, job_res, cmask, avail, capacity,
        gpu_mode, max_over_quota_jobs, considerable_cap)
    return order, num_ranked, dru, assign


class DensePoolCycleResult(NamedTuple):
    """The reference's PoolCycleResult of the dense cycle."""
    order: torch.Tensor          # i32[P, T]
    num_ranked: torch.Tensor     # i32[P]
    dru: torch.Tensor            # f32[P, T]
    assign: torch.Tensor         # i32[P, T] host per rank position, -1
    match_valid: torch.Tensor    # bool[P, T]
    queue_ok: torch.Tensor       # bool[P, T]
    accepted: torch.Tensor       # bool[P, T]
    matched_usage: torch.Tensor  # f32[P, 4]
    total_matched: torch.Tensor  # i32[]
    queue_rows: torch.Tensor     # i32[P, T]
    n_queue: torch.Tensor        # i32[P]
    cand_row: torch.Tensor       # i32[P, C]
    cand_assign: torch.Tensor    # i32[P, C]
    cand_qpos: torch.Tensor      # i32[P, C]


def _dense_block(inp: PoolCycleInputs, pool_base, group_base, *,
                 gpu_mode: bool, max_over_quota_jobs: int,
                 considerable_cap: Optional[int]) -> list:
    """Every pool of one block of the dense inputs, on their device:
    the reference's per-pool result columns, stacked over the block."""
    outs = []
    for p in range(inp.pending.shape[0]):
        outs.append(_pool_cycle_one(
            inp.usage[p], inp.quota[p], inp.shares[p], inp.first_idx[p],
            inp.user_rank[p], inp.pending[p], inp.valid[p],
            inp.enqueue_ok[p], inp.launch_ok[p], inp.tokens[p],
            inp.num_considerable[p], inp.pool_quota[p], inp.group_quota[p],
            pool_base[p], group_base[p], inp.job_res[p], inp.cmask[p],
            inp.avail[p], inp.capacity[p], gpu_mode, max_over_quota_jobs,
            considerable_cap))
    return [torch.stack(c) for c in zip(*outs)]


def _dense_result(cols, total) -> "DensePoolCycleResult":
    (order, num_ranked, dru, assign, match_valid, queue_ok, accepted,
     matched_usage, queue_rows, n_queue, cand_row, cand_assign,
     cand_qpos) = cols
    return DensePoolCycleResult(
        order=order, num_ranked=num_ranked.to(torch.int32), dru=dru,
        assign=assign,
        match_valid=match_valid, queue_ok=queue_ok, accepted=accepted,
        matched_usage=matched_usage, total_matched=total,
        queue_rows=queue_rows, n_queue=n_queue.to(torch.int32),
        cand_row=cand_row, cand_assign=cand_assign, cand_qpos=cand_qpos)


def _placed(assign) -> torch.Tensor:
    return (assign >= 0).sum(dtype=torch.int32)


def dense_pool_cycle(inp: PoolCycleInputs, *, gpu_mode: bool = False,
                     max_over_quota_jobs: int = 100,
                     considerable_cap: Optional[int] = None,
                     device="cuda") -> DensePoolCycleResult:
    """The dense cycle over P pools on one device (plain PyTorch): the
    reference's ``make_pool_cycle(..., structured=False)`` on one
    device."""
    dev = resolve_device(device)
    inp = PoolCycleInputs(*(t.to(dev) for t in inp))
    pool_base, group_base = pool_bases(inp.usage, inp.pending, inp.valid,
                                       inp.group_id)
    cols = _dense_block(inp, pool_base, group_base, gpu_mode=gpu_mode,
                        max_over_quota_jobs=max_over_quota_jobs,
                        considerable_cap=considerable_cap)
    return _dense_result(cols, _placed(cols[3]))


class MeshCycleResult(NamedTuple):
    """The compact cycle over a mesh: ``ops/pallas_cycle``'s seven
    outputs, then the reconciliations' (every pool's, in mesh order)."""
    queue_rows: torch.Tensor     # i32[P, T]
    n_queue: torch.Tensor        # i32[P]
    cand_row: torch.Tensor       # i32[P, C]
    cand_assign: torch.Tensor    # i32[P, C]
    cand_qpos: torch.Tensor      # i32[P, C]
    cand_gang: torch.Tensor      # i32[P, C]
    cand_dropped: torch.Tensor   # i32[P, C]
    pool_base: torch.Tensor      # f32[P, 4] gathered (reconciliation #1)
    group_base: torch.Tensor     # f32[P, 4] summed over the gathered bases
    matched_usage: torch.Tensor  # f32[P, 4] gathered (reconciliation #2)
    total_matched: torch.Tensor  # i32[] summed over the slots


def _gather(parts, dev) -> torch.Tensor:
    """The collectives' counterpart: every slot's block copied to ``dev``
    and concatenated in mesh order (pool-major: the reference's tiled
    ``all_gather``)."""
    if len(parts) == 1:
        return parts[0].to(dev)
    return torch.cat([t.to(dev) for t in parts])


def _psum(parts, dev) -> torch.Tensor:
    return _gather([t.reshape(1) for t in parts], dev).sum(dtype=torch.int32)


def group_bases(base_all, gid_all, gid) -> torch.Tensor:
    """Reconciliation #1's sum: for each pool whose group id is in
    ``gid``, its quota group's running base over every pool of
    ``base_all`` (f32[P, 4], ids ``gid_all``), in XLA:CPU's order
    (``window32_sum`` over the pools); f32[len(gid), 4]."""
    same = (gid_all[None, :] == gid[:, None]) & (gid[:, None] >= 0)
    return window32_sum(base_all[None, :, :] * same[:, :, None], dim=1)


REPLICATED = ("res_base", "disk_base")


def shard_wire(mesh, wire) -> list:
    """``wire`` (an ``ops/pallas_cycle.MegaCycleWire``) as one wire a
    slot of ``mesh``: each pool-stacked field's block
    (``parallel/mesh.pool_sharding``) on the slot's device, the
    :data:`REPLICATED` index columns whole on every slot."""
    from ..ops.pallas_cycle import MegaCycleWire, to_device
    from .mesh import pool_sharding
    blocks = pool_sharding(mesh).blocks(wire.group_id.shape[0])
    return [MegaCycleWire(*(
        to_device(t if f in REPLICATED else t[b], d).contiguous()
        for f, t in zip(MegaCycleWire._fields, wire)))
        for b, d in zip(blocks, mesh.devices)]


def mesh_megacycle(mesh, parts, *, gpu_mode: bool = False,
                   max_over_quota_jobs: int = 100,
                   considerable_cap: int = 1024,
                   rows_codec: int = quant.ROWS_WIDE,
                   avail_scale=0.0, cap_scale=0.0, stats: bool = False):
    """``ops/pallas_cycle.megacycle`` over a mesh: ``parts`` holds one
    wire a slot, each its pool block on the slot's device
    (:func:`shard_wire`, or the driver's staging), and each runs
    through the stage chain (the kernels on a card, their plain
    versions on the CPU).  Between K1 and the admission stage
    (``ops/stages.admit_match``'s ``group_base``) reconciliation #1
    gathers every slot's pool bases and group ids and sums each pool's
    quota-group base over all of them; with one slot K1's own base is
    already that sum and the chain is ``megacycle_stages``, launch for
    launch.  The outputs are gathered onto the first slot's device.
    Returns the ``MegaCycleResult``, or with ``stats`` the
    :class:`MeshCycleResult` (reconciliation #2 adds every pool's
    matched usage and the placement total)."""
    from ..ops import stages
    from ..ops.pallas_cycle import MegaCycleResult
    devs = mesh.devices
    if len(parts) != len(devs):
        raise ValueError(f"{len(parts)} slot wires for a "
                         f"{len(devs)}-slot mesh")
    # pass 1: each slot's wire decode and phase-0 bases (K2 + K1)
    heads = [stages.decode(w, rows_codec=rows_codec, avail_scale=avail_scale,
                           cap_scale=cap_scale) for w in parts]
    pool_base = _gather([x.pool_base for _ur, x in heads], devs[0])
    if len(parts) > 1:
        # reconciliation #1: every pool's running base and group id
        gid_all = _gather([w.group_id for w in parts], devs[0])
        group = [group_bases(pool_base.to(d), gid_all.to(d),
                             w.group_id).contiguous()
                 for w, d in zip(parts, devs)]
    else:
        group = [None]
    # pass 2: the rest of the cycle on each slot's block
    outs = [stages.admit_match(w, ur, x, gpu_mode=gpu_mode,
                               max_over_quota_jobs=max_over_quota_jobs,
                               considerable_cap=considerable_cap,
                               group_base=g)
            for w, (ur, x), g in zip(parts, heads, group)]
    res = MegaCycleResult(*(_gather([getattr(r, f) for r, _c in outs],
                                    devs[0])
                            for f in MegaCycleResult._fields))
    if not stats:
        return res
    # reconciliation #2: every pool's matched usage, the placement total
    used = [window32_sum(c.res_c * (r.cand_assign >= 0)[..., None],
                         dim=1)[:, :4] for r, c in outs]
    group_base = _gather([x.group_base for _ur, x in heads]
                         if group[0] is None else group, devs[0])
    return MeshCycleResult(
        *res, pool_base=pool_base, group_base=group_base,
        matched_usage=_gather(used, devs[0]),
        total_matched=_psum([_placed(r.cand_assign) for r, _c in outs],
                            devs[0]))


def compact_wire(inp: CompactPoolCycleInputs):
    """The wide ``MegaCycleWire`` of the compact inputs on their device:
    i32 rows, f32 hosts, the host vectors bit-packed, the no-op gang
    wire."""
    from ..ops.pallas_cycle import MegaCycleWire, empty_gang_wire
    from ..ops.quant import pack_bits_device
    P, T = inp.rows.shape
    H = inp.avail.shape[1]
    dev = inp.rows.device
    gang = [torch.from_numpy(a).to(dev) for a in empty_gang_wire(P, T, H)]
    return MegaCycleWire(
        rows=inp.rows.to(torch.int32), flags=inp.flags,
        res_base=inp.res_base, disk_base=inp.disk_base,
        tokens_u=inp.tokens_u, shares_u=inp.shares_u, quota_u=inp.quota_u,
        num_considerable=inp.num_considerable, pool_quota=inp.pool_quota,
        group_quota=inp.group_quota, group_id=inp.group_id,
        host_bits=torch.stack([pack_bits_device(inp.host_gpu),
                               pack_bits_device(inp.host_blocked)], dim=1),
        exc_rows=inp.exc_rows, exc_mask=inp.exc_mask, avail=inp.avail,
        capacity=inp.capacity, gang_id=gang[0], gang_size=gang[1],
        gang_attr=gang[2], host_topo=gang[3])


def _mesh_dense(mesh, inp: PoolCycleInputs, **kw) -> DensePoolCycleResult:
    """The dense cycle over a mesh (plain PyTorch on each slot's
    device): each slot's pool bases, reconciliation #1, each slot's
    pools, reconciliation #2."""
    from .mesh import pool_sharding
    devs = mesh.devices
    layout = pool_sharding(mesh)
    parts = [PoolCycleInputs(*blk)
             for blk in zip(*(layout.shard(t) for t in inp))]
    bases = [window32_sum(p.usage * (p.valid & ~p.pending)[..., None],
                          dim=1)[:, :4] for p in parts]
    base_all = _gather(bases, devs[0])
    gid_all = _gather([p.group_id for p in parts], devs[0])
    cols = [_dense_block(p, b, group_bases(base_all.to(d), gid_all.to(d),
                                           p.group_id), **kw)
            for p, b, d in zip(parts, bases, devs)]
    total = _psum([_placed(c[3]) for c in cols], devs[0])
    return _dense_result([_gather(c, devs[0]) for c in zip(*cols)], total)


def make_pool_cycle(mesh, *, gpu_mode: bool = False,
                    max_over_quota_jobs: int = 100,
                    considerable_cap: Optional[int] = None,
                    structured: bool = False, compact: bool = False):
    """The pool-sharded cycle over ``mesh`` (``parallel/mesh.pool_mesh``
    or ``multislice_pool_mesh``): each slot runs its contiguous pool
    block on its device; the pool axis must divide over the slots.

    ``compact=True`` takes :class:`CompactPoolCycleInputs` and runs
    :func:`mesh_megacycle` on its wide wire (:func:`compact_wire`: the
    stage kernels on a card, their plain versions on the CPU), returning
    a :class:`MeshCycleResult`.  Otherwise it takes the dense
    :class:`PoolCycleInputs` and runs the plain dense cycle on each
    slot's device, returning the reference's result
    (:class:`DensePoolCycleResult`); the dense form's card route is
    ``ops/pallas_cycle.dense_wire`` through :func:`mesh_megacycle`.  The
    structured non-compact form has no caller in either package's
    drivers and is not offered."""
    if compact:
        if considerable_cap is None:
            raise ValueError("the compact cycle needs a considerable_cap")

        def cycle(inp: CompactPoolCycleInputs) -> MeshCycleResult:
            cap = int(min(considerable_cap, inp.rows.shape[1]))
            return mesh_megacycle(
                mesh, shard_wire(mesh, compact_wire(inp)),
                gpu_mode=gpu_mode, max_over_quota_jobs=max_over_quota_jobs,
                considerable_cap=cap, stats=True)
        return cycle
    if structured:
        raise ValueError("make_pool_cycle: structured=True needs "
                         "compact=True here")
    return lambda inp: _mesh_dense(
        mesh, inp, gpu_mode=gpu_mode,
        max_over_quota_jobs=max_over_quota_jobs,
        considerable_cap=considerable_cap)


def pool_bases(usage, pending, valid, group_id):
    """Every pool's running usage and its quota group's total: f32[P, 4]
    each, summed in XLA:CPU's order over tasks and over pools
    (``window32_sum``: centred windows of 32) so the port's caps see the
    reference's bits."""
    run = usage * (valid & ~pending)[..., None]
    pool_base = window32_sum(run, dim=1)[:, :4]
    return pool_base, group_bases(pool_base, group_id, group_id)


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
