"""The fused scheduling cycle in one call: ``megacycle`` is the port of
``cook_tpu/ops/pallas_cycle.py``'s Pallas megakernel (``_kernel`` :137,
entry ``megacycle`` :331).

The Pallas kernel keeps a pool's whole [T] chain in about 13 MB of TPU
VMEM.  An SM has 227 KB of shared memory, so on the card the megakernel
becomes a chain of CUDA stage kernels over device memory, each written
by hand for sm_90a (``csrc/``):

  K1 expand  (ops/expand.py)   wire decode, gathers, phase-0 pool bases
  K2 scan    (ops/scan.py)     segmented / blocked / integer prefixes,
                               one tiled launch a scan
  K3 sort    (ops/sort.py)     stable LSD radix sorts (rank, user-major)
  K4 admit   (ops/admit.py)    over-quota limit, DRU, admission,
                               compaction (inside the K2 launches beside
                               them), compact outputs
  K5 greedy  (ops/match.py)    greedy assignment, one cluster per pool
  K6 gang    (ops/gang.py)     gang_min-gated segment reduction (the
                               epilogue of K5's launch)

Torch only allocates memory and calls them.  On the CPU ``megacycle``
runs the plain cycle instead: ``parallel/sharded.pool_cycle`` plus
``gang_reduce_body``, the same decisions by construction.

The dense-mask cycle (the entity pack's ``PoolCycleInputs``, whose
plain version is ``parallel/sharded.dense_pool_cycle``) runs through the
same chain: :func:`dense_wire` recasts its already expanded columns as
a wire whose rows are the identity into its own usage (so K1's gathers
return the dense columns and its phase 0 sums the pool bases in the
reference's order), whose segment bits reproduce the dense segments
exactly, and in which every task is its own exception row with the
dense ``cmask`` row as its mask, so K5 places each admitted slot
against exactly that row: ``megacycle(wire_from_numpy(dense_wire(
fields), device))`` is the dense cycle, its gang outputs the no-op
reduction (the dense pack stages no gang wire).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import quant

_BIG = 2 ** 30


class MegaCycleWire(NamedTuple):
    """The compact wire with each quantizable field in its negotiated
    form (the codec tags are separate arguments of ``megacycle``)."""

    rows: torch.Tensor        # [P, T] i32 | i16 | i8 (codec-tagged)
    flags: torch.Tensor       # u8[P, T]
    res_base: torch.Tensor    # f32[N, 4]
    disk_base: torch.Tensor   # f32[N]
    tokens_u: torch.Tensor    # f32[P, U]
    shares_u: torch.Tensor    # f32[P, U, 3]
    quota_u: torch.Tensor     # f32[P, U, 4]
    num_considerable: torch.Tensor  # i32[P]
    pool_quota: torch.Tensor  # f32[P, 4]
    group_quota: torch.Tensor  # f32[P, 4]
    group_id: torch.Tensor    # i32[P]
    host_bits: torch.Tensor   # u8[P, 2, ceil(H/8)] (gpu, blocked)
    exc_rows: torch.Tensor    # i32[P, E]
    exc_mask: torch.Tensor    # bool[P, E, H]
    avail: torch.Tensor       # [P, H, 4] f32 | u16 (scale-tagged)
    capacity: torch.Tensor    # [P, H, 4] f32 | u16
    gang_id: torch.Tensor     # i32[P, T] gang segment by task row, -1
    gang_size: torch.Tensor   # i32[P, G] reduction threshold (gang_min)
    gang_attr: torch.Tensor   # i32[P, G]
    host_topo: torch.Tensor   # i32[P, A, H]


class MegaCycleResult(NamedTuple):
    queue_rows: torch.Tensor   # i32[P, T]
    n_queue: torch.Tensor      # i32[P]
    cand_row: torch.Tensor     # i32[P, C]
    cand_assign: torch.Tensor  # i32[P, C] pre-gang assignment
    cand_qpos: torch.Tensor    # i32[P, C]
    cand_gang: torch.Tensor    # i32[P, C] post-gang assignment
    cand_dropped: torch.Tensor  # i32[P, C] 1 = the reduction reset it


_INT_FIELDS = {"num_considerable", "group_id", "exc_rows", "gang_id",
               "gang_size", "gang_attr", "host_topo"}
_F32_FIELDS = {"res_base", "disk_base", "tokens_u", "shares_u", "quota_u",
               "pool_quota", "group_quota"}


def wire_from_numpy(fields: dict, device="cuda") -> MegaCycleWire:
    """The port's wire from numpy arrays holding the JAX package's
    MegaCycleWire fields.  Narrow fields keep their dtype (rows i8/i16,
    avail/capacity u16); the scalars keep their [P] shape."""
    dev = resolve_device(device)
    out = {}
    for k in MegaCycleWire._fields:
        a = np.asarray(fields[k])
        if k in _INT_FIELDS:
            a = a.astype(np.int32)
        elif k in _F32_FIELDS:
            a = a.astype(np.float32)
        elif k == "exc_mask":
            # no host copy: the dense wire's mask is [P, T, H]
            a = a.astype(bool, copy=False)
        out[k] = to_device(torch.from_numpy(np.ascontiguousarray(a)), dev)
    return MegaCycleWire(**out)


def to_device(t: torch.Tensor, dev) -> torch.Tensor:
    """``t.to(dev)``; u16 tensors move as their int16 bit pattern."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(dev).view(torch.uint16)
    return t.to(dev)


def empty_gang_wire(P: int, T: int, H: int) -> Tuple[np.ndarray, ...]:
    """The no-op gang wire: no members, one padding gang of unreachable
    size."""
    return (np.full((P, T), -1, dtype=np.int32),
            np.full((P, 8), _BIG, dtype=np.int32),
            np.zeros((P, 8), dtype=np.int32),
            np.full((P, 1, H), -1, dtype=np.int32))


def decode_wire(wire: MegaCycleWire, rows_codec: int, avail_scale,
                cap_scale):
    """Plain decode of the negotiated wire into the compact cycle inputs
    (``parallel/sharded.CompactPoolCycleInputs``)."""
    from ..parallel.sharded import CompactPoolCycleInputs
    H = wire.exc_mask.shape[2]
    return CompactPoolCycleInputs(
        rows=quant.expand_rows_device(rows_codec, wire.rows),
        flags=wire.flags, res_base=wire.res_base, disk_base=wire.disk_base,
        tokens_u=wire.tokens_u, shares_u=wire.shares_u,
        quota_u=wire.quota_u, num_considerable=wire.num_considerable,
        pool_quota=wire.pool_quota, group_quota=wire.group_quota,
        group_id=wire.group_id,
        host_gpu=quant.unpack_bits_device(wire.host_bits[:, 0], H),
        host_blocked=quant.unpack_bits_device(wire.host_bits[:, 1], H),
        exc_rows=wire.exc_rows, exc_mask=wire.exc_mask,
        avail=quant.expand_fixed_device(avail_scale, wire.avail),
        capacity=quant.expand_fixed_device(cap_scale, wire.capacity))


def megacycle_plain(wire: MegaCycleWire, *, gpu_mode: bool = False,
                    max_over_quota_jobs: int = 100,
                    considerable_cap: int = 1024,
                    rows_codec: int = quant.ROWS_WIDE,
                    avail_scale=0.0, cap_scale=0.0) -> MegaCycleResult:
    """The plain PyTorch cycle on the wire's own device: ``pool_cycle``
    then ``gang_reduce_body`` over each pool's candidate slots."""
    from ..parallel.sharded import pool_cycle
    from .gang import gang_reduce_candidates
    cap = int(min(considerable_cap, wire.rows.shape[1]))
    inp = decode_wire(wire, rows_codec, avail_scale, cap_scale)
    res = pool_cycle(inp, considerable_cap=cap, gpu_mode=gpu_mode,
                     max_over_quota_jobs=max_over_quota_jobs,
                     device=wire.rows.device)
    cand_gang, dropped = gang_reduce_candidates(
        res.cand_row, res.cand_assign, wire.gang_id, wire.gang_size,
        wire.gang_attr, wire.host_topo)
    return MegaCycleResult(
        queue_rows=res.queue_rows, n_queue=res.n_queue.to(torch.int32),
        cand_row=res.cand_row, cand_assign=res.cand_assign,
        cand_qpos=res.cand_qpos, cand_gang=cand_gang, cand_dropped=dropped)


def megacycle(wire: MegaCycleWire, *, gpu_mode: bool = False,
              max_over_quota_jobs: int = 100,
              considerable_cap: int = 1024,
              rows_codec: int = quant.ROWS_WIDE,
              avail_scale=0.0, cap_scale=0.0,
              device="cuda") -> MegaCycleResult:
    """One fused scheduling cycle over every pool of the wire.  On
    ``cuda`` the CUDA stage kernels run it; on ``cpu`` the plain cycle.
    The wire is moved to ``device`` first."""
    dev = resolve_device(device)
    wire = MegaCycleWire(*(to_device(t, dev) for t in wire))
    kw = dict(gpu_mode=gpu_mode, max_over_quota_jobs=max_over_quota_jobs,
              considerable_cap=considerable_cap, rows_codec=rows_codec,
              avail_scale=avail_scale, cap_scale=cap_scale)
    if dev.type == "cpu":
        return megacycle_plain(wire, **kw)
    from .stages import megacycle_stages
    return megacycle_stages(wire, **kw)


def dense_wire(fields: dict) -> dict:
    """The wire fields (numpy, for :func:`wire_from_numpy`) of a dense
    cycle's inputs: ``fields`` holds the stacked PoolCycleInputs arrays
    (numpy, [P, T, ...]).

    * ``rows[p, t] = p * T + t`` into ``res_base`` = the usage rows and
      ``disk_base`` = the job_res disk column, so K1's decode returns
      usage, and job_res as (cpus, mem, gpus) of usage with that disk,
      times pending, which is the dense job_res (pending rows' usage is
      their demand; running rows' job_res is zero in both);
    * USER_FIRST where the segment changes (``first_idx[t] !=
      first_idx[t - 1]``, and at 0): the dense segments' starts
      (``first_idx == t``) and ends, the first padding row included
      (the dense end of the last user when it is not the first), so the
      segmented scans and segment totals see the dense segments;
    * per-user tables taken at each segment's first row (tokens, shares
      and quota are per-user columns in the dense pack), gathered back
      by K1 through the segment index, which is the dense user_rank on
      every valid row;
    * every task its own exception row (``exc_rows[p, t] = t``) with the
      dense ``cmask`` as ``exc_mask``; the host bits are never read for
      an exception row.

    Padding and running rows may differ from the dense arrays only where
    the cycle masks them (not valid, or not pending)."""
    pending = np.asarray(fields["pending"], dtype=bool)
    P, T = pending.shape
    first = np.asarray(fields["first_idx"]).astype(np.int64)
    change = np.ones((P, T), dtype=bool)
    change[:, 1:] = first[:, 1:] != first[:, :-1]
    from .delta import pack_flags
    flags = pack_flags(pending, np.asarray(fields["valid"], dtype=bool),
                       change,
                       enqueue_ok=np.asarray(fields["enqueue_ok"], bool),
                       launch_ok=np.asarray(fields["launch_ok"], bool))
    seg = np.cumsum(change, axis=1) - 1
    from .padding import bucket
    U = bucket(int(seg[:, -1].max()) + 1, minimum=8)
    tokens_u = np.full((P, U), np.inf, dtype=np.float32)
    shares_u = np.full((P, U, 3), np.inf, dtype=np.float32)
    quota_u = np.full((P, U, 4), np.inf, dtype=np.float32)
    tokens = np.asarray(fields["tokens"], dtype=np.float32)
    shares = np.asarray(fields["shares"], dtype=np.float32)
    quota = np.asarray(fields["quota"], dtype=np.float32)
    for p in range(P):
        at = np.flatnonzero(change[p])
        tokens_u[p, :at.size] = tokens[p, at]
        shares_u[p, :at.size] = shares[p, at]
        quota_u[p, :at.size] = quota[p, at]
    usage = np.asarray(fields["usage"], dtype=np.float32)
    job_res = np.asarray(fields["job_res"], dtype=np.float32)
    cmask = np.asarray(fields["cmask"], dtype=bool)
    H = cmask.shape[2]
    rows = (np.arange(P, dtype=np.int64)[:, None] * T
            + np.arange(T, dtype=np.int64)[None, :]).astype(np.int32)
    gang = empty_gang_wire(P, T, H)
    return dict(
        rows=rows, flags=flags,
        res_base=np.ascontiguousarray(usage.reshape(P * T, 4)),
        disk_base=np.ascontiguousarray(job_res[..., 3].reshape(P * T)),
        tokens_u=tokens_u, shares_u=shares_u, quota_u=quota_u,
        num_considerable=np.asarray(fields["num_considerable"], np.int32),
        pool_quota=np.asarray(fields["pool_quota"], np.float32),
        group_quota=np.asarray(fields["group_quota"], np.float32),
        group_id=np.asarray(fields["group_id"], np.int32),
        host_bits=np.stack([quant.pack_bits(np.zeros((P, H), bool)),
                            quant.pack_bits(np.ones((P, H), bool))], axis=1),
        exc_rows=np.ascontiguousarray(
            np.broadcast_to(np.arange(T, dtype=np.int32), (P, T))),
        exc_mask=cmask,
        avail=np.asarray(fields["avail"], np.float32),
        capacity=np.asarray(fields["capacity"], np.float32),
        gang_id=gang[0], gang_size=gang[1], gang_attr=gang[2],
        host_topo=gang[3])

