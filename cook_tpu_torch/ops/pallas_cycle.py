"""The fused scheduling cycle in one call: ``megacycle`` is the port of
``cook_tpu/ops/pallas_cycle.py``'s Pallas megakernel (``_kernel`` :137,
entry ``megacycle`` :331).

The Pallas kernel keeps a pool's whole [T] chain in about 13 MB of TPU
VMEM.  An SM has 227 KB of shared memory, so on the card the megakernel
becomes a chain of CUDA stage kernels over device memory, each written
by hand for sm_90a (``csrc/``):

  K1 expand  (ops/expand.py)   wire decode, gathers, phase-0 pool bases
  K2 scan    (ops/scan.py)     segmented / blocked / integer prefixes
  K3 sort    (ops/sort.py)     stable LSD radix sorts (rank, user-major)
  K4 admit   (ops/admit.py)    over-quota limit, DRU, admission,
                               compaction, compact outputs
  K5 greedy  (ops/match.py)    greedy assignment, one CTA per pool
  K6 gang    (ops/gang.py)     gang_min-gated segment reduction

Torch only allocates memory and calls them.  On the CPU ``megacycle``
runs the plain cycle instead: ``parallel/sharded.pool_cycle`` plus
``gang_reduce_body``, the same decisions by construction.
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
            a = a.astype(bool)
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
