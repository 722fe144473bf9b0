"""Kernel K1: the wire decode at the head of the cycle and its phase 0
(``csrc/expand.cu``), replacing ``cook_tpu/ops/pallas_cycle.py::_kernel``
:155-212 (the ``expand_compact`` recipe of ``cook_tpu/parallel/
sharded.py:206``, the quantized-wire decodes of ``cook_tpu/ops/quant.py``
:121,178,201, and the per-pool running usage banked in phase 0).

The plain version decodes with ``ops/quant``'s plain decodes and sums
the bases with ``parallel/sharded.pool_bases``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib, quant
from .delta import FLAG_PENDING, FLAG_USER_FIRST, FLAG_VALID

KERNEL = "expand"


class Expanded(NamedTuple):
    usage: torch.Tensor       # f32[P, T, 4] res_base[rows]
    job_res: torch.Tensor     # f32[P, T, 4] (cpus, mem, gpus, disk) * pending
    tokens: torch.Tensor      # f32[P, T] per-user gathers ...
    shares: torch.Tensor      # f32[P, T, 3]
    quota: torch.Tensor       # f32[P, T, 4]
    start: torch.Tensor       # u8[P, T] segment start (USER_FIRST or t == 0)
    last_mark: torch.Tensor   # i32[P, T] t at a segment's last row, else T-1
    exc_id: torch.Tensor      # i32[P, T] exception row index, -1
    host_gpu: torch.Tensor    # u8[P, H]
    host_blocked: torch.Tensor  # u8[P, H]
    avail: torch.Tensor       # f32[P, H, 4]
    capacity: torch.Tensor    # f32[P, H, 4]
    pool_base: torch.Tensor   # f32[P, 4] running usage per pool
    group_base: torch.Tensor  # f32[P, 4] running usage of the quota group


def _scales(scale):
    if scale == 0.0:
        return 0, (0.0, 0.0, 0.0, 0.0)
    return 1, tuple(float(s) for s in scale)


def _expand_plain(rows, flags, res_base, disk_base, tokens_u, shares_u,
                  quota_u, user_rank, group_id, host_bits, exc_rows,
                  avail_in, cap_in, *, rows_codec, avail_scale, cap_scale,
                  n_hosts):
    from ..parallel.sharded import pool_bases
    P, T = flags.shape
    dev = flags.device
    r = quant.expand_rows_device(rows_codec, rows).long()
    usage = res_base[r]
    pending = (flags & FLAG_PENDING) != 0
    valid = (flags & FLAG_VALID) != 0
    is_first = (flags & FLAG_USER_FIRST) != 0
    job_res = torch.cat([usage[..., :3], disk_base[r][..., None]], dim=-1) \
        * pending.to(torch.float32)[..., None]
    U = tokens_u.shape[1]
    ur = torch.clamp(user_rank, 0, U - 1).long()
    pidx = torch.arange(P, device=dev)[:, None]
    t = torch.arange(T, device=dev)
    start = is_first | (t == 0)
    nxt = torch.ones_like(is_first)
    nxt[:, :-1] = is_first[:, 1:]
    last_mark = torch.where(nxt, t.to(torch.int32), T - 1).to(torch.int32)
    E = exc_rows.shape[1]
    slot = torch.where((exc_rows >= 0) & (exc_rows < T), exc_rows, T).long()
    exc_id = torch.full((P, T + 1), -1, dtype=torch.int32, device=dev)
    exc_id.scatter_reduce_(
        1, slot, torch.arange(E, dtype=torch.int32, device=dev).expand(P, E),
        "amax")
    pool_base, group_base = pool_bases(usage, pending, valid, group_id)
    u8 = torch.uint8
    return Expanded(
        usage=usage, job_res=job_res, tokens=torch.gather(tokens_u, 1, ur),
        shares=shares_u[pidx, ur], quota=quota_u[pidx, ur],
        start=start.to(u8), last_mark=last_mark,
        exc_id=exc_id[:, :T].contiguous(),
        host_gpu=quant.unpack_bits_device(host_bits[:, 0], n_hosts).to(u8),
        host_blocked=quant.unpack_bits_device(host_bits[:, 1],
                                              n_hosts).to(u8),
        avail=quant.expand_fixed_device(avail_scale, avail_in),
        capacity=quant.expand_fixed_device(cap_scale, cap_in),
        pool_base=pool_base, group_base=group_base)


def _win32_scratch(P: int, T: int) -> int:
    total, nk = 0, T
    while True:
        nb = (nk + 31) // 32
        if nb == 1:
            return total
        total += P * nb * 4
        nk = nb


_ROWS_DTYPE = {quant.ROWS_WIDE: torch.int32, quant.ROWS_I16: torch.int16,
               quant.ROWS_I8: torch.int8}


@cuda_lib.stage(KERNEL, _expand_plain,
                (None, torch.uint8) + (torch.float32,) * 5
                + (torch.int32, torch.int32, torch.uint8, torch.int32))
def expand(rows, flags, res_base, disk_base, tokens_u, shares_u, quota_u,
           user_rank, group_id, host_bits, exc_rows, avail_in, cap_in, *,
           rows_codec, avail_scale, cap_scale, n_hosts):
    """Decode the negotiated wire of every pool (``user_rank`` from the
    K2 count of USER_FIRST bits) into the cycle's per-task and per-host
    tensors, and sum the pool and quota-group running bases."""
    P, T = flags.shape
    H = int(n_hosts)
    U = tokens_u.shape[1]
    E = exc_rows.shape[1]
    B = host_bits.shape[2]
    cuda_lib.check(rows, _ROWS_DTYPE[rows_codec], (P, T), "rows")
    cuda_lib.check(user_rank, torch.int32, (P, T), "user_rank")
    a_u16, a_s = _scales(avail_scale)
    c_u16, c_s = _scales(cap_scale)
    for t, u16, name in ((avail_in, a_u16, "avail"), (cap_in, c_u16, "cap")):
        cuda_lib.check(t, torch.uint16 if u16 else torch.float32, (P, H, 4),
                       name)
    dev = flags.device
    f32, u8, i32 = torch.float32, torch.uint8, torch.int32
    out = Expanded(
        usage=torch.empty((P, T, 4), dtype=f32, device=dev),
        job_res=torch.empty((P, T, 4), dtype=f32, device=dev),
        tokens=torch.empty((P, T), dtype=f32, device=dev),
        shares=torch.empty((P, T, 3), dtype=f32, device=dev),
        quota=torch.empty((P, T, 4), dtype=f32, device=dev),
        start=torch.empty((P, T), dtype=u8, device=dev),
        last_mark=torch.empty((P, T), dtype=i32, device=dev),
        exc_id=torch.empty((P, T), dtype=i32, device=dev),
        host_gpu=torch.empty((P, H), dtype=u8, device=dev),
        host_blocked=torch.empty((P, H), dtype=u8, device=dev),
        avail=torch.empty((P, H, 4), dtype=f32, device=dev),
        capacity=torch.empty((P, H, 4), dtype=f32, device=dev),
        pool_base=torch.empty((P, 4), dtype=f32, device=dev),
        group_base=torch.empty((P, 4), dtype=f32, device=dev))
    scratch = torch.empty(max(_win32_scratch(P, T), 1), dtype=f32,
                          device=dev)
    cuda_lib.call(
        "k1_expand", KERNEL, rows.data_ptr(), int(rows_codec),
        flags.data_ptr(), res_base.data_ptr(), disk_base.data_ptr(),
        tokens_u.data_ptr(), shares_u.data_ptr(), quota_u.data_ptr(),
        user_rank.data_ptr(), group_id.data_ptr(), host_bits.data_ptr(),
        exc_rows.data_ptr(), avail_in.data_ptr(), a_u16, *a_s,
        cap_in.data_ptr(), c_u16, *c_s, *(t.data_ptr() for t in out),
        scratch.data_ptr(), P, T, U, E, H, B)
    return out
