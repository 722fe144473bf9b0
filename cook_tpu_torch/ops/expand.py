"""Kernel K1: the wire decode at the head of the cycle and its phase 0
(``csrc/expand.cu``), replacing ``cook_tpu/ops/pallas_cycle.py::_kernel``
:155-212 (the ``expand_compact`` recipe of ``cook_tpu/parallel/
sharded.py:206``, the quantized-wire decodes of ``cook_tpu/ops/quant.py``
:121,178,201, and the per-pool running usage banked in phase 0).

The plain version decodes with ``ops/quant``'s plain decodes and sums
the bases with ``parallel/sharded.pool_bases``.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from . import cuda_lib, quant
from .scan import centred_pad
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


# ---------------------------------------------------------------- K1 plan
# The geometry csrc/expand.cu is compiled for (its constants of the same
# names; the C entry refuses any other).
TILE = 2_048          # kTile: task rows a CTA
HOST_TILE = 4_096     # kHostTile: hosts a CTA
THREADS = 256         # kExpandThreads
WIN = 32              # window32_sum's window
LEVEL1 = WIN * WIN    # rows of a level-1 window
MAX_POOLS = WIN * WIN
MAX_WINDOWS = 32_768  # level-1 windows a pool
SMEM_BYTES = 4 * 4 * (TILE + TILE // WIN) + 4 * TILE + 4 * 4 * (TILE // WIN)
_ALIGN = 16


class ExpandPlan(NamedTuple):
    """Launch geometry and slab layout of one K1 call: ``tiles`` task
    CTAs a pool then ``host_tiles`` host CTAs a pool (grid ``S * (tiles
    + host_tiles)``); ``windows`` level-1 partials a pool.  The task
    tiles start ``shift`` rows before row 0 (:func:`grid_shift`), so
    each holds whole level-1 windows of ``window32_sum``'s order.
    ``offsets`` are byte offsets into one slab of ``slab_bytes``: the 14
    outputs in ``Expanded`` order, then the partials [S, windows, 4] f32,
    then ``ctl_words`` u32 control words (a ticket a pool, then the
    ticket over pools at ``ctl_words - 1``), which the memset zeroes."""
    S: int
    T: int
    H: int
    shift: int
    tiles: int
    host_tiles: int
    windows: int
    ctl_words: int
    offsets: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    slab_bytes: int


_F32, _U8, _I32 = torch.float32, torch.uint8, torch.int32
_OUT_DTYPES = (_F32, _F32, _F32, _F32, _F32, _U8, _I32, _I32, _U8, _U8,
               _F32, _F32, _F32, _F32)
_SIZE = {_F32: 4, _I32: 4, _U8: 1}


def grid_shift(T: int) -> int:
    """Rows before row 0 at which ``window32_sum``'s level-1 windows (32
    windows of 32 rows) start over T rows: the first level's centred
    padding plus 32 times the second's; 0 when T is a power of two."""
    return centred_pad(T) + WIN * centred_pad(-(-T // WIN))


@functools.lru_cache(maxsize=64)
def expand_plan(S: int, T: int, H: int) -> ExpandPlan:
    if not (1 <= S <= MAX_POOLS and T >= 1 and H >= 0):
        raise ValueError(f"K1 needs 1 <= S <= {MAX_POOLS}, T >= 1, H >= 0; "
                         f"got {S}, {T}, {H}")
    shift = grid_shift(T)
    tiles = -(-(T + shift) // TILE)
    windows = -(-T // LEVEL1)
    if windows > MAX_WINDOWS:
        raise ValueError(f"K1 takes T up to {MAX_WINDOWS * LEVEL1}, got {T}")
    shapes = ((S, T, 4), (S, T, 4), (S, T), (S, T, 3), (S, T, 4), (S, T),
              (S, T), (S, T), (S, H), (S, H), (S, H, 4), (S, H, 4), (S, 4),
              (S, 4), (S, windows, 4), (S + 1,))
    dtypes = _OUT_DTYPES + (_F32, torch.int32)
    offsets, at = [], 0
    for shape, dt in zip(shapes, dtypes):
        offsets.append(at)
        n = math.prod(shape) * _SIZE[dt]
        at += -(-n // _ALIGN) * _ALIGN
    return ExpandPlan(S=S, T=T, H=H, shift=shift, tiles=tiles,
                      host_tiles=-(-H // HOST_TILE), windows=windows,
                      ctl_words=S + 1, offsets=tuple(offsets),
                      shapes=shapes, dtypes=dtypes, slab_bytes=at)


def carve(slab: torch.Tensor, plan: ExpandPlan) -> List[torch.Tensor]:
    """The plan's 14 outputs as contiguous views of the u8 ``slab`` (the
    partials and the control words stay pointers)."""
    typed = {dt: slab.view(dt) for dt in (_F32, _I32)}
    typed[_U8] = slab
    return [typed[dt].as_strided(shape, _strides(shape), off // _SIZE[dt])
            for off, shape, dt in zip(plan.offsets[:14], plan.shapes[:14],
                                      plan.dtypes[:14])]


def _strides(shape) -> Tuple[int, ...]:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))


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
    for t, name in ((res_base, "res_base"), (quota_u, "quota_u"),
                    (avail_in, "avail"), (cap_in, "cap")):
        if t.data_ptr() % (8 if t.dtype == torch.uint16 else 16):
            raise ValueError(f"expand: {name} must be aligned for vector "
                             f"loads")
    plan = expand_plan(P, T, H)
    slab = torch.empty(plan.slab_bytes, dtype=torch.uint8, device=flags.device)
    out = Expanded(*carve(slab, plan))
    at = slab.data_ptr()
    cuda_lib.call(
        "k1_expand", KERNEL, rows.data_ptr(), int(rows_codec),
        flags.data_ptr(), res_base.data_ptr(), disk_base.data_ptr(),
        tokens_u.data_ptr(), shares_u.data_ptr(), quota_u.data_ptr(),
        user_rank.data_ptr(), group_id.data_ptr(), host_bits.data_ptr(),
        exc_rows.data_ptr(), avail_in.data_ptr(), a_u16, *a_s,
        cap_in.data_ptr(), c_u16, *c_s, *(at + off for off in plan.offsets),
        plan.ctl_words, P, T, U, E, H, B, TILE, HOST_TILE, THREADS,
        plan.tiles, plan.host_tiles, plan.windows, plan.shift, SMEM_BYTES,
        plan=plan)
    return out
