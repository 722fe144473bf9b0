"""Scan primitives of the cycle, in the summation orders of the JAX
package on XLA:CPU, so that float sums agree bit for bit:

* :func:`segmented_cumsum` transcribes ``jax.lax.associative_scan``'s
  odd/even recursion (``cook_tpu/ops/scan.py:23``);
* :func:`prefix_sum_xla_cpu` is the order of ``jnp.cumsum`` on floats:
  a sequential sum inside each block of 16, the same scan applied
  recursively to the block totals, and the exclusive prefix of those
  totals added to each element;
* :func:`window32_sum` is the order of an axis ``jnp.sum`` over a
  power-of-two length >= 64: sequential sums over windows of 32, applied
  recursively until at most 32 partials remain, which are summed in
  order.

Integer prefixes are exact in any order.  :func:`lexsort` is numpy's
(last key primary), stable, built from chained stable sorts; float keys
go through :func:`float_sort_key`, JAX's sort order (-0 equals +0, NaN
after +inf).

The CUDA versions of these scans are kernel K2 (the stage wrappers
``seg_scan``, ``seg_count``, ``prefix16`` and ``int_scan`` below, over
``csrc/scan.cu``); the sorts are kernel K3 (``ops/sort.py``).
"""

from __future__ import annotations

import torch


def _sl(x: torch.Tensor, dim: int, start=None, stop=None, step=None):
    idx = [slice(None)] * x.ndim
    idx[dim] = slice(start, stop, step)
    return x[tuple(idx)]


def _combine(av, af, bv, bf):
    return torch.where(bf, bv, av + bv), af | bf


def _assoc_scan(v: torch.Tensor, f: torch.Tensor, dim: int):
    n = v.shape[dim]
    if n < 2:
        return v, f
    rv, rf = _combine(_sl(v, dim, 0, -1, 2), _sl(f, dim, 0, -1, 2),
                      _sl(v, dim, 1, None, 2), _sl(f, dim, 1, None, 2))
    ov, of = _assoc_scan(rv, rf, dim)
    if n % 2 == 0:
        ev, ef = _combine(_sl(ov, dim, 0, -1), _sl(of, dim, 0, -1),
                          _sl(v, dim, 2, None, 2), _sl(f, dim, 2, None, 2))
    else:
        ev, ef = _combine(ov, of, _sl(v, dim, 2, None, 2),
                          _sl(f, dim, 2, None, 2))
    ev = torch.cat([_sl(v, dim, 0, 1), ev], dim=dim)
    ef = torch.cat([_sl(f, dim, 0, 1), ef], dim=dim)
    out_v = torch.empty_like(v)
    out_f = torch.empty_like(f)
    _sl(out_v, dim, 0, None, 2).copy_(ev)
    _sl(out_v, dim, 1, None, 2).copy_(ov)
    _sl(out_f, dim, 0, None, 2).copy_(ef)
    _sl(out_f, dim, 1, None, 2).copy_(of)
    return out_v, out_f


def segmented_cumsum(x: torch.Tensor, start_flags: torch.Tensor,
                     dim: int = 0) -> torch.Tensor:
    """Per-segment inclusive prefix sum along ``dim``.  ``start_flags``
    (bool, shape ``x.shape[:dim + 1]``) marks each segment's first
    element.  The pairing order is ``lax.associative_scan``'s."""
    if dim < 0:
        dim += x.ndim
    flags = start_flags.to(torch.bool).reshape(
        tuple(start_flags.shape) + (1,) * (x.ndim - dim - 1))
    flags = flags.expand(x.shape).contiguous()
    out, _ = _assoc_scan(x, flags, dim)
    return out


def segmented_cumsum_by_first_idx(x: torch.Tensor, first_idx: torch.Tensor,
                                  dim: int = 0) -> torch.Tensor:
    if dim < 0:
        dim += x.ndim
    T = x.shape[dim]
    t = torch.arange(T, dtype=first_idx.dtype, device=x.device)
    t = t.reshape((T,) + (1,) * (first_idx.ndim - dim - 1))
    return segmented_cumsum(x, first_idx == t, dim)


def _seq_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    out = torch.empty_like(x)
    acc = _sl(x, dim, 0, 1)
    _sl(out, dim, 0, 1).copy_(acc)
    for i in range(1, x.shape[dim]):
        acc = acc + _sl(x, dim, i, i + 1)
        _sl(out, dim, i, i + 1).copy_(acc)
    return out


def prefix_sum_xla_cpu(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive prefix sum in ``jnp.cumsum``'s XLA:CPU order (blocked 16,
    recursive on the block totals)."""
    if dim < 0:
        dim += x.ndim
    n = x.shape[dim]
    if n <= 16:
        return _seq_cumsum(x, dim)
    nb = (n + 15) // 16
    pad = nb * 16 - n
    xm = torch.movedim(x, dim, 0)
    rest = xm.shape[1:]
    if pad:
        xm = torch.cat([xm, xm.new_zeros((pad,) + rest)], dim=0)
    blocks = xm.reshape((nb, 16) + rest)
    local = _seq_cumsum(blocks, 1).reshape((nb * 16,) + rest)[:n]
    last = torch.arange(nb, device=x.device) * 16 + 15
    last[-1] = n - 1
    tot = local[last]
    st = prefix_sum_xla_cpu(tot, 0)
    out = local.clone()
    body = out[16:]
    nbody = body.shape[0]
    excl = st[:-1].repeat_interleave(16, dim=0)[:nbody]
    out[16:] = body + excl
    return torch.movedim(out, 0, dim)


def window32_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum over ``dim`` in XLA:CPU's reduce order for a power-of-two
    length (windows of 32, each summed in order from zero)."""
    if dim < 0:
        dim += x.ndim
    xm = torch.movedim(x, dim, 0)
    while xm.shape[0] > 32:
        n = xm.shape[0]
        nb = (n + 31) // 32
        if nb * 32 != n:
            xm = torch.cat([xm, xm.new_zeros((nb * 32 - n,) + xm.shape[1:])])
        w = xm.reshape((nb, 32) + xm.shape[1:])
        acc = torch.zeros_like(w[:, 0])
        for j in range(32):
            acc = acc + w[:, j]
        xm = acc
    acc = torch.zeros_like(xm[0])
    for j in range(xm.shape[0]):
        acc = acc + xm[j]
    return acc


def user_segments_from_flags(is_first: torch.Tensor, dim: int = -1):
    """(user_rank, first_idx) from the wire's USER_FIRST bits: user_rank
    counts segment starts up to each row, less one; first_idx is the row
    of the latest start at or before each row (0 before any)."""
    if dim < 0:
        dim += is_first.ndim
    T = is_first.shape[dim]
    user_rank = torch.cumsum(is_first.to(torch.int32), dim=dim,
                             dtype=torch.int32) - 1
    shape = [1] * is_first.ndim
    shape[dim] = T
    iota = torch.arange(T, dtype=torch.int32,
                        device=is_first.device).reshape(shape)
    first_idx = torch.cummax(torch.where(is_first, iota, 0), dim=dim).values
    return user_rank, first_idx.to(torch.int32)


def float_sort_key(x: torch.Tensor) -> torch.Tensor:
    """int64 key whose order is JAX's float sort order: -0 and +0 equal,
    every NaN one positive NaN after +inf."""
    bits = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32)
    b = bits.to(torch.int64) & 0xFFFFFFFF
    key = torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)
    return torch.where(torch.isnan(x), torch.full_like(key, 0xFFC00000), key)


def lexsort(keys, dim: int = -1) -> torch.Tensor:
    """Stable lexicographic argsort, numpy's convention: the LAST key is
    primary; equal keys keep their input order.  Float keys are ordered
    by :func:`float_sort_key`."""
    keys = [float_sort_key(k) if k.is_floating_point() else k.to(torch.int64)
            for k in keys]
    if dim < 0:
        dim += keys[0].ndim
    shape = [1] * keys[0].ndim
    shape[dim] = keys[0].shape[dim]
    perm = torch.arange(keys[0].shape[dim], device=keys[0].device)
    perm = perm.reshape(shape).expand(keys[0].shape).contiguous()
    for k in keys:
        kp = torch.gather(k, dim, perm)
        step = torch.sort(kp, dim=dim, stable=True).indices
        perm = torch.gather(perm, dim, step)
    return perm


# --------------------------------------------------------------- kernel K2
# Stage wrappers over [S, T(, C)] batches (S independent series, the scan
# along dim 1).  A CPU tensor takes the plain version, a CUDA tensor the
# kernel in csrc/scan.cu, which replaces the scans inside
# cook_tpu/ops/pallas_cycle.py::_kernel.
from . import cuda_lib  # noqa: E402

KERNEL = "scan"
_F32, _U8 = torch.float32, torch.uint8


def _flag_mask(x: torch.Tensor, mflags, mon: int, moff: int):
    if mflags is None:
        return x
    m = ((mflags & mon) == mon) & ((mflags & moff) == 0)
    return x * m.to(x.dtype)[..., None]


def _seg_scan_plain(x, start, mflags=None, mon=0, moff=0):
    return segmented_cumsum(_flag_mask(x, mflags, mon, moff),
                            start != 0, dim=1)


def _seg_count_plain(x, bit, start):
    return segmented_cumsum(((x & bit) != 0).to(torch.int32), start != 0,
                            dim=1)


def _prefix16_plain(x):
    return prefix_sum_xla_cpu(x, dim=1)


def _int_scan_plain(x, bit=0, op="sum", reverse=False, offset=0):
    v = ((x & bit) != 0).to(torch.int32) if x.dtype == torch.uint8 \
        else x.to(torch.int32)
    if reverse:
        v = torch.flip(v, [1])
    if op == "sum":
        v = torch.cumsum(v, 1, dtype=torch.int32)
    else:
        v = torch.cummin(v, 1).values
    if reverse:
        v = torch.flip(v, [1])
    return v + offset


def tree_levels(n: int) -> int:
    """Elements in all levels of the tree scan of one length-n series."""
    total, k = 0, 0
    while (n >> k) >= 1:
        total += n >> k
        k += 1
    return total


def blocked_levels(n: int, block: int = 16) -> int:
    """Elements above level 0 of the blocked scan of one series."""
    total = 0
    while n > block:
        n = (n + block - 1) // block
        total += n
    return total


@cuda_lib.stage(KERNEL, _seg_scan_plain, (_F32, _U8, _U8))
def seg_scan(x, start, mflags=None, mon=0, moff=0):
    """Segmented inclusive scan of ``x * mask`` (f32 [S, T, C], C <= 4)
    in associative_scan's order; segments start where ``start`` (u8
    [S, T]) is set.  ``mflags`` (u8 [S, T]) keeps the rows where
    ``(mflags & mon) == mon`` and ``(mflags & moff) == 0``."""
    S, n, C = x.shape
    cuda_lib.check(start, torch.uint8, (S, n), "start")
    if mflags is not None:
        cuda_lib.check(mflags, torch.uint8, (S, n), "mflags")
    lv_n = S * tree_levels(n)
    lv = torch.empty(lv_n * C, dtype=torch.float32, device=x.device)
    lf = torch.empty(lv_n, dtype=torch.uint8, device=x.device)
    out = torch.empty_like(x)
    cuda_lib.call("k2_seg_f32", KERNEL, x.data_ptr(), start.data_ptr(),
                  cuda_lib.ptr(mflags), mon, moff, out.data_ptr(),
                  lv.data_ptr(), lf.data_ptr(), S, n, C)
    return out


@cuda_lib.stage(KERNEL, _seg_count_plain, (_U8, None, _U8))
def seg_count(x, bit, start):
    """Segmented inclusive count (i32 [S, T]) of rows with ``x & bit``."""
    S, n = x.shape
    cuda_lib.check(start, torch.uint8, (S, n), "start")
    lv_n = S * tree_levels(n)
    lv = torch.empty(lv_n, dtype=torch.int32, device=x.device)
    lf = torch.empty(lv_n, dtype=torch.uint8, device=x.device)
    out = torch.empty((S, n), dtype=torch.int32, device=x.device)
    cuda_lib.call("k2_seg_count", KERNEL, x.data_ptr(), bit,
                  start.data_ptr(), out.data_ptr(), lv.data_ptr(),
                  lf.data_ptr(), S, n)
    return out


@cuda_lib.stage(KERNEL, _prefix16_plain, (_F32,))
def prefix16(x):
    """Inclusive prefix of f32 [S, T, C] along T in jnp.cumsum's XLA:CPU
    order (blocked 16)."""
    S, n, C = x.shape
    scratch = torch.empty(max(S * C * blocked_levels(n), 1),
                          dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    cuda_lib.call("k2_prefix16", KERNEL, x.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), S, n, C)
    return out


@cuda_lib.stage(KERNEL, _int_scan_plain)
def int_scan(x, bit=0, op="sum", reverse=False, offset=0):
    """Inclusive integer scan along T of a u8 bit test (``x & bit``) or
    an i32 array: ``op`` "sum" or "min", optionally back to front, plus
    ``offset``.  Exact in any order."""
    S, n = x.shape
    if x.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"int_scan: u8 or i32, got {x.dtype}")
    cuda_lib.check(x, x.dtype, name="x")
    scratch = torch.empty(S * n + max(S * blocked_levels(n), 1),
                          dtype=torch.int32, device=x.device)
    out = torch.empty((S, n), dtype=torch.int32, device=x.device)
    cuda_lib.call("k2_int_scan", KERNEL, x.data_ptr(),
                  int(x.dtype == torch.uint8), bit,
                  {"sum": 0, "min": 1}[op], int(reverse), offset,
                  out.data_ptr(), scratch.data_ptr(), S, n)
    return out
