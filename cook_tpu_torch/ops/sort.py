"""Kernel K3: the cycle's two stable sorts, as one-sweep LSD radix sorts
on the card (``csrc/sort.cu``), replacing the lexsorts inside
``cook_tpu/ops/pallas_cycle.py::_kernel``:

* the rank order, ``jnp.lexsort((position, user_rank, sort_dru))``
  (``cook_tpu/ops/dru.py:106``);
* the user-major order, ``jnp.lexsort((pos, user))``
  (``cook_tpu/ops/considerable.py:54``).

The plain versions are :func:`ops.scan.lexsort`.  Both sorts are stable,
so position breaks the remaining ties.  :func:`sort_plan` fixes the
launch geometry (digit width, passes, tiles, scratch); the CUDA source
takes every value from it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_lib
from .scan import float_sort_key, lexsort

KERNEL = "sort"

# The geometry csrc/sort.cu is compiled for (it refuses any other):
# 8-bit digits, 256 threads (one per digit), 16 keys a thread.
DIGIT_BITS = 8
SORT_THREADS = 256
SORT_ITEMS = 16
_WARPS = SORT_THREADS // 32


class SortPlan(NamedTuple):
    """Launch geometry of one K3 call over S series of n keys of
    ``bits`` bits.  ``ctl`` is one int32 buffer, zeroed by one memset a
    call: the digit histogram of every (series, pass), one tile ticket
    per (series, pass), and one status word per (series, pass, tile,
    digit)."""
    S: int
    n: int
    bits: int
    digit_bits: int
    passes: int
    threads: int
    tile: int
    tiles: int
    hist_off: int
    ticket_off: int
    status_off: int
    ctl_words: int
    key_elems: int      # two key buffers (int64) and two value buffers
    smem_bytes: int     # dynamic shared memory of one pass CTA
    launches: int       # CUDA launches a call: memset, upfront, passes


def sort_plan(S: int, n: int, bits: int) -> SortPlan:
    if not 1 <= n < 1 << 30:
        raise ValueError(f"K3 sorts 1 <= n < 2^30 keys a series, got {n}")
    if not 1 <= bits <= 63:
        raise ValueError(f"K3 keys have 1..63 bits, got {bits}")
    digits = 1 << DIGIT_BITS
    passes = -(-bits // DIGIT_BITS)
    tile = SORT_THREADS * SORT_ITEMS
    tiles = -(-n // tile)
    hist = S * passes * digits
    tickets = S * passes
    status = S * passes * tiles * digits
    smem = tile * 12 + (_WARPS * digits + 2 * digits + _WARPS) * 4
    return SortPlan(S=S, n=n, bits=bits, digit_bits=DIGIT_BITS,
                    passes=passes, threads=SORT_THREADS, tile=tile,
                    tiles=tiles, hist_off=0, ticket_off=hist,
                    status_off=hist + tickets,
                    ctl_words=hist + tickets + status, key_elems=2 * S * n,
                    smem_bytes=smem, launches=2 + passes)


def rank_bits(n: int) -> int:
    """Key bits of the rank sort: 32 float bits over bit_length(n)."""
    return 32 + n.bit_length()


def rank_key_plain(dru, rankable, user_rank):
    """The rank sort's packed int64 key, ``(float key of sort_dru) <<
    bit_length(T) | (user_rank + 1)``: a stable sort of it is the rank
    order.  The yardstick ``torch.sort`` sorts this key."""
    ubits = dru.shape[-1].bit_length()
    sort_dru = torch.where(rankable != 0, dru,
                           torch.full_like(dru, float("inf")))
    return (float_sort_key(sort_dru) << ubits) | (user_rank.to(torch.int64)
                                                  + 1)


def _sort_rank_plain(dru, rankable, user_rank):
    sort_dru = torch.where(rankable != 0, dru,
                           torch.full_like(dru, float("inf")))
    return lexsort((user_rank, sort_dru), dim=1).to(torch.int32)


def _sort_user_plain(user):
    return lexsort((user,), dim=1).to(torch.int32)


def _launch(name, inputs, ubits, S, n, bits, device):
    plan = sort_plan(S, n, bits)
    keys = torch.empty(plan.key_elems, dtype=torch.int64, device=device)
    vals = torch.empty(plan.key_elems, dtype=torch.int32, device=device)
    ctl = torch.empty(plan.ctl_words, dtype=torch.int32, device=device)
    out = torch.empty((S, n), dtype=torch.int32, device=device)
    cuda_lib.call(name, KERNEL, *inputs, ubits, out.data_ptr(),
                  keys.data_ptr(), vals.data_ptr(), ctl.data_ptr(), S, n,
                  plan.digit_bits, plan.threads, plan.tile, plan.passes,
                  plan.tiles, plan.ctl_words, plan.hist_off, plan.ticket_off,
                  plan.status_off, plan.smem_bytes)
    return out


@cuda_lib.stage(KERNEL, _sort_rank_plain,
                (torch.float32, torch.uint8, torch.int32))
def sort_rank(dru, rankable, user_rank):
    """Rank order i32 [S, T]: stable argsort by (dru where rankable else
    +inf, user_rank).  ``user_rank`` must lie in [-1, T)."""
    S, n = dru.shape
    cuda_lib.check(rankable, torch.uint8, (S, n), "rankable")
    cuda_lib.check(user_rank, torch.int32, (S, n), "user_rank")
    return _launch("k3_sort_rank", (dru.data_ptr(), rankable.data_ptr(),
                                    user_rank.data_ptr()),
                   n.bit_length(), S, n, rank_bits(n), dru.device)


@cuda_lib.stage(KERNEL, _sort_user_plain, (torch.int32,))
def sort_user(user):
    """User-major permutation i32 [S, T]: stable argsort of ``user``
    (values in [-1, T))."""
    S, n = user.shape
    return _launch("k3_sort_user", (user.data_ptr(),), n.bit_length(), S, n,
                   n.bit_length(), user.device)
