"""Kernel K3: the cycle's two stable sorts, as LSD radix sorts on the
card (``csrc/sort.cu``), replacing the lexsorts inside
``cook_tpu/ops/pallas_cycle.py::_kernel``:

* the rank order, ``jnp.lexsort((position, user_rank, sort_dru))``
  (``cook_tpu/ops/dru.py:106``);
* the user-major order, ``jnp.lexsort((pos, user))``
  (``cook_tpu/ops/considerable.py:54``).

The plain versions are :func:`ops.scan.lexsort`.  Both sorts are stable,
so position breaks the remaining ties.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .scan import lexsort

KERNEL = "sort"
_RADIX_BLOCK = 1024


def _sort_rank_plain(dru, rankable, user_rank):
    sort_dru = torch.where(rankable != 0, dru,
                           torch.full_like(dru, float("inf")))
    return lexsort((user_rank, sort_dru), dim=1).to(torch.int32)


def _sort_user_plain(user):
    return lexsort((user,), dim=1).to(torch.int32)


def _scratch(S: int, n: int, device):
    nblk = (n + _RADIX_BLOCK - 1) // _RADIX_BLOCK
    keys = torch.empty(2 * S * n, dtype=torch.int64, device=device)
    vals = torch.empty(2 * S * n, dtype=torch.int32, device=device)
    hist = torch.empty(S * 256 * nblk, dtype=torch.int32, device=device)
    return keys, vals, hist


@cuda_lib.stage(KERNEL, _sort_rank_plain,
                (torch.float32, torch.uint8, torch.int32))
def sort_rank(dru, rankable, user_rank):
    """Rank order i32 [S, T]: stable argsort by (dru where rankable else
    +inf, user_rank).  ``user_rank`` must lie in [-1, T)."""
    S, n = dru.shape
    cuda_lib.check(rankable, torch.uint8, (S, n), "rankable")
    cuda_lib.check(user_rank, torch.int32, (S, n), "user_rank")
    keys, vals, hist = _scratch(S, n, dru.device)
    order = torch.empty((S, n), dtype=torch.int32, device=dru.device)
    cuda_lib.call("k3_sort_rank", KERNEL, dru.data_ptr(),
                  rankable.data_ptr(), user_rank.data_ptr(), n.bit_length(),
                  order.data_ptr(), keys.data_ptr(), vals.data_ptr(),
                  hist.data_ptr(), S, n)
    return order


@cuda_lib.stage(KERNEL, _sort_user_plain, (torch.int32,))
def sort_user(user):
    """User-major permutation i32 [S, T]: stable argsort of ``user``
    (values in [-1, T))."""
    S, n = user.shape
    keys, vals, hist = _scratch(S, n, user.device)
    perm = torch.empty((S, n), dtype=torch.int32, device=user.device)
    cuda_lib.call("k3_sort_user", KERNEL, user.data_ptr(), n.bit_length(),
                  perm.data_ptr(), keys.data_ptr(), vals.data_ptr(),
                  hist.data_ptr(), S, n)
    return perm
