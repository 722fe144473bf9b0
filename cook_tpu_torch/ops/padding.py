"""Bucketed padding so per-cycle dynamic sizes hit a small set of shapes
(a copy of ``cook_tpu/ops/padding.py``).  Kernels here are not compiled
per shape, but the buckets keep the wire identical to the reference's.
:func:`take` reads a gather as JAX does."""

from __future__ import annotations

import numpy as np
import torch

MIN_BUCKET = 64


def bucket(n: int, minimum: int = MIN_BUCKET) -> int:
    """Smallest power-of-two bucket >= max(n, 1)."""
    size = minimum
    n = max(n, 1)
    while size < n:
        size *= 2
    return size


def pad_to(arr, size: int, fill=0):
    """Pad a numpy array's leading axis up to ``size`` with ``fill``."""
    if arr.shape[0] == size:
        return arr
    pad_shape = (size - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)],
                          axis=0)


def take(x, idx):
    """``x[idx]`` along dim 0 as a JAX gather reads it: negative indices
    wrap once, then every index is clamped into range (torch raises, or
    asserts on the card, where JAX clamps)."""
    n = x.shape[0]
    i = torch.where(idx < 0, idx + n, idx)
    return x[torch.clamp(i, 0, n - 1).long()]
