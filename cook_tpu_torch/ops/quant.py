"""Quantized compact wire: the host codecs (copied from
``cook_tpu/ops/quant.py``) and the plain PyTorch versions of its device
decodes.  On the card the decodes run inside the K1 expand kernel
(``ops/expand.py``); these plain versions are what it is held against.

Every codec is lossless or wide: a narrow form is chosen only when the
round trip is exact, so "quantized" never means "approximate"."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

ROWS_WIDE = 0    # i32 absolute rows, no transform
ROWS_I16 = 1     # int16 delta vs position
ROWS_I8 = 2      # int8 delta vs position

_FIXED_SCALES = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class QuantizedRows(NamedTuple):
    codec: int
    data: np.ndarray

    @property
    def nbytes(self) -> int:
        return self.data.nbytes


class QuantizedFixed(NamedTuple):
    """u16 fixed point with a per-trailing-column tuple of power-of-two
    scales, or the wide f32 form (``scale == 0.0``)."""

    scale: object
    data: np.ndarray

    @property
    def nbytes(self) -> int:
        return self.data.nbytes


def quantize_rows(rows: np.ndarray) -> QuantizedRows:
    """Narrowest exact delta-from-position coding of a rows permutation
    (position runs along the last axis)."""
    rows = np.asarray(rows, dtype=np.int64)
    iota = np.arange(rows.shape[-1], dtype=np.int64)
    delta = rows - iota
    lo, hi = (int(delta.min()), int(delta.max())) if delta.size else (0, 0)
    if -128 <= lo and hi <= 127:
        return QuantizedRows(ROWS_I8, delta.astype(np.int8))
    if -32768 <= lo and hi <= 32767:
        return QuantizedRows(ROWS_I16, delta.astype(np.int16))
    return QuantizedRows(ROWS_WIDE, rows.astype(np.int32))


def expand_rows(q: QuantizedRows) -> np.ndarray:
    if q.codec == ROWS_WIDE:
        return np.asarray(q.data, dtype=np.int32)
    iota = np.arange(q.data.shape[-1], dtype=np.int32)
    return q.data.astype(np.int32) + iota


def quantize_fixed(x: np.ndarray, prefer=None) -> QuantizedFixed:
    """Exact u16 fixed-point coding per trailing column, or wide.
    ``prefer`` (a scale tuple negotiated earlier) is reused while it still
    round-trips, so the scales stay put from cycle to cycle."""
    x = np.asarray(x, dtype=np.float32)
    finite = np.isfinite(x)
    if not finite.all() or (x < 0).any() or x.ndim == 0:
        return QuantizedFixed(0.0, x)
    if isinstance(prefer, tuple) and len(prefer) == x.shape[-1]:
        sv = np.asarray(prefer, dtype=np.float32)
        q = np.round(x / sv)
        if (q <= 65535).all() and (q.astype(np.float32) * sv == x).all():
            return QuantizedFixed(tuple(prefer), q.astype(np.uint16))
    scales = []
    for c in range(x.shape[-1]):
        col = x[..., c]
        for s in _FIXED_SCALES:
            q = np.round(col / np.float32(s))
            if (q <= 65535).all() and \
                    (q.astype(np.float32) * np.float32(s) == col).all():
                scales.append(float(s))
                break
        else:
            return QuantizedFixed(0.0, x)
    sv = np.asarray(scales, dtype=np.float32)
    return QuantizedFixed(tuple(scales), np.round(x / sv).astype(np.uint16))


def expand_fixed(q: QuantizedFixed) -> np.ndarray:
    if q.scale == 0.0:
        return np.asarray(q.data, dtype=np.float32)
    return q.data.astype(np.float32) * np.asarray(q.scale, dtype=np.float32)


def pack_bits(x: np.ndarray) -> np.ndarray:
    """Bitpack a bool array along its last axis (8 entries/byte, MSB
    first)."""
    return np.packbits(np.asarray(x, dtype=bool), axis=-1)


def unpack_bits(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(packed, axis=-1, count=n).astype(bool)


# ------------------------------------------------------------ plain decodes
def expand_rows_device(codec: int, data: torch.Tensor) -> torch.Tensor:
    """rows = delta + position for the narrow codecs (position along the
    last axis), identity for wide."""
    if codec == ROWS_WIDE:
        return data.to(torch.int32)
    iota = torch.arange(data.shape[-1], dtype=torch.int32, device=data.device)
    return data.to(torch.int32) + iota


def expand_fixed_device(scale, data: torch.Tensor) -> torch.Tensor:
    """u16 fixed point -> f32, column c times ``scale[c]`` (exact: the
    scales are powers of two); ``scale == 0.0`` passes f32 through."""
    if scale == 0.0:
        return data.to(torch.float32)
    if data.dtype == torch.uint16:   # widen through int16: few u16 kernels
        data = data.view(torch.int16).to(torch.int32) & 0xFFFF
    f = data.to(torch.float32)
    return torch.stack([f[..., c] * float(s) for c, s in enumerate(scale)],
                       dim=-1)


def unpack_bits_device(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Bit unpack along the last axis, MSB first (numpy's packbits
    order); returns bool[..., n]."""
    p32 = packed.to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (p32[..., :, None] >> (7 - shifts)) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return flat[..., :n] != 0
