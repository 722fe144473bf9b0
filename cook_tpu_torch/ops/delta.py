"""Device-resident cycle state (``cook_tpu/ops/delta.py``): the wire
flag bits, the delta scatter into the resident rows/flags buffers and
the device base mirror.

The resident wire keeps the pack's per-cycle ``rows``/``flags`` arrays
on the card across cycles.  Each cycle the caller diffs the fresh host
arrays against its host shadow (:func:`pack_diff`) and scatters just the
changed positions (:class:`PackDeltaApplier`) instead of uploading the
whole [P, T] wire.

A delta batch is padded to a power-of-two bucket with the out-of-bounds
sentinel ``n_flat``.  The reference drops those entries with
``mode="drop"``; PyTorch has no such mode, so every resident buffer
carries one trailing dump element (``n_flat + 1`` elements, the [P, T]
view is the first ``n_flat``) and the sentinel writes land there.  The
padded shape is fixed and ``commit`` never reads ``k`` back from the
card.

A scatter batch travels as one blob (indices, values, flags) from
pinned memory with ``non_blocking=True``.  Every ``stage`` allocates a
fresh pinned buffer, as the reference allocates fresh host buffers:
PyTorch's pinned allocator keeps a block until the copies that read it
have completed, so no buffer an in-flight copy reads is ever rewritten.
Full uploads, needed at once, are synchronous copies.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import quant, telemetry
from .padding import bucket

FLAG_PENDING = 1
FLAG_VALID = 2
FLAG_ENQUEUE_OK = 4
FLAG_LAUNCH_OK = 8
FLAG_USER_FIRST = 16   # first row of a user segment

# delta batches are padded to power-of-two buckets of at least this size
_DELTA_MIN_BUCKET = 256
# base-mirror appends are padded to buckets of at least this many rows
_MIRROR_MIN_BUCKET = 1024

_VALUE_DTYPES = {quant.ROWS_WIDE: torch.int32, quant.ROWS_I16: torch.int16,
                 quant.ROWS_I8: torch.int8}


def pack_flags(pending: np.ndarray, valid: np.ndarray,
               is_first: np.ndarray, enqueue_ok=None,
               launch_ok=None) -> np.ndarray:
    """The wire flags byte.  ``enqueue_ok``/``launch_ok`` default to
    all-accept when omitted."""
    flags = (pending.astype(np.uint8) * FLAG_PENDING
             + valid.astype(np.uint8) * FLAG_VALID
             + is_first.astype(np.uint8) * FLAG_USER_FIRST)
    if enqueue_ok is not None:
        flags += enqueue_ok.astype(np.uint8) * FLAG_ENQUEUE_OK
    if launch_ok is not None:
        flags += launch_ok.astype(np.uint8) * FLAG_LAUNCH_OK
    return flags


def pack_diff(rows_old: np.ndarray, rows_new: np.ndarray,
              flags_old: np.ndarray, flags_new: np.ndarray) -> np.ndarray:
    """Flat positions (i32) where (rows, flags) differ: the resident
    pack's scatter batch (``cook_tpu/native/pack.py:77-95``, its numpy
    branch).  Inputs are same-shape i32 / u8 arrays, compared raveled."""
    ro = np.ascontiguousarray(rows_old, dtype=np.int32).ravel()
    rn = np.ascontiguousarray(rows_new, dtype=np.int32).ravel()
    fo = np.ascontiguousarray(flags_old, dtype=np.uint8).ravel()
    fn = np.ascontiguousarray(flags_new, dtype=np.uint8).ravel()
    return np.flatnonzero((ro != rn) | (fo != fn)).astype(np.int32)


def _host(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` as a host tensor a copy to ``dev`` may read: a fresh pinned
    buffer for the card, ``a`` itself for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dev.type == "cpu" else t.pin_memory()


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev``, by an asynchronous copy from pinned memory on
    the card."""
    return _host(a, dev).to(dev, non_blocking=True)


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (
        dev.index is None or t.device.index == dev.index)


def resident_buffer(a: np.ndarray, dev: torch.device,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A flat resident buffer of ``a.size + 1`` elements holding ``a``
    raveled and one trailing dump element: ``out`` rewritten in place,
    or a new device buffer.  The copy is synchronous (a full upload is
    needed at once); only the scatter batches travel asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
    if out is None:
        out = torch.empty(a.size + 1, dtype=t.dtype, device=dev)
        out[-1:].zero_()
    elif out.dtype != t.dtype or out.numel() != a.size + 1:
        raise ValueError(f"resident buffer: want {t.dtype}[{a.size + 1}], "
                         f"got {out.dtype}[{out.numel()}]")
    out[:-1].copy_(t)
    return out


class StagedDelta(NamedTuple):
    """One staged scatter batch: the padded device tensors whose copies
    started at :meth:`PackDeltaApplier.stage` time."""

    shape: Tuple[int, ...]
    kb: int
    codec: int
    idx: torch.Tensor      # i32[kb] flat positions, sentinel n_flat pads
    vals: torch.Tensor     # i8 | i16 | i32 [kb] by codec
    flags: torch.Tensor    # u8[kb]
    nbytes: int


class PackDeltaApplier:
    """Scatter delta batches into the resident rows/flags buffers in
    place.

    With ``quantize`` the row values travel as deltas against their own
    position in the row (``idx % T``): i8 when every delta of the batch
    fits [-128, 127], i16 when it fits [-32768, 32767], else wide i32.
    ``commit`` decodes them on the card in i32."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def stage(self, shape: Tuple[int, ...], idx: np.ndarray,
              rows_vals: np.ndarray, flags_vals: np.ndarray,
              quantize: bool = False) -> StagedDelta:
        """Pad, negotiate the value codec and start the copies of one
        delta batch; raises when ``k`` exceeds the buffer or an index
        lies outside it."""
        n_flat = int(np.prod(shape))
        T = int(shape[-1])
        k = int(idx.size)
        kb = min(bucket(max(k, 1), minimum=_DELTA_MIN_BUCKET), n_flat)
        if kb < k:
            raise ValueError(f"delta larger than buffer ({k} > {n_flat})")
        if k and (int(idx.min()) < 0 or int(idx.max()) >= n_flat):
            raise ValueError(f"delta index outside [0, {n_flat})")
        idx_p = np.full(kb, n_flat, dtype=np.int32)
        idx_p[:k] = idx
        codec, dt = quant.ROWS_WIDE, np.int32
        vals = np.asarray(rows_vals)
        if quantize and k:
            delta = vals.astype(np.int64) - (idx.astype(np.int64) % T)
            lo, hi = int(delta.min()), int(delta.max())
            if -128 <= lo and hi <= 127:
                codec, dt, vals = quant.ROWS_I8, np.int8, delta
            elif -32768 <= lo and hi <= 32767:
                codec, dt, vals = quant.ROWS_I16, np.int16, delta
            else:
                telemetry.count("quant.wide.delta")
        # one blob, one pinned buffer and one copy: idx, values, flags
        vb = np.dtype(dt).itemsize
        blob = np.zeros(kb * (4 + vb + 1), dtype=np.uint8)
        blob[:4 * kb].view(np.int32)[:] = idx_p
        blob[4 * kb:(4 + vb) * kb].view(dt)[:k] = vals.astype(dt)
        blob[(4 + vb) * kb:][:k] = flags_vals
        telemetry.count("transfer.h2d", blob.nbytes)
        on = upload(blob, self.device)
        return StagedDelta(tuple(shape), kb, codec,
                           on[:4 * kb].view(torch.int32),
                           on[4 * kb:(4 + vb) * kb].view(_VALUE_DTYPES[codec]),
                           on[(4 + vb) * kb:], blob.nbytes)

    def commit(self, rows_buf: torch.Tensor, flags_buf: torch.Tensor,
               st: StagedDelta) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scatter a staged batch into the flat resident buffers
        (``n_flat + 1`` elements each) in place; returns them."""
        n_flat = int(np.prod(st.shape))
        T = int(st.shape[-1])
        for buf, dt, name in ((rows_buf, torch.int32, "rows"),
                              (flags_buf, torch.uint8, "flags")):
            if (buf.dtype != dt or buf.ndim != 1 or buf.numel() != n_flat + 1
                    or not _on(buf, self.device)):
                raise ValueError(
                    f"{name} buffer: want {dt}[{n_flat + 1}] on "
                    f"{self.device}, got {buf.dtype}{tuple(buf.shape)} on "
                    f"{buf.device}")
        for t, dt, name in ((st.idx, torch.int32, "idx"),
                            (st.vals, _VALUE_DTYPES[st.codec], "values"),
                            (st.flags, torch.uint8, "flags")):
            if t.dtype != dt or tuple(t.shape) != (st.kb,) \
                    or not _on(t, self.device):
                raise ValueError(f"delta {name}: want {dt}[{st.kb}] on "
                                 f"{self.device}, got {t.dtype}"
                                 f"{tuple(t.shape)} on {t.device}")
        idx = st.idx.long()
        vals = st.vals.to(torch.int32)
        if st.codec != quant.ROWS_WIDE:
            vals = vals + st.idx % T
        rows_buf.index_copy_(0, idx, vals)
        flags_buf.index_copy_(0, idx, st.flags)
        return rows_buf, flags_buf

    def apply(self, rows_buf, flags_buf, shape, idx, rows_vals, flags_vals,
              quantize: bool = False):
        """Stage then commit one batch of flat positions into the flat
        buffers of a resident [``shape``] wire."""
        st = self.stage(shape, idx, rows_vals, flags_vals, quantize=quantize)
        return self.commit(rows_buf, flags_buf, st)


class DeviceBaseMirror:
    """Device mirror of the columnar index's res/disk base columns.
    Rows are append-only while the compaction epoch is unchanged, so a
    steady-state sync uploads only the new rows as one bucketed chunk;
    a compaction epoch change or a capacity overflow uploads it all."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._key: Optional[int] = None   # compaction epoch mirrored
        self._n = 0                       # rows synced
        self._cap = 0                     # device buffer capacity
        self._res: Optional[torch.Tensor] = None    # f32[cap, 4]
        self._disk: Optional[torch.Tensor] = None   # f32[cap]
        self.last_sync = None             # "full", "append" or None

    @property
    def capacity(self) -> int:
        return self._cap

    def sync(self, res_base: np.ndarray, disk_base: np.ndarray,
             compactions: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bring the mirror up to the snapshot; returns the
        capacity-padded (res, disk) device tensors."""
        n = res_base.shape[0]
        full = self._key != compactions or n > self._cap
        self.last_sync = None
        if not full and n > self._n:
            k = n - self._n
            kb = bucket(k, minimum=_MIRROR_MIN_BUCKET)
            if self._n + kb > self._cap:
                full = True
            else:
                chunk = np.zeros((kb, 4), dtype=np.float32)
                chunk[:k] = res_base[self._n:n]
                dchunk = np.zeros(kb, dtype=np.float32)
                dchunk[:k] = disk_base[self._n:n]
                telemetry.count("transfer.h2d", chunk.nbytes + dchunk.nbytes)
                self._res.narrow(0, self._n, kb).copy_(
                    _host(chunk, self.device), non_blocking=True)
                self._disk.narrow(0, self._n, kb).copy_(
                    _host(dchunk, self.device), non_blocking=True)
                self._n = n
                self.last_sync = "append"
        if full:
            cap = bucket(n, minimum=_MIRROR_MIN_BUCKET)
            res_p = np.zeros((cap, 4), dtype=np.float32)
            res_p[:n] = res_base
            disk_p = np.zeros(cap, dtype=np.float32)
            disk_p[:n] = disk_base
            telemetry.count("transfer.h2d", res_p.nbytes + disk_p.nbytes)
            self._res = upload(res_p, self.device)
            self._disk = upload(disk_p, self.device)
            self._key, self._n, self._cap = compactions, n, cap
            self.last_sync = "full"
        return self._res, self._disk
