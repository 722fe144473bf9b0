"""Wire negotiation of the fused driver's megakernel staging
(``cook_tpu/sched/fused.py`` ``_stage_mega`` :1641-1750) as a function:
from one dispatch group's stacked host arrays to the ``MegaCycleWire``
the port's ``megacycle`` takes, and the resident wire
(``_ResidentPack`` :179-197, ``_sync_resident`` :487-587).

* rows: delta-coded i8/i16 when every delta fits, negotiated over an
  identity-padded copy (a zero-padded tail would read as delta -t);
  with the resident wire the device buffers go in as wide rows and cost
  no upload;
* avail / capacity: u16 fixed point with per-column power-of-two scales,
  sticky across cycles through the caller's ``scales`` dict, or wide;
* host_gpu / host_blocked: bitpacked, 8 hosts a byte;
* gang arrays padded across the group (no-op rows for gang-free pools).

Every codec is lossless or wide.  The driver comes in a later slice of
the port.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import pallas_cycle, quant, telemetry
from ..ops.delta import PackDeltaApplier, pack_diff, resident_buffer
from ..ops.gang import GangWire
from ..ops.padding import bucket


def negotiate_rows(rows_p: np.ndarray, n_tasks: List[int]
                   ) -> quant.QuantizedRows:
    """The narrowest exact rows codec, over an identity-padded copy:
    padding rows are masked downstream, so their identity deltas are
    inert and the real rows decide the width."""
    P, T = rows_p.shape
    rows_q = rows_p.copy()
    iota = np.arange(T, dtype=rows_q.dtype)
    for i in range(P):
        n = n_tasks[i] if i < len(n_tasks) else 0
        rows_q[i, n:] = iota[n:]
    return quant.quantize_rows(rows_q)


def quantize_hosts(avail_p: np.ndarray, cap_p: np.ndarray,
                   scales: Dict[str, tuple]):
    """avail / capacity in u16 fixed point with sticky scales, or wide."""
    qa = quant.quantize_fixed(avail_p, prefer=scales.get("avail"))
    qc = quant.quantize_fixed(cap_p, prefer=scales.get("capacity"))
    if qa.scale != 0.0:
        scales["avail"] = qa.scale
    if qc.scale != 0.0:
        scales["capacity"] = qc.scale
    return qa, qc


def pack_host_bits(host_gpu_p: np.ndarray,
                   host_blocked_p: np.ndarray) -> np.ndarray:
    return np.stack([quant.pack_bits(host_gpu_p),
                     quant.pack_bits(host_blocked_p)], axis=1)


def pad_gangs(gang_wires: List[Optional[GangWire]], P: int, T: int, H: int):
    """(gang_id, gang_size, gang_attr, host_topo) padded across the
    group: gang-free pools get no-op rows."""
    if not any(w is not None for w in gang_wires):
        return pallas_cycle.empty_gang_wire(P, T, H)
    G = bucket(max(len(w.gang_size) for w in gang_wires
                   if w is not None), minimum=8)
    A = bucket(max(w.host_topo.shape[0] for w in gang_wires
                   if w is not None), minimum=1)
    gang_id = np.full((P, T), -1, dtype=np.int32)
    gang_size = np.full((P, G), 2 ** 30, dtype=np.int32)
    gang_attr = np.zeros((P, G), dtype=np.int32)
    host_topo = np.full((P, A, H), -1, dtype=np.int32)
    host_topo[:, 0, :] = 0
    for i, w in enumerate(gang_wires):
        if w is None:
            continue
        gang_id[i, :w.gang_id.shape[0]] = w.gang_id
        gang_size[i, :w.gang_size.shape[0]] = w.gang_size
        gang_attr[i, :w.gang_attr.shape[0]] = w.gang_attr
        a, hh = w.host_topo.shape
        host_topo[i, :a, :hh] = w.host_topo
    return gang_id, gang_size, gang_attr, host_topo


def stage_mega_wire(*, rows_p: np.ndarray, flags_p: np.ndarray,
                    n_tasks: List[int], res_base: torch.Tensor,
                    disk_base: torch.Tensor, tokens_u_p: np.ndarray,
                    shares_u_p: np.ndarray, quota_u_p: np.ndarray,
                    scalars: Dict[str, np.ndarray], host_gpu_p: np.ndarray,
                    host_blocked_p: np.ndarray, exc_rows_p: np.ndarray,
                    exc_mask_p: np.ndarray, avail_p: np.ndarray,
                    cap_p: np.ndarray,
                    gang_wires: List[Optional[GangWire]],
                    quantize: bool = True,
                    scales: Optional[Dict[str, tuple]] = None,
                    rows_dev: Optional[torch.Tensor] = None,
                    flags_dev: Optional[torch.Tensor] = None,
                    resident: bool = False,
                    device="cuda") -> dict:
    """Negotiate and upload one group's wire.  ``res_base``/``disk_base``
    are the device base mirror; ``scalars`` holds ``num_considerable``,
    ``pool_quota``, ``group_quota`` and ``group_id``.

    ``resident``: ``rows_dev``/``flags_dev`` are the resident [P, T]
    buffers (already synced, :func:`sync_resident`); they go in as wide
    rows and add nothing to ``h2d_bytes``.  Without ``quantize``, given
    device buffers are used as they are (their bytes counted, as the
    reference counts them); otherwise rows and flags are uploaded.
    Returns ``{"wire", "rows_codec", "avail_scale", "cap_scale",
    "h2d_bytes"}``."""
    dev = resolve_device(device)
    P, T = rows_p.shape
    H = avail_p.shape[1]
    scales = {} if scales is None else scales
    h2d = 0
    rows_codec = quant.ROWS_WIDE
    w_rows = w_flags = None
    if resident:
        if rows_dev is None or flags_dev is None:
            raise ValueError("resident staging needs rows_dev and flags_dev")
        w_rows, w_flags = rows_dev, flags_dev
    elif quantize:
        qr = negotiate_rows(rows_p, n_tasks)
        rows_codec, rows_host = qr.codec, qr.data
        h2d += rows_host.nbytes + flags_p.nbytes
    else:
        rows_host = rows_p.astype(np.int32)
        if rows_dev is not None:
            w_rows = rows_dev
        if flags_dev is not None:
            w_flags = flags_dev
        h2d += rows_p.nbytes + flags_p.nbytes
    avail_scale = cap_scale = 0.0
    if quantize:
        qa, qc = quantize_hosts(avail_p, cap_p, scales)
        avail_scale, cap_scale = qa.scale, qc.scale
        w_avail, w_cap = qa.data, qc.data
    else:
        w_avail = avail_p.astype(np.float32)
        w_cap = cap_p.astype(np.float32)
    h2d += w_avail.nbytes + w_cap.nbytes
    host_bits = pack_host_bits(host_gpu_p, host_blocked_p)
    h2d += (host_bits.nbytes + exc_rows_p.nbytes + exc_mask_p.nbytes
            + tokens_u_p.nbytes + shares_u_p.nbytes + quota_u_p.nbytes)
    gang_id, gang_size, gang_attr, host_topo = pad_gangs(gang_wires, P, T, H)
    h2d += (gang_id.nbytes + gang_size.nbytes + gang_attr.nbytes
            + host_topo.nbytes)
    empty = np.zeros((0,), np.uint8)
    fields = dict(
        rows=rows_host if w_rows is None else empty,
        flags=flags_p if w_flags is None else empty, tokens_u=tokens_u_p,
        shares_u=shares_u_p, quota_u=quota_u_p, host_bits=host_bits,
        exc_rows=exc_rows_p, exc_mask=exc_mask_p, avail=w_avail,
        capacity=w_cap, gang_id=gang_id, gang_size=gang_size,
        gang_attr=gang_attr, host_topo=host_topo,
        res_base=np.zeros((0, 4), np.float32),
        disk_base=np.zeros((0,), np.float32), **scalars)
    wire = pallas_cycle.wire_from_numpy(fields, dev)
    wire = wire._replace(res_base=res_base.to(dev),
                         disk_base=disk_base.to(dev))
    if w_rows is not None:
        wire = wire._replace(rows=w_rows.to(dev))
    if w_flags is not None:
        wire = wire._replace(flags=w_flags.to(dev))
    return {"wire": wire, "rows_codec": rows_codec,
            "avail_scale": avail_scale, "cap_scale": cap_scale,
            "h2d_bytes": int(h2d)}


class ResidentPack:
    """One DRU-mode group's resident wire arrays: the flat rows / flags
    buffers on the device (``n_flat + 1`` elements, the last one the
    scatter's dump slot) and the host shadow the per-cycle diff runs
    against.  ``key`` pins the group composition and bucket shape;
    ``epoch`` the index compaction epoch the row ids are valid in."""

    __slots__ = ("key", "epoch", "shape", "rows_buf", "flags_buf",
                 "rows_host", "flags_host")

    def __init__(self, key, epoch, shape, rows_buf, flags_buf, rows_host,
                 flags_host):
        self.key = key
        self.epoch = epoch
        self.shape = shape
        self.rows_buf = rows_buf
        self.flags_buf = flags_buf
        self.rows_host = rows_host
        self.flags_host = flags_host

    @property
    def rows_dev(self) -> torch.Tensor:
        """The i32 [P, T] view of the rows buffer."""
        return self.rows_buf[:-1].view(self.shape)

    @property
    def flags_dev(self) -> torch.Tensor:
        """The u8 [P, T] view of the flags buffer."""
        return self.flags_buf[:-1].view(self.shape)


class ResidentSync(NamedTuple):
    """What one :func:`sync_resident` did.  ``reason``: ``delta``,
    ``empty``, or the repack's (:data:`REPACK_REASONS`); ``k``: the
    positions that differ from the shadow (0 where no diff was taken);
    ``h2d_bytes``: the scatter batch's or the full upload's bytes."""

    rows_dev: torch.Tensor   # i32[P, T]
    flags_dev: torch.Tensor  # u8[P, T]
    reason: str
    k: int
    h2d_bytes: int


REPACK_REASONS = ("cold", "shape", "compaction", "oversize")


def sync_resident(packs: Dict[bool, ResidentPack], gpu_mode: bool, key: Tuple,
                  rows_p: np.ndarray, flags_p: np.ndarray, epoch: int, *,
                  applier: PackDeltaApplier,
                  quantize: bool = True) -> ResidentSync:
    """Bring the resident [P, T] rows/flags buffers of ``packs[gpu_mode]``
    up to the freshly staged host arrays, which become the new host
    shadow (the caller must not change them afterwards).

    A first sync (``cold``), a new group or bucket shape (``shape``) or a
    new compaction epoch (``compaction``) uploads it all.  Otherwise the
    diff against the shadow is scattered (``delta``); no change returns
    the buffers untouched (``empty``); a diff of more than half the
    positions uploads it all (``oversize``).  A repack of an unchanged
    [P, T] shape rewrites the buffers in place.  A failed diff, copy or
    scatter raises: there is no repack on a fault.  Repacks are counted
    by reason (``resident.repack.<reason>``) and delta rows
    (``resident.delta_rows``) in ``ops.telemetry``."""
    st = packs.get(gpu_mode)
    reason, k = None, 0
    if st is None:
        reason = "cold"
    elif st.key != key:
        reason = "shape"
    elif st.epoch != epoch:
        reason = "compaction"
    if reason is None:
        idx = pack_diff(st.rows_host, rows_p, st.flags_host, flags_p)
        k = int(idx.size)
        if k == 0:
            return ResidentSync(st.rows_dev, st.flags_dev, "empty", 0, 0)
        # a scatter row costs about 9 bytes against about 5 for the full
        # upload: past half the table the repack is the cheaper transfer
        if 2 * k > rows_p.size:
            reason = "oversize"
        else:
            staged = applier.stage(tuple(rows_p.shape), idx,
                                   rows_p.reshape(-1)[idx],
                                   flags_p.reshape(-1)[idx],
                                   quantize=quantize)
            applier.commit(st.rows_buf, st.flags_buf, staged)
            telemetry.count("resident.delta_rows", k)
            st.rows_host, st.flags_host = rows_p, flags_p
            return ResidentSync(st.rows_dev, st.flags_dev, "delta", k,
                                staged.nbytes)
    telemetry.count(f"resident.repack.{reason}")
    nbytes = rows_p.nbytes + flags_p.nbytes
    telemetry.count("transfer.h2d", nbytes)
    dev = applier.device
    # a repack of the same shape rewrites the buffers in place
    same = st is not None and st.shape == tuple(rows_p.shape)
    rows_buf = resident_buffer(rows_p.astype(np.int32, copy=False), dev,
                               out=st.rows_buf if same else None)
    flags_buf = resident_buffer(flags_p.astype(np.uint8, copy=False), dev,
                                out=st.flags_buf if same else None)
    st = packs[gpu_mode] = ResidentPack(key, epoch, tuple(rows_p.shape),
                                        rows_buf, flags_buf, rows_p, flags_p)
    return ResidentSync(st.rows_dev, st.flags_dev, reason, k, nbytes)
