"""Wire negotiation of the fused driver's megakernel staging
(``cook_tpu/sched/fused.py`` ``_stage_mega`` :1641-1750) as a function:
from one dispatch group's stacked host arrays to the ``MegaCycleWire``
the port's ``megacycle`` takes.

* rows: delta-coded i8/i16 when every delta fits, negotiated over an
  identity-padded copy (a zero-padded tail would read as delta -t);
* avail / capacity: u16 fixed point with per-column power-of-two scales,
  sticky across cycles through the caller's ``scales`` dict, or wide;
* host_gpu / host_blocked: bitpacked, 8 hosts a byte;
* gang arrays padded across the group (no-op rows for gang-free pools).

Every codec is lossless or wide.  The driver, the resident buffers and
the delta scatter come in later slices of the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ops import pallas_cycle, quant
from ..ops.gang import GangWire
from ..ops.padding import bucket


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
                    device="cuda") -> dict:
    """Negotiate and upload one group's wire.  ``res_base``/``disk_base``
    are the device base mirror; ``scalars`` holds ``num_considerable``,
    ``pool_quota``, ``group_quota`` and ``group_id``.  Returns
    ``{"wire", "rows_codec", "avail_scale", "cap_scale", "h2d_bytes"}``."""
    dev = resolve_device(device)
    P, T = rows_p.shape
    H = avail_p.shape[1]
    scales = {} if scales is None else scales
    h2d = 0
    rows_codec = quant.ROWS_WIDE
    if quantize:
        rows_q = rows_p.copy()
        iota = np.arange(T, dtype=rows_q.dtype)
        for i in range(P):
            n = n_tasks[i] if i < len(n_tasks) else 0
            rows_q[i, n:] = iota[n:]
        qr = quant.quantize_rows(rows_q)
        rows_codec, w_rows = qr.codec, qr.data
    else:
        w_rows = rows_p.astype(np.int32)
    h2d += w_rows.nbytes + flags_p.nbytes
    avail_scale = cap_scale = 0.0
    if quantize:
        qa = quant.quantize_fixed(avail_p, prefer=scales.get("avail"))
        qc = quant.quantize_fixed(cap_p, prefer=scales.get("capacity"))
        avail_scale, cap_scale = qa.scale, qc.scale
        if qa.scale != 0.0:
            scales["avail"] = qa.scale
        if qc.scale != 0.0:
            scales["capacity"] = qc.scale
        w_avail, w_cap = qa.data, qc.data
    else:
        w_avail = avail_p.astype(np.float32)
        w_cap = cap_p.astype(np.float32)
    h2d += w_avail.nbytes + w_cap.nbytes
    host_bits = np.stack([quant.pack_bits(host_gpu_p),
                          quant.pack_bits(host_blocked_p)], axis=1)
    h2d += (host_bits.nbytes + exc_rows_p.nbytes + exc_mask_p.nbytes
            + tokens_u_p.nbytes + shares_u_p.nbytes + quota_u_p.nbytes)
    if any(w is not None for w in gang_wires):
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
    else:
        gang_id, gang_size, gang_attr, host_topo = \
            pallas_cycle.empty_gang_wire(P, T, H)
    h2d += (gang_id.nbytes + gang_size.nbytes + gang_attr.nbytes
            + host_topo.nbytes)
    fields = dict(
        rows=w_rows, flags=flags_p, tokens_u=tokens_u_p,
        shares_u=shares_u_p, quota_u=quota_u_p, host_bits=host_bits,
        exc_rows=exc_rows_p, exc_mask=exc_mask_p, avail=w_avail,
        capacity=w_cap, gang_id=gang_id, gang_size=gang_size,
        gang_attr=gang_attr, host_topo=host_topo,
        res_base=np.zeros((0, 4), np.float32),
        disk_base=np.zeros((0,), np.float32), **scalars)
    wire = pallas_cycle.wire_from_numpy(fields, dev)
    wire = wire._replace(res_base=res_base.to(dev),
                         disk_base=disk_base.to(dev))
    return {"wire": wire, "rows_codec": rows_codec,
            "avail_scale": avail_scale, "cap_scale": cap_scale,
            "h2d_bytes": int(h2d)}
