"""The production cycle driver (``cook_tpu/sched/fused.py``): every
eligible pool's rank + admission + match in one device dispatch, and the
host applies the assignments transactionally.

``FusedCycleDriver.step(scheduler)`` packs every active non-direct pool
straight off the store's columnar index into the compact wire, groups the
pools by DRU mode, stages each group (:func:`stage_slot_wires`, over the
resident rows/flags of :func:`sync_resident` and the device base mirror),
runs the cycle over the driver's pool mesh (``parallel/sharded.
mesh_megacycle``: the stage kernels K1-K6 on a card, their plain
versions on the CPU), fetches the six compact outputs
with one wait, and walks them through the reference's apply path: queue
publication, within-batch group placement, the gang pass with K6's
verdicts, backoff and the transactional launch.

Host-side responsibilities that stay host-side (each feeds the cycle a
mask or a cap instead of a Python loop over the hot path):
  - plugin launch verdicts (arbitrary host predicates) -> launch_ok
  - offensive-job stifling (scheduler.clj:2205-2257)   -> enqueue_ok
  - launch-rate token budgets                          -> tokens
  - head-of-queue backoff (scheduler.clj:1613-1651)    -> num_considerable
  - pool / quota-group caps (scheduler.clj:2125-2157)  -> pool_quota,
    group_quota
  - within-batch group placement and the launch transaction, after the
    cycle (they mutate store state).

The wire staging as functions:

* rows: delta-coded i8/i16 when every delta fits, negotiated over an
  identity-padded copy (a zero-padded tail would read as delta -t);
  with the resident wire the device buffers go in as wide rows and cost
  no upload;
* avail / capacity: u16 fixed point with per-column power-of-two scales,
  sticky across cycles through the caller's ``scales`` dict, or wide;
* host_gpu / host_blocked: bitpacked, 8 hosts a byte;
* gang arrays padded across the group (no-op rows for gang-free pools).

Every codec is lossless or wide.  ``stage``'s ``exclude`` /
``avail_delta`` / ``token_delta`` and ``apply_group``'s ``reconciler``
are the pipelined driver's hooks (``sched/pipeline.py``).  With
``columnar_index=False`` the pools are packed off the store's entities
instead (the entity pack: ``build_user_tasks``, a dense bool[T, H]
constraint mask) and the group runs the dense-mask cycle
(``ops/pallas_cycle.dense_wire``: the same stage kernels, every task its
own exception row).  ``warmup`` runs every stage kernel once at the
configured bucket grid.  The mesh (``mesh=``, ``parallel/mesh``) is one
slot on the driver's device unless one is given; each slot runs its
pool block on its device, the quota-group base gathered across slots,
the pool axis is padded to a multiple of the slots, and the resident
wire is one [P_k, T] rows/flags pair a slot on that slot's device
(``parallel/mesh.pool_sharding``).  A fault in the resident
delta (its extraction or its scatter) repacks the resident wire, as the
reference's does; a failed launch, full upload or mirror sync raises
(``Scheduler.step_cycle`` then degrades that cycle to the split path).

Streams: every upload, resident scatter, dispatch and output copy is
enqueued on the current stream, in program order, so the next cycle's
``stage`` scattering into the resident rows/flags can never overtake a
dispatched cycle still reading them.  The only other stream is the lazy
queue fetch's (:meth:`FusedCycleDriver._apply_pool`), which waits on its
own cycle's event and reads only that cycle's outputs.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..cluster.base import Offer
from ..config import Config
from ..native import pack as native_pack
from ..ops import pallas_cycle, quant, telemetry
from ..ops.delta import (FLAG_LAUNCH_OK, DeviceBaseMirror,
                         PackDeltaApplier, resident_buffer)
from ..ops.gang import GangWire
from ..ops.padding import bucket, pad_to
from ..parallel.sharded import mesh_megacycle, shard_wire
from ..state.schema import DruMode, Job, Pool, SchedulerKind
from ..state.store import Store
from ..utils import audit as _audit
from ..utils import tracing
from ..utils.faults import injector as _faults
from ..utils.flight import recorder as _flight
from ..utils.metrics import registry
from .constraints import build_constraint_mask, validate_group_placement
from .matcher import MatchCycleResult, Matcher, _BackoffState
from .ranker import _pool_quota_vec

F32 = np.float32
INF = float("inf")


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


def stage_slot_wires(mesh, *, rows_p: np.ndarray, flags_p: np.ndarray,
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
                     slot_rows: Optional[List[Tuple]] = None,
                     resident: bool = False) -> dict:
    """Negotiate one group's wire once and upload it as one wire a slot
    of ``mesh`` (``parallel/mesh.PoolMesh``): each slot's pool block
    (``pool_sharding``) on the slot's device, ``res_base``/``disk_base``
    (the device base mirror) whole on every slot.  ``scalars`` holds
    ``num_considerable``, ``pool_quota``, ``group_quota`` and
    ``group_id``.

    ``slot_rows`` holds a (rows, flags) pair of device buffers a slot,
    either of them None.  With ``resident`` they are the resident [P_k,
    T] buffers (already synced, :func:`sync_resident`); they go in as
    wide rows and add nothing to ``h2d_bytes``.  Without ``quantize``,
    given device buffers are used as they are (their bytes counted, as
    the reference counts them); otherwise rows and flags are uploaded.
    Returns ``{"wires", "rows_codec", "avail_scale", "cap_scale",
    "h2d_bytes"}``."""
    from ..parallel.mesh import pool_sharding
    P, T = rows_p.shape
    H = avail_p.shape[1]
    scales = {} if scales is None else scales
    h2d = 0
    rows_codec = quant.ROWS_WIDE
    given = [(None, None)] * mesh.size
    rows_host = rows_p
    if resident:
        if slot_rows is None or any(r is None or f is None
                                    for r, f in slot_rows):
            raise ValueError("resident staging needs every slot's rows "
                             "and flags buffers")
        given = slot_rows
    elif quantize:
        qr = negotiate_rows(rows_p, n_tasks)
        rows_codec, rows_host = qr.codec, qr.data
        h2d += rows_host.nbytes + flags_p.nbytes
    else:
        rows_host = rows_p.astype(np.int32)
        if slot_rows is not None:
            given = slot_rows
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
    fields = dict(
        rows=rows_host, flags=flags_p, tokens_u=tokens_u_p,
        shares_u=shares_u_p, quota_u=quota_u_p, host_bits=host_bits,
        exc_rows=exc_rows_p, exc_mask=exc_mask_p, avail=w_avail,
        capacity=w_cap, gang_id=gang_id, gang_size=gang_size,
        gang_attr=gang_attr, host_topo=host_topo, **scalars)
    empty = {"rows": np.zeros((0,), np.int32),
             "flags": np.zeros((0,), np.uint8),
             "res_base": np.zeros((0, 4), np.float32),
             "disk_base": np.zeros((0,), np.float32)}
    wires = []
    blocks = pool_sharding(mesh).blocks(P)
    for b, d, (r_dev, f_dev) in zip(blocks, mesh.devices, given):
        # the device buffers and the base mirror's columns go in as they
        # are, the rest of the slot's block from the host
        on_dev = dict(res_base=res_base, disk_base=disk_base)
        if r_dev is not None:
            on_dev["rows"] = r_dev
        if f_dev is not None:
            on_dev["flags"] = f_dev
        block = {k: v[b] for k, v in fields.items() if k not in on_dev}
        block.update({k: empty[k] for k in on_dev})
        wire = pallas_cycle.wire_from_numpy(block, d)
        wires.append(wire._replace(**{k: t.to(d)
                                      for k, t in on_dev.items()}))
    return {"wires": wires, "rows_codec": rows_codec,
            "avail_scale": avail_scale, "cap_scale": cap_scale,
            "h2d_bytes": int(h2d)}


def stage_mega_wire(*, rows_dev: Optional[torch.Tensor] = None,
                    flags_dev: Optional[torch.Tensor] = None,
                    device="cuda", **kw) -> dict:
    """:func:`stage_slot_wires` on one device: ``rows_dev``/``flags_dev``
    are its buffers.  Returns the same dict, its one wire under
    ``"wire"``."""
    from ..parallel.mesh import POOL_AXIS, PoolMesh
    if kw.get("resident") and (rows_dev is None or flags_dev is None):
        raise ValueError("resident staging needs rows_dev and flags_dev")
    mesh = PoolMesh([resolve_device(device)], (POOL_AXIS,))
    given = (None if rows_dev is None and flags_dev is None
             else [(rows_dev, flags_dev)])
    out = stage_slot_wires(mesh, slot_rows=given, **kw)
    out["wire"] = out.pop("wires")[0]
    return out


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


class SlotSyncs(NamedTuple):
    """The resident sync of every mesh slot
    (``FusedCycleDriver._sync_resident``): ``slots`` holds each slot's
    :class:`ResidentSync` over its [P_k, T] block; ``reason`` is a
    slot's repack reason where any slot repacked, else ``delta`` where
    any slot scattered, else ``empty``; ``k`` and ``h2d_bytes`` are
    summed over the slots."""

    slots: List[ResidentSync]
    reason: str
    k: int
    h2d_bytes: int


class _ResidentSlot:
    """One mesh slot's resident [P_k, T] rows/flags wire, keyed by DRU
    mode, and the delta applier on the slot's device."""

    __slots__ = ("packs", "applier")

    def __init__(self, device):
        self.packs: Dict[bool, ResidentPack] = {}
        self.applier = PackDeltaApplier(device)


REPACK_REASONS = ("cold", "shape", "compaction", "oversize", "fault")


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
    positions uploads it all (``oversize``).  A failure of the diff (fault
    point ``delta.extract``) or of the scatter's stage or commit (fault
    point ``delta.apply``) is counted
    (``cook_kernel_fallback{kernel=}``, the flight record's
    ``kernel.dispatch-fallback``) and uploads it all (``fault``) into
    fresh buffers, since the old ones may be what failed.  Any other
    repack of an unchanged [P, T] shape rewrites the buffers in place.  A
    failed repack raises.  Repacks are counted by reason
    (``resident.repack.<reason>``) and delta rows
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
        try:
            _faults.fire("delta.extract")
            # the delta extraction (native/pack.cpp when g++ built it)
            idx = native_pack.pack_diff(st.rows_host, rows_p,
                                        st.flags_host, flags_p)
        except Exception:
            reason = _delta_fault("delta.extract")
        else:
            k = int(idx.size)
            if k == 0:
                return ResidentSync(st.rows_dev, st.flags_dev, "empty", 0,
                                    0)
            # a scatter row costs about 9 bytes against about 5 for the
            # full upload: past half the table the repack is the cheaper
            # transfer
            if 2 * k > rows_p.size:
                reason = "oversize"
            else:
                try:
                    _faults.fire("delta.apply")
                    staged = applier.stage(tuple(rows_p.shape), idx,
                                           rows_p.reshape(-1)[idx],
                                           flags_p.reshape(-1)[idx],
                                           quantize=quantize)
                    applier.commit(st.rows_buf, st.flags_buf, staged)
                except Exception:
                    reason = _delta_fault("delta.apply")
                else:
                    telemetry.count("resident.delta_rows", k)
                    st.rows_host, st.flags_host = rows_p, flags_p
                    return ResidentSync(st.rows_dev, st.flags_dev, "delta",
                                        k, staged.nbytes)
    telemetry.count(f"resident.repack.{reason}")
    nbytes = rows_p.nbytes + flags_p.nbytes
    telemetry.count_transfer("h2d", nbytes)
    dev = applier.device
    # a repack of the same shape rewrites the buffers in place, unless
    # they are what failed
    same = (reason != "fault" and st is not None
            and st.shape == tuple(rows_p.shape))
    rows_buf = resident_buffer(rows_p.astype(np.int32, copy=False), dev,
                               out=st.rows_buf if same else None)
    flags_buf = resident_buffer(flags_p.astype(np.uint8, copy=False), dev,
                                out=st.flags_buf if same else None)
    st = packs[gpu_mode] = ResidentPack(key, epoch, tuple(rows_p.shape),
                                        rows_buf, flags_buf, rows_p, flags_p)
    return ResidentSync(st.rows_dev, st.flags_dev, reason, k, nbytes)


def _delta_fault(kernel: str) -> str:
    """Count a failed resident delta (``delta.extract`` or
    ``delta.apply``) as the reference does; the sync then repacks."""
    import logging
    logging.getLogger(__name__).exception(
        "resident-pack %s failed; full repack", kernel)
    registry.counter_inc("cook_kernel_fallback", labels={"kernel": kernel})
    _flight.note_fault("kernel.dispatch-fallback")
    return "fault"


# --------------------------------------------------------------- the driver
class _PackedPool:
    """Host-side staging for one pool's cycle inputs (columnar pack)."""

    def __init__(self, pool: Pool):
        self.pool = pool
        # entity pack (columnar_index=False): kernel rows map to tasks of
        # build_user_tasks, task_ids[row] -> id2job; the dense form
        # carries per-row demands and a dense [T, H] constraint mask
        self.columnar = True
        self.task_ids: List[int] = []
        self.id2job: Dict[int, Job] = {}
        self.job_res: Optional[np.ndarray] = None       # f32[T, 4]
        self.cmask: Optional[np.ndarray] = None         # bool[T, H]
        self.tokens: Optional[np.ndarray] = None        # f32[T]
        # kernel rows map to job uuids: uuid/user/res come as index BASE
        # snapshots plus the sorted absolute rows (rows_s); sorted-position
        # lookups go through base[rows_s[pos]]
        self.rows_s: Optional[np.ndarray] = None        # i64[T] sorted rows
        self.uuid_base: Optional[np.ndarray] = None     # U36[n] by row
        self.user_base: Optional[np.ndarray] = None     # U64[n] by row
        self.res_base: Optional[np.ndarray] = None      # f32[n, 4] by row
        # structured-mask form: no dense [T, H] mask is ever built
        self.host_gpu: Optional[np.ndarray] = None      # bool[H]
        self.host_blocked: Optional[np.ndarray] = None  # bool[H]
        self.exc_mask: Optional[np.ndarray] = None      # bool[E, H]
        self.offers: List[Offer] = []
        self.ctx = None
        self.arrays: Dict[str, np.ndarray] = {}
        self.avail = None
        # overdraft-adjusted availability (pipelined driver only): set by
        # the reconciler when an overlapped cycle consumed capacity this
        # pack's staged avail never saw; the gang rescue/refill places
        # against it instead of avail
        self.avail_headroom: Optional[np.ndarray] = None  # f32[H, 4]
        self.capacity = None
        self.enqueue_ok = None
        self.launch_ok = None
        # compact wire form: per-user tables + packed admission flags
        self.shares_u: Optional[np.ndarray] = None      # f32[U, 3]
        self.quota_u: Optional[np.ndarray] = None       # f32[U, 4]
        self.tokens_u: Optional[np.ndarray] = None      # f32[U]
        self.flags: Optional[np.ndarray] = None         # u8[T]
        self.disk_base: Optional[np.ndarray] = None     # f32[n] by row
        self.base_compactions = -1   # index compaction epoch at pack
        self.exc_rows: Optional[np.ndarray] = None      # i32[n_exc]
        self.num_considerable = 0
        self.pool_quota = np.full(4, INF, dtype=F32)
        self.group_quota = np.full(4, INF, dtype=F32)
        self.group_id = -1
        self.offensive: List[Job] = []
        self.n_tasks = 0
        self.n_hosts = 0
        # gang wire (ops/gang.build_gang_wire): per-task gang segments
        # staged before the dispatch so K6 reduces in the launch, and the
        # pack-time satisfied elastic set the apply path compares against
        # before trusting K6's verdicts
        self.gang_wire = None
        self.gang_satisfied: frozenset = frozenset()


class _StagedCycle:
    """Phase 1 (stage) output: one cycle's packed pools, grouped by DRU
    mode and ready for dispatch."""

    __slots__ = ("pools", "groups")

    def __init__(self, pools: List[Pool]):
        self.pools = pools
        self.groups: List["_StagedGroup"] = []


class _StagedGroup:
    """One DRU-mode group's staged wire (``stage_slot_wires``' dict:
    one device wire a mesh slot, the codec tags and ``h2d_bytes``).
    With ``resident`` each slot wire's rows/flags are that slot's
    resident buffers, already synced by the delta scatter or a repack
    (``sync``: the :class:`SlotSyncs`)."""

    __slots__ = ("gpu_mode", "group", "cap", "T", "H", "stage_ms",
                 "resident", "mega", "sync", "dense")

    def __init__(self, *, gpu_mode, group, cap, T, H, stage_ms, mega,
                 resident=False, sync=None, dense=False):
        self.gpu_mode = gpu_mode
        # the entity pack's dense-mask wire (ops/pallas_cycle.dense_wire)
        self.dense = dense
        self.group = group
        self.cap = cap
        self.T = T
        self.H = H
        self.stage_ms = stage_ms
        self.mega = mega
        self.resident = resident
        # the resident sync's ResidentSync (path, k, bytes), or None
        self.sync = sync


class _GroupDispatch:
    """An in-flight dispatch of one staged group: the cycle's result
    tensors, and the pinned host buffer the six compact outputs are
    being copied into (``event`` marks the copy's end on the card).
    ``fetched`` holds the host arrays after :meth:`fetch_group`."""

    __slots__ = ("sg", "res", "host", "event", "sizes", "fetched")

    def __init__(self, sg: _StagedGroup, res, host, event, sizes):
        self.sg = sg
        self.res = res
        self.host = host
        self.event = event
        self.sizes = sizes
        self.fetched = None


# the compact outputs the host fetches, in the reference's order
_FETCHED = ("cand_row", "cand_assign", "cand_qpos", "n_queue", "cand_gang",
            "cand_dropped")


def fetch_rows(dev_rows: torch.Tensor, n: int, done,
               stream: Optional["torch.cuda.Stream"]) -> np.ndarray:
    """The first ``n`` rows of a cycle's queue output on the host.  On a
    card the copy runs on ``stream``, a side stream that waits on
    ``done`` (the event recorded after that cycle's outputs), into
    pinned memory: it never waits for a later cycle the pipelined driver
    has enqueued on the current stream behind this one.  ``dev_rows``
    stays referenced by the caller until the copy has ended."""
    if not dev_rows.is_cuda:
        return dev_rows[:n].numpy()
    if done is None:
        raise RuntimeError("queue rows on the card without their cycle's "
                           "event: the copy would not wait for them")
    host = torch.empty(n, dtype=dev_rows.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        stream.wait_event(done)
        host.copy_(dev_rows[:n], non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    copied.synchronize()
    return host.numpy()


class FusedCycleDriver:
    """The production cycle over every active non-direct pool: pack off
    the store's columnar index, stage the compact wire (resident and
    quantized by default), run the cycle over :meth:`mesh` (kernels
    K1-K6 on a card, their plain versions on the CPU), fetch the compact
    outputs, and launch transactionally.

    The reference's ``scheduler`` argument is duck-typed: ``step`` reads
    ``reserved_hosts``, ``clusters``, ``launchable_clusters(pool)`` and
    ``_stifle_offensive(jobs)`` from it.  Every group goes through the
    stage chain (the reference picks between its megakernel and the
    fused XLA cycle, which decide identically): a columnar group on the
    compact wire, an entity-pack group (``columnar_index=False``) on the
    dense wire.  ``mesh`` (``parallel/mesh.PoolMesh``, its first slot on
    ``device``) defaults to one slot on ``device``; each slot runs its
    pool block (:meth:`mesh`, :meth:`_launch`).  A failed resident
    delta repacks (:func:`sync_resident`); a failed launch, full upload
    or mirror sync raises."""

    def __init__(self, store: Store, config: Config, matcher: Matcher,
                 plugins, rate_limits, device="cuda", mesh=None,
                 shard_id=None):
        self.store = store
        self.config = config
        self.matcher = matcher
        self.plugins = plugins
        self.rate_limits = rate_limits
        self.device = resolve_device(device)
        if self.device != matcher.device:
            # the split match and the gang reduction run on the matcher's
            raise ValueError(f"FusedCycleDriver on {self.device}, its "
                             f"matcher on {matcher.device}")
        if mesh is not None and mesh.devices[0] != self.device:
            # the sharded cycle gathers its outputs onto the first slot
            raise ValueError(f"FusedCycleDriver on {self.device}, its "
                             f"mesh's first slot on {mesh.devices[0]}")
        self._mesh = mesh
        # sharded-controller mode: this process owns ONE mesh shard, so
        # the [P, ...] pool-stacked arrays it builds cover only its
        # partition's pools (mesh() refuses a multi-slot mesh with it)
        self.shard_id = shard_id
        # device mirror of the index's immutable res/disk base columns
        self._mirror = DeviceBaseMirror(self.device)
        # the resident [P_k, T] rows/flags wire of each mesh slot, on the
        # slot's device (built with the mesh: :meth:`_resident_slots`)
        self._slots: List[_ResidentSlot] = []
        # quiet-pool fast path: the index's delta feed tells the pack
        # when a pool saw no churn since its last pack
        self._delta_cid: Optional[int] = None
        self._pack_cache: Dict[str, Dict] = {}
        # sticky quantized-wire scales (ops/quant.py)
        self._mega_scales: Dict[str, tuple] = {}
        # host ms of the last stage's pack (the "pack" phase detail)
        self.last_pack_ms = 0.0
        # the side stream the lazy queue fetches copy on (a card only)
        self._queue_stream = None

    # ------------------------------------------------------------------ mesh
    def mesh(self):
        """The pool mesh the cycle runs over: one slot on the driver's
        device unless one was given.  A controller shard (``shard_id``)
        with a mesh of more than one slot raises
        ``ShardAlignmentError``."""
        if self._mesh is None:
            from ..parallel.mesh import POOL_AXIS, PoolMesh
            self._mesh = PoolMesh([self.device], (POOL_AXIS,))
        if self.shard_id is not None and self._mesh.size > 1:
            # one partition = one process = one mesh shard: a shard
            # worker driving a multi-slot pool mesh would commit
            # resident buffers for pools OTHER processes own
            from ..parallel.mesh import ShardAlignmentError
            raise ShardAlignmentError(
                f"controller shard {self.shard_id} was given a "
                f"{self._mesh.size}-device pool mesh: a shard process "
                "commits resident buffers for ITS pools only; give each "
                "shard its local device slice")
        return self._mesh

    # --------------------------------------------------------------- warmup
    def _megacycle_warm_selected(self) -> bool:
        """Does the warmup run the megacycle's codec variants (the
        counterpart of the reference's megakernel executables)?  Where
        the reference does: an explicit ``tpu-megakernel`` pin on any
        matcher, or ``auto`` on the accelerator (here a card, where the
        live path is the stage kernels)."""
        if self.mesh().size > 1:
            # the reference's megakernel serves a one-device mesh only
            return False
        backends = {self.config.default_matcher.backend}
        backends.update(mc.backend for _rx, mc in self.config.pool_matchers)
        return "tpu-megakernel" in backends or (
            "auto" in backends and self.device.type == "cuda")

    def warmup(self, *, tasks: int, hosts: int, users: int = 8,
               sweep: bool = False, gpu: bool = False) -> int:
        """Boot-time cold-start killer (config.PipelineConfig): run the
        cycle once, with zeroed inputs, at the bucket grid the configured
        design point implies, so the first launch of every stage kernel
        (K1-K6), the allocator's first blocks and the pinned buffers land
        at boot — inside the leader's takeover window — and never inside
        a live cycle.  The port compiles nothing per shape; the kernels'
        library is built or loaded by the first launch.

        The runs, as the reference counts them: at each (T, H) bucket
        (``sweep=True``: every bucket up to the targets, else the
        targets) and each DRU mode (``gpu``), one run a distinct matcher
        cap bucket of the wide wire (i32 rows, f32 hosts: the reference's
        compact fused cycle); then, where the reference warms its
        megakernel (:meth:`_megacycle_warm_selected`), one run a cap of
        each rows codec the live wire takes (i32 for the resident wire,
        i8 for the quantized rebuild), with the host columns in the
        live form (u16 fixed point with ``quantized_wire``).  With
        ``resident_pack`` the delta scatter runs once at every delta
        bucket up to the [P, T] buffer, in each value codec (not
        counted, as the reference does not count them).  Returns the
        number of runs."""
        if tasks <= 0 or hosts <= 0:
            return 0
        if not self.config.columnar_index:
            # warmup covers the production compact/columnar wire form
            # only (the dense wire's exception rows are its own shape)
            import logging
            logging.getLogger(__name__).warning(
                "fused-cycle warmup skipped: columnar_index=False packs "
                "the dense PoolCycleInputs variant, which warmup does "
                "not cover")
            return 0
        from ..ops.delta import _DELTA_MIN_BUCKET

        def grid(n: int, minimum: int = 64) -> List[int]:
            top = bucket(n, minimum=minimum)
            if not sweep:
                return [top]
            out, b = [], minimum
            while b <= top:
                out.append(b)
                b *= 2
            return out

        dev = self.device
        mesh = self.mesh()
        P = mesh.size  # one pool a slot, as the reference's
        U = bucket(max(users, 1), minimum=8)
        E = 8  # exception bucket floor: no complex jobs in the zero world
        # the dispatch cap is bucket(max matcher cap over the group's
        # pools); pool_matchers overrides can bucket differently from the
        # default, so warm every DISTINCT cap bucket
        caps = {bucket(self.config.default_matcher.max_jobs_considered)}
        caps.update(bucket(mc.max_jobs_considered)
                    for _rx, mc in self.config.pool_matchers)
        mega = self._megacycle_warm_selected()
        codecs = [(np.int32, quant.ROWS_WIDE)]
        if self.config.quantized_wire:
            codecs.append((np.int8, quant.ROWS_I8))
        runs = 0

        def run(fields, cap, gm, rows_codec=quant.ROWS_WIDE,
                avail_scale=0.0, cap_scale=0.0):
            res = self._launch(
                shard_wire(mesh, pallas_cycle.wire_from_numpy(fields, dev)),
                gpu_mode=gm, considerable_cap=cap, rows_codec=rows_codec,
                avail_scale=avail_scale, cap_scale=cap_scale)
            # wait for the cycle: one read of a result
            res.n_queue.cpu()

        for gm in ((False, True) if gpu else (False,)):
            for T in grid(tasks):
                # the device base mirror's capacity bucket tracks the
                # index row count (~T at one pool per index row)
                mir = bucket(T, minimum=1024)
                for H in grid(hosts):
                    gang = pallas_cycle.empty_gang_wire(P, T, H)
                    zero_hosts = np.zeros((P, H, 4), dtype=F32)
                    fields = dict(
                        rows=np.zeros((P, T), dtype=np.int32),
                        flags=np.zeros((P, T), dtype=np.uint8),
                        res_base=np.zeros((mir, 4), dtype=F32),
                        disk_base=np.zeros(mir, dtype=F32),
                        tokens_u=np.full((P, U), INF, dtype=F32),
                        shares_u=np.full((P, U, 3), INF, dtype=F32),
                        quota_u=np.full((P, U, 4), INF, dtype=F32),
                        num_considerable=np.zeros(P, dtype=np.int32),
                        pool_quota=np.full((P, 4), INF, dtype=F32),
                        group_quota=np.full((P, 4), INF, dtype=F32),
                        group_id=np.full(P, -1, dtype=np.int32),
                        host_bits=pack_host_bits(
                            np.zeros((P, H), dtype=bool),
                            np.ones((P, H), dtype=bool)),
                        exc_rows=np.full((P, E), -1, dtype=np.int32),
                        exc_mask=np.zeros((P, E, H), dtype=bool),
                        avail=zero_hosts, capacity=zero_hosts,
                        gang_id=gang[0], gang_size=gang[1],
                        gang_attr=gang[2], host_topo=gang[3])
                    cap_list = sorted({min(c, T) for c in caps})
                    for cap in cap_list:
                        run(fields, cap, gm)
                        runs += 1
                    if mega:
                        a_scale = c_scale = 0.0
                        hosts_f = {}
                        if self.config.quantized_wire:
                            qa, qc = quantize_hosts(zero_hosts, zero_hosts,
                                                    {})
                            a_scale, c_scale = qa.scale, qc.scale
                            hosts_f = dict(avail=qa.data, capacity=qc.data)
                        for rdt, rcodec in codecs:
                            wf = dict(fields, rows=np.zeros((P, T), rdt),
                                      **hosts_f)
                            for cap in cap_list:
                                run(wf, cap, gm, rcodec, a_scale, c_scale)
                                runs += 1
                if self.config.resident_pack:
                    # the resident delta scatter at every delta bucket up
                    # to the buffer, into throwaway buffers of the live
                    # buffers' shape and place (one a slot, on the
                    # slot's device): a wide batch, and with the
                    # quantized wire an i8 and an i16 one
                    Pk = P // mesh.size
                    n_flat = Pk * T
                    kbs, k = set(), _DELTA_MIN_BUCKET
                    while k < n_flat:
                        kbs.add(k)
                        k *= 2
                    kbs.add(n_flat)  # the clamped top bucket
                    zeros = np.zeros((Pk, T), dtype=np.int32)
                    for slot in self._resident_slots():
                        applier = slot.applier
                        rows_b = resident_buffer(zeros, applier.device)
                        flags_b = resident_buffer(zeros.astype(np.uint8),
                                                  applier.device)
                        for k in sorted(kbs):
                            idx = np.arange(min(k, n_flat), dtype=np.int32)
                            fl = np.zeros(idx.size, dtype=np.uint8)
                            applier.apply(rows_b, flags_b, (Pk, T), idx,
                                          np.zeros(idx.size, np.int32), fl)
                            if self.config.quantized_wire:
                                for off in (0, 1000):
                                    applier.apply(
                                        rows_b, flags_b, (Pk, T), idx,
                                        idx % T + off, fl, quantize=True)
                        rows_b[-1:].cpu()
        return runs

    # ------------------------------------------------------- resident pack
    def reset_resident(self) -> None:
        """Drop all device-resident state — the rows/flags pack, the
        quiet-pool cache and the res/disk base mirror — so the next stage
        rebuilds from scratch (a failed cycle, leader handoff, tests).
        Safe at any time: residency mirrors what the next full pack
        builds."""
        for slot in self._slots:
            slot.packs.clear()
        self._pack_cache.clear()
        self._mirror = DeviceBaseMirror(self.device)

    def _resident_slots(self) -> List[_ResidentSlot]:
        """The resident wire of each slot of :meth:`mesh`, in mesh
        order."""
        if not self._slots:
            self._slots = [_ResidentSlot(d) for d in self.mesh().devices]
        return self._slots

    def _sync_resident(self, gpu_mode: bool, key: Tuple, rows_p: np.ndarray,
                       flags_p: np.ndarray, epoch: int) -> SlotSyncs:
        """Bring each slot's resident [P_k, T] rows/flags buffers up to
        its block of the staged host arrays (:func:`sync_resident`,
        ``parallel/mesh.pool_sharding``'s blocks): a delta scatter in
        steady state, a full upload on a cold start, a reshape, a
        compaction, an oversize delta or a failed diff or scatter
        (``fault``)."""
        from ..parallel.mesh import pool_sharding
        blocks = pool_sharding(self.mesh()).blocks(rows_p.shape[0])
        with tracing.span("delta.apply", gpu=gpu_mode):
            slots = [sync_resident(slot.packs, gpu_mode, key, rows_p[b],
                                   flags_p[b], epoch, applier=slot.applier,
                                   quantize=bool(self.config.quantized_wire))
                     for slot, b in zip(self._resident_slots(), blocks)]
        reasons = [r.reason for r in slots]
        reason = next((r for r in reasons if r not in ("delta", "empty")),
                      "delta" if "delta" in reasons else "empty")
        rs = SlotSyncs(slots, reason, sum(r.k for r in slots),
                       sum(r.h2d_bytes for r in slots))
        if rs.reason == "delta":
            registry.counter_inc("cook_delta_rows", float(rs.k))
            _flight.note_delta(rs.k)
        elif rs.reason == "empty":
            _flight.note_delta(0)
        else:
            registry.counter_inc("cook_resident_repack",
                                 labels={"reason": rs.reason})
            _flight.note_repack(rs.reason)
        return rs

    # ------------------------------------------------------------------ pack
    def _pack_pool_columnar(self, scheduler, pool: Pool, exclude=None,
                            token_delta=None) -> Optional[_PackedPool]:
        """Pack one pool's cycle inputs straight off the columnar index
        (state/index.py): no entity materialization for the plain-job
        majority — entities are fetched only for rows the vectorized path
        can't decide (user constraints, groups, checkpoint, prior
        instances; see index._is_complex) and for the offensive minority.
        Decision parity with the reference driver is asserted by
        tests/test_torch_driver.py."""
        store, cfg = self.store, self.config
        idx = store.ensure_index()
        # ONE snapshot of the reservations: the rebalancer thread mutates
        # reserved_hosts concurrently, and every later read in this pack
        # (owner rows, host blocks, local owners) must see the same set
        resv = dict(scheduler.reserved_hosts)
        # tx-event delta feed (state/index.py attach_pack_consumer): one
        # drain per pack.  A quiet pool — zero journaled rows, no fence —
        # reuses its cached [T]-sized pack products wholesale instead of
        # rebuilding them (the incremental-view-maintenance fast path;
        # ineligible shapes fall through to the full rebuild below)
        if self._delta_cid is None:
            self._delta_cid = idx.attach_pack_consumer()
        delta = idx.pack_delta(self._delta_cid, pool.name)
        cached = self._pack_cache.get(pool.name)
        if (cached is not None and not delta.fence
                and delta.rows.size == 0
                and delta.epoch == cached["epoch"]
                and delta.version == cached["version"]
                and not self.plugins.launch_filters
                and not self._resv_owner_in_pack(idx, resv, cached)):
            return self._pack_pool_cached(scheduler, pool, cached, resv,
                                          exclude=exclude,
                                          token_delta=token_delta)
        self._pack_cache.pop(pool.name, None)
        snap = idx.fused_arrays(pool.name, owner_uuids=list(resv),
                                compact=True)
        if snap is None:
            return None
        arrays, rows_s = snap.arrays, snap.rows_s
        uuid_base, complex_rows, owner_rows = \
            snap.uuid_base, snap.complex_s, snap.owner_rows
        users = snap.users
        pp = _PackedPool(pool)
        pp.rows_s = rows_s
        pp.uuid_base, pp.user_base, pp.res_base = \
            uuid_base, snap.user_base, snap.res_base
        # device-resident base mirror inputs: NO per-task resource columns
        # are gathered on the host at all (expand_compact gathers the
        # res/disk base by rows on device)
        pp.disk_base = snap.disk_base
        pp.base_compactions = snap.compactions
        # sorted-position -> uuid, via the base snapshot (no full gather)
        uuid_at = lambda sel: uuid_base[rows_s[sel]]
        T = rows_s.size
        pp.arrays, pp.n_tasks = arrays, T
        pend = arrays["pending"]

        # per-user share/quota TABLES: the kernel gathers them on device via
        # user_rank (CompactPoolCycleInputs), so the host never broadcasts
        # ~32 B/task of user data into [T]-sized columns
        pp.shares_u, pp.quota_u = self._user_tables(pool, users)

        host_index = self._pack_offers(pp, scheduler, pool)
        offers = pp.offers
        if offers:
            H = len(offers)
            reserved_idx = [host_index[hn]
                            for hn in resv.values()
                            if hn in host_index]
            pp.host_blocked[reserved_idx] = True
            # exception rows = complex jobs + reservation owners (owners
            # must punch through the blanket reserved-host block; owners
            # whose reserved host serves another pool need no exception)
            is_exc = pend & complex_rows
            local_owners = [u for u, hn in resv.items()
                            if hn in host_index]
            if local_owners:
                # int row-membership test against rows resolved under the
                # SAME index lock hold as rows_s (a post-snapshot rows_for
                # could race a compaction's row remap); a string isin would
                # re-gather the full uuid column this pack is built to avoid
                local_rows = np.array(
                    [owner_rows[u] for u in local_owners
                     if u in owner_rows], dtype=np.int64)
                is_exc |= pend & np.isin(rows_s, local_rows)
            cjobs, keep = [], []
            for i in np.flatnonzero(is_exc):
                job = store.job(str(uuid_at(i)))
                if job is not None:
                    cjobs.append(job)
                    keep.append(i)
            crow = np.array(keep, dtype=np.int64)
            ctx = self.matcher._constraint_context(
                cjobs, resv)
            self.matcher._fill_cotask_host_attributes(
                ctx, pool.name, offers, scheduler.clusters)
            pp.ctx = ctx
            if cjobs:
                # the compiler emits COMPLETE rows (gpu isolation,
                # max-tasks, reservations included), so an exception row
                # fully replaces the base
                pp.exc_mask = build_constraint_mask(cjobs, offers, ctx)
                pp.exc_rows = crow.astype(np.int32)
            else:
                pp.exc_mask = np.zeros((1, H), dtype=bool)
                pp.exc_rows = np.zeros(0, dtype=np.int32)

        # offensive-job filter: vectorized over the BASE columns (the
        # compact pack gathers no per-task resource columns), then one
        # [T] bool gather by rows
        enqueue_ok = np.ones(T, dtype=bool)
        limits = cfg.offensive_job_limits
        if limits is not None:
            res_b = snap.res_base
            bad_base = ((res_b[:, 1] > limits.memory_gb * 1024.0)
                        | (res_b[:, 0] > limits.cpus))
            bad = pend & bad_base[rows_s]
            if bad.any():
                enqueue_ok[bad] = False
                pp.offensive = [j for j in (store.job(str(u))
                                            for u in uuid_at(bad))
                                if j is not None]
                # one gather over the existing wire arrays attributes the
                # aggregate to job uuids (utils/audit.py)
                _audit.note_skips(store.audit,
                                  {"offensive": list(uuid_at(bad))},
                                  pool=pool.name)
        pp.enqueue_ok = enqueue_ok

        # plugin launch verdicts: only when a filter is configured, and the
        # per-uuid verdict cache is consulted before materializing an
        # entity (plugins/launch.clj caches accept/defer the same way), so
        # steady state costs no deep copies even with filters on
        launch_ok = np.ones(T, dtype=bool)
        if self.plugins.launch_filters:
            for i in np.flatnonzero(pend):
                uuid = str(uuid_at(i))
                cached = self.plugins.launch_verdict_cached(uuid)
                if cached is None:
                    job = store.job(uuid)
                    if job is None:
                        # vanished-but-still-indexed uuid: cache a synthetic
                        # accept so the next cycle stays copy-free instead
                        # of re-missing and re-fetching forever.  Short TTL:
                        # if the uuid re-materializes (store swap race) the
                        # real filters re-run within seconds, not 60s
                        self.plugins.cache_launch_verdict(uuid, True,
                                                          ttl_s=5.0)
                        cached = True
                    else:
                        cached = self.plugins.launch_allowed(job)
                if not cached:
                    launch_ok[i] = False
            filtered = ~launch_ok
            if filtered.any():
                _audit.note_skips(
                    store.audit,
                    {"launch-filtered": list(uuid_at(filtered))},
                    pool=pool.name)
        # pipelined-driver speculation mask (sched/pipeline.py): rows the
        # in-flight overlapped cycle is about to launch are withheld from
        # THIS cycle's launch candidates (they'd conflict at reconcile).
        # Row ids are only valid within one index compaction epoch; on a
        # mismatch the mask is skipped and reconciliation catches the
        # conflicts instead (rare: compaction between two packs).
        spec_masked = None
        if exclude is not None:
            kind, epoch, rows = exclude
            if kind == "rows" and epoch == snap.compactions and len(rows):
                masked = pend & np.isin(rows_s, rows)
                if masked.any():
                    launch_ok = launch_ok & ~masked
                    spec_masked = masked
                    _audit.note_skips(
                        store.audit,
                        {"pipeline-speculative": list(uuid_at(masked))},
                        pool=pool.name)
        pp.launch_ok = launch_ok

        # launch-rate token budgets per USER (device gathers via user_rank)
        launch_rl = self.rate_limits.job_launch
        pp.tokens_u = self._tokens_u(pool, users, token_delta)

        # gang-cohort admission: every gang member is a complex row, so
        # the materialized exception jobs carry the full cohorts
        gang_members: Dict[str, List] = {}
        if pp.ctx is not None and len(pp.exc_rows):
            for i, job in zip(pp.exc_rows, cjobs):
                if pend[i] and job.group is not None and getattr(
                        pp.ctx.groups.get(job.group), "gang", False):
                    gang_members.setdefault(job.group, []).append(
                        (int(i), job))
        tok_by_user = dict(zip(users, pp.tokens_u.tolist()))
        satisfied = self._gang_cohort_admission(
            pool, pp.ctx.groups if pp.ctx is not None else {},
            gang_members, launch_ok,
            (lambda u: tok_by_user.get(u, 0.0))
            if launch_rl.enforce else None,
            spec_masked=spec_masked)
        if gang_members:
            # the gang wire: the same membership the host pass would
            # derive from the candidates, staged before the dispatch so
            # K6 reduces in the launch (every columnar pool dispatches
            # through the stage chain)
            from ..ops.gang import build_gang_wire
            pp.gang_wire = build_gang_wire(
                T, gang_members,
                pp.ctx.groups if pp.ctx is not None else {}, pp.offers,
                satisfied=satisfied)
            pp.gang_satisfied = frozenset(satisfied or ())

        # the admission bools + user-segment boundaries, packed into one
        # wire byte per task (user_rank/first_idx re-derive on device)
        from ..ops.delta import pack_flags
        pp.flags = pack_flags(pend, arrays["valid"], arrays["is_first"],
                              enqueue_ok=enqueue_ok, launch_ok=launch_ok)

        # quiet-pool cache (the delta-feed fast path above): only shapes
        # with no entity-coupled rows are reusable wholesale — no COMPLEX
        # pending rows (their constraint masks depend on entities the
        # event feed doesn't cover; checked against the snapshot, NOT
        # pp.exc_rows, which is only populated when offers exist — an
        # offer-less cycle must not cache a constrained job as maskless),
        # no offensive rows (their stifle kills are in flight), no launch
        # filters (verdict TTLs live outside the index).  Reservations
        # per se are fine: their blanket host blocks are re-applied per
        # cycle by the fast path, and an OWNER entering this pool's
        # pending set is re-checked against the live map on every reuse
        if (not self.plugins.launch_filters and not pp.offensive
                and not (pend & complex_rows).any()):
            flags0 = pp.flags
            if spec_masked is not None and spec_masked.any():
                # cache the PRE-speculation flags: the in-flight footprint
                # changes every cycle and is re-patched by the fast path
                flags0 = flags0.copy()
                flags0[spec_masked] |= np.uint8(FLAG_LAUNCH_OK)
            self._pack_cache[pool.name] = {
                "epoch": snap.compactions, "version": delta.version,
                "rows_s": rows_s, "pend": pend, "flags0": flags0,
                "users": users, "uuid_base": uuid_base,
                "user_base": snap.user_base, "res_base": snap.res_base,
                "disk_base": snap.disk_base}

        self._pack_caps(pp, pool)
        return pp

    def _pack_offers(self, pp: _PackedPool, scheduler, pool: Pool
                     ) -> Optional[Dict[str, int]]:
        """Per-cycle offer staging shared by the full pack and the
        quiet-pool fast path: breaker-filtered offers (a tripped cluster
        contributes none, so the kernel routes demand at healthy
        clusters) plus the STRUCTURED per-host base vectors — gpu
        isolation and max-tasks blocking (constraints.clj:122,433; see
        parallel/sharded.StructuredPoolCycleInputs) — and the
        avail/capacity stacks.  Returns hostname -> index for the full
        path's reservation/exception handling (None when no offers; the
        empty-offer fallback shapes are set here so the two paths can
        never diverge)."""
        cfg = self.config
        offers: List[Offer] = []
        for cluster in scheduler.launchable_clusters(pool.name):
            offers.extend(cluster.pending_offers(pool.name))
        pp.offers = offers
        pp.n_hosts = len(offers)
        if not offers:
            pp.host_gpu = np.zeros(1, dtype=bool)
            pp.host_blocked = np.ones(1, dtype=bool)
            pp.exc_rows = np.zeros(0, dtype=np.int32)
            pp.exc_mask = np.zeros((1, 1), dtype=bool)
            pp.avail = np.zeros((1, 4), dtype=F32)
            pp.capacity = np.zeros((1, 4), dtype=F32)
            return None
        H = len(offers)
        pp.host_gpu = np.array([o.capacity.gpus > 0 for o in offers],
                               dtype=bool)
        host_tasks = np.array([o.task_count for o in offers],
                              dtype=np.int32)
        host_blocked = np.zeros(H, dtype=bool)
        if cfg.max_tasks_per_host is not None:
            host_blocked |= host_tasks >= cfg.max_tasks_per_host
        pp.host_blocked = host_blocked
        pp.avail = np.array(
            [[o.available.cpus, o.available.mem, o.available.gpus,
              o.available.disk] for o in offers], dtype=F32)
        pp.capacity = np.array(
            [[o.capacity.cpus, o.capacity.mem, o.capacity.gpus,
              o.capacity.disk] for o in offers], dtype=F32)
        return {o.hostname: h for h, o in enumerate(offers)}

    def _user_tables(self, pool: Pool, users: List[str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-user share/quota tables in segment order (shared by the
        full pack, the quiet-pool fast path, and — via the same module
        function — the columnar rank path)."""
        from .ranker import build_user_tables
        return build_user_tables(self.store, pool.name, users)

    def _tokens_u(self, pool: Pool, users: List[str],
                  token_delta=None) -> np.ndarray:
        """Per-user launch-rate token budgets, net of the pipelined
        driver's in-flight spends (shared by both pack paths)."""
        launch_rl = self.rate_limits.job_launch
        if not launch_rl.enforce:
            return np.full(max(len(users), 1), INF, dtype=F32)
        from ..policy import pool_user_key
        tokens = np.array(
            [launch_rl.get_token_count(pool_user_key(pool.name, u))
             for u in users], dtype=F32)
        if token_delta:
            # tokens an overlapped in-flight cycle will spend at its
            # apply (the limiter hasn't seen the spends yet)
            tokens = np.maximum(tokens - np.array(
                [token_delta.get(u, 0.0) for u in users], dtype=F32), 0.0)
        return tokens

    def _resv_owner_in_pack(self, idx, resv: Dict, c: Dict) -> bool:
        """True when a reservation OWNER is one of the cached pack's
        pending rows: owners need an exception-mask punch-through, which
        only the full pack builds.  Plain reservations (owner elsewhere)
        stay fast-path compatible — their blanket host blocks are
        per-cycle state applied by _pack_pool_cached."""
        if not resv:
            return False
        owner_rows = idx.rows_for(list(resv))
        if not owner_rows.size:
            return False
        return bool(np.isin(owner_rows, c["rows_s"][c["pend"]]).any())

    def _pack_pool_cached(self, scheduler, pool: Pool, c: Dict,
                          resv: Dict, exclude=None,
                          token_delta=None) -> _PackedPool:
        """Quiet-pool fast path: the index's delta feed reported zero
        churn since this pool's last pack, so the [T]-sized pack products
        (sorted rows, admission flags) are reused WHOLESALE — no index
        snapshot, no order repair, no flags rebuild, no O(T) host work.
        Only the per-user tables, offers, reserved-host blocks, caps,
        and the pipelined driver's speculative mask are rebuilt per
        cycle; the mask is a bit-patch over the cached flags, which the
        resident pack then ships as a scatter delta.

        Eligibility was checked by the caller + at cache time: no
        reservation OWNERS pending in this pool, no launch filters, and
        the cached pack had no exception or offensive rows — so
        exceptions are empty and enqueue/launch verdicts are all-accept
        by construction."""
        pp = _PackedPool(pool)
        rows_s = c["rows_s"]
        pp.rows_s = rows_s
        pp.uuid_base, pp.user_base = c["uuid_base"], c["user_base"]
        pp.res_base, pp.disk_base = c["res_base"], c["disk_base"]
        pp.base_compactions = c["epoch"]
        T = rows_s.size
        pp.n_tasks = T
        pend = c["pend"]
        users = c["users"]
        pp.shares_u, pp.quota_u = self._user_tables(pool, users)

        host_index = self._pack_offers(pp, scheduler, pool)
        if host_index is not None:
            # blanket reserved-host blocks are per-cycle state, applied
            # here exactly as the full path does (owners needing the
            # punch-through exception forced a full rebuild upstream)
            reserved_idx = [host_index[hn] for hn in resv.values()
                            if hn in host_index]
            pp.host_blocked[reserved_idx] = True
            # eligibility guarantees no exception rows; the empty ctx
            # still carries the co-task host attributes the gang/group
            # apply path reads
            pp.exc_mask = np.zeros((1, len(pp.offers)), dtype=bool)
            pp.exc_rows = np.zeros(0, dtype=np.int32)
            ctx = self.matcher._constraint_context([], resv)
            self.matcher._fill_cotask_host_attributes(
                ctx, pool.name, pp.offers, scheduler.clusters)
            pp.ctx = ctx

        pp.enqueue_ok = np.ones(T, dtype=bool)
        launch_ok = np.ones(T, dtype=bool)
        flags = c["flags0"]
        if exclude is not None:
            kind, epoch, rows = exclude
            if kind == "rows" and epoch == c["epoch"] and len(rows):
                masked = pend & np.isin(rows_s, rows)
                if masked.any():
                    launch_ok = launch_ok & ~masked
                    flags = flags.copy()
                    flags[masked] &= np.uint8(~np.uint8(FLAG_LAUNCH_OK))
                    _audit.note_skips(
                        self.store.audit,
                        {"pipeline-speculative":
                             list(pp.uuid_base[rows_s[masked]])},
                        pool=pool.name)
        pp.launch_ok = launch_ok
        pp.tokens_u = self._tokens_u(pool, users, token_delta)
        # no gang members by eligibility, but a gang that admitted last
        # cycle must still shed its stale deferral reason
        self.matcher.last_admission_deferred[pool.name] = {}
        pp.flags = flags
        self._pack_caps(pp, pool)
        return pp

    def _gang_cohort_admission(self, pool: Pool, groups_ctx: Dict,
                               members_by_gang: Dict,
                               launch_ok: np.ndarray, net_tokens,
                               spec_masked=None) -> set:
        """Host-side gang-cohort admission for the fused pack paths
        (mirrors Matcher.considerable_jobs, docs/GANG.md): a gang that
        cannot clear this cycle's throttles WHOLE is withheld whole by
        clearing its members' launch_ok bits.  The device admits rows
        in rank order until tokens/caps run out, so a straddling cohort
        would admit partial, match, and be reset by the reduction —
        burning capacity every cycle when the budget can never cover
        the gang, with a capacity-shaped explanation for what is a
        rate-limit condition.  (Token/cap contention with earlier
        singles can still split a cohort transiently on device; the
        reduction drops it that cycle and the refilled budget admits it
        whole later.)

        ``members_by_gang``: group uuid -> [(task_row, job)] for the
        pack's pending gang members; ``net_tokens``: user -> launch
        tokens net of the pipeline's token_delta, or None when the
        limiter is off; ``spec_masked``: the pipeline's speculative
        in-flight rows.  Returns the pack-time SATISFIED elastic-gang
        set (the megakernel gang wire excludes those gangs exactly like
        the host reduction does)."""
        deferred_why: Dict[str, Dict] = {}
        skipped: List = []
        satisfied = set()
        if members_by_gang:
            from ..state.schema import gang_bounds, gang_is_elastic
            from .elastic import satisfied_gangs
            mc = self.config.matcher_for_pool(pool.name)
            backoff = self.matcher._backoff.setdefault(
                pool.name, _BackoffState(mc.max_jobs_considered))
            nc = min(backoff.num_considerable, mc.max_jobs_considered)
            mgr = self.matcher.elastic
            if mgr is not None:
                mgr.start_pool_cycle(pool.name)
            satisfied = satisfied_gangs(
                self.store, {guuid: groups_ctx.get(guuid)
                             for guuid in members_by_gang
                             if groups_ctx.get(guuid) is not None}) or set()
            for guuid, members in members_by_gang.items():
                g = groups_ctx.get(guuid)
                if not getattr(g, "gang", False):
                    continue
                if guuid in satisfied:
                    # GROW path (docs/GANG.md elasticity): the gang runs
                    # at >= min, so its waiting members admit like
                    # singles — capped at gang_max, then metered by the
                    # optimizer's grow budget
                    headroom = self.store.gang_growth_headroom(guuid)
                    grow_skipped: List[str] = []
                    max_skipped: List[str] = []
                    for row, j in members:
                        if not launch_ok[row]:
                            continue
                        if headroom < 1:
                            launch_ok[row] = False
                            max_skipped.append(j.uuid)
                            continue
                        if mgr is not None \
                                and not mgr.admit_grow(pool.name):
                            launch_ok[row] = False
                            grow_skipped.append(j.uuid)
                            continue
                        headroom -= 1
                    reasons = {}
                    if grow_skipped:
                        reasons["gang-grow-deferred"] = grow_skipped
                    if max_skipped:
                        reasons["gang-at-max"] = max_skipped
                    if reasons:
                        _audit.note_skips(self.store.audit, reasons,
                                          pool=pool.name)
                    continue
                # cohort size: gang_size for rigid gangs (bit-identical
                # to the pre-elastic admission), gang_min for elastic
                size = gang_bounds(g)[0] if gang_is_elastic(g) \
                    else int(getattr(g, "gang_size", 0) or 0)
                if not size:
                    continue
                if gang_is_elastic(g):
                    # surplus beyond the cohort is capped by the growth
                    # headroom: admit at most max(size, headroom)
                    # members so an unsatisfied elastic gang cannot
                    # overshoot gang_max through the min-threshold
                    # reduction's partial packing (the cohort itself
                    # always admits — it restores legality)
                    allowed = int(max(
                        size, self.store.gang_growth_headroom(guuid)))
                    over = [(row, j) for row, j in members[allowed:]
                            if launch_ok[row]]
                    if over:
                        for row, _j in over:
                            launch_ok[row] = False
                        _audit.note_skips(
                            self.store.audit,
                            {"gang-at-max": [j.uuid for _r, j in over]},
                            pool=pool.name)
                        members = members[:allowed]
                if len(members) < size:
                    reason = "members-missing"
                elif size > nc:
                    reason = "considerable-cap"
                elif sum(1 for row, _j in members
                         if launch_ok[row]) < size:
                    if spec_masked is not None and all(
                            launch_ok[row] or spec_masked[row]
                            for row, _j in members):
                        # every withheld member is the pipeline's
                        # speculative in-flight footprint: the gang is
                        # mid-launch in the overlapped cycle, not
                        # filter/quota-denied — withhold the rest whole
                        # with no deferral reason (reconcile re-surfaces
                        # the gang if the overlapped launch conflicts)
                        extra = []
                        for row, j in members:
                            if launch_ok[row]:
                                launch_ok[row] = False
                                extra.append(j.uuid)
                        if extra:
                            _audit.note_skips(
                                self.store.audit,
                                {"pipeline-speculative": extra},
                                pool=pool.name)
                        continue
                    reason = "member-denied"
                elif net_tokens is not None \
                        and net_tokens(members[0][1].user) < size:
                    reason = "rate-limited"
                else:
                    continue
                for row, job in members:
                    if launch_ok[row]:
                        launch_ok[row] = False
                        skipped.append((job.uuid, {"why": reason}))
                deferred_why[guuid] = {"size": size, "reason": reason}
        # set every cycle, like considerable_jobs on the split path, so
        # a gang that admitted this cycle sheds last cycle's reason
        self.matcher.last_admission_deferred[pool.name] = deferred_why
        if skipped:
            _audit.note_skips(self.store.audit,
                              {"gang-deferred": skipped}, pool=pool.name)
        return satisfied

    def _pack_caps(self, pp: _PackedPool, pool: Pool) -> None:
        """Backoff cap + pool/quota-group caps (shared by both pack paths)."""
        cfg = self.config
        mc = cfg.matcher_for_pool(pool.name)
        backoff = self.matcher._backoff.setdefault(
            pool.name, _BackoffState(mc.max_jobs_considered))
        pp.num_considerable = min(backoff.num_considerable,
                                  mc.max_jobs_considered)
        q = cfg.pool_quota(pool.name)
        if q is not None:
            pp.pool_quota = _pool_quota_vec(q)
        gname = cfg.quota_groups.get(pool.name)
        gq = cfg.quota_group_quotas.get(gname) if gname else None
        if gq is not None:
            pp.group_quota = _pool_quota_vec(gq)

    def _pack_pool(self, scheduler, pool: Pool, exclude=None,
                   token_delta=None) -> Optional[_PackedPool]:
        if self.config.columnar_index:
            return self._pack_pool_columnar(scheduler, pool,
                                            exclude=exclude,
                                            token_delta=token_delta)
        return self._pack_pool_entities(scheduler, pool, exclude=exclude,
                                        token_delta=token_delta)

    def _pack_pool_entities(self, scheduler, pool: Pool, exclude=None,
                            token_delta=None) -> Optional[_PackedPool]:
        """The entity pack (``columnar_index=False``): the pool's pending
        jobs and running instances as entities, grouped per user
        (``build_user_tasks``) into the rank arrays, per-row demands and
        a DENSE [T, H] constraint mask for the dense-mask cycle."""
        store, cfg = self.store, self.config
        from ..ops import host_prep
        from .ranker import _quota_vec, build_user_tasks
        pending = store.pending_jobs(pool.name)
        pp = _PackedPool(pool)
        pp.columnar = False
        if not pending:
            return None
        running = store.running_instances(pool.name)
        uts, id2job = build_user_tasks(pending, running)
        shares = {ut.user: tuple(
            store.get_share(ut.user, pool.name).get(d, INF)
            for d in ("cpus", "mem", "gpus")) for ut in uts}
        quotas = {ut.user: _quota_vec(store.get_quota(ut.user, pool.name))
                  for ut in uts}
        arrays, task_ids = host_prep.pack_rank_inputs(
            uts, shares, quotas, pad=False)
        T = arrays["usage"].shape[0]
        pp.task_ids, pp.id2job, pp.arrays, pp.n_tasks = \
            task_ids, id2job, arrays, T

        # offers from every cluster serving this pool; breaker-filtered:
        # a tripped cluster contributes no offers, so the cycle routes
        # demand at healthy clusters
        offers: List[Offer] = []
        for cluster in scheduler.launchable_clusters(pool.name):
            offers.extend(cluster.pending_offers(pool.name))
        pp.offers = offers
        pp.n_hosts = len(offers)

        jobs_in_rows = [pp.id2job[t] for t in task_ids]
        pend_rows = arrays["pending"]

        # per-row match resources (running rows never matched, zeroed)
        pp.job_res = np.stack(
            [[j.resources.cpus, j.resources.mem, j.resources.gpus,
              j.resources.disk] for j in jobs_in_rows]).astype(F32) \
            * pend_rows[:, None]

        # constraint mask for pending rows (running rows all-False)
        if offers:
            pend_idx = np.flatnonzero(pend_rows)
            pend_jobs = [jobs_in_rows[i] for i in pend_idx]
            ctx = self.matcher._constraint_context(
                pend_jobs, scheduler.reserved_hosts)
            self.matcher._fill_cotask_host_attributes(
                ctx, pool.name, offers, scheduler.clusters)
            pp.ctx = ctx
            sub = build_constraint_mask(pend_jobs, offers, ctx)
            cmask = np.zeros((T, len(offers)), dtype=bool)
            cmask[pend_idx] = sub
            pp.cmask = cmask
            pp.avail = np.array(
                [[o.available.cpus, o.available.mem, o.available.gpus,
                  o.available.disk] for o in offers], dtype=F32)
            pp.capacity = np.array(
                [[o.capacity.cpus, o.capacity.mem, o.capacity.gpus,
                  o.capacity.disk] for o in offers], dtype=F32)
        else:
            pp.cmask = np.zeros((T, 1), dtype=bool)
            pp.avail = np.zeros((1, 4), dtype=F32)
            pp.capacity = np.zeros((1, 4), dtype=F32)
            pp.n_hosts = 0

        # offensive-job filter -> enqueue_ok (scheduler.clj:2205-2257)
        enqueue_ok = np.ones(T, dtype=bool)
        limits = cfg.offensive_job_limits
        if limits is not None:
            max_mem_mb = limits.memory_gb * 1024.0
            for i, j in enumerate(jobs_in_rows):
                if pend_rows[i] and (j.resources.mem > max_mem_mb
                                     or j.resources.cpus > limits.cpus):
                    enqueue_ok[i] = False
                    pp.offensive.append(j)
        pp.enqueue_ok = enqueue_ok

        # plugin launch verdicts -> launch_ok (cached accept/defer)
        launch_ok = np.ones(T, dtype=bool)
        for i, j in enumerate(jobs_in_rows):
            if pend_rows[i] and not self.plugins.launch_allowed(j):
                launch_ok[i] = False
        # pipelined-driver speculation mask (entity-pack form: by uuid)
        spec_masked = None
        if exclude is not None:
            kind, _epoch, uuids = exclude
            if kind == "uuids" and uuids:
                spec_masked = np.zeros(T, dtype=bool)
                masked_uuids = []
                for i, j in enumerate(jobs_in_rows):
                    if pend_rows[i] and launch_ok[i] and j.uuid in uuids:
                        launch_ok[i] = False
                        spec_masked[i] = True
                        masked_uuids.append(j.uuid)
                if masked_uuids:
                    _audit.note_skips(
                        store.audit,
                        {"pipeline-speculative": masked_uuids},
                        pool=pool.name)
        pp.launch_ok = launch_ok

        # launch-rate token budgets, per user broadcast to tasks
        launch_rl = self.rate_limits.job_launch
        user_tokens: Dict[str, float] = {}
        if launch_rl.enforce:
            from ..policy import pool_user_key
            user_tokens = {
                ut.user: launch_rl.get_token_count(
                    pool_user_key(pool.name, ut.user)) for ut in uts}
            if token_delta:
                # overlapped in-flight spends not yet on the limiter
                user_tokens = {
                    u: max(t - token_delta.get(u, 0.0), 0.0)
                    for u, t in user_tokens.items()}
            tok = np.array([user_tokens[pp.id2job[t].user]
                            for t in task_ids], dtype=F32)
        else:
            tok = np.full(T, INF, dtype=F32)
        pp.tokens = tok

        # gang-cohort admission (see the columnar pack / helper doc); the
        # dense pack stages no gang wire: its gangs take the host
        # reduction at apply
        gang_members: Dict[str, List] = {}
        if offers and pp.ctx is not None:
            for i, job in zip(pend_idx, pend_jobs):
                if job.group is not None and getattr(
                        pp.ctx.groups.get(job.group), "gang", False):
                    gang_members.setdefault(job.group, []).append(
                        (int(i), job))
        self._gang_cohort_admission(
            pool, pp.ctx.groups if pp.ctx is not None else {},
            gang_members, launch_ok,
            (lambda u: user_tokens.get(u, 0.0))
            if launch_rl.enforce else None,
            spec_masked=spec_masked)

        self._pack_caps(pp, pool)
        return pp

    # ------------------------------------------------------------------ step
    def stage(self, scheduler, exclude=None, avail_delta=None,
              token_delta=None) -> "_StagedCycle":
        """Phase 1 of a cycle: host-side staging.  Packs every active
        non-direct pool off the store and stages each DRU-mode group's
        wire (resident rows/flags synced, the rest uploaded).

        The optional arguments are the pipelined driver's optimistic-
        concurrency hooks (sched/pipeline.py, Omega-style):

        - ``exclude``: pool name -> ("rows", index compaction epoch, task
          rows) for a columnar pack, ("uuids", -1, job uuids) for an
          entity pack — launch candidates a fetched-but-not-yet-applied
          overlapped cycle is about to consume; they are withheld from
          this cycle's launch_ok so back-to-back cycles don't fight over
          the head of the queue.
        - ``avail_delta``: (cluster, hostname) -> f32[4] — the resources
          those candidates will consume, subtracted from the staged offer
          availability so this cycle's speculative placements stay
          feasible even though the store doesn't show the launches yet.
        - ``token_delta``: pool name -> user -> launch-rate tokens those
          candidates will spend, subtracted from the staged per-user
          token budgets.

        All are None on the sync path."""
        _faults.fire("fused.dispatch")

        pools = [p for p in self.store.pools()
                 if p.state == "active"
                 and p.scheduler is not SchedulerKind.DIRECT]
        packed: List[_PackedPool] = []
        excl = exclude or {}
        tokd = token_delta or {}
        pack_t0 = time.perf_counter()
        with tracing.span("cycle.rank"), tracing.span("fused.pack"):
            for pool in pools:
                pp = self._pack_pool(scheduler, pool,
                                     exclude=excl.get(pool.name),
                                     token_delta=tokd.get(pool.name))
                if pp is not None:
                    packed.append(pp)
            # the columnar packs must share ONE index compaction epoch
            # (the base mirror holds one generation): re-pack stragglers,
            # and drop a pool whose re-pack is still stale or empty
            epochs = {pp.base_compactions for pp in packed if pp.columnar}
            if len(epochs) > 1:
                latest = max(epochs)
                refreshed = []
                for pp in packed:
                    if pp.columnar and pp.base_compactions != latest:
                        pp = self._pack_pool(
                            scheduler, pp.pool,
                            exclude=excl.get(pp.pool.name),
                            token_delta=tokd.get(pp.pool.name))
                        if pp is None or (pp.columnar and
                                          pp.base_compactions != latest):
                            continue
                    refreshed.append(pp)
                packed = refreshed
        self.last_pack_ms = (time.perf_counter() - pack_t0) * 1000.0
        _flight.note_phase_detail("pack", self.last_pack_ms)
        if avail_delta:
            for pp in packed:
                for h, o in enumerate(pp.offers):
                    d = avail_delta.get((o.cluster, o.hostname))
                    if d is not None:
                        pp.avail[h] = np.maximum(pp.avail[h] - d, 0.0)
        staged = _StagedCycle(pools)
        if not packed:
            return staged
        by_mode: Dict[bool, List[_PackedPool]] = {}
        for pp in packed:
            by_mode.setdefault(pp.pool.dru_mode is DruMode.GPU, []).append(pp)
        for gpu_mode, group in by_mode.items():
            staged.groups.append(self._stage_group(gpu_mode, group))
        return staged

    def _stage_group(self, gpu_mode: bool,
                     group: List[_PackedPool]) -> "_StagedGroup":
        """Fold quota-group caps and stage one DRU-mode group's wire:
        the stacked, padded host arrays (numpy, as the reference builds
        them), the base mirror, the resident rows/flags, then
        :func:`stage_slot_wires`."""
        # member pools NOT in this dispatch still consume their quota
        # group's cap: their running usage is folded into it here
        gids: Dict[str, int] = {}
        in_dispatch = {pp.pool.name for pp in group}
        missing_by_group: Dict[str, np.ndarray] = {}

        def missing_usage(gname: str) -> np.ndarray:
            m = missing_by_group.get(gname)
            if m is None:
                m = np.zeros(4, dtype=F32)
                idx = (self.store.ensure_index()
                       if self.config.columnar_index else None)
                for member, g in self.config.quota_groups.items():
                    if g != gname or member in in_dispatch:
                        continue
                    if idx is not None:
                        m += idx.pool_usage_base(member)
                        continue
                    for job, _i in self.store.running_instances(member):
                        m += [job.resources.cpus, job.resources.mem,
                              job.resources.gpus, 1.0]
                missing_by_group[gname] = m
            return m

        for pp in group:
            gname = self.config.quota_groups.get(pp.pool.name)
            if not gname:
                continue
            pp.group_id = gids.setdefault(gname, len(gids))
            pp.group_quota = (pp.group_quota
                              - missing_usage(gname)).astype(F32)
        T = bucket(max(pp.n_tasks for pp in group))
        H = bucket(max(max(pp.n_hosts, 1) for pp in group))
        # the pool axis divides over the mesh's slots: padding pools hold
        # no valid row and belong to no quota group
        n_dev = self.mesh().size
        P = max(n_dev, -(-len(group) // n_dev) * n_dev)
        pad = P - len(group)
        stage_t0 = time.perf_counter()
        avail_p = np.zeros((P, H, 4), dtype=F32)
        cap_p = np.zeros((P, H, 4), dtype=F32)
        for i, pp in enumerate(group):
            avail_p[i, :pp.avail.shape[0]] = pp.avail
            cap_p[i, :pp.capacity.shape[0]] = pp.capacity
        scalars = dict(
            num_considerable=np.array(
                [pp.num_considerable for pp in group] + [0] * pad,
                dtype=np.int32),
            pool_quota=np.stack([pp.pool_quota for pp in group]
                                + [np.full(4, INF, F32)] * pad),
            group_quota=np.stack([pp.group_quota for pp in group]
                                 + [np.full(4, INF, F32)] * pad),
            group_id=np.array([pp.group_id for pp in group] + [-1] * pad,
                              dtype=np.int32))
        # the static match cap: the configured max_jobs_considered (at
        # least every pool's dynamic num_considerable), bucketed
        cap = bucket(max(
            self.config.matcher_for_pool(pp.pool.name).max_jobs_considered
            for pp in group))
        if not group[0].columnar:
            return self._stage_dense(gpu_mode, group, T, H, avail_p, cap_p,
                                     scalars, cap, stage_t0)
        # every pack of the group shares one compaction epoch (stage
        # re-packs or drops stale pools), so the mirror's rows are valid
        # for all of them
        epoch = max(pp.base_compactions for pp in group)
        assert all(pp.base_compactions == epoch for pp in group), \
            [pp.base_compactions for pp in group]
        base_pp = max(group, key=lambda pp: pp.res_base.shape[0])
        # the device base mirror: a full upload on a compaction epoch
        # change or a capacity overflow, else the rows added since
        mir_res, mir_disk = self._mirror.sync(
            base_pp.res_base, base_pp.disk_base, epoch)
        E = bucket(max(max(len(pp.exc_rows), pp.exc_mask.shape[0])
                       for pp in group), minimum=8)
        U = bucket(max(pp.shares_u.shape[0] for pp in group), minimum=8)
        rows_p = np.zeros((P, T), dtype=np.int32)
        flags_p = np.zeros((P, T), dtype=np.uint8)
        exc_rows_p = np.full((P, E), -1, dtype=np.int32)
        exc_mask_p = np.zeros((P, E, H), dtype=bool)
        host_gpu_p = np.zeros((P, H), dtype=bool)
        # padding hosts stay blocked so zero-resource jobs never land there
        host_blocked_p = np.ones((P, H), dtype=bool)
        shares_u_p = np.full((P, U, 3), INF, dtype=F32)
        quota_u_p = np.full((P, U, 4), INF, dtype=F32)
        tokens_u_p = np.full((P, U), INF, dtype=F32)
        for i, pp in enumerate(group):
            rows_p[i, :pp.n_tasks] = pp.rows_s
            flags_p[i, :pp.n_tasks] = pp.flags
            exc_rows_p[i, :len(pp.exc_rows)] = pp.exc_rows
            e, h = pp.exc_mask.shape
            exc_mask_p[i, :e, :h] = pp.exc_mask
            host_gpu_p[i, :pp.host_gpu.shape[0]] = pp.host_gpu
            host_blocked_p[i, :pp.host_blocked.shape[0]] = pp.host_blocked
            shares_u_p[i, :pp.shares_u.shape[0]] = pp.shares_u
            quota_u_p[i, :pp.quota_u.shape[0]] = pp.quota_u
            tokens_u_p[i, :pp.tokens_u.shape[0]] = pp.tokens_u
        rs = slot_rows = None
        resident = bool(self.config.resident_pack)
        if resident:
            # steady state ships only the scatter delta of [P, T]
            key = (tuple(pp.pool.name for pp in group), P, T)
            rs = self._sync_resident(gpu_mode, key, rows_p, flags_p, epoch)
            slot_rows = [(r.rows_dev, r.flags_dev) for r in rs.slots]
        mega = stage_slot_wires(
            self.mesh(), rows_p=rows_p, flags_p=flags_p,
            n_tasks=[pp.n_tasks for pp in group] + [0] * pad,
            res_base=mir_res, disk_base=mir_disk, tokens_u_p=tokens_u_p,
            shares_u_p=shares_u_p, quota_u_p=quota_u_p, scalars=scalars,
            host_gpu_p=host_gpu_p, host_blocked_p=host_blocked_p,
            exc_rows_p=exc_rows_p, exc_mask_p=exc_mask_p, avail_p=avail_p,
            cap_p=cap_p,
            gang_wires=[pp.gang_wire for pp in group] + [None] * pad,
            quantize=bool(self.config.quantized_wire),
            scales=self._mega_scales, slot_rows=slot_rows,
            resident=resident)
        stage_ms = (time.perf_counter() - stage_t0) * 1000.0
        _flight.note_phase_detail("stage", stage_ms)
        return _StagedGroup(gpu_mode=gpu_mode, group=group, cap=cap, T=T,
                            H=H, stage_ms=stage_ms, mega=mega,
                            resident=resident, sync=rs)

    def _stage_dense(self, gpu_mode: bool, group: List[_PackedPool],
                     T: int, H: int, avail_p: np.ndarray, cap_p: np.ndarray,
                     scalars: Dict[str, np.ndarray], cap: int,
                     stage_t0: float) -> "_StagedGroup":
        """Stage an entity-pack group: the stacked dense PoolCycleInputs
        arrays (padded as the reference pads them, ``cmask_p`` the dense
        [P, T, H] mask), recast as the dense wire
        (``ops/pallas_cycle.dense_wire``) and uploaded by
        :func:`stage_slot_wires`; the usage rows the wire's identity rows
        index are uploaded beside it (no base mirror, no resident
        buffers: the dense form is rebuilt every cycle, as the
        reference's is)."""
        P = avail_p.shape[0]

        def stack(fn, fill, dtype):
            out = []
            for pp in group:
                a = np.asarray(fn(pp))
                out.append(pad_to(a, T, fill=fill))
            out += [np.full_like(out[0], fill)] * (P - len(group))
            return np.stack(out).astype(dtype)

        arr = lambda k, fill, dt: stack(lambda pp: pp.arrays[k], fill, dt)
        cmask_p = np.zeros((P, T, H), dtype=bool)
        for i, pp in enumerate(group):
            cmask_p[i, :pp.n_tasks, :pp.cmask.shape[1]] = pp.cmask
        fields = dict(
            usage=arr("usage", 0, F32), quota=arr("quota", INF, F32),
            shares=arr("shares", INF, F32),
            first_idx=arr("first_idx", 0, np.int32),
            user_rank=arr("user_rank", 2 ** 31 - 1, np.int32),
            pending=arr("pending", False, bool),
            valid=arr("valid", False, bool),
            enqueue_ok=stack(lambda pp: pp.enqueue_ok, False, bool),
            launch_ok=stack(lambda pp: pp.launch_ok, False, bool),
            tokens=stack(lambda pp: pp.tokens, 0.0, F32),
            job_res=stack(lambda pp: pp.job_res, 0.0, F32),
            cmask=cmask_p, avail=avail_p, capacity=cap_p, **scalars)
        w = pallas_cycle.dense_wire(fields)
        dev = self.device
        res_base = torch.from_numpy(w["res_base"]).to(dev)
        disk_base = torch.from_numpy(w["disk_base"]).to(dev)
        mega = stage_slot_wires(
            self.mesh(), rows_p=w["rows"], flags_p=w["flags"],
            n_tasks=[T] * P,
            res_base=res_base, disk_base=disk_base,
            tokens_u_p=w["tokens_u"], shares_u_p=w["shares_u"],
            quota_u_p=w["quota_u"], scalars=scalars,
            host_gpu_p=np.zeros((P, H), dtype=bool),
            host_blocked_p=np.ones((P, H), dtype=bool),
            exc_rows_p=w["exc_rows"], exc_mask_p=w["exc_mask"],
            avail_p=avail_p, cap_p=cap_p, gang_wires=[None] * P,
            quantize=bool(self.config.quantized_wire),
            scales=self._mega_scales)
        mega["h2d_bytes"] += w["res_base"].nbytes + w["disk_base"].nbytes
        stage_ms = (time.perf_counter() - stage_t0) * 1000.0
        _flight.note_phase_detail("stage", stage_ms)
        return _StagedGroup(gpu_mode=gpu_mode, group=group, cap=cap, T=T,
                            H=H, stage_ms=stage_ms, mega=mega, dense=True)

    def _launch(self, wires, **kw):
        """The cycle over :meth:`mesh`, one wire a slot
        (``parallel/sharded.mesh_megacycle``: each slot's block through
        the stage chain, K1-K6 on a card and their plain versions on the
        CPU; one slot is ``ops/stages.megacycle_stages``, launch for
        launch).  The dispatch and the warmup both run it."""
        return mesh_megacycle(
            self.mesh(), wires,
            max_over_quota_jobs=self.config.max_over_quota_jobs, **kw)

    def dispatch_group(self, sg: "_StagedGroup") -> "_GroupDispatch":
        """Phase 2: launch the cycle on one staged group (:meth:`_launch`:
        K1-K6 on a card) and start the copy of the six compact outputs
        into one pinned host buffer right behind it, so a later
        :meth:`fetch_group` overlaps the transfer with whatever the host
        does in between.  The event recorded after the copy marks this
        cycle's outputs complete; both fetches wait on it alone, never on
        a later cycle enqueued behind it.  A failed launch raises."""
        m = sg.mega
        telemetry.profile_upload(sg.stage_ms,
                                 [t for w in m["wires"] for t in w])
        telemetry.count_transfer("h2d", m["h2d_bytes"])
        with tracing.span("fused.dispatch", pools=len(sg.group),
                          tasks=sg.T, hosts=sg.H, gpu=sg.gpu_mode,
                          stage_ms=sg.stage_ms, megakernel=True):
            res = self._launch(
                m["wires"], gpu_mode=sg.gpu_mode,
                considerable_cap=min(sg.cap, sg.T),
                rows_codec=m["rows_codec"], avail_scale=m["avail_scale"],
                cap_scale=m["cap_scale"])
            outs = [getattr(res, k).to(torch.int32).reshape(-1)
                    for k in _FETCHED]
            flat = torch.cat(outs)
            event = None
            if flat.is_cuda:
                host = torch.empty(flat.shape, dtype=torch.int32,
                                   pin_memory=True)
                host.copy_(flat, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = flat
        _flight.note_path("megakernel")
        return _GroupDispatch(sg, res, host, event,
                              [(k, tuple(getattr(res, k).shape))
                               for k in _FETCHED])

    def fetch_group(self, gd: "_GroupDispatch"):
        """Phase 3: one wait for the compact outputs' copy, then the six
        host arrays (cand_row, cand_assign, cand_qpos, n_queue, cand_gang,
        cand_dropped).  Idempotent."""
        if gd.fetched is None:
            with tracing.span("fused.fetch"), \
                    telemetry.sync_wait("fused.fetch"):
                if gd.event is not None:
                    gd.event.synchronize()
                flat = gd.host.numpy()
            out, at = [], 0
            for _k, shape in gd.sizes:
                n = int(np.prod(shape))
                out.append(flat[at:at + n].reshape(shape))
                at += n
            gd.fetched = tuple(out)
            telemetry.count_transfer("d2h", flat.nbytes)
        return gd.fetched

    def apply_group(self, scheduler, gd: "_GroupDispatch", queues,
                    results, reconciler=None) -> None:
        """Phase 4: map one fetched group's outputs back to entities and
        run the transactional launch per pool, with K6's gang verdicts
        (post-reduction assignment and drop mask a slot).
        ``reconciler`` is the pipelined driver's pre-launch re-validation
        hook (see :meth:`_apply_pool`)."""
        cand_row, cand_assign, cand_qpos, n_queue, cand_gang, dropped = \
            self.fetch_group(gd)
        apply_t0 = time.perf_counter()
        with tracing.span("cycle.launch", pools=len(gd.sg.group)):
            for i, pp in enumerate(gd.sg.group):
                self._apply_pool(scheduler, pp, cand_row[i],
                                 cand_assign[i], cand_qpos[i],
                                 int(n_queue[i]), gd.res.queue_rows, i,
                                 queues, results, reconciler=reconciler,
                                 gang_pre=(cand_gang[i], dropped[i]),
                                 done=gd.event)
        _flight.note_phase_detail(
            "apply", (time.perf_counter() - apply_t0) * 1000.0)

    def step(self, scheduler) -> Tuple[Dict[str, List[Job]],
                                       Dict[str, MatchCycleResult]]:
        """One synchronous cycle over all active non-direct pools: stage
        -> dispatch -> fetch -> apply, group by group.  Returns (pending
        queues, match results); direct pools are the scheduler's."""
        staged = self.stage(scheduler)
        queues: Dict[str, List[Job]] = {p.name: [] for p in staged.pools}
        results: Dict[str, MatchCycleResult] = {}
        for sg in staged.groups:
            with tracing.span("cycle.match", pools=len(sg.group),
                              tasks=sg.T, hosts=sg.H, gpu=sg.gpu_mode):
                gd = self.dispatch_group(sg)
                self.fetch_group(gd)
            self.apply_group(scheduler, gd, queues, results)
        return queues, results

    # ----------------------------------------------------------------- apply
    def _apply_pool(self, scheduler, pp: _PackedPool, cand_row, cand_assign,
                    cand_qpos, n_queue: int, queue_rows_dev, pool_slot: int,
                    queues, results, reconciler=None, gang_pre=None,
                    done=None) -> None:
        """Map one pool's COMPACT kernel outputs back to entities: queue
        refresh, within-batch group validation, backoff bookkeeping,
        transactional launch.

        ``cand_row``/``cand_assign``/``cand_qpos`` are the [C] admitted-slot
        arrays (-1 = empty slot); the rank-ordered queue rows stay on device
        in ``queue_rows_dev[pool_slot]`` and are fetched only when a queue
        consumer materializes them, on a side stream that waits on
        ``done`` (the dispatch's event) alone.

        ``reconciler`` is the pipelined driver's Omega-style pre-launch
        re-validation (sched/pipeline.py): called with (pp, cand_jobs,
        cand_host), returns (state_drop, resource_drop) bool masks over
        the candidates.  State conflicts (no longer WAITING — launched by
        an overlapped cycle, or killed since the pack) are removed
        outright and pruned from the published queue; resource conflicts
        (the host's availability was consumed by an overlapped launch the
        staged snapshot didn't see) fall back to unmatched and retry next
        cycle.  Never passed on the sync path."""
        pool_name = pp.pool.name
        # this pool's row of the [P, T] output, a view: the published
        # queue's closure keeps that output's storage alive until the
        # next cycle replaces the queue, but not the rest of pp
        dev_rows = queue_rows_dev[pool_slot]
        rows_s = pp.rows_s
        fetched_rows: List[Optional[np.ndarray]] = [None]
        if dev_rows.is_cuda and self._queue_stream is None:
            self._queue_stream = torch.cuda.Stream(self.device)
        stream = self._queue_stream

        def fetch_local_rows() -> np.ndarray:
            # one device->host transfer of exactly n_queue i32 rows, paid
            # only when some consumer (rebalancer, /queue page, direct-pool
            # logic) actually touches the published queue
            if fetched_rows[0] is None:
                with telemetry.sync_wait("queue.rows"):
                    fetched_rows[0] = fetch_rows(dev_rows, n_queue, done,
                                                 stream)
                telemetry.count_transfer("d2h", fetched_rows[0].nbytes)
            return fetched_rows[0]

        def local_rows_with_drops(drop_qpos) -> np.ndarray:
            rows = fetch_local_rows()
            if drop_qpos is not None and len(drop_qpos):
                # post-match queue prune (native/pack.cpp when built)
                rows = native_pack.prune_rows(rows, np.unique(drop_qpos))
            return rows

        def publish_queue(drop_qpos=None):
            if not pp.columnar:
                # the entity pack's queue: its jobs in rank order
                queues[pool_name] = [
                    pp.id2job[pp.task_ids[r]]
                    for r in local_rows_with_drops(drop_qpos)]
                return
            # lazy queue straight over the index BASE snapshots; the row
            # selection itself is DEFERRED (device fetch + drop filter
            # run on first touch), and full-column gathers happen only if
            # someone reads .uuids/.resources/.users
            from .ranker import RankedQueue
            n = n_queue - (len(drop_qpos) if drop_qpos is not None else 0)
            queues[pool_name] = RankedQueue(
                self.store, pp.uuid_base, pp.res_base, pp.user_base,
                rows_fn=lambda drop=drop_qpos:
                    rows_s[local_rows_with_drops(drop)],
                n=n)

        scheduler._stifle_offensive(pp.offensive)

        result = MatchCycleResult()
        slots = np.flatnonzero(cand_row >= 0)
        result.considered = len(slots)
        # K6's gang verdicts: usable only while the candidate view the
        # kernel reduced over stays INTACT — any vanished job, clip, or
        # group-placement reset below invalidates them
        # and the host reduction recomputes (identical math,
        # ops/gang.py; parity-asserted).  A pool that staged no gang
        # wire has all -1 gang ids, which would read as "nothing
        # dropped"
        gang_ok = gang_pre is not None and pp.gang_wire is not None
        if pp.columnar:
            uuid_prefix = pp.uuid_base[pp.rows_s[cand_row[slots]]]
            fetched = self.store.jobs_bulk([str(u) for u in uuid_prefix])
            cand_jobs, cand_keep = [], []
            for s, job in zip(slots, fetched):
                if job is not None:
                    cand_jobs.append(job)
                    cand_keep.append(s)
            if len(cand_keep) != len(slots):
                gang_ok = False
            slots = np.array(cand_keep, dtype=np.int64)
        else:
            cand_jobs = [pp.id2job[pp.task_ids[r]] for r in cand_row[slots]]
        # per-job rank attribution for the fetched candidate slots
        # (bounded by the considerable cap, never [T]-sized): the
        # device-computed queue position, straight off the compact
        # outputs already on host (utils/audit.py)
        if len(slots):
            self.store.audit.ranked(
                [j.uuid for j in cand_jobs],
                [int(q) for q in cand_qpos[slots]], pool_name,
                users=[j.user for j in cand_jobs])
        if len(slots) == 0 or not pp.offers:
            # mirror Matcher.match_pool: an empty cycle returns the
            # considerable set unmatched and leaves backoff untouched
            result.unmatched = cand_jobs
            publish_queue()
            results[pool_name] = result
            return

        cand_host = cand_assign[slots].astype(np.int64)
        # clip padding-host assignments (can't happen: padding hosts have
        # zero capacity and all-False masks, but stay defensive)
        clipped = cand_host >= len(pp.offers)
        if clipped.any():
            cand_host[clipped] = -1
            gang_ok = False
        conflict_qpos = None
        res_conflict = None
        dropped_head_matched = False
        if reconciler is not None:
            with tracing.span("fused.reconcile", pool=pool_name,
                              candidates=len(slots)):
                state_drop, res_drop = reconciler(pp, cand_jobs, cand_host)
            # a dropped HEAD that held an assignment DID match (it
            # launched one cycle earlier, or the overlap consumed its
            # host): backoff must not shrink for a transient conflict
            dropped_head_matched = bool(
                (state_drop[0] or res_drop[0]) and cand_host[0] >= 0) \
                if len(slots) else False
            if state_drop.any() or res_drop.any():
                gang_ok = False
            if res_drop.any():
                cand_host[res_drop] = -1
            if state_drop.any():
                qp = cand_qpos[slots[state_drop]]
                conflict_qpos = qp[qp >= 0]
                keep = ~state_drop
                slots = slots[keep]
                cand_jobs = [j for j, k in zip(cand_jobs, keep) if k]
                cand_host = cand_host[keep]
                res_drop = res_drop[keep]
            res_conflict = res_drop if res_drop.any() else None
            if len(slots) == 0:
                # every candidate conflicted away: like the empty cycle,
                # leave backoff untouched (the head DID match — it just
                # launched one cycle earlier than this stale snapshot saw)
                publish_queue(conflict_qpos)
                result.queue_pruned = conflict_qpos is not None \
                    and len(conflict_qpos) > 0
                results[pool_name] = result
                return
        pre_validate = cand_host.copy()
        cand_host = validate_group_placement(
            cand_jobs, cand_host, pp.offers, pp.ctx)
        if gang_ok and (cand_host != pre_validate).any():
            # a within-batch placement rule reset an assignment after
            # the kernel's gang stage saw it: the fused verdict is stale
            gang_ok = False
        # gang all-or-nothing over the fetched candidates (ops/gang.py,
        # docs/GANG.md): partial gangs reset to unmatched with their
        # capacity refilled to group-less candidates in the SAME cycle.
        # Under the pipelined driver a reconcile-dropped member already
        # left its gang incomplete, so a conflicted gang drops atomically
        # here.  Structural no-op when no candidate is a gang member.
        groups_ctx = pp.ctx.groups if pp.ctx is not None else {}
        if any(j.group is not None
               and getattr(groups_ctx.get(j.group), "gang", False)
               for j in cand_jobs):
            from ..ops.gang import apply_gang_cycle
            from .elastic import satisfied_gangs
            H = len(pp.offers)
            cand_res = np.array(
                [[j.resources.cpus, j.resources.mem, j.resources.gpus,
                  j.resources.disk] for j in cand_jobs], dtype=F32)
            satisfied = satisfied_gangs(self.store, groups_ctx)
            if gang_ok:
                # the fused gang stage's membership is pack-time state:
                # a satisfied-set flip since staging (member failure,
                # grace shrink landing mid-cycle) changes who the
                # reduction even counts — recompute on host then
                wire_gangs = (frozenset(pp.gang_wire.uuids)
                              if pp.gang_wire is not None else frozenset())
                now_satisfied = frozenset(
                    u for u in (satisfied or ())
                    if u in wire_gangs or u in pp.gang_satisfied)
                if now_satisfied != pp.gang_satisfied:
                    gang_ok = False
            precomputed = None
            if gang_ok:
                precomputed = (np.asarray(gang_pre[0])[slots],
                               np.asarray(gang_pre[1])[slots].astype(bool))
            cand_host, gstats = apply_gang_cycle(
                cand_jobs, cand_host, pp.offers, groups_ctx,
                job_res=cand_res,
                cmask_fn=lambda: build_constraint_mask(
                    cand_jobs, pp.offers, pp.ctx),
                # reconcile-adjusted availability when an overlapped
                # cycle overdrafted the staged snapshot: the rescue and
                # refill passes must not re-place onto a host the
                # reconciler just protected
                avail=(pp.avail_headroom if pp.avail_headroom is not None
                       else pp.avail[:H]),
                capacity=pp.capacity[:H],
                device=False,
                refill_ok=(~res_conflict if res_conflict is not None
                           else None),
                audit_trail=self.store.audit, audit_pool=pool_name,
                satisfied=satisfied,
                precomputed=precomputed)
            if gstats is not None:
                result.gang_partial = gstats.partial
        if res_conflict is not None:
            # resource-conflicted candidates are a pipeline transient,
            # not a placement failure: keep them out of the unscheduled
            # explainer's persisted per-host summaries
            rp_keep = ~res_conflict
            self.matcher.record_placement_failures(
                [j for j, k in zip(cand_jobs, rp_keep) if k],
                cand_host[rp_keep], pp.offers, pp.ctx)
        else:
            self.matcher.record_placement_failures(
                cand_jobs, cand_host, pp.offers, pp.ctx)

        result.head_matched = bool(cand_host[0] >= 0) or dropped_head_matched
        mc = self.config.matcher_for_pool(pool_name)
        self.matcher._backoff[pool_name].update(mc, result.head_matched)

        for j, job in enumerate(cand_jobs):
            h = int(cand_host[j])
            if h < 0:
                result.unmatched.append(job)
            else:
                result.matched.append((job, pp.offers[h]))
        with tracing.span("fused.launch", pool=pool_name,
                          matched=len(result.matched)):
            self.matcher._launch(pool_name, result, scheduler.clusters)
        # drop this cycle's launches — and any reconcile-conflicted
        # candidates — from the queue by exact position (launched
        # candidates are always queue members — match_valid implies
        # queue_ok, so cand_qpos is valid for every launched slot)
        drops = ([conflict_qpos] if conflict_qpos is not None
                 and len(conflict_qpos) else [])
        if result.launched_job_uuids:
            cand_uuids = np.array([j.uuid for j in cand_jobs])
            launched_c = np.isin(cand_uuids,
                                 np.array(result.launched_job_uuids))
            drops.append(cand_qpos[slots[launched_c]])
        if drops:
            publish_queue(np.concatenate(drops))
            result.queue_pruned = True
        else:
            publish_queue()
        _audit.note_skips(self.store.audit, {
            "unmatched": [j.uuid for j in result.unmatched],
            "launch-failed": [(u, {"why": why})
                              for u, why in result.launch_failures],
        }, pool=pool_name)
        results[pool_name] = result
