"""Gang all-or-nothing reduction (``cook_tpu/ops/gang.py``): the host
builders ``build_gang_wire``, ``build_gang_pack`` and the per-cycle pass
``apply_gang_cycle`` (copied), and the PyTorch version of
``gang_reduce_body`` :210.  A gang is complete when at least
``gang_size`` (its gang_min) members hold a host and, if it asks for a
topology attribute, all of them landed in one known domain; members of
incomplete gangs are reset to -1.  On the card the reduction over the
fused cycle's candidate slots is kernel K6, the epilogue of K5's launch
(``ops/match.greedy_gang``, ``csrc/greedy.cu``); the split path's
reduction (``gang_reduce_kernel``, jitted XLA in the reference) runs
``gang_reduce_body`` on the matcher's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import tracing
from ..utils.metrics import registry
from . import reference_impl, telemetry
from .padding import bucket, pad_to

F32 = np.float32


@dataclass
class GangPack:
    """Host-side gang arrays for one match batch (built only when the
    batch holds gang members).  ``gang_size`` is the reduction threshold
    (gang_min for elastic gangs); ``declared`` the declared sizes."""

    gang_id: np.ndarray          # i32[J], -1 = not a gang member
    gang_size: np.ndarray        # i32[G] reduction threshold (min)
    gang_attr: np.ndarray        # i32[G] row into host_topo, 0 = none
    host_topo: np.ndarray        # i32[A, H] topology code, -1 = absent
    uuids: List[str]             # gang segment -> group uuid
    topology: List[Optional[str]]  # gang segment -> requested attribute
    declared: List[int] = None   # gang segment -> declared gang_size


@dataclass
class GangStats:
    """What the reduction did, for the cycle record / explainer."""

    dropped_jobs: int = 0
    dropped_gangs: int = 0
    refilled: int = 0
    # group uuid -> {"size", "matched", "missing", "topology_blocked"}
    partial: Dict[str, Dict] = field(default_factory=dict)


def _topology_table(topo_names: List[Optional[str]], offers
                    ) -> Tuple[Dict[str, int], np.ndarray]:
    """One row per distinct requested attribute (row 0: no request, all
    zeros); codes are assigned in offer order."""
    attrs = sorted({a for a in topo_names if a})
    attr_row = {a: i + 1 for i, a in enumerate(attrs)}
    H = max(len(offers), 1)
    host_topo = np.full((len(attrs) + 1, H), -1, dtype=np.int32)
    host_topo[0] = 0
    for a, row in attr_row.items():
        codes: Dict[str, int] = {}
        for h, o in enumerate(offers):
            v = o.attributes.get(a)
            if v is not None:
                host_topo[row, h] = codes.setdefault(v, len(codes))
    return attr_row, host_topo


class GangWire(NamedTuple):
    """Per-pool gang arrays keyed by task row (sorted pack position)."""

    gang_id: np.ndarray   # i32[T] by sorted pack position, -1 = none
    gang_size: np.ndarray  # i32[G] reduction threshold (gang_min)
    gang_attr: np.ndarray  # i32[G] row into host_topo, 0 = none
    host_topo: np.ndarray  # i32[A, H]
    uuids: List[str]       # gang segment -> group uuid


def build_gang_wire(T: int, members_by_gang: Dict[str, List],
                    groups_ctx: Dict[str, object], offers,
                    satisfied=None) -> Optional[GangWire]:
    """Gang wire for one packed pool (``members_by_gang``: group uuid ->
    [(task_row, job)]), or None when no reducible gang member is staged.
    Satisfied elastic gangs' members place like singles (excluded)."""
    from ..state.schema import gang_bounds
    rows_by_gang = {
        guuid: members for guuid, members in members_by_gang.items()
        if getattr(groups_ctx.get(guuid), "gang", False)
        and not (satisfied and guuid in satisfied)}
    if not rows_by_gang:
        return None
    gang_id = np.full(T, -1, dtype=np.int32)
    uuids: List[str] = []
    sizes: List[int] = []
    topo_names: List[Optional[str]] = []
    for guuid, members in rows_by_gang.items():
        g = groups_ctx[guuid]
        k = len(uuids)
        uuids.append(guuid)
        sizes.append(gang_bounds(g)[0])
        topo_names.append(getattr(g, "gang_topology", None) or None)
        for row, _job in members:
            gang_id[row] = k
    attr_row, host_topo = _topology_table(topo_names, offers)
    gang_attr = np.array([attr_row.get(a, 0) if a else 0
                          for a in topo_names], dtype=np.int32)
    return GangWire(gang_id=gang_id,
                    gang_size=np.array(sizes, dtype=np.int32),
                    gang_attr=gang_attr, host_topo=host_topo, uuids=uuids)


_BIG = 2 ** 30


def gang_reduce_body(assign, gang_id, gang_size, gang_attr, host_topo):
    """One pool: (assign', dropped).  ``assign``/``gang_id`` i32[J],
    ``gang_size``/``gang_attr`` i32[G], ``host_topo`` i32[A, H]."""
    G = gang_size.shape[0]
    member = gang_id >= 0
    gid = torch.where(member, gang_id, 0).long()
    matched = member & (assign >= 0)
    cnt = torch.zeros(G, dtype=torch.int32, device=assign.device)
    cnt.index_add_(0, gid, matched.to(torch.int32))
    h = torch.clamp(assign, 0, host_topo.shape[1] - 1).long()
    topo = host_topo[gang_attr[gid].long(), h]
    i32 = torch.iinfo(torch.int32)
    tmin = torch.full((G,), i32.max, dtype=torch.int32, device=assign.device)
    tmin = tmin.scatter_reduce(
        0, gid, torch.where(matched, topo, _BIG), "amin")
    tmax = torch.full((G,), i32.min, dtype=torch.int32, device=assign.device)
    tmax = tmax.scatter_reduce(
        0, gid, torch.where(matched, topo, -_BIG), "amax")
    topo_ok = (gang_attr <= 0) | ((tmin == tmax) & (tmin >= 0))
    complete = (cnt >= gang_size) & topo_ok
    dropped = matched & ~complete[gid]
    return torch.where(dropped, -1, assign).to(torch.int32), dropped


# --------------------------------------------------------------- kernel K6
# The reduction over every pool's compacted candidate slots (cook_tpu/
# ops/pallas_cycle.py::_gang_reduce_candidates :122).  On the card it is
# the epilogue of K5's launch (ops/match.greedy_gang, csrc/greedy.cu).


def gang_reduce_candidates(cand_row, cand_assign, gang_id, gang_size,
                           gang_attr, host_topo):
    """Plain version of K6 (``_gang_reduce_candidates`` of the JAX
    package, per pool): each slot's task row mapped to its gang segment,
    then ``gang_reduce_body``.  Returns (cand_gang, cand_dropped) i32."""
    gangs, drops = [], []
    for p in range(cand_row.shape[0]):
        ok = cand_row[p] >= 0
        gid = torch.where(
            ok, gang_id[p][torch.clamp(cand_row[p], min=0).long()], -1)
        g, d = gang_reduce_body(cand_assign[p], gid, gang_size[p],
                                gang_attr[p], host_topo[p])
        gangs.append(g)
        drops.append(d.to(torch.int32))
    return torch.stack(gangs), torch.stack(drops)


# ----------------------------------------------------------- split path
def build_gang_pack(jobs, groups: Dict[str, object], offers,
                    satisfied=None) -> Optional[GangPack]:
    """Gang arrays for a match batch, or None when no job of the batch
    belongs to a gang group.  Waiting members of ``satisfied`` elastic
    gangs are the grow path: they place like group-less jobs and are
    left out."""
    from ..state.schema import gang_bounds
    member_rows = [j for j, job in enumerate(jobs)
                   if getattr(job, "group", None)
                   and getattr(groups.get(job.group), "gang", False)
                   and not (satisfied and job.group in satisfied)]
    if not member_rows:
        return None
    J = len(jobs)
    gang_id = np.full(J, -1, dtype=np.int32)
    uuids: List[str] = []
    sizes: List[int] = []
    declared: List[int] = []
    topo_names: List[Optional[str]] = []
    seg: Dict[str, int] = {}
    for j in member_rows:
        g = groups[jobs[j].group]
        guuid = jobs[j].group
        k = seg.get(guuid)
        if k is None:
            k = seg[guuid] = len(uuids)
            uuids.append(guuid)
            sizes.append(gang_bounds(g)[0])
            declared.append(int(getattr(g, "gang_size", 0) or 0))
            topo_names.append(getattr(g, "gang_topology", None) or None)
        gang_id[j] = k
    attr_row, host_topo = _topology_table(topo_names, offers)
    gang_attr = np.array([attr_row.get(a, 0) if a else 0
                          for a in topo_names], dtype=np.int32)
    return GangPack(gang_id=gang_id,
                    gang_size=np.array(sizes, dtype=np.int32),
                    gang_attr=gang_attr, host_topo=host_topo,
                    uuids=uuids, topology=topo_names,
                    declared=declared)


def gang_reduce_kernel(assign: np.ndarray, pack: GangPack, device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`gang_reduce_body` on ``device`` over the reference's
    bucketed padding (``cook_tpu/ops/gang.py:251``): padding jobs get
    gang_id -1, padding gangs an unreachable size.  Returns (assign',
    dropped) over the real jobs, as numpy."""
    from .. import resolve_device
    dev = resolve_device(device)
    J = len(assign)
    Jb = bucket(J)
    Gb = bucket(len(pack.gang_size), minimum=8)
    Ab = bucket(pack.host_topo.shape[0], minimum=1)
    Hb = bucket(pack.host_topo.shape[1])
    assign_p = pad_to(np.asarray(assign, dtype=np.int32), Jb, fill=-1)
    gid_p = pad_to(pack.gang_id, Jb, fill=-1)
    size_p = pad_to(pack.gang_size, Gb, fill=2 ** 30)
    attr_p = pad_to(pack.gang_attr, Gb, fill=0)
    topo_p = np.full((Ab, Hb), -1, dtype=np.int32)
    topo_p[:pack.host_topo.shape[0], :pack.host_topo.shape[1]] = \
        pack.host_topo
    out, dropped = gang_reduce_body(
        *(torch.from_numpy(a).to(dev)
          for a in (assign_p, gid_p, size_p, attr_p, topo_p)))
    with telemetry.sync_wait("gang.reduce"):
        out_np = out.cpu().numpy()[:J]
        dropped_np = dropped.cpu().numpy()[:J]
    return out_np, dropped_np


def apply_gang_cycle(jobs, assign: np.ndarray, offers,
                     groups: Dict[str, object], *,
                     job_res: Optional[np.ndarray] = None,
                     cmask_fn: Optional[Callable[[], np.ndarray]] = None,
                     avail: Optional[np.ndarray] = None,
                     capacity: Optional[np.ndarray] = None,
                     device=False,
                     refill_ok: Optional[np.ndarray] = None,
                     audit_trail=None,
                     audit_pool: Optional[str] = None,
                     satisfied=None,
                     precomputed: Optional[Tuple[np.ndarray,
                                                 np.ndarray]] = None,
                     ) -> Tuple[np.ndarray, Optional[GangStats]]:
    """The per-cycle gang pass (``cook_tpu/ops/gang.py:279``): reduce
    partial gangs to nothing, try a rescue re-pack of each dropped
    cohort, and refill the freed capacity with still-unmatched
    group-less jobs.  A structural no-op (``assign`` unchanged, stats
    None) when the batch has no gang members.

    ``device``: False reduces with the host golden
    (``reference_impl.gang_reduce``); otherwise the device
    :func:`gang_reduce_kernel` runs on (a failure there raises: there is
    no host fallback).  ``precomputed``: the fused cycle's (out, dropped)
    from K6, aligned with ``jobs``, used in place of the reduction.
    ``refill_ok``: a veto over the refill pass's rows (the pipelined
    driver's resource conflicts)."""
    pack = build_gang_pack(jobs, groups, offers, satisfied=satisfied)
    if pack is None:
        return assign, None
    assign = np.asarray(assign, dtype=np.int32)
    with tracing.span("gang.reduce", gangs=len(pack.uuids),
                      jobs=len(jobs), fused=precomputed is not None):
        if precomputed is not None:
            out = np.asarray(precomputed[0], dtype=np.int32).copy()
            dropped = np.asarray(precomputed[1], dtype=bool).copy()
        elif device is not False and device is not None:
            out, dropped = gang_reduce_kernel(assign, pack, device=device)
        else:
            out, dropped = reference_impl.gang_reduce(
                assign, pack.gang_id, pack.gang_size,
                pack.gang_attr, pack.host_topo)
    # rescue pass: a dropped cohort whose members are all in the batch
    # is re-matched alone, most-constrained member first, against the
    # capacity the surviving assignments left; only a packing of at
    # least the reduction threshold is accepted.  The constraint mask is
    # built at most once a cycle, shared by rescue and refill
    cmask: Optional[np.ndarray] = None
    if (dropped.any() and cmask_fn is not None and avail is not None
            and capacity is not None and job_res is not None):
        cmask = np.asarray(cmask_fn(), dtype=bool)
        res_f = np.asarray(job_res, dtype=F32)
        cap_f = np.asarray(capacity, dtype=F32)
        H = cap_f.shape[0]
        avail_left = np.asarray(avail, dtype=F32).copy()
        taken = (out >= 0) & (out < H)
        if taken.any():
            np.subtract.at(avail_left, out[taken], res_f[taken])
        avail_left = np.maximum(avail_left, 0.0)
        for g in sorted({int(x) for x in pack.gang_id[dropped]}):
            rows = np.flatnonzero(pack.gang_id == g)
            if len(rows) < int(pack.gang_size[g]):
                continue  # members missing from the batch: no rescue
            ptype = getattr(groups.get(pack.uuids[g]),
                            "placement_type", None)
            from ..state.schema import GroupPlacementType
            if ptype is not None and ptype is not GroupPlacementType.ALL:
                # the re-pack honours resources and each job's mask
                # only; within-batch host-placement rules would not hold
                continue
            sub_mask = cmask[rows, :H]
            fits = np.stack([np.all(avail_left >= res_f[r][None, :],
                                    axis=1) for r in rows])
            order = np.argsort((sub_mask & fits).sum(axis=1),
                               kind="stable")
            trial = reference_impl.greedy_match(
                res_f[rows][order], sub_mask[order], avail_left, cap_f)
            hit = trial >= 0
            if int(hit.sum()) >= int(pack.gang_size[g]):
                out[rows[order]] = trial
                dropped[rows] = False
                np.subtract.at(avail_left, trial[hit],
                               res_f[rows][order][hit])
                avail_left = np.maximum(avail_left, 0.0)
    stats = GangStats()
    member = pack.gang_id >= 0
    matched_before = member & (assign >= 0)
    matched_final = member & (out >= 0)
    for g, guuid in enumerate(pack.uuids):
        rows = pack.gang_id == g
        matched = int(matched_before[rows].sum())
        need = int(pack.gang_size[g])
        size = int(pack.declared[g]) if pack.declared else need
        if int(matched_final[rows].sum()) >= need \
                and not dropped[rows].any():
            continue  # placed whole (directly or by the rescue pass)
        entry = {
            "size": size, "matched": matched,
            "missing": max(need - matched, 0),
            "topology_blocked": bool(matched >= need
                                     and dropped[rows].any())}
        if need != size:
            entry["min"] = need
        stats.partial[guuid] = entry
    stats.dropped_jobs = int(dropped.sum())
    stats.dropped_gangs = len(
        {int(g) for g in pack.gang_id[dropped]})
    if stats.dropped_jobs:
        registry.counter_inc("cook_gang_partial_drops",
                             float(stats.dropped_gangs))
        from ..utils import audit as _audit
        _audit.note_skips(audit_trail, {
            "gang-partial": [jobs[i].uuid
                             for i in np.flatnonzero(dropped)]},
            pool=audit_pool)
        # same-cycle refill: the freed capacity goes to group-less
        # unmatched jobs and to grow members of satisfied elastic gangs
        if (cmask_fn is not None and avail is not None
                and capacity is not None and job_res is not None):
            avail_after = np.asarray(avail, dtype=F32).copy()
            taken = (out >= 0) & (out < avail_after.shape[0])
            if taken.any():
                np.subtract.at(avail_after, out[taken],
                               np.asarray(job_res, dtype=F32)[taken])
            avail_after = np.maximum(avail_after, 0.0)
            eligible = ((out < 0) & ~dropped
                        & np.array([not getattr(j, "group", None)
                                    or bool(satisfied
                                            and j.group in satisfied)
                                    for j in jobs], dtype=bool))
            if refill_ok is not None:
                # the caller vetoes rows whose unmatched state is not a
                # plain capacity miss (the pipeline's resource conflicts,
                # whose staged availability is known to be stale)
                eligible &= np.asarray(refill_ok, dtype=bool)
            idx = np.flatnonzero(eligible)
            if idx.size:
                if cmask is None:
                    cmask = np.asarray(cmask_fn(), dtype=bool)
                refill = reference_impl.greedy_match(
                    np.asarray(job_res, dtype=F32)[idx], cmask[idx],
                    avail_after, np.asarray(capacity, dtype=F32))
                hit = refill >= 0
                if hit.any():
                    out[idx[hit]] = refill[hit]
                    stats.refilled = int(hit.sum())
    return out, stats
