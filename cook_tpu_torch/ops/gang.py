"""Gang all-or-nothing reduction (``cook_tpu/ops/gang.py``): the host
wire builder ``build_gang_wire`` (copied) and the plain PyTorch version
of ``gang_reduce_body`` :210.  A gang is complete when at least
``gang_size`` (its gang_min) members hold a host and, if it asks for a
topology attribute, all of them landed in one known domain; members of
incomplete gangs are reset to -1.  On the card the reduction over the
candidate slots is kernel K6, the epilogue of K5's launch
(``ops/match.greedy_gang``, ``csrc/greedy.cu``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


def gang_bounds(group) -> Tuple[int, int]:
    """The effective (min, max) member-count bounds of a gang group;
    unset (0) bounds default to ``gang_size``."""
    size = int(getattr(group, "gang_size", 0) or 0)
    lo = int(getattr(group, "gang_min", 0) or 0) or size
    hi = int(getattr(group, "gang_max", 0) or 0) or size
    return lo, hi


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
