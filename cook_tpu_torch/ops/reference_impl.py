"""Sequential numpy goldens with the reference scheduler's semantics
(copied from ``cook_tpu/ops/reference_impl.py``): DRU ranking through
per-user streams merged by a heap, the pool-quota filter, one-job-at-a-
time greedy bin packing, the gang all-or-nothing reduction, the
preemption decision host by host, and the resident pack's delta
scatter.  They are structured like the
reference scheduler rather than like the tensor code, which makes them an
independent golden for the port's parity tests.  All arithmetic is
float32.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

F32 = np.float32


# --------------------------------------------------------------------------
# DRU ranking (reference: dru.clj + scheduler.clj:2057-2099)
# --------------------------------------------------------------------------

class UserTasks:
    """One user's tasks in that user's sort order (running first, then
    pending by priority/submit-time — tools.clj same-user-task-comparator)."""

    def __init__(self, user: str, task_ids: Sequence[int],
                 usage: np.ndarray, pending: Sequence[bool]):
        self.user = user
        self.task_ids = list(task_ids)     # global task identifiers
        self.usage = np.asarray(usage, dtype=F32)  # [n, 4] cpus, mem, gpus, count
        self.pending = list(pending)


def limit_over_quota(tasks: UserTasks, quota: np.ndarray,
                     max_over_quota_jobs: int) -> UserTasks:
    """Drop tasks after the Nth whose cumulative usage exceeds quota
    (reference: limit-over-quota-jobs scheduler.clj:2057-2071)."""
    quota = np.asarray(quota, dtype=F32)
    total = np.zeros(4, dtype=F32)
    kept_ids, kept_usage, kept_pending = [], [], []
    over_count = 0
    for i in range(len(tasks.task_ids)):
        total = total + tasks.usage[i]
        if np.any(total > quota):
            over_count += 1
        if over_count > max_over_quota_jobs:
            break
        kept_ids.append(tasks.task_ids[i])
        kept_usage.append(tasks.usage[i])
        kept_pending.append(tasks.pending[i])
    usage = np.array(kept_usage, dtype=F32).reshape(len(kept_ids), 4)
    return UserTasks(tasks.user, kept_ids, usage, kept_pending)


def rank_by_dru(users: List[UserTasks],
                shares: Dict[str, Tuple[float, float, float]],
                quotas: Dict[str, np.ndarray],
                gpu_mode: bool = False,
                max_over_quota_jobs: int = 100) -> List[Tuple[int, float]]:
    """Rank pending tasks ascending by DRU.

    Returns [(task_id, dru)] for pending tasks only, in rank order.  Per-user
    streams of (dru, user_rank, position) are merged through a heap, mirroring
    sorted-merge (dru.clj:82-104); users are processed in name order like the
    reference's ``(sort-by first)`` (dru.clj:123).
    """
    streams = []
    for user_rank, ut in enumerate(sorted(users, key=lambda u: u.user)):
        ut = limit_over_quota(ut, quotas[ut.user], max_over_quota_jobs)
        share = np.asarray(shares[ut.user], dtype=F32)
        cum = np.zeros(3, dtype=F32)
        stream = []
        for pos in range(len(ut.task_ids)):
            cum = cum + ut.usage[pos, :3]
            if gpu_mode:
                dru = F32(cum[2] / share[2])
            else:
                dru = F32(max(cum[1] / share[1], cum[0] / share[0]))
            if ut.pending[pos]:
                stream.append((dru, user_rank, pos, ut.task_ids[pos]))
        streams.append(stream)
    merged = heapq.merge(*streams)
    return [(task_id, dru) for dru, _ur, _pos, task_id in merged]


def filter_pool_quota(job_usage: np.ndarray, base_usage: np.ndarray,
                      quota: Optional[np.ndarray]) -> np.ndarray:
    """Pool-quota keep mask over a ranked queue (tools.clj:917-933): the
    accumulator includes filtered jobs."""
    n = job_usage.shape[0]
    keep = np.ones(n, dtype=bool)
    if quota is None:
        return keep
    total = np.asarray(base_usage, dtype=F32).copy()
    for i in range(n):
        total = total + job_usage[i]
        keep[i] = bool(np.all(total <= quota))
    return keep


# --------------------------------------------------------------------------
# Greedy bin-packing match (reference: Fenzo scheduleOnce via
# scheduler.clj:617-687; fitness = cpuMemBinPacker, config.clj:108)
# --------------------------------------------------------------------------

def binpack_fitness(need: np.ndarray, avail: np.ndarray,
                    capacity: np.ndarray) -> np.ndarray:
    """cpuMemBinPacker: mean of post-assignment cpu and mem utilization."""
    used = capacity - avail
    cap = np.maximum(capacity, F32(1e-9))
    f_cpu = (used[:, 0] + need[0]) / cap[:, 0]
    f_mem = (used[:, 1] + need[1]) / cap[:, 1]
    return ((f_cpu + f_mem) / F32(2.0)).astype(F32)


def greedy_match(job_res: np.ndarray, constraint_mask: np.ndarray,
                 avail: np.ndarray, capacity: np.ndarray) -> np.ndarray:
    """Assign jobs (in rank order) one at a time to the feasible host with the
    highest bin-packing fitness; ties -> lowest host index. Returns i32[J]
    host index or -1.  Mutates nothing; works on copies."""
    job_res = np.asarray(job_res, dtype=F32)
    avail = np.asarray(avail, dtype=F32).copy()
    capacity = np.asarray(capacity, dtype=F32)
    J = job_res.shape[0]
    assign = np.full(J, -1, dtype=np.int32)
    for j in range(J):
        need = job_res[j]
        feasible = np.all(avail >= need[None, :], axis=1) & constraint_mask[j]
        if not feasible.any():
            continue
        fitness = binpack_fitness(need, avail, capacity)
        fitness = np.where(feasible, fitness, -np.inf)
        h = int(np.argmax(fitness))
        assign[j] = h
        avail[h] = avail[h] - need
    return assign


# --------------------------------------------------------------------------
# Gang all-or-nothing reduction (docs/GANG.md; the host golden for
# ops/gang.gang_reduce_body)
# --------------------------------------------------------------------------

def gang_reduce(assign: np.ndarray, gang_id: np.ndarray,
                gang_size: np.ndarray, gang_attr: np.ndarray,
                host_topo: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Zero out partial gangs in a match assignment.

    A gang is complete when (a) at least ``gang_size[g]`` of its members
    hold assignments and (b), for gangs with a topology request
    (``gang_attr[g] > 0``), every matched member landed on hosts sharing
    one known topology code.  Members of incomplete gangs are reset to
    -1 (they retry next cycle; the freed capacity is re-offered by the
    caller's refill pass).

    ``assign`` i32[J] host index or -1; ``gang_id`` i32[J] segment id or
    -1 for non-gang rows; ``gang_size`` i32[G]; ``gang_attr`` i32[G]
    row into ``host_topo`` (0 = no topology requirement); ``host_topo``
    i32[A, H] topology code per host (-1 = attribute absent).

    Returns (assign', dropped bool[J]).
    """
    assign = np.asarray(assign, dtype=np.int32)
    gang_id = np.asarray(gang_id, dtype=np.int32)
    G = int(gang_size.shape[0])
    member = gang_id >= 0
    matched = member & (assign >= 0)
    cnt = np.bincount(gang_id[matched], minlength=G)[:G]
    complete = cnt >= np.asarray(gang_size, dtype=np.int64)
    topo_required = np.asarray(gang_attr) > 0
    if topo_required.any():
        for g in np.flatnonzero(topo_required):
            rows = matched & (gang_id == g)
            if not rows.any():
                continue
            codes = host_topo[int(gang_attr[g])][assign[rows]]
            if codes.min() < 0 or codes.min() != codes.max():
                complete[g] = False
    dropped = matched & ~complete[np.where(member, gang_id, 0)]
    out = np.where(dropped, np.int32(-1), assign)
    return out, dropped


# --------------------------------------------------------------------------
# Preemption decision (reference: rebalancer.clj compute-preemption-decision
# :320-407)
# --------------------------------------------------------------------------

def preemption_decision(task_dru: np.ndarray, task_res: np.ndarray,
                        task_host: np.ndarray, eligible: np.ndarray,
                        spare: np.ndarray, host_ok: np.ndarray,
                        demand: np.ndarray
                        ) -> Optional[Tuple[int, List[int], float]]:
    """Pick (host, victim task indices, decision dru) maximizing the
    minimum DRU among preempted tasks; spare-only solutions score +inf.
    Tasks are scanned per host in descending-DRU order; ties go to the
    lowest host index."""
    task_dru = np.asarray(task_dru, dtype=F32)
    task_res = np.asarray(task_res, dtype=F32)
    spare = np.asarray(spare, dtype=F32)
    demand = np.asarray(demand, dtype=F32)
    H = spare.shape[0]
    best: Optional[Tuple[float, int, List[int]]] = None

    def consider(score: float, host: int, victims: List[int]):
        nonlocal best
        if best is None or score > best[0] or (score == best[0]
                                               and host < best[1]):
            best = (score, host, victims)

    for h in range(H):
        if not host_ok[h]:
            continue
        if np.all(spare[h] >= demand):
            consider(np.inf, h, [])
            continue
        idx = [t for t in np.nonzero((task_host == h) & eligible)[0]]
        idx.sort(key=lambda t: (-task_dru[t], t))
        freed = spare[h].copy()
        for k, t in enumerate(idx):
            freed = freed + task_res[t]
            if np.all(freed >= demand):
                consider(float(task_dru[t]), h,
                         [int(x) for x in idx[:k + 1]])
                break
    if best is None:
        return None
    score, host, victims = best
    return host, victims, score


# --------------------------------------------------------------------------
# Resident pack delta scatter (the host golden for ops/delta)
# --------------------------------------------------------------------------

def apply_pack_delta(rows_buf: np.ndarray, flags_buf: np.ndarray,
                     idx: np.ndarray, rows_vals: np.ndarray,
                     flags_vals: np.ndarray):
    """Scatter the delta batch (flat positions; entries >= the buffer
    size are padding and dropped) into copies of the resident rows/flags
    buffers."""
    n_flat = rows_buf.size
    keep = np.asarray(idx) < n_flat
    idx = np.asarray(idx)[keep]
    rows = np.array(rows_buf, copy=True)
    flags = np.array(flags_buf, copy=True)
    rows.reshape(-1)[idx] = np.asarray(rows_vals)[keep]
    flags.reshape(-1)[idx] = np.asarray(flags_vals)[keep]
    return rows, flags
