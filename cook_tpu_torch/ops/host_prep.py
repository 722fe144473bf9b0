"""Host-side packing: per-user task lists -> padded rank arrays, and
jobs x hosts -> padded match arrays (numpy), copied from
``cook_tpu/ops/host_prep.py``.  The control plane deals in entities, the
cycle in padded arrays; this is the boundary."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .padding import bucket, pad_to
from .reference_impl import UserTasks

F32 = np.float32


def pack_rank_inputs(users: List[UserTasks],
                     shares: Dict[str, Tuple[float, float, float]],
                     quotas: Dict[str, np.ndarray],
                     pad: bool = True):
    """Build the rank_body input arrays (as numpy) plus the flat
    task-id table mapping kernel positions back to tasks.

    Users are laid out contiguously, sorted by user name (matching the
    reference's deterministic ``(sort-by first)``, dru.clj:123).
    Returns (arrays dict, task_ids list).
    """
    users = sorted(users, key=lambda u: u.user)
    users = [u for u in users if len(u.task_ids)]
    if users:
        # O(users) Python, O(tasks) numpy: per-user blocks are repeated /
        # concatenated wholesale rather than appended one task at a time.
        counts = np.array([len(u.task_ids) for u in users], dtype=np.int64)
        total = int(counts.sum())
        starts = (np.cumsum(counts) - counts).astype(np.int32)
        usage = np.concatenate(
            [np.asarray(u.usage, dtype=F32).reshape(len(u.task_ids), -1)
             for u in users], axis=0)
        quota = np.repeat(
            np.stack([np.asarray(quotas[u.user], dtype=F32) for u in users]),
            counts, axis=0)
        share = np.repeat(
            np.stack([np.asarray(shares[u.user], dtype=F32) for u in users]),
            counts, axis=0)
        first = np.repeat(starts, counts)
        rank = np.repeat(np.arange(len(users), dtype=np.int32), counts)
        pend = np.concatenate(
            [np.asarray(u.pending, dtype=bool) for u in users])
        task_ids = [t for u in users for t in u.task_ids]
        arrays = {
            "usage": usage,
            "quota": quota,
            "shares": share,
            "first_idx": first,
            "user_rank": rank,
            "pending": pend,
            "valid": np.ones(total, dtype=bool),
        }
    else:  # canonical 1-row all-padding layout
        task_ids = []
        arrays = {
            "usage": np.zeros((1, 4), dtype=F32),
            "quota": np.full((1, 4), np.inf, dtype=F32),
            "shares": np.full((1, 3), np.inf, dtype=F32),
            "first_idx": np.zeros(1, dtype=np.int32),
            "user_rank": np.zeros(1, dtype=np.int32),
            "pending": np.zeros(1, dtype=bool),
            "valid": np.zeros(1, dtype=bool),
        }
    if pad:
        arrays = pad_rank_arrays(arrays)
    return arrays, task_ids


def pad_rank_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Pad unpadded RankInputs columns to the bucketed size (shared by the
    entity packer above and the columnar-index fast path)."""
    arrays = dict(arrays)
    size = bucket(arrays["usage"].shape[0])
    arrays["usage"] = pad_to(arrays["usage"], size)
    arrays["quota"] = pad_to(arrays["quota"], size, fill=np.inf)
    arrays["shares"] = pad_to(arrays["shares"], size, fill=np.inf)
    arrays["first_idx"] = pad_to(arrays["first_idx"], size)
    arrays["user_rank"] = pad_to(arrays["user_rank"], size,
                                 fill=np.int32(2**31 - 1))
    arrays["pending"] = pad_to(arrays["pending"], size, fill=False)
    arrays["valid"] = pad_to(arrays["valid"], size, fill=False)
    return arrays


def pack_match_inputs(job_res: Sequence[Sequence[float]],
                      constraint_mask: np.ndarray,
                      host_avail: Sequence[Sequence[float]],
                      host_capacity: Sequence[Sequence[float]],
                      pad: bool = True):
    """Pad jobs x hosts match inputs to buckets. Padding jobs get valid=False;
    padding hosts get zero capacity (never feasible)."""
    job_res = np.asarray(job_res, dtype=F32).reshape(-1, 4)
    avail = np.asarray(host_avail, dtype=F32).reshape(-1, 4)
    capacity = np.asarray(host_capacity, dtype=F32).reshape(-1, 4)
    J, H = job_res.shape[0], avail.shape[0]
    cmask = np.asarray(constraint_mask, dtype=bool).reshape(J, H)
    valid = np.ones(J, dtype=bool)
    if pad:
        JB, HB = bucket(J), bucket(H)
        job_res = pad_to(job_res, JB)
        valid = pad_to(valid, JB, fill=False)
        avail = pad_to(avail, HB)
        capacity = pad_to(capacity, HB)
        grown = np.zeros((JB, HB), dtype=bool)
        grown[:J, :H] = cmask
        cmask = grown
    return {
        "job_res": job_res,
        "constraint_mask": cmask,
        "avail": avail,
        "capacity": capacity,
        "valid": valid,
        "num_jobs": J,
        "num_hosts": H,
    }
