"""DRU (Dominant Resource Usage) fair-share ranking, plain PyTorch
(``cook_tpu/ops/dru.py:81`` ``rank_body``).

Per user, tasks in the user's order: cum = segmented prefix sum of
(cpus, mem, gpus, count); dru = max(cum_mem / share_mem, cum_cpus /
share_cpus) (or cum_gpus / share_gpus in gpu mode).  Pending survivors
of the over-quota limit are sorted ascending by (dru, user_rank,
position).  On the card the scans run in K2, the elementwise steps in K4
and the sort in K3.
"""

from __future__ import annotations

import torch

from .scan import lexsort, segmented_cumsum_by_first_idx


def rank_body(usage, quota, shares, first_idx, user_rank, pending, valid,
              gpu_mode: bool, max_over_quota_jobs: int):
    """One pool: returns (order, num_ranked, dru, keep, rankable)."""
    usage = usage * valid[:, None]
    cum_all = segmented_cumsum_by_first_idx(usage, first_idx)
    over = torch.any(cum_all > quota, dim=-1) & valid
    over_cnt = segmented_cumsum_by_first_idx(over.to(torch.int32), first_idx)
    keep = valid & (over_cnt <= max_over_quota_jobs)
    cum = segmented_cumsum_by_first_idx(usage * keep[:, None], first_idx)
    if gpu_mode:
        dru = cum[:, 2] / shares[:, 2]
    else:
        # torch.maximum propagates NaN, as jnp.maximum does
        dru = torch.maximum(cum[:, 1] / shares[:, 1],
                            cum[:, 0] / shares[:, 0])
    rankable = keep & pending
    sort_dru = torch.where(rankable, dru, torch.full_like(dru, float("inf")))
    # stable: equal (dru, user_rank) keep position order
    order = lexsort((user_rank, sort_dru)).to(torch.int32)
    num_ranked = rankable.to(torch.int32).sum()
    return order, num_ranked, dru, keep, rankable
