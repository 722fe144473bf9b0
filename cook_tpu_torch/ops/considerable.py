"""Considerable-job admission in rank order, plain PyTorch
(``cook_tpu/ops/considerable.py``): pool and quota-group caps over the
ranked pending prefix, per-user quota over running plus earlier queued
usage, per-user launch-rate tokens, launch-plugin verdicts, and the
head-of-queue cap ``num_considerable``.  On the card the elementwise
steps run in K4 (``ops/admit.py``), the prefixes in K2 and the user-major
sort in K3."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .scan import lexsort, prefix_sum_xla_cpu, segmented_cumsum


class ConsiderableResult(NamedTuple):
    match_valid: torch.Tensor   # bool[T] admitted for matching (rank order)
    queue_ok: torch.Tensor      # bool[T] survived pool/group quota + enqueue
    accepted: torch.Tensor      # bool[T] admitted before the cap


def per_user_prefix(user: torch.Tensor, x: torch.Tensor,
                    include: torch.Tensor) -> torch.Tensor:
    """Inclusive per-user prefix sum of ``x`` over rows where ``include``,
    in the current row order (a user's rows need not be contiguous)."""
    T = user.shape[0]
    perm = lexsort((user,))  # user-major, stable in current order
    inc = include[perm]
    vals = x[perm] * inc.to(x.dtype).reshape((T,) + (1,) * (x.ndim - 1))
    u_sorted = user[perm]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=user.device),
                       u_sorted[1:] != u_sorted[:-1]])
    cum = segmented_cumsum(vals, first)
    out = torch.zeros_like(cum)
    out[perm] = cum
    return out


def considerable_body(usage_r, quota_r, user_r, run_base_r, tokens_r,
                      launch_ok_r, enqueue_ok_r, rankable_r, pool_base,
                      pool_quota, group_base, group_quota,
                      num_considerable) -> ConsiderableResult:
    """All per-task inputs in RANK order (see the JAX docstring)."""
    pend_usage = usage_r * rankable_r[:, None]
    cum_pool = prefix_sum_xla_cpu(pend_usage, 0)
    pq_ok = torch.all(cum_pool + pool_base[None, :] <= pool_quota[None, :],
                      dim=-1)
    gq_ok = torch.all(cum_pool + group_base[None, :] <= group_quota[None, :],
                      dim=-1)
    queue_ok = rankable_r & pq_ok & gq_ok & enqueue_ok_r
    cum_user = per_user_prefix(user_r, usage_r, queue_ok)
    quota_ok = queue_ok & torch.all(cum_user + run_base_r <= quota_r, dim=-1)
    ones = torch.ones(user_r.shape[0], dtype=torch.float32,
                      device=user_r.device)
    cnt = per_user_prefix(user_r, ones, quota_ok)
    rl_ok = quota_ok & (cnt <= torch.floor(tokens_r))
    accepted = rl_ok & launch_ok_r
    admitted_prefix = torch.cumsum(accepted.to(torch.int32), 0,
                                   dtype=torch.int32)
    match_valid = accepted & (admitted_prefix <= num_considerable)
    return ConsiderableResult(match_valid=match_valid, queue_ok=queue_ok,
                              accepted=accepted)
