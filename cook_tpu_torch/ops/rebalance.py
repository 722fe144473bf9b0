"""Preemption victim search (``cook_tpu/ops/rebalance.py``).

Tasks come pre-sorted by (host, dru descending) with each host's spare
resources.  Every "preempt the k highest-DRU eligible tasks on host h"
prefix is evaluated at once by a segmented prefix sum over the host
segments; the decision is the global best of their quality (the lowest
victim DRU; spare-only placements score +inf).

The segmented sum runs through K2 ``scan.seg_scan`` (the kernel on the
card, its plain version on the CPU); the rest is PyTorch code.  Both
reductions are written out, not left to ``torch.argmax``: the winner is
the lowest index holding the maximum, and a NaN score is the maximum
(the first NaN wins), as ``jnp.argmax`` decides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from . import scan
from .padding import take


class RebalanceInputs(NamedTuple):
    """Tasks sorted by (host, -dru); padding rows have ``eligible``
    False and ``host_start`` True."""

    task_dru: torch.Tensor    # f32[T]
    task_res: torch.Tensor    # f32[T, R]
    task_host: torch.Tensor   # i32[T]
    host_start: torch.Tensor  # bool[T] first row of its host segment
    eligible: torch.Tensor    # bool[T] passes dru/quota/self filters
    spare: torch.Tensor       # f32[H, R] spare resources per host
    host_ok: torch.Tensor     # bool[H] passes the pending job's constraints
    demand: torch.Tensor      # f32[R] the pending job's resources


class RebalanceDecision(NamedTuple):
    found: torch.Tensor         # bool[]
    spare_only: torch.Tensor    # bool[] spare suffices, no preemption
    host: torch.Tensor          # i32[] winning host index
    victim_mask: torch.Tensor   # bool[T] tasks to preempt
    decision_dru: torch.Tensor  # f32[] min victim dru (inf when spare_only)


def first_max(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a 1-D float or bool tensor: the lowest index of
    the maximum, where a NaN is the maximum."""
    n = x.shape[0]
    if x.dtype == torch.bool:
        hit = x | ~x.any()
    else:
        nan = torch.isnan(x)
        top = torch.where(nan, float("-inf"), x).amax()
        hit = torch.where(nan.any(), nan, x == top)
    iota = torch.arange(n, device=x.device)
    return torch.where(hit, iota, n).amin()


def preemption_body(inp: RebalanceInputs, seg_sum) -> RebalanceDecision:
    """The decision, with the segmented sum of [T, R] f32 taken from
    ``seg_sum(values, start u8[1, T])``."""
    T = inp.task_dru.shape[0]
    t_idx = torch.arange(T, dtype=torch.int32, device=inp.task_dru.device)
    res_eligible = inp.task_res * inp.eligible[:, None]
    seg_cum = seg_sum(res_eligible, inp.host_start.to(torch.uint8)[None])
    total = take(inp.spare, inp.task_host) + seg_cum
    feasible = (torch.all(total >= inp.demand[None, :], dim=1)
                & inp.eligible & take(inp.host_ok, inp.task_host))
    score = torch.where(feasible, inp.task_dru, float("-inf"))
    spare_feasible = (torch.all(inp.spare >= inp.demand[None, :], dim=1)
                      & inp.host_ok)
    any_spare = spare_feasible.any()
    spare_host = first_max(spare_feasible)
    best_t = first_max(score)
    best_score = score[best_t[None]][0]
    any_task = best_score > float("-inf")
    best_host = inp.task_host[best_t[None]][0]
    host = torch.where(any_spare, spare_host, best_host).to(torch.int32)
    victim_mask = (~any_spare & inp.eligible & (inp.task_host == host)
                   & (t_idx <= best_t))
    decision_dru = torch.where(any_spare, float("inf"), best_score)
    return RebalanceDecision(found=any_spare | any_task,
                             spare_only=any_spare, host=host,
                             victim_mask=victim_mask,
                             decision_dru=decision_dru)


def preemption_plain(inp: RebalanceInputs) -> RebalanceDecision:
    """The plain version: the segmented sum in PyTorch on the inputs'
    device."""
    return preemption_body(inp, lambda x, start: scan.segmented_cumsum(
        x, start[0] != 0))


def preemption_kernel(inp: RebalanceInputs,
                      device="cuda") -> RebalanceDecision:
    """Pick the preemption host and victims for one pending job
    (``cook_tpu/ops/rebalance.py:45``)."""
    dev = resolve_device(device)
    inp = RebalanceInputs(*(t.to(dev) for t in inp))
    return preemption_body(inp, scan.seg_scan_columns)
