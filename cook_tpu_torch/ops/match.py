"""Batched jobs x hosts bin-packing assignment: the port of
``cook_tpu/ops/match.py``.

* ``greedy_assign`` (``_fitness`` :50, ``greedy_assign`` :60): jobs in
  rank order, each placed on the feasible host of highest
  cpuMemBinPacker fitness, ties to the lowest host index.  On the card
  this is kernel K5 (``greedy`` below, ``csrc/greedy.cu``), which
  ``greedy_match_kernel`` also runs.
* ``auction_match_kernel`` (:164) and ``waterfill_match_kernel`` (:276),
  the large-J matchers of the split path.  They have no Pallas kernel in
  the JAX package and are PyTorch tensor code here, written in the JAX
  package's summation orders so that they agree with it bit for bit;
  their scans go through the K2 wrappers (``scan.seg_scan``,
  ``scan.prefix16``), and their data-dependent ``while_loop``s are
  Python loops that read one device scalar per iteration.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def _fitness(need: torch.Tensor, avail: torch.Tensor,
             capacity: torch.Tensor) -> torch.Tensor:
    """cpuMemBinPacker: mean post-assignment utilization of cpus and mem.
    ``need`` [..., R], ``avail``/``capacity`` [..., H, R] -> [..., H]."""
    used = capacity - avail
    cap = torch.maximum(capacity, torch.tensor(1e-9, dtype=torch.float32,
                                               device=capacity.device))
    f_cpu = (used[..., 0] + need[..., None, 0]) / cap[..., 0]
    f_mem = (used[..., 1] + need[..., None, 1]) / cap[..., 1]
    return (f_cpu + f_mem) * 0.5


def greedy_assign(job_res, constraint_mask, valid, avail, capacity):
    """Sequential greedy over the job axis.  Shapes ``job_res`` [..., J,
    R], ``constraint_mask`` [..., J, H], ``valid`` [..., J], ``avail`` and
    ``capacity`` [..., H, R]; any leading batch dims are independent
    pools.  Returns (assign i32[..., J], remaining avail)."""
    avail = avail.clone()
    J = job_res.shape[-2]
    H = avail.shape[-2]
    assign = torch.full(job_res.shape[:-1], -1, dtype=torch.int32,
                        device=job_res.device)
    hosts = torch.arange(H, device=avail.device)
    for j in range(J):
        need = job_res[..., j, :]
        feasible = (torch.all(avail >= need[..., None, :], dim=-1)
                    & constraint_mask[..., j, :] & valid[..., j, None])
        fitness = torch.where(feasible, _fitness(need, avail, capacity),
                              torch.full_like(avail[..., 0], NEG_INF))
        host = torch.argmax(fitness, dim=-1)  # first maximum: lowest index
        found = torch.gather(feasible, -1, host[..., None])[..., 0]
        onehot = (hosts == host[..., None]) & found[..., None]
        avail = torch.where(onehot[..., None], avail - need[..., None, :],
                            avail)
        assign[..., j] = torch.where(found, host.to(torch.int32),
                                     torch.full_like(assign[..., j], -1))
    return assign, avail


# --------------------------------------------------------------- kernel K5
# Greedy over the compacted candidate slots of every pool, with each
# slot's mask composed from the structured form (cook_tpu/parallel/
# sharded.py:417-423).  On the card: csrc/greedy.cu.
from . import cuda_lib  # noqa: E402

KERNEL = "greedy"


def compose_mask(gpu_c, eid_c, host_gpu, host_blocked, exc_mask):
    """bool[P, C, H]: the exception row where a slot has one, else gpu
    isolation (gpu jobs on gpu hosts only, and the reverse) minus
    blocked hosts."""
    hg = host_gpu[:, None, :] != 0
    base = torch.where(gpu_c[..., None] != 0, hg, ~hg) \
        & (host_blocked[:, None, :] == 0)
    eid = eid_c.long()
    rows = torch.gather(
        exc_mask, 1, torch.clamp(eid, min=0)[..., None].expand(
            -1, -1, exc_mask.shape[2])) if exc_mask.shape[1] else base
    return torch.where((eid >= 0)[..., None], rows != 0, base)


def _greedy_plain(res_c, valid_c, gpu_c, eid_c, host_gpu, host_blocked,
                  exc_mask, avail, capacity):
    valid = valid_c != 0
    mask = compose_mask(gpu_c, eid_c, host_gpu, host_blocked, exc_mask) \
        & valid[..., None]
    assign, _ = greedy_assign(res_c, mask, valid, avail, capacity)
    return assign


@cuda_lib.stage(KERNEL, _greedy_plain,
                (torch.float32, torch.uint8, torch.uint8, torch.int32,
                 torch.uint8, torch.uint8, None, torch.float32,
                 torch.float32))
def greedy(res_c, valid_c, gpu_c, eid_c, host_gpu, host_blocked, exc_mask,
           avail, capacity):
    """assign i32[P, C]: each compacted slot's host, -1 when empty or
    nothing fits.  ``exc_mask`` bool or u8 [P, E, H]."""
    P, C, _ = res_c.shape
    H = avail.shape[1]
    E = exc_mask.shape[1]
    cuda_lib.check(res_c, torch.float32, (P, C, 4), "res_c")
    cuda_lib.check(capacity, torch.float32, (P, H, 4), "capacity")
    if exc_mask.dtype not in (torch.bool, torch.uint8) \
            or tuple(exc_mask.shape) != (P, E, H):
        raise ValueError("greedy: exc_mask must be bool or u8 [P, E, H]")
    em = exc_mask.view(torch.uint8)
    work = torch.empty(P * H * 4 if H * 24 > 220 * 1024 else 1,
                       dtype=torch.float32, device=res_c.device)
    assign = torch.empty((P, C), dtype=torch.int32, device=res_c.device)
    cuda_lib.call("k5_greedy", KERNEL, res_c.data_ptr(), valid_c.data_ptr(),
                  gpu_c.data_ptr(), eid_c.data_ptr(), host_gpu.data_ptr(),
                  host_blocked.data_ptr(), em.data_ptr(), avail.data_ptr(),
                  capacity.data_ptr(), work.data_ptr(), assign.data_ptr(),
                  P, C, H, E)
    return assign


# ------------------------------------------------------- the split matchers
import math  # noqa: E402
from typing import NamedTuple, Tuple  # noqa: E402

from . import scan as scanlib  # noqa: E402
from .pallas_match import chunk_rows  # noqa: E402

_U8, _I32 = torch.uint8, torch.int32


class MatchInputs(NamedTuple):
    job_res: torch.Tensor          # f32[J, R] demands in rank order
    constraint_mask: torch.Tensor  # bool[J, H]
    avail: torch.Tensor            # f32[H, R] offered (spare) resources
    capacity: torch.Tensor         # f32[H, R] total capacity (for fitness)
    valid: torch.Tensor            # bool[J] False for padding


def ordered_fold(base: torch.Tensor, values: torch.Tensor, seg: torch.Tensor,
                 keep: torch.Tensor, subtract: bool = False) -> torch.Tensor:
    """``base`` [H, R] with ``values[i]`` added to (or subtracted from)
    row ``seg[i]`` for every kept i, one at a time in increasing i: the
    order of a sequential loop, which is XLA:CPU's order for
    ``segment_sum`` and the greedy's order of subtraction.  A float
    scatter-add on the card (atomics) has no fixed order; here each step
    updates a set of distinct rows (the i-th kept entry of every
    segment), so the result is the same on every device."""
    out = base.clone()
    idx = torch.nonzero(keep).flatten()
    if idx.numel() == 0:
        return out
    s = seg[idx].long()
    order = torch.sort(s, stable=True).indices
    s, idx = s[order], idx[order]
    n = s.numel()
    pos = torch.arange(n, device=s.device)
    first = torch.ones(n, dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    level = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    by_level = torch.sort(level, stable=True).indices
    vals = values[idx]
    lo = 0
    for count in torch.bincount(level).tolist():
        sel = by_level[lo:lo + count]
        rows = s[sel]
        out[rows] = out[rows] - vals[sel] if subtract \
            else out[rows] + vals[sel]
        lo += count
    return out


def greedy_match_kernel(inp: MatchInputs
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential greedy assignment (``match.py`` :80).  Returns (assign
    i32[J] host index or -1, remaining avail f32[H, R]).  The assignment
    is K5 (``greedy``) over one pool in which every job is an exception
    row whose row is its mask, which composes exactly the dense mask;
    the remaining avail is the greedy's own sequential subtraction."""
    J, H = inp.constraint_mask.shape
    dev = inp.job_res.device
    zeros_h = torch.zeros((1, H), dtype=_U8, device=dev)
    assign = greedy(
        inp.job_res[None].contiguous(), inp.valid.to(_U8)[None],
        torch.zeros((1, J), dtype=_U8, device=dev),
        torch.arange(J, dtype=_I32, device=dev)[None], zeros_h, zeros_h,
        inp.constraint_mask.to(torch.bool).view(_U8)[None].contiguous(),
        inp.avail[None].contiguous(), inp.capacity[None].contiguous())[0]
    left = ordered_fold(inp.avail, inp.job_res, assign, assign >= 0,
                        subtract=True)
    return assign, left


def _prefix_admit(proposes, cand, job_res, avail, rank, H: int):
    """Per-host rank-order prefix admission (``match.py`` :89).  Returns
    (admitted bool[J], consumed f32[H, R])."""
    J = proposes.shape[0]
    choice = torch.where(proposes, cand.long(), H)
    order = scanlib.lexsort([rank, choice])
    sorted_choice = choice[order]
    sorted_res = job_res[order] * (sorted_choice < H)[:, None].to(
        job_res.dtype)
    first = torch.ones(J, dtype=torch.bool, device=choice.device)
    first[1:] = sorted_choice[1:] != sorted_choice[:-1]
    seg_cum = scanlib.seg_scan(sorted_res[None].contiguous(),
                               first.to(_U8)[None].contiguous())[0]
    host_avail = avail[torch.clamp(sorted_choice, max=H - 1)]
    fits_prefix = torch.all(seg_cum <= host_avail, dim=1) \
        & (sorted_choice < H)
    admitted = torch.zeros(J, dtype=torch.bool, device=choice.device)
    admitted[order] = fits_prefix
    consumed = ordered_fold(torch.zeros_like(avail), job_res,
                            torch.clamp(choice, max=H - 1), admitted)
    return admitted, consumed


def _build_prefs(inp: MatchInputs, assign, avail, K: int):
    """Top-K hosts per unassigned job by fitness against the current
    availability (``match.py`` :118), in chunks of jobs.  The JAX key is
    the 22-bit quantized fitness above 8 hash bits, bitcast to f32; here
    the same integer, or -1 where infeasible, sits above ``H - 1 - h`` in
    one int64, so every key is distinct and ``topk`` breaks ties at the
    lowest host as ``lax.top_k`` does.  The uint32 hash keeps only its
    low 8 bits, which wrap-around never touches."""
    J, H = inp.constraint_mask.shape
    dev = inp.job_res.device
    used = inp.capacity - avail
    cap = torch.clamp(inp.capacity, min=1e-9)
    hh = torch.arange(H, dtype=torch.int64, device=dev)
    hmix = (hh * 0x9E3779B9) & 0xFF
    low = (H - 1) - hh
    open_ = (assign < 0) & inp.valid
    pref_fit = torch.empty((J, K), dtype=torch.float32, device=dev)
    pref_host = torch.empty((J, K), dtype=_I32, device=dev)
    step = chunk_rows(H)
    for lo in range(0, J, step):
        hi = min(J, lo + step)
        res = inp.job_res[lo:hi]
        feas = torch.all(avail[None, :, :] >= res[:, None, :], dim=2) \
            & inp.constraint_mask[lo:hi] & open_[lo:hi, None]
        fit = (used[None, :, 0] + res[:, 0:1]) / cap[None, :, 0] \
            + (used[None, :, 1] + res[:, 1:2]) / cap[None, :, 1]
        q = (torch.clamp(fit * 0.5, 0.0, 1.0) * float(1 << 22)) \
            .to(_I32).to(torch.int64) << 8
        jmix = (torch.arange(lo, hi, dtype=torch.int64, device=dev)
                * 2654435761) & 0xFF
        key = torch.where(feas, q | (jmix[:, None] ^ hmix[None, :]), -1)
        top = torch.topk((key << 32) | low[None, :], K, dim=1).values
        kint = top >> 32
        pref_host[lo:hi] = ((H - 1) - (top & 0xFFFFFFFF)).to(_I32)
        pref_fit[lo:hi] = torch.where(
            kint >= 0, kint.to(_I32).view(torch.float32),
            torch.full(kint.shape, NEG_INF, device=dev))
    return pref_fit, pref_host


def _auction_rounds(inp: MatchInputs, pref_fit, pref_host, num_rounds: int,
                    assign, avail):
    """``match.py`` :242: rounds of propose + prefix admission."""
    J, H = inp.constraint_mask.shape
    job_idx = torch.arange(J, dtype=_I32, device=assign.device)
    K = pref_host.shape[1]
    pref_ok = pref_fit > NEG_INF
    ptr = torch.zeros(J, dtype=torch.int64, device=assign.device)
    for _ in range(num_rounds):
        active = (assign < 0) & inp.valid & (ptr < K)
        safe = torch.clamp(ptr, max=K - 1)[:, None]
        cand = torch.gather(pref_host, 1, safe)[:, 0].long()
        cand_ok = torch.gather(pref_ok, 1, safe)[:, 0]
        fits_alone = torch.all(avail[cand] >= inp.job_res, dim=1) & cand_ok
        proposes = active & fits_alone
        ptr = torch.where(active & ~fits_alone, ptr + 1, ptr)
        admitted, consumed = _prefix_admit(proposes, cand, inp.job_res,
                                           avail, job_idx, H)
        assign = torch.where(admitted, cand.to(_I32), assign)
        avail = avail - consumed
    return assign, avail


def auction_match_kernel(inp: MatchInputs, *, num_prefs: int = 16,
                         num_rounds: int = 8, num_refresh: int = 64,
                         min_refresh_gain: int = 16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K auction with adaptive refresh passes (``match.py`` :164).
    The ``while_loop`` becomes a Python loop with the same exit test:
    run a pass while the first has not run, or the last pass placed at
    least ``min_refresh_gain`` jobs, and fewer than ``num_refresh`` ran."""
    J, H = inp.constraint_mask.shape
    K = min(num_prefs, H)
    assign = torch.full((J,), -1, dtype=_I32, device=inp.job_res.device)
    avail = inp.avail
    prev, passes = -1, 0
    while True:
        placed = int((assign >= 0).sum())
        if not ((passes == 0 or placed - prev >= min_refresh_gain)
                and passes < num_refresh):
            return assign, avail
        pref_fit, pref_host = _build_prefs(inp, assign, avail, K)
        assign, avail = _auction_rounds(inp, pref_fit, pref_host,
                                        num_rounds, assign, avail)
        prev, passes = placed, passes + 1


def _util(avail, cap):
    return ((cap[:, 0] - avail[:, 0]) / cap[:, 0]
            + (cap[:, 1] - avail[:, 1]) / cap[:, 1]) * 0.5


def _tightest_first(util):
    """``jnp.argsort(-util)``: stable, -0 equal to +0."""
    return scanlib.lexsort([-util])


def _cumsum(x):
    """``jnp.cumsum(x, axis=0)`` in its blocked-16 order (K2 prefix16)."""
    return scanlib.prefix16(x[None].contiguous())[0]


def searchsorted_left(sorted_arr, query):
    """``jnp.searchsorted(side="left")``'s default ('scan') binary search,
    level for level, comparing in JAX's float sort order, so the result
    is the same even where a float prefix is not quite monotone."""
    n = sorted_arr.shape[0]
    keys = scanlib.float_sort_key(sorted_arr)
    q = scanlib.float_sort_key(query)
    low = torch.zeros_like(q)
    high = torch.full_like(q, n)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = q <= keys[mid]
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def _prefix_targets(avail, sigma, dem):
    """Per job, the position in ``sigma`` where its demand prefix falls
    in the capacity prefix, the binding resource deciding."""
    cum_cap = _cumsum(avail[sigma])
    cum_dem = _cumsum(dem)
    k = torch.zeros(dem.shape[0], dtype=torch.int64, device=dem.device)
    for r in range(dem.shape[1]):
        k = torch.maximum(k, searchsorted_left(cum_cap[:, r].contiguous(),
                                               cum_dem[:, r].contiguous()))
    return k


def waterfill_match_kernel(inp: MatchInputs, *, num_rounds: int = 32,
                           num_compaction: int = 16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefix-packing assignment with no J x H work, then tightness-
    improving compaction rounds (``match.py`` :276).  Both
    ``while_loop``s are Python loops with the same exit tests.  The mean
    used utilization is an axis sum in XLA:CPU's window-32 order, which
    is that order for a power-of-two H (as ``pack_match_inputs`` pads)."""
    J, H = inp.constraint_mask.shape
    dev = inp.job_res.device
    res = inp.job_res
    rank = torch.arange(J, dtype=_I32, device=dev)
    rows = rank.long()
    cap = torch.clamp(inp.capacity, min=1e-9)
    assign = torch.full((J,), -1, dtype=_I32, device=dev)
    avail = inp.avail
    skip = torch.zeros(J, dtype=torch.int64, device=dev)
    rnd, changed = 0, True
    while rnd < num_rounds and changed:
        skip_before = skip
        active = (assign < 0) & inp.valid & (skip < H)
        sigma = _tightest_first(_util(avail, cap))
        k = _prefix_targets(avail, sigma, torch.where(
            active[:, None], res, torch.zeros_like(res)))
        cand = sigma[torch.clamp(k + skip, 0, H - 1)]
        fits = torch.all(avail[cand] >= res, dim=1) \
            & inp.constraint_mask[rows, cand]
        proposes = active & fits
        # exponential probe on rejection; an admission resets it
        skip = torch.where(active & ~fits, skip * 2 + 1, skip)
        skip = torch.where(proposes, 0, skip)
        admitted, consumed = _prefix_admit(proposes, cand, res, avail, rank,
                                           H)
        assign = torch.where(admitted, cand.to(_I32), assign)
        avail = avail - consumed
        changed = bool(admitted.any() | (skip != skip_before).any())
        rnd += 1

    rnd, changed = 0, True
    while rnd < num_compaction and changed:
        placed = assign >= 0
        util = _util(avail, cap)
        job_host = torch.clamp(assign, min=0).long()
        job_util = util[job_host]
        holds = torch.zeros(H, dtype=_I32, device=dev).scatter_reduce(
            0, job_host, placed.to(_I32), "amax") > 0
        n_used = torch.clamp(holds.sum(), min=1)
        mean_used_util = scanlib.window32_sum(
            torch.where(holds, util, torch.zeros_like(util))) / n_used
        movers = placed & (job_util < mean_used_util)
        sigma = _tightest_first(util)
        k = _prefix_targets(avail, sigma, torch.where(
            movers[:, None], res, torch.zeros_like(res)))
        cand = sigma[torch.clamp(k, 0, H - 1)]
        fits = (torch.all(avail[cand] >= res, dim=1)
                & inp.constraint_mask[rows, cand]
                & (util[cand] > job_util + 1e-6) & (cand != assign))
        proposes = movers & fits
        moved, consumed = _prefix_admit(proposes, cand, res, avail, rank, H)
        # avail + segment_sum(...) compiles on XLA:CPU to a scatter-add
        # onto avail itself: each freed demand is added to avail in job
        # order, before consumed is subtracted
        avail = ordered_fold(avail, res, job_host, moved) - consumed
        assign = torch.where(moved, cand.to(_I32), assign)
        changed = bool(moved.any())
        rnd += 1
    return assign, avail


# the JAX package's backwards-compatible alias
multipass_match_kernel = auction_match_kernel
