"""Greedy bin-packing assignment, plain PyTorch (``cook_tpu/ops/match.py``
``_fitness`` :50 and ``greedy_assign`` :60): jobs in rank order, each
placed on the feasible host of highest cpuMemBinPacker fitness, ties to
the lowest host index.  On the card this is kernel K5 (``greedy``
below, ``csrc/greedy.cu``)."""

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
