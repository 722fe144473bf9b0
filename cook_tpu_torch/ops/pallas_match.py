"""Top-K host preferences per job: the port of
``cook_tpu/ops/pallas_match.py`` (``topk_prefs`` :298 over a dense mask,
``topk_prefs_structured`` :250 over the structured mask form).

For each job, the K hosts of highest cpuMemBinPacker fitness
``((cap0 - av0 + r0) / max(cap0, 1e-9) + (cap1 - av1 + r1) /
max(cap1, 1e-9)) * 0.5`` among the feasible ones (resource fit AND the
mask), best first, ties at the lowest host index as ``lax.top_k`` breaks
them; infeasible entries score -inf and their host index means nothing.

The Pallas kernels (``_kernel`` :116 and ``_structured_kernel`` :162)
score (job tile, host tile) blocks in VMEM and carry a running top-K
across the sequential host grid (``_merge_running_topk`` :78).  On the
card both become ``csrc/topk.cu``: one thread per job keeps a running
top-K in registers while it walks its hosts in increasing order, a
candidate entering only when strictly better than the K-th entry, so no
[J, H] score ever reaches device memory.  The plain versions below
materialize the score in chunks of jobs and take the top K through a
stable descending sort.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from . import cuda_lib

NEG_INF = float("-inf")
# score rows per chunk of the plain versions: about 2^24 scores at a time
CHUNK_SCORES = 1 << 24


def _as_tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(
        device=dev, dtype=dtype).contiguous()


def chunk_rows(H: int) -> int:
    return max(1, CHUNK_SCORES // max(H, 1))


def score(job_res, feas, avail, capacity) -> torch.Tensor:
    """f32 [j, H]: the Pallas kernel's fitness (accumulated from zero, as
    ``_binpack_score`` :67 does) where ``feas``, else -inf."""
    fit = torch.zeros(feas.shape, dtype=torch.float32, device=feas.device)
    for r in (0, 1):
        cap = torch.clamp(capacity[:, r], min=1e-9)
        used = capacity[:, r] - avail[:, r]
        fit += (used[None, :] + job_res[:, r:r + 1]) / cap[None, :]
    return torch.where(feas, fit * 0.5, torch.full_like(fit, NEG_INF))


def resource_fit(job_res, avail) -> torch.Tensor:
    return torch.all(avail[None, :, :] >= job_res[:, None, :], dim=2)


def structured_mask(job_res, valid, exc_id, host_gpu, host_blocked,
                    exc_mask) -> torch.Tensor:
    """bool [j, H]: the exception row where ``exc_id >= 0``, else gpu
    isolation (gpu jobs on gpu hosts only, and the reverse) minus blocked
    hosts; nothing for invalid jobs."""
    hg = host_gpu[None, :] != 0
    base = torch.where((job_res[:, 2] > 0)[:, None], hg, ~hg) \
        & (host_blocked[None, :] == 0)
    eid = exc_id.long()
    if exc_mask.shape[0]:
        rows = exc_mask[torch.clamp(eid, min=0)] != 0
        base = torch.where((eid >= 0)[:, None], rows, base)
    return base & (valid != 0)[:, None]


def take_topk(score_rows: torch.Tensor, k: int):
    """The first ``k`` of a stable descending sort: ties keep the lowest
    host first (``torch.topk`` promises no order among ties)."""
    fit, host = torch.sort(score_rows, dim=1, descending=True, stable=True)
    return fit[:, :k].contiguous(), host[:, :k].to(torch.int32).contiguous()


def _chunked(J: int, H: int, k: int, mask_of, job_res, avail, capacity,
             device):
    fit = torch.empty((J, k), dtype=torch.float32, device=device)
    host = torch.empty((J, k), dtype=torch.int32, device=device)
    step = chunk_rows(H)
    for lo in range(0, J, step):
        hi = min(J, lo + step)
        res = job_res[lo:hi]
        feas = resource_fit(res, avail) & mask_of(lo, hi)
        fit[lo:hi], host[lo:hi] = take_topk(
            score(res, feas, avail, capacity), k)
    return fit, host


def _dense_plain(job_res, cmask, valid, avail, capacity, k):
    J, H = cmask.shape
    return _chunked(J, H, k, lambda lo, hi: (cmask[lo:hi] != 0)
                    & (valid[lo:hi] != 0)[:, None],
                    job_res, avail, capacity, job_res.device)


def _structured_plain(job_res, valid, exc_id, host_gpu, host_blocked,
                      exc_mask, avail, capacity, k):
    J, H = job_res.shape[0], avail.shape[0]
    return _chunked(J, H, k, lambda lo, hi: structured_mask(
        job_res[lo:hi], valid[lo:hi], exc_id[lo:hi], host_gpu, host_blocked,
        exc_mask), job_res, avail, capacity, job_res.device)


# ----------------------------------------------------------- the kernels
KERNEL_DENSE = "topk_dense"
KERNEL_STRUCTURED = "topk_structured"
JOBS_PER_BLOCK = 128     # csrc/topk.cu kTopkThreads
HOSTS_PER_TILE = 1024    # csrc/topk.cu kTopkTile
MAX_K = 16               # csrc/topk.cu keeps at most 16 entries a job
BLOCKS_PER_SM = 4        # scan blocks wanted on each SM of the card
_F32, _U8, _I32 = torch.float32, torch.uint8, torch.int32


def kept(k: int) -> int:
    """Entries each thread keeps: 8 or 16 (csrc/topk.cu)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk kernels take 1 <= k <= {MAX_K}, got {k}")
    return 8 if k <= 8 else 16


def host_splits(J: int, H: int, sms: int) -> int:
    """Host ranges scanned by separate blocks, so that a small J still
    gives ``BLOCKS_PER_SM`` blocks to each of the card's ``sms`` SMs;
    their partial lists are merged in host order."""
    job_blocks = max(1, -(-J // JOBS_PER_BLOCK))
    tiles = max(1, -(-H // HOSTS_PER_TILE))
    return max(1, min(tiles, -(-BLOCKS_PER_SM * sms // job_blocks)))


def _outputs(J: int, H: int, k: int, device):
    S = host_splits(J, H, torch.cuda.get_device_properties(device)
                    .multi_processor_count)
    kt = kept(k)
    return (S, torch.empty((S, J, kt), dtype=_F32, device=device),
            torch.empty((S, J, kt), dtype=_I32, device=device),
            torch.empty((J, k), dtype=_F32, device=device),
            torch.empty((J, k), dtype=_I32, device=device))


@cuda_lib.stage(KERNEL_DENSE, _dense_plain, (_F32, _U8, _U8, _F32, _F32))
def topk_dense(job_res, cmask, valid, avail, capacity, k):
    """(fit f32[J, k], host i32[J, k]) over a dense u8 mask [J, H]."""
    J, H = cmask.shape
    cuda_lib.check(job_res, _F32, (J, 4), "job_res")
    cuda_lib.check(valid, _U8, (J,), "valid")
    cuda_lib.check(avail, _F32, (H, 4), "avail")
    cuda_lib.check(capacity, _F32, (H, 4), "capacity")
    S, pf, ph, fit, host = _outputs(J, H, k, job_res.device)
    cuda_lib.call("topk_dense", KERNEL_DENSE, job_res.data_ptr(),
                  cmask.data_ptr(), valid.data_ptr(), avail.data_ptr(),
                  capacity.data_ptr(), pf.data_ptr(), ph.data_ptr(),
                  fit.data_ptr(), host.data_ptr(), J, H, k, S)
    return fit, host


@cuda_lib.stage(KERNEL_STRUCTURED, _structured_plain,
                (_F32, _U8, _I32, _U8, _U8, _U8, _F32, _F32))
def topk_structured(job_res, valid, exc_id, host_gpu, host_blocked,
                    exc_mask, avail, capacity, k):
    """(fit f32[J, k], host i32[J, k]) over the structured mask: u8 host
    vectors [H], exception rows u8 [E, H] selected by ``exc_id`` i32[J]."""
    J, H = job_res.shape[0], avail.shape[0]
    E = exc_mask.shape[0]
    cuda_lib.check(job_res, _F32, (J, 4), "job_res")
    for t, shape, name in ((valid, (J,), "valid"), (exc_id, (J,), "exc_id"),
                           (host_gpu, (H,), "host_gpu"),
                           (host_blocked, (H,), "host_blocked"),
                           (exc_mask, (E, H), "exc_mask"),
                           (avail, (H, 4), "avail"),
                           (capacity, (H, 4), "capacity")):
        cuda_lib.check(t, t.dtype, shape, name)
    S, pf, ph, fit, host = _outputs(J, H, k, job_res.device)
    cuda_lib.call("topk_structured", KERNEL_STRUCTURED, job_res.data_ptr(),
                  valid.data_ptr(), exc_id.data_ptr(), host_gpu.data_ptr(),
                  host_blocked.data_ptr(), cuda_lib.ptr(exc_mask),
                  avail.data_ptr(), capacity.data_ptr(), pf.data_ptr(),
                  ph.data_ptr(), fit.data_ptr(), host.data_ptr(), J, H, k, S)
    return fit, host


# ------------------------------------------------------------ entry points
def topk_prefs(job_res, constraint_mask, valid, avail, capacity,
               k: int = 16, *, device="cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K host preferences per job over a dense mask.  Arguments as
    ``ops.match.MatchInputs``: job_res f32[J, R], constraint_mask
    bool[J, H], valid bool[J], avail/capacity f32[H, R] (numpy or
    tensors).  Returns (fit f32[J, K], host i32[J, K]) with K = min(k, H)
    on ``device``: the CUDA kernel on a card, the plain version on the
    CPU.  K must lie in 1..16 on every device (the kernel keeps at most
    16 entries a job; the JAX entry points take any k)."""
    dev = resolve_device(device)
    H = int(np.shape(avail)[0])
    k = min(k, H)
    kept(k)
    return topk_dense(_as_tensor(job_res, _F32, dev),
                      _as_tensor(constraint_mask, torch.bool, dev)
                      .view(_U8), _as_tensor(valid, torch.bool, dev)
                      .view(_U8), _as_tensor(avail, _F32, dev),
                      _as_tensor(capacity, _F32, dev), k)


def topk_prefs_structured(job_res, valid, host_gpu, host_blocked, exc_id,
                          exc_mask, avail, capacity, k: int = 16, *,
                          device="cuda"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K host preferences from the structured mask form: per-host gpu
    and blocked vectors, and exception rows ``exc_mask`` bool[E, H] for
    the jobs whose ``exc_id`` i32[J] is >= 0.  No [J, H] array exists on
    the card.  Returns as :func:`topk_prefs`, with the same limit on K."""
    dev = resolve_device(device)
    H = int(np.shape(avail)[0])
    k = min(k, H)
    kept(k)
    as_u8 = lambda x: _as_tensor(x, torch.bool, dev).view(_U8)  # noqa: E731
    exc_id = _as_tensor(exc_id, _I32, dev)
    exc_mask = as_u8(exc_mask)
    if bool((exc_id >= exc_mask.shape[0]).any()):
        raise ValueError("topk_prefs_structured: exc_id names a row past "
                         f"exc_mask's {exc_mask.shape[0]}")
    return topk_structured(
        _as_tensor(job_res, _F32, dev), as_u8(valid), exc_id,
        as_u8(host_gpu), as_u8(host_blocked), exc_mask,
        _as_tensor(avail, _F32, dev), _as_tensor(capacity, _F32, dev), k)
