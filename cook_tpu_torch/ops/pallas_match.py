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
[J, H] score ever reaches device memory.  Blocks stage tiles of hosts
(and of the mask) in shared memory with each host's terms computed once;
a conservative pre-filter of two FMAs a pair skips the pairs that
cannot beat a job's K-th entry (the source gives its error argument).
The plain versions below materialize the score in chunks of jobs and
take the top K through a stable descending sort.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

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
    host first (``torch.topk`` promises no order among ties).  A row
    holding a NaN score becomes that NaN (its first) with host 0, as the
    Pallas merge's running max leaves it."""
    fit, host = torch.sort(score_rows, dim=1, descending=True, stable=True)
    fit, host = fit[:, :k], host[:, :k].to(torch.int32)
    nan = torch.isnan(score_rows)
    first = score_rows.gather(1, torch.argmax(nan.to(torch.uint8), dim=1,
                                              keepdim=True))
    rows = nan.any(dim=1, keepdim=True)
    return (torch.where(rows, first.expand_as(fit), fit).contiguous(),
            torch.where(rows, torch.zeros_like(host), host).contiguous())


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
# The geometry csrc/topk.cu is compiled for (its constants of the same
# meaning; the C entries refuse any other).
STRUCT_THREADS = 256     # kStructThreads: threads (and jobs) a scan block
DENSE_THREADS = 128      # kDenseThreads
STRUCT_TILE = 1024       # kStructTile: hosts a tile, structured form
DENSE_TILE = 128         # kDenseTile: hosts a tile, dense form
EXC_SLOTS = 8            # kExcSlots: exception rows staged a round
ROW_PAD = 16             # kRowPad: bytes after each staged mask row
HOST_BYTES = 56          # kHostBytes: a host's records in shared memory
MAX_K = 16               # csrc/topk.cu keeps at most 16 entries a job
_F32, _U8, _I32 = torch.float32, torch.uint8, torch.int32


def kept(k: int) -> int:
    """Entries each thread keeps: 8 or 16 (csrc/topk.cu)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk kernels take 1 <= k <= {MAX_K}, got {k}")
    return 8 if k <= 8 else 16


def jobs_per_block(dense: bool) -> int:
    """Jobs a scan block: one a thread."""
    return DENSE_THREADS if dense else STRUCT_THREADS


def smem_bytes(dense: bool) -> int:
    """A scan block's dynamic shared memory: the host records of a tile,
    then two buffers of the block's mask rows (dense) or the two class
    rows and ``EXC_SLOTS`` exception rows (structured)."""
    tile = DENSE_TILE if dense else STRUCT_TILE
    rows = 2 * jobs_per_block(True) * (tile + ROW_PAD) if dense \
        else 2 * tile + EXC_SLOTS * (tile + ROW_PAD)
    return tile * HOST_BYTES + rows


class TopkPlan(NamedTuple):
    """One call's launch: ``splits`` host ranges of ``per`` hosts (whole
    tiles) for each block of ``jobs`` jobs (grid ``job_blocks x
    splits``), then the merge."""
    tile: int
    smem: int
    jobs: int
    job_blocks: int
    splits: int
    per: int


@functools.lru_cache(maxsize=64)
def topk_plan(J: int, H: int, dense: bool, sms: int,
              blocks_per_sm: int) -> TopkPlan:
    """Split the hosts where the jobs alone leave the card's ``sms`` SMs
    (``blocks_per_sm`` scan blocks each) idle: the split count whose
    waves of blocks times (tiles a block + 1, the block's own set-up and
    its share of the merge) is least, the fewest splits on a tie.  Each
    split's partial lists are merged in host order."""
    if H < 1:
        raise ValueError("topk kernels need H >= 1")
    tile = DENSE_TILE if dense else STRUCT_TILE
    jobs = jobs_per_block(dense)
    job_blocks = max(1, -(-J // jobs))
    tiles = -(-H // tile)
    slots = max(1, sms * blocks_per_sm)
    best = None
    for S in range(1, tiles + 1):
        per_tiles = -(-tiles // S)
        cost = -(-job_blocks * S // slots) * (per_tiles + 1)
        if best is None or cost < best[0]:
            best = (cost, S, per_tiles)
    _, S, per_tiles = best
    return TopkPlan(tile=tile, smem=smem_bytes(dense), jobs=jobs,
                    job_blocks=job_blocks, splits=S, per=per_tiles * tile)


@functools.lru_cache(maxsize=16)
def blocks_per_sm(dense: bool, k: int, device_index: int) -> int:
    """Scan blocks of the form an SM of the card holds at once (the
    CUDA occupancy calculator, through the library)."""
    with torch.cuda.device(device_index):
        n = cuda_lib.lib().topk_blocks_per_sm(int(dense), k)
    if n < 1:
        raise RuntimeError("topk: the scan kernel fits no SM")
    return n


def _plan(J: int, H: int, k: int, dense: bool, device) -> TopkPlan:
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    return topk_plan(J, H, dense, sms, blocks_per_sm(dense, kept(k), idx))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where it does not start on 16 bytes (the kernels
    read it a float4 at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _outputs(J: int, k: int, plan: TopkPlan, device):
    kt = kept(k)
    S = plan.splits
    return (torch.empty((S, J, kt), dtype=_F32, device=device),
            torch.empty((S, J, kt), dtype=_I32, device=device),
            torch.empty((J, k), dtype=_F32, device=device),
            torch.empty((J, k), dtype=_I32, device=device))


def _geometry(plan: TopkPlan):
    return (plan.splits, plan.per, plan.tile, plan.jobs, plan.smem)


@cuda_lib.stage(KERNEL_DENSE, _dense_plain, (_F32, _U8, _U8, _F32, _F32))
def topk_dense(job_res, cmask, valid, avail, capacity, k):
    """(fit f32[J, k], host i32[J, k]) over a dense u8 mask [J, H]."""
    J, H = cmask.shape
    cuda_lib.check(job_res, _F32, (J, 4), "job_res")
    cuda_lib.check(valid, _U8, (J,), "valid")
    cuda_lib.check(avail, _F32, (H, 4), "avail")
    cuda_lib.check(capacity, _F32, (H, 4), "capacity")
    job_res, avail, capacity = map(_aligned, (job_res, avail, capacity))
    plan = _plan(J, H, k, True, job_res.device)
    pf, ph, fit, host = _outputs(J, k, plan, job_res.device)
    cuda_lib.call("topk_dense", KERNEL_DENSE, job_res.data_ptr(),
                  cmask.data_ptr(), valid.data_ptr(), avail.data_ptr(),
                  capacity.data_ptr(), pf.data_ptr(), ph.data_ptr(),
                  fit.data_ptr(), host.data_ptr(), J, H, k, *_geometry(plan),
                  plan=plan)
    return fit, host


@cuda_lib.stage(KERNEL_STRUCTURED, _structured_plain,
                (_F32, _U8, _I32, _U8, _U8, _U8, _F32, _F32))
def topk_structured(job_res, valid, exc_id, host_gpu, host_blocked,
                    exc_mask, avail, capacity, k):
    """(fit f32[J, k], host i32[J, k]) over the structured mask: u8 host
    vectors [H], exception rows u8 [E, H] selected by ``exc_id`` i32[J]
    (each below E)."""
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
    job_res, avail, capacity = map(_aligned, (job_res, avail, capacity))
    plan = _plan(J, H, k, False, job_res.device)
    pf, ph, fit, host = _outputs(J, k, plan, job_res.device)
    cuda_lib.call("topk_structured", KERNEL_STRUCTURED, job_res.data_ptr(),
                  valid.data_ptr(), exc_id.data_ptr(), host_gpu.data_ptr(),
                  host_blocked.data_ptr(), cuda_lib.ptr(exc_mask),
                  avail.data_ptr(), capacity.data_ptr(), pf.data_ptr(),
                  ph.data_ptr(), fit.data_ptr(), host.data_ptr(), J, H, k,
                  *_geometry(plan), plan=plan)
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
