"""The split match path's device dispatch: the port of
``cook_tpu/sched/matcher.py``'s ``Matcher.resolve_backend`` :577,
``_dispatch`` :604, ``_dispatch_device`` :628 and ``_run_kernel`` :657,
as plain functions.  They take numpy and return numpy.

Not ported here: the ``Matcher`` object with its store, plugins, gangs
and launch (they come with the ``Scheduler``), and the ``try/except``
around the device dispatch that fell back to the host greedy.  A failure
on the card raises.  ``backend="cpu"`` still runs the numpy greedy
golden, as in the JAX package: that is a backend the caller chooses.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..config import MatcherConfig
from ..ops import host_prep, reference_impl
from ..ops.match import (MatchInputs, auction_match_kernel,
                         greedy_match_kernel, waterfill_match_kernel)

F32 = np.float32


def resolve_backend(mc: MatcherConfig, num_jobs: int) -> str:
    """The concrete kernel for ``auto``: the bit-exact greedy while the
    job count is at most ``auto_large_j_threshold``; beyond it the
    waterfill ("throughput") or the auction with its waterfill tail
    ("tight")."""
    if mc.backend == "tpu-auction-pallas":  # mutated after validation
        return "tpu-auction"
    if mc.backend == "tpu-megakernel":
        # a cycle backend: when the split path runs, it matches with the
        # greedy, the assignment the fused cycle computes
        return "tpu-greedy"
    if mc.backend != "auto":
        return mc.backend
    if num_jobs <= mc.auto_large_j_threshold:
        return "tpu-greedy"
    return "tpu-auction" if mc.auto_packing == "tight" else "tpu-waterfill"


def dispatch(mc: MatcherConfig, job_res, cmask, avail, cap,
             device="cuda") -> np.ndarray:
    """assign i32[J]: each job's host index, or -1.  ``job_res`` [J, 4],
    ``cmask`` bool[J, H], ``avail`` and ``cap`` [H, 4], as numpy or
    lists."""
    job_res = np.asarray(job_res, dtype=F32).reshape(-1, 4)
    avail = np.asarray(avail, dtype=F32).reshape(-1, 4)
    cap = np.asarray(cap, dtype=F32).reshape(-1, 4)
    cmask = np.asarray(cmask, dtype=bool)
    if mc.backend == "cpu":
        return reference_impl.greedy_match(job_res, cmask, avail, cap)
    return _dispatch_device(mc, job_res, cmask, avail, cap,
                            resolve_device(device))


def _dispatch_device(mc, job_res, cmask, avail, cap, dev) -> np.ndarray:
    backend = resolve_backend(mc, len(job_res))
    if backend == "tpu-waterfill" and mc.backend == "auto" and len(job_res):
        # the waterfill's mask support is safety-only (a sparse row's few
        # allowed hosts can be probed over): dense rows go through the
        # waterfill, the constrained minority through the exact greedy
        # against the availability the waterfill left
        sparse = cmask.mean(axis=1) < mc.sparse_cmask_density
        if sparse.any():
            assign = np.full(len(job_res), -1, dtype=np.int32)
            avail_left = avail
            didx = np.flatnonzero(~sparse)
            if didx.size:
                a, avail_left = _run_kernel(
                    "tpu-waterfill", mc, job_res[didx], cmask[didx],
                    avail_left, cap, dev)
                assign[didx] = a
            sidx = np.flatnonzero(sparse)
            a, _ = _run_kernel("tpu-greedy", mc, job_res[sidx], cmask[sidx],
                               avail_left, cap, dev)
            assign[sidx] = a
            return assign
    return _run_kernel(backend, mc, job_res, cmask, avail, cap, dev)[0]


def _run_kernel(backend: str, mc: MatcherConfig, job_res, cmask, avail,
                cap, dev):
    """One kernel call on ``dev``; returns (assign over the real jobs,
    remaining availability over the real hosts), as numpy."""
    arrays = host_prep.pack_match_inputs(job_res, cmask, avail, cap)
    inp = MatchInputs(*(torch.from_numpy(arrays[k]).to(dev) for k in (
        "job_res", "constraint_mask", "avail", "capacity", "valid")))
    if backend == "tpu-auction":
        assign, left = auction_match_kernel(
            inp, num_prefs=mc.auction_num_prefs,
            num_rounds=mc.auction_num_rounds,
            num_refresh=mc.auction_num_refresh,
            min_refresh_gain=mc.auction_min_refresh_gain)
        # the waterfill places the auction's leftovers; placed jobs keep
        # their hosts, baked into the availability the tail sees
        tail_assign, left = waterfill_match_kernel(
            inp._replace(avail=left, valid=inp.valid & (assign < 0)),
            num_rounds=mc.waterfill_num_rounds,
            num_compaction=mc.waterfill_num_compaction)
        assign = torch.where(assign < 0, tail_assign, assign)
    elif backend == "tpu-waterfill":
        assign, left = waterfill_match_kernel(
            inp, num_rounds=mc.waterfill_num_rounds,
            num_compaction=mc.waterfill_num_compaction)
    else:
        assign, left = greedy_match_kernel(inp)
    return (assign.cpu().numpy()[:arrays["num_jobs"]],
            left.cpu().numpy()[:len(avail)])
