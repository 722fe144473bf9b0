"""Build, load and call the port's CUDA kernels (``csrc/*.cu``): the
cycle's stage kernels K1-K6 (K4 inside K2's launches, K6 inside K5's)
and the top-K preference kernels.

The sources are compiled at first use, on the machine with the card,
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false`` (no
fast math), one ``nvcc -c`` per source started together, then linked
into one shared library with a plain C interface and loaded with
``ctypes``.  The library lands in ``build/cuda/`` at the root of the
checkout (or in the directory ``ops/telemetry.enable_compilation_cache``
names), named by a hash of the sources and flags, so an edit rebuilds;
``LAST_BUILD`` says whether the last :func:`build` found the library or
ran nvcc, and how long that took.

:func:`stage` turns a launcher into a stage wrapper: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel or raises.
There is no path from a failed launch to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional

import torch

from . import telemetry

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC"]

# argument codes: p pointer, i int, l long long, f float.  Every K2
# entry ends with scan_plan's geometry (ops/scan.k2_launch) and the
# stream.
_GEO = "piliiilli" + "p"
_SIGNATURES = {
    "k1_expand": "pipppppppppppiffffpiffff" + "p" * 16 + "iil" + "i" * 12
    + "p",
    "k2_seg_f32": "pppiipi" + _GEO,
    "k2_seg_count": "pipp" + _GEO,
    "k2_prefix16": "ppi" + _GEO,
    "k2_int_scan": "piiiiip" + _GEO,
    "k24_rank_over": "p" * 5 + _GEO,
    "k24_rank_keep": "ppppipp" + _GEO,
    "k24_rank_dru": "pppppipp" + _GEO,
    "k24_queue": "p" * 20 + _GEO,
    "k24_user_quota": "p" * 9 + _GEO,
    "k24_accept": "p" * 7 + _GEO,
    "k24_match_valid": "ppp" + _GEO,
    "k24_compact": "pppipppp" + _GEO,
    "k3_sort_rank": "pppippppiliiiiillllip",
    "k3_sort_user": "pippppiliiiiillllip",
    "k4_compact_slots": "p" * 14 + "ilip",
    "k5_greedy": "p" * 11 + "iiii" + "iiiiiiil" + "ip",
    "k5_div_check": "pppppppip",
    "k56_greedy_gang": "p" * 19 + "i" * 11 + "lil" + "iiii" + "p",
    "topk_dense": "p" * 9 + "i" * 8 + "p",
    "topk_structured": "p" * 12 + "i" * 8 + "p",
    "topk_blocks_per_sm": "ii",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int,
           "l": ctypes.c_longlong, "f": ctypes.c_float}

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""
# the last build(): {"path", "built" (nvcc ran), "seconds"}, and the
# library's load ("load_s", by lib())
LAST_BUILD: dict = {}


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "cook_tpu_torch's kernels")


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link the shared library
    (skipped when a library of the same hash exists).  ``verbose`` adds
    ``-Xptxas -v``; the compiler output lands in ``BUILD_LOG``.

    Processes that build into one directory together (the shard workers
    of ``sched/shard``, a node's standby beside its leader) take turns:
    the check, the compile and the link run under an exclusive
    ``flock`` on ``BUILD_DIR/.build.lock``, so no process links an
    object another is still writing, and the later ones find the
    library the first one linked."""
    t0 = time.perf_counter()
    out = BUILD_DIR / f"libcook_cycle_{_digest()}.so"
    if out.exists() and not verbose:
        LAST_BUILD.update(path=str(out), built=False,
                          seconds=time.perf_counter() - t0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists() and not verbose:
                LAST_BUILD.update(path=str(out), built=False,
                                  seconds=time.perf_counter() - t0)
                return out
            _compile_and_link(out, verbose)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    LAST_BUILD.update(path=str(out), built=True,
                      seconds=time.perf_counter() - t0)
    return out


def _compile_and_link(out: Path, verbose: bool) -> None:
    global BUILD_LOG
    cc = nvcc()
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    procs = []
    objs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{_digest()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [cc, *flags, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for src, pr in procs:
        text, _ = pr.communicate()
        logs.append(f"== {src.name}\n{text}")
        if pr.returncode != 0:
            failed.append(src.name)
    BUILD_LOG = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run([cc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}")
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path = build()
        t0 = time.perf_counter()
        dll = ctypes.CDLL(str(path))
        for name, sig in _SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = [_CTYPES[c] for c in sig]
            fn.restype = ctypes.c_int
        LAST_BUILD["load_s"] = time.perf_counter() - t0
        _LIB = dll
    return _LIB


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def call(name: str, kernel: str, *args, plan=None) -> None:
    """Launch C entry ``name`` on the current stream; raise if it reports
    a CUDA error, else count one launch of ``kernel``.  ``plan``, the
    launch geometry the caller built (K2's ``ScanPlan``), is kept with
    the recorded call."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    telemetry.counter(kernel).add()
    plans = getattr(_LOCAL, "plans", None)
    if plan is not None and plans is not None:
        plans.append(plan)


class Launch(NamedTuple):
    """One recorded stage-wrapper call: the wrapper, its arguments, and
    the plans its launches were given.  Under ``recording(snapshot=
    True)`` the tensors of ``args`` and ``kw`` are copies taken on the
    launch's stream just before it, and ``live`` holds the (args, kw)
    the call was given."""
    wrapper: Callable
    args: tuple
    kw: dict
    plans: tuple
    live: Optional[tuple] = None


# the open recording: (its list of calls, whether it snapshots), one
# name so that a launching thread reads both at once
_RECORDER: Optional[tuple] = None
# the plans of the wrapper call this thread is making: a node launches
# from more than one thread (the match loop, the rebalancer)
_LOCAL = threading.local()


@contextlib.contextmanager
def recording(snapshot: bool = False):
    """Collect every kernel launch made through a stage wrapper inside
    the block as a :class:`Launch`, so a caller can replay each launch
    against its plain version on the same inputs.  ``snapshot`` copies
    each launch's tensor arguments before it runs: a caller that replays
    later, after a later stage or another thread may have written those
    tensors in place (the next cycle's scatter into the resident
    buffers), replays the inputs as they were launched."""
    global _RECORDER
    calls = []
    _RECORDER = (calls, snapshot)
    try:
        yield calls
    finally:
        _RECORDER = None


def _copied(value):
    return value.clone() if isinstance(value, torch.Tensor) else value


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise TypeError("stage wrapper called without a tensor")


def stage(kernel: str, plain: Callable, dtypes=()):
    """Make a stage wrapper from a launcher.  CPU tensors go to ``plain``
    (the plain PyTorch version); CUDA tensors to the kernel, after every
    tensor is checked to be contiguous on the device and positional
    tensor ``i`` to have ``dtypes[i]`` (None: the launcher checks)."""
    def deco(launch):
        name = launch.__name__

        @functools.wraps(launch)
        def wrapper(*args, **kw):
            dev = _device_of(args)
            if dev.type == "cpu":
                return plain(*args, **kw)
            if dev.type != "cuda":
                raise ValueError(f"{name}: no kernel for {dev}")
            for i, a in enumerate(list(args) + list(kw.values())):
                if not isinstance(a, torch.Tensor):
                    continue
                if a.device != dev or not a.is_contiguous():
                    raise ValueError(f"{name}: tensor argument {i} must be "
                                     f"contiguous on {dev}")
                want = dtypes[i] if i < min(len(dtypes), len(args)) else None
                if want is not None and a.dtype != want:
                    raise ValueError(f"{name}: tensor argument {i} must be "
                                     f"{want}, got {a.dtype}")
            # the launch goes to the recording open when it began
            recorder, snapshot = _RECORDER or (None, False)
            _LOCAL.plans = plans = [] if recorder is not None else None
            try:
                with torch.cuda.device(dev):
                    if recorder is not None and snapshot:
                        # enqueued before the launch: what it will read
                        rec_args = tuple(_copied(a) for a in args)
                        rec_kw = {k: _copied(v) for k, v in kw.items()}
                    out = launch(*args, **kw)
            finally:
                _LOCAL.plans = None
            if recorder is not None:
                recorder.append(
                    Launch(wrapper, rec_args, rec_kw, tuple(plans),
                           (args, kw)) if snapshot
                    else Launch(wrapper, args, kw, tuple(plans)))
            return out
        wrapper.plain = plain
        wrapper.launch = launch
        wrapper.dtypes = dtypes
        wrapper.kernel = kernel
        telemetry.counter(kernel)
        return wrapper
    return deco


def check(t: torch.Tensor, dtype, shape=None, name: str = "tensor"):
    """Contiguous CUDA tensor of ``dtype`` (and ``shape``) or raise."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous cuda {dtype}, got "
                         f"{t.device} {t.dtype} contiguous="
                         f"{t.is_contiguous()}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t
