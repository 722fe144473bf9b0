"""Build, load and call the port's CUDA kernels (``csrc/*.cu``): the
cycle's stage kernels K1-K6 and the top-K preference kernels.

The sources are compiled at first use, on the machine with the card,
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false`` (no
fast math), one ``nvcc -c`` per source started together, then linked
into one shared library with a plain C interface and loaded with
``ctypes``.  The library lands in ``build/cuda/`` at the root of the
checkout, named by a hash of the sources and flags, so an edit rebuilds.

:func:`stage` turns a launcher into a stage wrapper: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the kernel or raises.
There is no path from a failed launch to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, List, Optional

import torch

from . import telemetry

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-Xcompiler", "-fPIC"]

# argument codes: p pointer, i int, l long long, f float
_SIGNATURES = {
    "k1_expand": "pipppppppppppiffffpiffff" + "p" * 15 + "iliiiip",
    "k2_seg_f32": "pppiipppilip",
    "k2_seg_count": "pippppilp",
    "k2_prefix16": "pppilip",
    "k2_int_scan": "piiiiippilp",
    "k3_sort_rank": "pppippppilp",
    "k3_sort_user": "pippppilp",
    "k4_rank_over": "ppppilp",
    "k4_rank_keep": "pppippilp",
    "k4_rank_dru": "ppppippilp",
    "k4_gather": "p" * 16 + "ilp",
    "k4_queue": "p" * 7 + "ilp",
    "k4_user_gather": "p" * 6 + "ilp",
    "k4_user_quota": "p" * 7 + "ilp",
    "k4_accept": "p" * 6 + "ilp",
    "k4_match_valid": "p" * 4 + "ilp",
    "k4_compact": "p" * 16 + "ilip",
    "k5_greedy": "p" * 11 + "iiiip",
    "k6_gang": "p" * 11 + "iiliiip",
    "topk_dense": "p" * 9 + "iiiip",
    "topk_structured": "p" * 12 + "iiiip",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int,
           "l": ctypes.c_longlong, "f": ctypes.c_float}

_LIB: Optional[ctypes.CDLL] = None
BUILD_LOG = ""


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
    ``-Xptxas -v``; the compiler output lands in ``BUILD_LOG``."""
    global BUILD_LOG
    out = BUILD_DIR / f"libcook_cycle_{_digest()}.so"
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
    return out


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        dll = ctypes.CDLL(str(build()))
        for name, sig in _SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = [_CTYPES[c] for c in sig]
            fn.restype = ctypes.c_int
        _LIB = dll
    return _LIB


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def call(name: str, kernel: str, *args) -> None:
    """Launch C entry ``name`` on the current stream; raise if it reports
    a CUDA error, else count one launch of ``kernel``."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
    telemetry.counter(kernel).add()


_RECORDER: Optional[list] = None


@contextlib.contextmanager
def recording():
    """Collect every kernel launch made through a stage wrapper inside
    the block as (wrapper, args, kwargs), so a caller can replay each
    launch against its plain version on the same inputs."""
    global _RECORDER
    _RECORDER = calls = []
    try:
        yield calls
    finally:
        _RECORDER = None


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
            with torch.cuda.device(dev):
                out = launch(*args, **kw)
            if _RECORDER is not None:
                _RECORDER.append((wrapper, args, kw))
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
