#!/usr/bin/env python3
"""Top-K kernel geometries side by side on one CUDA card.

Each geometry (threads a block of each form, one job a thread, hosts
a tile of each form) is built from ``cook_tpu_torch/ops/csrc/topk.cu`` with its
constants replaced, into a library of its own, with ptxas's report of
registers and spills.  Each is held against the plain version on
``chip_smoke.py``'s bench worlds (structured: 100,000 jobs x 50,000
hosts, E = 256; dense: 10,000 x 50,000) and timed there (CUDA events,
and torch.profiler's device time), in turns, forward then backward.
Then the dense form's host splits are swept on the source's own
geometry.  A geometry marked ``scan_only`` is timed without its exact
path (the pre-filter's threshold set past every fit, so no pair
becomes a candidate): what the walk over the pairs costs alone.  Its
results are not the function's, so it is not held to the plain
version.

Usage: ``python3 scripts/topk_geometry_sweep.py`` from the root of a
checkout, on a machine with one CUDA card and nvcc; writes into
build/variants.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cook_tpu_torch.ops import cuda_lib  # noqa: E402
from cook_tpu_torch.ops import pallas_match as tpm  # noqa: E402

# name: (kStructThreads, kDenseThreads, kStructTile, kDenseTile); the
# first is the source's own
GEOMETRIES = {"s256x1024_d128x128": (256, 128, 1024, 128),
              "s128x1024_d128x256": (128, 128, 1024, 256),
              "s256x512_d128x64": (256, 128, 512, 64),
              "s256x1024_d128x128_scan_only": (256, 128, 1024, 128)}
SCAN_ONLY = (("!(est <= q.top.v[KT - 1])", "!(est <= 3e38f)"),)
DENSE_SPLITS = (1, 4, 8, 13, 20)
DENSE_GEOMETRY = "s256x1024_d128x128"
REPS = 5


def set_const(text, name, value):
    out, n = re.subn(rf"(constexpr\s+int\s+{name}\s*=\s*)[^;]+;",
                     rf"\g<1>{value};", text)
    assert n == 1, name
    return out


def load(path):
    dll = ctypes.CDLL(str(path))
    for name in ("topk_dense", "topk_structured", "topk_blocks_per_sm"):
        getattr(dll, name).argtypes = [cuda_lib._CTYPES[c] for c in
                                       cuda_lib._SIGNATURES[name]]
        getattr(dll, name).restype = ctypes.c_int
    return dll


def use(dll, geometry):
    """Point the wrappers at a variant library and its plan constants
    (the cached plans and occupancies are the previous variant's)."""
    sthreads, dthreads, stile, dtile = geometry
    cuda_lib._LIB = dll
    tpm.STRUCT_THREADS, tpm.DENSE_THREADS = sthreads, dthreads
    tpm.STRUCT_TILE, tpm.DENSE_TILE = stile, dtile
    tpm.blocks_per_sm.cache_clear()
    tpm.topk_plan.cache_clear()


def ptxas_lines(text):
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and "scan" in name:
            out.append([name, int(m.group(1)), int(m.group(2))])
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "scan" in name and out and out[-1][0] == name:
            out[-1].append(int(m.group(1)))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("topk_geometry_sweep: no CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    src = ROOT / "cook_tpu_torch/ops/csrc"
    vdir = ROOT / "build/variants"
    vdir.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.cuh"):
        (vdir / f.name).write_text(f.read_text())
    nvcc = [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v"]
    text = (src / "topk.cu").read_text()
    procs = {}
    for name, (sthr, dthr, stile, dtile) in GEOMETRIES.items():
        t = text
        for k, v in (("kStructThreads", sthr), ("kDenseThreads", dthr),
                     ("kStructTile", stile), ("kDenseTile", dtile)):
            t = set_const(t, k, v)
        if name.endswith("scan_only"):
            for old, new in SCAN_ONLY:
                assert old in t, old
                t = t.replace(old, new)
        (vdir / f"topk_{name}.cu").write_text(t)
        procs[name] = subprocess.Popen(
            nvcc + ["-shared", str(vdir / f"topk_{name}.cu"), "-o",
                    str(vdir / f"topk_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, pr in procs.items():
        log, _ = pr.communicate()
        if pr.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = load(vdir / f"topk_{name}.so")
        print(json.dumps({"geometry": name, "ptxas": ptxas_lines(log)}),
              flush=True)

    worlds = {"structured": (tpm.topk_structured, cs.structured_world()),
              "dense": (tpm.topk_dense, cs.dense_world())}
    wants = {w: fn.plain(*args, cs.TOPK_K) for w, (fn, args) in worlds.items()}
    order = list(GEOMETRIES) + list(reversed(GEOMETRIES))
    for turn, name in enumerate(order):
        use(libs[name], GEOMETRIES[name])
        for w, (fn, args) in worlds.items():
            call = lambda: fn(*args, cs.TOPK_K)  # noqa: E731,B023
            if not name.endswith("scan_only"):
                cs.topk_parity(call(), wants[w])
            J, H = args[0].shape[0], args[-2].shape[0]
            plan = tpm._plan(J, H, cs.TOPK_K, w == "dense", args[0].device)
            print(json.dumps({
                "turn": turn, "geometry": name, "world": w,
                "equal_to_plain": not name.endswith("scan_only"),
                "ms": cs.cuda_ms(call, REPS),
                "device_ms": cs.device_ms(call, REPS, 2),
                "splits": plan.splits, "blocks_per_sm": tpm.blocks_per_sm(
                    w == "dense", tpm.kept(cs.TOPK_K), 0)}), flush=True)
    name = DENSE_GEOMETRY
    use(libs[name], GEOMETRIES[name])
    fn, args = worlds["dense"]
    call = lambda: fn(*args, cs.TOPK_K)  # noqa: E731
    for turn, S in enumerate(DENSE_SPLITS + tuple(reversed(DENSE_SPLITS))):
        with cs.forced_splits(tpm, S):
            cs.topk_parity(call(), wants["dense"])
            print(json.dumps({
                "turn": turn, "geometry": name, "world": "dense",
                "splits": S, "ms": cs.cuda_ms(call, REPS),
                "device_ms": cs.device_ms(call, REPS, 2)}), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
