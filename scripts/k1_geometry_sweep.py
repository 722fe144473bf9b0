#!/usr/bin/env python3
"""K1 launch geometries side by side on one CUDA card, and the ptxas
report of K5's gang-epilogue instances with and without rolled loops.

Each K1 geometry (rows a CTA, threads a CTA, rows in flight a thread,
CTAs an SM) is built from ``cook_tpu_torch/ops/csrc/expand.cu`` with its
constants replaced, into a library of its own; each is held against the
plain version on the design point's K1 call (the first cycle of
``chip_smoke.py``'s world) and on four edge worlds, then timed there
(CUDA events and torch.profiler's device time), in turns, forward then
backward.  The greedy source is compiled twice, as it is and with the
epilogue's loops left to unroll, and the spills of every
``greedy_cluster`` instance are printed.

Usage: ``python3 scripts/k1_geometry_sweep.py`` from the root of a
checkout, on a machine with one CUDA card and nvcc; writes into
build/variants.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cook_tpu_torch.ops import cuda_lib  # noqa: E402
from cook_tpu_torch.ops import expand as tex  # noqa: E402

# (kTile, kExpandThreads, kBatch, kMinCtas, kMaxWindows)
K1 = {"4096x512_b4_m2": (4096, 512, 4, 2, 32768),
      "2048x256_b4_m4": (2048, 256, 4, 4, 32768),
      "2048x256_b8_m2": (2048, 256, 8, 2, 32768),
      "1024x128_b4_m8": (1024, 128, 4, 8, 16384)}


def set_const(text, name, value):
    out, n = re.subn(rf"(constexpr\s+[\w ]+\s{name}\s*=\s*)[^;]+;",
                     rf"\g<1>{value};", text)
    assert n == 1, name
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_geometry_sweep: no CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    src = ROOT / "cook_tpu_torch/ops/csrc"
    vdir = ROOT / "build/variants"
    vdir.mkdir(parents=True, exist_ok=True)
    for f in src.glob("*.cuh"):
        (vdir / f.name).write_text(f.read_text())
    nvcc = [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v"]
    text = (src / "expand.cu").read_text()
    procs = {}
    for name, (tile, thr, batch, mc, mw) in K1.items():
        t = text
        for k, v in (("kTile", tile), ("kExpandThreads", thr),
                     ("kBatch", batch), ("kMinCtas", mc),
                     ("kMaxWindows", mw)):
            t = set_const(t, k, v)
        (vdir / f"k1_{name}.cu").write_text(t)
        procs[name] = subprocess.Popen(
            nvcc + ["-shared", str(vdir / f"k1_{name}.cu"), "-o",
                    str(vdir / f"k1_{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    greedy = (src / "greedy.cu").read_text()
    unrolled = re.sub(r"#pragma unroll 1[^\n]*\n", "", greedy)
    for name, t in (("greedy_rolled", greedy), ("greedy_unrolled", unrolled)):
        (vdir / f"{name}.cu").write_text(t)
        procs[name] = subprocess.Popen(
            nvcc + ["-c", str(vdir / f"{name}.cu"), "-o",
                    str(vdir / f"{name}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{logs[name]}")
    prop = re.compile(r"Function properties for (\S+)\n\s+(\d+) bytes stack "
                      r"frame, (\d+) bytes spill stores.*\n.*Used (\d+) "
                      r"registers")
    for name in ("greedy_rolled", "greedy_unrolled"):
        print(json.dumps({"source": name, "greedy_cluster": sorted({
            (re.search(r"greedy_cluster(I\w+?E)E", f).group(1), int(st),
             int(sp), int(r))
            for f, st, sp, r in prop.findall(logs[name])
            if "greedy_cluster" in f})}), flush=True)
    for name in K1:
        print(json.dumps({"k1": name, "ptxas": [
            (int(st), int(sp), int(r)) for f, st, sp, r in
            prop.findall(logs[name]) if "expand_tiles" in f]}), flush=True)

    cuda_lib.build()
    from cook_tpu_torch.ops.pallas_cycle import megacycle
    w = cs.build_world(np.random.default_rng(cs.SEED))
    staged = cs.stage(w, torch.from_numpy(w.res).cuda(),
                      torch.from_numpy(w.disk).cuda(), {})
    with cuda_lib.recording() as calls:
        megacycle(staged["wire"], **cs.megacycle_args(staged))
    (_, args, kw, _), = [c for c in calls if c.wrapper is tex.expand]
    edges = [cs.expand_edge_args(S, T, T % 3, E, H, u16, 99 + S + T)
             for S, T, E, H, u16 in ((33, 4097, 256, 7, True),
                                     (1, 1, 1, 1, False),
                                     (4, 1_048_576, 64, 8192, False),
                                     (33, 131_072, 64, 65536, True))]
    base = cuda_lib._LIB
    saved = {k: getattr(tex, k) for k in ("TILE", "THREADS", "SMEM_BYTES",
                                          "MAX_WINDOWS")}
    device = {}
    for name in list(K1) + list(K1)[::-1]:
        tile, thr, _, _, mw = K1[name]
        dll = ctypes.CDLL(str(vdir / f"k1_{name}.so"))
        dll.k1_expand.argtypes = [cuda_lib._CTYPES[c] for c in
                                  cuda_lib._SIGNATURES["k1_expand"]]
        dll.k1_expand.restype = ctypes.c_int
        tex.TILE, tex.THREADS, tex.MAX_WINDOWS = tile, thr, mw
        tex.SMEM_BYTES = 16 * (tile + tile // 32) + 4 * tile \
            + 16 * (tile // 32)
        tex.expand_plan.cache_clear()
        cuda_lib._LIB = dll
        try:
            faults = []
            cs.replay(0, tex.expand, args, kw, faults)
            for i, (ea, ekw) in enumerate(edges):
                cs.replay(i + 1, tex.expand, ea, ekw, faults)
            ms = cs.cuda_ms(lambda: tex.expand.launch(*args, **kw), 50)
            dms = cs.device_ms(lambda: tex.expand.launch(*args, **kw), 50)
        finally:
            cuda_lib._LIB = base
            for k, v in saved.items():
                setattr(tex, k, v)
            tex.expand_plan.cache_clear()
        if faults:
            raise AssertionError(f"{name}: kernel != plain version: "
                                 f"{faults[:3]}")
        device.setdefault(name, []).append(dms)
        print(json.dumps({"k1": name, "equal_to_plain": True, "ms": ms,
                          "device_ms": dms}), flush=True)
    print(json.dumps({"k1_device_ms_in_turns": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
