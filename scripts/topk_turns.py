#!/usr/bin/env python3
"""The top-K kernels of one checkout, timed on one CUDA card by this
checkout's harness, so that two checkouts compare like with like.

Imports ``cook_tpu_torch`` from CHECKOUT (its own sources, built into
CHECKOUT/build/cuda) and the worlds and timers of the ``chip_smoke.py``
beside this script: ``topk_structured`` at 100,000 jobs x 50,000 hosts
(E = 256) and ``topk_dense`` at 10,000 x 50,000, k = 16, each held
against its plain version bit for bit, then timed by CUDA events and by
torch.profiler (``device_ms``, every kernel of the calls in the trace),
its CUDA launches a call counted from a captured graph.  Run it once a
checkout, in turns, for example parent / change / change / parent.

Usage: ``python3 scripts/topk_turns.py CHECKOUT`` on a machine with one
CUDA card and nvcc.
"""

import importlib.util
import json
import sys
from pathlib import Path

import torch

REPS = 5


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("topk_turns: no CUDA card", file=sys.stderr)
        return 2
    checkout = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(checkout))
    spec = importlib.util.spec_from_file_location(
        "harness", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cook_tpu_torch.ops import pallas_match as tpm
    if not str(Path(tpm.__file__).resolve()).startswith(str(checkout)):
        raise RuntimeError(f"imported {tpm.__file__}, not {checkout}'s")
    print(cs.card_line(), flush=True)
    worlds = {"topk_structured": (tpm.topk_structured, cs.structured_world()),
              "topk_dense": (tpm.topk_dense, cs.dense_world())}
    for name, (fn, args) in worlds.items():
        call = lambda: fn(*args, cs.TOPK_K)  # noqa: E731,B023
        cs.topk_parity(call(), fn.plain(*args, cs.TOPK_K))
        types, _ = cs.captured_launches(call)
        print(json.dumps({
            "checkout": checkout.name, "kernel": name,
            "equal_to_plain": True, "ms": cs.cuda_ms(call, REPS),
            "device_ms": cs.device_ms(call, REPS, types.count("kernel")),
            "cuda_launches_per_call": len(types), "launched": types}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
