#!/usr/bin/env python3
"""What one fused cycle of a checkout asks of the host and the card, at
``chip_smoke.py``'s design point: stage-wrapper calls (the launch
counters), CUDA launches (one whole cycle captured into a CUDA graph,
its nodes counted; nothing runs), and allocating ``torch`` calls
(cProfile's call counts over three cycles).  Counts, not times: they do
not depend on the machine, so two checkouts compare across calls.

Usage: ``python3 scripts/cycle_host_counts.py [CHECKOUT]`` on a machine
with one CUDA card and nvcc; CHECKOUT (default: this one) is the root
of a checkout whose ``chip_smoke.py`` and ``cook_tpu_torch`` are used.
Prints one JSON line.
"""

import cProfile
import json
import pstats
import sys
from pathlib import Path

ALLOCATING = ("empty", "empty_like", "zeros", "zeros_like", "full",
              "full_like", "ones", "ones_like", "empty_strided")


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cycle_host_counts: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cook_tpu_torch.ops import telemetry
    from cook_tpu_torch.ops.pallas_cycle import megacycle
    w = cs.build_world(np.random.default_rng(cs.SEED))
    staged = cs.stage(w, torch.from_numpy(w.res).cuda(),
                      torch.from_numpy(w.disk).cuda(), {})
    args = cs.megacycle_args(staged)
    megacycle(staged["wire"], **args)
    torch.cuda.synchronize()
    telemetry.reset_all()
    megacycle(staged["wire"], **args)
    wrapper_calls = {k: v for k, v in telemetry.snapshot().items() if v}
    try:
        types, _ = cs.captured_launches(
            lambda: megacycle(staged["wire"], **args))
        launches = {t: types.count(t) for t in sorted(set(types))}
        launches["total"] = len(types)
    except Exception as e:  # a cycle that cannot be captured
        launches = f"not measured: {type(e).__name__}: {e}"
    cycles = 3
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    for _ in range(cycles):
        megacycle(staged["wire"], **args)
    prof.disable()
    torch.cuda.synchronize()
    allocs = {}
    for (f, _, fn), (_, nc, _, _, _) in pstats.Stats(prof).stats.items():
        for k in ALLOCATING:
            if f == "~" and fn == f"<built-in method torch.{k}>":
                allocs[f"torch.{k}"] = nc / cycles
    print(json.dumps({"checkout": str(root), "card": cs.card_line(),
                      "wrapper_calls_per_cycle": wrapper_calls,
                      "cuda_launches_per_cycle": launches,
                      "allocating_calls_per_cycle": allocs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
