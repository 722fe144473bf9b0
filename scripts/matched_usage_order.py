#!/usr/bin/env python3
"""In what order the reference's compact mesh cycle sums its matched
usage (``cook_tpu/parallel/sharded.py`` ``_match_tail``: ``jnp.sum(res_c
* matched[:, None], axis=0)``), read on the CPU.

For the two worlds of ``tests/test_torch_sharding.py::
test_spanning_groups_compact_form`` (seeds 0 and 1, cap 32, 8 pools on
the 8-device CPU mesh) it prints, as JSON lines:

- whether the compiled HLO text (``jit(...).lower(...).compile()
  .as_text()``) is the same for both worlds, and the fusion the sum
  sits in;
- per pool, whether the port's sum (``ops/scan.lane_tree_sum``) equals
  the reference's f32 bits, and which candidate orders over the C slots
  do: ``seq`` (in slot order from +0.0, ``window32_sum`` at C <= 32),
  ``rev``, ``pair`` (pairwise), ``lK``
  (K accumulators taking slot ``j`` at ``j % K``, combined as a tree,
  the shape of a vectorized loop) and ``lsK`` (the same, combined in
  order); the summands are the port's own (``res_c`` times the matched
  bit);
- the same candidates against a standalone ``jit`` of the same sum on
  random f32 inputs at C = 32 (outside the cycle's fusion).

Usage: ``JAX_PLATFORMS=cpu python3 scripts/matched_usage_order.py``
from the root of the checkout (it imports both packages and the test
module's worlds).
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]

import conftest  # noqa: E402,F401  the tests' 8-device CPU mesh
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_sharding as tts  # noqa: E402
from cook_tpu.parallel.sharded import CompactPoolCycleInputs  # noqa: E402


def _f32(v):
    return np.asarray(v, np.float32)


def candidates(x):
    """Each candidate order's sum of ``x`` (f32[C, 4]) over its rows."""
    def in_order(rows):
        s = np.zeros(x.shape[1:], np.float32)
        for j in rows:
            s = _f32(s + x[j])
        return s

    def lanes(k, tree):
        acc = np.zeros((k,) + x.shape[1:], np.float32)
        for j in range(x.shape[0]):
            acc[j % k] = _f32(acc[j % k] + x[j])
        if not tree:
            return in_order_of(acc)
        while acc.shape[0] > 1:
            h = acc.shape[0] // 2
            acc = _f32(acc[:h] + acc[h:])
        return acc[0]

    def in_order_of(acc):
        s = np.zeros(acc.shape[1:], np.float32)
        for a in acc:
            s = _f32(s + a)
        return s

    def pair(lo, hi):
        if hi - lo == 1:
            return x[lo]
        m = (lo + hi) // 2
        return _f32(pair(lo, m) + pair(m, hi))

    n = x.shape[0]
    out = {"seq": in_order(range(n)), "rev": in_order(range(n - 1, -1, -1)),
           "pair": pair(0, n)}
    for k in (2, 4, 8, 16, 32):
        out[f"l{k}"] = lanes(k, True)
        out[f"ls{k}"] = lanes(k, False)
    return out


def matching(x, want):
    return [name for name, v in candidates(x).items()
            if (v.view(np.uint32) == want.view(np.uint32)).all()]


def main() -> int:
    summands = []
    lane_tree_sum = tts.tsh.lane_tree_sum

    def spy(x, dim=0):
        summands.append(x.detach().clone())
        return lane_tree_sum(x, dim=dim)

    tts.tsh.lane_tree_sum = spy
    texts = []
    for seed in (0, 1):
        fields, _gang = tts.span_compact_world(seed)
        cycle = tts.jax_make_pool_cycle(
            tts.jax_pool_mesh(), considerable_cap=tts.CAP, structured=True,
            compact=True)
        args = CompactPoolCycleInputs(
            **{k: jnp.asarray(v) for k, v in fields.items()})
        text = cycle.lower(args).compile().as_text()
        texts.append(text)
        ref = tts.jax_compact(fields)
        summands.clear()
        got = tts.tsh.make_pool_cycle(
            tts.pool_mesh(1, "cpu"), considerable_cap=tts.CAP,
            compact=True)(tts.tsh.compact_inputs_from_numpy(fields, "cpu"))
        x_all = [s for s in summands
                 if s.ndim == 3 and s.shape[1] == tts.CAP][-1].numpy()
        want = ref["matched_usage"]
        port = got.matched_usage.numpy()
        for p in range(want.shape[0]):
            x = x_all[p][:, :4]
            print(json.dumps({
                "world": seed, "pool": p,
                "summands": int((x != 0).any(axis=1).sum()),
                "port_equal": bool((port[p].view(np.uint32)
                                    == want[p].view(np.uint32)).all()),
                "orders_equal": matching(x, want[p])}))
    fusion = [ln.strip()[:160] for ln in texts[0].splitlines()
              if "multiply_reduce_fusion" in ln and "fusion(" in ln]
    print(json.dumps({"hlo_same_for_both_worlds": texts[0] == texts[1],
                      "hlo_chars": len(texts[0]), "fusion": fusion}))
    # the same sum outside the cycle: a standalone jit at C = 32
    f = jax.jit(jax.vmap(lambda r, m: jnp.sum(r * m[:, None], axis=0)))
    rng = np.random.default_rng(0)
    hits = {}
    for _ in range(20):
        r = (rng.random((1, tts.CAP, 4)) * 900 + 0.1).astype(np.float32)
        m = (rng.random((1, tts.CAP)) < 0.8).astype(np.float32)
        for name in matching(r[0] * m[0][:, None], np.asarray(f(r, m))[0]):
            hits[name] = hits.get(name, 0) + 1
    print(json.dumps({"standalone_jit_c32_of_20": hits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
