"""K3 (the cycle's two stable sorts) on the CPU.

* The packed rank key of ``ops/sort.rank_key_plain``, sorted stably by
  ``torch.sort``, is the rank order ``jnp.lexsort((position, user_rank,
  sort_dru))`` of ``cook_tpu/ops/dru.py:106``: NaN, -0, +inf and tied
  DRUs, non-rankable rows, ``user_rank`` -1 and T - 1.  It is the
  function K3 computes and the key its ``torch.sort`` yardstick sorts.
* ``sort_plan``: the launch geometry csrc/sort.cu takes, for rank and
  user keys at every n the cycle gives: every pass has its digits, its
  tiles and its status words in the scratch.
Exact equality throughout.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu_torch.ops import sort as tsort

F32 = np.float32


def _rank_world(T, seed):
    rng = np.random.default_rng(seed)
    dru = (rng.integers(0, 7, T) * F32(0.25)).astype(F32)   # many ties
    pick = rng.random(T)
    dru[pick < 0.05] = np.nan
    dru[(pick >= 0.05) & (pick < 0.10)] = -0.0
    dru[(pick >= 0.10) & (pick < 0.15)] = np.inf
    dru[(pick >= 0.15) & (pick < 0.18)] = -np.inf
    dru[(pick >= 0.18) & (pick < 0.25)] = rng.random(
        int(((pick >= 0.18) & (pick < 0.25)).sum())).astype(F32)
    dru[:1] = -0.0
    if T > 1:
        dru[1] = 0.0
    rankable = rng.random(T) < 0.8
    user_rank = rng.integers(-1, T, T).astype(np.int32)
    user_rank[: min(T, 3)] = -1
    user_rank[-min(T, 3):] = T - 1
    if T > 10:                      # negative NaN bits, as x86 makes them
        dru[5] = np.float32(np.uint32(0xFFC00000).view(F32))
    return dru, rankable, user_rank


@pytest.mark.parametrize("T", [1, 100, 4097, 131072])
def test_packed_rank_key_sorts_as_jax_lexsort(T):
    dru, rankable, user_rank = _rank_world(T, seed=T)
    sort_dru = jnp.where(jnp.asarray(rankable), jnp.asarray(dru), jnp.inf)
    position = jnp.arange(T, dtype=jnp.int32)
    want = np.asarray(jnp.lexsort((position, jnp.asarray(user_rank),
                                   sort_dru)))
    key = tsort.rank_key_plain(torch.from_numpy(dru)[None],
                               torch.from_numpy(rankable.astype(np.uint8))[None],
                               torch.from_numpy(user_rank)[None])
    assert key.dtype == torch.int64 and int(key.min()) >= 0
    assert int(key.max()) < 1 << tsort.rank_bits(T)
    got = torch.sort(key, dim=1, stable=True).indices[0].numpy()
    np.testing.assert_array_equal(got, want)
    # the plain version of the kernel sorts the same order
    plain = tsort.sort_rank(torch.from_numpy(dru)[None],
                            torch.from_numpy(rankable.astype(np.uint8))[None],
                            torch.from_numpy(user_rank)[None])
    np.testing.assert_array_equal(plain[0].numpy(), want)


def _sort_cu_constants():
    """The geometry csrc/sort.cu is compiled for, from its source."""
    text = (Path(tsort.__file__).parent / "csrc" / "sort.cu").read_text()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr\s+\w+\s+(k\w+)\s*=\s*([^;]+);", text)}


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("kind", ["rank", "user"])
@pytest.mark.parametrize("n", [1, 1000, 4097, 131072, 262144])
def test_sort_plan_holds_every_pass(n, kind, S):
    bits = tsort.rank_bits(n) if kind == "rank" else n.bit_length()
    plan = tsort.sort_plan(S, n, bits)
    src = _sort_cu_constants()
    threads, items = int(src["kSortThreads"]), int(src["kItems"])
    # the geometry sort.cu was compiled for, which it checks (plan_ok)
    assert plan.digit_bits == int(src["kRadixBits"])
    assert plan.threads == threads and plan.tile == threads * items
    digits = 1 << plan.digit_bits
    # enough passes for every key bit, and no more than the upfront
    # kernel's histogram holds (cnt[kMaxPasses * kDigits])
    assert plan.passes * plan.digit_bits >= bits > (plan.passes - 1) \
        * plan.digit_bits
    assert plan.passes <= int(src["kMaxPasses"])
    assert plan.tiles * plan.tile >= n > (plan.tiles - 1) * plan.tile
    # the control words as sort.cu indexes them, for every (s, q): the
    # histogram hist_off + (s * passes + q) * digits + d, the ticket
    # ticket_off + s * passes + q, the status words status_off + ((s *
    # passes + q) * tiles + t) * digits + d; no two regions overlap and
    # every word lies inside the one memset of ctl_words
    regions = []
    for s in range(S):
        for q in range(plan.passes):
            sq = s * plan.passes + q
            regions += [(plan.hist_off + sq * digits, digits),
                        (plan.ticket_off + sq, 1),
                        (plan.status_off + sq * plan.tiles * digits,
                         plan.tiles * digits)]
    regions.sort()
    end = 0
    for start, size in regions:
        assert start >= end
        end = start + size
    assert end <= plan.ctl_words
    assert plan.status_off + (S * plan.passes * plan.tiles - 1) * digits \
        + digits - 1 < plan.ctl_words
    # key and value buffers: two of S * n, the second at S * n
    assert 2 * S * n - 1 < plan.key_elems
    # a pass CTA holds its tile's keys (u64) and values (i32)
    assert plan.tile * 12 <= plan.smem_bytes <= 232_448


def test_sort_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        tsort.sort_plan(1, 0, 8)
    with pytest.raises(ValueError):
        tsort.sort_plan(1, 1 << 30, 8)
    with pytest.raises(ValueError):
        tsort.sort_plan(1, 10, 64)
