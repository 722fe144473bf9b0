"""cook_tpu_torch's split match path against the JAX package on the CPU:
``greedy_match_kernel``, ``auction_match_kernel`` and
``waterfill_match_kernel`` (``ops/match``) on seeded worlds (a
``make_match_workload``-like contended world with non-dyadic values, a
uniform tie-heavy fleet, and a sparse-mask minority), with ``assign``
and the remaining ``avail`` equal bit for bit; the ordered fold against
``segment_sum``; ``resolve_backend`` over its whole table; and
``dispatch`` against ``Matcher._dispatch_device`` for every backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.config import Config
from cook_tpu.config import MatcherConfig as JMatcherConfig
from cook_tpu.ops import host_prep as jhp
from cook_tpu.ops import match as jm
from cook_tpu.ops import reference_impl as jref
from cook_tpu.sched.matcher import Matcher
from cook_tpu.state import Store
from cook_tpu_torch.config import MatcherConfig
from cook_tpu_torch.ops import host_prep as thp
from cook_tpu_torch.ops import match as tm
from cook_tpu_torch.ops import telemetry
from cook_tpu_torch.sched import matcher as tmatcher

F32 = np.float32
FIELDS = ("job_res", "constraint_mask", "avail", "capacity", "valid")


def _workload(J, H, seed):
    """bench.py's make_match_workload with non-dyadic demands, a 90%
    mask, and demand well past the fleet's free capacity."""
    rng = np.random.default_rng(seed)
    job_res = np.stack([rng.integers(1, 16, J) + 0.3,
                        rng.integers(64, 4096, J) * 1.1,
                        np.zeros(J), np.zeros(J)], 1).astype(F32)
    cap = np.stack([rng.integers(16, 128, H), rng.integers(4096, 65536, H),
                    np.zeros(H), np.full(H, 1e6)], 1).astype(F32)
    avail = (cap * rng.uniform(0.3, 1.0, (H, 1))).astype(F32)
    return job_res, rng.random((J, H)) < 0.9, avail, cap


def _uniform(J, H, seed):
    """Identical jobs on identical hosts: every fitness ties."""
    job_res = np.tile(np.array([[1.5, 700.7, 0, 0]], F32), (J, 1))
    cap = np.tile(np.array([[16, 8192, 0, 100]], F32), (H, 1))
    return job_res, np.ones((J, H), bool), cap * F32(0.75), cap


def _sparse(J, H, seed):
    """A dense majority and 10% of rows allowed on about 3% of hosts."""
    job_res, cmask, avail, cap = _workload(J, H, seed)
    rng = np.random.default_rng(seed + 100)
    rows = rng.random(J) < 0.1
    cmask[rows] = rng.random((int(rows.sum()), H)) < 0.03
    return job_res, cmask, avail, cap


WORLDS = {"workload": (_workload, 2000, 256), "uniform": (_uniform, 600, 256),
          "sparse": (_sparse, 1200, 512)}


def _inputs(world, seed=1):
    make, J, H = WORLDS[world]
    raw = make(J, H, seed)
    arrays = jhp.pack_match_inputs(*raw)
    ours = thp.pack_match_inputs(*raw)
    for k in FIELDS:
        np.testing.assert_array_equal(arrays[k], ours[k])
    return (jm.MatchInputs(*(jnp.asarray(arrays[k]) for k in FIELDS)),
            tm.MatchInputs(*(torch.from_numpy(ours[k]) for k in FIELDS)))


def _same(got, want):
    ga, gl = got
    wa, wl = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ga.numpy(), wa)
    np.testing.assert_array_equal(gl.numpy().view(np.uint32),
                                  wl.view(np.uint32))
    return wa


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("kernel", ["greedy", "auction", "waterfill"])
def test_match_kernel_bit_identical_to_jax(kernel, world):
    jinp, tinp = _inputs(world)
    name = f"{kernel}_match_kernel"
    assign = _same(getattr(tm, name)(tinp), getattr(jm, name)(jinp))
    assert (assign >= 0).any()


def test_auction_knobs_and_alias():
    jinp, tinp = _inputs("workload", seed=2)
    kw = dict(num_prefs=4, num_rounds=3, num_refresh=5, min_refresh_gain=1)
    _same(tm.multipass_match_kernel(tinp, **kw),
          jm.auction_match_kernel(jinp, **kw))


def test_waterfill_knobs():
    jinp, tinp = _inputs("sparse", seed=3)
    kw = dict(num_rounds=5, num_compaction=2)
    _same(tm.waterfill_match_kernel(tinp, **kw),
          jm.waterfill_match_kernel(jinp, **kw))


def test_waterfill_at_a_ragged_host_count():
    """Called directly at H = 4,000 (``dispatch`` would bucket H to a
    power of two): the compaction's ``mean_used_util`` is a sum over
    4,000 hosts, whose second level XLA:CPU pads (125 partials)."""
    raw = _workload(1_500, 4_000, 5)
    arrays = jhp.pack_match_inputs(*raw, pad=False)
    ours = thp.pack_match_inputs(*raw, pad=False)
    assert ours["avail"].shape[0] == 4_000
    jinp = jm.MatchInputs(*(jnp.asarray(arrays[k]) for k in FIELDS))
    tinp = tm.MatchInputs(*(torch.from_numpy(ours[k]) for k in FIELDS))
    kw = dict(num_rounds=4, num_compaction=3)
    assign = _same(tm.waterfill_match_kernel(tinp, **kw),
                   jm.waterfill_match_kernel(jinp, **kw))
    assert (assign >= 0).any()


def test_ordered_fold_is_segment_sum_order():
    rng = np.random.default_rng(5)
    N, H = 500, 13
    vals = (rng.random((N, 4)) * 1000.3).astype(F32)
    seg = rng.integers(0, H, N).astype(np.int32)
    keep = rng.random(N) < 0.7
    want = jax.ops.segment_sum(jnp.asarray(vals * keep[:, None]),
                               jnp.asarray(seg), num_segments=H)
    got = tm.ordered_fold(torch.zeros(H, 4), torch.from_numpy(vals),
                          torch.from_numpy(seg), torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_searchsorted_left_matches_jnp():
    rng = np.random.default_rng(9)
    arr = np.cumsum(rng.random(300).astype(F32) * 3.3).astype(F32)
    arr[50] = arr[49]                       # a tie
    arr[120] = arr[121] + 1                 # a step down
    q = np.concatenate([arr[::7], rng.random(60).astype(F32) * 600,
                        [-1.0, 0.0, -0.0, 1e9]]).astype(F32)
    want = np.asarray(jnp.searchsorted(jnp.asarray(arr), jnp.asarray(q),
                                       side="left"))
    got = tm.searchsorted_left(torch.from_numpy(arr), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_matchers_launch_nothing():
    _, tinp = _inputs("uniform")
    telemetry.reset_all()
    tm.greedy_match_kernel(tinp)
    tm.waterfill_match_kernel(tinp, num_rounds=2, num_compaction=1)
    assert all(v == 0 for v in telemetry.snapshot().values())


@pytest.mark.parametrize("backend", ["auto", "tpu-greedy", "tpu-auction",
                                     "tpu-waterfill", "tpu-megakernel",
                                     "cpu", "tpu-auction-pallas"])
@pytest.mark.parametrize("packing", ["throughput", "tight"])
def test_resolve_backend_table(backend, packing):
    for threshold in (0, 10, 2000):
        kw = dict(backend=backend, auto_packing=packing,
                  auto_large_j_threshold=threshold)
        jmc, tmc = JMatcherConfig(**kw), MatcherConfig(**kw)
        assert tmc.backend == jmc.backend
        for n in (0, 1, 10, 11, 2000, 2001, 50_000):
            assert tmatcher.resolve_backend(tmc, n) \
                == Matcher.resolve_backend(jmc, n)
        jmc.backend = tmc.backend = "tpu-auction-pallas"
        assert tmatcher.resolve_backend(tmc, 5) \
            == Matcher.resolve_backend(jmc, 5)


def test_config_validation():
    with pytest.raises(ValueError):
        MatcherConfig(backend="gpu")
    with pytest.raises(ValueError):
        MatcherConfig(auto_packing="loose")
    fields = set(MatcherConfig.__dataclass_fields__)
    assert fields <= set(JMatcherConfig.__dataclass_fields__)
    for f in fields:
        assert getattr(MatcherConfig(), f) == getattr(JMatcherConfig(), f)


@pytest.mark.parametrize("backend,packing", [
    ("auto", "throughput"), ("auto", "tight"), ("tpu-greedy", "throughput"),
    ("tpu-auction", "throughput"), ("tpu-waterfill", "throughput"),
    ("tpu-megakernel", "throughput"), ("cpu", "throughput")])
def test_dispatch_equals_matcher_dispatch_device(backend, packing):
    """The split world: auto above its threshold with sparse rows runs
    the waterfill on the dense rows and the greedy on the rest.  The
    reference is ``_dispatch_device`` itself (no fallback to the host
    greedy can hide a JAX failure); ``cpu`` is the host greedy golden."""
    job_res, cmask, avail, cap = _sparse(600, 300, 4)
    kw = dict(backend=backend, auto_packing=packing,
              auto_large_j_threshold=100)
    if backend == "cpu":
        want = jref.greedy_match(job_res, cmask, avail, cap)
    else:
        want = Matcher(Store(), Config())._dispatch_device(
            JMatcherConfig(**kw), job_res, cmask, avail, cap)
    got = tmatcher.dispatch(MatcherConfig(**kw), job_res, cmask, avail, cap,
                            device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got >= 0).sum() > 100
    placed = got >= 0
    assert cmask[np.flatnonzero(placed), got[placed]].all()
    used = np.zeros_like(avail, dtype=np.float64)
    np.add.at(used, got[placed], job_res[placed])
    assert (used <= avail).all()


def test_dispatch_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    job_res, cmask, avail, cap = _uniform(8, 8, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        tmatcher.dispatch(MatcherConfig(), job_res, cmask, avail, cap)
