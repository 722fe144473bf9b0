"""The design of the top-K kernels (``csrc/topk.cu``) on the CPU.

The kernels run only on the card; here:

* the plan constants of ``ops/pallas_match.py`` against the constants
  ``topk.cu`` is compiled for, and the host splits against the geometry
  its entries accept;
* a numpy model of the kernels' pre-filter, bit for bit: each host's
  terms (``__frcp_rn``'s reciprocal, which numpy's division reproduces,
  and FMAs emulated exactly), each pair's two FMAs.  On adversarial
  worlds (fits equal to the K-th entry, capacities at and below 1e-9,
  negative ``cap - avail``, operands at both edges of the pre-filter's
  range and past them, zeros, subnormals, infinities and NaN) the
  estimate is never below the exact fitness, so the rule never skips a
  pair the exact rule admits;
* the kernels' walk with the rule (hosts in order, pairs skipped where
  the estimate is at most the K-th entry, the exact strict insertion
  elsewhere) against the plain version, bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cook_tpu_torch.ops import pallas_match as tpm

F32 = np.float32
F64 = np.float64
NAN = F32(np.nan)


def _cu_constants():
    text = (Path(tpm.__file__).parent / "csrc" / "topk.cu").read_text()
    return text, {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr\s+int\s+(k\w+)\s*=\s*([^;]+);", text)}


def test_plan_constants_are_the_kernels():
    text, src = _cu_constants()
    assert int(src["kStructThreads"]) == tpm.STRUCT_THREADS
    assert int(src["kDenseThreads"]) == tpm.DENSE_THREADS
    # one job a thread
    assert "constexpr int JOBS = THREADS;" in text
    assert "jobs == threads_of(dense)" in text
    assert tpm.jobs_per_block(True) == tpm.DENSE_THREADS
    assert tpm.jobs_per_block(False) == tpm.STRUCT_THREADS
    assert int(src["kStructTile"]) == tpm.STRUCT_TILE
    assert int(src["kDenseTile"]) == tpm.DENSE_TILE
    assert int(src["kExcSlots"]) == tpm.EXC_SLOTS
    assert int(src["kRowPad"]) == tpm.ROW_PAD
    assert int(src["kChunk"]) == 16
    assert eval(src["kHostBytes"]) == tpm.HOST_BYTES == 3 * 16 + 8
    # the shared memory formula, and it fits a block (and 2 an SM)
    assert "tile * kHostBytes" in text
    assert "2 * kDenseThreads * row_bytes(tile)" in text
    assert "2 * tile + kExcSlots * row_bytes(tile)" in text
    for dense in (False, True):
        assert 2 * (tpm.smem_bytes(dense) + 1024) <= 233_472
    # rows of tile + 16 bytes: an odd count of 16-byte units, so the 8
    # threads of a quarter warp read 8 rows in distinct banks
    for tile in (tpm.STRUCT_TILE, tpm.DENSE_TILE):
        assert ((tile + tpm.ROW_PAD) // 16) % 2 == 1
    # the split geometry the entries check is the plan's
    assert "per == (tiles + S - 1) / S * want_tile" in text


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("J,H", [(1, 1), (16, 8), (2_000, 30_000),
                                 (10_000, 50_000), (100_000, 50_000),
                                 (30_000, 20_000), (129, 1_000_003)])
def test_host_splits_cover_the_hosts(J, H, dense):
    plan = tpm.topk_plan(J, H, dense, 132, 2 if dense else 3)
    tiles = -(-H // plan.tile)
    assert plan.per % plan.tile == 0
    assert plan.per == -(-tiles // plan.splits) * plan.tile
    assert plan.splits * plan.per >= H > 0
    assert 1 <= plan.splits <= tiles
    # every host in exactly one split, in order
    starts = [s * plan.per for s in range(plan.splits)]
    assert starts[0] == 0 and all(b - a == plan.per
                                  for a, b in zip(starts, starts[1:]))
    assert plan.jobs == tpm.jobs_per_block(dense)
    assert plan.job_blocks == max(1, -(-J // plan.jobs))
    assert plan.smem == tpm.smem_bytes(dense)


def test_launch_plans_of_the_bench_worlds():
    """The jobs fill the card at 100,000 jobs (391 blocks of 256);
    10,000 jobs (79 blocks of 128) split the hosts."""
    assert tpm.topk_plan(100_000, 50_000, False, 132, 3).splits == 1
    assert tpm.topk_plan(10_000, 50_000, True, 132, 2).splits == 10
    assert tpm.topk_plan(16, 8, True, 132, 2).splits == 1


# ------------------------------------------------- the pre-filter model
def fma32(a, b, c):
    """f32 fused multiply-add, rounded once (numpy has none): the
    product is exact in f64, the sum's f64 rounding error is recovered
    by TwoSum, and a sum that lands exactly between two f32 values is
    sent the way its error points."""
    a, b, c = (np.asarray(x, F32) for x in (a, b, c))
    p = a.astype(F64) * b.astype(F64)
    with np.errstate(over="ignore", invalid="ignore"):
        s = p + c.astype(F64)
        bb = s - p
        err = (p - (s - bb)) + (c.astype(F64) - bb)
        r = s.astype(F32)
        up = np.nextafter(r, F32(np.inf))
        down = np.nextafter(r, F32(-np.inf))
        other = np.where(s > r.astype(F64), up, down)
        mid = (r.astype(F64) + other.astype(F64)) * 0.5
        tie = np.isfinite(s) & (r.astype(F64) != s) & (s == mid) & (err != 0)
        toward = np.where(err > 0, np.maximum(r, other),
                          np.minimum(r, other))
    return np.where(tie, toward, r).astype(F32)


def test_fma32_against_exact_rationals():
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(3_000) * 2.0 ** rng.integers(-30, 30, 3_000)) \
        .astype(F32)
    b = (rng.standard_normal(3_000) * 2.0 ** rng.integers(-30, 30, 3_000)) \
        .astype(F32)
    c = (-(a.astype(F64) * b.astype(F64))
         * (1 + rng.standard_normal(3_000) * 2.0 ** -20)).astype(F32)
    # halfway cases: c cancels all but a tail below f64's precision
    got = fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, F32(np.inf)),
                 np.nextafter(lo, F32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(v.view(np.uint32)) & 1))
        assert g == best or (g == 0 and best == 0)


def in_range(x):
    a = np.abs(x)
    return (a >= F32(2.0 ** -40)) & (a < F32(2.0 ** 40))


def job_prefilter(job_res, valid):
    """Each job's pre-filter demand (NaN where the pre-filter does not
    apply) and the block maxima N0, N1 of their magnitudes, a block of
    ``jobs_per_block(True)`` jobs as the dense kernel groups them."""
    n0, n1 = job_res[:, 0], job_res[:, 1]
    pre = valid & (np.abs(n0) < F32(2.0 ** 40)) & (np.abs(n1) < F32(2.0 ** 40))
    pn0, pn1 = np.where(pre, n0, NAN), np.where(pre, n1, NAN)
    blocks = np.arange(job_res.shape[0]) // tpm.jobs_per_block(True)
    nmax = np.zeros((blocks.max() + 1, 2), F32)
    for b in range(nmax.shape[0]):
        sel = pre & (blocks == b)
        if sel.any():
            nmax[b] = [np.abs(n0[sel]).max(), np.abs(n1[sel]).max()]
    return pn0, pn1, nmax[blocks]


def host_terms(avail, cap, nmax0, nmax1):
    """The kernels' per-host pre-filter terms (stage_hosts in topk.cu)
    for a block whose maxima are nmax0, nmax1."""
    with np.errstate(all="ignore"):
        u0, u1 = cap[:, 0] - avail[:, 0], cap[:, 1] - avail[:, 1]
        m0 = np.where(cap[:, 0] > F32(1e-9), cap[:, 0], F32(1e-9))
        m1 = np.where(cap[:, 1] > F32(1e-9), cap[:, 1], F32(1e-9))
        ha0 = (F32(1) / m0) * F32(0.5)
        ha1 = (F32(1) / m1) * F32(0.5)
        safe = (np.abs(u0) < F32(2.0 ** 40)) & (np.abs(u1) < F32(2.0 ** 40)) \
            & in_range(m0) & in_range(m1)
        rel = F32(2.0 ** -16)
        margin = fma32(np.abs(u1) + nmax1, ha1 * rel,
                       fma32(np.abs(u0) + nmax0, ha0 * rel, F32(2.0 ** -120)))
        hh = np.where(safe, fma32(u0, ha0, fma32(u1, ha1, margin)), NAN)
    return ha0.astype(F32), ha1.astype(F32), hh.astype(F32)


def estimates(job_res, valid, avail, cap):
    """est[J, H]: the pre-filter's value of every pair."""
    pn0, pn1, nmax = job_prefilter(job_res, valid)
    est = np.empty((job_res.shape[0], avail.shape[0]), F32)
    for nm in np.unique(nmax, axis=0):
        rows = np.all(nmax == nm, axis=1)
        ha0, ha1, hh = host_terms(avail, cap, nm[0], nm[1])
        with np.errstate(all="ignore"):
            est[rows] = fma32(pn0[rows, None], ha0[None],
                              fma32(pn1[rows, None], ha1[None], hh[None]))
    return est


def exact_fit(job_res, avail, cap):
    """The fitness of every pair (the plain version's score, unmasked)."""
    t = torch.from_numpy
    feas = torch.ones((job_res.shape[0], avail.shape[0]), dtype=torch.bool)
    return tpm.score(t(job_res), feas, t(avail), t(cap)).numpy()


EDGE = [0.0, 1e-45, 1e-38, 2.0 ** -41, 2.0 ** -40, 1e-12, 1e-10, 1e-9,
        1.0000001e-9, 0.3, 1.0, 7.0, 1000.7, 2.0 ** 21, 2.0 ** 39.999,
        2.0 ** 40, 2.0 ** 41, 1e30, 3e38, np.inf, np.nan]


def adversarial_world(seed, J=400, H=500):
    """Demands and hosts drawn from EDGE values of both signs, mixed with
    ordinary ones; half the hosts with avail above capacity."""
    rng = np.random.default_rng(seed)
    edge = np.array(EDGE + [-v for v in EDGE], F64)

    def pick(shape, p_edge=0.5):
        ordinary = rng.uniform(0.1, 5_000.0, shape)
        return np.where(rng.random(shape) < p_edge,
                        rng.choice(edge, shape), ordinary).astype(F32)
    job_res = pick((J, 4), 0.4)
    job_res[:, 2:] = np.abs(job_res[:, 2:])
    cap = pick((H, 4), 0.4)
    avail = np.where(rng.random((H, 4)) < 0.5, cap * F32(0.7),
                     pick((H, 4), 0.4)).astype(F32)
    valid = rng.random(J) < 0.9
    return job_res, valid, avail, cap


@pytest.mark.parametrize("seed", range(6))
def test_prefilter_never_below_the_exact_fit(seed):
    job_res, valid, avail, cap = adversarial_world(seed)
    est = estimates(job_res, valid, avail, cap)
    fit = exact_fit(job_res, avail, cap)
    with np.errstate(invalid="ignore"):
        skip_ok = np.isnan(est) | np.isnan(fit) | (est >= fit)
    bad = np.argwhere(~skip_ok & valid[:, None])
    assert bad.size == 0, (bad[:5], est[tuple(bad[:5].T)],
                           fit[tuple(bad[:5].T)])
    # the worlds reach the pre-filter's every branch
    assert np.isnan(est[valid]).any() and np.isfinite(est[valid]).any()


@pytest.mark.parametrize("scale", [1e-9, 1e-6, 1.0, 3e4, 2.0 ** 37])
def test_prefilter_at_the_margin_of_ties(scale):
    """Hosts whose fits tie or differ in the last bits, at magnitudes from
    the smallest capacity to the top of the range: the estimate is at
    least the fit, and within 2^-14 of it relative to the terms."""
    rng = np.random.default_rng(int(np.log2(scale) + 60))
    H, J = 600, 130
    c0 = (F32(scale) * (1 + rng.integers(0, 4, H) * F32(2.0 ** -23))) \
        .astype(F32)
    cap = np.stack([c0, c0 * F32(3), np.zeros(H, F32), np.ones(H, F32)], 1)
    avail = (cap * F32(0.5)).astype(F32)
    avail[::7, :2] = cap[::7, :2] * F32(1.5)     # negative cap - avail
    job_res = np.stack([rng.uniform(0, 1, J) * F32(scale),
                        rng.uniform(0, 1, J) * F32(scale),
                        np.zeros(J), np.zeros(J)], 1).astype(F32)
    valid = np.ones(J, bool)
    est = estimates(job_res, valid, avail, cap)
    fit = exact_fit(job_res, avail, cap)
    assert np.isfinite(est).all() and (est >= fit).all()
    w = sum((np.abs(cap[None, :, r] - avail[None, :, r])
             + np.abs(job_res[:, r:r + 1])) / (2 * cap[None, :, r].astype(F64))
            for r in (0, 1))
    assert ((est.astype(F64) - fit) <= 2.0 ** -14 * w + 1e-30).all()


def walk_model(job_res, cmask, valid, avail, cap, k):
    """The kernels' scan of one split: each valid job walks the hosts in
    order; a masked pair whose estimate is at most the K-th entry is
    skipped, any other takes the exact path (resource fit, fitness,
    strict insertion after equal entries)."""
    kt = tpm.kept(k)
    est = estimates(job_res, valid, avail, cap)
    fit = exact_fit(job_res, avail, cap)
    with np.errstate(invalid="ignore"):
        feas = np.all(avail[None, :, :] >= job_res[:, None, :], axis=2)
    J, H = cmask.shape
    out_fit = np.full((J, kt), -np.inf, F32)
    out_host = np.zeros((J, kt), np.int32)
    exact_pairs = 0
    for j in np.flatnonzero(valid):
        v, ix, nan = [-np.inf] * kt, [0] * kt, None
        for h in range(H):
            if not cmask[j, h] or est[j, h] <= v[-1]:
                continue
            exact_pairs += 1
            f = fit[j, h]
            if feas[j, h] and np.isnan(f) and nan is None:
                nan = f
            if not feas[j, h] or not f > v[-1]:
                continue
            i = next(i for i in range(kt) if f > v[i])
            v.insert(i, f)
            ix.insert(i, h)
            v.pop()
            ix.pop()
        out_fit[j], out_host[j] = v, ix
        if nan is not None:   # a feasible NaN fitness: a row of it
            out_fit[j], out_host[j] = nan, 0
    return out_fit[:, :k], out_host[:, :k], exact_pairs


def _assert_topk_equal(got, want):
    fit, host = got
    wfit, whost = (t.numpy() for t in want)
    np.testing.assert_array_equal(fit.view(np.uint32), wfit.view(np.uint32))
    finite = wfit > -np.inf
    np.testing.assert_array_equal(host[finite], whost[finite])


@pytest.mark.parametrize("k", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("world", ["adversarial", "ties", "bench"])
def test_walk_with_the_prefilter_equals_the_plain_version(world, k):
    rng = np.random.default_rng(k)
    if world == "adversarial":
        job_res, valid, avail, cap = adversarial_world(k + 100, J=150,
                                                       H=260)
    elif world == "ties":   # quantized: many fits equal the K-th entry
        J, H = 150, 260
        job_res = rng.integers(1, 4, (J, 4)).astype(F32)
        cap = np.full((H, 4), 8.0, F32)
        avail = rng.integers(0, 9, (H, 4)).astype(F32)
        valid = rng.random(J) < 0.9
    else:                    # the structured bench world's recipe
        J, H = 150, 700
        job_res = np.stack([rng.integers(1, 8, J), rng.integers(64, 2048, J),
                            np.zeros(J), np.zeros(J)], 1).astype(F32)
        cap = np.stack([rng.integers(16, 64, H),
                        rng.integers(4096, 16384, H), np.zeros(H),
                        np.full(H, 1e6)], 1).astype(F32)
        avail = (cap * F32(0.8)).astype(F32)
        valid = np.ones(J, bool)
    cmask = rng.random((job_res.shape[0], avail.shape[0])) < 0.85
    fit, host, exact_pairs = walk_model(job_res, cmask, valid, avail, cap, k)
    t = torch.from_numpy
    want = tpm.topk_dense(t(job_res), t(cmask.view(np.uint8)),
                          t(valid.view(np.uint8)), t(avail), t(cap), k)
    _assert_topk_equal((fit, host), want)
    if world == "bench":   # the rule skips most pairs once lists fill
        assert exact_pairs < 0.25 * int(cmask[valid].sum())
