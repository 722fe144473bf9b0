"""cook_tpu_torch's top-K preference build (``ops/pallas_match``) against
the JAX package's Pallas kernels run in interpret mode on the CPU, at
``tests/test_pallas.py``'s shapes, the tie-heavy world and the
structured cases (E = 0 included).  Parity as the JAX tests define it:
``fit`` bit-identical everywhere, ``host`` equal where ``fit > -inf``
(the Pallas merge leaves implementation-defined hosts on -inf entries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import pallas_match as jpm
from cook_tpu_torch.ops import cuda_lib, telemetry
from cook_tpu_torch.ops import pallas_match as tpm

F32 = np.float32


def _problem(rng, J, H, tie_heavy=False):
    if tie_heavy:  # quantized resources: many identical fitness scores
        job_res = rng.integers(1, 4, (J, 4)).astype(F32)
        cap = np.full((H, 4), 8.0, F32)
        avail = rng.integers(0, 9, (H, 4)).astype(F32)
    else:          # non-dyadic values, so an order mistake shows
        job_res = rng.uniform(0.1, 4.0, (J, 4)).astype(F32)
        cap = rng.uniform(8.0, 64.0, (H, 4)).astype(F32)
        avail = (cap * rng.uniform(0.0, 1.0, (H, 4))).astype(F32)
    cmask = rng.random((J, H)) < 0.8
    valid = rng.random(J) < 0.9
    return job_res, cmask, valid, avail, cap


def _assert_parity(got, want):
    fit, host = (t.numpy() for t in got)
    wfit, whost = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(fit.view(np.uint32), wfit.view(np.uint32))
    finite = wfit > -np.inf
    np.testing.assert_array_equal(host[finite], whost[finite])
    assert fit.dtype == F32 and host.dtype == np.int32


@pytest.mark.parametrize("J,H,k", [(16, 8, 4), (128, 128, 16),
                                   (200, 300, 16), (300, 520, 8)])
def test_topk_prefs_matches_pallas(J, H, k):
    args = _problem(np.random.default_rng(J * 1000 + H), J, H)
    want = jpm.topk_prefs(*(jnp.asarray(a) for a in args), k=k,
                          interpret=True)
    got = tpm.topk_prefs(*args, k=k, device="cpu")
    _assert_parity(got, want)
    assert got[0].shape == (J, min(k, H))


def test_topk_prefs_tie_heavy_lowest_host():
    args = _problem(np.random.default_rng(7), 150, 260, tie_heavy=True)
    want = jpm.topk_prefs(*(jnp.asarray(a) for a in args), k=16,
                          interpret=True)
    _assert_parity(tpm.topk_prefs(*args, k=16, device="cpu"), want)


def _structured(J, H, E):
    rng = np.random.default_rng(J + H * 7 + E)
    job_res = rng.uniform(0.1, 4.0, (J, 4)).astype(F32)
    job_res[:, 2] = (rng.random(J) < 0.2).astype(F32)
    cap = rng.uniform(8.0, 64.0, (H, 4)).astype(F32)
    cap[:, 2] = (rng.random(H) < 0.3) * 4.0
    avail = (cap * rng.uniform(0.0, 1.0, (H, 4))).astype(F32)
    host_gpu = cap[:, 2] > 0
    host_blocked = rng.random(H) < 0.15
    valid = rng.random(J) < 0.9
    exc_id = np.full(J, -1, np.int32)
    exc_mask = np.zeros((max(E, 1), H), bool)
    if E:
        exc_id[rng.choice(J, size=E, replace=False)] = np.arange(E)
        exc_mask = rng.random((E, H)) < 0.5
    return (job_res, valid, host_gpu, host_blocked, exc_id, exc_mask, avail,
            cap)


@pytest.mark.parametrize("J,H,E,k", [(128, 128, 4, 8), (300, 520, 7, 16),
                                     (200, 130, 0, 8), (64, 40, 3, 16)])
def test_topk_prefs_structured_matches_pallas(J, H, E, k):
    args = _structured(J, H, E)
    want = jpm.topk_prefs_structured(*(jnp.asarray(a) for a in args), k=k,
                                     interpret=True)
    _assert_parity(tpm.topk_prefs_structured(*args, k=k, device="cpu"), want)


@pytest.mark.parametrize("structured", [False, True])
def test_nan_fitness_rows_match_pallas(structured):
    """A feasible host of infinite cpu capacity and avail makes a NaN
    fitness (inf - inf); the Pallas merge's running max then leaves the
    job's whole row NaN (host 0).  The port gives the same rows."""
    if structured:
        args = list(_structured(120, 300, 3))
        avail, cap, mask_ok = args[6], args[7], ~args[3]
    else:
        args = list(_problem(np.random.default_rng(11), 120, 300))
        avail, cap, mask_ok = args[3], args[4], np.ones(300, bool)
    for h in (5, 77, 250):
        cap[h, 0] = avail[h, 0] = np.inf
        mask_ok[h] = True
    if structured:
        args[3] = ~mask_ok
        fn = tpm.topk_prefs_structured
        want = jpm.topk_prefs_structured(*(jnp.asarray(a) for a in args),
                                         k=8, interpret=True)
    else:
        fn = tpm.topk_prefs
        want = jpm.topk_prefs(*(jnp.asarray(a) for a in args), k=8,
                              interpret=True)
    got = fn(*args, k=8, device="cpu")
    _assert_parity(got, want)
    nan_rows = np.isnan(np.asarray(want[0])).all(axis=1)
    assert 0 < nan_rows.sum() < 120
    assert (got[1].numpy()[nan_rows] == 0).all()


def test_structured_equals_dense_on_the_composed_mask():
    job_res, valid, hg, hb, exc_id, exc_mask, avail, cap = \
        _structured(300, 520, 7)
    dense = np.where(job_res[:, 2:3] > 0, hg[None], ~hg[None]) & ~hb[None]
    rows = exc_id >= 0
    dense[rows] = exc_mask[exc_id[rows]]
    a = tpm.topk_prefs_structured(job_res, valid, hg, hb, exc_id, exc_mask,
                                  avail, cap, k=16, device="cpu")
    b = tpm.topk_prefs(job_res, dense, valid, avail, cap, k=16, device="cpu")
    _assert_parity(a, b)


def test_structured_refuses_an_exception_row_past_the_mask():
    args = list(_structured(20, 30, 2))
    args[4] = args[4].copy()
    args[4][3] = 2
    with pytest.raises(ValueError, match="exc_id"):
        tpm.topk_prefs_structured(*args, k=4, device="cpu")


def test_plain_chunks_agree_with_one_chunk(monkeypatch):
    args = _problem(np.random.default_rng(3), 90, 70)
    whole = tpm.topk_prefs(*args, k=8, device="cpu")
    monkeypatch.setattr(tpm, "CHUNK_SCORES", 70 * 7)
    _assert_parity(tpm.topk_prefs(*args, k=8, device="cpu"), whole)


def test_cpu_wrappers_launch_nothing():
    telemetry.reset_all()
    tpm.topk_prefs(*_problem(np.random.default_rng(1), 20, 30), k=4,
                   device="cpu")
    tpm.topk_prefs_structured(*_structured(20, 30, 2), k=4, device="cpu")
    counts = telemetry.snapshot()
    assert counts["topk_dense"] == 0 and counts["topk_structured"] == 0
    assert tpm.topk_dense.kernel == "topk_dense"
    assert tpm.topk_structured.kernel == "topk_structured"


def test_topk_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tpm.topk_prefs(*_problem(np.random.default_rng(0), 8, 8), k=4)
    with pytest.raises(RuntimeError, match="cuda"):
        tpm.topk_prefs_structured(*_structured(8, 8, 1), k=4)


def test_launch_shapes():
    """Host splits fill the card for small J; kept entries cover k."""
    assert tpm.topk_plan(100_000, 50_000, False, 132, 3).splits == 1
    assert tpm.topk_plan(10_000, 50_000, True, 132, 2).splits == 10
    assert tpm.topk_plan(10_000, 50_000, True, 66, 2).splits == 5
    assert tpm.topk_plan(16, 8, True, 132, 2).splits == 1
    assert [tpm.kept(k) for k in (1, 8, 9, 16)] == [8, 8, 16, 16]
    with pytest.raises(ValueError):
        tpm.kept(17)
    assert "topk_dense" in cuda_lib._SIGNATURES


@pytest.mark.parametrize("structured", [False, True])
def test_k_above_16_refused_on_every_device(structured):
    """The kernels keep at most 16 entries a job, so the entry points
    refuse a larger K on the CPU too; K = min(k, H) still applies."""
    if structured:
        fn, make = tpm.topk_prefs_structured, lambda H: _structured(20, H, 2)
    else:
        fn = tpm.topk_prefs
        make = lambda H: _problem(np.random.default_rng(2), 20, H)  # noqa: E731
    with pytest.raises(ValueError, match="k <= 16"):
        fn(*make(30), k=17, device="cpu")
    assert fn(*make(12), k=20, device="cpu")[0].shape == (20, 12)
