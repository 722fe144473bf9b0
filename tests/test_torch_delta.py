"""The port's resident-wire state against the JAX package on the CPU.

``PackDeltaApplier`` (stage, then commit into flat buffers with a dump
slot) is held against ``cook_tpu.ops.delta.PackDeltaApplier(donate=
False)`` and ``reference_impl.apply_pack_delta``: every codec at the
edges of its range and one past each, k from 0 to the whole buffer, a T
that is not a power of two, and the same byte account.
``DeviceBaseMirror`` runs through cold, append, overflow and
compaction beside the JAX mirror; ``pack_diff`` is held against
``cook_tpu.native.pack.pack_diff``.  A malformed batch raises.  Every
comparison is exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.native import pack as jpack
from cook_tpu.ops import delta as jdelta
from cook_tpu.ops import quant as jq
from cook_tpu.ops import reference_impl as jref
from cook_tpu_torch.ops import delta as tdelta
from cook_tpu_torch.ops import quant as tq
from cook_tpu_torch.ops import reference_impl as tref
from cook_tpu_torch.ops import telemetry

CPU = torch.device("cpu")


def _buffers(rng, P, T):
    rows = rng.integers(0, 1 << 20, (P, T)).astype(np.int32)
    flags = rng.integers(0, 32, (P, T)).astype(np.uint8)
    return rows, flags


def _apply_both(rows, flags, idx, rv, fv, quantize):
    """(port rows, port flags, port staged, jax rows, jax flags, jax
    staged) after one batch."""
    P, T = rows.shape
    ap = tdelta.PackDeltaApplier(device="cpu")
    st = ap.stage((P, T), idx, rv, fv, quantize=quantize)
    rb = torch.from_numpy(np.append(rows.ravel(), 0).astype(np.int32))
    fb = torch.from_numpy(np.append(flags.ravel(), 0).astype(np.uint8))
    ap.commit(rb, fb, st)
    japp = jdelta.PackDeltaApplier(donate=False)
    jst = japp.stage((P, T), idx, rv, fv, quantize=quantize)
    jr, jf = japp.commit(jnp.asarray(rows), jnp.asarray(flags), jst)
    return (rb[:-1].view(P, T).numpy(), fb[:-1].view(P, T).numpy(), st,
            np.asarray(jr), np.asarray(jf), jst)


def _check(rows, flags, idx, rv, fv, quantize):
    got_r, got_f, st, want_r, want_f, jst = _apply_both(
        rows, flags, idx, rv, fv, quantize)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_f, want_f)
    # the port's host golden, and the JAX package's, on the padded batch
    pad = np.full(st.kb - idx.size, rows.size, np.int32)
    args = (np.concatenate([idx, pad]).astype(np.int32),
            np.concatenate([rv, np.zeros(pad.size, np.int32)]),
            np.concatenate([fv, np.zeros(pad.size, np.uint8)]))
    for ref in (tref, jref):
        ref_r, ref_f = ref.apply_pack_delta(rows, flags, *args)
        np.testing.assert_array_equal(got_r, ref_r)
        np.testing.assert_array_equal(got_f, ref_f)
    assert st.codec == jst.codec
    assert st.kb == jst.kb
    assert st.nbytes == jst.nbytes
    np.testing.assert_array_equal(st.idx.numpy(), np.asarray(jst.idx))
    np.testing.assert_array_equal(st.vals.numpy(), np.asarray(jst.vals))
    return st


@pytest.mark.parametrize("offset,codec", [
    (-128, tq.ROWS_I8), (127, tq.ROWS_I8), (-129, tq.ROWS_I16),
    (128, tq.ROWS_I16), (-32768, tq.ROWS_I16), (32767, tq.ROWS_I16),
    (-32769, tq.ROWS_WIDE), (32768, tq.ROWS_WIDE)])
def test_codec_edges_match_jax(offset, codec):
    rng = np.random.default_rng(abs(offset))
    P, T = 3, 70_000
    rows, flags = _buffers(rng, P, T)
    idx = np.sort(rng.choice(P * T, 40, replace=False)).astype(np.int32)
    # every delta within [-100, 100] except one at the edge under test
    rv = (idx % T + rng.integers(-100, 101, 40)).astype(np.int32)
    rv[7] = idx[7] % T + offset
    fv = rng.integers(0, 32, 40).astype(np.uint8)
    st = _check(rows, flags, idx, rv, fv, quantize=True)
    assert st.codec == codec
    assert tq.ROWS_WIDE == jq.ROWS_WIDE and tq.ROWS_I8 == jq.ROWS_I8


@pytest.mark.parametrize("k", [0, 1, 255, 256, 257, "all"])
@pytest.mark.parametrize("quantize", [False, True])
def test_batch_sizes_match_jax(k, quantize):
    rng = np.random.default_rng(11)
    P, T = 2, 300            # not a power of two
    n = P * T
    k = n if k == "all" else k
    rows, flags = _buffers(rng, P, T)
    rows = (np.arange(T) + rng.integers(-5, 6, (P, T))).astype(np.int32)
    idx = np.sort(rng.choice(n, k, replace=False)).astype(np.int32)
    rv = (idx % T + rng.integers(-90, 90, k)).astype(np.int32)
    fv = rng.integers(0, 32, k).astype(np.uint8)
    st = _check(rows, flags, idx, rv, fv, quantize)
    assert st.kb == min(max(256, 1 << max(k - 1, 0).bit_length()), n)
    assert st.nbytes == 4 * st.kb + st.vals.element_size() * st.kb + st.kb


def test_delta_larger_than_buffer_raises():
    rows, flags = _buffers(np.random.default_rng(0), 2, 8)
    idx = np.arange(17, dtype=np.int32) % 16
    ap = tdelta.PackDeltaApplier(device="cpu")
    with pytest.raises(ValueError, match="larger than buffer"):
        ap.stage((2, 8), idx, np.zeros(17, np.int32), np.zeros(17, np.uint8))
    with pytest.raises(ValueError, match="larger than buffer"):
        jdelta.PackDeltaApplier(donate=False).stage(
            (2, 8), idx, np.zeros(17, np.int32), np.zeros(17, np.uint8))


def test_malformed_batch_raises_and_leaves_buffers():
    """No fallback: a bad batch raises; nothing degrades to a repack."""
    P, T = 2, 64
    rows, flags = _buffers(np.random.default_rng(2), P, T)
    ap = tdelta.PackDeltaApplier(device="cpu")
    rb = torch.from_numpy(np.append(rows.ravel(), 0).astype(np.int32))
    fb = torch.from_numpy(np.append(flags.ravel(), 0).astype(np.uint8))
    before = rb.clone(), fb.clone()
    with pytest.raises(ValueError, match="outside"):
        ap.stage((P, T), np.array([3, P * T], np.int32),
                 np.zeros(2, np.int32), np.zeros(2, np.uint8))
    st = ap.stage((P, T), np.array([3, 5], np.int32),
                  np.array([1, 2], np.int32), np.array([1, 2], np.uint8))
    past_dump = st._replace(idx=torch.full_like(st.idx, P * T + 1))
    with pytest.raises(IndexError):
        ap.commit(rb, fb, past_dump)
    wrong_dtype = st._replace(vals=st.vals.to(torch.int64))
    with pytest.raises(ValueError, match="values"):
        ap.commit(rb, fb, wrong_dtype)
    with pytest.raises(ValueError, match="rows buffer"):
        ap.commit(rb[:-1], fb, st)
    assert torch.equal(rb, before[0]) and torch.equal(fb, before[1])


def test_padding_lands_in_the_dump_slot():
    P, T = 2, 100
    rows, flags = _buffers(np.random.default_rng(3), P, T)
    ap = tdelta.PackDeltaApplier(device="cpu")
    rb = torch.from_numpy(np.append(rows.ravel(), 0).astype(np.int32))
    fb = torch.from_numpy(np.append(flags.ravel(), 0).astype(np.uint8))
    ptr = rb.data_ptr()
    idx = np.array([0, 199], np.int32)
    ap.apply(rb, fb, (P, T), idx, np.array([7, 9], np.int32),
             np.array([1, 3], np.uint8), quantize=True)
    assert rb.data_ptr() == ptr            # in place
    assert rb[0] == 7 and rb[199] == 9 and fb[199] == 3
    np.testing.assert_array_equal(rb[1:199].numpy(), rows.ravel()[1:199])


def test_applier_and_mirror_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdelta.PackDeltaApplier()
    with pytest.raises(RuntimeError, match="cuda"):
        tdelta.DeviceBaseMirror()


def _mirror_world(rng, n):
    res = (rng.random((n, 4)) * 9 + 0.1).astype(np.float32)
    disk = (rng.random(n) * 300).astype(np.float32)
    return res, disk


def test_base_mirror_matches_jax():
    """cold, append, no-op, append past capacity (overflow), compaction,
    a grow past the capacity: each sync equals the JAX mirror's arrays
    and the numpy snapshot."""
    rng = np.random.default_rng(4)
    res, disk = _mirror_world(rng, 5_000)
    mine = tdelta.DeviceBaseMirror(device="cpu")
    ref = jdelta.DeviceBaseMirror()
    steps = [(2_100, 0, "full"), (2_300, 0, "append"), (2_300, 0, None),
             (3_000, 0, "append"), (3_100, 0, "append"),
             (3_200, 0, "full"),      # the 1,024-row chunk overflows
             (3_000, 1, "full"), (3_050, 1, "append"),
             (5_000, 1, "full")]      # past the capacity
    for n, epoch, kind in steps:
        r, d = mine.sync(res[:n], disk[:n], epoch)
        jr, jd = ref.sync(res[:n], disk[:n], epoch)
        assert mine.last_sync == kind, (n, epoch)
        assert mine.capacity == ref.capacity
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(r.numpy()[:n], res[:n])
        assert not r.numpy()[n:].any()


def test_base_mirror_append_is_in_place():
    rng = np.random.default_rng(5)
    res, disk = _mirror_world(rng, 3_000)
    m = tdelta.DeviceBaseMirror(device="cpu")
    r0, _ = m.sync(res[:2_100], disk[:2_100], 0)
    telemetry.reset_all()
    r1, _ = m.sync(res[:2_800], disk[:2_800], 0)
    assert r1.data_ptr() == r0.data_ptr() and m.last_sync == "append"
    assert telemetry.events()["transfer.h2d"] == 1_024 * 5 * 4


@pytest.mark.parametrize("changes", [0, 1, 97, 4096])
def test_pack_diff_matches_jax_package(changes):
    rng = np.random.default_rng(changes)
    a = rng.integers(0, 50, (2, 4096)).astype(np.int32)
    fa = rng.integers(0, 32, (2, 4096)).astype(np.uint8)
    b, fb = a.copy(), fa.copy()
    b.reshape(-1)[rng.integers(0, 8192, changes)] += 1
    fb.reshape(-1)[rng.integers(0, 8192, changes // 2)] ^= 8
    got = tdelta.pack_diff(a, b, fa, fb)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jpack.pack_diff(a, b, fa, fb))
