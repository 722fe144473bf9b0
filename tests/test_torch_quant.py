"""cook_tpu_torch's quantized wire against the JAX package on the CPU:
the wire flag bits and host codecs give the same codec, scales and
bytes; the plain decodes give the JAX decodes' values;
``stage_mega_wire`` negotiates the way the fused driver's
``_stage_mega`` does (identity-padded rows, sticky scales, bitpacked
hosts, gang arrays padded across the group) and its wire decodes
losslessly.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import delta as jdelta
from cook_tpu.ops import quant as jq
from cook_tpu_torch.ops import delta as tdelta
from cook_tpu_torch.ops import gang as tgang
from cook_tpu_torch.ops import quant as tq
from cook_tpu_torch.ops.pallas_cycle import decode_wire
from cook_tpu_torch.sched.fused import stage_mega_wire

F32 = np.float32


@pytest.mark.parametrize("spread,codec", [(100, tq.ROWS_I8),
                                          (30000, tq.ROWS_I16),
                                          (10 ** 6, tq.ROWS_WIDE)])
def test_rows_codec_and_decode_match_jax(spread, codec):
    rng = np.random.default_rng(spread)
    T = 256
    rows = (np.arange(T) + rng.integers(0, spread, (2, T)) % spread) \
        .astype(np.int32)
    a, b = jq.quantize_rows(rows), tq.quantize_rows(rows)
    assert a.codec == b.codec == codec
    np.testing.assert_array_equal(a.data, b.data)
    got = tq.expand_rows_device(b.codec, torch.from_numpy(b.data))
    want = jq.expand_rows_device(a.codec, jnp.asarray(a.data), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), rows)
    np.testing.assert_array_equal(tq.expand_rows(b), jq.expand_rows(a))


@pytest.mark.parametrize("wide", [False, True])
def test_fixed_codec_and_decode_match_jax(wide):
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, 64, (2, 50)) * 0.5,
                  rng.integers(0, 500, (2, 50)) * 1024.0,
                  rng.integers(0, 8, (2, 50)) * 1.0,
                  rng.integers(0, 60000, (2, 50)) * 32.0], -1).astype(F32)
    if wide:
        x[0, 0, 0] = 0.3    # not a power-of-two fraction: wide
    a, b = jq.quantize_fixed(x, "avail"), tq.quantize_fixed(x)
    assert a.scale == b.scale
    assert (b.scale == 0.0) == wide
    np.testing.assert_array_equal(a.data, b.data)
    got = tq.expand_fixed_device(b.scale, torch.from_numpy(b.data))
    want = jq.expand_fixed_device(a.scale, jnp.asarray(a.data))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    np.testing.assert_array_equal(got.numpy(), x)


def test_sticky_scale_is_reused():
    x = np.full((1, 4, 4), 2.0, F32)
    first = tq.quantize_fixed(x)
    assert first.scale == (0.125,) * 4
    again = tq.quantize_fixed(x * 2, prefer=(1.0, 1.0, 1.0, 1.0))
    assert again.scale == (1.0, 1.0, 1.0, 1.0)
    np.testing.assert_array_equal(tq.expand_fixed(again), x * 2)


@pytest.mark.parametrize("H", [5, 64, 70])
def test_unpack_bits_matches_jax(H):
    rng = np.random.default_rng(H)
    bits = rng.random((2, 3, H)) < 0.4
    packed = tq.pack_bits(bits)
    np.testing.assert_array_equal(packed, jq.pack_bits(bits))
    got = tq.unpack_bits_device(torch.from_numpy(packed), H)
    want = jq.unpack_bits_device(jnp.asarray(packed), H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), bits)
    np.testing.assert_array_equal(tq.unpack_bits(packed, H),
                                  jq.unpack_bits(packed, H))


@pytest.mark.parametrize("with_ok", [False, True])
def test_pack_flags_matches_jax(with_ok):
    rng = np.random.default_rng(7)
    pend, valid, first, enq, launch = rng.random((5, 2, 40)) < 0.5
    ok = dict(enqueue_ok=enq, launch_ok=launch) if with_ok else {}
    np.testing.assert_array_equal(
        tdelta.pack_flags(pend, valid, first, **ok),
        jdelta.pack_flags(pend, valid, first, **ok))
    assert (tdelta.FLAG_PENDING, tdelta.FLAG_VALID, tdelta.FLAG_ENQUEUE_OK,
            tdelta.FLAG_LAUNCH_OK, tdelta.FLAG_USER_FIRST) == (
        jdelta.FLAG_PENDING, jdelta.FLAG_VALID, jdelta.FLAG_ENQUEUE_OK,
        jdelta.FLAG_LAUNCH_OK, jdelta.FLAG_USER_FIRST)


def _group(rng, P=2, T=256, H=20, U=5, E=3, N=300):
    rows = np.zeros((P, T), np.int32)
    n_tasks = [100, 60]
    for p in range(P):
        rows[p, :n_tasks[p]] = p * 100 + np.arange(n_tasks[p])
    return dict(
        rows_p=rows, flags_p=rng.integers(0, 32, (P, T)).astype(np.uint8),
        n_tasks=n_tasks, res_base=torch.from_numpy(
            rng.random((N, 4)).astype(F32)),
        disk_base=torch.from_numpy(rng.random(N).astype(F32)),
        tokens_u_p=np.full((P, U), np.inf, F32),
        shares_u_p=np.ones((P, U, 3), F32), quota_u_p=np.ones((P, U, 4), F32),
        scalars=dict(num_considerable=np.full(P, 8, np.int32),
                     pool_quota=np.ones((P, 4), F32),
                     group_quota=np.ones((P, 4), F32),
                     group_id=np.zeros(P, np.int32)),
        host_gpu_p=rng.random((P, H)) < 0.3,
        host_blocked_p=rng.random((P, H)) < 0.2,
        exc_rows_p=np.full((P, E), -1, np.int32),
        exc_mask_p=rng.random((P, E, H)) < 0.5,
        avail_p=rng.integers(0, 9, (P, H, 4)).astype(F32) * 0.5,
        cap_p=rng.integers(9, 20, (P, H, 4)).astype(F32))


def test_stage_mega_wire_negotiates_and_decodes_losslessly():
    rng = np.random.default_rng(9)
    g = _group(rng)
    offers = [SimpleNamespace(attributes={"rack": str(h % 3)})
              for h in range(20)]
    groups = {"g": SimpleNamespace(gang=True, gang_size=2, gang_min=0,
                                   gang_max=0, gang_topology="rack")}
    wire1 = tgang.build_gang_wire(256, {"g": [(3, None), (4, None)]},
                                  groups, offers)
    scales = {}
    out = stage_mega_wire(**g, gang_wires=[None, wire1], scales=scales,
                          device="cpu")
    # a zero-padded tail would read as deltas down to -255 (int16); the
    # identity padding leaves the real rows' deltas (<= 100) to decide
    assert out["rows_codec"] == tq.ROWS_I8
    assert scales["avail"] == out["avail_scale"] != 0.0
    w = out["wire"]
    inp = decode_wire(w, out["rows_codec"], out["avail_scale"],
                      out["cap_scale"])
    for p, n in enumerate(g["n_tasks"]):
        np.testing.assert_array_equal(inp.rows[p, :n].numpy(),
                                      g["rows_p"][p, :n])
    np.testing.assert_array_equal(inp.avail.numpy(), g["avail_p"])
    np.testing.assert_array_equal(inp.capacity.numpy(), g["cap_p"])
    np.testing.assert_array_equal(inp.host_gpu.numpy(), g["host_gpu_p"])
    np.testing.assert_array_equal(inp.host_blocked.numpy(),
                                  g["host_blocked_p"])
    # gang arrays: pool 0 is the no-op row, pool 1 carries the gang
    assert tuple(w.gang_size.shape) == (2, 8)
    assert (w.gang_id[0] == -1).all() and (w.gang_size[0] == 2 ** 30).all()
    assert w.gang_id[1, 3] == 0 and w.gang_size[1, 0] == 2
    assert w.host_topo.shape == (2, 2, 20)
    # sticky: a later cycle whose values the old scale still codes keeps it
    g["avail_p"] = g["avail_p"] * 2
    again = stage_mega_wire(**g, gang_wires=[None, None], scales=scales,
                            device="cpu")
    assert again["avail_scale"] == out["avail_scale"]
    wide = stage_mega_wire(**g, gang_wires=[None, None], quantize=False,
                           device="cpu")
    assert wide["rows_codec"] == tq.ROWS_WIDE and wide["avail_scale"] == 0.0
