"""K1, the wire decode and phase-0 bases (``ops/expand.py``), on the CPU.

The kernel (``csrc/expand.cu``) runs only on the card; here:

* a numpy model of its tile reduction (level-1 partials by tile, then
  the levels the pool's last tile sums) against ``window32_sum`` at
  every T of ``chip_smoke.py``'s phase F and both tile sizes, and
  against ``jnp.sum`` at powers of two;
* a numpy model of its tile-local exception scatter against the JAX
  package's ``expand_compact``;
* ``expand_plan`` against the constants ``expand.cu`` is compiled for;
* ``_expand_plain`` (the plain version) against the JAX package's
  decode and phase-0 sums on seeded worlds.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import quant as jq
from cook_tpu.parallel.sharded import CompactPoolCycleInputs, expand_compact
from cook_tpu_torch.ops import expand as tex
from cook_tpu_torch.ops import quant as tq
from cook_tpu_torch.ops.scan import window32_sum

F32 = np.float32
EDGE_T = (1, 31, 32, 33, 1_023, 1_024, 1_025, 2_047, 2_048, 2_049, 4_095,
          4_096, 4_097, 131_072, 1_048_576)
WIN = 32


def _seq(x):
    """Sum along axis 1 in order from +0.0 (f32 at every step)."""
    acc = np.zeros((x.shape[0],) + x.shape[2:], F32)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _windows(x):
    """Window sums of 32 rows along axis 0; a ragged last window sums
    only its own rows."""
    n = x.shape[0]
    full = n // WIN
    out = [_seq(x[:full * WIN].reshape((full, WIN) + x.shape[1:]))]
    if n % WIN:
        out.append(_seq(x[full * WIN:][None]))
    return np.concatenate(out)


def tile_model(run, tile):
    """K1's pool base: each tile's level-0 windows (32 rows) and level-1
    windows (32 of those) of its own rows, then the finisher's levels
    over the pool's level-1 partials, windows of 32 until at most 32
    remain, then their sum in order."""
    T = run.shape[0]
    partials = []
    for lo in range(0, T, tile):
        lvl0 = _windows(run[lo:lo + tile])
        for v in range(tile // (WIN * WIN)):
            if v * WIN < lvl0.shape[0]:
                partials.append(_seq(lvl0[None, v * WIN:(v + 1) * WIN])[0])
    cur = np.stack(partials)
    assert cur.shape[0] == -(-T // (WIN * WIN))
    while cur.shape[0] > WIN:
        cur = _windows(cur)
    return _seq(cur[None])[0]


def _run(rng, T, specials=False):
    """Masked usage: non-dyadic values of both signs, zeros where the
    row is pending or invalid; with ``specials`` also +-inf times 0."""
    x = (rng.standard_normal((T, 4)) * rng.uniform(0.1, 900, (T, 4))) \
        .astype(F32)
    keep = rng.random(T) < 0.7
    if specials:
        x[rng.random(T) < 0.01, 1] = np.inf
        x[rng.random(T) < 0.01, 2] = -np.inf
    with np.errstate(invalid="ignore"):    # inf x 0 = NaN, on purpose
        return (x * keep[:, None].astype(F32)).astype(F32)


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(a.view(np.uint32)[~np.isnan(a)],
                                  b.view(np.uint32)[~np.isnan(b)])


@pytest.mark.parametrize("tile", [2_048, 4_096])
@pytest.mark.parametrize("T", EDGE_T)
def test_tile_reduction_equals_window32_sum(T, tile):
    rng = np.random.default_rng(T + tile)
    for specials in (False, True):
        run = _run(rng, T, specials)
        want = window32_sum(torch.from_numpy(run), dim=0).numpy()
        _bits_equal(tile_model(run, tile), want)


@pytest.mark.parametrize("T", [64, 1_024, 4_096, 131_072, 1_048_576])
def test_tile_reduction_equals_jnp_sum_at_powers_of_two(T):
    run = _run(np.random.default_rng(T), T)
    want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=0))(run))
    _bits_equal(tile_model(run, tex.TILE), want)


def exc_tile_model(exc_rows, T, tile):
    """One pool's exc_id as K1's tiles write it: each tile's slice starts
    at -1 and takes every exception row inside it, the highest e on a
    duplicate."""
    out = np.empty(T, np.int32)
    for lo in range(0, T, tile):
        n = min(tile, T - lo)
        sl = np.full(n, -1, np.int32)
        for e, r in enumerate(exc_rows):
            if lo <= r < lo + n:
                sl[r - lo] = max(sl[r - lo], e)
        out[lo:lo + n] = sl
    return out


def _world(seed, S, T, codec, H=13, E=24, U=7):
    """Compact-wire fields in the negotiated forms: rows in the codec,
    u16 avail and capacity with power-of-two scales where ``codec`` is
    narrow, f32 where wide."""
    rng = np.random.default_rng(seed)
    N = T + 300
    t = np.arange(T)
    if codec == jq.ROWS_WIDE:
        rows = rng.integers(0, N, (S, T)).astype(np.int32)
        wire_rows = rows
    else:
        lim = 100 if codec == jq.ROWS_I8 else 30_000
        rows = np.clip(t + rng.integers(-lim, lim, (S, T)), 0, N - 1)
        wire_rows = (rows - t).astype(np.int8 if codec == jq.ROWS_I8
                                      else np.int16)
        rows = rows.astype(np.int32)
    flags = rng.integers(0, 32, (S, T)).astype(np.uint8)
    flags &= ~np.where(rng.random((S, T)) < 0.9, 16, 0).astype(np.uint8)
    tile = tex.TILE
    exc = rng.integers(-2, T + 3, (S, E)).astype(np.int32)
    exc[:, :8] = [0, T - 1, tile - 1, tile, -1, T, T + 5, tile + 1]
    exc[:, 9] = exc[:, 0]                  # duplicates: the later e wins
    exc[:, E - 1] = exc[:, 1]
    f = dict(
        rows=rows, flags=flags,
        res_base=(rng.standard_normal((N, 4)) * 3.7 + 1.3).astype(F32),
        disk_base=(rng.random(N) * 2048.3).astype(F32),
        tokens_u=(rng.random((S, U)) * 50).astype(F32),
        shares_u=(rng.random((S, U, 3)) * 20 + 0.5).astype(F32),
        quota_u=(rng.random((S, U, 4)) * 400).astype(F32),
        num_considerable=np.full(S, 8, np.int32),
        pool_quota=np.ones((S, 4), F32), group_quota=np.ones((S, 4), F32),
        group_id=np.array([(q % 3) - 1 for q in range(S)], np.int32),
        host_gpu=rng.random((S, H)) < 0.3,
        host_blocked=rng.random((S, H)) < 0.2, exc_rows=exc,
        exc_mask=np.zeros((S, E, H), bool),
        avail=(rng.integers(0, 60000, (S, H, 4)) * 0.25).astype(F32),
        capacity=(rng.integers(0, 60000, (S, H, 4)) * 0.5).astype(F32))
    if codec == jq.ROWS_WIDE:
        a_scale = c_scale = 0.0
        avail, cap = f["avail"], f["capacity"]
    else:
        a_scale, c_scale = (0.25,) * 4, (0.5,) * 4
        avail = (f["avail"] * 4).astype(np.uint16)
        cap = (f["capacity"] * 2).astype(np.uint16)
    wire = dict(rows=wire_rows, avail=avail, cap=cap,
                host_bits=np.stack([jq.pack_bits(f["host_gpu"]),
                                    jq.pack_bits(f["host_blocked"])], 1))
    return f, wire, dict(rows_codec=codec, avail_scale=a_scale,
                         cap_scale=c_scale, n_hosts=H)


def _plain(f, wire, kw):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    flags = t(f["flags"])
    user_rank = torch.cumsum(((flags & 16) != 0).to(torch.int32), 1,
                             dtype=torch.int32) - 1
    return tex.expand(
        t(wire["rows"]), flags, t(f["res_base"]), t(f["disk_base"]),
        t(f["tokens_u"]), t(f["shares_u"]), t(f["quota_u"]), user_rank,
        t(f["group_id"]), t(wire["host_bits"]), t(f["exc_rows"]),
        t(wire["avail"]), t(wire["cap"]), **kw)


@pytest.mark.parametrize("tile", [2_048, 4_096])
def test_exception_scatter_model_equals_expand_compact(tile):
    f, wire, kw = _world(3, 3, 4_097, jq.ROWS_WIDE)
    s = expand_compact(CompactPoolCycleInputs(
        **{k: jnp.asarray(v) for k, v in f.items()}))
    want = np.asarray(s.exc_id)
    for p in range(3):
        np.testing.assert_array_equal(
            exc_tile_model(f["exc_rows"][p], 4_097, tile), want[p])
    np.testing.assert_array_equal(_plain(f, wire, kw).exc_id.numpy(), want)
    # the world holds every case: duplicates, -1, >= T, tile boundaries
    assert (want >= 0).sum() < f["exc_rows"].shape[1] * 3
    assert want[0, 0] == 9 and want[0, 4_096] == 23


@pytest.mark.parametrize("codec", [jq.ROWS_WIDE, jq.ROWS_I16, jq.ROWS_I8])
@pytest.mark.parametrize("S,T", [(33, 4_097), (4, 4_096)])
def test_expand_plain_equals_jax_decode_and_bases(codec, S, T):
    """Every output against the JAX package's decode (``expand_compact``
    and the quant decodes); the bases against its phase-0 ``jnp.sum``
    bit for bit where S and T are powers of two (the cycle's buckets).
    At S = 33 and T = 4,097 XLA:CPU sums in another order than windows
    of 32, so there the bases are held bit for bit against the tile
    model and ``window32_sum`` (the kernel's order) and to one part in
    10^5 against ``jnp.sum``."""
    f, wire, kw = _world(codec + 10 * S, S, T, codec)
    got = _plain(f, wire, kw)
    s = expand_compact(CompactPoolCycleInputs(
        **{k: jnp.asarray(v) for k, v in f.items()}))
    rows = np.asarray(jq.expand_rows_device(codec, jnp.asarray(wire["rows"]),
                                            T))
    np.testing.assert_array_equal(rows, f["rows"])
    for name in ("usage", "job_res", "tokens", "shares", "quota", "exc_id"):
        _bits_equal(getattr(got, name).numpy(),
                    np.asarray(getattr(s, name)).astype(
                        getattr(got, name).numpy().dtype))
    H = kw["n_hosts"]
    for i, name in enumerate(("host_gpu", "host_blocked")):
        want = np.asarray(jq.unpack_bits_device(
            jnp.asarray(wire["host_bits"][:, i]), H))
        np.testing.assert_array_equal(getattr(got, name).numpy(), want)
    for name, scale, data in (("avail", kw["avail_scale"], wire["avail"]),
                              ("capacity", kw["cap_scale"], wire["cap"])):
        want = np.asarray(jq.expand_fixed_device(scale, jnp.asarray(data)))
        _bits_equal(getattr(got, name).numpy(), want.astype(F32))
        _bits_equal(getattr(got, name).numpy(),
                    tq.expand_fixed_device(scale, torch.from_numpy(data))
                    .numpy())
    # segment starts and ends from the flags
    first = (f["flags"] & 16) != 0
    t = np.arange(T)
    np.testing.assert_array_equal(got.start.numpy(),
                                  (first | (t == 0)).astype(np.uint8))
    nxt = np.ones_like(first)
    nxt[:, :-1] = first[:, 1:]
    np.testing.assert_array_equal(got.last_mark.numpy(),
                                  np.where(nxt, t, T - 1))
    # phase 0: the running usage of each pool and of its quota group
    run = np.asarray(s.usage) * (np.asarray(s.valid)
                                 & ~np.asarray(s.pending))[..., None]
    pool_jax = np.asarray(jax.jit(jax.vmap(
        lambda u, m: jnp.sum(u * m[:, None], axis=0)[:4]))(
        s.usage, s.valid & ~s.pending))
    gid = f["group_id"]
    group_jax = np.asarray(jax.jit(jax.vmap(lambda g: jnp.sum(
        jnp.asarray(pool_jax) * ((jnp.asarray(gid) == g) & (g >= 0))[:, None],
        axis=0)))(jnp.asarray(gid)))
    model = np.stack([tile_model(run[p].astype(F32), tex.TILE)
                      for p in range(S)])
    _bits_equal(got.pool_base.numpy(), model)
    same = (gid[None, :] == gid[:, None]) & (gid[:, None] >= 0)
    group_model = np.stack([
        window32_sum(torch.from_numpy(model * same[p][:, None]), 0).numpy()
        for p in range(S)])
    _bits_equal(got.group_base.numpy(), group_model)
    if S & (S - 1) == 0 and T & (T - 1) == 0:
        _bits_equal(got.pool_base.numpy(), pool_jax)
        _bits_equal(got.group_base.numpy(), group_jax)
    else:
        np.testing.assert_allclose(got.pool_base.numpy(), pool_jax,
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got.group_base.numpy(), group_jax,
                                   rtol=1e-5, atol=1e-3)


def _cu_constants():
    """The geometry csrc/expand.cu is compiled for, from its source."""
    text = (Path(tex.__file__).parent / "csrc" / "expand.cu").read_text()
    return {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr\s+[\w ]+?\s(k\w+)\s*=\s*([^;]+);", text)}


def test_plan_constants_are_the_kernels():
    src = _cu_constants()
    assert int(src["kTile"]) == tex.TILE
    assert int(src["kHostTile"]) == tex.HOST_TILE
    assert int(src["kExpandThreads"]) == tex.THREADS
    assert int(src["kWin"]) == tex.WIN
    assert int(src["kMaxWindows"]) == tex.MAX_WINDOWS
    assert src["kMaxPools"] == "kWin * kWin" and tex.MAX_POOLS == 32 * 32
    # the kernel's shared memory: masked usage with a float4 of padding
    # every 32 rows, the exc_id slice, the level-0 partials
    assert tex.SMEM_BYTES == 4 * 4 * (tex.TILE + tex.TILE // 32) \
        + 4 * tex.TILE + 4 * 4 * (tex.TILE // 32)
    assert tex.SMEM_BYTES * int(src["kMinCtas"]) <= 232_448
    # one thread a (level-0 window, column); whole level-1 windows a tile
    assert tex.TILE // 32 * 4 == tex.THREADS and tex.TILE % 1024 == 0


@pytest.mark.parametrize("S", [1, 4, 33, 1024])
@pytest.mark.parametrize("T", EDGE_T)
@pytest.mark.parametrize("H", [0, 1, 7, 8, 8_192, 65_536])
def test_expand_plan_holds_every_tile(T, S, H):
    plan = tex.expand_plan(S, T, H)
    # task tiles cover [0, T) of every pool once; host tiles [0, H)
    assert plan.tiles * tex.TILE >= T > (plan.tiles - 1) * tex.TILE
    assert plan.host_tiles * tex.HOST_TILE >= H
    assert H == 0 or H > (plan.host_tiles - 1) * tex.HOST_TILE
    assert plan.windows == -(-T // 1024)
    # a tile's level-1 partials land at [tile * TILE / 1024, ...): every
    # window of the pool written by exactly one tile
    owners = [0] * plan.windows
    for tile in range(plan.tiles):
        n = min(tex.TILE, T - tile * tex.TILE)
        for v in range(tex.TILE // 1024):
            if v * 32 < -(-n // 32):
                owners[tile * (tex.TILE // 1024) + v] += 1
    assert owners == [1] * plan.windows
    # the slab: 14 outputs, the partials, the control words; 16-byte
    # aligned, disjoint, in range, the shapes the cycle's stages take
    assert len(plan.offsets) == len(plan.shapes) == len(plan.dtypes) == 16
    end = 0
    for off, shape, dt in zip(plan.offsets, plan.shapes, plan.dtypes):
        assert off % 16 == 0 and off >= end
        end = off + math.prod(shape) * torch.tensor([], dtype=dt) \
            .element_size()
    assert end <= plan.slab_bytes
    assert plan.shapes[14] == (S, plan.windows, 4)
    # the tickets (one a pool, then the one over pools) are the memset
    assert plan.shapes[15] == (plan.ctl_words,) and plan.ctl_words == S + 1
    assert plan.shapes[:14] == ((S, T, 4), (S, T, 4), (S, T), (S, T, 3),
                                (S, T, 4), (S, T), (S, T), (S, T), (S, H),
                                (S, H), (S, H, 4), (S, H, 4), (S, 4), (S, 4))
    # the grid stays an int
    assert S * (plan.tiles + plan.host_tiles) < 2 ** 31


def test_expand_plan_refuses_what_the_kernel_cannot_take():
    for args in ((0, 10, 10), (1025, 10, 10), (1, 0, 10), (1, 10, -1),
                 (1, tex.MAX_WINDOWS * 1024 + 1, 10)):
        with pytest.raises(ValueError):
            tex.expand_plan(*args)


def test_carve_gives_contiguous_views_of_one_slab():
    plan = tex.expand_plan(3, 4_097, 13)
    slab = torch.empty(plan.slab_bytes, dtype=torch.uint8)
    views = tex.carve(slab, plan)
    assert len(views) == 14
    for v, off, shape, dt in zip(views, plan.offsets, plan.shapes,
                                 plan.dtypes):
        assert v.is_contiguous() and v.dtype == dt \
            and tuple(v.shape) == shape
        assert v.data_ptr() == slab.data_ptr() + off


@pytest.mark.parametrize("S,agree", [(32, True), (64, True), (33, False),
                                     (62, False), (65, False)])
def test_group_sum_order_of_the_reference_at_ragged_pool_counts(S, agree):
    """An open fault of the port (ROADMAP section 3): over a ragged pool
    count XLA:CPU's ``jnp.sum`` does not sum in windows of 32, so the
    reference's group base can differ in its last bits from
    ``window32_sum``'s, which K1 and its plain version follow; at
    powers of two the two agree."""
    rng = np.random.default_rng(S)
    same = []
    for _ in range(10):
        base = (rng.standard_normal((S, 4)) * rng.uniform(1, 1e4, (S, 4))) \
            .astype(F32)
        want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=0))(base))
        got = window32_sum(torch.from_numpy(base), dim=0).numpy()
        same.append(np.array_equal(want.view(np.uint32),
                                   got.view(np.uint32)))
    assert all(same) == agree
