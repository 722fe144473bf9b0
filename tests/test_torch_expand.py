"""K1, the wire decode and phase-0 bases (``ops/expand.py``), on the CPU.

The kernel (``csrc/expand.cu``) runs only on the card; here:

* a numpy model of its tile reduction (the tile grid shifted by the
  centred padding, level-1 partials by tile, then the levels the pool's
  last tile sums) against ``window32_sum`` at every T of
  ``chip_smoke.py``'s phase F and both tile sizes, and against
  ``jnp.sum`` at powers of two and at ragged lengths;
* a numpy model of its group-base finisher, and the plain version's
  group base, against the reference's vmapped masked ``jnp.sum`` at
  pool counts from 1 to 1,024;
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
from cook_tpu_torch.parallel.sharded import pool_bases
from cook_tpu_torch.ops.scan import centred_pad, window32_sum

F32 = np.float32
EDGE_T = (1, 31, 32, 33, 1_023, 1_024, 1_025, 2_047, 2_048, 2_049, 4_095,
          4_096, 4_097, 33_000, 131_072, 1_048_576)
RAGGED_T = (33, 100, 1_025, 4_000, 4_097, 33_000, 100_000)
WIN = 32


def _seq(x):
    """Sum along axis 1 in order from +0.0 (f32 at every step)."""
    acc = np.zeros((x.shape[0],) + x.shape[2:], F32)
    for j in range(x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _centred_windows(x):
    """One level of the finisher along axis 0: window w sums the values
    [32 w - pad, 32 w - pad + 32) that exist, pad = centred_pad(n)."""
    n, pad = x.shape[0], centred_pad(x.shape[0])
    return np.stack([
        _seq(x[None, max(w * WIN - pad, 0):w * WIN - pad + WIN])[0]
        for w in range(-(-n // WIN))])


def tile_model(run, tile):
    """K1's pool base: the tile grid starts ``grid_shift(T)`` rows before
    row 0; each tile sums the rows it has in level-0 windows (32 rows)
    and level-1 windows (32 of those), from +0.0 (a row the tile does not
    have counts as +0.0, which changes no sum from +0.0); then the
    finisher's levels over the pool's level-1 partials, centred windows
    of 32 until at most 32 remain, then their sum in order."""
    T = run.shape[0]
    shift = tex.grid_shift(T)
    tiles = -(-(T + shift) // tile)
    rows = np.zeros((tiles * tile,) + run.shape[1:], F32)
    rows[shift:shift + T] = run
    partials = []
    for k in range(tiles):
        own = rows[k * tile:(k + 1) * tile]
        lvl0 = _seq(own.reshape((tile // WIN, WIN) + run.shape[1:]))
        lvl1 = _seq(lvl0.reshape((tile // WIN ** 2, WIN) + run.shape[1:]))
        r1 = min(tile, T + shift - k * tile)
        partials += [lvl1[v] for v in range(tile // WIN ** 2)
                     if v * WIN ** 2 < r1]
    cur = np.stack(partials)
    assert cur.shape[0] == -(-T // (WIN * WIN))
    while cur.shape[0] > WIN:
        cur = _centred_windows(cur)
    return _seq(cur[None])[0]


def group_model(base, gid):
    """K1's group-base finisher: for each pool, the pools of its group
    (gid >= 0) in order up to 32 pools, centred windows of 32 past that,
    the window sums in order."""
    S = base.shape[0]
    pad, nw = centred_pad(S), -(-S // WIN)
    out = np.empty_like(base)
    for s in range(S):
        m = ((gid == gid[s]) & (gid[s] >= 0)).astype(F32)[:, None]
        outer = np.zeros(base.shape[1:], F32)
        for w in range(nw):
            lo, hi = max(w * WIN - pad, 0), min(w * WIN - pad + WIN, S)
            outer = outer + _seq((base[lo:hi] * m[lo:hi])[None])[0]
        out[s] = outer
    return out


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
    assert tex.grid_shift(T) == 0


@pytest.mark.parametrize("T", RAGGED_T)
def test_tile_reduction_equals_jnp_sum_at_ragged_lengths(T):
    """Lengths where one, two or three levels pad (33,000: the grid
    shifted by 12 + 32 x 12 rows, and 33 partials at level 2)."""
    run = _run(np.random.default_rng(T + 7), T)
    want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=0))(run))
    _bits_equal(tile_model(run, tex.TILE), want)
    _bits_equal(tile_model(run, 4_096), want)


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
@pytest.mark.parametrize("S,T", [(33, 4_097), (4, 4_096), (65, 33_000)])
def test_expand_plain_equals_jax_decode_and_bases(codec, S, T):
    """Every output against the JAX package's decode (``expand_compact``
    and the quant decodes); the bases bit for bit against its phase-0
    ``jnp.sum`` (the vmapped masked sums of ``cook_tpu/parallel/
    sharded.py``), against the tile model and the group finisher's model
    (the kernel's order), at powers of two and at ragged S and T."""
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
    _bits_equal(got.group_base.numpy(), group_model(model, gid))
    _bits_equal(got.pool_base.numpy(), pool_jax)
    _bits_equal(got.group_base.numpy(), group_jax)


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
    # the grid shift: the C entry computes it as grid_shift does
    text = (Path(tex.__file__).parent / "csrc" / "expand.cu").read_text()
    assert "centred_pad(T) + kWin * centred_pad((T + kWin - 1) / kWin)" \
        in text


@pytest.mark.parametrize("S", [1, 4, 33, 1024])
@pytest.mark.parametrize("T", EDGE_T)
@pytest.mark.parametrize("H", [0, 1, 7, 8, 8_192, 65_536])
def test_expand_plan_holds_every_tile(T, S, H):
    plan = tex.expand_plan(S, T, H)
    # task tiles, shifted, cover [0, T) of every pool once (the first
    # tile is short, none is empty); host tiles [0, H)
    shift = plan.shift
    assert shift == tex.grid_shift(T) < 1024
    assert plan.tiles * tex.TILE >= T + shift > (plan.tiles - 1) * tex.TILE
    assert plan.host_tiles * tex.HOST_TILE >= H
    assert H == 0 or H > (plan.host_tiles - 1) * tex.HOST_TILE
    assert plan.windows == -(-T // 1024) == -(-(T + shift) // 1024)
    # a tile's level-1 partials land at [tile * TILE / 1024, ...): every
    # window of the pool written by exactly one tile
    owners = [0] * plan.windows
    for tile in range(plan.tiles):
        r1 = min(tex.TILE, T + shift - tile * tex.TILE)
        for v in range(tex.TILE // 1024):
            if v * 1024 < r1:
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


@pytest.mark.parametrize("S", [1, 4, 31, 32, 33, 48, 62, 63, 64, 65, 100,
                               129, 1000, 1024])
def test_group_sum_order_of_the_reference_at_ragged_pool_counts(S):
    """The group base over S pools in the reference's own form (the
    vmapped masked ``jnp.sum`` of ``cook_tpu/parallel/sharded.py``'s
    phase 0) against the port's plain ``pool_bases`` and the model of
    K1's finisher, bit for bit: XLA:CPU pads a ragged pool count to
    windows of 32 with the zeros centred, and so do both."""
    rng = np.random.default_rng(S)
    gid = rng.integers(-1, max(2, S // 3), S).astype(np.int32)
    gid[: min(S, 3)] = [0, 0, -1][: min(S, 3)]
    for _ in range(3):
        base = (rng.standard_normal((S, 4)) * rng.uniform(1, 1e4, (S, 4))) \
            .astype(F32)
        want = np.asarray(jax.jit(jax.vmap(lambda g: jnp.sum(
            jnp.asarray(base) * ((jnp.asarray(gid) == g) & (g >= 0))[:, None],
            axis=0)))(jnp.asarray(gid)))
        # one task row a pool: the pool base is the row itself
        _, got = pool_bases(torch.from_numpy(base)[:, None],
                            torch.zeros((S, 1), dtype=torch.bool),
                            torch.ones((S, 1), dtype=torch.bool),
                            torch.from_numpy(gid))
        _bits_equal(got.numpy(), want)
        _bits_equal(group_model(base, gid), want)
    # and the axis sum the group sums are made of
    want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=0))(base))
    _bits_equal(window32_sum(torch.from_numpy(base), dim=0).numpy(), want)
