"""cook_tpu_torch scan primitives against the JAX package on the CPU.

The port must reproduce the JAX package's float summation orders bit
for bit: ``lax.associative_scan``'s odd/even recursion
(``segmented_cumsum``), ``jnp.cumsum``'s blocked-16 order on XLA:CPU
(``prefix_sum_xla_cpu``) and the order of ``jnp.sum``
(``window32_sum``: windows of 32 after centred zero padding, at every
length).  ``lane_tree_sum`` (the order of a sum fused into a loop
fusion) is held here to a numpy model of its order, and to the
reference's fused sum in ``test_torch_sharding.py``.  Inputs are
non-dyadic floats, so an order mistake changes bits.  Exact equality (tolerance 0) throughout.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import scan as jscan
from cook_tpu_torch.ops import scan as tscan

F32 = np.float32


def _bits(a):
    return np.asarray(a, dtype=F32).view(np.uint32)


def _vals(rng, shape):
    return (rng.random(shape) * 7.3 + 0.01).astype(F32)


@pytest.mark.parametrize("T", [1, 2, 3, 7, 64, 100, 513, 5000])
def test_segmented_cumsum_matches_associative_scan(T):
    rng = np.random.default_rng(T)
    x = _vals(rng, (T, 4))
    f = rng.random(T) < 0.05
    f[0] = True
    want = jax.jit(jscan.segmented_cumsum)(jnp.asarray(x), jnp.asarray(f))
    got = tscan.segmented_cumsum(torch.from_numpy(x), torch.from_numpy(f))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_segmented_cumsum_by_first_idx_batched_dim():
    rng = np.random.default_rng(1)
    x = _vals(rng, (3, 300, 4))
    is_first = rng.random((3, 300)) < 0.1
    is_first[:, 0] = True
    _, first_idx = jscan.user_segments_from_flags(jnp.asarray(is_first), 1)
    want = jax.jit(jax.vmap(jscan.segmented_cumsum_by_first_idx))(
        jnp.asarray(x), first_idx)
    got = tscan.segmented_cumsum_by_first_idx(
        torch.from_numpy(x), torch.from_numpy(np.array(first_idx)), dim=1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("T", [5, 16, 17, 100, 256, 5000])
def test_prefix_sum_matches_jnp_cumsum(T):
    # T=5000: blocks of 16 -> 313 totals -> 20 -> 2, three recursion levels
    rng = np.random.default_rng(T)
    x = _vals(rng, (2, T, 4))
    want = jax.jit(jax.vmap(lambda a: jnp.cumsum(a, axis=0)))(jnp.asarray(x))
    got = tscan.prefix_sum_xla_cpu(torch.from_numpy(x), dim=1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


SUM_N = sorted(set(range(1, 131)) | {512, 1_000, 4_000, 4_096, 4_097,
                                      50_000, 65_536})


@pytest.mark.parametrize("T", SUM_N)
def test_window32_sum_matches_jnp_sum(T):
    """Every length, ragged ones included: an axis sum (vmapped over a
    batch, as the reference's pool bases are) and a 1-D sum, on values
    of both signs and many magnitudes, so that a window placed one row
    off changes bits."""
    rng = np.random.default_rng(T)
    x = (rng.standard_normal((3, T, 4))
         * rng.uniform(0.01, 900.0, (3, T, 4))).astype(F32)
    want = jax.jit(jax.vmap(lambda a: jnp.sum(a, axis=0)))(jnp.asarray(x))
    got = tscan.window32_sum(torch.from_numpy(x), dim=1)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    flat = x[0, :, 1].copy()
    want1 = jax.jit(jnp.sum)(jnp.asarray(flat))
    got1 = tscan.window32_sum(torch.from_numpy(flat), dim=0)
    np.testing.assert_array_equal(_bits(got1), _bits(want1))


@pytest.mark.parametrize("lanes", [8, 16, 32])
@pytest.mark.parametrize("n", [1, 7, 32, 33, 100])
def test_lane_tree_sum_order(n, lanes):
    """Lane ``j % lanes`` takes value ``j`` in order from +0.0, then the
    lanes are halved as a tree, the first half plus the second; at 32
    values 16 and 32 lanes are one order."""
    rng = np.random.default_rng(n * 64 + lanes)
    x = (rng.standard_normal((n, 4))
         * rng.uniform(0.01, 900.0, (n, 4))).astype(F32)
    acc = np.zeros((lanes, 4), F32)
    for j in range(n):
        acc[j % lanes] = (acc[j % lanes] + x[j]).astype(F32)
    while acc.shape[0] > 1:
        acc = (acc[:acc.shape[0] // 2] + acc[acc.shape[0] // 2:]).astype(F32)
    got = tscan.lane_tree_sum(torch.from_numpy(x).T, dim=1, lanes=lanes)
    np.testing.assert_array_equal(_bits(got), _bits(acc[0]))
    if n == 32 and lanes in (16, 32):
        other = tscan.lane_tree_sum(torch.from_numpy(x), lanes=48 - lanes)
        np.testing.assert_array_equal(_bits(other), _bits(acc[0]))


def test_centred_pad():
    assert [tscan.centred_pad(n) for n in (1, 32, 33, 62, 63, 64, 65, 100,
                                           4_000, 4_097, 65_536)] == \
        [0, 0, 15, 1, 0, 0, 15, 14, 0, 15, 0]


def test_user_segments_from_flags():
    rng = np.random.default_rng(2)
    is_first = rng.random((2, 200)) < 0.1
    is_first[1, 0] = False   # rows before the first start
    ur, fi = jscan.user_segments_from_flags(jnp.asarray(is_first), axis=1)
    tur, tfi = tscan.user_segments_from_flags(torch.from_numpy(is_first),
                                              dim=1)
    np.testing.assert_array_equal(tur.numpy(), np.asarray(ur))
    np.testing.assert_array_equal(tfi.numpy(), np.asarray(fi))


def test_lexsort_matches_jnp_lexsort_with_nan_zero_inf():
    rng = np.random.default_rng(3)
    key2 = rng.integers(0, 5, (3, 64))
    key1 = rng.random((3, 64)).astype(F32)
    key1[0, 3] = np.nan
    key1[0, 9] = -np.nan
    key1[1, 4] = np.inf
    key1[1, 5] = -np.inf
    key1[2, :6] = 0.0
    key1[2, 6] = -0.0
    want = np.stack([np.asarray(jnp.lexsort(
        (jnp.arange(64), jnp.asarray(key2[i]), jnp.asarray(key1[i]))))
        for i in range(3)])
    got = tscan.lexsort((torch.from_numpy(key2), torch.from_numpy(key1)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("op,reverse", [("sum", False), ("sum", True),
                                        ("min", True)])
def test_int_scan_stage_plain(op, reverse):
    """K2's integer scan on CPU tensors takes its plain version."""
    rng = np.random.default_rng(4)
    x = rng.integers(-50, 50, (2, 300)).astype(np.int32)
    got = tscan.int_scan(torch.from_numpy(x), op=op, reverse=reverse,
                         offset=-1).numpy()
    v = x[:, ::-1] if reverse else x
    v = np.cumsum(v, 1) if op == "sum" else np.minimum.accumulate(v, 1)
    want = (v[:, ::-1] if reverse else v) - 1
    np.testing.assert_array_equal(got, want)


def test_seg_scan_stage_plain_masks_rows():
    """K2's segmented scan keeps rows whose flags hold ``mon`` and not
    ``moff`` (usage * (valid & ~pending))."""
    rng = np.random.default_rng(5)
    x = _vals(rng, (2, 128, 4))
    start = (rng.random((2, 128)) < 0.1).astype(np.uint8)
    start[:, 0] = 1
    flags = rng.integers(0, 32, (2, 128)).astype(np.uint8)
    keep = ((flags & 2) != 0) & ((flags & 1) == 0)
    want = jax.jit(jax.vmap(jscan.segmented_cumsum))(
        jnp.asarray(x * keep[..., None]), jnp.asarray(start != 0))
    got = tscan.seg_scan(torch.from_numpy(x), torch.from_numpy(start),
                         torch.from_numpy(flags), 2, 1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------------------------- K2's tiled orders (CPU)
# Numpy models of the order csrc/scan_tile.cuh computes a scan in, tile
# by tile, held bit for bit against the JAX package's functions: the
# order the kernel implements, checked before any chip run.

def _tree_tiled(x, f, L):
    """seg_tile's order: each tile of 2^L builds its levels in place and
    publishes its level-L entry (full tiles only); a tile folds the
    blocks above it, built in tree order from the published entries of
    tiles 0..j-1 (and its own for its last element), then its own levels
    L-1..0, largest first."""
    n, C = x.shape
    tile = 1 << L
    tiles = -(-n // tile)
    levels, pub_v, pub_f = [], [], []
    for j in range(tiles):
        lv, lf = [x[j * tile:(j + 1) * tile]], [f[j * tile:(j + 1) * tile]]
        for k in range(1, L + 1):
            nk = len(lv[0]) >> k
            a, b = lv[-1][0:2 * nk:2], lv[-1][1:2 * nk:2]
            af, bf = lf[-1][0:2 * nk:2], lf[-1][1:2 * nk:2]
            lv.append(np.where(bf[:, None], b, a + b))
            lf.append(af | bf)
        levels.append((lv, lf))
        if len(lv[0]) == tile:
            pub_v.append(lv[L][0])
            pub_f.append(lf[L][0])
    out = np.empty_like(x)
    for j, (lv, lf) in enumerate(levels):
        tn = len(lv[0])
        full = tn == tile
        m = j + int(full)
        tv = [np.array(pub_v[:m], F32).reshape(m, C)]
        tf = [np.array(pub_f[:m], bool)]
        while m >> len(tv):
            nq = m >> len(tv)
            a, b = tv[-1][0:2 * nq:2], tv[-1][1:2 * nq:2]
            af, bf = tf[-1][0:2 * nq:2], tf[-1][1:2 * nq:2]
            tv.append(np.where(bf[:, None], b, a + b))
            tf.append(af | bf)

        def fold(mm):
            acc = None
            for q in range(len(tv) - 1, -1, -1):
                if (mm >> q) & 1:
                    e = (mm >> q) - 1
                    acc = tv[q][e] if acc is None or tf[q][e] \
                        else acc + tv[q][e]
            return acc

        hx = fold(j)
        mm = np.arange(1, tn + 1)
        acc = np.zeros((tn, C), F32) if hx is None else np.tile(hx, (tn, 1))
        first = np.full(tn, hx is None)
        body = mm < tile
        for k in range(L - 1, -1, -1):
            sel = body & (((mm >> k) & 1) == 1)
            e = (mm[sel] >> k) - 1
            bv, bf = lv[k][e], lf[k][e]
            acc[sel] = np.where((first[sel] | bf)[:, None], bv, acc[sel] + bv)
            first[sel] = False
        if full:
            acc[-1] = fold(j + 1)
        out[j * tile:j * tile + tn] = acc
    return out


def _local16(a):
    """Sequential sums inside each block of 16 (the last may be short)."""
    out = a.copy()
    for i in range(1, len(a)):
        if i % 16:
            out[i] = out[i - 1] + a[i]
    return out


def _blocked_at(tot, i):
    """blocked_at of scan_tile.cuh: out(i) of the blocked-16 scan of the
    tile totals, from the sums of their complete blocks of 16."""
    lv = [tot]
    while len(lv[-1]) >= 16:
        a = lv[-1][:len(lv[-1]) // 16 * 16].reshape(-1, 16, tot.shape[1])
        s = a[:, 0].copy()
        for e in range(1, 16):
            s = s + a[:, e]
        lv.append(s)
    idx = [i]
    while idx[-1] >= 16:
        idx.append(idx[-1] // 16 - 1)
    acc = _local16(lv[len(idx) - 1][:idx[-1] // 16 * 16 + 16])[idx[-1]]
    for k in range(len(idx) - 2, -1, -1):
        acc = acc + _local16(lv[k][idx[k] // 16 * 16:idx[k] + 1])[-1]
    return acc


def _blocked_tiled(x, D):
    """blk_tile's order at tiles of 16^D: levels 0..D-1 of sequential
    sums inside the tile; tile j-1 publishes its level-(D-1) total and,
    at every level k >= 1, the locals at positions 15 and 14 of its last
    block; tile j starts each level's first block from the entry before
    the tile, E_k = out_k(j 16^(D-k) - 1), chained through F_k = out_k(
    j 16^(D-k) - 2) down from out_D (the blocked scan of the totals)."""
    n, C = x.shape
    tile = 16 ** D
    tiles = -(-n // tile)
    locs = []
    for j in range(tiles):
        loc = [_local16(x[j * tile:(j + 1) * tile])]
        for _ in range(1, D):
            prev = loc[-1]
            last = np.minimum(np.arange(0, len(prev), 16) + 15, len(prev) - 1)
            loc.append(_local16(prev[last]))
        locs.append(loc)
    tot = np.array([locs[j][D - 1][15] for j in range(tiles - 1)]
                   + [np.zeros(C, F32)], F32)
    out = np.empty_like(x)
    for j, loc in enumerate(locs):
        E = {}
        if j >= 1:
            pl = locs[j - 1]
            E[D] = _blocked_at(tot[:j], j - 1)
            F = _blocked_at(tot[:j], j - 2) if j >= 2 else None
            for k in range(D - 1, 0, -1):
                E[k] = pl[k][-1] if F is None else F + pl[k][-1]
                F = pl[k][-2] if F is None else F + pl[k][-2]
        o = loc[D - 1] + E[D] if j >= 1 else loc[D - 1]
        for k in range(D - 2, -1, -1):
            lo = loc[k].copy()
            q = np.arange(len(lo)) // 16
            lo[q >= 1] = o[q[q >= 1] - 1] + lo[q >= 1]
            if j >= 1:
                lo[q == 0] = E[k + 1] + lo[q == 0]
            o = lo
        out[j * tile:j * tile + len(o)] = o
    return out


_TILED_N = [1, 2, 3, 15, 16, 17, 4095, 4096, 4097, 9000]
_STARTS = ["tile", "after_tile", "every", "first"]


def _starts(n, tile, kind):
    t = np.arange(n)
    return {"tile": t % tile == 0, "after_tile": t % tile == 1,
            "every": np.ones(n, bool), "first": t == 0}[kind]


@pytest.mark.parametrize("start", _STARTS)
@pytest.mark.parametrize("n", _TILED_N)
@pytest.mark.parametrize("L", [1, 2, 4, 12])
def test_tiled_tree_order_is_associative_scan(L, n, start):
    rng = np.random.default_rng(n * 7 + L)
    x = _vals(rng, (n, 4))
    x[rng.random(n) < 0.05] *= F32(-1.0)
    f = _starts(n, 1 << L, start)
    want = jax.jit(jscan.segmented_cumsum)(jnp.asarray(x), jnp.asarray(f))
    np.testing.assert_array_equal(_bits(_tree_tiled(x, f, L)), _bits(want))


@pytest.mark.parametrize("n", _TILED_N)
@pytest.mark.parametrize("D", [1, 2, 3])
def test_tiled_blocked_order_is_jnp_cumsum(D, n):
    rng = np.random.default_rng(n * 3 + D)
    x = _vals(rng, (n, 4))
    want = jax.jit(lambda a: jnp.cumsum(a, axis=0))(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(_blocked_tiled(x, D)), _bits(want))


def _scan_tile_source():
    return (Path(tscan.__file__).parent / "csrc"
            / "scan_tile.cuh").read_text()


def _scan_tile_constants():
    """The geometry csrc/scan_tile.cuh is compiled for, from its source."""
    text = _scan_tile_source()
    consts = {}
    for body in re.findall(r"constexpr\s+int\s+(k[^;]+);", text):
        for part in body.split(","):
            name, expr = (p.strip() for p in part.split("="))
            consts[name] = eval(re.sub(r"k\w+",
                                       lambda m: str(consts[m.group(0)]),
                                       expr))
    return consts


@pytest.mark.parametrize("C,kind", [(1, "seg"), (4, "seg"), (1, "blocked"),
                                    (4, "blocked"), (1, "int"), (2, "int")])
@pytest.mark.parametrize("n", [1, 17, 4095, 4096, 4097, 131072, 1048576,
                               1 << 22])
@pytest.mark.parametrize("S", [1, 4])
def test_scan_plan_holds_every_tile(S, n, C, kind):
    plan = tscan.scan_plan(S, n, C, kind)
    k = _scan_tile_constants()
    # the geometry scan_tile.cuh checks (geo_ok)
    assert plan.threads == k["kScanThreads"]
    assert plan.tile == 1 << k["kTileLog"] == k["kTile"]
    assert plan.tiles * plan.tile >= n > (plan.tiles - 1) * plan.tile
    assert plan.tiles <= k["kMaxTiles"] == 1 << k["kMaxTileLog"]
    assert tscan.KINDS.index(kind) == {"seg": k["kKindSeg"], "blocked":
                                       k["kKindBlocked"],
                                       "int": k["kKindInt"]}[kind]
    # one memset of the control words and one launch a call
    launcher = _scan_tile_source().split("int launch_tiled(")[1] \
        .split("\n}\n")[0]
    assert launcher.count("cudaMemsetAsync(") == 1
    assert launcher.count("<<<") == 1
    # the control words as the kernels index them: the ticket at ctl[0],
    # the status word of (s, j) at ctl[1 + s * tiles + j], its C columns
    # of published values from value_off + (s * tiles + j) * values; the
    # one memset covers the ticket and every status word, and the values
    # lie past it, inside ctl_words
    last_status = 1 + (S - 1) * plan.tiles + plan.tiles - 1
    assert plan.status_off == 1 and last_status < plan.zero_words
    assert plan.value_off >= plan.zero_words
    per = 3 if kind == "blocked" else 1
    assert plan.values == per * C
    last_value = plan.value_off + (S * plan.tiles - 1) * plan.values \
        + per * C - 1
    assert last_value < plan.ctl_words
    # shared memory as the kernels index it (4-byte words, u8 flags)
    tile, tiles = plan.tile, plan.tiles
    if kind == "seg":
        lvl_off = 2 * (tile - (tile >> k["kTileLog"]))    # the top level
        assert lvl_off < k["kLvn"]
        # tile tree over m <= tiles entries: sum of m >> q
        tree = sum(tiles >> q for q in range(tiles.bit_length()))
        assert tree <= 2 * tiles
        need = C * (k["kLvn"] + 2 * tiles) * 4 + k["kLvn"] + 2 * tiles
    elif kind == "blocked":
        pad = lambda e: e + (e >> 4)                      # noqa: E731
        assert pad(tile - 1) < k["kP0"] and pad(tile // 16 - 1) < k["kP1"]
        assert tile // 256 <= k["kP2"] and tile == 16 ** 3
        j = tiles - 1                                     # totals' levels
        lv, ln = 0, j
        while ln:
            lv, ln = lv + ln, ln // 16
        assert lv <= 2 * tiles
        need = C * (k["kP0"] + k["kP1"] + k["kP2"] + 2 * tiles) * 4
    else:
        assert k["kItems"] * plan.threads == tile
        need = 0
    assert plan.smem_bytes == need <= 232_448


def test_scan_plan_refuses_what_the_kernel_cannot_take():
    for args in ((1, 0, 1, "seg"), (1, (1 << 22) + 1, 1, "seg"),
                 (1, 10, 5, "seg"), (1, 10, 3, "int"), (0, 10, 1, "int"),
                 (1, 10, 1, "tree")):
        with pytest.raises(ValueError):
            tscan.scan_plan(*args)
