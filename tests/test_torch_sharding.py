"""The port's pool mesh and sharded cycle against the JAX package on the
CPU.

``cook_tpu_torch.parallel.mesh`` (``pool_mesh``, ``multislice_pool_mesh``,
``pool_sharding``) and ``parallel/sharded.make_pool_cycle(mesh, ...)``
over 1, 2, 4 and 8 slots of ``cpu`` and the 2 x 4 multislice mesh are
held against the reference's ``make_pool_cycle(pool_mesh())`` on its
8-device CPU mesh (``tests/conftest.py``): every case of
``tests/test_sharding.py`` (the structured-mask case through the port's
dense form, whose mask is the structured one composed), and worlds
whose quota groups span slots, with non-dyadic resources, in the dense
and the compact form.  Every output is equal bit for bit.

The card path's seam (``ops/stages.admit_match``'s ``group_base``) is
held on CPU tensors, stage by stage through the plain versions; the
driver with a two-slot mesh launches the same (job uuid, hostname) pairs
as the one-slot driver and as the reference's ``FusedCycleDriver`` (on
one device and on a two-device mesh), and refuses a ``shard_id``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_driver as td
from cook_tpu.ops.gang import gang_reduce_body as jax_gang_reduce
from cook_tpu.parallel import PoolCycleInputs as JaxDenseInputs
from cook_tpu.parallel import make_pool_cycle as jax_make_pool_cycle
from cook_tpu.parallel.mesh import POOL_AXIS
from cook_tpu.parallel.mesh import multislice_pool_mesh as jax_multislice
from cook_tpu.parallel.mesh import pool_mesh as jax_pool_mesh
from cook_tpu.parallel.sharded import (CompactPoolCycleInputs,
                                       StructuredPoolCycleInputs)
from cook_tpu_torch.ops import pallas_cycle as tpc
from cook_tpu_torch.ops.stages import megacycle_stages
from cook_tpu_torch.parallel import sharded as tsh
from cook_tpu_torch.parallel.mesh import (PoolMesh, ShardAlignmentError,
                                          multislice_pool_mesh, pool_mesh,
                                          pool_sharding)
from test_sharding import build_pool
from test_torch_dense_cycle import dense_world

F32 = np.float32
INF = np.inf
CAP = 32
DENSE = ("order", "num_ranked", "dru", "assign", "match_valid", "queue_ok",
         "accepted", "matched_usage", "total_matched", "n_queue",
         "cand_row", "cand_assign", "cand_qpos")
COMPACT = ("n_queue", "cand_row", "cand_assign", "cand_qpos")


def meshes():
    """The port's meshes the reference's 8-device mesh is held against."""
    return [pool_mesh(n, "cpu") for n in (1, 2, 4, 8)] + [
        multislice_pool_mesh(2, 4, "cpu")]


MESH_IDS = ["1", "2", "4", "8", "2x4"]


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_bits(got, want, what):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
        ok = ~np.isnan(got)
        np.testing.assert_array_equal(got.view(np.uint32)[ok],
                                      want.view(np.uint32)[ok], what)
    else:
        np.testing.assert_array_equal(got, want, what)


def assert_queues(got_rows, want_rows, n_queue):
    for p, n in enumerate(np.asarray(n_queue)):
        np.testing.assert_array_equal(_np(got_rows)[p, :n],
                                      np.asarray(want_rows)[p, :n])


# ----------------------------------------------------------------- meshes
def test_pool_mesh_slots_and_axes():
    m = pool_mesh(8, "cpu")
    assert m.size == 8 and m.axis_names == ("pool",) and m.shape == (8,)
    assert m.devices == [torch.device("cpu")] * 8
    assert pool_mesh(device="cpu").size == 1
    ms = multislice_pool_mesh(2, 4, "cpu")
    assert ms.axis_names == ("dcn", "pool") and ms.shape == (2, 4)
    assert ms.size == 8
    with pytest.raises(ValueError):
        multislice_pool_mesh(2, device="cpu")   # 1 device, 2 slices
    with pytest.raises(ValueError):
        PoolMesh([torch.device("cpu")] * 3, ("dcn", "pool"), (2, 2))


def test_pool_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pool_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        multislice_pool_mesh(2, 2)


def test_pool_sharding_blocks_are_contiguous():
    layout = pool_sharding(pool_mesh(4, "cpu"))
    assert layout.blocks(8) == [slice(0, 2), slice(2, 4), slice(4, 6),
                                slice(6, 8)]
    t = torch.arange(16, dtype=torch.int32).reshape(8, 2)
    parts = layout.shard(t)
    assert [p.tolist() for p in parts] == [t[b].tolist()
                                           for b in layout.blocks(8)]
    u16 = torch.arange(8, dtype=torch.int32).to(torch.uint16).reshape(8, 1)
    assert [p.dtype for p in layout.shard(u16)] == [torch.uint16] * 4
    with pytest.raises(ValueError, match="divide"):
        layout.blocks(6)


# --------------------------------------------- test_sharding.py's cases
_REF = {}


def cached(key, fn):
    """The reference's result for ``key``, computed once for every mesh
    the port runs it on."""
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


def jax_dense(inp, mesh=None, **kw):
    mesh = jax_pool_mesh() if mesh is None else mesh
    assert mesh.size == 8 or mesh.devices.size == 8
    return jax.tree_util.tree_map(np.asarray,
                                  jax_make_pool_cycle(mesh, **kw)(inp))


def stacked_pools(pools):
    def stack(key):
        return jnp.asarray(np.stack(
            [p["arrays"][key] if key in p["arrays"] else p[key]
             for p in pools]))
    return JaxDenseInputs.build(
        usage=stack("usage"), quota=stack("quota"), shares=stack("shares"),
        first_idx=stack("first_idx"), user_rank=stack("user_rank"),
        pending=stack("pending"), valid=stack("valid"),
        job_res=stack("job_res"), cmask=stack("cmask"),
        avail=stack("avail"), capacity=stack("capacity"))


def port_inputs(jax_inp):
    return tsh.dense_inputs_from_numpy(
        {k: np.asarray(getattr(jax_inp, k))
         for k in JaxDenseInputs._fields}, "cpu")


def assert_dense_equal(got, ref):
    for k in DENSE:
        assert_bits(getattr(got, k), getattr(ref, k), k)
    assert_queues(got.queue_rows, ref.queue_rows, ref.n_queue)


@pytest.mark.parametrize("mesh", meshes(), ids=MESH_IDS)
@pytest.mark.parametrize("case", ["eight_pools", "uneven_and_empty"])
def test_sharding_cases_match_the_reference(case, mesh):
    """``TestPoolShardedCycle``'s two worlds (seeds 42 and 7, pool 3
    empty in the second) on the reference's 8-device mesh and the
    port's meshes."""
    rng = np.random.default_rng(42 if case == "eight_pools" else 7)
    pools = [build_pool(rng) if case == "eight_pools"
             else build_pool(rng, n_users=(0 if i == 3 else 3))
             for i in range(8)]
    inp = stacked_pools(pools)
    ref = cached(case, lambda: jax_dense(inp))
    got = tsh.make_pool_cycle(mesh)(port_inputs(inp))
    assert_dense_equal(got, ref)
    assert got.matched_usage.shape == (8, 4)
    if case == "uneven_and_empty":
        assert int(got.num_ranked[3]) == 0
        assert bool((got.assign[3] == -1).all())
    else:
        for pi, pool in enumerate(pools):
            n = int(got.num_ranked[pi])
            np.testing.assert_array_equal(_np(got.assign[pi])[:n],
                                          pool["golden_assign"])


def structured_world(seed=13, E=4):
    """``TestStructuredMask``'s world: gpu hosts and rows, blocked hosts
    and exception rows, with the dense mask they compose to."""
    rng = np.random.default_rng(seed)
    pools = [build_pool(rng) for _ in range(8)]
    T = pools[0]["arrays"]["pending"].shape[0]
    Hb = pools[0]["avail"].shape[0]
    host_gpu = np.zeros((8, Hb), dtype=bool)
    host_blocked = np.zeros((8, Hb), dtype=bool)
    exc_id = np.full((8, T), -1, dtype=np.int32)
    exc_mask = np.zeros((8, E, Hb), dtype=bool)
    dense = np.zeros((8, T, Hb), dtype=bool)
    job_res = np.stack([p["job_res"] for p in pools])
    for pi, pool in enumerate(pools):
        H = pool["num_hosts"]
        host_gpu[pi, :H] = rng.random(H) < 0.3
        gpu_rows = rng.random(T) < 0.2
        job_res[pi, gpu_rows, 2] = 1.0
        host_blocked[pi, H:] = True
        if H > 1:
            host_blocked[pi, int(rng.integers(0, H))] = True
        rows = rng.choice(T, size=E, replace=False)
        exc_id[pi, rows] = np.arange(E, dtype=np.int32)
        exc_mask[pi, :, :H] = rng.random((E, H)) < 0.5
        dense[pi] = np.where(job_res[pi, :, 2:3] > 0, host_gpu[pi][None, :],
                             ~host_gpu[pi][None, :]) \
            & ~host_blocked[pi][None, :]
        for k, r in enumerate(rows):
            dense[pi, r] = exc_mask[pi, k]
    for pi, pool in enumerate(pools):
        pool["job_res"] = job_res[pi]
        pool["cmask"] = dense[pi]
    dense_inp = stacked_pools(pools)
    sinp = StructuredPoolCycleInputs(
        **{k: dense_inp._asdict()[k]
           for k in StructuredPoolCycleInputs._fields
           if k in JaxDenseInputs._fields and k != "cmask"},
        host_gpu=jnp.asarray(host_gpu),
        host_blocked=jnp.asarray(host_blocked),
        exc_id=jnp.asarray(exc_id), exc_mask=jnp.asarray(exc_mask))
    return dense_inp, sinp


@pytest.mark.parametrize("mesh", meshes(), ids=MESH_IDS)
def test_structured_case_through_the_dense_form(mesh):
    """``TestStructuredMask``: the reference's structured cycle equals
    its dense one; the port keeps the structured non-compact form
    refused, so its dense form on the composed mask is held against
    both (``considerable_cap=32``)."""
    dense_inp, sinp = structured_world()
    ref_d = cached("structured/dense",
                   lambda: jax_dense(dense_inp, considerable_cap=32))
    ref_s = cached("structured", lambda: jax_dense(
        sinp, considerable_cap=32, structured=True))
    got = tsh.make_pool_cycle(mesh, considerable_cap=32)(
        port_inputs(dense_inp))
    assert_dense_equal(got, ref_d)
    for k in ("order", "assign", "total_matched"):
        assert_bits(getattr(got, k), getattr(ref_s, k), k)
    assert int(got.total_matched) > 0


def test_multislice_case_matches_the_one_dimensional_mesh():
    """``TestMultisliceMesh``: the 2 x 4 ("dcn", "pool") mesh decides as
    the 1-D one, in both packages."""
    rng = np.random.default_rng(5)
    inp = stacked_pools([build_pool(rng) for _ in range(8)])
    ref1 = jax_dense(inp)
    ref2 = jax_dense(inp, mesh=jax_multislice(2, 4))
    mesh2 = multislice_pool_mesh(2, 4, "cpu")
    assert mesh2.axis_names == ("dcn", "pool")
    got1 = tsh.make_pool_cycle(pool_mesh(8, "cpu"))(port_inputs(inp))
    got2 = tsh.make_pool_cycle(mesh2)(port_inputs(inp))
    for ref in (ref1, ref2):
        assert_dense_equal(got1, ref)
        assert_dense_equal(got2, ref)


# ------------------------------------- quota groups that span the slots
GROUPS = np.array([0, 1, 2, 0, 1, -1, 2, 0], np.int32)


def span_dense_world(seed):
    """Eight dense pools (non-dyadic demands) in three quota groups that
    span slots at every mesh size, with caps that bind part-way."""
    parts = [dense_world(seed * 10 + i, P=2, T=64, H=16,
                         single_user_pool=i == 1) for i in range(4)]
    fields = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    fields["group_id"] = GROUPS.copy()
    fields["num_considerable"] = np.full(8, 12, np.int32)
    fields["group_quota"] = np.tile(
        np.array([[40.5, 1e6, INF, 60]], F32), (8, 1))
    fields["pool_quota"] = np.tile(np.array([[30.5, 1e6, INF, 40]], F32),
                                   (8, 1))
    return fields


def jax_dense_fields(fields, **kw):
    inp = JaxDenseInputs(**{k: jnp.asarray(fields[k])
                            for k in JaxDenseInputs._fields})
    return jax_dense(inp, **kw)


@pytest.mark.parametrize("mesh", meshes(), ids=MESH_IDS)
@pytest.mark.parametrize("seed", [1, 2])
def test_spanning_groups_dense_form(seed, mesh):
    fields = span_dense_world(seed)
    ref = cached(("span_dense", seed),
                 lambda: jax_dense_fields(fields, considerable_cap=16))
    got = tsh.make_pool_cycle(mesh, considerable_cap=16)(
        tsh.dense_inputs_from_numpy(fields, "cpu"))
    assert_dense_equal(got, ref)
    assert int(ref.total_matched) > 0


@pytest.mark.parametrize("mesh", meshes(), ids=MESH_IDS)
def test_spanning_groups_dense_card_route(mesh):
    """The dense form's card route over a mesh (``dense_wire`` through
    ``mesh_megacycle``; the stage chain's plain versions here), equal to
    the reference's dense cycle on every compact output."""
    fields = span_dense_world(3)
    ref = cached(("span_dense", 3),
                 lambda: jax_dense_fields(fields, considerable_cap=16))
    wire = tpc.wire_from_numpy(tpc.dense_wire(fields), "cpu")
    got = tsh.mesh_megacycle(mesh, tsh.shard_wire(mesh, wire),
                             considerable_cap=16)
    for k in COMPACT:
        assert_bits(getattr(got, k), getattr(ref, k), k)
    assert_queues(got.queue_rows, ref.queue_rows, ref.n_queue)
    assert torch.equal(got.cand_gang, got.cand_assign)


def span_compact_world(seed, P=8, T=256, H=48, U=9, E=6, N=1200):
    """Compact-wire fields of ``P`` pools (non-dyadic resources, a
    zero-share user, finite quotas and tokens, exception rows), in the
    quota groups ``GROUPS``, caps binding part-way; and a gang wire on
    pools 0 and 5."""
    rng = np.random.default_rng(seed)
    rows = np.stack([np.sort(rng.choice(N, T, replace=False))
                     for _ in range(P)]).astype(np.int32)
    pend = rng.random((P, T)) < 0.75
    uid = np.sort(rng.integers(0, U, (P, T)), axis=1)
    first = np.zeros((P, T), bool)
    first[:, 0] = True
    first[:, 1:] = uid[:, 1:] != uid[:, :-1]
    valid = np.ones((P, T), bool)
    valid[:, T - 17:] = False
    flags = (pend * 1 + valid * 2 + first * 16
             + (rng.random((P, T)) < 0.95) * 4
             + (rng.random((P, T)) < 0.9) * 8).astype(np.uint8)
    flags[~valid] = 0
    res = np.zeros((N, 4), F32)
    res[:, 0] = rng.random(N) * 3.7 + 0.1
    res[:, 1] = rng.random(N) * 900 + 17.3
    res[:, 2] = (rng.random(N) < 0.1) * 1.0
    res[:, 3] = 1.0
    shares = (rng.random((P, U, 3)) * 50 + 10).astype(F32)
    shares[0, 1] = 0.0
    quota = (rng.random((P, U, 4)) * np.array([30, 9000, 3, 40])
             + np.array([5, 1000, 1, 5])).astype(F32)
    tokens = np.floor(rng.random((P, U)) * 12 + 1).astype(F32)
    tokens[:, 0] = np.inf
    exc_rows = np.full((P, E), -1, np.int32)
    for p in range(0, P, 3):
        exc_rows[p, :3] = rng.choice(T, 3, replace=False)
    avail = (rng.integers(0, 40, (P, H, 4))
             * np.array([0.25, 64, 1, 8])).astype(F32)
    cap = (avail + rng.integers(0, 9, (P, H, 4))
           * np.array([0.5, 128, 1, 8])).astype(F32)
    fields = dict(
        rows=rows, flags=flags, res_base=res,
        disk_base=(rng.random(N) * 30).astype(F32), tokens_u=tokens,
        shares_u=shares, quota_u=quota,
        num_considerable=rng.integers(20, 32, P).astype(np.int32),
        pool_quota=np.tile(np.array([[200, 60000, 20, 300]], F32), (P, 1)),
        group_quota=np.tile(np.array([[290.5, 90000, 30, 400]], F32),
                            (P, 1)),
        group_id=GROUPS[:P].copy(), host_gpu=rng.random((P, H)) < 0.2,
        host_blocked=rng.random((P, H)) < 0.1, exc_rows=exc_rows,
        exc_mask=rng.random((P, E, H)) < 0.5, avail=avail, capacity=cap)
    G = 8
    gid = np.full((P, T), -1, np.int32)
    gsize = np.full((P, G), 2 ** 30, np.int32)
    gattr = np.zeros((P, G), np.int32)
    topo = np.full((P, 2, H), -1, np.int32)
    topo[:, 0] = 0
    topo[:, 1] = rng.integers(0, 4, (P, H))
    for p in (0, 5):
        cand = np.flatnonzero(pend[p] & valid[p])
        for g in range(4):
            m = rng.choice(cand, 4, replace=False)
            gid[p, m] = g
            gsize[p, g] = 3 if g % 2 else 4
            gattr[p, g] = g % 2
    return fields, dict(gang_id=gid, gang_size=gsize, gang_attr=gattr,
                        host_topo=topo)


def jax_compact(fields, gang=None):
    cycle = cached("compact_cycle", lambda: jax_make_pool_cycle(
        jax_pool_mesh(), considerable_cap=CAP, structured=True,
        compact=True))
    r = cycle(CompactPoolCycleInputs(
                                **{k: jnp.asarray(v)
                                   for k, v in fields.items()}))
    out = {k: np.asarray(getattr(r, k))
           for k in COMPACT + ("queue_rows", "matched_usage",
                               "total_matched")}
    if gang is not None:
        gangs, drops = [], []
        for p in range(fields["rows"].shape[0]):
            gid = jnp.where(r.cand_row[p] >= 0,
                            jnp.asarray(gang["gang_id"][p])[
                                jnp.maximum(r.cand_row[p], 0)], -1)
            a, d = jax_gang_reduce(
                r.cand_assign[p], gid, jnp.asarray(gang["gang_size"][p]),
                jnp.asarray(gang["gang_attr"][p]),
                jnp.asarray(gang["host_topo"][p]))
            gangs.append(np.asarray(a))
            drops.append(np.asarray(d).astype(np.int32))
        out.update(cand_gang=np.stack(gangs), cand_dropped=np.stack(drops))
    return out


def group_base_of(fields):
    """The reference's phase-0 group base, as its mesh cycle sums it."""
    valid = (fields["flags"] & 2) != 0
    run = valid & ((fields["flags"] & 1) == 0)
    usage = jnp.asarray(fields["res_base"])[jnp.asarray(fields["rows"])]
    pool_base = jax.jit(jax.vmap(
        lambda u, m: jnp.sum(u * m[:, None], axis=0)[:4]))(
        usage, jnp.asarray(run))
    gid = jnp.asarray(fields["group_id"])
    group_base = jax.jit(jax.vmap(lambda g: jnp.sum(
        pool_base * ((gid == g) & (g >= 0))[:, None], axis=0)))(gid)
    return np.asarray(pool_base), np.asarray(group_base)


@pytest.mark.parametrize("mesh", meshes(), ids=MESH_IDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_spanning_groups_compact_form(seed, mesh):
    """``make_pool_cycle(mesh, compact=True)`` on the compact inputs:
    the compact outputs and the placement total equal the reference's
    8-device cycle bit for bit, and so do the bases its phase 0 sums.
    The gathered matched usage (telemetry: no decision reads it) is
    summed in ``window32_sum``'s order, which the dense form's reference
    takes; the reference's compact cycle fuses that sum into its gather
    and XLA:CPU orders it differently from one world to the next, so it
    is held to a relative tolerance of 1e-5."""
    fields, _gang = span_compact_world(seed)
    ref = cached(("span_compact", seed), lambda: jax_compact(fields))
    got = tsh.make_pool_cycle(mesh, considerable_cap=CAP, compact=True)(
        tsh.compact_inputs_from_numpy(fields, "cpu"))
    for k in COMPACT + ("total_matched",):
        assert_bits(getattr(got, k), ref[k], k)
    np.testing.assert_allclose(_np(got.matched_usage), ref["matched_usage"],
                               rtol=1e-5, atol=0)
    assert_queues(got.queue_rows, ref["queue_rows"], ref["n_queue"])
    pool_base, group_base = group_base_of(fields)
    assert_bits(got.pool_base, pool_base, "pool_base")
    assert_bits(got.group_base, group_base, "group_base")
    assert int(ref["total_matched"]) > 0


@pytest.mark.parametrize("mesh", meshes(), ids=MESH_IDS)
@pytest.mark.parametrize("quantized", [False, True])
def test_mesh_megacycle_on_the_negotiated_wire(quantized, mesh):
    """The driver's wire (quantized rows and hosts, gangs) through
    ``mesh_megacycle``: the seven outputs equal the one-device
    ``megacycle`` and the reference's cycle plus its gang reduction."""
    from test_torch_cycle import wire_of
    fields, gang = span_compact_world(4)
    ref = cached(("span_compact_gang", 4), lambda: jax_compact(fields, gang))
    wire, codecs = wire_of(fields, gang, quantized)
    one = tpc.megacycle(wire, considerable_cap=CAP, device="cpu", **codecs)
    got = tsh.mesh_megacycle(mesh, tsh.shard_wire(mesh, wire),
                             considerable_cap=CAP, **codecs)
    for k in tpc.MegaCycleResult._fields:
        assert torch.equal(getattr(got, k), getattr(one, k)), k
        if k != "queue_rows":
            assert_bits(getattr(got, k), ref[k], k)
    assert (ref["cand_gang"] >= 0).sum() > 0


def test_one_slot_mesh_is_the_device_cycle():
    """``mesh_megacycle`` with one slot is ``megacycle`` on that slot's
    device, and ``shard_wire`` hands it the whole wire as it is."""
    from test_torch_cycle import wire_of
    fields, gang = span_compact_world(0)
    wire, codecs = wire_of(fields, gang, True)
    one = tpc.megacycle(wire, considerable_cap=CAP, device="cpu", **codecs)
    mesh = pool_mesh(1, "cpu")
    parts = tsh.shard_wire(mesh, wire)
    assert all(a is b or torch.equal(a, b) for a, b in zip(parts[0], wire))
    got = tsh.mesh_megacycle(mesh, parts, considerable_cap=CAP, **codecs)
    for k in tpc.MegaCycleResult._fields:
        assert torch.equal(getattr(got, k), getattr(one, k)), k


# ---------------------------------------------------- the step-3 seam
@pytest.mark.parametrize("slots", [2, 4])
def test_seam_stage_by_stage_with_the_gathered_group_base(slots):
    """Each slot's block through the stage chain (plain versions on CPU
    tensors) with the group base gathered over every slot equals the
    whole wire's plain cycle (``pool_cycle`` plus the gang reduction) on
    that block; with the block's own group base it does not."""
    from test_torch_cycle import wire_of
    fields, gang = span_compact_world(2)
    wire, codecs = wire_of(fields, gang, False)
    whole = tpc.megacycle_plain(wire, considerable_cap=CAP, **codecs)
    gathered = tsh.pool_cycle(tsh.compact_inputs_from_numpy(fields, "cpu"),
                              considerable_cap=CAP, device="cpu").group_base
    differs = False
    for b in pool_sharding(pool_mesh(slots, "cpu")).blocks(8):
        block = tpc.MegaCycleWire(*(
            t if k in ("res_base", "disk_base") else t[b]
            for k, t in zip(tpc.MegaCycleWire._fields, wire)))
        staged = megacycle_stages(block, considerable_cap=CAP,
                                  group_base=gathered[b].contiguous(),
                                  **codecs)
        alone = megacycle_stages(block, considerable_cap=CAP, **codecs)
        for k in tpc.MegaCycleResult._fields:
            assert torch.equal(getattr(staged, k), getattr(whole, k)[b]), k
        differs |= any(not torch.equal(getattr(alone, k),
                                       getattr(whole, k)[b])
                       for k in tpc.MegaCycleResult._fields)
    assert differs, "the world's group caps never bind across slots"


def test_group_bases_is_the_one_device_sum():
    fields, _ = span_compact_world(5)
    s = tsh.pool_cycle(tsh.compact_inputs_from_numpy(fields, "cpu"),
                       considerable_cap=CAP, device="cpu")
    gid = torch.from_numpy(fields["group_id"])
    for b in pool_sharding(pool_mesh(4, "cpu")).blocks(8):
        got = tsh.group_bases(s.pool_base, gid, gid[b])
        assert torch.equal(got.view(torch.int32),
                           s.group_base[b].view(torch.int32))


# ------------------------------------------------------------- the driver
def mesh_run(spec, slots, ref_slots, resident=True, quantized=True,
             cycles=3):
    """``td.run_parity`` with the port's driver on a ``slots``-slot CPU
    mesh, the reference's on ``ref_slots`` devices, and the port's
    one-slot driver beside it: the launched pairs, counts and states of
    every cycle equal on all three."""
    from cook_tpu.sched.fused import FusedCycleDriver as RefDriver
    from cook_tpu_torch.sched.fused import FusedCycleDriver
    fallbacks = td._fallbacks()
    ref = td.World(td.REF, spec, 3, resident, quantized)
    one = td.World(td.PORT, spec, 3, resident, quantized)
    port = td.World(td.PORT, spec, 3, resident, quantized)
    if ref_slots > 1:
        s = ref.sched
        s._fused = RefDriver(s.store, s.config, s.matcher, s.plugins,
                             s.rate_limits, mesh=Mesh(
                                 np.array(jax.devices()[:ref_slots]),
                                 (POOL_AXIS,)))
    d = port.driver
    port.driver = FusedCycleDriver(d.store, d.config, d.matcher, d.plugins,
                                   d.rate_limits, device="cpu",
                                   mesh=pool_mesh(slots, "cpu"))
    total = 0
    for c in range(cycles):
        rs = [w.cycle() for w in (ref, one, port)]
        ls = [td.launched(w, r) for w, r in zip((ref, one, port), rs)]
        assert ls[0] == ls[1] == ls[2], f"cycle {c}"
        assert td.counts(rs[0]) == td.counts(rs[1]) == td.counts(rs[2])
        assert td.states(ref) == td.states(port)
        total += sum(len(v) for v in ls[2].values())
        for w in (ref, one, port):
            spec.get("between", lambda w, c: None)(w, c)
            w.churn(5)
    assert total > 0
    assert td._fallbacks() == fallbacks, "the reference degraded"
    return port


@pytest.mark.parametrize("name,ref_slots", [
    ("plain", 1), ("two_pools", 2), ("pool_group_quota", 2),
    ("ragged_three_pools", 1), ("ragged_three_pools", 2), ("rack_gang", 1),
    ("checkpoint", 2)])
def test_two_slot_driver_launches_as_the_reference(name, ref_slots):
    port = mesh_run(td.WORLDS[name], 2, ref_slots)
    assert port.driver.mesh().size == 2


@pytest.mark.parametrize("resident,quantized", [(False, True),
                                                (True, False)])
def test_two_slot_driver_wire_modes(resident, quantized):
    mesh_run(td.WORLDS["ragged_three_pools"], 2, 1, resident, quantized)


def test_four_slot_driver_pads_the_pool_axis():
    """Three pools over four slots: the fourth is a padding pool."""
    port = mesh_run(td.WORLDS["ragged_three_pools"], 4, 1)
    assert len(port.driver._slots) == 4


def test_two_slot_driver_keeps_a_resident_pair_a_slot():
    port = mesh_run(td.WORLDS["two_pools"], 2, 1, cycles=2)
    d = port.driver
    sg = d.stage(port.sched).groups[0]
    assert sg.sync.reason == "delta" or sg.sync.reason == "empty"
    assert [tuple(r.rows_dev.shape) for r in sg.sync.slots] == \
        [(1, sg.T)] * 2
    assert [w.rows is r.rows_dev and w.flags is r.flags_dev
            for w, r in zip(sg.mega["wires"], sg.sync.slots)] == [True] * 2
    assert all(len(slot.packs) == 1 for slot in d._slots)
    d.reset_resident()
    assert all(not slot.packs for slot in d._slots)


def test_shard_id_with_a_two_slot_mesh_is_refused():
    from cook_tpu_torch.sched.fused import FusedCycleDriver
    w = td.World(td.PORT, td.WORLDS["plain"], 3)
    d = w.driver
    drv = FusedCycleDriver(d.store, d.config, d.matcher, d.plugins,
                           d.rate_limits, device="cpu",
                           mesh=pool_mesh(2, "cpu"), shard_id=1)
    with pytest.raises(ShardAlignmentError, match="controller shard 1 was "
                       "given a 2-device pool mesh"):
        drv.mesh()
    with pytest.raises(ShardAlignmentError):
        drv.step(w.sched)
    # one slot is the shard's local device slice
    one = FusedCycleDriver(d.store, d.config, d.matcher, d.plugins,
                           d.rate_limits, device="cpu",
                           mesh=pool_mesh(1, "cpu"), shard_id=1)
    assert one.mesh().size == 1


def test_driver_mesh_must_start_on_its_device():
    from cook_tpu_torch.sched.fused import FusedCycleDriver
    w = td.World(td.PORT, td.WORLDS["plain"], 3)
    d = w.driver
    meta = PoolMesh([torch.device("meta"), torch.device("cpu")], ("pool",))
    with pytest.raises(ValueError, match="first slot"):
        FusedCycleDriver(d.store, d.config, d.matcher, d.plugins,
                         d.rate_limits, device="cpu", mesh=meta)


def test_two_slot_warmup_counts_as_the_reference():
    """The warmup over a two-slot mesh: one pool a slot, no megakernel
    variants (the reference serves those on one device only), the
    delta scatter warmed on each slot's buffers."""
    from cook_tpu.sched.fused import FusedCycleDriver as RefDriver
    from cook_tpu_torch.sched.fused import FusedCycleDriver
    ref = td.World(td.REF, td.WORLDS["plain"], 3)
    port = td.World(td.PORT, td.WORLDS["plain"], 3)
    s = ref.sched
    rd = RefDriver(s.store, s.config, s.matcher, s.plugins, s.rate_limits,
                   mesh=Mesh(np.array(jax.devices()[:2]), (POOL_AXIS,)))
    d = port.driver
    pd = FusedCycleDriver(d.store, d.config, d.matcher, d.plugins,
                          d.rate_limits, device="cpu",
                          mesh=pool_mesh(2, "cpu"))
    for cfg in (rd.config, pd.config):
        cfg.default_matcher.backend = "tpu-megakernel"
    want = rd.warmup(tasks=64, hosts=16)
    assert pd.warmup(tasks=64, hosts=16) == want
    assert len(pd._slots) == 2
