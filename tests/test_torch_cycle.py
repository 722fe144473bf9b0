"""The port's whole fused cycle against the JAX package on the CPU.

``megacycle(wire, device="cpu")`` (the plain cycle: ``pool_cycle`` plus
``gang_reduce_body``) and ``megacycle_stages`` (the K1-K6 stage chain
the card runs, here through each stage's plain version) are held against
``make_pool_cycle(1-device CPU mesh, structured=True, compact=True)``
plus ``cook_tpu.ops.gang.gang_reduce_body`` on the candidates, over wide
and quantized wire, with gangs, exceptions, finite quotas and tokens,
and a zero-share user.  All seven outputs must be equal, the DRUs
bit-identical, and ``pool_base``/``group_base`` bit-identical (XLA:CPU's
reduce order, windows of 32, is reproduced).

Also here: the device contract, the import boundary of the port, and
the ctypes signatures of the CUDA entry points.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cook_tpu.ops import quant as jq
from cook_tpu.ops.gang import gang_reduce_body as jax_gang_reduce
from cook_tpu.parallel.mesh import POOL_AXIS
from cook_tpu.parallel.sharded import CompactPoolCycleInputs, make_pool_cycle
from cook_tpu_torch.ops import cuda_lib, telemetry
from cook_tpu_torch.ops import pallas_cycle as tpc
from cook_tpu_torch.ops.stages import megacycle_stages
from cook_tpu_torch.parallel.sharded import (compact_inputs_from_numpy,
                                             pool_cycle)

F32 = np.float32
REPO = Path(__file__).resolve().parents[1]
CAP = 32
OUTPUTS = ("queue_rows", "n_queue", "cand_row", "cand_assign", "cand_qpos",
           "cand_gang", "cand_dropped")


def world(seed, P=2, T=256, H=48, U=9, E=6, N=400):
    """Compact-wire fields (non-dyadic resources) and a gang wire."""
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
    shares[0, 1] = 0.0                     # zero share: inf and NaN DRUs
    res[rows[0][(uid[0] == 1) & pend[0]][:2], :2] = 0.0
    quota = (rng.random((P, U, 4)) * np.array([30, 9000, 3, 40])
             + np.array([5, 1000, 1, 5])).astype(F32)
    tokens = np.floor(rng.random((P, U)) * 12 + 1).astype(F32)
    tokens[:, 0] = np.inf
    exc_rows = np.full((P, E), -1, np.int32)
    exc_rows[0, :3] = rng.choice(T, 3, replace=False)
    exc_rows[1, 0] = 5
    avail = (rng.integers(0, 40, (P, H, 4))
             * np.array([0.25, 64, 1, 8])).astype(F32)
    cap = (avail + rng.integers(0, 9, (P, H, 4))
           * np.array([0.5, 128, 1, 8])).astype(F32)
    fields = dict(
        rows=rows, flags=flags, res_base=res,
        disk_base=(rng.random(N) * 30).astype(F32), tokens_u=tokens,
        shares_u=shares, quota_u=quota,
        num_considerable=np.array([30, 25], np.int32),
        pool_quota=np.tile(np.array([[200, 60000, 20, 300]], F32), (P, 1)),
        group_quota=np.tile(np.array([[300, 90000, 30, 400]], F32), (P, 1)),
        group_id=np.zeros(P, np.int32), host_gpu=rng.random((P, H)) < 0.2,
        host_blocked=rng.random((P, H)) < 0.1, exc_rows=exc_rows,
        exc_mask=rng.random((P, E, H)) < 0.5, avail=avail, capacity=cap)
    G = 8
    gid = np.full((P, T), -1, np.int32)
    gsize = np.full((P, G), 2 ** 30, np.int32)
    gattr = np.zeros((P, G), np.int32)
    topo = np.full((P, 2, H), -1, np.int32)
    topo[:, 0] = 0
    topo[:, 1] = rng.integers(0, 4, (P, H))
    cand = np.flatnonzero(pend[0] & valid[0])
    for g in range(4):
        m = rng.choice(cand, 4, replace=False)
        gid[0, m] = g
        gsize[0, g] = 3 if g % 2 else 4
        gattr[0, g] = g % 2
    return fields, dict(gang_id=gid, gang_size=gsize, gang_attr=gattr,
                        host_topo=topo)


_FUSED = {}


def jax_cycle(fields, gang, gpu_mode=False, max_over=100):
    key = (gpu_mode, max_over)
    if key not in _FUSED:
        mesh = Mesh(np.array(jax.devices()[:1]), (POOL_AXIS,))
        _FUSED[key] = make_pool_cycle(
            mesh, gpu_mode=gpu_mode, max_over_quota_jobs=max_over,
            considerable_cap=CAP, structured=True, compact=True)
    r = _FUSED[key](CompactPoolCycleInputs(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    gangs, drops = [], []
    for p in range(fields["rows"].shape[0]):
        gid = jnp.where(r.cand_row[p] >= 0, jnp.asarray(gang["gang_id"][p])[
            jnp.maximum(r.cand_row[p], 0)], -1)
        a, d = jax_gang_reduce(
            r.cand_assign[p], gid, jnp.asarray(gang["gang_size"][p]),
            jnp.asarray(gang["gang_attr"][p]),
            jnp.asarray(gang["host_topo"][p]))
        gangs.append(np.asarray(a))
        drops.append(np.asarray(d).astype(np.int32))
    out = {k: np.asarray(getattr(r, k)) for k in OUTPUTS[:5]}
    out.update(cand_gang=np.stack(gangs), cand_dropped=np.stack(drops))
    return out, r


def wire_of(fields, gang, quantized):
    wf = dict(fields, **gang)
    wf["host_bits"] = np.stack([jq.pack_bits(fields["host_gpu"]),
                                jq.pack_bits(fields["host_blocked"])], 1)
    codecs = dict(rows_codec=jq.ROWS_WIDE, avail_scale=0.0, cap_scale=0.0)
    if quantized:
        qr = jq.quantize_rows(fields["rows"])
        qa = jq.quantize_fixed(fields["avail"], "avail")
        qc = jq.quantize_fixed(fields["capacity"], "capacity")
        wf.update(rows=qr.data, avail=qa.data, capacity=qc.data)
        codecs = dict(rows_codec=qr.codec, avail_scale=qa.scale,
                      cap_scale=qc.scale)
        assert qr.codec != jq.ROWS_WIDE and qa.scale != 0.0
    return tpc.wire_from_numpy(wf, "cpu"), codecs


@pytest.mark.parametrize("seed,quantized", [(0, False), (1, True), (2, True),
                                            (3, False)])
def test_megacycle_bit_identical_to_fused_jax(seed, quantized):
    fields, gang = world(seed)
    want, _ = jax_cycle(fields, gang)
    wire, codecs = wire_of(fields, gang, quantized)
    plain = tpc.megacycle(wire, considerable_cap=CAP, device="cpu", **codecs)
    staged = megacycle_stages(wire, considerable_cap=CAP, **codecs)
    for name in OUTPUTS:
        np.testing.assert_array_equal(getattr(plain, name).numpy(),
                                      want[name], err_msg=name)
        np.testing.assert_array_equal(getattr(staged, name).numpy(),
                                      want[name], err_msg=name)
    assert (want["cand_gang"] >= 0).sum() > 0
    assert want["n_queue"].sum() > 0


@pytest.mark.parametrize("gpu_mode,max_over", [(True, 100), (False, 2)])
def test_megacycle_modes_bit_identical(gpu_mode, max_over):
    fields, gang = world(5)
    want, _ = jax_cycle(fields, gang, gpu_mode, max_over)
    wire, codecs = wire_of(fields, gang, False)
    for out in (tpc.megacycle(wire, considerable_cap=CAP, gpu_mode=gpu_mode,
                              max_over_quota_jobs=max_over, device="cpu"),
                megacycle_stages(wire, considerable_cap=CAP,
                                 gpu_mode=gpu_mode,
                                 max_over_quota_jobs=max_over)):
        for name in OUTPUTS:
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          want[name], err_msg=name)


def test_dru_and_bases_bit_identical():
    fields, gang = world(0)
    _, r = jax_cycle(fields, gang)
    got = pool_cycle(compact_inputs_from_numpy(fields, "cpu"),
                     considerable_cap=CAP, device="cpu")
    d_want, d_got = np.asarray(r.dru), got.dru.numpy()
    np.testing.assert_array_equal(np.isnan(d_got), np.isnan(d_want))
    np.testing.assert_array_equal(d_got.view(np.uint32)[~np.isnan(d_got)],
                                  d_want.view(np.uint32)[~np.isnan(d_want)])
    assert np.isnan(d_want).any() and np.isinf(d_want).any()
    # the reference's phase-0 sums, as make_pool_cycle computes them
    valid = (fields["flags"] & 2) != 0
    run = valid & ((fields["flags"] & 1) == 0)
    usage = jnp.asarray(fields["res_base"])[jnp.asarray(fields["rows"])]
    pool_base = jax.jit(jax.vmap(
        lambda u, m: jnp.sum(u * m[:, None], axis=0)[:4]))(
        usage, jnp.asarray(run))
    gid = jnp.asarray(fields["group_id"])
    group_base = jax.jit(jax.vmap(lambda g: jnp.sum(
        pool_base * ((gid == g) & (g >= 0))[:, None], axis=0)))(gid)
    np.testing.assert_array_equal(got.pool_base.numpy().view(np.uint32),
                                  np.asarray(pool_base).view(np.uint32))
    np.testing.assert_array_equal(got.group_base.numpy().view(np.uint32),
                                  np.asarray(group_base).view(np.uint32))


def test_megacycle_defaults_to_cuda():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    fields, gang = world(0)
    wire, _ = wire_of(fields, gang, False)
    with pytest.raises(RuntimeError, match="cuda"):
        tpc.megacycle(wire, considerable_cap=CAP)
    with pytest.raises(RuntimeError, match="cuda"):
        tpc.wire_from_numpy({}, "cuda")


def test_cpu_stage_wrappers_launch_nothing():
    fields, gang = world(1)
    wire, codecs = wire_of(fields, gang, False)
    telemetry.reset_all()
    megacycle_stages(wire, considerable_cap=CAP, **codecs)
    counts = telemetry.snapshot()
    assert set(counts) >= {"expand", "scan", "sort", "admit", "greedy",
                           "gang"}
    assert all(v == 0 for v in counts.values())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_cook_tpu():
    files = sorted((REPO / "cook_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    # the remote backend, the executor, which agents run, and each of the
    # Kubernetes backend's modules included
    assert {REPO / "cook_tpu_torch/cluster/remote.py",
            REPO / "cook_tpu_torch/agent/executor.py",
            REPO / "cook_tpu_torch/state/partition.py",
            REPO / "cook_tpu_torch/parallel/mesh.py",
            REPO / "cook_tpu_torch/parallel/sharded.py",
            REPO / "cook_tpu_torch/sched/shard.py",
            REPO / "cook_tpu_torch/sim/chaos.py",
            REPO / "cook_tpu_torch/sim/federation.py"} <= set(files)
    fed = {f.name for f in (REPO / "cook_tpu/federation").glob("*.py")}
    assert len(fed) == 6
    assert {REPO / "cook_tpu_torch/federation" / n for n in fed} \
        <= set(files)
    k8s = {f.name for f in (REPO / "cook_tpu/cluster/k8s").glob("*.py")}
    assert len(k8s) == 9
    assert {REPO / "cook_tpu_torch/cluster/k8s" / n for n in k8s} \
        <= set(files)
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "cook_tpu"), (f, mod)
        text = f.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|cook_tpu)\b", text,
                             re.M), f


def test_k8s_backend_loads_neither_jax_nor_cook_tpu():
    """Importing every module of the port's Kubernetes backend, the
    partitioned write plane, the pool mesh, the sharded cycle, the shard
    controllers, the federation front door, the cell-outage drill, and
    the node that builds its lease elector, opens partitions and serves
    the federation role, loads no ``jax`` and no ``cook_tpu`` module."""
    code = ("import sys, cook_tpu_torch.cluster.k8s, "
            "cook_tpu_torch.state.partition, cook_tpu_torch.parallel.mesh, "
            "cook_tpu_torch.parallel.sharded, cook_tpu_torch.sched.shard, "
            "cook_tpu_torch.cluster.k8s.real_api, "
            "cook_tpu_torch.cluster.k8s.mock_apiserver, "
            "cook_tpu_torch.cluster.k8s.testcerts, "
            "cook_tpu_torch.cluster.k8s.pod_spec, cook_tpu_torch.daemon, "
            "cook_tpu_torch.federation, cook_tpu_torch.sim.federation\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cook_tpu')))")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == "[]"


def test_ctypes_signatures_match_cuda_sources():
    code = {"*": "p", "long long": "l", "int": "i", "float": "f"}
    found = {}
    for src in (REPO / "cook_tpu_torch/ops/csrc").glob("*.cu"):
        for m in re.finditer(r"COOK_API\s+int\s+(\w+)\s*\(([^)]*)\)",
                             src.read_text()):
            sig = ""
            for prm in m.group(2).split(","):
                prm = " ".join(prm.split())
                sig += next(c for k, c in code.items()
                            if (k == "*" and "*" in prm) or
                            ("*" not in prm and prm.startswith(k)))
            found[m.group(1)] = sig
    assert found == cuda_lib._SIGNATURES


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd in (tmp_path, REPO):
        run = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                             cwd=cwd, capture_output=True, text=True,
                             timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
