#!/usr/bin/env python3
"""Chip smoke test of cook_tpu_torch on one NVIDIA card.

Drives two paths of the port through their CUDA kernels.

The fused scheduling cycle (``ops/pallas_cycle.megacycle``, stage kernels
K1-K6) at the production design point: P = 4 pools of 100,000 live task
rows (T bucket 131,072) from 200 users, 5,000 hosts (H bucket 8,192),
max_jobs_considered 1,000 (C = 1,024), 64 exception rows a pool, finite
user / pool / group quotas, and one pool with 16 gangs of 8 over a
4-value topology attribute.

The split match path (``sched/matcher.dispatch``: greedy through K5,
auction, waterfill) and the top-K preference kernels
(``ops/pallas_match``) at the JAX package's bench worlds: 100,000 jobs x
50,000 hosts with 256 exception rows, and 1,000 or 10,000 jobs x 50,000
hosts.

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernels from ``cook_tpu_torch/ops/csrc`` (nvcc);
  3. phase A: replays every kernel launch of one cycle against its plain
     PyTorch version on the same inputs (integers equal, floats equal
     bit for bit, NaN where NaN) and times kernel, plain version, and a
     library call where one computes the same function;
  4. phase C: two cycles of each of three small worlds for the kernel
     paths the design point does not take (i8 and i16 rows, the
     over-quota limit, gpu mode, K5 with avail in device memory), kernels
     against the plain cycle;
  5. phase B: 5 cycles, each staged through ``stage_mega_wire``
     (quantized wire), run by the kernels and by the plain cycle
     (``megacycle_plain``) on the card; all seven outputs must agree;
     the kept placements are applied before the next cycle; the launch
     counts are zeroed before and read after these cycles;
  6. phase D: the two top-K kernels (structured at 100,000 x 50,000,
     E = 256; dense at 10,000 x 50,000), counted, then held against
     their plain versions (fit bit for bit, host where fit > -inf) and
     timed beside ``torch.topk`` of the materialized score, the dense
     one also with its hosts left unsplit; then two check worlds for the
     paths those leave idle (gpu jobs and hosts, invalid jobs, k = 8
     and k = 4, many host splits), held the same way;
  7. phase E: ``dispatch`` on the card for the three full-width worlds
     (auto: greedy at 1,000 jobs; waterfill at 10,000; auction + tail at
     10,000 with tight packing), counted and recorded; every recorded
     launch (K2 scans, K5) replayed against its plain version bit for
     bit; placements checked against oversubscription and the mask; the
     K5 route held against the plain greedy on the card; and every
     backend on a reduced split world, on the card and on the CPU,
     equal bit for bit;
  8. prints the card line again, the ``{"kernels": [...]}`` line and
     last ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (needs one
CUDA card and nvcc; builds into ./build/cuda, with the ptxas report in
build/cuda/ptxas.log).  Any failure raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

SEED = 20261016
P, LIVE, USERS, HOSTS, MAX_CONSIDERED, E = 4, 100_000, 200, 5_000, 1_000, 64
GANGS, GANG_SIZE, RACKS = 16, 8, 4
CYCLES = 5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores

SOURCES = {"expand": "expand.cu", "scan": "scan.cu", "sort": "sort.cu",
           "admit": "admit.cu", "greedy": "greedy.cu", "gang": "gang.cu"}
STAGES = {
    "expand": "K1: wire decode, gathers, phase-0 pool/group bases",
    "scan": "K2: segmented (associative_scan order), blocked-16 and "
            "integer prefixes",
    "sort": "K3: stable LSD radix sorts (rank order, user-major)",
    "admit": "K4: over-quota limit, DRU, admission, compaction, compact "
             "outputs",
    "greedy": "K5: greedy assignment, one CTA per pool",
    "gang": "K6: gang_min-gated segment reduction",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ world
def build_world(rng, live=LIVE, users=USERS, hosts=HOSTS, gangs=GANGS,
                e=E):
    """The seeded world: host arrays of every pool plus the base mirror."""
    from cook_tpu_torch.ops.delta import (FLAG_ENQUEUE_OK, FLAG_LAUNCH_OK,
                                          FLAG_PENDING, FLAG_USER_FIRST,
                                          FLAG_VALID)
    from cook_tpu_torch.ops.gang import build_gang_wire
    from cook_tpu_torch.ops.padding import bucket
    T, H = bucket(live), bucket(hosts)
    N = P * live
    res = np.zeros((N, 4), np.float32)
    res[:, 0] = np.round(rng.uniform(0.1, 4.0, N), 1)
    res[:, 1] = rng.integers(128, 8192, N)
    res[:, 2] = rng.random(N) < 0.05
    res[:, 3] = 1.0
    disk = rng.integers(0, 2048, N).astype(np.float32)
    rows = np.zeros((P, T), np.int32)
    flags = np.zeros((P, T), np.uint8)
    weights = 1.0 / np.arange(1, users + 1) ** 0.8
    weights /= weights.sum()
    for p in range(P):
        user = rng.choice(users, live, p=weights)
        pend = rng.random(live) < 0.8
        if p == 0:       # the gang user: pending work only
            pend[user == 0] = True
        key = np.lexsort((rng.random(live), pend, user))
        user, pend = user[key], pend[key]
        rows[p, :live] = p * live + key
        first = np.ones(live, bool)
        first[1:] = user[1:] != user[:-1]
        flags[p, :live] = (pend * FLAG_PENDING + FLAG_VALID
                           + first * FLAG_USER_FIRST
                           + (rng.random(live) < 0.99) * FLAG_ENQUEUE_OK
                           + (rng.random(live) < 0.98) * FLAG_LAUNCH_OK)
        if p == 3:       # zero-resource tasks of a zero-share user: NaN DRU
            seg = np.flatnonzero(user == 5)[:8]
            res[rows[p, seg], :2] = 0.0
    shares = np.stack([rng.uniform(10, 200, (P, users)),
                       rng.uniform(10, 200, (P, users)) * 1024.0,
                       rng.uniform(1, 8, (P, users))], -1).astype(np.float32)
    shares[3, 5] = 0.0
    # user quotas: most users keep room for five cycles, some bind early
    quota = np.stack([rng.uniform(100, 3000, (P, users)),
                      rng.uniform(100, 3000, (P, users)) * 4096.0,
                      rng.uniform(2, 80, (P, users)),
                      rng.uniform(200, 6000, (P, users))],
                     -1).astype(np.float32)
    tokens = rng.integers(5, 400, (P, users)).astype(np.float32)
    tokens[:, ::7] = np.inf
    cap = np.zeros((P, H, 4), np.float32)
    cap[:, :hosts, 0] = rng.choice([32, 48, 64, 96], (P, hosts))
    cap[:, :hosts, 1] = rng.choice([131072, 262144, 393216], (P, hosts))
    gpu_host = np.zeros((P, H), bool)
    gpu_host[:, :hosts] = rng.random((P, hosts)) < 0.1
    cap[..., 2] = gpu_host * 8.0
    cap[:, :hosts, 3] = 1048576.0
    frac = rng.uniform(0.05, 0.6, (P, H, 4))
    avail = np.stack([np.floor(cap[..., 0] * frac[..., 0] * 2) / 2,
                      np.floor(cap[..., 1] * frac[..., 1] / 1024) * 1024,
                      np.floor(cap[..., 2] * frac[..., 2] + 0.5),
                      np.floor(cap[..., 3] * frac[..., 3] / 1024) * 1024],
                     -1).astype(np.float32)
    blocked = np.ones((P, H), bool)
    blocked[:, :hosts] = rng.random((P, hosts)) < 0.05
    exc_rows = np.zeros((P, e), np.int32)
    for p in range(P):
        exc_rows[p] = rng.choice(np.flatnonzero(flags[p] & FLAG_PENDING), e,
                                 replace=False)
    exc_mask = np.zeros((P, e, H), bool)
    exc_mask[..., :hosts] = rng.random((P, e, hosts)) < 0.6
    # gangs: pool 0, the first pending rows of user 0
    members = np.flatnonzero(flags[0, :live] & FLAG_PENDING)[:gangs * GANG_SIZE]
    groups = {f"g{g}": SimpleNamespace(
        gang=True, gang_size=GANG_SIZE, gang_min=GANG_SIZE, gang_max=0,
        gang_topology="rack" if g % 2 else None) for g in range(gangs)}
    by_gang = {f"g{g}": [(int(r), None) for r in
                         members[g * GANG_SIZE:(g + 1) * GANG_SIZE]]
               for g in range(gangs)}
    offers = [SimpleNamespace(attributes={"rack": str(h % RACKS)})
              for h in range(hosts)]
    gang0 = build_gang_wire(T, by_gang, groups, offers)
    run_total = np.zeros((P, 4), np.float32)
    for p in range(P):
        running = ((flags[p] & FLAG_VALID) != 0) \
            & ((flags[p] & FLAG_PENDING) == 0)
        run_total[p] = res[rows[p][running]].sum(0)
    scalars = {
        "num_considerable": np.full(P, MAX_CONSIDERED, np.int32),
        # headroom for about five cycles of placements, so the caps bind
        # every cycle without closing the queue
        "pool_quota": (run_total + np.array([12000, 5e7, 400, 6000]))
        .astype(np.float32),
        "group_quota": (np.repeat(run_total.reshape(2, 2, 4).sum(1), 2, 0)
                        + np.array([22000, 9e7, 700, 11000]))
        .astype(np.float32),
        "group_id": np.array([0, 0, 1, 1], np.int32)}
    return SimpleNamespace(
        live=live, T=T, H=H, rows=rows, flags=flags, res=res, disk=disk,
        shares=shares, quota=quota, tokens=tokens, cap=cap, avail=avail,
        host_gpu=gpu_host, blocked=blocked, exc_rows=exc_rows,
        exc_mask=exc_mask, scalars=scalars,
        gangs=[gang0] + [None] * (P - 1))


def stage(w, res_dev, disk_dev, scales, device="cuda", quantize=True):
    from cook_tpu_torch.sched.fused import stage_mega_wire
    return stage_mega_wire(
        rows_p=w.rows, flags_p=w.flags, n_tasks=[w.live] * P,
        res_base=res_dev, disk_base=disk_dev, tokens_u_p=w.tokens,
        shares_u_p=w.shares, quota_u_p=w.quota, scalars=w.scalars,
        host_gpu_p=w.host_gpu, host_blocked_p=w.blocked,
        exc_rows_p=w.exc_rows, exc_mask_p=w.exc_mask, avail_p=w.avail,
        cap_p=w.cap, gang_wires=w.gangs, quantize=quantize, scales=scales,
        device=device)


def apply(w, res) -> int:
    """The fused driver's apply, in numpy: kept candidates start running
    and their hosts' avail shrinks."""
    from cook_tpu_torch.ops.delta import FLAG_PENDING
    rows = res.cand_row.cpu().numpy()
    hosts = res.cand_gang.cpu().numpy()
    placed = 0
    for p in range(P):
        for c in np.flatnonzero(hosts[p] >= 0):
            r, h = rows[p, c], hosts[p, c]
            base = w.rows[p, r]
            need = np.concatenate([w.res[base, :3], w.disk[base:base + 1]])
            w.flags[p, r] &= ~np.uint8(FLAG_PENDING)
            w.avail[p, h] = w.avail[p, h] - need
            placed += 1
    return placed


def megacycle_args(staged, max_considered=MAX_CONSIDERED, **modes):
    from cook_tpu_torch.ops.padding import bucket
    return dict(considerable_cap=bucket(max_considered),
                rows_codec=staged["rows_codec"], **modes,
                avail_scale=staged["avail_scale"],
                cap_scale=staged["cap_scale"])


# ----------------------------------------------------------------- checks
def tensors_of(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; raises unless equal bit for bit (NaN with NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"dtype/shape {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            raise AssertionError("kernel and plain version differ in NaNs")
        same = torch.equal(a[~na].view(torch.int32), b[~nb].view(torch.int32))
        err = float((a[~na] - b[~nb]).abs().max()) if (~na).any() else 0.0
    else:
        same = torch.equal(a, b)
        err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    if not same:
        raise AssertionError(f"kernel and plain version differ "
                             f"(max abs err {err})")
    return err


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def library_call(kernel, args):
    """One PyTorch call computing the same function, where there is one
    (timed only; the port never calls it)."""
    x = args[0]
    if kernel == "scan":
        return lambda: torch.cumsum(x, dim=1)
    if kernel == "sort":
        return lambda: torch.sort(x, dim=1, stable=True)
    return None


def bound(row) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate, for the work this run's inputs need."""
    bytes_ms = row["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = row["ops"] / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms else "bytes"


def replay(i, wrapper, args, kw, faults) -> tuple:
    """Launch a recorded call again and run its plain version on the same
    inputs; every output must agree bit for bit.  Appends a line per
    differing output to ``faults``; returns (kernel outputs, max abs
    err)."""
    got = tensors_of(wrapper.launch(*args, **kw))
    want = tensors_of(wrapper.plain(*args, **kw))
    torch.cuda.synchronize()
    err = 0.0
    for j, (a, b) in enumerate(zip(got, want, strict=True)):
        try:
            err = max(err, max_err(a, b))
        except AssertionError as e:
            bad = (a != b) & ~(a.isnan() & b.isnan()) \
                if a.is_floating_point() else a != b
            where = bad.nonzero()[:4].tolist() if bad.shape == a.shape \
                else []
            faults.append(f"call {i} {wrapper.__name__} output {j}: {e}; "
                          f"{int(bad.sum())} differ, first at {where}")
    return got, err


def phase_a(calls):
    """Replay one cycle's launches: kernel vs plain version, timed."""
    from cook_tpu_torch.ops.match import compose_mask
    rows = {k: dict(calls=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                    library_ms=None, bytes=0, ops=0) for k in SOURCES}
    faults = []
    for i, (wrapper, args, kw) in enumerate(calls):
        row = rows[wrapper.kernel]
        got, err = replay(i, wrapper, args, kw, faults)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if faults:
            continue
        slow = wrapper.kernel == "greedy"
        row["calls"] += 1
        row["ms"] += cuda_ms(lambda: wrapper.launch(*args, **kw),
                             3 if slow else 20)
        row["plain_ms"] += cuda_ms(lambda: wrapper.plain(*args, **kw),
                                   1 if slow else 3)
        lib = library_call(wrapper.kernel, args)
        if lib is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + cuda_ms(lib, 20)
        ins = [a for a in list(args) + list(kw.values())
               if isinstance(a, torch.Tensor)]
        row["bytes"] += sum(t.numel() * t.element_size() for t in ins + got)
        if slow:   # ~12 f32 ops per (valid slot, host its mask admits)
            mask = compose_mask(*args[2:7]) & (args[1] != 0)[..., None]
            row["ops"] += int(mask.sum()) * 12
    if faults:
        raise AssertionError("kernel != plain version:\n" + "\n".join(faults))
    return rows


# small worlds for the kernel paths the design point does not take
SMALL_WORLDS = (
    # i8 rows; u16 avail and capacity
    dict(size=dict(live=30, users=6, hosts=50, gangs=2, e=4),
         quantize=True, modes={}),
    # i16 rows; the over-quota limit binds
    dict(size=dict(live=3000, users=40, hosts=300, gangs=4, e=16),
         quantize=True, modes=dict(max_over_quota_jobs=3)),
    # wide wire; gpu-mode DRU; H = 16,384 keeps K5's avail in device memory
    dict(size=dict(live=2000, users=30, hosts=12000, gangs=4, e=16),
         quantize=False, modes=dict(gpu_mode=True)),
)


def phase_c():
    """Two cycles of each small world: kernels vs the plain cycle."""
    from cook_tpu_torch.ops.pallas_cycle import megacycle, megacycle_plain
    for i, spec in enumerate(SMALL_WORLDS):
        w = build_world(np.random.default_rng(SEED + 1 + i), **spec["size"])
        res_dev = torch.from_numpy(w.res).cuda()
        disk_dev = torch.from_numpy(w.disk).cuda()
        scales, seen, placed = {}, [], []
        for _ in range(2):
            staged = stage(w, res_dev, disk_dev, scales,
                           quantize=spec["quantize"])
            args = megacycle_args(staged, **spec["modes"])
            res = megacycle(staged["wire"], **args)
            ref = megacycle_plain(staged["wire"], **args)
            for name in res._fields:
                max_err(getattr(res, name), getattr(ref, name))
            seen.append([staged["rows_codec"], str(staged["avail_scale"]),
                         str(staged["cap_scale"])])
            placed.append(apply(w, res))
        print(json.dumps({"phase": "C", "world": i, "T": w.T, "H": w.H,
                          "modes": spec["modes"], "codecs": seen,
                          "placed": placed}))


# ---------------------------------------------------- phase D: top-K kernels
TOPK = {
    "topk_structured": dict(
        replaces="cook_tpu/ops/pallas_match.py:162",
        stage="top-K host preferences, structured mask (host vectors + "
              "exception rows), one thread per job"),
    "topk_dense": dict(
        replaces="cook_tpu/ops/pallas_match.py:116",
        stage="top-K host preferences, dense u8 mask, one thread per job"),
}
TOPK_K = 16


def structured_world(J=100_000, H=50_000, E=256):
    """bench.py's bench_pallas_scale recipe, from default_rng(6)."""
    rng = np.random.default_rng(6)
    job_res = np.stack([rng.integers(1, 8, J), rng.integers(64, 2048, J),
                        np.zeros(J), np.zeros(J)], axis=1).astype(np.float32)
    exc_id = np.full(J, -1, np.int32)
    exc_id[rng.choice(J, size=E, replace=False)] = np.arange(E, dtype=np.int32)
    cap = np.stack([rng.integers(16, 64, H), rng.integers(4096, 16384, H),
                    np.zeros(H), np.full(H, 1e6)], axis=1).astype(np.float32)
    blocked = rng.random(H) < 0.05
    exc_mask = rng.random((E, H)) < 0.5
    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).cuda()

    u8 = np.uint8
    return (dev(job_res), dev(np.ones(J), u8), dev(exc_id),
            dev(np.zeros(H), u8), dev(blocked, u8), dev(exc_mask, u8),
            dev(cap * np.float32(0.8)), dev(cap))


def make_match_workload(J, H, seed=1):
    """bench.py's make_match_workload: integer demands, a dense mask."""
    rng = np.random.default_rng(seed)
    job_res = np.stack([rng.integers(1, 16, J).astype(np.float32),
                        rng.integers(64, 4096, J).astype(np.float32),
                        np.zeros(J, np.float32), np.zeros(J, np.float32)], 1)
    capacity = np.stack([rng.integers(16, 128, H).astype(np.float32),
                         rng.integers(4096, 65536, H).astype(np.float32),
                         np.zeros(H, np.float32),
                         np.full(H, 1e6, np.float32)], 1)
    avail = (capacity * rng.uniform(0.3, 1.0, (H, 1))).astype(np.float32)
    return job_res, np.ones((J, H), bool), avail, capacity


def dense_world(J=10_000, H=50_000):
    """make_match_workload seed 3 with a seeded 80% mask and 90% valid
    jobs, made on the card."""
    job_res, _, avail, cap = make_match_workload(J, H, seed=3)
    g = torch.Generator(device="cuda").manual_seed(3)
    cmask = (torch.rand((J, H), generator=g, device="cuda") < 0.8) \
        .view(torch.uint8)
    valid = (torch.rand(J, generator=g, device="cuda") < 0.9) \
        .view(torch.uint8)
    return (torch.from_numpy(job_res).cuda(), cmask, valid,
            torch.from_numpy(avail).cuda(), torch.from_numpy(cap).cuda())


def structured_check_world(J=30_000, H=20_000, E=64, seed=7):
    """The paths the bench world leaves idle: gpu jobs and gpu hosts, 10%
    invalid jobs (some holding an exception row), non-dyadic demands;
    run with k = 8 (eight kept entries) and 3 host splits."""
    rng = np.random.default_rng(seed)
    job_res = np.stack([rng.uniform(0.1, 8.0, J), rng.uniform(64, 2048, J),
                        (rng.random(J) < 0.2) * rng.integers(1, 4, J),
                        rng.uniform(0.0, 10.0, J)], 1).astype(np.float32)
    cap = np.stack([rng.uniform(16, 64, H), rng.uniform(4096, 16384, H),
                    (rng.random(H) < 0.3) * 8.0, np.full(H, 1e3)],
                   1).astype(np.float32)
    avail = (cap * rng.uniform(0.2, 1.0, (H, 4))).astype(np.float32)
    exc_id = np.full(J, -1, np.int32)
    exc_id[rng.choice(J, size=E, replace=False)] = np.arange(E, dtype=np.int32)
    u8 = np.uint8

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).cuda()
    return (dev(job_res), dev(rng.random(J) >= 0.1, u8), dev(exc_id),
            dev(cap[:, 2] > 0, u8), dev(rng.random(H) < 0.05, u8),
            dev(rng.random((E, H)) < 0.5, u8), dev(avail), dev(cap))


def dense_check_world(J=2_000, H=30_000, seed=8):
    """A small J (16 job blocks, so 30 host splits of fewer hosts than a
    tile), run with k = 4: eight kept entries, four written."""
    job_res, _, avail, cap = make_match_workload(J, H, seed=seed)
    job_res[:, 0] += np.float32(0.3)
    g = torch.Generator(device="cuda").manual_seed(seed)
    cmask = (torch.rand((J, H), generator=g, device="cuda") < 0.8) \
        .view(torch.uint8)
    valid = (torch.rand(J, generator=g, device="cuda") < 0.9) \
        .view(torch.uint8)
    return (torch.from_numpy(job_res).cuda(), cmask, valid,
            torch.from_numpy(avail).cuda(), torch.from_numpy(cap).cuda())


def topk_parity(got, want) -> float:
    """fit bit for bit; host equal where fit > -inf (the -inf entries'
    hosts mean nothing).  Returns the max abs error of the finite fits."""
    fit, host = got
    wfit, whost = want
    if not torch.equal(fit.view(torch.int32), wfit.view(torch.int32)):
        bad = int((fit.view(torch.int32) != wfit.view(torch.int32)).sum())
        raise AssertionError(f"top-K fit differs in {bad} entries")
    finite = wfit > float("-inf")
    if not torch.equal(host[finite], whost[finite]):
        raise AssertionError(f"top-K host differs in "
                             f"{int((host != whost)[finite].sum())} entries")
    return 0.0


def topk_library_ms(wrapper, args) -> float:
    """``torch.topk`` of the materialized score, summed over the plain
    version's chunks (the score is built outside the timed region)."""
    from cook_tpu_torch.ops import pallas_match as tpm
    job_res, avail, capacity = args[0], args[-2], args[-1]
    J, H = job_res.shape[0], avail.shape[0]
    total = 0.0
    step = tpm.chunk_rows(H)
    for lo in range(0, J, step):
        hi = min(J, lo + step)
        res = job_res[lo:hi]
        if wrapper.kernel == "topk_dense":
            mask = (args[1][lo:hi] != 0) & (args[2][lo:hi] != 0)[:, None]
        else:
            mask = tpm.structured_mask(res, args[1][lo:hi], args[2][lo:hi],
                                       *args[3:6])
        sc = tpm.score(res, tpm.resource_fit(res, avail) & mask, avail,
                       capacity)
        total += cuda_ms(lambda: torch.topk(sc, TOPK_K, dim=1), 3)
    return total


def phase_d():
    """The top-K kernels through their entry points at the bench worlds
    (counted), then each held against its plain version and timed."""
    from cook_tpu_torch.ops import pallas_match as tpm
    from cook_tpu_torch.ops import telemetry
    worlds = {"topk_structured": (tpm.topk_structured, structured_world()),
              "topk_dense": (tpm.topk_dense, dense_world())}
    telemetry.reset_all()
    outs = {}
    for name, (wrapper, args) in worlds.items():
        if name == "topk_structured":
            outs[name] = tpm.topk_prefs_structured(
                args[0], args[1], args[3], args[4], args[2], args[5],
                args[6], args[7], k=TOPK_K)
        else:
            outs[name] = tpm.topk_prefs(*args, k=TOPK_K)
    torch.cuda.synchronize()
    counts = telemetry.snapshot()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for name, (wrapper, args) in worlds.items():
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched")
        want = wrapper.plain(*args, TOPK_K)
        err = topk_parity(outs[name], want)
        ms = cuda_ms(lambda: wrapper(*args, TOPK_K), 3)
        job_res, avail = args[0], args[-2]
        J, H = job_res.shape[0], avail.shape[0]
        splits = tpm.host_splits(J, H, sms)
        one_split_ms = None
        if splits > 1:   # the same work with the hosts left unsplit
            per_sm = tpm.BLOCKS_PER_SM
            tpm.BLOCKS_PER_SM = 0
            try:
                topk_parity(wrapper(*args, TOPK_K), want)
                one_split_ms = cuda_ms(lambda: wrapper(*args, TOPK_K), 3)
            finally:
                tpm.BLOCKS_PER_SM = per_sm
        del want
        plain_ms = cuda_ms(lambda: wrapper.plain(*args, TOPK_K), 1)
        lib_ms = topk_library_ms(wrapper, args)
        valid = args[2] if name == "topk_dense" else args[1]
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        nbytes = sum(t.numel() * t.element_size()
                     for t in ins + list(outs[name]))
        # ~12 f32 operations per (valid job, host) pair
        ops = int((valid != 0).sum()) * avail.shape[0] * 12
        fit = outs[name][0]
        rows[name] = dict(calls=1, launches=counts[name], max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bytes=nbytes, ops=ops)
        b_ms, b_by = bound(rows[name])
        print(json.dumps({
            "phase": "D", "kernel": name, "J": J, "H": H, "k": TOPK_K,
            **rows[name], "bound_ms": b_ms, "bound_by": b_by,
            "host_splits": splits, "one_split_ms": one_split_ms,
            "finite_entries": int((fit > float("-inf")).sum())}))
    checks = (("topk_structured", tpm.topk_structured,
               structured_check_world(), 8),
              ("topk_dense", tpm.topk_dense, dense_check_world(), 4))
    for name, wrapper, args, k in checks:
        got = wrapper(*args, k)
        topk_parity(got, wrapper.plain(*args, k))
        J, H = args[0].shape[0], args[-2].shape[0]
        print(json.dumps({
            "phase": "D", "check": name, "J": J, "H": H, "k": k,
            "host_splits": tpm.host_splits(J, H, sms),
            "finite_entries": int((got[0] > float("-inf")).sum()),
            "equal_to_plain": True}))
    return rows


# ---------------------------------------------- phase E: the split matcher
FULL_WORLDS = (
    # (name, J, H, seed, packing): bench_match, bench_match_large,
    # bench_placement_quality
    ("greedy_1k", 1_000, 50_000, 1, "throughput"),
    ("waterfill_10k", 10_000, 50_000, 3, "throughput"),
    ("auction_10k", 10_000, 50_000, 11, "tight"),
)
BACKENDS = ("auto", "tpu-greedy", "tpu-auction", "tpu-waterfill",
            "tpu-megakernel", "cpu")


def check_placement(assign, job_res, cmask, avail) -> dict:
    """No host oversubscribed in any resource (exact float64 sums) and
    no masked host assigned."""
    placed = np.flatnonzero(assign >= 0)
    hosts = assign[placed]
    if not cmask[placed, hosts].all():
        raise AssertionError("a job was placed on a masked host")
    used = np.zeros(avail.shape, np.float64)
    np.add.at(used, hosts, job_res[placed].astype(np.float64))
    if (used > avail.astype(np.float64)).any():
        raise AssertionError("a host is oversubscribed")
    return {"placed": int(placed.size),
            "hosts_used": int(np.unique(hosts).size)}


def split_world(J=2_500, H=4_000, seed=21):
    """A reduced world where ``auto`` splits: 10% of rows below
    sparse_cmask_density, non-dyadic demands, demand past capacity."""
    job_res, cmask, avail, cap = make_match_workload(J, H, seed)
    rng = np.random.default_rng(seed + 1)
    job_res[:, 0] += np.float32(0.3)
    job_res[:, 1] *= np.float32(1.1)
    sparse = rng.random(J) < 0.1
    cmask[sparse] = rng.random((int(sparse.sum()), H)) < 0.05
    return job_res, cmask, avail, cap


def phase_e():
    """The split matcher on the card: the three full-width worlds
    (counted), the K5 route against the plain greedy, and the reduced
    split world for every backend, card against CPU."""
    from cook_tpu_torch.config import MatcherConfig
    from cook_tpu_torch.ops import cuda_lib, host_prep, telemetry
    from cook_tpu_torch.ops import match as tm
    from cook_tpu_torch.sched.matcher import dispatch, resolve_backend
    worlds = [(name, make_match_workload(J, H, seed), packing)
              for name, J, H, seed, packing in FULL_WORLDS]
    telemetry.reset_all()
    results = []
    with cuda_lib.recording() as calls:
        for name, args, packing in worlds:
            mc = MatcherConfig(auto_packing=packing)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            assign = dispatch(mc, *args)
            wall_ms = (time.perf_counter() - t0) * 1e3
            results.append((name, args, mc, assign, wall_ms))
    counts = telemetry.snapshot()
    for k in ("greedy", "scan"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{k} was not launched by the split path")
    # every launch of the three worlds again, against its plain version
    # on the same inputs, at the split path's own shapes
    faults, held = [], {}
    for i, (wrapper, wargs, kw) in enumerate(calls):
        replay(i, wrapper, wargs, kw, faults)
        shape = tuple(wargs[0].shape)
        key = f"{wrapper.__name__} {list(shape)}"
        held[key] = held.get(key, 0) + 1
    if faults:
        raise AssertionError("split path: kernel != plain version:\n"
                             + "\n".join(faults))
    print(json.dumps({"phase": "E", "replayed_equal_to_plain": held}))
    for name, args, mc, assign, wall_ms in results:
        print(json.dumps({
            "phase": "E", "world": name, "J": len(args[0]),
            "H": len(args[2]), "backend": resolve_backend(mc, len(args[0])),
            "auto_packing": mc.auto_packing, "wall_ms": wall_ms,
            **check_placement(assign, args[0], args[1], args[2])}))

    # the K5 route against the plain greedy on the card
    name, args, mc, assign, _ = results[0]
    arrays = host_prep.pack_match_inputs(*args)
    inp = tm.MatchInputs(*(torch.from_numpy(arrays[k]).cuda() for k in (
        "job_res", "constraint_mask", "avail", "capacity", "valid")))
    got = tm.greedy_match_kernel(inp)
    want = tm.greedy_assign(inp.job_res, inp.constraint_mask, inp.valid,
                            inp.avail, inp.capacity)
    for a, b in zip(got, want):
        max_err(a, b)
    if not np.array_equal(got[0].cpu().numpy()[:len(args[0])], assign):
        raise AssertionError("dispatch differs from the K5 route")

    # every backend on the reduced split world: card against CPU
    args = split_world()
    same = {}
    for backend in BACKENDS:
        for packing in ("throughput", "tight"):
            mc = MatcherConfig(backend=backend, auto_packing=packing)
            t0 = time.perf_counter()
            on_card = dispatch(mc, *args, device="cuda")
            card_ms = (time.perf_counter() - t0) * 1e3
            on_cpu = dispatch(mc, *args, device="cpu")
            if not np.array_equal(on_card, on_cpu):
                raise AssertionError(f"{backend}/{packing}: card != CPU in "
                                     f"{int((on_card != on_cpu).sum())} jobs")
            check_placement(on_card, *args[:3])
            same[f"{backend}/{packing}"] = {
                "placed": int((on_card >= 0).sum()), "card_ms": card_ms}
    print(json.dumps({"phase": "E", "world": "split_2500x4000",
                      "identical_card_cpu": same}))
    return counts



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.ops.pallas_cycle import megacycle, megacycle_plain
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)
    build_s = time.perf_counter() - t0
    log = cuda_lib.BUILD_DIR / "ptxas.log"
    log.write_text(cuda_lib.BUILD_LOG)
    print(json.dumps({"build_s": build_s, "ptxas_log": str(log)}))

    rng = np.random.default_rng(SEED)
    w = build_world(rng)
    res_dev = torch.from_numpy(w.res).cuda()
    disk_dev = torch.from_numpy(w.disk).cuda()
    scales = {}

    # warm-up cycle, recorded for phase A (the world is not changed)
    staged = stage(w, res_dev, disk_dev, scales)
    with cuda_lib.recording() as calls:
        megacycle(staged["wire"], **megacycle_args(staged))
    torch.cuda.synchronize()
    rows = phase_a(calls)
    for k, row in rows.items():
        b_ms, b_by = bound(row)
        print(json.dumps({"phase": "A", "kernel": k, **row, "bound_ms": b_ms,
                          "bound_by": b_by}))

    phase_c()

    # phase B: the main path, counted
    telemetry.reset_all()
    cycle_ms, plain_ms, stage_ms, placed, codecs = [], [], [], [], []
    for cyc in range(CYCLES):
        t0 = time.perf_counter()
        staged = stage(w, res_dev, disk_dev, scales)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = megacycle(staged["wire"], **megacycle_args(staged))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = telemetry.snapshot()
        ref = megacycle_plain(staged["wire"], **megacycle_args(staged))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name in res._fields:
            max_err(getattr(res, name), getattr(ref, name))
        n = apply(w, res)
        stage_ms.append((t1 - t0) * 1e3)
        cycle_ms.append((t2 - t1) * 1e3)
        plain_ms.append((t3 - t2) * 1e3)
        placed.append(n)
        codecs.append([staged["rows_codec"], str(staged["avail_scale"]),
                       str(staged["cap_scale"])])
        print(json.dumps({
            "phase": "B", "cycle": cyc, "stage_ms": stage_ms[-1],
            "cycle_ms": cycle_ms[-1], "plain_cycle_ms": plain_ms[-1],
            "placed": n, "dropped": int(res.cand_dropped.sum()),
            "n_queue": res.n_queue.tolist(), "h2d_bytes": staged["h2d_bytes"],
            "codecs": codecs[-1], "launches_so_far": launches}))
    counts = telemetry.snapshot()
    missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if sum(placed) <= 0:
        raise AssertionError("no placement in 5 cycles")
    print(json.dumps({
        "phase": "B", "cycles": CYCLES, "cycle_ms": cycle_ms,
        "cycle_ms_median_after_first": statistics.median(cycle_ms[1:]),
        "plain_cycle_ms_median_after_first": statistics.median(plain_ms[1:]),
        "stage_ms_median_after_first": statistics.median(stage_ms[1:]),
        "placed": placed, "launches_per_kernel": counts,
        "shape": {"P": P, "T": w.T, "H": w.H, "C": 1024, "E": E,
                  "live_rows": LIVE, "users": USERS, "hosts": HOSTS}}))
    topk_rows = phase_d()
    split_counts = phase_e()
    print(json.dumps({"phase": "E", "launches_per_kernel": split_counts}))
    print(card)
    out = []
    for k, row in rows.items():
        b_ms, b_by = bound(row)
        out.append({
            "name": k, "route": "cuda",
            "source": f"cook_tpu_torch/ops/csrc/{SOURCES[k]}",
            "replaces": "cook_tpu/ops/pallas_cycle.py:137",
            "stage": STAGES[k], "launches": counts[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": row["library_ms"], "calls_per_cycle": row["calls"]})
    for k, row in topk_rows.items():
        b_ms, b_by = bound(row)
        out.append({
            "name": k, "route": "cuda",
            "source": "cook_tpu_torch/ops/csrc/topk.cu",
            "replaces": TOPK[k]["replaces"], "stage": TOPK[k]["stage"],
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
