"""The resident wire over a churn sequence against the JAX package on
the CPU.

Six cycles on ``tests/test_torch_cycle.py``'s world (without gangs),
with placements applied, running tasks finishing and new pending jobs
arriving user-contiguous.  Every cycle the same host arrays go through
``megacycle_plain`` on the resident wire (``sync_resident`` then
``stage_mega_wire(resident=True)``), ``megacycle_plain`` on the rebuilt
quantized wire and the JAX fused cycle; all seven outputs must be equal
(tolerance 0).  ``sync_resident`` must take, in order: cold, delta,
empty, shape (the T bucket regrows), compaction, oversize, and fault (a
small change with the ``delta.apply`` fault point armed).
"""

import numpy as np
import pytest
import torch

from test_torch_cycle import CAP, OUTPUTS, jax_cycle, world

from cook_tpu_torch.ops import pallas_cycle as tpc
from cook_tpu_torch.ops import quant as tq
from cook_tpu_torch.ops import telemetry
from cook_tpu_torch.ops.delta import DeviceBaseMirror, PackDeltaApplier
from cook_tpu_torch.ops.padding import bucket
from cook_tpu_torch.sched.fused import (REPACK_REASONS, negotiate_rows,
                                        stage_mega_wire, sync_resident)
from cook_tpu_torch.utils.faults import injector
from cook_tpu_torch.utils.flight import recorder
from cook_tpu_torch.utils.metrics import registry

F32 = np.float32
P = 2


class Churn:
    """Host state of both pools: per pool the base row ids in
    user-contiguous order with each task's user and flag bits, and the
    base table the ids index."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.fields, _ = world(seed)
        f = self.fields
        self.res = f["res_base"].copy()
        self.disk = f["disk_base"].copy()
        self.epoch = 0
        self.pools = []
        for p in range(P):
            fl = f["flags"][p]
            live = (fl & 2) != 0
            user = np.cumsum((fl & 16) != 0)[live] - 1
            self.pools.append(dict(
                ids=f["rows"][p][live].astype(np.int32), user=user,
                bits=(fl[live] & 13).astype(np.uint8)))

    def T(self):
        return bucket(max(len(q["ids"]) for q in self.pools))

    def host_arrays(self):
        T = self.T()
        rows = np.zeros((P, T), np.int32)
        flags = np.zeros((P, T), np.uint8)
        for p, q in enumerate(self.pools):
            n = len(q["ids"])
            first = np.ones(n, bool)
            first[1:] = q["user"][1:] != q["user"][:-1]
            rows[p, :n] = q["ids"]
            flags[p, :n] = q["bits"] | 2 | (first * 16).astype(np.uint8)
        return rows, flags

    def fields_of(self, rows, flags):
        f = dict(self.fields, rows=rows, flags=flags, res_base=self.res,
                 disk_base=self.disk)
        return f

    def apply(self, rows, res):
        """Placed candidates start running; their hosts shrink."""
        placed = 0
        for p, q in enumerate(self.pools):
            for c in np.flatnonzero(res.cand_gang[p].numpy() >= 0):
                r = int(res.cand_row[p, c])
                h = int(res.cand_gang[p, c])
                base = rows[p, r]
                need = np.concatenate([self.res[base, :3],
                                       self.disk[base:base + 1]])
                q["bits"][r] &= ~np.uint8(1)
                self.fields["avail"][p, h] -= need
                placed += 1
        return placed

    def finish(self, n, last_user=False):
        """``n`` running tasks a pool finish and leave (of the last user
        only: the positions before that user's segment keep their
        rows)."""
        for q in self.pools:
            running = np.flatnonzero(((q["bits"] & 1) == 0) & (
                q["user"] == q["user"][-1] if last_user else True))
            gone = self.rng.choice(running, min(n, len(running)),
                                   replace=False)
            keep = np.ones(len(q["ids"]), bool)
            keep[gone] = False
            for k in ("ids", "user", "bits"):
                q[k] = q[k][keep]

    def arrive(self, n, users=None):
        """``n`` pending jobs a pool arrive, each at the end of its
        user's segment; their base rows are appended to the table.
        ``users``: ``(u,)`` puts them all on user u, ``(-1,)`` on each
        pool's last user; random users otherwise."""
        U = self.fields["shares_u"].shape[1]
        for q in self.pools:
            new_u = (self.rng.integers(0, U, n) if users is None
                     else np.full(n, users[0] if users[0] >= 0
                                  else q["user"][-1]))
            N = self.res.shape[0]
            self.res = np.concatenate([self.res, np.stack(
                [self.rng.random(n) * 3.7 + 0.1,
                 self.rng.random(n) * 900 + 17.3,
                 (self.rng.random(n) < 0.1) * 1.0, np.ones(n)],
                -1).astype(F32)])
            self.disk = np.concatenate(
                [self.disk, (self.rng.random(n) * 30).astype(F32)])
            ids = np.arange(N, N + n, dtype=np.int32)
            bits = (1 + 4 * (self.rng.random(n) < 0.95)
                    + 8 * (self.rng.random(n) < 0.9)).astype(np.uint8)
            user = np.concatenate([q["user"], new_u])
            order = np.argsort(user, kind="stable")
            q["user"] = user[order]
            q["ids"] = np.concatenate([q["ids"], ids])[order]
            q["bits"] = np.concatenate([q["bits"], bits])[order]

    def compact(self):
        """A compaction fence: the base table keeps only live rows,
        renumbered; the epoch moves."""
        live = np.unique(np.concatenate([q["ids"] for q in self.pools]))
        remap = np.full(self.res.shape[0], -1, np.int32)
        remap[live] = np.arange(len(live), dtype=np.int32)
        self.res, self.disk = self.res[live], self.disk[live]
        for q in self.pools:
            q["ids"] = remap[q["ids"]]
        self.epoch += 1


def _stage(c, rows, flags, mirror, **kw):
    f = c.fields
    res_dev, disk_dev = mirror.sync(c.res, c.disk, c.epoch)
    n_tasks = [len(q["ids"]) for q in c.pools]
    T = rows.shape[1]
    return stage_mega_wire(
        rows_p=rows, flags_p=flags, n_tasks=n_tasks, res_base=res_dev,
        disk_base=disk_dev, tokens_u_p=f["tokens_u"],
        shares_u_p=f["shares_u"], quota_u_p=f["quota_u"],
        scalars={k: f[k] for k in ("num_considerable", "pool_quota",
                                   "group_quota", "group_id")},
        host_gpu_p=f["host_gpu"], host_blocked_p=f["host_blocked"],
        exc_rows_p=np.minimum(f["exc_rows"], T - 1),
        exc_mask_p=f["exc_mask"], avail_p=f["avail"], cap_p=f["capacity"],
        gang_wires=[None] * P, device="cpu", **kw)


def _plain(staged):
    return tpc.megacycle_plain(
        staged["wire"], considerable_cap=CAP,
        rows_codec=staged["rows_codec"], avail_scale=staged["avail_scale"],
        cap_scale=staged["cap_scale"])


def _no_gangs(T, H):
    gid, gsize, gattr, topo = tpc.empty_gang_wire(P, T, H)
    return dict(gang_id=gid, gang_size=gsize, gang_attr=gattr,
                host_topo=topo)


# what happens between cycle i and i + 1, and the reason cycle i takes
PLAN = (("cold", "place+churn"), ("delta", None), ("empty", "grow"),
        ("shape", "compact"), ("compaction", "front"),
        ("oversize", "fault"), ("fault", None))


@pytest.mark.parametrize("seed", [0, 3])
def test_resident_churn_matches_rebuild_and_jax(seed):
    c = Churn(seed)
    mirror = DeviceBaseMirror(device="cpu")
    applier = PackDeltaApplier(device="cpu")
    packs, reasons, ks = {}, [], []
    telemetry.reset_all()
    injector.clear()
    for want_reason, then in PLAN:
        rows, flags = c.host_arrays()
        T, H = rows.shape[1], c.fields["avail"].shape[1]
        fields = c.fields_of(rows, flags)
        fields["exc_rows"] = np.minimum(fields["exc_rows"], T - 1)
        want, _ = jax_cycle(fields, _no_gangs(T, H))
        rebuilt = _plain(_stage(c, rows, flags, mirror, quantize=True,
                                scales={}))
        sync = sync_resident(packs, False, (("p0", "p1"), P, T), rows,
                             flags, c.epoch, applier=applier)
        st = _stage(c, rows, flags, mirror, quantize=True, scales={},
                    rows_dev=sync.rows_dev, flags_dev=sync.flags_dev,
                    resident=True)
        assert st["rows_codec"] == tq.ROWS_WIDE
        resident = _plain(st)
        for name in OUTPUTS:
            w = want[name]
            np.testing.assert_array_equal(
                getattr(rebuilt, name).numpy(), w, err_msg=name)
            np.testing.assert_array_equal(
                getattr(resident, name).numpy(), w, err_msg=name)
        reasons.append(sync.reason)
        ks.append(sync.k)
        assert sync.reason == want_reason, (reasons, ks)
        if then in ("place+churn", "grow"):
            assert c.apply(rows, rebuilt) > 0
        if then == "place+churn":      # churn in the last user only
            c.finish(3, last_user=True)
            c.arrive(4, users=(-1,))
        elif then == "grow":
            c.arrive(300 - len(c.pools[0]["ids"]) + 60)
        elif then == "compact":
            c.finish(20)
            c.compact()
        elif then == "front":
            c.arrive(40, users=(0,))
        elif then == "fault":          # a small delta whose scatter fails
            c.finish(2, last_user=True)
            injector.arm("delta.apply", schedule=[0])
    injector.clear()
    assert 0 < ks[1] and ks[2] == 0
    ev = telemetry.events()
    assert ev["resident.delta_rows"] == ks[1]
    for r in REPACK_REASONS:
        assert ev[f"resident.repack.{r}"] == 1


def test_delta_sync_scatters_in_place():
    c = Churn(1)
    applier = PackDeltaApplier(device="cpu")
    packs = {}
    rows, flags = c.host_arrays()
    first = sync_resident(packs, True, ("k",), rows, flags, 0,
                          applier=applier)
    ptr = packs[True].rows_buf.data_ptr()
    rows2, flags2 = rows.copy(), flags.copy()
    flags2[0, 3] ^= 1
    rows2[1, 7] += 2
    second = sync_resident(packs, True, ("k",), rows2, flags2, 0,
                           applier=applier)
    assert first.reason == "cold" and second.reason == "delta"
    assert second.k == 2 and packs[True].rows_buf.data_ptr() == ptr
    assert torch.equal(second.rows_dev, torch.from_numpy(rows2))
    assert torch.equal(second.flags_dev, torch.from_numpy(flags2))
    # the scatter batch: 256 padded positions of i32 + i8 + u8
    assert second.h2d_bytes == 256 * (4 + 1 + 1)
    assert first.h2d_bytes == rows.nbytes + flags.nbytes
    # a repack of the same shape rewrites the same buffers
    rows3 = rows2 + 1
    third = sync_resident(packs, True, ("k",), rows3, flags2, 0,
                          applier=applier)
    assert third.reason == "oversize" and third.k == rows3.size
    assert packs[True].rows_buf.data_ptr() == ptr
    assert torch.equal(third.rows_dev, torch.from_numpy(rows3))
    assert int(packs[True].rows_buf[-1]) == 0


def test_resident_staging_ships_no_rows_or_flags():
    c = Churn(2)
    mirror = DeviceBaseMirror(device="cpu")
    rows, flags = c.host_arrays()
    sync = sync_resident({}, False, ("k",), rows, flags, 0,
                         applier=PackDeltaApplier(device="cpu"))
    rebuilt = _stage(c, rows, flags, mirror, quantize=True, scales={})
    resident = _stage(c, rows, flags, mirror, quantize=True, scales={},
                      rows_dev=sync.rows_dev, flags_dev=sync.flags_dev,
                      resident=True)
    q = negotiate_rows(rows, [len(q["ids"]) for q in c.pools])
    assert rebuilt["h2d_bytes"] - resident["h2d_bytes"] == \
        q.data.nbytes + flags.nbytes
    assert resident["wire"].rows.dtype == torch.int32
    with pytest.raises(ValueError, match="rows_dev"):
        _stage(c, rows, flags, mirror, resident=True)


def _series_sum(registry, name, **labels):
    return sum(v for lab, v in registry.series(name)
               if all(lab.get(k) == x for k, x in labels.items()))


@pytest.mark.parametrize("fault", ["extract", "apply", "bad_buffer"])
def test_sync_resident_fault_repacks(fault):
    """A failed delta (its extraction, its scatter, or a scatter into a
    buffer that cannot take it) repacks with reason ``fault`` into fresh
    buffers equal to a cold repack's, counts the fallback, and the next
    sync takes the delta path again."""
    c = Churn(4)
    applier = PackDeltaApplier(device="cpu")
    packs = {}
    rows, flags = c.host_arrays()
    sync_resident(packs, False, ("k",), rows, flags, 0, applier=applier)
    flags2 = flags.copy()
    flags2[0, 0] ^= 4
    kernel = "delta.extract" if fault == "extract" else "delta.apply"
    injector.clear()
    if fault == "bad_buffer":
        packs[False].flags_buf = packs[False].flags_buf[:-1]  # no dump slot
    else:
        injector.arm(kernel, schedule=[0])
    before = _series_sum(registry, "cook_kernel_fallback", kernel=kernel)
    telemetry.reset_all()
    try:
        with recorder.cycle(kind="fused") as rec:
            sync = sync_resident(packs, False, ("k",), rows, flags2, 0,
                                 applier=applier)
    finally:
        injector.clear()
    assert sync.reason == "fault"
    assert _series_sum(registry, "cook_kernel_fallback",
                       kernel=kernel) == before + 1
    assert rec.faults.get("kernel.dispatch-fallback") == 1
    assert telemetry.events()["resident.repack.fault"] == 1
    cold = sync_resident({}, False, ("k",), rows, flags2, 0,
                         applier=applier)
    assert torch.equal(sync.rows_dev, cold.rows_dev)
    assert torch.equal(sync.flags_dev, cold.flags_dev)
    assert packs[False].flags_buf.numel() == flags.size + 1
    assert int(packs[False].flags_buf[-1]) == 0
    flags3 = flags2.copy()
    flags3[1, 2] ^= 1
    nxt = sync_resident(packs, False, ("k",), rows, flags3, 0,
                        applier=applier)
    assert nxt.reason == "delta" and nxt.k == 1
    assert torch.equal(nxt.flags_dev, torch.from_numpy(flags3))


@pytest.mark.parametrize("world", ["plain", "backoff_cap"])
@pytest.mark.parametrize("fault", ["delta.extract", "delta.apply"])
def test_driver_fault_repack_parity(fault, world):
    """The production driver with a resident-delta fault armed on its
    second cycle (a status-only change, which takes the delta path):
    both packages repack with reason ``fault``, count the fallback once,
    and launch the same pairs on every cycle, before and after."""
    import importlib
    from test_torch_driver import PORT, REF, WORLDS, World, counts, launched
    sides = [World(m, WORLDS[world], 3) for m in (REF, PORT)]
    mods = [(importlib.import_module(f"{m.root}.utils.faults").injector,
             importlib.import_module(f"{m.root}.utils.metrics").registry)
            for m in (REF, PORT)]
    before = [(_series_sum(reg, "cook_kernel_fallback", kernel=fault),
               _series_sum(reg, "cook_resident_repack", reason="fault"))
              for _inj, reg in mods]
    for c in range(4):
        if c == 1:
            for inj, _reg in mods:
                inj.clear()
                inj.arm(fault, schedule=[0])
        try:
            res = [w.cycle() for w in sides]
        finally:
            for inj, _reg in mods:
                inj.clear()
        assert launched(sides[0], res[0]) == launched(sides[1], res[1]), c
        assert counts(res[0]) == counts(res[1]), c
        for w in sides:
            # status-only churn: the next cycle's change is a delta
            w.now[0] += 60_000
            running = [t for j in sorted(w.jobs, key=lambda j: j.uuid)
                       for t in w.store.job(j.uuid).instances
                       if w.store.instance(t).status
                       is w.m.InstanceStatus.RUNNING]
            for n, tid in enumerate(running[:2]):
                w.cluster.complete_task(tid, exit_code=n)
    after = [(_series_sum(reg, "cook_kernel_fallback", kernel=fault),
              _series_sum(reg, "cook_resident_repack", reason="fault"))
             for _inj, reg in mods]
    assert [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)] == \
        [(1, 1), (1, 1)]
