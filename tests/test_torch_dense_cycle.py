"""The dense-mask cycle and the entity pack against the JAX package on the
CPU.

Cycle level: the same seeded dense worlds (numpy) go through the JAX
package's ``make_pool_cycle(1-device CPU mesh, structured=False)``, the
port's plain ``parallel/sharded.dense_pool_cycle`` (and
``single_pool_cycle``), and the port's card route (``megacycle`` over
``ops/pallas_cycle.dense_wire``) on the CPU (the stage chain's plain
versions); every output the reference's driver reads must be equal, bit
for bit.

Driver level: ``columnar_index=False`` (the entity pack) through the
port's ``FusedCycleDriver`` and ``Scheduler`` against the reference's at
pipeline depths 0 and 2, over ``tests/test_torch_driver.py``'s worlds:
the same launched (job uuid, hostname) pairs, ``MatchCycleResult``
counts, states and published queues every cycle; and the entity pack
deciding as the columnar pack does where the reference asserts it.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cook_tpu.parallel import PoolCycleInputs as JaxDenseInputs
from cook_tpu.parallel import make_pool_cycle as jax_make_pool_cycle
from cook_tpu.parallel.mesh import POOL_AXIS
from cook_tpu_torch.ops import pallas_cycle as tpc
from cook_tpu_torch.parallel import sharded as tsh
from cook_tpu_torch.parallel.mesh import pool_mesh

F32 = np.float32
INF = np.inf


def dense_world(seed, P=2, T=64, H=16, single_user_pool=True):
    """Stacked PoolCycleInputs arrays (numpy) of ``P`` random pools:
    users of 1-9 tasks (one pool with a single user when asked), 30%
    running, non-dyadic demands, finite user quotas and token budgets,
    random enqueue / launch verdicts, a random dense mask, padding at
    the tail of every pool, finite pool caps and one quota group."""
    rng = np.random.default_rng(seed)
    out = {k: [] for k in ("usage", "quota", "shares", "first_idx",
                           "user_rank", "pending", "valid", "enqueue_ok",
                           "launch_ok", "tokens", "job_res", "cmask",
                           "avail", "capacity")}
    for p in range(P):
        n_users = 1 if (single_user_pool and p == P - 1) else \
            int(rng.integers(2, 6))
        usage, quota, shares, first, rank, pend, toks = ([] for _ in range(7))
        for u in range(n_users):
            n = int(rng.integers(1, 10))
            start = len(usage)
            q = np.array([rng.integers(6, 30) + 0.5,
                          rng.integers(900, 5000) + 0.25, INF,
                          rng.integers(3, 9)], dtype=F32)
            sh = np.array([rng.integers(8, 40) + 0.3,
                           rng.integers(2000, 9000) + 0.7, 1.0], dtype=F32)
            tok = F32(rng.integers(1, 6)) if rng.random() < 0.5 else F32(INF)
            for _ in range(n):
                usage.append([rng.integers(1, 4) + rng.choice([0.1, 0.3]),
                              rng.integers(64, 700) + 0.7, 0.0, 1.0])
                quota.append(q)
                shares.append(sh)
                first.append(start)
                rank.append(u)
                pend.append(bool(rng.random() < 0.7))
                toks.append(tok)
        n = len(usage)
        assert n <= T
        pad = T - n

        def col(rows, fill, dt, width=None):
            a = np.asarray(rows, dtype=dt)
            shape = (pad,) + a.shape[1:]
            return np.concatenate([a, np.full(shape, fill, dtype=dt)])
        usage_a = col(usage, 0.0, F32)
        pend_a = col(pend, False, bool)
        out["usage"].append(usage_a)
        out["quota"].append(col(quota, INF, F32))
        out["shares"].append(col(shares, INF, F32))
        out["first_idx"].append(col(first, 0, np.int32))
        out["user_rank"].append(col(rank, 2 ** 31 - 1, np.int32))
        out["pending"].append(pend_a)
        out["valid"].append(col([True] * n, False, bool))
        out["enqueue_ok"].append(col(rng.random(n) < 0.9, False, bool))
        out["launch_ok"].append(col(rng.random(n) < 0.9, False, bool))
        out["tokens"].append(col(toks, 0.0, F32))
        disk = np.round(rng.random(T) * 10, 1).astype(F32)
        job_res = np.concatenate([usage_a[:, :3], disk[:, None]], axis=1) \
            * pend_a[:, None]
        out["job_res"].append(job_res.astype(F32))
        h = int(rng.integers(3, H))
        cmask = rng.random((T, H)) < 0.8
        cmask[:, h:] = False
        cmask[~pend_a] = False
        out["cmask"].append(cmask)
        cap = np.zeros((H, 4), dtype=F32)
        cap[:h] = np.stack([rng.integers(4, 12, h) + 0.5,
                            rng.integers(1024, 4096, h) + 0.25,
                            np.zeros(h), np.full(h, 1e4)], axis=1)
        out["capacity"].append(cap)
        out["avail"].append((cap * F32(0.75)).astype(F32))
    fields = {k: np.stack(v) for k, v in out.items()}
    fields["num_considerable"] = np.array(
        [rng.integers(3, 12) for _ in range(P)], dtype=np.int32)
    fields["pool_quota"] = np.tile(np.array([[60.5, 1e6, INF, 40]], F32),
                                   (P, 1))
    fields["group_quota"] = np.tile(np.array([[90.5, INF, INF, INF]], F32),
                                    (P, 1))
    fields["group_id"] = np.array([0] * P, dtype=np.int32)
    return fields


_JAX = {}


def jax_dense_cycle(fields, cap, gpu_mode=False):
    key = (cap, gpu_mode)
    if key not in _JAX:
        mesh = Mesh(np.array(jax.devices()[:1]), (POOL_AXIS,))
        _JAX[key] = jax_make_pool_cycle(mesh, gpu_mode=gpu_mode,
                                        considerable_cap=cap)
    inp = JaxDenseInputs(**{k: jax.numpy.asarray(fields[k])
                            for k in JaxDenseInputs._fields})
    return jax.tree_util.tree_map(np.asarray, _JAX[key](inp))


COMPACT = ("queue_rows", "n_queue", "cand_row", "cand_assign", "cand_qpos")


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def dense_route(fields, cap):
    """The dense cycle's card route, here on the CPU."""
    return tpc.megacycle(tpc.wire_from_numpy(tpc.dense_wire(fields), "cpu"),
                         considerable_cap=cap, device="cpu")


@pytest.mark.parametrize("gpu_mode", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_dense_plain_cycle_matches_the_reference(seed, gpu_mode):
    fields = dense_world(seed)
    cap = 16
    ref = jax_dense_cycle(fields, cap, gpu_mode)
    got = tsh.make_pool_cycle(
        pool_mesh(1, "cpu"), gpu_mode=gpu_mode, considerable_cap=cap)(
            tsh.dense_inputs_from_numpy(fields, "cpu"))
    n = ref.n_queue
    for k in ("order", "num_ranked", "assign", "match_valid", "queue_ok",
              "accepted", "matched_usage", "total_matched", "n_queue",
              "cand_row", "cand_assign", "cand_qpos"):
        np.testing.assert_array_equal(_np(getattr(got, k)),
                                      getattr(ref, k), err_msg=k)
    np.testing.assert_array_equal(_np(got.dru), ref.dru)
    for p in range(len(n)):
        np.testing.assert_array_equal(_np(got.queue_rows)[p, :n[p]],
                                      ref.queue_rows[p, :n[p]])


@pytest.mark.parametrize("seed", range(6))
def test_dense_card_route_matches_the_reference(seed):
    """The card route on the CPU: the stage chain's plain versions over
    ``dense_wire``, equal to the reference's dense cycle on every compact
    output, with the gang outputs the no-op reduction."""
    fields = dense_world(seed, single_user_pool=seed % 2 == 0)
    cap = 16
    ref = jax_dense_cycle(fields, cap)
    got = dense_route(fields, cap)
    n = ref.n_queue
    np.testing.assert_array_equal(_np(got.n_queue), n)
    for k in ("cand_row", "cand_assign", "cand_qpos"):
        np.testing.assert_array_equal(_np(getattr(got, k)), getattr(ref, k),
                                      err_msg=k)
    for p in range(len(n)):
        np.testing.assert_array_equal(_np(got.queue_rows)[p, :n[p]],
                                      ref.queue_rows[p, :n[p]])
    np.testing.assert_array_equal(_np(got.cand_gang), _np(got.cand_assign))
    assert not _np(got.cand_dropped).any()


def test_dense_route_sees_the_running_base_of_a_single_user_pool():
    """A pool whose only user has running tasks and padding behind them:
    the dense segment of that user runs to the end of the padding (its
    first_idx is 0 there too), so the running base is read at the last
    row; the wire must not end the segment at the last real row."""
    fields = dense_world(11, P=1, T=64, single_user_pool=True)
    assert fields["valid"][0, -1] == False  # noqa: E712  (padding)
    ref = jax_dense_cycle(fields, 16)
    got = dense_route(fields, 16)
    np.testing.assert_array_equal(_np(got.cand_row), ref.cand_row)
    np.testing.assert_array_equal(_np(got.cand_assign), ref.cand_assign)


def test_single_pool_cycle_matches_the_reference():
    from cook_tpu.parallel.sharded import single_pool_cycle as jax_single
    fields = dense_world(5, P=1)
    one = {k: v[0] for k, v in fields.items()
           if k not in ("num_considerable", "pool_quota", "group_quota",
                        "group_id")}
    args = ("usage", "quota", "shares", "first_idx", "user_rank", "pending",
            "valid", "job_res", "cmask", "avail", "capacity")
    kw = ("enqueue_ok", "launch_ok", "tokens")
    ref = jax_single(*(jax.numpy.asarray(one[a]) for a in args),
                     **{k: jax.numpy.asarray(one[k]) for k in kw},
                     considerable_cap=32)
    t = tsh.dense_inputs_from_numpy(
        {**fields, **{k: fields[k] for k in fields}}, "cpu")
    got = tsh.single_pool_cycle(
        *(getattr(t, a)[0] for a in args),
        **{k: getattr(t, k)[0] for k in kw}, considerable_cap=32)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_make_pool_cycle_refuses_the_structured_dense_form():
    with pytest.raises(ValueError, match="compact"):
        tsh.make_pool_cycle(pool_mesh(1, "cpu"), structured=True)


# ------------------------------------------------------------ driver level
from test_torch_driver import (PORT, REF, WORLDS, counts,  # noqa: E402
                               launched, run_parity, states)
from test_torch_scheduler import drive, make_world, queues  # noqa: E402


def entity(spec):
    """``spec`` with ``columnar_index=False`` on both sides."""
    setup = spec.get("setup", lambda w, cfg: None)

    def both(w, cfg):
        setup(w, cfg)
        cfg.columnar_index = False
    return {**spec, "setup": both}


# the compaction world exercises the columnar index's row remap, which
# the entity pack never reads
ENTITY_WORLDS = sorted(n for n in WORLDS if n != "compaction")


@pytest.mark.parametrize("name", ENTITY_WORLDS)
def test_entity_pack_driver_parity(name):
    """The driver at depth 0 (``FusedCycleDriver.step``) on the entity
    pack, against the reference's ``step_cycle`` on its entity pack."""
    port = run_parity(entity(WORLDS[name]))
    assert not port.driver.stage(port.sched).groups[0].group[0].columnar


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", ["plain", "rate_limit", "rack_gang",
                                  "two_pools", "unique_group",
                                  "offensive", "pool_group_quota"])
def test_entity_pack_scheduler_parity(name, depth):
    """The port's ``Scheduler`` on the entity pack at pipeline depths 0
    and 2 against the reference's: launched pairs, counts, published
    queues (job lists here) and states every step, and the pipelined
    driver's conflict counters."""
    ref, port, _n = drive(entity(WORLDS[name]), depth, None)
    q = port.sched.pending_queues.get("default")
    assert isinstance(q, list)
    if depth:
        assert (port.sched._pipeline.conflicts_state,
                port.sched._pipeline.conflicts_resources) == \
            (ref.sched._pipeline.conflicts_state,
             ref.sched._pipeline.conflicts_resources)


def _complex_world(m, columnar, seed=7):
    """``tests/test_fused_cycle.build_complex_world`` in either package:
    gpu hosts and jobs, rack EQUALS constraints and a failed prior
    instance (novel host), one pool, six hosts, 18 jobs."""
    cfg = m.Config()
    cfg.columnar_index = columnar
    cfg.pipeline.depth = 0
    rng = np.random.default_rng(seed)
    store = m.Store()
    store.clock = lambda: 1_000_000
    store.put_pool(m.Pool(name="default"))
    hosts = [m.FakeHost(hostname=f"h{i}",
                        capacity=m.Resources(cpus=16.0, mem=16384.0,
                                             gpus=4.0 if i >= 4 else 0.0),
                        gpu_model="a100" if i >= 4 else "",
                        attributes={"rack": f"r{i % 2}"})
             for i in range(6)]
    cluster = m.FakeCluster("fake-1", hosts)
    if m is REF:
        import cook_tpu.sched
        sched = cook_tpu.sched.Scheduler(store, cfg, [cluster],
                                         rank_backend="tpu")
    else:
        import cook_tpu_torch.sched
        sched = cook_tpu_torch.sched.Scheduler(store, cfg, [cluster],
                                               rank_backend="tpu",
                                               device="cpu")
    jobs = []
    for i in range(18):
        kw = {}
        if i % 6 == 5:
            kw["resources"] = m.Resources(cpus=1.0, mem=256.0, gpus=1.0)
        else:
            kw["resources"] = m.Resources(
                cpus=float(rng.integers(1, 4)) + 0.1,
                mem=float(rng.integers(128, 1024)) + 0.3)
        if i % 5 == 4:
            kw["constraints"] = [m.Constraint(attribute="rack",
                                              operator="EQUALS",
                                              pattern="r1")]
        j = m.Job(uuid=f"00000000-0000-0000-0003-{i:012d}",
                  user=f"user{i % 3}", command="true", pool="default",
                  priority=int(rng.integers(0, 100)),
                  submit_time_ms=1000 + i, max_retries=3, **kw)
        jobs.append(j)
        store.create_jobs([j])
    store.launch_instance(jobs[0].uuid, "task-prior-0", "h0")
    store.update_instance_status("task-prior-0", m.InstanceStatus.FAILED,
                                 reason_code=m.Reasons.NON_ZERO_EXIT.code)
    return store, sched, jobs


def _decisions(store, jobs):
    out = {}
    for j in jobs:
        job = store.job(j.uuid)
        hosts = sorted(store.instance(t).hostname for t in job.instances
                       if store.instance(t).task_id != "task-prior-0")
        out[j.uuid] = (job.state.value, hosts)
    return out


def test_entity_pack_decides_as_the_columnar_pack():
    """The reference's ``test_columnar_vs_entity_fused``, in the port:
    both pack paths place the complex world identically, and each
    equals the reference's."""
    got = {}
    for m in (REF, PORT):
        for columnar in (True, False):
            store, sched, jobs = _complex_world(m, columnar)
            res = sched.step_cycle()
            got[m.root, columnar] = (
                _decisions(store, jobs),
                {p: [j.uuid for j in r.unmatched] for p, r in res.items()})
    assert got["cook_tpu_torch", False] == got["cook_tpu_torch", True]
    assert got["cook_tpu_torch", False] == got["cook_tpu", False]
    assert got["cook_tpu_torch", True] == got["cook_tpu", True]
    placed = [h for _s, h in got["cook_tpu_torch", False][0].values() if h]
    assert placed, "the complex world placed nothing"
    # the novel-host rule holds on the entity pack too
    assert "h0" not in got["cook_tpu_torch", False][0][
        "00000000-0000-0000-0003-000000000000"][1]
