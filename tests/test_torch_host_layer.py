"""The port's host layer (``state/``, ``utils/``, ``cluster/``,
``policy/``, ``config``, ``sched/constraints``, ``sched/elastic``)
against the JAX package's copies on the CPU, and the port's imports.

One sequence of store operations (create, launch, status updates, kill)
runs on both stores; the job and instance states and the columnar
index's pool columns must be equal.  Every relative import of the port,
including those inside functions, must resolve to a module that defines
the imported name.
"""

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

from test_torch_driver import PORT, REF, WORLDS, World, uuid

REPO = pathlib.Path(__file__).resolve().parent.parent


def sequence(m, seed=11):
    """Create 40 jobs (two pools, a gang group), launch 25, drive them
    through RUNNING to SUCCESS / FAILED / node loss, kill a few waiting
    and running jobs; return the store."""
    rng = np.random.default_rng(seed)
    store = m.Store()
    now = [5_000]
    store.clock = lambda: now[0]
    store.put_pool(m.Pool(name="default"))
    store.put_pool(m.Pool(name="beta", dru_mode=m.DruMode.GPU))
    g = m.Group(uuid="44444444-0000-0000-0000-000000000000", name="g",
                gang=True, gang_size=2)
    jobs = []
    for i in range(40):
        kw = {}
        if i in (3, 4):
            kw["group"] = g.uuid
            g.jobs.append(uuid(1, i))
        jobs.append(m.Job(
            uuid=uuid(1, i), user=f"u{i % 4}", command="x",
            pool="beta" if i % 5 == 0 else "default",
            priority=int(rng.integers(0, 100)), max_retries=2,
            resources=m.Resources(cpus=float(rng.integers(1, 8)) + 0.5,
                                  mem=float(rng.integers(64, 4096)),
                                  gpus=1.0 if i % 5 == 0 else 0.0),
            submit_time_ms=100 + i, **kw))
    store.create_jobs(jobs, groups=[g])
    store.set_share("u1", "default", {"cpus": 8.0, "mem": 4096.0})
    store.set_quota("u2", "default", {"cpus": 12.0}, count=5.0)
    for i in range(25):
        now[0] += 7
        store.launch_instance(uuid(1, i), f"task-{i}", f"h{i % 6}")
    S = m.InstanceStatus
    for i in range(20):
        now[0] += 11
        store.update_instance_status(f"task-{i}", S.RUNNING)
    for i in range(0, 20, 3):
        now[0] += 13
        store.update_instance_status(f"task-{i}", S.SUCCESS, exit_code=0)
    for i in range(1, 20, 5):
        now[0] += 13
        store.update_instance_status(
            f"task-{i}", S.FAILED, reason_code=m.Reasons.NODE_LOST.code)
    store.update_instance_status(
        "task-7", S.FAILED, reason_code=m.Reasons.NON_ZERO_EXIT.code,
        exit_code=3)
    for i in (2, 26, 30, 39):
        now[0] += 17
        store.kill_job(uuid(1, i))
    return store


def job_state(store, u):
    j = store.job(u)
    insts = []
    for t in j.instances:
        inst = store.instance(t)
        insts.append((t, inst.status.value, inst.hostname,
                      inst.reason_code, inst.exit_code, inst.start_time_ms,
                      inst.end_time_ms))
    return (j.state.value, j.user_killed, j.priority, j.pool, j.group,
            tuple(insts))


def test_store_sequence_parity():
    a, b = sequence(REF), sequence(PORT)
    for i in range(40):
        assert job_state(a, uuid(1, i)) == job_state(b, uuid(1, i)), i
    assert ([j.uuid for j in a.pending_jobs("default")]
            == [j.uuid for j in b.pending_jobs("default")])
    assert ([(j.uuid, i.task_id) for j, i in a.running_instances()]
            == [(j.uuid, i.task_id) for j, i in b.running_instances()])
    assert (a.get_quota("u2", "default") == b.get_quota("u2", "default"))
    assert (a.get_share("u1", "default") == b.get_share("u1", "default"))


@pytest.mark.parametrize("pool", ["default", "beta"])
def test_index_pool_columns_parity(pool):
    a, b = sequence(REF), sequence(PORT)
    ia, ib = a.ensure_index(), b.ensure_index()
    sa = ia.fused_arrays(pool, compact=True)
    sb = ib.fused_arrays(pool, compact=True)
    assert sorted(sa.arrays) == sorted(sb.arrays)
    for k in sa.arrays:
        np.testing.assert_array_equal(sa.arrays[k], sb.arrays[k], err_msg=k)
    for k in ("rows_s", "uuid_base", "user_base", "res_base", "disk_base",
              "complex_s"):
        np.testing.assert_array_equal(getattr(sa, k), getattr(sb, k),
                                      err_msg=k)
    assert list(sa.users) == list(sb.users)
    assert sa.compactions == sb.compactions
    np.testing.assert_array_equal(ia.pool_usage_base(pool),
                                  ib.pool_usage_base(pool))


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


def test_config_defaults_equal():
    assert _fields(REF.Config()) == _fields(PORT.Config())


@pytest.mark.parametrize("name", ["plain", "rack_gang", "checkpoint",
                                  "unique_group"])
def test_constraint_masks_parity(name):
    """``build_constraint_mask`` and ``validate_group_placement`` over a
    world's pending jobs and offers, after one cycle and a node loss."""
    import cook_tpu.sched.constraints as jc
    import cook_tpu_torch.sched.constraints as tc
    out = []
    for w, mod in ((World(REF, WORLDS[name], 9), jc),
                   (World(PORT, WORLDS[name], 9), tc)):
        w.cycle()
        WORLDS[name].get("between", lambda w, c: None)(w, 0)
        w.churn(10)
        jobs = w.store.pending_jobs("default")
        offers = w.cluster.pending_offers("default")
        matcher = (w.sched.matcher if w.m is REF else w.driver.matcher)
        ctx = matcher._constraint_context(jobs, {})
        mask = mod.build_constraint_mask(jobs, offers, ctx)
        assign = np.arange(len(jobs), dtype=np.int32) % max(len(offers), 1)
        out.append((mask, mod.validate_group_placement(jobs, assign, offers,
                                                       ctx)))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def _relative_imports():
    """(importing module, level, target, names) of every ``from .x
    import y`` of the port, at any depth of the tree."""
    root = REPO / "cook_tpu_torch"
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
            pkg = parts
        else:
            pkg = parts[:-1]
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                base = pkg[:len(pkg) - (node.level - 1)]
                target = ".".join(base + ([node.module] if node.module
                                          else []))
                yield (".".join(parts), node.lineno, target,
                       [a.name for a in node.names])


IMPORTS = list(_relative_imports())


def test_lazy_imports_are_walked():
    # the walk sees imports inside functions too (examples: the store's
    # fault injector and index, the driver's gang and ranker imports)
    seen = {(mod, tgt) for mod, _ln, tgt, _n in IMPORTS}
    assert ("cook_tpu_torch.state.store", "cook_tpu_torch.state.index") \
        in seen
    assert ("cook_tpu_torch.sched.fused", "cook_tpu_torch.ops.delta") in seen
    # the leader's planes: the monitor's lazy imports of the request
    # observer, the saturation layer and the partition idiom
    for mod, tgt in (("sched.monitor", "rest.instrument"),
                     ("sched.monitor", "sched.fleet"),
                     ("sched.admission", "state.partition"),
                     ("sched.fleet", "state.partition"),
                     ("sched.scheduler", "sched.admission"),
                     # the simulator and the REST plane
                     ("sim.overload", "rest.instrument"),
                     ("sim.__main__", "sim.overload"),
                     ("rest.api", "sched.admission"),
                     ("rest.api", "state.partition"),
                     ("rest.instrument", "rest.api"),
                     ("rest.task_stats", "state.partition"),
                     ("sched.unscheduled", "sched.ranker"),
                     ("client", "utils.retry"),
                     # the node, its HA state plane and the operators' tools
                     ("daemon", "sched.fleet"),
                     ("daemon", "state.replication"),
                     ("daemon", "state.read_replica"),
                     ("rest.api", "state.replication"),
                     ("rest.api", "daemon"),
                     ("state.read_replica", "state.partition"),
                     ("state.read_replica", "state.replication"),
                     ("state.repair", "state.replication"),
                     ("state.replication", "native.build"),
                     ("sched.election", "utils.faults"),
                     ("sched.election", "utils.fsatomic"),
                     ("cli.main", "agent.file_server"),
                     ("cli.main", "utils.tracing"),
                     ("sim.system", "client"),
                     ("sim.crashpoint", "state.repair"),
                     ("sim.crashpoint", "state.replication"),
                     ("sim.__main__", "sim.crashpoint")):
        assert (f"cook_tpu_torch.{mod}", f"cook_tpu_torch.{tgt}") in seen
    assert len(IMPORTS) > 100


@pytest.mark.parametrize("mod,line,target,names", IMPORTS,
                         ids=[f"{m}:{ln}" for m, ln, _t, _n in IMPORTS])
def test_relative_import_resolves(mod, line, target, names):
    """Every relative import of the port names a module that exists and
    defines what is imported (a submodule counts), so a copy that drops
    a module a rarely run branch needs fails here."""
    module = importlib.import_module(target)
    for name in names:
        if hasattr(module, name):
            continue
        importlib.import_module(f"{target}.{name}")
