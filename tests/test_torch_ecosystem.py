"""The port's ecosystem integrations (``cook_tpu_torch/ecosystem``:
``ServiceFarm``, the Dask ``CookCluster`` and ``SparkOnCook``) against
the JAX package's, on the CPU, each over its own package's REST node
and its own package's ``JobClient``.

Every scenario of ``tests/test_ecosystem.py`` runs once on each side, on
the reference test's world (four fake hosts of 16 CPUs and 16 GiB, the
split CPU path, the port's scheduler on ``device="cpu"``).  Each scenario
returns a transcript: every farm call's result (fleet uuids, statuses,
resolved addresses, worker commands), exceptions by type and message,
the job documents the client reads back, and the (job uuid, hostname)
pairs of each cycle.  The two transcripts must be equal: every
comparison is exact.  Job uuids come from ``uuid.uuid4()`` in each
package's client; ``seeded_uuids`` hands both sides one seeded sequence
there and in the server's ``new_uuid``, inside the test only.

``dask`` is not installed, so ``CookCluster.adapt`` takes its no-dask
branch on both sides.
"""

import importlib

import pytest

from test_torch_jobclient import REPO, World, caught, run_both


def eco(p):
    return importlib.import_module(f"{p.root}.ecosystem")


def client(w, user):
    return importlib.import_module(f"{w.p.root}.client").JobClient(
        w.server.url, user=user)


def eco_world(p):
    return World(p, n_hosts=4, cpus=16, mem=16384)


def cycle(w):
    """``step_rank`` then ``step_match``: the launched (job uuid,
    hostname) pairs by pool."""
    w.sched.step_rank()
    out = {}
    for pool, res in sorted(w.sched.step_match().items()):
        out[pool] = sorted((w.store.instance(t).job_uuid,
                            w.store.instance(t).hostname)
                           for t in res.launched_task_ids)
    return out


def states(c, uuids):
    return {j["uuid"]: j["state"] for j in c.query(uuids)}


# ------------------------------------------------------------ service farm
def s_scale_up_and_down(w):
    c = client(w, "svc")
    farm = eco(w.p).ServiceFarm(c, "workers", lambda i: f"worker --id {i}",
                                spec={"cpus": 1.0, "mem": 256.0})
    fleet = farm.scale(3)
    out = [fleet, cycle(w), farm.running()]
    kept = farm.scale(1)
    out += [kept, farm.status(), states(c, fleet)]
    assert sorted(out[-1].values()) == ["failed", "failed", "running"]
    return out


def s_worker_commands_carry_index(w):
    c = client(w, "svc")
    farm = eco(w.p).ServiceFarm(c, "idx", lambda i: f"run --rank {i}")
    fleet = farm.scale(2)
    jobs = c.query(fleet)
    assert {j["command"] for j in jobs} == {"run --rank 0", "run --rank 1"}
    return [fleet, jobs]


def s_readoption_after_restart(w):
    c = client(w, "svc")
    E = eco(w.p)
    farm = E.ServiceFarm(c, "stable", lambda i: "serve")
    first = farm.scale(2)
    out = [first, cycle(w)]
    farm2 = E.ServiceFarm(c, "stable", lambda i: "serve")
    again = farm2.scale(2)
    grown = farm2.scale(3)
    assert set(again) == set(first) and len(set(grown)) == 3
    return out + [sorted(again), sorted(grown), c.query(grown)]


def s_failed_worker_replaced(w):
    c = client(w, "svc")
    farm = eco(w.p).ServiceFarm(c, "heal", lambda i: "serve")
    fleet = farm.scale(2)
    out = [fleet, cycle(w)]
    job = w.store.job(fleet[0])
    w.cluster.complete_task(job.instances[-1], exit_code=1)
    new_fleet = farm.scale(2)
    assert len(new_fleet) == 2 and fleet[0] not in new_fleet
    return out + [new_fleet, states(c, fleet + new_fleet)]


def s_close_kills_fleet(w):
    c = client(w, "svc")
    with eco(w.p).ServiceFarm(c, "tmp", lambda i: "serve") as farm:
        fleet = farm.scale(2)
        pairs = cycle(w)
    assert set(states(c, fleet).values()) == {"failed"}
    return [fleet, pairs, c.query(fleet)]


# -------------------------------------------------------------------- dask
def s_scheduler_then_workers(w):
    c = client(w, "dask")
    with eco(w.p).CookCluster(c, name="d1") as cluster:
        fleet = cluster._sched_farm.scale(1)
        out = [fleet, cycle(w)]
        addr = cluster.start_scheduler(timeout_s=5.0)
        assert addr.startswith("tcp://h")
        workers = cluster.scale(3)
        out += [addr, workers, cycle(w), cluster._workers.running(),
                [j["command"] for j in c.query(workers)],
                cluster.workers_status()]
    return out + [c.query(fleet + workers)]


def s_adapt_without_dask_applies_minimum(w):
    c = client(w, "dask")
    cluster = eco(w.p).CookCluster(c, name="d2")
    out = [cluster._sched_farm.scale(1), cycle(w),
           cluster.start_scheduler(timeout_s=5.0)]
    out.append(caught(lambda: cluster.adapt(minimum=2, maximum=8)))
    out.append(cluster._workers.size())
    cluster.scale(4)
    out.append(caught(lambda: cluster.adapt(minimum=2, maximum=8)))
    assert cluster._workers.size() == 4
    out.append(cluster._workers.fleet())
    cluster.close()
    return out


def s_scheduler_completing_early_raises(w):
    c = client(w, "dask")
    cluster = eco(w.p).CookCluster(c, name="d3")
    [uuid] = cluster._sched_farm.scale(1)
    pairs = cycle(w)
    w.cluster.complete_task(w.store.job(uuid).instances[-1], exit_code=1)
    got = caught(lambda: cluster.start_scheduler(timeout_s=1.0))
    assert got[0] == "raised"
    return [uuid, pairs, got]


# ------------------------------------------------------------------- spark
def s_master_then_workers_then_submit(w):
    c = client(w, "spark")
    with eco(w.p).SparkOnCook(c, name="s1") as cluster:
        fleet = cluster._master_farm.scale(1)
        out = [fleet, cycle(w)]
        url = cluster.start_master(timeout_s=5.0)
        assert url.startswith("spark://h")
        workers = cluster.scale(3)
        out += [url, c.query(fleet), workers, cycle(w),
                cluster._workers.running(),
                [j["command"] for j in c.query(workers)]]
        app = cluster.submit("wordcount.py", app_args="in.txt out",
                             submit_args="--deploy-mode client")
        out += [app, c.query([app]), cycle(w)]
    return out + [c.query(fleet + workers)]


def s_master_completing_early_raises(w):
    c = client(w, "spark")
    cluster = eco(w.p).SparkOnCook(c, name="s2")
    [uuid] = cluster._master_farm.scale(1)
    pairs = cycle(w)
    w.cluster.complete_task(w.store.job(uuid).instances[-1], exit_code=1)
    got = caught(lambda: cluster.start_master(timeout_s=1.0))
    assert got[0] == "raised"
    return [uuid, pairs, got]


def s_readoption_same_name(w):
    c = client(w, "spark")
    E = eco(w.p)
    c1 = E.SparkOnCook(c, name="s3")
    out = [c1._master_farm.scale(1), cycle(w),
           c1.start_master(timeout_s=5.0)]
    first = c1.scale(2)
    out += [first, cycle(w)]
    c2 = E.SparkOnCook(c, name="s3")
    out += [c2._master_farm.scale(1), c2.start_master(timeout_s=5.0)]
    again = c2.scale(2)
    assert set(again) == set(first)
    c2.close()
    return out + [sorted(again), c.query(first)]


def s_fractional_worker_cpus_refused(w):
    c = client(w, "spark")
    got = caught(lambda: eco(w.p).SparkOnCook(
        c, name="s4", worker_spec={"cpus": 0.5, "mem": 512.0}))
    assert got[:2] == ["raised", "ValueError"] and "whole number" in got[2]
    return [got]


def s_wait_workers(w):
    c = client(w, "spark")
    cluster = eco(w.p).SparkOnCook(c, name="s5")
    out = [cluster._master_farm.scale(1), cycle(w),
           cluster.start_master(timeout_s=5.0), cluster.scale(2), cycle(w)]
    out.append(sorted(cluster.wait_workers(2, timeout_s=5.0) or []))
    cluster.close()
    return out


SCRIPTS = {name[2:]: fn for name, fn in sorted(globals().items())
           if name.startswith("s_")}


def test_every_reference_scenario_has_a_script():
    ref = (REPO / "tests/test_ecosystem.py").read_text()
    names = {line.split("(")[0].split()[-1][len("test_"):]
             for line in ref.splitlines()
             if line.lstrip().startswith("def test_")}
    assert names == set(SCRIPTS)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scenario_parity(name):
    ref, port = run_both(SCRIPTS[name], world=eco_world)
    assert port == ref


def test_dask_scale_down_by_address_parity():
    """``CookCluster.scale_down`` (what dask's ``Adaptive`` calls with
    worker addresses) needs no dask: both sides kill the same members
    for a (host, port) address whose port no instance holds (the fake
    hosts assign none) and for a host-only one."""
    def script(w):
        c = client(w, "dask")
        cluster = eco(w.p).CookCluster(c, name="d4")
        out = [cluster._sched_farm.scale(1), cycle(w),
               cluster.start_scheduler(timeout_s=5.0)]
        workers = cluster.scale(6)
        out += [workers, cycle(w)]
        docs = {j["uuid"]: j for j in c.query(workers)}
        addrs = [f"tcp://{docs[workers[2]]['instances'][-1]['hostname']}:9",
                 docs[workers[4]]["instances"][-1]["hostname"]]
        cluster.scale_down(addrs)
        out += [addrs, sorted(cluster._workers.fleet()),
                states(c, workers)]
        cluster.close()
        return out

    ref, port = run_both(script, world=eco_world)
    assert port == ref
    assert list(ref[-1].values()).count("failed") == 2
