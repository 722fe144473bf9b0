"""The port's Kubernetes backend (``cook_tpu_torch/cluster/k8s``) and its
lease election against the JAX package's (``cook_tpu/cluster/k8s``) on
the CPU, each over its own package's in-process ``FakeKubernetesApi``.

Every case runs one scenario on the reference, then on the port, holds
the reference's own assertions on both, and compares what a caller sees:

- every case of ``tests/test_k8s.py``: offers synthesized from nodes less
  live pods, the controller's pod lifecycle through the ``Scheduler``
  (the port's on the CPU), the kill races, startup adoption, synthetic
  pods and their reaping, ``max_launchable``, the pod compiler's
  filters, and the k8s policy in ``/settings``;
- the 35 cells of the controller's (expected x actual) table and the
  other cases of ``tests/test_k8s_controller_table.py``;
- the pod compiler's goldens (``tests/test_pod_spec_golden.py``): the
  port's pod bodies equal the reference's byte for byte;
- ``tests/test_gang.py::TestAutoscaleRouting``;
- ``tests/test_ha.py::TestLeaseElection`` and the lease-annotation case
  of ``tests/test_failover.py``, each package's elector over its own
  package's fake.

Task ids are random in both packages, so pods and instances are named by
their job.  Every test starts and ends with both packages' breakers,
fault injectors and flight recorders in their default state.
"""

import importlib
import json
import time
import types

import pytest


def side(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("k8s", "cluster.k8s"),
                      ("cc", "cluster.k8s.compute_cluster"),
                      ("ctl", "cluster.k8s.controller"),
                      ("fake", "cluster.k8s.fake_api"),
                      ("pod_spec", "cluster.k8s.pod_spec"),
                      ("state", "state"), ("schema", "state.schema"),
                      ("config", "config"), ("sched", "sched"),
                      ("rest", "rest"), ("daemon", "daemon"),
                      ("election", "sched.election"),
                      ("incremental", "policy.incremental"),
                      ("retry", "utils.retry"), ("faults", "utils.faults"),
                      ("flight", "utils.flight")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    ns.kw = {"device": "cpu"} if root == "cook_tpu_torch" else {}
    return ns


SIDES = (side("cook_tpu"), side("cook_tpu_torch"))
R, P = SIDES


def fresh_planes():
    for p in SIDES:
        p.retry.breakers.reset()
        p.faults.injector.clear()
        p.flight.recorder.reset()


@pytest.fixture(autouse=True)
def _fresh_planes():
    fresh_planes()
    yield
    fresh_planes()


def both(scenario, *args, **kw):
    """``scenario(p, *args, **kw)`` on the reference, then on the port;
    asserts the two observations equal and returns the reference's."""
    out = [scenario(p, *args, **kw) for p in SIDES]
    assert out[1] == out[0]
    return out[0]


def job_uuid(i):
    return f"00000000-0000-4000-8000-{i:012d}"


def make_job(p, i, user="alice", cpus=1.0, mem=100.0, **kw):
    return p.state.Job(uuid=job_uuid(i), user=user, command="x",
                       resources=p.state.Resources(cpus=cpus, mem=mem), **kw)


def scheduler(p, store, clusters, cfg=None):
    if cfg is None:
        cfg = p.config.Config()
    cfg.default_matcher.backend = "cpu"
    return p.sched.Scheduler(store, cfg, clusters, rank_backend="cpu",
                             **p.kw)


def k8s_system(p, n_nodes=2, cpus=8.0, mem=8192.0):
    api = p.fake.FakeKubernetesApi()
    for i in range(n_nodes):
        api.add_node(p.fake.FakeNode(name=f"node{i}", cpus=cpus, mem=mem))
    store = p.state.Store()
    cluster = p.cc.KubernetesCluster("k8s-1", api=api, store=store)
    return api, store, cluster, scheduler(p, store, [cluster])


def inst_view(store, tid):
    i = store.instance(tid)
    return (i.job_uuid, i.status.value, i.reason_code, i.exit_code,
            i.hostname)


def pod_view(pod, names=None):
    """A pod as a caller sees it; a task id is named by its job."""
    if pod is None:
        return None
    name = (names or {}).get(pod.name, pod.name)
    return (name, pod.node_name, pod.phase, pod.cpus, pod.mem, pod.gpus,
            pod.synthetic, dict(pod.labels), pod.exit_code, pod.deleted)


def offers_view(offers):
    return sorted((o.hostname, o.pool, o.available.cpus, o.available.mem,
                   o.available.gpus, o.capacity.cpus, o.capacity.mem,
                   o.task_count, dict(o.attributes)) for o in offers)


def rank_match(p, sched):
    sched.step_rank()
    return sched.step_match()["default"]


# ------------------------------------------------ tests/test_k8s.py
def test_offer_capacity_minus_consumption():
    def scenario(p):
        api, store, cluster, _ = k8s_system(p)
        api.create_pod(p.fake.FakePod(name="existing", node_name="node0",
                                      phase="Running", cpus=2.0,
                                      mem=1024.0))
        offers = {o.hostname: o for o in cluster.pending_offers("default")}
        assert offers["node0"].available.cpus == 6.0
        assert offers["node0"].available.mem == 7168.0
        assert offers["node1"].available.cpus == 8.0
        assert offers["node0"].task_count == 1
        return offers_view(offers.values())
    both(scenario)


def test_offer_unschedulable_node_excluded():
    def scenario(p):
        api, _s, cluster, _ = k8s_system(p)
        api.add_node(p.fake.FakeNode(name="cordoned", cpus=8, mem=8192,
                                     unschedulable=True))
        api.add_node(p.fake.FakeNode(name="tainted", cpus=8, mem=8192,
                                     taints=["maintenance"]))
        offers = cluster.pending_offers("default")
        names = {o.hostname for o in offers}
        assert "cordoned" not in names and "tainted" not in names
        return offers_view(offers)
    both(scenario)


def test_full_pod_lifecycle():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        [uuid] = store.create_jobs([make_job(p, 0)])
        res = rank_match(p, sched)
        [tid] = res.launched_task_ids
        names = {tid: uuid}
        pod = api.pod(tid)
        assert pod is not None and pod.node_name is not None
        out = [pod_view(pod, names), store.job(uuid).state.value]
        assert store.job(uuid).state is p.state.JobState.RUNNING
        api.step()
        assert store.instance(tid).status is p.state.InstanceStatus.RUNNING
        assert store.instance(tid).hostname == pod.node_name
        out.append(inst_view(store, tid))
        api.finish_pod(tid, exit_code=0)
        assert store.instance(tid).status is p.state.InstanceStatus.SUCCESS
        assert store.job(uuid).state is p.state.JobState.COMPLETED
        assert api.pod(tid) is None
        assert tid not in cluster.controller.expected
        return out + [inst_view(store, tid), store.job(uuid).state.value]
    both(scenario)


def test_pod_failure_marks_instance_failed():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        [uuid] = store.create_jobs([make_job(p, 0, max_retries=2)])
        [tid] = rank_match(p, sched).launched_task_ids
        api.step()
        api.finish_pod(tid, exit_code=3)
        inst = store.instance(tid)
        assert inst.status is p.state.InstanceStatus.FAILED
        assert inst.exit_code == 3
        assert store.job(uuid).state is p.state.JobState.WAITING
        return inst_view(store, tid), store.job(uuid).state.value
    both(scenario)


def test_node_lost_is_mea_culpa():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        [uuid] = store.create_jobs([make_job(p, 0, max_retries=1)])
        [tid] = rank_match(p, sched).launched_task_ids
        api.step()
        api.lose_node(store.instance(tid).hostname or "node0")
        inst = store.instance(tid)
        assert inst.status is p.state.InstanceStatus.FAILED
        assert inst.reason_code == p.state.Reasons.NODE_LOST.code
        assert store.job(uuid).state is p.state.JobState.WAITING
        return (inst_view(store, tid), store.job(uuid).state.value,
                sorted(n.name for n in api.nodes()))
    both(scenario)


def test_user_kill_deletes_pod():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        [uuid] = store.create_jobs([make_job(p, 0)])
        [tid] = rank_match(p, sched).launched_task_ids
        api.step()
        store.kill_job(uuid)
        assert store.job(uuid).state is p.state.JobState.COMPLETED
        assert api.pod(tid) is None
        return inst_view(store, tid), store.job(uuid).state.value
    both(scenario)


def test_kill_before_pod_materializes():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        cluster.controller.set_expected("ghost-task",
                                        p.ctl.CookExpected.KILLED)
        cluster.controller.process("ghost-task")
        assert "ghost-task" not in cluster.controller.expected
        return sorted(cluster.controller.expected)
    both(scenario)


def test_untracked_live_cook_pod_killed():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        api.create_pod(p.fake.FakePod(name="stray", node_name="node0",
                                      phase="Running", cpus=1, mem=64,
                                      labels={"cook/job": "ghost"}))
        assert api.pod("stray") is None
        return [pod_view(x) for x in api.pods()]
    both(scenario)


def test_foreign_pod_left_alone():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        api.create_pod(p.fake.FakePod(name="daemonset-thing",
                                      node_name="node0", phase="Running",
                                      cpus=1, mem=64))
        cluster.controller.scan_all()
        assert api.pod("daemonset-thing") is not None
        return pod_view(api.pod("daemonset-thing"))
    both(scenario)


def test_leader_restart_adopts_running_pods():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        [uuid] = store.create_jobs([make_job(p, 0)])
        [tid] = rank_match(p, sched).launched_task_ids
        api.step()
        assert store.instance(tid).status is p.state.InstanceStatus.RUNNING
        blob = store.snapshot()
        cluster.shutdown()
        store2 = p.state.Store.restore(blob)
        cluster2 = p.cc.KubernetesCluster("k8s-1", api=api, store=store2)
        scheduler(p, store2, [cluster2])
        expected = {uuid if k == tid else k: v.state.value
                    for k, v in cluster2.controller.expected.items()}
        api.finish_pod(tid, exit_code=0)
        assert store2.instance(tid).status is \
            p.state.InstanceStatus.SUCCESS
        assert store2.job(uuid).state is p.state.JobState.COMPLETED
        return expected, inst_view(store2, tid), inst_view(store, tid)
    both(scenario)


def synthetic_view(api):
    """The synthetic pods, less their ``cook/created-ms`` annotation when
    the scheduler's autoscale stamps it from the host clock."""
    out = []
    for x in api.pods():
        if x.synthetic:
            notes = dict(x.annotations)
            created = int(notes.pop("cook/created-ms"))
            out.append((x.name, x.cpus, x.mem, dict(x.labels), notes,
                        x.node_name, created if created == 0 else "clock"))
    return sorted(out)


def test_synthetic_pods_created_for_unmatched():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p, n_nodes=1, cpus=2.0)
        jobs = [make_job(p, i, cpus=2.0) for i in range(3)]
        store.create_jobs(jobs)
        res = rank_match(p, sched)
        assert len(res.unmatched) == 2
        created = cluster.autoscale("default", res.unmatched)
        assert created == 2
        synthetic = [x for x in api.pods() if x.synthetic]
        assert len(synthetic) == 2
        assert all(x.cpus == 2.0 for x in synthetic)
        view = synthetic_view(api)
        again = cluster.autoscale("default", res.unmatched)
        assert again == 0
        reaped = cluster.reap_synthetic_pods([j.uuid for j in jobs])
        assert reaped == 2
        return (sorted(j.uuid for j in res.unmatched), created, view,
                again, reaped, synthetic_view(api))
    both(scenario)


def test_synthetic_pods_excluded_from_offers_accounting():
    def scenario(p):
        api, store, cluster, sched = k8s_system(p, n_nodes=1, cpus=8.0)
        cluster.autoscale("default", [make_job(p, 0, cpus=4.0)])
        [pod] = [x for x in api.pods() if x.synthetic]
        assert pod.name not in cluster.controller.expected
        cluster.controller.scan_all()
        assert api.pod(pod.name) is not None
        return pod_view(pod), offers_view(cluster.pending_offers("default"))
    both(scenario)


def test_match_cycle_triggers_autoscaling():
    def scenario(p):
        api = p.fake.FakeKubernetesApi()
        api.add_node(p.fake.FakeNode(name="node0", cpus=2.0, mem=8192.0))
        store = p.state.Store()
        cluster = p.cc.KubernetesCluster("k8s-1", api=api, store=store)
        cfg = p.config.Config(autoscaling_enabled=True)
        sched = scheduler(p, store, [cluster], cfg)
        store.create_jobs([make_job(p, i, cpus=2.0) for i in range(3)])
        first = rank_match(p, sched)
        synthetic = synthetic_view(api)
        assert len(synthetic) == 2
        api.add_node(p.fake.FakeNode(name="node1", cpus=8.0, mem=16384.0))
        res = rank_match(p, sched)
        assert len(res.launched_task_ids) == 2
        assert [x for x in api.pods() if x.synthetic] == []
        return (sorted(first.launched_job_uuids), synthetic,
                sorted(res.launched_job_uuids),
                sorted((x.labels.get("cook/job"), x.node_name)
                       for x in api.pods()))
    both(scenario)


def test_max_launchable_headroom():
    def scenario(p):
        api, store, cluster, _ = k8s_system(p, n_nodes=2)
        cluster.max_pods_per_node = 3
        out = [cluster.max_launchable("default")]
        api.create_pod(p.fake.FakePod(name="p1", node_name="node0",
                                      phase="Running", cpus=1, mem=10))
        out.append(cluster.max_launchable("default"))
        cluster.max_total_pods = 2
        out.append(cluster.max_launchable("default"))
        assert out == [6, 5, 1]
        return out
    both(scenario)


def test_ports_and_uris_compiled_into_pod():
    def scenario(p):
        job = p.state.Job(uuid=job_uuid(0), user="alice", command="serve",
                          ports=2,
                          uris=[{"value": "/data/a.bin"},
                                {"value": "https://x/b.tgz",
                                 "extract": True}],
                          resources=p.state.Resources(cpus=1.0, mem=64.0))
        spec = p.pod_spec.build_pod_spec(job, "default")
        main = spec["containers"][0]
        assert spec["port_count"] == 2
        assert {"name": "COOK_PORT_COUNT", "value": "2"} in main["env"]
        fetch = [c for c in spec["init_containers"]
                 if c["name"] == "cook-fetch"]
        assert len(fetch) == 1
        assert "/data/a.bin" in fetch[0]["env"][0]["value"]
        assert "https://x/b.tgz" in fetch[0]["env"][0]["value"]
        assert fetch[0]["volume_mounts"][0]["name"] == "cook-workdir"
        return json.dumps(spec)
    both(scenario)


def test_blocklisted_label_excludes_node_from_offers():
    def scenario(p):
        api = p.fake.FakeKubernetesApi()
        api.add_node(p.fake.FakeNode(name="good", cpus=8, mem=8192))
        api.add_node(p.fake.FakeNode(name="cordoned", cpus=8, mem=8192,
                                     labels={"maintenance": "true"}))
        cluster = p.cc.KubernetesCluster(
            "k1", api=api, node_blocklist_labels=["maintenance"])
        cluster.initialize(lambda *a, **k: None)
        offers = cluster.pending_offers("default")
        assert {o.hostname for o in offers} == {"good"}
        return offers_view(offers)
    both(scenario)


def test_disallowed_paths_and_vars_filtered_out_of_pod_spec():
    def scenario(p):
        job = p.state.Job(
            uuid="u-1", user="alice", command="x",
            resources=p.state.Resources(cpus=1.0, mem=64.0),
            env={"OK_VAR": "1", "INJECTED": "nope"},
            container={"image": "img", "volumes": [
                {"host-path": "/data", "container-path": "/data"},
                {"host-path": "/tmp", "container-path": "/managed"},
                "/scratch:/scratch"]})
        spec = p.pod_spec.build_pod_spec(
            job, "default", sidecar=False,
            disallowed_container_paths={"/managed", "/scratch"},
            disallowed_var_names={"INJECTED"})
        [c] = spec["containers"]
        mounts = {m["mount_path"] for m in c["volume_mounts"]}
        assert "/data" in mounts
        assert "/managed" not in mounts and "/scratch" not in mounts
        names = {e["name"] for e in c["env"]}
        assert "OK_VAR" in names and "INJECTED" not in names
        return json.dumps(spec)
    both(scenario)


def test_cluster_threads_config_and_settings_reports_it():
    def scenario(p):
        store = p.state.Store()
        cluster = p.cc.KubernetesCluster(
            "k8s", store=store, disallowed_container_paths=["/managed"],
            disallowed_var_names=["INJECTED"])
        cfg = p.config.Config()
        sched = scheduler(p, store, [cluster], cfg)
        s = p.rest.CookApi(store, scheduler=sched, config=cfg).settings()
        assert s["kubernetes"]["disallowed-container-paths"] == ["/managed"]
        assert s["kubernetes"]["disallowed-var-names"] == ["INJECTED"]
        return s["kubernetes"]
    both(scenario)


def test_env_parameter_cannot_bypass_filters():
    def scenario(p):
        job = p.state.Job(
            uuid="u-2", user="alice", command="x",
            resources=p.state.Resources(cpus=1.0, mem=64.0),
            container={"image": "img", "parameters": [
                {"key": "env", "value": "INJECTED=evil"},
                {"key": "env", "value": "COOK_JOB_UUID=forged"},
                {"key": "env", "value": "FINE=yes"}]})
        spec = p.pod_spec.build_pod_spec(job, "default", sidecar=False,
                                         disallowed_var_names={"INJECTED"})
        [c] = spec["containers"]
        env = {e["name"]: e.get("value") for e in c["env"]}
        assert env["FINE"] == "yes"
        assert "INJECTED" not in env
        assert env["COOK_JOB_UUID"] == "u-2"
        return json.dumps(spec)
    both(scenario)


def test_api_only_node_reports_kubernetes_settings_from_config():
    def scenario(p):
        cfg = p.config.Config()
        cfg.kubernetes_disallowed_container_paths = ["/managed"]
        cfg.kubernetes_disallowed_var_names = ["INJECTED"]
        s = p.rest.CookApi(p.state.Store(), scheduler=None,
                           config=cfg).settings()
        assert s["kubernetes"]["disallowed-container-paths"] == ["/managed"]
        assert s["kubernetes"]["disallowed-var-names"] == ["INJECTED"]
        return s["kubernetes"]
    both(scenario)


def test_scheduler_config_threads_into_built_clusters():
    def scenario(p):
        cfg = p.daemon.build_scheduler_config({
            "kubernetes": {"disallowed_container_paths": ["/managed"],
                           "disallowed_var_names": ["INJECTED"]}})
        factory = f"{p.root}.cluster.k8s.compute_cluster.factory"
        [cluster] = p.daemon.build_clusters(
            [{"factory": factory, "kwargs": {"name": "k8s-a"}}],
            p.state.Store(), config=cfg)
        assert type(cluster).__module__ == f"{p.root}.cluster.k8s." \
                                           "compute_cluster"
        assert cluster.disallowed_container_paths == {"/managed"}
        assert cluster.disallowed_var_names == {"INJECTED"}
        [cluster2] = p.daemon.build_clusters(
            [{"factory": factory,
              "kwargs": {"name": "k8s-b",
                         "disallowed_var_names": ["OTHER"]}}],
            p.state.Store(), config=cfg)
        assert cluster2.disallowed_var_names == {"OTHER", "INJECTED"}
        assert cluster2.disallowed_container_paths == {"/managed"}
        return [(c.name, sorted(c.disallowed_container_paths),
                 sorted(c.disallowed_var_names))
                for c in (cluster, cluster2)]
    both(scenario)


def test_workdir_overlap_volume_dropped():
    def scenario(p):
        workdir = p.pod_spec.COOK_WORKDIR
        job = p.state.Job(
            uuid="u-3", user="alice", command="x",
            resources=p.state.Resources(cpus=1.0, mem=64.0),
            container={"image": "img", "volumes": [
                {"host-path": "/x", "container-path": workdir},
                {"host-path": "/y", "container-path": "/y"}]})
        spec = p.pod_spec.build_pod_spec(job, "default", sidecar=False)
        [c] = spec["containers"]
        paths = [m["mount_path"] for m in c["volume_mounts"]]
        assert paths.count(workdir) == 1
        assert "/y" in paths
        return json.dumps(spec)
    both(scenario)


def test_user_volume_colliding_with_system_mounts_dropped():
    def scenario(p):
        job = p.state.Job(
            uuid="u-4", user="alice", command="x",
            resources=p.state.Resources(cpus=1.0, mem=64.0),
            labels={"shm-size-mb": "64"},
            container={"image": "img", "volumes": [
                {"host-path": "/a", "container-path": "/dev/shm"},
                {"host-path": "/b", "container-path": "/data"},
                {"host-path": "/c", "container-path": "/data"}]})
        spec = p.pod_spec.build_pod_spec(job, "default", sidecar=False)
        [c] = spec["containers"]
        paths = [m["mount_path"] for m in c["volume_mounts"]]
        assert paths.count("/dev/shm") == 1
        assert paths.count("/data") == 1
        shm = [m for m in c["volume_mounts"]
               if m["mount_path"] == "/dev/shm"][0]
        assert shm["name"] == "shm"
        assert len([v for v in spec["volumes"]
                    if v["name"].startswith("uservol-")]) == 1
        return json.dumps(spec)
    both(scenario)


# ------------------------------------------------ the controller's table
POD = "pod-1"


class Recorder:
    def __init__(self):
        self.calls = []

    def started(self, name):
        self.calls.append("started")

    def completed(self, name, exit_code, reason):
        self.calls.append(("completed", reason))

    def killed(self, name, reason):
        self.calls.append(("killed", reason))

    def preempted(self, name):
        self.calls.append("preempted")


def setup_cell(p, expected, actual, *, sticky=True, old_deletion=False,
               with_launch_pod=True, clock_ms=0):
    """``expected`` and ``actual`` by name: each package has its enums."""
    E, A = p.ctl.CookExpected, p.ctl.PodState
    expected, actual = E[expected], A[actual]
    api = p.fake.FakeKubernetesApi()
    api.sticky_deletion = sticky
    rec = Recorder()
    ctl = p.ctl.PodController(
        api, on_pod_started=rec.started, on_pod_completed=rec.completed,
        on_pod_killed=rec.killed, on_pod_preempted=rec.preempted,
        clock=lambda: clock_ms)
    pod = None
    if actual is not A.MISSING:
        phase = {A.WAITING: "Pending", A.RUNNING: "Running",
                 A.SUCCEEDED: "Succeeded", A.FAILED: "Failed",
                 A.UNKNOWN: "Unknown", A.DELETING: "Running"}[actual]
        pod = p.fake.FakePod(name=POD, phase=phase, node_name="n1",
                             labels={"cook/job": "j1"},
                             exit_code=(0 if actual is A.SUCCEEDED else
                                        1 if actual is A.FAILED else None))
        if actual is A.DELETING:
            pod.deleted = True
            pod.deletion_ms = (-p.ctl.OLD_DELETION_MS - 1 if old_deletion
                               else 0)
        api._pods[POD] = pod
        assert p.ctl.synthesize_pod_state(pod) is actual
    if expected is not E.MISSING:
        ctl.set_expected(POD, expected)
        if with_launch_pod:
            ctl.expected[POD].launch_pod = pod or p.fake.FakePod(name=POD)
    return api, ctl, rec


def cell_outcome(api, ctl, rec):
    entry = ctl.expected.get(POD)
    return (rec.calls, entry.state.name if entry is not None else None,
            pod_view(api.pod(POD)))


def reason(name):
    return R.schema.Reasons.__dict__[name].code


K_USER = ("killed", reason("KILLED_BY_USER"))
K_LOST = ("killed", reason("NODE_LOST"))
C_OK = ("completed", None)
C_FAIL = ("completed", reason("NON_ZERO_EXIT"))
C_MEA = ("completed", reason("UNKNOWN_MEA_CULPA"))

# (expected, actual) -> (callbacks, entry_gone, pod_gone), the
# reference's table
TABLE = {
    ("STARTING", "WAITING"):   ([], False, False),
    ("STARTING", "MISSING"):   ([], False, True),
    ("STARTING", "RUNNING"):   (["started"], False, False),
    ("STARTING", "SUCCEEDED"): (["started", C_OK], True, True),
    ("STARTING", "FAILED"):    ([C_FAIL], True, True),
    ("STARTING", "UNKNOWN"):   ([C_MEA], True, True),
    ("STARTING", "DELETING"):  ([K_LOST], True, False),

    ("RUNNING", "RUNNING"):    ([], False, False),
    ("RUNNING", "WAITING"):    (["preempted"], True, True),
    ("RUNNING", "SUCCEEDED"):  ([C_OK], True, True),
    ("RUNNING", "FAILED"):     ([C_FAIL], True, True),
    ("RUNNING", "UNKNOWN"):    ([C_MEA], True, True),
    ("RUNNING", "MISSING"):    ([K_LOST], True, True),
    ("RUNNING", "DELETING"):   ([K_LOST], True, False),

    ("KILLED", "WAITING"):     ([K_USER], True, True),
    ("KILLED", "RUNNING"):     ([K_USER], True, True),
    ("KILLED", "SUCCEEDED"):   ([C_OK], True, True),
    ("KILLED", "FAILED"):      ([K_USER], True, True),
    ("KILLED", "UNKNOWN"):     ([C_MEA], True, True),
    ("KILLED", "DELETING"):    ([K_USER], True, False),
    ("KILLED", "MISSING"):     ([K_USER], True, True),

    ("COMPLETED", "SUCCEEDED"): ([], True, True),
    ("COMPLETED", "FAILED"):    ([], True, True),
    ("COMPLETED", "UNKNOWN"):   ([], True, True),
    ("COMPLETED", "RUNNING"):   ([], False, True),
    ("COMPLETED", "WAITING"):   ([], False, True),
    ("COMPLETED", "DELETING"):  ([], True, False),
    ("COMPLETED", "MISSING"):   ([], True, True),

    ("MISSING", "MISSING"):    ([], True, True),
    ("MISSING", "SUCCEEDED"):  ([], True, True),
    ("MISSING", "FAILED"):     ([], True, True),
    ("MISSING", "UNKNOWN"):    ([], True, True),
    ("MISSING", "RUNNING"):    ([], True, True),
    ("MISSING", "WAITING"):    ([], True, True),
    ("MISSING", "DELETING"):   ([], True, False),
}


@pytest.mark.parametrize("expected,actual", sorted(TABLE))
def test_controller_table_cell(expected, actual):
    callbacks, entry_gone, pod_gone = TABLE[(expected, actual)]

    def scenario(p):
        api, ctl, rec = setup_cell(p, expected, actual,
                                   sticky=(actual == "DELETING"))
        ctl.process(POD)
        assert rec.calls == callbacks, (expected, actual, rec.calls)
        assert (POD not in ctl.expected) == entry_gone
        assert (api.pod(POD) is None) == pod_gone
        return cell_outcome(api, ctl, rec)
    both(scenario)


def test_controller_table_covers_every_cell():
    out = [(len(p.ctl.CookExpected), len(p.ctl.PodState),
            [e.name for e in p.ctl.CookExpected],
            [a.name for a in p.ctl.PodState]) for p in SIDES]
    assert out[1] == out[0]
    assert len(TABLE) == out[0][0] * out[0][1] == 35
    assert {e for e, _a in TABLE} == set(out[0][2])
    assert {a for _e, a in TABLE} == set(out[0][3])


def test_missing_deleting_old_timestamp_hard_kills():
    def scenario(p):
        api, ctl, rec = setup_cell(p, "MISSING", "DELETING", sticky=True,
                                   old_deletion=True, clock_ms=0)
        ctl.process(POD)
        assert api.pod(POD) is None
        assert rec.calls == []
        return cell_outcome(api, ctl, rec)
    both(scenario)


def test_killed_missing_opportunistic_kill():
    def scenario(p):
        api, ctl, rec = setup_cell(p, "KILLED", "MISSING",
                                   with_launch_pod=True)
        ctl.process(POD)
        assert rec.calls == [K_USER]
        return cell_outcome(api, ctl, rec)
    both(scenario)


@pytest.mark.parametrize("actual", ["RUNNING", "WAITING"])
def test_weird_kill_converges_on_delete_event(actual):
    def scenario(p):
        api, ctl, rec = setup_cell(p, "COMPLETED", actual, sticky=False)
        ctl.process(POD)
        assert api.pod(POD) is None
        mid = cell_outcome(api, ctl, rec)
        ctl.pod_deleted(POD)
        assert POD not in ctl.expected
        assert rec.calls == []
        return mid, cell_outcome(api, ctl, rec)
    both(scenario)


def test_starting_waiting_is_stable_under_rescan():
    def scenario(p):
        api, ctl, rec = setup_cell(p, "STARTING", "WAITING")
        for _ in range(3):
            ctl.process(POD)
        assert rec.calls == []
        assert ctl.expected[POD].state is p.ctl.CookExpected.STARTING
        return cell_outcome(api, ctl, rec)
    both(scenario)


# ------------------------------------------------ pod bodies, golden
GU = "11111111-2222-3333-4444-555555555555"


def incremental(p, key, value):
    inc = p.incremental.IncrementalConfig()
    inc.set_many({key: [{"value": value, "portion": 1.0}]})
    return inc


def golden_job(p, name):
    S = p.schema
    res = S.Resources
    jobs = {
        "plain": dict(command="echo hi", resources=res(cpus=2.0, mem=512.0)),
        "gpu": dict(command="train",
                    resources=res(cpus=4.0, mem=8192.0, gpus=2.0),
                    labels={"gpu-model": "a100"}),
        "disk_shm_ports": dict(user="bob", command="x",
                               resources=res(cpus=1.0, mem=128.0),
                               labels={"disk-type": "ssd",
                                       "shm-size-mb": "256"}, ports=2),
        "checkpoint": dict(command="train", resources=res(cpus=1.0,
                                                          mem=256.0),
                           checkpoint=S.Checkpoint(
                               mode=S.CheckpointMode.PERIODIC,
                               period_sec=300,
                               volume_mounts=["/ckpt-extra"])),
        "checkpoint_incremental": dict(
            command="x", resources=res(cpus=1.0, mem=64.0),
            checkpoint=S.Checkpoint(mode=S.CheckpointMode.AUTO)),
        "uri_fetch_modes": dict(
            command="x", resources=res(cpus=1.0, mem=64.0),
            uris=[{"value": "http://a/t.tgz", "extract": True,
                   "cache": True},
                  {"value": "http://b/run.sh", "executable": True}]),
        "sidecar_incremental": dict(command="x",
                                    resources=res(cpus=1.0, mem=64.0)),
        "user_volumes": dict(
            command="x", resources=res(cpus=1.0, mem=64.0),
            container={"image": "my:img",
                       "volumes": [{"host-path": "/data",
                                    "container-path": "/mnt/data",
                                    "mode": "RO"},
                                   {"host-path": "/scratch"}]}),
        "launch_identity": dict(command="true",
                                resources=res(cpus=1.0, mem=128.0)),
        "docker_parameters": dict(
            command="x", resources=res(cpus=1.0, mem=64.0),
            container={"image": "img:1", "parameters": [
                {"key": "workdir", "value": "/srv/app"},
                {"key": "env", "value": "MODE=fast"},
                {"key": "label", "value": "ignored=true"}]}),
    }
    kw = {"user": "alice", **jobs[name]}
    job = S.Job(uuid=GU, **kw)
    if name == "launch_identity":
        job.instances = ["task-1"]
    return job


GOLDEN = {
    # name: (pool, build_pod_spec keywords)
    "plain": ("default", lambda p: {}),
    "gpu": ("gpu", lambda p: {"sidecar": False}),
    "disk_shm_ports": ("default", lambda p: {"sidecar": False}),
    "checkpoint": ("default", lambda p: {"sidecar": False}),
    "checkpoint_incremental": ("default", lambda p: {
        "sidecar": False, "incremental": incremental(
            p, "checkpoint-init-image", "ckpt:canary")}),
    "uri_fetch_modes": ("default", lambda p: {"sidecar": False}),
    "sidecar_incremental": ("default", lambda p: {
        "incremental": incremental(p, "sidecar-image", "sidecar:canary")}),
    "user_volumes": ("default", lambda p: {"sidecar": False}),
    "launch_identity": ("default", lambda p: {
        "task_id": "task-1", "rest_url": "http://cook.example:12321"}),
    "docker_parameters": ("default", lambda p: {"sidecar": False}),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_pod_spec_golden_bytes_equal(name):
    pool, kwargs = GOLDEN[name]

    def scenario(p):
        spec = p.pod_spec.build_pod_spec(golden_job(p, name), pool,
                                         **kwargs(p))
        return json.dumps(spec)
    body = both(scenario)
    spec = json.loads(body)
    if name == "launch_identity":
        env = {e["name"]: e.get("value")
               for e in spec["containers"][0]["env"]}
        assert env["COOK_INSTANCE_UUID"] == "task-1"
        assert env["COOK_INSTANCE_NUM"] == "0"
    elif name == "sidecar_incremental":
        assert spec["containers"][1]["image"] == "sidecar:canary"
    elif name == "checkpoint_incremental":
        assert spec["init_containers"][0]["image"] == "ckpt:canary"
    elif name == "plain":
        assert [c["name"] for c in spec["containers"]] == \
            ["cook-job", "cook-sidecar"]
        assert spec["priority_class"] == "cook-pool-default"


def test_pod_spec_constants_equal():
    names = ("COOK_WORKDIR", "SIDECAR_PORT", "SIDECAR_WORKDIR")
    out = [tuple(getattr(p.pod_spec, n) for n in names) for p in SIDES]
    assert out[1] == out[0]


# ------------------------------------------------ autoscale routing
def make_k8s(p, name):
    cluster = p.cc.factory(name=name)
    cluster.api.add_node(p.fake.FakeNode(name=f"{name}-n0", cpus=1.0,
                                         mem=128.0))
    return cluster


def routing(p, edit=None):
    cfg = p.config.Config()
    cfg.columnar_index = False
    cfg.autoscaling_enabled = True
    store = p.state.Store()
    a, b = make_k8s(p, "a"), make_k8s(p, "b")
    if edit is not None:
        edit(p, a)
    sched = scheduler(p, store, [a, b], cfg)
    store.create_jobs([p.state.Job(
        uuid="big", user="u", command="x",
        resources=p.state.Resources(cpus=64, mem=2048))])
    rank_match(p, sched)
    return synthetic_view(a.api), synthetic_view(b.api)


def test_autoscale_demand_routes_to_one_healthy_cluster():
    synth_a, synth_b = both(routing)
    assert len(synth_a) == 1 and len(synth_b) == 0


def test_autoscale_breaker_open_reroutes_demand():
    def trip(p, a):
        br = p.retry.breakers.get("a")
        for _ in range(br.failure_threshold):
            br.record_failure()
    synth_a, synth_b = both(routing, trip)
    assert synth_a == [] and len(synth_b) == 1


def test_autoscale_capped_cluster_falls_through_to_next_scaler():
    def cap(p, a):
        a.max_total_pods = 0
    synth_a, synth_b = both(routing, cap)
    assert synth_a == [] and len(synth_b) == 1


# ------------------------------------------------ lease election
def lease_pair(p):
    api = p.fake.FakeKubernetesApi()
    clock = {"t": 0.0}

    def mk(ident, url, events, **kw):
        return p.election.LeaseLeaderElector(
            api, identity=ident, node_url=url, duration_s=10.0,
            clock=lambda: clock["t"],
            on_leadership=lambda: events.append("lead"),
            on_loss=lambda: events.append("loss"), **kw)
    return api, clock, mk


def lease_view(api, name="cook-scheduler-leader"):
    lease = api.get_lease(name)
    if lease is None:
        return None
    return (lease.holder, lease.renew_time_s, lease.duration_s,
            lease.transitions, lease.holder_url, dict(lease.annotations))


def test_lease_single_winner_and_renewal():
    def scenario(p):
        api, clock, mk = lease_pair(p)
        ev_a, ev_b = [], []
        a = mk("node-a", "http://a:1", ev_a)
        b = mk("node-b", "http://b:2", ev_b)
        assert a.try_once() and not b.try_once()
        assert a.is_leader and not b.is_leader
        assert a.leader_url() == "http://a:1" == b.leader_url()
        assert ev_a == ["lead"] and ev_b == []
        views = [lease_view(api)]
        for _ in range(5):
            clock["t"] += 5.0
            assert a.try_once() and not b.try_once()
            views.append(lease_view(api))
        assert a.epoch == 1
        return views, ev_a, ev_b, a.epoch
    both(scenario)


def test_lease_failover_after_ttl_with_epoch_bump():
    def scenario(p):
        api, clock, mk = lease_pair(p)
        ev_a, ev_b = [], []
        a = mk("node-a", "http://a:1", ev_a)
        b = mk("node-b", "http://b:2", ev_b)
        assert a.try_once()
        clock["t"] += 5.0
        assert not b.try_once()
        assert b.leader_url() == "http://a:1"
        clock["t"] += 6.0
        assert b.try_once()
        assert b.is_leader and b.epoch == 2
        assert b.leader_url() == "http://b:2"
        assert not a.try_once()
        assert not a.is_leader and ev_a == ["lead", "loss"]
        return lease_view(api), ev_a, ev_b, a.epoch, b.epoch
    both(scenario)


def test_lease_resign_releases_immediately():
    def scenario(p):
        api, clock, mk = lease_pair(p)
        ev_a, ev_b = [], []
        a = mk("node-a", "http://a:1", ev_a)
        b = mk("node-b", "http://b:2", ev_b)
        assert a.try_once()
        a.resign()
        released = lease_view(api)
        assert ev_a == ["lead", "loss"]
        assert b.try_once() and b.is_leader
        b.resign()
        assert b.leader_url() is None
        return released, lease_view(api), ev_a, ev_b
    both(scenario)


def test_lease_renewal_errors_do_not_split_brain():
    def scenario(p):
        api = p.fake.FakeKubernetesApi()
        clock = {"t": 0.0}
        fail = {"on": False}
        real_try = api.try_acquire_lease

        def flaky(*a, **kw):
            if fail["on"]:
                raise ConnectionError("apiserver 500")
            return real_try(*a, **kw)
        api.try_acquire_lease = flaky
        events = []
        a = p.election.LeaseLeaderElector(
            api, "node-a", "http://a:1", duration_s=10.0,
            renew_interval_s=0.01, clock=lambda: clock["t"],
            on_leadership=lambda: events.append("lead"),
            on_loss=lambda: events.append("loss"))
        a.campaign()
        try:
            deadline = time.time() + 5
            while not a.is_leader and time.time() < deadline:
                time.sleep(0.01)
            assert a.is_leader
            fail["on"] = True
            clock["t"] += 5.0
            time.sleep(0.1)
            assert a.is_leader
            clock["t"] += 6.0
            deadline = time.time() + 5
            while a.is_leader and time.time() < deadline:
                time.sleep(0.01)
            assert not a.is_leader
            assert events == ["lead", "loss"]
        finally:
            a.resign()
        return events, lease_view(api)[0]
    both(scenario)


def test_lease_elector_annotations_roundtrip():
    def scenario(p):
        api = p.fake.FakeKubernetesApi()
        clock = {"t": 0.0}
        a = p.election.LeaseLeaderElector(api, "node-a", "http://a:1",
                                          clock=lambda: clock["t"])
        a.publish_candidate("node-a", {"epoch": 2, "offset": 7,
                                       "synced": True})
        assert a.try_once()
        got = a.read_candidates()
        assert got == {"node-a": {"epoch": 2, "offset": 7, "synced": True}}
        a.clear_candidate("node-a")
        assert a.read_candidates() == {}
        return got, lease_view(api)
    both(scenario)


# ------------------------------------------------ a kill under contention
@pytest.mark.parametrize("held", ["controller", "kill_lock"])
def test_kill_under_contention_never_waits(held):
    """The port's one difference (``compute_cluster.py``'s docstring):
    while another thread holds the controller's lock (a watch event whose
    writeback waits for the store) or the kill lock's read side (a
    launch), the reference's ``safe_kill_task`` waits and the port's
    hands the kill to its kill thread and returns.  Once the holder lets
    go, both end the same: the pod deleted, KILLED_BY_USER written."""
    import threading

    def scenario(p):
        api, store, cluster, sched = k8s_system(p)
        [uuid] = store.create_jobs([make_job(p, 0)])
        [tid] = rank_match(p, sched).launched_task_ids
        api.step()
        taken, let_go = threading.Event(), threading.Event()

        def holder():
            if held == "controller":
                with cluster.controller._lock:
                    taken.set()
                    let_go.wait(10)
            else:
                cluster.kill_lock.acquire_read()
                taken.set()
                let_go.wait(10)
                cluster.kill_lock.release_read()

        h = threading.Thread(target=holder)
        h.start()
        taken.wait(10)
        killer = threading.Thread(target=cluster.safe_kill_task, args=(tid,))
        killer.start()
        killer.join(0.5)
        waited = killer.is_alive()
        pod_while_held = api.pod(tid) is not None
        let_go.set()
        h.join(10)
        killer.join(10)
        deadline = time.time() + 10
        while api.pod(tid) is not None and time.time() < deadline:
            time.sleep(0.01)
        cluster.shutdown()
        return waited, pod_while_held, api.pod(tid), inst_view(store, tid)
    out = [scenario(p) for p in SIDES]
    assert out[0][0] is True and out[1][0] is False
    assert out[0][1:] == out[1][1:]
    assert out[0][1] is True and out[0][2] is None
    assert out[0][3][1:3] == ("failed",
                              R.schema.Reasons.KILLED_BY_USER.code)
