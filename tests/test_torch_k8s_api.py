"""The port's Kubernetes wire (``cook_tpu_torch/cluster/k8s/real_api.py``,
``mock_apiserver.py``, ``testcerts.py``) against the JAX package's on the
CPU, over real sockets.

Every case of ``tests/test_k8s_real_api.py`` and ``tests/test_k8s_tls.py``
runs on both packages, each package's ``RealKubernetesApi`` against its
own ``MockApiServer`` and, for TLS, its own PKI from its own
``generate_pki`` (the ``openssl`` CLI, installed wherever these tests
run); each scenario holds the reference's assertions and returns what a
caller sees, and the two observations must be equal.  Watch streams
deliver on their own threads, so a scenario reports what the reference
waits for (an event seen, a relist counted), never raw event orders.

The wire check crosses the packages: the port's client against the
reference's mock and the reference's client against the port's, the
same pod creations and lease operations under a pinned clock; every
pairing must leave the same ``last_created_bodies`` and the same lease
objects on the mock.
"""

import base64
import importlib
import shutil
import ssl
import tempfile
import threading
import time
import types
import urllib.error
import urllib.request
from urllib.parse import urlparse

import pytest
import yaml


def side(root):
    ns = types.SimpleNamespace(root=root)
    for name, mod in (("fake", "cluster.k8s.fake_api"),
                      ("mock", "cluster.k8s.mock_apiserver"),
                      ("real", "cluster.k8s.real_api"),
                      ("certs", "cluster.k8s.testcerts"),
                      ("cc", "cluster.k8s.compute_cluster"),
                      ("pod_spec", "cluster.k8s.pod_spec"),
                      ("base", "cluster.base"), ("state", "state"),
                      ("file_server", "agent.file_server"),
                      ("faults", "utils.faults")):
        setattr(ns, name, importlib.import_module(f"{root}.{mod}"))
    return ns


SIDES = (side("cook_tpu"), side("cook_tpu_torch"))
R, P = SIDES


@pytest.fixture(autouse=True)
def _clear_injectors():
    for p in SIDES:
        p.faults.injector.clear()
    yield
    for p in SIDES:
        p.faults.injector.clear()


def both(scenario, *args, **kw):
    out = [scenario(p, *args, **kw) for p in SIDES]
    assert out[1] == out[0]
    return out[0]


def wait_for(pred, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


class Wire:
    """One package's mock apiserver and a client on it."""

    def __init__(self, p, **mock_kw):
        self.p = p
        self.mock = p.mock.MockApiServer(**mock_kw).start()
        self.clients = []

    def client(self, **kw):
        kw.setdefault("watch_timeout_s", 5.0)
        if "kubeconfig" not in kw:
            kw.setdefault("base_url", self.mock.base_url)
        api = self.p.real.RealKubernetesApi(**kw)
        self.clients.append(api)
        return api

    def close(self):
        for api in self.clients:
            api._stop.set()
        self.mock.close()


@pytest.fixture
def wires():
    made = []

    def make(p, **kw):
        w = Wire(p, **kw)
        made.append(w)
        return w
    yield make
    for w in made:
        w.close()


def node_view(n):
    return (n.name, n.cpus, n.mem, n.gpus, n.pool, dict(n.labels),
            list(n.taints), n.unschedulable, n.gpu_model)


def pod_view(x):
    if x is None:
        return None
    return (x.name, x.node_name, x.phase, x.cpus, x.mem, x.gpus,
            dict(x.labels), dict(x.annotations), x.exit_code,
            x.unschedulable_reason)


# ------------------------------------------------ quantities and CRUD
def test_parse_qty_forms():
    forms = [("2",), ("1500m",), ("512Mi",), ("1Gi",), ("524288Ki",),
             (None, 7.0), ("garbage", 3.0)]
    got = both(lambda p: [p.real.parse_qty(*f) for f in forms])
    assert got == [2.0, 1.5, 512.0, 1024.0, 512.0, 7.0, 3.0]


def test_nodes_roundtrip(wires):
    def scenario(p):
        w = wires(p)
        w.mock.fake.add_node(p.fake.FakeNode(
            name="n1", cpus=16.0, mem=32768.0, gpus=2.0, pool="gpu",
            labels={"zone": "z1"}, taints=["dedicated"],
            unschedulable=False, gpu_model="a100"))
        [n] = w.client().nodes()
        assert (n.name, n.cpus, n.mem, n.gpus) == ("n1", 16.0, 32768.0, 2.0)
        assert n.pool == "gpu" and n.labels["zone"] == "z1"
        assert n.taints == ["dedicated"] and n.gpu_model == "a100"
        return node_view(n)
    both(scenario)


def test_pod_crud_and_field_mapping(wires):
    def scenario(p):
        w = wires(p)
        api = w.client()
        api.create_pod(p.fake.FakePod(
            name="p1", cpus=2.0, mem=1024.0,
            labels={"cook/job": "j1"}, annotations={"a": "b"},
            spec={"containers": [{
                "name": "cook-job", "image": "img:1",
                "command": ["/bin/sh", "-c", "true"],
                "env": [{"name": "FOO", "value": "bar"}]}]}))
        [body] = w.mock.last_created_bodies
        c = body["spec"]["containers"][0]
        assert c["image"] == "img:1" and c["command"][0] == "/bin/sh"
        assert {"name": "FOO", "value": "bar"} in c["env"]
        out = [body, pod_view(api.pod("p1"))]
        assert api.pod("p1").cpus == 2.0
        assert api.pod("nope") is None
        with pytest.raises(ValueError):
            api.create_pod(p.fake.FakePod(name="p1"))
        w.mock.fake.step()
        w.mock.fake.add_node(p.fake.FakeNode(name="n1", cpus=8.0,
                                             mem=8192.0))
        w.mock.fake.step()
        w.mock.fake.step()
        w.mock.fake.finish_pod("p1", exit_code=3)
        got = api.pod("p1")
        assert got.exit_code == 3 and got.phase == "Failed"
        out.append(pod_view(got))
        api.delete_pod("p1", grace_period_s=0)
        api.delete_pod("p1")
        assert api.pod("p1") is None
        return out
    both(scenario)


def test_unschedulable_condition_mapping(wires):
    def scenario(p):
        w = wires(p)
        api = w.client()
        api.create_pod(p.fake.FakePod(name="p2", cpus=1.0, mem=64.0))
        w.mock.fake.mark_unschedulable("p2", "0/3 nodes: taint mismatch")
        got = api.pod("p2")
        assert "taint mismatch" in got.unschedulable_reason
        return pod_view(got)
    both(scenario)


# ------------------------------------------------ watches
def test_watch_stream_delivers_events(wires):
    def scenario(p):
        w = wires(p)
        api = w.client()
        seen = []
        api.watch(seen.append)
        w.mock.fake.add_node(p.fake.FakeNode(name="n1", cpus=4.0,
                                             mem=4096.0))
        api.create_pod(p.fake.FakePod(name="w1", cpus=1.0, mem=128.0))
        wait_for(lambda: any(e.kind == "pod" and e.type == "ADDED"
                             and e.obj.name == "w1" for e in seen),
                 msg="pod ADDED event")
        wait_for(lambda: any(e.kind == "node" and e.obj.name == "n1"
                             for e in seen), msg="node ADDED event")
        w.mock.fake.step()
        wait_for(lambda: any(e.kind == "pod" and e.type == "MODIFIED"
                             and e.obj.node_name == "n1" for e in seen),
                 msg="pod MODIFIED with node")
        assert api.resource_version > 0
        return sorted({(e.kind, e.type, e.obj.name) for e in list(seen)})
    both(scenario)


def test_reconnect_resumes_from_last_rv(wires):
    def scenario(p):
        w = wires(p)
        api = w.client()
        seen = []
        api.watch(seen.append)
        api.create_pod(p.fake.FakePod(name="r1", cpus=1.0, mem=64.0))
        wait_for(lambda: any(e.obj.name == "r1" for e in seen
                             if e.kind == "pod"), msg="first event")
        w.mock.drop_watch_streams()
        time.sleep(0.2)
        api.create_pod(p.fake.FakePod(name="r2", cpus=1.0, mem=64.0))
        wait_for(lambda: any(e.obj.name == "r2" for e in seen
                             if e.kind == "pod"), msg="post-drop event")
        r1_adds = [e for e in seen if e.kind == "pod" and e.type == "ADDED"
                   and e.obj.name == "r1"]
        assert len(r1_adds) == 1
        assert api.watch_reconnects >= 1
        return len(r1_adds), api.watch_reconnects >= 1
    both(scenario)


def test_watch_gap_410_relists(wires):
    def scenario(p):
        w = wires(p)
        api = w.client()
        for i in range(5):
            w.mock.fake.create_pod(p.fake.FakePod(name=f"old{i}", cpus=1.0,
                                                  mem=64.0))
        w.mock.compact()
        seen = []
        api.watch(seen.append, resource_version=1)
        wait_for(lambda: len({e.obj.name for e in seen
                              if e.kind == "pod"}) == 5,
                 msg="relist delivered current state")
        assert api.watch_gap_relists >= 1
        api.create_pod(p.fake.FakePod(name="fresh", cpus=1.0, mem=64.0))
        wait_for(lambda: any(e.obj.name == "fresh" for e in seen
                             if e.kind == "pod"), msg="live after gap")
        return sorted({e.obj.name for e in list(seen) if e.kind == "pod"})
    both(scenario)


def test_gap_synthesizes_deletes_for_vanished_pods(wires):
    def scenario(p):
        w = wires(p)
        api = w.client()
        seen = []
        api.watch(seen.append)
        api.create_pod(p.fake.FakePod(name="gone", cpus=1.0, mem=64.0))
        api.create_pod(p.fake.FakePod(name="stays", cpus=1.0, mem=64.0))
        wait_for(lambda: {"gone", "stays"} <= {
            e.obj.name for e in seen if e.kind == "pod"}, msg="both seen")
        w.mock.drop_watch_streams()
        w.mock.fake.delete_pod("gone", grace_period_s=0)
        w.mock.compact()
        wait_for(lambda: any(e.kind == "pod" and e.type == "DELETED"
                             and e.obj.name == "gone" for e in seen),
                 timeout=10.0, msg="synthesized DELETED after gap")
        assert w.mock.fake.pod("stays") is not None
        return sorted(x.name for x in w.mock.fake.pods())
    both(scenario)


# ------------------------------------------------ leases
def lease_view(lease):
    if lease is None:
        return None
    return (lease.name, lease.holder, lease.holder_url, lease.duration_s,
            lease.transitions, dict(lease.annotations))


def test_lease_acquire_renew_and_cas_conflict(wires):
    now = 1_700_000_000.0

    def scenario(p):
        w = wires(p)
        a, b = w.client(), w.client()
        out = []
        lease = a.try_acquire_lease("lead", "node-a", now, duration_s=10.0,
                                    holder_url="http://a")
        assert lease is not None and lease.transitions == 1
        out.append(lease_view(lease))
        assert b.try_acquire_lease("lead", "node-b", now + 1) is None
        lease = a.try_acquire_lease("lead", "node-a", now + 2,
                                    duration_s=10.0)
        assert lease is not None and lease.transitions == 1
        lease = b.try_acquire_lease("lead", "node-b", now + 20)
        assert lease is not None and lease.transitions == 2
        out.append(lease_view(lease))
        assert a.get_lease("lead").holder == "node-b"
        out.append(lease_view(a.get_lease("lead")))
        a.release_lease("lead", "node-a")
        assert a.get_lease("lead").holder == "node-b"
        b.release_lease("lead", "node-b")
        assert a.get_lease("lead").holder == ""
        assert a.get_lease("missing") is None
        return out + [lease_view(a.get_lease("lead"))]
    both(scenario)


def test_lease_concurrent_contenders_single_winner(wires):
    def scenario(p):
        w = wires(p)
        apis = [w.client() for _ in range(4)]
        now = time.time()
        wins = []
        barrier = threading.Barrier(4)

        def contend(i):
            barrier.wait()
            if apis[i].try_acquire_lease("c", f"n{i}", now) is not None:
                wins.append(i)

        ts = [threading.Thread(target=contend, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len(wins) == 1
        holder = apis[0].get_lease("c")
        assert holder.holder == f"n{wins[0]}"
        return len(wins), holder.transitions
    both(scenario)


# ------------------------------------------------ the backend over HTTP
def launch_over(p, w, api, name):
    """``KubernetesCluster`` over ``api``: an offer from the watched
    node, a launch, the pod's run and its end, as status updates."""
    updates = []
    store = p.state.Store()
    store.create_jobs([p.state.Job(
        uuid="j1", user="alice", command="echo hi",
        resources=p.state.Resources(cpus=1.0, mem=256.0))])
    cluster = p.cc.KubernetesCluster(name, api, store=store)
    cluster.initialize(lambda tid, status, reason, **kw:
                       updates.append((tid, status.value, reason)))
    try:
        wait_for(lambda: len(cluster.pending_offers("default")) == 1,
                 msg="offer from watched node")
        offer = cluster.pending_offers("default")[0]
        assert offer.available.cpus == 8.0
        cluster.launch_tasks("default", [p.base.LaunchSpec(
            task_id="t1", job_uuid="j1", hostname="", slave_id="",
            resources=p.state.Resources(cpus=1.0, mem=256.0),
            env={"COOK_COMMAND": "echo hi"})])
        wait_for(lambda: w.mock.fake.pod("t1") is not None,
                 msg="pod created over HTTP")
        body = [b for b in w.mock.last_created_bodies
                if b["metadata"]["name"] == "t1"][-1]
        w.mock.fake.step()
        w.mock.fake.step()
        wait_for(lambda: any(s == "running" for _, s, _r in updates),
                 msg="RUNNING update")
        w.mock.fake.finish_pod("t1", exit_code=0)
        wait_for(lambda: any(s == "success" for _, s, _r in updates),
                 msg="SUCCESS update")
        return body, sorted(set(updates)), (offer.hostname,
                                            offer.available.mem)
    finally:
        cluster.shutdown()


def test_launch_run_complete_over_http(wires):
    def scenario(p):
        w = wires(p)
        w.mock.fake.add_node(p.fake.FakeNode(name="n1", cpus=8.0,
                                             mem=8192.0))
        body, updates, offer = launch_over(p, w, w.client(), "k8s-real")
        names = [c["name"] for c in body["spec"]["containers"]]
        assert names == ["cook-job", "cook-sidecar"]
        sidecar = body["spec"]["containers"][1]
        assert sidecar["readinessProbe"]["httpGet"]["path"] \
            == "/readiness-probe"
        assert sidecar["ports"][0]["containerPort"] == \
            sidecar["readinessProbe"]["httpGet"]["port"]
        assert sidecar["resources"]["requests"] == {"cpu": "0.1",
                                                    "memory": "32Mi"}
        assert sidecar["resources"]["limits"] == {"memory": "32Mi"}
        fs = p.file_server.SandboxFileServer(tempfile.mkdtemp())
        fs.start()
        try:
            with urllib.request.urlopen(f"{fs.url}/readiness-probe",
                                        timeout=5) as r:
                probe = r.status
        finally:
            fs.stop()
        assert probe == 200
        return body, updates, offer, probe
    both(scenario)


def test_token_file_rotation_picked_up(wires, tmp_path):
    def scenario(p):
        w = wires(p)
        token_file = tmp_path / f"token-{p.root}"
        token_file.write_text("tok-1")
        api = w.client(token="tok-1")
        api._token_path = str(token_file)
        api._token_checked = 0.0
        out = [api._bearer()]
        token_file.write_text("tok-2")
        api._token_checked = 0.0
        out.append(api._bearer())
        token_file.unlink()
        api._token_checked = 0.0
        out.append(api._bearer())
        token_file.write_text("tok-3")
        out.append(api._bearer())
        assert out == ["tok-1", "tok-2", "tok-2", "tok-2"]
        return out
    both(scenario)


# ------------------------------------------------ TLS
@pytest.fixture(scope="module")
def pkis(tmp_path_factory):
    """Each package's PKI from its own ``generate_pki``."""
    return {p.root: p.certs.generate_pki(
        str(tmp_path_factory.mktemp(f"pki-{p.root}"))) for p in SIDES}


def write_kubeconfig(path, server, ca=None, ca_data=None, token=None,
                     client_cert=None, client_key=None, cert_data=None,
                     key_data=None, skip_verify=False):
    cluster = {"server": server}
    if ca:
        cluster["certificate-authority"] = ca
    if ca_data:
        cluster["certificate-authority-data"] = ca_data
    if skip_verify:
        cluster["insecure-skip-tls-verify"] = True
    user = {}
    if token:
        user["token"] = token
    if client_cert:
        user["client-certificate"] = client_cert
        user["client-key"] = client_key
    if cert_data:
        user["client-certificate-data"] = cert_data
        user["client-key-data"] = key_data
    cfg = {"apiVersion": "v1", "kind": "Config",
           "current-context": "test",
           "contexts": [{"name": "test",
                         "context": {"cluster": "c1", "user": "u1"}}],
           "clusters": [{"name": "c1", "cluster": cluster}],
           "users": [{"name": "u1", "user": user}]}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def b64file(path):
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def tls_wire(p, wires, pki, **kw):
    return wires(p, tls_cert=pki.server_cert, tls_key=pki.server_key, **kw)


def outcome(fn):
    """``("ok", value)``, or the error's kind: which of the reference's
    accepted exception types it is."""
    try:
        return ("ok", fn())
    except ssl.SSLError:
        return ("refused", "ssl")
    except urllib.error.URLError:
        return ("refused", "url")
    except (ConnectionError, OSError):
        return ("refused", "os")


def node_names(api):
    return [n.name for n in api.nodes()]


def kc_dir(tmp_path, p):
    d = tmp_path / p.root
    d.mkdir(exist_ok=True)
    return d


def test_tls_kubeconfig_ca_file_roundtrip(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki)
        w.mock.fake.add_node(p.fake.FakeNode(name="n1", cpus=4.0,
                                             mem=4096.0))
        kc = write_kubeconfig(kc_dir(tmp_path, p) / "kc.yaml",
                              w.mock.base_url, ca=pki.ca_cert)
        assert w.mock.base_url.startswith("https://")
        return node_names(w.client(kubeconfig=kc))
    assert both(scenario) == ["n1"]


def test_tls_kubeconfig_inline_ca_data(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki)
        w.mock.fake.add_node(p.fake.FakeNode(name="n2", cpus=1.0,
                                             mem=512.0))
        kc = write_kubeconfig(kc_dir(tmp_path, p) / "kc.yaml",
                              w.mock.base_url, ca_data=b64file(pki.ca_cert))
        return node_names(w.client(kubeconfig=kc))
    assert both(scenario) == ["n2"]


def test_tls_wrong_ca_rejected(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki)
        kc = write_kubeconfig(kc_dir(tmp_path, p) / "kc.yaml",
                              w.mock.base_url, ca=pki.wrong_ca_cert)
        api = w.client(kubeconfig=kc)
        with pytest.raises((ssl.SSLError, urllib.error.URLError)):
            api.nodes()
        return outcome(api.nodes)
    assert both(scenario)[0] == "refused"


def test_tls_insecure_skip_verify(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki)
        w.mock.fake.add_node(p.fake.FakeNode(name="n3", cpus=1.0,
                                             mem=512.0))
        kc = write_kubeconfig(kc_dir(tmp_path, p) / "kc.yaml",
                              w.mock.base_url, skip_verify=True)
        return node_names(w.client(kubeconfig=kc))
    assert both(scenario) == ["n3"]


def test_tls_base_url_verify_false(pkis, wires):
    def scenario(p):
        w = tls_wire(p, wires, pkis[p.root])
        w.mock.fake.add_node(p.fake.FakeNode(name="n4", cpus=1.0,
                                             mem=512.0))
        return node_names(w.client(verify_tls=False))
    assert both(scenario) == ["n4"]


def test_mtls_client_certificate_accepted(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki, client_ca=pki.ca_cert)
        w.mock.fake.add_node(p.fake.FakeNode(name="m1", cpus=1.0,
                                             mem=512.0))
        kc = write_kubeconfig(kc_dir(tmp_path, p) / "kc.yaml",
                              w.mock.base_url, ca=pki.ca_cert,
                              client_cert=pki.client_cert,
                              client_key=pki.client_key)
        return node_names(w.client(kubeconfig=kc))
    assert both(scenario) == ["m1"]


def test_mtls_inline_cert_data(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki, client_ca=pki.ca_cert)
        w.mock.fake.add_node(p.fake.FakeNode(name="m2", cpus=1.0,
                                             mem=512.0))
        kc = write_kubeconfig(kc_dir(tmp_path, p) / "kc.yaml",
                              w.mock.base_url, ca_data=b64file(pki.ca_cert),
                              cert_data=b64file(pki.client_cert),
                              key_data=b64file(pki.client_key))
        return node_names(w.client(kubeconfig=kc))
    assert both(scenario) == ["m2"]


def test_mtls_missing_client_certificate_rejected(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki, client_ca=pki.ca_cert)
        kc = write_kubeconfig(kc_dir(tmp_path, p) / "kc.yaml",
                              w.mock.base_url, ca=pki.ca_cert)
        api = w.client(kubeconfig=kc)
        with pytest.raises((ssl.SSLError, urllib.error.URLError,
                            ConnectionError, OSError)):
            api.nodes()
        return outcome(api.nodes)[0]
    assert both(scenario) == "refused"


def test_tls_token_enforced(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki, bearer_token="sekrit")
        w.mock.fake.add_node(p.fake.FakeNode(name="b1", cpus=1.0,
                                             mem=512.0))
        d = kc_dir(tmp_path, p)
        good = write_kubeconfig(d / "good.yaml", w.mock.base_url,
                                ca=pki.ca_cert, token="sekrit")
        names = node_names(w.client(kubeconfig=good))
        bad = write_kubeconfig(d / "bad.yaml", w.mock.base_url,
                               ca=pki.ca_cert, token="wrong")
        with pytest.raises(p.real.ApiError) as e:
            w.client(kubeconfig=bad).nodes()
        assert "401" in str(e.value)
        return names, e.value.status
    assert both(scenario) == (["b1"], 401)


def test_tls_in_cluster_service_account(pkis, wires, tmp_path, monkeypatch):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki, bearer_token="sa-tok")
        w.mock.fake.add_node(p.fake.FakeNode(name="s1", cpus=1.0,
                                             mem=512.0))
        sa = kc_dir(tmp_path, p) / "sa"
        sa.mkdir()
        (sa / "token").write_text("sa-tok")
        shutil.copy(pki.ca_cert, sa / "ca.crt")
        u = urlparse(w.mock.base_url)
        monkeypatch.setenv("COOK_K8S_SA_DIR", str(sa))
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", u.hostname)
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(u.port))
        api = p.real.RealKubernetesApi(watch_timeout_s=5.0)
        w.clients.append(api)
        assert api._token_path == str(sa / "token")
        out = [node_names(api)]
        (sa / "token").write_text("sa-tok-2")
        w.mock.bearer_token = "sa-tok-2"
        api._token_checked = 0.0
        out.append(node_names(api))
        return out
    assert both(scenario) == [["s1"], ["s1"]]


def test_tls_token_rotation(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki, bearer_token="tok-1")
        w.mock.fake.add_node(p.fake.FakeNode(name="r1", cpus=1.0,
                                             mem=512.0))
        d = kc_dir(tmp_path, p)
        kc = write_kubeconfig(d / "kc.yaml", w.mock.base_url,
                              ca=pki.ca_cert, token="tok-1")
        api = w.client(kubeconfig=kc)
        out = [node_names(api)]
        token_file = d / "token"
        token_file.write_text("tok-2")
        api._token_path = str(token_file)
        w.mock.bearer_token = "tok-2"
        api._token_checked = 0.0
        out.append(node_names(api))
        return out
    assert both(scenario) == [["r1"], ["r1"]]


def test_tls_cluster_launches_pod_over_https(pkis, wires, tmp_path):
    def scenario(p):
        pki = pkis[p.root]
        w = tls_wire(p, wires, pki, client_ca=pki.ca_cert,
                     bearer_token="sekrit")
        w.mock.fake.add_node(p.fake.FakeNode(name="n1", cpus=8.0,
                                             mem=8192.0))
        kc = write_kubeconfig(kc_dir(tmp_path, p) / "kc.yaml",
                              w.mock.base_url, ca=pki.ca_cert,
                              token="sekrit", client_cert=pki.client_cert,
                              client_key=pki.client_key)
        return launch_over(p, w, w.client(kubeconfig=kc), "k8s-tls")
    body, updates, _offer = both(scenario)
    assert [u[1] for u in updates if u[0] == "t1"] == ["running",
                                                        "success"]


def test_generate_pki_layout_equal(pkis):
    out = [sorted(k for k, v in vars(pkis[p.root]).items()
                  if isinstance(v, str)) for p in SIDES]
    assert out[1] == out[0]
    for p in SIDES:
        for path in vars(pkis[p.root]).values():
            with open(path) as f:
                assert f.read().startswith("-----BEGIN")


# ------------------------------------------------ the wire, crossed
NOW_S = 1_700_000_000.0


def wire_script(client_pkg, mock_pkg):
    """``client_pkg``'s ``RealKubernetesApi`` against ``mock_pkg``'s
    ``MockApiServer``: two pods (one compiled by the client package's
    pod compiler), a lease acquired, renewed, annotated, taken over and
    released under a pinned clock.  Returns the mock's captured bodies
    and lease objects after each lease step."""
    mock = mock_pkg.mock.MockApiServer().start()
    api = client_pkg.real.RealKubernetesApi(base_url=mock.base_url,
                                            namespace="cook",
                                            watch_timeout_s=5.0)
    other = client_pkg.real.RealKubernetesApi(base_url=mock.base_url,
                                              namespace="cook",
                                              watch_timeout_s=5.0)
    try:
        job = client_pkg.state.Job(
            uuid="00000000-0000-4000-8000-000000000001", user="alice",
            command="echo hi", ports=1,
            uris=[{"value": "http://a/t.tgz", "extract": True}],
            resources=client_pkg.state.Resources(cpus=2.0, mem=512.0,
                                                 gpus=1.0),
            env={"A": "1"}, labels={"shm-size-mb": "64"})
        spec = client_pkg.pod_spec.build_pod_spec(
            job, "default", task_id="t-1", rest_url="http://cook:1")
        fake = client_pkg.fake
        api.create_pod(fake.FakePod(
            name="t-1", cpus=2.0, mem=512.0, gpus=1.0, creation_ms=1,
            labels={"cook/job": job.uuid, "cook/pool": "default"},
            spec=spec))
        api.create_pod(fake.FakePod(
            name="synthetic-x", cpus=24.0, mem=256.0, synthetic=True,
            creation_ms=2, labels={"cook/synthetic": "true",
                                   "cook/job": "x"},
            annotations={"cook/created-ms": "0"}))
        leases = []

        def snap():
            leases.append(mock._leases.get("cook-scheduler-leader"))
        name = "cook-scheduler-leader"
        api.try_acquire_lease(name, "node-a", NOW_S, duration_s=15.0,
                              holder_url="http://a:1")
        snap()
        api.annotate_lease(name, {"cook.io/candidate-b": '{"offset": 5}'})
        snap()
        api.try_acquire_lease(name, "node-a", NOW_S + 2, duration_s=15.0,
                              holder_url="http://a:1")
        snap()
        assert other.try_acquire_lease(name, "node-b", NOW_S + 3) is None
        other.try_acquire_lease(name, "node-b", NOW_S + 30,
                                duration_s=15.0, holder_url="http://b:2")
        snap()
        other.release_lease(name, "node-b")
        snap()
        # a created pod's creation time is the mock's host clock
        pods = sorted((x.name, x.cpus, x.mem, x.gpus, x.synthetic,
                       dict(x.labels), dict(x.annotations))
                      for x in mock.fake.pods())
        read_back = [(x.name, x.cpus, x.mem, x.gpus, dict(x.labels))
                     for x in sorted(api.pods(), key=lambda x: x.name)]
        lease = api.get_lease(name)
        return {"bodies": mock.last_created_bodies, "leases": leases,
                "pods": pods, "read_back": read_back,
                "lease": (lease.holder, lease.renew_time_s,
                          lease.transitions, dict(lease.annotations))}
    finally:
        api._stop.set()
        other._stop.set()
        mock.close()


@pytest.mark.parametrize("client,server", [("port", "reference"),
                                           ("reference", "port")])
def test_wire_crossed_equals_each_package_alone(client, server):
    pkg = {"reference": R, "port": P}
    crossed = wire_script(pkg[client], pkg[server])
    alone = wire_script(R, R)
    assert crossed == alone
    assert wire_script(P, P) == alone
    assert len(alone["bodies"]) == 2
    assert [x["spec"]["leaseTransitions"] for x in alone["leases"]] == \
        [1, 1, 1, 2, 2]
    assert alone["leases"][-1]["spec"]["holderIdentity"] == ""
