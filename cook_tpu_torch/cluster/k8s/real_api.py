"""The port's copy of ``cook_tpu/cluster/k8s/real_api.py``
(imports re-rooted).

Real Kubernetes client adapter over stdlib HTTP.

Implements the same surface as :class:`fake_api.FakeKubernetesApi`
(nodes/pods/pod/create_pod/delete_pod/watch/unwatch/resource_version +
coordination/v1 leases) by speaking the Kubernetes REST API directly —
list/create/delete as JSON requests, watches as chunked ``?watch=1``
streams with resourceVersion resume and 410-Gone relist, leases with
resourceVersion compare-and-swap (reference: the okhttp watch +
client-java layer, scheduler/src/cook/kubernetes/api.clj:372-734; watch
bootstrap/resume :372-475).

No ``kubernetes`` package dependency: the wire protocol is small and a
stdlib client is exercisable in-repo against
:class:`mock_apiserver.MockApiServer` over real sockets
(tests/test_k8s_real_api.py), which is how every method here is tested.
"""

from __future__ import annotations

import datetime
import json
import socket
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from .fake_api import FakeNode, FakePod, WatchEvent
from .types import Lease

COOK_NS = "cook"


# --------------------------------------------------------------- quantities
def parse_qty(v, default: float = 0.0, kind: str = "count") -> float:
    """Kubernetes quantity -> float in cook units (cpus/gpus as counts,
    memory as MiB via ``kind="mem"``).

    "2" -> 2.0 cpus; "1500m" -> 1.5; "512Mi" -> 512; "1Gi" -> 1024;
    "524288Ki" -> 512; "2G" -> ~1907Mi.  A suffixless or
    exponent-form memory quantity ("16423059456", "16e9") is BYTES on
    the wire (canonical k8s form) and converts to MiB; suffixless
    cpu/gpu counts stay counts.
    """
    if v is None:
        return default
    s = str(v)
    try:
        if s.endswith("Ki"):
            return float(s[:-2]) / 1024.0
        if s.endswith("Mi"):
            return float(s[:-2])
        if s.endswith("Gi"):
            return float(s[:-2]) * 1024.0
        if s.endswith("Ti"):
            return float(s[:-2]) * 1024.0 * 1024.0
        if s.endswith("k"):
            return float(s[:-1]) * 1000.0 / (1024.0 * 1024.0)
        if s.endswith("M"):
            return float(s[:-1]) * 1e6 / (1024.0 * 1024.0)
        if s.endswith("G"):
            return float(s[:-1]) * 1e9 / (1024.0 * 1024.0)
        if s.endswith("m"):
            return float(s[:-1]) / 1000.0
        n = float(s)
        if kind == "mem":
            return n / (1024.0 * 1024.0)  # bytes -> MiB
        return n
    except ValueError:
        return default


def _ts_ms(rfc3339: Optional[str]) -> Optional[int]:
    if not rfc3339:
        return None
    try:
        dt = datetime.datetime.fromisoformat(rfc3339.replace("Z", "+00:00"))
        return int(dt.timestamp() * 1000)
    except ValueError:
        return None


def rfc3339(ts_s: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts_s, tz=datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def _resources_to_k8s(res: Dict) -> Dict:
    """pod_spec's internal resource dicts ({"cpu": float, "memory_mb":
    float, "gpu": float}) -> Kubernetes resource names/quantities (a real
    apiserver rejects unknown names like memory_mb)."""
    out: Dict = {}
    for section in ("requests", "limits"):
        vals = res.get(section)
        if not vals:
            continue
        k8s_vals: Dict = {}
        for k, v in vals.items():
            if k in ("memory_mb", "mem", "memory"):
                k8s_vals["memory"] = f"{int(float(v))}Mi"
            elif k in ("gpu", "gpus", "nvidia.com/gpu"):
                if float(v):
                    k8s_vals["nvidia.com/gpu"] = str(int(float(v)))
            else:
                k8s_vals["cpu" if k == "cpu" else k] = str(v)
        out[section] = k8s_vals
    return out


class ApiError(RuntimeError):
    def __init__(self, status: int, body: str = ""):
        super().__init__(f"apiserver HTTP {status}: {body[:200]}")
        self.status = status


class RealKubernetesApi:
    """Live-apiserver twin of FakeKubernetesApi over stdlib HTTP.

    ``base_url`` points at the apiserver (e.g. ``http://127.0.0.1:6443``
    or the MockApiServer's address); ``kubeconfig`` extracts server/token
    from a kubeconfig file instead.  Objects are translated into the same
    Fake* dataclasses the controller consumes, so
    :class:`compute_cluster.KubernetesCluster` and
    :class:`controller.PodController` run unchanged against a live
    cluster.
    """

    def __init__(self, namespace: str = COOK_NS,
                 kubeconfig: Optional[str] = None,
                 base_url: Optional[str] = None,
                 token: Optional[str] = None,
                 verify_tls: bool = True,
                 watch_timeout_s: float = 60.0):
        ctx: Optional[ssl.SSLContext] = None
        if kubeconfig and not base_url:
            base_url, token, ctx = self._from_kubeconfig(kubeconfig)
        self._token_path: Optional[str] = None
        self._token_checked = 0.0
        if not base_url and token is None:
            # in-cluster fallback: the pod's service account (the env
            # override exists so tests can execute this branch against a
            # mock apiserver — in a pod the default path is projected)
            import os
            sa = os.environ.get(
                "COOK_K8S_SA_DIR",
                "/var/run/secrets/kubernetes.io/serviceaccount")
            if os.path.exists(f"{sa}/token"):
                with open(f"{sa}/token", encoding="utf-8") as f:
                    token = f.read().strip()
                # bound service-account tokens ROTATE (the kubelet
                # refreshes the projected file); remember the path so
                # long-lived schedulers keep authenticating (reference:
                # TokenRefreshingAuthenticator.java + the bearer-token
                # refresh thread, kubernetes/compute_cluster.clj:756-792)
                self._token_path = f"{sa}/token"
                host = os.environ.get("KUBERNETES_SERVICE_HOST")
                port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
                if host:
                    base_url = f"https://{host}:{port}"
                if os.path.exists(f"{sa}/ca.crt"):
                    ctx = ssl.create_default_context(
                        cafile=f"{sa}/ca.crt")
        if not base_url:
            raise ValueError(
                "RealKubernetesApi needs base_url, kubeconfig, or an "
                "in-cluster service account")
        self.base_url = base_url.rstrip("/")
        self.namespace = namespace
        self.token = token
        self.watch_timeout_s = watch_timeout_s
        self._ctx = ctx
        if self.base_url.startswith("https") and not verify_tls:
            if self._ctx is None:
                self._ctx = ssl.create_default_context()
            # downgrade IN PLACE: rebuilding would drop a kubeconfig's
            # client-certificate (mTLS) identity
            self._ctx.check_hostname = False
            self._ctx.verify_mode = ssl.CERT_NONE
        self._rv = 0
        self._watchers: List[Callable[[WatchEvent], None]] = []
        self._lock = threading.RLock()
        # per-generation stop event: unwatch() must only stop the threads
        # of ITS generation — a later watch() spawns fresh threads with a
        # fresh event, so a slow old thread can never double-deliver
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # observability: watch reconnects / 410 relists (the reference
        # tracks watch gaps as metrics, api.clj:440-470)
        self.watch_reconnects = 0
        self.watch_gap_relists = 0

    @staticmethod
    def _from_kubeconfig(path: str) -> Tuple[str, Optional[str],
                                             Optional[ssl.SSLContext]]:
        """Resolve server/credentials honoring current-context, bearer
        tokens, client certificates, and CA bundles (inline *-data fields
        are written to temp files for the ssl module)."""
        import base64
        import tempfile

        import yaml
        with open(path, encoding="utf-8") as f:
            cfg = yaml.safe_load(f) or {}

        def by_name(items, name):
            for it in items or []:
                if it.get("name") == name:
                    return it
            return (items or [{}])[0]

        ctx_name = cfg.get("current-context")
        context = (by_name(cfg.get("contexts"), ctx_name)
                   .get("context") or {})
        cluster = (by_name(cfg.get("clusters"),
                           context.get("cluster")).get("cluster") or {})
        user = (by_name(cfg.get("users"),
                        context.get("user")).get("user") or {})
        server = cluster.get("server")
        if not server:
            raise ValueError(f"kubeconfig {path}: no cluster server")

        def materialize(data_key, file_key, src):
            if src.get(file_key):
                return src[file_key]
            if src.get(data_key):
                f = tempfile.NamedTemporaryFile(delete=False, suffix=".pem")
                f.write(base64.b64decode(src[data_key]))
                f.close()
                return f.name
            return None

        cafile = materialize("certificate-authority-data",
                             "certificate-authority", cluster)
        certfile = materialize("client-certificate-data",
                               "client-certificate", user)
        keyfile = materialize("client-key-data", "client-key", user)
        ctx = None
        if server.startswith("https") and (
                cafile or certfile
                or cluster.get("insecure-skip-tls-verify")):
            # skip-verify alone still needs a context: the default one
            # would reject the very self-signed server the operator just
            # told us to trust
            ctx = ssl.create_default_context(cafile=cafile)
            if cluster.get("insecure-skip-tls-verify"):
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if certfile:
                ctx.load_cert_chain(certfile, keyfile)
        return server, user.get("token"), ctx

    # ------------------------------------------------------------------ http
    def _bearer(self) -> Optional[str]:
        """The current bearer token, re-read from the projected
        service-account file at most once per minute (bound tokens
        rotate; a stale one starts getting 401s after expiry)."""
        if self._token_path is not None:
            now = time.time()
            if now - self._token_checked > 60.0:
                self._token_checked = now
                try:
                    with open(self._token_path, encoding="utf-8") as f:
                        fresh = f.read().strip()
                    if fresh:
                        self.token = fresh
                except OSError:
                    pass  # keep the last good token
        return self.token

    def _request(self, method: str, path: str, body=None,
                 timeout: float = 10.0):
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        token = self._bearer()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            with urllib.request.urlopen(req, timeout=timeout,
                                        context=self._ctx) as resp:
                raw = resp.read()
                return json.loads(raw) if raw else None
        except urllib.error.HTTPError as e:
            raise ApiError(e.code, e.read().decode("utf-8", "replace")) \
                from None

    # ------------------------------------------------------------ translate
    @staticmethod
    def _node_from_json(n: Dict) -> FakeNode:
        meta = n.get("metadata") or {}
        spec = n.get("spec") or {}
        alloc = (n.get("status") or {}).get("allocatable") or {}
        labels = meta.get("labels") or {}
        return FakeNode(
            name=meta.get("name", ""),
            cpus=parse_qty(alloc.get("cpu")),
            mem=parse_qty(alloc.get("memory"), kind="mem"),
            gpus=parse_qty(alloc.get("nvidia.com/gpu")),
            pool=labels.get("cook-pool", "default"),
            labels=dict(labels),
            taints=[t.get("key", "") for t in (spec.get("taints") or [])],
            unschedulable=bool(spec.get("unschedulable")),
            gpu_model=labels.get("gpu-model", ""))

    @staticmethod
    def _pod_from_json(p: Dict) -> FakePod:
        meta = p.get("metadata") or {}
        spec = p.get("spec") or {}
        status = p.get("status") or {}
        labels = meta.get("labels") or {}
        exit_code = None
        reason = status.get("reason") or ""
        unschedulable = ""
        for cond in (status.get("conditions") or []):
            if cond.get("type") == "PodScheduled" \
                    and cond.get("status") == "False":
                unschedulable = (cond.get("message") or cond.get("reason")
                                 or "Unschedulable")
        for cs in (status.get("containerStatuses") or []):
            term = (cs.get("state") or {}).get("terminated")
            if term is not None and cs.get("name") == "cook-job":
                exit_code = term.get("exitCode")
                reason = reason or (term.get("reason") or "")
        req = {}
        containers = spec.get("containers") or []
        if containers:
            req = (containers[0].get("resources") or {}).get("requests") or {}
        deleted_at = _ts_ms(meta.get("deletionTimestamp"))
        return FakePod(
            name=meta.get("name", ""),
            node_name=spec.get("nodeName"),
            phase=status.get("phase") or "Pending",
            cpus=parse_qty(req.get("cpu")),
            mem=parse_qty(req.get("memory"), kind="mem"),
            gpus=parse_qty(req.get("nvidia.com/gpu")),
            labels=dict(labels),
            annotations=dict(meta.get("annotations") or {}),
            deleted=deleted_at is not None,
            deletion_ms=deleted_at,
            creation_ms=_ts_ms(meta.get("creationTimestamp")) or 0,
            exit_code=exit_code,
            reason=reason,
            unschedulable_reason=unschedulable,
            synthetic=labels.get("cook/synthetic") == "true",
            resource_version=int(meta.get("resourceVersion") or 0))

    def _pod_to_json(self, pod: FakePod) -> Dict:
        spec = pod.spec or {}

        def container(c):
            out = {"name": c["name"], "image": c["image"]}
            if c.get("command"):
                out["command"] = c["command"]
            if c.get("env"):
                def env_entry(e):
                    if "value_from" in e:  # fieldRef vars (HOST_IP)
                        fr = e["value_from"]["field_ref"]
                        return {"name": e["name"],
                                "valueFrom": {"fieldRef": {
                                    "fieldPath": fr["field_path"]}}}
                    return {"name": e["name"], "value": e["value"]}
                out["env"] = [env_entry(e) for e in c["env"]]
            if c.get("working_dir"):
                out["workingDir"] = c["working_dir"]
            if c.get("volume_mounts"):
                out["volumeMounts"] = [
                    {"name": m["name"], "mountPath": m["mount_path"],
                     **({"readOnly": True} if m.get("read_only") else {}),
                     **({"subPath": m["sub_path"]}
                        if m.get("sub_path") else {})}
                    for m in c["volume_mounts"]]
            if c.get("ports"):
                out["ports"] = [{"containerPort": int(p)}
                                for p in c["ports"]]

            def probe(p):
                # pod_spec carries {"http_get": {"port", "path"}}; the
                # wire form is camelCase httpGet
                if "http_get" in p:
                    hg = p["http_get"]
                    return {"httpGet": {"port": int(hg["port"]),
                                        "path": hg.get("path", "/")}}
                return p
            if c.get("liveness_probe"):
                out["livenessProbe"] = probe(c["liveness_probe"])
            if c.get("readiness_probe"):
                out["readinessProbe"] = probe(c["readiness_probe"])
            out["resources"] = {"requests": {
                "cpu": str(pod.cpus), "memory": f"{int(pod.mem)}Mi",
                **({"nvidia.com/gpu": str(int(pod.gpus))}
                   if pod.gpus else {})}}
            res = c.get("resources")
            if res:  # per-container override (sidecar/init containers)
                out["resources"] = _resources_to_k8s(res)
            return out

        def volume(v):
            if "host_path" in v:
                return {"name": v["name"],
                        "hostPath": {"path": v["host_path"]}}
            ed = v.get("empty_dir", {})
            out = {}
            if ed.get("medium"):
                out["medium"] = ed["medium"]
            if "size_limit_mb" in ed:
                out["sizeLimit"] = f"{ed['size_limit_mb']}Mi"
            return {"name": v["name"], "emptyDir": out}

        body = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": pod.name, "namespace": self.namespace,
                         "labels": dict(pod.labels),
                         "annotations": dict(pod.annotations)},
            "spec": {
                "restartPolicy": spec.get("restart_policy", "Never"),
                "containers": [container(c)
                               for c in spec.get("containers", [])] or
                [container({"name": "cook-job",
                            "image": "cook/default-runtime:stable"})],
            },
        }
        ps = body["spec"]
        if pod.node_name:
            ps["nodeName"] = pod.node_name
        if spec.get("init_containers"):
            ps["initContainers"] = [container(c)
                                    for c in spec["init_containers"]]
        if spec.get("volumes"):
            ps["volumes"] = [volume(v) for v in spec["volumes"]]
        if spec.get("tolerations"):
            ps["tolerations"] = [
                {k.replace("_seconds", "Seconds"): v for k, v in t.items()}
                for t in spec["tolerations"]]
        if spec.get("node_selector"):
            ps["nodeSelector"] = spec["node_selector"]
        if spec.get("priority_class"):
            ps["priorityClassName"] = spec["priority_class"]
        if spec.get("shm_size_mb"):
            body["metadata"]["annotations"]["cook/shm-size-mb"] = \
                str(spec["shm_size_mb"])
        return body

    # -------------------------------------------------------------- surface
    def nodes(self) -> List[FakeNode]:
        out = self._request("GET", "/api/v1/nodes")
        return [self._node_from_json(n) for n in out.get("items", [])]

    def pods(self) -> List[FakePod]:
        out = self._request(
            "GET", f"/api/v1/namespaces/{self.namespace}/pods")
        return [self._pod_from_json(p) for p in out.get("items", [])]

    def pod(self, name: str) -> Optional[FakePod]:
        try:
            out = self._request(
                "GET", f"/api/v1/namespaces/{self.namespace}/pods/{name}")
            return self._pod_from_json(out)
        except ApiError as e:
            if e.status == 404:
                return None
            raise

    def create_pod(self, pod: FakePod) -> None:
        try:
            self._request(
                "POST", f"/api/v1/namespaces/{self.namespace}/pods",
                body=self._pod_to_json(pod))
        except ApiError as e:
            if e.status == 409:
                raise ValueError(f"pod {pod.name} already exists") from e
            raise

    def delete_pod(self, name: str, grace_period_s: Optional[float] = None,
                   now_ms: int = 0) -> None:
        q = ""
        if grace_period_s is not None:
            q = f"?gracePeriodSeconds={int(grace_period_s)}"
        try:
            self._request(
                "DELETE",
                f"/api/v1/namespaces/{self.namespace}/pods/{name}{q}")
        except ApiError as e:
            if e.status != 404:
                raise

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    # --------------------------------------------------------------- watches
    def watch(self, callback: Callable[[WatchEvent], None],
              resource_version: int = 0) -> None:
        """Start pod+node watch threads with resourceVersion resume
        (reference: watch bootstrap + gap handling, api.clj:372-475): a
        dropped connection resumes from the last seen resourceVersion; a
        410 Gone relists and emits the fresh objects before re-watching."""
        with self._lock:
            self._watchers.append(callback)
            if self._threads:
                return
            stop = self._stop = threading.Event()
            for kind in ("pod", "node"):
                t = threading.Thread(
                    target=self._watch_loop,
                    args=(kind, resource_version, stop),
                    daemon=True, name=f"k8s-watch-{kind}")
                t.start()
                self._threads.append(t)

    def unwatch(self, callback: Callable[[WatchEvent], None]) -> None:
        with self._lock:
            if callback in self._watchers:
                self._watchers.remove(callback)
            if not self._watchers:
                # stop THIS generation only; a later watch() gets a fresh
                # event + threads, and lingering old threads are muted by
                # their generation's stop flag in _emit
                self._stop.set()
                self._threads = []

    def _emit(self, kind: str, type_: str, obj, rv: int,
              stop: Optional[threading.Event] = None) -> None:
        if stop is not None and stop.is_set():
            return  # a stale generation's thread must not double-deliver
        with self._lock:
            self._rv = max(self._rv, rv)
            watchers = list(self._watchers)
        event = WatchEvent(kind, type_, obj, rv)
        for cb in watchers:
            cb(event)

    def _list_path(self, kind: str) -> str:
        return (f"/api/v1/namespaces/{self.namespace}/pods"
                if kind == "pod" else "/api/v1/nodes")

    def _relist(self, kind: str, known: Dict[str, object],
                stop: threading.Event) -> int:
        """Watch-gap recovery: list everything, emit the live objects as
        MODIFIED (the controller's handlers are reconciling, so replayed
        state is safe) and synthesize DELETED for objects that vanished
        during the gap — a pod garbage-collected while the watch was down
        must not stay RUNNING in the store forever.  Returns the
        collection resourceVersion to resume from."""
        out = self._request("GET", self._list_path(kind))
        rv = int((out.get("metadata") or {}).get("resourceVersion") or 0)
        seen = set()
        for item in out.get("items", []):
            obj = (self._pod_from_json(item) if kind == "pod"
                   else self._node_from_json(item))
            seen.add(obj.name)
            known[obj.name] = obj
            orv = getattr(obj, "resource_version", rv) or rv
            self._emit(kind, "MODIFIED", obj, int(orv), stop)
        for name in list(known):
            if name not in seen:
                self._emit(kind, "DELETED", known.pop(name), rv, stop)
        self.watch_gap_relists += 1
        return rv

    def _watch_loop(self, kind: str, start_rv: int,
                    stop: threading.Event) -> None:
        import logging

        from ...utils.faults import injector as _faults
        from ...utils.retry import Backoff
        log = logging.getLogger(__name__)
        rv: Optional[int] = start_rv
        known: Dict[str, object] = {}  # name -> last obj (for gap deletes)
        # ONE jittered-exponential policy for every retry branch below
        # (ERROR events, HTTP errors, dropped streams, parse errors):
        # full jitter so a fleet of watchers reconnecting after one
        # apiserver restart cannot synchronize into a relist storm
        backoff = Backoff(base_s=0.1, cap_s=5.0)
        delay = 0.0
        while not stop.is_set():
            try:
                _faults.fire(
                    "k8s.watch.disconnect",
                    lambda: ConnectionError("injected watch disconnect"))
                if _faults.should_fire("k8s.watch.gone"):
                    rv = None  # injected 410: force the relist path
                if rv is None:
                    rv = self._relist(kind, known, stop)
                q = urllib.parse.urlencode(
                    {"watch": "1", "resourceVersion": str(rv),
                     "timeoutSeconds": str(int(self.watch_timeout_s))})
                url = f"{self.base_url}{self._list_path(kind)}?{q}"
                req = urllib.request.Request(url)
                token = self._bearer()
                if token:
                    req.add_header("Authorization", f"Bearer {token}")
                with urllib.request.urlopen(
                        req, timeout=self.watch_timeout_s + 5,
                        context=self._ctx) as resp:
                    for line in resp:
                        if stop.is_set():
                            return
                        line = line.strip()
                        if not line:
                            continue
                        evt = json.loads(line)
                        if evt.get("type") == "ERROR":
                            code = (evt.get("object") or {}).get("code")
                            if code == 410:  # watch gap: relist + resume
                                rv = None
                            else:
                                log.warning(
                                    "k8s %s watch ERROR event: %s",
                                    kind, evt.get("object"))
                                delay = backoff.next_delay()
                            break
                        raw = evt.get("object") or {}
                        obj = (self._pod_from_json(raw) if kind == "pod"
                               else self._node_from_json(raw))
                        orv = int((raw.get("metadata") or {})
                                  .get("resourceVersion") or 0)
                        rv = max(int(rv or 0), orv)
                        if evt.get("type") == "DELETED":
                            known.pop(obj.name, None)
                        else:
                            known[obj.name] = obj
                        self._emit(kind, evt.get("type", "MODIFIED"),
                                   obj, orv, stop)
                        backoff.reset()  # healthy stream
                        delay = 0.0
                self.watch_reconnects += 1
            except urllib.error.HTTPError as e:
                if e.code == 410:
                    rv = None
                    continue
                delay = backoff.next_delay()
                log.warning("k8s %s watch HTTP %s; retrying in %.1fs",
                            kind, e.code, delay)
            except (urllib.error.URLError, socket.timeout,
                    ConnectionError, OSError) as e:
                # dropped stream: reconnect and resume from last seen rv
                self.watch_reconnects += 1
                delay = backoff.next_delay()
                log.debug("k8s %s watch dropped (%s); resuming rv=%s",
                          kind, e, rv)
            except json.JSONDecodeError:
                delay = backoff.next_delay()
            if delay:
                stop.wait(delay)
                delay = 0.0

    # --------------------------------------------------------------- leases
    # (coordination.k8s.io/v1; the surface LeaseLeaderElector drives —
    # same contract as FakeKubernetesApi.try_acquire_lease.)
    def _lease_path(self, name: str = "") -> str:
        base = (f"/apis/coordination.k8s.io/v1/namespaces/"
                f"{self.namespace}/leases")
        return f"{base}/{name}" if name else base

    @staticmethod
    def _lease_from_json(name: str, obj: Dict) -> Lease:
        spec = obj.get("spec") or {}
        meta = obj.get("metadata") or {}
        renew = spec.get("renewTime")
        return Lease(
            name=name, holder=spec.get("holderIdentity") or "",
            holder_url=(meta.get("annotations") or {}).get(
                "cook/leader-url", ""),
            renew_time_s=(_ts_ms(renew) or 0) / 1000.0,
            duration_s=float(spec.get("leaseDurationSeconds") or 15),
            transitions=int(spec.get("leaseTransitions") or 0),
            annotations=dict(meta.get("annotations") or {}))

    def get_lease(self, name: str) -> Optional[Lease]:
        try:
            obj = self._request("GET", self._lease_path(name))
        except ApiError as e:
            if e.status == 404:
                return None
            raise
        return self._lease_from_json(name, obj)

    def try_acquire_lease(self, name: str, identity: str, now_s: float,
                          duration_s: float = 15.0,
                          holder_url: str = "") -> Optional[Lease]:
        """Apiserver-CAS acquire/renew: the object's resourceVersion makes
        the replace conditional, so two contenders cannot both win."""
        body = {
            "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": {"name": name, "namespace": self.namespace,
                         "annotations": {"cook/leader-url": holder_url}},
            "spec": {"holderIdentity": identity,
                     "renewTime": rfc3339(now_s),
                     "leaseDurationSeconds": int(duration_s)},
        }
        try:
            cur = self._request("GET", self._lease_path(name))
        except ApiError as e:
            if e.status != 404:
                raise
            body["spec"]["leaseTransitions"] = 1
            try:
                self._request("POST", self._lease_path(), body=body)
            except ApiError as e2:
                if e2.status == 409:  # lost the create race
                    return None
                raise
            return Lease(name=name, holder=identity, holder_url=holder_url,
                         renew_time_s=now_s, duration_s=duration_s,
                         transitions=1)
        spec = cur.get("spec") or {}
        renew_s = (_ts_ms(spec.get("renewTime")) or 0) / 1000.0
        expired = now_s - renew_s > float(
            spec.get("leaseDurationSeconds") or duration_s)
        holder = spec.get("holderIdentity") or ""
        if holder and holder != identity and not expired:
            return None
        transitions = int(spec.get("leaseTransitions") or 0)
        if holder != identity:
            transitions += 1
        # preserve foreign annotations (candidate positions ride here) —
        # a renewal replacing the whole object must not wipe them
        body["metadata"]["annotations"] = {
            **((cur.get("metadata") or {}).get("annotations") or {}),
            "cook/leader-url": holder_url}
        body["metadata"]["resourceVersion"] = \
            (cur.get("metadata") or {}).get("resourceVersion")
        body["spec"]["leaseTransitions"] = transitions
        try:
            self._request("PUT", self._lease_path(name), body=body)
        except ApiError as e:
            if e.status == 409:  # CAS lost: someone renewed under us
                return None
            raise
        return Lease(name=name, holder=identity, holder_url=holder_url,
                     renew_time_s=now_s, duration_s=duration_s,
                     transitions=transitions)

    def annotate_lease(self, name: str,
                       annotations: Dict[str, Optional[str]]) -> None:
        """Merge annotations onto the lease (None deletes a key) — the
        candidate-position plane of coordinated promotion.  CAS via
        resourceVersion with a small retry budget: losing the race to a
        renewal just means re-reading and re-merging."""
        for _attempt in range(4):
            try:
                cur = self._request("GET", self._lease_path(name))
            except ApiError as e:
                if e.status != 404:
                    raise
                cur = {"apiVersion": "coordination.k8s.io/v1",
                       "kind": "Lease",
                       "metadata": {"name": name,
                                    "namespace": self.namespace},
                       "spec": {}}
            meta = cur.setdefault("metadata", {})
            merged = dict(meta.get("annotations") or {})
            for k, v in annotations.items():
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = str(v)
            meta["annotations"] = merged
            create = not meta.get("resourceVersion")
            try:
                if create:
                    self._request("POST", self._lease_path(), body=cur)
                else:
                    self._request("PUT", self._lease_path(name), body=cur)
                return
            except ApiError as e:
                if e.status != 409:  # CAS/create race: re-read, re-merge
                    raise
        # one-shot callers (clear_candidate, the promotion-time final
        # position) must not believe a dropped update was applied
        raise ApiError(409, f"lease {name} annotation update lost the "
                            "CAS race 4 times; retry")

    def release_lease(self, name: str, identity: str) -> None:
        """Explicit release on clean shutdown: clear holderIdentity so a
        standby acquires immediately instead of waiting out the TTL."""
        try:
            cur = self._request("GET", self._lease_path(name))
        except ApiError as e:
            if e.status == 404:
                return
            raise
        spec = cur.get("spec") or {}
        if (spec.get("holderIdentity") or "") != identity:
            return  # someone else holds it now; not ours to clear
        spec["holderIdentity"] = ""
        spec["renewTime"] = None
        meta = cur.setdefault("metadata", {})
        if meta.get("annotations"):
            meta["annotations"]["cook/leader-url"] = ""
        try:
            self._request("PUT", self._lease_path(name), body=cur)
        except ApiError as e:
            if e.status != 409:  # CAS lost: a competitor already took it
                raise
