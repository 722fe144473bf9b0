"""The port's copy of ``cook_tpu/cluster/k8s/mock_apiserver.py``
(imports re-rooted).

In-repo HTTP mock of the Kubernetes apiserver.

Serves the REST subset :class:`real_api.RealKubernetesApi` speaks —
list/get/create/delete pods, list nodes, chunked ``?watch=1`` streams
with resourceVersion semantics (including the 410 Gone watch-gap ERROR
event), and coordination/v1 leases with resourceVersion compare-and-swap
— in front of a :class:`fake_api.FakeKubernetesApi`, whose lifecycle
simulation hooks (``step``/``finish_pod``/``lose_node``/sticky deletion)
then drive the wire protocol.  This is what lets the real client adapter
execute every code path over real sockets without a cluster
(tests/test_k8s_real_api.py; reference for the behaviors mocked:
scheduler/src/cook/kubernetes/api.clj:372-734).

Fault injection for tests:
 - :meth:`drop_watch_streams` hard-closes active watch connections (the
   client must reconnect and resume from its last resourceVersion);
 - :meth:`compact` sets the history horizon so a watch from an older
   resourceVersion gets the 410 Gone ERROR event (client must relist).
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from .fake_api import FakeKubernetesApi, FakeNode, FakePod
from .real_api import RealKubernetesApi, rfc3339


def node_to_json(n: FakeNode) -> Dict:
    labels = dict(n.labels)
    labels.setdefault("cook-pool", n.pool)
    if n.gpu_model:
        labels.setdefault("gpu-model", n.gpu_model)
    return {
        "apiVersion": "v1", "kind": "Node",
        "metadata": {"name": n.name, "labels": labels},
        "spec": {"taints": [{"key": k, "effect": "NoSchedule"}
                            for k in n.taints],
                 "unschedulable": n.unschedulable},
        "status": {"allocatable": {
            "cpu": str(n.cpus), "memory": f"{int(n.mem)}Mi",
            "nvidia.com/gpu": str(int(n.gpus))}},
    }


def pod_to_json(p: FakePod) -> Dict:
    labels = dict(p.labels)
    if p.synthetic:
        labels.setdefault("cook/synthetic", "true")
    meta: Dict = {"name": p.name, "labels": labels,
                  "annotations": dict(p.annotations),
                  "resourceVersion": str(p.resource_version)}
    if p.creation_ms:
        meta["creationTimestamp"] = rfc3339(p.creation_ms / 1000.0)
    if p.deleted:
        meta["deletionTimestamp"] = rfc3339((p.deletion_ms or 0) / 1000.0)
    status: Dict = {"phase": p.phase}
    if p.reason:
        status["reason"] = p.reason
    if p.unschedulable_reason:
        status["conditions"] = [{
            "type": "PodScheduled", "status": "False",
            "reason": "Unschedulable", "message": p.unschedulable_reason}]
    if p.exit_code is not None:
        status["containerStatuses"] = [{
            "name": "cook-job",
            "state": {"terminated": {"exitCode": p.exit_code,
                                     "reason": p.reason or "Completed"}}}]
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": meta,
        "spec": {"nodeName": p.node_name,
                 "containers": [{"name": "cook-job",
                                 "resources": {"requests": {
                                     "cpu": str(p.cpus),
                                     "memory": f"{int(p.mem)}Mi",
                                     **({"nvidia.com/gpu":
                                         str(int(p.gpus))}
                                        if p.gpus else {})}}}]},
        "status": status,
    }


def _status(code: int, reason: str, message: str = "") -> Dict:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "code": code, "reason": reason, "message": message}


class MockApiServer:
    """HTTP(S) front-end over a FakeKubernetesApi.  ``base_url`` is what
    a RealKubernetesApi should be pointed at.

    TLS (the reference's client stack is TLS everywhere —
    kubernetes/api.clj:372-475, project.clj:152-156): pass
    ``tls_cert``/``tls_key`` to serve https.  ``client_ca`` additionally
    REQUIRES a client certificate signed by that CA (mTLS) at the
    handshake.  ``bearer_token`` rejects any request without the
    matching ``Authorization: Bearer`` header with a k8s-shaped 401."""

    def __init__(self, fake: Optional[FakeKubernetesApi] = None,
                 host: str = "127.0.0.1",
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 client_ca: Optional[str] = None,
                 bearer_token: Optional[str] = None):
        self.fake = fake or FakeKubernetesApi()
        self._tls = bool(tls_cert)
        if (client_ca or tls_key) and not tls_cert:
            # a test passing client_ca alone would otherwise serve plain
            # HTTP and "pass" with zero mTLS enforcement
            raise ValueError("client_ca/tls_key require tls_cert")
        self.bearer_token = bearer_token
        self._lock = threading.Lock()
        self._leases: Dict[str, Dict] = {}   # name -> lease JSON
        self._lease_rv = 0
        self.min_rv = 0                       # 410 horizon (compact())
        self._drop_generation = 0             # bumping ends active streams
        self.last_created_bodies: List[Dict] = []  # golden-test capture
        self.requests: List[str] = []
        mock = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: Dict) -> None:
                raw = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _read_body(self) -> Dict:
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n)) if n else {}

            def _authorized(self) -> bool:
                """Bearer-token check (TLS client-cert identity is
                enforced earlier, at the handshake)."""
                if mock.bearer_token is None:
                    return True
                got = self.headers.get("Authorization") or ""
                if got == f"Bearer {mock.bearer_token}":
                    return True
                # drain the body first: an unread body left in a
                # keep-alive stream would be parsed as the next request
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                self._json(401, _status(401, "Unauthorized",
                                        "invalid bearer token"))
                return False

            def do_GET(self):
                mock.requests.append(f"GET {self.path}")
                if not self._authorized():
                    return
                u = urlparse(self.path)
                q = parse_qs(u.query)
                parts = [p for p in u.path.split("/") if p]
                if u.path == "/api/v1/nodes" and q.get("watch"):
                    return mock._serve_watch(self, "node", q)
                if u.path == "/api/v1/nodes":
                    return self._json(200, {
                        "kind": "NodeList",
                        "metadata": {"resourceVersion":
                                     str(mock.fake.resource_version)},
                        "items": [node_to_json(n)
                                  for n in mock.fake.nodes()]})
                # /api/v1/namespaces/{ns}/pods[/name]
                if len(parts) == 5 and parts[0] == "api" \
                        and parts[4] == "pods":
                    if q.get("watch"):
                        return mock._serve_watch(self, "pod", q)
                    return self._json(200, {
                        "kind": "PodList",
                        "metadata": {"resourceVersion":
                                     str(mock.fake.resource_version)},
                        "items": [pod_to_json(p)
                                  for p in mock.fake.pods()]})
                if len(parts) == 6 and parts[4] == "pods":
                    pod = mock.fake.pod(parts[5])
                    if pod is None:
                        return self._json(404, _status(404, "NotFound"))
                    return self._json(200, pod_to_json(pod))
                if "coordination.k8s.io" in u.path and parts[-2] == "leases":
                    with mock._lock:
                        lease = mock._leases.get(parts[-1])
                    if lease is None:
                        return self._json(404, _status(404, "NotFound"))
                    return self._json(200, lease)
                return self._json(404, _status(404, "NotFound", u.path))

            def do_POST(self):
                mock.requests.append(f"POST {self.path}")
                if not self._authorized():
                    return
                u = urlparse(self.path)
                parts = [p for p in u.path.split("/") if p]
                body = self._read_body()
                if parts and parts[-1] == "pods":
                    mock.last_created_bodies.append(body)
                    pod = RealKubernetesApi._pod_from_json(body)
                    pod.spec = {"raw": body}
                    if not pod.creation_ms:
                        import time as _t
                        pod.creation_ms = int(_t.time() * 1000)
                    try:
                        mock.fake.create_pod(pod)
                    except ValueError:
                        return self._json(
                            409, _status(409, "AlreadyExists"))
                    return self._json(201, pod_to_json(pod))
                if parts and parts[-1] == "leases":
                    name = (body.get("metadata") or {}).get("name", "")
                    with mock._lock:
                        if name in mock._leases:
                            return self._json(
                                409, _status(409, "AlreadyExists"))
                        mock._lease_rv += 1
                        body.setdefault("metadata", {})["resourceVersion"] \
                            = str(mock._lease_rv)
                        mock._leases[name] = body
                    return self._json(201, body)
                return self._json(404, _status(404, "NotFound", u.path))

            def do_PUT(self):
                mock.requests.append(f"PUT {self.path}")
                if not self._authorized():
                    return
                u = urlparse(self.path)
                parts = [p for p in u.path.split("/") if p]
                body = self._read_body()
                if len(parts) >= 2 and parts[-2] == "leases":
                    name = parts[-1]
                    with mock._lock:
                        cur = mock._leases.get(name)
                        if cur is None:
                            return self._json(404, _status(404, "NotFound"))
                        sent_rv = (body.get("metadata") or {}).get(
                            "resourceVersion")
                        cur_rv = (cur.get("metadata") or {}).get(
                            "resourceVersion")
                        if sent_rv is not None and sent_rv != cur_rv:
                            return self._json(
                                409, _status(409, "Conflict",
                                             "resourceVersion mismatch"))
                        mock._lease_rv += 1
                        body.setdefault("metadata", {})["resourceVersion"] \
                            = str(mock._lease_rv)
                        mock._leases[name] = body
                    return self._json(200, body)
                return self._json(404, _status(404, "NotFound", u.path))

            def do_DELETE(self):
                mock.requests.append(f"DELETE {self.path}")
                if not self._authorized():
                    return
                u = urlparse(self.path)
                q = parse_qs(u.query)
                parts = [p for p in u.path.split("/") if p]
                if len(parts) == 6 and parts[4] == "pods":
                    name = parts[5]
                    if mock.fake.pod(name) is None:
                        return self._json(404, _status(404, "NotFound"))
                    grace = q.get("gracePeriodSeconds")
                    mock.fake.delete_pod(
                        name,
                        grace_period_s=(float(grace[0]) if grace
                                        else None))
                    return self._json(200, _status(200, "Success"))
                return self._json(404, _status(404, "NotFound", u.path))

        self._httpd = ThreadingHTTPServer((host, 0), Handler)
        if self._tls:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            if client_ca:
                # mTLS: the handshake itself rejects clients without a
                # certificate signed by this CA
                ctx.load_verify_locations(cafile=client_ca)
                ctx.verify_mode = ssl.CERT_REQUIRED
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                                 server_side=True)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="mock-apiserver")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MockApiServer":
        self._thread.start()
        return self

    @property
    def base_url(self) -> str:
        host, port = self._httpd.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------- fault injection
    def drop_watch_streams(self) -> None:
        """Hard-end every active watch stream (a client must reconnect and
        resume from its last resourceVersion)."""
        self._drop_generation += 1

    def compact(self, min_rv: Optional[int] = None) -> None:
        """Move the watch-history horizon: a watch from an older
        resourceVersion gets the 410 Gone ERROR event (client relists)."""
        self.min_rv = (self.fake.resource_version if min_rv is None
                       else min_rv)

    # ------------------------------------------------------------- watching
    def _serve_watch(self, handler, kind: str, q) -> None:
        rv = int((q.get("resourceVersion") or ["0"])[0])
        timeout_s = float((q.get("timeoutSeconds") or ["30"])[0])
        generation = self._drop_generation

        def chunk(obj: Dict) -> bytes:
            raw = json.dumps(obj).encode() + b"\n"
            return hex(len(raw))[2:].encode() + b"\r\n" + raw + b"\r\n"

        handler.send_response(200)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        if 0 < rv < self.min_rv:
            # watch gap: history before min_rv is compacted away
            handler.wfile.write(chunk({
                "type": "ERROR",
                "object": _status(410, "Gone", "too old resource version")}))
            handler.wfile.write(b"0\r\n\r\n")
            return
        events: "queue.Queue" = queue.Queue()

        def cb(evt):
            if evt.kind == kind:
                events.put(evt)

        self.fake.watch(cb, resource_version=rv)
        try:
            import time as _t
            deadline = _t.time() + timeout_s
            while _t.time() < deadline:
                if generation != self._drop_generation:
                    return  # fault injection: drop without clean close
                try:
                    evt = events.get(timeout=0.05)
                except queue.Empty:
                    continue
                obj = (pod_to_json(evt.obj) if kind == "pod"
                       else node_to_json(evt.obj))
                obj.setdefault("metadata", {})["resourceVersion"] = \
                    str(evt.resource_version)
                try:
                    handler.wfile.write(chunk(
                        {"type": evt.type, "object": obj}))
                    handler.wfile.flush()
                except (BrokenPipeError, ConnectionError):
                    return
            try:
                handler.wfile.write(b"0\r\n\r\n")  # clean timeout close
            except (BrokenPipeError, ConnectionError):
                pass
        finally:
            self.fake.unwatch(cb)
