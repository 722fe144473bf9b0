"""The port's copy of ``cook_tpu/federation/rest.py`` (imports
re-rooted): the federation front door, a stateless HTTP tier over N
cells.  :func:`build_federation_node` takes the ``device`` its router's
goodput replays run on (``router.py``).

This is the ``federation`` daemon role (a ``"federation"`` section in
the daemon conf makes the process a router node: no store, no journal,
no election).  Two operating regimes, chosen purely by cell count:

**Single cell** — the router is a pure reverse proxy.  Request and
response bytes pass through verbatim, commit tokens stay unqualified,
no global enforcement runs (the cell's own admission is the only
admission).  A client cannot distinguish the front door from a direct
cell connection — the wire-parity contract tier-1 asserts.

**Multiple cells** — submissions route whole-batch by locality, load,
tier and saturation (federation/router.py); accepted writes come back
with their ``X-Cook-Commit-Offset`` CELL-QUALIFIED (``cellA/p0:3:128``)
so one session token spans journals; reads carry the vector back, the
router strips it to the target cell's entries (cells never see cell
ids) and names every OTHER cell the vector mentioned in
``X-Cook-Federation-Stale-Cells`` — the read is honestly bounded-stale
with respect to those cells, never faked fresh.  Reads the router
cannot answer faithfully across cells are refused with 501 and the
reason, not half-answered.

Routes served by the router itself (API_ROUTES-style table below,
harvested into the OBSERVABILITY.md endpoint registry):
``/debug/federation`` (the routing panel), ``/debug/health``,
``/metrics``, ``/info``, plus the drain/rejoin/reclaim admin POSTs.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..config import FederationConfig
from ..utils.metrics import registry
from .cells import CellUnreachable
from .router import FederationRouter, RouteRejected
from .tokens import qualify_token, strip_for_cell

#: (method, path, summary, admin_only) — the front door's own surface.
#: Everything else is proxied/routed to cells (or honestly refused).
FEDERATION_ROUTES = [
    ("GET", "/debug/federation",
     "federation routing panel: per-cell breaker/drain/saturation, "
     "ledger depth, global summary staleness, reroute counters", False),
    ("GET", "/debug/health",
     "router health roll-up: eligible cell count, per-cell breaker "
     "states, summary staleness", False),
    ("GET", "/metrics", "router Prometheus metrics", False),
    ("GET", "/info", "router identity + cell roster", False),
    ("POST", "/federation/drain/{cell}",
     "drain a cell: no new demand, summary leaves the merge", True),
    ("POST", "/federation/rejoin/{cell}",
     "rejoin a drained cell: takes demand, summary re-converges", True),
    ("POST", "/federation/reclaim/{cell}",
     "reclaim a cell (spot tier / outage): drain + whole-batch "
     "mea-culpa re-route of its accepted demand", True),
]

#: hop-by-hop / recomputed headers never forwarded in either direction
_HOP_HEADERS = {"host", "connection", "content-length", "server",
                "date", "transfer-encoding", "keep-alive"}

#: read paths fanned out to EVERY serving cell and merged (list-shaped
#: answers concatenate; /usage sums; /pools unions by name)
_FANOUT_CONCAT = {"/list", "/running"}
_FANOUT_UNION = {"/pools"}


def _forwardable(headers) -> Dict[str, str]:
    return {k: v for k, v in headers.items()
            if k.lower() not in _HOP_HEADERS}


class _FederationHandler(BaseHTTPRequestHandler):
    router: FederationRouter  # bound per-server subclass
    protocol_version = "HTTP/1.1"
    # Nagle off, same as the cell server (rest/api.py): the proxied
    # response is written headers-then-body, and on localhost the
    # second segment would otherwise sit out a ~40ms delayed-ACK round
    # per request — 10x the whole routed hop.
    disable_nagle_algorithm = True
    timeout = 120
    # fully-buffered response stream: status line, relayed headers and
    # the proxied body coalesce into ONE sendall per response
    # (handle_one_request flushes after every method call, so
    # keep-alive responses still go out immediately)
    wbufsize = -1

    def log_message(self, fmt, *args):  # quiet, like the cell server
        pass

    # ------------------------------------------------------------ plumbing
    def _body(self) -> bytes:
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            n = 0
        return self.rfile.read(n) if n > 0 else b""

    def _respond_json(self, status: int, payload: Any,
                      extra_headers: Optional[Dict[str, str]] = None
                      ) -> None:
        raw = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(raw)

    def _respond_raw(self, status: int, headers: Dict[str, str],
                     raw: bytes,
                     extra_headers: Optional[Dict[str, str]] = None
                     ) -> None:
        """Pass a cell's answer through byte-identically (plus any
        router-added headers) — the wire-parity path."""
        self.send_response(status)
        for k, v in headers.items():
            if k.lower() not in _HOP_HEADERS:
                self.send_header(k, v)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _user(self) -> str:
        return str(self.headers.get("X-Cook-User") or "")

    # ------------------------------------------------------------- proxying
    def _proxy(self, handle, method: str, target: str,
               body: Optional[bytes],
               extra_resp_headers: Optional[Dict[str, str]] = None,
               req_headers: Optional[Dict[str, str]] = None) -> None:
        try:
            status, resp_headers, raw = handle.request(
                method, target, body=body,
                headers=req_headers if req_headers is not None
                else _forwardable(self.headers))
        except CellUnreachable as exc:
            self._respond_json(503, {"error": str(exc),
                                     "cell": handle.spec.id},
                              extra_headers={"Retry-After": "2"})
            return
        self._respond_raw(status, resp_headers, raw,
                          extra_headers=extra_resp_headers)

    def _target(self) -> Tuple[str, str, Dict[str, List[str]]]:
        parsed = urllib.parse.urlparse(self.path)
        target = (parsed.path or "/") + \
            ("?" + parsed.query if parsed.query else "")
        return parsed.path or "/", target, \
            urllib.parse.parse_qs(parsed.query)

    def _read_headers_for_cell(self, cell_id: str
                               ) -> Tuple[Dict[str, str],
                                          Optional[Dict[str, str]]]:
        """Forwarded headers for a read against ``cell_id``: the
        client's commit-token vector reduced to that cell's entries
        (prefix stripped — the cell's wait gate speaks the intra-cell
        grammar), plus the honest stale-cells response header when the
        vector named anyone else."""
        fwd = _forwardable(self.headers)
        want = self.headers.get("X-Cook-Min-Offset")
        if want is None or self.router.single_cell:
            return fwd, None
        cell_token, others = strip_for_cell(want, cell_id)
        if cell_token is None:
            fwd.pop("X-Cook-Min-Offset", None)
        else:
            fwd["X-Cook-Min-Offset"] = cell_token
        if others:
            registry.counter_inc("cook_federation_stale_reads_total")
            return fwd, {"X-Cook-Federation-Stale-Cells":
                         ",".join(sorted(others))}
        return fwd, None

    # ------------------------------------------------------------- routing
    def _route(self, method: str) -> None:
        path, target, params = self._target()
        router = self.router
        try:
            # ---- the router's own surface.  Only /debug/federation and
            # the /federation/* admin verbs are claimed unconditionally
            # (no cell serves them); /info, /metrics and /debug/health
            # are router-local ONLY with multiple cells — a single-cell
            # front door proxies them for byte-level wire parity.
            if method == "GET" and path == "/debug/federation":
                router.probe_all()
                self._respond_json(200, router.to_doc())
                return
            parts = [p for p in path.split("/") if p]
            if method == "POST" and len(parts) == 3 \
                    and parts[0] == "federation" \
                    and parts[1] in ("drain", "rejoin", "reclaim"):
                self._body()  # drain any body, keep keep-alive sound
                op = {"drain": router.drain_cell,
                      "rejoin": router.rejoin_cell,
                      "reclaim": router.reclaim_cell}[parts[1]]
                self._respond_json(200, op(parts[2]))
                return

            # ---- single cell: pure reverse proxy, wire-identical
            if router.single_cell:
                handle = next(iter(router.cells.values()))
                body = self._body() if method in ("POST", "PUT",
                                                  "DELETE") else None
                self._proxy(handle, method, target, body)
                return

            if method == "GET" and path == "/debug/health":
                self._respond_json(200, self._health_doc())
                return
            if method == "GET" and path == "/metrics":
                raw = registry.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)
                return
            if method == "GET" and path == "/info":
                self._respond_json(200, {
                    "role": "federation-router",
                    "cells": [h.spec.id for h in router.cells.values()],
                    "single_cell": router.single_cell})
                return

            # ---- multi-cell routing
            if method == "POST" and path in ("/jobs", "/rawscheduler"):
                self._submit()
                return
            if method == "GET":
                self._routed_read(path, target, params, parts)
                return
            if method == "DELETE" and path in ("/jobs", "/rawscheduler"):
                self._routed_kill(target, params)
                return
            if method in ("POST", "PUT") and path == "/retry":
                self._routed_retry(method, target)
                return
            self._respond_json(
                501, {"error": f"{method} {path} is not federated: the "
                               "front door cannot answer it faithfully "
                               "across cells — address the owning cell "
                               "directly (docs/DEPLOY.md multi-cell "
                               "federation)"})
        except RouteRejected as e:
            self._respond_json(e.status,
                              {"error": e.message, **e.extra},
                              extra_headers=e.headers)
        except Exception as e:  # pragma: no cover
            self._respond_json(500, {"error": f"router error: {e}"})

    def _health_doc(self) -> Dict[str, Any]:
        router = self.router
        eligible = router.eligible_cells()
        try:
            staleness = round(min(router.summaries.staleness_s(), 1e12), 3)
        except Exception:
            staleness = None
        return {"healthy": bool(eligible),
                "role": "federation-router",
                "cells_total": len(router.cells),
                "cells_eligible": len(eligible),
                "cells": {h.spec.id: {"breaker": h.breaker.state,
                                      "drained": h.drained}
                          for h in router.cells.values()},
                "summary_staleness_s": staleness}

    # ---------------------------------------------------------- write paths
    def _submit(self) -> None:
        raw = self._body()
        status, headers, resp_raw, cell_id = self.router.submit(
            raw, self._user(), _forwardable(self.headers))
        extra = None
        token = headers.get("X-Cook-Commit-Offset") \
            or headers.get("x-cook-commit-offset")
        if token:
            # the ONE header rewrite the front door performs: qualify
            # the cell's commit token so the client's session vector
            # can span journals
            headers = {k: v for k, v in headers.items()
                       if k.lower() != "x-cook-commit-offset"}
            extra = {"X-Cook-Commit-Offset":
                     qualify_token(cell_id, token)}
        self._respond_raw(status, headers, resp_raw, extra_headers=extra)

    def _routed_kill(self, target: str,
                     params: Dict[str, List[str]]) -> None:
        uuids = params.get("uuid") or params.get("job") or []
        by_cell = self._group_by_cell(uuids)
        if by_cell is None:
            return
        # kill fans out per owning cell; the combined answer is the
        # union (each cell only sees its own uuids)
        merged: Dict[str, Any] = {}
        worst = 200
        for cell_id, cell_uuids in by_cell.items():
            handle = self.router.cell(cell_id)
            q = urllib.parse.urlencode([("uuid", u) for u in cell_uuids])
            base = target.split("?", 1)[0]
            try:
                status, _, raw = handle.request(
                    "DELETE", f"{base}?{q}",
                    headers=_forwardable(self.headers))
            except CellUnreachable as exc:
                self._respond_json(503, {"error": str(exc),
                                         "cell": cell_id},
                                  extra_headers={"Retry-After": "2"})
                return
            if status >= worst:
                worst = status
            try:
                doc = json.loads(raw.decode() or "{}")
                if isinstance(doc, dict):
                    merged.update(doc)
            except ValueError:
                pass
        self._respond_json(worst, merged)

    def _routed_retry(self, method: str, target: str) -> None:
        raw = self._body()
        try:
            body = json.loads(raw.decode() or "{}")
        except ValueError:
            self._respond_json(400, {"error": "malformed retry body"})
            return
        uuids = [str(u) for u in (body.get("jobs") or [])]
        if body.get("job"):
            uuids.append(str(body["job"]))
        cells = {self.router.cell_of_uuid(u) for u in uuids}
        cells.discard(None)
        if len(cells) != 1:
            self._respond_json(
                400 if len(cells) > 1 else 404,
                {"error": "retry batch must target ONE cell's jobs "
                          f"(found {len(cells)} owning cells for "
                          f"{len(uuids)} uuids; split the batch per "
                          "cell)"})
            return
        handle = self.router.cell(cells.pop())
        self._proxy(handle, method, target, raw)

    # ----------------------------------------------------------- read paths
    def _group_by_cell(self,
                       uuids: List[str]) -> Optional[Dict[str, List[str]]]:
        """Owning cell per uuid from the commit ledger; answers the
        request itself (404, honest) when any uuid has no known owner
        and returns None."""
        by_cell: Dict[str, List[str]] = {}
        unknown = []
        for u in uuids:
            cell = self.router.cell_of_uuid(u)
            if cell is None:
                unknown.append(u)
            else:
                by_cell.setdefault(cell, []).append(u)
        if unknown:
            # probe each serving cell for the first unknown uuid rather
            # than failing blind: uuids submitted around a router
            # restart are findable, just not ledgered
            for u in unknown:
                found = self._find_cell(u)
                if found is None:
                    self._respond_json(
                        404, {"error": f"job {u} is unknown to this "
                                       "federation router (not in the "
                                       "commit ledger and no serving "
                                       "cell knows it)"})
                    return None
                by_cell.setdefault(found, []).append(u)
        if not by_cell:
            self._respond_json(400, {"error": "no uuids supplied"})
            return None
        return by_cell

    def _find_cell(self, uuid: str) -> Optional[str]:
        for handle in self.router.cells.values():
            if not handle.serving() or not handle.breaker.allow():
                continue
            try:
                status, _, _ = handle.request("GET", f"/jobs/{uuid}",
                                              headers={})
            except CellUnreachable:
                continue
            if status == 200:
                return handle.spec.id
        return None

    def _routed_read(self, path: str, target: str,
                     params: Dict[str, List[str]],
                     parts: List[str]) -> None:
        router = self.router
        # one-uuid paths: /jobs/{u}, /instances/{t},
        # /debug/job/{u}/timeline route to the owning cell
        uuid_path = None
        if len(parts) == 2 and parts[0] in ("jobs", "instances"):
            uuid_path = parts[1]
        elif len(parts) == 4 and parts[0] == "debug" \
                and parts[1] == "job" and parts[3] == "timeline":
            uuid_path = parts[2]
        if uuid_path is not None:
            cell = router.cell_of_uuid(uuid_path) \
                if parts[0] != "instances" else None
            if cell is None:
                cell = self._find_cell(uuid_path.split("-inst")[0]
                                       if parts[0] == "instances"
                                       else uuid_path)
            if cell is None and parts[0] == "instances":
                # instance ids don't map to job uuids generically:
                # ask each cell
                for handle in router.cells.values():
                    if handle.serving() and handle.breaker.allow():
                        fwd, extra = self._read_headers_for_cell(
                            handle.spec.id)
                        try:
                            status, hs, raw = handle.request(
                                "GET", target, headers=fwd)
                        except CellUnreachable:
                            continue
                        if status == 200:
                            self._respond_raw(status, hs, raw,
                                              extra_headers=extra)
                            return
                self._respond_json(404, {"error":
                                         f"no cell knows {uuid_path}"})
                return
            if cell is None:
                self._respond_json(
                    404, {"error": f"job {uuid_path} is unknown to "
                                   "this federation router"})
                return
            handle = router.cell(cell)
            fwd, extra = self._read_headers_for_cell(cell)
            self._proxy(handle, "GET", target, None,
                        extra_resp_headers=extra, req_headers=fwd)
            return
        if path in ("/jobs", "/rawscheduler", "/group"):
            uuids = params.get("uuid") or []
            if path == "/group" and uuids:
                # group uuids are not ledgered: probe cells for the
                # group and serve the first 200
                for handle in router.cells.values():
                    if not handle.serving() or not handle.breaker.allow():
                        continue
                    fwd, extra = self._read_headers_for_cell(
                        handle.spec.id)
                    try:
                        status, hs, raw = handle.request("GET", target,
                                                         headers=fwd)
                    except CellUnreachable:
                        continue
                    if status == 200:
                        self._respond_raw(status, hs, raw,
                                          extra_headers=extra)
                        return
                self._respond_json(404,
                                   {"error": "no cell knows this group"})
                return
            by_cell = self._group_by_cell(uuids)
            if by_cell is None:
                return
            if len(by_cell) == 1:
                cell_id, cell_uuids = next(iter(by_cell.items()))
                fwd, extra = self._read_headers_for_cell(cell_id)
                self._proxy(router.cell(cell_id), "GET", target, None,
                            extra_resp_headers=extra, req_headers=fwd)
                return
            # uuids span cells: fan out per owning cell, concatenate
            merged_list: List[Any] = []
            stale: List[str] = []
            base = target.split("?", 1)[0]
            for cell_id, cell_uuids in by_cell.items():
                handle = router.cell(cell_id)
                fwd, extra = self._read_headers_for_cell(cell_id)
                if extra:
                    stale.append(extra["X-Cook-Federation-Stale-Cells"])
                q = urllib.parse.urlencode([("uuid", u)
                                            for u in cell_uuids])
                try:
                    status, _, raw = handle.request(
                        "GET", f"{base}?{q}", headers=fwd)
                except CellUnreachable as exc:
                    self._respond_json(503, {"error": str(exc),
                                             "cell": cell_id},
                                      extra_headers={"Retry-After": "2"})
                    return
                if status != 200:
                    self._respond_raw(status, {}, raw)
                    return
                doc = json.loads(raw.decode() or "[]")
                merged_list.extend(doc if isinstance(doc, list)
                                   else [doc])
            self._respond_json(
                200, merged_list,
                extra_headers={"X-Cook-Federation-Stale-Cells":
                               ",".join(sorted(set(",".join(stale)
                                                   .split(","))))}
                if stale else None)
            return
        if path in _FANOUT_CONCAT or path in _FANOUT_UNION \
                or path in ("/usage", "/failure_reasons",
                            "/stats/instances"):
            self._fanout_read(path, target)
            return
        self._respond_json(
            501, {"error": f"GET {path} is not federated — address the "
                           "owning cell directly (docs/DEPLOY.md "
                           "multi-cell federation)"})

    def _fanout_read(self, path: str, target: str) -> None:
        """Fan a read out to every serving cell and merge: lists
        concatenate, /usage sums numbers, /pools unions by name,
        /failure_reasons serves the first answer (identical tables)."""
        router = self.router
        answers: List[Any] = []
        for handle in router.cells.values():
            if not handle.serving() or not handle.breaker.allow():
                continue
            fwd, _ = self._read_headers_for_cell(handle.spec.id)
            try:
                status, _, raw = handle.request("GET", target,
                                                headers=fwd)
            except CellUnreachable:
                continue
            if status != 200:
                self._respond_raw(status, {}, raw)
                return
            try:
                answers.append(json.loads(raw.decode() or "null"))
            except ValueError:
                self._respond_json(502, {"error": "unparseable cell "
                                                  "answer",
                                         "cell": handle.spec.id})
                return
        if not answers:
            self._respond_json(503, {"error": "no serving cell answered"},
                              extra_headers={"Retry-After": "2"})
            return
        if path == "/failure_reasons":
            self._respond_json(200, answers[0])
        elif path in _FANOUT_UNION:
            by_name: Dict[str, Any] = {}
            for doc in answers:
                for item in (doc or []):
                    by_name.setdefault(item.get("name"), item)
            self._respond_json(200, list(by_name.values()))
        elif path == "/usage" or path == "/stats/instances":
            self._respond_json(200, _sum_merge(answers))
        else:
            merged: List[Any] = []
            for doc in answers:
                merged.extend(doc if isinstance(doc, list) else [doc])
            self._respond_json(200, merged)

    # --------------------------------------------------------- verb mapping
    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_PUT(self):
        self._route("PUT")

    def do_DELETE(self):
        self._route("DELETE")


def _sum_merge(docs: List[Any]) -> Any:
    """Recursively merge JSON documents: numbers add, objects merge
    key-wise, lists concatenate, scalars keep the first answer."""
    first = docs[0]
    if isinstance(first, dict):
        out: Dict[str, Any] = {}
        for doc in docs:
            if not isinstance(doc, dict):
                continue
            for k, v in doc.items():
                if k in out:
                    out[k] = _sum_merge([out[k], v])
                else:
                    out[k] = v
        return out
    if isinstance(first, bool):
        return first
    if isinstance(first, (int, float)):
        return sum(d for d in docs if isinstance(d, (int, float))
                   and not isinstance(d, bool))
    if isinstance(first, list):
        out_list: List[Any] = []
        for doc in docs:
            if isinstance(doc, list):
                out_list.extend(doc)
        return out_list
    return first


class _FederationHTTPServer(ThreadingHTTPServer):
    request_queue_size = 128
    daemon_threads = True


class FederationServer:
    """Threaded HTTP wrapper for the front door (mirrors
    rest.api.ApiServer so the daemon lifecycle treats both alike)."""

    def __init__(self, router: FederationRouter,
                 host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundFederationHandler", (_FederationHandler,),
                       {"router": router})
        self.router = router
        self.server = _FederationHTTPServer((host, port), handler)
        self.host, self.port = self.server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def build_federation_node(conf_section: Dict,
                          host: str = "127.0.0.1",
                          port: int = 0,
                          device="cuda") -> FederationServer:
    """Boot-validate a ``"federation"`` conf section and assemble the
    router + front-door server (not yet started — the daemon owns the
    lifecycle).  ``device`` is resolved only in the goodput route mode
    (its replays' device); the load mode touches none."""
    cfg = FederationConfig.from_conf(dict(conf_section))
    return FederationServer(FederationRouter(cfg, device=device),
                            host=host, port=port)
