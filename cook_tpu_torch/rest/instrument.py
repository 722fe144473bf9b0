"""The port's copy of ``cook_tpu/rest/instrument.py`` (imports re-rooted).

Serving-plane request observability (docs/OBSERVABILITY.md).

This module is the REST plane's measurement layer: before a path can be
optimized it must decompose.  Three concerns,
Borg/Dapper style (Verma et al., EuroSys '15; Sigelman et al., 2010):

1. **Endpoint templating.**  Metric labels must be path TEMPLATES
   (``/jobs/{uuid}``), never raw uuids — the label space is the route
   table plus one ``{unmatched}`` bucket for 404 garbage, so per-endpoint
   series stay bounded no matter what clients throw at the socket.  The
   utils/metrics.py cardinality guard backstops the template resolver.

2. **RED metrics.**  Per-endpoint request counts (by method and status
   code), duration histograms, an in-flight gauge, and the request-size /
   phase decomposition (journal append, fsync, replication ack wait) the
   tracing layer's per-request phase collector feeds — "why was this POST
   slow" is answerable from /metrics before anyone opens a trace.

3. **Slow-request capture.**  A bounded ring of recent requests plus a
   ring of requests over the slow threshold, each record carrying the
   request id, trace id, redacted query params, and the per-phase
   breakdown — served at ``GET /debug/requests`` with no external
   collector (zero-egress friendly).

The module-level :data:`request_log` singleton mirrors the repo's other
observability planes (``utils.flight.recorder``, ``utils.tracing.tracer``).
"""

from __future__ import annotations

import gzip as _gzip
import threading
import time as _time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils.metrics import registry

# endpoint label value for paths matching no registered route: the 404
# surface must be one bounded series, not one per probe/typo'd path
UNMATCHED = "{unmatched}"

# request-size histogram bounds (bytes): submissions range from one tiny
# job to multi-thousand-job batches
REQUEST_SIZE_BUCKETS = (256.0, 1024.0, 4096.0, 16384.0, 65536.0,
                        262144.0, 1048576.0, 4194304.0)

# the span names the phase decomposition publishes (the tracing phase
# collector records EVERY span; exporting them all as label values would
# let any future span silently widen a metric family).  journal.fsync is
# the group-commit stage's batched force, attributed back into each
# waiting request via tracer.record_finished (state/store.py).
PHASE_SPANS = ("journal.append", "journal.fsync", "repl.ack_wait",
               "remote.launch")

# query params whose values never reach the capture ring verbatim
_REDACT_KEYS = frozenset({"token", "password", "authorization", "secret"})
_PARAM_VALUE_CAP = 64


def endpoint_template(method: str, path: str) -> str:
    """Resolve a raw (method, path) to its route-table template
    (``POST /jobs/<uuid>`` -> ``/jobs/{uuid}``); anything not in the
    table — unknown paths AND wrong-method probes against known paths —
    folds to :data:`UNMATCHED` so hostile traffic cannot mint metric
    series or skew a real endpoint's error counts."""
    static, templated = _route_tables()
    if (method, path) in static:
        return path
    parts = tuple(p for p in path.split("/") if p)
    for tmethod, tparts, template in templated:
        if tmethod != method or len(tparts) != len(parts):
            continue
        if all(t.startswith("{") or t == p
               for t, p in zip(tparts, parts)):
            return template
    return UNMATCHED


_ROUTE_CACHE: Optional[Tuple[frozenset, Tuple]] = None


def _route_tables() -> Tuple[frozenset, Tuple]:
    """(static (method, path) set, ((method, template parts, template),
    ...)) derived from the API route table; imported lazily (api.py
    imports this module)."""
    global _ROUTE_CACHE
    if _ROUTE_CACHE is None:
        from .api import API_ROUTES
        static = set()
        templated = []
        for method, path, _summary, _leader in API_ROUTES:
            if "{" in path:
                tparts = tuple(p for p in path.split("/") if p)
                if (method, tparts, path) not in templated:
                    templated.append((method, tparts, path))
            else:
                static.add((method, path))
        _ROUTE_CACHE = (frozenset(static), tuple(templated))
    return _ROUTE_CACHE


def redact_params(params: Dict[str, List[str]]) -> Dict[str, List[str]]:
    """Query params safe for the capture ring: secret-bearing keys are
    masked, values truncated (a 10k-uuid batch query must not bloat the
    ring)."""
    out: Dict[str, List[str]] = {}
    for key, values in params.items():
        if key.lower() in _REDACT_KEYS:
            out[key] = ["[redacted]"] * len(values)
        else:
            out[key] = [v if len(v) <= _PARAM_VALUE_CAP
                        else v[:_PARAM_VALUE_CAP] + "…"
                        for v in values[:8]]
            if len(values) > 8:
                out[key].append(f"…+{len(values) - 8} more")
    return out


def wants_gzip(accept_encoding: Optional[str]) -> bool:
    """True when the client's Accept-Encoding admits gzip (q=0 opt-outs
    honored)."""
    for token in (accept_encoding or "").lower().split(","):
        name, _, qs = token.strip().partition(";")
        if name in ("gzip", "*"):
            q = qs.strip()
            if q.startswith("q="):
                try:
                    return float(q[2:]) > 0.0
                except ValueError:
                    return False
            return True
    return False


def gzip_body(data: bytes) -> bytes:
    # mtime pinned so identical payloads compress identically (test
    # determinism; nothing reads the gzip timestamp)
    return _gzip.compress(data, compresslevel=5, mtime=0)


class RequestObserver:
    """RED metrics + bounded request-capture rings for the REST plane."""

    def __init__(self, recent: int = 256, slow: int = 64,
                 slow_ms: float = 500.0):
        self._lock = threading.Lock()
        self.enabled = True
        #: brownout stage >= 1 (sched/admission.py) turns the capture
        #: rings off — RED metrics and SLO windows keep flowing (the
        #: signal the incident is diagnosed with must survive the
        #: incident); only the per-request detail records shed
        self.capture = True
        self.slow_ms = float(slow_ms)
        self._recent: deque = deque(maxlen=recent)
        self._slow: deque = deque(maxlen=slow)
        self._inflight = 0
        # per-endpoint (count, over-objective) since the last monitor
        # sweep — the endpoint-latency SLO's burn-rate input
        self._slo_window: Dict[str, List[int]] = {}
        # rolling totals for the ack-wait share gauge (what fraction of
        # cumulative request wall time was replication ack wait)
        self._total_s = 0.0
        self._phase_totals: Dict[str, float] = {}
        # endpoint labels are templates (bounded by construction); the
        # registry cap is the backstop the acceptance criteria name
        for metric in ("cook_http_requests",
                       "cook_http_request_duration_seconds",
                       "cook_http_phase_seconds"):
            registry.set_label_cap(metric, "endpoint", 64, scope=())

    def configure(self, http_cfg) -> None:
        """Apply config.HttpConfig (CookApi construction / daemon boot)."""
        self.enabled = bool(http_cfg.observe)
        self.slow_ms = float(http_cfg.slow_request_ms)
        with self._lock:
            if self._recent.maxlen != int(http_cfg.request_log):
                self._recent = deque(self._recent,
                                     maxlen=int(http_cfg.request_log))
            if self._slow.maxlen != int(http_cfg.slow_log):
                self._slow = deque(self._slow,
                                   maxlen=int(http_cfg.slow_log))

    # -------------------------------------------------------------- lifecycle
    def begin(self) -> None:
        with self._lock:
            self._inflight += 1
            n = self._inflight
        registry.gauge_set("cook_http_inflight", float(n))

    def end(self, *, method: str, endpoint: str, status: int,
            duration_s: float, phases: Dict[str, float],
            params: Dict[str, List[str]], request_id: str,
            trace_id: Optional[str], user: str, bytes_in: int,
            bytes_out: int, objective_s: Optional[float] = None) -> None:
        labels = {"endpoint": endpoint, "method": method}
        registry.counter_inc("cook_http_requests", 1.0,
                             {**labels, "code": str(status)})
        registry.observe("cook_http_request_duration_seconds",
                         duration_s, labels)
        if bytes_in:
            registry.observe("cook_http_request_bytes", float(bytes_in),
                             {"endpoint": endpoint},
                             buckets=REQUEST_SIZE_BUCKETS)
        phases_ms = {}
        for name in PHASE_SPANS:
            dt = phases.get(name)
            if dt:
                phases_ms[name] = round(dt * 1000.0, 3)
                registry.observe("cook_http_phase_seconds", dt,
                                 {**labels, "phase": name})
        record = {
            "ts": None,  # stamped below under the lock (one time() call)
            "method": method, "endpoint": endpoint, "status": status,
            "duration_ms": round(duration_s * 1000.0, 3),
            "phases_ms": phases_ms,
            "request_id": request_id,
            "user": user,
            "bytes_in": bytes_in, "bytes_out": bytes_out,
            "params": redact_params(params),
        }
        if trace_id:
            record["trace_id"] = trace_id
        record["ts"] = round(_time.time(), 3)
        ack_share = None
        with self._lock:
            self._inflight -= 1
            n = self._inflight
            if self.capture:
                self._recent.append(record)
                if record["duration_ms"] >= self.slow_ms:
                    self._slow.append(record)
            win = self._slo_window.setdefault(endpoint, [0, 0])
            win[0] += 1
            if objective_s is not None and duration_s > objective_s:
                win[1] += 1
            self._total_s += duration_s
            for name, dt in phases.items():
                if name in PHASE_SPANS:
                    self._phase_totals[name] = \
                        self._phase_totals.get(name, 0.0) + dt
            if self._total_s > 0:
                ack_share = (self._phase_totals.get("repl.ack_wait", 0.0)
                             / self._total_s)
        registry.gauge_set("cook_http_inflight", float(n))
        if ack_share is not None:
            registry.gauge_set("cook_http_ack_wait_share",
                               round(ack_share, 6))

    # ---------------------------------------------------------------- queries
    def snapshot(self, limit: int = 50) -> Dict[str, Any]:
        """The GET /debug/requests payload: newest-last recent ring slice,
        the slow ring, and the rolling phase-share totals."""
        with self._lock:
            # limit<=0 = totals only ([-0:] would be the WHOLE ring)
            recent = list(self._recent)[-limit:] if limit > 0 else []
            slow = list(self._slow)[-limit:] if limit > 0 else []
            totals = {"requests_s": round(self._total_s, 6),
                      "phases_s": {k: round(v, 6) for k, v
                                   in self._phase_totals.items()},
                      "inflight": self._inflight}
        return {"slow_threshold_ms": self.slow_ms, "capture": self.capture,
                "recent": recent, "slow": slow, "totals": totals}

    def drain_slo_window(self) -> Dict[str, Tuple[int, int]]:
        """Per-endpoint (requests, over-objective) since the last drain —
        consumed by the monitor sweep's endpoint-latency SLO burn rate."""
        with self._lock:
            window, self._slo_window = self._slo_window, {}
        return {k: (v[0], v[1]) for k, v in window.items()}

    def reset(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slow.clear()
            self._slo_window.clear()
            self._phase_totals.clear()
            self._total_s = 0.0
            self._inflight = 0


request_log = RequestObserver()
