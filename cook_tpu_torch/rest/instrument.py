"""The port's copy of the request observer of
``cook_tpu/rest/instrument.py`` (imports re-rooted): ``RequestObserver``
and the module-level :data:`request_log` singleton, with what they use
(``redact_params`` and the bucket and phase constants).  The monitor
sweep's endpoint-latency SLO and the admission controller's capture
switch read the singleton.

Left out until the REST plane is ported (ROADMAP queue 1, item 10): the
endpoint templating (``endpoint_template`` and its route tables, which
import the API's route table) and the gzip helpers of the HTTP server.

Serving-plane request observability (docs/OBSERVABILITY.md): RED
metrics per endpoint template and bounded capture rings of recent and
slow requests, each record carrying the request id, trace id, redacted
query params and the per-phase breakdown.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..utils.metrics import registry

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
