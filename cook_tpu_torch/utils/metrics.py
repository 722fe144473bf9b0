"""The port's copy of ``cook_tpu/utils/metrics.py`` (imports re-rooted).

Minimal metrics registry with Prometheus text exposition.

Plays the role of the reference's tri-recorded metrics (reference:
prometheus_metrics.clj — 765 LoC of metric defs with a with-duration macro;
reporter.clj dropwizard wiring): counters, gauges, and duration histograms
keyed by (name, labels), exposed at /metrics.
"""

from __future__ import annotations

import contextvars
import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

#: context-scoped write suppression (propagates into copy_context worker
#: threads, like tracing's span context): the optimizer's
#: faster-than-real-time sim replay (sched/optimizer.py) drives a REAL
#: scheduler in-process, and its counters must not leak into the
#: production exposition — a replayed preemption is not a preemption
_suppressed: "contextvars.ContextVar[bool]" = \
    contextvars.ContextVar("cook_metrics_suppressed", default=False)

_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
            5.0, 10.0)

# wait/age histograms (queue latency SLOs) live on second-to-hour scales
# the default duration buckets can't resolve
LATENCY_BUCKETS = (1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0,
                   1800.0, 3600.0, 7200.0, 14400.0)


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping (exposition spec: label_value
    may contain any UTF-8 but ``\\``, ``"`` and line feeds must be escaped
    as ``\\\\``, ``\\"`` and ``\\n``).  Without this, a label like
    reason="no \"fit\"" corrupts the whole scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_str(key: Tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


def _unescape_label_value(value: str) -> str:
    """Inverse of :func:`_escape_label_value` (federation parse side)."""
    out: List[str] = []
    i = 0
    while i < len(value):
        c = value[i]
        if c == "\\" and i + 1 < len(value):
            n = value[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(n, "\\" + n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_LINE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+([^\s]+)\s*$')


def parse_exposition(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Parse Prometheus text exposition into ``(exposed_name, labels,
    value)`` triples — the federation scraper's read side (sched/fleet.py).
    Exposed names are kept VERBATIM (``_total``/``_bucket``/``_count``/
    ``_sum`` suffixes intact): federation re-labels and re-emits, it
    never re-interprets metric types.  Comment/HELP/TYPE lines and
    malformed lines are skipped (a member mid-restart must not poison
    the whole fleet view); non-finite values (``NaN``/``+Inf`` bucket
    bounds live in label values, not sample values) parse via float()."""
    out: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name, labels_str, value_str = m.groups()
        try:
            value = float(value_str)
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        if labels_str:
            for lm in _LABEL_RE.finditer(labels_str[1:-1]):
                labels[lm.group(1)] = _unescape_label_value(lm.group(2))
        out.append((name, labels, value))
    return out


def format_sample(name: str, labels: Dict[str, str], value: float) -> str:
    """One exposition line from an (exposed_name, labels, value) triple —
    the federation re-emit side, escaping-symmetric with parse."""
    return f"{name}{_labels_str(_labels_key(labels))} {value}"


class MetricsRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        # histogram state is fixed-size: cumulative bucket counts + count/sum
        self._histograms: Dict[Tuple[str, Tuple], Dict] = {}
        # cardinality guard (docs/OBSERVABILITY.md): (metric, label) ->
        # (cap, scope-label) on DISTINCT label values.  Past the cap,
        # samples fold into value "other" and
        # cook_metrics_dropped_labels_total counts the fold — per-user
        # fairness gauges stay bounded at millions-of-users scale.  The
        # window is PER SCOPE value (default scope "pool"): each pool's
        # user population gets its own cap, so a later-swept pool's
        # legitimate top-K is never folded just because earlier pools
        # filled a global window.  Admission is first-come within a
        # window; publishers that want top-K-by-usage (sched/monitor.py)
        # sort before publishing and reset_label_window() each sweep.
        self._label_caps: Dict[Tuple[str, str],
                               Tuple[int, Tuple[str, ...]]] = {}
        self._label_seen: Dict[Tuple[str, str], Dict[Tuple, set]] = {}

    # ------------------------------------------------------ cardinality guard
    OTHER_LABEL = "other"

    def set_label_cap(self, name: str, label: str, cap: int,
                      scope: Tuple[str, ...] = ("pool",)) -> None:
        """Cap distinct values of ``label`` on metric ``name`` per
        distinct combination of the ``scope`` labels (empty tuple = one
        global window); overflow samples are re-labeled ``other``
        (idempotent re-registration)."""
        with self._lock:
            self._label_caps[(name, label)] = (int(cap), tuple(scope))
            self._label_seen.setdefault((name, label), {})

    def reset_label_window(self, name: str, label: str) -> None:
        """Forget which values currently hold a slot (a periodic
        publisher calls this each sweep so a NEW top-K can claim the
        slots; already-exported stale series are the publisher's to
        zero/clear)."""
        with self._lock:
            self._label_seen.get((name, label), {}).clear()

    def _guard_labels(self, name: str,
                      labels: Optional[Dict[str, str]]
                      ) -> Optional[Dict[str, str]]:
        """Apply label caps (caller does NOT hold the lock).  Returns
        possibly-rewritten labels; counts folds."""
        if not labels or not self._label_caps:
            return labels
        folded = None
        for label, value in list(labels.items()):
            key = (name, label)
            capinfo = self._label_caps.get(key)
            if capinfo is None or value == self.OTHER_LABEL:
                continue
            cap, scope = capinfo
            group = tuple(labels.get(s, "") for s in scope)
            with self._lock:
                seen = self._label_seen.setdefault(
                    key, {}).setdefault(group, set())
                if value in seen:
                    continue
                if len(seen) < cap:
                    seen.add(value)
                    continue
            if folded is None:
                folded = dict(labels)
            folded[label] = self.OTHER_LABEL
            key2 = ("cook_metrics_dropped_labels",
                    _labels_key({"metric": name, "label": label}))
            with self._lock:
                self._counters[key2] = self._counters.get(key2, 0.0) + 1.0
        return folded if folded is not None else labels

    @contextmanager
    def suppressed(self):
        """Suppress every metric WRITE made from this context (and from
        workers started via ``contextvars.copy_context().run`` under it)
        — the optimizer's sim replay runs whole schedulers in-process
        and their counters are simulation, not production truth."""
        token = _suppressed.set(True)
        try:
            yield
        finally:
            _suppressed.reset(token)

    def counter_inc(self, name: str, value: float = 1.0,
                    labels: Optional[Dict[str, str]] = None) -> None:
        if _suppressed.get():
            return
        key = (name, _labels_key(self._guard_labels(name, labels)))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None) -> None:
        if _suppressed.get():
            return
        labels = self._guard_labels(name, labels)
        with self._lock:
            self._gauges[(name, _labels_key(labels))] = value

    def gauge_clear(self, name: str) -> None:
        """Drop every series of ``name`` — for gauges whose label sets
        name ephemeral entities (e.g. per-connection replication
        followers): re-set at each refresh, the series set stays bounded
        to what is live instead of accumulating frozen stale labels."""
        with self._lock:
            for key in [k for k in self._gauges if k[0] == name]:
                del self._gauges[key]

    def observe(self, name: str, value_s: float,
                labels: Optional[Dict[str, str]] = None,
                buckets: Optional[Tuple[float, ...]] = None) -> None:
        """Record one histogram observation.  ``buckets`` fixes the bound
        set on FIRST observation of a series (later values are ignored —
        cumulative bucket counts cannot be re-bucketed); default is the
        sub-second duration ladder, pass ``LATENCY_BUCKETS`` for
        second-to-hour wait times."""
        if _suppressed.get():
            return
        key = (name, _labels_key(self._guard_labels(name, labels)))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                bounds = tuple(buckets) if buckets is not None else _BUCKETS
                h = {"bounds": bounds, "buckets": [0] * len(bounds),
                     "count": 0, "sum": 0.0}
                self._histograms[key] = h
            for i, b in enumerate(h["bounds"]):
                if value_s <= b:
                    h["buckets"][i] += 1
            h["count"] += 1
            h["sum"] += value_s

    def observe_many(self, name: str, values_s,
                     labels: Optional[Dict[str, str]] = None,
                     buckets: Optional[Tuple[float, ...]] = None) -> None:
        """Bulk histogram observation: per-bucket counts are computed
        OUTSIDE the lock (one sort + searchsorted), then merged under one
        lock hold — the monitor's 100k-pending-job age sweep must not
        turn into 100k individual locked bucket scans."""
        if _suppressed.get():
            return
        import numpy as np
        vals = np.asarray(list(values_s), dtype=float)
        if vals.size == 0:
            return
        key = (name, _labels_key(self._guard_labels(name, labels)))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                bounds = tuple(buckets) if buckets is not None else _BUCKETS
                h = {"bounds": bounds, "buckets": [0] * len(bounds),
                     "count": 0, "sum": 0.0}
                self._histograms[key] = h
            bounds = h["bounds"]
        # cumulative "value <= bound" counts, vectorized and unlocked
        counts = np.searchsorted(np.sort(vals), np.asarray(bounds),
                                 side="right")
        total, vsum = int(vals.size), float(vals.sum())
        with self._lock:
            for i, c in enumerate(counts):
                h["buckets"][i] += int(c)
            h["count"] += total
            h["sum"] += vsum

    @contextmanager
    def time(self, name: str, labels: Optional[Dict[str, str]] = None):
        """The reference's with-duration macro."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0, labels)

    def series(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        """Every current series of gauge/counter ``name`` as
        (labels dict, value) pairs — the structured accessor the
        /debug/health roll-up reads (snapshot() flattens labels into
        strings, which a consumer would have to re-parse)."""
        with self._lock:
            out = [(dict(k), v) for (n, k), v in self._gauges.items()
                   if n == name]
            out += [(dict(k), v) for (n, k), v in self._counters.items()
                    if n == name]
        return out

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": {f"{n}{_labels_str(k)}": v
                             for (n, k), v in self._counters.items()},
                "gauges": {f"{n}{_labels_str(k)}": v
                           for (n, k), v in self._gauges.items()},
                "histogram_counts": {f"{n}{_labels_str(k)}": v["count"]
                                     for (n, k), v in self._histograms.items()},
            }

    def expose(self) -> str:
        """Prometheus text format."""
        lines: List[str] = []
        with self._lock:
            for (name, key), value in sorted(self._counters.items()):
                lines.append(f"{name}_total{_labels_str(key)} {value}")
            for (name, key), value in sorted(self._gauges.items()):
                lines.append(f"{name}{_labels_str(key)} {value}")
            for (name, key), h in sorted(self._histograms.items()):
                for i, b in enumerate(h.get("bounds", _BUCKETS)):
                    bucket_key = key + (("le", str(b)),)
                    lines.append(f"{name}_bucket{_labels_str(bucket_key)} "
                                 f"{h['buckets'][i]}")
                inf_key = key + (("le", "+Inf"),)
                lines.append(f"{name}_bucket{_labels_str(inf_key)} "
                             f"{h['count']}")
                lines.append(f"{name}_count{_labels_str(key)} {h['count']}")
                lines.append(f"{name}_sum{_labels_str(key)} {h['sum']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._label_caps.clear()
            self._label_seen.clear()


registry = MetricsRegistry()
