"""The port's copy of ``cook_tpu/sched/fleet.py`` (imports re-rooted).

Fleet observability plane: federation, trace stitching, saturation.

The topology the repo runs — an elected leader, partition leases, a
follower read fleet, remote agents — produced per-PROCESS telemetry
only: each member's flight recorder, span ring, RED metrics, and SLO
burn stop at its own process boundary.  This module builds the fleet
plane in the Dapper mold (Sigelman et al. 2010: propagate ids
everywhere, collect lazily, stitch centrally) with Monarch-style
(VLDB'20) bounded per-member aggregation, off ONE topology source: the
election candidate registry (state/replication.known_members) that
coordinated promotion already maintains.

Three layers (docs/OBSERVABILITY.md "Debugging the fleet"):

1. **Trace stitching** — every member keeps spans for adopted
   traceparents in its local ring (utils/tracing.py) and serves them
   raw at ``GET /debug/trace/spans?trace_id=``; :func:`collect_trace`
   fans out, merges, and dedupes, and tracing.export_fleet_trace turns
   the merged set into ONE Perfetto export with per-process tracks.
2. **Metrics federation** — :class:`FleetScraper` pulls each member's
   ``/metrics`` (driven by the monitor sweep, self-gated to
   ``scrape_interval_seconds``), re-labels with ``{instance, role}``
   under the cardinality discipline of utils/metrics.py, and serves
   the merged view at ``GET /metrics/fleet`` + ``GET /debug/fleet``.
   An unreachable member is DATA (``cook_fleet_member_up 0`` + its
   last error), never a silent gap.  Fleet-level SLO burn is the max
   over members per series (the page-worthy number: the worst burning
   process, not the average that dilutes it).
3. **Saturation signals** — :func:`compute_saturation` derives
   normalized 0-1 ``cook_saturation{resource=}`` gauges from existing
   counters each monitor sweep (formulas below, red line in
   FleetConfig) — the explicit input contract for the adaptive
   admission layer (sched/admission.py).

Network fetches never run under a lock (utils/locks.py blocking
discipline): a sweep snapshots the member list, fetches lock-free, and
installs results under the lock afterwards.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..config import Config, FleetConfig
from ..utils import tracing
from ..utils.metrics import (MetricsRegistry, format_sample,
                             parse_exposition, registry as default_registry)

#: series the scraper itself publishes; a member's own copies are
#: dropped from the merged exposition (a leader that federates would
#: otherwise re-federate its own federation gauges each sweep)
_FLEET_SELF = ("cook_fleet_member_up", "cook_fleet_scrape_age_seconds",
               "cook_fleet_dropped_series", "cook_fleet_slo_burn_rate",
               "cook_fleet_members")


def _default_fetch(url: str, timeout_s: float) -> str:
    """GET ``url`` as text; urllib only (zero new dependencies)."""
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8", "replace")


def _clamp01(v: float) -> float:
    """NaN-safe clamp into [0, 1] — every saturation gauge's contract."""
    v = float(v)
    if v != v:  # NaN
        return 0.0
    return min(max(v, 0.0), 1.0)


# ------------------------------------------------------------- saturation
def compute_saturation(config: Config,
                       store=None, read_view=None, rate_limits=None
                       ) -> Dict[str, float]:
    """The derived saturation layer: one normalized 0-1 value per
    resource, from counters the repo already maintains.  Every key is
    ALWAYS present (an absent input reads 0.0) so the exported series
    set is stable and the admission consumer never key-errors.

    Formulas (red lines in FleetConfig; docs/OBSERVABILITY.md):

    - ``group_commit_queue`` — max over write-plane shards of
      ``pending / serving.group_commit_max_batch``: 1.0 means a full
      batch is queued behind a committer mid-fsync.
    - ``follower_staleness`` — the local read view's apply age over
      ``fleet.staleness_red_line_seconds`` (0.0 on processes without a
      read view; the fleet view shows each follower's own value).
    - ``cycle_p99`` — p99 of the flight recorder's recent fused/match
      cycle durations over the cycle-duration SLO objective.
    - ``audit_queue`` — durable audit events still buffered for the
      journal over ``fleet.audit_queue_red_line``.
    - ``launch_tokens`` — worst-key consumption fraction of the
      job-launch token bucket (1.0 = some key fully spent or in debt).
    - ``journal_head`` — max shard journal bytes since the last
      checkpoint compaction over
      ``fleet.journal_head_red_line_bytes``.
    """
    fleet = config.fleet
    out = {"group_commit_queue": 0.0, "follower_staleness": 0.0,
           "cycle_p99": 0.0, "audit_queue": 0.0, "launch_tokens": 0.0,
           "journal_head": 0.0}
    if store is not None:
        from ..state.partition import substores
        gc_max = max(int(config.serving.group_commit_max_batch), 1)
        for shard in substores(store):
            gc_stats = getattr(shard, "group_commit_stats", None)
            gc = gc_stats() if gc_stats is not None else None
            if gc is not None:
                out["group_commit_queue"] = max(
                    out["group_commit_queue"],
                    _clamp01(float(gc.get("pending", 0)) / gc_max))
            co = getattr(shard, "commit_offset", None)
            head = co() if co is not None else 0
            if head:
                out["journal_head"] = max(
                    out["journal_head"],
                    _clamp01(float(head)
                             / fleet.journal_head_red_line_bytes))
        audit = getattr(store, "audit", None)
        if audit is not None:
            pending = getattr(audit, "pending_durable_count", None)
            if pending is not None:
                out["audit_queue"] = _clamp01(
                    float(pending()) / fleet.audit_queue_red_line)
    if read_view is not None:
        out["follower_staleness"] = _clamp01(
            (read_view.age_ms() / 1000.0)
            / fleet.staleness_red_line_seconds)
    from ..utils.flight import recorder
    durations = recorder.recent_durations(("fused", "match"),
                                          config.slo.cycle_window)
    if durations:
        ordered = sorted(durations)
        p99_ms = ordered[min(int(0.99 * (len(ordered) - 1)),
                             len(ordered) - 1)]
        out["cycle_p99"] = _clamp01(
            p99_ms / (config.slo.cycle_duration_objective_s * 1000.0))
    if rate_limits is not None:
        limiter = getattr(rate_limits, "job_launch", None)
        saturation = getattr(limiter, "saturation", None)
        if saturation is not None:
            out["launch_tokens"] = _clamp01(saturation())
    return out


def publish_saturation(values: Dict[str, float],
                       registry: Optional[MetricsRegistry] = None) -> None:
    """``cook_saturation{resource=}`` gauges from a computed dict — the
    one exporter every caller (monitor sweep, follower scrape path)
    shares so the series set stays identical across roles."""
    reg = registry if registry is not None else default_registry
    for resource, value in values.items():
        reg.gauge_set("cook_saturation", round(_clamp01(value), 6),
                      labels={"resource": resource})


# ----------------------------------------------------------- trace stitch
def collect_trace(trace_id: str, members: Dict[str, Dict],
                  fetch: Optional[Callable[[str, float], str]] = None,
                  timeout_s: float = 2.0,
                  local_spans: Optional[List[Dict]] = None
                  ) -> Tuple[List[Dict], List[Dict]]:
    """Fan out ``GET /debug/trace/spans?trace_id=`` to every member,
    merge with the local ring, dedupe by ``(proc, span_id)`` — the lazy
    Dapper collection step.  Returns ``(span_docs, provenance)`` where
    provenance records per-member success/failure so a partial stitch
    is visible in the export's ``otherData`` rather than silent."""
    fetch = fetch or _default_fetch
    spans: List[Dict] = list(local_spans
                             if local_spans is not None
                             else tracing.tracer.traces(trace_id))
    provenance: List[Dict] = []
    for instance, info in sorted(members.items()):
        url = (info or {}).get("url")
        if not url:
            continue
        entry: Dict[str, Any] = {"instance": instance, "url": url}
        try:
            body = fetch(f"{url}/debug/trace/spans?trace_id={trace_id}",
                         timeout_s)
            remote = json.loads(body).get("spans") or []
            spans.extend(d for d in remote if isinstance(d, dict))
            entry.update(ok=True, spans=len(remote))
        except Exception as e:
            entry.update(ok=False, error=f"{type(e).__name__}: {e}")
        provenance.append(entry)
    seen = set()
    out: List[Dict] = []
    for d in spans:
        key = (d.get("proc"), d.get("span_id"))
        if key in seen:
            continue
        seen.add(key)
        out.append(d)
    return out, provenance


# ------------------------------------------------------------- federation
class FleetScraper:
    """Monitor-driven pull federation over the candidate registry.

    ``members_fn`` returns the current topology (state/replication.
    known_members); ``fetch`` is injectable for tests.  One sweep
    fetches every member's ``/metrics`` LOCK-FREE, then installs the
    parsed per-member records under the lock; readers
    (:meth:`merged_exposition`, :meth:`fleet_doc`) only ever see a
    complete sweep."""

    def __init__(self, cfg: FleetConfig,
                 members_fn: Callable[[], Dict[str, Dict]],
                 fetch: Optional[Callable[[str, float], str]] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.members_fn = members_fn
        self.fetch = fetch or _default_fetch
        self.registry = registry if registry is not None \
            else default_registry
        self._lock = threading.Lock()
        self._members: Dict[str, Dict] = {}
        self._last_sweep = 0.0
        # instance cardinality is bounded by the membership cap; the
        # guard is the backstop against a churning registry minting
        # unbounded instance label values across sweeps
        cap = int(cfg.max_members) * 2 + 16
        for name in ("cook_fleet_member_up",
                     "cook_fleet_scrape_age_seconds",
                     "cook_fleet_dropped_series"):
            self.registry.set_label_cap(name, "instance", cap)

    # ------------------------------------------------------------ scraping
    def maybe_scrape(self, now: Optional[float] = None) -> bool:
        """Sweep-gated entry point the monitor calls every sweep; a
        sweep actually runs only once per ``scrape_interval_seconds``."""
        now = time.time() if now is None else now
        with self._lock:
            if not self.cfg.enabled \
                    or now - self._last_sweep < self.cfg.scrape_interval_seconds:
                return False
            self._last_sweep = now
        self.scrape(now=now)
        return True

    def scrape(self, now: Optional[float] = None) -> Dict[str, Dict]:
        """One federation sweep: fetch, parse, re-label, publish."""
        now = time.time() if now is None else now
        members = dict(self.members_fn() or {})
        skipped = max(0, len(members) - int(self.cfg.max_members))
        if skipped:
            members = dict(sorted(members.items())
                           [:int(self.cfg.max_members)])
        records: Dict[str, Dict] = {}
        for instance, info in sorted(members.items()):
            records[instance] = self._scrape_member(instance,
                                                    info or {}, now)
        with self._lock:
            self._members = records
            self._last_sweep = now
        self._publish(records, skipped, now)
        return records

    def _scrape_member(self, instance: str, info: Dict,
                       now: float) -> Dict:
        rec: Dict[str, Any] = {
            "instance": instance, "url": info.get("url"),
            "role": str(info.get("role") or "member"),
            "self": bool(info.get("self")),
            "up": False, "error": None, "scraped_ts": now,
            "series": [], "dropped": 0,
        }
        url = rec["url"]
        if not url:
            rec["error"] = "no url published"
            return rec
        try:
            text = self.fetch(f"{url}/metrics",
                              self.cfg.scrape_timeout_seconds)
        except Exception as e:
            rec["error"] = f"{type(e).__name__}: {e}"
            return rec
        series = parse_exposition(text)
        cap = int(self.cfg.max_series_per_member)
        if len(series) > cap:
            rec["dropped"] = len(series) - cap
            series = series[:cap]
        rec["series"] = series
        rec["up"] = True
        # derived per-member health read off the scrape itself
        burn = [v for n, _l, v in series if n == "cook_slo_burn_rate"]
        rec["burn"] = max(burn) if burn else 0.0
        rec["saturation"] = {
            labels.get("resource", "?"): v
            for n, labels, v in series if n == "cook_saturation"}
        staleness = [v for n, _l, v in series
                     if n == "cook_follower_staleness_seconds"]
        rec["staleness_s"] = max(staleness) if staleness else None
        return rec

    def _publish(self, records: Dict[str, Dict], skipped: int,
                 now: float) -> None:
        """Per-member + fleet-level gauges into the process registry —
        what the local /metrics (and any UPSTREAM federation of this
        process) sees about the fleet."""
        reg = self.registry
        reg.gauge_set("cook_fleet_members", float(len(records)))
        if skipped:
            reg.counter_inc("cook_fleet_members_skipped", skipped)
        for instance, rec in records.items():
            labels = {"instance": instance, "role": rec["role"]}
            reg.gauge_set("cook_fleet_member_up",
                          1.0 if rec["up"] else 0.0, labels=labels)
            reg.gauge_set("cook_fleet_scrape_age_seconds",
                          round(max(0.0, now - rec["scraped_ts"]), 6),
                          labels={"instance": instance})
            if rec["dropped"]:
                reg.gauge_set("cook_fleet_dropped_series",
                              float(rec["dropped"]),
                              labels={"instance": instance})
        # fleet-level burn: per merged series key, the MAX over members
        # — the worst burning process pages, an average would dilute it
        reg.gauge_clear("cook_fleet_slo_burn_rate")
        for labels_key, value in self._fleet_burn(records).items():
            reg.gauge_set("cook_fleet_slo_burn_rate", value,
                          labels=dict(labels_key))

    @staticmethod
    def _fleet_burn(records: Dict[str, Dict]
                    ) -> Dict[Tuple, float]:
        out: Dict[Tuple, float] = {}
        for rec in records.values():
            for name, labels, value in rec.get("series", []):
                if name != "cook_slo_burn_rate":
                    continue
                key = tuple(sorted(labels.items()))
                out[key] = max(out.get(key, 0.0), value)
        return out

    # -------------------------------------------------------------- readers
    def members(self) -> Dict[str, Dict]:
        with self._lock:
            return dict(self._members)

    def last_sweep(self) -> float:
        with self._lock:
            return self._last_sweep

    def merged_exposition(self, now: Optional[float] = None) -> str:
        """The federated text view (``GET /metrics/fleet``): every
        member's series re-labeled with ``{instance, role}``.  A series
        that already carries an ``instance``/``role`` label (a member
        federating someone else, a pushgateway-style exporter) keeps it
        renamed ``exported_instance``/``exported_role`` — the member
        identity must win the collision, not silently lose it.
        Unreachable members contribute their up/age/error series, so
        the merged view never has gaps, only zeros."""
        now = time.time() if now is None else now
        lines: List[str] = []
        for instance, rec in sorted(self.members().items()):
            ident = {"instance": instance, "role": rec["role"]}
            lines.append(format_sample(
                "cook_fleet_member_up", ident,
                1.0 if rec["up"] else 0.0))
            lines.append(format_sample(
                "cook_fleet_scrape_age_seconds", {"instance": instance},
                round(max(0.0, now - rec["scraped_ts"]), 6)))
            if rec["dropped"]:
                lines.append(format_sample(
                    "cook_fleet_dropped_series", {"instance": instance},
                    float(rec["dropped"])))
            for name, labels, value in rec.get("series", []):
                if name in _FLEET_SELF:
                    continue
                merged = dict(labels)
                for k in ("instance", "role"):
                    if k in merged:
                        merged[f"exported_{k}"] = merged.pop(k)
                merged.update(ident)
                lines.append(format_sample(name, merged, value))
        return "\n".join(lines) + "\n" if lines else ""

    def fleet_doc(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``GET /debug/fleet`` / ``cs debug fleet`` panel: per-
        member health (up, staleness, burn, saturation hot-spots,
        last-scrape age, error) + fleet-level burn, JSON-shaped for
        humans and the adaptive-admission consumer alike."""
        now = time.time() if now is None else now
        red = self.cfg.saturation_red_line
        members = []
        for instance, rec in sorted(self.members().items()):
            saturation = rec.get("saturation") or {}
            members.append({
                "instance": instance,
                "url": rec.get("url"),
                "role": rec.get("role"),
                "self": rec.get("self", False),
                "up": rec.get("up", False),
                "error": rec.get("error"),
                "scrape_age_s": round(
                    max(0.0, now - rec.get("scraped_ts", now)), 3),
                "series": len(rec.get("series", [])),
                "dropped_series": rec.get("dropped", 0),
                "staleness_s": rec.get("staleness_s"),
                "burn": rec.get("burn", 0.0),
                "saturation": saturation,
                "hot": sorted(r for r, v in saturation.items()
                              if v >= red),
            })
        with self._lock:
            last = self._last_sweep
        return {
            "enabled": bool(self.cfg.enabled),
            "last_sweep_ts": last,
            "sweep_age_s": round(max(0.0, now - last), 3) if last else None,
            "scrape_interval_seconds": self.cfg.scrape_interval_seconds,
            "saturation_red_line": red,
            "members": members,
            "fleet_burn": [
                {**dict(k), "burn": v}
                for k, v in sorted(self._fleet_burn(
                    self.members()).items())],
        }

    # --------------------------------------------------------- trace fanout
    def collect_trace(self, trace_id: str
                      ) -> Tuple[List[Dict], List[Dict]]:
        """Stitch one trace across the CURRENT topology (not the last
        scrape's): span rings are short-lived, so the fan-out must see
        members the federation sweep hasn't visited yet."""
        members = dict(self.members_fn() or {})
        # never fetch our own spans over HTTP: the local ring is richer
        # (it includes spans finishing mid-request) and the self-fetch
        # would deadlock a single-threaded test server
        members = {i: m for i, m in members.items()
                   if not (m or {}).get("self")}
        return collect_trace(
            trace_id, members, fetch=self.fetch,
            timeout_s=self.cfg.trace_fanout_timeout_seconds)
