"""The port's copy of ``cook_tpu/utils/flight.py`` (imports re-rooted).

Scheduler flight recorder: a fixed ring of per-cycle CycleRecords.

The per-cycle correlation layer the span ring alone can't give: every
driver cycle (fused production dispatch, split rank/match, rebalance)
opens a :meth:`FlightRecorder.cycle` context that

  1. roots a ``cycle`` tracing span, so every nested span (pack, kernel
     dispatch, fetch, launch RPC) shares the cycle's trace_id and the
     whole cycle exports as one Chrome/Perfetto flamegraph
     (``GET /debug/trace?trace_id=``);
  2. collects the cycle's device telemetry — recompiles per kernel,
     host<->device bytes, device sync-wait time (fed by
     cook_tpu.ops.telemetry), head-of-line skip reasons, preemptions,
     jobs considered/placed;
  3. on exit harvests the trace's spans into per-phase durations
     (rank / match / launch / rebalance) and lands the finished record in
     a fixed-size ring served by ``GET /debug/cycles`` and the
     ``cook-tpu debug cycles`` CLI.

This is the repro of the reference's structured match-cycle log documents
(scheduler.clj match cycle logging + prometheus_metrics.clj with-duration
tri-recording), extended with the JAX-level counters the reference never
needed: a recompile storm or transfer regression shows up as a labeled
field on the slow cycle's record, not a mystery p99 blip.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from . import tracing
from .metrics import registry

_DEFAULT_CAPACITY = 512

# span name -> canonical phase; phase durations on a CycleRecord are the
# sum of the trace's span durations per phase.  Only TOP-LEVEL phase spans
# are mapped (cycle.rank contains fused.pack; summing both would double
# count), the finer span names stay visible in the trace export.
PHASE_BY_SPAN = {
    "cycle.rank": "rank",
    "rank.cycle": "rank",
    "cycle.match": "match",
    "scheduler.pool-handler": "match",
    "cycle.launch": "launch",
    "rebalancer.pool": "rebalance",
}

_current_record: "contextvars.ContextVar[Optional[CycleRecord]]" = \
    contextvars.ContextVar("cook_cycle_record", default=None)

# process-wide shard identity (sharded controllers): a sharded-controller process
# owns exactly ONE partition shard, so the id is process state, not
# per-record plumbing — set once at shard boot (sched/shard.py), stamped
# onto every CycleRecord minted after.  None = unsharded (classic
# single-controller daemon): records export shard=null and the summary
# roll-up stays flat.
_shard_id: Optional[int] = None


def set_shard(shard: Optional[int]) -> None:
    """Declare this process's shard id (one partition = one process);
    every CycleRecord minted after carries it."""
    global _shard_id
    _shard_id = None if shard is None else int(shard)


def current_shard() -> Optional[int]:
    return _shard_id


class CycleRecord:
    """One scheduler cycle's instrument-panel readings."""

    __slots__ = ("seq", "kind", "trace_id", "start_s", "duration_ms",
                 "phases", "detail_ms", "pools", "jobs_considered",
                 "jobs_placed", "skip_reasons", "preemptions", "recompiles",
                 "h2d_bytes", "d2h_bytes", "sync_wait_ms", "faults",
                 "error", "pipeline_depth", "pipeline_inflight",
                 "pipeline_conflicts", "delta_rows", "full_repacks",
                 "audit_events", "kernel_launches", "path", "shard", "_t0")

    def __init__(self, seq: int, kind: str):
        self.seq = seq
        self.kind = kind
        # which controller shard ran this cycle (sharded
        # controllers; None on the classic single process) — the key the
        # stitched /debug/cycles roll-up and fleet trace group by
        self.shard: Optional[int] = _shard_id
        self.trace_id: Optional[str] = None
        self.start_s = time.time()
        self.duration_ms = 0.0
        self.phases: Dict[str, float] = {}       # phase -> ms
        self.pools = 0
        self.jobs_considered = 0
        self.jobs_placed = 0
        self.skip_reasons: Dict[str, int] = {}   # reason -> count
        self.preemptions = 0
        self.recompiles: Dict[str, int] = {}     # kernel -> compiles
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.sync_wait_ms = 0.0
        # fault-point triggers and degradations observed during this
        # cycle (utils/faults.py + kernel/fused fallbacks): a degraded
        # cycle explains itself without cross-referencing logs
        self.faults: Dict[str, int] = {}
        self.error: Optional[str] = None
        # pipelined-driver readings (sched/pipeline.py): configured depth
        # (0 = sync driver), dispatches in flight when this cycle's step
        # finished staging, and reconciliation conflict drops applied
        # inside this cycle
        self.pipeline_depth = 0
        self.pipeline_inflight = 0
        self.pipeline_conflicts = 0
        # sub-phase breakdown the whole-phase durations hide: host staging split into pack (store->arrays) /
        # stage (arrays->wire form) / apply (outputs->transactions), so a
        # staging regression is diagnosable from /debug/cycles without a
        # profiler.  Plus the resident-pack readings: delta rows shipped
        # on-chip this cycle and full repacks (reason-labeled on
        # cook_resident_repack_total).
        self.detail_ms: Dict[str, float] = {}
        self.delta_rows = 0
        self.full_repacks = 0
        # per-job audit events recorded during this cycle (utils/audit.py):
        # the audit lane's own overhead meter — a cycle that recorded
        # nothing proves the quiet fast path stayed zero-work
        self.audit_events = 0
        # device kernel dispatches inside this cycle (every
        # instrumented dispatch counts one) and the cycle path that made
        # them: "split" (per-stage XLA launches), "fused" (one XLA pool
        # cycle), "megakernel" (single Pallas launch), or "mixed" when
        # one cycle's dispatch groups took different paths — a path
        # regression (megakernel silently degrading to fused) is visible
        # in /debug/cycles and the Perfetto export
        self.kernel_launches = 0
        self.path: Optional[str] = None
        self._t0 = time.perf_counter()

    def to_doc(self) -> Dict[str, Any]:
        return {
            "seq": self.seq, "kind": self.kind, "trace_id": self.trace_id,
            "start": self.start_s, "duration_ms": round(self.duration_ms, 3),
            "phases_ms": {k: round(v, 3) for k, v in self.phases.items()},
            "pools": self.pools,
            "jobs_considered": self.jobs_considered,
            "jobs_placed": self.jobs_placed,
            "skip_reasons": dict(self.skip_reasons),
            "preemptions": self.preemptions,
            "recompiles": dict(self.recompiles),
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "sync_wait_ms": round(self.sync_wait_ms, 3),
            "faults": dict(self.faults),
            "pipeline_depth": self.pipeline_depth,
            "pipeline_inflight": self.pipeline_inflight,
            "pipeline_conflicts": self.pipeline_conflicts,
            "detail_ms": {k: round(v, 3) for k, v in self.detail_ms.items()},
            "delta_rows": self.delta_rows,
            "full_repacks": self.full_repacks,
            "audit_events": self.audit_events,
            "kernel_launches": self.kernel_launches,
            "path": self.path,
            "shard": self.shard,
            "error": self.error,
        }


class FlightRecorder:
    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._ring: "deque[CycleRecord]" = deque(maxlen=capacity)
        self._seq = 0
        self.enabled = True

    # ------------------------------------------------------------- lifecycle
    @contextmanager
    def cycle(self, kind: str = "cycle", **tags: Any):
        """Open (or join) the current cycle record.  Re-entrant: a nested
        call (e.g. a sub-step that can also run standalone) joins the
        enclosing record instead of splitting the cycle in two."""
        cur = _current_record.get()
        if not self.enabled or cur is not None:
            yield cur
            return
        with self._lock:
            self._seq += 1
            rec = CycleRecord(self._seq, kind)
        token = _current_record.set(rec)
        try:
            with tracing.span("cycle", kind=kind, seq=rec.seq, **tags) as sp:
                rec.trace_id = getattr(sp, "trace_id", None)
                yield rec
        except BaseException as exc:
            rec.error = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            _current_record.reset(token)
            rec.duration_ms = (time.perf_counter() - rec._t0) * 1000.0
            self._finish(rec)

    def _finish(self, rec: CycleRecord) -> None:
        if rec.trace_id is not None:
            for doc in tracing.tracer.traces(rec.trace_id):
                phase = PHASE_BY_SPAN.get(doc["span"])
                if phase is not None:
                    rec.phases[phase] = rec.phases.get(phase, 0.0) \
                        + (doc.get("duration_ms") or 0.0)
        with self._lock:
            self._ring.append(rec)
        registry.observe("cook_cycle_duration_seconds",
                         rec.duration_ms / 1000.0, {"kind": rec.kind})
        if rec.jobs_considered:
            registry.counter_inc("cook_cycle_jobs_considered",
                                 rec.jobs_considered)
        if rec.jobs_placed:
            registry.counter_inc("cook_cycle_jobs_placed", rec.jobs_placed)

    # ------------------------------------------------------------- telemetry
    def current(self) -> Optional[CycleRecord]:
        return _current_record.get()

    def note_recompile(self, kernel: str, n: int = 1) -> None:
        rec = _current_record.get()
        if rec is not None:
            with self._lock:
                rec.recompiles[kernel] = rec.recompiles.get(kernel, 0) + n

    def note_transfer(self, direction: str, nbytes: int) -> None:
        rec = _current_record.get()
        if rec is not None:
            with self._lock:
                if direction == "h2d":
                    rec.h2d_bytes += int(nbytes)
                else:
                    rec.d2h_bytes += int(nbytes)

    def note_sync_wait(self, seconds: float) -> None:
        rec = _current_record.get()
        if rec is not None:
            with self._lock:
                rec.sync_wait_ms += seconds * 1000.0

    def note_skips(self, reasons: Dict[str, int]) -> None:
        """Head-of-line skip reasons histogram (why a pending job was
        passed over this cycle: over-quota, rate-limited, launch-filtered,
        offensive, unmatched, launch-failed)."""
        rec = _current_record.get()
        if rec is None:
            return
        with self._lock:
            for reason, n in reasons.items():
                if n:
                    rec.skip_reasons[reason] = \
                        rec.skip_reasons.get(reason, 0) + int(n)

    def note_preemptions(self, n: int) -> None:
        rec = _current_record.get()
        if rec is not None and n:
            with self._lock:
                rec.preemptions += int(n)

    def note_pipeline(self, depth: int, inflight: int) -> None:
        """Pipelined-driver shape of the current cycle (sched/pipeline.py):
        configured depth and dispatches in flight after staging."""
        rec = _current_record.get()
        if rec is not None:
            with self._lock:
                rec.pipeline_depth = int(depth)
                rec.pipeline_inflight = int(inflight)

    def note_pipeline_conflicts(self, n: int) -> None:
        """Reconciliation conflict drops (candidates re-validated against
        the store and dropped instead of double-launched) inside the
        current cycle."""
        rec = _current_record.get()
        if rec is not None and n:
            with self._lock:
                rec.pipeline_conflicts += int(n)

    def note_phase_detail(self, name: str, ms: float) -> None:
        """Sub-phase duration (pack / stage / apply) summed onto the
        current record's detail breakdown."""
        rec = _current_record.get()
        if rec is not None:
            with self._lock:
                rec.detail_ms[name] = rec.detail_ms.get(name, 0.0) \
                    + float(ms)

    def note_delta(self, rows: int) -> None:
        """Delta rows scatter-applied into the device-resident pack this
        cycle (0 on a quiet cycle; the steady-state guard asserts it)."""
        rec = _current_record.get()
        if rec is not None and rows:
            with self._lock:
                rec.delta_rows += int(rows)

    def note_repack(self, reason: str) -> None:
        """A full resident-pack repack (reason also labels
        cook_resident_repack_total)."""
        rec = _current_record.get()
        if rec is not None:
            with self._lock:
                rec.full_repacks += 1

    def note_audit(self, n: int = 1) -> None:
        """Per-job audit events (utils/audit.py) recorded inside the
        current cycle."""
        rec = _current_record.get()
        if rec is not None and n:
            with self._lock:
                rec.audit_events += int(n)

    def note_kernel_launch(self, kernel: str, n: int = 1) -> None:
        """One device kernel dispatch attributed to the current cycle
        (counted by InstrumentedJit on every call — the megakernel's
        headline is this number going to 1)."""
        rec = _current_record.get()
        if rec is not None and n:
            with self._lock:
                rec.kernel_launches += int(n)

    def note_path(self, path: str) -> None:
        """The cycle's dispatch path (split | fused | megakernel); two
        different notes inside one cycle record as "mixed".  Also tagged
        onto the live cycle span so the Perfetto export carries it."""
        rec = _current_record.get()
        if rec is None:
            return
        with self._lock:
            if rec.path is None or rec.path == path:
                rec.path = path
            else:
                rec.path = "mixed"
        sp = tracing.tracer.current()
        if sp is not None:
            sp.set_tag("path", rec.path)

    def note_fault(self, point: str, n: int = 1) -> None:
        """A fault-point trigger or degradation (kernel fallback, breaker
        reroute) attributed to the cycle it happened inside."""
        rec = _current_record.get()
        if rec is not None:
            with self._lock:
                rec.faults[point] = rec.faults.get(point, 0) + int(n)

    # ----------------------------------------------------------------- query
    def recent(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Newest-last list of finished cycle record documents."""
        limit = int(limit)
        if limit <= 0:
            return []
        with self._lock:
            records = list(self._ring)
        return [r.to_doc() for r in records[-limit:]]

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def recent_durations(self, kinds, limit: int) -> List[float]:
        """duration_ms of the newest ``limit`` records of the given kinds,
        oldest first — the SLO sweep's cheap periodic read (no to_doc
        dict materialization for the whole ring)."""
        with self._lock:
            records = list(self._ring)
        out = [r.duration_ms for r in records if r.kind in kinds]
        return out[-max(int(limit), 0):] if limit > 0 else []

    def summary(self, since_seq: int = 0) -> Dict[str, Any]:
        """Aggregate over records with seq > since_seq (the simulator and
        bench sections snapshot last_seq() at start and summarize their
        own cycles at the end).  A run longer than the ring capacity is
        reported with ``truncated``/``cycles_evicted`` so an aggregate
        over a partial window is never mistaken for the whole run."""
        with self._lock:
            records = [r for r in self._ring if r.seq > since_seq]
            oldest = self._ring[0].seq if self._ring else self._seq + 1
        if not records:
            return {"cycles": 0}
        evicted = max(0, oldest - since_seq - 1)
        durs = sorted(r.duration_ms for r in records)

        def pctl(q: float) -> float:
            idx = min(len(durs) - 1, int(round(q / 100.0 * (len(durs) - 1))))
            return round(durs[idx], 3)

        by_shard: Dict[int, List[float]] = {}
        for r in records:
            if r.shard is not None:
                by_shard.setdefault(r.shard, []).append(r.duration_ms)

        def _shard_agg(durations: List[float]) -> Dict[str, Any]:
            ds = sorted(durations)

            def sp(q: float) -> float:
                i = min(len(ds) - 1, int(round(q / 100.0 * (len(ds) - 1))))
                return round(ds[i], 3)

            return {"cycles": len(ds), "cycle_ms_p50": sp(50),
                    "cycle_ms_p99": sp(99)}

        by_kind: Dict[str, int] = {}
        recompiles: Dict[str, int] = {}
        skips: Dict[str, int] = {}
        faults: Dict[str, int] = {}
        detail: Dict[str, float] = {}
        for r in records:
            by_kind[r.kind] = by_kind.get(r.kind, 0) + 1
            for k, v in r.recompiles.items():
                recompiles[k] = recompiles.get(k, 0) + v
            for k, v in r.skip_reasons.items():
                skips[k] = skips.get(k, 0) + v
            for k, v in r.faults.items():
                faults[k] = faults.get(k, 0) + v
            for k, v in r.detail_ms.items():
                detail[k] = detail.get(k, 0.0) + v
        return {
            "cycles": len(records),
            **({"truncated": True, "cycles_evicted": evicted}
               if evicted else {}),
            "by_kind": by_kind,
            "cycle_ms_p50": pctl(50),
            "cycle_ms_p99": pctl(99),
            # per-shard roll-up (sharded controllers): keyed by CycleRecord.shard,
            # present only when sharded cycles are in the window so the
            # classic single-process summary shape is unchanged
            **({"by_shard": {str(s): _shard_agg(d)
                             for s, d in sorted(by_shard.items())}}
               if by_shard else {}),
            "jobs_considered": sum(r.jobs_considered for r in records),
            "jobs_placed": sum(r.jobs_placed for r in records),
            "preemptions": sum(r.preemptions for r in records),
            "recompiles": recompiles,
            "skip_reasons": skips,
            "faults": faults,
            "pipeline_conflicts": sum(r.pipeline_conflicts
                                      for r in records),
            "h2d_bytes": sum(r.h2d_bytes for r in records),
            "d2h_bytes": sum(r.d2h_bytes for r in records),
            "sync_wait_ms": round(sum(r.sync_wait_ms for r in records), 3),
            "detail_ms": {k: round(v, 3) for k, v in detail.items()},
            "delta_rows": sum(r.delta_rows for r in records),
            "full_repacks": sum(r.full_repacks for r in records),
            "audit_events": sum(r.audit_events for r in records),
        }

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


recorder = FlightRecorder()
