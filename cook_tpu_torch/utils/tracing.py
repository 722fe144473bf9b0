"""The port's copy of ``cook_tpu/utils/tracing.py`` (imports re-rooted).

Tracing spans around scheduler stages and kernel dispatches.

Plays the role of the reference's OpenTracing integration: every stage of
the match path is wrapped in a span carrying pool/cluster tags (reference:
scheduler.clj:2438 `scheduler.pool-handler`, scheduler.clj:662-671
`match-offer-to-scheduler.fenzo-schedule-once`,
kubernetes/compute_cluster.clj:425 `k8s.launch-tasks`). Durations are
tri-recorded the way the reference records them (prometheus_metrics.clj
with-duration + structured match-cycle log documents): each finished span

  1. observes `cook_span_duration_seconds{span=..., <tags>}` on the global
     metrics registry,
  2. emits a structured JSON log line on the `cook.trace` logger,
  3. lands in an in-memory ring buffer served by the /debug REST endpoint.

Spans nest via a ``contextvars`` stack so kernel dispatch spans inherit a
trace id from the enclosing cycle span — enough to reconstruct per-cycle
flamegraphs offline without an external collector (zero-egress friendly).
Context variables (unlike the previous thread-local stack) survive the
async/executor boundaries the fused dispatch path uses: a launch thread
started under ``contextvars.copy_context().run`` keeps its kernel spans
under the owning cycle's trace_id, while plain ``threading.Thread``
workers still start with an empty stack (fresh root traces).

The whole span ring of one trace can be exported as Chrome/Perfetto
trace-event JSON (:meth:`Tracer.export_chrome_trace`), served by
``GET /debug/trace?trace_id=`` — load it in ``chrome://tracing`` or
https://ui.perfetto.dev to see the cycle flamegraph.
"""

from __future__ import annotations

import contextvars
import logging
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from .metrics import registry

_log = logging.getLogger("cook.trace")

_MAX_FINISHED = 4096

# The span stack is an immutable tuple in a context variable: each span
# push/pop is a set/reset, so a context copied into an executor sees a
# consistent snapshot and mutations never leak between contexts.
_stack_var: "contextvars.ContextVar[tuple]" = contextvars.ContextVar(
    "cook_span_stack", default=())

# Per-request phase accumulator (rest/instrument.py): while a collector
# dict is installed, every finished span adds its duration under its
# name — the request handler reads back a {span-name: seconds} breakdown
# ("how much of this POST was replication ack wait") without walking the
# span ring.  None (the default) costs one contextvar read per span.
_phases_var: "contextvars.ContextVar[Optional[dict]]" = \
    contextvars.ContextVar("cook_req_phases", default=None)


@contextmanager
def collect_phases():
    """Install a fresh per-request phase dict; yields it.  Nested
    collectors shadow (each request owns exactly its own spans)."""
    phases: Dict[str, float] = {}
    token = _phases_var.set(phases)
    try:
        yield phases
    finally:
        _phases_var.reset(token)


# ------------------------------------------------------- process identity
# Every span is stamped with the identity of the PROCESS (fleet member)
# that recorded it — the grouping key the fleet trace collector turns
# into per-process Perfetto tracks (docs/OBSERVABILITY.md "Debugging the
# fleet").  The default is a process-global set once by the daemon at
# boot (node id); a contextvar override scopes a DIFFERENT identity to
# one request, so an in-process multi-server topology (tests, the
# simulator) still yields distinct per-member tracks out of one shared
# ring.
_proc_default = "cook"
_identity_var: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("cook_proc_identity", default=None)


def set_process_identity(name: str) -> None:
    """Install the process-global span identity (daemon boot: node id)."""
    global _proc_default
    _proc_default = str(name)


def process_identity() -> str:
    """The identity spans record right now (contextvar override wins)."""
    return _identity_var.get() or _proc_default


@contextmanager
def scoped_identity(name: Optional[str]):
    """Spans opened inside record under ``name`` instead of the process
    default — the REST handler scopes each request to its serving node's
    identity.  ``None`` is a no-op (keeps the ambient identity)."""
    if name is None:
        yield
        return
    token = _identity_var.set(str(name))
    try:
        yield
    finally:
        _identity_var.reset(token)


# ------------------------------------------------------ W3C trace context
# Propagated over the `traceparent` HTTP header (W3C Trace Context:
# 00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>).  Internal span
# ids are 16-hex; they are zero-padded on the wire and the pad is
# stripped on parse, so an in-process client span and the server's
# http.request root share ONE trace id.
_PAD = "0" * 16


def make_traceparent(trace_id: Optional[str] = None,
                     span_id: Optional[str] = None) -> str:
    """A traceparent header value; mints a fresh trace when no ids are
    given (the client-side entry point)."""
    tid = (trace_id or uuid.uuid4().hex).lower()
    if len(tid) < 32:
        tid = tid.rjust(32, "0")
    sid = (span_id or uuid.uuid4().hex[:16]).lower()
    if len(sid) < 16:
        sid = sid.rjust(16, "0")
    return f"00-{tid[:32]}-{sid[:16]}-01"


def parse_traceparent(header: Optional[str]
                      ) -> Optional[tuple]:
    """(trace_id, parent_span_id) from a traceparent header, or None when
    absent/malformed (a garbage header must never 500 a request)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    _ver, tid, sid = parts[0], parts[1].lower(), parts[2].lower()
    try:
        int(tid, 16)
        int(sid, 16)
    except ValueError:
        return None
    if len(tid) != 32 or len(sid) != 16 or tid == "0" * 32:
        return None
    if tid.startswith(_PAD):
        tid = tid[16:]  # our own padded 16-hex form round-trips
    return tid, sid


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "tags",
                 "start_s", "duration_s", "error", "proc")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 tags: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        self.tags = tags
        self.start_s = time.time()
        self.duration_s: Optional[float] = None
        self.error: Optional[str] = None
        self.proc = process_identity()

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    def to_doc(self) -> Dict[str, Any]:
        return {"span": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "proc": self.proc,
                "start": self.start_s, "duration_ms":
                round((self.duration_s or 0.0) * 1000.0, 3),
                "error": self.error, **self.tags}


class Tracer:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.finished: List[Dict[str, Any]] = []
        self.enabled = True
        # hot-path I/O spans (journal append / replication ack wait,
        # state/store.py): gated separately so the rest_plane bench can
        # A/B exactly the serving-plane instrumentation without touching
        # the cycle spans
        self.io_spans = True

    def current(self) -> Optional[Span]:
        st = _stack_var.get()
        return st[-1] if st else None

    @contextmanager
    def span(self, name: str, remote_parent: Optional[tuple] = None,
             **tags: Any):
        """Open a span; tags with None values are dropped (matches the
        reference's optional pool/cluster tags).  ``remote_parent`` is a
        propagated (trace_id, span_id) — e.g. a parsed ``traceparent``
        header — adopted only when no LOCAL parent is active (the
        in-process stack always wins)."""
        if not self.enabled:
            yield _NOOP_SPAN
            return
        tags = {k: v for k, v in tags.items() if v is not None}
        parent = self.current()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif remote_parent is not None:
            trace_id, parent_id = remote_parent
        else:
            trace_id, parent_id = uuid.uuid4().hex[:16], None
        sp = Span(name, trace_id, parent_id, tags)
        token = _stack_var.set(_stack_var.get() + (sp,))
        t0 = time.perf_counter()
        try:
            yield sp
        except BaseException as exc:
            sp.error = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            sp.duration_s = time.perf_counter() - t0
            _stack_var.reset(token)
            self._record(sp)

    def _record(self, sp: Span) -> None:
        phases = _phases_var.get()
        if phases is not None:
            phases[sp.name] = phases.get(sp.name, 0.0) \
                + (sp.duration_s or 0.0)
        metric_labels = {"span": sp.name}
        for key in ("pool", "cluster"):
            if key in sp.tags:
                metric_labels[key] = str(sp.tags[key])
        registry.observe("cook_span_duration_seconds", sp.duration_s or 0.0,
                         metric_labels)
        doc = sp.to_doc()
        if _log.isEnabledFor(logging.DEBUG):
            _log.debug(sp.name, extra={"doc": doc})
        with self._lock:
            self.finished.append(doc)
            if len(self.finished) > _MAX_FINISHED:
                del self.finished[:_MAX_FINISHED // 2]

    def record_finished(self, name: str, duration_s: float,
                        **tags: Any) -> None:
        """Record an already-measured span under the CURRENT context —
        for costs incurred on a shared worker thread and attributed back
        to each awaiting request (the group committer's batched journal
        fsync / replication ack wait, state/store.py): the waiter calls
        this from its own request context once its batch resolves, so
        the shared round lands in the request's span tree, phase
        breakdown, and RED phase metrics like an inline span would."""
        if not self.enabled:
            return
        tags = {k: v for k, v in tags.items() if v is not None}
        parent = self.current()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = uuid.uuid4().hex[:16], None
        sp = Span(name, trace_id, parent_id, tags)
        sp.start_s = time.time() - max(duration_s, 0.0)
        sp.duration_s = max(duration_s, 0.0)
        self._record(sp)

    def recent(self, limit: int = 100,
               name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if name is None:
                return self.finished[-limit:]
            # copy under the lock, filter OUTSIDE it: the name scan is
            # O(ring) python work that would otherwise stall every
            # concurrent span completion for its duration
            docs = list(self.finished)
        out: List[Dict[str, Any]] = []
        # newest-first scan honoring the limit: the common "recent N of a
        # hot span name" query stops after N hits instead of walking the
        # whole ring
        for d in reversed(docs):
            if d["span"] == name:
                out.append(d)
                if len(out) >= limit:
                    break
        out.reverse()
        return out

    def traces(self, trace_id: str) -> List[Dict[str, Any]]:
        with self._lock:
            docs = list(self.finished)
        return [d for d in docs if d["trace_id"] == trace_id]

    def trace_events(self, trace_id: str, tid: int = 1
                     ) -> List[Dict[str, Any]]:
        """One trace's spans as Chrome trace-event 'X' events on thread
        ``tid`` — the building block :meth:`export_chrome_trace` and the
        multi-track stitched export (``/debug/trace?job=``) share."""
        events: List[Dict[str, Any]] = []
        for d in self.traces(trace_id):
            args = {k: v for k, v in d.items()
                    if k not in ("span", "trace_id", "start", "duration_ms",
                                 "proc")
                    and v is not None}
            events.append({
                "name": d["span"],
                "cat": "cook",
                "ph": "X",
                "ts": round(d["start"] * 1e6, 3),
                "dur": max(round((d.get("duration_ms") or 0.0) * 1000.0, 3),
                           1.0),
                "pid": 1,
                "tid": tid,
                "args": args,
            })
        events.sort(key=lambda e: e["ts"])
        return events

    def export_chrome_trace(self, trace_id: str) -> Dict[str, Any]:
        """Export one trace's spans as Chrome trace-event JSON (the
        "JSON Array Format" with complete 'X' events), loadable in
        chrome://tracing and https://ui.perfetto.dev.

        ``ts``/``dur`` are microseconds; ``ts`` comes from the span's
        wall-clock start so events across processes line up.  Durations
        are clamped to >= 1 us: a zero-width event is dropped by some
        viewers, and every real span costs more than that anyway."""
        return {"traceEvents": self.trace_events(trace_id),
                "displayTimeUnit": "ms",
                "otherData": {"trace_id": trace_id}}

    def reset(self) -> None:
        with self._lock:
            self.finished.clear()


def track_meta(name: str, tid: int) -> Dict[str, Any]:
    """A Chrome-trace thread_name metadata event: names one stitched
    track (job lanes, the request track) in the Perfetto timeline."""
    return {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": name}}


def job_track_events(uuid: str, timeline: List[Dict[str, Any]],
                     tid: int = 2) -> List[Dict[str, Any]]:
    """One job's audit timeline (utils/audit.py event docs) as a named
    Chrome-trace TRACK of instant events, stitchable into any
    export_chrome_trace payload: the cycle flamegraph and the job's
    decision history line up on one Perfetto timeline
    (``/debug/trace?trace_id=...&job=<uuid>``).

    Audit timestamps are store-clock epoch ms (wall clock in
    production); span timestamps are wall-clock too, so the tracks align
    — under the simulator's virtual clock the job track keeps its own
    relative ordering but sits at virtual time."""
    if not timeline:
        return []
    # spans live on tid 1; each job track is its own lane (callers
    # stitching several jobs pass distinct tids)
    events: List[Dict[str, Any]] = [track_meta(f"job {uuid}", tid)]
    for ev in timeline:
        args = dict(ev.get("data") or {})
        if ev.get("count", 1) > 1:
            args["count"] = ev["count"]
        name = ev["kind"]
        if name == "skip" and args.get("reason"):
            name = f"skip:{args['reason']}"
        events.append({
            "name": name, "cat": "cook.audit", "ph": "i",
            "ts": round(ev["ts"] * 1000.0, 3), "pid": 1, "tid": tid,
            "s": "t", "args": args})
    return events


def _proc_sort_key(proc: str) -> tuple:
    """Stable track ordering for the stitched fleet export: the client
    track first (it owns the root span), the leader next, everyone else
    alphabetical — so every export of the same topology reads the same
    way top-to-bottom in Perfetto."""
    if proc.startswith("client"):
        rank = 0
    elif "leader" in proc or proc.startswith("cook"):
        rank = 1
    else:
        rank = 2
    return (rank, proc)


def fleet_trace_events(span_docs: List[Dict[str, Any]],
                       base_pid: int = 10) -> List[Dict[str, Any]]:
    """Merged span docs (each carrying its recording process in ``proc``)
    as Chrome trace events on PER-PROCESS tracks: every distinct proc
    gets its own ``pid`` with ``process_name`` + ``process_sort_index``
    metadata, so the gang-launch path shows leader txn, partition fsync,
    agent exec, and barrier release as separate swimlanes on one
    timeline (the Dapper stitch, docs/OBSERVABILITY.md).

    Spans are deduplicated by ``(proc, span_id)`` — the fleet collector
    fans out to every member and a member may return spans another
    member (or the local ring) already contributed."""
    procs = sorted({str(d.get("proc") or "?") for d in span_docs},
                   key=_proc_sort_key)
    pid_of = {p: base_pid + i for i, p in enumerate(procs)}
    events: List[Dict[str, Any]] = []
    for i, p in enumerate(procs):
        pid = pid_of[p]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": p}})
        events.append({"name": "process_sort_index", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"sort_index": i}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 1, "args": {"name": "spans"}})
    seen = set()
    for d in span_docs:
        proc = str(d.get("proc") or "?")
        key = (proc, d.get("span_id"))
        if key in seen:
            continue
        seen.add(key)
        args = {k: v for k, v in d.items()
                if k not in ("span", "trace_id", "start", "duration_ms",
                             "proc")
                and v is not None}
        events.append({
            "name": d.get("span", "?"),
            "cat": "cook",
            "ph": "X",
            "ts": round(float(d.get("start") or 0.0) * 1e6, 3),
            "dur": max(round((d.get("duration_ms") or 0.0) * 1000.0, 3),
                       1.0),
            "pid": pid_of[proc],
            "tid": 1,
            "args": args,
        })
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0)))
    return events


def export_fleet_trace(span_docs: List[Dict[str, Any]], trace_id: str,
                       members: Optional[List[Dict[str, Any]]] = None
                       ) -> Dict[str, Any]:
    """One stitched fleet-wide Perfetto export for ``trace_id``: the
    per-process tracks of :func:`fleet_trace_events` plus the collection
    provenance (which members contributed / failed) in ``otherData`` so
    a partial stitch is never mistaken for the whole fleet."""
    doc: Dict[str, Any] = {
        "traceEvents": fleet_trace_events(span_docs),
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": trace_id, "fleet": True},
    }
    if members is not None:
        doc["otherData"]["members"] = members
    return doc


class _NoopSpan:
    def set_tag(self, key: str, value: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan()

tracer = Tracer()


def span(name: str, **tags: Any):
    """Module-level shorthand: `with tracing.span("rank.cycle", pool=p):`"""
    return tracer.span(name, **tags)
