"""The port's copy of ``cook_tpu/utils/audit.py`` (imports re-rooted).

Per-job scheduling audit trail: the Dapper-style per-entity lane the
per-cycle aggregates can't give (Sigelman et al., 2010; the scheduler
analogue of Monarch's entity-scoped monitoring, Adams et al., VLDB 2020).

The flight recorder (utils/flight.py) answers "what did cycle N do"; this
module answers **"why isn't MY job running"** — the dominant support
question of a fair-share multitenant scheduler (the reference carries an
unscheduled-jobs explainer and per-job instance history for exactly this
reason).  Every decision path records bounded per-job events:

  submitted -> ranked (queue position, DRU context) -> admission deferrals
  (rate-limit / cap / gang cohort reasons) -> match skip reasons -> gang
  cohort outcomes -> pipeline reconcile drops -> launch intent -> launch
  ack -> instance transitions -> preemption (victim AND beneficiary, with
  the DRU delta that justified it) -> terminal state.

Design constraints, in order:

1. **Bounded.**  Per-job lanes are capped (repeated advisory events —
   "ranked at position 7", "skipped: rate-limited" — COALESCE into one
   event with a count instead of churning the lane), the job map is an
   LRU with a global cap, and lifecycle events survive lane eviction
   preferentially.  A quiet pool records nothing: the resident driver's
   zero-work fast path stays zero-work.
2. **Attribution, not re-derivation.**  Decision paths already
   materialize the data (skip-reason vectors, gang partial maps, victim
   lists, reconcile masks); :func:`note_skips` turns exactly those into
   per-job events AND the flight recorder's aggregate histogram from ONE
   mapping, so the per-job sums reconcile with the aggregates by
   construction (tests/test_audit.py attribution parity).
3. **Survives failover.**  Events marked durable ride the store's redo
   journal as ``{"a": [...]}`` records (state/store.py): lifecycle events
   are journaled atomically with their transaction, advisory events are
   flushed once per cycle (first occurrence per coalesce key — counts
   drift after the first flush is an accepted economy).  Journal bytes
   replicate to standbys like any other record, so a promoted leader
   replays the trail and ``cs why`` keeps answering for pre-failover
   jobs.

Surfaces: ``GET /debug/job/<uuid>/timeline``, ``GET /unscheduled_jobs``
(history), ``cs why <uuid>``, and per-job instant-event tracks stitched
into the Chrome/Perfetto trace export (``/debug/trace?job=``).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .flight import recorder as _flight
from .locks import named_lock
from .metrics import registry

# event kinds that are one-shot lifecycle facts: never coalesced, last to
# be evicted from a full lane, journaled atomically with their txn
LIFECYCLE_KINDS = frozenset({
    "submitted", "committed", "launched", "launch-ack", "launch-denied",
    "instance", "requeued", "preempted", "preemption-benefit", "terminal",
})

# advisory kinds: high-frequency per-cycle attributions, coalesced by key
# ("ranked" by kind alone — its position just updates; skips by reason)
_COALESCE_BY_KIND = frozenset({"ranked"})

# skip/defer reasons that are FAIRNESS throttles rather than capacity or
# constraint misses — the wait-phase classifier (sched/monitor.py) and
# `cs why` read this split
FAIRNESS_REASONS = frozenset({
    "over-quota", "rate-limited", "cap-reserved", "gang-deferred",
    "offensive", "launch-filtered", "admission-throttled",
})
CONSTRAINT_REASONS = frozenset({"gang-partial"})


class _Ev:
    __slots__ = ("ts", "ts_last", "kind", "data", "count", "flushed")

    def __init__(self, ts: int, kind: str, data: Optional[Dict[str, Any]]):
        self.ts = ts
        self.ts_last = ts
        self.kind = kind
        self.data = data or {}
        self.count = 1
        self.flushed = False

    def to_doc(self) -> Dict[str, Any]:
        doc = {"ts": self.ts, "kind": self.kind, "count": self.count}
        if self.ts_last != self.ts:
            doc["ts_last"] = self.ts_last
        if self.data:
            doc["data"] = dict(self.data)
        return doc

    def to_wire(self, uuid: str) -> Dict[str, Any]:
        w = {"u": uuid, "k": self.kind, "t": self.ts}
        if self.count > 1:
            w["n"] = self.count
        if self.data:
            w["d"] = dict(self.data)
        return w


class _Lane:
    """One job's bounded event lane + its coalesce index."""

    __slots__ = ("events", "by_key", "last_reason")

    def __init__(self):
        self.events: List[_Ev] = []
        self.by_key: Dict[Any, _Ev] = {}
        self.last_reason: Optional[str] = None


class AuditTrail:
    """Bounded per-job decision-event lanes (see module doc)."""

    def __init__(self, clock: Optional[Callable[[], int]] = None,
                 max_jobs: int = 100_000, per_job: int = 64):
        # "audit" ranks ABOVE "store" in the global lock-order contract
        # (utils/locks.py): store->audit is the single nesting direction
        # everywhere (flush_audit drains under the store lock)
        self._lock = named_lock("audit")
        self._lanes: "OrderedDict[str, _Lane]" = OrderedDict()
        self._clock = clock or (lambda: int(time.time() * 1000))
        self.enabled = True
        #: journal durable events (the store consults this before
        #: embedding/appending audit records)
        self.journal = True
        #: brownout stage >= 1 (sched/admission.py): fold the advisory
        #: flush — pending advisory events stop being serialized to the
        #: journal (the in-memory lanes keep everything, so `cs why`
        #: still answers; only pre-failover durability of ADVISORY
        #: detail is shed).  Lifecycle events ride their own txn
        #: records and are untouched.
        self.shed_advisory = False
        #: advisory events folded (not journaled) while shedding —
        #: surfaced via stats() so the brownout's cost is visible
        self.shed_count = 0
        self.max_jobs = max_jobs
        self.per_job = per_job
        # durable events awaiting a journal flush (Store.flush_audit)
        self._pending: List[Tuple[str, _Ev]] = []
        # cook_audit_events_total accumulator: the hot paths record one
        # batch per TRANSACTION (thousands per cycle), so the labeled
        # registry increment is deferred to publish_metrics() — once per
        # cycle — instead of paying label-key hashing per batch
        self._ev_counts: Dict[str, int] = {}
        # fairness-plane cache: pool -> {user -> DRU} at the last
        # monitor sweep, attached to ranked events and `cs why` output
        # ("DRU at rank time", refreshed at the sweep cadence).  Each
        # sweep REPLACES a pool's table (set_user_dru), so departed
        # users age out instead of leaking for the leader's lifetime.
        self._user_dru: Dict[str, Dict[str, float]] = {}

    def configure(self, conf) -> None:
        """Apply config.AuditConfig (scheduler boot)."""
        self.enabled = bool(conf.enabled)
        self.journal = bool(conf.journal)
        self.max_jobs = int(conf.max_jobs)
        self.per_job = int(conf.per_job_events)

    # -------------------------------------------------------------- record
    def _record_one(self, uuid: str, kind: str,
                    data: Optional[Dict[str, Any]], ts: int,
                    count: int, durable: bool, loaded: bool) -> None:
        """One event append/coalesce; caller holds ``self._lock``.  The
        hot paths record THOUSANDS of events per cycle (every launch is
        3+ lifecycle events), so the lock round-trip, flight note, and
        metric increment are batched by the public entry points — this
        core is pure dict work.  Job eviction is INSERTION-ordered (the
        oldest-created lane goes first), not strict LRU: the earliest
        submissions are the likeliest terminal, and skipping the
        per-event move_to_end keeps the hot path flat."""
        lane = self._lanes.get(uuid)
        if lane is None:
            lane = self._lanes[uuid] = _Lane()
            while len(self._lanes) > self.max_jobs:
                self._lanes.popitem(last=False)
        key = None
        if kind in _COALESCE_BY_KIND:
            key = kind
        elif kind == "skip":
            key = (kind, (data or {}).get("reason"))
            lane.last_reason = (data or {}).get("reason")
        if key is not None:
            ev = lane.by_key.get(key)
            if ev is not None:
                # eviction scrubs by_key (below), so a hit is always
                # live — the coalesce path stays a true O(1) lookup
                ev.count += count
                ev.ts_last = ts
                if kind in _COALESCE_BY_KIND and data:
                    ev.data.update(data)
                return
        ev = _Ev(ts, kind, data)
        ev.count = count
        lane.events.append(ev)
        if key is not None:
            lane.by_key[key] = ev
        if len(lane.events) > self.per_job:
            # evict the oldest ADVISORY event first: "submitted" /
            # "launched" must outlive a thousand "ranked" updates
            for i, old in enumerate(lane.events):
                if old.kind not in LIFECYCLE_KINDS:
                    lane.events.pop(i)
                    break
            else:
                old = lane.events.pop(0)
            if lane.by_key:
                # scrub the evicted event's coalesce entry (tiny dict:
                # one entry per distinct reason) so by_key never holds
                # a dead reference the coalesce path could resurrect
                lane.by_key = {k: v for k, v in lane.by_key.items()
                               if v is not old}
        if durable and not loaded:
            self._pending.append((uuid, ev))

    def record(self, uuid: str, kind: str,
               data: Optional[Dict[str, Any]] = None, *,
               durable: bool = False, ts: Optional[int] = None,
               count: int = 1, _loaded: bool = False) -> None:
        if not self.enabled or not uuid:
            return
        if ts is None:
            ts = int(self._clock())
        with self._lock:
            self._record_one(uuid, kind, data, ts, count, durable,
                             _loaded)
            if not _loaded:
                # cook_audit_events_total covers EVERY recording path
                # (preempted/preemption-benefit arrive through here)
                self._ev_counts[kind] = \
                    self._ev_counts.get(kind, 0) + count
        if not _loaded:
            _flight.note_audit(count)

    def skips(self, mapping: Dict[str, Iterable], pool: Optional[str] = None
              ) -> None:
        """Per-job skip attribution: ``mapping`` is reason -> iterable of
        job uuids or (uuid, extra-data) tuples — the same structure whose
        lengths feed the flight recorder's aggregate histogram
        (:func:`note_skips` passes one mapping to both)."""
        if not self.enabled:
            return
        ts = int(self._clock())
        total = 0
        with self._lock:
            for reason, items in mapping.items():
                for item in items:
                    if isinstance(item, tuple):
                        uuid, extra = item
                        data = {"reason": reason, **extra}
                    else:
                        uuid, data = item, {"reason": reason}
                    if pool is not None:
                        data.setdefault("pool", pool)
                    self._record_one(str(uuid), "skip", data, ts, 1,
                                     True, False)
                    total += 1
        if total:
            _flight.note_audit(total)
            with self._lock:
                self._ev_counts["skip"] = \
                    self._ev_counts.get("skip", 0) + total

    def ranked(self, uuids: Iterable[str], positions: Iterable[int],
               pool: str, users: Optional[Iterable[str]] = None) -> None:
        """Per-cycle rank attribution for the ADMITTED candidate slots
        (bounded by the considerable cap, never [T]-sized): queue
        position now, plus the user's DRU from the fairness-plane cache
        when known."""
        if not self.enabled:
            return
        ts = int(self._clock())
        users = list(users) if users is not None else None
        dru_tab = self._user_dru.get(pool) or {}
        n = 0
        with self._lock:
            for i, (uuid, pos) in enumerate(zip(uuids, positions)):
                data: Dict[str, Any] = {"pos": int(pos), "pool": pool}
                if users is not None:
                    dru = dru_tab.get(users[i])
                    if dru is not None:
                        data["dru"] = round(dru, 4)
                self._record_one(str(uuid), "ranked", data, ts, 1,
                                 True, False)
                n += 1
        if n:
            _flight.note_audit(n)
            with self._lock:
                self._ev_counts["ranked"] = \
                    self._ev_counts.get("ranked", 0) + n

    # ----------------------------------------------------------- tx events
    def on_tx_events(self, events) -> None:
        """Lifecycle events off the store's transaction feed
        (state/store.py TxEvent).  Durability for these does NOT go
        through the pending flush: the store journals them atomically
        with their transaction (``"a"`` key on the txn record), so they
        are marked pre-flushed here."""
        if not self.enabled:
            return
        ts = None
        by_kind: Dict[str, int] = {}
        with self._lock:
            for e in events:
                wire = tx_event_to_audit(e)
                if wire is None:
                    continue
                if ts is None:
                    ts = int(self._clock())
                uuid, kind, data = wire
                self._record_one(uuid, kind, data, ts, 1, False, False)
                by_kind[kind] = by_kind.get(kind, 0) + 1
            for kind, n in by_kind.items():
                self._ev_counts[kind] = self._ev_counts.get(kind, 0) + n
        if by_kind:
            _flight.note_audit(sum(by_kind.values()))

    def publish_metrics(self) -> None:
        """Push the accumulated per-kind event counts onto
        ``cook_audit_events_total`` — called once per scheduler cycle
        (Store.flush_audit) and from stats(), so the registry sees the
        same totals without per-transaction label hashing."""
        with self._lock:
            counts, self._ev_counts = self._ev_counts, {}
        for kind, n in counts.items():
            registry.counter_inc("cook_audit_events", float(n),
                                 {"kind": kind})

    def discard_pending(self) -> None:
        """Drop pending durable events WITHOUT serializing them — the
        no-journal store's once-per-cycle pressure valve (there is no
        durability to provide; the in-memory lanes keep everything)."""
        with self._lock:
            pending, self._pending = self._pending, []
            for _uuid, ev in pending:
                ev.flushed = True

    # ------------------------------------------------------------ fairness
    def set_user_dru(self, pool: str, table: Dict[str, float]) -> None:
        """Replace a pool's DRU cache wholesale (the monitor sweep's
        publish path): users absent from the new table are gone —
        bounded by the CURRENT user population, never cumulative."""
        with self._lock:
            self._user_dru[pool] = {u: float(v) for u, v in table.items()}

    def user_dru(self, pool: str, user: str) -> Optional[float]:
        with self._lock:
            tab = self._user_dru.get(pool)
            return tab.get(user) if tab is not None else None

    def user_dru_table(self, pool: str) -> Dict[str, float]:
        """Copy of a pool's whole per-user DRU table (the fairness
        plane's objective signal for the goodput optimizer,
        sched/optimizer.py)."""
        with self._lock:
            tab = self._user_dru.get(pool)
            return dict(tab) if tab is not None else {}

    def last_reason(self, uuid: str) -> Optional[str]:
        """The job's most recent skip/defer reason (wait-phase
        classification input; O(1))."""
        with self._lock:
            lane = self._lanes.get(uuid)
            return lane.last_reason if lane is not None else None

    def last_reasons(self, uuids) -> Dict[str, Optional[str]]:
        """Bulk :meth:`last_reason` under ONE lock hold — the monitor's
        whole-pending-queue sweep must not pay 100k lock round-trips
        contending with the scheduler's hot-path record() calls."""
        with self._lock:
            lanes = self._lanes
            return {u: (lane.last_reason
                        if (lane := lanes.get(u)) is not None else None)
                    for u in uuids}

    # ----------------------------------------------------------- durability
    def drain_durable(self) -> List[Dict[str, Any]]:
        """Wire docs for durable events not yet journaled (Store.
        flush_audit calls this once per cycle).  Coalesced events are
        journaled at their first flush only; later count bumps stay
        in-memory (bounded journal growth).  Under brownout stage >= 1
        (``shed_advisory``, sched/admission.py) the flush FOLDS:
        pending events are marked flushed without serializing — zero
        journal bytes, in-memory lanes intact, `cs why` keeps
        answering; only pre-failover durability of advisory detail is
        shed."""
        with self._lock:
            pending, self._pending = self._pending, []
            out = []
            for uuid, ev in pending:
                if ev.flushed:
                    continue
                ev.flushed = True
                if self.shed_advisory:
                    self.shed_count += 1
                    continue
                out.append(ev.to_wire(uuid))
            return out

    def load(self, records: List[Dict[str, Any]]) -> None:
        """Rebuild lanes from journal ``"a"`` records (replay at store
        open / leader promotion).  Loaded events never re-pend: the
        journal copy they came from is already in this store's journal."""
        if not self.enabled:
            return
        with self._lock:
            for r in records:
                try:
                    self._record_one(
                        r["u"], r["k"], r.get("d"),
                        int(r.get("t") or 0), int(r.get("n", 1)),
                        False, True)
                except (KeyError, TypeError, ValueError):
                    continue  # a malformed advisory record won't stop a boot

    def export_wire(self, max_events: int = 100_000) -> List[Dict[str, Any]]:
        """Every lane's events as wire docs — NEWEST lanes first under
        the cap (checkpoint compaction re-seeds the truncated journal
        with this): when the trail is bigger than the cap, it is the
        recently-submitted ACTIVE jobs whose failover continuity
        matters, not the oldest (mostly terminal) lanes.  A truncation
        is logged — a silent partial re-seed would read as full
        continuity."""
        selected: List[Tuple[str, List[_Ev]]] = []
        total = 0
        truncated = False
        with self._lock:
            for uuid, lane in reversed(self._lanes.items()):
                if total + len(lane.events) > max_events:
                    truncated = True
                    break
                selected.append((uuid, list(lane.events)))
                total += len(lane.events)
        # selection prioritizes the newest lanes, but the WIRE order is
        # oldest-first: load() re-inserts in wire order, and an inverted
        # order would make the newest pre-checkpoint jobs the first
        # evicted once the lane cap bites after a replay
        out = [ev.to_wire(uuid)
               for uuid, events in reversed(selected)
               for ev in events]
        if truncated:
            import logging
            logging.getLogger(__name__).warning(
                "audit re-seed truncated at %d events: only the newest "
                "lanes keep pre-compaction timeline continuity",
                len(out))
        return out

    # ---------------------------------------------------------------- query
    def timeline(self, uuid: str) -> List[Dict[str, Any]]:
        """The job's event documents in insertion (time) order."""
        with self._lock:
            lane = self._lanes.get(uuid)
            if lane is None:
                return []
            return [ev.to_doc() for ev in lane.events]

    def jobs_tracked(self) -> int:
        with self._lock:
            return len(self._lanes)

    def pending_durable_count(self) -> int:
        """Durable events still buffered for the journal — the cheap
        per-sweep read behind the ``audit_queue`` saturation signal
        (sched/fleet.py); :meth:`stats` walks every lane, this holds
        the lock for one ``len``."""
        with self._lock:
            return len(self._pending)

    def stats(self) -> Dict[str, Any]:
        """Aggregate counts for the simulator summary / tests."""
        self.publish_metrics()
        by_kind: Dict[str, int] = {}
        with self._lock:
            for lane in self._lanes.values():
                for ev in lane.events:
                    by_kind[ev.kind] = by_kind.get(ev.kind, 0) + ev.count
            return {"jobs": len(self._lanes), "by_kind": by_kind,
                    "pending_durable": len(self._pending),
                    "shed_advisory": self.shed_advisory,
                    "shed_count": self.shed_count}

    def skip_counts(self) -> Dict[str, int]:
        """Per-reason sums over every job's skip events — the attribution
        side of the parity check against the flight recorder's aggregate
        skip histogram."""
        counts: Dict[str, int] = {}
        with self._lock:
            for lane in self._lanes.values():
                for ev in lane.events:
                    if ev.kind == "skip":
                        r = ev.data.get("reason", "?")
                        counts[r] = counts.get(r, 0) + ev.count
        return counts

    def reset(self) -> None:
        with self._lock:
            self._lanes.clear()
            self._pending.clear()
            self._user_dru.clear()


def tx_event_to_audit(e) -> Optional[Tuple[str, str, Dict[str, Any]]]:
    """TxEvent -> (job uuid, audit kind, data), or None for kinds the
    trail doesn't track.  One mapping shared by the live feed
    (AuditTrail.on_tx_events) and the store's journal append (which
    embeds the same docs in the txn record for replay).  Branches are
    frequency-ordered: at 1000 launches/cycle this runs thousands of
    times per cycle."""
    kind, data = e.kind, e.data
    if kind == "instance-status":
        d = {"task": data.get("task_id"), "to": data.get("new")}
        reason = data.get("reason")
        if reason is not None:
            d["reason"] = reason
        return data["job"], "instance", d
    if kind == "job-state":
        new = data.get("new")
        if new == "completed":
            return data["uuid"], "terminal", {}
        if new == "waiting" and data.get("old") == "running":
            return data["uuid"], "requeued", {}
        return None
    if kind == "instance-created":
        d = {"task": data.get("task_id"), "host": data.get("hostname")}
        gang = data.get("gang")
        if gang:
            d["gang"] = gang
        # serving-plane stitch points (docs/OBSERVABILITY.md): the
        # submission request's trace id and the trace of the cycle that
        # placed the job — /debug/trace?job= resolves both from here
        if data.get("trace"):
            d["trace"] = data["trace"]
        if data.get("cycle_trace"):
            d["cycle_trace"] = data["cycle_trace"]
        return data["job"], "launched", d
    if kind == "launch-ack":
        return data["job"], "launch-ack", {"task": data.get("task_id")}
    if kind == "job-created":
        d = {"user": data.get("user"), "pool": data.get("pool")}
        if data.get("trace"):
            d["trace"] = data["trace"]
        return data["uuid"], "submitted", d
    return None


def note_skips(trail: Optional[AuditTrail],
               mapping: Dict[str, Iterable],
               pool: Optional[str] = None) -> None:
    """Attributed skip noting: ONE mapping (reason -> job uuids, or
    (uuid, extra) tuples) feeds both the flight recorder's aggregate
    histogram and the per-job audit lanes, so the two can never drift
    (the attribution-parity invariant)."""
    counts = {}
    for reason, items in mapping.items():
        items = list(items)
        mapping[reason] = items
        if items:
            counts[reason] = len(items)
    if counts:
        _flight.note_skips(counts)
    if trail is not None and trail.enabled and counts:
        trail.skips({r: mapping[r] for r in counts}, pool=pool)


def wait_phase(reason: Optional[str], over_share: bool) -> str:
    """Classify WHY a pending job is waiting (the fairness plane's
    queue-latency split, sched/monitor.py):

    - ``fairness`` — throttled by a fair-share mechanism (quota, rate
      limit, reserved cap, gang admission) or the user is at/over share
      with no contrary signal;
    - ``constraints`` — the job (or its gang) can't be placed for
      constraint/topology reasons;
    - ``capacity`` — placeable in principle, no host has room (or no
      attribution yet and the user is under share)."""
    if reason in FAIRNESS_REASONS:
        return "fairness"
    if reason in CONSTRAINT_REASONS or reason == "constraints":
        return "constraints"
    if reason in ("unmatched", "launch-failed", "pipeline-conflict",
                  "pipeline-speculative"):
        return "capacity"
    return "fairness" if over_share else "capacity"
