"""The port's copy of ``cook_tpu/utils/locks.py`` (imports re-rooted).

Named ordered locks + a dynamic lock-order/race sanitizer.

THE GLOBAL LOCK-ORDER CONTRACT (the single home of the rule that used to
live only in CHANGES.md prose — every module that nests two of these
locks must acquire them in ascending rank):

    ======  ==================  ==============================================
    rank    lock name           owner
    ======  ==================  ==============================================
    10      ``store.notify``    `state/store.py` — commit-ordered event drain
    15      ``read_replica``    `state/read_replica.py` — apply-loop/rebuild mutex
    18      ``elastic``         `sched/elastic.py` — resize-ledger mutex
    20      ``store``           `state/store.py` — the store's main RLock
    30      ``index``           `state/index.py` — columnar projection mutex
    40      ``audit``           `utils/audit.py` — per-job lane mutex
    50      ``repl.server``     `state/replication.py` — native-handle mutex
    55      ``repl.follower``   `state/replication.py` — native-handle mutex
    ======  ==================  ==============================================

    **Rank families** (the partitioned write plane, state/partition.py):
    a bracketed suffix scopes a lock to one partition without changing
    its rank — ``store[p0]``, ``store[p1]``, ``store.notify[p3]`` all
    carry their base name's declared rank.  SIBLING locks of one family
    (same base, different suffix — two partitions' store locks) carry
    the SAME rank, and same-rank cross-acquisition is ambiguous by
    construction: thread A holding ``store[p0]`` while taking
    ``store[p1]`` and thread B doing the reverse is a textbook deadlock
    the rank table cannot order.  The contract is therefore: **sibling
    locks of a rank family may never nest in each other** (the
    partitioned facade fans out sequentially, releasing each
    partition's lock before the next) — the sanitizer reports any
    sibling nesting as a ``sibling`` violation, and the bare base name
    counts as a sibling of its bracketed forms (``store`` inside
    ``store[p0]`` is equally unorderable).  Blocking-op allowlist
    entries apply family-wide: ``("store", "os.fsync")`` covers every
    ``store[pN]``.

Canonical nestings this encodes: ``store.notify → store`` (the drain loop
pops the event queue under the store lock), ``store.notify → index`` /
``store.notify → audit`` (tx-feed subscribers), ``store → audit``
(``flush_audit`` drains the advisory batch under the store lock —
"store→audit is the single lock order everywhere"), ``store →
repl.server`` (journal append pokes/awaits the replication server), and
``read_replica → store`` (the read view rebuilds/applies into its store
while holding its own mutex).  Acquiring against the ranks is a
potential deadlock and is reported by the sanitizer.

How it works (Eraser-style lockset discipline, Savage et al. TOCS'97,
adapted to ordering): every :class:`NamedLock`/:class:`NamedRLock`
acquisition consults a per-thread held stack kept by a
:class:`LockMonitor`.  The monitor

* records the **acquisition-graph edge** (innermost held lock → lock
  being acquired) — one dict hit per *novel* edge, near-zero steady
  state cost, so the graph is recorded in production too and exposed on
  ``GET /debug/health`` under ``"locks"``;
* on a novel edge, runs a DFS **cycle check** — an A→B edge when B→A is
  already reachable is a potential deadlock — and checks the **declared
  rank order** above;
* when :meth:`LockMonitor.arm_blocking_detector` is armed (the tier-1
  conftest does this), patches ``os.fsync`` / ``time.sleep`` /
  ``socket.socket.connect`` / ``socket.socket.sendall`` so a **blocking
  syscall while holding a named lock** is recorded unless the
  (lock, op) pair is explicitly allowlisted (:data:`ALLOWED_BLOCKING`
  — e.g. the store's write-ahead ``os.fsync`` under the store lock is
  the durability contract itself, not a bug).

Violations increment ``cook_lock_violations_total{kind=...}`` and are
kept on the monitor for the tier-1 teardown assert and ``/debug/health``.
The static half of this rail — the lexical blocking-call-under-lock lint
— lives in ``cook_tpu/analysis`` (docs/ANALYSIS.md).
"""

from __future__ import annotations

import os
import socket
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Set, Tuple

#: (lock name, operation) pairs that are BY DESIGN blocking while held —
#: each entry is a documented contract, not an oversight.  Consulted by
#: BOTH rails: the armed runtime detector below AND the static
#: interprocedural blocking pass (cook_tpu/analysis/summaries.py parses
#: this literal), so the two agree by construction:
#:   - ("store", "os.fsync"): the write-ahead journal fsync (and the
#:     checkpoint snapshot's fsatomic fsync) must complete before the
#:     transaction installs / the journal truncates — durability IS the
#:     reason the lock is held (state/store.py _journal_append,
#:     _write_audit_record_locked, checkpoint).  Group commit moves the
#:     steady-state fsync off the lock; the inline path remains correct.
#:   - ("store", "fsatomic.fsync"): the same contract through
#:     utils/fsatomic.py (checkpoint snapshot write, journal_gen bump
#:     after a truncation) — at runtime the armed detector sees these
#:     as their inner os.fsync (already allowed); this entry is the
#:     static pass's name for the same sites.
#:   - ("store", "time.sleep"): none expected; not allowlisted.
#:   - ("partition.summaries.refresh", "socket.connect"/"socket.sendall"):
#:     the UserSummaryExchange peer fetch (shard control socket,
#:     sched/shard.py PeerSummaryFeed; federation cell HTTP,
#:     federation/summary.py) runs INSIDE the serialized sweep by
#:     design — the refresh lock is what guarantees a stalled sweep can
#:     never install an older peer table over a newer one while
#:     stamping it fresh (state/partition.py).  The fetch is bounded by
#:     the carrier's own request timeout, and no other lock family
#:     ranks under this one.
ALLOWED_BLOCKING: Set[Tuple[str, str]] = {
    ("store", "os.fsync"),
    ("store", "fsatomic.fsync"),
    ("partition.summaries.refresh", "socket.connect"),
    ("partition.summaries.refresh", "socket.sendall"),
}

_MAX_VIOLATIONS = 256
_MAX_BLOCKING_EVENTS = 256


def family(name: str) -> str:
    """A lock's rank family: the declared base name with any bracketed
    per-instance suffix stripped (``store[p2]`` → ``store``).  Families
    share one rank; siblings within a family may not nest (module doc)."""
    return name.split("[", 1)[0]


class LockOrderError(RuntimeError):
    """Raised in strict mode when an acquisition would create a cycle in
    the acquisition graph or invert the declared rank order."""


class _Held(threading.local):
    def __init__(self):
        self.stack: List["NamedLock"] = []


class LockMonitor:
    """Acquisition-graph recorder shared by every named lock.

    The module singleton :data:`monitor` is what production code uses;
    tests that deliberately construct violations build their own
    instance so the tier-1 teardown assert on the global one stays
    meaningful."""

    def __init__(self, strict: bool = False):
        self._mu = threading.Lock()
        self.strict = strict
        self._held = _Held()
        # (src name, dst name) -> acquisition count
        self.edges: Dict[Tuple[str, str], int] = {}
        self.violations: List[Dict[str, Any]] = []
        self.blocking_events: List[Dict[str, Any]] = []
        self.allowed_blocking: Set[Tuple[str, str]] = set(ALLOWED_BLOCKING)
        self._armed = False
        self._originals: Dict[str, Any] = {}

    # ------------------------------------------------------------ held stack
    def held(self) -> List["NamedLock"]:
        """Named locks this thread currently holds, outermost first."""
        return list(self._held.stack)

    def _note_acquiring(self, lock: "NamedLock") -> bool:
        """Pre-acquire hook: record the edge BEFORE blocking so an actual
        deadlock attempt still lands in the graph.  Returns True when the
        acquisition is re-entrant (same lock object already held by this
        thread — no edge, RLock semantics)."""
        stack = self._held.stack
        if not stack:
            return False
        for h in stack:
            if h is lock:
                return True
        src = stack[-1]
        if src.name != lock.name:
            self._add_edge(src, lock)
        return False

    def _note_acquired(self, lock: "NamedLock") -> None:
        self._held.stack.append(lock)

    def _note_released(self, lock: "NamedLock") -> None:
        stack = self._held.stack
        # LIFO in `with`-discipline code; scan from the end for safety
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    # ------------------------------------------------------------ the graph
    def _add_edge(self, src: "NamedLock", dst: "NamedLock") -> None:
        key = (src.name, dst.name)
        # steady-state fast path, UNLOCKED: bumping an existing key
        # neither resizes the dict (snapshot's locked iteration stays
        # safe) nor needs exactness (counts are advisory), and this
        # runs on every nested acquisition of the hot paths — the
        # monitor mutex is reserved for the once-per-pair novel case
        n = self.edges.get(key)
        if n is not None:
            self.edges[key] = n + 1
            return
        with self._mu:
            if key in self.edges:
                self.edges[key] += 1
                return
            self.edges[key] = 1
        # novel edge: the expensive checks run at most once per pair
        cycle = self._find_cycle(dst.name, src.name)
        if cycle is not None:
            # _find_cycle already returns the closed loop
            # (src -> dst -> ... -> src)
            self._violation("cycle", src, dst,
                            f"acquisition cycle {' -> '.join(cycle)}")
        if (src.order is not None and dst.order is not None
                and dst.order < src.order):
            self._violation(
                "order", src, dst,
                f"'{dst.name}' (rank {dst.order}) acquired while holding "
                f"'{src.name}' (rank {src.order}) — violates the declared "
                "lock-order contract (utils/locks.py)")
        elif (src.order is not None and dst.order is not None
                and dst.order == src.order
                and family(src.name) == family(dst.name)):
            # SIBLING locks of one rank family (two partitions' store
            # locks) are unorderable by construction: same rank, and the
            # opposite nesting is equally "legal" — which is exactly the
            # ABBA deadlock shape.  The partitioned-facade contract is
            # strictly sequential fan-out (release p_i before acquiring
            # p_{i+1}); any sibling nesting is a violation.
            self._violation(
                "sibling", src, dst,
                f"'{dst.name}' acquired while holding sibling "
                f"'{src.name}' (rank family "
                f"'{family(src.name)}', rank {src.order}) — sibling "
                "locks of a rank family may never nest "
                "(utils/locks.py partitioned-store contract)")

    def _find_cycle(self, start: str,
                    target: str) -> Optional[List[str]]:
        """DFS: path start -> ... -> target through recorded edges, i.e.
        the back-path that makes the new target->start edge a cycle."""
        with self._mu:
            adj: Dict[str, List[str]] = {}
            for (a, b) in self.edges:
                adj.setdefault(a, []).append(b)
        path = [start]
        seen = {start}

        def dfs(node: str) -> Optional[List[str]]:
            if node == target:
                return list(path)
            for nxt in adj.get(node, ()):
                if nxt in seen:
                    continue
                seen.add(nxt)
                path.append(nxt)
                got = dfs(nxt)
                if got is not None:
                    return got
                path.pop()
            return None

        if start == target:
            return [start]
        got = dfs(start)
        if got is not None:
            # present as src -> dst -> ... -> src
            return [target] + got
        return None

    def _violation(self, kind: str, src: "NamedLock", dst: "NamedLock",
                   message: str) -> None:
        doc = {"kind": kind, "from": src.name, "to": dst.name,
               "message": message,
               "thread": threading.current_thread().name,
               "stack": "".join(traceback.format_stack(limit=8)[:-2])}
        with self._mu:
            if len(self.violations) < _MAX_VIOLATIONS:
                self.violations.append(doc)
        from .metrics import registry
        registry.counter_inc("cook_lock_violations", labels={"kind": kind})
        if self.strict:
            raise LockOrderError(message)

    # ------------------------------------------------- blocking-call sensor
    def note_blocking(self, op: str, detail: str = "") -> None:
        """A blocking operation is about to run on this thread: record a
        violation when any held named lock does not allowlist it.  Called
        by the armed patches below; explicit call sites may also use it
        for blocking operations the generic patches cannot see (native
        waits)."""
        stack = self._held.stack
        if not stack:
            return
        bad = [h.name for h in stack
               if (h.name, op) not in self.allowed_blocking
               and (family(h.name), op) not in self.allowed_blocking]
        if not bad:
            return
        key = (op, tuple(bad))
        doc = {"kind": "blocking", "op": op, "held": bad,
               "detail": detail,
               "thread": threading.current_thread().name,
               "stack": "".join(traceback.format_stack(limit=10)[:-3])}
        with self._mu:
            # dedup per (op, held-set): a hot site must not flood the ring
            for ev in self.blocking_events:
                if (ev["op"], tuple(ev["held"])) == key:
                    ev["count"] = ev.get("count", 1) + 1
                    return
            if len(self.blocking_events) < _MAX_BLOCKING_EVENTS:
                doc["count"] = 1
                self.blocking_events.append(doc)
        from .metrics import registry
        registry.counter_inc("cook_lock_violations",
                             labels={"kind": "blocking"})

    def arm_blocking_detector(self) -> None:
        """Patch the generic blocking entry points (os.fsync, time.sleep,
        socket connect/sendall) to consult :meth:`note_blocking`.  Armed
        by the tier-1 conftest; idempotent."""
        if self._armed:
            return
        self._armed = True
        mon = self
        self._originals = {
            "os.fsync": os.fsync,
            "time.sleep": time.sleep,
            "socket.connect": socket.socket.connect,
            "socket.sendall": socket.socket.sendall,
        }

        def fsync(fd, _orig=os.fsync):
            mon.note_blocking("os.fsync")
            return _orig(fd)

        def sleep(secs, _orig=time.sleep):
            # sleep(0) is a bare yield, not a blocking wait
            if secs:
                mon.note_blocking("time.sleep", detail=str(secs))
            return _orig(secs)

        def connect(sock, addr, _orig=socket.socket.connect):
            mon.note_blocking("socket.connect", detail=str(addr))
            return _orig(sock, addr)

        def sendall(sock, *args, _orig=socket.socket.sendall):
            mon.note_blocking("socket.sendall")
            return _orig(sock, *args)

        os.fsync = fsync
        time.sleep = sleep
        socket.socket.connect = connect
        socket.socket.sendall = sendall

    def disarm_blocking_detector(self) -> None:
        if not self._armed:
            return
        os.fsync = self._originals["os.fsync"]
        time.sleep = self._originals["time.sleep"]
        socket.socket.connect = self._originals["socket.connect"]
        socket.socket.sendall = self._originals["socket.sendall"]
        self._originals = {}
        self._armed = False

    # --------------------------------------------------------------- report
    def observed_edges(self) -> List[str]:
        """The FAMILY-normalized observed edge set
        (``["store.notify->store", ...]``): each entry says a lock of
        the first family was held while one of the second was acquired
        at least once this process.  This is the dynamic half of the
        static-vs-observed lock-coverage diff (``cs lint
        --lock-coverage``, ``/debug/health`` → ``locks``; the static
        half comes from cook_tpu/analysis) — family-normalized because
        the static analysis cannot tell ``store[p0]`` from
        ``store[p1]`` in an f-string, and the diff must compare like
        with like."""
        with self._mu:
            fams = {(family(a), family(b)) for (a, b) in self.edges}
        return sorted(f"{a}->{b}" for a, b in fams)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/health`` ``"locks"`` block: observed edge set +
        violation counters (full violation docs stay on the monitor; the
        health surface carries counts and the first few messages)."""
        with self._mu:
            edges = [{"from": a, "to": b, "count": n}
                     for (a, b), n in sorted(self.edges.items())]
            fams = {(family(a), family(b)) for (a, b) in self.edges}
            violations = list(self.violations)
            blocking = list(self.blocking_events)
        return {
            "armed": self._armed,
            "edges": edges,
            "observed_edges": sorted(f"{a}->{b}" for a, b in fams),
            "violations": len(violations),
            "blocking_events": sum(e.get("count", 1) for e in blocking),
            "problems": [v["message"] for v in violations[:5]]
            + [f"blocking {e['op']} while holding {e['held']}"
               for e in blocking[:5]],
        }

    def check(self) -> List[str]:
        """Human-readable list of every recorded violation (cycle/order
        inversions AND unallowlisted blocking events) — the tier-1
        teardown asserts this is empty."""
        with self._mu:
            out = [f"[{v['kind']}] {v['message']}\n{v['stack']}"
                   for v in self.violations]
            out += [f"[blocking] {e['op']} ({e.get('detail', '')}) while "
                    f"holding {e['held']} x{e.get('count', 1)}\n"
                    f"{e['stack']}" for e in self.blocking_events]
        return out

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.violations.clear()
            self.blocking_events.clear()


class NamedLock:
    """``threading.Lock`` with a name and an optional declared rank,
    reporting acquisitions to a :class:`LockMonitor` (see module doc for
    the rank table).  ``order=None`` opts out of the declared-order check
    (cycle detection still applies)."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str, order: Optional[int] = None,
                 monitor: Optional[LockMonitor] = None):
        self.name = name
        self.order = order
        self._monitor = monitor if monitor is not None else _monitor()
        self._lock = self._factory()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentrant = self._monitor._note_acquiring(self)
        ok = self._lock.acquire(blocking, timeout)
        if ok and not reentrant:
            self._monitor._note_acquired(self)
        return ok

    def release(self) -> None:
        self._lock.release()
        self._monitor._note_released(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.name!r}>"


class NamedRLock(NamedLock):
    """Re-entrant variant: nested acquisitions by the owning thread add
    no edges (the monitor tracks one held entry per outermost hold).
    Release tracking relies on ``with``-discipline (LIFO), which is how
    every adopter uses it."""

    _factory = staticmethod(threading.RLock)

    def release(self) -> None:
        self._lock.release()
        try:
            still_owned = self._lock._is_owned()
        except AttributeError:  # pragma: no cover - exotic RLock impl
            still_owned = False
        if not still_owned:
            # this release dropped the OUTERMOST hold: the held entry
            # (pushed once per outermost acquire) retires with it
            self._monitor._note_released(self)

    def locked(self) -> bool:  # RLock has no .locked() pre-3.12
        try:
            if self._lock._is_owned():
                # a bare try-acquire would succeed re-entrantly and
                # report "unlocked" to the very thread holding it
                return True
        except AttributeError:  # pragma: no cover - exotic RLock impl
            pass
        if self._lock.acquire(blocking=False):
            self._lock.release()
            return False
        return True


def _monitor() -> LockMonitor:
    return monitor


#: the process-wide monitor every production named lock reports to
monitor = LockMonitor()


# convenience factories carrying the declared ranks from the module doc
_DECLARED_ORDER = {
    "store.notify": 10,
    "read_replica": 15,
    "elastic": 18,
    "store": 20,
    "index": 30,
    "audit": 40,
    "repl.server": 50,
    "repl.follower": 55,
}


def named_lock(name: str, monitor: Optional[LockMonitor] = None
               ) -> NamedLock:
    """A :class:`NamedLock` with the rank declared in the module-doc
    contract table (None = unordered, cycle detection only).  A
    bracketed suffix (``store[p1]``) inherits its rank family's rank —
    and the sibling no-nesting rule that comes with it."""
    return NamedLock(name, order=_DECLARED_ORDER.get(family(name)),
                     monitor=monitor)


def named_rlock(name: str, monitor: Optional[LockMonitor] = None
                ) -> NamedRLock:
    return NamedRLock(name, order=_DECLARED_ORDER.get(family(name)),
                      monitor=monitor)
