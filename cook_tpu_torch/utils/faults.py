"""The port's copy of ``cook_tpu/utils/faults.py`` (imports re-rooted).

Deterministic fault injection at named points in the hot paths.

The chaos-engineering layer (Basiri et al., IEEE Software 2016) for the
failure paths the survey says must stay *proven*, not assumed: store
commit/fsync, the replication stream, remote-cluster RPC and agent
heartbeat delivery, the k8s watch stream, kernel dispatch, and the
leader lease.  Each such site calls :meth:`FaultInjector.fire` (raise on
trigger) or :meth:`should_fire` (boolean branch) with its point name; a
disarmed injector reduces to one dict lookup, so production pays nothing.

Fault points are armed by name with either a probability (seeded RNG —
the same seed replays the same fault sequence) or an explicit schedule
of call indices (exact, for tests: "fail the 3rd journal append").
Every trigger increments ``cook_faults_injected_total{point=...}`` and
lands on the owning CycleRecord's ``faults`` map, so a degraded cycle
explains itself in ``/debug/cycles``.

Registered point names (the sites that consult this module):

==========================  ====================================================
``store.journal.append``    `state/store.py` — journal write fails (disk error)
``store.journal.fsync``     `state/store.py` — fsync fails after the write
``repl.stream``             `state/store.py` — stream down BEFORE the record
                            was written (clean abort)
``repl.ack``                `state/store.py` — follower ack never arrives
                            AFTER the record is durable locally
                            (indeterminate outcome)
``remote.rpc``              `cluster/remote.py` — agent launch RPC fails
``agent.heartbeat``         `sched/scheduler.py` — a heartbeat frame is dropped
``k8s.watch.disconnect``    `cluster/k8s/real_api.py` — watch stream drops
``k8s.watch.gone``          `cluster/k8s/real_api.py` — 410 Gone (watch gap)
``kernel.dispatch``         `sched/matcher.py` — XLA kernel dispatch raises
``fused.dispatch``          `sched/fused.py` — whole fused cycle dispatch raises
``leader.lease``            `sched/election.py` — lease acquire/renew fails
``cluster.launch``          `cluster/fake.py` — backend rejects a launch
``store.journal.torn_write``  `state/store.py` — a PREFIX of the frame lands
                            then the write fails (``arg`` = cut byte offset);
                            exercises the torn-tail excision discipline
``store.journal.bitflip``   `state/store.py` — one bit flips in the
                            just-written frame (``arg`` = byte offset), with
                            NO error surfaced: silent media corruption for
                            the CRC scrub/replay to catch
``store.journal.fsync_lie`` `state/store.py` — fsync reports EIO while the
                            page cache silently drops the dirty frame and
                            the next fsync succeeds (the ATC'20
                            "succeeds-after-failure" lie)
``store.journal.enospc``    `state/store.py` — ENOSPC on append: a clean
                            abort surfaced as StorageFullError (503 +
                            admission write-shed, never a dead daemon)
``fsatomic.fsync``          `utils/fsatomic.py` — fsync of an atomic-write
                            temp fails (checkpoint/fence publish aborts;
                            the orphaned temp is the hygiene sweep's prey)
==========================  ====================================================
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Dict, List, Optional

from .metrics import registry


class FaultInjected(RuntimeError):
    """Raised by :meth:`FaultInjector.fire` when a point triggers."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point}")
        self.point = point


class _Point:
    __slots__ = ("name", "probability", "schedule", "max_fires",
                 "calls", "fires", "arg")

    def __init__(self, name: str, probability: float = 0.0,
                 schedule: Optional[List[int]] = None,
                 max_fires: Optional[int] = None,
                 arg: Optional[Any] = None):
        self.name = name
        self.probability = float(probability)
        # explicit call indices (0-based) that fire, e.g. [2] = third call
        self.schedule = set(schedule or [])
        self.max_fires = max_fires
        self.calls = 0
        self.fires = 0
        # site-interpreted parameter (e.g. the byte offset a torn write
        # cuts at, or the byte a bitflip targets) — what lets the
        # crash-point harness sweep every record byte boundary
        self.arg = arg

    def to_doc(self) -> Dict[str, Any]:
        return {"probability": self.probability,
                "schedule": sorted(self.schedule),
                "max_fires": self.max_fires,
                "calls": self.calls, "fires": self.fires,
                **({"arg": self.arg} if self.arg is not None else {})}


class FaultInjector:
    """Seeded, thread-safe fault-point registry.  Disabled points cost
    one dict miss per consultation; the module singleton :data:`injector`
    is what the call sites import."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._points: Dict[str, _Point] = {}
        self._seed = seed

    # -------------------------------------------------------------- arming
    def reseed(self, seed: int) -> None:
        with self._lock:
            self._seed = seed
            self._rng = random.Random(seed)

    def arm(self, point: str, probability: float = 0.0,
            schedule: Optional[List[int]] = None,
            max_fires: Optional[int] = None,
            arg: Optional[Any] = None) -> None:
        with self._lock:
            self._points[point] = _Point(point, probability, schedule,
                                         max_fires, arg)

    def disarm(self, point: str) -> None:
        with self._lock:
            self._points.pop(point, None)

    def clear(self) -> None:
        with self._lock:
            self._points.clear()

    def configure(self, spec: Dict[str, Any]) -> None:
        """Arm from a config document:
        ``{"seed": 7, "points": {"remote.rpc": {"probability": 0.05},
        "store.journal.append": {"schedule": [3], "max_fires": 1}}}``.
        This is the shape `config.FaultInjectionConfig` and the daemon's
        ``"faults"`` conf section carry."""
        if "seed" in spec:
            self.reseed(int(spec["seed"]))
        for name, knobs in (spec.get("points") or {}).items():
            self.arm(name,
                     probability=float(knobs.get("probability", 0.0)),
                     schedule=list(knobs.get("schedule", [])),
                     max_fires=knobs.get("max_fires"),
                     arg=knobs.get("arg"))

    # ------------------------------------------------------------- firing
    def should_fire(self, point: str) -> bool:
        """True when the armed point triggers on this call.  Counts the
        call either way (schedules index by consultation order)."""
        with self._lock:
            p = self._points.get(point)
            if p is None:
                return False
            idx = p.calls
            p.calls += 1
            if p.max_fires is not None and p.fires >= p.max_fires:
                return False
            hit = idx in p.schedule or (
                p.probability > 0.0 and self._rng.random() < p.probability)
            if hit:
                p.fires += 1
        if hit:
            registry.counter_inc("cook_faults_injected",
                                 labels={"point": point})
            # a degraded cycle explains itself on its own CycleRecord
            from .flight import recorder
            recorder.note_fault(point)
        return hit

    def fire(self, point: str,
             exc_factory: Optional[Callable[[], BaseException]]
             = None) -> None:
        """Raise (``FaultInjected`` by default) when the point triggers."""
        if self.should_fire(point):
            raise (exc_factory() if exc_factory is not None
                   else FaultInjected(point))

    def point_arg(self, point: str) -> Optional[Any]:
        """The armed point's site-interpreted parameter (byte offsets
        for the disk-fault sites), or None when unarmed/unset."""
        with self._lock:
            p = self._points.get(point)
            return p.arg if p is not None else None

    # -------------------------------------------------------------- query
    def active(self) -> Dict[str, Dict[str, Any]]:
        """Armed points and their counters, for ``GET /debug/faults`` and
        ``cs debug faults``."""
        with self._lock:
            return {name: p.to_doc() for name, p in self._points.items()}

    @property
    def seed(self) -> int:
        return self._seed


injector = FaultInjector()
