"""The port's copy of ``cook_tpu/utils/retry.py`` (imports re-rooted).

Shared retry/backoff and per-compute-cluster circuit breaking.

One definition of "back off with full jitter" for every reconnect loop in
the tree (the k8s watch streams, the remote-agent transport, the REST
client), replacing the hand-rolled ``min(max(backoff*2, ...), cap)``
inline loops.  Full jitter — ``uniform(0, min(cap, base * 2**attempt))``
— is deliberate: a cluster-wide apiserver restart otherwise synchronizes
every scheduler's watch reconnects into a thundering herd (the classic
AWS-architecture-blog result; the reference leans on okhttp's own
backoff, api.clj:372-475).

:class:`CircuitBreaker` is the degradation half: consecutive backend
failures open the breaker, an open breaker makes the matcher route
launches to healthy clusters (``Scheduler.launchable_clusters``), and a
half-open probe after ``reset_timeout_s`` discovers recovery.  Breakers
live in the module-level :data:`breakers` registry keyed by compute
cluster name so backends, matcher, REST, and the CLI all observe one
truth; state is exported as ``cook_circuit_breaker_state`` (0 closed,
1 half-open, 2 open) on /metrics and via ``cs debug faults``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from .metrics import registry

STATE_CLOSED = "closed"
STATE_HALF_OPEN = "half-open"
STATE_OPEN = "open"

_STATE_GAUGE = {STATE_CLOSED: 0.0, STATE_HALF_OPEN: 1.0, STATE_OPEN: 2.0}


@dataclass
class RetryPolicy:
    """Jittered-exponential retry knobs (shared by :func:`retry_call` and
    :class:`Backoff`)."""

    max_attempts: int = 5
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0


class Backoff:
    """Stateful full-jitter exponential backoff for reconnect loops.

    ``next_delay()`` returns the next sleep; ``reset()`` on a healthy
    connection restarts the ladder.  A seeded ``rng`` makes tests
    deterministic; the default draws from the module RNG so independent
    reconnectors desynchronize (the whole point of the jitter).
    """

    def __init__(self, base_s: float = 0.1, cap_s: float = 5.0,
                 rng: Optional[random.Random] = None):
        self.base_s = base_s
        self.cap_s = cap_s
        self._rng = rng or random
        self.attempts = 0

    def next_delay(self) -> float:
        ceiling = min(self.cap_s, self.base_s * (2.0 ** self.attempts))
        self.attempts += 1
        return self._rng.uniform(0.0, ceiling)

    def reset(self) -> None:
        self.attempts = 0


def retry_call(fn: Callable, *, policy: Optional[RetryPolicy] = None,
               retry_on: Tuple[type, ...] = (Exception,),
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               on_retry: Optional[Callable[[int, BaseException], None]]
               = None):
    """Call ``fn`` with jittered-exponential retries on ``retry_on``
    exceptions.  The last failure propagates once ``max_attempts`` is
    exhausted — callers own the terminal handling, this owns the pacing."""
    policy = policy or RetryPolicy()
    backoff = Backoff(policy.base_delay_s, policy.max_delay_s, rng=rng)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempt >= policy.max_attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(backoff.next_delay())


class CircuitBreaker:
    """Per-backend failure gate: closed -> open after
    ``failure_threshold`` consecutive failures; open -> half-open after
    ``reset_timeout_s``.  Half-open admits traffic until an outcome is
    recorded (the matcher consults once per pool per cycle, so the probe
    granularity is one cycle's launches): the first half-open success
    closes, the first failure reopens and restarts the heal timer.

    ``clock`` is injectable so the chaos simulator runs breakers in
    virtual time (a breaker that only heals in wall time would deadlock
    a faster-than-real-time run)."""

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._publish(STATE_CLOSED)

    def _publish(self, state: str) -> None:
        registry.gauge_set("cook_circuit_breaker_state",
                           _STATE_GAUGE[state], {"cluster": self.name})

    def _set_state(self, state: str) -> None:
        if state != self._state:
            self._state = state
            self._publish(state)
            registry.counter_inc("cook_circuit_breaker_transitions",
                                 labels={"cluster": self.name, "to": state})

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if self._state == STATE_OPEN and \
                self.clock() - self._opened_at >= self.reset_timeout_s:
            self._set_state(STATE_HALF_OPEN)

    def allow(self) -> bool:
        """May a launch be routed at this backend right now?  Open says
        no; half-open says yes (the probe that discovers recovery)."""
        with self._lock:
            self._maybe_half_open()
            return self._state != STATE_OPEN

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state != STATE_CLOSED:
                self._set_state(STATE_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == STATE_HALF_OPEN:
                # the probe failed: back to open, restart the heal timer
                self._opened_at = self.clock()
                self._set_state(STATE_OPEN)
                return
            self._failures += 1
            if self._state == STATE_CLOSED and \
                    self._failures >= self.failure_threshold:
                self._opened_at = self.clock()
                self._set_state(STATE_OPEN)

    def trip(self) -> None:
        """Force open (operator/chaos hook)."""
        with self._lock:
            self._opened_at = self.clock()
            self._set_state(STATE_OPEN)

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._set_state(STATE_CLOSED)

    def to_doc(self) -> Dict:
        with self._lock:
            self._maybe_half_open()
            return {"state": self._state,
                    "consecutive_failures": self._failures,
                    "failure_threshold": self.failure_threshold,
                    "reset_timeout_s": self.reset_timeout_s}


class BreakerRegistry:
    """Process-wide breakers keyed by compute-cluster name.  A module
    singleton (like the metrics registry) so the backend that records
    failures and the matcher that routes around them need no plumbing;
    ``configure`` sets the defaults new breakers are minted with, and
    ``clock`` retargets every breaker's timebase (chaos/virtual time)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self.failure_threshold = 5
        self.reset_timeout_s = 30.0
        self.clock: Callable[[], float] = time.monotonic

    def configure(self, failure_threshold: Optional[int] = None,
                  reset_timeout_s: Optional[float] = None,
                  clock: Optional[Callable[[], float]] = None) -> None:
        with self._lock:
            if failure_threshold is not None:
                self.failure_threshold = failure_threshold
            if reset_timeout_s is not None:
                self.reset_timeout_s = reset_timeout_s
            if clock is not None:
                self.clock = clock
            for b in self._breakers.values():
                if failure_threshold is not None:
                    b.failure_threshold = failure_threshold
                if reset_timeout_s is not None:
                    b.reset_timeout_s = reset_timeout_s
                if clock is not None:
                    b.clock = clock

    def get(self, name: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(name)
            if b is None:
                b = CircuitBreaker(
                    name, failure_threshold=self.failure_threshold,
                    reset_timeout_s=self.reset_timeout_s, clock=self.clock)
                self._breakers[name] = b
            return b

    def states(self) -> Dict[str, Dict]:
        with self._lock:
            items = list(self._breakers.items())
        return {name: b.to_doc() for name, b in items}

    def reset(self) -> None:
        """Drop every breaker (tests/chaos setup)."""
        with self._lock:
            self._breakers.clear()
            self.failure_threshold = 5
            self.reset_timeout_s = 30.0
            self.clock = time.monotonic


breakers = BreakerRegistry()
