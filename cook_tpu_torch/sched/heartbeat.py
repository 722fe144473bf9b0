"""The port's copy of ``cook_tpu/sched/heartbeat.py``.

Executor heartbeat timeout tracker.

Mirrors the reference's heartbeat monitor (reference:
scheduler/src/cook/mesos/heartbeat.clj:66-147): executors/agents send
periodic liveness signals per task; a task silent for longer than the
timeout is presumed wedged (executor crashed but the node still reports it
running) and is killed with HEARTBEAT_LOST, which is mea-culpa — the
failure is the cluster's fault, so the user's retry budget is untouched
(reference: reason table mesos/reason.clj).

The reference tracks per-task timer channels; here a single dict of
last-beat timestamps swept on the reaper cadence is equivalent and
single-writer friendly.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class HeartbeatTracker:
    """Last-heartbeat bookkeeping with a sweep that returns expired tasks."""

    def __init__(self, timeout_ms: int = 60_000):
        self.timeout_ms = timeout_ms
        self._last: Dict[str, int] = {}
        self._lock = threading.Lock()

    def beat(self, task_id: str, now: int) -> None:
        """Record a liveness signal (progress frame, status update, or an
        explicit heartbeat message all count, matching the reference's
        'any framework message resets the timer' behavior).

        Only refreshes tasks already under watch: a stale signal arriving
        after the terminal status forgot the task must not re-track it
        (leak + spurious kill); ``watch`` is the sole insert point."""
        with self._lock:
            if task_id in self._last:
                self._last[task_id] = now

    def watch(self, task_id: str, now: int) -> None:
        """Start tracking a task at launch; the launch itself is the first
        beat so a slow-starting executor gets the full timeout."""
        with self._lock:
            self._last[task_id] = now

    def forget(self, task_id: str) -> None:
        with self._lock:
            self._last.pop(task_id, None)

    def last_beat(self, task_id: str) -> Optional[int]:
        with self._lock:
            return self._last.get(task_id)

    def expired(self, now: int) -> List[str]:
        """Task ids silent beyond the timeout. Does not forget them; the
        caller kills and the terminal status update cleans up."""
        with self._lock:
            return [t for t, ts in self._last.items()
                    if now - ts > self.timeout_ms]

    def tracked_count(self) -> int:
        with self._lock:
            return len(self._last)
