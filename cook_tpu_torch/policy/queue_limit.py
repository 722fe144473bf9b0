"""The port's copy of ``cook_tpu/policy/queue_limit.py`` (imports re-rooted).

Pending-queue length limits enforced at submission.

Mirrors the reference's queue limits (reference:
scheduler/src/cook/queue_limit.clj:56-188): per-pool and per-pool-per-user
caps on the number of pending (waiting) jobs; a submission that would exceed
either cap is rejected before anything is transacted.  Counts are maintained
incrementally from the store's tx feed plus a periodic full re-query (the
reference updates on submit/kill and re-queries on an interval).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..state.schema import JobState
from ..state.store import Store


class QueueLimits:
    def __init__(self, store: Store,
                 per_pool_limit: int = 1_000_000,
                 per_user_limit: int = 1_000_000,
                 user_overrides: Optional[Dict[str, int]] = None):
        self.store = store
        self.per_pool_limit = per_pool_limit
        self.per_user_limit = per_user_limit
        self.user_overrides = dict(user_overrides or {})
        self._lock = threading.Lock()
        self._pool_counts: Dict[str, int] = {}
        self._pool_user_counts: Dict[str, Dict[str, int]] = {}
        self.refresh()
        store.subscribe(self._on_events)

    # ----------------------------------------------------------- accounting
    def refresh(self) -> None:
        """Full re-query (reference: query-queue-lengths)."""
        pools: Dict[str, int] = {}
        pool_users: Dict[str, Dict[str, int]] = {}
        for job in self.store.jobs_where(
                lambda j: j.state is JobState.WAITING):
            pools[job.pool] = pools.get(job.pool, 0) + 1
            users = pool_users.setdefault(job.pool, {})
            users[job.user] = users.get(job.user, 0) + 1
        with self._lock:
            self._pool_counts = pools
            self._pool_user_counts = pool_users

    def _on_events(self, tx_id: int, events) -> None:
        for e in events:
            if e.kind == "job-created":
                self._bump(e.data["pool"], e.data["user"], +1)
            elif e.kind == "job-state":
                job = self.store.job(e.data["uuid"])
                if job is None:
                    continue
                if e.data.get("new") == "waiting":
                    self._bump(job.pool, job.user, +1)
                elif e.data.get("old") == "waiting":
                    self._bump(job.pool, job.user, -1)

    def _bump(self, pool: str, user: str, delta: int) -> None:
        with self._lock:
            self._pool_counts[pool] = max(
                0, self._pool_counts.get(pool, 0) + delta)
            users = self._pool_user_counts.setdefault(pool, {})
            users[user] = max(0, users.get(user, 0) + delta)

    # ------------------------------------------------------------ interface
    def user_limit(self, user: str) -> int:
        return self.user_overrides.get(user, self.per_user_limit)

    def check_submission(self, pool: str, user: str,
                         n_jobs: int) -> Optional[str]:
        """None when allowed; else a rejection message."""
        with self._lock:
            pool_count = self._pool_counts.get(pool, 0)
            user_count = self._pool_user_counts.get(pool, {}).get(user, 0)
        if pool_count + n_jobs > self.per_pool_limit:
            return (f"queue limit exceeded for pool {pool}: "
                    f"{pool_count} pending, limit {self.per_pool_limit}")
        if user_count + n_jobs > self.user_limit(user):
            return (f"queue limit exceeded for user {user} in pool {pool}: "
                    f"{user_count} pending, limit {self.user_limit(user)}")
        return None

    def counts(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                "pools": dict(self._pool_counts),
                "users": {p: dict(u) for p, u in self._pool_user_counts.items()},
            }
