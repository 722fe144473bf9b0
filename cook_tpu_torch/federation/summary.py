"""The port's copy of ``cook_tpu/federation/summary.py`` (imports
re-rooted): the staleness-bounded UserSummaryExchange, federated across
cells.

Global fair-share needs one answer per user — pending count, running
count, resource sums — that covers EVERY cell, without ever shipping
job state between cells (that would rebuild the single blast domain
federation exists to remove).  The intra-cell machinery already solved
this shape for partitions and then for shard processes
(:class:`cook_tpu_torch.state.partition.UserSummaryExchange`); this module
lifts it one level by plugging a per-cell HTTP fetch into the SAME
exchange as its ``peer_fetch`` carrier:

- each serving cell's bounded table rides
  ``GET /debug/federation/summary`` (a few floats per distinct user);
- a cell that answers contributes a fresh table (its reported age
  backdates the merge, exactly like a shard peer's table would);
- a cell that does NOT answer keeps contributing its LAST table with
  its true age — the merge's staleness then grows loudly toward the
  bound and enforcement raises
  :class:`~cook_tpu_torch.state.partition.SummaryStalenessError` instead of
  silently serving a view that no longer covers that cell's users;
- a DRAINED cell leaves the merge entirely (operator intent: its
  demand was finished or re-routed; a tombstone table would
  double-count every re-routed user forever) and re-converges on
  rejoin with one fresh fetch.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, List, Tuple

from ..state.partition import SummaryStalenessError, UserSummaryExchange
from ..utils.metrics import registry
from .cells import CellUnreachable

if TYPE_CHECKING:  # pragma: no cover
    from .cells import CellHandle

__all__ = ["FederatedUserSummaries", "SummaryStalenessError"]


class FederatedUserSummaries:
    """Per-user tables from every serving cell, merged under one
    asserted staleness bound."""

    def __init__(self, cells: Dict[str, "CellHandle"],
                 max_age_s: float = 5.0):
        self._cells = cells
        #: last successfully fetched table per cell:
        #: cell id -> (users_table, fetched_monotonic, reported_age_s)
        self._cache: Dict[str, Tuple[Dict[str, Dict[str, float]],
                                     float, float]] = {}
        self.fetch_errors = 0
        self._exchange = UserSummaryExchange(
            partitions=[], max_age_s=max_age_s,
            peer_fetch=self._fetch, assert_bound=True)

    @property
    def max_age_s(self) -> float:
        return self._exchange.max_age_s

    def _fetch(self) -> List[Tuple[Dict[str, Dict[str, float]], float]]:
        """The exchange's peer carrier: one (table, age) entry per
        serving cell — fresh when the cell answers, the aged cache when
        it does not, and an infinitely old placeholder for a serving
        cell never successfully read (its users are invisible, and the
        merge must say so rather than enforce around them)."""
        out: List[Tuple[Dict[str, Dict[str, float]], float]] = []
        for cell_id, handle in self._cells.items():
            if not handle.serving():
                continue
            try:
                doc = handle.get_json("/debug/federation/summary")
                table = dict(doc.get("users") or {})
                age = max(float(doc.get("age_s") or 0.0), 0.0)
                self._cache[cell_id] = (table, time.monotonic(), age)
                out.append((table, age))
            except (CellUnreachable, ValueError, TypeError):
                self.fetch_errors += 1
                cached = self._cache.get(cell_id)
                if cached is None:
                    out.append(({}, float("inf")))
                else:
                    table, at, age = cached
                    out.append((table, age + (time.monotonic() - at)))
        registry.gauge_set("cook_federation_summary_staleness_seconds",
                           min(self.staleness_s(), 1e12))
        return out

    def forget(self, cell_id: str) -> None:
        """Drop a drained cell's cached table so a later rejoin starts
        from a fresh fetch, not a resurrected corpse."""
        self._cache.pop(cell_id, None)

    # -------------------------------------------------- exchange surface
    def refresh(self) -> None:
        self._exchange.refresh()

    def staleness_s(self) -> float:
        return self._exchange.staleness_s()

    def merged(self) -> Dict[str, Dict[str, float]]:
        return self._exchange.merged()

    def user_totals(self, user: str) -> Dict[str, float]:
        return self._exchange.user_totals(user)

    def stats(self) -> Dict[str, object]:
        stats = self._exchange.stats()
        stats["fetch_errors"] = self.fetch_errors
        stats["cells_cached"] = len(self._cache)
        return stats
