"""The port's copy of ``cook_tpu/federation/router.py`` (imports
re-rooted): the federation routing brain.

Two things differ from the JAX package, both in the goodput route mode
and both stated where they live (:meth:`FederationRouter._goodput_scores`):

* the replays run on the router's device (``FederationRouter(config,
  device=...)``, resolved at construction only when ``route_mode`` is
  ``"goodput"``, where a missing card raises): the JAX package replays
  on ``Simulator(..., backend="cpu")``, whose matcher is the numpy
  greedy golden; here the replay's matcher is pinned to ``tpu-greedy``,
  so ``step_match`` places through kernel K5 on the device.  K5
  computes the golden's assignment bit for bit, so the goodput scores,
  and the cell picked, are the JAX package's; the replay's ranker stays
  the numpy ``cpu`` backend, as there.  In the ``"load"`` mode the
  router touches no device and boots anywhere;
* the JAX package skips a candidate whose replay raises anything
  (``except Exception``), which would score a failed K5 launch 0 and
  route around the card in silence.  Here only what the JAX package
  meets without a card is skipped: an unreachable cell and a malformed
  inventory (``ValueError``, ``KeyError``, ``TypeError`` from
  ``load_hosts``).  A replay that fails on the device raises out of
  :meth:`FederationRouter.pick_cell`.

Everything the front door decides happens here, behind a plain method
surface the REST shim (federation/rest.py) and the chaos simulator
call directly:

- **whole-batch routing** — one submission batch (and therefore one
  gang: a gang's jobs always ride one atomic batch) lands on exactly
  one cell, chosen by locality attributes, capacity tier, per-cell
  load and the cell's own saturation/brownout signals.  The
  owning-cluster rule, generalized: demand that must stay together
  routes together or not at all.
- **breaker-per-cell reroute** — a cell that stops answering trips its
  breaker after ``breaker_failures`` consecutive transport failures;
  from then on its traffic reroutes WHOLE to surviving cells (no
  per-request dribble into a dead socket, no cascade: the surviving
  cells' breakers never see the dead cell's failures).
- **global fair-share** — the per-user pending cap and dominant-share
  ceiling are enforced HERE, against the federated summary merge, so
  a user cannot escape their cap by spraying cells; refusals quote the
  staleness window and the merge raises rather than silently serving a
  view that no longer covers an unreachable cell.
- **the commit ledger** — a bounded record of every batch a cell
  ACCEPTED (positively acknowledged; never in-flight guesses), which
  is exactly the set "zero lost committed submissions" quantifies
  over: on full-cell outage or spot reclaim, every ledgered batch of
  the dead cell re-submits whole to a surviving cell, mea-culpa
  (Reasons.CELL_RECLAIMED — free retries, the platform's fault).
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import resolve_device
from ..config import FederationConfig
from ..state.partition import SummaryStalenessError
from ..state.schema import Reasons
from ..utils import tracing
from ..utils.metrics import registry
from .cells import CellHandle, CellSpec, CellUnreachable
from .summary import FederatedUserSummaries

#: label key (under the configured prefix) that pins a batch to a cell
#: id instead of matching attributes
PIN_KEY = "cell"


class RouteRejected(Exception):
    """An admission refusal minted by the ROUTER itself (global caps,
    no eligible cell): carries the HTTP shape the front door answers
    with, mirroring rest.api.ApiError."""

    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None,
                 extra: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}
        self.extra = extra or {}


class FederationRouter:
    """Routing + global enforcement + the commit ledger for one front
    door.  Stateless in the durability sense: every decision input is
    re-fetchable from the cells, and the ledger only accelerates
    re-route/read-routing — losing the router loses no committed work
    (the cells hold it)."""

    def __init__(self, config: FederationConfig, device="cuda"):
        self.config = config
        #: the goodput replays' torch device; the load mode touches none
        self.device = (resolve_device(device)
                       if config.route_mode == "goodput" else None)
        self.cells: "OrderedDict[str, CellHandle]" = OrderedDict()
        for entry in config.cells:
            spec = CellSpec(
                id=str(entry["id"]), url=str(entry["url"]),
                tier=str(entry.get("tier", "standard")),
                attributes=dict(entry.get("attributes") or {}),
                weight=float(entry.get("weight", 1.0)))
            self.cells[spec.id] = CellHandle(
                spec, failure_threshold=config.breaker_failures,
                reset_timeout_s=config.breaker_reset_seconds,
                request_timeout_s=config.request_timeout_seconds)
        self.summaries = FederatedUserSummaries(
            self.cells, max_age_s=config.summary_max_age_seconds)
        self._mu = threading.Lock()
        #: batch key (first job uuid) -> ledger entry; insertion-ordered
        #: so eviction drops the oldest accepted batch first
        self._ledger: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._uuid_to_batch: Dict[str, str] = {}
        self.ledger_evicted = 0
        #: recent routed batches' job shapes for goodput-mode replay
        self._recent: "deque[Dict[str, Any]]" = deque(
            maxlen=max(int(config.goodput_window), 1))
        self.rejections = 0
        self.rerouted_jobs = 0
        self.rerouted_batches = 0
        registry.gauge_set("cook_federation_cells", float(len(self.cells)))

    # ------------------------------------------------------------ surface
    @property
    def single_cell(self) -> bool:
        """One configured cell ⇒ the front door is a pure reverse
        proxy: no token qualification, no global enforcement beyond
        what the cell itself does — decision- and wire-identical to
        talking to the cell directly."""
        return len(self.cells) == 1

    def cell(self, cell_id: str) -> Optional[CellHandle]:
        return self.cells.get(cell_id)

    def eligible_cells(self) -> List[CellHandle]:
        return [h for h in self.cells.values() if h.eligible()]

    # ------------------------------------------------------- batch parsing
    @staticmethod
    def _batch_uuids(body: Dict[str, Any]) -> List[str]:
        return [str(s["uuid"]) for s in body.get("jobs", [])
                if isinstance(s, dict) and s.get("uuid")]

    @staticmethod
    def _is_gang(body: Dict[str, Any]) -> bool:
        if body.get("groups"):
            return True
        return any(isinstance(s, dict) and s.get("group")
                   for s in body.get("jobs", []))

    def _locality_demands(self, body: Dict[str, Any]) -> Dict[str, str]:
        """The union of every job's locality labels — a batch is one
        placement unit, so its demands combine (conflicting demands
        simply match no cell, which is the honest answer)."""
        prefix = self.config.locality_label_prefix
        demands: Dict[str, str] = {}
        for spec in body.get("jobs", []):
            labels = spec.get("labels") if isinstance(spec, dict) else None
            if not isinstance(labels, dict):
                continue
            for k, v in labels.items():
                if isinstance(k, str) and k.startswith(prefix):
                    demands[k[len(prefix):]] = str(v)
        return demands

    # --------------------------------------------------- global fair-share
    def _check_global_caps(self, body: Dict[str, Any], user: str) -> None:
        """The front door's global per-user enforcement.  Single-cell
        routers skip it entirely (parity: the cell's own admission is
        the only admission), as do deployments with both caps off."""
        cfg = self.config
        if self.single_cell or \
                (cfg.max_user_pending <= 0
                 and cfg.max_user_dominant_share <= 0.0):
            return
        n_jobs = len(body.get("jobs", []))
        try:
            totals = self.summaries.user_totals(user)
        except SummaryStalenessError as exc:
            # the global view cannot be brought under its bound (a
            # serving cell is unreachable): enforcement must not guess.
            # 503 + Retry-After, never a silently-unenforced admit and
            # never a refusal quoting a window we don't actually have.
            self.rejections += 1
            registry.counter_inc("cook_federation_rejections", 1.0,
                                 {"scope": "user", "reason": "stale"})
            raise RouteRejected(
                503, f"global fair-share view unavailable: {exc}",
                headers={"Retry-After": "1"},
                extra={"reason": "summary-stale"})
        if cfg.max_user_pending > 0 and \
                totals["pending"] + n_jobs > cfg.max_user_pending:
            self.rejections += 1
            registry.counter_inc("cook_federation_rejections", 1.0,
                                 {"scope": "user", "reason": "pending-cap"})
            raise RouteRejected(
                429, f"user {user} would exceed the global pending cap "
                     f"({int(totals['pending'])} pending across "
                     f"{len(self.cells)} cells + {n_jobs} submitted > "
                     f"{cfg.max_user_pending}; view "
                     f"{self.summaries.staleness_s():.3f}s stale, bound "
                     f"{self.summaries.max_age_s}s)",
                headers={"Retry-After": "5"},
                extra={"reason": "global-pending-cap"})
        if cfg.max_user_dominant_share > 0.0:
            share = self._dominant_share(user, totals)
            if share > cfg.max_user_dominant_share:
                self.rejections += 1
                registry.counter_inc(
                    "cook_federation_rejections", 1.0,
                    {"scope": "user", "reason": "dominant-share"})
                raise RouteRejected(
                    429, f"user {user} holds {share:.3f} dominant share "
                         f"of the federation's running usage (cap "
                         f"{cfg.max_user_dominant_share}); view "
                         f"{self.summaries.staleness_s():.3f}s stale, "
                         f"bound {self.summaries.max_age_s}s",
                    headers={"Retry-After": "15"},
                    extra={"reason": "global-dominant-share"})

    def _dominant_share(self, user: str,
                        totals: Dict[str, float]) -> float:
        """The user's dominant resource share of the FEDERATION's
        running usage — DRU's defining ratio, computed on the merged
        summaries (usage over usage: capacity totals never cross the
        cell boundary, so the denominator is what is actually in use,
        which is the conservative choice under contention — exactly
        when the cap matters)."""
        merged = self.summaries.merged()
        fleet = {"cpus": 0.0, "mem": 0.0, "gpus": 0.0}
        for u in merged.values():
            for k in fleet:
                fleet[k] += u.get(k, 0.0)
        share = 0.0
        for k, total in fleet.items():
            if total > 0:
                share = max(share, totals.get(k, 0.0) / total)
        return share

    # ------------------------------------------------------------- scoring
    def _candidates(self, demands: Dict[str, str],
                    exclude: Set[str]) -> List[CellHandle]:
        pinned = demands.get(PIN_KEY)
        out = []
        for h in self.cells.values():
            if h.spec.id in exclude or not h.eligible():
                continue
            if pinned is not None and h.spec.id != pinned:
                continue
            if any(h.spec.attributes.get(k) != v
                   for k, v in demands.items() if k != PIN_KEY):
                continue
            out.append(h)
        return out

    def _score(self, h: CellHandle) -> float:
        s = h.spec.weight * (1.0 - min(h.saturation(), 1.0)) \
            / (1.0 + h.inflight + 0.01 * h.routed_total)
        if h.spec.tier == "spot":
            s *= self.config.spot_penalty
        return s

    def _goodput_scores(self,
                        cands: List[CellHandle]) -> Dict[str, float]:
        """Goodput route mode: replay this router's recent routed job
        shapes through ``sim/`` against each candidate cell's last
        advertised host inventory (the optimizer's replay, one level
        up).  Cells that never advertised hosts score 0 additions —
        the load score alone decides.  Each replay matches through K5
        on the router's device (``tpu-greedy``), and only an unreachable
        cell or a malformed inventory is skipped: a replay that fails on
        the device raises."""
        recent = list(self._recent)
        if not recent:
            return {}
        from ..config import Config
        from ..sim.simulator import Simulator, load_hosts
        from ..state.schema import Job, Resources
        scores: Dict[str, float] = {}
        for h in cands:
            hosts = (h._health.get("federation_hosts")
                     if isinstance(h._health, dict) else None)
            if not hosts:
                try:
                    doc = h.get_json("/debug/federation/summary")
                    hosts = doc.get("hosts") or []
                    if isinstance(h._health, dict):
                        h._health["federation_hosts"] = hosts
                except (CellUnreachable, ValueError):
                    continue
            if not hosts:
                continue
            jobs = [Job(uuid=f"replay-{i}", user=e["user"],
                        command="replay",
                        resources=Resources(cpus=e["cpus"], mem=e["mem"],
                                            gpus=e["gpus"]),
                        submit_time_ms=0,
                        labels={"sim/duration_ms": "1000"})
                    for i, e in enumerate(recent)]
            try:
                inventory = load_hosts(hosts)
            except (ValueError, KeyError, TypeError):
                continue
            cfg = Config()
            sim = Simulator(jobs, inventory, config=cfg, backend="cpu",
                            device=self.device)
            # the cpu backend set the numpy golden; K5 is the same greedy
            cfg.default_matcher.backend = "tpu-greedy"
            with registry.suppressed():
                res = sim.run(max_virtual_ms=30_000)
            scores[h.spec.id] = float(
                res.goodput.get("goodput", res.completed))
        return scores

    def pick_cell(self, body: Dict[str, Any],
                  exclude: Optional[Set[str]] = None) -> CellHandle:
        demands = self._locality_demands(body)
        cands = self._candidates(demands, exclude or set())
        if not cands:
            self.rejections += 1
            registry.counter_inc("cook_federation_rejections", 1.0,
                                 {"scope": "batch", "reason": "no-cell"})
            raise RouteRejected(
                503, "no eligible cell for this batch "
                     f"(locality demands {demands or '{}'}; "
                     f"{len(self.cells)} cells configured)",
                headers={"Retry-After": "2"},
                extra={"reason": "no-eligible-cell"})
        if len(cands) == 1:
            return cands[0]
        goodput = (self._goodput_scores(cands)
                   if self.config.route_mode == "goodput" else {})
        return max(cands,
                   key=lambda h: (self._score(h)
                                  * (1.0 + goodput.get(h.spec.id, 0.0)),
                                  h.spec.id))

    # ------------------------------------------------------------- routing
    def submit(self, raw: bytes, user: str,
               headers: Dict[str, str]
               ) -> Tuple[int, Dict[str, str], bytes, str]:
        """Route one submission batch: admission → cell choice → proxy
        → ledger.  Returns ``(status, headers, body, cell_id)`` of the
        cell's answer.  An unreachable first choice re-routes the WHOLE
        batch to the next eligible cell (the breaker records every
        miss, so a dead cell stops being chosen after
        ``breaker_failures`` batches fleet-wide)."""
        try:
            body = json.loads(raw.decode() or "{}")
        except ValueError:
            raise RouteRejected(400, "malformed submission body")
        if not isinstance(body, dict):
            raise RouteRejected(400, "malformed submission body")
        self._check_global_caps(body, user)
        uuids = self._batch_uuids(body)
        gang = self._is_gang(body)
        tried: Set[str] = set()
        with tracing.span("federation.route", user=user,
                          jobs=len(uuids), gang=gang):
            while True:
                handle = self.pick_cell(body, exclude=tried)
                cell_id = handle.spec.id
                tried.add(cell_id)
                handle.inflight += 1
                t0 = time.perf_counter()
                try:
                    status, resp_headers, resp_raw = handle.request(
                        "POST", "/jobs", body=raw, headers=headers)
                except CellUnreachable:
                    # whole-batch re-route: the breaker recorded the
                    # miss; the next iteration excludes this cell
                    registry.counter_inc(
                        "cook_federation_reroutes_total", 1.0,
                        {"reason": "unreachable"})
                    continue
                finally:
                    handle.inflight -= 1
                registry.observe("cook_federation_route_seconds",
                                 time.perf_counter() - t0)
                if 200 <= status < 300:
                    self._record_accepted(cell_id, raw, user, uuids, gang)
                registry.counter_inc("cook_federation_routed_total", 1.0,
                                     {"cell": cell_id})
                handle.routed_total += 1
                return status, resp_headers, resp_raw, cell_id

    def _record_accepted(self, cell_id: str, raw: bytes, user: str,
                         uuids: List[str], gang: bool) -> None:
        if not uuids:
            return
        entry = {"cell": cell_id, "raw": raw, "user": user,
                 "uuids": uuids, "gang": gang, "reroutes": 0}
        for e in ({"user": user, "cpus": s.get("cpus", 1.0),
                   "mem": s.get("mem", 256.0),
                   "gpus": s.get("gpus", 0.0)}
                  for s in json.loads(raw.decode()).get("jobs", [])
                  if isinstance(s, dict)):
            self._recent.append(e)
        with self._mu:
            key = uuids[0]
            self._ledger[key] = entry
            for u in uuids:
                self._uuid_to_batch[u] = key
            while len(self._ledger) > self.config.ledger_max_batches:
                old_key, old = self._ledger.popitem(last=False)
                for u in old["uuids"]:
                    self._uuid_to_batch.pop(u, None)
                self.ledger_evicted += 1
                registry.counter_inc("cook_federation_ledger_evicted_total")

    def cell_of_uuid(self, uuid: str) -> Optional[str]:
        with self._mu:
            key = self._uuid_to_batch.get(uuid)
            return self._ledger[key]["cell"] if key else None

    # ------------------------------------------------- drain/reclaim/outage
    def drain_cell(self, cell_id: str) -> Dict[str, Any]:
        """Operator drain: no NEW demand routes here; the cell's
        summary table leaves the global merge.  Existing demand keeps
        running on the cell (it is healthy — this is the dynamic-
        cluster drain contract, one level up)."""
        handle = self._require(cell_id)
        handle.drained = True
        self.summaries.forget(cell_id)
        registry.counter_inc("cook_federation_drains_total",
                             labels={"cell": cell_id})
        return {"cell": cell_id, "drained": True}

    def rejoin_cell(self, cell_id: str) -> Dict[str, Any]:
        """Undo a drain: the cell takes new demand again and its table
        re-enters the merge on the next sweep (re-convergence is one
        fresh fetch — the exchange's staleness bound guarantees the
        window)."""
        handle = self._require(cell_id)
        handle.drained = False
        handle.breaker.record_success()
        self.summaries.refresh()
        return {"cell": cell_id, "drained": False}

    def reclaim_cell(self, cell_id: str,
                     reason=Reasons.CELL_RECLAIMED) -> Dict[str, Any]:
        """Spot-tier reclaim or confirmed full-cell outage: drain the
        cell AND re-route every ledgered batch it had accepted to
        surviving cells, whole batches only (a gang re-lands as one
        gang or stays pending — never split).  ``reason`` is mea-culpa:
        the re-routed demand keeps its retry budget; the platform took
        the capacity, the jobs did nothing wrong."""
        handle = self._require(cell_id)
        handle.drained = True
        self.summaries.forget(cell_id)
        with self._mu:
            batches = [dict(e) for e in self._ledger.values()
                       if e["cell"] == cell_id]
        rerouted, failed = [], []
        for entry in batches:
            ok, new_cell = self._reroute_batch(entry, cell_id,
                                               reason.name)
            (rerouted if ok else failed).append(
                {"batch": entry["uuids"][0], "jobs": len(entry["uuids"]),
                 "gang": entry["gang"], "cell": new_cell})
        registry.counter_inc("cook_federation_reclaims_total",
                             labels={"cell": cell_id,
                                     "reason": reason.name})
        return {"cell": cell_id, "reason": reason.name,
                "mea_culpa": reason.mea_culpa,
                "rerouted_batches": rerouted, "failed_batches": failed}

    def _reroute_batch(self, entry: Dict[str, Any], dead_cell: str,
                       reason_name: str) -> Tuple[bool, Optional[str]]:
        """Re-submit one accepted batch whole to a surviving cell.
        The resubmission is marked idempotent so a batch that ALSO
        survived on a half-dead cell (or a double reroute) lands as a
        no-op rather than a duplicate-uuid refusal."""
        try:
            body = json.loads(entry["raw"].decode())
        except ValueError:
            return False, None
        body["idempotent"] = True
        raw = json.dumps(body).encode()
        headers = {"Content-Type": "application/json",
                   "X-Cook-User": entry["user"]}
        tried = {dead_cell}
        while True:
            try:
                handle = self.pick_cell(body, exclude=tried)
            except RouteRejected:
                return False, None
            tried.add(handle.spec.id)
            try:
                status, _, _ = handle.request("POST", "/jobs", body=raw,
                                              headers=headers)
            except CellUnreachable:
                continue
            if 200 <= status < 300:
                with self._mu:
                    key = entry["uuids"][0]
                    if key in self._ledger:
                        self._ledger[key]["cell"] = handle.spec.id
                        self._ledger[key]["reroutes"] += 1
                        for u in entry["uuids"]:
                            self._uuid_to_batch[u] = key
                self.rerouted_batches += 1
                self.rerouted_jobs += len(entry["uuids"])
                registry.counter_inc(
                    "cook_federation_rerouted_jobs_total",
                    float(len(entry["uuids"])),
                    {"reason": reason_name})
                return True, handle.spec.id
            return False, handle.spec.id

    def _require(self, cell_id: str) -> CellHandle:
        handle = self.cells.get(cell_id)
        if handle is None:
            raise RouteRejected(404, f"no such cell {cell_id!r}")
        return handle

    # ------------------------------------------------------------ debugging
    def probe_all(self) -> None:
        for handle in self.cells.values():
            if handle.serving():
                handle.probe_health()

    def to_doc(self) -> Dict[str, Any]:
        """The ``/debug/federation`` panel."""
        try:
            summary_stats = self.summaries.stats()
        except Exception as exc:  # stats() itself never asserts, but
            summary_stats = {"error": str(exc)}  # stay panel-safe
        with self._mu:
            ledger = {"batches": len(self._ledger),
                      "jobs": len(self._uuid_to_batch),
                      "evicted": self.ledger_evicted,
                      "max_batches": self.config.ledger_max_batches}
        return {
            "cells": [h.to_doc() for h in self.cells.values()],
            "single_cell": self.single_cell,
            "route_mode": self.config.route_mode,
            "summaries": summary_stats,
            "ledger": ledger,
            "rejections": self.rejections,
            "rerouted_batches": self.rerouted_batches,
            "rerouted_jobs": self.rerouted_jobs,
            "caps": {
                "max_user_pending": self.config.max_user_pending,
                "max_user_dominant_share":
                    self.config.max_user_dominant_share,
                "summary_max_age_seconds":
                    self.config.summary_max_age_seconds,
            },
        }
