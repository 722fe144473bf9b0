"""The port's copy of ``cook_tpu/sim/federation.py`` (imports re-rooted):
full-cell-outage chaos for the federation front door.

``run_cell_outage`` takes ``device`` (default ``"cuda"``, which raises
before any cell, server or temporary directory is made without a card).
The JAX package's cells rank and match with its numpy backends
(``rank_backend="cpu"``, ``default_matcher.backend = "cpu"``); here each
cell's ``Scheduler`` runs on ``device`` with ``rank_backend="tpu"`` and
the matcher pinned to ``tpu-greedy``, so every :func:`_step_all` ranks
through kernels K2 and K3 (``Ranker.rank_pool``) and matches through K5
(``sched/matcher.dispatch``) on the card; on the CPU the same calls run
their plain versions.  The decisions are the JAX package's
(``tests/test_torch_federation.py`` holds the summary and every job's
owning cell against it).

``python -m cook_tpu_torch.sim --chaos --cell-outage [--cells N] [--soak]
[--device cpu]`` assembles N REAL cells in one process — each a Store + FakeCluster +
Scheduler + CookApi on its own threaded HTTP server, journal-backed so
commit tokens mint — puts the federation router in front, drives
multi-user traffic (plain batches and whole gangs) through the front
door, then KILLS one cell's server mid-stream and reclaims it.

The run fails (exit 1) unless every survival invariant holds:

1. **zero lost committed submissions** — every batch the front door
   positively acknowledged is queryable through the front door after
   the outage (the dead cell's accepted demand re-lands on survivors
   via the commit ledger's mea-culpa re-route, Reasons.CELL_RECLAIMED);
2. **whole-gang re-route** — every gang's members live on ONE cell
   after the outage: a gang re-lands whole or not at all, never split;
3. **surviving-cell read-your-writes** — the client's cell-qualified
   session token still gates reads on surviving cells, and reads that
   can no longer be fresh with respect to the dead cell say so in
   ``X-Cook-Federation-Stale-Cells`` instead of faking freshness;
4. **no breaker cascade** — the dead cell's breaker opens; every
   surviving cell's breaker stays closed (the survivors never absorb
   the dead cell's failures);
5. **goodput continues** — surviving cells schedule and run the
   re-routed demand (the outage degrades capacity, not the service).
"""

from __future__ import annotations

import json
import shutil
import tempfile
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .. import resolve_device
from ..client import JobClient
from ..cluster import FakeCluster, FakeHost
from ..config import Config
from ..rest import ApiServer, CookApi
from ..sched import Scheduler
from ..state import Resources, Store

__all__ = ["CellOutageConfig", "CellOutageResult", "run_cell_outage"]


@dataclass
class CellOutageConfig:
    seed: int = 0
    n_cells: int = 2
    #: batches submitted before + after the kill (half each side)
    n_batches: int = 16
    #: every k-th batch is a whole gang
    gang_every: int = 4
    gang_size: int = 3
    n_users: int = 3
    hosts_per_cell: int = 3
    #: soak mode (the slow tier): more cells, much more traffic
    soak: bool = False

    def __post_init__(self):
        if self.soak:
            self.n_cells = max(self.n_cells, 3)
            self.n_batches = max(self.n_batches, 80)
        if self.n_cells < 2:
            raise ValueError("--cell-outage needs at least 2 cells "
                             "(one dies, the rest must carry it)")


@dataclass
class _Cell:
    cell_id: str
    data_dir: str
    store: Store
    cluster: FakeCluster
    sched: Scheduler
    api: CookApi
    server: ApiServer


@dataclass
class CellOutageResult:
    ok: bool = False
    violations: List[str] = field(default_factory=list)
    cells: int = 0
    batches_acked: int = 0
    jobs_acked: int = 0
    gangs: int = 0
    victim: str = ""
    acked_before_kill: int = 0
    rerouted_batches: int = 0
    rerouted_jobs: int = 0
    lost_jobs: int = 0
    split_gangs: int = 0
    running_after: int = 0
    stale_cells_header: str = ""
    breaker_states: Dict[str, str] = field(default_factory=dict)

    def summary(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "violations": self.violations,
            "cells": self.cells,
            "victim": self.victim,
            "batches_acked": self.batches_acked,
            "jobs_acked": self.jobs_acked,
            "gangs": self.gangs,
            "acked_before_kill": self.acked_before_kill,
            "rerouted_batches": self.rerouted_batches,
            "rerouted_jobs": self.rerouted_jobs,
            "lost_jobs": self.lost_jobs,
            "split_gangs": self.split_gangs,
            "running_after": self.running_after,
            "stale_cells_header": self.stale_cells_header,
            "breaker_states": self.breaker_states,
        }


def _make_cell(name: str, n_hosts: int, device) -> _Cell:
    data_dir = tempfile.mkdtemp(prefix=f"cook-cell-{name}-")
    store = Store.open(data_dir)
    cluster = FakeCluster(
        f"{name}-cluster",
        [FakeHost(f"{name}-h{i}", Resources(cpus=8, mem=8192))
         for i in range(n_hosts)])
    cfg = Config()
    # the split cycle's kernels on the device: K2 and K3 rank, K5 matches
    cfg.default_matcher.backend = "tpu-greedy"
    sched = Scheduler(store, cfg, [cluster], rank_backend="tpu",
                      device=device)
    api = CookApi(store, scheduler=sched, config=cfg)
    server = ApiServer(api)
    server.start()
    return _Cell(name, data_dir, store, cluster, sched, api, server)


def _step_all(cells: List[_Cell]) -> None:
    for cell in cells:
        cell.sched.step_rank()
        cell.sched.step_match()


def run_cell_outage(config: Optional[CellOutageConfig] = None,
                    device="cuda") -> CellOutageResult:
    # refuse a missing card before any cell, server or tempdir is made
    device = resolve_device(device)
    cc = config or CellOutageConfig()
    res = CellOutageResult(cells=cc.n_cells)
    from ..federation.rest import build_federation_node

    cells = [_make_cell(f"cell{i}", cc.hosts_per_cell, device)
             for i in range(cc.n_cells)]
    by_id = {c.cell_id: c for c in cells}
    fed = build_federation_node(
        {"cells": [{"id": c.cell_id, "url": c.server.url}
                   for c in cells],
         # tight enough that a dead cell trips fast, loose enough that
         # one slow accept does not
         "breaker_failures": 2, "breaker_reset_seconds": 30.0,
         "request_timeout_seconds": 5.0}, device=device)
    fed.start()
    router = fed.router
    clients = [JobClient(fed.url, user=f"user{u}")
               for u in range(cc.n_users)]

    #: batch index -> {"uuids": [...], "gang": bool, "client": idx}
    acked: List[Dict[str, Any]] = []
    import uuid as _uuid

    def submit_batch(i: int) -> None:
        client = clients[i % cc.n_users]
        gang = cc.gang_every > 0 and i % cc.gang_every == 0
        if gang:
            g = str(_uuid.uuid4())
            specs = [{"command": f"sleep-{i}", "cpus": 1.0, "mem": 128.0,
                      "group": g, "labels": {"sim/duration_ms": "60000"}}
                     for _ in range(cc.gang_size)]
            uuids = client.submit(
                specs, groups=[{"uuid": g,
                                "gang": {"size": cc.gang_size}}])
        else:
            specs = [{"command": f"run-{i}-{j}", "cpus": 1.0,
                      "mem": 128.0,
                      "labels": {"sim/duration_ms": "60000"}}
                     for j in range(2)]
            uuids = client.submit(specs)
        acked.append({"uuids": uuids, "gang": gang,
                      "client": i % cc.n_users})

    try:
        half = cc.n_batches // 2
        for i in range(half):
            submit_batch(i)
        res.acked_before_kill = sum(len(b["uuids"]) for b in acked)
        _step_all(cells)

        # ---- the outage: hard-stop one cell that actually owns demand
        owned = {}
        for b in acked:
            c = router.cell_of_uuid(b["uuids"][0])
            owned[c] = owned.get(c, 0) + 1
        victim_id = max(owned, key=lambda k: owned[k]) \
            if owned else cells[0].cell_id
        res.victim = victim_id
        # hard kill: listener closed AND established keep-alive
        # connections severed, exactly what a dead process looks like
        # from the router's socket pool
        by_id[victim_id].server.kill()

        # ---- traffic continues: every post-kill batch must still land
        for i in range(half, cc.n_batches):
            submit_batch(i)

        # ---- reclaim: the dead cell's ACCEPTED demand re-routes whole
        reclaim = router.reclaim_cell(victim_id)
        res.rerouted_batches = len(reclaim["rerouted_batches"])
        res.rerouted_jobs = sum(b["jobs"]
                                for b in reclaim["rerouted_batches"])
        if reclaim["failed_batches"]:
            res.violations.append(
                f"{len(reclaim['failed_batches'])} ledgered batches of "
                f"{victim_id} could not be re-routed: "
                f"{reclaim['failed_batches'][:3]}")
        if not reclaim["mea_culpa"]:
            res.violations.append(
                "cell reclaim must be mea-culpa (free retries)")

        survivors = [c for c in cells if c.cell_id != victim_id]
        _step_all(survivors)

        res.batches_acked = len(acked)
        res.jobs_acked = sum(len(b["uuids"]) for b in acked)
        res.gangs = sum(1 for b in acked if b["gang"])

        # ---- invariant 1: zero lost committed submissions
        for b in acked:
            for u in b["uuids"]:
                try:
                    clients[b["client"]].job(u)
                except Exception as exc:
                    res.lost_jobs += 1
                    if len(res.violations) < 5:
                        res.violations.append(
                            f"acked job {u} lost after outage: {exc}")

        # ---- invariant 2: whole-gang re-route (never split)
        for b in acked:
            if not b["gang"]:
                continue
            owners = {router.cell_of_uuid(u) for u in b["uuids"]}
            if len(owners) != 1 or None in owners:
                res.split_gangs += 1
                res.violations.append(
                    f"gang split across cells {owners} "
                    f"(uuids {b['uuids'][:2]}...)")

        # ---- invariant 3: surviving-cell read-your-writes + honest
        # staleness toward the dead cell
        probe = clients[0]
        token = probe.last_commit_offset or ""
        if not any(token.startswith(s.cell_id + "/")
                   or ("," + s.cell_id + "/") in ("," + token)
                   for s in survivors):
            res.violations.append(
                f"session token {token!r} names no surviving cell — "
                "read-your-writes cannot span the outage")
        some_uuid = acked[0]["uuids"][0]
        req = urllib.request.Request(
            f"{fed.url}/jobs/{some_uuid}",
            headers={"X-Cook-User": probe.user,
                     "X-Cook-Min-Offset": token} if token else {})
        with urllib.request.urlopen(req) as r:
            res.stale_cells_header = \
                r.headers.get("X-Cook-Federation-Stale-Cells", "")
        if token and victim_id in {c for e in token.split(",")
                                   for c in [e.partition("/")[0]]} \
                and victim_id not in res.stale_cells_header:
            res.violations.append(
                f"token names {victim_id} but the read did not declare "
                "it stale (X-Cook-Federation-Stale-Cells="
                f"{res.stale_cells_header!r}) — staleness must be "
                "honest, never faked fresh")

        # ---- invariant 4: breaker opens on the victim ONLY
        for cid, handle in router.cells.items():
            res.breaker_states[cid] = handle.breaker.state
        if res.breaker_states.get(victim_id) not in ("open", "half-open"):
            res.violations.append(
                f"victim breaker is {res.breaker_states.get(victim_id)!r}"
                " — a dead cell must trip its breaker")
        for c in survivors:
            if res.breaker_states.get(c.cell_id) != "closed":
                res.violations.append(
                    f"survivor {c.cell_id} breaker "
                    f"{res.breaker_states.get(c.cell_id)!r}: the dead "
                    "cell's failures cascaded")

        # ---- invariant 5: survivors keep scheduling (goodput)
        _step_all(survivors)
        res.running_after = sum(
            len(c.store.running_instances()) for c in survivors)
        if res.running_after == 0 and res.jobs_acked > 0:
            res.violations.append(
                "no instance running on any survivor after the outage")

        res.ok = not res.violations
        return res
    finally:
        fed.stop()
        for c in cells:
            if c.cell_id != res.victim:
                try:
                    c.server.stop()
                except Exception:
                    pass
            shutil.rmtree(c.data_dir, ignore_errors=True)


def main_summary(res: CellOutageResult) -> str:  # pragma: no cover
    return json.dumps(res.summary(), indent=2)
