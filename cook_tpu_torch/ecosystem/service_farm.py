"""The port's copy of ``cook_tpu/ecosystem/service_farm.py`` (over the port's
``cook_tpu_torch.client``; host code, no device).

Generic long-running service farm over the jobclient.

The reference integrates Dask and Spark by running their worker processes
as Cook jobs (reference: dask/docs/design.md architecture — "deploy the
scheduler node and worker nodes on Cook as jobs"; spark patches submit
coarse-grained executors the same way).  ServiceFarm is that pattern made
first-class: declare a command template, call :meth:`scale`, and the farm
submits or kills jobs to converge on the target, tracking them by a farm
label so a restarted client can re-adopt its fleet.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..client import TERMINAL_STATES

FARM_LABEL = "cook-service-farm"


class ServiceFarm:
    """Manage N copies of a long-running service job.

    ``command_fn(index)`` produces the command line for worker *index*;
    ``spec`` carries the common job fields (cpus/mem/gpus/pool/labels...).
    """

    def __init__(self, client, name: str,
                 command_fn: Callable[[int], str],
                 spec: Optional[Dict] = None,
                 pool: Optional[str] = None):
        self.client = client
        self.name = name
        self.command_fn = command_fn
        self.spec = dict(spec or {})
        self.pool = pool
        self._next_index = 0
        # uuid -> worker index, live fleet as this farm believes it
        self._workers: Dict[str, int] = {}
        self._adopt()

    # ------------------------------------------------------------- adoption
    def _adopt(self) -> None:
        """Re-adopt jobs labeled for this farm that are still alive (a
        client restart must not leak a running fleet).

        A transient listing failure here would silently skip adoption and
        make the restarted client double-submit over a leaked fleet — the
        exact bug adoption exists to prevent — so the listing is retried
        and a persistent failure raises instead of returning quietly.
        """
        last_err = None
        for attempt in range(5):
            try:
                # filter by the submitting user: two users may run
                # same-named farms, and one must never adopt (then kill)
                # the other's fleet
                jobs = self.client.jobs(
                    user=getattr(self.client, "user", None),
                    states=["waiting", "running"])
                break
            except Exception as e:
                last_err = e
                time.sleep(min(0.25 * (2 ** attempt), 2.0))
        else:
            raise RuntimeError(
                f"ServiceFarm {self.name!r}: could not list jobs to "
                f"re-adopt the fleet ({last_err}); refusing to start "
                "blind (would double-submit over a leaked fleet)")
        for j in jobs:
            labels = j.get("labels") or {}
            if labels.get(FARM_LABEL) == self.name:
                idx = int(labels.get("cook-farm-index", -1))
                self._workers[j["uuid"]] = idx
                self._next_index = max(self._next_index, idx + 1)

    # --------------------------------------------------------------- fleet
    def _make_spec(self, idx: int) -> Dict:
        spec = dict(self.spec)
        labels = dict(spec.get("labels") or {})
        labels[FARM_LABEL] = self.name
        labels["cook-farm-index"] = str(idx)
        spec["labels"] = labels
        spec["command"] = self.command_fn(idx)
        spec.setdefault("max_retries", 1)
        return spec

    def _refresh(self) -> None:
        """Drop fleet members that completed (failed/killed workers)."""
        if not self._workers:
            return
        for j in self.client.query(list(self._workers)):
            if j.get("state") in TERMINAL_STATES:
                self._workers.pop(j["uuid"], None)

    def scale(self, n: int) -> List[str]:
        """Converge on ``n`` live workers; returns the fleet's uuids.
        Scale-down kills the newest workers first (the dask design doc's
        recommendation: disturb the oldest, warmest workers last)."""
        self._refresh()
        if len(self._workers) < n:
            # one batched POST, not a round trip per worker
            idxs = [self._next_index + k
                    for k in range(n - len(self._workers))]
            self._next_index = idxs[-1] + 1
            uuids = self.client.submit([self._make_spec(i) for i in idxs],
                                       pool=self.pool)
            self._workers.update(zip(uuids, idxs))
        if len(self._workers) > n:
            doomed = sorted(self._workers, key=self._workers.get,
                            reverse=True)[:len(self._workers) - n]
            self.client.kill(doomed)
            for u in doomed:
                self._workers.pop(u, None)
        return list(self._workers)

    def size(self) -> int:
        """Current believed fleet size (no HTTP round trip)."""
        return len(self._workers)

    def fleet(self) -> List[str]:
        """Current fleet uuids."""
        return list(self._workers)

    def kill_members(self, uuids: List[str]) -> None:
        """Kill specific fleet members and forget them."""
        doomed = [u for u in uuids if u in self._workers]
        if doomed:
            self.client.kill(doomed)
            for u in doomed:
                self._workers.pop(u, None)

    def status(self) -> Dict[str, str]:
        """uuid -> state for the current fleet."""
        if not self._workers:
            return {}
        return {j["uuid"]: j["state"]
                for j in self.client.query(list(self._workers))}

    def running(self) -> List[str]:
        return [u for u, s in self.status().items() if s == "running"]

    def wait_running(self, n: int, timeout_s: float = 60.0,
                     poll_s: float = 0.2) -> List[str]:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            r = self.running()
            if len(r) >= n:
                return r
            time.sleep(poll_s)
        raise TimeoutError(
            f"{self.name}: {n} running workers not reached in {timeout_s}s")

    def start_singleton(self, timeout_s: float = 60.0,
                        poll_s: float = 0.2):
        """Scale to ONE member and resolve its placement once running:
        returns ``(uuid, hostname, ports)``.  The shared head-node
        bring-up for the dask scheduler and the spark master — one
        definition of the poll/resolve/terminal-check loop."""
        [uuid] = self.scale(1)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            [job] = self.client.query([uuid])
            if job["state"] == "running" and job.get("instances"):
                inst = job["instances"][-1]
                return (uuid, inst.get("hostname", ""),
                        inst.get("ports") or [])
            if job["state"] in TERMINAL_STATES:
                raise RuntimeError(
                    f"{self.name}: singleton job completed early")
            time.sleep(poll_s)
        raise TimeoutError(
            f"{self.name}: singleton not running within {timeout_s}s")

    def close(self) -> None:
        """Kill the whole fleet."""
        if self._workers:
            self.client.kill(list(self._workers))
            self._workers.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
