"""The port's copy of ``cook_tpu/ecosystem/dask_backend.py`` (over the port's
``cook_tpu_torch.client``; host code, no device).

Dask cluster backend: the reference's ``dask_cook.CookCluster`` design
(reference: dask/docs/design.md — a docs-only proposal there) implemented.

Architecture per the design doc: the Dask *scheduler node* and all *worker
nodes* run as Cook jobs; the client connects to the scheduler's address.
API shape matches the doc's examples::

    with CookCluster(client) as cluster:
        cluster.scale(20)            # add/remove workers
        from dask.distributed import Client
        client = Client(cluster.scheduler_address)

``dask`` itself is only needed on the nodes running the jobs (and by
:meth:`adapt`); this module stays importable without it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ..client import TERMINAL_STATES
from .service_farm import ServiceFarm

DEFAULT_SCHEDULER_PORT = 8786


class CookCluster:
    """Deploy a Dask cluster as Cook jobs.

    ``client`` is a :class:`cook_tpu_torch.client.JobClient` (or the native
    jobclient wrapper — anything with submit/query/kill/jobs).
    """

    def __init__(self, client, name: str = "dask",
                 pool: Optional[str] = None,
                 scheduler_spec: Optional[Dict] = None,
                 worker_spec: Optional[Dict] = None,
                 scheduler_port: int = DEFAULT_SCHEDULER_PORT,
                 scheduler_cmd: str = "dask-scheduler",
                 worker_cmd: str = "dask-worker"):
        self.client = client
        self.name = name
        self.scheduler_port = scheduler_port
        sspec = dict(scheduler_spec or {"cpus": 1.0, "mem": 2048.0})
        sspec.setdefault("name", f"{name}-scheduler")
        # one host port for the scheduler endpoint (compiled into the task
        # env as PORT0 by the launch path)
        sspec.setdefault("ports", 1)
        # the launch path assigns the host port and exports it as PORT0;
        # the scheduler must listen on THAT port or workers would connect
        # to a port nothing listens on — fall back to scheduler_port when
        # the backend assigns none
        self._sched_farm = ServiceFarm(
            client, f"{name}-scheduler",
            lambda i: (f"{scheduler_cmd} "
                       f"--port ${{PORT0:-{scheduler_port}}}"),
            spec=sspec, pool=pool)
        self._scheduler_uuid: Optional[str] = None
        self._scheduler_address: Optional[str] = None
        wspec = dict(worker_spec or {"cpus": 1.0, "mem": 2048.0})
        wspec.setdefault("name", f"{name}-worker")
        # one host port per worker, bound as its dask listening port: the
        # instance's recorded ports then equal the port in the address dask
        # hands back to scale_down, so co-located workers are
        # distinguishable (a hostname-only match would kill the wrong one)
        wspec.setdefault("ports", 1)
        self._worker_cmd = worker_cmd
        self._workers = ServiceFarm(
            client, f"{name}-workers",
            lambda i: (f"{worker_cmd} {self._address_placeholder()}"
                       " --worker-port ${PORT0:-0}"),
            spec=wspec, pool=pool)
        self._adaptive = None

    def _address_placeholder(self) -> str:
        return self._scheduler_address or "$COOK_DASK_SCHEDULER"

    # ------------------------------------------------------------ scheduler
    def start_scheduler(self, timeout_s: float = 60.0) -> str:
        """Submit the scheduler job (if needed) and resolve its address from
        the running instance's hostname."""
        self._scheduler_uuid, host, ports = \
            self._sched_farm.start_singleton(timeout_s=timeout_s)
        port = ports[0] if ports else self.scheduler_port
        self._scheduler_address = f"tcp://{host}:{port}"
        return self._scheduler_address

    @property
    def scheduler_address(self) -> str:
        if self._scheduler_address is None:
            return self.start_scheduler()
        return self._scheduler_address

    # -------------------------------------------------------------- workers
    def scale(self, n: int):
        """Converge on n workers (design.md: ``cluster.scale(20)``).  The
        scheduler is started on first use so worker commands carry its
        resolved address."""
        if n > 0 and self._scheduler_address is None:
            self.start_scheduler()
        return self._workers.scale(n)

    def adapt(self, minimum: int = 0, maximum: int = 16):
        """Dynamic sizing (design.md: ``cluster.adapt()``).  With
        ``dask.distributed`` importable this returns dask's own ``Adaptive``
        wired to this cluster; otherwise it applies the minimum bound and
        records the range for an external autoscaler."""
        self._adaptive = (minimum, maximum)
        try:
            from distributed.deploy.adaptive import Adaptive  # type: ignore
        except Exception:
            # only enforce the LOWER bound — never shrink a healthy fleet
            # that is already within [minimum, maximum]
            target = max(minimum, self._workers.size())
            if len(self._workers.scale(target)) < minimum:
                raise RuntimeError("could not reach adapt minimum")
            return self._adaptive
        return Adaptive(self, minimum=minimum, maximum=maximum)

    # dask's Adaptive calls these on its cluster handle
    def scale_up(self, n: int):  # pragma: no cover - requires dask
        self.scale(n)

    def scale_down(self, workers):  # pragma: no cover - requires dask
        """Adaptive hands back dask worker ADDRESSES (tcp://host:port);
        map them to farm job uuids via each job's latest instance before
        killing.  Two workers can share one host, so a plain hostname
        match would kill the whole host's fleet when one worker is
        retired: prefer an exact (host, port) match against the
        instance's assigned ports, and otherwise kill at most as many
        co-located members as addresses were requested for that host
        (newest first)."""
        want = {}  # host -> list of requested ports (None = unknown)
        for w in workers:
            addr = str(w)
            if "://" in addr:
                addr = addr.split("://", 1)[1]
            host, _, port = addr.rpartition(":")
            if not host:
                host, port = addr, ""
            want.setdefault(host, []).append(
                int(port) if port.isdigit() else None)
        by_host = {}  # host -> [(farm_index, uuid, instance_ports)]
        idx_of = dict(zip(self._workers.fleet(),
                          range(len(self._workers.fleet()))))
        for j in self.client.query(self._workers.fleet()):
            insts = j.get("instances") or []
            if not insts or j.get("state") in TERMINAL_STATES:
                continue
            inst = insts[-1]
            host = inst.get("hostname")
            if host in want:
                by_host.setdefault(host, []).append(
                    (idx_of.get(j["uuid"], 0), j["uuid"],
                     set(inst.get("ports") or [])))
        doomed = []
        for host, ports in want.items():
            cands = sorted(by_host.get(host, []), reverse=True)  # newest 1st
            # two passes: every exact port match claims its worker FIRST, so
            # an unknown-port address's fallback can never steal (then
            # cascade onto) a worker another address names exactly
            unmatched = []
            for port in ports:
                hit = next((c for c in cands
                            if port is not None and port in c[2]), None)
                if hit is not None:
                    cands.remove(hit)
                    doomed.append(hit[1])
                else:
                    unmatched.append(port)
            for _ in unmatched:
                if cands:
                    doomed.append(cands.pop(0)[1])  # newest co-resident
        self._workers.kill_members(doomed)

    def workers_status(self) -> Dict[str, str]:
        return self._workers.status()

    def close(self) -> None:
        self._workers.close()
        self._sched_farm.close()
        self._scheduler_address = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
