"""The port's copy of ``cook_tpu/cluster/base.py`` (imports re-rooted).

Compute-cluster abstraction — the framework's "device layer".

Mirrors the reference's ComputeCluster protocol (reference:
scheduler/src/cook/compute_cluster.clj:27-112) with the subset of methods the
scheduler core needs, plus the per-cluster launch/kill ReadWriteLock ordering
discipline (compute_cluster.clj:86-130): kills take the write lock, launches
the read lock, so a kill issued while a launch is in flight cannot be
reordered before it.
"""

from __future__ import annotations

import abc
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..state.schema import Resources


@dataclass
class Offer:
    """A host's spare capacity offered to the matcher (reference: mesos
    offers / k8s synthesized offers, kubernetes/compute_cluster.clj:68-174)."""

    id: str
    hostname: str
    slave_id: str
    pool: str
    available: Resources
    capacity: Resources
    cluster: str = ""
    attributes: Dict[str, str] = field(default_factory=dict)
    # running task count, for max-tasks-per-host constraints
    task_count: int = 0
    # gpu/disk models present on the host (constraints.clj:122-216)
    gpu_model: str = ""
    disk_type: str = ""


@dataclass
class LaunchSpec:
    """One matched task to launch.

    Carries the full task compilation the reference builds in
    mesos/task.clj:114-294: command environment, requested host-port count,
    and the container spec ({"image": ..., "volumes": ["host:cont", ...]}).
    """

    task_id: str
    job_uuid: str
    hostname: str
    slave_id: str
    resources: Resources
    env: Dict[str, str] = field(default_factory=dict)
    port_count: int = 0
    container: Optional[Dict] = None


class ReadWriteLock:
    """Writer-preferring RW lock (equivalent of the reference's
    ReentrantReadWriteLock kill-lock, compute_cluster.clj:86-112)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._local = threading.local()

    def holds_read(self) -> bool:
        """True when the calling thread holds the read side — acquiring the
        write side from such a thread would self-deadlock."""
        return getattr(self._local, "read_count", 0) > 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
            self._local.read_count = getattr(self._local, "read_count", 0) + 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            self._local.read_count = getattr(self._local, "read_count", 1) - 1
            if self._readers == 0:
                self._cond.notify_all()

    def try_acquire_write(self) -> bool:
        """Take the write side only if no reader or writer holds the lock
        now; never waits."""
        with self._cond:
            if self._writer or self._readers:
                return False
            self._writer = True
            return True

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class ComputeCluster(abc.ABC):
    """Pluggable cluster backend (reference: compute_cluster.clj protocol).

    Status updates flow back through ``status_callback(task_id, status,
    reason_code)`` registered at initialization — the moral equivalent of the
    mesos scheduler callbacks / k8s watch feed.
    """

    def __init__(self, name: str):
        self.name = name
        self.kill_lock = ReadWriteLock()
        self.state = "running"  # running -> draining -> deleted
        self._status_callback: Optional[Callable] = None

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, status_callback: Callable) -> None:
        """Connect and begin delivering status updates."""
        self._status_callback = status_callback

    # -- scheduling ---------------------------------------------------------
    @abc.abstractmethod
    def pending_offers(self, pool: str) -> List[Offer]:
        """Current spare capacity per host for a pool."""

    def hosts(self, pool: str) -> List[Offer]:
        """ALL schedulable hosts for a pool with true capacity/attributes,
        including fully-utilized ones (which pending_offers may omit).  The
        rebalancer needs this for constraint evaluation on preemption
        targets — exactly the busy hosts.  Default assumes pending_offers is
        already exhaustive."""
        return self.pending_offers(pool)

    @abc.abstractmethod
    def launch_tasks(self, pool: str, specs: List[LaunchSpec]) -> None:
        """Start tasks. Caller holds kill_lock (the read side), so an
        in-flight launch always lands before a safe_kill_task."""

    @abc.abstractmethod
    def kill_task(self, task_id: str) -> None:
        """Kill one task. Implementations must be idempotent."""

    def safe_kill_task(self, task_id: str) -> None:
        """Kill under the write lock so in-flight launches land first
        (reference: compute_cluster.clj:116-130)."""
        self.kill_lock.acquire_write()
        try:
            self.kill_task(task_id)
        finally:
            self.kill_lock.release_write()

    def notify_task(self, task_id: str, event: Dict) -> None:
        """Best-effort advisory delivery to a RUNNING task — the elastic
        resize plane's checkpoint warning (docs/GANG.md elasticity: the
        agent relays SIGUSR1 + a ``COOK_GANG_RESIZE_FILE`` event so the
        workload can checkpoint inside the grace window).  Never
        load-bearing: a lost notification only costs the workload its
        checkpoint opportunity, the shrink itself executes through the
        ordinary kill path at the grace deadline.  Default: drop."""

    # -- capacity (Kenzo-style direct mode backpressure) --------------------
    def max_launchable(self, pool: str) -> int:
        """Headroom for direct-mode submission (reference:
        kubernetes/compute_cluster.clj:555-588)."""
        return len(self.pending_offers(pool))

    def accepts_pool(self, pool: str) -> bool:
        return self.state == "running"
