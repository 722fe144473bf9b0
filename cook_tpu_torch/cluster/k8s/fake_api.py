"""The port's copy of ``cook_tpu/cluster/k8s/fake_api.py``
(imports re-rooted).

In-process fake Kubernetes API.

The stand-in for a real k8s API server, mirroring how the reference unit
tests drive the controller/API layers without a cluster (reference:
scheduler/test/cook/test/kubernetes/*).  Implements the subset the backend
uses: node and pod objects, create/delete pod, watch streams with
resourceVersion resume, and a pod-lifecycle simulation the tests/simulator
can step (scheduled -> running -> succeeded/failed).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class FakeNode:
    name: str
    cpus: float
    mem: float
    gpus: float = 0.0
    pool: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[str] = field(default_factory=list)
    unschedulable: bool = False
    gpu_model: str = ""


from .types import Lease

FakeLease = Lease  # back-compat alias; the type itself is adapter-neutral


@dataclass
class FakePod:
    name: str
    node_name: Optional[str] = None        # set when scheduled
    phase: str = "Pending"                 # Pending|Running|Succeeded|Failed
    cpus: float = 0.0
    mem: float = 0.0
    gpus: float = 0.0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    deleted: bool = False                  # deletion timestamp set
    deletion_ms: Optional[int] = None      # when the delete was requested
    creation_ms: int = 0
    exit_code: Optional[int] = None
    reason: str = ""
    # scheduling condition message, e.g. "Unschedulable: taint mismatch"
    # (the PodScheduled=False condition the stuck-pod detector reads,
    # reference: kubernetes/api.clj:1820-1846)
    unschedulable_reason: str = ""
    synthetic: bool = False                # autoscaling placeholder
    resource_version: int = 0
    # rich pod spec compiled from the job (containers/volumes/env/
    # tolerations/priority...; reference: task-metadata->pod
    # kubernetes/api.clj:1370-1813)
    spec: Dict[str, object] = field(default_factory=dict)


class WatchEvent:
    __slots__ = ("kind", "type", "obj", "resource_version")

    def __init__(self, kind: str, type_: str, obj, resource_version: int):
        self.kind = kind          # "pod" | "node"
        self.type = type_         # ADDED | MODIFIED | DELETED
        self.obj = obj
        self.resource_version = resource_version


class FakeKubernetesApi:
    """Thread-safe fake API server with watches."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._nodes: Dict[str, FakeNode] = {}
        self._pods: Dict[str, FakePod] = {}
        self._leases: Dict[str, FakeLease] = {}
        self._rv = 0
        self._events: List[WatchEvent] = []
        self._watchers: List[Callable[[WatchEvent], None]] = []
        # simulation: pods auto-advance on step()
        self.auto_schedule = True
        # when True, graceful deletes linger in DELETING until
        # finish_deletion (exercises the controller's deleting arms)
        self.sticky_deletion = False

    # -------------------------------------------------------------- leases
    @staticmethod
    def _lease_copy(lease: Lease) -> Lease:
        # annotations is the one mutable field: a caller mutating the
        # returned copy must not reach back into the stored lease
        return Lease(**{**vars(lease),
                        "annotations": dict(lease.annotations)})

    def get_lease(self, name: str) -> Optional[Lease]:
        with self._lock:
            lease = self._leases.get(name)
            return self._lease_copy(lease) if lease else None

    def annotate_lease(self, name: str,
                       annotations: Dict[str, Optional[str]]) -> None:
        """Merge-patch the lease's metadata annotations (None deletes a
        key) — the coordination surface candidate positions ride
        (sched/election.py LeaseLeaderElector.publish_candidate)."""
        with self._lock:
            lease = self._leases.get(name)
            if lease is None:
                lease = Lease(name=name)
                self._leases[name] = lease
            for k, v in annotations.items():
                if v is None:
                    lease.annotations.pop(k, None)
                else:
                    lease.annotations[k] = str(v)

    def try_acquire_lease(self, name: str, identity: str, now_s: float,
                          duration_s: float = 15.0,
                          holder_url: str = "") -> Optional[Lease]:
        """Acquire-or-renew with the apiserver's compare-and-swap
        semantics: succeeds when the lease is unheld, expired, or already
        held by ``identity``; returns the updated lease or None when a
        live competitor holds it (the k8s leader-election recipe)."""
        with self._lock:
            lease = self._leases.get(name)
            if lease is None:
                lease = Lease(name=name)
                self._leases[name] = lease
            expired = now_s - lease.renew_time_s > lease.duration_s
            if lease.holder and lease.holder != identity and not expired:
                return None
            if lease.holder != identity:
                lease.transitions += 1  # new holder: fencing epoch bump
            lease.holder = identity
            lease.holder_url = holder_url
            lease.renew_time_s = now_s
            lease.duration_s = duration_s
            return self._lease_copy(lease)

    def release_lease(self, name: str, identity: str) -> None:
        """Explicit release on clean shutdown: clears the hold so a
        standby can acquire immediately (no TTL wait)."""
        with self._lock:
            lease = self._leases.get(name)
            if lease is not None and lease.holder == identity:
                lease.holder = ""
                lease.holder_url = ""
                lease.renew_time_s = 0.0

    # ------------------------------------------------------------- plumbing
    def _emit(self, kind: str, type_: str, obj) -> None:
        self._rv += 1
        if kind == "pod":
            obj.resource_version = self._rv
        event = WatchEvent(kind, type_, obj, self._rv)
        self._events.append(event)
        for w in list(self._watchers):
            w(event)

    def watch(self, callback: Callable[[WatchEvent], None],
              resource_version: int = 0) -> None:
        """Register a watcher; replays history after resource_version first
        (the resume semantics of kubernetes/api.clj:372-475)."""
        with self._lock:
            for event in self._events:
                if event.resource_version > resource_version:
                    callback(event)
            self._watchers.append(callback)

    def unwatch(self, callback: Callable[[WatchEvent], None]) -> None:
        with self._lock:
            if callback in self._watchers:
                self._watchers.remove(callback)

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    # ----------------------------------------------------------------- nodes
    def add_node(self, node: FakeNode) -> None:
        with self._lock:
            self._nodes[node.name] = node
            self._emit("node", "ADDED", node)

    def delete_node(self, name: str) -> None:
        with self._lock:
            node = self._nodes.pop(name, None)
            if node:
                self._emit("node", "DELETED", node)

    def nodes(self) -> List[FakeNode]:
        with self._lock:
            return list(self._nodes.values())

    # ------------------------------------------------------------------ pods
    def create_pod(self, pod: FakePod) -> None:
        with self._lock:
            if pod.name in self._pods:
                raise ValueError(f"pod {pod.name} already exists")
            self._pods[pod.name] = pod
            self._emit("pod", "ADDED", pod)

    def delete_pod(self, name: str, grace_period_s: Optional[float] = None,
                   now_ms: int = 0) -> None:
        """Graceful delete: marks deletion; the object disappears on the next
        lifecycle step (watch sees MODIFIED then DELETED).
        ``grace_period_s=0`` is the hard kill the controller issues for pods
        stuck DELETING past their deadline (controller.clj kill-pod-hard)."""
        with self._lock:
            pod = self._pods.get(name)
            if pod is None:
                return
            pod.deleted = True
            if pod.deletion_ms is None:
                pod.deletion_ms = now_ms
            if self.sticky_deletion and grace_period_s != 0:
                # simulate a slow kubelet: the pod lingers with its
                # deletionTimestamp set (synthesized state DELETING) until
                # finish_deletion or a grace-0 hard kill
                self._emit("pod", "MODIFIED", pod)
                return
            if pod.phase not in ("Succeeded", "Failed"):
                # killing a live pod fails it first
                pod.phase = "Failed"
                pod.reason = pod.reason or "Deleted"
                self._emit("pod", "MODIFIED", pod)
            # watchers run synchronously and may re-enter delete_pod;
            # pop so only one caller emits the DELETED event
            if self._pods.pop(name, None) is not None:
                self._emit("pod", "DELETED", pod)

    def finish_deletion(self, name: str) -> None:
        """Simulation hook: the kubelet finally releases a DELETING pod."""
        with self._lock:
            pod = self._pods.pop(name, None)
            if pod is not None:
                self._emit("pod", "DELETED", pod)

    def mark_unschedulable(self, name: str, reason: str) -> None:
        """Simulation hook: kube-scheduler reports PodScheduled=False."""
        with self._lock:
            pod = self._pods.get(name)
            if pod is not None:
                pod.unschedulable_reason = reason
                self._emit("pod", "MODIFIED", pod)

    def pods(self) -> List[FakePod]:
        with self._lock:
            return list(self._pods.values())

    def pod(self, name: str) -> Optional[FakePod]:
        with self._lock:
            return self._pods.get(name)

    # ------------------------------------------------------------ simulation
    def _fits(self, node: FakeNode, pod: FakePod,
              used: Dict[str, List[float]]) -> bool:
        u = used.get(node.name, [0.0, 0.0, 0.0])
        return (u[0] + pod.cpus <= node.cpus
                and u[1] + pod.mem <= node.mem
                and u[2] + pod.gpus <= node.gpus)

    def step(self) -> None:
        """Advance the cluster one tick: schedule pending pods (first-fit,
        the kube-scheduler stand-in) and start scheduled pods."""
        with self._lock:
            used: Dict[str, List[float]] = {}
            for pod in self._pods.values():
                if pod.node_name and pod.phase in ("Pending", "Running"):
                    u = used.setdefault(pod.node_name, [0.0, 0.0, 0.0])
                    u[0] += pod.cpus
                    u[1] += pod.mem
                    u[2] += pod.gpus
            for pod in list(self._pods.values()):
                if pod.phase == "Pending" and pod.node_name is None \
                        and self.auto_schedule:
                    for node in self._nodes.values():
                        if node.unschedulable:
                            continue
                        if self._fits(node, pod, used):
                            pod.node_name = node.name
                            u = used.setdefault(node.name, [0.0, 0.0, 0.0])
                            u[0] += pod.cpus
                            u[1] += pod.mem
                            u[2] += pod.gpus
                            self._emit("pod", "MODIFIED", pod)
                            break
                elif pod.phase == "Pending" and pod.node_name is not None:
                    pod.phase = "Running"
                    self._emit("pod", "MODIFIED", pod)

    def finish_pod(self, name: str, exit_code: int = 0) -> None:
        """Simulation hook: complete a running pod."""
        with self._lock:
            pod = self._pods.get(name)
            if pod is None or pod.phase not in ("Running", "Pending"):
                return
            pod.phase = "Succeeded" if exit_code == 0 else "Failed"
            pod.exit_code = exit_code
            self._emit("pod", "MODIFIED", pod)

    def lose_node(self, name: str) -> None:
        """Simulation hook: node disappears; its pods fail."""
        with self._lock:
            self.delete_node(name)
            for pod in list(self._pods.values()):
                if pod.node_name == name and pod.phase in ("Pending", "Running"):
                    pod.phase = "Failed"
                    pod.reason = "NodeLost"
                    self._emit("pod", "MODIFIED", pod)
