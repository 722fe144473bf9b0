"""The port's copy of ``cook_tpu/cluster/fake.py`` (imports re-rooted).

In-process fake compute cluster with a virtual clock.

The port of the reference's test/simulation backends: the fake compute
cluster registered by unit tests (reference: testutil.clj:76-122) fused with
the offer-fabricating in-JVM Mesos master used by the faster-than-real-time
simulator (reference: scheduler/src/cook/mesos/mesos_mock.clj:88-184).

Hosts are declared with capacities/attributes; offers are synthesized as
capacity minus consumption (the k8s-style offer model); launched tasks
complete after a configurable virtual duration when :meth:`advance_to` moves
the clock, delivering status updates through the scheduler's callback.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..state.schema import InstanceStatus, Reasons, Resources
from .base import ComputeCluster, LaunchSpec, Offer


@dataclass
class FakeHost:
    hostname: str
    capacity: Resources
    pool: str = "default"
    attributes: Dict[str, str] = field(default_factory=dict)
    gpu_model: str = ""
    disk_type: str = ""


@dataclass
class _RunningTask:
    spec: LaunchSpec
    started_at_ms: int
    duration_ms: Optional[int]   # None = runs until killed
    exit_code: int = 0


class FakeCluster(ComputeCluster):
    """Deterministic fake backend for tests, the simulator, and benchmarks."""

    def __init__(self, name: str, hosts: List[FakeHost],
                 default_task_duration_ms: Optional[int] = None,
                 auto_advance: bool = False):
        """``auto_advance``: follow the wall clock on a background ticker
        — for daemon deployments where no simulator drives advance_to, so
        tasks with durations actually complete.  A ticker (not an
        advance-on-offers hook) because a DRAINING cluster gets no offer
        calls yet must still finish its tasks for drain-then-delete."""
        super().__init__(name)
        self._hosts: Dict[str, FakeHost] = {h.hostname: h for h in hosts}
        self._tasks: Dict[str, _RunningTask] = {}
        self._lock = threading.RLock()
        self._now_ms = 0
        self._default_duration_ms = default_task_duration_ms
        # task_id -> duration override, set by tests/simulator before launch
        self.task_durations_ms: Dict[str, int] = {}
        # job uuid -> duration fallback (the simulator keys by job, since
        # task ids are only minted at launch)
        self.job_durations_ms: Dict[str, int] = {}
        self.task_exit_codes: Dict[str, int] = {}
        self.launched_order: List[str] = []
        # task_id -> advisory notify_task events delivered while running
        # (the elastic resize plane's checkpoint warnings, docs/GANG.md)
        self.notifications: Dict[str, List[Dict]] = {}
        # per-host consumption/counts maintained incrementally on
        # launch/complete/kill: recomputing from _tasks and re-running the
        # generator-based Resources arithmetic for every host cost 25-50 ms
        # per cycle at the 5k-host bench point
        self._consumption: Dict[str, List[float]] = {}
        self._counts: Dict[str, int] = {}
        # per-host Offer cache: rebuilding 5k Offer objects per cycle cost
        # ~35 ms at the bench point while only the ~launched hosts change;
        # entries are invalidated by _consume and host add/remove
        self._offer_cache: Dict[str, Offer] = {}
        self._auto_advance = auto_advance
        self._ticker_stop = threading.Event()
        if auto_advance:
            import time as _time

            def tick():
                while not self._ticker_stop.wait(0.1):
                    self.advance_to(int(_time.time() * 1000))
            threading.Thread(target=tick, daemon=True,
                             name=f"fake-clock-{name}").start()

    def shutdown(self) -> None:
        self._ticker_stop.set()

    def _consume(self, hostname: str, r: Resources, sign: float) -> None:
        c = self._consumption.get(hostname)
        if c is None:
            c = self._consumption[hostname] = [0.0, 0.0, 0.0, 0.0]
        c[0] += sign * r.cpus
        c[1] += sign * r.mem
        c[2] += sign * r.gpus
        c[3] += sign * r.disk
        self._counts[hostname] = self._counts.get(hostname, 0) + (
            1 if sign > 0 else -1)
        self._offer_cache.pop(hostname, None)

    def _pop_task(self, task_id: str) -> Optional[_RunningTask]:
        """Remove a task and release its consumption (caller holds _lock)."""
        task = self._tasks.pop(task_id, None)
        if task is not None:
            self._consume(task.spec.hostname, task.spec.resources, -1.0)
        return task

    # ------------------------------------------------------------- protocol
    def pending_offers(self, pool: str) -> List[Offer]:
        with self._lock:
            offers = []
            zeros = (0.0, 0.0, 0.0, 0.0)
            cache = self._offer_cache
            for h in self._hosts.values():
                if h.pool != pool:
                    continue
                offer = cache.get(h.hostname)
                if offer is not None and offer.pool == pool:
                    offers.append(offer)
                    continue
                cap = h.capacity
                used = self._consumption.get(h.hostname, zeros)
                avail = Resources(cap.cpus - used[0], cap.mem - used[1],
                                  cap.gpus - used[2], cap.disk - used[3])
                if not avail.non_negative():
                    avail = Resources()
                offer = Offer(
                    id=f"{self.name}/{h.hostname}/{self._now_ms}",
                    hostname=h.hostname, slave_id=h.hostname, pool=pool,
                    cluster=self.name,
                    available=avail, capacity=cap,
                    attributes=dict(h.attributes),
                    task_count=self._counts.get(h.hostname, 0),
                    gpu_model=h.gpu_model, disk_type=h.disk_type)
                cache[h.hostname] = offer
                offers.append(offer)
            return offers

    def launch_tasks(self, pool: str, specs: List[LaunchSpec]) -> None:
        from ..utils.faults import injector as _faults
        from ..utils.retry import breakers as _breakers
        breaker = _breakers.get(self.name)
        rejected: List[str] = []
        with self._lock:
            for spec in specs:
                if _faults.should_fire("cluster.launch"):
                    # injected backend/RPC fault: the launch is rejected
                    # (mea-culpa, pod-submission-failed) and the failure
                    # counts against this cluster's circuit breaker
                    rejected.append(spec.task_id)
                    breaker.record_failure()
                    continue
                if not spec.hostname:
                    # direct (Kenzo) mode: the backend's own scheduler places
                    # the task — first-fit stand-in for kube-scheduler
                    chosen = self._first_fit(pool, spec.resources)
                    if chosen is None:
                        rejected.append(spec.task_id)
                        continue
                    spec.hostname = chosen
                    spec.slave_id = chosen
                duration = self.task_durations_ms.get(
                    spec.task_id,
                    self.job_durations_ms.get(spec.job_uuid,
                                              self._default_duration_ms))
                # out-of-process drivers (daemon integration tests) can't
                # reach the dicts above; a job env hint carries the same
                # override through the REST surface
                env_hint = (spec.env or {}).get("COOK_FAKE_DURATION_MS")
                if env_hint is not None and \
                        spec.task_id not in self.task_durations_ms and \
                        spec.job_uuid not in self.job_durations_ms:
                    try:
                        duration = int(env_hint)
                    except ValueError:
                        pass
                exit_hint = (spec.env or {}).get("COOK_FAKE_EXIT_CODE")
                if exit_hint is not None and \
                        spec.task_id not in self.task_exit_codes:
                    try:
                        self.task_exit_codes[spec.task_id] = int(exit_hint)
                    except ValueError:
                        pass
                # relaunch of a live task_id (retry/replay): release the
                # overwritten entry's consumption or the host stays
                # permanently inflated
                self._pop_task(spec.task_id)
                self._tasks[spec.task_id] = _RunningTask(
                    spec=spec, started_at_ms=self._now_ms, duration_ms=duration,
                    exit_code=self.task_exit_codes.get(spec.task_id, 0))
                self._consume(spec.hostname, spec.resources, 1.0)
                self.launched_order.append(spec.task_id)
                breaker.record_success()
        for spec in specs:
            if spec.task_id not in rejected:
                self._emit(spec.task_id, InstanceStatus.RUNNING, None,
                           hostname=spec.hostname)
        for tid in rejected:
            self._emit(tid, InstanceStatus.FAILED,
                       Reasons.REASON_POD_SUBMISSION_FAILED.code)

    def _first_fit(self, pool: str, need: Resources) -> Optional[str]:
        zeros = (0.0, 0.0, 0.0, 0.0)
        for h in self._hosts.values():
            if h.pool != pool:
                continue
            cap, used = h.capacity, self._consumption.get(h.hostname, zeros)
            avail = Resources(cap.cpus - used[0], cap.mem - used[1],
                              cap.gpus - used[2], cap.disk - used[3])
            if need.fits_in(avail):
                return h.hostname
        return None

    def kill_task(self, task_id: str) -> None:
        with self._lock:
            task = self._pop_task(task_id)
        if task is not None:
            self._emit(task_id, InstanceStatus.FAILED, Reasons.KILLED_BY_USER.code)

    def notify_task(self, task_id: str, event: Dict) -> None:
        """Record resize notifications per task so tests/sim can assert
        the checkpoint warning reached a still-running member (the fake
        analog of the agent's SIGUSR1 + resize-file relay)."""
        with self._lock:
            if task_id in self._tasks:
                self.notifications.setdefault(task_id, []).append(
                    dict(event))

    # ---------------------------------------------------------- virtual time
    def advance_to(self, now_ms: int) -> List[str]:
        """Move the virtual clock; complete tasks whose duration elapsed.
        Returns completed task ids (in completion-time order)."""
        finished: List[tuple] = []
        with self._lock:
            self._now_ms = max(self._now_ms, now_ms)
            for tid, t in list(self._tasks.items()):
                if t.duration_ms is None:
                    continue
                done_at = t.started_at_ms + t.duration_ms
                if done_at <= self._now_ms:
                    finished.append((done_at, tid, t.exit_code))
                    self._pop_task(tid)
        finished.sort()
        out = []
        for _done_at, tid, exit_code in finished:
            ok = exit_code == 0
            self._emit(tid,
                       InstanceStatus.SUCCESS if ok else InstanceStatus.FAILED,
                       None if ok else Reasons.NON_ZERO_EXIT.code,
                       exit_code=exit_code)
            out.append(tid)
        return out

    @property
    def now_ms(self) -> int:
        return self._now_ms

    def running_task_ids(self) -> List[str]:
        with self._lock:
            return list(self._tasks.keys())

    def complete_task(self, task_id: str, exit_code: int = 0) -> None:
        """Test/simulator hook: finish a running task immediately."""
        with self._lock:
            task = self._pop_task(task_id)
        if task is not None:
            ok = exit_code == 0
            self._emit(task_id,
                       InstanceStatus.SUCCESS if ok else InstanceStatus.FAILED,
                       None if ok else Reasons.NON_ZERO_EXIT.code,
                       exit_code=exit_code)

    def fail_task(self, task_id: str, reason_code: int,
                  preempted: bool = False) -> None:
        """Test/chaos hook: fail a running task with a given reason."""
        with self._lock:
            task = self._pop_task(task_id)
        if task is not None:
            self._emit(task_id, InstanceStatus.FAILED, reason_code,
                       preempted=preempted)

    def _emit(self, task_id: str, status: InstanceStatus,
              reason_code: Optional[int], exit_code: Optional[int] = None,
              preempted: bool = False, hostname: Optional[str] = None) -> None:
        if self._status_callback is not None:
            self._status_callback(task_id, status, reason_code,
                                  exit_code=exit_code, preempted=preempted,
                                  hostname=hostname)


def factory(store=None, name: str = "fake", n_hosts: int = 4,
            cpus: float = 8.0, mem: float = 8192.0, gpus: float = 0.0,
            pool: str = "default", attributes=None,
            default_task_duration_ms=None,
            auto_advance: bool = False) -> "FakeCluster":
    """Config-driven construction for the daemon (the analog of the
    reference's compute-cluster factory-fn, compute_cluster.clj:483-497).
    In a daemon there is no simulator calling advance_to, so pass
    ``auto_advance`` (with a duration) when fake tasks should complete in
    wall time."""
    hosts = [FakeHost(hostname=f"{name}-h{i}", pool=pool,
                      capacity=Resources(cpus=cpus, mem=mem, gpus=gpus),
                      attributes=dict(attributes or {}))
             for i in range(n_hosts)]
    return FakeCluster(name, hosts,
                       default_task_duration_ms=default_task_duration_ms,
                       auto_advance=auto_advance)
