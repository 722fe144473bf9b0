"""The port's copy of ``cook_tpu/cluster/k8s/controller.py``
(imports re-rooted).

Dual-state-machine pod controller.

The heart of the k8s backend (reference:
scheduler/src/cook/kubernetes/controller.clj:482-711): reconciles the cross
product of

  cook-expected-state in {STARTING, RUNNING, COMPLETED, KILLED, MISSING}
  pod-synthesized-state in {WAITING, RUNNING, SUCCEEDED, FAILED, UNKNOWN,
                            DELETING, MISSING}

— the reference's "30-state table" plus its DELETING arms — preserving the
reference's invariants:
  * store writeback happens FIRST, then kubernetes actions (restart safety);
  * pods are deleted from kubernetes only in terminal pod states
    (UNKNOWN counts as terminal, forced retry at the cook level);
  * a live pod in an unexpected ("weird") state is killed by deleting it and
    the failure is marked mea-culpa;
  * (RUNNING, WAITING) — a pod regressing to waiting means the node
    preempted/moved it (GKE preemptible semantics): kill the pod AND write
    a mea-culpa preemption so the retry is free (controller.clj
    handle-pod-preemption);
  * (KILLED, MISSING) — the kill-races-the-watch case: opportunistically
    kill using the launch-time pod object saved in the expected-state entry
    (controller.clj :launch-pod);
  * (MISSING, DELETING) with an old deletion timestamp — escalate to a
    grace-0 hard kill (controller.clj kill-pod-hard);
  * per-pod processing is serialized through sharded locks
    (controller.clj:22-51 — here the sharded ordered executor).
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ...state.schema import Reasons
from .fake_api import FakePod


class CookExpected(enum.Enum):
    STARTING = "starting"
    RUNNING = "running"
    COMPLETED = "completed"
    KILLED = "killed"
    MISSING = "missing"


class PodState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    UNKNOWN = "unknown"
    DELETING = "deleting"
    MISSING = "missing"


TERMINAL_POD_STATES = (PodState.SUCCEEDED, PodState.FAILED,
                       PodState.UNKNOWN, PodState.MISSING)

# how long a DELETING pod may linger before the hard kill
OLD_DELETION_MS = 60_000


def synthesize_pod_state(pod: Optional[FakePod]) -> PodState:
    """pod object -> synthesized state (reference:
    pod->synthesized-pod-state kubernetes/api.clj:1916)."""
    if pod is None:
        return PodState.MISSING
    if pod.deleted and pod.phase in ("Pending", "Running"):
        return PodState.DELETING
    if pod.phase == "Pending":
        return PodState.WAITING
    if pod.phase == "Running":
        return PodState.RUNNING
    if pod.phase == "Succeeded":
        return PodState.SUCCEEDED
    if pod.phase == "Failed":
        return PodState.FAILED
    return PodState.UNKNOWN


@dataclass
class ExpectedStateEntry:
    state: CookExpected
    # why a kill happened / weird-state provenance, for passport/debug
    reason: str = ""
    # the pod object we asked kubernetes to create, kept so a kill that
    # races ahead of the watch can still name its target
    # (reference: :launch-pod in the cook-expected-state dict)
    launch_pod: Optional[FakePod] = None


class PodController:
    """Reconciler over (expected, actual) per pod name.

    Writebacks to the store go through the callbacks; kubernetes actions go
    through the api client (create/delete pod).
    """

    def __init__(self, api, *,
                 on_pod_started: Callable[[str], None],
                 on_pod_completed: Callable[[str, Optional[int], Optional[int]], None],
                 on_pod_killed: Callable[[str, int], None],
                 on_pod_preempted: Optional[Callable[[str], None]] = None,
                 managed_filter: Optional[Callable] = None,
                 clock: Callable[[], int] = lambda: 0,
                 logger=None):
        self.api = api
        self.managed_filter = managed_filter or (lambda pod: True)
        self.expected: Dict[str, ExpectedStateEntry] = {}
        self._lock = threading.RLock()
        self.on_pod_started = on_pod_started
        self.on_pod_completed = on_pod_completed
        self.on_pod_killed = on_pod_killed
        self.on_pod_preempted = on_pod_preempted or (
            lambda pod_name: on_pod_killed(
                pod_name, Reasons.PREEMPTED_BY_POOL.code))
        self.clock = clock
        import logging
        self.log = logger or logging.getLogger(__name__)

    # ------------------------------------------------------------ lifecycle
    def launch_pod(self, pod: FakePod) -> bool:
        """Expected -> STARTING and create in kubernetes."""
        with self._lock:
            self.expected[pod.name] = ExpectedStateEntry(
                CookExpected.STARTING, launch_pod=pod)
            try:
                self.api.create_pod(pod)
                return True
            except ValueError:
                # name collision: treat as submission failure
                self.expected.pop(pod.name, None)
                return False

    def kill_pod(self, pod_name: str, reason: str = "killed") -> None:
        """Cook-level kill (user kill / preemption): expected -> KILLED, then
        reconcile (which deletes the pod)."""
        with self._lock:
            entry = self.expected.get(pod_name)
            if entry is None or entry.state in (CookExpected.COMPLETED,
                                                CookExpected.MISSING):
                return
            self.expected[pod_name] = ExpectedStateEntry(
                CookExpected.KILLED, reason,
                launch_pod=entry.launch_pod)
        self.process(pod_name)

    def try_kill_pod(self, pod_name: str) -> bool:
        """``kill_pod`` if this thread can take the controller's lock now;
        False, with nothing done, if another thread holds it."""
        if not self._lock.acquire(blocking=False):
            return False
        try:
            self.kill_pod(pod_name)
            return True
        finally:
            self._lock.release()

    def set_expected(self, pod_name: str, state: CookExpected) -> None:
        """Startup reconciliation hook."""
        with self._lock:
            self.expected[pod_name] = ExpectedStateEntry(state)

    # ---------------------------------------------------------------- events
    def pod_update(self, pod_name: str) -> None:
        self.process(pod_name)

    def pod_deleted(self, pod_name: str) -> None:
        self.process(pod_name)

    def scan_all(self) -> None:
        """Periodic full reconciliation (reference: scan-process
        controller.clj:815): every tracked or live pod gets visited."""
        with self._lock:
            names = set(self.expected.keys())
        names.update(p.name for p in self.api.pods()
                     if self.managed_filter(p))
        for name in names:
            self.process(name)

    # ------------------------------------------------------------------ core
    def process(self, pod_name: str) -> None:
        """One reconciliation visit (reference: process controller.clj:482).
        Runs under the per-pod lock; loops until the state is stable."""
        with self._lock:
            for _ in range(4):  # states converge in <= a few hops
                entry = self.expected.get(pod_name)
                expected = entry.state if entry else CookExpected.MISSING
                pod = self.api.pod(pod_name)
                actual = synthesize_pod_state(pod)
                new_expected = self._step(pod_name, expected, actual, pod,
                                          entry)
                if new_expected is None:
                    self.expected.pop(pod_name, None)
                    if expected is CookExpected.MISSING:
                        return
                elif new_expected is not expected:
                    self.expected[pod_name] = ExpectedStateEntry(
                        new_expected, entry.reason if entry else "",
                        launch_pod=entry.launch_pod if entry else None)
                else:
                    return  # stable

    # The full transition table. Returns the new expected state
    # (None = forget the entry).
    def _step(self, pod_name: str, expected: CookExpected, actual: PodState,
              pod: Optional[FakePod], entry: Optional[ExpectedStateEntry]
              ) -> Optional[CookExpected]:
        E, A = CookExpected, PodState

        if expected is E.STARTING:
            if actual in (A.WAITING, A.MISSING):
                return E.STARTING  # pod creation/scheduling in progress
            if actual is A.RUNNING:
                self.on_pod_started(pod_name)
                return E.RUNNING
            if actual is A.SUCCEEDED:
                self.on_pod_started(pod_name)  # never observed running
                self.on_pod_completed(pod_name, pod.exit_code, None)
                return E.COMPLETED
            if actual is A.FAILED:
                self.on_pod_completed(
                    pod_name, pod.exit_code, self._failure_reason(pod))
                return E.COMPLETED
            if actual is A.UNKNOWN:
                # terminal-as-far-as-we're-concerned + kill the weird pod;
                # mea-culpa so the retry is free
                self.on_pod_completed(pod_name, pod.exit_code if pod else None,
                                      Reasons.UNKNOWN_MEA_CULPA.code)
                self._kill_weird(pod_name, "unknown pod phase while starting")
                return E.COMPLETED
            if actual is A.DELETING:
                # deleted before it ever ran: something external killed it
                self.on_pod_killed(pod_name, Reasons.NODE_LOST.code)
                return E.COMPLETED

        elif expected is E.RUNNING:
            if actual is A.RUNNING:
                return E.RUNNING
            if actual is A.SUCCEEDED:
                self.on_pod_completed(pod_name, pod.exit_code, None)
                return E.COMPLETED
            if actual is A.FAILED:
                self.on_pod_completed(
                    pod_name, pod.exit_code, self._failure_reason(pod))
                return E.COMPLETED
            if actual is A.UNKNOWN:
                self.on_pod_completed(pod_name, pod.exit_code if pod else None,
                                      Reasons.UNKNOWN_MEA_CULPA.code)
                self._kill_weird(pod_name, "unknown pod phase while running")
                return E.COMPLETED
            if actual is A.WAITING:
                # a running pod regressing to waiting means the node
                # preempted/moved it (GKE preemptible): kill the pod and
                # write a mea-culpa PREEMPTION so the retry is free
                # (reference: handle-pod-preemption, controller.clj)
                self.log.info("pod %s regressed running->waiting: preempted",
                              pod_name)
                self.api.delete_pod(pod_name)
                self.on_pod_preempted(pod_name)
                return E.COMPLETED
            if actual in (A.MISSING, A.DELETING):
                # pod vanished under us (node reclaim, external delete)
                self.on_pod_killed(pod_name, Reasons.NODE_LOST.code)
                return E.COMPLETED

        elif expected is E.KILLED:
            if actual in (A.WAITING, A.RUNNING):
                # store writeback first, then delete from kubernetes
                self.on_pod_killed(pod_name, Reasons.KILLED_BY_USER.code)
                self.api.delete_pod(pod_name)
                return E.COMPLETED
            if actual is A.SUCCEEDED:
                # it finished before the kill landed
                self.on_pod_completed(pod_name, pod.exit_code, None)
                self.api.delete_pod(pod_name)
                return E.COMPLETED
            if actual is A.FAILED:
                self.on_pod_killed(pod_name, Reasons.KILLED_BY_USER.code)
                self.api.delete_pod(pod_name)
                return E.COMPLETED
            if actual is A.UNKNOWN:
                self.on_pod_completed(pod_name, pod.exit_code if pod else None,
                                      Reasons.UNKNOWN_MEA_CULPA.code)
                self._kill_weird(pod_name, "unknown pod phase while killed")
                return E.COMPLETED
            if actual is A.DELETING:
                # expected step of the deletion path
                self.on_pod_killed(pod_name, Reasons.KILLED_BY_USER.code)
                return E.COMPLETED
            if actual is A.MISSING:
                # kill raced ahead of the watch: the pod may exist even
                # though our watch state says missing — opportunistically
                # kill the launch-time pod object (controller.clj
                # :launch-pod) so it cannot leak, then write back
                if entry is not None and entry.launch_pod is not None:
                    self.log.info(
                        "opportunistic kill of %s (kill raced the watch)",
                        pod_name)
                    self.api.delete_pod(pod_name)
                self.on_pod_killed(pod_name, Reasons.KILLED_BY_USER.code)
                return E.COMPLETED

        elif expected is E.COMPLETED:
            if actual in (A.SUCCEEDED, A.FAILED):
                self.api.delete_pod(pod_name)  # writeback already happened
                return E.COMPLETED if self.api.pod(pod_name) else None
            if actual is A.UNKNOWN:
                self._kill_weird(pod_name, "unknown pod phase after complete")
                return E.COMPLETED if self.api.pod(pod_name) else None
            if actual in (A.RUNNING, A.WAITING):
                # who resurrected this pod? two leaders? kill it
                self._kill_weird(pod_name, "live pod for completed instance")
                return E.COMPLETED
            if actual is A.DELETING:
                return None  # deletion in progress; nothing left to do
            if actual is A.MISSING:
                return None  # final state: forget

        elif expected is E.MISSING:
            # only reached for cook-managed pods (the watch layer filters
            # foreign and synthetic pods before the controller sees them)
            if actual in (A.SUCCEEDED, A.FAILED, A.UNKNOWN):
                self._kill_weird(pod_name, "terminal pod with no record")
                return None
            if actual in (A.RUNNING, A.WAITING):
                self._kill_weird(pod_name, "untracked live cook pod")
                return None
            if actual is A.DELETING:
                # stuck deletion: past the deadline, escalate to a grace-0
                # hard kill (reference: kill-pod-hard for old deletion
                # timestamps)
                if pod is not None and pod.deletion_ms is not None and \
                        self.clock() - pod.deletion_ms > OLD_DELETION_MS:
                    self.log.warning("hard-killing pod %s stuck deleting",
                                     pod_name)
                    self.api.delete_pod(pod_name, grace_period_s=0)
                return None
            return None

        return expected

    def _kill_weird(self, pod_name: str, why: str) -> None:
        self.log.warning("killing pod %s in weird state: %s", pod_name, why)
        self.api.delete_pod(pod_name)

    @staticmethod
    def _failure_reason(pod: Optional[FakePod]) -> Optional[int]:
        if pod is None:
            return Reasons.UNKNOWN.code
        if pod.reason == "NodeLost":
            return Reasons.NODE_LOST.code
        if pod.reason == "Deleted":
            return Reasons.KILLED_BY_USER.code
        return Reasons.NON_ZERO_EXIT.code if pod.exit_code else \
            Reasons.UNKNOWN.code
