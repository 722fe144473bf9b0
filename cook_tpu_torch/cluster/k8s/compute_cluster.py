"""The port's copy of ``cook_tpu/cluster/k8s/compute_cluster.py``
(imports re-rooted), with one difference: ``safe_kill_task`` never waits.

A kill arrives inside the store's event drain (a REST kill: the
scheduler's transaction listener kills the job's live instances), and
the controller calls the store, a status writeback, under the lock its
kills and launches take.  Over ``RealKubernetesApi`` the watch threads
make that a lock cycle: a watch thread holds the controller's lock and
waits for the drain, the kill holds the drain and waits for the lock
(directly, or behind a launch that holds the kill lock's read side and
waits for the controller).  So a kill that cannot take the kill lock's
write side and the controller's lock at once goes to this cluster's
kill thread, which takes both in turn; the store already holds the
kill's reason, and the controller's table makes a late kill of an
ended pod a no-op.  Where no thread contends, as over the in-process
fake, the kill runs in the caller as the reference's does.

Kubernetes-style compute cluster backend.

Mirrors the reference's KubernetesComputeCluster (reference:
scheduler/src/cook/kubernetes/compute_cluster.clj:410-741):

 - offers are *synthesized* from watch state: per node, capacity minus the
   consumption of live pods (generate-offers :68-174, get-capacity/
   get-consumption api.clj:874-927);
 - launch builds a pod and feeds the controller (launch-task! :319-347);
 - startup reconstructs expected state from the store union live pods
   (determine-cook-expected-state-on-startup :253-288);
 - autoscaling launches placeholder "synthetic pods" sized like unmatched
   jobs so a cluster autoscaler provisions nodes (autoscale! :590-715);
 - max_launchable gives direct-mode backpressure from node/pod headroom
   (:555-588).

Works against any object with the FakeKubernetesApi surface; a real
kubernetes client adapter can implement the same interface.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

from ...state.schema import InstanceStatus, Job, Resources
from ...state.store import Store
from ..base import ComputeCluster, LaunchSpec, Offer
from .controller import CookExpected, PodController, synthesize_pod_state
from .fake_api import FakeKubernetesApi, FakeNode, FakePod

SYNTHETIC_PREFIX = "synthetic-"


class KubernetesCluster(ComputeCluster):
    def __init__(self, name: str, api: Optional[FakeKubernetesApi] = None,
                 store: Optional[Store] = None,
                 max_total_pods: int = 10_000,
                 max_pods_per_node: int = 32,
                 synthetic_pod_ttl_ms: int = 120_000,
                 stuck_pod_timeout_ms: int = 300_000,
                 node_blocklist_labels: Optional[List[str]] = None,
                 incremental=None,
                 rest_url: str = "",
                 disallowed_container_paths: Optional[List[str]] = None,
                 disallowed_var_names: Optional[List[str]] = None):
        super().__init__(name)
        self.api = api or FakeKubernetesApi()
        self.store = store
        self.max_total_pods = max_total_pods
        self.max_pods_per_node = max_pods_per_node
        self.stuck_pod_timeout_ms = stuck_pod_timeout_ms
        # nodes carrying any of these label KEYS take no cook work
        # (reference: node-blocklist-labels in node-schedulable?,
        # kubernetes/api.clj:782)
        self.node_blocklist_labels = list(node_blocklist_labels or [])
        self.incremental = incremental
        # advertised to tasks as COOK_SCHEDULER_REST_URL
        # (reference: kubernetes/api.clj:1440)
        self.rest_url = rest_url
        # volumes/env another cluster component owns, dropped at pod
        # compile (reference: config :kubernetes
        # :disallowed-container-paths / :disallowed-var-names)
        self.disallowed_container_paths = set(
            disallowed_container_paths or [])
        self.disallowed_var_names = set(disallowed_var_names or [])
        self._watch_registered = False
        self._kills: "queue.Queue[Optional[str]]" = queue.Queue()
        self._kill_thread: Optional[threading.Thread] = None
        self._kill_start = threading.Lock()
        clock = (lambda: store.clock()) if store is not None else (lambda: 0)
        self.controller = PodController(
            self.api,
            on_pod_started=self._pod_started,
            on_pod_completed=self._pod_completed,
            on_pod_killed=self._pod_killed,
            on_pod_preempted=self._pod_preempted,
            managed_filter=lambda pod: self._cook_managed(pod),
            clock=clock)

    # ------------------------------------------------------------- lifecycle
    def initialize(self, status_callback) -> None:
        super().initialize(status_callback)
        if self.store is not None:
            self._reconcile_startup()
        if not self._watch_registered:
            self.api.watch(self._on_watch_event)
            self._watch_registered = True

    def shutdown(self) -> None:
        """Detach from the api (leader handoff: the dying leader must stop
        reacting before the new one adopts the pods)."""
        if self._watch_registered:
            self.api.unwatch(self._on_watch_event)
            self._watch_registered = False
        with self._kill_start:
            thread, self._kill_thread = self._kill_thread, None
        if thread is not None:
            self._kills.put(None)
            thread.join(timeout=10)

    def _reconcile_startup(self) -> None:
        """Expected state = store's live instances for this cluster, union
        live pods (reference: compute_cluster.clj:253-288)."""
        expected_live = set()
        for _job, inst in self.store.running_instances():
            if inst.compute_cluster == self.name:
                expected_live.add(inst.task_id)
                self.controller.set_expected(
                    inst.task_id,
                    CookExpected.STARTING
                    if inst.status is InstanceStatus.UNKNOWN
                    else CookExpected.RUNNING)
        for pod in self.api.pods():
            if not self._cook_managed(pod):
                continue
            if pod.name not in expected_live:
                # live pod with no live instance: the controller's
                # (MISSING, live) arm will clean it up
                self.controller.set_expected(pod.name, CookExpected.MISSING)
        self.controller.scan_all()

    @staticmethod
    def _cook_managed(pod: FakePod) -> bool:
        """Only pods we launched are controller-managed; foreign pods on
        shared nodes consume capacity but are never touched (the reference
        scopes by namespace/naming, kubernetes/api.clj pod<->job naming)."""
        return (not pod.synthetic) and "cook/job" in pod.labels

    def _on_watch_event(self, event) -> None:
        if event.kind == "pod" and self._cook_managed(event.obj):
            if event.type == "DELETED":
                self.controller.pod_deleted(event.obj.name)
            else:
                self.controller.pod_update(event.obj.name)

    # ------------------------------------------------------------ writebacks
    def _pod_started(self, pod_name: str) -> None:
        pod = self.api.pod(pod_name)
        if self._status_callback:
            self._status_callback(pod_name, InstanceStatus.RUNNING, None,
                                  hostname=pod.node_name if pod else None)

    def _pod_completed(self, pod_name: str, exit_code: Optional[int],
                       reason_code: Optional[int]) -> None:
        ok = (exit_code or 0) == 0 and reason_code is None
        if self._status_callback:
            self._status_callback(
                pod_name,
                InstanceStatus.SUCCESS if ok else InstanceStatus.FAILED,
                reason_code, exit_code=exit_code)

    def _pod_killed(self, pod_name: str, reason_code: int) -> None:
        if self._status_callback:
            from ...state.schema import Reasons
            preempted = reason_code == Reasons.PREEMPTED_BY_REBALANCER.code
            self._status_callback(pod_name, InstanceStatus.FAILED,
                                  reason_code, preempted=preempted)

    def _pod_preempted(self, pod_name: str) -> None:
        """Pod regressed running->waiting (node preemption): mea-culpa
        failure so the retry is free (reference: handle-pod-preemption,
        controller.clj)."""
        if self._status_callback:
            from ...state.schema import Reasons
            self._status_callback(pod_name, InstanceStatus.FAILED,
                                  Reasons.PREEMPTED_BY_POOL.code,
                                  preempted=True)

    # --------------------------------------------------------------- offers
    def pending_offers(self, pool: str) -> List[Offer]:
        consumption: Dict[str, List[float]] = {}
        counts: Dict[str, int] = {}
        for pod in self.api.pods():
            if pod.node_name and pod.phase in ("Pending", "Running"):
                u = consumption.setdefault(pod.node_name, [0.0, 0.0, 0.0])
                u[0] += pod.cpus
                u[1] += pod.mem
                u[2] += pod.gpus
                counts[pod.node_name] = counts.get(pod.node_name, 0) + 1
        offers = []
        for node in self.api.nodes():
            if node.pool != pool or node.unschedulable or node.taints:
                continue
            if any(k in node.labels for k in self.node_blocklist_labels):
                continue
            used = consumption.get(node.name, [0.0, 0.0, 0.0])
            avail = Resources(cpus=max(0.0, node.cpus - used[0]),
                              mem=max(0.0, node.mem - used[1]),
                              gpus=max(0.0, node.gpus - used[2]))
            offers.append(Offer(
                id=f"{self.name}/{node.name}/{self.api.resource_version}",
                hostname=node.name, slave_id=node.name, pool=pool,
                cluster=self.name,
                available=avail,
                capacity=Resources(cpus=node.cpus, mem=node.mem,
                                   gpus=node.gpus),
                attributes=dict(node.labels),
                task_count=counts.get(node.name, 0),
                gpu_model=node.gpu_model))
        return offers

    def hosts(self, pool: str) -> List[Offer]:
        return self.pending_offers(pool)

    # --------------------------------------------------------------- launch
    def launch_tasks(self, pool: str, specs: List[LaunchSpec]) -> None:
        from ...state.schema import Reasons
        from .pod_spec import build_pod_spec
        for spec in specs:
            job = self.store.job(spec.job_uuid) if self.store else None
            pod = FakePod(
                name=spec.task_id,
                node_name=spec.hostname or None,  # direct mode: unscheduled
                cpus=spec.resources.cpus, mem=spec.resources.mem,
                gpus=spec.resources.gpus,
                creation_ms=(self.store.clock() if self.store else 0),
                labels={"cook/job": spec.job_uuid, "cook/pool": pool},
                spec=(build_pod_spec(
                    job, pool, incremental=self.incremental,
                    task_id=spec.task_id, rest_url=self.rest_url,
                    disallowed_container_paths=(
                        self.disallowed_container_paths),
                    disallowed_var_names=self.disallowed_var_names)
                      if job is not None else {}))
            if not self.controller.launch_pod(pod):
                if self._status_callback:
                    self._status_callback(
                        spec.task_id, InstanceStatus.FAILED,
                        Reasons.REASON_POD_SUBMISSION_FAILED.code)

    def kill_task(self, task_id: str) -> None:
        self.controller.kill_pod(task_id)

    def safe_kill_task(self, task_id: str) -> None:
        """Kill now if the kill lock's write side and the controller's
        lock are both free, else on the kill thread (module docstring)."""
        if self.kill_lock.try_acquire_write():
            try:
                if self.controller.try_kill_pod(task_id):
                    return
            finally:
                self.kill_lock.release_write()
        with self._kill_start:
            if self._kill_thread is None:
                self._kill_thread = threading.Thread(
                    target=self._kill_loop, daemon=True,
                    name=f"k8s-kill-{self.name}")
                self._kill_thread.start()
        self._kills.put(task_id)

    def _kill_loop(self) -> None:
        while True:
            task_id = self._kills.get()
            if task_id is None:
                return
            try:
                super().safe_kill_task(task_id)
            except Exception:
                import logging
                logging.getLogger(__name__).exception(
                    "deferred kill of %s failed", task_id)

    # ---------------------------------------------------- direct-mode limits
    def max_launchable(self, pool: str) -> int:
        """Headroom = min(total pod cap, per-node pod slots) (reference:
        kubernetes/compute_cluster.clj:555-588)."""
        pods = [p for p in self.api.pods() if not p.synthetic]
        total_headroom = self.max_total_pods - len(pods)
        node_headroom = 0
        per_node: Dict[str, int] = {}
        for p in pods:
            if p.node_name:
                per_node[p.node_name] = per_node.get(p.node_name, 0) + 1
        for node in self.api.nodes():
            if node.pool != pool or node.unschedulable:
                continue
            if any(k in node.labels for k in self.node_blocklist_labels):
                continue  # consistent with pending_offers: no offers ->
                # no launchable headroom either
            node_headroom += max(
                0, self.max_pods_per_node - per_node.get(node.name, 0))
        return max(0, min(total_headroom, node_headroom))

    # ------------------------------------------------------------ autoscaling
    def autoscale(self, pool: str, unmatched_jobs: List[Job],
                  now_ms: int = 0,
                  gangs: Optional[Dict[str, Dict]] = None) -> int:
        """Launch placeholder synthetic pods sized like unmatched jobs so a
        cluster autoscaler sees unsatisfied demand and provisions nodes
        (reference: autoscale! kubernetes/compute_cluster.clj:590-715,
        trigger-autoscaling! scheduler.clj:1178). Returns pods created.

        ``gangs`` (group uuid -> {"size", "topology"}) sizes gang demand
        as whole-slice pod SETS: the gang's placeholders are created
        all-or-none within the pod budget and carry a co-location
        affinity label/annotation so the cluster autoscaler provisions a
        contiguous slice instead of scattered singles (docs/GANG.md)."""
        gangs = gangs or {}
        budget = max(0, self.max_total_pods - len(self.api.pods()))
        created = 0
        # gang members grouped so a set never splits across the budget
        units: List[List[Job]] = []
        cohorts: Dict[str, List[Job]] = {}
        for job in unmatched_jobs:
            if job.group and job.group in gangs:
                cohort = cohorts.get(job.group)
                if cohort is None:
                    cohort = cohorts[job.group] = []
                    units.append(cohort)
                cohort.append(job)
            else:
                units.append([job])
        for unit in units:
            if budget <= 0:
                # nothing more can be created — skip the per-job pod
                # lookups (real API reads) the missing-filter would do
                break
            # budget the MISSING placeholders only: members whose pods
            # survived a previous cycle are free, and counting them
            # would wrongly skip a nearly-provisioned gang at the cap
            missing = [job for job in unit
                       if self.api.pod(f"{SYNTHETIC_PREFIX}{job.uuid}")
                       is None]
            if not missing or len(missing) > budget:
                continue  # a split gang set would under-provision the slice
            guuid = unit[0].group if unit[0].group in gangs else None
            made: List[str] = []
            for job in missing:
                name = f"{SYNTHETIC_PREFIX}{job.uuid}"
                labels = {"cook/synthetic": "true", "cook/job": job.uuid}
                annotations = {"cook/created-ms": str(now_ms)}
                if guuid:
                    labels["cook/gang"] = guuid
                    annotations["cook/gang-size"] = \
                        str(gangs[guuid].get("size") or len(unit))
                    topo = gangs[guuid].get("topology")
                    if topo:
                        # co-location affinity hint for the autoscaler /
                        # kube-scheduler: members want one topology domain
                        annotations["cook/gang-affinity"] = topo
                try:
                    self.api.create_pod(FakePod(
                        name=name, cpus=job.resources.cpus,
                        mem=job.resources.mem, gpus=job.resources.gpus,
                        synthetic=True,
                        labels=labels, annotations=annotations))
                    made.append(name)
                    created += 1
                    budget -= 1
                except ValueError:
                    if guuid:
                        # the set is all-or-none: roll back this gang's
                        # fresh placeholders rather than leave a partial
                        # slice signal for the autoscaler
                        for n in made:
                            try:
                                self.api.delete_pod(n)
                            except Exception:
                                pass
                        created -= len(made)
                        budget += len(made)
                        break
                    continue
        return created

    def synthetic_pods_for(self, job_uuids: List[str]) -> List[str]:
        """Which of these jobs already have a live placeholder here.
        The scheduler's autoscale routing uses this to tell "at the pod
        cap" (fall through with the uncovered jobs) apart from "already
        provisioned" (stay put) when autoscale() creates nothing —
        autoscale()'s own missing-filter reads the same pods, so this
        is the established per-cycle read pattern, not a new one."""
        return [u for u in job_uuids
                if self.api.pod(f"{SYNTHETIC_PREFIX}{u}") is not None]

    def detect_stuck_pods(self, now_ms: Optional[int] = None) -> List[str]:
        """Stuck/unschedulable pod detection (reference:
        kubernetes/api.clj:1820-1846): a cook-managed pod Pending past the
        timeout, or one the kube-scheduler marked unschedulable, is killed
        with a mea-culpa POD_STUCK failure (free retry elsewhere)."""
        from ...state.schema import Reasons
        if now_ms is None:
            now_ms = self.store.clock() if self.store else 0
        stuck: List[str] = []
        for pod in self.api.pods():
            if not self._cook_managed(pod) or pod.deleted:
                continue
            if pod.phase != "Pending":
                continue
            unschedulable = bool(pod.unschedulable_reason)
            timed_out = (now_ms - pod.creation_ms) > self.stuck_pod_timeout_ms
            if not (unschedulable or timed_out):
                continue
            stuck.append(pod.name)
            why = (f"unschedulable: {pod.unschedulable_reason}"
                   if unschedulable else
                   f"pending for {now_ms - pod.creation_ms}ms")
            # writeback first, then the kubernetes delete (restart safety)
            if self._status_callback:
                self._status_callback(pod.name, InstanceStatus.FAILED,
                                      Reasons.POD_STUCK.code)
            self.controller.set_expected(pod.name, CookExpected.COMPLETED)
            self.api.delete_pod(pod.name)
            self.controller.pod_update(pod.name)
            import logging
            logging.getLogger(__name__).warning(
                "reaped stuck pod %s (%s)", pod.name, why)
        return stuck

    def reap_synthetic_pods(self, launched_job_uuids: List[str]) -> int:
        """Delete placeholders whose jobs launched for real."""
        reaped = 0
        launched = set(launched_job_uuids)
        for pod in self.api.pods():
            if pod.synthetic and pod.labels.get("cook/job") in launched:
                self.api.delete_pod(pod.name)
                reaped += 1
        return reaped


def factory(store=None, name: str = "k8s", api_url: str = "",
            **kwargs) -> KubernetesCluster:
    """Config-file / dynamic-creation entry point (the analog of
    fake.factory / remote.factory; reference: the factory-fn template,
    compute_cluster.clj:483-497).  ``api_url`` selects the stdlib-HTTP
    RealKubernetesApi; empty keeps the in-process fake (tests,
    simulation)."""
    api = None
    if api_url:
        from .real_api import RealKubernetesApi
        api = RealKubernetesApi(base_url=api_url)
    return KubernetesCluster(name, api, store=store, **kwargs)
