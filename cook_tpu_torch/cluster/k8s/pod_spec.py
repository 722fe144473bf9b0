"""The port's copy of ``cook_tpu/cluster/k8s/pod_spec.py``
(imports re-rooted).

Pod-spec compiler: Job -> rich pod specification.

The analog of the reference's ``task-metadata->pod`` (reference:
scheduler/src/cook/kubernetes/api.clj:1370-1813) and its checkpointing
injection (api.clj:1173-1267): the job's container image/volumes, env,
checkpoint volumes + env + init container (with incremental-config-driven
image selection), tolerations, priority class, GPU/disk node selectors, and
the shm volume are compiled into a plain dict carried on the pod object.

The dict IS the contract: the fake API stores it verbatim; a real client
adapter translates it to V1Pod fields 1:1.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from ...state.schema import Checkpoint, Job

# well-known labels (shared with sched/constraints.py)
GPU_MODEL_LABEL = "gpu-model"
DISK_TYPE_LABEL = "disk-type"

COOK_WORKDIR = "/mnt/sandbox"
CHECKPOINT_VOLUME = "cook-checkpoint"
CHECKPOINT_MOUNT = "/mnt/checkpoint"
DEFAULT_CHECKPOINT_INIT_IMAGE = "cook/checkpoint-init:stable"
DEFAULT_FETCH_INIT_IMAGE = "cook/fetch-init:stable"
DEFAULT_SIDECAR_IMAGE = "cook/sidecar:stable"
SIDECAR_PORT = 28101
SIDECAR_HEALTH_PATH = "/readiness-probe"
SIDECAR_WORKDIR = "/mnt/sidecar"
# the file server is infrastructure, not user workload: its requests ride
# outside the job's resources (reference: sidecar resource-requirements
# from config, api.clj:1666-1696)
SIDECAR_CPUS = 0.1
SIDECAR_MEM_MB = 32.0
DEFAULT_SHM_MB = 64


def _resolve_image(incremental: Optional[Any], key: str, default: str,
                   job_uuid: str) -> str:
    """Incremental-config image rollout (reference resolves images per
    job-uuid hash portion, api.clj:1226 + config_incremental.clj)."""
    if incremental is not None:
        resolved = incremental.resolve(key, job_uuid)
        if resolved:
            return resolved
    return default


def build_pod_spec(job: Job, pool: str,
                   incremental: Optional[Any] = None,
                   sidecar: bool = True,
                   task_id: Optional[str] = None,
                   rest_url: str = "",
                   disallowed_container_paths: Optional[set] = None,
                   disallowed_var_names: Optional[set] = None
                   ) -> Dict[str, Any]:
    """Compile one job's pod specification.

    ``incremental`` is a policy.incremental.IncrementalConfig used for
    gradual image rollouts (the reference resolves the checkpoint init
    image per job-uuid hash, api.clj:1226 + config_incremental.clj).
    ``task_id``/``rest_url`` feed the task-identity metadata environment
    (reference: mesos/task.clj:114-135 + kubernetes/api.clj:1440
    COOK_SCHEDULER_REST_URL).
    """
    container = job.container or {}
    image = container.get("image", "cook/default-runtime:stable")

    env = [{"name": "HOST_IP",  # fieldRef, resolved by the kubelet
            # (reference: hostIpEnvVar kubernetes/api.clj:1102-1114)
            "value_from": {"field_ref": {"field_path": "status.hostIP"}}},
           {"name": "COOK_JOB_UUID", "value": job.uuid},
           {"name": "COOK_JOB_USER", "value": job.user},
           {"name": "COOK_WORKDIR", "value": COOK_WORKDIR},
           {"name": "COOK_POOL", "value": pool},
           {"name": "COOK_JOB_CPUS", "value": str(job.resources.cpus)},
           {"name": "COOK_JOB_MEM_MB", "value": str(job.resources.mem)}]
    if task_id:
        env.append({"name": "COOK_INSTANCE_UUID", "value": task_id})
        # count of PRIOR attempts (the launching task is already recorded
        # on the job; the reference counts the pre-transaction snapshot)
        env.append({"name": "COOK_INSTANCE_NUM",
                    "value": str(max(0, len(job.instances) - 1))})
    if job.resources.gpus:
        env.append({"name": "COOK_JOB_GPUS",
                    "value": str(job.resources.gpus)})
    if job.group:
        env.append({"name": "COOK_JOB_GROUP_UUID", "value": job.group})
    if rest_url:
        env.append({"name": "COOK_SCHEDULER_REST_URL", "value": rest_url})
    # scheduler-owned identity vars win over user env (the reference assocs
    # them ON TOP of job-ent->env, mesos/task.clj:127-131; k8s env lists are
    # last-entry-wins, so drop user collisions instead)
    reserved = {e["name"] for e in env}
    # operator-filtered var names (reference: make-filtered-env-vars,
    # kubernetes/api.clj:1117-1126 — REMOVED, not rejected: another
    # cluster component owns those names)
    blocked_vars = disallowed_var_names or set()
    env.extend({"name": k, "value": v} for k, v in sorted(job.env.items())
               if k not in reserved and k not in blocked_vars)

    volumes = [{"name": "cook-workdir", "empty_dir": {}}]
    mounts = [{"name": "cook-workdir", "mount_path": COOK_WORKDIR}]
    blocked_paths = disallowed_container_paths or set()
    for vol in container.get("volumes", []):
        # user volumes: {"host-path": ..., "container-path": ..., "mode":
        # ...} or the compact "host:container" string form
        if isinstance(vol, str):
            bits = vol.split(":")  # host[:container[:mode]]
            vol = {"host-path": bits[0],
                   "container-path": bits[1] if len(bits) > 1 and bits[1]
                   else bits[0],
                   "mode": ("RO" if len(bits) > 2
                            and bits[2].lower() == "ro" else "RW")}
        # paths another cluster component mounts (admission controller)
        # are dropped, not rejected (make-volumes, kubernetes/api.clj:995)
        target = vol.get("container-path") or vol.get("host-path")
        if target in blocked_paths:
            continue
        name = f"uservol-{len(volumes)}"
        volumes.append({"name": name,
                        "host_path": vol.get("host-path", "")})
        mounts.append({"name": name,
                       "mount_path": vol.get("container-path",
                                             vol.get("host-path", "")),
                       "read_only": vol.get("mode", "RW") == "RO"})

    # shm volume (api.clj shm handling): jobs can ask for a bigger /dev/shm
    shm_mb = int(job.labels.get("shm-size-mb", 0) or 0)
    if shm_mb:
        volumes.append({"name": "shm",
                        "empty_dir": {"medium": "Memory",
                                      "size_limit_mb": shm_mb}})
        mounts.append({"name": "shm", "mount_path": "/dev/shm"})

    init_containers = []
    tolerations = [
        # cook nodes are tainted so only cook pods land on them
        {"key": "cook-pool", "operator": "Equal", "value": pool,
         "effect": "NoSchedule"},
    ]
    node_selector: Dict[str, str] = {}

    # GPU jobs: node selector on gpu model + toleration
    if job.resources.gpus > 0:
        model = job.labels.get(GPU_MODEL_LABEL)
        if model:
            node_selector[GPU_MODEL_LABEL] = model
        tolerations.append({"key": "nvidia.com/gpu", "operator": "Exists",
                            "effect": "NoSchedule"})
    disk_type = job.labels.get(DISK_TYPE_LABEL)
    if disk_type:
        node_selector[DISK_TYPE_LABEL] = disk_type

    # checkpointing (api.clj:1173-1267): volume + env + init container whose
    # image can roll out gradually via incremental config
    checkpoint: Optional[Checkpoint] = job.checkpoint
    if checkpoint is not None:
        volumes.append({"name": CHECKPOINT_VOLUME, "empty_dir": {}})
        mounts.append({"name": CHECKPOINT_VOLUME,
                       "mount_path": CHECKPOINT_MOUNT})
        env.append({"name": "COOK_CHECKPOINT_MODE",
                    "value": checkpoint.mode.value})
        env.append({"name": "COOK_CHECKPOINT_PATH",
                    "value": CHECKPOINT_MOUNT})
        if checkpoint.period_sec:
            env.append({"name": "COOK_CHECKPOINT_PERIOD_SEC",
                        "value": str(checkpoint.period_sec)})
        init_image = _resolve_image(incremental, "checkpoint-init-image",
                                    DEFAULT_CHECKPOINT_INIT_IMAGE, job.uuid)
        init_containers.append({
            "name": "checkpoint-init",
            "image": init_image,
            "volume_mounts": [{"name": CHECKPOINT_VOLUME,
                               "mount_path": CHECKPOINT_MOUNT}],
            "env": [{"name": "COOK_JOB_UUID", "value": job.uuid}],
        })
        for extra in checkpoint.volume_mounts:
            mounts.append({"name": CHECKPOINT_VOLUME, "mount_path": extra,
                           "sub_path": extra.strip("/")})

    # URI artifacts: fetched into the shared workdir by an init container
    # before the job container starts — the k8s analog of the mesos
    # fetcher, with its full per-uri mode set (executable/extract/cache;
    # reference: :job/uri semantics, mesos fetcher task.clj:114-160)
    if job.uris:
        fetch_spec = [{"value": u.get("value", ""),
                       "executable": bool(u.get("executable", False)),
                       "extract": bool(u.get("extract", False)),
                       "cache": bool(u.get("cache", False))}
                      for u in job.uris]
        init_containers.append({
            "name": "cook-fetch",
            "image": DEFAULT_FETCH_INIT_IMAGE,
            "env": [
                # structured fetch list: modes survive the wire
                {"name": "COOK_URIS_JSON",
                 "value": json.dumps(fetch_spec, sort_keys=True)},
                # legacy flat form (paths only) kept for older fetchers
                {"name": "COOK_URIS",
                 "value": ";".join(u["value"] for u in fetch_spec)},
            ],
            "volume_mounts": [{"name": "cook-workdir",
                               "mount_path": COOK_WORKDIR}],
            "working_dir": COOK_WORKDIR,
        })

    # requested host-port count (mesos/task.clj:209-237's slot).  Dynamic
    # host-port assignment is the native transport's feature; kubernetes
    # has no offer-side port ranges, so the request is surfaced as
    # COOK_PORT_COUNT + spec metadata for a runtime webhook/CNI to fulfill
    # rather than fabricated containerPorts the apiserver would reject.
    if job.ports:
        env.append({"name": "COOK_PORT_COUNT", "value": str(job.ports)})

    # docker parameters that translate to pod fields (reference: the k8s
    # path honors workdir/env parameters, kubernetes/api.clj:1370-1813;
    # the rest are docker-runtime flags with no pod equivalent)
    workdir = COOK_WORKDIR
    for p in container.get("parameters", []) or []:
        key, value = p.get("key"), p.get("value", "")
        if key == "workdir" and value:
            workdir = value
        elif key == "env" and "=" in value:
            name, _, val = value.partition("=")
            # the SAME filters as job.env: scheduler-owned identity vars
            # and operator-owned names must not be injectable through a
            # docker parameter either (k8s env is last-entry-wins)
            if name not in reserved and name not in blocked_vars:
                env.append({"name": name, "value": val})

    # duplicate mountPaths are rejected by the apiserver; when a USER
    # volume collides with any system mount (sandbox, /dev/shm,
    # checkpoint) or an earlier user volume, the user one is dropped so
    # the job still runs (reference: test_workdir_volume_overlap)
    claimed: Dict[str, Dict] = {}
    for m in mounts:
        if not m["name"].startswith("uservol-"):
            claimed.setdefault(m["mount_path"], m)
    for m in mounts:
        if m["name"].startswith("uservol-"):
            claimed.setdefault(m["mount_path"], m)
    dropped_user = {m["name"] for m in mounts
                    if claimed.get(m["mount_path"]) is not m
                    and m["name"].startswith("uservol-")}
    mounts = [m for m in mounts if claimed.get(m["mount_path"]) is m]
    volumes = [v for v in volumes if v["name"] not in dropped_user]

    containers = [{
        "name": "cook-job",
        "image": image,
        "command": ["/bin/sh", "-c", job.command],
        "env": env,
        "volume_mounts": mounts,
        "resources": {
            "requests": {"cpu": job.resources.cpus,
                         "memory_mb": job.resources.mem,
                         "gpu": job.resources.gpus},
            "limits": {"memory_mb": job.resources.mem,
                       "gpu": job.resources.gpus},
        },
        "working_dir": workdir,
    }]
    if sidecar:
        # progress tracker + sandbox file server (the reference's sidecar,
        # api.clj:1664-1698; our agent/file_server.py is the server):
        # fixed port + command wiring, HTTP readiness probe on the health
        # endpoint, own (non-job) resource requests, read-only sandbox
        # mount, and incremental-config image rollout
        sidecar_image = _resolve_image(incremental, "sidecar-image",
                                       DEFAULT_SIDECAR_IMAGE, job.uuid)
        volumes.append({"name": "cook-sidecar-workdir", "empty_dir": {}})
        containers.append({
            "name": "cook-sidecar",
            "image": sidecar_image,
            "command": ["cook-sidecar", str(SIDECAR_PORT)],
            "ports": [SIDECAR_PORT],
            "env": [{"name": "COOK_JOB_UUID", "value": job.uuid},
                    {"name": "COOK_SANDBOX", "value": COOK_WORKDIR},
                    # DEPRECATED alias of COOK_SANDBOX (reference keeps it
                    # one release for older sidecars, api.clj:1680)
                    {"name": "COOK_WORKDIR", "value": COOK_WORKDIR},
                    {"name": "COOK_FILE_SERVER_PORT",
                     "value": str(SIDECAR_PORT)}],
            "readiness_probe": {"http_get": {"port": SIDECAR_PORT,
                                             "path": SIDECAR_HEALTH_PATH}},
            "resources": {"requests": {"cpu": SIDECAR_CPUS,
                                       "memory_mb": SIDECAR_MEM_MB},
                          "limits": {"memory_mb": SIDECAR_MEM_MB}},
            "volume_mounts": [{"name": "cook-workdir",
                               "mount_path": COOK_WORKDIR,
                               "read_only": True},
                              {"name": "cook-sidecar-workdir",
                               "mount_path": SIDECAR_WORKDIR}],
            "working_dir": SIDECAR_WORKDIR,
        })

    # priority class from the pool (synthetic pods ride a lower class so
    # real pods preempt them; api.clj priority-class handling)
    priority_class = job.labels.get("priority-class",
                                    f"cook-pool-{pool}")

    return {
        "containers": containers,
        "init_containers": init_containers,
        "port_count": job.ports,
        "volumes": volumes,
        "tolerations": tolerations,
        "node_selector": node_selector,
        "priority_class": priority_class,
        "restart_policy": "Never",
        "labels": dict(job.labels),
    }
