"""The port's copy of ``cook_tpu/rest/api.py`` (imports re-rooted).

``CookApi`` drives the port's ``Scheduler``, so every cycle a REST
deployment runs is on the scheduler's device.  ``/debug/health`` diffs
the lock monitor's observed edges against the static edges that the
port's ``analysis/`` computes over the port's own tree.

REST API server.

Re-implements the behavior-bearing endpoint surface of the reference's REST
layer (reference: scheduler/src/cook/rest/api.clj:3640-4019 main-handler)
over the stdlib threading HTTP server:

  POST   /jobs                batch submit (validation, plugins, queue limits,
                              submission rate limit, commit-latch atomicity)
  GET    /jobs?uuid=&user=&state=   query jobs
  GET    /jobs/<uuid>         one job with instances
  DELETE /jobs?uuid=...       kill jobs
  POST   /retry               {"job": uuid, "retries": n}
  GET    /instances/<task-id>
  GET    /queue               per-pool ranked queue (leader only)
  GET    /running             running instances
  GET    /usage?user=         aggregate running usage per pool
  GET/POST/DELETE /share      fair-share admin
  GET/POST/DELETE /quota      quota admin
  GET    /pools
  GET    /unscheduled_jobs?job=uuid
  GET    /failure_reasons
  GET    /stats/instances
  GET    /settings, /info, /debug, /metrics
  GET    /debug/cycles?limit=       flight-recorder CycleRecords
  GET    /debug/trace?trace_id=     Chrome/Perfetto trace-event export
  POST   /progress/<task-id>  sidecar progress callback

AuthN is the reference's composable scheme reduced to HTTP basic / an
X-Cook-User header ("open" mode), with admin checks and impersonation via
X-Cook-Impersonate (reference: rest/authorization.clj, impersonation.clj).
"""

from __future__ import annotations

import base64
import copy
import hmac
import json
import re
import socket
import threading
import time
import urllib.parse
import uuid as uuidlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from ..config import Config
from ..utils import tracing
from . import instrument
from ..policy import PluginRegistry, QueueLimits, RateLimits
from ..sched.scheduler import Scheduler
from ..sched.unscheduled import job_reasons
# re-exported on the REST surface; the store-derived status itself is
# domain logic and lives in the state layer
from ..state.machines import gang_status  # noqa: F401
from ..state.schema import (
    GANG_POLICIES,
    GANG_POLICY_REQUEUE,
    Application,
    Constraint,
    Group,
    GroupPlacementType,
    InstanceStatus,
    Job,
    JobState,
    Reasons,
    Resources,
    new_uuid,
    to_json,
)
from ..state.store import (AbortTransaction, ReplicationIndeterminate,
                           StorageFullError, Store)
from . import task_stats


# (method, path, summary, leader_only) — the documented API surface served
# by _Handler._dispatch; /swagger-docs and /swagger-ui render this table
# (reference: the compojure-api Swagger surface, rest/api.clj:3640-4019).
API_ROUTES = [
    ("GET", "/jobs/{uuid}", "one job with instances", False),
    ("GET", "/jobs", "batch job query by uuid params", False),
    ("POST", "/jobs", "submit a batch of jobs (atomic)", False),
    ("DELETE", "/jobs", "kill jobs by uuid", False),
    ("GET", "/rawscheduler", "deprecated job CRUD (query)", False),
    ("POST", "/rawscheduler", "deprecated job CRUD (submit)", False),
    ("DELETE", "/rawscheduler", "deprecated job CRUD (kill)", False),
    ("GET", "/instances/{task_id}", "one instance", False),
    ("DELETE", "/instances", "kill instances by task id", False),
    ("GET", "/share", "fair-share weights for a user", False),
    ("POST", "/share", "set shares (admin)", False),
    ("DELETE", "/share", "retract shares (admin)", False),
    ("GET", "/quota", "hard caps for a user", False),
    ("POST", "/quota", "set quotas (admin)", False),
    ("DELETE", "/quota", "retract quotas (admin)", False),
    ("GET", "/usage", "a user's running usage per pool", False),
    ("POST", "/retry", "raise retries / requeue a job", False),
    ("GET", "/group", "job group status", False),
    ("DELETE", "/group", "kill a job group", False),
    ("GET", "/list", "query jobs by user/state/time window", False),
    ("GET", "/queue", "ranked pending queues (admin)", True),
    ("GET", "/running", "running instances", False),
    ("GET", "/unscheduled_jobs", "why-unscheduled explanations", True),
    ("GET", "/failure_reasons", "failure reason table", False),
    ("GET", "/stats/instances", "instance statistics", False),
    ("GET", "/settings", "effective scheduler settings", False),
    ("POST", "/settings/rebalancer",
     "update rebalancer params, no restart (admin)", True),
    ("GET", "/pools", "pool listing", False),
    ("GET", "/info", "version + leadership", False),
    ("GET", "/debug", "health + recent tracing spans", False),
    ("GET", "/debug/cycles", "flight-recorder cycle records", False),
    ("GET", "/debug/trace", "Chrome/Perfetto trace-event export", False),
    ("GET", "/debug/faults",
     "active fault points, breaker states, open launch intents", False),
    ("GET", "/debug/replication",
     "replication/failover panel: follower offsets, min_acked, synced "
     "set, candidate positions", False),
    ("GET", "/debug/job/{uuid}/timeline",
     "per-job scheduling audit timeline (why isn't my job running)",
     False),
    ("GET", "/debug/requests",
     "recent + slow REST requests with per-phase breakdown "
     "(redacted params)", False),
    ("GET", "/debug/health",
     "one-shot health roll-up: SLO burn rates, breakers, replication "
     "lag, pipeline depth, repack counters, audit queue depth", False),
    ("GET", "/debug/storage",
     "persistence-integrity panel: per-partition scrub progress, "
     "corruption/repair counters, checkpoint manifest status, mirror "
     "poison state", False),
    ("GET", "/debug/optimizer",
     "goodput optimizer panel: last per-pool decisions, cycle "
     "counts/errors, elastic resize plane state", False),
    ("GET", "/debug/trace/spans",
     "raw local span-ring docs for one trace id — the fleet trace "
     "collector's per-member stitch source", False),
    ("GET", "/debug/fleet",
     "federated fleet panel: per-member health, staleness, burn, "
     "saturation hot-spots, last-scrape age", False),
    ("GET", "/debug/federation/summary",
     "this cell's bounded per-user summary table + host inventory for "
     "a federation front door's global fair-share merge and goodput "
     "routing (never job state)", False),
    ("GET", "/metrics", "Prometheus metrics", False),
    ("GET", "/metrics/fleet",
     "merged fleet exposition: every member's /metrics re-labeled "
     "with instance/role", False),
    ("POST", "/progress/{task_id}", "sidecar progress frames", True),
    ("POST", "/shutdown-leader", "resign leadership (admin)", True),
    ("GET", "/compute-clusters", "dynamic cluster configs", False),
    ("POST", "/compute-clusters/{name}", "create/update/drain a cluster",
     True),
    ("GET", "/incremental-config", "gradual-rollout config values", False),
    ("POST", "/incremental-config", "set rollout portions (admin)", True),
    ("GET", "/swagger-docs", "this API description (OpenAPI)", False),
    ("GET", "/swagger-ui", "human-readable API listing", False),
]


class ApiError(Exception):
    def __init__(self, status: int, message: str,
                 headers: Optional[Dict[str, str]] = None,
                 extra: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}
        # merged into the JSON error body (e.g. the indeterminate-commit
        # contract: {"error": ..., "indeterminate": true, "jobs": [...]})
        self.extra = extra or {}


class RequestUser(str):
    """A resolved request identity: a plain str plus the fact that it was
    reached via X-Cook-Impersonate (admin gating refuses those)."""

    impersonated: bool

    def __new__(cls, name: str, impersonated: bool = False):
        self = super().__new__(cls, name)
        self.impersonated = impersonated
        return self


class _Redirect(Exception):
    def __init__(self, location: str):
        super().__init__(location)
        self.location = location


def job_state_string(store: Store, job: Job,
                     instances: Optional[List] = None) -> str:
    """waiting | running | success | failed — the reference resolves a
    completed job to success/failed from its instances (tools.clj:310-321
    job-ent->state); ``status`` keeps the raw tri-state.  Pass already-
    fetched ``instances`` to avoid re-reading them from the store."""
    if job.state is not JobState.COMPLETED:
        return job.state.value
    if instances is None:
        instances = [i for t in job.instances
                     if (i := store.instance(t)) is not None]
    for inst in instances:
        if inst.status is InstanceStatus.SUCCESS:
            return "success"
    return "failed"


def job_to_json(store: Store, job: Job, include_instances=True,
                gang_cache: Optional[Dict[str, Dict]] = None) -> Dict:
    # fetched once, shared by the state resolution and the instances block;
    # skipped entirely for waiting/running summaries (no reader needs them)
    instances = ([i for t in job.instances
                  if (i := store.instance(t)) is not None]
                 if include_instances or job.state is JobState.COMPLETED
                 else [])
    out = {
        "uuid": job.uuid, "name": job.name, "command": job.command,
        "user": job.user, "priority": job.priority, "pool": job.pool,
        "state": job_state_string(store, job, instances),
        "status": {"waiting": "waiting", "running": "running",
                   "completed": "completed"}[job.state.value],
        "cpus": job.resources.cpus, "mem": job.resources.mem,
        "gpus": job.resources.gpus, "disk": job.resources.disk,
        "max_retries": job.max_retries, "max_runtime": job.max_runtime_ms,
        "submit_time": job.submit_time_ms, "labels": job.labels,
        "env": job.env, "ports": job.ports,
        "container": job.container,
        "groups": [job.group] if job.group else [],
        "constraints": [[c.attribute, c.operator, c.pattern]
                        for c in job.constraints],
        "disable_mea_culpa_retries": job.disable_mea_culpa_retries,
        "uris": job.uris,
        "executor": job.executor,
        "expected_runtime": job.expected_runtime_ms,
        "progress_output_file": job.progress_output_file,
        "progress_regex_string": job.progress_regex_string,
        "datasets": job.datasets,
        "application": ({"name": job.application.name,
                         "version": job.application.version,
                         "workload-class": job.application.workload_class,
                         "workload-id": job.application.workload_id,
                         "workload-details":
                             job.application.workload_details}
                        if job.application else None),
    }
    if job.group is not None:
        if gang_cache is not None and job.group in gang_cache:
            cached = gang_cache[job.group]
            if cached:  # {} marks a known non-gang group
                out["gang"] = {"group": job.group, **cached}
        else:
            group = store.group(job.group)
            if group is not None and group.gang:
                out["gang"] = {"group": group.uuid,
                               **gang_status(store, group,
                                             cache=gang_cache)}
            elif gang_cache is not None:
                gang_cache[job.group] = {}
    if include_instances:
        out["instances"] = [instance_to_json(i) for i in instances]
    return out




def instance_to_json(inst) -> Dict:
    reason = Reasons.by_code(inst.reason_code) if inst.reason_code is not None \
        else None
    return {
        "task_id": inst.task_id, "job_uuid": inst.job_uuid,
        "status": inst.status.value, "hostname": inst.hostname,
        "slave_id": inst.slave_id, "compute_cluster": inst.compute_cluster,
        "start_time": inst.start_time_ms, "end_time": inst.end_time_ms,
        "preempted": inst.preempted, "progress": inst.progress,
        "progress_message": inst.progress_message,
        "exit_code": inst.exit_code, "ports": inst.ports,
        "reason_code": inst.reason_code,
        "reason_string": reason.name if reason else None,
        "mea_culpa": reason.mea_culpa if reason else None,
        "sandbox_directory": inst.sandbox_directory,
        "output_url": inst.output_url,
        "queue_time": inst.queue_time_ms,
    }


# docker parameters forwarded to the container runtime without an operator
# allowlist configured: benign task-shape flags only.  Anything else
# (privileged, volume, cap-add, device, ...) reaches the runtime argv and
# is host-privilege-bearing, so it is DENIED unless explicitly allowlisted
# via TaskConstraints.docker_parameters_allowed.
DEFAULT_DOCKER_PARAMETERS_ALLOWED = (
    "env", "workdir", "label", "user", "entrypoint", "name")


# C0 control characters (plus DEL) in docker parameter keys/values: the
# agent wire format joins key=value pairs with \x1e and the agent splits on
# it, so an embedded \x1e in an ALLOWLISTED parameter's value would inject
# arbitrary extra runtime flags (e.g. ``privileged=``) past the allowlist.
# No legitimate docker flag or value contains control characters.
_CTRL_CHARS = re.compile(r"[\x00-\x1f\x7f]")


def validate_docker_parameters(job: Job, tc) -> None:
    """Docker parameters are validated for EVERY submission (unlike the
    other task constraints, which an operator opts into): they compile to
    container-runtime flags on the agent, so an unvalidated key like
    ``privileged`` would be a privilege escalation.  Both the flat
    ``container.parameters`` and nested ``container.docker.parameters``
    forms are validated (backends read the flat form today, but an
    unvalidated nested list must never sit in the store).  The operator's
    allowlist (tc.docker_parameters_allowed) replaces the conservative
    default when configured (reference: :docker-parameters-allowed,
    rest/api.clj + integration test_disallowed_docker_parameters)."""
    if not isinstance(job.container, dict):
        return
    # the control-character rule (keys reject ALL control chars, values
    # the wire-breaking bytes) has ONE home, check_container_wire_bytes —
    # delegated here so a direct caller of this validator still gets it
    check_container_wire_bytes(job.container)
    flat = job.container.get("parameters") or []
    docker = job.container.get("docker")
    nested = (docker.get("parameters") or []) \
        if isinstance(docker, dict) else []
    # normalize_container aliases the nested list into the flat slot when
    # only the nested form was submitted — skip the alias, validate both
    # lists when they really are distinct
    params = list(flat) + ([] if nested is flat else list(nested))
    allowed = set(tc.docker_parameters_allowed
                  if tc is not None and tc.docker_parameters_allowed
                  is not None else DEFAULT_DOCKER_PARAMETERS_ALLOWED)
    if "*" not in allowed:
        # ["*"] is the explicit allow-all opt-out restoring the reference's
        # unconfigured behavior (rest/api.clj:1097 allows everything when
        # no allowlist is set; here unset means the conservative default —
        # see docs/DEPLOY.md).  Control characters stay rejected above.
        bad = [p.get("key") for p in params
               if isinstance(p, dict) and p.get("key") not in allowed]
        if bad:
            raise ApiError(400, "The following parameters are not "
                                f"supported: {bad}")
    unvalued = [p.get("key") for p in params
                if isinstance(p, dict) and p.get("key")
                and not p.get("value")]
    if unvalued:
        # a bare "--key" would make the runtime consume the IMAGE as the
        # flag's value — reject instead of launching the wrong container
        raise ApiError(400, f"docker parameters {unvalued} require a value")


def validate_task_constraints(job: Job, tc) -> None:
    """Submission-time task-constraint checks, messages mirroring the
    reference (rest/api.clj:1070-1103 validate-and-munge-job)."""
    validate_docker_parameters(job, tc)
    if tc is None:
        return
    if tc.cpus is not None and job.resources.cpus > tc.cpus:
        raise ApiError(400, f"Requested {job.resources.cpus} cpus, but only "
                            f"allowed to use {tc.cpus}")
    if tc.memory_gb is not None and job.resources.mem > 1024 * tc.memory_gb:
        raise ApiError(400, f"Requested {job.resources.mem}mb memory, but "
                            f"only allowed to use {1024 * tc.memory_gb}")
    if tc.max_ports is not None and job.ports > tc.max_ports:
        raise ApiError(400, f"Requested {job.ports} ports, but only allowed "
                            f"to use {tc.max_ports}")
    if tc.retry_limit is not None and job.max_retries > tc.retry_limit:
        raise ApiError(400, f"Requested {job.max_retries} exceeds the "
                            f"maximum retry limit")
    if tc.command_length_limit is not None \
            and len(job.command) > tc.command_length_limit:
        raise ApiError(400, f"Job command length of {len(job.command)} is "
                            f"greater than the maximum command length "
                            f"({tc.command_length_limit})")


def normalize_container(raw) -> Optional[Dict]:
    """Container spec -> the canonical flat form backends consume.

    Accepts both the flat form ({"image", "volumes", "parameters"}) and
    the reference's nested Mesos form ({"type": "docker", "docker":
    {"image", "network", "force-pull-image", "parameters"}, "volumes"},
    rest/api.clj Container/DockerInfo schemas).  The nested ``docker``
    subdict is preserved so validators and clients see what was
    submitted."""
    if not isinstance(raw, dict):
        return raw
    docker = raw.get("docker")
    if not isinstance(docker, dict):
        return raw
    norm = dict(raw)
    norm.setdefault("image", docker.get("image", ""))
    norm.setdefault("parameters", docker.get("parameters", []))
    if docker.get("network") is not None:
        norm.setdefault("network", docker.get("network"))
    return norm


# NUL truncates at the native transport's C-string boundary (everything
# after it in the marshaled channel is silently dropped) and \x1e is that
# transport's intra-channel delimiter (an embedded one injects extra
# env/volume entries).  Neither byte has a legitimate use in a job spec,
# so they are rejected at submission with a 400 instead of surfacing as
# an opaque launch failure per attempt.
_WIRE_BREAKING = re.compile(r"[\x00\x1e]")


def check_env_wire_bytes(env, what: str = "env variable") -> None:
    """Shared by submitted env, operator pool-default env (at boot and at
    merge), and any other KEY=VALUE channel that reaches the wire."""
    for k, v in (env.items() if isinstance(env, dict) else ()):
        if _WIRE_BREAKING.search(str(k)) or _WIRE_BREAKING.search(str(v)):
            raise ApiError(400, f"{what} {k!r} contains NUL or "
                                "field-separator control characters")


def check_container_wire_bytes(container) -> None:
    """Volumes, image, and docker parameters reach the \\x1e/NUL-sensitive
    wire; used for both submitted containers and operator pool-default
    containers (the latter attach after the per-spec pass).  Malformed
    shapes are skipped here — the parse path's own type errors surface as
    400 malformed-spec."""
    if not isinstance(container, dict):
        return
    params = [*(container.get("parameters") or []),
              *((container.get("docker") or {}).get("parameters") or []
                if isinstance(container.get("docker"), dict) else [])]
    for p in params:
        # same rule validate_docker_parameters applies: keys reject ALL
        # control characters (they compile to --key flags), values the
        # wire-breaking bytes — so an operator default that would 400 a
        # submitter is caught here (at boot / as a 500) first
        if isinstance(p, dict) and (
                _CTRL_CHARS.search(str(p.get("key") or ""))
                or _WIRE_BREAKING.search(str(p.get("value") or ""))):
            raise ApiError(400, "docker parameters must not contain "
                                "control characters")
    vols = container.get("volumes", [])
    for v in (vols if isinstance(vols, (list, tuple)) else []):
        # dict form ({"host-path", "container-path"}) is checked value by
        # value — serializing it would escape the raw bytes out of reach
        parts = [v] if isinstance(v, str) else \
            [str(x) for x in v.values()] if isinstance(v, dict) else \
            [str(v)]
        if any(_WIRE_BREAKING.search(p) for p in parts):
            raise ApiError(400, "container volumes must not contain NUL "
                                "or field-separator control characters")
    images = [container.get("image", ""),
              (container.get("docker") or {}).get("image", "")
              if isinstance(container.get("docker"), dict) else ""]
    if any(_WIRE_BREAKING.search(str(i)) for i in images if i):
        raise ApiError(400, "container image must not contain NUL or "
                            "field-separator control characters")


def _reject_wire_breaking_bytes(spec: Dict) -> None:
    check_env_wire_bytes(spec.get("env"))
    check_container_wire_bytes(spec.get("container"))
    if _WIRE_BREAKING.search(str(spec.get("command", ""))):
        raise ApiError(400, "command must not contain NUL or "
                            "field-separator control characters")
    for fld in ("uuid", "group", "name"):
        # exported into the wire env (COOK_JOB_UUID/COOK_JOB_GROUP_UUID)
        if _WIRE_BREAKING.search(str(spec.get(fld) or "")):
            raise ApiError(400, f"{fld} must not contain NUL or "
                                "field-separator control characters")
    uris = spec.get("uris")
    for u in (uris if isinstance(uris, (list, tuple)) else []):
        # uri values splice into the wire command as the fetch prelude
        val = u.get("value", "") if isinstance(u, dict) else u
        if _WIRE_BREAKING.search(str(val)):
            raise ApiError(400, "uri values must not contain NUL or "
                                "field-separator control characters")
    for fld in ("progress_output_file", "progress_regex_string"):
        # exported into the wire env for the progress-tracking executor
        if _WIRE_BREAKING.search(str(spec.get(fld) or "")):
            raise ApiError(400, f"{fld} must not contain NUL or "
                                "field-separator control characters")


def parse_job_spec(spec: Dict, user: str, default_pool: str) -> Job:
    """Submission schema -> Job (reference: make-job-txn rest/api.clj:750)."""
    if "command" not in spec:
        raise ApiError(400, "job is missing command")
    _reject_wire_breaking_bytes(spec)
    priority = int(spec.get("priority", 50))
    if not 0 <= priority <= 100:
        raise ApiError(400, "priority must be in [0, 100]")
    constraints = []
    for c in spec.get("constraints", []):
        if len(c) != 3:
            raise ApiError(400, f"malformed constraint {c}")
        constraints.append(Constraint(c[0], c[1], c[2]))
    try:
        return Job(
            uuid=spec.get("uuid") or new_uuid(),
            user=user,
            command=spec["command"],
            name=spec.get("name", "cookjob"),
            resources=Resources(
                cpus=float(spec.get("cpus", 1.0)),
                mem=float(spec.get("mem", 128.0)),
                gpus=float(spec.get("gpus", 0.0)),
                disk=float(spec.get("disk", 0.0))),
            priority=priority,
            max_retries=int(spec.get("max_retries", 1)),
            max_runtime_ms=int(spec.get("max_runtime", 2**53)),
            pool=spec.get("pool", default_pool),
            labels=dict(spec.get("labels", {})),
            env=dict(spec.get("env", {})),
            container=normalize_container(spec.get("container")),
            ports=int(spec.get("ports", 0)),
            uris=[u if isinstance(u, dict) else {"value": u}
                  for u in spec.get("uris", [])],
            executor=spec.get("executor", ""),
            expected_runtime_ms=(int(spec["expected_runtime"])
                                 if spec.get("expected_runtime") is not None
                                 else None),
            progress_output_file=spec.get("progress_output_file", ""),
            progress_regex_string=spec.get("progress_regex_string", ""),
            datasets=list(spec.get("datasets", [])),
            application=(Application(
                name=spec["application"].get("name", ""),
                version=spec["application"].get("version", ""),
                workload_class=spec["application"].get("workload-class", ""),
                workload_id=spec["application"].get("workload-id", ""),
                workload_details=spec["application"].get(
                    "workload-details", ""))
                if isinstance(spec.get("application"), dict) else None),
            constraints=constraints,
            group=spec.get("group"),
            disable_mea_culpa_retries=bool(
                spec.get("disable_mea_culpa_retries", False)),
        )
    except (TypeError, ValueError) as e:
        raise ApiError(400, f"malformed job spec: {e}")


def parse_group_spec(gspec: Dict, job_uuids: List[str]) -> Group:
    """Group submission schema -> Group, including host-placement,
    straggler-handling (reference: rest/api.clj:489-514 HostPlacement/
    StragglerHandling schemas + :925 make-group-txn), and the gang block
    (docs/GANG.md): ``{"gang": {"size": N, "topology": attr?,
    "policy": "requeue"|"kill", "min": M?, "max": X?}}`` declares an
    all-or-nothing multi-host slice job; ``min``/``max`` relax it to an
    ELASTIC gang legal at any member count in ``[min, max]``
    (docs/GANG.md elasticity; ``1 <= min <= max <= size``, both default
    to ``size`` — the rigid contract).  Malformed gang specs are a
    clear 400."""
    try:
        group = Group(uuid=gspec["uuid"],
                      name=gspec.get("name", "defaultgroup"),
                      jobs=job_uuids)
        gang = gspec.get("gang")
        if gang is not None:
            if not isinstance(gang, dict):
                raise ApiError(400, "gang must be an object like "
                                    '{"size": N}')
            size = gang.get("size")
            if not isinstance(size, int) or isinstance(size, bool) \
                    or size < 1:
                raise ApiError(400, "gang.size must be an integer >= 1")
            topology = gang.get("topology")
            if topology is not None and (
                    not isinstance(topology, str) or not topology):
                raise ApiError(400, "gang.topology must be a non-empty "
                                    "host attribute name")
            policy = gang.get("policy", GANG_POLICY_REQUEUE)
            if policy not in GANG_POLICIES:
                raise ApiError(
                    400, f"gang.policy must be one of {GANG_POLICIES}")
            unknown = set(gang) - {"size", "topology", "policy",
                                   "min", "max"}
            if unknown:
                raise ApiError(400, "unknown gang spec key(s): "
                                    f"{sorted(unknown)}")
            # elastic bounds (docs/GANG.md elasticity): unset = rigid
            lo = gang.get("min", 0)
            hi = gang.get("max", 0)
            for key, v in (("min", lo), ("max", hi)):
                if key in gang and (not isinstance(v, int)
                                    or isinstance(v, bool) or v < 1):
                    raise ApiError(400, f"gang.{key} must be an integer "
                                        ">= 1 (or omitted)")
            if (lo or size) > (hi or size):
                raise ApiError(400, "gang.min must be <= gang.max")
            if lo > size or hi > size:
                raise ApiError(
                    400, "gang.min/gang.max cannot exceed gang.size — "
                         "the co-submitted members ARE the maximum "
                         "membership (docs/GANG.md elasticity)")
            group.gang = True
            group.gang_size = size
            group.gang_topology = topology
            group.gang_policy = policy
            group.gang_min = lo
            group.gang_max = hi
        hp = gspec.get("host-placement") or gspec.get("host_placement")
        if hp:
            try:
                group.placement_type = GroupPlacementType(
                    hp.get("type", "all"))
            except ValueError:
                raise ApiError(
                    400, f"unknown host-placement type {hp.get('type')}")
            params = hp.get("parameters") or {}
            group.placement_attribute = params.get("attribute")
            if group.placement_type is GroupPlacementType.ATTRIBUTE_EQUALS \
                    and not group.placement_attribute:
                raise ApiError(400, "attribute-equals host-placement "
                                    "requires parameters.attribute")
            if params.get("minimum") is not None:
                group.placement_minimum = int(params["minimum"])
        sh = gspec.get("straggler-handling") or gspec.get("straggler_handling")
        if sh:
            if sh.get("type") not in (None, "none", "quantile-deviation"):
                raise ApiError(
                    400,
                    f"unknown straggler-handling type {sh.get('type')}")
            if sh.get("type") == "quantile-deviation":
                params = sh.get("parameters") or {}
                quantile = float(params.get("quantile", 0.5))
                multiplier = float(params.get("multiplier", 2.0))
                if not 0.0 < quantile < 1.0:
                    raise ApiError(400,
                                   "straggler quantile must be in (0, 1)")
                if multiplier < 1.0:
                    raise ApiError(400, "straggler multiplier must be >= 1")
                group.straggler_quantile = quantile
                group.straggler_multiplier = multiplier
        return group
    except (TypeError, ValueError, AttributeError, KeyError) as e:
        raise ApiError(400, f"malformed group spec: {e}")


class CookApi:
    """Request-handling core, separable from the HTTP plumbing for tests."""

    def __init__(self, store: Store, scheduler: Optional[Scheduler] = None,
                 config: Optional[Config] = None,
                 plugins: Optional[PluginRegistry] = None,
                 rate_limits: Optional[RateLimits] = None,
                 queue_limits: Optional[QueueLimits] = None,
                 admins: Optional[List[str]] = None,
                 impersonators: Optional[List[str]] = None,
                 elector=None, node_url: str = "",
                 basic_auth_users: Optional[Dict[str, str]] = None,
                 cors_origins: Optional[List[str]] = None,
                 authenticators: Optional[List] = None,
                 ip_requests_per_minute: Optional[float] = None):
        from ..policy.incremental import IncrementalConfig
        self.store = store
        self.scheduler = scheduler
        self.config = config or (scheduler.config if scheduler else Config())
        self.plugins = plugins or (scheduler.plugins if scheduler
                                   else PluginRegistry())
        self.rate_limits = rate_limits or (
            scheduler.rate_limits if scheduler else RateLimits())
        self.queue_limits = queue_limits
        self.admins = set(admins or [])
        self.impersonators = set(impersonators or [])
        # HA: api-only nodes redirect leader-only requests (307) to the
        # elected leader (reference: leader-redirect, api-only? config.clj:692)
        self.elector = elector
        self.node_url = node_url
        # socket-replication surfaces (set by the daemon): the leader's
        # ReplicationServer / a standby's ReplicationFollower, and the
        # fence guard that flips the write path to 503/redirect the
        # moment a successor mints a higher election epoch
        self.repl_server = None
        self.repl_follower = None
        #: per-partition ReplicationServers on a partitioned leader
        #: (each partition replicates its own journal to its own
        #: synced-standby set; surfaced on /debug/replication and as
        #: partition-labeled cook_replication_lag_bytes series)
        self.partition_repl_servers: List = []
        self.repl_dir: Optional[str] = None
        self.fence_guard: Optional[Callable[[], bool]] = None
        # follower read fleet (state/read_replica.py, set by the daemon
        # on replication standbys): a live journal-applied store this
        # node serves bounded-staleness GETs from instead of
        # 307-redirecting them to the leader (docs/DEPLOY.md)
        self.read_view = None
        self.follower_reads = 0
        # fleet observability plane (sched/fleet.py, set by the daemon):
        # the FleetScraper behind /metrics/fleet + /debug/fleet and the
        # stitched /debug/trace fan-out, and this node's span identity
        # (every request's spans record under it — the per-process
        # track key of the fleet Perfetto export)
        self.fleet = None
        self.instance: Optional[str] = None
        # HTTP-level per-client-IP throttle (reference: ip-rate-limit
        # middleware wrapping the handler, components.clj:214-221);
        # None = unlimited
        self.ip_limiter = None
        if ip_requests_per_minute:
            from ..policy.rate_limit import TokenBucketRateLimiter
            self.ip_limiter = TokenBucketRateLimiter(
                tokens_per_minute=float(ip_requests_per_minute),
                bucket_size=float(ip_requests_per_minute))
        # layered admission front door (config.AdmissionConfig +
        # sched/admission.py): the admission section can supply both the
        # per-IP bucket (when the daemon-level knob is absent) and the
        # per-user submission bucket; the scheduler's AdmissionController
        # — when one exists — gets handles to BOTH so the adaptive level
        # scales their refill rates under pressure
        ac = self.config.admission
        if ac.enabled:
            from ..policy.rate_limit import (TokenBucketRateLimiter,
                                             submission_limiter)
            if self.ip_limiter is None and ac.ip_requests_per_minute > 0:
                self.ip_limiter = TokenBucketRateLimiter(
                    tokens_per_minute=ac.ip_requests_per_minute,
                    bucket_size=ac.ip_requests_per_minute)
            if not getattr(self.rate_limits.job_submission, "enforce",
                           False):
                self.rate_limits.job_submission = submission_limiter(ac)
        ctrl = scheduler.admission if scheduler is not None else None
        if ctrl is not None:
            ctrl.rate_limits = self.rate_limits
            if self.ip_limiter is not None:
                ctrl.ip_limiter = self.ip_limiter
            ctrl._apply_level()
        self.incremental = IncrementalConfig()
        # HTTP-basic verification (reference: basic_auth.clj). None = "open"
        # mode: the username is taken from Basic/X-Cook-User unverified.
        self.basic_auth_users = basic_auth_users
        # Pluggable scheme chain (reference: spnego/basic/open composition,
        # components.clj:266-284). When set, authentication is mandatory.
        # basic_auth_users is sugar for a single-Basic chain so verified
        # basic auth has exactly one code path.
        from .auth import AuthChain, BasicAuthenticator
        if authenticators:
            self.auth_chain = AuthChain(authenticators)
        elif basic_auth_users is not None:
            self.auth_chain = AuthChain(
                [BasicAuthenticator(dict(basic_auth_users))])
        else:
            self.auth_chain = None
        # CORS allowed-origin regexes (reference: cors.clj; same-origin
        # requests are always allowed, cross-origin must match a pattern)
        self.cors_origins = [re.compile(p) for p in (cors_origins or [])]
        # serving-plane request observability (rest/instrument.py): the
        # module singleton, sized/armed from the "http" config section
        self.request_obs = instrument.request_log
        self.request_obs.configure(self.config.http)

    def origin_allowed(self, origin: str) -> bool:
        return any(rx.fullmatch(origin) for rx in self.cors_origins)

    def check_basic_auth(self, user: str, password: str) -> bool:
        want = (self.basic_auth_users or {}).get(user)
        return want is not None and hmac.compare_digest(want, password)

    def leader_redirect_target(self) -> Optional[str]:
        """Non-None when this node must redirect scheduler-state requests."""
        if self.scheduler is not None or self.elector is None:
            return None
        url = self.elector.leader_url()
        if url and url != self.node_url:
            return url
        return None

    # ------------------------------------------------------- admission
    def admission_controller(self):
        return self.scheduler.admission if self.scheduler is not None \
            else None

    def brownout_stage(self) -> int:
        """The brownout stage this node acts on: the live controller on
        the leader; on followers, the journaled dynamic-config document
        replicated into the read view's mirror (stage flips ride
        ordinary ``"w"`` records, so standbys see them at replication
        latency)."""
        ctrl = self.admission_controller()
        if ctrl is not None:
            return ctrl.stage
        from ..sched.admission import stage_from_store
        rv = self.read_view
        rv_store = getattr(rv, "store", None) if rv is not None else None
        if rv_store is not None:
            return stage_from_store(rv_store)
        return stage_from_store(self.store)

    def admission_state(self) -> Dict:
        """The /debug/health "admission" block on ANY role."""
        ctrl = self.admission_controller()
        if ctrl is not None:
            return ctrl.state()
        from ..sched.admission import STAGE_NAMES
        stage = self.brownout_stage()
        return {"enabled": bool(self.config.admission.enabled),
                "level": None, "stage": stage,
                "stage_name": STAGE_NAMES[stage]}

    # ------------------------------------------------------------------ auth
    def require_admin(self, user: str, message: Optional[str] = None) -> None:
        # an impersonator acting AS an admin may not reach admin endpoints
        # (reference: impersonation.clj object-type->verb table admits no
        # admin verbs; integration test_cannot_impersonate_admin_endpoints)
        if getattr(user, "impersonated", False):
            raise ApiError(403, "impersonated requests may not use "
                                "admin endpoints")
        if self.admins and user not in self.admins:
            raise ApiError(403, message or f"{user} is not authorized")

    def resolve_user(self, auth_user: str, impersonate: Optional[str]) -> str:
        """The effective request identity (reference: impersonation.clj).

        Only configured impersonators may impersonate — being an admin
        grants nothing here (test_admin_cannot_impersonate), and
        self-impersonation is treated as a plain non-impersonated request
        (test_self_impersonate)."""
        if impersonate and impersonate != auth_user:
            if auth_user not in self.impersonators:
                raise ApiError(403, f"{auth_user} may not impersonate")
            return RequestUser(impersonate, impersonated=True)
        return auth_user

    # ---------------------------------------------------------------- routes
    def _admit_submission(self, specs: List[Dict], user: str,
                          idempotent: bool = False) -> None:
        """The submission front door (the overload ladder): every
        rejection is a 429 with a machine-readable ``reason`` +
        ``scope`` in the body and an honest ``Retry-After`` header, so
        clients back off instead of stampeding.  Order: brownout write
        shed (cheapest, and the explicit overload gate) -> per-user
        token bucket (refill scaled by the admission level) -> GLOBAL
        per-user pending cap off the bounded summary exchange."""
        from ..utils.metrics import registry

        def _reject(reason: str, scope: str, message: str,
                    retry_s: float) -> None:
            registry.counter_inc("cook_admission_rejections", 1.0,
                                 {"scope": scope, "reason": reason})
            retry = max(1, min(int(retry_s) + 1, 3600))
            raise ApiError(429, message,
                           extra={"reason": reason, "scope": scope},
                           headers={"Retry-After": str(retry)})

        ac = self.config.admission
        if ac.enabled and self.brownout_stage() >= 3:
            # stage 3 sheds LOW-PRIORITY writes only; a batch with any
            # at-or-above-threshold job rides the committed-write path,
            # which never sheds
            if all(int(s.get("priority", 50)) < ac.shed_priority_below
                   for s in specs):
                _reject("brownout-shed", "user",
                        "the cluster is shedding low-priority writes "
                        "under overload (brownout stage 3); retry "
                        "later or raise job priority",
                        ac.stage_hold_seconds)
        rl = self.rate_limits.job_submission
        if rl.enforce and rl.get_token_count(user) < len(specs):
            _reject("rate-limited", "user",
                    "job submission rate limit exceeded",
                    rl.retry_after_s(user, len(specs)))
        if ac.enabled and ac.max_user_pending > 0 and not idempotent:
            # idempotent retries are exempt: their jobs may already be
            # journaled and counted by the summaries — charging them
            # again would strand a user at cap unable to heal an
            # ambiguous submission (same principle as the quota gate)
            # GLOBAL pending cap, partitions included: the bounded
            # per-user summary exchange (state/partition.py) is the only
            # cross-partition signal — counts, never job state.  A
            # single store answers from its own summary.
            summaries = getattr(self.store, "summaries", None)
            if summaries is not None:
                pending = summaries.user_totals(str(user))["pending"]
            else:
                u = self.store.user_summary().get(str(user))
                pending = u["pending"] if u else 0.0
            if pending + len(specs) > ac.max_user_pending:
                _reject("user-pending-cap", "global",
                        f"user {user} has {int(pending)} pending jobs; "
                        f"admitting {len(specs)} more would exceed the "
                        f"global cap of {ac.max_user_pending}",
                        ac.stage_hold_seconds)

    def submit_jobs(self, body: Dict, user: str) -> Dict:
        specs = body.get("jobs", [])
        if not specs:
            raise ApiError(400, "no jobs to submit")
        pool_override = body.get("pool")
        self._admit_submission(specs, user,
                               idempotent=bool(body.get("idempotent")))
        jobs = []
        # request trace context (the http.request ingress span, itself
        # parented under a client-sent traceparent): stamped on every job
        # so the submission request stays joinable to the job's audit
        # lifecycle and the launching cycle (docs/OBSERVABILITY.md)
        _cur = tracing.tracer.current()
        req_trace = _cur.trace_id if _cur is not None else None
        for spec in specs:
            job = parse_job_spec(spec, user, self.config.default_pool)
            if req_trace:
                job.trace_id = req_trace
            validate_task_constraints(job, self.config.task_constraints)
            for uri in job.uris:
                if uri.get("executable") and uri.get("extract"):
                    raise ApiError(
                        400, "Uri cannot set executable and extract")
            if pool_override:
                job.pool = pool_override
            job.pool = self.plugins.pool_selector.select(
                job, self.config.default_pool)
            # pool-regex planes, applied with the EFFECTIVE pool known
            # (reference: rest/api.clj:719-738 default container / gpu
            # model / default env resolution per pool)
            if job.container is None:
                default = self.config.default_container_for_pool(job.pool)
                if default:
                    job.container = normalize_container(
                        copy.deepcopy(default))
                    # the default was attached AFTER the per-spec
                    # validation pass — it must clear the same wire-byte
                    # and allowlist checks a direct submission would, but
                    # ANY violation here is the operator's plane, not the
                    # submitter's (clean) spec: surface every one as 500
                    try:
                        check_container_wire_bytes(job.container)
                        validate_docker_parameters(
                            job, self.config.task_constraints)
                    except ApiError as exc:
                        raise ApiError(
                            500, "pool default container is "
                                 f"misconfigured: {exc.message}")
            default_env = self.config.default_env_for_pool(job.pool)
            if default_env:
                # same wire-byte rule the submitted env already cleared.
                # Daemon boot refuses such config (_check_plane_wire_bytes);
                # this guards programmatic Config mutation, and it is a
                # SERVER error — the submitter's spec is clean
                try:
                    check_env_wire_bytes(default_env,
                                         what="pool default env variable")
                except ApiError as exc:
                    raise ApiError(
                        500, f"misconfigured: {exc.message}")
                job.env = {**default_env, **job.env}  # job's values win
            if job.resources.gpus:
                models = self.config.gpu_models_for_pool(job.pool)
                if models is not None:
                    model = job.labels.get("gpu-model", "")
                    if model not in models:
                        raise ApiError(
                            400, f"The following GPU model is not supported "
                                 f"in pool {job.pool}: {model or '(none)'}")
            deny = self.plugins.validate_submission(job)
            if deny:
                raise ApiError(400, f"job {job.uuid}: {deny}")
            jobs.append(self.plugins.modify_submission(job))
        by_pool: Dict[str, int] = {}
        for job in jobs:
            by_pool[job.pool] = by_pool.get(job.pool, 0) + 1
        if self.queue_limits is not None:
            for pool, n in by_pool.items():
                msg = self.queue_limits.check_submission(pool, user, n)
                if msg:
                    raise ApiError(422, msg)
        # cross-partition per-user quota (partitioned write plane,
        # state/partition.py): a finite count quota on the reserved
        # pool "*" caps the user's TOTAL footprint across every
        # partition, enforced off the bounded-staleness summary
        # exchange — never by shipping job state between partitions
        prior_jobs: Dict[str, Any] = {}
        if body.get("idempotent"):
            # an indeterminate-retry resubmits uuids that may already
            # be journaled; ONE membership pass feeds both the quota
            # gate here and the existing/to_create split below
            for j in jobs:
                prior = self.store.job(j.uuid)
                if prior is not None:
                    prior_jobs[j.uuid] = prior
        check_global = getattr(self.store, "check_user_quota", None)
        if check_global is not None:
            # only truly-new jobs consume quota headroom — the
            # already-journaled ones are counted by the summary
            # exchange, and charging them again would leave a user at
            # cap unable to heal their own ambiguous submission
            n_new = sum(1 for j in jobs if j.uuid not in prior_jobs)
            msg = check_global(str(user), n_new) if n_new else None
            if msg:
                raise ApiError(422, msg)
        groups = []
        for gspec in body.get("groups", []):
            guuid = gspec.get("uuid")
            if not guuid:
                raise ApiError(400, "groups must carry a uuid so jobs can "
                                    "reference them")
            group = parse_group_spec(
                gspec, [j.uuid for j in jobs if j.group == guuid])
            if group.gang:
                # a gang launches all-or-nothing, so its members must be
                # co-submitted: exactly gang_size jobs in this batch, and
                # never trickled onto an existing gang group
                if len(group.jobs) != group.gang_size:
                    raise ApiError(
                        400, f"gang group {guuid} declares size "
                             f"{group.gang_size} but the batch carries "
                             f"{len(group.jobs)} member job(s); gang "
                             "members must be submitted together")
                # all members must resolve to ONE pool (per-spec pool
                # overrides and the pool-selector plugin can split
                # them): each pool's queue would hold a strict subset,
                # so cohort admission defers the gang every cycle with
                # a misleading members-missing diagnosis
                member_pools = {j.pool for j in jobs
                                if j.group == guuid}
                if len(member_pools) > 1:
                    raise ApiError(
                        400, f"gang group {guuid} members resolve to "
                             f"multiple pools {sorted(member_pools)}; "
                             "a gang schedules within one pool")
                # an idempotent retry resends the SAME batch after an
                # indeterminate commit — the group legitimately exists
                # and its member set MATCHES, so it passes this check on
                # its own; the idempotent flag must not bypass it (a
                # "retry" carrying novel members would merge into the
                # group and grow the gang past gang_size)
                existing_group = self.store.group(guuid)
                if existing_group is not None and existing_group.jobs \
                        and set(existing_group.jobs) != set(group.jobs):
                    raise ApiError(
                        400, f"group {guuid} already exists; gang "
                             "members cannot be added incrementally")
            groups.append(group)
        # the no-incremental-members rule must also hold for jobs that
        # reference a PRE-EXISTING gang group without a groups entry in
        # this batch: such a job would skip every gang check above and
        # ride the gang's cohort as a phantom extra member (counted by
        # the reduction, invisible to the gang policy)
        batch_guuids = {g.uuid for g in groups}
        ref_cache: Dict[str, object] = {}
        for job in jobs:
            if not job.group or job.group in batch_guuids:
                continue
            if job.group not in ref_cache:
                ref_cache[job.group] = self.store.group(job.group)
            existing = ref_cache[job.group]
            if existing is not None and existing.gang \
                    and not (body.get("idempotent")
                             and job.uuid in (existing.jobs or [])):
                raise ApiError(
                    400, f"group {job.group} is a gang; gang members "
                         "cannot be added incrementally")
        all_uuids = [j.uuid for j in jobs]

        def _indeterminate(exc: Exception) -> ApiError:
            # HTTP 504 + ambiguous-outcome body: the batch is journaled
            # locally but unconfirmed on the mirror.  The uuids let the
            # client retry the SAME logical submission ("idempotent":
            # true) after a failover — neither losing nor duplicating.
            return ApiError(504, str(exc),
                            extra={"indeterminate": True,
                                   "jobs": all_uuids})

        to_create = jobs
        if body.get("idempotent"):
            # retry of an indeterminate submission: jobs that survived
            # (or were stranded mid-latch by the ambiguous commit) count
            # as successes and are made visible; only the rest are
            # created.  Keyed on job uuid — the idempotency unit.
            existing, to_create = [], []
            for job in jobs:
                prior = prior_jobs.get(job.uuid)
                if prior is None:
                    to_create.append(job)
                elif prior.user != user:
                    raise ApiError(409, f"job {job.uuid} exists and "
                                        "belongs to another user")
                else:
                    existing.append(job.uuid)
            if existing:
                try:
                    self.store.commit_jobs(existing)
                except ReplicationIndeterminate as e:
                    raise _indeterminate(e)
        if to_create:
            # atomic batch visibility via commit latch (metatransaction)
            latch = new_uuid()
            try:
                self.store.create_jobs(to_create, groups=groups,
                                       latch=latch)
            except AbortTransaction as e:
                raise ApiError(409, e.reason)
            except ReplicationIndeterminate as e:
                # the jobs ARE installed locally (uncommitted); try to
                # finish the latch so they aren't stranded invisible —
                # a second indeterminate outcome changes nothing the
                # client's retry can't heal via the idempotent path
                try:
                    self.store.commit_latch(latch)
                except ReplicationIndeterminate:
                    pass
                raise _indeterminate(e)
            try:
                self.store.commit_latch(latch)
            except ReplicationIndeterminate as e:
                raise _indeterminate(e)
        self.rate_limits.job_submission.spend(user, len(specs))
        return {"jobs": all_uuids}

    def get_jobs(self, params: Dict) -> List[Dict]:
        uuids = params.get("uuid", [])
        if uuids:
            # partial=true: return the found subset as long as at least one
            # uuid resolves, instead of 404ing the whole query (reference:
            # rest/api.clj:1391-1415 retrieve-jobs allow-partial-results)
            partial = first(params.get("partial"), "false") == "true"
            out = []
            gang_cache: Dict[str, Dict] = {}
            for uuid in uuids:
                job = self.store.job(uuid)
                if job is None:
                    if partial:
                        continue
                    raise ApiError(404, f"no such job {uuid}")
                out.append(job_to_json(self.store, job,
                                       gang_cache=gang_cache))
            if not out:
                raise ApiError(404, f"no such jobs {uuids}")
            return out
        user = first(params.get("user"))
        states = parse_states(params)
        jobs = self.store.jobs_where(
            lambda j: (user is None or j.user == user)
            and job_matches_states(self.store, j, states))
        gang_cache: Dict[str, Dict] = {}
        return [job_to_json(self.store, j, include_instances=False,
                            gang_cache=gang_cache)
                for j in jobs]

    def kill_jobs(self, params: Dict, user: str) -> Dict:
        uuids = params.get("uuid", [])
        if not uuids:
            raise ApiError(400, "no uuids given")
        for uuid in uuids:
            job = self.store.job(uuid)
            if job is None:
                raise ApiError(404, f"no such job {uuid}")
            if job.user != user:
                self.require_admin(user)
        for uuid in uuids:
            self.store.kill_job(uuid)
        return {"killed": uuids}

    def retry(self, body: Dict, user: str, deprecated: bool = True) -> Dict:
        """POST (deprecated: job/jobs + retries/increment only) and PUT
        (adds groups + failed_only) /retry (reference: rest/api.clj:2470-2650
        UpdateRetriesRequest + validate-retries + check-jobs-exist).

        failed_only defaults to True when groups are given, False otherwise
        (api.clj:2569-2573's backwards-compatible default)."""
        if body.get("job") is not None and body.get("jobs") is not None:
            raise ApiError(400, 'Can\'t specify both "job" and "jobs".')
        uuids = body.get("jobs") or ([body["job"]] if body.get("job") else [])
        if deprecated and body.get("groups"):
            raise ApiError(400, 'POST /retry does not support "groups"; '
                                "use PUT.")
        groups = [] if deprecated else (body.get("groups") or [])
        if not uuids and not groups:
            raise ApiError(400, "Need to specify at least 1 job or group.")
        retries = body.get("retries")
        increment = body.get("increment")
        if retries is None and increment is None:
            raise ApiError(400, "Need to specify either retries or increment.")
        if retries is not None and increment is not None:
            raise ApiError(400, "Can't specify both retries and increment.")
        try:
            retries = int(retries) if retries is not None else None
            increment = int(increment) if increment is not None else None
        except (TypeError, ValueError):
            raise ApiError(400, "retries/increment must be integers")
        tc = self.config.task_constraints
        limit = tc.retry_limit if tc is not None else None
        if retries is not None and limit is not None and retries > limit:
            raise ApiError(400, f"'retries' exceeds the maximum retry limit "
                                f"of {limit}")

        failed_only = body.get("failed_only", body.get("failed-only"))
        if failed_only is None:
            failed_only = bool(groups)

        # resolve + authorize every named job/group before touching any
        all_jobs: List[Job] = []
        for uuid in uuids:
            job = self.store.job(uuid)
            if job is None:
                raise ApiError(404,
                               f"UUID {uuid} does not correspond to a job.")
            if job.user != user:
                self.require_admin(
                    user, f"You are not authorized to retry job {uuid}.")
            all_jobs.append(job)
        for guuid in groups:
            group = self.store.group(guuid)
            if group is None:
                raise ApiError(404,
                               f"UUID {guuid} does not correspond to a group.")
            gjobs = [j for j in (self.store.job(u) for u in group.jobs)
                     if j is not None]
            if any(j.user != user for j in gjobs):
                self.require_admin(
                    user, "You are not authorized to retry jobs from "
                          f"group {guuid}.")
            all_jobs.extend(gjobs)

        seen = set()
        targets = []
        for job in all_jobs:
            if job.uuid in seen:
                continue
            seen.add(job.uuid)
            if failed_only \
                    and job_state_string(self.store, job) != "failed":
                continue
            targets.append(job)

        if increment is not None:
            if limit is not None and any(j.max_retries + increment > limit
                                         for j in targets):
                raise ApiError(400, "Increment would exceed the maximum "
                                    f"retry limit of {limit}")
        else:
            for job in targets:
                insts = {t: i for t in job.instances
                         if (i := self.store.instance(t)) is not None}
                if job.attempts_used(insts) > retries:
                    raise ApiError(
                        400, "Retries would be less than attempts-consumed")
        for job in targets:
            new_retries = (job.max_retries + increment
                           if increment is not None else retries)
            self.store.retry_job(job.uuid, new_retries)
        out: Dict[str, Any] = {"jobs": [j.uuid for j in targets],
                               "retries": retries, "increment": increment}
        if body.get("job") is not None:
            # the deprecated single-job POST contract returned {job, retries}
            out["job"] = body["job"]
        return out

    def kill_instances(self, params: Dict, user: str) -> Dict:
        """DELETE /instances?uuid=task-id — kill individual instances
        without aborting the job (reference: rest/api.clj instance kill)."""
        task_ids = params.get("uuid", [])
        if not task_ids:
            raise ApiError(400, "no uuids given")
        for tid in task_ids:
            inst = self.store.instance(tid)
            if inst is None:
                raise ApiError(404, f"no such instance {tid}")
            job = self.store.job(inst.job_uuid)
            if job is not None and job.user != user:
                self.require_admin(user)
        killed = []
        for tid in task_ids:
            inst = self.store.instance(tid)
            if inst.status in (InstanceStatus.UNKNOWN, InstanceStatus.RUNNING):
                if self.scheduler is not None:
                    self.scheduler.kill_instance(
                        tid, Reasons.KILLED_BY_USER.code)
                else:
                    self.store.update_instance_status(
                        tid, InstanceStatus.FAILED,
                        reason_code=Reasons.KILLED_BY_USER.code)
                killed.append(tid)
        return {"killed": killed}

    def group_get(self, params: Dict) -> List[Dict]:
        """GET /group?uuid=...&detailed=true (reference: rest/api.clj
        read-groups-handler)."""
        uuids = params.get("uuid", [])
        if not uuids:
            raise ApiError(400, "no uuids given")
        detailed = first(params.get("detailed"), "false") == "true"
        partial = first(params.get("partial"), "false") == "true"
        out = []
        for uuid in uuids:
            group = self.store.group(uuid)
            if group is None:
                if partial:
                    continue
                raise ApiError(404, f"no such group {uuid}")
            entry: Dict[str, Any] = {
                "uuid": group.uuid, "name": group.name, "jobs": group.jobs,
                "host-placement": {
                    "type": group.placement_type.value,
                    "parameters": {
                        **({"attribute": group.placement_attribute}
                           if group.placement_attribute else {}),
                        **({"minimum": group.placement_minimum}
                           if group.placement_type is
                           GroupPlacementType.BALANCED else {})}},
                "straggler-handling": (
                    {"type": "quantile-deviation",
                     "parameters": {"quantile": group.straggler_quantile,
                                    "multiplier": group.straggler_multiplier}}
                    if group.straggler_quantile is not None
                    else {"type": "none", "parameters": {}})}
            if group.gang:
                entry["gang"] = gang_status(self.store, group)
            jobs = [j for j in (self.store.job(u) for u in group.jobs)
                    if j is not None]
            by_state = {"waiting": 0, "running": 0, "completed": 0}
            for job in jobs:
                by_state[job.state.value] += 1
            entry.update(by_state)
            if detailed:
                gang_cache: Dict[str, Dict] = {}
                entry["detailed"] = [
                    job_to_json(self.store, j, include_instances=False,
                                gang_cache=gang_cache)
                    for j in jobs]
            out.append(entry)
        if not out:
            raise ApiError(404, f"no such groups {uuids}")
        return out

    def group_kill(self, params: Dict, user: str) -> Dict:
        """DELETE /group?uuid=... — kill every job in the groups."""
        uuids = params.get("uuid", [])
        if not uuids:
            raise ApiError(400, "no uuids given")
        job_uuids = []
        for uuid in uuids:
            group = self.store.group(uuid)
            if group is None:
                raise ApiError(404, f"no such group {uuid}")
            for juuid in group.jobs:
                job = self.store.job(juuid)
                if job is None:
                    continue
                if job.user != user:
                    self.require_admin(user)
                job_uuids.append(juuid)
        for juuid in job_uuids:
            self.store.kill_job(juuid)
        return {"killed": job_uuids}

    def list_jobs(self, params: Dict) -> List[Dict]:
        """GET /list?user=&state=&start-ms=&end-ms=&limit=&name=&pool=
        (reference: rest/api.clj:3038 list-resource): jobs filtered by user,
        state set, submit-time window, name pattern (literal with ``*``
        wildcards, api.clj:1670-1675), and pool; newest first."""
        user = first(params.get("user"))
        if user is None:
            raise ApiError(400, "user parameter required")
        states = parse_states(params)
        try:
            start_ms = int(first(params.get("start-ms"), 0))
            end_ms = int(first(params.get("end-ms"), 2**62))
            limit = int(first(params.get("limit"), 150))
        except ValueError as e:
            raise ApiError(400, f"malformed query parameter: {e}")
        if limit <= 0:
            raise ApiError(400, "limit must be positive")
        name_filter = first(params.get("name"))
        name_rx = None
        if name_filter is not None:
            if not re.fullmatch(r"[\w.*\-]*", name_filter):
                raise ApiError(400, f"unsupported name filter {name_filter}")
            name_rx = re.compile(
                name_filter.replace(".", r"\.").replace("*", ".*") + "$")
        pool = first(params.get("pool"))
        jobs = self.store.jobs_where(
            lambda j: j.user == user
            and job_matches_states(self.store, j, states)
            and start_ms <= j.submit_time_ms < end_ms
            and (name_rx is None or name_rx.match(j.name))
            and (pool is None or j.pool == pool))
        jobs.sort(key=lambda j: j.submit_time_ms, reverse=True)
        gang_cache: Dict[str, Dict] = {}
        return [job_to_json(self.store, j, include_instances=False,
                            gang_cache=gang_cache)
                for j in jobs[:limit]]

    def shutdown_leader(self, user: str) -> Dict:
        """POST /shutdown-leader — admin-only; the leader resigns so a
        follower takes over (reference: the leader deliberately exits and
        the supervisor restarts it, mesos.clj:296-313)."""
        self.require_admin(user)
        if self.scheduler is None:
            raise ApiError(503, "this node is not the leader")
        self.scheduler.shutdown()
        if self.elector is not None:
            try:
                self.elector.resign()
            except Exception:
                pass
        return {"shutdown": True}

    def queue(self, user: str) -> Dict:
        self.require_admin(user)
        if self.scheduler is not None:
            return {pool: [job_to_json(self.store, j,
                                       include_instances=False)
                           for j in jobs[:200]]
                    for pool, jobs in self.scheduler.pending_queues.items()}
        if self.read_view is not None:
            # follower approximation of the ranked queue: the true DRU
            # order is leader state, so serve the pending set in
            # (priority, submit-time) order from the live mirror —
            # honestly stale, labeled by the replication headers the
            # follower read path attaches (docs/DEPLOY.md)
            out: Dict[str, List] = {}
            for job in self.store.pending_jobs():
                out.setdefault(job.pool, []).append(job)
            return {pool: [job_to_json(self.store, j,
                                       include_instances=False)
                           for j in sorted(
                               jobs, key=lambda j: (-j.priority,
                                                    j.submit_time_ms))[:200]]
                    for pool, jobs in out.items()}
        raise ApiError(503, "no scheduler attached")

    def running(self) -> List[Dict]:
        return [instance_to_json(inst)
                for _job, inst in self.store.running_instances()]

    def usage(self, params: Dict, auth_user: str = "") -> Dict:
        """GET /usage?user=&pool=&group_breakdown= (reference:
        rest/api.clj:2855-2968 UsageResponse + get-user-usage): running
        usage totals per pool, optionally broken down by job group
        (``grouped`` entries carry the group's uuid/name/running_jobs;
        ``ungrouped`` the rest).  Without ``user``, returns the
        cluster-wide per-user breakdown ``{"users": {user: usage}}``
        (admin-only here); ``pool`` restricts either form to one pool."""
        user = first(params.get("user"))
        pool_filter = first(params.get("pool")) or None  # "" = unfiltered
        if user is None:
            # admin check FIRST: no store scans for unauthorized callers
            self.require_admin(
                auth_user, "the all-users usage report is admin-only")
        # ONE usage scan per pool, shared by every user in the response
        # (the all-users form would otherwise rescan per user x pool)
        pool_usages = {p.name: self.store.user_usage(p.name)
                       for p in self.store.pools()
                       if pool_filter is None or p.name == pool_filter}
        breakdown = first(params.get("group_breakdown"), "false") == "true"
        if user is None:
            users: set = set()
            for usages in pool_usages.values():
                users.update(usages)
            running_by_user: Optional[Dict[str, List[Job]]] = None
            if breakdown:
                # ONE running-jobs scan bucketed by user (not one per user)
                running_by_user = {}
                for j in self.store.jobs_where(
                        lambda j: j.state is JobState.RUNNING
                        and (pool_filter is None or j.pool == pool_filter)):
                    running_by_user.setdefault(j.user, []).append(j)
            return {"users": {
                u: self._user_usage(
                    u, pool_filter, params, pool_usages,
                    running=(running_by_user.get(u, [])
                             if running_by_user is not None else None))
                for u in sorted(users)}}
        return self._user_usage(user, pool_filter, params, pool_usages)

    def _user_usage(self, user: str, pool_filter: Optional[str],
                    params: Dict, pool_usages: Dict[str, Dict],
                    running: Optional[List[Job]] = None) -> Dict:
        breakdown = first(params.get("group_breakdown"), "false") == "true"
        out: Dict[str, Any] = {
            "total_usage": {"cpus": 0.0, "mem": 0.0, "gpus": 0.0,
                            "jobs": 0}, "pools": {}}
        for pool_name, usages in pool_usages.items():
            usage = usages.get(user)
            if not usage:
                continue
            out["pools"][pool_name] = {
                "cpus": usage["cpus"], "mem": usage["mem"],
                "gpus": usage["gpus"], "jobs": int(usage["count"])}
            out["total_usage"]["cpus"] += usage["cpus"]
            out["total_usage"]["mem"] += usage["mem"]
            out["total_usage"]["gpus"] += usage["gpus"]
            out["total_usage"]["jobs"] += int(usage["count"])
        if breakdown:
            if running is None:
                running = self.store.jobs_where(
                    lambda j: j.user == user
                    and j.state is JobState.RUNNING
                    and (pool_filter is None or j.pool == pool_filter))

            def usage_of(jobs: List[Job]) -> Dict:
                return {"cpus": sum(j.resources.cpus for j in jobs),
                        "mem": sum(j.resources.mem for j in jobs),
                        "gpus": sum(j.resources.gpus for j in jobs),
                        "jobs": len(jobs)}

            by_group: Dict[Optional[str], List[Job]] = {}
            for j in running:
                by_group.setdefault(j.group, []).append(j)
            grouped = []
            for guuid, jobs in sorted(by_group.items(),
                                      key=lambda kv: kv[0] or ""):
                if guuid is None:
                    continue
                group = self.store.group(guuid)
                grouped.append({
                    "group": {"uuid": guuid,
                              "name": group.name if group else "",
                              "running_jobs": [j.uuid for j in jobs]},
                    "usage": usage_of(jobs)})
            loose = by_group.get(None, [])
            out["grouped"] = grouped
            out["ungrouped"] = {"running_jobs": [j.uuid for j in loose],
                                "usage": usage_of(loose)}
        return out

    def share_get(self, params: Dict) -> Dict:
        user = first(params.get("user"))
        if user is None:
            raise ApiError(400, "user parameter required")
        pools = [p.name for p in self.store.pools()] or ["default"]
        return {pool: _finite(self.store.get_share(user, pool))
                for pool in pools}

    def share_set(self, body: Dict, user: str) -> Dict:
        self.require_admin(user)
        target = body.get("user")
        if not target:
            raise ApiError(400, "user required")
        for pool, resources in body.get("pools", {}).items():
            self.store.set_share(target, pool, resources,
                                 reason=body.get("reason", ""))
        return {"user": target}

    def share_delete(self, params: Dict, user: str) -> Dict:
        self.require_admin(user)
        target = first(params.get("user"))
        for pool in [p.name for p in self.store.pools()] or ["default"]:
            self.store.retract_share(target, pool)
        return {"user": target}

    def quota_get(self, params: Dict) -> Dict:
        user = first(params.get("user"))
        if user is None:
            raise ApiError(400, "user parameter required")
        pools = [p.name for p in self.store.pools()] or ["default"]
        return {pool: _finite(self.store.get_quota(user, pool))
                for pool in pools}

    def quota_set(self, body: Dict, user: str) -> Dict:
        self.require_admin(user)
        target = body.get("user")
        if not target:
            raise ApiError(400, "user required")
        for pool, resources in body.get("pools", {}).items():
            resources = dict(resources)
            count = resources.pop("count", float("inf"))
            self.store.set_quota(target, pool, resources, count=count,
                                 reason=body.get("reason", ""))
        return {"user": target}

    def quota_delete(self, params: Dict, user: str) -> Dict:
        self.require_admin(user)
        target = first(params.get("user"))
        for pool in [p.name for p in self.store.pools()] or ["default"]:
            self.store.retract_quota(target, pool)
        return {"user": target}

    def pools(self) -> List[Dict]:
        return [{"name": p.name, "purpose": p.purpose, "state": p.state,
                 "dru-mode": p.dru_mode.value,
                 "scheduler": p.scheduler.value}
                for p in self.store.pools()]

    def unscheduled(self, params: Dict) -> List[Dict]:
        """GET /unscheduled_jobs?job=...&partial= (reference:
        UnscheduledJobParams rest/api.clj:3112-3117: ``partial`` allows a
        mix of valid and unknown uuids to return the valid subset)."""
        uuids = params.get("job", [])
        partial = first(params.get("partial"), "false") == "true"
        out = []
        for uuid in uuids:
            job = self.store.job(uuid)
            if job is None:
                if partial:
                    continue
                raise ApiError(404, f"no such job {uuid}")
            out.append({"uuid": uuid,
                        "reasons": job_reasons(self.store, job,
                                               scheduler=self.scheduler,
                                               queue_limits=self.queue_limits),
                        # decision HISTORY next to the live reasons: the
                        # newest audit events (utils/audit.py) — "what
                        # has the scheduler done with this job so far",
                        # not just "what blocks it right now"
                        "history": self.store.audit.timeline(uuid)[-20:]})
        if not out and uuids and partial:
            raise ApiError(404, "none of the requested jobs exist")
        return out

    def failure_reasons(self) -> List[Dict]:
        return [{"code": r.code, "name": r.name, "mea_culpa": r.mea_culpa,
                 "failure_limit": r.failure_limit}
                for r in Reasons.all()]

    def stats_instances(self, params: Dict, user: str) -> Dict:
        """GET /stats/instances?status=&start=&end=&name= — histogram
        statistics (percentiles + totals of run-time/cpu/mem-seconds)
        overall, by reason, by user-and-reason, plus per-user leaders,
        for instances started inside the window (reference:
        rest/api.clj:3185-3232 task-stats-handler + task_stats.clj).

        Without parameters, serves the legacy quick aggregate (instance
        counts by status and by reason) — a cook_tpu extension kept for
        dashboards; any parameter engages full reference validation."""
        if not params:
            from ..state.partition import substores
            by_status: Dict[str, int] = {}
            by_reason: Dict[str, int] = {}
            # one partition's lock at a time, never nested (the
            # store[pN] sibling rule, utils/locks.py)
            for shard in substores(self.store):
                with shard._lock:
                    for inst in shard._instances.values():
                        by_status[inst.status.value] = \
                            by_status.get(inst.status.value, 0) + 1
                        if inst.reason_code is not None:
                            name = Reasons.by_code(inst.reason_code).name
                            by_reason[name] = by_reason.get(name, 0) + 1
            return {"by_status": by_status, "by_reason": by_reason}
        self.require_admin(user)
        try:
            v = task_stats.validate_params(params)
        except task_stats.StatsParamError as e:
            raise ApiError(400, str(e))
        return task_stats.get_stats(
            self.store, v["status"], v["start_ms"], v["end_ms"],
            v["name_fn"], now_ms=self.store.clock())

    def progress(self, task_id: str, body: Dict) -> Dict:
        ok = self.store.update_instance_progress(
            task_id, int(body.get("progress_percent", 0)),
            message=body.get("progress_message", ""),
            sequence=int(body.get("progress_sequence", 0)))
        if not ok:
            raise ApiError(404, f"no such instance {task_id} "
                                "(or stale sequence)")
        if self.scheduler is not None:
            # progress frames double as liveness (heartbeat.clj:100-123)
            self.scheduler.heartbeat(task_id)
        return {"task_id": task_id}

    def info(self) -> Dict:
        from .. import __version__
        out = {"version": __version__,
               "leader": self.scheduler is not None,
               "authentication-scheme": "open",
               "start-up-time": 0}
        rs = getattr(self, "repl_server", None)
        if rs is not None:
            # socket-replication leader: operators (and failover tests)
            # need to see when a standby's mirror is actually synced —
            # the no-loss guarantee only covers commits made after that
            out["replication"] = {"port": rs.port,
                                  "followers": rs.follower_count,
                                  "synced_followers":
                                      rs.synced_follower_count}
        return out

    def swagger_docs(self) -> Dict:
        """Machine-readable API description (reference: the swagger-docs
        endpoint compojure-api generates from the route table,
        rest/api.clj:3640).  OpenAPI-3 shape, hand-maintained from the
        same dispatch table do_* routes serve."""
        from .. import __version__
        paths: Dict[str, Dict] = {}
        # declared query parameters for the read endpoints whose contracts
        # carry validation (the reference's compojure-api schemas)
        query_params = {
            # status/start/end are required TOGETHER for the windowed
            # report; omitting all of them serves the legacy quick
            # aggregate, so none is individually required:true
            ("GET", "/stats/instances"): [
                ("status", False, "unknown|running|success|failed "
                                  "(required for the windowed report)"),
                ("start", False, "epoch-ms or ISO-8601 "
                                 "(required for the windowed report)"),
                ("end", False, "epoch-ms or ISO-8601, window <= 31 days "
                               "(required for the windowed report)"),
                ("name", False, "job-name filter, * wildcard")],
            ("GET", "/list"): [
                ("user", True, ""), ("state", False, ""),
                ("start-ms", False, ""), ("end-ms", False, ""),
                ("limit", False, ""), ("name", False, "* wildcard"),
                ("pool", False, "")],
            ("GET", "/usage"): [
                ("user", False, "omit for the all-users report (admin)"),
                ("pool", False, ""),
                ("group_breakdown", False, "true|false")],
            ("GET", "/jobs"): [
                ("uuid", False, "repeatable; omit to query by user/state"),
                ("user", False, "with state: the listing form"),
                ("state", False, "waiting|running|completed (+-joined)"),
                ("partial", False, "true returns the found subset")],
            ("GET", "/unscheduled_jobs"): [
                ("job", True, "repeatable"),
                ("partial", False, "true returns the found subset")],
            ("GET", "/debug/cycles"): [
                ("limit", False, "newest-last record count, default 50")],
            ("GET", "/debug/trace"): [
                ("trace_id", False,
                 "trace_id of a span or CycleRecord; the response is "
                 "Chrome trace-event JSON (chrome://tracing, "
                 "ui.perfetto.dev)"),
                ("job", False,
                 "job uuid: stitch the job's audit track in; alone "
                 "(no trace_id) the export is the per-job stitched "
                 "view — launching cycle + submission request track")],
            ("GET", "/debug/requests"): [
                ("limit", False, "records per ring, default 50")],
        }
        for method, path, summary, leader_only in API_ROUTES:
            entry = paths.setdefault(path, {})
            op = {
                "summary": summary,
                "x-leader-only": leader_only,
                "responses": {"200": {"description": "success"}},
            }
            # declared path parameters, required by the OpenAPI spec for
            # every templated segment
            names = re.findall(r"{([^}]+)}", path)
            params = [{"name": n, "in": "path", "required": True,
                       "schema": {"type": "string"}} for n in names]
            for qname, required, desc in query_params.get((method, path),
                                                          []):
                q = {"name": qname, "in": "query", "required": required,
                     "schema": {"type": "string"}}
                if desc:
                    q["description"] = desc
                params.append(q)
            if params:
                op["parameters"] = params
            entry[method.lower()] = op
        return {
            "openapi": "3.0.0",
            "info": {"title": "cook_tpu scheduler API",
                     "version": __version__,
                     "description": "TPU-native fair-share batch scheduler "
                                    "(Cook-compatible REST surface)"},
            "paths": paths,
        }

    def swagger_ui(self) -> str:
        """Minimal self-contained HTML view of the API (no external
        assets; the image is zero-egress)."""
        rows = "".join(
            f"<tr><td><code>{m}</code></td><td><code>{p}</code></td>"
            f"<td>{s}</td><td>{'leader' if lo else ''}</td></tr>"
            for m, p, s, lo in API_ROUTES)
        return ("<!doctype html><html><head><title>cook_tpu API</title>"
                "<style>body{font-family:sans-serif;margin:2em}"
                "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
                "padding:4px 8px;text-align:left}</style></head><body>"
                "<h1>cook_tpu scheduler API</h1>"
                "<p>Machine-readable spec at <a href='/swagger-docs'>"
                "/swagger-docs</a>.</p><table><tr><th>Method</th>"
                f"<th>Path</th><th>Summary</th><th></th></tr>{rows}"
                "</table></body></html>")

    def debug(self) -> Dict:
        from ..utils.flight import recorder
        from ..utils.tracing import tracer
        return {"healthy": True,
                "pools": [p.name for p in self.store.pools()],
                "clusters": (list(self.scheduler.clusters)
                             if self.scheduler else []),
                "recent-spans": tracer.recent(limit=50),
                "recent-cycles": recorder.recent(limit=10)}

    def debug_cycles(self, params: Dict) -> Dict:
        """GET /debug/cycles?limit= — the flight recorder's newest-last
        CycleRecords (docs/OBSERVABILITY.md documents every field).
        When sharded cycles are in the ring (records carry a
        ``shard`` id) the response adds the per-shard summary roll-up
        (cycle count + p50/p99 per shard) under ``by_shard``."""
        from ..utils.flight import recorder
        try:
            limit = int(params.get("limit", ["50"])[0])
        except ValueError:
            raise ApiError(400, "limit must be an integer")
        out: Dict = {"cycles": recorder.recent(limit=limit)}
        by_shard = recorder.summary().get("by_shard")
        if by_shard:
            out["by_shard"] = by_shard
        return out

    def debug_trace(self, params: Dict) -> Dict:
        """GET /debug/trace?trace_id=&job= — spans as Chrome trace-event
        JSON (load in chrome://tracing / ui.perfetto.dev).  CycleRecords
        carry their trace_id, so /debug/cycles -> /debug/trace is the
        slow-cycle drill-down.

        With ``job`` alone (no trace_id), the export is the STITCHED
        per-job view (docs/OBSERVABILITY.md "tracing one request"): the
        cycle that launched the job (resolved from the ``launched``
        audit event's recorded cycle trace) as the base flamegraph, the
        submission request's span tree (http.request -> journal append
        -> replication ack wait) as its own named track, and the job's
        audit timeline as an instant-event lane — one Perfetto timeline
        from client submit to launch RPC."""
        from ..utils.tracing import job_track_events, tracer, track_meta
        trace_id = params.get("trace_id", [None])[0]
        job = params.get("job", [None])[0]
        req_trace = cycle_trace = None
        timeline: List[Dict[str, Any]] = []
        if job:
            timeline = self.store.audit.timeline(job)
            jb = self.store.job(job)
            if jb is not None:
                req_trace = jb.trace_id
            for ev in timeline:
                data = ev.get("data") or {}
                if req_trace is None and ev["kind"] == "submitted":
                    req_trace = data.get("trace")
                if ev["kind"] == "launched" and data.get("cycle_trace"):
                    cycle_trace = data["cycle_trace"]
        if not trace_id:
            # job-only form: base the export on the launching cycle when
            # one is known, else on the request trace alone
            trace_id = cycle_trace or req_trace
            if not trace_id:
                if job:
                    raise ApiError(
                        404, f"no trace recorded for job {job}")
                raise ApiError(400, "trace_id or job query parameter "
                                    "is required")
        if self.fleet is not None:
            # fleet-wide stitch (sched/fleet.py): fan out to every
            # known member's span ring and export per-PROCESS tracks —
            # leader txn, partition fsync, agent exec, barrier release
            # on one timeline (docs/OBSERVABILITY.md "Debugging the
            # fleet")
            return self._debug_trace_fleet(trace_id, req_trace, job,
                                           timeline)
        trace = tracer.export_chrome_trace(trace_id)
        if not trace["traceEvents"] and not (job and timeline):
            raise ApiError(404, f"no spans recorded for trace {trace_id}")
        if job:
            # stitch the submission request's span tree as a named track
            # next to the cycle flamegraph (skipped when it IS the base)
            if req_trace and req_trace != trace_id:
                req_events = tracer.trace_events(req_trace, tid=3)
                if req_events:
                    trace["traceEvents"].append(
                        track_meta(f"request {job[:13]}", 3))
                    trace["traceEvents"].extend(req_events)
            # the job's audit events as a per-job instant-event track
            # (utils/audit.py; docs/OBSERVABILITY.md "debugging one
            # job"): decision history and flamegraph on one timeline
            trace["traceEvents"].extend(job_track_events(job, timeline))
        return trace

    def _debug_trace_fleet(self, trace_id: str,
                           req_trace: Optional[str], job: Optional[str],
                           timeline: List[Dict[str, Any]]) -> Dict:
        """The stitched form of /debug/trace: local ring + per-member
        fan-out, merged and deduped, exported with per-process tracks;
        a distinct submission-request trace merges onto the same member
        tracks (the spans carry which process recorded them).  Fan-out
        provenance lands in ``otherData.members`` so a partial stitch
        (unreachable member) is visible, not silent."""
        from ..utils.tracing import export_fleet_trace, job_track_events
        spans, provenance = self.fleet.collect_trace(trace_id)
        if req_trace and req_trace != trace_id:
            req_spans, req_prov = self.fleet.collect_trace(req_trace)
            seen = {(d.get("proc"), d.get("span_id")) for d in spans}
            spans += [d for d in req_spans
                      if (d.get("proc"), d.get("span_id")) not in seen]
            provenance += [{**p, "trace": req_trace} for p in req_prov]
        if not spans and not (job and timeline):
            raise ApiError(404, f"no spans recorded for trace {trace_id}")
        trace = export_fleet_trace(spans, trace_id, members=provenance)
        if job and timeline:
            # the audit lane keeps its classic pid-1 home; name the
            # process so the fleet view labels the timeline track
            trace["traceEvents"].append(
                {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
                 "args": {"name": f"job {job[:13]} timeline"}})
            trace["traceEvents"].extend(job_track_events(job, timeline))
        return trace

    def debug_trace_spans(self, params: Dict) -> Dict:
        """GET /debug/trace/spans?trace_id= — THIS process's raw span
        docs for one trace, straight off the bounded local ring
        (utils/tracing.py): the per-member stitch source the fleet
        trace collector merges and dedupes.  Served locally on every
        role — a follower or agent-side process answers for its own
        ring, it never redirects (the whole point is that each member
        holds spans nobody else has)."""
        from ..utils import tracing as _tracing
        trace_id = params.get("trace_id", [None])[0]
        if not trace_id:
            raise ApiError(400, "trace_id query parameter is required")
        return {"trace_id": trace_id,
                "proc": self.instance or _tracing.process_identity(),
                "spans": _tracing.tracer.traces(trace_id)}

    def _role(self) -> str:
        """This process's fleet role as surfaced on /debug/health and
        /debug/fleet: ``leader`` (scheduler attached), ``follower`` (a
        live read view or replication mirror), else ``standby``."""
        if self.scheduler is not None:
            return "leader"
        if self.read_view is not None or self.repl_follower is not None:
            return "follower"
        return "standby"

    def debug_fleet(self) -> Dict:
        """GET /debug/fleet — the federated fleet panel (`cs debug
        fleet` renders it): per-member health, staleness, SLO burn,
        saturation hot-spots, and last-scrape age off the FleetScraper,
        plus this process's LIVE saturation block (recomputed now, not
        the last sweep's).  Without a scraper attached (follower,
        api-only node, federation disabled) the local block still
        serves — a probe of any member always answers."""
        from ..sched.fleet import compute_saturation
        sat = compute_saturation(self.config, store=self.store,
                                 read_view=self.read_view,
                                 rate_limits=self.rate_limits)
        red = self.config.fleet.saturation_red_line
        local = {"instance": self.instance, "role": self._role(),
                 "saturation": sat,
                 "hot": sorted(r for r, v in sat.items() if v >= red)}
        if self.fleet is None:
            return {"enabled": False, "members": [], "local": local,
                    "saturation_red_line": red}
        self.fleet.maybe_scrape()
        doc = self.fleet.fleet_doc()
        doc["local"] = local
        return doc

    def debug_federation_summary(self) -> Dict:
        """GET /debug/federation/summary — what this cell contributes
        to a federation front door (federation/summary.py): the SAME
        bounded per-user table partitions exchange intra-cell
        (state/store.py user_summary: a few floats per distinct user,
        never job state), a freshness age, and a bounded host inventory
        for goodput-mode cross-cell placement scoring.  Cheap enough to
        poll every summary sweep."""
        store = self.store if self.store is not None else (
            self.read_view.store if self.read_view is not None else None)
        users = store.user_summary() if store is not None else {}
        hosts: List[Dict[str, Any]] = []
        if self.scheduler is not None:
            seen = set()
            pools = [p.name for p in (store.pools() if store else [])] \
                or ["default"]
            for cluster in self.scheduler.clusters.values():
                for pool in pools:
                    try:
                        offers = cluster.hosts(pool)
                    except Exception:
                        continue
                    for o in offers:
                        if o.hostname in seen:
                            continue
                        seen.add(o.hostname)
                        hosts.append({
                            "hostname": o.hostname,
                            "cpus": o.capacity.cpus,
                            "mem": o.capacity.mem,
                            "gpus": o.capacity.gpus,
                            "pool": o.pool,
                            "attributes": dict(o.attributes),
                            "gpu_model": o.gpu_model})
                        if len(hosts) >= 256:
                            break
                    if len(hosts) >= 256:
                        break
                if len(hosts) >= 256:
                    break
        return {"users": users, "age_s": 0.0, "hosts": hosts}

    def metrics_fleet(self) -> str:
        """GET /metrics/fleet — the merged fleet exposition: every
        member's /metrics re-labeled with {instance, role}
        (sched/fleet.py).  A pull nudges the self-gated scraper, so a
        fresh leader serves real data without waiting a monitor sweep;
        without a scraper the local exposition serves (the scrape
        target never 404s during failover)."""
        if self.fleet is None:
            return self.metrics()
        self.fleet.maybe_scrape()
        merged = self.fleet.merged_exposition()
        return merged if merged else self.metrics()

    def debug_requests(self, params: Dict) -> Dict:
        """GET /debug/requests?limit= — the serving plane's bounded
        request-capture rings (rest/instrument.py): newest recent
        requests, the slow ring with per-phase breakdowns, and rolling
        phase-share totals.  Params are redacted; join records to traces
        via ``trace_id`` and to user reports via ``request_id``."""
        try:
            limit = int(params.get("limit", ["50"])[0])
        except ValueError:
            raise ApiError(400, "limit must be an integer")
        return self.request_obs.snapshot(limit=limit)

    def debug_health(self) -> Dict:
        """GET /debug/health — the one-shot operator roll-up `cs debug
        health` renders: every "is this cell healthy" signal that
        otherwise takes five /debug/* fetches (docs/OBSERVABILITY.md)."""
        from ..utils.locks import monitor as lock_monitor
        from ..utils.metrics import registry
        from ..utils.retry import breakers

        def series(name: str) -> List[Dict[str, Any]]:
            return [{**labels, "value": value}
                    for labels, value in registry.series(name)]

        from ..sched.fleet import compute_saturation
        repl = self.debug_replication()
        saturation = compute_saturation(self.config, store=self.store,
                                        read_view=self.read_view,
                                        rate_limits=self.rate_limits)
        red_line = self.config.fleet.saturation_red_line
        health: Dict[str, Any] = {
            "healthy": True,
            "leader": self.scheduler is not None,
            # fleet role marker: a follower probed directly must SAY so
            # (and carry its read-view block below) instead of looking
            # like a healthy leader-shaped process
            "role": self._role(),
            # normalized 0-1 saturation signals (sched/fleet.py
            # formulas; docs/OBSERVABILITY.md) — the adaptive-admission
            # input contract, recomputed live for this probe
            "saturation": saturation,
            "saturation_red_line": red_line,
            "saturation_hot": sorted(r for r, v in saturation.items()
                                     if v >= red_line),
            "slo_burn_rates": series("cook_slo_burn_rate"),
            # overload ladder state (sched/admission.py): the adaptive
            # admission level, the brownout stage + recent flips on a
            # leader; followers report the journaled stage they act on
            "admission": self.admission_state(),
            "breakers": breakers.states(),
            "replication": {
                k: repl.get(k)
                for k in ("role", "epoch", "fenced", "synced_followers",
                          "follower_count", "min_acked", "journal_bytes",
                          "mirror", "serving", "group_commit",
                          "partitions", "summary_exchange")
                if repl.get(k) is not None},
            "pipeline_depth": next(
                (v for _lbl, v in registry.series("cook_pipeline_depth")),
                None),
            "resident_repacks": series("cook_resident_repack"),
            "audit": {k: v for k, v in self.store.audit.stats().items()
                      if k in ("jobs", "pending_durable",
                               "shed_advisory", "shed_count")},
            "http": self.request_obs.snapshot(limit=0)["totals"],
            # lock-order sanitizer (utils/locks.py, docs/ANALYSIS.md):
            # the observed acquisition-graph edge set + violation counts
            "locks": lock_monitor.snapshot(),
        }
        # static-vs-observed lock-coverage diff (docs/ANALYSIS.md): the
        # static edge set is computed ONCE per process off a background
        # thread (a ~1 s source scan must never stall a health probe);
        # until it lands, the block reports "computing".  unexercised =
        # statically possible orderings tier-1 never drove; observed-
        # only = a resolution gap in the static analysis (report it).
        lk = health["locks"]
        try:
            from ..analysis.summaries import (static_edge_error,
                                              static_edge_families)
            static = static_edge_families(wait=False)
            err = static_edge_error()
        except Exception:  # analysis package stripped from this deploy
            lk["static_edges"] = "unavailable"
        else:
            if static is not None:
                observed = set(lk.get("observed_edges", []))
                lk["static_edges"] = static
                lk["unexercised_edges"] = sorted(set(static) - observed)
                lk["observed_only_edges"] = sorted(observed - set(static))
            elif err is not None:
                lk["static_edges"] = f"failed: {err}"
            else:
                lk["static_edges"] = "computing"
        followers = repl.get("followers") or []
        if followers:
            health["replication"]["max_lag_bytes"] = max(
                int(f.get("lag_bytes", 0)) for f in followers)
        rv = self.read_view
        if rv is not None:
            # the read-view apply-loop block /debug/replication always
            # had but this roll-up omitted: a follower probed directly
            # looked healthier than it was — no staleness age, no
            # applied offset, no reads-served count
            health["read_view"] = {**rv.stats(),
                                   "reads_served": self.follower_reads}
        # persistence-integrity roll-up (full detail: /debug/storage) —
        # a poisoned journal or a corrupt mirror is NOT healthy even
        # while the process keeps serving its verified prefix
        storage = self.debug_storage()
        health["storage"] = {
            k: storage.get(k)
            for k in ("poisoned", "corruptions", "repairs",
                      "enospc_aborts", "mirror_corrupt")
            if storage.get(k) is not None}
        # burning past budget, a fenced store, or a potential-deadlock
        # lock graph is not healthy
        if any(s["value"] > 1.0 for s in health["slo_burn_rates"]) \
                or repl.get("fenced") \
                or health["locks"]["violations"] \
                or health["locks"]["blocking_events"]:
            health["healthy"] = False
        if storage.get("poisoned") or storage.get("mirror_corrupt"):
            health["healthy"] = False
        if rv is not None and saturation["follower_staleness"] >= 1.0:
            # a follower serving reads staler than the red line
            # (fleet.staleness_red_line_seconds) is NOT healthy — the
            # exact "looks healthier than it is" gap this block closes
            health["healthy"] = False
        return health

    def debug_storage(self) -> Dict:
        """GET /debug/storage — the persistence-integrity panel `cs
        debug storage` renders: per-partition scrub progress (last
        verified offset vs journal size), corruption/repair counters,
        checkpoint manifest status, ENOSPC aborts, boot hygiene, and —
        on a follower — the read view's poison state
        (docs/DEPLOY.md corrupted-journal runbook)."""
        from ..state.partition import substores
        shards: List[Dict[str, Any]] = []
        for shard in substores(self.store):
            try:
                shards.append(shard.storage_stats())
            except Exception as e:  # pragma: no cover — defensive
                shards.append({"error": str(e)})
        doc: Dict[str, Any] = {
            "shards": shards,
            "poisoned": any(s.get("journal_poisoned") for s in shards),
            "corruptions": sum(int(s.get("scrub_corruptions", 0) or 0)
                               for s in shards),
            "repairs": sum(int(s.get("scrub_repairs", 0) or 0)
                           for s in shards),
            "enospc_aborts": sum(int(s.get("enospc_aborts", 0) or 0)
                                 for s in shards),
            "hygiene_removed": sum(int(s.get("hygiene_removed", 0) or 0)
                                   for s in shards),
        }
        sc = getattr(self.config, "storage", None)
        if sc is not None:
            doc["scrub"] = {
                "enabled": bool(sc.scrub_enabled),
                "interval_seconds": sc.scrub_interval_seconds,
                "chunk_bytes": sc.scrub_chunk_bytes,
                "checkpoint_on_corruption":
                    bool(sc.checkpoint_on_corruption),
            }
        rv = self.read_view
        if rv is not None:
            st = rv.stats()
            doc["read_view"] = {
                k: st.get(k)
                for k in ("offset", "epoch", "jobs", "corrupt")
                if st.get(k) is not None}
            doc["mirror_corrupt"] = \
                getattr(rv, "corrupt", None) is not None
        return doc

    def debug_job_timeline(self, uuid: str) -> Dict:
        """GET /debug/job/<uuid>/timeline — the job's full decision
        audit trail (utils/audit.py): submit -> ranked -> skips/deferrals
        with reasons -> launch intent/ack -> instance transitions ->
        preemption (with the DRU delta) -> terminal, surviving leader
        failover via the journal-backed lane.  Answers live next to the
        history: a still-waiting job also gets the unscheduled
        explainer's current reasons and the user's fairness position."""
        job = self.store.job(uuid)
        timeline = self.store.audit.timeline(uuid)
        if job is None and not timeline:
            raise ApiError(404, f"no such job {uuid}")
        out: Dict[str, Any] = {"uuid": uuid, "timeline": timeline}
        if job is not None:
            out["state"] = job_state_string(self.store, job)
            out["user"] = job.user
            out["pool"] = job.pool
            dru = self.store.audit.user_dru(job.pool, job.user)
            if dru is not None:
                out["user_dru"] = dru
            if job.state is JobState.WAITING:
                out["reasons"] = job_reasons(
                    self.store, job, scheduler=self.scheduler,
                    queue_limits=self.queue_limits)
        return out

    def debug_optimizer(self) -> Dict:
        """GET /debug/optimizer — the goodput loop's decision panel
        (`cs debug optimizer` renders it; docs/GANG.md elasticity):
        cycle counts + last error, the last per-pool decisions (grow
        budget, shrink pressure, preemption budget, autoscale target,
        candidate scores), the legacy observational schedule, and the
        elastic resize plane's live state (pending grace shrinks,
        standing budgets, grow/shrink totals)."""
        sched = self.scheduler
        if sched is None:
            raise ApiError(503, "no scheduler attached (not the leader)")
        out: Dict[str, Any] = {
            "enabled": sched.config.optimizer is not None,
            "elastic": sched.elastic.debug(),
        }
        cyc = sched.optimizer_cycler
        if cyc is None:
            return out
        decisions = getattr(cyc.optimizer, "last_decisions", {})
        schedule = None
        if cyc.last_schedule is not None:
            # HostInfo keys are not JSON; render them
            schedule = {
                str(period): {
                    "suggested-matches": [
                        {"host": vars(hi), "jobs": list(uuids)}
                        for hi, uuids in step["suggested-matches"].items()]}
                for period, step in cyc.last_schedule.items()}
        out.update({
            "cycles": cyc.cycles,
            "interval_seconds": cyc.interval_seconds,
            "last_error": (repr(cyc.last_error)
                           if cyc.last_error is not None else None),
            "decisions": {p: d.to_dict() for p, d in decisions.items()},
            "last_schedule": schedule,
        })
        return out

    def debug_faults(self) -> Dict:
        """GET /debug/faults — degradation panel: armed fault points and
        their trigger counts, per-cluster circuit-breaker states, and open
        launch intents (docs/ROBUSTNESS.md).  Served locally on every
        node like the other debug surfaces."""
        from ..utils.faults import injector
        from ..utils.retry import breakers
        return {"fault_points": injector.active(),
                "seed": injector.seed,
                "breakers": breakers.states(),
                "launch_intents": self.store.launch_intents()}

    def debug_replication(self) -> Dict:
        """GET /debug/replication — the failover-protocol panel
        (docs/OBSERVABILITY.md): per-follower acked offsets and synced
        flags, min_acked, journal head and lag on the leader; the
        mirror's offset/synced state on a standby; plus every candidate
        position currently published into the election medium.  Served
        locally on every node (each node's view IS the datum)."""
        out: Dict[str, Any] = {"role": "none"}
        rs = self.repl_server
        if rs is not None:
            followers = rs.status()
            head = 0
            if getattr(rs, "directory", None):
                try:
                    import os as _os
                    head = _os.path.getsize(
                        _os.path.join(rs.directory, "journal.jsonl"))
                except OSError:
                    head = 0
            for f in followers:
                f["lag_bytes"] = max(0, head - int(f.get("acked", 0)))
            out.update(
                role="leader", epoch=getattr(rs, "epoch", None),
                fenced=bool(getattr(rs, "fenced", False)),
                port=rs.port, journal_bytes=head,
                min_acked=rs.min_acked(),
                follower_count=rs.follower_count,
                synced_followers=rs.synced_follower_count,
                followers=followers)
            gc = self.store.group_commit_stats() \
                if hasattr(self.store, "group_commit_stats") else None
            if gc is not None:
                # write-path admission batching: batches, demuxed
                # outcomes, and the largest batch amortized so far
                out["group_commit"] = gc
        rf = self.repl_follower
        if rf is not None:
            out["role"] = "standby"
            out["mirror"] = {"offset": rf.offset,
                             "connected": rf.connected}
        rv = self.read_view
        if rv is not None:
            # the SERVING role of this standby: local apply position vs
            # the mirrored head (staleness in bytes + age) and how many
            # GETs this node has answered from its live store
            out["serving"] = {**rv.stats(),
                              "reads_served": self.follower_reads}
        pstats = getattr(self.store, "partition_stats", None)
        if pstats is not None:
            # partitioned write plane (state/partition.py): one block
            # per partition — journal head, lease epoch, group-commit
            # stage, declared pool groups — plus the summary-exchange
            # state cross-partition invariants read through
            out["partitions"] = pstats()
            summaries = getattr(self.store, "summaries", None)
            if summaries is not None:
                out["summary_exchange"] = summaries.stats()
        for srv in getattr(self, "partition_repl_servers", None) or []:
            # per-partition replication topologies (each partition owns
            # its own server + synced-standby set)
            out.setdefault("partition_replication", []).append({
                "partition": f"p{srv.partition}"
                if getattr(srv, "partition", None) is not None else None,
                "port": srv.port,
                "synced_followers": srv.synced_follower_count,
                "min_acked": srv.min_acked(),
            })
        if self.repl_dir:
            from ..state.replication import candidate_position
            out["position"] = candidate_position(self.repl_dir)
        if self.elector is not None:
            try:
                out["candidates"] = self.elector.read_candidates()
            except Exception:
                out["candidates"] = {}
        return out

    def settings(self) -> Dict:
        from ..sched.rebalancer import effective_rebalancer_params
        cfg = self.config
        # resolved against the store's dynamic document so api-only nodes
        # (no scheduler attached) report the same truth they accept
        # updates against
        reb = effective_rebalancer_params(cfg, self.store)
        return {
            "rank-interval-seconds": cfg.rank_interval_seconds,
            "match-interval-seconds": cfg.match_interval_seconds,
            "max-over-quota-jobs": cfg.max_over_quota_jobs,
            "default-pool": cfg.default_pool,
            "rebalancer": {
                "enabled": reb.enabled,
                "safe-dru-threshold": reb.safe_dru_threshold,
                "min-dru-diff": reb.min_dru_diff,
                "max-preemption": reb.max_preemption,
                "interval-seconds": reb.interval_seconds,
            },
            # clients derive their submission expectations from this block
            # (reference: settings -> :task-constraints, read by the
            # integration tier's limit probes)
            "task-constraints": {
                "cpus": cfg.task_constraints.cpus,
                "memory-gb": cfg.task_constraints.memory_gb,
                "max-ports": cfg.task_constraints.max_ports,
                "retry-limit": cfg.task_constraints.retry_limit,
                "command-length-limit":
                    cfg.task_constraints.command_length_limit,
                "docker-parameters-allowed": (
                    cfg.task_constraints.docker_parameters_allowed
                    if cfg.task_constraints.docker_parameters_allowed
                    is not None
                    else sorted(DEFAULT_DOCKER_PARAMETERS_ALLOWED)),
            },
            "pools": {
                "default-containers": [
                    {"pool-regex": rx, "container": c}
                    for rx, c in cfg.default_containers],
                "default-envs": [{"pool-regex": rx, "env": e}
                                 for rx, e in cfg.default_envs],
                "valid-gpu-models": [{"pool-regex": rx, "valid-models": m}
                                     for rx, m in cfg.valid_gpu_models],
            },
            **self._k8s_settings(),
        }

    def _k8s_settings(self) -> Dict:
        """The kubernetes config block (reference: settings ->
        :kubernetes, read by the integration tier's disallowed-volume/
        var probes).  Config is the cross-node source of truth; any live
        backend's values are unioned in, so leaders and api-only
        followers serve one consistent settings document."""
        paths = set(self.config.kubernetes_disallowed_container_paths)
        names = set(self.config.kubernetes_disallowed_var_names)
        for cluster in (self.scheduler.clusters.values()
                        if self.scheduler else []):
            if hasattr(cluster, "disallowed_container_paths"):
                paths |= cluster.disallowed_container_paths
                names |= cluster.disallowed_var_names
        return {"kubernetes": {
            "disallowed-container-paths": sorted(paths),
            "disallowed-var-names": sorted(names)}}

    # wire-name -> (field, coercion): values are validated/coerced so a
    # mistyped document can never poison every later rebalance cycle
    _REBALANCER_PARAMS = {
        "enabled": ("enabled", bool),
        "safe-dru-threshold": ("safe_dru_threshold", float),
        "min-dru-diff": ("min_dru_diff", float),
        "max-preemption": ("max_preemption", int),
        "interval-seconds": ("interval_seconds", float),
    }

    def rebalancer_set(self, body: Dict, user: str) -> Dict:
        """POST /settings/rebalancer — durable no-restart parameter update
        (reference: the rebalancer's Datomic params, rebalancer.clj:535-557,
        re-read every cycle; interval changes take effect on the next
        tick)."""
        self.require_admin(user)
        unknown = set(body) - set(self._REBALANCER_PARAMS)
        if unknown:
            raise ApiError(400, f"unknown rebalancer params: {sorted(unknown)}")
        updates = {}
        for wire, value in body.items():
            field_name, coerce = self._REBALANCER_PARAMS[wire]
            try:
                if coerce is bool and not isinstance(value, bool):
                    raise ValueError("expected a boolean")
                if coerce is int and float(value) != int(value):
                    raise ValueError("expected an integer")
                updates[field_name] = coerce(value)
            except (TypeError, ValueError) as e:
                raise ApiError(400, f"bad value for {wire}: {e}")
        merged = self.store.update_dynamic_config("rebalancer", updates)
        return {"rebalancer": merged}

    # --------------------------------------------- dynamic compute clusters
    def compute_clusters(self) -> List[Dict]:
        if self.scheduler is None:
            raise ApiError(503, "no scheduler attached")
        return [{"name": c.name, "state": c.state,
                 "type": type(c).__name__}
                for c in self.scheduler.clusters.values()]

    def compute_cluster_update(self, name: str, body: Dict,
                               user: str) -> Dict:
        """Dynamic cluster CRUD (reference: compute_cluster.clj:450-594):
        CREATE a new backend from a factory spec, or drive the state
        machine running -> draining -> deleted.  Deletion is refused while
        the cluster still runs tasks (the reference's integration flow
        polls deleted until the drain empties the cluster,
        integration/tests/cook/test_dynamic_clusters.py)."""
        self.require_admin(user)
        if self.scheduler is None:
            raise ApiError(503, "no scheduler attached")
        cluster = self.scheduler.clusters.get(name)
        if cluster is None:
            factory = body.get("factory")
            if not factory:
                raise ApiError(404, f"no such cluster {name} "
                                    "(create needs a 'factory' spec)")
            # an HTTP body must not become a code-loading surface: only
            # factories the operator pre-declared (static cluster specs /
            # explicit allowlist, the reference's factory-fn templates)
            # may be instantiated dynamically
            allowed = getattr(self.config, "cluster_factory_allowlist",
                              None) or []
            if factory not in allowed:
                raise ApiError(
                    403, f"factory {factory!r} not in the configured "
                         "cluster_factory_allowlist")
            from ..daemon import build_clusters
            try:
                [fresh] = build_clusters(
                    [{"factory": factory,
                      "kwargs": dict(body.get("kwargs") or {},
                                     name=name)}], self.store,
                    config=self.config)
            except Exception as e:
                raise ApiError(422, f"cluster factory failed: {e}")
            self.scheduler.add_cluster(fresh)
            return {"name": name, "state": fresh.state, "created": True}
        new_state = body.get("state")
        legal = {"running": {"draining"}, "draining": {"running", "deleted"}}
        if new_state not in legal.get(cluster.state, set()):
            raise ApiError(422, f"illegal transition {cluster.state} "
                                f"-> {new_state}")
        if new_state == "deleted":
            # backend-agnostic liveness: the store is the source of truth
            # (a backend-specific probe would silently no-op for adapters
            # that don't expose one)
            live = sum(1 for _j, inst in self.store.running_instances()
                       if inst.compute_cluster == name)
            if live:
                raise ApiError(422, f"cluster {name} still runs "
                                    f"{live} tasks; drain first")
            gone = self.scheduler.clusters.pop(name)
            shutdown = getattr(gone, "shutdown", None)
            if shutdown:
                try:
                    shutdown()  # unhook watches/threads (daemon contract)
                except Exception:
                    pass
        else:
            cluster.state = new_state
        return {"name": name, "state": new_state}

    # -------------------------------------------------- incremental config
    def incremental_get(self) -> Dict:
        return self.incremental.all()

    def incremental_set(self, body: Dict, user: str) -> Dict:
        self.require_admin(user)
        try:
            self.incremental.set_many(body)  # all-or-nothing
        except (ValueError, KeyError, TypeError) as e:
            raise ApiError(400, f"bad incremental config: {e}")
        return self.incremental.all()

    def metrics(self) -> str:
        """Prometheus text exposition (reference: prometheus_metrics.clj +
        /metrics handler rest/api.clj:3981)."""
        from ..utils.metrics import registry
        repl_servers = [s for s in ([self.repl_server]
                                    + list(self.partition_repl_servers))
                        if s is not None and not getattr(s, "fenced",
                                                         False)]
        if repl_servers:
            # per-follower mirror lag, refreshed at scrape time (the
            # replication-health signal operators alert on:
            # docs/OBSERVABILITY.md cook_replication_lag_bytes).  The
            # follower label is a per-CONNECTION id, so stale series are
            # dropped first — reconnect churn must not accumulate frozen
            # dead-follower series forever.  On a partitioned leader
            # every partition's server exports its own partition-labeled
            # series (each partition is its own replication topology).
            registry.gauge_clear("cook_replication_lag_bytes")
            for rs in repl_servers:
                try:
                    import os as _os
                    head = _os.path.getsize(
                        _os.path.join(rs.directory, "journal.jsonl"))
                except OSError:
                    head = 0
                part = getattr(rs, "partition", None)
                for f in rs.status():
                    registry.gauge_set(
                        "cook_replication_lag_bytes",
                        max(0, head - int(f.get("acked", 0))),
                        labels={"follower": str(f.get("id")),
                                "synced":
                                    str(bool(f.get("synced"))).lower(),
                                **({"partition": f"p{part}"}
                                   if part is not None else {})})
        rv = self.read_view
        if rv is not None:
            # follower serving-plane staleness, refreshed at scrape time
            # like the leader's per-follower lag above
            registry.gauge_set("cook_follower_apply_lag_bytes",
                               float(rv.lag_bytes()))
            registry.gauge_set("cook_follower_staleness_seconds",
                               round(rv.age_ms() / 1000.0, 6))
        # saturation gauges refresh at scrape time on EVERY role: the
        # leader's monitor sweep also publishes them, but followers and
        # api-only nodes run no monitor — without this their federated
        # series would read a boot-time zero forever (sched/fleet.py)
        from ..sched.fleet import compute_saturation, publish_saturation
        publish_saturation(
            compute_saturation(self.config, store=self.store,
                               read_view=rv,
                               rate_limits=self.rate_limits),
            registry)
        lines = registry.expose()
        # always include live gauges derivable from state (per-shard
        # locks taken in turn, never nested — utils/locks.py)
        from ..state.partition import substores
        waiting = running = 0
        for shard in substores(self.store):
            with shard._lock:
                waiting += sum(1 for j in shard._jobs.values()
                               if j.state is JobState.WAITING
                               and j.committed)
                running += sum(1 for j in shard._jobs.values()
                               if j.state is JobState.RUNNING)
        lines += (f"\ncook_jobs_waiting {waiting}"
                  f"\ncook_jobs_running {running}\n")
        return lines


ALLOWED_LIST_STATES = frozenset(
    {"waiting", "running", "completed", "success", "failed"})


def parse_states(params: Dict) -> set:
    """State filter from query params. '+' is the documented separator, but
    standard URL decoding turns a literal '+' into a space, so accept
    space/comma too, and repeated state params."""
    states = set()
    for value in params.get("state", []):
        states.update(s for s in re.split(r"[+,\s]+", value) if s)
    if states and not states <= ALLOWED_LIST_STATES:
        raise ApiError(400, f"unsupported state in {sorted(states)}, must "
                            f"be one of: {sorted(ALLOWED_LIST_STATES)}")
    return states


def job_matches_states(store: Store, job: Job, states: set) -> bool:
    """'completed' means both success and failed (reference:
    rest/api.clj:1659-1668 normalize-list-states)."""
    if not states:
        return True
    if job.state.value in states:
        return True
    # resolving success/failed reads the job's instances — skip it unless
    # the filter can actually match a resolved state
    if job.state is not JobState.COMPLETED \
            or not states & {"success", "failed"}:
        return False
    return job_state_string(store, job) in states


def first(values, default=None):
    if not values:
        return default
    return values[0]


def _finite(d: Dict[str, float]) -> Dict[str, Any]:
    return {k: (v if v != float("inf") else None) for k, v in d.items()}


class _Handler(BaseHTTPRequestHandler):
    api: CookApi = None  # set by server factory
    protocol_version = "HTTP/1.1"
    # keep-alive is the serving plane's thread model: ThreadingHTTPServer
    # runs one thread per CONNECTION, so connection reuse (JobClient's
    # pooled http.client sockets) turns per-request thread churn into one
    # long-lived thread per client.  Nagle off: small JSON responses must
    # not wait out delayed-ACK interactions on localhost benches.
    disable_nagle_algorithm = True
    # an idle keep-alive connection releases its thread eventually
    # instead of holding it for the client process lifetime
    timeout = 120

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):  # pragma: no cover - silence
        pass

    def _authenticate(self) -> str:
        """Resolve (and in verified mode, check) the caller identity; runs
        for EVERY request before dispatch (reference: the auth middleware
        wraps the whole handler stack, components.clj:266-284)."""
        if self.api.auth_chain is not None:
            from .auth import AuthError
            try:
                # schemes may fill response headers (e.g. the GSSAPI
                # acceptor's mutual-auth token), sent with the 200
                self._auth_respond_headers = {}
                return self.api.auth_chain.authenticate(
                    self.headers, self._auth_respond_headers)
            except AuthError as e:
                headers = ({"WWW-Authenticate": e.challenge}
                           if e.challenge else None)
                raise ApiError(401, e.message, headers=headers)
        # open mode: identity from unverified Basic or the trusted header
        auth = self.headers.get("Authorization", "")
        user = self.headers.get("X-Cook-User", "")
        if auth.startswith("Basic "):
            try:
                user = base64.b64decode(auth[6:]).decode().partition(":")[0]
            except Exception:
                raise ApiError(401, "malformed basic auth")
        return user or "anonymous"

    def _user(self) -> str:
        return self.api.resolve_user(
            self._auth_user, self.headers.get("X-Cook-Impersonate"))

    def _body(self) -> Dict:
        length = int(self.headers.get("Content-Length", 0))
        if not length:
            return {}
        try:
            return json.loads(self.rfile.read(length))
        except json.JSONDecodeError:
            raise ApiError(400, "malformed JSON body")

    def _cors_headers(self) -> None:
        origin = self.headers.get("Origin")
        if origin and self.api.origin_allowed(origin):
            self.send_header("Access-Control-Allow-Origin", origin)
            self.send_header("Access-Control-Allow-Credentials", "true")
            self.send_header("Vary", "Origin")

    def _respond(self, status: int, payload,
                 extra_headers: Optional[Dict[str, str]] = None) -> None:
        # {"_raw"}/{"_html"} payloads are plain-text surfaces (/metrics,
        # /swagger-ui); everything else is the JSON plane
        html = isinstance(payload, dict) and "_html" in payload
        raw = isinstance(payload, dict) and "_raw" in payload
        if raw or html:
            data = payload.get("_raw", payload.get("_html")).encode()
            ctype = "text/html" if html else "text/plain"
        else:
            data = json.dumps(to_json(payload)).encode()
            ctype = "application/json"
        self._status = status
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        # gzip the observability surfaces (Prometheus scrapes, Perfetto
        # trace exports run to MBs) when the client opts in; tiny bodies
        # skip the compressor (the header bytes would outweigh the win)
        path = self.path.split("?", 1)[0]
        if len(data) > 512 \
                and (path in ("/metrics", "/metrics/fleet")
                     or path.startswith("/debug")) \
                and instrument.wants_gzip(
                    self.headers.get("Accept-Encoding")):
            data = instrument.gzip_body(data)
            self.send_header("Content-Encoding", "gzip")
            self.send_header("Vary", "Accept-Encoding")
        self.send_header("Content-Length", str(len(data)))
        # every response (success AND error) echoes the request id so a
        # user report joins to the slow-request ring and the trace
        rid = getattr(self, "_request_id", None)
        if rid:
            self.send_header("X-Cook-Request-Id", rid)
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        if not (raw or html):
            self._cors_headers()
        self.end_headers()
        self.wfile.write(data)
        self._bytes_out = len(data)

    # paths the front door NEVER rate-limits (docs/DEPLOY.md
    # overload runbook): the observability and health surfaces must
    # survive the very incident that trips the limiter — an operator
    # locked out of /metrics and /debug/* mid-overload is flying blind
    @staticmethod
    def _admission_exempt(path: str) -> bool:
        # NOT /info: it has been IP-throttled since the limiter shipped
        # and is cheap to re-probe; the exemption exists for the surfaces
        # an operator needs DURING the stampede (/debug/health et al.)
        return (path in ("/metrics", "/metrics/fleet",
                         "/failure_reasons", "/settings")
                or path.startswith("/debug"))

    def _check_ip_limit(self) -> bool:
        """Admit or 429 this request per the client-IP bucket (covers
        every verb incl. OPTIONS — the reference's middleware wraps the
        whole handler).  try_spend is atomic: a full token per request,
        so the fractional refill trickle never admits a burst.
        Observability/health paths are exempt (_admission_exempt)."""
        limiter = self.api.ip_limiter
        if limiter is None:
            return True
        path = urllib.parse.urlparse(self.path).path
        if self._admission_exempt(path):
            return True
        ip = self.client_address[0]
        if limiter.try_spend(ip):
            return True
        from ..utils.metrics import registry
        registry.counter_inc("cook_admission_rejections", 1.0,
                             {"scope": "ip", "reason": "rate-limited"})
        # one token's worth of refill is when the next request can pass
        rate = limiter.tokens_per_minute * getattr(limiter, "refill_scale",
                                                   1.0)
        retry_s = max(1, int(60.0 / max(rate, 1e-9))
                      + int(min(limiter.time_until_out_of_debt_s(ip),
                                3600.0)))
        # minted lazily: verbs that gate on the IP bucket before _route
        # (OPTIONS) reject before the request id would normally be set
        rid = getattr(self, "_request_id", None) \
            or self.headers.get("X-Cook-Request-Id") \
            or uuidlib.uuid4().hex[:16]
        self._request_id = rid
        self._respond(429, {"error": "too many requests from this "
                                     "address",
                            "reason": "rate-limited",
                            "scope": "ip",
                            "request_id": rid},
                      extra_headers={"Retry-After": str(retry_s)})
        return False

    def _route(self, method: str) -> None:
        """Instrumented ingress (docs/OBSERVABILITY.md serving plane):
        every request gets an id (client's X-Cook-Request-Id or minted
        here), and — unless the operator disabled the http observe knob —
        an ``http.request`` root span under any client-sent traceparent,
        RED metrics on the templated endpoint, and a capture-ring record
        carrying the per-phase breakdown the span tree accumulated
        (journal append, replication ack wait, ...).

        Spans record under this node's fleet identity (CookApi.instance)
        for the request's duration: an in-process multi-server topology
        (tests, the simulator) shares one span ring, and the per-process
        tracks of the stitched fleet export are grouped by which MEMBER
        served the request, not which OS process ran it."""
        with tracing.scoped_identity(getattr(self.api, "instance", None)):
            self._route_identified(method)

    def _route_identified(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        self._request_id = (self.headers.get("X-Cook-Request-Id")
                            or uuidlib.uuid4().hex[:16])
        self._status = 500
        self._bytes_out = 0
        # per-request response headers the dispatch layer fills (the
        # serving-plane contract: X-Cook-Replication-Offset/-Age-Ms on
        # follower-served reads, X-Cook-Commit-Offset on leader writes)
        self._resp_headers: Dict[str, str] = {}
        # keep-alive connections reuse this handler instance: a stale
        # identity from the previous request must not be attributed to
        # one that fails authentication
        self._auth_user = ""
        obs = self.api.request_obs
        if not (obs.enabled and tracing.tracer.enabled):
            self._handle(method, parsed)
            return
        endpoint = instrument.endpoint_template(method, parsed.path)
        remote = tracing.parse_traceparent(self.headers.get("traceparent"))
        try:
            bytes_in = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            # a garbage Content-Length must not kill the connection
            # before _handle can answer it with a proper error
            bytes_in = 0
        obs.begin()
        t0 = time.perf_counter()
        trace_id = None
        phases: Dict[str, float] = {}
        try:
            with tracing.collect_phases() as phases, \
                    tracing.span("http.request", remote_parent=remote,
                                 endpoint=endpoint, method=method,
                                 request_id=self._request_id) as sp:
                trace_id = getattr(sp, "trace_id", None)
                self._handle(method, parsed)
                sp.set_tag("status", self._status)
                user = str(getattr(self, "_auth_user", "") or "")
                if user:
                    sp.set_tag("user", user)
        finally:
            obs.end(
                method=method, endpoint=endpoint, status=self._status,
                duration_s=time.perf_counter() - t0, phases=phases,
                params=(urllib.parse.parse_qs(parsed.query)
                        if parsed.query else {}),
                request_id=self._request_id, trace_id=trace_id,
                user=str(getattr(self, "_auth_user", "") or ""),
                bytes_in=bytes_in, bytes_out=self._bytes_out,
                objective_s=self.api.config.slo
                .endpoint_latency_objective_s)

    def _drained_bucket_reject(self) -> bool:
        """Ingress fast path for the stampede case (DAGOR: reject at
        the cheapest possible layer): a user whose submission bucket is
        fully drained cannot admit ANY batch — every batch needs at
        least one token — so answer the 429 before the body is parsed.
        A stampeding client then costs the server one header parse and
        a raw body drain, not a JSON decode + validation pass; the
        saved CPU is exactly the goodput retained under overload
        (bench.py ``overload`` leg).  Behavior-equivalent to the
        ``_admit_submission`` bucket check, just earlier and cheaper:
        a non-empty bucket falls through to the full front door."""
        rl = self.api.rate_limits.job_submission
        if not getattr(rl, "enforce", False):
            return False
        user = str(self._auth_user or "")
        if rl.get_token_count(user) > 0:
            return False
        from ..utils.metrics import registry
        registry.counter_inc("cook_admission_rejections", 1.0,
                             {"scope": "user", "reason": "rate-limited"})
        try:
            leftover = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            leftover = 0
        if leftover:
            self.rfile.read(leftover)  # keep the keep-alive conn sound
        retry = max(1, min(int(rl.retry_after_s(user, 1)) + 1, 3600))
        self._respond(429, {"error": "job submission rate limit "
                                     "exceeded",
                            "reason": "rate-limited", "scope": "user",
                            "request_id": self._request_id},
                      extra_headers={"Retry-After": str(retry)})
        return True

    def _handle(self, method: str, parsed) -> None:
        try:
            if not self._check_ip_limit():
                return
            self._auth_user = self._authenticate()
            if method == "POST" and parsed.path == "/jobs" \
                    and self._drained_bucket_reject():
                return
            params = urllib.parse.parse_qs(parsed.query)
            payload = self._dispatch(method, parsed.path, params)
            if method in ("POST", "PUT", "DELETE") \
                    and self.api.read_view is None:
                # leader/standalone write: return the commit position
                # ("<epoch>:<offset>", offset-space-qualified) so the
                # client can demand read-your-writes from followers
                if self.api.store.commit_offset():
                    self._resp_headers.setdefault(
                        "X-Cook-Commit-Offset",
                        self.api.store.commit_token())
            self._respond(200, payload,
                          extra_headers={
                              **self._resp_headers,
                              **(getattr(self, "_auth_respond_headers",
                                         None) or {})})
        except _Redirect as r:
            # 307 preserves the method+body, as the reference's
            # leader-redirect does. Drain any unread body first: leaving it
            # on the socket corrupts the next keep-alive request.
            leftover = int(self.headers.get("Content-Length", 0))
            if leftover:
                self.rfile.read(leftover)
            self._status = 307
            self.send_response(307)
            self.send_header("Location", r.location)
            self.send_header("X-Cook-Request-Id", self._request_id)
            self.send_header("Content-Length", "0")
            self.end_headers()
        except ApiError as e:
            # the request id rides the error BODY too: a pasted error
            # report alone is joinable to /debug/requests and the trace
            self._respond(e.status,
                          {"error": e.message,
                           "request_id": self._request_id, **e.extra},
                          extra_headers={
                              **getattr(self, "_resp_headers", {}),
                              **(e.headers or {})})
        except ReplicationIndeterminate as e:
            # write paths that don't build their own ambiguous-outcome
            # body (kill/retry/status — all idempotent): the transaction
            # is applied locally but unconfirmed on the mirror
            self._respond(504, {"error": str(e), "indeterminate": True,
                                "request_id": self._request_id})
        except StorageFullError as e:
            # ENOSPC clean abort (state/store.py): the journal excised
            # the torn append, in-memory state matches disk, nothing was
            # committed.  Escalation happens HERE rather than inside the
            # store because force_shed_writes journals its stage flip —
            # doing that under the store lock on a full disk would
            # recurse into the same failing append.
            try:
                ctrl = self.api.admission_controller()
                if ctrl is not None:
                    ctrl.force_shed_writes("storage:enospc")
            except Exception:
                pass
            self._respond(503, {"error": str(e), "storage_full": True,
                                "request_id": self._request_id},
                          extra_headers={"Retry-After": "30"})
        except Exception as e:  # pragma: no cover
            self._respond(500, {"error": f"internal error: {e}",
                                "request_id": self._request_id})

    # ------------------------------------------------------------- dispatch
    _LOCAL_PATHS = {"/info", "/debug", "/debug/cycles", "/debug/trace",
                    "/debug/trace/spans", "/debug/fleet",
                    "/debug/federation/summary",
                    "/debug/faults", "/debug/replication",
                    "/debug/requests", "/debug/health", "/debug/storage",
                    "/metrics",
                    "/metrics/fleet",
                    "/failure_reasons", "/settings", "/swagger-docs",
                    "/swagger-ui"}

    #: GET paths a replication standby with a live read view serves
    #: LOCALLY (bounded staleness, labeled by the replication headers)
    #: instead of 307-redirecting — ROADMAP item 1's read fleet
    _FOLLOWER_READ_PATHS = {
        "/jobs", "/rawscheduler", "/group", "/list", "/running",
        "/usage", "/share", "/quota", "/pools", "/queue",
        "/unscheduled_jobs", "/stats/instances"}

    @classmethod
    def _follower_readable(cls, path: str, parts: List[str]) -> bool:
        if path in cls._FOLLOWER_READ_PATHS:
            return True
        if len(parts) == 2 and parts[0] in ("jobs", "instances"):
            return True
        return (len(parts) == 4 and parts[0] == "debug"
                and parts[1] == "job" and parts[3] == "timeline")

    @staticmethod
    def _parse_min_offset(token: str):
        """An X-Cook-Min-Offset token: ``<epoch>:<offset>`` (the epoch
        qualifies the journal offset SPACE) or bare ``<offset>``.
        Returns (epoch or None, offset); raises 400 on garbage."""
        try:
            if ":" in token:
                ep, _, off = token.partition(":")
                return int(ep), int(off)
            return None, int(token)
        except ValueError:
            raise ApiError(400, "malformed X-Cook-Min-Offset")

    def _redirect(self, base: str, path: str) -> None:
        """Raise the 307 to ``base``, preserving this request's query."""
        query = urllib.parse.urlparse(self.path).query
        raise _Redirect(base + path + ("?" + query if query else ""))

    def _serve_from_follower(self, target: str, path: str) -> None:
        """Admit this GET to the local read view: honor the client's
        read-your-writes token (wait briefly, else redirect to the
        leader) and attach the staleness contract headers."""
        api = self.api
        rv = api.read_view
        # brownout stage >= 2 (sched/admission.py, journaled by the
        # leader and replicated into this mirror): the min-offset wait
        # gate RELAXES — reads stop queueing behind replication under
        # overload and serve bounded-stale instead.  The staleness
        # contract stays honest: the real age rides the response
        # headers, an unsatisfiable token still redirects (read-your-
        # writes is never faked), and the degrade is visible via
        # X-Cook-Brownout.
        brownout = api.brownout_stage() >= 2
        wait_s = api.config.serving.min_offset_wait_seconds
        if brownout:
            wait_s *= api.config.admission.relaxed_offset_wait_factor
        want = self.headers.get("X-Cook-Min-Offset")
        if want is not None:
            # vector-aware gate (the partitioned plane's token form —
            # entries satisfied against the mirror of THEIR partition);
            # legacy single tokens go through the same method
            gate = getattr(rv, "wait_commit_token", None)
            try:
                if gate is not None:
                    ok = gate(want, wait_s)
                else:
                    ep, off = self._parse_min_offset(want)
                    ok = rv.wait_token(ep, off, wait_s)
            except ValueError:
                raise ApiError(400, "malformed X-Cook-Min-Offset")
            if not ok:
                # still behind the client's own write (or mirroring an
                # EARLIER leadership's / a SIBLING partition's offset
                # space): the leader is the only node that can
                # guarantee read-your-writes
                self._redirect(target, path)
        api.follower_reads += 1
        from ..utils.metrics import registry
        registry.counter_inc("cook_follower_reads")
        if brownout:
            self._resp_headers["X-Cook-Brownout"] = "stale-reads"
        self._resp_headers["X-Cook-Replication-Offset"] = str(rv.offset)
        self._resp_headers["X-Cook-Replication-Age-Ms"] = \
            str(round(rv.age_ms(), 1))

    def _dispatch(self, method: str, path: str, params: Dict):
        api = self.api
        parts = [p for p in path.split("/") if p]
        if path not in self._LOCAL_PATHS:
            target = api.leader_redirect_target()
            if target is not None:
                if method == "GET" and api.read_view is not None \
                        and self._follower_readable(path, parts):
                    # serve from the live mirror instead of redirecting
                    # (may itself redirect when a read-your-writes token
                    # cannot be satisfied in time)
                    self._serve_from_follower(target, path)
                else:
                    self._redirect(target, path)
            elif method == "GET" \
                    and self.headers.get("X-Cook-Min-Offset") \
                    and api.fence_guard is not None and api.fence_guard():
                # a DEPOSED leader cannot honor a read-your-writes token:
                # the successor holds commits beyond this journal's fence
                # epoch, so offsets here no longer bound staleness.
                # Plain reads stay served (honest best-effort, clients
                # re-resolve the leader); token-bearing reads refuse.
                successor = api.elector.leader_url() if api.elector \
                    else None
                if successor and successor != api.node_url:
                    self._redirect(successor, path)
                raise ApiError(
                    503, "this leader has been superseded (stale "
                         "election epoch); its offsets cannot satisfy "
                         "read-your-writes — retry against the new "
                         "leader", headers={"Retry-After": "1"})
            if method in ("POST", "PUT", "DELETE") \
                    and api.fence_guard is not None and api.fence_guard():
                # deposed replication leader: a successor minted a higher
                # election epoch.  Journal fencing already rejects the
                # next append, but accepting the request at all risks a
                # split-brain write observed by clients — flip the write
                # path immediately (redirect when the successor is
                # already published, 503 otherwise).
                successor = api.elector.leader_url() if api.elector \
                    else None
                if successor and successor != api.node_url:
                    self._redirect(successor, path)
                raise ApiError(
                    503, "this leader has been superseded (stale "
                         "election epoch); retry against the new leader",
                    headers={"Retry-After": "1"})
        if method == "GET":
            if path == "/jobs" or path == "/rawscheduler":
                return api.get_jobs(params)
            if len(parts) == 2 and parts[0] == "jobs":
                return api.get_jobs({"uuid": [parts[1]]})[0]
            if len(parts) == 2 and parts[0] == "instances":
                inst = api.store.instance(parts[1])
                if inst is None:
                    raise ApiError(404, f"no such instance {parts[1]}")
                return instance_to_json(inst)
            if path == "/queue":
                return api.queue(self._user())
            if path == "/group":
                return api.group_get(params)
            if path == "/list":
                return api.list_jobs(params)
            if path == "/running":
                return api.running()
            if path == "/usage":
                return api.usage(params, self._user())
            if path == "/share":
                return api.share_get(params)
            if path == "/quota":
                return api.quota_get(params)
            if path == "/pools":
                return api.pools()
            if path == "/unscheduled_jobs":
                return api.unscheduled(params)
            if path == "/failure_reasons":
                return api.failure_reasons()
            if path == "/stats/instances":
                return api.stats_instances(params, self._user())
            if path == "/settings":
                return api.settings()
            if path == "/info":
                return api.info()
            if path == "/debug":
                return api.debug()
            if path == "/debug/cycles":
                return api.debug_cycles(params)
            if path == "/debug/trace":
                return api.debug_trace(params)
            if path == "/debug/faults":
                return api.debug_faults()
            if path == "/debug/replication":
                return api.debug_replication()
            if path == "/debug/requests":
                return api.debug_requests(params)
            if path == "/debug/health":
                return api.debug_health()
            if path == "/debug/storage":
                return api.debug_storage()
            if path == "/debug/optimizer":
                return api.debug_optimizer()
            if path == "/debug/trace/spans":
                return api.debug_trace_spans(params)
            if path == "/debug/fleet":
                return api.debug_fleet()
            if path == "/debug/federation/summary":
                return api.debug_federation_summary()
            if len(parts) == 4 and parts[0] == "debug" \
                    and parts[1] == "job" and parts[3] == "timeline":
                return api.debug_job_timeline(parts[2])
            if path == "/swagger-docs":
                return api.swagger_docs()
            if path == "/swagger-ui":
                return {"_html": api.swagger_ui()}
            if path == "/metrics":
                return {"_raw": api.metrics()}
            if path == "/metrics/fleet":
                return {"_raw": api.metrics_fleet()}
            if path == "/compute-clusters":
                return api.compute_clusters()
            if path == "/incremental-config":
                return api.incremental_get()
        elif method == "POST":
            if len(parts) == 2 and parts[0] == "compute-clusters":
                return api.compute_cluster_update(parts[1], self._body(),
                                                  self._user())
            if path == "/incremental-config":
                return api.incremental_set(self._body(), self._user())
            if path == "/jobs" or path == "/rawscheduler":
                return api.submit_jobs(self._body(), self._user())
            if path == "/retry":
                return api.retry(self._body(), self._user())
            if path == "/share":
                return api.share_set(self._body(), self._user())
            if path == "/quota":
                return api.quota_set(self._body(), self._user())
            if path == "/settings/rebalancer":
                return api.rebalancer_set(self._body(), self._user())
            if len(parts) == 2 and parts[0] == "progress":
                return api.progress(parts[1], self._body())
            if path == "/shutdown-leader":
                return api.shutdown_leader(self._user())
        elif method == "PUT":
            if path == "/retry":
                return api.retry(self._body(), self._user(),
                                 deprecated=False)
        elif method == "DELETE":
            if path == "/jobs" or path == "/rawscheduler":
                return api.kill_jobs(params, self._user())
            if path == "/instances":
                return api.kill_instances(params, self._user())
            if path == "/group":
                return api.group_kill(params, self._user())
            if path == "/share":
                return api.share_delete(params, self._user())
            if path == "/quota":
                return api.quota_delete(params, self._user())
        raise ApiError(404, f"no such endpoint {method} {path}")

    def do_OPTIONS(self):
        """CORS preflight (reference: cors.clj preflight handling): 200 with
        allow headers for an allowed origin, 403 otherwise."""
        if not self._check_ip_limit():
            return
        origin = self.headers.get("Origin", "")
        if not self.api.origin_allowed(origin):
            self._respond(403, {"error": f"Origin {origin} not allowed"})
            return
        self.send_response(200)
        self.send_header("Access-Control-Allow-Origin", origin)
        self.send_header("Access-Control-Allow-Credentials", "true")
        self.send_header("Access-Control-Allow-Methods",
                         "GET, POST, PUT, DELETE, OPTIONS")
        self.send_header(
            "Access-Control-Allow-Headers",
            self.headers.get("Access-Control-Request-Headers", "*"))
        self.send_header("Access-Control-Max-Age", "86400")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_DELETE(self):
        self._route("DELETE")

    def do_PUT(self):
        self._route("PUT")


class _CookHTTPServer(ThreadingHTTPServer):
    # a deep accept backlog: reader fleets open their keep-alive
    # connections in a burst at client start; the default backlog (5)
    # made that burst retry its SYNs — part of the 4->8 reader QPS
    # regression in the r8 rest_plane baseline
    request_queue_size = 128
    daemon_threads = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        # live client sockets, so kill() can sever established
        # keep-alive connections the way a process death would —
        # shutdown() alone only stops the LISTENER, leaving pooled
        # connections served by their handler threads indefinitely
        self._live: set = set()
        self._live_mu = threading.Lock()

    def process_request(self, request, client_address):
        with self._live_mu:
            self._live.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._live_mu:
            self._live.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self) -> None:
        with self._live_mu:
            live = list(self._live)
            self._live.clear()
        for sock in live:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class ApiServer:
    """Threaded HTTP server wrapper."""

    def __init__(self, api: CookApi, host: str = "127.0.0.1", port: int = 0):
        # _Handler._respond serves the {"_raw"}/{"_html"} text surfaces
        # (/metrics, /swagger-ui) itself — no wrapper needed
        handler = type("BoundHandler", (_Handler,), {"api": api})
        self.server = _CookHTTPServer((host, port), handler)
        self.host, self.port = self.server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def kill(self) -> None:
        """Hard-stop: close the listener AND sever every established
        client connection, like a process death would.  The graceful
        stop() leaves keep-alive connections draining — correct for
        shutdown, wrong for an outage drill (sim/federation.py's
        full-cell kill needs remote sockets to actually die)."""
        self.server.shutdown()
        self.server.server_close()
        self.server.close_all_connections()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
