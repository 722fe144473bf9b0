"""The port's copy of ``cook_tpu/state/schema.py`` (imports re-rooted).

Entity schema: jobs, instances, groups, pools, shares, quotas.

Mirrors the reference Datomic schema (reference: scheduler/src/cook/schema.clj:20-1100)
as plain Python dataclasses.  The reference keeps ~200 attributes; we keep the
behavior-bearing subset and a ``labels``/``env`` escape hatch for the rest.

Resource vectors are ordered (cpus, mem, gpus, disk) so host-side entities
convert losslessly into the (N x R) tensors consumed by the kernels in
``cook_tpu.ops``.
"""

from __future__ import annotations

import dataclasses
import enum
import time
import uuid as uuidlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Resource dimension order used by every kernel in cook_tpu.ops.
RESOURCE_DIMS: Tuple[str, ...] = ("cpus", "mem", "gpus", "disk")
NUM_RESOURCE_DIMS = len(RESOURCE_DIMS)

DEFAULT_JOB_PRIORITY = 50  # reference: util/default-job-priority (tools.clj)
MAX_JOB_PRIORITY = 100


# Job-label keys with placement semantics (consumed by the constraint
# compiler in sched/constraints.py and the columnar index's complex-job
# classifier in state/index.py; reference: constraints.clj:122,164)
GPU_MODEL_LABEL = "gpu-model"
DISK_TYPE_LABEL = "disk-type"


class JobState(enum.Enum):
    """Job lifecycle (reference: schema.clj job state machine, :job/update-state
    schema.clj:1202-1239): waiting <-> running -> completed."""

    WAITING = "waiting"
    RUNNING = "running"
    COMPLETED = "completed"


class InstanceStatus(enum.Enum):
    """Instance lifecycle (reference: :instance/update-state schema.clj:1242-1308):
    unknown -> running -> {success, failed}."""

    UNKNOWN = "unknown"
    RUNNING = "running"
    SUCCESS = "success"
    FAILED = "failed"


TERMINAL_INSTANCE_STATUSES = (InstanceStatus.SUCCESS, InstanceStatus.FAILED)


@dataclass(frozen=True)
class Reason:
    """Failure reason (reference: scheduler/src/cook/mesos/reason.clj).

    ``mea_culpa`` failures are the cluster's fault and do not consume user
    retries (up to ``failure_limit`` occurrences, None = unlimited).
    """

    code: int
    name: str
    mea_culpa: bool = False
    failure_limit: Optional[int] = None


class Reasons:
    """Registry of failure reasons, mirroring reason.clj's reason table."""

    NORMAL_EXIT = Reason(0, "normal-exit")
    UNKNOWN = Reason(1, "unknown")
    KILLED_BY_USER = Reason(2, "killed-by-user")
    PREEMPTED_BY_REBALANCER = Reason(3, "preempted-by-rebalancer", mea_culpa=True)
    PREEMPTED_BY_POOL = Reason(4, "preempted-by-pool", mea_culpa=True)
    MAX_RUNTIME_EXCEEDED = Reason(5, "max-runtime-exceeded")
    NON_ZERO_EXIT = Reason(6, "non-zero-exit")
    NODE_LOST = Reason(7, "node-lost", mea_culpa=True)
    CONTAINER_LAUNCH_FAILED = Reason(8, "container-launch-failed", mea_culpa=True, failure_limit=3)
    HEARTBEAT_LOST = Reason(9, "heartbeat-lost", mea_culpa=True)
    CHECKPOINT_FAILURE = Reason(10, "checkpoint-failure", mea_culpa=True, failure_limit=3)
    STRAGGLER = Reason(11, "straggler", mea_culpa=True)
    CANCELLED_DURING_LAUNCH = Reason(12, "cancelled-during-launch", mea_culpa=True)
    REASON_POD_SUBMISSION_FAILED = Reason(13, "pod-submission-failed", mea_culpa=True, failure_limit=10)
    # pod entered phase Unknown: kubernetes lost track of it; the cluster's
    # fault, retry free (reference: the controller's :pod/unknown arms)
    UNKNOWN_MEA_CULPA = Reason(14, "unknown-mea-culpa", mea_culpa=True, failure_limit=3)
    # stuck/unschedulable pod reaped by the detector
    # (reference: kubernetes/api.clj:1820-1846)
    POD_STUCK = Reason(15, "pod-stuck", mea_culpa=True, failure_limit=3)
    # task exceeded its requested memory and was hard-killed by the agent
    # (reference: "Container memory limit exceeded", reason 2002 in
    # reason.clj — the user's fault, consumes a retry)
    MEMORY_LIMIT_EXCEEDED = Reason(16, "memory-limit-exceeded")
    # a gang sibling failed: this (blameless) member was killed by the
    # gang policy so the whole gang requeues atomically (docs/GANG.md).
    # Unlimited free retries — the member that actually failed carries
    # its own reason and consumes ITS budget; like
    # CANCELLED_DURING_LAUNCH, the kill proves nothing about the host,
    # so the matcher does not novel-host-exclude it.
    GANG_MEMBER_LOST = Reason(17, "gang-member-lost", mea_culpa=True)
    # an ELASTIC gang member shed by the resize pass (checkpoint/grace
    # shrink, docs/GANG.md elasticity): the cluster reclaimed surplus
    # capacity, the member did nothing wrong — mea-culpa, free retries,
    # no novel-host exclusion (the member wants its host back on grow),
    # and the gang policy never reacts to it (the gang stays whole at
    # its post-shrink size).
    GANG_RESIZED = Reason(18, "gang-resized", mea_culpa=True)
    # a whole CELL's capacity was reclaimed (spot/preemptible tier) or
    # lost outright and the federation router re-routed this job's
    # demand to a surviving cell (cook_tpu/federation): the platform
    # took the capacity back, the job did nothing wrong — mea-culpa,
    # free retries.  The refund is the spot tier's contract: capacity
    # is cheap BECAUSE reclaim costs the user nothing.
    CELL_RECLAIMED = Reason(19, "cell-reclaimed", mea_culpa=True)

    _by_code: Dict[int, Reason] = {}
    _by_name: Dict[str, Reason] = {}

    @classmethod
    def all(cls) -> List[Reason]:
        return [v for v in vars(cls).values() if isinstance(v, Reason)]

    @classmethod
    def by_code(cls, code: int) -> Reason:
        if not cls._by_code:
            cls._by_code = {r.code: r for r in cls.all()}
        return cls._by_code.get(code, cls.UNKNOWN)

    @classmethod
    def by_name(cls, name: str) -> Reason:
        if not cls._by_name:
            cls._by_name = {r.name: r for r in cls.all()}
        return cls._by_name.get(name, cls.UNKNOWN)


@dataclass(frozen=True)
class Resources:
    """A point in resource space. Arithmetic is element-wise.

    Reference jobs carry cpus/mem(/gpus); hosts additionally advertise disk and
    port ranges (ports are handled host-side at launch, mesos/task.clj:209-237).
    """

    cpus: float = 0.0
    mem: float = 0.0
    gpus: float = 0.0
    disk: float = 0.0

    def as_tuple(self) -> Tuple[float, float, float, float]:
        return (self.cpus, self.mem, self.gpus, self.disk)

    def __add__(self, other: "Resources") -> "Resources":
        return Resources(*(a + b for a, b in zip(self.as_tuple(), other.as_tuple())))

    def __sub__(self, other: "Resources") -> "Resources":
        return Resources(*(a - b for a, b in zip(self.as_tuple(), other.as_tuple())))

    def fits_in(self, other: "Resources") -> bool:
        return all(a <= b for a, b in zip(self.as_tuple(), other.as_tuple()))

    def non_negative(self) -> bool:
        return all(a >= 0 for a in self.as_tuple())


@dataclass
class Constraint:
    """User-specified placement constraint (reference: schema.clj
    :constraint/{attribute,operator,pattern}; constraints.clj:356-430).

    operator is one of EQUALS ("EQUALS") today; the mask compiler in
    cook_tpu.sched.constraints interprets it against host attributes.
    """

    attribute: str
    operator: str
    pattern: str


class CheckpointMode(enum.Enum):
    # reference: schema.clj :job/checkpoint modes
    AUTO = "auto"
    PERIODIC = "periodic"
    PREEMPTION = "preemption"


@dataclass
class Checkpoint:
    """Job checkpointing declaration (reference: schema.clj:84, kubernetes/api.clj:1173-1267)."""

    mode: CheckpointMode = CheckpointMode.AUTO
    volume_mounts: List[str] = field(default_factory=list)
    period_sec: Optional[int] = None
    options: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Application:
    """Submitting-application metadata (reference: schema.clj
    :job.application/{name,version,workload-class,workload-id,
    workload-details})."""

    name: str = ""
    version: str = ""
    workload_class: str = ""
    workload_id: str = ""
    workload_details: str = ""


@dataclass
class Job:
    """A user's unit of work (reference: schema.clj:20-682 job attributes)."""

    uuid: str
    user: str
    command: str = ""
    name: str = "cookjob"
    resources: Resources = field(default_factory=lambda: Resources(cpus=1.0, mem=128.0))
    priority: int = DEFAULT_JOB_PRIORITY  # 0-100
    max_retries: int = 1
    max_runtime_ms: int = 2**53
    expected_runtime_ms: Optional[int] = None
    pool: str = "default"
    state: JobState = JobState.WAITING
    submit_time_ms: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    env: Dict[str, str] = field(default_factory=dict)
    container: Optional[Dict[str, Any]] = None
    # count of host ports to assign at launch (reference: :job/ports,
    # assigned from the offer's ranges in mesos/task.clj:209-237 and
    # exported as PORT0.. in the task environment)
    ports: int = 0
    # artifacts fetched into the sandbox before the command runs
    # (reference: :job/uri, mesos fetcher semantics task.clj:114-160);
    # each: {"value": path-or-url, "executable": bool, "extract": bool,
    # "cache": bool}
    uris: List[Dict[str, Any]] = field(default_factory=list)
    # executor choice (reference: :job/executor "cook"|"mesos"): "cook"
    # runs under the progress-tracking executor, "" = backend default
    executor: str = ""
    # per-job progress plumbing (reference: :job/progress-output-file,
    # :job/progress-regex-string)
    progress_output_file: str = ""
    progress_regex_string: str = ""
    # declared input datasets for locality-aware plugins (reference:
    # :job/datasets, consumed by the data-locality fitness calculator)
    datasets: List[Dict[str, Any]] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    group: Optional[str] = None  # group uuid
    application: Optional[Application] = None
    checkpoint: Optional[Checkpoint] = None
    disable_mea_culpa_retries: bool = False
    # commit-latch: submitted-but-uncommitted jobs are invisible to queries
    # (reference: metatransaction/core.clj filter-committed; schema.clj:28).
    committed: bool = True
    # instances by task_id, newest last
    instances: List[str] = field(default_factory=list)
    # count of mea-culpa failures per reason code (for failure_limit accounting,
    # reference: :job/all-attempts-consumed? logic)
    mea_culpa_failures: Dict[int, int] = field(default_factory=dict)
    # set when the job reached completed because the user killed it
    user_killed: bool = False
    # rebalancer host reservation consumed by the matcher (rebalancer.clj:419-432)
    reserved_host: Optional[str] = None
    # "under investigation" flag driving the unscheduled-jobs explainer
    # (reference: :job/under-investigation; the next match cycle records a
    # placement-failure summary for investigated jobs, fenzo_utils.clj:75-99)
    under_investigation: bool = False
    # {"resources": {"cpus": host_count, ...},
    #  "constraints": {"novel_host_constraint": host_count, ...}}
    # (reference: :job/last-fenzo-placement-failure)
    last_placement_failure: Optional[Dict[str, Any]] = None
    last_waiting_start_ms: int = 0
    # request trace context stamped at submission (the client's W3C
    # traceparent / the REST ingress `http.request` span): joins this
    # job's audit lifecycle to the serving-plane trace so
    # `GET /debug/trace?job=` can stitch the submission request next to
    # the cycle that launched it (docs/OBSERVABILITY.md)
    trace_id: Optional[str] = None

    def attempts_used(self, instances: Dict[str, "Instance"]) -> int:
        """Number of retries consumed: failed, non-mea-culpa instances
        (mea-culpa failures under their limit don't count;
        reference: :job/all-attempts-consumed? + reason failure limits)."""
        used = 0
        mea_culpa_counts: Dict[int, int] = {}
        for tid in self.instances:
            inst = instances.get(tid)
            if inst is None or inst.status is not InstanceStatus.FAILED:
                continue
            reason = Reasons.by_code(inst.reason_code if inst.reason_code is not None else 1)
            if reason.mea_culpa and not self.disable_mea_culpa_retries:
                n = mea_culpa_counts.get(reason.code, 0) + 1
                mea_culpa_counts[reason.code] = n
                if reason.failure_limit is None or n <= reason.failure_limit:
                    continue  # free retry
            used += 1
        return used


@dataclass
class Instance:
    """One attempt at running a job (reference: schema.clj:683-1100)."""

    task_id: str
    job_uuid: str
    status: InstanceStatus = InstanceStatus.UNKNOWN
    hostname: str = ""
    slave_id: str = ""
    compute_cluster: str = ""
    start_time_ms: int = 0
    end_time_ms: Optional[int] = None
    mesos_start_time_ms: Optional[int] = None
    reason_code: Optional[int] = None
    preempted: bool = False
    progress: int = 0
    progress_message: str = ""
    progress_sequence: int = 0
    exit_code: Optional[int] = None
    sandbox_directory: str = ""
    # base URL of the instance's sandbox file server (the reference exposes
    # output_url on instance maps for Mesos-agent / sidecar file access)
    output_url: str = ""
    ports: List[int] = field(default_factory=list)
    queue_time_ms: int = 0
    cancelled: bool = False
    # "location" attribute of the host this instance ran on, recorded at
    # launch so checkpoint-locality can pin the job's next instance to the
    # same location (reference: constraints.clj:218-240 reads the prior
    # instance's node; here the matcher snapshots the offer attribute)
    node_location: str = ""


class GroupPlacementType(enum.Enum):
    # reference: schema.clj host-placement types; constraints.clj:586-676
    ALL = "all"
    UNIQUE = "unique"
    BALANCED = "balanced"
    ATTRIBUTE_EQUALS = "attribute-equals"


# Gang member-failure policies (docs/GANG.md): what happens to the rest
# of a gang when one member's instance fails.
GANG_POLICY_REQUEUE = "requeue"   # kill siblings mea-culpa, whole gang retries
GANG_POLICY_KILL = "kill"         # kill the whole gang's jobs outright
GANG_POLICIES = (GANG_POLICY_REQUEUE, GANG_POLICY_KILL)


@dataclass
class Group:
    """Job group with placement constraints + straggler handling
    (reference: schema.clj group attributes; group.clj).

    With ``gang=True`` the group is a multi-host slice job scheduled
    all-or-nothing (docs/GANG.md): all ``gang_size`` members must match
    in the same cycle, launch in one guard transaction, and — under the
    default ``requeue`` policy — a member failure kills and requeues the
    whole gang.  ``gang_topology`` optionally names a host attribute
    (e.g. "slice-id") whose value must be equal across every member's
    host, with the matcher preferring the slice with the most feasible
    capacity.

    ELASTIC gangs (docs/GANG.md elasticity): ``gang_min``/``gang_max``
    relax the rigid size — the gang launches whole at any member count
    in ``[gang_min, gang_max]``, grows into spare capacity and shrinks
    under pressure via the resize pass.  ``0`` (the default) means
    "same as gang_size": a group with ``gang_min == gang_max ==
    gang_size`` is exactly the rigid gang, decision-identical to a
    pre-elasticity build."""

    uuid: str
    name: str = "defaultgroup"
    placement_type: GroupPlacementType = GroupPlacementType.ALL
    placement_attribute: Optional[str] = None
    placement_minimum: int = 2  # for BALANCED
    straggler_quantile: Optional[float] = None   # e.g. 0.5
    straggler_multiplier: Optional[float] = None  # e.g. 2.0
    jobs: List[str] = field(default_factory=list)
    gang: bool = False
    gang_size: int = 0
    gang_topology: Optional[str] = None
    gang_policy: str = GANG_POLICY_REQUEUE
    # elasticity bounds; 0 = rigid (defaults to gang_size)
    gang_min: int = 0
    gang_max: int = 0


def gang_bounds(group) -> Tuple[int, int]:
    """The effective ``(min, max)`` member-count bounds of a gang group
    (docs/GANG.md elasticity).  Unset (0) bounds default to
    ``gang_size``, so rigid gangs read ``(size, size)``."""
    size = int(getattr(group, "gang_size", 0) or 0)
    lo = int(getattr(group, "gang_min", 0) or 0) or size
    hi = int(getattr(group, "gang_max", 0) or 0) or size
    return lo, hi


def gang_is_elastic(group) -> bool:
    """True when the gang's legal member count differs from its rigid
    all-or-nothing declaration — the gate every elastic-only code path
    checks so rigid gangs stay decision-identical to a pre-elasticity
    build.  NOTE ``lo != hi`` alone would be wrong: a gang declaring
    ``min == max < size`` (run exactly M of the N members) must take
    the elastic admission/reduction/growth-cap path too, or the rigid
    cohort gate (all N) and the min-threshold reduction (M) strand a
    permanent partial gang between them."""
    if not getattr(group, "gang", False):
        return False
    size = int(getattr(group, "gang_size", 0) or 0)
    lo, hi = gang_bounds(group)
    return not (lo == hi == size)


class DruMode(enum.Enum):
    # reference: schema.clj :pool/dru-mode default|gpu
    DEFAULT = "default"
    GPU = "gpu"


class SchedulerKind(enum.Enum):
    """Which matcher drives a pool (reference: config.clj pool-schedulers;
    'fenzo' -> our batched greedy kernel, 'kubernetes' -> direct backpressure mode)."""

    BATCH = "batch"       # rank + bin-pack match (Fenzo-style)
    DIRECT = "direct"     # direct submission under backpressure (Kenzo-style)


@dataclass
class Pool:
    """Scheduling pool (reference: schema.clj pool attributes; pool.clj)."""

    name: str
    purpose: str = ""
    state: str = "active"  # active | inactive
    dru_mode: DruMode = DruMode.DEFAULT
    scheduler: SchedulerKind = SchedulerKind.BATCH


@dataclass
class ShareEntry:
    """Per-user per-pool fair-share weights = DRU divisors
    (reference: share.clj; 'default' user is the fallback)."""

    user: str
    pool: str
    resources: Dict[str, float] = field(default_factory=dict)
    reason: str = ""


@dataclass
class QuotaEntry:
    """Per-user per-pool hard caps, including job count
    (reference: quota.clj; :count is a quota dimension)."""

    user: str
    pool: str
    resources: Dict[str, float] = field(default_factory=dict)  # cpus/mem/gpus
    count: float = float("inf")
    reason: str = ""


def new_uuid() -> str:
    return str(uuidlib.uuid4())


def now_ms() -> int:
    return int(time.time() * 1000)


def job_usage(job: Job) -> Dict[str, float]:
    """Usage map of one job, including count=1 (reference: tools.clj job->usage)."""
    u = {"count": 1.0, "cpus": job.resources.cpus, "mem": job.resources.mem}
    if job.resources.gpus:
        u["gpus"] = job.resources.gpus
    return u


def add_usage(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def below_quota(quota: Dict[str, float], usage: Dict[str, float]) -> bool:
    """True iff usage <= quota on every dimension present in usage
    (reference: tools.clj below-quota?, missing quota key treated as 0)."""
    return all(v <= quota.get(k, 0.0) for k, v in usage.items())


import copy as _copy


def _shallow(obj):
    """Fast shallow copy: copy.copy() routes dataclass instances through
    __reduce_ex__/_reconstruct, ~4x the cost of a __dict__ transplant."""
    c = obj.__class__.__new__(obj.__class__)
    c.__dict__.update(obj.__dict__)
    return c


def _clone_job(j: Job) -> Job:
    c = _shallow(j)  # new object, attributes shared
    # re-copy every mutable field so a txn fn mutating the clone can never
    # leak into the stored entity (Resources/enums/strs are immutable and
    # stay shared; rare nested dicts keep full deepcopy safety)
    c.labels = dict(j.labels)
    c.env = dict(j.env)
    c.instances = list(j.instances)
    c.mea_culpa_failures = dict(j.mea_culpa_failures)
    c.constraints = [_shallow(x) for x in j.constraints]
    c.uris = [dict(u) for u in j.uris]
    c.datasets = _copy.deepcopy(j.datasets) if j.datasets else []
    if j.container is not None:
        c.container = _copy.deepcopy(j.container)
    if j.application is not None:
        c.application = _shallow(j.application)
    if j.checkpoint is not None:
        k = _shallow(j.checkpoint)
        k.volume_mounts = list(j.checkpoint.volume_mounts)
        k.options = _copy.deepcopy(j.checkpoint.options)
        c.checkpoint = k
    if j.last_placement_failure is not None:
        c.last_placement_failure = _copy.deepcopy(j.last_placement_failure)
    return c


def _clone_instance(i: Instance) -> Instance:
    c = _shallow(i)
    c.ports = list(i.ports)
    return c


def _clone_group(g: Group) -> Group:
    c = _shallow(g)
    c.jobs = list(g.jobs)
    return c


def _clone_share(s: ShareEntry) -> ShareEntry:
    c = _shallow(s)
    c.resources = dict(s.resources)
    return c


def _clone_quota(q: QuotaEntry) -> QuotaEntry:
    c = _shallow(q)
    c.resources = dict(q.resources)
    return c


_CLONERS = {
    Job: _clone_job,
    Instance: _clone_instance,
    Group: _clone_group,
    Pool: _shallow,  # every Pool field is immutable
    ShareEntry: _clone_share,
    QuotaEntry: _clone_quota,
}


def fast_clone(ent: Any) -> Any:
    """Typed entity copy with deepcopy semantics at a fraction of the cost.

    ``copy.deepcopy``'s generic machinery (memo dict, reconstruct, per-object
    dispatch) dominates the store's transaction reads at 100k-job scale; a
    typed clone of the known entity classes is ~10x cheaper while preserving
    the same guarantee: mutating the returned object (including its mutable
    containers) never affects the stored original.  Unknown types fall back
    to deepcopy.
    """
    fn = _CLONERS.get(type(ent))
    return fn(ent) if fn is not None else _copy.deepcopy(ent)


# per-class field-name cache for to_json: the journal serializes every
# committed entity, so the generic ``dataclasses.asdict`` path (recursive
# deepcopy machinery, then to_json recursing AGAIN over the copy) was the
# single hottest function of the REST submit path — ~86% of an in-process
# batch submit's wall time at batch 20.  Walking getattr over cached
# field names emits the identical wire form at ~10x less cost (the same
# move fast_clone makes over copy.deepcopy).
_TO_JSON_FIELDS: Dict[type, tuple] = {}
_JSON_SCALARS = frozenset((str, int, float, bool, type(None)))


def to_json(obj: Any) -> Any:
    """Recursively convert entities to JSON-serializable structures."""
    cls = obj.__class__
    if cls in _JSON_SCALARS:
        return obj
    names = _TO_JSON_FIELDS.get(cls)
    if names is not None:
        return {n: to_json(getattr(obj, n)) for n in names}
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = tuple(f.name for f in dataclasses.fields(cls))
        _TO_JSON_FIELDS[cls] = names
        return {n: to_json(getattr(obj, n)) for n in names}
    if isinstance(obj, dict):
        return {k: to_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_json(v) for v in obj]
    return obj
