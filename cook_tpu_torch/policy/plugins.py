"""The port's copy of ``cook_tpu/policy/plugins.py`` (imports re-rooted).

Plugin extension points.

Mirrors the reference's eight plugin protocols (reference:
scheduler/src/cook/plugins/definitions.clj:18-67) with config-driven
registration (plugins/*.clj factory loading) and the launch filter's
accept/defer cache (plugins/launch.clj:140).
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..state.schema import Instance, Job


@dataclass
class PluginResult:
    """accepted/deferred verdict with an optional retry time (reference:
    plugins/definitions.clj FilterResult)."""

    status: str  # "accepted" | "rejected" | "deferred"
    message: str = ""
    cache_expires_at_s: Optional[float] = None

    @classmethod
    def accepted(cls, message: str = "", ttl_s: Optional[float] = None):
        return cls("accepted", message,
                   time.time() + ttl_s if ttl_s else None)

    @classmethod
    def rejected(cls, message: str = ""):
        return cls("rejected", message)

    @classmethod
    def deferred(cls, message: str = "", ttl_s: float = 60.0):
        return cls("deferred", message, time.time() + ttl_s)


class JobSubmissionValidator:
    """Accept/reject a job at submission (definitions.clj JobSubmissionValidator)."""

    def validate(self, job: Job) -> PluginResult:
        return PluginResult.accepted()


class JobSubmissionModifier:
    """Rewrite a job at submission time (definitions.clj JobSubmissionModifier)."""

    def modify(self, job: Job) -> Job:
        return job


class JobLaunchFilter:
    """Accept/defer a job right before it becomes considerable
    (definitions.clj JobLaunchFilter)."""

    def check(self, job: Job) -> PluginResult:
        return PluginResult.accepted()


class InstanceCompletionHandler:
    """Side effect after an instance completes (definitions.clj
    InstanceCompletionHandler)."""

    def on_completion(self, job: Job, instance: Instance) -> None:
        pass


class PoolSelector:
    """Pick the pool for a submitted job (definitions.clj PoolSelector)."""

    def select(self, job: Job, default_pool: str) -> str:
        return job.pool or default_pool


class JobAdjuster:
    """Adjust a job just before matching (definitions.clj JobAdjuster)."""

    def adjust(self, job: Job) -> Job:
        return job


class JobRouter:
    """Route a job to a scheduling variant (definitions.clj JobRouter)."""

    def route(self, job: Job) -> Optional[str]:
        return None


class FileUrlGenerator:
    """Build sandbox file-access URLs for an instance (definitions.clj
    FileUrlGenerator)."""

    def url(self, instance: Instance, path: str) -> Optional[str]:
        return None


@dataclass
class PluginRegistry:
    validators: List[JobSubmissionValidator] = field(default_factory=list)
    modifiers: List[JobSubmissionModifier] = field(default_factory=list)
    launch_filters: List[JobLaunchFilter] = field(default_factory=list)
    completion_handlers: List[InstanceCompletionHandler] = field(default_factory=list)
    pool_selector: PoolSelector = field(default_factory=PoolSelector)
    adjusters: List[JobAdjuster] = field(default_factory=list)
    router: JobRouter = field(default_factory=JobRouter)
    file_url_generator: FileUrlGenerator = field(default_factory=FileUrlGenerator)
    # launch-filter verdict cache: job uuid -> result (plugins/launch.clj:140)
    _launch_cache: Dict[str, PluginResult] = field(default_factory=dict)

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def from_config(cls, spec: Dict[str, Any]) -> "PluginRegistry":
        """Instantiate plugins from dotted-path factory names, the moral
        equivalent of the reference's symbol-resolving factory-fn loading.

        Each entry is either a dotted path string (no-arg construction) or
        ``{"factory": path, "kwargs": {...}}`` for parameterized plugins
        like PoolMoverPlugin."""

        def build(entry):
            if isinstance(entry, str):
                path, kwargs = entry, {}
            else:
                path, kwargs = entry["factory"], entry.get("kwargs", {})
            module, _, attr = path.rpartition(".")
            return getattr(importlib.import_module(module), attr)(**kwargs)

        reg = cls()
        slots = {
            "validators": reg.validators, "modifiers": reg.modifiers,
            "launch_filters": reg.launch_filters,
            "completion_handlers": reg.completion_handlers,
            "adjusters": reg.adjusters,
        }
        for slot, target in slots.items():
            for entry in spec.get(slot, []):
                target.append(build(entry))
        for slot in ("pool_selector", "router", "file_url_generator"):
            entry = spec.get(slot)
            if entry:
                setattr(reg, slot, build(entry))
        return reg

    # ------------------------------------------------------------- dispatch
    def validate_submission(self, job: Job) -> Optional[str]:
        for v in self.validators:
            result = v.validate(job)
            if result.status != "accepted":
                return result.message or "rejected by submission plugin"
        return None

    def modify_submission(self, job: Job) -> Job:
        for m in self.modifiers:
            job = m.modify(job)
        for a in self.adjusters:
            job = a.adjust(job)
        return job

    def launch_verdict_cached(self, uuid: str):
        """Non-materializing probe of the launch-verdict cache: True/False
        when a live cached verdict exists for the job uuid, None on miss
        (callers then fetch the entity and call launch_allowed).  Lets the
        columnar fused pack skip entity deep-copies in steady state."""
        cached = self._launch_cache.get(uuid)
        if cached is None:
            return None
        if (cached.cache_expires_at_s is not None
                and cached.cache_expires_at_s <= time.time()):
            return None
        return cached.status == "accepted"

    def cache_launch_verdict(self, uuid: str, allowed: bool,
                             ttl_s: float = 60.0) -> None:
        """Record a verdict without materializing a Job (used for rows whose
        entity has vanished from the store but not yet from the index)."""
        r = (PluginResult.accepted() if allowed
             else PluginResult.rejected("cached"))
        r.cache_expires_at_s = time.time() + ttl_s
        self._launch_cache[uuid] = r

    def launch_allowed(self, job: Job) -> bool:
        """Cached accept/defer check used by considerable-job selection."""
        if not self.launch_filters:
            return True
        cached = self._launch_cache.get(job.uuid)
        now = time.time()
        if cached is not None and (cached.cache_expires_at_s is None
                                   or cached.cache_expires_at_s > now):
            return cached.status == "accepted"
        verdict = PluginResult.accepted()
        for f in self.launch_filters:
            verdict = f.check(job)
            if verdict.status != "accepted":
                break
        if verdict.cache_expires_at_s is None:
            verdict.cache_expires_at_s = now + 60.0
        self._launch_cache[job.uuid] = verdict
        if len(self._launch_cache) > 4096:
            self._launch_cache = {
                k: v for k, v in self._launch_cache.items()
                if v.cache_expires_at_s is None or v.cache_expires_at_s > now}
        return verdict.status == "accepted"

    def on_instance_completion(self, job: Job, instance: Instance) -> None:
        for h in self.completion_handlers:
            try:
                h.on_completion(job, instance)
            except Exception:  # pragma: no cover - plugin errors are isolated
                import logging
                logging.getLogger(__name__).exception(
                    "completion plugin failed")


class PoolMoverPlugin(JobSubmissionModifier):
    """Migrate a portion of configured users' jobs to a destination pool at
    submission time (reference: plugins/pool_mover.clj — gradual pool
    migration driven by per-user portions).

    ``moves`` maps source pool -> {"destination": pool, "users": {user:
    portion}}; a job moves when the fraction derived from its uuid hash is
    below the user's portion, so rollouts are deterministic per job and
    tunable per user (same portion mechanism as incremental config).
    """

    def __init__(self, moves: Optional[Dict[str, Dict[str, Any]]] = None):
        self.moves = moves or {}
        for src, rule in self.moves.items():
            if "destination" not in rule:
                raise ValueError(
                    f"pool-mover rule for {src!r} missing 'destination'")

    def modify(self, job: Job) -> Job:
        from .incremental import _uuid_to_unit_interval

        rule = self.moves.get(job.pool)
        if not rule:
            return job
        portion = rule.get("users", {}).get(job.user)
        if portion is None:
            return job
        if _uuid_to_unit_interval(job.uuid) < float(portion):
            job.pool = rule["destination"]
        return job
