"""The port's copy of ``cook_tpu/rest/task_stats.py`` (imports re-rooted).

Instance statistics for ``GET /stats/instances``.

Re-implements the reference's task-stats subsystem (reference:
scheduler/src/cook/task_stats.clj:22-122 and the endpoint validation in
rest/api.clj:3185-3232): tasks whose instance started inside a required
[start, end) window and carry a required status are aggregated into

  overall              count + {cpu,mem,run-time}-seconds histograms
  by-reason            the same, grouped by failure-reason name
  by-user-and-reason   the same, grouped by user then reason
  leaders              top-10 users by total cpu-seconds / mem-seconds

Histograms use the reference's Nearest Rank percentile method at
50/75/95/99/100 plus the group total.  Aggregation is vectorized with
numpy: one pass builds parallel value arrays, then group-bys are argsort
partitions rather than per-task dict updates.

Endpoint validation mirrors rest/api.clj:3194-3221: status must be one of
unknown/running/success/failed, the name filter admits only
``[A-Za-z0-9.-_*]`` (``*`` is a wildcard), end must be after start, and
the window may not exceed 31 days.  Times parse as epoch milliseconds or
ISO-8601 (util/parse-time accepts both).
"""

from __future__ import annotations

import datetime as _dt
import fnmatch
import re
from typing import Callable, Dict, List, Optional

import numpy as np

from ..state.schema import InstanceStatus, Reasons

ALLOWED_STATUSES = ("unknown", "running", "success", "failed")
MAX_WINDOW_DAYS = 31
_PERCENTILES = (50, 75, 95, 99, 100)
_NAME_FILTER_RE = re.compile(r"^[A-Za-z0-9.\-_*]*$")


class StatsParamError(ValueError):
    """Raised for a malformed parameter; the REST layer maps it to 400."""


def parse_time_ms(value: str, param: str) -> int:
    """Epoch milliseconds or ISO-8601 (reference: util/parse-time)."""
    value = (value or "").strip()
    if re.fullmatch(r"\d{12,}", value):
        return int(value)
    try:
        dt = _dt.datetime.fromisoformat(value.replace("Z", "+00:00"))
    except ValueError:
        raise StatsParamError(f"unsupported {param} time {value!r}, must be "
                              "epoch milliseconds or ISO-8601")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1000)


def validate_params(params: Dict) -> Dict:
    """Validates raw query params into {status, start_ms, end_ms, name_fn}.

    Mirrors the malformed? checks of rest/api.clj:3194-3221; raises
    StatsParamError with a reference-shaped message on the first failure.
    """
    def first(key: str) -> Optional[str]:
        v = params.get(key)
        return v[0] if isinstance(v, list) else v

    status = first("status")
    if status not in ALLOWED_STATUSES:
        raise StatsParamError(
            f"unsupported status {status}, must be one of: "
            + ", ".join(ALLOWED_STATUSES))
    name = first("name")
    if name is not None and not _NAME_FILTER_RE.fullmatch(name):
        raise StatsParamError(
            f"unsupported name filter {name}, can only contain alphanumeric "
            "characters, '.', '-', '_', and '*' as a wildcard")
    start_raw, end_raw = first("start"), first("end")
    if not start_raw or not end_raw:
        raise StatsParamError("start and end parameters are required")
    start_ms = parse_time_ms(start_raw, "start")
    end_ms = parse_time_ms(end_raw, "end")
    if end_ms <= start_ms:
        raise StatsParamError("end time must be after start time")
    if end_ms - start_ms > MAX_WINDOW_DAYS * 86_400_000:
        raise StatsParamError(
            "time interval must be less than or equal to 31 days")
    name_fn: Optional[Callable[[str], bool]] = None
    if name is not None:
        pattern = name
        name_fn = lambda n: fnmatch.fnmatchcase(n or "", pattern)  # noqa: E731
    return {"status": status, "start_ms": start_ms, "end_ms": end_ms,
            "name_fn": name_fn}


def _histogram(values: np.ndarray) -> Dict:
    """Nearest-Rank percentiles + total (task_stats.clj:59-91)."""
    order = np.sort(values)
    n = len(order)
    ranks = [min(n - 1, max(0, int(np.ceil(p / 100.0 * n)) - 1))
             for p in _PERCENTILES]
    return {"percentiles": {p: float(order[r])
                            for p, r in zip(_PERCENTILES, ranks)},
            "total": float(values.sum())}


def _group_stats(cpu_s: np.ndarray, mem_s: np.ndarray,
                 run_s: np.ndarray) -> Dict:
    if len(run_s) == 0:
        return {}
    return {"count": int(len(run_s)),
            "cpu-seconds": _histogram(cpu_s),
            "mem-seconds": _histogram(mem_s),
            "run-time-seconds": _histogram(run_s)}


def _stats_by(keys: List[str], cpu_s, mem_s, run_s) -> Dict[str, Dict]:
    out: Dict[str, Dict] = {}
    arr = np.asarray(keys, dtype=object)
    for k in sorted(set(keys)):
        sel = arr == k
        out[k] = _group_stats(cpu_s[sel], mem_s[sel], run_s[sel])
    return out


def get_stats(store, status: str, start_ms: int, end_ms: int,
              name_fn: Optional[Callable[[str], bool]],
              now_ms: int) -> Dict:
    """The TaskStatsResponse body (task_stats.clj:94-122)."""
    from ..state.partition import substores
    want = InstanceStatus(status)
    users: List[str] = []
    reasons: List[str] = []
    cpu, mem, run = [], [], []
    matched = []
    # per-shard locks in turn, never nested (utils/locks.py sibling rule)
    for shard in substores(store):
        with shard._lock:
            matched.extend(
                inst for inst in shard._instances.values()
                if inst.status is want and inst.start_time_ms
                and start_ms <= inst.start_time_ms < end_ms)
    # one batched read, one clone per JOB (not per attempt) — per-call
    # store.job() would re-lock and re-clone for every instance
    uuids = list({inst.job_uuid for inst in matched})
    jobs = {u: j for u, j in zip(uuids, store.jobs_bulk(uuids))
            if j is not None}
    for inst in matched:
        st = inst.start_time_ms
        job = jobs.get(inst.job_uuid)
        if job is None:
            continue
        if name_fn is not None and not name_fn(job.name):
            continue
        run_s = max(0, (inst.end_time_ms or now_ms) - st) / 1000.0
        users.append(job.user)
        reasons.append("" if inst.reason_code is None
                       else Reasons.by_code(inst.reason_code).name)
        run.append(run_s)
        cpu.append(run_s * job.resources.cpus)
        mem.append(run_s * job.resources.mem)
    cpu_a, mem_a, run_a = (np.asarray(cpu), np.asarray(mem),
                           np.asarray(run))
    user_a = np.asarray(users, dtype=object)
    by_user_and_reason: Dict[str, Dict] = {}
    leaders_cpu: Dict[str, float] = {}
    leaders_mem: Dict[str, float] = {}
    for u in sorted(set(users)):
        sel = user_a == u
        by_user_and_reason[u] = _stats_by(
            [r for r, s in zip(reasons, sel) if s],
            cpu_a[sel], mem_a[sel], run_a[sel])
        leaders_cpu[u] = float(cpu_a[sel].sum())
        leaders_mem[u] = float(mem_a[sel].sum())

    def top10(totals: Dict[str, float]) -> Dict[str, float]:
        return dict(sorted(totals.items(), key=lambda kv: -kv[1])[:10])

    return {"overall": _group_stats(cpu_a, mem_a, run_a),
            "by-reason": _stats_by(reasons, cpu_a, mem_a, run_a),
            "by-user-and-reason": by_user_and_reason,
            "leaders": {"cpu-seconds": top10(leaders_cpu),
                        "mem-seconds": top10(leaders_mem)}}
