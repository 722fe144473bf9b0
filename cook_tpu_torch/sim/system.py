"""The port's copy of ``cook_tpu/sim/system.py`` (imports re-rooted).

System simulator: generated workloads against a LIVE cook_tpu_torch daemon.

The analog of the reference's simulator subproject (reference:
simulator/src/main/cook/sim/{schedule,runner,reporting}.clj) — distinct
from ``cook_tpu_torch.sim.simulator``'s faster-than-real-time scheduler
simulation: this one exercises the FULL system (REST submission, real
scheduler cadence, backend execution) the way a fleet of users would.

    python -m cook_tpu_torch.sim.system generate -f sched.json \
        --users 4 --jobs-per-user 25 --duration-s 60 --seed 7
    python -m cook_tpu_torch.sim.system simulate -f sched.json \
        --url http://localhost:12321 --out results.json --time-scale 10
    python -m cook_tpu_torch.sim.system report -f results.json

Schedule shape (JSON; reference: sim/schedule.clj create-db-job):
    {"label": ..., "duration_seconds": S,
     "users": [{"username": u, "jobs": [
         {"at_ms": t, "name": n, "priority": p, "duration_ms": d,
          "cpus": c, "mem": m, "exit_code": e}]}]}

``simulate`` submits every job at its ``at_ms`` offset (divided by
--time-scale so an hour-long schedule can replay in minutes), waits for
completion, and records per-job submit/start/finish timestamps.
``report`` computes the reference's metrics: wait (first start -
submit), turnaround (finish - submit), overhead (turnaround - the job's
intended duration), per user and overall (reporting.clj:166-202), plus
preemption counts and never-scheduled warnings (:101-155).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np


def generate_schedule(users: int, jobs_per_user: int, duration_s: float,
                      seed: int, label: str,
                      mean_duration_ms: float = 2000.0) -> Dict:
    """Random schedule (reference: schedule.clj generate-job-schedule —
    arrival times uniform over the window, durations/resources drawn per
    job, a small failure rate via exit codes)."""
    rng = np.random.default_rng(seed)
    out_users = []
    for u in range(users):
        jobs = []
        arrivals = np.sort(rng.uniform(0, duration_s * 1000.0,
                                       jobs_per_user))
        for j, at in enumerate(arrivals):
            jobs.append({
                "at_ms": int(at),
                "name": f"sim-u{u}-j{j}",
                "priority": int(rng.integers(0, 100)),
                "duration_ms": int(rng.exponential(mean_duration_ms)) + 50,
                "cpus": float(rng.integers(1, 4)),
                "mem": float(rng.integers(64, 1024)),
                # ~5% of jobs fail (reference schedules exit codes)
                "exit_code": int(rng.random() < 0.05),
            })
        out_users.append({"username": f"sim{u:03d}", "jobs": jobs})
    return {"label": label, "duration_seconds": duration_s,
            "seed": seed, "users": out_users}


def run_simulation(schedule: Dict, url: str, time_scale: float = 1.0,
                   settle_timeout_s: float = 120.0,
                   fake_hints: bool = True) -> Dict:
    """Submit the schedule against a live daemon and record outcomes.

    Each user runs as its own thread of JobClient submissions at the
    scheduled (scaled) offsets — the reference's Simulant agents
    (runner.clj).  ``fake_hints`` attaches COOK_FAKE_* env so FakeCluster
    backends honor durations/exit codes; real agents run the sleep
    command itself."""
    from ..client import JobClient

    t0 = time.time()
    lock = threading.Lock()
    submitted: List[Dict] = []
    errors: List[str] = []

    def run_user(user: Dict) -> None:
        client = JobClient(url, user=user["username"])
        for job in user["jobs"]:
            target = t0 + (job["at_ms"] / 1000.0) / time_scale
            delay = target - time.time()
            if delay > 0:
                time.sleep(delay)
            dur_s = (job["duration_ms"] / 1000.0) / time_scale
            spec = {
                "command": f"sleep {dur_s:.3f}; exit {job['exit_code']}",
                "name": job["name"], "priority": job["priority"],
                "cpus": job["cpus"], "mem": job["mem"], "max_retries": 1,
            }
            if fake_hints:
                spec["env"] = {
                    "COOK_FAKE_DURATION_MS":
                        str(max(1, int(job["duration_ms"] / time_scale))),
                    "COOK_FAKE_EXIT_CODE": str(job["exit_code"]),
                }
            try:
                [uuid] = client.submit([spec])
                with lock:
                    submitted.append({
                        "uuid": uuid, "user": user["username"],
                        "name": job["name"],
                        "intended_duration_ms":
                            job["duration_ms"] / time_scale,
                        "submit_ms": int(time.time() * 1000)})
            except Exception as e:  # noqa: BLE001 - recorded, not fatal
                with lock:
                    errors.append(f"{user['username']}/{job['name']}: {e}")

    threads = [threading.Thread(target=run_user, args=(u,), daemon=True)
               for u in schedule["users"]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    # settle: wait for every submitted job to reach a terminal state.
    # Transient query failures (leader failover, brief 503) must not
    # discard a possibly hour-long replay — retry until the deadline.
    from ..client import TERMINAL_STATES
    client = JobClient(url, user="sim-reporter")
    deadline = time.time() + settle_timeout_s
    uuids = [s["uuid"] for s in submitted]
    jobs_by_uuid: Dict[str, Dict] = {}
    while time.time() < deadline:
        done = 0
        try:
            for i in range(0, len(uuids), 100):
                for j in client.query(uuids[i:i + 100], partial=True):
                    jobs_by_uuid[j["uuid"]] = j
                    if j["state"] in TERMINAL_STATES:
                        done += 1
        except Exception as e:  # noqa: BLE001 - transient; keep settling
            with lock:
                errors.append(f"settle query: {e}")
        if done == len(uuids):
            break
        time.sleep(0.5)

    results = []
    for s in submitted:
        job = jobs_by_uuid.get(s["uuid"], {})
        insts = job.get("instances", [])
        start = min((i.get("start_time") or 0 for i in insts
                     if i.get("start_time")), default=None)
        finish = max((i.get("end_time") or 0 for i in insts
                      if i.get("end_time")), default=None)
        results.append({
            **s,
            "state": job.get("state", "unknown"),
            "instance_count": len(insts),
            "preempted": sum(1 for i in insts if i.get("preempted")),
            # the DAEMON's clock for submit too: mixing the simulator
            # host's clock with server-side start/end timestamps would
            # skew wait/overhead by clock offset + POST round trip
            "submit_ms": job.get("submit_time") or s["submit_ms"],
            "start_ms": start, "finish_ms": finish,
        })
    return {"label": schedule.get("label", ""),
            "time_scale": time_scale,
            "wall_s": round(time.time() - t0, 1),
            "errors": errors, "jobs": results}


def _metric_block(values: List[float]) -> Dict:
    if not values:
        return {}
    a = np.asarray(values, dtype=np.float64)
    return {"mean_ms": round(float(a.mean()), 1),
            "p50_ms": round(float(np.percentile(a, 50)), 1),
            "p95_ms": round(float(np.percentile(a, 95)), 1),
            "max_ms": round(float(a.max()), 1),
            "count": int(len(a))}


def build_report(results: Dict) -> Dict:
    """Wait/turnaround/overhead per user + overall (reference:
    reporting.clj show-average-{wait,turnaround,overhead} + the
    unscheduled/unfinished warnings)."""
    jobs = results["jobs"]
    never_scheduled = [j for j in jobs if not j.get("start_ms")]
    unfinished = [j for j in jobs
                  if j.get("start_ms") and not j.get("finish_ms")]
    per_user: Dict[str, Dict[str, List[float]]] = {}
    overall: Dict[str, List[float]] = {"wait": [], "turnaround": [],
                                       "overhead": []}
    for j in jobs:
        if not (j.get("start_ms") and j.get("finish_ms")):
            continue
        wait = j["start_ms"] - j["submit_ms"]
        turnaround = j["finish_ms"] - j["submit_ms"]
        overhead = turnaround - j["intended_duration_ms"]
        bucket = per_user.setdefault(
            j["user"], {"wait": [], "turnaround": [], "overhead": []})
        for key, v in (("wait", wait), ("turnaround", turnaround),
                       ("overhead", overhead)):
            bucket[key].append(v)
            overall[key].append(v)
    return {
        "label": results.get("label", ""),
        "jobs_total": len(jobs),
        "finished": sum(1 for j in jobs
                        if j.get("start_ms") and j.get("finish_ms")),
        "failed": sum(1 for j in jobs if j.get("state") == "failed"),
        "preemptions": sum(j.get("preempted", 0) for j in jobs),
        "never_scheduled": [j["uuid"] for j in never_scheduled],
        "unfinished": [j["uuid"] for j in unfinished],
        "submit_errors": results.get("errors", []),
        "overall": {k: _metric_block(v) for k, v in overall.items()},
        "by_user": {u: {k: _metric_block(v) for k, v in m.items()}
                    for u, m in sorted(per_user.items())},
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="cook-sim-system", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a random job schedule")
    g.add_argument("-f", "--file", required=True)
    g.add_argument("--users", type=int, default=4)
    g.add_argument("--jobs-per-user", type=int, default=25)
    g.add_argument("--duration-s", type=float, default=60.0)
    g.add_argument("--mean-job-duration-ms", type=float, default=2000.0)
    g.add_argument("--seed", type=int, default=1)
    g.add_argument("--label", default="generated")

    s = sub.add_parser("simulate", help="run a schedule against a daemon")
    s.add_argument("-f", "--file", required=True)
    s.add_argument("--url", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--time-scale", type=float, default=1.0,
                   help="replay N× faster than the schedule's clock")
    s.add_argument("--settle-timeout-s", type=float, default=120.0)
    s.add_argument("--no-fake-hints", action="store_true",
                   help="omit COOK_FAKE_* env (real agent backends)")

    r = sub.add_parser("report", help="summarize simulation results")
    r.add_argument("-f", "--file", required=True)

    args = p.parse_args(argv)
    if args.cmd == "generate":
        schedule = generate_schedule(
            args.users, args.jobs_per_user, args.duration_s, args.seed,
            args.label, mean_duration_ms=args.mean_job_duration_ms)
        with open(args.file, "w", encoding="utf-8") as f:
            json.dump(schedule, f, indent=2)
        total = sum(len(u["jobs"]) for u in schedule["users"])
        print(f"wrote {args.file}: {len(schedule['users'])} users, "
              f"{total} jobs over {args.duration_s}s")
        return 0
    if args.cmd == "simulate":
        with open(args.file, encoding="utf-8") as f:
            schedule = json.load(f)
        results = run_simulation(
            schedule, args.url, time_scale=args.time_scale,
            settle_timeout_s=args.settle_timeout_s,
            fake_hints=not args.no_fake_hints)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {args.out}: {len(results['jobs'])} jobs in "
              f"{results['wall_s']}s wall ({len(results['errors'])} "
              "submit errors)")
        return 0
    with open(args.file, encoding="utf-8") as f:
        results = json.load(f)
    print(json.dumps(build_report(results), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
