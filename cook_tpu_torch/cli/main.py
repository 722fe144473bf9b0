"""The port's copy of ``cook_tpu/cli/main.py``: ``cs`` over the port's
``JobClient`` (``python -m cook_tpu_torch.cli.main``).  ``cs lint`` exits 2:
the static analysis passes are still to be ported.

``cs`` command-line interface.

Parity with the reference's CLI subcommands (reference: cli/cook/subcommands/
— submit, show, wait, jobs, kill, usage, cat, tail, ls, ssh, plus admin
queue/limits).  Sandbox access (cat/tail/ls) goes through the instance's
``output_url`` file server, the analog of the Mesos agent / sidecar files
API (reference: cli/cook/mesos.py; sidecar file_server.py).  Cluster
selection via --url or the COOK_URL environment variable / ~/.cs.json
config federation list (reference: cli/cook/querying.py multi-cluster
federation, deduped by uuid).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..client import JobClient, JobClientError

CONFIG_PATH = Path.home() / ".cs.json"


def load_cs_config() -> Optional[Dict]:
    """Parsed ~/.cs.json; {} when absent, None when present but CORRUPT
    (callers that WRITE must refuse on None — falling back to {} and
    rewriting would destroy the user's whole config)."""
    if not CONFIG_PATH.exists():
        return {}
    try:
        return json.loads(CONFIG_PATH.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def load_urls(args) -> List[str]:
    # clusters named by entity refs on this invocation come first
    refs = list(getattr(args, "ref_urls", []) or [])
    if args.url:
        return refs + [args.url]
    env = os.environ.get("COOK_URL")
    if env:
        return refs + env.split(",")
    cfg = load_cs_config()
    if cfg is None:
        # a corrupt config must not silently reroute work to localhost
        raise OSError(f"{CONFIG_PATH} exists but is not valid JSON; "
                      "fix or remove it (or pass --url)")
    if cfg:
        return refs + [c["url"] for c in cfg.get("clusters", [])]
    return refs or ["http://127.0.0.1:12321"]


def clients(args) -> List[JobClient]:
    user = args.user or os.environ.get("COOK_USER") \
        or os.environ.get("USER", "anonymous")
    return [JobClient(url, user=user) for url in load_urls(args)]


def resolve_refs(args, tokens: List[str],
                 allow_stdin: bool = True) -> Optional[List[str]]:
    """Entity refs -> uuids (reference: cli/cook/querying.py
    parse_entity_refs + the test_entity_refs_* integration scenarios).

    Accepts bare uuids, ``https://cluster/jobs/<uuid>`` refs (case-
    insensitive, optional trailing slash on the cluster part), and
    ``...?job=<uuid>`` query-string refs; a ref's cluster URL is added to
    this invocation's federation list.  With no tokens, refs are read
    from stdin (one per whitespace-separated word) so ``cs jobs | cs
    kill`` pipes compose.  Duplicate uuids are an error (the reference
    refuses them for show/wait/kill alike) -> None."""
    if not tokens and allow_stdin and not sys.stdin.isatty():
        tokens = sys.stdin.read().split()
    uuids: List[str] = []
    extra_urls: List[str] = []
    for tok in tokens:
        tok = tok.strip()
        if not tok:
            continue
        if tok.lower().startswith(("http://", "https://")):
            parsed = urllib.parse.urlparse(tok)
            qs = urllib.parse.parse_qs(parsed.query)
            if qs.get("job"):
                uuid = qs["job"][0]
            else:
                parts = [p for p in parsed.path.split("/") if p]
                uuid = parts[-1] if parts else ""
                if uuid in ("jobs", "rawscheduler", "instances", "group"):
                    uuid = ""  # a bare endpoint path carries no uuid
            if not uuid:
                print(f"error: malformed entity ref {tok}", file=sys.stderr)
                return None
            extra_urls.append(f"{parsed.scheme}://{parsed.netloc}")
            uuids.append(uuid.lower())
        else:
            uuids.append(tok.lower())
    if len(set(uuids)) != len(uuids):
        dupes = sorted({u for u in uuids if uuids.count(u) > 1})
        print(f"error: duplicate uuids {', '.join(dupes)}", file=sys.stderr)
        return None
    if not uuids:
        print("error: at least one uuid or entity ref is required",
              file=sys.stderr)
        return None
    if extra_urls:
        args.ref_urls = list(dict.fromkeys(extra_urls))
    return uuids


def federated_owners(args, uuids: List[str]
                     ) -> Tuple[List[Tuple[JobClient, List[str]]],
                                List[str]]:
    """Partition uuids by the federation cluster that owns them
    (reference: querying.py routes each entity to its cluster before
    acting on it).  Returns ([(client, owned_uuids)...], missing).

    A cluster that cannot be queried is reported on stderr when any uuid
    ends up unclaimed: an OUTAGE of the owning cluster must be
    distinguishable from a uuid no cluster has ever seen (the caller's
    "no cluster knows" message alone would misreport the former)."""
    unclaimed = list(uuids)
    owned: List[Tuple[JobClient, List[str]]] = []
    errors = []
    for client in clients(args):
        if not unclaimed:
            break
        try:
            found = {j["uuid"] for j in client.query(unclaimed,
                                                     partial=True)}
        except (JobClientError, OSError) as e:
            errors.append(f"{client.url}: {e}")
            continue
        mine = [u for u in unclaimed if u in found]
        if mine:
            owned.append((client, mine))
            unclaimed = [u for u in unclaimed if u not in found]
    if unclaimed and errors:
        print("warning: some clusters could not be queried (the uuids "
              "reported missing may live there):", file=sys.stderr)
        print("\n".join(errors), file=sys.stderr)
    return owned, unclaimed


def federated_query(args, uuids: List[str]) -> List[Dict]:
    """Query every configured cluster, dedupe by uuid (reference:
    cli/cook/querying.py)."""
    seen: Dict[str, Dict] = {}
    errors = []
    for client in clients(args):
        try:
            # partial: a cluster that owns only SOME of the uuids must
            # return that subset, not 404 the whole query
            for job in client.query(uuids, partial=True):
                seen.setdefault(job["uuid"], job)
        except (JobClientError, OSError) as e:
            errors.append(f"{client.url}: {e}")
    missing = [u for u in uuids if u not in seen]
    if missing and errors:
        print("\n".join(errors), file=sys.stderr)
    return [seen[u] for u in uuids if u in seen]


def out(payload) -> None:
    print(json.dumps(payload, indent=2, default=str))


def cmd_submit(args) -> int:
    """Submit job(s) (reference: cli/cook/subcommands/submit.py): the
    command comes from argv, or — when absent — from stdin, one job per
    non-empty line; ``--raw`` instead reads full JSON spec(s) (an object,
    a list, or a ``{"jobs": [...], "groups": [...]}`` body) from stdin
    and refuses argv commands."""
    groups = None
    if args.raw:
        if args.command:
            print("error: --raw reads specs from stdin; it cannot be "
                  "combined with a command argument", file=sys.stderr)
            return 1
        if (args.gang_size is not None or args.gang_topology
                or args.gang_policy or args.gang_min is not None
                or args.gang_max is not None):
            print("error: gang flags do not apply to --raw specs; "
                  'submit a full body {"jobs": [...], "groups": [{..., '
                  '"gang": {...}}]} instead', file=sys.stderr)
            return 1
        if args.command_prefix is not None:
            print("error: --command-prefix does not apply to --raw "
                  "specs", file=sys.stderr)
            return 1
        if sys.stdin.isatty():
            print("error: --raw expects JSON spec(s) on stdin",
                  file=sys.stderr)
            return 1
        try:
            raw = json.loads(sys.stdin.read())
        except json.JSONDecodeError as e:
            print(f"error: malformed --raw JSON: {e}", file=sys.stderr)
            return 1
        if isinstance(raw, dict) and "jobs" in raw:
            # full submit body {"jobs": [...], "groups": [...]} — the
            # raw form that can express group/gang membership
            specs = raw["jobs"]
            groups = raw.get("groups")
            if not isinstance(specs, list):
                print('error: --raw "jobs" must be a list of job '
                      "specs", file=sys.stderr)
                return 1
        else:
            specs = raw if isinstance(raw, list) else [raw]
    else:
        if args.command:
            commands = [" ".join(args.command)]
        elif sys.stdin.isatty():
            commands = []  # interactive with no command: error, not a hang
        else:
            commands = [line.strip() for line in sys.stdin.read().splitlines()
                        if line.strip()]
        if not commands:
            print("error: no command given (argv or stdin)",
                  file=sys.stderr)
            return 1
        # --command-prefix flag, falling back to the config file's
        # defaults.submit.command-prefix (reference: subcommands/submit.py
        # job-template command-prefix + test_submit_with_command_prefix)
        prefix = args.command_prefix
        if prefix is None:
            cfg = load_cs_config()
            if cfg is None:
                # a corrupt config must not silently drop the user's
                # configured command-prefix
                print(f"error: {CONFIG_PATH} exists but is not valid "
                      "JSON; fix or remove it (or pass "
                      "--command-prefix)", file=sys.stderr)
                return 1
            prefix = (cfg.get("defaults", {}).get("submit", {})
                      .get("command-prefix", ""))
        if prefix and not isinstance(prefix, str):
            print("error: defaults.submit.command-prefix must be a "
                  f"string, got {prefix!r}", file=sys.stderr)
            return 1
        if prefix:
            commands = [prefix + c for c in commands]
        base: Dict = {}
        for field in ("name", "pool"):
            value = getattr(args, field)
            if value:
                base[field] = value
        for field in ("cpus", "mem", "gpus", "priority", "max_retries",
                      "ports"):
            value = getattr(args, field)
            if value is not None:
                base[field] = value
        if args.env:
            base["env"] = dict(kv.split("=", 1) for kv in args.env)
        if args.label:
            base["labels"] = dict(kv.split("=", 1) for kv in args.label)
        if args.constraint:
            base["constraints"] = [c.split(":", 2) for c in args.constraint]
        if args.docker_image:
            base["container"] = {"image": args.docker_image,
                                 "volumes": list(args.volume or [])}
        if args.uri:
            base["uris"] = [{"value": u} for u in args.uri]
        if args.executor:
            base["executor"] = args.executor
        if args.application:
            name, _, version = args.application.partition(":")
            base["application"] = {"name": name, "version": version or "0"}
        specs = [{**base, "command": c} for c in commands]
        if args.gang_size is not None:
            # ONE command fans out into gang_size member jobs sharing a
            # gang group (all-or-nothing placement, docs/GANG.md)
            if args.gang_size < 1:
                print("error: --gang-size must be >= 1", file=sys.stderr)
                return 1
            if len(specs) != 1:
                print("error: --gang-size submits ONE command as N "
                      "member jobs; got multiple commands",
                      file=sys.stderr)
                return 1
            import uuid as uuidlib
            guuid = str(uuidlib.uuid4())
            specs = [{**specs[0], "group": guuid}
                     for _ in range(args.gang_size)]
            gang: Dict = {"size": args.gang_size}
            if args.gang_topology:
                gang["topology"] = args.gang_topology
            if args.gang_policy:
                gang["policy"] = args.gang_policy
            # elastic bounds (docs/GANG.md elasticity): the server
            # validates 1 <= min <= max <= size; pre-check the obvious
            # inversions here for a clearer error than a 400
            if args.gang_min is not None:
                if args.gang_min < 1 or args.gang_min > args.gang_size:
                    print("error: --gang-min must be in "
                          "[1, --gang-size]", file=sys.stderr)
                    return 1
                gang["min"] = args.gang_min
            if args.gang_max is not None:
                if args.gang_max > args.gang_size \
                        or args.gang_max < (args.gang_min or 1):
                    print("error: --gang-max must be in "
                          "[--gang-min, --gang-size]", file=sys.stderr)
                    return 1
                gang["max"] = args.gang_max
            groups = [{"uuid": guuid, "gang": gang}]
        elif args.gang_topology or args.gang_policy \
                or args.gang_min is not None or args.gang_max is not None:
            print("error: --gang-topology/--gang-policy/--gang-min/"
                  "--gang-max require --gang-size", file=sys.stderr)
            return 1
    client = clients(args)[0]
    uuids = client.submit(specs, groups=groups)
    for u in uuids:
        print(u)
    return 0


def cmd_show(args) -> int:
    uuids = resolve_refs(args, args.uuid)
    if uuids is None:
        return 1
    jobs = federated_query(args, uuids)
    if not jobs:
        print("no matching jobs", file=sys.stderr)
        return 1
    out(jobs)
    return 0


def cmd_jobs(args) -> int:
    client = clients(args)[0]
    states = args.state.split("+") if args.state else None
    jobs = client.jobs(user=args.for_user or client.user, states=states)
    if args.one_per_line:
        # uuid-per-line output feeds `cs show/wait/kill` pipes (reference:
        # subcommands/jobs.py --one-per-line + the piping scenarios)
        for j in jobs:
            print(j["uuid"])
    else:
        out(jobs)
    return 0


def cmd_wait(args) -> int:
    uuids = resolve_refs(args, args.uuid)
    if uuids is None:
        return 1
    owned, missing = federated_owners(args, uuids)
    if missing:
        print(f"error: no cluster knows {', '.join(missing)}",
              file=sys.stderr)
        return 1
    jobs: List[Dict] = []
    deadline = time.monotonic() + args.timeout
    for client, mine in owned:
        # one SHARED deadline across clusters — N owners must not
        # multiply the user's --timeout by N
        try:
            jobs.extend(client.wait(
                mine, timeout_s=max(0.0, deadline - time.monotonic())))
        except TimeoutError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    out(jobs)
    failed = [j for j in jobs
              if not any(i["status"] == "success"
                         for i in j.get("instances", []))]
    return 1 if failed else 0


def cmd_kill(args) -> int:
    uuids = resolve_refs(args, args.uuid)
    if uuids is None:
        return 1
    owned, missing = federated_owners(args, uuids)
    if missing:
        print(f"error: no cluster knows {', '.join(missing)}",
              file=sys.stderr)
        return 1
    # always a list, one entry per owning cluster — a stable shape no
    # matter how the uuids were distributed
    out([client.kill(mine) for client, mine in owned])
    return 0


def cmd_retry(args) -> int:
    """Raise retries on jobs and/or groups (reference: subcommands/
    retry.py over PUT /retry — multiple uuids, groups, retries or
    increment, failed-only)."""
    if (args.retries is None) == (args.increment is None):
        print("error: specify exactly one of --retries or --increment",
              file=sys.stderr)
        return 1
    uuids: List[str] = []
    if args.uuid:
        # entity refs, exactly like show/wait/kill
        resolved = resolve_refs(args, args.uuid, allow_stdin=False)
        if resolved is None:
            return 1
        uuids = resolved
    elif not args.group:
        # no positional refs and no groups: read uuids from a pipe
        # (`cs jobs -1 | cs retry --retries 3`)
        resolved = resolve_refs(args, [])
        if resolved is None:
            return 1
        uuids = resolved
    results = []
    if uuids:
        # route each uuid to its OWNING cluster (same federation
        # semantics as kill/wait)
        owned, missing = federated_owners(args, uuids)
        if missing:
            print(f"error: no cluster knows {', '.join(missing)}",
                  file=sys.stderr)
            return 1
        for client, mine in owned:
            results.append(client.retry(
                jobs=mine, retries=args.retries,
                increment=args.increment, failed_only=args.failed_only))
    for guuid in args.group or []:
        # group ownership isn't resolvable through the jobs query; try
        # each federation cluster, keeping the first that knows it
        last_err: Optional[Exception] = None
        for client in clients(args):
            try:
                results.append(client.retry(
                    groups=[guuid], retries=args.retries,
                    increment=args.increment,
                    failed_only=args.failed_only))
                break
            except (JobClientError, OSError) as e:
                last_err = e
        else:
            print(f"error: group {guuid}: {last_err}", file=sys.stderr)
            return 1
    out(results if len(results) != 1 else results[0])
    return 0


def cmd_usage(args) -> int:
    client = clients(args)[0]
    out(client.usage(args.for_user or client.user, pool=args.pool,
                     group_breakdown=args.group_breakdown))
    return 0


def cmd_unscheduled(args) -> int:
    uuids = resolve_refs(args, args.uuid)
    if uuids is None:
        return 1
    owned, missing = federated_owners(args, uuids)
    if missing:
        print(f"error: no cluster knows {', '.join(missing)}",
              file=sys.stderr)
        return 1
    merged: List[Dict] = []
    for client, mine in owned:
        merged.extend(client.unscheduled_jobs(mine))
    out(merged)
    return 0


def cmd_pools(args) -> int:
    out(clients(args)[0].pools())
    return 0


def cmd_admin(args) -> int:
    client = clients(args)[0]
    if args.admin_cmd == "queue":
        out(client.queue())
    elif args.admin_cmd == "share":
        if args.set:
            pools = {args.pool or "default":
                     dict((kv.split("=")[0], float(kv.split("=")[1]))
                          for kv in args.set)}
            out(client.set_share(args.for_user, pools))
        else:
            out(client.get_share(args.for_user or client.user))
    elif args.admin_cmd == "quota":
        if args.set:
            pools = {args.pool or "default":
                     dict((kv.split("=")[0], float(kv.split("=")[1]))
                          for kv in args.set)}
            out(client.set_quota(args.for_user, pools))
        else:
            out(client.get_quota(args.for_user or client.user))
    elif args.admin_cmd == "usage":
        # all-users report by default (admin-only server side);
        # --for-user scopes it like the other admin subcommands
        out(client.usage(args.for_user, pool=args.pool))
    elif args.admin_cmd == "stats":
        if any(v is not None for v in (args.status, args.start, args.end,
                                       args.name)):
            # forward everything given: the server's validation explains
            # what's missing rather than silently serving the wrong report
            out(client.stats(status=args.status, start=args.start,
                             end=args.end, name=args.name))
        else:
            out(client.stats())
    elif args.admin_cmd == "rebalancer":
        if args.set:
            body = {}
            for kv in args.set:
                k, eq, v = kv.partition("=")
                if not eq or not k:
                    raise JobClientError(
                        400, f"malformed --set {kv!r} (expected key=value)")
                if v.lower() in ("true", "false"):
                    body[k] = v.lower() == "true"
                else:
                    try:
                        # integral stays int so the server validates
                        # instead of silently truncating (max-preemption)
                        body[k] = int(v) if v.lstrip("-").isdigit() \
                            else float(v)
                    except ValueError:
                        raise JobClientError(
                            400, f"malformed --set value {kv!r}")
            out(client.set_rebalancer(body))
        else:
            out(client.settings().get("rebalancer", {}))
    return 0


def _fmt_ts(ms) -> str:
    import datetime
    try:
        return datetime.datetime.fromtimestamp(
            ms / 1000.0).strftime("%H:%M:%S")
    except (OverflowError, OSError, ValueError):
        return str(ms)


def cmd_why(args) -> int:
    """``cs why <uuid>`` — the whole lifecycle, human-readable: every
    audit event (submit, rank position + DRU, skip/defer reasons, launch
    intent/ack, instance transitions, preemption with the DRU delta,
    terminal), then — for a still-waiting job — the unscheduled
    explainer's live reasons.  The trail survives leader failover
    (journal-backed lane, docs/OBSERVABILITY.md), so this works for jobs
    scheduled by a previous leader too.  ``--json`` emits the raw
    timeline document; ``--perfetto FILE`` writes the newest cycle's
    trace with this job's events stitched in as a dedicated track."""
    uuids = resolve_refs(args, args.uuid)
    if uuids is None:
        return 1
    client = clients(args)[0]
    rc = 0
    shown = []
    for uuid in uuids:
        try:
            doc = client.job_timeline(uuid)
        except JobClientError as e:
            print(f"error: {uuid}: {e}", file=sys.stderr)
            rc = 1
            continue
        shown.append((uuid, doc.get("timeline", [])))
        if args.json:
            out(doc)
            continue
        head = f"job {uuid}"
        if doc.get("user"):
            head += f" (user={doc['user']}, pool={doc.get('pool')})"
        if doc.get("state"):
            head += f" — {doc['state']}"
        if doc.get("user_dru") is not None:
            head += f" [user DRU {doc['user_dru']:.3f}]"
        print(head)
        for ev in doc.get("timeline", []):
            data = dict(ev.get("data") or {})
            reason = data.pop("reason", None)
            label = ev["kind"] + (f":{reason}" if reason else "")
            extras = " ".join(f"{k}={v}" for k, v in data.items()
                              if v is not None and k != "pool")
            times = _fmt_ts(ev["ts"])
            if ev.get("count", 1) > 1:
                times += (f" (x{ev['count']}, last "
                          f"{_fmt_ts(ev.get('ts_last', ev['ts']))})")
            print(f"  {times}  {label}" + (f"  {extras}" if extras
                                           else ""))
        for r in doc.get("reasons", []):
            print(f"  why waiting: {r['reason']}")
    if args.perfetto and shown:
        # Prefer the server's stitched per-job export for the FIRST job:
        # the cycle that launched it, the submission request's span
        # track (http.request -> journal -> replication ack wait), and
        # its audit lane in one timeline (docs/OBSERVABILITY.md
        # "tracing one request").  Remaining jobs ride along as extra
        # tracks (ONE export — a per-uuid write would silently keep
        # only the last job).
        from ..utils.tracing import job_track_events
        trace = None
        extra = shown[1:]
        try:
            trace = client.debug_trace(job=shown[0][0])
        except (JobClientError, OSError):
            pass
        if trace is None:
            # no trace recorded for the job (old server / trace ring
            # rolled over): fall back to the newest cycle's flamegraph
            # with every job's audit track appended client-side
            cycles = client.debug_cycles(limit=1).get("cycles", [])
            if cycles and cycles[-1].get("trace_id"):
                trace = client.debug_trace(cycles[-1]["trace_id"])
                extra = shown
        if trace is not None:
            for i, (uuid, timeline) in enumerate(extra):
                trace["traceEvents"].extend(
                    job_track_events(uuid, timeline, tid=16 + i))
            with open(args.perfetto, "w") as f:
                json.dump(trace, f)
            print(f"wrote perfetto trace with {len(shown)} job "
                  f"track(s) to {args.perfetto}", file=sys.stderr)
        else:
            print("no cycle trace available for --perfetto",
                  file=sys.stderr)
    return rc


def cmd_debug(args) -> int:
    """Flight-recorder access: ``cs debug cycles`` lists recent per-cycle
    records; ``cs debug trace [TRACE_ID]`` exports one cycle's spans as
    Chrome trace-event JSON (default: the newest recorded cycle) for
    chrome://tracing / ui.perfetto.dev; ``cs debug faults`` dumps the
    degradation panel — armed fault points, per-cluster circuit-breaker
    states, and open launch intents (docs/ROBUSTNESS.md); ``cs debug
    replication`` dumps the failover panel — per-follower offsets,
    min_acked, synced set, the candidate positions published into
    the election medium, plus the node's SERVING role: a standby's
    read-fleet block (reads served, local apply offset vs mirrored
    head, staleness bytes/age) and a leader's group-commit batching
    counters (docs/DEPLOY.md read fleet).  On a PARTITIONED write
    plane the panel carries a ``partitions`` block — per-partition
    journal head, lease epoch, group-commit stage, declared pool
    groups — plus the cross-partition ``summary_exchange`` state
    (docs/DEPLOY.md partitioned write plane); ``cs debug health`` is the one-shot roll-up
    (SLO burn rates, breakers, replication lag, pipeline depth, repack
    counters, audit queue depth) replacing five /debug/* fetches;
    ``cs debug requests`` lists the serving plane's recent + slow
    captured requests with per-phase breakdowns
    (docs/OBSERVABILITY.md); ``cs debug optimizer`` dumps the goodput
    loop's decision panel — last per-pool decisions (grow budget,
    shrink pressure, preemption budget, autoscale target), cycle
    counts/errors, and the elastic resize plane's live state
    (docs/GANG.md elasticity); ``cs debug fleet`` dumps the federated
    fleet panel — every known member's health, role, last-scrape age,
    staleness, SLO burn, and saturation hot-spots, with unreachable
    members surfaced as rows (up=false), not gaps
    (docs/OBSERVABILITY.md debugging the fleet); ``cs debug storage``
    dumps the persistence-integrity panel — per-partition scrub
    progress, last verified offset, corruption/repair counters,
    checkpoint manifest status, and a follower's mirror poison state
    (docs/DEPLOY.md corrupted-journal runbook)."""
    client = clients(args)[0]
    if args.debug_cmd == "cycles":
        out(client.debug_cycles(limit=args.limit))
        return 0
    if args.debug_cmd == "faults":
        out(client.debug_faults())
        return 0
    if args.debug_cmd == "replication":
        out(client.debug_replication())
        return 0
    if args.debug_cmd == "health":
        out(client.debug_health())
        return 0
    if args.debug_cmd == "requests":
        out(client.debug_requests(limit=args.limit))
        return 0
    if args.debug_cmd == "optimizer":
        out(client.debug_optimizer())
        return 0
    if args.debug_cmd == "fleet":
        out(client.debug_fleet())
        return 0
    if args.debug_cmd == "storage":
        out(client.debug_storage())
        return 0
    trace_id = args.trace_id
    if not trace_id:
        cycles = client.debug_cycles(limit=1).get("cycles", [])
        if not cycles or not cycles[-1].get("trace_id"):
            print("error: no cycle records yet (is the scheduler "
                  "cycling?); pass an explicit TRACE_ID", file=sys.stderr)
            return 1
        trace_id = cycles[-1]["trace_id"]
    trace = client.debug_trace(trace_id)
    if args.out_file:
        with open(args.out_file, "w") as f:
            json.dump(trace, f)
        print(f"wrote {len(trace.get('traceEvents', []))} events to "
              f"{args.out_file} (open in chrome://tracing or "
              "https://ui.perfetto.dev)", file=sys.stderr)
    else:
        out(trace)
    return 0


def _resolve_instance(args, uuid: str) -> Tuple[Dict, Dict]:
    """uuid (job or instance) -> (job, instance) for sandbox access
    (reference: cli/cook/querying.py query_unique_and_run)."""
    jobs = federated_query(args, [uuid])
    if jobs:
        job = jobs[0]
        insts = job.get("instances", [])
        if not insts:
            raise JobClientError(404, f"job {uuid} has no instances")
        # prefer the running/latest attempt, as the reference does
        insts = sorted(insts, key=lambda i: (i["status"] == "running",
                                             i.get("start_time") or 0))
        return job, insts[-1]
    for client in clients(args):
        try:
            inst = client.instance(uuid)
            job = client.query([inst["job_uuid"]])[0]
            return job, inst
        except (JobClientError, OSError):
            continue
    raise JobClientError(404, f"no job or instance {uuid}")


def _files_get(inst: Dict, endpoint: str, params: Dict) -> bytes:
    base = inst.get("output_url")
    if not base:
        raise JobClientError(
            503, f"instance {inst['task_id']} has no sandbox file server "
                 "(output_url) yet")
    url = (base.rstrip("/") + "/files/" + endpoint + "?"
           + urllib.parse.urlencode(params))
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read()


def cmd_cat(args) -> int:
    """Stream a sandbox file to stdout (reference: subcommands/cat.py)."""
    _job, inst = _resolve_instance(args, args.uuid[0])
    data = _files_get(inst, "download", {"path": args.path})
    sys.stdout.buffer.write(data)
    sys.stdout.buffer.flush()
    return 0


def cmd_tail(args) -> int:
    """Print the last N lines of a sandbox file (reference:
    subcommands/tail.py; reads backwards via the offset/length API)."""
    if args.lines <= 0:
        return 0
    _job, inst = _resolve_instance(args, args.uuid[0])
    from ..agent.file_server import MAX_READ_LENGTH
    probe = json.loads(_files_get(inst, "read", {"path": args.path}))
    size = probe.get("offset", 0)
    # clamp to the server's per-read cap: a larger request would be
    # silently shortened and leave holes between stitched chunks
    want = min(args.bytes if args.bytes else 64 * 1024, MAX_READ_LENGTH)
    chunk: bytes = b""
    offset = size
    while offset > 0 and chunk.count(b"\n") <= args.lines \
            and len(chunk) < 16 * want:
        step = min(want, offset)
        offset -= step
        got = json.loads(_files_get(inst, "read", {
            "path": args.path, "offset": offset, "length": step}))
        chunk = got["data"].encode("utf-8", "surrogateescape") + chunk
    lines = chunk.splitlines(keepends=True)[-args.lines:]
    sys.stdout.buffer.write(b"".join(lines))
    sys.stdout.buffer.flush()
    return 0


def cmd_ls(args) -> int:
    """List sandbox directory contents (reference: subcommands/ls.py)."""
    _job, inst = _resolve_instance(args, args.uuid[0])
    entries = json.loads(_files_get(inst, "browse",
                                    {"path": args.path or ""}))
    if args.json:
        out(entries)
        return 0
    for e in entries:
        print(f"{e.get('mode', '??????????')} {e.get('nlink', 1):>3} "
              f"{e.get('size', 0):>12} {e.get('path', '')}")
    return 0


def cmd_ssh(args) -> int:
    """exec ssh to the instance's host, landing in the sandbox directory
    (reference: subcommands/ssh.py execs ssh <host> -t cd <sandbox>)."""
    _job, inst = _resolve_instance(args, args.uuid[0])
    hostname = inst.get("hostname")
    if not hostname:
        print(f"instance {inst['task_id']} has no hostname", file=sys.stderr)
        return 1
    sandbox = inst.get("sandbox_directory") or "~"
    command = ["ssh", "-t", hostname, f"cd {sandbox} ; exec $SHELL -l"]
    if args.dry_run:
        print(" ".join(command))
        return 0
    os.execvp("ssh", command)  # pragma: no cover - replaces the process


def cmd_lint(args) -> int:
    """``cs lint``: the static analysis passes (the JAX package's
    ``lint`` and ``analysis/``) are still to be ported, so this exits 2
    with a line naming the ROADMAP.md item, before any work."""
    print("error: cs lint is not ported: the static analysis passes "
          "(lint, analysis/) are ROADMAP.md, queue 1, item 11",
          file=sys.stderr)
    return 2


def cmd_config(args) -> int:
    """Get/set dotted config keys in ~/.cs.json (reference:
    subcommands/config.py — ``cs config defaults.submit.command-prefix
    'time '`` writes, ``cs config KEY`` reads).  Merges into the existing
    file: clobbering it would silently delete unrelated keys (the
    plugins mapping, custom settings)."""
    cfg = load_cs_config()
    if cfg is None:
        # a corrupt file must never be silently replaced: a write from
        # here would destroy every unrelated setting
        print(f"error: {CONFIG_PATH} exists but is not valid JSON; "
              "fix or remove it first", file=sys.stderr)
        return 1
    if args.set_url:
        cfg["clusters"] = [{"name": "default", "url": args.set_url}]
        CONFIG_PATH.write_text(json.dumps(cfg, indent=2))
        out(cfg)
        return 0
    if args.key is None:
        cfg.setdefault("clusters", [{"name": "default", "url": u}
                                    for u in load_urls(args)])
        out(cfg)
        return 0
    path = args.key.split(".")
    if args.value is None:  # read
        node = cfg
        for part in path:
            if not isinstance(node, dict) or part not in node:
                print(f"configuration key '{args.key}' not found",
                      file=sys.stderr)
                return 1
            node = node[part]
        out(node)
        return 0
    node = cfg  # write: create intermediate tables as needed
    for i, part in enumerate(path[:-1]):
        if part not in node:
            node[part] = {}
        node = node[part]
        if not isinstance(node, dict):
            # a typo'd path through an existing scalar/list must not
            # silently clobber it
            print(f"error: '{'.'.join(path[:i + 1])}' exists and is not "
                  "a table; refusing to overwrite it", file=sys.stderr)
            return 1
    try:
        value: Any = json.loads(args.value)  # "5" -> 5, "true" -> True
    except ValueError:
        value = args.value                   # plain string
    node[path[-1]] = value
    CONFIG_PATH.write_text(json.dumps(cfg, indent=2))
    out({args.key: value})
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cs", description="cook_tpu scheduler CLI")
    p.add_argument("--url", help="scheduler URL")
    p.add_argument("--user", help="submit/query as this user")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("submit", help="submit a job")
    sp.add_argument("--name")
    sp.add_argument("--pool")
    sp.add_argument("--cpus", type=float)
    sp.add_argument("--mem", type=float)
    sp.add_argument("--gpus", type=float)
    sp.add_argument("--priority", type=int)
    sp.add_argument("--max-retries", dest="max_retries", type=int)
    sp.add_argument("--env", action="append")
    sp.add_argument("--label", action="append")
    sp.add_argument("--constraint", action="append",
                    help="attr:EQUALS:value")
    sp.add_argument("--ports", type=int,
                    help="host ports to assign (PORT0.. in the task env)")
    sp.add_argument("--docker-image", dest="docker_image",
                    help="container image to run the command in")
    sp.add_argument("--volume", action="append",
                    help="host:container bind for --docker-image")
    sp.add_argument("--uri", action="append",
                    help="artifact fetched into the sandbox before the "
                         "command runs")
    sp.add_argument("--executor", choices=["cook", ""],
                    help="'cook' wraps the command in the progress-"
                         "tracking executor")
    sp.add_argument("--application",
                    help="submitting application, name[:version]")
    sp.add_argument("--gang-size", dest="gang_size", type=int,
                    help="submit the command as an all-or-nothing gang "
                         "of N member jobs (one group; docs/GANG.md)")
    sp.add_argument("--gang-topology", dest="gang_topology",
                    help="host attribute every gang member's host must "
                         "share, e.g. slice-id")
    sp.add_argument("--gang-policy", dest="gang_policy",
                    choices=["requeue", "kill"],
                    help="what a member failure does to the rest of the "
                         "gang (default requeue)")
    sp.add_argument("--gang-min", dest="gang_min", type=int,
                    help="ELASTIC gang: minimum member count the gang "
                         "may legally run at (docs/GANG.md elasticity; "
                         "default = --gang-size, i.e. rigid)")
    sp.add_argument("--gang-max", dest="gang_max", type=int,
                    help="ELASTIC gang: maximum member count to grow "
                         "to (default = --gang-size)")
    sp.add_argument("--raw", action="store_true",
                    help="read full JSON job spec(s) from stdin")
    sp.add_argument("--command-prefix", dest="command_prefix",
                    help="string prepended to every submitted command "
                         "(default: config defaults.submit.command-prefix)")
    sp.add_argument("command", nargs="*",
                    help="command to run; read from stdin when omitted "
                         "(one job per line)")
    sp.set_defaults(fn=cmd_submit)

    for name, fn in (("show", cmd_show), ("wait", cmd_wait),
                     ("kill", cmd_kill), ("unscheduled", cmd_unscheduled)):
        sp = sub.add_parser(name)
        # zero positional refs -> read uuids/entity-refs from stdin, so
        # `cs jobs --json | cs kill` pipes compose (reference:
        # test_piping_from_jobs_to_kill_show_wait)
        sp.add_argument("uuid", nargs="*",
                        help="job uuid or https://cluster/jobs/<uuid> "
                             "entity ref; stdin when omitted")
        if name == "wait":
            sp.add_argument("--timeout", type=float, default=300.0)
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("retry")
    sp.add_argument("uuid", nargs="*", help="job uuid(s)")
    sp.add_argument("--retries", type=int)
    sp.add_argument("--increment", type=int,
                    help="raise retries BY this much instead of setting")
    sp.add_argument("--group", action="append",
                    help="retry a whole group (repeatable)")
    sp.add_argument("--failed-only", dest="failed_only",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="only resurrect failed members; --no-failed-only "
                         "raises retries on everything (server default: "
                         "failed-only iff groups given)")
    sp.set_defaults(fn=cmd_retry)

    sp = sub.add_parser("jobs", help="list your jobs")
    sp.add_argument("--for-user", dest="for_user")
    sp.add_argument("--state", help="waiting+running+completed")
    sp.add_argument("-1", "--one-per-line", dest="one_per_line",
                    action="store_true",
                    help="print bare uuids, one per line (for piping)")
    sp.set_defaults(fn=cmd_jobs)

    sp = sub.add_parser("usage")
    sp.add_argument("--for-user", dest="for_user")
    sp.add_argument("--pool", help="restrict the report to one pool")
    sp.add_argument("--group-breakdown", dest="group_breakdown",
                    action="store_true",
                    help="split running usage by job group")
    sp.set_defaults(fn=cmd_usage)

    sp = sub.add_parser("pools")
    sp.set_defaults(fn=cmd_pools)

    sp = sub.add_parser("admin")
    sp.add_argument("admin_cmd",
                    choices=["queue", "share", "quota", "stats",
                             "usage", "rebalancer"])
    sp.add_argument("--for-user", dest="for_user")
    sp.add_argument("--pool")
    sp.add_argument("--set", action="append",
                    help="resource=value (cpus=10)")
    # windowed instance-stats args (stats subcommand)
    sp.add_argument("--status", help="unknown|running|success|failed")
    sp.add_argument("--start", help="epoch-ms or ISO-8601")
    sp.add_argument("--end", help="epoch-ms or ISO-8601")
    sp.add_argument("--name", help="job-name filter (* wildcard)")
    sp.set_defaults(fn=cmd_admin)

    sp = sub.add_parser("cat", help="print a sandbox file")
    sp.add_argument("uuid", nargs=1)
    sp.add_argument("path")
    sp.set_defaults(fn=cmd_cat)

    sp = sub.add_parser("tail", help="tail a sandbox file")
    sp.add_argument("uuid", nargs=1)
    sp.add_argument("path")
    sp.add_argument("--lines", type=int, default=10)
    sp.add_argument("--bytes", type=int, default=0,
                    help="read granularity override")
    sp.set_defaults(fn=cmd_tail)

    sp = sub.add_parser("ls", help="list sandbox files")
    sp.add_argument("uuid", nargs=1)
    sp.add_argument("path", nargs="?", default="")
    sp.add_argument("--json", action="store_true")
    sp.set_defaults(fn=cmd_ls)

    sp = sub.add_parser("ssh", help="ssh to the instance's sandbox")
    sp.add_argument("uuid", nargs=1)
    sp.add_argument("--dry-run", dest="dry_run", action="store_true")
    sp.set_defaults(fn=cmd_ssh)

    sp = sub.add_parser("why", help="why isn't my job running: the "
                                    "per-job scheduling audit timeline "
                                    "+ live unscheduled reasons")
    sp.add_argument("uuid", nargs="*",
                    help="job uuid or entity ref; stdin when omitted")
    sp.add_argument("--json", action="store_true",
                    help="raw timeline document instead of the "
                         "rendered lifecycle")
    sp.add_argument("--perfetto", metavar="FILE",
                    help="also export the newest cycle's Chrome trace "
                         "with this job's events as a dedicated track")
    sp.set_defaults(fn=cmd_why)

    sp = sub.add_parser("debug", help="flight recorder: cycle records, "
                                      "Perfetto trace export, fault/"
                                      "breaker states, replication/"
                                      "failover panel")
    sp.add_argument("debug_cmd",
                    choices=["cycles", "trace", "faults", "replication",
                             "health", "requests", "optimizer", "fleet",
                             "storage"])
    sp.add_argument("trace_id", nargs="?",
                    help="trace to export (trace subcommand); default: "
                         "the newest cycle record's trace")
    sp.add_argument("--limit", type=int, default=50,
                    help="cycle records to list (cycles subcommand)")
    sp.add_argument("--out", dest="out_file",
                    help="write the trace JSON here instead of stdout")
    sp.set_defaults(fn=cmd_debug)

    sp = sub.add_parser("lint", help="repo-native static analysis: lock "
                                     "discipline, JIT hygiene, docs-"
                                     "registry completeness "
                                     "(docs/ANALYSIS.md); exits nonzero "
                                     "on any unbaselined finding")
    sp.add_argument("--json", action="store_true", dest="as_json")
    sp.add_argument("--root", default=None)
    sp.add_argument("--docs", default=None)
    sp.add_argument("--baseline", default=None)
    sp.add_argument("--show-suppressed", action="store_true")
    sp.add_argument("--changed", nargs="?", const="HEAD", default=None,
                    metavar="BASE",
                    help="findings restricted to files modified vs a "
                         "git base (default HEAD)")
    sp.add_argument("--lock-coverage", action="store_true",
                    dest="lock_coverage",
                    help="static-vs-observed lock-edge coverage diff")
    sp.add_argument("--observed", default=None, metavar="FILE",
                    help="observed edges source for --lock-coverage "
                         "(a /debug/health JSON)")
    sp.set_defaults(fn=cmd_lint)

    sp = sub.add_parser("config")
    sp.add_argument("--set-url", dest="set_url")
    sp.add_argument("key", nargs="?", help="dotted config key to get/set")
    sp.add_argument("value", nargs="?", help="value to set (JSON or str)")
    sp.set_defaults(fn=cmd_config)
    _register_plugins(sub)
    return p


def _register_plugins(subparsers) -> None:
    """Subcommand plugins (reference: cli/cook/plugins.py + the
    test_cli_subcommand_plugin integration tier): ~/.cs.json may carry
    {"plugins": {"<name>": "dotted.module:register"}}; each register
    callable gets the subparsers object and adds its own parser (with
    set_defaults(fn=...)).  A broken plugin is reported and skipped — it
    must not take the whole CLI down."""
    import importlib
    cfg = load_cs_config()
    if not cfg:
        return
    for name, path in (cfg.get("plugins") or {}).items():
        try:
            module, _, attr = path.partition(":")
            register = getattr(importlib.import_module(module),
                               attr or "register")
            register(subparsers)
        except Exception as e:  # noqa: BLE001 - plugin faults are isolated
            print(f"warning: cli plugin {name!r} ({path}) failed to "
                  f"load: {e}", file=sys.stderr)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except JobClientError as e:
        print(f"error: {e.message}", file=sys.stderr)
        return 1
    except (OSError, TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
