"""The port's copy of ``cook_tpu/client`` (stdlib only).

Python job client.

Parity with the reference's Python jobclient (reference:
jobclient/python/cookclient/__init__.py:419 JobClient): submit/query/kill/
wait plus admin helpers, over stdlib urllib (no extra dependencies).
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Union

# a completed job renders as success|failed (the server resolves the raw
# completed state from instances, reference: tools.clj:310-321); "completed"
# is kept for compatibility with older servers
TERMINAL_STATES = frozenset({"completed", "success", "failed"})


class JobClientError(Exception):
    def __init__(self, status: int, message: str,
                 body: Optional[Dict] = None):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.message = message
        # the parsed JSON error body, when there was one — carries the
        # indeterminate-commit contract (``{"indeterminate": true,
        # "jobs": [...]}``, HTTP 504; docs/DEPLOY.md)
        self.body = body or {}

    @property
    def indeterminate(self) -> bool:
        """True when the server could not confirm whether the write
        committed (replication unconfirmed mid-failover).  Safe to
        retry: submission is idempotent on job uuid."""
        return bool(self.body.get("indeterminate"))

    @property
    def request_id(self) -> Optional[str]:
        """The server-echoed X-Cook-Request-Id carried in the error body:
        quote it in a report and an operator joins it to the server's
        slow-request ring (GET /debug/requests) and the trace."""
        return self.body.get("request_id")

    @property
    def reason(self) -> Optional[str]:
        """Machine-readable shed/throttle reason on an admission 429
        ("rate-limited", "user-pending-cap", "brownout-shed", ...)."""
        return self.body.get("reason")

    @property
    def scope(self) -> Optional[str]:
        """Which limit rejected the request ("user", "ip", "global")."""
        return self.body.get("scope")

    @property
    def retry_after_s(self) -> Optional[float]:
        """The server's Retry-After advice in seconds, when it sent one
        (admission 429s and 503s always do)."""
        v = self.body.get("retry_after_s")
        return float(v) if v is not None else None

    @property
    def throttled(self) -> bool:
        """True for an admission rejection (HTTP 429).  Unlike an
        indeterminate 504, a 429 means the server REFUSED the request
        before touching state — the exact same request is safe to retry
        verbatim after backing off (non-indeterminate by construction)."""
        return self.status == 429


class JobClient:
    def __init__(self, url: str, user: str = "anonymous",
                 impersonate: Optional[str] = None, timeout_s: float = 30.0,
                 token: Optional[str] = None,
                 basic_auth: Optional[tuple] = None,
                 read_your_writes: bool = True):
        self.url = url.rstrip("/")
        self.user = user
        self.impersonate = impersonate
        self.timeout_s = timeout_s
        # bearer/negotiate ticket (rest/auth.py HmacTokenAuthenticator) or
        # (user, password) basic credentials for verified servers
        self.token = token
        self.basic_auth = basic_auth
        # trace context of the most recent request (W3C traceparent is
        # minted per request — or inherited from an active in-process
        # span — and sent as a header; the server opens its http.request
        # root under it, so this id keys GET /debug/trace server-side)
        self.last_trace_id: Optional[str] = None
        # the server-echoed X-Cook-Request-Id of the most recent response
        self.last_request_id: Optional[str] = None
        # read-your-writes over the follower fleet (docs/DEPLOY.md):
        # leader write responses carry X-Cook-Commit-Offset (an OPAQUE
        # session token, "<epoch>:<offset>" on fenced journals); with
        # read_your_writes on, later GETs thread the most recent token
        # back as X-Cook-Min-Offset so a behind follower waits briefly
        # or hands the read to the leader — this client never reads a
        # state older than its own confirmed writes
        self.read_your_writes = read_your_writes
        # overload etiquette (docs/ROBUSTNESS.md brownout ladder): how
        # many times one request waits out a 429/503 Retry-After before
        # surfacing the error.  0 disables the wait (the error carries
        # retry_after_s for the caller's own pacing).  The wait is the
        # server's advice bounded by a full-jitter backoff ladder, so a
        # fleet of throttled clients desynchronizes instead of returning
        # in one synchronized retry wave.
        self.throttle_retries = 2
        #: hard ceiling on a single honored Retry-After sleep
        self.throttle_cap_s = 30.0
        self.last_commit_offset: Optional[str] = None
        # partitioned write plane (docs/DEPLOY.md): a partitioned
        # leader's token is a VECTOR of per-partition entries
        # ("p0:3:128,p1:3:64").  The client keeps the LATEST entry PER
        # PARTITION (each partition is its own offset space and its own
        # session: latest-wins per partition, exactly the single-token
        # rule applied P times) and threads the joined vector back as
        # X-Cook-Min-Offset — so a write to partition 0 followed by a
        # write to partition 1 still guarantees read-your-writes for
        # BOTH on later reads.
        self._commit_tokens: dict = {}
        # staleness of the most recent follower-served response
        # (X-Cook-Replication-Offset / -Age-Ms), None when the leader
        # answered
        self.last_replication_offset: Optional[int] = None
        self.last_replication_age_ms: Optional[float] = None
        # pooled keep-alive connections, one per (thread, host:port):
        # ThreadingHTTPServer spawns a thread per CONNECTION, so per-
        # request connections meant per-request thread churn + TCP
        # handshakes — the 4->8 reader QPS regression in the r8 bench.
        # Thread-local so one client shared across threads stays safe.
        self._pool = threading.local()

    # ------------------------------------------------------------- plumbing
    #: a reused keep-alive socket idle past this is proactively recycled
    #: before a NON-idempotent request: the server's idle timeout may
    #: have closed it, and a write whose response is lost must never be
    #: silently re-sent (see _exchange)
    _IDLE_RECYCLE_S = 10.0

    def _connection(self, scheme: str, netloc: str,
                    fresh_for_write: bool = False):
        conns = getattr(self._pool, "conns", None)
        if conns is None:
            conns = self._pool.conns = {}
        key = (scheme, netloc)
        conn = conns.get(key)
        if conn is not None and fresh_for_write \
                and conn._cook_served > 0 \
                and time.monotonic() - conn._cook_last_use \
                > self._IDLE_RECYCLE_S:
            self._drop_connection(scheme, netloc)
            conn = None
        if conn is None:
            cls = (http.client.HTTPSConnection if scheme == "https"
                   else http.client.HTTPConnection)
            conn = cls(netloc, timeout=self.timeout_s)
            conn._cook_served = 0  # requests completed on this socket
            conn._cook_last_use = time.monotonic()
            conns[key] = conn
        return conn

    def _drop_connection(self, scheme: str, netloc: str) -> None:
        conns = getattr(self._pool, "conns", {})
        conn = conns.pop((scheme, netloc), None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def close(self) -> None:
        """Close this thread's pooled keep-alive connections."""
        for scheme, netloc in list(getattr(self._pool, "conns", {})):
            self._drop_connection(scheme, netloc)

    def _exchange(self, scheme: str, netloc: str, method: str,
                  target: str, data: Optional[bytes],
                  headers: Dict[str, str]):
        """One HTTP exchange over the pooled keep-alive connection.
        A REUSED connection the server closed while idle fails on the
        next exchange; the retry policy distinguishes WHERE it failed:

        - during ``request()`` (send phase): nothing reached the
          server — safe to retry ANY method once on a fresh socket;
        - during ``getresponse()``: the server may have processed the
          request and died before answering — only idempotent GETs are
          retried (a silently re-sent POST could duplicate its effect;
          writes surface the error like the per-request-connection
          client did).  Non-idempotent requests avoid this window by
          recycling long-idle sockets up front (_IDLE_RECYCLE_S)."""
        retriable = (http.client.BadStatusLine,
                     http.client.CannotSendRequest,
                     ConnectionError, BrokenPipeError, OSError)
        for attempt in (0, 1):
            conn = self._connection(scheme, netloc,
                                    fresh_for_write=method != "GET")
            reused = conn._cook_served > 0
            try:
                conn.request(method, target, body=data, headers=headers)
            except retriable:
                self._drop_connection(scheme, netloc)
                if attempt == 0 and reused:
                    continue
                raise
            try:
                resp = conn.getresponse()
                raw = resp.read()  # drain fully: keep-alive reuse
            except retriable:
                self._drop_connection(scheme, netloc)
                if attempt == 0 and reused and method == "GET":
                    continue
                raise
            conn._cook_served += 1
            conn._cook_last_use = time.monotonic()
            return resp, raw

    def _merge_commit_token(self, token: str) -> None:
        """Fold one X-Cook-Commit-Offset into the session token: plain
        tokens replace wholesale (latest wins); partition-qualified
        vectors replace per partition; CELL-qualified entries (a
        federation front door's ``cell/p0:3:128`` — docs/DEPLOY.md
        multi-cell federation) replace per (cell, partition), so one
        session token carries read-your-writes across every cell the
        session touched.  All string-level — the entries stay opaque."""
        entries = [e.strip() for e in token.split(",") if e.strip()]

        def _key(e: str) -> Optional[str]:
            # merge key per entry: "p<part>" intra-cell, "<cell>/" or
            # "<cell>/p<part>" when a front door qualified it
            cell, sep, rest = e.partition("/")
            if sep and cell and "/" not in rest:
                if rest.startswith("p") and ":" in rest:
                    return cell + "/" + rest.partition(":")[0]
                return cell + "/"
            return e.partition(":")[0] \
                if e.startswith("p") and ":" in e else None

        keys = [_key(e) for e in entries]
        if not entries or any(k is None for k in keys):
            # legacy single token (or something unrecognized: treat as
            # the opaque session token it is).  Wholesale replacement
            # retires any per-partition vector too — the server that
            # minted this token is not the partitioned plane those
            # entries measured, and resurrecting them on the next
            # vector merge would gate reads on an obsolete journal.
            self._commit_tokens.clear()
            self.last_commit_offset = token
            return
        for k, e in zip(keys, entries):
            self._commit_tokens[k] = e
        self.last_commit_offset = ",".join(
            self._commit_tokens[k]
            for k in sorted(self._commit_tokens))

    def _request(self, method: str, path: str,
                 params: Optional[Dict[str, Union[str, Sequence[str]]]] = None,
                 body: Optional[Dict] = None) -> Any:
        query = ""
        if params:
            pairs = []
            for k, v in params.items():
                if isinstance(v, (list, tuple)):
                    pairs.extend((k, item) for item in v)
                else:
                    pairs.append((k, v))
            query = "?" + urllib.parse.urlencode(pairs)
        data = json.dumps(body).encode() if body is not None else None
        url = self.url + path + query
        # Dapper-style propagation: every request carries a W3C
        # traceparent — an active in-process span's context when one
        # exists (tests, embedded clients), a freshly minted trace
        # otherwise — so the server's http.request span, store txn,
        # journal fsync, and replication ack wait all stitch under ONE
        # trace this client can name (docs/OBSERVABILITY.md)
        from ..utils import tracing
        cur = tracing.tracer.current()
        traceparent = (tracing.make_traceparent(cur.trace_id, cur.span_id)
                       if cur is not None else tracing.make_traceparent())
        self.last_trace_id = \
            tracing.parse_traceparent(traceparent)[0]
        headers = {"Content-Type": "application/json",
                   "X-Cook-User": self.user,
                   "traceparent": traceparent,
                   **({"X-Cook-Impersonate": self.impersonate}
                      if self.impersonate else {})}
        if data is not None:
            headers["Content-Length"] = str(len(data))
        if method == "GET" and self.read_your_writes \
                and self.last_commit_offset:
            # the read-your-writes token: a follower behind this
            # position waits briefly, then redirects the read to the
            # leader
            headers["X-Cook-Min-Offset"] = self.last_commit_offset
        if self.token:
            headers["Authorization"] = "Bearer " + self.token
        elif self.basic_auth:
            import base64
            cred = base64.b64encode(
                f"{self.basic_auth[0]}:{self.basic_auth[1]}".encode()).decode()
            headers["Authorization"] = "Basic " + cred
        raw = None
        # transient-failure budget for idempotent requests: a dropped
        # connection mid-failover must not surface as an error when a
        # jittered retry (utils/retry.py) would land on the new leader
        transient = None
        from ..utils.retry import Backoff
        if method == "GET":
            transient = [2, Backoff(base_s=0.1, cap_s=1.0)]
        # admission throttling (429) / overload (503): the server's
        # Retry-After is honored with full jitter — never a tight loop,
        # never an unbounded sleep (see throttle_retries)
        throttle = [max(0, int(self.throttle_retries)),
                    Backoff(base_s=0.5, cap_s=self.throttle_cap_s)]
        # 8 hops: room for the transient + throttle retry budgets on top
        # of the 307 leader-redirect chain
        for _hop in range(8):  # follow leader redirects (307) incl. POST,
            parsed = urllib.parse.urlsplit(url)
            target = (parsed.path or "/") \
                + ("?" + parsed.query if parsed.query else "")
            try:
                resp, raw = self._exchange(parsed.scheme or "http",
                                           parsed.netloc, method, target,
                                           data, headers)
            except (urllib.error.URLError, ConnectionError, OSError):
                if transient is None or transient[0] <= 0:
                    raise
                transient[0] -= 1
                time.sleep(transient[1].next_delay())
                continue
            echoed_id = resp.getheader("X-Cook-Request-Id")
            forwarded_id = headers.get("X-Cook-Request-Id")
            if forwarded_id and echoed_id and echoed_id != forwarded_id:
                # the hop adopted a DIFFERENT id than the one this chain
                # carries: the redirect's log/ring entries and the
                # leader's can no longer be joined — fail loudly rather
                # than hand back an id that names only half the request
                raise JobClientError(
                    502, "request-id echo mismatch across redirect: "
                         f"forwarded {forwarded_id}, got {echoed_id}")
            self.last_request_id = echoed_id
            co = resp.getheader("X-Cook-Commit-Offset")
            if co is not None:
                # the token is OPAQUE and the LATEST write wins, not a
                # max(): the server's offset space re-bases smaller on
                # a journal checkpoint (and changes epoch on failover),
                # and a pinned stale token from an old space would be
                # unsatisfiable forever.  The read-your-writes session
                # token is the most recent confirmed write, exactly
                # like any session token.  Partition-qualified entries
                # ("pN:...") apply that rule PER PARTITION and the
                # session token becomes the joined vector.
                self._merge_commit_token(co)
            ro = resp.getheader("X-Cook-Replication-Offset")
            self.last_replication_offset = \
                int(ro) if ro and ro.isdigit() else None
            age = resp.getheader("X-Cook-Replication-Age-Ms")
            try:
                self.last_replication_age_ms = \
                    float(age) if age is not None else None
            except ValueError:
                self.last_replication_age_ms = None
            if resp.status == 307 and resp.getheader("Location"):
                url = resp.getheader("Location")
                if echoed_id:
                    # forward the id the redirecting node (a follower)
                    # minted, so the leader ADOPTS it instead of minting
                    # a second one — the two log/ring entries for this
                    # one logical request join on a single id
                    # (docs/OBSERVABILITY.md "Tracing one request")
                    headers["X-Cook-Request-Id"] = echoed_id
                continue
            if resp.status >= 400:
                try:
                    err_body = json.loads(raw)
                    message = err_body.get(
                        "error", f"HTTP {resp.status}")
                except Exception:
                    err_body = {}
                    message = f"HTTP {resp.status}: {resp.reason}"
                if resp.status in (429, 503):
                    # surface the server's pacing advice on the error
                    # even when the retry budget is spent
                    ra = resp.getheader("Retry-After")
                    try:
                        advised = float(ra) if ra is not None else None
                    except ValueError:
                        advised = None
                    if advised is not None:
                        err_body.setdefault("retry_after_s", advised)
                    if throttle[0] > 0 and advised is not None:
                        throttle[0] -= 1
                        # server advice, jittered and capped: sleep a
                        # uniform draw over [0, advice] plus the ladder's
                        # own jitter, bounded by throttle_cap_s and never
                        # shorter than the ladder's first rung (a 429
                        # with Retry-After: 0 must not tight-loop)
                        delay = min(self.throttle_cap_s,
                                    max(throttle[1].next_delay(),
                                        random.uniform(0.0, advised)))
                        time.sleep(delay)
                        continue
                if echoed_id:
                    err_body.setdefault("request_id", echoed_id)
                raise JobClientError(resp.status, message, body=err_body)
            break
        else:
            raise JobClientError(508, "redirect loop")
        if path in ("/metrics", "/metrics/fleet"):
            return raw.decode()
        return json.loads(raw) if raw else None

    # ---------------------------------------------------------------- jobs
    def submit(self, jobs: List[Dict], pool: Optional[str] = None,
               groups: Optional[List[Dict]] = None,
               indeterminate_retries: int = 2,
               idempotent: bool = False) -> List[str]:
        """Submit a batch.  Every spec gets a client-side uuid up front,
        which makes the submission idempotent on job uuid: when the
        server answers HTTP 504 ``indeterminate`` (the commit is
        journaled on the leader but unconfirmed on its mirror — a
        failover may or may not preserve it), the SAME batch is resent
        with ``"idempotent": true`` so the post-failover leader treats
        surviving jobs as successes and creates only the missing ones —
        the retry neither loses nor duplicates (docs/DEPLOY.md).
        ``indeterminate_retries=0`` disables the automatic retry; the
        504 then surfaces as a :class:`JobClientError` whose
        ``indeterminate`` property is True — re-calling submit with the
        same uuid-carrying specs and ``idempotent=True`` is the manual
        form of the same recovery."""
        import uuid as _uuid
        jobs = [dict(spec) for spec in jobs]
        for spec in jobs:
            spec.setdefault("uuid", str(_uuid.uuid4()))
        body: Dict[str, Any] = {"jobs": jobs}
        if pool:
            body["pool"] = pool
        if groups:
            body["groups"] = groups
        if idempotent:
            body["idempotent"] = True
        from ..utils.retry import Backoff
        backoff = Backoff(base_s=0.2, cap_s=2.0)
        attempts = max(0, int(indeterminate_retries))
        while True:
            try:
                return self._request("POST", "/jobs", body=body)["jobs"]
            except JobClientError as e:
                if not e.indeterminate or attempts <= 0:
                    raise
                attempts -= 1
                body["idempotent"] = True
                time.sleep(backoff.next_delay())

    def submit_one(self, command: str, **spec) -> str:
        spec["command"] = command
        return self.submit([spec])[0]

    def query(self, uuids: Sequence[str],
              partial: bool = False) -> List[Dict]:
        params: Dict[str, Any] = {"uuid": list(uuids)}
        if partial:
            params["partial"] = "true"
        return self._request("GET", "/jobs", params=params)

    def job(self, uuid: str) -> Dict:
        return self._request("GET", f"/jobs/{uuid}")

    def jobs(self, user: Optional[str] = None,
             states: Optional[Sequence[str]] = None) -> List[Dict]:
        params: Dict[str, str] = {}
        if user:
            params["user"] = user
        if states:
            params["state"] = "+".join(states)
        return self._request("GET", "/jobs", params=params)

    def kill(self, uuids: Sequence[str]) -> Dict:
        return self._request("DELETE", "/jobs", params={"uuid": list(uuids)})

    def retry(self, uuid: Optional[str] = None, retries: Optional[int] = None,
              *, jobs: Optional[Sequence[str]] = None,
              groups: Optional[Sequence[str]] = None,
              increment: Optional[int] = None,
              failed_only: Optional[bool] = None) -> Dict:
        """PUT /retry (reference: UpdateRetriesRequest rest/api.clj:2480):
        raise retries to ``retries`` or by ``increment`` on jobs and/or
        groups; ``failed_only`` defaults server-side to True iff groups."""
        body: Dict[str, Any] = {}
        if uuid is not None:
            body["job"] = uuid
        if jobs is not None:
            body["jobs"] = list(jobs)
        if groups is not None:
            body["groups"] = list(groups)
        if retries is not None:
            body["retries"] = retries
        if increment is not None:
            body["increment"] = increment
        if failed_only is not None:
            body["failed_only"] = failed_only
        return self._request("PUT", "/retry", body=body)

    def wait(self, uuids: Sequence[str], timeout_s: float = 300.0,
             poll_s: float = 0.5) -> List[Dict]:
        """Block until all jobs complete (reference: cli wait subcommand)."""
        deadline = time.time() + timeout_s
        while True:
            jobs = self.query(uuids)
            if all(j["state"] in TERMINAL_STATES for j in jobs):
                return jobs
            if time.time() > deadline:
                raise TimeoutError(
                    f"jobs not completed within {timeout_s}s")
            time.sleep(poll_s)

    def instance(self, task_id: str) -> Dict:
        return self._request("GET", f"/instances/{task_id}")

    def kill_instances(self, task_ids: Sequence[str]) -> Dict:
        return self._request("DELETE", "/instances",
                             params={"uuid": list(task_ids)})

    # --------------------------------------------------------------- groups
    def group(self, uuids: Sequence[str], detailed: bool = False
              ) -> List[Dict]:
        params: Dict[str, Any] = {"uuid": list(uuids)}
        if detailed:
            params["detailed"] = "true"
        return self._request("GET", "/group", params=params)

    def kill_groups(self, uuids: Sequence[str]) -> Dict:
        return self._request("DELETE", "/group",
                             params={"uuid": list(uuids)})

    def list_jobs(self, user: str, states: Optional[Sequence[str]] = None,
                  start_ms: Optional[int] = None,
                  end_ms: Optional[int] = None,
                  limit: Optional[int] = None) -> List[Dict]:
        params: Dict[str, Any] = {"user": user}
        if states:
            params["state"] = "+".join(states)
        if start_ms is not None:
            params["start-ms"] = str(start_ms)
        if end_ms is not None:
            params["end-ms"] = str(end_ms)
        if limit is not None:
            params["limit"] = str(limit)
        return self._request("GET", "/list", params=params)

    def shutdown_leader(self) -> Dict:
        return self._request("POST", "/shutdown-leader", body={})

    # ---------------------------------------------------------------- admin
    def usage(self, user: Optional[str] = None,
              pool: Optional[str] = None,
              group_breakdown: bool = False) -> Dict:
        """GET /usage.  No user = the all-users report (admin-only);
        ``pool`` restricts either form; ``group_breakdown`` adds the
        per-group running-jobs split."""
        params: Dict[str, str] = {}
        if user is not None:
            params["user"] = user
        if pool is not None:
            params["pool"] = pool
        if group_breakdown:
            params["group_breakdown"] = "true"
        return self._request("GET", "/usage", params=params)

    def queue(self) -> Dict:
        return self._request("GET", "/queue")

    def pools(self) -> List[Dict]:
        return self._request("GET", "/pools")

    def unscheduled_jobs(self, uuids: Sequence[str]) -> List[Dict]:
        return self._request("GET", "/unscheduled_jobs",
                             params={"job": list(uuids)})

    def get_share(self, user: str) -> Dict:
        return self._request("GET", "/share", params={"user": user})

    def set_share(self, user: str, pools: Dict[str, Dict[str, float]],
                  reason: str = "") -> Dict:
        return self._request("POST", "/share",
                             body={"user": user, "pools": pools,
                                   "reason": reason})

    def get_quota(self, user: str) -> Dict:
        return self._request("GET", "/quota", params={"user": user})

    def set_quota(self, user: str, pools: Dict[str, Dict[str, float]],
                  reason: str = "") -> Dict:
        return self._request("POST", "/quota",
                             body={"user": user, "pools": pools,
                                   "reason": reason})

    def failure_reasons(self) -> List[Dict]:
        return self._request("GET", "/failure_reasons")

    def stats(self, status: Optional[str] = None,
              start: Optional[str] = None, end: Optional[str] = None,
              name: Optional[str] = None) -> Dict:
        """GET /stats/instances.  With a status/start/end window, returns
        the reference-shaped histogram report (task_stats.clj); with no
        arguments, the quick by-status/by-reason aggregate."""
        if status is None and start is None and end is None and name is None:
            return self._request("GET", "/stats/instances")
        return self._request(
            "GET", "/stats/instances",
            params={k: v for k, v in (("status", status), ("start", start),
                                      ("end", end), ("name", name))
                    if v is not None})

    def settings(self) -> Dict:
        return self._request("GET", "/settings")

    def set_rebalancer(self, params: Dict) -> Dict:
        """Live rebalancer tuning (admin): {"min-dru-diff": 0.2, ...}."""
        return self._request("POST", "/settings/rebalancer", body=params)

    def info(self) -> Dict:
        return self._request("GET", "/info")

    def metrics(self) -> str:
        return self._request("GET", "/metrics")

    def debug_cycles(self, limit: int = 50) -> Dict:
        """GET /debug/cycles — the scheduler's flight-recorder ring of
        per-cycle records (newest last)."""
        return self._request("GET", "/debug/cycles",
                             params={"limit": str(limit)})

    def debug_trace(self, trace_id: Optional[str] = None,
                    job: Optional[str] = None) -> Dict:
        """GET /debug/trace — spans as Chrome trace-event JSON, loadable
        in chrome://tracing / ui.perfetto.dev.  With ``job``, the job's
        audit timeline is stitched in as a per-job instant-event track;
        ``job`` ALONE returns the fully stitched per-job view (launching
        cycle flamegraph + submission request track + audit lane)."""
        params: Dict = {}
        if trace_id:
            params["trace_id"] = trace_id
        if job:
            params["job"] = job
        return self._request("GET", "/debug/trace", params=params)

    def debug_requests(self, limit: int = 50) -> Dict:
        """GET /debug/requests — the serving plane's recent + slow
        request rings with per-phase breakdowns (redacted params)."""
        return self._request("GET", "/debug/requests",
                             params={"limit": str(limit)})

    def debug_health(self) -> Dict:
        """GET /debug/health — the one-shot roll-up behind ``cs debug
        health``: SLO burn rates, breaker states, replication lag,
        pipeline depth, repack counters, audit queue depth."""
        return self._request("GET", "/debug/health")

    def job_timeline(self, uuid: str) -> Dict:
        """GET /debug/job/<uuid>/timeline — the job's full scheduling
        audit trail plus, while it waits, the unscheduled explainer's
        current reasons and the user's fairness position (`cs why`)."""
        return self._request("GET", f"/debug/job/{uuid}/timeline")

    def debug_faults(self) -> Dict:
        """GET /debug/faults — armed fault points, per-cluster circuit
        breaker states, and open launch intents (docs/ROBUSTNESS.md)."""
        return self._request("GET", "/debug/faults")

    def debug_replication(self) -> Dict:
        """GET /debug/replication — the failover panel: per-follower
        offsets, min_acked, synced set, mirror position, and the
        candidate positions published into the election medium."""
        return self._request("GET", "/debug/replication")

    def debug_optimizer(self) -> Dict:
        """GET /debug/optimizer — the goodput loop's decision panel:
        last per-pool decisions, cycle counts/errors, and the elastic
        resize plane's live state (docs/GANG.md elasticity)."""
        return self._request("GET", "/debug/optimizer")

    def debug_fleet(self) -> Dict:
        """GET /debug/fleet — the federated fleet panel behind ``cs
        debug fleet``: per-member health, staleness, burn, saturation
        hot-spots, and last-scrape age (docs/OBSERVABILITY.md)."""
        return self._request("GET", "/debug/fleet")

    def debug_storage(self) -> Dict:
        """GET /debug/storage — the persistence-integrity panel behind
        ``cs debug storage``: per-partition scrub progress, corruption/
        repair counters, checkpoint manifest status, mirror poison
        state (docs/DEPLOY.md corrupted-journal runbook)."""
        return self._request("GET", "/debug/storage")

    def debug_trace_spans(self, trace_id: str) -> Dict:
        """GET /debug/trace/spans — ONE member's raw span-ring docs for
        a trace id; the fleet trace collector's per-member stitch
        source (normally you want ``debug_trace`` instead)."""
        return self._request("GET", "/debug/trace/spans",
                             params={"trace_id": trace_id})

    def metrics_fleet(self) -> str:
        """GET /metrics/fleet — merged fleet exposition: every member's
        /metrics re-labeled with instance/role."""
        return self._request("GET", "/metrics/fleet")
