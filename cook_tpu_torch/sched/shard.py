"""Sharded controller processes (``cook_tpu/sched/shard.py``): one
partition = one process = one mesh shard.

A shard WORKER process owns one contiguous partition block end to end:

- its pools' write plane: the partition ``Store``, fenced by the
  partition lease it acquires at boot (``sched/election.
  acquire_shard_lease``; process death releases the flock);
- its scheduler, which sees only its partition's pools, on the worker's
  ``device`` (``spec["device"]``, default ``"cuda"``): the fused cycle's
  stage kernels K1-K6 run in this process on the card, with the
  resident buffers it commits (``parallel/mesh.pool_sharding``'s
  owner-local contract, across processes);
- its flight recorder and span ring, stamped with the shard identity
  (``flight.set_shard`` + ``tracing.set_process_identity``), so the
  supervisor stitches every shard's spans into one Perfetto export with
  a process track a shard (``tracing.export_fleet_trace``).

Cross-pool global state (per-user totals for DRU and the global caps)
rides ``state/partition.UserSummaryExchange`` between the shard
processes, never job state: the ``peer_fetch`` carrier here is a
framed-JSON localhost socket, and the staleness bound is asserted
(``assert_bound=True``: a dead peer trips ``SummaryStalenessError``
instead of serving a stale total).

The parent-side :class:`ShardSupervisor` spawns N workers (``python -m
cook_tpu_torch.sched.shard <spec.json>``) and fans commands out over the
same socket protocol.  The store role (:class:`_StoreWorker`) is one
partition's write plane alone, with socket replication, for a
process-kill failover harness.

Wire protocol: 4-byte big-endian length + one JSON object per frame;
one request -> one response per frame, connections are serial per
client thread.  Deliberately not HTTP: the exchange sits on the quota
hot path and the store role never imports the REST stack.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

_FRAME_MAX = 64 * 1024 * 1024


# --------------------------------------------------------------------------
# framed-JSON wire helpers (both sides)
# --------------------------------------------------------------------------

def send_msg(sock: socket.socket, obj: Dict[str, Any]) -> None:
    data = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("shard peer closed mid-frame")
        buf += chunk
    return buf


def recv_msg(sock: socket.socket) -> Dict[str, Any]:
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    if n > _FRAME_MAX:
        raise ValueError(f"shard frame of {n} bytes exceeds {_FRAME_MAX}")
    return json.loads(_recv_exact(sock, n).decode("utf-8"))


def rpc(port: int, obj: Dict[str, Any], timeout_s: float = 30.0,
        host: str = "127.0.0.1") -> Dict[str, Any]:
    """One request/response round to a shard worker's control socket.
    Raises on transport errors and re-raises worker-side errors as
    RuntimeError — callers decide whether a dead shard is fatal (parity
    runs) or expected (a failover harness's kill window)."""
    with socket.create_connection((host, port), timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        send_msg(s, obj)
        resp = recv_msg(s)
    if not resp.get("ok"):
        raise RuntimeError(
            f"shard rpc {obj.get('cmd')!r} failed: {resp.get('error')}")
    return resp


def read_addr_file(path: str, timeout_s: float = 30.0) -> Dict[str, Any]:
    """Wait for a worker's atomically-written address announcement
    ({port, pid, repl_port?}) — the boot barrier the supervisor joins."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if doc.get("port"):
                return doc
        except (OSError, json.JSONDecodeError):
            pass
        time.sleep(0.02)
    raise TimeoutError(f"shard address file {path} never appeared "
                       f"(worker failed to boot within {timeout_s}s)")


# --------------------------------------------------------------------------
# peer summary carrier (the UserSummaryExchange socket feed)
# --------------------------------------------------------------------------

class PeerSummaryFeed:
    """``peer_fetch`` carrier for :class:`UserSummaryExchange`: fetch
    every PEER shard's bounded per-user table over the control socket.
    A reachable peer contributes a fresh table (age 0 — the peer
    computes ``Store.user_summary()`` inside the request); an
    unreachable one contributes its last cached table aged by the time
    since that fetch, so the exchange's asserted staleness bound trips
    exactly when the fleet view genuinely decayed past the window."""

    def __init__(self, peer_addr_files: List[str], self_shard: int,
                 timeout_s: float = 5.0):
        self._addr_files = [
            (i, p) for i, p in enumerate(peer_addr_files)
            if i != self_shard]
        self._timeout_s = timeout_s
        self._ports: Dict[int, int] = {}
        # shard -> (table, monotonic fetch time) fallback cache
        self._cache: Dict[int, Tuple[Dict[str, Dict[str, float]], float]] = {}
        self.fetch_errors = 0

    def _port(self, shard: int, path: str) -> int:
        port = self._ports.get(shard)
        if port is None:
            port = int(read_addr_file(path, self._timeout_s)["port"])
            self._ports[shard] = port
        return port

    def __call__(self) -> List[Tuple[Dict[str, Dict[str, float]], float]]:
        out: List[Tuple[Dict[str, Dict[str, float]], float]] = []
        for shard, path in self._addr_files:
            try:
                resp = rpc(self._port(shard, path),
                           {"cmd": "summary"}, timeout_s=self._timeout_s)
                table = resp.get("users") or {}
                self._cache[shard] = (table, time.monotonic())
                out.append((table, 0.0))
            except Exception:
                self.fetch_errors += 1
                self._ports.pop(shard, None)  # re-resolve after failover
                cached = self._cache.get(shard)
                if cached is not None:
                    table, at = cached
                    out.append((table, time.monotonic() - at))
                else:
                    # never seen this peer: the fleet view is unbounded-
                    # stale by definition; inf backdates the sweep so an
                    # asserting consumer refuses instead of under-counting
                    out.append(({}, float("inf")))
        return out


# --------------------------------------------------------------------------
# worker side
# --------------------------------------------------------------------------

class _BaseWorker:
    """Control-socket serving shared by both worker roles: bind, announce
    the address atomically, then one handler thread per connection (the
    failover harness drives concurrent writer threads from the
    parent)."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec
        self.shard = int(spec.get("shard", 0))
        self._stop = threading.Event()
        self._srv: Optional[socket.socket] = None

    # role hooks -----------------------------------------------------------
    def setup(self) -> Dict[str, Any]:
        """Open stores/schedulers; returns extra addr-file fields."""
        return {}

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def teardown(self) -> None:
        pass

    # lifecycle ------------------------------------------------------------
    def serve_forever(self) -> int:
        from ..utils import tracing
        from ..utils.flight import set_shard
        set_shard(self.shard)
        tracing.set_process_identity(f"shard-{self.shard}")
        extra = self.setup()
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(64)
        self._srv = srv
        addr = {"port": srv.getsockname()[1], "pid": os.getpid(),
                "shard": self.shard, **extra}
        path = self.spec["addr_file"]
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(addr, f)
        os.replace(tmp, path)
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except OSError:
                    break
                t = threading.Thread(target=self._conn_loop, args=(conn,),
                                     daemon=True)
                t.start()
        finally:
            self.teardown()
        return 0

    def _conn_loop(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    req = recv_msg(conn)
                except (ConnectionError, OSError, ValueError):
                    return
                try:
                    if req.get("cmd") == "ping":
                        resp = {"ok": True, "shard": self.shard,
                                "pid": os.getpid(),
                                "role": self.spec.get("role", "sched")}
                    elif req.get("cmd") == "shutdown":
                        resp = {"ok": True}
                        send_msg(conn, resp)
                        self._stop.set()
                        if self._srv is not None:
                            try:
                                # close() alone does not wake a thread
                                # blocked in accept() on Linux; shutdown
                                # does (accept fails with EINVAL)
                                self._srv.shutdown(socket.SHUT_RDWR)
                            except OSError:
                                pass
                            try:
                                self._srv.close()
                            except OSError:
                                pass
                        return
                    else:
                        resp = self.handle(req)
                except Exception as e:  # worker must answer, never wedge
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                try:
                    send_msg(conn, resp)
                except OSError:
                    return


class _StoreWorker(_BaseWorker):
    """Store role: one partition's WRITE PLANE only — fenced journal +
    group commit + sync socket replication — no scheduler.
    A failover harness SIGKILLs one of these for real and promotes its
    synced standby in the parent."""

    def setup(self) -> Dict[str, Any]:
        from ..state import replication as repl
        from ..state.store import Store
        spec = self.spec
        store = Store.open(spec["data_dir"], epoch=int(spec["epoch"]),
                           shared=False, partition=self.shard)
        store.attach_fence_authority(spec["authority"])
        self.store = store
        self.server = None
        extra: Dict[str, Any] = {}
        if spec.get("replicate", True):
            srv = repl.ReplicationServer(spec["data_dir"], 0)
            srv.epoch = int(spec["epoch"])
            srv.partition = self.shard
            store.attach_replication(
                srv, sync=True,
                timeout_s=float(spec.get("ack_timeout_s", 5.0)))
            self.server = srv
            extra["repl_port"] = srv.port
        if spec.get("group_commit", True):
            store.enable_group_commit(window_ms=2.0)
        return extra

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        from ..state.store import ReplicationIndeterminate, _job_from_json
        cmd = req.get("cmd")
        if cmd == "put_pool":
            from ..state.schema import Pool
            self.store.put_pool(Pool(name=req["name"]))
            return {"ok": True}
        if cmd == "submit":
            jobs = [_job_from_json(d) for d in req["jobs"]]
            try:
                self.store.create_jobs(jobs)
                return {"ok": True, "outcome": "committed"}
            except ReplicationIndeterminate:
                return {"ok": True, "outcome": "indeterminate"}
        if cmd == "job":
            job = self.store.job(req["uuid"])
            return {"ok": True, "found": job is not None,
                    "state": job.state.value if job else None}
        if cmd == "arm_fault":
            from ..utils.faults import injector
            injector.arm(req["point"],
                         probability=float(req.get("probability", 1.0)),
                         max_fires=req.get("max_fires"))
            return {"ok": True}
        if cmd == "repl_status":
            journal = os.path.join(self.spec["data_dir"], "journal.jsonl")
            size = os.path.getsize(journal) if os.path.exists(journal) else 0
            synced = (self.server.synced_follower_count
                      if self.server is not None else 0)
            return {"ok": True, "synced_followers": synced,
                    "journal_bytes": size}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    def teardown(self) -> None:
        try:
            if self.server is not None:
                self.server.stop()
            self.store.close()
        except Exception:
            pass


class _SchedWorker(_BaseWorker):
    """Full controller shard: partition store + scheduler + fused cycle
    over ONLY this shard's pools on ``spec["device"]`` (default
    ``"cuda"``), socket-fed summary exchange for the global view."""

    def setup(self) -> Dict[str, Any]:
        from ..cluster import FakeCluster
        from ..sched.scheduler import Scheduler
        from ..state.partition import UserSummaryExchange
        from ..state.schema import Pool
        from ..state.store import Store
        spec = self.spec
        n_shards = int(spec.get("n_shards", 1))
        pools: List[str] = list(spec["pools"])
        my_pools = shard_pools(pools, self.shard, n_shards)
        if spec.get("election_dir"):
            from .election import acquire_shard_lease
            # one lease per shard: partition block p maps 1:1 here
            self.lease = acquire_shard_lease(
                spec["election_dir"], self.shard,
                f"shard://{self.shard}")
        store = Store(partition=self.shard if n_shards > 1 else None)
        for name in my_pools:
            store.put_pool(Pool(name=name))
        world = spec.get("world") or {}
        jobs = [j for j in build_world_jobs(world, pools)
                if j.pool in set(my_pools)]
        hosts = build_world_hosts(world, my_pools)
        cfg = config_from_spec(spec.get("cfg") or {})
        cluster = FakeCluster(f"fake-s{self.shard}", hosts)
        sched = Scheduler(store, cfg, [cluster],
                          rank_backend=(spec.get("cfg") or {}).get(
                              "rank_backend", "tpu"),
                          shard_id=self.shard if n_shards > 1 else None,
                          device=spec.get("device", "cuda"))
        for job in jobs:
            store.create_jobs([job])
        self.store, self.sched, self.jobs = store, sched, jobs
        self.my_pools = my_pools
        feed = None
        if n_shards > 1 and spec.get("peers"):
            feed = PeerSummaryFeed(list(spec["peers"]), self.shard)
        self.exchange = UserSummaryExchange(
            [store],
            max_age_s=float(spec.get("summary_max_age_s", 1.0)),
            peer_fetch=feed, assert_bound=True)
        return {"pools": my_pools}

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        cmd = req.get("cmd")
        if cmd == "cycle":
            durations = []
            for _ in range(int(req.get("n", 1))):
                t0 = time.perf_counter()
                self.sched.step_cycle()
                durations.append((time.perf_counter() - t0) * 1000.0)
            return {"ok": True, "cycles": len(durations),
                    "durations_ms": [round(d, 3) for d in durations]}
        if cmd == "decisions":
            out = {}
            for j in self.jobs:
                job = self.store.job(j.uuid)
                hosts = sorted(
                    self.store.instance(t).hostname for t in job.instances
                    if self.store.instance(t) is not None)
                out[j.uuid] = [job.state.value, hosts]
            return {"ok": True, "decisions": out}
        if cmd == "submit":
            from ..state.store import _job_from_json
            jobs = [_job_from_json(d) for d in req["jobs"]]
            self.store.create_jobs(jobs)
            self.jobs.extend(jobs)
            return {"ok": True, "created": len(jobs)}
        if cmd == "summary":
            return {"ok": True, "users": self.store.user_summary()}
        if cmd == "user_totals":
            from ..state.partition import SummaryStalenessError
            try:
                totals = self.exchange.user_totals(req["user"])
            except SummaryStalenessError as e:
                return {"ok": True, "stale": str(e)}
            return {"ok": True, "totals": totals,
                    "staleness_s": self.exchange.staleness_s()}
        if cmd == "exchange_stats":
            return {"ok": True, "stats": self.exchange.stats()}
        if cmd == "flight_summary":
            from ..utils.flight import recorder
            return {"ok": True, "shard": self.shard,
                    "summary": recorder.summary(int(req.get("since_seq", 0)))}
        if cmd == "trace_spans":
            from ..utils import tracing
            if req.get("trace_id"):
                docs = tracing.tracer.traces(req["trace_id"])
            else:
                docs = tracing.tracer.recent(int(req.get("limit", 1000)))
            return {"ok": True, "spans": docs}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}


# --------------------------------------------------------------------------
# deterministic world construction (shared by every topology so 1-process
# and N-process runs see byte-identical jobs and hosts)
# --------------------------------------------------------------------------

def shard_pools(pools: List[str], shard: int, n_shards: int) -> List[str]:
    """The contiguous pool block shard ``shard`` owns: pool i lives on
    write-plane partition i, partitions block over shards — the same
    layout ``parallel.mesh.shard_of_partition`` validates at boot."""
    from ..parallel.mesh import shard_of_partition
    return [p for i, p in enumerate(pools)
            if shard_of_partition(i, len(pools), n_shards) == shard]


def build_world_jobs(world: Dict[str, Any], pools: List[str]) -> List:
    """Fixed-uuid world jobs over ALL pools.  Each job's attributes are
    derived from its INDEX alone (per-index rng stream), so a worker
    filtering to its own pools materializes exactly the same Job values
    the single-process topology does — the bit-identical-launches parity
    contract starts here."""
    import numpy as np

    from ..state.schema import Job, Resources
    n_jobs = int(world.get("n_jobs", 16))
    n_users = int(world.get("n_users", 3))
    seed = int(world.get("seed", 3))
    jobs = []
    for i in range(n_jobs):
        rng = np.random.default_rng(seed * 1_000_003 + i)
        jobs.append(Job(
            uuid=f"00000000-0000-4000-8000-{i:012d}",
            user=f"user{i % n_users}", command="true",
            pool=pools[i % len(pools)],
            priority=int(rng.integers(0, 100)),
            resources=Resources(cpus=float(rng.integers(1, 4)),
                                mem=float(rng.integers(128, 1024))),
            submit_time_ms=1000 + i))
    return jobs


def build_world_hosts(world: Dict[str, Any], pools: List[str]) -> List:
    """Pool-tagged FakeHosts for the given pools, deterministic names —
    offers are pool-filtered (cluster/fake.py), so each pool's matching
    surface is identical whichever process hosts it."""
    from ..cluster import FakeHost
    from ..state.schema import Resources
    hosts_per_pool = int(world.get("hosts_per_pool", 4))
    cpus = float(world.get("host_cpus", 16.0))
    mem = float(world.get("host_mem", 16384.0))
    return [FakeHost(hostname=f"{pool}-h{k}", pool=pool,
                     capacity=Resources(cpus=cpus, mem=mem))
            for pool in pools for k in range(hosts_per_pool)]


def config_from_spec(cfg_spec: Dict[str, Any]):
    from ..config import Config
    cfg = Config()
    cfg.cycle_mode = cfg_spec.get("cycle_mode", "fused")
    cfg.default_matcher.backend = cfg_spec.get("backend", "tpu")
    cfg.pipeline.depth = int(cfg_spec.get("depth", 0))
    cfg.resident_pack = bool(cfg_spec.get("resident", False))
    cfg.quantized_wire = bool(cfg_spec.get("quantized", False))
    return cfg


# --------------------------------------------------------------------------
# supervisor side
# --------------------------------------------------------------------------

class ShardProc:
    def __init__(self, shard: int, proc: subprocess.Popen,
                 addr_file: str, spec_file: str):
        self.shard = shard
        self.proc = proc
        self.addr_file = addr_file
        self.spec_file = spec_file
        self.addr: Dict[str, Any] = {}

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def port(self) -> int:
        return int(self.addr["port"])


class ShardSupervisor:
    """Spawn and drive N shard worker processes.

    Each worker gets ``base_spec`` + its shard identity + the shared
    peer address list (the summary-exchange carrier wiring) + the
    ``device`` its scheduler runs on (unless ``base_spec`` names one);
    per-shard overrides come from ``per_shard`` (a failover harness
    points each store-role worker at its own journal dir + fence
    authority).  The
    supervisor is deliberately thin: it never holds job state — its
    cross-shard reads are the same bounded summaries and telemetry
    documents any shard could serve."""

    def __init__(self, n_shards: int, base_spec: Dict[str, Any],
                 root: Optional[str] = None,
                 per_shard: Optional[List[Dict[str, Any]]] = None,
                 device="cuda"):
        self.n_shards = int(n_shards)
        self.root = root or tempfile.mkdtemp(prefix="cook-shards-")
        os.makedirs(self.root, exist_ok=True)
        self.base_spec = dict(base_spec)
        self.base_spec.setdefault("device", str(device))
        self.per_shard = list(per_shard or [{}] * self.n_shards)
        self.procs: List[ShardProc] = []

    # -------------------------------------------------------------- launch
    def start(self, boot_timeout_s: float = 60.0) -> "ShardSupervisor":
        addr_files = [os.path.join(self.root, f"shard-{i}.addr.json")
                      for i in range(self.n_shards)]
        pkg_parent = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_parent + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        for i in range(self.n_shards):
            spec = dict(self.base_spec, shard=i, n_shards=self.n_shards,
                        addr_file=addr_files[i], peers=addr_files)
            spec.update(self.per_shard[i] if i < len(self.per_shard) else {})
            spec_file = os.path.join(self.root, f"shard-{i}.spec.json")
            with open(spec_file, "w", encoding="utf-8") as f:
                json.dump(spec, f)
            log = open(os.path.join(self.root, f"shard-{i}.log"), "wb")
            proc = subprocess.Popen(
                [sys.executable, "-m", "cook_tpu_torch.sched.shard",
                 spec_file],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=pkg_parent)
            log.close()
            self.procs.append(ShardProc(i, proc, addr_files[i], spec_file))
        deadline = time.monotonic() + boot_timeout_s
        for sp in self.procs:
            remaining = max(0.5, deadline - time.monotonic())
            sp.addr = read_addr_file(sp.addr_file, remaining)
        return self

    # ----------------------------------------------------------------- rpc
    def rpc(self, shard: int, obj: Dict[str, Any],
            timeout_s: float = 60.0) -> Dict[str, Any]:
        return rpc(self.procs[shard].port, obj, timeout_s=timeout_s)

    def broadcast(self, obj: Dict[str, Any],
                  timeout_s: float = 60.0) -> List[Dict[str, Any]]:
        """Fan a command to every live shard CONCURRENTLY — on a
        multi-core host the shards' cycles overlap, which is the whole
        point of the scale-out; serializing here would serialize them."""
        out: List[Optional[Dict[str, Any]]] = [None] * len(self.procs)
        errs: List[Optional[Exception]] = [None] * len(self.procs)

        def _one(i: int) -> None:
            try:
                out[i] = self.rpc(i, dict(obj), timeout_s=timeout_s)
            except Exception as e:
                errs[i] = e

        threads = [threading.Thread(target=_one, args=(i,))
                   for i in range(len(self.procs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout_s + 5.0)
        for e in errs:
            if e is not None:
                raise e
        return [r for r in out if r is not None]

    # ------------------------------------------------------------ stitches
    def collect_decisions(self) -> Dict[str, Tuple[str, Tuple[str, ...]]]:
        """The union launched set across shards: job uuid -> (state,
        sorted hostnames)."""
        merged: Dict[str, Tuple[str, Tuple[str, ...]]] = {}
        for resp in self.broadcast({"cmd": "decisions"}):
            for uuid, (state, hosts) in resp["decisions"].items():
                merged[uuid] = (state, tuple(hosts))
        return merged

    def collect_flight(self, since_seq: int = 0) -> Dict[int, Dict[str, Any]]:
        """Per-shard flight-recorder summaries (each carries its own
        ``by_shard`` roll-up keyed by the worker's shard id)."""
        out: Dict[int, Dict[str, Any]] = {}
        for resp in self.broadcast({"cmd": "flight_summary",
                                    "since_seq": since_seq}):
            out[int(resp["shard"])] = resp["summary"]
        return out

    def collect_trace(self, trace_label: str = "sharded-cycle"
                      ) -> Dict[str, Any]:
        """ONE stitched Perfetto export across every shard's span ring:
        each worker's spans carry its ``shard-<i>`` process identity, so
        ``export_fleet_trace`` renders them as distinct process tracks
        with per-shard provenance in ``otherData``."""
        from ..utils.tracing import export_fleet_trace
        spans: List[Dict[str, Any]] = []
        members: List[Dict[str, Any]] = []
        for sp in self.procs:
            entry: Dict[str, Any] = {"instance": f"shard-{sp.shard}"}
            try:
                resp = self.rpc(sp.shard, {"cmd": "trace_spans"})
                remote = resp.get("spans") or []
                spans.extend(remote)
                entry.update(ok=True, spans=len(remote))
            except Exception as e:
                entry.update(ok=False, error=f"{type(e).__name__}: {e}")
            members.append(entry)
        seen = set()
        deduped = []
        for d in spans:
            key = (d.get("proc"), d.get("span_id"))
            if key not in seen:
                seen.add(key)
                deduped.append(d)
        return export_fleet_trace(deduped, trace_label, members=members)

    # ------------------------------------------------------------ lifecycle
    def kill(self, shard: int, sig: int = signal.SIGKILL) -> None:
        """REAL process kill — a failover harness's victim loss.  SIGKILL by
        default: no handlers, no cleanup, the journal stops mid-write
        exactly as a host loss would leave it."""
        os.kill(self.procs[shard].pid, sig)
        self.procs[shard].proc.wait(timeout=30.0)

    def stop(self) -> None:
        for sp in self.procs:
            if sp.proc.poll() is not None:
                continue
            try:
                rpc(sp.port, {"cmd": "shutdown"}, timeout_s=5.0)
            except Exception:
                pass
        deadline = time.monotonic() + 5.0
        for sp in self.procs:
            while sp.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if sp.proc.poll() is None:
                try:
                    sp.proc.kill()
                    sp.proc.wait(timeout=10.0)
                except OSError:
                    pass


def sched_topology(n_shards: int, pools: List[str],
                   world: Dict[str, Any],
                   cfg: Optional[Dict[str, Any]] = None,
                   summary_max_age_s: float = 1.0,
                   root: Optional[str] = None,
                   device="cuda") -> ShardSupervisor:
    """Convenience: an N-process scheduler topology over ``pools`` with
    a deterministic world, every worker's scheduler on ``device`` — the
    parity tests' entry point."""
    base = {"role": "sched", "pools": list(pools), "world": dict(world),
            "cfg": dict(cfg or {}), "summary_max_age_s": summary_max_age_s}
    return ShardSupervisor(n_shards, base, root=root,
                           device=device).start()


# --------------------------------------------------------------------------
# worker entry point
# --------------------------------------------------------------------------

def run_worker(spec: Dict[str, Any]) -> int:
    role = spec.get("role", "sched")
    worker = _StoreWorker(spec) if role == "store" else _SchedWorker(spec)
    return worker.serve_forever()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage: python -m cook_tpu_torch.sched.shard <spec.json>",
              file=sys.stderr)
        return 2
    with open(argv[0], encoding="utf-8") as f:
        spec = json.load(f)
    rc = run_worker(spec)
    # Hard exit: the scheduler's pump/pipeline threads are non-daemon and
    # would hold the interpreter open past the supervisor's stop deadline.
    # Worker state is crash-safe by contract (a failover harness SIGKILLs these
    # processes), so a clean shutdown owes nothing to interpreter teardown.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


if __name__ == "__main__":
    sys.exit(main())
