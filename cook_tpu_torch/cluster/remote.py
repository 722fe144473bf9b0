"""The port's copy of ``cook_tpu/cluster/remote.py`` (imports re-rooted).
It builds the repo-root ``native/transport.cpp`` into ``build/native/``
(the reference builds the same source into ``native/build/``), and the
"cook" executor it wraps a task in is ``cook_tpu_torch.agent.executor``.

One difference in threads: each agent's pump thread hands its events to
one delivery thread, which runs ``_on_status`` and ``_on_agent_lost`` in
arrival order; the reference runs them on the pump threads.  With 64
agents, 64 pumps each applying status transactions contend for the
store's lock and the interpreter lock until a node's REST requests
wait past the executor's 10 s progress timeout
(``scripts/status_contention.py`` measures the contention; ``PERF.md``
has the node's numbers).  Each task's events keep
their order, so the decisions and the callbacks a caller sees are the
reference's.  The status path runs on the host only; no tensor is
touched there.

Remote compute cluster over the native C++ transport.

The framework's equivalent of the reference's Mesos backend: the scheduler
binds a *native* driver (libcooktransport.so, built from
``native/transport.cpp``) the way the reference binds the C++
MesosSchedulerDriver through JNI (reference: mesos_compute_cluster.clj:
206-238, project.clj:207 twosigma/mesomatic), and on-node ``cook_agentd``
daemons play the role of the Mesos agent + custom executor pair
(reference: executor/cook/executor.py): they run task commands in their own
process groups under per-task sandboxes and stream status updates back.

Semantics mirrored from the reference backend:
  - offers synthesized as capacity minus tracked consumption per host
    (the k8s-style model, kubernetes/compute_cluster.clj:68-174);
  - status updates delivered through the scheduler's callback exactly like
    mesos status-update -> write-status-to-datomic (scheduler.clj:217);
  - reconciliation on (re)connect (scheduler.clj:1828-1878): the agent's
    REGISTERED frame carries its live task ids, and RECONCILE replays the
    authoritative per-task state; tasks the store considers live but the
    agent no longer knows become NODE_LOST (mea-culpa);
  - sandbox directory writeback (mesos/sandbox.clj:222-353) via the STATUS
    frame's sandbox field.
"""

from __future__ import annotations

import ctypes
import logging
from collections import OrderedDict
import queue
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from ..state.schema import InstanceStatus, Reasons, Resources
from ..utils import tracing
from .base import ComputeCluster, LaunchSpec, Offer

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "transport.cpp"
_BUILD_DIR = _REPO_ROOT / "build" / "native"
_LIB = _BUILD_DIR / "libcooktransport.so"
_AGENTD = _BUILD_DIR / "cook_agentd"

_SEP = "\x1f"
_BUF_CAP = 1 << 20


def compile_fetch_prelude(uris) -> str:
    """Shell prelude fetching each job URI into the sandbox before the
    command runs (reference: the mesos fetcher's copy/download + extract +
    executable bits, driven from :job/uri at mesos/task.clj:114-160).
    Local paths / file:// are copied; http(s) downloads via curl; a failed
    fetch fails the task (exit before the user command)."""
    import shlex
    lines = []
    for uri in uris or []:
        value = (uri.get("value") or "").strip()
        if not value:
            continue
        src = value[7:] if value.startswith("file://") else value
        base = shlex.quote(src.rsplit("/", 1)[-1])
        if value.startswith(("http://", "https://")):
            lines.append(f"curl -sSfL -o {base} {shlex.quote(value)}")
        else:
            lines.append(f"cp {shlex.quote(src)} {base}")
        if uri.get("executable"):
            lines.append(f"chmod +x {base}")
        if uri.get("extract"):
            lines.append(f"tar -xf {base}")
    if not lines:
        return ""
    return "set -e\n" + "\n".join(lines) + "\nset +e\n"


def _build(target: Path, extra: List[str]) -> Optional[Path]:
    from ..native.build import build_if_stale
    return build_if_stale([_SRC, _SRC.parent / "framing.h"], target, extra)


def build_agentd() -> Optional[Path]:
    return _build(_AGENTD, ["-DCOOK_AGENT_MAIN"])


_lib_handle = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib_handle, _lib_tried
    if _lib_tried:
        return _lib_handle
    _lib_tried = True
    path = _build(_LIB, ["-shared", "-fPIC"])
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.ctd_connect.restype = ctypes.c_void_p
    lib.ctd_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.ctd_agent_info.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.ctd_launch.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_double,
                               ctypes.c_double]
    lib.ctd_launch2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_double,
                                ctypes.c_double, ctypes.c_char_p,
                                ctypes.c_int, ctypes.c_char_p,
                                ctypes.c_char_p]
    lib.ctd_launch3.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_double,
                                ctypes.c_double, ctypes.c_char_p,
                                ctypes.c_int, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_char_p]
    lib.ctd_kill.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.ctd_reconcile.argtypes = [ctypes.c_void_p]
    lib.ctd_ping.argtypes = [ctypes.c_void_p]
    lib.ctd_poll.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                             ctypes.c_int]
    lib.ctd_connected.argtypes = [ctypes.c_void_p]
    lib.ctd_close.argtypes = [ctypes.c_void_p]
    _lib_handle = lib
    return lib


def native_available() -> bool:
    return _load() is not None and build_agentd() is not None


class AgentConnection:
    """One driver connection to one cook_agentd (ctypes over the C API)."""

    def __init__(self, host: str, port: int, timeout_ms: int = 5000):
        lib = _load()
        if lib is None:
            raise RuntimeError("native transport unavailable")
        self._lib = lib
        self._handle = lib.ctd_connect(host.encode(), port, timeout_ms)
        if not self._handle:
            raise ConnectionError(f"agent {host}:{port} unreachable")
        self._buf = ctypes.create_string_buffer(_BUF_CAP)
        self._lock = threading.Lock()  # guards handle lifetime vs close
        info = self._call_str(lib.ctd_agent_info)
        (self.agent_id, self.hostname, cpus, mem, gpus, disk,
         running_csv) = info.split(_SEP)
        self.capacity = Resources(cpus=float(cpus), mem=float(mem),
                                  gpus=float(gpus), disk=float(disk))
        self.running_at_connect = ([t for t in running_csv.split(",") if t]
                                   if running_csv else [])

    def _call_str(self, fn) -> str:
        n = fn(self._handle, self._buf, _BUF_CAP)
        if n < 0:
            raise RuntimeError("transport call failed")
        return self._buf.value.decode()

    def launch(self, task_id: str, command: str, cpus: float,
               mem: float, env: Optional[Dict[str, str]] = None,
               port_count: int = 0, image: str = "",
               volumes: Optional[List[str]] = None,
               params: Optional[List[Dict[str, str]]] = None) -> bool:
        env_pairs = [f"{k}={v}" for k, v in (env or {}).items()]
        vol_items = list(volumes or [])
        # docker parameters [{"key": k, "value": v}] -> "--k v" runtime
        # flags agent-side (reference: mesos/task.clj docker parameters)
        par_items = [f"{p['key']}={p.get('value', '')}"
                     for p in (params or [])
                     if isinstance(p, dict) and p.get("key")]
        # The agent splits each of these channels on \x1e (an embedded one
        # in any untrusted value injects extra entries — e.g. a runtime
        # flag like ``--privileged`` past the REST allowlist), and every
        # channel crosses ctypes as a C string, which a NUL byte silently
        # truncates (dropping e.g. the executor env merged after user
        # env).  REST validation rejects both bytes at submission; this
        # layer refuses regardless of the caller, failing the launch.
        wire_fields = (env_pairs + vol_items + par_items
                       + [task_id, command, image])
        if any("\x1e" in s or "\x00" in s for s in wire_fields):
            logging.getLogger(__name__).warning(
                "refusing launch of %s: field embeds a NUL or the \\x1e "
                "wire delimiter", task_id)
            return False
        env_s = "\x1e".join(env_pairs)
        vol_s = "\x1e".join(vol_items)
        par_s = "\x1e".join(par_items)
        with self._lock:
            if not self._handle:
                return False
            return self._lib.ctd_launch3(
                self._handle, task_id.encode(), command.encode(), cpus, mem,
                env_s.encode(), int(port_count), image.encode(),
                vol_s.encode(), par_s.encode()) == 0

    def kill(self, task_id: str, grace_ms: int = 3000) -> bool:
        with self._lock:
            if not self._handle:
                return False
            return self._lib.ctd_kill(self._handle, task_id.encode(),
                                      grace_ms) == 0

    def reconcile(self) -> bool:
        with self._lock:
            if not self._handle:
                return False
            return self._lib.ctd_reconcile(self._handle) == 0

    def poll(self, timeout_ms: int = 100) -> Optional[List[str]]:
        """Next event's fields; None on timeout; raises on closed.

        Only the pump thread calls poll, and close() is only invoked from
        the pump thread itself or after its join (see
        RemoteComputeCluster.shutdown), so the blocking C call needs no
        lock.  rc -2 = event larger than the buffer: grow and retry (the
        event stays queued agent-side) instead of misreading a big frame
        as connection loss and NODE_LOSTing every task."""
        if not self._handle:
            raise ConnectionError("closed")
        while True:
            n = self._lib.ctd_poll(self._handle, self._buf,
                                   ctypes.sizeof(self._buf), timeout_ms)
            if n == 0:
                return None
            if n == -2:
                self._buf = ctypes.create_string_buffer(
                    ctypes.sizeof(self._buf) * 4)
                continue
            if n < 0:
                raise ConnectionError("agent connection closed")
            return self._buf.value.decode().split(_SEP)

    @property
    def connected(self) -> bool:
        with self._lock:  # vs concurrent close(): no use-after-free reads
            return bool(self._handle) and \
                self._lib.ctd_connected(self._handle) == 1

    def close(self) -> None:
        with self._lock:
            if self._handle:
                self._lib.ctd_close(self._handle)
                self._handle = None


class LocalAgentProcess:
    """Spawn a cook_agentd on this machine (tests/single-node deployments)."""

    def __init__(self, hostname: str, cpus: float = 4.0, mem: float = 4096.0,
                 gpus: float = 0.0, disk: float = 0.0,
                 workdir: str = "/tmp/cook-agentd",
                 ports_begin: int = 0, ports_end: int = 0,
                 container_runtime: str = ""):
        agentd = build_agentd()
        if agentd is None:
            raise RuntimeError("cook_agentd unavailable (no C++ toolchain?)")
        Path(workdir).mkdir(parents=True, exist_ok=True)
        self.hostname = hostname
        argv = [str(agentd), "--port", "0", "--hostname", hostname,
                "--cpus", str(cpus), "--mem", str(mem), "--gpus", str(gpus),
                "--disk", str(disk), "--workdir", workdir,
                "--ports-begin", str(ports_begin),
                "--ports-end", str(ports_end)]
        if container_runtime:
            argv += ["--container-runtime", container_runtime]
        self.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline()
        if not line.startswith("PORT "):
            self.proc.kill()
            raise RuntimeError(f"agentd failed to start: {line!r}")
        self.port = int(line.split()[1])

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:  # pragma: no cover
            self.proc.kill()


class RemoteComputeCluster(ComputeCluster):
    """ComputeCluster backed by cook_agentd daemons over the native driver."""

    def __init__(self, name: str, endpoints: List[Tuple[str, int]],
                 pool: str = "default", store=None,
                 kill_grace_ms: int = 3000,
                 progress_url: str = "",
                 executor_python: str = "",
                 executor_pythonpath: str = ""):
        super().__init__(name)
        self.pool = pool
        self.store = store  # optional: sandbox writeback target
        self.kill_grace_ms = kill_grace_ms
        # scheduler REST base URL; jobs running under the "cook" executor
        # POST progress frames here (reference: progress plumbing)
        self.progress_url = progress_url
        # AGENT-side interpreter + cook_tpu_torch location for the "cook"
        # executor wrapper; the defaults (this process's interpreter and
        # repo) are only right when agents share the scheduler's filesystem
        # — multi-node deployments configure the agent-side paths here
        # (the reference ships its executor to agents as a mesos URI).
        import sys as _sys
        self.executor_python = executor_python or _sys.executable
        self.executor_pythonpath = executor_pythonpath or str(_REPO_ROOT)
        self._endpoints = endpoints
        self._agents: Dict[str, AgentConnection] = {}  # hostname -> conn
        # endpoints that failed to connect at initialize: while any
        # remain, this backend cannot POSITIVELY enumerate its tasks
        # (running_task_ids returns None), so the launch-intent sweep
        # defers instead of refunding a task that may be running on the
        # unreachable agent
        self._failed_endpoints: set = set()
        self._lock = threading.RLock()
        # task_id -> (hostname, resources); consumption tracking for offers
        self._tasks: Dict[str, Tuple[str, Resources]] = {}
        # (pump thread, its connection): shutdown() may only close a
        # connection whose pump has actually joined (use-after-free guard)
        self._pumps: List[Tuple[threading.Thread, "AgentConnection"]] = []
        self._stopping = threading.Event()
        # task ids already seen terminal: a late replayed "running" frame
        # must not re-adopt them into consumption tracking
        self._terminal_seen: "OrderedDict[str, None]" = OrderedDict()
        # the pumps' events, (method, args, kwargs), in arrival order; one
        # delivery thread runs them (see the module docstring)
        self._events: "queue.SimpleQueue" = queue.SimpleQueue()
        self._delivery: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, status_callback: Callable) -> None:
        super().initialize(status_callback)
        self._delivery = threading.Thread(
            target=self._deliver, daemon=True,
            name=f"agent-delivery-{self.name}")
        self._delivery.start()
        for host, port in self._endpoints:
            # one dead node must not prevent scheduling on healthy ones
            try:
                self._connect_agent(host, port)
            except (ConnectionError, RuntimeError) as e:
                with self._lock:
                    self._failed_endpoints.add((host, port))
                logging.getLogger(__name__).warning(
                    "agent %s:%s unreachable at startup: %s", host, port, e)
        self._reconcile_store_tasks()

    def _connect_agent(self, host: str, port: int) -> AgentConnection:
        conn = AgentConnection(host, port)
        with self._lock:
            self._failed_endpoints.discard((host, port))
            self._agents[conn.hostname] = conn
            # Adopt tasks already running on the agent (reconnect after a
            # scheduler restart) so offers subtract their consumption.
            for task_id in conn.running_at_connect:
                if task_id not in self._tasks:
                    self._tasks[task_id] = (
                        conn.hostname, self._task_resources(task_id))
        # Reconciliation (scheduler.clj:1828-1878): replay authoritative
        # state for every task the agent knows about.
        conn.reconcile()
        pump = threading.Thread(target=self._pump, args=(conn,), daemon=True,
                                name=f"agent-pump-{conn.hostname}")
        pump.start()
        self._pumps.append((pump, conn))
        return conn

    def _task_resources(self, task_id: str) -> Resources:
        """Best-effort resource lookup for an adopted task."""
        if self.store is not None:
            inst = self.store.instance(task_id)
            if inst is not None:
                job = self.store.job(inst.job_uuid)
                if job is not None:
                    return job.resources
        return Resources()

    def _reconcile_store_tasks(self) -> None:
        """Tasks the store believes are live on this cluster but no agent
        knows about are NODE_LOST, mea-culpa (the reference's task
        reconciliation on (re)register, scheduler.clj:1828-1878)."""
        if self.store is None:
            return
        cb = self._status_callback
        with self._lock:
            known = set(self._tasks)
        for job, inst in self.store.running_instances():
            if inst.compute_cluster != self.name:
                continue
            if inst.task_id not in known and cb is not None:
                cb(inst.task_id, InstanceStatus.FAILED,
                   Reasons.NODE_LOST.code, hostname=inst.hostname)

    def add_agent(self, host: str, port: int) -> None:
        """Dynamic agent registration (elastic capacity)."""
        self._connect_agent(host, port)

    # -- status pump --------------------------------------------------------
    def _pump(self, conn: AgentConnection) -> None:
        while not self._stopping.is_set():
            try:
                ev = conn.poll(timeout_ms=200)
            except ConnectionError:
                if not self._stopping.is_set():
                    self._events.put((self._on_agent_lost, (conn,), {}))
                return
            if ev is None or not ev:
                continue
            if ev[0] == "STATUS" and len(ev) >= 5:
                ports = ([int(p) for p in ev[5].split(",") if p]
                         if len(ev) >= 6 and ev[5] else [])
                self._events.put((self._on_status, (conn,), dict(
                    task_id=ev[1], state=ev[2], exit_code=int(ev[3] or 0),
                    sandbox=ev[4], ports=ports)))

    def _deliver(self) -> None:
        """The delivery thread: every pump's events in arrival order,
        until ``shutdown`` queues None after the pumps have stopped."""
        while True:
            item = self._events.get()
            if item is None:
                return
            fn, args, kw = item
            try:
                fn(*args, **kw)
            except Exception:
                # one event's fault must not stop every agent's delivery
                logging.getLogger(__name__).exception(
                    "agent event delivery failed: %s", kw or args)

    def _on_status(self, conn: AgentConnection, task_id: str, state: str,
                   exit_code: int, sandbox: str,
                   ports: Optional[List[int]] = None) -> None:
        if self.store is not None and sandbox:
            try:
                self.store.update_instance_sandbox(
                    task_id, sandbox_directory=sandbox)
            except Exception:
                pass
        if self.store is not None and ports:
            # assigned host-port writeback (mesos/task.clj:209-237 ->
            # :instance/ports)
            try:
                self.store.update_instance_ports(task_id, ports)
            except Exception:
                pass
        cb = self._status_callback
        if state == "running":
            with self._lock:
                if task_id in self._terminal_seen:
                    # out-of-order/replayed "running" after a terminal
                    # status: adopting it would leak tracked consumption
                    # on that host's offers forever
                    return
                # replayed running status after reconnect: adopt the task
                if task_id not in self._tasks:
                    self._tasks[task_id] = (
                        conn.hostname, self._task_resources(task_id))
            if cb:
                cb(task_id, InstanceStatus.RUNNING, None,
                   hostname=conn.hostname)
            return
        # terminal: release tracked consumption; remember the terminal so a
        # late "running" replay is dropped (bounded memory)
        with self._lock:
            self._tasks.pop(task_id, None)
            self._terminal_seen[task_id] = None
            while len(self._terminal_seen) > 4096:
                self._terminal_seen.popitem(last=False)
        if cb is None:
            return
        if state == "finished":
            cb(task_id, InstanceStatus.SUCCESS, None, exit_code=exit_code,
               hostname=conn.hostname)
        elif state == "killed":
            cb(task_id, InstanceStatus.FAILED, Reasons.KILLED_BY_USER.code,
               exit_code=exit_code, hostname=conn.hostname)
        elif state == "memlimit":
            # the agent's memory watchdog hard-killed the task tree
            # (reference: "Container memory limit exceeded")
            cb(task_id, InstanceStatus.FAILED,
               Reasons.MEMORY_LIMIT_EXCEEDED.code,
               exit_code=exit_code, hostname=conn.hostname)
        else:  # failed
            cb(task_id, InstanceStatus.FAILED, Reasons.NON_ZERO_EXIT.code,
               exit_code=exit_code, hostname=conn.hostname)

    def _on_agent_lost(self, conn: AgentConnection) -> None:
        """Connection dropped: its tasks are NODE_LOST (mea-culpa), exactly
        the reference's slave-lost semantics.  Deliberately NOT a
        circuit-breaker failure: agent loss is a capacity event, and
        counting it would let routine node churn black out launches on
        the cluster's remaining healthy agents."""
        with self._lock:
            if self._agents.get(conn.hostname) is conn:
                del self._agents[conn.hostname]
            lost = [t for t, (h, _) in self._tasks.items()
                    if h == conn.hostname]
            for t in lost:
                del self._tasks[t]
        cb = self._status_callback
        if cb:
            for t in lost:
                cb(t, InstanceStatus.FAILED, Reasons.NODE_LOST.code,
                   hostname=conn.hostname)
        conn.close()  # release the fd/driver; reader thread already exited

    # -- scheduling ---------------------------------------------------------
    def pending_offers(self, pool: str) -> List[Offer]:
        if pool != self.pool:
            return []
        offers = []
        with self._lock:
            consumption: Dict[str, Resources] = {}
            counts: Dict[str, int] = {}
            for h, res in self._tasks.values():
                consumption[h] = consumption.get(h, Resources()) + res
                counts[h] = counts.get(h, 0) + 1
            for hostname, conn in self._agents.items():
                used = consumption.get(hostname, Resources())
                avail = conn.capacity - used
                if not avail.non_negative():
                    avail = Resources()
                offers.append(Offer(
                    id=f"{self.name}/{hostname}",
                    hostname=hostname, slave_id=conn.agent_id, pool=pool,
                    available=avail, capacity=conn.capacity,
                    cluster=self.name,
                    task_count=counts.get(hostname, 0)))
        return offers

    def launch_tasks(self, pool: str, specs: List[LaunchSpec]) -> None:
        from ..utils.faults import injector as _faults
        from ..utils.retry import breakers as _breakers
        breaker = _breakers.get(self.name)
        for spec in specs:
            with self._lock:
                conn = self._agents.get(spec.hostname)
                if conn is not None:
                    self._tasks[spec.task_id] = (spec.hostname, spec.resources)
            if conn is None:
                cb = self._status_callback
                if cb:
                    cb(spec.task_id, InstanceStatus.FAILED,
                       Reasons.CONTAINER_LAUNCH_FAILED.code,
                       hostname=spec.hostname)
                continue
            command, extra_env = self._task_command(spec)
            if command is None:
                # job vanished between match and launch, or has no command:
                # running a placeholder would report SUCCESS for work that
                # never happened
                with self._lock:
                    self._tasks.pop(spec.task_id, None)
                cb = self._status_callback
                if cb:
                    cb(spec.task_id, InstanceStatus.FAILED,
                       Reasons.CONTAINER_LAUNCH_FAILED.code,
                       hostname=spec.hostname)
                continue
            container = spec.container or {}
            with tracing.span("remote.launch", cluster=self.name,
                              hostname=spec.hostname):
                if _faults.should_fire("remote.rpc"):
                    ok = False  # injected transport fault: RPC never lands
                else:
                    ok = conn.launch(
                        spec.task_id, command,
                        spec.resources.cpus, spec.resources.mem,
                        env={**spec.env, **extra_env},
                        port_count=spec.port_count,
                        image=container.get("image", ""),
                        volumes=[v if isinstance(v, str)
                                 else f"{v['host-path']}:"
                                      f"{v['container-path']}"
                                 for v in container.get("volumes", [])],
                        params=container.get("parameters") or [])
            if ok:
                breaker.record_success()
            else:
                breaker.record_failure()
            if not ok:
                with self._lock:
                    self._tasks.pop(spec.task_id, None)
                cb = self._status_callback
                if cb:
                    cb(spec.task_id, InstanceStatus.FAILED,
                       Reasons.CONTAINER_LAUNCH_FAILED.code,
                       hostname=spec.hostname)

    def _task_command(self, spec: LaunchSpec
                      ) -> Tuple[Optional[str], Dict[str, str]]:
        """(command, extra env), command None when it cannot be determined
        (which must fail the launch, not silently succeed). Without a store
        this backend is a pure transport under test; 'true' keeps it
        driveable.

        Task compilation (the reference's mesos/task.clj:114-294 role):
        URI artifacts become a fetch prelude ahead of the user command, and
        :job/executor "cook" wraps the command in the progress-tracking
        executor (python -m cook_tpu_torch.agent.executor) with its
        configuration in the environment."""
        if self.store is None:
            return "true", {}
        job = self.store.job(spec.job_uuid)
        if job is None or not job.command:
            return None, {}
        prelude = compile_fetch_prelude(job.uris)
        command = prelude + job.command if prelude else job.command
        # the reference's task environment (mesos/task.clj:114-135): every
        # task learns its own identity and resource grant from COOK_* vars
        extra: Dict[str, str] = {
            "COOK_JOB_UUID": job.uuid,
            "COOK_INSTANCE_UUID": spec.task_id,
            # count of PRIOR attempts (the launching task is already in
            # job.instances here; the reference counts from the
            # pre-transaction snapshot, so attempt 1 sees 0)
            "COOK_INSTANCE_NUM": str(max(0, len(job.instances) - 1)),
            "COOK_JOB_CPUS": str(job.resources.cpus),
            "COOK_JOB_MEM_MB": str(job.resources.mem),
        }
        if job.resources.gpus:
            extra["COOK_JOB_GPUS"] = str(job.resources.gpus)
        if job.group:
            extra["COOK_JOB_GROUP_UUID"] = job.group
        if job.executor == "cook":
            import shlex
            # prepend (not clobber) any PYTHONPATH the job itself set
            job_pp = job.env.get("PYTHONPATH", "")
            extra["PYTHONPATH"] = (self.executor_pythonpath
                                   + (":" + job_pp if job_pp else ""))
            if self.progress_url:
                extra["COOK_PROGRESS_URL"] = self.progress_url
            if job.progress_regex_string:
                extra["COOK_PROGRESS_REGEX"] = job.progress_regex_string
            if job.progress_output_file:
                extra["COOK_PROGRESS_FILE"] = job.progress_output_file
            command = (f"exec {shlex.quote(self.executor_python)} -m "
                       f"cook_tpu_torch.agent.executor "
                       f"{shlex.quote(command)}")
        return command, extra

    def running_task_ids(self) -> Optional[List[str]]:
        """Task ids this backend is tracking (launched here or adopted
        from agent reconnects) — the launch-intent sweep's positive
        does-the-cluster-know-it check.  None while any configured
        endpoint never connected: the enumeration is incomplete, so a
        task's absence proves nothing (refunding it could double-run
        work still executing on the unreachable agent)."""
        with self._lock:
            if self._failed_endpoints:
                return None
            return list(self._tasks)

    def kill_task(self, task_id: str) -> None:
        with self._lock:
            entry = self._tasks.get(task_id)
            conn = self._agents.get(entry[0]) if entry else None
        if conn is not None:
            conn.kill(task_id, self.kill_grace_ms)

    # -- teardown -----------------------------------------------------------
    def shutdown(self) -> None:
        self._stopping.set()
        closable = []
        for pump, conn in self._pumps:
            pump.join(timeout=2)
            if pump.is_alive():
                # the pump may still be inside ctd_poll; closing now would
                # delete the C driver under it (use-after-free). Leak the
                # handle instead — the daemon thread dies with the process.
                logging.getLogger(__name__).warning(
                    "agent pump for %s did not exit; leaking its handle",
                    conn.hostname)
            else:
                closable.append(conn)
        if self._delivery is not None:
            # what the pumps handed over is delivered first
            self._events.put(None)
            self._delivery.join(timeout=5)
        with self._lock:
            self._agents.clear()
        for conn in closable:
            conn.close()


def factory(store=None, name: str = "native", endpoints=None,
            pool: str = "default", kill_grace_ms: int = 3000,
            progress_url: str = "") -> "RemoteComputeCluster":
    """Config-driven construction for the daemon: ``endpoints`` is a list of
    [host, port] pairs of running cook_agentd daemons."""
    eps = [(h, int(p)) for h, p in (endpoints or [])]
    return RemoteComputeCluster(name, eps, pool=pool, store=store,
                                kill_grace_ms=kill_grace_ms,
                                progress_url=progress_url)
