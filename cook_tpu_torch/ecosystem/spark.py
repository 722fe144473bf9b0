"""The port's copy of ``cook_tpu/ecosystem/spark.py`` (over the port's
``cook_tpu_torch.client``; host code, no device).

Spark-on-Cook: the reference's Spark integration as working code.

The reference ships two applied patches adding a Cook scheduler backend
INSIDE Spark (reference: ``spark/0001-Add-cook-support-for-spark-v1.5.0
.patch``, ``spark/README.md``) — Spark asks Cook for executors.  That
approach patches a specific Spark version; this module implements the
same capability the way every other cook_tpu_torch ecosystem integration works
(and the way ``docs/ECOSYSTEM.md`` prescribes): run SPARK ITSELF as Cook
jobs — the standalone master and its workers are fleet members managed
by :class:`~cook_tpu_torch.ecosystem.service_farm.ServiceFarm`, and
applications are ``spark-submit`` Cook jobs pointed at the resolved
``spark://host:port`` master URL.  No Spark fork, version-agnostic, and
the scheduler's fair-share/quota/preemption machinery governs Spark's
resources exactly as the reference patch intended.

``spark`` itself is only needed on the nodes that run the jobs; this
module stays importable without it::

    cluster = SparkOnCook(client)
    url = cluster.start_master()          # spark://host:port
    cluster.scale(8)                      # 8 standalone workers
    cluster.submit("wordcount.py", app_args="hdfs://in hdfs://out")
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .service_farm import ServiceFarm

DEFAULT_MASTER_PORT = 7077


class SparkOnCook:
    """Deploy a standalone Spark cluster as Cook jobs.

    ``client`` is a :class:`cook_tpu_torch.client.JobClient` (or the native
    jobclient wrapper — anything with submit/query/kill/jobs).
    """

    def __init__(self, client, name: str = "spark",
                 pool: Optional[str] = None,
                 master_spec: Optional[Dict] = None,
                 worker_spec: Optional[Dict] = None,
                 master_port: int = DEFAULT_MASTER_PORT,
                 spark_class_cmd: str = "spark-class",
                 spark_submit_cmd: str = "spark-submit"):
        self.client = client
        self.name = name
        self.pool = pool
        self.master_port = master_port
        self._spark_submit_cmd = spark_submit_cmd
        mspec = dict(master_spec or {"cpus": 1.0, "mem": 2048.0})
        mspec.setdefault("name", f"{name}-master")
        # two host ports: the RPC endpoint workers/apps dial (PORT0) and
        # the web UI (PORT1); the launch path assigns them and exports
        # PORTn into the task env, so the master must bind THOSE
        mspec.setdefault("ports", 2)
        self._master_farm = ServiceFarm(
            client, f"{name}-master",
            lambda i: (f"{spark_class_cmd} "
                       "org.apache.spark.deploy.master.Master "
                       f"--host $(hostname) --port ${{PORT0:-{master_port}}} "
                       "--webui-port ${PORT1:-0}"),
            spec=mspec, pool=pool)
        self._master_uuid: Optional[str] = None
        self._master_url: Optional[str] = None
        wspec = dict(worker_spec or {"cpus": 2.0, "mem": 4096.0})
        wspec.setdefault("name", f"{name}-worker")
        wspec.setdefault("ports", 1)
        # the worker advertises exactly the cpus/mem Cook allotted it, so
        # Spark's view of the fleet equals the scheduler's accounting —
        # which is only possible for whole cores (--cores is an int), so
        # fractional worker cpus are refused instead of silently
        # over-advertising a rounded-up core
        cpus = float(wspec.get("cpus", 1))
        if cpus < 1 or cpus != int(cpus):
            raise ValueError(
                f"spark worker cpus must be a whole number >= 1 "
                f"(got {cpus}): Spark's --cores cannot advertise a "
                "fractional allotment")
        w_cores = int(cpus)
        w_mem = max(256, int(wspec.get("mem", 1024)))
        self._workers = ServiceFarm(
            client, f"{name}-workers",
            lambda i: (f"{spark_class_cmd} "
                       "org.apache.spark.deploy.worker.Worker "
                       f"--cores {w_cores} --memory {w_mem}M "
                       "--port ${PORT0:-0} "
                       f"{self._master_placeholder()}"),
            spec=wspec, pool=pool)

    def _master_placeholder(self) -> str:
        return self._master_url or "$COOK_SPARK_MASTER"

    # -------------------------------------------------------------- master
    def start_master(self, timeout_s: float = 60.0) -> str:
        """Submit the master job (if needed) and resolve its
        ``spark://host:port`` URL from the running instance."""
        self._master_uuid, host, ports = \
            self._master_farm.start_singleton(timeout_s=timeout_s)
        port = ports[0] if ports else self.master_port
        self._master_url = f"spark://{host}:{port}"
        return self._master_url

    @property
    def master_url(self) -> str:
        if self._master_url is None:
            return self.start_master()
        return self._master_url

    # ------------------------------------------------------------- workers
    def scale(self, n: int) -> List[str]:
        """Converge on n standalone workers; the master is started on
        first use so worker commands carry its resolved URL."""
        if n > 0 and self._master_url is None:
            self.start_master()
        return self._workers.scale(n)

    def wait_workers(self, n: int, timeout_s: float = 60.0) -> None:
        self._workers.wait_running(n, timeout_s=timeout_s)

    # -------------------------------------------------------- applications
    def submit(self, application: str, app_args: str = "",
               spec: Optional[Dict] = None,
               submit_args: str = "") -> str:
        """Run ``spark-submit`` against this cluster as a Cook job and
        return its job uuid: the driver's lifecycle (retries, kill, wait,
        quota) is Cook's, exactly like every other job."""
        job_spec = dict(spec or {"cpus": 1.0, "mem": 2048.0})
        job_spec.setdefault("name", f"{self.name}-app")
        job_spec["command"] = (
            f"{self._spark_submit_cmd} --master {self.master_url} "
            + (f"{submit_args} " if submit_args else "")
            + application + (f" {app_args}" if app_args else ""))
        if self.pool and "pool" not in job_spec:
            job_spec["pool"] = self.pool
        [uuid] = self.client.submit([job_spec])
        return uuid

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Tear the fleet down: workers first, then the master."""
        self._workers.close()
        self._master_farm.close()
        self._master_url = None

    def __enter__(self) -> "SparkOnCook":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
