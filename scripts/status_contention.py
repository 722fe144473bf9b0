#!/usr/bin/env python3
"""What a status update costs the node's host as more threads apply
them at once: the ``Scheduler``'s status callback
(``_on_status_update``: the store transaction, its tx listeners) applied
for ``RUNNING`` then ``SUCCESS`` on every task of 2,000 launched jobs,
split across 1, 8, 16, 32 and 64 threads, as 64 agents' pump threads
would apply them if each called back itself.  The remote backend hands
every agent's events to one delivery thread instead
(``cook_tpu_torch/cluster/remote.py``).  Host clock; no card is used.

Usage: ``python3 scripts/status_contention.py [THREADS ...]`` from the
repo root.  Prints one JSON line: ms a status update, by thread count.
"""

import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

JOBS = 2_000


def world():
    from cook_tpu_torch.cluster import FakeCluster, FakeHost
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import Job, Resources, Store
    store = Store()
    uuids = [f"00000000-0000-4000-8000-{k:012d}" for k in range(JOBS)]
    store.create_jobs([Job(uuid=u, user=f"user{k % 60:02d}", command="true",
                           resources=Resources(cpus=1.0, mem=256.0))
                       for k, u in enumerate(uuids)])
    cluster = FakeCluster("f", [FakeHost(f"h{i}", Resources(cpus=64,
                                                             mem=65536))
                                for i in range(64)])
    cfg = Config()
    cfg.pipeline.depth = 0
    sched = Scheduler(store, cfg, [cluster], device="cpu")
    store.launch_instances([dict(job_uuid=u, task_id=f"t{k}",
                                 hostname=f"h{k % 64}", compute_cluster="f")
                            for k, u in enumerate(uuids)])
    return sched


def ms_an_update(n_threads: int) -> float:
    from cook_tpu_torch.state.schema import InstanceStatus
    sched = world()

    def work(ks):
        for k in ks:
            sched._on_status_update(f"t{k}", InstanceStatus.RUNNING, None,
                                    hostname=f"h{k % 64}")
            sched._on_status_update(f"t{k}", InstanceStatus.SUCCESS, None,
                                    exit_code=0, hostname=f"h{k % 64}")

    threads = [threading.Thread(target=work,
                                args=(range(i, JOBS, n_threads),))
               for i in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    sched.shutdown()
    return wall / (2 * JOBS) * 1e3


def main() -> int:
    counts = [int(x) for x in sys.argv[1:]] or [1, 8, 16, 32, 64]
    print(json.dumps({"jobs": JOBS, "updates": 2 * JOBS,
                      "ms_an_update_by_threads": {
                          n: ms_an_update(n) for n in counts}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
