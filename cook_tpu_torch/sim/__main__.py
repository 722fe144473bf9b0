"""CLI: python -m cook_tpu_torch.sim --trace trace.json --hosts hosts.json
     or: python -m cook_tpu_torch.sim --workload spec.json [--emit-trace t.json]
     or: python -m cook_tpu_torch.sim --parity-pipeline | --overload
     or: python -m cook_tpu_torch.sim --chaos [--seed N]  (fault-schedule run
         with invariant checks, sim/chaos.py; exit 1 on violations)
     or: python -m cook_tpu_torch.sim --chaos-failover [--partitions N
         [--in-process]]  (failover chaos over socket replication)
     or: python -m cook_tpu_torch.sim --crashpoints  (exhaustive disk-fault /
         crash-point recovery matrix, sim/crashpoint.py; exit 1 on any
         storage-contract violation)
     or: python -m cook_tpu_torch.sim --chaos --cell-outage [--cells N]
         [--soak]  (full-cell outage behind the federation front door,
         sim/federation.py; exit 1 on violations)

The port's copy of ``cook_tpu/sim/__main__.py``, with ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path), which ``--chaos``
hands to ``run_chaos`` and ``--chaos --cell-outage`` to
``run_cell_outage`` (the failover modes touch no device).
``--cell-outage`` without ``--chaos`` is ignored, as in the reference."""

import argparse
import json
import sys

from .simulator import (
    Simulator,
    generate_example_hosts,
    generate_example_trace,
    load_hosts,
    load_trace,
)
from .workload import generate_hosts, generate_trace


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cook_tpu_torch.sim")
    p.add_argument("--trace", help="trace JSON file (default: generated)")
    p.add_argument("--workload",
                   help="statistical workload spec JSON; synthesizes the "
                        "trace instead of --trace (simulator/ parity)")
    p.add_argument("--seed", type=int, default=None,
                   help="workload generation seed (overrides spec)")
    p.add_argument("--emit-trace",
                   help="also write the synthesized trace JSON here")
    p.add_argument("--hosts", help="hosts JSON file (default: generated)")
    p.add_argument("--backend", default="tpu", choices=["tpu", "cpu"])
    p.add_argument("--device", default="cuda",
                   help="torch device the scheduler runs on (default "
                        "cuda; cpu runs the plain PyTorch path)")
    p.add_argument("--jobs", type=int, default=None,
                   help="generated trace size (default 200; chaos "
                        "mode's own default is smaller)")
    p.add_argument("--n-hosts", type=int, default=None,
                   help="generated host count (default 20)")
    p.add_argument("--out", help="write task records CSV here")
    p.add_argument("--chaos", action="store_true",
                   help="run the fault-schedule chaos mode (node loss + "
                        "RPC faults + leader kill/promotion) and assert "
                        "the robustness invariants; exit 1 on violations")
    p.add_argument("--leader-kill-at-ms", type=int, default=None,
                   help="chaos: virtual ms offset of the leader kill "
                        "(default 15000; negative disables)")
    p.add_argument("--chaos-failover", action="store_true",
                   help="run the multi-standby failover chaos (candidate "
                        "ranking, delta pull, old-leader fencing, "
                        "indeterminate commits) over real socket "
                        "replication; exit 1 on violations")
    p.add_argument("--leader-mode", default="sigkill",
                   choices=["sigkill", "partition"],
                   help="chaos-failover: how the leader is lost")
    p.add_argument("--partitions", type=int, default=None,
                   help="chaos-failover: run the PARTITIONED write-plane "
                        "scenario over N partitions instead — kill ONE "
                        "partition leader mid-batch, its standby "
                        "promotes via the candidate ranking while "
                        "sibling partitions keep committing "
                        "uninterrupted; zero committed txns lost, "
                        "per-partition indeterminate demux asserted "
                        "(docs/DEPLOY.md partitioned write plane)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="chaos: drive the production pipelined fused "
                        "cycle at this depth instead of the split host "
                        "path (duplicate-live invariant under overlapped "
                        "optimistic dispatches)")
    p.add_argument("--gangs", type=int, default=None,
                   help="chaos: ride N all-or-nothing gang groups on the "
                        "trace and assert the zero-partial-gangs "
                        "invariant every tick (docs/GANG.md)")
    p.add_argument("--gang-size", type=int, default=None,
                   help="chaos: members per gang (default 3)")
    p.add_argument("--elastic", action="store_true",
                   help="chaos: make the gangs ELASTIC (gang_min = "
                        "size//2, docs/GANG.md elasticity) — asserts "
                        "zero partial gangs at the relaxed minimum and "
                        "drives grace shrinks through the fault "
                        "schedule, including one racing the leader "
                        "kill (defaults --gangs 2 when unset)")
    p.add_argument("--resident", action="store_true",
                   help="chaos: drive the fused cycle off the columnar "
                        "index with the DEVICE-RESIDENT pack on; leader "
                        "kill rebuilds the resident pack on the "
                        "promoted driver")
    p.add_argument("--delta-faults", type=float, default=None,
                   help="chaos: per-call fire probability for the "
                        "delta.extract/delta.apply fault points (each "
                        "hit degrades that cycle to a full repack)")
    p.add_argument("--no-group-commit", action="store_true",
                   help="chaos-failover: disable the leader's "
                        "group-commit admission batching (default ON: "
                        "concurrent submissions share one journal "
                        "fsync + replication ack round, and an ack "
                        "lost mid-batch must demux indeterminate to "
                        "every waiter — never a silent drop)")
    p.add_argument("--overload", action="store_true",
                   help="overload replay (sim/overload.py): heavy-tailed "
                        "users at --overload-multiple x sustainable "
                        "offered load with the admission controller in "
                        "the loop; asserts the brownout ladder engages "
                        "in shed order, recovers, and loses zero "
                        "committed writes.  Combine with --chaos for a "
                        "leader kill MID-BROWNOUT (the promoted "
                        "controller must restore the journaled stage)")
    p.add_argument("--overload-multiple", type=float, default=None,
                   help="overload: offered load as a multiple of "
                        "sustainable capacity (default 10)")
    p.add_argument("--crashpoints", action="store_true",
                   help="run the exhaustive crash-point recovery matrix "
                        "(sim/crashpoint.py): every disk-fault site at "
                        "every append index, every record byte boundary "
                        "truncation, per-record bit flips with peer "
                        "repair, checkpoint crash windows; exit 1 on "
                        "any committed-write loss, phantom, refused "
                        "torn tail, or non-byte-identical repair")
    p.add_argument("--crashpoint-stride", type=int, default=None,
                   help="crashpoints: subsample the fault-site append "
                        "indices (default 1 = every index)")
    p.add_argument("--disk-faults", type=float, default=None,
                   help="chaos: per-append fire probability for the "
                        "store.journal.bitflip point on the leader's "
                        "journal during the failover legs — recovery "
                        "must detect the damage and still converge "
                        "(docs/ROBUSTNESS.md WAL v2)")
    p.add_argument("--in-process", action="store_true",
                   help="partitioned chaos-failover: keep every partition "
                        "leader a thread inside THIS process (the pre-"
                        "scale-out variant).  Default since the multi-"
                        "controller scale-out: one real shard worker "
                        "process per partition, the victim is SIGKILLed")
    p.add_argument("--cell-outage", action="store_true",
                   help="chaos: multi-cell federation outage "
                        "(sim/federation.py): N real cells behind the "
                        "front-door router, one cell hard-killed "
                        "mid-traffic then reclaimed; exit 1 on any lost "
                        "acked submission, split gang, faked-fresh "
                        "read, breaker cascade, or stalled survivors")
    p.add_argument("--cells", type=int, default=None,
                   help="cell-outage: number of federated cells "
                        "(default 2; soak raises to 3)")
    p.add_argument("--soak", action="store_true",
                   help="cell-outage: the slow-tier soak shape (more "
                        "cells, ~5x the traffic)")
    p.add_argument("--parity-pipeline", action="store_true",
                   help="run the pipelined-vs-sync parity harness "
                        "(sim/simulator.py run_pipeline_parity): same "
                        "launched job set, no duplicate live instances; "
                        "exit 1 on divergence")
    args = p.parse_args(argv)

    if args.crashpoints:
        from .crashpoint import run_crashpoints
        cres = run_crashpoints(
            n_jobs=args.jobs or 4,
            stride=args.crashpoint_stride or 1)
        print(json.dumps(cres.summary(), indent=2))
        return 0 if cres.ok else 1

    if args.parity_pipeline:
        from .simulator import run_pipeline_parity
        result = run_pipeline_parity(
            seed=args.seed or 0, n_jobs=args.jobs or 60,
            n_hosts=args.n_hosts or 10,
            depth=args.pipeline_depth or 2, backend=args.backend,
            device=args.device)
        print(json.dumps(result, indent=2))
        return 0 if result["ok"] else 1

    if args.chaos and args.cell_outage:
        from .federation import CellOutageConfig, run_cell_outage
        occ = CellOutageConfig(seed=args.seed or 0, soak=args.soak)
        if args.cells is not None:
            occ.n_cells = args.cells
            occ.__post_init__()
        if args.jobs is not None:
            occ.n_batches = max(args.jobs // 2, 4)
        oresult = run_cell_outage(occ, device=args.device)
        print(json.dumps(oresult.summary(), indent=2))
        return 0 if oresult.ok else 1

    if args.chaos_failover:
        if args.partitions and args.partitions > 1:
            from .chaos import (PartitionChaosConfig, run_partition_chaos,
                                run_partition_chaos_procs)
            pcc = PartitionChaosConfig(
                seed=args.seed or 0, partitions=args.partitions,
                group_commit=not args.no_group_commit,
                process_kill=not args.in_process)
            runner = (run_partition_chaos if args.in_process
                      else run_partition_chaos_procs)
            presult = runner(pcc)
            print(json.dumps(presult.summary(), indent=2))
            return 0 if presult.ok else 1
        from .chaos import FailoverChaosConfig, run_failover_chaos
        result = run_failover_chaos(FailoverChaosConfig(
            seed=args.seed or 0, leader_mode=args.leader_mode,
            group_commit=not args.no_group_commit))
        print(json.dumps(result.summary(), indent=2))
        return 0 if result.ok else 1

    if args.overload and not args.chaos:
        from .overload import run_overload
        summary = run_overload(
            offered_multiple=args.overload_multiple or 10.0,
            seed=args.seed if args.seed is not None else 17,
            device=args.device)
        print(json.dumps(summary, indent=2))
        return 0 if summary["ok"] else 1

    if args.chaos:
        from .chaos import ChaosConfig, run_chaos
        cc = ChaosConfig(seed=args.seed or 0)
        if args.overload:
            cc.overload = True
        if args.jobs is not None:
            cc.n_jobs = args.jobs
        if args.n_hosts is not None:
            cc.n_hosts = args.n_hosts
        if args.leader_kill_at_ms is not None:
            cc.leader_kill_at_ms = (None if args.leader_kill_at_ms < 0
                                    else args.leader_kill_at_ms)
        if args.pipeline_depth is not None:
            cc.pipeline_depth = args.pipeline_depth
        if args.gangs is not None:
            cc.n_gangs = args.gangs
        if args.gang_size is not None:
            cc.gang_size = args.gang_size
        if args.elastic:
            cc.elastic = True
            if not cc.n_gangs:
                cc.n_gangs = 2
        if args.resident:
            cc.resident = True
        if args.delta_faults is not None:
            cc.delta_fault_probability = args.delta_faults
        if args.disk_faults is not None:
            cc.disk_fault_probability = args.disk_faults
        result = run_chaos(cc, device=args.device)
        print(json.dumps(result.summary(), indent=2))
        return 0 if result.ok else 1

    if args.workload:
        spec = json.load(open(args.workload))
        trace_entries = generate_trace(spec, seed=args.seed)
        if args.emit_trace:
            with open(args.emit_trace, "w") as f:
                json.dump(trace_entries, f)
        host_entries = (json.load(open(args.hosts)) if args.hosts
                        else generate_hosts(args.n_hosts or 20))
    else:
        trace_entries = (json.load(open(args.trace)) if args.trace
                         else generate_example_trace(
                             args.jobs or 200, seed=args.seed or 0))
        host_entries = (json.load(open(args.hosts)) if args.hosts
                        else generate_example_hosts(args.n_hosts or 20))
    sim = Simulator(load_trace(trace_entries), load_hosts(host_entries),
                    backend=args.backend, device=args.device)
    result = sim.run()
    print(json.dumps(result.summary(), indent=2))
    if args.out:
        import csv
        with open(args.out, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=[
                "job", "user", "task", "host", "status", "start", "end",
                "wait_ms", "preempted"])
            writer.writeheader()
            writer.writerows(result.task_records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
