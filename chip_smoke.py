#!/usr/bin/env python3
"""Chip smoke test of cook_tpu_torch on one NVIDIA card.

Drives the port's paths through their CUDA kernels.

The fused scheduling cycle (``ops/pallas_cycle.megacycle``, stage kernels
K1-K6; K4 runs inside K2's launches and K6 inside K5's) at the production
design point: P = 4 pools of 100,000 live task
rows (T bucket 131,072) from 200 users, 5,000 hosts (H bucket 8,192),
max_jobs_considered 1,000 (C = 1,024), 64 exception rows a pool, finite
user / pool / group quotas, and one pool with 16 gangs of 8 over a
4-value topology attribute.

The split match path (``sched/matcher.dispatch``: greedy through K5,
auction, waterfill) and the top-K preference kernels
(``ops/pallas_match``) at the JAX package's bench worlds: 100,000 jobs x
50,000 hosts with 256 exception rows, and 1,000 or 10,000 jobs x 50,000
hosts.

The resident wire (``sched/fused.sync_resident``, ``ops/delta``), the
split ranker (``ops/dru``) and the preemption search
(``ops/rebalance``), PyTorch code over kernels K2 and K3, at the design
point.

The production cycle driver (``sched/fused.FusedCycleDriver``) from a
``Store`` of submitted jobs to launched tasks on a ``FakeCluster``, at
the JAX package's production-loop world (``bench.py::
bench_driver_cycle``): one pool, 100,000 jobs from 200 users, 5,000
hosts, ``Config()`` defaults (resident and quantized wire).

The scheduler (``sched/scheduler.Scheduler``): ``step_cycle`` through
the synchronous and the pipelined driver (``sched/pipeline``, depth 2,
the default) at ``bench.py::bench_pipeline_driver``'s world, and
``step_rebalance`` (``sched/rebalancer``) on a full cluster.

The leader's other planes: the monitor sweep (``sched/monitor``) feeding
the adaptive admission controller (``sched/admission``), whose level
cuts the split cycle's considerable window, at the same world; a failed
fused cycle degraded to the split path and resident-delta faults
repacked; the reapers on the full cluster.

The node (``python -m cook_tpu_torch --config``, ``daemon.CookDaemon``):
in process under a REST backlog, and as two processes with journal
replication through a SIGKILL failover, each leader driving the cycle's
kernels on the card; and in process over the remote backend
(``cluster/remote``), whose ``cook_agentd`` agents (the repo-root
``native/transport.cpp``) run every placed job as a real process.

The user entry points: the trace-replay simulator
(``cook_tpu_torch.sim``) on a 5,000-job burst over 1,000 hosts, and
the REST plane (``rest/api.CookApi`` behind ``ApiServer``, driven by
``client.JobClient``) at the JAX package's serving bench world; each
runs the scheduler's cycle on the card.

The production scheduler section (``examples/cook-production.json``):
the boot warmup with its kernel cache, the goodput optimizer whose
replays match through K5 on the card, the entity pack's dense-mask
cycle, and the native pack (``native/pack.cpp``) on phase S's arrays.

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the kernels from ``cook_tpu_torch/ops/csrc`` (nvcc);
  3. phase F: K1, K2, K3, K5 and K5+K6 against their plain versions,
     bit for bit, on edge worlds: K1 at S in {1, 4, 33} and T from 1 to
     1,048,576 (tile edges at 1,024, 2,048 and 4,096 +-1; 33,000 and
     100,000 pad two and three levels of the sum, so the tile grid
     shifts and the finisher pads), and at S = 100 and 1,000 (the group
     base's centred windows) with ragged T, the three rows codecs,
     exception rows with duplicates, -1, >= T and rows on tile
     boundaries at E in {0,
     1, 64, 256}, u16 and f32 avail and capacity at H in {1, 7, 8,
     8,192, 65,536}, group ids with -1 and shared groups, +-inf in
     res_base (0 x inf = NaN reaches the bases), 2 CUDA launches a call
     (a captured graph's nodes); every K2 kind and every fused K2/K4
     launch at S in
     {1, 4} and n from 1 to 1,048,576 (segment starts at and just after
     tile boundaries, on every row, on row 0 only and at random; masked
     rows; +-inf and NaN; C in {1, 3, 4}; integer sum and min, reversed
     and offset), at most 2 CUDA launches a K2 call (each call
     captured into a CUDA graph, its nodes counted); K3 at S in {1, 4}
     and n in {1, 1,000, 4,097, 131,072, 262,144} with tied, NaN, -0
     and +inf DRUs, non-rankable rows, ``user_rank`` -1 and n - 1, and
     all-equal keys (passes both run and skipped); K5 on identical hosts whose
     first feasible host lies in the third CTA of the cluster, at H =
     4,000 (a ragged last CTA), with every slot infeasible, at the split
     path's H = 65,536, on a cluster of 16 (H = 100,000) and with the
     slices in device memory (H = 300,000); it prints K5's cluster and
     microseconds a step; the fused K5+K6 launch on the same worlds with
     gang wires (a gang complete, one a member short of gang_min, one
     split across topology domains, one with a member on a host of
     unknown topology, unplaced members, slots with cand_row -1; G = 8
     and 1,024, K6's counts in shared memory and in scratch), one CUDA
     launch a call, beside K5 alone; and it holds K5's fast-path
     division against IEEE ``/`` bit for bit on operands at both edges
     of its range and past them;
  4. phase A: replays every kernel launch of one cycle against its plain
     PyTorch version on the same inputs (integers equal, floats equal
     bit for bit, NaN where NaN) and times kernel (CUDA events, and the
     card's own time from torch.profiler), plain version, and a library
     call where one computes the same function (for the rank sort
     ``torch.sort(stable=True)`` of the packed int64 key, for K2's
     forward integer sums ``torch.cumsum``); each call's CUDA launches
     (the nodes of a CUDA graph captured from it), each K2 call's kind,
     shape and columns, K2 and K4 together (at most 30 CUDA launches a cycle);
     K3's passes; the fused K5+K6 launch (the ``gang`` row) beside K5
     alone on its inputs (the ``greedy`` row); K1 at 2 CUDA launches,
     K5+K6 at 1 and the cycle at most 40;
  5. phase C: two cycles of each of three small worlds for the kernel
     paths the design point does not take (i8 and i16 rows, the
     over-quota limit, gpu mode, K5 at H = 16,384), kernels against the
     plain cycle;
  6. phase B: 5 cycles, each staged through ``stage_mega_wire``
     (quantized wire), run by the kernels and by the plain cycle
     (``megacycle_plain``) on the card; all seven outputs must agree;
     the kept placements are applied before the next cycle; the launch
     counts are zeroed before and read after these cycles; then three
     profiled cycles: the card's time by stage kernel (torch.profiler),
     its idle share of the cycles' span, and the host's time by function
     and its allocating calls (``torch.empty`` and kin) a cycle
     (cProfile); then the resident wire: the same 5 cycles from the
     same world through ``sync_resident`` and
     ``stage_mega_wire(resident=True)`` (a cold repack, then scatters),
     each cycle's outputs equal to the rebuilt wire's and to the plain
     cycle's, counted on their own; 3 churn cycles (1,000 running rows
     a pool finish, 1,000 jobs arrive across its users, user-contiguous)
     staged both ways from the same host arrays, kernels on both wires
     and the plain cycle equal; each cycle's ``stage_ms``,
     ``h2d_bytes``, delta k, path and the sync's device ms; and the
     host time of staging by part in both modes (cProfile);
  6b. phase M: ``DeviceBaseMirror.sync`` through cold, append, no-op,
     overflow, compaction and growth, each step against numpy;
  6c. phase R: the split ranker (``rank_kernel_compact``,
     ``rank_kernel``) on each design pool, then both quota masks over
     its ranked queue, counted and recorded (K2, K3), held bit for bit
     against the plain versions on the card, every recorded launch
     replayed against its plain version, timed;
  6d. phase P: the preemption search for 64 demands on 100,000 tasks x
     5,000 hosts (R = 4) with spare, without, and without with eligible
     NaN DRUs, one call a demand, counted, recorded and replayed, every
     decision bit for bit against the plain version on the card,
     timed;
  6e. phase S: the driver at ``bench_driver_cycle``'s world, nothing
     cut (100,000 jobs, seed 5, priority U[0, 100), submit time U[0,
     10^6), cpus U{1..7}, mem U{64..2047}, users round robin; 5,000
     hosts of 64 cpus and 65,536 MB; ``Config()``): one warm cycle, one
     settle cycle, then 5 timed cycles, each topped up with as many
     fresh jobs as the last launched; each cycle through ``stage``,
     ``dispatch_group``, ``fetch_group`` and ``apply_group``, and
     between fetch and apply the same staged wire through
     ``megacycle_plain`` on the card, all seven outputs equal; after
     each apply no host oversubscribed (by the store's live
     instances), every launched job pending at the pack, placements >
     0; per cycle ``step_ms`` (the four phases, host clock, without the
     plain check), ``pack_ms``, ``stage_ms``, ``enqueue_ms``,
     ``fetch_ms``, ``apply_ms``, ``h2d_bytes``, the resident path and
     its k, placements, and ``status_ms`` (the queued status updates
     applied after the step, as the bench's status shards take them off
     the cycle); the launches counted over these cycles; one step under
     torch.profiler (the card's busy time and idle share); then the
     split cycle (``Ranker.rank_pool``, ``Matcher.match_pool``) on the
     same store, counted on its own, each of its launches recorded and
     replayed against its plain version, and its rank held against
     ``rank_kernel_compact``'s plain version on the same inputs;
     then phase U2 on the same driver and store: one cycle with the
     native pack's three entry points (``pack_diff``, ``order_merge``,
     ``prune_rows``) spied on, each captured call run again through
     ``libcookpack`` and through its numpy branch, equal
     (``native_available()`` must hold), and four cycles in turns
     (native, numpy, numpy, native), their ``stage_ms`` and
     ``pack_ms``;
  6f. phase Q: ``Scheduler.step_cycle`` at ``bench_pipeline_driver``'s
     world, cut to 25,000 jobs from ``_driver_jobs`` (seed 13; 5,000
     hosts of 64 cpus and 65,536 MB; ``Config()``;
     ``status_queue_shards=4``): a depth-0 leg and a depth-2 leg, each
     from a fresh store, one warm step, one settle step, then 5 timed
     steps, each topped up with as many jobs as the last launched, the
     status updates flushed and the published queue touched after each
     (its ``queue.rows`` wait read); p50 and p99, launches, conflicts,
     sync waits by site, the pack / stage / apply split, the launch
     counts of each leg, and one more step under cProfile (the main
     thread's largest own times); the depth-0 leg again without
     status shards (one leg, for the run's time); after
     every step no host oversubscribed and no
     job with two live instances; on each shard leg's store three steps
     whose every dispatched wire is cloned and run through
     ``megacycle_plain`` on the card after its fetch (all seven outputs
     equal); then on the depth-2 store the lazy queue fetch behind a 50 ms sleep kernel on the current stream
     (its wait against a current-stream copy's), one profiled depth-2
     step (busy time, idle share, the next cycle's kernels against the
     host apply's window); and a reduced world (10,000 jobs, 500 hosts)
     4 steps at depth 0 and 4 at depth 2 on the card and with
     ``device="cpu"``, the same (job uuid, hostname) pairs every step;
  6g. phase V: ``step_rebalance`` on a full cluster (2,500 hosts, 100
     users of 100 jobs of 16 cpus and 16,384 MB filled by
     ``step_cycle`` until a step launches nothing; then 1,000 jobs of a
     new user, one ``step_rank`` and one ``step_match``, counted, every
     launch replayed against its plain version and the rank held
     against ``rank_kernel_compact``'s plain version),
     ``RebalancerConfig`` defaults: the ``backend="cpu"`` rebalancer's decisions first (its ``_execute`` a
     no-op), then
     the timed ``step_rebalance`` with every K2 launch recorded and
     replayed and every search's inputs held against
     ``preemption_plain`` on the card; the decisions equal to the cpu
     backend's, the victims FAILED and preempted, every beneficiary
     launched by the next ``step_cycle``;
  6h. phase W: ``Config()`` with ``admission.enabled`` at phase Q's
     world (depth 2, 4 status shards): 6 ``step_cycle``s topped up as
     phase Q's, a ``monitor.sweep()`` after each (``sweep_ms`` on the
     host clock, the ``cook_saturation`` gauges it published, the
     controller's state), one sweep under cProfile (the 12 largest own
     times); the controller driven with ``cycle_p99`` at 1.0 to level
     0.5 or below, then ``step_rank`` + ``step_match`` counted and
     recorded (``admission_split``), every launch replayed against its
     plain version; each window ``int(limit * level)`` (the limit
     ``max_jobs_considered`` or the backoff's), one
     ``admission-throttled`` skip per job cut; the controller driven
     back to stage 0; then the reduced world (10,000 jobs, 500 hosts)
     through the same sequence on the card and with ``device="cpu"``,
     the same pairs every step;
  6i. phase X: the reduced world at depths 0 and 2, on the card and
     with ``device="cpu"`` (the same pairs every step), nothing topped
     up: a step on the delta path, one with ``delta.extract`` armed and
     one with ``delta.apply`` armed (each repacks with reason ``fault``,
     its fallback counted, the step after back on the delta path), one
     with ``fused.dispatch`` armed (the cycle degrades to ``step_rank``
     + ``step_match``: one more ``cook_kernel_fallback{kernel=
     "fused.pool_cycle"}``, the note on its flight record, its launches
     counted as ``scheduler_degraded``, recorded and replayed); on the
     card every dispatched wire held against ``megacycle_plain``; then
     one timed ``step_reapers`` on phase V's full cluster, where 1% of
     the jobs carry a max runtime of 1 ms (``reapers_ms``, the number
     killed, each ``max-runtime-exceeded``);
  6j. phase Y: the simulator (``cook_tpu_torch.sim``). Y1: one
     ``Simulator.run`` with ``Config()`` defaults (fused, depth 2) of
     ``generate_example_trace(n_jobs=5_000, n_users=200, span_ms=
     10_000, duration_ms=10_000)`` (5,000 jobs for the run's time)
     with fixed uuids over
     ``generate_example_hosts(1_000)``, counted (``simulator``); at every
     tick no host over its capacity and no job live twice, and every
     launch of the tick before replayed against its plain version; wall
     time, virtual makespan, ``step_cycle`` calls and their p50 and p99,
     placements, completions (all), waits, preemptions, the flight
     summary.  Y2: 500 jobs from 50 users over 100 hosts on the card
     and with ``device="cpu"``, the same task records and summary less
     its host-clock fields.  Y3: ``run_pipeline_parity`` (seed 3, 600
     jobs, 40 hosts, depth 2) ok.  Y4: ``run_overload()`` ok.  Y5:
     ``python -m cook_tpu_torch.sim --out <csv>`` in process, exit 0;
  6k. phase Z: the REST plane at ``bench.py::bench_rest_plane``'s world
     (a journaled ``Store.open``, ``Config()`` at depth 0, 200 hosts of
     64 cpus and 65,536 MB, ``status_queue_shards=2``, ``CookApi`` behind
     an ``ApiServer`` on localhost). Z1: 4 ``JobClient`` writers submit
     2,000 jobs in batches of 20 (submissions a second, request p50 and
     p99).  Z2: ``step_cycle`` until no job waits (at most 20), counted
     (``rest``), every launch replayed against its plain version, no
     host oversubscribed.  Z3: ten unplaceable jobs more; every
     acknowledged job read back by ``GET /jobs/{uuid}`` at 1, 4 and 8
     readers (QPS, p50, p99), its status and hosts the store's;
     ``/queue``, ``/unscheduled_jobs``, ``/usage``, ``/metrics`` and
     ``/debug`` answer.  Z4: after shutdown the journal reopened, every
     acknowledged job there in its state.  Z5: one writer with fixed
     uuids and a pinned store clock, 500 jobs over 50 hosts, on the card
     and with ``device="cpu"``: the same pairs and job bodies;
  6l. phase N: the node in process (``daemon.CookDaemon``, ``start()``):
     a journaled data dir, an explicit election dir, ``"device":
     "cuda"``, the port's fake cluster of 1,000 hosts of 64 cpus and
     65,536 MB (tasks of 3 s, auto-advanced), a scheduler section that
     sets only ``match_interval_seconds`` 1.0 (fused, depth 2,
     resident, columnar); 4 ``JobClient`` writers submit 1,600 jobs
     from 200 users in batches of 20 (a size for the run's time) and
     the daemon's own loops place and complete them;
     every launch of its cycles recorded and replayed against its plain
     version after its step (path ``daemon``), no host oversubscribed
     and no job live twice after every step; a fault in a step, the
     cycle's own or a check's, which the match loop would log and
     carry on from, fails the phase, as do a step left unchecked and a
     kernel whose path launches differ from its replays'; submissions
     a second, the
     seconds from the last acknowledgement until every job is placed
     and until every job has completed, the dispatching cycles; the
     journal scans clean; after ``shutdown()`` the reopened journal
     holds every acknowledged job in its state;
  6m. phase O: two ``python -m cook_tpu_torch --config`` nodes on the
     card, each with its own data dir, a shared election dir and
     ``"replication": {"listen_port": 0, "sync": true}``, phase N's
     cluster at 200 hosts; the leader on ``nvidia-smi
     --query-compute-apps``'s list (by its pid, or where a container's
     processes all show as pid 1, by one entry more than the processes
     already there; the standby adds none); the port's ``cs`` submits
     100 jobs and
     ``cs wait``s for them; the leader's cluster is drained (``POST
     /compute-clusters/node-fake``) and 300 more are submitted; once
     ``/debug/replication`` shows the standby synced the leader is
     killed with SIGKILL, and the list's count, polled from the kill,
     shows the handover (down to the processes already there, or up by
     one, the new context made before the old one left); the seconds
     from the kill until the standby leads and until its first
     placement; every acknowledged job on the new leader and every
     waiting one placed by it; the new leader on the list;
     ``cook_tpu_torch.sim.system``'s command line (in process: it is a
     client of the node) generates, simulates
     (10 users x 10 jobs over 5 s) and reports against it (wait and
     turnaround p50); SIGTERM ends it with exit code 0;
  6p. phase G: the node over the remote backend: one ``CookDaemon`` in
     process on the card (phase N's scheduler section: fused, depth 2,
     1 s match interval) whose one cluster is
     ``cook_tpu_torch.cluster.remote.factory`` over 64
     ``LocalAgentProcess`` agents (``g-00`` ... ``g-63``, 16 cpus and
     32,768 MB each; ``progress_url`` the node's own URL); 400 jobs
     of 1 cpu and 256 MB from 60 users (a size for the run's time;
     ``phase_g(kinds=...)`` takes more): 16 that fill ``g-00``, its only
     agent at first, and run ``[ "$COOK_INSTANCE_NUM" = 0 ] && sleep 60
     || true``; then the other 63 agents register (``add_agent``) and 4
     ``JobClient`` writers submit in batches of 20 the rest: 204 that
     write ``$COOK_INSTANCE_UUID`` into their sandbox, 100 under
     ``executor: "cook"`` printing two progress lines, 60 ``exit 7``
     with ``max_retries`` 2, 20 ``sleep 60`` killed through REST once
     they run; ``g-00`` is SIGKILLed after the last acknowledgement.
     Every job must end in the reference's state and reason (SUCCESS
     with its uuid in its sandbox, progress 100 in the store,
     NON_ZERO_EXIT twice, KILLED_BY_USER, NODE_LOST then SUCCESS on
     another agent); after every step no agent over its capacity (the
     backend's tracked consumption, the store's live instances a
     host) and no job live twice, and no cycle degraded to the split
     path (the ``fused.pool_cycle`` fallback counter and the flight
     records' ``fused.dispatch-fallback`` notes unmoved); every launch
     replayed against its
     plain version after its step (path ``remote_node``), the path's
     launches equal to the replays'; seconds from the last
     acknowledgement to every job placed and completed, launch to
     ``running`` p50/p99 from the instances' start times,
     ``step_cycle`` p50/p99, progress frames received; then one cycle
     (depth 0) over 8 fresh agents with every job submitted before it,
     the same launched pairs on the card and with ``device="cpu"``;
  6q. phase L: the node over the Kubernetes backend: one ``CookDaemon``
     in process on the card (phase N's scheduler section with
     ``autoscaling_enabled``) under ``election.mode = "k8s-lease"``,
     whose one cluster is
     ``cook_tpu_torch.cluster.k8s.compute_cluster.factory``, both over
     the port's ``MockApiServer`` in process (plain HTTP) with 64 nodes
     ``k-00`` ... ``k-63`` of 16 cpus and 32,768 MB; a kubelet thread
     steps the mock every 100 ms and finishes each running pod 300 ms
     after it saw it run, with its job's exit code, never on ``k-00``;
     400 jobs from 40 users by 4 ``JobClient`` writers in batches of
     20 (312 exit 0, 60 exit 7 with ``max_retries`` 2, 20 killed
     through REST once they run, 8 of 24 cpus that fit no node); once
     16 pods run on ``k-00`` the mock loses it; once the big jobs'
     synthetic pods are up, 4 nodes of 32 cpus join.  Every job must
     end in the reference's state and reason (the lost ones NODE_LOST
     on ``k-00`` first); after every step no node over its capacity
     (the mock's live pods, and the pods ``pending_offers`` lists over
     HTTP), no job live twice; no synthetic pod left; the lease held by
     the node from the first sample to the last at one transition, its
     ``renewTime`` moving, its holder empty after ``shutdown()``; no
     kernel launched from a watch thread; no cycle degraded; every
     launch replayed against its plain version (path ``k8s_node``);
     seconds to placed and completed, pod creation to ``running``
     p50/p99, ``step_cycle`` and ``pending_offers`` p50/p99, synthetic
     pods made and reaped, lease renewals; then one cycle (depth 0)
     over 8 fresh nodes, the pods' (job, node) pairs equal on the card
     and with ``device="cpu"``;
  6r. phase H: the partitioned write plane: one ``CookDaemon`` in
     process on the card (phase N's scheduler section) with
     ``"partitions": {"count": 4, "pools": {"prod": 0, "research": 1,
     "batch": 2}, "summary_max_age_seconds": 1.0}`` (docs/DEPLOY.md's
     deployment; ``default`` hashes to p3) on a journaled data dir, so
     ``p0`` ... ``p3`` and the entity pack's dense-mask K1-K6 cycle; one
     fake cluster a pool, 250 hosts of 64 cpus and 65,536 MB each; 4
     ``JobClient`` writers submit 800 jobs of 1 cpu and 256 MB in
     batches of 20, writer i to pool i only.  Every job must land in its
     pool's partition, each writer's token carry its partition's entry,
     every job be placed and completed, no host over capacity and no job
     live twice after any step; "capped" with a count quota of 8 on
     ``"*"`` submits 6 jobs to prod and 6 to research one by one: 8
     admitted, the rest and the next to each pool refused with 422 once
     the summaries must sweep anew, at most 8 live; ``/debug/replication``
     has four partition blocks at each partition's journal head, the
     monitor one head series a partition; no cycle degraded; every
     launch replayed against its plain version (path
     ``partitioned_node``); after ``shutdown()`` each journal scans
     clean, the reopened plane holds every job in its state and another
     map is refused; drain seconds, ``step_cycle`` p50/p99 with the
     flight records' pack, stage and apply, each partition's journal
     bytes and group commits, the summary exchange's ``stats()``; then
     one cycle (depth 0) over four pools of 8 hosts and 200 jobs, the
     same (job uuid, hostname) pairs on the card and with
     ``device="cpu"``;
  6s. phase CH: the chaos simulator (``sim/chaos``). CH1:
     ``run_chaos(device="cuda")`` at ``CH_WORLD`` (2,000 jobs from 50
     users, 200 hosts, 8 gangs of 4 on slice topology with the last at
     the leader kill, the resident wire at pipeline depth 2, delta
     faults at 0.1, launch-RPC faults at 0.15 up to 50, a node lost
     every 9 s up to 5, the leader killed at 60 s of virtual time), job
     uuids from a counter: the reference's invariants (every job
     completed, one kill with launch intents open and every one
     relaunched, delta faults fired, no user retry charged), no cycle
     degraded, one ``fault`` repack a delta fault and the successor's
     first cycle a ``cold`` one, every launch replayed against its plain
     version before the next cycle stages (path ``chaos``), the summary
     less ``flight`` and every job's instance sequence equal to the
     CPU's; wall seconds, ticks, ``step_cycle`` p50/p99 with the flight
     records' pack, stage and apply, launches, virtual makespan. CH2:
     the reference's tier-1 chaos worlds through ``cook_tpu_torch.sim``'s
     ``main`` on the card and with ``--device cpu``, each exit 0 and
     the same summary less ``flight`` (the flight recorder's cycle
     durations one fixed list on both). CH3: ``--chaos-failover`` with
     ``--leader-mode sigkill`` and ``partition``, and ``--partitions 2``
     in process and with shard worker processes (a real SIGKILL), each
     exit 0 with the fields no thread timing decides;
  6t. phase FO: the multi-cell federation (``federation/``,
     ``sim/federation``). FO1: ``run_cell_outage(device="cuda")`` at
     ``FO_WORLD`` (3 cells of 1,000 hosts of 8 cpus and 8 GiB; 1,000
     batches from 50 users, every fourth a gang of 3: 2,250 jobs; the
     busiest cell killed after half, then reclaimed), job and gang uuids
     from one seeded sequence: the drill's invariants (ok, no job lost,
     no gang split, the victim's breaker open and every survivor's
     closed, work running after), batches re-routed, no cycle degraded,
     every launch (K2, K3, K5 of each cell's ``step_rank`` +
     ``step_match``) replayed against its plain version after the
     ``_step_all`` that made it (path ``federation``), the summary,
     every job's owning cell and every cell's placements equal to the
     CPU's; wall seconds, ``_step_all`` ms a cell, the route p50/p99
     (each ``FederationRouter.submit``, host clock) and the front door's
     ``cook_federation_route_seconds``. FO2: a front door with
     ``route_mode: "goodput"`` on the card over three cells on the card
     whose inventories differ (``FO2_CELLS``), 40 batches of seeded
     shapes: every batch's cell equal to the CPU run's, the replays' K5
     launches counted and replayed (stacked by shape:
     ``replay_stacked``), ``pick_cell``'s ms p50/p99. FO3: a
     ``CookDaemon`` with ``examples/cook-federation.json``'s
     ``"federation"`` section (the cells' local URLs, no dominant-share
     cap) over two cell ``CookDaemon``s on the card of 200 hosts each
     (phase N's section: fused, depth 2); 4 ``JobClient`` writers submit
     400 jobs through the front door; every job placed in the cell the
     router recorded for it and unknown to the other; the cells' steps
     take turns under one lock, each replayed (K1-K6) and checked: no
     host over capacity, no job live twice; no cycle degraded; seconds
     from the last acknowledgement to the last placement;
  6n. phase T: the production scheduler section through
     ``daemon.build_scheduler_config``, with the fake cluster in place
     of its remote backend (phase G drives that backend) and its
     ``compilation_cache_dir`` in ``build/cuda-cache`` (the file's lies
     outside the checkout). T1: two fresh ``python3`` processes on
     phase Q's world (25,000 jobs, 200 users, 5,000 hosts) and 4
     elastic gangs of 8 (min 4), no status shards, a pinned store
     clock: the first with the boot warmup at the file's grid (131,072
     x 8,192, 2,048 users, no sweep; its seconds, its run count held
     to the reference's rule, its launches counted and replayed) over
     an emptied cache (nvcc builds the library there), the second
     without the warmup over that cache (the library loaded); each
     reports the first step's ms against the p50 of ``T_STEPS`` more.
     T2: ``step_optimize`` once with the file's ``optimizer_config`` on
     the first process's world after its steps (the last 900 s, the
     newest 200 jobs, 64 hosts, 6 candidate replays), its seconds and
     decisions, its launches counted (path ``optimizer``), recorded
     and replayed against their plain versions, and the applied levers
     held to the decisions (the grow budget, the shrink pressure less
     what it shed, the rebalancer's ``max_preemption``); then Q_SMALL's
     world (10,000 jobs, 500 hosts) on the card and with
     ``device="cpu"``, the same decisions;
  6o. phase U1: the entity-pack driver (``columnar_index=False``) on
     one pool of 100,000 jobs (T bucket 131,072) x 8,192 hosts, C =
     1,024, 1 cycle counted (path ``dense_cycle``): the cycle's
     dense inputs through ``parallel/sharded.dense_pool_cycle`` on the
     card, every compact output equal bit for bit, the gang outputs
     the no-op reduction; ``pack_ms``, ``stage_ms``, ``h2d_bytes`` and
     the cycle's ms; then a 3,000-job world on the card and on the CPU,
     the same (job uuid, hostname) pairs every cycle;
  7. phase D: the two top-K kernels (structured at 100,000 x 50,000,
     E = 256; dense at 10,000 x 50,000), counted, then held against
     their plain versions (fit bit for bit, host where fit > -inf) and
     timed beside ``torch.topk`` of the materialized score, the dense
     one also with its hosts left unsplit; their operations bound from
     the pairs whose mask is set and the pairs that enter a job's list
     (counted from the plain scores); then the eight
     ``TOPK_CHECKS`` worlds for the paths those leave idle, held the
     same way;
  8. phase E: ``dispatch`` on the card for the three full-width worlds
     at H = 50,000 (auto: greedy at 1,000 jobs; waterfill at 10,000;
     the auction and its tail at 2,500 with tight packing, J cut for
     the run's time), counted and recorded; every recorded
     launch (K2 scans, K5) replayed against its plain version bit for
     bit, each K2 call's CUDA launches counted (at most 2); placements
     checked against oversubscription and the mask; the K5 route held
     against the plain greedy on the card; and every backend on a
     reduced split world, on the card and on the CPU, equal bit for
     bit (each distinct dispatch once: ``auto`` with tight packing is
     the auction's, ``tpu-megakernel`` the greedy's);
  9. prints the card line again, the ``{"kernels": [...]}`` line (each
     stage kernel's launches on every path in ``launches_by_path``,
     phase Q's legs as ``scheduler_sync`` and ``scheduler_pipelined``,
     phase V's ``step_rank`` and ``step_match`` as ``scheduler_split``,
     its ``step_rebalance`` as ``rebalancer``, phase W's split cycle as
     ``admission_split``, phase X's degraded cycles as
     ``scheduler_degraded``, phase Y1 as ``simulator``, phase Z2 as
     ``rest``, phase N as ``daemon``, phase G as ``remote_node``,
     phase L as ``k8s_node``, phase H as ``partitioned_node``,
     phase T's warmup as ``warmup`` and its replays as ``optimizer``,
     phase U1 as ``dense_cycle``, phase SH1 as ``mesh_cycle``, phase
     SH2's worker as ``sharded_controllers``, phase CH1 as ``chaos``,
     phase FO's three parts as ``federation``)
     and last ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (needs one
CUDA card, nvcc and g++): it builds every kernel and native library it
needs, the kernels into ./build/cuda (the ptxas report in
build/cuda/ptxas.log; phase T builds them once more into
./build/cuda-cache) and the replication carrier, the native pack, the
transport library and ``cook_agentd`` into ./build/native.  The CPU
sides of phases Q, X, T, U1, L, H, SH2, CH, FO and E's card = CPU
comparisons run in two spawned worker processes (no CUDA in them)
beside the card phases, and are shut down at the end.  Any failure
raises.
"""

from __future__ import annotations

import cProfile
import json
import logging
import os
import pstats
import re
import statistics
import subprocess
import sys
import time
import urllib.request
from contextlib import contextmanager, nullcontext
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

SEED = 20261016
P, LIVE, USERS, HOSTS, MAX_CONSIDERED, E = 4, 100_000, 200, 5_000, 1_000, 64
GANGS, GANG_SIZE, RACKS = 16, 8, 4
CYCLES = 5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores

SOURCES = {"expand": "expand.cu", "scan": "scan.cu", "sort": "sort.cu",
           "admit": "admit.cu", "greedy": "greedy.cu", "gang": "greedy.cu"}
STAGES = {
    "expand": "K1: wire decode, gathers, phase-0 pool/group bases, one "
              "tiled launch after one memset (the last tile of a pool "
              "finishes its base, the last pool the group bases)",
    "scan": "K2: segmented (associative_scan order), blocked-16 and "
            "integer prefixes, one tiled launch a scan after one memset; "
            "K4's stages run inside as prologues and epilogues",
    "sort": "K3: one-sweep stable LSD radix sorts (rank order, "
            "user-major), one launch per 8-bit pass",
    "admit": "K4: the compaction (its two-column K2 scan with the "
             "scatters as epilogue, then the compact outputs, K4's one "
             "launch of its own)",
    "greedy": "K5: greedy assignment, one thread-block cluster per pool "
              "(timed alone: the split path's instance, on the cycle's "
              "inputs)",
    "gang": "K6: gang_min-gated segment reduction, inside K5's launch as "
            "its epilogue (timed as the fused K5+K6 launch the cycle "
            "makes)",
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ world
def build_world(rng, live=LIVE, users=USERS, hosts=HOSTS, gangs=GANGS,
                e=E):
    """The seeded world: host arrays of every pool plus the base mirror."""
    from cook_tpu_torch.ops.delta import (FLAG_ENQUEUE_OK, FLAG_LAUNCH_OK,
                                          FLAG_PENDING, FLAG_USER_FIRST,
                                          FLAG_VALID)
    from cook_tpu_torch.ops.gang import build_gang_wire
    from cook_tpu_torch.ops.padding import bucket
    T, H = bucket(live), bucket(hosts)
    N = P * live
    res = np.zeros((N, 4), np.float32)
    res[:, 0] = np.round(rng.uniform(0.1, 4.0, N), 1)
    res[:, 1] = rng.integers(128, 8192, N)
    res[:, 2] = rng.random(N) < 0.05
    res[:, 3] = 1.0
    disk = rng.integers(0, 2048, N).astype(np.float32)
    rows = np.zeros((P, T), np.int32)
    flags = np.zeros((P, T), np.uint8)
    task_user = np.zeros((P, T), np.int32)
    weights = 1.0 / np.arange(1, users + 1) ** 0.8
    weights /= weights.sum()
    for p in range(P):
        user = rng.choice(users, live, p=weights)
        pend = rng.random(live) < 0.8
        if p == 0:       # the gang user: pending work only
            pend[user == 0] = True
        key = np.lexsort((rng.random(live), pend, user))
        user, pend = user[key], pend[key]
        task_user[p, :live] = user
        rows[p, :live] = p * live + key
        first = np.ones(live, bool)
        first[1:] = user[1:] != user[:-1]
        flags[p, :live] = (pend * FLAG_PENDING + FLAG_VALID
                           + first * FLAG_USER_FIRST
                           + (rng.random(live) < 0.99) * FLAG_ENQUEUE_OK
                           + (rng.random(live) < 0.98) * FLAG_LAUNCH_OK)
        if p == 3:       # zero-resource tasks of a zero-share user: NaN DRU
            seg = np.flatnonzero(user == 5)[:8]
            res[rows[p, seg], :2] = 0.0
    shares = np.stack([rng.uniform(10, 200, (P, users)),
                       rng.uniform(10, 200, (P, users)) * 1024.0,
                       rng.uniform(1, 8, (P, users))], -1).astype(np.float32)
    shares[3, 5] = 0.0
    # user quotas: most users keep room for five cycles, some bind early
    quota = np.stack([rng.uniform(100, 3000, (P, users)),
                      rng.uniform(100, 3000, (P, users)) * 4096.0,
                      rng.uniform(2, 80, (P, users)),
                      rng.uniform(200, 6000, (P, users))],
                     -1).astype(np.float32)
    tokens = rng.integers(5, 400, (P, users)).astype(np.float32)
    tokens[:, ::7] = np.inf
    cap = np.zeros((P, H, 4), np.float32)
    cap[:, :hosts, 0] = rng.choice([32, 48, 64, 96], (P, hosts))
    cap[:, :hosts, 1] = rng.choice([131072, 262144, 393216], (P, hosts))
    gpu_host = np.zeros((P, H), bool)
    gpu_host[:, :hosts] = rng.random((P, hosts)) < 0.1
    cap[..., 2] = gpu_host * 8.0
    cap[:, :hosts, 3] = 1048576.0
    frac = rng.uniform(0.05, 0.6, (P, H, 4))
    avail = np.stack([np.floor(cap[..., 0] * frac[..., 0] * 2) / 2,
                      np.floor(cap[..., 1] * frac[..., 1] / 1024) * 1024,
                      np.floor(cap[..., 2] * frac[..., 2] + 0.5),
                      np.floor(cap[..., 3] * frac[..., 3] / 1024) * 1024],
                     -1).astype(np.float32)
    blocked = np.ones((P, H), bool)
    blocked[:, :hosts] = rng.random((P, hosts)) < 0.05
    exc_rows = np.zeros((P, e), np.int32)
    for p in range(P):
        exc_rows[p] = rng.choice(np.flatnonzero(flags[p] & FLAG_PENDING), e,
                                 replace=False)
    exc_mask = np.zeros((P, e, H), bool)
    exc_mask[..., :hosts] = rng.random((P, e, hosts)) < 0.6
    # gangs: pool 0, the first pending rows of user 0
    members = np.flatnonzero(flags[0, :live] & FLAG_PENDING)[:gangs * GANG_SIZE]
    groups = {f"g{g}": SimpleNamespace(
        gang=True, gang_size=GANG_SIZE, gang_min=GANG_SIZE, gang_max=0,
        gang_topology="rack" if g % 2 else None) for g in range(gangs)}
    by_gang = {f"g{g}": [(int(r), None) for r in
                         members[g * GANG_SIZE:(g + 1) * GANG_SIZE]]
               for g in range(gangs)}
    offers = [SimpleNamespace(attributes={"rack": str(h % RACKS)})
              for h in range(hosts)]
    gang0 = build_gang_wire(T, by_gang, groups, offers)
    run_total = np.zeros((P, 4), np.float32)
    for p in range(P):
        running = ((flags[p] & FLAG_VALID) != 0) \
            & ((flags[p] & FLAG_PENDING) == 0)
        run_total[p] = res[rows[p][running]].sum(0)
    scalars = {
        "num_considerable": np.full(P, MAX_CONSIDERED, np.int32),
        # headroom for about five cycles of placements, so the caps bind
        # every cycle without closing the queue
        "pool_quota": (run_total + np.array([12000, 5e7, 400, 6000]))
        .astype(np.float32),
        "group_quota": (np.repeat(run_total.reshape(2, 2, 4).sum(1), 2, 0)
                        + np.array([22000, 9e7, 700, 11000]))
        .astype(np.float32),
        "group_id": np.array([0, 0, 1, 1], np.int32)}
    return SimpleNamespace(
        live=live, T=T, H=H, rows=rows, flags=flags, res=res, disk=disk,
        shares=shares, quota=quota, tokens=tokens, cap=cap, avail=avail,
        host_gpu=gpu_host, blocked=blocked, exc_rows=exc_rows,
        exc_mask=exc_mask, scalars=scalars,
        gangs=[gang0] + [None] * (P - 1),
        # what churn needs to keep the layout: each task's user, the user
        # weights, and the base rows of the exception rows and gangs
        task_user=task_user, weights=weights, run_total=run_total,
        exc_ids=np.take_along_axis(rows, exc_rows, 1),
        gang_ids={g: [rows[0, r] for r, _ in m] for g, m in by_gang.items()},
        gang_groups=groups, gang_offers=offers)


def driver_wire(sg):
    """The staged wire of a ``FusedCycleDriver`` group on its default
    one-slot mesh."""
    (wire,) = sg.mega["wires"]
    return wire


def stage(w, res_dev, disk_dev, scales, device="cuda", quantize=True,
          rows=None, flags=None, **resident):
    """``stage_mega_wire`` on the world's host arrays (or on ``rows`` /
    ``flags``); ``resident`` passes ``rows_dev``, ``flags_dev`` and
    ``resident``."""
    from cook_tpu_torch.sched.fused import stage_mega_wire
    return stage_mega_wire(
        rows_p=w.rows if rows is None else rows,
        flags_p=w.flags if flags is None else flags, n_tasks=[w.live] * P,
        res_base=res_dev, disk_base=disk_dev, tokens_u_p=w.tokens,
        shares_u_p=w.shares, quota_u_p=w.quota, scalars=w.scalars,
        host_gpu_p=w.host_gpu, host_blocked_p=w.blocked,
        exc_rows_p=w.exc_rows, exc_mask_p=w.exc_mask, avail_p=w.avail,
        cap_p=w.cap, gang_wires=w.gangs, quantize=quantize, scales=scales,
        device=device, **resident)


def apply(w, res) -> int:
    """The fused driver's apply, in numpy: kept candidates start running
    and their hosts' avail shrinks."""
    from cook_tpu_torch.ops.delta import FLAG_PENDING
    rows = res.cand_row.cpu().numpy()
    hosts = res.cand_gang.cpu().numpy()
    placed = 0
    for p in range(P):
        for c in np.flatnonzero(hosts[p] >= 0):
            r, h = rows[p, c], hosts[p, c]
            base = w.rows[p, r]
            need = np.concatenate([w.res[base, :3], w.disk[base:base + 1]])
            w.flags[p, r] &= ~np.uint8(FLAG_PENDING)
            w.avail[p, h] = w.avail[p, h] - need
            placed += 1
    return placed


def megacycle_args(staged, max_considered=MAX_CONSIDERED, **modes):
    from cook_tpu_torch.ops.padding import bucket
    return dict(considerable_cap=bucket(max_considered),
                rows_codec=staged["rows_codec"], **modes,
                avail_scale=staged["avail_scale"],
                cap_scale=staged["cap_scale"])


# ----------------------------------------------------------------- checks
def tensors_of(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for t in out if isinstance(t, torch.Tensor)]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; raises unless equal bit for bit (NaN with NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"dtype/shape {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            raise AssertionError("kernel and plain version differ in NaNs")
        same = torch.equal(a[~na].view(torch.int32), b[~nb].view(torch.int32))
        err = float((a[~na] - b[~nb]).abs().max()) if (~na).any() else 0.0
    else:
        same = torch.equal(a, b)
        err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    if not same:
        raise AssertionError(f"kernel and plain version differ "
                             f"(max abs err {err})")
    return err


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int, kernels_per_call: int = 0):
    """The card's own time a call (kernels and memsets, from
    torch.profiler's CUDA activity over ``reps`` calls), or None where
    the profiler reports no device time.  Unlike ``cuda_ms`` it does not
    count the gaps in which the card waits for the host.
    ``kernels_per_call``: the kernels one call launches (counted from a
    captured graph), which a whole trace must hold."""
    fn()
    prof, _ = profiled(fn, reps, kernels=kernels_per_call * reps)
    us = sum(device_us(e) for e in prof.key_averages()) if prof else 0.0
    return us / 1e3 / reps if us > 0 else None


def profiled(fn, reps: int, tries: int = 3, kernels: int = 0) -> tuple:
    """(torch.profiler's trace of ``reps`` calls of ``fn``, its device
    activities in launch order), or (None, []).  The profiler can drop
    activities, even a whole trace's: a trace that holds fewer kernels
    than the C entries the calls made (each launches at least one; the
    stage counters count them on the host), or than ``kernels``, is
    taken again, at most ``tries`` times, and then reported as not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from cook_tpu_torch.ops import telemetry
    def launched():   # K6 counts inside K5's launch
        return sum(v for k, v in telemetry.snapshot().items() if k != "gang")
    for _ in range(tries):
        torch.cuda.synchronize()
        entries = -launched()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        entries += launched()
        acts = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)),
                      key=lambda e: e.time_range.start)
        if sum(1 for e in acts if "Memset" not in e.name) \
                >= max(entries, kernels):
            return prof, acts
    return None, []


_CU = None
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def captured_launches(fn) -> tuple:
    """The CUDA launches of one call of ``fn``, counted exactly: the call
    is captured into a CUDA graph (nothing runs) and the graph's nodes
    are read through the driver API.  Returns (their types in capture
    order, the C entries the call made by stage kernel, from the stage
    counters)."""
    import ctypes
    from cook_tpu_torch.ops import telemetry
    global _CU
    if _CU is None:
        _CU = ctypes.CDLL("libcuda.so.1")
        _CU.cuGraphGetNodes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t)]
        _CU.cuGraphNodeGetType.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    before = telemetry.snapshot()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    torch.cuda.synchronize()
    with torch.cuda.stream(torch.cuda.Stream()):
        graph.capture_begin(capture_error_mode="relaxed")
        try:
            fn()
        finally:
            graph.capture_end()
    entries = {k: v - before.get(k, 0)
               for k, v in telemetry.snapshot().items()
               if v > before.get(k, 0)}
    g = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    rc = _CU.cuGraphGetNodes(g, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    rc = rc or _CU.cuGraphGetNodes(g, nodes, ctypes.byref(n))
    types = []
    for i in range(n.value):
        t = ctypes.c_int(-1)
        rc = rc or _CU.cuGraphNodeGetType(nodes[i], ctypes.byref(t))
        types.append(_NODE_TYPES.get(t.value, f"type {t.value}"))
    graph.reset()
    if rc:
        raise RuntimeError(f"reading a captured graph: CUDA error {rc}")
    return types, entries


def k2_launches(types, entries) -> int:
    """At most this many of a call's CUDA launches are K2's: all but
    one for each of K4's own C entries (each launches at least one)."""
    return len(types) - entries.get("admit", 0)


def device_us(event) -> float:
    us = getattr(event, "device_time_total", None)
    return getattr(event, "cuda_time_total", 0.0) if us is None else us


def library_call(wrapper, args, kw):
    """One PyTorch call computing the same function, where there is one
    (timed only; the port never calls it).  K2: ``torch.cumsum`` for the
    forward integer sums (of the bit test or the i32 input, built
    outside the timed call; the offset is not added) and for
    ``prefix16`` (another summation order: a yardstick); no single call
    computes a segmented scan or a fused launch.  The rank sort's is
    ``torch.sort(stable=True)`` of the packed int64 key K3 sorts, built
    outside the timed call; the user sort's sorts the user column."""
    from cook_tpu_torch.ops import scan as tscan
    from cook_tpu_torch.ops import sort as tsort
    x = args[0]
    if wrapper is tscan.prefix16:
        return lambda: torch.cumsum(x, dim=1)
    if wrapper is tscan.int_scan and kw.get("op", "sum") == "sum" \
            and not kw.get("reverse", False):
        bit = kw.get("bit", 0)
        v = ((x & bit) != 0).to(torch.int32) if x.dtype == torch.uint8 \
            else x
        return lambda: torch.cumsum(v, dim=1, dtype=torch.int32)
    if wrapper is tsort.sort_rank:
        key = tsort.rank_key_plain(*args)
        return lambda: torch.sort(key, dim=1, stable=True)
    if wrapper is tsort.sort_user:
        return lambda: torch.sort(x, dim=1, stable=True)
    return None


def launch_detail(wrapper, args, plans, launched, ms, lib_ms) -> dict:
    """What a call of K2 or K3 launched: K2's kind, shape and columns
    (from the plan the wrapper built) and its CUDA launches a call
    (``launched``: ``captured_launches``); K3's passes and CUDA launches
    a call."""
    types, entries = launched
    from cook_tpu_torch.ops import sort as tsort
    if wrapper.kernel in ("scan", "admit"):
        plan = plans[0]
        return {"call": wrapper.__name__, "kind": plan.kind, "S": plan.S,
                "n": plan.n, "C": plan.C, "launches_per_call": len(types),
                "k2_launches_per_call": k2_launches(types, entries),
                "launched": types, "ms": ms, "library_ms": lib_ms}
    if wrapper.kernel == "sort":
        S, n = args[0].shape
        bits = tsort.rank_bits(n) if wrapper is tsort.sort_rank \
            else n.bit_length()
        plan = tsort.sort_plan(S, n, bits)
        return {"call": wrapper.__name__, "S": S, "n": n, "passes":
                plan.passes, "launches_per_call": len(types),
                "passes_run": passes_run(wrapper, args), "ms": ms,
                "library_ms": lib_ms}
    return {}


def passes_run(wrapper, args) -> list:
    """For each series, the passes of K3 whose digit is not one value
    over the whole series (the others move nothing and are skipped)."""
    from cook_tpu_torch.ops import sort as tsort
    if wrapper is tsort.sort_rank:
        key = tsort.rank_key_plain(*args)
        bits = tsort.rank_bits(key.shape[1])
    else:
        key = args[0].to(torch.int64) + 1
        bits = key.shape[1].bit_length()
    runs = []
    for q in range(tsort.sort_plan(*key.shape, bits).passes):
        d = (key >> (8 * q)) & 255
        runs.append((d != d[:, :1]).any(dim=1))
    return torch.stack(runs, 1).sum(1).tolist()


def bound(row) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 rate, for the work this run's inputs need."""
    bytes_ms = row["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = row["ops"] / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms > bytes_ms else "bytes"


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def bytes_moved(wrapper, args, kw, got) -> int:
    """The bytes a call's function must move: each input read once, each
    output written once.  The compaction reads ``job_res`` and
    ``exc_id`` only at the rows its slots gather (each admitted slot's
    row, and the last rank-order row for the empty slots), counted here
    from this call's outputs."""
    from cook_tpu_torch.ops import admit as tad
    ins = [a for a in list(args) + list(kw.values())
           if isinstance(a, torch.Tensor)]
    total = sum(nbytes(t) for t in ins + got)
    if wrapper is tad.compact:
        order, job_res, exc_id = args[0], args[3], args[4]
        out = tad.Compacted(*got)
        last = order[:, -1:].expand_as(out.cand_row)
        rows = torch.where(out.valid_c != 0, out.cand_row, last)
        gathered = sum(int(torch.unique(r).numel()) for r in rows)
        row_bytes = (job_res.shape[2] * job_res.element_size()
                     + exc_id.element_size())
        total += gathered * row_bytes - nbytes(job_res) - nbytes(exc_id)
    return total


def replay(i, wrapper, args, kw, faults) -> tuple:
    """Launch a recorded call again and run its plain version on the same
    inputs; every output must agree bit for bit.  Appends a line per
    differing output to ``faults``; returns (kernel outputs, max abs
    err)."""
    got = tensors_of(wrapper.launch(*args, **kw))
    want = tensors_of(wrapper.plain(*args, **kw))
    torch.cuda.synchronize()
    err = 0.0
    for j, (a, b) in enumerate(zip(got, want, strict=True)):
        try:
            err = max(err, max_err(a, b))
        except AssertionError as e:
            bad = (a != b) & ~(a.isnan() & b.isnan()) \
                if a.is_floating_point() else a != b
            where = bad.nonzero()[:4].tolist() if bad.shape == a.shape \
                else []
            faults.append(f"call {i} {wrapper.__name__} output {j}: {e}; "
                          f"{int(bad.sum())} differ, first at {where}")
    return got, err


def phase_a(calls):
    """Replay one cycle's launches: kernel vs plain version, timed, each
    call's CUDA launches counted (``captured_launches``).  The fused
    K5+K6 call fills the ``gang`` row, and K5 alone on its inputs (the
    split path's instance) the ``greedy`` row."""
    from cook_tpu_torch.ops import match as tm
    rows = {k: dict(calls=0, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                    library_ms=None, bytes=0, ops=0) for k in SOURCES}
    details = {"scan": [], "admit": [], "sort": []}
    covered_ms = 0.0   # K2's time in the calls a library call covers
    faults = []
    cycle_launches = 0
    for i, (wrapper, args, kw, plans) in enumerate(calls):
        row = rows[wrapper.kernel]
        got, err = replay(i, wrapper, args, kw, faults)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if faults:
            continue
        if wrapper is tm.greedy_gang:
            cycle_launches += len(captured_launches(
                lambda: wrapper.launch(*args))[0])
            fused_row(rows, args, got, err)
            continue
        row["calls"] += 1
        ms = cuda_ms(lambda: wrapper.launch(*args, **kw), 20)
        row["ms"] += ms
        dev_ms = device_ms(lambda: wrapper.launch(*args, **kw), 20)
        if dev_ms is not None:
            row["device_ms"] = row.get("device_ms", 0.0) + dev_ms
        launched = captured_launches(lambda: wrapper.launch(*args, **kw))
        row["cuda_launches"] = row.get("cuda_launches", 0) + len(launched[0])
        cycle_launches += len(launched[0])
        row["plain_ms"] += cuda_ms(lambda: wrapper.plain(*args, **kw), 3)
        lib = library_call(wrapper, args, kw)
        lib_ms = None if lib is None else cuda_ms(lib, 20)
        if lib_ms is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + lib_ms
            if wrapper.kernel == "scan":
                covered_ms += ms
        if wrapper.kernel in details:
            details[wrapper.kernel].append(
                {**launch_detail(wrapper, args, plans, launched, ms, lib_ms),
                 "device_ms": dev_ms})
        row["bytes"] += bytes_moved(wrapper, args, kw, got)
    if faults:
        raise AssertionError("kernel != plain version:\n" + "\n".join(faults))
    for k, det in details.items():
        rows[k]["per_call"] = det
    rows["scan"]["ms_of_library_calls"] = covered_ms
    rows["cycle_cuda_launches"] = cycle_launches
    return rows


def k5_ops(args) -> int:
    """~12 f32 operations per (valid slot, host its mask admits)."""
    from cook_tpu_torch.ops.match import compose_mask
    mask = compose_mask(*args[2:7]) & (args[1] != 0)[..., None]
    return int(mask.sum()) * 12


def fused_row(rows, args, got, err):
    """The fused K5+K6 call of the cycle: the ``gang`` row times the
    fused launch (events, device, its plain version K5 then K6), the
    ``greedy`` row K5 alone (``k5_greedy``, no epilogue) on the same
    inputs; each with its CUDA launches counted.  The fused bound
    counts K5's inputs, K6's and the three outputs once."""
    from cook_tpu_torch.ops import match as tm
    k5 = args[:9]
    for name, fn, plain, n_out in (
            ("greedy", lambda: tm.greedy.launch(*k5),
             lambda: tm.greedy.plain(*k5), 1),
            ("gang", lambda: tm.greedy_gang.launch(*args),
             lambda: tm.greedy_gang.plain(*args), 3)):
        row = rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["calls"] += 1
        row["ms"] += cuda_ms(fn, 3)
        dev_ms = device_ms(fn, 3)
        if dev_ms is not None:
            row["device_ms"] = row.get("device_ms", 0.0) + dev_ms
        types = captured_launches(fn)[0]
        row["cuda_launches"] = row.get("cuda_launches", 0) + len(types)
        row["plain_ms"] += cuda_ms(plain, 1)
        ins = args if n_out == 3 else k5
        row["bytes"] += sum(nbytes(t) for t in ins) \
            + sum(nbytes(t) for t in got[:n_out])
        row["ops"] += k5_ops(args)
        P, C, _ = args[0].shape
        H, G = args[7].shape[1], args[11].shape[1]
        plan = tm.greedy_plan(P, C, H, G if n_out == 3 else 0)
        row.setdefault("per_call", []).append({
            "call": "k56_greedy_gang" if n_out == 3 else "k5_greedy",
            "P": P, "C": C, "H": H, "G": G if n_out == 3 else 0,
            "cluster": plan.cluster, "threads": plan.threads,
            "hosts_per_cta": plan.hosts_per_cta, "in_smem": plan.in_smem,
            "gang_counts_in_smem": plan.gang_in_smem,
            "launched": types, "ms": row["ms"], "device_ms": dev_ms,
            "us_per_step": row["ms"] * 1e3 / C})


def k1_k56_lines(rows) -> list:
    """K1 (2 CUDA launches a call), K5+K6 (1) and the cycle (at most
    40) as phase A counted them from captured graphs."""
    k1 = rows["expand"]
    fused, k5 = rows["gang"], rows["greedy"]
    if k1["cuda_launches"] != 2 * k1["calls"] or fused["cuda_launches"] != 1 \
            or rows["cycle_cuda_launches"] > 40:
        raise AssertionError(
            f"CUDA launches: K1 {k1['cuda_launches']} in {k1['calls']} "
            f"calls, K5+K6 {fused['cuda_launches']}, a cycle "
            f"{rows['cycle_cuda_launches']}")
    out = []
    for name, row, extra in (
            ("K1", k1, {}),
            ("K5+K6", fused, {"k5_alone_ms": k5["ms"],
                              "k5_alone_device_ms": k5.get("device_ms")})):
        b_ms, b_by = bound(row)
        out.append({"phase": "A", "kernel": name, "ms": row["ms"],
                    "device_ms": row.get("device_ms"), "bound_ms": b_ms,
                    "bound_by": b_by,
                    "cuda_launches_per_call": row["cuda_launches"]
                    // row["calls"], **extra})
    out.append({"phase": "A", "cycle_cuda_launches":
                rows["cycle_cuda_launches"]})
    return out


def k2_k4_line(rows) -> dict:
    """K2 and K4 together at the design point: one cycle's calls, their
    CUDA launches as phase A counted them (at most 2 a K2 call, 30 a
    cycle) and time."""
    calls = rows["scan"]["per_call"] + rows["admit"]["per_call"]
    launches = sum(d["launches_per_call"] for d in calls)
    worst = max(d["k2_launches_per_call"] for d in calls)
    if worst > 2 or launches > 30:
        raise AssertionError(f"K2: {worst} CUDA launches in a call, "
                             f"{launches} with K4 a cycle")
    both = {k: rows["scan"][k] + rows["admit"][k]
            for k in ("calls", "ms", "plain_ms", "bytes", "ops")}
    both["device_ms"] = (rows["scan"].get("device_ms", 0.0)
                         + rows["admit"].get("device_ms", 0.0)) or None
    b_ms, b_by = bound(both)
    return {"phase": "A", "kernel": "K2+K4", **both,
            "cuda_launches_per_cycle": launches,
            "max_k2_launches_per_call": worst, "bound_ms": b_ms,
            "bound_by": b_by}


# CUDA kernel names by stage kernel, for the profiler's breakdown
KERNEL_NAMES = (("scan", ("seg_tile", "blk_tile", "int_tile")),
                ("sort", ("radix_",)), ("admit", ("compact_slots",)),
                ("greedy+gang", ("greedy",)), ("expand", ("expand_",)),
                ("memset", ("memset", "Memset")))


def profile_cycles(wire, args, cycles=3) -> dict:
    """Device time a cycle by stage kernel, from torch.profiler's CUDA
    activity over ``cycles`` cycles on one staged wire, beside the CUDA
    events' span around them (the profiler slows the host, so the idle
    share is taken against the unprofiled cycles' span).
    Then the host's time by function over as many cycles (cProfile's own
    time a cycle, the 15 largest; the profiler slows the host, so these
    are shares, not the cycle's enqueue time)."""
    from cook_tpu_torch.ops.pallas_cycle import megacycle
    megacycle(wire, **args)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)

    def run():
        ev0.record()
        for _ in range(cycles):
            megacycle(wire, **args)
        ev1.record()
    prof, _ = profiled(run, 1)
    span = ev0.elapsed_time(ev1) / cycles
    host = cProfile.Profile()
    host.enable()
    for _ in range(cycles):
        megacycle(wire, **args)
    host.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(host).stats
    allocs = {fn[len("<built-in method "):-1]: nc / cycles
              for (f, _, fn), (_, nc, _, _, _) in stats.items()
              if f == "~" and fn.startswith("<built-in method torch.")
              and any(fn.endswith(k + ">") for k in (
                  "empty", "empty_like", "zeros", "zeros_like", "full",
                  "full_like", "ones", "ones_like", "empty_strided"))}
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:15]
    host_ms = {f"{Path(f).name}:{line}({fn})": tt * 1e3 / cycles
               for (f, line, fn), (_, _, tt, _, _) in top}
    by_name, by_stage = {}, {}
    for e in (prof.key_averages() if prof else []):
        us = device_us(e)
        if us <= 0:
            continue
        ms = us / 1e3 / cycles
        by_name[e.key[:80]] = ms
        stage = next((k for k, pats in KERNEL_NAMES
                      if any(p in e.key for p in pats)), "other")
        by_stage[stage] = by_stage.get(stage, 0.0) + ms
    busy = sum(by_name.values())
    return {"phase": "B", "profiled_cycles": cycles,
            "device_ms_by_stage": by_stage or "not measured",
            "device_ms_by_kernel": by_name or "not measured",
            "busy_ms": busy if by_name else "not measured",
            "profiled_span_ms": span,
            "host_tottime_ms_by_function_profiled": host_ms,
            "torch_empty_calls_per_cycle": allocs.get("torch.empty", 0.0),
            "allocating_calls_per_cycle": allocs,
            "busy": busy if by_name else None}


# small worlds for the kernel paths the design point does not take
SMALL_WORLDS = (
    # i8 rows; u16 avail and capacity
    dict(size=dict(live=30, users=6, hosts=50, gangs=2, e=4),
         quantize=True, modes={}),
    # i16 rows; the over-quota limit binds
    dict(size=dict(live=3000, users=40, hosts=300, gangs=4, e=16),
         quantize=True, modes=dict(max_over_quota_jobs=3)),
    # wide wire; gpu-mode DRU; H = 16,384: K5 on a cluster of 8, 2,048
    # hosts a CTA
    dict(size=dict(live=2000, users=30, hosts=12000, gangs=4, e=16),
         quantize=False, modes=dict(gpu_mode=True)),
)


def phase_c():
    """Two cycles of each small world: kernels vs the plain cycle."""
    from cook_tpu_torch.ops.pallas_cycle import megacycle, megacycle_plain
    for i, spec in enumerate(SMALL_WORLDS):
        w = build_world(np.random.default_rng(SEED + 1 + i), **spec["size"])
        res_dev = torch.from_numpy(w.res).cuda()
        disk_dev = torch.from_numpy(w.disk).cuda()
        scales, seen, placed = {}, [], []
        for _ in range(2):
            staged = stage(w, res_dev, disk_dev, scales,
                           quantize=spec["quantize"])
            args = megacycle_args(staged, **spec["modes"])
            res = megacycle(staged["wire"], **args)
            ref = megacycle_plain(staged["wire"], **args)
            for name in res._fields:
                max_err(getattr(res, name), getattr(ref, name))
            seen.append([staged["rows_codec"], str(staged["avail_scale"]),
                         str(staged["cap_scale"])])
            placed.append(apply(w, res))
        print(json.dumps({"phase": "C", "world": i, "T": w.T, "H": w.H,
                          "modes": spec["modes"], "codecs": seen,
                          "placed": placed}))


# ------------------------------- phase B: the resident wire, and churn
CHURN = 1_000          # rows that finish, and jobs that arrive, a pool
CHURN_CYCLES = 3
RESIDENT_KEY = ("design", P)
# the parts of staging, by the function that does each (cProfile)
STAGE_PARTS = {
    "rows negotiation": ("fused.py", "negotiate_rows"),
    "avail/cap quantization": ("fused.py", "quantize_hosts"),
    "bit packing": ("fused.py", "pack_host_bits"),
    "gang padding": ("fused.py", "pad_gangs"),
    "uploads (wire_from_numpy)": ("pallas_cycle.py", "wire_from_numpy"),
    "stage_mega_wire": ("fused.py", "stage_mega_wire"),
    "sync_resident": ("fused.py", "sync_resident"),
    "pack_diff": ("delta.py", "pack_diff"),
    "delta stage": ("delta.py", "stage"),
    "delta commit": ("delta.py", "commit"),
    "full upload (resident_buffer)": ("delta.py", "resident_buffer"),
    "synchronize": ("__init__.py", "synchronize"),
}


def snapshot(w) -> dict:
    """What a cycle's apply changes in the world."""
    return {"flags": w.flags.copy(), "avail": w.avail.copy()}


def outputs_of(res) -> dict:
    return {name: getattr(res, name).clone() for name in res._fields}


def same_outputs(res, want: dict, what: str) -> None:
    for name in res._fields:
        try:
            max_err(getattr(res, name), want[name])
        except AssertionError as e:
            raise AssertionError(f"{what}: {name}: {e}") from None


def resident_stage(w, packs, applier, res_dev, disk_dev, scales,
                   timed=True):
    """One cycle's resident staging: copies of the host arrays (the pack
    a driver builds afresh every cycle; outside the timing, as the
    rebuild mode's pack is), then ``sync_resident`` and
    ``stage_mega_wire(resident=True)``.  Returns (staged, sync,
    stage_ms host clock to the synchronize, sync_device_ms).  The sync's
    device work is timed again afterwards with CUDA events around it
    alone, so that no other host work falls between them: the scatter,
    committed once more (it writes the same values), or the full
    upload's two copies, made once more."""
    from cook_tpu_torch.ops.delta import pack_diff, resident_buffer
    from cook_tpu_torch.sched.fused import sync_resident
    rows, flags = w.rows.copy(), w.flags.copy()
    prev = packs.get(False)
    prev = None if prev is None else (prev.rows_host, prev.flags_host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync = sync_resident(packs, False, RESIDENT_KEY + (w.T,), rows, flags,
                         0, applier=applier)
    staged = stage(w, res_dev, disk_dev, scales, rows=rows, flags=flags,
                   rows_dev=sync.rows_dev, flags_dev=sync.flags_dev,
                   resident=True)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    if not timed or sync.reason == "empty":
        return staged, sync, stage_ms, None
    pack = packs[False]
    if sync.reason == "delta":
        idx = pack_diff(prev[0], rows, prev[1], flags)
        st = applier.stage(rows.shape, idx, rows.reshape(-1)[idx],
                           flags.reshape(-1)[idx], quantize=True)
        work = lambda: applier.commit(pack.rows_buf, pack.flags_buf, st)
    else:
        def work():
            resident_buffer(rows, pack.rows_buf.device, out=pack.rows_buf)
            resident_buffer(flags, pack.rows_buf.device, out=pack.flags_buf)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    work()
    ev1.record()
    torch.cuda.synchronize()
    return staged, sync, stage_ms, ev0.elapsed_time(ev1)


def rebuild_stage(w, res_dev, disk_dev, scales):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = stage(w, res_dev, disk_dev, scales)
    torch.cuda.synchronize()
    return staged, (time.perf_counter() - t0) * 1e3


def timed_cycle(staged):
    from cook_tpu_torch.ops.pallas_cycle import megacycle
    t0 = time.perf_counter()
    res = megacycle(staged["wire"], **megacycle_args(staged))
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def cycle_line(seq, mode, cyc, staged, stage_ms, cycle_ms, n, sync=None,
               sync_ms=None) -> dict:
    line = {"phase": "B", "sequence": seq, "mode": mode, "cycle": cyc,
            "stage_ms": stage_ms, "cycle_ms": cycle_ms, "placed": n,
            "staging_h2d_bytes": staged["h2d_bytes"],
            "rows_codec": staged["rows_codec"]}
    if sync is None:
        line.update(h2d_bytes=staged["h2d_bytes"], path="rebuild")
    else:
        line.update(h2d_bytes=staged["h2d_bytes"] + sync.h2d_bytes,
                    sync_h2d_bytes=sync.h2d_bytes, delta_k=sync.k,
                    path=("scatter" if sync.reason == "delta" else
                          "untouched" if sync.reason == "empty" else
                          f"repack ({sync.reason})"),
                    sync_device_ms=sync_ms)
    return line


def phase_b_resident(w, snap, scales0, rebuild_outs, rebuild_placed):
    """The rebuild pass's cycles again, from the same world, through the
    resident wire: a cold cycle, then deltas.  Every cycle's outputs
    must equal the rebuild pass's on the same host arrays and the plain
    cycle's on the resident wire.  Counted on its own."""
    from cook_tpu_torch.ops import telemetry
    from cook_tpu_torch.ops.delta import DeviceBaseMirror, PackDeltaApplier
    from cook_tpu_torch.ops.pallas_cycle import megacycle_plain
    w.flags[...] = snap["flags"]
    w.avail[...] = snap["avail"]
    scales = dict(scales0)
    mirror, applier, packs = DeviceBaseMirror(), PackDeltaApplier(), {}
    lines = []
    telemetry.reset_all()
    for cyc in range(CYCLES):
        res_dev, disk_dev = mirror.sync(w.res, w.disk, 0)
        staged, sync, stage_ms, sync_ms = resident_stage(
            w, packs, applier, res_dev, disk_dev, scales)
        res, cycle_ms = timed_cycle(staged)
        same_outputs(res, rebuild_outs[cyc], f"resident cycle {cyc} vs "
                     f"rebuild")
        ref = megacycle_plain(staged["wire"], **megacycle_args(staged))
        same_outputs(res, outputs_of(ref), f"resident cycle {cyc} vs plain")
        n = apply(w, res)
        if n != rebuild_placed[cyc]:
            raise AssertionError(f"resident cycle {cyc} placed {n}")
        lines.append(cycle_line("placement", "resident", cyc, staged,
                                stage_ms, cycle_ms, n, sync, sync_ms))
        print(json.dumps(lines[-1]))
    counts, events = telemetry.snapshot(), telemetry.events()
    missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"resident cycles did not launch {missing}")
    return counts, events, lines, (mirror, applier, packs, scales)


def churn(w, rng) -> None:
    """``CHURN`` running rows of each pool finish and leave, and as many
    pending jobs arrive across its users (the world's Zipf weights), each
    at the end of its user's rows, as ``build_world`` lays them out; their
    base rows are appended to the base table.  The exception rows and the
    gang members keep their base rows (they never finish) and move with
    them."""
    from cook_tpu_torch.ops.delta import (FLAG_ENQUEUE_OK, FLAG_LAUNCH_OK,
                                          FLAG_PENDING, FLAG_USER_FIRST,
                                          FLAG_VALID)
    from cook_tpu_torch.ops.gang import build_gang_wire
    n = CHURN
    keep_ids = set(int(x) for x in w.exc_ids.ravel())
    keep_ids.update(int(x) for ids in w.gang_ids.values() for x in ids)
    live = w.live
    for p in range(P):
        ids, user = w.rows[p, :live], w.task_user[p, :live]
        fl = w.flags[p, :live]
        running = np.flatnonzero(
            ((fl & FLAG_PENDING) == 0)
            & ~np.isin(ids, np.fromiter(keep_ids, np.int32)))
        gone = rng.choice(running, n, replace=False)
        kept = np.ones(live, bool)
        kept[gone] = False
        N = w.res.shape[0]
        new_res = np.zeros((n, 4), np.float32)
        new_res[:, 0] = np.round(rng.uniform(0.1, 4.0, n), 1)
        new_res[:, 1] = rng.integers(128, 8192, n)
        new_res[:, 2] = rng.random(n) < 0.05
        new_res[:, 3] = 1.0
        w.res = np.concatenate([w.res, new_res])
        w.disk = np.concatenate(
            [w.disk, rng.integers(0, 2048, n).astype(np.float32)])
        new_user = rng.choice(len(w.weights), n, p=w.weights)
        new_fl = (FLAG_PENDING + FLAG_VALID
                  + (rng.random(n) < 0.99) * FLAG_ENQUEUE_OK
                  + (rng.random(n) < 0.98) * FLAG_LAUNCH_OK).astype(np.uint8)
        u = np.concatenate([user[kept], new_user])
        order = np.argsort(u, kind="stable")
        u = u[order]
        ids = np.concatenate([ids[kept], np.arange(N, N + n)])[order]
        fl = np.concatenate([fl[kept] & ~np.uint8(FLAG_USER_FIRST),
                             new_fl])[order]
        first = np.ones(live, bool)
        first[1:] = u[1:] != u[:-1]
        w.rows[p, :live] = ids
        w.task_user[p, :live] = u
        w.flags[p, :live] = fl | (first * FLAG_USER_FIRST).astype(np.uint8)
    pos = [dict(zip(w.rows[p, :live].tolist(), range(live)))
           for p in range(P)]
    w.exc_rows = np.array([[pos[p][int(x)] for x in w.exc_ids[p]]
                           for p in range(P)], np.int32)
    by_gang = {g: [(pos[0][int(x)], None) for x in ids]
               for g, ids in w.gang_ids.items()}
    w.gangs[0] = build_gang_wire(w.T, by_gang, w.gang_groups, w.gang_offers)


def phase_b_churn(w, state, rng):
    """``CHURN_CYCLES`` cycles of churn, each staged both ways from the
    same host arrays (the order of the two modes alternates); kernels on
    both wires and the plain cycle on the resident wire must agree.
    The rebuild pass's placements are applied."""
    from cook_tpu_torch.ops import telemetry
    from cook_tpu_torch.ops.pallas_cycle import megacycle_plain
    mirror, applier, packs, scales = state
    lines = []
    telemetry.reset_all()
    for cyc in range(CHURN_CYCLES):
        churn(w, rng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res_dev, disk_dev = mirror.sync(w.res, w.disk, 0)
        torch.cuda.synchronize()
        mirror_ms = (time.perf_counter() - t0) * 1e3
        for mode in (("rebuild", "resident") if cyc % 2 == 0
                     else ("resident", "rebuild")):
            if mode == "rebuild":
                sb, b_stage_ms = rebuild_stage(w, res_dev, disk_dev, scales)
                rb, b_cycle_ms = timed_cycle(sb)
            else:
                sr, sync, r_stage_ms, sync_ms = resident_stage(
                    w, packs, applier, res_dev, disk_dev, scales)
                rr, r_cycle_ms = timed_cycle(sr)
        same_outputs(rr, outputs_of(rb), f"churn cycle {cyc}: resident vs "
                     f"rebuild")
        ref = megacycle_plain(sr["wire"], **megacycle_args(sr))
        same_outputs(rr, outputs_of(ref), f"churn cycle {cyc} vs plain")
        n = apply(w, rb)
        for line in (cycle_line("churn", "rebuild", cyc, sb, b_stage_ms,
                                b_cycle_ms, n),
                     cycle_line("churn", "resident", cyc, sr, r_stage_ms,
                                r_cycle_ms, n, sync, sync_ms)):
            line.update(mirror_ms=mirror_ms, mirror_sync=mirror.last_sync)
            lines.append(line)
            print(json.dumps(line))
    counts, events = telemetry.snapshot(), telemetry.events()
    missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"churn cycles did not launch {missing}")
    return counts, events, lines


def staging_profile(w, state, rng, reps=3) -> dict:
    """Host time of staging by part, for both modes (cProfile's
    cumulative time a cycle), over ``reps`` cycles of each kind:
    "placement", where 1,000 pending rows a pool start running before
    each cycle, as a placement cycle changes them (the resident mode's
    scatter path), and "churn" (``churn``: its repack path)."""
    from cook_tpu_torch.ops.delta import FLAG_PENDING
    mirror, applier, packs, scales = state
    out = {}
    for kind in ("placement", "churn"):
        for mode in ("rebuild", "resident"):
            prof = cProfile.Profile()
            paths = []
            for _ in range(reps):
                if kind == "churn":
                    churn(w, rng)
                for p in range(P):
                    pend = np.flatnonzero(w.flags[p] & FLAG_PENDING)
                    hit = rng.choice(pend, min(1_000, pend.size),
                                     replace=False)
                    w.flags[p, hit] &= ~np.uint8(FLAG_PENDING)
                res_dev, disk_dev = mirror.sync(w.res, w.disk, 0)
                torch.cuda.synchronize()
                prof.enable()
                if mode == "rebuild":
                    rebuild_stage(w, res_dev, disk_dev, scales)
                else:
                    paths.append(resident_stage(
                        w, packs, applier, res_dev, disk_dev, scales,
                        timed=False)[1].reason)
                prof.disable()
            stats = pstats.Stats(prof).stats
            parts = {}
            for part, (fname, fn) in STAGE_PARTS.items():
                ct = sum(v[3] for (f, _, name), v in stats.items()
                         if name == fn and f.endswith(fname))
                if ct:
                    parts[part] = ct * 1e3 / reps
            out[f"{kind}/{mode}"] = {"ms_per_cycle_profiled": parts,
                                     "paths": paths}
    return {"phase": "B", "staging_profile": out, "reps": reps,
            "note": "cumulative times under cProfile, which slows the "
                    "host: shares, not the unprofiled stage_ms"}


# ------------------------------------------- base mirror: sync checks
MIRROR_STEPS = (
    # (rows, compaction epoch, expected sync)
    (300_000, 0, "full"), (303_000, 0, "append"), (303_000, 0, None),
    (307_500, 0, "append"), (450_000, 0, "full"),   # the chunk overflows
    (400_000, 1, "full"), (401_000, 1, "append"),
    (600_000, 1, "full"))                            # past the capacity


def phase_mirror(rng) -> dict:
    """``DeviceBaseMirror.sync`` through cold, append, a no-op, overflow,
    compaction and growth; each sync's device arrays against numpy."""
    from cook_tpu_torch.ops.delta import DeviceBaseMirror
    n_max = max(n for n, _, _ in MIRROR_STEPS)
    res = rng.uniform(0.1, 9000.0, (n_max, 4)).astype(np.float32)
    disk = rng.uniform(0.0, 2048.0, n_max).astype(np.float32)
    m = DeviceBaseMirror()
    steps = []
    for n, epoch, want in MIRROR_STEPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, d = m.sync(res[:n], disk[:n], epoch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if m.last_sync != want:
            raise AssertionError(f"mirror at {n} rows, epoch {epoch}: "
                                 f"{m.last_sync}, want {want}")
        rh, dh = r.cpu().numpy(), d.cpu().numpy()
        if rh.shape != (m.capacity, 4) or not (
                np.array_equal(rh[:n], res[:n]) and not rh[n:].any()
                and np.array_equal(dh[:n], disk[:n]) and not dh[n:].any()):
            raise AssertionError(f"mirror at {n} rows differs from numpy")
        steps.append({"rows": n, "epoch": epoch, "sync": m.last_sync,
                      "capacity": m.capacity, "ms": ms})
    return {"phase": "M", "mirror_steps": steps, "equal_to_numpy": True}


# ------------------------------------------------- phase R: split rank
def rank_world(w, p, res_dev):
    """Pool ``p``'s compact rank inputs on the card: its rows and flags,
    the base table, the per-user tables padded to a bucket of 256 users
    with +inf (as the fused staging pads them)."""
    from cook_tpu_torch.ops import dru
    from cook_tpu_torch.ops.padding import bucket
    U = bucket(w.shares.shape[1], minimum=8)
    shares = np.full((U, 3), np.inf, np.float32)
    quota = np.full((U, 4), np.inf, np.float32)
    shares[:w.shares.shape[1]] = w.shares[p]
    quota[:w.quota.shape[1]] = w.quota[p]
    return dru.CompactRankInputs(
        rows=torch.from_numpy(w.rows[p]).cuda(),
        flags=torch.from_numpy(w.flags[p]).cuda(), res_base=res_dev,
        shares_u=torch.from_numpy(shares).cuda(),
        quota_u=torch.from_numpy(quota).cuda())


def quota_queues(w, p, order, num_ranked, usage):
    """The masks' inputs over pool ``p``'s ranked queue: the pool mask's
    (job usage in rank order, the pool's running usage and quota, the
    ranked prefix valid) and the user mask's (the ranked jobs regrouped
    user-contiguous, stable in rank order, each user's running usage and
    quota; padding rows carry the last user)."""
    from cook_tpu_torch.ops.delta import FLAG_PENDING, FLAG_VALID
    T = w.T
    order = order.cpu().numpy()
    k = int(num_ranked)
    u_all = w.task_user[p]
    fl = w.flags[p]
    usage_h = usage.cpu().numpy()
    job_usage = usage_h[order]
    valid = np.arange(T) < k
    pool = (job_usage, w.run_total[p], w.scalars["pool_quota"][p], valid)
    users = u_all[order[:k]]
    by_user = order[:k][np.argsort(users, kind="stable")]
    ju = np.zeros((T, 4), np.float32)
    ju[:k] = usage_h[by_user]
    uid = np.zeros(T, np.int32)
    uid[:k] = u_all[by_user]
    uid[k:] = uid[k - 1] if k else 0
    first = np.ones(T, bool)
    first[1:] = uid[1:] != uid[:-1]
    first_idx = np.maximum.accumulate(
        np.where(first, np.arange(T), 0)).astype(np.int32)
    running = ((fl & FLAG_VALID) != 0) & ((fl & FLAG_PENDING) == 0)
    base_u = np.zeros((w.shares.shape[1], 4), np.float32)
    np.add.at(base_u, u_all[running], usage_h[running])
    user = (ju, uid, first_idx, base_u, w.quota[p][uid], valid)
    to = lambda xs: tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda()
                          for x in xs)
    return to(pool), to(user)


def phase_r(w) -> tuple:
    """The split ranker on each design-world pool, counted: through K2
    and K3 (recorded, each launch replayed against its plain version),
    held bit for bit against the plain versions on the card, timed."""
    from cook_tpu_torch.ops import cuda_lib, dru, telemetry
    res_dev = torch.from_numpy(w.res).cuda()
    inputs = [rank_world(w, p, res_dev) for p in range(P)]
    expanded = [dru.expand_compact_rank(c) for c in inputs]
    telemetry.reset_all()
    got = []
    with cuda_lib.recording() as calls:
        for c, e in zip(inputs, expanded):
            rc = dru.rank_kernel_compact(c)
            rk = dru.rank_kernel(e)
            got.append((rc, rk))
    torch.cuda.synchronize()
    queues = [quota_queues(w, p, got[p][0].order, got[p][0].num_ranked,
                           expanded[p].usage) for p in range(P)]
    with cuda_lib.recording() as mask_calls:
        masks = [(dru.pool_quota_mask(*pq), dru.user_quota_mask(*uq))
                 for pq, uq in queues]
    torch.cuda.synchronize()
    counts = telemetry.snapshot()
    for k in ("scan", "sort"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"the split ranker did not launch {k}")
    # the plain versions on the card
    per_pool = []
    for p in range(P):
        e = expanded[p]
        order, num, dru_v, keep, _ = dru.rank_body(*e, False, 100)
        want = dru.RankResult(order=order,
                              dru=torch.where(keep, dru_v, float("inf")),
                              keep=keep, num_ranked=num)
        for r in got[p]:
            for name in want._fields:
                max_err(getattr(r, name), getattr(want, name))
        pq, uq = queues[p]
        max_err(masks[p][0], dru.pool_quota_mask_plain(*pq))
        max_err(masks[p][1], dru.user_quota_mask_plain(*uq))
        c = inputs[p]
        per_pool.append({
            "pool": p, "num_ranked": int(num),
            "pool_quota_kept": int(masks[p][0].sum()),
            "user_quota_kept": int(masks[p][1].sum()),
            "rank_kernel_compact_ms": cuda_ms(
                lambda: dru.rank_kernel_compact(c), 10),
            "rank_kernel_compact_device_ms": device_ms(
                lambda: dru.rank_kernel_compact(c), 10),
            "rank_kernel_ms": cuda_ms(lambda: dru.rank_kernel(e), 10),
            "pool_quota_mask_ms": cuda_ms(
                lambda: dru.pool_quota_mask(*pq), 10),
            "user_quota_mask_ms": cuda_ms(
                lambda: dru.user_quota_mask(*uq), 10),
            "plain_rank_ms": cuda_ms(lambda: dru.rank_body(
                *dru.expand_compact_rank(c), False, 100), 3),
            "plain_pool_quota_mask_ms": cuda_ms(
                lambda: dru.pool_quota_mask_plain(*pq), 3),
            "plain_user_quota_mask_ms": cuda_ms(
                lambda: dru.user_quota_mask_plain(*uq), 3)})
    held = replay_all(calls + mask_calls, "split ranker")
    print(json.dumps({"phase": "R", "T": w.T, "U_bucket": 256,
                      "launches_per_kernel": {k: counts[k] for k in
                                              ("scan", "sort")},
                      "replayed_equal_to_plain": held,
                      "pools": per_pool}))
    return counts


def replay_all(calls, what: str) -> dict:
    """Replay recorded launches against their plain versions; returns
    the count held by wrapper and shape."""
    faults, held = [], {}
    for i, (wrapper, wargs, kw, _) in enumerate(calls):
        replay(i, wrapper, wargs, kw, faults)
        key = f"{wrapper.__name__} {list(wargs[0].shape)}"
        held[key] = held.get(key, 0) + 1
    if faults:
        raise AssertionError(f"{what}: kernel != plain version:\n"
                             + "\n".join(faults))
    return held


def replay_stacked(calls, what: str) -> dict:
    """Replay recorded launches of wrappers whose every argument leads
    with the pool axis (K5's ``greedy``), whose pools are independent:
    each call's kernel again, then one plain call a shape on the calls
    stacked along that axis; each call's rows of the plain outputs must
    equal its kernel's bit for bit.  Returns the count held by wrapper
    and shape."""
    groups = {}
    for i, (wrapper, wargs, kw, _) in enumerate(calls):
        if kw:
            raise ValueError(f"{what}: a stacked replay takes no keyword "
                             f"arguments ({wrapper.__name__})")
        key = (wrapper, tuple((tuple(a.shape[1:]), a.dtype)
                              for a in wargs))
        groups.setdefault(key, []).append((i, wargs))
    faults, held = [], {}
    for (wrapper, _), members in groups.items():
        got = [tensors_of(wrapper.launch(*wargs)) for _, wargs in members]
        stacked = [torch.cat([wargs[k] for _, wargs in members])
                   for k in range(len(members[0][1]))]
        sizes = [wargs[0].shape[0] for _, wargs in members]
        want = [t.split(sizes) for t in tensors_of(wrapper.plain(*stacked))]
        torch.cuda.synchronize()
        for m, (i, _) in enumerate(members):
            for j, a in enumerate(got[m]):
                try:
                    max_err(a, want[j][m])
                except AssertionError as e:
                    faults.append(f"call {i} {wrapper.__name__} output "
                                  f"{j}: {e}")
        key = f"{wrapper.__name__} {list(members[0][1][0].shape)}"
        held[key] = held.get(key, 0) + len(members)
    if faults:
        raise AssertionError(f"{what}: kernel != plain version:\n"
                             + "\n".join(faults))
    return held


# ------------------------------------------------- phase P: preemption
PREEMPT_TASKS, PREEMPT_HOSTS, PREEMPT_DEMANDS = 100_000, 5_000, 64


def preempt_world(rng, spare=True, nan_eligible=0):
    """100,000 running tasks on 5,000 hosts, R = 4, sorted by (host,
    -dru) and padded to 131,072 as the rebalancer pads them (host 0,
    segment start, ineligible); 10% of the tasks ineligible, 10% of the
    hosts failing the job's constraints; 0.5% +inf DRUs (eligible) and
    0.5% NaN DRUs, ineligible as the rebalancer's DRU filters leave them
    (a NaN fails their ``>`` tests) but for ``nan_eligible`` of them;
    spare per host, or none at all."""
    from cook_tpu_torch.ops.padding import bucket, pad_to
    from cook_tpu_torch.ops.rebalance import RebalanceInputs
    n, H = PREEMPT_TASKS, PREEMPT_HOSTS
    host = rng.integers(0, H, n).astype(np.int32)
    dru = (rng.random(n) * 4).astype(np.float32)
    special = rng.random(n)
    nan = special < 0.005
    dru[nan] = np.nan
    dru[(special >= 0.005) & (special < 0.01)] = np.inf
    res = np.zeros((n, 4), np.float32)
    res[:, 0] = np.round(rng.uniform(0.1, 4.0, n), 1)
    res[:, 1] = rng.integers(128, 8192, n)
    res[:, 2] = rng.random(n) < 0.05
    eligible = (rng.random(n) >= 0.1) & ~nan
    eligible[np.flatnonzero(nan)[:nan_eligible]] = True
    order = np.lexsort((-dru, host))
    dru, res, host, eligible = dru[order], res[order], host[order], \
        eligible[order]
    start = np.ones(n, bool)
    start[1:] = host[1:] != host[:-1]
    spare_h = np.zeros((H, 4), np.float32)
    if spare:
        spare_h[:, 0] = np.floor(rng.uniform(0, 6, H) * 2) / 2
        spare_h[:, 1] = rng.integers(0, 16384, H)
        spare_h[:, 2] = rng.random(H) < 0.1
    host_ok = rng.random(H) >= 0.1
    T = bucket(n)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    return RebalanceInputs(
        task_dru=to(pad_to(dru, T)), task_res=to(pad_to(res, T)),
        task_host=to(pad_to(host, T)),
        host_start=to(pad_to(start, T, fill=True)),
        eligible=to(pad_to(eligible, T, fill=False)), spare=to(spare_h),
        host_ok=to(host_ok), demand=to(np.zeros(4, np.float32)))


def demands(rng) -> np.ndarray:
    """Pending jobs' demands: 1 to 16 cpus, 1 to 64 GiB, a gpu in 10%."""
    k = PREEMPT_DEMANDS
    d = np.zeros((k, 4), np.float32)
    d[:, 0] = np.floor(rng.uniform(1, 16, k) * 2) / 2
    d[:, 1] = rng.integers(1024, 65536, k)
    d[:, 2] = rng.random(k) < 0.1
    return d


def phase_p(rng) -> dict:
    """The preemption search for 64 demands (``max_preemption``'s
    default) on the main world, on one with no spare anywhere (every
    decision preempts) and on that one with eight eligible NaN DRUs, one
    call a demand, counted and recorded; every decision held bit for bit
    against the plain version on the card; each recorded K2 launch
    replayed; calls timed."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.ops import rebalance as reb
    worlds = {"spare": preempt_world(rng),
              "no_spare": preempt_world(rng, spare=False),
              # eight eligible NaN DRUs: where one is feasible its NaN
              # score wins, and NaN > -inf is false: no decision
              "no_spare_nan": preempt_world(rng, spare=False,
                                            nan_eligible=8)}
    dem = torch.from_numpy(demands(rng)).cuda()
    telemetry.reset_all()
    got = {}
    torch.cuda.synchronize()
    with cuda_lib.recording() as calls:
        for name, inp in worlds.items():
            t0 = time.perf_counter()
            got[name] = [reb.preemption_kernel(inp._replace(demand=d))
                         for d in dem]
            torch.cuda.synchronize()
            got[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    counts = telemetry.snapshot()
    if counts.get("scan", 0) != len(worlds) * PREEMPT_DEMANDS:
        raise AssertionError(f"preemption: {counts.get('scan')} K2 launches "
                             f"for {len(worlds) * PREEMPT_DEMANDS} calls")
    out = {"phase": "P", "tasks": PREEMPT_TASKS, "T": 131_072,
           "hosts": PREEMPT_HOSTS, "R": 4, "demands": PREEMPT_DEMANDS,
           "launches_per_kernel": {"scan": counts["scan"]}}
    for name, inp in worlds.items():
        found = spare_only = victims = 0
        for d, r in zip(dem, got[name]):
            want = reb.preemption_plain(inp._replace(demand=d))
            for f in want._fields:
                max_err(getattr(r, f), getattr(want, f))
            found += int(r.found)
            spare_only += int(r.spare_only)
            if bool(r.found) and not bool(r.spare_only):
                victims += int(r.victim_mask.sum())
        if name != "spare" and spare_only:
            raise AssertionError("a spare-only decision with no spare")
        one = inp._replace(demand=dem[0])
        out[name] = {
            "found": found, "spare_only": spare_only, "victims": victims,
            "wall_ms_all_calls": got[name + "_ms"],
            "ms": cuda_ms(lambda: reb.preemption_kernel(one), 20),
            "device_ms": device_ms(lambda: reb.preemption_kernel(one), 20),
            "plain_ms": cuda_ms(lambda: reb.preemption_plain(one), 5)}
    out["replayed_equal_to_plain"] = replay_all(calls, "preemption")
    print(json.dumps(out))
    return counts


# ---------------------------------------------------- phase D: top-K kernels
TOPK = {
    "topk_structured": dict(
        replaces="cook_tpu/ops/pallas_match.py:162",
        stage="top-K host preferences, structured mask (host vectors + "
              "exception rows staged in shared memory), one thread per "
              "job, host terms once a tile, a two-FMA pre-filter"),
    "topk_dense": dict(
        replaces="cook_tpu/ops/pallas_match.py:116",
        stage="top-K host preferences, dense u8 mask staged by cp.async "
              "(double-buffered), one thread per job, host terms once a "
              "tile, a two-FMA pre-filter"),
}
TOPK_K = 16
# f32 operations (an FMA counts two, as the peak rate does) the top-K
# function needs: for each (job, host) pair whose mask is set, a test
# that it cannot beat the job's K-th entry (the pre-filter's two FMAs
# and a compare); for each pair that enters the job's list, the exact
# fitness: four compares of the resource fit, two adds (u + n), two
# quotients from the stored reciprocal (a multiply and two FMAs each),
# two adds and a multiply, and the compare of the insertion
TOPK_PAIR_OPS = 5
TOPK_EXACT_OPS = 4 + 2 + 2 * 5 + 3 + 1


def structured_world(J=100_000, H=50_000, E=256):
    """bench.py's bench_pallas_scale recipe, from default_rng(6)."""
    rng = np.random.default_rng(6)
    job_res = np.stack([rng.integers(1, 8, J), rng.integers(64, 2048, J),
                        np.zeros(J), np.zeros(J)], axis=1).astype(np.float32)
    exc_id = np.full(J, -1, np.int32)
    exc_id[rng.choice(J, size=E, replace=False)] = np.arange(E, dtype=np.int32)
    cap = np.stack([rng.integers(16, 64, H), rng.integers(4096, 16384, H),
                    np.zeros(H), np.full(H, 1e6)], axis=1).astype(np.float32)
    blocked = rng.random(H) < 0.05
    exc_mask = rng.random((E, H)) < 0.5
    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).cuda()

    u8 = np.uint8
    return (dev(job_res), dev(np.ones(J), u8), dev(exc_id),
            dev(np.zeros(H), u8), dev(blocked, u8), dev(exc_mask, u8),
            dev(cap * np.float32(0.8)), dev(cap))


def make_match_workload(J, H, seed=1):
    """bench.py's make_match_workload: integer demands, a dense mask."""
    rng = np.random.default_rng(seed)
    job_res = np.stack([rng.integers(1, 16, J).astype(np.float32),
                        rng.integers(64, 4096, J).astype(np.float32),
                        np.zeros(J, np.float32), np.zeros(J, np.float32)], 1)
    capacity = np.stack([rng.integers(16, 128, H).astype(np.float32),
                         rng.integers(4096, 65536, H).astype(np.float32),
                         np.zeros(H, np.float32),
                         np.full(H, 1e6, np.float32)], 1)
    avail = (capacity * rng.uniform(0.3, 1.0, (H, 1))).astype(np.float32)
    return job_res, np.ones((J, H), bool), avail, capacity


def dense_world(J=10_000, H=50_000):
    """make_match_workload seed 3 with a seeded 80% mask and 90% valid
    jobs, made on the card."""
    job_res, _, avail, cap = make_match_workload(J, H, seed=3)
    g = torch.Generator(device="cuda").manual_seed(3)
    cmask = (torch.rand((J, H), generator=g, device="cuda") < 0.8) \
        .view(torch.uint8)
    valid = (torch.rand(J, generator=g, device="cuda") < 0.9) \
        .view(torch.uint8)
    return (torch.from_numpy(job_res).cuda(), cmask, valid,
            torch.from_numpy(avail).cuda(), torch.from_numpy(cap).cuda())


def topk_parity(got, want) -> float:
    """fit bit for bit; host equal where fit > -inf (the -inf entries'
    hosts mean nothing).  Returns the max abs error of the finite fits."""
    fit, host = got
    wfit, whost = want
    if not torch.equal(fit.view(torch.int32), wfit.view(torch.int32)):
        bad = int((fit.view(torch.int32) != wfit.view(torch.int32)).sum())
        raise AssertionError(f"top-K fit differs in {bad} entries")
    finite = wfit > float("-inf")
    if not torch.equal(host[finite], whost[finite]):
        raise AssertionError(f"top-K host differs in "
                             f"{int((host != whost)[finite].sum())} entries")
    return 0.0


def masked_pairs(wrapper, args) -> int:
    """The (valid job, host) pairs whose mask is set, counted on the card
    from the mask's own form (structured: each job's class row or
    exception row)."""
    if wrapper.kernel == "topk_dense":
        return int(((args[1] != 0) & (args[2] != 0)[:, None]).sum())
    job_res, valid, exc_id, host_gpu, host_blocked, exc_mask = args[:6]
    ok, gpu = host_blocked == 0, host_gpu != 0
    per_class = torch.stack([(ok & ~gpu).sum(), (ok & gpu).sum()])
    v, exc = valid != 0, exc_id >= 0
    rows = (exc_mask != 0).sum(1)
    base = per_class[(job_res[:, 2] > 0).long()][v & ~exc].sum()
    return int(base) + int(rows[exc_id[v & exc].long()].sum())


def list_entries(wrapper, args, block=1024) -> int:
    """The feasible pairs that enter their job's running list of the
    best ``TOPK_K`` in a walk over the hosts in order (strictly above
    its K-th entry then): the pairs whose exact fitness the function
    needs.  From the plain version's scores, a block of hosts at a
    time, on the card."""
    from cook_tpu_torch.ops import pallas_match as tpm
    job_res, avail, capacity = args[0], args[-2], args[-1]
    J, H = job_res.shape[0], avail.shape[0]
    if wrapper.kernel == "topk_dense":
        def mask_of(h0, h1):
            return (args[1][:, h0:h1] != 0) & (args[2] != 0)[:, None]
    else:
        def mask_of(h0, h1):
            return tpm.structured_mask(job_res, args[1], args[2],
                                       args[3][h0:h1], args[4][h0:h1],
                                       args[5][:, h0:h1])
    top = torch.full((J, TOPK_K), float("-inf"), device=job_res.device)
    n = torch.zeros((), dtype=torch.int64, device=job_res.device)
    for h0 in range(0, H, block):
        h1 = min(H, h0 + block)
        av, cap = avail[h0:h1], capacity[h0:h1]
        sc = tpm.score(job_res, tpm.resource_fit(job_res, av)
                       & mask_of(h0, h1), av, cap)
        for i in range(h1 - h0):
            col = sc[:, i:i + 1]
            n += (col[:, 0] > top[:, -1]).sum()
            top = torch.topk(torch.cat([top, col], 1), TOPK_K, dim=1).values
    return int(n)


def topk_library_ms(wrapper, args) -> float:
    """``torch.topk`` of the materialized score, summed over the plain
    version's chunks (the score is built outside the timed region)."""
    from cook_tpu_torch.ops import pallas_match as tpm
    job_res, avail, capacity = args[0], args[-2], args[-1]
    J, H = job_res.shape[0], avail.shape[0]
    total = 0.0
    step = tpm.chunk_rows(H)
    for lo in range(0, J, step):
        hi = min(J, lo + step)
        res = job_res[lo:hi]
        if wrapper.kernel == "topk_dense":
            mask = (args[1][lo:hi] != 0) & (args[2][lo:hi] != 0)[:, None]
        else:
            mask = tpm.structured_mask(res, args[1][lo:hi], args[2][lo:hi],
                                       *args[3:6])
        sc = tpm.score(res, tpm.resource_fit(res, avail) & mask, avail,
                       capacity)
        total += cuda_ms(lambda: torch.topk(sc, TOPK_K, dim=1), 3)
    return total


def ptxas_report(pattern: str) -> list:
    """Registers, stack and spills of every kernel whose mangled name
    matches ``pattern``, from the build's ``-Xptxas -v`` output."""
    import re
    from cook_tpu_torch.ops import cuda_lib
    out, name = [], None
    for line in cuda_lib.BUILD_LOG.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name and re.search(pattern, name):
            out.append({"function": name, "stack": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
        m = re.search(r"Used (\d+) registers", line)
        if m and name and re.search(pattern, name):
            for row in out:
                if row["function"] == name:
                    row["registers"] = int(m.group(1))
    return out


def forced_splits(tpm, splits):
    """A context in which the top-K wrappers plan ``splits`` host splits
    (the same work in another geometry, for comparison)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        plan = tpm._plan

        def forced(J, H, k, dense, device):
            p = plan(J, H, k, dense, device)
            tiles = -(-H // p.tile)
            S = min(splits, tiles)
            return p._replace(splits=S, per=-(-tiles // S) * p.tile)
        tpm._plan = forced
        try:
            yield
        finally:
            tpm._plan = plan
    return ctx()


def topk_edge_world(seed, J, H, E=0, *, structured=True, exc_block=None,
                    ties=False, edges=False, nan_hosts=False):
    """A check world for the top-K kernels, on the card.  ``exc_block``:
    every job of that scan block holds an exception row (more rows than
    a round stages); ``ties``: integer demands and capacities, so fits
    tie at the K-th entry; ``edges``: capacity 0 and below 1e-9,
    capacities and demands past the fast division's range (the ``/``
    path, and the pre-filter off), negative cap - avail, zero demands;
    ``nan_hosts``: three hosts of infinite cpu capacity and avail (a
    NaN fitness: the row of a job they fit becomes that NaN).  10%
    invalid jobs, 20% gpu jobs and 30% gpu hosts."""
    from cook_tpu_torch.ops import pallas_match as tpm
    rng = np.random.default_rng(seed)
    f32 = np.float32
    if ties:
        job_res = rng.integers(0, 4, (J, 4)).astype(f32)
        cap = rng.integers(4, 9, (H, 4)).astype(f32)
        avail = rng.integers(0, 9, (H, 4)).astype(f32)
    else:
        job_res = np.stack([rng.uniform(0.1, 8.0, J),
                            rng.uniform(64, 2048, J), np.zeros(J),
                            rng.uniform(0.0, 10.0, J)], 1).astype(f32)
        cap = np.stack([rng.uniform(16, 64, H), rng.uniform(4096, 16384, H),
                        np.zeros(H), np.full(H, 1e3)], 1).astype(f32)
        avail = (cap * rng.uniform(0.2, 1.0, (H, 4))).astype(f32)
    gpu_host = rng.random(H) < 0.3
    cap[:, 2] = np.where(gpu_host, 8.0, 0.0)
    avail[:, 2] = np.where(gpu_host, rng.integers(0, 9, H), 0.0)
    job_res[:, 2] = np.where(rng.random(J) < 0.2, rng.integers(1, 4, J), 0)
    if edges:
        hc = [0.0, 1e-12, 1e-10, 1e-9, 2e12, 5e13, 1e-30]
        pick = rng.random(H) < 0.3
        for r in (0, 1):
            cap[pick, r] = rng.choice(hc, int(pick.sum()))
        neg = rng.random(H) < 0.2          # avail above capacity
        avail[neg, :2] = cap[neg, :2] * f32(1.25) + f32(3.0)
        full = rng.random(H) < 0.1         # cap - avail exactly 0
        avail[full, :2] = cap[full, :2]
        jc = [0.0, 1e-20, 1e-13, 2.0 ** 41, 3e12]
        pick = rng.random(J) < 0.2
        for r in (0, 1):
            job_res[pick, r] = rng.choice(jc, int(pick.sum()))
    if nan_hosts:   # feasible only for jobs of disk demand below 0.5
        for h in (3, H // 2, H - 2):
            cap[h, 0] = avail[h, 0] = np.inf
            avail[h, 3] = 0.5
    valid = rng.random(J) >= 0.1
    exc_id = np.full(J, -1, np.int32)
    if E:
        exc_id[rng.choice(J, size=min(E, J) // 2, replace=False)] = \
            rng.integers(0, E, min(E, J) // 2)
        if exc_block is not None:
            jobs = tpm.jobs_per_block(False)
            b = slice(exc_block * jobs, (exc_block + 1) * jobs)
            exc_id[b] = rng.integers(0, E, exc_id[b].shape[0])
    exc_mask = rng.random((max(E, 1), H)) < 0.5

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).cuda()
    u8 = np.uint8
    if structured:
        return (dev(job_res), dev(valid, u8), dev(exc_id), dev(gpu_host, u8),
                dev(rng.random(H) < 0.05, u8), dev(exc_mask, u8), dev(avail),
                dev(cap))
    cmask = rng.random((J, H)) < 0.8
    return (dev(job_res), dev(cmask, u8), dev(valid, u8), dev(avail),
            dev(cap))


# (name, structured, J, H, E, world options, k values): H not a multiple
# of the tile (and of 16: the byte path) and J not of the block; every
# job of one block holding an exception row, with the 16-byte path and
# the byte path; ties at the K-th entry; the division's edges; NaN rows
TOPK_CHECKS = (
    ("structured_mixed", True, 30_000, 20_000, 64, {}, (8, 16)),
    ("structured_exc_block_vec", True, 2_000, 20_480, 200,
     dict(exc_block=3), (16, 9)),
    ("structured_exc_block_bytes", True, 1_037, 20_013, 300,
     dict(exc_block=0), (4, 1)),
    ("structured_ties", True, 3_001, 5_003, 16, dict(ties=True), (16, 8)),
    ("structured_edges", True, 4_000, 9_000, 32,
     dict(edges=True, nan_hosts=True), (16, 9)),
    ("dense_ragged", False, 2_001, 30_007, 0, {}, (4, 1)),
    ("dense_ties", False, 3_000, 8_192, 0, dict(ties=True), (16, 9)),
    ("dense_edges", False, 2_500, 10_000, 0,
     dict(edges=True, nan_hosts=True), (8, 16)),
)


def topk_check():
    """Each TOPK_CHECKS world at each of its k, kernel against the plain
    version bit for bit (topk_parity)."""
    from cook_tpu_torch.ops import pallas_match as tpm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (name, structured, J, H, E, opts, ks) in enumerate(TOPK_CHECKS):
        args = topk_edge_world(SEED + 80 + i, J, H, E,
                               structured=structured, **opts)
        wrapper = tpm.topk_structured if structured else tpm.topk_dense
        for k in ks:
            got = wrapper(*args, k)
            topk_parity(got, wrapper.plain(*args, k))
            plan = tpm._plan(J, H, k, not structured, args[0].device)
            print(json.dumps({
                "phase": "D", "check": name, "J": J, "H": H, "E": E, "k": k,
                "host_splits": plan.splits, "sms": sms,
                "finite_entries": int((got[0] > float("-inf")).sum()),
                "nan_rows": int(torch.isnan(got[0]).all(1).sum()),
                "equal_to_plain": True}))
        del args


def phase_d():
    """The top-K kernels through their entry points at the bench worlds
    (counted), then each held against its plain version and timed; then
    the check worlds."""
    from cook_tpu_torch.ops import pallas_match as tpm
    from cook_tpu_torch.ops import telemetry
    worlds = {"topk_structured": (tpm.topk_structured, structured_world()),
              "topk_dense": (tpm.topk_dense, dense_world())}
    telemetry.reset_all()
    outs = {}
    for name, (wrapper, args) in worlds.items():
        if name == "topk_structured":
            outs[name] = tpm.topk_prefs_structured(
                args[0], args[1], args[3], args[4], args[2], args[5],
                args[6], args[7], k=TOPK_K)
        else:
            outs[name] = tpm.topk_prefs(*args, k=TOPK_K)
    torch.cuda.synchronize()
    counts = telemetry.snapshot()
    rows = {}
    for name, (wrapper, args) in worlds.items():
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} was not launched")
        want = wrapper.plain(*args, TOPK_K)
        err = topk_parity(outs[name], want)
        call = lambda: wrapper(*args, TOPK_K)  # noqa: E731
        ms = cuda_ms(call, 3)
        types, _ = captured_launches(call)
        dev_ms = device_ms(call, 3, types.count("kernel"))
        job_res, avail = args[0], args[-2]
        J, H = job_res.shape[0], avail.shape[0]
        plan = tpm._plan(J, H, TOPK_K, name == "topk_dense", job_res.device)
        one_split_ms = None
        if plan.splits > 1:   # the same work with the hosts left unsplit
            with forced_splits(tpm, 1):
                topk_parity(call(), want)
                one_split_ms = cuda_ms(call, 3)
        del want
        plain_ms = cuda_ms(lambda: wrapper.plain(*args, TOPK_K), 1)
        lib_ms = topk_library_ms(wrapper, args)
        ins = [a for a in args if isinstance(a, torch.Tensor)]
        nbytes = sum(t.numel() * t.element_size()
                     for t in ins + list(outs[name]))
        pairs, entries = masked_pairs(wrapper, args), list_entries(wrapper,
                                                                   args)
        ops = pairs * TOPK_PAIR_OPS + entries * TOPK_EXACT_OPS
        if not 0 < entries <= pairs:
            raise AssertionError(f"{name}: {entries} list entries of "
                                 f"{pairs} masked pairs")
        fit = outs[name][0]
        rows[name] = dict(calls=1, launches=counts[name], max_abs_err=err,
                          ms=ms, device_ms=dev_ms,
                          cuda_launches_per_call=len(types),
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bytes=nbytes, ops=ops, masked_pairs=pairs,
                          list_entries=entries)
        b_ms, b_by = bound(rows[name])
        print(json.dumps({
            "phase": "D", "kernel": name, "J": J, "H": H, "k": TOPK_K,
            **rows[name], "bound_ms": b_ms, "bound_by": b_by,
            "launched": types, "host_splits": plan.splits,
            "blocks_per_sm": tpm.blocks_per_sm(
                name == "topk_dense", tpm.kept(TOPK_K), 0),
            "one_split_ms": one_split_ms,
            "finite_entries": int((fit > float("-inf")).sum())}))
    print(json.dumps({"phase": "D", "ptxas": ptxas_report(
        r"topk|greedy_cluster|div_check|div_recip")}))
    topk_check()
    return rows


# ------------------------------------------------- phase S: the driver
# bench.py::bench_driver_cycle's world (:805-934, jobs from _driver_jobs
# :1237-1247), nothing cut: one pool, 100,000 jobs from 200 users, 5,000
# hosts of 64 cpus and 65,536 MB, Config() defaults
S_JOBS, S_USERS, S_HOSTS, S_SEED, S_TIMED = 100_000, 200, 5_000, 5, 5


class DriverScheduler:
    """What ``FusedCycleDriver.step`` reads off a scheduler
    (``cook_tpu/sched/scheduler.py:214-235``, ``:639-651``; phase S
    drives the driver's four phases alone, phase Q the port's
    ``Scheduler``): the clusters, the reserved hosts, the
    breaker-filtered launchable clusters and the offensive-job stifler.
    Status updates are queued in arrival order and applied to the store
    by ``flush_status_updates``, after the step: the bench's scheduler
    takes them off the cycle thread too (``status_queue_shards=4``,
    ``bench.py:836-837``, flushed after every step)."""

    def __init__(self, store, clusters):
        self.store = store
        self.clusters = {}
        self.reserved_hosts = {}
        self._status = []
        for c in clusters:
            c.initialize(self._on_status)
            self.clusters[c.name] = c

    def _on_status(self, task_id, status, reason_code, exit_code=None,
                   preempted=False, hostname=None):
        self._status.append((task_id, status, reason_code, exit_code,
                             preempted, hostname))

    def flush_status_updates(self) -> int:
        """Apply the queued updates in order; returns their count."""
        queued, self._status = self._status, []
        for task_id, status, reason, exit_code, preempted, host in queued:
            self.store.update_instance_status(
                task_id, status, reason_code=reason, exit_code=exit_code,
                preempted=preempted, hostname=host)
        return len(queued)

    def launchable_clusters(self, pool_name):
        from cook_tpu_torch.utils.retry import breakers
        return [c for c in self.clusters.values()
                if c.accepts_pool(pool_name)
                and breakers.get(c.name).allow()]

    def _stifle_offensive(self, offensive):
        for job in offensive:
            self.store.kill_job(job.uuid)


def driver_jobs(rng, n, n_users):
    """``bench.py::_driver_jobs`` with the port's classes: priority from
    U[0, 100), submit time from U[0, 10^6), cpus from U{1..7}, mem from
    U{64..2047}, users round robin."""
    from cook_tpu_torch.state import Job, Resources, new_uuid
    return [Job(uuid=new_uuid(), user=f"user{i % n_users:04d}", command="x",
                priority=int(rng.integers(0, 100)),
                submit_time_ms=int(rng.integers(0, 10**6)),
                resources=Resources(cpus=float(rng.integers(1, 8)),
                                    mem=float(rng.integers(64, 2048))))
            for i in range(n)]


def driver_world(device="cuda", n_jobs=S_JOBS, n_users=S_USERS,
                 hosts=S_HOSTS, seed=S_SEED):
    from cook_tpu_torch.cluster import FakeCluster, FakeHost
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.policy import PluginRegistry, RateLimits
    from cook_tpu_torch.sched.fused import FusedCycleDriver
    from cook_tpu_torch.sched.matcher import Matcher
    from cook_tpu_torch.state import Pool, Resources, Store
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    store = Store()
    cluster = FakeCluster("fake-1", [
        FakeHost(f"h{i}", Resources(cpus=64.0, mem=65536.0))
        for i in range(hosts)])
    cfg = Config()
    cfg.pipeline.depth = 0
    store.put_pool(Pool(name=cfg.default_pool))
    plugins, limits = PluginRegistry(), RateLimits()
    sched = DriverScheduler(store, [cluster])
    matcher = Matcher(store, cfg, plugins=plugins, rate_limits=limits,
                      device=device)
    driver = FusedCycleDriver(store, cfg, matcher, plugins, limits,
                              device=device)
    jobs = driver_jobs(rng, n_jobs, n_users)
    for i in range(0, n_jobs, 10_000):
        store.create_jobs(jobs[i:i + 10_000])
    store.ensure_index()
    return SimpleNamespace(store=store, cluster=cluster, cfg=cfg,
                           sched=sched, matcher=matcher, driver=driver,
                           rng=rng, n_users=n_users, hosts=hosts,
                           build_s=time.perf_counter() - t0, counts={})


def top_up(s, n):
    """As the bench does: the jobs the last cycle launched come back as
    fresh pending jobs, so every cycle schedules at scale."""
    fresh = driver_jobs(s.rng, n, s.n_users)
    for i in range(0, n, 10_000):
        s.store.create_jobs(fresh[i:i + 10_000])


def pending_at_pack(sg) -> set:
    from cook_tpu_torch.ops.delta import FLAG_PENDING
    out = set()
    for pp in sg.group:
        pend = (pp.flags & FLAG_PENDING) != 0
        out.update(str(u) for u in pp.uuid_base[pp.rows_s[pend]])
    return out


def check_hosts(s) -> int:
    """No host holds more than its capacity, by the store's live
    instances; returns the live instance count."""
    cap = np.array([64.0, 65536.0])
    used = {}
    n = 0
    for job, inst in s.store.running_instances():
        u = used.setdefault(inst.hostname, np.zeros(2))
        u += (job.resources.cpus, job.resources.mem)
        n += 1
    over = [h for h, u in used.items() if (u > cap).any()]
    if over:
        raise AssertionError(f"phase S: hosts oversubscribed: {over[:5]}")
    return n


def driver_cycle(s, kind: str, i: int, check: bool = True) -> dict:
    """One ``FusedCycleDriver`` step through its four public phases
    (``stage``, ``dispatch_group``, ``fetch_group``, ``apply_group``),
    timed on the host clock.  Between fetch and apply the same staged
    wire runs through ``megacycle_plain`` on the card and all seven
    outputs must equal the kernels'.  Launch counts are read around
    dispatch and fetch only.  After the step the queued status updates
    are applied (``status_ms``, not in ``step_ms``); then: no host
    oversubscribed, every launched job was pending at the pack,
    placements > 0."""
    import gc
    from cook_tpu_torch.ops import telemetry
    from cook_tpu_torch.ops.pallas_cycle import megacycle_plain
    drv = s.driver
    h2d0 = telemetry.events().get("transfer.h2d", 0)
    # the scheduler's GC discipline (cook_tpu/sched/scheduler.py:716-754,
    # maintain_gc :347): no automatic collection inside a cycle; a full
    # collect and freeze after the first cycle and every 10th, outside
    # the step
    gc.disable()
    t0 = time.perf_counter()
    staged = drv.stage(s.sched)
    t1 = time.perf_counter()
    queues = {p.name: [] for p in staged.pools}
    results = {}
    enq = fetch = apply_ms = plain = 0.0
    paths, ks, group_stage_ms, pend = [], [], 0.0, set()
    for sg in staged.groups:
        before = telemetry.snapshot()
        ta = time.perf_counter()
        gd = drv.dispatch_group(sg)
        tb = time.perf_counter()
        drv.fetch_group(gd)
        tc = time.perf_counter()
        after = telemetry.snapshot()
        for k, v in after.items():
            s.counts[k] = s.counts.get(k, 0) + v - before.get(k, 0)
        if check:
            m = sg.mega
            ref = megacycle_plain(
                driver_wire(sg), gpu_mode=sg.gpu_mode,
                max_over_quota_jobs=s.cfg.max_over_quota_jobs,
                considerable_cap=min(sg.cap, sg.T),
                rows_codec=m["rows_codec"], avail_scale=m["avail_scale"],
                cap_scale=m["cap_scale"])
            for name in ref._fields:
                max_err(getattr(gd.res, name), getattr(ref, name))
        pend |= pending_at_pack(sg)
        td = time.perf_counter()
        drv.apply_group(s.sched, gd, queues, results)
        te = time.perf_counter()
        enq += (tb - ta) * 1e3
        fetch += (tc - tb) * 1e3
        plain += (td - tc) * 1e3
        apply_ms += (te - td) * 1e3
        group_stage_ms += sg.stage_ms
        if sg.sync is not None:
            paths.append(sg.sync.reason)
            ks.append(sg.sync.k)
    gc.enable()
    if i == 0 or i % 10 == 0:
        gc.collect()
        gc.freeze()
    tf = time.perf_counter()
    n_status = s.sched.flush_status_updates()
    status_ms = (time.perf_counter() - tf) * 1e3
    h2d = telemetry.events().get("transfer.h2d", 0) - h2d0
    launched = [u for r in results.values() for u in r.launched_job_uuids]
    if not launched:
        raise AssertionError(f"phase S {kind} cycle {i}: no placement")
    stray = [u for u in launched if u not in pend]
    if stray:
        raise AssertionError(f"phase S: launched jobs that were not "
                             f"pending: {stray[:5]}")
    live = check_hosts(s)
    s.last_queues = queues
    step_ms = (t1 - t0) * 1e3 + enq + fetch + apply_ms
    return {"phase": "S", "kind": kind, "cycle": i, "step_ms": step_ms,
            "pack_ms": drv.last_pack_ms, "stage_ms": group_stage_ms,
            "stage_phase_ms": (t1 - t0) * 1e3, "enqueue_ms": enq,
            "fetch_ms": fetch, "apply_ms": apply_ms,
            "status_ms": status_ms, "status_updates": n_status,
            "plain_check_ms": plain if check else None,
            "outputs_equal_to_plain": check, "h2d_bytes": h2d,
            "resident_path": paths, "delta_k": ks,
            "placements": len(launched),
            "considered": sum(r.considered for r in results.values()),
            "pending_at_pack": len(pend), "live_instances": live}


def profile_step(s, tries: int = 3) -> dict:
    """The card's busy time in one driver step (torch.profiler's CUDA
    activity; a trace holding fewer kernels than the stage counters
    counted is taken again, each try a fresh step), and its share of the
    step's host wall time."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from cook_tpu_torch.ops import telemetry
    for t in range(tries):
        top_up(s, 1_000)
        torch.cuda.synchronize()
        entries = -sum(v for k, v in telemetry.snapshot().items()
                       if k != "gang")
        gc.collect()
        gc.disable()   # as in driver_cycle
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _q, results = s.driver.step(s.sched)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        gc.enable()
        s.sched.flush_status_updates()
        entries += sum(v for k, v in telemetry.snapshot().items()
                       if k != "gang")
        acts = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        if sum(1 for e in acts if "Memset" not in e.name) >= entries:
            busy = sum(device_us(e) for e in prof.key_averages()) / 1e3
            by = {}
            for e in prof.key_averages():
                us = device_us(e)
                if us > 0:
                    stage = next((k for k, pats in KERNEL_NAMES
                                  if any(p in e.key for p in pats)), "other")
                    by[stage] = by.get(stage, 0.0) + us / 1e3
            return {"busy_ms": busy, "profiled_step_ms": wall,
                    "idle_share_of_profiled_step": 1.0 - busy / wall,
                    "device_ms_by_stage": by, "tries": t + 1,
                    "placements": sum(len(r.launched_task_ids)
                                      for r in results.values())}
    return {"busy_ms": "not measured", "tries": tries}


def phase_s(device="cuda", keep=False, **size):
    """The driver at bench_driver_cycle's world: one warm cycle, one
    settle cycle, then S_TIMED timed cycles, each topped up with as many
    fresh jobs as the last one launched; launches counted over these
    cycles (the counts zeroed just before).  Then one profiled step, and
    the split cycle (``Ranker.rank_pool``, ``Matcher.match_pool``) on
    the same store, counted on its own; each of its launches is replayed
    against its plain version, and the rank against
    ``rank_kernel_compact``'s plain version on the same inputs.  With
    ``keep`` the world is returned too (phase U2 runs on it)."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.sched import ranker as ranker_mod
    from cook_tpu_torch.sched.ranker import Ranker
    s = driver_world(device, **size)
    print(json.dumps({"phase": "S", "world": {
        "jobs": len(s.store.pending_jobs("default")), "users": s.n_users,
        "hosts": s.hosts, "build_s": s.build_s}}))
    telemetry.reset_all()
    lines = []
    line = driver_cycle(s, "warm", 0)
    lines.append(line)
    print(json.dumps(line))
    top_up(s, line["placements"])
    line = driver_cycle(s, "settle", 1)
    lines.append(line)
    print(json.dumps(line))
    for i in range(S_TIMED):
        top_up(s, line["placements"])
        line = driver_cycle(s, "timed", 2 + i)
        lines.append(line)
        print(json.dumps(line))
    counts = dict(s.counts)
    missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
    if missing and device == "cuda":
        raise AssertionError(f"phase S: kernels not launched: {missing}")
    timed = [x for x in lines if x["kind"] == "timed"]
    med = {k: statistics.median(x[k] for x in timed)
           for k in ("step_ms", "pack_ms", "stage_ms", "stage_phase_ms",
                     "enqueue_ms", "fetch_ms", "apply_ms", "status_ms",
                     "h2d_bytes")}
    # the status updates' share of a cycle's host time, had they been
    # applied on the cycle thread as the launches arrive
    med["status_share"] = statistics.median(
        x["status_ms"] / (x["step_ms"] + x["status_ms"]) for x in timed)
    prof = profile_step(s) if device == "cuda" else {}
    if isinstance(prof.get("busy_ms"), float):
        prof["idle_share_of_median_step"] = \
            1.0 - prof["busy_ms"] / med["step_ms"]
    telemetry.reset_all()
    ranker = Ranker(s.store, s.cfg, device=device)
    real, ranked = ranker_mod.rank_kernel_compact, []

    def rank_spy(inp, **kw):
        # the ranker's CompactRankInputs and result, for the plain check
        got = real(inp, **kw)
        ranked.append((inp, kw, got))
        return got

    ranker_mod.rank_kernel_compact = rank_spy
    try:
        with cuda_lib.recording() as calls:
            t0 = time.perf_counter()
            queue = ranker.rank_pool("default")
            t1 = time.perf_counter()
            offers = s.cluster.pending_offers("default")
            split = s.matcher.match_pool("default", queue, offers,
                                         s.sched.clusters,
                                         s.sched.reserved_hosts)
            t2 = time.perf_counter()
    finally:
        ranker_mod.rank_kernel_compact = real
    split_counts = telemetry.snapshot()
    s.sched.flush_status_updates()
    if not split.launched_job_uuids:
        raise AssertionError("phase S: the split cycle placed nothing")
    check_hosts(s)
    held, rank_err = {}, None
    if device == "cuda":
        held = replay_all(calls, "phase S split cycle")
        rank_err = split_rank_check(ranked)
    out = {"phase": "S", "timed_cycles": len(timed),
           "median_timed": med,
           "placements": [x["placements"] for x in lines],
           "resident_paths": [x["resident_path"] for x in lines],
           "launches_per_kernel": counts, "profile": prof,
           "split_cycle": {"rank_ms": (t1 - t0) * 1e3,
                           "match_ms": (t2 - t1) * 1e3,
                           "queue": len(queue),
                           "considered": split.considered,
                           "placements": len(split.launched_job_uuids),
                           "launches_per_kernel": split_counts,
                           "replayed_equal_to_plain": held,
                           "rank_max_abs_err_against_plain": rank_err}}
    print(json.dumps(out))
    counts = {"driver": counts, "split": split_counts}
    return (counts, s) if keep else counts


def split_rank_check(ranked, what: str = "phase S") -> float:
    """The split cycle's rank against ``rank_kernel_compact``'s plain
    version on the same ``CompactRankInputs``: the wire expanded on the
    CPU (the wrappers' plain versions), then ``rank_body`` on the card;
    every output equal.  Returns the max abs err."""
    from cook_tpu_torch.ops import dru
    if len(ranked) != 1:
        raise AssertionError(f"{what}: {len(ranked)} compact ranks, not 1")
    inp, kw, got = ranked[0]
    wide = dru.expand_compact_rank(dru.CompactRankInputs(
        *(t.cpu() for t in inp)))
    order, num, dru_v, keep, _ = dru.rank_body(
        *(t.cuda() for t in wide), kw["gpu_mode"],
        kw["max_over_quota_jobs"])
    want = dru.RankResult(order=order,
                          dru=torch.where(keep, dru_v, float("inf")),
                          keep=keep, num_ranked=num)
    return max(max_err(getattr(got, name), getattr(want, name))
               for name in want._fields)


# ------------------------------------------------ phase Q: the Scheduler
# bench.py::bench_pipeline_driver's world (:1250-1352), cut to 25,000 of
# its 100,000 jobs for the smoke's time (50,000 until phase FO joined the
# run): one pool, jobs from 200 users
# (_driver_jobs, seed 13), 5,000 hosts
# of 64 cpus and 65,536 MB, Config() defaults, status_queue_shards=4; a
# depth-0 leg and a depth-2 leg, each from a fresh store
Q_JOBS, Q_USERS, Q_HOSTS, Q_SEED, Q_TIMED, Q_CHECKED = \
    25_000, 200, 5_000, 13, 5, 3
Q_SMALL = {"n_jobs": 10_000, "hosts": 500}   # the card-against-CPU world
Q_SMALL_STEPS = 4


def counted_uuids(seed):
    """Canonical lowercase uuids from a counter: equal on every run, so
    two runs of one world rank and tie-break alike."""
    n = [0]

    def make():
        n[0] += 1
        return f"{seed:08x}-0000-4000-8000-{n[0]:012x}"
    return make


def sched_world(device="cuda", depth=2, n_jobs=Q_JOBS, n_users=Q_USERS,
                hosts=Q_HOSTS, seed=Q_SEED, counted=False, shards=4,
                admission=False):
    """The port's ``Scheduler`` over a fresh store, built as the bench
    builds it (the scheduler first, then the jobs in chunks);
    ``admission`` enables the adaptive admission controller."""
    from cook_tpu_torch.cluster import FakeCluster, FakeHost
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import Resources, Store
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    store = Store()
    cluster = FakeCluster(f"fake-d{depth}", [
        FakeHost(f"h{i}", Resources(cpus=64.0, mem=65536.0))
        for i in range(hosts)])
    cfg = Config()
    cfg.pipeline.depth = depth
    cfg.admission.enabled = admission
    sched = Scheduler(store, cfg, [cluster], rank_backend="tpu",
                      status_queue_shards=shards, device=device)
    s = SimpleNamespace(store=store, cluster=cluster, cfg=cfg, sched=sched,
                        rng=rng, n_users=n_users, hosts=hosts,
                        uuid=counted_uuids(seed) if counted else None)
    q_top_up(s, n_jobs)
    store.ensure_index()
    s.build_s = time.perf_counter() - t0
    return s


def q_top_up(s, n):
    fresh = driver_jobs(s.rng, n, s.n_users)
    if s.uuid is not None:
        for j in fresh:
            j.uuid = s.uuid()
    for i in range(0, n, 10_000):
        s.store.create_jobs(fresh[i:i + 10_000])


def check_live(s, what: str) -> int:
    """No host over capacity and no job with two live instances, by the
    store's live instances; returns their count."""
    cap = np.array([64.0, 65536.0])
    used, per_job = {}, {}
    live = s.store.running_instances()
    for job, inst in live:
        u = used.setdefault(inst.hostname, np.zeros(2))
        u += (job.resources.cpus, job.resources.mem)
        per_job[job.uuid] = per_job.get(job.uuid, 0) + 1
    over = [h for h, u in used.items() if (u > cap).any()]
    if over:
        raise AssertionError(f"{what}: hosts oversubscribed: {over[:5]}")
    twice = [u for u, n in per_job.items() if n > 1]
    if twice:
        raise AssertionError(f"{what}: jobs with two live instances: "
                             f"{twice[:5]}")
    return len(live)


def sync_waits() -> dict:
    """Seconds waited on the card so far, by site
    (``cook_sync_wait_seconds{kind}``)."""
    from cook_tpu_torch.utils.metrics import registry
    out = {}
    for (name, labels), h in list(registry._histograms.items()):
        if name == "cook_sync_wait_seconds":
            out[dict(labels).get("kind", "")] = h["sum"]
    return out


def waits_since(before: dict) -> dict:
    now = sync_waits()
    return {k: (v - before.get(k, 0.0)) * 1e3 for k, v in now.items()
            if v - before.get(k, 0.0) > 0}


def launched_pairs(s, results) -> list:
    out = []
    for r in results.values():
        for tid in r.launched_task_ids:
            inst = s.store.instance(tid)
            out.append((inst.job_uuid, inst.hostname))
    return sorted(out)


def touch_queue(s) -> int:
    """A queue consumer (the rebalancer, a /queue page): the published
    queue's uuids, which fetch its rows from the card."""
    q = s.sched.pending_queues.get("default")
    return 0 if q is None else len(q.uuids)


def q_step(s, what, i):
    """One timed ``step_cycle``; then the status updates flushed, the
    queue touched and the store checked (outside the timed step)."""
    from cook_tpu_torch.utils.flight import recorder
    t0 = time.perf_counter()
    results = s.sched.step_cycle()
    ms = (time.perf_counter() - t0) * 1e3
    rec = recorder.recent(1)[0]
    w0 = sync_waits()
    t1 = time.perf_counter()
    s.sched.flush_status_updates()
    t2 = time.perf_counter()
    queued = touch_queue(s)
    touch_ms = (time.perf_counter() - t2) * 1e3
    waits = waits_since(w0)
    live = check_live(s, f"phase Q {what} step {i}")
    n = sum(len(r.launched_task_ids) for r in results.values())
    return {"step": i, "step_ms": ms, "launched": n,
            "detail_ms": rec["detail_ms"], "phases_ms": rec["phases_ms"],
            "status_ms": (t2 - t1) * 1e3, "queue_touch_ms": touch_ms,
            "queue_rows_wait_ms": waits.get("queue.rows", 0.0),
            "queued": queued, "live": live}


def own_time_step(s, top: int = 12) -> dict:
    """One more step under cProfile: its wall ms and the main thread's
    ``top`` largest own times (ms, file:line:function), which show where
    the step waits while the status shards' threads apply updates."""
    q_top_up(s, 1_000)
    ms, own = profiled_own(s.sched.step_cycle, top)
    s.sched.flush_status_updates()
    return {"step_ms": ms, "top_own_ms": own}


def profiled_own(fn, top: int = 12) -> tuple:
    """``fn()`` under cProfile: its wall ms and the ``top`` largest own
    times (ms, file:line:function)."""
    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    fn()
    ms = (time.perf_counter() - t0) * 1e3
    prof.disable()
    own = sorted(((v[2] * 1e3, f"{Path(k[0]).name}:{k[1]}:{k[2]}")
                  for k, v in pstats.Stats(prof).stats.items()),
                 reverse=True)[:top]
    return ms, own


def q_leg(depth, device="cuda", timed=Q_TIMED, shards=4, **size) -> dict:
    """One leg of bench_pipeline_driver: a warm step, a settle step, then
    ``timed`` steps, each topped up with as many jobs as the last one
    launched; the launch counts zeroed before the warm step and read
    after the last.  Then one step under cProfile (``own_time_step``)."""
    from cook_tpu_torch.ops import telemetry
    from cook_tpu_torch.utils.flight import recorder
    s = sched_world(device, depth, shards=shards, **size)
    telemetry.reset_all()
    waits0 = sync_waits()
    seq0 = recorder.last_seq()
    lines = [q_step(s, f"d{depth} warm", 0)]
    top_up_n = lines[-1]["launched"]
    q_top_up(s, top_up_n)
    lines.append(q_step(s, f"d{depth} settle", 1))
    for i in range(timed):
        q_top_up(s, lines[-1]["launched"])
        lines.append(q_step(s, f"d{depth}", 2 + i))
    counts = telemetry.snapshot()
    flight = recorder.summary(since_seq=seq0)
    steps = [x["step_ms"] for x in lines[2:]]
    drv = s.sched._pipeline
    launched = sum(x["launched"] for x in lines)
    leg = {"phase": "Q", "depth": depth, "status_queue_shards": shards,
           "world": {
               "jobs": size.get("n_jobs", Q_JOBS), "hosts": s.hosts,
               "users": s.n_users, "build_s": s.build_s},
           "p50_ms": float(np.percentile(steps, 50)),
           "p99_ms": float(np.percentile(steps, 99)),
           "step_ms": steps, "launched": launched,
           "launched_per_step": [x["launched"] for x in lines],
           "status_ms_median": statistics.median(
               x["status_ms"] for x in lines[2:]),
           "detail_ms_median": {k: statistics.median(
               x["detail_ms"].get(k, 0.0) for x in lines[2:])
               for k in ("pack", "stage", "apply")},
           "phases_ms_median": {k: statistics.median(
               x["phases_ms"].get(k, 0.0) for x in lines[2:])
               for k in lines[-1]["phases_ms"]},
           "sync_wait_ms_by_site": waits_since(waits0),
           "flight_sync_wait_ms": flight.get("sync_wait_ms"),
           "queue_rows_wait_ms": [x["queue_rows_wait_ms"] for x in lines],
           "queue_touch_ms": [x["queue_touch_ms"] for x in lines],
           "launches_per_kernel": counts}
    if drv is not None:
        conflicts = drv.conflicts_state + drv.conflicts_resources
        leg.update({"conflicts_state": drv.conflicts_state,
                    "conflicts_resources": drv.conflicts_resources,
                    "conflict_rate": conflicts / max(launched, 1)})
    missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
    if missing and device == "cuda":
        raise AssertionError(f"phase Q depth {depth}: kernels not "
                             f"launched: {missing}")
    leg["profiled_step"] = own_time_step(s)
    s.leg = leg
    return s


@contextmanager
def checking_dispatches(s, plain=True):
    """Within the block, every dispatch of ``s``'s driver is recorded:
    ``dispatches`` gets its resident sync's path (``None`` without the
    resident wire); with ``plain``, its wire is cloned at dispatch (at
    depth 2 the next stage scatters into the resident buffers) and, after
    its fetch, run through ``megacycle_plain`` on the card: all seven
    outputs must equal the kernels' (``held`` gets the dispatch's index
    and the outputs held).  At the end the dispatch still in flight at
    depth 2 is fetched (the pipeline's own fetch; the next step finds it
    fetched)."""
    from cook_tpu_torch.ops.pallas_cycle import MegaCycleWire, \
        megacycle_plain
    s.sched._ensure_fused()
    drv = s.sched._fused
    real_dispatch, real_fetch = drv.dispatch_group, drv.fetch_group
    clones = {}
    seen = SimpleNamespace(dispatches=[], held=[])

    def dispatch(sg):
        seen.dispatches.append(sg.sync.reason if sg.sync else None)
        wire = (MegaCycleWire(*(t.clone() for t in driver_wire(sg)))
                if plain else None)
        gd = real_dispatch(sg)
        clones[id(gd)] = (len(seen.dispatches) - 1, wire)
        return gd

    def fetch(gd):
        out = real_fetch(gd)
        i, wire = clones.pop(id(gd), (None, None))
        if wire is not None:
            sg, m = gd.sg, gd.sg.mega
            ref = megacycle_plain(
                wire, gpu_mode=sg.gpu_mode,
                max_over_quota_jobs=s.cfg.max_over_quota_jobs,
                considerable_cap=min(sg.cap, sg.T),
                rows_codec=m["rows_codec"], avail_scale=m["avail_scale"],
                cap_scale=m["cap_scale"])
            for name in ref._fields:
                max_err(getattr(gd.res, name), getattr(ref, name))
            seen.held.append((i, len(ref._fields)))
        return out

    drv.dispatch_group, drv.fetch_group = dispatch, fetch
    try:
        yield seen
        pipe = s.sched._pipeline
        for entry in list(pipe._inflight if pipe is not None else ()):
            pipe._fetch(entry)
    finally:
        drv.dispatch_group, drv.fetch_group = real_dispatch, real_fetch


def q_checked_steps(s, steps=Q_CHECKED) -> dict:
    """Steps whose every dispatched wire is run through
    ``megacycle_plain`` on the card (``checking_dispatches``)."""
    with checking_dispatches(s) as seen:
        n = 0
        for i in range(steps):
            q_top_up(s, 1_000)
            n += sum(len(r.launched_task_ids)
                     for r in s.sched.step_cycle().values())
            s.sched.flush_status_updates()
            check_live(s, f"phase Q checked step {i}")
    held = seen.held
    if len(held) < steps:
        raise AssertionError(f"phase Q: {len(held)} dispatches checked "
                             f"in {steps} steps")
    return {"dispatches_equal_to_plain": len(held),
            "outputs_each": held[0][1], "launched": n}


def q_queue_fetch_check(s) -> dict:
    """The lazy queue fetch waits on its own cycle only: with a long
    sleep kernel enqueued on the current stream behind the cycle, the
    published queue's rows still arrive at once, where a copy on the
    current stream waits the sleep out."""
    from cook_tpu_torch.ops import telemetry
    q_top_up(s, 1_000)
    s.sched.step_cycle()
    s.sched.flush_status_updates()
    q = s.sched.pending_queues["default"]
    torch.cuda.synchronize()
    cycles = 100_000_000   # about 50 ms of the card's clock
    torch.cuda._sleep(cycles)
    w0 = sync_waits()
    t0 = time.perf_counter()
    n = len(q.uuids)
    touch_ms = (time.perf_counter() - t0) * 1e3
    side_ms = waits_since(w0).get("queue.rows", 0.0)
    torch.cuda.synchronize()
    probe = torch.zeros(n, dtype=torch.int32, device="cuda")
    torch.cuda._sleep(cycles)
    t1 = time.perf_counter()
    probe.cpu()
    same_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    if not side_ms < same_ms / 2:
        raise AssertionError(f"phase Q: the queue fetch waited "
                             f"{side_ms} ms behind a {same_ms} ms sleep")
    telemetry.count("queue.fetch_checked")
    return {"queue_rows": n, "rows_wait_ms_behind_sleep": side_ms,
            "touch_ms_behind_sleep": touch_ms,
            "current_stream_copy_ms_behind_sleep": same_ms}


def profile_pipelined_step(s, tries: int = 3) -> dict:
    """One depth-2 step under torch.profiler (CPU and CUDA activity):
    the card's busy time and idle share of the step, and whether the
    next cycle's kernels ran inside the host apply's window (device
    timestamps against the ``pipeline.apply`` range)."""
    import gc
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    drv = s.sched._pipeline
    real_apply = drv._apply

    def apply(scheduler, entry):
        with record_function("pipeline.apply"):
            return real_apply(scheduler, entry)

    drv._apply = apply
    try:
        for t in range(tries):
            q_top_up(s, 1_000)
            torch.cuda.synchronize()
            gc.collect()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                s.sched.step_cycle()
                wall = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
            s.sched.flush_status_updates()
            evs = prof.events()
            kern = [e for e in evs if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)]
            applies = [e for e in evs if e.name == "pipeline.apply"
                       and e.device_type == DeviceType.CPU]
            if not kern or not applies:
                continue
            a0 = min(e.time_range.start for e in applies)
            a1 = max(e.time_range.end for e in applies)
            inside = [e for e in kern if a0 <= e.time_range.start <= a1]
            before = [e for e in kern if e.time_range.start < a0]
            busy = sum(device_us(e) for e in prof.key_averages()) / 1e3
            return {"profiled_step_ms": wall, "busy_ms": busy,
                    "idle_share_of_profiled_step": 1.0 - busy / wall,
                    "device_activities": len(kern),
                    "apply_window_ms": (a1 - a0) / 1e3,
                    "activities_before_apply": len(before),
                    "activities_inside_apply": len(inside),
                    "device_ms_inside_apply": sum(
                        (e.time_range.end - e.time_range.start)
                        for e in inside) / 1e3,
                    "last_activity_end_after_apply_start_ms": (max(
                        e.time_range.end for e in kern) - a0) / 1e3,
                    "tries": t + 1}
    finally:
        drv._apply = real_apply
    return {"busy_ms": "not measured", "tries": tries}


def q_small_run(depth: int, device: str) -> list:
    """Q_SMALL's world at ``depth`` on ``device``: the launched pairs of
    each of ``Q_SMALL_STEPS`` steps, each topped up."""
    s = sched_world(device, depth, counted=True, **Q_SMALL)
    steps = []
    for i in range(Q_SMALL_STEPS):
        res = s.sched.step_cycle()
        s.sched.flush_status_updates()
        check_live(s, f"phase Q small d{depth} {device}")
        steps.append(launched_pairs(s, res))
        q_top_up(s, len(steps[-1]))
    s.sched.shutdown()
    return steps


def q_card_against_cpu() -> dict:
    """The reduced world (10,000 jobs, 500 hosts, seed 13, uuids from a
    counter) 4 steps at depth 0 and 4 at depth 2, on the card and with
    ``device="cpu"``: every step launches the same pairs on both."""
    out = {}
    for depth in (0, 2):
        t0 = time.perf_counter()
        runs = {"cuda": q_small_run(depth, "cuda"),
                "cpu": cpu_side("q_small", depth)}
        for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
            if a != b:
                raise AssertionError(f"phase Q small world depth {depth} "
                                     f"step {i}: card and CPU launched "
                                     f"different pairs")
        out[f"depth{depth}"] = [len(x) for x in runs["cuda"]]
        out[f"depth{depth}_wall_s"] = time.perf_counter() - t0
    return out


def phase_q() -> dict:
    """The Scheduler's production loop at bench_pipeline_driver's world:
    the depth-0 leg, then the depth-2 leg (the default), each counted
    on its own; on the depth-2 leg's store the checked steps, the
    queue-fetch check and a profiled step; then one leg without
    status shards (the updates applied on the cycle thread as they
    arrive) at depth 0 only (for the run's time), to read the shards'
    cost; then the reduced world
    on card and CPU.  Each leg's world is dropped before the next is
    built."""
    import gc
    counts, checks = {}, {"phase": "Q"}
    for depth in (0, 2):
        s = q_leg(depth)
        print(json.dumps(s.leg))
        counts[depth] = s.leg["launches_per_kernel"]
        checks[f"checked_depth{depth}"] = q_checked_steps(s)
        if depth == 2:
            checks["queue_fetch"] = q_queue_fetch_check(s)
            checks["profile_depth2"] = profile_pipelined_step(s)
        s.sched.shutdown()
        del s
        gc.collect()
    turns = {0: []}
    for depth in turns:
        s = q_leg(depth, shards=None)
        print(json.dumps(s.leg))
        turns[depth].append(s.leg["p50_ms"])
        s.sched.shutdown()
        del s
        gc.collect()
    checks["no_shards_p50_ms"] = turns
    checks["card_against_cpu_launched"] = q_card_against_cpu()
    print(json.dumps(checks))
    return {"sync": counts[0], "pipelined": counts[2]}


# --------------------------------------------- phase V: step_rebalance
# tests/test_rebalance.py:155-176 ("alice fills the cluster; bob's job
# waits") on half of phase S's hosts, RebalancerConfig
# defaults (safe_dru_threshold 1.0, min_dru_diff 0.5, max_preemption 64)
V_USERS, V_JOBS_EACH, V_NEW, V_HOSTS = 100, 100, 1_000, 2_500
V_CPUS, V_MEM = 16.0, 16_384.0
# every 100th job of the full cluster carries a max runtime of 1 ms:
# phase X's reapers find 1% of the running tasks past it
V_REAP_EVERY, V_REAP_MS = 100, 1


def v_world(device="cuda", hosts=V_HOSTS, users=V_USERS,
            each=V_JOBS_EACH, new=V_NEW):
    """The full cluster: ``users`` users (share 64 cpus, 65,536 MB) with
    ``each`` jobs of 16 cpus and 16,384 MB (every ``V_REAP_EVERY``-th
    with a max runtime of ``V_REAP_MS``), ``step_cycle`` until a step
    launches nothing; then a new user's ``new`` such jobs and one
    ``step_rank``."""
    from cook_tpu_torch.state import Job, Resources
    s = sched_world(device, 2, n_jobs=0, hosts=hosts, seed=S_SEED,
                    counted=True)
    s.users, s.each = users, each
    store = s.store
    jobs = []
    for u in range(users):
        user = f"user{u:04d}"
        store.set_share(user, "default", {"cpus": 64.0, "mem": 65536.0})
        jobs += [Job(uuid=s.uuid(), user=user, command="x",
                     priority=50, submit_time_ms=1000 + len(jobs),
                     resources=Resources(cpus=V_CPUS, mem=V_MEM),
                     **({"max_runtime_ms": V_REAP_MS}
                        if (len(jobs) + k) % V_REAP_EVERY == 0 else {}))
                 for k in range(each)]
    for i in range(0, len(jobs), 10_000):
        store.create_jobs(jobs[i:i + 10_000])
    t0 = time.perf_counter()
    fill, steps = 0, 0
    while True:
        res = s.sched.step_cycle()
        s.sched.flush_status_updates()
        steps += 1
        n = sum(len(r.launched_task_ids) for r in res.values())
        fill += n
        if n == 0 or steps > 4 * users:
            break
    s.fill = {"steps": steps, "launched": fill,
              "running": check_live(s, "phase V fill"),
              "fill_s": time.perf_counter() - t0}
    store.set_share("newcomer", "default", {"cpus": 64.0, "mem": 65536.0})
    s.newcomer = [Job(uuid=s.uuid(), user="newcomer", command="x",
                      priority=50, submit_time_ms=10**6 + i,
                      resources=Resources(cpus=V_CPUS, mem=V_MEM))
                  for i in range(new)]
    store.create_jobs(s.newcomer)
    v_split(s, device)
    return s


def v_split(s, device) -> None:
    """One ``step_rank`` and one ``step_match`` on the full cluster,
    counted on their own.  On the card every launch is recorded and
    replayed against its plain version, and the rank held against
    ``rank_kernel_compact``'s plain version on the same inputs, before
    anything else runs."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.sched import ranker as ranker_mod
    real, s.ranked = ranker_mod.rank_kernel_compact, []

    def rank_spy(inp, **kw):
        got = real(inp, **kw)
        s.ranked.append((inp, kw, got))
        return got

    ranker_mod.rank_kernel_compact = rank_spy
    telemetry.reset_all()
    try:
        with cuda_lib.recording() as s.split_calls:
            t0 = time.perf_counter()
            s.sched.step_rank()
            t1 = time.perf_counter()
            match = s.sched.step_match("default")["default"]
            t2 = time.perf_counter()
    finally:
        ranker_mod.rank_kernel_compact = real
    s.split_counts = telemetry.snapshot()
    s.sched.flush_status_updates()
    s.rank_ms, s.match_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    s.match = {"considered": match.considered,
               "placements": len(match.launched_job_uuids),
               "running": check_live(s, "phase V step_match")}
    s.split_checks = {}
    if device == "cuda":
        s.split_checks = {
            "replayed_equal_to_plain": replay_all(
                s.split_calls, "phase V step_rank/step_match"),
            "rank_max_abs_err_against_plain": split_rank_check(
                s.ranked, "phase V")}


def decision_key(store, d) -> tuple:
    return (d.job_uuid, d.hostname,
            tuple(store.instance(t).job_uuid for t in d.victim_task_ids),
            d.dru)


def phase_v(device="cuda", keep=False, **size):
    """``step_rebalance`` at full cluster: the ``backend="cpu"``
    rebalancer first (its ``_execute`` a no-op here), then the timed
    ``step_rebalance`` with
    every preemption call's inputs and result recorded; each call held
    against ``preemption_plain`` on the card bit for bit, each K2 launch
    replayed; the decisions equal to the cpu backend's; the victims
    FAILED and preempted; after one more ``step_cycle`` every
    beneficiary launched (a multi-victim one on its reserved host).
    With ``keep`` the world is returned beside the counts, its
    scheduler running (phase X's reapers)."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.ops import rebalance as reb
    from cook_tpu_torch.sched.rebalancer import Rebalancer
    s = v_world(device, **size)
    store, sched = s.store, s.sched
    pool = store.pools()[0]
    queue = sched.pending_queues[pool.name]
    cpu = Rebalancer(store, s.cfg, backend="cpu", device=device)
    cpu.elastic = sched.rebalancer.elastic
    cpu._execute = lambda decisions, clusters: None
    t0 = time.perf_counter()
    want = cpu.rebalance_pool(pool.name, pool.dru_mode, queue,
                              sched.clusters)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    want = [decision_key(store, d) for d in want]
    real = reb.preemption_kernel
    searched = []

    def spy(inp, device="cuda"):
        out = real(inp, device=device)
        searched.append((inp, out))
        return out

    real_execute = sched.rebalancer._execute
    execute_ms = []

    def execute(decisions, clusters):
        t = time.perf_counter()
        real_execute(decisions, clusters)
        execute_ms.append((time.perf_counter() - t) * 1e3)

    reb.preemption_kernel = spy
    sched.rebalancer._execute = execute
    telemetry.reset_all()
    try:
        with cuda_lib.recording() as calls:
            t0 = time.perf_counter()
            decisions = sched.step_rebalance()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        reb.preemption_kernel = real
        sched.rebalancer._execute = real_execute
    counts = telemetry.snapshot()
    got = decisions.get(pool.name, [])
    keys = [decision_key(store, d) for d in got]
    if keys != want:
        raise AssertionError(f"phase V: {len(keys)} decisions differ from "
                             f"the cpu backend's {len(want)}")
    if not got:
        raise AssertionError("phase V: no preemption decided")
    if device == "cuda":
        missing = [k for k in ("scan", "sort", "greedy")
                   if s.split_counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"phase V: step_rank/step_match launched "
                                 f"no {missing}")
        if counts.get("scan", 0) != len(searched):
            raise AssertionError(f"phase V: {counts.get('scan')} K2 "
                                 f"launches for {len(searched)} searches")
        for inp, out in searched:
            plain = reb.preemption_plain(inp)
            for f in plain._fields:
                max_err(getattr(out, f), getattr(plain, f))
    victims = [t for d in got for t in d.victim_task_ids]
    for t in victims:
        inst = store.instance(t)
        if inst.status.value != "failed" or not inst.preempted:
            raise AssertionError(f"phase V: victim {t} is {inst.status} "
                                 f"preempted={inst.preempted}")
    sched.flush_status_updates()
    res = sched.step_cycle()
    sched.flush_status_updates()
    check_live(s, "phase V after")
    placed = {}
    for r in res.values():
        for tid in r.launched_task_ids:
            inst = store.instance(tid)
            placed[inst.job_uuid] = inst.hostname
    missing = [d.job_uuid for d in got if d.job_uuid not in placed]
    if missing:
        raise AssertionError(f"phase V: {len(missing)} beneficiaries did "
                             f"not launch")
    moved = [d.job_uuid for d in got if len(d.victim_task_ids) > 1
             and placed[d.job_uuid] != d.hostname]
    if moved:
        raise AssertionError(f"phase V: reserved beneficiaries launched "
                             f"elsewhere: {moved[:5]}")
    out = {"phase": "V", "world": {"hosts": s.hosts, "users": s.users,
                                   "jobs_each": s.each,
                                   "newcomer_jobs": len(s.newcomer),
                                   "build_s": s.build_s, **s.fill},
           "step_rank_ms": s.rank_ms, "step_match_ms": s.match_ms,
           "step_match": s.match, "split_checks": s.split_checks,
           "split_launches_per_kernel": s.split_counts,
           "step_rebalance_ms": ms, "cpu_backend_ms": cpu_ms,
           "decisions": len(got), "victims": len(victims),
           "victims_per_decision": sorted(
               {len(d.victim_task_ids) for d in got}),
           "decisions_equal_to_cpu_backend": len(want),
           "preemption_calls": len(searched),
           "execute_ms": execute_ms,
           "beneficiaries_launched": len(got),
           "launches_per_kernel": counts}
    if device == "cuda" and searched:
        one = searched[0][0]
        out["T"], out["H"] = int(one.task_dru.shape[0]), \
            int(one.spare.shape[0])
        out["kernel_ms_a_call"] = cuda_ms(lambda: real(one), 20)
        out["kernel_device_ms_a_call"] = device_ms(lambda: real(one), 20)
        out["plain_ms_a_call"] = cuda_ms(
            lambda: reb.preemption_plain(one), 5)
        out["replayed_equal_to_plain"] = replay_all(calls, "phase V")
    print(json.dumps(out))
    counts = {"rebalancer": counts, "split": s.split_counts}
    if keep:
        return counts, s
    sched.shutdown()
    return counts


# ------------------------------------- phase W: admission at deployment size
W_STEPS = 6
W_TARGET_LEVEL = 0.5
SATURATION_KEYS = ("group_commit_queue", "follower_staleness", "cycle_p99",
                   "audit_queue", "launch_tokens", "journal_head")


def saturation_gauges() -> dict:
    """The ``cook_saturation`` gauges the last sweep published."""
    from cook_tpu_torch.utils.metrics import registry
    return {labels["resource"]: v
            for labels, v in registry.series("cook_saturation")}


def w_sweep(s) -> dict:
    """One ``monitor.sweep()`` on the host clock, with the saturation it
    published and the controller's state after it (the sweep feeds the
    controller one ``decide``)."""
    t0 = time.perf_counter()
    counts = s.sched.monitor.sweep()
    ms = (time.perf_counter() - t0) * 1e3
    return {"sweep_ms": ms, "counts": counts,
            "saturation": saturation_gauges(),
            "admission": s.sched.admission.state()}


def w_throttle(s, gauges: dict, target=W_TARGET_LEVEL) -> list:
    """``decide`` with ``cycle_p99`` at 1.0 (the objective's whole
    budget; the other gauges as given) until the level is at most
    ``target``; each decide's level and stage."""
    ctrl = s.sched.admission
    forced = dict(gauges, cycle_p99=1.0)
    steps = []
    while ctrl.level > target:
        ctrl.decide(forced)
        steps.append({"level": ctrl.level, "stage": ctrl.stage})
        if len(steps) > 50:
            raise AssertionError(f"admission level {ctrl.level} after "
                                 f"50 decides at cycle_p99 1.0")
    return steps


def w_recover(s) -> list:
    """``decide`` with every gauge at 0 until the controller is back at
    stage 0 and level 1.0.  The ladder steps down one stage per
    ``stage_hold_seconds`` of recovery on the store's clock, so the
    clock is moved on by the hold before each decide and put back
    after."""
    ctrl, store = s.sched.admission, s.store
    hold_ms = int(ctrl.ac.stage_hold_seconds * 1000) + 1
    real_clock, offset = store.clock, [0]
    store.clock = lambda: real_clock() + offset[0]
    steps = []
    try:
        while ctrl.stage > 0 or ctrl.level < 1.0:
            offset[0] += hold_ms
            ctrl.decide({k: 0.0 for k in SATURATION_KEYS})
            steps.append({"level": ctrl.level, "stage": ctrl.stage})
            if len(steps) > 100:
                raise AssertionError("admission: no recovery in 100 "
                                     "decides")
    finally:
        store.clock = real_clock
    return steps


def w_split(s, device) -> dict:
    """``step_rank`` + ``step_match`` at the controller's level, counted
    and recorded: each ``admission_limit`` call's limit must be
    ``max_jobs_considered`` (or the head-of-queue backoff's smaller
    window), its window ``int(limit * level)``, and the match's cycle
    record must hold one ``admission-throttled`` skip per job cut from
    the window; on the card every launch is replayed against its plain
    version."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.utils.flight import recorder
    m, ctrl = s.sched.matcher, s.sched.admission
    max_considered = s.cfg.matcher_for_pool("default").max_jobs_considered
    backoff = {p: b.num_considerable for p, b in m._backoff.items()}
    windows = []
    real = m.admission_limit

    def spy(pool, ranked, limit):
        scaled = real(pool, ranked, limit)
        windows.append({"pool": pool, "limit": limit, "scaled": scaled,
                        "queue": len(ranked)})
        return scaled

    m.admission_limit = spy
    telemetry.reset_all()
    try:
        with cuda_lib.recording() as calls:
            t0 = time.perf_counter()
            s.sched.step_rank()
            t1 = time.perf_counter()
            res = s.sched.step_match()
            t2 = time.perf_counter()
    finally:
        del m.admission_limit
    counts = telemetry.snapshot()
    skips = recorder.recent(1)[0]["skip_reasons"].get(
        "admission-throttled", 0)
    s.sched.flush_status_updates()
    live = check_live(s, "admission split")
    for w in windows:
        limit = min(backoff.get(w["pool"], max_considered), max_considered)
        want = (w["limit"] if ctrl.level >= 1.0 or w["limit"] <= 1
                else max(1, int(w["limit"] * ctrl.level)))
        if w["limit"] != limit or w["scaled"] != want:
            raise AssertionError(f"admission window {w} at level "
                                 f"{ctrl.level}: want {want}")
    cut = sum(max(0, min(w["limit"], w["queue"]) - w["scaled"])
              for w in windows)
    if skips != cut:
        raise AssertionError(f"{skips} admission-throttled skips for a "
                             f"cut of {cut}")
    considered = {p: r.considered for p, r in res.items()}
    out = {"level": ctrl.level, "stage": ctrl.stage, "windows": windows,
           "max_jobs_considered": max_considered,
           "backoff_windows": backoff, "considered": considered, "throttled_skips": skips,
           "launched": sum(len(r.launched_task_ids) for r in res.values()),
           "live": live, "step_rank_ms": (t1 - t0) * 1e3,
           "step_match_ms": (t2 - t1) * 1e3, "launches_per_kernel": counts,
           "pairs": launched_pairs(s, res)}
    if any(c > w["scaled"] for c, w in zip(considered.values(), windows)):
        raise AssertionError(f"considered {considered} past the windows "
                             f"{windows}")
    if device == "cuda":
        missing = [k for k in ("scan", "sort", "greedy")
                   if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"admission split: no {missing} launched")
        out["replayed_equal_to_plain"] = replay_all(calls,
                                                    "admission split")
    return out


def w_card_against_cpu() -> dict:
    """Phase Q's reduced world (10,000 jobs, 500 hosts, uuids from a
    counter) with admission enabled, on the card and with
    ``device="cpu"``: two ``step_cycle``s, the controller driven to
    level 0.5 or below, then ``step_rank`` + ``step_match``; every step
    launches the same pairs on both."""
    runs = {}
    for device in ("cuda", "cpu"):
        s = sched_world(device, 2, counted=True, admission=True, **Q_SMALL)
        steps = []
        for i in range(2):
            res = s.sched.step_cycle()
            s.sched.flush_status_updates()
            check_live(s, f"phase W small {device} step {i}")
            steps.append(launched_pairs(s, res))
            q_top_up(s, len(steps[-1]))
        w_throttle(s, {"cycle_p99": 1.0})
        split = w_split(s, device)
        steps.append(split.pop("pairs"))
        runs[device] = (steps, split["level"], split["windows"])
        s.sched.shutdown()
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError("phase W small world: card and CPU differ")
    return {"launched": [len(x) for x in runs["cuda"][0]],
            "level": runs["cuda"][1], "windows": runs["cuda"][2]}


def phase_w(device="cuda", **size) -> dict:
    """Adaptive admission at phase Q's world (100,000 jobs from
    ``_driver_jobs``, seed 13, 5,000 hosts, ``Config()`` with
    ``admission.enabled``, depth 2, 4 status shards): ``W_STEPS``
    ``step_cycle``s topped up as phase Q's, a timed ``monitor.sweep()``
    after each (the saturation it published, the controller's state),
    one sweep under cProfile; then the controller driven to level 0.5
    or below, ``step_rank`` + ``step_match`` counted, recorded and
    replayed (``w_split``), the controller driven back to stage 0; then
    the reduced world on card and CPU (the card only).  The flight
    recorder is cleared first: the sweep's ``cycle_p99`` reads the
    recorder's last ``slo.cycle_window`` cycles, and the earlier phases'
    profiled and checked steps are no cycles of this world."""
    from cook_tpu_torch.utils.flight import recorder
    recorder.reset()
    t0 = time.perf_counter()
    s = sched_world(device, 2, admission=True, **size)
    sweeps = []
    for i in range(W_STEPS):
        res = s.sched.step_cycle()
        s.sched.flush_status_updates()
        n = sum(len(r.launched_task_ids) for r in res.values())
        check_live(s, f"phase W step {i}")
        q_top_up(s, n)
        sweeps.append({"step": i, "launched": n, **w_sweep(s)})
        print(json.dumps({"phase": "W", **sweeps[-1]}))
    prof_ms, prof_own = profiled_own(s.sched.monitor.sweep)
    throttle = w_throttle(s, saturation_gauges())
    split = w_split(s, device)
    split.pop("pairs")
    recover = w_recover(s)
    s.sched.shutdown()
    world_s = time.perf_counter() - t0
    small = w_card_against_cpu() if device == "cuda" else None
    sweep_ms = [x["sweep_ms"] for x in sweeps]
    print(json.dumps({
        "phase": "W", "world": {"jobs": size.get("n_jobs", Q_JOBS),
                                "hosts": s.hosts,
                                "users": s.n_users, "build_s": s.build_s},
        "sweep_ms": sweep_ms, "sweep_ms_median": statistics.median(sweep_ms),
        "profiled_sweep": {"sweep_ms": prof_ms, "top_own_ms": prof_own},
        "throttle": throttle, "split": split, "recover": recover,
        "card_against_cpu": small, "world_s": world_s,
        "wall_s": time.perf_counter() - t0}))
    return split["launches_per_kernel"]


# ------------------------------------------ phase X: faults and reapers
def fallbacks(kernel: str) -> float:
    from cook_tpu_torch.utils.metrics import registry
    return sum(v for labels, v in registry.series("cook_kernel_fallback")
               if labels.get("kernel") == kernel)


def guard_rebalancer(sched, guard) -> list:
    """The rebalancer's pool passes (its own loop's thread) hold ``guard``,
    the lock a replaying step holds from its drain to its checks: no
    launch of the rebalancer falls in a drain, where the recording is
    closed and the replays' launches are counted, so each is recorded
    and replayed at the next drain.  Returns the passes' list, one entry
    a pass."""
    passes, rebalance_pool = [], sched.rebalancer.rebalance_pool

    def guarded(*a, **kw):
        with guard:
            passes.append(time.perf_counter())
            return rebalance_pool(*a, **kw)

    sched.rebalancer.rebalance_pool = guarded
    return passes


def flight_seq() -> int:
    from cook_tpu_torch.utils.flight import recorder
    return recorder.last_seq()


def degraded_since(seq0: int, counter0: float) -> dict:
    """The cycles degraded from the fused path to the split path since
    flight record ``seq0``: the rise of the ``fused.pool_cycle``
    fallback counter from ``counter0`` and the ``fused.dispatch-fallback``
    notes on the flight records after ``seq0`` (``Scheduler.step_cycle``
    makes both when it catches a failed fused cycle)."""
    from cook_tpu_torch.utils.flight import recorder
    summary = recorder.summary(seq0)
    return {"fallback_counter": fallbacks("fused.pool_cycle") - counter0,
            "flight_notes": summary.get("faults", {}).get(
                "fused.dispatch-fallback", 0),
            "flight_records": summary.get("cycles", 0)}


def x_leg(depth: int, device: str):
    """The reduced world (10,000 jobs, 500 hosts, uuids from a counter)
    at ``depth`` on ``device``, nothing topped up (each step's change is
    the previous step's launches: status changes only): a cold step, a
    step that must take the delta path, one with ``delta.extract``
    armed, one more, one with ``delta.apply`` armed, one more (each
    armed step must repack with reason ``fault`` and each following one
    take the delta path again), then one with ``fused.dispatch`` armed
    (the cycle degrades to the split path: one more
    ``cook_kernel_fallback{kernel="fused.pool_cycle"}``, the note on its
    flight record; on the card its launches counted, recorded and
    replayed) and one more.  On the card every dispatched wire is held
    against ``megacycle_plain`` (``checking_dispatches``)."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.utils.faults import injector
    from cook_tpu_torch.utils.flight import recorder
    s = sched_world(device, depth, counted=True, **Q_SMALL)
    card = device == "cuda"
    leg = SimpleNamespace(pairs=[], paths=[])

    def step(armed=None):
        injector.clear()
        if armed:
            injector.arm(armed, schedule=[0])
        n0 = len(seen.dispatches)
        try:
            res = s.sched.step_cycle()
        finally:
            injector.clear()
        s.sched.flush_status_updates()
        check_live(s, f"phase X d{depth} {device}")
        leg.pairs.append(launched_pairs(s, res))
        leg.paths.append(seen.dispatches[n0:])

    def expect(path, what):
        if path not in leg.paths[-1]:
            raise AssertionError(f"phase X d{depth} {device} {what}: "
                                 f"paths {leg.paths}")

    t0 = time.perf_counter()
    with checking_dispatches(s, plain=card) as seen:
        step()
        step()
        expect("delta", "status-only step")
        for point in ("delta.extract", "delta.apply"):
            before = fallbacks(point)
            step(point)
            expect("fault", point)
            if fallbacks(point) != before + 1:
                raise AssertionError(f"phase X: {point} fallback not "
                                     f"counted")
            step()
            expect("delta", f"after {point}")
        before = fallbacks("fused.pool_cycle")
        telemetry.reset_all()
        with cuda_lib.recording() as calls:
            step("fused.dispatch")
        leg.counts = telemetry.snapshot()
        rec = recorder.recent(1)[0]
        if fallbacks("fused.pool_cycle") != before + 1 or \
                rec["faults"].get("fused.dispatch-fallback") != 1:
            raise AssertionError(f"phase X d{depth}: degraded cycle not "
                                 f"counted: {rec['faults']}")
        if not leg.pairs[-1]:
            raise AssertionError(f"phase X d{depth}: the degraded cycle "
                                 f"launched nothing")
        step()
    leg.wall_s = time.perf_counter() - t0
    s.sched.shutdown()
    if card:
        faulted = [i for i, p in enumerate(seen.dispatches) if p == "fault"]
        held = {i for i, _n in seen.held}
        if len(faulted) != 2 or not set(faulted) <= held:
            raise AssertionError(f"phase X d{depth}: fault repacks "
                                 f"{faulted}, held {sorted(held)}")
        missing = [k for k in ("scan", "sort", "greedy")
                   if leg.counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"phase X d{depth}: the degraded cycle "
                                 f"launched no {missing}")
        leg.replayed = replay_all(calls, f"phase X d{depth} degraded")
        leg.dispatches_equal_to_plain = len(seen.held)
    return leg


def x_reapers(v) -> dict:
    """One timed ``step_reapers`` on phase V's full cluster: every
    running task of a job with ``V_REAP_MS`` of max runtime is killed
    (``max-runtime-exceeded``), nothing else."""
    from cook_tpu_torch.state import Reasons
    sched, store = v.sched, v.store
    sched.flush_status_updates()
    running = store.running_instances()
    due = sorted(inst.task_id for job, inst in running
                 if job.max_runtime_ms == V_REAP_MS)
    t0 = time.perf_counter()
    killed = sched.step_reapers()
    ms = (time.perf_counter() - t0) * 1e3
    sched.flush_status_updates()
    if sorted(killed) != due or not due:
        raise AssertionError(f"phase X reapers: killed {len(killed)}, "
                             f"due {len(due)}")
    for t in killed:
        inst = store.instance(t)
        if inst.status.value != "failed" or \
                inst.reason_code != Reasons.MAX_RUNTIME_EXCEEDED.code:
            raise AssertionError(f"phase X reapers: {t} is {inst.status} "
                                 f"reason {inst.reason_code}")
    sched.shutdown()
    return {"reapers_ms": ms, "running": len(running),
            "killed": len(killed)}


def phase_x(v) -> dict:
    """Faults on the reduced world at depths 0 and 2, on the card and
    with ``device="cpu"`` (the same pairs every step), then the reapers
    on phase V's full cluster ``v``."""
    t0 = time.perf_counter()
    out, counts = {"phase": "X"}, {}
    for depth in (0, 2):
        card, cpu = x_leg(depth, "cuda"), cpu_side("x_leg", depth)
        for i, (a, b) in enumerate(zip(card.pairs, cpu.pairs,
                                       strict=True)):
            if a != b:
                raise AssertionError(f"phase X depth {depth} step {i}: "
                                     f"card and CPU launched different "
                                     f"pairs")
        counts[depth] = card.counts
        out[f"depth{depth}"] = {
            "launched": [len(x) for x in card.pairs],
            "paths": card.paths, "cpu_paths": cpu.paths,
            "dispatches_equal_to_plain": card.dispatches_equal_to_plain,
            "degraded_launches_per_kernel": card.counts,
            "degraded_replayed_equal_to_plain": card.replayed,
            "card_wall_s": card.wall_s, "cpu_wall_s": cpu.wall_s}
    out["reapers"] = x_reapers(v)
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return {k: counts[0].get(k, 0) + counts[2].get(k, 0)
            for k in set(counts[0]) | set(counts[2])}


# ------------------------------------------ phase Y: the simulator
# generate_example_trace(n_jobs=Y_JOBS, n_users=200, span_ms=10_000,
# duration_ms=10_000) over generate_example_hosts(1_000), uuids fixed as
# run_pipeline_parity fixes them, Config() defaults (fused, depth 2):
# the burst lands pending behind 1,000 hosts within the first cycles and
# drains at most max_jobs_considered (1,000) a cycle.  5,000 jobs for
# the run's time (PERF.md section 4); users and hosts are not cut
Y_JOBS, Y_USERS, Y_HOSTS = 5_000, 200, 1_000
Y_SPAN_MS = Y_DURATION_MS = 10_000
Y_SMALL = {"n_jobs": 500, "n_users": 50, "hosts": 100}  # card = CPU
# summary() and flight-summary fields read off the host's clock
Y_HOST_CLOCK = ("match_cycle_p50_ms", "match_cycle_p99_ms",
                "rank_cycle_p50_ms", "placements_per_wall_s")
Y_FLIGHT_HOST_CLOCK = ("cycle_ms_p50", "cycle_ms_p99", "detail_ms",
                       "sync_wait_ms")


class ReplayingRecorder:
    """Records every stage-wrapper launch between two ``drain`` calls and
    replays each against its plain version at the ``drain``, on the
    inputs it was launched with (the resident buffers are scattered into
    only at the next stage); ``stacked``, for many small launches of K5,
    replays them through :func:`replay_stacked`.  The replays' own
    launches are counted by the wrappers' launchers; ``launches`` takes
    them off the counts."""

    def __init__(self, what: str, stacked: bool = False):
        from cook_tpu_torch.ops import cuda_lib, telemetry
        self.cuda_lib, self.telemetry, self.what = cuda_lib, telemetry, what
        self.replay = replay_stacked if stacked else replay_all
        self.extra, self.held, self.replayed = {}, {}, 0
        self._ctx = None

    def start(self) -> None:
        self.telemetry.reset_all()
        self._ctx = self.cuda_lib.recording()
        self.calls = self._ctx.__enter__()

    def drain(self) -> None:
        calls = self.calls
        self._ctx.__exit__(None, None, None)
        try:
            if calls:
                before = self.telemetry.snapshot()
                for k, n in self.replay(calls, self.what).items():
                    self.held[k] = self.held.get(k, 0) + n
                after = self.telemetry.snapshot()
                for k, n in after.items():
                    self.extra[k] = (self.extra.get(k, 0) + n
                                     - before.get(k, 0))
                self.replayed += len(calls)
        finally:
            self._ctx = self.cuda_lib.recording()
            self.calls = self._ctx.__enter__()

    def stop(self) -> dict:
        """Replay what is left; the launches counted in between, less the
        replays'."""
        self.drain()
        self._ctx.__exit__(None, None, None)
        self._ctx = None
        return {k: n - self.extra.get(k, 0)
                for k, n in self.telemetry.snapshot().items()}

    def unreplayed(self, counts: dict) -> dict:
        """Where a replay launches each recorded call's kernels again,
        the path's launches ``counts`` (from ``stop``) equal the
        replays' by kernel; the kernels where they differ, with both
        counts: a launch made while nothing recorded."""
        return {k: (counts.get(k, 0), self.extra.get(k, 0))
                for k in set(counts) | set(self.extra)
                if counts.get(k, 0) != self.extra.get(k, 0)}


def y_trace(n_jobs=Y_JOBS, n_users=Y_USERS, hosts=Y_HOSTS, seed=SEED):
    from cook_tpu_torch.sim import (generate_example_hosts,
                                    generate_example_trace, load_hosts,
                                    load_trace)
    entries = generate_example_trace(n_jobs=n_jobs, n_users=n_users,
                                     seed=seed, span_ms=Y_SPAN_MS,
                                     duration_ms=Y_DURATION_MS)
    for i, e in enumerate(entries):
        e["uuid"] = f"00000000-0000-4000-8000-{i:012d}"
    return load_trace(entries), load_hosts(generate_example_hosts(hosts))


def y_check_live(sim, what: str) -> int:
    """No host of the simulator's cluster over its capacity and no job
    with two live instances; returns the live count."""
    caps = {h.hostname: np.array([h.capacity.cpus, h.capacity.mem])
            for h in sim.cluster._hosts.values()}
    used, per_job = {}, {}
    live = sim.store.running_instances(clone=False)
    for job, inst in live:
        u = used.setdefault(inst.hostname, np.zeros(2))
        u += (job.resources.cpus, job.resources.mem)
        per_job[job.uuid] = per_job.get(job.uuid, 0) + 1
    over = [h for h, u in used.items() if (u > caps[h]).any()]
    if over:
        raise AssertionError(f"{what}: hosts oversubscribed: {over[:5]}")
    twice = [u for u, n in per_job.items() if n > 1]
    if twice:
        raise AssertionError(f"{what}: jobs with two live instances: "
                             f"{twice[:5]}")
    return len(live)


def y_run(device="cuda", record=False, **size):
    """One ``Simulator.run`` of ``y_trace(**size)`` with ``Config()``
    defaults on ``device``; the store is checked at every tick, and with
    ``record`` every launch is replayed against its plain version at the
    tick after it.  Returns (result, sim, wall s, launches, replays)."""
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.sim import Simulator
    trace, hosts = y_trace(**size)
    sim = Simulator(trace, hosts, config=Config(), device=device)
    rec = ReplayingRecorder("phase Y1") if record else None
    ticks = [0]

    def on_tick(now_ms):
        ticks[0] += 1
        y_check_live(sim, f"phase Y {device} tick {ticks[0]}")
        if rec is not None:
            rec.drain()

    sim.on_tick = on_tick
    if rec is not None:
        rec.start()
    t0 = time.perf_counter()
    try:
        res = sim.run()
    finally:
        counts = rec.stop() if rec is not None else None
    wall = time.perf_counter() - t0
    sim.scheduler.shutdown()
    if res.completed != res.total:
        raise AssertionError(f"phase Y {device}: {res.completed} of "
                             f"{res.total} jobs completed")
    return res, sim, wall, counts, rec, ticks[0]


def y_comparable(res) -> tuple:
    """(task records less the task id, summary less the host clock)."""
    recs = [{k: v for k, v in r.items() if k != "task"}
            for r in res.task_records]
    summ = {k: v for k, v in res.summary().items() if k not in Y_HOST_CLOCK}
    summ["flight"] = {k: v for k, v in summ["flight"].items()
                      if k not in Y_FLIGHT_HOST_CLOCK}
    return recs, summ


def phase_y(device="cuda", y1=None, small=None, parity=None) -> dict:
    """The simulator on the card: Y1 one world at full width, counted
    (path ``simulator``); Y2 the reduced world on the card and with
    ``device="cpu"``; Y3 ``run_pipeline_parity``; Y4 ``run_overload()``;
    Y5 ``python -m cook_tpu_torch.sim`` in process."""
    import contextlib
    import io
    import tempfile

    from cook_tpu_torch.sim.__main__ import main as sim_main
    from cook_tpu_torch.sim.overload import run_overload
    from cook_tpu_torch.sim.simulator import run_pipeline_parity
    t0 = time.perf_counter()
    card = device == "cuda"
    out = {"phase": "Y"}
    res, _sim, wall, counts, rec, ticks = y_run(
        device, record=card, **(y1 or {}))
    summ = res.summary()
    mw = res.match_wall_ms
    out["y1"] = {
        "jobs": res.total, "completed": res.completed, "wall_s": wall,
        "ticks": ticks, "makespan_virtual_s": summ["makespan_virtual_s"],
        "step_cycle_calls": len(mw),
        "step_cycle_ms_p50": float(np.percentile(mw, 50)),
        "step_cycle_ms_p99": float(np.percentile(mw, 99)),
        "placements": res.placements, "preemptions": res.preemptions,
        "wait_time_p50_s": summ["wait_time_p50_s"],
        "wait_time_p99_s": summ["wait_time_p99_s"],
        "flight": summ["flight"]}
    if card:
        missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"phase Y1: kernels not launched: "
                                 f"{missing}")
        out["y1"]["launches_per_kernel"] = counts
        out["y1"]["replayed_equal_to_plain"] = rec.replayed
        out["y1"]["replayed_by_wrapper"] = rec.held
    print(json.dumps(out["y1"]))
    del out["y1"]["flight"]   # printed above
    del res, _sim

    small = small or Y_SMALL
    t1 = time.perf_counter()
    legs = [y_run(d, **small) for d in (device, "cpu")]
    got = [y_comparable(leg[0]) for leg in legs]
    if got[0][0] != got[1][0]:
        raise AssertionError("phase Y2: card and CPU task records differ")
    if got[0][1] != got[1][1]:
        diff = {k: (got[0][1].get(k), got[1][1].get(k))
                for k in set(got[0][1]) | set(got[1][1])
                if got[0][1].get(k) != got[1][1].get(k)}
        raise AssertionError(f"phase Y2: summaries differ: {diff}")
    out["y2"] = {"jobs": small["n_jobs"], "records": len(got[0][0]),
                 "card_wall_s": legs[0][2], "cpu_wall_s": legs[1][2],
                 "wall_s": time.perf_counter() - t1}
    del legs, got

    t1 = time.perf_counter()
    par = run_pipeline_parity(device=device, **(parity or {
        "seed": 3, "n_jobs": 600, "n_hosts": 40, "depth": 2}))
    if not par["ok"]:
        raise AssertionError(f"phase Y3: pipeline parity failed: {par}")
    out["y3"] = {k: par[k] for k in (
        "jobs", "depth", "sync_completed", "pipelined_completed",
        "launched_equal", "pipelined_conflicts", "sync_placements",
        "pipelined_placements")}
    out["y3"]["wall_s"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    ov = run_overload(device=device)
    if not ov["ok"]:
        raise AssertionError(f"phase Y4: overload replay failed: {ov}")
    out["y4"] = {**{k: ov[k] for k in (
        "offered", "admitted", "shed_total", "completed",
        "committed_writes_lost", "wait_p99_s")},
        "max_stage": ov["admission"]["max_stage"],
        "wall_s": time.perf_counter() - t1}

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = Path(tmp) / "records.csv"
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = sim_main(["--device", device, "--out", str(csv_path)])
        rows = len(csv_path.read_text().splitlines()) - 1
    if rc != 0 or rows <= 0:
        raise AssertionError(f"phase Y5: exit {rc}, {rows} records")
    y5 = json.loads(printed.getvalue())
    out["y5"] = {"exit": rc, "records": rows,
                 "jobs_completed": y5["jobs_completed"],
                 "jobs_total": y5["jobs_total"],
                 "wall_s": time.perf_counter() - t1}
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return counts or {}


# ---------------------------------------------- phase Z: the REST plane
# bench.py::bench_rest_plane's world (:1729-1790): a journaled store,
# Config() with pipeline.depth 0, 200 hosts of 64 cpus and 65,536 MB,
# status_queue_shards=2; 4 JobClient writers submit 2,000 jobs of 1 cpu
# and 64 MB in batches of 20
Z_JOBS, Z_BATCH, Z_WRITERS, Z_HOSTS = 2_000, 20, 4, 200
Z_CYCLES = 20
Z_READERS = (1, 4, 8)
Z_SMALL = {"n_jobs": 500, "hosts": 50}    # card = CPU, one writer
Z_TASK_ID = re.compile(r"\b(?!00000000-)[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]"
                       r"{3}-[89ab][0-9a-f]{3}-[0-9a-f]{12}\b")


def z_stack(device="cuda", directory=None, hosts=Z_HOSTS, shards=2,
            clock=None):
    """The REST deployment: a store (journaled in ``directory``), the
    fake cluster, the port's ``Scheduler`` on ``device`` and an
    ``ApiServer`` on a free localhost port."""
    from cook_tpu_torch.cluster import FakeCluster, FakeHost
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.rest import ApiServer, CookApi
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import Resources, Store
    store = Store.open(directory) if directory else Store()
    if clock is not None:
        store.clock = clock
    cfg = Config()
    cfg.pipeline.depth = 0
    cluster = FakeCluster("fake-1", [
        FakeHost(f"h{i}", Resources(cpus=64.0, mem=65536.0))
        for i in range(hosts)])
    sched = Scheduler(store, cfg, [cluster], status_queue_shards=shards,
                      device=device)
    api = CookApi(store, scheduler=sched, config=cfg, admins=["admin"])
    server = ApiServer(api)
    server.start()
    return SimpleNamespace(store=store, cluster=cluster, cfg=cfg,
                           sched=sched, api=api, server=server)


def z_threads(n, fn) -> tuple:
    """``fn(worker, latencies)`` on ``n`` threads; (wall s, latencies ms,
    what each returned)."""
    import threading
    lats = [[] for _ in range(n)]
    rets = [None] * n

    def run(i):
        rets[i] = fn(i, lats[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, [x for sub in lats for x in sub], rets


def z_cycles(z, rec=None, cycles=Z_CYCLES) -> list:
    """``step_cycle`` until no job waits or ``cycles`` have run; the
    launched pairs of each; the store checked after each."""
    from cook_tpu_torch.state import JobState
    pairs = []
    for i in range(cycles):
        res = z.sched.step_cycle()
        z.sched.flush_status_updates()
        if rec is not None:
            rec.drain()
        check_live(z, f"phase Z cycle {i}")
        pairs.append(launched_pairs(z, res))
        if not z.store.jobs_where(lambda j: j.state is JobState.WAITING):
            break
    return pairs


def z_submit(z, n_jobs, writers, batch, uuids=None) -> dict:
    """``writers`` JobClients submit ``n_jobs`` jobs in batches; the
    acknowledged uuids, submissions a second and the request p50/p99."""
    from cook_tpu_torch.client import JobClient
    per_writer = n_jobs // (writers * batch)

    def writer(i, lats):
        client = JobClient(z.server.url, user=f"bench{i}")
        acked = []
        for b in range(per_writer):
            specs = [{"command": "true", "cpus": 1.0, "mem": 64.0}
                     for _ in range(batch)]
            if uuids is not None:
                for k, s in enumerate(specs):
                    s["uuid"] = uuids[(i * per_writer + b) * batch + k]
            t0 = time.perf_counter()
            acked += client.submit(specs)
            lats.append((time.perf_counter() - t0) * 1e3)
        return acked

    wall, lats, rets = z_threads(writers, writer)
    acked = [u for r in rets for u in r]
    if len(acked) != per_writer * writers * batch:
        raise AssertionError(f"phase Z: {len(acked)} submissions "
                             f"acknowledged")
    return {"acked": acked, "jobs_per_s": len(acked) / wall,
            "request_p50_ms": float(np.percentile(lats, 50)),
            "request_p99_ms": float(np.percentile(lats, 99)),
            "wall_s": wall}


def z_read_back(z, uuids, readers) -> dict:
    """GET /jobs/{uuid} for every uuid over ``readers`` threads; each
    job's status and instance hosts must equal the store's."""
    from cook_tpu_torch.client import JobClient
    per = -(-len(uuids) // readers)

    def reader(i, lats):
        client = JobClient(z.server.url, user="reader")
        bad = []
        for u in uuids[i * per:(i + 1) * per]:
            t0 = time.perf_counter()
            body = client.job(u)
            lats.append((time.perf_counter() - t0) * 1e3)
            job = z.store.job(u)
            hosts = [z.store.instance(t).hostname for t in job.instances]
            if body["status"] != job.state.value or \
                    [x["hostname"] for x in body["instances"]] != hosts:
                bad.append(u)
        return bad

    wall, lats, rets = z_threads(readers, reader)
    bad = [u for r in rets for u in r]
    if bad:
        raise AssertionError(f"phase Z3: {len(bad)} jobs read back unlike "
                             f"the store: {bad[:3]}")
    return {"qps": len(uuids) / wall,
            "p50_ms": float(np.percentile(lats, 50)),
            "p99_ms": float(np.percentile(lats, 99))}


def z_norm(value, names):
    """``value`` with each task id (``new_uuid()``, minted at random)
    renamed by order of first appearance."""
    if isinstance(value, str):
        return Z_TASK_ID.sub(lambda m: names.setdefault(
            m.group(0), f"task-{len(names)}"), value)
    if isinstance(value, list):
        return [z_norm(v, names) for v in value]
    if isinstance(value, dict):
        return {z_norm(k, names): z_norm(v, names) for k, v in value.items()}
    return value


def z_small_leg(device, n_jobs, hosts) -> tuple:
    """One writer with fixed uuids against a store with a pinned clock:
    the launched pairs of each cycle and every job's body."""
    from cook_tpu_torch.client import JobClient
    now = [1_700_000_000_000]
    z = z_stack(device, hosts=hosts, shards=None, clock=lambda: now[0])
    try:
        uuids = [f"00000000-0000-4000-8000-{i:012d}" for i in range(n_jobs)]
        z_submit(z, n_jobs, 1, Z_BATCH, uuids=uuids)
        now[0] += 1_000
        pairs = z_cycles(z)
        client, names = JobClient(z.server.url, user="reader"), {}
        bodies = [z_norm(client.job(u), names) for u in uuids]
    finally:
        z.server.stop()
        z.sched.shutdown()
    return pairs, bodies


def phase_z(device="cuda", n_jobs=Z_JOBS, writers=Z_WRITERS, batch=Z_BATCH,
            hosts=Z_HOSTS, small=None) -> dict:
    """The REST plane on the card: Z1 submissions through 4 JobClient
    writers; Z2 ``step_cycle`` until the queue is empty (path ``rest``,
    every launch replayed); Z3 every acknowledged job read back at 1, 4
    and 8 readers, and the other surfaces; Z4 the journal reopened; Z5
    one writer on the card and with ``device="cpu"``."""
    import shutil
    import tempfile

    from cook_tpu_torch.client import JobClient
    from cook_tpu_torch.state import Store
    t0 = time.perf_counter()
    card = device == "cuda"
    out = {"phase": "Z"}
    tmp = tempfile.mkdtemp(prefix="cook_rest_plane")
    try:
        z = z_stack(device, tmp, hosts=hosts)
        sub = z_submit(z, n_jobs, writers, batch)
        acked = sub.pop("acked")
        out["z1"] = sub
        rec = ReplayingRecorder("phase Z2") if card else None
        if rec is not None:
            rec.start()
        t1 = time.perf_counter()
        try:
            pairs = z_cycles(z, rec)
        finally:
            counts = rec.stop() if rec is not None else {}
        out["z2"] = {"cycles": len(pairs),
                     "launched": [len(p) for p in pairs],
                     "wall_s": time.perf_counter() - t1}
        if sum(out["z2"]["launched"]) != len(acked):
            raise AssertionError(f"phase Z2: launched "
                                 f"{out['z2']['launched']} of {len(acked)}")
        if card:
            missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"phase Z2: kernels not launched: "
                                     f"{missing}")
            out["z2"]["launches_per_kernel"] = counts
            out["z2"]["replayed_equal_to_plain"] = rec.replayed
        # ten jobs no host can take (128 cpus): they stay pending for the
        # explainer, and are acknowledged submissions like the rest
        admin = JobClient(z.server.url, user="admin")
        pending = admin.submit([{"command": "true", "cpus": 128.0,
                                 "mem": 64.0} for _ in range(10)])
        acked += pending
        out["z3"] = {f"readers_{n}": z_read_back(z, acked, n)
                     for n in Z_READERS}
        surfaces = {
            "/queue": lambda: admin.queue(),
            "/unscheduled_jobs": lambda: admin.unscheduled_jobs(pending),
            "/usage": lambda: admin.usage(user="bench0"),
            "/metrics": lambda: admin.metrics(),
            "/debug": lambda: admin._request("GET", "/debug")}
        answered = {}
        for path, call in surfaces.items():
            body = call()
            if not body:
                raise AssertionError(f"phase Z3: {path} answered nothing")
            answered[path] = len(json.dumps(body))
        out["z3"]["answered_bytes"] = answered
        states = {u: z.store.job(u).state.value for u in acked}
        z.server.stop()
        z.sched.shutdown()
        z.store.close()
        t1 = time.perf_counter()
        reopened = Store.open(tmp)
        lost = [u for u in acked if reopened.job(u) is None
                or reopened.job(u).state.value != states[u]]
        reopened.close()
        if lost:
            raise AssertionError(f"phase Z4: {len(lost)} acknowledged jobs "
                                 f"not read back: {lost[:3]}")
        out["z4"] = {"acked": len(acked), "read_back": len(acked),
                     "reopen_s": time.perf_counter() - t1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    small = small or Z_SMALL
    t1 = time.perf_counter()
    a, b = (z_small_leg(d, **small) for d in (device, "cpu"))
    if a[0] != b[0]:
        raise AssertionError("phase Z5: card and CPU launched different "
                             "pairs")
    if a[1] != b[1]:
        raise AssertionError("phase Z5: card and CPU job bodies differ")
    out["z5"] = {"jobs": small["n_jobs"], "cycles": len(a[0]),
                 "launched": [len(p) for p in a[0]],
                 "wall_s": time.perf_counter() - t1}
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return counts


# ---------------------------------------------- phases N and O: the node
# Phase N: one CookDaemon in process on a journaled data dir, Config()
# but for match_interval_seconds 1.0, the fake cluster at 1,000 hosts
# of 64 cpus and 65,536 MB (tasks of 3 s, auto-advanced); 4 JobClient
# writers submit 1,600 jobs from 200 users in batches of 20 (a size for
# the run's time).  Phase O: two ``python -m cook_tpu_torch`` nodes with
# socket replication on 200 hosts.
N_JOBS, N_USERS, N_HOSTS, N_WRITERS, N_BATCH = 1_600, 200, 1_000, 4, 20
N_TIMEOUT_S = 180.0
O_HOSTS, O_FIRST, O_WAITING = 200, 100, 300
# 10 users over 5 s, for the run's time
O_SIM = {"users": 10, "jobs_per_user": 10, "duration_s": 5.0}
O_TIMEOUT_S = 120.0


def node_conf(directory: Path, name: str, device: str, hosts: int,
              **extra) -> dict:
    """A node's config: its own data dir, the shared election dir, the
    port's fake cluster (tasks of 3 s on the wall clock), and a
    scheduler section that sets only the match interval."""
    conf = {"host": "127.0.0.1", "port": 0, "device": device,
            "data_dir": str(directory / f"data-{name}"),
            "election_dir": str(directory / "election"),
            "admins": ["admin"],
            "clusters": [{"factory": "cook_tpu_torch.cluster.fake.factory",
                          "kwargs": {"name": "node-fake", "n_hosts": hosts,
                                     "cpus": 64.0, "mem": 65536.0,
                                     "default_task_duration_ms": 3_000,
                                     "auto_advance": True}}],
            "scheduler": {"match_interval_seconds": 1.0}}
    conf.update(extra)
    return conf


def wait_for(pred, timeout: float, what: str, every: float = 0.05):
    deadline = time.perf_counter() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(every)


def submit_batches(url, per_writer: list, clients=None) -> dict:
    """One ``JobClient`` writer a thread for each list of ``per_writer``,
    each submitting its (user, specs) batches in turn; the acknowledged
    uuids (writer by writer), the last acknowledgement, submissions a
    second and the requests' p50 and p99.  ``clients``, a list, gets
    each writer's clients (user -> ``JobClient``)."""
    from cook_tpu_torch.client import JobClient
    last = [0.0] * len(per_writer)
    mine = [{} for _ in per_writer]

    def writer(i, lats):
        acked = []
        for user, specs in per_writer[i]:
            client = mine[i].setdefault(user, JobClient(url, user=user))
            t0 = time.perf_counter()
            acked += client.submit(specs)
            last[i] = time.perf_counter()
            lats.append((last[i] - t0) * 1e3)
        return acked

    wall, lats, rets = z_threads(len(per_writer), writer)
    acked = [u for r in rets for u in r]
    want = sum(len(specs) for w in per_writer for _user, specs in w)
    if len(acked) != want:
        raise AssertionError(f"{len(acked)} of {want} submissions "
                             f"acknowledged")
    if clients is not None:
        clients[:] = mine
    return {"acked": acked, "last_ack": max(last),
            "jobs_per_s": len(acked) / wall,
            "request_p50_ms": float(np.percentile(lats, 50)),
            "request_p99_ms": float(np.percentile(lats, 99)),
            "wall_s": wall}


def n_submit(url, n_jobs, n_users, writers, batch, seed) -> dict:
    """``writers`` JobClients submit ``n_jobs`` jobs of 1-4 cpus and
    64-2,047 MB in batches of ``batch``, each batch from the next of
    ``n_users`` users."""
    per_writer = n_jobs // (writers * batch)
    rng = np.random.default_rng(seed)
    cpus = rng.integers(1, 5, n_jobs).astype(float)
    mem = rng.integers(64, 2048, n_jobs).astype(float)
    starts = [[(i * per_writer + b) * batch for b in range(per_writer)]
              for i in range(writers)]
    return submit_batches(url, [[
        (f"user{(k0 // batch) % n_users:03d}",
         [{"command": "true", "cpus": cpus[k], "mem": mem[k]}
          for k in range(k0, k0 + batch)]) for k0 in ks] for ks in starts])


def checked_steps(sched, rec, guard, check, what: str, faults: list):
    """Wrap ``sched.step_cycle`` for a node whose match loop steps on
    its own thread: each step, under ``guard``, drains ``rec`` (the
    replays), fails if the cycle degraded to the split path, and calls
    ``check(label)``.  The match loop logs a failed cycle and carries
    on, so a fault here, the cycle's own or a check's, is appended to
    ``faults`` for the phase to raise from its main thread; so is a
    cycle that degraded, which ``step_cycle`` catches itself.  Returns
    the steps' list, one (start, launched, step s, replay and check s)
    a step, and the calls' count in a one-element list."""
    steps, calls = [], [0]
    step_cycle = sched.step_cycle

    def counted_step(*a, **kw):
        with guard:
            calls[0] += 1
        try:
            t1 = time.perf_counter()
            before = fallbacks("fused.pool_cycle")
            res = step_cycle(*a, **kw)
            with guard:
                t2 = time.perf_counter()
                if rec is not None and rec._ctx is not None:
                    rec.drain()
                if fallbacks("fused.pool_cycle") != before:
                    raise AssertionError(f"{what} step {len(steps)} "
                                         f"degraded to the split path")
                check(f"{what} step {len(steps)}")
                steps.append((t1, sum(len(r.launched_task_ids)
                                      for r in res.values()),
                              t2 - t1, time.perf_counter() - t2))
        except BaseException as e:
            faults.append(e)
            raise
        return res

    sched.step_cycle = counted_step
    return steps, calls


def phase_n(device="cuda", n_jobs=N_JOBS, n_users=N_USERS, hosts=N_HOSTS,
            writers=N_WRITERS, batch=N_BATCH) -> dict:
    """The node in process: ``CookDaemon.start()`` leads, 4 writers
    submit, the daemon's own loops place and complete every job; every
    launch of its cycles is recorded and replayed against its plain
    version after its step (path ``daemon``); no host oversubscribed
    and no job live twice after every step; the journal scans clean;
    after ``shutdown()`` the reopened journal holds every acknowledged
    job in its state."""
    import shutil
    import tempfile
    import threading

    from cook_tpu_torch.daemon import CookDaemon
    from cook_tpu_torch.state import JobState, Store
    from cook_tpu_torch.state.integrity import scan_journal
    card = device == "cuda"
    out = {"phase": "N"}
    tmp = Path(tempfile.mkdtemp(prefix="cook_node"))
    t0 = time.perf_counter()
    node = CookDaemon(node_conf(tmp, "n", device, hosts))
    running = True

    def leader():
        if node.exit_code != 0:
            raise AssertionError("phase N: the takeover failed")
        return node.scheduler

    try:
        node.start()
        sched = wait_for(leader, 60.0, "phase N: leadership")
        out["lead_s"] = time.perf_counter() - t0
        if sched.device.type != torch.device(device).type:
            raise AssertionError(f"phase N: the leader runs on "
                                 f"{sched.device}")
        # the loops wait one interval before their first tick: the
        # recorder starts (and zeroes the counts) before any launch
        rec = ReplayingRecorder("phase N") if card else None
        guard = threading.Lock()
        faults = []
        seq0, counter0 = flight_seq(), fallbacks("fused.pool_cycle")
        rebalances = guard_rebalancer(sched, guard)

        def no_fault():
            if faults:
                raise AssertionError(f"phase N: {len(faults)} step_cycle "
                                     f"calls failed") from faults[0]

        if rec is not None:
            rec.start()
        steps, calls = checked_steps(
            sched, rec, guard, lambda label: check_live(node, label),
            "phase N", faults)
        sub = n_submit(node.node_url, n_jobs, n_users, writers, batch,
                       SEED + 11)
        acked, last_ack = sub.pop("acked"), sub.pop("last_ack")
        out["n1"] = sub

        def count(state):
            no_fault()
            return len(node.store.jobs_where(
                lambda j: j.state is state, clone=False))

        wait_for(lambda: count(JobState.WAITING) == 0, N_TIMEOUT_S,
                 "phase N: every job placed", every=0.1)
        placed_s = time.perf_counter() - last_ack
        wait_for(lambda: count(JobState.COMPLETED) == len(acked),
                 N_TIMEOUT_S, "phase N: every job completed", every=0.1)
        completed_s = time.perf_counter() - last_ack
        states = {u: node.store.job(u).state.value for u in acked}
        journal = scan_journal(str(tmp / "data-n" / "journal.jsonl"))
        if journal.corrupt or journal.good != journal.size:
            raise AssertionError(f"phase N: journal unsound: "
                                 f"{journal.reason}")
        with guard:
            # each step: its start after the last acknowledgement (s), the
            # jobs it launched, its own wall and the replays' and checks'
            # after it (ms)
            out["n2"] = {
                "placed_after_last_ack_s": placed_s,
                "completed_after_last_ack_s": completed_s,
                "step_cycles": len(steps),
                "dispatching_cycles": sum(1 for s in steps if s[1]),
                "steps": [[t1 - last_ack, n, s * 1e3, r * 1e3]
                          for t1, n, s, r in steps],
                "replay_and_check_s": sum(s[3] for s in steps),
                # the match thread's replays and checks between the last
                # acknowledgement and the last placement, which the
                # placement waited for
                "replay_and_check_to_placed_s": sum(
                    s[3] for s in steps
                    if last_ack <= s[0]
                    and s[0] + s[2] + s[3] < last_ack + placed_s),
                "journal_records": len(journal.records)}
        node.shutdown()
        running = False
        counts = rec.stop() if rec is not None else {}
        no_fault()
        if len(steps) != calls[0]:
            raise AssertionError(f"phase N: {calls[0]} step_cycle calls, "
                                 f"{len(steps)} checked")
        degraded = degraded_since(seq0, counter0)
        out["n2"]["degraded_cycles"] = degraded
        out["n2"]["rebalancer_pool_passes"] = len(rebalances)
        if degraded["fallback_counter"] or degraded["flight_notes"]:
            raise AssertionError(f"phase N: cycles degraded to the split "
                                 f"path: {degraded}")
        if card:
            missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"phase N: kernels not launched: "
                                     f"{missing}")
            skipped = rec.unreplayed(counts)
            if skipped:
                raise AssertionError(f"phase N: launches not replayed "
                                     f"(path, replays): {skipped}")
            out["n2"]["launches_per_kernel"] = counts
            out["n2"]["replayed_equal_to_plain"] = rec.replayed
        t1 = time.perf_counter()
        reopened = Store.open(str(tmp / "data-n"))
        lost = [u for u in acked if reopened.job(u) is None
                or reopened.job(u).state.value != states[u]]
        reopened.close()
        if lost:
            raise AssertionError(f"phase N: {len(lost)} acknowledged jobs "
                                 f"not read back: {lost[:3]}")
        out["n3"] = {"acked": len(acked), "read_back": len(acked),
                     "states": sorted(set(states.values())),
                     "reopen_s": time.perf_counter() - t1}
    finally:
        if running:
            node.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return counts


# -------------------------------------- phase G: the node's remote backend
# One CookDaemon in process on the card (phase N's node: Config() but for
# match_interval_seconds 1.0, so the fused cycle at depth 2) whose one
# cluster is cook_tpu_torch.cluster.remote.factory over 64 cook_agentd
# agents (LocalAgentProcess, g-00 ... g-63, 16 cpus and 32,768 MB each),
# its progress_url the node's own URL.  400 jobs of 1 cpu and 256 MB
# from 60 users; the job kinds and their commands are G_KINDS.  g-00
# holds 16 cpus, so 16 jobs fill it before it is SIGKILLed.  400 jobs
# (1,200 until a whole run of this script took 898.8 s on a slow host,
# 800 until phase FO joined the run) for the run's time: a launching step of up to 1,000 real launches
# holds the node's host for seconds, and the statuses apply after it
# (PERF.md section 5).  G_KINDS_6000 is the 6,000-job world, run alone
# (``phase_g(kinds=G_KINDS_6000)``).
G_AGENTS, G_CPUS, G_MEM = 64, 16.0, 32_768.0
G_USERS, G_WRITERS, G_BATCH = 60, 4, 20
G_KINDS = {
    # kind: (count, command, executor, max_retries)
    "uuid": (204, 'echo "$COOK_INSTANCE_UUID" > instance_uuid', None, 1),
    "executor": (100, 'echo "progress: 50 half"; echo "progress: 100 done"',
                 "cook", 1),
    "exit7": (60, "exit 7", None, 2),
    "killed": (20, "sleep 60", None, 1),
    "lost": (16, 'echo $$ > pid; [ "$COOK_INSTANCE_NUM" = 0 ] && sleep 60 '
                 '|| true', None, 1),
}
G_KINDS_6000 = {**G_KINDS, "uuid": (5_404,) + G_KINDS["uuid"][1:],
                "executor": (500,) + G_KINDS["executor"][1:]}
G_TIMEOUT_S = 150.0
G_SMALL = {"agents": 8, "jobs": 200, "users": 10}  # card against CPU


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def g_agents(directory: Path, n: int, cpus=G_CPUS, mem=G_MEM) -> list:
    from cook_tpu_torch.cluster.remote import LocalAgentProcess
    agents = []
    try:
        for i in range(n):
            agents.append(LocalAgentProcess(f"g-{i:02d}", cpus=cpus,
                                            mem=mem, workdir=str(directory)))
    except BaseException:
        for a in agents:
            a.stop()
        raise
    return agents


def g_check(node, cluster, what: str) -> int:
    """No agent over its capacity, by the backend's tracked consumption
    (what ``pending_offers`` subtracts) and by the store's live
    instances a host (less those whose terminal status the backend has
    taken and the store is still to apply); no job live twice.  Returns
    the live instances."""
    cap = np.array([G_CPUS, G_MEM])
    with cluster._lock:
        tracked = list(cluster._tasks.values())
        ended = set(cluster._terminal_seen)
        caps = {h: np.array([c.capacity.cpus, c.capacity.mem])
                for h, c in cluster._agents.items()}
    used = {}
    for host, res in tracked:
        used.setdefault(host, np.zeros(2))[:] += (res.cpus, res.mem)
    over = [h for h, u in used.items() if (u > caps.get(h, cap)).any()]
    if over:
        raise AssertionError(f"{what}: tracked consumption over capacity "
                             f"on {over[:5]}")
    used, per_job = {}, {}
    live = node.store.running_instances(clone=False)
    for job, inst in live:
        per_job[job.uuid] = per_job.get(job.uuid, 0) + 1
        if inst.task_id in ended:
            continue
        used.setdefault(inst.hostname, np.zeros(2))[:] += (
            job.resources.cpus, job.resources.mem)
    over = [h for h, u in used.items() if (u > cap).any()]
    if over:
        raise AssertionError(f"{what}: live instances over capacity on "
                             f"{over[:5]}")
    twice = [u for u, n in per_job.items() if n > 1]
    if twice:
        raise AssertionError(f"{what}: jobs live twice: {twice[:5]}")
    return len(live)


def g_specs(kinds=G_KINDS, users=G_USERS) -> dict:
    """Each kind's submissions: uuids from a counter, users in turn."""
    out, k = {}, 0
    for kind, (count, command, executor, retries) in kinds.items():
        specs = []
        for _ in range(count):
            spec = {"uuid": f"00000000-0000-4000-8000-{k:012d}",
                    "command": command, "cpus": 1.0, "mem": 256.0,
                    "max_retries": retries, "user": f"user{k % users:02d}"}
            if executor:
                spec["executor"] = executor
            specs.append(spec)
            k += 1
        out[kind] = specs
    return out


def g_submit(url, specs, writers=G_WRITERS, batch=G_BATCH) -> dict:
    """``writers`` JobClients submit ``specs`` in batches of ``batch``,
    each batch one user's, the batches dealt to the writers in turn."""
    by_user = {}
    for spec in specs:
        by_user.setdefault(spec["user"], []).append(
            {k: v for k, v in spec.items() if k != "user"})
    batches = [(u, ss[i:i + batch]) for u, ss in sorted(by_user.items())
               for i in range(0, len(ss), batch)]
    return submit_batches(url, [batches[i::writers]
                                for i in range(writers)])


def g_outcomes(node, specs, workdir: Path) -> dict:
    """Each job against the reference's end state for its kind; raises
    on the first kind with a job elsewhere."""
    from cook_tpu_torch.state.schema import InstanceStatus, Reasons
    store, out, bad = node.store, {}, {}
    for kind, ss in specs.items():
        n_ok = 0
        for s in ss:
            job = store.job(s["uuid"])
            insts = [store.instance(t) for t in job.instances]
            last = insts[-1] if insts else None
            st = [(i.status, i.reason_code, i.exit_code, i.hostname)
                  for i in insts]
            if kind == "uuid":
                path = Path(last.sandbox_directory or "") / "instance_uuid"
                ok = (job.state.value == "completed"
                      and last.status is InstanceStatus.SUCCESS
                      and path.is_file()
                      and path.read_text().strip() == last.task_id)
            elif kind == "executor":
                ok = (last.status is InstanceStatus.SUCCESS
                      and last.progress == 100
                      and last.progress_message == "done")
            elif kind == "exit7":
                ok = (job.state.value == "completed" and len(st) == 2
                      and all(x[:3] == (InstanceStatus.FAILED,
                                        Reasons.NON_ZERO_EXIT.code, 7)
                              for x in st))
            elif kind == "killed":
                ok = (job.state.value == "completed" and len(st) == 1
                      and st[0][:2] == (InstanceStatus.FAILED,
                                        Reasons.KILLED_BY_USER.code))
            else:  # lost: NODE_LOST on g-00, mea culpa, then SUCCESS
                ok = (len(st) == 2 and st[0][:2] == (
                          InstanceStatus.FAILED, Reasons.NODE_LOST.code)
                      and st[0][3] == "g-00" and Reasons.NODE_LOST.mea_culpa
                      and st[1][0] is InstanceStatus.SUCCESS
                      and st[1][3] != "g-00")
            if ok:
                n_ok += 1
            else:
                bad.setdefault(kind, []).append((s["uuid"], [
                    (x[0].value, x[1], x[2], x[3]) for x in st]))
        out[kind] = n_ok
    if bad:
        raise AssertionError(f"phase G: jobs not in their expected end "
                             f"state: { {k: v[:3] for k, v in bad.items()} }")
    return out


def g_small(directory: Path, agents=G_SMALL["agents"], jobs=G_SMALL["jobs"],
            users=G_SMALL["users"], devices=("cuda", "cpu")) -> dict:
    """Card against CPU: one ``step_cycle`` (depth 0, so the cycle
    applies its own decisions) over ``agents`` fresh agents, every job
    submitted before it, so no status has arrived; the launched pairs on
    ``devices[0]`` and ``devices[1]`` must be equal.  Each side's tasks
    end before the other side connects."""
    from cook_tpu_torch.cluster.remote import RemoteComputeCluster
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import Job, Resources, Store
    procs = g_agents(directory, agents)
    runs = []
    try:
        for device in devices:
            store = Store()
            store.clock = lambda: 1_700_000_000_000
            store.create_jobs([Job(
                uuid=f"00000000-0000-4000-8000-{k:012d}",
                user=f"user{k % users:02d}", command="true",
                priority=1 + (k * 37) % 100,
                resources=Resources(cpus=1.0, mem=256.0))
                for k in range(jobs)])
            cluster = RemoteComputeCluster(
                "g-small", [("127.0.0.1", a.port) for a in procs],
                store=store)
            cfg = Config()
            cfg.pipeline.depth = 0
            sched = Scheduler(store, cfg, [cluster], device=device)
            try:
                res = sched.step_cycle()
                runs.append(sorted(
                    (store.instance(t).job_uuid, store.instance(t).hostname)
                    for r in res.values() for t in r.launched_task_ids))
                wait_for(lambda: cluster.running_task_ids() == [], 60.0,
                         "phase G small: tasks ended")
            finally:
                sched.shutdown()
                cluster.shutdown()
    finally:
        for a in procs:
            a.stop()
    if not runs[0] or runs[0] != runs[1]:
        raise AssertionError(f"phase G small: {devices} launched "
                             f"{len(runs[0])} and {len(runs[1])} pairs, "
                             f"not the same")
    return {"agents": agents, "jobs": jobs, "launched": len(runs[0]),
            "devices": list(devices), "equal": True}


def phase_g(device="cuda", n_agents=G_AGENTS, kinds=G_KINDS, users=G_USERS,
            writers=G_WRITERS, batch=G_BATCH, small=G_SMALL) -> dict:
    """The node over the remote backend: ``CookDaemon.start()`` leads on
    ``device`` with g-00 its one agent; the ``lost`` jobs run there,
    then the other agents register (``add_agent``) and 4 writers submit
    the rest; g-00 is SIGKILLed after the last acknowledgement, the
    ``killed`` jobs are killed through REST once they run, and the
    daemon's own loops place and complete every job on real processes.
    Every launch of its cycles is replayed against its plain version
    after its step (path ``remote_node``); every step is checked
    (``g_check``); every job ends in its kind's state; then card against
    CPU on a small world (``g_small``)."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from cook_tpu_torch.client import JobClient
    from cook_tpu_torch.daemon import CookDaemon
    from cook_tpu_torch.state import JobState
    card = device == "cuda"
    out = {"phase": "G"}
    tmp = Path(tempfile.mkdtemp(prefix="cook_remote"))
    workdir = tmp / "agents"
    t0 = time.perf_counter()
    specs = g_specs(kinds, users)
    agents = g_agents(workdir, n_agents)
    out["agents_start_s"] = time.perf_counter() - t0
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    conf = node_conf(tmp, "g", device, 0, port=port)
    conf["clusters"] = [{
        "factory": "cook_tpu_torch.cluster.remote.factory",
        "kwargs": {"name": "g-remote", "progress_url": url,
                   "endpoints": [["127.0.0.1", agents[0].port]]}}]
    node = CookDaemon(conf)
    running, rec = True, None

    def leader():
        if node.exit_code != 0:
            raise AssertionError("phase G: the takeover failed")
        return node.scheduler

    try:
        node.start()
        sched = wait_for(leader, 60.0, "phase G: leadership")
        if node.node_url != url:
            raise AssertionError(f"phase G: node at {node.node_url}")
        if sched.device.type != torch.device(device).type:
            raise AssertionError(f"phase G: the leader runs on "
                                 f"{sched.device}")
        cluster = sched.clusters["g-remote"]
        frames = [0]
        progress = node.api.progress

        def counted_progress(task_id, body):
            frames[0] += 1
            return progress(task_id, body)

        node.api.progress = counted_progress
        rec = ReplayingRecorder("phase G") if card else None
        guard = threading.Lock()
        faults = []
        seq0, counter0 = flight_seq(), fallbacks("fused.pool_cycle")
        rebalances = guard_rebalancer(sched, guard)

        def no_fault():
            if faults:
                raise AssertionError(f"phase G: {len(faults)} step_cycle "
                                     f"calls failed") from faults[0]

        if rec is not None:
            rec.start()
        steps, calls = checked_steps(
            sched, rec, guard, lambda label: g_check(node, cluster, label),
            "phase G", faults)
        store = node.store

        def live_on(uuids, host=None):
            no_fault()
            n = 0
            for u in uuids:
                job = store.job(u)
                inst = store.instance(job.instances[-1]) \
                    if job and job.instances else None
                n += (inst is not None and inst.status.value == "running"
                      and (host is None or inst.hostname == host))
            return n == len(uuids)

        # the lost jobs fill g-00, the only agent yet
        lost = [s["uuid"] for s in specs["lost"]]
        g_submit(url, specs["lost"], writers=1, batch=batch)
        wait_for(lambda: live_on(lost, "g-00"), 60.0,
                 "phase G: the lost jobs running on g-00", every=0.1)
        t1 = time.perf_counter()
        for a in agents[1:]:
            cluster.add_agent("127.0.0.1", a.port)
        out["add_agents_s"] = time.perf_counter() - t1
        rest = [s for kind in specs if kind != "lost" for s in specs[kind]]
        sub = g_submit(url, rest, writers, batch)
        acked, last_ack = sub.pop("acked"), sub.pop("last_ack")
        out["g1"] = sub
        agents[0].proc.kill()  # g-00 dies hard
        t_kill = time.time()
        killed = [s["uuid"] for s in specs["killed"]]
        wait_for(lambda: live_on(killed), G_TIMEOUT_S,
                 "phase G: the killed jobs running", every=0.1)
        by_user = {}
        for s in specs["killed"]:
            by_user.setdefault(s["user"], []).append(s["uuid"])
        for user, uuids in sorted(by_user.items()):
            JobClient(url, user=user).kill(uuids)
        everyone = lost + acked

        def count(state):
            no_fault()
            return len(store.jobs_where(lambda j: j.state is state,
                                        clone=False))

        wait_for(lambda: count(JobState.WAITING) == 0, G_TIMEOUT_S,
                 "phase G: every job placed", every=0.1)
        placed_s = time.perf_counter() - last_ack
        wait_for(lambda: count(JobState.COMPLETED) == len(everyone),
                 G_TIMEOUT_S, "phase G: every job completed", every=0.1)
        completed_s = time.perf_counter() - last_ack
        # the store's clock is the wall clock in ms
        lost_back_s = max(
            store.instance(store.job(u).instances[-1]).end_time_ms or 0
            for u in lost) / 1e3 - t_kill
        with guard:
            out["g2"] = {
                "placed_after_last_ack_s": placed_s,
                "completed_after_last_ack_s": completed_s,
                "lost_completed_after_kill_s": lost_back_s,
                "step_cycles": len(steps),
                "dispatching_cycles": sum(1 for s in steps if s[1]),
                "launched": sum(s[1] for s in steps),
                "step_ms_p50": float(np.percentile(
                    [s[2] * 1e3 for s in steps], 50)),
                "step_ms_p99": float(np.percentile(
                    [s[2] * 1e3 for s in steps], 99)),
                "steps": [[round(t - last_ack, 3), n, s * 1e3, r * 1e3]
                          for t, n, s, r in steps],
                "replay_and_check_s": sum(s[3] for s in steps),
                "progress_frames": frames[0]}
        node.shutdown()
        running = False
        counts = rec.stop() if rec is not None else {}
        no_fault()
        if len(steps) != calls[0]:
            raise AssertionError(f"phase G: {calls[0]} step_cycle calls, "
                                 f"{len(steps)} checked")
        degraded = degraded_since(seq0, counter0)
        out["g2"]["degraded_cycles"] = degraded
        out["g2"]["rebalancer_pool_passes"] = len(rebalances)
        if degraded["fallback_counter"] or degraded["flight_notes"]:
            raise AssertionError(f"phase G: cycles degraded to the split "
                                 f"path: {degraded}")
        insts = [store.instance(t) for u in everyone
                 for t in store.job(u).instances]
        lat = [i.mesos_start_time_ms - i.start_time_ms for i in insts
               if i.mesos_start_time_ms is not None]
        out["g2"]["launch_to_running_ms_p50"] = float(np.percentile(lat, 50))
        out["g2"]["launch_to_running_ms_p99"] = float(np.percentile(lat, 99))
        out["g2"]["instances"] = len(insts)
        out["g3"] = {"end_states": g_outcomes(node, specs, workdir),
                     "no_agent_over_capacity_no_job_live_twice_steps":
                         len(steps)}
        if card:
            missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"phase G: kernels not launched: "
                                     f"{missing}")
            skipped = rec.unreplayed(counts)
            if skipped:
                raise AssertionError(f"phase G: launches not replayed "
                                     f"(path, replays): {skipped}")
            out["g3"]["launches_per_kernel"] = counts
            out["g3"]["replayed_equal_to_plain"] = rec.replayed
    finally:
        if running:
            node.shutdown()
        if rec is not None and rec._ctx is not None:
            rec._ctx.__exit__(None, None, None)
        for a in agents:
            a.stop()
        # g-00 was SIGKILLed: its sleeping tasks are orphans in their own
        # process groups, each named by its sandbox's pid file
        for pid_file in (workdir / "g-00").glob("*/pid"):
            try:
                os.killpg(int(pid_file.read_text()), signal.SIGKILL)
            except (ValueError, ProcessLookupError, PermissionError):
                pass
        shutil.rmtree(tmp, ignore_errors=True)
    tmp_small = Path(tempfile.mkdtemp(prefix="cook_remote_small"))
    try:
        out["g4"] = g_small(tmp_small / "agents", devices=(device, "cpu"),
                            **small)
    finally:
        shutil.rmtree(tmp_small, ignore_errors=True)
    out["world"] = {"agents": n_agents, "cpus": G_CPUS, "mem": G_MEM,
                    "jobs": sum(len(v) for v in specs.values()),
                    "users": users, "writers": writers, "batch": batch,
                    "kinds": {k: len(v) for k, v in specs.items()}}
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return counts


# -------------------------------------- phase L: the Kubernetes node
# One CookDaemon in process on the card (phase N's scheduler section:
# fused, depth 2, 1 s match interval, and autoscaling on) electing over
# the k8s lease and placing through cook_tpu_torch.cluster.k8s, both
# over the port's MockApiServer in this process (plain HTTP: the card's
# machine lists no openssl; the tests hold TLS).  64 nodes k-00 ...
# k-63 of 16 cpus and 32,768 MB in pool "default"; a kubelet thread
# steps the mock every L_TICK_S and finishes each Running pod L_RUN_S
# after it saw it run, with its kind's exit code, never on k-00 and
# never a "killed" job's.  The mock's kube-scheduler stand-in binds no
# unbound pod: synthetic pods stay pending demand, placeholders a real
# cluster would preempt (the mock has no priorities), so they never
# take a node from a job.  400 jobs of 1 cpu and 256 MB but the big
# ones, from 40 users; L_KINDS gives each kind's count, exit code,
# max_retries and cpus.  The jobs on k-00 once 16 pods run there fail
# NODE_LOST when the phase loses it, whatever their kind.  400 jobs for
# the run's time (1,200 until a whole run of this script took 898.8 s on
# a slow host, 800 until phase FO joined the run): every pod is an HTTP POST under the controller's lock,
# and at 2,400 (L_KINDS_2400, run alone) the phase took 151 s on the
# card's host (PERF.md section 6).
L_NODES, L_CPUS, L_MEM = 64, 16.0, 32_768.0
L_USERS, L_WRITERS, L_BATCH = 40, 4, 20
L_KINDS = {
    # kind: (count, exit code, max_retries, cpus)
    "ok": (312, 0, 1, 1.0),
    "exit7": (60, 7, 2, 1.0),
    "killed": (20, None, 1, 1.0),
    "big": (8, 0, 1, 24.0),
}
L_KINDS_2400 = {**L_KINDS, "ok": (2_312,) + L_KINDS["ok"][1:]}
L_BIG_NODES, L_BIG_CPUS, L_BIG_MEM = 4, 32.0, 65_536.0
L_LOST_AT = 16
L_TICK_S, L_RUN_S = 0.1, 0.3
L_LEASE = "cook-scheduler-leader"
L_TIMEOUT_S = 150.0
L_SMALL = {"nodes": 8, "jobs": 200, "users": 10}  # card against CPU


def l_mock(nodes: int, prefix: str = "k"):
    """The port's mock apiserver with ``nodes`` nodes of L_CPUS and
    L_MEM, ``k-00`` ... ."""
    from cook_tpu_torch.cluster.k8s.fake_api import FakeNode
    from cook_tpu_torch.cluster.k8s.mock_apiserver import MockApiServer
    mock = MockApiServer().start()
    mock.fake.auto_schedule = False
    for i in range(nodes):
        mock.fake.add_node(FakeNode(name=f"{prefix}-{i:02d}", cpus=L_CPUS,
                                    mem=L_MEM))
    return mock


def l_specs(kinds=L_KINDS, users=L_USERS) -> dict:
    """Each kind's submissions: uuids from a counter, users in turn."""
    out, k = {}, 0
    for kind, (count, _code, retries, cpus) in kinds.items():
        specs = []
        for _ in range(count):
            specs.append({"uuid": f"00000000-0000-4000-8000-{k:012d}",
                          "command": "true", "cpus": cpus, "mem": 256.0,
                          "max_retries": retries,
                          "user": f"user{k % users:02d}"})
            k += 1
        out[kind] = specs
    return out


def l_check(node, cluster, mock, what: str) -> dict:
    """No node over its capacity, by the mock's live pods a node and by
    what ``pending_offers`` subtracts (the pods it lists over HTTP); no
    job live twice, by the store's live instances and by the mock's
    live pods.  Returns the live counts."""
    caps = {n.name: np.array([n.cpus, n.mem]) for n in mock.fake.nodes()}
    for source, pods in (("mock", mock.fake.pods()),
                         ("pending_offers", cluster.api.pods())):
        used, per_job = {}, {}
        for pod in pods:
            if pod.synthetic or not pod.node_name \
                    or pod.phase not in ("Pending", "Running"):
                continue
            used.setdefault(pod.node_name, np.zeros(2))[:] += (pod.cpus,
                                                               pod.mem)
            job = pod.labels.get("cook/job")
            per_job[job] = per_job.get(job, 0) + 1
        over = [h for h, u in used.items()
                if h in caps and (u > caps[h]).any()]
        if over:
            raise AssertionError(f"{what}: {source} pods over capacity on "
                                 f"{over[:5]}")
        twice = [u for u, n in per_job.items() if n > 1]
        if twice:
            raise AssertionError(f"{what}: {source} jobs live twice: "
                                 f"{twice[:5]}")
    per_job = {}
    live = node.store.running_instances(clone=False)
    for job, _inst in live:
        per_job[job.uuid] = per_job.get(job.uuid, 0) + 1
    twice = [u for u, n in per_job.items() if n > 1]
    if twice:
        raise AssertionError(f"{what}: jobs live twice in the store: "
                             f"{twice[:5]}")
    return len(live)


def l_outcomes(node, specs, lost: set) -> dict:
    """Each job against the reference's end state for its kind; a job
    whose pod was on k-00 when it was lost first fails NODE_LOST there
    (mea culpa), then follows its kind elsewhere.  Raises on the first
    kind with a job elsewhere."""
    from cook_tpu_torch.state.schema import InstanceStatus, Reasons
    store, out, bad = node.store, {}, {}
    for kind, ss in specs.items():
        n_ok = 0
        for s in ss:
            job = store.job(s["uuid"])
            st = [(i.status, i.reason_code, i.exit_code, i.hostname)
                  for i in (store.instance(t) for t in job.instances)]
            ok = job.state.value == "completed"
            if s["uuid"] in lost:
                ok = ok and bool(st) and st[0][:2] == (
                    InstanceStatus.FAILED, Reasons.NODE_LOST.code) \
                    and st[0][3] == "k-00" and Reasons.NODE_LOST.mea_culpa
                st = st[1:]
            ok = ok and all(x[3] != "k-00" for x in st)
            if kind in ("ok", "big"):
                ok = ok and len(st) == 1 and st[0][0] is \
                    InstanceStatus.SUCCESS
                if kind == "big":
                    ok = ok and st[0][3].startswith("k-big-")
            elif kind == "exit7":
                ok = ok and len(st) == 2 and all(
                    x[:3] == (InstanceStatus.FAILED,
                              Reasons.NON_ZERO_EXIT.code, 7) for x in st)
            else:  # killed through REST once it ran
                ok = ok and len(st) == 1 and st[0][:2] == (
                    InstanceStatus.FAILED, Reasons.KILLED_BY_USER.code)
            if ok:
                n_ok += 1
            else:
                bad.setdefault(kind, []).append((s["uuid"], [
                    (x[0].value, x[1], x[2], x[3]) for x in st]))
        out[kind] = n_ok
    if bad:
        raise AssertionError(f"phase L: jobs not in their expected end "
                             f"state: { {k: v[:3] for k, v in bad.items()} }")
    return out


def l_small(device: str, nodes=L_SMALL["nodes"], jobs=L_SMALL["jobs"],
            users=L_SMALL["users"]) -> list:
    """One ``step_cycle`` (depth 0) of the port's ``Scheduler`` on
    ``device`` over a fresh mock of ``nodes`` nodes through
    ``RealKubernetesApi``, every job submitted before it; the (job uuid,
    node) pairs of the pods it created on the mock."""
    from cook_tpu_torch.cluster.k8s.compute_cluster import KubernetesCluster
    from cook_tpu_torch.cluster.k8s.real_api import RealKubernetesApi
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import Job, Resources, Store
    mock = l_mock(nodes)
    api = RealKubernetesApi(base_url=mock.base_url)
    store = Store()
    store.clock = lambda: 1_700_000_000_000
    store.create_jobs([Job(
        uuid=f"00000000-0000-4000-8000-{k:012d}",
        user=f"user{k % users:02d}", command="true",
        priority=1 + (k * 37) % 100,
        resources=Resources(cpus=1.0 + k % 3, mem=256.0))
        for k in range(jobs)])
    cluster = KubernetesCluster("l-small", api, store=store)
    cfg = Config()
    cfg.pipeline.depth = 0
    sched = Scheduler(store, cfg, [cluster], device=device)
    try:
        sched.step_cycle()
        return sorted((p.labels["cook/job"], p.node_name)
                      for p in mock.fake.pods())
    finally:
        sched.shutdown()
        cluster.shutdown()
        api._stop.set()
        mock.close()


def phase_l(device="cuda", n_nodes=L_NODES, kinds=L_KINDS, users=L_USERS,
            writers=L_WRITERS, batch=L_BATCH) -> dict:
    """The node over the Kubernetes backend: ``CookDaemon.start()``
    campaigns under ``election.mode = "k8s-lease"`` on the mock and
    leads on ``device``; 4 writers submit every kind; once 16 pods run
    on k-00 it is lost (``lose_node``); the killed jobs are killed
    through REST once they run; once the big jobs' synthetic pods are
    up, 4 nodes of 32 cpus are added; the daemon's own loops place and
    complete every job.  Every step is checked (``l_check``) and every
    launch of its cycles replayed against its plain version after its
    step (path ``k8s_node``); the lease is sampled throughout; every job
    ends in its kind's state and no synthetic pod is left; then card
    against CPU on a small world (``l_small``)."""
    import shutil
    import tempfile
    import threading

    from cook_tpu_torch.client import JobClient
    from cook_tpu_torch.cluster.k8s.fake_api import FakeNode
    from cook_tpu_torch.cluster.k8s.real_api import RealKubernetesApi
    from cook_tpu_torch.daemon import CookDaemon
    from cook_tpu_torch.ops import cuda_lib
    from cook_tpu_torch.state import JobState
    card = device == "cuda"
    out = {"phase": "L"}
    tmp = Path(tempfile.mkdtemp(prefix="cook_k8s"))
    t0 = time.perf_counter()
    specs = l_specs(kinds, users)
    kind_of = {s["uuid"]: k for k, ss in specs.items() for s in ss}
    code_of = {k: v[1] for k, v in kinds.items()}
    mock = l_mock(n_nodes)
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    conf = node_conf(tmp, "l", device, 0, port=port)
    conf["scheduler"]["autoscaling_enabled"] = True
    conf["election"] = {"mode": "k8s-lease", "base_url": mock.base_url,
                        "lease_name": L_LEASE, "duration_seconds": 15}
    conf["clusters"] = [{
        "factory": "cook_tpu_torch.cluster.k8s.compute_cluster.factory",
        "kwargs": {"name": "k8s-1", "api_url": mock.base_url,
                   "rest_url": url}}]
    node = CookDaemon(conf)
    stop, sampled = threading.Event(), threading.Event()
    threads, faults, lease_seen = [], [], []
    running, rec, call = True, None, cuda_lib.call
    launch_threads = set()

    def counted_call(*a, **kw):
        launch_threads.add(threading.current_thread().name)
        return call(*a, **kw)

    def kubelet():
        ran = {}
        try:
            while not stop.is_set():
                mock.fake.step()
                now = time.perf_counter()
                for pod in mock.fake.pods():
                    if pod.phase != "Running" or pod.synthetic \
                            or pod.node_name == "k-00":
                        continue
                    kind = kind_of.get(pod.labels.get("cook/job"))
                    if kind is None or kind == "killed":
                        continue
                    if now - ran.setdefault(pod.name, now) >= L_RUN_S:
                        mock.fake.finish_pod(pod.name,
                                             exit_code=code_of[kind])
                stop.wait(L_TICK_S)
        except BaseException as e:
            faults.append(e)
            raise

    reader = RealKubernetesApi(base_url=mock.base_url)

    def lease_sampler():
        try:
            while not sampled.is_set():
                x = reader.get_lease(L_LEASE)
                if x is not None:
                    lease_seen.append((x.holder, x.renew_time_s,
                                       x.transitions))
                sampled.wait(0.25)
        except BaseException as e:
            faults.append(e)
            raise

    def leader():
        if node.exit_code != 0:
            raise AssertionError("phase L: the takeover failed")
        return node.scheduler

    try:
        cuda_lib.call = counted_call
        for target in (kubelet, lease_sampler):
            threads.append(threading.Thread(target=target, daemon=True,
                                            name=f"phase-l-{target.__name__}"))
            threads[-1].start()
        node.start()
        sched = wait_for(leader, 60.0, "phase L: leadership")
        out["lead_s"] = time.perf_counter() - t0
        if sched.device.type != torch.device(device).type:
            raise AssertionError(f"phase L: the leader runs on "
                                 f"{sched.device}")
        cluster = sched.clusters["k8s-1"]
        offers_ms, synth = [], {"created": 0, "reaped": 0}
        pending_offers = cluster.pending_offers
        autoscale, reap = cluster.autoscale, cluster.reap_synthetic_pods

        def timed_offers(pool):
            t1 = time.perf_counter()
            try:
                return pending_offers(pool)
            finally:
                offers_ms.append((time.perf_counter() - t1) * 1e3)

        def counted_autoscale(*a, **kw):
            n = autoscale(*a, **kw)
            synth["created"] += n
            return n

        def counted_reap(*a, **kw):
            n = reap(*a, **kw)
            synth["reaped"] += n
            return n

        cluster.pending_offers = timed_offers
        cluster.autoscale = counted_autoscale
        cluster.reap_synthetic_pods = counted_reap
        rec = ReplayingRecorder("phase L") if card else None
        guard = threading.Lock()
        seq0, counter0 = flight_seq(), fallbacks("fused.pool_cycle")
        rebalances = guard_rebalancer(sched, guard)

        def no_fault():
            if faults:
                raise AssertionError(f"phase L: {len(faults)} faults in "
                                     f"the steps or the phase's threads"
                                     ) from faults[0]

        if rec is not None:
            rec.start()
        steps, calls = checked_steps(
            sched, rec, guard,
            lambda label: l_check(node, cluster, mock, label), "phase L",
            faults)
        store = node.store

        def running_jobs(uuids):
            no_fault()
            n = 0
            for u in uuids:
                job = store.job(u)
                inst = store.instance(job.instances[-1]) \
                    if job and job.instances else None
                n += inst is not None and inst.status.value == "running"
            return n == len(uuids)

        everyone = [s for ss in specs.values() for s in ss]
        sub = g_submit(url, everyone, writers, batch)
        acked, last_ack = sub.pop("acked"), sub.pop("last_ack")
        out["l1"] = sub

        def on_k00():
            no_fault()
            pods = [p for p in mock.fake.pods() if p.node_name == "k-00"
                    and p.phase in ("Pending", "Running")]
            return pods if sum(p.phase == "Running"
                               for p in pods) >= L_LOST_AT else None

        lost = {p.labels["cook/job"] for p in wait_for(
            on_k00, L_TIMEOUT_S, "phase L: 16 pods running on k-00",
            every=0.05)}
        mock.fake.lose_node("k-00")
        t_lost = time.time()

        def lost_applied():
            # every lost job's k-00 instance has taken its failure, so a
            # REST kill below never races the NODE_LOST status
            no_fault()
            return all(any(i.hostname == "k-00"
                           and i.status.value == "failed"
                           for i in (store.instance(x)
                                     for x in store.job(u).instances))
                       for u in lost)

        wait_for(lost_applied, L_TIMEOUT_S,
                 "phase L: the lost pods failed in the store", every=0.05)
        killed = [s["uuid"] for s in specs["killed"]]
        wait_for(lambda: running_jobs(killed), L_TIMEOUT_S,
                 "phase L: the killed jobs running", every=0.1)
        by_user = {}
        for s in specs["killed"]:
            by_user.setdefault(s["user"], []).append(s["uuid"])
        for user, uuids in sorted(by_user.items()):
            JobClient(url, user=user).kill(uuids)
        big = {s["uuid"] for s in specs["big"]}

        def big_demand():
            no_fault()
            return {p.labels.get("cook/job") for p in mock.fake.pods()
                    if p.synthetic} >= big

        wait_for(big_demand, L_TIMEOUT_S,
                 "phase L: the big jobs' synthetic pods", every=0.1)
        t_big = time.time()
        for i in range(L_BIG_NODES):
            mock.fake.add_node(FakeNode(name=f"k-big-{i}", cpus=L_BIG_CPUS,
                                        mem=L_BIG_MEM))

        def count(state):
            no_fault()
            return len(store.jobs_where(lambda j: j.state is state,
                                        clone=False))

        wait_for(lambda: count(JobState.WAITING) == 0, L_TIMEOUT_S,
                 "phase L: every job placed", every=0.1)
        placed_s = time.perf_counter() - last_ack
        wait_for(lambda: count(JobState.COMPLETED) == len(acked),
                 L_TIMEOUT_S, "phase L: every job completed", every=0.1)
        completed_s = time.perf_counter() - last_ack
        big_s = max(store.instance(store.job(u).instances[-1]).end_time_ms
                    or 0 for u in big) / 1e3
        lost_back_s = max(
            store.instance(store.job(u).instances[-1]).end_time_ms or 0
            for u in lost) / 1e3 - t_lost
        with guard:
            left = [p.name for p in mock.fake.pods() if p.synthetic]
            out["l2"] = {
                "placed_after_last_ack_s": placed_s,
                "completed_after_last_ack_s": completed_s,
                "lost_completed_after_loss_s": lost_back_s,
                "big_completed_after_nodes_added_s": big_s - t_big,
                "step_cycles": len(steps),
                "dispatching_cycles": sum(1 for s in steps if s[1]),
                "launched": sum(s[1] for s in steps),
                "step_ms_p50": float(np.percentile(
                    [s[2] * 1e3 for s in steps], 50)),
                "step_ms_p99": float(np.percentile(
                    [s[2] * 1e3 for s in steps], 99)),
                "steps": [[round(t - last_ack, 3), n, s * 1e3, r * 1e3]
                          for t, n, s, r in steps],
                "replay_and_check_s": sum(s[3] for s in steps),
                "pending_offers_calls": len(offers_ms),
                "pending_offers_ms_p50": float(np.percentile(offers_ms, 50)),
                "pending_offers_ms_p99": float(np.percentile(offers_ms, 99)),
                "synthetic_created": synth["created"],
                "synthetic_reaped": synth["reaped"],
                "synthetic_left": len(left),
                "lost_jobs": len(lost),
                "lost_by_kind": {k: sum(kind_of[u] == k for u in lost)
                                 for k in kinds}}
        if left:
            raise AssertionError(f"phase L: synthetic pods left: "
                                 f"{left[:5]}")
        if synth["created"] < len(big) or synth["reaped"] < len(big):
            raise AssertionError(f"phase L: synthetic pods {synth}")
        identity = node.node_url
        sampled.set()
        threads[1].join(timeout=10)
        node.shutdown()
        running = False
        stop.set()
        threads[0].join(timeout=10)
        released = reader.get_lease(L_LEASE)
        counts = rec.stop() if rec is not None else {}
        no_fault()
        if len(steps) != calls[0]:
            raise AssertionError(f"phase L: {calls[0]} step_cycle calls, "
                                 f"{len(steps)} checked")
        holders = {h for h, _t, _n in lease_seen}
        renewals = len({t for _h, t, _n in lease_seen})
        transitions = {n for _h, _t, n in lease_seen}
        out["lease"] = {"samples": len(lease_seen),
                        "renewals_seen": renewals,
                        "holders": sorted(holders),
                        "transitions": sorted(transitions),
                        "holder_after_shutdown": released.holder}
        if holders != {identity} or transitions != {1} or renewals < 2 \
                or released.holder != "":
            raise AssertionError(f"phase L: the lease {out['lease']} "
                                 f"(the node is {identity})")
        degraded = degraded_since(seq0, counter0)
        out["l2"]["degraded_cycles"] = degraded
        out["l2"]["rebalancer_pool_passes"] = len(rebalances)
        if degraded["fallback_counter"] or degraded["flight_notes"]:
            raise AssertionError(f"phase L: cycles degraded to the split "
                                 f"path: {degraded}")
        insts = [store.instance(t) for u in acked
                 for t in store.job(u).instances]
        lat = [i.mesos_start_time_ms - i.start_time_ms for i in insts
               if i.mesos_start_time_ms is not None]
        out["l2"]["pod_created_to_running_ms_p50"] = float(
            np.percentile(lat, 50))
        out["l2"]["pod_created_to_running_ms_p99"] = float(
            np.percentile(lat, 99))
        out["l2"]["instances"] = len(insts)
        watchers = sorted(n for n in launch_threads
                          if n.startswith("k8s-watch"))
        out["l3"] = {"end_states": l_outcomes(node, specs, lost),
                     "no_node_over_capacity_no_job_live_twice_steps":
                         len(steps),
                     "launch_threads": sorted(launch_threads)}
        if watchers:
            raise AssertionError(f"phase L: kernels launched from the "
                                 f"watch threads {watchers}")
        if card:
            missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"phase L: kernels not launched: "
                                     f"{missing}")
            skipped = rec.unreplayed(counts)
            if skipped:
                raise AssertionError(f"phase L: launches not replayed "
                                     f"(path, replays): {skipped}")
            out["l3"]["launches_per_kernel"] = counts
            out["l3"]["replayed_equal_to_plain"] = rec.replayed
    finally:
        cuda_lib.call = call
        stop.set()
        sampled.set()
        if running:
            node.shutdown()
        if rec is not None and rec._ctx is not None:
            rec._ctx.__exit__(None, None, None)
        reader._stop.set()
        mock.close()
        shutil.rmtree(tmp, ignore_errors=True)
    t1 = time.perf_counter()
    pairs = [l_small(device), cpu_side("l_small")]
    if not pairs[0] or pairs[0] != pairs[1]:
        raise AssertionError(f"phase L small: {device} placed "
                             f"{len(pairs[0])} pods and cpu "
                             f"{len(pairs[1])}, not the same pairs")
    out["l4"] = {**L_SMALL, "pods": len(pairs[0]),
                 "devices": [device, "cpu"], "equal": True,
                 "wall_s": time.perf_counter() - t1}
    out["world"] = {"nodes": n_nodes, "cpus": L_CPUS, "mem": L_MEM,
                    "big_nodes": L_BIG_NODES, "big_cpus": L_BIG_CPUS,
                    "jobs": len(everyone), "users": users,
                    "writers": writers, "batch": batch,
                    "kinds": {k: len(v) for k, v in specs.items()},
                    "kubelet_tick_s": L_TICK_S, "pod_run_s": L_RUN_S}
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return counts


# ------------------------------------ phase H: the partitioned write plane
# One CookDaemon in process on the card (phase N's node: Config() but for
# match_interval_seconds 1.0, so the fused cycle at depth 2) whose store
# is four partition journals, as docs/DEPLOY.md's partitioned write plane
# documents: prod, research and batch declared on p0-p2 and default
# hashed (crc32 mod 4) to p3, summaries at most 1 s stale.  The node pins
# columnar_index and resident_pack off, so its leader runs the entity
# pack and the dense-mask K1-K6 cycle.  One fake cluster a pool, 250
# hosts of 64 cpus and 65,536 MB each (1,000 hosts, as phase N); tasks of
# 3 s, auto-advanced.  4 JobClient writers, writer i to pool i only, so
# each writer's batches go to one partition's journal (bench.py's
# partitioned write bench); then the user "capped" meets a count quota
# of 8 on the reserved pool "*" across prod and research.  800 jobs
# (1,600 until a whole run of this script took 898.8 s on a slow host).
H_POOLS = ("prod", "research", "batch", "default")
H_PARTITIONS = {"count": 4, "pools": {"prod": 0, "research": 1, "batch": 2},
                "summary_max_age_seconds": 1.0}
H_HOSTS, H_JOBS, H_USERS, H_WRITERS, H_BATCH = 250, 800, 200, 4, 20
H_CAP, H_CAP_EACH = 8, 6
H_CAP_TASK_MS = 120_000   # the capped user's tasks run until killed
H_TIMEOUT_S = 180.0
H_SMALL = {"hosts": 8, "jobs": 200, "users": 10}  # card against CPU


def h_clusters(hosts: int) -> list:
    """One fake cluster a pool: ``hosts`` hosts of 64 cpus and 65,536 MB,
    tasks of 3 s on the wall clock."""
    return [{"factory": "cook_tpu_torch.cluster.fake.factory",
             "kwargs": {"name": f"h-{pool}", "n_hosts": hosts, "pool": pool,
                        "cpus": 64.0, "mem": 65_536.0,
                        "default_task_duration_ms": 3_000,
                        "auto_advance": True}}
            for pool in H_POOLS]


def h_specs(n_jobs, n_users, writers, batch) -> list:
    """Writer i's (user, specs) batches, every job in pool ``H_POOLS[i]``:
    1 cpu and 256 MB, exit 0; each batch from the next user."""
    per_writer = n_jobs // (writers * batch)
    return [[(f"user{(i * per_writer + b) % n_users:03d}",
              [{"command": "true", "cpus": 1.0, "mem": 256.0,
                "pool": H_POOLS[i]} for _ in range(batch)])
             for b in range(per_writer)] for i in range(writers)]


def h_capped(node, url: str) -> dict:
    """The cross-partition count quota: "capped" gets a count quota of
    ``H_CAP`` on the reserved pool "*" (through REST, as an admin), then
    submits ``H_CAP_EACH`` single jobs to prod and as many to research,
    whose tasks run until killed.  Whatever the summaries' age, the
    first ``H_CAP`` are admitted (a summary can only lag behind the
    user's own submissions); once the exchange must sweep anew (older
    than its bound), the rest and the next submission to each pool are
    refused with 422, and no more than ``H_CAP`` of the user's jobs are
    live across the partitions.  Then the user kills them."""
    from cook_tpu_torch.client import JobClient, JobClientError
    from cook_tpu_torch.state import JobState
    ex = node.store.summaries
    JobClient(url, user="admin").set_quota("capped",
                                           {"*": {"count": H_CAP}})
    client = JobClient(url, user="capped")
    client.throttle_retries = 0
    env = {"COOK_FAKE_DURATION_MS": str(H_CAP_TASK_MS)}
    order = ["prod"] * H_CAP_EACH + ["research"] * H_CAP_EACH
    accepted, answers, t0 = [], [], time.perf_counter()
    for k, pool in enumerate(order + ["prod", "research"]):
        if k == H_CAP:
            # the next check sweeps every partition's summary anew
            wait_for(lambda: ex.staleness_s() > ex.max_age_s, 10.0,
                     "phase H: the summary exchange's window")
        try:
            accepted += client.submit([{"command": "true", "cpus": 1.0,
                                        "mem": 256.0, "env": env}],
                                      pool=pool)
            answers.append([pool, 200])
        except JobClientError as e:
            if e.status != 422 or "global quota" not in e.message:
                raise
            answers.append([pool, 422])
    owners = sorted({node.store._partition_of_job(u) for u in accepted})

    def live():
        return sum(1 for j in node.store.jobs_where(
            lambda j: j.user == "capped", clone=False)
            if j.state is not JobState.COMPLETED)

    n_live = live()
    want = [[p, 200] for p in order[:H_CAP]] \
        + [[p, 422] for p in order[H_CAP:] + ["prod", "research"]]
    if answers != want or n_live > H_CAP or owners != [0, 1]:
        raise AssertionError(f"phase H: capped answers {answers}, "
                             f"{n_live} live, partitions {owners}")
    client.kill(accepted)
    wait_for(lambda: live() == 0, 60.0, "phase H: the capped jobs killed")
    return {"quota": H_CAP, "answers": [a[1] for a in answers],
            "admitted": len(accepted), "live_at_most": n_live,
            "partitions": owners, "refusal_staleness_bound_s": ex.max_age_s,
            "wall_s": time.perf_counter() - t0}


def h_small(device: str, hosts=H_SMALL["hosts"], jobs=H_SMALL["jobs"],
            users=H_SMALL["users"]) -> list:
    """One ``step_cycle`` (depth 0) of the port's ``Scheduler`` on
    ``device`` over a four-partition in-memory store (the phase's map)
    and one fake cluster of ``hosts`` hosts of 8 cpus and 8,192 MB a
    pool, every job submitted before it; the launched (job uuid,
    hostname) pairs."""
    from cook_tpu_torch.cluster import FakeCluster, FakeHost
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import (Job, PartitionedStore, PartitionMap,
                                      Pool, Resources, Store)
    pmap = PartitionMap(H_PARTITIONS["count"], H_PARTITIONS["pools"])
    store = PartitionedStore([Store(partition=i) for i in range(pmap.count)],
                             pmap)
    store.clock = lambda: 1_700_000_000_000
    for pool in H_POOLS:
        store.put_pool(Pool(name=pool))
    store.create_jobs([Job(
        uuid=f"00000000-0000-4000-8000-{k:012d}",
        user=f"user{k % users:02d}", command="true",
        pool=H_POOLS[k % len(H_POOLS)], priority=1 + (k * 37) % 100,
        resources=Resources(cpus=1.0 + k % 3, mem=256.0 * (1 + k % 4)))
        for k in range(jobs)])
    clusters = [FakeCluster(f"h-{pool}", [
        FakeHost(f"h-{pool}-{i}", pool=pool,
                 capacity=Resources(cpus=8.0, mem=8192.0))
        for i in range(hosts)]) for pool in H_POOLS]
    cfg = Config()
    cfg.pipeline.depth = 0
    cfg.columnar_index = cfg.resident_pack = False
    sched = Scheduler(store, cfg, clusters, device=device)
    try:
        res = sched.step_cycle()
        return sorted((store.instance(t).job_uuid, store.instance(t).hostname)
                      for r in res.values() for t in r.launched_task_ids)
    finally:
        sched.shutdown()


def h_scan(data: Path, i: int):
    """Partition ``i``'s journal, which must scan clean to its end."""
    from cook_tpu_torch.state.integrity import scan_journal
    j = scan_journal(str(data / f"p{i}" / "journal.jsonl"))
    if j.corrupt or j.good != j.size:
        raise AssertionError(f"phase H: p{i}'s journal unsound: {j.reason}")
    return j


def h_detail(seq0: int) -> dict:
    """p50 and p99 of each ``detail_ms`` entry (pack, stage, apply) over
    the fused flight records after ``seq0``."""
    from cook_tpu_torch.utils.flight import recorder
    recs = [r for r in recorder.recent(10_000)
            if r["seq"] > seq0 and r["kind"] == "fused"]
    out = {"records": len(recs)}
    for k in ("pack", "stage", "apply"):
        xs = [r["detail_ms"][k] for r in recs if k in r["detail_ms"]]
        if xs:
            out[f"{k}_ms_p50"] = float(np.percentile(xs, 50))
            out[f"{k}_ms_p99"] = float(np.percentile(xs, 99))
    return out


def phase_h(device="cuda", n_jobs=H_JOBS, n_users=H_USERS, hosts=H_HOSTS,
            writers=H_WRITERS, batch=H_BATCH) -> dict:
    """The partitioned node: ``CookDaemon.start()`` opens ``p0`` ... ``p3``
    and leads on ``device``; 4 writers submit, each to one pool; the
    daemon's own loops place and complete every job; every launch of its
    cycles is recorded and replayed against its plain version after its
    step (path ``partitioned_node``); no host over capacity and no job
    live twice after every step; every job in its pool's partition, each
    writer's token with an entry for its partition; ``h_capped``;
    ``/debug/replication``'s four partition blocks at each partition's
    journal head, the monitor's head gauge one series a partition; no
    cycle degraded; after ``shutdown()`` each journal scans clean, the
    reopened plane holds every acknowledged job in its state, and
    another map is refused; then ``H_SMALL`` on the card and the CPU."""
    import shutil
    import tempfile
    import threading

    from cook_tpu_torch.client import JobClient
    from cook_tpu_torch.daemon import CookDaemon
    from cook_tpu_torch.state import (JobState, PartitionedStore,
                                      PartitionMap, PartitionRoutingError,
                                      Pool, parse_token_vector)
    from cook_tpu_torch.utils.metrics import registry
    card = device == "cuda"
    out = {"phase": "H"}
    tmp = Path(tempfile.mkdtemp(prefix="cook_part"))
    data = tmp / "data-h"
    t0 = time.perf_counter()
    pmap = PartitionMap(H_PARTITIONS["count"], H_PARTITIONS["pools"])
    owner = [pmap.partition_of(pool) for pool in H_POOLS]
    if owner != [0, 1, 2, 3]:
        raise AssertionError(f"phase H: the pools route to {owner}")
    specs = h_specs(n_jobs, n_users, writers, batch)
    conf = node_conf(tmp, "h", device, 0)
    conf["clusters"] = h_clusters(hosts)
    conf["scheduler"]["partitions"] = dict(H_PARTITIONS)
    node = CookDaemon(conf)
    running, rec = True, None

    def leader():
        if node.exit_code != 0:
            raise AssertionError("phase H: the takeover failed")
        return node.scheduler

    try:
        node.start()
        sched = wait_for(leader, 60.0, "phase H: leadership")
        out["lead_s"] = time.perf_counter() - t0
        store = node.store
        if sched.device.type != torch.device(device).type:
            raise AssertionError(f"phase H: the leader runs on "
                                 f"{sched.device}")
        if not isinstance(store, PartitionedStore) \
                or node.sched_config.columnar_index \
                or node.sched_config.resident_pack:
            raise AssertionError("phase H: not a partitioned node on the "
                                 "entity path")
        dirs = sorted(os.listdir(data))
        if dirs != ["p0", "p1", "p2", "p3", "partition_map.json"]:
            raise AssertionError(f"phase H: the data dir holds {dirs}")
        for pool in H_POOLS:
            store.put_pool(Pool(name=pool))
        # the loops wait one interval before their first tick: the
        # recorder starts (and zeroes the counts) before any launch
        rec = ReplayingRecorder("phase H") if card else None
        guard = threading.Lock()
        faults = []
        seq0, counter0 = flight_seq(), fallbacks("fused.pool_cycle")
        rebalances = guard_rebalancer(sched, guard)

        def no_fault():
            if faults:
                raise AssertionError(f"phase H: {len(faults)} step_cycle "
                                     f"calls failed") from faults[0]

        if rec is not None:
            rec.start()
        steps, calls = checked_steps(
            sched, rec, guard, lambda label: check_live(node, label),
            "phase H", faults)
        clients = []
        sub = submit_batches(node.node_url, specs, clients)
        acked, last_ack = sub.pop("acked"), sub.pop("last_ack")
        out["h1"] = sub
        # writer i submitted to H_POOLS[i] only, its uuids in turn
        each = len(acked) // writers
        astray = [(u, k // each) for k, u in enumerate(acked)
                  if store._partition_of_job(u) != owner[k // each]]
        untokened = [(i, c.last_commit_offset)
                     for i, mine in enumerate(clients) for c in mine.values()
                     if owner[i] not in {e[0] for e in parse_token_vector(
                         c.last_commit_offset)}]
        if astray or untokened:
            raise AssertionError(f"phase H: jobs outside their pool's "
                                 f"partition {astray[:3]}, tokens without "
                                 f"the writer's partition {untokened[:3]}")

        def count(state):
            no_fault()
            return len(store.jobs_where(lambda j: j.state is state,
                                        clone=False))

        wait_for(lambda: count(JobState.WAITING) == 0, H_TIMEOUT_S,
                 "phase H: every job placed", every=0.1)
        placed_s = time.perf_counter() - last_ack
        wait_for(lambda: count(JobState.COMPLETED) == len(acked),
                 H_TIMEOUT_S, "phase H: every job completed", every=0.1)
        completed_s = time.perf_counter() - last_ack
        out["h3"] = h_capped(node, node.node_url)
        states = {j.uuid: j.state.value
                  for j in store.jobs_where(lambda j: True, clone=False)}
        with guard:
            admin = JobClient(node.node_url, user="admin")
            for _ in range(20):
                heads = [s.commit_offset() for s in store.partitions]
                repl = admin.debug_replication()
                if heads == [s.commit_offset() for s in store.partitions]:
                    break
            blocks = [(b["partition"], b["journal_bytes"])
                      for b in repl["partitions"]]
            sched.monitor.sweep()
            # an earlier node of this process left its one-store series,
            # which carries no partition label
            gauge = {dict(lbl)["partition"]: v for lbl, v
                     in registry.series("cook_journal_head_bytes")
                     if "partition" in dict(lbl)}
            exchange = dict(store.summaries.stats())
            scans = [h_scan(data, i) for i in range(pmap.count)]
            steps_ms = [s[2] * 1e3 for s in steps]
            out["h2"] = {
                "placed_after_last_ack_s": placed_s,
                "completed_after_last_ack_s": completed_s,
                "step_cycles": len(steps),
                "dispatching_cycles": sum(1 for s in steps if s[1]),
                "launched": sum(s[1] for s in steps),
                "step_ms_p50": float(np.percentile(steps_ms, 50)),
                "step_ms_p99": float(np.percentile(steps_ms, 99)),
                "flight_detail": h_detail(seq0),
                "steps": [[round(t - last_ack, 3), n, s * 1e3, r * 1e3]
                          for t, n, s, r in steps],
                "replay_and_check_s": sum(s[3] for s in steps),
                "partitions": [{
                    "partition": f"p{i}", "pool": H_POOLS[i],
                    "journal_bytes": heads[i],
                    "journal_commits": len(scans[i].records),
                    "jobs": sum(1 for u in states
                                if store._partition_of_job(u) == i)}
                    for i in range(pmap.count)],
                "summary_exchange": exchange}
        want = [(f"p{i}", h) for i, h in enumerate(heads)]
        if blocks != want or sorted(gauge) != [f"p{i}" for i in range(4)] \
                or [gauge[f"p{i}"] for i in range(4)] != heads:
            raise AssertionError(f"phase H: /debug/replication {blocks} "
                                 f"and the head gauge {gauge}, heads "
                                 f"{heads}")
        node.shutdown()
        running = False
        counts = rec.stop() if rec is not None else {}
        no_fault()
        if len(steps) != calls[0]:
            raise AssertionError(f"phase H: {calls[0]} step_cycle calls, "
                                 f"{len(steps)} checked")
        degraded = degraded_since(seq0, counter0)
        out["h2"]["degraded_cycles"] = degraded
        out["h2"]["rebalancer_pool_passes"] = len(rebalances)
        if degraded["fallback_counter"] or degraded["flight_notes"]:
            raise AssertionError(f"phase H: cycles degraded to the split "
                                 f"path: {degraded}")
        if card:
            missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"phase H: kernels not launched: "
                                     f"{missing}")
            skipped = rec.unreplayed(counts)
            if skipped:
                raise AssertionError(f"phase H: launches not replayed "
                                     f"(path, replays): {skipped}")
            out["h2"]["launches_per_kernel"] = counts
            out["h2"]["replayed_equal_to_plain"] = rec.replayed
        t1 = time.perf_counter()
        journals = [len(h_scan(data, i).records) for i in range(pmap.count)]
        reopened = PartitionedStore.open(str(data), pmap)
        try:
            lost = [u for u in states if reopened.job(u) is None
                    or reopened.job(u).state.value != states[u]]
        finally:
            reopened.close()
        if lost:
            raise AssertionError(f"phase H: {len(lost)} acknowledged jobs "
                                 f"not read back: {lost[:3]}")
        try:
            PartitionedStore.open(str(data), PartitionMap(
                4, {**H_PARTITIONS["pools"], "batch": 0})).close()
            raise AssertionError("phase H: another map reopened the plane")
        except PartitionRoutingError:
            pass
        out["h4"] = {"journal_records_after_checkpoint": journals,
                     "read_back": len(states),
                     "states": sorted(set(states.values())),
                     "other_map_refused": True,
                     "reopen_s": time.perf_counter() - t1}
    finally:
        if running:
            node.shutdown()
        if rec is not None and rec._ctx is not None:
            rec._ctx.__exit__(None, None, None)
        shutil.rmtree(tmp, ignore_errors=True)
    t1 = time.perf_counter()
    pairs = [h_small(device), cpu_side("h_small")]
    if not pairs[0] or pairs[0] != pairs[1]:
        raise AssertionError(f"phase H small: {device} placed "
                             f"{len(pairs[0])} jobs and cpu "
                             f"{len(pairs[1])}, not the same pairs")
    out["h5"] = {**H_SMALL, "pools": len(H_POOLS), "placed": len(pairs[0]),
                 "devices": [device, "cpu"], "equal": True,
                 "wall_s": time.perf_counter() - t1}
    out["world"] = {"partitions": H_PARTITIONS, "pools": list(H_POOLS),
                    "hosts_per_pool": hosts, "cpus": 64.0, "mem": 65_536.0,
                    "jobs": n_jobs, "users": n_users,
                    "users_submitting": len({u for w in specs
                                             for u, _ in w}),
                    "writers": writers, "batch": batch, "task_s": 3.0}
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return counts


# ------------------------------------- phase SH: the mesh and the shards
SH_MESHES = ((1,), (2,), (4,), (2, 2))   # pool_mesh(n), multislice(2, 2)
# quota groups that span slots on every mesh of more than one slot: pools
# 0 and 2, 1 and 3; each group's cap its pools' running total plus 1,000
# cpus, which one cycle's placements pass, so the caps bind
SH_GROUPS = np.array([0, 1, 0, 1], np.int32)
SH_HEADROOM = np.array([1000.0, 1e12, 1e6, 1e9], np.float32)
SH_REPS = 5
SH_POOLS = ["pool0", "pool1", "pool2", "pool3"]
# the design point over 4 pools: 200 users; 1,250 hosts of 16 cpus and
# 16 GiB a pool; 25,000 jobs for the smoke's time (50,000 until phase FO
# joined the run): each worker builds the whole world at boot
SH_WORLD = {"n_jobs": 25_000, "n_users": 200, "hosts_per_pool": 1_250,
            "host_cpus": 16.0, "host_mem": 16384.0, "seed": 3}
SH_CFG = {"resident": True, "quantized": True, "depth": 0}
SH_SMALL = {"n_jobs": 1_600, "n_users": 20, "hosts_per_pool": 8,
            "host_cpus": 16.0, "host_mem": 16384.0, "seed": 5}
# SH1's driver leg: 4 pools of 1,500 jobs over 200 hosts each, the quota
# groups spanning the two slots.  A cycle admits up to 1,000 jobs of 1-3
# cpus a pool, so after the first (about 2,000 cpus a pool running) a
# group's cap leaves each of its pools 500-700 cpus of the about 1,000
# its last 500 jobs ask, where a slot-local group base would leave 2,500
SH_DRIVER_WORLD = {"n_jobs": 6_000, "n_users": 200, "hosts_per_pool": 200,
                   "host_cpus": 16.0, "host_mem": 16384.0, "seed": 7}
SH_DRIVER_GROUPS = {"pool0": "g0", "pool2": "g0", "pool1": "g1",
                    "pool3": "g1"}
SH_DRIVER_CPUS = {"g0": 4_500.0, "g1": 4_700.0}
SH_DRIVER_CYCLES = 3
SH_WARM, SH_TIMED = 1, 3
SH_MAX_AGE_S = 2.0
SH_CYCLE_TIMEOUT_S = 300.0


def sh_mesh(shape, device):
    from cook_tpu_torch.parallel.mesh import multislice_pool_mesh, pool_mesh
    if len(shape) == 2:
        return multislice_pool_mesh(*shape, device=device)
    return pool_mesh(shape[0], device=device)


def sh_world(live=LIVE, hosts=HOSTS):
    """Phase A's world with its quota groups spanning slots."""
    w = build_world(np.random.default_rng(SEED), live=live, hosts=hosts)
    group_total = np.stack([w.run_total[SH_GROUPS == g].sum(0)
                            for g in SH_GROUPS])
    w.scalars = {**w.scalars, "group_id": SH_GROUPS.copy(),
                 "group_quota": (group_total + SH_HEADROOM)
                 .astype(np.float32)}
    return w


def sh_compact(w) -> dict:
    """The world as the JAX package's CompactPoolCycleInputs fields."""
    return dict(rows=w.rows, flags=w.flags, res_base=w.res,
                disk_base=w.disk, tokens_u=w.tokens, shares_u=w.shares,
                quota_u=w.quota, **w.scalars, host_gpu=w.host_gpu,
                host_blocked=w.blocked, exc_rows=w.exc_rows,
                exc_mask=w.exc_mask, avail=w.avail, capacity=w.cap)


def sh_sync(card: bool) -> None:
    if card:
        torch.cuda.synchronize()


def sh_driver(device, mesh=None):
    """A ``Scheduler`` over ``SH_DRIVER_WORLD``'s 4 pools (``SH_CFG``:
    resident, quantized, depth 0; the quota groups ``SH_DRIVER_GROUPS``)
    and a ``FusedCycleDriver`` on ``device`` over ``mesh`` (default one
    slot).  Returns (store, scheduler, driver)."""
    from cook_tpu_torch.cluster import FakeCluster
    from cook_tpu_torch.config import PoolQuota
    from cook_tpu_torch.sched.fused import FusedCycleDriver
    from cook_tpu_torch.sched.scheduler import Scheduler
    from cook_tpu_torch.sched.shard import (build_world_hosts,
                                            build_world_jobs,
                                            config_from_spec)
    from cook_tpu_torch.state.schema import Pool
    from cook_tpu_torch.state.store import Store
    cfg = config_from_spec(SH_CFG)
    cfg.quota_groups = dict(SH_DRIVER_GROUPS)
    cfg.quota_group_quotas = {g: PoolQuota(cpus=c)
                              for g, c in SH_DRIVER_CPUS.items()}
    store = Store()
    for name in SH_POOLS:
        store.put_pool(Pool(name=name))
    cluster = FakeCluster("fake-mesh",
                          build_world_hosts(SH_DRIVER_WORLD, SH_POOLS))
    sched = Scheduler(store, cfg, [cluster], rank_backend="tpu",
                      device=device)
    store.create_jobs(build_world_jobs(SH_DRIVER_WORLD, SH_POOLS))
    drv = FusedCycleDriver(store, cfg, sched.matcher, sched.plugins,
                           sched.rate_limits, device=device, mesh=mesh)
    return store, sched, drv


def sh_pairs(store, jobs) -> set:
    """The launched (job uuid, hostname) pairs of ``jobs``."""
    return {(j.uuid, store.instance(t).hostname)
            for j in jobs for t in store.job(j.uuid).instances
            if store.instance(t) is not None}


def phase_sh1(device="cuda", **size) -> dict:
    """The mesh cycle: phase A's wire with slot-spanning quota groups
    through ``make_pool_cycle(mesh, compact=True)`` on 1, 2 and 4 slots
    of one card and the 2 x 2 multislice mesh, each launch recorded and
    replayed against its plain version, every output equal bit for bit
    to the one-device ``megacycle`` and ``megacycle_plain`` on the same
    wire (and the gathered bases to the one-device plain bases); the
    wire's blocks on their own (each slot's group base its own) decide
    otherwise.  Then the negotiated wire (quantized, gangs) through
    ``mesh_megacycle`` on two slots, equal to one device; and
    ``FusedCycleDriver`` over two slots (resident and quantized: a cold
    repack, then delta scatters into each slot's buffers), its launched
    (job uuid, hostname) pairs equal to the one-slot driver's after
    every cycle.  The launches of the mesh cycles and of the two-slot
    driver are the path ``mesh_cycle``."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.ops.pallas_cycle import (MegaCycleResult,
                                                 MegaCycleWire, megacycle,
                                                 megacycle_plain)
    from cook_tpu_torch.parallel.mesh import pool_sharding
    from cook_tpu_torch.parallel.sharded import (compact_inputs_from_numpy,
                                                 compact_wire,
                                                 make_pool_cycle,
                                                 mesh_megacycle, pool_cycle,
                                                 shard_wire)
    card = device == "cuda"
    dev = "cuda:0" if card else "cpu"
    t0 = time.perf_counter()
    w = sh_world(**size)
    inp = compact_inputs_from_numpy(sh_compact(w), dev)
    wire = compact_wire(inp)
    cap = 1024
    want = megacycle(wire, considerable_cap=cap, device=dev)
    plain = megacycle_plain(wire, considerable_cap=cap)
    bases = pool_cycle(inp, considerable_cap=cap, device=dev)
    sh_sync(card)
    for k in MegaCycleResult._fields:
        max_err(getattr(want, k), getattr(plain, k))
    out = {"phase": "SH1", "meshes": {}, "shape": {
        "P": P, "T": w.T, "H": w.H, "C": cap, "live_rows": w.live,
        "hosts": int((~w.blocked).sum(1).max()), "groups": SH_GROUPS.tolist()}}
    counts, replayed = {}, 0

    def counted(fn, what):
        nonlocal replayed
        telemetry.reset_all()
        with cuda_lib.recording() as calls:
            res = fn()
        sh_sync(card)
        launched = telemetry.snapshot()
        for k, n in launched.items():
            counts[k] = counts.get(k, 0) + n
        if card:
            replay_all(calls, what)
            replayed += len(calls)
        return res, launched

    for shape in SH_MESHES:
        name = "x".join(map(str, shape))
        mesh = sh_mesh(shape, dev)
        cycle = make_pool_cycle(mesh, considerable_cap=cap, compact=True)
        got, launched = counted(lambda: cycle(inp), f"phase SH1 {name}")
        for k in MegaCycleResult._fields:
            max_err(getattr(got, k), getattr(want, k))
        max_err(got.pool_base, bases.pool_base)
        max_err(got.group_base, bases.group_base)
        parts = shard_wire(mesh, wire)
        t1 = time.perf_counter()
        if card:
            ms = cuda_ms(lambda: mesh_megacycle(mesh, parts,
                                                considerable_cap=cap),
                         SH_REPS)
            full_ms = cuda_ms(lambda: cycle(inp), SH_REPS)
        else:
            mesh_megacycle(mesh, parts, considerable_cap=cap)
            ms = full_ms = (time.perf_counter() - t1) * 1e3
        out["meshes"][name] = {
            "slots": mesh.size, "axes": list(mesh.axis_names),
            "devices": [str(d) for d in mesh.devices], "ms": ms,
            "make_pool_cycle_ms": full_ms, "launches": launched,
            "placed": int((got.cand_gang >= 0).sum()),
            "total_matched": int(got.total_matched),
            "matched_cpus": float(got.matched_usage[:, 0].sum())}
    # each slot's block with its own group base decides otherwise
    differs = False
    for b in pool_sharding(sh_mesh((2,), dev)).blocks(P):
        block = MegaCycleWire(*(t if k in ("res_base", "disk_base") else
                                t[b].contiguous() for k, t in
                                zip(MegaCycleWire._fields, wire)))
        alone = megacycle(block, considerable_cap=cap, device=dev)
        differs |= any(not torch.equal(getattr(alone, k),
                                       getattr(want, k)[b])
                       for k in MegaCycleResult._fields)
    if not differs:
        raise AssertionError("phase SH1: the group caps never bind across "
                             "slots")
    # the driver's negotiated wire (quantized, gangs) on two slots
    res_dev = torch.from_numpy(w.res).to(dev)
    disk_dev = torch.from_numpy(w.disk).to(dev)
    staged = stage(w, res_dev, disk_dev, {}, device=dev)
    args = megacycle_args(staged)
    one = megacycle(staged["wire"], device=dev, **args)
    mesh2 = sh_mesh((2,), dev)
    parts = shard_wire(mesh2, staged["wire"])
    two, launched = counted(lambda: mesh_megacycle(mesh2, parts, **args),
                            "phase SH1 negotiated")
    for k in MegaCycleResult._fields:
        max_err(getattr(two, k), getattr(one, k))
    out["negotiated_2"] = {
        "codecs": [staged["rows_codec"], str(staged["avail_scale"]),
                   str(staged["cap_scale"])],
        "placed": int((two.cand_gang >= 0).sum()),
        "dropped": int(two.cand_dropped.sum()), "launches": launched}
    out["driver_2"] = sh1_driver(dev, counted)
    missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
    if card and missing:
        raise AssertionError(f"phase SH1: kernels not launched: {missing}")
    out.update(slot_local_bases_differ=differs, equal=True,
               replayed_equal_to_plain=replayed,
               launches_per_kernel=counts,
               wall_s=time.perf_counter() - t0)
    print(json.dumps(out))
    return counts


def sh1_driver(dev, counted) -> dict:
    """SH1's driver leg: one-slot and two-slot ``FusedCycleDriver``s on
    ``dev`` over the same world, ``SH_DRIVER_CYCLES`` synchronous cycles
    each (a cold repack, then delta scatters); the two-slot driver's
    cycles go through ``counted`` (launches recorded and replayed).
    Their launched pairs must be equal after every cycle; the resident
    path is the cold repack first and then the delta (or, where no slot
    changed, none), with at least one delta."""
    from cook_tpu_torch.ops import telemetry
    from cook_tpu_torch.sched.shard import build_world_jobs
    t0 = time.perf_counter()
    jobs = build_world_jobs(SH_DRIVER_WORLD, SH_POOLS)
    one_store, one_sched, one = sh_driver(dev)
    two_store, two_sched, two = sh_driver(dev, sh_mesh((2,), dev))
    out = {"world": SH_DRIVER_WORLD, "groups": SH_DRIVER_GROUPS,
           "group_cpus": SH_DRIVER_CPUS, "cycles": []}
    try:
        for c in range(SH_DRIVER_CYCLES):
            one.step(one_sched)

            def step():
                two.step(two_sched)
                return telemetry.events()
            ev, launched = counted(step, f"phase SH1 driver cycle {c}")
            for s in (one_sched, two_sched):
                s.flush_status_updates()
            pairs = [sh_pairs(one_store, jobs), sh_pairs(two_store, jobs)]
            if pairs[0] != pairs[1]:
                raise AssertionError(
                    f"phase SH1 driver cycle {c}: two slots launched "
                    f"{len(pairs[1])} pairs, one slot {len(pairs[0])}, "
                    f"{len(pairs[0] ^ pairs[1])} differ")
            repacks = sorted(k for k in ev if k.startswith("resident.repack"))
            path = ("cold" if repacks == ["resident.repack.cold"] else
                    repacks or ("delta" if ev.get("resident.delta_rows")
                                else "empty"))
            if path not in (("cold",) if c == 0 else ("delta", "empty")):
                raise AssertionError(f"phase SH1 driver cycle {c}: the "
                                     f"resident path was {path}")
            out["cycles"].append({"running": len(pairs[1]), "path": path,
                                  "delta_rows": ev.get(
                                      "resident.delta_rows", 0),
                                  "launches": launched})
    finally:
        one_sched.shutdown()
        two_sched.shutdown()
    if two.mesh().size != 2 or len(two._slots) != 2:
        raise AssertionError("phase SH1 driver: not a two-slot driver")
    if "delta" not in [c["path"] for c in out["cycles"]]:
        raise AssertionError("phase SH1 driver: no delta cycle")
    out.update(slots=2, equal=True, wall_s=time.perf_counter() - t0)
    return out


def sh_topology(n, world, device, root):
    from cook_tpu_torch.sched.shard import sched_topology
    t0, wall0 = time.perf_counter(), time.time()
    sup = sched_topology(n, SH_POOLS, world, cfg=SH_CFG,
                         summary_max_age_s=SH_MAX_AGE_S, root=str(root),
                         device=device)
    boot = time.perf_counter() - t0
    # a worker's boot: from the spawn to its address file
    each = [os.path.getmtime(sp.addr_file) - wall0 for sp in sup.procs]
    return sup, {"topology_s": boot, "workers_s": each}


def sh_rounds(sup, warm=SH_WARM, timed=SH_TIMED):
    """``warm`` then ``timed`` rounds of one cycle on every shard at
    once: each round's wall (host clock, the supervisor's broadcast) and
    each shard's own cycle ms."""
    rounds, per_shard = [], {}
    for i in range(warm + timed):
        t0 = time.perf_counter()
        resps = sup.broadcast({"cmd": "cycle", "n": 1},
                              timeout_s=SH_CYCLE_TIMEOUT_S)
        wall = (time.perf_counter() - t0) * 1e3
        if len(resps) != len(sup.procs):
            raise AssertionError("phase SH2: a shard did not answer")
        if i >= warm:
            rounds.append(wall)
            for sp, r in zip(sup.procs, resps):
                per_shard.setdefault(sp.shard, []).extend(r["durations_ms"])
    return rounds, per_shard


def sh_pcts(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)), "all": list(xs)}


def sh_check(decisions: dict, world: dict, what: str) -> int:
    """No host over capacity and no job live twice, from the launched
    set and the world's jobs; returns the jobs placed."""
    from cook_tpu_torch.sched.shard import build_world_jobs
    jobs = {j.uuid: j for j in build_world_jobs(world, SH_POOLS)}
    if set(decisions) != set(jobs):
        raise AssertionError(f"{what}: decisions for {len(decisions)} of "
                             f"{len(jobs)} jobs")
    cap = np.array([world["host_cpus"], world["host_mem"]])
    used, placed = {}, 0
    for uuid, (state, hosts) in decisions.items():
        if len(hosts) > 1:
            raise AssertionError(f"{what}: job {uuid} live on {hosts}")
        if hosts:
            if state != "running":
                raise AssertionError(f"{what}: job {uuid} {state} on "
                                     f"{hosts}")
            r = jobs[uuid].resources
            used.setdefault(hosts[0], np.zeros(2))
            used[hosts[0]] += (r.cpus, r.mem)
            placed += 1
    over = [h for h, u in used.items() if (u > cap).any()]
    if over:
        raise AssertionError(f"{what}: hosts over capacity: {over[:5]}")
    return placed


def sh_worker_counts(spec_file: str) -> tuple:
    """One ``_SchedWorker`` built in this process from a topology's
    shard spec: its ``setup`` and two ``handle({"cmd": "cycle"})``, each
    under ``cuda_lib.recording()`` and replayed against the plain
    versions after it.  Returns (launches by kernel, replays, cycle
    ms)."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.sched.shard import _SchedWorker
    from cook_tpu_torch.utils import flight
    spec = json.loads(Path(spec_file).read_text())
    worker = _SchedWorker(spec)
    counts, replayed, ms = {}, 0, []
    try:
        worker.setup()
        for _ in range(2):
            telemetry.reset_all()
            with cuda_lib.recording() as calls:
                resp = worker.handle({"cmd": "cycle", "n": 1})
            torch.cuda.synchronize()
            for k, n in telemetry.snapshot().items():
                counts[k] = counts.get(k, 0) + n
            replay_all(calls, "phase SH2 worker")
            replayed += len(calls)
            ms.extend(resp["durations_ms"])
    finally:
        flight.set_shard(None)
        sched = getattr(worker, "sched", None)
        if sched is not None:
            sched.shutdown()
    return counts, replayed, ms


def sh_small(device: str) -> dict:
    """SH_SMALL through four shard processes on ``device``."""
    import shutil
    import tempfile
    root = Path(tempfile.mkdtemp(prefix="cook_sh_small"))
    try:
        sup, _boot = sh_topology(4, SH_SMALL, device, root)
        try:
            sh_rounds(sup, 0, 3)
            got = sup.collect_decisions()
        finally:
            sup.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sh_check(got, SH_SMALL, f"phase SH2 small on {device}")
    return {u: [s, list(h)] for u, (s, h) in sorted(got.items())}


def phase_sh2(device="cuda", world=SH_WORLD) -> dict:
    """The sharded controllers: ``sched_topology`` over 4 pools of
    ``world`` on ``device`` (the default fused cycle, resident and
    quantized wire, depth 0), one process and then four, ``SH_WARM``
    rounds then ``SH_TIMED`` timed; the four-process launched set equal
    to the one-process set, no host over capacity, no job live twice;
    the flight summaries and the stitched trace (a process track a
    shard); shard 1 SIGKILLed, shard 0's totals reported stale.  A
    shard-0 worker built in this process from the topology's spec has
    its kernels counted (path ``sharded_controllers``) and replayed.
    Then ``SH_SMALL`` on four processes on the card and on the CPU."""
    import shutil
    import tempfile
    card = device == "cuda"
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="cook_sh"))
    out = {"phase": "SH2", "world": world, "config": SH_CFG,
           "pools": SH_POOLS}
    try:
        sup, boot1 = sh_topology(1, world, device, tmp / "one")
        try:
            rounds1, shard1 = sh_rounds(sup)
            d1 = sup.collect_decisions()
        finally:
            sup.stop()
        sup, boot4 = sh_topology(4, world, device, tmp / "four")
        try:
            rounds4, shard4 = sh_rounds(sup)
            d4 = sup.collect_decisions()
            flight = sup.collect_flight()
            trace = sup.collect_trace("phase-sh2")
            spec0 = sup.procs[0].spec_file
            fresh = sup.rpc(0, {"cmd": "user_totals", "user": "user0"})
            t1 = time.perf_counter()
            sup.kill(1)
            stale = None
            while time.perf_counter() - t1 < 30.0:
                resp = sup.rpc(0, {"cmd": "user_totals", "user": "user0"})
                if "stale" in resp:
                    stale = resp["stale"]
                    break
                time.sleep(0.1)
            stale_s = time.perf_counter() - t1
            if stale is None:
                raise AssertionError("phase SH2: shard 0 served totals 30 s "
                                     "after its peer died")
            counts, replayed, worker_ms = ({}, 0, [])
            if card:
                counts, replayed, worker_ms = sh_worker_counts(spec0)
        finally:
            sup.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if d4 != d1:
        bad = [u for u in d1 if d1[u] != d4.get(u)]
        raise AssertionError(f"phase SH2: 4 processes decided otherwise "
                             f"than 1 on {len(bad)} jobs: {bad[:3]}")
    placed = sh_check(d4, world, "phase SH2")
    if placed <= 0:
        raise AssertionError("phase SH2: nothing placed")
    tracks = {ev["args"]["name"] for ev in trace["traceEvents"]
              if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    pids = {ev["pid"] for ev in trace["traceEvents"]}
    if sorted(flight) != [0, 1, 2, 3] or len(pids) != 4 \
            or not {f"shard-{i}" for i in range(4)} <= tracks:
        raise AssertionError(f"phase SH2: flight of shards {sorted(flight)}"
                             f", trace tracks {sorted(tracks)}")
    kinds = {s: f["by_kind"] for s, f in flight.items()}
    if any(k != {"fused": SH_WARM + SH_TIMED} for k in kinds.values()) \
            or any(f["faults"] for f in flight.values()):
        raise AssertionError(f"phase SH2: cycles not all fused: {kinds}, "
                             f"{[f['faults'] for f in flight.values()]}")
    if card:
        missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"phase SH2: kernels not launched in a "
                                 f"worker: {missing}")
    t1 = time.perf_counter()
    pairs = [sh_small(device), cpu_side("sh_small")]
    if not pairs[0] or pairs[0] != pairs[1]:
        raise AssertionError("phase SH2 small: the card's shards and the "
                             "CPU's decided otherwise")
    out.update({
        "one_process": {"boot": boot1, "round_ms": sh_pcts(rounds1),
                        "cycle_ms": sh_pcts(shard1[0])},
        "four_processes": {
            "boot": boot4, "round_ms": sh_pcts(rounds4),
            "cycle_ms_by_shard": {s: sh_pcts(v) for s, v in shard4.items()},
            "flight_by_shard": {s: f["by_shard"] for s, f in flight.items()},
            "trace_tracks": sorted(tracks),
            "trace_events": len(trace["traceEvents"])},
        "decisions_equal": True, "placed": placed,
        "live_checked": True,
        "totals_fresh_staleness_s": fresh.get("staleness_s"),
        "dead_peer_stale_after_s": stale_s, "stale": stale,
        "worker": {"launches_per_kernel": counts,
                   "replayed_equal_to_plain": replayed,
                   "cycle_ms": worker_ms},
        "small": {**SH_SMALL, "placed": sum(1 for s, h in pairs[0].values()
                                            if h),
                  "devices": [device, "cpu"], "equal": True,
                  "wall_s": time.perf_counter() - t1},
        "wall_s": time.perf_counter() - t0})
    print(json.dumps(out))
    return counts


# ---------------------------------------- phase CH: the chaos simulator
# CH1: sim/chaos.run_chaos at full width on the card: 2,000 jobs from 50
# users over 200 hosts (generate_example_hosts), submitted over 120 s,
# 6 s jobs; 8 gangs of 4 on slice topology, the last at the leader
# kill; the resident wire at pipeline depth 2; delta faults at 0.1 a
# call, launch-RPC faults at 0.15 (at most 50), a node lost every 9 s
# (at most 5), the leader killed at 60 s of virtual time.  The
# reference's fault density: more node losses roll a requeued job's
# oldest audit events off (AuditConfig.per_job_events, 64)
CH_WORLD = {"seed": 7, "n_jobs": 2_000, "n_users": 50, "n_hosts": 200,
            "submit_span_ms": 120_000, "job_duration_ms": 6_000,
            "n_gangs": 8, "gang_size": 4, "resident": True,
            "pipeline_depth": 2, "delta_fault_probability": 0.1,
            "rpc_fault_probability": 0.15, "rpc_fault_max": 50,
            "node_loss_every_ms": 9_000, "node_loss_max": 5,
            "leader_kill_at_ms": 60_000}
# CH2: the reference's tier-1 chaos worlds through the CLI, as far as
# its flags reach them (tests/test_chaos.py, test_pipeline.py:287,
# test_resident.py:424, test_gang.py:1029, test_elastic.py:748,
# test_overload.py:770); the rest of each world is ChaosConfig's
# defaults
CH2_WORLDS = {
    "chaos_seed7": ["--chaos", "--seed", "7"],
    "pipelined": ["--chaos", "--seed", "7", "--jobs", "14", "--n-hosts",
                  "6", "--leader-kill-at-ms", "8000",
                  "--pipeline-depth", "2"],
    "resident_delta_faults": ["--chaos", "--seed", "7", "--resident",
                              "--delta-faults", "0.3"],
    "gangs_depth2": ["--chaos", "--seed", "7", "--jobs", "20",
                     "--n-hosts", "9", "--gangs", "3", "--gang-size", "3",
                     "--pipeline-depth", "2"],
    "elastic": ["--chaos", "--elastic"],
    "disk_faults": ["--chaos", "--seed", "7", "--disk-faults", "0.25"],
    "overload_chaos": ["--overload", "--chaos"]}
# CH3: the failover legs (no kernel: the replication library, the REST
# fence, real shard worker processes)
CH3_LEGS = {
    "sigkill": ["--chaos-failover", "--leader-mode", "sigkill"],
    "partition": ["--chaos-failover", "--leader-mode", "partition"],
    "partitions_in_process": ["--chaos-failover", "--partitions", "2",
                              "--in-process"],
    "partitions_sigkill": ["--chaos-failover", "--partitions", "2"]}


class _NotInjected(logging.Filter):
    """Drops the log records of injected faults (the resident sync logs
    each injected delta fault with its traceback); any other failure is
    logged."""

    def filter(self, record):
        from cook_tpu_torch.utils.faults import FaultInjected
        exc = record.exc_info[1] if record.exc_info else None
        return not isinstance(exc, FaultInjected)


@contextmanager
def chaos_fixtures():
    """``run_chaos``'s generated trace with job uuids from a counter
    (``load_trace`` mints random ones), so that the card's and the CPU's
    runs pair job by job; and the flight recorder's cycle durations one
    fixed list, so that no host-clock reading moves the overload leg's
    ladder (it reads ``cycle_p99``).  The resident sync's logs of the
    injected delta faults are filtered out (:class:`_NotInjected`)."""
    from cook_tpu_torch.sim import chaos
    from cook_tpu_torch.utils.flight import recorder
    generate = chaos.generate_example_trace
    fused_log = logging.getLogger("cook_tpu_torch.sched.fused")
    quiet = _NotInjected()
    fused_log.addFilter(quiet)

    def trace(*args, **kw):
        return [dict(e, uuid=f"00000000-0000-4000-8000-{i:012d}")
                for i, e in enumerate(generate(*args, **kw))]

    chaos.generate_example_trace = trace
    recorder.recent_durations = \
        lambda kinds, limit: [20.0] * max(int(limit), 0)
    try:
        yield
    finally:
        chaos.generate_example_trace = generate
        del recorder.recent_durations
        fused_log.removeFilter(quiet)


def instance_sequences(data_dir) -> dict:
    """Every job's instances in order, from the final journal: hostname,
    status, reason code, start and end on the virtual clock (task ids
    are random)."""
    from cook_tpu_torch.state.store import Store
    store = Store.replay_only(str(data_dir))
    return {job.uuid: [(i.hostname, i.status.value, i.reason_code,
                        i.start_time_ms, i.end_time_ms)
                       for t in job.instances
                       if (i := store.instance(t)) is not None]
            for job in store.jobs_where(lambda j: True)}


def repacks() -> dict:
    from cook_tpu_torch.utils.metrics import registry
    return {labels.get("reason"): v
            for labels, v in registry.series("cook_resident_repack")}


def ch1_run(device="cuda", record=False, **size) -> dict:
    """One ``run_chaos`` of ``CH_WORLD`` (``size`` overrides) on
    ``device``.  Every ``step_cycle`` is timed from its flight record,
    and the repacks of the successor leader's first cycle are counted by
    reason; with ``record`` every launch is replayed against its plain
    version before the next cycle stages (the resident buffers are
    scattered into only there)."""
    import tempfile

    from cook_tpu_torch.sched.scheduler import Scheduler
    from cook_tpu_torch.sim.chaos import ChaosConfig, run_chaos
    from cook_tpu_torch.utils.flight import recorder
    rec = ReplayingRecorder("phase CH1") if record else None
    step_cycle = Scheduler.step_cycle
    steps, leaders, first_of_successor = [], [], {}

    def timed_step(sched):
        if rec is not None:
            rec.drain()
        if not leaders or leaders[-1] is not sched:
            leaders.append(sched)
        before, seq0 = repacks(), recorder.last_seq()
        try:
            return step_cycle(sched)
        finally:
            if len(leaders) == 2 and not first_of_successor:
                after = repacks()
                first_of_successor.update(
                    {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)})
            if recorder.last_seq() > seq0:
                steps.append(recorder.recent(1)[0])

    with tempfile.TemporaryDirectory(prefix="cook_ch") as tmp, \
            chaos_fixtures():
        seq0, fb0, rp0 = flight_seq(), fallbacks("fused.pool_cycle"), \
            repacks()
        Scheduler.step_cycle = timed_step
        if rec is not None:
            rec.start()
        t0 = time.perf_counter()
        try:
            res = run_chaos(ChaosConfig(data_dir=str(Path(tmp) / "data"),
                                        **{**CH_WORLD, **size}),
                            device=device)
        finally:
            wall = time.perf_counter() - t0
            Scheduler.step_cycle = step_cycle
            counts = rec.stop() if rec is not None else None
        seqs = instance_sequences(Path(tmp) / "data")
    rp = repacks()
    summary = res.summary()

    def pcts(xs):
        return {"p50": float(np.percentile(xs, 50)),
                "p99": float(np.percentile(xs, 99))} if xs else None

    return {
        "summary": {k: v for k, v in summary.items() if k != "flight"},
        "flight": summary["flight"], "sequences": seqs, "wall_s": wall,
        "ticks": len(steps), "leaders": len(leaders),
        "step_cycle_ms": pcts([s["duration_ms"] for s in steps]),
        "detail_ms": {k: pcts([s["detail_ms"].get(k, 0.0) for s in steps])
                      for k in ("pack", "stage", "apply")},
        "paths": sorted({str(s["path"]) for s in steps}),
        "repacks_by_reason": {k: v - rp0.get(k, 0) for k, v in rp.items()
                              if v != rp0.get(k, 0)},
        "successor_first_repacks": first_of_successor,
        "degraded": degraded_since(seq0, fb0),
        "counts": counts, "rec": rec}


def _cli(argv) -> tuple:
    """``argv`` through ``cook_tpu_torch.sim``'s ``main`` in this
    process, journaling into a new temporary directory: the exit code,
    the printed summary and the wall seconds."""
    import contextlib
    import io
    import tempfile

    from cook_tpu_torch.sim.__main__ import main as sim_main
    printed = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cook_cli") as tmp:
        saved, tempfile.tempdir = tempfile.tempdir, tmp
        try:
            with contextlib.redirect_stdout(printed):
                rc = sim_main(argv)
        finally:
            tempfile.tempdir = saved
    return rc, json.loads(printed.getvalue()), time.perf_counter() - t0


def ch2_run(device="cuda") -> dict:
    """Each ``CH2_WORLDS`` argv through the CLI (:func:`_cli`) on
    ``device``: the exit code, the printed summary less ``flight``
    (host-clock cycle times), the cycles degraded to the split path and
    the resident repacks of reason ``fault``."""
    out = {}
    with chaos_fixtures():
        for name, argv in CH2_WORLDS.items():
            seq0, fb0, rp0 = flight_seq(), fallbacks("fused.pool_cycle"), \
                repacks()
            rc, summary, wall = _cli(argv + ["--device", device])
            summary.pop("flight", None)
            out[name] = {"exit": rc, "summary": summary, "wall_s": wall,
                         "degraded": degraded_since(seq0, fb0),
                         "fault_repacks": repacks().get("fault", 0)
                         - rp0.get("fault", 0)}
    return out


def phase_ch3() -> dict:
    """``CH3_LEGS`` through the CLI (:func:`_cli`): no kernel and no
    device; each exits 0 with the fields no thread timing decides as
    the reference's tests hold them."""
    out = {}
    for name, argv in CH3_LEGS.items():
        rc, s, wall = _cli(argv)
        if "--partitions" in argv:
            want = {"ok": True, "violations": [], "partitions": 2,
                    "promoted_epoch": 2, "unresolved_writers": 0,
                    "sibling_errors": 0,
                    "process_kill": "--in-process" not in argv}
            timed_ok = (s["victim_indeterminate"] >= 1
                        and s["sibling_commits_during_promotion"] >= 1)
        else:
            want = {"ok": True, "violations": [], "laggard_converged": True,
                    "indeterminate_commits": 1, "audit_timeline_ok": True,
                    "group_commit_unresolved": 0,
                    "delta_pulled": s.get("winner_was_laggard"),
                    **({"fenced_appends_rejected": 1,
                        "fenced_rest_writes_rejected": 1}
                       if "partition" in argv else {})}
            outcomes = s["group_commit_outcomes"]
            timed_ok = (sum(outcomes.values()) == 8
                        and outcomes.get("indeterminate", 0) >= 1)
        got = {k: s.get(k) for k in want}
        if rc != 0 or got != want or not timed_ok:
            raise AssertionError(f"phase CH3 {name}: exit {rc}, {got} "
                                 f"(want {want}), summary {s}")
        out[name] = {**s, "exit": rc, "wall_s": wall}
    return out


def phase_ch(device="cuda", world=None) -> dict:
    """The chaos simulator (``sim/chaos``): CH1 ``CH_WORLD`` (or
    ``world``) on ``device``, counted (path ``chaos``) with every launch
    replayed against its plain version, held to the reference's
    invariants, no cycle degraded, the summary less ``flight`` and every
    job's instance sequence equal to the CPU's; CH2 the CLI's chaos
    worlds on ``device`` and on the CPU, equal; CH3 the failover legs."""
    card = device == "cuda"
    t0 = time.perf_counter()
    size = world or {}
    got = ch1_run(device, record=card, **size)
    cpu = cpu_side("ch1") if world is None else ch1_run("cpu", **size)
    s, counts = got["summary"], got["counts"] or {}
    checks = {
        "ok": s["ok"], "all_completed": s["jobs_completed"] ==
        s["jobs_total"], "one_leader_kill": s["leader_kills"] == 1,
        "intents_open_at_kill": s["intents_open_at_kill"] > 0,
        "all_relaunched": s["relaunched_after_kill"] ==
        s["intents_open_at_kill"],
        "delta_faults": s["delta_faults"] > 0,
        "no_user_retries": s["user_retries_charged"] == 0,
        "not_degraded": got["degraded"]["fallback_counter"] == 0
        and got["degraded"]["flight_notes"] == 0,
        "fault_repacks": got["repacks_by_reason"].get("fault", 0) ==
        s["delta_faults"],
        "successor_cold": got["successor_first_repacks"] == {"cold": 1.0},
        "two_leaders": got["leaders"] == 2,
        "summary_equal_to_cpu": s == cpu["summary"],
        "sequences_equal_to_cpu": got["sequences"] == cpu["sequences"]}
    if card:
        checks["every_kernel_launched"] = all(
            counts.get(k, 0) > 0 for k in SOURCES)
        checks["every_launch_replayed"] = \
            got["rec"].unreplayed(counts) == {}
    failed = [k for k, v in checks.items() if not v]
    line = {
        "phase": "CH1", "device": device,
        "world": {**CH_WORLD, **size}, "wall_s": got["wall_s"],
        "cpu_wall_s": cpu["wall_s"], "ticks": got["ticks"],
        "step_cycle_ms": got["step_cycle_ms"],
        "detail_ms": got["detail_ms"], "paths": got["paths"],
        "makespan_virtual_s": s["makespan_virtual_s"],
        "repacks_by_reason": got["repacks_by_reason"],
        "successor_first_repacks": got["successor_first_repacks"],
        "degraded": got["degraded"], "flight": got["flight"],
        "summary": s, "jobs_with_instances": sum(
            1 for v in got["sequences"].values() if v),
        "instances": sum(len(v) for v in got["sequences"].values()),
        "checks": checks}
    if card:
        line.update({"launches_per_kernel": counts,
                     "replayed_equal_to_plain": got["rec"].replayed,
                     "replayed_by_wrapper": got["rec"].held})
    print(json.dumps(line))
    if failed:
        diff = {k: (s.get(k), cpu["summary"].get(k)) for k in s
                if s.get(k) != cpu["summary"].get(k)}
        raise AssertionError(f"phase CH1: {failed}; card/CPU summary "
                             f"differences {diff}")
    del got, cpu

    from cook_tpu_torch.ops import telemetry
    t1 = time.perf_counter()
    before = telemetry.snapshot()
    ch2 = ch2_run(device)
    ch2_counts = {k: v - before.get(k, 0)
                  for k, v in telemetry.snapshot().items()}
    ch2_cpu = cpu_side("ch2") if world is None else ch2_run("cpu")

    def held(r):
        # CH1's checks of a fused world: no cycle degraded, and every
        # resident repack of reason fault an injected delta fault
        return (r["exit"] == 0 and r["summary"]["ok"]
                and r["degraded"]["fallback_counter"] == 0
                and r["degraded"]["flight_notes"] == 0
                and r["fault_repacks"] ==
                r["summary"].get("delta_faults", 0))

    bad = [n for n in CH2_WORLDS
           if not held(ch2[n]) or not held(ch2_cpu[n])
           or ch2[n]["summary"] != ch2_cpu[n]["summary"]]
    print(json.dumps({
        "phase": "CH2", "device": device,
        "worlds": {n: {"argv": CH2_WORLDS[n], "exit": ch2[n]["exit"],
                       "cpu_exit": ch2_cpu[n]["exit"],
                       "equal_to_cpu": ch2[n]["summary"] ==
                       ch2_cpu[n]["summary"],
                       "wall_s": ch2[n]["wall_s"],
                       "cpu_wall_s": ch2_cpu[n]["wall_s"],
                       "degraded": ch2[n]["degraded"],
                       "fault_repacks": ch2[n]["fault_repacks"],
                       "cpu_fault_repacks": ch2_cpu[n]["fault_repacks"],
                       "summary": ch2[n]["summary"]} for n in CH2_WORLDS},
        "launches_per_kernel": ch2_counts,
        "wall_s": time.perf_counter() - t1}))
    if bad:
        raise AssertionError(f"phase CH2: {bad} failed, degraded, "
                             f"repacked unexplained or differ from the "
                             f"CPU")
    t1 = time.perf_counter()
    ch3 = phase_ch3()
    print(json.dumps({"phase": "CH3", "legs": ch3,
                      "wall_s": time.perf_counter() - t1,
                      "ch_wall_s": time.perf_counter() - t0}))
    return counts


# --------------------------------------- phase FO: the multi-cell federation
# FO1: the cell-outage drill at a cell size users run (3 cells of 1,000
# hosts of 8 cpus and 8 GiB; 2,250 jobs, 250 of them in gangs of 3)
FO_WORLD = {"seed": 0, "n_cells": 3, "hosts_per_cell": 1_000,
            "n_batches": 1_000, "n_users": 50, "gang_every": 4,
            "gang_size": 3}
FO_UUID_SEED = 22
# FO2: goodput routing over three cells whose inventories differ (id,
# hosts, cpus, MB), a cell's summary advertising at most 256 hosts
FO2_CELLS = (("cellA", 64, 8.0, 8_192.0), ("cellB", 32, 32.0, 16_384.0),
             ("cellC", 200, 4.0, 4_096.0))
FO2_BATCHES = 40
# FO3: the node role over two cell nodes
FO3_HOSTS, FO3_JOBS, FO3_USERS, FO3_WRITERS, FO3_BATCH = 200, 400, 20, 4, 20
FO3_TIMEOUT_S = 120.0


@contextmanager
def fo_uuids(seed=FO_UUID_SEED):
    """``uuid.uuid4()`` called from the client or the cell-outage drill
    (the job and gang uuids) answers from one seeded sequence, so the
    card's and the CPU's drills pair job by job; every other caller
    (task ids, trace ids) keeps the random one."""
    import random
    import uuid

    real, rng = uuid.uuid4, random.Random(seed)
    callers = {"cook_tpu_torch.client", "cook_tpu_torch.sim.federation"}

    def uuid4():
        if sys._getframe(1).f_globals.get("__name__") in callers:
            return uuid.UUID(int=rng.getrandbits(128), version=4)
        return real()

    uuid.uuid4 = uuid4
    try:
        yield
    finally:
        uuid.uuid4 = real


def route_histogram(before=None) -> dict:
    """``cook_federation_route_seconds`` since ``before`` (an earlier
    return): count, mean, and p50/p99 as the upper bounds of the buckets
    that hold them."""
    from cook_tpu_torch.utils.metrics import registry
    h = next((dict(v, buckets=list(v["buckets"]))
              for (name, _), v in list(registry._histograms.items())
              if name == "cook_federation_route_seconds"), None)
    if h is None:
        return {"count": 0, "sum": 0.0, "buckets": [], "bounds": []}
    if before and before["count"]:
        h["count"] -= before["count"]
        h["sum"] -= before["sum"]
        h["buckets"] = [a - b for a, b in zip(h["buckets"],
                                              before["buckets"])]
    out = {"count": h["count"], "sum": h["sum"], "buckets": h["buckets"],
           "bounds": list(h["bounds"])}
    for q in (0.5, 0.99):
        out[f"p{int(q * 100)}_le_s"] = next(
            (b for b, c in zip(h["bounds"], h["buckets"])
             if c >= q * h["count"]), None) if h["count"] else None
    out["mean_ms"] = h["sum"] / h["count"] * 1e3 if h["count"] else None
    return out


def pcts(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))} if len(xs) else None


def cell_placements(cells) -> dict:
    """Every cell's jobs: uuid, state, and each instance's host and
    status (task ids are random)."""
    out = {}
    for cell in cells:
        store = cell.store
        out[cell.cell_id] = sorted(
            [j.uuid, j.state.value, [[i.hostname, i.status.value]
                                     for t in j.instances
                                     if (i := store.instance(t))
                                     is not None]]
            for j in store.jobs_where(lambda j: True))
    return out


def fo1_run(device="cuda", record=False, **size) -> dict:
    """One ``run_cell_outage`` of ``FO_WORLD`` (``size`` overrides) on
    ``device`` under :func:`fo_uuids`: the summary, every ledgered job's
    owning cell, every cell's placements, each ``_step_all`` call's ms a
    cell, the route times (each ``FederationRouter.submit`` on the host
    clock, and the front door's ``cook_federation_route_seconds``); with
    ``record`` every launch is replayed against its plain version after
    the ``_step_all`` that made it."""
    from cook_tpu_torch.federation import rest as fed_rest
    from cook_tpu_torch.federation.router import FederationRouter
    from cook_tpu_torch.sim import federation as simfed
    rec = ReplayingRecorder("phase FO1") if record else None
    made, nodes, steps, routes = [], [], [], []
    make, build, step_all = (simfed._make_cell,
                             fed_rest.build_federation_node,
                             simfed._step_all)
    submit = FederationRouter.submit

    def make_cell(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    def build_node(*a, **kw):
        nodes.append(build(*a, **kw))
        return nodes[-1]

    def timed_step_all(cells):
        per = {}
        for cell in cells:
            t0 = time.perf_counter()
            step_all([cell])
            per[cell.cell_id] = (time.perf_counter() - t0) * 1e3
        steps.append(per)
        if rec is not None:
            rec.drain()

    def timed_submit(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return submit(self, *a, **kw)
        finally:
            routes.append((time.perf_counter() - t0) * 1e3)

    hist0 = route_histogram()
    seq0, fb0 = flight_seq(), fallbacks("fused.pool_cycle")
    simfed._make_cell, fed_rest.build_federation_node = make_cell, build_node
    simfed._step_all, FederationRouter.submit = timed_step_all, timed_submit
    if rec is not None:
        rec.start()
    t0 = time.perf_counter()
    try:
        with fo_uuids():
            res = simfed.run_cell_outage(
                simfed.CellOutageConfig(**{**FO_WORLD, **size}),
                device=device)
    finally:
        wall = time.perf_counter() - t0
        simfed._make_cell, fed_rest.build_federation_node = make, build
        simfed._step_all, FederationRouter.submit = step_all, submit
        counts = rec.stop() if rec is not None else None
    router = nodes[0].router
    return {"summary": res.summary(), "wall_s": wall,
            "owners": {u: router.cell_of_uuid(u)
                       for u in router._uuid_to_batch},
            "placed": cell_placements(made),
            "step_all_ms": steps, "route_ms": pcts(routes),
            "routes": len(routes), "route_histogram": route_histogram(hist0),
            "degraded": degraded_since(seq0, fb0), "counts": counts,
            "rec": rec}


def fo2_cell(directory: Path, cid: str, n_hosts: int, cpus: float,
             mem: float, device):
    """One cell of FO2: a journaled store, ``n_hosts`` hosts of ``cpus``
    and ``mem``, a ``Scheduler`` on ``device`` (K2/K3 rank, K5 match),
    the REST plane on a local port."""
    from cook_tpu_torch.cluster import FakeCluster, FakeHost
    from cook_tpu_torch.config import Config
    from cook_tpu_torch.rest import ApiServer, CookApi
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import Resources, Store
    store = Store.open(str(directory / cid))
    cluster = FakeCluster(f"{cid}-cluster", [
        FakeHost(f"{cid}-h{i}", Resources(cpus=cpus, mem=mem))
        for i in range(n_hosts)])
    cfg = Config()
    cfg.default_matcher.backend = "tpu-greedy"
    sched = Scheduler(store, cfg, [cluster], rank_backend="tpu",
                      device=device)
    server = ApiServer(CookApi(store, scheduler=sched, config=cfg))
    server.start()
    return server


def fo2_run(device="cuda", record=False, n_batches=FO2_BATCHES) -> dict:
    """A goodput-mode front door (``route_mode: "goodput"``, its replays
    on ``device``) over ``FO2_CELLS``; ``n_batches`` batches of 1-4 jobs of
    seeded shapes (fixed uuids) from 5 users: every batch's cell, each
    ``pick_cell`` ms (host clock); with ``record`` each batch's replay
    launches (K5) are replayed against their plain version after it,
    stacked by shape (:func:`replay_stacked`)."""
    import shutil
    import tempfile

    from cook_tpu_torch.client import JobClient
    from cook_tpu_torch.federation.rest import build_federation_node
    rec = ReplayingRecorder("phase FO2", stacked=True) if record else None
    tmp = Path(tempfile.mkdtemp(prefix="cook_fo2"))
    servers, fed, picks, pick_ms = [], None, [], []
    rng = np.random.default_rng(SEED + 22)
    try:
        for cid, n, cpus, mem in FO2_CELLS:
            servers.append((cid, fo2_cell(tmp, cid, n, cpus, mem, device)))
        fed = build_federation_node(
            {"cells": [{"id": cid, "url": s.url} for cid, s in servers],
             "route_mode": "goodput"}, device=device)
        fed.start()
        router = fed.router
        pick = router.pick_cell

        def timed_pick(*a, **kw):
            t0 = time.perf_counter()
            try:
                return pick(*a, **kw)
            finally:
                pick_ms.append((time.perf_counter() - t0) * 1e3)

        router.pick_cell = timed_pick
        clients = [JobClient(fed.url, user=f"gp{u}") for u in range(5)]
        if rec is not None:
            rec.start()
        t0 = time.perf_counter()
        for b in range(n_batches):
            specs = [{"uuid": f"00000000-0000-4000-8022-{b * 10 + j:012d}",
                      "command": "true",
                      "cpus": float(rng.choice([1, 2, 4, 6, 12])),
                      "mem": float(rng.choice([256, 1_024, 3_000, 6_000]))}
                     for j in range(int(rng.integers(1, 5)))]
            clients[b % 5].submit(specs)
            picks.append(router.cell_of_uuid(specs[0]["uuid"]))
            if rec is not None:
                rec.drain()
        wall = time.perf_counter() - t0
    finally:
        counts = rec.stop() if rec is not None else None
        if fed is not None:
            fed.stop()
        for _cid, s in servers:
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"picks": picks, "pick_ms": pcts(pick_ms),
            "picks_timed": len(pick_ms), "wall_s": wall, "counts": counts,
            "rec": rec}


def fo3_cells(directory: Path, device: str, hosts: int) -> dict:
    """Two cell nodes (``CookDaemon``), each with its own data and
    election dirs, ``hosts`` fake hosts of 64 cpus and 65,536 MB and
    phase N's scheduler section (fused, depth 2, 1 s match interval)."""
    from cook_tpu_torch.daemon import CookDaemon
    out = {}
    for cid in ("cellA", "cellB"):
        conf = node_conf(directory / cid, cid, device, hosts)
        conf["clusters"][0]["kwargs"]["name"] = f"{cid}-fake"
        out[cid] = CookDaemon(conf)
    return out


def fo3_section(cells: dict) -> dict:
    """``examples/cook-federation.json``'s ``"federation"`` section with
    the cells' local URLs, and without the dominant-share cap: in a
    400-job drill the first user's batches hold the whole running usage
    of the federation until the others' are placed."""
    conf = json.loads((ROOT / "examples" / "cook-federation.json")
                      .read_text())
    fed = conf["federation"]
    for entry in fed["cells"]:
        entry["url"] = cells[entry["id"]].node_url
    fed["max_user_dominant_share"] = 0.0
    return fed


def phase_fo3(device="cuda", hosts=FO3_HOSTS, n_jobs=FO3_JOBS,
              n_users=FO3_USERS, writers=FO3_WRITERS,
              batch=FO3_BATCH) -> dict:
    """The node role: two cell nodes on ``device`` (:func:`fo3_cells`)
    and a ``CookDaemon`` with a ``"federation"`` section over them
    (:func:`fo3_section`); ``writers`` ``JobClient`` writers submit
    ``n_jobs`` jobs through the front door; every job is placed in the
    cell the router recorded for it and is unknown to the other; each
    cell's ``step_cycle`` runs under one lock, its launches replayed
    against their plain versions after it (the two cells' loops take
    turns) and its cell checked: no host over capacity, no job live
    twice; no cycle degraded."""
    import shutil
    import tempfile
    import threading

    from cook_tpu_torch.daemon import CookDaemon
    from cook_tpu_torch.state import JobState
    card = device == "cuda"
    out = {"phase": "FO3"}
    tmp = Path(tempfile.mkdtemp(prefix="cook_fo3"))
    t0 = time.perf_counter()
    guard, faults, steps = threading.Lock(), [], []
    rec = ReplayingRecorder("phase FO3") if card else None
    cells = fo3_cells(tmp, device, hosts)
    front, counts = None, {}
    seq0, fb0 = flight_seq(), fallbacks("fused.pool_cycle")

    def no_fault():
        if faults:
            raise AssertionError(f"phase FO3: {len(faults)} step_cycle "
                                 f"calls failed") from faults[0]

    def checked(cid, node):
        step_cycle = node.scheduler.step_cycle

        def step(*a, **kw):
            try:
                with guard:
                    t1 = time.perf_counter()
                    before = fallbacks("fused.pool_cycle")
                    res = step_cycle(*a, **kw)
                    t2 = time.perf_counter()
                    if rec is not None and rec._ctx is not None:
                        rec.drain()
                    if fallbacks("fused.pool_cycle") != before:
                        raise AssertionError(f"phase FO3 {cid}: a step "
                                             f"degraded to the split path")
                    check_live(node, f"phase FO3 {cid} step {len(steps)}")
                    steps.append((cid, t1, sum(
                        len(r.launched_task_ids) for r in res.values()),
                        (t2 - t1) * 1e3))
            except BaseException as e:
                faults.append(e)
                raise
            return res

        node.scheduler.step_cycle = step
        guard_rebalancer(node.scheduler, guard)

    try:
        if rec is not None:
            with guard:
                rec.start()
        for cid, node in cells.items():
            node.start()

            def leader():
                if node.exit_code != 0:
                    raise AssertionError(f"phase FO3 {cid}: the takeover "
                                         f"failed")
                return node.scheduler

            wait_for(leader, 60.0, f"phase FO3 {cid}: leadership")
            if node.scheduler.device.type != torch.device(device).type:
                raise AssertionError(f"phase FO3 {cid}: the leader runs "
                                     f"on {node.scheduler.device}")
            checked(cid, node)
        out["cells_lead_s"] = time.perf_counter() - t0
        front = CookDaemon({"host": "127.0.0.1", "port": 0,
                            "federation": fo3_section(cells)},
                           device=device)
        front.start()
        if front.federation is None or front.store is not None \
                or front.elector is not None:
            raise AssertionError("phase FO3: the front door is not a "
                                 "stateless router")
        router = front.federation.router
        sub = n_submit(front.node_url, n_jobs, n_users, writers, batch,
                       SEED + 23)
        acked, last_ack = sub.pop("acked"), sub.pop("last_ack")
        out["submit"] = sub
        owners = {u: router.cell_of_uuid(u) for u in acked}
        if None in owners.values():
            raise AssertionError("phase FO3: acknowledged jobs without a "
                                 "cell in the router's ledger")

        def placed():
            no_fault()
            return all(
                (job := cells[owners[u]].store.job(u)) is not None
                and job.state is not JobState.WAITING for u in acked)

        wait_for(placed, FO3_TIMEOUT_S, "phase FO3: every job placed in "
                 "its cell", every=0.1)
        placed_s = time.perf_counter() - last_ack
        with guard:
            stray = [u for u in acked for cid, node in cells.items()
                     if cid != owners[u] and node.store.job(u) is not None]
            for cid, node in cells.items():
                check_live(node, f"phase FO3 {cid} at the end")
            panel = json.loads(urllib.request.urlopen(
                front.node_url + "/debug/federation").read())
        if stray:
            raise AssertionError(f"phase FO3: jobs known to a cell that "
                                 f"does not own them: {stray[:3]}")
        by_cell = {cid: sum(1 for c in owners.values() if c == cid)
                   for cid in cells}
        out["fo3"] = {
            "placed_after_last_ack_s": placed_s,
            "jobs_by_cell": by_cell,
            "step_cycles": len(steps),
            "dispatching_cycles": sum(1 for s in steps if s[2]),
            "launched": sum(s[2] for s in steps),
            "step_ms": pcts([s[3] for s in steps]),
            "panel_cells": [{k: c[k] for k in ("id", "tier", "breaker",
                                               "routed_total")}
                            for c in panel["cells"]],
            "rejections": panel["rejections"]}
    finally:
        if front is not None:
            front.shutdown()
        for node in cells.values():
            node.shutdown()
        if rec is not None:
            with guard:
                counts = rec.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    no_fault()
    degraded = degraded_since(seq0, fb0)
    out["degraded"] = degraded
    if degraded["fallback_counter"] or degraded["flight_notes"]:
        raise AssertionError(f"phase FO3: cycles degraded: {degraded}")
    if card:
        missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
        skipped = rec.unreplayed(counts)
        if missing or skipped:
            raise AssertionError(f"phase FO3: kernels not launched "
                                 f"{missing}, launches not replayed "
                                 f"(path, replays) {skipped}")
        out["launches_per_kernel"] = counts
        out["replayed_equal_to_plain"] = rec.replayed
    out["world"] = {"cells": 2, "hosts_per_cell": hosts, "cpus": 64.0,
                    "mem": 65_536.0, "jobs": n_jobs, "users": n_users,
                    "writers": writers, "batch": batch, "task_s": 3.0}
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return counts


def phase_fo(device="cuda", world=None, fo2=None, fo3=None) -> dict:
    """The multi-cell federation: FO1 ``run_cell_outage`` at
    ``FO_WORLD`` (or ``world``) on ``device``, counted (path
    ``federation``) with every launch replayed, held to the drill's
    invariants, no cycle degraded, the summary, every job's owning cell
    and every cell's placements equal to the CPU's; FO2 a goodput front
    door on ``device`` over three cells, its picks equal to the CPU's,
    its replays' launches replayed; FO3 the node role
    (:func:`phase_fo3`).  The launches of all three, summed."""
    card = device == "cuda"
    t0 = time.perf_counter()
    size = world or {}
    got = fo1_run(device, record=card, **size)
    cpu = cpu_side("fo1") if world is None else fo1_run("cpu", **size)
    s, counts = got["summary"], got["counts"] or {}
    checks = {
        "ok": s["ok"], "no_lost_jobs": s["lost_jobs"] == 0,
        "no_split_gangs": s["split_gangs"] == 0,
        "victim_breaker_open": s["breaker_states"][s["victim"]]
        in ("open", "half-open"),
        "survivors_closed": all(v == "closed" for c, v in
                                s["breaker_states"].items()
                                if c != s["victim"]),
        "running_after": s["running_after"] > 0,
        "rerouted": s["rerouted_batches"] > 0,
        "all_jobs_owned": len(got["owners"]) == s["jobs_acked"]
        and None not in got["owners"].values(),
        "not_degraded": got["degraded"]["fallback_counter"] == 0
        and got["degraded"]["flight_notes"] == 0,
        "summary_equal_to_cpu": s == cpu["summary"],
        "owners_equal_to_cpu": got["owners"] == cpu["owners"],
        "placements_equal_to_cpu": got["placed"] == cpu["placed"]}
    if card:
        checks["k2_k3_k5_launched"] = all(
            counts.get(k, 0) > 0 for k in ("scan", "sort", "greedy"))
        checks["every_launch_replayed"] = \
            got["rec"].unreplayed(counts) == {}
    failed = [k for k, v in checks.items() if not v]
    steps = got["step_all_ms"]
    line = {
        "phase": "FO1", "device": device, "world": {**FO_WORLD, **size},
        "wall_s": got["wall_s"], "cpu_wall_s": cpu["wall_s"],
        "step_all_calls": len(steps), "step_all_ms_by_cell": steps,
        "route_ms": got["route_ms"], "routes": got["routes"],
        "route_histogram": got["route_histogram"],
        "placed_by_cell": {c: sum(1 for j in v if j[2])
                           for c, v in got["placed"].items()},
        "degraded": got["degraded"], "summary": s, "checks": checks}
    if card:
        line.update({"launches_per_kernel": counts,
                     "replayed_equal_to_plain": got["rec"].replayed,
                     "replayed_by_wrapper": got["rec"].held})
    print(json.dumps(line))
    if failed:
        diff = {k: (s.get(k), cpu["summary"].get(k)) for k in s
                if s.get(k) != cpu["summary"].get(k)}
        raise AssertionError(f"phase FO1: {failed}; card/CPU summary "
                             f"differences {diff}")
    del got, cpu

    t1 = time.perf_counter()
    gp = fo2_run(device, record=card, **(fo2 or {}))
    gp_cpu = cpu_side("fo2") if fo2 is None else fo2_run("cpu", **fo2)
    gp_counts = gp["counts"] or {}
    bad = []
    if gp["picks"] != gp_cpu["picks"]:
        bad.append("picks differ from the CPU's")
    if card and (gp_counts.get("greedy", 0) <= 0
                 or gp["rec"].unreplayed(gp_counts)):
        bad.append("replays' K5 launches missing or not replayed")
    line = {"phase": "FO2", "device": device,
            "cells": [list(c) for c in FO2_CELLS],
            "batches": len(gp["picks"]), "picks": gp["picks"],
            "picks_by_cell": {c: gp["picks"].count(c)
                              for c in sorted(set(gp["picks"]))},
            "equal_to_cpu": gp["picks"] == gp_cpu["picks"],
            "pick_ms": gp["pick_ms"], "picks_timed": gp["picks_timed"],
            "wall_s": gp["wall_s"], "cpu_wall_s": gp_cpu["wall_s"],
            "fo2_wall_s": time.perf_counter() - t1}
    if card:
        line.update({"launches_per_kernel": gp_counts,
                     "replayed_equal_to_plain": gp["rec"].replayed})
    print(json.dumps(line))
    if bad:
        raise AssertionError(f"phase FO2: {bad}; card {gp['picks']}, "
                             f"cpu {gp_cpu['picks']}")
    node_counts = phase_fo3(device, **(fo3 or {}))
    print(json.dumps({"phase": "FO", "fo_wall_s": time.perf_counter()
                      - t0}))
    return {k: counts.get(k, 0) + gp_counts.get(k, 0)
            + node_counts.get(k, 0)
            for k in set(counts) | set(gp_counts) | set(node_counts)}


def compute_apps() -> list:
    """The pids ``nvidia-smi`` lists as compute processes on the card,
    one entry a process that holds a CUDA context."""
    got = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [int(x) for x in got.split() if x.strip().isdigit()]


def on_card(pid: int, others: int, what: str, seen=None) -> str:
    """Raise unless process ``pid`` is on ``nvidia-smi``'s list of
    compute apps.  Where the list names it, by its pid; in a container
    whose processes the list shows all as pid 1 (a PID namespace it
    cannot map), by the count: one entry more than the ``others`` known
    to hold a context.  After a process that held a context was killed,
    ``seen``, the counts polled since the kill, must show the handover:
    down to ``others`` (the killed context gone first) or up to
    ``others + 2`` (the new one made first)."""
    apps = compute_apps()
    if pid in apps:
        return "pid"
    if apps and set(apps) == {1} and len(apps) == others + 1 and (
            seen is None or others in seen or others + 2 in seen):
        return "count"
    raise AssertionError(f"phase O: {what} (pid {pid}) not among the "
                         f"compute apps {apps} ({others} others, counts "
                         f"seen since the kill {sorted(seen or ())})")


class AppCounts:
    """The counts of ``nvidia-smi``'s compute apps, polled in a thread
    until ``stop``."""

    def __init__(self):
        import threading
        self.seen, self._stop = set(), threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self) -> None:
        while not self._stop.is_set():
            self.seen.add(len(compute_apps()))
            self._stop.wait(0.02)

    def stop(self) -> set:
        self._stop.set()
        self._thread.join(timeout=10)
        return self.seen


class NodeProc:
    """One ``python -m cook_tpu_torch --config`` child, its output in a
    file; ``serving()`` waits for its banner and sets ``url``."""

    def __init__(self, conf: dict, directory: Path, name: str):
        import os
        self.log = directory / f"node-{name}.log"
        path = directory / f"node-{name}.json"
        path.write_text(json.dumps(conf))
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                              .parent),
                   PYTHONUNBUFFERED="1")
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "cook_tpu_torch", "--config",
                 str(path)], stdout=f, stderr=subprocess.STDOUT,
                cwd=str(Path(__file__).resolve().parent), env=env)
        self.name = name

    def serving(self) -> "NodeProc":
        self.url = wait_for(self._banner, 90.0, f"phase O: node "
                            f"{self.name} serving", every=0.1)
        return self

    def _banner(self):
        if self.proc.poll() is not None:
            raise AssertionError(f"node exited {self.proc.returncode}: "
                                 f"{self.log.read_text()[-2000:]}")
        for line in self.log.read_text().splitlines():
            if line.startswith("cook_tpu: serving "):
                return line.split()[2]
        return None

    def get(self, path: str):
        import urllib.request
        req = urllib.request.Request(self.url + path,
                                     headers={"X-Cook-User": "admin"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.load(r)

    def post(self, path: str, body: dict):
        import urllib.request
        req = urllib.request.Request(
            self.url + path, data=json.dumps(body).encode(), method="POST",
            headers={"X-Cook-User": "admin",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.load(r)

    def leads(self) -> bool:
        try:
            return bool(self.get("/info").get("leader"))
        except OSError:
            return False

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)


def cs(url: str, home: Path, *argv, stdin=None, timeout=O_TIMEOUT_S):
    """The port's ``cs`` as a user runs it; its stdout."""
    import os
    env = dict(os.environ, COOK_URL=url, COOK_USER="alice", HOME=str(home),
               PYTHONPATH=str(Path(__file__).resolve().parent))
    got = subprocess.run(
        [sys.executable, "-m", "cook_tpu_torch.cli.main", *argv],
        input=stdin, capture_output=True, text=True, timeout=timeout,
        env=env)
    if got.returncode != 0:
        raise AssertionError(f"cs {argv[0]}: exit {got.returncode}: "
                             f"{got.stderr[-2000:]}")
    return got.stdout


def states_of(node: NodeProc, uuids) -> dict:
    import urllib.parse
    out = {}
    for i in range(0, len(uuids), 100):
        q = urllib.parse.urlencode({"uuid": uuids[i:i + 100]}, doseq=True)
        for j in node.get(f"/jobs?{q}"):
            out[j["uuid"]] = j["status"]
    return out


def phase_o(device="cuda", hosts=O_HOSTS, first=O_FIRST, waiting=O_WAITING,
            sim=None) -> dict:
    """Two nodes as processes on the card with socket replication: the
    leader is on ``nvidia-smi``'s list; ``cs`` submits ``first`` jobs and
    waits for them, then ``waiting`` more; once the standby is synced
    the leader's cluster drained (``POST /compute-clusters``) and the
    leader killed with SIGKILL; the standby promotes, holds every
    acknowledged job and places every one that waited, and is on the
    list; ``sim.system``'s command line (in process: it is a client)
    generates, simulates and reports a schedule against it; SIGTERM
    stops it with exit code 0."""
    import contextlib
    import io
    import os
    import shutil
    import signal
    import tempfile

    from cook_tpu_torch.sim.system import main as system_main
    card = device == "cuda"
    out = {"phase": "O"}
    tmp = Path(tempfile.mkdtemp(prefix="cook_nodes"))
    repl = {"listen_port": 0, "sync": True}
    nodes, polled = [], None
    t0 = time.perf_counter()
    try:
        # the processes on the card before the nodes (this one, after the
        # earlier phases)
        others = len(compute_apps()) if card else 0
        # both boot at once; whichever takes the lock leads (a), the
        # other follows its journal (b)
        nodes += [NodeProc(node_conf(tmp, n, device, hosts,
                                     replication=repl), tmp, n)
                  for n in ("a", "b")]
        for n in nodes:
            n.serving()
        a = wait_for(lambda: next((n for n in nodes if n.leads()), None),
                     90.0, "phase O: a node leads", every=0.1)
        b = nodes[1] if a is nodes[0] else nodes[0]
        out["boot_s"] = time.perf_counter() - t0
        spec = {"command": "true", "cpus": 1.0, "mem": 64.0}
        t1 = time.perf_counter()
        first_uuids = cs(a.url, tmp, "submit", "--raw",
                         stdin=json.dumps([spec] * first)).split()
        done = json.loads(cs(a.url, tmp, "wait", *first_uuids,
                             "--timeout", str(O_TIMEOUT_S)))
        if len(first_uuids) != first or any(
                j["status"] != "completed" for j in done):
            raise AssertionError("phase O: cs wait did not see every job "
                                 "complete")
        out["o1"] = {"jobs": first, "submit_and_wait_s":
                     time.perf_counter() - t1}
        if card:
            # the standby holds no context: only the leader is added
            out["o1"]["leader_on_card_by"] = on_card(a.proc.pid, others,
                                                     "the leader")
        # the operator drains the leader's cluster (its state lives in the
        # leader's memory only), so the next jobs wait until a failover
        a.post("/compute-clusters/node-fake", {"state": "draining"})
        late = cs(a.url, tmp, "submit", "--raw",
                  stdin=json.dumps([spec] * waiting)).split()
        panel = wait_for(
            lambda: (lambda p: p if p.get("synced_followers", 0) >= 1
                     else None)(a.get("/debug/replication")),
            30.0, "phase O: standby synced")
        before = states_of(a, late)
        os.kill(a.proc.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        # the killed leader's context and the standby's new one may show
        # in either order
        polled = AppCounts() if card else None
        a.proc.wait(timeout=30)
        waited = [u for u in late if before[u] == "waiting"]
        if len(waited) != waiting:
            raise AssertionError(f"phase O: {waiting - len(waited)} jobs "
                                 "placed on a drained cluster")
        wait_for(b.leads, 60.0, "phase O: standby leads", every=0.05)
        led_s = time.perf_counter() - t_kill

        def first_placed():
            st = states_of(b, waited)
            return any(s != "waiting" for s in st.values())

        wait_for(first_placed, 60.0, "phase O: first placement", 0.05)
        placed_s = time.perf_counter() - t_kill
        wait_for(lambda: all(s != "waiting" for s in
                             states_of(b, waited).values()),
                 60.0, "phase O: every waiting job placed", 0.1)
        every_s = time.perf_counter() - t_kill
        held = states_of(b, first_uuids + late)
        if sorted(held) != sorted(first_uuids + late):
            raise AssertionError(f"phase O: {first + waiting - len(held)} "
                                 "acknowledged jobs lost in the failover")
        out["o2"] = {"acked": len(held), "waiting_at_kill": len(waited),
                     "synced_followers": panel["synced_followers"],
                     "standby_leads_s": led_s,
                     "kill_to_first_placement_s": placed_s,
                     "kill_to_every_placement_s": every_s,
                     "standby_epoch": b.get("/debug/replication")
                     .get("epoch")}
        if card:
            wait_for(lambda: len(compute_apps()) == others + 1, 30.0,
                     "phase O: the killed leader left the card", 0.1)
            seen = polled.stop()
            out["o2"]["new_leader_on_card_by"] = on_card(
                b.proc.pid, others, "the new leader", seen)
            out["o2"]["compute_apps_seen_after_kill"] = sorted(seen)
        sim = sim or O_SIM
        sched_path, res_path = tmp / "schedule.json", tmp / "results.json"
        t1 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            for argv in (["generate", "-f", str(sched_path), "--users",
                          str(sim["users"]), "--jobs-per-user",
                          str(sim["jobs_per_user"]), "--duration-s",
                          str(sim["duration_s"]), "--seed",
                          str(SEED % 1000)],
                         ["simulate", "-f", str(sched_path), "--url",
                          b.url, "--out", str(res_path),
                          "--settle-timeout-s", "120"]):
                rc = system_main(argv)
                if rc != 0:
                    raise AssertionError(f"phase O: sim.system "
                                         f"{argv[0]}: exit {rc}")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            system_main(["report", "-f", str(res_path)])
        report = json.loads(printed.getvalue())
        total = sim["users"] * sim["jobs_per_user"]
        if report["jobs_total"] != total or report["finished"] != total \
                or report["submit_errors"]:
            raise AssertionError(f"phase O: simulation: {report}")
        out["o3"] = {"jobs": total, "finished": report["finished"],
                     "failed": report["failed"],
                     "wait_p50_ms": report["overall"]["wait"]["p50_ms"],
                     "turnaround_p50_ms":
                         report["overall"]["turnaround"]["p50_ms"],
                     "wall_s": time.perf_counter() - t1}
        b.proc.send_signal(signal.SIGTERM)
        rc = b.proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"phase O: SIGTERM exit code {rc}")
        out["o4"] = {"sigterm_exit": rc}
    finally:
        if polled is not None:
            polled.stop()
        for n in nodes:
            n.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return out


# ---------------------------------------------- phase E: the split matcher
FULL_WORLDS = (
    # (name, J, H, seed, packing): bench_match, bench_match_large,
    # bench_placement_quality
    ("greedy_1k", 1_000, 50_000, 1, "throughput"),
    ("waterfill_10k", 10_000, 50_000, 3, "throughput"),
    # the auction with its waterfill tail at the bench's H; J below
    # bench_match_large's 10,000 for the run's time
    ("auction_2500", 2_500, 50_000, 11, "tight"),
)
BACKENDS = ("auto", "tpu-greedy", "tpu-auction", "tpu-waterfill",
            "tpu-megakernel", "cpu")


def check_placement(assign, job_res, cmask, avail) -> dict:
    """No host oversubscribed in any resource (exact float64 sums) and
    no masked host assigned."""
    placed = np.flatnonzero(assign >= 0)
    hosts = assign[placed]
    if not cmask[placed, hosts].all():
        raise AssertionError("a job was placed on a masked host")
    used = np.zeros(avail.shape, np.float64)
    np.add.at(used, hosts, job_res[placed].astype(np.float64))
    if (used > avail.astype(np.float64)).any():
        raise AssertionError("a host is oversubscribed")
    return {"placed": int(placed.size),
            "hosts_used": int(np.unique(hosts).size)}


def split_world(J=2_500, H=4_000, seed=21):
    """A reduced world where ``auto`` splits: 10% of rows below
    sparse_cmask_density, non-dyadic demands, demand past capacity."""
    job_res, cmask, avail, cap = make_match_workload(J, H, seed)
    rng = np.random.default_rng(seed + 1)
    job_res[:, 0] += np.float32(0.3)
    job_res[:, 1] *= np.float32(1.1)
    sparse = rng.random(J) < 0.1
    cmask[sparse] = rng.random((int(sparse.sum()), H)) < 0.05
    return job_res, cmask, avail, cap


def split_dispatches(n_jobs: int) -> list:
    """(backend, packing, key) for every backend and packing; ``key`` names
    the dispatch that runs: ``auto`` with tight packing is the auction's
    and ``tpu-megakernel`` the greedy's (the resolution is CPU-tested);
    ``auto``'s waterfill is its own, since it splits off the sparse
    rows."""
    from cook_tpu_torch.config import MatcherConfig
    from cook_tpu_torch.sched.matcher import resolve_backend
    out = []
    for backend in BACKENDS:
        for packing in ("throughput", "tight"):
            resolved = resolve_backend(MatcherConfig(
                backend=backend, auto_packing=packing), n_jobs)
            out.append((backend, packing, (
                backend if resolved == "tpu-waterfill" else resolved,
                packing)))
    return out


def split_on_cpu() -> dict:
    """Each distinct dispatch of the reduced split world on the CPU, by
    its key."""
    from cook_tpu_torch.config import MatcherConfig
    from cook_tpu_torch.sched.matcher import dispatch
    args, out = split_world(), {}
    for backend, packing, key in split_dispatches(len(args[0])):
        if key not in out:
            out[key] = dispatch(MatcherConfig(
                backend=backend, auto_packing=packing), *args, device="cpu")
    return out


def phase_e():
    """The split matcher on the card: the three full-width worlds
    (counted), the K5 route against the plain greedy, and the reduced
    split world for every backend, card against CPU."""
    from cook_tpu_torch.config import MatcherConfig
    from cook_tpu_torch.ops import cuda_lib, host_prep, telemetry
    from cook_tpu_torch.ops import match as tm
    from cook_tpu_torch.sched.matcher import dispatch, resolve_backend
    worlds = [(name, make_match_workload(J, H, seed), packing)
              for name, J, H, seed, packing in FULL_WORLDS]
    telemetry.reset_all()
    results = []
    with cuda_lib.recording() as calls:
        for name, args, packing in worlds:
            mc = MatcherConfig(auto_packing=packing)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            assign = dispatch(mc, *args)
            wall_ms = (time.perf_counter() - t0) * 1e3
            results.append((name, args, mc, assign, wall_ms))
    counts = telemetry.snapshot()
    for k in ("greedy", "scan"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{k} was not launched by the split path")
    # every launch of the three worlds again, against its plain version
    # on the same inputs, at the split path's own shapes
    faults, held, worst = [], {}, 0
    t0 = time.perf_counter()
    for i, (wrapper, wargs, kw, _) in enumerate(calls):
        replay(i, wrapper, wargs, kw, faults)
        shape = tuple(wargs[0].shape)
        key = f"{wrapper.__name__} {list(shape)}"
        held[key] = held.get(key, 0) + 1
        if wrapper.kernel == "scan":
            worst = max(worst, k2_launches(*captured_launches(
                lambda: wrapper.launch(*wargs, **kw))))
    if faults:
        raise AssertionError("split path: kernel != plain version:\n"
                             + "\n".join(faults))
    if worst > 2:
        raise AssertionError(f"split path: a K2 call made {worst} launches")
    print(json.dumps({"phase": "E", "replayed_equal_to_plain": held,
                      "max_k2_launches_per_call": worst,
                      "replay_and_count_s": time.perf_counter() - t0}))
    for name, args, mc, assign, wall_ms in results:
        print(json.dumps({
            "phase": "E", "world": name, "J": len(args[0]),
            "H": len(args[2]), "backend": resolve_backend(mc, len(args[0])),
            "auto_packing": mc.auto_packing, "wall_ms": wall_ms,
            **check_placement(assign, args[0], args[1], args[2])}))

    # the K5 route against the plain greedy on the card
    name, args, mc, assign, _ = results[0]
    arrays = host_prep.pack_match_inputs(*args)
    inp = tm.MatchInputs(*(torch.from_numpy(arrays[k]).cuda() for k in (
        "job_res", "constraint_mask", "avail", "capacity", "valid")))
    got = tm.greedy_match_kernel(inp)
    want = tm.greedy_assign(inp.job_res, inp.constraint_mask, inp.valid,
                            inp.avail, inp.capacity)
    for a, b in zip(got, want):
        max_err(a, b)
    if not np.array_equal(got[0].cpu().numpy()[:len(args[0])], assign):
        raise AssertionError("dispatch differs from the K5 route")

    # every backend on the reduced split world: card against CPU, each
    # distinct dispatch once (``split_dispatches``)
    args = split_world()
    cpu = cpu_side("e_split")
    same, done = {}, {}
    for backend, packing, key in split_dispatches(len(args[0])):
        mc = MatcherConfig(backend=backend, auto_packing=packing)
        if key in done:
            same[f"{backend}/{packing}"] = {**done[key],
                                            "same_dispatch_as": key[0]}
            continue
        t0 = time.perf_counter()
        on_card = dispatch(mc, *args, device="cuda")
        card_ms = (time.perf_counter() - t0) * 1e3
        on_cpu = cpu[key]
        if not np.array_equal(on_card, on_cpu):
            raise AssertionError(f"{backend}/{packing}: card != CPU in "
                                 f"{int((on_card != on_cpu).sum())} jobs")
        check_placement(on_card, *args[:3])
        same[f"{backend}/{packing}"] = done[key] = {
            "placed": int((on_card >= 0).sum()), "card_ms": card_ms}
    print(json.dumps({"phase": "E", "world": "split_2500x4000",
                      "identical_card_cpu": same}))
    return counts


# ------------------------------------- phase F: K2, K3 and K5 edge worlds
SCAN_EDGE_N = (1, 2, 15, 16, 17, 4_095, 4_096, 4_097, 65_537, 131_072,
               262_144, 1_048_576)
SCAN_STARTS = ("tile", "after_tile", "every", "first", "random")


def edge_floats(g, shape, specials=False):
    """Non-dyadic floats of both signs; with ``specials`` also +inf,
    -inf and NaN (one in 10,000 each)."""
    dev = "cuda"
    x = torch.rand(shape, generator=g, device=dev) * 7.3 + 0.01
    x = torch.where(torch.rand(shape, generator=g, device=dev) < 0.1, -x, x)
    if specials:
        r = torch.rand(shape, generator=g, device=dev)
        x = torch.where(r < 1e-4, float("inf"), x)
        x = torch.where((r >= 1e-4) & (r < 2e-4), float("-inf"), x)
        x = torch.where((r >= 2e-4) & (r < 3e-4), float("nan"), x)
    return x.contiguous()


def edge_starts(g, S, n, kind):
    """u8 segment starts: at each tile's first row, at its second, on
    every row, on row 0 only, or at random (1%, row 0 not forced); set
    rows hold 1, 2 or 255 (the kernel tests != 0)."""
    from cook_tpu_torch.ops import scan as tscan
    t = torch.arange(n, device="cuda").expand(S, n)
    tile = 1 << tscan.TILE_LOG
    on = {"tile": t % tile == 0, "after_tile": t % tile == 1,
          "every": torch.ones_like(t, dtype=torch.bool), "first": t == 0,
          "random": torch.rand((S, n), generator=g, device="cuda") < 0.01
          }[kind]
    val = torch.tensor([1, 2, 255], dtype=torch.uint8, device="cuda")[
        torch.randint(0, 3, (S, n), generator=g, device="cuda")]
    return torch.where(on, val, torch.zeros_like(val)).contiguous()


def scan_edge_calls(g, S, n):
    """(wrapper, args, kwargs) of every K2 kind at one (S, n)."""
    from cook_tpu_torch.ops import scan as tscan
    calls = []
    for kind in SCAN_STARTS:
        calls.append((tscan.seg_scan, (edge_floats(g, (S, n, 4),
                                                   kind == "random"),
                                       edge_starts(g, S, n, kind)), {}))
    rnd = edge_starts(g, S, n, "random")
    mflags = torch.randint(0, 32, (S, n), generator=g, device="cuda",
                           dtype=torch.uint8)
    for C in (1, 3):
        calls.append((tscan.seg_scan, (edge_floats(g, (S, n, C), True),
                                       rnd), {}))
    calls.append((tscan.seg_scan, (edge_floats(g, (S, n, 3), True), rnd,
                                   mflags, 2, 1), {}))
    for kind in ("tile", "random"):
        calls.append((tscan.seg_count, (mflags, 4,
                                        edge_starts(g, S, n, kind)), {}))
    for C in (1, 3, 4):
        calls.append((tscan.prefix16, (edge_floats(g, (S, n, C), C == 3),),
                      {}))
    ints = torch.randint(-1000, 1000, (S, n), generator=g, device="cuda",
                         dtype=torch.int32)
    calls += [
        (tscan.int_scan, (mflags,), dict(bit=8, offset=-1)),
        (tscan.int_scan, (mflags,), dict(bit=1, reverse=True)),
        (tscan.int_scan, (ints,), dict(op="min", reverse=True)),
        (tscan.int_scan, (ints,), dict(op="min", offset=3)),
        (tscan.int_scan, (ints,), dict(offset=5))]
    return calls


def fused_edge_calls(g, S, n):
    """(wrapper, args, kwargs) of every fused K2/K4 launch on a random
    world at (S, n): permutations for order and perm, random flags,
    quotas that some prefixes pass and some do not."""
    from cook_tpu_torch.ops import admit as tad
    dev = "cuda"

    def u(shape, lo, hi):
        return (torch.rand(shape, generator=g, device=dev) * (hi - lo)
                + lo).contiguous()

    def bits(p, shape=(S, n)):
        return (torch.rand(shape, generator=g, device=dev) < p).to(
            torch.uint8)

    def perm():
        return torch.argsort(torch.rand((S, n), generator=g, device=dev),
                             dim=1).to(torch.int32)

    def ints(lo, hi, shape=(S, n)):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    usage = u((S, n, 4), 0.1, 4.0)
    start = edge_starts(g, S, n, "random")
    start[:, 0] = 1
    flags = torch.randint(0, 32, (S, n), generator=g, device=dev,
                          dtype=torch.uint8)
    tokens = u((S, n), 0.0, 60.0)
    tokens[bits(0.1) != 0] = float("inf")
    return [
        (tad.rank_over, (usage, start, flags, u((S, n, 4), 0.0, 400.0)), {}),
        (tad.rank_keep, (bits(0.3), start, usage, flags, 3), {}),
        (tad.rank_dru, (usage, start, u((S, n, 3), 0.5, 50.0),
                        bits(0.9), flags, n % 2 == 1), {}),
        (tad.queue, (perm(), usage, u((S, n, 4), 0.0, 400.0),
                     ints(-1, n), u((S, n, 4), 0.0, 50.0), ints(0, n),
                     tokens, flags, bits(0.8), u((S, 4), 0.0, 10.0),
                     u((S, 4), 0.0, 1.0 * n), u((S, 4), 0.0, 10.0),
                     u((S, 4), 0.0, 1.2 * n)), {}),
        (tad.user_quota, (perm(), usage, bits(0.7), ints(0, max(n // 50, 1)),
                          u((S, n, 4), 0.0, 100.0),
                          u((S, n, 4), 0.0, 400.0)), {}),
        (tad.accept, (bits(0.7), edge_starts(g, S, n, "random"), perm(),
                      tokens, bits(0.7), ints(0, 8).to(torch.uint8)), {}),
        (tad.match_valid, (bits(0.5), ints(0, n + 1, (S,))), {}),
        (tad.compact, (perm(), bits(0.5), bits(0.6), u((S, n, 4), 0.0, 8.0),
                       ints(-1, 64), min(1024, n)), {})]


def scan_edge_check():
    """Every K2 kind and every fused K2/K4 launch against its plain
    version, bit for bit, at S in {1, 4} and every n of SCAN_EDGE_N (at
    S = 4, n = 1,048,576 makes 1,024 tiles, more CTAs than can be
    resident: the ticket orders them)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    faults, held, worst, i = [], {}, 0, 0
    t0 = time.perf_counter()
    for S in (1, 4):
        for n in SCAN_EDGE_N:
            for wrapper, args, kw in scan_edge_calls(g, S, n) \
                    + fused_edge_calls(g, S, n):
                replay(i, wrapper, args, kw, faults)
                i += 1
                held[wrapper.__name__] = held.get(wrapper.__name__, 0) + 1
                worst = max(worst, k2_launches(*captured_launches(
                    lambda: wrapper.launch(*args, **kw))))
            if faults:
                raise AssertionError(f"K2 at S={S}, n={n}: kernel != plain "
                                     "version:\n" + "\n".join(faults))
    if worst > 2:
        raise AssertionError(f"K2: {worst} CUDA launches in a call")
    print(json.dumps({"phase": "F", "kernel": "scan", "S": [1, 4],
                      "n": list(SCAN_EDGE_N), "calls": held,
                      "equal_to_plain": True,
                      "max_k2_launches_per_call": worst,
                      "replay_and_count_s": time.perf_counter() - t0}))


# ------------------------------------------ phase F: K3 and K5 edge worlds
SORT_EDGE_N = (1, 1_000, 4_097, 131_072, 262_144)
SORT_EDGE_KINDS = ("rank-mixed", "rank-equal", "user-mixed", "user-equal")


def sort_edge_args(S, n, kind, rng) -> tuple:
    """Inputs of one K3 edge call: ``rank-mixed`` has tied, NaN (both
    signs), -0, +0, +inf and -inf DRUs, 20% non-rankable rows and
    ``user_rank`` from -1 to n - 1; ``rank-equal`` one key everywhere;
    ``user-mixed`` users from -1 to n - 1; ``user-equal`` all -1."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()
    if kind.startswith("user"):
        user = rng.integers(-1, n, (S, n)) if kind == "user-mixed" \
            else np.full((S, n), -1)
        user[:, :1] = -1
        user[:, -1:] = n - 1 if kind == "user-mixed" else -1
        return (dev(user.astype(np.int32)),)
    if kind == "rank-equal":
        return (dev(np.full((S, n), 0.75, np.float32)),
                dev(np.ones((S, n), np.uint8)),
                dev(np.full((S, n), n - 1, np.int32)))
    dru = (rng.integers(0, 7, (S, n)) * 0.25).astype(np.float32)
    pick = rng.random((S, n))
    dru[pick < 0.04] = np.nan
    dru[(pick >= 0.04) & (pick < 0.06)] = \
        np.uint32(0xFFC00000).view(np.float32)
    dru[(pick >= 0.06) & (pick < 0.10)] = -0.0
    dru[(pick >= 0.10) & (pick < 0.14)] = np.inf
    dru[(pick >= 0.14) & (pick < 0.16)] = -np.inf
    wide = (pick >= 0.16) & (pick < 0.30)
    dru[wide] = rng.standard_normal(int(wide.sum())).astype(np.float32)
    user_rank = rng.integers(-1, n, (S, n)).astype(np.int32)
    user_rank[:, :1] = -1
    user_rank[:, -1:] = n - 1
    return (dev(dru), dev((rng.random((S, n)) < 0.8).astype(np.uint8)),
            dev(user_rank))


def greedy_edge_world(P, C, H, E, seed, *, tie_from=None, infeasible=False):
    """K5 inputs in the cycle's layout.  ``tie_from``: every host the
    same, hosts below it blocked, no exception rows, so the first
    feasible host (the winner of every fitness tie) lies in a later CTA;
    ``infeasible``: no slot fits any host."""
    rng = np.random.default_rng(seed)
    res = np.stack([rng.uniform(0.1, 4.0, (P, C)).round(1),
                    rng.integers(128, 8192, (P, C)),
                    (rng.random((P, C)) < 0.1) * rng.integers(1, 3, (P, C)),
                    rng.integers(0, 2048, (P, C))], -1).astype(np.float32)
    if infeasible:
        res[..., 1] = 1e9
    cap = np.stack([rng.choice([32, 48, 64, 96], (P, H)),
                    rng.choice([131072, 262144, 393216], (P, H)),
                    (rng.random((P, H)) < 0.1) * 8.0,
                    np.full((P, H), 1048576.0)], -1).astype(np.float32)
    frac = rng.uniform(0.05, 0.6, (P, H, 4)).astype(np.float32)
    avail = np.floor(cap * frac).astype(np.float32)
    blocked = rng.random((P, H)) < 0.05
    valid = rng.random((P, C)) < 0.95
    eid = np.where(rng.random((P, C)) < 0.2, rng.integers(0, max(E, 1),
                                                          (P, C)), -1)
    if E == 0:
        eid[:] = -1
    if tie_from is not None:
        cap[:] = np.float32([64, 262144, 0, 1048576])
        avail[:] = np.float32([32, 131072, 0, 524288])
        res[..., 2] = 0.0
        valid[:, 0] = True
        blocked[:] = False
        blocked[:, :tie_from] = True
    host_gpu = cap[..., 2] > 0
    exc = rng.random((P, E, H)) < 0.6

    def dev(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).cuda()
    u8 = np.uint8
    return (dev(res), dev(valid, u8), dev(res[..., 2] > 0, u8),
            dev(eid, np.int32), dev(host_gpu, u8), dev(blocked, u8),
            dev(exc, u8), dev(avail), dev(cap))


GREEDY_EDGES = (
    # (name, P, C, H, E, options)
    ("cross_cta_tie", 2, 1_024, 8_192, 0, dict(tie_from=2_048)),
    ("h4000", 4, 1_024, 4_000, 16, {}),
    ("all_infeasible", 4, 256, 8_192, 16, dict(infeasible=True)),
    ("h65536", 1, 1_024, 65_536, 64, {}),
    ("cluster16", 1, 256, 100_000, 8, {}),
    ("device_memory", 1, 64, 300_000, 8, {}),
)


def phase_f():
    """K2, K3 and K5 against their plain versions on edge worlds: K2's
    kinds and fused launches (scan_edge_check); K3 at S in {1, 4} and
    every n of SORT_EDGE_N for the four kinds (skipped and run passes
    both occur); K5 across CTAs, clusters and variants."""
    from cook_tpu_torch.ops import match as tm
    from cook_tpu_torch.ops import sort as tsort
    expand_edge_check()
    scan_edge_check()
    rng = np.random.default_rng(SEED + 40)
    sorts, runs, skips = 0, 0, 0
    for S in (1, 4):
        for n in SORT_EDGE_N:
            for kind in SORT_EDGE_KINDS:
                args = sort_edge_args(S, n, kind, rng)
                wrapper = tsort.sort_user if kind.startswith("user") \
                    else tsort.sort_rank
                max_err(wrapper(*args), wrapper.plain(*args))
                ran = passes_run(wrapper, args)
                bits = tsort.rank_bits(n) if wrapper is tsort.sort_rank \
                    else n.bit_length()
                passes = tsort.sort_plan(S, n, bits).passes
                sorts += 1
                runs += sum(ran)
                skips += S * passes - sum(ran)
    if not (runs and skips):
        raise AssertionError("phase F ran no pass or skipped none")
    print(json.dumps({"phase": "F", "kernel": "sort", "calls": sorts,
                      "equal_to_plain": True, "passes_run": runs,
                      "passes_skipped": skips}))
    for name, P, C, H, E, opts in GREEDY_EDGES:
        args = greedy_edge_world(P, C, H, E, SEED + 50, **opts)
        got = tm.greedy(*args)
        want = tm.greedy.plain(*args)
        max_err(got, want)
        valid = args[1] != 0
        if "tie_from" in opts and not bool(
                (got[:, 0] == opts["tie_from"]).all()):
            raise AssertionError("cross-CTA tie did not go to the lowest "
                                 "feasible host")
        if opts.get("infeasible") and bool((got >= 0).any()):
            raise AssertionError("an infeasible slot was placed")
        ms = cuda_ms(lambda: tm.greedy(*args), 3)
        plan = tm.greedy_plan(P, C, H)
        print(json.dumps({
            "phase": "F", "kernel": "greedy", "world": name, "P": P, "C": C,
            "H": H, "E": E, "cluster": plan.cluster, "threads": plan.threads,
            "hosts_per_cta": plan.hosts_per_cta, "in_smem": plan.in_smem,
            "equal_to_plain": True, "placed": int((got >= 0).sum()),
            "valid_slots": int(valid.sum()), "ms": ms,
            "us_per_step": ms * 1e3 / C}))
    greedy_gang_edge_check()
    div_fast_check()


def div_operands(rng) -> tuple:
    """f32 pairs (a, b) for K5's fast-path division: every pair of signed
    magnitudes at both edges of its range [2^-40, 2^40) and just past
    them (and at 0, the smallest normal and subnormal, 1e-9 and 2^21),
    then random pairs with random mantissas, half with exponents inside
    the range and half from 2^-70 to 2^70."""
    f = np.float32
    lo, hi = f(2.0 ** -40), f(2.0 ** 40)
    edges = [lo, np.nextafter(lo, f(1)), lo * f(1.5), f(2.0 ** -39),
             np.nextafter(hi, f(0)), f(2.0 ** 39), f(2.0 ** 39) * f(1.75),
             f(1), np.nextafter(f(2), f(0)), f(1e-9), f(2.0 ** 21),
             np.nextafter(lo, f(0)), hi, f(2.0 ** -41), f(2.0 ** 41),
             f(2.0 ** -63), f(2.0 ** 63) * f(1.5), f(2.0 ** -126),
             f(1e-45), f(0)]
    vals = np.array(edges + [-v for v in edges], np.float32)
    a = np.repeat(vals, vals.size)
    b = np.tile(vals, vals.size)
    n = 1 << 21

    def rand(lo_e, hi_e):
        bits = (rng.integers(lo_e, hi_e, n).astype(np.uint32) << 23) \
            | rng.integers(0, 1 << 23, n).astype(np.uint32) \
            | (rng.integers(0, 2, n).astype(np.uint32) << 31)
        return bits.view(np.float32)
    a = np.concatenate([a, rand(87, 167), rand(57, 197)])
    b = np.concatenate([b, rand(87, 167), rand(57, 197)])
    return a, b


def div_fast_check():
    """K5's fast-path division (``div_fast`` in csrc/greedy.cu) against
    IEEE ``/`` on the card: wherever its range check passes the two are
    equal bit for bit, and the check passes exactly where both operands
    have magnitudes in [2^-40, 2^40); the top-K kernels' split form
    (``recip_fast`` stored, then ``div_by_recip``) equals ``div_fast``
    on every pair."""
    from cook_tpu_torch.ops import cuda_lib
    a, b = div_operands(np.random.default_rng(SEED + 60))
    da, db = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    fast, ieee = torch.empty_like(da), torch.empty_like(da)
    recip, pre = torch.empty_like(da), torch.empty_like(da)
    safe = torch.empty(a.size, dtype=torch.int32, device="cuda")
    rc = cuda_lib.lib().k5_div_check(
        da.data_ptr(), db.data_ptr(), fast.data_ptr(), ieee.data_ptr(),
        safe.data_ptr(), recip.data_ptr(), pre.data_ptr(), a.size,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"k5_div_check: CUDA error {rc}")
    torch.cuda.synchronize()
    fast = fast.cpu().numpy().view(np.uint32)
    ieee = ieee.cpu().numpy().view(np.uint32)
    pre = pre.cpu().numpy().view(np.uint32)
    safe = safe.cpu().numpy() != 0

    def inside(x):
        e = (x.view(np.uint32) >> 23) & 0xFF
        return (e >= 87) & (e < 167)
    if not np.array_equal(safe, inside(a) & inside(b)):
        raise AssertionError("div_safe disagrees with its range")
    bad = int((safe & (fast != ieee)).sum())
    if bad:
        raise AssertionError(f"div_fast differs from / on {bad} pairs in "
                             f"its range")
    # the top-K kernels' split form: the reciprocal stored, then the
    # quotient from it, equal to div_fast everywhere
    bad = int((pre != fast).sum())
    if bad:
        raise AssertionError(f"div_by_recip from a stored reciprocal "
                             f"differs from div_fast on {bad} pairs")
    print(json.dumps({"phase": "F", "kernel": "greedy", "check": "div_fast",
                      "pairs": int(a.size), "in_range": int(safe.sum()),
                      "equal_in_range": True, "split_form_equal": True,
                      "differ_out_of_range": int((~safe
                                                  & (fast != ieee)).sum())}))



# ------------------------------------------- phase F: K1 and K5+K6 edge worlds
EXPAND_EDGE_S = (1, 4, 33)
EXPAND_EDGE_T = (1, 31, 32, 33, 1_023, 1_024, 1_025, 2_047, 2_048, 2_049,
                 4_095, 4_096, 4_097, 33_000, 100_000, 131_072, 1_048_576)
# (S, T) beyond EXPAND_EDGE_S x EXPAND_EDGE_T: ragged pool counts past 64
# (centred windows of the group base) at ragged T (33,000: the grid
# shifted by 396 rows, three levels padded; 100,000: the finisher pads)
EXPAND_EDGE_MORE = ((100, 33), (100, 1_025), (100, 4_000), (100, 4_097),
                    (100, 33_000), (100, 100_000), (1_000, 1),
                    (1_000, 33), (1_000, 1_025), (1_000, 4_097))
EXPAND_EDGE_E = (0, 1, 64, 256)
EXPAND_EDGE_H = (1, 7, 8, 8_192, 65_536)


def expand_edge_args(S, T, codec, E, H, u16, seed) -> tuple:
    """K1's inputs on a seeded world: rows in the codec (deltas within
    its range for i8 and i16), random flags whose USER_FIRST bits make
    segments (and ``user_rank`` -1 before the first and past U - 1),
    +-inf in ``res_base`` (so 0 x inf = NaN reaches the bases),
    exception rows with duplicates, -1, >= T and rows on tile
    boundaries, u16 or f32 ``avail`` and ``capacity``, group ids with -1
    and shared groups."""
    from cook_tpu_torch.ops import expand as tex
    from cook_tpu_torch.ops import quant
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)
    N = T + 300
    t = torch.arange(T, device=dev)
    if codec == quant.ROWS_WIDE:
        rows = ints(0, N, (S, T))
    else:
        lim = 100 if codec == quant.ROWS_I8 else 30_000
        delta = ints(-lim, lim, (S, T))
        delta = torch.clamp(delta + t, 0, N - 1) - t
        rows = delta.to(torch.int8 if codec == quant.ROWS_I8
                        else torch.int16)
    flags = ints(0, 32, (S, T)).to(torch.uint8)
    flags &= ~torch.where(rand((S, T), 0, 1) < 0.9, 16, 0).to(torch.uint8)
    user_rank = (torch.cumsum(((flags & 16) != 0).to(torch.int32), 1,
                              dtype=torch.int32) - 1).contiguous()
    U = 7
    res_base = (rand((N, 4), -3.0, 9.0) * 1.37).contiguous()
    pick = rand((N, 4), 0, 1)
    res_base[pick < 0.01] = float("inf")
    res_base[(pick >= 0.01) & (pick < 0.02)] = float("-inf")
    disk = rand(N, 0, 2048.3)
    group_id = torch.tensor([(q % 3) - 1 for q in range(S)], dtype=torch.int32,
                            device=dev)
    B = -(-H // 8)
    host_bits = ints(0, 256, (S, 2, B)).to(torch.uint8)
    exc = ints(-2, T + 3, (S, E))
    if E:
        special = torch.tensor([0, T - 1, tex.TILE - 1, tex.TILE, -1, T,
                                T + 5, tex.TILE + 1], dtype=torch.int32,
                               device=dev)
        k = min(E, special.numel())
        exc[:, :k] = special[:k]
        if E > 9:
            exc[:, 9] = exc[:, 0]          # duplicates: the later e wins
            exc[:, E - 1] = exc[:, 1]
    if u16:
        a_scale, c_scale = (0.5, 1024.0, 1.0, 0.25), (1.0, 2048.0, 0.5, 1.0)
        avail = ints(-32768, 32768, (S, H, 4), torch.int16).view(
            torch.uint16)
        cap = ints(-32768, 32768, (S, H, 4), torch.int16).view(torch.uint16)
    else:
        a_scale = c_scale = 0.0
        avail = rand((S, H, 4), 0, 99.7)
        cap = rand((S, H, 4), 0, 199.3)
    args = (rows.contiguous(), flags.contiguous(), res_base, disk,
            rand((S, U), 0, 50).contiguous(), rand((S, U, 3), 0.5, 20),
            rand((S, U, 4), 0, 400), user_rank, group_id,
            host_bits.contiguous(), exc.contiguous(), avail.contiguous(),
            cap.contiguous())
    kw = dict(rows_codec=codec, avail_scale=a_scale, cap_scale=c_scale,
              n_hosts=H)
    return args, kw


def expand_edge_check():
    """K1 against its plain version, bit for bit (NaN where NaN), on
    every (S, T) of EXPAND_EDGE_S x EXPAND_EDGE_T and EXPAND_EDGE_MORE,
    the codecs, E, H and the u16 / f32 host decode taken in turn; each
    call's CUDA launches counted from a captured graph (2: the memset
    and the kernel)."""
    from cook_tpu_torch.ops import expand as tex
    faults, worst, i, seen = [], 0, 0, set()
    t0 = time.perf_counter()
    worlds = [(S, T) for S in EXPAND_EDGE_S for T in EXPAND_EDGE_T] \
        + list(EXPAND_EDGE_MORE)
    for S, T in worlds:
        codec, E = i % 3, EXPAND_EDGE_E[i % 4]
        H, u16 = EXPAND_EDGE_H[i % 5], i % 2 == 1
        args, kw = expand_edge_args(S, T, codec, E, H, u16, SEED + 70 + i)
        replay(i, tex.expand, args, kw, faults)
        types, _ = captured_launches(
            lambda: tex.expand.launch(*args, **kw))
        if len(types) != 2:
            faults.append(f"K1 at S={S}, T={T}: launched {types}")
        worst = max(worst, len(types))
        seen.add((codec, E, H, u16))
        i += 1
        del args
    if faults:
        raise AssertionError("K1: kernel != plain version:\n"
                             + "\n".join(faults))
    print(json.dumps({"phase": "F", "kernel": "expand", "S": EXPAND_EDGE_S,
                      "T": EXPAND_EDGE_T, "more": EXPAND_EDGE_MORE,
                      "worlds": i,
                      "codec_E_H_u16_seen": len(seen),
                      "equal_to_plain": True, "launches_per_call": worst,
                      "replay_and_count_s": time.perf_counter() - t0}))


def gang_edge_wire(args, G, seed) -> tuple:
    """Gang wires for a K5 edge world (``greedy_edge_world``), built
    from the plain greedy's assignment so that each case occurs: gang 0
    complete (4 placed members, gang_min 4), gang 1 one short (4 placed,
    gang_min 5), gang 2 split across topology domains, gang 3 with a
    member on a host whose topology is -1, gang 4 with unplaced members;
    the other gangs random; 10% of the slots with ``cand_row`` -1."""
    from cook_tpu_torch.ops import match as tm
    rng = np.random.default_rng(seed)
    P, C, _ = args[0].shape
    H = args[7].shape[1]
    T = 2 * C
    assign = tm.greedy.plain(*args).cpu().numpy()
    cand_row = np.stack([rng.permutation(T)[:C] for _ in range(P)]) \
        .astype(np.int32)
    cand_row[rng.random((P, C)) < 0.1] = -1
    topo = np.full((P, 2, H), -1, np.int32)
    topo[:, 0] = 0
    topo[:, 1] = rng.integers(0, 4, (P, H))
    topo[:, 1, rng.random(H) < 0.05] = -1
    gang_id = np.full((P, T), -1, np.int32)
    size = np.full((P, G), 2, np.int32)
    attr = (rng.random((P, G)) < 0.5).astype(np.int32)
    for p in range(P):
        placed = [c for c in rng.permutation(C)
                  if cand_row[p, c] >= 0 and assign[p, c] >= 0]
        free = [c for c in rng.permutation(C)
                if cand_row[p, c] >= 0 and assign[p, c] < 0]
        cases = []
        if len(placed) >= 16 and G >= 5:
            by = {}
            for c in placed:
                by.setdefault(int(topo[p, 1, assign[p, c]]), []).append(c)
            known = [v for k, v in by.items() if k >= 0]
            same = max(known, key=len) if known else []
            cases = [(0, placed[:4], 4, 0), (1, placed[4:8], 5, 0)]
            split = [v[0] for v in known[:2]] if len(known) >= 2 else []
            cases.append((2, split + placed[8:10], 2, 1))
            if -1 in by and same:
                cases.append((3, same[:2] + by[-1][:1], 3, 1))
            cases.append((4, placed[10:12] + free[:2], 4, 0))
            used = {c for _, m, _, _ in cases for c in m}
        else:
            used = set()
        for g, members, gmin, a in cases:
            for c in members:
                gang_id[p, cand_row[p, c]] = g
            size[p, g], attr[p, g] = gmin, a
        rest = [c for c in range(C) if cand_row[p, c] >= 0 and c not in used]
        for c in rest:
            if rng.random() < 0.5:
                gang_id[p, cand_row[p, c]] = rng.integers(min(5, G - 1), G)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (dev(cand_row), dev(gang_id), dev(size), dev(attr), dev(topo))


def greedy_gang_edge_check():
    """The fused K5+K6 launch against K5's plain version then K6's, bit
    for bit, on K5's edge worlds (GREEDY_EDGES) with gang wires (G = 8
    and 1,024: K6's counts in shared memory and in scratch), one CUDA
    launch a call; beside each, K5 alone (the split path's instance) on
    the same inputs."""
    from cook_tpu_torch.ops import match as tm
    for i, (name, P, C, H, E, opts) in enumerate(GREEDY_EDGES):
        G = 1024 if i % 2 else 8
        args = greedy_edge_world(P, C, H, E, SEED + 50, **opts)
        full = args + gang_edge_wire(args, G, SEED + 80 + i)
        faults = []
        got, _ = replay(i, tm.greedy_gang, full, {}, faults)
        if faults:
            raise AssertionError(f"K5+K6 {name}: kernel != plain version:\n"
                                 + "\n".join(faults))
        types, _ = captured_launches(lambda: tm.greedy_gang.launch(*full))
        if types != ["kernel"]:
            raise AssertionError(f"K5+K6 {name}: launched {types}")
        plan = tm.greedy_plan(P, C, H, G)
        ms = cuda_ms(lambda: tm.greedy_gang.launch(*full), 3)
        k5_ms = cuda_ms(lambda: tm.greedy.launch(*args), 3)
        member = (full[9] >= 0) & (torch.gather(
            full[10], 1, full[9].clamp(min=0).long()) >= 0)
        print(json.dumps({
            "phase": "F", "kernel": "greedy+gang", "world": name, "P": P,
            "C": C, "H": H, "G": G, "gang_counts_in_smem": plan.gang_in_smem,
            "equal_to_plain": True, "launches_per_call": len(types),
            "member_slots": int(member.sum()),
            "dropped": int(got[2].sum()), "kept_members": int(
                (member & (got[1] >= 0)).sum()),
            "ms": ms, "k5_alone_ms": k5_ms}))


# --------------------------------- phase T: the production scheduler section
ROOT = Path(__file__).resolve().parent
# compilation_cache_dir: the file's /var/cook/xla-cache lies outside the
# checkout; the smoke keeps the library in the checkout's build/
T_CACHE = ROOT / "build" / "cuda-cache"
T_STEPS = 3              # steps after the first, each leg
T_GANGS, T_GANG_SIZE, T_GANG_MIN = 4, 8, 4   # elastic gangs in the world
T_CLOCK = 2_000_000      # the pinned store clock (ms) of phase T's worlds
T_CHILD_TIMEOUT_S = 240.0


def production_section() -> dict:
    """``examples/cook-production.json``'s ``"scheduler"`` section."""
    path = ROOT / "examples" / "cook-production.json"
    return json.loads(path.read_text())["scheduler"]


def t_config(warmup=True, cache=T_CACHE):
    """The production section through ``daemon.build_scheduler_config``,
    the compilation cache in the checkout; ``warmup`` False zeroes the
    warmup knobs (a boot without it)."""
    from cook_tpu_torch.daemon import build_scheduler_config
    spec = production_section()
    spec["pipeline"]["compilation_cache_dir"] = str(cache)
    if not warmup:
        spec["pipeline"]["warmup_tasks"] = 0
        spec["pipeline"]["warmup_hosts"] = 0
    return build_scheduler_config(spec)


def expected_warm_runs(cfg, device="cuda") -> int:
    """The warmup's run count for ``cfg`` by the reference's rule
    (``cook_tpu/sched/fused.py:280-463``): per DRU mode, T bucket and H
    bucket, one run a distinct cap bucket, and where the megacycle is
    warmed (a ``tpu-megakernel`` pin, or ``auto`` on the card) one more
    a cap for each rows codec (wide, and i8 with the quantized wire)."""
    from cook_tpu_torch.ops.padding import bucket
    pl = cfg.pipeline

    def grid(n):
        top = bucket(n, minimum=64)
        return [top] if not pl.warmup_sweep else \
            [64 << i for i in range(top.bit_length() - 6)]
    backends = {cfg.default_matcher.backend}
    backends |= {mc.backend for _rx, mc in cfg.pool_matchers}
    caps = {bucket(cfg.default_matcher.max_jobs_considered)}
    caps |= {bucket(mc.max_jobs_considered) for _rx, mc in cfg.pool_matchers}
    mega = "tpu-megakernel" in backends or (
        "auto" in backends and device == "cuda")
    codecs = 2 if cfg.quantized_wire else 1
    runs = 0
    for T in grid(pl.warmup_tasks):
        for _H in grid(pl.warmup_hosts):
            n = len({min(c, T) for c in caps})
            runs += n * (1 + (codecs if mega else 0))
    return runs * (2 if pl.warmup_gpu else 1)


def t_world(cfg, device="cuda", n_jobs=Q_JOBS, n_users=Q_USERS,
            hosts=Q_HOSTS, seed=Q_SEED, counted=False, gangs=T_GANGS):
    """The production section's ``Scheduler`` (no status shards) over a
    fresh store with a pinned clock: phase Q's jobs and ``gangs``
    elastic gangs of ``T_GANG_SIZE`` (min ``T_GANG_MIN``) submitted
    last, so the optimizer's 900 s window and its newest
    ``max_replay_jobs`` hold them.  The scheduler is built first, as a
    node's takeover builds it."""
    from cook_tpu_torch.cluster import FakeCluster, FakeHost
    from cook_tpu_torch.sched import Scheduler
    from cook_tpu_torch.state import Group, Job, Resources, Store
    rng = np.random.default_rng(seed)
    store = Store()
    store.clock = lambda: T_CLOCK
    cluster = FakeCluster("fake-prod", [
        FakeHost(f"h{i}", Resources(cpus=64.0, mem=65536.0))
        for i in range(hosts)])
    t0 = time.perf_counter()
    sched = Scheduler(store, cfg, [cluster], rank_backend="tpu",
                      device=device)
    boot_s = time.perf_counter() - t0
    s = SimpleNamespace(store=store, cluster=cluster, cfg=cfg, sched=sched,
                        rng=rng, n_users=n_users, hosts=hosts,
                        uuid=counted_uuids(seed) if counted else None)
    q_top_up(s, n_jobs)
    members, groups = [], []
    for g in range(gangs):
        guuid = f"{seed:08x}-0000-4000-9000-{g:012x}"
        jobs = [Job(uuid=f"{seed:08x}-0000-4000-a{g:03x}-{i:012x}",
                    user=f"train{g}", command="x", max_retries=5,
                    priority=90, group=guuid,
                    submit_time_ms=T_CLOCK - 60_000 + g,
                    resources=Resources(cpus=16.0, mem=16384.0))
                for i in range(T_GANG_SIZE)]
        groups.append(Group(uuid=guuid, gang=True, gang_size=T_GANG_SIZE,
                            gang_min=T_GANG_MIN, gang_max=T_GANG_SIZE,
                            jobs=[j.uuid for j in jobs]))
        members += jobs
    if members:
        store.create_jobs(members, groups=groups)
    store.ensure_index()
    s.boot_s = boot_s
    return s


def t_step(s, what, i) -> dict:
    """One timed ``step_cycle``, then the status updates flushed and the
    store checked (outside the timed step)."""
    t0 = time.perf_counter()
    results = s.sched.step_cycle()
    ms = (time.perf_counter() - t0) * 1e3
    s.sched.flush_status_updates()
    live = check_live(s, f"phase T {what} step {i}")
    n = sum(len(r.launched_task_ids) for r in results.values())
    return {"step": i, "step_ms": ms, "launched": n, "live": live}


def t1_leg(warm: bool, device="cuda", grid=None, optimize=False,
           **size) -> dict:
    """One fresh process's boot on the production section (the child of
    :func:`phase_t`): the kernels' library from ``compilation_cache_dir``
    (built there when it is not), with ``warm`` the boot warmup
    (counted, timed, each of its launches replayed against its plain
    version), then the first step and ``T_STEPS`` more on phase Q's
    world; with ``optimize``, T2's ``step_optimize`` on that world
    (:func:`t_optimize`)."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    t_proc = time.perf_counter()
    cfg = t_config(warmup=warm)
    pl = cfg.pipeline
    if warm and grid is not None:  # a CPU rehearsal's (tasks, hosts)
        pl.warmup_tasks, pl.warmup_hosts = grid
    knobs = (pl.warmup_tasks, pl.warmup_hosts)
    # the constructor's warmup, made explicitly below to read its count
    pl.warmup_tasks = pl.warmup_hosts = 0
    s = t_world(cfg, device, **size)
    pl.warmup_tasks, pl.warmup_hosts = knobs
    card = device == "cuda"
    out = {"warm": warm, "world_s": time.perf_counter() - t_proc,
           "build_dir": str(cuda_lib.BUILD_DIR),
           "library_loaded_before_warmup": cuda_lib._LIB is not None}
    if warm:
        telemetry.reset_all()
        with cuda_lib.recording() as calls:
            t0 = time.perf_counter()
            runs = s.sched.warmup_kernels()
            if card:
                torch.cuda.synchronize()
            out["warmup_s"] = time.perf_counter() - t0
        counts = telemetry.snapshot()
        want = expected_warm_runs(cfg, device)
        if not 0 < runs == want:
            raise AssertionError(f"phase T: warmup ran {runs} times, the "
                                 f"rule gives {want}")
        missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
        if card and missing:
            raise AssertionError(f"phase T: warmup launched no {missing}")
        out.update(warmup_runs=runs, warmup_runs_expected=want,
                   warmup_launches=counts,
                   warmup_replayed_equal_to_plain=replay_all(
                       calls, "phase T warmup") if card else {})
    steps = [t_step(s, "warm" if warm else "cold", 0)]
    # built (nvcc ran) or loaded from the cache, by the warmup or else
    # by the first step
    out["library"] = dict(cuda_lib.LAST_BUILD)
    for i in range(T_STEPS):
        q_top_up(s, steps[-1]["launched"])
        steps.append(t_step(s, "warm" if warm else "cold", 1 + i))
    if not sum(x["launched"] for x in steps):
        raise AssertionError("phase T: no step launched anything")
    out.update(first_step_ms=steps[0]["step_ms"],
               warm_p50_ms=statistics.median(x["step_ms"]
                                             for x in steps[1:]),
               steps=steps, process_s=time.perf_counter() - t_proc)
    if optimize:
        out["optimizer"] = t_optimize(s, record=card)
    return out


def t1_child(warm: bool, optimize: bool = False) -> dict:
    """:func:`t1_leg` in a fresh ``python3`` process; its last stdout
    line is the leg's JSON.  A failed child fails the phase."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1")
    code = ("import json, chip_smoke as cs; print(json.dumps(cs.t1_leg("
            f"{warm!r}, optimize={optimize!r})))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=T_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"phase T child (warm={warm}) exit "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["child_wall_s"] = time.perf_counter() - t0
    return out


@contextmanager
def ordered_task_ids():
    """``uuid.uuid4`` from a counter inside the block: the elastic shrink
    of the optimizer's replays breaks ties by task id, which would
    otherwise be random on each side of a card-against-CPU comparison."""
    import itertools
    import uuid
    real, counter = uuid.uuid4, itertools.count(1)
    uuid.uuid4 = lambda: uuid.UUID(int=next(counter), version=4)
    try:
        yield
    finally:
        uuid.uuid4 = real


def t_optimize(s, record=True) -> dict:
    """``step_optimize`` once (its replays recorded and each launch
    replayed against its plain version), and the applied levers held
    against the decisions: the grow budget, the shrink pressure (less
    what it shed at once) and the rebalancer's ``max_preemption``."""
    from cook_tpu_torch.ops import cuda_lib, telemetry
    sched = s.sched
    pending0 = len(sched.elastic.debug()["pending_shrinks"])
    dyn0 = s.store.dynamic_config("rebalancer")
    telemetry.reset_all()
    with ordered_task_ids(), cuda_lib.recording() as calls:
        t0 = time.perf_counter()
        decisions = sched.step_optimize()
        secs = time.perf_counter() - t0
    counts = telemetry.snapshot()
    if not decisions:
        raise AssertionError("phase T: the optimizer decided nothing")
    shed = len(sched.elastic.debug()["pending_shrinks"]) - pending0
    budgets = []
    for pool, d in decisions.items():
        grow = sched.elastic.grow_budget.get(pool)
        if (grow is None) != (d.grow_budget is None) or (
                grow is not None and grow != float(d.grow_budget)):
            raise AssertionError(f"phase T: grow budget {grow} against "
                                 f"the decision's {d.grow_budget}")
        left = sched.elastic.shrink_pressure.get(pool, 0)
        if left + shed != d.shrink_pressure:
            raise AssertionError(f"phase T: shrink pressure {left} (+{shed} "
                                 f"shed) against {d.shrink_pressure}")
        if d.preemption_budget is not None:
            budgets.append(d.preemption_budget)
    dyn = s.store.dynamic_config("rebalancer")
    if budgets and (dyn or {}).get("max_preemption") != max(budgets):
        raise AssertionError(f"phase T: max_preemption {dyn} against "
                             f"{max(budgets)}")
    if not budgets and dyn != dyn0:
        raise AssertionError("phase T: the dynamic config moved without "
                             "a preemption budget")
    held = replay_all(calls, "phase T optimizer") if record and calls \
        else {}
    return {"seconds": secs, "launches": counts, "replayed": len(calls),
            "replayed_equal_to_plain": held,
            "decisions": {p: d.to_dict() for p, d in decisions.items()},
            "grow_budget": dict(sched.elastic.grow_budget),
            "shrink_pressure": dict(sched.elastic.shrink_pressure),
            "shed": shed, "max_preemption": (dyn or {}).get(
                "max_preemption")}


def t_small(device) -> dict:
    """Q_SMALL's world with the production section on ``device`` (counted
    uuids, pinned clock): two steps, then ``step_optimize``; the
    decisions as dicts."""
    cfg = t_config(warmup=False)
    s = t_world(cfg, device=device, counted=True, **Q_SMALL)
    for i in range(2):
        t_step(s, f"small {device}", i)
    with ordered_task_ids():
        d = s.sched.step_optimize()
    return {p: x.to_dict() for p, x in d.items()}


def phase_t() -> dict:
    """The production scheduler section on the card (the fake cluster in
    place of the file's remote backend, queue 1 item 11): T1, the boot
    warmup at the file's grid (131,072 x 8,192, 2,048 users, no sweep)
    in a fresh process with an empty ``compilation_cache_dir`` (nvcc
    builds the library there), then a fresh process without the warmup
    over the cache the first filled (the library loaded); each reports
    its first step against the warm p50.  T2: ``step_optimize`` once on
    the first process's world after its steps (its replays counted,
    recorded and replayed against their plain versions, the levers
    checked), and on Q_SMALL's world the card's decisions equal to the
    CPU's.  Returns the warmup's and the optimizer's launches."""
    import shutil
    shutil.rmtree(T_CACHE, ignore_errors=True)
    warm = t1_child(True, optimize=True)
    opt = warm.pop("optimizer")
    print(json.dumps({"phase": "T1", **warm}))
    cold = t1_child(False)
    print(json.dumps({"phase": "T1", **cold}))
    if warm["library"].get("built") is not True:
        raise AssertionError("phase T: the empty cache held a library")
    if cold["library"].get("built") is not False:
        raise AssertionError("phase T: the cache did not hold the library")
    print(json.dumps({"phase": "T1", "summary": {
        "warmup_s": warm["warmup_s"], "warmup_runs": warm["warmup_runs"],
        "library_build_s_in_warm_leg": warm["library"]["seconds"],
        "library_find_s_in_cold_leg": cold["library"]["seconds"],
        "library_load_s": {"warm": warm["library"]["load_s"],
                           "cold": cold["library"]["load_s"]},
        "cache_held_library_for_cold_leg": not cold["library"]["built"],
        "first_step_ms": {"warm": warm["first_step_ms"],
                          "cold": cold["first_step_ms"]},
        "warm_p50_ms": {"warm": warm["warm_p50_ms"],
                        "cold": cold["warm_p50_ms"]}}}))
    if opt["launches"].get("greedy", 0) <= 0:
        raise AssertionError("phase T: the replays launched no K5")
    print(json.dumps({"phase": "T2", "world": {
        "jobs": Q_JOBS, "users": Q_USERS, "hosts": Q_HOSTS,
        "elastic_gangs": T_GANGS, "after_steps": 1 + T_STEPS}, **opt}))
    card, cpu = t_small("cuda"), cpu_side("t_small")
    if card != cpu:
        raise AssertionError(f"phase T: Q_SMALL decisions differ:\n"
                             f"card {card}\ncpu  {cpu}")
    print(json.dumps({"phase": "T2", "small_world": Q_SMALL,
                      "decisions_card_equal_cpu": True,
                      "decisions": card}))
    return {"warmup": warm["warmup_launches"], "optimizer": opt["launches"]}


# ------------------------------ phase U: the dense cycle and the native pack
# 2 cycles, for the run's time
U_JOBS, U_USERS, U_HOSTS, U_CYCLES = 100_000, 200, 8_192, 1
U_SMALL = {"n_jobs": 3_000, "n_users": 20, "hosts": 300}  # card = CPU


def u_world(device="cuda", n_jobs=U_JOBS, n_users=U_USERS, hosts=U_HOSTS,
            seed=S_SEED):
    """The driver on the entity pack (``columnar_index=False``): one
    pool, phase S's jobs (counted uuids), ``hosts`` hosts of 64 cpus."""
    s = driver_world(device, n_jobs=0, n_users=n_users, hosts=hosts,
                     seed=seed)
    s.cfg.columnar_index = False
    make = counted_uuids(seed)
    jobs = driver_jobs(s.rng, n_jobs, n_users)
    for j in jobs:
        j.uuid = make()
    for i in range(0, n_jobs, 10_000):
        s.store.create_jobs(jobs[i:i + 10_000])
    s.make_uuid = make
    return s


def u_top_up(s, n):
    fresh = driver_jobs(s.rng, n, s.n_users)
    for j in fresh:
        j.uuid = s.make_uuid()
    if fresh:
        s.store.create_jobs(fresh)


def u_cycle(s, i, check=True) -> dict:
    """One entity-pack step through the driver's four phases; between
    fetch and apply the staged dense inputs through
    ``parallel/sharded.dense_pool_cycle`` on the same device, every
    compact output equal (the gang outputs the no-op reduction)."""
    from cook_tpu_torch.ops import pallas_cycle, telemetry
    from cook_tpu_torch.parallel import sharded
    drv = s.driver
    seen = []
    real = pallas_cycle.dense_wire

    def spy(fields):
        seen.append(fields)
        return real(fields)
    pallas_cycle.dense_wire = spy
    try:
        t0 = time.perf_counter()
        staged = drv.stage(s.sched)
        t1 = time.perf_counter()
    finally:
        pallas_cycle.dense_wire = real
    queues = {p.name: [] for p in staged.pools}
    results, line = {}, {"cycle": i, "pack_ms": drv.last_pack_ms,
                         "stage_phase_ms": (t1 - t0) * 1e3}
    for sg, fields in zip(staged.groups, seen):
        if not sg.dense:
            raise AssertionError("phase U: a group staged off the dense wire")
        before = telemetry.snapshot()
        ta = time.perf_counter()
        gd = drv.dispatch_group(sg)
        got = drv.fetch_group(gd)
        tb = time.perf_counter()
        after = telemetry.snapshot()
        for k, v in after.items():
            s.counts[k] = s.counts.get(k, 0) + v - before.get(k, 0)
        err = None
        if check:
            ref = sharded.dense_pool_cycle(
                sharded.dense_inputs_from_numpy(fields, drv.device),
                gpu_mode=sg.gpu_mode,
                max_over_quota_jobs=s.cfg.max_over_quota_jobs,
                considerable_cap=min(sg.cap, sg.T), device=drv.device)
            cand_row, cand_assign, cand_qpos, n_queue, cand_gang, drop = got
            err = 0.0
            for name, a, b in (("n_queue", n_queue, ref.n_queue),
                               ("cand_row", cand_row, ref.cand_row),
                               ("cand_assign", cand_assign, ref.cand_assign),
                               ("cand_qpos", cand_qpos, ref.cand_qpos)):
                if not np.array_equal(a, b.cpu().numpy()):
                    raise AssertionError(f"phase U cycle {i}: {name} "
                                         f"differs from the dense plain "
                                         f"cycle")
            for p, n in enumerate(n_queue.tolist()):
                err = max(err, max_err(gd.res.queue_rows[p, :n],
                                       ref.queue_rows[p, :n]))
            if not (np.array_equal(cand_gang, cand_assign)
                    and not drop.any()):
                raise AssertionError(f"phase U cycle {i}: the no-op gang "
                                     f"reduction moved a slot")
        drv.apply_group(s.sched, gd, queues, results)
        line.update(stage_ms=sg.stage_ms, h2d_bytes=sg.mega["h2d_bytes"],
                    cycle_ms=(tb - ta) * 1e3, T=sg.T, H=sg.H,
                    rows_codec=sg.mega["rows_codec"],
                    outputs_equal_to_dense_plain=check, max_abs_err=err)
    s.sched.flush_status_updates()
    check_hosts(s)
    line["placements"] = launched_pairs(s, results)
    return line


def u_small(device) -> list:
    s = u_world(device, **U_SMALL)
    pairs = []
    for i in range(U_CYCLES):
        pairs.append(u_cycle(s, i, check=False)["placements"])
        u_top_up(s, len(pairs[-1]))
    return pairs


def phase_u1(device="cuda", **size) -> dict:
    """U1: the entity-pack driver at one pool of 131,072 task rows (the
    bucket of 100,000 jobs and the running ones) x 8,192 hosts, C =
    1,024, for ``U_CYCLES`` cycles, counted (path ``dense_cycle``);
    then U_SMALL's world on the card and on the CPU, the same (job
    uuid, hostname) pairs every cycle."""
    from cook_tpu_torch.ops import telemetry
    s = u_world(device, **size)
    telemetry.reset_all()
    lines = []
    for i in range(U_CYCLES):
        line = u_cycle(s, i, check=device == "cuda")
        n = len(line.pop("placements"))
        line["placements"] = n
        print(json.dumps({"phase": "U1", **line}))
        lines.append(line)
        u_top_up(s, n)
    counts = dict(s.counts)
    missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
    if device == "cuda" and missing:
        raise AssertionError(f"phase U: kernels not launched: {missing}")
    if not sum(x["placements"] for x in lines):
        raise AssertionError("phase U: no placement")
    card, cpu = u_small(device), cpu_side("u_small")
    if card != cpu:
        raise AssertionError("phase U: U_SMALL pairs differ, card and CPU")
    print(json.dumps({"phase": "U1", "launches_per_kernel": counts,
                      "small_world": U_SMALL, "small_pairs_card_equal_cpu":
                      [len(p) for p in card],
                      "median": {k: statistics.median(x[k] for x in lines)
                                 for k in ("pack_ms", "stage_ms",
                                           "cycle_ms", "h2d_bytes")}}))
    return counts


U2_TURNS = ("native", "numpy", "numpy", "native")


def phase_u2(s) -> dict:
    """U2, on phase S's driver and world: one cycle with the native
    pack's three entry points spied on, each captured call run again
    through ``libcookpack`` and through its numpy branch, equal; then
    one cycle a turn with the native branch and with the numpy branch
    (native, numpy, numpy, native), ``stage_ms`` and ``pack_ms`` of
    each."""
    from cook_tpu_torch.native import pack
    if not pack.native_available():
        raise AssertionError("phase U: libcookpack did not build")
    captured = {}
    real = {n: getattr(pack, n) for n in ("pack_diff", "order_merge",
                                          "prune_rows")}

    def spy(name):
        def f(*args):
            captured.setdefault(name, [copy_args(args)])
            return real[name](*args)
        return f
    for n in real:
        setattr(pack, n, spy(n))
    try:
        top_up(s, 1_000)
        line = driver_cycle(s, "U2", 0, check=False)
        touch_driver_queue(s)
    finally:
        for n, f in real.items():
            setattr(pack, n, f)
    missing = sorted(set(real) - set(captured))
    if missing:
        raise AssertionError(f"phase U: no call of {missing} in phase "
                             f"S's cycle")
    checks = {}
    for name, (args,) in captured.items():
        t0 = time.perf_counter()
        got = real[name](*args)
        t1 = time.perf_counter()
        with pack.numpy_branch():
            want = real[name](*args)
        t2 = time.perf_counter()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"phase U: {name} differs from its numpy "
                                 f"branch")
        checks[name] = {"native_ms": (t1 - t0) * 1e3,
                        "numpy_ms": (t2 - t1) * 1e3,
                        "sizes": [int(np.size(a)) for a in args
                                  if isinstance(a, np.ndarray)],
                        "equal_to_numpy": True}
    turns = []
    for i, branch in enumerate(U2_TURNS):
        top_up(s, line["placements"])
        ctx = pack.numpy_branch() if branch == "numpy" else nullcontext()
        with ctx:
            line = driver_cycle(s, f"U2 {branch}", 1 + i, check=False)
            touch_driver_queue(s)
        turns.append({"branch": branch, "stage_ms": line["stage_ms"],
                      "pack_ms": line["pack_ms"],
                      "step_ms": line["step_ms"],
                      "resident_path": line["resident_path"]})
    by = {b: {k: statistics.mean(t[k] for t in turns if t["branch"] == b)
              for k in ("stage_ms", "pack_ms", "step_ms")}
          for b in ("native", "numpy")}
    out = {"phase": "U2", "native_available": True, "checks": checks,
           "turns": turns, "mean_by_branch": by}
    print(json.dumps(out))
    return out


def touch_driver_queue(s) -> int:
    """The driver's published queue read (its rows fetched and the
    cycle's launches pruned, as a queue consumer would)."""
    q = s.last_queues.get("default")
    return 0 if q is None else len(q.uuids)


def copy_args(args) -> tuple:
    return tuple(a.copy() if isinstance(a, np.ndarray) else a for a in args)


# ------------------------------------------ the CPU sides, in workers
# The CPU side of a card = CPU comparison is a function of its world's
# seed and size alone.  main() starts the longest ones in worker
# processes (spawned: no CUDA in them) before phase F, so they run on
# the host's other cores beside the card phases; a phase takes its
# side's result from there, or computes it in process when nothing was
# started (a phase run alone).
CPU_SIDES = (("e_split",), ("x_leg", 0), ("x_leg", 2), ("t_small",),
             ("q_small", 0), ("q_small", 2), ("u_small",), ("l_small",),
             ("h_small",), ("sh_small",), ("ch1",), ("ch2",), ("fo1",),
             ("fo2",))
CPU_SIDE_WORKERS, CPU_SIDE_THREADS = 2, 2
_SIDES = {"pool": None, "futures": {}}


def cpu_side_run(key: tuple):
    name, *args = key
    if name == "x_leg":
        return x_leg(args[0], "cpu")
    if name == "q_small":
        return q_small_run(args[0], "cpu")
    if name == "t_small":
        return t_small("cpu")
    if name == "u_small":
        return u_small("cpu")
    if name == "e_split":
        return split_on_cpu()
    if name == "l_small":
        return l_small("cpu")
    if name == "h_small":
        return h_small("cpu")
    if name == "sh_small":
        return sh_small("cpu")
    if name == "ch1":
        got = ch1_run("cpu")
        return {k: got[k] for k in ("summary", "sequences", "wall_s")}
    if name == "ch2":
        return ch2_run("cpu")
    if name == "fo1":
        got = fo1_run("cpu")
        return {k: got[k] for k in ("summary", "owners", "placed",
                                    "wall_s")}
    if name == "fo2":
        got = fo2_run("cpu")
        return {k: got[k] for k in ("picks", "wall_s")}
    raise KeyError(key)


def cpu_side(*key):
    future = _SIDES["futures"].pop(key, None)
    return cpu_side_run(key) if future is None else future.result()


def _cpu_worker_init() -> None:
    torch.set_num_threads(CPU_SIDE_THREADS)


def start_cpu_sides() -> None:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(
        CPU_SIDE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init)
    _SIDES["pool"] = pool
    for key in CPU_SIDES:
        _SIDES["futures"][key] = pool.submit(cpu_side_run, key)


def stop_cpu_sides() -> None:
    pool = _SIDES["pool"]
    _SIDES["pool"], _SIDES["futures"] = None, {}
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)


def main() -> int:
    try:
        return run()
    finally:
        stop_cpu_sides()


def run() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    from cook_tpu_torch.ops import cuda_lib, telemetry
    from cook_tpu_torch.ops.pallas_cycle import megacycle, megacycle_plain
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    walls, t_mark = {}, [time.perf_counter()]

    def mark(name):
        # seconds of command since the previous mark, by phase
        now = time.perf_counter()
        walls[name] = now - t_mark[0]
        t_mark[0] = now

    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)
    build_s = time.perf_counter() - t0
    log = cuda_lib.BUILD_DIR / "ptxas.log"
    log.write_text(cuda_lib.BUILD_LOG)
    from cook_tpu_torch.cluster.remote import native_available
    from cook_tpu_torch.state.replication import replication_available
    t0 = time.perf_counter()
    if not replication_available():
        raise RuntimeError("g++ failed to build native/repl.cpp")
    if not native_available():
        raise RuntimeError("g++ failed to build native/transport.cpp")
    print(json.dumps({"build_s": build_s, "ptxas_log": str(log),
                      "native_build_s": time.perf_counter() - t0}))

    mark("build")
    start_cpu_sides()
    phase_f()
    mark("F")
    rng = np.random.default_rng(SEED)
    w = build_world(rng)
    res_dev = torch.from_numpy(w.res).cuda()
    disk_dev = torch.from_numpy(w.disk).cuda()
    scales = {}

    # warm-up cycle, recorded for phase A (the world is not changed)
    staged = stage(w, res_dev, disk_dev, scales)
    with cuda_lib.recording() as calls:
        megacycle(staged["wire"], **megacycle_args(staged))
    torch.cuda.synchronize()
    rows = phase_a(calls)
    cycle_launches = rows.pop("cycle_cuda_launches")
    for k, row in rows.items():
        b_ms, b_by = bound(row)
        print(json.dumps({"phase": "A", "kernel": k, **row,
                          "bound_ms": b_ms, "bound_by": b_by}))
    print(json.dumps(k2_k4_line(rows)))
    for line in k1_k56_lines({**rows, "cycle_cuda_launches": cycle_launches}):
        print(json.dumps(line))
    mark("A")
    phase_c()
    mark("C")

    # phase B: the main path, counted
    snap, scales0 = snapshot(w), dict(scales)
    rebuild_outs, rebuild_lines = [], []
    telemetry.reset_all()
    cycle_ms, plain_ms, stage_ms, placed, codecs = [], [], [], [], []
    enqueue_ms, span_ms = [], []
    for cyc in range(CYCLES):
        t0 = time.perf_counter()
        staged = stage(w, res_dev, disk_dev, scales)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        ev0.record()
        res = megacycle(staged["wire"], **megacycle_args(staged))
        t_enq = time.perf_counter()
        ev1.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = telemetry.snapshot()
        ref = megacycle_plain(staged["wire"], **megacycle_args(staged))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name in res._fields:
            max_err(getattr(res, name), getattr(ref, name))
        rebuild_outs.append(outputs_of(res))
        n = apply(w, res)
        stage_ms.append((t1 - t0) * 1e3)
        cycle_ms.append((t2 - t1) * 1e3)
        enqueue_ms.append((t_enq - t1) * 1e3)
        span_ms.append(ev0.elapsed_time(ev1))
        plain_ms.append((t3 - t2) * 1e3)
        placed.append(n)
        codecs.append([staged["rows_codec"], str(staged["avail_scale"]),
                       str(staged["cap_scale"])])
        rebuild_lines.append({
            "phase": "B", "sequence": "placement", "mode": "rebuild",
            "path": "rebuild", "cycle": cyc, "stage_ms": stage_ms[-1],
            "cycle_ms": cycle_ms[-1], "enqueue_ms": enqueue_ms[-1],
            "device_span_ms": span_ms[-1], "plain_cycle_ms": plain_ms[-1],
            "placed": n, "dropped": int(res.cand_dropped.sum()),
            "n_queue": res.n_queue.tolist(), "h2d_bytes": staged["h2d_bytes"],
            "codecs": codecs[-1], "launches_so_far": launches})
        print(json.dumps(rebuild_lines[-1]))
    counts = telemetry.snapshot()
    prof = profile_cycles(staged["wire"], megacycle_args(staged))
    busy = prof.pop("busy")
    span = statistics.median(span_ms[1:])
    prof["idle_share_of_unprofiled_span"] = \
        "not measured" if busy is None else 1.0 - busy / span
    print(json.dumps(prof))
    missing = [k for k in SOURCES if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if sum(placed) <= 0:
        raise AssertionError("no placement in 5 cycles")
    print(json.dumps({
        "phase": "B", "cycles": CYCLES, "cycle_ms": cycle_ms,
        "cycle_ms_median_after_first": statistics.median(cycle_ms[1:]),
        "enqueue_ms_median_after_first": statistics.median(enqueue_ms[1:]),
        "device_span_ms_median_after_first": statistics.median(span_ms[1:]),
        "plain_cycle_ms_median_after_first": statistics.median(plain_ms[1:]),
        "stage_ms_median_after_first": statistics.median(stage_ms[1:]),
        "placed": placed, "launches_per_kernel": counts,
        "shape": {"P": P, "T": w.T, "H": w.H, "C": 1024, "E": E,
                  "live_rows": LIVE, "users": USERS, "hosts": HOSTS}}))

    # phase B, resident: the same cycles through the resident wire, then
    # churn in both modes, then the staging profile of both modes
    res_counts, res_events, res_lines, state = phase_b_resident(
        w, snap, scales0, rebuild_outs, placed)
    churn_counts, churn_events, churn_lines = phase_b_churn(
        w, state, np.random.default_rng(SEED + 7))
    print(json.dumps(staging_profile(w, state,
                                     np.random.default_rng(SEED + 8))))
    by_mode = {}
    for seq, lines in (("placement", rebuild_lines + res_lines),
                       ("churn", churn_lines)):
        for mode in ("rebuild", "resident"):
            ls = [x for x in lines if x["mode"] == mode]
            by_mode[f"{seq}/{mode}"] = {
                "stage_ms_median_after_first": statistics.median(
                    x["stage_ms"] for x in ls[1:]),
                "h2d_bytes_median_after_first": statistics.median(
                    x["h2d_bytes"] for x in ls[1:]),
                "stage_ms": [x["stage_ms"] for x in ls],
                "h2d_bytes": [x["h2d_bytes"] for x in ls],
                "paths": [x["path"] for x in ls]}
    print(json.dumps({"phase": "B", "modes": by_mode,
                      "resident_events": res_events,
                      "churn_events": churn_events,
                      "resident_launches_per_kernel": res_counts,
                      "churn_launches_per_kernel": churn_counts}))
    mark("B")
    print(json.dumps(phase_mirror(np.random.default_rng(SEED + 9))))
    mark("M")
    driver_counts, s_world = phase_s(keep=True)
    mark("S")
    phase_u2(s_world)
    del s_world
    mark("U2")
    sched_counts = phase_q()
    mark("Q")
    rebalance_counts, v = phase_v(keep=True)
    mark("V")
    admission_counts = phase_w()
    mark("W")
    degraded_counts = phase_x(v)
    del v
    mark("X")
    sim_counts = phase_y()
    mark("Y")
    rest_counts = phase_z()
    mark("Z")
    node_counts = phase_n()
    mark("N")
    phase_o()
    mark("O")
    remote_counts = phase_g()
    mark("G")
    k8s_counts = phase_l()
    mark("L")
    partitioned_counts = phase_h()
    mark("H")
    mesh_counts = phase_sh1()
    mark("SH1")
    shard_counts = phase_sh2()
    mark("SH2")
    chaos_counts = phase_ch()
    mark("CH")
    federation_counts = phase_fo()
    mark("FO")
    prod_counts = phase_t()
    mark("T")
    dense_counts = phase_u1()
    mark("U1")
    rank_counts = phase_r(build_world(np.random.default_rng(SEED)))
    mark("R")
    preempt_counts = phase_p(np.random.default_rng(SEED + 10))
    mark("P")
    topk_rows = phase_d()
    mark("D")
    split_counts = phase_e()
    mark("E")
    print(json.dumps({"phase": "E", "launches_per_kernel": split_counts}))
    print(json.dumps({"phase_wall_s": walls}))
    print(card)
    out = []
    for k, row in rows.items():
        b_ms, b_by = bound(row)
        out.append({
            "name": k, "route": "cuda",
            "source": f"cook_tpu_torch/ops/csrc/{SOURCES[k]}",
            "replaces": "cook_tpu/ops/pallas_cycle.py:137",
            "stage": STAGES[k], "launches": counts[k],
            "launches_by_path": {
                "cycle_rebuild": counts[k], "cycle_resident": res_counts[k],
                "churn_both_modes": churn_counts[k],
                "split_rank": rank_counts.get(k, 0),
                "preemption": preempt_counts.get(k, 0),
                "driver": driver_counts["driver"][k],
                "driver_split_cycle": driver_counts["split"].get(k, 0),
                "scheduler_sync": sched_counts["sync"].get(k, 0),
                "scheduler_pipelined": sched_counts["pipelined"].get(k, 0),
                "scheduler_split": rebalance_counts["split"].get(k, 0),
                "rebalancer": rebalance_counts["rebalancer"].get(k, 0),
                "admission_split": admission_counts.get(k, 0),
                "scheduler_degraded": degraded_counts.get(k, 0),
                "simulator": sim_counts.get(k, 0),
                "rest": rest_counts.get(k, 0),
                "daemon": node_counts.get(k, 0),
                "remote_node": remote_counts.get(k, 0),
                "k8s_node": k8s_counts.get(k, 0),
                "partitioned_node": partitioned_counts.get(k, 0),
                "mesh_cycle": mesh_counts.get(k, 0),
                "sharded_controllers": shard_counts.get(k, 0),
                "chaos": chaos_counts.get(k, 0),
                "federation": federation_counts.get(k, 0),
                "warmup": prod_counts["warmup"].get(k, 0),
                "optimizer": prod_counts["optimizer"].get(k, 0),
                "dense_cycle": dense_counts.get(k, 0)},
            **({"inside": "greedy"} if k == "gang" else {}),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": row["library_ms"], "calls_per_cycle": row["calls"],
            "cuda_launches_per_cycle": row.get("cuda_launches"),
            "device_ms": row.get("device_ms"),
            **({"ms_of_library_calls": row["ms_of_library_calls"]}
               if "ms_of_library_calls" in row else {}),
            **({"per_call": row["per_call"]} if "per_call" in row else {})})
    for k, row in topk_rows.items():
        b_ms, b_by = bound(row)
        out.append({
            "name": k, "route": "cuda",
            "source": "cook_tpu_torch/ops/csrc/topk.cu",
            "replaces": TOPK[k]["replaces"], "stage": TOPK[k]["stage"],
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": row["library_ms"],
            "device_ms": row["device_ms"],
            "cuda_launches_per_call": row["cuda_launches_per_call"]})
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
