"""The cycle as a chain of stage kernels: ``megacycle`` on the card.

Each call below is a stage wrapper (K1-K6); given CUDA tensors it
launches its CUDA kernel, given CPU tensors its plain PyTorch version,
so the same chain runs in the CPU tests.  The chain computes exactly
``parallel/sharded.pool_cycle`` followed by ``gang_reduce_body``.
"""

from __future__ import annotations

from . import admit, quant, scan, sort
from .delta import FLAG_PENDING, FLAG_USER_FIRST, FLAG_VALID
from .expand import expand
from .gang import gang_stage
from .match import greedy


def megacycle_stages(wire, *, gpu_mode: bool = False,
                     max_over_quota_jobs: int = 100,
                     considerable_cap: int = 1024,
                     rows_codec: int = quant.ROWS_WIDE,
                     avail_scale=0.0, cap_scale=0.0):
    from .pallas_cycle import MegaCycleResult
    P, T = wire.flags.shape
    C = int(min(considerable_cap, T))
    flags = wire.flags
    # K2 + K1: wire decode, user segments, phase-0 bases
    user_rank = scan.int_scan(flags, bit=FLAG_USER_FIRST, offset=-1)
    x = expand(wire.rows, flags, wire.res_base, wire.disk_base,
               wire.tokens_u, wire.shares_u, wire.quota_u, user_rank,
               wire.group_id, wire.host_bits, wire.exc_rows, wire.avail,
               wire.capacity, rows_codec=rows_codec, avail_scale=avail_scale,
               cap_scale=cap_scale, n_hosts=wire.exc_mask.shape[2])
    # rank_body: over-quota limit, DRU, rank sort
    cum_all = scan.seg_scan(x.usage, x.start, flags, FLAG_VALID, 0)
    over = admit.rank_over(cum_all, x.quota, flags)
    over_cnt = scan.seg_count(over, 1, x.start)
    keep, xk = admit.rank_keep(x.usage, flags, over_cnt, max_over_quota_jobs)
    cum = scan.seg_scan(xk, x.start)
    dru, rankable = admit.rank_dru(cum, x.shares, keep, flags, gpu_mode)
    order = sort.sort_rank(dru, rankable, user_rank)
    # each user's running base: segment totals of the running usage
    cum_run = scan.seg_scan(x.usage, x.start, flags, FLAG_VALID,
                            FLAG_PENDING)
    seg_last = scan.int_scan(x.last_mark, op="min", reverse=True)
    # considerable_body in rank order
    r = admit.gather(order, x.usage, x.quota, user_rank, cum_run, seg_last,
                     x.tokens, flags, rankable)
    cum_pool = scan.prefix16(r.pend_usage)
    queue_ok = admit.queue(cum_pool, x.pool_base, wire.pool_quota,
                           x.group_base, wire.group_quota, r.bits_r)
    perm = sort.sort_user(r.user_r)
    vals, ufirst = admit.user_gather(perm, r.usage_r, queue_ok, r.user_r)
    cum_s = scan.seg_scan(vals, ufirst)
    quota_ok, quota_ok_s = admit.user_quota(perm, cum_s, r.run_base_r,
                                            r.quota_r, queue_ok)
    cnt_s = scan.seg_count(quota_ok_s, 1, ufirst)
    accepted = admit.accept(perm, cnt_s, r.tokens_r, quota_ok, r.bits_r)
    adm = scan.int_scan(accepted, bit=1)
    mv = admit.match_valid(accepted, adm, wire.num_considerable)
    # compaction, match, compact outputs, gang reduction
    kk = scan.int_scan(mv, bit=1)
    qp = scan.int_scan(queue_ok, bit=1)
    c = admit.compact(order, mv, kk, queue_ok, qp, x.job_res, x.exc_id, C)
    assign = greedy(c.res_c, c.valid_c, c.gpu_c, c.eid_c, x.host_gpu,
                    x.host_blocked, wire.exc_mask, x.avail, x.capacity)
    cand_gang, dropped = gang_stage(c.cand_row, assign, wire.gang_id,
                                    wire.gang_size, wire.gang_attr,
                                    wire.host_topo)
    return MegaCycleResult(
        queue_rows=c.queue_rows, n_queue=c.n_queue, cand_row=c.cand_row,
        cand_assign=assign, cand_qpos=c.cand_qpos, cand_gang=cand_gang,
        cand_dropped=dropped)
