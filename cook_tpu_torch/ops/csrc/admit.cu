// K4 admit: the elementwise stages of the cycle between the scans and
// sorts: rank_body's over-quota limit and DRU (dru.py:85-103),
// considerable_body's admission tests (considerable.py:86-111),
// _compact_admitted (sharded.py:292) and _compact_outputs
// (sharded.py:355), as they run inside ops/pallas_cycle.py::_kernel.
//
// Each entry is one or three plain elementwise launches over the pool's
// [T] (or [C]) axis.  Bound: bytes (every input read once, every output
// written once); at T = 128Ki, P = 4 each entry moves 2-30 MB.
#include "common.cuh"

namespace {

using cook::gtid;
using cook::grid_for;
using cook::kThreads;

constexpr uint8_t kPending = 1, kValid = 2, kEnqueueOk = 4, kLaunchOk = 8;
// bits of the rank-order byte built by k4_gather
constexpr uint8_t kRLaunch = 1, kREnqueue = 2, kRRankable = 4;

__device__ __forceinline__ float bit_f(bool b) { return b ? 1.0f : 0.0f; }

__global__ void rank_over(const float* __restrict__ cum,
                          const float* __restrict__ quota,
                          const uint8_t* __restrict__ flags,
                          uint8_t* __restrict__ over, long long total) {
  long long i = gtid();
  if (i >= total) return;
  bool any = false;
  for (int c = 0; c < 4; ++c) any |= cum[i * 4 + c] > quota[i * 4 + c];
  over[i] = any && (flags[i] & kValid);
}

__global__ void rank_keep(const float* __restrict__ usage,
                          const uint8_t* __restrict__ flags,
                          const int* __restrict__ over_cnt, int max_over,
                          uint8_t* __restrict__ keep, float* __restrict__ xk,
                          long long total) {
  long long i = gtid();
  if (i >= total) return;
  bool valid = flags[i] & kValid;
  bool k = valid && over_cnt[i] <= max_over;
  keep[i] = k;
  for (int c = 0; c < 4; ++c)
    xk[i * 4 + c] = (usage[i * 4 + c] * bit_f(valid)) * bit_f(k);
}

__global__ void rank_dru(const float* __restrict__ cum,
                         const float* __restrict__ shares,
                         const uint8_t* __restrict__ keep,
                         const uint8_t* __restrict__ flags, int gpu_mode,
                         float* __restrict__ dru,
                         uint8_t* __restrict__ rankable, long long total) {
  long long i = gtid();
  if (i >= total) return;
  float d;
  if (gpu_mode) {
    d = cum[i * 4 + 2] / shares[i * 3 + 2];
  } else {
    float a = cum[i * 4 + 1] / shares[i * 3 + 1];
    float b = cum[i * 4 + 0] / shares[i * 3 + 0];
    // jnp.maximum propagates NaN (fmaxf would drop it)
    d = (a != a || b != b) ? __int_as_float(0x7FC00000) : (a > b ? a : b);
  }
  dru[i] = d;
  rankable[i] = keep[i] && (flags[i] & kPending);
}

__global__ void gather_rank(const int* __restrict__ order,
                            const float* __restrict__ usage,
                            const float* __restrict__ quota,
                            const int* __restrict__ user_rank,
                            const float* __restrict__ cum_run,
                            const int* __restrict__ seg_last,
                            const float* __restrict__ tokens,
                            const uint8_t* __restrict__ flags,
                            const uint8_t* __restrict__ rankable,
                            float* __restrict__ usage_r,
                            float* __restrict__ quota_r,
                            int* __restrict__ user_r,
                            float* __restrict__ run_base_r,
                            float* __restrict__ tokens_r,
                            uint8_t* __restrict__ bits_r,
                            float* __restrict__ pend_usage, int S,
                            long long n) {
  long long i = gtid();
  if (i >= S * n) return;
  long long s = i / n;
  long long o = s * n + order[i];
  long long l = s * n + seg_last[o];
  bool rk = rankable[o];
  for (int c = 0; c < 4; ++c) {
    float u = usage[o * 4 + c];
    usage_r[i * 4 + c] = u;
    quota_r[i * 4 + c] = quota[o * 4 + c];
    run_base_r[i * 4 + c] = cum_run[l * 4 + c];
    pend_usage[i * 4 + c] = u * bit_f(rk);
  }
  user_r[i] = user_rank[o];
  tokens_r[i] = tokens[o];
  uint8_t f = flags[o];
  bits_r[i] = ((f & kLaunchOk) ? kRLaunch : 0) |
              ((f & kEnqueueOk) ? kREnqueue : 0) | (rk ? kRRankable : 0);
}

__global__ void queue_ok_k(const float* __restrict__ cum_pool,
                           const float* __restrict__ pool_base,
                           const float* __restrict__ pool_quota,
                           const float* __restrict__ group_base,
                           const float* __restrict__ group_quota,
                           const uint8_t* __restrict__ bits_r,
                           uint8_t* __restrict__ queue_ok, int S,
                           long long n) {
  long long i = gtid();
  if (i >= S * n) return;
  long long s = i / n;
  bool pq = true, gq = true;
  for (int c = 0; c < 4; ++c) {
    float v = cum_pool[i * 4 + c];
    pq &= v + pool_base[s * 4 + c] <= pool_quota[s * 4 + c];
    gq &= v + group_base[s * 4 + c] <= group_quota[s * 4 + c];
  }
  uint8_t b = bits_r[i];
  queue_ok[i] = (b & kRRankable) && pq && gq && (b & kREnqueue);
}

__global__ void user_gather(const int* __restrict__ perm,
                            const float* __restrict__ usage_r,
                            const uint8_t* __restrict__ queue_ok,
                            const int* __restrict__ user_r,
                            float* __restrict__ vals,
                            uint8_t* __restrict__ ufirst, int S,
                            long long n) {
  long long j = gtid();
  if (j >= S * n) return;
  long long s = j / n, t = j % n;
  long long r = s * n + perm[j];
  float inc = bit_f(queue_ok[r]);
  for (int c = 0; c < 4; ++c) vals[j * 4 + c] = usage_r[r * 4 + c] * inc;
  ufirst[j] = t == 0 || user_r[r] != user_r[s * n + perm[j - 1]];
}

__global__ void user_quota(const int* __restrict__ perm,
                           const float* __restrict__ cum_s,
                           const float* __restrict__ run_base_r,
                           const float* __restrict__ quota_r,
                           const uint8_t* __restrict__ queue_ok,
                           uint8_t* __restrict__ quota_ok,
                           uint8_t* __restrict__ quota_ok_s, int S,
                           long long n) {
  long long j = gtid();
  if (j >= S * n) return;
  long long s = j / n;
  long long r = s * n + perm[j];
  bool q = queue_ok[r];
  for (int c = 0; c < 4; ++c)
    q &= cum_s[j * 4 + c] + run_base_r[r * 4 + c] <= quota_r[r * 4 + c];
  quota_ok[r] = q;
  quota_ok_s[j] = q;
}

__global__ void accept_k(const int* __restrict__ perm,
                         const int* __restrict__ cnt_s,
                         const float* __restrict__ tokens_r,
                         const uint8_t* __restrict__ quota_ok,
                         const uint8_t* __restrict__ bits_r,
                         uint8_t* __restrict__ accepted, int S, long long n) {
  long long j = gtid();
  if (j >= S * n) return;
  long long s = j / n;
  long long r = s * n + perm[j];
  accepted[r] = quota_ok[r] && (float)cnt_s[j] <= floorf(tokens_r[r]) &&
                (bits_r[r] & kRLaunch);
}

__global__ void match_valid_k(const uint8_t* __restrict__ accepted,
                              const int* __restrict__ adm,
                              const int* __restrict__ num_considerable,
                              uint8_t* __restrict__ mv, int S, long long n) {
  long long i = gtid();
  if (i >= S * n) return;
  mv[i] = accepted[i] && adm[i] <= num_considerable[i / n];
}

__global__ void compact_init(int* __restrict__ sel,
                             int* __restrict__ queue_rows, int S, long long n,
                             int C) {
  long long i = gtid();
  if (i < S * (long long)C) sel[i] = (int)n;
  if (i < S * n) queue_rows[i] = (int)n;
}

__global__ void compact_scatter(const int* __restrict__ order,
                                const uint8_t* __restrict__ mv,
                                const int* __restrict__ kk,
                                const uint8_t* __restrict__ queue_ok,
                                const int* __restrict__ qp,
                                int* __restrict__ sel,
                                int* __restrict__ queue_rows, int S,
                                long long n, int C) {
  long long i = gtid();
  if (i >= S * n) return;
  long long s = i / n, t = i % n;
  int k = kk[i] - 1;
  if (mv[i] && k < C) sel[s * C + k] = (int)t;
  if (queue_ok[i]) queue_rows[s * n + qp[i] - 1] = order[i];
}

__global__ void compact_slots(const int* __restrict__ sel,
                              const int* __restrict__ order,
                              const int* __restrict__ qp,
                              const float* __restrict__ job_res,
                              const int* __restrict__ exc_id,
                              int* __restrict__ n_queue,
                              int* __restrict__ cand_row,
                              int* __restrict__ cand_qpos,
                              float* __restrict__ res_c,
                              uint8_t* __restrict__ valid_c,
                              uint8_t* __restrict__ gpu_c,
                              int* __restrict__ eid_c, int S, long long n,
                              int C) {
  long long i = gtid();
  if (i >= S * (long long)C) return;
  long long s = i / C;
  int c = (int)(i % C);
  if (c == 0) n_queue[s] = qp[s * n + n - 1];
  int sl = sel[i];
  bool v = sl < n;
  long long cl = s * n + (sl < n - 1 ? sl : n - 1);
  int ti = order[cl];
  long long row = s * n + ti;
  cand_row[i] = v ? ti : -1;
  cand_qpos[i] = v ? qp[cl] - 1 : -1;
  for (int r = 0; r < 4; ++r)
    res_c[i * 4 + r] = job_res[row * 4 + r] * bit_f(v);
  valid_c[i] = v;
  gpu_c[i] = job_res[row * 4 + 2] > 0.0f;
  eid_c[i] = exc_id[row];
}

}  // namespace

COOK_API int k4_rank_over(const float* cum, const float* quota,
                          const uint8_t* flags, uint8_t* over, int S,
                          long long n, void* stream) {
  rank_over<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      cum, quota, flags, over, S * n);
  return cook::last_error();
}

COOK_API int k4_rank_keep(const float* usage, const uint8_t* flags,
                          const int* over_cnt, int max_over, uint8_t* keep,
                          float* xk, int S, long long n, void* stream) {
  rank_keep<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      usage, flags, over_cnt, max_over, keep, xk, S * n);
  return cook::last_error();
}

COOK_API int k4_rank_dru(const float* cum, const float* shares,
                         const uint8_t* keep, const uint8_t* flags,
                         int gpu_mode, float* dru, uint8_t* rankable, int S,
                         long long n, void* stream) {
  rank_dru<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      cum, shares, keep, flags, gpu_mode, dru, rankable, S * n);
  return cook::last_error();
}

COOK_API int k4_gather(const int* order, const float* usage,
                       const float* quota, const int* user_rank,
                       const float* cum_run, const int* seg_last,
                       const float* tokens, const uint8_t* flags,
                       const uint8_t* rankable, float* usage_r,
                       float* quota_r, int* user_r, float* run_base_r,
                       float* tokens_r, uint8_t* bits_r, float* pend_usage,
                       int S, long long n, void* stream) {
  gather_rank<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      order, usage, quota, user_rank, cum_run, seg_last, tokens, flags,
      rankable, usage_r, quota_r, user_r, run_base_r, tokens_r, bits_r,
      pend_usage, S, n);
  return cook::last_error();
}

COOK_API int k4_queue(const float* cum_pool, const float* pool_base,
                      const float* pool_quota, const float* group_base,
                      const float* group_quota, const uint8_t* bits_r,
                      uint8_t* queue_ok, int S, long long n, void* stream) {
  queue_ok_k<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      cum_pool, pool_base, pool_quota, group_base, group_quota, bits_r,
      queue_ok, S, n);
  return cook::last_error();
}

COOK_API int k4_user_gather(const int* perm, const float* usage_r,
                            const uint8_t* queue_ok, const int* user_r,
                            float* vals, uint8_t* ufirst, int S, long long n,
                            void* stream) {
  user_gather<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      perm, usage_r, queue_ok, user_r, vals, ufirst, S, n);
  return cook::last_error();
}

COOK_API int k4_user_quota(const int* perm, const float* cum_s,
                           const float* run_base_r, const float* quota_r,
                           const uint8_t* queue_ok, uint8_t* quota_ok,
                           uint8_t* quota_ok_s, int S, long long n,
                           void* stream) {
  user_quota<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      perm, cum_s, run_base_r, quota_r, queue_ok, quota_ok, quota_ok_s, S, n);
  return cook::last_error();
}

COOK_API int k4_accept(const int* perm, const int* cnt_s,
                       const float* tokens_r, const uint8_t* quota_ok,
                       const uint8_t* bits_r, uint8_t* accepted, int S,
                       long long n, void* stream) {
  accept_k<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      perm, cnt_s, tokens_r, quota_ok, bits_r, accepted, S, n);
  return cook::last_error();
}

COOK_API int k4_match_valid(const uint8_t* accepted, const int* adm,
                            const int* num_considerable, uint8_t* mv, int S,
                            long long n, void* stream) {
  match_valid_k<<<grid_for(S * n), kThreads, 0, (cudaStream_t)stream>>>(
      accepted, adm, num_considerable, mv, S, n);
  return cook::last_error();
}

COOK_API int k4_compact(const int* order, const uint8_t* mv, const int* kk,
                        const uint8_t* queue_ok, const int* qp,
                        const float* job_res, const int* exc_id, int* sel,
                        int* queue_rows, int* n_queue, int* cand_row,
                        int* cand_qpos, float* res_c, uint8_t* valid_c,
                        uint8_t* gpu_c, int* eid_c, int S, long long n, int C,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long big = S * n > S * (long long)C ? S * n : S * (long long)C;
  compact_init<<<grid_for(big), kThreads, 0, st>>>(sel, queue_rows, S, n, C);
  compact_scatter<<<grid_for(S * n), kThreads, 0, st>>>(
      order, mv, kk, queue_ok, qp, sel, queue_rows, S, n, C);
  compact_slots<<<grid_for(S * (long long)C), kThreads, 0, st>>>(
      sel, order, qp, job_res, exc_id, n_queue, cand_row, cand_qpos, res_c,
      valid_c, gpu_c, eid_c, S, n, C);
  return cook::last_error();
}
