// K4 admit: the elementwise stages of the cycle between the scans and
// sorts: rank_body's over-quota limit and DRU (dru.py:85-103),
// considerable_body's admission tests (considerable.py:86-111),
// _compact_admitted (sharded.py:292) and _compact_outputs
// (sharded.py:355), as they run inside ops/pallas_cycle.py::_kernel.
//
// Each stage sits between two K2 scans, so it runs as the prologue
// (load: a gather, a mask) or the epilogue (store: the admission test,
// a scatter by perm) of the K2 launch beside it (scan_tile.cuh's stage
// functors; the k24_* entries of scan.cu).  Only k4_compact_slots
// (admit.cu), which needs every slot's sel, is a launch of its own.
// The arithmetic is the plain versions' (ops/admit.py): masks as float
// multiplies by 1 and 0, comparisons in f32, -fmad=false.
//
// Bound: bytes (every input read once, every output written once).
#pragma once

#include "common.cuh"

namespace {

constexpr uint8_t kPending = 1, kValid = 2, kEnqueueOk = 4, kLaunchOk = 8;
// bits of the rank-order byte built by the queue prologue
constexpr uint8_t kRLaunch = 1, kREnqueue = 2, kRRankable = 4;

__device__ __forceinline__ float bit_f(bool b) { return b ? 1.0f : 0.0f; }

// row r of an f32 [.., 4] array (16-byte aligned: the wrappers check)
__device__ __forceinline__ float4 row4(const float* p, long long r) {
  return __ldg((const float4*)p + r);
}
__device__ __forceinline__ void put4(float* p, long long r, float4 v) {
  ((float4*)p)[r] = v;
}
__device__ __forceinline__ void to4(float4 a, float* v) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// seg_scan(usage * valid, start); over = any(cum_all > quota) & valid
struct RankOver {
  using V = float;
  static constexpr int C = 4;
  const float* usage;
  const uint8_t* start;
  const uint8_t* flags;
  const float* quota;
  uint8_t* over;
  long long n;
  __device__ bool load(int s, long long t, float* v) const {
    const long long i = s * n + t;
    const float m = (flags[i] & kValid) == kValid ? 1.0f : 0.0f;
    to4(row4(usage, i), v);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = v[c] * m;
    return start[i] != 0;
  }
  __device__ void store(int s, long long t, const float* cum) const {
    const long long i = s * n + t;
    float q[4];
    to4(row4(quota, i), q);
    bool any = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) any |= cum[c] > q[c];
    over[i] = any && (flags[i] & kValid);
  }
};

// seg_count(over, start); keep = valid & over_cnt <= max_over;
// xk = usage * valid * keep
struct RankKeep {
  using V = int;
  static constexpr int C = 1;
  const uint8_t* over;
  const uint8_t* start;
  const float* usage;
  const uint8_t* flags;
  int max_over;
  uint8_t* keep;
  float* xk;
  long long n;
  __device__ bool load(int s, long long t, int* v) const {
    const long long i = s * n + t;
    v[0] = (over[i] & 1) != 0;
    return start[i] != 0;
  }
  __device__ void store(int s, long long t, const int* cnt) const {
    const long long i = s * n + t;
    const bool valid = flags[i] & kValid;
    const bool k = valid && cnt[0] <= max_over;
    keep[i] = k;
    float u[4];
    to4(row4(usage, i), u);
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] = (u[c] * bit_f(valid)) * bit_f(k);
    put4(xk, i, make_float4(u[0], u[1], u[2], u[3]));
  }
};

// seg_scan(xk, start); dru (NaN-propagating max of the cpu and mem
// shares, or the gpu share), rankable = keep & pending
struct RankDru {
  using V = float;
  static constexpr int C = 4;
  const float* xk;
  const uint8_t* start;
  const float* shares;
  const uint8_t* keep;
  const uint8_t* flags;
  int gpu_mode;
  float* dru;
  uint8_t* rankable;
  long long n;
  __device__ bool load(int s, long long t, float* v) const {
    const long long i = s * n + t;
    to4(row4(xk, i), v);
    return start[i] != 0;
  }
  __device__ void store(int s, long long t, const float* cum) const {
    const long long i = s * n + t;
    float d;
    if (gpu_mode) {
      d = cum[2] / shares[i * 3 + 2];
    } else {
      const float a = cum[1] / shares[i * 3 + 1];
      const float b = cum[0] / shares[i * 3 + 0];
      // jnp.maximum propagates NaN (fmaxf would drop it)
      d = (a != a || b != b) ? __int_as_float(0x7FC00000) : (a > b ? a : b);
    }
    dru[i] = d;
    rankable[i] = keep[i] && (flags[i] & kPending);
  }
};

// Prologue: the admission inputs gathered into rank order (the running
// base is each row's segment total cum_run[seg_last]); the scan value is
// pend_usage = usage_r * rankable_r.  prefix16 gives cum_pool; epilogue:
// queue_ok = rankable & within the pool and group caps & enqueue_ok.
struct Queue {
  static constexpr int C = 4;
  const int* order;
  const float* usage;
  const float* quota;
  const int* user_rank;
  const float* cum_run;
  const int* seg_last;
  const float* tokens;
  const uint8_t* flags;
  const uint8_t* rankable;
  const float* pool_base;
  const float* pool_quota;
  const float* group_base;
  const float* group_quota;
  float* usage_r;
  float* quota_r;
  int* user_r;
  float* run_base_r;
  float* tokens_r;
  uint8_t* bits_r;   // written by load, read back by store (same thread)
  uint8_t* queue_ok;
  long long n;
  __device__ void load(int s, long long t, float* v) const {
    // every read first (three dependent levels: order, seg_last, rows),
    // then the writes
    const long long i = s * n + t;
    const long long o = s * n + __ldg(&order[i]);
    const long long l = s * n + __ldg(&seg_last[o]);
    const bool rk = __ldg(&rankable[o]);
    const float4 u = row4(usage, o), q = row4(quota, o), rb = row4(cum_run, l);
    const int ur = __ldg(&user_rank[o]);
    const float tk = __ldg(&tokens[o]);
    const uint8_t f = __ldg(&flags[o]);
    put4(usage_r, i, u);
    put4(quota_r, i, q);
    put4(run_base_r, i, rb);
    to4(u, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = v[c] * bit_f(rk);
    user_r[i] = ur;
    tokens_r[i] = tk;
    bits_r[i] = ((f & kLaunchOk) ? kRLaunch : 0) |
                ((f & kEnqueueOk) ? kREnqueue : 0) | (rk ? kRRankable : 0);
  }
  __device__ void store(int s, long long t, const float* cum) const {
    const long long i = s * n + t;
    bool pq = true, gq = true;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pq &= cum[c] + pool_base[s * 4 + c] <= pool_quota[s * 4 + c];
      gq &= cum[c] + group_base[s * 4 + c] <= group_quota[s * 4 + c];
    }
    const uint8_t b = bits_r[i];
    queue_ok[i] = (b & kRRankable) && pq && gq && (b & kREnqueue);
  }
};

// Prologue: user-major values usage_r * queue_ok and segment starts
// (ufirst, also stored); seg_scan gives cum_s; epilogue: quota_ok =
// queue_ok & cum_s + run_base <= quota, scattered to rank order by perm
// and kept in user-major order.
struct UserQuota {
  using V = float;
  static constexpr int C = 4;
  const int* perm;
  const float* usage_r;
  const uint8_t* queue_ok;
  const int* user_r;
  const float* run_base_r;
  const float* quota_r;
  uint8_t* ufirst;
  uint8_t* quota_ok;
  uint8_t* quota_ok_s;
  long long n;
  __device__ bool load(int s, long long t, float* v) const {
    const long long j = s * n + t;
    const long long r = s * n + __ldg(&perm[j]);
    const long long rp = t == 0 ? r : s * n + __ldg(&perm[j - 1]);
    const float inc = bit_f(__ldg(&queue_ok[r]));
    to4(row4(usage_r, r), v);
    const bool f = t == 0 || __ldg(&user_r[r]) != __ldg(&user_r[rp]);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = v[c] * inc;
    ufirst[j] = f;
    return f;
  }
  __device__ void store(int s, long long t, const float* cum) const {
    const long long j = s * n + t;
    const long long r = s * n + __ldg(&perm[j]);
    float rb[4], q4[4];
    to4(row4(run_base_r, r), rb);
    to4(row4(quota_r, r), q4);
    bool q = __ldg(&queue_ok[r]);
#pragma unroll
    for (int c = 0; c < 4; ++c) q &= cum[c] + rb[c] <= q4[c];
    quota_ok[r] = q;
    quota_ok_s[j] = q;
  }
};

// seg_count(quota_ok_s, ufirst) gives cnt_s; epilogue: accepted =
// quota_ok & count <= floor(tokens) & launch_ok, scattered by perm.
struct Accept {
  using V = int;
  static constexpr int C = 1;
  const uint8_t* quota_ok_s;
  const uint8_t* ufirst;
  const int* perm;
  const float* tokens_r;
  const uint8_t* quota_ok;
  const uint8_t* bits_r;
  uint8_t* accepted;
  long long n;
  __device__ bool load(int s, long long t, int* v) const {
    const long long j = s * n + t;
    v[0] = (quota_ok_s[j] & 1) != 0;
    return ufirst[j] != 0;
  }
  __device__ void store(int s, long long t, const int* cnt) const {
    const long long r = s * n + perm[s * n + t];
    accepted[r] = quota_ok[r] && (float)cnt[0] <= floorf(tokens_r[r]) &&
                  (bits_r[r] & kRLaunch);
  }
};

// adm = int_scan(accepted); mv = accepted & adm <= num_considerable
// (the head-of-queue cap on the admitted prefix)
struct MatchValid {
  static constexpr int C = 1;
  int op;
  const uint8_t* accepted;
  const int* num_considerable;
  uint8_t* mv;
  long long n;
  __device__ void load(int s, long long t, int* v) const {
    v[0] = (accepted[s * n + t] & 1) != 0;
  }
  __device__ void store(int s, long long t, const int* adm) const {
    const long long i = s * n + t;
    mv[i] = accepted[i] && adm[0] <= num_considerable[s];
  }
};

// kk, qp = int_scan(mv), int_scan(queue_ok); epilogue: the admitted
// rows to their slots (sel) and the queue as a rank-ordered row list.
// sel is written only below min(kk[n - 1], slots) and queue_rows only
// below qp[n - 1]; k4_compact_slots fills the rest of queue_rows.
struct CompactScan {
  static constexpr int C = 2;
  int op;
  const uint8_t* mv;
  const uint8_t* queue_ok;
  const int* order;
  int slots;
  int* kk;
  int* qp;
  int* sel;
  int* queue_rows;
  long long n;
  __device__ void load(int s, long long t, int* v) const {
    const long long i = s * n + t;
    v[0] = (mv[i] & 1) != 0;
    v[1] = (queue_ok[i] & 1) != 0;
  }
  __device__ void store(int s, long long t, const int* v) const {
    const long long i = s * n + t;
    kk[i] = v[0];
    qp[i] = v[1];
    const int k = v[0] - 1;
    if (mv[i] && k < slots) sel[(long long)s * slots + k] = (int)t;
    if (queue_ok[i]) queue_rows[s * n + v[1] - 1] = order[i];
  }
};

}  // namespace
