// K2 scan: the cycle's prefix sums, in the JAX package's XLA:CPU orders,
// one tiled launch a scan (scan_tile.cuh) after one memset.
//
// Replaces the scans inside ops/pallas_cycle.py::_kernel (rank_body's
// segmented scans dru.py:89-95, _user_running_base sharded.py:283,
// per_user_prefix considerable.py:47, cum_pool considerable.py:89 and
// the integer prefixes sharded.py:305,361, considerable.py:109,
// scan.py:41).
//
// The plain entries below scan their input as it is.  The k24_* entries
// are the same launches with K4's elementwise stages (admit.cuh) as the
// scan's prologue and epilogue: the data is already in registers or
// shared memory there, so K4 costs no launch of its own except
// k4_compact_slots (admit.cu).
//
// Bound: bytes.  Each scan reads its input once and writes its output
// once (a [4, 128Ki, 4] f32 scan moves 16 MB: about 5 us at 3.35 TB/s);
// the launch reads a few published words per earlier tile besides.
#include "admit.cuh"
#include "scan_tile.cuh"

namespace {

// f32 x * mask (C columns), segments from start != 0
template <int C_>
struct SegF32 {
  using V = float;
  static constexpr int C = C_;
  const float* x;
  const uint8_t* start;
  const uint8_t* mflags;
  int mon, moff;
  float* out;
  long long n;
  __device__ bool load(int s, long long t, float* v) const {
    const long long i = s * n + t;
    if (mflags != nullptr) {
      const uint8_t b = mflags[i];
      const float m = ((b & mon) == mon && (b & moff) == 0) ? 1.0f : 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = x[i * C + c] * m;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = x[i * C + c];
    }
    return start[i] != 0;
  }
  __device__ void store(int s, long long t, const float* v) const {
    const long long i = s * n + t;
#pragma unroll
    for (int c = 0; c < C; ++c) out[i * C + c] = v[c];
  }
};

// segmented count of (x & bit) != 0
struct SegCount {
  using V = int;
  static constexpr int C = 1;
  const uint8_t* x;
  int bit;
  const uint8_t* start;
  int* out;
  long long n;
  __device__ bool load(int s, long long t, int* v) const {
    const long long i = s * n + t;
    v[0] = (x[i] & bit) != 0;
    return start[i] != 0;
  }
  __device__ void store(int s, long long t, const int* v) const {
    out[s * n + t] = v[0];
  }
};

template <int C_>
struct Blk {
  static constexpr int C = C_;
  const float* x;
  float* out;
  long long n;
  __device__ void load(int s, long long t, float* v) const {
    const long long i = s * n + t;
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = x[i * C + c];
  }
  __device__ void store(int s, long long t, const float* v) const {
    const long long i = s * n + t;
#pragma unroll
    for (int c = 0; c < C; ++c) out[i * C + c] = v[c];
  }
};

// u8 bit test or i32, front to back or back to front, plus offset
struct IntScan {
  static constexpr int C = 1;
  int op;
  const void* x;
  int x_u8, bit, reverse, offset;
  int* out;
  long long n;
  __device__ long long at(int s, long long t) const {
    return s * n + (reverse ? n - 1 - t : t);
  }
  __device__ void load(int s, long long t, int* v) const {
    const long long i = at(s, t);
    v[0] = x_u8 ? ((((const uint8_t*)x)[i] & bit) != 0) : ((const int*)x)[i];
  }
  __device__ void store(int s, long long t, const int* v) const {
    out[at(s, t)] = v[0] + offset;
  }
};

TileGeo geo(int* ctl, int S, long long n, int threads, int tile, int tiles,
            long long value_off, long long zero_words, int smem) {
  return TileGeo{ctl, S, n, threads, tile, tiles, value_off, zero_words, smem};
}

}  // namespace

// The trailing geometry of every entry is scan_plan's (ops/scan.py):
// ctl, S, n, threads, tile, tiles, value_off, zero_words, smem.  An
// entry refuses a geometry this source was not compiled for.

// Segmented inclusive scan of x * mask (f32, C <= 4 columns) in
// associative_scan's order.  mflags (optional): the row counts where
// (flags & mon) == mon and (flags & moff) == 0.
COOK_API int k2_seg_f32(const float* x, const uint8_t* start,
                        const uint8_t* mflags, int mon, int moff, float* out,
                        int C, int* ctl, int S, long long n, int threads,
                        int tile, int tiles, long long value_off,
                        long long zero_words, int smem, void* stream) {
  if (C < 1 || C > 4) return (int)cudaErrorInvalidValue;
  const TileGeo g =
      geo(ctl, S, n, threads, tile, tiles, value_off, zero_words, smem);
  switch (C) {
#define COOK_CASE(K)                                                        \
  case K:                                                                   \
    return run_seg(SegF32<K>{x, start, mflags, mon, moff, out, n}, g,       \
                   (cudaStream_t)stream);
    COOK_CASE(1)
    COOK_CASE(2)
    COOK_CASE(3)
    COOK_CASE(4)
#undef COOK_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Segmented inclusive count of the rows where (x & bit) != 0 (int32).
COOK_API int k2_seg_count(const uint8_t* x, int bit, const uint8_t* start,
                          int* out, int* ctl, int S, long long n,
                          int threads, int tile, int tiles,
                          long long value_off, long long zero_words,
                          int smem, void* stream) {
  return run_seg(SegCount{x, bit, start, out, n},
                 geo(ctl, S, n, threads, tile, tiles, value_off, zero_words,
                     smem),
                 (cudaStream_t)stream);
}

// Inclusive prefix of x (f32, C <= 4 columns) in jnp.cumsum's XLA:CPU
// order.
COOK_API int k2_prefix16(const float* x, float* out, int C, int* ctl, int S,
                         long long n, int threads, int tile, int tiles,
                         long long value_off, long long zero_words, int smem,
                         void* stream) {
  const TileGeo g =
      geo(ctl, S, n, threads, tile, tiles, value_off, zero_words, smem);
  switch (C) {
#define COOK_CASE(K) \
  case K:            \
    return run_blk(Blk<K>{x, out, n}, g, (cudaStream_t)stream);
    COOK_CASE(1)
    COOK_CASE(2)
    COOK_CASE(3)
    COOK_CASE(4)
#undef COOK_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Integer inclusive scan (op 0: sum, 1: min) of a u8 bit test
// (x_u8 = 1) or an i32 array, front to back or back to front, plus
// `offset`.
COOK_API int k2_int_scan(const void* x, int x_u8, int bit, int op,
                         int reverse, int offset, int* out, int* ctl, int S,
                         long long n, int threads, int tile, int tiles,
                         long long value_off, long long zero_words, int smem,
                         void* stream) {
  if (op != 0 && op != 1) return (int)cudaErrorInvalidValue;
  return run_int(IntScan{op, x, x_u8, bit, reverse, offset, out, n},
                 geo(ctl, S, n, threads, tile, tiles, value_off, zero_words,
                     smem),
                 (cudaStream_t)stream);
}

// ------------------------------------------- K2 launches with K4 inside
// rank_body: cum_all = seg_scan(usage * valid); over (admit.cuh RankOver)
COOK_API int k24_rank_over(const float* usage, const uint8_t* start,
                           const uint8_t* flags, const float* quota,
                           uint8_t* over, int* ctl, int S, long long n,
                           int threads, int tile, int tiles,
                           long long value_off, long long zero_words,
                           int smem, void* stream) {
  return run_seg(RankOver{usage, start, flags, quota, over, n},
                 geo(ctl, S, n, threads, tile, tiles, value_off, zero_words,
                     smem),
                 (cudaStream_t)stream);
}

// over_cnt = seg_count(over); keep, xk
COOK_API int k24_rank_keep(const uint8_t* over, const uint8_t* start,
                           const float* usage, const uint8_t* flags,
                           int max_over, uint8_t* keep, float* xk, int* ctl,
                           int S, long long n, int threads, int tile,
                           int tiles, long long value_off,
                           long long zero_words, int smem, void* stream) {
  return run_seg(RankKeep{over, start, usage, flags, max_over, keep, xk, n},
                 geo(ctl, S, n, threads, tile, tiles, value_off, zero_words,
                     smem),
                 (cudaStream_t)stream);
}

// cum = seg_scan(xk); dru, rankable
COOK_API int k24_rank_dru(const float* xk, const uint8_t* start,
                          const float* shares, const uint8_t* keep,
                          const uint8_t* flags, int gpu_mode, float* dru,
                          uint8_t* rankable, int* ctl, int S, long long n,
                          int threads, int tile, int tiles,
                          long long value_off, long long zero_words, int smem,
                          void* stream) {
  return run_seg(
      RankDru{xk, start, shares, keep, flags, gpu_mode, dru, rankable, n},
      geo(ctl, S, n, threads, tile, tiles, value_off, zero_words, smem),
      (cudaStream_t)stream);
}

// the rank-order gather, cum_pool = prefix16(pend_usage), queue_ok
COOK_API int k24_queue(const int* order, const float* usage,
                       const float* quota, const int* user_rank,
                       const float* cum_run, const int* seg_last,
                       const float* tokens, const uint8_t* flags,
                       const uint8_t* rankable, const float* pool_base,
                       const float* pool_quota, const float* group_base,
                       const float* group_quota, float* usage_r,
                       float* quota_r, int* user_r, float* run_base_r,
                       float* tokens_r, uint8_t* bits_r, uint8_t* queue_ok,
                       int* ctl, int S, long long n, int threads, int tile,
                       int tiles, long long value_off, long long zero_words,
                       int smem, void* stream) {
  return run_blk(
      Queue{order, usage, quota, user_rank, cum_run, seg_last, tokens, flags,
            rankable, pool_base, pool_quota, group_base, group_quota,
            usage_r, quota_r, user_r, run_base_r, tokens_r, bits_r, queue_ok,
            n},
      geo(ctl, S, n, threads, tile, tiles, value_off, zero_words, smem),
      (cudaStream_t)stream);
}

// the user-major gather, cum_s = seg_scan(vals, ufirst), quota_ok
COOK_API int k24_user_quota(const int* perm, const float* usage_r,
                            const uint8_t* queue_ok, const int* user_r,
                            const float* run_base_r, const float* quota_r,
                            uint8_t* ufirst, uint8_t* quota_ok,
                            uint8_t* quota_ok_s, int* ctl, int S,
                            long long n, int threads, int tile, int tiles,
                            long long value_off, long long zero_words,
                            int smem, void* stream) {
  return run_seg(UserQuota{perm, usage_r, queue_ok, user_r, run_base_r,
                           quota_r, ufirst, quota_ok, quota_ok_s, n},
                 geo(ctl, S, n, threads, tile, tiles, value_off, zero_words,
                     smem),
                 (cudaStream_t)stream);
}

// cnt_s = seg_count(quota_ok_s, ufirst); accepted
COOK_API int k24_accept(const uint8_t* quota_ok_s, const uint8_t* ufirst,
                        const int* perm, const float* tokens_r,
                        const uint8_t* quota_ok, const uint8_t* bits_r,
                        uint8_t* accepted, int* ctl, int S, long long n,
                        int threads, int tile, int tiles,
                        long long value_off, long long zero_words, int smem,
                        void* stream) {
  return run_seg(
      Accept{quota_ok_s, ufirst, perm, tokens_r, quota_ok, bits_r, accepted,
             n},
      geo(ctl, S, n, threads, tile, tiles, value_off, zero_words, smem),
      (cudaStream_t)stream);
}

// adm = int_scan(accepted); mv
COOK_API int k24_match_valid(const uint8_t* accepted,
                             const int* num_considerable, uint8_t* mv,
                             int* ctl, int S, long long n, int threads,
                             int tile, int tiles, long long value_off,
                             long long zero_words, int smem, void* stream) {
  return run_int(MatchValid{0, accepted, num_considerable, mv, n},
                 geo(ctl, S, n, threads, tile, tiles, value_off, zero_words,
                     smem),
                 (cudaStream_t)stream);
}

// kk, qp = int_scan(mv), int_scan(queue_ok) as one two-column scan; the
// scatters of compact_scatter (sel, queue_rows)
COOK_API int k24_compact(const uint8_t* mv, const uint8_t* queue_ok,
                         const int* order, int slots, int* kk, int* qp,
                         int* sel, int* queue_rows, int* ctl, int S,
                         long long n, int threads, int tile, int tiles,
                         long long value_off, long long zero_words, int smem,
                         void* stream) {
  return run_int(
      CompactScan{0, mv, queue_ok, order, slots, kk, qp, sel, queue_rows, n},
      geo(ctl, S, n, threads, tile, tiles, value_off, zero_words, smem),
      (cudaStream_t)stream);
}
