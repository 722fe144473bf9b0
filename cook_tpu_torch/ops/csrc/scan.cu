// K2 scan: the cycle's prefix sums, in the JAX package's XLA:CPU orders.
//
// Replaces the scans inside ops/pallas_cycle.py::_kernel (rank_body's
// segmented scans dru.py:89-95, _user_running_base sharded.py:283,
// per_user_prefix considerable.py:47, cum_pool considerable.py:89 and
// the integer prefixes sharded.py:305,361, considerable.py:109,
// scan.py:41).
//
// * Segmented tree scan, lax.associative_scan's order.  Level k holds,
//   for each aligned block [i*2^k, (i+1)*2^k) of the input, the combine
//   of its two halves; the inclusive prefix at t is the left fold of the
//   blocks of (t+1)'s binary decomposition, largest first.  That is the
//   odd/even recursion of associative_scan written without recursion:
//   one launch per level up, one launch down.
// * Blocked-16 scan, jnp.cumsum's order on XLA:CPU: a sequential sum in
//   each block of 16, the same scan of the block totals, and the
//   exclusive prefix of the totals added to each element.  Also used,
//   with integer add or min, for the integer prefixes (exact in any
//   order).
//
// Bound: bytes.  Each scan reads its input once and writes its output
// once; the levels add about one more pass, so at 3.35 TB/s a [4, 128Ki,
// 4] f32 scan is bound near 5 us.  The launches per level dominate at
// these sizes; fusing levels in shared memory is later work.
#include "common.cuh"

namespace {

using cook::gtid;
using cook::grid_for;
using cook::kThreads;

// ------------------------------------------------------------------ tree
// level arrays: level k (k >= 0) of series s starts at S * off(k) where
// off(k) = sum_{j<k} (n >> j); values carry C columns, flags one byte.
__host__ __device__ inline long long level_off(long long n, int k) {
  long long o = 0;
  for (int j = 0; j < k; ++j) o += n >> j;
  return o;
}

inline int top_level(long long n) {
  int k = 0;
  while ((n >> (k + 1)) >= 1) ++k;
  return k;
}

// level 0: x * mask (f32, C columns), flags = start != 0
__global__ void tree_load_f32(const float* __restrict__ x,
                              const uint8_t* __restrict__ start,
                              const uint8_t* __restrict__ mflags, int mon,
                              int moff, float* __restrict__ lv,
                              uint8_t* __restrict__ lf, int S, long long n,
                              int C) {
  long long idx = gtid();
  if (idx >= S * n) return;
  float m = 1.0f;
  if (mflags != nullptr) {
    uint8_t b = mflags[idx];
    m = ((b & mon) == mon && (b & moff) == 0) ? 1.0f : 0.0f;
  }
  for (int c = 0; c < C; ++c) {
    float v = x[idx * C + c];
    lv[idx * C + c] = (mflags != nullptr) ? v * m : v;
  }
  lf[idx] = start[idx] != 0;
}

// level 0: (x & bit) != 0 as an int count
__global__ void tree_load_bit(const uint8_t* __restrict__ x, int bit,
                              const uint8_t* __restrict__ start,
                              int* __restrict__ lv, uint8_t* __restrict__ lf,
                              int S, long long n) {
  long long idx = gtid();
  if (idx >= S * n) return;
  lv[idx] = (x[idx] & bit) != 0;
  lf[idx] = start[idx] != 0;
}

template <typename V>
__global__ void tree_up(V* __restrict__ lv, uint8_t* __restrict__ lf,
                        int S, long long n, int C, int k) {
  long long nk = n >> k, np = n >> (k - 1);
  long long idx = gtid();
  if (idx >= S * nk) return;
  long long s = idx / nk, i = idx % nk;
  long long pbase = S * level_off(n, k - 1) + s * np;
  long long cbase = S * level_off(n, k) + s * nk;
  long long a = pbase + 2 * i, b = a + 1;
  uint8_t af = lf[a], bf = lf[b];
  for (int c = 0; c < C; ++c) {
    V av = lv[a * C + c], bv = lv[b * C + c];
    lv[(cbase + i) * C + c] = bf ? bv : av + bv;
  }
  lf[cbase + i] = af | bf;
}

template <typename V>
__global__ void tree_down(const V* __restrict__ lv,
                          const uint8_t* __restrict__ lf, V* __restrict__ out,
                          int S, long long n, int C, int K) {
  long long idx = gtid();
  if (idx >= S * n) return;
  long long s = idx / n, t = idx % n;
  long long m = t + 1;
  V acc[4];
  bool first = true;
  for (int k = K; k >= 0; --k) {
    if (!((m >> k) & 1)) continue;
    long long nk = n >> k;
    long long e = S * level_off(n, k) + s * nk + ((m >> k) - 1);
    uint8_t bf = lf[e];
    for (int c = 0; c < C; ++c) {
      V bv = lv[e * C + c];
      acc[c] = (first || bf) ? bv : acc[c] + bv;
    }
    first = false;
  }
  for (int c = 0; c < C; ++c) out[idx * C + c] = acc[c];
}

template <typename V>
void tree_scan(V* lv, uint8_t* lf, V* out, int S, long long n, int C,
               cudaStream_t st) {
  int K = top_level(n);
  for (int k = 1; k <= K; ++k)
    tree_up<V><<<grid_for(S * (n >> k)), kThreads, 0, st>>>(lv, lf, S, n, C,
                                                           k);
  tree_down<V><<<grid_for(S * n), kThreads, 0, st>>>(lv, lf, out, S, n, C, K);
}

// -------------------------------------------------------------- blocked-16
struct Add {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a + b; }
};
struct Min {
  template <typename V>
  __device__ V operator()(V a, V b) const { return b < a ? b : a; }
};

// level k of size nk: local sequential scan of each block of 16 in place,
// block total written to the next level (size ceil(nk / 16))
template <typename V, typename Op>
__global__ void blk_up(V* __restrict__ cur, V* __restrict__ nxt, int S,
                       long long nk, int C) {
  long long nb = (nk + 15) / 16;
  long long idx = gtid();
  if (idx >= S * nb * C) return;
  int c = (int)(idx % C);
  long long sb = idx / C, s = sb / nb, b = sb % nb;
  long long lo = b * 16, hi = lo + 16 < nk ? lo + 16 : nk;
  Op op;
  V acc = cur[(s * nk + lo) * C + c];
  for (long long t = lo + 1; t < hi; ++t) {
    acc = op(acc, cur[(s * nk + t) * C + c]);
    cur[(s * nk + t) * C + c] = acc;
  }
  if (nxt != nullptr) nxt[(s * nb + b) * C + c] = acc;
}

// out[t] = op(scanned totals[b - 1], local[t]) for blocks b >= 1
template <typename V, typename Op>
__global__ void blk_down(V* __restrict__ cur, const V* __restrict__ nxt,
                         int S, long long nk, int C) {
  long long nb = (nk + 15) / 16;
  long long idx = gtid();
  if (idx >= S * nk * C) return;
  int c = (int)(idx % C);
  long long st = idx / C, s = st / nk, t = st % nk;
  long long b = t / 16;
  if (b == 0) return;
  Op op;
  cur[idx] = op(nxt[(s * nb + b - 1) * C + c], cur[idx]);
}

// level 0 lives in `base` (already holding the input), upper levels in
// `scratch`
template <typename V, typename Op>
void blk_scan(V* base, V* scratch, int S, long long n, int C,
              cudaStream_t st) {
  const int kMaxLevels = 32;
  V* lvl[kMaxLevels];
  long long sz[kMaxLevels];
  int K = 0;
  lvl[0] = base;
  sz[0] = n;
  V* p = scratch;
  while (sz[K] > 16) {
    long long nb = (sz[K] + 15) / 16;
    lvl[K + 1] = p;
    sz[K + 1] = nb;
    p += S * nb * C;
    ++K;
  }
  for (int k = 0; k <= K; ++k)
    blk_up<V, Op><<<grid_for(S * ((sz[k] + 15) / 16) * C), kThreads, 0, st>>>(
        lvl[k], k < K ? lvl[k + 1] : nullptr, S, sz[k], C);
  for (int k = K - 1; k >= 0; --k)
    blk_down<V, Op><<<grid_for(S * sz[k] * C), kThreads, 0, st>>>(
        lvl[k], lvl[k + 1], S, sz[k], C);
}

__global__ void copy_f32(const float* __restrict__ x, float* __restrict__ y,
                         long long total) {
  long long idx = gtid();
  if (idx < total) y[idx] = x[idx];
}

// integer source: u8 bit test or i32, optionally read back to front
__global__ void int_load(const void* __restrict__ x, int x_u8, int bit,
                         int reverse, int* __restrict__ v, int S,
                         long long n) {
  long long idx = gtid();
  if (idx >= S * n) return;
  long long s = idx / n, t = idx % n;
  long long src = s * n + (reverse ? n - 1 - t : t);
  v[idx] = x_u8 ? ((((const uint8_t*)x)[src] & bit) != 0)
                : ((const int*)x)[src];
}

__global__ void int_store(const int* __restrict__ v, int reverse, int offset,
                          int* __restrict__ out, int S, long long n) {
  long long idx = gtid();
  if (idx >= S * n) return;
  long long s = idx / n, t = idx % n;
  out[s * n + (reverse ? n - 1 - t : t)] = v[idx] + offset;
}

}  // namespace

// Segmented inclusive scan of x * mask (f32, C <= 4 columns) in
// associative_scan's order.  mflags (optional): the row counts where
// (flags & mon) == mon and (flags & moff) == 0.  Scratch: lv f32 of
// S * level_off(n, top + 1) * C values, lf of S * level_off(n, top + 1)
// bytes.
COOK_API int k2_seg_f32(const float* x, const uint8_t* start,
                        const uint8_t* mflags, int mon, int moff, float* out,
                        float* lv, uint8_t* lf, int S, long long n, int C,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || C > 4) return (int)cudaErrorInvalidValue;
  tree_load_f32<<<grid_for(S * n), kThreads, 0, st>>>(x, start, mflags, mon,
                                                      moff, lv, lf, S, n, C);
  tree_scan<float>(lv, lf, out, S, n, C, st);
  return cook::last_error();
}

// Segmented inclusive count of the rows where (x & bit) != 0 (int32).
COOK_API int k2_seg_count(const uint8_t* x, int bit, const uint8_t* start,
                          int* out, int* lv, uint8_t* lf, int S, long long n,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  tree_load_bit<<<grid_for(S * n), kThreads, 0, st>>>(x, bit, start, lv, lf, S,
                                                      n);
  tree_scan<int>(lv, lf, out, S, n, 1, st);
  return cook::last_error();
}

// Inclusive prefix of x (f32, C columns) in jnp.cumsum's XLA:CPU order.
// Scratch: S * C * (n/16 + n/256 + ...) floats (blk_levels in Python).
COOK_API int k2_prefix16(const float* x, float* out, float* scratch, int S,
                         long long n, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  copy_f32<<<grid_for(S * n * C), kThreads, 0, st>>>(x, out, S * n * C);
  blk_scan<float, Add>(out, scratch, S, n, C, st);
  return cook::last_error();
}

// Integer inclusive scan (op 0: sum, 1: min) of a u8 bit test
// (x_u8 = 1) or an i32 array, front to back or back to front, plus
// `offset`.  Scratch: S * n ints for level 0, then the blocked levels.
COOK_API int k2_int_scan(const void* x, int x_u8, int bit, int op,
                         int reverse, int offset, int* out, int* scratch,
                         int S, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int_load<<<grid_for(S * n), kThreads, 0, st>>>(x, x_u8, bit, reverse,
                                                 scratch, S, n);
  if (op == 0)
    blk_scan<int, Add>(scratch, scratch + S * n, S, n, 1, st);
  else
    blk_scan<int, Min>(scratch, scratch + S * n, S, n, 1, st);
  int_store<<<grid_for(S * n), kThreads, 0, st>>>(scratch, reverse, offset,
                                                  out, S, n);
  return cook::last_error();
}
