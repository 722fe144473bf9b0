// K3 sort: stable LSD radix sort of the cycle's two lexsorts.
//
// Replaces the sorts inside ops/pallas_cycle.py::_kernel: the rank
// order jnp.lexsort((position, user_rank, sort_dru)) of dru.py:106 and
// the user-major jnp.lexsort((pos, user)) of considerable.py:54.
//
// The rank key is the 64-bit (float key of sort_dru) << ubits |
// (user_rank + 1), where ubits = bit_length(T) holds every user_rank + 1
// in [0, T]; stability supplies the position tie-break, so the key needs
// 32 + ubits bits (50 at T = 128Ki), not the 66 a packed position would
// need.  The float key is JAX's sort order: -0 is +0, every NaN is one
// positive NaN after +inf.
//
// One pass per 8-bit digit: a per-block digit histogram, an exclusive
// scan over (digit, block), and a stable scatter whose in-block ranks
// come from __match_any_sync peer masks.  Bound: bytes (each pass reads
// and writes 12 B per element).
#include "common.cuh"

namespace {

using cook::grid_for;
using cook::kThreads;

constexpr int kSortThreads = 1024;
constexpr int kDigits = 256;

__device__ __forceinline__ uint32_t float_key(float x) {
  if (x == 0.0f) x = 0.0f;
  uint32_t b = __float_as_uint(x);
  if (x != x) return 0xFFC00000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void build_rank_keys(const float* __restrict__ dru,
                                const uint8_t* __restrict__ rankable,
                                const int* __restrict__ user_rank, int ubits,
                                unsigned long long* __restrict__ keys,
                                int* __restrict__ vals, int S, long long n) {
  long long idx = cook::gtid();
  if (idx >= S * n) return;
  float d = rankable[idx] ? dru[idx] : __int_as_float(0x7F800000);
  unsigned long long k = ((unsigned long long)float_key(d) << ubits) |
                         (unsigned long long)(unsigned)(user_rank[idx] + 1);
  keys[idx] = k;
  vals[idx] = (int)(idx % n);
}

__global__ void build_int_keys(const int* __restrict__ key,
                               unsigned long long* __restrict__ keys,
                               int* __restrict__ vals, int S, long long n) {
  long long idx = cook::gtid();
  if (idx >= S * n) return;
  keys[idx] = (unsigned long long)(unsigned)(key[idx] + 1);
  vals[idx] = (int)(idx % n);
}

__device__ __forceinline__ int digit_of(const unsigned long long* keys,
                                        long long s, long long n, long long i,
                                        int shift) {
  return i < n ? (int)((keys[s * n + i] >> shift) & 0xFF) : kDigits;
}

// hist[(s * 256 + d) * nblk + blk]
__global__ void radix_hist(const unsigned long long* __restrict__ keys,
                           int* __restrict__ hist, long long n, int shift,
                           int nblk) {
  __shared__ int cnt[kDigits];
  int s = blockIdx.y, blk = blockIdx.x;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  long long i = (long long)blk * kSortThreads + threadIdx.x;
  int d = digit_of(keys, s, n, i, shift);
  if (d < kDigits) atomicAdd(&cnt[d], 1);
  __syncthreads();
  for (int e = threadIdx.x; e < kDigits; e += blockDim.x)
    hist[((long long)s * kDigits + e) * nblk + blk] = cnt[e];
}

// exclusive scan of one series' 256 * nblk counts, in place
__global__ void radix_offsets(int* __restrict__ hist, int nblk) {
  __shared__ int part[kSortThreads];
  int s = blockIdx.x;
  long long total = (long long)kDigits * nblk;
  int* h = hist + (long long)s * total;
  long long per = (total + kSortThreads - 1) / kSortThreads;
  long long lo = threadIdx.x * per;
  long long hi = lo + per < total ? lo + per : total;
  int sum = 0;
  for (long long e = lo; e < hi; ++e) sum += h[e];
  part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int j = 0; j < kSortThreads; ++j) {
      int c = part[j];
      part[j] = run;
      run += c;
    }
  }
  __syncthreads();
  int run = part[threadIdx.x];
  for (long long e = lo; e < hi; ++e) {
    int c = h[e];
    h[e] = run;
    run += c;
  }
}

__global__ void radix_scatter(const unsigned long long* __restrict__ kin,
                              const int* __restrict__ vin,
                              unsigned long long* __restrict__ kout,
                              int* __restrict__ vout,
                              const int* __restrict__ hist, long long n,
                              int shift, int nblk) {
  __shared__ int wcnt[kSortThreads / 32][kDigits];
  int s = blockIdx.y, blk = blockIdx.x;
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < (kSortThreads / 32) * kDigits;
       e += blockDim.x)
    (&wcnt[0][0])[e] = 0;
  __syncthreads();
  long long i = (long long)blk * kSortThreads + threadIdx.x;
  int d = digit_of(kin, s, n, i, shift);
  unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
  int leader = __ffs(peers) - 1;
  int below = __popc(peers & ((1u << lane) - 1u));
  if (lane == leader && d < kDigits) wcnt[warp][d] = __popc(peers);
  __syncthreads();
  if (threadIdx.x < kDigits) {
    int run = 0;
    for (int w = 0; w < kSortThreads / 32; ++w) {
      int c = wcnt[w][threadIdx.x];
      wcnt[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  if (d < kDigits) {
    long long dest = hist[((long long)s * kDigits + d) * nblk + blk] +
                     wcnt[warp][d] + below;
    kout[s * n + dest] = kin[s * n + i];
    vout[s * n + dest] = vin[s * n + i];
  }
}

__global__ void copy_i32(const int* __restrict__ x, int* __restrict__ y,
                         long long total) {
  long long idx = cook::gtid();
  if (idx < total) y[idx] = x[idx];
}

// keys/vals: two buffers each of S * n; hist: S * 256 * nblk ints
void radix_sort(unsigned long long* keys, int* vals, int* hist, int* out,
                int S, long long n, int bits, cudaStream_t st) {
  int nblk = (int)((n + kSortThreads - 1) / kSortThreads);
  dim3 grid(nblk, S);
  unsigned long long* ka = keys;
  unsigned long long* kb = keys + S * n;
  int* va = vals;
  int* vb = vals + S * n;
  for (int shift = 0; shift < bits; shift += 8) {
    radix_hist<<<grid, kSortThreads, 0, st>>>(ka, hist, n, shift, nblk);
    radix_offsets<<<S, kSortThreads, 0, st>>>(hist, nblk);
    radix_scatter<<<grid, kSortThreads, 0, st>>>(ka, va, kb, vb, hist, n,
                                                 shift, nblk);
    unsigned long long* tk = ka; ka = kb; kb = tk;
    int* tv = va; va = vb; vb = tv;
  }
  copy_i32<<<grid_for(S * n), kThreads, 0, st>>>(va, out, S * n);
}

}  // namespace

// order[s] = stable argsort of (sort_dru, user_rank) with sort_dru =
// dru where rankable else +inf.
COOK_API int k3_sort_rank(const float* dru, const uint8_t* rankable,
                          const int* user_rank, int ubits, int* order,
                          unsigned long long* keys, int* vals, int* hist,
                          int S, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  build_rank_keys<<<grid_for(S * n), kThreads, 0, st>>>(
      dru, rankable, user_rank, ubits, keys, vals, S, n);
  radix_sort(keys, vals, hist, order, S, n, 32 + ubits, st);
  return cook::last_error();
}

// perm[s] = stable argsort of user (values in [-1, 2^ubits - 1)).
COOK_API int k3_sort_user(const int* user, int ubits, int* perm,
                          unsigned long long* keys, int* vals, int* hist,
                          int S, long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  build_int_keys<<<grid_for(S * n), kThreads, 0, st>>>(user, keys, vals, S, n);
  radix_sort(keys, vals, hist, perm, S, n, ubits, st);
  return cook::last_error();
}
