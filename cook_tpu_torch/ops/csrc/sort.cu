// K3 sort: stable LSD radix sort of the cycle's two lexsorts, one
// launch per radix pass (Onesweep: Adinets & Merrill, 2022).
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
// A call is one cudaMemsetAsync of the control words, one upfront kernel
// and one kernel per 8-bit digit:
//  * radix_upfront reads the inputs once, builds each key in registers
//    and counts every pass's digits (warp-aggregated shared atomics, so
//    a skewed digit costs one atomic a warp, not one an element);
//  * radix_pass: each CTA takes a tile of kTile keys (16 a thread, loaded
//    coalesced) by an atomic ticket, ranks it stably in shared memory
//    (__match_any_sync peers, per-warp digit counters), publishes its
//    digit counts in a status word per (series, pass, tile, digit) (2-bit
//    flag, 30-bit count; release stores, acquire loads), finds its
//    exclusive prefix by decoupled look-back, adds the digit's global
//    base (a block scan of the upfront histogram), and writes through
//    shared memory in digit order, so consecutive threads write
//    consecutive addresses.  The first pass builds its keys from the raw
//    inputs; the last writes the permutation itself.
// A pass whose digit takes one value over a whole series moves nothing;
// every CTA reads that from the upfront histogram on the device and the
// pass is skipped for that series (buffers alternate over the passes
// that run).  When none runs, the last pass writes the identity.
//
// Bound: bytes (each pass reads and writes 12 B a key), but at 524,288
// keys a pass is about 6 MB, a few microseconds at 3.35 TB/s: the time
// is the latency of a pass and the number of launches.
#include "common.cuh"

namespace {

constexpr int kRadixBits = 8;
constexpr int kDigits = 1 << kRadixBits;
constexpr int kSortThreads = 256;  // one thread per digit
constexpr int kItems = 16;
constexpr int kTile = kSortThreads * kItems;
constexpr int kWarps = kSortThreads / 32;
constexpr int kMaxPasses = 8;  // 63 key bits at most
constexpr uint32_t kFlagA = 1u << 30;  // tile count published
constexpr uint32_t kFlagP = 2u << 30;  // inclusive prefix published
constexpr uint32_t kCount = kFlagA - 1u;
constexpr unsigned kFull = 0xFFFFFFFFu;

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t float_key(float x) {
  if (x == 0.0f) x = 0.0f;
  uint32_t b = __float_as_uint(x);
  if (x != x) return 0xFFC00000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The raw inputs a first pass builds its keys from.
struct KeySrc {
  const float* dru;
  const uint8_t* rankable;
  const int* user_rank;  // the user sort's key
  int rank;              // 1: rank key, 0: user key
  int ubits;
};

__device__ __forceinline__ u64 make_key(const KeySrc& k, long long idx) {
  u64 low = (u64)(unsigned)(k.user_rank[idx] + 1);
  if (!k.rank) return low;
  float d = k.rankable[idx] ? k.dru[idx] : __int_as_float(0x7F800000);
  return ((u64)float_key(d) << k.ubits) | low;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Exclusive scan of one int per thread over the block (kSortThreads).
__device__ __forceinline__ int block_exclusive(int v, int* warp_tot) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += warp_tot[w];
  __syncthreads();
  return base + x - v;
}

// hist[(s * passes + q) * kDigits + d]: digit d's count in pass q.
__global__ void __launch_bounds__(kSortThreads)
radix_upfront(KeySrc src, int* __restrict__ hist, long long n, int passes) {
  __shared__ int cnt[kMaxPasses * kDigits];
  int s = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < passes * kDigits; e += kSortThreads) cnt[e] = 0;
  __syncthreads();
  long long base = (long long)blockIdx.x * kTile;
  for (int i = 0; i < kItems; ++i) {
    long long j = base + (long long)i * kSortThreads + tid;
    bool ok = j < n;
    u64 key = ok ? make_key(src, s * n + j) : 0;
    for (int q = 0; q < passes; ++q) {
      int d = ok ? (int)((key >> (q * kRadixBits)) & (kDigits - 1)) : -1;
      unsigned peers = __match_any_sync(kFull, d);
      if (ok && lane == __ffs(peers) - 1)
        atomicAdd(&cnt[q * kDigits + d], __popc(peers));
    }
  }
  __syncthreads();
  for (int e = tid; e < passes * kDigits; e += kSortThreads) {
    int c = cnt[e];
    if (c) atomicAdd(&hist[(long long)s * passes * kDigits + e], c);
  }
}

// One radix pass over every series.  keys/vals: two buffers each of S * n
// (the passes that run alternate between them); ctl: the histogram, one
// tile ticket per (series, pass), and the status words.
__global__ void __launch_bounds__(kSortThreads)
radix_pass(KeySrc src, u64* __restrict__ keys, int* __restrict__ vals,
           int* __restrict__ out, const int* __restrict__ hist,
           int* __restrict__ tickets, uint32_t* __restrict__ status, int S,
           long long n, int q, int passes, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* skeys = (u64*)smem;                      // kTile
  int* svals = (int*)(skeys + kTile);           // kTile
  int* wcnt = svals + kTile;                    // kWarps * kDigits
  int* loc = wcnt + kWarps * kDigits;           // kDigits
  int* dst = loc + kDigits;                     // kDigits
  int* wtot = dst + kDigits;                    // kWarps
  __shared__ int tile_sh;
  int s = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* h = hist + (long long)s * passes * kDigits;

  // which passes move anything for this series: the same answer in
  // every CTA, from the upfront histogram (all loads issued first)
  int hv[kMaxPasses];
#pragma unroll
  for (int r = 0; r < kMaxPasses; ++r)
    hv[r] = r < passes ? h[r * kDigits + tid] : 0;
  unsigned runs = 0;
#pragma unroll
  for (int r = 0; r < kMaxPasses; ++r)
    if (r < passes && !__syncthreads_or(hv[r] == n)) runs |= 1u << r;
  if (!((runs >> q) & 1u)) {
    if (q == passes - 1 && runs == 0) {  // nothing moved: the identity
      for (long long j = (long long)blockIdx.x * kTile + tid;
           j < n && j < (long long)(blockIdx.x + 1) * kTile;
           j += kSortThreads)
        out[s * n + j] = (int)j;
    }
    return;
  }
  int k = __popc(runs & ((1u << q) - 1u));  // passes run before this one
  bool first = k == 0, last = (runs >> (q + 1)) == 0;
  const u64* kin = keys + (long long)((k - 1) & 1) * S * n + s * n;
  const int* vin = vals + (long long)((k - 1) & 1) * S * n + s * n;
  u64* kout = keys + (long long)(k & 1) * S * n + s * n;
  int* vout = last ? out + s * n : vals + (long long)(k & 1) * S * n + s * n;
  int shift = q * kRadixBits;

  if (tid == 0) tile_sh = atomicAdd(&tickets[s * passes + q], 1);
  for (int e = tid; e < kWarps * kDigits; e += kSortThreads) wcnt[e] = 0;
  __syncthreads();
  int tile = tile_sh;
  long long t0 = (long long)tile * kTile;
  int tn = (int)(n - t0 < kTile ? n - t0 : kTile);

  // load warp-striped: warp w holds tile elements [w*32*kItems, +32*kItems)
  u64 key[kItems];
  int val[kItems], dig[kItems], rnk[kItems];
  int wbase = warp * 32 * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int e = wbase + i * 32 + lane;
    bool ok = e < tn;
    if (first) {
      key[i] = ok ? make_key(src, s * n + t0 + e) : 0;
      val[i] = (int)(t0 + e);
    } else {
      key[i] = ok ? kin[t0 + e] : 0;
      val[i] = ok ? vin[t0 + e] : 0;
    }
    dig[i] = ok ? (int)((key[i] >> shift) & (kDigits - 1)) : kDigits;
  }
  // stable ranks inside the warp: items in order, lanes in order
  int* wc = wcnt + warp * kDigits;
  unsigned below_mask = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int d = dig[i];
    unsigned peers = __match_any_sync(kFull, d);
    int before = d < kDigits ? wc[d] : 0;
    rnk[i] = before + __popc(peers & below_mask);
    __syncwarp();
    if (d < kDigits && lane == __ffs(peers) - 1)
      wc[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread d: warp prefixes of digit d and the tile's count
  int d = tid;
  int count = 0;
  for (int w = 0; w < kWarps; ++w) {
    int c = wcnt[w * kDigits + d];
    wcnt[w * kDigits + d] = count;
    count += c;
  }
  // publish, then look back for the tiles before this one
  uint32_t* st = status + ((long long)(s * passes + q) * tiles) * kDigits;
  int excl = 0;
  if (tile == 0) {
    st_release(&st[d], kFlagP | (uint32_t)count);
  } else {
    st_release(&st[(long long)tile * kDigits + d], kFlagA | (uint32_t)count);
    for (int t = tile - 1; t >= 0;) {
      uint32_t v = ld_acquire(&st[(long long)t * kDigits + d]);
      if (!(v & (kFlagA | kFlagP))) continue;
      excl += (int)(v & kCount);
      if (v & kFlagP) break;
      --t;
    }
    st_release(&st[(long long)tile * kDigits + d],
               kFlagP | (uint32_t)(excl + count));
  }
  // the digit's global base: exclusive scan of this pass's histogram
  int own = 0;
#pragma unroll
  for (int r = 0; r < kMaxPasses; ++r)
    if (r == q) own = hv[r];
  int gbase = block_exclusive(own, wtot);
  int local = block_exclusive(count, wtot);
  loc[d] = local;
  dst[d] = gbase + excl - local;
  __syncthreads();
  // into shared memory in digit order
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    int dd = dig[i];
    if (dd < kDigits) {
      int pos = loc[dd] + wc[dd] + rnk[i];
      skeys[pos] = key[i];
      svals[pos] = val[i];
    }
  }
  __syncthreads();
  // out in digit order: consecutive threads, consecutive addresses
  for (int j = tid; j < tn; j += kSortThreads) {
    u64 kk = skeys[j];
    long long g = dst[(int)((kk >> shift) & (kDigits - 1))] + j;
    vout[g] = svals[j];
    if (!last) kout[g] = kk;
  }
}

// ctl: int32 words, hist at hist_off, tickets at ticket_off, status at
// status_off; zeroed here with one memset.
int radix_sort(const KeySrc& src, u64* keys, int* vals, int* ctl,
               long long ctl_words, long long hist_off, long long ticket_off,
               long long status_off, int* out, int S, long long n, int passes,
               int tiles, int smem, cudaStream_t st) {
  if (passes < 1 || passes > kMaxPasses) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(ctl, 0, (size_t)ctl_words * 4, st);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(tiles, S);
  int* hist = ctl + hist_off;
  radix_upfront<<<grid, kSortThreads, 0, st>>>(src, hist, n, passes);
  e = cudaFuncSetAttribute(radix_pass,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  for (int q = 0; q < passes; ++q)
    radix_pass<<<grid, kSortThreads, smem, st>>>(
        src, keys, vals, out, hist, ctl + ticket_off,
        (uint32_t*)(ctl + status_off), S, n, q, passes, tiles);
  return cook::last_error();
}

// The plan's geometry must be the one this source was compiled for.
bool plan_ok(int digit_bits, int threads, int tile, int tiles, long long n,
             int smem) {
  int need = kTile * 12 + (kWarps * kDigits + 2 * kDigits + kWarps) * 4;
  return digit_bits == kRadixBits && threads == kSortThreads &&
         tile == kTile && (long long)tiles * kTile >= n &&
         n < (1ll << 30) && smem >= need;
}

}  // namespace

// order[s] = stable argsort of (sort_dru, user_rank) with sort_dru =
// dru where rankable else +inf.
COOK_API int k3_sort_rank(const float* dru, const uint8_t* rankable,
                          const int* user_rank, int ubits, int* order,
                          unsigned long long* keys, int* vals, int* ctl,
                          int S, long long n, int digit_bits, int threads,
                          int tile, int passes, int tiles, long long ctl_words,
                          long long hist_off, long long ticket_off,
                          long long status_off, int smem, void* stream) {
  if (!plan_ok(digit_bits, threads, tile, tiles, n, smem))
    return (int)cudaErrorInvalidValue;
  KeySrc src{dru, rankable, user_rank, 1, ubits};
  return radix_sort(src, keys, vals, ctl, ctl_words, hist_off, ticket_off,
                    status_off, order, S, n, passes, tiles, smem,
                    (cudaStream_t)stream);
}

// perm[s] = stable argsort of user (values in [-1, 2^ubits - 1)).
COOK_API int k3_sort_user(const int* user, int ubits, int* perm,
                          unsigned long long* keys, int* vals, int* ctl,
                          int S, long long n, int digit_bits, int threads,
                          int tile, int passes, int tiles, long long ctl_words,
                          long long hist_off, long long ticket_off,
                          long long status_off, int smem, void* stream) {
  if (!plan_ok(digit_bits, threads, tile, tiles, n, smem))
    return (int)cudaErrorInvalidValue;
  KeySrc src{nullptr, nullptr, user, 0, ubits};
  return radix_sort(src, keys, vals, ctl, ctl_words, hist_off, ticket_off,
                    status_off, perm, S, n, passes, tiles, smem,
                    (cudaStream_t)stream);
}
