// K2's tiled scans: one launch a scan, after one memset of the control
// words (sm_90a).
//
// Each CTA takes an aligned tile of kTile = 2^kTileLog elements of one
// series by an atomic ticket (series-major), so a CTA only ever waits on
// tiles whose CTAs already run, at any S and n.  The tile's levels live
// in shared memory; the tile publishes what later tiles need (a release
// store of its status word after its values), then reads what it needs
// of the tiles before it (acquire loads), and folds.  No tile waits on
// another's prefix, only on its published values, so there is no serial
// chain across tiles.  Three orders, each a kernel template over a
// stage functor St that loads an element (the prologue: a gather, a
// mask, a bit test) and stores it (the epilogue: K4's admission tests,
// scatters):
//
// * seg_tile: the segmented tree scan of lax.associative_scan.  The
//   inclusive prefix at t is the left fold, largest first, of the
//   aligned dyadic blocks of t+1's binary decomposition (each block the
//   combine (bf ? bv : av + bv, af | bf) of its halves; only complete
//   blocks exist).  Levels 0..kTileLog of the tile are built in shared
//   memory; a full tile publishes its level-kTileLog entry; the blocks
//   above it that the tile's elements need are built, in tree order,
//   from the published entries of tiles 0..j-1 (and the tile's own for
//   its last element, whose t+1 is (j+1) * kTile).
// * blk_tile: jnp.cumsum's blocked-16 order on XLA:CPU.  A tile is 16^3
//   elements: levels 0-2 (sequential sums in blocks of 16) in shared
//   memory; out_k(i) = out_{k+1}(i/16 - 1) + local_k(i) where i/16 >= 1.
//   A tile publishes its total local2(15), local2(14) and local1(255):
//   the next tile's first blocks need them, and every later tile's
//   out_3 (the blocked scan of the tile totals) needs the totals.
// * int_tile: integer sum or min (exact in any order): a block scan of
//   the tile, the published tile totals of tiles 0..j-1 reduced.
//
// Bound: bytes (each input read once, each output written once); the
// levels never leave shared memory.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kTileLog = 12;
constexpr int kTile = 1 << kTileLog;           // 4,096 = 16^3
constexpr int kMaxTileLog = 10;
constexpr int kMaxTiles = 1 << kMaxTileLog;    // n <= 2^22 a series
constexpr int kLvn = 2 * kTile;                // tree levels 0..kTileLog
constexpr int kP0 = kTile + kTile / 16;        // blocked level 0, padded
constexpr int kP1 = kTile / 16 + kTile / 256;  // blocked level 1, padded
constexpr int kP2 = 16;                        // blocked level 2
constexpr int kItems = kTile / kScanThreads;   // elements a thread: 4
constexpr int kScanWarps = kScanThreads / 32;
constexpr unsigned kAll = 0xFFFFFFFFu;

// scan_plan's kinds; a tile publishes C values (kKindBlocked: 3 C)
constexpr int kKindSeg = 0, kKindBlocked = 1, kKindInt = 2;

// dynamic shared memory of one CTA, as the kernels below index it
inline int tile_smem(int kind, int C, int tiles) {
  if (kind == kKindSeg) return C * (kLvn + 2 * tiles) * 4 + kLvn + 2 * tiles;
  if (kind == kKindBlocked) return C * (kP0 + kP1 + kP2 + 2 * tiles) * 4;
  return 0;
}

__device__ __forceinline__ void release_u32(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t acquire_u32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Wait for tile i's status word; returns it (bit 0 set).
__device__ __forceinline__ uint32_t wait_tile(const uint32_t* st, int i) {
  uint32_t w;
  while (!((w = acquire_u32(&st[i])) & 1u)) __nanosleep(32);
  return w;
}

// -------------------------------------------------------- segmented tree
// offset of in-tile level k: sum_{i<k} kTile >> i
__device__ __forceinline__ int lvl_off(int k) {
  return 2 * (kTile - (kTile >> k));
}

// Left fold, largest block first, of the tile-tree blocks of mm (a count
// of tiles): tree level q holds m >> q entries from offset
// sum_{i<q} m >> i.  `first` stays true when mm is 0.
template <typename V, int C>
__device__ void tree_fold(const V* tt, const uint8_t* tf, int tw, int m,
                          int mm, V* out, bool* first) {
  bool f = true;
  V acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = V(0);
  for (int q = kMaxTileLog; q >= 0; --q) {
    if (!((mm >> q) & 1)) continue;
    int off = 0;
    for (int i = 0; i < q; ++i) off += m >> i;
    const int e = off + (mm >> q) - 1;
    const bool bf = tf[e];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const V bv = tt[c * tw + e];
      acc[c] = (f || bf) ? bv : acc[c] + bv;
    }
    f = false;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = acc[c];
  *first = f;
}

// St: V (float or int), C (1..4); bool load(s, t, V* v) gives the
// element's C values and its segment-start flag; store(s, t, const V*).
template <class St>
__global__ void __launch_bounds__(kScanThreads)
seg_tile(St st, int* __restrict__ ticket, uint32_t* __restrict__ status,
         typename St::V* __restrict__ tv, long long n, int tiles) {
  using V = typename St::V;
  constexpr int C = St::C;
  extern __shared__ __align__(16) unsigned char smem[];
  V* lv = (V*)smem;                               // [C][kLvn]
  V* tt = lv + C * kLvn;                          // [C][2 * tiles]
  uint8_t* lf = (uint8_t*)(tt + C * 2 * tiles);   // [kLvn]
  uint8_t* tf = lf + kLvn;                        // [2 * tiles]
  __shared__ V hx[C], hl[C];
  __shared__ int g_sh, hx_first;
  const int tid = threadIdx.x, tw = 2 * tiles;
  if (tid == 0) g_sh = atomicAdd(ticket, 1);
  __syncthreads();
  const int s = g_sh / tiles, j = g_sh % tiles;
  const long long t0 = (long long)j * kTile;
  const int tn = (int)(n - t0 < kTile ? n - t0 : kTile);
  const bool full = tn == kTile;

  {  // every load of the thread issued before the first is used
    V v[kItems][C];
    bool f[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int e = tid + r * kScanThreads;
      if (e < tn) f[r] = st.load(s, t0 + e, v[r]);
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int e = tid + r * kScanThreads;
      if (e >= tn) break;
      lf[e] = f[r];
#pragma unroll
      for (int c = 0; c < C; ++c) lv[c * kLvn + e] = v[r][c];
    }
  }
  __syncthreads();
  // up-sweep: level k entry i combines level k-1 entries 2i, 2i+1
  for (int k = 1; k <= kTileLog; ++k) {
    const int nk = tn >> k, po = lvl_off(k - 1), co = lvl_off(k);
    for (int i = tid; i < nk; i += kScanThreads) {
      const int a = po + 2 * i, b = a + 1;
      const uint8_t bf = lf[b];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const V av = lv[c * kLvn + a], bv = lv[c * kLvn + b];
        lv[c * kLvn + co + i] = bf ? bv : av + bv;
      }
      lf[co + i] = lf[a] | bf;
    }
    __syncthreads();
  }
  // publish the tile's level-kTileLog entry (only full tiles have one)
  const int top = lvl_off(kTileLog);
  uint32_t* sst = status + (long long)s * tiles;
  V* stv = tv + (long long)s * tiles * C;
  if (full && tid == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) stv[(long long)j * C + c] = lv[c * kLvn + top];
    release_u32(&sst[j], 1u | ((uint32_t)lf[top] << 1));
  }
  // the entries of tiles 0..j-1, and the tile's own when full
  for (int i = tid; i < j; i += kScanThreads) {
    const uint32_t w = wait_tile(sst, i);
#pragma unroll
    for (int c = 0; c < C; ++c)
      tt[c * tw + i] = __ldcg(&stv[(long long)i * C + c]);
    tf[i] = (uint8_t)(w >> 1);
  }
  if (full && tid == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) tt[c * tw + j] = lv[c * kLvn + top];
    tf[j] = lf[top];
  }
  __syncthreads();
  const int m = j + (full ? 1 : 0);
  // the tree over them, in the order of the levels above kTileLog
  for (int q = 1, off = 0; (m >> q) >= 1; ++q) {
    const int np = m >> (q - 1), nq = m >> q, co = off + np;
    for (int i = tid; i < nq; i += kScanThreads) {
      const int a = off + 2 * i, b = a + 1;
      const uint8_t bf = tf[b];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const V av = tt[c * tw + a], bv = tt[c * tw + b];
        tt[c * tw + co + i] = bf ? bv : av + bv;
      }
      tf[co + i] = tf[a] | bf;
    }
    off = co;
    __syncthreads();
  }
  if (tid == 0) {
    bool f;
    tree_fold<V, C>(tt, tf, tw, m, j, hx, &f);
    hx_first = f;
    if (full) tree_fold<V, C>(tt, tf, tw, m, j + 1, hl, &f);
  }
  __syncthreads();
  // each element: the blocks above the tile, then levels kTileLog-1..0
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int e = tid + r * kScanThreads;
    if (e >= tn) break;
    const int mm = e + 1;
    V acc[C];
    if (mm == kTile) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = hl[c];
    } else {
      bool first = hx_first;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = hx[c];
      for (int k = kTileLog - 1; k >= 0; --k) {
        if (!((mm >> k) & 1)) continue;
        const int i = lvl_off(k) + (mm >> k) - 1;
        const bool bf = lf[i];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const V bv = lv[c * kLvn + i];
          acc[c] = (first || bf) ? bv : acc[c] + bv;
        }
        first = false;
      }
    }
    st.store(s, t0 + e, acc);
  }
}

// ------------------------------------------------------------ blocked-16
__device__ __forceinline__ int pad16(int e) { return e + (e >> 4); }

// Sequential sum of a[16 * (i / 16) .. i] (a local scan at i).
__device__ __forceinline__ float local16(const float* a, int i) {
  const int b = i & ~15;
  float acc = a[b];
  for (int p = b + 1; p <= i; ++p) acc = acc + a[p];
  return acc;
}

// out(i) of jnp.cumsum's blocked-16 scan of a level of `len` entries at
// `a`, whose upper levels (the sums of complete blocks of 16) follow it:
// level q+1 of len_q / 16 entries right after level q.
__device__ float blocked_at(const float* a, int len, int i) {
  int idx[8], off[8];
  int K = 0;
  idx[0] = i;
  off[0] = 0;
  for (int ln = len; idx[K] >= 16; ln /= 16, ++K) {
    off[K + 1] = off[K] + ln;
    idx[K + 1] = idx[K] / 16 - 1;
  }
  float acc = local16(a + off[K], idx[K]);
  for (int k = K - 1; k >= 0; --k) acc = acc + local16(a + off[k], idx[k]);
  return acc;
}

// St: C (1..4); load(s, t, float* v); store(s, t, const float* v).
template <class St>
__global__ void __launch_bounds__(kScanThreads)
blk_tile(St st, int* __restrict__ ticket, uint32_t* __restrict__ status,
         float* __restrict__ tv, long long n, int tiles) {
  constexpr int C = St::C;
  extern __shared__ __align__(16) unsigned char smem[];
  float* x0 = (float*)smem;   // [C][kP0] level 0 (padded), local scans
  float* x1 = x0 + C * kP0;   // [C][kP1] level 1 (padded)
  float* x2 = x1 + C * kP1;   // [C][kP2] level 2
  float* tt = x2 + C * kP2;   // [C][2 * tiles] totals of tiles 0..j-1
  __shared__ float a1[C], a2[C], b3[C], prev14[C], prev255[C];
  __shared__ int g_sh;
  const int tid = threadIdx.x, tw = 2 * tiles;
  if (tid == 0) g_sh = atomicAdd(ticket, 1);
  __syncthreads();
  const int s = g_sh / tiles, j = g_sh % tiles;
  const long long t0 = (long long)j * kTile;
  const int tn = (int)(n - t0 < kTile ? n - t0 : kTile);
  const bool full = tn == kTile;

  {  // every load of the thread issued before the first is used
    float v[kItems][C];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int e = tid + r * kScanThreads;
      if (e < tn) st.load(s, t0 + e, v[r]);
    }
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int e = tid + r * kScanThreads;
      if (e >= tn) break;
#pragma unroll
      for (int c = 0; c < C; ++c) x0[c * kP0 + pad16(e)] = v[r][c];
    }
  }
  __syncthreads();
  // level 0: sequential scans of blocks of 16; totals to level 1
  const int nb0 = (tn + 15) / 16, nb1 = (nb0 + 15) / 16;
  for (int p = tid; p < nb0 * C; p += kScanThreads) {
    const int c = p / nb0, b = p % nb0;
    float* x = x0 + c * kP0;
    const int lo = b * 16, hi = lo + 16 < tn ? lo + 16 : tn;
    float acc = x[pad16(lo)];
    for (int e = lo + 1; e < hi; ++e) {
      acc = acc + x[pad16(e)];
      x[pad16(e)] = acc;
    }
    x1[c * kP1 + pad16(b)] = acc;
  }
  __syncthreads();
  for (int p = tid; p < nb1 * C; p += kScanThreads) {
    const int c = p / nb1, b = p % nb1;
    float* x = x1 + c * kP1;
    const int lo = b * 16, hi = lo + 16 < nb0 ? lo + 16 : nb0;
    float acc = x[pad16(lo)];
    for (int e = lo + 1; e < hi; ++e) {
      acc = acc + x[pad16(e)];
      x[pad16(e)] = acc;
    }
    x2[c * kP2 + b] = acc;
  }
  __syncthreads();
  if (tid < C) {
    float* x = x2 + tid * kP2;
    float acc = x[0];
    for (int e = 1; e < nb1; ++e) {
      acc = acc + x[e];
      x[e] = acc;
    }
  }
  __syncthreads();
  uint32_t* sst = status + (long long)s * tiles;
  float* stv = tv + (long long)s * tiles * 3 * C;
  if (full && tid == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float* o = stv + ((long long)j * C + c) * 3;
      o[0] = x2[c * kP2 + 15];
      o[1] = x2[c * kP2 + 14];
      o[2] = x1[c * kP1 + pad16(255)];
    }
    release_u32(&sst[j], 1u);
  }
  for (int i = tid; i < j; i += kScanThreads) {
    wait_tile(sst, i);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* o = stv + ((long long)i * C + c) * 3;
      tt[c * tw + i] = __ldcg(&o[0]);
      if (i == j - 1) {
        prev14[c] = __ldcg(&o[1]);
        prev255[c] = __ldcg(&o[2]);
      }
    }
  }
  __syncthreads();
  // the sums of complete blocks of 16 totals, level over level
  for (int len = j, off = 0; len >= 16; off += len, len /= 16) {
    const int nq = len / 16;
    for (int p = tid; p < nq * C; p += kScanThreads) {
      const int c = p / nq, b = p % nq;
      const float* a = tt + c * tw + off + b * 16;
      float acc = a[0];
      for (int e = 1; e < 16; ++e) acc = acc + a[e];
      tt[c * tw + off + len + b] = acc;
    }
    __syncthreads();
  }
  if (tid < C && j >= 1) {
    const int c = tid;
    const float* a = tt + c * tw;
    // out_3 at j-1 and j-2; out_2 at 16j-1 and 16j-2; out_1 at 256j-1
    b3[c] = blocked_at(a, j, j - 1);
    const float tot = a[j - 1];
    const float o3 = j >= 2 ? blocked_at(a, j, j - 2) : 0.0f;
    a2[c] = j >= 2 ? o3 + tot : tot;
    const float o2 = j >= 2 ? o3 + prev14[c] : prev14[c];
    a1[c] = o2 + prev255[c];
  }
  __syncthreads();
  // down, level by level: out = out_{k+1}(b - 1) + local where b >= 1
  if (j >= 1) {
    for (int p = tid; p < nb1 * C; p += kScanThreads) {
      const int c = p / nb1, q = p % nb1;
      x2[c * kP2 + q] = b3[c] + x2[c * kP2 + q];
    }
  }
  __syncthreads();
  for (int p = tid; p < nb0 * C; p += kScanThreads) {
    const int c = p / nb0, r = p % nb0, q = r >> 4;
    if (q >= 1)
      x1[c * kP1 + pad16(r)] = x2[c * kP2 + q - 1] + x1[c * kP1 + pad16(r)];
    else if (j >= 1)
      x1[c * kP1 + pad16(r)] = a2[c] + x1[c * kP1 + pad16(r)];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int e = tid + r * kScanThreads;
    if (e >= tn) break;
    const int b = e >> 4;
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float loc = x0[c * kP0 + pad16(e)];
      v[c] = b >= 1 ? x1[c * kP1 + pad16(b - 1)] + loc
                    : (j >= 1 ? a1[c] + loc : loc);
    }
    st.store(s, t0 + e, v);
  }
}

// --------------------------------------------------------------- integer
__device__ __forceinline__ int int_op(int op, int a, int b) {
  return op ? (b < a ? b : a) : a + b;
}

// St: C (1..2), op (0 sum, 1 min); load(s, t, int* v); store(s, t,
// const int* v).  Element e of the tile is item e % kItems of thread
// e / kItems.  (seg_tile and blk_tile give element e to thread
// e % kScanThreads; a stage's load and store of an element run on one
// thread in all three.)
template <class St>
__global__ void __launch_bounds__(kScanThreads)
int_tile(St st, int* __restrict__ ticket, uint32_t* __restrict__ status,
         int* __restrict__ tv, long long n, int tiles) {
  constexpr int C = St::C;
  __shared__ int wsum[C][kScanWarps];
  __shared__ int pre[C], g_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int op = st.op, id = op ? INT_MAX : 0;
  if (tid == 0) g_sh = atomicAdd(ticket, 1);
  __syncthreads();
  const int s = g_sh / tiles, j = g_sh % tiles;
  const long long t0 = (long long)j * kTile;
  const int tn = (int)(n - t0 < kTile ? n - t0 : kTile);

  int v[kItems][C];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = tid * kItems + i;
    if (e < tn) {
      st.load(s, t0 + e, v[i]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[i][c] = id;
    }
  }
  int excl[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 1; i < kItems; ++i) v[i][c] = int_op(op, v[i - 1][c], v[i][c]);
    int x = v[kItems - 1][c];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kAll, x, off);
      if (lane >= off) x = int_op(op, y, x);
    }
    const int y = __shfl_up_sync(kAll, x, 1);
    excl[c] = lane ? y : id;
    if (lane == 31) wsum[c][warp] = x;
  }
  __syncthreads();
  uint32_t* sst = status + (long long)s * tiles;
  int* stv = tv + (long long)s * tiles * C;
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      int t = id;
      for (int w = 0; w < kScanWarps; ++w) t = int_op(op, t, wsum[c][w]);
      stv[(long long)j * C + c] = t;
    }
    release_u32(&sst[j], 1u);
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    for (int w = 0; w < warp; ++w) excl[c] = int_op(op, wsum[c][w], excl[c]);
  // the totals of tiles 0..j-1, reduced over the block
  int p[C];
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = id;
  for (int i = tid; i < j; i += kScanThreads) {
    wait_tile(sst, i);
#pragma unroll
    for (int c = 0; c < C; ++c)
      p[c] = int_op(op, p[c], __ldcg(&stv[(long long)i * C + c]));
  }
  __syncthreads();   // wsum is read above before it is reused
#pragma unroll
  for (int c = 0; c < C; ++c) {
    for (int off = 16; off >= 1; off >>= 1)
      p[c] = int_op(op, p[c], __shfl_down_sync(kAll, p[c], off));
    if (lane == 0) wsum[c][warp] = p[c];
  }
  __syncthreads();
  if (tid < C) {
    int t = id;
    for (int w = 0; w < kScanWarps; ++w) t = int_op(op, t, wsum[tid][w]);
    pre[tid] = t;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = tid * kItems + i;
    if (e >= tn) break;
    int r[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      r[c] = int_op(op, pre[c], int_op(op, excl[c], v[i][c]));
    st.store(s, t0 + e, r);
  }
}

// ------------------------------------------------------------------ host
// The geometry scan_plan gave (ops/scan.py): ctl holds the ticket (word
// 0), one status word per (series, tile) from word 1, zeroed by the one
// memset of zero_words, then the published values from value_off.
struct TileGeo {
  int* ctl;
  int S;
  long long n;
  int threads, tile, tiles;
  long long value_off, zero_words;
  int smem;
};

inline bool geo_ok(const TileGeo& g, int kind, int C) {
  const long long tiles = (g.n + kTile - 1) / kTile;
  const long long words = 1 + (long long)g.S * g.tiles;
  return g.n >= 1 && g.S >= 1 && g.threads == kScanThreads &&
         g.tile == kTile && g.tiles == tiles && g.tiles <= kMaxTiles &&
         g.zero_words == words && g.value_off >= words &&
         g.smem == tile_smem(kind, C, g.tiles) && C >= 1 &&
         C <= (kind == kKindInt ? 2 : 4);
}

// One memset of the control words, one launch of S * tiles CTAs.
template <class Kern, class St, typename T>
int launch_tiled(Kern kern, const St& st, const TileGeo& g, int kind, int C,
                 cudaStream_t stream) {
  if (!geo_ok(g, kind, C)) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaMemsetAsync(g.ctl, 0, (size_t)g.zero_words * 4, stream);
  if (e != cudaSuccess) return (int)e;
  if (g.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<g.S * g.tiles, kScanThreads, g.smem, stream>>>(
      st, g.ctl, (uint32_t*)(g.ctl + 1), (T*)(g.ctl + g.value_off), g.n,
      g.tiles);
  return cook::last_error();
}

template <class St>
int run_seg(const St& st, const TileGeo& g, cudaStream_t stream) {
  return launch_tiled<decltype(&seg_tile<St>), St, typename St::V>(
      seg_tile<St>, st, g, kKindSeg, St::C, stream);
}

template <class St>
int run_blk(const St& st, const TileGeo& g, cudaStream_t stream) {
  return launch_tiled<decltype(&blk_tile<St>), St, float>(
      blk_tile<St>, st, g, kKindBlocked, St::C, stream);
}

template <class St>
int run_int(const St& st, const TileGeo& g, cudaStream_t stream) {
  return launch_tiled<decltype(&int_tile<St>), St, int>(
      int_tile<St>, st, g, kKindInt, St::C, stream);
}

}  // namespace
