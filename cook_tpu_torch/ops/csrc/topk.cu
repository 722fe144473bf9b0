// Top-K host preferences per job: the port of the two Pallas kernels of
// ops/pallas_match.py, _kernel :116 (dense mask) and _structured_kernel
// :162 (mask composed from host vectors and exception rows), which share
// the running merge _merge_running_topk :78.
//
// Each thread keeps, for each of its jobs, the best K (8 or 16) entries
// of (fit, host) in registers, sorted best first, and walks the hosts in
// increasing order.  A candidate enters only when it is strictly greater
// than the K-th entry and is placed after every entry it ties with, so
// ties stay at the lowest host index, as lax.top_k breaks them.  A job
// with a feasible NaN fitness gets a row of that NaN and host 0, as the
// Pallas merge's running max leaves it.
//
// Bound: operations (every (job, host) pair), and for the dense form the
// [J, H] mask's bytes.  The design spends as little as it can a pair:
//
// * Host terms once a host.  A block stages a tile of hosts in shared
//   memory and computes there, once a host, what every pair would
//   repeat: u = cap - avail and m = max(cap, 1e-9) of cpu and mem, the
//   refined reciprocal of m (divide.cuh), and the pre-filter's terms.
// * A conservative pre-filter.  For a job (demand n) and a host, with
//   ha = RN(1 / m) / 2 (__frcp_rn, which numpy reproduces) and
//   hh = RN(u0 ha0 + RN(u1 ha1 + M)),
//       est = RN(n0 ha0 + RN(n1 ha1 + hh))
//   is two FMAs a pair.  The margin M = 2^-16 ((|u0| + N0) ha0 + (|u1| +
//   N1) ha1) + 2^-120 (N the largest |n| of the block's jobs) makes est
//   >= fit wherever both are defined: with every |u|, |n| < 2^40 and m in
//   [2^-40, 2^40) nothing overflows, the exact fit is within 2^-22 W +
//   2^-148 of V = (u0 + n0) / 2m0 + (u1 + n1) / 2m1 (W = the same with
//   |u| and |n|: two roundings in each quotient, one in the sum, one in
//   the halving when subnormal), est's six roundings and the reciprocal's
//   put it within 2^-21.6 W of V + M, and M >= 2^-16.01 W + 2^-120.01.
//   So est - fit >= 2^-16.1 W - 2^-20.6 W + 2^-121 - 2^-148 > 0.  A host
//   outside that range gets hh = NaN, a job outside it n = NaN for the
//   pre-filter, and a NaN est never skips.  Since est >= fit, a pair
//   whose est is at most the K-th entry cannot enter and is skipped;
//   every other pair takes the exact path: the mask, the resource fit,
//   the fitness in the Pallas kernel's order (fit = 0; fit += q0; fit +=
//   q1; fit * 0.5) with each quotient by div_by_recip where div_safe
//   holds and `/` elsewhere, and the strict insertion.
//   tests/test_torch_topk_design.py holds a numpy model of the rule to
//   est >= fit on adversarial worlds.
// * The mask from shared memory.  A thread reads its job's mask 16 hosts
//   at a time (a uint4) from a row in shared memory: the dense form
//   stages the block's [jobs x tile] u8 mask with 16-byte cp.async
//   copies, double-buffered (the next tile's copies in flight while this
//   one is scanned); the structured form keeps two class rows (cpu jobs:
//   not gpu, not blocked; gpu jobs: gpu, not blocked) that all its jobs
//   read, and stages the exception rows its jobs name, kExcSlots rows a
//   round.  Rows are kRowPad bytes apart beyond the tile, so that the 8
//   threads of a quarter warp read 8 rows without a bank conflict.
// * A chunk's 16 pre-filter tests run without a branch into a mask of
//   candidate bits, then taken lowest host first, so the rare exact path
//   is one copy of its code.
//
// One job a thread (two were measured slower: more registers, fewer
// blocks an SM).
//
// When the jobs alone give too few blocks to fill the card, blockIdx.y
// splits the hosts into S ranges of whole tiles; each writes a partial
// list and a second kernel merges the S lists in host order with the
// same strict rule.  Geometry: ops/pallas_match.py's plan constants; the
// entries refuse any other.
#include "common.cuh"
#include "divide.cuh"

namespace {

constexpr int kStructThreads = 256;   // threads a scan block, structured
constexpr int kDenseThreads = 128;    // threads a scan block, dense
constexpr int kStructTile = 1024;     // hosts a tile, structured form
constexpr int kDenseTile = 128;       // hosts a tile, dense form
constexpr int kExcSlots = 8;          // exception rows a round (structured)
constexpr int kRowPad = 16;           // bytes after each staged mask row
constexpr int kChunk = 16;            // hosts a uint4 of mask bytes

// shared memory of a scan block: the host records (three float4 and a
// float2 a host), then the mask rows
constexpr int kHostBytes = 3 * 16 + 8;
__host__ __device__ constexpr int row_bytes(int tile) {
  return tile + kRowPad;
}
__host__ __device__ constexpr int threads_of(bool dense) {
  return dense ? kDenseThreads : kStructThreads;
}
constexpr int smem_bytes(bool dense, int tile) {
  return tile * kHostBytes +
         (dense ? 2 * kDenseThreads * row_bytes(tile)
                : 2 * tile + kExcSlots * row_bytes(tile));
}
constexpr int kDenseSmem = smem_bytes(true, kDenseTile);
constexpr int kStructSmem = smem_bytes(false, kStructTile);

static_assert(kStructTile % (2 * kChunk) == 0 &&
                  kDenseTile % (2 * kChunk) == 0,
              "row_bytes / 16 odd: 8 rows a quarter warp in distinct banks");
static_assert(kDenseSmem <= 232448 && kStructSmem <= 232448,
              "a block's shared memory");

__device__ __forceinline__ float pow2(int e) {   // 2^e, e in [-126, 127]
  return __int_as_float((127 + e) << 23);
}

// magnitudes in [2^-40, 2^40); false for NaN
__device__ __forceinline__ bool in_range(float x) {
  float a = fabsf(x);
  return a >= pow2(-40) && a < pow2(40);
}

template <int KT>
struct RunningTopK {
  float v[KT];
  int ix[KT];

  __device__ __forceinline__ void init() {
    const float neg_inf = -__int_as_float(0x7F800000);
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      v[i] = neg_inf;
      ix[i] = 0;
    }
  }

  // Insert (f, h) after every entry >= f; the last entry falls off.
  __device__ __forceinline__ void offer(float f, int h) {
    if (!(f > v[KT - 1])) return;
    bool shifting = false;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      if (shifting || f > v[i]) {
        float tf = v[i];
        int th = ix[i];
        v[i] = f;
        ix[i] = h;
        f = tf;
        h = th;
        shifting = true;
      }
    }
  }
};

struct Params {
  const float* res;
  const uint8_t* cmask;       // dense [J, H]
  const uint8_t* valid;
  const int* exc_id;          // structured
  const uint8_t* host_gpu;
  const uint8_t* host_blocked;
  const uint8_t* exc_mask;    // structured [E, H]
  const float* avail;
  const float* cap;
  float* part_fit;            // [S, J, KT]
  int* part_host;
  int J, H, per;              // per: hosts a split, whole tiles
  int vec;                    // mask rows take 16-byte copies
};

// The host records of one tile in shared memory.
struct Hosts {
  float4* pre;     // ha0, ha1, hh, 0: the pre-filter
  float4* um;      // u0, u1, m0, m1
  float4* avail;
  float2* rcp;     // recip_fast(m0), recip_fast(m1)
};

template <int TILE>
__device__ __forceinline__ Hosts carve_hosts(uint8_t* smem) {
  Hosts s;
  s.pre = (float4*)smem;
  s.um = s.pre + TILE;
  s.avail = s.um + TILE;
  s.rcp = (float2*)(s.avail + TILE);
  return s;
}

// Hosts [h0, h0 + n) into the records (past n a chunk's mask bytes are
// 0); nmax: the block's largest |n0|, |n1| among the jobs the pre-filter
// takes.
template <int THREADS>
__device__ __forceinline__ void stage_hosts(const Params& p, const Hosts& s,
                                            int h0, int n, float nmax0,
                                            float nmax1) {
  const float tiny = pow2(-120), rel = pow2(-16);
  for (int t = threadIdx.x; t < n; t += THREADS) {
    const int h = h0 + t;
    const float4 av = __ldg((const float4*)p.avail + h);
    const float4 cp = __ldg((const float4*)p.cap + h);
    const float u0 = cp.x - av.x, u1 = cp.y - av.y;
    const float m0 = cp.x > 1e-9f ? cp.x : 1e-9f;
    const float m1 = cp.y > 1e-9f ? cp.y : 1e-9f;
    const float ha0 = __frcp_rn(m0) * 0.5f, ha1 = __frcp_rn(m1) * 0.5f;
    const bool safe = fabsf(u0) < pow2(40) && fabsf(u1) < pow2(40) &&
                      in_range(m0) && in_range(m1);
    const float margin =
        __fmaf_rn(fabsf(u1) + nmax1, ha1 * rel,
                  __fmaf_rn(fabsf(u0) + nmax0, ha0 * rel, tiny));
    const float hh = safe ? __fmaf_rn(u0, ha0, __fmaf_rn(u1, ha1, margin))
                          : __int_as_float(0x7FC00000);
    s.pre[t] = make_float4(ha0, ha1, hh, 0.0f);
    s.um[t] = make_float4(u0, u1, m0, m1);
    s.rcp[t] = make_float2(recip_fast(m0), recip_fast(m1));
    s.avail[t] = av;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row r of the staged rows gets bytes [h0, h0 + n) of src_row(r) (null:
// nothing), zeros after them up to the chunk; 16-byte copies when vec
// (n is then a multiple of 16), else byte loads and stores.
template <int THREADS, int TILE, typename RowOf>
__device__ __forceinline__ void stage_rows(uint8_t* rows, int nrows, int h0,
                                           int n, bool vec, RowOf src_row) {
  if (vec) {
    const int per_row = n / kChunk;
    for (int i = threadIdx.x; i < nrows * per_row; i += THREADS) {
      const int r = i / per_row, c = i - r * per_row;
      const uint8_t* src = src_row(r);
      if (src)
        cp_async16(rows + r * row_bytes(TILE) + c * kChunk,
                   src + h0 + c * kChunk);
    }
  } else {
    const int width = (n + kChunk - 1) / kChunk * kChunk;
    for (int i = threadIdx.x; i < nrows * width; i += THREADS) {
      const int r = i / width, b = i - r * width;
      const uint8_t* src = src_row(r);
      if (src) rows[r * row_bytes(TILE) + b] = b < n ? src[h0 + b] : 0;
    }
  }
}

// The thread's job: its demand, the pre-filter's copy of it (NaN
// where the pre-filter does not apply), its list, and its mask row for
// the current round (a byte offset into shared memory; -1: not in this
// round).
template <int KT>
struct Job {
  float n0, n1, n2, n3, pn0, pn1;
  bool active;
  int slot;        // structured: exception slot, or -1
  int cls;         // structured: 1 for a gpu job, else 0
  int row;
  bool nan;        // a feasible pair's fitness was NaN: nanv
  float nanv;
  RunningTopK<KT> top;
};

// The exact path at tile host t (host h), whose mask is set: the
// resource fit, the fitness in the Pallas kernel's order, the strict
// insertion.
template <int KT>
__device__ __forceinline__ void exact(Job<KT>& q, const Hosts& s, int t,
                                     int h) {
  const float4 av = s.avail[t];
  if (!(av.x >= q.n0 && av.y >= q.n1 && av.z >= q.n2 && av.w >= q.n3))
    return;
  const float4 um = s.um[t];
  const float2 r = s.rcp[t];
  const float x0 = um.x + q.n0, x1 = um.y + q.n1;
  const float q0 = div_safe(x0, um.z) ? div_by_recip(x0, um.z, r.x)
                                      : x0 / um.z;
  const float q1 = div_safe(x1, um.w) ? div_by_recip(x1, um.w, r.y)
                                      : x1 / um.w;
  float f = 0.0f;
  f = f + q0;
  f = f + q1;
  f = f * 0.5f;
  if (f != f && !q.nan) {
    q.nan = true;
    q.nanv = f;
  }
  q.top.offer(f, h);
}

// Scan the tile's hosts [h0, h0 + 16 nc) for the job if it has a row
// in this round (a warp without one skips the tile).
template <int KT>
__device__ __forceinline__ void scan_tile(Job<KT>& q, const uint8_t* smem,
                                          const Hosts& s, int h0, int nc) {
  if (!__any_sync(0xFFFFFFFFu, q.row >= 0)) return;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const uint4 mw = q.row >= 0
                         ? *(const uint4*)(smem + q.row + c * kChunk)
                         : make_uint4(0, 0, 0, 0);
    unsigned cand = 0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 pre = s.pre[c * kChunk + k];
      const unsigned w = k < 4 ? mw.x : k < 8 ? mw.y : k < 12 ? mw.z : mw.w;
      const float est = __fmaf_rn(q.pn0, pre.x,
                                  __fmaf_rn(q.pn1, pre.y, pre.z));
      const bool m = (w >> (8 * (k & 3))) & 0xFFu;
      cand |= (m && !(est <= q.top.v[KT - 1])) ? 1u << k : 0u;
    }
    while (cand) {
      const int k = __ffs(cand) - 1;
      cand &= cand - 1;
      exact(q, s, c * kChunk + k, h0 + c * kChunk + k);
    }
  }
}

template <int KT, bool kDense>
__global__ void __launch_bounds__(threads_of(kDense))
    topk_scan_kernel(Params p) {
  constexpr int TILE = kDense ? kDenseTile : kStructTile;
  constexpr int THREADS = threads_of(kDense);
  constexpr int JOBS = THREADS;   // one job a thread
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned s_nmax[2];
  __shared__ int s_nexc;
  __shared__ int s_eid[JOBS];
  const Hosts hs = carve_hosts<TILE>(smem);
  constexpr int kRows = TILE * kHostBytes;   // the mask rows' offset
  uint8_t* rows = smem + kRows;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * JOBS;
  const int h_lo = blockIdx.y * p.per;
  const int h_hi = min(p.H, h_lo + p.per);
  if (tid == 0) {
    s_nmax[0] = s_nmax[1] = 0u;
    s_nexc = 0;
  }
  __syncthreads();

  Job<KT> q;
  const int j = j0 + tid;
  q.active = j < p.J && p.valid[j] != 0;
  q.n0 = q.n1 = q.n2 = q.n3 = 0.0f;
  q.slot = -1;
  q.cls = 0;
  q.row = -1;
  q.nan = false;
  q.nanv = 0.0f;
  q.top.init();
  if (q.active) {
    const float4 n = __ldg((const float4*)p.res + j);
    q.n0 = n.x;
    q.n1 = n.y;
    q.n2 = n.z;
    q.n3 = n.w;
    if (!kDense) {
      q.cls = n.z > 0.0f ? 1 : 0;
      const int eid = p.exc_id[j];
      if (eid >= 0) {
        q.slot = atomicAdd(&s_nexc, 1);
        s_eid[q.slot] = eid;
      }
    }
  }
  const bool pre = q.active && fabsf(q.n0) < pow2(40) &&
                   fabsf(q.n1) < pow2(40);
  q.pn0 = pre ? q.n0 : __int_as_float(0x7FC00000);
  q.pn1 = pre ? q.n1 : __int_as_float(0x7FC00000);
  if (pre) {   // non-negative floats order as their bits
    atomicMax(&s_nmax[0], __float_as_uint(fabsf(q.n0)));
    atomicMax(&s_nmax[1], __float_as_uint(fabsf(q.n1)));
  }
  __syncthreads();
  const float nmax0 = __uint_as_float(s_nmax[0]);
  const float nmax1 = __uint_as_float(s_nmax[1]);
  const bool vec = p.vec != 0;

  if (kDense) {
    // row r of a buffer is job j0 + r; tile i in buffer i & 1
    auto src_row = [&](int r) -> const uint8_t* {
      const int j = j0 + r;
      return j < p.J ? p.cmask + (long long)j * p.H : nullptr;
    };
    if (h_lo < h_hi)
      stage_rows<THREADS, TILE>(rows, JOBS, h_lo, min(TILE, h_hi - h_lo),
                                vec, src_row);
    cp_async_commit();
    int buf = 0;
    for (int h0 = h_lo; h0 < h_hi; h0 += TILE, buf ^= 1) {
      const int n = min(TILE, h_hi - h0);
      __syncthreads();   // the previous tile's scan is done
      if (h0 + TILE < h_hi)
        stage_rows<THREADS, TILE>(rows + (buf ^ 1) * JOBS * row_bytes(TILE),
                                  JOBS, h0 + TILE,
                                  min(TILE, h_hi - h0 - TILE), vec, src_row);
      cp_async_commit();
      stage_hosts<THREADS>(p, hs, h0, n, nmax0, nmax1);
      cp_async_wait<1>();   // this tile's copies have landed
      __syncthreads();
      q.row = q.active
                  ? kRows + (buf * JOBS + tid) * row_bytes(TILE)
                  : -1;
      scan_tile(q, smem, hs, h0, (n + kChunk - 1) / kChunk);
    }
  } else {
    uint8_t* cls = rows;                 // [2][TILE]: cpu jobs, gpu jobs
    uint8_t* exc = rows + 2 * TILE;      // kExcSlots rows
    constexpr int kExc = kRows + 2 * TILE;
    // round r: the exception slots [r kExcSlots, (r + 1) kExcSlots), and
    // in round 0 the jobs without an exception row
    const int nexc = s_nexc;
    const int rounds = nexc > 0 ? (nexc + kExcSlots - 1) / kExcSlots : 1;
    for (int h0 = h_lo; h0 < h_hi; h0 += TILE) {
      const int n = min(TILE, h_hi - h0);
      const int nc = (n + kChunk - 1) / kChunk;
      __syncthreads();   // the previous tile's scan is done
      stage_hosts<THREADS>(p, hs, h0, n, nmax0, nmax1);
      for (int t = tid; t < nc * kChunk; t += THREADS) {
        const bool ok = t < n && p.host_blocked[h0 + t] == 0;
        const bool g = t < n && p.host_gpu[h0 + t] != 0;
        cls[t] = ok && !g;
        cls[TILE + t] = ok && g;
      }
      for (int rd = 0; rd < rounds; ++rd) {
        if (rd > 0) __syncthreads();   // the previous round's scan is done
        const int first = rd * kExcSlots;
        stage_rows<THREADS, TILE>(exc, min(kExcSlots, nexc - first), h0, n,
                                  vec, [&](int r) -> const uint8_t* {
                                    return p.exc_mask +
                                           (long long)s_eid[first + r] * p.H;
                                  });
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        q.row = !q.active ? -1
                : q.slot < 0 ? (rd == 0 ? kRows + q.cls * TILE : -1)
                : q.slot >= first && q.slot < first + kExcSlots
                    ? kExc + (q.slot - first) * row_bytes(TILE)
                    : -1;
        scan_tile(q, smem, hs, h0, nc);
      }
    }
  }

  if (j < p.J) {
    const long long o = ((long long)blockIdx.y * p.J + j) * KT;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      p.part_fit[o + i] = q.nan ? q.nanv : q.top.v[i];
      p.part_host[o + i] = q.nan ? 0 : q.top.ix[i];
    }
  }
}

template <int KT>
__global__ void topk_merge_kernel(const float* __restrict__ part_fit,
                                  const int* __restrict__ part_host,
                                  float* __restrict__ out_fit,
                                  int* __restrict__ out_host, int J, int k,
                                  int S) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J) return;
  RunningTopK<KT> top;
  top.init();
  bool nan = false;   // a split's row of NaN (the first one's)
  float nanv = 0.0f;
  for (int s = 0; s < S; ++s) {
    long long o = ((long long)s * J + j) * KT;
    for (int i = 0; i < KT; ++i) {
      const float f = part_fit[o + i];
      if (f != f && !nan) {
        nan = true;
        nanv = f;
      }
      top.offer(f, part_host[o + i]);
    }
  }
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    if (i < k) {
      out_fit[(long long)j * k + i] = nan ? nanv : top.v[i];
      out_host[(long long)j * k + i] = nan ? 0 : top.ix[i];
    }
  }
}

// Allow the scan kernel its shared memory (above 48 KB) on the current
// device; set at every call, since the attribute is the device's.
template <int KT, bool kDense>
int prepare() {
  return (int)cudaFuncSetAttribute(topk_scan_kernel<KT, kDense>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kDense ? kDenseSmem : kStructSmem);
}

template <int KT, bool kDense>
int launch(Params p, float* out_fit, int* out_host, int k, int S,
           cudaStream_t st) {
  constexpr int smem = kDense ? kDenseSmem : kStructSmem;
  if (int e = prepare<KT, kDense>()) return e;
  if (p.J <= 0) return 0;
  dim3 grid(cook::grid_for(p.J, threads_of(kDense)), S);
  topk_scan_kernel<KT, kDense><<<grid, threads_of(kDense), smem, st>>>(p);
  int e = cook::last_error();
  if (e != 0) return e;
  topk_merge_kernel<KT><<<cook::grid_for(p.J), cook::kThreads, 0, st>>>(
      p.part_fit, p.part_host, out_fit, out_host, p.J, k, S);
  return cook::last_error();
}

// The geometry the plan gives must be this source's: tile, jobs a block,
// shared memory, and S splits of `per` hosts (whole tiles) covering H.
bool geometry_ok(int H, int S, int per, int tile, int jobs, int smem,
                 bool dense) {
  const int want_tile = dense ? kDenseTile : kStructTile;
  const int want_smem = dense ? kDenseSmem : kStructSmem;
  const int tiles = (H + want_tile - 1) / want_tile;
  return tile == want_tile && jobs == threads_of(dense) &&
         smem == want_smem &&
         S >= 1 && per > 0 && per % want_tile == 0 &&
         per == (tiles + S - 1) / S * want_tile &&
         (long long)per * S >= H;
}

template <int KT, bool kDense>
int blocks_per_sm() {
  int n = 0;
  if (prepare<KT, kDense>() != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, topk_scan_kernel<KT, kDense>, threads_of(kDense),
          kDense ? kDenseSmem : kStructSmem) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// fit[J, k], host[J, k] over a dense mask cmask[J, H] (u8).  part_fit and
// part_host hold S * J * KT entries, KT = 8 when k <= 8, else 16.
// res, avail and cap must be 16-byte aligned.
COOK_API int topk_dense(const float* res, const uint8_t* cmask,
                        const uint8_t* valid, const float* avail,
                        const float* cap, float* part_fit, int* part_host,
                        float* out_fit, int* out_host, int J, int H, int k,
                        int S, int per, int tile, int jobs, int smem,
                        void* stream) {
  if (k < 1 || k > 16 || J < 0 || H < 1 ||
      !geometry_ok(H, S, per, tile, jobs, smem, true))
    return (int)cudaErrorInvalidValue;
  Params p{res, cmask, valid, nullptr, nullptr, nullptr, nullptr, avail,
           cap, part_fit, part_host, J, H, per,
           ((uintptr_t)cmask % 16 == 0 && H % kChunk == 0) ? 1 : 0};
  cudaStream_t st = (cudaStream_t)stream;
  return k <= 8 ? launch<8, true>(p, out_fit, out_host, k, S, st)
                : launch<16, true>(p, out_fit, out_host, k, S, st);
}

// The same over the structured mask: host_gpu[H], host_blocked[H] (u8),
// exception rows exc_mask[E, H] (u8) for the jobs with exc_id[j] >= 0
// (every exc_id below E).
COOK_API int topk_structured(const float* res, const uint8_t* valid,
                             const int* exc_id, const uint8_t* host_gpu,
                             const uint8_t* host_blocked,
                             const uint8_t* exc_mask, const float* avail,
                             const float* cap, float* part_fit, int* part_host,
                             float* out_fit, int* out_host, int J, int H,
                             int k, int S, int per, int tile, int jobs,
                             int smem, void* stream) {
  if (k < 1 || k > 16 || J < 0 || H < 1 ||
      !geometry_ok(H, S, per, tile, jobs, smem, false))
    return (int)cudaErrorInvalidValue;
  Params p{res, nullptr, valid, exc_id, host_gpu, host_blocked, exc_mask,
           avail, cap, part_fit, part_host, J, H, per,
           ((uintptr_t)exc_mask % 16 == 0 && H % kChunk == 0) ? 1 : 0};
  cudaStream_t st = (cudaStream_t)stream;
  return k <= 8 ? launch<8, false>(p, out_fit, out_host, k, S, st)
                : launch<16, false>(p, out_fit, out_host, k, S, st);
}

// Scan blocks of a form (dense or structured, k <= 8 or above) that an
// SM holds at once, for the plan's host splits; 0 on error.
COOK_API int topk_blocks_per_sm(int dense, int k) {
  if (dense)
    return k <= 8 ? blocks_per_sm<8, true>() : blocks_per_sm<16, true>();
  return k <= 8 ? blocks_per_sm<8, false>() : blocks_per_sm<16, false>();
}
