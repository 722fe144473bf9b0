// K1 expand: the wire decode and gathers at the head of
// ops/pallas_cycle.py::_kernel (:155-203, the expand_compact recipe of
// parallel/sharded.py:206) and its phase 0 (:163-168, the per-pool
// running usage, and the quota-group base :211).
//
// One memset of the control words, then one launch.  The grid is the
// task tiles (kTile rows of one pool each, pools series-major over
// blockIdx), then the host tiles (kHostTile hosts of one pool each).
//
// A task tile decodes the rows codec, gathers res_base[row] as one
// 16-byte load and stores usage, job_res and quota as float4, gathers
// tokens and shares from the per-user tables (L2-resident), writes the
// segment starts and segment-end marks, and writes its slice of exc_id
// whole: the slice starts at -1 in shared memory, every exception row of
// the pool (read by each tile, L2-resident) that lands inside it is
// applied with a shared atomicMax (the highest e wins a duplicate: the
// JAX scatter's last write), and the slice is stored once.
//
// pool_base is summed in window32_sum's order (ops/scan.py, XLA:CPU's:
// while more than 32 values remain, centred zero padding to whole
// windows of 32, each window summed from +0.0) without reading usage
// back.  The level-0 windows start `shift0` rows before row 0 and the
// level-1 windows (32 level-0 windows) `shift0 + 32 * shift1` rows
// before it, where shift0 and shift1 are the two levels' leading
// padding (0 at a power of two).  So the tile grid is shifted by
// `shift = shift0 + 32 * shift1` rows: tile k holds rows [k * kTile -
// shift, (k + 1) * kTile - shift) of the pool, the first tile is short,
// and every tile holds whole level-1 windows.  A tile sums its masked
// usage (usage * (valid & ~pending)) a 32-row window at a time from
// +0.0, then each 32 of those, and stores the level-1 partials.  A
// window sums only the rows it has; the zero padding changes no sum
// that starts from +0.0, so the bits are the same.  The tile then takes
// a ticket of its pool (atomic, after a fence); the tile that finishes
// its pool last sums the remaining levels, with their own centred
// padding, into pool_base[s] and takes a ticket over pools; the last
// pool's finisher computes group_base of every pool in the same order
// (a sequential sum up to 32 pools, centred windows of 32 past that).
// No tile waits on another, so any scheduling order is safe.
//
// A host tile unpacks host_bits and decodes avail and capacity (u16
// fixed point times the column's scale, or f32 through), float4 out.
//
// The geometry is ops/expand.py's expand_plan; the entry refuses any
// other.  Bound: bytes, about 80 B a task row plus 40 B a host; at P = 4,
// T = 128Ki, H = 8Ki about 53 MB, 16 us at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr uint8_t kPending = 1, kValid = 2, kUserFirst = 16;

constexpr int kTile = 2048;            // task rows a CTA
constexpr int kHostTile = 4096;        // hosts a CTA
constexpr int kExpandThreads = 256;    // threads a CTA
constexpr int kMinCtas = 2;            // CTAs an SM holds at once
constexpr int kWin = 32;               // window32_sum's window
constexpr int kLevel1 = kWin * kWin;   // rows of a level-1 window
constexpr int kRowsPerThread = kTile / kExpandThreads;  // 8
constexpr int kBatch = 8;              // rows in flight a thread
constexpr int kWindows0 = kTile / kWin;          // level-0 windows a tile
constexpr int kWindows1 = kTile / kLevel1;       // level-1 windows a tile
constexpr int kMaxPools = kWin * kWin;           // group_base's two levels
constexpr long long kMaxWindows = 32768;         // level-1 windows a pool
// shared memory: the masked usage (float4 a row, one float4 of padding
// after every 32 rows, so that the level-0 sums read without bank
// conflicts), the exc_id slice, the level-0 partials
constexpr int kRunFloats = 4 * (kTile + kTile / kWin);
constexpr int kSmemBytes =
    4 * kRunFloats + 4 * kTile + 4 * 4 * kWindows0;

static_assert(kTile % kLevel1 == 0, "a tile holds whole level-1 windows");
static_assert(kWindows0 * 4 == kExpandThreads,
              "one thread a (level-0 window, column)");
static_assert(kMaxWindows / kWin * 4 * 2 <= kRunFloats,
              "the finisher's two level buffers fit the tile's smem");

struct Scales {
  float v[4];
};

struct Args {
  const void* rows;
  const uint8_t* flags;
  const float* res_base;
  const float* disk_base;
  const float* tokens_u;
  const float* shares_u;
  const float* quota_u;
  const int* user_rank;
  const int* group_id;
  const uint8_t* host_bits;
  const int* exc_rows;
  const void* avail_in;
  const void* cap_in;
  Scales as, cs;
  float* usage;
  float* job_res;
  float* tokens;
  float* shares;
  float* quota;
  uint8_t* start;
  int* last_mark;
  int* exc_id;
  uint8_t* host_gpu;
  uint8_t* host_blocked;
  float* avail;
  float* cap;
  float* pool_base;
  float* group_base;
  float* partials;      // [S, windows, 4] level-1 partials
  unsigned* ticket;     // [S] tiles finished a pool, then pools finished
  long long T;
  int codec, avail_u16, cap_u16, S, U, E, H, B, tiles, host_tiles, windows;
  int shift;            // rows the tile grid starts before row 0
};

__device__ __forceinline__ long long decode_row(const Args& a, long long i,
                                                long long t) {
  if (a.codec == 0) return ((const int*)a.rows)[i];
  if (a.codec == 1) return (long long)((const int16_t*)a.rows)[i] + t;
  return (long long)((const int8_t*)a.rows)[i] + t;
}

__device__ __forceinline__ float4 scale4(float4 v, float m) {
  return make_float4(v.x * m, v.y * m, v.z * m, v.w * m);
}

__device__ __forceinline__ float4 decode4(const void* in, int u16,
                                          const Scales& sc, long long i) {
  if (!u16) return __ldg((const float4*)in + i);
  ushort4 v = __ldg((const ushort4*)in + i);
  return make_float4((float)v.x * sc.v[0], (float)v.y * sc.v[1],
                     (float)v.z * sc.v[2], (float)v.w * sc.v[3]);
}

__device__ void host_tile(const Args& a, int b) {
  const int s = b / a.host_tiles;
  const int h0 = (b % a.host_tiles) * kHostTile;
  const int h1 = min(h0 + kHostTile, a.H);
  const uint8_t* gbits = a.host_bits + (long long)(s * 2 + 0) * a.B;
  const uint8_t* bbits = a.host_bits + (long long)(s * 2 + 1) * a.B;
  for (int h = h0 + (int)threadIdx.x; h < h1; h += kExpandThreads) {
    long long i = (long long)s * a.H + h;
    int sh = 7 - (h & 7);
    a.host_gpu[i] = (gbits[h >> 3] >> sh) & 1;
    a.host_blocked[i] = (bbits[h >> 3] >> sh) & 1;
    ((float4*)a.avail)[i] = decode4(a.avail_in, a.avail_u16, a.as, i);
    ((float4*)a.cap)[i] = decode4(a.cap_in, a.cap_u16, a.cs, i);
  }
}

// Zeros XLA:CPU's reduce puts before n values (ops/scan.centred_pad).
__host__ __device__ __forceinline__ int centred_pad(long long n) {
  return n <= kWin ? 0 : (int)(((n + kWin - 1) / kWin * kWin - n) / 2);
}

// pool_base[s] from the pool's level-1 partials, the levels above in
// window32_sum's order; buf: two buffers of kRunFloats / 2 floats
__device__ void finish_pool(const Args& a, int s, float* buf) {
  const int tid = threadIdx.x;
  int n = a.windows;
  const float* src = a.partials + (long long)s * a.windows * 4;
  bool global = true;
  int flip = 0;
  while (n > kWin) {
    int nb = (n + kWin - 1) / kWin;
    int pad = centred_pad(n);
    float* dst = buf + flip * (kRunFloats / 2);
    for (int i = tid; i < nb * 4; i += kExpandThreads) {
      int w = i >> 2, c = i & 3;
      int hi = min(w * kWin - pad + kWin, n);
      float acc = 0.0f;
      for (int j = max(w * kWin - pad, 0); j < hi; ++j)
        acc = acc + (global ? __ldcg(src + j * 4 + c) : src[j * 4 + c]);
      dst[i] = acc;
    }
    __syncthreads();
    src = dst;
    global = false;
    flip ^= 1;
    n = nb;
  }
  if (tid < 4) {
    float acc = 0.0f;
    for (int j = 0; j < n; ++j)
      acc = acc + (global ? __ldcg(src + j * 4 + tid) : src[j * 4 + tid]);
    a.pool_base[s * 4 + tid] = acc;
    __threadfence();
  }
}

// group_base[s] = sum over pools q of pool_base[q] where q shares s's
// quota group: in order up to 32 pools; past that, window w holds pools
// [32 w - pad, 32 w - pad + 32) (centred padding), and the nw <= 32
// window sums are summed in order.  Every sum starts from +0.0, so a
// single window's sum is the sequential one.
__device__ void finish_groups(const Args& a) {
  const int nw = (a.S + kWin - 1) / kWin, pad = centred_pad(a.S);
  for (int i = threadIdx.x; i < a.S * 4; i += kExpandThreads) {
    int s = i >> 2, c = i & 3;
    int g = a.group_id[s];
    float outer = 0.0f;
    for (int w = 0; w < nw; ++w) {
      float acc = 0.0f;
      for (int q = max(w * kWin - pad, 0);
           q < a.S && q < w * kWin - pad + kWin; ++q)
        acc = acc + __ldcg(a.pool_base + q * 4 + c) *
                        ((a.group_id[q] == g && g >= 0) ? 1.0f : 0.0f);
      outer = outer + acc;
    }
    a.group_base[i] = outer;
  }
}

__global__ void __launch_bounds__(kExpandThreads, kMinCtas)
    expand_tiles(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int task_ctas = a.S * a.tiles;
  if ((int)blockIdx.x >= task_ctas) {
    host_tile(a, (int)blockIdx.x - task_ctas);
    return;
  }
  const int s = blockIdx.x / a.tiles, tile = blockIdx.x % a.tiles;
  const long long T = a.T, lo = (long long)tile * kTile - a.shift;
  // the tile's rows are [r0, r1) of its kTile
  const int r0 = lo < 0 ? (int)-lo : 0;
  const int r1 = (int)(T - lo < kTile ? T - lo : kTile);
  const long long base = (long long)s * T + lo;
  float* run = smem;
  int* exc = (int*)(smem + kRunFloats);
  float* lvl0 = (float*)(exc + kTile);
  for (int r = tid; r < kTile; r += kExpandThreads) exc[r] = -1;

  // the row gathers, kBatch rows a thread at a time: every load of a
  // batch issued before its stores
#pragma unroll 1
  for (int k0 = 0; k0 < kRowsPerThread; k0 += kBatch) {
    int row[kBatch];
    uint8_t fl[kBatch];
    bool nfirst[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int r = tid + (k0 + k) * kExpandThreads;
      long long t = lo + r, i = base + r;
      bool ok = r >= r0 && r < r1;
      row[k] = ok ? (int)decode_row(a, i, t) : 0;
      fl[k] = ok ? a.flags[i] : 0;
      nfirst[k] = !ok || t + 1 >= T || (a.flags[i + 1] & kUserFirst);
    }
    float4 u[kBatch];
    float dk[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      u[k] = __ldg((const float4*)a.res_base + row[k]);
      dk[k] = __ldg(a.disk_base + row[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int r = tid + (k0 + k) * kExpandThreads;
      if (r < r0 || r >= r1) continue;
      long long t = lo + r, i = base + r;
      uint8_t f = fl[k];
      float pend = (f & kPending) ? 1.0f : 0.0f;
      float keep = ((f & kValid) && !(f & kPending)) ? 1.0f : 0.0f;
      ((float4*)a.usage)[i] = u[k];
      ((float4*)a.job_res)[i] = make_float4(u[k].x * pend, u[k].y * pend,
                                            u[k].z * pend, dk[k] * pend);
      *(float4*)(run + 4 * (r + (r >> 5))) = scale4(u[k], keep);
      a.start[i] = (f & kUserFirst) || t == 0;
      a.last_mark[i] = nfirst[k] ? (int)t : (int)(T - 1);
    }
  }
  // the per-user gathers
#pragma unroll 1
  for (int k0 = 0; k0 < kRowsPerThread; k0 += kBatch) {
    int uc[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int r = tid + (k0 + k) * kExpandThreads;
      int ur = r >= r0 && r < r1 ? a.user_rank[base + r] : 0;
      uc[k] = s * a.U + (ur < 0 ? 0 : (ur > a.U - 1 ? a.U - 1 : ur));
    }
    float tk[kBatch];
    float4 q[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      tk[k] = __ldg(a.tokens_u + uc[k]);
      q[k] = __ldg((const float4*)a.quota_u + uc[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      int r = tid + (k0 + k) * kExpandThreads;
      if (r < r0 || r >= r1) continue;
      long long i = base + r;
      const float* sh = a.shares_u + (long long)uc[k] * 3;
      a.tokens[i] = tk[k];
      ((float4*)a.quota)[i] = q[k];
      a.shares[i * 3 + 0] = __ldg(sh + 0);
      a.shares[i * 3 + 1] = __ldg(sh + 1);
      a.shares[i * 3 + 2] = __ldg(sh + 2);
    }
  }
  __syncthreads();

  // exceptions landing in this tile; the slice stored whole
  const int* er = a.exc_rows + (long long)s * a.E;
  for (int e = tid; e < a.E; e += kExpandThreads) {
    long long r = er[e];
    if (r >= lo + r0 && r < lo + r1) atomicMax(&exc[r - lo], e);
  }
  // level 0: a thread a (32-row window, column), sequential from +0.0
  {
    const int w = tid >> 2, c = tid & 3;
    const int hi = min(w * kWin + kWin, r1);
    float acc = 0.0f;
    for (int r = max(w * kWin, r0); r < hi; ++r)
      acc = acc + run[4 * (r + w) + c];
    lvl0[tid] = acc;
  }
  __syncthreads();
  for (int r = r0 + tid; r < r1; r += kExpandThreads)
    a.exc_id[base + r] = exc[r];
  // level 1: windows of 32 level-0 partials, stored for the finisher
  if (tid < 4 * kWindows1) {
    const int v = tid >> 2, c = tid & 3;
    const int n0 = (r1 + kWin - 1) / kWin;
    if (v * kWin < n0) {
      float acc = 0.0f;
      for (int w = v * kWin; w < min(v * kWin + kWin, n0); ++w)
        acc = acc + lvl0[w * 4 + c];
      a.partials[((long long)s * a.windows + tile * kWindows1 + v) * 4 + c] =
          acc;
      __threadfence();
    }
  }
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&a.ticket[s], 1u) == (unsigned)(a.tiles - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  finish_pool(a, s, run);
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&a.ticket[a.S], 1u) == (unsigned)(a.S - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  finish_groups(a);
}

}  // namespace

// Outputs and scratch are views of one slab (ops/expand.py): partials
// [S, windows, 4] f32, ticket [S + 1] u32 inside the ctl_words the
// memset zeroes.  tile, host_tile, threads and smem must be the values
// this source was compiled for; shift must be the grid's (see above);
// tiles, host_tiles and windows must cover T + shift and H.
COOK_API int k1_expand(const void* rows, int codec, const uint8_t* flags,
                       const float* res_base, const float* disk_base,
                       const float* tokens_u, const float* shares_u,
                       const float* quota_u, const int* user_rank,
                       const int* group_id, const uint8_t* host_bits,
                       const int* exc_rows, const void* avail_in,
                       int avail_u16, float a0, float a1, float a2, float a3,
                       const void* cap_in, int cap_u16, float c0, float c1,
                       float c2, float c3, float* usage, float* job_res,
                       float* tokens, float* shares, float* quota,
                       uint8_t* start, int* last_mark, int* exc_id,
                       uint8_t* host_gpu, uint8_t* host_blocked, float* avail,
                       float* cap, float* pool_base, float* group_base,
                       float* partials, unsigned* ctl, int ctl_words, int S,
                       long long T, int U, int E, int H, int B, int tile,
                       int host_tile_, int threads, int tiles, int host_tiles,
                       int windows, int shift, int smem, void* stream) {
  const int want_shift =
      T < 1 ? 0 : centred_pad(T) + kWin * centred_pad((T + kWin - 1) / kWin);
  if (tile != kTile || host_tile_ != kHostTile || threads != kExpandThreads ||
      smem != kSmemBytes || S < 1 || S > kMaxPools || T < 1 || U < 1 ||
      E < 0 || H < 0 || codec < 0 || codec > 2 ||
      shift != want_shift || (long long)tiles * kTile < T + shift ||
      (long long)(tiles - 1) * kTile >= T + shift ||
      (long long)host_tiles * kHostTile < H ||
      (host_tiles > 0 && (long long)(host_tiles - 1) * kHostTile >= H) ||
      windows != (T + kLevel1 - 1) / kLevel1 ||
      windows > kMaxWindows || ctl_words < S + 1 ||
      (long long)S * (tiles + host_tiles) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        expand_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ctl, 0, sizeof(unsigned) * ctl_words, st);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.rows = rows;
  a.flags = flags;
  a.res_base = res_base;
  a.disk_base = disk_base;
  a.tokens_u = tokens_u;
  a.shares_u = shares_u;
  a.quota_u = quota_u;
  a.user_rank = user_rank;
  a.group_id = group_id;
  a.host_bits = host_bits;
  a.exc_rows = exc_rows;
  a.avail_in = avail_in;
  a.cap_in = cap_in;
  a.as = Scales{{a0, a1, a2, a3}};
  a.cs = Scales{{c0, c1, c2, c3}};
  a.usage = usage;
  a.job_res = job_res;
  a.tokens = tokens;
  a.shares = shares;
  a.quota = quota;
  a.start = start;
  a.last_mark = last_mark;
  a.exc_id = exc_id;
  a.host_gpu = host_gpu;
  a.host_blocked = host_blocked;
  a.avail = avail;
  a.cap = cap;
  a.pool_base = pool_base;
  a.group_base = group_base;
  a.partials = partials;
  a.ticket = ctl;
  a.T = T;
  a.codec = codec;
  a.avail_u16 = avail_u16;
  a.cap_u16 = cap_u16;
  a.S = S;
  a.U = U;
  a.E = E;
  a.H = H;
  a.B = B;
  a.tiles = tiles;
  a.host_tiles = host_tiles;
  a.windows = windows;
  a.shift = shift;
  expand_tiles<<<S * (tiles + host_tiles), kExpandThreads, kSmemBytes, st>>>(
      a);
  return cook::last_error();
}
