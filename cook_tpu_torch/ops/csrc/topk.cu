// Top-K host preferences per job: the port of the two Pallas kernels of
// ops/pallas_match.py, _kernel :116 (dense mask) and _structured_kernel
// :162 (mask composed from host vectors and exception rows), which share
// the running merge _merge_running_topk :78.
//
// One thread per job keeps its best K (8 or 16) entries of (score, host)
// in registers, sorted best first, and walks its hosts in increasing
// order.  A candidate enters only when it is strictly greater than the
// K-th entry and is placed after every entry it ties with, so ties stay
// at the lowest host index, as lax.top_k breaks them.  Blocks stage a
// tile of hosts (avail and the cpu/mem capacity columns; the gpu and
// blocked bytes for the structured form) in shared memory; every thread
// of a warp reads the same host, a broadcast.  The structured form reads
// an exception row by a direct byte read of exc_mask[eid, h] (the TPU
// kernel's one-hot matmul only works round Mosaic's lack of row gathers).
//
// When the jobs alone give too few blocks to fill the card, blockIdx.y
// splits the hosts into S ranges; each writes a partial list and a second
// kernel merges the S lists in host order with the same strict rule.
//
// Bound: operations.  Every feasible (job, host) pair costs two IEEE
// divisions and a handful of compares and adds (about 12 f32 operations),
// against bytes of only the inputs and the [J, K] outputs.  No [J, H]
// score touches device memory.
#include "common.cuh"

namespace {

constexpr int kTopkThreads = 128;
constexpr int kTopkTile = 1024;

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

template <int KT, bool kStructured>
__global__ void __launch_bounds__(kTopkThreads)
topk_scan_kernel(const float* __restrict__ res,
                 const uint8_t* __restrict__ cmask,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ exc_id,
                 const uint8_t* __restrict__ host_gpu,
                 const uint8_t* __restrict__ host_blocked,
                 const uint8_t* __restrict__ exc_mask,
                 const float* __restrict__ avail, const float* __restrict__ cap,
                 float* __restrict__ part_fit, int* __restrict__ part_host,
                 int J, int H, int hosts_per_split) {
  __shared__ float s_av[kTopkTile * 4];
  __shared__ float s_c0[kTopkTile];
  __shared__ float s_c1[kTopkTile];
  __shared__ uint8_t s_ok[kStructured ? 2 * kTopkTile : 1];
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int s = blockIdx.y;
  int h_lo = s * hosts_per_split;
  int h_hi = min(H, h_lo + hosts_per_split);
  bool active = j < J && valid[j] != 0;
  float n0 = 0.f, n1 = 0.f, n2 = 0.f, n3 = 0.f;
  bool gpu = false;
  const uint8_t* row = nullptr;
  if (active) {
    n0 = res[j * 4 + 0];
    n1 = res[j * 4 + 1];
    n2 = res[j * 4 + 2];
    n3 = res[j * 4 + 3];
    if (kStructured) {
      gpu = n2 > 0.f;
      int eid = exc_id[j];
      row = eid >= 0 ? exc_mask + (long long)eid * H : nullptr;
    } else {
      row = cmask + (long long)j * H;
    }
  }
  RunningTopK<KT> top;
  top.init();
  for (int base = h_lo; base < h_hi; base += kTopkTile) {
    int n = min(kTopkTile, h_hi - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      int h = base + t;
      s_av[t * 4 + 0] = avail[h * 4 + 0];
      s_av[t * 4 + 1] = avail[h * 4 + 1];
      s_av[t * 4 + 2] = avail[h * 4 + 2];
      s_av[t * 4 + 3] = avail[h * 4 + 3];
      s_c0[t] = cap[h * 4 + 0];
      s_c1[t] = cap[h * 4 + 1];
      if (kStructured) {
        s_ok[t] = host_gpu[h] != 0;
        s_ok[kTopkTile + t] = host_blocked[h] == 0;
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < n; ++t) {
      int h = base + t;
      bool m;
      if (kStructured) {
        m = row ? row[h] != 0
                : ((gpu ? s_ok[t] != 0 : s_ok[t] == 0) &&
                   s_ok[kTopkTile + t] != 0);
      } else {
        m = row[h] != 0;
      }
      if (!m) continue;
      float a0 = s_av[t * 4 + 0], a1 = s_av[t * 4 + 1];
      float a2 = s_av[t * 4 + 2], a3 = s_av[t * 4 + 3];
      if (!(a0 >= n0 && a1 >= n1 && a2 >= n2 && a3 >= n3)) continue;
      float c0 = s_c0[t], c1 = s_c1[t];
      float m0 = c0 > 1e-9f ? c0 : 1e-9f;
      float m1 = c1 > 1e-9f ? c1 : 1e-9f;
      // the Pallas kernel's order: fit = 0; fit += a; fit += b; fit * 0.5
      float f = 0.f;
      f = f + ((c0 - a0) + n0) / m0;
      f = f + ((c1 - a1) + n1) / m1;
      f = f * 0.5f;
      top.offer(f, h);
    }
  }
  if (j < J) {
    long long o = ((long long)s * J + j) * KT;
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      part_fit[o + i] = top.v[i];
      part_host[o + i] = top.ix[i];
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
  for (int s = 0; s < S; ++s) {
    long long o = ((long long)s * J + j) * KT;
    for (int i = 0; i < KT; ++i) top.offer(part_fit[o + i], part_host[o + i]);
  }
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    if (i < k) {
      out_fit[(long long)j * k + i] = top.v[i];
      out_host[(long long)j * k + i] = top.ix[i];
    }
  }
}

template <int KT, bool kStructured>
int launch(const float* res, const uint8_t* cmask, const uint8_t* valid,
           const int* exc_id, const uint8_t* host_gpu,
           const uint8_t* host_blocked, const uint8_t* exc_mask,
           const float* avail, const float* cap, float* part_fit,
           int* part_host, float* out_fit, int* out_host, int J, int H, int k,
           int S, cudaStream_t st) {
  if (J <= 0) return 0;
  int per = (H + S - 1) / S;
  dim3 grid(cook::grid_for(J, kTopkThreads), S);
  topk_scan_kernel<KT, kStructured><<<grid, kTopkThreads, 0, st>>>(
      res, cmask, valid, exc_id, host_gpu, host_blocked, exc_mask, avail, cap,
      part_fit, part_host, J, H, per);
  int e = cook::last_error();
  if (e != 0) return e;
  topk_merge_kernel<KT><<<cook::grid_for(J), cook::kThreads, 0, st>>>(
      part_fit, part_host, out_fit, out_host, J, k, S);
  return cook::last_error();
}

}  // namespace

// fit[J, k], host[J, k] over a dense mask cmask[J, H] (u8).  part_fit and
// part_host hold S * J * KT entries, KT = 8 when k <= 8, else 16.
COOK_API int topk_dense(const float* res, const uint8_t* cmask,
                        const uint8_t* valid, const float* avail,
                        const float* cap, float* part_fit, int* part_host,
                        float* out_fit, int* out_host, int J, int H, int k,
                        int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > 16 || S < 1) return (int)cudaErrorInvalidValue;
  if (k <= 8)
    return launch<8, false>(res, cmask, valid, nullptr, nullptr, nullptr,
                            nullptr, avail, cap, part_fit, part_host, out_fit,
                            out_host, J, H, k, S, st);
  return launch<16, false>(res, cmask, valid, nullptr, nullptr, nullptr,
                           nullptr, avail, cap, part_fit, part_host, out_fit,
                           out_host, J, H, k, S, st);
}

// The same over the structured mask: host_gpu[H], host_blocked[H] (u8),
// exception rows exc_mask[E, H] (u8) for the jobs with exc_id[j] >= 0.
COOK_API int topk_structured(const float* res, const uint8_t* valid,
                             const int* exc_id, const uint8_t* host_gpu,
                             const uint8_t* host_blocked,
                             const uint8_t* exc_mask, const float* avail,
                             const float* cap, float* part_fit, int* part_host,
                             float* out_fit, int* out_host, int J, int H,
                             int k, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k < 1 || k > 16 || S < 1) return (int)cudaErrorInvalidValue;
  if (k <= 8)
    return launch<8, true>(res, nullptr, valid, exc_id, host_gpu,
                           host_blocked, exc_mask, avail, cap, part_fit,
                           part_host, out_fit, out_host, J, H, k, S, st);
  return launch<16, true>(res, nullptr, valid, exc_id, host_gpu, host_blocked,
                          exc_mask, avail, cap, part_fit, part_host, out_fit,
                          out_host, J, H, k, S, st);
}
