// K1 expand: the wire decode and gathers at the head of
// ops/pallas_cycle.py::_kernel (:155-203, the expand_compact recipe of
// parallel/sharded.py:206) and its phase 0 (:163-168, the per-pool
// running usage, and the quota-group base :211).
//
// * rows codec decode (quant.expand_rows_device), usage / disk gathers
//   from the base mirror, job_res, the per-user gathers of tokens,
//   shares and quota, segment starts and segment-end marks;
// * the exc_rows -> exc_id scatter;
// * host bit unpack (quant.unpack_bits_device) and the u16 fixed-point
//   decode of avail and capacity (quant.expand_fixed_device);
// * pool_base, summed in XLA:CPU's reduce order (windows of 32 from
//   zero, recursively), and group_base, summed over pools in order.
//
// Bound: bytes, about 80 B per task row plus 40 B per host; at T = 128Ki,
// P = 4, H = 8Ki under 50 MB, about 15 us at 3.35 TB/s.
#include "common.cuh"

namespace {

using cook::gtid;
using cook::grid_for;
using cook::kThreads;

constexpr uint8_t kPending = 1, kValid = 2, kUserFirst = 16;

__global__ void expand_tasks(const void* __restrict__ rows, int codec,
                             const uint8_t* __restrict__ flags,
                             const float* __restrict__ res_base,
                             const float* __restrict__ disk_base,
                             const float* __restrict__ tokens_u,
                             const float* __restrict__ shares_u,
                             const float* __restrict__ quota_u,
                             const int* __restrict__ user_rank,
                             float* __restrict__ usage,
                             float* __restrict__ job_res,
                             float* __restrict__ tokens,
                             float* __restrict__ shares,
                             float* __restrict__ quota,
                             uint8_t* __restrict__ start,
                             int* __restrict__ last_mark,
                             int* __restrict__ exc_id, int S, long long T,
                             int U) {
  long long i = gtid();
  if (i >= S * T) return;
  long long s = i / T, t = i % T;
  long long row;
  if (codec == 0)
    row = ((const int*)rows)[i];
  else if (codec == 1)
    row = (long long)((const int16_t*)rows)[i] + t;
  else
    row = (long long)((const int8_t*)rows)[i] + t;
  uint8_t f = flags[i];
  float pend = (f & kPending) ? 1.0f : 0.0f;
  for (int c = 0; c < 4; ++c) {
    float u = res_base[row * 4 + c];
    usage[i * 4 + c] = u;
    if (c < 3) job_res[i * 4 + c] = u * pend;
  }
  job_res[i * 4 + 3] = disk_base[row] * pend;
  int ur = user_rank[i];
  long long uc = s * U + (ur < 0 ? 0 : (ur > U - 1 ? U - 1 : ur));
  tokens[i] = tokens_u[uc];
  for (int c = 0; c < 3; ++c) shares[i * 3 + c] = shares_u[uc * 3 + c];
  for (int c = 0; c < 4; ++c) quota[i * 4 + c] = quota_u[uc * 4 + c];
  start[i] = (f & kUserFirst) || t == 0;
  bool last = t == T - 1 || (flags[i + (t < T - 1 ? 1 : 0)] & kUserFirst);
  last_mark[i] = last ? (int)t : (int)(T - 1);
  exc_id[i] = -1;
}

__global__ void expand_exc(const int* __restrict__ exc_rows,
                           int* __restrict__ exc_id, int S, int E,
                           long long T) {
  long long i = gtid();
  if (i >= (long long)S * E) return;
  long long s = i / E;
  int e = (int)(i % E);
  int r = exc_rows[i];
  if (r >= 0 && r < T) atomicMax(&exc_id[s * T + r], e);
}

struct Scales {
  float v[4];
};

__global__ void expand_hosts(const uint8_t* __restrict__ host_bits,
                             const void* __restrict__ avail_in, int avail_u16,
                             Scales as, const void* __restrict__ cap_in,
                             int cap_u16, Scales cs,
                             uint8_t* __restrict__ host_gpu,
                             uint8_t* __restrict__ host_blocked,
                             float* __restrict__ avail,
                             float* __restrict__ cap, int S, int H, int B) {
  long long i = gtid();
  if (i >= (long long)S * H) return;
  long long s = i / H;
  int h = (int)(i % H);
  int sh = 7 - (h & 7);
  host_gpu[i] = (host_bits[(s * 2 + 0) * B + (h >> 3)] >> sh) & 1;
  host_blocked[i] = (host_bits[(s * 2 + 1) * B + (h >> 3)] >> sh) & 1;
  for (int c = 0; c < 4; ++c) {
    avail[i * 4 + c] =
        avail_u16 ? (float)((const uint16_t*)avail_in)[i * 4 + c] * as.v[c]
                  : ((const float*)avail_in)[i * 4 + c];
    cap[i * 4 + c] =
        cap_u16 ? (float)((const uint16_t*)cap_in)[i * 4 + c] * cs.v[c]
                : ((const float*)cap_in)[i * 4 + c];
  }
}

// one window-of-32 level: out[s, b, c] = ((0 + x[32b]) + x[32b+1]) + ...;
// level 0 reads usage * (valid & ~pending)
__global__ void win32(const float* __restrict__ x,
                      const uint8_t* __restrict__ flags,
                      float* __restrict__ out, int S, long long nk) {
  long long nb = (nk + 31) / 32;
  long long i = gtid();
  if (i >= S * nb * 4) return;
  int c = (int)(i % 4);
  long long sb = i / 4, s = sb / nb, b = sb % nb;
  long long lo = b * 32, hi = lo + 32 < nk ? lo + 32 : nk;
  float acc = 0.0f;
  for (long long t = lo; t < hi; ++t) {
    float v = x[(s * nk + t) * 4 + c];
    if (flags != nullptr) {
      uint8_t f = flags[s * nk + t];
      v = v * (((f & kValid) && !(f & kPending)) ? 1.0f : 0.0f);
    }
    acc = acc + v;
  }
  out[i] = acc;
}

// group_base[s] = sum over pools q, in order, of pool_base[q] where q
// shares s's quota group (windows of 32 past 32 pools, as win32)
__global__ void group_base_k(const float* __restrict__ pool_base,
                             const int* __restrict__ group_id,
                             float* __restrict__ group_base, int S) {
  long long i = gtid();
  if (i >= (long long)S * 4) return;
  int s = (int)(i / 4), c = (int)(i % 4);
  int g = group_id[s];
  float outer = 0.0f;
  float part[32];
  int nw = (S + 31) / 32;
  for (int w = 0; w < nw; ++w) {
    float acc = 0.0f;
    for (int q = w * 32; q < S && q < w * 32 + 32; ++q)
      acc = acc + pool_base[q * 4 + c] *
                      ((group_id[q] == g && g >= 0) ? 1.0f : 0.0f);
    part[w] = acc;
  }
  if (nw == 1) {
    group_base[i] = part[0];
    return;
  }
  for (int w = 0; w < nw; ++w) outer = outer + part[w];
  group_base[i] = outer;
}

}  // namespace

// scratch: S * 4 * (T/32 + T/1024 + ...) floats for the pool-base levels
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
                       float* scratch, int S, long long T, int U, int E, int H,
                       int B, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 32 * 32) return (int)cudaErrorInvalidValue;
  expand_tasks<<<grid_for(S * T), kThreads, 0, st>>>(
      rows, codec, flags, res_base, disk_base, tokens_u, shares_u, quota_u,
      user_rank, usage, job_res, tokens, shares, quota, start, last_mark,
      exc_id, S, T, U);
  if (E > 0)
    expand_exc<<<grid_for((long long)S * E), kThreads, 0, st>>>(
        exc_rows, exc_id, S, E, T);
  Scales as = {{a0, a1, a2, a3}}, cs = {{c0, c1, c2, c3}};
  expand_hosts<<<grid_for((long long)S * H), kThreads, 0, st>>>(
      host_bits, avail_in, avail_u16, as, cap_in, cap_u16, cs, host_gpu,
      host_blocked, avail, cap, S, H, B);
  // pool_base: windows of 32 until one value per pool and column
  const float* x = usage;
  const uint8_t* fl = flags;
  long long nk = T;
  float* buf = scratch;
  while (true) {
    long long nb = (nk + 31) / 32;
    float* out = nb == 1 ? pool_base : buf;
    win32<<<grid_for(S * nb * 4), kThreads, 0, st>>>(x, fl, out, S, nk);
    if (nb == 1) break;
    x = out;
    fl = nullptr;
    buf += S * nb * 4;
    nk = nb;
  }
  group_base_k<<<grid_for((long long)S * 4), kThreads, 0, st>>>(
      pool_base, group_id, group_base, S);
  return cook::last_error();
}
