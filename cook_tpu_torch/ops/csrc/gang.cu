// K6 gang: the gang_min-gated segment reduction over the compacted
// candidate slots (ops/gang.py gang_reduce_body :210-234, reached from
// ops/pallas_cycle.py::_kernel via _gang_reduce_candidates :122).
//
// One CTA per pool: per-gang matched counts and topology min/max by
// integer atomics (exact in any order), a barrier, then each slot's
// verdict.  Bound: bytes, a few KB per pool; launch latency dominates.
#include "common.cuh"

namespace {

constexpr int kGangThreads = 1024;
constexpr int kBig = 1 << 30;

__global__ void gang_kernel(const int* __restrict__ cand_row,
                            const int* __restrict__ cand_assign,
                            const int* __restrict__ gang_id,
                            const int* __restrict__ gang_size,
                            const int* __restrict__ gang_attr,
                            const int* __restrict__ host_topo,
                            int* __restrict__ cnt, int* __restrict__ tmin,
                            int* __restrict__ tmax,
                            int* __restrict__ cand_gang,
                            int* __restrict__ cand_dropped, int C,
                            long long T, int G, int A, int H) {
  int p = blockIdx.x;
  long long pg = (long long)p * G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    cnt[pg + g] = 0;
    tmin[pg + g] = 0x7FFFFFFF;
    tmax[pg + g] = (int)0x80000000;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    long long sc = (long long)p * C + c;
    int row = cand_row[sc];
    int gidc = row >= 0 ? gang_id[(long long)p * T + row] : -1;
    bool member = gidc >= 0;
    int gid = member ? gidc : 0;
    int a = cand_assign[sc];
    bool matched = member && a >= 0;
    if (matched) atomicAdd(&cnt[pg + gid], 1);
    int h = a < 0 ? 0 : (a > H - 1 ? H - 1 : a);
    int topo = host_topo[((long long)p * A + gang_attr[pg + gid]) * H + h];
    atomicMin(&tmin[pg + gid], matched ? topo : kBig);
    atomicMax(&tmax[pg + gid], matched ? topo : -kBig);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    long long sc = (long long)p * C + c;
    int row = cand_row[sc];
    int gidc = row >= 0 ? gang_id[(long long)p * T + row] : -1;
    bool member = gidc >= 0;
    int gid = member ? gidc : 0;
    int a = cand_assign[sc];
    bool matched = member && a >= 0;
    int lo = tmin[pg + gid], hi = tmax[pg + gid];
    bool topo_ok = gang_attr[pg + gid] <= 0 || (lo == hi && lo >= 0);
    bool complete = cnt[pg + gid] >= gang_size[pg + gid] && topo_ok;
    bool dropped = matched && !complete;
    cand_gang[sc] = dropped ? -1 : a;
    cand_dropped[sc] = dropped;
  }
}

}  // namespace

// cnt/tmin/tmax: scratch of P * G ints each.
COOK_API int k6_gang(const int* cand_row, const int* cand_assign,
                     const int* gang_id, const int* gang_size,
                     const int* gang_attr, const int* host_topo, int* cnt,
                     int* tmin, int* tmax, int* cand_gang, int* cand_dropped,
                     int P, int C, long long T, int G, int A, int H,
                     void* stream) {
  gang_kernel<<<P, kGangThreads, 0, (cudaStream_t)stream>>>(
      cand_row, cand_assign, gang_id, gang_size, gang_attr, host_topo, cnt,
      tmin, tmax, cand_gang, cand_dropped, C, T, G, A, H);
  return cook::last_error();
}
