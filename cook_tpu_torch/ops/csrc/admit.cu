// K4 admit, the one launch of its own: _compact_outputs (sharded.py:355)
// as it runs inside ops/pallas_cycle.py::_kernel.  Every other K4 stage
// is the prologue or epilogue of a K2 launch (admit.cuh, scan.cu).
//
// One plain elementwise launch over max(S * n, S * C) threads, after the
// compaction scan (k24_compact): each slot's match inputs from its
// admitted row, and queue_rows past n_queue set to n.  Bound: bytes.
#include "admit.cuh"

namespace {

using cook::gtid;
using cook::grid_for;
using cook::kThreads;

__global__ void compact_slots(const int* __restrict__ sel,
                              const int* __restrict__ kk,
                              const int* __restrict__ order,
                              const int* __restrict__ qp,
                              const float* __restrict__ job_res,
                              const int* __restrict__ exc_id,
                              int* __restrict__ queue_rows,
                              int* __restrict__ n_queue,
                              int* __restrict__ cand_row,
                              int* __restrict__ cand_qpos,
                              float* __restrict__ res_c,
                              uint8_t* __restrict__ valid_c,
                              uint8_t* __restrict__ gpu_c,
                              int* __restrict__ eid_c, int S, long long n,
                              int C) {
  const long long i = gtid();
  if (i < S * n) {
    const long long s = i / n;
    if (i % n >= qp[s * n + n - 1]) queue_rows[i] = (int)n;
  }
  if (i >= S * (long long)C) return;
  const long long s = i / C;
  const int c = (int)(i % C);
  const long long last = s * n + n - 1;
  if (c == 0) n_queue[s] = qp[last];
  // slots below min(kk[n - 1], C) hold an admitted row (k24_compact)
  const bool v = c < kk[last];
  const int sl = v ? sel[i] : (int)n;
  const long long cl = s * n + (sl < n - 1 ? sl : n - 1);
  const int ti = order[cl];
  const long long row = s * n + ti;
  cand_row[i] = v ? ti : -1;
  cand_qpos[i] = v ? qp[cl] - 1 : -1;
  for (int r = 0; r < 4; ++r)
    res_c[i * 4 + r] = job_res[row * 4 + r] * bit_f(v);
  valid_c[i] = v;
  gpu_c[i] = job_res[row * 4 + 2] > 0.0f;
  eid_c[i] = exc_id[row];
}

}  // namespace

COOK_API int k4_compact_slots(const int* sel, const int* kk, const int* order,
                              const int* qp, const float* job_res,
                              const int* exc_id, int* queue_rows,
                              int* n_queue, int* cand_row, int* cand_qpos,
                              float* res_c, uint8_t* valid_c, uint8_t* gpu_c,
                              int* eid_c, int S, long long n, int C,
                              void* stream) {
  const long long big = S * n > S * (long long)C ? S * n : S * (long long)C;
  compact_slots<<<grid_for(big), kThreads, 0, (cudaStream_t)stream>>>(
      sel, kk, order, qp, job_res, exc_id, queue_rows, n_queue, cand_row,
      cand_qpos, res_c, valid_c, gpu_c, eid_c, S, n, C);
  return cook::last_error();
}
