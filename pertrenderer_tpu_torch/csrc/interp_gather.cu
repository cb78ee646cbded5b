// K10a: the barycentric interpolating gather, and K10b: its table and
// weight gradients.
//
// K10a replaces _fwd_kernel (pertrenderer_tpu/ops/interp_gather.py:75,
// pallas_call at :179):
//   out[:, p] = w0[p] t[idx[p], 0] + w1[p] t[idx[p], 1] + w2[p] t[idx[p], 2]
// for a row-major (F, 3, D) corner table, zero where idx[p] lies outside
// [0, F).  The TPU folds the weights into one-hot matmuls so that the
// (3D, P) corner tensor never reaches HBM; on Hopper one thread per column
// p reads its row's 3D contiguous floats (read-only path, L2-resident) and
// writes the D interpolated values, coalesced along p — nothing but the
// (D, P) result reaches device memory either.  Bound: bytes.  The sum is
// (t0 * (w0 * valid) + t1 * (w1 * valid)) + t2 * (w2 * valid), left to
// right and without contraction, as the plain version evaluates it.
//
// K10b replaces _bwd_tables_kernel (:101, pallas_call :222) and
// _bwd_weights_kernel (:127, pallas_call :243):
//   d_t[f, v] = sum_{p: idx[p] = f} w_v[p] g[:, p]   (segment_sum.cuh)
//   dw_v[p]   = sum_d t[idx[p], v, d] valid[p] g[d, p]   (one thread per p)
// The table gradient is segment_sum.cuh's deterministic segment sum over
// K9b's index preparation (ops/gather.py `segments`); the weight gradient
// is a gather-dot, one thread per column.  Bound: bytes (g is read scattered by the segment
// sum, one 32-byte sector a value).
//
// Numerics: -fmad=false and no fast math (_build.py).
#include <cuda_runtime.h>

#include "segment_sum.cuh"

namespace {

__device__ __forceinline__ long long safe_row(long long i, int f,
                                              float* valid) {
  *valid = (i >= 0 && i < f) ? 1.0f : 0.0f;
  return i < 0 ? 0 : (i >= f ? f - 1 : i);
}

__global__ void interp_fwd_kernel(const float* __restrict__ table,
                                  const long long* __restrict__ idx,
                                  const float* __restrict__ w0,
                                  const float* __restrict__ w1,
                                  const float* __restrict__ w2,
                                  float* __restrict__ out, long long p_total,
                                  int f, int d) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_total) return;
  float valid;
  const long long r = safe_row(idx[p], f, &valid);
  const float a0 = w0[p] * valid, a1 = w1[p] * valid, a2 = w2[p] * valid;
  const float* row = table + r * 3 * d;
  for (int j = 0; j < d; ++j) {
    const float t0 = __ldg(row + j), t1 = __ldg(row + d + j),
                t2 = __ldg(row + 2 * d + j);
    out[(long long)j * p_total + p] = (t0 * a0 + t1 * a1) + t2 * a2;
  }
}

__global__ void interp_bwd_weights_kernel(const float* __restrict__ table,
                                          const long long* __restrict__ idx,
                                          const float* __restrict__ g,
                                          float* __restrict__ dw,
                                          long long p_total, int f, int d) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_total) return;
  float valid;
  const long long r = safe_row(idx[p], f, &valid);
  const float* row = table + r * 3 * d;
  for (int v = 0; v < 3; ++v) {
    float acc = 0.0f;
    for (int j = 0; j < d; ++j)
      acc += (__ldg(row + v * d + j) * valid) *
             __ldg(g + (long long)j * p_total + p);
    dw[(long long)v * p_total + p] = acc;
  }
}

}  // namespace

extern "C" int pt_interp_rows(const void* table, const void* idx,
                              const void* w0, const void* w1, const void* w2,
                              void* out, long long p, int f, int d,
                              void* stream) {
  if (p == 0) return 0;
  const int threads = 256;
  interp_fwd_kernel<<<(unsigned)((p + threads - 1) / threads), threads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)table, (const long long*)idx, (const float*)w0,
      (const float*)w1, (const float*)w2, (float*)out, p, f, d);
  return (int)cudaGetLastError();
}

extern "C" int pt_interp_rows_bwd_tables(
    const void* g, const void* w0, const void* w1, const void* w2,
    const void* order, const void* starts, const void* ends,
    const void* chunk_row, void* partial, void* d_table, long long p, int f,
    int d, long long n_chunks, void* stream) {
  return ptseg::segment_sum<true>(
      (const float*)g, (const float*)w0, (const float*)w1, (const float*)w2,
      (const int*)order, (const int*)starts, (const int*)ends,
      (const int*)chunk_row, (float*)partial, (float*)d_table, p, f, d,
      n_chunks, (cudaStream_t)stream);
}

extern "C" int pt_interp_rows_bwd_weights(const void* table, const void* idx,
                                          const void* g, void* dw,
                                          long long p, int f, int d,
                                          void* stream) {
  if (p == 0) return 0;
  const int threads = 256;
  interp_bwd_weights_kernel<<<(unsigned)((p + threads - 1) / threads),
                              threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const long long*)idx, (const float*)g,
      (float*)dw, p, f, d);
  return (int)cudaGetLastError();
}
