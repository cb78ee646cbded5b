// Deterministic segment sums: the reduction shared by K9b (csrc/gather.cu)
// and K10b's table gradient (csrc/interp_gather.cu).
//
// out[r, v, j] = sum over the columns p with idx[p] = r of
// g[j, p] (* w_v[p] when weighted), for rows r < rows, channels j < d and
// v < 3 weights (one when unweighted).  The host prepares the column
// order (ops/gather.py `segments`): `order` lists the columns sorted by
// row, ascending p within a row; row r owns order[starts[r] ..
// starts[r + 1]), cut into chunks of `chunk` columns, which are
// chunk_begin[r] .. chunk_begin[r + 1].
//
// Pass 1: one warp per chunk; each lane adds its strided columns in
// ascending order, then a fixed xor butterfly sums the lanes into the
// chunk's partial row.  Pass 2: one thread per output element adds its
// row's chunk partials in ascending order; a row without columns is an
// exact 0.  No atomics, so repeated launches give the same bits.
#pragma once

#include <cuda_runtime.h>

namespace ptseg {
namespace {

template <bool kWeighted>
__global__ void partial_kernel(const float* __restrict__ g,
                               const float* __restrict__ w0,
                               const float* __restrict__ w1,
                               const float* __restrict__ w2,
                               const long long* __restrict__ order,
                               const long long* __restrict__ starts,
                               const long long* __restrict__ chunk_begin,
                               float* __restrict__ partial, long long p_total,
                               int rows, int d, long long n_chunks,
                               int chunk) {
  const long long c =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // c is uniform across a warp, so whole warps leave together.
  if (c >= n_chunks || c >= chunk_begin[rows]) return;
  int lo = 0, hi = rows;  // chunk_begin[lo] <= c < chunk_begin[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_begin[mid] <= c) lo = mid; else hi = mid;
  }
  const long long begin = starts[lo] + (c - chunk_begin[lo]) * chunk;
  const long long stop = begin + chunk;
  const long long end = stop < starts[lo + 1] ? stop : starts[lo + 1];
  const int nv = kWeighted ? 3 : 1;
  float* out = partial + c * (long long)(nv * d);
  for (int v = 0; v < nv; ++v) {
    const float* w = v == 0 ? w0 : (v == 1 ? w1 : w2);
    for (int j = 0; j < d; ++j) {
      const float* gj = g + (long long)j * p_total;
      float acc = 0.0f;
      for (long long s = begin + lane; s < end; s += 32) {
        const long long p = order[s];
        float x = __ldg(gj + p);
        if (kWeighted) x = x * __ldg(w + p);
        acc += x;
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) out[v * d + j] = acc;
    }
  }
}

__global__ void final_kernel(const float* __restrict__ partial,
                             const long long* __restrict__ chunk_begin,
                             float* __restrict__ out, int rows, int width) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * width) return;
  const int r = (int)(i / width), j = (int)(i % width);
  float acc = 0.0f;
  for (long long c = chunk_begin[r]; c < chunk_begin[r + 1]; ++c)
    acc += partial[c * width + j];
  out[i] = acc;
}

// Both passes on `stream`; returns the first launch error (0 if none).
template <bool kWeighted>
inline int segment_sum(const float* g, const float* w0, const float* w1,
                       const float* w2, const long long* order,
                       const long long* starts, const long long* chunk_begin,
                       float* partial, float* out, long long p_total,
                       int rows, int d, long long n_chunks, int chunk,
                       cudaStream_t stream) {
  const int threads = 256;
  const long long warps_per_block = threads / 32;
  if (n_chunks > 0) {
    const long long blocks = (n_chunks + warps_per_block - 1) /
                             warps_per_block;
    partial_kernel<kWeighted><<<(unsigned)blocks, threads, 0, stream>>>(
        g, w0, w1, w2, order, starts, chunk_begin, partial, p_total, rows, d,
        n_chunks, chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int width = (kWeighted ? 3 : 1) * d;
  const long long total = (long long)rows * width;
  if (total > 0) {
    final_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   stream>>>(partial, chunk_begin, out, rows, width);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ptseg
