// K9a: the channel-major row gather, and K9b: its transposed scatter.
//
// K9a replaces _gather_cm_kernel (pertrenderer_tpu/ops/gather.py:59,
// pallas_call at :105): out[:, p] = table[idx[p]] for a row-major (F, D)
// table, zero where idx[p] lies outside [0, F).  On the TPU this is a
// one-hot matmul on the MXU, capped at 8192 rows by VMEM; on Hopper it is
// an indexed load with no cap: one thread per output column p reads its
// row's D contiguous floats through the read-only path (the tables are at
// most a few MB and stay in L2) and writes D values, coalesced along p.
// Bound: bytes — the index, the output and the table once; nothing to
// compute.  The value is table[safe] * valid, as the plain version
// computes it, so the kernel is bit-exact against it.
//
// K9b replaces _scatter_cm_kernel (pertrenderer_tpu/ops/gather.py:121,
// pallas_call at :160): d_table[f] = sum_{p: idx[p] = f} g[:, p], the VJP
// of K9a.  The TPU accumulates a transposed one-hot matmul over pixel
// tiles in a sequential grid; Hopper's blocks run in no order, so the
// reduction is segment_sum.cuh's: the index preparation on the card (the
// valid columns compacted and radix-sorted by row on only the key bits,
// the rows' bounds and a chunk -> row table), then a warp per chunk of a
// row's sorted columns and an in-order pass over the chunks.  Bound:
// bytes — idx twice, the compacted keys a few times, g at the valid
// columns once, the table gradient once; the reads of g are scattered (a
// face's pixels lie apart in the (D, P) layout), so each costs a 32-byte
// sector.

// Numerics: -fmad=false and no fast math (_build.py).
#include <cuda_runtime.h>

#include "segment_sum.cuh"

namespace {

__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const long long* __restrict__ idx,
                                   float* __restrict__ out, long long p_total,
                                   int f, int d) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_total) return;
  const long long i = idx[p];
  const float valid = (i >= 0 && i < f) ? 1.0f : 0.0f;
  const long long safe = i < 0 ? 0 : (i >= f ? f - 1 : i);
  const float* row = table + safe * d;
  for (int j = 0; j < d; ++j) out[(long long)j * p_total + p] =
      __ldg(row + j) * valid;
}

}  // namespace

extern "C" int pt_gather_rows(const void* table, const void* idx, void* out,
                              long long p, int f, int d, void* stream) {
  if (p == 0) return 0;
  const int threads = 256;
  gather_rows_kernel<<<(unsigned)((p + threads - 1) / threads), threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)table, (const long long*)idx, (float*)out, p, f, d);
  return (int)cudaGetLastError();
}

// The index preparation of K9b (segment_sum.cuh `prepare`).
extern "C" int pt_segment_prep(const void* idx, long long p, int f,
                               void* status, void* counts, void* tcount,
                               void* keys_a, void* pos_a, void* keys_b,
                               void* pos_b, void* starts, void* ends,
                               void* chunk_row, void* stream) {
  if (p == 0) return 0;
  return ptseg::prepare((const long long*)idx, p, f, (int*)counts,
                        (unsigned long long*)status, (int*)tcount,
                        (int*)keys_a, (int*)pos_a, (int*)keys_b,
                        (int*)pos_b, (int*)starts, (int*)ends,
                        (int*)chunk_row, (cudaStream_t)stream);
}

extern "C" int pt_scatter_rows(const void* g, const void* order,
                               const void* starts, const void* ends,
                               const void* chunk_row, void* partial,
                               void* out, long long p, int f, int d,
                               long long n_chunks, void* stream) {
  return ptseg::segment_sum<false>(
      (const float*)g, nullptr, nullptr, nullptr, (const int*)order,
      (const int*)starts, (const int*)ends, (const int*)chunk_row,
      (float*)partial, (float*)out, p, f, d, n_chunks, (cudaStream_t)stream);
}
