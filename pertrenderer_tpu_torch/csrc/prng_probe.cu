// K1: hash-PRNG identity probe.
//
// Replaces prng_probe (the kernel body at pertrenderer_tpu/ops/
// fused_render.py:263, pallas_call at :270): s blocks of (c, p) noise for
// the seed words seeds[0..1] at pixel positions 7 .. p + 6.
//
// Bound on the H100: nothing — 16K draws, a few microseconds, launch
// overhead.  It exists to pin the PRNG stream that K3 draws from.  One
// thread per hash word: a gaussian thread writes both Box-Muller halves
// (rows r and r + c/2), exactly the row pairing of the JAX _draw_block.
#include <cuda_runtime.h>

#include "hash_prng.cuh"

namespace {

enum Noise { kUniform = 0, kGaussian = 1, kCauchy = 2 };

__global__ void prng_probe_kernel(const int* __restrict__ seeds,
                                  float* __restrict__ out, int noise, int s,
                                  int c, int p) {
  const int rows = noise == kGaussian ? c / 2 : c;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)s * rows * p) return;
  const int col = (int)(i % p);
  const int r = (int)((i / p) % rows);
  const int si = (int)(i / ((long long)p * rows));
  const uint32_t x = ptt::hash_words((uint32_t)seeds[0], (uint32_t)seeds[1],
                                     (uint32_t)si, (uint32_t)r,
                                     (uint32_t)(col + 7));
  float* blk = out + (size_t)si * c * p;
  if (noise == kGaussian) {
    float a, b;
    ptt::gaussian_pair(x, &a, &b);
    blk[(size_t)r * p + col] = a;
    blk[(size_t)(r + c / 2) * p + col] = b;
  } else if (noise == kCauchy) {
    blk[(size_t)r * p + col] = ptt::cauchy_draw(x);
  } else {
    blk[(size_t)r * p + col] = ptt::uniform_draw(x);
  }
}

// Does nothing: the device time of one launch is the card's launch floor,
// the least time any kernel takes, and so K1's bound.
__global__ void empty_kernel() {}

}  // namespace

extern "C" int pt_prng_probe(const void* seeds, void* out, int noise, int s,
                             int c, int p, void* stream) {
  const int rows = noise == kGaussian ? c / 2 : c;
  const long long total = (long long)s * rows * p;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  prng_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)seeds, (float*)out, noise, s, c, p);
  return (int)cudaGetLastError();
}

extern "C" int pt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
