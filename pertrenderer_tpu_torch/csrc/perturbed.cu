// K8a, K8b and K8c: the staged route's Monte-Carlo estimators
// (ops/perturbed_kernels.py holds the wrappers and the plain versions).
//
// K8a replaces _ph_mean_kernel and _ph_coeff_kernel
// (pertrenderer_tpu/ops/perturbed_pallas.py:133,148; pallas_call in _ph_call
// at :171): elementwise over the (N, H, W, K) coverage distances,
//   mean_s H(d + sigma Z_s)                                   (forward)
//   mean_s (H(d + sigma Z_s) - vr H(d)) score(Z_s) / sigma     (backward).
// K8b replaces _pa_mean_kernel (:223; pallas_call in argmax_mean_pallas at
// :289): per pixel of the (N, H, W, C = K + 1) z_map,
//   mean_s onehot(z + gamma Z_s >= max_c).
// K8c replaces _pa_grads_kernel (:238; pallas_call in argmax_grads_pallas
// at :317): per pixel, with dot_s = <g, w_s - w0> (w0 the first-wins
// one-hot of z under variance reduction, else 0),
//   grad_z[c]  = sum_s dot_s score(Z_sc) / (S gamma)
//   gterm      = sum_s dot_s (phi_s - 1) / (S gamma),
// phi_s = sum_c Z_sc^2 (gaussian) or sum_c score(Z_sc) Z_sc (cauchy); the
// wrapper sums gterm into the gamma gradient.
//
// Noise: the counter hash of K1 (hash_prng.cuh), keyed by the batch
// element's seed word pair, the sample s, the channel c (hash row) and the
// pixel p (hash position).  So the backward kernels redraw the forward's
// noise and nothing (S, ...)-sized is stored.  The TPU kernels' layout is
// not carried over: no (8, 2048) supertiles, no channel padding with -inf,
// no per-tile reseeding of a stateful generator; the input stays channels
// last, as the staged route makes it.
//
// Design: K8a is one thread per element with the sample loop in registers;
// K8b is one thread per pixel looping over its C channels, with each
// sample's max in an (S, N P) scratch (coalesced along the pixels), and
// then, channel by channel, counts the samples whose perturbed value
// reaches it (2 S C draws per pixel).  K8c is one warp per pixel with the
// pixel's channels across the lanes (argmax_grads_warp): lane l owns
// channels l, l + 32, ..., so the warp reads the pixel's C contiguous
// floats of z and g and writes gz in coalesced lines.  A sample's values
// are drawn once, by the lane that owns the channel, and used at once:
// the sample's max is a warp max (exact in any order, so every >= max
// one-hot keeps its bits), dot_s and phi_s are warp sums in a fixed
// butterfly order, and gz[c] += dot_s score(Z_sc) stays in the lane, in s
// order; nothing per sample outlives its batch.  Samples go in batches of
// kSampleBatch held in registers, whose butterflies interleave; a larger
// S loops over batches.  So K8c makes S C draws per pixel.  The variance-
// reduction baseline w0 is a first-wins warp argmax of z: the larger
// value, the lower channel on ties, as the plain version's torch.argmax.
// A whole warp rather than a group of 16 lanes: at the main path's C = 51
// both leave 13 of 64 channel slots idle, and the half warp would hold
// twice the draws per lane (four channels) for one butterfly step less.
//
// Bound, at the staged cow's shapes (N=4, 256^2, K=50, S=8): K8a moves
// 13.1 M floats in and out (104.9 MB, 0.031 ms at 3.35 TB/s); K8b reads
// and writes the (4, 65536, 51) z_map (107 MB, 0.032 ms); K8c reads z and
// g and writes grad_z and gterm (161.5 MB, 0.048 ms).  The transcendental
// draws (log, sqrt, cos / tan per value) make all three operation-bound in
// practice.
//
// Numerics: -fmad=false and no fast math (_build.py), so every threshold
// d + sigma Z >= 0 and z + gamma Z >= max rounds as the plain version does.
// Exact ties at the max count every tied channel, in the kernel and the
// plain version alike.
//
// The per-element and per-pixel functions use no CUDA intrinsics: with the
// CUDA keywords defined away they compile with a host compiler, which is
// how the tests run them against the reference goldens on the CPU; K8c's
// takes the warp type as a template parameter (warp.cuh), and the tests
// run it with the 32 lanes emulated.
#include <math.h>
#include <stdint.h>

#include "hash_prng.cuh"
#include "warp.cuh"

namespace ptk {

#define PTK_HD __device__ __forceinline__

PTK_HD float draw(int fam, uint32_t s0, uint32_t s1, int s, int c,
                  uint32_t p) {
  return ptt::family_draw(fam, ptt::hash_words(s0, s1, (uint32_t)s,
                                               (uint32_t)c, p));
}

PTK_HD float score(float z, int fam) {
  return fam == ptt::kFamGaussian ? z : 2.0f * z / (1.0f + z * z);
}

// K8a at one element: mode 0 the forward mean, mode 1 the coefficient.
PTK_HD float heaviside_elem(int mode, float d, float sigma, uint32_t s0,
                            uint32_t s1, int c, uint32_t p, int S, int fam,
                            bool vr) {
  const float h0 = mode == 1 && vr && d >= 0.0f ? 1.0f : 0.0f;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const float z = draw(fam, s0, s1, s, c, p);
    const float h = d + sigma * z >= 0.0f ? 1.0f : 0.0f;
    if (mode == 0)
      acc += h;
    else
      acc += (h - h0) * score(z, fam);
  }
  return mode == 0 ? acc * (1.0f / (float)S) : acc / ((float)S * sigma);
}

// Sample s's max over the pixel's channels of z + gamma Z.
PTK_HD float sample_max(const float* z, float gamma, uint32_t s0,
                        uint32_t s1, int s, uint32_t p, int C, int fam) {
  float m = -INFINITY;
  for (int c = 0; c < C; ++c) {
    const float v = z[c] + gamma * draw(fam, s0, s1, s, c, p);
    m = v > m ? v : m;
  }
  return m;
}

// K8b at one pixel: z and out hold its C channels, ms its S maxima (stride
// ms_stride).
PTK_HD void argmax_mean_pixel(const float* z, float* out, float gamma,
                              uint32_t s0, uint32_t s1, uint32_t p, int C,
                              int S, int fam, float* ms, size_t ms_stride) {
  for (int s = 0; s < S; ++s)
    ms[s * ms_stride] = sample_max(z, gamma, s0, s1, s, p, C, fam);
  const float inv_s = 1.0f / (float)S;
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s)
      acc += z[c] + gamma * draw(fam, s0, s1, s, c, p) >= ms[s * ms_stride]
                 ? 1.0f
                 : 0.0f;
    out[c] = acc * inv_s;
  }
}

constexpr int kSampleBatch = 4;   // K8c: samples drawn together

// K8c at one pixel of C channels, its channels across the lanes of warp w
// (lane l owns channel l + 32 j, j < J): z, g and gz point at the pixel.
// Returns the pixel's gamma term (every lane).
template <int J, class Wp>
PTK_HD float argmax_grads_warp(Wp& w, const float* z, const float* g,
                               float* gz, float gamma, uint32_t s0,
                               uint32_t s1, uint32_t p, int C, int S,
                               int fam, bool vr) {
  constexpr int SB = J <= 4 ? kSampleBatch : 1;
  float zl[J], gl[J], acc[J];
  bool on[J];
  for (int j = 0; j < J; ++j) {
    const int c = w.lane + 32 * j;
    on[j] = c < C;
    zl[j] = on[j] ? z[c] : 0.0f;
    gl[j] = on[j] ? g[c] : 0.0f;
    acc[j] = 0.0f;
  }
  int w0 = -1;                     // first channel reaching the max of z
  if (vr) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = 0; j < J; ++j)
      if (on[j] && (bi == 0x7fffffff || zl[j] > bv)) {
        bv = zl[j];
        bi = w.lane + 32 * j;
      }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = w.shfl_xor(bv, o);
      const int oi = w.shfl_xor(bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    w0 = bi;
  }
  float gterm = 0.0f;
  for (int sb = 0; sb < S; sb += SB) {
    PT_MARK(t);
    float e[SB][J], v[SB][J], ml[SB];
    for (int k = 0; k < SB; ++k) {
      ml[k] = -INFINITY;
      for (int j = 0; j < J; ++j) {
        e[k][j] = v[k][j] = 0.0f;
        if (!on[j] || sb + k >= S) continue;
        e[k][j] = draw(fam, s0, s1, sb + k, w.lane + 32 * j, p);
        v[k][j] = zl[j] + gamma * e[k][j];
        ml[k] = v[k][j] > ml[k] ? v[k][j] : ml[k];
      }
    }
    PT_PHASE(0, t);
    for (int o = 16; o > 0; o >>= 1)
      for (int k = 0; k < SB; ++k) ml[k] = fmaxf(ml[k], w.shfl_xor(ml[k], o));
    float dl[SB], pl[SB];
    for (int k = 0; k < SB; ++k) {
      dl[k] = pl[k] = 0.0f;
      for (int j = 0; j < J; ++j) {
        if (!on[j] || sb + k >= S) continue;
        const int c = w.lane + 32 * j;
        const float wv = v[k][j] >= ml[k] ? 1.0f : 0.0f;
        dl[k] += gl[j] * (wv - (c == w0 ? 1.0f : 0.0f));
        pl[k] += fam == ptt::kFamGaussian ? e[k][j] * e[k][j]
                                          : score(e[k][j], fam) * e[k][j];
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      for (int k = 0; k < SB; ++k) {
        dl[k] += w.shfl_xor(dl[k], o);
        pl[k] += w.shfl_xor(pl[k], o);
      }
    for (int k = 0; k < SB; ++k) {
      if (sb + k >= S) continue;
      for (int j = 0; j < J; ++j)
        if (on[j]) acc[j] += dl[k] * score(e[k][j], fam);
      gterm += dl[k] * (pl[k] - 1.0f);
    }
    PT_PHASE(1, t);
  }
  const float sg = (float)S * gamma;
  for (int j = 0; j < J; ++j)
    if (on[j]) gz[w.lane + 32 * j] = acc[j] / sg;
  return gterm / sg;
}

}  // namespace ptk

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void heaviside_kernel(const float* __restrict__ d,
                                 const float* __restrict__ sigma,
                                 const int* __restrict__ seeds,
                                 float* __restrict__ out, int mode,
                                 long long total, long long P, int C, int S,
                                 int fam, int vr) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long pc = P * C;
  const long long n = e / pc, rem = e - n * pc;
  const int c = (int)(rem % C);
  const uint32_t p = (uint32_t)(rem / C);
  out[e] = ptk::heaviside_elem(mode, d[e], *sigma, (uint32_t)seeds[2 * n],
                               (uint32_t)seeds[2 * n + 1], c, p, S, fam,
                               vr != 0);
}

__global__ void argmax_mean_kernel(const float* __restrict__ z,
                                   const float* __restrict__ gamma,
                                   const int* __restrict__ seeds,
                                   float* __restrict__ out,
                                   float* __restrict__ scratch, long long np,
                                   long long P, int C, int S, int fam) {
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= np) return;
  const long long n = q / P;
  ptk::argmax_mean_pixel(z + q * C, out + q * C, *gamma,
                         (uint32_t)seeds[2 * n], (uint32_t)seeds[2 * n + 1],
                         (uint32_t)(q - n * P), C, S, fam, scratch + q,
                         (size_t)np);
}

// K8c: one warp per pixel, kThreads / 32 pixels per block.
template <int J>
__global__ void __launch_bounds__(kThreads)
argmax_grads_kernel(const float* __restrict__ z, const float* __restrict__ g,
                    const float* __restrict__ gamma,
                    const int* __restrict__ seeds, float* __restrict__ gz,
                    float* __restrict__ gterm, long long np, long long P,
                    int C, int S, int fam, int vr) {
  const long long q =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (q >= np) return;                      // uniform over the warp
  ptw::CardWarp w{(int)(threadIdx.x & 31)};
  const long long n = q / P;
  const float t = ptk::argmax_grads_warp<J>(
      w, z + q * C, g + q * C, gz + q * C, *gamma, (uint32_t)seeds[2 * n],
      (uint32_t)seeds[2 * n + 1], (uint32_t)(q - n * P), C, S, fam, vr != 0);
  if (w.lane == 0) gterm[q] = t;
}

unsigned blocks(long long work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int pt_heaviside(const void* d, const void* sigma,
                            const void* seeds, void* out, int mode,
                            long long total, long long p, int c, int s,
                            int fam, int vr, void* stream) {
  if (total == 0) return 0;
  if (blocks(total) > 0x7FFFFFFFu) return (int)cudaErrorInvalidValue;
  heaviside_kernel<<<blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)sigma, (const int*)seeds, (float*)out,
      mode, total, p, c, s, fam, vr);
  return (int)cudaGetLastError();
}

extern "C" int pt_argmax_mean(const void* z, const void* gamma,
                              const void* seeds, void* out, void* scratch,
                              int n, long long p, int c, int s, int fam,
                              void* stream) {
  const long long np = (long long)n * p;
  if (np == 0) return 0;
  argmax_mean_kernel<<<blocks(np), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)gamma, (const int*)seeds, (float*)out,
      (float*)scratch, np, p, c, s, fam);
  return (int)cudaGetLastError();
}

// Channels per lane of K8c's instantiations: ceil(C / 32) rounded up to
// 1, 2, 3, 4, 8 or 16 (C <= 512).
constexpr int kMaxGradChannels = 512;

template <int J>
int launch_argmax_grads(const void* z, const void* g, const void* gamma,
                        const void* seeds, void* gz, void* gterm,
                        long long np, long long p, int c, int s, int fam,
                        int vr, cudaStream_t stream) {
  const long long nb = (np + kThreads / 32 - 1) / (kThreads / 32);
  if (nb > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  argmax_grads_kernel<J><<<(unsigned)nb, kThreads, 0, stream>>>(
      (const float*)z, (const float*)g, (const float*)gamma,
      (const int*)seeds, (float*)gz, (float*)gterm, np, p, c, s, fam, vr);
  return (int)cudaGetLastError();
}

extern "C" int pt_argmax_grads(const void* z, const void* g,
                               const void* gamma, const void* seeds, void* gz,
                               void* gterm, int n, long long p, int c, int s,
                               int fam, int vr, void* stream) {
  const long long np = (long long)n * p;
  if (np == 0) return 0;
  const int J = (c + 31) / 32;
  const cudaStream_t st = (cudaStream_t)stream;
  if (J <= 1)
    return launch_argmax_grads<1>(z, g, gamma, seeds, gz, gterm, np, p, c, s,
                                  fam, vr, st);
  if (J == 2)
    return launch_argmax_grads<2>(z, g, gamma, seeds, gz, gterm, np, p, c, s,
                                  fam, vr, st);
  if (J == 3)
    return launch_argmax_grads<3>(z, g, gamma, seeds, gz, gterm, np, p, c, s,
                                  fam, vr, st);
  if (J == 4)
    return launch_argmax_grads<4>(z, g, gamma, seeds, gz, gterm, np, p, c, s,
                                  fam, vr, st);
  if (J <= 8)
    return launch_argmax_grads<8>(z, g, gamma, seeds, gz, gterm, np, p, c, s,
                                  fam, vr, st);
  if (c <= kMaxGradChannels)
    return launch_argmax_grads<16>(z, g, gamma, seeds, gz, gterm, np, p, c,
                                   s, fam, vr, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef PT_PROFILE
// K8c's phase clocks of a profiling build (draws, the rest), read and
// reset.
extern "C" int pt_k8c_profile(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pt_prof, sizeof(pt_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(pt_prof, zero, sizeof(zero));
}
#endif
#endif
