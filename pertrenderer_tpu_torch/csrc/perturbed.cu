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
// Design.  K8a and K8b draw only where a draw can change the result.
// Every family's draws are bounded, |Z| <= B (hash_prng.cuh's
// family_bound, the table K12 prunes its coverage draws by), and IEEE
// rounding is monotone, so with sb = fl(|sigma| B) an element with d > sb
// has d + sigma Z >= 0 for every draw and one with d < -sb none; with gb =
// fl(|gamma| B) a channel with fl(z_c + gb) < fl(z_top - gb) stays below
// the top channel's perturbed value in every sample and never reaches a
// sample's max.  Those outcomes are written without a draw, by the same
// expressions as the plain versions, so they keep the plain versions'
// bits.
//
// K8a (heaviside_strip): each warp takes a strip of kStripLines
// 32-element lines of the flat (N, P, C) distances and reads them line by
// line (coalesced); each lane writes its element's certain value at once
// (mean: 1 or 0; coefficient: 0, except above the band without variance
// reduction, where h = 1 and sum_s score(Z_s) still needs the draws) or
// draws it in place through heaviside_elem, its own S loop in s order, so
// every drawn element keeps the per-element arithmetic and sum order.  At
// the staged cow's shapes 17.7% of the elements lie in the gaussian band
// (73% are empty slots at d = +1).  Packing the band elements 32 to a
// pass through a shared-memory queue measured the same on the card, so
// the lanes draw where they stand.
//
// K8b (argmax_mean_warp): one warp per pixel, the pixel's channels across
// the lanes (z read and out written in coalesced lines, no scratch).  The
// warp max of z gives the certainty test; the candidates are compacted by
// ballots into the warp's list.  One candidate writes S 1 / S, the others
// 0, with no draw (77% of the cow's pixels).  Up to 32 candidates: the
// lanes are (sample, candidate) pairs, G lanes per sample (G the power of
// two >= the count, 32 / G samples per pass), each sample's max a
// butterfly within its G lanes (a max is exact in any order), each lane
// counting its candidate's hits; the counts, integers, are then summed
// over the groups.  Above 32 (no workload's pixel has more than ~20): the
// lane's own channels, two draws per candidate and sample, the hits
// counted in out.  So K8b draws S times per candidate up to 32.
//
// K8c is one warp per pixel with the
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
// Above 16 channels per lane (C > 512) argmax_grads_wide loops over the
// lane's channels sample by sample, drawing each value three times (the
// max, dot and phi, the accumulation) and keeping gz's sums in gz.
//
// Bound, at the staged cow's shapes (N=4, 256^2, K=50, S=8): K8a moves
// 13.1 M floats in and out (104.9 MB, 0.031 ms at 3.35 TB/s); K8b reads
// and writes the (4, 65536, 51) z_map (107 MB, 0.032 ms); K8c reads z and
// g and writes grad_z and gterm (161.5 MB, 0.048 ms).  The transcendental
// draws (log, sqrt, cos / tan per value) made all three operation-bound
// when every value was drawn; K8a and K8b now draw ~18% of the elements
// and ~3.7 of 51 channels per pixel.
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
#pragma unroll 4
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

// K8b at one pixel of C channels across the lanes of warp w (z and out
// point at the pixel; list: the warp's 32 ints).
template <class Wp>
PTK_HD void argmax_mean_warp(Wp& w, const float* z, float* out, float gamma,
                             uint32_t s0, uint32_t s1, uint32_t p, int C,
                             int S, int fam, int* list) {
  const float inv_s = 1.0f / (float)S;
  float top = -INFINITY;
  for (int c = w.lane; c < C; c += 32) top = z[c] > top ? z[c] : top;
  top = ptw::wmax(w, top);
  const float gb = fabsf(gamma) * ptt::family_bound(fam);
  const float lo = top - gb;
  // The candidates, compacted in channel order; the rest write 0.
  const unsigned lt = (1u << w.lane) - 1u;
  int nc = 0;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + w.lane;
    const bool cand = c < C && !(z[c] + gb < lo);
    if (c < C && !cand) out[c] = 0.0f;
    const unsigned bal = w.ballot(cand);
    const int k = nc + ptw::pt_popc(bal & lt);
    if (cand && k < 32) list[k] = c;
    nc += ptw::pt_popc(bal);
  }
  w.sync();
  if (nc == 1) {
    if (w.lane == 0) out[list[0]] = (float)S * inv_s;
  } else if (nc <= 32) {
    int G = 2;
    while (G < nc) G <<= 1;
    const int k = w.lane & (G - 1), grp = w.lane / G, per = 32 / G;
    const int c = k < nc ? list[k] : -1;
    const float zc = c >= 0 ? z[c] : 0.0f;
    int hits = 0;
    for (int sb = 0; sb < S; sb += per) {
      const int s = sb + grp;
      const bool on = c >= 0 && s < S;
      const float v =
          on ? zc + gamma * draw(fam, s0, s1, s, c, p) : -INFINITY;
      float m = v;
      for (int o = 1; o < G; o <<= 1) m = fmaxf(m, w.shfl_xor(m, o));
      hits += on && v >= m ? 1 : 0;
    }
    for (int o = G; o < 32; o <<= 1) hits += w.shfl_xor(hits, o);
    if (w.lane < nc) out[c] = (float)hits * inv_s;
  } else {
    for (int c = w.lane; c < C; c += 32)
      if (!(z[c] + gb < lo)) out[c] = 0.0f;
    for (int s = 0; s < S; ++s) {
      float m = -INFINITY;
      for (int c = w.lane; c < C; c += 32)
        if (!(z[c] + gb < lo))
          m = fmaxf(m, z[c] + gamma * draw(fam, s0, s1, s, c, p));
      m = ptw::wmax(w, m);
      for (int c = w.lane; c < C; c += 32)
        if (!(z[c] + gb < lo) &&
            z[c] + gamma * draw(fam, s0, s1, s, c, p) >= m)
          out[c] += 1.0f;
    }
    for (int c = w.lane; c < C; c += 32)
      if (!(z[c] + gb < lo)) out[c] = out[c] * inv_s;
  }
  w.sync();
}

constexpr int kStripLines = 4;   // K8a: 32-element lines in a warp's strip

// K8a at element e of the flat (N, P, C) input: its batch element,
// channel and pixel (32-bit division where the input allows).
PTK_HD float heaviside_at(int mode, const float* d, float sigma,
                          const int* seeds, long long e, long long P, int C,
                          int S, int fam, bool vr, bool narrow) {
  long long n, c, p;
  if (narrow) {
    const uint32_t pc = (uint32_t)(P * C), u = (uint32_t)e;
    const uint32_t nn = u / pc, rem = u - nn * pc;
    n = nn;
    c = rem % (uint32_t)C;
    p = rem / (uint32_t)C;
  } else {
    const long long pc = P * C;
    n = e / pc;
    const long long rem = e - n * pc;
    c = rem % C;
    p = rem / C;
  }
  return heaviside_elem(mode, d[e], sigma, (uint32_t)seeds[2 * n],
                        (uint32_t)seeds[2 * n + 1], (int)c, (uint32_t)p, S,
                        fam, vr);
}

// K8a over the elements [e0, e1) of the flat (N, P, C) input, lane `lane`
// of the warp taking every 32nd (narrow: every element index and P C
// below 2^32).
PTK_HD void heaviside_strip(int lane, int mode, const float* d, float* out,
                            float sigma, const int* seeds, long long e0,
                            long long e1, long long P, int C, int S, int fam,
                            bool vr, bool narrow) {
  const float sb = fabsf(sigma) * ptt::family_bound(fam);
  // Above the band h = 1 for every draw: the mean is 1 and the coefficient
  // 0 under variance reduction; without it sum_s score(Z_s) needs the
  // draws.  Below, h = 0: the mean and the coefficient are 0.
  const bool draw_above = mode == 1 && !vr;
  const float inv_s = 1.0f / (float)S;
  const float ss = (float)S * sigma;
  const float above = mode == 0 ? (float)S * inv_s : 0.0f / ss;
  const float below = mode == 0 ? 0.0f * inv_s : 0.0f / ss;
  for (long long e = e0 + lane; e < e1; e += 32) {
    const float x = d[e];
    if (x < -sb)
      out[e] = below;
    else if (x > sb && !draw_above)
      out[e] = above;
    else
      out[e] = heaviside_at(mode, d, sigma, seeds, e, P, C, S, fam, vr,
                            narrow);
  }
}

constexpr int kSampleBatch = 4;   // K8c: samples drawn together

// The first channel reaching the warp's max: each lane's (value, channel)
// candidate, the larger value and then the lower channel winning.
template <class Wp>
PTK_HD int first_max(Wp& w, float bv, int bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = w.shfl_xor(bv, o);
    const int oi = w.shfl_xor(bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  return bi;
}

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
    w0 = first_max(w, bv, bi);
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

// K8c at one pixel with more than 16 channels per lane: the lane's
// channels l, l + 32, ... one at a time, sample by sample; the sample's
// draws, warp max and sums in the order of argmax_grads_warp, each value
// drawn three times, gz's sums kept in gz.
template <class Wp>
PTK_HD float argmax_grads_wide(Wp& w, const float* z, const float* g,
                               float* gz, float gamma, uint32_t s0,
                               uint32_t s1, uint32_t p, int C, int S,
                               int fam, bool vr) {
  int w0 = -1;
  if (vr) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int c = w.lane; c < C; c += 32)
      if (bi == 0x7fffffff || z[c] > bv) {
        bv = z[c];
        bi = c;
      }
    w0 = first_max(w, bv, bi);
  }
  for (int c = w.lane; c < C; c += 32) gz[c] = 0.0f;
  float gterm = 0.0f;
  for (int s = 0; s < S; ++s) {
    float ml = -INFINITY;
    for (int c = w.lane; c < C; c += 32) {
      const float v = z[c] + gamma * draw(fam, s0, s1, s, c, p);
      ml = v > ml ? v : ml;
    }
    for (int o = 16; o > 0; o >>= 1) ml = fmaxf(ml, w.shfl_xor(ml, o));
    float dl = 0.0f, pl = 0.0f;
    for (int c = w.lane; c < C; c += 32) {
      const float e = draw(fam, s0, s1, s, c, p);
      const float wv = z[c] + gamma * e >= ml ? 1.0f : 0.0f;
      dl += g[c] * (wv - (c == w0 ? 1.0f : 0.0f));
      pl += fam == ptt::kFamGaussian ? e * e : score(e, fam) * e;
    }
    for (int o = 16; o > 0; o >>= 1) {
      dl += w.shfl_xor(dl, o);
      pl += w.shfl_xor(pl, o);
    }
    for (int c = w.lane; c < C; c += 32)
      gz[c] += dl * score(draw(fam, s0, s1, s, c, p), fam);
    gterm += dl * (pl - 1.0f);
  }
  const float sg = (float)S * gamma;
  for (int c = w.lane; c < C; c += 32) gz[c] = gz[c] / sg;
  return gterm / sg;
}

}  // namespace ptk

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr int kWarps = kThreads / 32;

// K8a: a strip of kStripLines 32-element lines per warp.
__global__ void __launch_bounds__(kThreads)
heaviside_kernel(const float* __restrict__ d, const float* __restrict__ sigma,
                 const int* __restrict__ seeds, float* __restrict__ out,
                 int mode, long long total, long long P, int C, int S,
                 int fam, int vr) {
  constexpr long long strip = 32ll * ptk::kStripLines;
  const long long e0 =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * strip;
  if (e0 >= total) return;
  ptk::heaviside_strip((int)(threadIdx.x & 31), mode, d, out, *sigma, seeds,
                       e0, e0 + strip < total ? e0 + strip : total, P, C, S,
                       fam, vr != 0, total <= 0xffffffffll);
}

// K8b: one warp per pixel, kWarps pixels per block.
__global__ void __launch_bounds__(kThreads)
argmax_mean_kernel(const float* __restrict__ z,
                   const float* __restrict__ gamma,
                   const int* __restrict__ seeds, float* __restrict__ out,
                   long long np, long long P, int C, int S, int fam) {
  __shared__ int list[kWarps][32];
  const int warp = threadIdx.x >> 5;
  const long long q = (long long)blockIdx.x * kWarps + warp;
  if (q >= np) return;                      // uniform over the warp
  ptw::CardWarp w{(int)(threadIdx.x & 31)};
  const long long n = q / P;
  ptk::argmax_mean_warp(w, z + q * C, out + q * C, *gamma,
                        (uint32_t)seeds[2 * n], (uint32_t)seeds[2 * n + 1],
                        (uint32_t)(q - n * P), C, S, fam, list[warp]);
}

// K8c: one warp per pixel, kThreads / 32 pixels per block; J channels per
// lane in registers, or J = 0 for argmax_grads_wide (C > 512).
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
  const uint32_t s0 = (uint32_t)seeds[2 * n], s1 = (uint32_t)seeds[2 * n + 1];
  const uint32_t p = (uint32_t)(q - n * P);
  float t;
  if constexpr (J > 0)
    t = ptk::argmax_grads_warp<J>(w, z + q * C, g + q * C, gz + q * C,
                                  *gamma, s0, s1, p, C, S, fam, vr != 0);
  else
    t = ptk::argmax_grads_wide(w, z + q * C, g + q * C, gz + q * C, *gamma,
                               s0, s1, p, C, S, fam, vr != 0);
  if (w.lane == 0) gterm[q] = t;
}

}  // namespace

extern "C" int pt_heaviside(const void* d, const void* sigma,
                            const void* seeds, void* out, int mode,
                            long long total, long long p, int c, int s,
                            int fam, int vr, void* stream) {
  if (total == 0) return 0;
  const long long per = 32ll * ptk::kStripLines * kWarps;
  const long long nb = (total + per - 1) / per;
  if (nb > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  heaviside_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)sigma, (const int*)seeds, (float*)out,
      mode, total, p, c, s, fam, vr);
  return (int)cudaGetLastError();
}

extern "C" int pt_argmax_mean(const void* z, const void* gamma,
                              const void* seeds, void* out, int n,
                              long long p, int c, int s, int fam,
                              void* stream) {
  const long long np = (long long)n * p;
  if (np == 0) return 0;
  const long long nb = (np + kWarps - 1) / kWarps;
  if (nb > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  argmax_mean_kernel<<<(unsigned)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)gamma, (const int*)seeds, (float*)out,
      np, p, c, s, fam);
  return (int)cudaGetLastError();
}

// Channels per lane of K8c's instantiations: ceil(C / 32) rounded up to
// 1, 2, 3, 4, 8 or 16; above 512 channels the wide path (J = 0).

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
  if (J <= 16)
    return launch_argmax_grads<16>(z, g, gamma, seeds, gz, gterm, np, p, c,
                                   s, fam, vr, st);
  return launch_argmax_grads<0>(z, g, gamma, seeds, gz, gterm, np, p, c, s,
                                fam, vr, st);
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
