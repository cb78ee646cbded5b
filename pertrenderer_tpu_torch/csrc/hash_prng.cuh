// Counter-based hash PRNG (murmur3 finalizer), device side.
//
// Port of _mix / _hash_words / _uniform01 / _draw_block in
// pertrenderer_tpu/ops/fused_render.py.  The JAX package writes this
// unsigned arithmetic in int32 (wraparound multiplies, logical shifts);
// here it is uint32_t, which is the same bits.  The uniform stage is an
// integer hash plus a power-of-two scale, so it is bit-exact against
// tests/goldens/prng_goldens.npz; the gaussian / cauchy maps use the
// precise (non fast-math) logf / sqrtf / sinf / cosf / tanf.
//
// Shared by the probe (K1), the fused and stream kernels (K3-K7) and the
// staged estimators (K8a-c), whose backward passes replay the forward's
// noise from the same words.
#pragma once

#include <stdint.h>

namespace ptt {

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Mixed counter for (seed words, sample s, channel row, pixel position).
__device__ __forceinline__ uint32_t hash_words(uint32_t seed0, uint32_t seed1,
                                               uint32_t s, uint32_t row,
                                               uint32_t pos) {
  uint32_t x = mix(pos);
  x = mix(x ^ (seed0 + s * 0x9E3779B9u + row * 0x85EBCA77u));
  return x ^ seed1;
}

// Low 23 bits -> (m + 0.5) * 2^-23 in (0, 1).
__device__ __forceinline__ float uniform01(uint32_t h) {
  return ((float)(h & 0x7FFFFFu) + 0.5f) * 1.1920928955078125e-07f;
}

// The Box-Muller radius of u1: both halves are r cos and r sin.
__device__ __forceinline__ float gaussian_radius(float u1) {
  return sqrtf(-2.0f * logf(u1));
}

// Both Box-Muller outputs of one hash word: the cos half goes to row r,
// the sin half to row r + c/2 of a c-row block.
__device__ __forceinline__ void gaussian_pair(uint32_t x, float* cos_half,
                                              float* sin_half) {
  const float u1 = uniform01(x);
  const float u2 = uniform01(mix(x + 0xBB67AE85u));
  const float r = gaussian_radius(u1);
  const float th = 6.2831854820251465f * u2;   // float32(2 pi)
  *cos_half = r * cosf(th);
  *sin_half = r * sinf(th);
}

__device__ __forceinline__ float uniform_draw(uint32_t x) {
  return uniform01(mix(x + 0x6A09E667u));
}

// Standard cauchy of the uniform u, clamped to +-1e7.
__device__ __forceinline__ float cauchy_value(float u) {
  const float t = tanf(3.1415927410125732f * (u - 0.5f));
  return fminf(fmaxf(t, -1e7f), 1e7f);
}

__device__ __forceinline__ float cauchy_draw(uint32_t x) {
  return cauchy_value(uniform_draw(x));
}

// The staged estimators' families (K8a-c, csrc/perturbed.cu): one value
// per hash word, the maps of _sample in
// pertrenderer_tpu/ops/perturbed_pallas.py.  Gaussian keeps the cos half
// of gaussian_pair.
enum Family { kFamGaussian = 0, kFamCauchy, kFamLogistic, kFamGumbel,
              kFamUniform };

__device__ __forceinline__ float gaussian_draw(uint32_t x) {
  const float u1 = uniform01(x);
  const float u2 = uniform01(mix(x + 0xBB67AE85u));
  return gaussian_radius(u1) * cosf(6.2831854820251465f * u2);
}

// The other families' maps of one uniform u (uniform_draw's).
__device__ __forceinline__ float uniform_value(int family, float u) {
  switch (family) {
    case kFamCauchy: return cauchy_value(u);
    case kFamLogistic: return logf(u) - log1pf(-u);
    case kFamGumbel: return -logf(-logf(u));
    default: return u - 0.5f;
  }
}

// Bounds on |family_draw(family, x)| over every hash word x, one table
// for the kernels that skip the draws whose outcome no draw can change
// (K12's coverage, csrc/binned_warp.cuh; K8a / K8b, csrc/perturbed.cu):
// gaussian sqrt(-2 ln 2^-24) = 5.76812 (u1 >= 2^-24; either Box-Muller
// half), uniform 0.5 (|u - 0.5| <= 0.5 - 2^-24), logistic and gumbel
// ln 2^24 = 16.6355, cauchy its clamp (which prunes only what is 1e7
// gamma below the top, such as masked -inf slots), each with a margin for
// rounding.  tests/test_torch_perturbed_goldens.py evaluates each map
// (gaussian_radius, uniform_value) at every 23-bit uniform and holds its
// maximum below the bound.
constexpr float kBoundGaussian = 5.78f;
constexpr float kBoundCauchy = 1e7f;
constexpr float kBoundLogistic = 16.7f;
constexpr float kBoundGumbel = 16.7f;
constexpr float kBoundUniform = 0.5f;

__device__ __forceinline__ float family_bound(int family) {
  switch (family) {
    case kFamGaussian: return kBoundGaussian;
    case kFamCauchy: return kBoundCauchy;
    case kFamLogistic: return kBoundLogistic;
    case kFamGumbel: return kBoundGumbel;
    default: return kBoundUniform;
  }
}

__device__ __forceinline__ float family_draw(int family, uint32_t x) {
  return family == kFamGaussian ? gaussian_draw(x)
                                : uniform_value(family, uniform_draw(x));
}

}  // namespace ptt
