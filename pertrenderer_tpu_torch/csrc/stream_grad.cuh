// The stream route's per-row arithmetic, shared by K5 (stream_forward.cu)
// and the gradient kernels K6 / K7 (stream_warp.cuh), as the JAX kernels
// share _stream_chunk_det, _stream_zmap and _stream_grad_impl
// (pertrenderer_tpu/ops/fused_render.py:2083-2636).
//
// A chunk is 64 rows of the sorted face table (fused_render._stream_tables);
// the kernels put a chunk's rows across the 32 lanes of a warp, lane h
// owning rows h and h + 32 at one pixel (PairRows).
//
// Noise keys on the absolute sorted row (row_base = chunk id * 64) and the
// absolute pixel: Gaussian rows h and h + 32 of a chunk are the cos and sin
// halves of hash(row_base + h), so rows are drawn in pairs (pair_rows: det1,
// coverage and z_map of rows h and h + 32 at one pixel), but every scan
// that picks a winner takes rows 0..63 in order.  The background draws a
// 2-row block at row rw and keeps row 0 (the cos half of hash(rw)).
//
// The functions outside the __CUDACC__ blocks use no CUDA intrinsics: with
// the CUDA keywords defined away they compile with a host compiler, which
// is how the tests hold this arithmetic against the plain PyTorch version
// without a card.
#pragma once

#include "fused_grad.cuh"

namespace ptf {

constexpr int kChunk = 64;
constexpr int kHalf = kChunk / 2;
// Aggregation samples per pass: K5 and K6 / K7's replay hold the running
// argmax of at most kMaxS samples per pixel and run more in passes of
// kMaxS over the chunk list, in s order (stream_passes).
constexpr int kMaxS = 64;

// A staged chunk (64 rows of dt floats: ndc 9 | world 9 | fn 9 | tex tex_d
// | key | padding) as face tables.
PT_HD Tables chunk_tables(const Params& p, const float* blk,
                          const float* sc) {
  Tables t;
  t.ndc = blk;
  t.world = blk + 9;
  t.fn = blk + 18;
  t.tex = blk + kGeo;
  t.valid = blk + kGeo + p.tex_d;
  t.sc = sc;
  t.rs_geo = t.rs_tex = t.rs_valid = p.dt;
  t.key_valid = true;
  return t;
}

// Noise of rows h and h + 32 of a chunk for sample s: the two Box-Muller
// halves of hash(row_base + h), or two Cauchy draws.
PT_HD void noise_pair(int noise, uint32_t s0, uint32_t s1, int s,
                      uint32_t row_base, int h, uint32_t pos, float* lo,
                      float* hi) {
  if (noise == kGaussian) {
    ptt::gaussian_pair(ptt::hash_words(s0, s1, s, row_base + h, pos), lo, hi);
  } else {
    *lo = ptt::cauchy_draw(ptt::hash_words(s0, s1, s, row_base + h, pos));
    *hi = ptt::cauchy_draw(
        ptt::hash_words(s0, s1, s, row_base + h + kHalf, pos));
  }
}

// Row 0 of the background's 2-row noise block at row rw.
PT_HD float bg_noise(int noise, uint32_t s0, uint32_t s1, int s,
                     uint32_t rw, uint32_t pos) {
  float lo, hi;
  noise_pair(noise, s0, s1, s, rw, 0, pos, &lo, &hi);
  return lo;
}

PT_HD float noise_phi(float n, int noise) {   // phi's term of one row
  return noise == kGaussian ? n * n : score(n, noise) * n;
}

// The background's start for aggregation sample s at pixel pos: its
// perturbed z_map (eps alone for the hard argmax) and its phi term.
PT_HD float bg_start(const Params& p, const float* sc, uint32_t a0,
                     uint32_t a1, int s, uint32_t pos, float* phi) {
  if (p.agg_kind != kAggMC) {
    *phi = 0.0f;
    return p.eps_bg;
  }
  const float n = bg_noise(p.agg_noise, a0, a1, s, p.rw, pos);
  *phi = noise_phi(n, p.agg_noise);
  return p.eps_bg + sc[kGamma] * n;
}

PT_HOST_HD int agg_samples(const Params& p) {
  return p.agg_kind == kAggMC ? p.s_agg : 1;
}

// Passes over the chunk list: pass k runs samples [k kMaxS, (k + 1) kMaxS).
PT_HOST_HD int stream_passes(const Params& p) {
  return (agg_samples(p) + kMaxS - 1) / kMaxS;
}

// Rows h (k = 0) and h + 32 (k = 1) of a chunk at one pixel: det1,
// coverage (with the MC score coefficient when asked) and the unshifted
// z_map.  A row that is not a candidate has colour 0 (face_shade masks by
// the candidacy); with shade_all false it is not shaded, which gives the
// same rows but for the sign of a zero colour, and neither wins an argmax
// (z_map -inf) nor weighs in a softmax (weight 0).
struct PairRows {
  float dist[2], z[2], mk[2], col[2][3];
  float prob[2], coeff[2], zmap[2];
};

// det1 of rows h and h + 32: distance, depth, candidacy, colour.
PT_HD void pair_geometry(const Params& p, const Tables& T, int h, float px,
                         float py, bool live, bool shade_all, PairRows& R) {
  for (int k = 0; k < 2; ++k) {
    float w[3];
    face_geometry(p, T, h + k * kHalf, px, py, live, &R.dist[k], &R.z[k],
                  &R.mk[k], w);
    if (shade_all || R.mk[k] != 0.0f)
      face_shade(p, T, h + k * kHalf, R.mk[k], w, R.col[k]);
    else
      R.col[k][0] = R.col[k][1] = R.col[k][2] = 0.0f;
  }
}

// Coverage and z_map of rows h and h + 32 from their counts of hits in
// R.prob (MC) or their det1 (deterministic): prob = hits fl(1 / S) mk,
// the score coefficient over S sigma, z_map = gal log(prob) + z_inv.
PT_HD void pair_finish(const Params& p, const float* sc, PairRows& R) {
  const float sigma = sc[kSigma];
  if (p.rast_kind == kRastMC) {
    const float inv_s = 1.0f / (float)p.s_rast;
    const float ss = (float)p.s_rast * sigma;
    for (int k = 0; k < 2; ++k) {
      R.prob[k] = R.prob[k] * inv_s * R.mk[k];
      R.coeff[k] = R.coeff[k] / ss;
    }
  } else {
    for (int k = 0; k < 2; ++k) {
      const float x = -R.dist[k] / sigma;
      float pr;
      if (p.rast_kind == kRastSoft) {
        pr = 1.0f / (1.0f + expf(-x));
      } else if (p.rast_kind == kRastAffine) {
        pr = fmaxf(x > 0.5f ? 1.0f : x + 0.5f, 0.0f);
      } else {
        pr = -R.dist[k] >= 0.0f ? 1.0f : 0.0f;
      }
      R.prob[k] = pr * R.mk[k];
    }
  }
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const float gal = p.agg_kind == kAggHard ? 1e-6f : sc[kGamma] / sc[kAlpha];
  for (int k = 0; k < 2; ++k) {
    const float zinv = (zfar - R.z[k]) / (zfar - znear) * R.mk[k];
    R.zmap[k] = gal * logf(R.prob[k]) + zinv;
  }
}

// Coverage (with the MC score coefficient when asked) and z_map of rows h
// and h + 32 from their det1: the lane draws its pair's S_rast samples
// when either row is a candidate.
PT_HD void pair_coverage(const Params& p, const float* sc, int b, int cid,
                         int h, uint32_t pos, bool want_coeff, PairRows& R) {
  if (p.rast_kind == kRastMC) {
    const float sigma = sc[kSigma];
    for (int k = 0; k < 2; ++k) R.prob[k] = R.coeff[k] = 0.0f;
    if (R.mk[0] != 0.0f || R.mk[1] != 0.0f) {
      const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 0];
      const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 1];
      const uint32_t base = (uint32_t)(cid * kChunk);
      for (int s = 0; s < p.s_rast; ++s) {
        float nz[2];
        noise_pair(p.rast_noise, s0, s1, s, base, h, pos, &nz[0], &nz[1]);
        for (int k = 0; k < 2; ++k) {
          const float hv = -R.dist[k] + sigma * nz[k] >= 0.0f ? 1.0f : 0.0f;
          R.prob[k] += hv;
          if (want_coeff) {
            const float h0 = p.rast_vr && -R.dist[k] >= 0.0f ? 1.0f : 0.0f;
            R.coeff[k] += (hv - h0) * score(nz[k], p.rast_noise);
          }
        }
      }
    }
  }
  pair_finish(p, sc, R);
}

PT_HD void pair_rows(const Params& p, const Tables& T, int b, int cid, int h,
                     float px, float py, bool live, uint32_t pos,
                     bool want_coeff, bool shade_all, PairRows& R) {
  pair_geometry(p, T, h, px, py, live, shade_all, R);
  pair_coverage(p, T.sc, b, cid, h, pos, want_coeff, R);
}

}  // namespace ptf
