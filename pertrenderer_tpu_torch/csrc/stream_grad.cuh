// The stream route's per-row arithmetic, shared by K5 (stream_forward.cu)
// and the gradient kernels K6 / K7 (stream_warp.cuh), and K5's per-pixel
// forward, as the JAX kernels share _stream_chunk_det, _stream_zmap and
// _stream_grad_impl (pertrenderer_tpu/ops/fused_render.py:2083-2636).
//
// K5: a block is one JAX stream tile (8 x 32 pixels, or a strip), one
// thread per pixel.  The tile's chunk list (ascending chunk ids) names the
// 64-row blocks of the sorted face table that can reach it; the block
// stages each into shared memory and every thread runs the chunk's 64 rows
// for its pixel.  Above kMaxS aggregation samples the block walks the
// list once per kMaxS samples (the alpha product in the first pass only),
// each pass adding its samples' colours to the pixel's running sum in s
// order, so every sample's draws and the image's sum order are those of a
// single pass.  Per pixel the state carries across chunks: the alpha
// product and, per aggregation sample, a running first-wins argmax (a
// later chunk wins only when strictly greater; the background row, set
// first, wins ties) or an online softmax.
//
// Noise keys on the absolute sorted row (row_base = chunk id * 64) and the
// absolute pixel: Gaussian rows h and h + 32 of a chunk are the cos and sin
// halves of hash(row_base + h), so rows are drawn in pairs (pair_rows: det1,
// coverage and z_map of rows h and h + 32 at one pixel), but every scan
// that picks a winner walks rows 0..63 in order.  The background draws a
// 2-row block at row rw and keeps row 0 (the cos half of hash(rw)).
//
// The functions outside the __CUDACC__ block use no CUDA intrinsics: with
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

PT_HD void pair_rows(const Params& p, const Tables& T, int b, int cid, int h,
                     float px, float py, bool live, uint32_t pos,
                     bool want_coeff, bool shade_all, PairRows& R) {
  const float* sc = T.sc;
  for (int k = 0; k < 2; ++k) {
    float w[3];
    face_geometry(p, T, h + k * kHalf, px, py, live, &R.dist[k], &R.z[k],
                  &R.mk[k], w);
    if (shade_all || R.mk[k] != 0.0f)
      face_shade(p, T, h + k * kHalf, R.mk[k], w, R.col[k]);
    else
      R.col[k][0] = R.col[k][1] = R.col[k][2] = 0.0f;
  }
  const float sigma = sc[kSigma];
  if (p.rast_kind == kRastMC) {
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

// ---- K5: one thread per pixel --------------------------------------------

// Product of q[0..63] by successive halving (the JAX _prod_rows order).
PT_HD float prod_rows(float (&q)[kChunk]) {
  for (int half = kHalf; half >= 1; half >>= 1)
    for (int i = 0; i < half; ++i) q[i] = q[i] * q[i + half];
  return q[0];
}

// One chunk's rows at one pixel: candidacy, colour, coverage and z_map.
struct ChunkRows {
  float mk[kChunk], col[kChunk][3], prob[kChunk], zmap[kChunk];
};

PT_HD void chunk_rows(const Params& p, const Tables& T, int b, int cid,
                      float px, float py, bool live, uint32_t pos,
                      ChunkRows& R) {
  for (int h = 0; h < kHalf; ++h) {
    PairRows Q;
    pair_rows(p, T, b, cid, h, px, py, live, pos, false, true, Q);
    for (int k = 0; k < 2; ++k) {
      const int r = h + k * kHalf;
      R.mk[r] = Q.mk[k];
      R.prob[r] = Q.prob[k];
      R.zmap[r] = Q.zmap[k];
      for (int c = 0; c < 3; ++c) R.col[r][c] = Q.col[k][c];
    }
  }
}

// The per-pixel state carried across chunks: the deterministic part
// (pass 0 only), the pass's samples s0 .. s0 + ns - 1, and the colours of
// the earlier passes' samples summed in s order.
struct StreamState {
  float alpha;                             // alpha product
  float m, den, num[3];                    // online softmax
  float runmax[kMaxS], winc[kMaxS][3];     // per-sample running argmax
  int s0, ns;                              // the pass's samples (MULTI)
  float sum[3];                            // earlier passes' colours
};

// The state before the first chunk of pass k: the background channel
// alone.  MULTI: the kernel runs more than one pass (stream_passes > 1);
// without it the state holds every sample, s0 = 0.
template <bool MULTI>
PT_HD void state_init(const Params& p, const float* sc, int b, uint32_t pos,
                      int k, StreamState& st) {
  if (!MULTI || k == 0) {
    st.alpha = 1.0f;
    for (int c = 0; c < 3; ++c) st.num[c] = sc[kBg + c];
    st.m = p.eps_bg * (1.0f / sc[kGamma]);
    st.den = 1.0f;
    if (MULTI)
      for (int c = 0; c < 3; ++c) st.sum[c] = 0.0f;
  }
  const int s0 = MULTI ? k * kMaxS : 0;
  const int ns = MULTI ? min(kMaxS, agg_samples(p) - s0) : agg_samples(p);
  if (MULTI) {
    st.s0 = s0;
    st.ns = ns;
  }
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  for (int i = 0; i < ns; ++i) {
    float phi;
    st.runmax[i] = bg_start(p, sc, a0, a1, s0 + i, pos, &phi);
    for (int c = 0; c < 3; ++c) st.winc[i][c] = sc[kBg + c];
  }
}

// After a pass of a MULTI kernel: its samples' colours into the running
// sum, in s order.
PT_HD void state_pass_end(const Params& p, StreamState& st) {
  if (p.agg_kind == kAggSoft) return;
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < st.ns; ++i) st.sum[c] += st.winc[i][c];
}

// Rows 0..63 in order: a row takes over the running winner only when
// strictly greater, so within the chunk the first row reaching the max
// wins and across chunks an equal later max loses (the JAX
// _first_hot_rows + `m > runmax`).
PT_HD void scan_rows(const float (&val)[kChunk], float* cur, int* win) {
  for (int r = 0; r < kChunk; ++r)
    if (val[r] > *cur) {
      *cur = val[r];
      *win = r;
    }
}

// One chunk of K5's forward at one pixel, for the pass's samples (and the
// alpha product and the softmax in pass 0).
template <bool MULTI>
PT_HD void chunk_forward(const Params& p, const Tables& T, int b, int cid,
                         float px, float py, bool live, uint32_t pos,
                         StreamState& st, ChunkRows& R) {
  const float* sc = T.sc;
  const int s0 = MULTI ? st.s0 : 0, ns = MULTI ? st.ns : agg_samples(p);
  chunk_rows(p, T, b, cid, px, py, live, pos, R);
  if (s0 == 0) {
    float q[kChunk];
    for (int r = 0; r < kChunk; ++r) q[r] = 1.0f - R.prob[r];
    st.alpha = st.alpha * prod_rows(q);
  }
  const float gamma = sc[kGamma];
  if (p.agg_kind == kAggSoft) {
    const float inv_g = 1.0f / gamma;
    float x[kChunk], mc = -INFINITY;
    for (int r = 0; r < kChunk; ++r) {
      x[r] = R.zmap[r] * inv_g;
      mc = fmaxf(mc, x[r]);
    }
    const float m_new = fmaxf(st.m, mc);
    const float scale = expf(st.m - m_new);
    float den = 0.0f, num[3] = {0.0f, 0.0f, 0.0f};
    for (int r = 0; r < kChunk; ++r) {
      const float e = expf(x[r] - m_new);
      den += e;
      for (int c = 0; c < 3; ++c) num[c] += e * R.col[r][c];
    }
    st.den = st.den * scale + den;
    for (int c = 0; c < 3; ++c) st.num[c] = st.num[c] * scale + num[c];
    st.m = m_new;
    return;
  }
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  const uint32_t base = (uint32_t)(cid * kChunk);
  for (int i = 0; i < ns; ++i) {
    const int s = s0 + i;
    float val[kChunk];
    if (p.agg_kind == kAggHard) {
      for (int r = 0; r < kChunk; ++r) val[r] = R.zmap[r];
    } else {
      for (int h = 0; h < kHalf; ++h) {
        // Pairs of dead rows are not drawn: a z_map of -inf never wins.
        float nz[2] = {0.0f, 0.0f};
        if (R.mk[h] != 0.0f || R.mk[h + kHalf] != 0.0f)
          noise_pair(p.agg_noise, a0, a1, s, base, h, pos, &nz[0], &nz[1]);
        val[h] = R.zmap[h] + gamma * nz[0];
        val[h + kHalf] = R.zmap[h + kHalf] + gamma * nz[1];
      }
    }
    int win = -1;
    scan_rows(val, &st.runmax[i], &win);
    if (win >= 0)
      for (int c = 0; c < 3; ++c) st.winc[i][c] = R.col[win][c];
  }
}

// The pixel's colour once every pass is done (one pass: its samples'
// colours summed in s order here).
template <bool MULTI>
PT_HD void state_rgb(const Params& p, const StreamState& st, float rgb[3]) {
  if (p.agg_kind == kAggSoft) {
    for (int c = 0; c < 3; ++c) rgb[c] = st.num[c] / st.den;
    return;
  }
  const int S = agg_samples(p);
  for (int c = 0; c < 3; ++c) {
    float sum = MULTI ? st.sum[c] : 0.0f;
    if (!MULTI)
      for (int s = 0; s < S; ++s) sum += st.winc[s][c];
    rgb[c] = sum / (float)S;
  }
}

#ifdef __CUDACC__
// Stages chunk cid of batch element b into shared memory (the caller
// synchronises before the next stage overwrites it).
__device__ __forceinline__ void stage_chunk(const Params& p, int b, int cid,
                                            float* s_blk) {
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(
      p.tab + ((size_t)b * p.rw + (size_t)cid * kChunk) * p.dt);
  float4* dst = reinterpret_cast<float4*>(s_blk);
  for (int k = threadIdx.x; k < kChunk * p.dt / 4; k += blockDim.x)
    dst[k] = src[k];
  __syncthreads();
}
#endif

}  // namespace ptf
