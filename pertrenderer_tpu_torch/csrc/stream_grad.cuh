// The stream route's per-pixel pipeline, shared by K5 (stream_forward.cu),
// K6 (stream_backward.cu) and K7 (stream_loss_grad.cu), as the JAX kernels
// share _stream_chunk_det, _stream_zmap and _stream_grad_impl
// (pertrenderer_tpu/ops/fused_render.py:2083-2636).
//
// A block is one JAX stream tile (8 x 32 pixels, or a strip), one thread
// per pixel.  The tile's chunk list (ascending chunk ids) names the 64-row
// blocks of the sorted face table that can reach it; the block stages each
// into shared memory and every thread runs the chunk's 64 rows for its
// pixel.  Per pixel the state carries across chunks: the alpha product and,
// per aggregation sample, a running first-wins argmax (a later chunk wins
// only when strictly greater; the background row, set first, wins ties) or
// an online softmax.
//
// Noise keys on the absolute sorted row (row_base = chunk id * 64) and the
// absolute pixel: Gaussian rows h and h + 32 of a chunk are the cos and sin
// halves of hash(row_base + h), so rows are drawn in pairs, but every scan
// that picks a winner walks rows 0..63 in order.  The background draws a
// 2-row block at row rw and keeps row 0 (the cos half of hash(rw)).
//
// The gradient kernels run the JAX kernel's two sweeps: B1 replays the
// forward and keeps, per sample, the winner's sorted row, its colour and
// phi (sum of n^2 over all 64 rows of every visited chunk), the hard-argmax
// control variate and nreal (64 per visited chunk); after B1 the per-pixel
// cotangents are fixed; B2 walks the chunks again with the adjoints of the
// aggregation, z_map (no stabilising shift, no clamp), coverage and det1.
// The alpha cotangent uses the exact exclusion products from zcnt (count
// of prob >= 1) and pnz, never ap / (1 - p).
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
constexpr int kMaxS = 64;        // fused_render.MAX_STREAM_SAMPLES

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

// Product of q[0..63] by successive halving (the JAX _prod_rows order).
PT_HD float prod_rows(float (&q)[kChunk]) {
  for (int half = kHalf; half >= 1; half >>= 1)
    for (int i = 0; i < half; ++i) q[i] = q[i] * q[i + half];
  return q[0];
}

// One chunk's rows at one pixel: det1, coverage (with the MC score
// coefficient when asked) and the unshifted z_map.
struct ChunkRows {
  float dist[kChunk], z[kChunk], mk[kChunk];
  float c0[kChunk], c1[kChunk], c2[kChunk];
  float prob[kChunk], coeff[kChunk], zmap[kChunk];
};

PT_HD void chunk_rows(const Params& p, const Tables& T, int b, int cid,
                      float px, float py, bool live, uint32_t pos,
                      bool want_coeff, ChunkRows& R) {
  const float* sc = T.sc;
  for (int r = 0; r < kChunk; ++r) {
    float c3[3];
    face_forward(p, T, r, px, py, live, &R.dist[r], &R.z[r], &R.mk[r], c3);
    R.c0[r] = c3[0];
    R.c1[r] = c3[1];
    R.c2[r] = c3[2];
  }
  const float sigma = sc[kSigma];
  if (p.rast_kind == kRastMC) {
    for (int r = 0; r < kChunk; ++r) R.prob[r] = R.coeff[r] = 0.0f;
    const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 0];
    const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 1];
    const uint32_t base = (uint32_t)(cid * kChunk);
    for (int s = 0; s < p.s_rast; ++s)
      for (int h = 0; h < kHalf; ++h) {
        if (R.mk[h] == 0.0f && R.mk[h + kHalf] == 0.0f) continue;
        float nz[2];
        noise_pair(p.rast_noise, s0, s1, s, base, h, pos, &nz[0], &nz[1]);
        for (int k = 0; k < 2; ++k) {
          const int r = h + k * kHalf;
          const float hv = -R.dist[r] + sigma * nz[k] >= 0.0f ? 1.0f : 0.0f;
          R.prob[r] += hv;
          if (want_coeff) {
            const float h0 = p.rast_vr && -R.dist[r] >= 0.0f ? 1.0f : 0.0f;
            R.coeff[r] += (hv - h0) * score(nz[k], p.rast_noise);
          }
        }
      }
    const float inv_s = 1.0f / (float)p.s_rast;
    const float ss = (float)p.s_rast * sigma;
    for (int r = 0; r < kChunk; ++r) {
      R.prob[r] = R.prob[r] * inv_s * R.mk[r];
      R.coeff[r] = R.coeff[r] / ss;
    }
  } else {
    for (int r = 0; r < kChunk; ++r) {
      const float x = -R.dist[r] / sigma;
      float pr;
      if (p.rast_kind == kRastSoft) {
        pr = 1.0f / (1.0f + expf(-x));
      } else if (p.rast_kind == kRastAffine) {
        pr = fmaxf(x > 0.5f ? 1.0f : x + 0.5f, 0.0f);
      } else {
        pr = -R.dist[r] >= 0.0f ? 1.0f : 0.0f;
      }
      R.prob[r] = pr * R.mk[r];
    }
  }
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const float gal = p.agg_kind == kAggHard ? 1e-6f : sc[kGamma] / sc[kAlpha];
  for (int r = 0; r < kChunk; ++r) {
    const float zinv = (zfar - R.z[r]) / (zfar - znear) * R.mk[r];
    R.zmap[r] = gal * logf(R.prob[r]) + zinv;
  }
}

// The per-pixel state carried across chunks, and after B1 the cotangents.
struct StreamState {
  float alpha, zcnt, pnz;                  // alpha product; exclusion track
  float m, den, num[3];                    // online softmax
  float runmax[kMaxS], phi[kMaxS], winc[kMaxS][3];
  int winid[kMaxS];                        // winner's sorted row (rw: bg)
  float rm0, w0c[3], nreal;                // hard-argmax control variate
  float g_rgb[3], g_alpha, dot_w, dot[kMaxS];
};

PT_HOST_HD int agg_samples(const Params& p) {
  return p.agg_kind == kAggMC ? p.s_agg : 1;
}

// The state before the first chunk: the background channel alone.
PT_HD void state_init(const Params& p, const float* sc, int b, uint32_t pos,
                      StreamState& st) {
  st.alpha = st.pnz = 1.0f;
  st.zcnt = 0.0f;
  for (int c = 0; c < 3; ++c) st.num[c] = st.w0c[c] = sc[kBg + c];
  st.m = p.eps_bg * (1.0f / sc[kGamma]);
  st.den = 1.0f;
  st.rm0 = p.eps_bg;
  st.nreal = 0.0f;
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  for (int s = 0; s < agg_samples(p); ++s) {
    const float n = p.agg_kind == kAggMC
                        ? bg_noise(p.agg_noise, a0, a1, s, p.rw, pos)
                        : 0.0f;
    st.runmax[s] = p.agg_kind == kAggMC ? p.eps_bg + sc[kGamma] * n
                                        : p.eps_bg;
    st.phi[s] = p.agg_kind == kAggMC ? noise_phi(n, p.agg_noise) : 0.0f;
    st.winid[s] = p.rw;
    for (int c = 0; c < 3; ++c) st.winc[s][c] = sc[kBg + c];
  }
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

// One chunk of the forward (K5) or of the replay B1 (REPLAY: also the
// exclusion track when TRACK_ALPHA, the control variate, winner rows, phi
// and nreal).
template <bool REPLAY, bool TRACK_ALPHA>
PT_HD void chunk_forward(const Params& p, const Tables& T, int b, int cid,
                         float px, float py, bool live, uint32_t pos,
                         StreamState& st, ChunkRows& R) {
  const float* sc = T.sc;
  chunk_rows(p, T, b, cid, px, py, live, pos, false, R);
  float q[kChunk];
  for (int r = 0; r < kChunk; ++r) q[r] = 1.0f - R.prob[r];
  st.alpha = st.alpha * prod_rows(q);
  if (TRACK_ALPHA) {
    for (int r = 0; r < kChunk; ++r) {
      const bool one = R.prob[r] >= 1.0f;
      st.zcnt += one ? 1.0f : 0.0f;
      q[r] = one ? 1.0f : 1.0f - R.prob[r];
    }
    st.pnz = st.pnz * prod_rows(q);
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
      num[0] += e * R.c0[r];
      num[1] += e * R.c1[r];
      num[2] += e * R.c2[r];
    }
    st.den = st.den * scale + den;
    for (int c = 0; c < 3; ++c) st.num[c] = st.num[c] * scale + num[c];
    st.m = m_new;
    return;
  }
  if (REPLAY) {                  // the control variate: argmax of z_map
    int win = -1;
    scan_rows(R.zmap, &st.rm0, &win);
    if (win >= 0) {
      st.w0c[0] = R.c0[win];
      st.w0c[1] = R.c1[win];
      st.w0c[2] = R.c2[win];
    }
    st.nreal += (float)kChunk;
  }
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  const uint32_t base = (uint32_t)(cid * kChunk);
  for (int s = 0; s < agg_samples(p); ++s) {
    float val[kChunk];
    if (p.agg_kind == kAggHard) {
      for (int r = 0; r < kChunk; ++r) val[r] = R.zmap[r];
    } else {
      float ph = 0.0f;
      for (int h = 0; h < kHalf; ++h) {
        // The forward skips pairs of dead rows (z_map -inf never wins);
        // the replay needs every draw for phi.
        float nz[2] = {0.0f, 0.0f};
        if (REPLAY || R.mk[h] != 0.0f || R.mk[h + kHalf] != 0.0f)
          noise_pair(p.agg_noise, a0, a1, s, base, h, pos, &nz[0], &nz[1]);
        val[h] = R.zmap[h] + gamma * nz[0];
        val[h + kHalf] = R.zmap[h + kHalf] + gamma * nz[1];
        if (REPLAY)
          ph += noise_phi(nz[0], p.agg_noise) +
                noise_phi(nz[1], p.agg_noise);
      }
      if (REPLAY) st.phi[s] += ph;
    }
    int win = -1;
    scan_rows(val, &st.runmax[s], &win);
    if (win >= 0) {
      st.winid[s] = cid * kChunk + win;
      st.winc[s][0] = R.c0[win];
      st.winc[s][1] = R.c1[win];
      st.winc[s][2] = R.c2[win];
    }
  }
}

PT_HD void state_rgb(const Params& p, const StreamState& st, float rgb[3]) {
  if (p.agg_kind == kAggSoft) {
    for (int c = 0; c < 3; ++c) rgb[c] = st.num[c] / st.den;
    return;
  }
  const int S = agg_samples(p);
  for (int c = 0; c < 3; ++c) {
    float sum = 0.0f;
    for (int s = 0; s < S; ++s) sum += st.winc[s][c];
    rgb[c] = sum / (float)S;
  }
}

// Between the sweeps: the output cotangent (K6: g_out; K7: the image
// loss's, derived in place from the target) and the per-pixel terms of
// the aggregation that need no chunk: background colour, the MC gamma
// term, the softmax background weight.  An inactive tile (active false)
// stops here: background colour gradient (and loss) only.
template <bool LOSS>
PT_HD void stream_post(const Params& p, const float* sc, int b, int pix,
                       bool live, bool active, StreamState& st,
                       PixelAcc& acc) {
  const int npix = p.image_size * p.image_size;
  for (int c = 0; c < 3; ++c) st.g_rgb[c] = 0.0f;
  st.g_alpha = 0.0f;
  if (!live) return;
  if (LOSS) {
    float rgb[3];
    state_rgb(p, st, rgb);
    const float* tg = p.extra + (size_t)b * 3 * npix + pix;
    for (int c = 0; c < 3; ++c) {
      const float d = rgb[c] - tg[(size_t)c * npix];
      if (p.loss_kind == kL2) {
        acc.loss += d * d;
        st.g_rgb[c] = 2.0f * d * p.lscale;
      } else {
        acc.loss += fabsf(d);
        st.g_rgb[c] = (d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f)) *
                      p.lscale;
      }
    }
  } else {
    const float* go = p.extra + ((size_t)b * npix + pix) * 4;
    for (int c = 0; c < 3; ++c) st.g_rgb[c] = go[c];
    st.g_alpha = go[3];
  }
  if (!active) {
    for (int c = 0; c < 3; ++c) acc.gsc[kBg + c] += st.g_rgb[c];
    return;
  }
  const float gamma = sc[kGamma];
  if (p.agg_kind == kAggSoft) {
    float rgb[3];
    state_rgb(p, st, rgb);
    st.dot_w = rgb[0] * st.g_rgb[0] + rgb[1] * st.g_rgb[1] +
               rgb[2] * st.g_rgb[2];
    const float x_bg = p.eps_bg * (1.0f / gamma);
    const float w_bg = expf(x_bg - st.m) / st.den;
    float bgdot = 0.0f;
    for (int c = 0; c < 3; ++c) {
      acc.gsc[kBg + c] += w_bg * st.g_rgb[c];
      bgdot += sc[kBg + c] * st.g_rgb[c];
    }
    const float gb_x = w_bg * (bgdot - st.dot_w);
    // gamma, znear and zfar reach the softmax only through z / gamma, z =
    // eps for the background and z_inv for a row; sum g_x = 0 over both.
    // Each z is taken less c = the pixel's max z_map (m * gamma), exact in
    // real arithmetic, so the rows' sum G = sum g_x (z_inv - c) (in
    // g_invgam, chunk_grads) does not cancel: gamma takes -(G + (eps - c)
    // gb_x) / gamma^2, znear (G - c gb_x) / (gamma zden) and zfar
    // -(G + (1 - c) gb_x) / (gamma zden).  Here the background's share;
    // stream_finish adds G's.
    const float c = st.m * gamma;
    const float gz_den = gamma * (sc[kZfar] - sc[kZnear]);
    acc.gsc[kGamma] += -((p.eps_bg - c) * gb_x) / (gamma * gamma);
    acc.gsc[kZnear] += -(c * gb_x) / gz_den;
    acc.gsc[kZfar] += -((1.0f - c) * gb_x) / gz_den;
    return;
  }
  const int S = agg_samples(p);
  const float comp = (float)p.k - st.nreal;
  float gterm = 0.0f, wbg = 0.0f;
  for (int s = 0; s < S; ++s) {
    float d = 0.0f;
    for (int c = 0; c < 3; ++c) d += (st.winc[s][c] - st.w0c[c]) * st.g_rgb[c];
    st.dot[s] = d;
    gterm += d * (st.phi[s] + comp - 1.0f);
    wbg += st.winid[s] >= p.rw ? 1.0f : 0.0f;
  }
  if (p.agg_kind == kAggMC) acc.gsc[kGamma] += gterm / ((float)S * gamma);
  wbg = wbg / (float)S;
  for (int c = 0; c < 3; ++c) acc.gsc[kBg + c] += wbg * st.g_rgb[c];
}

// One chunk of B2: the adjoints of the aggregation, z_map, the alpha
// product, coverage and det1 for each of the 64 rows, each row's table
// gradient handed to the sink.  Sink (collective over the block on the
// card): begin(cand, r) says whether any pixel has row r as a candidate
// (false: the row's gradient is 0), add / add_cell sum a column across
// pixels, end(r) stores the row.
template <bool TRACK_ALPHA, class Sink>
PT_HD void chunk_grads(const Params& p, const Tables& T, int b, int cid,
                       float px, float py, bool live, uint32_t pos,
                       const StreamState& st, ChunkRows& R, Sink& sink,
                       PixelAcc& acc) {
  const float* sc = T.sc;
  chunk_rows(p, T, b, cid, px, py, live, pos, true, R);
  const float gamma = sc[kGamma];
  const float* g_rgb = st.g_rgb;
  // Aggregation cotangents, per row: z_map (gz) and colour (gc*).
  float gz[kChunk], gc0[kChunk], gc1[kChunk], gc2[kChunk];
  for (int r = 0; r < kChunk; ++r) gz[r] = gc0[r] = gc1[r] = gc2[r] = 0.0f;
  if (p.agg_kind == kAggSoft) {
    // x = log(prob) / alpha + z_inv / gamma: gamma, znear and zfar reach
    // it through z_inv / gamma alone, so g_invgam sums g_x (z_inv - c) (c
    // as stream_post's), and neither the z_map's gamma / alpha factor
    // (stream_finish) nor the rows' z_inv adjoint (below) books them.
    // Apart, the gamma paths are large sums of log(prob) g_x that cancel
    // exactly, and the z_inv adjoints sums of z_inv g_x whose g_x cancel:
    // their float32 rounding was what those gradients kept.
    const float inv_g = 1.0f / gamma;
    const float zshift = st.m * gamma;
    const float zfar = sc[kZfar], znear = sc[kZnear];
    for (int r = 0; r < kChunk; ++r) {
      const float x = R.zmap[r] * inv_g;
      const float wgt = expf(x - st.m) / st.den;
      const float gwr =
          R.c0[r] * g_rgb[0] + R.c1[r] * g_rgb[1] + R.c2[r] * g_rgb[2];
      const float g_x = wgt * (gwr - st.dot_w);
      gz[r] = g_x * inv_g;
      const float zinv = (zfar - R.z[r]) / (zfar - znear) * R.mk[r];
      acc.g_invgam += (isinf(R.zmap[r]) ? 0.0f : zinv - zshift) * g_x;
      gc0[r] = wgt * g_rgb[0];
      gc1[r] = wgt * g_rgb[1];
      gc2[r] = wgt * g_rgb[2];
    }
  } else {
    const int S = agg_samples(p);
    const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
    const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
    const uint32_t base = (uint32_t)(cid * kChunk);
    for (int s = 0; s < S; ++s) {
      const int w = st.winid[s] - cid * kChunk;
      if (w >= 0 && w < kChunk) {
        gc0[w] += g_rgb[0];
        gc1[w] += g_rgb[1];
        gc2[w] += g_rgb[2];
      }
      if (p.agg_kind != kAggMC) continue;
      // Only candidate rows carry the z_map cotangent any further.
      for (int h = 0; h < kHalf; ++h) {
        if (R.mk[h] == 0.0f && R.mk[h + kHalf] == 0.0f) continue;
        float nz[2];
        noise_pair(p.agg_noise, a0, a1, s, base, h, pos, &nz[0], &nz[1]);
        gz[h] += st.dot[s] * score(nz[0], p.agg_noise);
        gz[h + kHalf] += st.dot[s] * score(nz[1], p.agg_noise);
      }
    }
    const float sg = (float)S * gamma;
    for (int r = 0; r < kChunk; ++r) {
      gz[r] = gz[r] / sg;
      gc0[r] = gc0[r] / (float)S;
      gc1[r] = gc1[r] / (float)S;
      gc2[r] = gc2[r] / (float)S;
    }
  }

  const bool hard_agg = p.agg_kind == kAggHard;
  const float gal = hard_agg ? 1e-6f : sc[kGamma] / sc[kAlpha];
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const float zden = zfar - znear;
  const float sigma = sc[kSigma];
  for (int r = 0; r < kChunk; ++r) {
    const bool cand = R.mk[r] != 0.0f;
    if (!sink.begin(cand, r)) continue;
    float gslot[kGeo + 9];
    for (int d = 0; d < kGeo + 9; ++d) gslot[d] = 0.0f;
    int cell = -1;
    float gcell[3] = {0.0f, 0.0f, 0.0f};
    if (cand) {
      const float prob = R.prob[r];
      // z_map = scaled(log prob) + z_inv.
      const float g_zm = gz[r];
      const float lp = logf(prob);
      float g_lp;
      if (hard_agg) {
        g_lp = 1e-6f * g_zm;
      } else {
        const float gy = gal * g_zm;
        g_lp = isnan(gy) ? 0.0f : gy;
        const float term = (isinf(lp) ? 0.0f : lp) * g_zm;
        if (!isnan(term)) acc.g_gal += term;
      }
      float inv = 1.0f / prob;
      if (isinf(inv)) inv = 0.0f;
      float g_prob = inv * g_lp;
      const float g_q = g_zm * R.mk[r];
      const float num = zfar - R.z[r];
      const float g_num = g_q / zden;
      const float g_den = -g_q * num / (zden * zden);
      if (p.agg_kind != kAggSoft) {       // the softmax's: stream_post
        acc.gsc[kZfar] += g_num + g_den;
        acc.gsc[kZnear] -= g_den;
      }
      const float g_z = -g_num;
      if (TRACK_ALPHA) {       // alpha = 1 - prod(1 - p): exclusion products
        const bool one = prob >= 1.0f;
        const float excl =
            one ? (st.zcnt == 1.0f ? st.pnz : 0.0f)
                : (st.zcnt == 0.0f ? st.pnz / (1.0f - prob) : 0.0f);
        g_prob = g_prob + (-st.g_alpha) * (-excl);
      }
      const float g_raw = g_prob * R.mk[r];
      float g_dist = 0.0f;
      if (p.rast_kind == kRastMC) {
        const float g_d = R.coeff[r] * g_raw;
        g_dist = -g_d;
        acc.gsc[kSigma] += g_d;
      } else if (p.rast_kind != kRastHard) {
        const float nd = -R.dist[r];
        const float x = nd / sigma;
        float g_x;
        if (p.rast_kind == kRastSoft) {
          g_x = g_raw * prob * (1.0f - prob);
        } else {
          const float p1 = x > 0.5f ? 1.0f : x + 0.5f;
          g_x = x > 0.5f ? 0.0f : g_raw * tie_max(p1, 0.0f);
        }
        g_dist = -(g_x / sigma);
        acc.gsc[kSigma] += -g_x * nd / (sigma * sigma);
      }
      const float g_col[3] = {gc0[r], gc1[r], gc2[r]};
      face_backward(p, T, r, px, py, g_dist, g_z, g_col, gslot, &cell, gcell,
                    acc.gsc);
    }
    for (int d = 0; d < 9; ++d) sink.add(d, gslot[d]);
    if (p.phong)
      for (int d = 9; d < kGeo; ++d) sink.add(d, gslot[d]);
    const int dense = p.atlas_r == 0 ? 9 : (p.atlas_r == 1 ? 3 : 0);
    for (int d = kGeo; d < kGeo + dense; ++d) sink.add(d, gslot[d]);
    if (p.atlas_r > 1) sink.add_cell(kGeo, cand, cell, gcell);
    sink.end(r);
  }
}

// A thread's scalar sums across its chunks, in double.  Each step adds
// into a float PixelAcc (face_backward's interface), folded here after
// the step: the sums run over every visited row of every chunk and
// cancel (the softmax's 1 / gamma term sums z_map times a weight
// deviation), so a float running sum would lose the digits that decide
// the result.
struct StreamAcc {
  double gsc[kNS];
  double g_gal, g_invgam, loss;
};

PT_HD void acc_clear(PixelAcc& a) {
  for (int k = 0; k < kNS; ++k) a.gsc[k] = 0.0f;
  a.g_gal = a.g_invgam = a.loss = 0.0f;
}

PT_HD void acc_clear(StreamAcc& a) {
  for (int k = 0; k < kNS; ++k) a.gsc[k] = 0.0;
  a.g_gal = a.g_invgam = a.loss = 0.0;
}

PT_HD void acc_fold(StreamAcc& total, PixelAcc& step) {
  for (int k = 0; k < kNS; ++k) total.gsc[k] += (double)step.gsc[k];
  total.g_gal += (double)step.g_gal;
  total.g_invgam += (double)step.g_invgam;
  total.loss += (double)step.loss;
  acc_clear(step);
}

// The thread's scalar sums once every chunk is done: the z_map's
// gamma / alpha factor (gamma's share only for the argmax aggregations:
// the softmax's is in its 1 / gamma term, see chunk_grads), the
// softmax's 1 / gamma, and its znear / zfar from the same sum.
PT_HD void stream_finish(const Params& p, const float* sc, StreamAcc& acc) {
  const double gamma = sc[kGamma], alpha = sc[kAlpha];
  if (p.agg_kind != kAggHard) {
    if (p.agg_kind != kAggSoft) acc.gsc[kGamma] += acc.g_gal / alpha;
    acc.gsc[kAlpha] += -acc.g_gal * gamma / (alpha * alpha);
  }
  acc.gsc[kGamma] += -acc.g_invgam / (gamma * gamma);
  if (p.agg_kind == kAggSoft) {        // G's share (stream_post)
    const double gz_den = gamma * ((double)sc[kZfar] - (double)sc[kZnear]);
    acc.gsc[kZnear] += acc.g_invgam / gz_den;
    acc.gsc[kZfar] += -acc.g_invgam / gz_den;
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

// A row's gradient summed over the block's pixels: warp butterflies, one
// row of `red` per warp, then a fixed-order sum over the warps.  No
// atomics: the same bits on every run.
struct BlockSink {
  float* red;     // shared: [warps][D]
  float* out;     // this visit's (64, D) partial rows
  int D, lane, warp, warps;
  bool warp_any;
  __device__ bool begin(bool cand, int r) {
    if (!__syncthreads_or(cand)) {
      for (int d = threadIdx.x; d < D; d += blockDim.x) out[r * D + d] = 0.0f;
      return false;
    }
    warp_any = __ballot_sync(0xffffffffu, cand) != 0;
    for (int d = lane; d < D; d += 32) red[warp * D + d] = 0.0f;
    __syncwarp();
    return true;
  }
  __device__ void add(int d, float v) {
    if (!warp_any) return;
    v = warp_sum(v);
    if (lane == (d & 31)) red[warp * D + d] = v;
  }
  __device__ void add_cell(int base, bool has, int cell, const float g[3]) {
    unsigned todo = __ballot_sync(0xffffffffu, has);
    while (todo) {
      const int leader = __ffs(todo) - 1;
      const int lc = __shfl_sync(0xffffffffu, cell, leader);
      const bool mine = has && cell == lc;
      for (int c = 0; c < 3; ++c) {
        const float v = warp_sum(mine ? g[c] : 0.0f);
        if (lane == c) red[warp * D + base + lc * 3 + c] = v;
      }
      todo &= ~__ballot_sync(0xffffffffu, mine);
    }
  }
  __device__ void end(int r) {
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float s = 0.0f;
      for (int w = 0; w < warps; ++w) s += red[w * D + d];
      out[r * D + d] = s;
    }
  }
};

// Shared memory of the stream kernels: the staged chunk, the scalars and
// the reduction rows.
inline size_t stream_smem(const Params& p) {
  const int warps = p.p_tile / 32;
  const int red = (kGeo + p.tex_d > kNS + 1 ? kGeo + p.tex_d : kNS + 1);
  return sizeof(float) * ((size_t)kChunk * p.dt + kNS + (size_t)warps * red);
}

template <bool LOSS>
__global__ void __launch_bounds__(256)
stream_grad_kernel(const Params p) {
  extern __shared__ float smem[];
  float* s_blk = smem;
  float* s_sc = smem + kChunk * p.dt;
  float* s_red = s_sc + kNS;
  const int b = blockIdx.y, t = blockIdx.x, tid = (int)threadIdx.x;
  for (int k = tid; k < kNS; k += blockDim.x)
    s_sc[k] = p.scal[(size_t)b * kNS + k];
  __syncthreads();
  bool live;
  const int pix = tile_pixel(p, t, tid, &live);
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;
  const int bt = b * p.nt + t;
  const bool active = p.active[bt] > 0;
  const int n = p.count[bt];
  const int* list = p.rows + (size_t)bt * p.nch;
  PixelAcc acc;
  StreamAcc total;
  acc_clear(acc);
  acc_clear(total);
  StreamState st;
  ChunkRows R;
  state_init(p, s_sc, b, pos, st);
  if (active)
    for (int q = 0; q < n; ++q) {
      stage_chunk(p, b, list[q], s_blk);
      const Tables T = chunk_tables(p, s_blk, s_sc);
      chunk_forward<true, !LOSS>(p, T, b, list[q], px, py, live, pos, st, R);
    }
  stream_post<LOSS>(p, s_sc, b, pix, live, active, st, acc);
  acc_fold(total, acc);
  if (active) {
    const int D = kGeo + p.tex_d;
    BlockSink sink{s_red, nullptr, D, tid & 31, tid >> 5,
                   (int)blockDim.x >> 5, false};
    for (int q = 0; q < n; ++q) {
      stage_chunk(p, b, list[q], s_blk);
      const Tables T = chunk_tables(p, s_blk, s_sc);
      sink.out = p.partial + ((size_t)p.voff[bt] + q) * kChunk * D;
      chunk_grads<!LOSS>(p, T, b, list[q], px, py, live, pos, st, R, sink,
                         acc);
      acc_fold(total, acc);
    }
    stream_finish(p, s_sc, total);
  }
  // The block's scalar gradients and loss: one partial row per tile.
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  for (int k = 0; k <= kNS; ++k) {
    const float v = warp_sum((float)(k < kNS ? total.gsc[k] : total.loss));
    if (lane == 0) s_red[warp * (kNS + 1) + k] = v;
  }
  __syncthreads();
  if (tid <= kNS) {
    float s = 0.0f;
    for (int w = 0; w < warps; ++w) s += s_red[w * (kNS + 1) + tid];
    p.pscal[(size_t)bt * (kNS + 1) + tid] = s;
  }
}

// g_tab (sorted rows): each (batch element, row, column) adds the partial
// rows of its chunk's visits in ascending tile order.
static __global__ void stream_chunk_reduce(const Params p) {
  const int D = kGeo + p.tex_d;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)p.rw * D) return;
  const int b = blockIdx.y;
  const int row = (int)(idx / D), d = (int)(idx % D);
  const int key = b * p.nch + row / kChunk, r = row % kChunk;
  float s = 0.0f;
  for (int k = p.vstart[key]; k < p.vstart[key + 1]; ++k)
    s += p.partial[((size_t)p.vidx[k] * kChunk + r) * D + d];
  p.g_tab[((size_t)b * p.rw + row) * p.dt + d] = s;
}

// g_scal and the loss: the tiles' partial rows in ascending tile order.
static __global__ void stream_scal_reduce(const Params p) {
  const int b = blockIdx.x, j = threadIdx.x;
  if (j > kNS) return;
  float s = 0.0f;
  for (int t = 0; t < p.nt; ++t)
    s += p.pscal[((size_t)b * p.nt + t) * (kNS + 1) + j];
  if (j < kNS)
    p.g_scal[(size_t)b * kNS + j] = s;
  else
    p.loss[b] = s * p.lscale;
}

// The C entries' body: fills Params, launches the gradient kernel and the
// two reductions.  (static per translation unit: K6 and K7 each have one.)
template <bool LOSS>
static int stream_grads_entry(
    const void* tab, const void* rows, const void* count, const void* active,
    const void* voff, const void* vstart, const void* vidx, const void* scal,
    const void* seeds, const void* extra, void* partial, void* pscal,
    void* g_tab, void* g_scal, void* loss, int n, int nt, int nch,
    int p_tile, int tile_w, int rw, int dt, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, int loss_kind, float lscale, void* stream) {
  Params p = {};
  p.tab = (const float*)tab;
  p.rows = (const int*)rows;
  p.count = (const int*)count;
  p.voff = (const int*)voff;
  p.vstart = (const int*)vstart;
  p.vidx = (const int*)vidx;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  p.extra = (const float*)extra;
  p.partial = (float*)partial;
  p.pscal = (float*)pscal;
  p.g_tab = (float*)g_tab;
  p.g_scal = (float*)g_scal;
  p.loss = (float*)loss;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  p.nch = nch;
  p.rw = rw;
  p.dt = dt;
  p.loss_kind = loss_kind;
  p.lscale = LOSS ? lscale : 0.0f;
  if (p_tile % 32 || p_tile > 256 || dt % 4 || agg_samples(p) > kMaxS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = stream_smem(p);
  cudaError_t e = allow_smem(stream_grad_kernel<LOSS>, smem);
  if (e != cudaSuccess) return (int)e;
  stream_grad_kernel<LOSS><<<dim3(nt, n), p_tile, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t cells = (size_t)rw * (kGeo + tex_d);
  stream_chunk_reduce<<<dim3((unsigned)((cells + 255) / 256), n), 256, 0,
                        st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stream_scal_reduce<<<n, 64, 0, st>>>(p);
  return (int)cudaGetLastError();
}
#endif

}  // namespace ptf
