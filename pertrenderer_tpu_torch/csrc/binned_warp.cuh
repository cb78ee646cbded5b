// K12's per-pixel pipelines with the slots across the lanes of a warp
// (csrc/fused_binned.cu): one warp renders one pixel at a time.
//
// A pixel first finds its candidates: lane l tests slots l, l + 32, ...
// (det1's geometry, face_geometry), a ballot per group of 32 and a
// per-warp list in shared memory compact them in slot order.  The live
// z_map rows are those candidates followed by the background row; lane l
// owns live rows l, l + 32, ... of that list, so a pixel with up to 31
// candidates keeps each row's state (colour, coverage, z_inv, z_map,
// weight, cotangents) in one register per lane.  Slots that are not
// candidates contribute exactly what the flat pipeline gives them (z_inv
// 0, probability 0, weight 0, colour 0, no gradient), so shading, the
// coverage draws and the adjoints run only for candidates.
//
// The noise is the flat pipeline's counter hash keyed by (seed words,
// sample, row, absolute pixel), gaussian rows paired h <-> h + R/2 over an
// R-row block (R = M for coverage, c_zpad for aggregation).  Only the
// draws that can change a result are taken, each for its own row (the
// partner half is not computed): coverage draws for the candidates whose
// outcome some draw can flip (|d| within sigma * kNzMax; the rest hit in
// every sample or in none), aggregation draws for the rows that can win
// (a z_map above -inf).  The rows needing draws are compacted across the
// lanes and the draws reach the rows' lanes through a per-warp row buffer
// in shared memory.  The MC aggregation's backward needs every row up to
// the background (phi, and the z_inv_max clamp's share of g_zmap): the
// lanes draw the block's pairs once each into the row buffer, except at
// a pixel without a candidate under variance reduction (the background
// wins every sample and every score term is exactly 0).  Every value is
// the one the flat pipeline draws.
//
// The maxima, sums, the first-wins row and alpha's product are warp
// reductions in a fixed butterfly order, alpha's prefix / suffix products
// for its adjoint warp scans; so repeated launches give the same bits.
// The aggregation and the adjoints run in double (K12's numerics,
// fused_binned.cu); the per-slot functions are the flat kernels'
// (face_geometry, face_forward, face_backward).
//
// The warp type Wp gives the lane and the warp primitives (warp.cuh):
// CardWarp on the card; the CPU tests compile these functions with the
// lanes emulated.
#pragma once

#include <limits.h>

#include "fused_grad.cuh"
#include "warp.cuh"

namespace ptf {

using namespace ptw;

// Row `row` of sample s's R-row noise block (draw_noise's value): for a
// gaussian row only its half of the Box-Muller pair, by gaussian_pair's
// own expressions.
PT_HD float row_draw(int noise, uint32_t s0, uint32_t s1, int s, int row,
                     int rows, uint32_t pos) {
  if (noise == kGaussian) {
    const int half = rows / 2;
    const int h = row < half ? row : row - half;
    const uint32_t x = ptt::hash_words(s0, s1, s, h, pos);
    const float u1 = ptt::uniform01(x);
    const float u2 = ptt::uniform01(ptt::mix(x + 0xBB67AE85u));
    const float r = sqrtf(-2.0f * logf(u1));
    const float th = 6.2831854820251465f * u2;   // float32(2 pi)
    return row < half ? r * cosf(th) : r * sinf(th);
  }
  return ptt::cauchy_draw(ptt::hash_words(s0, s1, s, row, pos));
}

// A bound on |gaussian draw|: u1 >= 2^-24, so r <= sqrt(-2 ln 2^-24) =
// 5.76812; with a margin for rounding.  A coverage test -d + sigma n >= 0
// with |d| above sigma * kNzMax has the same outcome for every draw.
constexpr double kNzMax = 5.78;

// Lane l's rows among `want` (per list pass u) compacted, in list order,
// into the warp's `items`; returns their count (every lane).
template <int K, class Wp>
PT_HD int compact_rows(Wp& w, const bool want[K], const int row[K],
                       int* items) {
  const unsigned lt = (1u << w.lane) - 1u;
  int n = 0;
  for (int u = 0; u < K; ++u) {
    const unsigned bal = w.ballot(want[u]);
    if (want[u]) items[n + pt_popc(bal & lt)] = row[u];
    n += pt_popc(bal);
  }
  w.sync();
  return n;
}

// A pixel's live z_map rows across the lanes: lane l owns list entries
// q = l + 32 u (u < K): the nc candidates in slot order, then the
// background row (q == nc); row[u] is -1 past it.
template <int MAXF>
struct Live {
  static constexpr int K = MAXF / 32 + 1;
  int nc;
  int row[K];
};

// Candidacy of every slot at (px, py), compacted through the warp's list
// (M ints of shared memory) into L.
template <int MAXF, class Wp>
PT_HD void live_rows(const Params& p, const Tables& T, float px, float py,
                     Wp& w, int* list, Live<MAXF>& L) {
  const int F = p.f_pad;
  const unsigned lt = (1u << w.lane) - 1u;
  int n = 0;
  for (int k = 0; k < (MAXF + 31) / 32; ++k) {
    const int i = 32 * k + w.lane;
    bool c = false;
    if (i < F) {
      // A pixel farther from the face's box than the blur radius is no
      // candidate (its squared edge distance exceeds the blur): skip the
      // geometry.  The margin covers the distance's float rounding.
      const float* v = T.ndc + i * T.rs_geo;
      const float dx = fmaxf(fmaxf(fminf(v[0], fminf(v[3], v[6])) - px,
                                   px - fmaxf(v[0], fmaxf(v[3], v[6]))),
                             0.0f);
      const float dy = fmaxf(fmaxf(fminf(v[1], fminf(v[4], v[7])) - py,
                                   py - fmaxf(v[1], fmaxf(v[4], v[7]))),
                             0.0f);
      const bool far = (double)dx * dx + (double)dy * dy >
                       (double)T.sc[kBlur] * 1.001 + 1e-8;
      if (!far) {
        float d, z, m, bary[3];
        face_geometry(p, T, i, px, py, true, &d, &z, &m, bary);
        c = m != 0.0f;
      }
    }
    const unsigned bal = w.ballot(c);
    if (c) list[n + pt_popc(bal & lt)] = i;
    n += pt_popc(bal);
  }
  w.sync();
  L.nc = n;
  for (int u = 0; u < Live<MAXF>::K; ++u) {
    const int q = w.lane + 32 * u;
    L.row[u] = q < n ? list[q] : (q == n ? p.bg_row : -1);
  }
  w.sync();
}

// log((double)prob) of the MC coverage's S + 1 possible means (hits / S),
// as a table (the kernels' shared memory) that rows_forward and the
// adjoints read instead of taking a double log per candidate; null where
// the coverage is not MC or S exceeds kMaxLogS.
constexpr int kMaxLogS = 64;

PT_HD double log_prob_mean(int hits, int s_rast) {
  const float inv_s = 1.0f / (float)s_rast;
  return log((double)((float)hits * inv_s * 1.0f));
}

PT_HD bool uses_log_table(const Params& p) {
  return p.rast_kind == kRastMC && p.s_rast <= kMaxLogS;
}

PT_HD double log_prob(const double* lgs, int s_rast, float prob) {
  if (lgs == nullptr) return log((double)prob);
  return lgs[(int)(prob * (float)s_rast + 0.5f)];
}

// The per-lane state of a pixel's live rows, and the forward through the
// coverage and z_map shared by the forward and the gradients.
template <int MAXF, class A>
struct RowState {
  static constexpr int K = Live<MAXF>::K;
  Live<MAXF> L;
  float dist[K], zz[K], col[K][3], prob[K], coeff[K];
  A zinv[K], zmap[K];
  A zmax_raw, gal;
  int nk;      // list passes that hold a row: ceil((nc + 1) / 32)
  const double* lgs;   // log_prob's table, or null

  PT_HD bool slot(int u, int lane) const { return lane + 32 * u < L.nc; }
  PT_HD bool live(int u, int lane) const { return lane + 32 * u <= L.nc; }
  PT_HD bool bg(int u, int lane) const { return lane + 32 * u == L.nc; }
};

// det1 (candidates: geometry, texel, shading; the background row its
// colour), the coverage (MC: the mean and, for the gradients, the score
// coefficient from one pass over the noise) and det2.  list (M ints) and
// nzbuf (c_zpad floats): the warp's shared memory.
template <int MAXF, class A, class Wp>
PT_HD void rows_forward(const Params& p, const Tables& T, int b, float px,
                        float py, uint32_t pos, bool want_coeff, Wp& w,
                        int* list, float* nzbuf, const double* lgs,
                        RowState<MAXF, A>& R) {
  constexpr int K = Live<MAXF>::K;
  const int F = p.f_pad, lane = w.lane;
  const float* sc = T.sc;
  PT_MARK(t0);
  R.lgs = lgs;
  live_rows<MAXF>(p, T, px, py, w, list, R.L);
  PT_PHASE(0, t0);
  const int nc = R.L.nc;
  R.nk = (nc + 32) / 32;
  for (int u = 0; u < K; ++u) {
    R.dist[u] = R.zz[u] = R.prob[u] = R.coeff[u] = 0.0f;
    for (int c = 0; c < 3; ++c)
      R.col[u][c] = R.bg(u, lane) ? sc[kBg + c] : 0.0f;
    if (R.slot(u, lane)) {
      float m;
      face_forward(p, T, R.L.row[u], px, py, true, &R.dist[u], &R.zz[u], &m,
                   R.col[u]);
    }
  }
  PT_PHASE(1, t0);
  // Coverage: prob = prob_raw * maskf with maskf 1 for every candidate.
  const float sigma = sc[kSigma];
  if (p.rast_kind == kRastMC) {
    const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 0];
    const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 1];
    float hits[K], cf[K];
    bool draw[K];
    for (int u = 0; u < K; ++u) {
      hits[u] = cf[u] = 0.0f;
      draw[u] = R.slot(u, lane);
      if (!draw[u] || p.rast_noise != kGaussian) continue;
      // An outcome no draw can change: every sample hits, or none does.
      // Its score terms are 0 (the baseline has the same outcome) unless
      // the coefficient runs without variance reduction and every sample
      // hits.
      const double dd = R.dist[u], bound = (double)sigma * kNzMax;
      if (dd > bound) {
        draw[u] = false;
      } else if (-dd > bound && !(want_coeff && !p.rast_vr)) {
        draw[u] = false;
        hits[u] = (float)p.s_rast;
      }
    }
    // The rows that draw, compacted across the lanes: each sample's draws
    // go through the warp's row buffer to the rows' lanes.
    const int nd = compact_rows<K>(w, draw, R.L.row, list);
    for (int s = 0; s < p.s_rast && nd > 0; ++s) {
      for (int j = lane; j < nd; j += 32)
        nzbuf[list[j]] = row_draw(p.rast_noise, s0, s1, s, list[j], F, pos);
      w.sync();
      for (int u = 0; u < K; ++u) {
        if (!draw[u]) continue;
        const float nz = nzbuf[R.L.row[u]];
        const float h = -R.dist[u] + sigma * nz >= 0.0f ? 1.0f : 0.0f;
        hits[u] += h;
        if (want_coeff) {
          const float h0 = p.rast_vr && -R.dist[u] >= 0.0f ? 1.0f : 0.0f;
          cf[u] += (h - h0) * score(nz, p.rast_noise);
        }
      }
      w.sync();
    }
    const float inv_s = 1.0f / (float)p.s_rast;
    const float ss = (float)p.s_rast * sigma;
    for (int u = 0; u < K; ++u)
      if (R.slot(u, lane)) {
        R.prob[u] = hits[u] * inv_s * 1.0f;
        R.coeff[u] = cf[u] / ss;
      }
  } else {
    for (int u = 0; u < K; ++u) {
      if (!R.slot(u, lane)) continue;
      const float x = -R.dist[u] / sigma;
      float pr;
      if (p.rast_kind == kRastSoft) {
        pr = 1.0f / (1.0f + expf(-x));
      } else if (p.rast_kind == kRastAffine) {
        pr = fmaxf(x > 0.5f ? 1.0f : x + 0.5f, 0.0f);
      } else {
        pr = -R.dist[u] >= 0.0f ? 1.0f : 0.0f;
      }
      R.prob[u] = pr * 1.0f;
    }
  }
  PT_PHASE(2, t0);
  // det2: z_map of the live rows; a slot that is no candidate has z_inv
  // 0, which the unclamped max still sees.
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const A zden = (A)zfar - (A)znear;
  A zl = -INFINITY;
  for (int u = 0; u < K; ++u) {
    R.zinv[u] = 0.0;
    if (!R.slot(u, lane)) continue;
    R.zinv[u] = ((A)zfar - R.zz[u]) / zden;
    zl = fmax(zl, R.zinv[u]);
  }
  R.zmax_raw = wmax(w, zl);
  if (nc < F) R.zmax_raw = fmax(R.zmax_raw, (A)0);
  const A zmax = fmax(R.zmax_raw, (A)p.eps_bg);
  R.gal = p.agg_kind == kAggHard ? (A)1e-6f : (A)sc[kGamma] / (A)sc[kAlpha];
  for (int u = 0; u < K; ++u) {
    if (R.slot(u, lane))
      R.zmap[u] = R.gal * log_prob(R.lgs, p.s_rast, R.prob[u]) + R.zinv[u] -
                  zmax;
    else if (R.bg(u, lane))
      R.zmap[u] = (A)p.eps_bg - zmax;
    else
      R.zmap[u] = -INFINITY;
  }
  PT_PHASE(3, t0);
}

// The first live row with the largest z_map (hard aggregation, and the MC
// aggregation's variance-reduction baseline), as a list entry q.
template <int MAXF, class A, class Wp>
PT_HD int first_live_max(const RowState<MAXF, A>& R, Wp& w) {
  constexpr int K = Live<MAXF>::K;
  A ml = -INFINITY;
  for (int u = 0; u < K; ++u)
    if (R.live(u, w.lane)) ml = fmax(ml, R.zmap[u]);
  const A mx = wmax(w, ml);
  int fq = INT_MAX;
  for (int u = 0; u < K; ++u)
    if (R.live(u, w.lane) && R.zmap[u] >= mx)
      fq = min(fq, w.lane + 32 * u);
  return wmin(w, fq);
}

// Softmax or hard aggregation weights of the live rows.
template <int MAXF, class A, class Wp>
PT_HD void det_weights(const Params& p, const float* sc,
                       const RowState<MAXF, A>& R, Wp& w, A wts[]) {
  constexpr int K = Live<MAXF>::K;
  const int lane = w.lane;
  if (p.agg_kind == kAggSoft) {
    const A ig = (A)1 / (A)sc[kGamma];
    A ml = -INFINITY;
    for (int u = 0; u < K; ++u) {
      wts[u] = 0.0;
      if (!R.live(u, lane)) continue;
      wts[u] = ig * R.zmap[u];
      ml = fmax(ml, wts[u]);
    }
    const A mx = wmax(w, ml);
    A sl = 0.0;
    for (int u = 0; u < K; ++u) {
      if (!R.live(u, lane)) continue;
      wts[u] = exp(wts[u] - mx);
      sl += wts[u];
    }
    const A sum = wsum(w, sl);
    for (int u = 0; u < K; ++u)
      if (R.live(u, lane)) wts[u] = wts[u] / sum;
  } else {
    const int first = first_live_max<MAXF>(R, w);
    for (int u = 0; u < K; ++u)
      wts[u] = lane + 32 * u == first ? 1.0 : 0.0;
  }
}

// One pass over the MC aggregation noise of the rows that can win (the
// forward): the >=-max one-hots' mean into wts.
// Rows that can win the MC aggregation: a z_map of -inf or NaN (a slot
// whose coverage is 0) never reaches a sample's max.
template <int MAXF, class A>
PT_HD void can_win(const RowState<MAXF, A>& R, int lane, bool act[]) {
  for (int u = 0; u < Live<MAXF>::K; ++u)
    act[u] = R.live(u, lane) && !isnan(R.zmap[u]) &&
             !(isinf(R.zmap[u]) && R.zmap[u] < 0);
}

template <int MAXF, class A, class Wp>
PT_HD void mc_weights(const Params& p, const float* sc, int b, uint32_t pos,
                      const RowState<MAXF, A>& R, Wp& w, int* list,
                      float* nzbuf, A wts[]) {
  constexpr int K = Live<MAXF>::K;
  const int lane = w.lane;
  for (int u = 0; u < K; ++u) wts[u] = 0.0;
  if (R.L.nc == 0) {               // the background wins every sample
    for (int u = 0; u < K; ++u)
      if (R.bg(u, lane)) wts[u] = (A)p.s_agg;
  } else {
    const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
    const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
    const float gamma = sc[kGamma];
    bool act[K];
    can_win<MAXF>(R, lane, act);
    const int na = compact_rows<K>(w, act, R.L.row, list);
    for (int s = 0; s < p.s_agg; ++s) {
      // The sample's draws of those rows, compacted across the lanes, to
      // the rows' lanes through nzbuf.
      for (int j = lane; j < na; j += 32)
        nzbuf[list[j]] = row_draw(p.agg_noise, a0, a1, s, list[j], p.c_zpad,
                                  pos);
      w.sync();
      A pert[K];
      A pm = -INFINITY;
      for (int u = 0; u < K; ++u) {
        pert[u] = -INFINITY;
        if (!act[u]) continue;
        pert[u] = R.zmap[u] + (A)gamma * nzbuf[R.L.row[u]];
        pm = fmax(pm, pert[u]);
      }
      w.sync();
      const A mx = wmax(w, pm);
      for (int u = 0; u < K; ++u)
        if (act[u]) wts[u] += pert[u] >= mx ? 1.0f : 0.0f;
    }
  }
  const A inv_s = (A)1 / (A)p.s_agg;
  for (int u = 0; u < K; ++u) wts[u] = wts[u] * inv_s;
}

// K12's forward of one pixel (the binned pixel_forward<MAXF, double>):
// RGBA into out[0..3] in every lane.  The caller handles inactive tiles;
// list (M ints) and nzbuf (c_zpad floats) are the warp's shared memory,
// lgs log_prob's table.
template <int MAXF, class Wp>
PT_HD void warp_pixel_forward(const Params& p, const Tables& T, int b,
                              int pix, Wp& w, int* list, float* nzbuf,
                              const double* lgs, float out[4]) {
  using A = double;
  constexpr int K = Live<MAXF>::K;
  const int lane = w.lane;
  const float* sc = T.sc;
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;
  RowState<MAXF, A> R;
  rows_forward<MAXF>(p, T, b, px, py, pos, false, w, list, nzbuf, lgs, R);
  PT_MARK(t0);
  A wts[K];
  if (p.agg_kind == kAggMC)
    mc_weights<MAXF>(p, sc, b, pos, R, w, list, nzbuf, wts);
  else
    det_weights<MAXF>(p, sc, R, w, wts);
  PT_PHASE(4, t0);
  A rl[3] = {0.0, 0.0, 0.0}, ap = 1.0;
  for (int u = 0; u < K; ++u) {
    if (!R.live(u, lane)) continue;
    for (int c = 0; c < 3; ++c) rl[c] += wts[u] * R.col[u][c];
    if (R.slot(u, lane)) ap = ap * ((A)1 - (A)R.prob[u]);
  }
  for (int c = 0; c < 3; ++c) out[c] = (float)wsum(w, rl[c]);
  out[3] = 1.0f - (float)wprod(w, ap);
  PT_PHASE(5, t0);
}

// Gradient rows of one tile: slot i's row of the (M, 27 + tex_d) tables,
// split as the kernels' outputs (ndc, world, normals, texels).
struct GradRows {
  float *ndc, *world, *fn, *tex;
  int tex_d;
  PT_HD void add(int i, int d, float v) {
    if (d < 9)
      ndc[i * 9 + d] += v;
    else if (d < 18)
      world[i * 9 + d - 9] += v;
    else if (d < kGeo)
      fn[i * 9 + d - 18] += v;
    else
      tex[i * tex_d + d - kGeo] += v;
  }
};

// K12's gradient pipeline of one pixel inside the image of an active tile
// (the binned pixel_grads<MAXF, LOSS> with PixelAccT<double>): each lane
// adds its candidates' slot rows into `rows` (a slot belongs to one lane
// at a pixel, so no two lanes touch a row) and its terms of the scalar
// gradients and the loss into its own acc; the pixel-wide terms go to
// lane 0's.  nzbuf: c_zpad floats of per-warp shared memory.
template <int MAXF, bool LOSS, class Wp, class Acc>
PT_HD void warp_pixel_grads(const Params& p, const Tables& T, int b, int pix,
                            Wp& w, int* list, float* nzbuf,
                            const double* lgs, GradRows& rows, Acc& acc) {
  using A = double;
  constexpr int K = Live<MAXF>::K;
  const int lane = w.lane, C = p.c_zpad, bg = p.bg_row;
  const int F = p.f_pad;
  const int npix = p.image_size * p.image_size;
  const float* sc = T.sc;
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;
  RowState<MAXF, A> R;
  rows_forward<MAXF>(p, T, b, px, py, pos, true, w, list, nzbuf, lgs, R);
  const int nc = R.L.nc, nk = R.nk;
  PT_MARK(t0);

  // ---- output cotangent (K4) -----------------------------------------------
  float g_rgb[3] = {0.0f, 0.0f, 0.0f}, g_alpha = 0.0f;
  if (!LOSS) {
    const float* go = p.extra + ((size_t)b * npix + pix) * 4;
    for (int c = 0; c < 3; ++c) g_rgb[c] = go[c];
    g_alpha = go[3];
  }
  A gw[K];
  auto build_gw = [&]() {
    for (int u = 0; u < K; ++u)
      gw[u] = (A)R.col[u][0] * g_rgb[0] + (A)R.col[u][1] * g_rgb[1] +
              (A)R.col[u][2] * g_rgb[2];
  };

  // ---- aggregation: weights, and g_zmap ------------------------------------
  const float gamma = sc[kGamma];
  A wts[K], gz[K];
  for (int u = 0; u < K; ++u) wts[u] = gz[u] = 0.0;
  const int first = first_live_max<MAXF>(R, w);
  A sum_gz_mc = 0.0;
  // The MC aggregation's backward (want_g; with want_w also its weights,
  // K4's single pass): every row up to the background is drawn, once,
  // into nzbuf; phi and the rows' score sum (the z_inv_max clamp's share
  // of g_zmap over every row) reduce across the lanes.
  auto mc_grad = [&](bool want_w) {
    const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
    const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
    const float phi_comp = (float)(p.k - bg);
    if (want_w)
      for (int u = 0; u < K; ++u) wts[u] = 0.0;
    A g_gam = 0.0;
    if (nc == 0 && p.agg_vr) {
      // The background wins every sample and is the baseline: every score
      // term is exactly 0.
      if (want_w)
        for (int u = 0; u < K; ++u)
          if (R.bg(u, lane)) wts[u] = (A)p.s_agg;
    } else {
      for (int s = 0; s < p.s_agg; ++s) {
        float phi_l = 0.0f, ss_l = 0.0f;
        if (p.agg_noise == kGaussian) {
          const int half = C / 2;
          for (int h = lane; h < half; h += 32) {
            float c, sn;
            ptt::gaussian_pair(ptt::hash_words(a0, a1, s, h, pos), &c, &sn);
            if (h <= bg) {
              nzbuf[h] = c;
              phi_l += score(c, p.agg_noise) * c;
              ss_l += score(c, p.agg_noise);
            }
            if (h + half <= bg) {
              nzbuf[h + half] = sn;
              phi_l += score(sn, p.agg_noise) * sn;
              ss_l += score(sn, p.agg_noise);
            }
          }
        } else {
          for (int r = lane; r <= bg; r += 32) {
            const float n = ptt::cauchy_draw(ptt::hash_words(a0, a1, s, r,
                                                             pos));
            nzbuf[r] = n;
            phi_l += score(n, p.agg_noise) * n;
            ss_l += score(n, p.agg_noise);
          }
        }
        w.sync();
        float nz[K];
        A pert[K];
        A pm = -INFINITY;
        for (int u = 0; u < K; ++u) {
          nz[u] = 0.0f;
          pert[u] = -INFINITY;
          if (u >= nk || !R.live(u, lane)) continue;
          nz[u] = nzbuf[R.L.row[u]];
          pert[u] = R.zmap[u] + (A)gamma * nz[u];
          pm = fmax(pm, pert[u]);
        }
        w.sync();                  // nzbuf is the next sample's
        const A mx = wmax(w, pm);
        A dot_l = 0.0;
        for (int u = 0; u < K; ++u) {
          if (!R.live(u, lane)) continue;
          const float oh = pert[u] >= mx ? 1.0f : 0.0f;
          if (want_w) wts[u] += oh;
          const float w0 = p.agg_vr && lane + 32 * u == first ? 1.0f : 0.0f;
          dot_l += gw[u] * (oh - w0);
        }
        const A dot = wsum(w, dot_l);
        const float phi = wsum(w, phi_l) + phi_comp;
        const float ssum = wsum(w, ss_l);
        for (int u = 0; u < K; ++u)
          if (R.live(u, lane)) gz[u] += dot * score(nz[u], p.agg_noise);
        g_gam += dot * (phi - 1.0f);
        sum_gz_mc += dot * ssum;
      }
    }
    if (want_w) {
      const A inv_s = (A)1 / (A)p.s_agg;
      for (int u = 0; u < K; ++u) wts[u] = wts[u] * inv_s;
    }
    const A sg = (A)p.s_agg * (A)gamma;
    for (int u = 0; u < K; ++u) gz[u] = gz[u] / sg;
    sum_gz_mc = sum_gz_mc / sg;
    if (lane == 0) acc.gsc[kGamma] += g_gam / sg;
  };
  if (p.agg_kind == kAggMC) {
    if (LOSS) {
      mc_weights<MAXF>(p, sc, b, pos, R, w, list, nzbuf, wts);
    } else {
      build_gw();
      mc_grad(true);             // K4: forward and backward in one pass
    }
  } else {
    det_weights<MAXF>(p, sc, R, w, wts);
  }
  PT_PHASE(6, t0);

  // ---- blend (forward), alpha's prefix and suffix products ----------------
  A rl[3] = {0.0, 0.0, 0.0};
  for (int u = 0; u < K; ++u)
    if (R.live(u, lane))
      for (int c = 0; c < 3; ++c) rl[c] += wts[u] * R.col[u][c];
  A rgb[3];
  for (int c = 0; c < 3; ++c) rgb[c] = wsum(w, rl[c]);
  // alpha = 1 - prod(1 - prob) over the candidates in slot order: each
  // row's product of the rows after it here, of the rows before it in the
  // adjoint loop below (warp scans over the list, pass by pass).
  A suf[K];
  {
    A carry = 1.0;
    for (int u = K - 1; u >= 0; --u) {
      suf[u] = 1.0;
      if (u >= nk) continue;
      const A x = R.slot(u, lane) ? (A)1 - (A)R.prob[u] : (A)1;
      const A inc = wscan_mul(w, x, false);
      const A ex = w.shfl_down(inc, 1);
      suf[u] = (lane == 31 ? (A)1 : ex) * carry;
      carry = carry * w.shfl(inc, 0);
    }
  }

  // ---- image loss and its cotangent (K2) -----------------------------------
  if (LOSS) {
    const float* tg = p.extra + (size_t)b * 3 * npix + pix;
    for (int c = 0; c < 3; ++c) {
      const float d = (float)rgb[c] - tg[(size_t)c * npix];
      if (p.loss_kind == kL2) {
        if (lane == 0) acc.loss += d * d;
        g_rgb[c] = 2.0f * d * p.lscale;
      } else {
        if (lane == 0) acc.loss += fabsf(d);
        g_rgb[c] = (d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f)) * p.lscale;
      }
    }
    build_gw();
    if (p.agg_kind == kAggMC) mc_grad(false);      // replay for g_zmap
  }
  if (p.agg_kind == kAggSoft) {
    if (!LOSS) build_gw();
    const A ig = (A)1 / (A)gamma;
    A sd_l = 0.0;
    for (int u = 0; u < K; ++u)
      if (R.live(u, lane)) sd_l += wts[u] * gw[u];
    const A sdot = wsum(w, sd_l);
    for (int u = 0; u < K; ++u) {
      if (!R.live(u, lane)) continue;
      const A gx = wts[u] * (gw[u] - sdot);
      const A gy = ig * gx;
      gz[u] = isnan(gy) ? (A)0 : gy;
      const A term = (isinf(R.zmap[u]) ? (A)0 : R.zmap[u]) * gx;
      if (!isnan(term)) acc.g_invgam += term;
    }
  }
  for (int u = 0; u < K; ++u)
    if (R.bg(u, lane))
      for (int c = 0; c < 3; ++c) acc.gsc[kBg + c] += wts[u] * g_rgb[c];

  // ---- det2 adjoint, shared part: the z_inv_max clamp ----------------------
  A sum_gz;
  if (p.agg_kind == kAggMC) {
    sum_gz = sum_gz_mc;
  } else {
    A sl = 0.0;
    for (int u = 0; u < K; ++u)
      if (R.live(u, lane)) sl += gz[u];
    sum_gz = wsum(w, sl);
  }
  const A g_zmax = -sum_gz * tie_max(R.zmax_raw, (A)p.eps_bg);
  int tl = 0;
  for (int u = 0; u < K; ++u)
    if (R.slot(u, lane) && R.zinv[u] == R.zmax_raw) ++tl;
  const int ties = wsum(w, tl) + (R.zmax_raw == (A)0 ? F - nc : 0);
  const A g_share = ties ? g_zmax / (A)ties : (A)0;

  PT_PHASE(7, t0);
  // ---- per candidate: alpha product, det2, coverage, det1 ------------------
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const A zden = (A)zfar - (A)znear;
  const float sigma = sc[kSigma];
  const bool hard_agg = p.agg_kind == kAggHard;
  A carry = 1.0;
  for (int u = 0; u < K; ++u) {
    if (u >= nk) break;
    const A x = R.slot(u, lane) ? (A)1 - (A)R.prob[u] : (A)1;
    const A inc = wscan_mul(w, x, true);
    const A ex = w.shfl_up(inc, 1);
    const A pre = carry * (lane == 0 ? (A)1 : ex);
    carry = carry * w.shfl(inc, 31);
    if (!R.slot(u, lane)) continue;
    const int i = R.L.row[u];
    const A g_ap = (A)(-g_alpha) * suf[u];
    const A g_p3 = -(g_ap * pre);
    float gslot[kGeo + 9];
    for (int d = 0; d < kGeo + 9; ++d) gslot[d] = 0.0f;
    int cell = -1;
    float gcell[3] = {0.0f, 0.0f, 0.0f};
    // det2: zmap_i = scaled_i + zinv_i - zmax.
    const A g_zm = gz[u];
    const A g_zinv = g_zm + (R.zinv[u] == R.zmax_raw ? g_share : (A)0);
    const A lp = log_prob(R.lgs, p.s_rast, R.prob[u]);
    A g_lp;
    if (hard_agg) {
      g_lp = (A)1e-6f * g_zm;
    } else {
      const A gy = R.gal * g_zm;
      g_lp = isnan(gy) ? (A)0 : gy;
      const A term = (isinf(lp) ? (A)0 : lp) * g_zm;
      if (!isnan(term)) acc.g_gal += term;
    }
    A inv = (A)1 / (A)R.prob[u];
    if (isinf(inv)) inv = 0.0f;
    const A g_p2 = inv * g_lp;
    const A g_q = g_zinv * 1.0f;
    const A num = (A)zfar - R.zz[u];
    const A g_num = g_q / zden;
    const A g_den = -g_q * num / (zden * zden);
    acc.gsc[kZfar] += g_num + g_den;
    acc.gsc[kZnear] -= g_den;
    const A g_z = -g_num;
    // coverage
    const A g_raw = (g_p3 + g_p2) * 1.0f;
    A g_dist = 0.0f;
    if (p.rast_kind == kRastMC) {
      const A g_d = R.coeff[u] * g_raw;
      g_dist = -g_d;
      acc.gsc[kSigma] += g_d;
    } else if (p.rast_kind != kRastHard) {
      const float nd = -R.dist[u];
      const float x = nd / sigma;
      A g_x;
      if (p.rast_kind == kRastSoft) {
        g_x = g_raw * R.prob[u] * ((A)1 - R.prob[u]);
      } else {
        const float p1 = x > 0.5f ? 1.0f : x + 0.5f;
        g_x = x > 0.5f ? (A)0 : g_raw * tie_max(p1, 0.0f);
      }
      g_dist = -(g_x / sigma);
      acc.gsc[kSigma] += -g_x * nd / ((A)sigma * (A)sigma);
    }
    const A g_col[3] = {wts[u] * g_rgb[0], wts[u] * g_rgb[1],
                        wts[u] * g_rgb[2]};
    face_backward(p, T, i, px, py, g_dist, g_z, g_col, gslot, &cell, gcell,
                  acc.gsc);
    for (int d = 0; d < 9; ++d) rows.add(i, d, gslot[d]);
    if (p.phong)
      for (int d = 9; d < kGeo; ++d) rows.add(i, d, gslot[d]);
    if (p.atlas_r == 0)
      for (int d = kGeo; d < kGeo + 9; ++d) rows.add(i, d, gslot[d]);
    else if (p.atlas_r == 1)
      for (int d = kGeo; d < kGeo + 3; ++d) rows.add(i, d, gslot[d]);
    if (p.atlas_r > 1)
      for (int c = 0; c < 3; ++c) rows.add(i, kGeo + cell * 3 + c, gcell[c]);
  }
  PT_PHASE(8, t0);
}

// A pixel of an inactive tile (no candidate, so its image is the
// background): only the background colour's gradient and, for K2, the
// loss (the flat pipeline's bg_only).  Per thread, into acc.
template <bool LOSS, class Acc>
PT_HD void background_grads(const Params& p, const float* sc, int b, int pix,
                            Acc& acc) {
  using A = double;
  const int npix = p.image_size * p.image_size;
  float g_rgb[3];
  if (!LOSS) {
    const float* go = p.extra + ((size_t)b * npix + pix) * 4;
    for (int c = 0; c < 3; ++c) g_rgb[c] = go[c];
  } else {
    // The background's weight: the MC mean of S ones, else 1.
    const A wb = p.agg_kind == kAggMC
                     ? (A)p.s_agg * ((A)1 / (A)p.s_agg) : (A)1;
    const float* tg = p.extra + (size_t)b * 3 * npix + pix;
    for (int c = 0; c < 3; ++c) {
      const float d = (float)(wb * sc[kBg + c]) - tg[(size_t)c * npix];
      if (p.loss_kind == kL2) {
        acc.loss += d * d;
        g_rgb[c] = 2.0f * d * p.lscale;
      } else {
        acc.loss += fabsf(d);
        g_rgb[c] = (d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f)) * p.lscale;
      }
    }
  }
  for (int c = 0; c < 3; ++c) acc.gsc[kBg + c] += g_rgb[c];
}

// A lane's last step: the reciprocal-scale terms into its scalar
// gradients (finish_pixels), then the warp's 34 scalar sums and loss into
// out[0..34] (lane 0 writes).
template <class Wp, class Acc>
PT_HD void warp_finish(const Params& p, const float* sc, Acc& acc, Wp& w,
                       double* out) {
  if (p.agg_kind != kAggHard) {     // z_map's gamma / alpha factor
    acc.gsc[kGamma] += acc.g_gal / sc[kAlpha];
    acc.gsc[kAlpha] += -acc.g_gal * sc[kGamma] / (sc[kAlpha] * sc[kAlpha]);
  }
  acc.gsc[kGamma] += -acc.g_invgam / (sc[kGamma] * sc[kGamma]);
  for (int k = 0; k < kNS; ++k) {
    const double v = wsum(w, acc.gsc[k]);
    if (w.lane == 0) out[k] = v;
  }
  const double v = wsum(w, acc.loss);
  if (w.lane == 0) out[kNS] = v;
}

PT_HD void zero_acc(PixelAccT<double>& acc) {
  for (int k = 0; k < kNS; ++k) acc.gsc[k] = 0.0;
  acc.g_gal = acc.g_invgam = acc.loss = 0.0;
}

}  // namespace ptf
