// The per-pixel gradient pipeline shared by K4 (fused_backward.cu) and K2
// (fused_loss_grad.cu), as the JAX kernels share run_pipeline, and the
// sharded route's backward halves (sharded.cu): K11b's aggregation replay
// (pixel_agg_grads) and K11c, pixel_grads with the coverage, weights and
// g_zmap given (EXT).
//
// One thread per pixel recomputes the forward (det1 -> coverage -> det2 ->
// aggregation -> blend, exactly as K3), then runs the hand-derived
// adjoints in reverse: blend and alpha product, aggregation (softmax,
// hard, or the MC score-function estimator), det2 (z_map with the
// corrected log / product and the z_inv_max clamp), coverage (soft,
// affine, hard, or the MC score coefficient) and det1 (edge-function
// geometry, texel select, Phong).  Ties follow JAX: jnp.maximum /
// jnp.minimum / jnp.clip give half the gradient to each side, jnp.max
// shares it equally among tied rows.
//
// The MC noise is drawn from the counter hash, so a replay gives the
// forward's bits: the coverage mean and its score coefficient share one
// noise pass; K4's aggregation forward and backward share one pass (the
// weight cotangent comes from the colors before the weights exist), and
// K2, which needs the rendered RGB before its cotangent, replays the
// aggregation noise in a second pass instead of stashing it.
//
// A warp whose 32 pixels have no candidate slot (most of an image: the
// flat cube covers 9% of its pixels) leaves after det1 with what JAX's
// bg_only gives it, the background colour's gradient and the loss; only
// warps with a candidate run the coverage, aggregation and adjoints.
//
// Reduction: a Sink adds each slot's table gradient across the pixels.
// On the card (WarpSink) a warp sums its 32 lanes with a butterfly of
// shuffles and adds the sum to the warp's own row of a partial buffer,
// which the warp zeroes first; a second kernel adds the rows in a fixed
// two-level order, many threads per column.  No atomics, so the
// gradients are the same bits from run to run.
#pragma once

#include "fused_common.cuh"
#include "warp.cuh"

namespace ptf {

// Per-thread sums across a thread's pixels: the 34 scalar gradients, the
// two reciprocal-scale terms converted once at the end, and the loss; in
// float (K4, K2, K5-K7) or in double (K12's lanes, binned_warp.cuh).  Real
// is also the type of pixel_grads' aggregation arithmetic (see there).
template <class F>
struct PixelAccT {
  using Real = F;
  F gsc[kNS];
  F g_gal;          // d loss / d (gamma / alpha)
  F g_invgam;       // d loss / d (1 / gamma), softmax aggregation
  F loss;
};
using PixelAcc = PixelAccT<float>;

PT_HD float tie_max(float x, float c) {   // d max(x, c) / dx, JAX rule
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

PT_HD float tie_min(float x, float c) {   // d min(x, c) / dx, JAX rule
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

PT_HD float tie_max(double x, double c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

PT_HD float tie_min(double x, double c) {
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

PT_HD float score(float n, int noise) {
  return noise == kGaussian ? n : 2.0f * n / (1.0f + n * n);
}

// Adjoint of edge_dist_sq: adds d(dist)/d(a, b) * g to ga, gb.
template <class F>
PT_HD void edge_backward(F px, F py, F ax, F ay, F bx, F by, F g, F* gax,
                         F* gay, F* gbx, F* gby) {
  const F ex = bx - ax, ey = by - ay;
  const F len = ex * ex + ey * ey;
  const F inv = (F)1 / fmax(len, (F)1e-12f);
  const F exs = ex * inv, eys = ey * inv;
  const F dx = px - ax, dy = py - ay;
  const F tr = dx * exs + dy * eys;
  const F u = fmax(tr, (F)0);
  const F t = fmin(u, (F)1);
  const F rx = dx - t * ex, ry = dy - t * ey;
  const F g_rx = 2.0f * rx * g, g_ry = 2.0f * ry * g;
  F g_dx = g_rx, g_dy = g_ry;
  const F g_t = -(g_rx * ex + g_ry * ey);
  F g_ex = -g_rx * t, g_ey = -g_ry * t;
  const F g_tr = g_t * tie_min(u, (F)1) * tie_max(tr, (F)0);
  g_dx += g_tr * exs;
  g_dy += g_tr * eys;
  const F g_exs = g_tr * dx, g_eys = g_tr * dy;
  g_ex += g_exs * inv;
  g_ey += g_eys * inv;
  const F g_inv = g_exs * ex + g_eys * ey;
  const F g_len = -g_inv * inv * inv * tie_max(len, (F)1e-12f);
  g_ex += 2.0f * ex * g_len;
  g_ey += 2.0f * ey * g_len;
  *gax += -g_dx - g_ex;
  *gay += -g_dy - g_ey;
  *gbx += g_ex;
  *gby += g_ey;
}

// Adjoint of v / max(|v|, 1e-8) for a 3-vector: g_v from g_u.
template <class F>
PT_HD void normalize_backward(const F v[3], F n_raw, const F g_u[3],
                              F g_v[3]) {
  const F n = fmax(n_raw, (F)1e-8f);
  F g_n = 0.0f;
  for (int c = 0; c < 3; ++c) {
    g_v[c] = g_u[c] / n;
    g_n -= g_u[c] * v[c] / (n * n);
  }
  g_n *= tie_max(n_raw, (F)1e-8f);
  for (int c = 0; c < 3; ++c)
    g_v[c] += n_raw > 0.0f ? g_n * v[c] / n_raw : (F)0;
}

// det1's adjoint for a candidate slot i, in F (float, or double for K12's
// warp pipeline):
// recomputes the geometry and shading of face_forward and pulls (g_dist,
// g_z, g_col) back to the slot's tables.  gslot: [0, 9) ndc, [9, 18)
// world, [18, 27) normals, [27, 27 + 9) corner texels (or [27, 30) for a
// one-cell atlas); an atlas with more cells reports its cell and gcell
// instead.
template <class F>
PT_HD void face_backward(const Params& p, const Tables& T, int i, float px,
                         float py, F g_dist, F g_z, const F g_col[3],
                         float* gslot, int* cell_out, float gcell[3],
                         F* gsc) {
  const float* sc = T.sc;
  const float* v = T.ndc + i * T.rs_geo;
  const F ax = v[0], ay = v[1], az = v[2], bx = v[3], by = v[4],
          bz = v[5], cx = v[6], cy = v[7], cz = v[8];
  const F vz[3] = {az, bz, cz};
  // ---- forward recompute (as face_forward) -------------------------------
  const F area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  const bool degen = fabs(area) < (F)1e-10f;
  const F ia = 1.0f / (degen ? 1.0f : area);
  const F e0x = (cy - by) * ia, e0y = (cx - bx) * ia;
  const F e1x = (ay - cy) * ia, e1y = (ax - cx) * ia;
  const F w0r = e0y * py - e0x * px + (e0x * bx - e0y * by);
  const F w1r = e1y * py - e1x * px + (e1x * cx - e1y * cy);
  const F wr[3] = {w0r, w1r, 1.0f - w0r - w1r};
  const bool inside = wr[0] >= 0.0f && wr[1] >= 0.0f && wr[2] >= 0.0f &&
                      !degen;
  const F d0 = edge_dist_sq(px, py, ax, ay, bx, by);
  const F d1 = edge_dist_sq(px, py, bx, by, cx, cy);
  const F d2 = edge_dist_sq(px, py, cx, cy, ax, ay);
  F mz[3], sp[3], wp[3], sum_s = 0.0f, den_p = 1.0f;
  for (int k = 0; k < 3; ++k) wp[k] = wr[k];
  if (p.persp) {
    for (int k = 0; k < 3; ++k) {
      mz[k] = fmax(vz[k], (F)1e-8f);
      sp[k] = wr[k] / mz[k];
    }
    sum_s = sp[0] + sp[1] + sp[2];
    den_p = fmax(sum_s, (F)1e-12f);
    for (int k = 0; k < 3; ++k) wp[k] = sp[k] / den_p;
  }
  F cc[3], w[3], sum_c = 0.0f, den_c = 1.0f;
  for (int k = 0; k < 3; ++k) w[k] = wp[k];
  if (p.clip) {
    for (int k = 0; k < 3; ++k) cc[k] = fmax(wp[k], (F)0);
    sum_c = cc[0] + cc[1] + cc[2];
    den_c = fmax(sum_c, (F)1e-12f);
    for (int k = 0; k < 3; ++k) w[k] = cc[k] / den_c;
  }

  // ---- texel + shading adjoint -> g_w (final barycentrics) ----------------
  F g_w[3] = {0.0f, 0.0f, 0.0f};
  const float* t = T.tex + i * T.rs_tex;
  F texel[3];
  int cell = -1;
  if (p.atlas_r == 0) {
    for (int c = 0; c < 3; ++c)
      texel[c] = w[0] * t[c] + w[1] * t[3 + c] + w[2] * t[6 + c];
  } else {
    const int r = p.atlas_r;
    const int xi = min(max((int)(fmin(fmax(w[1], (F)0), (F)1) * r), 0),
                       r - 1);
    const int yi = min(max((int)(fmin(fmax(w[2], (F)0), (F)1) * r), 0),
                       r - 1);
    cell = yi * r + xi;
    for (int c = 0; c < 3; ++c) texel[c] = t[cell * 3 + c];
  }
  F g_texel[3];
  if (p.phong) {
    const float* fw = T.world + i * T.rs_geo;
    const float* fnn = T.fn + i * T.rs_geo;
    F pnt[3], nrm[3], tl[3], vd[3];
    for (int c = 0; c < 3; ++c) {
      pnt[c] = w[0] * fw[c] + w[1] * fw[3 + c] + w[2] * fw[6 + c];
      nrm[c] = w[0] * fnn[c] + w[1] * fnn[3 + c] + w[2] * fnn[6 + c];
      tl[c] = p.point_light ? sc[kLight + c] - pnt[c] : -sc[kLight + c];
      vd[c] = sc[kCam + c] - pnt[c];
    }
    const F tln = sqrt(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2]);
    const F vdn = sqrt(vd[0] * vd[0] + vd[1] * vd[1] + vd[2] * vd[2]);
    F tlu[3], vdu[3];
    for (int c = 0; c < 3; ++c) {
      tlu[c] = tl[c] / fmax(tln, (F)1e-8f);
      vdu[c] = vd[c] / fmax(vdn, (F)1e-8f);
    }
    const F cosv = nrm[0] * tlu[0] + nrm[1] * tlu[1] + nrm[2] * tlu[2];
    const F cos2 = 2.0f * cosv;
    F refl[3];
    for (int c = 0; c < 3; ++c) refl[c] = cos2 * nrm[c] - tlu[c];
    const F sa_raw =
        vdu[0] * refl[0] + vdu[1] * refl[1] + vdu[2] * refl[2];
    const F spec_a = fmax(sa_raw, (F)0);
    const F facing = cosv > 0.0f ? 1.0f : 0.0f;
    const F shin = sc[kShin];               // no gradient (JAX)
    const F praw = pow(spec_a, shin);
    const F spec_pow = facing * praw;
    const F cmax = fmax(cosv, (F)0);
    F g_cmax = 0.0f, g_spow = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const F ma = sc[kMAmb + c], la = sc[kLAmb + c];
      const F ld = sc[kLDiff + c], md = sc[kMDiff + c];
      const F ls = sc[kLSpec + c], ms = sc[kMSpec + c];
      const F cl = cmax * ld;
      const F g = g_col[c];
      g_texel[c] = g * (ma * la + cl * md);
      const F g_amb = g * texel[c];           // = g_diffuse
      gsc[kMAmb + c] += g_amb * la;
      gsc[kLAmb + c] += g_amb * ma;
      gsc[kMDiff + c] += g_amb * cl;
      const F g_cl = g_amb * md;
      g_cmax += g_cl * ld;
      gsc[kLDiff + c] += g_cl * cmax;
      const F spl = spec_pow * ls;
      gsc[kMSpec + c] += g * spl;
      const F g_spl = g * ms;
      g_spow += g_spl * ls;
      gsc[kLSpec + c] += g_spl * spec_pow;
    }
    // In double (K12) pow(a, s - 1) is taken as pow(a, s) / a where a > 0
    // (one double pow fewer, within an ulp or two); K4 / K2 keep powf.
    const F dpow =
        shin == 0.0f ? (F)0
                     : shin * (sizeof(F) == 8 && spec_a > (F)0
                                   ? praw / spec_a
                                   : pow(spec_a, shin - (F)1));
    const F g_sa = g_spow * facing * dpow * tie_max(sa_raw, (F)0);
    F g_vdu[3], g_refl[3], g_nrm[3], g_tlu[3];
    F g_c2 = 0.0f;
    for (int c = 0; c < 3; ++c) {
      g_vdu[c] = g_sa * refl[c];
      g_refl[c] = g_sa * vdu[c];
      g_c2 += g_refl[c] * nrm[c];
      g_nrm[c] = g_refl[c] * cos2;
      g_tlu[c] = -g_refl[c];
    }
    const F g_cos = 2.0f * g_c2 + g_cmax * tie_max(cosv, (F)0);
    for (int c = 0; c < 3; ++c) {
      g_nrm[c] += g_cos * tlu[c];
      g_tlu[c] += g_cos * nrm[c];
    }
    F g_vd[3], g_tl[3], g_pnt[3];
    normalize_backward(vd, vdn, g_vdu, g_vd);
    normalize_backward(tl, tln, g_tlu, g_tl);
    for (int c = 0; c < 3; ++c) {
      gsc[kCam + c] += g_vd[c];
      g_pnt[c] = -g_vd[c];
      if (p.point_light) {
        gsc[kLight + c] += g_tl[c];
        g_pnt[c] -= g_tl[c];
      } else {
        gsc[kLight + c] -= g_tl[c];
      }
    }
    for (int k = 0; k < 3; ++k)
      for (int c = 0; c < 3; ++c) {
        gslot[9 + k * 3 + c] = g_pnt[c] * w[k];
        gslot[18 + k * 3 + c] = g_nrm[c] * w[k];
        g_w[k] += g_pnt[c] * fw[k * 3 + c] + g_nrm[c] * fnn[k * 3 + c];
      }
  } else {
    for (int c = 0; c < 3; ++c) g_texel[c] = g_col[c];
  }
  if (p.atlas_r == 0) {
    for (int k = 0; k < 3; ++k)
      for (int c = 0; c < 3; ++c) {
        gslot[27 + k * 3 + c] = g_texel[c] * w[k];
        g_w[k] += g_texel[c] * t[k * 3 + c];
      }
  } else if (p.atlas_r == 1) {
    for (int c = 0; c < 3; ++c) gslot[27 + c] = g_texel[c];
  } else {
    for (int c = 0; c < 3; ++c) gcell[c] = g_texel[c];
  }
  *cell_out = cell;

  // ---- z = w . (az, bz, cz) ------------------------------------------------
  F g_vz[3];
  for (int k = 0; k < 3; ++k) {
    g_w[k] += g_z * vz[k];
    g_vz[k] = g_z * w[k];
  }
  // ---- clip, then perspective correction, in reverse -----------------------
  if (p.clip) {
    F g_den = 0.0f, g_cc[3];
    for (int k = 0; k < 3; ++k) {
      g_cc[k] = g_w[k] / den_c;
      g_den -= g_w[k] * cc[k] / (den_c * den_c);
    }
    const F g_sum = g_den * tie_max(sum_c, (F)1e-12f);
    for (int k = 0; k < 3; ++k)
      g_w[k] = (g_cc[k] + g_sum) * tie_max(wp[k], (F)0);
  }
  if (p.persp) {
    F g_den = 0.0f, g_sp[3];
    for (int k = 0; k < 3; ++k) {
      g_sp[k] = g_w[k] / den_p;
      g_den -= g_w[k] * sp[k] / (den_p * den_p);
    }
    const F g_sum = g_den * tie_max(sum_s, (F)1e-12f);
    for (int k = 0; k < 3; ++k) {
      const F g_s = g_sp[k] + g_sum;
      g_w[k] = g_s / mz[k];
      g_vz[k] -= g_s * wr[k] / (mz[k] * mz[k]) * tie_max(vz[k], (F)1e-8f);
    }
  }
  // ---- raw barycentrics (edge functions) -----------------------------------
  F gax = 0.0f, gay = 0.0f, gbx = 0.0f, gby = 0.0f, gcx = 0.0f,
        gcy = 0.0f;
  const F g_w0 = g_w[0] - g_w[2], g_w1 = g_w[1] - g_w[2];
  const F g_e0y = g_w0 * py - g_w0 * by;
  const F g_e0x = g_w0 * bx - g_w0 * px;
  gbx += g_w0 * e0x;
  gby -= g_w0 * e0y;
  const F g_e1y = g_w1 * py - g_w1 * cy;
  const F g_e1x = g_w1 * cx - g_w1 * px;
  gcx += g_w1 * e1x;
  gcy -= g_w1 * e1y;
  F g_ia = 0.0f;
  gcy += g_e0x * ia;
  gby -= g_e0x * ia;
  g_ia += g_e0x * (cy - by);
  gcx += g_e0y * ia;
  gbx -= g_e0y * ia;
  g_ia += g_e0y * (cx - bx);
  gay += g_e1x * ia;
  gcy -= g_e1x * ia;
  g_ia += g_e1x * (ay - cy);
  gax += g_e1y * ia;
  gcx -= g_e1y * ia;
  g_ia += g_e1y * (ax - cx);
  if (!degen) {
    const F g_area = -g_ia * ia * ia;
    gbx += g_area * (cy - ay);
    gax -= g_area * (cy - ay);
    gcy += g_area * (bx - ax);
    gay -= g_area * (bx - ax);
    gby -= g_area * (cx - ax);
    gay += g_area * (cx - ax);
    gcx -= g_area * (by - ay);
    gax += g_area * (by - ay);
  }
  // ---- signed distance: where(inside, -min_d, min_d) -----------------------
  const F g_min = inside ? -g_dist : g_dist;
  const F m12 = fmin(d1, d2);
  const F g_d0 = g_min * tie_min(d0, m12);
  const F g_m12 = g_min * tie_min(m12, d0);
  edge_backward<F>(px, py, ax, ay, bx, by, g_d0, &gax, &gay, &gbx, &gby);
  edge_backward<F>(px, py, bx, by, cx, cy, g_m12 * tie_min(d1, d2), &gbx, &gby,
                &gcx, &gcy);
  edge_backward<F>(px, py, cx, cy, ax, ay, g_m12 * tie_min(d2, d1), &gcx, &gcy,
                &gax, &gay);
  gslot[0] = gax;
  gslot[1] = gay;
  gslot[2] = g_vz[0];
  gslot[3] = gbx;
  gslot[4] = gby;
  gslot[5] = g_vz[1];
  gslot[6] = gcx;
  gslot[7] = gcy;
  gslot[8] = g_vz[2];
}

// det2 of one pixel: z_map rows (slots, the background, -inf padding)
// from the coverage prob and the depths, in A; zinv and the unclamped max
// zmax_raw are kept for the adjoint.
template <int MAXF, class A>
PT_HD void z_map_rows(const Params& p, const float* sc, const float* prob,
                      const float* zz, const float* mk, A zinv[MAXF],
                      A* zmax_raw_out, A* gal_out, A zmap[MAXF + 8]) {
  const int F = p.f_pad, C = p.c_zpad;
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const A zden = (A)zfar - (A)znear;
  A zmax_raw = -INFINITY;
  for (int i = 0; i < F; ++i) {
    zinv[i] = ((A)zfar - zz[i]) / zden * mk[i];
    zmax_raw = fmax(zmax_raw, zinv[i]);
  }
  const A zmax = fmax(zmax_raw, (A)p.eps_bg);
  const A gal =
      p.agg_kind == kAggHard ? (A)1e-6f : (A)sc[kGamma] / (A)sc[kAlpha];
  for (int i = 0; i < F; ++i) zmap[i] = gal * log((A)prob[i]) + zinv[i] - zmax;
  for (int r = F; r < C; ++r) zmap[r] = -INFINITY;
  zmap[p.bg_row] = (A)p.eps_bg - zmax;
  *zmax_raw_out = zmax_raw;
  *gal_out = gal;
}

// Weight cotangent of the (linear) blend, laid out like z_map.
template <int MAXF, class A>
PT_HD void blend_cotangent(const Params& p, const float* sc,
                           const float* col0, const float* col1,
                           const float* col2, const float g_rgb[3],
                           A gw[MAXF + 8]) {
  const int F = p.f_pad, C = p.c_zpad;
  for (int i = 0; i < F; ++i)
    gw[i] = (A)col0[i] * g_rgb[0] + (A)col1[i] * g_rgb[1] +
            (A)col2[i] * g_rgb[2];
  for (int r = F; r < C; ++r) gw[r] = 0.0f;
  gw[p.bg_row] = (A)sc[kBg] * g_rgb[0] + (A)sc[kBg + 1] * g_rgb[1] +
                 (A)sc[kBg + 2] * g_rgb[2];
}

// First-wins argmax of z_map's C rows (the MC aggregation's VR baseline).
template <class A>
PT_HD int first_max(const A* zmap, int C) {
  A mx = -INFINITY;
  for (int r = 0; r < C; ++r) mx = fmax(mx, zmap[r]);
  int first = -1;
  for (int r = C - 1; r >= 0; --r)
    if (zmap[r] >= mx) first = r;
  return first;
}

// One replay of the MC aggregation noise of batch element b at pixel pos:
// the weights' sample mean into wts (want_w), and the score-function terms
// of the aggregation's backward (want_g): g_zmap into gz (zeroed by the
// caller) and the gamma gradient's term, returned (0 without want_g).  gw:
// the weights' cotangent; first: the VR baseline's row.
template <int MAXC, class A>
PT_HD A mc_agg_replay(const Params& p, const float* sc, int b, uint32_t pos,
                      const A zmap[MAXC], const A gw[MAXC], int first,
                      bool want_w, bool want_g, A wts[MAXC], A gz[MAXC]) {
  const int C = p.c_zpad, bg = p.bg_row;
  const float gamma = sc[kGamma];
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  float nz[MAXC];
  A pert[MAXC];
  A g_gam = 0.0f;
  const float phi_comp = (float)(p.k - bg);
  if (want_w)
    for (int r = 0; r < C; ++r) wts[r] = 0.0f;
  for (int s = 0; s < p.s_agg; ++s) {
    draw_noise<MAXC>(nz, C, p.agg_noise, a0, a1, s, pos);
    A mx = -INFINITY;
    for (int r = 0; r < C; ++r) {
      pert[r] = zmap[r] + (A)gamma * nz[r];
      mx = fmax(mx, pert[r]);
    }
    if (want_w)
      for (int r = 0; r < C; ++r) wts[r] += pert[r] >= mx ? 1.0f : 0.0f;
    if (want_g) {
      // Rows past bg_row are -inf and never win; their noise is masked.
      A dot = 0.0f;
      float phi = 0.0f;
      for (int r = 0; r <= bg; ++r) {
        const float oh = pert[r] >= mx ? 1.0f : 0.0f;
        const float w0 = p.agg_vr && r == first ? 1.0f : 0.0f;
        dot += gw[r] * (oh - w0);
        phi += score(nz[r], p.agg_noise) * nz[r];
      }
      phi += phi_comp;
      for (int r = 0; r <= bg; ++r)
        gz[r] += dot * score(nz[r], p.agg_noise);
      g_gam += dot * (phi - 1.0f);
    }
  }
  if (want_w) {
    const A inv_s = (A)1 / (A)p.s_agg;
    for (int r = 0; r < C; ++r) wts[r] = wts[r] * inv_s;
  }
  if (!want_g) return 0.0f;
  const A sg = (A)p.s_agg * (A)gamma;
  for (int r = 0; r < C; ++r) gz[r] = gz[r] / sg;
  return g_gam / sg;
}

// The gradient pipeline of one pixel.  LOSS: K2 (cotangent from the
// target), else K4 (cotangent g_out).  Sink: the reduction across pixels.
//
// From the aggregation on — z_inv, z_map, the weights, the weight
// cotangent, g_zmap, the slot's cotangents and det1's adjoint
// (face_backward) — the arithmetic runs in Acc::Real: float for K4 / K2
// (the bits of float32 arithmetic); double in the CPU tests' reference of
// K12 over binned tiles, as K12's warp pipeline (binned_warp.cuh) runs
// it; det1's forward stays float.  Two sums need it on a large binned
// scene.  The scalar gradients
// sum terms over every (slot, pixel) that, under a cotangent of mixed
// sign, cancel to a small share of their magnitude, and the softmax
// weights carry z_inv's float32 rounding magnified by 1 / gamma: in float
// alpha's gradient on config 5 misses float64 by 1.7e-4 of its value
// (5e-6 in double; the float32 plain version 8e-5).  A face seen nearly
// edge-on has adjoint terms of order L / h that cancel across its
// pixels: in float its rows miss float64 by up to 16 float32 ulps times
// L / h of the table's max (the card's thin-row bound), in double by a
// twentieth of that.
//
// EXT (the sharded route's K11c, K4's cotangent): the coverage mean, the
// weights and g_zmap over the sample group come in (prob_ext, w_in,
// gz_in); only the coverage's score coefficient is drawn, from this
// shard's samples.  The aggregation's own gamma term is K11b's.
template <int MAXF, bool LOSS, class Sink, class Acc, bool EXT = false>
PT_HD void pixel_grads(const Params& p, const Tables& T, int b, int pix,
                       bool live, Sink& sink, Acc& acc) {
  using A = typename Acc::Real;
  constexpr int MAXC = MAXF + 8;
  const int F = p.f_pad, C = p.c_zpad, bg = p.bg_row;
  const int npix = p.image_size * p.image_size;
  const float* sc = T.sc;
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;

  PT_MARK(clk);
  // ---- det1 (a slot that is not a candidate is not shaded: colour 0) -------
  float dist[MAXF], zz[MAXF], mk[MAXF], col0[MAXF], col1[MAXF], col2[MAXF];
  bool dead = true;
  for (int i = 0; i < F; ++i) {
    float c3[3] = {0.0f, 0.0f, 0.0f}, w3[3];
    face_geometry(p, T, i, px, py, live, &dist[i], &zz[i], &mk[i], w3);
    if (mk[i] != 0.0f) {
      face_shade(p, T, i, mk[i], w3, c3);
      dead = false;
    }
    col0[i] = c3[0];
    col1[i] = c3[1];
    col2[i] = c3[2];
  }
  PT_PHASE_AT(0, clk, sink.lane_id());

  // ---- a warp whose pixels have no candidate ------------------------------
  // Each pixel's image is the background: the background wins every
  // sample (z_map 0 against -inf), or takes the softmax's whole weight, so
  // the blend's background weight wb is S fl(1 / S) (MC; the sample mean's
  // own expression), 1 (softmax, hard) or the sample group's (EXT).  Its
  // only gradients are the background colour's and (K2) the loss; the
  // rest of the pipeline adds zeros.  Without variance reduction the MC
  // aggregation's gamma term is not 0 there, so that pair runs the
  // pipeline.
  if (!(p.agg_kind == kAggMC && !p.agg_vr && !EXT) && sink.all(dead)) {
    A wb = (A)1;
    if (EXT) {
      wb = live ? (A)p.w_in[((size_t)b * C + bg) * npix + pix] : (A)0;
    } else if (p.agg_kind == kAggMC) {
      A hits = 0.0f;
      for (int s = 0; s < p.s_agg; ++s) hits += 1.0f;
      wb = hits * ((A)1 / (A)p.s_agg);
    }
    if (live) {
      const bool act = pixel_active(p, b, pix);
      float g_rgb[3];
      if (LOSS) {
        const float* tg = p.extra + (size_t)b * 3 * npix + pix;
        for (int c = 0; c < 3; ++c) {
          const A rgb = (A)0 + wb * sc[kBg + c];
          const float d = (float)rgb - tg[(size_t)c * npix];
          if (p.loss_kind == kL2) {
            acc.loss += d * d;
            g_rgb[c] = 2.0f * d * p.lscale;
          } else {
            acc.loss += fabsf(d);
            g_rgb[c] = (d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f)) *
                       p.lscale;
          }
        }
      } else {
        const float* go = p.extra + ((size_t)b * npix + pix) * 4;
        for (int c = 0; c < 3; ++c) g_rgb[c] = go[c];
      }
      for (int c = 0; c < 3; ++c)
        acc.gsc[kBg + c] += act ? wb * g_rgb[c] : g_rgb[c];
    }
    PT_PHASE_AT(5, clk, sink.lane_id());
    return;
  }

  // ---- coverage (+ the MC score coefficient, same noise pass) --------------
  const float sigma = sc[kSigma];
  float prob[MAXF], coeff[MAXF];
  if (p.rast_kind == kRastMC) {
    float nz[MAXF];
    for (int i = 0; i < F; ++i) {
      prob[i] = 0.0f;
      coeff[i] = 0.0f;
    }
    const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 0];
    const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 1];
    for (int s = 0; s < p.s_rast; ++s) {
      draw_noise<MAXF>(nz, F, p.rast_noise, s0, s1, s, pos);
      for (int i = 0; i < F; ++i) {
        const float h = -dist[i] + sigma * nz[i] >= 0.0f ? 1.0f : 0.0f;
        const float h0 = p.rast_vr && -dist[i] >= 0.0f ? 1.0f : 0.0f;
        prob[i] += h;
        coeff[i] += (h - h0) * score(nz[i], p.rast_noise);
      }
    }
    const float inv_s = 1.0f / (float)p.s_rast;
    const float ss = (float)p.s_rast * sigma;
    for (int i = 0; i < F; ++i) {
      prob[i] = prob[i] * inv_s * mk[i];
      coeff[i] = coeff[i] / ss;
    }
  } else {
    for (int i = 0; i < F; ++i) {
      const float x = -dist[i] / sigma;
      float pr;
      if (p.rast_kind == kRastSoft) {
        pr = 1.0f / (1.0f + expf(-x));
      } else if (p.rast_kind == kRastAffine) {
        pr = fmaxf(x > 0.5f ? 1.0f : x + 0.5f, 0.0f);
      } else {
        pr = -dist[i] >= 0.0f ? 1.0f : 0.0f;
      }
      prob[i] = pr * mk[i];
    }
  }
  if (EXT)
    for (int i = 0; i < F; ++i)
      prob[i] = p.prob_ext[((size_t)b * F + i) * npix + pix];
  PT_PHASE_AT(1, clk, sink.lane_id());

  // ---- det2: z_map ---------------------------------------------------------
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const A zden = (A)zfar - (A)znear;
  const bool hard_agg = p.agg_kind == kAggHard;
  A zinv[MAXF], zmap[MAXC], zmax_raw, gal;
  z_map_rows<MAXF, A>(p, sc, prob, zz, mk, zinv, &zmax_raw, &gal, zmap);

  // ---- output cotangent (K4) -----------------------------------------------
  // A pixel of an inactive tile has no candidate, so its image is the
  // background; it takes only the background colour's gradient (the JAX
  // kernels' bg_only): bg_only() books it and zeroes the cotangent the
  // pipeline sees.
  const bool act = live && pixel_active(p, b, pix);
  float g_rgb[3] = {0.0f, 0.0f, 0.0f}, g_alpha = 0.0f;
  auto bg_only = [&]() {
    for (int c = 0; c < 3; ++c) {
      acc.gsc[kBg + c] += g_rgb[c];
      g_rgb[c] = 0.0f;
    }
    g_alpha = 0.0f;
  };
  if (!LOSS && live) {
    const float* go = p.extra + ((size_t)b * npix + pix) * 4;
    for (int c = 0; c < 3; ++c) g_rgb[c] = go[c];
    g_alpha = go[3];
    if (!act) bg_only();
  }
  // Weight cotangent of the (linear) blend, laid out like z_map.
  A gw[MAXC];
  auto build_gw = [&]() {
    blend_cotangent<MAXF, A>(p, sc, col0, col1, col2, g_rgb, gw);
  };

  // ---- aggregation: weights, and g_zmap ------------------------------------
  const float gamma = sc[kGamma];
  A wts[MAXC], gz[MAXC];
  for (int r = 0; r < C; ++r) gz[r] = 0.0f;
  const int first = first_max(zmap, C);   // VR baseline of the MC replay
  // One replay of the MC aggregation noise: the weights (want_w) and the
  // score-function terms of g_zmap and gamma (want_g).
  auto mc_agg = [&](bool want_w, bool want_g) {
    const A term = mc_agg_replay<MAXC, A>(p, sc, b, pos, zmap, gw, first,
                                          want_w, want_g, wts, gz);
    if (want_g) acc.gsc[kGamma] += term;
  };
  if (EXT) {
    // The sample group's weights and g_zmap (K3 and K11b, averaged).
    for (int r = 0; r < C; ++r) {
      const size_t at = ((size_t)b * C + r) * npix + pix;
      wts[r] = p.w_in[at];
      gz[r] = act ? p.gz_in[at] : 0.0f;
    }
  } else if (p.agg_kind == kAggMC) {
    if (!LOSS) build_gw();
    mc_agg(true, !LOSS);            // K4: forward and backward in one pass
  } else if (p.agg_kind == kAggSoft) {
    const A inv_gamma = (A)1 / (A)gamma;
    A mx = -INFINITY;
    for (int r = 0; r < C; ++r) {
      wts[r] = inv_gamma * zmap[r];
      mx = fmax(mx, wts[r]);
    }
    A sum = 0.0f;
    for (int r = 0; r < C; ++r) {
      wts[r] = exp(wts[r] - mx);
      sum += wts[r];
    }
    for (int r = 0; r < C; ++r) wts[r] = wts[r] / sum;
  } else {
    for (int r = 0; r < C; ++r) wts[r] = r == first ? 1.0f : 0.0f;
  }

  // ---- blend (forward) -----------------------------------------------------
  A rgb[3] = {0.0f, 0.0f, 0.0f};
  float ap = 1.0f, pre[MAXF];
  for (int i = 0; i < F; ++i) {
    rgb[0] += wts[i] * col0[i];
    rgb[1] += wts[i] * col1[i];
    rgb[2] += wts[i] * col2[i];
    pre[i] = ap;
    ap = ap * (1.0f - prob[i]);
  }
  const A wb = wts[bg];
  for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + wb * sc[kBg + c];

  PT_PHASE_AT(2, clk, sink.lane_id());

  // ---- image loss and its cotangent (K2) -----------------------------------
  if (LOSS) {
    if (live) {
      const float* tg = p.extra + (size_t)b * 3 * npix + pix;
      for (int c = 0; c < 3; ++c) {
        const float d = (float)rgb[c] - tg[(size_t)c * npix];
        if (p.loss_kind == kL2) {
          acc.loss += d * d;
          g_rgb[c] = 2.0f * d * p.lscale;
        } else {
          acc.loss += fabsf(d);
          g_rgb[c] = (d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f)) * p.lscale;
        }
      }
      if (!act) bg_only();
    }
    build_gw();
    if (p.agg_kind == kAggMC) mc_agg(false, true);   // replay for g_zmap
  }
  if (!EXT && p.agg_kind == kAggSoft) {
    if (!LOSS) build_gw();
    const A inv_gamma = (A)1 / (A)gamma;
    A sdot = 0.0f;
    for (int r = 0; r < C; ++r) sdot += wts[r] * gw[r];
    for (int r = 0; r < C; ++r) {
      const A gx = wts[r] * (gw[r] - sdot);
      const A gy = inv_gamma * gx;
      gz[r] = isnan(gy) ? (A)0 : gy;
      const A term = (isinf(zmap[r]) ? (A)0 : zmap[r]) * gx;
      if (!isnan(term)) acc.g_invgam += term;
    }
  }
  for (int c = 0; c < 3; ++c) acc.gsc[kBg + c] += wb * g_rgb[c];

  PT_PHASE_AT(3, clk, sink.lane_id());

  // ---- det2 adjoint, shared part: the z_inv_max clamp ----------------------
  A sum_gz = 0.0f;
  for (int r = 0; r < C; ++r) sum_gz += gz[r];
  const A g_zmax = -sum_gz * tie_max(zmax_raw, (A)p.eps_bg);
  int ties = 0;
  for (int i = 0; i < F; ++i) ties += zinv[i] == zmax_raw ? 1 : 0;
  const A g_share = ties ? g_zmax / (A)ties : (A)0;

  // ---- per slot, in reverse: alpha product, det2, coverage, det1 -----------
  A g_ap = -g_alpha;
  for (int i = F - 1; i >= 0; --i) {
    const A g_p3 = -(g_ap * pre[i]);
    g_ap = g_ap * ((A)1 - prob[i]);
    const bool cand = mk[i] != 0.0f;
    if (!sink.any(cand)) continue;
    float gslot[kGeo + 9];
    for (int d = 0; d < kGeo + 9; ++d) gslot[d] = 0.0f;
    int cell = -1;
    float gcell[3] = {0.0f, 0.0f, 0.0f};
    if (cand) {
      // det2: zmap_i = scaled_i + zinv_i - zmax (bg_row never a candidate).
      const A g_zm = gz[i];
      const A g_zinv = g_zm + (zinv[i] == zmax_raw ? g_share : (A)0);
      const A lp = log((A)prob[i]);
      A g_lp;
      if (hard_agg) {
        g_lp = (A)1e-6f * g_zm;
      } else {
        const A gy = gal * g_zm;
        g_lp = isnan(gy) ? (A)0 : gy;
        const A term = (isinf(lp) ? (A)0 : lp) * g_zm;
        if (!isnan(term)) acc.g_gal += term;
      }
      A inv = (A)1 / (A)prob[i];
      if (isinf(inv)) inv = 0.0f;
      const A g_p2 = inv * g_lp;
      const A g_q = g_zinv * mk[i];
      const A num = (A)zfar - zz[i];
      const A g_num = g_q / zden;
      const A g_den = -g_q * num / (zden * zden);
      acc.gsc[kZfar] += g_num + g_den;
      acc.gsc[kZnear] -= g_den;
      const A g_z = -g_num;
      // coverage
      const A g_raw = (g_p3 + g_p2) * mk[i];
      A g_dist = 0.0f;
      if (p.rast_kind == kRastMC) {
        const A g_d = coeff[i] * g_raw;
        g_dist = -g_d;
        acc.gsc[kSigma] += g_d;
      } else if (p.rast_kind != kRastHard) {
        const float nd = -dist[i];
        const float x = nd / sigma;
        A g_x;
        if (p.rast_kind == kRastSoft) {
          g_x = g_raw * prob[i] * ((A)1 - prob[i]);
        } else {
          const float p1 = x > 0.5f ? 1.0f : x + 0.5f;
          g_x = x > 0.5f ? (A)0 : g_raw * tie_max(p1, 0.0f);
        }
        g_dist = -(g_x / sigma);
        acc.gsc[kSigma] += -g_x * nd / ((A)sigma * (A)sigma);
      }
      const A g_col[3] = {wts[i] * g_rgb[0], wts[i] * g_rgb[1],
                          wts[i] * g_rgb[2]};
      face_backward(p, T, i, px, py, g_dist, g_z, g_col, gslot, &cell, gcell,
                    acc.gsc);
    }
    const int D = kGeo + p.tex_d;
    float* row = sink.row(i * D);
    for (int d = 0; d < 9; ++d) sink.add(row, d, gslot[d]);
    if (p.phong)
      for (int d = 9; d < kGeo; ++d) sink.add(row, d, gslot[d]);
    const int dense = p.atlas_r == 0 ? 9 : (p.atlas_r == 1 ? 3 : 0);
    for (int d = kGeo; d < kGeo + dense; ++d) sink.add(row, d, gslot[d]);
    if (p.atlas_r > 1) sink.add_cell(row + kGeo, cand, cell, gcell);
  }
  PT_PHASE_AT(4, clk, sink.lane_id());
}

// K11b's pipeline of one pixel (the JAX _agg_bwd_kernel): the MC
// aggregation's backward alone, on this shard's aggregation samples,
// given the coverage mean prob_ext over the sample group and K4's output
// cotangent g_out (extra).  det1's geometry (from the faces' FaceConst
// fc, only of the slots whose grown box holds the pixel: the others are no
// candidates there), det2 (z_map from prob_ext),
// then, under variance reduction, the certainty rule (agg_may_win): a
// pixel where only one row may reach a sample's max has that row, the
// baseline's first max, as every sample's one-hot, so oh - w0 = 0 in
// every row and sample, and g_zmap and the gamma term are +0, as the
// replay would give them; it stops there (*certain).  Without variance
// reduction dot = gw[winner] and the replay runs.  The other pixels shade
// their candidates (the blend's weight cotangent) and run one replay of
// the aggregation noise: g_zmap's C rows into gz and the pixel's gamma
// term, returned.  A pixel of an inactive tile gives zeros (bg_only).
// Phases of a -DPT_PROFILE build (lane 0): 0 det1's geometry, z_map and
// the certainty test, 1 shading and the replay.
template <int MAXF>
PT_HD float pixel_agg_grads(const Params& p, const Tables& T,
                            const FaceConst* fc, int b, int pix,
                            float gz[MAXF + 8], bool* certain = nullptr) {
  constexpr int MAXC = MAXF + 8;
  const int F = p.f_pad, C = p.c_zpad;
  const size_t npix = (size_t)p.image_size * p.image_size;
  for (int r = 0; r < C; ++r) gz[r] = 0.0f;
  if (!pixel_active(p, b, pix)) return 0.0f;
  PT_MARK(clk);
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  float zz[MAXF], mk[MAXF], prob[MAXF];
  for (int i = 0; i < F; ++i) {
    float d, w3[3];
    zz[i] = mk[i] = 0.0f;
    if (face_near(fc[i], px, py))
      face_geometry_at(p, fc[i], T.sc[kBlur], px, py, &d, &zz[i], &mk[i], w3);
    prob[i] = p.prob_ext[((size_t)b * F + i) * npix + pix];
  }
  float zinv[MAXF], zmap[MAXC], zmax_raw, gal;
  z_map_rows<MAXF, float>(p, T.sc, prob, zz, mk, zinv, &zmax_raw, &gal, zmap);
  if (p.agg_vr) {
    const float gb = fabsf(T.sc[kGamma]) * noise_bound(p.agg_noise);
    const float lim = agg_lim(zmap, C, gb);
    int may = 0;
    for (int r = 0; r < C; ++r) may += agg_may_win(zmap[r], gb, lim) ? 1 : 0;
    if (may == 1) {
      if (certain != nullptr) *certain = true;
      PT_PHASE_AT(0, clk, threadIdx.x & 31);
      return 0.0f;
    }
  }
  PT_PHASE_AT(0, clk, threadIdx.x & 31);
  // The candidates' colours (a slot that is not one: colour 0, weight 0).
  float col0[MAXF], col1[MAXF], col2[MAXF];
  for (int i = 0; i < F; ++i) {
    float c3[3] = {0.0f, 0.0f, 0.0f};
    if (mk[i] != 0.0f) {
      float d, z, m, w3[3];
      face_geometry_at(p, fc[i], T.sc[kBlur], px, py, &d, &z, &m, w3);
      face_shade(p, T, i, m, w3, c3);
    }
    col0[i] = c3[0];
    col1[i] = c3[1];
    col2[i] = c3[2];
  }
  const float* go = p.extra + ((size_t)b * npix + pix) * 4;
  const float g_rgb[3] = {go[0], go[1], go[2]};
  float gw[MAXC], wts[MAXC];
  blend_cotangent<MAXF, float>(p, T.sc, col0, col1, col2, g_rgb, gw);
  const float term = mc_agg_replay<MAXC, float>(
      p, T.sc, b, (uint32_t)pix, zmap, gw, first_max(zmap, C), false, true,
      wts, gz);
  PT_PHASE_AT(1, clk, threadIdx.x & 31);
  return term;
}

// The thread's last step: scalar gradients and the loss into the sink.
template <class Sink, class Acc>
PT_HD void finish_pixels(const Params& p, const Tables& T, Sink& sink,
                         Acc& acc) {
  const float* sc = T.sc;
  if (p.agg_kind != kAggHard) {     // z_map's gamma / alpha factor
    acc.gsc[kGamma] += acc.g_gal / sc[kAlpha];
    acc.gsc[kAlpha] += -acc.g_gal * sc[kGamma] / (sc[kAlpha] * sc[kAlpha]);
  }
  acc.gsc[kGamma] += -acc.g_invgam / (sc[kGamma] * sc[kGamma]);
  float* row = sink.row(p.f_pad * (kGeo + p.tex_d));
  for (int k = 0; k < kNS; ++k) sink.add(row, k, acc.gsc[k]);
  sink.add(row, kNS, acc.loss);
}

#ifdef __CUDACC__
__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane ends with the same bits (a + b == b + a).
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums each value over the warp's 32 lanes into the warp's partial row.
struct WarpSink {
  float* part;
  int lane;
  __device__ int lane_id() const { return lane; }
  __device__ bool any(bool x) { return __ballot_sync(0xffffffffu, x) != 0; }
  __device__ bool all(bool x) { return __all_sync(0xffffffffu, x) != 0; }
  __device__ float* row(int off) { return part + off; }
  __device__ void add(float* row, int d, float v) {
    v = warp_sum(v);
    if (lane == (d & 31)) row[d] += v;
  }
  // Atlas texels: one sum per distinct cell among the lanes that have one.
  __device__ void add_cell(float* row, bool has, int cell,
                           const float g[3]) {
    unsigned todo = __ballot_sync(0xffffffffu, has);
    while (todo) {
      const int leader = __ffs(todo) - 1;
      const int lc = __shfl_sync(0xffffffffu, cell, leader);
      const bool mine = has && cell == lc;
      for (int c = 0; c < 3; ++c) {
        const float v = warp_sum(mine ? g[c] : 0.0f);
        if (lane == c) row[lc * 3 + c] += v;
      }
      todo &= ~__ballot_sync(0xffffffffu, mine);
    }
  }
};

template <int MAXF, bool LOSS, bool EXT = false>
__global__ void __launch_bounds__(kThreads)
fused_grad_kernel(const Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const Tables T = load_tables(p, smem, b);
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  WarpSink sink{p.partial + ((size_t)b * p.warps + warp) * p.width,
                (int)(threadIdx.x & 31)};
  // The warp's row starts at zero (no memset of the buffer).
  for (int d = sink.lane; d < p.width; d += 32) sink.part[d] = 0.0f;
  __syncwarp();
  PixelAcc acc;
  for (int k = 0; k < kNS; ++k) acc.gsc[k] = 0.0f;
  acc.g_gal = acc.g_invgam = acc.loss = 0.0f;
  const int npix = p.image_size * p.image_size;
  const int chunks = (npix + kThreads - 1) / kThreads;
  // Every lane of a warp runs every chunk: the sink's shuffles need all 32.
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int pix = chunk * kThreads + threadIdx.x;
    const bool live = pix < npix;
    pixel_grads<MAXF, LOSS, WarpSink, PixelAcc, EXT>(p, T, b, live ? pix : 0,
                                                     live, sink, acc);
  }
  finish_pixels(p, T, sink, acc);
}

// Adds the warps' partial rows and scatters the sums to the gradient
// tables, the scalar row and the loss.  A block takes 32 columns of one
// batch element with kRedRows x 32 threads: thread (x, y) adds the rows of
// its y-th segment in order, then row y = 0 adds the kRedRows segment sums
// in order, a fixed two-level tree.  (static: K4's, K2's and K11c's
// translation units each have their own copy.)
constexpr int kRedRows = 32;

static __global__ void __launch_bounds__(32 * kRedRows)
grad_reduce_kernel(const Params p) {
  __shared__ float seg_sum[kRedRows][33];
  const int b = blockIdx.y, x = threadIdx.x, y = threadIdx.y;
  const int j = blockIdx.x * 32 + x;
  const int seg = (p.warps + kRedRows - 1) / kRedRows;
  float s = 0.0f;
  if (j < p.width) {
    const float* src = p.partial + (size_t)b * p.warps * p.width + j;
    const int w1 = min(p.warps, (y + 1) * seg);
#pragma unroll 8
    for (int w = y * seg; w < w1; ++w) s += src[(size_t)w * p.width];
  }
  seg_sum[y][x] = s;
  __syncthreads();
  if (y != 0 || j >= p.width) return;
  s = 0.0f;
  for (int k = 0; k < kRedRows; ++k) s += seg_sum[k][x];
  const int F = p.f_pad, D = kGeo + p.tex_d;
  if (j < F * D) {
    const int f = j / D, d = j % D;
    if (d < 9)
      p.g_ndc[((size_t)b * F + f) * 9 + d] = s;
    else if (d < 18)
      p.g_world[((size_t)b * F + f) * 9 + d - 9] = s;
    else if (d < kGeo)
      p.g_fn[((size_t)b * F + f) * 9 + d - 18] = s;
    else
      p.g_tex[((size_t)b * F + f) * p.tex_d + d - kGeo] = s;
  } else if (j < F * D + kNS) {
    p.g_scal[(size_t)b * kNS + j - F * D] = s;
  } else {
    p.loss[b] = s * p.lscale;
  }
}

// Per-warp partial rows: one per warp of every block of every batch
// element, (27 + tex_d) per slot + 34 scalars + the loss.
inline int grad_width(int f_pad, int tex_d) {
  return f_pad * (kGeo + tex_d) + kNS + 1;
}

// Blocks per batch element: one per 128-pixel chunk, fewer when the
// partial rows would pass 64 MiB (each block then loops over chunks).
inline int grad_warps(int n, int image_size, int f_pad, int tex_d) {
  const long long chunks =
      ((long long)image_size * image_size + kThreads - 1) / kThreads;
  const long long per_block = (long long)kWarps * grad_width(f_pad, tex_d) *
                              4 * (n > 0 ? n : 1);
  long long blocks = (64ll << 20) / per_block;
  if (blocks > chunks) blocks = chunks;
  if (blocks < 1) blocks = 1;
  return (int)(blocks * kWarps);
}

template <int MAXF, bool LOSS, bool EXT = false>
cudaError_t launch_grads(Params p, int n, cudaStream_t st) {
  if (p.warps % kWarps || p.width != grad_width(p.f_pad, p.tex_d))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * table_floats(p);
  cudaError_t e = allow_smem(fused_grad_kernel<MAXF, LOSS, EXT>, smem);
  if (e != cudaSuccess) return e;
  fused_grad_kernel<MAXF, LOSS, EXT>
      <<<dim3(p.warps / kWarps, n), kThreads, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  grad_reduce_kernel<<<dim3((p.width + 31) / 32, n), dim3(32, kRedRows), 0,
                       st>>>(p);
  return cudaGetLastError();
}

// The pixel kernel's shape for f_pad slots and tex_d texel columns: out[0]
// resident blocks of kThreads per SM (the occupancy API), out[1] registers
// and out[2] local memory bytes per thread, out[3] dynamic shared memory
// bytes.
template <int MAXF, bool LOSS>
int grads_shape(int f_pad, int tex_d, int* out) {
  Params p = {};
  p.f_pad = f_pad;
  p.tex_d = tex_d;
  const size_t smem = sizeof(float) * table_floats(p);
  cudaError_t e = allow_smem(fused_grad_kernel<MAXF, LOSS>, smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fused_grad_kernel<MAXF, LOSS>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_grad_kernel<MAXF, LOSS>, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)smem;
  return 0;
}

template <bool LOSS>
int grads_occupancy(int f_pad, int tex_d, int* out) {
  if (f_pad <= 16) return grads_shape<16, LOSS>(f_pad, tex_d, out);
  if (f_pad <= 32) return grads_shape<32, LOSS>(f_pad, tex_d, out);
  if (f_pad <= 64) return grads_shape<64, LOSS>(f_pad, tex_d, out);
  if (f_pad <= 128) return grads_shape<128, LOSS>(f_pad, tex_d, out);
  if (f_pad <= 256) return grads_shape<256, LOSS>(f_pad, tex_d, out);
  return (int)cudaErrorInvalidValue;
}

// The C entry's body: fills Params and picks the slot bucket.
template <bool LOSS>
int grads_entry(const void* fv_ndc, const void* fv_world, const void* fn,
                const void* tex, const void* valid, const void* scal,
                const void* seeds, const void* extra, void* partial,
                int warps, void* g_ndc, void* g_world, void* g_fn,
                void* g_tex, void* g_scal, void* loss, int n, int image_size,
                int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r,
                int rast_kind, int rast_noise, int rast_vr, int s_rast,
                int agg_kind, int agg_noise, int agg_vr, int s_agg, int k,
                float eps_bg, int phong, int point_light, int clip, int persp,
                int loss_kind, float lscale, const void* active, int nt,
                int p_tile, int tile_w, void* stream) {
  Params p = {};
  p.fv_ndc = (const float*)fv_ndc;
  p.fv_world = (const float*)fv_world;
  p.fn = (const float*)fn;
  p.tex = (const float*)tex;
  p.valid = (const float*)valid;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  p.extra = (const float*)extra;
  p.partial = (float*)partial;
  p.g_ndc = (float*)g_ndc;
  p.g_world = (float*)g_world;
  p.g_fn = (float*)g_fn;
  p.g_tex = (float*)g_tex;
  p.g_scal = (float*)g_scal;
  p.loss = (float*)loss;
  p.warps = warps;
  p.width = grad_width(f_pad, tex_d);
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  p.loss_kind = loss_kind;
  p.lscale = LOSS ? lscale : 0.0f;
  set_tiling(p, active, nt, p_tile, tile_w);
  cudaStream_t st = (cudaStream_t)stream;
  if (f_pad <= 16) return (int)launch_grads<16, LOSS>(p, n, st);
  if (f_pad <= 32) return (int)launch_grads<32, LOSS>(p, n, st);
  if (f_pad <= 64) return (int)launch_grads<64, LOSS>(p, n, st);
  if (f_pad <= 128) return (int)launch_grads<128, LOSS>(p, n, st);
  if (f_pad <= 256) return (int)launch_grads<256, LOSS>(p, n, st);
  return (int)cudaErrorInvalidValue;
}
#endif

}  // namespace ptf
