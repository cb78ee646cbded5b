// The per-pixel gradient pipeline shared by K4 (fused_backward.cu) and K2
// (fused_loss_grad.cu), as the JAX kernels share run_pipeline.
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
// Reduction: a Sink adds each slot's table gradient across the pixels.
// On the card (WarpSink) a warp sums its 32 lanes with a butterfly of
// shuffles and adds the sum to the warp's own row of a partial buffer;
// a second kernel adds the rows in a fixed order.  No atomics, so the
// gradients are the same bits from run to run.
#pragma once

#include "fused_common.cuh"

namespace ptf {

// Per-thread sums across a thread's pixels: the 34 scalar gradients, the
// two reciprocal-scale terms converted once at the end, and the loss.
struct PixelAcc {
  float gsc[kNS];
  float g_gal;      // d loss / d (gamma / alpha)
  float g_invgam;   // d loss / d (1 / gamma), softmax aggregation
  float loss;
};

PT_HD float tie_max(float x, float c) {   // d max(x, c) / dx, JAX rule
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

PT_HD float tie_min(float x, float c) {   // d min(x, c) / dx, JAX rule
  return x < c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

PT_HD float score(float n, int noise) {
  return noise == kGaussian ? n : 2.0f * n / (1.0f + n * n);
}

// Adjoint of edge_dist_sq: adds d(dist)/d(a, b) * g to ga, gb.
PT_HD void edge_backward(float px, float py, float ax, float ay, float bx,
                         float by, float g, float* gax, float* gay,
                         float* gbx, float* gby) {
  const float ex = bx - ax, ey = by - ay;
  const float len = ex * ex + ey * ey;
  const float inv = 1.0f / fmaxf(len, 1e-12f);
  const float exs = ex * inv, eys = ey * inv;
  const float dx = px - ax, dy = py - ay;
  const float tr = dx * exs + dy * eys;
  const float u = fmaxf(tr, 0.0f);
  const float t = fminf(u, 1.0f);
  const float rx = dx - t * ex, ry = dy - t * ey;
  const float g_rx = 2.0f * rx * g, g_ry = 2.0f * ry * g;
  float g_dx = g_rx, g_dy = g_ry;
  const float g_t = -(g_rx * ex + g_ry * ey);
  float g_ex = -g_rx * t, g_ey = -g_ry * t;
  const float g_tr = g_t * tie_min(u, 1.0f) * tie_max(tr, 0.0f);
  g_dx += g_tr * exs;
  g_dy += g_tr * eys;
  const float g_exs = g_tr * dx, g_eys = g_tr * dy;
  g_ex += g_exs * inv;
  g_ey += g_eys * inv;
  const float g_inv = g_exs * ex + g_eys * ey;
  const float g_len = -g_inv * inv * inv * tie_max(len, 1e-12f);
  g_ex += 2.0f * ex * g_len;
  g_ey += 2.0f * ey * g_len;
  *gax += -g_dx - g_ex;
  *gay += -g_dy - g_ey;
  *gbx += g_ex;
  *gby += g_ey;
}

// Adjoint of v / max(|v|, 1e-8) for a 3-vector: g_v from g_u.
PT_HD void normalize_backward(const float v[3], float n_raw,
                              const float g_u[3], float g_v[3]) {
  const float n = fmaxf(n_raw, 1e-8f);
  float g_n = 0.0f;
  for (int c = 0; c < 3; ++c) {
    g_v[c] = g_u[c] / n;
    g_n -= g_u[c] * v[c] / (n * n);
  }
  g_n *= tie_max(n_raw, 1e-8f);
  for (int c = 0; c < 3; ++c)
    g_v[c] += n_raw > 0.0f ? g_n * v[c] / n_raw : 0.0f;
}

// det1's adjoint for a candidate slot i: recomputes the geometry and
// shading of face_forward and pulls (g_dist, g_z, g_col) back to the
// slot's tables.  gslot: [0, 9) ndc, [9, 18) world, [18, 27) normals,
// [27, 27 + 9) corner texels (or [27, 30) for a one-cell atlas); an atlas
// with more cells reports its cell and gcell instead.
PT_HD void face_backward(const Params& p, const Tables& T, int i, float px,
                         float py, float g_dist, float g_z,
                         const float g_col[3], float* gslot, int* cell_out,
                         float gcell[3], float* gsc) {
  const float* sc = T.sc;
  const float* v = T.ndc + i * T.rs_geo;
  const float ax = v[0], ay = v[1], az = v[2], bx = v[3], by = v[4],
              bz = v[5], cx = v[6], cy = v[7], cz = v[8];
  const float vz[3] = {az, bz, cz};
  // ---- forward recompute (as face_forward) -------------------------------
  const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  const bool degen = fabsf(area) < 1e-10f;
  const float ia = 1.0f / (degen ? 1.0f : area);
  const float e0x = (cy - by) * ia, e0y = (cx - bx) * ia;
  const float e1x = (ay - cy) * ia, e1y = (ax - cx) * ia;
  const float w0r = e0y * py - e0x * px + (e0x * bx - e0y * by);
  const float w1r = e1y * py - e1x * px + (e1x * cx - e1y * cy);
  const float wr[3] = {w0r, w1r, 1.0f - w0r - w1r};
  const bool inside = wr[0] >= 0.0f && wr[1] >= 0.0f && wr[2] >= 0.0f &&
                      !degen;
  const float d0 = edge_dist_sq(px, py, ax, ay, bx, by);
  const float d1 = edge_dist_sq(px, py, bx, by, cx, cy);
  const float d2 = edge_dist_sq(px, py, cx, cy, ax, ay);
  float mz[3], sp[3], wp[3], sum_s = 0.0f, den_p = 1.0f;
  for (int k = 0; k < 3; ++k) wp[k] = wr[k];
  if (p.persp) {
    for (int k = 0; k < 3; ++k) {
      mz[k] = fmaxf(vz[k], 1e-8f);
      sp[k] = wr[k] / mz[k];
    }
    sum_s = sp[0] + sp[1] + sp[2];
    den_p = fmaxf(sum_s, 1e-12f);
    for (int k = 0; k < 3; ++k) wp[k] = sp[k] / den_p;
  }
  float cc[3], w[3], sum_c = 0.0f, den_c = 1.0f;
  for (int k = 0; k < 3; ++k) w[k] = wp[k];
  if (p.clip) {
    for (int k = 0; k < 3; ++k) cc[k] = fmaxf(wp[k], 0.0f);
    sum_c = cc[0] + cc[1] + cc[2];
    den_c = fmaxf(sum_c, 1e-12f);
    for (int k = 0; k < 3; ++k) w[k] = cc[k] / den_c;
  }

  // ---- texel + shading adjoint -> g_w (final barycentrics) ----------------
  float g_w[3] = {0.0f, 0.0f, 0.0f};
  const float* t = T.tex + i * T.rs_tex;
  float texel[3];
  int cell = -1;
  if (p.atlas_r == 0) {
    for (int c = 0; c < 3; ++c)
      texel[c] = w[0] * t[c] + w[1] * t[3 + c] + w[2] * t[6 + c];
  } else {
    const int r = p.atlas_r;
    const int xi = min(max((int)(fminf(fmaxf(w[1], 0.0f), 1.0f) * r), 0),
                       r - 1);
    const int yi = min(max((int)(fminf(fmaxf(w[2], 0.0f), 1.0f) * r), 0),
                       r - 1);
    cell = yi * r + xi;
    for (int c = 0; c < 3; ++c) texel[c] = t[cell * 3 + c];
  }
  float g_texel[3];
  if (p.phong) {
    const float* fw = T.world + i * T.rs_geo;
    const float* fnn = T.fn + i * T.rs_geo;
    float pnt[3], nrm[3], tl[3], vd[3];
    for (int c = 0; c < 3; ++c) {
      pnt[c] = w[0] * fw[c] + w[1] * fw[3 + c] + w[2] * fw[6 + c];
      nrm[c] = w[0] * fnn[c] + w[1] * fnn[3 + c] + w[2] * fnn[6 + c];
      tl[c] = p.point_light ? sc[kLight + c] - pnt[c] : -sc[kLight + c];
      vd[c] = sc[kCam + c] - pnt[c];
    }
    const float tln = sqrtf(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2]);
    const float vdn = sqrtf(vd[0] * vd[0] + vd[1] * vd[1] + vd[2] * vd[2]);
    float tlu[3], vdu[3];
    for (int c = 0; c < 3; ++c) {
      tlu[c] = tl[c] / fmaxf(tln, 1e-8f);
      vdu[c] = vd[c] / fmaxf(vdn, 1e-8f);
    }
    const float cosv = nrm[0] * tlu[0] + nrm[1] * tlu[1] + nrm[2] * tlu[2];
    const float cos2 = 2.0f * cosv;
    float refl[3];
    for (int c = 0; c < 3; ++c) refl[c] = cos2 * nrm[c] - tlu[c];
    const float sa_raw =
        vdu[0] * refl[0] + vdu[1] * refl[1] + vdu[2] * refl[2];
    const float spec_a = fmaxf(sa_raw, 0.0f);
    const float facing = cosv > 0.0f ? 1.0f : 0.0f;
    const float shin = sc[kShin];               // no gradient (JAX)
    const float spec_pow = facing * powf(spec_a, shin);
    const float cmax = fmaxf(cosv, 0.0f);
    float g_cmax = 0.0f, g_spow = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const float ma = sc[kMAmb + c], la = sc[kLAmb + c];
      const float ld = sc[kLDiff + c], md = sc[kMDiff + c];
      const float ls = sc[kLSpec + c], ms = sc[kMSpec + c];
      const float cl = cmax * ld;
      const float g = g_col[c];
      g_texel[c] = g * (ma * la + cl * md);
      const float g_amb = g * texel[c];           // = g_diffuse
      gsc[kMAmb + c] += g_amb * la;
      gsc[kLAmb + c] += g_amb * ma;
      gsc[kMDiff + c] += g_amb * cl;
      const float g_cl = g_amb * md;
      g_cmax += g_cl * ld;
      gsc[kLDiff + c] += g_cl * cmax;
      const float spl = spec_pow * ls;
      gsc[kMSpec + c] += g * spl;
      const float g_spl = g * ms;
      g_spow += g_spl * ls;
      gsc[kLSpec + c] += g_spl * spec_pow;
    }
    const float dpow = shin == 0.0f ? 0.0f : shin * powf(spec_a, shin - 1.0f);
    const float g_sa = g_spow * facing * dpow * tie_max(sa_raw, 0.0f);
    float g_vdu[3], g_refl[3], g_nrm[3], g_tlu[3];
    float g_c2 = 0.0f;
    for (int c = 0; c < 3; ++c) {
      g_vdu[c] = g_sa * refl[c];
      g_refl[c] = g_sa * vdu[c];
      g_c2 += g_refl[c] * nrm[c];
      g_nrm[c] = g_refl[c] * cos2;
      g_tlu[c] = -g_refl[c];
    }
    const float g_cos = 2.0f * g_c2 + g_cmax * tie_max(cosv, 0.0f);
    for (int c = 0; c < 3; ++c) {
      g_nrm[c] += g_cos * tlu[c];
      g_tlu[c] += g_cos * nrm[c];
    }
    float g_vd[3], g_tl[3], g_pnt[3];
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
  float g_vz[3];
  for (int k = 0; k < 3; ++k) {
    g_w[k] += g_z * vz[k];
    g_vz[k] = g_z * w[k];
  }
  // ---- clip, then perspective correction, in reverse -----------------------
  if (p.clip) {
    float g_den = 0.0f, g_cc[3];
    for (int k = 0; k < 3; ++k) {
      g_cc[k] = g_w[k] / den_c;
      g_den -= g_w[k] * cc[k] / (den_c * den_c);
    }
    const float g_sum = g_den * tie_max(sum_c, 1e-12f);
    for (int k = 0; k < 3; ++k)
      g_w[k] = (g_cc[k] + g_sum) * tie_max(wp[k], 0.0f);
  }
  if (p.persp) {
    float g_den = 0.0f, g_sp[3];
    for (int k = 0; k < 3; ++k) {
      g_sp[k] = g_w[k] / den_p;
      g_den -= g_w[k] * sp[k] / (den_p * den_p);
    }
    const float g_sum = g_den * tie_max(sum_s, 1e-12f);
    for (int k = 0; k < 3; ++k) {
      const float g_s = g_sp[k] + g_sum;
      g_w[k] = g_s / mz[k];
      g_vz[k] -= g_s * wr[k] / (mz[k] * mz[k]) * tie_max(vz[k], 1e-8f);
    }
  }
  // ---- raw barycentrics (edge functions) -----------------------------------
  float gax = 0.0f, gay = 0.0f, gbx = 0.0f, gby = 0.0f, gcx = 0.0f,
        gcy = 0.0f;
  const float g_w0 = g_w[0] - g_w[2], g_w1 = g_w[1] - g_w[2];
  const float g_e0y = g_w0 * py - g_w0 * by;
  const float g_e0x = g_w0 * bx - g_w0 * px;
  gbx += g_w0 * e0x;
  gby -= g_w0 * e0y;
  const float g_e1y = g_w1 * py - g_w1 * cy;
  const float g_e1x = g_w1 * cx - g_w1 * px;
  gcx += g_w1 * e1x;
  gcy -= g_w1 * e1y;
  float g_ia = 0.0f;
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
    const float g_area = -g_ia * ia * ia;
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
  const float g_min = inside ? -g_dist : g_dist;
  const float m12 = fminf(d1, d2);
  const float g_d0 = g_min * tie_min(d0, m12);
  const float g_m12 = g_min * tie_min(m12, d0);
  edge_backward(px, py, ax, ay, bx, by, g_d0, &gax, &gay, &gbx, &gby);
  edge_backward(px, py, bx, by, cx, cy, g_m12 * tie_min(d1, d2), &gbx, &gby,
                &gcx, &gcy);
  edge_backward(px, py, cx, cy, ax, ay, g_m12 * tie_min(d2, d1), &gcx, &gcy,
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

// The gradient pipeline of one pixel.  LOSS: K2 (cotangent from the
// target), else K4 (cotangent g_out).  Sink: the reduction across pixels.
template <int MAXF, bool LOSS, class Sink>
PT_HD void pixel_grads(const Params& p, const Tables& T, int b, int pix,
                       bool live, Sink& sink, PixelAcc& acc) {
  constexpr int MAXC = MAXF + 8;
  const int F = p.f_pad, C = p.c_zpad, bg = p.bg_row;
  const int npix = p.image_size * p.image_size;
  const float* sc = T.sc;
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;

  // ---- det1 ----------------------------------------------------------------
  float dist[MAXF], zz[MAXF], mk[MAXF], col0[MAXF], col1[MAXF], col2[MAXF];
  for (int i = 0; i < F; ++i) {
    float c3[3];
    face_forward(p, T, i, px, py, live, &dist[i], &zz[i], &mk[i], c3);
    col0[i] = c3[0];
    col1[i] = c3[1];
    col2[i] = c3[2];
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

  // ---- det2: z_map ---------------------------------------------------------
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const float zden = zfar - znear;
  float zinv[MAXF];
  float zmax_raw = -INFINITY;
  for (int i = 0; i < F; ++i) {
    zinv[i] = (zfar - zz[i]) / zden * mk[i];
    zmax_raw = fmaxf(zmax_raw, zinv[i]);
  }
  const float zmax = fmaxf(zmax_raw, p.eps_bg);
  const bool hard_agg = p.agg_kind == kAggHard;
  const float gal = hard_agg ? 1e-6f : sc[kGamma] / sc[kAlpha];
  float zmap[MAXC];
  for (int i = 0; i < F; ++i) zmap[i] = gal * logf(prob[i]) + zinv[i] - zmax;
  for (int r = F; r < C; ++r) zmap[r] = -INFINITY;
  zmap[bg] = p.eps_bg - zmax;

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
  float gw[MAXC];
  auto build_gw = [&]() {
    for (int i = 0; i < F; ++i)
      gw[i] = col0[i] * g_rgb[0] + col1[i] * g_rgb[1] + col2[i] * g_rgb[2];
    for (int r = F; r < C; ++r) gw[r] = 0.0f;
    gw[bg] = sc[kBg] * g_rgb[0] + sc[kBg + 1] * g_rgb[1] +
             sc[kBg + 2] * g_rgb[2];
  };

  // ---- aggregation: weights, and g_zmap ------------------------------------
  const float gamma = sc[kGamma];
  float wts[MAXC], gz[MAXC];
  for (int r = 0; r < C; ++r) gz[r] = 0.0f;
  int first = -1;                 // first-wins argmax of z_map (VR baseline)
  {
    float mx = -INFINITY;
    for (int r = 0; r < C; ++r) mx = fmaxf(mx, zmap[r]);
    for (int r = C - 1; r >= 0; --r)
      if (zmap[r] >= mx) first = r;
  }
  const uint32_t a0 = (uint32_t)p.seeds[b * 4 + 2];
  const uint32_t a1 = (uint32_t)p.seeds[b * 4 + 3];
  // One replay of the MC aggregation noise: accumulates the weights
  // (want_w) and the score-function terms of g_zmap and gamma (want_g).
  auto mc_agg = [&](bool want_w, bool want_g) {
    float nz[MAXC], pert[MAXC];
    float g_gam = 0.0f;
    const float phi_comp = (float)(p.k - bg);
    if (want_w)
      for (int r = 0; r < C; ++r) wts[r] = 0.0f;
    for (int s = 0; s < p.s_agg; ++s) {
      draw_noise<MAXC>(nz, C, p.agg_noise, a0, a1, s, pos);
      float mx = -INFINITY;
      for (int r = 0; r < C; ++r) {
        pert[r] = zmap[r] + gamma * nz[r];
        mx = fmaxf(mx, pert[r]);
      }
      if (want_w)
        for (int r = 0; r < C; ++r) wts[r] += pert[r] >= mx ? 1.0f : 0.0f;
      if (want_g) {
        // Rows past bg_row are -inf and never win; their noise is masked.
        float dot = 0.0f, phi = 0.0f;
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
      const float inv_s = 1.0f / (float)p.s_agg;
      for (int r = 0; r < C; ++r) wts[r] = wts[r] * inv_s;
    }
    if (want_g) {
      const float sg = (float)p.s_agg * gamma;
      for (int r = 0; r < C; ++r) gz[r] = gz[r] / sg;
      acc.gsc[kGamma] += g_gam / sg;
    }
  };
  if (p.agg_kind == kAggMC) {
    if (!LOSS) build_gw();
    mc_agg(true, !LOSS);            // K4: forward and backward in one pass
  } else if (p.agg_kind == kAggSoft) {
    const float inv_gamma = 1.0f / gamma;
    float mx = -INFINITY;
    for (int r = 0; r < C; ++r) {
      wts[r] = inv_gamma * zmap[r];
      mx = fmaxf(mx, wts[r]);
    }
    float sum = 0.0f;
    for (int r = 0; r < C; ++r) {
      wts[r] = expf(wts[r] - mx);
      sum += wts[r];
    }
    for (int r = 0; r < C; ++r) wts[r] = wts[r] / sum;
  } else {
    for (int r = 0; r < C; ++r) wts[r] = r == first ? 1.0f : 0.0f;
  }

  // ---- blend (forward) -----------------------------------------------------
  float rgb[3] = {0.0f, 0.0f, 0.0f}, ap = 1.0f, pre[MAXF];
  for (int i = 0; i < F; ++i) {
    rgb[0] += wts[i] * col0[i];
    rgb[1] += wts[i] * col1[i];
    rgb[2] += wts[i] * col2[i];
    pre[i] = ap;
    ap = ap * (1.0f - prob[i]);
  }
  const float wb = wts[bg];
  for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + wb * sc[kBg + c];

  // ---- image loss and its cotangent (K2) -----------------------------------
  if (LOSS) {
    if (live) {
      const float* tg = p.extra + (size_t)b * 3 * npix + pix;
      for (int c = 0; c < 3; ++c) {
        const float d = rgb[c] - tg[(size_t)c * npix];
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
  if (p.agg_kind == kAggSoft) {
    if (!LOSS) build_gw();
    const float inv_gamma = 1.0f / gamma;
    float sdot = 0.0f;
    for (int r = 0; r < C; ++r) sdot += wts[r] * gw[r];
    for (int r = 0; r < C; ++r) {
      const float gx = wts[r] * (gw[r] - sdot);
      const float gy = inv_gamma * gx;
      gz[r] = isnan(gy) ? 0.0f : gy;
      const float term = (isinf(zmap[r]) ? 0.0f : zmap[r]) * gx;
      if (!isnan(term)) acc.g_invgam += term;
    }
  }
  for (int c = 0; c < 3; ++c) acc.gsc[kBg + c] += wb * g_rgb[c];

  // ---- det2 adjoint, shared part: the z_inv_max clamp ----------------------
  float sum_gz = 0.0f;
  for (int r = 0; r < C; ++r) sum_gz += gz[r];
  const float g_zmax = -sum_gz * tie_max(zmax_raw, p.eps_bg);
  int ties = 0;
  for (int i = 0; i < F; ++i) ties += zinv[i] == zmax_raw ? 1 : 0;
  const float g_share = ties ? g_zmax / (float)ties : 0.0f;

  // ---- per slot, in reverse: alpha product, det2, coverage, det1 -----------
  float g_ap = -g_alpha;
  for (int i = F - 1; i >= 0; --i) {
    const float g_p3 = -(g_ap * pre[i]);
    g_ap = g_ap * (1.0f - prob[i]);
    const bool cand = mk[i] != 0.0f;
    if (!sink.any(cand)) continue;
    float gslot[kGeo + 9];
    for (int d = 0; d < kGeo + 9; ++d) gslot[d] = 0.0f;
    int cell = -1;
    float gcell[3] = {0.0f, 0.0f, 0.0f};
    if (cand) {
      // det2: zmap_i = scaled_i + zinv_i - zmax (bg_row never a candidate).
      const float g_zm = gz[i];
      const float g_zinv = g_zm + (zinv[i] == zmax_raw ? g_share : 0.0f);
      const float lp = logf(prob[i]);
      float g_lp;
      if (hard_agg) {
        g_lp = 1e-6f * g_zm;
      } else {
        const float gy = gal * g_zm;
        g_lp = isnan(gy) ? 0.0f : gy;
        const float term = (isinf(lp) ? 0.0f : lp) * g_zm;
        if (!isnan(term)) acc.g_gal += term;
      }
      float inv = 1.0f / prob[i];
      if (isinf(inv)) inv = 0.0f;
      const float g_p2 = inv * g_lp;
      const float g_q = g_zinv * mk[i];
      const float num = zfar - zz[i];
      const float g_num = g_q / zden;
      const float g_den = -g_q * num / (zden * zden);
      acc.gsc[kZfar] += g_num + g_den;
      acc.gsc[kZnear] -= g_den;
      const float g_z = -g_num;
      // coverage
      const float g_raw = (g_p3 + g_p2) * mk[i];
      float g_dist = 0.0f;
      if (p.rast_kind == kRastMC) {
        const float g_d = coeff[i] * g_raw;
        g_dist = -g_d;
        acc.gsc[kSigma] += g_d;
      } else if (p.rast_kind != kRastHard) {
        const float nd = -dist[i];
        const float x = nd / sigma;
        float g_x;
        if (p.rast_kind == kRastSoft) {
          g_x = g_raw * prob[i] * (1.0f - prob[i]);
        } else {
          const float p1 = x > 0.5f ? 1.0f : x + 0.5f;
          g_x = x > 0.5f ? 0.0f : g_raw * tie_max(p1, 0.0f);
        }
        g_dist = -(g_x / sigma);
        acc.gsc[kSigma] += -g_x * nd / (sigma * sigma);
      }
      const float g_col[3] = {wts[i] * g_rgb[0], wts[i] * g_rgb[1],
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
}

// The thread's last step: scalar gradients and the loss into the sink.
template <class Sink>
PT_HD void finish_pixels(const Params& p, const Tables& T, Sink& sink,
                         PixelAcc& acc) {
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
  __device__ bool any(bool x) { return __ballot_sync(0xffffffffu, x) != 0; }
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

template <int MAXF, bool LOSS>
__global__ void __launch_bounds__(kThreads)
fused_grad_kernel(const Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const Tables T = load_tables(p, smem, b);
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  WarpSink sink{p.partial + ((size_t)b * p.warps + warp) * p.width,
                (int)(threadIdx.x & 31)};
  PixelAcc acc;
  for (int k = 0; k < kNS; ++k) acc.gsc[k] = 0.0f;
  acc.g_gal = acc.g_invgam = acc.loss = 0.0f;
  const int npix = p.image_size * p.image_size;
  const int chunks = (npix + kThreads - 1) / kThreads;
  // Every lane of a warp runs every chunk: the sink's shuffles need all 32.
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int pix = chunk * kThreads + threadIdx.x;
    const bool live = pix < npix;
    pixel_grads<MAXF, LOSS>(p, T, b, live ? pix : 0, live, sink, acc);
  }
  finish_pixels(p, T, sink, acc);
}

// Adds the warps' partial rows in a fixed order and scatters the sums to
// the gradient tables, the scalar row and the loss.  (static: K4's and
// K2's translation units each have their own copy.)
static __global__ void grad_reduce_kernel(const Params p) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.width) return;
  const float* src = p.partial + (size_t)b * p.warps * p.width + j;
  float s = 0.0f;
  for (int w = 0; w < p.warps; ++w) s += src[(size_t)w * p.width];
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

template <int MAXF, bool LOSS>
cudaError_t launch_grads(Params p, int n, cudaStream_t st) {
  if (p.warps % kWarps || p.width != grad_width(p.f_pad, p.tex_d))
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * table_floats(p);
  cudaError_t e = allow_smem(fused_grad_kernel<MAXF, LOSS>, smem);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(p.partial, 0,
                      sizeof(float) * (size_t)n * p.warps * p.width, st);
  if (e != cudaSuccess) return e;
  fused_grad_kernel<MAXF, LOSS>
      <<<dim3(p.warps / kWarps, n), kThreads, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  grad_reduce_kernel<<<dim3((p.width + 127) / 128, n), 128, 0, st>>>(p);
  return cudaGetLastError();
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
