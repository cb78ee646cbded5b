// Pieces shared by the fused kernels: the flat route's K3
// (fused_forward.cu), K4 (fused_backward.cu) and K2 (fused_loss_grad.cu),
// the binned route's K12 (fused_binned.cu) and the stream route's K5-K7
// (stream_grad.cuh).
//
// The packed scalar layout, the launch parameters, the tiling and its
// activity bits, the shared-memory face tables, the noise draws, det1 —
// the per-(slot, pixel) geometry, texel select and Phong shading of
// _make_det1 (pertrenderer_tpu/ops/fused_render.py:324) — and the forward
// pipeline of one pixel (pixel_forward).  The functions outside the
// __CUDACC__ block use no CUDA intrinsics, so with the CUDA keywords
// defined away the gradient kernels' per-pixel arithmetic also compiles
// with a host compiler and can be held against the plain PyTorch version
// without a card.
#pragma once

#include <math.h>
#include <stdint.h>

#include "hash_prng.cuh"

#define PT_HD __device__ __forceinline__
#define PT_HOST_HD __host__ __device__ __forceinline__

namespace ptf {

constexpr int kNS = 34;
constexpr int kLight = 0, kLAmb = 3, kLDiff = 6, kLSpec = 9, kMAmb = 12,
              kMDiff = 15, kMSpec = 18, kShin = 21, kCam = 22, kBg = 25,
              kZnear = 28, kZfar = 29, kSigma = 30, kGamma = 31, kAlpha = 32,
              kBlur = 33;
enum Rast { kRastSoft = 0, kRastAffine = 1, kRastHard = 2, kRastMC = 3 };
enum Agg { kAggSoft = 0, kAggHard = 1, kAggMC = 2 };
enum Noise { kGaussian = 1, kCauchy = 2 };
enum Loss { kL2 = 0, kL1 = 1 };
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGeo = 27;   // per-slot columns of fv_ndc, fv_world and fn

struct Params {
  const float* fv_ndc;    // (N, F, 9)
  const float* fv_world;  // (N, F, 9)
  const float* fn;        // (N, F, 9)
  const float* tex;       // (N, F, tex_d)
  const float* valid;     // (N, F)
  const float* scal;      // (N, 34)
  const int* seeds;       // (N, 4): rast0, rast1, agg0, agg1
  float* out;             // K3: (N, H, W, 4)
  const float* extra;     // K4: g_out (N, H, W, 4); K2: target (N, 3, H*W)
  float* partial;         // K4/K2: (N, warps, width) per-warp sums
  float *g_ndc, *g_world, *g_fn, *g_tex, *g_scal, *loss;
  int warps, width;
  int image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r;
  int rast_kind, rast_noise, rast_vr, s_rast;
  int agg_kind, agg_noise, agg_vr, s_agg, k;
  float eps_bg;
  int phong, point_light, clip, persp;
  int loss_kind;
  float lscale;
  // Tiling, both routes: JAX's tiles of p_tile pixels, 2-D of
  // (p_tile / tile_w, tile_w) or row-major strips (tile_w 0), and their
  // activity bits (N, nt); a null `active` marks every tile active.
  const int* active;
  int nt, p_tile, tile_w;
  // The stream route: the sorted table (N, rw, dt), each tile's chunk list
  // (N, nt, nch) and count (N, nt); the gradient kernels' visits (voff,
  // vstart, vidx: fused_render._stream_visit_index) and scalar partials.
  const float* tab;
  const int *rows, *count, *voff, *vstart, *vidx;
  float *pscal, *g_tab;
  int nch, rw, dt;
  // The binned route's K12: each tile's 34 scalar gradients and loss
  // (N, nt, 35), in double.
  double* pscal64;
};

// The static configuration, in the order every C entry takes it (the
// wrappers' fused_render._cfg_args).
inline void set_config(Params& p, int image_size, int f_pad, int bg_row,
                       int c_zpad, int tex_d, int atlas_r, int rast_kind,
                       int rast_noise, int rast_vr, int s_rast, int agg_kind,
                       int agg_noise, int agg_vr, int s_agg, int k,
                       float eps_bg, int phong, int point_light, int clip,
                       int persp) {
  p.image_size = image_size;
  p.f_pad = f_pad;
  p.bg_row = bg_row;
  p.c_zpad = c_zpad;
  p.tex_d = tex_d;
  p.atlas_r = atlas_r;
  p.rast_kind = rast_kind;
  p.rast_noise = rast_noise;
  p.rast_vr = rast_vr;
  p.s_rast = s_rast;
  p.agg_kind = agg_kind;
  p.agg_noise = agg_noise;
  p.agg_vr = agg_vr;
  p.s_agg = s_agg;
  p.k = k;
  p.eps_bg = eps_bg;
  p.phong = phong;
  p.point_light = point_light;
  p.clip = clip;
  p.persp = persp;
}

// The tiling and activity bits, as the C entries take them.
inline void set_tiling(Params& p, const void* active, int nt, int p_tile,
                       int tile_w) {
  p.active = (const int*)active;
  p.nt = nt;
  p.p_tile = p_tile;
  p.tile_w = tile_w;
}

// One batch element's face tables (shared memory on the card).  Row i of
// a table starts at i * its row stride: flat tables are separate arrays
// (strides 9, tex_d and 1); a stream chunk is one row-major block whose
// validity column is the sort key (valid below 1e30, key_valid).
struct Tables {
  const float *ndc, *world, *fn, *valid, *sc, *tex;
  int rs_geo, rs_tex, rs_valid;
  bool key_valid;
};

PT_HOST_HD size_t table_floats(const Params& p) {
  return (size_t)p.f_pad * (kGeo + 1 + p.tex_d) + kNS;
}

PT_HOST_HD Tables tables_at(const Params& p, float* base) {
  const int F = p.f_pad;
  Tables t;
  t.ndc = base;
  t.world = base + F * 9;
  t.fn = base + F * 18;
  t.valid = base + F * 27;
  t.sc = base + F * 28;
  t.tex = base + F * 28 + kNS;
  t.rs_geo = 9;
  t.rs_tex = p.tex_d;
  t.rs_valid = 1;
  t.key_valid = false;
  return t;
}

// Tile of row-major pixel `pix`.
PT_HD int pixel_tile(const Params& p, int pix) {
  if (p.tile_w) {
    const int th = p.p_tile / p.tile_w, ntx = p.image_size / p.tile_w;
    return (pix / p.image_size / th) * ntx + (pix % p.image_size) / p.tile_w;
  }
  return pix / p.p_tile;
}

// Whether the tile of pixel `pix` of batch element b may have a candidate.
PT_HD bool pixel_active(const Params& p, int b, int pix) {
  return p.active == nullptr || p.active[b * p.nt + pixel_tile(p, pix)] > 0;
}

// Row-major pixel of the i-th pixel of tile t; *inside is false for the
// padding pixels of the last strip.
PT_HD int tile_pixel(const Params& p, int t, int i, bool* inside) {
  const int w = p.image_size;
  if (p.tile_w) {
    const int th = p.p_tile / p.tile_w, ntx = w / p.tile_w;
    *inside = true;
    return ((t / ntx) * th + i / p.tile_w) * w + (t % ntx) * p.tile_w +
           i % p.tile_w;
  }
  const int pix = t * p.p_tile + i;
  *inside = pix < w * w;
  return *inside ? pix : 0;
}

PT_HD float edge_dist_sq(float px, float py, float ax, float ay, float bx,
                         float by) {
  const float ex = bx - ax, ey = by - ay;
  const float inv_denom = 1.0f / fmaxf(ex * ex + ey * ey, 1e-12f);
  const float exs = ex * inv_denom, eys = ey * inv_denom;
  const float dx = px - ax, dy = py - ay;
  const float t = fminf(fmaxf(dx * exs + dy * eys, 0.0f), 1.0f);
  const float rx = dx - t * ex;
  const float ry = dy - t * ey;
  return rx * rx + ry * ry;
}

// One noise block of `rows` rows for sample s: nz[r] is row r's standard
// draw.  Gaussian rows pair up: row h < rows/2 is the cos half of
// hash(h), row h + rows/2 its sin half, so a row's noise depends on the
// block's row count (f_pad for coverage, c_zpad for aggregation).
template <int MAXR>
PT_HD void draw_noise(float (&nz)[MAXR], int rows, int noise, uint32_t s0,
                      uint32_t s1, int s, uint32_t pos) {
  if (noise == kGaussian) {
    const int half = rows / 2;
    for (int h = 0; h < half; ++h)
      ptt::gaussian_pair(ptt::hash_words(s0, s1, s, h, pos), &nz[h],
                         &nz[h + half]);
  } else {
    for (int r = 0; r < rows; ++r)
      nz[r] = ptt::cauchy_draw(ptt::hash_words(s0, s1, s, r, pos));
  }
}

// NDC center of row-major pixel `pix`.
PT_HD void pixel_center(int image_size, int pix, float* px, float* py) {
  const float w = (float)image_size;
  *px = (w - 1.0f - 2.0f * (float)(pix % image_size)) / w;
  *py = (w - 1.0f - 2.0f * (float)(pix / image_size)) / w;
}

// det1 of slot i at pixel (px, py): signed squared edge distance, depth,
// candidacy (1 or 0) and the shaded color (masked like the JAX kernel).
PT_HD void face_forward(const Params& p, const Tables& T, int i, float px,
                        float py, bool live, float* d_out, float* z_out,
                        float* m_out, float col[3]) {
  const float* sc = T.sc;
  const float* v = T.ndc + i * T.rs_geo;
  const float ax = v[0], ay = v[1], az = v[2], bx = v[3], by = v[4],
              bz = v[5], cx = v[6], cy = v[7], cz = v[8];
  const float area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  const bool degen = fabsf(area) < 1e-10f;
  const float inv_area = 1.0f / (degen ? 1.0f : area);
  const float e0x = (cy - by) * inv_area, e0y = (cx - bx) * inv_area;
  float w0 = e0y * py - e0x * px + (e0x * bx - e0y * by);
  const float e1x = (ay - cy) * inv_area, e1y = (ax - cx) * inv_area;
  float w1 = e1y * py - e1x * px + (e1x * cx - e1y * cy);
  float w2 = 1.0f - w0 - w1;
  const bool inside = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && !degen;
  const float d0 = edge_dist_sq(px, py, ax, ay, bx, by);
  const float d1 = edge_dist_sq(px, py, bx, by, cx, cy);
  const float d2 = edge_dist_sq(px, py, cx, cy, ax, ay);
  const float min_d = fminf(d0, fminf(d1, d2));
  const float d = inside ? -min_d : min_d;
  if (p.persp) {
    const float s0 = w0 / fmaxf(az, 1e-8f);
    const float s1 = w1 / fmaxf(bz, 1e-8f);
    const float s2 = w2 / fmaxf(cz, 1e-8f);
    const float den = fmaxf(s0 + s1 + s2, 1e-12f);
    w0 = s0 / den;
    w1 = s1 / den;
    w2 = s2 / den;
  }
  if (p.clip) {
    const float c0 = fmaxf(w0, 0.0f), c1 = fmaxf(w1, 0.0f),
                c2 = fmaxf(w2, 0.0f);
    const float den = fmaxf(c0 + c1 + c2, 1e-12f);
    w0 = c0 / den;
    w1 = c1 / den;
    w2 = c2 / den;
  }
  const float z = w0 * az + w1 * bz + w2 * cz;
  // Face validity plus the behind-camera cull (a stream key below 1e30
  // already includes the cull).
  const bool validb =
      T.key_valid ? T.valid[i * T.rs_valid] < 1e30f
                  : T.valid[i] > 0.5f && fmaxf(fmaxf(az, bz), cz) > 0.0f;
  const bool cand = live && (inside || d <= sc[kBlur]) && !degen && validb &&
                    z > 0.0f;
  const float m = cand ? 1.0f : 0.0f;

  float texel[3];
  const float* t = T.tex + i * T.rs_tex;
  if (p.atlas_r == 0) {            // per-corner colors
    for (int c = 0; c < 3; ++c)
      texel[c] = (w0 * t[c] + w1 * t[3 + c] + w2 * t[6 + c]) * m;
  } else {                         // atlas cell from quantized (w1, w2)
    const int r = p.atlas_r;
    const int xi = min(max((int)(fminf(fmaxf(w1, 0.0f), 1.0f) * r), 0),
                       r - 1);
    const int yi = min(max((int)(fminf(fmaxf(w2, 0.0f), 1.0f) * r), 0),
                       r - 1);
    const int cell = yi * r + xi;
    for (int c = 0; c < 3; ++c) texel[c] = m * t[cell * 3 + c];
  }
  if (p.phong) {
    const float* fw = T.world + i * T.rs_geo;
    const float* fnn = T.fn + i * T.rs_geo;
    float pnt[3], nrm[3], tl[3], vd[3];
    for (int c = 0; c < 3; ++c) {
      pnt[c] = (w0 * fw[c] + w1 * fw[3 + c] + w2 * fw[6 + c]) * m;
      nrm[c] = (w0 * fnn[c] + w1 * fnn[3 + c] + w2 * fnn[6 + c]) * m;
      tl[c] = p.point_light ? sc[kLight + c] - pnt[c] : -sc[kLight + c];
      vd[c] = sc[kCam + c] - pnt[c];
    }
    const float tln = fmaxf(
        sqrtf(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2]), 1e-8f);
    const float vdn = fmaxf(
        sqrtf(vd[0] * vd[0] + vd[1] * vd[1] + vd[2] * vd[2]), 1e-8f);
    for (int c = 0; c < 3; ++c) {
      tl[c] = tl[c] / tln;
      vd[c] = vd[c] / vdn;
    }
    const float cosv = nrm[0] * tl[0] + nrm[1] * tl[1] + nrm[2] * tl[2];
    float refl[3];
    for (int c = 0; c < 3; ++c) refl[c] = 2.0f * cosv * nrm[c] - tl[c];
    const float spec_a =
        fmaxf(vd[0] * refl[0] + vd[1] * refl[1] + vd[2] * refl[2], 0.0f);
    const float facing = cosv > 0.0f ? 1.0f : 0.0f;
    const float spec_pow = facing * powf(spec_a, sc[kShin]);
    const float cmax = fmaxf(cosv, 0.0f);
    for (int c = 0; c < 3; ++c) {
      const float ambient = sc[kMAmb + c] * sc[kLAmb + c];
      const float diffuse = cmax * sc[kLDiff + c] * sc[kMDiff + c];
      const float specular = spec_pow * sc[kLSpec + c] * sc[kMSpec + c];
      texel[c] = (ambient + diffuse) * texel[c] + specular;
    }
  }
  *d_out = d;
  *z_out = z;
  *m_out = m;
  for (int c = 0; c < 3; ++c) col[c] = texel[c];
}

// K3's per-pixel pipeline, shared with the binned route's forward (K12,
// fused_binned.cu): det1 (edge-function geometry, texel select, Phong),
// coverage (MC perturbed Heaviside or soft / affine / hard), det2 (z_map
// with the log / gamma-over-alpha scaling and the background channel),
// aggregation (MC perturbed >=-max one-hots, softmax, or first-wins hard
// one-hot) and det3 (weighted colors, alpha = 1 - prod(1 - prob)) for
// row-major pixel `pix` of batch element b over the tables T: RGBA into
// out[0..3].  A pixel of an inactive tile gives the background, alpha 0.
// A: the type of the aggregation and the blend's weighted sum (z_inv,
// z_map, the weights), float for K3 and double for K12, as pixel_grads.
template <int MAXF, class A = float>
PT_HD void pixel_forward(const Params& p, const Tables& T, int b, int pix,
                         float out[4]) {
  constexpr int MAXC = MAXF + 8;
  const int F = p.f_pad;
  const float* sc = T.sc;
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;
  if (!pixel_active(p, b, pix)) {
    out[0] = sc[kBg];
    out[1] = sc[kBg + 1];
    out[2] = sc[kBg + 2];
    out[3] = 0.0f;
    return;
  }

  // ---- det1: geometry, texel, shading per slot --------------------------
  float dist[MAXF], zz[MAXF], maskf[MAXF];
  float col0[MAXF], col1[MAXF], col2[MAXF];
  for (int i = 0; i < F; ++i) {
    float c3[3];
    face_forward(p, T, i, px, py, true, &dist[i], &zz[i], &maskf[i], c3);
    col0[i] = c3[0];
    col1[i] = c3[1];
    col2[i] = c3[2];
  }

  // ---- coverage: prob = prob_raw * maskf (kept in dist[]) ---------------
  const float sigma = sc[kSigma];
  if (p.rast_kind == kRastMC) {
    // Heaviside of -dist + sigma * Z over an f_pad-row noise block.
    float nz[MAXF], acc[MAXF];
    for (int i = 0; i < F; ++i) acc[i] = 0.0f;
    const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 0];
    const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 1];
    for (int s = 0; s < p.s_rast; ++s) {
      draw_noise<MAXF>(nz, F, p.rast_noise, s0, s1, s, pos);
      for (int i = 0; i < F; ++i)
        acc[i] += -dist[i] + sigma * nz[i] >= 0.0f ? 1.0f : 0.0f;
    }
    const float inv_s = 1.0f / (float)p.s_rast;
    for (int i = 0; i < F; ++i) dist[i] = acc[i] * inv_s * maskf[i];
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
      dist[i] = pr * maskf[i];
    }
  }
  const float* prob = dist;

  // ---- det2: z_map rows (slots, background, -inf padding) ---------------
  const int C = p.c_zpad;
  A zmap[MAXC], zinv[MAXF];
  const float zfar = sc[kZfar], znear = sc[kZnear];
  const A zden = (A)zfar - (A)znear;
  A zmax = -INFINITY;
  for (int i = 0; i < F; ++i) {
    zinv[i] = ((A)zfar - zz[i]) / zden * maskf[i];
    zmax = fmax(zmax, zinv[i]);
  }
  zmax = fmax(zmax, (A)p.eps_bg);
  const A gal =
      p.agg_kind == kAggHard ? (A)1e-6f : (A)sc[kGamma] / (A)sc[kAlpha];
  for (int i = 0; i < F; ++i)
    zmap[i] = gal * log((A)prob[i]) + zinv[i] - zmax;
  for (int r = F; r < C; ++r) zmap[r] = -INFINITY;
  zmap[p.bg_row] = (A)p.eps_bg - zmax;

  // ---- aggregation weights over the C z_map rows -------------------------
  A wts[MAXC];
  if (p.agg_kind == kAggMC) {
    // >=-max one-hots of z_map + gamma * N over a c_zpad-row noise block.
    float nz[MAXC];
    A pert[MAXC];
    for (int r = 0; r < C; ++r) wts[r] = 0.0f;
    const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 2];
    const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 3];
    const float gamma = sc[kGamma];
    for (int s = 0; s < p.s_agg; ++s) {
      draw_noise<MAXC>(nz, C, p.agg_noise, s0, s1, s, pos);
      for (int r = 0; r < C; ++r) pert[r] = zmap[r] + (A)gamma * nz[r];
      A mx = -INFINITY;
      for (int r = 0; r < C; ++r) mx = fmax(mx, pert[r]);
      for (int r = 0; r < C; ++r) wts[r] += pert[r] >= mx ? 1.0f : 0.0f;
    }
    const A inv_s = (A)1 / (A)p.s_agg;
    for (int r = 0; r < C; ++r) wts[r] = wts[r] * inv_s;
  } else if (p.agg_kind == kAggSoft) {
    const A inv_gamma = (A)1 / (A)sc[kGamma];
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
  } else {                                   // first-wins hard one-hot
    A mx = -INFINITY;
    for (int r = 0; r < C; ++r) mx = fmax(mx, zmap[r]);
    int first = C;
    for (int r = C - 1; r >= 0; --r)
      if (zmap[r] >= mx) first = r;
    for (int r = 0; r < C; ++r) wts[r] = r == first ? 1.0f : 0.0f;
  }

  // ---- det3: blend ------------------------------------------------------
  A rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f;
  float ap = 1.0f;
  for (int i = 0; i < F; ++i) {
    rgb0 += wts[i] * col0[i];
    rgb1 += wts[i] * col1[i];
    rgb2 += wts[i] * col2[i];
    ap = ap * (1.0f - prob[i]);
  }
  const A wb = wts[p.bg_row];
  out[0] = (float)(rgb0 + wb * sc[kBg + 0]);
  out[1] = (float)(rgb1 + wb * sc[kBg + 1]);
  out[2] = (float)(rgb2 + wb * sc[kBg + 2]);
  out[3] = 1.0f - ap;
}


#ifdef __CUDACC__
// Copies batch element b's face tables and scalars into shared memory.
__device__ __forceinline__ Tables load_tables(const Params& p, float* smem,
                                              int b) {
  const int F = p.f_pad;
  const Tables t = tables_at(p, smem);
  float* s_ndc = smem;
  float* s_world = smem + F * 9;
  float* s_fn = smem + F * 18;
  float* s_valid = smem + F * 27;
  float* s_sc = smem + F * 28;
  float* s_tex = s_sc + kNS;
  for (int i = threadIdx.x; i < F * 9; i += blockDim.x) {
    s_ndc[i] = p.fv_ndc[(size_t)b * F * 9 + i];
    s_world[i] = p.fv_world[(size_t)b * F * 9 + i];
    s_fn[i] = p.fn[(size_t)b * F * 9 + i];
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    s_valid[i] = p.valid[(size_t)b * F + i];
  for (int i = threadIdx.x; i < kNS; i += blockDim.x)
    s_sc[i] = p.scal[(size_t)b * kNS + i];
  for (int i = threadIdx.x; i < F * p.tex_d; i += blockDim.x)
    s_tex[i] = p.tex[(size_t)b * F * p.tex_d + i];
  __syncthreads();
  return t;
}

// Raises the kernel's dynamic shared-memory limit when the tables need
// more than the default 48 KB.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
#endif

}  // namespace ptf
