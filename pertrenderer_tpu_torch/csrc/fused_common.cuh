// Pieces shared by the fused kernels: the flat route's K3
// (fused_forward.cu), K4 (fused_backward.cu) and K2 (fused_loss_grad.cu),
// the sharded route's K11a-c (sharded.cu), the binned route's K12
// (fused_binned.cu) and the stream route's K5-K7 (stream_grad.cuh).
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
  // vstart, vidx: fused_render._stream_visit_index), the pixels' records
  // from B1 to B2 (recs), each visit's nsub blocks' partial rows, their
  // row masks (pmask) and their scalar rows (pscal64, in double).
  const float* tab;
  const int *rows, *count, *voff, *vstart, *vidx;
  float *recs, *g_tab;
  unsigned long long* pmask;
  int nch, rw, dt, nsub;
  // K5 above kMaxS samples: each visit's pixels' z_map rows and candidacy
  // masks from the first pass, read by the later ones (zbuf, zmask).
  float* zbuf;
  unsigned long long* zmask;
  // The binned route's K12: each tile's 34 scalar gradients and loss
  // (N, nt, 35), in double.
  double* pscal64;
  // The sharded route (channel-major, P = H * W): K11a writes its shard's
  // coverage mean (N, F, P) to prob_out; K3 with external coverage, K11b
  // and K11c read the group's mean of it from prob_ext.  K3 writes the
  // aggregation weights (N, c_zpad, P) to w_out and K11c reads the
  // group's from w_in; K11b writes g_zmap (N, c_zpad, P) to gz_out and
  // K11c reads the group's from gz_in; K11b's gamma term per image goes
  // to g_gamma (N,), from per-warp partials.
  const float* prob_ext;
  float* prob_out;
  float* w_out;
  const float *w_in, *gz_in;
  float *gz_out, *g_gamma;
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

// A bound on |noise| for every hash word (hash_prng.cuh's table): a
// perturbed comparison whose margin exceeds it has one outcome for every
// draw.
PT_HD float noise_bound(int noise) {
  return noise == kGaussian ? ptt::kBoundGaussian : ptt::kBoundCauchy;
}

// The certainty rules of the MC estimators (K3: flat_warp.cuh; K11b:
// pixel_agg_grads; the stream route's K5 and the staged K8a / K8b apply
// the same bounds).  Coverage: with sb = fl(|sigma| B), fl(sigma n) lies
// within +-sb for every draw and rounding is monotone, so a candidate with
// -d > sb hits in every sample and one with d > sb in none
// (cover_certain: +1, -1; 0 where a draw decides).
PT_HD int cover_certain(float d, float sb) {
  return -d > sb ? 1 : (d > sb ? -1 : 0);
}

// Aggregation: with gb = fl(|gamma| B), row r's perturbed value fl(z_r +
// fl(gamma n)) lies in [fl(z_r - gb), fl(z_r + gb)], so every sample's max
// is at least lim = max_r fl(z_r - gb) and a row with fl(z_r + gb) < lim
// never reaches it.  The max is taken by a row that may reach it; where
// only one row may, that row is every sample's only >=-max row.
PT_HD float agg_lim(const float* zmap, int C, float gb) {
  float lim = -INFINITY;
  for (int r = 0; r < C; ++r) lim = fmaxf(lim, zmap[r] - gb);
  return lim;
}

PT_HD bool agg_may_win(float z, float gb, float lim) {
  return !(z + gb < lim);
}

// NDC center of row-major pixel `pix`.
PT_HD void pixel_center(int image_size, int pix, float* px, float* py) {
  const float w = (float)image_size;
  *px = (w - 1.0f - 2.0f * (float)(pix % image_size)) / w;
  *py = (w - 1.0f - 2.0f * (float)(pix / image_size)) / w;
}

// det1's geometry in two steps: what does not depend on the pixel
// (face_const: a face's corners, barycentric coefficients and edges, and
// its bounding box grown by more than the blur band), then the values at a
// pixel (face_geometry_at).  face_geometry takes the two in turn; K3's warp
// pipeline (flat_warp.cuh) and K11b (pixel_agg_grads) keep one FaceConst
// per slot in shared memory and run face_geometry_at only where face_near
// holds: elsewhere the face is no candidate.
//
// Why the box drops no candidate.  A candidate is inside the face or
// within d <= blur of it.  At a pixel outside the grown box the face lies
// more than `band` away.  So d, whose rounding is some 1e-7 R (R the
// coordinates' size), exceeds blur: band > 1.0625 sqrt(blur) + 1e-4 +
// 1e-5 vmax.  And one exact barycentric is below -band / (2 diam), diam
// the longest edge: were all three above -e, the pixel would lie within
// 2 e diam of the face.  The computed barycentrics differ from the exact
// ones by at most err: the area's relative rounding, 4 u P / |area| + 2 u
// (u = 2^-24, P the sizes of its two products; large where the area
// cancels, as for a thin face seen nearly edge-on), plus some 8 u, on
// terms of size 4 M R (M the largest coefficient), twice in w2 = 1 - w0 -
// w1; err below is twice that.  A face whose err can reach band / (2
// diam) keeps an unbounded box: it is never culled.
struct FaceConst {
  float ax, ay, bx, by, cx, cy, az, bz, cz;
  float e0x, e0y, k0, e1x, e1y, k1;
  float ex[3], ey[3], exs[3], eys[3];
  float x0, x1, y0, y1;
  int degen;          // |area| < 1e-10: never inside
  int ok;             // not degenerate, valid and not behind the camera
};

PT_HD void face_const(const Tables& T, int i, FaceConst& f) {
  const float* v = T.ndc + i * T.rs_geo;
  f.ax = v[0];
  f.ay = v[1];
  f.az = v[2];
  f.bx = v[3];
  f.by = v[4];
  f.bz = v[5];
  f.cx = v[6];
  f.cy = v[7];
  f.cz = v[8];
  const float p0 = (f.bx - f.ax) * (f.cy - f.ay);
  const float p1 = (f.by - f.ay) * (f.cx - f.ax);
  const float area = p0 - p1;
  const bool degen = fabsf(area) < 1e-10f;
  const float inv_area = 1.0f / (degen ? 1.0f : area);
  f.e0x = (f.cy - f.by) * inv_area;
  f.e0y = (f.cx - f.bx) * inv_area;
  f.k0 = f.e0x * f.bx - f.e0y * f.by;
  f.e1x = (f.ay - f.cy) * inv_area;
  f.e1y = (f.ax - f.cx) * inv_area;
  f.k1 = f.e1x * f.cx - f.e1y * f.cy;
  const float sx[3] = {f.ax, f.bx, f.cx}, sy[3] = {f.ay, f.by, f.cy};
  float vmax = 0.0f, len2 = 0.0f;
  for (int e = 0; e < 3; ++e) {     // edges a -> b, b -> c, c -> a
    f.ex[e] = sx[(e + 1) % 3] - sx[e];
    f.ey[e] = sy[(e + 1) % 3] - sy[e];
    const float l2 = f.ex[e] * f.ex[e] + f.ey[e] * f.ey[e];
    const float inv_denom = 1.0f / fmaxf(l2, 1e-12f);
    f.exs[e] = f.ex[e] * inv_denom;
    f.eys[e] = f.ey[e] * inv_denom;
    vmax = fmaxf(vmax, fmaxf(fabsf(sx[e]), fabsf(sy[e])));
    len2 = fmaxf(len2, l2);
  }
  const bool validb =
      T.key_valid ? T.valid[i * T.rs_valid] < 1e30f
                  : T.valid[i] > 0.5f && fmaxf(fmaxf(f.az, f.bz), f.cz) > 0.0f;
  f.degen = degen;
  f.ok = !degen && validb;
  const float band =
      sqrtf(fmaxf(T.sc[kBlur], 0.0f)) * 1.0625f + 1e-4f + 1e-5f * vmax;
  const float u = 5.9604645e-8f;
  const float M = fmaxf(fmaxf(fabsf(f.e0x), fabsf(f.e0y)),
                        fmaxf(fabsf(f.e1x), fabsf(f.e1y)));
  const float err =
      16.0f * u * M * fmaxf(vmax, 1.0f) *
          (4.0f * (fabsf(p0) + fabsf(p1)) / (degen ? 1.0f : fabsf(area)) +
           10.0f) +
      4.0f * u;
  const bool cull = err < band / (2.0f * sqrtf(len2));   // NaN: no cull
  f.x0 = cull ? fminf(f.ax, fminf(f.bx, f.cx)) - band : -INFINITY;
  f.x1 = cull ? fmaxf(f.ax, fmaxf(f.bx, f.cx)) + band : INFINITY;
  f.y0 = cull ? fminf(f.ay, fminf(f.by, f.cy)) - band : -INFINITY;
  f.y1 = cull ? fmaxf(f.ay, fmaxf(f.by, f.cy)) + band : INFINITY;
}

// Whether the face may be a candidate at pixel (px, py).
PT_HD bool face_near(const FaceConst& f, float px, float py) {
  return f.ok && px >= f.x0 && px <= f.x1 && py >= f.y0 && py <= f.y1;
}

// det1's geometry at pixel (px, py) from the face's FaceConst: signed
// squared edge distance, depth, the candidacy (1 or 0) of a face with
// f.ok and the final barycentrics.
PT_HD void face_geometry_at(const Params& p, const FaceConst& f, float blur,
                            float px, float py, float* d_out, float* z_out,
                            float* m_out, float w_out[3]) {
  float w0 = f.e0y * py - f.e0x * px + f.k0;
  float w1 = f.e1y * py - f.e1x * px + f.k1;
  float w2 = 1.0f - w0 - w1;
  const bool inside = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && !f.degen;
  const float sx[3] = {f.ax, f.bx, f.cx}, sy[3] = {f.ay, f.by, f.cy};
  float dd[3];
  for (int e = 0; e < 3; ++e) {
    const float dx = px - sx[e], dy = py - sy[e];
    const float t = fminf(fmaxf(dx * f.exs[e] + dy * f.eys[e], 0.0f), 1.0f);
    const float rx = dx - t * f.ex[e];
    const float ry = dy - t * f.ey[e];
    dd[e] = rx * rx + ry * ry;
  }
  const float min_d = fminf(dd[0], fminf(dd[1], dd[2]));
  const float d = inside ? -min_d : min_d;
  if (p.persp) {
    const float s0 = w0 / fmaxf(f.az, 1e-8f);
    const float s1 = w1 / fmaxf(f.bz, 1e-8f);
    const float s2 = w2 / fmaxf(f.cz, 1e-8f);
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
  const float z = w0 * f.az + w1 * f.bz + w2 * f.cz;
  *d_out = d;
  *z_out = z;
  *m_out = (inside || d <= blur) && z > 0.0f ? 1.0f : 0.0f;
  w_out[0] = w0;
  w_out[1] = w1;
  w_out[2] = w2;
}

// det1's geometry of slot i at pixel (px, py): signed squared edge
// distance, depth, candidacy (1 or 0; live and f.ok: the face is valid,
// not degenerate and not behind the camera, a stream key below 1e30
// already including the cull) and the final barycentrics.
PT_HD void face_geometry(const Params& p, const Tables& T, int i, float px,
                         float py, bool live, float* d_out, float* z_out,
                         float* m_out, float w_out[3]) {
  FaceConst f;
  face_const(T, i, f);
  face_geometry_at(p, f, T.sc[kBlur], px, py, d_out, z_out, m_out, w_out);
  if (!(live && f.ok)) *m_out = 0.0f;
}

// det1's texel select and Phong shading of slot i at final barycentrics
// w, masked by the candidacy m (1 or 0): the colour into col.
PT_HD void face_shade(const Params& p, const Tables& T, int i, float m,
                      const float w[3], float col[3]) {
  const float* sc = T.sc;
  const float w0 = w[0], w1 = w[1], w2 = w[2];
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
  for (int c = 0; c < 3; ++c) col[c] = texel[c];
}

// det1 of slot i at pixel (px, py): signed squared edge distance, depth,
// candidacy (1 or 0) and the shaded color (masked like the JAX kernel).
PT_HD void face_forward(const Params& p, const Tables& T, int i, float px,
                        float py, bool live, float* d_out, float* z_out,
                        float* m_out, float col[3]) {
  float m, w[3];
  face_geometry(p, T, i, px, py, live, d_out, z_out, &m, w);
  face_shade(p, T, i, m, w, col);
  *m_out = m;
}

// Coverage of the F slots at pixel pos of batch element b: prob = prob_raw
// * maskf, written over dist[] (MC perturbed Heaviside of -dist + sigma *
// Z over an f_pad-row noise block, or soft / affine / hard).  K3's and
// K11a's.
template <int MAXF>
PT_HD void coverage(const Params& p, const float* sc, int b, uint32_t pos,
                    float dist[MAXF], const float maskf[MAXF]) {
  const int F = p.f_pad;
  const float sigma = sc[kSigma];
  if (p.rast_kind == kRastMC) {
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
}

// K11a's pipeline of one pixel: det1's geometry (no colour) and the
// coverage of the F slots on this shard's coverage samples, zero on an
// inactive tile.  Reads only the tables' NDC corners, validity and
// scalars.
template <int MAXF>
PT_HD void pixel_prob(const Params& p, const Tables& T, int b, int pix,
                      float prob[MAXF]) {
  const int F = p.f_pad;
  for (int i = 0; i < F; ++i) prob[i] = 0.0f;
  if (!pixel_active(p, b, pix)) return;
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  float maskf[MAXF];
  for (int i = 0; i < F; ++i) {
    float z, w[3];
    face_geometry(p, T, i, px, py, true, &prob[i], &z, &maskf[i], w);
  }
  coverage<MAXF>(p, T.sc, b, (uint32_t)pix, prob, maskf);
}

// K3's per-pixel pipeline: det1 (edge-function geometry, texel select, Phong),
// coverage (MC perturbed Heaviside or soft / affine / hard), det2 (z_map
// with the log / gamma-over-alpha scaling and the background channel),
// aggregation (MC perturbed >=-max one-hots, softmax, or first-wins hard
// one-hot) and det3 (weighted colors, alpha = 1 - prod(1 - prob)) for
// row-major pixel `pix` of batch element b over the tables T: RGBA into
// out[0..3].  A pixel of an inactive tile gives the background, alpha 0.
// A: the type of the aggregation and the blend's weighted sum (z_inv,
// z_map, the weights): float for K3; the CPU tests also run it in double
// over binned tiles, the reference of K12's warp pipeline
// (binned_warp.cuh), as pixel_grads.
// EXT (the sharded route's K3): the coverage is read from prob_ext (the
// mean of K11a over the sample group) instead of drawn, and the weights
// go to w_out as well (the background one-hot on an inactive tile).
template <int MAXF, class A = float, bool EXT = false>
PT_HD void pixel_forward(const Params& p, const Tables& T, int b, int pix,
                         float out[4]) {
  constexpr int MAXC = MAXF + 8;
  const int F = p.f_pad, C = p.c_zpad;
  const size_t npix = (size_t)p.image_size * p.image_size;
  const float* sc = T.sc;
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;
  if (!pixel_active(p, b, pix)) {
    out[0] = sc[kBg];
    out[1] = sc[kBg + 1];
    out[2] = sc[kBg + 2];
    out[3] = 0.0f;
    if (EXT)
      for (int r = 0; r < C; ++r)
        p.w_out[((size_t)b * C + r) * npix + pix] = r == p.bg_row ? 1.0f
                                                                  : 0.0f;
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
  if (EXT) {
    for (int i = 0; i < F; ++i)
      dist[i] = p.prob_ext[((size_t)b * F + i) * npix + pix];
  } else {
    coverage<MAXF>(p, sc, b, pos, dist, maskf);
  }
  const float* prob = dist;

  // ---- det2: z_map rows (slots, background, -inf padding) ---------------
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

  if (EXT)
    for (int r = 0; r < C; ++r)
      p.w_out[((size_t)b * C + r) * npix + pix] = (float)wts[r];

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
