// K3: flat fused forward render, one thread per output pixel.
//
// Replaces _forward_kernel (pertrenderer_tpu/ops/fused_render.py:799,
// pallas_call in _pallas_forward at :1657) in flat, unsharded, unpacked
// mode: det1 (edge-function geometry, texel select, Phong), coverage (MC
// perturbed Heaviside or soft / affine / hard), det2 (z_map with the
// log / gamma-over-alpha scaling and the background channel), aggregation
// (MC perturbed >=-max one-hots, softmax, or first-wins hard one-hot) and
// det3 (weighted colors, alpha = 1 - prod(1 - prob)).  Output (N, H, W, 4).
//
// Bound on the H100: compute.  Every pixel draws S_rast * f_pad / 2 +
// S_agg * c_zpad / 2 Box-Muller pairs (a log, a sqrt, a sincos each) and
// runs the f_pad-slot geometry; it reads O(F) bytes of tables per batch
// element and writes 16 bytes per pixel.  The design keeps everything
// per-pixel in registers / local memory and the face tables in shared
// memory (under 3 KB for the cube), so device memory sees only the tables
// once per block and the image once.  A pixel of a tile that the activity
// prepass (fused_render._active_tiles) proves empty writes the background
// and stops, as the TPU kernel's bg_only branch does; the TPU kernel's
// face packing is not ported (exact either way).  Making it fast
// (skipping dead slots' draws) is later work.
//
// Numerics: built with -fmad=false and without fast math, so every
// Heaviside and >=max threshold sees the same rounding as the plain
// PyTorch version, whose separate ops are never contracted.
#include <cuda_runtime.h>

#include "fused_common.cuh"

namespace {

using namespace ptf;

template <int MAXF>
__global__ void __launch_bounds__(kThreads)
fused_forward_kernel(const Params p) {
  constexpr int MAXC = MAXF + 8;
  extern __shared__ float smem[];
  const int F = p.f_pad;
  const int b = blockIdx.y;
  const Tables T = load_tables(p, smem, b);
  const float* sc = T.sc;

  const int w = p.image_size, hgt = p.image_size;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= w * hgt) return;
  float px, py;
  pixel_center(w, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;
  float4* out = reinterpret_cast<float4*>(p.out) + (size_t)b * w * hgt + pix;
  if (!pixel_active(p, b, pix)) {
    *out = make_float4(sc[kBg], sc[kBg + 1], sc[kBg + 2], 0.0f);
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
  float zmap[MAXC];
  const float zfar = sc[kZfar], znear = sc[kZnear];
  float zmax = -INFINITY;
  for (int i = 0; i < F; ++i) {
    zz[i] = (zfar - zz[i]) / (zfar - znear) * maskf[i];   // z_inv
    zmax = fmaxf(zmax, zz[i]);
  }
  zmax = fmaxf(zmax, p.eps_bg);
  const float gal = p.agg_kind == kAggHard ? 1e-6f : sc[kGamma] / sc[kAlpha];
  for (int i = 0; i < F; ++i) zmap[i] = gal * logf(prob[i]) + zz[i] - zmax;
  for (int r = F; r < C; ++r) zmap[r] = -INFINITY;
  zmap[p.bg_row] = p.eps_bg - zmax;

  // ---- aggregation weights over the C z_map rows -------------------------
  float wts[MAXC];
  if (p.agg_kind == kAggMC) {
    // >=-max one-hots of z_map + gamma * N over a c_zpad-row noise block.
    float pert[MAXC];
    for (int r = 0; r < C; ++r) wts[r] = 0.0f;
    const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 2];
    const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 3];
    const float gamma = sc[kGamma];
    for (int s = 0; s < p.s_agg; ++s) {
      draw_noise<MAXC>(pert, C, p.agg_noise, s0, s1, s, pos);
      for (int r = 0; r < C; ++r) pert[r] = zmap[r] + gamma * pert[r];
      float mx = -INFINITY;
      for (int r = 0; r < C; ++r) mx = fmaxf(mx, pert[r]);
      for (int r = 0; r < C; ++r) wts[r] += pert[r] >= mx ? 1.0f : 0.0f;
    }
    const float inv_s = 1.0f / (float)p.s_agg;
    for (int r = 0; r < C; ++r) wts[r] = wts[r] * inv_s;
  } else if (p.agg_kind == kAggSoft) {
    const float inv_gamma = 1.0f / sc[kGamma];
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
  } else {                                   // first-wins hard one-hot
    float mx = -INFINITY;
    for (int r = 0; r < C; ++r) mx = fmaxf(mx, zmap[r]);
    int first = C;
    for (int r = C - 1; r >= 0; --r)
      if (zmap[r] >= mx) first = r;
    for (int r = 0; r < C; ++r) wts[r] = r == first ? 1.0f : 0.0f;
  }

  // ---- det3: blend ------------------------------------------------------
  float rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f, ap = 1.0f;
  for (int i = 0; i < F; ++i) {
    rgb0 += wts[i] * col0[i];
    rgb1 += wts[i] * col1[i];
    rgb2 += wts[i] * col2[i];
    ap = ap * (1.0f - prob[i]);
  }
  const float wb = wts[p.bg_row];
  float4 o;
  o.x = rgb0 + wb * sc[kBg + 0];
  o.y = rgb1 + wb * sc[kBg + 1];
  o.z = rgb2 + wb * sc[kBg + 2];
  o.w = 1.0f - ap;
  *out = o;
}

template <int MAXF>
cudaError_t launch(const Params& p, int n, cudaStream_t stream) {
  const size_t smem = sizeof(float) * table_floats(p);
  const cudaError_t e = allow_smem(fused_forward_kernel<MAXF>, smem);
  if (e != cudaSuccess) return e;
  const int pixels = p.image_size * p.image_size;
  const dim3 grid((pixels + kThreads - 1) / kThreads, n);
  fused_forward_kernel<MAXF><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_fused_forward(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, void* out, int n,
    int image_size, int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r,
    int rast_kind, int rast_noise, int rast_vr, int s_rast, int agg_kind,
    int agg_noise, int agg_vr, int s_agg, int k, float eps_bg, int phong,
    int point_light, int clip, int persp, const void* active, int nt,
    int p_tile, int tile_w, void* stream) {
  Params p = {};
  p.fv_ndc = (const float*)fv_ndc;
  p.fv_world = (const float*)fv_world;
  p.fn = (const float*)fn;
  p.tex = (const float*)tex;
  p.valid = (const float*)valid;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  p.out = (float*)out;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  cudaStream_t st = (cudaStream_t)stream;
  if (f_pad <= 16) return (int)launch<16>(p, n, st);
  if (f_pad <= 32) return (int)launch<32>(p, n, st);
  if (f_pad <= 64) return (int)launch<64>(p, n, st);
  if (f_pad <= 128) return (int)launch<128>(p, n, st);
  if (f_pad <= 256) return (int)launch<256>(p, n, st);
  return (int)cudaErrorInvalidValue;
}
