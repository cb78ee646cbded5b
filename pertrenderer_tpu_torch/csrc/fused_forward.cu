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
// once per block and the image once.  The TPU kernel's tile activity
// prepass and face packing are not needed for exactness: a zero-coverage
// pixel comes out as background / alpha 0 through the full pipeline.
// Making it fast (skipping dead slots' draws, tile culling) is later work.
//
// Numerics: built with -fmad=false and without fast math, so every
// Heaviside and >=max threshold sees the same rounding as the plain
// PyTorch version, whose separate ops are never contracted.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_prng.cuh"

namespace {

constexpr int kNS = 34;
constexpr int kLight = 0, kLAmb = 3, kLDiff = 6, kLSpec = 9, kMAmb = 12,
              kMDiff = 15, kMSpec = 18, kShin = 21, kCam = 22, kBg = 25,
              kZnear = 28, kZfar = 29, kSigma = 30, kGamma = 31, kAlpha = 32,
              kBlur = 33;
enum Rast { kRastSoft = 0, kRastAffine = 1, kRastHard = 2, kRastMC = 3 };
enum Agg { kAggSoft = 0, kAggHard = 1, kAggMC = 2 };
enum Noise { kGaussian = 1, kCauchy = 2 };
constexpr int kThreads = 128;

struct Params {
  const float* fv_ndc;    // (N, F, 9)
  const float* fv_world;  // (N, F, 9)
  const float* fn;        // (N, F, 9)
  const float* tex;       // (N, F, tex_d)
  const float* valid;     // (N, F)
  const float* scal;      // (N, 34)
  const int* seeds;       // (N, 4): rast0, rast1, agg0, agg1
  float* out;             // (N, H, W, 4)
  int image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r;
  int rast_kind, rast_noise, s_rast, agg_kind, agg_noise, s_agg;
  float eps_bg;
  int phong, point_light, clip, persp;
};

__device__ __forceinline__ float edge_dist_sq(float px, float py, float ax,
                                              float ay, float bx, float by) {
  const float ex = bx - ax, ey = by - ay;
  const float inv_denom = 1.0f / fmaxf(ex * ex + ey * ey, 1e-12f);
  const float exs = ex * inv_denom, eys = ey * inv_denom;
  const float dx = px - ax, dy = py - ay;
  const float t = fminf(fmaxf(dx * exs + dy * eys, 0.0f), 1.0f);
  const float rx = dx - t * ex;
  const float ry = dy - t * ey;
  return rx * rx + ry * ry;
}

// Draws one noise block of `rows` rows for sample s and adds the
// perturbation to base[r], writing pert[r] = base[r] + scale * noise[r].
template <int MAXR>
__device__ __forceinline__ void perturb(float (&pert)[MAXR],
                                        const float (&base)[MAXR], int rows,
                                        int noise, float scale, uint32_t s0,
                                        uint32_t s1, int s, uint32_t pos) {
  if (noise == kGaussian) {
    const int half = rows / 2;
    for (int h = 0; h < half; ++h) {
      float a, b;
      ptt::gaussian_pair(ptt::hash_words(s0, s1, s, h, pos), &a, &b);
      pert[h] = base[h] + scale * a;
      pert[h + half] = base[h + half] + scale * b;
    }
  } else {
    for (int r = 0; r < rows; ++r)
      pert[r] = base[r] + scale * ptt::cauchy_draw(
          ptt::hash_words(s0, s1, s, r, pos));
  }
}

template <int MAXF>
__global__ void __launch_bounds__(kThreads)
fused_forward_kernel(const Params p) {
  constexpr int MAXC = MAXF + 8;
  extern __shared__ float smem[];
  const int F = p.f_pad;
  const int b = blockIdx.y;
  float* s_ndc = smem;
  float* s_world = s_ndc + F * 9;
  float* s_fn = s_world + F * 9;
  float* s_valid = s_fn + F * 9;
  float* sc = s_valid + F;
  float* s_tex = sc + kNS;
  for (int i = threadIdx.x; i < F * 9; i += blockDim.x) {
    s_ndc[i] = p.fv_ndc[(size_t)b * F * 9 + i];
    s_world[i] = p.fv_world[(size_t)b * F * 9 + i];
    s_fn[i] = p.fn[(size_t)b * F * 9 + i];
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    s_valid[i] = p.valid[(size_t)b * F + i];
  for (int i = threadIdx.x; i < kNS; i += blockDim.x)
    sc[i] = p.scal[(size_t)b * kNS + i];
  for (int i = threadIdx.x; i < F * p.tex_d; i += blockDim.x)
    s_tex[i] = p.tex[(size_t)b * F * p.tex_d + i];
  __syncthreads();

  const int w = p.image_size, hgt = p.image_size;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= w * hgt) return;
  const float px = ((float)w - 1.0f - 2.0f * (float)(pix % w)) / (float)w;
  const float py = ((float)hgt - 1.0f - 2.0f * (float)(pix / w)) / (float)hgt;
  const uint32_t pos = (uint32_t)pix;

  // ---- det1: geometry, texel, shading per slot --------------------------
  float dist[MAXF], zz[MAXF], maskf[MAXF];
  float col0[MAXF], col1[MAXF], col2[MAXF];
  const float blur = sc[kBlur];
  for (int i = 0; i < F; ++i) {
    const float* v = s_ndc + i * 9;
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
    // Face validity plus the behind-camera cull.
    const bool validb = s_valid[i] > 0.5f && fmaxf(fmaxf(az, bz), cz) > 0.0f;
    const bool cand = (inside || d <= blur) && !degen && validb && z > 0.0f;
    const float m = cand ? 1.0f : 0.0f;

    float texel[3];
    const float* t = s_tex + i * p.tex_d;
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
      const float* fw = s_world + i * 9;
      const float* fnn = s_fn + i * 9;
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
    dist[i] = d;
    zz[i] = z;
    maskf[i] = m;
    col0[i] = texel[0];
    col1[i] = texel[1];
    col2[i] = texel[2];
  }

  // ---- coverage: prob = prob_raw * maskf (kept in dist[]) ---------------
  const float sigma = sc[kSigma];
  if (p.rast_kind == kRastMC) {
    // Heaviside of -dist + sigma * Z over an f_pad-row noise block.
    float negd[MAXF], pert[MAXF], acc[MAXF];
    for (int i = 0; i < F; ++i) {
      negd[i] = -dist[i];
      acc[i] = 0.0f;
    }
    const uint32_t s0 = (uint32_t)p.seeds[b * 4 + 0];
    const uint32_t s1 = (uint32_t)p.seeds[b * 4 + 1];
    for (int s = 0; s < p.s_rast; ++s) {
      perturb<MAXF>(pert, negd, F, p.rast_noise, sigma, s0, s1, s, pos);
      for (int i = 0; i < F; ++i) acc[i] += pert[i] >= 0.0f ? 1.0f : 0.0f;
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
      perturb<MAXC>(pert, zmap, C, p.agg_noise, gamma, s0, s1, s, pos);
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
  reinterpret_cast<float4*>(p.out)[(size_t)b * w * hgt + pix] = o;
}

template <int MAXF>
cudaError_t launch(const Params& p, int n, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)p.f_pad * (27 + 1 + p.tex_d) + kNS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_forward_kernel<MAXF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
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
    int rast_kind, int rast_noise, int s_rast, int agg_kind, int agg_noise,
    int s_agg, float eps_bg, int phong, int point_light, int clip, int persp,
    void* stream) {
  Params p;
  p.fv_ndc = (const float*)fv_ndc;
  p.fv_world = (const float*)fv_world;
  p.fn = (const float*)fn;
  p.tex = (const float*)tex;
  p.valid = (const float*)valid;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  p.out = (float*)out;
  p.image_size = image_size;
  p.f_pad = f_pad;
  p.bg_row = bg_row;
  p.c_zpad = c_zpad;
  p.tex_d = tex_d;
  p.atlas_r = atlas_r;
  p.rast_kind = rast_kind;
  p.rast_noise = rast_noise;
  p.s_rast = s_rast;
  p.agg_kind = agg_kind;
  p.agg_noise = agg_noise;
  p.s_agg = s_agg;
  p.eps_bg = eps_bg;
  p.phong = phong;
  p.point_light = point_light;
  p.clip = clip;
  p.persp = persp;
  cudaStream_t st = (cudaStream_t)stream;
  if (f_pad <= 16) return (int)launch<16>(p, n, st);
  if (f_pad <= 32) return (int)launch<32>(p, n, st);
  if (f_pad <= 64) return (int)launch<64>(p, n, st);
  if (f_pad <= 128) return (int)launch<128>(p, n, st);
  if (f_pad <= 256) return (int)launch<256>(p, n, st);
  return (int)cudaErrorInvalidValue;
}
