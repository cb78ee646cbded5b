// K3: flat fused forward render, one thread per output pixel, each warp's
// noise draws packed across its lanes.
//
// Replaces _forward_kernel (pertrenderer_tpu/ops/fused_render.py:799,
// pallas_call in _pallas_forward at :1657) in flat, unsharded, unpacked
// mode: det1 (edge-function geometry, texel select, Phong), coverage (MC
// perturbed Heaviside or soft / affine / hard), det2 (z_map with the
// log / gamma-over-alpha scaling and the background channel), aggregation
// (MC perturbed >=-max one-hots, softmax, or first-wins hard one-hot) and
// det3 (weighted colors, alpha = 1 - prod(1 - prob)).  Output (N, H, W, 4).
// The pipeline is warp_flat_forward (flat_warp.cuh); its per-pixel
// reference, pixel_forward (fused_common.cuh, which the binned route's
// host reference shares), also runs here as a diagnostic entry
// (pt_fused_forward_pixel), so the card can hold the two bit for bit.
//
// Bound on the H100: operations.  Each pixel of an active tile runs the
// geometry of the slots whose bounding box, grown by the blur band, holds
// it (from each face's pixel-independent terms, computed once per block:
// FaceConst); a candidate is shaded and its coverage drawn only within
// sigma B of its edge (elsewhere it takes S hits or none), and a pixel's
// aggregation draws only the rows that can reach a sample's max (one such
// row: its one-hot, no draw).  The kernel is latency-bound: with one
// thread per pixel the slowest warp's serial chain of 16 slots' geometry
// and shading took ~140k clocks, so a pixel's slots are spread over a
// group of lanes (kGroup, flat_warp.cuh), 8 warps of 32 / kGroup pixels a
// block, and the draws a warp needs are listed in shared memory and
// spread over its 32 lanes (pruning each lane's own draws measured slower
// than none in K2).  Memory sees the tables once per block and the
// image once; a block whose pixels all lie in tiles that the activity
// prepass (fused_render._active_tiles) proves empty writes the background
// without its tables, and so does a pixel of such a tile, as the TPU
// kernel's bg_only branch does; the TPU kernel's face packing is not
// ported (exact either way).
//
// Numerics: built with -fmad=false and without fast math, so every
// Heaviside and >=max threshold sees the same rounding as the plain
// PyTorch version, whose separate ops are never contracted; the image has
// pixel_forward's bits (flat_warp.cuh).
//
// With external coverage (pt_fused_forward_ext, the sharded route's K3:
// _forward_kernel with cfg.prob_ext, _pallas_forward at :1646): the
// coverage is read from prob (N, f_pad, H * W), the group's mean of K11a
// (sharded.cu), instead of drawn; the aggregation's weights (N, c_zpad,
// H * W) are written beside the image, the background one-hot on an
// inactive tile (the JAX kernel's _bg_weights).
//
// The counting entry (pt_fused_forward_diag, a diagnostic) runs the
// kernel's COUNT instantiation, which adds each warp's FlatCounts to 8
// int64 on the card; the entries of the main path take no counters.
#include <cuda_runtime.h>

#include "flat_warp.cuh"

namespace {

using namespace ptf;
using ptw::CardWarp;

// Shared memory: the tables (rounded to 4 floats), the faces' FaceConst,
// then each warp's scratch.
__host__ __device__ inline size_t tables_words(const Params& p) {
  return (table_floats(p) + 3) & ~(size_t)3;
}

template <int MAXF>
size_t forward_smem(const Params& p) {
  return sizeof(float) * tables_words(p) + sizeof(FaceConst) * p.f_pad +
         sizeof(int) * kFlatWarps * flat_scratch_words<MAXF>();
}

template <int MAXF, bool EXT, bool COUNT>
__global__ void __launch_bounds__(kFlatWarps * 32)
fused_forward_kernel(const Params p, unsigned long long* counts) {
  extern __shared__ __align__(16) float smem[];
  constexpr int G = kGroup<MAXF>();
  const int b = blockIdx.y, warp = threadIdx.x >> 5;
#if defined(PT_PROFILE)
  const long long t_start = clock64();
#endif
  const int npix = p.image_size * p.image_size;
  const int pix = blockIdx.x * block_pixels<MAXF>() + warp * (32 / G) +
                  (int)(threadIdx.x & 31) / G;
  const bool live = pix < npix;
  // A block whose pixels all lie in inactive tiles writes the background
  // (and the background one-hot weights) without its tables.
  if (!__syncthreads_or(live && pixel_active(p, b, pix))) {
    if (!live) return;
    const float* sc = p.scal + (size_t)b * kNS;
    const int g = threadIdx.x % G;
    if (g == 0)
      reinterpret_cast<float4*>(p.out)[(size_t)b * npix + pix] =
          make_float4(sc[kBg], sc[kBg + 1], sc[kBg + 2], 0.0f);
    if (EXT)
      for (int r = g; r < p.c_zpad; r += G)
        p.w_out[((size_t)b * p.c_zpad + r) * npix + pix] =
            r == p.bg_row ? 1.0f : 0.0f;
    return;
  }
  const Tables T = load_tables(p, smem, b);
  FaceConst* fc = (FaceConst*)(smem + tables_words(p));
  for (int i = threadIdx.x; i < p.f_pad; i += blockDim.x)
    face_const(T, i, fc[i]);
  CardWarp w{(int)(threadIdx.x & 31)};
  constexpr int words = flat_scratch_words<MAXF>();
  int* base = (int*)(fc + p.f_pad) + warp * words;
  const FlatScratch S = flat_scratch<MAXF>(base);
  for (int k = w.lane; k < 2 * flat_list<MAXF>(); k += 32) S.hits[k] = 0;
  __syncthreads();
  FlatCounts dc = {};
  float o[4];
  warp_flat_forward<MAXF, EXT>(p, T, fc, b, live ? pix : 0, live, w, S, dc,
                               o);
  if (live && w.lane % G == 0)
    reinterpret_cast<float4*>(p.out)[(size_t)b * npix + pix] =
        make_float4(o[0], o[1], o[2], o[3]);
#if defined(PT_PROFILE)
  // Each warp's clocks from its start (slots 8-12: the sum, the most, the
  // warps, those with a pixel of an active tile and their sum).
  const unsigned long long dt = (unsigned long long)(clock64() - t_start);
  const bool busy = w.ballot(live && pixel_active(p, b, pix)) != 0;
  if (w.lane == 0) {
    atomicAdd(&pt_prof[8], dt);
    atomicMax(&pt_prof[9], dt);
    atomicAdd(&pt_prof[10], 1ull);
    if (busy) {
      atomicAdd(&pt_prof[11], 1ull);
      atomicAdd(&pt_prof[12], dt);
    }
  }
#endif
  if (COUNT) {
    const unsigned long long v[8] = {dc.pixels,      dc.certain,
                                     dc.cover_full,  dc.cover_drawn,
                                     dc.agg_full,    dc.agg_drawn,
                                     dc.near,        dc.weighted};
    for (int k = 0; k < 8; ++k) {
      const unsigned long long t = ptw::wsum(w, v[k]);
      if (w.lane == 0) atomicAdd(&counts[k], t);
    }
  }
}

// The per-pixel reference: pixel_forward, one thread per pixel.
template <int MAXF, bool EXT>
__global__ void __launch_bounds__(kThreads)
pixel_forward_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const Tables T = load_tables(p, smem, b);
  const int npix = p.image_size * p.image_size;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  float o[4];
  pixel_forward<MAXF, float, EXT>(p, T, b, pix, o);
  reinterpret_cast<float4*>(p.out)[(size_t)b * npix + pix] =
      make_float4(o[0], o[1], o[2], o[3]);
}

// Which kernel an entry launches: the warp pipeline, its counting
// instantiation, or the per-pixel reference.
enum Mode { kWarp, kCount, kReference };

template <int MAXF, bool EXT, bool COUNT>
cudaError_t launch_warp(const Params& p, int n, unsigned long long* counts,
                        cudaStream_t stream) {
  const int pixels = p.image_size * p.image_size;
  const size_t smem = forward_smem<MAXF>(p);
  const cudaError_t e =
      allow_smem(fused_forward_kernel<MAXF, EXT, COUNT>, smem);
  if (e != cudaSuccess) return e;
  constexpr int per = block_pixels<MAXF>();
  fused_forward_kernel<MAXF, EXT, COUNT>
      <<<dim3((pixels + per - 1) / per, n), kFlatWarps * 32, smem, stream>>>(
          p, counts);
  return cudaGetLastError();
}

template <int MAXF, bool EXT>
cudaError_t launch(const Params& p, int n, unsigned long long* counts,
                   Mode mode, cudaStream_t stream) {
  const int pixels = p.image_size * p.image_size;
  const dim3 grid((pixels + kThreads - 1) / kThreads, n);
  if (mode == kReference) {
    const size_t smem = sizeof(float) * table_floats(p);
    const cudaError_t e = allow_smem(pixel_forward_kernel<MAXF, EXT>, smem);
    if (e != cudaSuccess) return e;
    pixel_forward_kernel<MAXF, EXT><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
  if (mode == kCount) return launch_warp<MAXF, EXT, true>(p, n, counts, stream);
  return launch_warp<MAXF, EXT, false>(p, n, nullptr, stream);
}

template <bool EXT>
int forward_entry(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, void* out,
    const void* prob, void* weights, int n, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, const void* active, int nt, int p_tile, int tile_w,
    void* counts, Mode mode, void* stream) {
  Params p = {};
  p.prob_ext = (const float*)prob;
  p.w_out = (float*)weights;
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
  unsigned long long* c = (unsigned long long*)counts;
  if (f_pad <= 16) return (int)launch<16, EXT>(p, n, c, mode, st);
  if (f_pad <= 32) return (int)launch<32, EXT>(p, n, c, mode, st);
  if (f_pad <= 64) return (int)launch<64, EXT>(p, n, c, mode, st);
  if (f_pad <= 128) return (int)launch<128, EXT>(p, n, c, mode, st);
  if (f_pad <= 256) return (int)launch<256, EXT>(p, n, c, mode, st);
  return (int)cudaErrorInvalidValue;
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
  return forward_entry<false>(
      fv_ndc, fv_world, fn, tex, valid, scal, seeds, out, nullptr, nullptr, n,
      image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r, rast_kind,
      rast_noise, rast_vr, s_rast, agg_kind, agg_noise, agg_vr, s_agg, k,
      eps_bg, phong, point_light, clip, persp, active, nt, p_tile, tile_w,
      nullptr, kWarp, stream);
}

// K3 with external coverage: prob (N, f_pad, H * W) in, the image and the
// weights (N, c_zpad, H * W) out.
extern "C" int pt_fused_forward_ext(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, void* out,
    const void* prob, void* weights, int n, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, const void* active, int nt, int p_tile, int tile_w,
    void* stream) {
  return forward_entry<true>(
      fv_ndc, fv_world, fn, tex, valid, scal, seeds, out, prob, weights, n,
      image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r, rast_kind,
      rast_noise, rast_vr, s_rast, agg_kind, agg_noise, agg_vr, s_agg, k,
      eps_bg, phong, point_light, clip, persp, active, nt, p_tile, tile_w,
      nullptr, kWarp, stream);
}

// The diagnostic entry, of either mode (prob null draws the coverage,
// else reads it and writes the weights): diag 1, the counting launch
// (counts: 8 zeroed int64 on the card, flat_warp.cuh's FlatCounts in
// order); diag 2, the per-pixel reference (pixel_forward).
extern "C" int pt_fused_forward_diag(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, void* out,
    const void* prob, void* weights, int n, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, const void* active, int nt, int p_tile, int tile_w,
    void* counts, int diag, void* stream) {
  if (diag != kCount && diag != kReference) return (int)cudaErrorInvalidValue;
  auto entry = prob != nullptr ? forward_entry<true> : forward_entry<false>;
  return entry(fv_ndc, fv_world, fn, tex, valid, scal, seeds, out, prob,
               weights, n, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
               rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
               agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp,
               active, nt, p_tile, tile_w, counts, (Mode)diag, stream);
}

#ifdef PT_PROFILE
// The phase clocks of K3's warp pipeline (csrc/flat_warp.cuh), then
// zeroes them.
extern "C" int pt_fused_forward_profile(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pt_prof, sizeof(pt_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(pt_prof, zero, sizeof(zero));
}
#endif
