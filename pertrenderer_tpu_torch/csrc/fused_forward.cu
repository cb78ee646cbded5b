// K3: flat fused forward render, one thread per output pixel.
//
// Replaces _forward_kernel (pertrenderer_tpu/ops/fused_render.py:799,
// pallas_call in _pallas_forward at :1657) in flat, unsharded, unpacked
// mode: det1 (edge-function geometry, texel select, Phong), coverage (MC
// perturbed Heaviside or soft / affine / hard), det2 (z_map with the
// log / gamma-over-alpha scaling and the background channel), aggregation
// (MC perturbed >=-max one-hots, softmax, or first-wins hard one-hot) and
// det3 (weighted colors, alpha = 1 - prod(1 - prob)).  Output (N, H, W, 4).
// The per-pixel pipeline is pixel_forward (fused_common.cuh), which the
// binned route's forward (K12, fused_binned.cu) shares.
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
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const Tables T = load_tables(p, smem, b);
  const int npix = p.image_size * p.image_size;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  float o[4];
  pixel_forward<MAXF>(p, T, b, pix, o);
  reinterpret_cast<float4*>(p.out)[(size_t)b * npix + pix] =
      make_float4(o[0], o[1], o[2], o[3]);
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
