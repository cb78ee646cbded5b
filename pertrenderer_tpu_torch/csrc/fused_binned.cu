// K12: the binned route's fused forward, backward and loss-and-grad.
//
// Replaces _forward_kernel (pertrenderer_tpu/ops/fused_render.py:799),
// _backward_kernel (:873) and _loss_grad_kernel (:2962) run with
// cfg.binned (pallas_calls at :1657, :1694 and :3169; per-tile output
// blocks at :996-1012 and :3101-3130).  Each tile of p_tile row-major
// pixels (a strip of a pixel row) renders against its own M-slot tables
// (N, nt, M, .): the faces that _binned_tables_sorted selected for it.
// The per-pixel pipelines are K3's and K4 / K2's (pixel_forward in
// fused_common.cuh, pixel_grads in fused_grad.cuh, instantiated with
// double arithmetic from the aggregation on; see Numerics below): the
// slot row keys the MC noise (the bin-local slot), pos the absolute
// row-major pixel, and gaussian rows pair over the block's row count
// (M for coverage, c_zpad for aggregation), as in JAX.
//
// One block of 128 threads per (batch element, tile); the block copies the
// tile's tables and the element's scalars into shared memory, and each
// thread runs one pixel, looping when the tile has more pixels than the
// block has threads.
//
// Gradient reduction, with no atomics: slot by slot (the slot loop of
// pixel_grads, which a block-wide vote keeps in step across the warps),
// each warp sums its 32 lanes with a butterfly into its own row of a
// shared stage; then the block adds the warps' rows in a fixed order
// into the tile's rows of the gradient tables (N, nt, M, .), which only
// this block writes.  The 34 scalar gradients and the loss are summed in
// double (per thread, across the warp and the warps) into (N, nt, 35),
// as the stream kernels sum theirs, and a second kernel adds the tiles in
// order.  Two launches give the same bits.
//
// Bound on the H100: compute, as K3 / K4 / K2 (the noise draws and the
// slot geometry per pixel); device memory sees the tile's tables once per
// block, the image or cotangent once and the tile's gradient rows once
// per slot.
//
// Numerics: -fmad=false and no fast math, as every fused kernel.  The
// per-pixel pipelines run with double from the aggregation on (z_inv,
// z_map, weights, blend sum; in the gradients also the adjoints down to
// the slot tables, pixel_grads): K3 / K4 / K2 keep float.  A binned
// scene's scalar gradients are sums over ~1e7 (slot, pixel) terms that
// cancel, and its many faces seen nearly edge-on have rows of cancelling
// L / h-sized terms; float arithmetic misses float64 on both by more than
// the checks allow.
#include <cuda_runtime.h>

#include "fused_grad.cuh"

namespace {

using namespace ptf;

// The tables of tile t of batch element b (rows (b * nt + t) * M ..) and
// the element's scalars, in shared memory (load_tables on shifted
// pointers).
__device__ __forceinline__ Tables load_tile_tables(const Params& p,
                                                   float* smem, int b,
                                                   int t) {
  const size_t bt = (size_t)b * p.nt + t;
  const int F = p.f_pad;
  Params q = p;
  q.fv_ndc = p.fv_ndc + bt * F * 9;
  q.fv_world = p.fv_world + bt * F * 9;
  q.fn = p.fn + bt * F * 9;
  q.tex = p.tex + bt * F * p.tex_d;
  q.valid = p.valid + bt * F;
  q.scal = p.scal + (size_t)b * kNS;
  return load_tables(q, smem, 0);
}

template <int MAXF>
__global__ void __launch_bounds__(kThreads)
binned_forward_kernel(const Params p) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, b = blockIdx.y;
  const Tables T = load_tile_tables(p, smem, b, t);
  const int npix = p.image_size * p.image_size;
  for (int i = threadIdx.x; i < p.p_tile; i += blockDim.x) {
    bool inside;
    const int pix = tile_pixel(p, t, i, &inside);
    if (!inside) continue;
    float o[4];
    pixel_forward<MAXF, double>(p, T, b, pix, o);
    reinterpret_cast<float4*>(p.out)[(size_t)b * npix + pix] =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// The reduction of one tile's gradients (see the top of the file): the
// pixel pipeline's sink calls land in the warp's stage row; any() (a
// block-wide vote, so every warp walks the same slots) and flush() add
// the stage's rows in warp order to the row the stage holds.
__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct BlockSink {
  const Params* p;
  float* stage;        // (kWarps, width): a slot row's per-warp sums
  double* sstage;      // (kWarps, kNS + 1): the scalar row's, in double
  size_t bt;           // b * nt + t
  int width, warp, lane;
  int pending;         // offset of the staged row (slot * D, or F * D for
                       // the scalars and the loss); -1: nothing staged

  __device__ bool any(bool x) {
    flush();
    return __syncthreads_or(x) != 0;
  }
  __device__ float* row(int off) {
    pending = off;
    return stage + warp * width;
  }
  __device__ void add(float* row, int d, float v) {
    v = warp_sum(v);
    if (lane == (d & 31)) row[d] += v;
  }
  // The scalar row (finish_pixels, from a double accumulator).
  __device__ void add(float*, int d, double v) {
    v = warp_sum_d(v);
    if (lane == (d & 31)) sstage[warp * (kNS + 1) + d] += v;
  }
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
  __device__ void flush() {
    __syncthreads();
    if (pending >= 0) {
      const int F = p->f_pad, D = kGeo + p->tex_d;
      const bool slot = pending < F * D;
      const int cols = slot ? D : kNS + 1;
      const size_t r = bt * F + pending / D;
      for (int d = threadIdx.x; d < cols; d += blockDim.x) {
        if (!slot) {
          double s = 0.0;
          for (int w = 0; w < kWarps; ++w) {
            s += sstage[w * (kNS + 1) + d];
            sstage[w * (kNS + 1) + d] = 0.0;
          }
          p->pscal64[bt * (kNS + 1) + d] += s;
          continue;
        }
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          s += stage[w * width + d];
          stage[w * width + d] = 0.0f;
        }
        if (d < 9)
          p->g_ndc[r * 9 + d] += s;
        else if (d < 18)
          p->g_world[r * 9 + d - 9] += s;
        else if (d < kGeo)
          p->g_fn[r * 9 + d - 18] += s;
        else
          p->g_tex[r * p->tex_d + d - kGeo] += s;
      }
    }
    __syncthreads();
    pending = -1;
  }
};

PT_HOST_HD int stage_width(int tex_d) {
  return kGeo + tex_d > kNS + 1 ? kGeo + tex_d : kNS + 1;
}

template <int MAXF, bool LOSS>
__global__ void __launch_bounds__(kThreads)
binned_grad_kernel(const Params p) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, b = blockIdx.y;
  const Tables T = load_tile_tables(p, smem, b, t);
  const int width = stage_width(p.tex_d);
  // The double stage first (8-byte aligned: the tables' float count may
  // be odd), then the float stage.
  double* sstage = reinterpret_cast<double*>(
      smem + ((table_floats(p) + 1) & ~(size_t)1));
  float* stage = reinterpret_cast<float*>(sstage + kWarps * (kNS + 1));
  for (int i = threadIdx.x; i < kWarps * width; i += blockDim.x)
    stage[i] = 0.0f;
  for (int i = threadIdx.x; i < kWarps * (kNS + 1); i += blockDim.x)
    sstage[i] = 0.0;
  __syncthreads();
  BlockSink sink{&p, stage, sstage, (size_t)b * p.nt + t, width,
                 (int)(threadIdx.x >> 5), (int)(threadIdx.x & 31), -1};
  PixelAccT<double> acc;
  for (int k = 0; k < kNS; ++k) acc.gsc[k] = 0.0;
  acc.g_gal = acc.g_invgam = acc.loss = 0.0;
  // Every thread runs every pass: the sink's votes need the whole block.
  for (int c0 = 0; c0 < p.p_tile; c0 += blockDim.x) {
    bool inside = false;
    const int i = c0 + (int)threadIdx.x;
    const int pix = i < p.p_tile ? tile_pixel(p, t, i, &inside) : 0;
    pixel_grads<MAXF, LOSS>(p, T, b, inside ? pix : 0, inside, sink, acc);
    sink.flush();
  }
  finish_pixels(p, T, sink, acc);
  sink.flush();
}

// Adds the tiles' scalar rows in ascending tile order (in double): the
// 34 scalar gradients and the loss of each batch element.
__global__ void binned_scalar_reduce_kernel(const Params p) {
  const int b = blockIdx.x, k = threadIdx.x;
  if (k > kNS) return;
  const double* src = p.pscal64 + (size_t)b * p.nt * (kNS + 1) + k;
  double s = 0.0;
  for (int t = 0; t < p.nt; ++t) s += src[(size_t)t * (kNS + 1)];
  if (k < kNS)
    p.g_scal[(size_t)b * kNS + k] = (float)s;
  else
    p.loss[b] = (float)s * p.lscale;
}

template <int MAXF>
cudaError_t launch_binned_forward(const Params& p, int n, cudaStream_t st) {
  const size_t smem = sizeof(float) * table_floats(p);
  const cudaError_t e = allow_smem(binned_forward_kernel<MAXF>, smem);
  if (e != cudaSuccess) return e;
  binned_forward_kernel<MAXF><<<dim3(p.nt, n), kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int MAXF, bool LOSS>
cudaError_t launch_binned_grads(const Params& p, int n, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (((table_floats(p) + 1) & ~(size_t)1) +
                       kWarps * stage_width(p.tex_d)) +
      sizeof(double) * kWarps * (kNS + 1);
  cudaError_t e = allow_smem(binned_grad_kernel<MAXF, LOSS>, smem);
  if (e != cudaSuccess) return e;
  binned_grad_kernel<MAXF, LOSS><<<dim3(p.nt, n), kThreads, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  binned_scalar_reduce_kernel<<<n, 64, 0, st>>>(p);
  return cudaGetLastError();
}

Params binned_params(const void* fv_ndc, const void* fv_world,
                     const void* fn, const void* tex, const void* valid,
                     const void* scal, const void* seeds, const void* active,
                     int nt, int p_tile, int tile_w) {
  Params p = {};
  p.fv_ndc = (const float*)fv_ndc;
  p.fv_world = (const float*)fv_world;
  p.fn = (const float*)fn;
  p.tex = (const float*)tex;
  p.valid = (const float*)valid;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  set_tiling(p, active, nt, p_tile, tile_w);
  return p;
}

// The slot-count bucket of the per-pixel arrays (M is a multiple of 8, at
// most 160).
template <class F32, class F64, class F160>
int by_slots(int f_pad, F32 f32, F64 f64, F160 f160) {
  if (f_pad <= 32) return (int)f32();
  if (f_pad <= 64) return (int)f64();
  if (f_pad <= 160) return (int)f160();
  return (int)cudaErrorInvalidValue;
}

template <bool LOSS>
int binned_grads_entry(const void* fv_ndc, const void* fv_world,
                const void* fn, const void* tex, const void* valid,
                const void* scal, const void* seeds, const void* extra,
                void* pscal,
                void* g_ndc, void* g_world, void* g_fn, void* g_tex,
                void* g_scal, void* loss, int n, int image_size, int f_pad,
                int bg_row, int c_zpad, int tex_d, int atlas_r,
                int rast_kind, int rast_noise, int rast_vr, int s_rast,
                int agg_kind, int agg_noise, int agg_vr, int s_agg, int k,
                float eps_bg, int phong, int point_light, int clip,
                int persp, int loss_kind, float lscale, const void* active,
                int nt, int p_tile, int tile_w, void* stream) {
  Params p = binned_params(fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                           active, nt, p_tile, tile_w);
  p.extra = (const float*)extra;
  p.pscal64 = (double*)pscal;
  p.g_ndc = (float*)g_ndc;
  p.g_world = (float*)g_world;
  p.g_fn = (float*)g_fn;
  p.g_tex = (float*)g_tex;
  p.g_scal = (float*)g_scal;
  p.loss = (float*)loss;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  p.loss_kind = loss_kind;
  p.lscale = LOSS ? lscale : 0.0f;
  cudaStream_t st = (cudaStream_t)stream;
  return by_slots(
      f_pad, [&] { return launch_binned_grads<32, LOSS>(p, n, st); },
      [&] { return launch_binned_grads<64, LOSS>(p, n, st); },
      [&] { return launch_binned_grads<160, LOSS>(p, n, st); });
}

}  // namespace

// The arguments of pt_fused_forward, over per-tile tables (N, nt, M, .).
extern "C" int pt_binned_forward(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, void* out, int n,
    int image_size, int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r,
    int rast_kind, int rast_noise, int rast_vr, int s_rast, int agg_kind,
    int agg_noise, int agg_vr, int s_agg, int k, float eps_bg, int phong,
    int point_light, int clip, int persp, const void* active, int nt,
    int p_tile, int tile_w, void* stream) {
  Params p = binned_params(fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                           active, nt, p_tile, tile_w);
  p.out = (float*)out;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  cudaStream_t st = (cudaStream_t)stream;
  return by_slots(
      f_pad, [&] { return launch_binned_forward<32>(p, n, st); },
      [&] { return launch_binned_forward<64>(p, n, st); },
      [&] { return launch_binned_forward<160>(p, n, st); });
}

// The arguments of pt_fused_backward / pt_fused_loss_grad, with the tiles'
// scalar rows (N, nt, 35) float64 in place of the partial buffer and its
// width unused; the gradient tables (N, nt, M, .) and the scalar rows must
// be zero on entry.
extern "C" int pt_binned_backward(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, const void* g_out,
    void* pscal, int unused, void* g_ndc, void* g_world, void* g_fn,
    void* g_tex, void* g_scal, void* loss, int n, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, int loss_kind, float lscale, const void* active,
    int nt, int p_tile, int tile_w, void* stream) {
  (void)unused;
  return binned_grads_entry<false>(
      fv_ndc, fv_world, fn, tex, valid, scal, seeds, g_out, pscal, g_ndc,
      g_world, g_fn, g_tex, g_scal, loss, n, image_size, f_pad, bg_row,
      c_zpad, tex_d, atlas_r, rast_kind, rast_noise, rast_vr, s_rast,
      agg_kind, agg_noise, agg_vr, s_agg, k, eps_bg, phong, point_light, clip,
      persp, loss_kind, lscale, active, nt, p_tile, tile_w, stream);
}

extern "C" int pt_binned_loss_grad(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds,
    const void* target, void* pscal, int unused, void* g_ndc, void* g_world,
    void* g_fn, void* g_tex, void* g_scal, void* loss, int n, int image_size,
    int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, int loss_kind, float lscale, const void* active,
    int nt, int p_tile, int tile_w, void* stream) {
  (void)unused;
  return binned_grads_entry<true>(
      fv_ndc, fv_world, fn, tex, valid, scal, seeds, target, pscal, g_ndc,
      g_world, g_fn, g_tex, g_scal, loss, n, image_size, f_pad, bg_row,
      c_zpad, tex_d, atlas_r, rast_kind, rast_noise, rast_vr, s_rast,
      agg_kind, agg_noise, agg_vr, s_agg, k, eps_bg, phong, point_light, clip,
      persp, loss_kind, lscale, active, nt, p_tile, tile_w, stream);
}
