// K12: the binned route's fused forward, backward and loss-and-grad.
//
// Replaces _forward_kernel (pertrenderer_tpu/ops/fused_render.py:799),
// _backward_kernel (:873) and _loss_grad_kernel (:2962) run with
// cfg.binned (pallas_calls at :1657, :1694 and :3169; per-tile output
// blocks at :996-1012 and :3101-3130).  Each tile of p_tile row-major
// pixels (a strip of a pixel row) renders against its own M-slot tables
// (N, nt, M, .): the faces that _binned_tables_sorted selected for it.
//
// Design for Hopper (binned_warp.cuh): one block per (batch element,
// tile); the block's warps take the tile's pixels in turn, and a warp
// renders one pixel with the slots across its lanes.  A pixel has a few
// candidates among its tile's 160 slots, so after one geometry test per
// slot (five per lane) the candidates are compacted across the lanes and
// only they are shaded, draw coverage noise, aggregate and take adjoints;
// each lane holds its rows' state in registers, and the reductions over
// the rows are warp shuffles.  The noise is the flat kernels' counter
// hash keyed by (seed words, sample, the bin-local slot row, the absolute
// pixel), gaussian rows paired over M rows for coverage and c_zpad for
// aggregation, as in JAX.
//
// The tile's tables arrive by one bulk asynchronous copy (TMA,
// cp.async.bulk, onto an mbarrier) into shared memory.  A tile without a
// filled slot (activity bit 0) leaves before: the forward writes the
// background, the gradients take only the background colour's gradient
// and the loss, and neither copies a table.
//
// Gradient reduction, with no atomics and no barrier per slot: each warp
// adds its pixels' slot rows, in pixel order, into its own slice of
// shared memory (a slot belongs to one lane at a pixel); at the end of
// the tile, behind one barrier, the block adds the slices in warp order
// into the tile's rows of the gradient tables (N, nt, M, .), which only
// this block writes.  Where the slices do not fit (a large atlas), one
// warp per block adds into the tile's rows directly.  The 34 scalar
// gradients and the loss are summed in double: per lane, across the warp,
// across the warps in order into (N, nt, 35), and a second kernel adds
// the tiles in order.  Two launches give the same bits.
//
// Bound on the H100: operations, as K3 / K4 / K2 (the noise draws and the
// slot geometry per pixel); device memory sees the tile's tables once per
// block, the image or cotangent once and the tile's gradient rows once.
//
// Numerics: -fmad=false and no fast math, as every fused kernel; the
// aggregation and the adjoints in double (z_inv, z_map, weights, blend
// sum, alpha's products; in the gradients also the adjoints down to the
// slot tables): a binned scene's scalar gradients are sums over ~1e7
// (slot, pixel) terms that cancel, and its many faces seen nearly edge-on
// have rows of cancelling L / h-sized terms; float arithmetic misses
// float64 on both by more than the checks allow.  K3 / K4 / K2 keep float.
#include <cuda_runtime.h>
#include <stdint.h>

#include "binned_warp.cuh"

namespace {

using namespace ptf;

constexpr int kFwdWarps = 4;        // forward: warps per block
constexpr int kMaxGradWarps = 8;    // gradients: at most, per block

using ptw::bulk_load;
using ptw::CardWarp;
using ptw::smem_addr;

// Floats of a tile's tables in shared memory (K12's layout: ndc, world,
// normals, validity, texels, then the 34 scalars), rounded up to 16 bytes.
PT_HOST_HD size_t tile_floats(const Params& p) {
  return ((size_t)p.f_pad * (kGeo + 1 + p.tex_d) + kNS + 3) & ~(size_t)3;
}

// Per-warp shared memory: the gradient kernel's slot-row slice (when in
// shared memory), the candidate list (M ints) and the noise rows (c_zpad
// floats), rounded up to 16 bytes.
PT_HOST_HD size_t warp_floats(const Params& p, bool slices) {
  const size_t slice = slices ? (size_t)p.f_pad * (kGeo + p.tex_d) : 0;
  return (slice + p.f_pad + p.c_zpad + 3) & ~(size_t)3;
}

// log_prob's table in shared memory (visible after load_tile_async's
// barrier), or null.
__device__ const double* fill_log_table(const Params& p, double* lg) {
  if (!uses_log_table(p)) return nullptr;
  for (int k = threadIdx.x; k <= p.s_rast; k += blockDim.x)
    lg[k] = log_prob_mean(k, p.s_rast);
  return lg;
}

// The tile's tables of batch element b by TMA bulk copies onto one
// mbarrier, the scalars by plain loads; every thread returns once both
// have landed.
__device__ Tables load_tile_async(const Params& p, float* smem, int b, int t,
                                  uint64_t* bar) {
  const size_t bt = (size_t)b * p.nt + t;
  const int F = p.f_pad, td = p.tex_d;
  Tables T;
  T.ndc = smem;
  T.world = smem + F * 9;
  T.fn = smem + F * 18;
  T.valid = smem + F * 27;
  T.tex = smem + F * 28;
  T.sc = smem + F * (28 + td);
  T.rs_geo = 9;
  T.rs_tex = td;
  T.rs_valid = 1;
  T.key_valid = false;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned geo = 36u * F, tex = 4u * F * td;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_addr(bar)),
        "r"(3 * geo + 4u * F + tex)
        : "memory");
    bulk_load((void*)T.ndc, p.fv_ndc + bt * F * 9, geo, bar);
    bulk_load((void*)T.world, p.fv_world + bt * F * 9, geo, bar);
    bulk_load((void*)T.fn, p.fn + bt * F * 9, geo, bar);
    bulk_load((void*)T.valid, p.valid + bt * F, 4u * F, bar);
    if (tex) bulk_load((void*)T.tex, p.tex + bt * F * td, tex, bar);
  }
  float* s_sc = const_cast<float*>(T.sc);
  for (int i = threadIdx.x; i < kNS; i += blockDim.x)
    s_sc[i] = p.scal[(size_t)b * kNS + i];
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred q;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;\n"
        " selp.u32 %0, 1, 0, q;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
  __syncthreads();
  return T;
}

template <int MAXF>
__global__ void __launch_bounds__(kFwdWarps * 32)
binned_forward_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int t = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npix = p.image_size * p.image_size;
  float4* out = reinterpret_cast<float4*>(p.out) + (size_t)b * npix;
  if (p.active != nullptr && p.active[(size_t)b * p.nt + t] <= 0) {
    const float* sc = p.scal + (size_t)b * kNS;
    for (int i = threadIdx.x; i < p.p_tile; i += blockDim.x) {
      bool inside;
      const int pix = tile_pixel(p, t, i, &inside);
      if (inside) out[pix] = make_float4(sc[kBg], sc[kBg + 1], sc[kBg + 2],
                                         0.0f);
    }
    return;
  }
  __shared__ double lg[kMaxLogS + 1];
  const double* lgs = fill_log_table(p, lg);
  const Tables T = load_tile_async(p, smem, b, t, &bar);
  float* mine = smem + tile_floats(p) + warp * warp_floats(p, false);
  int* list = reinterpret_cast<int*>(mine);
  float* nzbuf = mine + p.f_pad;
  CardWarp w{lane};
  for (int i = warp; i < p.p_tile; i += kFwdWarps) {
    bool inside;
    const int pix = tile_pixel(p, t, i, &inside);
    if (!inside) continue;
    float o[4];
    warp_pixel_forward<MAXF>(p, T, b, pix, w, list, nzbuf, lgs, o);
    if (lane == 0) out[pix] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Sums the block's per-thread accumulators (warp butterflies, then the
// warps in order) into the tile's scalar row.
__device__ void block_scalars(const Params& p, size_t bt, int nwarps,
                              double (*stage)[kNS + 1]) {
  __syncthreads();
  for (int k = threadIdx.x; k <= kNS; k += blockDim.x) {
    double s = 0.0;
    for (int v = 0; v < nwarps; ++v) s += stage[v][k];
    p.pscal64[bt * (kNS + 1) + k] = s;
  }
}

template <int MAXF, bool LOSS>
__global__ void __launch_bounds__(kMaxGradWarps * 32)
binned_grad_kernel(const Params p, int slices) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ double stage[kMaxGradWarps][kNS + 1];
  const int t = blockIdx.x, b = blockIdx.y;
  const size_t bt = (size_t)b * p.nt + t;
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  CardWarp w{lane};
  if (p.active != nullptr && p.active[(size_t)b * p.nt + t] <= 0) {
    // Uniform over the block: no warp waits at a barrier below.
    PixelAccT<double> acc;
    zero_acc(acc);
    const float* sc = p.scal + (size_t)b * kNS;
    for (int i = threadIdx.x; i < p.p_tile; i += blockDim.x) {
      bool inside;
      const int pix = tile_pixel(p, t, i, &inside);
      if (inside) background_grads<LOSS>(p, sc, b, pix, acc);
    }
    for (int k = 0; k < kNS; ++k) {
      const double v = wsum(w, acc.gsc[k]);
      if (lane == 0) stage[warp][k] = v;
    }
    const double v = wsum(w, acc.loss);
    if (lane == 0) stage[warp][kNS] = v;
    block_scalars(p, bt, nwarps, stage);
    return;
  }
  __shared__ double lg[kMaxLogS + 1];
  const double* lgs = fill_log_table(p, lg);
  const Tables T = load_tile_async(p, smem, b, t, &bar);
  const int F = p.f_pad, D = kGeo + p.tex_d;
  const size_t tbl = tile_floats(p), per = warp_floats(p, slices);
  PixelAccT<double> acc;
  zero_acc(acc);
  float* mine = smem + tbl + warp * per;
  const int slice = slices ? F * D : 0;
  int* list = reinterpret_cast<int*>(mine + slice);
  float* nzbuf = reinterpret_cast<float*>(list + F);
  GradRows rows;
  rows.tex_d = p.tex_d;
  if (slices) {
    rows.ndc = mine;
    rows.world = mine + F * 9;
    rows.fn = mine + F * 18;
    rows.tex = mine + F * 27;
    for (int i = lane; i < slice; i += 32) mine[i] = 0.0f;
    __syncwarp();
  } else {                       // one warp: the tile's rows directly
    rows.ndc = p.g_ndc + bt * F * 9;
    rows.world = p.g_world + bt * F * 9;
    rows.fn = p.g_fn + bt * F * 9;
    rows.tex = p.g_tex + bt * F * p.tex_d;
  }
  for (int i = warp; i < p.p_tile; i += nwarps) {
    bool inside;
    const int pix = tile_pixel(p, t, i, &inside);
    if (!inside) continue;
    warp_pixel_grads<MAXF, LOSS>(p, T, b, pix, w, list, nzbuf, lgs, rows,
                                 acc);
  }
  warp_finish(p, T.sc, acc, w, stage[warp]);
  if (slices) {
    // The warps' slices in warp order into the tile's rows (the slice is
    // laid out as the four tables' rows of this tile).
    __syncthreads();
    const int geo = F * 9;
    for (int e = threadIdx.x; e < slice; e += blockDim.x) {
      float s = 0.0f;
      for (int v = 0; v < nwarps; ++v)
        s += smem[tbl + v * per + e];
      if (e < geo)
        p.g_ndc[bt * geo + e] = s;
      else if (e < 2 * geo)
        p.g_world[bt * geo + e - geo] = s;
      else if (e < 3 * geo)
        p.g_fn[bt * geo + e - 2 * geo] = s;
      else
        p.g_tex[bt * F * p.tex_d + e - 3 * geo] = s;
    }
  }
  block_scalars(p, bt, nwarps, stage);
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

// The dynamic shared memory a block may take beside the kernel's static.
template <class Kern>
cudaError_t smem_room(Kern kern, size_t* room) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
  if (e != cudaSuccess) return e;
  *room = (size_t)optin - attr.sharedSizeBytes;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*room);
}

// The bulk copies need 16-byte aligned tables.
inline bool tables_aligned(const Params& p) {
  const uintptr_t a = (uintptr_t)p.fv_ndc | (uintptr_t)p.fv_world |
                      (uintptr_t)p.fn | (uintptr_t)p.tex |
                      (uintptr_t)p.valid;
  return (a & 15) == 0 && p.f_pad % 4 == 0;
}

template <int MAXF>
cudaError_t launch_binned_forward(const Params& p, int n, cudaStream_t st) {
  if (!tables_aligned(p)) return cudaErrorMisalignedAddress;
  const size_t smem =
      sizeof(float) *
      (tile_floats(p) + kFwdWarps * warp_floats(p, false));
  size_t room = 0;
  cudaError_t e = smem_room(binned_forward_kernel<MAXF>, &room);
  if (e != cudaSuccess) return e;
  if (smem > room) return cudaErrorInvalidValue;
  binned_forward_kernel<MAXF>
      <<<dim3(p.nt, n), kFwdWarps * 32, smem, st>>>(p);
  return cudaGetLastError();
}

// Warps per block: the count among 8, 4, 2, 1 that keeps the most warps
// resident on an SM (the slices take shared memory per warp); one warp
// adding into the tile's rows directly where no slice fits.
template <int MAXF, bool LOSS>
cudaError_t launch_binned_grads(const Params& p, int n, cudaStream_t st) {
  if (!tables_aligned(p)) return cudaErrorMisalignedAddress;
  auto kern = binned_grad_kernel<MAXF, LOSS>;
  size_t room = 0;
  cudaError_t e = smem_room(kern, &room);
  if (e != cudaSuccess) return e;
  int best = 0, best_resident = 0, slices = 1;
  for (int warps = kMaxGradWarps; warps >= 1; warps /= 2) {
    const size_t smem =
        sizeof(float) * (tile_floats(p) + warps * warp_floats(p, true));
    if (smem > room) continue;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                      warps * 32, smem);
    if (e != cudaSuccess) return e;
    if (blocks * warps > best_resident) {
      best_resident = blocks * warps;
      best = warps;
    }
  }
  if (best == 0) {
    best = 1;
    slices = 0;
  }
  const size_t smem =
      sizeof(float) * (tile_floats(p) + best * warp_floats(p, slices));
  if (smem > room) return cudaErrorInvalidValue;
  kern<<<dim3(p.nt, n), best * 32, smem, st>>>(p, slices);
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

#ifdef PT_PROFILE
// The phase clocks of a profiling build (binned_warp.cuh), read and reset.
extern "C" int pt_binned_profile(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pt_prof, sizeof(pt_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(pt_prof, zero, sizeof(zero));
}
#endif
