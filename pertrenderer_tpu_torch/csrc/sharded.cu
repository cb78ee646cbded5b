// The sample-sharded route's kernels: K11a (a lane group per pixel, as
// K3), K11b and K11c (a thread per pixel).
//
// Under sample-axis sharding each rank of a sample group draws its own
// slice [d * S, (d + 1) * S) of one sample sequence (the wrappers offset
// seed word 0), and the render splits at points where the group averages
// per-rank sample means (ops/fused_render.py _FusedSharded):
//
//   forward:  prob    = mean over the group of K11a
//             (image, weights) = K3 with that prob (fused_forward.cu,
//             pixel_forward<..., EXT>), each averaged over the group
//   backward: (g_zmap, g_gamma) = mean of K11b
//             gradients = mean of K11c, g_gamma added to gamma's column
//
// K11a replaces _prob_kernel (pertrenderer_tpu/ops/fused_render.py:1764,
// pallas_call in _pallas_prob at :1792): this shard's coverage mean
// (N, F, P) of the perturbed Heaviside, masked to the candidates (pixel_
// prob, fused_common.cuh).  K11b replaces _agg_bwd_kernel (:1804,
// pallas_call :1848): the MC aggregation's backward on this shard's
// aggregation samples, given the group's prob: g_zmap (N, c_zpad, P) and
// the gamma term per image (pixel_agg_grads, fused_grad.cuh).  K11c
// replaces _det_bwd_kernel (:1861, pallas_call :1938): K4's pipeline with
// the group's prob, weights and g_zmap given (pixel_grads<..., EXT>), whose
// only sample-dependent term is the coverage's score coefficient on this
// shard's coverage samples; the table gradients (N, F, 9) x 3, (N, F,
// tex_d) and the 34 scalar gradients go through K4's warp partials and
// fixed-order reduction.
//
// Bound on the H100: compute, as K3 / K4, except K11a.  K11a runs K3's
// pipeline up to the coverage (flat_warp.cuh's warp_flat_prob): a group of
// kGroup lanes per pixel, 8 warps a block, geometry only where a face's
// grown box (FaceConst, computed once a block) holds the pixel, and a
// candidate's S_rast samples drawn only where |d| <= fl(|sigma| B)
// (cover_certain), those draws packed across the warp; it writes f_pad
// floats per pixel, staged per block in shared memory and written a
// slot's row of consecutive pixels at a time (128 bytes with 16 slots).
// Its per-pixel reference (pixel_prob, every draw taken) stays as a
// diagnostic entry whose bits the warp pipeline keeps; its bound counts
// the box tests, the geometry in the boxes and the draws taken (the
// counting launch) against the dense write.  K11b replays S_agg
// aggregation draws over c_zpad rows and writes c_zpad floats, except
// where (variance reduction) only one row can win a sample: there g_zmap
// and the gamma term are 0 without shading or a draw, and a warp whose
// pixels are all such leaves after det1's geometry (of the slots whose
// grown box holds the pixel, from each face's FaceConst); K11c draws the
// coverage noise once more and runs the slot adjoints.  Each keeps a
// pixel's slot arrays in registers / local memory and the tables in
// shared memory.  K11b's gamma term is summed per warp with a butterfly of
// shuffles into one partial per warp, and a second kernel, a block per
// image, adds the partials in a fixed order (each thread a strided share
// of them in turn, then a halving tree): no atomics, the same bits from
// run to run.
//
// Numerics: -fmad=false and no fast math, as K3 / K4, so every threshold
// and sum rounds as the plain PyTorch versions' separate ops.
#include <cuda_runtime.h>

#include "flat_warp.cuh"
#include "fused_grad.cuh"

namespace {

using namespace ptf;
using ptw::CardWarp;

// K11a's shared memory: the NDC corners, validity and scalars (rounded to
// 4 floats), the faces' FaceConst, each warp's scratch, then the block's
// output, f_pad rows of block_pixels floats (one padding float a row).
__host__ __device__ inline size_t prob_tables_words(const Params& p) {
  return ((size_t)p.f_pad * 10 + kNS + 3) & ~(size_t)3;
}

template <int MAXF>
__host__ __device__ constexpr int prob_row() {
  return block_pixels<MAXF>() + 1;
}

template <int MAXF>
size_t prob_smem(const Params& p) {
  return sizeof(float) * prob_tables_words(p) + sizeof(FaceConst) * p.f_pad +
         sizeof(int) * kFlatWarps * flat_scratch_words<MAXF>() +
         sizeof(float) * p.f_pad * prob_row<MAXF>();
}

// K11a: warp_flat_prob (flat_warp.cuh) for the block's block_pixels
// consecutive pixels, kGroup lanes a pixel; the block's (f_pad, pixels)
// output is staged in shared memory and written a slot's row of
// consecutive pixels at a time.  A block whose pixels all lie in inactive
// tiles writes zeros without its tables.
template <int MAXF, bool COUNT>
__global__ void __launch_bounds__(kFlatWarps * 32)
sharded_prob_kernel(const Params p, unsigned long long* counts) {
  extern __shared__ float smem[];
  constexpr int G = kGroup<MAXF>(), KU = kUnits<MAXF>();
  constexpr int BP = block_pixels<MAXF>(), RW = prob_row<MAXF>();
  const int b = blockIdx.y, F = p.f_pad, U = F / 2, lane = threadIdx.x & 31;
  const int npix = p.image_size * p.image_size;
  const int pix0 = blockIdx.x * BP;
  const int at = (threadIdx.x >> 5) * (32 / G) + lane / G;
  const int pix = pix0 + at;
  const bool live = pix < npix;
  const int width = min(BP, npix - pix0);
  float* out = p.prob_out + (size_t)b * F * npix + pix0;
  if (!__syncthreads_or(live && pixel_active(p, b, pix))) {
    for (int k = threadIdx.x; k < F * BP; k += blockDim.x)
      if (k % BP < width) out[(size_t)(k / BP) * npix + k % BP] = 0.0f;
    return;
  }
  // Only the NDC corners, validity and scalars: K11a takes no colour.
  float* s_ndc = smem;
  float* s_valid = smem + F * 9;
  float* s_sc = smem + F * 10;
  for (int i = threadIdx.x; i < F * 9; i += blockDim.x)
    s_ndc[i] = p.fv_ndc[(size_t)b * F * 9 + i];
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    s_valid[i] = p.valid[(size_t)b * F + i];
  for (int i = threadIdx.x; i < kNS; i += blockDim.x)
    s_sc[i] = p.scal[(size_t)b * kNS + i];
  __syncthreads();
  Tables T = {};
  T.ndc = s_ndc;
  T.valid = s_valid;
  T.sc = s_sc;
  T.rs_geo = 9;
  T.rs_valid = 1;
  T.key_valid = false;
  FaceConst* fc = (FaceConst*)(smem + prob_tables_words(p));
  for (int i = threadIdx.x; i < F; i += blockDim.x) face_const(T, i, fc[i]);
  CardWarp w{lane};
  constexpr int words = flat_scratch_words<MAXF>();
  int* scratch = (int*)(fc + F);
  const FlatScratch S =
      flat_scratch<MAXF>(scratch + (threadIdx.x >> 5) * words);
  for (int k = lane; k < 2 * flat_list<MAXF>(); k += 32) S.hits[k] = 0;
  float* rows = (float*)(scratch + kFlatWarps * words);
  __syncthreads();
  FlatCounts dc = {};
  float pr[2 * KU];
  warp_flat_prob<MAXF>(p, fc, s_sc, b, live ? pix : 0, live, w, S, dc, pr);
  const int g = lane % G;
  for (int j = 0; j < 2 * KU; ++j) {
    const int u = g + (j % KU) * G;
    if (u < U) rows[(u + (j / KU) * U) * RW + at] = pr[j];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < F * BP; k += blockDim.x)
    if (k % BP < width)
      out[(size_t)(k / BP) * npix + k % BP] = rows[(k / BP) * RW + k % BP];
  if (COUNT) {
    const unsigned long long v[8] = {dc.pixels,      dc.certain,
                                     dc.cover_full,  dc.cover_drawn,
                                     dc.agg_full,    dc.agg_drawn,
                                     dc.near,        dc.weighted};
    for (int k = 0; k < 8; ++k) {
      const unsigned long long t = ptw::wsum(w, v[k]);
      if (lane == 0) atomicAdd(&counts[k], t);
    }
  }
}

// K11a's per-pixel reference: pixel_prob, one thread per pixel with every
// draw taken.
template <int MAXF>
__global__ void __launch_bounds__(kThreads)
pixel_prob_kernel(const Params p) {
  extern __shared__ float smem[];
  const int b = blockIdx.y, F = p.f_pad;
  float* s_ndc = smem;
  float* s_valid = smem + F * 9;
  float* s_sc = smem + F * 10;
  for (int i = threadIdx.x; i < F * 9; i += blockDim.x)
    s_ndc[i] = p.fv_ndc[(size_t)b * F * 9 + i];
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    s_valid[i] = p.valid[(size_t)b * F + i];
  for (int i = threadIdx.x; i < kNS; i += blockDim.x)
    s_sc[i] = p.scal[(size_t)b * kNS + i];
  __syncthreads();
  Tables T = {};
  T.ndc = s_ndc;
  T.valid = s_valid;
  T.sc = s_sc;
  T.rs_geo = 9;
  T.rs_valid = 1;
  T.key_valid = false;
  const int npix = p.image_size * p.image_size;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  float prob[MAXF];
  pixel_prob<MAXF>(p, T, b, pix, prob);
  for (int i = 0; i < F; ++i)
    p.prob_out[((size_t)b * F + i) * npix + pix] = prob[i];
}

template <int MAXF, bool COUNT>
__global__ void __launch_bounds__(kThreads)
sharded_agg_bwd_kernel(const Params p, unsigned long long* counts) {
  extern __shared__ float smem[];
  constexpr int MAXC = MAXF + 8;
  const int b = blockIdx.y, C = p.c_zpad;
  const Tables T = load_tables(p, smem, b);
  FaceConst* fc = (FaceConst*)(smem + table_floats(p));
  for (int i = threadIdx.x; i < p.f_pad; i += blockDim.x)
    face_const(T, i, fc[i]);
  __syncthreads();
  const int npix = p.image_size * p.image_size;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  float term = 0.0f;
  bool certain = false;
  if (pix < npix) {
    float gz[MAXC];
    term = pixel_agg_grads<MAXF>(p, T, fc, b, pix, gz, &certain);
    PT_MARK(clk);
    for (int r = 0; r < C; ++r)
      p.gz_out[((size_t)b * C + r) * npix + pix] = gz[r];
    PT_PHASE_AT(2, clk, threadIdx.x & 31);
  }
  PT_MARK(clk2);
  term = warp_sum(term);        // every lane of the warp takes part
  if ((threadIdx.x & 31) == 0)
    p.partial[(size_t)b * p.warps + blockIdx.x * kWarps +
              (threadIdx.x >> 5)] = term;
  PT_PHASE_AT(3, clk2, threadIdx.x & 31);
  if (COUNT) {
    // Pixels of active tiles, those that took the certain exit, and the
    // noise units (Box-Muller pairs; Cauchy draws) the replay draws there
    // (full) and those drawn.
    const bool act = pix < npix && pixel_active(p, b, pix);
    const unsigned long long units =
        (unsigned long long)p.s_agg *
        (p.agg_noise == kGaussian ? C / 2 : C);
    const unsigned long long v[4] = {act ? 1ull : 0ull,
                                     certain ? 1ull : 0ull,
                                     act ? units : 0ull,
                                     act && !certain ? units : 0ull};
    for (int k = 0; k < 4; ++k) {
      unsigned long long t = v[k];
      for (int o = 16; o > 0; o >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, o);
      if ((threadIdx.x & 31) == 0) atomicAdd(&counts[k], t);
    }
  }
}

// The gamma term of each image: a block per image adds its warps'
// partials in a fixed order, each thread every kGammaThreads-th partial
// in turn, then the threads' sums by a fixed halving tree.
constexpr int kGammaThreads = 256;

__global__ void __launch_bounds__(kGammaThreads)
gamma_reduce_kernel(const Params p) {
  __shared__ float part[kGammaThreads];
  const int b = blockIdx.x, t = threadIdx.x;
  const float* src = p.partial + (size_t)b * p.warps;
  float s = 0.0f;
  for (int w = t; w < p.warps; w += kGammaThreads) s += src[w];
  part[t] = s;
  __syncthreads();
  for (int h = kGammaThreads / 2; h > 0; h >>= 1) {
    if (t < h) part[t] += part[t + h];
    __syncthreads();
  }
  if (t == 0) p.g_gamma[b] = part[0];
}

Params base_params(const void* fv_ndc, const void* fv_world, const void* fn,
                   const void* tex, const void* valid, const void* scal,
                   const void* seeds) {
  Params p = {};
  p.fv_ndc = (const float*)fv_ndc;
  p.fv_world = (const float*)fv_world;
  p.fn = (const float*)fn;
  p.tex = (const float*)tex;
  p.valid = (const float*)valid;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  return p;
}

// Which kernel a K11a entry launches: the warp pipeline, its counting
// instantiation, or the per-pixel reference.
enum ProbMode { kProbWarp, kProbCount, kProbReference };

template <int MAXF>
cudaError_t launch_prob(const Params& p, int n, unsigned long long* counts,
                        ProbMode mode, cudaStream_t st) {
  const int pixels = p.image_size * p.image_size;
  if (mode == kProbReference) {
    const size_t smem = sizeof(float) * ((size_t)p.f_pad * 10 + kNS);
    pixel_prob_kernel<MAXF>
        <<<dim3((pixels + kThreads - 1) / kThreads, n), kThreads, smem,
           st>>>(p);
    return cudaGetLastError();
  }
  const size_t smem = prob_smem<MAXF>(p);
  constexpr int per = block_pixels<MAXF>();
  const dim3 grid((pixels + per - 1) / per, n);
  if (mode == kProbCount) {
    const cudaError_t e = allow_smem(sharded_prob_kernel<MAXF, true>, smem);
    if (e != cudaSuccess) return e;
    sharded_prob_kernel<MAXF, true>
        <<<grid, kFlatWarps * 32, smem, st>>>(p, counts);
    return cudaGetLastError();
  }
  const cudaError_t e = allow_smem(sharded_prob_kernel<MAXF, false>, smem);
  if (e != cudaSuccess) return e;
  sharded_prob_kernel<MAXF, false>
      <<<grid, kFlatWarps * 32, smem, st>>>(p, nullptr);
  return cudaGetLastError();
}

int prob_entry(const void* fv_ndc, const void* valid, const void* scal,
               const void* seeds, void* prob, int n, int image_size,
               int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r,
               int rast_kind, int rast_noise, int rast_vr, int s_rast,
               int agg_kind, int agg_noise, int agg_vr, int s_agg, int k,
               float eps_bg, int phong, int point_light, int clip, int persp,
               const void* active, int nt, int p_tile, int tile_w,
               void* counts, ProbMode mode, void* stream) {
  Params p = base_params(fv_ndc, nullptr, nullptr, nullptr, valid, scal,
                         seeds);
  p.prob_out = (float*)prob;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)counts;
  if (f_pad <= 16) return (int)launch_prob<16>(p, n, c, mode, st);
  if (f_pad <= 32) return (int)launch_prob<32>(p, n, c, mode, st);
  if (f_pad <= 64) return (int)launch_prob<64>(p, n, c, mode, st);
  if (f_pad <= 128) return (int)launch_prob<128>(p, n, c, mode, st);
  if (f_pad <= 256) return (int)launch_prob<256>(p, n, c, mode, st);
  return (int)cudaErrorInvalidValue;
}

template <int MAXF, bool COUNT>
cudaError_t launch_agg_bwd(const Params& p, int n, unsigned long long* counts,
                           cudaStream_t st) {
  const int blocks = (p.image_size * p.image_size + kThreads - 1) / kThreads;
  if (p.warps != blocks * kWarps) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * table_floats(p) + sizeof(FaceConst) * p.f_pad;
  cudaError_t e = allow_smem(sharded_agg_bwd_kernel<MAXF, COUNT>, smem);
  if (e != cudaSuccess) return e;
  sharded_agg_bwd_kernel<MAXF, COUNT>
      <<<dim3(blocks, n), kThreads, smem, st>>>(p, counts);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gamma_reduce_kernel<<<n, kGammaThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// K11b at every slot bucket; counts null, or the COUNT instantiation's
// counters.
template <bool COUNT>
int agg_bwd_bucket(const Params& p, int n, unsigned long long* counts,
                   cudaStream_t st) {
  const int f_pad = p.f_pad;
  if (f_pad <= 16) return (int)launch_agg_bwd<16, COUNT>(p, n, counts, st);
  if (f_pad <= 32) return (int)launch_agg_bwd<32, COUNT>(p, n, counts, st);
  if (f_pad <= 64) return (int)launch_agg_bwd<64, COUNT>(p, n, counts, st);
  if (f_pad <= 128) return (int)launch_agg_bwd<128, COUNT>(p, n, counts, st);
  if (f_pad <= 256) return (int)launch_agg_bwd<256, COUNT>(p, n, counts, st);
  return (int)cudaErrorInvalidValue;
}

int agg_bwd_entry(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, const void* prob,
    const void* g_out, void* g_zmap, void* partial, int warps, void* g_gamma,
    int n, int image_size, int f_pad, int bg_row, int c_zpad, int tex_d,
    int atlas_r, int rast_kind, int rast_noise, int rast_vr, int s_rast,
    int agg_kind, int agg_noise, int agg_vr, int s_agg, int k, float eps_bg,
    int phong, int point_light, int clip, int persp, const void* active,
    int nt, int p_tile, int tile_w, void* counts, void* stream) {
  Params p = base_params(fv_ndc, fv_world, fn, tex, valid, scal, seeds);
  p.prob_ext = (const float*)prob;
  p.extra = (const float*)g_out;
  p.gz_out = (float*)g_zmap;
  p.partial = (float*)partial;
  p.warps = warps;
  p.g_gamma = (float*)g_gamma;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)counts;
  return c != nullptr ? agg_bwd_bucket<true>(p, n, c, st)
                      : agg_bwd_bucket<false>(p, n, nullptr, st);
}

}  // namespace

#define PT_PROB_ARGS                                                        \
  fv_ndc, valid, scal, seeds, prob, n, image_size, f_pad, bg_row, c_zpad,   \
      tex_d, atlas_r, rast_kind, rast_noise, rast_vr, s_rast, agg_kind,     \
      agg_noise, agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp, \
      active, nt, p_tile, tile_w

// K11a: this shard's coverage mean prob (N, f_pad, H * W).
extern "C" int pt_sharded_prob(
    const void* fv_ndc, const void* valid, const void* scal,
    const void* seeds, void* prob, int n, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, const void* active, int nt, int p_tile, int tile_w,
    void* stream) {
  return prob_entry(PT_PROB_ARGS, nullptr, kProbWarp, stream);
}

// K11a's diagnostic entry: diag 1, the counting launch (counts: 8 zeroed
// int64 on the card, flat_warp.cuh's FlatCounts in order; the
// aggregation's and the weighted stay 0); diag 2, the per-pixel reference
// (pixel_prob).
extern "C" int pt_sharded_prob_diag(
    const void* fv_ndc, const void* valid, const void* scal,
    const void* seeds, void* prob, int n, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, const void* active, int nt, int p_tile, int tile_w,
    void* counts, int diag, void* stream) {
  if (diag != kProbCount && diag != kProbReference)
    return (int)cudaErrorInvalidValue;
  if (diag == kProbCount && counts == nullptr)
    return (int)cudaErrorInvalidValue;
  return prob_entry(PT_PROB_ARGS, counts, (ProbMode)diag, stream);
}
#undef PT_PROB_ARGS

// K11b: g_zmap (N, c_zpad, H * W) and the gamma term g_gamma (N,) of this
// shard's aggregation samples; partial holds one float per warp (N,
// warps), warps = 4 per 128-pixel block.
#define PT_AGG_BWD_ARGS                                                    \
  fv_ndc, fv_world, fn, tex, valid, scal, seeds, prob, g_out, g_zmap,      \
      partial, warps, g_gamma, n, image_size, f_pad, bg_row, c_zpad, tex_d, \
      atlas_r, rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise, \
      agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp, active,   \
      nt, p_tile, tile_w
extern "C" int pt_sharded_agg_bwd(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, const void* prob,
    const void* g_out, void* g_zmap, void* partial, int warps, void* g_gamma,
    int n, int image_size, int f_pad, int bg_row, int c_zpad, int tex_d,
    int atlas_r, int rast_kind, int rast_noise, int rast_vr, int s_rast,
    int agg_kind, int agg_noise, int agg_vr, int s_agg, int k, float eps_bg,
    int phong, int point_light, int clip, int persp, const void* active,
    int nt, int p_tile, int tile_w, void* stream) {
  return agg_bwd_entry(PT_AGG_BWD_ARGS, nullptr, stream);
}

// K11b's counting launch, a diagnostic: as pt_sharded_agg_bwd, and each
// warp's counts added to 4 zeroed int64 on the card (counts).
extern "C" int pt_sharded_agg_bwd_count(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, const void* prob,
    const void* g_out, void* g_zmap, void* partial, int warps, void* g_gamma,
    int n, int image_size, int f_pad, int bg_row, int c_zpad, int tex_d,
    int atlas_r, int rast_kind, int rast_noise, int rast_vr, int s_rast,
    int agg_kind, int agg_noise, int agg_vr, int s_agg, int k, float eps_bg,
    int phong, int point_light, int clip, int persp, const void* active,
    int nt, int p_tile, int tile_w, void* counts, void* stream) {
  if (counts == nullptr) return (int)cudaErrorInvalidValue;
  return agg_bwd_entry(PT_AGG_BWD_ARGS, counts, stream);
}
#undef PT_AGG_BWD_ARGS

// K11c: the table and scalar gradients given the group's prob, weights and
// g_zmap (each (N, rows, H * W)) and the output cotangent g_out (N, H, W,
// 4); partial, warps and loss as K4's (fused_backward.cu).
extern "C" int pt_sharded_det_bwd(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, const void* g_out,
    const void* prob, const void* weights, const void* g_zmap, void* partial,
    int warps, void* g_ndc, void* g_world, void* g_fn, void* g_tex,
    void* g_scal, void* loss, int n, int image_size, int f_pad, int bg_row,
    int c_zpad, int tex_d, int atlas_r, int rast_kind, int rast_noise,
    int rast_vr, int s_rast, int agg_kind, int agg_noise, int agg_vr,
    int s_agg, int k, float eps_bg, int phong, int point_light, int clip,
    int persp, const void* active, int nt, int p_tile, int tile_w,
    void* stream) {
  Params p = base_params(fv_ndc, fv_world, fn, tex, valid, scal, seeds);
  p.extra = (const float*)g_out;
  p.prob_ext = (const float*)prob;
  p.w_in = (const float*)weights;
  p.gz_in = (const float*)g_zmap;
  p.partial = (float*)partial;
  p.warps = warps;
  p.width = grad_width(f_pad, tex_d);
  p.g_ndc = (float*)g_ndc;
  p.g_world = (float*)g_world;
  p.g_fn = (float*)g_fn;
  p.g_tex = (float*)g_tex;
  p.g_scal = (float*)g_scal;
  p.loss = (float*)loss;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  cudaStream_t st = (cudaStream_t)stream;
  if (f_pad <= 16) return (int)launch_grads<16, false, true>(p, n, st);
  if (f_pad <= 32) return (int)launch_grads<32, false, true>(p, n, st);
  if (f_pad <= 64) return (int)launch_grads<64, false, true>(p, n, st);
  if (f_pad <= 128) return (int)launch_grads<128, false, true>(p, n, st);
  if (f_pad <= 256) return (int)launch_grads<256, false, true>(p, n, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef PT_PROFILE
// The phase clocks of the sharded kernels' pixel pipelines (K11b:
// pixel_agg_grads' det1 and replay, the g_zmap stores, the warp sum; K11c:
// pixel_grads'), then zeroes them.
extern "C" int pt_sharded_profile(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pt_prof, sizeof(pt_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(pt_prof, zero, sizeof(zero));
}
#endif
