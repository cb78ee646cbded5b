// K5: the stream route's forward render, a warp per pixel with a chunk's
// rows across the lanes.
//
// Replaces _stream_forward_kernel (pertrenderer_tpu/ops/fused_render.py:
// 2155, pallas_call in _pallas_stream_forward at :2658): for each tile it
// walks the ascending list of 64-row chunks of the sorted face table
// (fused_render._stream_tables); per chunk det1, MC or deterministic
// coverage, the unshifted z_map, the alpha product, and either a running
// first-wins argmax per aggregation sample or an online softmax.  Output
// (N, H, W, 4); a tile that the activity prepass proves empty writes the
// background, alpha 0.
//
// Work: a block takes 32 pixels of one JAX stream tile (a pixel row of an
// 8 x 32 tile, a quarter of a 128-pixel strip), as K6 / K7's B1; the tiles
// and their chunk lists stay JAX's.  Its eight warps each render every
// eighth pixel, one pixel at a time with the chunk's rows across the
// lanes: lane h owns rows h and h + 32, the cos and sin halves of one
// hash (stream_warp.cuh: warp_forward_chunk, B1 without the gradients'
// state).  The pixel's state (alpha, the online softmax, per sample the
// running max and the winner's row) stays in shared memory; the chunks
// arrive by double-buffered bulk copies (cp.async.bulk onto mbarriers).
// The argmax aggregations shade only each sample's final winner, at the
// end of a pass.  Above kMaxS aggregation samples the block walks the
// chunk list once per kMaxS samples: the first pass leaves each visited
// pixel's z_map rows in device memory and the later ones read them back
// (no table, no det1, no coverage), each pass adding its samples' colours
// to the pixel's sums in s order.
//
// Bound on the H100: operations (chip_smoke.py's k5_ops, on the counts of
// this kernel's counting build).  Per visited (row, pixel) pair det1's
// geometry; per candidate its z_map and alpha factor; the texel and Phong
// per candidate for the softmax, and for the argmax aggregations only per
// distinct winner of a pixel's samples; the background's draw per pixel
// and sample; and only the noise draws that can change the image: a
// coverage pair while one of its rows lies within sigma B of its edge, an
// aggregation pair while one of its rows can still beat the sample's
// running max.  Those draws are packed across the warp's lanes, so a lane
// draws for its neighbours' rows instead of idling.  Every other outcome
// is written without a draw, by the per-row rule's own expression, so the
// image keeps the per-row rule's bits.  Memory sees each visited chunk
// once per block and the image once (above kMaxS samples also the z_map
// rows, written once and read once per pass).
//
// Numerics: -fmad=false and no fast math, as K3, so every threshold and
// strict-greater test sees the plain version's rounding.
#include <cuda_runtime.h>

#include "stream_warp.cuh"

namespace {

using namespace ptf;

// Warps per block (each renders 32 / kFwdWarps of the block's pixels) and
// the resident blocks per SM the registers are held to.
constexpr int kFwdWarps = 8;
constexpr int kFwdMinBlocks = 3;

// Shared memory in floats: two chunk buffers, the scalars, the block's
// pixel states and each warp's scratch.
size_t forward_floats(const Params& p) {
  return 2 * (size_t)kChunk * p.dt + ((kNS + 3) & ~3) +
         (size_t)kBlockPix * fwd_floats(p) + (size_t)kFwdWarps * kFwdScratch;
}

// MULTI: above kMaxS aggregation samples, one pass over the chunk list
// per kMaxS samples.  COUNT: the counts go to counts[5] (coverage draws
// needed, drawn; aggregation draws needed, drawn; winners shaded).
template <bool MULTI, bool COUNT>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdMinBlocks)
stream_forward_kernel(const Params p, unsigned long long* counts) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar[2];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int tid = threadIdx.x, ff = fwd_floats(p);
  CardWarp w{tid & 31};
  const StreamBlock B(p, 0);
  const size_t chunk = (size_t)kChunk * p.dt;
  float* s_sc = smem + 2 * chunk;
  float* states = s_sc + ((kNS + 3) & ~3);
  const FwdScratch S = fwd_scratch(states + (size_t)kBlockPix * ff +
                                   (size_t)warp * kFwdScratch);
  for (int k = tid; k < kNS; k += blockDim.x)
    s_sc[k] = p.scal[(size_t)B.b * kNS + k];
  for (int k = w.lane; k < kChunk; k += 32) S.hits[k] = 0;
  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  __syncthreads();
  DrawCounts dc = {0, 0, 0, 0, 0};
  auto state = [&](int i, int k) { return fwd_at(p, states + i * ff, k); };
  // Pass 0's visit q of the block's pixel i in the pass buffers (MULTI).
  auto zrow = [&](int q, int i) {
    return ((size_t)(p.voff[B.bt] + q) * p.nsub + B.sub) * kBlockPix + i;
  };
  const unsigned cbytes = (unsigned)(chunk * sizeof(float));
  const int passes = MULTI ? stream_passes(p) : 1;
  if (B.n > 0 && tid == 0) bulk_fetch(smem, B.chunk(p, 0), cbytes, &bar[0]);
  for (int k = 0; k < passes; ++k) {
    // The warp's pixels: i = warp, warp + nw, ... of the block's 32.
    for (int i = warp; i < kBlockPix; i += nw) {
      bool live;
      const int pix = B.pixel(p, i, &live);
      fwd_init(p, s_sc, B.b, (uint32_t)pix, w, state(i, k));
    }
    for (int q = 0; q < B.n; ++q) {
      const int cur = q & 1;
      const float* buf = cur ? smem + chunk : smem;
      if (k == 0) {   // the chunks, double-buffered: the first pass only
        if (q + 1 < B.n && tid == 0)
          bulk_fetch(cur ? smem : smem + chunk, B.chunk(p, q + 1), cbytes,
                     &bar[cur ^ 1]);
        mbar_wait(&bar[cur], (q >> 1) & 1);   // buffer cur's (q / 2)-th fill
      }
      const Tables T = chunk_tables(p, buf, s_sc);
      for (int i = warp; i < kBlockPix; i += nw) {
        bool live;
        const int pix = B.pixel(p, i, &live);
        if (!live) continue;
        float px, py;
        pixel_center(p.image_size, pix, &px, &py);
        float* zb = MULTI ? p.zbuf + zrow(q, i) * kChunk : nullptr;
        unsigned long long* zm = MULTI ? p.zmask + zrow(q, i) : nullptr;
        warp_forward_chunk<MULTI, true, COUNT>(p, T, B.b, B.list[q], px, py,
                                               (uint32_t)pix, w, state(i, k),
                                               S, dc, zb, zm);
      }
      if (k == 0) __syncthreads();
    }
    for (int i = warp; i < kBlockPix; i += nw) {
      bool live;
      const int pix = B.pixel(p, i, &live);
      float px, py;
      pixel_center(p.image_size, pix, &px, &py);
      fwd_pass_end(p, s_sc, B.b, px, py, w, state(i, k), S);
      if (COUNT && live) fwd_count_winners(p, w, state(i, k), dc);
    }
  }
  for (int i = warp; i < kBlockPix; i += nw) {
    bool live;
    const int pix = B.pixel(p, i, &live);
    if (!live || w.lane != 0) continue;
    float o[4];
    fwd_rgba(p, state(i, 0), o);
    reinterpret_cast<float4*>(p.out)[(size_t)B.b * p.image_size *
                                         p.image_size + pix] =
        make_float4(o[0], o[1], o[2], o[3]);
  }
  if (COUNT) {
    const unsigned long long c[5] = {dc.cover_need, dc.cover_drawn,
                                     dc.agg_need, dc.agg_drawn, dc.winners};
    for (int j = 0; j < 5; ++j) {
      const unsigned long long t = wsum(w, c[j]);
      if (w.lane == 0) atomicAdd(&counts[j], t);
    }
  }
}

// The kernel's shape: dynamic shared memory in bytes, its attribute raised
// to match.
template <bool MULTI, bool COUNT>
cudaError_t forward_shape(const Params& p, size_t* smem) {
  *smem = sizeof(float) * forward_floats(p);
  return allow_smem(stream_forward_kernel<MULTI, COUNT>, *smem);
}

template <bool MULTI, bool COUNT>
cudaError_t forward_launch(const Params& p, int n, unsigned long long* counts,
                           cudaStream_t st) {
  size_t smem;
  cudaError_t e = forward_shape<MULTI, COUNT>(p, &smem);
  if (e != cudaSuccess) return e;
  stream_forward_kernel<MULTI, COUNT>
      <<<dim3(p.nt * p.nsub, n), kFwdWarps * 32, smem, st>>>(p, counts);
  return cudaGetLastError();
}

}  // namespace

// Above kMaxS samples voff (N, nt: each tile's first visit,
// fused_render._stream_visit_index), zbuf (V nsub 32 64 floats) and zmask
// (V nsub 32 64-bit words) for V visits; else null.  counts: null, or 5
// zeroed 64-bit counters that a counting build of the kernel fills
// (coverage pairs needed / drawn, aggregation pairs needed / drawn;
// "needed": every pair with a candidate row, every sample, once; the
// argmax aggregations' distinct winners per pixel and pass).
extern "C" int pt_stream_forward(
    const void* tab, const void* rows, const void* count, const void* active,
    const void* scal, const void* seeds, void* out, int n, int nt, int nch,
    int p_tile, int tile_w, int rw, int dt, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, const void* voff, void* zbuf, void* zmask,
    void* counts, void* stream) {
  Params p = {};
  p.tab = (const float*)tab;
  p.rows = (const int*)rows;
  p.count = (const int*)count;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  p.out = (float*)out;
  p.voff = (const int*)voff;
  p.zbuf = (float*)zbuf;
  p.zmask = (unsigned long long*)zmask;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  p.nch = nch;
  p.rw = rw;
  p.dt = dt;
  p.nsub = p_tile / kBlockPix;
  if (p_tile % kBlockPix || dt % 4 || ((uintptr_t)tab & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* c = (unsigned long long*)counts;
  const bool multi = stream_passes(p) > 1;
  if (multi && (!voff || !zbuf || !zmask)) return (int)cudaErrorInvalidValue;
  if (c)
    return (int)(multi ? forward_launch<true, true>(p, n, c, st)
                       : forward_launch<false, true>(p, n, c, st));
  return (int)(multi ? forward_launch<true, false>(p, n, c, st)
                     : forward_launch<false, false>(p, n, c, st));
}

// The kernel's shape at (dt, tex_d, agg_kind, s_agg): out[0] warps per
// block, out[1] resident blocks per SM (the occupancy API), out[2] dynamic
// shared memory in bytes, out[3] registers per thread, out[4] local memory
// per thread in bytes.
extern "C" int pt_stream_forward_occupancy(int dt, int tex_d, int agg_kind,
                                           int s_agg, int* out) {
  Params p = {};
  p.dt = dt;
  p.tex_d = tex_d;
  p.agg_kind = agg_kind;
  p.s_agg = s_agg;
  const bool multi = stream_passes(p) > 1;
  size_t smem;
  cudaError_t e = multi ? forward_shape<true, false>(p, &smem)
                        : forward_shape<false, false>(p, &smem);
  cudaFuncAttributes a;
  if (e == cudaSuccess)
    e = multi ? cudaFuncGetAttributes(&a, stream_forward_kernel<true, false>)
              : cudaFuncGetAttributes(&a, stream_forward_kernel<false, false>);
  int blocks = 0;
  if (e == cudaSuccess)
    e = multi ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, stream_forward_kernel<true, false>,
                    kFwdWarps * 32, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, stream_forward_kernel<false, false>,
                    kFwdWarps * 32, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = kFwdWarps;
  out[1] = blocks;
  out[2] = (int)smem;
  out[3] = a.numRegs;
  out[4] = (int)a.localSizeBytes;
  return 0;
}

#ifdef PT_PROFILE
// K5's phase clocks of a profiling build (geometry, coverage draws,
// aggregation draws, the rest), read and reset.
extern "C" int pt_stream_forward_profile(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pt_prof, sizeof(pt_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(pt_prof, zero, sizeof(zero));
}
#endif
