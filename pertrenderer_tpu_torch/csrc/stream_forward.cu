// K5: the stream route's forward render, one block per (batch element,
// tile), one thread per pixel.
//
// Replaces _stream_forward_kernel (pertrenderer_tpu/ops/fused_render.py:
// 2155, pallas_call in _pallas_stream_forward at :2658): for each tile it
// walks the ascending list of 64-row chunks of the sorted face table
// (fused_render._stream_tables); per chunk det1, MC or deterministic
// coverage, the unshifted z_map, the alpha product, and either a running
// first-wins argmax per aggregation sample or an online softmax
// (stream_grad.cuh).  Output (N, H, W, 4); a tile that the activity
// prepass proves empty writes the background, alpha 0.
//
// Bound on the H100: compute.  Per visited (row, pixel) pair: det1's
// geometry, and for the candidates texel, Phong, the coverage draws and
// z_map; per live row pair and sample one Box-Muller pair.  Memory sees
// each visited chunk once per tile (64 x dt floats, staged into shared
// memory by the whole block) and the image once.  The per-pixel chunk
// arrays live in local memory; making it fast (the rows across a warp's
// lanes, as K6 / K7's stream_warp.cuh; cp.async double buffering of the
// chunks, fewer dead-row draws) is later work.
//
// Numerics: -fmad=false and no fast math, as K3, so every threshold and
// strict-greater test sees the plain version's rounding.
#include <cuda_runtime.h>

#include "stream_grad.cuh"

namespace {

using namespace ptf;

__global__ void __launch_bounds__(256) stream_forward_kernel(const Params p) {
  extern __shared__ float smem[];
  float* s_blk = smem;
  float* s_sc = smem + kChunk * p.dt;
  const int b = blockIdx.y, t = blockIdx.x, tid = (int)threadIdx.x;
  for (int k = tid; k < kNS; k += blockDim.x)
    s_sc[k] = p.scal[(size_t)b * kNS + k];
  __syncthreads();
  bool live;
  const int pix = tile_pixel(p, t, tid, &live);
  float px, py;
  pixel_center(p.image_size, pix, &px, &py);
  const uint32_t pos = (uint32_t)pix;
  const int bt = b * p.nt + t;
  StreamState st;
  state_init(p, s_sc, b, pos, st);
  if (p.active[bt] > 0) {
    ChunkRows R;
    const int* list = p.rows + (size_t)bt * p.nch;
    for (int q = 0; q < p.count[bt]; ++q) {
      stage_chunk(p, b, list[q], s_blk);
      const Tables T = chunk_tables(p, s_blk, s_sc);
      chunk_forward(p, T, b, list[q], px, py, live, pos, st, R);
    }
  }
  if (!live) return;
  float rgb[3];
  state_rgb(p, st, rgb);
  reinterpret_cast<float4*>(p.out)[(size_t)b * p.image_size * p.image_size +
                                   pix] =
      make_float4(rgb[0], rgb[1], rgb[2], 1.0f - st.alpha);
}

}  // namespace

extern "C" int pt_stream_forward(
    const void* tab, const void* rows, const void* count, const void* active,
    const void* scal, const void* seeds, void* out, int n, int nt, int nch,
    int p_tile, int tile_w, int rw, int dt, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, void* stream) {
  Params p = {};
  p.tab = (const float*)tab;
  p.rows = (const int*)rows;
  p.count = (const int*)count;
  p.scal = (const float*)scal;
  p.seeds = (const int*)seeds;
  p.out = (float*)out;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  p.nch = nch;
  p.rw = rw;
  p.dt = dt;
  if (p_tile % 32 || p_tile > 256 || dt % 4 || agg_samples(p) > kMaxS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kChunk * dt + kNS);
  cudaError_t e = allow_smem(stream_forward_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  stream_forward_kernel<<<dim3(nt, n), p_tile, smem, (cudaStream_t)stream>>>(
      p);
  return (int)cudaGetLastError();
}
