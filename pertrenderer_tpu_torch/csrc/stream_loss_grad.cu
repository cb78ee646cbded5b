// K7: the stream route's image loss and gradients in one launch.
//
// Replaces _stream_loss_grad_kernel (pertrenderer_tpu/ops/fused_render.py:
// 2266, pallas_call in _pallas_stream_loss_grad at :2791): K6's two sweeps
// (stream_warp.cuh: a chunk's rows across a warp's lanes) with the
// image-loss cotangent derived in place after B1 from a target (N, 3,
// H*W) — l2_rgb: 2 (rgb - target) lscale, l1_rgb: sign(rgb - target)
// lscale — and no alpha track (the loss reads RGB only).  Returns the loss
// of each batch element, the sorted-table gradient and the 34 scalar
// gradients: the pose step's only kernel on the stream route.
//
// Bound on the H100: compute, as K6 without the exclusion track; reads
// the target once.  Reduction as K6.
//
// Numerics: -fmad=false and no fast math, as K3.
#include <cuda_runtime.h>

#include "stream_warp.cuh"

extern "C" int pt_stream_loss_grad(
    const void* tab, const void* rows, const void* count, const void* active,
    const void* voff, const void* vstart, const void* vidx, const void* scal,
    const void* seeds, const void* target, void* recs, void* partial,
    void* pmask, void* pscal, void* g_tab, void* g_scal, void* loss, int n,
    int nt, int nch, int p_tile, int tile_w, int rw, int dt, int image_size,
    int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, int loss_kind, float lscale, void* stream) {
  return ptf::stream_grads_entry<true>(
      tab, rows, count, active, voff, vstart, vidx, scal, seeds, target,
      recs, partial, pmask, pscal, g_tab, g_scal, loss, n, nt, nch, p_tile,
      tile_w, rw, dt, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
      rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise, agg_vr,
      s_agg, k, eps_bg, phong, point_light, clip, persp, loss_kind, lscale,
      stream);
}

// K7's kernels' shapes (stream_warp.cuh: stream_grads_occupancy).
extern "C" int pt_stream_loss_grad_occupancy(int dt, int tex_d, int agg_kind,
                                             int s_agg, int* out) {
  return ptf::stream_grads_occupancy<true>(dt, tex_d, agg_kind, s_agg, out);
}

#ifdef PT_PROFILE
// K7's phase clocks of a profiling build (B1, post, B2), read and reset.
extern "C" int pt_stream_profile(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pt_prof, sizeof(pt_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(pt_prof, zero, sizeof(zero));
}
#endif
