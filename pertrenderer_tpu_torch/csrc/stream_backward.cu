// K6: the stream route's backward render.
//
// Replaces _stream_backward_kernel (pertrenderer_tpu/ops/fused_render.py:
// 2256, body _stream_grad_impl :2283, pallas_call in
// _pallas_stream_backward at :2676): the vector-Jacobian product of K5 for
// an output cotangent g_out (N, H, W, 4), alpha included, giving the
// gradient of the sorted table (N, rw, dt) and the 34 scalar gradients.
// Two sweeps over the tile's chunk list with the chunk's rows across a
// warp's lanes (stream_warp.cuh): B1 replays the forward with the
// exclusion track for alpha, B2 runs the adjoints, each in its own kernel.
//
// Bound on the H100: compute — B1 draws every Box-Muller pair of every
// visited chunk for each sample (phi sums n^2 over all 64 rows), B2 the
// live pairs again and the adjoints of each candidate (row, pixel).  The
// reduction writes one partial row per (visit, block, chunk row) that had
// a candidate, summed over the block's warps in order; a second kernel
// adds a chunk's visits in ascending tile order and a third the blocks'
// scalar rows.  No atomics: the same bits every run.
//
// Numerics: -fmad=false and no fast math, as K3.
#include <cuda_runtime.h>

#include "stream_warp.cuh"

extern "C" int pt_stream_backward(
    const void* tab, const void* rows, const void* count, const void* active,
    const void* voff, const void* vstart, const void* vidx, const void* scal,
    const void* seeds, const void* g_out, void* recs, void* partial,
    void* pmask, void* pscal, void* g_tab, void* g_scal, void* loss, int n,
    int nt, int nch, int p_tile, int tile_w, int rw, int dt, int image_size,
    int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, int loss_kind, float lscale, void* stream) {
  return ptf::stream_grads_entry<false>(
      tab, rows, count, active, voff, vstart, vidx, scal, seeds, g_out,
      recs, partial, pmask, pscal, g_tab, g_scal, loss, n, nt, nch, p_tile,
      tile_w, rw, dt, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
      rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise, agg_vr,
      s_agg, k, eps_bg, phong, point_light, clip, persp, loss_kind, lscale,
      stream);
}

// K6's kernels' shapes (stream_warp.cuh: stream_grads_occupancy).
extern "C" int pt_stream_backward_occupancy(int dt, int tex_d, int agg_kind,
                                            int s_agg, int* out) {
  return ptf::stream_grads_occupancy<false>(dt, tex_d, agg_kind, s_agg, out);
}
