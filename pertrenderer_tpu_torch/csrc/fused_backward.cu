// K4: flat fused backward render, one thread per pixel; a warp of pixels
// without a candidate slot stops after det1 (fused_grad.cuh).
//
// Replaces _backward_kernel (pertrenderer_tpu/ops/fused_render.py:873,
// pallas_call in _pallas_backward at :1694) in flat, unsharded, unpacked
// mode: the vector-Jacobian product of K3 for an output cotangent g_out
// (N, H, W, 4), alpha included, giving the face-table gradients
// (N, F, 9) x 3 and (N, F, tex_d) and the 34 scalar gradients of each
// batch element.  A pixel of a tile that the activity prepass
// (fused_render._active_tiles) proves empty takes only the background
// colour's gradient, as the JAX kernel's bg_only branch.  The pipeline is
// fused_grad.cuh, shared with K2.
//
// Bound on the H100: compute, like K3 — per pixel the forward's
// S_rast * f_pad / 2 + S_agg * c_zpad / 2 Box-Muller pairs (the MC
// aggregation forward and backward share one noise pass) plus the slot
// adjoints.  Device memory sees the tables once per block, g_out once and
// one partial row per warp: each warp zeroes its own row, sums its lanes'
// per-slot gradients with shuffles (dead slots of the whole warp are
// skipped) and adds them to the row; a second kernel adds the rows in a
// fixed two-level order, so the result is the same bits on every run.
//
// Numerics: -fmad=false and no fast math, as K3, so the replayed forward
// takes the plain version's thresholds.
#include <cuda_runtime.h>

#include "fused_grad.cuh"

extern "C" int pt_fused_backward(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds, const void* g_out,
    void* partial, int warps, void* g_ndc, void* g_world, void* g_fn,
    void* g_tex, void* g_scal, void* loss, int n, int image_size, int f_pad,
    int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, int loss_kind, float lscale, const void* active,
    int nt, int p_tile, int tile_w, void* stream) {
  return ptf::grads_entry<false>(
      fv_ndc, fv_world, fn, tex, valid, scal, seeds, g_out, partial, warps,
      g_ndc, g_world, g_fn, g_tex, g_scal, loss, n, image_size, f_pad, bg_row,
      c_zpad, tex_d, atlas_r, rast_kind, rast_noise, rast_vr, s_rast,
      agg_kind, agg_noise, agg_vr, s_agg, k, eps_bg, phong, point_light, clip,
      persp, loss_kind, lscale, active, nt, p_tile, tile_w, stream);
}

// Sizes of the partial buffer the wrappers allocate for K4 and K2.
extern "C" int pt_grad_partial_warps(int n, int image_size, int f_pad,
                                     int tex_d) {
  return ptf::grad_warps(n, image_size, f_pad, tex_d);
}

extern "C" int pt_grad_partial_width(int f_pad, int tex_d) {
  return ptf::grad_width(f_pad, tex_d);
}

// K4's pixel kernel's shape (fused_grad.cuh: grads_occupancy).
extern "C" int pt_fused_backward_occupancy(int f_pad, int tex_d, int* out) {
  return ptf::grads_occupancy<false>(f_pad, tex_d, out);
}
