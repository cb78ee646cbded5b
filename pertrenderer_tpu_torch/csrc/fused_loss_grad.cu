// K2: fused image loss and gradients, one thread per pixel; a warp of
// pixels without a candidate slot stops after det1 (fused_grad.cuh).
//
// Replaces _loss_grad_kernel (pertrenderer_tpu/ops/fused_render.py:2962,
// pallas_call in _pallas_loss_grad at :3169) in flat, unsharded, unpacked
// mode: K4 with the image-loss cotangent derived in place from a target
// (N, 3, H*W) — l2_rgb: 2 * (rgb - target) * lscale, l1_rgb:
// sign(rgb - target) * lscale, lscale = 1 / (N * H * W * 3) — so one
// launch gives the loss of each batch element and every gradient.  This
// is the pose step's only kernel.  The pipeline is fused_grad.cuh.
//
// Bound on the H100: compute, as K4, plus one more aggregation noise
// pass for MC aggregation: the weight cotangent needs the rendered RGB,
// so the forward loop runs first and the backward loop replays the
// counter hash (bit-identical noise) instead of stashing S * c_zpad
// floats per pixel as the TPU kernel's VMEM stash does.  Reads the
// target once; the reduction is K4's (per-warp rows, fixed-order sum).
// Why the early exit and the two-level reduction (fused_grad.cuh): on
// an H100 (cube, 256^2, N=1; experiments/kernel_splits.py k2) most warps
// hold no candidate, and adding 2048 warp rows with one thread per column
// took a quarter of the call.
#include <cuda_runtime.h>

#include "fused_grad.cuh"

extern "C" int pt_fused_loss_grad(
    const void* fv_ndc, const void* fv_world, const void* fn, const void* tex,
    const void* valid, const void* scal, const void* seeds,
    const void* target, void* partial, int warps, void* g_ndc, void* g_world,
    void* g_fn, void* g_tex, void* g_scal, void* loss, int n, int image_size,
    int f_pad, int bg_row, int c_zpad, int tex_d, int atlas_r, int rast_kind,
    int rast_noise, int rast_vr, int s_rast, int agg_kind, int agg_noise,
    int agg_vr, int s_agg, int k, float eps_bg, int phong, int point_light,
    int clip, int persp, int loss_kind, float lscale, const void* active,
    int nt, int p_tile, int tile_w, void* stream) {
  return ptf::grads_entry<true>(
      fv_ndc, fv_world, fn, tex, valid, scal, seeds, target, partial, warps,
      g_ndc, g_world, g_fn, g_tex, g_scal, loss, n, image_size, f_pad, bg_row,
      c_zpad, tex_d, atlas_r, rast_kind, rast_noise, rast_vr, s_rast,
      agg_kind, agg_noise, agg_vr, s_agg, k, eps_bg, phong, point_light, clip,
      persp, loss_kind, lscale, active, nt, p_tile, tile_w, stream);
}

// K2's pixel kernel's shape (fused_grad.cuh: grads_occupancy).
extern "C" int pt_fused_loss_grad_occupancy(int f_pad, int tex_d, int* out) {
  return ptf::grads_occupancy<true>(f_pad, tex_d, out);
}

#ifdef PT_PROFILE
// K2's phase clocks of a profiling build (det1; coverage; the aggregation
// forward and the blend; the loss and the aggregation's backward replay;
// the slots' adjoints and the sink; a dead warp's exit), read and reset.
extern "C" int pt_grads_profile(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, pt_prof, sizeof(pt_prof));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(pt_prof, zero, sizeof(zero));
}
#endif
