"""Pixel-colour blending (PyTorch port of ``pertrenderer_tpu/blending.py``):
hard (nearest fragment), softmax (SoftRas) and smooth (the perturbed
estimators' composition), the staged route's last stage.  The fused routes
blend inside their kernels and read only ``BlendParams``."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ["BlendParams", "hard_rgb_blend", "softmax_rgb_blend",
           "smooth_rgb_blend", "smooth_rgb_blend_cm"]


class BlendParams(NamedTuple):
    sigma: float = 1e-4
    gamma: float = 1e-4
    background_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)


def _background(blend_params: BlendParams, like: torch.Tensor):
    return torch.as_tensor(blend_params.background_color, dtype=like.dtype,
                           device=like.device)


def hard_rgb_blend(colors: torch.Tensor, fragments,
                   blend_params: BlendParams) -> torch.Tensor:
    """Nearest fragment's colour, alpha the foreground mask: colors
    (N, H, W, K, 3) -> (N, H, W, 4)."""
    background = _background(blend_params, colors)
    is_fg = (fragments.pix_to_face[..., 0:1] >= 0).to(colors.dtype)
    rgb = colors[..., 0, :] * is_fg + background * (1.0 - is_fg)
    return torch.cat([rgb, is_fg], dim=-1)


def softmax_rgb_blend(colors: torch.Tensor, fragments,
                      blend_params: BlendParams, znear=1.0, zfar=100.0,
                      eps: float = 1e-10) -> torch.Tensor:
    """SoftRas blending: sigmoid coverage and depth-softmax weights
    (PyTorch3D's ``softmax_rgb_blend``)."""
    background = _background(blend_params, colors)
    mask = (fragments.pix_to_face >= 0).to(colors.dtype)
    prob_map = torch.where(
        fragments.pix_to_face >= 0,
        1.0 / (1.0 + torch.exp(fragments.dists / blend_params.sigma)), 0.0)
    alpha = 1.0 - torch.prod(1.0 - prob_map, dim=-1, keepdim=True)
    z_inv = (zfar - fragments.zbuf) / (zfar - znear) * mask
    z_inv_max = torch.amax(z_inv, dim=-1, keepdim=True)
    z_inv_max = torch.maximum(z_inv_max, z_inv_max.new_tensor(eps))
    weights_num = prob_map * torch.exp((z_inv - z_inv_max)
                                       / blend_params.gamma)
    delta = torch.exp((eps - z_inv_max) / blend_params.gamma)
    denom = torch.sum(weights_num, dim=-1, keepdim=True) + delta
    weighted_colors = torch.sum(weights_num[..., None] * colors, dim=-2)
    rgb = (weighted_colors + delta * background) / denom
    return torch.cat([rgb, alpha], dim=-1)


def _seed_pairs(seeds, n: int, device):
    """(rasterization words, aggregation words), each (N, 2) int32, of
    (N, 4) seed words (JAX-layout (N, 1, 8) rows: their first four); drawn
    as ``fused_render.draw_seeds`` draws them (generator seed 0) when None.
    The fused routes' convention: words 0/1 key the coverage noise, 2/3
    the aggregation's."""
    from pertrenderer_tpu_torch.ops import fused_render

    if seeds is None:
        seeds = fused_render.draw_seeds(n, device=device)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=device)
    seeds = seeds.reshape(n, -1)[:, :4]
    return seeds[:, :2].contiguous(), seeds[:, 2:].contiguous()


def smooth_rgb_blend(colors: torch.Tensor, fragments, smoothrast,
                     smoothagg, blend_params: BlendParams, znear=1.0,
                     zfar=100.0, seeds=None) -> torch.Tensor:
    """The perturbed estimators' blend (the reference's
    ``random_rasterizer.py:34-56``):

        prob_map = smoothrast.rasterize(dists) * mask
        alpha    = 1 - prod_K(1 - prob_map)
        weights  = smoothagg.aggregate(zbuf, ...)       (K + 1 channels)
        rgb      = sum_K w_k colors_k + w_bg background

    colors (N, H, W, K, 3) -> (N, H, W, 4).  ``seeds``: (N, 4) int32 seed
    words keying the MC estimators (:func:`_seed_pairs`); the
    deterministic members ignore them."""
    background = _background(blend_params, colors)
    seeds_rast, seeds_agg = _seed_pairs(seeds, colors.shape[0],
                                        colors.device)
    mask = fragments.pix_to_face >= 0
    prob_map = smoothrast.rasterize(fragments.dists, seeds_rast) * mask
    alpha_chan = torch.prod(1.0 - prob_map, dim=-1, keepdim=True)
    weights = smoothagg.aggregate(fragments.zbuf, zfar, znear, prob_map,
                                  mask, seeds_agg)
    wz, wb = weights[..., :-1], weights[..., -1:]
    rgb = torch.sum(wz[..., None] * colors, dim=-2) + wb * background
    return torch.cat([rgb, 1.0 - alpha_chan], dim=-1)


def smooth_rgb_blend_cm(colors_cm: torch.Tensor, pfrag, smoothrast,
                        smoothagg, blend_params: BlendParams, znear=1.0,
                        zfar=100.0, seeds=None) -> torch.Tensor:
    """Channel-major twin of :func:`smooth_rgb_blend`: colors_cm
    (3, N, H, W, K) and planar fragments -> RGBA (N, H, W, 4)."""
    background = _background(blend_params, colors_cm)
    seeds_rast, seeds_agg = _seed_pairs(seeds, colors_cm.shape[1],
                                        colors_cm.device)
    mask = pfrag.pix_to_face >= 0
    prob_map = smoothrast.rasterize(pfrag.dists, seeds_rast) * mask
    alpha = 1.0 - torch.prod(1.0 - prob_map, dim=-1)           # (N, H, W)
    weights = smoothagg.aggregate(pfrag.zbuf, zfar, znear, prob_map, mask,
                                  seeds_agg)                   # (.., K + 1)
    wz, wb = weights[..., :-1], weights[..., -1]
    rgb = torch.sum(wz[None] * colors_cm, dim=-1)              # (3, N, H, W)
    rgb = rgb + wb[None] * background.reshape(3, 1, 1, 1)
    return torch.cat([torch.movedim(rgb, 0, -1), alpha[..., None]], dim=-1)
