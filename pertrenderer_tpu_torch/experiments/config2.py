"""BASELINE config 2: the icosphere silhouette through the perturbed
Heaviside (the port of ``tests/test_silhouette.py``'s scene and criteria).

    python -m pertrenderer_tpu_torch.experiments.config2
        [--out results/config2.json] [--device cuda]

At 128^2 (``IMAGE``), the level-2 icosphere (162 verts / 320 faces,
white per-vertex colour) is seen from dist 2.7, elev 10, azim 30, fov 60.
``rasterize_meshes`` (the staged route: flat select, derive through K9a,
its gradient K9b) gives the fragments at K=8 and blur log(1/1e-4 - 1) sigma; ``GaussianRast``'s
perturbed Heaviside of -dists (K8a) gives each slot's coverage and the
silhouette is alpha = 1 - prod(1 - p) over the filled slots.

- ``fit_scale``: 60 steps of gradient descent on the mesh's scale from 0.7
  with the 1/t step 0.4 / (1 + i/10), clipped to [0.2, 3], against the
  silhouette at scale 1; the JAX test asks that it ends within 0.08 of 1.
- ``gradient_variance``: the variance of the perturbed Heaviside's
  gradient over 24 seed words at S in {4, 16, 64}, on the JAX test's
  synthetic 16 x 16 field (sigma 0.3) and on the scene's own dists; it
  must fall with S, by more than 4x from 4 to 64.
- ``gumbel_weights``: the perturbed argmax with gumbel noise (K8b,
  forward-only) over SoftRast coverage at blur 1e-4 (``gumbel_inputs``);
  its weights must sum to 1 within 1e-5.

Seed words come from CPU generators (``fused_render.draw_seeds``); the
JAX test draws threefry keys, so the two packages' MC draws differ.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.models.smoothagg import _StochasticAgg
from pertrenderer_tpu_torch.ops import fused_render
from pertrenderer_tpu_torch.ops.perturbed import perturbed_heaviside

__all__ = ["scene", "settings", "alpha", "fit_scale", "synthetic_field",
           "scene_dists", "gradient_variance", "gumbel_inputs",
           "gumbel_weights", "main"]

IMAGE = 128
SIGMA, K, S = 1e-3, 8, 8
ZNEAR, ZFAR = 1.0, 100.0
GUMBEL_SEED = 5
FIT_STEPS, FIT_START = 60, 0.7
SAMPLE_COUNTS, SEED_WORDS = (4, 16, 64), 24
_BLUR_CONST = float(np.log(1.0 / 1e-4 - 1.0))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def scene(device="cuda"):
    """(mesh, cameras) of the silhouette scene."""
    verts, faces = ptt.make_icosphere(2)
    mesh = ptt.Meshes.create(verts, faces, device=device,
                             textures=ptt.TexturesVertex(torch.ones(
                                 1, verts.shape[0], 3, device=device)))
    r, t = ptt.look_at_view_transform(dist=2.7, elev=10.0, azim=30.0,
                                      device=device)
    return mesh, ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0,
                                               device=device)


def settings(imsize: int):
    return ptt.RasterizationSettings(image_size=imsize,
                                     blur_radius=_BLUR_CONST * SIGMA,
                                     faces_per_pixel=K)


def _seeds(generator, device):
    return fused_render.draw_seeds(1, generator, device=device)


def alpha(mesh, cameras, scale, seeds, imsize: int, nb_samples: int = S):
    """(1, H, W) silhouette of ``mesh`` scaled by ``scale`` (a float or a
    tensor that may require grad); ``seeds`` (1, 4) int32, words 0/1 key
    the coverage draws."""
    frags = ptt.rasterize_meshes(mesh.scale_verts(scale), cameras,
                                 settings(imsize))
    rast = ptt.GaussianRast.create(sigma=SIGMA, nb_samples=nb_samples)
    mask = (frags.pix_to_face >= 0).float()
    prob = rast.rasterize(frags.dists, seeds[:, :2]) * mask
    return 1.0 - torch.prod(1.0 - prob, dim=-1)


def fit_scale(mesh, cameras, imsize: int, generator=None):
    """(final scale, losses): the silhouette scale fit of the JAX test."""
    generator = generator or torch.Generator().manual_seed(0)
    dev = mesh.device
    with torch.no_grad():
        target = alpha(mesh, cameras, 1.0,
                       _seeds(torch.Generator().manual_seed(42), dev), imsize)
    s = torch.tensor(FIT_START, device=dev)
    losses = []
    for i in range(FIT_STEPS):
        s = s.detach().requires_grad_(True)
        loss = torch.mean((alpha(mesh, cameras, s, _seeds(generator, dev),
                                 imsize) - target) ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            s = torch.clamp(s - 0.4 / (1.0 + i / 10.0) * s.grad, 0.2, 3.0)
    return float(s), losses


def synthetic_field(device="cuda"):
    """The JAX test's field: 256 distances in [-0.5, 0.5] as (1, 16, 16,
    1), at sigma 0.3."""
    return (torch.linspace(-0.5, 0.5, 256, device=device).reshape(
        1, 16, 16, 1), 0.3)


def scene_dists(mesh, cameras, imsize: int):
    """The distances of the scene's filled slots as (1, M, 1), at
    SIGMA."""
    with torch.no_grad():
        frags = ptt.rasterize_meshes(mesh, cameras, settings(imsize))
    return frags.dists[frags.pix_to_face >= 0].reshape(1, -1, 1), SIGMA


def gradient_variance(d, sigma, generator=None, words=SEED_WORDS):
    """Mean over the elements of the variance over ``words`` seed words of
    d/dd sum(perturbed Heaviside(-d)) (gaussian, variance reduction), one
    value per sample count."""
    generator = generator or torch.Generator().manual_seed(0)
    out = []
    for s_count in SAMPLE_COUNTS:
        grads = []
        for _ in range(words):
            x = d.detach().clone().requires_grad_(True)
            seeds = _seeds(generator, d.device)[:, :2]
            torch.sum(perturbed_heaviside(-x, sigma, seeds, s_count,
                                          "gaussian", True)).backward()
            grads.append(x.grad.reshape(-1))
        g = torch.stack(grads).double()
        out.append(float(g.var(dim=0, unbiased=False).mean()))
    return out


def gumbel_inputs(mesh, cameras, imsize: int):
    """(agg, zbuf, prob, mask): the perturbed argmax with gumbel noise
    (gamma 1e-2, S=16) and its inputs, SoftRast coverage at blur 1e-4,
    K=8."""

    @dataclasses.dataclass
    class GumbelAgg(_StochasticAgg):
        noise_type = "gumbel"

    st = ptt.RasterizationSettings(image_size=imsize, blur_radius=1e-4,
                                   faces_per_pixel=K)
    frags = ptt.rasterize_meshes(mesh, cameras, st)
    mask = frags.pix_to_face >= 0
    prob = ptt.SoftRast.create(sigma=1e-3).rasterize(frags.dists) * mask
    return GumbelAgg.create(gamma=1e-2, nb_samples=16), frags.zbuf, prob, mask


def gumbel_weights(mesh, cameras, imsize: int, seeds):
    """(1, H, W, K + 1) weights of ``gumbel_inputs``' perturbed argmax at
    znear 1, zfar 100; ``seeds`` (1, 4) int32, words 2/3 key the draws."""
    agg, zbuf, prob, mask = gumbel_inputs(mesh, cameras, imsize)
    return agg.aggregate(zbuf, ZFAR, ZNEAR, prob, mask, seeds[:, 2:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(_ROOT, "results",
                                                  "config2.json"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    mesh, cams = scene(dev)
    t0 = time.perf_counter()
    scale, losses = fit_scale(mesh, cams, IMAGE,
                              torch.Generator().manual_seed(0))
    fit_s = time.perf_counter() - t0
    field = synthetic_field(dev)
    var_field = gradient_variance(*field, torch.Generator().manual_seed(1))
    var_scene = gradient_variance(*scene_dists(mesh, cams, IMAGE),
                                  torch.Generator().manual_seed(2))
    w = gumbel_weights(mesh, cams, IMAGE, fused_render.draw_seeds(
        1, torch.Generator().manual_seed(GUMBEL_SEED), device=dev))
    rec = {
        "config": f"BASELINE config 2: level-2 icosphere silhouette at "
                  f"{IMAGE}^2, GaussianRast sigma {SIGMA}, S={S}, K={K}",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "fit": {"start": FIT_START, "final_scale": scale,
                "steps": FIT_STEPS, "loss_first": losses[0],
                "loss_last": losses[-1], "seconds": fit_s,
                "within_0.08": abs(scale - 1.0) < 0.08},
        "variance": {"counts": list(SAMPLE_COUNTS), "field": var_field,
                     "scene": var_scene},
        "gumbel_max_abs_sum_minus_1": float((w.sum(-1) - 1.0).abs().max()),
        "gumbel_finite": bool(torch.isfinite(w).all()),
    }
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()
