"""The perturbed shaders on the staged route: RandomPhongShader and
RandomSimpleShader with the deterministic estimator pairs (SoftRast +
SoftAgg, AffineRast + HardAgg, HardRast + HardAgg) on vertex, UV and atlas
textures, driven through ``rasterizer.planar`` + ``shader(...)``, against
the JAX package's staged route compiled without fused multiply-adds
(``_torch_parity.jax_exact``); and the staged route against the port's own
fused route.

Images at atol 2e-5; gradients (vertices, texture values, light location,
sigma, gamma) within 1e-4 of their max |grad|.  The scenes
(``_torch_parity.staged_scene``) project every vertex to the same bits in
both packages.  Small sizes: the cube at 32^2, N = 2.
"""

import dataclasses

import numpy as np
import pytest

import torch

from pertrenderer_tpu_torch import convert
from _torch_parity import (assert_staged_parity,  # noqa: F401
                           one_torch_thread, port_staged, staged_scene)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("shader,noise,textures", [
    ("RandomPhongShader", "softras", "uv"),
    ("RandomPhongShader", "softras", "vertex"),
    ("RandomPhongShader", "softras", "atlas4"),
    ("RandomPhongShader", "uniform", "uv_map"),
    ("RandomPhongShader", "hard", "vertex"),
    ("RandomSimpleShader", "softras", "uv_map"),
    ("RandomSimpleShader", "uniform", "atlas4"),
    ("RandomSimpleShader", "hard", "uv")])
def test_random_shader_staged_matches_jax(shader, noise, textures):
    mesh, _c, lights, renderer = staged_scene(shader, noise=noise,
                                              textures=textures)
    assert_staged_parity(renderer, mesh, lights)


def test_staged_matches_fused_softras_cube():
    """Inside the port: the staged route and the flat fused route (plain
    versions here) render the softras pair alike, K = 16 >= F so neither
    truncates; images atol 2e-5, gradients to the vertices, sigma and
    gamma within 1e-4 of their max."""
    mesh, _c, _l, renderer = staged_scene(k=16)
    trend = convert.from_reference(renderer, device="cpu")
    tmesh = convert.from_reference(mesh, device="cpu")
    assert trend.plan(tmesh).mode == "flat"
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 32, 4)).astype(np.float32))
    out = {}
    for route in ("staged", "fused"):
        verts = tmesh.verts.detach().clone().requires_grad_()
        sr, sa = trend.shader.smoothrast, trend.shader.smoothagg
        sigma = sr.sigma.detach().clone().requires_grad_()
        gamma = sa.gamma.detach().clone().requires_grad_()
        sh = dataclasses.replace(
            trend.shader, smoothrast=dataclasses.replace(sr, sigma=sigma),
            smoothagg=dataclasses.replace(sa, gamma=gamma))
        rend = trend.replace(shader=sh)
        mesh_v = tmesh.update_padded(verts)
        img = (port_staged(rend, mesh_v) if route == "staged"
               else rend(mesh_v, seeds=torch.zeros(2, 4, dtype=torch.int32)))
        grads = torch.autograd.grad(torch.sum(img * w),
                                    [verts, sigma, gamma])
        out[route] = (img.detach(), grads)
    (img_s, g_s), (img_f, g_f) = out["staged"], out["fused"]
    assert (img_s[..., 3] > 0.5).sum() > 50
    torch.testing.assert_close(img_s, img_f, rtol=0, atol=2e-5)
    for name, a, b in zip(("verts", "sigma", "gamma"), g_s, g_f):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= 1e-4, (name, err)
