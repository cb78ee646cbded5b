"""The port's public entry end to end against the JAX package:
``MeshRenderer(meshes, seeds=...)`` on the cube at 32^2, K=50, S=4, two
rotated poses, with the JAX renderer's own seed rows.  Plus the routing,
gradients of a render reaching the pose and the smoothing parameters, and
the rule that the CPU path launches no kernel."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.transforms import Rotate as JRotate
from pertrenderer_tpu.transforms import so3_exp_map as j_exp
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (KEY, MC_NOISES, assert_image_close, build,
                           interpret_env, jax_inputs)

LOG_ROT = np.array([[0.1, -0.2, 0.3], [-0.4, 0.25, 0.05]], np.float32)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


def _scene(noise):
    """JAX (posed mesh, renderer) and the port's (base mesh, renderer)."""
    mesh, _cams, _lights, renderer = build(noise, imsize=32, k=50, s=4,
                                           n_views=2, sigma=1e-2, gamma=5e-2)
    posed = mesh.update_padded(JRotate(j_exp(jnp.asarray(LOG_ROT)))
                               .transform_points(mesh.verts_padded()))
    return posed, renderer, convert.from_reference(mesh, device="cpu"), \
        convert.from_reference(renderer, device="cpu")


def _pose(tmesh, log_rot):
    rot = ptt.so3_exp_map(log_rot)
    return tmesh.update_padded(ptt.Rotate(rot).transform_points(
        tmesh.verts_padded()))


@pytest.mark.parametrize("noise", ["gaussian", "softras"])
def test_renderer_matches_jax(noise):
    posed, jrend, tmesh, trend = _scene(noise)
    want = np.asarray(jrend(posed, key=KEY))
    seed_rows = np.asarray(jax_inputs(posed, jrend)[1][-1])     # (N, 1, 8)
    before = dict(tfr.launch_counts)
    got = trend(_pose(tmesh, torch.from_numpy(LOG_ROT)), seeds=seed_rows)
    assert tfr.launch_counts == before      # CPU: plain version, no launch
    assert got.shape == (2, 32, 32, 4) and got.dtype == torch.float32
    assert (want[..., 3] > 0.5).sum() > 100
    assert_image_close(got.numpy(), want, noise in MC_NOISES)


def test_render_plan_is_flat():
    _posed, _jrend, tmesh, trend = _scene("gaussian")
    plan = trend.plan(tmesh)
    assert (plan.mode, plan.f, plan.k, plan.slots) == ("flat", 12, 50, 16)
    sh = trend.shader
    assert ptt.render_plan(tmesh, sh.lights, sh.smoothrast, sh.smoothagg,
                           trend.rasterizer.raster_settings) == plan


def test_unported_routes_raise():
    """The sharded route raises; F > faces_per_pixel streams; what the
    fused planner declines (an image above 2048, a UV texture without an
    atlas) takes the staged route, whose MC estimators run (K8a-c)."""
    _posed, _jrend, tmesh, trend = _scene("gaussian")
    few_slots = ptt.MeshRenderer(
        ptt.MeshRasterizer(trend.rasterizer.cameras, dataclasses.replace(
            trend.rasterizer.raster_settings, faces_per_pixel=8)),
        trend.shader)
    # F = 12 > faces_per_pixel = 8 takes the stream route, which is
    # ported; the sharded route below is not.
    assert few_slots.plan(tmesh).mode == "stream"
    big = ptt.MeshRenderer(ptt.MeshRasterizer(
        trend.rasterizer.cameras, dataclasses.replace(
            trend.rasterizer.raster_settings, image_size=4096)),
        trend.shader).plan(tmesh)
    assert (big.mode, big.reason) == (
        "staged", "image size above the 2048 fused-kernel limit")
    sharded = dataclasses.replace(trend.shader, smoothrast=dataclasses.replace(
        trend.shader.smoothrast, sample_axis="samples"))
    with pytest.raises(NotImplementedError, match="sharded"):
        ptt.MeshRenderer(trend.rasterizer, sharded)(tmesh)
    no_atlas = tmesh.with_textures(dataclasses.replace(tmesh.textures,
                                                       atlas_size=0))
    assert trend.plan(no_atlas).mode == "staged"
    img = trend(no_atlas, generator=torch.Generator().manual_seed(0))
    assert img.shape == (2, 32, 32, 4) and torch.isfinite(img).all()
    assert (img[..., 3] > 0.5).sum() > 50
    with pytest.raises(ValueError, match="loss_kind"):
        trend.render_loss(tmesh, torch.zeros(2, 32, 32, 3), loss_kind="l3")


def test_render_gradient_reaches_pose_and_smoothing():
    """A render's gradient (through K4's plain version here) reaches the
    pose and the sigma / gamma / alpha tensors through the packed
    scalars, finite and nonzero, and equals finite differences of the
    pose along one axis."""
    _posed, _jrend, tmesh, trend = _scene("softras")
    seeds = tfr.draw_seeds(2, torch.Generator().manual_seed(4), device="cpu")
    log_rot = torch.from_numpy(LOG_ROT).requires_grad_()
    smoothing = [torch.tensor(v, requires_grad=True)
                 for v in (1e-2, 5e-2, 1.0)]
    shader = trend.shader.update_smoothing(*smoothing)
    weights = torch.linspace(0.0, 1.0, 4)

    def objective(rot):
        img = trend.replace(shader=shader)(_pose(tmesh, rot), seeds=seeds)
        return torch.sum(img * weights)

    value = objective(log_rot)
    grads = torch.autograd.grad(value, [log_rot, *smoothing])
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max() > 0
    h = 1e-3
    step = torch.zeros_like(log_rot)
    step[0, 1] = h
    with torch.no_grad():
        fd = (objective(log_rot + step) - objective(log_rot - step)) / (2 * h)
    assert abs(fd.item() - grads[0][0, 1].item()) <= 0.05 * abs(fd.item())


def test_generator_seeds_the_noise():
    _posed, _jrend, tmesh, trend = _scene("gaussian")
    a = trend(tmesh, generator=torch.Generator().manual_seed(1))
    b = trend(tmesh, generator=torch.Generator().manual_seed(1))
    c = trend(tmesh, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    seeds = tfr.draw_seeds(2, torch.Generator().manual_seed(1),
                           device="cpu")
    assert seeds.shape == (2, 4) and seeds.dtype == torch.int32
    assert torch.equal(trend(tmesh, seeds=seeds), a)


def test_fused_forward_checks_its_inputs():
    _posed, _jrend, tmesh, trend = _scene("softras")
    sh = trend.shader
    settings = trend.rasterizer.raster_settings
    cfg, _why = tfr._plan(tmesh, sh.lights, sh.smoothrast, sh.smoothagg,
                          settings, "phong")
    inputs = list(tfr._prepare_inputs(
        cfg, tmesh, sh.cameras, sh.lights, sh.materials, sh.smoothrast,
        sh.smoothagg, sh.blend_params, settings,
        tfr.draw_seeds(2, device="cpu"), "phong"))
    assert tfr.fused_forward(cfg, *inputs).shape == (2, 32, 32, 4)
    bad_dtype = list(inputs)
    bad_dtype[5] = inputs[5].double()
    with pytest.raises(ValueError, match="scal"):
        tfr.fused_forward(cfg, *bad_dtype)
    bad_layout = list(inputs)
    bad_layout[0] = inputs[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tfr.fused_forward(cfg, *bad_layout)
