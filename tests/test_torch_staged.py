"""The port's staged rasterizer, routing and ``init_target`` against the
JAX package.

The JAX side is compiled without fused multiply-adds
(``_torch_parity.jax_exact``), and the scenes
(``_torch_parity.staged_scene``) project every vertex to the same bits in
both packages, so the selected faces are compared exactly and the
fragments' values at atol 1e-6.  Small sizes: the 12-face cube at 32^2,
the 1280-face icosphere at 64^2 (flat, and binned with bin_size 16),
N = 2.  Shaders: tests/test_torch_staged_shaders.py and
tests/test_torch_staged_random.py.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

import pertrenderer_tpu as pt
import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.experiments import harness as jharness
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.experiments import harness as tharness
from pertrenderer_tpu_torch.ops import fused_render as tfr
from _torch_parity import (jax_exact, one_torch_thread,  # noqa: F401
                           staged_scene)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kind,imsize,bin_size", [
    ("cube", 32, None), ("icosphere", 64, None), ("icosphere", 64, 16)])
def test_rasterizer_matches_jax(kind, imsize, bin_size):
    """rasterize_meshes / rasterize_planar, flat and binned selection:
    pix_to_face equal, zbuf / dists / barycentrics within 1e-6."""
    mesh, cameras, _lights, renderer = staged_scene(
        mesh_kind=kind, imsize=imsize, k=6, sigma=2e-3, bin_size=bin_size)
    settings = renderer.rasterizer.raster_settings
    assert settings.resolve_binning(mesh.max_faces)[0] == (bin_size or 0)
    jfrag, jplanar = jax_exact(
        lambda m, c: (pt.rasterize_meshes(m, c, settings),
                      pt.rasterize_planar(m, c, settings)), mesh, cameras)
    tmesh = convert.from_reference(mesh, device="cpu")
    tcams = convert.from_reference(cameras, device="cpu")
    tsettings = convert.from_reference(settings)
    tfrag = ptt.rasterize_meshes(tmesh, tcams, tsettings)
    tplanar = ptt.rasterize_planar(tmesh, tcams, tsettings)
    p2f = np.asarray(jfrag.pix_to_face)
    np.testing.assert_array_equal(tfrag.pix_to_face.numpy(), p2f)
    np.testing.assert_array_equal(tplanar.pix_to_face.numpy(), p2f)
    assert (p2f >= 0).sum() > 100 and (p2f[..., 1] >= 0).any()
    for name in ("zbuf", "dists", "bary_coords"):
        np.testing.assert_allclose(getattr(tfrag, name).numpy(),
                                   np.asarray(getattr(jfrag, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    for name in ("w0", "w1", "w2"):
        np.testing.assert_allclose(getattr(tplanar, name).numpy(),
                                   np.asarray(getattr(jplanar, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_render_plan_reports_staged_as_jax():
    """plan() says 'staged' with the JAX package's reason: a shader outside
    the fused menu, and an image above the fused kernels' limit."""
    mesh, _c, _l, hard = staged_scene("HardPhongShader")
    tmesh = convert.from_reference(mesh, device="cpu")
    got = convert.from_reference(hard, device="cpu").plan(tmesh)
    want = hard.plan(mesh)
    assert (got.mode, got.reason) == (want.mode, want.reason) == (
        "staged", want.reason)
    mesh, _c, _l, big = staged_scene(imsize=4096)
    sh, settings = big.shader, big.rasterizer.raster_settings
    want = jfr.render_plan(mesh, sh.cameras, sh.lights, sh.materials,
                           sh.smoothrast, sh.smoothagg, settings)
    got = convert.from_reference(big, device="cpu").plan(tmesh)
    assert got.mode == want.mode == "staged"
    assert got.reason == want.reason


def test_staged_mc_estimators_raise_naming_k8():
    """The staged route with a Monte-Carlo estimator runs (kernels K8a-c,
    their plain versions on the CPU): a render the fused planner declines
    (a znear override) gives a finite image that its seed words fix, draws
    them from the generator as the fused routes do, and has gradients, also
    through render_loss's staged fallback; a sharded sample axis outside
    a device mesh raises, naming the missing mesh."""
    mesh, _c, _l, renderer = staged_scene(noise="gaussian", imsize=16)
    trend = convert.from_reference(renderer, device="cpu")
    tmesh = convert.from_reference(mesh, device="cpu")
    assert trend.plan(tmesh, znear=1.0).mode == "staged"
    seeds = tfr.draw_seeds(2, torch.Generator().manual_seed(5), device="cpu")
    img = trend(tmesh, seeds=seeds, znear=1.0)
    assert img.shape == (2, 16, 16, 4) and torch.isfinite(img).all()
    assert (img[..., 3] > 0.5).sum() > 20
    assert torch.equal(img, trend(tmesh, seeds=seeds, znear=1.0))
    assert not torch.equal(img, trend(tmesh, seeds=seeds + 1, znear=1.0))
    drawn = trend(tmesh, generator=torch.Generator().manual_seed(5),
                  znear=1.0)
    assert torch.equal(img, drawn)
    verts = tmesh.verts.detach().clone().requires_grad_()
    (g,) = torch.autograd.grad(
        trend(tmesh.update_padded(verts), seeds=seeds, znear=1.0)[..., :3]
        .sum(), [verts])
    assert torch.isfinite(g).all() and g.abs().max() > 0
    loss = trend.render_loss(tmesh.update_padded(verts), img[..., :3] * 0.5,
                             seeds=seeds, znear=1.0)
    torch.testing.assert_close(
        loss, torch.mean((img[..., :3] * 0.5) ** 2), rtol=1e-6, atol=0)
    (g,) = torch.autograd.grad(loss, [verts])
    assert torch.isfinite(g).all() and g.abs().max() > 0
    sh = dataclasses.replace(trend.shader, smoothrast=dataclasses.replace(
        trend.shader.smoothrast, sample_axis="s"))
    with pytest.raises(RuntimeError, match="no device mesh"):
        trend.replace(shader=sh)(tmesh, znear=1.0)
    with pytest.raises(RuntimeError, match="no device mesh"):
        ptt.perturbed_argmax(torch.zeros(1, 3), 1e-2, seeds[:1, 2:],
                             sample_axis="s")


def test_init_target_cube_matches_jax():
    """init_target('cube') with the JAX package's true pose: the Hard-Phong
    target, at least 99.9% of pixels within 1e-5."""
    jout = jharness.init_target(jax.random.PRNGKey(4), "cube", imsize=64)
    r_true = np.array(jout[4])
    tout = tharness.init_target(category="cube", imsize=64, R_true=r_true,
                                device="cpu")
    np.testing.assert_allclose(tout[0].verts.numpy(),
                               np.asarray(jout[0].verts), rtol=0, atol=1e-6)
    want, got = np.asarray(jout[3][0]), tout[3][0].numpy()
    assert got.shape == want.shape == (64, 64, 3)
    close = np.all(np.abs(got - want) <= 1e-5, axis=-1).mean()
    assert close >= 0.999, close
    assert (want.sum(-1) > 0).mean() > 0.05
    sphere = tharness.init_target(category="sphere", imsize=32,
                                  R_true=r_true, device="cpu")
    assert sphere[0].max_faces == 1280
    assert abs(sphere[0].verts.abs().max().item() - 3.0) < 1e-5
    assert (sphere[3][0].sum(-1) > 0).float().mean() > 0.05
    with pytest.raises(FileNotFoundError, match="ShapeNet"):
        tharness.init_target(category="mug", device="cpu")
