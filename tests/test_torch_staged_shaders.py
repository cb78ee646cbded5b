"""The port's baseline shaders on the staged route against the JAX
package: HardPhongShader, SoftPhongShader, SimpleShader, SoftSimpleShader
and SoftSilhouetteShader through MeshRenderer, render_loss's fallback
and ``from_reference`` of baseline renderers.

Images at atol 2e-5, gradients (vertices, texture values, light location)
within 1e-4 of their max |grad|, against the JAX functions compiled
without fused multiply-adds (``_torch_parity.jax_exact``).
The scenes (``_torch_parity.staged_scene``) project every vertex to the
same bits in both packages.  Small sizes: the cube at 32^2, N = 2.
"""

import dataclasses

import numpy as np
import pytest

import torch

import pertrenderer_tpu as pt
from pertrenderer_tpu_torch import convert
from _torch_parity import (assert_staged_parity,  # noqa: F401
                           jax_exact, one_torch_thread, staged_scene)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("shader,textures", [
    ("HardPhongShader", "uv"), ("HardPhongShader", "vertex"),
    ("HardPhongShader", "atlas4"), ("SoftPhongShader", "uv"),
    ("SoftPhongShader", "atlas4"), ("SimpleShader", "vertex"),
    ("SoftSimpleShader", "uv"), ("SoftSilhouetteShader", "vertex")])
def test_baseline_shader_matches_jax(shader, textures):
    """Every baseline shader through MeshRenderer (they always render
    staged): image and gradients to the vertices, the texture and the
    light location."""
    mesh, _cams, lights, renderer = staged_scene(shader, textures=textures)
    trend = convert.from_reference(renderer, device="cpu")
    assert trend.plan(convert.from_reference(mesh, device="cpu")).mode == \
        "staged"
    assert_staged_parity(renderer, mesh, lights, with_smoothing=False)


def test_meshrenderer_renders_baseline_shaders_staged():
    """MeshRenderer.__call__ and render_loss take the staged route for a
    baseline shader; render_loss reduces the render like the reference."""
    mesh, cams, lights, renderer = staged_scene("HardPhongShader")
    trend = convert.from_reference(renderer, device="cpu")
    tmesh = convert.from_reference(mesh, device="cpu")
    want = np.asarray(jax_exact(lambda m: renderer(m), mesh))
    got = trend(tmesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    target = torch.rand(2, 32, 32, 3, generator=torch.Generator()
                        .manual_seed(0))
    for kind, red in (("l2_rgb", lambda d: d * d), ("l1_rgb", torch.abs)):
        loss = trend.render_loss(tmesh, target, loss_kind=kind)
        torch.testing.assert_close(loss, red(got[..., :3] - target).mean())


def test_from_reference_round_trip_baseline_renderers():
    """A JAX HardPhongShader renderer and a SoftPhongShader renderer with
    non-default materials, light colours, blend parameters and settings
    (perspective correction, explicit faces_per_chunk) come across with
    from_reference and give the JAX image."""
    mesh, cams, _l, _r = staged_scene(textures="atlas4")
    lights = pt.PointLights.create(location=(1.0, 1.5, -2.5),
                                   ambient_color=(0.4, 0.3, 0.2),
                                   diffuse_color=(0.5, 0.6, 0.4),
                                   specular_color=(0.3, 0.2, 0.1))
    materials = pt.Materials.create(ambient_color=(0.9, 0.8, 0.7),
                                    specular_color=(0.5, 0.5, 0.5),
                                    shininess=20.0)
    blend = pt.BlendParams(sigma=3e-4, gamma=2e-3,
                           background_color=(0.2, 0.3, 0.4))
    settings = pt.RasterizationSettings(
        image_size=32, blur_radius=2e-4, faces_per_pixel=3,
        perspective_correct=True, faces_per_chunk=5, bin_size=0)
    for cls in (pt.HardPhongShader, pt.SoftPhongShader):
        renderer = pt.MeshRenderer.create(
            rasterizer=pt.MeshRasterizer.create(cameras=cams,
                                                raster_settings=settings),
            shader=cls.create(cameras=cams, lights=lights,
                              materials=materials, blend_params=blend))
        want = np.asarray(jax_exact(lambda m: renderer(m), mesh))
        trend = convert.from_reference(renderer, device="cpu")
        assert dataclasses.asdict(trend.rasterizer.raster_settings) == \
            dataclasses.asdict(settings)
        assert trend.shader.blend_params == tuple(blend)
        got = trend(convert.from_reference(mesh, device="cpu"))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
