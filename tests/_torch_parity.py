"""Shared scene set-up for the PyTorch-port parity tests.

Each helper makes the scene in the JAX package; ``pertrenderer_tpu_torch.
convert.from_reference`` carries it across, so both packages render the
same scene.  The JAX fused forward runs in interpret mode with tile packing
off, which keys the MC noise the way the port does.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

import pertrenderer_tpu as pt
from pertrenderer_tpu.experiments.harness import make_smoothers
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch.ops import fused_render as tfr

KEY = jax.random.PRNGKey(3)
MC_NOISES = ("gaussian", "gaussian_wovr", "cauchy")


def interpret_env(monkeypatch):
    monkeypatch.setenv("PERTRENDERER_FUSED", "interpret")
    monkeypatch.setenv("PERTRENDERER_PACK", "off")


def build(noise="softras", imsize=16, k=16, s=4, shade="phong",
          textures="uv", lights_kind="point", perspective_correct=False,
          cull=False, n_views=1, sigma=1e-2, gamma=5e-1, faces16=False):
    """(mesh, cameras, lights, renderer) of the JAX package: the cube x2
    seen from ``n_views`` poses.  ``faces16`` repeats four of its faces, so
    that F = f_pad = 16 and the background row is appended below the slots
    instead of compacted into a dead one."""
    mesh = pt.load_cube().scale_verts(2.0)
    if faces16:
        faces = jnp.concatenate([mesh.faces[0], mesh.faces[0, :4]])
        mesh = pt.Meshes.create(mesh.verts[0], faces)
    if textures == "vertex":
        mesh = mesh.with_textures(pt.TexturesVertex(
            jnp.linspace(0.1, 1.0, mesh.max_verts * 3).reshape(
                1, mesh.max_verts, 3)))
    elif textures == "atlas4":
        rng = np.random.default_rng(0)
        mesh = mesh.with_textures(pt.TexturesAtlas(jnp.asarray(
            rng.uniform(0.0, 1.0, (1, mesh.max_faces, 4, 4, 3)),
            jnp.float32)))
    if n_views > 1:
        mesh = mesh.extend(n_views)
    r, t = pt.look_at_view_transform(
        dist=6.7, elev=jnp.linspace(20.0, 40.0, n_views),
        azim=jnp.linspace(100.0, 140.0, n_views))
    cameras = pt.PerspectiveCameras.create(R=r, T=t, fov=60.0)
    if lights_kind == "point":
        lights = pt.PointLights.create(location=(0.0, 2.0, -2.0))
    else:
        lights = pt.DirectionalLights.create(direction=(0.3, -1.0, 0.2))
    blur = float(np.log(1.0 / 1e-4 - 1.0) * sigma)
    settings = pt.RasterizationSettings(
        image_size=imsize, blur_radius=blur, faces_per_pixel=k,
        perspective_correct=perspective_correct, cull_backfaces=cull)
    sr, sa = make_smoothers(noise, sigma, gamma, 1.0, s)
    cls = pt.RandomPhongShader if shade == "phong" else pt.RandomSimpleShader
    renderer = pt.MeshRenderer.create(
        rasterizer=pt.MeshRasterizer.create(cameras=cameras,
                                            raster_settings=settings),
        shader=cls.create(
            cameras=cameras, lights=lights,
            blend_params=pt.BlendParams(sigma=sigma, gamma=gamma,
                                        background_color=(0.0, 0.1, 0.2)),
            smoothrast=sr, smoothagg=sa))
    return mesh, cameras, lights, renderer


def jax_inputs(mesh, renderer, key=KEY):
    """(JAX FusedConfig, JAX kernel inputs) of a render."""
    sh = renderer.shader
    settings = renderer.rasterizer.raster_settings
    shade = "phong" if type(sh).__name__ == "RandomPhongShader" else "none"
    cfg = jfr._plan(mesh, sh.cameras, sh.lights, sh.materials,
                    sh.smoothrast, sh.smoothagg, settings, shade)
    inputs = jfr._prepare_inputs(cfg, mesh, sh.cameras, sh.lights,
                                 sh.materials, sh.smoothrast, sh.smoothagg,
                                 sh.blend_params, settings, key, shade)
    return cfg, inputs


def port_config(jcfg):
    """The port's FusedConfig with the JAX config's shared fields."""
    import dataclasses

    names = [f.name for f in dataclasses.fields(tfr.FusedConfig)]
    return tfr.FusedConfig(**{n: getattr(jcfg, n) for n in names})


def port_inputs(inputs):
    """JAX kernel inputs -> the port's layout (valid (N, F), scal (N, 34),
    seeds (N, 4))."""
    fv_ndc, fv_world, fn, tex, valid, scal, seeds = (np.asarray(x)
                                                     for x in inputs)
    t = lambda x: torch.from_numpy(np.array(x))
    return (t(fv_ndc), t(fv_world), t(fn), t(tex), t(valid[..., 0]),
            t(scal[:, 0]), t(seeds[:, 0, :4]))


def assert_image_close(a, b, mc: bool):
    """Deterministic pairs: atol 2e-5.  MC pairs share the noise, so they
    differ only by ulp-level threshold flips: mean |d| <= 1e-5 and at least
    99.9% of pixels within 1e-4."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    if not mc:
        np.testing.assert_allclose(a, b, atol=2e-5)
        return
    d = np.abs(a - b)
    assert d.mean() <= 1e-5, d.mean()
    assert np.mean(d.max(axis=-1) <= 1e-4) >= 0.999, d.max()
