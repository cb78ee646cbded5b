"""Shared scene set-up for the PyTorch-port parity tests.

Each helper makes the scene in the JAX package; ``pertrenderer_tpu_torch.
convert.from_reference`` carries it across, so both packages render the
same scene.  The JAX fused forward runs in interpret mode with tile packing
off, which keys the MC noise the way the port does.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pertrenderer_tpu as pt
from pertrenderer_tpu.experiments.harness import make_smoothers
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch.ops import fused_render as tfr

KEY = jax.random.PRNGKey(3)
MC_NOISES = ("gaussian", "gaussian_wovr", "cauchy")


@pytest.fixture(scope="module", autouse=False)
def one_torch_thread():
    """One intra-op torch thread for a module: the stream route's plain
    sweeps are many small ops, which slow down by orders of magnitude
    when every test worker runs a full thread pool on a shared machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def interpret_env(monkeypatch):
    monkeypatch.setenv("PERTRENDERER_FUSED", "interpret")
    monkeypatch.setenv("PERTRENDERER_PACK", "off")


def scene_mesh(kind):
    """A JAX test mesh: ``cube`` (12 faces, x2), ``icosphere`` (level 3,
    1280 faces, x2, per-vertex colours) or ``cow`` (``make_cow``: 5120
    faces, UV atlas 4, centred and scaled to 3 / max |v| as
    tools/run_config3.py does)."""
    if kind == "cube":
        return pt.load_cube().scale_verts(2.0)
    if kind == "icosphere":
        from pertrenderer_tpu.io import make_icosphere

        verts, faces = make_icosphere(3)
        return pt.Meshes.create(2.0 * verts, faces,
                                textures=pt.TexturesVertex(jnp.linspace(
                                    0.2, 1.0, verts.shape[0] * 3).reshape(
                                        1, verts.shape[0], 3)))
    cow = pt.make_cow()
    verts = cow.verts[0]
    center = verts.mean(0)
    scale = jnp.max(jnp.abs(verts - center))
    return cow.offset_verts(-jnp.broadcast_to(center, verts.shape)) \
        .scale_verts(3.0 / scale)


def build(noise="softras", imsize=16, k=16, s=4, shade="phong",
          textures="uv", lights_kind="point", perspective_correct=False,
          cull=False, n_views=1, sigma=1e-2, gamma=5e-1, faces16=False,
          mesh_kind="cube", shift=None):
    """(mesh, cameras, lights, renderer) of the JAX package: the cube x2
    (or another ``scene_mesh``) seen from ``n_views`` poses.  ``faces16``
    repeats four of the cube's faces, so that F = f_pad = 16 and the
    background row is appended below the slots instead of compacted into a
    dead one.  ``shift`` moves the mesh by a world-space offset."""
    mesh = scene_mesh(mesh_kind)
    if shift is not None:
        mesh = mesh.offset_verts(jnp.broadcast_to(
            jnp.asarray(shift, jnp.float32), mesh.verts.shape[1:]))
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


def port_inputs(jcfg, inputs):
    """JAX flat kernel inputs -> the port's layout (valid (N, F), scal
    (N, 34), seeds (N, 4)), followed by the JAX package's activity bits
    of the tiles (N, nt)."""
    active = jax.vmap(lambda v, va, s: jfr._active_tiles(
        jcfg, v, va, s[0, jfr._S_BLUR]))(inputs[0], inputs[4], inputs[5])
    fv_ndc, fv_world, fn, tex, valid, scal, seeds = (np.asarray(x)
                                                     for x in inputs)
    t = lambda x: torch.from_numpy(np.array(x))
    return (t(fv_ndc), t(fv_world), t(fn), t(tex), t(valid[..., 0]),
            t(scal[:, 0]), t(seeds[:, 0, :4]),
            t(np.asarray(active).reshape(fv_ndc.shape[0], -1)))


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


def port_stream_inputs(jcfg, inputs):
    """JAX stream kernel inputs (tab, scal, rows, n, active, seeds) -> the
    port's argument order of the stream kernels (tab with its first
    round_up(d + 1, 4) columns, rows, count, active, scal (N, 34), seeds
    (N, 4))."""
    tab, scal, rows, count, active, seeds = (np.asarray(x) for x in inputs)
    n, nt = tab.shape[0], rows.shape[1]
    dt = -(-(28 + jcfg.tex_d) // 4) * 4
    t = lambda x: torch.from_numpy(np.array(x))
    return (t(tab[:, :, :dt]), t(rows.reshape(n, nt, -1)),
            t(count.reshape(n, nt)), t(active.reshape(n, nt)),
            t(scal[:, 0]), t(seeds[:, 0, :4]))


def _image_cm(jcfg, x):
    """(N, H, W, C) -> the JAX kernels' tile-major (N, C, nt * p_tile)."""
    n, s, c = x.shape[0], jcfg.image_size, x.shape[-1]
    cm = jnp.moveaxis(jnp.asarray(x).reshape(n, s * s, c), -1, 1)
    cm = jax.vmap(lambda a: jfr._to_tilemajor(jcfg, a))(cm)
    return jnp.pad(cm, ((0, 0), (0, 0),
                        (0, jfr._n_tiles(jcfg) * jcfg.p_tile - s * s)))


def jax_stream_forward(jcfg, inputs):
    """JAX ``_pallas_stream_forward`` per batch element: (N, H, W, 4)."""
    tab, scal, rows, count, active, seeds = inputs
    s = jcfg.image_size
    outs = []
    for b in range(tab.shape[0]):
        o = jfr._pallas_stream_forward(jcfg, tab[b], rows[b], count[b],
                                       active[b], scal[b], seeds[b])
        outs.append(np.asarray(jfr._from_tilemajor(jcfg, o))[:, :s * s])
    return np.moveaxis(np.stack(outs).reshape(-1, 4, s, s), 1, -1)


def jax_stream_grads(jcfg, inputs, g_out=None, target=None, loss_kind=None,
                     lscale=0.0):
    """JAX ``_pallas_stream_backward`` (``g_out`` (N, H, W, 4)) or
    ``_pallas_stream_loss_grad`` (``target`` (N, H, W, 3)) per batch
    element: (loss (N,), g_tab (N, rw, dt), g_scal (N, 34)) with dt as in
    :func:`port_stream_inputs`."""
    tab, scal, rows, count, active, seeds = inputs
    dt = -(-(28 + jcfg.tex_d) // 4) * 4
    extra = _image_cm(jcfg, g_out if target is None else target)
    losses, g_tabs, g_scals = [], [], []
    for b in range(tab.shape[0]):
        args = (tab[b], rows[b], count[b], active[b], scal[b], seeds[b])
        if target is None:
            g_tab, g_scal = jfr._pallas_stream_backward(jcfg, *args,
                                                        extra[b])
            loss = 0.0
        else:
            loss, g_tab, g_scal = jfr._pallas_stream_loss_grad(
                jcfg, loss_kind, *args, extra[b],
                jnp.full((1, 1), lscale, jnp.float32))
            loss = float(loss[0, 0])
        losses.append(loss)
        g_tabs.append(np.asarray(g_tab)[:, :dt])
        g_scals.append(np.asarray(g_scal)[0])
    return np.array(losses, np.float32), np.stack(g_tabs), np.stack(g_scals)
