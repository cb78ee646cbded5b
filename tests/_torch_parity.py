"""Shared scene set-up for the PyTorch-port parity tests.

Each helper makes the scene in the JAX package; ``pertrenderer_tpu_torch.
convert.from_reference`` carries it across, so both packages render the
same scene.  The JAX fused forward runs in interpret mode with tile packing
off, which keys the MC noise the way the port does.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import pertrenderer_tpu as pt
from pertrenderer_tpu.experiments.harness import make_smoothers
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch import convert
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


def _rotation(seed):
    """A fixed rotation matrix (float32) from a seeded unit quaternion."""
    q = np.random.default_rng(seed).standard_normal(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]],
        np.float32)


STAGED_SHADERS = ("RandomPhongShader", "RandomSimpleShader",
                  "HardPhongShader", "SoftPhongShader", "SimpleShader",
                  "SoftSimpleShader", "SoftSilhouetteShader")


def staged_scene(shader="RandomPhongShader", noise="softras",
                 mesh_kind="cube", textures="uv", n=2, imsize=32, k=4,
                 sigma=1e-2, gamma=5e-1, bin_size=None, same_pose=False,
                 nb_samples=4):
    """(mesh, cameras, lights, renderer) of the JAX package for the staged
    route, seen so that both packages project every vertex to the same
    bits: the mesh (``scene_mesh``) is turned to ``n`` fixed poses as data
    (numpy float32) and the camera looks down the z axis (elev = azim = 0,
    fov 50, rotation entries 0 and +-1).  ``textures``: ``uv`` (the
    cube's, sampled through its one-texel atlas on the channel-major
    path), ``uv_map`` (the same map with no atlas: bilinear fetches),
    ``vertex`` or ``atlas4``.  ``same_pose`` gives every batch element the
    first pose (replicas of one render); ``nb_samples`` is the MC
    estimators' S."""
    base = scene_mesh(mesh_kind)
    v = np.asarray(base.verts[0])
    verts = np.stack([v @ _rotation(1 if same_pose else i + 1)
                      for i in range(n)])
    tex = base.textures
    nv, nf = base.max_verts, base.max_faces
    if textures == "uv_map":
        tex = tex.replace(atlas_size=0)
    elif textures == "vertex":
        tex = pt.TexturesVertex(jnp.linspace(0.1, 1.0, nv * 3).reshape(
            1, nv, 3))
    elif textures == "atlas4":
        tex = pt.TexturesAtlas(jnp.asarray(np.random.default_rng(0).uniform(
            0.0, 1.0, (1, nf, 4, 4, 3)), jnp.float32))
    mesh = pt.Meshes(verts=jnp.asarray(verts),
                     faces=jnp.repeat(base.faces, n, 0),
                     num_verts=jnp.repeat(base.num_verts, n),
                     num_faces=jnp.repeat(base.num_faces, n),
                     textures=tex.extend(n))
    r, t = pt.look_at_view_transform(dist=6.7, elev=0.0, azim=0.0)
    cameras = pt.PerspectiveCameras.create(R=jnp.repeat(r, n, 0),
                                           T=jnp.repeat(t, n, 0), fov=50.0)
    lights = pt.PointLights.create(location=(0.0, 2.0, -2.0))
    settings = pt.RasterizationSettings(
        image_size=imsize, blur_radius=float(np.log(1.0 / 1e-4 - 1.0) * sigma),
        faces_per_pixel=k, bin_size=bin_size)
    blend = pt.BlendParams(sigma=sigma, gamma=gamma,
                           background_color=(0.0, 0.1, 0.2))
    cls = getattr(pt, shader)
    if shader in ("RandomPhongShader", "RandomSimpleShader"):
        sr, sa = make_smoothers(noise, sigma, gamma, 1.0, nb_samples)
        sh = cls.create(cameras=cameras, lights=lights, blend_params=blend,
                        smoothrast=sr, smoothagg=sa)
    elif shader in ("HardPhongShader", "SoftPhongShader"):
        sh = cls.create(cameras=cameras, lights=lights, blend_params=blend)
    else:
        sh = cls.create(blend_params=blend)
    renderer = pt.MeshRenderer.create(
        rasterizer=pt.MeshRasterizer.create(cameras=cameras,
                                            raster_settings=settings),
        shader=sh)
    return mesh, cameras, lights, renderer


def jax_exact(fn, *args):
    """``fn(*args)`` jitted at XLA backend optimisation level 0.  The CPU
    backend otherwise contracts a * b + c into fused multiply-adds, which
    neither the port's plain versions nor its kernels (-fmad=false) do;
    faces seen nearly edge-on amplify that difference past 1e-6.  At level
    0 each operation rounds on its own, as in the port."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def jax_staged(renderer, mesh, **kwargs):
    """The JAX package's staged route: rasterize, then shade (planar
    fragments for the perturbed shaders), whatever the fused planner
    would say."""
    cameras = kwargs.get("cameras", renderer.rasterizer.cameras)
    if getattr(type(renderer.shader), "planar_input", False):
        fragments = renderer.rasterizer.planar(mesh, cameras=cameras)
    else:
        fragments = renderer.rasterizer(mesh, cameras=cameras)
    return renderer.shader(fragments, mesh, **kwargs)


# ---------------------------------------------------------------------------
# Staged-route parity: images and gradients of both packages
# ---------------------------------------------------------------------------

TEX_FIELD = {"TexturesUV": "maps", "TexturesVertex": "verts_features",
             "TexturesAtlas": "atlas"}
LIT = ("RandomPhongShader", "HardPhongShader", "SoftPhongShader")


def port_staged(renderer, mesh, **kwargs):
    """The port's staged route through its public parts."""
    cameras = kwargs.get("cameras", renderer.rasterizer.cameras)
    if getattr(type(renderer.shader), "planar_input", False):
        fragments = renderer.rasterizer.planar(mesh, cameras=cameras)
    else:
        fragments = renderer.rasterizer(mesh, cameras=cameras)
    return renderer.shader(fragments, mesh, **kwargs)


def _leaf_names(renderer, with_smoothing):
    names = ["verts", "tex"]
    if type(renderer.shader).__name__ in LIT:
        names.append("light")
    if with_smoothing:
        sr, sa = renderer.shader.smoothrast, renderer.shader.smoothagg
        if type(sr).__name__ in ("SoftRast", "AffineRast"):
            names.append("sigma")
        if type(sa).__name__ == "SoftAgg":
            names.append("gamma")
    return names


def jax_value_and_grads(renderer, mesh, lights, w, names):
    """(image, {leaf: gradient}) of sum(image * w) through the JAX
    package's staged route (``jax_exact``)."""
    sh = renderer.shader
    tex = mesh.textures
    field = TEX_FIELD[type(tex).__name__]
    leaves = {"verts": mesh.verts, "tex": getattr(tex, field),
              "light": lights.location}
    if "sigma" in names:
        leaves["sigma"] = sh.smoothrast.sigma
    if "gamma" in names:
        leaves["gamma"] = sh.smoothagg.gamma
    leaves = {k: leaves[k] for k in names}

    def render(p):
        m = mesh.replace(verts=p["verts"],
                         textures=tex.replace(**{field: p["tex"]}))
        shader = sh
        if "sigma" in p:
            shader = shader.replace(
                smoothrast=shader.smoothrast.replace(sigma=p["sigma"]))
        if "gamma" in p:
            shader = shader.replace(
                smoothagg=shader.smoothagg.replace(gamma=p["gamma"]))
        kw = {"cameras": renderer.rasterizer.cameras}
        if "light" in p:
            kw["lights"] = lights.replace(location=p["light"])
        return jax_staged(renderer.replace(shader=shader), m, **kw)

    def loss(p):
        img = render(p)
        return jnp.sum(img * w), img

    (_, img), grads = jax_exact(jax.value_and_grad(loss, has_aux=True),
                                leaves)
    return np.asarray(img), {k: np.asarray(v) for k, v in grads.items()}


def port_value_and_grads(renderer, mesh, lights, w, names):
    """(image, {leaf: gradient}) of sum(image * w) through the port's
    staged route (plain versions on the CPU)."""
    trend = convert.from_reference(renderer, device="cpu")
    tmesh = convert.from_reference(mesh, device="cpu")
    tlights = convert.from_reference(lights, device="cpu")
    tex = tmesh.textures
    field = TEX_FIELD[type(tex).__name__]
    sh = trend.shader
    leaves = {"verts": tmesh.verts, "tex": getattr(tex, field),
              "light": tlights.location}
    if "sigma" in names:
        leaves["sigma"] = sh.smoothrast.sigma
    if "gamma" in names:
        leaves["gamma"] = sh.smoothagg.gamma
    leaves = {k: leaves[k].detach().clone().requires_grad_() for k in names}
    m = dataclasses.replace(tmesh, verts=leaves["verts"],
                            textures=dataclasses.replace(
                                tex, **{field: leaves["tex"]}))
    if "sigma" in leaves:
        sh = dataclasses.replace(sh, smoothrast=dataclasses.replace(
            sh.smoothrast, sigma=leaves["sigma"]))
    if "gamma" in leaves:
        sh = dataclasses.replace(sh, smoothagg=dataclasses.replace(
            sh.smoothagg, gamma=leaves["gamma"]))
    kw = {"cameras": trend.rasterizer.cameras}
    if "light" in leaves:
        kw["lights"] = dataclasses.replace(tlights,
                                           location=leaves["light"])
    img = port_staged(trend.replace(shader=sh), m, **kw)
    grads = torch.autograd.grad(torch.sum(img * torch.from_numpy(w)),
                                list(leaves.values()), allow_unused=True)
    return img.detach().numpy(), {
        k: (np.zeros(leaves[k].shape, np.float32) if g is None
            else g.numpy()) for k, g in zip(leaves, grads)}


def assert_staged_parity(renderer, mesh, lights, with_smoothing=True):
    """Image atol 2e-5; each gradient within 1e-4 of its max |grad|."""
    names = _leaf_names(renderer, with_smoothing)
    n, s = mesh.batch_size, renderer.rasterizer.raster_settings.image_size
    w = np.random.default_rng(7).standard_normal((n, s, s, 4)).astype(
        np.float32)
    jimg, jgrads = jax_value_and_grads(renderer, mesh, lights, w, names)
    timg, tgrads = port_value_and_grads(renderer, mesh, lights, w, names)
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=2e-5)
    assert (jimg[..., 3] > 0.5).sum() > 50          # the mesh is in view
    for k in names:
        scale = max(np.abs(jgrads[k]).max(), 1e-30)
        err = np.abs(tgrads[k] - jgrads[k]).max() / scale
        assert np.isfinite(tgrads[k]).all() and err <= 1e-4, (k, err)


