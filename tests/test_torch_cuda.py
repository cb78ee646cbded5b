"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up.)  Without a
CUDA device every test here skips: a CUDA kernel has no CPU mode.
"""

import os

import numpy as np
import pytest
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch import checks
from pertrenderer_tpu_torch.checks import table_errors
from pertrenderer_tpu_torch.ops import fused_render as tfr

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "prng_goldens.npz")
MC_NOISES = ("gaussian", "gaussian_wovr", "cauchy")
NOISE_MENU = ("cauchy", "gaussian", "gaussian_wovr", "uniform", "hard",
              "softras")


def check_against_goldens(noise_type, got, ref):
    """Uniform: bit-exact.  Gaussian: 5e-4 absolute; cauchy: 1e-5 relative
    (the transcendentals round differently across libms)."""
    if noise_type == "uniform":
        np.testing.assert_array_equal(got, ref)
    elif noise_type == "gaussian":
        assert np.abs(got - ref).max() <= 5e-4
    else:
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)
        assert rel.max() <= 1e-5


def assert_kernel_close(got, want, mc: bool):
    """Deterministic pairs: atol 2e-5.  MC pairs: mean |d| <= 1e-5 and at
    least 99.9% of pixels within 1e-4 (ulp-level threshold flips)."""
    d = (got - want).abs()
    assert torch.isfinite(got).all()
    if not mc:
        assert d.max().item() <= 2e-5, d.max().item()
        return
    assert d.mean().item() <= 1e-5
    assert (d.amax(dim=-1) <= 1e-4).float().mean().item() >= 0.999


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _smoothers(noise, sigma, gamma, s):
    if noise == "cauchy":
        return (ptt.ArctanRast.create(sigma=sigma, nb_samples=s),
                ptt.CauchyAgg.create(gamma=gamma, nb_samples=s))
    if noise == "gaussian":
        return (ptt.GaussianRast.create(sigma=sigma, nb_samples=s),
                ptt.GaussianAgg.create(gamma=gamma, nb_samples=s))
    if noise == "gaussian_wovr":
        return (ptt.GaussianRast_wovr.create(sigma=sigma, nb_samples=s),
                ptt.GaussianAgg_wovr.create(gamma=gamma, nb_samples=s))
    if noise == "uniform":
        return ptt.AffineRast.create(sigma=sigma, nb_samples=s), \
            ptt.HardAgg.create()
    if noise == "hard":
        return ptt.HardRast.create(), ptt.HardAgg.create()
    return ptt.SoftRast.create(sigma=sigma), ptt.SoftAgg.create(gamma=gamma)


def scene_mesh(kind, device):
    """``cube`` (12 faces, x2), ``icosphere`` (level 3, 1280 faces, x2,
    per-vertex colours) or ``cow`` (``make_cow``: 5120 faces, UV atlas 4,
    centred and scaled to 3 / max |v|)."""
    if kind == "cube":
        return ptt.load_cube(device=device).scale_verts(2.0)
    if kind == "icosphere":
        verts, faces = ptt.make_icosphere(3)
        colours = torch.linspace(0.2, 1.0, verts.shape[0] * 3,
                                 device=device).reshape(1, -1, 3)
        return ptt.Meshes.create(2.0 * verts, faces, device=device,
                                 textures=ptt.TexturesVertex(colours))
    cow = ptt.make_cow(device=device)
    verts = cow.verts[0]
    center = verts.mean(0)
    scale = torch.max(torch.abs(verts - center))
    return cow.offset_verts(-center.expand_as(verts)).scale_verts(
        3.0 / scale)


def _renderer(noise, device, imsize=32, n=2, lights_kind="point",
              textures="uv", perspective_correct=False, mesh_kind="cube",
              sigma=1e-2, gamma=5e-1, s=4, k=50):
    mesh = scene_mesh(mesh_kind, device)
    if textures == "atlas4":
        g = torch.Generator().manual_seed(0)
        mesh = mesh.with_textures(ptt.TexturesAtlas(
            torch.rand(1, 12, 4, 4, 3, generator=g).to(device)))
    elif textures == "vertex":
        mesh = mesh.with_textures(ptt.TexturesVertex(torch.linspace(
            0.1, 1.0, 24, device=device).reshape(1, 8, 3)))
    mesh = mesh.extend(n)
    r, t = ptt.look_at_view_transform(
        dist=6.7, elev=torch.linspace(20.0, 40.0, n),
        azim=torch.linspace(100.0, 140.0, n), device=device)
    cams = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=device)
    if lights_kind == "point":
        lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0),
                                        device=device)
    else:
        lights = ptt.DirectionalLights.create(direction=(0.3, -1.0, 0.2),
                                              device=device)
    settings = ptt.RasterizationSettings(
        image_size=imsize, blur_radius=float(np.log(1 / 1e-4 - 1) * sigma),
        faces_per_pixel=k, perspective_correct=perspective_correct)
    sr, sa = _smoothers(noise, sigma, gamma, s)
    renderer = ptt.MeshRenderer(
        ptt.MeshRasterizer(cams, settings),
        ptt.RandomPhongShader.create(
            cameras=cams, lights=lights, smoothrast=sr, smoothagg=sa,
            blend_params=ptt.BlendParams(sigma, gamma, (0.0, 0.1, 0.2)),
            device=device))
    return mesh, renderer


def _inputs(mesh, renderer):
    sh, settings = renderer.shader, renderer.rasterizer.raster_settings
    cfg = tfr._plan(mesh, sh.lights, sh.smoothrast, sh.smoothagg, settings,
                    "phong")
    seeds = tfr.draw_seeds(mesh.batch_size, torch.Generator().manual_seed(5),
                           device=mesh.device)
    return cfg, tfr._prepare_inputs(cfg, mesh, sh.cameras, sh.lights,
                                    sh.materials, sh.smoothrast,
                                    sh.smoothagg, sh.blend_params, settings,
                                    seeds, "phong")


@pytest.mark.cuda
@pytest.mark.parametrize("noise_type", ["uniform", "gaussian", "cauchy"])
def test_prng_probe_kernel_matches_goldens_and_plain(noise_type,
                                                     cuda_device):
    before = tfr.launch_counts["prng_probe"]
    got = tfr.prng_probe(noise_type, device=cuda_device)
    torch.cuda.synchronize()
    assert tfr.launch_counts["prng_probe"] == before + 1
    check_against_goldens(noise_type, got.cpu().numpy(),
                          np.load(GOLDENS)[noise_type])
    plain = tfr.prng_probe_plain(noise_type, device=cuda_device)
    assert torch.allclose(got, plain, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("noise,kw", [(n, {}) for n in NOISE_MENU] + [
    ("softras", dict(lights_kind="directional")),
    ("gaussian", dict(textures="vertex")),
    ("uniform", dict(textures="atlas4", perspective_correct=True)),
])
def test_fused_forward_kernel_matches_plain(noise, kw, cuda_device):
    cfg, inputs = _inputs(*_renderer(noise, cuda_device, **kw))
    before = tfr.launch_counts["fused_forward"]
    got = tfr.fused_forward(cfg, *inputs)
    torch.cuda.synchronize()
    assert tfr.launch_counts["fused_forward"] == before + 1
    assert_kernel_close(got, tfr.forward_plain(cfg, *inputs),
                        noise in MC_NOISES)


@pytest.mark.cuda
def test_renderer_on_cuda_matches_cpu(cuda_device):
    """The public entry on the card launches K3 once and matches the same
    render on the CPU (plain version)."""
    seeds = tfr.draw_seeds(2, torch.Generator().manual_seed(7),
                           device="cpu")
    mesh, renderer = _renderer("gaussian", cuda_device)
    before = tfr.launch_counts["fused_forward"]
    got = renderer(mesh, seeds=seeds)
    torch.cuda.synchronize()
    assert tfr.launch_counts["fused_forward"] == before + 1
    mesh_c, renderer_c = _renderer("gaussian", "cpu")
    assert_kernel_close(got.cpu(), renderer_c(mesh_c, seeds=seeds), True)


def assert_tables_close(got, want, mc: bool):
    """Each gradient table, and each of the 34 scalar gradients, within 1e-3
    (MC: shared noise, threshold flips only) or 1e-4 (deterministic) of its
    own max |grad| (``table_errors``)."""
    tol = 1e-3 if mc else 1e-4
    errors = table_errors(got, want)
    assert all(e <= tol for _n, e in errors), errors


def _many_faces(mesh, renderer, copies=3):
    """The cube's faces repeated (copies x 12 + 4 faces, per-vertex
    colours): coincident faces tie in depth and distance, and F = 40
    takes the 64-slot kernels."""
    faces = torch.cat([mesh.faces[0]] * copies + [mesh.faces[0, :4]])
    cols = torch.linspace(0.1, 1.0, 24, device=mesh.device).reshape(1, 8, 3)
    many = ptt.Meshes.create(mesh.verts[0], faces,
                             textures=ptt.TexturesVertex(cols),
                             device=mesh.device).extend(mesh.batch_size)
    return many, renderer


GRAD_CASES = [(n, {}) for n in NOISE_MENU] + [
    ("uniform", dict(textures="atlas4", perspective_correct=True)),
    ("gaussian", dict(textures="atlas4")),
    ("cauchy", dict(textures="vertex", lights_kind="directional")),
    ("gaussian", dict(many_faces=True)),
    ("softras", dict(many_faces=True)),
]


def _grad_case(noise, device, kw):
    kw = dict(kw)
    many = kw.pop("many_faces", False)
    mesh, renderer = _renderer(noise, device, imsize=64, **kw)
    if many:
        mesh, renderer = _many_faces(mesh, renderer)
    return _inputs(mesh, renderer)


@pytest.mark.cuda
@pytest.mark.parametrize("noise,kw", GRAD_CASES)
def test_fused_backward_kernel_matches_plain(noise, kw, cuda_device):
    cfg, inputs = _grad_case(noise, cuda_device, kw)
    g_out = torch.randn(2, 64, 64, 4, generator=torch.Generator()
                        .manual_seed(1)).to(cuda_device)
    before = tfr.launch_counts["fused_backward"]
    got = tfr.fused_backward(cfg, *inputs, g_out)
    torch.cuda.synchronize()
    assert tfr.launch_counts["fused_backward"] == before + 1
    assert_tables_close(got, tfr.backward_plain(cfg, *inputs, g_out),
                        noise in MC_NOISES)


@pytest.mark.cuda
@pytest.mark.parametrize("noise,kw", GRAD_CASES)
def test_fused_loss_grad_kernel_matches_plain(noise, kw, cuda_device):
    cfg, inputs = _grad_case(noise, cuda_device, kw)
    target = torch.rand(2, 3, 64 * 64, generator=torch.Generator()
                        .manual_seed(2)).to(cuda_device)
    lscale = 1.0 / (2 * 64 * 64 * 3)
    before = tfr.launch_counts["fused_loss_grad"]
    loss, *got = tfr.fused_loss_grad(cfg, *inputs, target, "l2_rgb", lscale)
    torch.cuda.synchronize()
    assert tfr.launch_counts["fused_loss_grad"] == before + 1
    want_loss, *want = tfr.loss_grad_plain(cfg, *inputs, target, "l2_rgb",
                                           lscale)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    assert_tables_close(got, want, noise in MC_NOISES)


@pytest.mark.cuda
def test_render_loss_launches_k2_once(cuda_device):
    """render_loss launches K2 once; loss.backward() launches nothing
    else (its backward only scales K2's gradients)."""
    mesh, renderer = _renderer("gaussian", cuda_device, imsize=64)
    renderer(mesh)                          # the PRNG check (K1) once
    log_rot = torch.zeros(2, 3, device=cuda_device, requires_grad=True)
    posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                               .transform_points(mesh.verts))
    before = dict(tfr.launch_counts)
    loss = renderer.render_loss(posed, torch.zeros(64, 64, 3,
                                                   device=cuda_device))
    loss.backward()
    torch.cuda.synchronize()
    after = dict(tfr.launch_counts)
    assert {k: after[k] - before[k] for k in after} == {
        "prng_probe": 0, "fused_forward": 0, "fused_backward": 0,
        "fused_loss_grad": 1, "fused_stream_forward": 0,
        "fused_stream_backward": 0, "fused_stream_loss_grad": 0}
    assert torch.isfinite(log_rot.grad).all()
    assert log_rot.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("noise", ["gaussian_wovr", "softras"])
def test_flat_kernels_take_background_only_on_inactive_tiles(noise,
                                                            cuda_device):
    """The cube moved up in a 64^2 image (two 2048-pixel strips): the
    lower strip is inactive.  K3, K4 and K2 equal their plain versions,
    which give that tile JAX's bg_only image and gradient."""
    mesh, renderer = _renderer(noise, cuda_device, imsize=64, sigma=1e-3)
    mesh = mesh.offset_verts(torch.tensor([0.0, 2.5, 0.0],
                                          device=cuda_device).expand(8, 3))
    cfg, inputs = _inputs(mesh, renderer)
    assert inputs[7].tolist() == [[1, 0], [1, 0]]
    mc = noise in MC_NOISES
    assert_kernel_close(tfr.fused_forward(cfg, *inputs),
                        tfr.forward_plain(cfg, *inputs), mc)
    g_out = torch.randn(2, 64, 64, 4, generator=torch.Generator()
                        .manual_seed(1)).to(cuda_device)
    assert_tables_close(tfr.fused_backward(cfg, *inputs, g_out),
                        tfr.backward_plain(cfg, *inputs, g_out), mc)
    target = torch.rand(2, 3, 64 * 64, generator=torch.Generator()
                        .manual_seed(2)).to(cuda_device)
    got = tfr.fused_loss_grad(cfg, *inputs, target, "l2_rgb", 1e-4)
    want = tfr.loss_grad_plain(cfg, *inputs, target, "l2_rgb", 1e-4)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    assert_tables_close(got[1:], want[1:], mc)


# The stream route (K5, K6, K7) at the config-3 settings (sigma 1e-3,
# gamma 1e-2).  The gradients are held against the plain version in
# float32 and in float64 (``checks.stream_grads_close``): each row and
# each scalar within the tolerances above of either, and the rows of faces
# too thin for float32 to resolve them (height under 2e-6 / tolerance of
# the longest edge, seen nearly edge-on at the silhouette) within 2e-6 /
# (height / edge) of the table max.
STREAM_SCENES = {"icosphere": (64, 2), "cow": (128, 1)}


def _stream_case(noise, kind, device):
    size, n = STREAM_SCENES[kind]
    mesh, renderer = _renderer(noise, device, imsize=size, n=n,
                               mesh_kind=kind, sigma=1e-3, gamma=1e-2, s=4)
    cfg, (tab, scal, rows, count, active, seeds) = _inputs(mesh, renderer)
    assert cfg.stream
    return cfg, (tab, rows, count, active, scal, seeds), size, n


def assert_stream_grads_close(cfg, tab, got, want, want64, mc: bool):
    """``checks.stream_grads_close`` at the MC or deterministic
    tolerance."""
    ok, err, where, _n, bins = checks.stream_grads_close(
        cfg, tab, got, want, want64, 1e-3 if mc else 1e-4)
    assert ok, (err, where, checks.witness_text(bins))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(STREAM_SCENES))
@pytest.mark.parametrize("noise", NOISE_MENU)
def test_stream_forward_kernel_matches_plain(noise, kind, cuda_device):
    cfg, args, _size, _n = _stream_case(noise, kind, cuda_device)
    before = tfr.launch_counts["fused_stream_forward"]
    got = tfr.fused_stream_forward(cfg, *args)
    again = tfr.fused_stream_forward(cfg, *args)
    torch.cuda.synchronize()
    assert tfr.launch_counts["fused_stream_forward"] == before + 2
    assert torch.equal(got, again)
    assert_kernel_close(got, tfr.stream_forward_plain(cfg, *args),
                        noise in MC_NOISES)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(STREAM_SCENES))
@pytest.mark.parametrize("noise", NOISE_MENU)
def test_stream_gradient_kernels_match_plain(noise, kind, cuda_device):
    """K6 and K7 against their plain versions in float32 and float64 (see
    above), repeated launches bit-equal, and K7 equal to K5's image under
    the L2 loss fed through K6 (tables and scalars within 1e-5 of their
    max: the same kernels' arithmetic on both sides)."""
    cfg, args, size, n = _stream_case(noise, kind, cuda_device)
    mc = noise in MC_NOISES
    g_out = torch.randn(n, size, size, 4, generator=torch.Generator()
                        .manual_seed(1)).to(cuda_device)
    before = dict(tfr.launch_counts)
    got = tfr.fused_stream_backward(cfg, *args, g_out)
    again = tfr.fused_stream_backward(cfg, *args, g_out)
    target = torch.rand(n, 3, size * size, generator=torch.Generator()
                        .manual_seed(2)).to(cuda_device)
    lscale = 1.0 / (n * size * size * 3)
    loss, *lg = tfr.fused_stream_loss_grad(cfg, *args, target, "l2_rgb",
                                           lscale)
    torch.cuda.synchronize()
    assert tfr.launch_counts["fused_stream_backward"] == (
        before["fused_stream_backward"] + 2)
    assert tfr.launch_counts["fused_stream_loss_grad"] == (
        before["fused_stream_loss_grad"] + 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(t).all()) for t in list(got) + lg)
    args64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    want = tfr.stream_backward_plain(cfg, *args, g_out)
    want64 = tfr.stream_backward_plain(cfg, *args64, g_out.double())
    assert_stream_grads_close(cfg, args[0], got, want, want64, mc)
    w_loss, *want = tfr.stream_loss_grad_plain(cfg, *args, target, "l2_rgb",
                                               lscale)
    _l64, *want64 = tfr.stream_loss_grad_plain(cfg, *args64, target.double(),
                                               "l2_rgb", lscale)
    torch.testing.assert_close(loss, w_loss, rtol=1e-5, atol=0)
    assert_stream_grads_close(cfg, args[0], lg, want, want64, mc)
    img = tfr.fused_stream_forward(cfg, *args)
    d = img[..., :3].reshape(n, -1, 3).transpose(1, 2) - target
    g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(n, size, size, 3)
    g_l2 = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
    dual = tfr.fused_stream_backward(cfg, *args, g_l2.contiguous())
    torch.testing.assert_close(loss, torch.sum(d * d, dim=(1, 2)) * lscale,
                               rtol=1e-5, atol=0)
    errors = table_errors(checks.split_stream(cfg, *lg),
                          checks.split_stream(cfg, *dual))
    assert all(e <= 1e-5 for _n, e in errors), errors


@pytest.mark.cuda
def test_stream_route_through_meshrenderer(cuda_device):
    """The cow at 128^2, N=2, through the public entries: the render
    launches K5 once, its backward K6 once, render_loss K7 once (and its
    backward nothing); the pose gradients are finite and nonzero."""
    mesh, renderer = _renderer("gaussian", cuda_device, imsize=128,
                               mesh_kind="cow", sigma=1e-3, gamma=1e-2)
    assert renderer.plan(mesh).mode == "stream"
    renderer(mesh)                          # the PRNG check (K1) once
    log_rot = torch.zeros(2, 3, device=cuda_device, requires_grad=True)
    posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                               .transform_points(mesh.verts))
    before = dict(tfr.launch_counts)
    img = renderer(posed)
    (g_img,) = torch.autograd.grad(img[..., :3].mean(), [log_rot])
    posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                               .transform_points(mesh.verts))
    loss = renderer.render_loss(posed, torch.zeros(128, 128, 3,
                                                   device=cuda_device))
    (g_loss,) = torch.autograd.grad(loss, [log_rot])
    torch.cuda.synchronize()
    after = dict(tfr.launch_counts)
    assert {k: after[k] - before[k] for k in after} == {
        "prng_probe": 0, "fused_forward": 0, "fused_backward": 0,
        "fused_loss_grad": 0, "fused_stream_forward": 1,
        "fused_stream_backward": 1, "fused_stream_loss_grad": 1}
    for g in (g_img, g_loss):
        assert torch.isfinite(g).all() and g.abs().max() > 0
