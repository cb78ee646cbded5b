"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up.)  Without a
CUDA device every test here skips: a CUDA kernel has no CPU mode.
"""

import dataclasses
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
    cfg, _why = tfr._plan(mesh, sh.lights, sh.smoothrast, sh.smoothagg,
                          settings, "phong")
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
        "fused_stream_backward": 0, "fused_stream_loss_grad": 0,
        "fused_binned_forward": 0, "fused_binned_backward": 0,
        "fused_binned_loss_grad": 0, "fused_forward_ext": 0,
        "sharded_prob": 0, "sharded_agg_bwd": 0, "sharded_det_bwd": 0}
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


def _stream_case(noise, kind, device, s=4):
    size, n = STREAM_SCENES[kind]
    mesh, renderer = _renderer(noise, device, imsize=size, n=n,
                               mesh_kind=kind, sigma=1e-3, gamma=1e-2, s=s)
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
    check_stream_forward(cfg, args, noise in MC_NOISES)


def check_stream_forward(cfg, args, mc):
    before = tfr.launch_counts["fused_stream_forward"]
    got = tfr.fused_stream_forward(cfg, *args)
    again = tfr.fused_stream_forward(cfg, *args)
    torch.cuda.synchronize()
    assert tfr.launch_counts["fused_stream_forward"] == before + 2
    assert torch.equal(got, again)
    assert_kernel_close(got, tfr.stream_forward_plain(cfg, *args), mc)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(STREAM_SCENES))
@pytest.mark.parametrize("noise", NOISE_MENU)
def test_stream_gradient_kernels_match_plain(noise, kind, cuda_device):
    """K6 and K7 against their plain versions in float32 and float64 (see
    above), repeated launches bit-equal, and K7 equal to K5's image under
    the L2 loss fed through K6 (tables and scalars within 1e-5 of their
    max: the same kernels' arithmetic on both sides)."""
    cfg, args, size, n = _stream_case(noise, kind, cuda_device)
    check_stream_grads(cfg, args, size, n, noise in MC_NOISES, cuda_device)


def check_stream_grads(cfg, args, size, n, mc, cuda_device):
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
@pytest.mark.parametrize("noise", ["gaussian", "cauchy"])
def test_stream_kernels_at_128_samples_match_plain(noise, cuda_device):
    """Above 64 aggregation samples (S = 128: two passes of K5 and of B1
    over the chunk list) on the icosphere at 64^2, N=2: K5, K6 and K7 as
    the two tests above hold them, repeats bit-equal and K7 = K5 + K6."""
    cfg, args, size, n = _stream_case(noise, "icosphere", cuda_device,
                                      s=128)
    assert cfg.s_agg == 128
    check_stream_forward(cfg, args, True)
    check_stream_grads(cfg, args, size, n, True, cuda_device)


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
        "fused_stream_backward": 1, "fused_stream_loss_grad": 1,
        "fused_binned_forward": 0, "fused_binned_backward": 0,
        "fused_binned_loss_grad": 0, "fused_forward_ext": 0,
        "sharded_prob": 0, "sharded_agg_bwd": 0, "sharded_det_bwd": 0}
    for g in (g_img, g_loss):
        assert torch.isfinite(g).all() and g.abs().max() > 0


# ---------------------------------------------------------------------------
# The binned route's K12 (ops/binned.py): the icosphere at 64^2 with the
# route's tile shrunk to 32 pixels and its face threshold to 512, M = 32
# ---------------------------------------------------------------------------

BINNED_NOISES = ("gaussian", "cauchy", "softras", "hard")


def _binned_case(noise, device, monkeypatch, n=2):
    import dataclasses

    monkeypatch.setattr(tfr, "_COARSE_THRESHOLD", 512)
    monkeypatch.setattr(tfr, "_BIN_P_TILE", 32)
    mesh, renderer = _renderer(noise, device, imsize=64, n=n,
                               mesh_kind="icosphere", sigma=1e-2,
                               gamma=5e-2, s=2)
    renderer.rasterizer.raster_settings = dataclasses.replace(
        renderer.rasterizer.raster_settings, bin_overflow="allow",
        max_faces_per_bin=32)
    cfg, args = _inputs(mesh, renderer)
    assert cfg.binned and cfg.f_pad == 32 and cfg.p_tile == 32
    return cfg, args, mesh, renderer


@pytest.mark.cuda
@pytest.mark.parametrize("noise", BINNED_NOISES)
def test_binned_kernels_match_plain(noise, cuda_device, monkeypatch):
    """K12's forward, backward and loss-and-grad against their plain
    versions (forward as the flat kernels; gradients by
    ``checks.binned_grads_close`` against the float32 or float64 plain
    version, thin faces' rows by L / h), repeated launches bit-equal, and
    the loss-and-grad equal to the forward's L2 cotangent fed through the
    backward (tables and scalars within 1e-5 of their max)."""
    from pertrenderer_tpu_torch.ops import binned as tbin

    cfg, args, _mesh, _r = _binned_case(noise, cuda_device, monkeypatch)
    mc = noise in MC_NOISES
    tol = 1e-3 if mc else 1e-4
    n, size = args[0].shape[0], cfg.image_size
    before = dict(tfr.launch_counts)
    img = tbin.fused_binned_forward(cfg, *args)
    assert torch.equal(img, tbin.fused_binned_forward(cfg, *args))
    assert_kernel_close(img, tbin.binned_forward_plain(cfg, *args), mc)
    args64 = [a.double() if a.is_floating_point() else a for a in args]
    g_out = torch.randn(n, size, size, 4, generator=torch.Generator()
                        .manual_seed(1)).to(cuda_device)
    got = tbin.fused_binned_backward(cfg, *args, g_out)
    again = tbin.fused_binned_backward(cfg, *args, g_out)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ok, err, where, _t, bins = checks.binned_grads_close(
        cfg, args[:4], got, tbin.binned_backward_plain(cfg, *args, g_out),
        tbin.binned_backward_plain(cfg, *args64, g_out.double()), tol)
    assert ok, (err, where, checks.witness_text(bins))
    target = torch.rand(n, 3, size * size, generator=torch.Generator()
                        .manual_seed(2)).to(cuda_device)
    lscale = 1.0 / (n * size * size * 3)
    loss, *lg = tbin.fused_binned_loss_grad(cfg, *args, target, "l2_rgb",
                                            lscale)
    w_loss, *want = tbin.binned_loss_grad_plain(cfg, *args, target,
                                                "l2_rgb", lscale)
    _l64, *want64 = tbin.binned_loss_grad_plain(
        cfg, *args64, target.double(), "l2_rgb", lscale)
    torch.testing.assert_close(loss, w_loss, rtol=1e-5, atol=0)
    ok, err, where, _t, bins = checks.binned_grads_close(
        cfg, args[:4], lg, want, want64, tol)
    assert ok, (err, where, checks.witness_text(bins))
    d = img[..., :3].reshape(n, -1, 3).transpose(1, 2) - target
    g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(n, size, size, 3)
    g_l2 = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
    dual = tbin.fused_binned_backward(cfg, *args, g_l2.contiguous())
    ok, err, where = checks.tables_close(lg, dual, 1e-5)
    assert ok, (err, where)
    after = dict(tfr.launch_counts)
    assert {k: after[k] - before[k] for k in after if "binned" in k} == {
        "fused_binned_forward": 2, "fused_binned_backward": 3,
        "fused_binned_loss_grad": 1}


@pytest.mark.cuda
def test_binned_route_through_meshrenderer(cuda_device, monkeypatch):
    """The binned icosphere through the public entries: the render
    launches K12's forward once and its backward once, render_loss K12's
    loss-and-grad once (its gradients reach the face tables through K9b),
    and no flat or stream kernel; the pose gradients are finite and
    nonzero."""
    from pertrenderer_tpu_torch.ops import gather as gk

    _cfg, _args, mesh, renderer = _binned_case("gaussian", cuda_device,
                                               monkeypatch)
    assert renderer.plan(mesh).mode == "binned"
    renderer(mesh)                          # the PRNG check (K1) once
    log_rot = torch.zeros(2, 3, device=cuda_device, requires_grad=True)
    posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                               .transform_points(mesh.verts))
    before, scatters = dict(tfr.launch_counts), gk.launch_counts[
        "scatter_rows_cm"]
    img = renderer(posed)
    (g_img,) = torch.autograd.grad(img[..., :3].mean(), [log_rot])
    posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                               .transform_points(mesh.verts))
    loss = renderer.render_loss(posed, torch.zeros(64, 64, 3,
                                                   device=cuda_device))
    (g_loss,) = torch.autograd.grad(loss, [log_rot])
    torch.cuda.synchronize()
    after = dict(tfr.launch_counts)
    assert {k: after[k] - before[k] for k in after} == {
        "prng_probe": 0, "fused_forward": 0, "fused_backward": 0,
        "fused_loss_grad": 0, "fused_stream_forward": 0,
        "fused_stream_backward": 0, "fused_stream_loss_grad": 0,
        "fused_binned_forward": 1, "fused_binned_backward": 1,
        "fused_binned_loss_grad": 1, "fused_forward_ext": 0,
        "sharded_prob": 0, "sharded_agg_bwd": 0, "sharded_det_bwd": 0}
    assert gk.launch_counts["scatter_rows_cm"] > scatters
    for g in (g_img, g_loss):
        assert torch.isfinite(g).all() and g.abs().max() > 0


# ---------------------------------------------------------------------------
# The staged route's kernels: K9a / K9b (ops/gather.py) and K10a / K10b
# (ops/interp_gather.py)
# ---------------------------------------------------------------------------

def _gather_case(d, f, p, device, seed=0):
    """A table (f, d), a corner table (f, 3, d), weights and indices with
    -1 and out-of-range entries; rows f // 2 .. f // 2 + 9 get no column
    (empty faces)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(-2, f + 2, (p,), generator=g)
    idx[(idx >= f // 2) & (idx < f // 2 + 10)] = -1
    table = torch.randn(f, d, generator=g)
    corners = torch.randn(f, 3, d, generator=g)
    ws = [torch.rand(p, generator=g) for _ in range(3)]
    cot = torch.randn(d, p, generator=g)
    to = lambda t: t.to(device)
    return (to(table), to(corners), to(idx), [to(w) for w in ws], to(cot))


def _nearer(got, want, want64):
    scale = want64.abs().max().item()
    return min((got.double() - want.double()).abs().max().item(),
               (got.double() - want64).abs().max().item()) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 9])
def test_gather_kernels_match_plain(d, cuda_device):
    """K9a bit-exact and K9b within 1e-6 of its max (nearer of the float32
    and float64 plain versions) on F = 9000 rows (above the TPU kernel's
    8192 one-hot cap), with -1 / out-of-range indices and empty rows
    (exact zeros); repeated launches bit-equal."""
    from pertrenderer_tpu_torch.ops import gather as tg

    f, p = 9000, 200_000
    table, _c, idx, _w, cot = _gather_case(d, f, p, cuda_device)
    got = tg.gather_rows_cm(table, idx)
    assert torch.equal(got, tg.gather_rows_plain(table, idx))
    assert torch.equal(got, tg.gather_rows_cm(table, idx))
    s1 = tg.scatter_rows_cm(cot, idx, f)
    s2 = tg.scatter_rows_cm(cot, idx, f)
    want = tg.scatter_rows_plain(cot, idx, f)
    want64 = tg.scatter_rows_plain(cot.double(), idx, f)
    torch.cuda.synchronize()
    assert torch.equal(s1, s2)
    assert _nearer(s1, want, want64) <= 1e-6
    assert torch.all(s1[f // 2:f // 2 + 10] == 0.0)


def _scatter_edge_idx(kind, f, p, device):
    g = torch.Generator().manual_seed(5)
    if kind == "all_invalid":
        idx = torch.where(torch.rand(p, generator=g) < 0.5, -1, f + 1)
    elif kind == "pile_up":                   # every column in row 0
        idx = torch.zeros(p, dtype=torch.int64)
    else:                                     # 17-bit keys with gaps
        idx = torch.randint(-1, f + 1, (p,), generator=g)
        idx[(idx > 1000) & (idx < 40000)] = -1
    return idx.to(torch.int64).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,f,p", [("all_invalid", 500, 70_000),
                                      ("pile_up", 300, 300_000),
                                      ("bits17", 81_920, 400_000)])
def test_scatter_preparation_edge_cases(kind, f, p, cuda_device):
    """K9b's index preparation on the card gives the order of
    torch.sort(stable=True) and the starts of searchsorted; the sum equals
    segment_sum_plain (the same order, on the CPU) bit for bit and the
    nearer of the float32 / float64 plain versions within 1e-6 of max
    (the pile-up within 1e-5: its one row adds 1,172 chunk partials in
    float32, in order); exact zeros in empty rows; repeats bit-equal."""
    from pertrenderer_tpu_torch.ops import gather as tg

    idx = _scatter_edge_idx(kind, f, p, cuda_device)
    cot = torch.randn(3, p, generator=torch.Generator().manual_seed(6)).to(
        cuda_device)
    seg = tg.segments(idx, f)
    valid = (idx >= 0) & (idx < f)
    key = torch.where(valid, idx, torch.full_like(idx, f))
    sorted_key, order = torch.sort(key, stable=True)
    n = int(valid.sum())
    assert int(seg.num_valid[0]) == n
    assert torch.equal(seg.order[:n].long(), order[:n])
    starts = torch.searchsorted(sorted_key, torch.arange(
        f + 1, device=cuda_device))
    lengths = starts[1:] - starts[:-1]
    assert torch.equal((seg.ends - seg.starts).long(), lengths)
    assert torch.equal(seg.starts.long()[lengths > 0],
                       starts[:-1][lengths > 0])
    s1 = tg.scatter_rows_cm(cot, idx, f)
    s2 = tg.scatter_rows_cm(cot, idx, f)
    ordered = tg.segment_sum_plain(cot.cpu(), tg.segments_plain(
        idx.cpu(), f), f)
    want = tg.scatter_rows_plain(cot, idx, f)
    want64 = tg.scatter_rows_plain(cot.double(), idx, f)
    torch.cuda.synchronize()
    assert torch.equal(s1, s2)
    assert torch.equal(s1.cpu(), ordered)
    if n:
        assert _nearer(s1, want, want64) <= (1e-5 if kind == "pile_up"
                                             else 1e-6)
    assert torch.all(s1[lengths == 0] == 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 9])
def test_interp_kernels_match_plain(d, cuda_device):
    """K10a within 1 ulp of max |out| of its plain version, K10b's table
    and weight gradients within 1e-6 of their max (nearer of the float32
    and float64 plain versions), on F = 9000 rows with -1 /
    out-of-range indices and empty rows; repeats bit-equal."""
    from pertrenderer_tpu_torch.ops import interp_gather as ti

    f, p = 9000, 200_000
    _t, corners, idx, ws, cot = _gather_case(d, f, p, cuda_device, seed=1)
    got = ti.interp_rows(corners, idx, *ws)
    want = ti.interp_rows_plain(corners, idx, *ws)
    ulp = torch.finfo(torch.float32).eps * want.abs().max().item()
    assert (got - want).abs().max().item() <= ulp
    assert torch.equal(got, ti.interp_rows(corners, idx, *ws))
    dt, dws = ti.interp_rows_backward(corners, idx, *ws, cot)
    dt2, dws2 = ti.interp_rows_backward(corners, idx, *ws, cot)
    wt, wws = ti.interp_rows_backward_plain(corners, idx, *ws, cot)
    wt64, wws64 = ti.interp_rows_backward_plain(
        corners.double(), idx, *(w.double() for w in ws), cot.double())
    torch.cuda.synchronize()
    assert torch.equal(dt, dt2) and all(torch.equal(a, b)
                                        for a, b in zip(dws, dws2))
    assert _nearer(dt, wt, wt64) <= 1e-6
    for a, b, c in zip(dws, wws, wws64):
        assert _nearer(a, b, c) <= 1e-6
    assert torch.all(dt[f // 2:f // 2 + 10] == 0.0)


@pytest.mark.cuda
def test_staged_hard_phong_cube_matches_cpu(cuda_device):
    """A staged Hard-Phong render of the cube (the experiments' target
    renderer, K = 1) on the card through K9a equals the CPU plain render,
    atol 2e-5."""
    from pertrenderer_tpu_torch.experiments import harness
    from pertrenderer_tpu_torch.ops import gather as tg

    r_true = ptt.random_rotations(1, torch.Generator().manual_seed(3),
                                  device="cpu")
    before = tg.launch_counts["gather_rows_cm"]
    gpu = harness.init_target(category="cube", imsize=128,
                              R_true=r_true.to(cuda_device),
                              device=cuda_device)[3][0]
    torch.cuda.synchronize()
    assert tg.launch_counts["gather_rows_cm"] > before
    cpu = harness.init_target(category="cube", imsize=128, R_true=r_true,
                              device="cpu")[3][0]
    assert (cpu.sum(-1) > 0).float().mean() > 0.05
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_stream_preparation_is_deterministic(cuda_device):
    """Two preparations of the cow's stream inputs on the card, and their
    backward to the poses, give the same bits (the vertex normals and the
    face-table gathers sum through K9b, without float atomics)."""
    mesh, renderer = _renderer("gaussian", cuda_device, imsize=128,
                               mesh_kind="cow", sigma=1e-3, gamma=1e-2)
    log_rot0 = torch.linspace(-1.0, 1.0, 6, device=cuda_device).reshape(2, 3)

    def once():
        log_rot = log_rot0.clone().requires_grad_()
        posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                                   .transform_points(mesh.verts))
        _cfg, (tab, scal, *_rest) = _inputs(posed, renderer)
        g = torch.Generator().manual_seed(0)
        loss = ((tab * torch.randn(tab.shape, generator=g).to(tab)).sum()
                + (scal * torch.randn(scal.shape, generator=g).to(scal))
                .sum())
        (g_pose,) = torch.autograd.grad(loss, [log_rot])
        return tab.detach(), scal.detach(), g_pose

    first, second = once(), once()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("noise,vr", [
    ("gaussian", True), ("gaussian", False), ("cauchy", True),
    ("logistic", True), ("gumbel", True), ("uniform", True)])
def test_staged_estimator_kernels_match_plain(noise, vr, cuda_device):
    """K8a / K8b / K8c against their plain versions on shared noise at a
    small staged shape (N=2, 37 x 41 pixels, K=9, S=8): forwards at the MC
    tolerance (mean |d| <= 1e-5, 99.9% of elements within 1e-4), the
    gradients of gaussian and cauchy within 1e-3 of their max, two
    launches bit-equal, one launch counted per call; a pixel of exact
    ties counts every tied channel.  The elements the kernels write
    without a draw (outside K8a's band, outside K8b's candidates and in
    pixels with one candidate) are bit-equal to the plain versions."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    gen = torch.Generator().manual_seed(12)
    d = (torch.randn(2, 37, 41, 9, generator=gen) * 0.02).to(cuda_device)
    z = torch.randn(2, 37, 41, 10, generator=gen).to(cuda_device)
    z[0, 0, 0] = 0.25
    g = torch.randn(z.shape, generator=gen).to(cuda_device)
    seeds = torch.tensor([[5, -6], [7, 8]], dtype=torch.int32,
                         device=cuda_device)
    sigma = torch.tensor(1e-2, device=cuda_device)
    gamma = torch.tensor(0.5, device=cuda_device)

    def mc_close(got, want):
        dd = (got - want).abs()
        assert torch.isfinite(got).all()
        assert dd.mean().item() <= 1e-5
        assert (dd <= 1e-4).float().mean().item() >= 0.999

    cand = pk.argmax_candidates(z, gamma, noise)
    certain = {"heaviside_mean": ~pk.heaviside_band(d, sigma, noise),
               "argmax_mean": ~cand | (cand.sum(-1, keepdim=True) == 1)}
    before = dict(pk.launch_counts)
    for fn, plain, x, scale in (
            (pk.heaviside_mean, pk.heaviside_mean_plain, d, sigma),
            (pk.argmax_mean, pk.argmax_mean_plain, z, gamma)):
        got, again = fn(x, scale, seeds, 8, noise), fn(x, scale, seeds, 8,
                                                       noise)
        want = plain(x, scale, seeds, 8, noise)
        assert torch.equal(got, again)
        mc_close(got, want)
        keep = certain[fn.__name__]
        assert torch.equal(got[keep], want[keep])
    tied = pk.argmax_mean(z, gamma, seeds, 8, noise)[0, 0, 0]
    assert tied.sum().item() >= 1.0
    if noise in pk.GRAD_NOISES:
        got = pk.heaviside_coeff(d, sigma, seeds, 8, noise, vr)
        want = pk.heaviside_coeff_plain(d, sigma, seeds, 8, noise, vr)
        assert torch.equal(got, pk.heaviside_coeff(d, sigma, seeds, 8,
                                                   noise, vr))
        keep = ~pk.heaviside_band(d, sigma, noise, draw_above=not vr)
        assert torch.equal(got[keep], want[keep])
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-3
        got = pk.argmax_grads(z, g, gamma, seeds, 8, noise, vr)
        want = pk.argmax_grads_plain(z, g, gamma, seeds, 8, noise, vr)
        for a, b, c in zip(got, want, pk.argmax_grads(z, g, gamma, seeds, 8,
                                                      noise, vr)):
            assert torch.equal(a, c)
            assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-3
    torch.cuda.synchronize()
    launched = {k: pk.launch_counts[k] - before[k] for k in before}
    assert launched["heaviside_mean"] == 2 and launched["argmax_mean"] == 3
    if noise in pk.GRAD_NOISES:
        assert launched["heaviside_coeff"] == 2
        assert launched["argmax_grads"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("c,s", [(51, 8), (51, 13), (33, 8), (101, 13)])
@pytest.mark.parametrize("noise,vr", [
    ("gaussian", True), ("gaussian", False), ("cauchy", True)])
def test_argmax_grads_kernel_channels_and_samples(noise, vr, c, s,
                                                  cuda_device):
    """K8c (a warp per pixel, the channels across its lanes) against its
    plain version at the main path's C = 51 (two channels per lane) and at
    the odd C = 33 and 101 (two and four per lane, the last lane group
    ragged), at S = 8 and at S = 13 (above the sample batch of 4, the last
    batch ragged): grad_z and the gamma term within 1e-3 of their max, two
    launches bit-equal; pixel 0 has every channel tied, pixel 1 two
    channels tied at its max."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    gen = torch.Generator().manual_seed(13)
    z = torch.randn(2, 19, 23, c, generator=gen)
    z[:, 0, 0] = 0.5
    z[:, 0, 1, c // 3] = z[:, 0, 1, c - 2] = z[:, 0, 1].max() + 1.0
    z = z.to(cuda_device)
    g = torch.randn(z.shape, generator=gen).to(cuda_device)
    seeds = torch.tensor([[9, -10], [11, 12]], dtype=torch.int32,
                         device=cuda_device)
    gamma = torch.tensor(0.5, device=cuda_device)
    got = pk.argmax_grads(z, g, gamma, seeds, s, noise, vr)
    again = pk.argmax_grads(z, g, gamma, seeds, s, noise, vr)
    want = pk.argmax_grads_plain(z, g, gamma, seeds, s, noise, vr)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
        assert ((a - w).abs().max() / w.abs().max()).item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("noise,vr", [("gaussian", True),
                                      ("cauchy", False)])
def test_argmax_grads_kernel_above_512_channels(noise, vr, cuda_device):
    """K8c at C = 600 (above 16 channels per lane: the wide path) against
    its plain version: grad_z and the gamma term within 1e-3 of their max,
    two launches bit-equal."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    gen = torch.Generator().manual_seed(14)
    z = torch.randn(2, 7, 9, 600, generator=gen).to(cuda_device)
    g = torch.randn(z.shape, generator=gen).to(cuda_device)
    seeds = torch.tensor([[15, -16], [17, 18]], dtype=torch.int32,
                         device=cuda_device)
    gamma = torch.tensor(0.5, device=cuda_device)
    got = pk.argmax_grads(z, g, gamma, seeds, 5, noise, vr)
    again = pk.argmax_grads(z, g, gamma, seeds, 5, noise, vr)
    want = pk.argmax_grads_plain(z, g, gamma, seeds, 5, noise, vr)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
        assert ((a - w).abs().max() / w.abs().max()).item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("noise", ["gaussian", "cauchy"])
def test_staged_mc_render_matches_cpu(noise, cuda_device):
    """A staged MC render of the cube (a znear override sends it staged)
    and its vertex gradient on the card (K8a-c, K9, K10) against the CPU
    plain versions on the same seed words: the image at the MC tolerance,
    the gradient within 1e-3 of its max."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    def run(device):
        mesh, renderer = _renderer(noise, device, imsize=64)
        seeds = tfr.draw_seeds(mesh.batch_size,
                               torch.Generator().manual_seed(4),
                               device=device)
        verts = mesh.verts.detach().clone().requires_grad_()
        img = renderer(mesh.update_padded(verts), seeds=seeds, znear=1.0)
        w = torch.randn(img.shape, generator=torch.Generator()
                        .manual_seed(5)).to(device)
        (g,) = torch.autograd.grad((img * w).sum(), [verts])
        return img.detach().cpu(), g.cpu()

    before = dict(pk.launch_counts)
    img_g, g_g = run(cuda_device)
    torch.cuda.synchronize()
    assert all(pk.launch_counts[k] > before[k] for k in before)
    img_c, g_c = run("cpu")
    assert (img_c[..., 3] > 0.5).float().mean() > 0.05
    assert_kernel_close(img_g, img_c, mc=True)
    assert ((g_g - g_c).abs().max() / g_c.abs().max()).item() <= 1e-3


# The sample-sharded flat route's kernels (K11a, K3 with external
# coverage, K11b, K11c) on one rank's seed words (shard 1 of a sample
# group), each fed its plain upstream: the cube (gaussian pair, S=4) at
# 32^2, and moved up in a 64^2 image whose lower strip is inactive.


def sharded_case(device, imsize=32, shift=None, d=1, s=4):
    """(cfg, inputs with shard d's seed words) of the cube with
    GaussianRast + GaussianAgg sharding the 'samples' axis."""
    mesh, renderer = _renderer("gaussian", device, imsize=imsize, s=s,
                               sigma=1e-3 if shift else 1e-2)
    if shift is not None:
        mesh = mesh.offset_verts(torch.tensor(shift, device=device)
                                 .expand(mesh.verts.shape[1], 3))
    sh, settings = renderer.shader, renderer.rasterizer.raster_settings
    sr = dataclasses.replace(sh.smoothrast, sample_axis="samples")
    sa = dataclasses.replace(sh.smoothagg, sample_axis="samples")
    cfg, _why = tfr._plan(mesh, sh.lights, sr, sa, settings, "phong")
    seeds = tfr.shard_seeds(cfg, tfr.draw_seeds(
        mesh.batch_size, torch.Generator().manual_seed(5), device=device), d)
    return cfg, tfr._prepare_inputs(cfg, mesh, sh.cameras, sh.lights,
                                    sh.materials, sr, sa, sh.blend_params,
                                    settings, seeds, "phong")


def assert_fields_close(got, want):
    """(N, rows, H * W) fields by the MC image rule, per pixel."""
    assert_kernel_close(got.transpose(1, 2), want.transpose(1, 2), mc=True)


@pytest.mark.cuda
@pytest.mark.parametrize("imsize,shift", [(32, None),
                                          (64, (0.0, 2.5, 0.0))])
def test_sharded_kernels_match_plain(imsize, shift, cuda_device):
    """K11a's coverage, K3's image and weights with external coverage (MC
    image rule), K11b's g_zmap and gamma term (1e-3 of max) and K11c's
    tables (assert_tables_close) against their plain versions on the same
    inputs; repeated launches bit-equal."""
    cfg, ins = sharded_case(cuda_device, imsize, shift)
    assert cfg.prob_ext and not cfg.stream
    if shift is not None:
        assert ins[7].tolist() == [[1, 0], [1, 0]]
    seeds, active = ins[6], ins[7]
    cover = (ins[0], ins[4], ins[5], seeds, active)
    prob = tfr.fused_prob(cfg, *cover)
    want_prob = tfr.prob_plain(cfg, *cover)
    assert_fields_close(prob, want_prob)
    assert torch.equal(prob, tfr.fused_prob(cfg, *cover))

    img, w = tfr.fused_forward(cfg, *ins, prob=want_prob)
    want_img, want_w = tfr.forward_plain(cfg, *ins, want_prob)
    assert_kernel_close(img, want_img, mc=True)
    assert_fields_close(w, want_w)
    again = tfr.fused_forward(cfg, *ins, prob=want_prob)
    assert torch.equal(img, again[0]) and torch.equal(w, again[1])

    g_out = torch.randn(2, imsize, imsize, 4, generator=torch.Generator()
                        .manual_seed(1)).to(cuda_device)
    gz, gg = tfr.fused_agg_bwd(cfg, *ins, want_prob, g_out)
    want_gz, want_gg = tfr.agg_bwd_plain(cfg, *ins, want_prob, g_out)
    for got_t, want_t in ((gz, want_gz), (gg, want_gg)):
        d = (got_t - want_t).abs().max().item()
        assert d <= 1e-3 * want_t.abs().max().item(), d
    assert torch.equal(gg, tfr.fused_agg_bwd(cfg, *ins, want_prob,
                                             g_out)[1])

    grads = tfr.fused_det_bwd(cfg, *ins, want_prob, want_w, want_gz, g_out)
    assert_tables_close(grads, tfr.det_bwd_plain(cfg, *ins, want_prob,
                                                 want_w, want_gz, g_out),
                        True)
    again = tfr.fused_det_bwd(cfg, *ins, want_prob, want_w, want_gz, g_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
