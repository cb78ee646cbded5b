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


def _renderer(noise, device, imsize=32, n=2, lights_kind="point",
              textures="uv", perspective_correct=False):
    mesh = ptt.load_cube(device=device).scale_verts(2.0)
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
    sigma, gamma = 1e-2, 5e-1
    settings = ptt.RasterizationSettings(
        image_size=imsize, blur_radius=float(np.log(1 / 1e-4 - 1) * sigma),
        faces_per_pixel=50, perspective_correct=perspective_correct)
    sr, sa = _smoothers(noise, sigma, gamma, 4)
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
    seeds = tfr.draw_seeds(mesh.batch_size, torch.Generator().manual_seed(5))
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
    seeds = tfr.draw_seeds(2, torch.Generator().manual_seed(7))
    mesh, renderer = _renderer("gaussian", cuda_device)
    before = tfr.launch_counts["fused_forward"]
    got = renderer(mesh, seeds=seeds)
    torch.cuda.synchronize()
    assert tfr.launch_counts["fused_forward"] == before + 1
    mesh_c, renderer_c = _renderer("gaussian", "cpu")
    assert_kernel_close(got.cpu(), renderer_c(mesh_c, seeds=seeds), True)
