"""K2's plain version (``loss_grad_plain``) against the JAX fused
loss-and-grad kernel, the dual path inside the port (K2 = forward + K4
with the L2 cotangent), and the repairs the backward needs: the
corrected primitives' gradients, the variance-reduction bits, no gradient
to the shininess, the background-only rule of pixels with no candidate
face and the card as every entry point's default device.

Tolerances: losses rtol 1e-5; gradient tables as in
test_torch_backward.py (1e-4 of the table's max |grad| for deterministic
pairs, 1e-3 for MC pairs, which share their noise)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu.ops import perturbed as jperturbed
from pertrenderer_tpu_torch.ops import fused_render as tfr
from pertrenderer_tpu_torch.ops import perturbed as tperturbed

from _torch_parity import (build, interpret_env, jax_inputs,  # noqa: F401
                           one_torch_thread, port_config, port_inputs)
from test_torch_backward import assert_grads_close, jax_backward

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMAGE = 16


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


def _case(noise, **kw):
    mesh, _cams, _lights, renderer = build(noise, imsize=IMAGE, **kw)
    jcfg, jin = jax_inputs(mesh, renderer)
    return jcfg, jin, port_config(jcfg), port_inputs(jcfg, jin)


def _target(n, seed=3):
    return np.random.default_rng(seed).uniform(
        size=(n, 3, IMAGE * IMAGE)).astype(np.float32)


def jax_loss_grad(jcfg, jin, target_cm, loss_kind, lscale):
    """JAX ``_pallas_loss_grad`` per batch element: (loss (N,), tables in
    the port's layout)."""
    n, hw = target_cm.shape[0], target_cm.shape[2]
    tcm = jnp.pad(jnp.asarray(target_cm),
                  ((0, 0), (0, 0), (0, jfr._n_tiles(jcfg) * jcfg.p_tile - hw)))
    ls = jnp.full((n, 1, 1), lscale, jnp.float32)
    out = jax.vmap(lambda *a: jfr._pallas_loss_grad(jcfg, loss_kind, *a))(
        *jin, tcm, ls)
    loss = np.asarray(out[0])[:, 0, 0]
    tables = [np.asarray(x) for x in out[1:]]
    tables[4] = tables[4][:, 0]
    return loss, tables


@pytest.mark.parametrize("noise,loss_kind", [("gaussian", "l2_rgb"),
                                             ("softras", "l1_rgb")])
def test_loss_grad_plain_matches_jax(noise, loss_kind):
    jcfg, jin, cfg, tin = _case(noise)
    n = tin[0].shape[0]
    target = _target(n)
    lscale = 1.0 / (n * IMAGE * IMAGE * 3)
    loss, *got = tfr.loss_grad_plain(cfg, *tin, torch.from_numpy(target),
                                     loss_kind, lscale)
    want_loss, want = jax_loss_grad(jcfg, jin, target, loss_kind, lscale)
    np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-5)
    assert_grads_close(got, want, noise == "gaussian")


@pytest.mark.parametrize("noise", ["gaussian", "cauchy", "uniform"])
def test_loss_grad_is_forward_plus_backward(noise):
    """The dual path inside the port: K2's loss and gradients equal K3's
    image under the L2 loss and K4 fed its cotangent 2 (rgb - target) /
    (N H W 3), alpha 0 (deterministic: the same noise on both paths)."""
    _jcfg, _jin, cfg, tin = _case(noise, n_views=2)
    n = tin[0].shape[0]
    target = torch.from_numpy(_target(n, seed=4))
    lscale = 1.0 / (n * IMAGE * IMAGE * 3)
    loss, *got = tfr.fused_loss_grad(cfg, *tin, target, "l2_rgb", lscale)
    img = tfr.fused_forward(cfg, *tin)
    rgb = img[..., :3].reshape(n, -1, 3).transpose(1, 2)
    d = rgb - target
    np.testing.assert_allclose(loss.numpy(), (torch.sum(d * d, dim=(1, 2))
                                              * lscale).numpy(), rtol=1e-5)
    g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(n, IMAGE, IMAGE, 3)
    g_out = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
    want = tfr.fused_backward(cfg, *tin, g_out.contiguous())
    assert_grads_close([g.numpy() for g in got], [w.numpy() for w in want],
                       mc=False)


def test_render_loss_matches_mean_squared_error():
    """MeshRenderer.render_loss is the mean squared RGB error of the same
    render, and its gradient reaches the pose."""
    mesh, _cams, _lights, jrend = build("cauchy", imsize=IMAGE)
    from pertrenderer_tpu_torch import convert

    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(jrend, device="cpu")
    seeds = tfr.draw_seeds(1, torch.Generator().manual_seed(9), device="cpu")
    target = torch.rand(IMAGE, IMAGE, 3, generator=torch.Generator()
                        .manual_seed(2))
    log_rot = torch.tensor([[0.1, 0.2, -0.1]], requires_grad=True)
    posed = tmesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                                .transform_points(tmesh.verts))
    loss = trend.render_loss(posed, target, seeds=seeds)
    img = trend(posed, seeds=seeds)
    torch.testing.assert_close(loss, torch.mean((img[..., :3] - target) ** 2),
                               rtol=1e-5, atol=0)
    (g,) = torch.autograd.grad(loss, [log_rot])
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("noise", ["softras", "gaussian", "gaussian_wovr",
                                   "cauchy", "uniform", "hard"])
def test_pixel_without_candidate_gives_background_gradient(noise):
    """JAX gives a tile with no candidate face only the background-colour
    gradient (``bg_only``); so does the port, from the same activity bits
    (``_active_tiles``).  At 48^2 the image is two JAX tiles (a 2048-pixel
    strip and the last 256 pixels) and the cube, moved up, lies in the
    first: for every menu
    pair, the aggregation without variance reduction included, the
    gradients equal JAX's, and a pixel of the empty tile gives exactly the
    background gradient."""
    size = 48
    mesh, _cams, _lights, renderer = build(noise, imsize=size, s=2,
                                           sigma=1e-3, shift=(0.0, 2.5, 0.0))
    jcfg, jin = jax_inputs(mesh, renderer)
    cfg, tin = port_config(jcfg), port_inputs(jcfg, jin)
    act = tfr._active_tiles(cfg, tin[0], tin[4], tin[5][:, tfr._S_BLUR])
    assert tfr._n_tiles(cfg) == 2 and act.tolist() == [[1, 0]]
    assert torch.equal(act, tin[7])
    n = tin[0].shape[0]
    g_out = np.random.default_rng(7).normal(
        size=(n, size, size, 4)).astype(np.float32)
    mc = noise in ("gaussian", "gaussian_wovr", "cauchy")
    got = tfr.backward_plain(cfg, *tin, torch.from_numpy(g_out))
    assert_grads_close(got, jax_backward(jcfg, jin, g_out), mc)
    if noise == "gaussian_wovr":            # and K2's plain version
        target = np.random.default_rng(8).uniform(
            size=(n, 3, size * size)).astype(np.float32)
        lscale = 1.0 / (n * size * size * 3)
        loss, *got = tfr.loss_grad_plain(cfg, *tin, torch.from_numpy(target),
                                         "l2_rgb", lscale)
        want_loss, want = jax_loss_grad(jcfg, jin, target, "l2_rgb", lscale)
        np.testing.assert_allclose(loss.numpy(), want_loss, rtol=1e-5)
        assert_grads_close(got, want, mc)

    pix = size * size - 1                   # the last pixel: tile 1
    g_one = torch.zeros(n, size * size, 4)
    g_one[:, pix] = torch.tensor([0.3, -0.7, 1.1, 0.9])
    g = tfr.backward_plain(cfg, *tin, g_one.reshape(n, size, size, 4))
    for table in g[:4]:
        assert torch.count_nonzero(table) == 0
    want = torch.zeros(n, 34)
    want[:, tfr._S_BG:tfr._S_BG + 3] = g_one[:, pix, :3]
    torch.testing.assert_close(g[4], want, rtol=0, atol=0)


def test_variance_reduction_changes_the_coverage_gradient():
    """GaussianRast and GaussianRast_wovr share a forward but not a
    gradient (each is held to JAX in test_torch_backward.py)."""
    _jcfg, _jin, cfg, tin = _case("gaussian")
    assert cfg.rast_vr and cfg.agg_vr
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, IMAGE, IMAGE, 4)).astype(np.float32))
    vr = tfr.backward_plain(cfg, *tin, g)
    wovr = tfr.backward_plain(dataclasses.replace(cfg, rast_vr=False), *tin,
                              g)
    assert torch.equal(tfr.forward_plain(cfg, *tin), tfr.forward_plain(
        dataclasses.replace(cfg, rast_vr=False), *tin))
    assert not torch.allclose(vr[0], wovr[0])
    assert tfr._RAST_MAP["GaussianRast"][2]
    assert not tfr._RAST_MAP["GaussianRast_wovr"][2]
    assert not tfr._AGG_MAP["GaussianAgg_wovr"][2]


def test_shininess_and_blur_get_no_gradient():
    _jcfg, _jin, cfg, tin = _case("softras")
    g = torch.ones(1, IMAGE, IMAGE, 4)
    g_scal = tfr.backward_plain(cfg, *tin, g)[4]
    assert g_scal[0, tfr._S_SHIN] == 0 and g_scal[0, tfr._S_BLUR] == 0
    assert g_scal[0, tfr._S_LIGHT:tfr._S_LIGHT + 3].abs().max() > 0


def test_corrected_primitives_match_jax():
    """log_corrected at x = 0 and prod_corrected with y = -inf: gradients
    are zero where the plain rules would give inf or nan, as JAX's."""
    x = np.array([0.0, 0.5, 2.0], np.float32)
    gy = np.array([1.0, -2.0, 0.5], np.float32)
    want = jax.vjp(jperturbed.log_corrected, jnp.asarray(x))[1](
        jnp.asarray(gy))[0]
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad(tperturbed.log_corrected(xt),
                                 [xt], torch.tensor(gy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == 0

    y = np.array([[-np.inf, -1.5, 0.25], [3.0, -np.inf, 1.0]], np.float32)
    g = np.array([[0.5, 1.0, -1.0], [2.0, 4.0, 0.5]], np.float32)
    s = np.float32(0.7)
    want_s, want_y = jax.vjp(jperturbed.prod_corrected, jnp.asarray(s),
                             jnp.asarray(y))[1](jnp.asarray(g))
    st = torch.tensor(s, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    got_s, got_y = torch.autograd.grad(tperturbed.prod_corrected(st, yt),
                                       [st, yt], torch.tensor(g))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert np.isfinite(got_s.item())


def test_entry_points_default_to_the_card():
    """Called without ``device=`` the entry points put their tensors on the
    card; on a machine without one they raise instead of falling back to
    the CPU."""
    calls = [
        lambda: ptt.load_cube().verts,
        lambda: ptt.Meshes.create([[0.0, 0.0, 0.0]] * 3, [[0, 1, 2]]).verts,
        lambda: ptt.PerspectiveCameras.create().R,
        lambda: ptt.PointLights.create().location,
        lambda: tfr.prng_probe("uniform", s=1, c=2, p=8),
        lambda: tfr.draw_seeds(1),
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
