"""K12's plain versions (the binned route's forward and backward over
per-tile slot tables) against the JAX package's binned kernels
(interpret mode) on shared inputs, and the dual path; the loss-and-grad,
the route end to end and the pose steps: test_torch_binned_steps.py.

The scene of test_torch_binned_tables.py: the level-3 icosphere at 64^2,
``_BIN_P_TILE`` 32, ``_COARSE_THRESHOLD`` 512, M = 32 slots; softras
(sigma 1e-2, gamma 5e-2) and the gaussian pair at S=2 on JAX's seed rows.

Tolerances: images atol 2e-5 (softras) or, MC (shared noise, ulp-level
threshold flips), mean |d| <= 1e-5 and 99.9% of pixels within 1e-4;
losses rtol 1e-5; each gradient row within 1e-4 (softras) or 1e-3 (MC)
of its table's max |grad|, and each scalar of its own max, of JAX's or
of the plain version evaluated in float64, except the rows of faces seen
nearly edge-on (height h over longest edge L below 2e-6 / tol), held
within 2e-6 L / h (``checks.binned_grads_close``: float32 gradients of
such a face carry rounding noise that grows as L / h whatever the order
of the arithmetic); the dual path within 1e-5.  The plain versions
aggregate in float64, as K12 does (``fused_render._render_block``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch import checks
from pertrenderer_tpu_torch.ops import binned as tbin
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (assert_image_close, jax_inputs,  # noqa: F401
                           one_torch_thread, port_config)
from test_torch_binned_tables import IMAGE, _env, binned_scene  # noqa: F401

NOISES = ("softras", "gaussian")


def case(noise, n_views=2):
    """(JAX config, JAX kernel inputs, the port's config, the port's
    kernel inputs on JAX's tables and seed rows) of ``n_views`` poses."""
    mesh, rend = binned_scene(noise, n_views=n_views)
    jcfg, jin = jax_inputs(mesh, rend)
    assert jcfg.binned and jcfg.f_pad == 32 and jcfg.p_tile == 32
    t = lambda x: torch.from_numpy(np.array(x))
    valid = t(np.asarray(jin[4])[..., 0])
    tin = ([t(x) for x in jin[:4]] + [valid, t(np.asarray(jin[5])[:, 0]),
                                      t(np.asarray(jin[6])[:, 0, :4]),
                                      tbin._active_tiles(valid)])
    return jcfg, jin, port_config(jcfg), tin


def jax_forward(jcfg, jin):
    out = jax.vmap(lambda *a: jfr._fused_core(jcfg, *a))(*jin)
    n, s = out.shape[0], jcfg.image_size
    return np.moveaxis(np.asarray(out)[..., :s * s].reshape(n, 4, s, s), 1,
                       -1)


def jax_grads(jcfg, jin, extra, loss_kind=None, lscale=0.0):
    """JAX's binned backward (``extra`` = g_out, channel-major) or
    loss-and-grad (``extra`` = target) per batch element: (loss (N,),
    g_ndc, g_world, g_fn, g_tex (N, nt, M, .), g_scal (N, 34))."""
    outs = []
    for b in range(jin[0].shape[0]):
        args = [x[b] for x in jin]
        active = jfr._active_tiles(jcfg, args[0], args[4], 0.0)
        if loss_kind is None:
            res = (jnp.zeros((1, 1)),) + tuple(jfr._pallas_backward(
                jcfg, *args, active, jnp.asarray(extra[b])))
        else:
            res = jfr._pallas_loss_grad(jcfg, loss_kind, *args,
                                        jnp.asarray(extra[b]),
                                        jnp.full((1, 1), lscale, jnp.float32))
        outs.append([np.asarray(x) for x in res])
    loss, *tabs, scal = (np.stack([o[i] for o in outs])
                         for i in range(6))
    return (torch.from_numpy(loss.reshape(-1)),
            *[torch.from_numpy(x) for x in tabs],
            torch.from_numpy(scal.reshape(-1, 34)))


def hold(cfg, tin, got, want, mc, plain64, scalar_tol=None):
    """``got`` against JAX's ``want`` (checks.binned_grads_close), or
    against the plain version evaluated in float64 (``plain64`` of the
    inputs in float64): float32 sums of a scalar gradient whose terms
    cancel round differently in the two packages, and each may lie off
    the float64 value by more than the tolerance; ``scalar_tol`` as
    there."""
    want64 = plain64([t.double() if t.is_floating_point() else t
                      for t in tin])
    ok, worst, where, thin, _report = checks.binned_grads_close(
        cfg, tin[:4], got, want, want64[-5:], 1e-3 if mc else 1e-4,
        scalar_tol)
    assert ok, (worst, where, thin)


# Rounding depth of one pixel's share of a scalar gradient: float32
# operations between the tables and the share (det1's shading and its
# adjoint, the weights, the blend), each off by at most u = 2^-24.
SHARE_ROUNDINGS = 16


def scalar_share_bound(shares):
    """(34,) bound of a float32 evaluation's scalar gradients, over each
    scalar's own max |grad| over N: ``shares`` (N, 34, P) the pixels'
    shares of each scalar gradient in float64 (the plain version given a
    copy of the scalars per pixel).  Each share is within K u of itself
    (K = SHARE_ROUNDINGS), so the sum is within K u sum_p |share| of the
    float64 value (the summation's own rounding is below that): under a
    cotangent of mixed sign a scalar's shares can cancel to a small part
    of their magnitudes (kappa = sum |share| / |sum share| in the
    thousands), and no float32 evaluation is then held to 1e-4."""
    s = shares.double()
    scale = s.sum(dim=-1).abs().amax(dim=0)
    scale = torch.clamp(torch.maximum(scale, 1e-6 * scale.max()), min=1e-30)
    return (SHARE_ROUNDINGS * 2.0 ** -24 * s.abs().sum(dim=-1).amax(dim=0)
            / scale)


def pixel_shares(cfg, tin, g_out):
    """(N, 34, H*W) each pixel's share of the scalar gradients of the
    backward with ``g_out`` (N, H, W, 4), in float64: the plain pipeline
    over the tiles with one copy of the scalars per pixel."""
    t64 = [t.double() if t.is_floating_point() else t for t in tin]
    n, p = tin[0].shape[0], cfg.p_tile
    g_cm = g_out.double().reshape(n, -1, 4).transpose(1, 2)
    out = torch.zeros(n, 34, IMAGE * IMAGE, dtype=torch.float64)
    for t0, t1 in tbin._tile_blocks(cfg, n):
        a = tbin._block_args(cfg, [t[:, t0:t1] for t in t64[:4]],
                             *t64[4:8], t0, t1)
        a[5] = a[5][:, :, None].expand(-1, -1, p).clone().requires_grad_()
        img = tfr._render_block(cfg, *a)
        (g,) = torch.autograd.grad(
            torch.sum(img * tbin._cm_block(g_cm, n, t0, t1, p)), [a[5]])
        out[..., t0 * p:t1 * p] = g.view(n, t1 - t0, 34, p).transpose(
            1, 2).reshape(n, 34, -1)
    return out


@pytest.mark.parametrize("noise", NOISES)
def test_binned_forward_plain_matches_jax(noise):
    jcfg, jin, cfg, tin = case(noise)
    got = tbin.binned_forward_plain(cfg, *tin)
    want = jax_forward(jcfg, jin)
    assert_image_close(got.numpy(), want, mc=noise != "softras")
    assert (want[..., 3] > 0.5).mean() > 0.1
    # The CPU wrapper is the plain version; no kernel is counted.
    before = dict(tfr.launch_counts)
    torch.testing.assert_close(tbin.fused_binned_forward(cfg, *tin), got,
                               rtol=0, atol=0)
    assert tfr.launch_counts == before


@pytest.mark.parametrize("noise", NOISES)
def test_binned_backward_plain_matches_jax(noise):
    """Under the random cotangent the softras light-x gradient's pixel
    shares cancel to 1 / 1400 of their magnitudes, and both packages'
    float32 sums lie more than 1e-4 of its value off the float64 one
    (JAX 1.3e-4, the plain version 4.4e-4): each softras scalar is held
    within the larger of the tolerance and ``scalar_share_bound``
    (16 ulps of each share: 1.4e-3 for light-x, 1.2e-4 at most for the
    others)."""
    jcfg, jin, cfg, tin = case(noise, n_views=1)
    g_out = np.random.default_rng(0).normal(
        size=(tin[0].shape[0], IMAGE, IMAGE, 4)).astype(np.float32)
    got = tbin.binned_backward_plain(cfg, *tin, torch.from_numpy(g_out))
    g_cm = np.ascontiguousarray(np.moveaxis(
        g_out.reshape(g_out.shape[0], -1, 4), -1, 1))
    want = jax_grads(jcfg, jin, g_cm)[1:]
    bound = (scalar_share_bound(pixel_shares(
        cfg, tin, torch.from_numpy(g_out))) if noise == "softras" else None)
    hold(cfg, tin, got, want, noise != "softras",
         lambda a: tbin.binned_backward_plain(cfg, *a, torch.from_numpy(
             g_out).double()), bound)


@pytest.mark.parametrize("noise", NOISES)
def test_binned_dual_path(noise):
    """loss-and-grad equals the forward, the L2 cotangent and the
    backward: loss rtol 1e-5, every table and scalar within 1e-5 of its
    max."""
    _jcfg, _jin, cfg, tin = case(noise)
    n, hw = tin[0].shape[0], IMAGE * IMAGE
    target = torch.rand(n, 3, hw, generator=torch.Generator().manual_seed(4))
    lscale = 1.0 / (n * hw * 3)
    loss, *got = tbin.binned_loss_grad_plain(cfg, *tin, target, "l2_rgb",
                                             lscale)
    img = tbin.binned_forward_plain(cfg, *tin)
    d = img[..., :3].reshape(n, hw, 3).transpose(1, 2) - target
    g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(n, IMAGE, IMAGE, 3)
    g_out = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
    dual = tbin.binned_backward_plain(cfg, *tin, g_out)
    torch.testing.assert_close(loss, torch.sum(d * d, dim=(1, 2)) * lscale,
                               rtol=1e-5, atol=0)
    ok, err, where = checks.tables_close(got, dual, 1e-5)
    assert ok, (err, where)
