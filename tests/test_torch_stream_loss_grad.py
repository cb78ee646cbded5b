"""The stream route's loss-and-grad on the cube with K=4 at 16^2 (F=12 >
K: one chunk, two tiles), every menu pair:

* ``stream_loss_grad_plain`` (the plain version of K7) against JAX's
  ``_pallas_stream_loss_grad`` (interpret mode, same inputs and seed
  rows), L2 and L1 image losses;
* the dual path inside the port: the loss-and-grad equals the forward
  under the L2 loss plus the backward fed its cotangent (two views).

Tolerances: losses rtol 1e-5; each gradient table and each of the 34
scalar gradients within 1e-4 (deterministic pairs) or 1e-3 (MC pairs) of
its own max |grad| (``assert_grads_close``)."""

import numpy as np
import pytest
import torch

from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (interpret_env, jax_stream_grads, MC_NOISES,
                           one_torch_thread)
from test_torch_backward import assert_grads_close
from test_torch_stream_grads import IMAGE, cube_case, split


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


def _target(n, seed=3):
    return np.random.default_rng(seed).uniform(
        size=(n, IMAGE, IMAGE, 3)).astype(np.float32)


def _target_cm(target):
    n = target.shape[0]
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(target.reshape(n, -1, 3), -1, 1)))


@pytest.mark.parametrize("noise,kind", [
    ("softras", "l2_rgb"), ("gaussian", "l2_rgb"),
    ("gaussian_wovr", "l1_rgb"), ("cauchy", "l2_rgb"),
    ("uniform", "l1_rgb"), ("hard", "l2_rgb")])
def test_stream_loss_grad_plain_matches_jax(noise, kind):
    jcfg, jin, cfg, tin = cube_case(noise)
    n = tin[0].shape[0]
    target = _target(n)
    lscale = 1.0 / (n * IMAGE * IMAGE * 3)
    loss, *got = tfr.stream_loss_grad_plain(cfg, *tin, _target_cm(target),
                                            kind, lscale)
    w_loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, target=target,
                                             loss_kind=kind, lscale=lscale)
    np.testing.assert_allclose(loss.numpy(), w_loss, rtol=1e-5)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal),
                       noise in MC_NOISES)


@pytest.mark.parametrize("noise", ["gaussian", "softras"])
def test_stream_loss_grad_is_forward_plus_backward(noise):
    """The same noise on both paths, so the two agree to rounding: K7's
    loss and gradients equal K5's image under the L2 loss and K6 fed its
    cotangent 2 (rgb - target) / (N H W 3), alpha 0."""
    _jcfg, _jin, cfg, tin = cube_case(noise, n_views=2)
    n = tin[0].shape[0]
    target = _target_cm(_target(n, seed=4))
    lscale = 1.0 / (n * IMAGE * IMAGE * 3)
    loss, *got = tfr.fused_stream_loss_grad(cfg, *tin, target, "l2_rgb",
                                            lscale)
    img = tfr.fused_stream_forward(cfg, *tin)
    d = img[..., :3].reshape(n, -1, 3).transpose(1, 2) - target
    np.testing.assert_allclose(loss.numpy(), (torch.sum(d * d, dim=(1, 2))
                                              * lscale).numpy(), rtol=1e-5)
    g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(n, IMAGE, IMAGE, 3)
    g_out = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
    want = tfr.fused_stream_backward(cfg, *tin, g_out.contiguous())
    assert_grads_close(split(cfg, *got), split(cfg, *want), mc=False)
