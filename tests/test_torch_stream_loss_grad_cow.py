"""The stream route's loss-and-grad on the cow (5120 faces in 80 chunks)
at 48^2, S=2: ``stream_loss_grad_plain`` (the plain version of K7)
against JAX's ``_pallas_stream_loss_grad`` (interpret mode, the same
inputs and seed rows), for the GaussianRast + GaussianAgg pair of the
pose loop, SoftRast + SoftAgg and GaussianAgg without variance reduction,
L2 and L1 image losses.  Tiles visit many chunks (see
test_torch_stream_grads_cow.py).

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
from test_torch_stream_grads import split
from test_torch_stream_grads_cow import IMAGE, cow_case


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


@pytest.mark.parametrize("noise,kind", [
    ("gaussian", "l2_rgb"), ("softras", "l2_rgb"),
    ("gaussian_wovr", "l1_rgb")])
def test_stream_loss_grad_plain_matches_jax_on_the_cow(noise, kind):
    jcfg, jin, cfg, tin = cow_case(noise)
    target = np.random.default_rng(3).uniform(
        size=(1, IMAGE, IMAGE, 3)).astype(np.float32)
    target_cm = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(target.reshape(1, -1, 3), -1, 1)))
    lscale = 1.0 / (IMAGE * IMAGE * 3)
    loss, *got = tfr.stream_loss_grad_plain(cfg, *tin, target_cm, kind,
                                            lscale)
    w_loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, target=target,
                                             loss_kind=kind, lscale=lscale)
    np.testing.assert_allclose(loss.numpy(), w_loss, rtol=1e-5)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal),
                       noise in MC_NOISES)
