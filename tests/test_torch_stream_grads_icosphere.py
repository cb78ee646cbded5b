"""The stream route's gradients on the icosphere (1280 faces in 20
chunks) at 32^2, S=2, sigma 1e-2: ``stream_backward_plain`` and
``stream_loss_grad_plain`` (the plain versions of K6 and K7) against
JAX's ``_pallas_stream_backward`` / ``_pallas_stream_loss_grad``
(interpret mode, the same inputs and seed rows), for the MC pairs whose
terms run across chunks (GaussianAgg with variance reduction, CauchyAgg).

The deterministic pairs are held on the cube and the cow instead: one
face of this view is seen almost edge-on (height a few millionths of its
longest edge), and the two packages' float32 gradients of that face
differ by more than 1e-4 of the table max, as two float32 evaluations in
different orders do.

Tolerances: losses rtol 1e-5; each gradient table and each of the 34
scalar gradients within 1e-3 of its own max |grad| (MC: shared noise,
ulp-level threshold flips; ``assert_grads_close``)."""

import numpy as np
import pytest
import torch

from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (build, interpret_env, jax_inputs,
                           jax_stream_grads, one_torch_thread, port_config,
                           port_stream_inputs)
from test_torch_backward import assert_grads_close
from test_torch_stream_grads import split

IMAGE = 32


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


def icosphere_case(noise):
    mesh, _cams, _lights, renderer = build(noise, imsize=IMAGE, k=50, s=2,
                                           mesh_kind="icosphere")
    jcfg, jin = jax_inputs(mesh, renderer)
    assert jcfg.stream and jcfg.rw == 1280
    tin = port_stream_inputs(jcfg, jin)
    assert int((tin[2] * tin[3]).max()) > 1
    return jcfg, jin, port_config(jcfg), tin


def test_stream_backward_plain_matches_jax_on_the_icosphere():
    jcfg, jin, cfg, tin = icosphere_case("gaussian")
    g_out = np.random.default_rng(0).normal(
        size=(1, IMAGE, IMAGE, 4)).astype(np.float32)
    got = tfr.stream_backward_plain(cfg, *tin, torch.from_numpy(g_out))
    _loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, g_out=g_out)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal), mc=True)


def test_stream_loss_grad_plain_matches_jax_on_the_icosphere():
    jcfg, jin, cfg, tin = icosphere_case("cauchy")
    target = np.random.default_rng(3).uniform(
        size=(1, IMAGE, IMAGE, 3)).astype(np.float32)
    target_cm = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(target.reshape(1, -1, 3), -1, 1)))
    lscale = 1.0 / (IMAGE * IMAGE * 3)
    loss, *got = tfr.stream_loss_grad_plain(cfg, *tin, target_cm, "l1_rgb",
                                            lscale)
    w_loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, target=target,
                                             loss_kind="l1_rgb",
                                             lscale=lscale)
    np.testing.assert_allclose(loss.numpy(), w_loss, rtol=1e-5)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal), mc=True)
