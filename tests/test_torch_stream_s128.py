"""The stream route above 64 aggregation samples: the cube with K=4 at
16^2 (F = 12 > K: one chunk, two tiles), GaussianRast + GaussianAgg at
S = 128, which ``optimize_pose``'s annealing reaches
(``anneal_sample_cap``).  The card's kernels run the samples in passes of
64 (csrc/stream_grad.cuh ``stream_passes``); on the CPU the wrappers take
the plain versions, held here against JAX's stream kernels (interpret
mode, same inputs and seed rows), which loop over any S:

* both packages plan the stream route;
* K5's image (``assert_image_close``, MC);
* K6's gradients for a seeded cotangent and K7's loss (rtol 1e-5) and
  gradients: each table and scalar within 1e-3 of its own max
  (``assert_grads_close``, MC).

tests/test_torch_stream_host.py holds the passes themselves (the kernels'
pipeline compiled with g++) against the plain versions at S = 128."""

import numpy as np
import pytest
import torch

from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (assert_image_close, build, interpret_env,
                           jax_inputs, jax_stream_forward, jax_stream_grads,
                           one_torch_thread, port_config, port_stream_inputs)
from test_torch_backward import assert_grads_close
from test_torch_stream_grads import IMAGE, split
from test_torch_stream_loss_grad import _target, _target_cm

S = 128


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


@pytest.fixture(scope="module")
def case():
    with pytest.MonkeyPatch.context() as mp:
        interpret_env(mp)
        mesh, _cams, _lights, renderer = build("gaussian", imsize=IMAGE,
                                               k=4, s=S)
        jcfg, jin = jax_inputs(mesh, renderer)
    return (mesh, renderer, jcfg, jin, port_config(jcfg),
            port_stream_inputs(jcfg, jin))


def test_render_plan_at_128_samples_is_the_stream_route(case):
    mesh, renderer, jcfg, _jin, cfg, _tin = case
    sh = renderer.shader
    want = jfr.render_plan(mesh, sh.cameras, sh.lights, sh.materials,
                           sh.smoothrast, sh.smoothagg,
                           renderer.rasterizer.raster_settings)
    got = convert.from_reference(renderer, device="cpu").plan(
        convert.from_reference(mesh, device="cpu"))
    assert got.mode == want.mode == "stream"
    assert jcfg.stream and cfg.stream and cfg.s_agg == jcfg.s_agg == S


def test_stream_forward_at_128_samples_matches_jax(case):
    _mesh, _renderer, jcfg, jin, cfg, tin = case
    got = tfr.fused_stream_forward(cfg, *tin).numpy()
    assert_image_close(got, jax_stream_forward(jcfg, jin), mc=True)


def test_stream_backward_at_128_samples_matches_jax(case):
    _mesh, _renderer, jcfg, jin, cfg, tin = case
    g_out = np.random.default_rng(0).normal(
        size=(tin[0].shape[0], IMAGE, IMAGE, 4)).astype(np.float32)
    got = tfr.fused_stream_backward(cfg, *tin, torch.from_numpy(g_out))
    _loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, g_out=g_out)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal), True)


def test_stream_loss_grad_at_128_samples_matches_jax(case):
    _mesh, _renderer, jcfg, jin, cfg, tin = case
    n = tin[0].shape[0]
    target = _target(n)
    lscale = 1.0 / (n * IMAGE * IMAGE * 3)
    loss, *got = tfr.fused_stream_loss_grad(cfg, *tin, _target_cm(target),
                                            "l2_rgb", lscale)
    w_loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, target=target,
                                             loss_kind="l2_rgb",
                                             lscale=lscale)
    np.testing.assert_allclose(loss.numpy(), w_loss, rtol=1e-5)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal), True)
