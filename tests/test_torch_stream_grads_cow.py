"""The stream route's backward on the cow (5120 faces in 80 chunks) at
48^2, S=2: ``stream_backward_plain`` (the plain version of K6) against
JAX's ``_pallas_stream_backward`` (interpret mode, the same inputs and
seed rows) for a seeded random cotangent, alpha included.

Tiles visit up to 80 chunks here, so the parts of the gradient that
depend on the chunk list run across chunks: the first-wins argmax with
its strict ``>`` between chunks, nreal and the variance-reduction
coefficient phi summed over the visited chunks, the exclusion products
of the alpha track.  The CauchyAgg, UniformRast and HardAgg pairs here;
test_torch_stream_loss_grad_cow.py holds the other three through K7's
plain version, which shares the sweeps.

Tolerances (``assert_grads_close``): each gradient table and each of the
34 scalar gradients within 1e-4 (deterministic pairs) or 1e-3 (MC pairs)
of its own max |grad|."""

import numpy as np
import pytest
import torch

from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (build, interpret_env, jax_inputs,
                           jax_stream_grads, MC_NOISES, one_torch_thread,
                           port_config, port_stream_inputs)
from test_torch_backward import assert_grads_close
from test_torch_stream_grads import split

IMAGE = 48


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


def cow_case(noise):
    """(JAX config, JAX inputs, port config, port inputs) of the cow at
    48^2 (strip tiles), K=50, S=2, sigma 1e-2; asserts that some tile
    visits several chunks."""
    mesh, _cams, _lights, renderer = build(noise, imsize=IMAGE, k=50, s=2,
                                           mesh_kind="cow")
    jcfg, jin = jax_inputs(mesh, renderer)
    assert jcfg.stream and jcfg.rw == 5120
    tin = port_stream_inputs(jcfg, jin)
    assert int((tin[2] * tin[3]).max()) > 1
    return jcfg, jin, port_config(jcfg), tin


@pytest.mark.parametrize("noise", ["cauchy", "uniform", "hard"])
def test_stream_backward_plain_matches_jax_on_the_cow(noise):
    jcfg, jin, cfg, tin = cow_case(noise)
    g_out = np.random.default_rng(0).normal(
        size=(1, IMAGE, IMAGE, 4)).astype(np.float32)
    got = tfr.stream_backward_plain(cfg, *tin, torch.from_numpy(g_out))
    _loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, g_out=g_out)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal),
                       noise in MC_NOISES)
