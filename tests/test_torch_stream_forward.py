"""The stream route's forward (``stream_forward_plain``, the plain
version of K5) against the JAX stream forward kernel
(``_pallas_stream_forward`` in interpret mode), on the same inputs and
seed rows: every menu pair on the cube with K=4 at 16^2 (F=12 > K
streams in one chunk; two views), two on the icosphere (1280 faces, 20
chunks) at 32^2 and the gaussian pair on the cow (5120 faces, 80 chunks,
strip tiles) at 48^2, S=2.

Tolerances (``assert_image_close``): deterministic pairs atol 2e-5; MC
pairs draw the same noise rows and differ only by ulp-level threshold
flips, mean |d| <= 1e-5 and at least 99.9% of pixels within 1e-4."""

import numpy as np
import pytest

from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (assert_image_close, build, interpret_env,
                           jax_inputs, jax_stream_forward, MC_NOISES,
                           one_torch_thread, port_config, port_stream_inputs)

MENU = ("softras", "gaussian", "gaussian_wovr", "cauchy", "uniform", "hard")
SCENES = {"cube": (16, 4, 2), "icosphere": (32, 50, 1), "cow": (48, 50, 1)}


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


def stream_case(noise, kind):
    imsize, k, views = SCENES[kind]
    mesh, _cams, _lights, renderer = build(noise, imsize=imsize, k=k, s=2,
                                           mesh_kind=kind, n_views=views)
    jcfg, jin = jax_inputs(mesh, renderer)
    assert jcfg.stream
    return jcfg, jin, port_config(jcfg), port_stream_inputs(jcfg, jin)


@pytest.mark.parametrize("noise,kind", [(n, "cube") for n in MENU] + [
    (n, "icosphere") for n in ("softras", "cauchy")])
def test_stream_forward_plain_matches_jax(noise, kind):
    jcfg, jin, cfg, tin = stream_case(noise, kind)
    got = tfr.stream_forward_plain(cfg, *tin).numpy()
    assert_image_close(got, jax_stream_forward(jcfg, jin),
                       mc=noise in MC_NOISES)


def test_stream_forward_plain_matches_jax_on_the_cow():
    """The config-3 asset: 80 chunks, strip tiles, inactive tiles, a 4 x 4
    UV atlas; the gaussian pair."""
    noise = "gaussian"
    jcfg, jin, cfg, tin = stream_case(noise, "cow")
    assert 0 < int(tin[3].sum()) < tin[3].numel()
    got = tfr.stream_forward_plain(cfg, *tin).numpy()
    assert_image_close(got, jax_stream_forward(jcfg, jin),
                       mc=noise in MC_NOISES)


def test_stream_wrapper_takes_the_plain_version_on_the_cpu():
    _jcfg, _jin, cfg, tin = stream_case("gaussian", "cube")
    before = dict(tfr.launch_counts)
    np.testing.assert_array_equal(tfr.fused_stream_forward(cfg, *tin),
                                  tfr.stream_forward_plain(cfg, *tin))
    assert tfr.launch_counts == before
