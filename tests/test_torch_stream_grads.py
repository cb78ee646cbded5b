"""The stream route's backward on the cube with K=4 at 16^2 (F=12 > K: one
chunk, two tiles), every menu pair:

* ``stream_backward_plain`` (the plain version of K6) against JAX's
  ``_pallas_stream_backward`` (interpret mode, same inputs and seed rows)
  for a seeded random cotangent, alpha included;
* a tile marked inactive that has chunks in its list takes the JAX
  kernels' ``bg_only`` branch: background image, background gradient.

test_torch_stream_loss_grad.py holds K7's plain version.  Tolerances: each
gradient table (the sorted table's ndc, world, normal and texel columns)
and each of the 34 scalar gradients within 1e-4 (deterministic pairs) or
1e-3 (MC pairs, same noise, ulp-level threshold flips) of its own max
|grad| (``assert_grads_close``)."""

import numpy as np
import pytest
import torch

from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (assert_image_close, build, interpret_env,
                           jax_inputs, jax_stream_forward, jax_stream_grads,
                           MC_NOISES, one_torch_thread, port_config,
                           port_stream_inputs)
from test_torch_backward import assert_grads_close

MENU = ("softras", "gaussian", "gaussian_wovr", "cauchy", "uniform", "hard")
IMAGE = 16


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


def split(cfg, g_tab, g_scal):
    """The sorted gradient table as the four tables, plus g_scal."""
    g_tab = np.asarray(g_tab)
    td = cfg.tex_d
    return [g_tab[..., :9], g_tab[..., 9:18], g_tab[..., 18:27],
            g_tab[..., 27:27 + td], np.asarray(g_scal)]


def cube_case(noise, n_views=1, **kw):
    mesh, _cams, _lights, renderer = build(noise, imsize=IMAGE, k=4, s=4,
                                           n_views=n_views, **kw)
    jcfg, jin = jax_inputs(mesh, renderer)
    assert jcfg.stream and jcfg.rw == 64
    return jcfg, jin, port_config(jcfg), port_stream_inputs(jcfg, jin)


def _g_out(n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, IMAGE, IMAGE, 4)).astype(np.float32)


@pytest.mark.parametrize("noise", MENU)
def test_stream_backward_plain_matches_jax(noise):
    jcfg, jin, cfg, tin = cube_case(noise)
    g_out = _g_out(tin[0].shape[0])
    got = tfr.stream_backward_plain(cfg, *tin, torch.from_numpy(g_out))
    _loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, g_out=g_out)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal),
                       noise in MC_NOISES)


def test_inactive_tile_with_chunks_takes_background_only():
    """Mark one of the two tiles inactive although its list holds the
    chunk: JAX's kernels and the port's plain versions both give that
    tile the background image, alpha 0, and only the background colour's
    gradient; the other tile is unchanged.  The MC aggregation without
    variance reduction, whose score term would leave a gamma gradient on
    a no-candidate pixel run through the pipeline."""
    noise = "gaussian_wovr"
    jcfg, jin, cfg, tin = cube_case(noise)
    count = np.asarray(jin[3]).reshape(-1)
    assert count[0] > 0
    active = np.array(jin[4])
    active.reshape(-1)[0] = 0
    jin = list(jin)
    jin[4] = active
    tin = list(tin)
    tin[3] = torch.from_numpy(active.reshape(1, -1).copy())
    img = tfr.stream_forward_plain(cfg, *tin)
    assert_image_close(img.numpy(), jax_stream_forward(jcfg, jin), mc=True)
    tile0 = (tfr._pixel_tiles(cfg, "cpu") == 0).view(IMAGE, IMAGE)
    bg = tin[4][0, tfr._S_BG:tfr._S_BG + 3]
    torch.testing.assert_close(img[0][tile0][:, :3],
                               bg.expand(int(tile0.sum()), 3))
    assert torch.count_nonzero(img[0][tile0][:, 3]) == 0
    g_out = _g_out(1, seed=5)
    got = tfr.stream_backward_plain(cfg, *tin, torch.from_numpy(g_out))
    _loss, w_tab, w_scal = jax_stream_grads(jcfg, jin, g_out=g_out)
    assert_grads_close(split(cfg, *got), split(cfg, w_tab, w_scal), mc=True)
    # Only tile 0's cotangent: the background colour gradient alone.
    g_out[0][~tile0.numpy()] = 0.0
    g_tab, g_scal = tfr.stream_backward_plain(cfg, *tin,
                                              torch.from_numpy(g_out))
    assert torch.count_nonzero(g_tab) == 0
    want = torch.zeros(1, 34)
    want[0, tfr._S_BG:tfr._S_BG + 3] = torch.from_numpy(
        g_out[0][tile0.numpy()][:, :3].sum(axis=0))
    torch.testing.assert_close(g_scal, want, rtol=1e-6, atol=1e-6)
