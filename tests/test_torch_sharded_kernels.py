"""The sample-sharded flat route's pieces in one process (no process
group): the seed offsets, and K11a, K3 with external coverage, K11b and
K11c's plain versions against the JAX package's sharded kernels.

* The seed words of rank d (``shard_seeds``) equal what the JAX
  ``_prepare_inputs`` gives device d of the sample axis under
  ``shard_map`` on 8 virtual devices, bit for bit, flat and stream.
* Per shard d in {0, 1, 3}, on the cube at 16^2 (one JAX tile), and at
  d = 1 on the cube moved up in a 48^2 image (two strip tiles, the second
  inactive): ``prob_plain`` against ``_pallas_prob``, ``forward_plain(...,
  prob=)`` against ``_pallas_forward(..., prob=)``, ``agg_bwd_plain``
  against ``_pallas_agg_bwd`` and ``det_bwd_plain`` against
  ``_pallas_det_bwd`` (interpret mode), each fed the JAX side's upstream
  outputs.  MC pairs share the noise: the coverage, image and weights by
  the MC image rule (mean |d| <= 1e-5, >= 99.9% of pixels within 1e-4),
  g_zmap, the gamma term and every gradient table within 1e-3 of its max.
* The mean over D = 4 shards of S = 2 samples (the coverage before the
  z_map, the image and weights, g_zmap and the gamma term, the gradients)
  equals the port's folded flat forward and backward at S = 8 within
  1e-6 of each output's max (power-of-two sample counts: the coverage and
  the weights fold exactly)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (KEY, assert_image_close, build, interpret_env,
                           jax_inputs, one_torch_thread, port_config,
                           port_inputs)
from test_torch_backward import assert_grads_close

AXIS = "samples"


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


def sharded_scene(noise="gaussian", imsize=16, s=2, shift=None, k=16,
                  mesh_kind="cube"):
    """(mesh, renderer) of the JAX package with both estimators sharding
    AXIS, two views."""
    mesh, _cams, _lights, renderer = build(noise, imsize=imsize, k=k, s=s,
                                           n_views=2, sigma=1e-2,
                                           gamma=5e-1, shift=shift,
                                           mesh_kind=mesh_kind)
    sh = renderer.shader
    shader = sh.replace(smoothrast=sh.smoothrast.replace(sample_axis=AXIS),
                        smoothagg=sh.smoothagg.replace(sample_axis=AXIS))
    return mesh, renderer.replace(shader=shader)


@pytest.mark.parametrize("kind", ["flat", "stream"])
def test_seed_offsets_match_jax_shard_map(kind):
    """Rank d's seed words equal JAX device d's under shard_map (8 virtual
    devices on the sample axis): flat offsets the coverage and
    aggregation words, stream the aggregation word only."""
    if kind == "flat":
        mesh, renderer = sharded_scene()
    else:
        mesh, renderer = sharded_scene(mesh_kind="icosphere", k=16)
    jcfg, jin = jax_inputs(mesh, renderer)
    assert jcfg.prob_ext and jcfg.stream == (kind == "stream")
    sh = renderer.shader
    settings = renderer.rasterizer.raster_settings

    def per_device(_):
        inputs = jfr._prepare_inputs(jcfg, mesh, sh.cameras, sh.lights,
                                     sh.materials, sh.smoothrast,
                                     sh.smoothagg, sh.blend_params, settings,
                                     KEY, "phong", sample_axis=AXIS)
        return inputs[-1][None, :, 0, :4]

    devices = np.asarray(jax.devices()[:8]).reshape(1, 8)
    got = np.asarray(jax.jit(jax.shard_map(
        per_device, mesh=Mesh(devices, ("data", AXIS)), in_specs=P(),
        out_specs=P(AXIS), check_vma=False))(jnp.zeros(())))
    base = torch.from_numpy(np.array(jin[-1][:, 0, :4]))
    cfg = port_config(jcfg)
    for d in range(8):
        want = got[d]
        mine = tfr.shard_seeds(cfg, base, d).numpy()
        np.testing.assert_array_equal(mine, want)
        assert d == 0 or (mine[:, 0] != base[:, 0].numpy()).all() == (
            kind == "flat")


def _tm(jcfg, x):
    """Port layout (N, rows, H * W) -> the JAX kernels' padded tile-major
    (N, rows, nt * p_tile)."""
    x = jax.vmap(lambda a: jfr._to_tilemajor(jcfg, a))(jnp.asarray(
        np.asarray(x)))
    hw = jcfg.image_size ** 2
    return jnp.pad(x, ((0, 0), (0, 0),
                       (0, jfr._n_tiles(jcfg) * jcfg.p_tile - hw)))


def _rm(jcfg, x):
    """The JAX kernels' tile-major (N, rows, nt * p_tile) -> (N, rows, H *
    W) as a tensor."""
    x = jax.vmap(lambda a: jfr._from_tilemajor(jcfg, a))(x)
    return torch.from_numpy(np.array(x[..., :jcfg.image_size ** 2]))


def _jax_shard(jcfg, jin, seeds, g_out):
    """The JAX sharded kernels of one shard (seed rows ``seeds``), each fed
    the previous one's output: (prob, (image, weights), (g_zmap, gamma
    term), gradients) in the port's layout."""
    fv_ndc, fv_world, fn, tex, valid, scal, _s = jin
    tabs = (fv_ndc, fv_world, fn, tex, valid, scal, seeds)
    act = jax.vmap(lambda v, va, s: jfr._active_tiles(
        jcfg, v, va, s[0, jfr._S_BLUR]))(fv_ndc, valid, scal)
    prob = jax.vmap(lambda v, va, s, sd, a: jfr._pallas_prob(
        jcfg, v, va, s, sd, a))(fv_ndc, valid, scal, seeds, act)
    out, weights = jax.vmap(lambda *a: jfr._pallas_forward(
        jcfg, *a[:8], prob=a[8]))(*tabs, act, prob)
    g_tm = _tm(jcfg, np.moveaxis(g_out.reshape(g_out.shape[0], -1, 4),
                                 -1, 1))
    gz, gg = jax.vmap(lambda *a: jfr._pallas_agg_bwd(jcfg, *a))(
        *tabs, act, prob, g_tm)
    grads = jax.vmap(lambda *a: jfr._pallas_det_bwd(jcfg, *a))(
        *tabs, act, prob, weights, gz, g_tm)
    n, s = g_out.shape[0], jcfg.image_size
    image = _rm(jcfg, out).transpose(1, 2).reshape(n, s, s, 4)
    grads = [np.asarray(x).reshape(n, x.shape[1], -1) if i < 4
             else np.asarray(x)[:, 0] for i, x in enumerate(grads)]
    return (_rm(jcfg, prob), (image, _rm(jcfg, weights)),
            (_rm(jcfg, gz), torch.from_numpy(np.array(gg[:, 0, 0]))), grads)


def _assert_fields_close(got, want):
    """(N, rows, P) fields by the MC image rule, per pixel over the rows."""
    assert_image_close(got.transpose(1, 2).numpy(),
                       want.transpose(1, 2).numpy(), mc=True)


def _assert_max_close(got, want, tol=1e-3):
    d = (got - want).abs().max().item()
    assert d <= tol * want.abs().max().item(), (d, want.abs().max().item())


CASES = [(0, 16, None), (1, 16, None), (3, 16, None),
         (1, 48, (0.0, 2.5, 0.0))]


@pytest.mark.parametrize("d,size,shift", CASES)
def test_sharded_kernels_plain_match_jax(d, size, shift):
    mesh, renderer = sharded_scene(imsize=size, shift=shift)
    jcfg, jin = jax_inputs(mesh, renderer)
    cfg, tin = port_config(jcfg), port_inputs(jcfg, jin)
    assert cfg.prob_ext and not cfg.stream
    if shift is not None:
        assert tin[7].tolist() == [[1, 0], [1, 0]]
    tabs, active = tin[:6], tin[7]
    seeds = tfr.shard_seeds(cfg, tin[6], d)
    jseeds = jin[6].at[:, 0, :4].set(jnp.asarray(seeds.numpy()))
    g_out = np.random.default_rng(7).normal(
        size=(2, size, size, 4)).astype(np.float32)
    g = torch.from_numpy(g_out)
    prob, (image, weights), (gz, gg), grads = _jax_shard(jcfg, jin, jseeds,
                                                         g_out)

    _assert_fields_close(tfr.prob_plain(cfg, tabs[0], tabs[4], tabs[5],
                                        seeds, active), prob)
    got_img, got_w = tfr.forward_plain(cfg, *tabs, seeds, active, prob)
    assert_image_close(got_img.numpy(), image.numpy(), mc=True)
    _assert_fields_close(got_w, weights)
    got_gz, got_gg = tfr.agg_bwd_plain(cfg, *tabs, seeds, active, prob, g)
    _assert_max_close(got_gz, gz)
    _assert_max_close(got_gg, gg)
    got = tfr.det_bwd_plain(cfg, *tabs, seeds, active, prob, weights, gz, g)
    assert_grads_close(got, grads, mc=True)
    if shift is not None:          # the empty tile's weights: background
        bg = weights[:, :, -1]
        assert bg.tolist() == [[float(r == cfg.bg_row)
                                for r in range(cfg.c_zpad)]] * 2


def test_mean_over_shards_is_the_folded_run():
    """D = 4 shards of S = 2 samples, averaged where the sharded route
    averages, against the folded run's forward_plain / backward_plain at
    S = 8 on the same seed words."""
    n_dev, s_local = 4, 2
    mesh, renderer = sharded_scene(s=s_local)
    jcfg, jin = jax_inputs(mesh, renderer)
    cfg, tin = port_config(jcfg), port_inputs(jcfg, jin)
    folded = dataclasses.replace(cfg, s_rast=n_dev * s_local,
                                 s_agg=n_dev * s_local, prob_ext=False)
    tabs, active = tin[:6], tin[7]
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 16, 16, 4)).astype(np.float32))
    shards = [tfr.shard_seeds(cfg, tin[6], d) for d in range(n_dev)]
    mean = lambda xs: sum(xs) / n_dev
    prob = mean([tfr.prob_plain(cfg, tabs[0], tabs[4], tabs[5], s, active)
                 for s in shards])
    outs = [tfr.forward_plain(cfg, *tabs, s, active, prob) for s in shards]
    image, weights = mean([o[0] for o in outs]), mean([o[1] for o in outs])
    aggs = [tfr.agg_bwd_plain(cfg, *tabs, s, active, prob, g)
            for s in shards]
    gz, gg = mean([a[0] for a in aggs]), mean([a[1] for a in aggs])
    dets = [tfr.det_bwd_plain(cfg, *tabs, s, active, prob, weights, gz, g)
            for s in shards]
    grads = [mean([x[i] for x in dets]) for i in range(5)]
    grads[4] = grads[4] + torch.where(
        torch.arange(34) == tfr._S_GAMMA, gg[:, None], 0.0)

    want_img = tfr.forward_plain(folded, *tin)
    assert image.abs().max() > 0
    torch.testing.assert_close(image, want_img, rtol=0, atol=1e-6)
    want = tfr.backward_plain(folded, *tin, g)
    for got_t, want_t in zip(grads, want):
        scale = max(want_t.abs().max().item(), 1e-30)
        assert (got_t - want_t).abs().max().item() <= 1e-6 * scale
    assert grads[4][:, tfr._S_SIGMA].abs().min() > 0
    assert grads[4][:, tfr._S_GAMMA].abs().min() > 0
