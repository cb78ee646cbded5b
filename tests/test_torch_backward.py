"""K4's plain version (``backward_plain``) against the JAX fused backward,
for the MC menu pairs (test_torch_backward_det.py holds the
deterministic pairs and the layout variants).

Each case feeds the JAX package's own ``_prepare_inputs`` outputs, seed
rows included, into the port and compares the table and scalar
gradients of a seeded random output cotangent (alpha included) with
``_pallas_backward`` (interpret mode, packing off), which is what
``jax.vjp`` of ``_fused_core`` returns.  At 16^2 the image is one JAX
tile and the cube covers it, so JAX runs its full pipeline on every
pixel, as the port does.

Tolerances, per gradient table, relative to the table's max |grad|:
deterministic pairs 1e-4; MC pairs draw the same noise and differ only by
ulp-level threshold flips, 1e-3 (the count of entries beyond 1e-5 is
reported in the failure message)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (MC_NOISES, build, interpret_env,  # noqa: F401
                           jax_inputs, one_torch_thread, port_config,
                           port_inputs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TABLES = ("g_ndc", "g_world", "g_fn", "g_tex", "g_scal")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


def jax_backward(jcfg, jin, g_out):
    """JAX ``_pallas_backward`` per batch element (its custom VJP's rule)
    for a (N, H, W, 4) cotangent; tables in the port's layout."""
    n, hw = g_out.shape[0], g_out.shape[1] * g_out.shape[2]
    g_cm = jnp.moveaxis(jnp.asarray(g_out).reshape(n, hw, 4), -1, 1)
    g_cm = jnp.pad(g_cm, ((0, 0), (0, 0),
                          (0, jfr._n_tiles(jcfg) * jcfg.p_tile - hw)))

    def one(fv_ndc, fv_world, fn, tex, valid, scal, seeds, g):
        active, pack = jfr._active_and_pack(jcfg, fv_ndc, valid,
                                            scal[0, jfr._S_BLUR])
        return jfr._pallas_backward(jcfg, fv_ndc, fv_world, fn, tex, valid,
                                    scal, seeds, active, g, pack=pack)

    out = jax.vmap(one)(*jin, g_cm)
    return [np.asarray(x).reshape(x.shape[0], x.shape[1], -1)
            if i < 4 else np.asarray(x)[:, 0] for i, x in enumerate(out)]


def assert_grads_close(got, want, mc: bool, names=TABLES):
    """Each table within 1e-4 (deterministic) or 1e-3 (MC) of its own max
    |grad|, and each of the 34 scalar gradients (g_scal, (N, 34)) within
    that share of its own max |grad| over N, floored at 1e-6 of the table's
    max for columns that are 0 in the reference; all finite."""
    tol = 1e-3 if mc else 1e-4
    for name, g, w in zip(names, got, want):
        g = np.asarray(g)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.all(np.isfinite(g)), name
        d = np.abs(g - w)
        if name == "g_scal":
            scale = np.abs(w).max(axis=0)
            scale = np.maximum(np.maximum(scale, 1e-6 * scale.max()), 1e-30)
            col = d.max(axis=0) / scale
            assert col.max() <= tol, (name, int(col.argmax()), col.max())
            continue
        scale = float(np.abs(w).max())
        flips = int(np.sum(d > 1e-5 * scale))
        assert d.max() <= tol * scale, (name, d.max(), scale, flips)


def _case(noise, **kw):
    mesh, _cams, _lights, renderer = build(noise, **kw)
    jcfg, jin = jax_inputs(mesh, renderer)
    return jcfg, jin, port_config(jcfg), port_inputs(jcfg, jin)


def _g_out(n, s=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, s, s, 4)).astype(
        np.float32)


@pytest.mark.parametrize("noise", MC_NOISES)
def test_backward_plain_matches_jax_menu(noise):
    check_menu_pair(noise)


def check_menu_pair(noise):
    jcfg, jin, cfg, tin = _case(noise)
    g = _g_out(tin[0].shape[0])
    got = tfr.backward_plain(cfg, *tin, torch.from_numpy(g))
    want = jax_backward(jcfg, jin, g)
    assert np.abs(want[0]).max() > 0 and np.abs(want[4]).max() > 0
    assert_grads_close(got, want, noise in MC_NOISES)
