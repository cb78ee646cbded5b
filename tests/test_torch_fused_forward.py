"""K3's plain version (``forward_plain``) against the JAX fused forward.

Each case feeds the JAX package's own ``_prepare_inputs`` outputs, seed
rows included, into the port and compares with the image JAX renders
(interpret mode, tile packing off — the port keys MC noise on unpacked
slot rows).  Deterministic menu pairs: atol 2e-5.  MC pairs draw the same
noise, so they differ only by ulp-level threshold flips: mean |d| <= 1e-5
and >= 99.9% of pixels within 1e-4."""

import numpy as np
import pytest

from pertrenderer_tpu.experiments.harness import NOISE_MENU
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (KEY, MC_NOISES, assert_image_close,  # noqa: F401
                           build, interpret_env, jax_inputs, one_torch_thread,
                           port_config, port_inputs)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


def _case(noise, **kw):
    mesh, cameras, lights, renderer = build(noise, **kw)
    want = np.asarray(renderer(mesh, key=KEY))
    jcfg, jin = jax_inputs(mesh, renderer)
    return port_config(jcfg), port_inputs(jcfg, jin), want


@pytest.mark.parametrize("noise", NOISE_MENU)
def test_forward_plain_matches_jax_menu(noise):
    cfg, inputs, want = _case(noise)
    got = tfr.forward_plain(cfg, *inputs).numpy()
    assert (want[..., 3] > 0.5).sum() > 20           # the cube is visible
    assert_image_close(got, want, noise in MC_NOISES)


@pytest.mark.parametrize("noise,kw", [
    ("softras", dict(lights_kind="directional")),
    ("gaussian", dict(textures="vertex")),
    ("softras", dict(shade="simple")),
    ("cauchy", dict(perspective_correct=True)),
    ("hard", dict(cull=True)),
    ("uniform", dict(textures="atlas4")),
    ("gaussian", dict(n_views=2, imsize=12)),
])
def test_forward_plain_matches_jax_variants(noise, kw):
    cfg, inputs, want = _case(noise, **kw)
    got = tfr.forward_plain(cfg, *inputs).numpy()
    assert_image_close(got, want, noise in MC_NOISES)


def test_forward_plain_matches_jax_classic_background_row():
    """F = f_pad = 16: the background channel sits below the slots (row 16)
    and the z_map block, with its argmax noise, has 24 rows."""
    cfg, inputs, want = _case("gaussian", textures="vertex", faces16=True)
    assert (cfg.f_real, cfg.bg_row, cfg.c_zpad) == (16, 16, 24)
    got = tfr.forward_plain(cfg, *inputs).numpy()
    assert_image_close(got, want, mc=True)
