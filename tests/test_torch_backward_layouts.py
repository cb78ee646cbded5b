"""K4's plain version against the JAX fused backward on the layouts and
options the menu cases do not reach: the background row appended below
16 slots, per-corner and 4x4-atlas texels, a directional light,
perspective correction, back-face culling and no shading.  Same
tolerances as test_torch_backward.py."""

import pytest
import torch

from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (MC_NOISES, interpret_env,  # noqa: F401
                           one_torch_thread)
from test_torch_backward import (_case, _g_out, assert_grads_close,
                                 jax_backward)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


@pytest.mark.parametrize("noise,kw", [
    # Background row appended below 16 slots, per-corner texels, a
    # directional light, perspective correction.
    ("gaussian", dict(textures="vertex", faces16=True,
                      lights_kind="directional", perspective_correct=True)),
    # An atlas of 4x4 texels, back-face culling, no shading.
    ("softras", dict(textures="atlas4", cull=True, shade="simple")),
])
def test_backward_plain_matches_jax_layouts(noise, kw):
    jcfg, jin, cfg, tin = _case(noise, **kw)
    if kw.get("faces16"):
        assert (cfg.f_real, cfg.bg_row, cfg.c_zpad) == (16, 16, 24)
    g = _g_out(tin[0].shape[0], seed=1)
    got = tfr.backward_plain(cfg, *tin, torch.from_numpy(g))
    assert_grads_close(got, jax_backward(jcfg, jin, g), noise in MC_NOISES)
