"""The port's strip rasterizer (``rasterize_planar_rows``, the config-5
oracle's path) against the JAX package's and against the same rows of the
port's full-image ``rasterize_planar``, and one tiny run of the port's
oracle script.

The scene is ``_torch_parity.staged_scene``'s (the mesh turned as data,
the camera down the z axis, so both packages project to the same bits)
with the level-2 icosphere at 32^2, K=6, N=2; the JAX side is compiled
without fused multiply-adds (``jax_exact``).  Selected faces are compared
exactly, zbuf / dists / barycentrics at the staged tolerance (1e-6).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pertrenderer_tpu as pt
import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.io import make_icosphere
from pertrenderer_tpu.ops.rasterize import (
    rasterize_planar_rows as jax_planar_rows)
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.experiments import oracle_config5
from pertrenderer_tpu_torch.ops.rasterize import rasterize_planar_rows
from _torch_parity import (_rotation, jax_exact,  # noqa: F401
                           one_torch_thread, staged_scene)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMSIZE, ROWS = 32, 8
STRIPS = (0, 13, 24)
FIELDS = ("zbuf", "dists", "w0", "w1", "w2")


@pytest.fixture(scope="module")
def scene():
    """The level-2 icosphere x2 turned to staged_scene's two poses, with
    its cameras and settings, in both packages."""
    _mesh, cameras, _lights, renderer = staged_scene(
        mesh_kind="cube", imsize=IMSIZE, k=6, sigma=2e-3)
    verts, faces = make_icosphere(2)
    ico = pt.Meshes(
        verts=jnp.asarray(np.stack([(2.0 * verts) @ _rotation(i + 1)
                                    for i in range(2)])),
        faces=jnp.repeat(jnp.asarray(faces)[None], 2, 0),
        num_verts=jnp.full((2,), verts.shape[0]),
        num_faces=jnp.full((2,), faces.shape[0]))
    settings = renderer.rasterizer.raster_settings
    return (ico, cameras, settings, convert.from_reference(ico, "cpu"),
            convert.from_reference(cameras, "cpu"),
            convert.from_reference(settings))


@pytest.mark.parametrize("row_start", STRIPS)
def test_strip_matches_jax_and_full_image(scene, row_start):
    mesh, cams, settings, tmesh, tcams, tsettings = scene
    rows = min(ROWS, IMSIZE - row_start)
    jfrag = jax_exact(lambda m, c: jax_planar_rows(m, c, settings, row_start,
                                                   rows), mesh, cams)
    tfrag = rasterize_planar_rows(tmesh, tcams, tsettings, row_start, rows)
    full = ptt.rasterize_planar(tmesh, tcams, tsettings)
    p2f = np.asarray(jfrag.pix_to_face)
    assert p2f.shape == (2, rows, IMSIZE, 6)
    assert (p2f >= 0).sum() > 50 and (p2f[..., 1] >= 0).any()
    np.testing.assert_array_equal(tfrag.pix_to_face.numpy(), p2f)
    sl = slice(row_start, row_start + rows)
    np.testing.assert_array_equal(tfrag.pix_to_face.numpy(),
                                  full.pix_to_face[:, sl].numpy())
    for name in FIELDS:
        got = getattr(tfrag, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jfrag, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got, getattr(full, name)[:, sl].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_strip_gradient_matches_full_image(scene):
    """The strip's derive carries the gradient to the vertices as the full
    image's does on the same rows (K9a / K9b's plain versions)."""
    _m, _c, _s, tmesh, tcams, tsettings = scene
    w = torch.rand(2, ROWS, IMSIZE, 6,
                   generator=torch.Generator().manual_seed(0))

    def grad(strip):
        verts = tmesh.verts.clone().requires_grad_(True)
        m = tmesh.update_padded(verts)
        if strip:
            frag = rasterize_planar_rows(m, tcams, tsettings, 13, ROWS)
        else:
            full = ptt.rasterize_planar(m, tcams, tsettings)
            frag = type(full)(*(x[:, 13:13 + ROWS] for x in (
                full.pix_to_face, full.zbuf, full.dists, full.w0, full.w1,
                full.w2)))
        empty = frag.pix_to_face < 0
        loss = sum(torch.sum(torch.where(empty, 0.0, getattr(frag, f)) * w)
                   for f in FIELDS)
        loss.backward()
        return verts.grad

    g_strip, g_full = grad(True), grad(False)
    assert g_strip.abs().max() > 0
    torch.testing.assert_close(g_strip, g_full, rtol=0,
                               atol=1e-6 * g_full.abs().max().item())


def test_oracle_script_tiny(tmp_path):
    """The oracle script's main on the level-2 icosphere at 24^2 (the
    stream route only: the binned route needs images above 128^2): K_exact
    above the count, the exact rung untruncated and equal to the stream
    render, the dual path and the strip gradient held."""
    out = tmp_path / "oracle.json"
    rec = oracle_config5.main(
        ["--image", "24", "--k", "8", "--k-exact", "8", "--level", "2",
         "--rc", "8", "--device", "cpu", "--no-full-staged", "--out",
         str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    ladder = rec["oracle_k_ladder"]
    assert ladder[0]["saturated"] and not ladder[-1]["saturated"]
    assert rec["grad_oracle_k"] > rec["count_max"]
    st = rec["modes"]["stream"]
    kx = str(rec["grad_oracle_k"])
    assert max(st["forward_max_abs_err_by_oracle_k"][kx].values()) <= 2e-5
    assert max(st["forward_max_abs_err_by_oracle_k"]["8"].values()) > 1e-2
    assert st["pose_grad_dual_path_rel_err"] <= 1e-5
    assert st["pose_grad_strip_parity_rel_err"] <= 1e-4
    assert set(rec["modes"]) == {"stream"}
