"""BASELINE config 2 on the port (experiments/config2.py) against the JAX
package's tests/test_silhouette.py.

The silhouette scene (the level-2 icosphere from dist 2.7, elev 10, azim
30) is JAX's, and its fragments equal JAX's (the JAX side compiled without
fused multiply-adds, ``jax_exact``; the camera's turn applied to the
vertices as data and the camera down the z axis, so both packages project
to the same bits).  The Monte-Carlo coverage is keyed on the
counter hash, not on threefry, so it is held in distribution: alpha =
1 - prod(1 - p) at S = 1024 against the same product of the exact
Gaussian coverage Phi(-d / sigma).  The JAX test's own criteria hold on
the port at its 48^2: the scale fit ends within 0.08 of 1, the gradient
variance falls with S by more than 4x from 4 to 64, and the gumbel
weights sum to 1 within 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import pertrenderer_tpu as pt
import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.io import make_icosphere
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.experiments import config2
from pertrenderer_tpu_torch.ops import fused_render
from _torch_parity import jax_exact, one_torch_thread  # noqa: F401

import jax.numpy as jnp

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMSIZE = 48


def _jax_scene():
    verts, faces = make_icosphere(2)
    mesh = pt.Meshes.create(verts, faces, textures=pt.TexturesVertex(
        jnp.ones((1, verts.shape[0], 3))))
    r, t = pt.look_at_view_transform(dist=2.7, elev=10.0, azim=30.0)
    return mesh, pt.PerspectiveCameras.create(R=r, T=t, fov=60.0)


def test_fragments_match_jax(scale=0.7):
    """The port's scene is JAX's: the same vertices, and the camera's
    rotation within 2 ulps and translation within 1e-6 (XLA's CPU sin /
    cos miss the correctly rounded value the port takes on some angles).
    With the camera's rotation applied to the vertices as data and a
    camera down the z axis at fov 50 and 64^2 (XLA rounds the pixel
    centres' division by 48 otherwise than the port, and its runtime
    tan(30 degrees) misses the correctly rounded value the port takes by
    an ulp, which parts zbuf by up to 2e-5), the selected faces are equal
    and the fragments within 1e-6."""
    jmesh, jcams = _jax_scene()
    mesh, cams = config2.scene("cpu")
    tcams = convert.from_reference(jcams, "cpu")
    np.testing.assert_array_equal(
        mesh.verts.numpy(), convert.from_reference(jmesh, "cpu").verts.numpy())
    np.testing.assert_array_max_ulp(cams.R.numpy(), tcams.R.numpy(), 2)
    np.testing.assert_allclose(cams.T.numpy(), tcams.T.numpy(), rtol=0,
                               atol=1e-6)
    verts = np.asarray(jmesh.verts[0]) @ np.asarray(jcams.R[0])
    dmesh = pt.Meshes.create(verts.astype(np.float32), jmesh.faces[0],
                             textures=jmesh.textures)
    r, t = pt.look_at_view_transform(dist=2.7, elev=0.0, azim=0.0)
    dcams = pt.PerspectiveCameras.create(R=r, T=t, fov=50.0)
    settings = config2.settings(64)
    jfrag = jax_exact(lambda m, c: pt.rasterize_meshes(
        m.scale_verts(scale), c, convert_settings(settings)), dmesh, dcams)
    tfrag = ptt.rasterize_meshes(
        convert.from_reference(dmesh, "cpu").scale_verts(scale),
        convert.from_reference(dcams, "cpu"), settings)
    p2f = np.asarray(jfrag.pix_to_face)
    assert (p2f >= 0).sum() > 500 and (p2f[..., 1] >= 0).any()
    np.testing.assert_array_equal(tfrag.pix_to_face.numpy(), p2f)
    for name in ("zbuf", "dists", "bary_coords"):
        np.testing.assert_allclose(getattr(tfrag, name).numpy(),
                                   np.asarray(getattr(jfrag, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def convert_settings(settings):
    """The JAX package's RasterizationSettings with the port's fields."""
    return pt.RasterizationSettings(
        image_size=settings.image_size, blur_radius=settings.blur_radius,
        faces_per_pixel=settings.faces_per_pixel)


def _rasterize(mesh, cams, scale):
    return ptt.rasterize_meshes(mesh.scale_verts(scale), cams,
                                config2.settings(IMSIZE))


def test_alpha_in_distribution():
    """alpha from S = 1024 hash draws per slot against 1 - prod(1 -
    Phi(-d / sigma)): every pixel within 6 standard errors (a slot's p_hat
    has variance p (1 - p) / S; at least one draw's 1 / S), and the band's
    mean error within 6 standard errors of the mean."""
    mesh, cams = config2.scene("cpu")
    s_count = 1024
    seeds = fused_render.draw_seeds(1, torch.Generator().manual_seed(3),
                                    device="cpu")
    got = config2.alpha(mesh, cams, 1.0, seeds, IMSIZE,
                        nb_samples=s_count)[0].double()
    frags = _rasterize(mesh, cams, 1.0)
    mask = frags.pix_to_face >= 0
    d = frags.dists.double()
    phi = 0.5 * torch.erfc(d / (config2.SIGMA * math.sqrt(2.0)))
    p = torch.where(mask, phi, 0.0)[0]
    want = 1.0 - torch.prod(1.0 - p, dim=-1)
    # The product's standard error: each factor's std sqrt(p (1 - p) / S)
    # times the other factors (at most 1).
    se = torch.sqrt(torch.sum(p * (1.0 - p), dim=-1) / s_count)
    band = (want > 1e-3) & (want < 1.0 - 1e-3)
    assert band.sum() > 50
    z = (got - want) / torch.clamp(se, min=1.0 / s_count)
    assert z.abs().max() < 6.0, z.abs().max()
    assert abs(z[band].mean().item()) < 6.0 / math.sqrt(band.sum().item())


def test_scale_fit_and_variance_criteria():
    """The JAX test's criteria on the port at 48^2."""
    mesh, cams = config2.scene("cpu")
    scale, losses = config2.fit_scale(mesh, cams, IMSIZE,
                                      torch.Generator().manual_seed(0))
    assert abs(scale - 1.0) < 0.08, scale
    assert losses[-1] < losses[0]
    v = config2.gradient_variance(*config2.synthetic_field("cpu"),
                                  torch.Generator().manual_seed(1))
    assert v[0] > v[1] > v[2] and v[0] / v[2] > 4.0, v
    v = config2.gradient_variance(*config2.scene_dists(mesh, cams, IMSIZE),
                                  torch.Generator().manual_seed(2),
                                  words=12)
    assert v[0] > v[1] > v[2] and v[0] / v[2] > 4.0, v


def test_gumbel_weights_sum_to_one():
    mesh, cams = config2.scene("cpu")
    seeds = fused_render.draw_seeds(1, torch.Generator().manual_seed(0),
                                    device="cpu")
    w = config2.gumbel_weights(mesh, cams, 32, seeds)
    assert w.shape == (1, 32, 32, config2.K + 1)
    assert torch.isfinite(w).all()
    torch.testing.assert_close(w.sum(-1), torch.ones(1, 32, 32), rtol=0,
                               atol=1e-5)
    assert (w[..., :-1] > 0).any() and (w[..., :-1] < 1).any()
