"""BASELINE config 4 on the port (experiments/config4.py) against the JAX
package's tests/test_multiview.py: the cube x2 in N=2 views at 32^2,
GaussianRast + GaussianAgg at S=4 (sigma 1e-4, gamma 1e-3, blur 1e-4), on
both fused routes (K=8: stream; K=50: flat), against a random target
(a render of the true pose would cost the JAX side another interpreted
render).

The JAX side runs its fused kernels in interpret mode with tile packing
off, compiled at XLA optimisation level 0 (``jax_exact``); both packages
draw with JAX's seed words.  Images at the MC image rule
(``assert_image_close``), the loss at rtol 1e-5 and the joint gradients of
``log_rot`` and the per-vertex ``deform`` within 1e-3 of their max (MC
pairs on shared noise differ only by threshold flips; ROADMAP's parity
rule 4).  The port's own scene (``config4.scene``) is JAX's up to the
last places of its cameras (XLA's CPU sin / cos).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pertrenderer_tpu as pt
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu.transforms import Rotate, so3_exp_map
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.experiments import config4
from _torch_parity import (assert_image_close, interpret_env,  # noqa: F401
                           jax_exact, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, IMSIZE = 2, 32
LOG_ROT = np.array([[0.1, -0.2, 0.15]], np.float32)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


def _jax_scene(k):
    mesh = pt.load_cube().scale_verts(2.0).extend(N)
    elev = jnp.linspace(10.0, 60.0, N)
    azim = jnp.linspace(0.0, 315.0, N)
    r, t = pt.look_at_view_transform(dist=6.7, elev=elev, azim=azim)
    cams = pt.PerspectiveCameras.create(R=r, T=t, fov=60.0)
    lights = pt.PointLights.create(location=(0.0, 2.0, -2.0), batch=N)
    settings = pt.RasterizationSettings(image_size=IMSIZE, blur_radius=1e-4,
                                        faces_per_pixel=k)
    renderer = pt.MeshRenderer.create(
        rasterizer=pt.MeshRasterizer.create(cameras=cams,
                                            raster_settings=settings),
        shader=pt.RandomPhongShader.create(
            cameras=cams, lights=lights,
            blend_params=pt.BlendParams(sigma=1e-4, gamma=1e-3,
                                        background_color=(0.0, 0.0, 0.0)),
            smoothrast=pt.GaussianRast.create(sigma=1e-4, nb_samples=4),
            smoothagg=pt.GaussianAgg.create(gamma=1e-3, nb_samples=4)))
    return mesh, cams, lights, renderer


def _seed_words(k):
    """(N, 2) int32: the seed words JAX's _prepare_inputs draws from key k
    for each batch element."""
    return np.array([[int(w) for w in jfr._key_words(jax.random.fold_in(k, i))]
                     for i in range(N)], np.int32)


def _close(got, want, rel=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and np.abs(want).sum() > 0
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (got, want)


@pytest.mark.parametrize("k,route", [(8, "stream"), (50, "flat")])
def test_joint_pose_deform_matches_jax(k, route):
    mesh, cams, lights, jrend = _jax_scene(k)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    targets = np.random.default_rng(5).uniform(
        size=(N, IMSIZE, IMSIZE, 3)).astype(np.float32)
    deform0 = np.random.default_rng(0).normal(
        0.0, 0.02, (mesh.max_verts, 3)).astype(np.float32)
    key = (keys[0], keys[1])

    def predict(log_rot, deform):
        rot = so3_exp_map(log_rot)
        return mesh.update_padded(Rotate(jnp.repeat(rot, N, 0))
                                  .transform_points(mesh.verts + deform[None]))

    def loss_fn(log_rot, deform):
        imgs = jrend(predict(log_rot, deform), key=key, cameras=cams,
                     lights=lights)
        return jnp.mean((imgs[..., :3] - targets) ** 2), imgs

    (jloss, jimg), jgrads = jax_exact(
        jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True),
        jnp.asarray(LOG_ROT), jnp.asarray(deform0))
    seeds = torch.from_numpy(np.stack([_seed_words(k) for k in key], 1)
                             .reshape(N, 4))

    tmesh = convert.from_reference(mesh, "cpu")
    trend = convert.from_reference(jrend, "cpu")
    assert trend.plan(tmesh).mode == route
    ttarget = torch.from_numpy(targets)
    (tloss_one, *tgrads), (tloss_two, *tgrads_two) = config4.dual_path(
        tmesh, trend, ttarget, torch.from_numpy(LOG_ROT),
        torch.from_numpy(deform0), seeds)
    timg = trend(config4.predict(tmesh, torch.from_numpy(LOG_ROT),
                                 torch.from_numpy(deform0)), seeds=seeds)
    assert_image_close(timg.detach().numpy(), jimg, mc=True)
    np.testing.assert_allclose(tloss_one.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tloss_two.item(), float(jloss), rtol=1e-5)
    for got, got_two, want in zip(tgrads, tgrads_two, jgrads):
        _close(got.numpy(), want)
        _close(got_two.numpy(), want)


def test_port_scene_is_jax_scene():
    """config4.scene builds test_multiview's scene: the same cube, lights
    and settings; the cameras within 2 ulps of rotation and 1e-6 of
    translation."""
    mesh, cams, lights, jrend = _jax_scene(50)
    tmesh, tcams, tlights, trend = config4.scene(N, IMSIZE, 50, "cpu")
    ref = convert.from_reference(mesh, "cpu")
    assert torch.equal(tmesh.verts, ref.verts)
    assert torch.equal(tmesh.faces, ref.faces)
    rcams = convert.from_reference(cams, "cpu")
    np.testing.assert_array_max_ulp(tcams.R.numpy(), rcams.R.numpy(), 2)
    np.testing.assert_allclose(tcams.T.numpy(), rcams.T.numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(tlights.location,
                       convert.from_reference(lights, "cpu").location)
    assert (trend.rasterizer.raster_settings
            == convert.from_reference(jrend.rasterizer.raster_settings))
    sh, rsh = trend.shader, convert.from_reference(jrend, "cpu").shader
    assert float(sh.smoothrast.sigma) == float(rsh.smoothrast.sigma)
    assert float(sh.smoothagg.gamma) == float(rsh.smoothagg.gamma)
    assert sh.smoothrast.nb_samples == rsh.smoothrast.nb_samples == 4


def test_optimize_runs_and_repeats():
    """Five joint steps on the port at N=2, 32^2 (flat) from
    ``config4.problem``'s start: finite losses, both parameters move, a
    second run bit-equal."""
    mesh, rend, r_true, target, log_rot0, _seeds0 = config4.problem(
        N, IMSIZE, 50, "cpu")
    assert rend.plan(mesh).mode == "flat"
    assert abs(config4.angle_deg(log_rot0, r_true) - 20.0) < 1e-3
    runs = [config4.optimize(mesh, rend, target, log_rot0, 5,
                             torch.Generator().manual_seed(2))
            for _ in range(2)]
    (lr_a, df_a, loss_a, _), (lr_b, df_b, loss_b, _) = runs
    assert np.isfinite(loss_a).all() and loss_a[-1] < loss_a[0]
    assert not torch.equal(lr_a, log_rot0) and df_a.abs().sum() > 0
    assert torch.equal(lr_a, lr_b) and torch.equal(df_a, df_b)
    assert np.array_equal(loss_a, loss_b)
    assert config4.angle_deg(lr_a, r_true) < config4.angle_deg(log_rot0,
                                                               r_true)
