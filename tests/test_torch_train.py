"""The port's pose-optimisation step against the JAX package's.

Three ``pose_step``s of the port and three steps of JAX's
``_make_pose_step`` (Adam, lr 5e-2) start from the same ``log_rot``,
target and estimator seed rows (JAX's own, derived from each step's keys)
on the cube at 16^2, GaussianRast + GaussianAgg, S=4.  JAX's per-step
gradients are read back from its optimizer and EMA state (Adam's first
moment and the smoothing EMA are 0.9 * old + 0.1 * g).

Tolerances: losses rtol 1e-5; the pose and sigma / gamma / alpha
gradients (MC: shared noise, ulp-level threshold flips) 1e-3 of their max
|grad|; ``log_rot`` after each Adam step atol 1e-6.  Plus the annealing
of ``optimize_pose``: past step 100 it divides sigma and gamma and doubles
the sample count."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.experiments import harness as jh
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.experiments import harness as th

from _torch_parity import (build, interpret_env, jax_inputs,  # noqa: F401
                           one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = 5e-2
LOG_ROT = np.array([[0.25, -0.15, 0.35]], np.float32)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


def _recover(new, old):
    """g from new = 0.9 * old + 0.1 * g."""
    return (np.asarray(new) - 0.9 * np.asarray(old)) / 0.1


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= rel * scale, (got, want)


def test_pose_steps_match_jax():
    mesh, cams, lights, jrend = build("gaussian", imsize=16, k=16, s=4,
                                      sigma=1e-2, gamma=5e-2)
    jrend = jrend.replace(rasterizer=jrend.rasterizer.update_blur(
        jrend.rasterizer.blur))
    target = np.random.default_rng(5).uniform(
        size=(1, 16, 16, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), 9).reshape(3, 3, 2)

    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    log_rot = jnp.asarray(LOG_ROT)
    zero = jnp.asarray(0.0)
    carry = (log_rot, opt.init(log_rot), jax.random.PRNGKey(0),
             jnp.asarray(np.inf), log_rot, jrend, (zero, zero, zero))
    step = jax.jit(jh._make_pose_step(cams, lights, opt))

    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(jrend, device="cpu")
    tcams, tlights = trend.rasterizer.cameras, trend.shader.lights
    state = th.PoseState.start(torch.from_numpy(LOG_ROT))
    topt = torch.optim.Adam([state.log_rot], lr=LR)

    mu_old, ema_old = np.zeros((1, 3)), np.zeros(3)
    for i in range(3):
        seeds = np.asarray(jax_inputs(mesh, jrend,
                                      key=(keys[i, 0], keys[i, 1]))[1][-1])
        carry, (loss, _gnorm) = step(mesh, jnp.asarray(target), carry,
                                     keys[i])
        mu = np.asarray(carry[1].inner_state[0].mu)
        ema = np.array([float(e) for e in carry[6]])
        tseeds = torch.from_numpy(np.array(seeds[:, 0, :4]))
        state, out = th.pose_step(tmesh, torch.from_numpy(target), state,
                                  trend, tcams, tlights, topt, tseeds,
                                  torch.zeros(1, 3))
        np.testing.assert_allclose(out.loss.item(), float(loss), rtol=1e-5)
        _close(out.g_pose.numpy(), _recover(mu, mu_old), 1e-3)
        _close([g.item() for g in out.g_smooth], _recover(ema, ema_old), 1e-3)
        np.testing.assert_allclose(state.log_rot.detach().numpy(),
                                   np.asarray(carry[0]), rtol=0, atol=1e-6)
        mu_old, ema_old = mu, ema
    assert state.best_loss.item() == pytest.approx(float(carry[3]), rel=1e-5)


def test_optimize_pose_anneals_past_step_100():
    """With adapt_reg, the boundary at step 101 (past 100, before the
    last) divides sigma by 1.1 and gamma by 1.5, sets blur from sigma and
    doubles S; the loop runs through with finite losses."""
    dev = "cpu"
    r, t = ptt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0,
                                      device=dev)
    cams = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=dev)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), device=dev)
    mesh = ptt.load_cube(device=dev).scale_verts(2.0)
    gen = torch.Generator().manual_seed(0)
    log_rot, (renderer,) = th.init_renderers(
        cams, lights, torch.eye(3)[None], gen, pert_init_intensity=20.0,
        sigma=1e-2, gamma=5e-2, nb_samples=2, noise_type=("gaussian",),
        imsize=8, faces_per_pixel=16)
    target = torch.full((8, 8, 3), 0.5)
    res = th.optimize_pose(mesh, cams, lights, log_rot, renderer, [target],
                           generator=gen, Niter=102, segment_size=101,
                           adapt_reg=True)
    assert res.nb_samples == [2, 4]
    assert res.losses.shape == (102,) and np.all(np.isfinite(res.losses))
    assert np.all(np.isfinite(res.grad_norms))
    assert len(res.runtimes["segment"]) == 2
    # The caller's renderer is unchanged.
    assert renderer.shader.get_nb_samples() == 2
    assert renderer.rasterizer.blur_override is None
