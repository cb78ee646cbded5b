"""The port's pose-optimisation step on the stream route against the JAX
package's.

Three ``pose_step``s of the port and three steps of JAX's
``_make_pose_step`` (Adam, lr 5e-2) start from the same ``log_rot``,
target and estimator seed rows on the cube with K=4 at 16^2 (F=12 > K:
both packages take the stream route, JAX's render loss is its stream
loss-and-grad kernel, the port's K7's plain version), GaussianRast +
GaussianAgg, S=4.  JAX's per-step gradients are read back from its
optimizer and EMA state, as in test_torch_train.py.

Tolerances: losses rtol 1e-5; the pose and sigma / gamma / alpha
gradients (MC: shared noise, ulp-level threshold flips) 1e-3 of their max
|grad|; ``log_rot`` after each Adam step atol 1e-6.  Plus the same scene
through ``MeshRenderer``: ``render_loss`` is the mean squared error of the
stream render, and its pose gradient equals the one of autograd through
the render (K5 forward, K6 backward)."""

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
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (build, interpret_env, jax_inputs, MC_NOISES,
                           one_torch_thread)
from test_torch_train import LOG_ROT, LR, _close, _recover


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


def _pose_steps_match_jax(noise, imsize, rw, **kw):
    """Three pose steps of both packages on a ``build`` scene at
    ``imsize``^2 (sigma 1e-2, gamma 5e-2), whose stream table holds ``rw``
    rows; gradients within 1e-3 (MC) or 1e-4 of their max |grad|."""
    tol = 1e-3 if noise in MC_NOISES else 1e-4
    mesh, cams, lights, jrend = build(noise, imsize=imsize, sigma=1e-2,
                                      gamma=5e-2, **kw)
    jrend = jrend.replace(rasterizer=jrend.rasterizer.update_blur(
        jrend.rasterizer.blur))
    target = np.random.default_rng(5).uniform(
        size=(1, imsize, imsize, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), 9).reshape(3, 3, 2)

    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)
    log_rot = jnp.asarray(LOG_ROT)
    zero = jnp.asarray(0.0)
    carry = (log_rot, opt.init(log_rot), jax.random.PRNGKey(0),
             jnp.asarray(np.inf), log_rot, jrend, (zero, zero, zero))
    step = jax.jit(jh._make_pose_step(cams, lights, opt))

    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(jrend, device="cpu")
    assert trend.plan(tmesh).mode == "stream"
    tcams, tlights = trend.rasterizer.cameras, trend.shader.lights
    state = th.PoseState.start(torch.from_numpy(LOG_ROT))
    topt = torch.optim.Adam([state.log_rot], lr=LR)

    mu_old, ema_old = np.zeros((1, 3)), np.zeros(3)
    for i in range(3):
        jcfg, jin = jax_inputs(mesh, jrend, key=(keys[i, 0], keys[i, 1]))
        assert jcfg.stream and jcfg.rw == rw
        seeds = np.asarray(jin[-1])
        carry, (loss, _gnorm) = step(mesh, jnp.asarray(target), carry,
                                     keys[i])
        mu = np.asarray(carry[1].inner_state[0].mu)
        ema = np.array([float(e) for e in carry[6]])
        tseeds = torch.from_numpy(np.array(seeds[:, 0, :4]))
        state, out = th.pose_step(tmesh, torch.from_numpy(target), state,
                                  trend, tcams, tlights, topt, tseeds,
                                  torch.zeros(1, 3))
        np.testing.assert_allclose(out.loss.item(), float(loss), rtol=1e-5)
        _close(out.g_pose.numpy(), _recover(mu, mu_old), tol)
        _close([g.item() for g in out.g_smooth], _recover(ema, ema_old), tol)
        np.testing.assert_allclose(state.log_rot.detach().numpy(),
                                   np.asarray(carry[0]), rtol=0, atol=1e-6)
        mu_old, ema_old = mu, ema
    assert state.best_loss.item() == pytest.approx(float(carry[3]), rel=1e-5)


def test_stream_pose_steps_match_jax():
    _pose_steps_match_jax("gaussian", 16, 64, k=4, s=4)


def test_stream_pose_steps_match_jax_on_the_icosphere():
    """1280 faces in 20 chunks, each tile visiting up to 20: the step's
    prepass (sort, chunk lists, the permutation's gradient) and the online
    softmax across chunks.  The deterministic SoftRast + SoftAgg pair: the
    MC pairs key their noise on the sorted row, and the float32 sort key
    (b * 8 + xn * 4) rounds the faces' left edges to ~8e-6, so an ulp of
    difference between the two packages' camera transforms can swap two
    faces of near-equal key, and with them their noise (seen at the third
    step here).  The MC terms across chunks are held on shared inputs in
    test_torch_stream_grads_cow.py and test_torch_stream_loss_grad_cow.py."""
    _pose_steps_match_jax("softras", 32, 1280, k=50, s=2,
                          mesh_kind="icosphere")


def test_stream_render_loss_matches_render_and_its_gradient():
    """Through MeshRenderer on the CPU: render_loss (K7's plain version)
    equals the mean squared error of the render (K5's), and the pose
    gradient of render_loss equals autograd through the render, whose
    backward is K6's plain version; no kernel is launched on the CPU."""
    mesh, _cams, _lights, jrend = build("cauchy", imsize=16, k=4, s=4)
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(jrend, device="cpu")
    seeds = tfr.draw_seeds(1, torch.Generator().manual_seed(9), device="cpu")
    target = torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(2))
    before = dict(tfr.launch_counts)

    def posed(log_rot):
        return tmesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                                   .transform_points(tmesh.verts))

    log_rot = torch.tensor([[0.1, 0.2, -0.1]], requires_grad=True)
    loss = trend.render_loss(posed(log_rot), target, seeds=seeds)
    (g_loss,) = torch.autograd.grad(loss, [log_rot])
    img = trend(posed(log_rot), seeds=seeds)
    mse = torch.mean((img[..., :3] - target) ** 2)
    torch.testing.assert_close(loss, mse, rtol=1e-5, atol=0)
    (g_img,) = torch.autograd.grad(mse, [log_rot])
    assert torch.isfinite(g_loss).all() and g_loss.abs().max() > 0
    _close(g_loss.numpy(), g_img.numpy(), 1e-4)
    assert tfr.launch_counts == before
