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

import dataclasses

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


_JAX_RUNS = {}


def _jax_steps(noise, imsize, rw, route, settings, kw):
    """JAX's three pose steps on a ``build`` scene at ``imsize``^2 (sigma
    1e-2, gamma 5e-2), its step compiled at XLA optimisation level 0
    (``jax_exact``), once per scene and module: (mesh, renderer, target,
    per step a dict of the loss, the pose before (``jax_in``) and after
    (``jax_out``) the step, the pose and smoothing gradients read back
    from its Adam and EMA state (as in test_torch_train.py) and the seed
    words; the best loss)."""
    key = (noise, imsize, rw, route, repr(settings), repr(sorted(kw.items())))
    if key in _JAX_RUNS:
        return _JAX_RUNS[key]
    mesh, cams, lights, jrend = build(noise, imsize=imsize, sigma=1e-2,
                                      gamma=5e-2, **kw)
    if settings:
        jrend = jrend.replace(rasterizer=jrend.rasterizer.replace(
            raster_settings=dataclasses.replace(
                jrend.rasterizer.raster_settings, **settings)))
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
    # At XLA optimisation level 0, as _torch_parity.jax_exact compiles.
    step = jax.jit(jh._make_pose_step(cams, lights, opt)).lower(
        mesh, jnp.asarray(target), carry, keys[0]).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    steps = []
    mu_old, ema_old = np.zeros((1, 3)), np.zeros(3)
    for i in range(3):
        jcfg, jin = jax_inputs(mesh, jrend, key=(keys[i, 0], keys[i, 1]))
        assert (jcfg.binned if route == "binned"
                else jcfg.stream and jcfg.rw == rw)
        pose_in = np.array(carry[0])
        carry, (loss, _gnorm) = step(mesh, jnp.asarray(target), carry,
                                     keys[i])
        mu = np.asarray(carry[1].inner_state[0].mu)
        ema = np.array([float(e) for e in carry[6]])
        steps.append(dict(loss=float(loss), jax_in=pose_in,
                          jax_out=np.asarray(carry[0]),
                          g_pose=_recover(mu, mu_old),
                          g_smooth=_recover(ema, ema_old),
                          seeds=np.array(np.asarray(jin[-1])[:, 0, :4])))
        mu_old, ema_old = mu, ema
    _JAX_RUNS[key] = (mesh, jrend, target, steps, float(carry[3]))
    return _JAX_RUNS[key]


def _pose_steps(noise, imsize, rw, anchor=False, route="stream",
                settings=None, probe=False, **kw):
    """Three pose steps of both packages (``_jax_steps``'s scene), whose
    stream table holds ``rw`` rows.  ``anchor``: each port step starts
    from JAX's ``log_rot`` (the Adam state runs on), so that both
    packages pose the mesh to the same bits and draw the same noise at
    every step.  ``route``: the route both packages must take (``binned``
    with ``settings``, rasterization settings to replace, opting in).

    Yields per step ``_jax_steps``' dict with the port's step output
    ``out``, its pose before (``port_in``) and after (``port_out``), and
    with ``probe`` ``at_jax_pose``, the port's loss at JAX's pose before
    the step; finally the two best losses."""
    mesh, jrend, target, steps, jax_best = _jax_steps(
        noise, imsize, rw, route, settings, kw)
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(jrend, device="cpu")
    assert trend.plan(tmesh).mode == route
    tcams, tlights = trend.rasterizer.cameras, trend.shader.lights
    state = th.PoseState.start(torch.from_numpy(LOG_ROT))
    topt = torch.optim.Adam([state.log_rot], lr=LR)
    smoothing = [torch.as_tensor(x, dtype=torch.float32)
                 for x in trend.shader.get_smoothing()]
    for st in steps:
        tseeds = torch.from_numpy(st["seeds"])
        with torch.no_grad():
            at_jax_pose = th.pose_loss(
                tmesh, torch.from_numpy(target),
                torch.from_numpy(st["jax_in"]), smoothing, trend, tcams,
                tlights, tseeds).item() if probe else None
            if anchor:
                state.log_rot.copy_(torch.from_numpy(st["jax_in"]))
        port_in = state.log_rot.detach().numpy().copy()
        state, out = th.pose_step(tmesh, torch.from_numpy(target), state,
                                  trend, tcams, tlights, topt, tseeds,
                                  torch.zeros(1, 3))
        yield dict(st, out=out, port_in=port_in,
                   port_out=state.log_rot.detach().numpy().copy(),
                   at_jax_pose=at_jax_pose)
    yield dict(best=(state.best_loss.item(), jax_best))


def _pose_steps_match_jax(noise, imsize, rw, **kw):
    """``_pose_steps`` held to JAX: losses rtol 1e-5, gradients within
    1e-3 (MC) or 1e-4 of their max |grad|, log_rot after each step atol
    1e-6."""
    tol = 1e-3 if noise in MC_NOISES else 1e-4
    *steps, last = _pose_steps(noise, imsize, rw, **kw)
    for st in steps:
        out = st["out"]
        np.testing.assert_allclose(out.loss.item(), st["loss"], rtol=1e-5)
        _close(out.g_pose.numpy(), st["g_pose"], tol)
        _close([g.item() for g in out.g_smooth], st["g_smooth"], tol)
        np.testing.assert_allclose(st["port_out"], st["jax_out"], rtol=0,
                                   atol=1e-6)
    assert last["best"][0] == pytest.approx(last["best"][1], rel=1e-5)


def test_stream_pose_steps_match_jax():
    _pose_steps_match_jax("gaussian", 16, 64, k=4, s=4)


def test_stream_pose_steps_match_jax_on_the_icosphere():
    """1280 faces in 20 chunks, each tile visiting up to 20: the step's
    prepass (sort, chunk lists, the permutation's gradient) and the online
    softmax across chunks, with the deterministic SoftRast + SoftAgg pair
    (the gaussian pair: the next test)."""
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
