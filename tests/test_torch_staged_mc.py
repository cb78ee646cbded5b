"""The staged route with the Monte-Carlo estimators (kernels K8a-c, their
plain versions on the CPU) against the JAX package's staged route.

The two packages draw different noise (the port's counter hash against
JAX's threefry), so renders and gradients agree in distribution.  The
scene is the cube at 16^2, K=8, seen as R=4 replicas of one pose (each
batch element its own noise stream), rendered in M=8 calls with fresh
seeds: 32 independent estimates of the image and of the vertex gradients,
and 8 of the sigma and gamma gradients (summed over a call's replicas),
with S=32 samples per estimator.  The MC bound, per quantity: with z the
difference of the two packages' means over its standard error (from both
samples' variances, floored at 1e-6 of the quantity's max), the RMS of z
over the image or gradient elements at most 1.5 and every |z| at most 7;
for sigma and gamma, |z| at most 4.  The gaussian, gaussian_wovr and
cauchy pairs (image, gradients to vertices, sigma, gamma) and
UniformAgg's forward (with GaussianRast).

Then the shared preamble exactly: ``_z_map`` with the plain product
(UniformAgg's) and with prod_corrected equals the JAX package's bit for
bit wherever the two libraries' log agree (the JAX side compiled without
fused multiply-adds, ``_torch_parity.jax_exact``), and within 2 ulps of
its intermediates where XLA's log rounds the other way.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pertrenderer_tpu as pt
import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.models import smoothagg as jsa
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.models import smoothagg as tsa
from pertrenderer_tpu_torch.ops import fused_render as tfr
from pertrenderer_tpu_torch.ops import perturbed_kernels as pk
from _torch_parity import (jax_exact, jax_staged,  # noqa: F401
                           one_torch_thread, port_staged, staged_scene)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

R, M, S, IMSIZE, K = 4, 8, 32, 16, 8


def _scene(agg=None, noise="gaussian"):
    mesh, _c, _l, renderer = staged_scene(
        noise=noise, imsize=IMSIZE, k=K, n=R, same_pose=True,
        nb_samples=S)
    if agg is not None:
        renderer = renderer.replace(shader=renderer.shader.replace(
            smoothagg=agg))
    return mesh, renderer


def _jax_runs(renderer, mesh, w, grads: bool):
    """M calls of the JAX staged route: (images (M R, H, W, 4), and with
    ``grads`` vertex gradients (M R, V, 3), sigma (M,), gamma (M,))."""
    sh = renderer.shader

    def loss(verts, sigma, gamma, key):
        shader = sh.replace(
            smoothrast=sh.smoothrast.replace(sigma=sigma),
            smoothagg=sh.smoothagg.replace(gamma=gamma))
        img = jax_staged(renderer.replace(shader=shader),
                         mesh.replace(verts=verts), key=key)
        return jnp.sum(img * w), img

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)
                 if grads else lambda *a: (None, loss(*a)[1]))
    out = [[], [], [], []]
    for i in range(M):
        key = jax.random.PRNGKey(100 + i)
        res = fn(mesh.verts, sh.smoothrast.sigma, sh.smoothagg.gamma, key)
        (_, img), g = (res[0], res[1]) if grads else (res, None)
        out[0].append(np.asarray(img))
        if grads:
            out[1].append(np.asarray(g[0]))
            out[2].append(float(g[1]))
            out[3].append(float(g[2]))
    return [np.concatenate(out[0])] + ([np.concatenate(out[1]),
                                        np.array(out[2]), np.array(out[3])]
                                       if grads else [])


def _port_runs(renderer, mesh, w, grads: bool):
    """The port's counterpart of :func:`_jax_runs`, seeds drawn per call."""
    trend = convert.from_reference(renderer, device="cpu")
    tmesh = convert.from_reference(mesh, device="cpu")
    gen = torch.Generator().manual_seed(100)
    wt = torch.from_numpy(w)
    out = [[], [], [], []]
    for _ in range(M):
        seeds = tfr.draw_seeds(R, gen, device="cpu")
        verts = tmesh.verts.detach().clone().requires_grad_(grads)
        sh = trend.shader
        sigma = sh.smoothrast.sigma.detach().clone().requires_grad_(grads)
        gamma = sh.smoothagg.gamma.detach().clone().requires_grad_(grads)
        sh = dataclasses.replace(
            sh, smoothrast=dataclasses.replace(sh.smoothrast, sigma=sigma),
            smoothagg=dataclasses.replace(sh.smoothagg, gamma=gamma))
        img = port_staged(trend.replace(shader=sh),
                          tmesh.update_padded(verts), seeds=seeds)
        out[0].append(img.detach().numpy())
        if grads:
            g = torch.autograd.grad(torch.sum(img * wt),
                                    [verts, sigma, gamma])
            out[1].append(g[0].numpy())
            out[2].append(g[1].item())
            out[3].append(g[2].item())
    return [np.concatenate(out[0])] + ([np.concatenate(out[1]),
                                        np.array(out[2]), np.array(out[3])]
                                       if grads else [])


def _z(a, b):
    """Per element: (mean a - mean b) / the standard error of the
    difference, floored at 1e-6 of the largest |mean|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    scale = max(np.abs(b.mean(0)).max(), np.abs(a.mean(0)).max(), 1e-30)
    return (a.mean(0) - b.mean(0)) / np.maximum(se, 1e-6 * scale)


def _assert_same_field(a, b, what):
    z = _z(a, b)
    rms = float(np.sqrt(np.mean(z * z)))
    assert np.all(np.isfinite(a)), what
    assert rms <= 1.5 and np.abs(z).max() <= 7.0, (what, rms,
                                                   np.abs(z).max())


def _weights():
    return np.random.default_rng(4).standard_normal(
        (R, IMSIZE, IMSIZE, 4)).astype(np.float32)


@pytest.mark.parametrize("noise", ["gaussian", "gaussian_wovr", "cauchy"])
def test_staged_mc_render_and_gradients_match_jax_in_distribution(noise):
    mesh, renderer = _scene(noise=noise)
    w = _weights()
    j_img, j_gv, j_gs, j_gg = _jax_runs(renderer, mesh, w, grads=True)
    counts = dict(pk.launch_counts)
    t_img, t_gv, t_gs, t_gg = _port_runs(renderer, mesh, w, grads=True)
    assert pk.launch_counts == counts            # plain versions on the CPU
    assert (t_img[..., 3] > 0.5).mean() > 0.1
    assert 0.0 < t_img[..., 3].mean() < 1.0
    _assert_same_field(t_img, j_img, "image")
    _assert_same_field(t_gv, j_gv, "vertex gradients")
    for what, a, b in (("sigma", t_gs, j_gs), ("gamma", t_gg, j_gg)):
        z = _z(a[:, None], b[:, None])[0]
        assert abs(z) <= 4.0 and np.all(np.isfinite(a)), (what, z, a, b)
        assert np.abs(a).max() > 0, what


def test_staged_uniform_agg_forward_matches_jax_in_distribution():
    """UniformAgg (forward-only, plain product) with GaussianRast, through
    both staged routes; and the port's renderer reports the JAX package's
    staged plan."""
    mesh, renderer = _scene(pt.UniformAgg.create(gamma=5e-1, nb_samples=S))
    trend = convert.from_reference(renderer, device="cpu")
    assert isinstance(trend.shader.smoothagg, ptt.UniformAgg)
    tmesh = convert.from_reference(mesh, device="cpu")
    got, want = trend.plan(tmesh), renderer.plan(mesh)
    assert (got.mode, got.reason) == (want.mode, want.reason)
    assert got.mode == "staged"
    w = _weights()
    j_img = _jax_runs(renderer, mesh, w, grads=False)[0]
    t_img = _port_runs(renderer, mesh, w, grads=False)[0]
    assert 0.0 < t_img[..., 3].mean() < 1.0
    _assert_same_field(t_img, j_img, "image")


@pytest.mark.parametrize("corrected", [False, True])
def test_z_map_equals_jax_bit_for_bit(corrected):
    rng = np.random.default_rng(8)
    shape = (2, 5, 6, K)
    zbuf = rng.uniform(1.0, 9.0, shape).astype(np.float32)
    prob = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    prob[..., -2:] = 0.0                         # log(0) = -inf slots
    mask = rng.uniform(size=shape) < 0.8
    gamma, alpha = np.float32(0.3), np.float32(1.7)
    far, near = np.float32(100.0), np.float32(1.0)
    want = jax_exact(lambda g, a, zb, zf, zn, pr, ms: jsa._z_map(
        g, a, 1e-10, zb, zf, zn, pr, ms, corrected_prod=corrected),
        gamma, alpha, zbuf, far, near, prob, mask)
    got = tsa._z_map(torch.tensor(gamma), torch.tensor(alpha), 1e-10,
                     torch.from_numpy(zbuf), torch.tensor(far),
                     torch.tensor(near),
                     torch.from_numpy(prob), torch.from_numpy(mask),
                     corrected_prod=corrected)
    assert got.shape == shape[:-1] + (K + 1,)
    # XLA's and torch's log round differently in the last place for some
    # inputs: where they agree, the preamble's bits must; elsewhere the
    # z_map is within 2 ulps of its intermediates (z_inv, z_inv_max and
    # the scaled log-prob lie below 2 in magnitude).
    same_log = np.asarray(jax_exact(jnp.log, prob)) == torch.log(
        torch.from_numpy(prob)).numpy()
    same = np.concatenate([same_log, np.ones(shape[:-1] + (1,), bool)], -1)
    got, want = got.numpy(), np.asarray(want)
    assert same.mean() > 0.5
    np.testing.assert_array_equal(got[same], want[same])
    ulp = np.spacing(np.float32(2.0))
    assert np.all(np.abs(got[~same] - want[~same]) <= 2 * ulp)
    assert np.isneginf(want).any()
