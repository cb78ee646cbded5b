"""The staged Monte-Carlo estimators (``ops/perturbed_kernels.py``, kernels
K8a / K8b / K8c) against the JAX package's ``ops/perturbed.py``.

The port's estimator math is fed the JAX package's own noise, drawn as
its CPU path draws it (``_sample_noise(fold_in(key, s), ...)`` for s = 0
.. S - 1), so both packages evaluate the same sums: the forwards and the
vector-Jacobian products (grad_d and grad_sigma of the perturbed
Heaviside; grad_z and grad_gamma of the perturbed argmax) must agree
within 1e-6 of their max |value| (float32 rounding of sums taken in
another order).  Then the forward-only families (logistic, gumbel,
uniform): forwards as above, zero gradients and a warning.  Then the
port's own draws: the autograd functions equal their plain versions, the
backward replays the forward's noise, and the families have their
distribution's mean and spread.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.ops import perturbed as jp
from pertrenderer_tpu_torch.ops import perturbed_kernels as pk
from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 16
KEY = jax.random.PRNGKey(21)
# (noise family, variance reduction): the reference's differentiable
# members (gaussian, gaussian_wovr, cauchy).
GRAD_CASES = [("gaussian", True), ("gaussian", False), ("cauchy", True)]
FORWARD_ONLY = ("logistic", "gumbel", "uniform")


def _inputs(shape, scale, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, g


def _jax_noise(noise_type, shape):
    """(S, *shape): the JAX package's per-sample noise."""
    draw = lambda s: jp._sample_noise(jax.random.fold_in(KEY, s), shape,
                                      noise_type)
    return np.asarray(jax.jit(jax.vmap(draw))(jnp.arange(S)))


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert np.all(np.isfinite(got)) and err <= tol, err


@pytest.mark.parametrize("noise,vr", GRAD_CASES)
def test_heaviside_estimator_matches_jax_on_its_noise(noise, vr):
    d, g = _inputs((2, 6, 5, 7), 0.02, 1)
    sigma = np.float32(1e-2)
    jf = lambda x, s: jp.perturbed_heaviside(x, s, KEY, S, noise, vr)
    jout, vjp = jax.vjp(jf, jnp.asarray(d), jnp.asarray(sigma))
    jgd, jgs = vjp(jnp.asarray(g))
    z = torch.from_numpy(_jax_noise(noise, d.shape))
    td, ts = torch.from_numpy(d), torch.tensor(sigma)
    out = pk.heaviside_mean_est(td, ts, z, S)
    coeff = pk.heaviside_coeff_est(td, ts, z, S, noise, vr)
    gd = coeff * torch.from_numpy(g)
    _close(out, jout)
    _close(gd, jgd)
    _close(gd.sum(), jgs)
    assert 0.0 < np.asarray(jout).mean() < 1.0 and np.abs(jgd).max() > 0


@pytest.mark.parametrize("noise,vr", GRAD_CASES)
def test_argmax_estimator_matches_jax_on_its_noise(noise, vr):
    z, g = _inputs((2, 6, 5, 9), 1.0, 2)
    z[0, 0, 0, :] = 0.25                    # a pixel of exact ties
    gamma = np.float32(0.5)
    jf = lambda x, s: jp.perturbed_argmax(x, s, KEY, S, noise, vr)
    jout, vjp = jax.vjp(jf, jnp.asarray(z), jnp.asarray(gamma))
    jgz, jgg = vjp(jnp.asarray(g))
    e = torch.from_numpy(_jax_noise(noise, z.shape))
    tz, tg = torch.from_numpy(z), torch.tensor(gamma)
    out = pk.argmax_mean_est(tz, tg, e, S)
    gz, gterm = pk.argmax_grads_est(tz, torch.from_numpy(g), tg, e, S, noise,
                                    vr)
    _close(out, jout)
    _close(gz, jgz)
    _close(gterm.sum(), jgg)
    assert gterm.shape == z.shape[:-1]


@pytest.mark.parametrize("noise", FORWARD_ONLY)
def test_forward_only_families_match_jax_and_give_zero_gradients(noise):
    d, g = _inputs((2, 4, 4, 5), 0.05, 3)
    z, gz = _inputs((2, 4, 4, 6), 1.0, 4)
    jh = jp.perturbed_heaviside(jnp.asarray(d), 0.1, KEY, S, noise, True)
    ja = jp.perturbed_argmax(jnp.asarray(z), 0.5, KEY, S, noise, True)
    th = pk.heaviside_mean_est(torch.from_numpy(d), torch.tensor(0.1),
                               torch.from_numpy(_jax_noise(noise, d.shape)),
                               S)
    ta = pk.argmax_mean_est(torch.from_numpy(z), torch.tensor(0.5),
                            torch.from_numpy(_jax_noise(noise, z.shape)), S)
    _close(th, jh)
    _close(ta, ja)

    seeds = torch.tensor([[3, 4], [5, -6]], dtype=torch.int32)
    for fn, x, scale, cot in (
            (ptt.perturbed_heaviside, d, 0.1, g),
            (ptt.perturbed_argmax, z, 0.5, gz)):
        xt = torch.from_numpy(x).requires_grad_()
        st = torch.tensor(scale, requires_grad=True)
        out = fn(xt, st, seeds, S, noise)
        assert torch.isfinite(out).all()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gx, gs = torch.autograd.grad(
                torch.sum(out * torch.from_numpy(cot)), [xt, st])
        assert any("forward-only family" in str(w.message) for w in caught)
        assert not gx.any() and gs.item() == 0.0


@pytest.mark.parametrize("noise,vr", GRAD_CASES)
def test_autograd_functions_equal_plain_versions(noise, vr):
    """perturbed_heaviside / perturbed_argmax on the CPU run the kernels'
    plain versions: the forward draws once, the backward redraws the same
    noise (no (S, ...) tensor is kept), and the gradients equal the
    estimators fed that noise."""
    d, g = _inputs((2, 5, 4, 6), 0.02, 5)
    z, gz = _inputs((2, 5, 4, 7), 1.0, 6)
    seeds = torch.tensor([[11, -12], [13, 14]], dtype=torch.int32)
    for fn, x, scale, cot, est in (
            (ptt.perturbed_heaviside, d, 1e-2, g, "heaviside"),
            (ptt.perturbed_argmax, z, 0.5, gz, "argmax")):
        xt = torch.from_numpy(x).requires_grad_()
        st = torch.tensor(scale, requires_grad=True)
        out = fn(xt, st, seeds, S, noise, vr)
        gx, gs = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)),
                                     [xt, st])
        noise_s = torch.stack(list(pk.draws(noise, seeds, S, x.shape)))
        xd, sd, ct = xt.detach(), st.detach(), torch.from_numpy(cot)
        if est == "heaviside":
            want = pk.heaviside_mean_est(xd, sd, noise_s, S)
            want_gx = pk.heaviside_coeff_est(xd, sd, noise_s, S, noise,
                                             vr) * ct
            want_gs = want_gx.sum()
        else:
            want = pk.argmax_mean_est(xd, sd, noise_s, S)
            want_gx, gterm = pk.argmax_grads_est(xd, ct, sd, noise_s, S,
                                                 noise, vr)
            want_gs = gterm.sum()
        assert torch.equal(out, want)
        assert torch.equal(gx, want_gx)
        assert torch.equal(gs, want_gs)
        assert gx.abs().max() > 0
    assert all(v == 0 for v in pk.launch_counts.values())


def test_draws_are_keyed_and_distributed():
    """Each batch element's seed words key its own stream; the samples and
    channels differ; the families' mean and spread are the distribution's
    (gaussian 0 / 1, logistic 0 / pi / sqrt 3, gumbel Euler's gamma /
    pi / sqrt 6, uniform 0 / 1 / sqrt 12; cauchy's median 0 and quartiles
    +-1), within 5 standard errors of 2**17 draws."""
    seeds = torch.tensor([[1, 2], [1, 2], [1, 3]], dtype=torch.int32)
    e = torch.stack(list(pk.draws("gaussian", seeds, 4, (3, 64, 8))))
    assert torch.equal(e[:, 0], e[:, 1])
    assert not torch.equal(e[:, 0], e[:, 2])
    assert not torch.equal(e[0], e[1])
    assert not torch.equal(e[..., 0], e[..., 1])
    one = torch.tensor([[7, 9]], dtype=torch.int32)
    n = 2 ** 17
    moments = {"gaussian": (0.0, 1.0), "logistic": (0.0, np.pi / 3 ** 0.5),
               "gumbel": (0.5772156649, np.pi / 6 ** 0.5),
               "uniform": (0.0, 12 ** -0.5)}
    for noise, (mean, std) in moments.items():
        x = torch.stack(list(pk.draws(noise, one, 8, (1, 1024, 16))))
        x = x.double().reshape(-1)
        assert x.numel() == n
        assert abs(x.mean().item() - mean) <= 5 * std / n ** 0.5, noise
        assert abs(x.std().item() / std - 1.0) <= 0.02, noise
    x = torch.stack(list(pk.draws("cauchy", one, 8, (1, 1024, 16))))
    q = torch.quantile(x.reshape(-1).double(),
                       torch.tensor([0.25, 0.5, 0.75], dtype=torch.float64))
    assert torch.allclose(q, torch.tensor([-1.0, 0.0, 1.0],
                                          dtype=torch.float64), atol=0.03)
    u = torch.stack(list(pk.draws("uniform", one, 8, (1, 1024, 16))))
    assert u.min() >= -0.5 and u.max() <= 0.5
