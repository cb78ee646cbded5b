"""Estimator primitives of the staged route (PyTorch port of
``pertrenderer_tpu/ops/perturbed.py``).

``heaviside`` and ``hard_argmax_onehot`` are the hard members' maps.
``log_corrected`` / ``prod_corrected`` (:336-380) have plain forward
values; what makes them "corrected" is the backward, which zeroes the
inf/nan terms a zero-coverage fragment (prob = 0, log = -inf) would
otherwise spread through the whole gradient.

``perturbed_heaviside`` / ``perturbed_argmax`` are the staged route's
Monte-Carlo estimators, with the reference's variance-reduced
score-function gradients.  Their sample loops are the kernels K8a (the
Heaviside mean and its backward coefficient), K8b (the argmax mean) and
K8c (its gradients) of ``ops/perturbed_kernels.py``; the backward redraws
the forward's noise from the seed words, so no (S, ...) noise tensor is
kept.  The fused routes' MC estimators live in ``ops/fused_render.py``.

With a ``sample_axis`` (a mesh axis of ``parallel.sharding``) each rank of
the sample group draws its own slice of one sample sequence: rank d adds
d * S * 0x9E3779B9 to seed word 0, which gives it samples [d S, (d + 1) S)
of the counter hash, as the fused routes do (the JAX package instead
folds the rank into a threefry key).  The forward means and the backward
coefficients and gradients are averaged over the group, so the group's
result is one run's at its total sample count.
"""

from __future__ import annotations

import warnings

import torch

from pertrenderer_tpu_torch.ops import fused_render as _fr  # the offset
from pertrenderer_tpu_torch.ops import perturbed_kernels as pk
from pertrenderer_tpu_torch.parallel import sharding

__all__ = ["heaviside", "hard_argmax_onehot", "perturbed_heaviside",
           "perturbed_argmax", "log_corrected", "prod_corrected"]


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """H(x) with H(0) = 1, as float32 (no gradient)."""
    return torch.where(x >= 0, 1.0, 0.0).to(torch.float32)


def hard_argmax_onehot(z: torch.Tensor) -> torch.Tensor:
    """One-hot of the argmax over the last axis; the first index wins a
    tie."""
    return torch.nn.functional.one_hot(
        torch.argmax(z, dim=-1), z.shape[-1]).to(torch.float32)


def _forward_only_grads(noise_type, x, scale, what):
    """Zero gradients and a warning for the families without a score
    function (logistic, gumbel, uniform), as the JAX package does where
    the reference crashes."""
    warnings.warn(
        f"{what} backward not implemented for noise type {noise_type!r}; "
        "returning zero gradients (forward-only family)", stacklevel=3)
    return torch.zeros_like(x), torch.zeros_like(scale)


def _estimator_inputs(what, x, scale, seeds, n_samples, sample_axis):
    """(x as contiguous float32, the noise scale as one float32 on x's
    device, seeds as (N, 2) int32 there, this rank's under a sample
    axis)."""
    if seeds is None:
        raise ValueError(f"{what}: seeds (N, 2) int32 seed words required")
    if isinstance(scale, torch.Tensor):
        scale = scale.to(device=x.device, dtype=torch.float32)
    else:
        scale = torch.tensor(float(scale), dtype=torch.float32,
                             device=x.device)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=x.device)
    if sample_axis is not None:      # this rank's samples of the group
        seeds = seeds.clone()
        seeds[:, 0] = _fr.sample_offset(
            seeds[:, 0], sharding.axis_info(sample_axis).index, n_samples)
    return x.to(torch.float32), scale, seeds


def _mean(x, sample_axis):
    """x averaged over the sample group (x itself without one)."""
    return x if sample_axis is None else sharding.axis_mean(x, sample_axis)


class _PerturbedHeaviside(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, sigma, seeds, n_samples, noise_type, vr,
                sample_axis):
        ctx.save_for_backward(d, sigma, seeds)
        ctx.cfg = (n_samples, noise_type, vr, sample_axis)
        return _mean(pk.heaviside_mean(d.contiguous(), sigma.reshape(()),
                                       seeds, n_samples, noise_type),
                     sample_axis)

    @staticmethod
    def backward(ctx, g):
        d, sigma, seeds = ctx.saved_tensors
        n_samples, noise_type, vr, sample_axis = ctx.cfg
        if noise_type not in pk.GRAD_NOISES:
            g_d, g_sigma = _forward_only_grads(noise_type, d, sigma,
                                               "perturbed_heaviside")
        else:
            coeff = _mean(pk.heaviside_coeff(d.contiguous(),
                                             sigma.reshape(()), seeds,
                                             n_samples, noise_type, vr),
                          sample_axis)
            g_d = coeff * g
            # The reference's sigma gradient is sum(grad_d), overwriting
            # its own sigma score (smoothrast.py:58): kept as shipped.
            g_sigma = g_d.sum().reshape(sigma.shape)
        return g_d, g_sigma, None, None, None, None, None


def perturbed_heaviside(distances, noise_intensity, seeds, nb_samples=1,
                        noise_type="gaussian", variance_reduction=True,
                        sample_axis=None):
    """E_Z[H(d + sigma Z)] by Monte Carlo over ``nb_samples`` draws (K8a).

    ``distances`` (N, ..., C); ``seeds`` (N, 2) int32 seed words of the
    batch elements.  Backward: grad_d = mean_s[(H(d + sigma Z_s) - vr
    H(d)) score(Z_s)] / sigma * g, grad_sigma = sum(grad_d) (the
    reference's quirk); the logistic, gumbel and uniform families give zero
    gradients and a warning.  ``sample_axis``: ``nb_samples`` per rank of
    the sample group, the mean and the coefficient averaged over it."""
    d, sigma, seeds = _estimator_inputs("perturbed_heaviside", distances,
                                        noise_intensity, seeds,
                                        int(nb_samples), sample_axis)
    return _PerturbedHeaviside.apply(d, sigma, seeds, int(nb_samples),
                                     noise_type, bool(variance_reduction),
                                     sample_axis)


class _PerturbedArgmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, gamma, seeds, n_samples, noise_type, vr,
                sample_axis):
        ctx.save_for_backward(z, gamma, seeds)
        ctx.cfg = (n_samples, noise_type, vr, sample_axis)
        return _mean(pk.argmax_mean(z.contiguous(), gamma.reshape(()), seeds,
                                    n_samples, noise_type), sample_axis)

    @staticmethod
    def backward(ctx, g):
        z, gamma, seeds = ctx.saved_tensors
        n_samples, noise_type, vr, sample_axis = ctx.cfg
        if noise_type not in pk.GRAD_NOISES:
            g_z, g_gamma = _forward_only_grads(noise_type, z, gamma,
                                               "perturbed_argmax")
        else:
            g_z, gterm = pk.argmax_grads(z.contiguous(), g.contiguous(),
                                         gamma.reshape(()), seeds, n_samples,
                                         noise_type, vr)
            g_z, g_gamma = _mean([g_z, gterm.sum().reshape(gamma.shape)],
                                 sample_axis)
        return g_z, g_gamma, None, None, None, None, None


def perturbed_argmax(z, noise_intensity, seeds, nb_samples=1,
                     noise_type="gaussian", variance_reduction=True,
                     sample_axis=None):
    """E_Z[onehot(argmax(z + gamma Z))] over the last axis by Monte Carlo
    over ``nb_samples`` draws (K8b; every channel tied at the max counts).

    ``z`` (N, ..., C); ``seeds`` (N, 2) int32.  Backward (K8c): grad_z =
    mean_s[<g, w_s - w0> score(Z_s)] / gamma and grad_gamma = mean_s[<g,
    w_s - w0> (phi(Z_s) - 1)] / gamma summed over the pixels, with w0 the
    first-wins one-hot of z under variance reduction (else 0) and phi =
    sum Z^2 (gaussian) or sum score(Z) Z (cauchy); the other families give
    zero gradients and a warning.  ``sample_axis``: as for
    :func:`perturbed_heaviside`, grad_z and grad_gamma averaged too."""
    z, gamma, seeds = _estimator_inputs("perturbed_argmax", z,
                                        noise_intensity, seeds,
                                        int(nb_samples), sample_axis)
    return _PerturbedArgmax.apply(z, gamma, seeds, int(nb_samples),
                                  noise_type, bool(variance_reduction),
                                  sample_axis)


class _LogCorrected(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.log(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        inv = 1.0 / x
        inv = torch.where(torch.isinf(inv), torch.zeros_like(inv), inv)
        return inv * g


def _nansum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """nansum of ``t`` down to the broadcast ``shape`` it came from."""
    lead = t.dim() - len(shape)
    dims = list(range(lead)) + [lead + i for i, s in enumerate(shape)
                                if s == 1 and t.shape[lead + i] != 1]
    out = torch.nansum(t, dim=dims, keepdim=True) if dims else t
    return out.reshape(shape)


class _ProdCorrected(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return x * y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        y_safe = torch.where(torch.isinf(y), torch.zeros_like(y), y)
        grad_x = _nansum_to(y_safe * g, x.shape)
        gy = x * g
        grad_y = torch.where(torch.isnan(gy), torch.zeros_like(gy), gy)
        return grad_x, grad_y


def log_corrected(x: torch.Tensor) -> torch.Tensor:
    """log(x) whose backward maps 1/x = inf (x = 0) to 0 instead of
    propagating inf * 0 = nan."""
    return _LogCorrected.apply(x)


def prod_corrected(x, y: torch.Tensor) -> torch.Tensor:
    """x * y (x scalar-like, broadcast against y) whose backward zeroes
    inf/nan terms: grad_x = nansum(where(isinf(y), 0, y) * g) over the
    broadcast dims, grad_y = x * g with nan -> 0."""
    x = torch.as_tensor(x, dtype=y.dtype, device=y.device)
    return _ProdCorrected.apply(x, y)
