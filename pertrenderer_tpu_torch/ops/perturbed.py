"""Estimator primitives of the staged route (PyTorch port of
``pertrenderer_tpu/ops/perturbed.py``).

``heaviside`` and ``hard_argmax_onehot`` are the hard members' maps.
``log_corrected`` / ``prod_corrected`` (:336-380) have plain forward
values; what makes them "corrected" is the backward, which zeroes the
inf/nan terms a zero-coverage fragment (prob = 0, log = -inf) would
otherwise spread through the whole gradient.

The staged Monte-Carlo estimators ``perturbed_heaviside`` /
``perturbed_argmax`` run on the TPU as the Pallas kernels K8a / K8b / K8c
(``ops/perturbed_pallas.py``), which are not ported yet: they raise.  The
fused routes' MC estimators live in ``ops/fused_render.py``.
"""

from __future__ import annotations

import torch

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


def _staged_mc(what: str, kernels: str):
    raise NotImplementedError(
        f"staged route with Monte-Carlo estimators is not ported to "
        f"PyTorch yet: {what} needs the staged MC estimator kernels "
        f"{kernels} (pertrenderer_tpu/ops/perturbed_pallas.py); the fused "
        "flat and stream routes run these estimators")


def perturbed_heaviside(distances, noise_intensity, *args, **kwargs):
    """E_Z[H(d + sigma Z)] on the staged route: not ported (kernel K8a)."""
    _staged_mc("perturbed_heaviside", "K8a")


def perturbed_argmax(z, noise_intensity, *args, **kwargs):
    """E_Z[onehot(argmax(z + gamma Z))] on the staged route: not ported
    (kernels K8b and K8c)."""
    _staged_mc("perturbed_argmax", "K8b/K8c")


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
