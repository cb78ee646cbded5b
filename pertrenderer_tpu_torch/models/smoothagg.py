"""Aggregation front-ends, the SmoothAgg family (PyTorch port of
``pertrenderer_tpu/models/smoothagg.py``) as parameter holders.

``gamma`` and ``alpha`` are float32 scalar tensors (learnable: a tensor
that requires grad passed to ``update_smoothing`` is kept as it is);
``eps``, ``nb_samples`` and ``fixed_noise`` are plain values.  The fused
kernels evaluate the aggregation on the flat and stream routes;
``aggregate(...)`` is the staged route's, ported for the deterministic
members (SoftAgg, HardAgg).  Every member shares the reference's
preamble (``_z_map``):

    z_inv     = (zfar - zbuf) / (zfar - znear) * mask
    z_inv_max = max(max_K z_inv, eps)
    z_map     = prod_corrected(gamma / alpha, log_corrected(prob))
                + z_inv - z_inv_max,  then the background channel
                eps - z_inv_max appended (K + 1 channels).

The MC members (GaussianAgg, GaussianAgg_wovr, CauchyAgg and the
forward-only UniformAgg, whose log-prob scaling is the plain product)
take the perturbed argmax of the z_map (kernels K8b / K8c), keyed by the
(N, 2) int32 aggregation seed words, and split their samples over the
mesh axis ``sample_axis`` names (``parallel.sharding``), if any.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pertrenderer_tpu_torch.ops import fused_render
from pertrenderer_tpu_torch.ops.perturbed import (hard_argmax_onehot,
                                                  log_corrected,
                                                  perturbed_argmax,
                                                  prod_corrected)

__all__ = ["SoftAgg", "GaussianAgg", "GaussianAgg_wovr", "CauchyAgg",
           "UniformAgg", "HardAgg"]


def _scalar(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _z_map(gamma, alpha, eps, zbuf, zfar, znear, prob_map, mask,
           corrected_prod: bool = True, gamma_over_alpha=None):
    """The shared aggregation preamble: z_map (..., K + 1) with the
    background channel last."""
    mask = mask.to(zbuf.dtype)
    z_inv = (zfar - zbuf) / (zfar - znear) * mask
    z_inv_max = torch.amax(z_inv, dim=-1, keepdim=True)
    z_inv_max = torch.maximum(z_inv_max, z_inv_max.new_tensor(eps))
    log_prob = log_corrected(prob_map)
    gal = gamma / alpha if gamma_over_alpha is None else gamma_over_alpha
    if corrected_prod:
        scaled = prod_corrected(gal, log_prob)
    else:
        scaled = gal * log_prob
    z_map = scaled + z_inv - z_inv_max
    bg = (eps - z_inv_max).expand(z_map.shape[:-1] + (1,))
    return torch.cat([z_map, bg], dim=-1)


def _on(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass
class _Agg:
    gamma: torch.Tensor
    alpha: torch.Tensor
    eps: float = 1e-10
    nb_samples: int = 16

    def update_smoothing(self, gamma=4e-2, alpha=1.0):
        return dataclasses.replace(self, gamma=_scalar(gamma),
                                   alpha=_scalar(alpha))

    def update_nb_samples(self, nb_samples):
        return dataclasses.replace(self, nb_samples=int(nb_samples))


@dataclasses.dataclass
class SoftAgg(_Agg):
    """Softmax aggregation (the SoftRas aggregate).  Deterministic."""

    nb_samples: int = 1

    @classmethod
    def create(cls, gamma=4e-2, alpha=1.0, eps=1e-10, nb_samples=1):
        return cls(gamma=_scalar(gamma), alpha=_scalar(alpha), eps=eps,
                   nb_samples=nb_samples)

    def aggregate(self, zbuf, zfar, znear, prob_map, mask, seeds=None):
        gamma = _on(self.gamma, zbuf)
        z_map = _z_map(gamma, _on(self.alpha, zbuf), self.eps, zbuf, zfar,
                       znear, prob_map, mask)
        return torch.softmax(prod_corrected(1.0 / gamma, z_map), dim=-1)


@dataclasses.dataclass
class _StochasticAgg(_Agg):
    """Perturbed argmax.  ``fixed_noise`` (or no seeds) renders with the
    aggregation seed words drawn from a generator seeded 1, as
    ``fused_render.draw_seeds`` does (the reference reseeds to 1)."""

    noise_type = "gaussian"
    variance_reduction = True
    corrected_prod = True       # prod_corrected scales the log-prob

    fixed_noise: bool = False
    sample_axis: Optional[str] = None

    @classmethod
    def create(cls, gamma=4e-2, alpha=1.0, eps=1e-10, nb_samples=16,
               fixed_noise=False, sample_axis=None):
        return cls(gamma=_scalar(gamma), alpha=_scalar(alpha), eps=eps,
                   nb_samples=nb_samples, fixed_noise=fixed_noise,
                   sample_axis=sample_axis)

    def aggregate(self, zbuf, zfar, znear, prob_map, mask, seeds=None):
        """The perturbed argmax of the z_map (K8b, gradients K8c);
        ``seeds``: (N, 2) int32 aggregation seed words."""
        if self.fixed_noise or seeds is None:
            seeds = fused_render.draw_seeds(zbuf.shape[0], fixed_noise=True,
                                            device=zbuf.device)[:, 2:]
        gamma = _on(self.gamma, zbuf)
        z_map = _z_map(gamma, _on(self.alpha, zbuf), self.eps, zbuf, zfar,
                       znear, prob_map, mask,
                       corrected_prod=self.corrected_prod)
        return perturbed_argmax(z_map, gamma, seeds, self.nb_samples,
                                self.noise_type, self.variance_reduction,
                                self.sample_axis)


@dataclasses.dataclass
class GaussianAgg(_StochasticAgg):
    """Gaussian perturbed argmax with variance reduction."""


@dataclasses.dataclass
class GaussianAgg_wovr(_StochasticAgg):
    """Gaussian perturbed argmax without variance reduction."""

    variance_reduction = False


@dataclasses.dataclass
class CauchyAgg(_StochasticAgg):
    """Cauchy perturbed argmax with variance reduction."""

    noise_type = "cauchy"


@dataclasses.dataclass
class UniformAgg(_StochasticAgg):
    """Uniform-noise perturbed argmax: forward-only (its gradients are
    zero, with a warning), and the log-prob scaled by the plain product,
    as in the reference (smoothagg.py:267).  Not a fused menu member: a
    renderer with it takes the staged route."""

    noise_type = "uniform"
    corrected_prod = False


@dataclasses.dataclass
class HardAgg(_Agg):
    """Hard argmax; log-prob scaled by 1e-6.  gamma/alpha are inert."""

    gamma: torch.Tensor = dataclasses.field(
        default_factory=lambda: _scalar(1.0))
    alpha: torch.Tensor = dataclasses.field(
        default_factory=lambda: _scalar(1.0))
    nb_samples: int = 1

    @classmethod
    def create(cls, eps=1e-10):
        return cls(eps=eps)

    def aggregate(self, zbuf, zfar, znear, prob_map, mask, seeds=None):
        one = _on(1.0, zbuf)
        z_map = _z_map(one, one, self.eps, zbuf, zfar, znear, prob_map,
                       mask, corrected_prod=False,
                       gamma_over_alpha=_on(1.0 / 1e6, zbuf))
        return hard_argmax_onehot(z_map)

    def update_smoothing(self, gamma=4e-2, alpha=1.0):
        return self

    def update_nb_samples(self, nb_samples):
        return self
