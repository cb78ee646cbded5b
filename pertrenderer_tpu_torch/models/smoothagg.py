"""Aggregation front-ends, the SmoothAgg family (PyTorch port of
``pertrenderer_tpu/models/smoothagg.py``) as parameter holders.

``gamma`` and ``alpha`` are float32 scalar tensors (learnable); ``eps``,
``nb_samples`` and ``fixed_noise`` are plain values.  The fused kernel
evaluates the aggregation; the staged ``aggregate`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SoftAgg", "GaussianAgg", "GaussianAgg_wovr", "CauchyAgg",
           "HardAgg"]


def _scalar(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class _Agg:
    gamma: torch.Tensor
    alpha: torch.Tensor
    eps: float = 1e-10
    nb_samples: int = 16

    def update_smoothing(self, gamma=4e-2, alpha=1.0):
        return dataclasses.replace(self, gamma=_scalar(gamma),
                                   alpha=_scalar(alpha))


@dataclasses.dataclass
class SoftAgg(_Agg):
    """Softmax aggregation (the SoftRas aggregate).  Deterministic."""

    nb_samples: int = 1

    @classmethod
    def create(cls, gamma=4e-2, alpha=1.0, eps=1e-10, nb_samples=1):
        return cls(gamma=_scalar(gamma), alpha=_scalar(alpha), eps=eps,
                   nb_samples=nb_samples)


@dataclasses.dataclass
class _StochasticAgg(_Agg):
    """Perturbed argmax.  ``fixed_noise`` renders with the aggregation seed
    words drawn from a generator seeded 1 (the reference reseeds to 1)."""

    fixed_noise: bool = False
    sample_axis: Optional[str] = None

    @classmethod
    def create(cls, gamma=4e-2, alpha=1.0, eps=1e-10, nb_samples=16,
               fixed_noise=False, sample_axis=None):
        return cls(gamma=_scalar(gamma), alpha=_scalar(alpha), eps=eps,
                   nb_samples=nb_samples, fixed_noise=fixed_noise,
                   sample_axis=sample_axis)


@dataclasses.dataclass
class GaussianAgg(_StochasticAgg):
    """Gaussian perturbed argmax with variance reduction."""


@dataclasses.dataclass
class GaussianAgg_wovr(_StochasticAgg):
    """Gaussian perturbed argmax without variance reduction."""


@dataclasses.dataclass
class CauchyAgg(_StochasticAgg):
    """Cauchy perturbed argmax with variance reduction."""


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

    def update_smoothing(self, gamma=4e-2, alpha=1.0):
        return self
