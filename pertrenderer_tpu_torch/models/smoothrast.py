"""Coverage front-ends, the SmoothRast family (PyTorch port of
``pertrenderer_tpu/models/smoothrast.py``) as parameter holders.

``sigma`` is a float32 scalar tensor (learnable); ``nb_samples`` sets the
Monte-Carlo sample count.  The fused kernel evaluates the estimators; the
staged ``rasterize`` is not ported yet.  ``sample_axis`` names the
sample-sharded route, which the port does not run yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["SoftRast", "GaussianRast", "GaussianRast_wovr", "ArctanRast",
           "AffineRast", "HardRast"]


def _scalar(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class _Rast:
    sigma: torch.Tensor
    nb_samples: int = 16

    @classmethod
    def create(cls, sigma=2e-4, nb_samples=16, **kw):
        return cls(sigma=_scalar(sigma), nb_samples=nb_samples, **kw)

    def update_smoothing(self, sigma):
        return dataclasses.replace(self, sigma=_scalar(sigma))


@dataclasses.dataclass
class SoftRast(_Rast):
    """sigmoid(-d / sigma) coverage.  Deterministic."""

    nb_samples: int = 1

    @classmethod
    def create(cls, sigma=2e-4, nb_samples=1):
        return cls(sigma=_scalar(sigma), nb_samples=nb_samples)


@dataclasses.dataclass
class GaussianRast(_Rast):
    """Gaussian perturbed Heaviside with variance reduction."""

    sample_axis: Optional[str] = None


@dataclasses.dataclass
class GaussianRast_wovr(_Rast):
    """Gaussian perturbed Heaviside without variance reduction."""

    sample_axis: Optional[str] = None


@dataclasses.dataclass
class ArctanRast(_Rast):
    """Cauchy-noise perturbed Heaviside."""

    sample_axis: Optional[str] = None


@dataclasses.dataclass
class AffineRast(_Rast):
    """Clamped affine coverage (uniform-noise closed form).  Deterministic."""


@dataclasses.dataclass
class HardRast(_Rast):
    """Hard Heaviside coverage; sigma is inert."""

    sigma: torch.Tensor = dataclasses.field(
        default_factory=lambda: _scalar(0.0))
    nb_samples: int = 1

    @classmethod
    def create(cls):
        return cls()

    def update_smoothing(self, sigma):
        return self
