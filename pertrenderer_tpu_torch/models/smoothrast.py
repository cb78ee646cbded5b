"""Coverage front-ends, the SmoothRast family (PyTorch port of
``pertrenderer_tpu/models/smoothrast.py``).

``sigma`` is a float32 scalar tensor (learnable: ``update_smoothing``
keeps a tensor that requires grad, so the pose step's gradient reaches
it); ``nb_samples`` sets the Monte-Carlo sample count, which annealing
doubles through ``update_nb_samples``.  The fused kernels evaluate the
estimators on the flat and stream routes; ``rasterize(dists, seeds)`` is
the staged route's coverage map: the deterministic members' closed forms
(SoftRast, AffineRast, HardRast) and the MC members' perturbed Heaviside
(kernel K8a), keyed by the (N, 2) int32 rasterization seed words.
``sample_axis`` names the sample-sharded route, which the port does not
run yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pertrenderer_tpu_torch.ops.perturbed import (heaviside,
                                                  perturbed_heaviside)

__all__ = ["SoftRast", "GaussianRast", "GaussianRast_wovr", "ArctanRast",
           "AffineRast", "HardRast"]


def _scalar(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


@dataclasses.dataclass
class _Rast:
    noise_type = "gaussian"          # the MC members' noise family
    variance_reduction = True

    sigma: torch.Tensor
    nb_samples: int = 16

    @classmethod
    def create(cls, sigma=2e-4, nb_samples=16, **kw):
        return cls(sigma=_scalar(sigma), nb_samples=nb_samples, **kw)

    def update_smoothing(self, sigma):
        return dataclasses.replace(self, sigma=_scalar(sigma))

    def update_nb_samples(self, nb_samples):
        return dataclasses.replace(self, nb_samples=int(nb_samples))

    def rasterize(self, dists, seeds=None):
        """The MC members' perturbed Heaviside of -dists (kernel K8a);
        ``seeds``: (N, 2) int32 seed words."""
        return perturbed_heaviside(-dists, self._sigma(dists), seeds,
                                   self.nb_samples, self.noise_type,
                                   self.variance_reduction,
                                   getattr(self, "sample_axis", None))

    def check_staged(self):
        """Raise NotImplementedError, before any work is done, where the
        staged route cannot run this estimator: a sharded sample axis."""
        if getattr(self, "sample_axis", None):
            raise NotImplementedError(
                "sharded route is not ported to PyTorch yet: the estimator "
                f"shards its samples over {self.sample_axis!r}")

    def _sigma(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.sigma, dtype=torch.float32,
                               device=like.device)


@dataclasses.dataclass
class SoftRast(_Rast):
    """sigmoid(-d / sigma) coverage.  Deterministic."""

    nb_samples: int = 1

    @classmethod
    def create(cls, sigma=2e-4, nb_samples=1):
        return cls(sigma=_scalar(sigma), nb_samples=nb_samples)

    def rasterize(self, dists, seeds=None):
        return torch.sigmoid(-dists / self._sigma(dists))


@dataclasses.dataclass
class GaussianRast(_Rast):
    """Gaussian perturbed Heaviside with variance reduction."""

    sample_axis: Optional[str] = None


@dataclasses.dataclass
class GaussianRast_wovr(_Rast):
    """Gaussian perturbed Heaviside without variance reduction."""

    variance_reduction = False

    sample_axis: Optional[str] = None


@dataclasses.dataclass
class ArctanRast(_Rast):
    """Cauchy-noise perturbed Heaviside."""

    noise_type = "cauchy"

    sample_axis: Optional[str] = None


@dataclasses.dataclass
class AffineRast(_Rast):
    """Clamped affine coverage (uniform-noise closed form).  Deterministic."""

    def rasterize(self, dists, seeds=None):
        x = -dists / self._sigma(dists)
        p = torch.where(x > 0.5, torch.ones_like(x), x + 0.5)
        return torch.maximum(p, p.new_tensor(0.0))


@dataclasses.dataclass
class HardRast(_Rast):
    """Hard Heaviside coverage; sigma is inert."""

    sigma: torch.Tensor = dataclasses.field(
        default_factory=lambda: _scalar(0.0))
    nb_samples: int = 1

    @classmethod
    def create(cls):
        return cls()

    def rasterize(self, dists, seeds=None):
        return heaviside(-dists)

    def update_smoothing(self, sigma):
        return self

    def update_nb_samples(self, nb_samples):
        return self
