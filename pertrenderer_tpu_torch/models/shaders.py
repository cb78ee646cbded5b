"""Perturbed shaders (PyTorch port of ``RandomPhongShader`` and
``RandomSimpleShader`` in ``pertrenderer_tpu/models/shaders.py``).

They hold the shading and smoothing configuration that ``MeshRenderer``
hands to the fused forward.  The staged per-fragment ``__call__`` is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from pertrenderer_tpu_torch.blending import BlendParams
from pertrenderer_tpu_torch.cameras import (PerspectiveCameras,
                                            look_at_view_transform)
from pertrenderer_tpu_torch.lights import Materials, PointLights
from pertrenderer_tpu_torch.models.smoothagg import SoftAgg
from pertrenderer_tpu_torch.models.smoothrast import SoftRast

__all__ = ["RandomPhongShader", "RandomSimpleShader"]


@dataclasses.dataclass
class _RandomShader:
    cameras: Optional[PerspectiveCameras] = None
    lights: Optional[Any] = None
    materials: Optional[Materials] = None
    smoothrast: Any = None
    smoothagg: Any = None
    blend_params: Optional[BlendParams] = None

    @classmethod
    def create(cls, cameras=None, lights=None, materials=None,
               smoothrast=None, smoothagg=None, blend_params=None,
               device="cpu"):
        return cls(
            cameras=cameras,
            lights=(lights if lights is not None
                    else PointLights.create(device=device)),
            materials=(materials if materials is not None
                       else Materials.create(device=device)),
            smoothrast=smoothrast if smoothrast is not None
            else SoftRast.create(),
            smoothagg=smoothagg if smoothagg is not None
            else SoftAgg.create(),
            blend_params=blend_params if blend_params is not None
            else BlendParams())

    def get_smoothing(self):
        return (self.smoothrast.sigma, self.smoothagg.gamma,
                self.smoothagg.alpha)

    def update_smoothing(self, sigma=4e-4, gamma=4e-2, alpha=1.0):
        return dataclasses.replace(
            self, smoothrast=self.smoothrast.update_smoothing(sigma),
            smoothagg=self.smoothagg.update_smoothing(gamma, alpha))


@dataclasses.dataclass
class RandomPhongShader(_RandomShader):
    """Phong shading + perturbed blending."""


@dataclasses.dataclass
class RandomSimpleShader(_RandomShader):
    """Texels straight to perturbed blending, no lighting.  Its default
    camera looks at the origin from dist 2.7."""

    @classmethod
    def create(cls, cameras=None, lights=None, materials=None,
               smoothrast=None, smoothagg=None, blend_params=None,
               device="cpu"):
        if cameras is None:
            r, t = look_at_view_transform(dist=2.7, elev=0.0, azim=0.0,
                                          device=device)
            cameras = PerspectiveCameras.create(R=r, T=t, device=device)
        return super().create(cameras, lights, materials, smoothrast,
                              smoothagg, blend_params, device=device)
