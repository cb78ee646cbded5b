"""Rasterizer + shader composition (PyTorch port of
``pertrenderer_tpu/models/renderer.py``).

``MeshRenderer(meshes, seeds=..., generator=...)`` renders (N, H, W, 4) RGBA
through the flat fused forward (kernel K3).  Configurations the JAX package
sends down another route (stream, binned, sharded, staged) raise
``NotImplementedError`` naming the route.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from pertrenderer_tpu_torch.ops import fused_render
from pertrenderer_tpu_torch.ops.rasterize import RasterizationSettings

__all__ = ["MeshRasterizer", "MeshRenderer"]


class MeshRasterizer(nn.Module):
    """Holds the cameras and rasterization settings.  ``blur_override`` (set
    by :meth:`update_blur`) replaces the settings' blur radius, as
    annealing does, without changing the settings."""

    def __init__(self, cameras=None,
                 raster_settings: Optional[RasterizationSettings] = None):
        super().__init__()
        self.cameras = cameras
        self.raster_settings = (raster_settings if raster_settings is not None
                                else RasterizationSettings())
        self.blur_override: Optional[Any] = None

    @classmethod
    def create(cls, cameras=None, raster_settings=None):
        return cls(cameras=cameras, raster_settings=raster_settings)

    @property
    def blur(self):
        """The effective blur radius."""
        if self.blur_override is not None:
            return self.blur_override
        return self.raster_settings.blur_radius

    def update_blur(self, blur_radius) -> "MeshRasterizer":
        """Set the blur override in place; returns self."""
        self.blur_override = torch.as_tensor(blur_radius,
                                             dtype=torch.float32)
        return self


class MeshRenderer(nn.Module):
    """renderer(meshes, seeds=..., cameras=..., lights=...) -> (N, H, W, 4)."""

    _FUSED_SHADE = {"RandomPhongShader": "phong",
                    "RandomSimpleShader": "none"}

    def __init__(self, rasterizer: MeshRasterizer, shader):
        super().__init__()
        self.rasterizer = rasterizer
        self.shader = shader
        self._checked_devices = set()     # CUDA devices whose PRNG passed

    @classmethod
    def create(cls, rasterizer, shader):
        return cls(rasterizer=rasterizer, shader=shader)

    def _fused_args(self, kwargs):
        shader = self.shader
        shade = self._FUSED_SHADE.get(type(shader).__name__)
        cameras = kwargs.get("cameras", self.rasterizer.cameras)
        if shade is None:
            fused_render._unsupported(
                "staged", "shader %s is not fused-eligible"
                % type(shader).__name__)
        if cameras is None:
            raise ValueError("Cameras must be specified either at "
                             "initialization or in the forward pass")
        if "znear" in kwargs or "zfar" in kwargs:
            fused_render._unsupported("staged", "znear/zfar overrides")
        # The staged path shades through the shader's own cameras; the fused
        # forward needs them to be the rasterizer's.
        if kwargs.get("cameras", shader.cameras) is not cameras:
            fused_render._unsupported(
                "staged", "shader and rasterizer cameras differ")
        return (cameras, kwargs.get("lights", shader.lights),
                kwargs.get("materials", shader.materials),
                shader.smoothrast, shader.smoothagg,
                kwargs.get("blend_params", shader.blend_params),
                self.rasterizer.raster_settings), shade

    def forward(self, meshes, seeds=None,
                generator: Optional[torch.Generator] = None, **kwargs):
        """Render ``meshes``.  ``seeds``: (N, 4) int32 seed words (or JAX
        (N, 1, 8) seed rows); drawn from ``generator`` (a CPU generator,
        seed 0 if None) when not given.  kwargs override cameras, lights,
        materials and blend_params.  The first call on a CUDA device checks
        the card's hash-PRNG stream (kernel K1) before rendering."""
        (cameras, lights, materials, sr, sa, blend, settings), shade = \
            self._fused_args(kwargs)
        dev = meshes.device
        if dev.type == "cuda" and dev not in self._checked_devices:
            fused_render.check_prng_stream(dev)
            self._checked_devices.add(dev)
        return fused_render.try_render(
            meshes, cameras, lights, materials, sr, sa, blend, settings,
            shade, seeds=seeds, generator=generator,
            blur_override=self.rasterizer.blur_override)

    def plan(self, meshes, **kwargs) -> fused_render.RenderPlan:
        """Routing report: the route this renderer takes for ``meshes``."""
        (_cams, lights, _mats, sr, sa, _blend, settings), shade = \
            self._fused_args(kwargs)
        return fused_render.render_plan(meshes, lights, sr, sa, settings,
                                        shade)

    def render_loss(self, meshes, target, seeds=None, loss_kind="l2_rgb",
                    **kwargs):
        """Image loss with gradients: needs the backward kernels."""
        raise NotImplementedError(
            "render_loss: the backward kernels are not ported to PyTorch "
            "yet")
