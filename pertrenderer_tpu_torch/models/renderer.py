"""Rasterizer + shader composition (PyTorch port of
``pertrenderer_tpu/models/renderer.py``).

``MeshRenderer(meshes, seeds=..., generator=...)`` renders (N, H, W, 4) RGBA
through the flat fused forward (kernel K3), whose gradients come from K4;
``render_loss`` gives an image loss and all its gradients from one launch
of K2.  Configurations the JAX package sends down another route (stream,
binned, sharded, staged) raise ``NotImplementedError`` naming the route.
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
        """A rasterizer with the blur override set (the settings and the
        cameras are shared, this one is unchanged)."""
        out = MeshRasterizer(self.cameras, self.raster_settings)
        out.blur_override = torch.as_tensor(blur_radius, dtype=torch.float32)
        return out


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

    def replace(self, rasterizer=None, shader=None) -> "MeshRenderer":
        """A renderer with the given parts swapped in (the JAX package's
        ``renderer.replace``); it shares this one's checked devices."""
        out = MeshRenderer(rasterizer if rasterizer is not None
                           else self.rasterizer,
                           shader if shader is not None else self.shader)
        out._checked_devices = self._checked_devices
        return out

    def _check_device(self, dev):
        """Check a CUDA device's hash-PRNG stream (K1) once: every MC
        render draws from it and every MC gradient replays it."""
        if dev.type == "cuda" and dev not in self._checked_devices:
            fused_render.check_prng_stream(dev)
            self._checked_devices.add(dev)

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
        self._check_device(meshes.device)
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

    def render_loss(self, meshes, target, seeds=None,
                    generator: Optional[torch.Generator] = None,
                    loss_kind: str = "l2_rgb", **kwargs):
        """Mean image loss against ``target`` (broadcast to (N, H, W, 3))
        over the RGB channels: ``l2_rgb`` = mean squared error (the pose
        loop's loss), ``l1_rgb`` = mean absolute error.  The loss and every
        gradient come from one launch of K2, so ``loss.backward()``
        launches nothing more.  The target is a constant: it gets no
        gradient.  ``seeds``, ``generator`` and kwargs as for
        :meth:`forward`."""
        if loss_kind not in fused_render.LOSS_KINDS:
            raise ValueError(f"unknown loss_kind {loss_kind!r} (expected "
                             "'l2_rgb' or 'l1_rgb')")
        (cameras, lights, materials, sr, sa, blend, settings), shade = \
            self._fused_args(kwargs)
        self._check_device(meshes.device)
        return fused_render.try_render_loss(
            meshes, cameras, lights, materials, sr, sa, blend, settings,
            shade, target, loss_kind, seeds=seeds, generator=generator,
            blur_override=self.rasterizer.blur_override)
