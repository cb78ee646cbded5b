"""Rasterizer + shader composition (PyTorch port of
``pertrenderer_tpu/models/renderer.py``).

``MeshRenderer(meshes, seeds=..., generator=...)`` renders (N, H, W, 4) RGBA
through the route the JAX package takes: the flat fused forward (kernel
K3, gradients K4), the stream forward (K5, gradients K6) or, for a mesh
above 8192 faces opted in with ``bin_overflow='allow'``, the binned
forward (K12 over per-tile slot tables, its gradients from K12's backward
and K9b) for the perturbed shaders; ``render_loss`` gives an image loss
and all its gradients from one launch of K2, K7 or K12's loss-and-grad.
Everything else — the baseline
shaders, znear/zfar overrides, shader and rasterizer cameras that differ,
and configurations the fused kernels decline — takes the staged route:
``MeshRasterizer`` (select and derive, kernels K9a / K9b), then the
shader (texture sampling, Phong shading with K10a / K10b, blending), whose
Monte-Carlo estimators run as kernels K8a (coverage) and K8b / K8c
(aggregation).  Estimators with a ``sample_axis`` take the sample-sharded
flat route (K11a, K3 with external coverage, K11b, K11c) or the stream
route with the aggregation samples sharded, averaged over the sample
group (``parallel.sharding``); the staged estimators average themselves.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from pertrenderer_tpu_torch.ops import fused_render
from pertrenderer_tpu_torch.ops.rasterize import (RasterizationSettings,
                                                  rasterize_meshes,
                                                  rasterize_planar)

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

    def _cameras(self, cameras):
        cameras = cameras if cameras is not None else self.cameras
        if cameras is None:
            raise ValueError("Cameras must be specified either at "
                             "initialization or in the forward pass")
        return cameras

    def forward(self, meshes, cameras=None, **kwargs):
        """PyTorch3D-layout fragments of ``meshes`` (the staged route)."""
        return rasterize_meshes(meshes, self._cameras(cameras),
                                self.raster_settings,
                                blur_radius=self.blur_override)

    def planar(self, meshes, cameras=None):
        """Channel-major fragments (the staged hot path)."""
        return rasterize_planar(meshes, self._cameras(cameras),
                                self.raster_settings,
                                blur_radius=self.blur_override)

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

    def _fused_args(self, cameras, kwargs):
        """The fused routes' arguments, or None where the JAX package
        renders staged: a shader outside the fused menu, znear/zfar
        overrides, or shader cameras other than the rasterizer's."""
        shader = self.shader
        shade = self._FUSED_SHADE.get(type(shader).__name__)
        if shade is None or cameras is None:
            return None
        if "znear" in kwargs or "zfar" in kwargs:
            return None
        # The staged route shades through the shader's own cameras; the
        # fused routes need them to be the rasterizer's.
        if kwargs.get("cameras", shader.cameras) is not cameras:
            return None
        return (cameras, kwargs.get("lights", shader.lights),
                kwargs.get("materials", shader.materials),
                shader.smoothrast, shader.smoothagg,
                kwargs.get("blend_params", shader.blend_params),
                self.rasterizer.raster_settings), shade

    def _fused(self, meshes, kwargs):
        """(the fused route's configuration, its arguments, shade) if a
        fused route takes this render, else None."""
        cameras = kwargs.get("cameras", self.rasterizer.cameras)
        if cameras is None:
            raise ValueError("Cameras must be specified either at "
                             "initialization or in the forward pass")
        args = self._fused_args(cameras, kwargs)
        if args is None:
            return None
        (_c, lights, _m, sr, sa, _b, settings), shade = args
        cfg, _why = fused_render._plan(meshes, lights, sr, sa, settings,
                                       shade)
        return None if cfg is None else (cfg, *args)

    def _staged(self, meshes, seeds, generator, kwargs):
        """Rasterize (planar fragments for the perturbed shaders), then
        shade; the seed words are drawn from ``generator`` when not given,
        as the fused routes draw them."""
        agg = getattr(self.shader, "smoothagg", None)
        if agg is not None:         # the perturbed shaders draw MC noise
            self._check_device(meshes.device)
        if seeds is None:
            seeds = fused_render.draw_seeds(
                meshes.batch_size, generator,
                getattr(agg, "fixed_noise", False), device=meshes.device)
        cameras = kwargs.get("cameras", self.rasterizer.cameras)
        if getattr(type(self.shader), "planar_input", False):
            fragments = self.rasterizer.planar(meshes, cameras=cameras)
        else:
            fragments = self.rasterizer(meshes, cameras=cameras)
        return self.shader(fragments, meshes, seeds=seeds, **kwargs)

    def forward(self, meshes, seeds=None,
                generator: Optional[torch.Generator] = None, **kwargs):
        """Render ``meshes``.  ``seeds``: (N, 4) int32 seed words (or JAX
        (N, 1, 8) seed rows), words 0/1 keying the coverage noise and 2/3
        the aggregation's; drawn from ``generator`` (a CPU generator, seed
        0 if None) when not given; the deterministic estimators ignore
        them.  kwargs override cameras, lights, materials, blend_params
        (and, staged, znear / zfar).  The first fused or perturbed staged
        render on a CUDA device checks the card's hash-PRNG stream (kernel
        K1) before rendering."""
        fused = self._fused(meshes, kwargs)
        if fused is None:
            return self._staged(meshes, seeds, generator, kwargs)
        cfg, (cameras, lights, materials, sr, sa, blend, settings), shade = \
            fused
        self._check_device(meshes.device)
        return fused_render.try_render(
            cfg, meshes, cameras, lights, materials, sr, sa, blend, settings,
            shade, seeds=seeds, generator=generator,
            blur_override=self.rasterizer.blur_override)

    def plan(self, meshes, **kwargs) -> fused_render.RenderPlan:
        """Routing report: the route this renderer takes for ``meshes``,
        and why."""
        cameras = kwargs.get("cameras", self.rasterizer.cameras)
        args = self._fused_args(cameras, kwargs)
        settings = self.rasterizer.raster_settings
        if args is None:
            return fused_render.RenderPlan(
                mode="staged",
                reason="shader %s (or camera resolution) is not "
                       "fused-eligible" % type(self.shader).__name__,
                f=int(meshes.max_faces), k=int(settings.faces_per_pixel),
                image_size=settings.image_size)
        (_cams, lights, _mats, sr, sa, _blend, settings), shade = args
        return fused_render.render_plan(meshes, lights, sr, sa, settings,
                                        shade)

    def render_loss(self, meshes, target, seeds=None,
                    generator: Optional[torch.Generator] = None,
                    loss_kind: str = "l2_rgb", **kwargs):
        """Mean image loss against ``target`` (broadcast to (N, H, W, 3))
        over the RGB channels: ``l2_rgb`` = mean squared error (the pose
        loop's loss), ``l1_rgb`` = mean absolute error.  On the fused
        routes the loss and every gradient come from one launch of K2 (or
        K7), so ``loss.backward()`` launches nothing more; elsewhere, the
        sample-sharded routes included, the render is reduced as the
        reference does.  The target is a
        constant: it gets no gradient.  ``seeds``, ``generator`` and kwargs
        as for :meth:`forward`."""
        if loss_kind not in fused_render.LOSS_KINDS:
            raise ValueError(f"unknown loss_kind {loss_kind!r} (expected "
                             "'l2_rgb' or 'l1_rgb')")
        fused = self._fused(meshes, kwargs)
        if fused is not None:
            cfg, (cameras, lights, materials, sr, sa, blend, settings), \
                shade = fused
            self._check_device(meshes.device)
            loss = fused_render.try_render_loss(
                cfg, meshes, cameras, lights, materials, sr, sa, blend,
                settings, shade, target, loss_kind, seeds=seeds,
                generator=generator,
                blur_override=self.rasterizer.blur_override)
            if loss is not None:
                return loss
        images = self(meshes, seeds=seeds, generator=generator, **kwargs)
        diff = images[..., :3] - torch.as_tensor(
            target, dtype=torch.float32, device=images.device).detach()
        if loss_kind == "l1_rgb":
            return torch.mean(torch.abs(diff))
        return torch.mean(diff ** 2)
