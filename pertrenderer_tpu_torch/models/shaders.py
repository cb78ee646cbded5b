"""Shaders (PyTorch port of ``pertrenderer_tpu/models/shaders.py``).

``RandomPhongShader`` / ``RandomSimpleShader`` hold the shading and
smoothing configuration that ``MeshRenderer`` hands to the fused routes;
called on fragments they run the staged route: sample the texture, Phong
shading (``shading.phong_shading_cm``) and the perturbed blend, whose
Monte-Carlo estimators are kernels K8a-c.  The
PyTorch3D baselines ``SimpleShader``, ``SoftSimpleShader``,
``HardPhongShader`` (the experiments' target renderer), ``SoftPhongShader``
and ``SoftSilhouetteShader`` run only staged.  A shader maps (fragments,
meshes, **overrides) to (N, H, W, 4) RGBA; cameras, lights, materials,
blend_params, znear and zfar may be overridden per call.
``update_smoothing`` / ``update_nb_samples`` return new shaders, as the
pose loop's annealing uses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from pertrenderer_tpu_torch.blending import (BlendParams, hard_rgb_blend,
                                             smooth_rgb_blend_cm,
                                             softmax_rgb_blend)
from pertrenderer_tpu_torch.cameras import (PerspectiveCameras,
                                            look_at_view_transform)
from pertrenderer_tpu_torch.lights import Materials, PointLights
from pertrenderer_tpu_torch.models.smoothagg import SoftAgg
from pertrenderer_tpu_torch.models.smoothrast import SoftRast
from pertrenderer_tpu_torch.ops.rasterize import as_planar
from pertrenderer_tpu_torch.shading import phong_shading, phong_shading_cm

__all__ = ["RandomPhongShader", "RandomSimpleShader", "SimpleShader",
           "SoftSimpleShader", "HardPhongShader", "SoftPhongShader",
           "SoftSilhouetteShader"]


def _znear_zfar(cameras, kwargs):
    """(znear, zfar) shaped (N, 1, 1, 1): the overrides, else the
    cameras'."""
    def get(name):
        x = torch.as_tensor(kwargs.get(name, getattr(cameras, name)),
                            dtype=torch.float32, device=cameras.R.device)
        return x.reshape(-1, 1, 1, 1)
    return get("znear"), get("zfar")


def _cameras(shader, kwargs):
    cameras = kwargs.get("cameras", shader.cameras)
    if cameras is None:
        raise ValueError("Cameras must be specified either at "
                         "initialization or in the forward pass")
    return cameras


@dataclasses.dataclass
class _RandomShader:
    planar_input = True     # MeshRenderer hands it PlanarFragments

    cameras: Optional[PerspectiveCameras] = None
    lights: Optional[Any] = None
    materials: Optional[Materials] = None
    smoothrast: Any = None
    smoothagg: Any = None
    blend_params: Optional[BlendParams] = None

    @classmethod
    def create(cls, cameras=None, lights=None, materials=None,
               smoothrast=None, smoothagg=None, blend_params=None,
               device="cuda"):
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

    def get_nb_samples(self):
        return self.smoothagg.nb_samples

    def update_smoothing(self, sigma=4e-4, gamma=4e-2, alpha=1.0):
        return dataclasses.replace(
            self, smoothrast=self.smoothrast.update_smoothing(sigma),
            smoothagg=self.smoothagg.update_smoothing(gamma, alpha))

    def update_nb_samples(self, nb_samples=16):
        return dataclasses.replace(
            self, smoothrast=self.smoothrast.update_nb_samples(nb_samples),
            smoothagg=self.smoothagg.update_nb_samples(nb_samples))


@dataclasses.dataclass
class RandomPhongShader(_RandomShader):
    """Phong shading + perturbed blending."""

    def __call__(self, fragments, meshes, seeds=None, **kwargs):
        """The staged route: sample, Phong (K10a), perturbed blend.
        ``seeds``: (N, 4) int32 seed words of the MC estimators (K8a-c),
        drawn from a generator seeded 0 when None."""
        cameras = _cameras(self, kwargs)
        pfrag = as_planar(fragments)
        colors_cm = phong_shading_cm(
            meshes, pfrag, meshes.sample_textures_cm(pfrag),
            kwargs.get("lights", self.lights), cameras,
            kwargs.get("materials", self.materials))
        znear, zfar = _znear_zfar(cameras, kwargs)
        return smooth_rgb_blend_cm(
            colors_cm, pfrag, self.smoothrast, self.smoothagg,
            kwargs.get("blend_params", self.blend_params), znear=znear,
            zfar=zfar, seeds=seeds)


@dataclasses.dataclass
class RandomSimpleShader(_RandomShader):
    """Texels straight to perturbed blending, no lighting.  Its default
    camera looks at the origin from dist 2.7."""

    @classmethod
    def create(cls, cameras=None, lights=None, materials=None,
               smoothrast=None, smoothagg=None, blend_params=None,
               device="cuda"):
        if cameras is None:
            r, t = look_at_view_transform(dist=2.7, elev=0.0, azim=0.0,
                                          device=device)
            cameras = PerspectiveCameras.create(R=r, T=t, device=device)
        return super().create(cameras, lights, materials, smoothrast,
                              smoothagg, blend_params, device=device)

    def __call__(self, fragments, meshes, seeds=None, **kwargs):
        """The staged route: texels straight to the perturbed blend
        (``seeds`` as for RandomPhongShader)."""
        cameras = _cameras(self, kwargs)
        pfrag = as_planar(fragments)
        znear, zfar = _znear_zfar(cameras, kwargs)
        return smooth_rgb_blend_cm(
            meshes.sample_textures_cm(pfrag), pfrag, self.smoothrast,
            self.smoothagg, kwargs.get("blend_params", self.blend_params),
            znear=znear, zfar=zfar, seeds=seeds)


@dataclasses.dataclass
class SimpleShader:
    """Hard texel blending (the nearest fragment's texel)."""

    blend_params: Optional[BlendParams] = None

    @classmethod
    def create(cls, blend_params=None):
        return cls(blend_params=blend_params if blend_params is not None
                   else BlendParams())

    def __call__(self, fragments, meshes, seeds=None, **kwargs):
        return hard_rgb_blend(meshes.sample_textures(fragments), fragments,
                              kwargs.get("blend_params", self.blend_params))


@dataclasses.dataclass
class SoftSimpleShader:
    """Softmax texel blending (znear 1, zfar 100 unless cameras are
    passed)."""

    blend_params: Optional[BlendParams] = None

    @classmethod
    def create(cls, blend_params=None):
        return cls(blend_params=blend_params if blend_params is not None
                   else BlendParams())

    def __call__(self, fragments, meshes, seeds=None, **kwargs):
        znear, zfar = 1.0, 100.0
        if kwargs.get("cameras") is not None:
            znear, zfar = _znear_zfar(kwargs["cameras"], kwargs)
        return softmax_rgb_blend(
            meshes.sample_textures(fragments), fragments,
            kwargs.get("blend_params", self.blend_params), znear, zfar)


@dataclasses.dataclass
class _PhongShader:
    cameras: Optional[PerspectiveCameras] = None
    lights: Optional[Any] = None
    materials: Optional[Materials] = None
    blend_params: Optional[BlendParams] = None

    @classmethod
    def create(cls, cameras=None, lights=None, materials=None,
               blend_params=None, device="cuda"):
        return cls(
            cameras=cameras,
            lights=(lights if lights is not None
                    else PointLights.create(device=device)),
            materials=(materials if materials is not None
                       else Materials.create(device=device)),
            blend_params=blend_params if blend_params is not None
            else BlendParams())

    def _colors(self, fragments, meshes, kwargs):
        cameras = _cameras(self, kwargs)
        colors = phong_shading(
            meshes, fragments, meshes.sample_textures(fragments),
            kwargs.get("lights", self.lights), cameras,
            kwargs.get("materials", self.materials))
        return colors, cameras


@dataclasses.dataclass
class HardPhongShader(_PhongShader):
    """Phong shading + hard blending: the experiments' target renderer."""

    def __call__(self, fragments, meshes, seeds=None, **kwargs):
        colors, _ = self._colors(fragments, meshes, kwargs)
        return hard_rgb_blend(colors, fragments,
                              kwargs.get("blend_params", self.blend_params))


@dataclasses.dataclass
class SoftPhongShader(_PhongShader):
    """Phong shading + softmax blending."""

    def __call__(self, fragments, meshes, seeds=None, **kwargs):
        colors, cameras = self._colors(fragments, meshes, kwargs)
        znear, zfar = _znear_zfar(cameras, kwargs)
        return softmax_rgb_blend(
            colors, fragments, kwargs.get("blend_params", self.blend_params),
            znear, zfar)


@dataclasses.dataclass
class SoftSilhouetteShader:
    """Silhouette: RGB 1, alpha the sigmoid-coverage blend."""

    blend_params: Optional[BlendParams] = None

    @classmethod
    def create(cls, blend_params=None):
        return cls(blend_params=blend_params if blend_params is not None
                   else BlendParams())

    def __call__(self, fragments, meshes, seeds=None, **kwargs):
        blend = kwargs.get("blend_params", self.blend_params)
        prob = torch.where(fragments.pix_to_face >= 0,
                           torch.sigmoid(-fragments.dists / blend.sigma),
                           0.0)
        alpha = 1.0 - torch.prod(1.0 - prob, dim=-1, keepdim=True)
        rgb = torch.ones(alpha.shape[:-1] + (3,), dtype=alpha.dtype,
                         device=alpha.device)
        return torch.cat([rgb, alpha], dim=-1)
