"""Carry scene parameters across from the JAX package.

Each function takes plain values — numpy arrays, or anything ``np.asarray``
accepts, such as the JAX objects' fields — and builds the port's object.
:func:`from_reference` walks a JAX scene object (mesh, textures, cameras,
lights, materials, estimators, settings, shader, rasterizer or renderer)
by its field names — the baseline shaders and every field of the
rasterization settings included — so the tests feed both packages the
same scene, and a
pose-optimisation state (``log_rot`` through :func:`tensor`; sigma, gamma
and alpha as tensors, ``nb_samples`` and the blur override through the
renderer) starts the same in both.  Every estimator of the menu keeps its
class, so the ``_wovr`` members keep their variance-reduction bit.  No
JAX import is needed: fields are read with ``np.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pertrenderer_tpu_torch import (blending, cameras, lights,
                                    structures, textures)
from pertrenderer_tpu_torch.models import (renderer, shaders, smoothagg,
                                           smoothrast)
from pertrenderer_tpu_torch.ops.rasterize import RasterizationSettings

__all__ = ["tensor", "meshes", "textures_uv", "textures_vertex",
           "textures_atlas", "perspective_cameras", "point_lights",
           "directional_lights", "materials", "smoothrast_from",
           "smoothagg_from", "from_reference"]


def tensor(x, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """A numpy-convertible array as a tensor (copied)."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def textures_uv(maps, verts_uvs, faces_uvs, atlas_size=0, device="cuda"):
    return textures.TexturesUV(
        maps=tensor(maps, device=device),
        verts_uvs=tensor(verts_uvs, device=device),
        faces_uvs=tensor(faces_uvs, torch.int64, device),
        atlas_size=int(atlas_size))


def textures_vertex(verts_features, device="cuda"):
    return textures.TexturesVertex(tensor(verts_features, device=device))


def textures_atlas(atlas, device="cuda"):
    return textures.TexturesAtlas(tensor(atlas, device=device))


def meshes(verts, faces, num_verts, num_faces, tex=None, device="cuda"):
    return structures.Meshes(
        verts=tensor(verts, device=device),
        faces=tensor(faces, torch.int64, device),
        num_verts=tensor(num_verts, torch.int64, device),
        num_faces=tensor(num_faces, torch.int64, device), textures=tex)


def perspective_cameras(R, T, fov, znear, zfar, aspect_ratio,
                        device="cuda"):
    f = lambda x: tensor(x, device=device)
    return cameras.PerspectiveCameras(R=f(R), T=f(T), fov=f(fov),
                                      znear=f(znear), zfar=f(zfar),
                                      aspect_ratio=f(aspect_ratio))


def point_lights(location, ambient_color, diffuse_color, specular_color,
                 device="cuda"):
    f = lambda x: tensor(x, device=device)
    return lights.PointLights(f(location), f(ambient_color),
                              f(diffuse_color), f(specular_color))


def directional_lights(direction, ambient_color, diffuse_color,
                       specular_color, device="cuda"):
    f = lambda x: tensor(x, device=device)
    return lights.DirectionalLights(f(direction), f(ambient_color),
                                    f(diffuse_color), f(specular_color))


def materials(ambient_color, diffuse_color, specular_color, shininess,
              device="cuda"):
    f = lambda x: tensor(x, device=device)
    return lights.Materials(f(ambient_color), f(diffuse_color),
                            f(specular_color), f(shininess))


def smoothrast_from(name: str, sigma, nb_samples: int, device="cuda"):
    """The SmoothRast member ``name`` (the JAX class name)."""
    cls = getattr(smoothrast, name)
    if cls is smoothrast.HardRast:
        return cls()
    return dataclasses.replace(cls.create(), sigma=tensor(sigma,
                                                          device=device),
                               nb_samples=int(nb_samples))


def smoothagg_from(name: str, gamma, alpha, eps: float, nb_samples: int,
                   fixed_noise: bool = False, device="cuda"):
    """The SmoothAgg member ``name`` (the JAX class name)."""
    cls = getattr(smoothagg, name)
    if cls is smoothagg.HardAgg:
        return cls(eps=float(eps))
    agg = dataclasses.replace(cls.create(), gamma=tensor(gamma,
                                                         device=device),
                              alpha=tensor(alpha, device=device),
                              eps=float(eps), nb_samples=int(nb_samples))
    if fixed_noise:
        agg = dataclasses.replace(agg, fixed_noise=True)
    return agg


_RAST_NAMES = ("SoftRast", "GaussianRast", "GaussianRast_wovr",
               "ArctanRast", "AffineRast", "HardRast")
_AGG_NAMES = ("SoftAgg", "GaussianAgg", "GaussianAgg_wovr", "CauchyAgg",
              "UniformAgg", "HardAgg")


def from_reference(obj, device="cuda", _memo=None):
    """The port's counterpart of a JAX scene object, read field by field.
    Objects shared inside ``obj`` (a shader's and a rasterizer's cameras)
    stay shared."""
    memo = {} if _memo is None else _memo
    if obj is None:
        return None
    if id(obj) in memo:
        return memo[id(obj)]
    conv = lambda x: from_reference(x, device, memo)
    name = type(obj).__name__
    if name == "Meshes":
        out = meshes(obj.verts, obj.faces, obj.num_verts, obj.num_faces,
                     conv(obj.textures), device)
    elif name == "TexturesUV":
        out = textures_uv(obj.maps, obj.verts_uvs, obj.faces_uvs,
                          obj.atlas_size, device)
    elif name == "TexturesVertex":
        out = textures_vertex(obj.verts_features, device)
    elif name == "TexturesAtlas":
        out = textures_atlas(obj.atlas, device)
    elif name == "PerspectiveCameras":
        out = perspective_cameras(obj.R, obj.T, obj.fov, obj.znear, obj.zfar,
                                  obj.aspect_ratio, device)
    elif name == "PointLights":
        out = point_lights(obj.location, obj.ambient_color,
                           obj.diffuse_color, obj.specular_color, device)
    elif name == "DirectionalLights":
        out = directional_lights(obj.direction, obj.ambient_color,
                                 obj.diffuse_color, obj.specular_color,
                                 device)
    elif name == "Materials":
        out = materials(obj.ambient_color, obj.diffuse_color,
                        obj.specular_color, obj.shininess, device)
    elif name in _RAST_NAMES:
        out = smoothrast_from(name, obj.sigma, obj.nb_samples, device)
    elif name in _AGG_NAMES:
        out = smoothagg_from(name, obj.gamma, obj.alpha, obj.eps,
                             obj.nb_samples,
                             getattr(obj, "fixed_noise", False), device)
    elif name == "BlendParams":
        out = blending.BlendParams(
            float(obj.sigma), float(obj.gamma),
            tuple(float(c) for c in np.asarray(obj.background_color)))
    elif name == "RasterizationSettings":
        out = RasterizationSettings(**{
            f.name: getattr(obj, f.name)
            for f in dataclasses.fields(RasterizationSettings)})
    elif name in ("RandomPhongShader", "RandomSimpleShader"):
        out = getattr(shaders, name)(
            cameras=conv(obj.cameras), lights=conv(obj.lights),
            materials=conv(obj.materials), smoothrast=conv(obj.smoothrast),
            smoothagg=conv(obj.smoothagg),
            blend_params=conv(obj.blend_params))
    elif name in ("HardPhongShader", "SoftPhongShader"):
        out = getattr(shaders, name)(
            cameras=conv(obj.cameras), lights=conv(obj.lights),
            materials=conv(obj.materials),
            blend_params=conv(obj.blend_params))
    elif name in ("SimpleShader", "SoftSimpleShader",
                  "SoftSilhouetteShader"):
        out = getattr(shaders, name)(blend_params=conv(obj.blend_params))
    elif name == "MeshRasterizer":
        out = renderer.MeshRasterizer(conv(obj.cameras),
                                      conv(obj.raster_settings))
        if obj.blur_override is not None:
            out = out.update_blur(float(np.asarray(obj.blur_override)))
    elif name == "MeshRenderer":
        out = renderer.MeshRenderer(conv(obj.rasterizer), conv(obj.shader))
    else:
        raise TypeError(f"from_reference: no counterpart for {name}")
    memo[id(obj)] = out
    return out
