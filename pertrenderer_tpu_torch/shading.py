"""Per-pixel Phong shading on the staged route (PyTorch port of
``pertrenderer_tpu/shading.py``): interpolate world positions and vertex
normals at every fragment, light them (ambient + diffuse + specular) and
modulate the texels.

``phong_shading_cm`` is the channel-major hot path: positions and normals
in one six-wide interpolating gather (``ops/interp_gather.py``, kernel
K10a; its gradients K10b), every 3-vector field with its channels first.
``phong_shading`` is the PyTorch3D-layout version the baseline shaders
use (a per-pixel corner gather, K9a, and the barycentric sum).
"""

from __future__ import annotations

import torch

from pertrenderer_tpu_torch.lights import (DirectionalLights, PointLights,
                                           diffuse_specular)
from pertrenderer_tpu_torch.ops.gather import take_rows_batched
from pertrenderer_tpu_torch.ops.interp_gather import interp_rows_cm_batched
from pertrenderer_tpu_torch.textures import interpolate_face_attributes

__all__ = ["apply_lighting", "phong_shading", "phong_shading_cm"]


def _per_batch(x: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    x = x.to(points.device)
    return x.reshape((x.shape[0],) + (1,) * (points.dim() - 2) + (3,))


def corner_table(meshes) -> torch.Tensor:
    """(N, F, 3, 6): each face's corner positions and vertex normals, in
    one row gather."""
    return take_rows_batched(
        torch.cat([meshes.verts, meshes.verts_normals()], dim=-1),
        torch.clamp(meshes.faces, min=0))


def apply_lighting(points, normals, lights, cameras, materials):
    """(ambient, diffuse, specular) of shaded points and normals (N, ..., 3),
    each (N, ..., 3)."""
    diffuse, specular = diffuse_specular(
        lights, normals, points, cameras.camera_center(),
        materials.shininess)
    ambient = _per_batch(materials.ambient_color * lights.ambient_color,
                         points)
    diffuse = diffuse * _per_batch(materials.diffuse_color, points)
    specular = specular * _per_batch(materials.specular_color, points)
    return ambient, diffuse, specular


def phong_shading(meshes, fragments, texels, lights, cameras, materials):
    """Per-fragment Phong colours (N, H, W, K, 3):
    (ambient + diffuse) * texels + specular."""
    vals = interpolate_face_attributes(
        fragments.pix_to_face, fragments.bary_coords, corner_table(meshes))
    points, normals = vals[..., :3], vals[..., 3:]
    ambient, diffuse, specular = apply_lighting(points, normals, lights,
                                                cameras, materials)
    return (ambient + diffuse) * texels + specular


def _normalize_cm(v, eps=1e-8):
    """Normalize a channel-major (3, ...) vector field along axis 0."""
    norm = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    return v / torch.maximum(norm, norm.new_tensor(eps))


def phong_shading_cm(meshes, pfrag, texels_cm, lights, cameras, materials):
    """Channel-major Phong colours (3, N, H, W, K) from planar fragments and
    channel-major texels; point or directional lights."""
    vals = interp_rows_cm_batched(corner_table(meshes), pfrag.pix_to_face,
                                  pfrag.w0, pfrag.w1, pfrag.w2)
    # vals: (6, N, H, W, K)
    points, normals = vals[:3], vals[3:]

    def b(x):  # (N, 3) -> (3, N, 1, 1, 1)
        x = x.to(points.device)
        return torch.movedim(x, -1, 0).reshape(
            (3, x.shape[0]) + (1,) * (points.dim() - 2))

    if isinstance(lights, PointLights):
        to_light = _normalize_cm(b(lights.location) - points)
    elif isinstance(lights, DirectionalLights):
        to_light = _normalize_cm(b(-lights.direction)).expand(points.shape)
    else:
        raise NotImplementedError(
            "phong_shading_cm supports Point/DirectionalLights, got "
            f"{type(lights).__name__}")
    zero = points.new_tensor(0.0)
    cos_angle = torch.sum(normals * to_light, dim=0)          # (N, H, W, K)
    diffuse = torch.maximum(cos_angle, zero) * b(lights.diffuse_color)
    view_dir = _normalize_cm(b(cameras.camera_center()) - points)
    reflect = 2.0 * cos_angle * normals - to_light
    alpha = torch.maximum(torch.sum(view_dir * reflect, dim=0), zero)
    facing = (cos_angle > 0.0).to(points.dtype)
    shin = materials.shininess.to(points.device).reshape(
        (materials.shininess.shape[0],) + (1,) * (points.dim() - 2))
    specular = (facing * torch.pow(alpha, shin)) * b(lights.specular_color)
    ambient = b(materials.ambient_color * lights.ambient_color)
    diffuse = diffuse * b(materials.diffuse_color)
    specular = specular * b(materials.specular_color)
    return (ambient + diffuse) * texels_cm + specular
