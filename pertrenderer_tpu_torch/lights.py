"""Lights and materials for Phong shading (PyTorch port of
``pertrenderer_tpu/lights.py``), with PyTorch3D's defaults — lights
ambient 0.5, diffuse 0.3, specular 0.2; materials all ones with shininess
64 — and the staged route's per-point lighting (``direction_to_light``,
``diffuse_specular``).  Light locations are differentiable."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PointLights", "DirectionalLights", "Materials",
           "diffuse_specular"]


def _unit(d: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(d, dim=-1, keepdim=True)
    return d / torch.maximum(norm, norm.new_tensor(1e-8))


def _per_batch(x: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(B, 3) per-batch values shaped to broadcast against (N, ..., 3)
    points; B is 1 or N."""
    x = x.to(points.device)
    return x.reshape((x.shape[0],) + (1,) * (points.dim() - 2) + (3,))


def _color(x, n: int, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return torch.atleast_2d(x).expand(n, 3)


@dataclasses.dataclass
class Materials:
    ambient_color: torch.Tensor   # (N, 3)
    diffuse_color: torch.Tensor   # (N, 3)
    specular_color: torch.Tensor  # (N, 3)
    shininess: torch.Tensor       # (N,)

    @classmethod
    def create(cls, ambient_color=(1.0, 1.0, 1.0),
               diffuse_color=(1.0, 1.0, 1.0),
               specular_color=(1.0, 1.0, 1.0), shininess=64.0, batch=1,
               device="cuda") -> "Materials":
        shin = torch.as_tensor(shininess, dtype=torch.float32, device=device)
        return cls(ambient_color=_color(ambient_color, batch, device),
                   diffuse_color=_color(diffuse_color, batch, device),
                   specular_color=_color(specular_color, batch, device),
                   shininess=torch.atleast_1d(shin).expand(batch))


@dataclasses.dataclass
class PointLights:
    location: torch.Tensor        # (N, 3)
    ambient_color: torch.Tensor   # (N, 3)
    diffuse_color: torch.Tensor   # (N, 3)
    specular_color: torch.Tensor  # (N, 3)

    @classmethod
    def create(cls, location=(0.0, 1.0, 0.0), ambient_color=(0.5, 0.5, 0.5),
               diffuse_color=(0.3, 0.3, 0.3), specular_color=(0.2, 0.2, 0.2),
               batch=1, device="cuda") -> "PointLights":
        return cls(location=_color(location, batch, device),
                   ambient_color=_color(ambient_color, batch, device),
                   diffuse_color=_color(diffuse_color, batch, device),
                   specular_color=_color(specular_color, batch, device))

    def direction_to_light(self, points: torch.Tensor) -> torch.Tensor:
        """Unit vectors (N, ..., 3) from surface points to the light."""
        return _unit(_per_batch(self.location, points) - points)


@dataclasses.dataclass
class DirectionalLights:
    direction: torch.Tensor       # (N, 3) direction the light travels
    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor

    @classmethod
    def create(cls, direction=(0.0, 1.0, 0.0), ambient_color=(0.5, 0.5, 0.5),
               diffuse_color=(0.3, 0.3, 0.3), specular_color=(0.2, 0.2, 0.2),
               batch=1, device="cuda") -> "DirectionalLights":
        return cls(direction=_color(direction, batch, device),
                   ambient_color=_color(ambient_color, batch, device),
                   diffuse_color=_color(diffuse_color, batch, device),
                   specular_color=_color(specular_color, batch, device))

    def direction_to_light(self, points: torch.Tensor) -> torch.Tensor:
        """The unit vector against the light's direction, at every point."""
        d = _unit(-self.direction.to(points.device))
        return _per_batch(d, points).expand(points.shape)


def diffuse_specular(lights, normals: torch.Tensor, points: torch.Tensor,
                     camera_position: torch.Tensor, shininess: torch.Tensor):
    """Per-point (diffuse, specular) light, each (N, ..., 3): normals and
    world points (N, ..., 3), camera centres (N, 3), shininess (N,)."""
    to_light = lights.direction_to_light(points)
    cos_angle = torch.sum(normals * to_light, dim=-1, keepdim=True)
    zero = cos_angle.new_tensor(0.0)
    diffuse = _per_batch(lights.diffuse_color, points) * torch.maximum(
        cos_angle, zero)
    view_dir = _unit(_per_batch(camera_position, points) - points)
    reflect = 2.0 * cos_angle * normals - to_light
    alpha = torch.maximum(torch.sum(view_dir * reflect, dim=-1,
                                    keepdim=True), zero)
    facing = (cos_angle > 0.0).to(points.dtype)
    shin = shininess.to(points.device).reshape(
        (shininess.shape[0],) + (1,) * (points.dim() - 1))
    specular = (_per_batch(lights.specular_color, points) * facing
                * torch.pow(alpha, shin))
    return diffuse, specular
