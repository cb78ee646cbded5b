"""Lights and materials for Phong shading (PyTorch port of
``pertrenderer_tpu/lights.py``): data holders with PyTorch3D's defaults —
lights ambient 0.5, diffuse 0.3, specular 0.2; materials all ones with
shininess 64."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PointLights", "DirectionalLights", "Materials"]


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
