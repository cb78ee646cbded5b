"""Differentiable perspective cameras (PyTorch port of
``pertrenderer_tpu/cameras.py``).

Conventions (PyTorch3D's): world/view +X left, +Y up, +Z into the screen;
row-vector transforms ``x_view = x_world @ R + T``; NDC +x LEFT and +y UP;
the rasterizer consumes NDC x/y with VIEW-space depth z.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from pertrenderer_tpu_torch.transforms import _rounded, cross3, matmul3

__all__ = ["PerspectiveCameras", "OpenGLPerspectiveCameras",
           "look_at_rotation", "look_at_view_transform"]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _batched_scalar(x, n: int, device) -> torch.Tensor:
    return torch.atleast_1d(_f32(x, device)).expand(n)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """sqrt(sum v^2) over the last axis (the JAX package's ``linalg.norm``)."""
    return _rounded(torch.sqrt, torch.sum(v * v, dim=-1, keepdim=True))


@dataclasses.dataclass
class PerspectiveCameras:
    """Batch of FoV perspective cameras.

    R: (N, 3, 3) world-to-view rotations; T: (N, 3) translations; fov: (N,)
    vertical field of view in degrees; znear, zfar, aspect_ratio: (N,).
    """

    R: torch.Tensor
    T: torch.Tensor
    fov: torch.Tensor
    znear: torch.Tensor
    zfar: torch.Tensor
    aspect_ratio: torch.Tensor

    @classmethod
    def create(cls, R=None, T=None, fov=60.0, znear=1.0, zfar=100.0,
               aspect_ratio=1.0, device="cuda") -> "PerspectiveCameras":
        R = torch.eye(3)[None] if R is None else R
        R = _f32(R, device)
        if R.dim() == 2:
            R = R[None]
        n = R.shape[0]
        T = _f32(torch.zeros(n, 3) if T is None else T, device)
        if T.dim() == 1:
            T = T[None]
        return cls(R=R, T=T, fov=_batched_scalar(fov, n, device),
                   znear=_batched_scalar(znear, n, device),
                   zfar=_batched_scalar(zfar, n, device),
                   aspect_ratio=_batched_scalar(aspect_ratio, n, device))

    @property
    def batch_size(self) -> int:
        return self.R.shape[0]

    def camera_center(self) -> torch.Tensor:
        """World-space camera positions (N, 3): C = -T @ R^T."""
        return -matmul3(self.T[:, None, :], self.R.transpose(-1, -2))[:, 0]

    def transform_points_view(self, points: torch.Tensor) -> torch.Tensor:
        """World -> view. points: (N, P, 3)."""
        return matmul3(points, self.R) + self.T[:, None, :]

    def project_view_to_ndc(self, points_view: torch.Tensor) -> torch.Tensor:
        """View -> (x_ndc, y_ndc, z_view); focal s = 1 / tan(fov / 2), the
        tangent correctly rounded (float32 library tangents miss it in the
        last place for a few percent of angles, and differ by device)."""
        s = 1.0 / _rounded(torch.tan, 0.5 * torch.deg2rad(self.fov))
        z = points_view[..., 2]
        tiny = torch.where(z < 0, torch.full_like(z, -1e-8),
                           torch.full_like(z, 1e-8))
        safe_z = torch.where(torch.abs(z) < 1e-8, tiny, z)
        x_ndc = (s[:, None] / self.aspect_ratio[:, None]
                 * points_view[..., 0] / safe_z)
        y_ndc = s[:, None] * points_view[..., 1] / safe_z
        return torch.stack([x_ndc, y_ndc, z], dim=-1)

    def transform_points_ndc(self, points_world: torch.Tensor) -> torch.Tensor:
        """World -> (x_ndc, y_ndc, z_view)."""
        return self.project_view_to_ndc(
            self.transform_points_view(points_world))


OpenGLPerspectiveCameras = PerspectiveCameras


def look_at_rotation(camera_position, at=None, up=None,
                     device="cuda") -> torch.Tensor:
    """Rotations (N, 3, 3) whose columns are the camera x/y/z axes in world
    coordinates, for cameras at ``camera_position`` looking at ``at``."""
    camera_position = torch.atleast_2d(_f32(camera_position, device))
    n = camera_position.shape[0]
    at = _f32((0.0, 0.0, 0.0) if at is None else at, device).expand(n, 3)
    up = _f32((0.0, 1.0, 0.0) if up is None else up, device).expand(n, 3)

    def unit(v):
        return v / torch.clamp(_norm(v), min=1e-8)

    z_axis = unit(at - camera_position)
    x_axis = cross3(up, z_axis)
    fallback = _f32((1.0, 0.0, 0.0), device).expand_as(x_axis)
    x_axis = unit(torch.where(_norm(x_axis) < 1e-6, fallback, x_axis))
    y_axis = unit(cross3(z_axis, x_axis))
    return torch.stack([x_axis, y_axis, z_axis], dim=-1)


def look_at_view_transform(dist=1.0, elev=0.0, azim=0.0, degrees=True,
                           at=None, up=None, device="cuda"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera (R, T) from spherical coordinates; dist/elev/azim broadcast to
    a common batch (N,).  elev = azim = 0 puts the camera at (0, 0, dist)."""
    dist, elev, azim = (torch.atleast_1d(_f32(x, device))
                        for x in (dist, elev, azim))
    n = max(dist.shape[0], elev.shape[0], azim.shape[0])
    dist, elev, azim = dist.expand(n), elev.expand(n), azim.expand(n)
    if degrees:
        elev, azim = torch.deg2rad(elev), torch.deg2rad(azim)
    at_arr = _f32((0.0, 0.0, 0.0) if at is None else at, device).expand(n, 3)
    cos_e, sin_e = _rounded(torch.cos, elev), _rounded(torch.sin, elev)
    cos_a, sin_a = _rounded(torch.cos, azim), _rounded(torch.sin, azim)
    x = dist * cos_e * sin_a
    y = dist * sin_e
    z = dist * cos_e * cos_a
    camera_position = torch.stack([x, y, z], dim=-1) + at_arr
    R = look_at_rotation(camera_position, at=at_arr, up=up, device=device)
    T = -matmul3(camera_position[:, None, :], R)[:, 0]
    return R, T
