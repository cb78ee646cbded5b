"""SO(3) transforms and rigid rotations (PyTorch port of
``pertrenderer_tpu/transforms.py``).

Row-vector convention throughout: ``x_out = x @ R``.  Every matmul runs at
full float32 — the package pins TF32 off at import (``__init__.py``).
"""

from __future__ import annotations

import torch

__all__ = ["hat", "hat_inv", "so3_exp_map", "so3_exponential_map",
           "so3_log_map", "so3_relative_angle", "so3_rotation_angle",
           "Rotate"]

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Map batched 3-vectors to skew-symmetric matrices: hat(v) @ x = v × x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def hat_inv(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat` (extracts the axis vector)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def so3_exp_map(log_rot: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (N, 3) -> rotations (N, 3, 3) (Rodrigues, with the
    angle clamped away from 0 as in the JAX package)."""
    theta_sq = torch.sum(log_rot * log_rot, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_EPS * _EPS))
    k = hat(log_rot)
    k2 = torch.matmul(k, k)
    a = (torch.sin(theta) / theta)[..., None, None]
    b = ((1.0 - torch.cos(theta)) / (theta * theta))[..., None, None]
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device)
    return eye.expand(k.shape) + a * k + b * k2


so3_exponential_map = so3_exp_map


def so3_rotation_angle(r: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Rotation angle of (N, 3, 3) matrices, in radians."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_angle = torch.clamp((trace - 1.0) * 0.5, -1.0 + eps, 1.0 - eps)
    return torch.arccos(cos_angle)


def so3_log_map(r: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Rotations (N, 3, 3) -> axis-angle vectors (N, 3)."""
    theta = so3_rotation_angle(r, eps=eps)
    vec = hat_inv(0.5 * (r - r.transpose(-1, -2)))   # sin(theta) * axis
    scale = theta / torch.clamp(torch.sin(theta), min=eps)
    return vec * scale[..., None]


def so3_relative_angle(r1: torch.Tensor, r2: torch.Tensor,
                       eps: float = 1e-4) -> torch.Tensor:
    """Angle of the relative rotation r1^T r2 (radians)."""
    return so3_rotation_angle(torch.matmul(r1.transpose(-1, -2), r2),
                              eps=eps)


class Rotate:
    """Rotation transform with the row-vector convention: p_out = p @ R."""

    def __init__(self, R: torch.Tensor):
        self.R = R if R.dim() == 3 else R[None]

    def transform_points(self, points: torch.Tensor) -> torch.Tensor:
        """points: (N, P, 3) -> (N, P, 3)."""
        return torch.matmul(points, self.R)
