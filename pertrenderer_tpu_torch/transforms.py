"""SO(3) transforms and rigid rotations (PyTorch port of
``pertrenderer_tpu/transforms.py``).

Row-vector convention throughout: ``x_out = x @ R``.  The 3-term products
of the pose path (``matmul3``) are written as separate multiplies and adds,
rounded in the order XLA rounds them at backend optimisation level 0: a
GEMM (oneDNN on the CPU, cuBLAS on the card) rounds its dot products as a
fused multiply-add chain, which moves posed vertices by an ulp and with
them the sort keys that key the Monte-Carlo noise.
"""

from __future__ import annotations

import torch

__all__ = ["matmul3", "cross3", "hat", "hat_inv", "so3_exp_map", "so3_exponential_map",
           "so3_log_map", "so3_relative_angle", "so3_rotation_angle",
           "quaternion_to_matrix", "random_rotations", "Rotate"]

_EPS = 1e-8


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a (..., m, 3) and b (..., 3, k), each entry rounded as
    (a0 b0 + a1 b1) + a2 b2: elementwise ops only, no GEMM and no
    contraction."""
    a0, a1, a2 = (a[..., i:i + 1] for i in range(3))
    b0, b1, b2 = (b[..., i:i + 1, :] for i in range(3))
    return (a0 * b0 + a1 * b1) + a2 * b2


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis in ``jnp.cross``'s rounding order
    (``torch.linalg.cross`` rounds otherwise)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _rounded(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` evaluated in float64 and rounded once to x's dtype: the
    correctly rounded value on every device (float32 library sqrt, sin and
    cos differ from it, and from one another, in the last place)."""
    return fn(x.double()).to(x.dtype)


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
    theta_sq = torch.clamp(torch.sum(log_rot * log_rot, dim=-1),
                           min=_EPS * _EPS)
    theta = _rounded(torch.sqrt, theta_sq)
    k = hat(log_rot)
    k2 = matmul3(k, k)
    a = (_rounded(torch.sin, theta) / theta)[..., None, None]
    # theta * theta as the clamped square itself: XLA simplifies
    # sqrt(x) * sqrt(x) to x, and the two differ in the last place.
    b = ((1.0 - _rounded(torch.cos, theta)) / theta_sq)[..., None, None]
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
    return so3_rotation_angle(matmul3(r1.transpose(-1, -2), r2),
                              eps=eps)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) [w, x, y, z] -> rotations (..., 3, 3)."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def random_rotations(n: int, generator=None, device="cuda") -> torch.Tensor:
    """Uniformly distributed rotations (n, 3, 3) from normalised gaussian
    quaternions drawn from a CPU ``generator``."""
    quat = torch.randn(n, 4, generator=generator)
    quat = quat / torch.sqrt(torch.sum(quat * quat, dim=-1, keepdim=True))
    return quaternion_to_matrix(quat).to(device)


class Rotate:
    """Rotation transform with the row-vector convention: p_out = p @ R."""

    def __init__(self, R: torch.Tensor):
        self.R = R if R.dim() == 3 else R[None]

    def transform_points(self, points: torch.Tensor) -> torch.Tensor:
        """points: (N, P, 3) -> (N, P, 3)."""
        return matmul3(points, self.R)
