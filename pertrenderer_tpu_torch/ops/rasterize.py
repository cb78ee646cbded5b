"""Rasterization settings and per-(face, pixel) geometry (PyTorch port of
``pertrenderer_tpu/ops/rasterize.py``: ``RasterizationSettings``,
``_edge_dist_sq`` and ``_face_pixel_geometry``).

Coordinate frame: NDC +x left, +y up; image pixel (0, 0) is top-left, NDC
(+1, +1).  ``dist`` is the signed squared NDC distance to the nearest face
edge, negative inside.  The staged top-K rasterizer is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["RasterizationSettings"]


@dataclasses.dataclass(frozen=True)
class RasterizationSettings:
    """Static rasterizer configuration (PyTorch3D's field names).  The
    JAX package's binning and chunking fields belong to routes the port
    does not run yet."""

    image_size: int = 128
    blur_radius: float = 0.0
    faces_per_pixel: int = 1
    perspective_correct: bool = False
    clip_barycentric_coords: Optional[bool] = None
    cull_backfaces: bool = False

    def resolve_clip(self) -> bool:
        if self.clip_barycentric_coords is None:
            return self.blur_radius > 0.0
        return self.clip_barycentric_coords


def _edge_dist_sq(px, py, ax, ay, bx, by):
    """Squared distance from pixel (px, py) to segment (a, b); broadcasting.
    The per-edge constants have the face shape only."""
    ex, ey = bx - ax, by - ay
    inv_denom = 1.0 / torch.clamp(ex * ex + ey * ey, min=1e-12)
    exs, eys = ex * inv_denom, ey * inv_denom
    dx, dy = px - ax, py - ay
    t = torch.clamp(dx * exs + dy * eys, 0.0, 1.0)
    rx = dx - t * ex
    ry = dy - t * ey
    return rx * rx + ry * ry


def _face_pixel_geometry(px, py, ax, ay, az, bx, by, bz, cx, cy, cz,
                         clip: bool, perspective_correct: bool):
    """Per pixel x face geometry on broadcastable coordinate tensors.

    Returns (w0, w1, w2, z, dist, inside, degenerate): interpolation
    barycentrics (optionally perspective-corrected, then clipped), the
    interpolated view depth and the signed squared edge distance."""
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    degenerate = torch.abs(area) < 1e-10
    inv_area = 1.0 / torch.where(degenerate, torch.ones_like(area), area)
    e0x = (cy - by) * inv_area
    e0y = (cx - bx) * inv_area
    w0 = e0y * py - e0x * px + (e0x * bx - e0y * by)
    e1x = (ay - cy) * inv_area
    e1y = (ax - cx) * inv_area
    w1 = e1y * py - e1x * px + (e1x * cx - e1y * cy)
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ~degenerate

    d0 = _edge_dist_sq(px, py, ax, ay, bx, by)
    d1 = _edge_dist_sq(px, py, bx, by, cx, cy)
    d2 = _edge_dist_sq(px, py, cx, cy, ax, ay)
    min_d = torch.minimum(d0, torch.minimum(d1, d2))
    dist = torch.where(inside, -min_d, min_d)

    if perspective_correct:
        s0 = w0 / torch.clamp(az, min=1e-8)
        s1 = w1 / torch.clamp(bz, min=1e-8)
        s2 = w2 / torch.clamp(cz, min=1e-8)
        denom = torch.clamp(s0 + s1 + s2, min=1e-12)
        w0, w1, w2 = s0 / denom, s1 / denom, s2 / denom
    if clip:
        c0 = torch.clamp(w0, min=0.0)
        c1 = torch.clamp(w1, min=0.0)
        c2 = torch.clamp(w2, min=0.0)
        denom = torch.clamp(c0 + c1 + c2, min=1e-12)
        w0, w1, w2 = c0 / denom, c1 / denom, c2 / denom
    z = w0 * az + w1 * bz + w2 * cz
    return w0, w1, w2, z, dist, inside, degenerate
