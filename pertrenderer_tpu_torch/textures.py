"""Textures: per-vertex colours, UV maps, per-face atlases (PyTorch port
of ``pertrenderer_tpu/textures.py``).

The fused routes read textures as per-face tables (the UV map through
``TexturesUV._bake_atlas``).  The staged route samples them per fragment:
``sample`` (PyTorch3D layout, (N, H, W, K, C)) and ``sample_cm``
(channel-major, (C, N, H, W, K)).  Every per-pixel lookup is one row
gather from a small per-face table (``ops/gather.py``, kernel K9a) or one
barycentric interpolating gather (``ops/interp_gather.py``, kernel K10a);
all are differentiable in the texture values, and UV sampling also in the
vertex UVs through the bilinear weights.  Empty fragments (pix_to_face
-1) sample zeros.
"""

from __future__ import annotations

import dataclasses

import torch

from pertrenderer_tpu_torch.ops.gather import (take_rows_batched,
                                               take_rows_cm_batched)
from pertrenderer_tpu_torch.ops.interp_gather import interp_rows_cm_batched

__all__ = ["Textures", "TexturesVertex", "TexturesUV", "TexturesAtlas",
           "interpolate_face_attributes", "interpolate_face_attributes_cm"]


def interpolate_face_attributes_cm(pix_to_face, w0, w1, w2, face_attrs):
    """Channel-major barycentric interpolation in one weighted gather
    (K10a): pix_to_face, w0..w2 (N, H, W, K), face_attrs (N, F, 3, C) ->
    (C, N, H, W, K), zero where empty."""
    return interp_rows_cm_batched(face_attrs, pix_to_face, w0, w1, w2)


def interpolate_face_attributes(pix_to_face, bary_coords, face_attrs):
    """Barycentric interpolation of per-face corner attributes:
    pix_to_face (N, H, W, K), bary_coords (N, H, W, K, 3), face_attrs
    (N, F, 3, C) -> (N, H, W, K, C), zero where empty."""
    n, f, c = face_attrs.shape[0], face_attrs.shape[1], face_attrs.shape[-1]
    vals = take_rows_batched(face_attrs.reshape(n, f, 3 * c), pix_to_face)
    vals = vals.reshape(tuple(pix_to_face.shape) + (3, c))
    return torch.einsum("...v,...vc->...c", bary_coords, vals)


def _bilinear_corners(u, v, hm: int, wm: int):
    """Texel indices of the four bilinear corners (row-major in the
    map) and the weights (fx, fy) of uv (u, v), v = 0 the bottom row."""
    x = u * (wm - 1)
    y = (1.0 - v) * (hm - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, wm - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, hm - 1)
    x1 = torch.clamp(x0 + 1, 0, wm - 1)
    y1 = torch.clamp(y0 + 1, 0, hm - 1)
    fx = torch.clamp(x - x0.to(x.dtype), 0.0, 1.0)
    fy = torch.clamp(y - y0.to(y.dtype), 0.0, 1.0)
    corners = (y0 * wm + x0, y0 * wm + x1, y1 * wm + x0, y1 * wm + x1)
    return corners, fx, fy


def _bilinear(c00, c01, c10, c11, fx, fy):
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _repeat(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.repeat_interleave(x, n, dim=0)


@dataclasses.dataclass
class TexturesVertex:
    """Per-vertex features (N, V, C), interpolated with barycentrics."""

    verts_features: torch.Tensor

    def _face_attrs(self, faces):
        return take_rows_batched(self.verts_features,
                                 torch.clamp(faces, min=0))  # (N, F, 3, C)

    def sample(self, faces, pix_to_face, bary_coords) -> torch.Tensor:
        return interpolate_face_attributes(pix_to_face, bary_coords,
                                           self._face_attrs(faces))

    def sample_cm(self, faces, pix_to_face, w0, w1, w2) -> torch.Tensor:
        return interpolate_face_attributes_cm(pix_to_face, w0, w1, w2,
                                              self._face_attrs(faces))

    def extend(self, n: int) -> "TexturesVertex":
        return TexturesVertex(_repeat(self.verts_features, n))


@dataclasses.dataclass
class TexturesUV:
    """UV-mapped texture: maps (N, Hm, Wm, C), verts_uvs (N, Vt, 2) with the
    origin bottom-left, faces_uvs (N, F, 3).  ``atlas_size`` R > 0 bakes the
    map into a per-face R x R atlas, which is what the fused forward reads."""

    maps: torch.Tensor
    verts_uvs: torch.Tensor
    faces_uvs: torch.Tensor
    atlas_size: int = 0

    def _bake_atlas(self) -> torch.Tensor:
        """(N, F, R, R, C) atlas resampled bilinearly from the map on a
        barycentric grid (x from w1, y from w2)."""
        r = self.atlas_size
        hm, wm = self.maps.shape[1], self.maps.shape[2]
        dev = self.maps.device
        grid = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) / r
        w1 = grid[None, :].repeat(r, 1)          # (R, R) x-coordinate
        w2 = grid[:, None].repeat(1, r)          # (R, R) y-coordinate
        w0 = 1.0 - w1 - w2
        out = []
        for map_n, uvs_n, fuv_n in zip(self.maps, self.verts_uvs,
                                       self.faces_uvs):
            uv_c = uvs_n[torch.clamp(fuv_n, min=0).long()]   # (F, 3, 2)
            uv = (w0[None, ..., None] * uv_c[:, None, None, 0]
                  + w1[None, ..., None] * uv_c[:, None, None, 1]
                  + w2[None, ..., None] * uv_c[:, None, None, 2])
            x = uv[..., 0] * (wm - 1)
            y = (1.0 - uv[..., 1]) * (hm - 1)
            x0 = torch.clamp(torch.floor(x).long(), 0, wm - 1)
            y0 = torch.clamp(torch.floor(y).long(), 0, hm - 1)
            x1 = torch.clamp(x0 + 1, 0, wm - 1)
            y1 = torch.clamp(y0 + 1, 0, hm - 1)
            fx = torch.clamp(x - x0.float(), 0.0, 1.0)[..., None]
            fy = torch.clamp(y - y0.float(), 0.0, 1.0)[..., None]
            top = map_n[y0, x0] * (1 - fx) + map_n[y0, x1] * fx
            bot = map_n[y1, x0] * (1 - fx) + map_n[y1, x1] * fx
            out.append(top * (1 - fy) + bot * fy)           # (F, R, R, C)
        return torch.stack(out)

    def _uv_corners(self):
        return take_rows_batched(self.verts_uvs,
                                 torch.clamp(self.faces_uvs, min=0))

    def sample(self, faces, pix_to_face, bary_coords) -> torch.Tensor:
        """Bilinear fetch from the map at the interpolated UV (the atlas is
        not used here, as in the JAX package): the four corner texels in
        one row gather."""
        n, hm, wm, c = self.maps.shape
        uv_corners = self._uv_corners()
        f = uv_corners.shape[1]
        uv_pix = take_rows_batched(uv_corners.reshape(n, f, 6), pix_to_face)
        uv_pix = uv_pix.reshape(tuple(pix_to_face.shape) + (3, 2))
        uv = torch.einsum("...v,...vc->...c", bary_coords, uv_pix)
        corners, fx, fy = _bilinear_corners(uv[..., 0], uv[..., 1], hm, wm)
        corners = torch.stack(corners, dim=-1)
        corners = torch.where((pix_to_face >= 0)[..., None], corners, -1)
        texels4 = take_rows_batched(self.maps.reshape(n, hm * wm, c),
                                    corners)                # (..., 4, C)
        return _bilinear(*(texels4[..., i, :] for i in range(4)),
                         fx[..., None], fy[..., None])

    def sample_cm(self, faces, pix_to_face, w0, w1, w2) -> torch.Tensor:
        """Channel-major UV sampling (C, N, H, W, K): through the baked
        atlas when ``atlas_size`` is set, else bilinear from the map."""
        if self.atlas_size:
            return TexturesAtlas(self._bake_atlas()).sample_cm(
                faces, pix_to_face, w0, w1, w2)
        n, hm, wm, c = self.maps.shape
        uv = interpolate_face_attributes_cm(pix_to_face, w0, w1, w2,
                                            self._uv_corners())
        corners, fx, fy = _bilinear_corners(uv[0], uv[1], hm, wm)
        corners = torch.stack(corners, dim=0)             # (4, N, H, W, K)
        corners = torch.where((pix_to_face >= 0)[None], corners, -1)
        texels = take_rows_cm_batched(self.maps.reshape(n, hm * wm, c),
                                      torch.movedim(corners, 1, 0))
        texels = torch.movedim(texels, 2, 1)          # (C, 4, N, H, W, K)
        return _bilinear(*(texels[:, i] for i in range(4)), fx, fy)

    def extend(self, n: int) -> "TexturesUV":
        return TexturesUV(maps=_repeat(self.maps, n),
                          verts_uvs=_repeat(self.verts_uvs, n),
                          faces_uvs=_repeat(self.faces_uvs, n),
                          atlas_size=self.atlas_size)


@dataclasses.dataclass
class TexturesAtlas:
    """Per-face R x R texture atlas (N, F, R, R, C); texel (i, j) is chosen
    by quantizing the (w1, w2) barycentrics onto the grid."""

    atlas: torch.Tensor

    def _lookup(self, pix_to_face, w1, w2):
        """(table (N, F R R, C), texel row per fragment, -1 where empty)."""
        n, f, r = self.atlas.shape[:3]
        c = self.atlas.shape[-1]
        cell = lambda w: torch.clamp(
            (torch.clamp(w, 0.0, 1.0) * r).to(torch.int64), 0, r - 1)
        lin = pix_to_face * (r * r) + cell(w2) * r + cell(w1)
        lin = torch.where(pix_to_face >= 0, lin, -1)
        return self.atlas.reshape(n, f * r * r, c), lin

    def sample(self, faces, pix_to_face, bary_coords) -> torch.Tensor:
        table, lin = self._lookup(pix_to_face, bary_coords[..., 1],
                                  bary_coords[..., 2])
        return take_rows_batched(table, lin)

    def sample_cm(self, faces, pix_to_face, w0, w1, w2) -> torch.Tensor:
        table, lin = self._lookup(pix_to_face, w1, w2)
        return take_rows_cm_batched(table, lin)

    def extend(self, n: int) -> "TexturesAtlas":
        return TexturesAtlas(_repeat(self.atlas, n))


def Textures(maps=None, verts_uvs=None, faces_uvs=None):
    """PyTorch3D 0.4's ``Textures(verts_uvs, faces_uvs, maps)``, the form
    the reference builds the cube's texture with: a ``TexturesUV``."""
    return TexturesUV(maps=maps, verts_uvs=verts_uvs, faces_uvs=faces_uvs)
