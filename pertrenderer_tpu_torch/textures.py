"""Texture holders (PyTorch port of ``pertrenderer_tpu/textures.py``).

The fused forward reads textures as per-face tables, so this module holds
the data and the UV-to-atlas bake (``TexturesUV._bake_atlas``) that the
cube takes.  Per-fragment ``sample`` / ``sample_cm`` belong to the staged
route, which is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["TexturesVertex", "TexturesUV", "TexturesAtlas"]


def _repeat(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.repeat_interleave(x, n, dim=0)


@dataclasses.dataclass
class TexturesVertex:
    """Per-vertex features (N, V, C), interpolated with barycentrics."""

    verts_features: torch.Tensor

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

    def extend(self, n: int) -> "TexturesAtlas":
        return TexturesAtlas(_repeat(self.atlas, n))
