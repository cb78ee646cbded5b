"""Fixed-shape mesh batch (PyTorch port of ``pertrenderer_tpu/structures.py``).

One padded representation: every mesh of the batch shares the (V, F)
padding; padding faces are -1.  Updates return new ``Meshes``, as in the
JAX package, so a caller's mesh is never changed behind its back.

The per-face gathers and the vertex-normal sums go through
``ops/gather.py`` (kernels K9a / K9b on the card), whose sums have a fixed
order: no float atomics, so the same mesh gives the same bits on every
run, forward and backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from pertrenderer_tpu_torch.transforms import cross3
from pertrenderer_tpu_torch.ops.gather import (batch_index, scatter_rows,
                                               take_rows_batched)

__all__ = ["Meshes"]


@dataclasses.dataclass
class Meshes:
    """verts (N, V, 3) float32, faces (N, F, 3) int64 (-1 padding),
    num_verts / num_faces (N,) int64, optional textures."""

    verts: torch.Tensor
    faces: torch.Tensor
    num_verts: torch.Tensor
    num_faces: torch.Tensor
    textures: Optional[Any] = None

    @classmethod
    def create(cls, verts, faces, textures=None, device="cuda") -> "Meshes":
        """From unbatched (V, 3) + (F, 3) or batched (N, V, 3) + (N, F, 3)."""
        verts = torch.as_tensor(verts, dtype=torch.float32, device=device)
        faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
        if verts.dim() == 2:
            verts = verts[None]
        if faces.dim() == 2:
            faces = faces[None]
        n = verts.shape[0]
        num_verts = torch.full((n,), verts.shape[1], dtype=torch.int64,
                               device=device)
        num_faces = torch.sum(torch.any(faces >= 0, dim=-1), dim=-1)
        return cls(verts=verts, faces=faces, num_verts=num_verts,
                   num_faces=num_faces, textures=textures)

    @property
    def batch_size(self) -> int:
        return self.verts.shape[0]

    @property
    def max_verts(self) -> int:
        return self.verts.shape[1]

    @property
    def max_faces(self) -> int:
        return self.faces.shape[1]

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def verts_padded(self) -> torch.Tensor:
        return self.verts

    def faces_padded(self) -> torch.Tensor:
        return self.faces

    def faces_mask(self) -> torch.Tensor:
        """(N, F) bool — True for valid (non-padding) faces."""
        return torch.all(self.faces >= 0, dim=-1)

    def update_padded(self, new_verts: torch.Tensor) -> "Meshes":
        return dataclasses.replace(self, verts=new_verts)

    def offset_verts(self, offset: torch.Tensor) -> "Meshes":
        """offset: (V, 3) or (N, V, 3)."""
        offset = torch.as_tensor(offset, dtype=torch.float32,
                                 device=self.device)
        if offset.dim() == 2:
            offset = offset[None]
        return dataclasses.replace(self, verts=self.verts + offset)

    def scale_verts(self, scale) -> "Meshes":
        scale = torch.atleast_1d(torch.as_tensor(
            scale, dtype=torch.float32, device=self.device))
        return dataclasses.replace(self,
                                   verts=self.verts * scale[:, None, None])

    def extend(self, n: int) -> "Meshes":
        """Repeat each mesh n times."""
        rep = lambda x: torch.repeat_interleave(x, n, dim=0)
        tex = self.textures.extend(n) if self.textures is not None else None
        return Meshes(verts=rep(self.verts), faces=rep(self.faces),
                      num_verts=rep(self.num_verts),
                      num_faces=rep(self.num_faces), textures=tex)

    def with_textures(self, textures) -> "Meshes":
        return dataclasses.replace(self, textures=textures)

    def face_verts(self) -> torch.Tensor:
        """(N, F, 3, 3) world coordinates of each face's corners (padding
        faces read vertex 0)."""
        return take_rows_batched(self.verts, torch.clamp(self.faces, min=0))

    def face_normals(self, normalize: bool = True) -> torch.Tensor:
        """(N, F, 3) face normals (area-weighted if normalize=False)."""
        fv = self.face_verts()
        n = cross3(fv[..., 1, :] - fv[..., 0, :],
                   fv[..., 2, :] - fv[..., 0, :])
        if normalize:
            n = n / torch.clamp(_norm(n), min=1e-10)
        return n * self.faces_mask()[..., None].to(n.dtype)

    def verts_normals(self) -> torch.Tensor:
        """(N, V, 3) unit vertex normals: the sum of the incident faces'
        area-weighted normals (corner 0 of every face in face order, then
        corners 1 and 2, as the JAX package adds them), normalized."""
        fn = self.face_normals(normalize=False)
        n, v, f = self.batch_size, self.max_verts, self.max_faces
        corners = torch.where(self.faces_mask()[..., None], self.faces,
                              torch.full_like(self.faces, -1))
        idx = batch_index(corners.transpose(1, 2), n, v)      # (N, 3, F)
        vals = fn[:, None].expand(n, 3, f, 3)
        vn = scatter_rows(vals, idx, n * v).reshape(n, v, 3)
        return vn / torch.clamp(_norm(vn), min=1e-10)

    def sample_textures(self, fragments) -> torch.Tensor:
        """Per-fragment texel colours (N, H, W, K, C) from the attached
        textures (PyTorch3D's ``meshes.sample_textures(fragments)``)."""
        if self.textures is None:
            raise ValueError("Meshes has no textures attached.")
        return self.textures.sample(self.faces, fragments.pix_to_face,
                                    fragments.bary_coords)

    def sample_textures_cm(self, pfrag) -> torch.Tensor:
        """Channel-major texel colours (C, N, H, W, K) from planar
        fragments."""
        if self.textures is None:
            raise ValueError("Meshes has no textures attached.")
        return self.textures.sample_cm(self.faces, pfrag.pix_to_face,
                                       pfrag.w0, pfrag.w1, pfrag.w2)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
