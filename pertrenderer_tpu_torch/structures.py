"""Fixed-shape mesh batch (PyTorch port of ``pertrenderer_tpu/structures.py``).

One padded representation: every mesh of the batch shares the (V, F)
padding; padding faces are -1.  Updates return new ``Meshes``, as in the
JAX package, so a caller's mesh is never changed behind its back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

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
        safe = torch.clamp(self.faces, min=0)
        return torch.stack([v[f] for v, f in zip(self.verts, safe)])

    def face_normals(self, normalize: bool = True) -> torch.Tensor:
        """(N, F, 3) face normals (area-weighted if normalize=False)."""
        fv = self.face_verts()
        n = torch.linalg.cross(fv[..., 1, :] - fv[..., 0, :],
                               fv[..., 2, :] - fv[..., 0, :])
        if normalize:
            n = n / torch.clamp(_norm(n), min=1e-10)
        return n * self.faces_mask()[..., None].to(n.dtype)

    def verts_normals(self) -> torch.Tensor:
        """(N, V, 3) unit vertex normals: area-weighted sum of the incident
        face normals, normalized."""
        fn = self.face_normals(normalize=False)
        mask = self.faces_mask()
        v = self.max_verts
        out = []
        for faces_n, fn_n, mask_n in zip(torch.clamp(self.faces, min=0), fn,
                                         mask):
            # Padding faces scatter into a dummy slot v.
            idx = torch.where(mask_n[:, None], faces_n,
                              torch.full_like(faces_n, v))
            acc = torch.zeros(v + 1, 3, dtype=fn_n.dtype, device=fn_n.device)
            for corner in range(3):
                acc = acc.index_add(0, idx[:, corner], fn_n)
            out.append(acc[:v])
        vn = torch.stack(out)
        return vn / torch.clamp(_norm(vn), min=1e-10)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
