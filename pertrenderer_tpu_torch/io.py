"""Procedural assets (PyTorch port of the cube in ``pertrenderer_tpu/io.py``).

The OBJ loader, ``make_cow`` and ``make_icosphere`` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from pertrenderer_tpu_torch.structures import Meshes
from pertrenderer_tpu_torch.textures import TexturesUV

__all__ = ["cube_mesh_data", "cube_texture_image", "load_cube"]

# Rubik's cube strip colors: green, yellow, blue, white, red, orange.
_CUBE_STRIP_COLORS = np.array(
    [[0.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 1.0, 1.0],
     [1.0, 0.0, 0.0], [1.0, 0.647, 0.0]], np.float32)


def cube_mesh_data():
    """8 verts, 12 faces, one UV per cube side pointing at a 6-strip
    texture: (verts, faces, verts_uvs, faces_uvs) as numpy arrays."""
    verts = np.array(
        [[-0.5, -0.5, 0.5], [0.5, -0.5, 0.5], [-0.5, 0.5, 0.5],
         [0.5, 0.5, 0.5], [-0.5, 0.5, -0.5], [0.5, 0.5, -0.5],
         [-0.5, -0.5, -0.5], [0.5, -0.5, -0.5]], np.float32)
    faces = np.array(
        [[0, 1, 2], [2, 1, 3],      # +z side, strip 0
         [2, 3, 4], [4, 3, 5],      # +y side, strip 1
         [4, 5, 6], [6, 5, 7],      # -z side, strip 2
         [6, 7, 0], [0, 7, 1],      # -y side, strip 3
         [1, 7, 3], [3, 7, 5],      # +x side, strip 4
         [6, 0, 4], [4, 0, 2]],     # -x side, strip 5
        np.int32)
    strip_of_face = np.repeat(np.arange(6, dtype=np.int32), 2)
    verts_uvs = np.stack(
        [np.array([0.08, 0.24, 0.40, 0.56, 0.82, 0.98], np.float32),
         np.full(6, 0.5, np.float32)], axis=-1)
    faces_uvs = np.stack([strip_of_face] * 3, axis=-1)
    return verts, faces, verts_uvs, faces_uvs


def cube_texture_image(strip_px: int = 16, height: int = 8) -> np.ndarray:
    """The painted 6-strip texture (height, 6 * strip_px, 3)."""
    img = np.zeros((height, 6 * strip_px, 3), np.float32)
    for i in range(6):
        img[:, i * strip_px:(i + 1) * strip_px] = _CUBE_STRIP_COLORS[i]
    return img


def load_cube(device="cpu") -> Meshes:
    """The Rubik's-cube test asset with a one-texel-per-face baked atlas
    (exact: each cube side maps to a constant strip)."""
    verts, faces, verts_uvs, faces_uvs = cube_mesh_data()
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)
    tex = TexturesUV(maps=as_t(cube_texture_image()[None], torch.float32),
                     verts_uvs=as_t(verts_uvs[None], torch.float32),
                     faces_uvs=as_t(faces_uvs[None], torch.int64),
                     atlas_size=1)
    return Meshes.create(verts, faces, textures=tex, device=device)
