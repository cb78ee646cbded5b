"""Procedural assets (PyTorch port of ``pertrenderer_tpu/io.py``): the
cube, the icosphere and the cow.  Each is generated by numpy code that
repeats the JAX package's arithmetic, so both packages build the same
arrays.  The OBJ loader is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from pertrenderer_tpu_torch.structures import Meshes
from pertrenderer_tpu_torch.textures import TexturesUV

__all__ = ["cube_mesh_data", "cube_texture_image", "load_cube",
           "make_icosphere", "make_cow"]

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


def load_cube(device="cuda") -> Meshes:
    """The Rubik's-cube test asset with a one-texel-per-face baked atlas
    (exact: each cube side maps to a constant strip)."""
    verts, faces, verts_uvs, faces_uvs = cube_mesh_data()
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)
    tex = TexturesUV(maps=as_t(cube_texture_image()[None], torch.float32),
                     verts_uvs=as_t(verts_uvs[None], torch.float32),
                     faces_uvs=as_t(faces_uvs[None], torch.int64),
                     atlas_size=1)
    return Meshes.create(verts, faces, textures=tex, device=device)


def make_cow(level: int = 4, device="cuda") -> Meshes:
    """The procedural cow-class asset of BASELINE config 3: an icosphere
    (level 4: 2562 verts / 5120 faces) stretched into a body with a head
    bump and four leg bulges, spherical UVs and a spotted 128 x 128 hide,
    as ``TexturesUV`` with a baked 4 x 4 atlas."""
    verts, faces = make_icosphere(level)
    v = verts.astype(np.float64).copy()
    v[:, 0] *= 1.6
    v[:, 1] *= 0.95
    head = np.exp(-np.sum((v - np.array([1.5, 0.25, 0.0])) ** 2, 1) / 0.18)
    v += 0.55 * head[:, None] * np.array([1.0, 0.35, 0.0])
    for lx in (-0.9, 0.7):
        for lz in (-0.45, 0.45):
            leg = np.exp(-((v[:, 0] - lx) ** 2 + (v[:, 2] - lz) ** 2)
                         / 0.06) * (v[:, 1] < -0.2)
            v[:, 1] -= 0.5 * leg
    v = v / np.max(np.abs(v))
    u = np.arctan2(v[:, 2], v[:, 0]) / (2.0 * np.pi) + 0.5
    w = 0.5 + 0.5 * (v[:, 1] / np.max(np.abs(v[:, 1]) + 1e-9))
    verts_uvs = np.stack([u, np.clip(w, 0.0, 1.0)], 1).astype(np.float32)
    hh = ww = 128
    yy, xx = np.meshgrid(np.linspace(0, 1, hh), np.linspace(0, 1, ww),
                         indexing="ij")
    rng = np.random.RandomState(7)
    img = np.ones((hh, ww, 3), np.float32) * 0.95
    for _ in range(14):
        cy, cx, rr = rng.rand(), rng.rand(), 0.05 + 0.08 * rng.rand()
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        img[d2 < rr * rr] = np.array([0.12, 0.10, 0.10], np.float32)
    belly = yy < 0.18
    img[belly] = 0.6 * img[belly] + 0.4 * np.array([0.95, 0.75, 0.75],
                                                   np.float32)
    as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)
    tex = TexturesUV(maps=as_t(img[None], torch.float32),
                     verts_uvs=as_t(verts_uvs[None], torch.float32),
                     faces_uvs=as_t(faces[None], torch.int64),
                     atlas_size=4)
    return Meshes.create(v.astype(np.float32), faces, textures=tex,
                         device=device)


def make_icosphere(level: int = 3):
    """Unit icosphere by repeated midpoint subdivision of an icosahedron:
    (verts (V, 3) float32, faces (F, 3) int32).  Level 3 gives 642 verts /
    1280 faces, level 4 2562 / 5120."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(level):
        cache = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            kk = (min(a, b), max(a, b))
            if kk not in cache:
                m = vlist[a] + vlist[b]
                vlist.append(m / np.linalg.norm(m))
                cache[kk] = len(vlist) - 1
            return cache[kk]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces.astype(np.int32)
