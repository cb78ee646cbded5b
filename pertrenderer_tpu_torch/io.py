"""Mesh I/O and the procedural assets (PyTorch port of
``pertrenderer_tpu/io.py``).

OBJ I/O: ``load_obj`` (OBJ + MTL + texture images, an optional per-face
texture atlas) returns numpy arrays as the JAX package's does, through the
native C++ parser (``native/``, built with g++ at first use; a failed
build raises) or, with ``use_native=False``, the pure-Python scanner;
``load_objs_as_meshes`` builds a ``Meshes`` batch on ``device`` and
``save_obj`` writes vertices and faces.  ``map_Kd`` images in 8-bit RGB or
RGBA non-interlaced PNG are decoded here with ``zlib`` (``read_png``);
any other image goes through Pillow, imported where it is needed.

The assets (the cube, the icosphere and the cow) are generated by numpy
code that repeats the JAX package's arithmetic, so both packages build the
same arrays.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from pertrenderer_tpu_torch import native
from pertrenderer_tpu_torch.structures import Meshes
from pertrenderer_tpu_torch.textures import TexturesUV, TexturesVertex

__all__ = ["FacesData", "ObjAux", "load_obj", "load_objs_as_meshes",
           "save_obj", "read_png", "read_image", "cube_mesh_data",
           "cube_texture_image", "load_cube", "make_icosphere", "make_cow"]


class FacesData(NamedTuple):
    verts_idx: np.ndarray      # (F, 3) int32
    textures_idx: np.ndarray   # (F, 3) int32 (-1 if absent)
    normals_idx: np.ndarray    # (F, 3) int32 (-1 if absent)


class ObjAux(NamedTuple):
    verts_uvs: Optional[np.ndarray]           # (Vt, 2)
    normals: Optional[np.ndarray]             # (Vn, 3)
    material_colors: Dict[str, Dict[str, np.ndarray]]
    texture_images: Dict[str, np.ndarray]     # name -> (H, W, 3) float [0,1]
    texture_atlas: Optional[np.ndarray]       # (F, R, R, 3) if requested


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters: (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    prior = bytearray(stride)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = bytearray(raw[pos + 1:pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:                                   # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:                                 # Up
            line = bytearray((np.frombuffer(line, np.uint8)
                              + np.frombuffer(prior, np.uint8)).tobytes())
        elif ftype == 3:                                 # Average
            for i in range(stride):
                left = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((left + prior[i]) >> 1)) & 0xFF
        elif ftype == 4:                                 # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prior[i]
                c = prior[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = np.frombuffer(line, np.uint8)
        prior = line
    return out


def read_png(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 RGB of an 8-bit RGB or RGBA non-interlaced PNG (the
    alpha channel dropped, as Pillow's ``convert("RGB")`` drops it), or
    None if the file is another kind of image.  Raises on a corrupt PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        return None
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if (len(body) != length or len(crc) != 4
                or zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]):
            raise ValueError(f"{path}: corrupt PNG chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in (2, 6) or interlace != 0:
        return None
    channels = 3 if color == 2 else 4
    stride = width * channels
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: PNG data of {len(raw)} bytes for "
                         f"{width} x {height} x {channels}")
    img = _unfilter(raw, height, stride, channels)
    return img.reshape(height, width, channels)[..., :3]


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1] (uint8 / 255, as the JAX package
    reads it through Pillow): 8-bit RGB / RGBA PNGs by ``read_png``, any
    other image through Pillow, which must then be installed."""
    img = read_png(path)
    if img is None:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"{path}: only 8-bit RGB / RGBA non-interlaced PNGs are "
                "decoded without Pillow, which is not installed") from e
        img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def _parse_mtl(path: str):
    """Minimal MTL parser: Ka/Kd/Ks/Ns + map_Kd images (a map_Kd file that
    does not exist is left out, as in the JAX package)."""
    colors: Dict[str, Dict[str, np.ndarray]] = {}
    images: Dict[str, np.ndarray] = {}
    if not os.path.exists(path):
        return colors, images
    current = None
    with open(path) as f:
        lines = f.readlines()
    for raw in lines:
        tokens = raw.split("#")[0].split()
        if not tokens:
            continue
        if tokens[0] == "newmtl":
            current = tokens[1]
            colors[current] = {}
        elif current is not None and tokens[0] in ("Ka", "Kd", "Ks"):
            key = {"Ka": "ambient_color", "Kd": "diffuse_color",
                   "Ks": "specular_color"}[tokens[0]]
            colors[current][key] = np.array(tokens[1:4], np.float32)
        elif current is not None and tokens[0] == "Ns":
            colors[current]["shininess"] = np.array(tokens[1], np.float32)
        elif current is not None and tokens[0] == "map_Kd":
            img_path = os.path.join(os.path.dirname(path), tokens[-1])
            if os.path.exists(img_path):
                images[current] = read_image(img_path)
    return colors, images


def load_obj(path: str, load_textures: bool = True,
             create_texture_atlas: bool = False, texture_atlas_size: int = 4,
             texture_wrap: str = "repeat", use_native: bool = True):
    """Parse an OBJ file: (verts (V, 3) float32, FacesData, ObjAux), numpy
    arrays, as PyTorch3D's ``load_obj`` and the JAX package's.

    ``use_native`` (the default) parses the geometry with the C++ parser,
    which is built at first use and raises if it cannot be built or
    loaded; ``use_native=False`` takes the pure-Python scanner.  Polygons
    are fan-triangulated; an absent vt / vn index is -1.  Both parsers
    keep the JAX package's semantics, its limits included (the Python
    scanner does not resolve negative, relative indices; the C++ parser
    does).  ``texture_wrap`` is accepted for the API's sake: the atlas
    always wraps UVs with ``% 1``, then clips."""
    if use_native:
        nat = native.parse_obj_native(path)
        colors: Dict[str, Dict[str, np.ndarray]] = {}
        images: Dict[str, np.ndarray] = {}
        if load_textures and nat["mtl"]:
            mtl_path = os.path.join(os.path.dirname(path), nat["mtl"])
            colors, images = _parse_mtl(mtl_path)
        faces = FacesData(verts_idx=nat["faces_v"],
                          textures_idx=nat["faces_t"],
                          normals_idx=nat["faces_n"])
        atlas = None
        if (create_texture_atlas and nat["uvs"] is not None and images
                and len(nat["uvs"])):
            atlas = _make_texture_atlas(
                list(images.values())[0], nat["uvs"], faces.textures_idx,
                texture_atlas_size)
        aux = ObjAux(verts_uvs=nat["uvs"], normals=nat["normals"],
                     material_colors=colors, texture_images=images,
                     texture_atlas=atlas)
        return nat["verts"], faces, aux

    verts: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    faces_v: List[List[int]] = []
    faces_t: List[List[int]] = []
    faces_n: List[List[int]] = []
    mtl_path = None
    colors = {}
    images = {}

    def _idx(tok: str, which: int) -> int:
        parts = tok.split("/")
        if which >= len(parts) or parts[which] == "":
            return 0
        return int(parts[which])

    with open(path) as f:
        lines = f.readlines()
    for raw in lines:
        tokens = raw.split("#")[0].split()
        if not tokens:
            continue
        tag = tokens[0]
        if tag == "v":
            verts.append([float(x) for x in tokens[1:4]])
        elif tag == "vt":
            uvs.append([float(x) for x in tokens[1:3]])
        elif tag == "vn":
            normals.append([float(x) for x in tokens[1:4]])
        elif tag == "mtllib":
            mtl_path = os.path.join(os.path.dirname(path), tokens[1])
        elif tag == "f":
            corners = tokens[1:]
            for i in range(1, len(corners) - 1):     # fan triangulation
                tri = [corners[0], corners[i], corners[i + 1]]
                faces_v.append([_idx(t, 0) - 1 for t in tri])
                faces_t.append([_idx(t, 1) - 1 for t in tri])
                faces_n.append([_idx(t, 2) - 1 for t in tri])

    if load_textures and mtl_path:
        colors, images = _parse_mtl(mtl_path)

    verts_np = np.asarray(verts, np.float32)
    faces = FacesData(verts_idx=np.asarray(faces_v, np.int32),
                      textures_idx=np.asarray(faces_t, np.int32),
                      normals_idx=np.asarray(faces_n, np.int32))
    verts_uvs = np.asarray(uvs, np.float32) if uvs else None
    normals_np = np.asarray(normals, np.float32) if normals else None

    atlas = None
    if create_texture_atlas and verts_uvs is not None and images:
        atlas = _make_texture_atlas(list(images.values())[0], verts_uvs,
                                    faces.textures_idx, texture_atlas_size)
    aux = ObjAux(verts_uvs=verts_uvs, normals=normals_np,
                 material_colors=colors, texture_images=images,
                 texture_atlas=atlas)
    return verts_np, faces, aux


def _make_texture_atlas(image: np.ndarray, verts_uvs: np.ndarray,
                        faces_uvs: np.ndarray, r: int) -> np.ndarray:
    """Bake a (F, R, R, 3) per-face atlas by sampling the UV map at the
    nearest texel on an R x R barycentric grid (x from w1, y from w2), the
    UVs wrapped with ``% 1`` and clipped to the map."""
    f = faces_uvs.shape[0]
    h, w = image.shape[0], image.shape[1]
    grid = (np.arange(r, dtype=np.float32) + 0.5) / r
    gx, gy = np.meshgrid(grid, grid, indexing="xy")  # (R, R)
    w1, w2 = gx, gy
    w0 = 1.0 - w1 - w2
    uv0 = verts_uvs[np.maximum(faces_uvs[:, 0], 0)]
    uv1 = verts_uvs[np.maximum(faces_uvs[:, 1], 0)]
    uv2 = verts_uvs[np.maximum(faces_uvs[:, 2], 0)]
    uv = (w0[None, ..., None] * uv0[:, None, None]
          + w1[None, ..., None] * uv1[:, None, None]
          + w2[None, ..., None] * uv2[:, None, None])  # (F, R, R, 2)
    x = np.clip((uv[..., 0] % 1.0) * (w - 1), 0, w - 1).astype(np.int32)
    y = np.clip((1.0 - (uv[..., 1] % 1.0)) * (h - 1), 0, h - 1).astype(
        np.int32)
    return image[y, x].reshape(f, r, r, 3).astype(np.float32)


def load_objs_as_meshes(paths: List[str], load_textures: bool = True,
                        device="cuda") -> Meshes:
    """Load OBJs (of equal vertex and face counts) into a Meshes batch on
    ``device``: ``TexturesUV`` from the last file with a texture map, else
    white ``TexturesVertex``."""
    all_verts, all_faces, textures = [], [], None
    for path in paths:
        verts, faces, aux = load_obj(path, load_textures=load_textures)
        all_verts.append(verts)
        all_faces.append(faces.verts_idx)
        if aux.texture_images and aux.verts_uvs is not None:
            img = list(aux.texture_images.values())[0]
            as_t = lambda x, dt: torch.as_tensor(x, dtype=dt, device=device)
            textures = TexturesUV(
                maps=as_t(np.asarray(img, np.float32)[None], torch.float32),
                verts_uvs=as_t(aux.verts_uvs[None], torch.float32),
                faces_uvs=as_t(faces.textures_idx[None], torch.int64))
    verts = np.stack(all_verts)
    faces = np.stack(all_faces)
    if textures is None:
        textures = TexturesVertex(torch.ones(verts.shape, dtype=torch.float32,
                                             device=device))
    return Meshes.create(verts, faces, textures=textures, device=device)


def save_obj(path: str, verts, faces) -> None:
    """Write vertices (V, 3) at ``%.6f`` and 1-based triangles (F, 3);
    numpy arrays or tensors on any device."""
    if isinstance(verts, torch.Tensor):
        verts = verts.detach().cpu()
    if isinstance(faces, torch.Tensor):
        faces = faces.detach().cpu()
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


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
