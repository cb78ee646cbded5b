"""The port's OBJ I/O against the JAX package's: ``load_obj`` through the
native C++ parser and through the Python scanner, the PNG decoder against
Pillow, ``save_obj``, ``load_objs_as_meshes`` and the ShapeNet loader.

Every file is written by the test.  The JAX side always reads with
``use_native=False``: its native binding builds its library inside the
JAX package, and nothing here writes there.  Arrays are compared bit for
bit: verts, the three index tables, UVs, normals, material colours,
texture images and atlases.
"""

import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import pertrenderer_tpu as pt
import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.experiments import harness as jharness
from pertrenderer_tpu.io import load_obj as jax_load_obj
from pertrenderer_tpu_torch import io as tio
from pertrenderer_tpu_torch import native
from pertrenderer_tpu_torch.experiments import harness as tharness


def _png(path, img, filters, color=None, interlace=0):
    """Write img (H, W, C) uint8 as a PNG whose row y uses filter
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    color = {3: 2, 4: 6}[c] if color is None else color
    flat = img.reshape(h, w * c).astype(np.int64)
    rows, prior = [], np.zeros(w * c, np.int64)
    for y in range(h):
        line, ftype = flat[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if ftype == 0:
            pred = np.zeros_like(line)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([ftype]) + ((line - pred) % 256).astype(
            np.uint8).tobytes())
        prior = line

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                             0, interlace))
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


def _image(h, w, c, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c),
                                                dtype=np.uint8)


OBJ = """# a quad, a pentagon and triangles in every corner form
mtllib scene.mtl
v 0 0 0
v 1.5 0 0   # trailing comment
v 1 1 0.25
v 0 1 -0.5
v 2 2 2
v -1 0.5 1e-3
vt 0.1 0.2
vt 0.9 0.1
vt 0.85 0.95
vt 0.05 0.8
vt 1.3 -0.2
vn 0 0 1
vn 0 1 0
vn 1 0 0
usemtl body
f 1/1/1 2/2/1 3/3/1 4/4/1
f 1 2 5
f 1//2 3//2 6//3
f 2/5 3/3 5/2
f 1/1/1 2/2/2 3/3/3 5/4/1 6/5/2
# f 1 2 3  (commented out)
"""

MTL = """newmtl body  # the only material
Ka 0.1 0.2 0.3
Kd 0.9 0.8 0.7
Ks 0.5 0.5 0.5
Ns 32.5
map_Kd tex.png
newmtl unused
Kd 0.25 0.5 0.75
"""


@pytest.fixture(scope="module")
def scene_obj(tmp_path_factory):
    root = tmp_path_factory.mktemp("obj")
    (root / "scene.obj").write_text(OBJ)
    (root / "scene.mtl").write_text(MTL)
    _png(root / "tex.png", _image(9, 13, 3, 0), (0, 1, 2, 3, 4))
    return str(root / "scene.obj")


def _assert_same(got, want):
    (gv, gf, ga), (wv, wf, wa) = got, want
    np.testing.assert_array_equal(gv, wv)
    assert gv.dtype == wv.dtype == np.float32
    for name in ("verts_idx", "textures_idx", "normals_idx"):
        np.testing.assert_array_equal(getattr(gf, name), getattr(wf, name))
        assert getattr(gf, name).dtype == np.int32
    for name in ("verts_uvs", "normals", "texture_atlas"):
        g, w = getattr(ga, name), getattr(wa, name)
        assert (g is None) == (w is None), name
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=name)
            assert g.dtype == w.dtype, name
    assert ga.material_colors.keys() == wa.material_colors.keys()
    for m, cols in wa.material_colors.items():
        assert ga.material_colors[m].keys() == cols.keys()
        for k, v in cols.items():
            np.testing.assert_array_equal(ga.material_colors[m][k], v)
    assert ga.texture_images.keys() == wa.texture_images.keys()
    for m, img in wa.texture_images.items():
        np.testing.assert_array_equal(ga.texture_images[m], img)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("atlas", [None, 2, 4])
def test_load_obj_matches_jax(scene_obj, use_native, atlas):
    kw = dict(create_texture_atlas=atlas is not None,
              texture_atlas_size=atlas or 4)
    got = ptt.load_obj(scene_obj, use_native=use_native, **kw)
    want = jax_load_obj(scene_obj, use_native=False, **kw)
    _assert_same(got, want)
    verts, faces, aux = got
    assert faces.verts_idx.shape == (8, 3)       # 2 + 1 + 1 + 1 + 3
    assert (faces.normals_idx[2] == -1).all()    # v
    assert (faces.textures_idx[2] == -1).all()
    assert (faces.textures_idx[3] == -1).all()   # v//vn
    assert (faces.normals_idx[4] == -1).all()    # v/vt
    assert aux.texture_images["body"].shape == (9, 13, 3)
    if atlas:
        assert aux.texture_atlas.shape == (8, atlas, atlas, 3)


def test_python_scanner_keeps_jax_semantics(tmp_path):
    """Relative (negative) indices, which the JAX package's Python scanner
    does not resolve, come out as it gives them; no MTL, no textures."""
    path = tmp_path / "rel.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\nf 1 2 3\n")
    got = ptt.load_obj(str(path), use_native=False)
    want = jax_load_obj(str(path), use_native=False)
    _assert_same(got, want)
    np.testing.assert_array_equal(got[1].verts_idx, [[-4, -3, -2],
                                                     [0, 1, 2]])
    nat = ptt.load_obj(str(path))             # the C++ parser resolves them
    np.testing.assert_array_equal(nat[1].verts_idx, [[0, 1, 2], [0, 1, 2]])
    assert got[2].verts_uvs is None and got[2].texture_images == {}


@pytest.mark.parametrize("channels,filters", [
    (3, (0,)), (3, (1,)), (3, (2,)), (3, (3,)), (3, (4,)),
    (3, (4, 3, 2, 1, 0)), (4, (0, 1, 2, 3, 4)), (4, (4,))])
def test_png_decoder_matches_pillow(tmp_path, channels, filters):
    path = str(tmp_path / "t.png")
    img = _image(17, 23, channels, channels * 10 + filters[0])
    _png(path, img, filters)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(tio.read_png(path), want)
    np.testing.assert_array_equal(
        tio.read_image(path), np.asarray(want, np.float32) / 255.0)


def test_png_decoder_pillow_files_and_fallback(tmp_path):
    """PNGs written by Pillow (its own filter choices) decode bit-equal;
    other images (grayscale PNG, interlaced PNG, JPEG) go through Pillow."""
    img = _image(31, 19, 3, 7)
    Image.fromarray(img).save(tmp_path / "p.png")
    Image.fromarray(np.concatenate([img, img[..., :1]], -1)).save(
        tmp_path / "pa.png")
    np.testing.assert_array_equal(tio.read_png(str(tmp_path / "p.png")), img)
    np.testing.assert_array_equal(tio.read_png(str(tmp_path / "pa.png")),
                                  img)
    Image.fromarray(img[..., 0]).save(tmp_path / "g.png")
    _png(tmp_path / "i.png", img, (0,), interlace=1)
    Image.fromarray(img).save(tmp_path / "j.jpg")
    for name in ("g.png", "i.png", "j.jpg"):
        path = str(tmp_path / name)
        assert tio.read_png(path) is None
    for name in ("g.png", "j.jpg"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(
            tio.read_image(path),
            np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0)


def test_save_obj_round_trip(tmp_path):
    verts, faces = ptt.make_icosphere(2)
    path = str(tmp_path / "ico.obj")
    ptt.save_obj(path, torch.from_numpy(verts), torch.from_numpy(faces))
    for use_native in (True, False):
        v, f, aux = ptt.load_obj(path, use_native=use_native)
        np.testing.assert_array_equal(f.verts_idx, faces)
        assert np.abs(v - verts).max() <= 1e-6
        assert aux.verts_uvs is None and aux.normals is None
    pt.save_obj(str(tmp_path / "jax.obj"), verts, faces)
    assert (tmp_path / "jax.obj").read_text() == open(path).read()


def test_load_objs_as_meshes(scene_obj, tmp_path):
    """The textured file gives TexturesUV of its map, UVs and UV indices;
    an untextured one white TexturesVertex; a batch stacks the files."""
    mesh = ptt.load_objs_as_meshes([scene_obj], device="cpu")
    verts, faces, aux = jax_load_obj(scene_obj, use_native=False)
    np.testing.assert_array_equal(mesh.verts[0].numpy(), verts)
    np.testing.assert_array_equal(mesh.faces[0].numpy(), faces.verts_idx)
    tex = mesh.textures
    assert isinstance(tex, ptt.TexturesUV)
    np.testing.assert_array_equal(tex.maps[0].numpy(),
                                  aux.texture_images["body"])
    np.testing.assert_array_equal(tex.verts_uvs[0].numpy(), aux.verts_uvs)
    np.testing.assert_array_equal(tex.faces_uvs[0].numpy(),
                                  faces.textures_idx)
    v, f = ptt.make_icosphere(1)
    paths = [str(tmp_path / f"{i}.obj") for i in range(2)]
    for i, p in enumerate(paths):
        ptt.save_obj(p, v * (i + 1), f)
    batch = ptt.load_objs_as_meshes(paths, device="cpu")
    assert batch.verts.shape == (2, v.shape[0], 3)
    assert isinstance(batch.textures, ptt.TexturesVertex)
    assert torch.equal(batch.textures.verts_features,
                       torch.ones(2, v.shape[0], 3))
    torch.testing.assert_close(batch.verts[1], 2 * batch.verts[0],
                               rtol=0, atol=2e-6)


def _shapenet_fixture(root):
    """The synthetic model of tests/test_structures_io.py in ShapeNetCore's
    layout (mug)."""
    model_dir = (root / "03797390" / "bea77759a3e5f9037ae0031c221d81a4"
                 / "models")
    model_dir.mkdir(parents=True)
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4] = (255, 0, 0)
    tex[:, 4:] = (0, 0, 255)
    Image.fromarray(tex).save(model_dir / "tex.png")
    (model_dir / "model_normalized.mtl").write_text(
        "newmtl m0\nKd 1.0 1.0 1.0\nmap_Kd tex.png\n")
    (model_dir / "model_normalized.obj").write_text(
        "mtllib model_normalized.mtl\n"
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
        "vt 0.1 0.1\nvt 0.9 0.1\nvt 0.9 0.9\nvt 0.1 0.9\n"
        "usemtl m0\n"
        "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    return model_dir / "model_normalized.obj"


def test_shapenet_loader(tmp_path):
    """harness._load_shapenet: the atlas of JAX's load_obj bit for bit, the
    normalised mesh of JAX's _normalize_mesh, init_target's render, and
    FileNotFoundError without the dataset."""
    obj = _shapenet_fixture(tmp_path)
    mesh = tharness._load_shapenet("mug", str(tmp_path), device="cpu")
    verts, faces, aux = jax_load_obj(str(obj), create_texture_atlas=True,
                                     texture_atlas_size=4, use_native=False)
    assert isinstance(mesh.textures, ptt.TexturesAtlas)
    np.testing.assert_array_equal(mesh.textures.atlas.numpy(),
                                  aux.texture_atlas[None])
    atlas = mesh.textures.atlas.numpy()
    assert atlas[..., 0].max() > 0.9 and atlas[..., 2].max() > 0.9
    jmesh = pt.Meshes.create(verts, faces.verts_idx,
                             textures=pt.TexturesAtlas(
                                 jnp.asarray(aux.texture_atlas[None])))
    np.testing.assert_array_equal(
        tharness.normalize_mesh(mesh).verts.numpy(),
        np.asarray(jharness._normalize_mesh(jmesh).verts))

    meshes, cams, _l, target, r_true, _e, _a = tharness.init_target(
        torch.Generator().manual_seed(0), category="mug",
        shapenet_path=str(tmp_path), imsize=16, device="cpu")
    assert isinstance(meshes.textures, ptt.TexturesAtlas)
    assert target[0].shape == (16, 16, 3)
    assert torch.isfinite(target[0]).all() and (target[0].sum(-1) > 0).any()
    for bad in (None, str(tmp_path / "nope")):
        with pytest.raises(FileNotFoundError):
            tharness._load_shapenet("mug", bad, device="cpu")
        with pytest.raises(FileNotFoundError):
            tharness.init_target(category="mug", shapenet_path=bad,
                                 device="cpu")


def test_native_build_failure_raises(scene_obj, tmp_path, monkeypatch):
    """load_obj(use_native=True) raises when the parser cannot be built,
    and falls back to nothing; use_native=False still reads the file."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "COMPILER",
                        str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native OBJ parser"):
        ptt.load_obj(scene_obj)
    assert not os.path.exists(tmp_path / "build" / "anything")
    assert ptt.load_obj(scene_obj, use_native=False)[1].verts_idx.shape == (
        8, 3)


def test_native_library_lands_in_the_build_directory():
    native.library()
    built = [n for n in os.listdir(native.BUILD_DIR)
             if n.startswith("libobjparse_") and n.endswith(".so")]
    assert os.path.basename(native._target()) in built
    src = os.path.dirname(native.SOURCE)
    assert not [n for n in os.listdir(src) if n.endswith(".so")]
