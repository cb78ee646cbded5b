"""The stream route's prepass and routing against the JAX package.

* ``_stream_tables``: the sorted table (hence the permutation), each
  tile's chunk list and count, and the activity bits equal JAX's bit for
  bit on the three stream test scenes: the cube with K=4 at 16^2 (F=12 >
  K, one chunk), the icosphere (1280 faces) at 32^2 and the cow (5120
  faces) at 48^2 (strip tiles: 48 is no multiple of the 32-pixel tile).
  Both sides get the same inputs: the JAX package's merged tables.
* The flat route's activity bits (``_active_tiles``, separating-axis
  refinement included) equal JAX's on images of several tiles.
* ``make_icosphere`` and ``make_cow`` build the JAX assets: vertices,
  faces, UV map and baked atlas, bit for bit.
* ``render_plan`` reports the stream route as JAX does; the binned opt-in
  plans the binned route; the sharded estimators raise, naming the route;
  images above 2048 take the staged route.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pertrenderer_tpu as pt
import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (build, interpret_env, jax_inputs, one_torch_thread,
                           port_config)

STREAM_SCENES = {"cube": (16, 4), "icosphere": (32, 50), "cow": (48, 50)}


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_stream_pieces(mesh, renderer):
    """The JAX package's stream prepass inputs (merged tables, fv_ndc,
    validity, blur), as its ``_prepare_inputs`` builds them."""
    sh = renderer.shader
    settings = renderer.rasterizer.raster_settings
    n, f = mesh.batch_size, mesh.max_faces
    faces = jnp.maximum(mesh.faces, 0)
    gather = jax.vmap(jfr._gather_rows)
    fv_ndc = gather(sh.cameras.transform_points_ndc(mesh.verts), faces)
    fv_world = gather(mesh.verts, faces)
    fn = gather(mesh.verts_normals(), faces)
    tex = mesh.textures
    if isinstance(tex, pt.TexturesVertex):
        tex_tab = gather(jnp.broadcast_to(
            tex.verts_features, (n,) + tex.verts_features.shape[1:]), faces)
    else:
        atlas = tex._bake_atlas()
        tex_tab = jnp.broadcast_to(atlas, (n,) + atlas.shape[1:]).reshape(
            n, f, -1)
    valid = ((jnp.arange(f)[None, :] < mesh.num_faces[:, None])
             & jnp.all(mesh.faces >= 0, axis=-1)).astype(jnp.float32)
    merged = jnp.concatenate([fv_ndc, fv_world, fn, tex_tab], axis=-1)
    return merged, fv_ndc, valid, jnp.float32(settings.blur_radius)


@pytest.fixture(scope="module", params=list(STREAM_SCENES))
def stream_case(request):
    kind = request.param
    imsize, k = STREAM_SCENES[kind]
    with pytest.MonkeyPatch.context() as mp:
        interpret_env(mp)
        mesh, _cams, _lights, renderer = build(
            "gaussian", imsize=imsize, k=k, s=2, mesh_kind=kind,
            n_views=2 if kind == "cube" else 1)
        jcfg, jin = jax_inputs(mesh, renderer)
        merged, fv_ndc, valid, blur = jax_stream_pieces(mesh, renderer)
        tab, rows, count = jax.vmap(
            partial(jfr._stream_tables, jcfg),
            in_axes=(0, 0, 0, None))(merged, fv_ndc, valid, blur)
        active = jax.vmap(lambda v, va: jfr._active_tiles(
            jcfg, v, va[:, None], blur))(fv_ndc, valid)
    return dict(kind=kind, jcfg=jcfg, jin=jin, merged=np.asarray(merged),
                fv_ndc=np.asarray(fv_ndc), valid=np.asarray(valid),
                blur=float(blur), tab=np.asarray(tab), rows=np.asarray(rows),
                count=np.asarray(count), active=np.asarray(active))


def test_stream_tables_equal_jax(stream_case):
    c = stream_case
    jcfg = c["jcfg"]
    assert jcfg.stream
    # The pieces are the ones JAX's own _prepare_inputs sorted.
    np.testing.assert_array_equal(c["tab"], np.asarray(c["jin"][0]))
    cfg = port_config(jcfg)
    n, f, d = c["merged"].shape
    tab, rows, count, perm = tfr._stream_tables(
        cfg, _t(c["merged"]), _t(c["fv_ndc"]), _t(c["valid"]),
        torch.full((n,), c["blur"]))
    assert tab.shape == (n, cfg.rw, tab.shape[2]) and tab.shape[2] % 4 == 0
    np.testing.assert_array_equal(tab[..., :d + 1].numpy(),
                                  c["tab"][..., :d + 1])
    assert torch.count_nonzero(tab[..., d + 1:]) == 0
    # The permutation: JAX's sorted rows are the merged rows in the port's
    # order, and the merged rows are distinct.
    assert len(np.unique(c["merged"][0], axis=0)) == f
    for b in range(n):
        np.testing.assert_array_equal(c["tab"][b, :f, :d],
                                      c["merged"][b][perm[b].numpy()])
    np.testing.assert_array_equal(rows.numpy(),
                                  c["rows"].reshape(rows.shape))
    np.testing.assert_array_equal(count.numpy(),
                                  c["count"].reshape(count.shape))
    active = tfr._active_tiles(cfg, _t(c["fv_ndc"]), _t(c["valid"]),
                               torch.full((n,), c["blur"]))
    np.testing.assert_array_equal(active.numpy(),
                                  c["active"].reshape(active.shape))
    assert rows.dtype == count.dtype == active.dtype == torch.int32


def test_port_prepare_inputs_stream_layout(stream_case):
    """The port's own prepass on the converted scene: the stream config
    equals JAX's, the inputs have the kernels' layout, and every chunk
    list is ascending and names only chunks with a valid row."""
    c = stream_case
    imsize, k = STREAM_SCENES[c["kind"]]
    mesh, _cams, _lights, renderer = build(
        "gaussian", imsize=imsize, k=k, s=2, mesh_kind=c["kind"],
        n_views=2 if c["kind"] == "cube" else 1)
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(renderer, device="cpu")
    sh, settings = trend.shader, trend.rasterizer.raster_settings
    cfg, _why = tfr._plan(tmesh, sh.lights, sh.smoothrast, sh.smoothagg,
                          settings, "phong")
    assert cfg == port_config(c["jcfg"])
    seeds = tfr.draw_seeds(tmesh.batch_size, device="cpu")
    tab, scal, rows, count, active, seeds = tfr._prepare_inputs(
        cfg, tmesh, sh.cameras, sh.lights, sh.materials, sh.smoothrast,
        sh.smoothagg, sh.blend_params, settings, seeds, "phong")
    n, nt = tmesh.batch_size, tfr._n_tiles(cfg)
    assert tab.shape[:2] == (n, cfg.rw) and scal.shape == (n, 34)
    assert rows.shape == (n, nt, cfg.rw // 64) and count.shape == (n, nt)
    key = tab[..., 27 + cfg.tex_d].view(n, -1, 64)
    live_chunks = (key < 1e30).any(dim=2)
    for b in range(n):
        for t in range(nt):
            lst = rows[b, t, :count[b, t]].tolist()
            assert lst == sorted(lst)
            assert all(bool(live_chunks[b, q]) for q in lst)
    assert int((count * active).sum()) > 0


@pytest.mark.parametrize("imsize,shift", [(64, (0.0, 2.5, 0.0)),
                                          (128, (0.0, -2.5, 0.0))])
def test_flat_active_bits_equal_jax(imsize, shift):
    """The flat route's tiling (64^2: two 2048-pixel strips; 128^2: 2-D
    tiles of 32 x 64) and activity bits: equal to JAX's on the cube moved
    off centre, so that some tiles are inactive."""
    mesh, _cams, _lights, renderer = build("gaussian", imsize=imsize, k=16,
                                           n_views=2, sigma=1e-3, shift=shift)
    jcfg, jin = jax_inputs(mesh, renderer)
    cfg = port_config(jcfg)
    assert not cfg.stream and cfg.p_tile == 2048
    assert cfg.tile_w == (64 if imsize == 128 else 0)
    fv_ndc, valid, scal = jin[0], jin[4], jin[5]
    want = jax.vmap(lambda v, va, s: jfr._active_tiles(
        jcfg, v, va, s[0, jfr._S_BLUR]))(fv_ndc, valid, scal)
    got = tfr._active_tiles(cfg, _t(fv_ndc), _t(valid[..., 0]),
                            _t(scal[:, 0, jfr._S_BLUR]))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(got.shape))
    assert 0 < int(got.sum()) < got.numel()


def test_flat_active_bits_separating_axis_equal_jax(monkeypatch):
    """A diagonal sliver across a 128^2 image: its bbox meets all 8 tiles,
    the separating-axis test clears the tiles it never comes near; the
    port's bits equal JAX's, with and without the refinement."""
    mesh, _cams, _lights, renderer = build("gaussian", imsize=128, k=16,
                                           sigma=1e-3)
    jcfg, _jin = jax_inputs(mesh, renderer)
    cfg = port_config(jcfg)
    sliver = np.zeros((1, 16, 9), np.float32)
    sliver[0, 0] = [-0.9, -0.95, 5.0, 0.9, 0.85, 5.0, 0.9, 0.95, 5.0]
    valid = np.zeros((1, 16), np.float32)
    valid[0, 0] = 1.0
    blur = np.float32(1e-4)
    want = jfr._active_tiles(jcfg, jnp.asarray(sliver[0]),
                             jnp.asarray(valid[0])[:, None], blur)
    args = (_t(sliver), _t(valid), torch.tensor([blur]))
    got = tfr._active_tiles(cfg, *args)
    np.testing.assert_array_equal(got.numpy()[0],
                                  np.asarray(want).reshape(-1))
    monkeypatch.setattr(tfr, "_SAT_MAX_F", 0)
    monkeypatch.setattr(jfr, "_SAT_MAX_F", 0)
    bbox_only = tfr._active_tiles(cfg, *args)
    assert int(bbox_only.sum()) == 8 > int(got.sum()) > 0
    np.testing.assert_array_equal(
        bbox_only.numpy()[0], np.asarray(jfr._active_tiles(
            jcfg, jnp.asarray(sliver[0]), jnp.asarray(valid[0])[:, None],
            blur)).reshape(-1))


def test_assets_equal_jax():
    from pertrenderer_tpu.io import make_icosphere as jax_icosphere

    for level in (3, 4):
        jv, jf = jax_icosphere(level)
        tv, tf = ptt.make_icosphere(level)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
    jcow, tcow = pt.make_cow(), ptt.make_cow(device="cpu")
    assert tcow.max_faces == 5120 and tcow.max_verts == 2562
    np.testing.assert_array_equal(tcow.verts.numpy(), np.asarray(jcow.verts))
    np.testing.assert_array_equal(tcow.faces.numpy(), np.asarray(jcow.faces))
    for name in ("maps", "verts_uvs", "faces_uvs"):
        np.testing.assert_array_equal(
            getattr(tcow.textures, name).numpy(),
            np.asarray(getattr(jcow.textures, name)))
    assert tcow.textures.atlas_size == jcow.textures.atlas_size == 4
    np.testing.assert_array_equal(tcow.textures._bake_atlas().numpy(),
                                  np.asarray(jcow.textures._bake_atlas()))


def test_render_plan_stream_matches_jax():
    mesh, _cams, _lights, renderer = build("gaussian", imsize=32, k=50,
                                           s=2, mesh_kind="icosphere")
    sh = renderer.shader
    settings = renderer.rasterizer.raster_settings
    want = jfr.render_plan(mesh, sh.cameras, sh.lights, sh.materials,
                           sh.smoothrast, sh.smoothagg, settings)
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(renderer, device="cpu")
    got = trend.plan(tmesh)
    assert got.mode == want.mode == "stream"
    for name in ("reason", "f", "k", "image_size", "p_tile", "tile",
                 "table_rows"):
        assert getattr(got, name) == getattr(want, name), name


def test_other_routes_raise_naming_the_route():
    """Binned (bin_overflow='allow' with F > 8192 at a binnable size)
    plans the binned route (K12: M = 160 slots, 128-pixel strip tiles),
    and declines sharded estimators with the JAX package's reason; 'allow'
    with fewer faces still streams, as in the JAX package, sharded too;
    images above 2048 decline to the staged route, which runs the MC
    estimators (K8a-c), and a sharded sample axis outside a device mesh
    raises naming the missing mesh."""
    cams_l = ptt.PointLights.create(location=(0.0, 2.0, -2.0), device="cpu")
    sr = ptt.GaussianRast.create(sigma=1e-3, nb_samples=2)
    sa = ptt.GaussianAgg.create(gamma=1e-2, nb_samples=2)
    big = ptt.Meshes.create(
        torch.eye(3), torch.tensor([[0, 1, 2]] * 9000), device="cpu",
        textures=ptt.TexturesVertex(torch.ones(1, 3, 3)))
    allow = ptt.RasterizationSettings(image_size=256, faces_per_pixel=50,
                                      bin_overflow="allow")
    cfg, why = tfr._plan(big, cams_l, sr, sa, allow, "phong")
    assert why == "" and cfg.binned and not cfg.stream
    assert (cfg.f_pad, cfg.f_real, cfg.p_tile, cfg.tile_w) == (160, 160,
                                                               128, 0)
    assert tfr.render_plan(big, cams_l, sr, sa, allow).mode == "binned"
    assert tfr._plan(big, cams_l, sr, sa, dataclasses.replace(
        allow, bin_overflow="warn"), "phong")[0].stream
    cow = ptt.make_cow(device="cpu")
    assert tfr._plan(cow, cams_l, sr, sa, allow, "phong")[0].stream
    srs = dataclasses.replace(sr, sample_axis="s")
    sas = dataclasses.replace(sa, sample_axis="s")
    cfg = tfr._plan(cow, cams_l, srs, sa, allow, "phong")[0]
    assert cfg.stream and cfg.prob_ext
    assert tfr._plan(big, cams_l, srs, sas, allow, "phong") == (
        None, "sharded fused path covers the flat and streaming modes "
              "(binned is not sharded)")
    # Above 2048 pixels the fused routes decline, as JAX's _plan does: the
    # render goes staged, whose MC estimators run (K8a-c) unless sharded.
    assert tfr._plan(cow, cams_l, sr, sa, dataclasses.replace(
        allow, image_size=4096), "phong") == (
            None, "image size above the 2048 fused-kernel limit")
    seeds = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no device mesh"):
        ptt.perturbed_heaviside(torch.zeros(1, 3), 1e-2, seeds,
                                sample_axis="s")
