"""The binned route's selection and routing against the JAX package.

The level-3 icosphere (1280 faces) at 64^2 with the binned route's tile
shrunk to 32 pixels (``_BIN_P_TILE``) and its face threshold to 512
(``_COARSE_THRESHOLD``) on both packages, as tests/test_binning.py and
tests/test_capacity.py reach the route at small F; M = 32 slots
(``max_faces_per_bin``).  Both packages select from the same ``fv_ndc``
(JAX's), and must agree bit for bit on the per-tile selection (sorted
positions, candidate counts, the worst group window) and the per-tile
tables, also where the window clamp and the slot overflow bite (small
``_RANGE_MAX`` / ``_RANGE_GROUP`` / M) and where faces tie (duplicated
faces); the y-sorted selection picks the direct per-tile selection's
faces; ``_prepare_inputs``, ``capacity_stats``, the capacity policies
and ``render_plan`` match JAX's."""

import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.ops import binned as tbin
from pertrenderer_tpu_torch.ops import fused_render as tfr
from pertrenderer_tpu_torch.ops.gather import take_rows_batched

from _torch_parity import build, interpret_env, jax_exact, one_torch_thread

IMAGE, M = 64, 32


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)
    for mod in (jfr, tfr):
        monkeypatch.setattr(mod, "_COARSE_THRESHOLD", 512)
        monkeypatch.setattr(mod, "_BIN_P_TILE", 32)


def binned_scene(noise="gaussian", m=M, n_views=2, duplicate=False,
                 bin_overflow="allow", sigma=1e-2):
    """(mesh, renderer) of the JAX package: the icosphere x2 at
    ``n_views`` poses, binned with ``m`` slots (blur from ``sigma``).
    ``duplicate`` repeats every face once more (exact ties in every
    selection key)."""
    mesh, _cams, _lights, rend = build(noise, imsize=IMAGE, k=50, s=2,
                                       mesh_kind="icosphere", sigma=sigma,
                                       gamma=5e-2, n_views=n_views)
    if duplicate:
        import pertrenderer_tpu as pt

        faces = jnp.concatenate([mesh.faces[0], mesh.faces[0]])
        mesh = pt.Meshes.create(
            mesh.verts[0], faces, textures=pt.TexturesVertex(
                mesh.textures.verts_features[:1])).extend(n_views)
    settings = dataclasses.replace(rend.rasterizer.raster_settings,
                                   bin_overflow=bin_overflow,
                                   max_faces_per_bin=m)
    return mesh, rend.replace(
        rasterizer=rend.rasterizer.replace(raster_settings=settings))


def plans(mesh, rend):
    """(JAX FusedConfig, the port's) of the scene's render."""
    sh, st = rend.shader, rend.rasterizer.raster_settings
    jcfg = jfr._plan(mesh, sh.cameras, sh.lights, sh.materials,
                     sh.smoothrast, sh.smoothagg, st, "phong")
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(rend, device="cpu")
    tsh = trend.shader
    tcfg, _why = tfr._plan(tmesh, tsh.lights, tsh.smoothrast, tsh.smoothagg,
                           trend.rasterizer.raster_settings, "phong")
    return jcfg, tcfg


def shared_faces(mesh, rend):
    """JAX's per-face NDC table (N, F, 9), a merged table of it and
    per-face columns unique to each face, validity and the blur."""
    sh = rend.shader
    verts_ndc = sh.cameras.transform_points_ndc(mesh.verts)
    fv = jax.vmap(jfr._gather_rows)(verts_ndc, jnp.maximum(mesh.faces, 0))
    f = fv.shape[1]
    ids = jnp.broadcast_to(jnp.arange(f, dtype=jnp.float32)[None, :, None],
                           fv.shape[:2] + (1,))
    merged = jnp.concatenate([fv, 2.0 * fv, ids, fv[..., :3] - ids], -1)
    valid = jnp.ones(fv.shape[:2], jnp.float32)
    blur = jnp.float32(rend.rasterizer.raster_settings.blur_radius)
    return fv, merged, valid, blur


def _t(x):
    return torch.from_numpy(np.array(x))


CASES = {
    "default": {},
    "range clamp": dict(range_max=256, range_group=4),
    "slot overflow": dict(m=8),
    "ties": dict(duplicate=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sorted_tables_equal_jax_bit_for_bit(case, monkeypatch):
    kw = dict(CASES[case])
    for name, key in (("_RANGE_MAX", "range_max"),
                      ("_RANGE_GROUP", "range_group")):
        if key in kw:
            v = kw.pop(key)
            monkeypatch.setattr(jfr, name, v)
            monkeypatch.setattr(tbin, name, v)
    mesh, rend = binned_scene(**kw)
    jcfg, tcfg = plans(mesh, rend)
    assert jcfg.binned and tcfg.binned and tcfg.f_pad == jcfg.f_pad
    fv, merged, valid, blur = shared_faces(mesh, rend)
    n = fv.shape[0]
    want = jax.vmap(partial(jfr._binned_tables_sorted, jcfg),
                    in_axes=(0, 0, 0, None))(merged, fv, valid, blur)
    got = tbin._binned_tables_sorted(tcfg, _t(merged), _t(fv), _t(valid),
                                     torch.full((n,), float(blur)))
    w_tiles, w_ids, w_counts, w_range = (np.asarray(x) for x in want)
    tiles, ids, counts, max_range = (x.numpy() for x in got)
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_array_equal(counts, w_counts)
    np.testing.assert_array_equal(max_range, w_range)
    np.testing.assert_array_equal(tiles, w_tiles)
    assert (ids >= 0).any(axis=-1).mean() > 0.2      # the mesh is in view
    if case == "range clamp":
        assert int(max_range.max()) > 256            # the clamp bites
    if case in ("slot overflow", "ties"):
        assert int(counts.max()) > tcfg.f_pad        # the slots overflow
    # The direct per-tile selection, too.
    w_direct = jax.vmap(partial(jfr._bin_face_ids, jcfg),
                        in_axes=(0, 0, None))(fv, valid, blur)
    direct = tbin._bin_face_ids(tcfg, _t(fv), _t(valid),
                                torch.full((n,), float(blur)))
    for a, b in zip(direct, w_direct):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sorted_selection_matches_direct():
    """Without a clamped window the y-sorted selection picks the direct
    per-tile selection's faces (slot order may differ only on exact
    depth ties): the same counts, filled slots and, row-sorted, tables
    (tests/test_binning.py's check, on the port), with M = 160 slots,
    more than any tile's candidates at sigma 1e-4."""
    mesh, rend = binned_scene(m=160, sigma=1e-4)
    _jcfg, tcfg = plans(mesh, rend)
    fv, merged, valid, blur = (_t(x) for x in shared_faces(mesh, rend))
    blur = torch.full((fv.shape[0],), float(blur))
    tiles, ids, counts, max_range = tbin._binned_tables_sorted(
        tcfg, merged, fv, valid, blur)
    d_ids, d_counts = tbin._bin_face_ids(tcfg, fv, valid, blur)
    assert int(max_range.max()) <= tbin._RANGE_MAX
    assert 0 < int(counts.max()) <= tcfg.f_pad == 160
    torch.testing.assert_close(counts, d_counts, rtol=0, atol=0)
    torch.testing.assert_close(ids >= 0, d_ids >= 0, rtol=0, atol=0)
    d_tiles = take_rows_batched(merged, d_ids)
    torch.testing.assert_close(torch.sort(tiles, dim=2)[0],
                               torch.sort(d_tiles, dim=2)[0], rtol=0, atol=0)


def test_prepare_inputs_and_active_tiles_equal_jax():
    """The port's binned ``_prepare_inputs`` against JAX's at XLA level 0
    (``jax_exact``): the per-tile tables, slot validity and scalars bit
    for bit; the activity bits equal JAX's ``_active_tiles`` (binned: any
    filled slot)."""
    mesh, rend = binned_scene(n_views=1)
    jcfg, tcfg = plans(mesh, rend)
    sh, st = rend.shader, rend.rasterizer.raster_settings
    key = jax.random.PRNGKey(3)
    want = jax_exact(lambda m: jfr._prepare_inputs(
        jcfg, m, sh.cameras, sh.lights, sh.materials, sh.smoothrast,
        sh.smoothagg, sh.blend_params, st, key, "phong"), mesh)
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(rend, device="cpu")
    tsh = trend.shader
    seeds = _t(np.asarray(want[6])[:, 0, :4])
    got = tfr._prepare_inputs(tcfg, tmesh, tsh.cameras, tsh.lights,
                              tsh.materials, tsh.smoothrast, tsh.smoothagg,
                              tsh.blend_params, trend.rasterizer
                              .raster_settings, seeds, "phong")
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4])[..., 0])
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5])[:, 0])
    w_active = jax.vmap(lambda v, va: jfr._active_tiles(jcfg, v, va, 0.0))(
        want[0], want[4])
    np.testing.assert_array_equal(got[7].numpy(),
                                  np.asarray(w_active).reshape(1, -1))
    assert 0 < int(got[7].sum()) < got[7].numel()


def test_capacity_stats_and_policies_match_jax():
    """capacity_stats of the binned scene equals JAX's (worst tile count,
    worst window, slots, window limit); it is None on the stream route;
    check_capacity_host warns, raises or stays silent as JAX's does, and
    the render-time check is silent under 'allow'."""
    mesh, rend = binned_scene(m=8)
    sh, st = rend.shader, rend.rasterizer.raster_settings
    want = jax.device_get(jfr.capacity_stats(
        mesh, sh.cameras, st, sh.smoothrast, sh.smoothagg, sh.lights,
        sh.materials))
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(rend, device="cpu")
    tsh, tst = trend.shader, trend.rasterizer.raster_settings
    got = tbin.capacity_stats(tmesh, tsh.cameras, tst, tsh.smoothrast,
                              tsh.smoothagg, tsh.lights, tsh.materials)
    assert {k: int(v) for k, v in want.items()} == got
    assert got["max_tile_candidates"] > got["slots"] == 8
    assert tbin.capacity_stats(tmesh, tsh.cameras, dataclasses.replace(
        tst, bin_overflow="warn"), tsh.smoothrast, tsh.smoothagg,
        tsh.lights) is None

    warn = dataclasses.replace(tst, bin_overflow="warn")
    with pytest.warns(UserWarning, match="capacity exceeded") as rec:
        msg = tbin.check_capacity_host(warn, got)
    with pytest.warns(UserWarning) as jrec:
        jmsg = jfr.check_capacity_host(dataclasses.replace(
            st, bin_overflow="warn"), want)
    assert msg == jmsg and str(rec[0].message) == str(jrec[0].message)
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        tbin.check_capacity_host(dataclasses.replace(
            tst, bin_overflow="error"), got)
    assert tbin.check_capacity_host(tst, got) is None          # 'allow'
    assert tbin.check_capacity_host(warn, None) is None
    ok = dict(got, max_tile_candidates=1, max_range=0)
    assert tbin.check_capacity_host(warn, ok) is None
    over = dict(ok, max_range=got["range_limit"] + 1)
    with pytest.warns(UserWarning, match="range clamped"):
        assert "range clamped" in tbin.check_capacity_host(warn, over)


@pytest.mark.parametrize("opt", ["binned", "stream: threshold",
                                 "stream: warn", "stream: size"])
def test_render_plan_binned_matches_jax(opt, monkeypatch):
    """render_plan reports the binned route (mode, slots, tile, reason)
    wherever JAX's does; 'allow' with F at or below the threshold, the
    default 'warn' policy and an image the tile does not divide stream."""
    if opt == "stream: threshold":
        for mod in (jfr, tfr):
            monkeypatch.setattr(mod, "_COARSE_THRESHOLD", 1280)
    mesh, rend = binned_scene(
        bin_overflow="warn" if opt == "stream: warn" else "allow")
    sh, st = rend.shader, rend.rasterizer.raster_settings
    if opt == "stream: size":
        st = dataclasses.replace(st, image_size=48)
        rend = rend.replace(rasterizer=rend.rasterizer.replace(
            raster_settings=st))
    want = jfr.render_plan(mesh, sh.cameras, sh.lights, sh.materials,
                           sh.smoothrast, sh.smoothagg, st)
    got = convert.from_reference(rend, device="cpu").plan(
        convert.from_reference(mesh, device="cpu"))
    assert got.mode == want.mode == opt.split(":")[0]
    for name in ("reason", "f", "k", "image_size", "p_tile", "tile",
                 "slots", "table_rows"):
        assert getattr(got, name) == getattr(want, name), name
