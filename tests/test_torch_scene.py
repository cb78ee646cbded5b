"""Scene modules of the PyTorch port against the JAX package: transforms,
cameras, normals, the UV atlas bake and the fused forward's input tables
(atol 1e-6, float32 on the CPU) — plus the rule that the port never
imports JAX."""

import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pertrenderer_tpu as pt
import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.transforms import Rotate as JRotate
from pertrenderer_tpu.transforms import so3_exp_map as j_exp
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (build, interpret_env, jax_inputs,  # noqa: F401
                           one_torch_thread, port_config)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    interpret_env(monkeypatch)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


def test_so3_exp_log_and_rotate():
    rng = np.random.default_rng(0)
    log_rot = rng.normal(size=(3, 3)).astype(np.float32)
    log_rot[0] = 0.0                                  # the clamped angle
    pts = rng.normal(size=(3, 8, 3)).astype(np.float32)
    rj = j_exp(jnp.asarray(log_rot))
    rt = ptt.so3_exp_map(torch.from_numpy(log_rot))
    _close(rt, rj)
    _close(ptt.Rotate(rt).transform_points(torch.from_numpy(pts)),
           JRotate(rj).transform_points(jnp.asarray(pts)))
    _close(ptt.so3_log_map(rt), pt.so3_log_map(rj), atol=1e-5)
    _close(ptt.so3_relative_angle(rt, rt.flip(0)),
           pt.so3_relative_angle(rj, rj[::-1]), atol=1e-5)


def test_look_at_view_transform_and_ndc_projection():
    elev, azim = [20.0, 30.0, 89.0], [100.0, 120.0, -45.0]
    rj, tj = pt.look_at_view_transform(dist=6.7, elev=elev, azim=azim)
    rt, tt = ptt.look_at_view_transform(dist=6.7, elev=elev, azim=azim,
                                        device="cpu")
    _close(rt, rj)
    _close(tt, tj, atol=4e-6)              # |T| ~ 6.7: a few ulp
    cam_j = pt.PerspectiveCameras.create(R=rj, T=tj, fov=60.0)
    cam_t = convert.from_reference(cam_j, device="cpu")
    pts = np.random.default_rng(1).normal(size=(3, 10, 3)).astype(np.float32)
    _close(cam_t.transform_points_ndc(torch.from_numpy(pts)),
           cam_j.transform_points_ndc(jnp.asarray(pts)))
    _close(cam_t.camera_center(), cam_j.camera_center(), atol=4e-6)


def test_verts_normals_and_load_cube():
    mj = pt.load_cube().scale_verts(2.0)
    mt = ptt.load_cube(device="cpu").scale_verts(2.0)
    _close(mt.verts, mj.verts)
    np.testing.assert_array_equal(mt.faces.numpy(), np.asarray(mj.faces))
    rot = j_exp(jnp.asarray([[0.3, -0.2, 0.5]]))
    mj = mj.update_padded(JRotate(rot).transform_points(mj.verts))
    mt = convert.from_reference(mj, device="cpu")
    _close(mt.verts_normals(), mj.verts_normals())
    _close(mt.face_normals(), mj.face_normals())


@pytest.mark.parametrize("atlas_size", [1, 4])
def test_bake_atlas(atlas_size):
    rng = np.random.default_rng(2)
    cube = pt.load_cube()
    tex_j = cube.textures.replace(
        maps=jnp.asarray(rng.uniform(size=(1, 8, 96, 3)), jnp.float32),
        atlas_size=atlas_size)
    tex_t = convert.from_reference(tex_j, device="cpu")
    assert tex_t.atlas_size == atlas_size
    _close(tex_t._bake_atlas(), tex_j._bake_atlas())


@pytest.mark.parametrize("kw", [
    dict(),
    dict(textures="vertex", shade="simple", cull=True),
    dict(lights_kind="directional", perspective_correct=True, n_views=2),
])
def test_prepare_inputs_tables(kw):
    mesh, _cams, _lights, renderer = build("gaussian", **kw)
    jcfg, jin = jax_inputs(mesh, renderer)
    cfg = port_config(jcfg)
    tr = convert.from_reference(renderer, device="cpu")
    tm = convert.from_reference(mesh, device="cpu")
    sh = tr.shader
    seeds = np.asarray(jin[-1])[:, 0, :4]
    tin = tfr._prepare_inputs(cfg, tm, sh.cameras, sh.lights, sh.materials,
                              sh.smoothrast, sh.smoothagg, sh.blend_params,
                              tr.rasterizer.raster_settings, seeds,
                              "phong" if jcfg.shade == "phong" else "none")
    names = ("fv_ndc", "fv_world", "fn", "tex", "valid", "scal")
    want = [np.asarray(x) for x in jin[:6]]
    want[4] = want[4][..., 0]                       # valid (N, F_pad)
    want[5] = want[5][:, 0]                         # scal (N, 34)
    for name, got, ref in zip(names, tin[:6], want):
        assert got.shape == ref.shape, name
        assert got.dtype == torch.float32 and got.is_contiguous(), name
        # scal holds the camera center (|C| ~ 6.7): a few ulp there.
        _close(got, ref, atol=4e-6 if name == "scal" else ATOL)
    np.testing.assert_array_equal(tin[6].numpy(), seeds)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO,
                                                   "pertrenderer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "pertrenderer_tpu"), (path, mod)


@pytest.mark.parametrize("noise", ["gaussian_wovr", "hard"])
def test_from_reference_carries_the_pose_state(noise):
    """A JAX renderer mid-optimisation (annealed blur, doubled samples)
    comes across with its estimator classes, smoothing tensors, sample
    counts and blur override, so both packages' pose steps start alike."""
    mesh, _cams, _lights, jrend = build(noise, s=4)
    jrend = jrend.replace(
        rasterizer=jrend.rasterizer.update_blur(0.02),
        shader=jrend.shader.update_smoothing(sigma=3e-3, gamma=4e-2)
        .update_nb_samples(8))
    tr = convert.from_reference(jrend, device="cpu")
    sh, jsh = tr.shader, jrend.shader
    assert type(sh.smoothrast).__name__ == type(jsh.smoothrast).__name__
    assert type(sh.smoothagg).__name__ == type(jsh.smoothagg).__name__
    assert sh.get_nb_samples() == jsh.get_nb_samples()
    for got, want in zip(sh.get_smoothing(), jsh.get_smoothing()):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        _close(got, want)
    _close(tr.rasterizer.blur, 0.02)
    cfg, _why = tfr._plan(convert.from_reference(mesh, device="cpu"),
                          sh.lights, sh.smoothrast, sh.smoothagg,
                          tr.rasterizer.raster_settings, "phong")
    assert (cfg.rast_vr, cfg.agg_vr) == ((False, False) if noise ==
                                         "gaussian_wovr" else (True, True))
