"""The port's sample-sharded routes on two gloo CPU ranks, against the
JAX package's ``shard_map`` on two virtual devices and against the port's
folded single-process runs.

Two ranks (spawned once for the module, ``_torch_sharded_worker``) shard
the samples of each case: the loss of the JAX sharding tests,
mean((image - target)^2) of the posed mesh, and its gradients with
respect to the pose and sigma, gamma and alpha, through ``MeshRenderer``
(``render_loss``, which renders and reduces under sharding):

* ``flat`` — the cube x2 at 16^2, K=16, GaussianRast + GaussianAgg, S=2
  per rank: the flat sharded route (K11a, K3 with external coverage,
  K11b, K11c plain versions on the CPU);
* ``stream`` — the level-2 icosphere (320 faces) at 16^2, K=50, S_rast=3
  on every rank, S_agg=2 per rank: the stream route, aggregation samples
  sharded;
* ``staged`` — the flat case with a znear override, which sends it
  staged: the staged estimators (K8a-c plain versions) shard themselves.

Each is held against the folded run (one process, the group's samples:
S=4, stream S_agg=4), and flat and stream against JAX's sharded runs
(``jax.shard_map`` over the ``samples`` axis, PERTRENDERER_FUSED=
interpret, compiled at XLA optimisation level 0 as ``jax_exact``), with
the JAX package's sharded = folded tolerances: image atol 1e-6, loss
rtol 1e-6, pose gradient 1e-6 of its max, sigma / gamma / alpha rtol
1e-5 (stream 5e-5 with atol 5e-7).  Against JAX the stream pose gradient
is held at 1e-5 of its max: the port's plain chunk sweeps add the slot
terms in another order than JAX's kernels (2e-6 of max apart here; the
folded comparison, in one package, keeps 1e-6).  The JAX side is
computed once per module.  And ``render_plan``: the sharded modes, and every rule that
declines with the JAX package's reason."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import pertrenderer_tpu as pt
from pertrenderer_tpu.lights import Materials
from pertrenderer_tpu.ops import fused_render as jfr
from pertrenderer_tpu.transforms import Rotate, so3_exp_map
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import interpret_env, jax_exact, jax_inputs
import _torch_sharded_worker as worker

N_DEV, AXIS = 2, "samples"
SIGMA, GAMMA = 1e-2, 5e-1
LOG_ROT = 0.1 * np.ones((1, 3), np.float32)
TARGET = np.linspace(0.0, 1.0, 16 * 16 * 3, dtype=np.float32).reshape(
    1, 16, 16, 3)


def scene(kind, nb_rast, nb_agg, axis):
    """(mesh, cameras, lights, renderer) of the JAX package: the flat cube
    or the stream icosphere of tests/test_sharding.py."""
    if kind == "stream":
        verts, faces = pt.make_icosphere(2)
        mesh = pt.Meshes.create(verts, faces, textures=pt.TexturesVertex(
            jnp.linspace(0.1, 0.9, verts.shape[0] * 3).reshape(
                1, verts.shape[0], 3))).scale_verts(2.0)
        k = 50
    else:
        mesh, k = pt.load_cube().scale_verts(2.0), 16
    r, t = pt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0)
    cameras = pt.PerspectiveCameras.create(R=r, T=t, fov=60.0)
    lights = pt.PointLights.create(location=(0.0, 2.0, -2.0))
    settings = pt.RasterizationSettings(
        image_size=16, blur_radius=float(np.log(1.0 / 1e-4 - 1.0) * SIGMA),
        faces_per_pixel=k)
    renderer = pt.MeshRenderer.create(
        rasterizer=pt.MeshRasterizer.create(cameras=cameras,
                                            raster_settings=settings),
        shader=pt.RandomPhongShader.create(
            cameras=cameras, lights=lights,
            blend_params=pt.BlendParams(sigma=SIGMA, gamma=GAMMA,
                                        background_color=(0., 0., 0.)),
            smoothrast=pt.GaussianRast.create(sigma=SIGMA,
                                              nb_samples=nb_rast,
                                              sample_axis=axis),
            smoothagg=pt.GaussianAgg.create(gamma=GAMMA, nb_samples=nb_agg,
                                            sample_axis=axis)))
    return mesh, cameras, lights, renderer


KEYS = {"flat": 7, "stream": 11}
SAMPLES = {"flat": (2, 2), "stream": (3, 2)}       # (S_rast, S_agg) per rank


def case_args(kind, sharded):
    s_rast, s_agg = SAMPLES[kind]
    fold = 1 if sharded else N_DEV
    return scene(kind, s_rast if kind == "stream" else s_rast * fold,
                 s_agg * fold, AXIS if sharded else None)


def jax_run(kind):
    """JAX's sharded value and gradients on N_DEV virtual devices."""
    mesh, cameras, lights, renderer = case_args(kind, True)
    key = jax.random.PRNGKey(KEYS[kind])

    def loss(log_rot, sig, gam, alp):
        rr = renderer.replace(shader=renderer.shader.update_smoothing(
            sigma=sig, gamma=gam, alpha=alp))
        pred = mesh.update_padded(Rotate(so3_exp_map(log_rot))
                                  .transform_points(mesh.verts_padded()))
        images = rr(pred, key=key, cameras=cameras, lights=lights)
        return jnp.mean((images[..., :3] - TARGET) ** 2), images

    def run(*a):
        return jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                  has_aux=True)(*a)

    devices = np.asarray(jax.devices()[:N_DEV]).reshape(1, N_DEV)
    sharded = jax.shard_map(
        run, mesh=Mesh(devices, ("data", AXIS)), in_specs=(P(),) * 4,
        out_specs=((P(), P()), (P(),) * 4), check_vma=False)
    (l, img), g = jax_exact(sharded, jnp.asarray(LOG_ROT),
                            jnp.asarray(SIGMA), jnp.asarray(GAMMA),
                            jnp.asarray(1.0))
    return dict(loss=float(l), image=np.asarray(img),
                grads=[np.asarray(x) for x in g])


def port_case(kind, sharded, **kwargs):
    """The worker's case dict: the scene carried across, JAX's seed words
    (unoffset: each rank offsets its own)."""
    mesh, _c, _l, renderer = case_args(kind, sharded)
    seeds = jax_inputs(mesh, renderer, key=jax.random.PRNGKey(KEYS[kind]))[
        1][-1]
    return dict(renderer=convert.from_reference(renderer, device="cpu"),
                mesh=convert.from_reference(mesh, device="cpu"),
                target=torch.from_numpy(TARGET),
                seeds=torch.from_numpy(np.array(seeds[:, 0, :4])),
                log_rot=torch.from_numpy(LOG_ROT),
                smoothing=(SIGMA, GAMMA, 1.0), kwargs=kwargs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (port sharded (rank 0), the other rank, port folded, JAX
    sharded or None)} for flat, stream and staged."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PERTRENDERER_FUSED", "interpret")
    mp.setenv("PERTRENDERER_PACK", "off")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        specs = {"flat": ("flat", {}), "stream": ("stream", {}),
                 "staged": ("flat", {"znear": 1.0})}
        cases = {name: port_case(kind, True, **kw)
                 for name, (kind, kw) in specs.items()}
        ranks = worker.spawn(N_DEV, "sharded_cases", dict(cases=cases),
                             tmp_path_factory.mktemp("sharded"))
        out = {}
        for name, (kind, kw) in specs.items():
            folded = worker.value_and_grads(port_case(kind, False, **kw))
            ref = jax_run(kind) if name != "staged" else None
            out[name] = (ranks[0][name], ranks[1][name], folded, ref)
        return out
    finally:
        torch.set_num_threads(threads)
        mp.undo()


def assert_close(got, want, stream: bool, pose_tol=1e-6):
    """image atol 1e-6, loss rtol 1e-6, pose gradient ``pose_tol`` of its
    max, sigma / gamma / alpha rtol 1e-5 (stream 5e-5, atol 5e-7)."""
    np.testing.assert_allclose(np.asarray(got["image"]),
                               np.asarray(want["image"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    g_pose, w_pose = np.asarray(got["grads"][0]), np.asarray(
        want["grads"][0])
    assert np.abs(w_pose).max() > 0
    np.testing.assert_allclose(g_pose, w_pose, rtol=0,
                               atol=pose_tol * np.abs(w_pose).max())
    rtol, atol = (5e-5, 5e-7) if stream else (1e-5, 1e-8)
    for a, b in zip(got["grads"][1:], want["grads"][1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["flat", "stream", "staged"])
def test_sharded_equals_folded(name, runs):
    """Both ranks hold the same image, loss and gradients, equal to the
    folded run's on the group's samples."""
    rank0, rank1, folded, _ref = runs[name]
    assert rank0["plan"] == folded["plan"] == (
        "staged" if name == "staged" else name)
    assert torch.equal(rank0["image"], rank1["image"])
    assert rank0["loss"] == rank1["loss"]
    assert all(torch.equal(a, b) for a, b in zip(rank0["grads"],
                                                 rank1["grads"]))
    assert_close(rank0, folded, name == "stream")


@pytest.mark.parametrize("name", ["flat", "stream"])
def test_sharded_matches_jax_shard_map(name, runs):
    """The port's two ranks against JAX's two devices."""
    rank0, _rank1, _folded, ref = runs[name]
    assert_close(rank0, ref, name == "stream",
                 pose_tol=1e-5 if name == "stream" else 1e-6)


def _plans(monkeypatch, rast, agg, mesh=None, size=16, k=16, **settings):
    """(port RenderPlan, JAX RenderPlan) of the cube (or ``mesh``) with the
    JAX estimators ``rast`` / ``agg``."""
    mesh = mesh if mesh is not None else pt.load_cube().scale_verts(2.0)
    _m, cameras, lights, _r = scene("flat", 2, 2, None)
    st = pt.RasterizationSettings(image_size=size, faces_per_pixel=k,
                                  blur_radius=1e-3, **settings)
    jplan = jfr.render_plan(mesh, cameras, lights, Materials.create(), rast,
                            agg, st, "phong")
    tplan = tfr.render_plan(convert.from_reference(mesh, device="cpu"),
                            convert.from_reference(lights, device="cpu"),
                            convert.from_reference(rast, device="cpu"),
                            convert.from_reference(agg, device="cpu"),
                            convert.from_reference(st, device="cpu"),
                            "phong")
    return tplan, jplan


def test_render_plan_sharded_modes_and_declines(monkeypatch):
    """Flat and stream sharded plans report prob_ext; every sharding rule
    that declines gives the JAX package's reason and the staged mode."""
    gr = lambda axis=AXIS: pt.GaussianRast.create(sigma=SIGMA, nb_samples=2,
                                                  sample_axis=axis)
    ga = lambda axis=AXIS: pt.GaussianAgg.create(gamma=GAMMA, nb_samples=2,
                                                 sample_axis=axis)
    tplan, _j = _plans(monkeypatch, gr(), ga())
    assert (tplan.mode, tplan.prob_ext) == ("flat", True)
    verts, faces = pt.make_icosphere(2)
    ico = pt.Meshes.create(verts, faces, textures=pt.TexturesVertex(
        jnp.full((1, verts.shape[0], 3), 0.5)))
    tplan, _j = _plans(monkeypatch, pt.SoftRast.create(sigma=SIGMA), ga(),
                       mesh=ico, k=50)
    assert (tplan.mode, tplan.prob_ext) == ("stream", True)
    assert not _plans(monkeypatch, gr(None), ga(None))[0].prob_ext

    # Two axes; a deterministic aggregation; flat with one estimator
    # sharding (a deterministic coverage has no sample axis, so the flat
    # MC / MC rule declines it under this reason too).
    declines = [(gr("a"), ga("b")), (gr(), pt.SoftAgg.create(gamma=GAMMA)),
                (pt.SoftRast.create(sigma=SIGMA), ga()), (gr(None), ga())]
    reasons = set()
    for rast, agg in declines:
        tplan, jplan = _plans(monkeypatch, rast, agg)
        assert tplan.mode == jplan.mode == "staged"
        assert tplan.reason == jplan.reason
        reasons.add(tplan.reason)
    # Binned is not sharded (reached at small F as the binned tests do).
    for mod in (tfr, jfr):
        monkeypatch.setattr(mod, "_COARSE_THRESHOLD", 256)
        monkeypatch.setattr(mod, "_BIN_P_TILE", 32)
    tplan, jplan = _plans(monkeypatch, gr(), ga(), mesh=ico, size=64, k=50,
                          bin_overflow="allow")
    assert tplan.mode == jplan.mode == "staged"
    assert tplan.reason == jplan.reason
    reasons.add(tplan.reason)
    assert len(reasons) == 4


def test_sharded_route_needs_a_mesh_and_no_loss_kernel(monkeypatch):
    """Outside a process group the sharded route raises (no mesh, as
    JAX's axis_index outside shard_map); try_render_loss declines it
    (None: render_loss renders and reduces, as the JAX package does)."""
    interpret_env(monkeypatch)
    case = port_case("flat", True)
    sh = case["renderer"].shader
    settings = case["renderer"].rasterizer.raster_settings
    cfg, _why = tfr._plan(case["mesh"], sh.lights, sh.smoothrast,
                          sh.smoothagg, settings, "phong")
    assert cfg.prob_ext
    with pytest.raises(RuntimeError, match="no device mesh"):
        case["renderer"](case["mesh"], seeds=case["seeds"])
    assert tfr.try_render_loss(cfg, case["mesh"], sh.cameras, sh.lights,
                               sh.materials, sh.smoothrast, sh.smoothagg,
                               sh.blend_params, settings, "phong",
                               case["target"], seeds=case["seeds"]) is None
