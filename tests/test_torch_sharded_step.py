"""The port's sharded pose step on four gloo CPU ranks (data 2 x samples
2) against the JAX package's ``make_sharded_pose_step`` on four virtual
devices, and the process-group start-up.

One step of two pose problems (the cube x2 at 16^2, K=12, GaussianRast +
GaussianAgg sharding their S=2 samples per rank, sigma 1e-3, gamma 1e-2;
Adam at 3e-2; the smoothing parameters learnt at 1e-4), from the JAX
problems' poses, targets (the hard Phong render of random rotations)
and seed words; JAX's step compiled at XLA optimisation level 0
(``jax_exact``).  Tolerances: ``log_rot`` after the step atol 1e-6,
losses rtol 1e-6, sigma / gamma / alpha after the step rtol 1e-6.  Each
data rank holds its own problem; the two sample ranks of a problem agree
bit for bit.  ``distributed.initialize`` is a no-op for one process, and
``build_multislice_mesh`` lays four ranks out as (slice, data,
samples)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

import pertrenderer_tpu as pt
from pertrenderer_tpu.parallel import sharding as jsharding
from pertrenderer_tpu.transforms import Rotate
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.parallel import distributed

from _torch_parity import interpret_env, jax_exact, jax_inputs
import _torch_sharded_worker as worker

LR, SMOOTHING_LR, BATCH = 3e-2, 1e-4, 2


def jax_problem():
    """The JAX step's scene, renderer, problems and one step's result."""
    scene_mesh = pt.load_cube().scale_verts(2.0)
    r, t = pt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0)
    cameras = pt.PerspectiveCameras.create(R=r, T=t, fov=60.0)
    lights = pt.PointLights.create(location=(0.0, 2.0, -2.0))
    sigma, gamma = 1e-3, 1e-2
    settings = pt.RasterizationSettings(
        image_size=16, blur_radius=float(np.log(1.0 / 1e-4 - 1.0) * sigma),
        faces_per_pixel=12)
    axis = jsharding.SAMPLE_AXIS
    renderer = pt.MeshRenderer.create(
        rasterizer=pt.MeshRasterizer.create(cameras=cameras,
                                            raster_settings=settings),
        shader=pt.RandomPhongShader.create(
            cameras=cameras, lights=lights,
            blend_params=pt.BlendParams(sigma=sigma, gamma=gamma,
                                        background_color=(0.0, 0.0, 0.0)),
            smoothrast=pt.GaussianRast.create(sigma=sigma, nb_samples=2,
                                              sample_axis=axis),
            smoothagg=pt.GaussianAgg.create(gamma=gamma, nb_samples=2,
                                            sample_axis=axis)))
    key = jax.random.PRNGKey(0)
    k_rot, k_keys = jax.random.split(key)
    r_true = pt.random_rotations(BATCH, k_rot)
    target_mesh = scene_mesh.extend(BATCH).update_padded(
        Rotate(r_true).transform_points(
            jnp.repeat(scene_mesh.verts, BATCH, axis=0)))
    hard = pt.MeshRenderer.create(
        rasterizer=pt.MeshRasterizer.create(
            cameras=cameras, raster_settings=pt.RasterizationSettings(
                image_size=16, faces_per_pixel=1)),
        shader=pt.HardPhongShader.create(
            cameras=cameras, lights=lights,
            blend_params=pt.BlendParams(background_color=(0.0, 0.0, 0.0))))
    cams_b = pt.PerspectiveCameras.create(
        R=jnp.repeat(r, BATCH, 0), T=jnp.repeat(t, BATCH, 0), fov=60.0)
    lights_b = pt.PointLights.create(location=(0.0, 2.0, -2.0), batch=BATCH)
    targets = hard(target_mesh, cameras=cams_b, lights=lights_b)[..., :3]
    log_rot = 0.1 * jax.random.normal(k_rot, (BATCH, 3))
    keys = jax.vmap(lambda i: jax.random.fold_in(k_keys, i))(
        jnp.arange(BATCH))
    opt = optax.adam(LR)
    opt_state = opt.init(log_rot)
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, (jsharding.DATA_AXIS, axis))
    step = jsharding.make_sharded_pose_step(mesh, scene_mesh, cameras, lights,
                                            opt, opt_state,
                                            smoothing_lr=SMOOTHING_LR)
    new_rot, _state, losses, new_rend = jax_exact(
        step, log_rot, opt_state, targets, keys, renderer)
    # Each problem renders one mesh from its own key: its seed words.
    seeds = np.concatenate([np.asarray(jax_inputs(scene_mesh, renderer,
                                                  key=keys[b])[1][-1])
                            [:, 0, :4] for b in range(BATCH)])
    return dict(scene_mesh=scene_mesh, cameras=cameras, lights=lights,
                renderer=renderer, targets=np.asarray(targets),
                log_rot=np.asarray(log_rot), seeds=seeds,
                new_rot=np.asarray(new_rot), losses=np.asarray(losses),
                smoothing=[float(v) for v in
                           new_rend.shader.get_smoothing()])


def test_sharded_pose_step_matches_jax(monkeypatch, tmp_path):
    interpret_env(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = jax_problem()
        payload = dict(
            shape=(2, 2), lr=LR, smoothing_lr=SMOOTHING_LR,
            mesh=convert.from_reference(ref["scene_mesh"], device="cpu"),
            cameras=convert.from_reference(ref["cameras"], device="cpu"),
            lights=convert.from_reference(ref["lights"], device="cpu"),
            renderer=convert.from_reference(ref["renderer"], device="cpu"),
            targets=torch.from_numpy(ref["targets"].copy()),
            log_rot=torch.from_numpy(ref["log_rot"]),
            seeds=torch.from_numpy(ref["seeds"]))
        ranks = worker.spawn(4, "pose_step", payload, tmp_path)
    finally:
        torch.set_num_threads(threads)
    assert [r["data"] for r in ranks] == [0, 0, 1, 1]
    for a, b in (ranks[:2], ranks[2:]):          # the two sample ranks
        assert torch.equal(a["log_rot"], b["log_rot"])
        assert torch.equal(a["losses"], b["losses"])
    log_rot = torch.cat([ranks[0]["log_rot"], ranks[2]["log_rot"]]).numpy()
    losses = torch.cat([ranks[0]["losses"], ranks[2]["losses"]]).numpy()
    assert np.all(losses > 0)
    np.testing.assert_allclose(log_rot, ref["new_rot"], rtol=0, atol=1e-6)
    assert np.abs(log_rot - ref["log_rot"]).max() > 1e-3
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    for r in ranks:                 # the smoothing step is shared
        np.testing.assert_allclose(r["smoothing"], ref["smoothing"],
                                   rtol=1e-6)
    assert ref["smoothing"][0] != 1e-3


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()


def test_build_multislice_mesh_layout(tmp_path):
    """Four ranks as (slice 2, data 1, samples 2), slice-major, made the
    active mesh."""
    ranks = worker.spawn(4, "multislice", {}, tmp_path)
    assert all(r["names"] == ("slice", "data", "samples")
               and r["shape"] == (2, 1, 2) and r["active"] and r["refused"]
               for r in ranks)
    assert [(r["slice"], r["samples"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_dryrun_multichip_on_cpu_ranks():
    """``dryrun_multichip(2, device='cpu')``: two spawned gloo ranks run
    the sharded pose step on the cube (flat sharded route) and the
    80-face icosphere (stream route, aggregation samples sharded); one
    finite loss per problem."""
    from pertrenderer_tpu_torch.parallel import sharding

    out = sharding.dryrun_multichip(2, device="cpu")
    assert sorted(out) == ["cube", "stream/sphere"]
    assert all(len(v) == 1 and np.isfinite(v).all() for v in out.values())
