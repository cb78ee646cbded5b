"""The port's experiment CLI, checkpoints and pose-loop resume.

``experiments.eval.main`` of the port runs ``pose_opt``, ``runtime`` and
``check_diff`` on the CPU (``--device cpu``, one problem, 4 iterations,
16^2) and writes the JSON artifacts the JAX package's CLI writes for the
same arguments: the same file names, keys and nesting.  The two packages
draw their problems from different generators, so only the layout is
compared.  On the JAX side ``init_target`` and ``optimize_pose`` are
stubs (an identity true pose, and the start pose returned as the best):
the artifacts' layout is the CLI layer's own, the loops are held by
``test_torch_train`` and ``test_torch_scene_params``, and the JAX CLI then
needs no compile of its target render or pose scan.  Plus ``utils/checkpoint``'s round trip and ``latest_step``,
``optimize_pose`` killed after a segment and resumed: bit-equal to the
uninterrupted run on the CPU, across an annealing boundary; and the
timing, tracing and memory helpers on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu.experiments import eval as jeval
from pertrenderer_tpu.experiments import harness as jh
from pertrenderer_tpu_torch.experiments import eval as teval
from pertrenderer_tpu_torch.experiments import harness as th
from pertrenderer_tpu_torch.utils import artifacts, checkpoint, profiling

from _torch_parity import one_torch_thread  # noqa: F401

ARGS = ["-np", "1", "-ni", "4", "-is", "16", "--plot-results", "0"]
POSE_FILES = ("angle_error.txt", "angle_error_final.txt",
              "angle_error_init.txt", "angle_std.txt",
              "solved_percentage.txt", "params.txt", "exp_setup.txt")
RUNTIME_FILES = ("runtimes.txt", "memory.txt")


def _layout(x):
    """The keys and nesting of a JSON value, its leaves' types dropped."""
    if isinstance(x, dict):
        return {k: _layout(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_layout(v) for v in x]
    return None


def _read(root, names):
    out = {}
    for name in names:
        with open(os.path.join(root, "7", name)) as f:
            out[name] = json.load(f)
    return out


def _jax_identity_target(key, category="cube", shapenet_path=None,
                         imsize=128):
    import jax.numpy as jnp

    return (None, [None], None, [jnp.zeros((imsize, imsize, 3))],
            jnp.eye(3)[None], None, None)


def _jax_start_pose(mesh, cameras, lights, init_pose, *args, **kw):
    return jh.PoseOptResult(best_log_rot=init_pose, log_rot=init_pose,
                            losses=np.zeros(4), grad_norms=np.zeros(4),
                            runtimes={"memory_mb": [None]})


@pytest.mark.parametrize("mode,names", [("pose_opt", POSE_FILES),
                                        ("runtime", RUNTIME_FILES)])
def test_cli_artifacts_match_jax(tmp_path, monkeypatch, one_torch_thread,
                                 mode, names):
    monkeypatch.setattr(jh, "init_target", _jax_identity_target)
    monkeypatch.setattr(jh, "optimize_pose", _jax_start_pose)
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    common = ["-et", mode, "-eid", "7", "-sra", "0"] + ARGS
    jeval.main(common + ["--results-dir", jax_root])
    teval.main(common + ["--results-dir", port_root, "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(port_root, "7"))) == sorted(
        os.listdir(os.path.join(jax_root, "7"))) == sorted(names)
    got, want = _read(port_root, names), _read(jax_root, names)
    assert _layout(got) == _layout(want)
    if mode == "pose_opt":
        assert got["exp_setup.txt"] == want["exp_setup.txt"]
        assert got["params.txt"] == want["params.txt"]
        for nt in ("softras", "gaussian"):
            init = got["angle_error_init.txt"][nt][0][0]
            assert init == pytest.approx(20.0, abs=1e-3)
            assert np.isfinite(got["angle_error.txt"][nt][0])
    else:
        assert got["memory.txt"] == {"softras": [[None]],
                                     "gaussian": [[None]]}
        assert all(t[0][0] > 0 for t in got["runtimes.txt"].values())


def test_cli_run_artifacts_and_check_diff(tmp_path, one_torch_thread):
    """With run artifacts on, each run leaves its histories; check_diff
    optimises the light only, on the cube (the flat route), with finite
    losses."""
    root = str(tmp_path)
    teval.main(["-et", "pose_opt", "-eid", "7", "-sn", "gaussian",
                "--results-dir", root, "--device", "cpu"] + ARGS)
    runs = os.listdir(os.path.join(root, "7", "optimization_details"))
    assert len(runs) == 1
    hist = np.load(os.path.join(root, "7", "optimization_details", runs[0],
                                "loss_values.npy"))
    assert hist.shape == (4,) and np.all(np.isfinite(hist))

    best, losses = teval.main(["-et", "check_diff", "--results-dir", root,
                               "--device", "cpu"] + ARGS)
    assert losses.shape == (4,) and np.all(np.isfinite(losses))
    assert sorted(best) == sorted(th.SCENE_PARAMS)
    moved = (best["lights_location"] - torch.tensor([[0.0, 6.0, -1.0]]))
    assert float(moved.abs().max()) > 0.0
    assert torch.equal(best["camera_elev"], torch.tensor([30.0]))


def test_cli_refuses_a_missing_card():
    """The default device is the card: without one the CLI stops and
    names --device cpu, it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        teval.main(["-et", "runtime"] + ARGS)


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    d = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(d)
    gen = torch.Generator().manual_seed(3)
    torch.randn(5, generator=gen)
    state = {"x": torch.arange(6.0).reshape(2, 3), "lr": 0.025,
             "step": 50, "ema": [torch.tensor(1.5), torch.tensor(-2.0)],
             "generator": gen.get_state(), "optimizer": None,
             "nested": {"a": torch.ones(2, dtype=torch.int32)}}
    for step in (50, 100, 7):
        checkpoint.save_checkpoint(d, dict(state, step=step), step)
    assert checkpoint.latest_step(d) == 100
    assert sorted(os.listdir(d)) == ["step_100", "step_50", "step_7"]
    back = checkpoint.restore_checkpoint(d)
    assert back["step"] == 100 and back["lr"] == 0.025
    assert torch.equal(back["x"], state["x"])
    assert torch.equal(back["nested"]["a"], state["nested"]["a"])
    assert [float(e) for e in back["ema"]] == [1.5, -2.0]
    assert checkpoint.restore_checkpoint(d, 7)["step"] == 7
    g2 = torch.Generator()
    g2.set_state(back["generator"])
    assert torch.equal(torch.randn(4, generator=g2),
                       torch.randn(4, generator=gen))


def test_pose_kill_and_resume_is_bit_equal(tmp_path, one_torch_thread):
    """optimize_pose killed after its first 51-step segment and resumed
    from the checkpoint follows the uninterrupted run bit for bit: the
    pose, the best iterate, every loss and gradient norm, and the
    annealing at step 102 (sigma, gamma, S, lr, the optimizer reset)."""
    dev = "cpu"
    r, t = ptt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0,
                                      device=dev)
    cams = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=dev)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), device=dev)
    mesh = ptt.load_cube(device=dev).scale_verts(2.0)
    r_true = ptt.random_rotations(1, torch.Generator().manual_seed(4),
                                  device=dev)
    log_rot, (renderer,) = th.init_renderers(
        cams, lights, r_true, torch.Generator().manual_seed(1),
        pert_init_intensity=20.0, sigma=1e-2, gamma=5e-2, nb_samples=2,
        noise_type=("gaussian",), imsize=8, faces_per_pixel=16)
    posed = mesh.update_padded(ptt.Rotate(r_true).transform_points(
        mesh.verts))
    target = renderer(posed, seeds=torch.zeros(1, 4, dtype=torch.int32))[
        0, ..., :3].detach()
    kw = dict(Niter=104, segment_size=51, adapt_reg=True, lr_init=3e-2)

    def run(**extra):
        return th.optimize_pose(mesh, cams, lights, log_rot, renderer,
                                [target],
                                generator=torch.Generator().manual_seed(9),
                                **kw, **extra)

    full = run()
    assert full.nb_samples == [2, 2, 4]         # annealed at step 102
    ckpt = str(tmp_path / "pose")
    killed = run(checkpoint_dir=ckpt, max_segments=1)
    assert killed.losses.shape == (51,)
    assert checkpoint.latest_step(ckpt) == 51
    resumed = run(checkpoint_dir=ckpt, resume=True)
    assert resumed.nb_samples == [2, 4]
    assert checkpoint.latest_step(ckpt) == 104
    assert torch.equal(resumed.log_rot, full.log_rot)
    assert torch.equal(resumed.best_log_rot, full.best_log_rot)
    assert np.array_equal(resumed.losses, full.losses)
    assert np.array_equal(resumed.grad_norms, full.grad_norms)


def test_profiling_and_memory_helpers_on_the_cpu(tmp_path):
    """per_iteration_time's slope is a time; a trace of CPU work is
    written and has no device kernels to sum; the CPU has no device peak
    memory."""
    a = torch.randn(64, 64)
    t = profiling.per_iteration_time(lambda c: c @ a, torch.eye(64),
                                     device="cpu")
    assert 0.0 <= t < 1.0
    log = str(tmp_path / "trace")
    with profiling.trace(log) as where:
        (a @ a).sum().item()
    assert where == log and len(os.listdir(log)) == 1
    assert profiling.summarize_trace(log) == []
    assert artifacts.device_peak_memory_mb("cpu") is None
