"""Experiment CLI: pose optimisation, runtime benchmark, differentiability
check (PyTorch port of ``pertrenderer_tpu/experiments/eval.py``).

    python -m pertrenderer_tpu_torch.experiments.eval -et pose_opt -np 4 -ni 200
    python -m pertrenderer_tpu_torch.experiments.eval -et runtime -np 1 -ni 100
    python -m pertrenderer_tpu_torch.experiments.eval -et check_diff -cat sphere

The flags, the three ``--experiment-type`` modes and the JSON artifact
names (``angle_error.txt``, ``angle_error_final.txt``,
``angle_error_init.txt``, ``angle_std.txt``, ``solved_percentage.txt``,
``params.txt``, ``exp_setup.txt``; ``runtimes.txt`` and ``memory.txt``
for the runtime mode) are the JAX package's.  The port adds ``--device``
(default ``cuda``; the CPU runs the kernels' plain versions and is taken
only when asked for).  Every random draw comes from one CPU
``torch.Generator`` seeded with ``--seed``, so the port's problems are
not the JAX package's (whose draws are threefry keys).

Per-run times are host-clock seconds around each ``optimize_pose`` call
(its device work synchronised at every segment boundary); peak memory is
``torch.cuda.max_memory_allocated`` over the run, None on the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.experiments import harness
from pertrenderer_tpu_torch.utils import artifacts

DATASET_DIRECTORY = os.environ.get("SHAPENET_DIR", "")
NUM_ITERATIONS = 800
OPTIMIZER = "adam"
LR_VALUES = [3e-2]
SMOOTHING_VALUES = [(1e-3, 1e-2)]
SMOOTHING_NOISE = ["softras", "gaussian"]
MC_SAMPLES = [8]
ADAPTIVE_REGULARIZATION = 1
ADAPTIVE_PARAMS = [(1.1, 1.1)]
INITIAL_PERTURBATION = 20.0
CATEGORIES = ["cube"]
TASK = "pose_opt"
EXP_ID = 10
IMAGE_SIZE = 128
NUM_PROB = 100
RANDOM_SEED = 1
EXP_TYPE = "pose_opt"

SOLVED_THRESHOLDS = (1, 2, 5, 10, 15, 20, 25, 35, 45)


def parse_tuples(s):
    try:
        x, y = map(float, s.split(","))
        return x, y
    except Exception:
        raise argparse.ArgumentTypeError("Tuple must be x,y")


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-et", "--experiment-type", type=str, default=EXP_TYPE)
    parser.add_argument("-eid", "--experiment-id", type=int, default=EXP_ID)
    parser.add_argument("-dd", "--dataset-directory", type=str,
                        default=DATASET_DIRECTORY)
    parser.add_argument("-ni", "--num-iterations", type=int,
                        default=NUM_ITERATIONS)
    parser.add_argument("-opt", "--optimizer", type=str, default=OPTIMIZER)
    parser.add_argument("-lr", "--lr-values", nargs="+", type=float,
                        default=LR_VALUES)
    parser.add_argument("-sv", "--smoothing-values", nargs="+",
                        type=parse_tuples, default=SMOOTHING_VALUES)
    parser.add_argument("-sn", "--smoothing-noise", nargs="+", type=str,
                        default=SMOOTHING_NOISE)
    parser.add_argument("-mc", "--mc-samples", nargs="+", type=int,
                        default=MC_SAMPLES)
    parser.add_argument("-ar", "--adaptive-regularization", type=int,
                        default=ADAPTIVE_REGULARIZATION)
    parser.add_argument("-ap", "--adaptive-params", nargs="+",
                        type=parse_tuples, default=ADAPTIVE_PARAMS)
    parser.add_argument("-ip", "--initial-perturbation", type=float,
                        default=INITIAL_PERTURBATION)
    parser.add_argument("-cat", "--categories", nargs="+", type=str,
                        default=CATEGORIES)
    parser.add_argument("-tsk", "--task", type=str, default=TASK)
    parser.add_argument("-np", "--num-prob", type=int, default=NUM_PROB)
    parser.add_argument("-is", "--image-size", type=int, default=IMAGE_SIZE)
    parser.add_argument("-s", "--seed", type=int, default=RANDOM_SEED)
    parser.add_argument("--results-dir", type=str, default="results")
    parser.add_argument("--plot-results", type=int, default=1,
                        help="save the solved-percentage summary plot")
    parser.add_argument("-sra", "--save-run-artifacts", type=int, default=1,
                        help="dump per-run loss/grad .npy + image grid")
    parser.add_argument("--checkpoint-dir", type=str, default="",
                        help="save full run state at segment boundaries "
                             "under this directory (per run subdirs)")
    parser.add_argument("--resume", type=int, default=0,
                        help="with --checkpoint-dir: restore the latest "
                             "checkpoint of each run and continue its exact "
                             "trajectory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the experiment runs on; the "
                             "CPU runs the kernels' plain versions")
    return parser


def _ckpt_dir(args, tag):
    if not args.checkpoint_dir:
        return None
    return os.path.join(args.checkpoint_dir, str(args.experiment_id), tag)


def _seed(generator: torch.Generator) -> int:
    """A 31-bit seed drawn from ``generator``."""
    return int(torch.randint(2 ** 31 - 1, (1,), generator=generator))


def _make_test_problems(args, generator: torch.Generator, device):
    """The scene (meshes, cameras, lights) and ``--num-prob`` problems
    (target_rgb, R_true, log_rot_init, seed): a true pose and its target,
    and a start ``--initial-perturbation`` degrees from it."""
    imsize = args.image_size
    cat = args.categories[0]
    sp = args.dataset_directory or None
    meshes, cameras, lights, _, _, _, _ = harness.init_target(
        generator, category=cat, shapenet_path=sp, imsize=imsize,
        device=device)
    problems = []
    for _ in range(args.num_prob):
        _, _, _, target_rgb, R_true, _, _ = harness.init_target(
            generator, category=cat, shapenet_path=sp, imsize=imsize,
            device=device)
        seed = _seed(generator)
        log_rot_init, _ = harness.init_renderers(
            cameras[0], lights, R_true, torch.Generator().manual_seed(seed),
            pert_init_intensity=args.initial_perturbation, sigma=0.1,
            gamma=0.1, nb_samples=1, noise_type=args.smoothing_noise,
            imsize=imsize)
        problems.append((target_rgb, R_true, log_rot_init, seed))
    return meshes, cameras, lights, problems


def _grid(args):
    adapt_reg = bool(args.adaptive_regularization)
    adapt_params = args.adaptive_params if adapt_reg else [(1.0, 1.0)]
    mc_samples = args.mc_samples if not adapt_reg else [8]
    for lr in args.lr_values:
        for sigma, gamma in args.smoothing_values:
            for nb_mc in mc_samples:
                for ap in adapt_params:
                    yield lr, sigma, gamma, nb_mc, ap


def _angle_deg(log_rot, r_true) -> float:
    return float(ptt.so3_relative_angle(ptt.so3_exp_map(log_rot), r_true)
                 [0]) * 180.0 / math.pi


def _new_params():
    return {"lr-smoothing-MC": [], "lr": [], "sigma": [], "gamma": [],
            "MC": [], "adapt_params": []}


def _add_params(params, lr, sigma, gamma, nb_mc, adapt_param):
    params["lr-smoothing-MC"].append((lr, sigma, gamma, nb_mc))
    params["lr"].append(lr)
    params["sigma"].append(sigma)
    params["gamma"].append(gamma)
    params["MC"].append(nb_mc)
    params["adapt_params"].append(adapt_param)


def _renderers(args, cameras, lights, R_true, seed, sigma, gamma, nb_mc):
    _, renderers = harness.init_renderers(
        cameras[0], lights, R_true, torch.Generator().manual_seed(seed),
        pert_init_intensity=args.initial_perturbation, sigma=sigma,
        gamma=gamma, nb_samples=nb_mc, noise_type=args.smoothing_noise,
        imsize=args.image_size)
    return renderers


def compare_pose_opt(args, device):
    """Pose-optimisation quality over the grid of learning rates,
    smoothing values, sample counts and annealing parameters: the angle
    errors before and after, their mean and spread, and the share of
    problems solved below each threshold, per noise type."""
    generator = torch.Generator().manual_seed(args.seed)
    noise_type = args.smoothing_noise
    adapt_reg = bool(args.adaptive_regularization)
    meshes, cameras, lights, problems = _make_test_problems(
        args, generator, device)

    mean_errors = {x: [] for x in noise_type}
    var_errors = {x: [] for x in noise_type}
    init_errors = {x: [] for x in noise_type}
    final_errors = {x: [] for x in noise_type}
    mean_solved = {x: {t: [] for t in SOLVED_THRESHOLDS} for x in noise_type}
    params = _new_params()
    exp_setup = {
        "perturbation": args.initial_perturbation,
        "Niter": args.num_iterations, "optimizer": args.optimizer,
        "N_benchmark": args.num_prob, "adaptive_regularization": adapt_reg,
        "category": args.categories,
    }

    for g_idx, (lr, sigma, gamma, nb_mc, adapt_param) in enumerate(
            _grid(args)):
        angle_errors = {x: [] for x in noise_type}
        angle_errors_init = {x: [] for x in noise_type}
        for i, (target_rgb, R_true, log_rot_init, seed) in enumerate(
                problems):
            print(f"{i + 1}/{len(problems)} test problem", flush=True)
            renderers = _renderers(args, cameras, lights, R_true, seed,
                                   sigma, gamma, nb_mc)
            for l, nt in enumerate(noise_type):
                ang_init = _angle_deg(log_rot_init, R_true)
                angle_errors_init[nt].append(ang_init)
                run_dir = (artifacts.run_dir(args.results_dir,
                                             args.experiment_id)
                           if args.save_run_artifacts else None)
                res = harness.optimize_pose(
                    meshes, cameras, lights, log_rot_init, renderers[l],
                    target_rgb,
                    generator=torch.Generator().manual_seed(seed + l),
                    lr_init=lr, Niter=args.num_iterations,
                    optimizer=args.optimizer, adapt_reg=adapt_reg,
                    adapt_params=adapt_param, artifacts_dir=run_dir,
                    # The tag names the grid point too, so that --resume
                    # restores each (lr, sigma, gamma, MC, adapt) run's own.
                    checkpoint_dir=_ckpt_dir(args, f"pose_g{g_idx}_p{i}_{nt}"),
                    resume=bool(args.resume))
                ang = _angle_deg(res.best_log_rot, R_true)
                angle_errors[nt].append(ang)
                print(f"  {nt}: {ang_init:.2f} deg -> {ang:.2f} deg",
                      flush=True)
        for nt in noise_type:
            errs = angle_errors[nt]
            mean_errors[nt].append(sum(errs) / len(errs))
            var_errors[nt].append(float(np.std(errs)))
            init_errors[nt].append(angle_errors_init[nt])
            final_errors[nt].append(errs)
            for t in SOLVED_THRESHOLDS:
                mean_solved[nt][t].append(
                    sum(1 if a < t else 0 for a in errs) / len(errs))
        _add_params(params, lr, sigma, gamma, nb_mc, adapt_param)

    root, eid = args.results_dir, args.experiment_id
    artifacts.dump_json(root, eid, "angle_error.txt", mean_errors)
    artifacts.dump_json(root, eid, "angle_error_final.txt", final_errors)
    artifacts.dump_json(root, eid, "angle_error_init.txt", init_errors)
    artifacts.dump_json(root, eid, "angle_std.txt", var_errors)
    artifacts.dump_json(root, eid, "solved_percentage.txt", mean_solved)
    artifacts.dump_json(root, eid, "params.txt", params)
    artifacts.dump_json(root, eid, "exp_setup.txt", exp_setup)
    if args.plot_results:
        path = artifacts.plot_solved_percentage(root, eid, SOLVED_THRESHOLDS)
        if path:
            print("results plot:", path)
    print("mean angle errors:", mean_errors)
    return mean_errors


def compare_runtime(args, device):
    """Seconds and peak device memory of each pose-optimisation run over
    the grid, per noise type."""
    generator = torch.Generator().manual_seed(args.seed)
    noise_type = args.smoothing_noise
    adapt_reg = bool(args.adaptive_regularization)
    meshes, cameras, lights, problems = _make_test_problems(
        args, generator, device)

    mean_runtimes = {x: [] for x in noise_type}
    mean_memory = {x: [] for x in noise_type}
    params = _new_params()

    for lr, sigma, gamma, nb_mc, adapt_param in _grid(args):
        runtimes = {x: [] for x in noise_type}
        memory_cons = {x: [] for x in noise_type}
        for i, (target_rgb, R_true, log_rot_init, seed) in enumerate(
                problems):
            print(f"{i + 1}/{len(problems)} test problem", flush=True)
            renderers = _renderers(args, cameras, lights, R_true, seed,
                                   sigma, gamma, nb_mc)
            for l, nt in enumerate(noise_type):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                    torch.cuda.reset_peak_memory_stats(device)
                t_start = time.perf_counter()
                harness.optimize_pose(
                    meshes, cameras, lights, log_rot_init, renderers[l],
                    target_rgb,
                    generator=torch.Generator().manual_seed(seed + l),
                    lr_init=lr, Niter=args.num_iterations,
                    optimizer=args.optimizer, adapt_reg=adapt_reg,
                    adapt_params=adapt_param)
                timing = time.perf_counter() - t_start
                mem = artifacts.device_peak_memory_mb(device)
                runtimes[nt].append(timing)
                memory_cons[nt].append(mem)
                print(f"  {nt}: {timing:.2f}s peak memory: {mem} Mb",
                      flush=True)
        for nt in noise_type:
            mean_runtimes[nt].append(runtimes[nt])
            mean_memory[nt].append(memory_cons[nt])
        _add_params(params, lr, sigma, gamma, nb_mc, adapt_param)

    root, eid = args.results_dir, args.experiment_id
    artifacts.dump_json(root, eid, "runtimes.txt", mean_runtimes)
    artifacts.dump_json(root, eid, "memory.txt", mean_memory)
    print("runtimes:", mean_runtimes)
    return mean_runtimes


def check_differentiability(args, device):
    """The scene-parameter gradient check: optimises the light location
    of ``--categories[0]``'s source mesh (the cube: the flat route; the
    sphere: 1280 faces, the stream route), turned to a random pose,
    against the cube's target at another pose, at sigma 1e-4 / gamma
    1e-3 with the second noise type's renderer.  Returns (best params,
    losses)."""
    param_to_check = {"camera": False, "vertices": False, "textures": False,
                      "light": True}
    sigma, gamma = 1e-4, 1e-3
    generator = torch.Generator().manual_seed(args.seed)

    (src_mesh, deform_init, verts_rgb_init, camera_elev, camera_azim,
     lights_location) = harness.init_base_mesh_cameras_lights(
        args.categories[0], param_to_check, device=device)
    src_mesh = harness.normalize_mesh(src_mesh)

    _, _, _, target_rgb, R_true, _, _ = harness.init_target(
        generator, imsize=args.image_size, device=device)
    target_rgb = target_rgb[0][None]
    src_mesh = src_mesh.update_padded(
        ptt.Rotate(R_true).transform_points(src_mesh.verts_padded()))
    if src_mesh.textures is None:
        src_mesh = src_mesh.with_textures(
            ptt.TexturesVertex(torch.ones_like(src_mesh.verts)))

    nb_mc = args.mc_samples[0]
    R_true2 = ptt.random_rotations(1, generator, device=device)
    _, renderers = harness.init_renderers(
        None, None, R_true2, generator,
        pert_init_intensity=args.initial_perturbation, sigma=sigma,
        gamma=gamma, nb_samples=nb_mc, noise_type=args.smoothing_noise,
        imsize=args.image_size, device=device)
    best_params, _final, losses = harness.optimize_scene_params(
        src_mesh, camera_elev, camera_azim, lights_location, deform_init,
        verts_rgb_init, renderers[min(1, len(renderers) - 1)], [target_rgb],
        generator=generator, lr_init=args.lr_values[0],
        Niter=args.num_iterations, optimizer=args.optimizer,
        param_to_check=param_to_check,
        checkpoint_dir=_ckpt_dir(args, "check_diff"),
        resume=bool(args.resume))
    print("loss first/last:", float(losses[0]), float(losses[-1]))
    print("best light location:",
          best_params["lights_location"].cpu().numpy().tolist())
    return best_params, losses


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "kernels' plain versions on the CPU")
    os.makedirs(args.results_dir, exist_ok=True)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})", flush=True)
    if args.experiment_type == "pose_opt":
        return compare_pose_opt(args, device)
    if args.experiment_type == "runtime":
        return compare_runtime(args, device)
    if args.experiment_type == "check_diff":
        return check_differentiability(args, device)
    raise SystemExit(f"unknown experiment type {args.experiment_type!r}")


if __name__ == "__main__":
    main()
