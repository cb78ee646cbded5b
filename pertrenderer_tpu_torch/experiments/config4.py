"""BASELINE config 4: joint pose and vertex-offset optimisation over 16
views at once (the port of ``tests/test_multiview.py``'s scene, at
BASELINE's size).

    python -m pertrenderer_tpu_torch.experiments.config4
        [--out results/config4.json] [--device cuda]

The cube x2 is seen by 16 cameras (``VIEWS``) at 256^2 at dist 6.7, fov
60, with
elevations linspace(10, 60) and azimuths linspace(0, 315), lit by a point
light at (0, 2, -2); RandomPhongShader with GaussianRast (sigma 1e-4) and
GaussianAgg (gamma 1e-3) at S=4, blur 1e-4, background black.  At K=50
the 12-face cube takes the flat fused route, so a step's ``render_loss``
is one launch of K2 over every view (N = views); at K=8 it streams (K7).

A step renders the cube at the pose ``log_rot`` (one rotation for every
view) with a per-vertex offset ``deform`` added first, takes the mean
squared error against the targets (the views of the true pose) and an
Adam step on both (lr 5e-2 for the pose, 1e-3 for the offsets).  The
corner gather's gradient reaches the offsets through K9b.  The true pose
is a random rotation and the start 20 degrees from it about a random axis
(both from a CPU generator seeded 1, which also draws the targets' and
step 0's seed words: ``problem``).  ``main`` runs 30 steps (``STEPS``)
twice and records whether the two runs are bit-equal.

``dual_path`` holds ``render_loss``'s gradients (K2) against the render
(K3) and its backward (K4) with the L2 in autograd on the same seed words.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.ops import fused_render
from pertrenderer_tpu_torch.transforms import matmul3

__all__ = ["scene", "predict", "targets", "start_pose", "problem",
           "dual_path", "angle_deg", "optimize", "main"]

VIEWS, IMAGE, K, STEPS = 16, 256, 50, 30
SIGMA, GAMMA, BLUR, S = 1e-4, 1e-3, 1e-4, 4
LR_POSE, LR_DEFORM = 5e-2, 1e-3
OFFSET_DEG = 20.0
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def scene(n_views: int = VIEWS, imsize: int = IMAGE, k: int = K,
          device="cuda"):
    """(mesh (n_views copies of the cube x2), cameras, lights, renderer)."""
    mesh = ptt.load_cube(device=device).scale_verts(2.0).extend(n_views)
    elev = torch.linspace(10.0, 60.0, n_views)
    azim = torch.linspace(0.0, 315.0, n_views)
    r, t = ptt.look_at_view_transform(dist=6.7, elev=elev, azim=azim,
                                      device=device)
    cams = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=device)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0),
                                    batch=n_views, device=device)
    settings = ptt.RasterizationSettings(image_size=imsize, blur_radius=BLUR,
                                         faces_per_pixel=k)
    shader = ptt.RandomPhongShader.create(
        cameras=cams, lights=lights,
        blend_params=ptt.BlendParams(SIGMA, GAMMA, (0.0, 0.0, 0.0)),
        smoothrast=ptt.GaussianRast.create(sigma=SIGMA, nb_samples=S),
        smoothagg=ptt.GaussianAgg.create(gamma=GAMMA, nb_samples=S),
        device=device)
    return mesh, cams, lights, ptt.MeshRenderer(
        ptt.MeshRasterizer(cams, settings), shader)


def predict(mesh, log_rot, deform):
    """The mesh with ``deform`` (V, 3) added, then turned by log_rot (1, 3)
    in every view."""
    rot = ptt.so3_exp_map(log_rot).expand(mesh.batch_size, 3, 3)
    return mesh.update_padded(ptt.Rotate(rot).transform_points(
        mesh.verts + deform[None]))


def targets(mesh, renderer, r_true, seeds):
    """(N, H, W, 3) renders of the true pose."""
    rot = r_true.expand(mesh.batch_size, 3, 3)
    with torch.no_grad():
        return renderer(mesh.update_padded(ptt.Rotate(rot).transform_points(
            mesh.verts)), seeds=seeds)[..., :3]


def start_pose(r_true, offset_deg: float, generator):
    """log_rot (1, 3) ``offset_deg`` degrees from r_true about a random
    axis drawn from ``generator``."""
    axis = torch.randn(1, 3, generator=generator).to(r_true.device)
    axis = axis / torch.sqrt(torch.sum(axis * axis))
    r_pert = ptt.so3_exp_map(math.radians(offset_deg) * axis)
    return ptt.so3_log_map(matmul3(r_true, r_pert))


def problem(n_views: int = VIEWS, imsize: int = IMAGE, k: int = K,
            device="cuda"):
    """The run's scene and start: (mesh, renderer, r_true, target,
    log_rot0, seeds0), with step 0's seed words ``seeds0``."""
    mesh, _cams, _lights, rend = scene(n_views, imsize, k, device)
    gen = torch.Generator().manual_seed(1)
    r_true = ptt.random_rotations(1, gen, device=device)
    target = targets(mesh, rend, r_true,
                     fused_render.draw_seeds(n_views, gen, device=device))
    log_rot0 = start_pose(r_true, OFFSET_DEG, gen)
    seeds0 = fused_render.draw_seeds(n_views, gen, device=device)
    return mesh, rend, r_true, target, log_rot0, seeds0


def _grads(fn, log_rot, deform):
    lr = log_rot.detach().clone().requires_grad_(True)
    df = deform.detach().clone().requires_grad_(True)
    loss = fn(lr, df)
    loss.backward()
    return loss.detach(), lr.grad, df.grad


def dual_path(mesh, renderer, target, log_rot, deform, seeds):
    """(loss, grads) of render_loss (K2) and of the render (K3) with the
    L2 in autograd (K4), each grads (g_log_rot, g_deform)."""
    one = _grads(lambda lr, df: renderer.render_loss(
        predict(mesh, lr, df), target, seeds=seeds), log_rot, deform)
    two = _grads(lambda lr, df: torch.mean(
        (renderer(predict(mesh, lr, df), seeds=seeds)[..., :3] - target)
        ** 2), log_rot, deform)
    return one, two


def angle_deg(log_rot, r_true) -> float:
    return float(ptt.so3_relative_angle(ptt.so3_exp_map(log_rot), r_true)
                 .item()) * 180.0 / math.pi


def optimize(mesh, renderer, target, log_rot0, steps: int, generator):
    """Adam on (log_rot, deform) for ``steps`` steps of render_loss, seed
    words drawn from ``generator``: (log_rot, deform, losses, seconds of
    each step on a synchronised host clock)."""
    dev = mesh.device
    log_rot = log_rot0.detach().clone().requires_grad_(True)
    deform = torch.zeros(mesh.max_verts, 3, device=dev, requires_grad=True)
    opt = torch.optim.Adam([{"params": [log_rot], "lr": LR_POSE},
                            {"params": [deform], "lr": LR_DEFORM}])
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        seeds = fused_render.draw_seeds(mesh.batch_size, generator,
                                        device=dev)
        opt.zero_grad()
        loss = renderer.render_loss(predict(mesh, log_rot, deform), target,
                                    seeds=seeds)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs.append(time.perf_counter() - t0)
    return (log_rot.detach(), deform.detach(),
            torch.stack(losses).cpu().numpy(), secs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(_ROOT, "results",
                                                  "config4.json"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    mesh, rend, r_true, target, log_rot0, seeds0 = problem(VIEWS, IMAGE, K,
                                                           dev)
    zero = torch.zeros(mesh.max_verts, 3, device=dev)
    one, two = dual_path(mesh, rend, target, log_rot0, zero, seeds0)
    dual = [float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
            for a, b in zip(one[1:], two[1:])]
    runs = [optimize(mesh, rend, target, log_rot0, STEPS,
                     torch.Generator().manual_seed(2)) for _ in range(2)]
    log_rot, deform, losses, secs = runs[0]
    again = runs[1]
    step_ms = float(np.mean(secs[1:])) * 1e3
    rec = {
        "config": f"BASELINE config 4: cube x2, {VIEWS} views at "
                  f"{IMAGE}^2, K={K}, GaussianRast + GaussianAgg S={S}, "
                  f"joint log_rot + deform, {STEPS} Adam steps",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "route": rend.plan(mesh).mode,
        "verts": mesh.max_verts,
        "pose_error_deg": {"start": angle_deg(log_rot0, r_true),
                           "end": angle_deg(log_rot, r_true)},
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "losses_finite": bool(np.isfinite(losses).all()),
        "dual_path_rel_err": {"log_rot": dual[0], "deform": dual[1]},
        "dual_path_loss_rel_err": float(abs((one[0] - two[0]) / two[0])),
        "grads_finite_nonzero": {
            name: bool(torch.isfinite(g).all() and g.abs().sum() > 0)
            for name, g in zip(("log_rot", "deform"), one[1:])},
        "repeat_bit_equal": bool(
            torch.equal(again[0], log_rot) and torch.equal(again[1], deform)
            and np.array_equal(again[2], losses)),
        "step_ms": step_ms,
        "view_renders_per_s": VIEWS / step_ms * 1e3,
    }
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()
