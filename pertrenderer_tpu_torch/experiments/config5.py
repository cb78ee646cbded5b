"""Config-5 pose recovery through the binned (and the stream) route: the
PyTorch port of ``tools/compare_config5_opt.py``.

    python -m pertrenderer_tpu_torch.experiments.config5 [--iters 400]
        [--modes binned stream] [--out results/config5_opt_compare.json]

BASELINE config 5: the level-6 icosphere (81,920 faces) scaled x3, with a
low-frequency asymmetric vertex colouring (three incommensurate sines, so
that every rotation looks different), at 512^2, K=150, GaussianRast +
GaussianAgg at S=8, a point light at (0, 2, -2), camera dist 6.7 elev 30
azim 120, fov 60.  The true rotation is ``--pert`` degrees about an axis
drawn from a CPU generator seeded ``--seed`` (the JAX script draws its
axis from a JAX key, so the two scripts' axes differ); the target is the
hard render of the true pose (blur 0, HardRast + HardAgg, the default
settings' route).  Each mode runs ``optimize_pose`` from the identity with
the script's coarse-to-fine smoothing (sigma0 6e-3, gamma0 6e-2, annealed
by 1.35 every 50-step segment past step 100), Adam at lr 3e-2; the binned
mode opts in with ``bin_overflow='allow'`` and records its capacity at the
identity under the 'warn' policy, as the JAX script does.  The JSON
record lands in ``--out`` (by default under ``results/`` at the repository
root, which git ignores).

``oracle_scene`` is the scene of ``tools/oracle_config5.py`` (vertex
colours 0.5 + 0.5 |v|, softras at sigma 1e-3, gamma 1e-2, whose capacity
``artifacts/oracle_config5.json`` records).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.experiments import harness
from pertrenderer_tpu_torch.ops import binned

__all__ = ["icosphere_mesh", "scene", "renderer", "oracle_scene", "main"]

IMAGE, K, LEVEL = 512, 150, 6
_BLUR_CONST = float(np.log(1.0 / 1e-4 - 1.0))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def icosphere_mesh(level: int, colours: str, device):
    """The icosphere of ``level`` scaled x3, coloured ``oracle`` (0.5 +
    0.5 |v|) or ``asymmetric`` (the compare script's sines)."""
    verts, faces = ptt.make_icosphere(level)
    v = torch.as_tensor(verts, dtype=torch.float32)
    if colours == "oracle":
        tex = 0.5 + 0.5 * torch.abs(v)
    else:
        x, y, z = v[:, 0], v[:, 1], v[:, 2]
        tex = torch.stack([0.5 + 0.5 * torch.sin(2.3 * x + 1.3 * y + 0.7),
                           0.5 + 0.5 * torch.sin(1.7 * y + 2.9 * z + 1.1),
                           0.5 + 0.5 * torch.sin(3.1 * z + 1.9 * x + 2.3)],
                          dim=-1)
    mesh = ptt.Meshes.create(v, faces, device=device,
                             textures=ptt.TexturesVertex(tex[None].to(device)))
    return mesh.scale_verts(3.0)


def scene(device, n: int = 1):
    """(cameras, lights) of config 5 for ``n`` renders of one view."""
    r, t = ptt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0,
                                      device=device)
    cams = ptt.PerspectiveCameras.create(R=r.expand(n, 3, 3),
                                         T=t.expand(n, 3), fov=60.0,
                                         device=device)
    return cams, ptt.PointLights.create(location=(0.0, 2.0, -2.0),
                                        device=device)


def renderer(cameras, lights, noise: str, sigma: float, gamma: float,
             s: int = 8, image: int = IMAGE, k: int = K,
             bin_overflow: str = "allow", blur=None, device="cuda"):
    """A RandomPhongShader renderer of the config-5 settings
    (``max_faces_per_bin`` 50000, so M = 160 slots) with the ``noise``
    pair of ``harness.make_smoothers``; blur from sigma unless given."""
    settings = ptt.RasterizationSettings(
        image_size=image, faces_per_pixel=k, max_faces_per_bin=50000,
        blur_radius=_BLUR_CONST * sigma if blur is None else blur,
        perspective_correct=False, bin_overflow=bin_overflow)
    sr, sa = harness.make_smoothers(noise, sigma, gamma, 1.0, s)
    shader = ptt.RandomPhongShader.create(
        cameras=cameras, lights=lights, smoothrast=sr, smoothagg=sa,
        blend_params=ptt.BlendParams(sigma, gamma, (0.0, 0.0, 0.0)),
        device=device)
    return ptt.MeshRenderer(ptt.MeshRasterizer(cameras, settings), shader)


def oracle_scene(device, n: int = 1):
    """(mesh, cameras, lights, softras renderer) of tools/oracle_config5.py
    at n renders, binned (``bin_overflow='allow'``)."""
    mesh = icosphere_mesh(LEVEL, "oracle", device).extend(n)
    cams, lights = scene(device, n)
    return mesh, cams, lights, renderer(cams, lights, "softras", 1e-3, 1e-2,
                                        device=device)


def _angle_deg(log_rot, r_true) -> float:
    return float(ptt.so3_relative_angle(ptt.so3_exp_map(log_rot), r_true)
                 .item()) * 180.0 / math.pi


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--adapt", action="store_true", default=True)
    ap.add_argument("--no-adapt", dest="adapt", action="store_false")
    ap.add_argument("--image", type=int, default=IMAGE)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--s", type=int, default=8)
    ap.add_argument("--level", type=int, default=LEVEL)
    ap.add_argument("--pert", type=float, default=20.0)       # degrees
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--sigma0", type=float, default=6e-3)
    ap.add_argument("--gamma0", type=float, default=6e-2)
    ap.add_argument("--adapt-params", type=float, nargs=2,
                    default=(1.35, 1.35))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--modes", nargs="+", default=["binned"],
                    choices=["binned", "stream"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        _ROOT, "results", "config5_opt_compare.json"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    mesh = icosphere_mesh(args.level, "asymmetric", dev)
    cams, lights = scene(dev)
    gen = torch.Generator().manual_seed(args.seed)
    axis = torch.randn(1, 3, generator=gen)
    axis = axis / torch.sqrt(torch.sum(axis * axis))
    r_true = ptt.so3_exp_map(axis * math.radians(args.pert)).to(dev)
    posed = mesh.update_padded(ptt.Rotate(r_true).transform_points(
        mesh.verts_padded()))
    hard = renderer(cams, lights, "hard", 1e-3, 1e-2, image=args.image,
                    k=args.k, bin_overflow="warn", blur=0.0, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        target = hard(posed, seeds=torch.zeros(1, 4, dtype=torch.int32))[
            0, ..., :3]
    print(f"hard target ({hard.plan(posed).mode} route): "
          f"{time.perf_counter() - t0:.1f} s, coverage "
          f"{(target.sum(-1) > 0).float().mean().item():.3f}",
          file=sys.stderr)

    nf = int(mesh.num_faces[0])
    rec = {
        "config": f"config-5 pose-opt comparison: icosphere level "
                  f"{args.level} ({nf} faces), {args.image}^2, K={args.k}, "
                  f"S={args.s}, gaussian member, {args.iters} iters Adam "
                  f"lr={args.lr}, {args.pert} deg true rotation",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "sigma0": args.sigma0, "gamma0": args.gamma0,
        "adapt_params": list(args.adapt_params), "modes": {}}
    init_angle = _angle_deg(torch.zeros(1, 3, device=dev), r_true)
    for mode in args.modes:
        rr = renderer(cams, lights, "gaussian", args.sigma0, args.gamma0,
                      s=args.s, image=args.image, k=args.k,
                      bin_overflow="allow" if mode == "binned" else "warn",
                      device=dev)
        plan = rr.plan(mesh)
        if plan.mode != mode:
            raise RuntimeError(f"{mode}: the scene routes {plan.mode} "
                               f"({plan.reason})")
        capacity = None
        if mode == "binned":
            st = rr.rasterizer.raster_settings
            stats = binned.capacity_stats(mesh, cams, st,
                                          rr.shader.smoothrast,
                                          rr.shader.smoothagg, lights)
            msg = binned.check_capacity_host(
                dataclasses.replace(st, bin_overflow="warn"), stats)
            print(f"[binned] capacity: {msg}", file=sys.stderr)
            capacity = dict(stats, warning=msg)
        t0 = time.perf_counter()
        res = harness.optimize_pose(
            mesh, cams, lights, torch.zeros(1, 3, device=dev), rr, [target],
            generator=torch.Generator().manual_seed(args.seed),
            lr_init=args.lr, Niter=args.iters, adapt_reg=args.adapt,
            adapt_params=tuple(args.adapt_params), anneal_sample_cap=args.s,
            segment_size=50)
        wall = time.perf_counter() - t0
        final = _angle_deg(res.log_rot, r_true)
        best = _angle_deg(res.best_log_rot, r_true)
        per_iter = res.runtimes["per_iter"][0]
        rec["modes"][mode] = {
            "init_angle_deg": init_angle, "final_angle_deg": final,
            "best_iterate_angle_deg": best,
            "loss_first": float(res.losses[0]),
            "loss_last": float(res.losses[-1]),
            "loss_min": float(res.losses.min()), "wall_s": wall,
            "per_iter_s": per_iter, "steps_per_s": 1.0 / max(per_iter, 1e-9),
            "capacity": capacity,
            "max_tile_candidates_by_segment": [
                c["max_tile_candidates"] for c in res.capacity]}
        m = rec["modes"][mode]
        print(f"[{mode}] {init_angle:.2f} deg -> final {final:.2f} deg "
              f"(best {best:.2f}), loss {m['loss_first']:.4f} -> "
              f"{m['loss_last']:.4f}, {wall:.0f} s wall", file=sys.stderr)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()
