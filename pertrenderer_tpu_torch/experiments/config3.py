"""BASELINE config 3: the textured cow, joint camera pose and vertex
texture at 256^2 (PyTorch port of ``tools/run_config3.py``).

    python -m pertrenderer_tpu_torch.experiments.config3 [--iters 400]
        [--image 256] [--views 2] [--schedule 64,128,256]
        [--out results/config3.json] [--device cuda]

"Pose" is each view's camera (elevation and azimuth, differentiable
through ``look_at_view_transform``) and "texture" the per-vertex colours
shared by every view: the two parameter groups of the scene-parameter
loop (``harness.optimize_scene_params``).  The target is the hard Phong
render of the cow (``make_cow``: 5120 faces, its spotted UV texture) from
the true cameras (elev 30, azim 120 + 360 k / views, dist 6.7); the loop
starts from a white texture and every camera offset by (``--elev0`` - 30,
``--azim0`` - 120) degrees.  The cow streams (F > K): each step is one
launch of K7 over the views, plus the mesh Laplacian's segment sums
(K9a / K9b).

The schedule is the JAX script's.  Phase 1 (``--warmup-iters``) fits the
texture at the start cameras.  Phase 2 (``--alternate`` blocks) refits the
texture at frozen cameras, then moves the cameras (their Adam group at
``--cam-lr-scale`` times the learning rate) with the texture frozen,
dividing sigma and gamma by ``--adapt-sigma`` / ``--adapt-gamma`` from
the second block on; with ``--schedule`` the blocks run at the first
(coarsest) size and ``--refine-blocks`` more at each finer one.  A final
texture refit (``--final-tex-iters``, else ``--tex-iters``) ends it.
``--alternate 0`` runs one joint phase instead.  As in the JAX package's
loop, a block that does not train the texture renders the mesh with its
own (true) UV texture.

The JSON record (camera errors per view, texture MAE against the UV map
sampled at each vertex, losses, steps per second, the wall time and the
device) lands in ``--out``, by default under ``results/`` at the
repository root (which git ignores); the script refuses to write over the
JAX run's ``artifacts/config3.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.experiments import harness
from pertrenderer_tpu_torch.utils import artifacts

__all__ = ["build_parser", "cow", "true_vertex_colours", "renderer",
           "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_JAX_ARTIFACT = os.path.join(_ROOT, "artifacts", "config3.json")
TEX = {"camera": False, "textures": True, "vertices": False, "light": False}
CAM = {"camera": True, "textures": False, "vertices": False, "light": False}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--image", type=int, default=256)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--elev0", type=float, default=20.0)
    ap.add_argument("--azim0", type=float, default=100.0)
    ap.add_argument("--sigma0", type=float, default=3e-3)
    ap.add_argument("--gamma0", type=float, default=3e-2)
    ap.add_argument("--adapt-sigma", type=float, default=1.35)
    ap.add_argument("--adapt-gamma", type=float, default=1.35)
    ap.add_argument("--anneal-start", type=int, default=100)
    ap.add_argument("--segment", type=int, default=50)
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--warmup-iters", type=int, default=60)
    ap.add_argument("--alternate", type=int, default=4,
                    help="texture/camera alternation blocks (0: one joint "
                         "phase 2)")
    ap.add_argument("--tex-iters", type=int, default=50)
    ap.add_argument("--cam-iters", type=int, default=50)
    ap.add_argument("--tex-smooth", type=float, default=0.0,
                    help="weight of the vertex colours' Laplacian")
    ap.add_argument("--cam-lr-scale", type=float, default=5.0)
    ap.add_argument("--tex-lr-scale", type=float, default=1.0)
    ap.add_argument("--lr-decay", type=float, default=1.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--schedule", default="",
                    help="comma list of image sizes, coarse to fine (empty: "
                         "one stage at --image)")
    ap.add_argument("--refine-blocks", type=int, default=3)
    ap.add_argument("--final-tex-iters", type=int, default=0,
                    help="final texture refit iterations (0: --tex-iters)")
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(_ROOT, "results",
                                                  "config3.json"))
    return ap


def cow(device):
    """The cow centred on its vertex mean and scaled to 3 / max |v|."""
    return harness.normalize_mesh(ptt.make_cow(device=device), 3.0)


def true_vertex_colours(mesh) -> np.ndarray:
    """(V, 3) the UV map sampled (nearest texel) at each vertex's UV: the
    vertex-resolution projection of the true texture."""
    tex = mesh.textures
    maps = tex.maps[0].cpu().numpy()
    uvs = tex.verts_uvs[0].cpu().numpy()
    hh, ww = maps.shape[:2]
    px = np.clip(uvs[:, 0] * (ww - 1), 0, ww - 1)
    py = np.clip((1.0 - uvs[:, 1]) * (hh - 1), 0, hh - 1)
    return maps[py.astype(int), px.astype(int)]


def renderer(lights, image, sigma, gamma, samples=8, k=50, device="cuda"):
    """The loop's renderer: no cameras (the loop passes them), GaussianRast
    + GaussianAgg at ``samples``, blur from sigma, ``k`` faces a pixel."""
    sr, sa = harness.make_smoothers("gaussian", sigma, gamma, 1.0, samples)
    settings = ptt.RasterizationSettings(
        image_size=image, blur_radius=harness._BLUR_CONST * sigma,
        faces_per_pixel=k, perspective_correct=False)
    return ptt.MeshRenderer(
        ptt.MeshRasterizer(None, settings),
        ptt.RandomPhongShader.create(
            lights=lights, smoothrast=sr, smoothagg=sa,
            blend_params=ptt.BlendParams(sigma, gamma, (0.0, 0.0, 0.0)),
            device=device))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(_JAX_ARTIFACT):
        raise SystemExit(f"--out {args.out} is the JAX run's record; name "
                         "another path")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "kernels' plain versions on the CPU")

    mesh = cow(dev)
    nv = max(1, args.views)
    true_elev = torch.full((nv,), 30.0, device=dev)
    true_azim = (120.0 + (360.0 / nv) * torch.arange(nv, device=dev)
                 if nv > 1 else torch.full((1,), 120.0, device=dev))
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), batch=nv,
                                    device=dev)
    r, t = ptt.look_at_view_transform(dist=6.7, elev=true_elev,
                                      azim=true_azim, device=dev)
    cam_true = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=dev)
    mesh_n = mesh.extend(nv)
    stages = [int(s) for s in args.schedule.split(",") if s] or [args.image]
    imsize = stages[-1]
    with torch.no_grad():
        target = harness.get_hard_rendering(mesh_n, cam_true, lights,
                                            stages[0])[..., :3]

    d_elev, d_azim = args.elev0 - 30.0, args.azim0 - 120.0
    elev0, azim0 = true_elev + d_elev, true_azim + d_azim
    n_verts = mesh.max_verts
    sigma, gamma = args.sigma0, args.gamma0
    rend = renderer(lights, stages[0], sigma, gamma, args.samples, args.k,
                    dev)

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    vrgb0 = torch.ones(1, n_verts, 3, device=dev)
    lloc = torch.tensor([[0.0, 2.0, -2.0]], device=dev)
    zdef = torch.zeros(n_verts, 3, device=dev)
    warmup_losses = np.zeros(0)
    total_iters = args.iters + args.warmup_iters
    if args.warmup_iters > 0:
        _, ph1, warmup_losses = harness.optimize_scene_params(
            mesh_n, elev0, azim0, lloc, zdef, vrgb0, rend, [target],
            generator=seeded(args.seed + 1), lr_init=args.lr,
            Niter=args.warmup_iters, adapt_reg=False,
            segment_size=min(args.segment, args.warmup_iters),
            texture_smoothing_weight=args.tex_smooth, param_to_check=TEX)
        vrgb0 = ph1["verts_rgb"]

    if args.alternate > 0:
        losses_acc = []
        sig_b, gam_b = sigma, gamma
        elev_b, azim_b = elev0, azim0
        total_iters = args.warmup_iters
        first_block = True
        for si, ims in enumerate(stages):
            n_blocks = args.alternate if si == 0 else args.refine_blocks
            if si > 0:
                with torch.no_grad():
                    target = harness.get_hard_rendering(
                        mesh_n, cam_true, lights, ims)[..., :3]
            for b in range(n_blocks):
                if not first_block:
                    sig_b /= args.adapt_sigma
                    gam_b /= args.adapt_gamma
                first_block = False
                rend = renderer(lights, ims, sig_b, gam_b, args.samples,
                                args.k, dev)
                _, ph_t, ls_t = harness.optimize_scene_params(
                    mesh_n, elev_b, azim_b, lloc, zdef, vrgb0, rend,
                    [target], generator=seeded(args.seed + 101 + 50 * si + b),
                    lr_init=args.lr, Niter=args.tex_iters, adapt_reg=False,
                    segment_size=args.tex_iters, param_to_check=TEX,
                    texture_smoothing_weight=args.tex_smooth)
                vrgb0 = ph_t["verts_rgb"]
                best_c, _ph_c, ls_c = harness.optimize_scene_params(
                    mesh_n, elev_b, azim_b, lloc, zdef, vrgb0, rend,
                    [target], generator=seeded(args.seed + 201 + 50 * si + b),
                    lr_init=args.lr, Niter=args.cam_iters, adapt_reg=False,
                    segment_size=args.cam_iters, param_to_check=CAM,
                    lr_scales={"camera_elev": args.cam_lr_scale,
                               "camera_azim": args.cam_lr_scale})
                # The camera phase's best iterate, scored at the frozen
                # texture.
                elev_b, azim_b = best_c["camera_elev"], best_c["camera_azim"]
                losses_acc.extend([ls_t, ls_c])
                total_iters += args.tex_iters + args.cam_iters
                print(f"stage {ims} block {b}: sigma={sig_b:.2e} "
                      f"elev_err={float((elev_b - true_elev).abs().max()):.2f}"
                      f" azim_err={float((azim_b - true_azim).abs().max()):.2f}"
                      f" loss={float(ls_c[-1]):.5f}", file=sys.stderr,
                      flush=True)
        n_final = args.final_tex_iters or args.tex_iters
        best, _final, ls_f = harness.optimize_scene_params(
            mesh_n, elev_b, azim_b, lloc, zdef, vrgb0, rend, [target],
            generator=seeded(args.seed + 999), lr_init=args.lr,
            Niter=n_final, adapt_reg=False, segment_size=n_final,
            param_to_check=TEX, texture_smoothing_weight=args.tex_smooth)
        losses_acc.append(ls_f)
        total_iters += n_final
        losses = np.concatenate(losses_acc)
        best = dict(best, camera_elev=elev_b, camera_azim=azim_b)
    else:
        if len(stages) != 1:
            raise SystemExit("--schedule requires --alternate > 0")
        best, _final, losses = harness.optimize_scene_params(
            mesh_n, elev0, azim0, lloc, zdef, vrgb0, rend, [target],
            generator=seeded(args.seed), lr_init=args.lr, Niter=args.iters,
            adapt_reg=True, adapt_params=(args.adapt_sigma, args.adapt_gamma),
            anneal_start=args.anneal_start, segment_size=args.segment,
            lr_decay=args.lr_decay,
            param_to_check={"camera": True, "textures": True,
                            "vertices": False, "light": False},
            texture_smoothing_weight=args.tex_smooth,
            lr_scales={"camera_elev": args.cam_lr_scale,
                       "camera_azim": args.cam_lr_scale,
                       "verts_rgb": args.tex_lr_scale})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    elev_err = (best["camera_elev"] - true_elev).abs().cpu().numpy()
    azim_err = (best["camera_azim"] - true_azim).abs().cpu().numpy()
    true_vrgb = true_vertex_colours(mesh)
    best_vrgb = np.clip(best["verts_rgb"][0].cpu().numpy(), 0.0, 1.0)
    rec = {
        "config": "BASELINE config 3: cow-class mesh (5120 faces, UV "
                  "target), joint camera-pose + vertex-texture, "
                  f"{imsize}^2, sigma/gamma annealing, {nv} view(s), "
                  "shared texture",
        "iters_total": int(total_iters),
        "warmup_iters": args.warmup_iters,
        "alternate_blocks": args.alternate,
        "views": nv,
        "warmup_loss_first": (float(warmup_losses[0])
                              if len(warmup_losses) else None),
        "loss_first": float(losses[0]) if len(losses) else None,
        "loss_last": float(losses[-1]) if len(losses) else None,
        "loss_best": float(np.min(losses)) if len(losses) else None,
        "camera_err_deg_init": [abs(d_elev), abs(d_azim)],
        "camera_err_deg_final": {
            "elev_per_view": [float(x) for x in elev_err],
            "azim_per_view": [float(x) for x in azim_err],
            "max": float(max(elev_err.max(), azim_err.max()))},
        "texture_mae_vs_true_init": float(np.abs(1.0 - true_vrgb).mean()),
        "texture_mae_vs_true_best": float(np.abs(best_vrgb
                                                 - true_vrgb).mean()),
        "recipe": {"sigma0": args.sigma0, "gamma0": args.gamma0,
                   "adapt": [args.adapt_sigma, args.adapt_gamma],
                   "anneal_start": args.anneal_start,
                   "segment": args.segment, "samples": args.samples,
                   "lr": args.lr, "lr_decay": args.lr_decay,
                   "cam_lr_scale": args.cam_lr_scale,
                   "tex_lr_scale": args.tex_lr_scale, "seed": args.seed,
                   "warmup_iters": args.warmup_iters,
                   "alternate": args.alternate,
                   "tex_iters": args.tex_iters,
                   "cam_iters": args.cam_iters, "schedule": stages,
                   "refine_blocks": args.refine_blocks,
                   "final_tex_iters": args.final_tex_iters,
                   "tex_smooth": args.tex_smooth},
        "wall_seconds_total": wall,
        "steps_per_sec": total_iters / wall,
        "renders_per_sec": total_iters * nv / wall,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))

    # Targets over the final renders, one column per view (needs
    # matplotlib).
    r2, t2 = ptt.look_at_view_transform(dist=6.7, elev=best["camera_elev"],
                                        azim=best["camera_azim"], device=dev)
    cam_f = ptt.PerspectiveCameras.create(R=r2, T=t2, device=dev)
    mesh_f = mesh_n.with_textures(ptt.TexturesVertex(torch.clamp(
        best["verts_rgb"], 0.0, 1.0).expand(nv, n_verts, 3)))
    with torch.no_grad():
        final_imgs = rend(mesh_f, generator=seeded(7), cameras=cam_f,
                          lights=lights)[..., :3]
    grid = np.concatenate([target.cpu().numpy(), final_imgs.cpu().numpy()])
    outdir = os.path.dirname(os.path.abspath(args.out))
    path = artifacts.image_grid(grid, outdir, rows=2, cols=nv)
    if path:
        os.replace(path, os.path.join(outdir, "config3_views.png"))
    return rec


if __name__ == "__main__":
    main()
