"""At-scale correctness oracle for BASELINE config 5 (the port of
``tools/oracle_config5.py``): the fused stream and binned routes held
against the staged route run strip by strip.

    python -m pertrenderer_tpu_torch.experiments.oracle_config5 \
        [--image 512] [--k 150] [--k-exact 800] [--level 6] [--rc 32] \
        [--strips 3] [--no-full-staged] [--out results/oracle_config5.json]

The scene is the JAX script's: the level-6 icosphere (81,920 faces)
scaled x3 with vertex colours 0.5 + 0.5 |v|, camera dist 6.7 elev 30 azim
120 fov 60, a point light at (0, 2, -2), 512^2, K=150, RandomPhongShader
with the deterministic softras pair (SoftRast + SoftAgg, sigma 1e-3,
gamma 1e-2) and the blur from sigma.  The strip oracle
(``ops.rasterize.rasterize_planar_rows``) selects flat and chunked, every
face at every pixel of the strip, so it is independent of both fused
routes' selection.

1. A count pass (no top-K, no fragments) finds the most candidate faces
   at any pixel of the checked strips (``--rc`` rows at H/4, H/2 - rc/2
   and 5H/8; ``--strips`` takes the first of these) and fixes K_exact
   above it, a multiple of 8.
2. The K ladder: the strips rendered staged at K = ``--k`` (the
   reference's truncated top-K) and at K_exact in blocks of 8 rows, so
   that the (P, K) fragments fit; the K_exact rung must not saturate.
3. Each fused route's forward against both rungs, strip by strip: the
   stream route (the default) is untruncated and must match K_exact to
   float scale; the binned route (``bin_overflow='allow'``, 160 slots a
   tile) is an approximation whose error this measures.
4. The dual-path pose gradient: ``render_loss`` (K7 / K12's loss-and-grad)
   against render forward + backward with the L2 in autograd, at a
   target rendered 1.5 degrees off (``OFFSET``).
5. Central differences of the same loss at h in {0.003, 0.01}: a sanity
   row, not a float oracle (at sigma 1e-3 the image also moves through
   discrete candidate-set flips that no soft rasterizer differentiates).
6. The strip gradient: each route's pose gradient of the mean square of
   its own render on 8 rows at H/2 - rc/2, against the K_exact staged
   oracle differentiating the same functional of its own render.
7. The binned route's capacity (``capacity_stats``) and the warning its
   'warn' policy gives (``check_capacity_host``).

With ``--full-staged`` (the default on the card) the script also renders
the whole image through the staged route (binned selection) at K = ``--k``
with its gradient, and records whether it fits the device, its peak
memory and its error against the K = ``--k`` strips.  The JSON record
goes to ``--out`` (by default under ``results/``, which git ignores).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.experiments import config5
from pertrenderer_tpu_torch.ops import binned
from pertrenderer_tpu_torch.ops.rasterize import (_face_pixel_geometry,
                                                  _face_validity,
                                                  _pixel_grid,
                                                  rasterize_planar_rows)

__all__ = ["OFFSET", "count_candidates", "strip_oracle", "main"]

SIGMA, GAMMA = 1e-3, 1e-2
OFFSET = (0.02, -0.015, 0.01)       # the self-target's pose, ~1.5 degrees
COUNT_CHUNK = 2048                  # faces per step of the count pass
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rotated(mesh, log_rot):
    rot = ptt.so3_exp_map(log_rot)
    return mesh.update_padded(ptt.Rotate(rot).transform_points(
        mesh.verts_padded()))


@torch.no_grad()
def count_candidates(mesh, cameras, settings, r0: int, rc: int) -> int:
    """The most candidate faces at any pixel of rows [r0, r0 + rc): the
    selection's candidate test (inside or within the blur of an edge, in
    front of the camera, not degenerate, a valid face) summed over every
    face in chunks, with no top-K."""
    verts_ndc = cameras.transform_points_ndc(mesh.verts)
    fv, valid = _face_validity(verts_ndc, mesh.faces, mesh.num_faces,
                               settings.cull_backfaces)
    fv, valid = fv[0], valid[0]
    h = settings.image_size
    xs, ys = _pixel_grid(h, h, fv.device)
    py, px = torch.meshgrid(ys[r0:r0 + rc], xs, indexing="ij")
    px, py = px.reshape(1, -1), py.reshape(1, -1)
    acc = torch.zeros(px.shape[1], dtype=torch.int64, device=fv.device)
    for c0 in range(0, fv.shape[0], COUNT_CHUNK):
        blk = fv[c0:c0 + COUNT_CHUNK]
        coords = [blk[:, a, j, None] for a in range(3) for j in range(3)]
        _, _, _, z, dist, inside, degen = _face_pixel_geometry(
            px, py, *coords, settings.resolve_clip(),
            settings.perspective_correct)
        cand = ((inside | (dist <= settings.blur_radius)) & ~degen
                & (z > 0) & valid[c0:c0 + COUNT_CHUNK, None])
        acc += cand.sum(dim=0)
    return int(acc.max().item())


@torch.no_grad()
def strip_oracle(mesh, cameras, settings, shader, seeds, k: int, r0: int,
                 rc: int, rc_block: int):
    """(image (1, rc, W, 4), the most filled slots at a pixel) of rows
    [r0, r0 + rc) rendered staged at K = k, ``rc_block`` rows at a time."""
    st = dataclasses.replace(settings, faces_per_pixel=k)
    blocks, worst = [], 0
    for b0 in range(r0, r0 + rc, rc_block):
        frag = rasterize_planar_rows(mesh, cameras, st, b0, rc_block)
        worst = max(worst, int((frag.pix_to_face >= 0).sum(-1).max()))
        blocks.append(shader(frag, mesh, seeds=seeds, cameras=cameras))
    return torch.cat(blocks, dim=1), worst


def _grad(fn, log_rot):
    lr = log_rot.detach().clone().requires_grad_(True)
    fn(lr).backward()
    return lr.grad.detach().cpu().numpy().astype(np.float64).reshape(-1)


def _full_staged(mesh, cameras, rr, seeds, oracle_k, strip_starts, rc, dev):
    """The whole image through the staged route at K = --k, forward and
    the pose gradient: whether it fits, its peak memory and its error
    against the K = --k strip oracle."""
    lr = torch.zeros(1, 3, device=dev, requires_grad=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        pred = rotated(mesh, lr)
        frag = rr.rasterizer.planar(pred)
        img = rr.shader(frag, pred, seeds=seeds, cameras=cameras)
        torch.mean(img[..., :3] ** 2).backward()
        _sync(dev)
    except torch.cuda.OutOfMemoryError as e:
        rec = {"fits": False, "error": str(e).splitlines()[0]}
    else:
        errs = {str(r0): float((img[:, r0:r0 + rc].detach()
                                - oracle_k[r0]).abs().max())
                for r0 in strip_starts}
        rec = {"fits": True, "max_abs_err_vs_strip_oracle": errs,
               "pose_grad": lr.grad.tolist(),
               "finite": bool(torch.isfinite(img).all()
                              and torch.isfinite(lr.grad).all())}
    rec["seconds"] = time.perf_counter() - t0
    if dev.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        rec["device_gib"] = (torch.cuda.get_device_properties(dev)
                             .total_memory / 2 ** 30)
    del lr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _step_ms(rr, mesh, seeds, cameras, lights, imsize, dev, reps=4):
    """Milliseconds of one loss-and-gradient step (render_loss and its
    backward to the pose), synchronised host clock over ``reps`` steps."""
    zero_t = torch.zeros(1, imsize, imsize, 3, device=dev)
    lr = torch.zeros(1, 3, device=dev, requires_grad=True)

    def step():
        lr.grad = None
        rr.render_loss(rotated(mesh, lr), zero_t, seeds=seeds,
                       cameras=cameras, lights=lights).backward()

    step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    _sync(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image", type=int, default=512)
    ap.add_argument("--k", type=int, default=150)
    ap.add_argument("--k-exact", type=int, default=800,
                    help="the exact rung's K if the count pass finds "
                         "fewer candidates (it is raised above the count)")
    ap.add_argument("--level", type=int, default=6)   # 81,920 faces
    ap.add_argument("--rc", type=int, default=32)     # strip rows
    ap.add_argument("--strips", type=int, default=3, choices=(1, 2, 3))
    ap.add_argument("--full-staged", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(_ROOT, "results",
                                                  "oracle_config5.json"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    log = lambda msg: print(msg, file=sys.stderr, flush=True)

    imsize, k = args.image, args.k
    mesh = config5.icosphere_mesh(args.level, "oracle", dev)
    cameras, lights = config5.scene(dev)
    blur = float(np.log(1.0 / 1e-4 - 1.0) * SIGMA)
    renderers = {"stream": config5.renderer(
        cameras, lights, "softras", SIGMA, GAMMA, image=imsize, k=k,
        bin_overflow="warn", blur=blur, device=dev)}
    if imsize > 128:
        renderers["binned"] = config5.renderer(
            cameras, lights, "softras", SIGMA, GAMMA, image=imsize, k=k,
            bin_overflow="allow", blur=blur, device=dev)
    for name, rr in renderers.items():
        plan = rr.plan(mesh)
        if plan.mode != name:
            raise RuntimeError(f"{name}: the scene routes {plan.mode} "
                               f"({plan.reason})")
    settings = dataclasses.replace(
        renderers["stream"].rasterizer.raster_settings)
    shader = renderers["stream"].shader
    seeds = torch.zeros(1, 4, dtype=torch.int32)  # softras draws no noise

    h, rc = imsize, args.rc
    strip_starts = [h // 4, h // 2 - rc // 2, 5 * h // 8][:args.strips]
    r0_mid = h // 2 - rc // 2
    t0 = time.perf_counter()
    count_max = max(count_candidates(mesh, cameras, settings, r0, rc)
                    for r0 in strip_starts)
    k_exact = max(args.k_exact, -(-(count_max + 1) // 8) * 8)
    count_s = time.perf_counter() - t0
    log(f"count pass: at most {count_max} candidates at a pixel of the "
        f"strips -> K_exact = {k_exact} ({count_s:.1f} s)")

    oracle_ladder, ladder_info = {}, []
    for k_o, rc_blk in ((k, rc), (k_exact, 8)):
        imgs, worst = {}, 0
        t0 = time.perf_counter()
        for r0 in strip_starts:
            imgs[r0], w = strip_oracle(mesh, cameras, settings, shader,
                                       seeds, k_o, r0, rc, min(rc_blk, rc))
            worst = max(worst, w)
        _sync(dev)
        ladder_info.append({"k": k_o, "rc_block": min(rc_blk, rc),
                            "max_valid_slots": worst,
                            "saturated": worst >= k_o,
                            "seconds": time.perf_counter() - t0})
        oracle_ladder[k_o] = imgs
        log(f"oracle K={k_o} (rows {min(rc_blk, rc)} a block): at most "
            f"{worst} filled slots ({'SATURATED' if worst >= k_o else
                                     'untruncated'}), "
            f"{ladder_info[-1]['seconds']:.1f} s")
    if ladder_info[-1]["saturated"]:
        raise RuntimeError("the count pass under-estimated K_exact")

    nf = int(mesh.num_faces[0])
    rec = {
        "config": f"BASELINE config 5 oracle: icosphere level {args.level} "
                  f"({nf} faces), {imsize}^2, K={k}, softras member, fused "
                  "routes vs the flat strip oracle's K ladder (stream = the "
                  "default exact route; binned = the bin_overflow='allow' "
                  "approximation)",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "strips": strip_starts, "rows_per_strip": rc,
        "count_max": count_max, "count_seconds": count_s,
        "oracle_k_ladder": ladder_info, "grad_oracle_k": k_exact,
        "modes": {},
    }
    if args.full_staged:
        fs = _full_staged(mesh, cameras, renderers["stream"], seeds,
                          oracle_ladder[k], strip_starts, rc, dev)
        rec["full_staged"] = fs
        log(f"full staged route at K={k}: {json.dumps(fs)}")

    offset = torch.tensor([OFFSET], device=dev)
    log_rot = torch.zeros(1, 3, device=dev)
    rc_g = 8
    settings_g = dataclasses.replace(settings, faces_per_pixel=k_exact)
    for name, rr in renderers.items():
        capacity = None
        if name == "binned":
            st = rr.rasterizer.raster_settings
            stats = binned.capacity_stats(mesh, cameras, st,
                                          rr.shader.smoothrast,
                                          rr.shader.smoothagg, lights)
            msg = binned.check_capacity_host(
                dataclasses.replace(st, bin_overflow="warn"), stats)
            log(f"[binned] capacity: {msg}")
            capacity = dict(stats, warning=msg)
        t0 = time.perf_counter()
        with torch.no_grad():
            img_fused = rr(mesh, seeds=seeds)
        _sync(dev)
        log(f"[{name}] render {time.perf_counter() - t0:.2f} s, coverage "
            f"{float((img_fused[..., 3] > 0).float().mean()):.3f}")
        fwd_errs = {}
        for k_o, imgs in oracle_ladder.items():
            fwd_errs[str(k_o)] = {
                str(r0): float((img_fused[:, r0:r0 + rc] - imgs[r0])
                               .abs().max()) for r0 in strip_starts}
            log(f"[{name}] max |fused - oracle(K={k_o})| by strip: "
                f"{fwd_errs[str(k_o)]}")

        def render_mode(lr_, rr=rr):
            return rr(rotated(mesh, lr_), seeds=seeds, cameras=cameras,
                      lights=lights)[..., :3]

        with torch.no_grad():
            target = render_mode(offset)

        def loss_one(lr_, rr=rr):
            return rr.render_loss(rotated(mesh, lr_), target, seeds=seeds,
                                  cameras=cameras, lights=lights)

        g_one = _grad(loss_one, log_rot)
        g_two = _grad(lambda lr_: torch.mean((render_mode(lr_) - target)
                                             ** 2), log_rot)
        g_norm = max(float(np.linalg.norm(g_one)), 1e-30)
        rel_dual = float(np.linalg.norm(g_two - g_one) / g_norm)
        log(f"[{name}] pose grad dual path (render_loss vs render + "
            f"autograd L2): one {g_one.tolist()}, two {g_two.tolist()}, "
            f"rel err {rel_dual:.3e}")

        fd_checks = {"dual_path_rel_err": rel_dual}
        for hh in (3e-3, 1e-2):
            fd = np.zeros(3)
            with torch.no_grad():
                for i in range(3):
                    e = torch.zeros(1, 3, device=dev)
                    e[0, i] = hh
                    fd[i] = (float(loss_one(log_rot + e))
                             - float(loss_one(log_rot - e))) / (2.0 * hh)
            rel_fd = float(np.linalg.norm(fd - g_one) / g_norm)
            cos = float(np.dot(fd, g_one)
                        / max(np.linalg.norm(fd) * g_norm, 1e-30))
            fd_checks[f"{hh:g}"] = {"fd_grad": fd.tolist(),
                                    "rel_err_l2": rel_fd, "cosine": cos}
            log(f"[{name}] pose grad vs central FD (h={hh:g}): fd "
                f"{fd.tolist()}, l2 rel err {rel_fd:.3e}, cos {cos:.4f}")

        def strip_loss_fused(lr_, rr=rr):
            img = rr(rotated(mesh, lr_), seeds=seeds, cameras=cameras,
                     lights=lights)
            return torch.mean(img[:, r0_mid:r0_mid + rc_g, :, :3] ** 2)

        def strip_loss_oracle(lr_):
            pred = rotated(mesh, lr_)
            frag = rasterize_planar_rows(pred, cameras, settings_g, r0_mid,
                                         rc_g)
            img = shader(frag, pred, seeds=seeds, cameras=cameras)
            return torch.mean(img[..., :3] ** 2)

        g_fused = _grad(strip_loss_fused, log_rot)
        g_strip = _grad(strip_loss_oracle, log_rot)
        rel = float(np.abs(g_fused - g_strip).max()
                    / max(np.abs(g_strip).max(), 1e-30))
        log(f"[{name}] pose grad strip parity (own-render strip loss, "
            f"oracle K={k_exact}): fused {g_fused.tolist()}, oracle "
            f"{g_strip.tolist()}, rel err {rel:.3e}")

        ms = _step_ms(rr, mesh, seeds, cameras, lights, imsize, dev)
        log(f"[{name}] loss + grad step: {ms:.2f} ms ({1e3 / ms:.3f} "
            "renders/s)")
        rec["modes"][name] = {
            "forward_max_abs_err_by_oracle_k": fwd_errs,
            "pose_grad_dual_path_rel_err": rel_dual,
            "pose_grad_vs_fd_by_h": fd_checks,
            "pose_grad_strip_parity_rel_err": rel,
            "pose_grad_strip": {"fused": g_fused.tolist(),
                                "oracle": g_strip.tolist()},
            "step_ms": ms, "renders_per_s": 1e3 / ms,
            "capacity": capacity,
        }

    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()
