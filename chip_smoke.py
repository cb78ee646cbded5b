"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

The headline configuration throughout: the cube x2 (flat route) or the
cow (stream route), 256^2, K=50, S=8, GaussianRast + GaussianAgg (sigma
1e-3, gamma 1e-2), point light (0, 2, -2), camera dist 6.7 elev 30 azim
120.  Phases (each prints one
line; any failure exits non-zero before a result is printed):

1. device — the card must be CUDA capability 9.0 (Hopper); builds the
   kernels from csrc/ with nvcc (one process per source) and reports the
   build time;
2. K1 — the hash-PRNG probe against tests/goldens/prng_goldens.npz
   (uniform bit-exact, gaussian 5e-4 abs, cauchy 1e-5 rel) and against its
   plain PyTorch version on the card;
3. K3 — the fused forward against its plain version, N=4 random poses.
   MC tolerance: mean |d| <= 1e-5 and >= 99.9% of pixels within 1e-4; the
   deterministic softras pair at atol 2e-5;
4. K4 — the fused backward against its plain version (torch autograd
   through the plain forward) for a seeded random cotangent, N=4, gaussian
   and softras.  Each gradient table, and each of the 34 scalar gradients
   on its own, within 1e-3 (MC: shared noise, threshold flips only) or
   1e-4 (softras) of its max |grad|, and the same bits on a second launch;
5. K2 — the fused loss-and-grad against its plain version (loss rtol
   1e-5, tables as K4), and the dual path: K2 equals K3 + K4 fed the L2
   cotangent (tables and scalars within 1e-5 of their max);
6. serve — 8 render requests of N=4 poses through MeshRenderer;
7. render-grad — 4 requests that render N=4 poses through MeshRenderer
   and take the gradient of an image objective with respect to the poses;
8. train — optimize_pose for 30 steps at N=1 from 20 degrees off the true
   pose, lr 5e-2, against the port's own render of the true pose through
   the flat HardRast + HardAgg pair; its first step must equal the same
   step on the CPU through the plain versions (loss rtol 1e-4, pose
   gradient within 1e-3 of its max).

9. K5 — the stream forward on the config-3 cow (5120 faces, centred and
   scaled to 3 / max |v|) at 256^2, N=4, against its plain version at
   full width (tolerances as K3), repeated launches bit-equal;
10. K6 / K7 — the stream backward (N=4) and loss-and-grad (N=1) of the
   gaussian pair against their plain versions on the cow at 256^2 (each
   row within 1e-3 of its table's max, each scalar within 1e-3 of its
   own max, of the float32 plain version or of the plain version
   evaluated in float64; the rows of faces too thin for float32 to
   resolve that, height under 2e-3 of their longest edge, within 2e-6 /
   (height / edge)), repeated launches bit-equal, and K7 = K5 + K6 at
   N=4 (1e-5 of each table's max);
11. serve-stream — 8 render requests of N=4 cow poses through
   MeshRenderer;
12. render-grad-stream — 4 requests that render N=4 cow poses and take
   the pose gradient of an image objective;
13. train-stream — optimize_pose on the cow for 30 steps at N=1 from 20
   degrees off, against the port's render of the true pose through the
   stream HardRast + HardAgg pair (K5); its first step must equal the same
   step through K7's plain version on the card (loss rtol 1e-5, pose
   gradient within 1e-3 of its max, the thin faces' rows of phase 10 left
   out of both table gradients).

Phases 6-8 and 11-13 are the main paths: the launch counts are reset just
before each and read just after, and each must have launched its kernels
(serve: K1 and K3; render-grad: K3 and K4; train: K2 once per step;
serve-stream: K5; render-grad-stream: K5 and K6; train-stream: K7 once
per step).  Times are CUDA events except the per-request and per-step
times (host clock ending in a device synchronisation).  Kernel and plain
version are timed in turns (plain, kernel, kernel, plain) after a warm-up
call.

The last lines are the per-kernel report (one JSON object), the card's
nvidia-smi name and power limit, then {"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch import _build, checks
from pertrenderer_tpu_torch.checks import tables_close
from pertrenderer_tpu_torch.experiments import harness
from pertrenderer_tpu_torch.ops import fused_render as fr

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "tests", "goldens", "prng_goldens.npz")
N_POSES, N_REQUESTS, IMAGE, K, S = 4, 8, 256, 50, 8
SIGMA, GAMMA = 1e-3, 1e-2
TRAIN_STEPS, TRAIN_LR, TRAIN_OFFSET_DEG = 30, 5e-2, 20.0

# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# Float32 operations counted from csrc/ (adds, multiplies, compares,
# divisions; each log / sqrt / sin / cos / tan / exp / pow as one).  The
# integer hash is left out (the data sheet gives no integer rate outside
# the tensor cores), so the bounds are lower bounds.  Each term is counted
# over the work the function needs on this run's data (``work``), not over
# the kernels' padded loops: geometry for every real face at every pixel
# (it decides candidacy); texel, shading, coverage, z_map, blend and the
# adjoints per candidate (slot, pixel); aggregation per live z_map row
# (candidates and the background); noise only for the draws those rows use.
OPS_GEOM = 121        # per real face and pixel: edges, distances, depth
OPS_CLIP = 9          # ... clipped barycentrics
OPS_PERSP = 12        # ... perspective correction
OPS_TEXEL = {"corner": 18, "atlas": 11}   # per candidate
OPS_PHONG = 113       # per candidate: Phong shading
OPS_PAIR = 14         # per Box-Muller pair: 2 uniforms, log, sqrt, sincos
OPS_CAUCHY = 7        # per Cauchy draw: uniform, tan, clamp
OPS_COVER = 4         # per candidate and sample: perturb, test, add
OPS_COVER_BWD = 4     # ... plus the score coefficient (backward)
OPS_SOFT_COVER = 5    # per candidate: sigmoid of -d / sigma
OPS_ZMAP = 8          # per candidate: z_inv, log, scale, shift
OPS_AGG = 5           # per live row and sample: perturb, max, test
OPS_AGG_BWD = 8       # ... plus one-hot difference, dot, score, phi
OPS_SOFTMAX = 6       # per live row, forward or backward
OPS_BLEND = 8         # per candidate: weighted colour, alpha product
OPS_BG = 7            # per pixel: background blend, alpha
OPS_SLOT_BWD = 534    # per candidate: adjoints of det2, coverage, det1
OPS_CLIP_BWD = 26     # ... of the clipped barycentrics
OPS_PERSP_BWD = 41    # ... of the perspective correction
OPS_LOSS = 12         # per pixel: the image loss and its cotangent


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() on the card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel, plain, reps, plain_reps=None):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain, after one warm-up call each (``plain_reps`` calls per plain
    turn, ``reps`` by default)."""
    plain_reps = plain_reps or reps
    kernel(), plain()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def reset_counts():
    for k in fr.launch_counts:
        fr.launch_counts[k] = 0


def mc_close(got, want):
    """(ok, max |d|, mean |d|, share of pixels beyond 1e-4)."""
    d = (got - want).abs()
    flips = (d.amax(dim=-1) > 1e-4).float().mean().item()
    ok = (bool(torch.isfinite(got).all()) and d.mean().item() <= 1e-5
          and flips <= 1e-3)
    return ok, d.max().item(), d.mean().item(), flips


def bound(nbytes, ops):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and operations over the float32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pairs_used(rows):
    """Box-Muller pairs that feed at least one used row: pair h gives rows
    h and h + R/2 of an R-row block.  ``rows`` is (N, R, P) bool."""
    half = rows.shape[1] // 2
    return int((rows[:, :half] | rows[:, half:2 * half]).sum().item())


def work(cfg, ins):
    """What the function needs on these inputs, as counts: pixels, (real
    face, pixel) pairs, candidate (slot, pixel) pairs, live z_map rows
    (candidates and the background), and the operations of the noise draws
    per sample.  The MC aggregation's gamma gradient sums a term over every
    row up to bg_row; with variance reduction it is 0 at a pixel with no
    candidate (the background always wins), so the backward needs those
    rows (``grad_rows``, ``agg_draw_ops_grad``) at pixels with a candidate,
    or at every pixel without variance reduction."""
    n, c = ins[0].shape[0], cfg.c_zpad
    pixels = n * cfg.image_size ** 2
    _pos, px, py = fr._pixel_coords(cfg.image_size, ins[0].device)
    sc = lambda i: ins[5][:, i].view(n, 1, 1)
    cand = fr._det1(cfg, px, py, *ins[:5], sc)[-1] > 0     # (N, F_pad, P)
    live = torch.zeros(n, c, cand.shape[-1], dtype=torch.bool,
                       device=cand.device)
    live[:, :cfg.f_pad] = cand
    live[:, cfg.bg_row] = True
    grad_px = cand.any(dim=1) if cfg.agg_vr else torch.ones_like(cand[:, 0])
    up_to_bg = torch.arange(c, device=cand.device).view(1, c, 1) <= cfg.bg_row
    grad_live = live | (up_to_bg & grad_px[:, None, :])
    draws = lambda rows, noise: (_pairs_used(rows) * OPS_PAIR
                                 if noise == "gaussian"
                                 else int(rows.sum().item()) * OPS_CAUCHY)
    return dict(pixels=pixels, faces=pixels * cfg.f_real,
                cand=int(cand.sum().item()), live=int(live.sum().item()),
                grad_rows=int((up_to_bg & grad_px[:, None, :]).sum().item()),
                rast_draw_ops=draws(cand, cfg.rast_noise),
                agg_draw_ops=draws(live, cfg.agg_noise),
                agg_draw_ops_grad=draws(grad_live, cfg.agg_noise))


def forward_ops(cfg, w):
    """Float32 operations of the forward render on the ``work`` counts."""
    geom = OPS_GEOM + OPS_CLIP * cfg.clip_bary + (
        OPS_PERSP * cfg.perspective_correct)
    shade = OPS_TEXEL[cfg.tex_mode] + (
        OPS_PHONG if cfg.shade == "phong" else 0)
    ops = (w["faces"] * geom + w["pixels"] * OPS_BG
           + w["cand"] * (shade + OPS_ZMAP + OPS_BLEND))
    if cfg.rast_kind == "mc":
        ops += cfg.s_rast * (w["rast_draw_ops"] + w["cand"] * OPS_COVER)
    else:
        ops += w["cand"] * OPS_SOFT_COVER
    if cfg.agg_kind == "mc":
        ops += cfg.s_agg * (w["agg_draw_ops"] + w["live"] * OPS_AGG)
    elif cfg.agg_kind == "soft":
        ops += w["live"] * OPS_SOFTMAX
    return ops


def grad_ops(cfg, w, loss):
    """Float32 operations of K4 (loss=False) or K2 on the ``work`` counts:
    the forward, then the adjoints.  The noise is counted once: the
    function needs each draw once, however often a kernel replays it."""
    ops = forward_ops(cfg, w) + w["cand"] * (
        OPS_SLOT_BWD + OPS_CLIP_BWD * cfg.clip_bary
        + OPS_PERSP_BWD * cfg.perspective_correct)
    if cfg.rast_kind == "mc":
        ops += cfg.s_rast * w["cand"] * OPS_COVER_BWD
    if cfg.agg_kind == "mc":
        ops += cfg.s_agg * (w["grad_rows"] * OPS_AGG_BWD
                            + w["agg_draw_ops_grad"] - w["agg_draw_ops"])
    elif cfg.agg_kind == "soft":
        ops += w["live"] * OPS_SOFTMAX
    return ops + (w["pixels"] * OPS_LOSS if loss else 0)


def _draw_ops(rows, noise):
    """Operations of the noise draws that feed the rows marked in ``rows``
    (N, 64, Q): Box-Muller pairs (row h with row h + 32) or Cauchy
    draws."""
    if noise == "gaussian":
        return int((rows[:, :32] | rows[:, 32:]).sum().item()) * OPS_PAIR
    return int(rows.sum().item()) * OPS_CAUCHY


def stream_work(cfg, args):
    """What the stream route needs on these inputs: pixels, visited (row,
    pixel) pairs (each pixel's tile list: 64 rows per listed chunk of an
    active tile), candidate (row, pixel) pairs, and the noise operations
    per sample for the candidate rows and for every visited row (the MC
    gamma gradient sums n^2 over all of them)."""
    tab, rows, count, active, scal, _seeds = args
    n, td = tab.shape[0], cfg.tex_d
    sc = lambda i: scal[:, i].view(n, 1, 1)
    w = dict(pixels=n * cfg.image_size ** 2, visited=0, cand=0,
             rast_draw_ops=0, agg_draw_ops=0, agg_draw_ops_all=0)
    with torch.no_grad():
        for c, _sel, vis, _pos, px, py in fr._StreamPass(
                cfg, rows, count, active).chunks():
            blk = tab[:, c * 64:(c + 1) * 64]
            valid = (blk[..., 27 + td] < 1e30).float()
            cand = fr._det1(cfg, px, py, blk[..., :9], blk[..., 9:18],
                            blk[..., 18:27], blk[..., 27:27 + td], valid,
                            sc)[-1] > 0
            cand = cand & vis
            allv = vis.expand_as(cand)
            w["visited"] += int(allv.sum().item())
            w["cand"] += int(cand.sum().item())
            w["rast_draw_ops"] += _draw_ops(cand, cfg.rast_noise)
            w["agg_draw_ops"] += _draw_ops(cand, cfg.agg_noise)
            w["agg_draw_ops_all"] += _draw_ops(allv, cfg.agg_noise)
    return w


def stream_forward_ops(cfg, w):
    """Float32 operations of the stream forward on the ``stream_work``
    counts: geometry per visited pair; texel, shading, z_map, blend and
    coverage per candidate; the aggregation over the candidates and the
    background row (one draw per pixel and sample)."""
    geom = OPS_GEOM + OPS_CLIP * cfg.clip_bary + (
        OPS_PERSP * cfg.perspective_correct)
    shade = OPS_TEXEL[cfg.tex_mode] + (
        OPS_PHONG if cfg.shade == "phong" else 0)
    live = w["cand"] + w["pixels"]
    ops = (w["visited"] * geom + w["pixels"] * OPS_BG
           + w["cand"] * (shade + OPS_ZMAP + OPS_BLEND))
    if cfg.rast_kind == "mc":
        ops += cfg.s_rast * (w["rast_draw_ops"] + w["cand"] * OPS_COVER)
    else:
        ops += w["cand"] * OPS_SOFT_COVER
    if cfg.agg_kind == "mc":
        ops += cfg.s_agg * (w["agg_draw_ops"] + w["pixels"] * OPS_PAIR
                            + live * OPS_AGG)
    elif cfg.agg_kind == "soft":
        ops += live * OPS_SOFTMAX
    return ops


def stream_grad_ops(cfg, w, loss):
    """Float32 operations of K6 (loss=False) or K7: the forward, every
    visited row's draw for phi (MC aggregation), then the adjoints per
    candidate; each draw counted once."""
    ops = stream_forward_ops(cfg, w) + w["cand"] * (
        OPS_SLOT_BWD + OPS_CLIP_BWD * cfg.clip_bary
        + OPS_PERSP_BWD * cfg.perspective_correct)
    if cfg.rast_kind == "mc":
        ops += cfg.s_rast * w["cand"] * OPS_COVER_BWD
    if cfg.agg_kind == "mc":
        ops += cfg.s_agg * (w["agg_draw_ops_all"] - w["agg_draw_ops"]
                            + w["cand"] * OPS_AGG_BWD)
    elif cfg.agg_kind == "soft":
        ops += (w["cand"] + w["pixels"]) * OPS_SOFTMAX
    return ops + (w["pixels"] * OPS_LOSS if loss else 0)


def stream_bytes(args):
    """Bytes of the sorted table, the chunk lists, counts, activity bits,
    scalars and seeds."""
    return sum(t.numel() * t.element_size() for t in args)


def table_bytes(cfg, n):
    """Bytes of the face tables, validity, scalars and seeds."""
    return 4 * n * (cfg.f_pad * (27 + cfg.tex_d + 1) + 34 + 4)


def scene(device):
    r, t = ptt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0,
                                      device=device)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), device=device)
    return r, t, lights


def headline_renderer(noise, device, n=N_POSES, size=None):
    """The headline scene's renderer (cameras, light, estimators), at
    ``size``^2 (IMAGE by default)."""
    r, t, lights = scene(device)
    cams = ptt.PerspectiveCameras.create(
        R=r.expand(n, 3, 3), T=t.expand(n, 3), fov=60.0, device=device)
    if noise == "gaussian":
        sr = ptt.GaussianRast.create(sigma=SIGMA, nb_samples=S)
        sa = ptt.GaussianAgg.create(gamma=GAMMA, nb_samples=S)
    else:
        sr, sa = ptt.SoftRast.create(sigma=SIGMA), ptt.SoftAgg.create(
            gamma=GAMMA)
    settings = ptt.RasterizationSettings(
        image_size=size or IMAGE,
        blur_radius=float(np.log(1.0 / 1e-4 - 1.0) * SIGMA),
        faces_per_pixel=K)
    shader = ptt.RandomPhongShader.create(
        cameras=cams, lights=lights, smoothrast=sr, smoothagg=sa,
        blend_params=ptt.BlendParams(SIGMA, GAMMA, (0.0, 0.0, 0.0)),
        device=device)
    return ptt.MeshRenderer(ptt.MeshRasterizer(cams, settings), shader)


def cow_mesh(device):
    """The config-3 cow (``make_cow``: 2562 verts, 5120 faces, UV atlas
    4), centred and scaled to 3 / max |v| as tools/run_config3.py does."""
    cow = ptt.make_cow(device=device)
    verts = cow.verts[0]
    center = verts.mean(0)
    scale = torch.max(torch.abs(verts - center))
    return cow.offset_verts(-center.expand_as(verts)).scale_verts(
        3.0 / scale)


def posed_cow(generator, device, n=N_POSES, log_rot=None):
    """The cow at n random rotations drawn from ``generator``."""
    cow = cow_mesh(device).extend(n)
    if log_rot is None:
        log_rot = torch.randn(n, 3, generator=generator).to(device)
    rot = ptt.so3_exp_map(log_rot)
    return cow.update_padded(ptt.Rotate(rot).transform_points(cow.verts))


def stream_inputs(noise, dev, n, size=None):
    """(cfg, K5-K7 arguments) of the cow at n random poses."""
    renderer = headline_renderer(noise, dev, n, size)
    mesh = posed_cow(torch.Generator().manual_seed(0), dev, n)
    seeds = fr.draw_seeds(n, torch.Generator().manual_seed(1), device=dev)
    cfg, (tab, scal, rows, count, active, seeds) = kernel_inputs(
        renderer, mesh, seeds)
    if not cfg.stream:
        fail(f"the cow did not take the stream route: {cfg}")
    return cfg, (tab, rows, count, active, scal, seeds)


def posed_cube(generator, device, log_rot=None):
    """The cube x2 at N_POSES random rotations drawn from ``generator``."""
    cube = ptt.load_cube(device=device).scale_verts(2.0).extend(N_POSES)
    if log_rot is None:
        log_rot = torch.randn(N_POSES, 3, generator=generator).to(device)
    rot = ptt.so3_exp_map(log_rot)
    return cube.update_padded(ptt.Rotate(rot).transform_points(cube.verts))


def kernel_inputs(renderer, mesh, seeds):
    sh, settings = renderer.shader, renderer.rasterizer.raster_settings
    cfg = fr._plan(mesh, sh.lights, sh.smoothrast, sh.smoothagg, settings,
                   "phong")
    return cfg, fr._prepare_inputs(cfg, mesh, sh.cameras, sh.lights,
                                   sh.materials, sh.smoothrast, sh.smoothagg,
                                   sh.blend_params, settings, seeds, "phong")


def headline_inputs(noise, dev):
    renderer = headline_renderer(noise, dev)
    mesh = posed_cube(torch.Generator().manual_seed(0), dev)
    seeds = fr.draw_seeds(N_POSES, torch.Generator().manual_seed(1),
                          device=dev)
    return kernel_inputs(renderer, mesh, seeds)


def phase_k1(dev, smi, report):
    goldens = np.load(GOLDENS)
    k1_err = 0.0
    for nt in ("uniform", "gaussian", "cauchy"):
        got = fr.prng_probe(nt, device=dev)
        plain = fr.prng_probe_plain(nt, device=dev)
        torch.cuda.synchronize()
        g, ref = got.cpu().numpy(), goldens[nt]
        if nt == "uniform":
            ok = np.array_equal(g, ref) and torch.equal(got, plain)
            gerr = float(np.abs(g - ref).max())
        elif nt == "gaussian":
            gerr = float(np.abs(g - ref).max())
            ok = gerr <= 5e-4
        else:
            gerr = float((np.abs(g - ref)
                          / np.maximum(np.abs(ref), 1e-6)).max())
            ok = gerr <= 1e-5
        perr = (got - plain).abs().max().item()
        k1_err = max(k1_err, perr)
        if not ok or perr > 1e-5:
            fail(f"K1 {nt}: vs goldens {gerr}, vs plain {perr}")
    ms, plain_ms = timed_pair(
        lambda: fr.prng_probe("gaussian", device=dev),
        lambda: fr.prng_probe_plain("gaussian", device=dev), 50)
    # (4, 16, 256) gaussian: 4 * 8 * 256 Box-Muller pairs, 64 KB out.
    b_ms, b_by = bound(4 * 16 * 256 * 4, 4 * 8 * 256 * OPS_PAIR)
    report["prng_probe"] = dict(max_abs_err=k1_err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by)
    print(f"[K1] prng_probe: uniform bit-exact vs goldens, gaussian/cauchy "
          f"within 5e-4 abs / 1e-5 rel; max |kernel - plain| {k1_err:.3g}; "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.2e} ms "
          f"({b_by}) | {smi}", flush=True)


def phase_k3(dev, smi, report):
    for noise in ("gaussian", "softras"):
        cfg, ins = headline_inputs(noise, dev)
        got = fr.fused_forward(cfg, *ins)
        want = fr.forward_plain(cfg, *ins)
        torch.cuda.synchronize()
        if noise == "gaussian":
            ok, dmax, dmean, flips = mc_close(got, want)
        else:
            d = (got - want).abs()
            dmax, dmean, flips = d.max().item(), d.mean().item(), 0.0
            ok = bool(torch.isfinite(got).all()) and dmax <= 2e-5
        if not ok:
            fail(f"K3 {noise}: max {dmax} mean {dmean} flips {flips}")
        k_ms, p_ms = timed_pair(
            lambda: fr.fused_forward(cfg, *ins),
            lambda: fr.forward_plain(cfg, *ins), 20)
        w = work(cfg, ins)
        b_ms, b_by = bound(table_bytes(cfg, N_POSES) + 16 * w["pixels"],
                           forward_ops(cfg, w))
        if noise == "gaussian":
            report["fused_forward"] = dict(max_abs_err=dmax, ms=k_ms,
                                           plain_ms=p_ms, bound_ms=b_ms,
                                           bound_by=b_by)
        print(f"[K3] fused_forward {noise} 256^2 K=50 S=8 N=4 (f_pad "
              f"{cfg.f_pad}, c_zpad {cfg.c_zpad}): max |d| {dmax:.3g}, mean "
              f"|d| {dmean:.3g}, pixels beyond 1e-4 {flips:.3g}; "
              f"{k_ms:.4f} ms vs plain {p_ms:.4f} ms per render, bound "
              f"{b_ms:.4f} ms ({b_by}) | {smi}", flush=True)


def phase_k4(dev, smi, report):
    for noise in ("gaussian", "softras"):
        cfg, ins = headline_inputs(noise, dev)
        g_out = torch.randn(N_POSES, IMAGE, IMAGE, 4,
                            generator=torch.Generator().manual_seed(2)).to(dev)
        got = fr.fused_backward(cfg, *ins, g_out)
        again = fr.fused_backward(cfg, *ins, g_out)
        want = fr.backward_plain(cfg, *ins, g_out)
        torch.cuda.synchronize()
        tol = 1e-3 if noise == "gaussian" else 1e-4
        ok, err, where = tables_close(got, want, tol)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not ok or not same:
            fail(f"K4 {noise}: worst table error {err} at {where} "
                 f"(tolerance {tol}), repeat bit-equal {same}")
        k_ms, p_ms = timed_pair(
            lambda: fr.fused_backward(cfg, *ins, g_out),
            lambda: fr.backward_plain(cfg, *ins, g_out), 5)
        w = work(cfg, ins)
        nbytes = 2 * table_bytes(cfg, N_POSES) + 16 * w["pixels"]
        b_ms, b_by = bound(nbytes, grad_ops(cfg, w, False))
        if noise == "gaussian":
            report["fused_backward"] = dict(max_abs_err=err, ms=k_ms,
                                            plain_ms=p_ms, bound_ms=b_ms,
                                            bound_by=b_by)
        print(f"[K4] fused_backward {noise} 256^2 K=50 S=8 N=4: worst table "
              f"error {err:.3g} of max |grad| at {where} (tolerance {tol}), "
              f"repeat bit-equal; {w['cand']} candidate (slot, pixel) pairs, "
              f"{w['live']} live z_map rows; {k_ms:.4f} "
              f"ms vs plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) | "
              f"{smi}", flush=True)


def phase_k2(dev, smi, report):
    for noise in ("gaussian", "softras"):
        cfg, ins = headline_inputs(noise, dev)
        n, hw = N_POSES, IMAGE * IMAGE
        target = torch.rand(n, 3, hw,
                            generator=torch.Generator().manual_seed(3)).to(dev)
        lscale = 1.0 / (n * hw * 3)
        loss, *got = fr.fused_loss_grad(cfg, *ins, target, "l2_rgb", lscale)
        want_loss, *want = fr.loss_grad_plain(cfg, *ins, target, "l2_rgb",
                                              lscale)
        torch.cuda.synchronize()
        tol = 1e-3 if noise == "gaussian" else 1e-4
        ok, err, where = tables_close(got, want, tol)
        lerr = ((loss - want_loss).abs() / want_loss.abs()).max().item()
        if not ok or lerr > 1e-5:
            fail(f"K2 {noise}: worst table error {err} at {where} "
                 f"(tolerance {tol}), loss rel error {lerr}")
        # Dual path: K3's image, the L2 cotangent, K4.
        img = fr.fused_forward(cfg, *ins)
        d = img[..., :3].reshape(n, hw, 3).transpose(1, 2) - target
        g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(n, IMAGE, IMAGE,
                                                            3)
        g_out = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
        dual = fr.fused_backward(cfg, *ins, g_out.contiguous())
        dual_loss = torch.sum(d * d, dim=(1, 2)) * lscale
        ok, derr, dwhere = tables_close(got, dual, 1e-5)
        dlerr = ((loss - dual_loss).abs() / dual_loss.abs()).max().item()
        if not ok or dlerr > 1e-5:
            fail(f"K2 {noise} vs K3 + K4: worst table error {derr} at "
                 f"{dwhere}, loss rel error {dlerr}")
        k_ms, p_ms = timed_pair(
            lambda: fr.fused_loss_grad(cfg, *ins, target, "l2_rgb", lscale),
            lambda: fr.loss_grad_plain(cfg, *ins, target, "l2_rgb", lscale),
            5)
        w = work(cfg, ins)
        nbytes = 2 * table_bytes(cfg, n) + 12 * w["pixels"] + 4 * n
        b_ms, b_by = bound(nbytes, grad_ops(cfg, w, True))
        if noise == "gaussian":
            report["fused_loss_grad"] = dict(max_abs_err=err, ms=k_ms,
                                             plain_ms=p_ms, bound_ms=b_ms,
                                             bound_by=b_by)
        print(f"[K2] fused_loss_grad {noise} 256^2 K=50 S=8 N=4: loss rel "
              f"error {lerr:.3g}, worst table error {err:.3g} at {where} (tolerance "
              f"{tol}); vs K3 + K4 {derr:.3g}; {k_ms:.4f} ms vs plain "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) | {smi}",
              flush=True)


def phase_serve(dev, smi, report):
    gen = torch.Generator().manual_seed(2026)
    warm = headline_renderer("gaussian", dev)
    warm(posed_cube(gen, dev), generator=gen)         # build + cache warm
    torch.cuda.synchronize()
    renderer = headline_renderer("gaussian", dev)
    first_state, first_image, lat_ms, alphas = None, None, [], []
    reset_counts()
    t_all = time.perf_counter()
    for i in range(N_REQUESTS):
        t0 = time.perf_counter()
        mesh = posed_cube(gen, dev)
        state = gen.get_state()
        img = renderer(mesh, generator=gen)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first_state, first_image, first_mesh = state, img, mesh
        if tuple(img.shape) != (N_POSES, IMAGE, IMAGE, 4):
            fail(f"serve: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            fail("serve: non-finite pixels")
        alphas.append((img[..., 3] > 0.5).float().mean().item())
    total_s = time.perf_counter() - t_all
    counts = dict(fr.launch_counts)
    if counts["fused_forward"] != N_REQUESTS or counts["prng_probe"] < 1:
        fail(f"serve: launch counts {counts}")
    if not all(0.02 < a < 0.6 for a in alphas):
        fail(f"serve: coverage shares {alphas}")
    report["prng_probe"]["launches"] = counts["prng_probe"]
    report["fused_forward"]["launches"] = counts["fused_forward"]
    # The first request again on the CPU, through the plain version.
    cpu_renderer = headline_renderer("gaussian", "cpu")
    cpu_mesh = ptt.Meshes(
        verts=first_mesh.verts.cpu(), faces=first_mesh.faces.cpu(),
        num_verts=first_mesh.num_verts.cpu(),
        num_faces=first_mesh.num_faces.cpu(),
        textures=ptt.load_cube(device="cpu").textures.extend(N_POSES))
    cpu_gen = torch.Generator()
    cpu_gen.set_state(first_state)
    ok, dmax, dmean, flips = mc_close(first_image.cpu(),
                                      cpu_renderer(cpu_mesh,
                                                   generator=cpu_gen))
    if not ok:
        fail(f"serve: card vs CPU plain max {dmax} mean {dmean} "
             f"flips {flips}")
    med = statistics.median(lat_ms[1:])
    print(f"[serve] {N_REQUESTS} requests x {N_POSES} poses through "
          f"MeshRenderer: launches {counts}; coverage share alpha>0.5 "
          f"{min(alphas):.3f}-{max(alphas):.3f}; request latency median "
          f"{med:.3f} ms (after the first), "
          f"{N_REQUESTS * N_POSES / total_s:.1f} renders/s; vs CPU plain max "
          f"|d| {dmax:.3g} | {smi}", flush=True)


def phase_render_grad(dev, smi, report):
    """Gradients of an image objective through MeshRenderer: K3 forward,
    K4 backward."""
    gen = torch.Generator().manual_seed(2028)
    renderer = headline_renderer("gaussian", dev)
    weights = torch.linspace(0.0, 1.0, 4, device=dev)
    reset_counts()
    lat_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        log_rot = torch.randn(N_POSES, 3, generator=gen).to(dev)
        log_rot.requires_grad_()
        img = renderer(posed_cube(gen, dev, log_rot), generator=gen)
        (g,) = torch.autograd.grad(torch.mean(img * weights), [log_rot])
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if not (bool(torch.isfinite(g).all()) and g.abs().max() > 0):
            fail(f"render-grad: pose gradient {g}")
    counts = dict(fr.launch_counts)
    if counts["fused_forward"] != 4 or counts["fused_backward"] != 4:
        fail(f"render-grad: launch counts {counts}")
    report["fused_backward"]["launches"] = counts["fused_backward"]
    print(f"[render-grad] 4 requests x {N_POSES} poses, render + pose "
          f"gradient through MeshRenderer: launches {counts}; request "
          f"latency median {statistics.median(lat_ms[1:]):.3f} ms | {smi}",
          flush=True)


def cube_mesh(device):
    return ptt.load_cube(device=device).scale_verts(2.0)


def train_setup(device, r_true, gen_seed, make_mesh=cube_mesh):
    """(mesh, cameras, lights, renderer, log_rot_init, target) of the pose
    loop on ``device``: the headline scene (or ``make_mesh``'s) at N=1."""
    r, t, lights = scene(device)
    cams = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=device)
    mesh = make_mesh(device)
    hard = ptt.MeshRenderer(
        ptt.MeshRasterizer(cams, ptt.RasterizationSettings(
            image_size=IMAGE, blur_radius=0.0, faces_per_pixel=K)),
        ptt.RandomPhongShader.create(
            cameras=cams, lights=lights, smoothrast=ptt.HardRast.create(),
            smoothagg=ptt.HardAgg.create(),
            blend_params=ptt.BlendParams(SIGMA, GAMMA, (0.0, 0.0, 0.0)),
            device=device))
    posed = mesh.update_padded(ptt.Rotate(r_true).transform_points(
        mesh.verts))
    target = hard(posed, seeds=torch.zeros(1, 4, dtype=torch.int32))[0, ...,
                                                                      :3]
    log_rot, (renderer,) = harness.init_renderers(
        cams, lights, r_true, torch.Generator().manual_seed(gen_seed),
        pert_init_intensity=TRAIN_OFFSET_DEG, sigma=SIGMA, gamma=GAMMA,
        nb_samples=S, noise_type=("gaussian",), imsize=IMAGE,
        faces_per_pixel=K)
    return mesh, cams, lights, renderer, log_rot, target


def degrees_off(log_rot, r_true):
    return float(ptt.so3_relative_angle(ptt.so3_exp_map(log_rot), r_true)
                 .item()) * 180.0 / math.pi


def phase_train(dev, smi, report):
    r_true = ptt.random_rotations(1, torch.Generator().manual_seed(2027),
                                  device="cpu")
    mesh, cams, lights, renderer, log_rot, target = train_setup(
        dev, r_true.to(dev), 5)

    # The first step, on the card and on the CPU (plain versions).
    seeds = fr.draw_seeds(1, torch.Generator().manual_seed(7), device="cpu")
    outs = []
    for where in (dev, torch.device("cpu")):
        if where == dev:
            m, c, li, rd, tg = mesh, cams, lights, renderer, target
        else:
            m, c, li, rd, _lr, _tg = train_setup(where, r_true, 5)
            tg = target.cpu()
        st = harness.PoseState.start(log_rot.to(where))
        opt = torch.optim.Adam([st.log_rot], lr=TRAIN_LR)
        outs.append(harness.pose_step(m, tg, st, rd, c, li, opt,
                                      seeds.to(where),
                                      torch.zeros(1, 3))[1])
    gpu, cpu = outs
    lerr = abs(gpu.loss.item() - cpu.loss.item()) / abs(cpu.loss.item())
    gerr = ((gpu.g_pose.cpu() - cpu.g_pose).abs().max()
            / cpu.g_pose.abs().max()).item()
    if lerr > 1e-4 or gerr > 1e-3:
        fail(f"train: first step card vs CPU plain: loss rel {lerr}, pose "
             f"gradient {gerr} of its max")

    # The main path: optimize_pose, counts reset just before.
    start_deg = degrees_off(log_rot, r_true.to(dev))
    torch.cuda.synchronize()
    reset_counts()
    res = harness.optimize_pose(
        mesh, cams, lights, log_rot, renderer, [target],
        generator=torch.Generator().manual_seed(8), lr_init=TRAIN_LR,
        Niter=TRAIN_STEPS, segment_size=TRAIN_STEPS)
    counts = dict(fr.launch_counts)
    if counts["fused_loss_grad"] != TRAIN_STEPS:
        fail(f"train: launch counts {counts}")
    if not (np.all(np.isfinite(res.losses))
            and np.all(np.isfinite(res.grad_norms))):
        fail(f"train: losses {res.losses} grad norms {res.grad_norms}")
    best = float(np.min(res.losses))
    if not best < res.losses[0]:
        fail(f"train: best loss {best} not below the first {res.losses[0]}")
    report["fused_loss_grad"]["launches"] = counts["fused_loss_grad"]
    steps_s = TRAIN_STEPS / res.runtimes["total"][0]
    end_deg = degrees_off(res.best_log_rot, r_true.to(dev))

    # Where a step's time goes: the whole step (synchronised), K2 alone
    # and the Adam update alone, at the final pose.
    gen = torch.Generator().manual_seed(9)
    st = harness.PoseState.start(res.log_rot)
    opt = torch.optim.Adam([st.log_rot], lr=TRAIN_LR)
    step_ms = []
    for _ in range(11):
        sd = fr.draw_seeds(1, gen, device=dev)
        t0 = time.perf_counter()
        st, _out = harness.pose_step(mesh, target, st, renderer, cams,
                                     lights, opt, sd, torch.zeros(1, 3))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    sd = fr.draw_seeds(1, gen, device=dev)

    def prep():          # pose -> kernel inputs, with the autograd graph
        posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(
            st.log_rot)).transform_points(mesh.verts))
        return kernel_inputs(renderer, posed, sd)

    prep_ms = []
    for _ in range(11):
        t0 = time.perf_counter()
        cfg, ins = prep()
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    ins = [t.detach() for t in ins]
    tcm = target.permute(2, 0, 1).reshape(1, 3, -1).contiguous()
    k2_ms = cuda_ms(lambda: fr.fused_loss_grad(
        cfg, *ins, tcm, "l2_rgb", 1.0 / (3 * IMAGE * IMAGE)), 10)
    st.log_rot.grad = torch.ones_like(st.log_rot)
    adam_ms = cuda_ms(opt.step, 20)
    med = statistics.median(step_ms[1:])
    prep_med = statistics.median(prep_ms[1:])
    print(f"[train] optimize_pose {TRAIN_STEPS} steps, N=1, headline "
          f"config, lr {TRAIN_LR}: launches {counts}; loss "
          f"{res.losses[0]:.5g} -> best {best:.5g}; pose error "
          f"{start_deg:.2f} -> {end_deg:.2f} deg; "
          f"{steps_s:.1f} steps/s ({res.runtimes['total'][0] * 1e3:.1f} ms "
          f"for {TRAIN_STEPS} steps); synchronised step median {med:.3f} ms: "
          f"input prep {prep_med:.3f} ms (host clock), K2 {k2_ms:.4f} ms, "
          f"Adam {adam_ms:.4f} ms (CUDA events), the rest (the prep's "
          f"backward, Python) {med - prep_med - k2_ms - adam_ms:.3f} ms; "
          f"first step vs CPU plain: loss rel {lerr:.3g}, pose "
          f"gradient {gerr:.3g} of max | {smi}", flush=True)


def phase_k5(dev, smi, report):
    for noise in ("gaussian", "softras"):
        cfg, args = stream_inputs(noise, dev, N_POSES)
        count, active = args[2], args[3]
        got = fr.fused_stream_forward(cfg, *args)
        again = fr.fused_stream_forward(cfg, *args)
        want = fr.stream_forward_plain(cfg, *args)
        torch.cuda.synchronize()
        if noise == "gaussian":
            ok, dmax, dmean, flips = mc_close(got, want)
        else:
            d = (got - want).abs()
            dmax, dmean, flips = d.max().item(), d.mean().item(), 0.0
            ok = bool(torch.isfinite(got).all()) and dmax <= 2e-5
        if not ok or not torch.equal(got, again):
            fail(f"K5 {noise}: max {dmax} mean {dmean} flips {flips}, "
                 f"repeat bit-equal {torch.equal(got, again)}")
        k_ms, p_ms = timed_pair(lambda: fr.fused_stream_forward(cfg, *args),
                                lambda: fr.stream_forward_plain(cfg, *args),
                                10, 1)
        w = stream_work(cfg, args)
        b_ms, b_by = bound(stream_bytes(args) + 16 * w["pixels"],
                           stream_forward_ops(cfg, w))
        if noise == "gaussian":
            report["fused_stream_forward"] = dict(
                max_abs_err=dmax, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)
        visits = int((count * active).sum())
        idle = int(((active == 0) & (count > 0)).sum())
        print(f"[K5] fused_stream_forward {noise} cow 5120 faces 256^2 K=50 "
              f"S=8 N=4 (rw {cfg.rw}, {fr._n_tiles(cfg)} tiles of "
              f"{cfg.p_tile} px, {visits} chunk visits, {idle} inactive "
              f"tiles with chunks; {w['visited']} visited and {w['cand']} "
              f"candidate (row, pixel) pairs): max |d| {dmax:.3g}, mean |d| "
              f"{dmean:.3g}, pixels beyond 1e-4 {flips:.3g}, repeat "
              f"bit-equal; {k_ms:.4f} ms vs plain {p_ms:.2f} ms per render, "
              f"bound {b_ms:.4f} ms ({b_by}) | {smi}", flush=True)


def stream_grad_calls(cfg, args, size, seed=2):
    """{kernel name: (kernel call, plain call)} of K6 and K7 on a seeded
    cotangent / target; each call returns (loss or None, g_tab, g_scal)."""
    n, hw = args[0].shape[0], size * size
    g_out = torch.randn(n, size, size, 4, generator=torch.Generator()
                        .manual_seed(seed)).to(args[0])
    target = torch.rand(n, 3, hw, generator=torch.Generator()
                        .manual_seed(seed + 1)).to(args[0])
    lscale = 1.0 / (n * hw * 3)
    return {
        "fused_stream_backward": (
            lambda: (None,) + fr.fused_stream_backward(cfg, *args, g_out),
            lambda: (None,) + fr.stream_backward_plain(cfg, *args, g_out)),
        "fused_stream_loss_grad": (
            lambda: fr.fused_stream_loss_grad(cfg, *args, target, "l2_rgb",
                                              lscale),
            lambda: fr.stream_loss_grad_plain(cfg, *args, target, "l2_rgb",
                                              lscale))}


def phase_k6_k7(dev, smi, report):
    """K6 and K7 against their plain versions at the main paths' shapes:
    the gaussian pair on the cow, 256^2, K6 at N=4 (render-grad-stream),
    K7 at N=1 (train-stream).  Each row within 1e-3 of each table's max
    (MC: shared noise), and each scalar within 1e-3 of its own max, of
    the float32 plain version or of the plain version evaluated in
    float64; the rows of faces too thin for float32 to resolve 1e-3
    within 2e-6 / thinness (``checks.stream_grads_close``, which reports
    both versions' distances from float64 per thinness bin).  Repeated
    launches bit-equal.  (The softras pair's K6 / K7 are held at 1e-4 in
    tests/test_torch_cuda.py at 64^2 and 128^2.)  Then K7 = K5 + K6 at
    N=4, every row within 1e-5 of each table's max."""
    tol = 1e-3
    for kname, n in (("fused_stream_backward", N_POSES),
                     ("fused_stream_loss_grad", 1)):
        cfg, args = stream_inputs("gaussian", dev, n)
        calls = stream_grad_calls(cfg, args, IMAGE)
        kern, plain = calls[kname]
        got, again, want = kern(), kern(), plain()
        args64 = tuple(a.double() if a.is_floating_point() else a
                       for a in args)
        want64 = stream_grad_calls(cfg, args64, IMAGE)[kname][1]()
        torch.cuda.synchronize()
        ok, err, where, n_thin, bins = checks.stream_grads_close(
            cfg, args[0], got[1:], want[1:], want64[1:], tol)
        finite = all(bool(torch.isfinite(t).all()) for t in got[1:])
        same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
        lerr = 0.0
        if got[0] is not None:
            lerr = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
        if not ok or not same or not finite or lerr > 1e-5:
            fail(f"{kname}: worst error {err} at {where} (tolerance "
                 f"{tol}), thin rows {checks.witness_text(bins)}, finite "
                 f"{finite}, repeat bit-equal {same}, loss rel {lerr}")
        k_ms, p_ms = timed_pair(kern, plain, 5, 1)
        w = stream_work(cfg, args)
        loss = kname == "fused_stream_loss_grad"
        nbytes = (2 * stream_bytes(args) + 34 * 4 * n
                  + (12 if loss else 16) * w["pixels"])
        b_ms, b_by = bound(nbytes, stream_grad_ops(cfg, w, loss))
        report[kname] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by)
        print(f"[{'K7' if loss else 'K6'}] {kname} gaussian cow {IMAGE}^2 "
              f"K=50 S=8 N={n}: worst error {err:.3g} of max |grad| at "
              f"{where} from the nearer of the float32 and float64 plain "
              f"versions (tolerance {tol}) outside the {n_thin} rows of "
              f"thin faces (held within {checks.THIN_NOISE:g} / thinness; "
              f"per thinness bin: {checks.witness_text(bins)}); loss rel "
              f"{lerr:.3g}, "
              f"repeat bit-equal; {w['visited']} visited, {w['cand']} "
              f"candidate (row, pixel) pairs; {k_ms:.4f} ms vs plain "
              f"{p_ms:.2f} ms, bound {b_ms:.4f} ms ({b_by}) | {smi}",
              flush=True)

    cfg, args = stream_inputs("gaussian", dev, N_POSES)
    n, hw = N_POSES, IMAGE * IMAGE
    target = torch.rand(n, 3, hw,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    lscale = 1.0 / (n * hw * 3)
    loss, *got = fr.fused_stream_loss_grad(cfg, *args, target, "l2_rgb",
                                           lscale)
    img = fr.fused_stream_forward(cfg, *args)
    d = img[..., :3].reshape(n, hw, 3).transpose(1, 2) - target
    g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(n, IMAGE, IMAGE, 3)
    g_out = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
    dual = fr.fused_stream_backward(cfg, *args, g_out.contiguous())
    dual_loss = torch.sum(d * d, dim=(1, 2)) * lscale
    ok, derr, dwhere = tables_close(checks.split_stream(cfg, *got),
                                    checks.split_stream(cfg, *dual), 1e-5)
    dlerr = ((loss - dual_loss).abs() / dual_loss.abs()).max().item()
    if not ok or dlerr > 1e-5:
        fail(f"K7 vs K5 + K6: worst table error {derr} at {dwhere}, loss "
             f"rel error {dlerr}")
    print(f"[K7 = K5 + K6] gaussian cow {IMAGE}^2 N=4: worst table error "
          f"{derr:.3g} at {dwhere}, loss rel error {dlerr:.3g} | {smi}",
          flush=True)


def phase_serve_stream(dev, smi, report):
    gen = torch.Generator().manual_seed(2030)
    renderer = headline_renderer("gaussian", dev)
    renderer(posed_cow(gen, dev), generator=gen)          # warm
    torch.cuda.synchronize()
    lat_ms, alphas = [], []
    reset_counts()
    t_all = time.perf_counter()
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        img = renderer(posed_cow(gen, dev), generator=gen)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(img.shape) != (N_POSES, IMAGE, IMAGE, 4):
            fail(f"serve-stream: image shape {tuple(img.shape)}")
        if not bool(torch.isfinite(img).all()):
            fail("serve-stream: non-finite pixels")
        alphas.append((img[..., 3] > 0.5).float().mean().item())
    total_s = time.perf_counter() - t_all
    counts = dict(fr.launch_counts)
    if (counts["fused_stream_forward"] != N_REQUESTS
            or counts["fused_forward"] != 0):
        fail(f"serve-stream: launch counts {counts}")
    if not all(0.02 < a < 0.6 for a in alphas):
        fail(f"serve-stream: coverage shares {alphas}")
    report["fused_stream_forward"]["launches"] = counts[
        "fused_stream_forward"]
    med = statistics.median(lat_ms[1:])
    print(f"[serve-stream] {N_REQUESTS} requests x {N_POSES} poses of the "
          f"cow through MeshRenderer: launches {counts}; coverage share "
          f"alpha>0.5 {min(alphas):.3f}-{max(alphas):.3f}; request latency "
          f"median {med:.3f} ms (after the first), "
          f"{N_REQUESTS * N_POSES / total_s:.1f} renders/s | {smi}",
          flush=True)


def phase_render_grad_stream(dev, smi, report):
    """Gradients of an image objective through MeshRenderer on the cow: K5
    forward, K6 backward."""
    gen = torch.Generator().manual_seed(2032)
    renderer = headline_renderer("gaussian", dev)
    weights = torch.linspace(0.0, 1.0, 4, device=dev)
    reset_counts()
    lat_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        log_rot = torch.randn(N_POSES, 3, generator=gen).to(dev)
        log_rot.requires_grad_()
        img = renderer(posed_cow(gen, dev, log_rot=log_rot), generator=gen)
        (g,) = torch.autograd.grad(torch.mean(img * weights), [log_rot])
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if not (bool(torch.isfinite(g).all()) and g.abs().max() > 0):
            fail(f"render-grad-stream: pose gradient {g}")
    counts = dict(fr.launch_counts)
    if (counts["fused_stream_forward"] != 4
            or counts["fused_stream_backward"] != 4):
        fail(f"render-grad-stream: launch counts {counts}")
    report["fused_stream_backward"]["launches"] = counts[
        "fused_stream_backward"]
    print(f"[render-grad-stream] 4 requests x {N_POSES} poses of the cow, "
          f"render + pose gradient through MeshRenderer: launches {counts}; "
          f"request latency median {statistics.median(lat_ms[1:]):.3f} ms "
          f"| {smi}", flush=True)


def phase_train_stream(dev, smi, report):
    """optimize_pose on the cow (stream route, K7 per step), and its first
    step against the same step through the plain versions on the card."""
    r_true = ptt.random_rotations(1, torch.Generator().manual_seed(2031),
                                  device="cpu").to(dev)
    mesh, cams, lights, renderer, log_rot, target = train_setup(
        dev, r_true, 6, cow_mesh)
    if renderer.plan(mesh).mode != "stream":
        fail("train-stream: the cow does not stream")

    # The first step: K7 through pose_step, against K7's plain version on
    # the card fed back through the same input preparation.  The rows of
    # thin faces (``checks.thin_rows``, held apart in the K6 / K7 phase)
    # are left out of both table gradients before they reach the pose.
    seeds = fr.draw_seeds(1, torch.Generator().manual_seed(7), device=dev)
    st = harness.PoseState.start(log_rot)
    opt = torch.optim.Adam([st.log_rot], lr=TRAIN_LR)
    out = harness.pose_step(mesh, target, st, renderer, cams, lights, opt,
                            seeds, torch.zeros(1, 3))[1]
    tcm = target.permute(2, 0, 1).reshape(1, 3, -1).contiguous()
    lscale = 1.0 / (3 * IMAGE * IMAGE)

    def pose_grad(table_grad):
        lr0 = log_rot.detach().clone().requires_grad_()
        posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(lr0))
                                   .transform_points(mesh.verts))
        cfg, (tab, scal, rows, count, active, sd) = kernel_inputs(
            renderer, posed, seeds)
        res = table_grad(cfg, (tab.detach(), rows, count, active,
                               scal.detach(), sd))
        (g,) = torch.autograd.grad(tab, [lr0], res[1])
        return res[0], g

    def without_thin_rows(loss_grad):
        def table_grad(cfg, a):
            loss, g_tab, _g_scal = loss_grad(cfg, *a, tcm, "l2_rgb", lscale)
            return loss, g_tab * ~checks.thin_rows(a[0], 1e-3)[..., None]
        return table_grad

    _k, g_kernel = pose_grad(lambda cfg, a: fr.fused_stream_loss_grad(
        cfg, *a, tcm, "l2_rgb", lscale))
    _k, g_kernel_held = pose_grad(without_thin_rows(fr.fused_stream_loss_grad))
    p_loss, g_plain = pose_grad(without_thin_rows(fr.stream_loss_grad_plain))
    lerr = abs(out.loss.item() - p_loss.item()) / abs(p_loss.item())
    gerr = ((g_kernel_held - g_plain).abs().max()
            / g_plain.abs().max()).item()
    serr = ((out.g_pose - g_kernel).abs().max()
            / g_kernel.abs().max()).item()
    if lerr > 1e-5 or gerr > 1e-3 or serr > 1e-5:
        fail(f"train-stream: first step: loss rel {lerr} vs plain, pose "
             f"gradient {gerr} of its max vs plain, pose_step vs K7 "
             f"{serr}")

    start_deg = degrees_off(log_rot, r_true)
    torch.cuda.synchronize()
    reset_counts()
    res = harness.optimize_pose(
        mesh, cams, lights, log_rot, renderer, [target],
        generator=torch.Generator().manual_seed(8), lr_init=TRAIN_LR,
        Niter=TRAIN_STEPS, segment_size=TRAIN_STEPS)
    counts = dict(fr.launch_counts)
    if (counts["fused_stream_loss_grad"] != TRAIN_STEPS
            or counts["fused_loss_grad"] != 0):
        fail(f"train-stream: launch counts {counts}")
    if not (np.all(np.isfinite(res.losses))
            and np.all(np.isfinite(res.grad_norms))):
        fail(f"train-stream: losses {res.losses} grad norms "
             f"{res.grad_norms}")
    best = float(np.min(res.losses))
    if not best < res.losses[0]:
        fail(f"train-stream: best loss {best} not below the first "
             f"{res.losses[0]}")
    report["fused_stream_loss_grad"]["launches"] = counts[
        "fused_stream_loss_grad"]
    steps_s = TRAIN_STEPS / res.runtimes["total"][0]
    end_deg = degrees_off(res.best_log_rot, r_true)

    gen = torch.Generator().manual_seed(9)
    st = harness.PoseState.start(res.log_rot)
    opt = torch.optim.Adam([st.log_rot], lr=TRAIN_LR)
    step_ms, prep_ms = [], []
    for _ in range(11):
        sd = fr.draw_seeds(1, gen, device=dev)
        t0 = time.perf_counter()
        st, _out = harness.pose_step(mesh, target, st, renderer, cams,
                                     lights, opt, sd, torch.zeros(1, 3))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    sd = fr.draw_seeds(1, gen, device=dev)
    for _ in range(11):
        t0 = time.perf_counter()
        posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(
            st.log_rot)).transform_points(mesh.verts))
        cfg, ins = kernel_inputs(renderer, posed, sd)
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    tab, scal, rows, count, active, sd = [t.detach() for t in ins]
    k7_ms = cuda_ms(lambda: fr.fused_stream_loss_grad(
        cfg, tab, rows, count, active, scal, sd, tcm, "l2_rgb", lscale), 10)
    st.log_rot.grad = torch.ones_like(st.log_rot)
    adam_ms = cuda_ms(opt.step, 20)
    med = statistics.median(step_ms[1:])
    prep_med = statistics.median(prep_ms[1:])
    print(f"[train-stream] optimize_pose {TRAIN_STEPS} steps, N=1, the cow "
          f"(5120 faces, stream route), lr {TRAIN_LR}: launches {counts}; "
          f"loss {res.losses[0]:.5g} -> best {best:.5g}; pose error "
          f"{start_deg:.2f} -> {end_deg:.2f} deg; {steps_s:.1f} steps/s "
          f"({res.runtimes['total'][0] * 1e3:.1f} ms for {TRAIN_STEPS} "
          f"steps); synchronised step median {med:.3f} ms: input prep "
          f"{prep_med:.3f} ms (host clock), K7 {k7_ms:.4f} ms, Adam "
          f"{adam_ms:.4f} ms (CUDA events), the rest "
          f"{med - prep_med - k7_ms - adam_ms:.3f} ms; first step K7 vs "
          f"plain on the card: loss rel {lerr:.3g}, pose gradient "
          f"{gerr:.3g} of max (the thin faces' rows left out of both) "
          f"| {smi}",
          flush=True)


SOURCES = {
    "prng_probe": ("csrc/prng_probe.cu", "ops/fused_render.py:263"),
    "fused_forward": ("csrc/fused_forward.cu", "ops/fused_render.py:799"),
    "fused_backward": ("csrc/fused_backward.cu", "ops/fused_render.py:873"),
    "fused_loss_grad": ("csrc/fused_loss_grad.cu",
                        "ops/fused_render.py:2962"),
    "fused_stream_forward": ("csrc/stream_forward.cu",
                             "ops/fused_render.py:2155"),
    "fused_stream_backward": ("csrc/stream_backward.cu",
                              "ops/fused_render.py:2256"),
    "fused_stream_loss_grad": ("csrc/stream_loss_grad.cu",
                               "ops/fused_render.py:2266"),
}


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs the port on a GPU")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = smi_name_power()
    if cap != (9, 0):
        fail(f"{name} has capability {cap}; the kernels are built for sm_90a")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[device] {name} capability {cap} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | kernel build "
          f"{build_s:.2f} s (nvcc {_build.build_seconds})", flush=True)

    report = {}
    phase_k1(dev, smi, report)
    phase_k3(dev, smi, report)
    phase_k4(dev, smi, report)
    phase_k2(dev, smi, report)
    phase_serve(dev, smi, report)
    phase_render_grad(dev, smi, report)
    phase_train(dev, smi, report)
    phase_k5(dev, smi, report)
    phase_k6_k7(dev, smi, report)
    phase_serve_stream(dev, smi, report)
    phase_render_grad_stream(dev, smi, report)
    phase_train_stream(dev, smi, report)

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        r = report[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"pertrenderer_tpu_torch/{src}",
            "replaces": f"pertrenderer_tpu/{replaces}",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
