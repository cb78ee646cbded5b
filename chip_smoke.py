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
   N=4 (1e-5 of each table's max); ptxas's registers / stack / spills of
   the two gradient kernels (csrc/stream_warp.cuh: B1, B2) and their
   resident blocks per SM at N=1 by the occupancy API (>= 2 blocks or >= 16
   warps); then [stream S=128]: the gaussian pair at S = 128 (two passes
   of 64 samples over the chunk list) on the cow at 64^2, N=1: K5, K6 and
   K7 against their plain versions at the same tolerances, repeats
   bit-equal, through MeshRenderer.forward and render_loss, and K7 = K5 +
   K6; then K5 / K6 at N=4 and K7 at N=1 on the cow at 256^2, S = 64
   beside S = 128, timed, finite, repeats bit-equal;
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

14. K9a / K9b / K10a / K10b — the staged route's row gather, its scatter,
   the interpolating gather and its gradients against their plain
   versions at the cow's staged shapes (256^2, K=50, N=4: 13.1 M columns
   over 20,480 face rows; D = 9 for the corner table, 6 for positions and
   normals), and on an edge case with -1 and out-of-range indices: K9a
   bit-exact, K10a within 1 ulp of max |out|, K9b / K10b within 1e-6 of
   the output's max of the nearer of the float32 and float64 plain
   versions; repeated launches bit-equal; index_select (K9a) and
   index_add_ (K9b) timed as the library calls; K9b's index preparation
   checked against torch.sort(stable=True) / searchsorted and timed apart
   from its sum; ptxas's registers / stack of K9b's kernels;
15. target — harness.init_target('cube', 256), the reference's K=1
   Hard-Phong target on the staged route, and the share of its cube
   pixels equal to [train]'s flat fused HardRast + HardAgg target on the
   same pose; get_hard_rendering of the cow (binned select) with its
   select / shade split;
16. staged-softras — RandomPhongShader(SoftRast, SoftAgg) at sigma 1e-3,
   gamma 1e-2 through rasterizer.planar + shader(...) at 256^2, K=50, N=4
   on the cube and the cow, forward and the gradient to the vertices,
   sigma and gamma, held against the fused route on the same poses (K3 /
   K4 on the cube, K5 / K6 on the cow): image atol 2e-5, gradients within
   1e-4 of their max; on the cow the pixels whose slot K-1 is filled and
   the vertices of thin faces are left out, and sigma / gamma are held
   against the nearer of K6 and the float64 plain version;
17. K12 — the binned route's forward (N=4), backward and loss-and-grad
   (N=1) against their plain versions on BASELINE config 5 (the level-6
   icosphere, 81,920 faces, x3, oracle colours, at 512^2, K=150, M=160
   slots in 2048 strip tiles of 128 pixels; random poses), gaussian (S=8)
   and softras: forward as K3; each gradient row and scalar within 1e-3
   (MC) or 1e-4 (softras) of its max of the float32 or float64 plain
   version, thin faces' rows within 2e-6 L / h (K12 and its plain
   versions aggregate in double: in float the softras alpha gradient
   misses float64 by 1.5e-4); repeats bit-equal; the
   loss-and-grad equal to the forward's L2 cotangent through the backward
   (1e-5); ptxas's registers / stack / spills of K12's kernels;
18. capacity-binned — capacity_stats of tools/oracle_config5.py's scene
   within 1% of artifacts/oracle_config5.json (max_range 12134,
   max_tile_candidates 4954);
19. serve-binned — 8 requests of N=4 config-5 poses through MeshRenderer
   (K1, K12's forward; no flat, stream or staged kernel);
20. train-binned — optimize_pose on config 5 for 30 steps at N=1 from 20
   degrees off (gaussian, S=8, sigma 6e-3, gamma 6e-2), against the
   port's binned HardRast + HardAgg render of the true pose: K12's
   loss-and-grad once per step and the capacity probe at the segment
   boundary; its first step against the same step through the plain
   version on the card (loss rtol 1e-5, pose gradient within 1e-3 of its
   max, the thin faces' rows left out of both);
21. determinism — two preparations of the cow's stream inputs and their
   backward with torch's default algorithms give the same bits; the ops
   that warn under torch.use_deterministic_algorithms (warn only).

22. K11a / K3e / K11b / K11c — the sample-sharded route's kernels on the
   cube (256^2, K=50, N=4, GaussianRast + GaussianAgg sharding S_local=4
   samples per rank) on shard 1's seed words, each fed its plain
   upstream: K11a's coverage, K3's image and weights with external
   coverage (MC image rule, per pixel over the rows), K11b's g_zmap and
   gamma term (1e-3 of max), K11c's tables (1e-3 of max); repeats
   bit-equal;
23. sharded = folded / sharded-stream = folded — two gloo ranks spawned
   on the one card (NCCL refuses two ranks per device; every average
   stages through the host), each rendering through MeshRenderer.
   render_loss and back to the poses and sigma / gamma / alpha, against
   one process at the group's samples: the cube (N=4, S_local 4 vs 8)
   and the cow (N=2, S_rast 8 on every rank, S_agg 4 vs 8): image atol
   1e-6, loss rtol 1e-6, pose gradient 1e-6 of its max (the cow's with
   its thin faces' sorted-table rows, height under 2e-3 of the longest
   edge, left out of both, as [K6] holds them), sigma / gamma / alpha
   rtol 1e-5 (the cow 5e-5); the ranks bit-equal;
24. serve-sharded — 8 requests of N=4 cube poses through MeshRenderer
   on the two ranks (K11a and K3 with external coverage, no other fused
   kernel), each request's time split into kernels (CUDA events),
   collectives and host (host clock, synchronised);
25. train-sharded — make_sharded_pose_step for 30 steps at N=1 from 20
   degrees off against the flat HardRast + HardAgg target (K11a, K3e,
   K11b, K11c once per step), the step's time split likewise, the pose
   error;
26. dryrun-sharded — sharding.dryrun_multichip(2, device="cuda"): the
   cube and the 80-face icosphere phases, finite losses.

Phases 6-8, 11-13, 15, 16, 19, 20, 24 and 25 are the main paths: the
launch
counts are reset just before each and read just after, and each must have
launched its kernels (serve: K1 and K3; render-grad: K3 and K4; train: K2
once per step; serve-stream: K5; render-grad-stream: K5 and K6;
train-stream: K7 once per step; target: K9a and no fused kernel;
staged-softras: K9a, K9b, K10a and K10b and no fused kernel;
serve-binned: K1 and K12's forward; train-binned: K12's loss-and-grad
once per step; serve-sharded and train-sharded: counted in rank 0).  Times are CUDA events except the
per-request and per-step times (host clock ending in a device
synchronisation).  Kernel and plain version are timed in turns (plain,
kernel, kernel, plain) after a warm-up call.

The last lines are the per-kernel report (one JSON object, eighteen
kernels; K12's row gives its loss-and-grad at N=1, the pose step's
kernel, and every mode under "modes"; K3's row its external-coverage
mode under "modes"),
the card's nvidia-smi name and power limit, then
{"ok": true, "device": {...}}.
"""

import dataclasses
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
from pertrenderer_tpu_torch import _build, checks, shading
from pertrenderer_tpu_torch.checks import tables_close
from pertrenderer_tpu_torch.experiments import config5, harness
from pertrenderer_tpu_torch.ops import binned
from pertrenderer_tpu_torch.ops import fused_render as fr
from pertrenderer_tpu_torch.ops import gather as gk
from pertrenderer_tpu_torch.ops import interp_gather as ik
from pertrenderer_tpu_torch.ops import perturbed_kernels as pk
from pertrenderer_tpu_torch.parallel import sharding

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


def ptxas_report(names):
    """{name: "R registers, S bytes stack, L bytes spill stores / loads"}
    from the build's ptxas report (_build/build.log) for the kernels whose
    mangled names contain each of ``names``."""
    with open(os.path.join(_build.BUILD_DIR, "build.log")) as f:
        lines = f.read().splitlines()
    out, entry, frame = {}, None, ""
    for line in lines:
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            frame = ""
        elif entry and "bytes stack frame" in line:
            frame = line.strip()
        elif entry and "Used" in line and "registers" in line:
            for name in names:
                if name in entry:
                    regs = line.split("Used")[1].split("registers")[0].strip()
                    out.setdefault(name, []).append(
                        f"{regs} registers; {frame}")
            entry = None
    return out


def k9b_per(report, path, units, what):
    """K9b's launches on a main path's run (the counts reset just before),
    recorded under report["scatter_rows_cm"]["launches_by_path"]; the text
    gives them per request or step."""
    n = gk.launch_counts["scatter_rows_cm"]
    report.setdefault("k9b_paths", {})[path] = n
    return f"K9b {n / units:g} per {what}"


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


COUNTS = (fr.launch_counts, gk.launch_counts, ik.launch_counts,
          pk.launch_counts)


def reset_counts():
    for counts in COUNTS:
        for k in counts:
            counts[k] = 0


def all_counts():
    return {k: v for counts in COUNTS for k, v in counts.items()}


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


def tensor_bytes(args):
    """Bytes of a kernel's tensor arguments (stream: the sorted table,
    chunk lists, counts, activity bits, scalars and seeds; binned: the
    per-tile tables, slot validity, scalars, seeds and activity bits)."""
    return sum(t.numel() * t.element_size() for t in args)


def table_bytes(cfg, n):
    """Bytes of the face tables, validity, scalars and seeds."""
    return 4 * n * (cfg.f_pad * (27 + cfg.tex_d + 1) + 34 + 4)


def scene(device):
    r, t = ptt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0,
                                      device=device)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), device=device)
    return r, t, lights


def headline_renderer(noise, device, n=N_POSES, size=None, s=S):
    """The headline scene's renderer (cameras, light, estimators), at
    ``size``^2 (IMAGE by default), ``s`` samples per estimator."""
    r, t, lights = scene(device)
    cams = ptt.PerspectiveCameras.create(
        R=r.expand(n, 3, 3), T=t.expand(n, 3), fov=60.0, device=device)
    if noise == "gaussian":
        sr = ptt.GaussianRast.create(sigma=SIGMA, nb_samples=s)
        sa = ptt.GaussianAgg.create(gamma=GAMMA, nb_samples=s)
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


def stream_inputs(noise, dev, n, size=None, s=S):
    """(cfg, K5-K7 arguments) of the cow at n random poses."""
    renderer = headline_renderer(noise, dev, n, size, s)
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
    cfg, _why = fr._plan(mesh, sh.lights, sh.smoothrast, sh.smoothagg,
                         settings, "phong")
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
    k9b = k9b_per(report, "serve", N_REQUESTS, "request")
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
          f"MeshRenderer: launches {counts}, {k9b}; coverage share alpha>0.5 "
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
    k9b = k9b_per(report, "train", TRAIN_STEPS, "step")
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
          f"config, lr {TRAIN_LR}: launches {counts}, {k9b}; loss "
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
    lines = ptxas_report(("stream_forward_kernel",)).get(
        "stream_forward_kernel", ["not in the build log"])
    print(f"[K5] ptxas stream_forward_kernel: {' | '.join(sorted(set(lines)))}",
          flush=True)
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
        b_ms, b_by = bound(tensor_bytes(args) + 16 * w["pixels"],
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


def stream_grad_calls(cfg, args, size, seed=2, g_out=None):
    """{kernel name: (kernel call, plain call)} of K6 and K7 on a seeded
    cotangent (or ``g_out``) / target; each call returns (loss or None,
    g_tab, g_scal)."""
    n, hw = args[0].shape[0], size * size
    if g_out is None:
        g_out = torch.randn(n, size, size, 4, generator=torch.Generator()
                            .manual_seed(seed))
    g_out = g_out.to(args[0])
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
    launches bit-equal.  Then the softras pair (SoftRast + SoftAgg at the
    same sigma / gamma) likewise at 1e-4, K6 on [staged-softras]'s
    cotangent (its objective's weights, the pixels whose slot K-1 fills
    left out), and every scalar (sigma and gamma among them) against the
    float64 plain version alone: the softmax's gamma, znear and zfar
    gradients are sums whose terms cancel, and a float32 version of them
    lost digits that the float32 plain version lost too.  Then K7 = K5 +
    K6 at N=4, every row within 1e-5 of each table's max."""
    stream_grad_shapes(dev, smi)
    for noise, tol in (("gaussian", 1e-3), ("softras", 1e-4)):
        for kname, n in (("fused_stream_backward", N_POSES),
                         ("fused_stream_loss_grad", 1)):
            k6_k7_case(dev, smi, report, noise, tol, kname, n)
    k7_equals_k5_k6(dev, smi)


def stream_grad_shapes(dev, smi):
    """ptxas's registers / stack / spills of K6's and K7's two kernels
    (csrc/stream_warp.cuh: B1's stream_replay_kernel, B2's
    stream_adjoint_kernel) and, at the cow's N=1 shapes, their block
    shapes and resident blocks per SM by the occupancy API: each must hold
    >= 2 blocks or >= 16 warps per SM."""
    names = [f"stream_{k}_kernelILb{loss}E" for loss in (0, 1)
             for k in ("replay", "adjoint")]
    for name, lines in ptxas_report(names).items():
        tag = "K6" if "Lb0E" in name else "K7"
        print(f"[{tag}] ptxas {name}: {' | '.join(sorted(set(lines)))}",
              flush=True)
    cfg, args = stream_inputs("gaussian", dev, 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = fr._n_tiles(cfg) * (cfg.p_tile // fr.STREAM_BLOCK_PIX)
    for kname, tag in (("fused_stream_backward", "K6"),
                       ("fused_stream_loss_grad", "K7")):
        sh = fr.stream_grad_shape(kname, cfg, args[0].shape[2], dev)
        for part, w, per_sm, smem in (
                ("B1", sh["b1_warps"], sh["b1_blocks_per_sm"], sh["b1_smem"]),
                ("B2", sh["warps"], sh["blocks_per_sm"], sh["smem"])):
            if per_sm < 2 and per_sm * w < 16:
                fail(f"{kname} {part}: {per_sm} resident blocks of {w} "
                     f"warps per SM")
            print(f"[{tag}] {kname} {part} kernel on the cow at N=1: "
                  f"{blocks} blocks of {w} warps ({fr.STREAM_BLOCK_PIX} "
                  f"pixels each) on {sms} SMs, {per_sm} resident per SM "
                  f"({per_sm * w} warps), {smem} B of dynamic shared "
                  f"memory per block | {smi}", flush=True)


def k6_k7_case(dev, smi, report, noise, tol, kname, n):
    """One K6 / K7 check of ``phase_k6_k7`` (``noise``: gaussian or
    softras)."""
    cfg, args = stream_inputs(noise, dev, n)
    g_out = None
    if noise == "softras" and kname == "fused_stream_backward":
        g_out = staged_softras_cotangent(dev)
    calls = stream_grad_calls(cfg, args, IMAGE, g_out=g_out)
    kern, plain = calls[kname]
    got, again, want = kern(), kern(), plain()
    args64 = tuple(a.double() if a.is_floating_point() else a
                   for a in args)
    want64 = stream_grad_calls(cfg, args64, IMAGE, g_out=g_out)[kname][1]()
    torch.cuda.synchronize()
    ok, err, where, n_thin, bins = checks.stream_grads_close(
        cfg, args[0], got[1:], want[1:], want64[1:], tol)
    s_text = ""
    if noise == "softras":
        s_ok, s_err, s_where = checks.scalars_close64(got[2], want64[2], tol)
        ok = ok and s_ok
        s_text = (f"; every scalar against float64 alone within {s_err:.3g} "
                  f"of its max at {s_where} (gamma summed over N: kernel "
                  f"{got[2][:, fr._S_GAMMA].sum().item():.9g}, float32 "
                  f"plain {want[2][:, fr._S_GAMMA].sum().item():.9g}, "
                  f"float64 {want64[2][:, fr._S_GAMMA].sum().item():.9g}; "
                  f"sigma: kernel {got[2][:, fr._S_SIGMA].sum().item():.9g}, "
                  f"float64 {want64[2][:, fr._S_SIGMA].sum().item():.9g})")
    finite = all(bool(torch.isfinite(t).all()) for t in got[1:])
    same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
    lerr = 0.0
    if got[0] is not None:
        lerr = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
    if not ok or not same or not finite or lerr > 1e-5:
        fail(f"{kname} {noise}: worst error {err} at {where} (tolerance "
             f"{tol}){s_text}, thin rows {checks.witness_text(bins)}, "
             f"finite {finite}, repeat bit-equal {same}, loss rel {lerr}")
    loss = kname == "fused_stream_loss_grad"
    tag = "K7" if loss else "K6"
    if noise == "softras":
        print(f"[{tag}] {kname} softras cow {IMAGE}^2 K=50 N={n}: worst "
              f"error {err:.3g} of max |grad| at {where} from the nearer of "
              f"the float32 and float64 plain versions (tolerance {tol}) "
              f"outside the {n_thin} rows of thin faces{s_text}; loss rel "
              f"{lerr:.3g}, repeat bit-equal | {smi}", flush=True)
        return
    k_ms, p_ms = timed_pair(kern, plain, 5, 1)
    w = stream_work(cfg, args)
    nbytes = (2 * tensor_bytes(args) + 34 * 4 * n
              + (12 if loss else 16) * w["pixels"])
    b_ms, b_by = bound(nbytes, stream_grad_ops(cfg, w, loss))
    report[kname] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by)
    print(f"[{tag}] {kname} gaussian cow {IMAGE}^2 "
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


def staged_softras_cotangent(dev):
    """[staged-softras]'s objective on the cow as a cotangent of the N=4
    image: seeded weights, 0 at the pixels whose slot K-1 fills."""
    mesh = posed_cow(torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        p2f = staged_renderer("softras", dev).rasterizer.planar(
            mesh).pix_to_face
    w = torch.randn(N_POSES, IMAGE, IMAGE, 4,
                    generator=torch.Generator().manual_seed(6)).to(dev)
    return w * (p2f[..., K - 1] < 0)[..., None].float()


def k7_equals_k5_k6(dev, smi, n=N_POSES, size=IMAGE, s=S):
    """K7 = K5 + K6 at N=4: every row within 1e-5 of each table's max."""
    cfg, args = stream_inputs("gaussian", dev, n, size, s)
    hw = size * size
    target = torch.rand(n, 3, hw,
                        generator=torch.Generator().manual_seed(3)).to(dev)
    lscale = 1.0 / (n * hw * 3)
    loss, *got = fr.fused_stream_loss_grad(cfg, *args, target, "l2_rgb",
                                           lscale)
    img = fr.fused_stream_forward(cfg, *args)
    d = img[..., :3].reshape(n, hw, 3).transpose(1, 2) - target
    g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(n, size, size, 3)
    g_out = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
    dual = fr.fused_stream_backward(cfg, *args, g_out.contiguous())
    dual_loss = torch.sum(d * d, dim=(1, 2)) * lscale
    ok, derr, dwhere = tables_close(checks.split_stream(cfg, *got),
                                    checks.split_stream(cfg, *dual), 1e-5)
    dlerr = ((loss - dual_loss).abs() / dual_loss.abs()).max().item()
    if not ok or dlerr > 1e-5:
        fail(f"K7 vs K5 + K6: worst table error {derr} at {dwhere}, loss "
             f"rel error {dlerr}")
    print(f"[K7 = K5 + K6] gaussian cow {size}^2 N={n} S={s}: worst table "
          f"error {derr:.3g} at {dwhere}, loss rel error {dlerr:.3g} | "
          f"{smi}", flush=True)


STREAM_S128 = 128     # optimize_pose's anneal_sample_cap
STREAM_S128_IMAGE = 64


def phase_stream_s128(dev, smi):
    """The stream route above 64 aggregation samples (K5, K6 / K7's B1 in
    passes of 64): the gaussian pair at S = 128 on the cow at 64^2, K=50,
    N=1.  A render (K5) at the MC tolerance of its plain version, and K6
    and K7 (a pose step's loss and gradients) within 1e-3 of the nearer of
    the float32 and float64 plain versions (``checks.stream_grads_close``),
    each repeat bit-equal; K7 = K5 + K6 (1e-5).  The render goes through
    MeshRenderer.forward and the step through render_loss as well, with
    the launch counts read around them."""
    size, s = STREAM_S128_IMAGE, STREAM_S128
    cfg, args = stream_inputs("gaussian", dev, 1, size, s)
    got = fr.fused_stream_forward(cfg, *args)
    again = fr.fused_stream_forward(cfg, *args)
    want = fr.stream_forward_plain(cfg, *args)
    torch.cuda.synchronize()
    ok, dmax, dmean, flips = mc_close(got, want)
    if not ok or not torch.equal(got, again):
        fail(f"stream S={s} K5: max {dmax} mean {dmean} flips {flips}, "
             f"repeat bit-equal {torch.equal(got, again)}")
    k5_ms = cuda_ms(lambda: fr.fused_stream_forward(cfg, *args), 3)
    texts = [f"K5 max |d| {dmax:.3g}, mean |d| {dmean:.3g}, pixels beyond "
             f"1e-4 {flips:.3g}, {k5_ms:.3f} ms"]
    args64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    for kname in ("fused_stream_backward", "fused_stream_loss_grad"):
        kern, plain = stream_grad_calls(cfg, args, size)[kname]
        got, again, want = kern(), kern(), plain()
        want64 = stream_grad_calls(cfg, args64, size)[kname][1]()
        torch.cuda.synchronize()
        ok, err, where, n_thin, bins = checks.stream_grads_close(
            cfg, args[0], got[1:], want[1:], want64[1:], 1e-3)
        same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
        lerr = 0.0
        if got[0] is not None:
            lerr = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
        if not ok or not same or lerr > 1e-5:
            fail(f"stream S={s} {kname}: worst error {err} at {where}, thin "
                 f"rows {checks.witness_text(bins)}, repeat bit-equal "
                 f"{same}, loss rel {lerr}")
        ms = cuda_ms(kern, 3)
        texts.append(f"{'K7' if got[0] is not None else 'K6'} worst error "
                     f"{err:.3g} of max |grad| at {where} outside {n_thin} "
                     f"thin rows, loss rel {lerr:.3g}, {ms:.3f} ms")
    rend = headline_renderer("gaussian", dev, 1, size, s)
    mesh = posed_cow(torch.Generator().manual_seed(0), dev, 1)
    target = torch.rand(1, size, size, 3,
                        generator=torch.Generator().manual_seed(5)).to(dev)
    gen = torch.Generator().manual_seed(6)
    reset_counts()
    img = rend(mesh, generator=gen)
    loss = rend.render_loss(mesh, target, generator=gen)
    torch.cuda.synchronize()
    counts = all_counts()
    if (rend.plan(mesh).mode != "stream" or counts["fused_stream_forward"] < 1
            or counts["fused_stream_loss_grad"] < 1
            or not bool(torch.isfinite(img).all())
            or not bool(torch.isfinite(loss).all())):
        fail(f"stream S={s} through MeshRenderer: plan "
             f"{rend.plan(mesh).mode}, launches {counts}")
    print(f"[stream S={s}] gaussian cow {size}^2 K={K} N=1: "
          + "; ".join(texts)
          + f"; repeats bit-equal; MeshRenderer.forward and render_loss "
          f"launch K5 {counts['fused_stream_forward']}, K7 "
          f"{counts['fused_stream_loss_grad']} | {smi}", flush=True)
    k7_equals_k5_k6(dev, smi, 1, size, s)
    stream_sample_scaling(dev, smi)


def stream_sample_scaling(dev, smi):
    """K5 and K6 at N=4 and K7 at N=1 (the pose step's shape) on the cow at
    256^2, S = 64 (one pass over the chunk list) beside S = 128 (two),
    timed in turns (64, 128, 128, 64); each output finite and its repeat
    bit-equal."""
    texts = []
    for kname, n in (("fused_stream_forward", N_POSES),
                     ("fused_stream_backward", N_POSES),
                     ("fused_stream_loss_grad", 1)):
        calls = {}
        for s in (64, STREAM_S128):
            cfg, args = stream_inputs("gaussian", dev, n, IMAGE, s)
            if kname == "fused_stream_forward":
                kern = (lambda cfg=cfg, args=args:
                        (fr.fused_stream_forward(cfg, *args),))
            else:
                kern = stream_grad_calls(cfg, args, IMAGE)[kname][0]
            got, again = kern(), kern()
            torch.cuda.synchronize()
            outs = [(a, b) for a, b in zip(got, again) if a is not None]
            if not all(bool(torch.isfinite(a).all()) and torch.equal(a, b)
                       for a, b in outs):
                fail(f"{kname} at S={s}, cow {IMAGE}^2 N={n}: not finite "
                     f"or a repeat differs")
            calls[s] = kern
        t64 = cuda_ms(calls[64], 3)
        t128 = cuda_ms(calls[STREAM_S128], 3)
        t128 = (t128 + cuda_ms(calls[STREAM_S128], 3)) / 2
        t64 = (t64 + cuda_ms(calls[64], 3)) / 2
        tag = {"fused_stream_forward": "K5", "fused_stream_backward": "K6",
               "fused_stream_loss_grad": "K7"}[kname]
        texts.append(f"{tag} N={n} S=64 {t64:.3f} ms, S={STREAM_S128} "
                     f"{t128:.3f} ms ({t128 / t64:.3f}x)")
        del calls
        torch.cuda.empty_cache()
    print(f"[stream S={STREAM_S128}] gaussian cow {IMAGE}^2 K={K}: "
          + "; ".join(texts) + f"; finite, repeats bit-equal | {smi}",
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
    k9b = k9b_per(report, "train-stream", TRAIN_STEPS, "step")
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
          f"(5120 faces, stream route), lr {TRAIN_LR}: launches {counts}, "
          f"{k9b}; "
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


# ---------------------------------------------------------------------------
# The staged route: K9a / K9b (row gather and scatter), K10a / K10b
# (interpolating gather and its gradients)
# ---------------------------------------------------------------------------

def staged_renderer(noise, device, n=N_POSES, k=K):
    """The headline renderer (softras: SoftRast + SoftAgg at the main
    path's sigma / gamma), with max_faces_per_bin above the cow's face
    count so that the staged selection's bins drop no face."""
    rend = headline_renderer(noise, device, n)
    rend.rasterizer.raster_settings = dataclasses.replace(
        rend.rasterizer.raster_settings, max_faces_per_bin=50000,
        faces_per_pixel=k)
    return rend


def nearer_error(got, want, want64):
    """max |got - want| over max |want64|, against the nearer of the
    float32 and float64 plain versions (the float32 plain version's
    sequential sums round too)."""
    scale = max(want64.abs().max().item(), 1e-30)
    d32 = (got.double() - want.double()).abs().max().item()
    d64 = (got.double() - want64).abs().max().item()
    return min(d32, d64) / scale, d32 / scale, d64 / scale


def staged_kernel_inputs(dev):
    """The cow's staged shapes at 256^2, K=50, N=4: its planar fragments
    (binned select), the per-face corner table (N F, 9), the merged
    position / normal corner table (N F, 3, 6) and the flat indices with
    the batch offsets, -1 where empty."""
    rend = staged_renderer("softras", dev)
    mesh = posed_cow(torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        pfrag = rend.rasterizer.planar(mesh)
        n, f = mesh.batch_size, mesh.max_faces
        faces = torch.clamp(mesh.faces, min=0)
        verts_ndc = rend.rasterizer.cameras.transform_points_ndc(mesh.verts)
        fv9 = gk.take_rows_batched(verts_ndc, faces).reshape(n * f, 9)
        merged = shading.corner_table(mesh)
    idx = gk.batch_index(pfrag.pix_to_face, n, f).reshape(-1).contiguous()
    ws = [w.reshape(-1).contiguous() for w in (pfrag.w0, pfrag.w1,
                                               pfrag.w2)]
    return (fv9.contiguous(), merged.reshape(n * f, 3, 6).contiguous(), idx,
            ws)


def edge_indices(idx, f):
    """idx with every 97th column -1 and every 89th out of range (f + 3)."""
    e = idx.clone()
    e[::97] = -1
    e[::89] = f + 3
    return e


def phase_k9_k10(dev, smi, report):
    """K9a / K9b / K10a / K10b against their plain versions at the cow's
    staged shapes (P = N H W K = 13.1 M columns over N F = 20,480 rows):
    K9a bit-exact, K10a within 1 ulp of max |out|, K9b / K10b within 1e-6
    of the output's max |.| of the nearer of the float32 and float64 plain
    versions; each also on an edge case with -1 and out-of-range
    indices; two launches bit-equal.  Times in CUDA events; the bound is
    bytes over 3.35 TB/s (each input read once, each output written once,
    and the cotangent and weights only at the filled columns: an empty
    column's output is 0 and it adds nothing to a row); the library call
    times torch.index_select with a mask (K9a) and index_add_ over the
    filled columns (K9b), which compute the same functions."""
    fv9, merged, idx, ws = staged_kernel_inputs(dev)
    rows, p = fv9.shape[0], idx.shape[0]
    gen = torch.Generator().manual_seed(4)
    edge = edge_indices(idx, rows)
    filled = int((idx >= 0).sum())

    # K9a: the (N F, 9) corner table at every column.
    table_t = fv9.T.contiguous()
    valid = ((idx >= 0) & (idx < rows)).float()
    safe = idx.clamp(0, rows - 1)
    for ix in (idx, edge):
        got, again = gk.gather_rows_cm(fv9, ix), gk.gather_rows_cm(fv9, ix)
        if not (torch.equal(got, gk.gather_rows_plain(fv9, ix))
                and torch.equal(got, again)):
            fail("K9a: not bit-exact against its plain version")
    ms, plain_ms = timed_pair(lambda: gk.gather_rows_cm(fv9, idx),
                              lambda: gk.gather_rows_plain(fv9, idx), 20)
    lib_ms = cuda_ms(lambda: torch.index_select(table_t, 1, safe) * valid,
                     20)
    b_ms, b_by = bound(8 * p + 4 * 9 * p + 4 * fv9.numel(), 0)
    report["gather_rows_cm"] = dict(max_abs_err=0.0, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib_ms)
    print(f"[K9a] gather_rows_cm cow staged {IMAGE}^2 K={K} N={N_POSES} "
          f"({rows} rows x "
          f"9 at {p} columns, {filled} filled): bit-exact vs plain (also "
          f"with -1 / out-of-range indices), repeat bit-equal; {ms:.4f} ms "
          f"vs plain {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}) | {smi}", flush=True)

    # K9b: a cotangent (9, P) summed into the rows.
    g9 = torch.randn(9, p, generator=gen).to(dev)
    worst = 0.0
    for ix in (idx, edge):
        got, again = (gk.scatter_rows_cm(g9, ix, rows) for _ in range(2))
        want = gk.scatter_rows_plain(g9, ix, rows)
        want64 = gk.scatter_rows_plain(g9.double(), ix, rows)
        err, e32, e64 = nearer_error(got, want, want64)
        worst = max(worst, err)
        if err > 1e-6 or not torch.equal(got, again):
            fail(f"K9b: error {err} (float32 plain {e32}, float64 {e64}), "
                 f"repeat bit-equal {torch.equal(got, again)}")
    ptx = ptxas_report(("compact_kernel", "digit_count_kernel",
                        "digit_scan_kernel", "digit_scatter_kernel",
                        "bounds_kernel", "chunks_kernel", "sum_kernelILb0",
                        "final_kernel"))
    print("[K9b] ptxas: " + "; ".join(
        f"{k} {sorted(set(v))[0]}" for k, v in ptx.items()), flush=True)
    ms, plain_ms = timed_pair(lambda: gk.scatter_rows_cm(g9, idx, rows),
                              lambda: gk.scatter_rows_plain(g9, idx, rows),
                              10)
    # The preparation alone gives torch.sort's order and searchsorted's
    # starts; its time and the sum's apart (CUDA events).
    seg = gk.segments(idx, rows)
    key = torch.where((idx >= 0) & (idx < rows), idx, rows)
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(sorted_key, torch.arange(rows + 1,
                                                         device=dev))
    lengths = starts[1:] - starts[:-1]
    if not (int(seg.num_valid[0]) == filled
            and torch.equal(seg.order[:filled].long(), order[:filled])
            and torch.equal((seg.ends - seg.starts).long(), lengths)
            and torch.equal(seg.starts.long()[lengths > 0],
                            starts[:-1][lengths > 0])):
        fail("K9b: the preparation's order or row bounds differ from "
             "torch.sort(stable=True) / searchsorted")
    prep_ms = cuda_ms(lambda: gk.segments(idx, rows), 10)
    sum_ms = cuda_ms(lambda: gk.segment_sum(g9, seg, rows), 10)
    live = idx >= 0
    idx_live, g_live = idx[live], g9[:, live].T.contiguous()

    def library():
        return torch.zeros(rows, 9, device=dev).index_add_(0, idx_live,
                                                           g_live)
    library()
    lib_ms = cuda_ms(library, 10)
    b_ms, b_by = bound(8 * p + 4 * 9 * filled + 4 * 9 * rows, 9 * filled)
    report["scatter_rows_cm"] = dict(max_abs_err=worst, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms,
                                     prep_ms=prep_ms, sum_ms=sum_ms)
    print(f"[K9b] scatter_rows_cm cow staged (9, {p}) into {rows} rows: "
          f"error {worst:.3g} of max (nearer of the float32 / float64 plain "
          f"versions; float32 plain {e32:.3g}, float64 {e64:.3g} on the edge "
          f"case), repeat bit-equal; preparation = torch.sort(stable) / "
          f"searchsorted ({gk._sort_passes(rows)} radix passes); {ms:.4f} ms "
          f"(preparation {prep_ms:.4f} ms + sum {sum_ms:.4f} ms) vs plain "
          f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}) | {smi}", flush=True)

    # K10a: positions and normals (D = 6) interpolated at every column.
    for ix in (idx, edge):
        got = ik.interp_rows(merged, ix, *ws)
        again = ik.interp_rows(merged, ix, *ws)
        want = ik.interp_rows_plain(merged, ix, *ws)
        ulp = torch.finfo(torch.float32).eps * want.abs().max().item()
        err = (got - want).abs().max().item()
        if err > ulp or not torch.equal(got, again):
            fail(f"K10a: max |d| {err} above 1 ulp of max |out| ({ulp})")
    ms, plain_ms = timed_pair(lambda: ik.interp_rows(merged, idx, *ws),
                              lambda: ik.interp_rows_plain(merged, idx, *ws),
                              20)
    b_ms, b_by = bound(8 * p + 12 * filled + 4 * 6 * p
                       + 4 * merged.numel(), 5 * 6 * filled)
    report["interp_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=None)
    print(f"[K10a] interp_rows cow staged (3, 6) corners at {p} columns: max "
          f"|d| {err:.3g} vs plain (1 ulp of max |out|: {ulp:.3g}), also with "
          f"-1 / out-of-range indices, repeat bit-equal; {ms:.4f} ms vs "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) | {smi}",
          flush=True)

    # K10b: a cotangent (6, P) back to the corner table and the weights.
    g6 = torch.randn(6, p, generator=gen).to(dev)
    worst = 0.0
    for ix in (idx, edge):
        got = ik.interp_rows_backward(merged, ix, *ws, g6)
        again = ik.interp_rows_backward(merged, ix, *ws, g6)
        want = ik.interp_rows_backward_plain(merged, ix, *ws, g6)
        want64 = ik.interp_rows_backward_plain(
            merged.double(), ix, *(w.double() for w in ws), g6.double())
        errs = [nearer_error(got[0], want[0], want64[0])[0]] + [
            nearer_error(a, b, c)[0]
            for a, b, c in zip(got[1], want[1], want64[1])]
        same = torch.equal(got[0], again[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], again[1]))
        worst = max(worst, *errs)
        if max(errs) > 1e-6 or not same:
            fail(f"K10b: errors {errs} (table, w0, w1, w2), repeat "
                 f"bit-equal {same}")
    ms, plain_ms = timed_pair(
        lambda: ik.interp_rows_backward(merged, idx, *ws, g6),
        lambda: ik.interp_rows_backward_plain(merged, idx, *ws, g6), 5)
    b_ms, b_by = bound(8 * p + 4 * 6 * filled + 12 * filled
                       + 2 * 4 * merged.numel() + 12 * p, 4 * 18 * filled)
    report["interp_rows_backward"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    print(f"[K10b] interp_rows_backward cow staged (6, {p}) cotangent: table "
          f"and weight gradients within {worst:.3g} of their max (nearer "
          f"of the float32 / float64 plain versions), also with -1 / "
          f"out-of-range indices, repeat bit-equal; {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) | {smi}",
          flush=True)


def synced_ms(fn, reps=3):
    """(result of the last call, median host ms per call ending in a device
    synchronisation)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


TARGET_REPS = 5


def phase_target(dev, smi, report):
    """init_target('cube', 256): the reference's K=1 Hard-Phong target on
    the staged route (the median of TARGET_REPS synchronised calls after a
    warm-up); the share of its cube pixels equal (every channel
    within 1e-5) to the flat fused HardRast + HardAgg target [train]
    uses, on the same pose; get_hard_rendering of the cow (binned select)
    with its select / shade split."""
    r_true = ptt.random_rotations(1, torch.Generator().manual_seed(2027),
                                  device="cpu").to(dev)
    def target_call():
        return harness.init_target(category="cube", imsize=IMAGE,
                                   R_true=r_true, device=dev)
    target_call()                                   # warm-up
    reset_counts()
    out, target_ms = synced_ms(target_call, TARGET_REPS)
    counts = all_counts()
    target = out[3][0]
    if (tuple(target.shape) != (IMAGE, IMAGE, 3)
            or not bool(torch.isfinite(target).all())
            or counts["gather_rows_cm"] < 1
            or counts["fused_forward"] + counts["fused_stream_forward"]):
        fail(f"target: shape {tuple(target.shape)}, launches {counts}")
    cover = (target.sum(-1) > 0).float().mean().item()
    if not 0.02 < cover < 0.6:
        fail(f"target: coverage share {cover}")

    # The same pose of [train]'s cube x2 through both renderers.
    r, t, lights = scene(dev)
    cams = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=dev)
    mesh = cube_mesh(dev)
    posed = mesh.update_padded(ptt.Rotate(r_true).transform_points(
        mesh.verts))
    *_x, train_target = train_setup(dev, r_true, 5)
    hard = harness.get_hard_rendering(posed, cams, lights, IMAGE)[0, ..., :3]
    fg = (hard.sum(-1) > 0) | (train_target.sum(-1) > 0)
    equal = ((hard - train_target).abs() <= 1e-5).all(dim=-1)
    share = equal[fg].float().mean().item()

    # The cow through get_hard_rendering: select + derive, then shade.
    cow = posed_cow(torch.Generator().manual_seed(5), dev, n=1)
    settings = ptt.RasterizationSettings(
        image_size=IMAGE, blur_radius=0.0, faces_per_pixel=1,
        max_faces_per_bin=100000)
    if settings.resolve_binning(cow.max_faces)[0] == 0:
        fail("target: the cow does not bin")
    harness.get_hard_rendering(cow, cams, lights, IMAGE)
    rast = ptt.MeshRasterizer(cams, settings)
    shader = ptt.HardPhongShader.create(
        cameras=cams, lights=lights,
        blend_params=ptt.BlendParams(background_color=(0.0, 0.0, 0.0)),
        device=dev)
    frags, select_ms = synced_ms(lambda: rast(cow))
    img, shade_ms = synced_ms(lambda: shader(frags, cow))
    _img, render_ms = synced_ms(
        lambda: harness.get_hard_rendering(cow, cams, lights, IMAGE))
    if not bool(torch.isfinite(img).all()) or not (
            0.02 < (img[..., 3] > 0.5).float().mean().item() < 0.6):
        fail("target: the cow's Hard-Phong render")
    report["target"] = dict(share=share)
    print(f"[target] init_target('cube', {IMAGE}) on the staged route (K=1 "
          f"Hard-Phong): launches in {TARGET_REPS} calls {counts}, median "
          f"{target_ms:.3f} ms per call after a warm-up, coverage "
          f"{cover:.3f}; cube pixels equal (within 1e-5) to [train]'s flat "
          f"fused HardRast + HardAgg target: {share:.5f} of {int(fg.sum())} "
          f"covered; the cow (5120 faces, binned select) through "
          f"get_hard_rendering: {render_ms:.3f} ms per render, rasterize "
          f"(select + derive) {select_ms:.3f} ms, shade + blend "
          f"{shade_ms:.3f} ms (host clock, synchronised) | {smi}",
          flush=True)


def staged_and_fused(rend, mesh, w, fused: bool, seeds=None):
    """(image, grads to the vertices, sigma, gamma, fwd ms, bwd ms) of
    sum(image * w), staged (rasterizer.planar + shader) or fused
    (MeshRenderer); ``seeds`` (N, 4) int32 (fused: zeros, staged: drawn
    from a generator seeded 0 when None)."""
    verts = mesh.verts.detach().clone().requires_grad_()
    sh = rend.shader
    sigma = sh.smoothrast.sigma.detach().clone().to(mesh.device) \
        .requires_grad_()
    gamma = sh.smoothagg.gamma.detach().clone().to(mesh.device) \
        .requires_grad_()
    sh = dataclasses.replace(
        sh, smoothrast=dataclasses.replace(sh.smoothrast, sigma=sigma),
        smoothagg=dataclasses.replace(sh.smoothagg, gamma=gamma))
    r = rend.replace(shader=sh)
    m = mesh.update_padded(verts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if fused:
        img = r(m, seeds=seeds if seeds is not None else torch.zeros(
            mesh.batch_size, 4, dtype=torch.int32))
    else:
        img = r.shader(r.rasterizer.planar(m), m, seeds=seeds)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(torch.sum(img * w), [verts, sigma, gamma])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return img.detach(), grads, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def stream_grads64(rend, mesh, g_out):
    """(vertex, sigma, gamma) gradients of sum(image * g_out) by the stream
    route's plain backward evaluated in float64; the table's gradient is
    carried to the vertices through the preparation's float32 backward,
    which has no thin-face terms."""
    verts = mesh.verts.detach().clone().requires_grad_()
    cfg, (tab, scal, rows, count, active, seeds) = kernel_inputs(
        rend, mesh.update_padded(verts),
        torch.zeros(mesh.batch_size, 4, dtype=torch.int32))
    args = tuple(a.detach().double() if a.is_floating_point() else a
                 for a in (tab, rows, count, active, scal, seeds))
    g_tab, g_scal = fr.stream_backward_plain(cfg, *args, g_out.double())
    (g_verts,) = torch.autograd.grad(tab, [verts], g_tab.float())
    return (g_verts, g_scal[:, fr._S_SIGMA].sum().item(),
            g_scal[:, fr._S_GAMMA].sum().item())


def thin_vertex_bounds(rend, mesh, tol):
    """((N, V) float64, (N, V) bool): each vertex's bound over the max
    |grad|, and whether it is a corner of a thin face.  The bound is
    ``tol`` plus, for each face of height h over its longest edge L below
    checks.THIN_NOISE / tol that the vertex is a corner of,
    checks.THIN_NOISE * L / h: checks.stream_grads_close's bound of a thin
    row, summed over the faces as the vertex's gradient sums their
    corners'."""
    faces = torch.clamp(mesh.faces, min=0)
    fv = gk.take_rows_batched(
        rend.rasterizer.cameras.transform_points_ndc(mesh.verts),
        faces).reshape(mesh.batch_size, -1, 9)
    thinness = checks.face_thinness(fv)                         # (N, F)
    thin = thinness < checks.THIN_NOISE / tol
    per_face = torch.where(thin, checks.THIN_NOISE
                           / thinness.clamp(min=1e-30), 0.0)
    extra = torch.zeros(mesh.verts.shape[:2], dtype=torch.float64,
                        device=mesh.device)
    hit = torch.zeros_like(extra, dtype=torch.bool)
    for b in range(mesh.batch_size):
        extra[b].index_add_(0, faces[b].reshape(-1),
                            per_face[b].repeat_interleave(3))
        hit[b, faces[b][thin[b]].reshape(-1)] = True
    return tol + extra, hit


def phase_staged_softras(dev, smi, report):
    """RandomPhongShader(SoftRast, SoftAgg) at the main path's sigma /
    gamma through rasterizer.planar + shader(...) at 256^2, K=50, N=4 on
    the cube and the cow: forward, then the gradient of an image
    objective to the vertices, sigma and gamma — the staged route's main
    path (launch counts reset just before, read just after).  Held
    against the fused route on the same poses: K3 / K4 on the cube, K5 /
    K6 on the cow; image atol 2e-5, gradients within 1e-4 of their max.
    On the cow the pixels whose slot K-1 is filled (the staged route keeps
    K faces, the stream route all) are left out of the objective and the
    images; the vertices of faces too thin for float32 to resolve 1e-4
    (``thin_vertex_bounds``) are held to 1e-4 plus the thin faces' bounds,
    against the nearer of K6 and the float64 plain version, as
    ``checks.stream_grads_close`` holds a thin row."""
    cases = {"cube": posed_cube(torch.Generator().manual_seed(0), dev),
             "cow": posed_cow(torch.Generator().manual_seed(0), dev)}
    rend = staged_renderer("softras", dev)
    gen = torch.Generator().manual_seed(6)
    w = torch.randn(N_POSES, IMAGE, IMAGE, 4, generator=gen).to(dev)
    staged, masks = {}, {}
    for name, mesh in cases.items():           # warm-up, and the masks
        with torch.no_grad():
            p2f = rend.rasterizer.planar(mesh).pix_to_face
        masks[name] = (p2f[..., K - 1] < 0)[..., None].float()
        staged_and_fused(rend, mesh, w * masks[name], False)
    reset_counts()
    for name, mesh in cases.items():
        staged[name] = staged_and_fused(rend, mesh, w * masks[name], False)
    counts = all_counts()
    needed = ("gather_rows_cm", "scatter_rows_cm", "interp_rows",
              "interp_rows_backward")
    if any(counts[k] < 1 for k in needed) or any(
            counts[k] for k in fr.launch_counts):
        fail(f"staged-softras: launch counts {counts}")
    for k in needed:
        report[k]["launches"] = counts[k]
    lines = []
    for name, mesh in cases.items():
        img_s, g_s, fwd_ms, bwd_ms = staged[name]
        img_f, g_f, _f, _b = staged_and_fused(rend, mesh, w * masks[name],
                                              True)
        mode = rend.plan(mesh).mode
        if mode != ("flat" if name == "cube" else "stream"):
            fail(f"staged-softras: the {name} takes the {mode} route")
        keep = masks[name]
        d_img = ((img_s - img_f).abs() * keep).max().item()
        d_verts = (g_s[0] - g_f[0]).abs().amax(-1)              # (N, V)
        errs = {gname: ((a - b).abs().max() / b.abs().max()).item()
                for gname, a, b in zip(("sigma", "gamma"), g_s[1:], g_f[1:])}
        ref64, thin_ok, n_thin = "", True, 0
        if name == "cube":
            errs["verts"] = (d_verts.max() / g_f[0].abs().max()).item()
        else:
            v64, s64, g64 = stream_grads64(rend, mesh, w * keep)
            vbound, vthin = thin_vertex_bounds(rend, mesh, 1e-4)
            n_thin = int(vthin.sum())
            scale = g_f[0].abs().amax(-1)[~vthin].max().item()
            errs["verts"] = d_verts[~vthin].max().item() / scale
            near = torch.minimum(d_verts, (g_s[0] - v64).abs().amax(-1))
            share = (near[vthin].double() / scale / vbound[vthin]).max()
            thin_ok = share.item() <= 1.0
            ref64 = (f"; the {n_thin} vertices of thin faces within "
                     f"{share.item():.3g} of their bound against the nearer "
                     f"of K6 and the float64 plain version")
            if max(errs["sigma"], errs["gamma"]) > 1e-4:
                # sigma / gamma sum terms that cancel over every pixel and
                # row: hold them against the nearer of K6 and the float64
                # plain version, as checks.stream_grads_close holds the
                # scalars.
                for gname, a, b, r64 in zip(("sigma", "gamma"), g_s[1:],
                                            g_f[1:], (s64, g64)):
                    a = a.double().item()
                    errs[gname] = (min(abs(a - b.item()), abs(a - r64))
                                   / abs(r64))
                ref64 += (f", sigma / gamma too ({s64:.9g} / {g64:.9g}; "
                          f"K6 {g_f[1].item():.9g} / {g_f[2].item():.9g}, "
                          f"staged {g_s[1].item():.9g} / "
                          f"{g_s[2].item():.9g})")
        if d_img > 2e-5 or max(errs.values()) > 1e-4 or not thin_ok or \
                not all(bool(torch.isfinite(g).all()) for g in g_s):
            fail(f"staged-softras {name}: image {d_img}, gradients {errs}"
                 f"{ref64}")
        lines.append(f"{name} ({mode} route to compare): image max |d| "
                     f"{d_img:.3g}, gradients verts {errs['verts']:.3g} / "
                     f"sigma {errs['sigma']:.3g} / gamma {errs['gamma']:.3g} "
                     f"of max (outside the {n_thin} vertices of thin "
                     f"faces; {int((keep == 0).sum())} pixels with slot K-1 "
                     f"filled left out{ref64}); staged forward "
                     f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms")
    print(f"[staged-softras] RandomPhongShader(SoftRast, SoftAgg) sigma "
          f"{SIGMA} gamma {GAMMA}, {IMAGE}^2 K={K} N={N_POSES}, "
          f"rasterizer.planar + shader: launches {counts}; "
          + "; ".join(lines) + f" | {smi}", flush=True)


# ---------------------------------------------------------------------------
# The staged route's Monte-Carlo estimators: K8a (perturbed Heaviside), K8b
# (perturbed argmax) and K8c (its gradients)
# ---------------------------------------------------------------------------

OPS_DRAW = {"gaussian": 10, "cauchy": OPS_CAUCHY, "uniform": 3}
STAGED_NOISES = ("gaussian", "cauchy", "uniform")


def staged_estimator_inputs(dev):
    """The cow's staged estimator inputs at 256^2, K=50, N=4 (13.1 M
    slots): -dists (N, H, W, K), the GaussianAgg z_map (N, H, W, K + 1) of
    the gaussian coverage, a seeded cotangent of the z_map, sigma, gamma
    and the (N, 2) seed words of coverage and aggregation."""
    from pertrenderer_tpu_torch.models import shaders, smoothagg

    rend = staged_renderer("gaussian", dev)
    mesh = posed_cow(torch.Generator().manual_seed(0), dev)
    seeds = fr.draw_seeds(N_POSES, torch.Generator().manual_seed(1),
                          device=dev)
    rs, ags = seeds[:, :2].contiguous(), seeds[:, 2:].contiguous()
    sigma = torch.tensor(SIGMA, device=dev)
    gamma = torch.tensor(GAMMA, device=dev)
    with torch.no_grad():
        pfrag = rend.rasterizer.planar(mesh)
        d = (-pfrag.dists).contiguous()
        mask = pfrag.pix_to_face >= 0
        prob = pk.heaviside_mean(d, sigma, rs, S, "gaussian") * mask
        znear, zfar = shaders._znear_zfar(rend.rasterizer.cameras, {})
        z = smoothagg._z_map(gamma, torch.tensor(1.0, device=dev), 1e-10,
                             pfrag.zbuf, zfar, znear, prob,
                             mask).contiguous()
    g = torch.randn(z.shape, generator=torch.Generator().manual_seed(7)).to(
        dev)
    return d, z, g, sigma, gamma, rs, ags


def estimator_close(got, want):
    """(ok, max |d|, mean |d|, share of elements beyond 1e-4): a forward
    estimator on shared noise, where only ulp-level threshold flips may
    differ (PERF.md's MC tolerance: mean |d| <= 1e-5, >= 99.9% within
    1e-4)."""
    d = (got - want).abs()
    flips = (d > 1e-4).float().mean().item()
    ok = (bool(torch.isfinite(got).all()) and d.mean().item() <= 1e-5
          and flips <= 1e-3)
    return ok, d.max().item(), d.mean().item(), flips


def grad_close(got, want, tol=1e-3):
    """(ok, error over max |want|) of an MC gradient on shared noise."""
    err = ((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30)).item()
    return bool(torch.isfinite(got).all()) and err <= tol, err


def phase_k8(dev, smi, report):
    """K8a, K8b and K8c against their plain versions on the card at the
    cow's staged shapes (256^2, K=50, N=4, S=8: 13.1 M coverage slots, a
    (4, 65536, 51) z_map), with the gaussian, cauchy and uniform families
    (uniform is forward-only): outside K8a's band (``heaviside_band``) and
    K8b's candidates (``argmax_candidates``, and every channel of a pixel
    with one candidate), which the kernels write without a draw, bit-equal;
    the rest of a forward at the MC tolerance on shared noise
    (``estimator_close``), gradients within 1e-3 of their max, two
    launches bit-equal.  Beside each time: the band's share of the
    elements and the candidates per pixel (mean, p99, the share of pixels
    with one).  Times in CUDA events (plain, kernel, kernel, plain); the
    bound is the larger of the bytes (each input read once, each output
    written once) over 3.35 TB/s and the float32 operations this run's
    data needs (a draw, the threshold or argmax and the accumulations per
    drawn element or candidate and sample; the hash left out) over 67
    TFLOP/s.  No single PyTorch call computes the hashed estimator: no
    library time.  Then K8c at C = 600 (above 16 channels per lane: the
    wide path), within 1e-3 of its plain version's max, repeats
    bit-equal."""
    ptx = ptxas_report(tuple(f"argmax_grads_kernelILi{j}E"
                             for j in (1, 2, 3, 4, 8, 16, 0)))
    print("[K8c] ptxas (channels per lane J; J=0 the wide path above 512 "
          "channels): " + "; ".join(
              f"J={k[len('argmax_grads_kernelILi'):-1]} {sorted(set(v))[0]}"
              for k, v in ptx.items()), flush=True)
    for tag, name in (("K8a", "heaviside_kernel"),
                      ("K8b", "argmax_mean_kernel")):
        lines = ptxas_report((name,)).get(name, ["not in the build log"])
        print(f"[{tag}] ptxas {name}: {' | '.join(sorted(set(lines)))}",
              flush=True)
    d, z, g, sigma, gamma, rs, ags = staged_estimator_inputs(dev)
    nd, nz, npx = d.numel(), z.numel(), z.numel() // z.shape[-1]
    out = {}
    for noise in STAGED_NOISES:
        grads = noise in pk.GRAD_NOISES
        band = pk.heaviside_band(d, sigma, noise)
        cand = pk.argmax_candidates(z, gamma, noise)
        per_px = cand.sum(-1)
        single = (per_px == 1)[..., None]
        exact_z = ~cand | single
        n_band = int(band.sum())
        n_drawn = int((cand & ~single).sum())
        band_text = (f"band |d| <= sigma B holds {n_band / nd:.4f} of the "
                     f"elements")
        cand_text = (f"candidates per pixel mean "
                     f"{per_px.float().mean().item():.3f}, p99 "
                     f"{torch.quantile(per_px.float().flatten(), 0.99).item():g}"
                     f", one candidate on {single.float().mean().item():.4f}"
                     f" of pixels")
        calls = {"heaviside_mean": (
            lambda: pk.heaviside_mean(d, sigma, rs, S, noise),
            lambda: pk.heaviside_mean_plain(d, sigma, rs, S, noise),
            8 * nd, n_band * S * (OPS_DRAW[noise] + OPS_COVER), band)}
        if grads:
            calls["heaviside_coeff"] = (
                lambda: pk.heaviside_coeff(d, sigma, rs, S, noise),
                lambda: pk.heaviside_coeff_plain(d, sigma, rs, S, noise,
                                                 True),
                8 * nd, n_band * S * (OPS_DRAW[noise] + OPS_COVER
                                      + OPS_COVER_BWD), band)
        calls["argmax_mean"] = (
            lambda: pk.argmax_mean(z, gamma, ags, S, noise),
            lambda: pk.argmax_mean_plain(z, gamma, ags, S, noise),
            8 * nz, n_drawn * S * (OPS_DRAW[noise] + OPS_AGG), ~exact_z)
        if grads:
            calls["argmax_grads"] = (
                lambda: pk.argmax_grads(z, g, gamma, ags, S, noise),
                lambda: pk.argmax_grads_plain(z, g, gamma, ags, S, noise,
                                              True),
                12 * nz + 4 * npx,
                nz * S * (OPS_DRAW[noise] + OPS_AGG + OPS_AGG_BWD), None)
        for kname, (kern, plain, nbytes, ops, drawn) in calls.items():
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            exact = True
            if drawn is not None:
                exact = torch.equal(got[~drawn], want[~drawn])
            if kname == "argmax_grads":
                oks = [grad_close(a, b) for a, b in zip(got, want)]
                ok, err = all(o for o, _ in oks), max(e for _, e in oks)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                text = f"grad_z and gamma term within {err:.3g} of max"
            elif kname == "heaviside_coeff":
                ok, err = grad_close(got, want)
                same = torch.equal(got, again)
                text = (f"within {err:.3g} of max, bit-equal outside the "
                        f"band; {band_text}")
            else:
                ok, err, dmean, flips = estimator_close(got, want)
                same = torch.equal(got, again)
                text = (f"max |d| {err:.3g}, mean |d| {dmean:.3g}, elements "
                        f"beyond 1e-4 {flips:.3g}, bit-equal outside the "
                        + (f"band; {band_text}" if drawn is band else
                           f"candidates; {cand_text}"))
            if not ok or not same or not exact:
                fail(f"{kname} {noise}: {text}, repeat bit-equal {same}, "
                     f"bit-equal where no draw is made {exact}")
            k_ms, p_ms = timed_pair(kern, plain, 10, 1)
            b_ms, b_by = bound(nbytes, ops)
            out[(kname, noise)] = (err, k_ms, p_ms, b_ms, b_by)
            tag = {"heaviside_mean": "K8a", "heaviside_coeff": "K8a",
                   "argmax_mean": "K8b", "argmax_grads": "K8c"}[kname]
            shape = tuple(d.shape) if tag == "K8a" else tuple(z.shape)
            print(f"[{tag}] {kname} {noise} cow staged {shape} S={S}: "
                  f"{text} vs plain on shared noise, repeat bit-equal; "
                  f"{k_ms:.4f} ms vs plain {p_ms:.2f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}) | {smi}", flush=True)
    k8c_wide(dev, smi)
    # The kernels line: K8a is the forward and its backward coefficient
    # together (both entry points), K8b and K8c one call each; gaussian.
    mean, coeff = out[("heaviside_mean", "gaussian")], \
        out[("heaviside_coeff", "gaussian")]
    report["perturbed_heaviside"] = dict(
        max_abs_err=max(mean[0], coeff[0]), ms=mean[1] + coeff[1],
        plain_ms=mean[2] + coeff[2], bound_ms=mean[3] + coeff[3],
        bound_by=mean[4], library_ms=None)
    for kname in ("argmax_mean", "argmax_grads"):
        err, k_ms, p_ms, b_ms, b_by = out[(kname, "gaussian")]
        report[kname] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None)


K8C_WIDE = 600      # channels of [K8c]'s wide case (16 per lane is 512)


def k8c_wide(dev, smi):
    """K8c at C = 600 (argmax_grads_wide: the lane's channels sample by
    sample) on a seeded (2, 4096, 600) z and cotangent, gaussian, S=8,
    with and without variance reduction: within 1e-3 of the plain
    version's max, repeats bit-equal."""
    gen = torch.Generator().manual_seed(12)
    z = torch.randn(2, 4096, K8C_WIDE, generator=gen).to(dev)
    g = torch.randn(2, 4096, K8C_WIDE, generator=gen).to(dev)
    gamma = torch.tensor(0.5, device=dev)
    seeds = fr.draw_seeds(2, gen, device=dev)[:, 2:].contiguous()
    for vr in (True, False):
        kern = lambda: pk.argmax_grads(z, g, gamma, seeds, S, "gaussian", vr)
        got, again = kern(), kern()
        want = pk.argmax_grads_plain(z, g, gamma, seeds, S, "gaussian", vr)
        torch.cuda.synchronize()
        oks = [grad_close(a, b) for a, b in zip(got, want)]
        err = max(e for _, e in oks)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not all(o for o, _ in oks) or not same:
            fail(f"K8c C={K8C_WIDE} vr={vr}: within {err} of max, repeat "
                 f"bit-equal {same}")
        k_ms = cuda_ms(kern, 3)
        print(f"[K8c] argmax_grads gaussian C={K8C_WIDE} (wide path) "
              f"{tuple(z.shape)} S={S} variance reduction {vr}: grad_z and "
              f"gamma term within {err:.3g} of max vs plain, repeat "
              f"bit-equal; {k_ms:.4f} ms | {smi}", flush=True)


MC_PAIRS = {"gaussian": (ptt.GaussianRast, ptt.GaussianAgg),
            "gaussian_wovr": (ptt.GaussianRast_wovr, ptt.GaussianAgg_wovr),
            "cauchy": (ptt.ArctanRast, ptt.CauchyAgg)}
STAGED_MC_CASES = (("cube", "gaussian"), ("cube", "gaussian_wovr"),
                   ("cube", "cauchy"), ("cow", "gaussian"))
STAGED_MC_SEEDS = 64
STAGED_MC_RATIO = 1.5
STAGED_MC_Z = 4.0


def mc_renderer(noise, dev):
    """The staged renderer (K=50, no bin drops) with the MC pair
    ``noise`` at the main path's sigma / gamma / S."""
    rend = staged_renderer("softras", dev)
    sr, sa = MC_PAIRS[noise]
    return rend.replace(shader=dataclasses.replace(
        rend.shader, smoothrast=sr.create(sigma=SIGMA, nb_samples=S),
        smoothagg=sa.create(gamma=GAMMA, nb_samples=S)))


def phase_staged_mc(dev, smi, report):
    """RandomPhongShader with the MC pairs through rasterizer.planar +
    shader(...) at 256^2, K=50, N=4 (the gaussian pair on the cube and the
    cow, the _wovr and cauchy pairs on the cube): forward, then the
    gradient of sum(image * w) to the vertices, sigma and gamma — the
    staged route's MC path (launch counts reset just before the staged
    runs and read just after: K8a, K8b and K8c launched, no plain version
    taken).  Oracle: the fused route on the same poses at the same sigma,
    gamma and S (K3 / K4 on the cube, K5 / K6 on the cow), which draws
    other noise.  For each of STAGED_MC_SEEDS seed words (N, 4) i: the
    staged run with seeds a_i, a fused run with seeds b_i and a second
    fused run with seeds c_i.  The criterion, fixed before the first run:
    for the image, the vertex gradients and sigma, the RMS over the runs
    (and the elements) of staged_i - fused_i is at most STAGED_MC_RATIO =
    1.5 times the RMS of fused_i - fused'_i: estimators of equal mean and
    spread give a ratio near 1, a bias raises it; with 64 seed words the
    ratio of a scalar's two RMS exceeds 1.5 by chance with probability
    ~1e-3.  For gamma the mean difference over its standard error (64
    staged runs against 128 fused) is at most STAGED_MC_Z = 4 in
    magnitude: the staged gamma gradient's phi sums the noise of all K + 1
    channels, where the fused routes put its mean for the channels that
    hold no face (flat: K - bg_row; stream: K less the visited rows), so
    its spread differs by design and only its mean is held (its RMS ratio
    is reported).  On the cow the pixels whose slot K-1 fills (the staged
    route keeps K faces, the stream route all) are left out of the
    objective and the image."""
    meshes = {"cube": posed_cube(torch.Generator().manual_seed(0), dev),
              "cow": posed_cow(torch.Generator().manual_seed(0), dev)}
    w = torch.randn(N_POSES, IMAGE, IMAGE, 4,
                    generator=torch.Generator().manual_seed(6)).to(dev)
    gen = torch.Generator().manual_seed(2031)
    seeds = [[fr.draw_seeds(N_POSES, gen, device=dev) for _ in range(3)]
             for _ in range(STAGED_MC_SEEDS)]
    masks = {}
    for name, mesh in meshes.items():
        with torch.no_grad():
            p2f = staged_renderer("softras", dev).rasterizer.planar(
                mesh).pix_to_face
        masks[name] = (p2f[..., K - 1] < 0)[..., None].float()
    rends = {noise: mc_renderer(noise, dev) for noise in MC_PAIRS}
    for name, noise in STAGED_MC_CASES:            # warm-up
        staged_and_fused(rends[noise], meshes[name], w * masks[name], False,
                         seeds[0][0])
    reset_counts()
    plain0 = dict(pk.plain_calls)
    staged = {case: [] for case in STAGED_MC_CASES}
    t0 = time.perf_counter()
    for name, noise in STAGED_MC_CASES:
        for i in range(STAGED_MC_SEEDS):
            img, g, _f, _b = staged_and_fused(
                rends[noise], meshes[name], w * masks[name], False,
                seeds[i][0])
            staged[(name, noise)].append((img, *g))
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    counts = all_counts()
    needed = ("heaviside_mean", "heaviside_coeff", "argmax_mean",
              "argmax_grads")
    if any(counts[k] < 1 for k in needed) or pk.plain_calls != plain0 or any(
            counts[k] for k in fr.launch_counts):
        fail(f"staged-mc: launch counts {counts}, plain calls "
             f"{pk.plain_calls}")
    report["perturbed_heaviside"]["launches"] = (
        counts["heaviside_mean"] + counts["heaviside_coeff"])
    for k in ("argmax_mean", "argmax_grads"):
        report[k]["launches"] = counts[k]
    lines = []
    for name, noise in STAGED_MC_CASES:
        mesh, keep = meshes[name], masks[name]
        mode = rends[noise].plan(mesh).mode
        if mode != ("flat" if name == "cube" else "stream"):
            fail(f"staged-mc: the {name} takes the {mode} route")
        sq_sf, sq_ff = [0.0] * 4, [0.0] * 4
        scal_s, scal_f = ([], []), ([], [])         # sigma, gamma values
        for i in range(STAGED_MC_SEEDS):
            fa = staged_and_fused(rends[noise], mesh, w * keep, True,
                                  seeds[i][1])
            fb = staged_and_fused(rends[noise], mesh, w * keep, True,
                                  seeds[i][2])
            fa, fb = (fa[0], *fa[1]), (fb[0], *fb[1])
            st = staged[(name, noise)][i]
            for j in range(4):
                a, b, c = st[j], fa[j], fb[j]
                if j == 0:
                    a, b, c = a * keep, b * keep, c * keep
                if not bool(torch.isfinite(a).all()):
                    fail(f"staged-mc {name} {noise}: non-finite output {j}")
                sq_sf[j] += ((a - b).double() ** 2).sum().item()
                sq_ff[j] += ((b - c).double() ** 2).sum().item()
                if j >= 2:
                    scal_s[j - 2].append(a.item())
                    scal_f[j - 2].extend((b.item(), c.item()))
        ratios = [math.sqrt(a / max(b, 1e-300)) for a, b in zip(sq_sf, sq_ff)]
        zs = [(statistics.fmean(a) - statistics.fmean(b)) / max(math.sqrt(
            statistics.variance(a) / len(a) + statistics.variance(b)
            / len(b)), 1e-300) for a, b in zip(scal_s, scal_f)]
        text = (" / ".join(f"{q} {r:.3f}" for q, r in zip(
            ("image", "verts", "sigma", "gamma"), ratios))
            + f"; mean difference over its standard error: sigma "
              f"{zs[0]:.2f}, gamma {zs[1]:.2f} (gamma staged "
              f"{statistics.fmean(scal_s[1]):.6g} +- "
              f"{statistics.stdev(scal_s[1]):.3g}, fused "
              f"{statistics.fmean(scal_f[1]):.6g} +- "
              f"{statistics.stdev(scal_f[1]):.3g})")
        if max(ratios[:3]) > STAGED_MC_RATIO or abs(zs[1]) > STAGED_MC_Z:
            fail(f"staged-mc {name} {noise}: RMS staged-fused over "
                 f"fused-fused {text} (limits: ratio {STAGED_MC_RATIO} for "
                 f"the image, verts and sigma; |z| {STAGED_MC_Z} for gamma)")
        lines.append(f"{name} {noise} ({mode} route as the oracle): "
                     f"{text}")
    print(f"[staged-mc] RandomPhongShader MC pairs sigma {SIGMA} gamma "
          f"{GAMMA} S={S}, {IMAGE}^2 K={K} N={N_POSES}, rasterizer.planar + "
          f"shader, forward and gradient, {STAGED_MC_SEEDS} seed words per "
          f"case: {len(STAGED_MC_CASES) * STAGED_MC_SEEDS} staged runs in "
          f"{staged_s:.1f} s, launches {counts}, no plain version; RMS of "
          f"staged - fused over RMS of fused - fused' (limit "
          f"{STAGED_MC_RATIO}; gamma: |z| <= {STAGED_MC_Z}): "
          + "; ".join(lines) + f" | {smi}", flush=True)


def phase_staged_uniform(dev, smi, report):
    """RandomPhongShader(AffineRast, UniformAgg) on the cow at 256^2, N=4
    through MeshRenderer.forward: the planner itself sends it staged
    (UniformAgg is not a fused menu member).  plan()'s reason, the median
    latency of 5 calls after a warm-up (host clock ending in a
    synchronisation), and K8b's launches (AffineRast is deterministic:
    no K8a)."""
    rend = staged_renderer("softras", dev)
    rend = rend.replace(shader=dataclasses.replace(
        rend.shader, smoothrast=ptt.AffineRast.create(sigma=SIGMA,
                                                      nb_samples=S),
        smoothagg=ptt.UniformAgg.create(gamma=GAMMA, nb_samples=S)))
    mesh = posed_cow(torch.Generator().manual_seed(0), dev)
    plan = rend.plan(mesh)
    if plan.mode != "staged":
        fail(f"staged-uniform: plan {plan}")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        rend(mesh, generator=gen)                      # warm-up
        reset_counts()
        img, lat = synced_ms(lambda: rend(mesh, generator=gen), 5)
    counts = all_counts()
    if (tuple(img.shape) != (N_POSES, IMAGE, IMAGE, 4)
            or not bool(torch.isfinite(img).all())
            or counts["argmax_mean"] != 5 or counts["heaviside_mean"]
            or any(counts[k] for k in fr.launch_counts)):
        fail(f"staged-uniform: shape {tuple(img.shape)}, launches {counts}")
    cover = (img[..., 3] > 0.5).float().mean().item()
    report["staged_uniform"] = dict(ms=lat)
    print(f"[staged-uniform] RandomPhongShader(AffineRast, UniformAgg) cow "
          f"{IMAGE}^2 K={K} N={N_POSES} through MeshRenderer.forward: plan "
          f"{plan.mode} ({plan.reason}); median {lat:.3f} ms per request "
          f"of 5 after a warm-up; launches {counts}; alpha > 0.5 on "
          f"{cover:.3f} of pixels | {smi}", flush=True)


LARGE_IMAGE = 2304


def phase_large(dev, smi, report):
    """One request above the fused kernels' 2048 limit through
    MeshRenderer.forward: the gaussian pair on the cube, N=1, 2304^2,
    K=50 (the planner sends it staged).  The latency of the first call
    and the median of 3 more, and torch.cuda.max_memory_allocated over
    them.  If K=50 does not fit in the card's memory, that is reported
    with the largest K of 50, 40, 32, 25, 16, 8 that does."""
    rend = headline_renderer("gaussian", dev, n=1, size=LARGE_IMAGE)
    mesh = cube_mesh(dev)
    plan = rend.plan(mesh)
    if plan.mode != "staged":
        fail(f"large: plan {plan}")
    gen = torch.Generator().manual_seed(4)
    notes = []
    for k in (50, 40, 32, 25, 16, 8):
        r = rend
        if k != K:
            r = rend.replace(rasterizer=ptt.MeshRasterizer(
                rend.rasterizer.cameras, dataclasses.replace(
                    rend.rasterizer.raster_settings, faces_per_pixel=k)))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            with torch.no_grad():
                img, first = synced_ms(lambda: r(mesh, generator=gen), 1)
                img, lat = synced_ms(lambda: r(mesh, generator=gen), 3)
        except torch.OutOfMemoryError as e:
            notes.append(f"K={k} does not fit ({str(e).splitlines()[0]})")
            continue
        counts = all_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if (tuple(img.shape) != (1, LARGE_IMAGE, LARGE_IMAGE, 4)
                or not bool(torch.isfinite(img).all())
                or counts["heaviside_mean"] != 4
                or counts["argmax_mean"] != 4):
            fail(f"large: shape {tuple(img.shape)}, launches {counts}")
        cover = (img[..., 3] > 0.5).float().mean().item()
        report["large"] = dict(k=k, ms=lat, peak_gib=peak)
        print(f"[large] gaussian cube N=1 {LARGE_IMAGE}^2 K={k} through "
              f"MeshRenderer.forward: plan {plan.mode} ({plan.reason}); "
              f"first call {first:.1f} ms, then median {lat:.1f} ms of 3; "
              f"peak memory {peak:.2f} GiB (max_memory_allocated); "
              f"launches {counts}; alpha > 0.5 on {cover:.4f} of pixels"
              + (f"; {'; '.join(notes)}" if notes else "") + f" | {smi}",
              flush=True)
        return
    fail(f"large: no K fits: {notes}")


def phase_determinism(dev, smi):
    """Two preparations of the cow's stream inputs (N=4, 256^2), each
    back-propagated from a fixed cotangent of the table and scalars to
    the poses, with torch's default algorithms: the tables, scalars,
    vertex normals and pose gradients must repeat bit for bit.  A third
    preparation under torch.use_deterministic_algorithms(True,
    warn_only=True) lists the ops that have no deterministic
    implementation (torch swaps some ops for deterministic ones in that
    mode, so only the default mode's bits show atomics)."""
    import warnings

    mesh = cow_mesh(dev).extend(N_POSES)
    rend = headline_renderer("gaussian", dev)
    seeds = fr.draw_seeds(N_POSES, torch.Generator().manual_seed(1),
                          device=dev)
    log_rot0 = torch.linspace(-1.0, 1.0, N_POSES * 3, device=dev).reshape(
        N_POSES, 3)

    def once():
        log_rot = log_rot0.clone().requires_grad_()
        posed = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                                   .transform_points(mesh.verts))
        _cfg, (tab, scal, *_rest) = kernel_inputs(rend, posed, seeds)
        g = torch.Generator().manual_seed(0)
        g_tab = torch.randn(tab.shape, generator=g).to(dev)
        g_scal = torch.randn(scal.shape, generator=g).to(dev)
        (g_pose,) = torch.autograd.grad(
            (tab * g_tab).sum() + (scal * g_scal).sum(), [log_rot])
        torch.cuda.synchronize()
        return {"table": tab.detach(), "scalars": scal.detach(),
                "vertex normals": posed.verts_normals().detach(),
                "pose gradient": g_pose}

    runs = [once(), once()]
    same = {k: torch.equal(runs[0][k], runs[1][k]) for k in runs[0]}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            once()
    finally:
        torch.use_deterministic_algorithms(False)
    warned = sorted({str(x.message).split("\n")[0][:120] for x in caught
                     if "deterministic" in str(x.message)})
    print(f"[determinism] two preparations of the cow's stream inputs "
          f"(N=4) and their backward, default algorithms: bit-equal {same}; "
          f"ops without a deterministic implementation: "
          f"{warned or 'none'} | {smi}", flush=True)
    if not all(same.values()):
        fail("determinism: the preparation is not bit-equal from run to run")


# ---------------------------------------------------------------------------
# The binned route (K12): BASELINE config 5, the level-6 icosphere (81,920
# faces) at 512^2, K=150, M=160 slots in 2048 strip tiles of 128 pixels
# ---------------------------------------------------------------------------

C5_TRAIN_SIGMA, C5_TRAIN_GAMMA = 6e-3, 6e-2   # config5's coarse start


def binned_inputs(noise, dev, n, seed=0):
    """(cfg, K12 arguments, renderer) of the oracle's config-5 mesh at n
    random rotations (``noise`` gaussian at S=8, or softras)."""
    cams, lights = config5.scene(dev, n)
    rend = config5.renderer(cams, lights, noise, SIGMA, GAMMA, s=S,
                            device=dev)
    mesh = config5.icosphere_mesh(config5.LEVEL, "oracle", dev).extend(n)
    log_rot = torch.randn(n, 3, generator=torch.Generator().manual_seed(seed))
    mesh = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot.to(dev)))
                              .transform_points(mesh.verts))
    seeds = fr.draw_seeds(n, torch.Generator().manual_seed(1), device=dev)
    cfg, ins = kernel_inputs(rend, mesh, seeds)
    if not cfg.binned or cfg.f_pad != 160 or cfg.p_tile != 128:
        fail(f"config 5 did not take the binned route: {cfg}")
    return cfg, ins, rend


def binned_work(cfg, ins):
    """``work``'s counts for K12 on these inputs: geometry for every filled
    slot at every pixel of its tile; texel, shading, coverage, z_map,
    blend and the adjoints per candidate (slot, pixel); aggregation per
    live z_map row; the noise only for the draws those rows use."""
    n, c = ins[0].shape[0], cfg.c_zpad
    w = dict(pixels=n * cfg.image_size ** 2, faces=0, cand=0, live=0,
             grad_rows=0, rast_draw_ops=0, agg_draw_ops=0,
             agg_draw_ops_grad=0)
    draws = lambda rows, noise: (_pairs_used(rows) * OPS_PAIR
                                 if noise == "gaussian"
                                 else int(rows.sum().item()) * OPS_CAUCHY)
    with torch.no_grad():
        for t0, t1 in binned._tile_blocks(cfg, n):
            a = binned._block_args(cfg, [t[:, t0:t1] for t in ins[:4]],
                                   *ins[4:8], t0, t1)
            scal, px, py, act = a[5], a[8], a[9], a[10]
            sc = lambda i: scal[:, i].view(-1, 1, 1)
            cand = (fr._det1(cfg, px, py, *a[:5], sc)[-1] > 0) & act
            w["faces"] += int((a[4] > 0.5).sum().item()) * cfg.p_tile
            live = torch.zeros(cand.shape[0], c, cand.shape[-1],
                               dtype=torch.bool, device=cand.device)
            live[:, :cfg.f_pad] = cand
            live[:, cfg.bg_row] = True
            grad_px = (cand.any(dim=1) if cfg.agg_vr
                       else torch.ones_like(cand[:, 0]))
            up_to_bg = (torch.arange(c, device=cand.device).view(1, c, 1)
                        <= cfg.bg_row)
            grad_rows = up_to_bg & grad_px[:, None, :]
            w["cand"] += int(cand.sum().item())
            w["live"] += int(live.sum().item())
            w["grad_rows"] += int(grad_rows.sum().item())
            w["rast_draw_ops"] += draws(cand, cfg.rast_noise)
            w["agg_draw_ops"] += draws(live, cfg.agg_noise)
            w["agg_draw_ops_grad"] += draws(live | grad_rows, cfg.agg_noise)
    return w


def k12_grads_close(cfg, ins, kernel, plain, tol):
    """(ok, worst, where, thin rows, witness bins) of K12's gradients
    (``kernel(ins)``: (g_ndc, g_world, g_fn, g_tex, g_scal)) against the
    float32 or float64 plain version (``plain(ins)``) by
    ``checks.binned_grads_close``: every row and every scalar on the full
    arguments."""
    a64 = [t.double() if t.is_floating_point() else t for t in ins]
    return checks.binned_grads_close(cfg, ins[:4], kernel(ins), plain(ins),
                                     plain(a64), tol)


def phase_k12(dev, smi, report):
    """K12's forward (N=4), backward and loss-and-grad (N=1) on config 5
    against their plain versions, repeats bit-equal, the dual path."""
    rows = {}
    names = ("binned_forward_kernelILi160E", "binned_grad_kernelILi160ELb0",
             "binned_grad_kernelILi160ELb1")
    for name, lines in ptxas_report(names).items():
        print(f"[K12] ptxas {name}: {' | '.join(sorted(set(lines)))}",
              flush=True)
    for noise in ("gaussian", "softras"):
        mc = noise == "gaussian"
        cfg, ins, _rend = binned_inputs(noise, dev, N_POSES)
        got = binned.fused_binned_forward(cfg, *ins)
        again = binned.fused_binned_forward(cfg, *ins)
        want = binned.binned_forward_plain(cfg, *ins)
        torch.cuda.synchronize()
        if mc:
            ok, dmax, dmean, flips = mc_close(got, want)
        else:
            d = (got - want).abs()
            dmax, dmean, flips = d.max().item(), d.mean().item(), 0.0
            ok = bool(torch.isfinite(got).all()) and dmax <= 2e-5
        if not ok or not torch.equal(got, again):
            fail(f"K12 forward {noise}: max {dmax} mean {dmean} flips "
                 f"{flips}, repeat bit-equal {torch.equal(got, again)}")
        cover = (got[..., 3] > 0.5).float().mean().item()
        f_ms, fp_ms = timed_pair(
            lambda: binned.fused_binned_forward(cfg, *ins),
            lambda: binned.binned_forward_plain(cfg, *ins), 5, 1)
        w = binned_work(cfg, ins)
        fb_ms, fb_by = bound(tensor_bytes(ins) + 16 * w["pixels"],
                             forward_ops(cfg, w))
        print(f"[K12] fused_binned_forward {noise} config 5 (81920 faces, "
              f"{cfg.image_size}^2, M={cfg.f_pad}, {fr._n_tiles(cfg)} "
              f"tiles) N={N_POSES}: max |d| {dmax:.3g}, mean |d| "
              f"{dmean:.3g}, pixels beyond 1e-4 {flips:.3g}, alpha > 0.5 on "
              f"{cover:.3f}, repeat bit-equal; {w['cand']} candidate (slot, "
              f"pixel) pairs; {f_ms:.3f} ms vs plain {fp_ms:.1f} ms, bound "
              f"{fb_ms:.4f} ms ({fb_by}) | {smi}", flush=True)

        cfg, ins, _rend = binned_inputs(noise, dev, 1, seed=3)
        tol = 1e-3 if mc else 1e-4
        g_out = torch.randn(1, cfg.image_size, cfg.image_size, 4,
                            generator=torch.Generator().manual_seed(2)
                            ).to(dev)
        hw = cfg.image_size ** 2
        target = torch.rand(1, 3, hw, generator=torch.Generator()
                            .manual_seed(3)).to(dev)
        lscale = 1.0 / (3 * hw)
        bwd = binned.fused_binned_backward(cfg, *ins, g_out)
        bwd2 = binned.fused_binned_backward(cfg, *ins, g_out)
        cast = lambda a, t: t.double() if a[0].dtype == torch.float64 else t
        ok_b, err_b, where_b, thin_b, bins_b = k12_grads_close(
            cfg, ins, lambda a: binned.fused_binned_backward(cfg, *a, g_out),
            lambda a: binned.binned_backward_plain(cfg, *a,
                                                   cast(a, g_out)), tol)
        loss, *lg = binned.fused_binned_loss_grad(cfg, *ins, target,
                                                  "l2_rgb", lscale)
        loss2, *lg2 = binned.fused_binned_loss_grad(cfg, *ins, target,
                                                    "l2_rgb", lscale)
        w_loss, *_want = binned.binned_loss_grad_plain(cfg, *ins, target,
                                                       "l2_rgb", lscale)
        ok_l, err_l, where_l, thin_l, bins_l = k12_grads_close(
            cfg, ins, lambda a: binned.fused_binned_loss_grad(
                cfg, *a, target, "l2_rgb", lscale)[1:],
            lambda a: binned.binned_loss_grad_plain(
                cfg, *a, cast(a, target), "l2_rgb", lscale)[1:], tol)
        lerr = ((loss - w_loss).abs() / w_loss.abs()).max().item()
        same = (all(torch.equal(a, b) for a, b in zip(bwd, bwd2))
                and torch.equal(loss, loss2)
                and all(torch.equal(a, b) for a, b in zip(lg, lg2)))
        img = binned.fused_binned_forward(cfg, *ins)
        d = img[..., :3].reshape(1, hw, 3).transpose(1, 2) - target
        g_rgb = (2.0 * d * lscale).transpose(1, 2).reshape(
            1, cfg.image_size, cfg.image_size, 3)
        g_l2 = torch.cat([g_rgb, torch.zeros_like(g_rgb[..., :1])], dim=-1)
        dual = binned.fused_binned_backward(cfg, *ins, g_l2.contiguous())
        ok_d, err_d, where_d = tables_close(lg, dual, 1e-5)
        dlerr = ((loss - torch.sum(d * d, dim=(1, 2)) * lscale).abs()
                 / loss.abs()).max().item()
        torch.cuda.synchronize()
        if not (ok_b and ok_l and same and lerr <= 1e-5 and ok_d
                and dlerr <= 1e-5):
            fail(f"K12 gradients {noise}: backward {err_b} at {where_b} "
                 f"({checks.witness_text(bins_b)}), loss-and-grad {err_l} "
                 f"at {where_l} ({checks.witness_text(bins_l)}), loss rel "
                 f"{lerr}, repeats bit-equal {same}, dual path {err_d} at "
                 f"{where_d}, loss {dlerr}")
        b_ms, bp_ms = timed_pair(
            lambda: binned.fused_binned_backward(cfg, *ins, g_out),
            lambda: binned.binned_backward_plain(cfg, *ins, g_out), 3, 1)
        l_ms, lp_ms = timed_pair(
            lambda: binned.fused_binned_loss_grad(cfg, *ins, target,
                                                  "l2_rgb", lscale),
            lambda: binned.binned_loss_grad_plain(cfg, *ins, target,
                                                  "l2_rgb", lscale), 3, 1)
        w1 = binned_work(cfg, ins)
        tb_ = tensor_bytes(ins)
        grad_out = sum(t.numel() * 4 for t in ins[:4]) + 4 * 35
        bb_ms, bb_by = bound(tb_ + grad_out + 16 * w1["pixels"],
                             grad_ops(cfg, w1, False))
        lb_ms, lb_by = bound(tb_ + grad_out + 12 * w1["pixels"],
                             grad_ops(cfg, w1, True))
        print(f"[K12] fused_binned_backward / _loss_grad {noise} config 5 "
              f"N=1: worst row or scalar error {err_b:.3g} at {where_b} / "
              f"{err_l:.3g} at {where_l} "
              f"(tolerance {tol}; {thin_b} thin slot rows held by L/h: "
              f"{checks.witness_text(bins_l)}), loss rel {lerr:.3g}, "
              f"repeats bit-equal, loss-and-grad vs forward + backward "
              f"{err_d:.3g} (loss {dlerr:.3g}); {w1['cand']} candidate "
              f"pairs; backward {b_ms:.3f} ms vs plain {bp_ms:.1f} ms, "
              f"bound {bb_ms:.4f} ms ({bb_by}); loss-and-grad {l_ms:.3f} ms "
              f"vs plain {lp_ms:.1f} ms, bound {lb_ms:.4f} ms ({lb_by}) | "
              f"{smi}", flush=True)
        rows[noise] = dict(
            forward=dict(max_abs_err=dmax, ms=f_ms, plain_ms=fp_ms,
                         bound_ms=fb_ms, bound_by=fb_by, n=N_POSES),
            backward=dict(max_abs_err=err_b, ms=b_ms, plain_ms=bp_ms,
                          bound_ms=bb_ms, bound_by=bb_by, n=1),
            loss_grad=dict(max_abs_err=err_l, ms=l_ms, plain_ms=lp_ms,
                           bound_ms=lb_ms, bound_by=lb_by, n=1))
    g = rows["gaussian"]
    report["fused_binned"] = dict(
        max_abs_err=max(g[m]["max_abs_err"] for m in g),
        ms=g["loss_grad"]["ms"], plain_ms=g["loss_grad"]["plain_ms"],
        bound_ms=g["loss_grad"]["bound_ms"],
        bound_by=g["loss_grad"]["bound_by"], library_ms=None,
        modes={noise: r for noise, r in rows.items()})


def phase_capacity_binned(dev, smi, report):
    """capacity_stats of the oracle's config-5 scene at its pose (softras
    blur) against artifacts/oracle_config5.json's, within 1%."""
    with open(os.path.join(HERE, "artifacts", "oracle_config5.json")) as f:
        want = json.load(f)["modes"]["binned"]["capacity"]
    mesh, cams, lights, rend = config5.oracle_scene(dev)
    sh, st = rend.shader, rend.rasterizer.raster_settings
    stats, ms = synced_ms(lambda: binned.capacity_stats(
        mesh, cams, st, sh.smoothrast, sh.smoothagg, lights), 3)
    errs = {k: abs(stats[k] - want[k]) / want[k]
            for k in ("max_range", "max_tile_candidates")}
    if (stats["slots"] != want["slots"]
            or stats["range_limit"] != want["range_limit"]
            or max(errs.values()) > 0.01):
        fail(f"capacity-binned: {stats} against the TPU artifact {want}")
    report["capacity"] = stats
    print(f"[capacity-binned] capacity_stats of the oracle's config-5 scene "
          f"(softras blur): max_range {stats['max_range']} (TPU artifact "
          f"{want['max_range']}), max_tile_candidates "
          f"{stats['max_tile_candidates']} ({want['max_tile_candidates']}), "
          f"slots {stats['slots']}, range limit {stats['range_limit']}; "
          f"{ms:.1f} ms | {smi}", flush=True)


STAGED_KERNELS = ("heaviside_mean", "heaviside_coeff", "argmax_mean",
                  "argmax_grads", "interp_rows", "interp_rows_backward")
OTHER_FUSED = ("fused_forward", "fused_backward", "fused_loss_grad",
               "fused_stream_forward", "fused_stream_backward",
               "fused_stream_loss_grad")


def phase_serve_binned(dev, smi, report):
    """Eight N=4 requests of the config-5 scene (gaussian, S=8) at random
    poses through MeshRenderer: K1 once and K12's forward per request,
    no flat, stream or staged kernel."""
    gen = torch.Generator().manual_seed(2032)
    cams, lights = config5.scene(dev, N_POSES)
    base = config5.icosphere_mesh(config5.LEVEL, "oracle", dev).extend(
        N_POSES)

    def posed():
        rot = ptt.so3_exp_map(torch.randn(N_POSES, 3, generator=gen).to(dev))
        return base.update_padded(ptt.Rotate(rot).transform_points(
            base.verts))

    def make():
        return config5.renderer(cams, lights, "gaussian", SIGMA, GAMMA, s=S,
                                device=dev)

    make()(posed(), generator=gen)                  # warm the allocator
    torch.cuda.synchronize()
    renderer = make()
    reset_counts()
    lat_ms, alphas = [], []
    t_all = time.perf_counter()
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        img = renderer(posed(), generator=gen)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if (tuple(img.shape) != (N_POSES, 512, 512, 4)
                or not bool(torch.isfinite(img).all())):
            fail(f"serve-binned: image {tuple(img.shape)}")
        alphas.append((img[..., 3] > 0.5).float().mean().item())
    total_s = time.perf_counter() - t_all
    counts = all_counts()
    k9b = k9b_per(report, "serve-binned", N_REQUESTS, "request")
    if (counts["fused_binned_forward"] != N_REQUESTS
            or counts["prng_probe"] < 1
            or any(counts[k] for k in OTHER_FUSED + STAGED_KERNELS)):
        fail(f"serve-binned: launch counts {counts}")
    if not all(0.2 < a < 0.9 for a in alphas):
        fail(f"serve-binned: coverage shares {alphas}")
    report["fused_binned"]["launches_forward"] = counts[
        "fused_binned_forward"]
    print(f"[serve-binned] {N_REQUESTS} requests x {N_POSES} poses of config "
          f"5 (81920 faces, 512^2, K=150, binned) through MeshRenderer: "
          f"launches {counts}, {k9b}; alpha > 0.5 on {min(alphas):.3f}-"
          f"{max(alphas):.3f}; request latency median "
          f"{statistics.median(lat_ms[1:]):.1f} ms (after the first), "
          f"{N_REQUESTS * N_POSES / total_s:.2f} renders/s | {smi}",
          flush=True)


def phase_train_binned(dev, smi, report):
    """optimize_pose on config 5 (binned, gaussian S=8, the config5
    module's coarse start sigma 6e-3, gamma 6e-2), 30 steps at N=1 from
    20 degrees off, against the port's binned HardRast + HardAgg render of
    the true pose; its first step against the same step through K12's
    plain version on the card."""
    r_true = ptt.random_rotations(1, torch.Generator().manual_seed(2033),
                                  device="cpu").to(dev)
    cams, lights = config5.scene(dev)
    mesh = config5.icosphere_mesh(config5.LEVEL, "asymmetric", dev)
    hard = config5.renderer(cams, lights, "hard", SIGMA, GAMMA, blur=0.0,
                            device=dev)
    posed = mesh.update_padded(ptt.Rotate(r_true).transform_points(
        mesh.verts))
    if hard.plan(posed).mode != "binned":
        fail(f"train-binned: the target does not bin: {hard.plan(posed)}")
    with torch.no_grad():
        target = hard(posed, seeds=torch.zeros(1, 4, dtype=torch.int32))[
            0, ..., :3]
    log_rot, (renderer,) = harness.init_renderers(
        cams, lights, r_true, torch.Generator().manual_seed(7),
        pert_init_intensity=TRAIN_OFFSET_DEG, sigma=C5_TRAIN_SIGMA,
        gamma=C5_TRAIN_GAMMA, nb_samples=S, noise_type=("gaussian",),
        imsize=512, faces_per_pixel=150)
    renderer.rasterizer.raster_settings = dataclasses.replace(
        renderer.rasterizer.raster_settings, max_faces_per_bin=50000,
        bin_overflow="allow")
    if renderer.plan(mesh).mode != "binned":
        fail(f"train-binned: plan {renderer.plan(mesh)}")

    # The first step: K12's loss-and-grad through pose_step, against its
    # plain version on the card fed back through the same preparation
    # (the per-tile tables' gradients reach the pose through K9b); the
    # thin faces' slot rows left out of both table gradients.
    seeds = fr.draw_seeds(1, torch.Generator().manual_seed(7), device=dev)
    st = harness.PoseState.start(log_rot)
    opt = torch.optim.Adam([st.log_rot], lr=TRAIN_LR)
    out = harness.pose_step(mesh, target, st, renderer, cams, lights, opt,
                            seeds, torch.zeros(1, 3))[1]
    tcm = target.permute(2, 0, 1).reshape(1, 3, -1).contiguous()
    lscale = 1.0 / tcm.numel()

    def pose_grad(loss_grad, hold_thin):
        lr0 = log_rot.detach().clone().requires_grad_()
        pm = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(lr0))
                                .transform_points(mesh.verts))
        cfg, ins = kernel_inputs(renderer, pm, seeds)
        det = [t.detach() for t in ins]
        loss, *g = loss_grad(cfg, *det, tcm, "l2_rgb", lscale)
        keep = ~checks.thin_rows(det[0].reshape(1, -1, 9), 1e-3).view(
            det[0].shape[:3])[..., None] if hold_thin else 1.0
        (gp,) = torch.autograd.grad(ins[:4], [lr0],
                                    [t * keep for t in g[:4]])
        return loss, gp

    _k, g_kernel = pose_grad(binned.fused_binned_loss_grad, False)
    _k, g_kernel_held = pose_grad(binned.fused_binned_loss_grad, True)
    p_loss, g_plain = pose_grad(binned.binned_loss_grad_plain, True)
    lerr = abs(out.loss.item() - p_loss.item()) / abs(p_loss.item())
    gerr = ((g_kernel_held - g_plain).abs().max()
            / g_plain.abs().max()).item()
    serr = ((out.g_pose - g_kernel).abs().max()
            / g_kernel.abs().max()).item()
    if lerr > 1e-5 or gerr > 1e-3 or serr > 1e-5:
        fail(f"train-binned: first step: loss rel {lerr} vs plain, pose "
             f"gradient {gerr} of its max vs plain, pose_step vs K12 {serr}")

    start_deg = degrees_off(log_rot, r_true)
    torch.cuda.synchronize()
    reset_counts()
    res = harness.optimize_pose(
        mesh, cams, lights, log_rot, renderer, [target],
        generator=torch.Generator().manual_seed(8), lr_init=TRAIN_LR,
        Niter=TRAIN_STEPS, segment_size=TRAIN_STEPS)
    counts = all_counts()
    k9b = k9b_per(report, "train-binned", TRAIN_STEPS, "step")
    if (counts["fused_binned_loss_grad"] != TRAIN_STEPS
            or any(counts[k] for k in OTHER_FUSED + STAGED_KERNELS)
            or counts["fused_binned_forward"] or len(res.capacity) != 1):
        fail(f"train-binned: launch counts {counts}, capacity probes "
             f"{res.capacity}")
    if not (np.all(np.isfinite(res.losses))
            and np.all(np.isfinite(res.grad_norms))):
        fail(f"train-binned: losses {res.losses}")
    best = float(np.min(res.losses))
    if not best < res.losses[0]:
        fail(f"train-binned: best loss {best} not below the first "
             f"{res.losses[0]}")
    report["fused_binned"]["launches_loss_grad"] = counts[
        "fused_binned_loss_grad"]
    steps_s = TRAIN_STEPS / res.runtimes["total"][0]
    end_deg = degrees_off(res.best_log_rot, r_true)

    # Where a step goes: the synchronised step; the preparation and
    # selection (host clock); K12's loss-and-grad, the K9b scatter of its
    # table gradients and Adam (CUDA events).
    gen = torch.Generator().manual_seed(9)
    st = harness.PoseState.start(res.log_rot)
    opt = torch.optim.Adam([st.log_rot], lr=TRAIN_LR)
    step_ms, prep_ms = [], []
    for _ in range(6):
        sd = fr.draw_seeds(1, gen, device=dev)
        t0 = time.perf_counter()
        st, _o = harness.pose_step(mesh, target, st, renderer, cams, lights,
                                   opt, sd, torch.zeros(1, 3))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    sd = fr.draw_seeds(1, gen, device=dev)
    for _ in range(6):
        t0 = time.perf_counter()
        pm = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(st.log_rot))
                                .transform_points(mesh.verts))
        cfg, ins = kernel_inputs(renderer, pm, sd)
        torch.cuda.synchronize()
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    det = [t.detach() for t in ins]
    k12_ms = cuda_ms(lambda: binned.fused_binned_loss_grad(
        cfg, *det, tcm, "l2_rgb", lscale), 5)
    lr0 = st.log_rot.detach().clone().requires_grad_()
    pm = mesh.update_padded(ptt.Rotate(ptt.so3_exp_map(lr0))
                            .transform_points(mesh.verts))
    _cfg, ins = kernel_inputs(renderer, pm, sd)
    g_tabs = [torch.ones_like(t) for t in ins[:4]]
    k9b0 = gk.launch_counts["scatter_rows_cm"]
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        ins[:4], [lr0], g_tabs, retain_graph=True), 5)
    k9b_bwd = (gk.launch_counts["scatter_rows_cm"] - k9b0) / 5
    st.log_rot.grad = torch.ones_like(st.log_rot)
    adam_ms = cuda_ms(opt.step, 20)
    med, prep_med = statistics.median(step_ms[1:]), statistics.median(
        prep_ms[1:])
    cap = res.capacity[0]
    print(f"[train-binned] optimize_pose {TRAIN_STEPS} steps, N=1, config 5 "
          f"(81920 faces, 512^2, binned, sigma {C5_TRAIN_SIGMA} gamma "
          f"{C5_TRAIN_GAMMA}), lr {TRAIN_LR}: launches {counts}, {k9b}; "
          f"capacity "
          f"probe at the boundary: {cap['max_tile_candidates']} candidates "
          f"per tile at most, window {cap['max_range']}; loss "
          f"{res.losses[0]:.5g} -> best {best:.5g}; pose error "
          f"{start_deg:.2f} -> {end_deg:.2f} deg; {steps_s:.2f} steps/s; "
          f"synchronised step median {med:.1f} ms: preparation and "
          f"selection {prep_med:.1f} ms (host clock), K12 {k12_ms:.3f} ms, "
          f"the preparation's backward {bwd_ms:.3f} ms ({k9b_bwd:g} K9b "
          f"scatters, the slot tables' into the faces' first), Adam "
          f"{adam_ms:.4f} ms (CUDA events), the rest (Python, launches) "
          f"{med - prep_med - k12_ms - bwd_ms - adam_ms:.1f} ms; "
          f"first step K12 vs plain on the card: loss rel {lerr:.3g}, pose "
          f"gradient {gerr:.3g} of max (thin faces' rows left out of both; "
          f"{serr:.3g} between pose_step and K12 with them) | {smi}",
          flush=True)
    report["train_binned"] = dict(steps_s=steps_s, step_ms=med,
                                  prep_ms=prep_med, k12_ms=k12_ms,
                                  prep_bwd_ms=bwd_ms, adam_ms=adam_ms,
                                  start_deg=start_deg, end_deg=end_deg)


# ---------------------------------------------------------------------------
# The sample-sharded route: K11a, K3 with external coverage, K11b, K11c,
# and SHARDS gloo ranks sharing the card (NCCL refuses two ranks on one
# device; every average stages through the host).
# ---------------------------------------------------------------------------

S_LOCAL, SHARDS, SHARD = 4, 2, 1     # samples per rank, ranks, checked rank
SHARDED_KERNELS = ("fused_prob", "fused_forward", "fused_agg_bwd",
                   "fused_det_bwd")      # the flat sharded route's wrappers


def sharded_renderer(dev, n=N_POSES, s=S_LOCAL, axis=sharding.SAMPLE_AXIS,
                     s_rast=None):
    """The headline renderer with GaussianRast (``s_rast`` samples, ``s``
    by default) + GaussianAgg (``s``) sharding ``axis`` (None: the
    folded, single-process estimators)."""
    rend = headline_renderer("gaussian", dev, n)
    sh = rend.shader
    return rend.replace(shader=dataclasses.replace(
        sh, smoothrast=dataclasses.replace(
            sh.smoothrast, nb_samples=s_rast or s, sample_axis=axis),
        smoothagg=dataclasses.replace(sh.smoothagg, nb_samples=s,
                                      sample_axis=axis)))


def fields_close(got, want):
    """mc_close of (N, rows, P) fields, per pixel over the rows."""
    return mc_close(got.transpose(1, 2), want.transpose(1, 2))


def phase_k11(dev, smi, report):
    """K11a, K3 with external coverage, K11b and K11c at the flagship
    shapes on shard 1's seed words, each fed its plain upstream."""
    renderer = sharded_renderer(dev)
    mesh = posed_cube(torch.Generator().manual_seed(0), dev)
    base = fr.draw_seeds(N_POSES, torch.Generator().manual_seed(1),
                         device=dev)
    cfg, ins = kernel_inputs(renderer, mesh, base)
    if not cfg.prob_ext or cfg.stream:
        fail(f"K11: the sharded cube did not plan the flat sharded route "
             f"{cfg}")
    ins = (*ins[:6], fr.shard_seeds(cfg, ins[6], SHARD), ins[7])
    cover = (ins[0], ins[4], ins[5], ins[6], ins[7])
    n, px = N_POSES, N_POSES * IMAGE * IMAGE
    w = work(cfg, ins)
    geom = OPS_GEOM + OPS_CLIP * cfg.clip_bary + (
        OPS_PERSP * cfg.perspective_correct)
    shade = OPS_TEXEL[cfg.tex_mode] + OPS_PHONG
    cover_ops = cfg.s_rast * (w["rast_draw_ops"] + w["cand"] * OPS_COVER)
    agg_grad_ops = cfg.s_agg * (w["agg_draw_ops_grad"] + w["live"] * OPS_AGG
                                + w["grad_rows"] * OPS_AGG_BWD)
    tabs = table_bytes(cfg, n)
    prob_b, zrows_b = 4 * px * cfg.f_pad, 4 * px * cfg.c_zpad

    def row(name, err, k_ms, p_ms, nbytes, ops):
        b_ms, b_by = bound(nbytes, ops)
        report[name] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                            bound_ms=b_ms, bound_by=b_by)
        return f"{k_ms:.4f} ms vs plain {p_ms:.4f} ms, bound {b_ms:.4f} ms " \
               f"({b_by})"

    prob = fr.fused_prob(cfg, *cover)
    want_prob = fr.prob_plain(cfg, *cover)
    torch.cuda.synchronize()
    ok, dmax, dmean, flips = fields_close(prob, want_prob)
    same = torch.equal(prob, fr.fused_prob(cfg, *cover))
    if not ok or not same:
        fail(f"K11a: max {dmax} mean {dmean} flips {flips}, repeat "
             f"bit-equal {same}")
    k_ms, p_ms = timed_pair(lambda: fr.fused_prob(cfg, *cover),
                            lambda: fr.prob_plain(cfg, *cover), 20)
    times = row("sharded_prob", dmax, k_ms, p_ms,
                4 * n * (cfg.f_pad * 10 + 34 + 4) + prob_b,
                w["faces"] * geom + cover_ops)
    print(f"[K11a] sharded_prob 256^2 K=50 S_local={S_LOCAL} N=4, shard "
          f"{SHARD} (f_pad {cfg.f_pad}): max |d| {dmax:.3g}, mean |d| "
          f"{dmean:.3g}, pixels beyond 1e-4 {flips:.3g}, repeat bit-equal; "
          f"{times} | {smi}", flush=True)

    img, wts = fr.fused_forward(cfg, *ins, prob=want_prob)
    want_img, want_w = fr.forward_plain(cfg, *ins, want_prob)
    again = fr.fused_forward(cfg, *ins, prob=want_prob)
    torch.cuda.synchronize()
    ok, dmax, dmean, flips = mc_close(img, want_img)
    ok_w, wmax, wmean, wflips = fields_close(wts, want_w)
    same = torch.equal(img, again[0]) and torch.equal(wts, again[1])
    if not (ok and ok_w and same):
        fail(f"K3e: image max {dmax} mean {dmean} flips {flips}; weights "
             f"max {wmax} mean {wmean} flips {wflips}; repeat {same}")
    k_ms, p_ms = timed_pair(
        lambda: fr.fused_forward(cfg, *ins, prob=want_prob),
        lambda: fr.forward_plain(cfg, *ins, want_prob), 20)
    b_ms, b_by = bound(tabs + prob_b + 16 * px + zrows_b,
                       forward_ops(cfg, w) - cover_ops)
    report["fused_forward"]["modes"] = {"prob_ext": dict(
        max_abs_err=max(dmax, wmax), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by)}
    print(f"[K3e] fused_forward with external coverage (the sharded "
          f"route's K3), 256^2 N=4: image max |d| {dmax:.3g} mean {dmean:.3g}"
          f", weights max |d| {wmax:.3g} mean {wmean:.3g}, repeat "
          f"bit-equal; {k_ms:.4f} ms vs plain {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}) | {smi}", flush=True)

    g_out = torch.randn(n, IMAGE, IMAGE, 4,
                        generator=torch.Generator().manual_seed(2)).to(dev)
    gz, gg = fr.fused_agg_bwd(cfg, *ins, want_prob, g_out)
    want_gz, want_gg = fr.agg_bwd_plain(cfg, *ins, want_prob, g_out)
    again = fr.fused_agg_bwd(cfg, *ins, want_prob, g_out)
    torch.cuda.synchronize()
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in ((gz, want_gz), (gg, want_gg))]
    same = torch.equal(gz, again[0]) and torch.equal(gg, again[1])
    if max(errs) > 1e-3 or not same:
        fail(f"K11b: g_zmap / gamma term {errs} of max, repeat {same}")
    k_ms, p_ms = timed_pair(
        lambda: fr.fused_agg_bwd(cfg, *ins, want_prob, g_out),
        lambda: fr.agg_bwd_plain(cfg, *ins, want_prob, g_out), 5)
    times = row("sharded_agg_bwd", max(errs), k_ms, p_ms,
                tabs + prob_b + 16 * px + zrows_b + 4 * n,
                w["faces"] * geom + w["cand"] * (shade + OPS_ZMAP)
                + agg_grad_ops)
    print(f"[K11b] sharded_agg_bwd 256^2 N=4: g_zmap {errs[0]:.3g} and the "
          f"gamma term {errs[1]:.3g} of max (tolerance 1e-3), repeat "
          f"bit-equal; {times} | {smi}", flush=True)

    grads = fr.fused_det_bwd(cfg, *ins, want_prob, want_w, want_gz, g_out)
    want = fr.det_bwd_plain(cfg, *ins, want_prob, want_w, want_gz, g_out)
    again = fr.fused_det_bwd(cfg, *ins, want_prob, want_w, want_gz, g_out)
    torch.cuda.synchronize()
    ok, err, where = tables_close(grads, want, 1e-3)
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    if not ok or not same:
        fail(f"K11c: worst table error {err} at {where}, repeat {same}")
    k_ms, p_ms = timed_pair(
        lambda: fr.fused_det_bwd(cfg, *ins, want_prob, want_w, want_gz,
                                 g_out),
        lambda: fr.det_bwd_plain(cfg, *ins, want_prob, want_w, want_gz,
                                 g_out), 5)
    times = row("sharded_det_bwd", err, k_ms, p_ms,
                2 * tabs + prob_b + 2 * zrows_b + 16 * px,
                grad_ops(cfg, w, False) - agg_grad_ops)
    print(f"[K11c] sharded_det_bwd 256^2 N=4: worst table error {err:.3g} "
          f"of max at {where} (tolerance 1e-3), repeat bit-equal; {times} | "
          f"{smi}", flush=True)


def split_times(fn, reps):
    """Milliseconds per call of fn: the whole (host clock, synchronised),
    its kernels (CUDA events around each kernel wrapper), its collectives
    (host clock around each sharding.axis_mean, synchronised before and
    after: the host copies and the gloo all-reduce) and the rest (host:
    Python, preparation, launches).  The synchronisations make these
    calls slower than unmeasured ones."""
    events, coll = [], [0.0]

    def kernel(f):
        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = f(*a, **k)
            end.record()
            events.append((start, end))
            return out
        return timed

    axis_mean = sharding.axis_mean

    def timed_mean(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = axis_mean(*a, **k)
        torch.cuda.synchronize()
        coll[0] += (time.perf_counter() - t0) * 1e3
        return out

    saved = {name: getattr(fr, name) for name in SHARDED_KERNELS}
    for name, f in saved.items():
        setattr(fr, name, kernel(f))
    sharding.axis_mean = timed_mean
    total = 0.0
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total += (time.perf_counter() - t0) * 1e3
    finally:
        for name, f in saved.items():
            setattr(fr, name, f)
        sharding.axis_mean = axis_mean
    kern = sum(s.elapsed_time(e) for s, e in events)
    return dict(total=total / reps, kernels=kern / reps,
                collectives=coll[0] / reps,
                host=(total - kern - coll[0]) / reps)


def split_text(sp):
    return (f"{sp['total']:.2f} ms measured: kernels {sp['kernels']:.3f}, "
            f"collectives {sp['collectives']:.3f}, host {sp['host']:.2f}")


def sharded_value_and_grads(dev, kind, sharded):
    """The loss mean((image - target)^2) of ``kind`` ('cube': N=4 at
    S_local 4 per rank; 'cow': N=2, S_rast 8 on every rank, S_agg 4 per
    rank) at seeded poses, through MeshRenderer.render_loss, and its
    gradients with respect to the poses and sigma, gamma, alpha; the
    image.  ``sharded`` False: one process at the group's samples.  The
    cow also gives the pose gradient with the thin faces' sorted-table
    rows (height under 2e-3 of the longest edge, as [K6] holds them) left
    out: their float32 gradients carry rounding noise that grows as L / h,
    so two sums of the same samples in another order part there first."""
    fold = 1 if sharded else SHARDS
    axis = sharding.SAMPLE_AXIS if sharded else None
    if kind == "cube":
        n, base = N_POSES, cube_mesh(dev)
        renderer = sharded_renderer(dev, n, S_LOCAL * fold, axis)
    else:
        n, base = 2, cow_mesh(dev)
        renderer = sharded_renderer(dev, n, S_LOCAL * fold, axis,
                                    s_rast=S)
    gen = torch.Generator().manual_seed(11)
    log_rot = torch.randn(n, 3, generator=gen).to(dev).requires_grad_()
    target = torch.rand(n, IMAGE, IMAGE, 3, generator=gen).to(dev)
    seeds = fr.draw_seeds(n, gen, device=dev)
    smoothing = [torch.tensor(v, device=dev, requires_grad=True)
                 for v in (SIGMA, GAMMA, 1.0)]
    posed = renderer.replace(shader=renderer.shader.update_smoothing(
        *smoothing))
    base = base.extend(n)
    pred = base.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                              .transform_points(base.verts))
    plan = renderer.plan(pred)
    loss = posed.render_loss(pred, target, seeds=seeds)
    grads = torch.autograd.grad(loss, [log_rot, *smoothing])
    with torch.no_grad():
        image = posed(pred, seeds=seeds)
    held = grads[0]
    if kind == "cow":
        pred = base.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                                  .transform_points(base.verts))
        sh, st = posed.shader, posed.rasterizer.raster_settings
        cfg, _why = fr._plan(pred, sh.lights, sh.smoothrast, sh.smoothagg,
                             st, "phong")
        ins = fr._prepare_inputs(cfg, pred, sh.cameras, sh.lights,
                                 sh.materials, sh.smoothrast, sh.smoothagg,
                                 sh.blend_params, st, seeds, "phong",
                                 sample_axis=axis)
        img = (fr._FusedStreamSharded.apply(cfg, axis, *ins) if sharded
               else fr._FusedStream.apply(cfg, *ins))
        (g_tab,) = torch.autograd.grad(
            torch.mean((img[..., :3] - target) ** 2), [ins[0]])
        keep = ~checks.thin_rows(ins[0].detach(), 1e-3)
        (held,) = torch.autograd.grad(ins[0], [log_rot],
                                      g_tab * keep[..., None])
    return dict(loss=loss.item(), image=image.cpu(),
                grads=[g.cpu() for g in grads], held=held.cpu(),
                plan=(plan.mode, plan.prob_ext))


def sharded_serve(dev):
    """N_REQUESTS requests of N_POSES cube poses (the same poses and seed
    words on every rank) through MeshRenderer on the sharded route."""
    gen = torch.Generator().manual_seed(2034)
    renderer = sharded_renderer(dev)
    renderer(posed_cube(gen, dev), generator=gen)        # warm
    torch.cuda.synchronize()
    torch.distributed.barrier()
    reset_counts()
    lat_ms, sums = [], []
    t_all = time.perf_counter()
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        img = renderer(posed_cube(gen, dev), generator=gen)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        if (tuple(img.shape) != (N_POSES, IMAGE, IMAGE, 4)
                or not bool(torch.isfinite(img).all())):
            raise RuntimeError(f"serve-sharded: image {tuple(img.shape)}")
        sums.append(img.double().sum().item())
    total_s = time.perf_counter() - t_all
    counts = all_counts()
    split = split_times(lambda: renderer(posed_cube(gen, dev),
                                         generator=gen), 3)
    return dict(lat_ms=lat_ms, total_s=total_s, counts=counts, sums=sums,
                alpha=(img[..., 3] > 0.5).float().mean().item(), split=split)


def sharded_train(dev):
    """TRAIN_STEPS steps of make_sharded_pose_step (N=1, the headline
    cube from 20 degrees off, S_local 4 per rank, Adam at TRAIN_LR)
    against the flat HardRast + HardAgg render of the true pose."""
    r_true = ptt.random_rotations(1, torch.Generator().manual_seed(2035),
                                  device="cpu").to(dev)
    mesh, cams, lights, _r, log_rot0, target = train_setup(dev, r_true, 5)
    renderer = sharded_renderer(dev, n=1)
    step = sharding.make_sharded_pose_step(sharding.active_mesh(), mesh,
                                           cams, lights)
    log_rot = log_rot0.detach().clone().requires_grad_()
    opt = torch.optim.Adam([log_rot], lr=TRAIN_LR)
    gen = torch.Generator().manual_seed(8)
    targets = target[None]
    step(log_rot.detach().clone().requires_grad_(), torch.optim.Adam(
        [torch.zeros(1, 3, device=dev, requires_grad=True)], lr=0.0),
        targets, fr.draw_seeds(1, gen, device=dev), renderer)     # warm
    torch.cuda.synchronize()
    torch.distributed.barrier()
    reset_counts()
    losses, best, best_rot = [], math.inf, log_rot0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = log_rot.detach().clone()
        loss, renderer = step(log_rot, opt, targets,
                              fr.draw_seeds(1, gen, device=dev), renderer)
        losses.append(loss.item())
        if losses[-1] < best:
            best, best_rot = losses[-1], before
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = all_counts()
    split = split_times(lambda: step(log_rot, opt, targets, fr.draw_seeds(
        1, gen, device=dev), renderer), 3)
    return dict(losses=losses, total_s=total_s, counts=counts, split=split,
                start_deg=degrees_off(log_rot0, r_true),
                end_deg=degrees_off(best_rot, r_true),
                final=log_rot.detach().cpu())


def _sharded_rank(rank, init_method, out_dir):
    torch.distributed.init_process_group("gloo", init_method=init_method,
                                         world_size=SHARDS, rank=rank)
    try:
        dev = torch.device("cuda", 0)
        sharding.build_mesh(SHARDS, samples_parallel=SHARDS)
        res = {"flat": sharded_value_and_grads(dev, "cube", True),
               "stream": sharded_value_and_grads(dev, "cow", True),
               "serve": sharded_serve(dev), "train": sharded_train(dev)}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def folded_close(got, want, scalar_rtol):
    """(ok, image max |d|, loss rel, pose gradient share of max (thin
    rows held out on the cow), the whole pose gradient's, worst sigma /
    gamma / alpha rel) of the sharded against the folded run."""
    di = (got["image"] - want["image"]).abs().max().item()
    dl = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    share = lambda g, w: ((g - w).abs().max() / w.abs().max()).item()
    dp = share(got["held"], want["held"])
    dp_all = share(got["grads"][0], want["grads"][0])
    ds = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
             for a, b in zip(got["grads"][1:], want["grads"][1:]))
    ok = di <= 1e-6 and dl <= 1e-6 and dp <= 1e-6 and ds <= scalar_rtol
    return ok, di, dl, dp, dp_all, ds


def phase_sharded(dev, smi, report):
    """SHARDS gloo ranks sharing the card: [sharded = folded],
    [sharded-stream = folded], [serve-sharded], [train-sharded]."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            torch.multiprocessing.start_processes(
                _sharded_rank,
                args=(f"tcp://127.0.0.1:{sharding.free_port()}", out_dir),
                nprocs=SHARDS, join=True, start_method="spawn")
        except torch.multiprocessing.ProcessRaisedException as e:
            fail(f"sharded: a rank failed:\n{e}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(SHARDS)]
    ranks_s = time.perf_counter() - t0
    r0, r1 = ranks
    for name, kind, rtol, what in (
            ("flat", "cube", 1e-5, "cube 256^2 K=50 N=4, S_local 4 x 2 "
                                  "ranks against S 8"),
            ("stream", "cow", 5e-5, "cow 256^2 K=50 N=2, S_rast 8, S_agg "
                                    "4 x 2 ranks against 8")):
        folded = sharded_value_and_grads(dev, kind, False)
        same = (torch.equal(r0[name]["image"], r1[name]["image"])
                and all(torch.equal(a, b) for a, b in
                        zip(r0[name]["grads"], r1[name]["grads"])))
        ok, di, dl, dp, dp_all, ds = folded_close(r0[name], folded, rtol)
        want_plan = ("flat" if name == "flat" else "stream", True)
        if not ok or not same or r0[name]["plan"] != want_plan:
            fail(f"sharded {name}: image {di}, loss rel {dl}, pose gradient "
                 f"{dp} of max (all rows {dp_all}), scalars rel {ds} (rtol "
                 f"{rtol}); ranks bit-equal {same}; plan "
                 f"{r0[name]['plan']}")
        tag = "sharded = folded" if name == "flat" else \
            "sharded-stream = folded"
        held = "" if name == "flat" else (
            f" with the thin faces' rows held out ({dp_all:.3g} with "
            f"them)")
        print(f"[{tag}] {what} ({SHARDS} gloo ranks on one card, plan "
              f"{r0[name]['plan']}): image max |d| {di:.3g} (atol 1e-6), loss "
              f"rel {dl:.3g} (1e-6), pose gradient {dp:.3g} of max (1e-6)"
              f"{held}, sigma / gamma / alpha rel {ds:.3g} (rtol {rtol}); "
              f"the ranks bit-equal | {smi}", flush=True)

    sv, c = r0["serve"], r0["serve"]["counts"]
    if (c["sharded_prob"] != N_REQUESTS or c["fused_forward_ext"]
            != N_REQUESTS or c["fused_forward"] or c["fused_backward"]
            or r0["serve"]["sums"] != r1["serve"]["sums"]):
        fail(f"serve-sharded: launch counts {c}, ranks' image sums "
             f"{sv['sums']} / {r1['serve']['sums']}")
    med = statistics.median(sv["lat_ms"][1:])
    print(f"[serve-sharded] {N_REQUESTS} requests x {N_POSES} cube poses "
          f"through MeshRenderer, {SHARDS} ranks x S_local {S_LOCAL}: launches "
          f"(rank 0) {c}; alpha > 0.5 on {sv['alpha']:.3f}; request latency "
          f"median {med:.2f} ms, {N_REQUESTS * N_POSES / sv['total_s']:.1f} "
          f"renders/s; a request {split_text(sv['split'])} (gloo stages "
          f"every average through the host: two ranks sharing one card) | "
          f"{smi}", flush=True)

    tr, c = r0["train"], r0["train"]["counts"]
    if any(c[k] != TRAIN_STEPS for k in ("sharded_prob", "fused_forward_ext",
                                         "sharded_agg_bwd",
                                         "sharded_det_bwd")) or (
            c["fused_loss_grad"] or c["fused_backward"]):
        fail(f"train-sharded: launch counts {c}")
    if not (np.all(np.isfinite(tr["losses"]))
            and min(tr["losses"]) < tr["losses"][0]
            and torch.equal(tr["final"], r1["train"]["final"])):
        fail(f"train-sharded: losses {tr['losses']}, ranks' poses "
             f"{tr['final']} / {r1['train']['final']}")
    print(f"[train-sharded] make_sharded_pose_step {TRAIN_STEPS} steps, N=1, "
          f"{SHARDS} ranks x S_local {S_LOCAL}, lr {TRAIN_LR}: launches "
          f"(rank 0) {c}; loss {tr['losses'][0]:.5g} -> best "
          f"{min(tr['losses']):.5g}; pose error {tr['start_deg']:.2f} -> "
          f"{tr['end_deg']:.2f} deg; {TRAIN_STEPS / tr['total_s']:.1f} "
          f"steps/s; a step {split_text(tr['split'])}; the ranks' poses "
          f"bit-equal; ranks' wall time {ranks_s:.1f} s | {smi}", flush=True)
    for name, key in (("sharded_prob", "sharded_prob"),
                      ("sharded_agg_bwd", "sharded_agg_bwd"),
                      ("sharded_det_bwd", "sharded_det_bwd")):
        report[name]["launches"] = (r0["serve"]["counts"][key]
                                    + r0["train"]["counts"][key])
    report["fused_forward"]["modes"]["prob_ext"]["launches"] = (
        r0["serve"]["counts"]["fused_forward_ext"]
        + r0["train"]["counts"]["fused_forward_ext"])
    report["sharded"] = dict(serve_ms=med, serve_split=sv["split"],
                             step_ms=tr["total_s"] * 1e3 / TRAIN_STEPS,
                             step_split=tr["split"])


def phase_dryrun_sharded(dev, smi):
    """sharding.dryrun_multichip(2, device='cuda'): the cube (flat
    sharded) and the 80-face icosphere (stream sharded) phases."""
    t0 = time.perf_counter()
    try:
        out = sharding.dryrun_multichip(2, device=dev)
    except torch.multiprocessing.ProcessRaisedException as e:
        fail(f"dryrun-sharded: a rank failed:\n{e}")
    if sorted(out) != ["cube", "stream/sphere"] or not all(
            np.all(np.isfinite(v)) for v in out.values()):
        fail(f"dryrun-sharded: {out}")
    print(f"[dryrun-sharded] dryrun_multichip(2, device='cuda'): losses "
          f"{out}; {time.perf_counter() - t0:.1f} s | {smi}", flush=True)


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
    "gather_rows_cm": ("csrc/gather.cu", "ops/gather.py:59"),
    "scatter_rows_cm": ("csrc/gather.cu", "ops/gather.py:121"),
    "interp_rows": ("csrc/interp_gather.cu", "ops/interp_gather.py:75"),
    "interp_rows_backward": ("csrc/interp_gather.cu",
                             "ops/interp_gather.py:101"),
    "perturbed_heaviside": ("csrc/perturbed.cu",
                            "ops/perturbed_pallas.py:133"),
    "argmax_mean": ("csrc/perturbed.cu", "ops/perturbed_pallas.py:223"),
    "argmax_grads": ("csrc/perturbed.cu", "ops/perturbed_pallas.py:238"),
    "fused_binned": ("csrc/fused_binned.cu", "ops/fused_render.py:2962"),
    "sharded_prob": ("csrc/sharded.cu", "ops/fused_render.py:1764"),
    "sharded_agg_bwd": ("csrc/sharded.cu", "ops/fused_render.py:1804"),
    "sharded_det_bwd": ("csrc/sharded.cu", "ops/fused_render.py:1861"),
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
    phase_stream_s128(dev, smi)
    phase_serve_stream(dev, smi, report)
    phase_render_grad_stream(dev, smi, report)
    phase_train_stream(dev, smi, report)
    phase_k9_k10(dev, smi, report)
    phase_target(dev, smi, report)
    phase_staged_softras(dev, smi, report)
    phase_k8(dev, smi, report)
    phase_staged_mc(dev, smi, report)
    phase_staged_uniform(dev, smi, report)
    phase_large(dev, smi, report)
    phase_k12(dev, smi, report)
    phase_capacity_binned(dev, smi, report)
    phase_serve_binned(dev, smi, report)
    phase_train_binned(dev, smi, report)
    phase_determinism(dev, smi)
    phase_k11(dev, smi, report)
    phase_sharded(dev, smi, report)
    phase_dryrun_sharded(dev, smi)

    kernels = []
    k12 = report["fused_binned"]
    k12["launches"] = k12["launches_forward"] + k12["launches_loss_grad"]
    k9b = report["scatter_rows_cm"]
    k9b_paths = dict(report["k9b_paths"], **{"staged-softras":
                                             k9b["launches"]})
    k9b["launches"] = sum(k9b_paths.values())
    for kname, (src, replaces) in SOURCES.items():
        r = report[kname]
        extra = ({"launches_by_mode": {
            "forward": k12["launches_forward"], "backward": 0,
            "loss_grad": k12["launches_loss_grad"]},
            "modes": k12["modes"]} if kname == "fused_binned" else {})
        if kname == "fused_forward":
            extra = {"modes": r["modes"]}
        if kname == "scatter_rows_cm":
            extra = {"launches_by_path": k9b_paths, "prep_ms": r["prep_ms"],
                     "sum_ms": r["sum_ms"]}
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"pertrenderer_tpu_torch/{src}",
            "replaces": f"pertrenderer_tpu/{replaces}",
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), **extra})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
