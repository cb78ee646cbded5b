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
   deterministic softras pair at atol 2e-5; bit-equal to its per-pixel
   reference (pixel_forward, every draw taken) and to its counting
   launch, whose certain pixels and skipped draws it prints and whose
   draws the bound counts; timed at N=4 and N=1; then gaussian at S=128
   bit-equal to the reference;
4. K4 — the fused backward against its plain version (torch autograd
   through the plain forward) for a seeded random cotangent, N=4, gaussian
   and softras.  Each gradient table, and each of the 34 scalar gradients
   on its own, within 1e-3 (MC: shared noise, threshold flips only) or
   1e-4 (softras) of its max |grad|, and the same bits on a second launch;
   the pixel kernel's ptxas line and resident warps per SM (occupancy
   API), and the call's device time at N=1 and N=4 split by kernel
   (torch.profiler: memset, pixel kernel, reduction);
5. K2 — the fused loss-and-grad against its plain version (loss rtol
   1e-5, tables as K4), and the dual path: K2 equals K3 + K4 fed the L2
   cotangent (tables and scalars within 1e-5 of their max); ptxas,
   occupancy and the split as K4's;
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
   full width (tolerances as K3), repeated launches bit-equal; its ptxas
   line and resident warps per SM, and a counting build's share of the
   coverage and aggregation draws skipped (its image bit-equal);
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
   of 64 samples over the chunk list) on the level-3 cow (1280 faces: the
   plain versions' time goes with the chunks) at 64^2, N=1: K5, K6 and K7
   against their plain versions at the same tolerances, repeats
   bit-equal; K7 on the 5120-face cow (80 chunks) at 32^2 against its
   float64 plain version; the cow at 64^2 through MeshRenderer.forward and
   render_loss, and K7 = K5 + K6; then K5 / K6 at N=4 and K7 at N=1 on
   the cow at 256^2, S = 64 beside S = 128, timed, finite, repeats
   bit-equal;
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
   versions; repeated launches bit-equal; K10b also bit-equal to the
   plain mirror of its order (tile partials, then tile order), with its
   tile counts (distinct faces per tile, partial rows against the filled
   columns; its device split by kernel is kernel_splits k10b's);
   index_select (K9a) and index_add_ (K9b) timed as the library calls;
   K9b's index preparation
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
   upstream: K11a's coverage (MC image rule, and bit-equal to its
   per-pixel reference and its counting launch at N=4 and N=1, gaussian
   and cauchy; its bound recounted from the counting launch), K3's image
   and weights with external coverage (MC image rule, per pixel over the
   rows; image and weights bit-equal to the per-pixel reference), K11b's
   g_zmap and gamma term
   (1e-3 of max), K11c's tables (1e-3 of max); repeats bit-equal; K3e's
   and K11b's counting launches (certain pixels, draws skipped); K11b's
   device time split (pixel kernel, reduction); K11a, K3e, K11b and K11c
   also timed at N=1, [train-sharded]'s shape;
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

27. eval-pose / eval-runtime / check-diff — the experiment CLI
   (``python -m pertrenderer_tpu_torch.experiments.eval``) in one child
   process, the launch counts reset before and printed after each run:
   pose_opt (cube, 128^2, 2 problems, gaussian and softras, 150 steps;
   the 7 JSON files, every gaussian run under 5 degrees; K2 once per
   step), runtime (1 problem, 100 steps; seconds and peak memory per
   run), check_diff of the light on the cube (K2) and the 1280-face
   sphere (K7), 100 steps each: the loss falls (mean of the last 10
   below the first 10); then, in this process, K2 on the cube and K7 on
   the sphere on the inputs of check_diff's first step (loss_kind
   l1_rgb) against their plain versions: the loss within 1e-5, the
   tables and every scalar (the light location among them) within 1e-3
   of their max, repeat bit-equal;
28. resume — optimize_pose for 100 steps straight against 50 steps, a
   checkpoint and a resume of 50: bit-equal;
29. config3 — experiments/config3.py at the recipe of
   artifacts/config3.json (the cow, 4 views, 64 -> 128 -> 256^2, 1480
   steps, K7 once per step): every view's camera within 2 degrees, the
   best texture MAE at most 0.25; then K7's share of a synchronised
   scene step at 256^2, and K7 on the inputs of that scene step (N=4,
   S=8, l1_rgb) against its plain version, as check-diff holds it.

30. obj-io — the level-6 icosphere (81,920 faces) through save_obj and
   load_obj: the native (C++, built with g++) and the Python parser give
   the same arrays, their parse times in host seconds; the cow through
   save_obj -> load_objs_as_meshes -> a K5 render (256^2, N=1) bit-equal
   to the render of the same vertices rounded to %.6f in memory; a
   synthetic ShapeNet model (written here, PNG map included) through
   harness.init_target (TexturesAtlas, the staged Hard-Phong target) and
   FileNotFoundError without shapenet_path;
31. config2 — BASELINE config 2 through experiments/config2.py's main at
   128^2: the level-2 icosphere's silhouette (staged select, K9a / K9b,
   K8a): the 60-step scale fit from 0.7 within 0.08 of 1; the
   gradient-variance sweep S in {4, 16, 64} over 24 seed words on the
   synthetic field and on the scene's dists (falling, var(4) / var(64) >
   4); gumbel aggregation (K8b) weights summing to 1 within 1e-5; then
   K8a (mean and coefficient) on the scene's -dists and K8b with gumbel
   noise on the scene's z_map against their plain versions on shared
   noise (MC tolerance; coefficient 1e-3 of max), bit-equal where no draw
   is made, K8b bit-equal to the path's weights;
32. config4 — BASELINE config 4 through experiments/config4.py's main:
   the cube x2 in 16 views at 256^2, K=50, S=4, 30 Adam steps on log_rot
   and per-vertex offsets through render_loss (K2 at N=16, the offsets
   through K9b), twice: step time, view-renders/s, pose error before and
   after, the dual path at step 0 (K2 vs K3 + K4, 1e-3 of max), both
   gradients finite and non-zero, the second run bit-equal; then K2 vs
   its plain version on step 0's inputs at N=16 (tables 1e-3 of max, loss
   1e-5);
33. oracle-config5 — experiments/oracle_config5.py on one 32-row strip:
   count pass and K_exact, the K ladder, stream and binned forward
   against both rungs (stream within 5e-5 of K_exact), the dual-path pose
   gradient (1e-4), FD rows, the strip gradient against the K_exact
   staged oracle (stream 1e-4) and the binned capacity.

[phases] prints each phase's seconds.

Phases 6-8, 11-13, 15, 16, 19, 20, 24, 25 and 27-33 are the main paths:
the launch counts are reset just before each and read just after, and
each must have launched its kernels (serve: K1 and K3; render-grad: K3
and K4; train: K2 once per step; serve-stream: K5; render-grad-stream:
K5 and K6; train-stream: K7 once per step; target: K9a and no fused
kernel; staged-softras: K9a, K9b, K10a and K10b and no fused kernel;
serve-binned: K1 and K12's forward; train-binned: K12's loss-and-grad
once per step; serve-sharded and train-sharded: counted in rank 0; the
CLI's runs, resume and config3 as above; obj-io: K5 and K9a; config2:
K9a, K9b, K8a and K8b; config4: K2 once per step (and once for the dual
path) and K9b; oracle-config5: K5-K7, K12's three modes, K9a, K9b, K10a
and K10b).  Times are CUDA events except the per-request and per-step
times (host clock ending in a device synchronisation).  Kernel and plain version are timed in turns (plain,
kernel, kernel, plain) after a warm-up call.

The last lines are the per-kernel report (one JSON object, eighteen
kernels; K12's row gives its loss-and-grad at N=1, the pose step's
kernel, and every mode under "modes"; K3's row its external-coverage
mode under "modes"),
the card's nvidia-smi name and power limit, then
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch import _build, checks, native, shading
from pertrenderer_tpu_torch.checks import tables_close
from pertrenderer_tpu_torch.experiments import (config2, config3, config4,
                                                config5, harness,
                                                oracle_config5)
from pertrenderer_tpu_torch.experiments import eval as eval_cli
from pertrenderer_tpu_torch.ops import binned
from pertrenderer_tpu_torch.ops import fused_render as fr
from pertrenderer_tpu_torch.ops import gather as gk
from pertrenderer_tpu_torch.ops import interp_gather as ik
from pertrenderer_tpu_torch.ops import perturbed_kernels as pk
from pertrenderer_tpu_torch.parallel import sharding
from pertrenderer_tpu_torch.utils import checkpoint as ckpt_mod

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
OPS_BOX = 4           # ... K3's grown bounding-box test before it
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
OPS_ALPHA = 2         # ... of which the alpha product: 1 - prob, multiply
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


def grad_kernel_text(kname, cfg, dev):
    """K4's or K2's pixel kernel at cfg's slot bucket: its ptxas line and
    its resident warps per SM (the occupancy API)."""
    bucket = next(b for b in (16, 32, 64, 128, 256) if cfg.f_pad <= b)
    key = (f"fused_grad_kernelILi{bucket}ELb"
           f"{int(kname == 'fused_loss_grad')}ELb0E")
    line = " | ".join(sorted(set(ptxas_report((key,)).get(
        key, ["not in the build log"]))))
    shape = fr.grad_kernel_shape(kname, cfg, dev)
    return (f"ptxas fused_grad_kernel<{bucket}>: {line}; "
            f"{shape['blocks_per_sm'] * 4} resident warps per SM "
            f"({shape['blocks_per_sm']} blocks of 128 threads)")


def grad_call(kname, cfg, ins, dev):
    """A call of K4 (``fused_backward``, on a seeded cotangent) or K2
    (``fused_loss_grad``, on a seeded target) on ``ins``."""
    n, size = ins[0].shape[0], cfg.image_size
    if kname == "fused_loss_grad":
        target = torch.rand(n, 3, size * size, generator=torch.Generator()
                            .manual_seed(3)).to(dev)
        return lambda: fr.fused_loss_grad(cfg, *ins, target, "l2_rgb",
                                          1.0 / (3 * n * size * size))
    g_out = torch.randn(n, size, size, 4,
                        generator=torch.Generator().manual_seed(2)).to(dev)
    return lambda: fr.fused_backward(cfg, *ins, g_out)


def device_split(fn, reps):
    """{kernel name: device ms per call} of fn()'s launches, from
    torch.profiler's CUDA activity (empty where the profiler sees no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t and t > 0:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3 / reps
    return out


def kernel_name(name):
    """A profiler kernel name without its namespace, return type, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def kernel_split_text(split):
    """A device split's kernels in three groups: memsets, reductions (names
    with "reduce") and the rest."""
    if not split:
        return "no device time in the profile"
    groups = {"memset": 0.0, "main": 0.0, "reduction": 0.0}
    names = {"memset": [], "main": [], "reduction": []}
    for name, ms in split.items():
        g = ("memset" if "memset" in name.lower() else
             "reduction" if "reduce" in name else "main")
        groups[g] += ms
        names[g].append(f"{kernel_name(name)} {ms:.4f}")
    return ", ".join(f"{g} {groups[g]:.4f} ms ({'; '.join(names[g]) or '-'})"
                     for g in groups)


def grad_split_text(kname, cfg, ins, dev):
    """K4's or K2's time per call (CUDA events) and its device time split by
    kernel (torch.profiler: the memset, the pixel kernel, the reduction) on
    the first element of ins (N=1) and on all of them."""
    texts = []
    for n in (1, ins[0].shape[0]):
        call = grad_call(kname, cfg, tuple(t[:n].contiguous() for t in ins),
                         dev)
        call()
        ms = cuda_ms(call, 10)
        texts.append(f"N={n} {ms:.4f} ms per call, device: "
                     + kernel_split_text(device_split(call, 10)))
    return "; ".join(texts)


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
    """Float32 operations of the stream forward as K6 / K7 replay it, on
    the ``stream_work`` counts: geometry per visited pair; texel, shading,
    z_map, blend and coverage per candidate (every candidate's draws); the
    aggregation over the candidates and the background row (one draw per
    pixel and sample)."""
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


def k5_ops(cfg, w, counts):
    """Float32 operations that K5's image needs, on the ``stream_work``
    counts and this run's counting launch (``counts``:
    fr.stream_forward_counts): geometry per visited pair; z_map and the
    alpha factor per candidate; the texel and shading per candidate for the
    softmax, and for the argmax aggregations only per pixel's distinct
    winner (``winners``); only the noise draws that can change the image
    (``cover_drawn`` / ``agg_drawn`` pairs, each counted as one draw, one
    perturbed test and no more); the background row's draw and test per
    pixel and sample."""
    geom = OPS_GEOM + OPS_CLIP * cfg.clip_bary + (
        OPS_PERSP * cfg.perspective_correct)
    shade = OPS_TEXEL[cfg.tex_mode] + (
        OPS_PHONG if cfg.shade == "phong" else 0)
    ops = (w["visited"] * geom + w["pixels"] * OPS_BG
           + w["cand"] * (OPS_ZMAP + OPS_ALPHA))
    if cfg.agg_kind == "soft":
        ops += (w["cand"] * (shade + OPS_BLEND - OPS_ALPHA)
                + (w["cand"] + w["pixels"]) * OPS_SOFTMAX)
    else:
        ops += counts["winners"] * shade
    draw = lambda noise: OPS_PAIR if noise == "gaussian" else OPS_CAUCHY
    if cfg.rast_kind == "mc":
        ops += counts["cover_drawn"] * (draw(cfg.rast_noise) + OPS_COVER)
    else:
        ops += w["cand"] * OPS_SOFT_COVER
    if cfg.agg_kind == "mc":
        ops += (counts["agg_drawn"] * (draw(cfg.agg_noise) + OPS_AGG)
                + cfg.s_agg * w["pixels"] * (draw(cfg.agg_noise) + OPS_AGG))
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


def cow_mesh(device, level=4):
    """The config-3 cow (``make_cow``: 2562 verts, 5120 faces, UV atlas
    4; at level 3 642 verts, 1280 faces), centred and scaled to 3 / max |v|
    as tools/run_config3.py does."""
    cow = ptt.make_cow(level=level, device=device)
    verts = cow.verts[0]
    center = verts.mean(0)
    scale = torch.max(torch.abs(verts - center))
    return cow.offset_verts(-center.expand_as(verts)).scale_verts(
        3.0 / scale)


def posed_cow(generator, device, n=N_POSES, log_rot=None, level=4):
    """The cow at n random rotations drawn from ``generator``."""
    cow = cow_mesh(device, level).extend(n)
    if log_rot is None:
        log_rot = torch.randn(n, 3, generator=generator).to(device)
    rot = ptt.so3_exp_map(log_rot)
    return cow.update_padded(ptt.Rotate(rot).transform_points(cow.verts))


def stream_inputs(noise, dev, n, size=None, s=S, level=4):
    """(cfg, K5-K7 arguments) of the cow (``make_cow(level)``) at n random
    poses."""
    renderer = headline_renderer(noise, dev, n, size, s)
    mesh = posed_cow(torch.Generator().manual_seed(0), dev, n, level=level)
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
    # No launch finishes in b_ms: the device time of a kernel that does
    # nothing (the launch floor) is the bound that K1 can be held to.  Both
    # are profiled in a fresh process (kernel_splits k1): in this one the
    # later phases' profiler sessions see the device only if theirs come
    # first.
    out = subprocess.run(
        [sys.executable, "-m", "pertrenderer_tpu_torch.experiments."
         "kernel_splits", "k1", "--root", HERE], capture_output=True,
        text=True, timeout=300, cwd=HERE)
    if out.returncode != 0:
        fail(f"K1: kernel_splits k1 failed: {out.stderr[-2000:]}")
    split = json.loads(out.stdout.strip().splitlines()[-1])
    k1_dev, floor = split["prng_probe_ms"], split["launch_floor_ms"]
    if not (k1_dev > 0 and floor > 0):
        fail(f"K1: no device time in the profile: {split}")
    report["prng_probe"] = dict(max_abs_err=k1_err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                device_ms=k1_dev, launch_floor_ms=floor)
    print(f"[K1] prng_probe: uniform bit-exact vs goldens, gaussian/cauchy "
          f"within 5e-4 abs / 1e-5 rel; max |kernel - plain| {k1_err:.3g}; "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {b_ms:.2e} ms "
          f"({b_by}); device time (torch.profiler) {k1_dev:.5f} ms against "
          f"an empty kernel's {floor:.5f} ms (the launch floor): "
          f"{k1_dev / floor:.2f}x | {smi}",
          flush=True)


def k3_ops(cfg, w, counts):
    """Float32 operations that K3's image needs, on the ``work`` counts and
    this run's counting launch (``counts``: fr.fused_forward_counts): the
    grown-box test per real face at each pixel of an active tile and the
    geometry only where the box holds the pixel (``near``); z_map and the
    alpha factor per candidate; texel, shading and the weighted colour only
    for the candidates with a non-zero weight (``weighted``; under the
    argmax aggregations a pixel's winners); only the noise units that can
    change the image (``cover_drawn`` / ``agg_drawn``, each counted as one
    draw and one perturbed test); the softmax per live row; the background
    per pixel."""
    geom = OPS_GEOM + OPS_CLIP * cfg.clip_bary + (
        OPS_PERSP * cfg.perspective_correct)
    shade = OPS_TEXEL[cfg.tex_mode] + (
        OPS_PHONG if cfg.shade == "phong" else 0)
    draw = lambda noise: OPS_PAIR if noise == "gaussian" else OPS_CAUCHY
    ops = (counts["pixels"] * cfg.f_real * OPS_BOX + counts["near"] * geom
           + w["pixels"] * OPS_BG + w["cand"] * (OPS_ZMAP + OPS_ALPHA)
           + counts["weighted"] * (shade + OPS_BLEND - OPS_ALPHA))
    if cfg.rast_kind == "mc" and not cfg.prob_ext:
        ops += counts["cover_drawn"] * (draw(cfg.rast_noise) + OPS_COVER)
    elif not cfg.prob_ext:
        ops += w["cand"] * OPS_SOFT_COVER
    if cfg.agg_kind == "mc":
        ops += counts["agg_drawn"] * (draw(cfg.agg_noise) + OPS_AGG)
    elif cfg.agg_kind == "soft":
        ops += w["live"] * OPS_SOFTMAX
    return ops


def k11a_ops(cfg, counts):
    """Float32 operations that K11a's coverage needs, on its counting
    launch (fr.prob_counts): the grown-box test per real face at each pixel
    of an active tile, the geometry only where the box holds the pixel
    (``near``) and, under MC coverage, only the noise units drawn
    (``cover_drawn``, each one draw and one perturbed test per row: two
    rows a Box-Muller pair); otherwise one soft coverage per geometry
    run."""
    geom = OPS_GEOM + OPS_CLIP * cfg.clip_bary + (
        OPS_PERSP * cfg.perspective_correct)
    ops = counts["pixels"] * cfg.f_real * OPS_BOX + counts["near"] * geom
    if cfg.rast_kind != "mc":
        return ops + counts["near"] * OPS_SOFT_COVER
    draw = OPS_PAIR + 2 * OPS_COVER if cfg.rast_noise == "gaussian" \
        else OPS_CAUCHY + OPS_COVER
    return ops + counts["cover_drawn"] * draw


def k3_counts_text(counts):
    """The counting launch's certain pixels and draws skipped, as text,
    and the shares (certain, coverage skipped, aggregation skipped)."""
    share = lambda a, b: a / b if b else 0.0
    cert = share(counts["certain"], counts["pixels"])
    skip = {k: 1.0 - share(counts[f"{k}_drawn"], counts[f"{k}_full"])
            if counts[f"{k}_full"] else 0.0 for k in ("cover", "agg")}
    text = (f"certain pixels {counts['certain']} of {counts['pixels']} in "
            f"active tiles ({cert:.4f}); noise units (Box-Muller pairs) "
            f"skipped: coverage {counts['cover_full'] - counts['cover_drawn']}"
            f" of {counts['cover_full']} ({skip['cover']:.4f}), aggregation "
            f"{counts['agg_full'] - counts['agg_drawn']} of "
            f"{counts['agg_full']} ({skip['agg']:.4f})")
    return text, dict(certain_pixels=cert, coverage=skip["cover"],
                      aggregation=skip["agg"])


def n1_ms(fn, ins, *rest):
    """Mean ms of fn on the first batch element of ins (and of each tensor
    of rest), two turns of 10 calls: the shape the pose steps launch."""
    one = lambda t: t[:1].contiguous()
    args = tuple(one(t) for t in ins) + tuple(one(t) for t in rest)
    call = lambda: fn(*args)
    call()
    return (cuda_ms(call, 10) + cuda_ms(call, 10)) / 2


def phase_k3(dev, smi, report):
    for noise in ("gaussian", "softras"):
        cfg, ins = headline_inputs(noise, dev)
        got = fr.fused_forward(cfg, *ins)
        want = fr.forward_plain(cfg, *ins)
        ref = fr.fused_forward_reference(cfg, *ins)
        counted, counts = fr.fused_forward_counts(cfg, *ins)
        torch.cuda.synchronize()
        if noise == "gaussian":
            ok, dmax, dmean, flips = mc_close(got, want)
        else:
            d = (got - want).abs()
            dmax, dmean, flips = d.max().item(), d.mean().item(), 0.0
            ok = bool(torch.isfinite(got).all()) and dmax <= 2e-5
        if not ok:
            fail(f"K3 {noise}: max {dmax} mean {dmean} flips {flips}")
        # Softras's softmax sums the same rows in the same order, so every
        # pair keeps the per-pixel pipeline's bits.
        if not torch.equal(got, ref) or not torch.equal(counted, got):
            fail(f"K3 {noise}: differs from the per-pixel pipeline "
                 f"({(got - ref).abs().max().item()}) or the counting "
                 f"launch")
        k_ms, p_ms = timed_pair(
            lambda: fr.fused_forward(cfg, *ins),
            lambda: fr.forward_plain(cfg, *ins), 20)
        ref_ms = cuda_ms(lambda: fr.fused_forward_reference(cfg, *ins), 20)
        ms1 = n1_ms(lambda *a: fr.fused_forward(cfg, *a), ins)
        w = work(cfg, ins)
        b_ms, b_by = bound(table_bytes(cfg, N_POSES) + 16 * w["pixels"],
                           k3_ops(cfg, w, counts))
        ctext, shares = k3_counts_text(counts)
        if noise == "gaussian":
            report["fused_forward"] = dict(max_abs_err=dmax, ms=k_ms,
                                           plain_ms=p_ms, bound_ms=b_ms,
                                           bound_by=b_by, ms_n1=ms1,
                                           reference_ms=ref_ms,
                                           certain=shares)
        print(f"[K3] fused_forward {noise} 256^2 K=50 S=8 N=4 (f_pad "
              f"{cfg.f_pad}, c_zpad {cfg.c_zpad}): max |d| {dmax:.3g}, mean "
              f"|d| {dmean:.3g}, pixels beyond 1e-4 {flips:.3g}; bit-equal "
              f"to the per-pixel pipeline ({ref_ms:.4f} ms) and the counting "
              f"launch; {ctext}; {k_ms:.4f} ms vs plain {p_ms:.4f} ms per "
              f"render, N=1 {ms1:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"geometry inside the grown boxes, the draws taken, the "
              f"weighted candidates shaded) | {smi}", flush=True)
    # Above 64 samples (the flat route takes any S).
    renderer = headline_renderer("gaussian", dev, s=128)
    mesh = posed_cube(torch.Generator().manual_seed(0), dev)
    seeds = fr.draw_seeds(N_POSES, torch.Generator().manual_seed(1),
                          device=dev)
    cfg, ins = kernel_inputs(renderer, mesh, seeds)
    got = fr.fused_forward(cfg, *ins)
    ref = fr.fused_forward_reference(cfg, *ins)
    ok, dmax, dmean, flips = mc_close(got, fr.forward_plain(cfg, *ins))
    if not ok or not torch.equal(got, ref):
        fail(f"K3 S=128: max {dmax} mean {dmean} flips {flips}, bit-equal "
             f"to the per-pixel pipeline {torch.equal(got, ref)}")
    ms = (cuda_ms(lambda: fr.fused_forward(cfg, *ins), 5)
          + cuda_ms(lambda: fr.fused_forward(cfg, *ins), 5)) / 2
    ref_ms = cuda_ms(lambda: fr.fused_forward_reference(cfg, *ins), 5)
    print(f"[K3] fused_forward gaussian S=128 N=4: max |d| {dmax:.3g}, mean "
          f"|d| {dmean:.3g} against plain; bit-equal to the per-pixel "
          f"pipeline; {ms:.4f} ms vs the per-pixel pipeline {ref_ms:.4f} ms "
          f"| {smi}", flush=True)


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
        if noise == "gaussian":
            print(f"[K4] {grad_kernel_text('fused_backward', cfg, dev)}; "
                  f"{grad_split_text('fused_backward', cfg, ins, dev)} | "
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
        if noise == "gaussian":
            print(f"[K2] {grad_kernel_text('fused_loss_grad', cfg, dev)}; "
                  f"{grad_split_text('fused_loss_grad', cfg, ins, dev)} | "
                  f"{smi}", flush=True)


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
    key = "stream_forward_kernelILb0ELb0E"       # one pass, no counting
    lines = ptxas_report((key,)).get(key, ["not in the build log"])
    for noise in ("gaussian", "softras"):
        cfg, args = stream_inputs(noise, dev, N_POSES)
        count, active = args[2], args[3]
        shape = fr.stream_forward_shape(cfg, args[0].shape[2], dev)
        print(f"[K5] {noise}: ptxas stream_forward_kernel<one pass>: "
              f"{' | '.join(sorted(set(lines)))}; "
              f"{shape['blocks_per_sm'] * shape['warps']} resident warps per "
              f"SM ({shape['blocks_per_sm']} blocks of {shape['warps']} "
              f"warps, {shape['smem']} bytes of shared memory, "
              f"{shape['registers']} registers) | {smi}", flush=True)
        got = fr.fused_stream_forward(cfg, *args)
        again = fr.fused_stream_forward(cfg, *args)
        # The counting build: the same image, and the work it did, which
        # the bound counts.
        counted, counts = fr.stream_forward_counts(cfg, *args)
        torch.cuda.synchronize()
        if not torch.equal(counted, got):
            fail(f"K5 {noise}: the counting build's image differs")
        skip = {kind: (1.0 - counts[f"{kind}_drawn"] / counts[f"{kind}_need"]
                       if counts[f"{kind}_need"] else 0.0)
                for kind in ("cover", "agg")}
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
                           k5_ops(cfg, w, counts))
        full_ms, _ = bound(0, stream_forward_ops(cfg, w))
        if noise == "gaussian":
            report["fused_stream_forward"] = dict(
                max_abs_err=dmax, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by, draws_skipped={
                    "coverage": skip["cover"], "aggregation": skip["agg"]},
                winners_shaded=counts["winners"])
        print(f"[K5] {noise}: draws skipped over the call (Box-Muller "
              f"pairs): coverage {counts['cover_need'] - counts['cover_drawn']}"
              f" of {counts['cover_need']} ({skip['cover']:.4f}), aggregation "
              f"{counts['agg_need'] - counts['agg_drawn']} of "
              f"{counts['agg_need']} ({skip['agg']:.4f}); "
              f"{counts['winners']} distinct winners shaded (argmax); the "
              f"counting build's image bit-equal; the bound counts only "
              f"these draws and shadings: {b_ms:.4f} ms, against "
              f"{full_ms:.4f} ms with every candidate drawn and shaded | "
              f"{smi}", flush=True)
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
# The plain versions at S = 128 sweep every chunk once per sample, so
# their time goes with the chunks (5120 faces: 80; level 3: 20), not with
# the pixels: they are held on the level-3 cow.
STREAM_S128_LEVEL = 3
STREAM_S128_FULL_IMAGE = 32


def phase_stream_s128(dev, smi, _report):
    """The stream route above 64 aggregation samples (K5, K6 / K7's B1 in
    passes of 64): the gaussian pair at S = 128 on the level-3 cow (1280
    faces, 20 chunks) at 64^2, K=50, N=1.  A render (K5) at the MC
    tolerance of its plain version, and K6 and K7 (a pose step's loss
    and gradients) within 1e-3 of the nearer of the float32 and float64
    plain versions (``checks.stream_grads_close``),
    each repeat bit-equal; K7 = K5 + K6 (1e-5).  K7 also on the 5120-face
    cow (80 chunks) at 32^2 against its float64 plain version (1e-3 of
    max), the stream main paths' chunk list.  The render goes through
    MeshRenderer.forward and the step through render_loss as well, with
    the launch counts read around them."""
    size, s = STREAM_S128_IMAGE, STREAM_S128
    cfg, args = stream_inputs("gaussian", dev, 1, size, s, STREAM_S128_LEVEL)
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
    # K7 alone on the 5120-face cow (80 chunks, the stream main paths'
    # chunk list) at 32^2 against its float64 plain version.
    size_full = STREAM_S128_FULL_IMAGE
    cfg, args = stream_inputs("gaussian", dev, 1, size_full, s)
    args64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    kern = stream_grad_calls(cfg, args, size_full)[
        "fused_stream_loss_grad"][0]
    got, again = kern(), kern()
    want64 = stream_grad_calls(cfg, args64, size_full)[
        "fused_stream_loss_grad"][1]()
    torch.cuda.synchronize()
    ok, err, where, n_thin, bins = checks.stream_grads_close(
        cfg, args[0], got[1:], want64[1:], want64[1:], 1e-3)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    lerr = ((got[0] - want64[0]).abs() / want64[0].abs()).max().item()
    if not ok or not same or lerr > 1e-5:
        fail(f"stream S={s} K7 on the 5120-face cow at {size_full}^2 vs "
             f"float64 plain: worst error {err} at {where}, thin rows "
             f"{checks.witness_text(bins)}, repeat bit-equal {same}, loss "
             f"rel {lerr}")
    texts.append(f"K7 on the 5120-face cow ({cfg.rw // 64} chunks) at "
                 f"{size_full}^2 vs float64 plain: worst error {err:.3g} of "
                 f"max |grad| at {where} outside {n_thin} thin rows, loss "
                 f"rel {lerr:.3g}")
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
    print(f"[stream S={s}] gaussian cow (level {STREAM_S128_LEVEL}, "
          f"{20 * 4 ** STREAM_S128_LEVEL} faces) {size}^2 K={K} N=1: "
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
    # First its tile counts: the distinct faces of each tile of consecutive
    # columns, and their partial rows against the filled columns.
    rows = merged.shape[0]
    for tile in (512, 1024, 2048, 4096):
        tiles, _faces = ik.tile_partials(idx, rows, tile)
        per = torch.bincount(tiles, minlength=-(-p // tile)).float()
        print(f"[K10b] tiles of {tile} columns: {per.numel()} tiles, "
              f"distinct faces per tile mean {per.mean().item():.1f}, max "
              f"{int(per.max().item())}; {tiles.numel()} partial rows for "
              f"{filled} filled columns ({tiles.numel() / filled:.4f})"
              f"{' (the kernel tile)' if tile == ik.BWD_TILE else ''}",
              flush=True)
    g6 = torch.randn(6, p, generator=gen).to(dev)
    worst = 0.0
    for ix in (idx, edge):
        got = ik.interp_rows_backward(merged, ix, *ws, g6)
        again = ik.interp_rows_backward(merged, ix, *ws, g6)
        mirror = ik.interp_rows_backward_tiles_plain(merged, ix, *ws, g6)
        want = ik.interp_rows_backward_plain(merged, ix, *ws, g6)
        want64 = ik.interp_rows_backward_plain(
            merged.double(), ix, *(w.double() for w in ws), g6.double())
        errs = [nearer_error(got[0], want[0], want64[0])[0]] + [
            nearer_error(a, b, c)[0]
            for a, b, c in zip(got[1], want[1], want64[1])]
        same = torch.equal(got[0], again[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], again[1]))
        order = torch.equal(got[0], mirror[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], mirror[1]))
        worst = max(worst, *errs)
        if max(errs) > 1e-6 or not same or not order:
            fail(f"K10b: errors {errs} (table, w0, w1, w2), repeat "
                 f"bit-equal {same}, bit-equal to the tile-order mirror "
                 f"{order}")
        del mirror, want, want64
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
          f"out-of-range indices, repeat bit-equal, bit-equal to the plain "
          f"mirror of its order (tiles of {ik.BWD_TILE} columns, then tile "
          f"order); {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}) (its device split by kernel: "
          f"kernel_splits k10b) | {smi}", flush=True)


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


def phase_determinism(dev, smi, _report):
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
    # Bit for bit against the per-pixel reference (pixel_prob) and the
    # counting launch: N=4 and N=1, gaussian and cauchy (whose band holds
    # every candidate: it draws them all).
    one = lambda ts: tuple(t[:1].contiguous() for t in ts)
    counts = {}
    for noise in ("gaussian", "cauchy"):
        ncfg = dataclasses.replace(cfg, rast_noise=noise)
        for nn, args in ((n, cover), (1, one(cover))):
            got = fr.fused_prob(ncfg, *args)
            ref = fr.prob_reference(ncfg, *args)
            counted, c = fr.prob_counts(ncfg, *args)
            if not (torch.equal(got, ref) and torch.equal(got, counted)):
                fail(f"K11a {noise} N={nn}: not bit-equal to the per-pixel "
                     f"reference ({(got - ref).abs().max().item()}) or the "
                     f"counting launch")
            counts[(noise, nn)] = c
    c = counts[("gaussian", n)]
    k_ms, p_ms = timed_pair(lambda: fr.fused_prob(cfg, *cover),
                            lambda: fr.prob_plain(cfg, *cover), 20)
    ref_ms = cuda_ms(lambda: fr.prob_reference(cfg, *cover), 20)
    times = row("sharded_prob", dmax, k_ms, p_ms,
                4 * n * (cfg.f_pad * 10 + 34 + 4) + prob_b, k11a_ops(cfg, c))
    # N=1: the shape [train-sharded] launches K11a, K3e and K11b at.
    ms1 = n1_ms(lambda *a: fr.fused_prob(cfg, *a), cover)
    report["sharded_prob"].update(ms_n1=ms1, reference_ms=ref_ms)
    skip = 1.0 - c["cover_drawn"] / max(c["cover_full"], 1)
    cc = counts[("cauchy", n)]
    print(f"[K11a] sharded_prob 256^2 K=50 S_local={S_LOCAL} N=4, shard "
          f"{SHARD} (f_pad {cfg.f_pad}): max |d| {dmax:.3g}, mean |d| "
          f"{dmean:.3g}, pixels beyond 1e-4 {flips:.3g}, repeat bit-equal; "
          f"bit-equal to the per-pixel reference ({ref_ms:.4f} ms) and the "
          f"counting launch at N=4 and N=1, gaussian and cauchy; gaussian: "
          f"geometry at {c['near']} of {c['pixels'] * cfg.f_real} (face, "
          f"pixel) pairs, certain pixels {c['certain']} of {c['pixels']}, "
          f"coverage units drawn {c['cover_drawn']} of {c['cover_full']} "
          f"(skipped {skip:.4f}); cauchy drew {cc['cover_drawn']} of "
          f"{cc['cover_full']}; {times} (recounted: box tests, geometry in "
          f"the boxes, draws taken); N=1 {ms1:.4f} ms | {smi}", flush=True)

    img, wts = fr.fused_forward(cfg, *ins, prob=want_prob)
    want_img, want_w = fr.forward_plain(cfg, *ins, want_prob)
    again = fr.fused_forward(cfg, *ins, prob=want_prob)
    ref = fr.fused_forward_reference(cfg, *ins, prob=want_prob)
    counted, counts = fr.fused_forward_counts(cfg, *ins, prob=want_prob)
    torch.cuda.synchronize()
    ok, dmax, dmean, flips = mc_close(img, want_img)
    ok_w, wmax, wmean, wflips = fields_close(wts, want_w)
    same = torch.equal(img, again[0]) and torch.equal(wts, again[1])
    bits = all(torch.equal(a, b)
               for a, b in zip((img, wts) * 2, ref + counted))
    if not (ok and ok_w and same and bits):
        fail(f"K3e: image max {dmax} mean {dmean} flips {flips}; weights "
             f"max {wmax} mean {wmean} flips {wflips}; repeat {same}; "
             f"bit-equal to the per-pixel pipeline and the counting launch "
             f"{bits}")
    k_ms, p_ms = timed_pair(
        lambda: fr.fused_forward(cfg, *ins, prob=want_prob),
        lambda: fr.forward_plain(cfg, *ins, want_prob), 20)
    ref_ms = cuda_ms(
        lambda: fr.fused_forward_reference(cfg, *ins, prob=want_prob), 20)
    ms1 = n1_ms(lambda *a: fr.fused_forward(cfg, *a[:8], prob=a[8]), ins,
                want_prob)
    b_ms, b_by = bound(tabs + prob_b + 16 * px + zrows_b,
                       k3_ops(cfg, w, counts))
    ctext, shares = k3_counts_text(counts)
    report["fused_forward"]["modes"] = {"prob_ext": dict(
        max_abs_err=max(dmax, wmax), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, ms_n1=ms1, reference_ms=ref_ms, certain=shares)}
    print(f"[K3e] fused_forward with external coverage (the sharded "
          f"route's K3), 256^2 N=4: image max |d| {dmax:.3g} mean {dmean:.3g}"
          f", weights max |d| {wmax:.3g} mean {wmean:.3g}, repeat "
          f"bit-equal, image and weights bit-equal to the per-pixel "
          f"pipeline ({ref_ms:.4f} ms) and the counting launch; {ctext}; "
          f"{k_ms:.4f} ms vs plain {p_ms:.4f} ms, N=1 {ms1:.4f} ms, bound "
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
    counted, counts = fr.agg_bwd_counts(cfg, *ins, want_prob, g_out)
    if not all(torch.equal(a, b) for a, b in zip(counted, (gz, gg))):
        fail("K11b: the counting launch differs")
    k_ms, p_ms = timed_pair(
        lambda: fr.fused_agg_bwd(cfg, *ins, want_prob, g_out),
        lambda: fr.agg_bwd_plain(cfg, *ins, want_prob, g_out), 5)
    times = row("sharded_agg_bwd", max(errs), k_ms, p_ms,
                tabs + prob_b + 16 * px + zrows_b + 4 * n,
                w["faces"] * geom + w["cand"] * (shade + OPS_ZMAP)
                + agg_grad_ops)
    ms1 = n1_ms(lambda *a: fr.fused_agg_bwd(cfg, *a), ins, want_prob, g_out)
    cert = counts["certain"] / max(counts["pixels"], 1)
    skip = 1.0 - counts["drawn"] / max(counts["full"], 1)
    report["sharded_agg_bwd"].update(ms_n1=ms1, certain=dict(
        certain_pixels=cert, aggregation=skip))
    print(f"[K11b] sharded_agg_bwd 256^2 N=4: g_zmap {errs[0]:.3g} and the "
          f"gamma term {errs[1]:.3g} of max (tolerance 1e-3), repeat and "
          f"counting launch bit-equal; certain pixels {counts['certain']} of "
          f"{counts['pixels']} in active tiles ({cert:.4f}), replay noise "
          f"units skipped {counts['full'] - counts['drawn']} of "
          f"{counts['full']} ({skip:.4f}); {times}; N=1 {ms1:.4f} ms "
          f"(its device split: kernel_splits k11b) | {smi}", flush=True)

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
    # N=1: the shape [train-sharded] launches it at.
    one = lambda t: t[:1].contiguous()
    ins1 = tuple(one(t) for t in ins)
    det1 = (one(want_prob), one(want_w), one(want_gz), one(g_out))
    ms1 = cuda_ms(lambda: fr.fused_det_bwd(cfg, *ins1, *det1), 10)
    ms1 = (ms1 + cuda_ms(lambda: fr.fused_det_bwd(cfg, *ins1, *det1), 10)) / 2
    report["sharded_det_bwd"]["ms_n1"] = ms1
    print(f"[K11c] sharded_det_bwd 256^2 N=4: worst table error {err:.3g} "
          f"of max at {where} (tolerance 1e-3), repeat bit-equal; {times}; "
          f"N=1 ([train-sharded]'s shape) {ms1:.4f} ms | {smi}", flush=True)


def split_times(fn, reps, names=None):
    """Milliseconds per call of fn: the whole (host clock, synchronised),
    its kernels (CUDA events around each of the kernel wrappers ``names``
    of ops/fused_render.py, the flat sharded route's by default), its
    collectives
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

    saved = {name: getattr(fr, name) for name in names or SHARDED_KERNELS}
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


def phase_dryrun_sharded(dev, smi, _report):
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


# ---------------------------------------------------------------------------
# The experiment CLI, checkpoint / resume and the scene-parameter loop
# ---------------------------------------------------------------------------

# The child process of the CLI phases: each argv in turn through the CLI's
# own entry (runpy, as ``python -m``), the launch counts reset just before
# each run and printed just after it.
CLI_CHILD = """
import json, runpy, sys
sys.path.insert(0, {root!r})
import chip_smoke as cs
for i, argv in enumerate({argvs!r}):
    sys.argv = ["eval"] + argv
    print("@@run", i, flush=True)
    cs.reset_counts()
    runpy.run_module("pertrenderer_tpu_torch.experiments.eval",
                     run_name="__main__")
    print("@@counts", json.dumps(cs.all_counts()), flush=True)
"""


def cli_runs(argvs, timeout=900):
    """[(stdout, launch counts)] of ``python -m
    pertrenderer_tpu_torch.experiments.eval`` on each argv, in one child
    process on the card (the kernels already built)."""
    out = subprocess.run(
        [sys.executable, "-c", CLI_CHILD.format(root=HERE, argvs=argvs)],
        capture_output=True, text=True, timeout=timeout, cwd=HERE)
    if out.returncode != 0:
        fail(f"experiment CLI: rc {out.returncode}: {out.stderr[-3000:]}")
    runs = []
    for chunk in out.stdout.split("@@run ")[1:]:
        text, _sep, counts = chunk.partition("@@counts ")
        runs.append((text, json.loads(counts.splitlines()[0])))
    if len(runs) != len(argvs):
        fail(f"experiment CLI: {len(runs)} of {len(argvs)} runs reported")
    return runs


def read_json(root, eid, name):
    with open(os.path.join(root, str(eid), name)) as f:
        return json.load(f)


def first_call(name, run):
    """The arguments of the first call of ``fr.<name>`` that ``run()``
    makes; every call goes on as usual."""
    orig, calls = getattr(fr, name), []

    def spy(*a):
        calls.append(a)
        return orig(*a)

    setattr(fr, name, spy)
    try:
        run()
    finally:
        setattr(fr, name, orig)
    if not calls:
        fail(f"no call of {name}")
    return calls[0]


def scene_loss_grad_check(tag, a, tol):
    """K2 (``tag`` K2) or K7 on the arguments ``a`` that a scene step gave
    it, loss_kind l1_rgb (the sign of d, not 2d), against its plain
    version on the same inputs: the loss within 1e-5; the tables and
    every scalar (the light location among them) as [K2] / [K7] hold
    them, K7's also against the plain version in float64
    (``checks.stream_grads_close``); repeat bit-equal.  Returns a text."""
    stream = tag == "K7"
    if a[-2] != "l1_rgb":
        fail(f"{tag} in a scene step: loss_kind {a[-2]!r}, not l1_rgb")
    kern, plain = ((fr.fused_stream_loss_grad, fr.stream_loss_grad_plain)
                   if stream else (fr.fused_loss_grad, fr.loss_grad_plain))
    got, again, want = kern(*a), kern(*a), plain(*a)
    torch.cuda.synchronize()
    if stream:
        a64 = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                    else x for x in a)
        want64 = plain(*a64)
        ok, err, where, n_thin, _bins = checks.stream_grads_close(
            a[0], a[1], got[1:], want[1:], want64[1:], tol)
        thin = f" outside the {n_thin} rows of thin faces"
    else:
        ok, err, where = tables_close(got[1:], want[1:], tol)
        thin = ""
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    lerr = ((got[0] - want[0]).abs() / want[0].abs()).max().item()
    light = [got[-1][:, fr._S_LIGHT + i].sum().item() for i in range(3)]
    light_p = [want[-1][:, fr._S_LIGHT + i].sum().item() for i in range(3)]
    if not ok or not same or lerr > 1e-5:
        fail(f"{tag} l1_rgb in a scene step: worst error {err} at {where} "
             f"(tolerance {tol}), loss rel {lerr}, repeat bit-equal {same}; "
             f"light gradient {light} vs plain {light_p}")
    return (f"{tag} l1_rgb on a scene step's inputs (N={a[1].shape[0]}) vs "
            f"its plain version: loss rel {lerr:.3g}, worst error "
            f"{err:.3g} of max |grad| at {where}{thin} (tolerance {tol}), "
            f"light-location gradient ({', '.join(f'{x:.6g}' for x in light)}"
            f") vs plain ({', '.join(f'{x:.6g}' for x in light_p)}), repeat "
            f"bit-equal")


def check_diff_step_checks(dev, tmp):
    """``scene_loss_grad_check`` of K2 on the cube and K7 on the sphere,
    each on the inputs of the first step of ``eval -et check_diff``
    (gaussian, sigma 1e-4: the tolerance of [K2] / [K7] gaussian)."""
    texts = []
    for cat, tag, name in (("cube", "K2", "fused_loss_grad"),
                           ("sphere", "K7", "fused_stream_loss_grad")):
        args = eval_cli.build_parser().parse_args(
            ["-et", "check_diff", "-cat", cat, "-ni", "1", "--results-dir",
             tmp, "--device", "cuda"])
        with contextlib.redirect_stdout(io.StringIO()):
            a = first_call(name, lambda: eval_cli.check_differentiability(
                args, dev))
        texts.append(f"{cat}: {scene_loss_grad_check(tag, a, 1e-3)}")
    return texts


EVAL_FILES = ("angle_error.txt", "angle_error_final.txt",
              "angle_error_init.txt", "angle_std.txt",
              "solved_percentage.txt", "params.txt", "exp_setup.txt")
EVAL_ITERS, RUNTIME_ITERS, CHECK_DIFF_ITERS = 150, 100, 100


def phase_cli(dev, smi, report):
    """[eval-pose], [eval-runtime], [check-diff]: the port's experiment CLI
    in one child process on the card; then K2 and K7 (l1_rgb) on the
    inputs of check_diff's first step against their plain versions."""
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        common = ["--results-dir", tmp, "--device", "cuda"]
        ckpt_root = os.path.join(tmp, "ckpt")
        ckpt = [os.path.join(ckpt_root, eid, "check_diff")
                for eid in ("3", "4")]
        argvs = [
            ["-et", "pose_opt", "-eid", "1", "-np", "2", "-ni",
             str(EVAL_ITERS), "-is", "128", "-sn", "gaussian", "softras"]
            + common,
            ["-et", "runtime", "-eid", "2", "-np", "1", "-ni",
             str(RUNTIME_ITERS)] + common,
            ["-et", "check_diff", "-eid", "3", "-ni", str(CHECK_DIFF_ITERS),
             "--checkpoint-dir", ckpt_root] + common,
            ["-et", "check_diff", "-eid", "4", "-cat", "sphere", "-ni",
             str(CHECK_DIFF_ITERS), "--checkpoint-dir", ckpt_root] + common]
        t0 = time.perf_counter()
        runs = cli_runs(argvs)
        wall = time.perf_counter() - t0

        # [eval-pose]
        (text, counts) = runs[0]
        missing = [f for f in EVAL_FILES
                   if not os.path.exists(os.path.join(tmp, "1", f))]
        if missing:
            fail(f"eval-pose: artifacts missing: {missing}")
        init = read_json(tmp, 1, "angle_error_init.txt")
        final = read_json(tmp, 1, "angle_error_final.txt")
        steps = 2 * 2 * EVAL_ITERS
        if (counts["fused_loss_grad"] != steps or counts["prng_probe"] < 1
                or counts["gather_rows_cm"] < 1):
            fail(f"eval-pose: launch counts {counts}")
        errs = {nt: list(zip(init[nt][0], final[nt][0])) for nt in init}
        if not all(0 <= e < 5.0 for _i, e in errs["gaussian"]):
            fail(f"eval-pose: gaussian errors {errs['gaussian']} (deg), "
                 "not all below 5")
        report["paths"]["eval-pose"] = counts
        per = "; ".join(f"{nt} " + ", ".join(f"{a:.2f} -> {b:.2f}"
                                             for a, b in pairs)
                        for nt, pairs in errs.items())
        print(f"[eval-pose] eval -et pose_opt -np 2 -ni {EVAL_ITERS} -is 128 "
              f"-sn gaussian softras (the cube, flat route): {per} deg; "
              f"{len(EVAL_FILES)} JSON artifacts; launches K2 "
              f"{counts['fused_loss_grad']} ({steps} steps), K1 "
              f"{counts['prng_probe']}, K9a {counts['gather_rows_cm']} (the "
              f"targets among them), K9b {counts['scatter_rows_cm']}, K3 "
              f"{counts['fused_forward']} (the run artifacts' images) | {smi}",
              flush=True)

        # [eval-runtime]
        (text, counts) = runs[1]
        runtimes = read_json(tmp, 2, "runtimes.txt")
        memory = read_json(tmp, 2, "memory.txt")
        if counts["fused_loss_grad"] != 2 * RUNTIME_ITERS:
            fail(f"eval-runtime: launch counts {counts}")
        if not all(m[0][0] and m[0][0] > 0 for m in memory.values()):
            fail(f"eval-runtime: peak memory {memory}")
        report["paths"]["eval-runtime"] = counts
        runs_text = "; ".join(
            f"{nt} {runtimes[nt][0][0]:.3f} s ({RUNTIME_ITERS / runtimes[nt][0][0]:.1f} "
            f"steps/s), peak {memory[nt][0][0]:.1f} MB" for nt in runtimes)
        print(f"[eval-runtime] eval -et runtime -np 1 -ni {RUNTIME_ITERS} "
              f"(128^2, S=8): {runs_text} (torch.cuda.max_memory_allocated); "
              f"launches K2 {counts['fused_loss_grad']} | {smi}", flush=True)

        # [check-diff]
        lines = []
        for (text, counts), path, route, key in zip(
                runs[2:], ckpt, ("cube, flat", "sphere, stream"),
                ("fused_loss_grad", "fused_stream_loss_grad")):
            other = ("fused_stream_loss_grad" if key == "fused_loss_grad"
                     else "fused_loss_grad")
            if counts[key] != CHECK_DIFF_ITERS or counts[other] != 0:
                fail(f"check-diff ({route}): launch counts {counts}")
            st = ckpt_mod.restore_checkpoint(path)
            losses = st["losses"].numpy()
            light = st["params"]["lights_location"][0].tolist()
            best = st["best_params"]["lights_location"][0].tolist()
            first, last = losses[:10].mean(), losses[-10:].mean()
            if not (np.all(np.isfinite(losses)) and last < first):
                fail(f"check-diff ({route}): losses {losses[:10]} ... "
                     f"{losses[-10:]}: no fall")
            report["paths"][f"check-diff-{route.split(',')[0]}"] = counts
            mid = ckpt_mod.restore_checkpoint(path, CHECK_DIFF_ITERS // 2)
            lines.append(
                f"{route} (K{'2' if key == 'fused_loss_grad' else '7'} "
                f"{counts[key]}): loss {losses[0]:.5f} -> {losses[-1]:.5f} "
                f"(mean of the first / last 10 {first:.5f} / {last:.5f}); "
                f"light (0, 6, -1) -> "
                f"{tuple(round(x, 3) for x in mid['params']['lights_location'][0].tolist())}"
                f" at step {CHECK_DIFF_ITERS // 2} -> "
                f"{tuple(round(x, 3) for x in light)}, best "
                f"{tuple(round(x, 3) for x in best)}")
        print(f"[check-diff] eval -et check_diff -ni {CHECK_DIFF_ITERS} "
              f"(light only, 128^2, gaussian S=8, sigma 1e-4): "
              + "; ".join(lines) + f"; the CLI's four runs {wall:.1f} s in "
              f"one process | {smi}", flush=True)
        for text in check_diff_step_checks(dev, tmp):
            print(f"[check-diff] {text} | {smi}", flush=True)


def phase_resume(dev, smi, report):
    """optimize_pose for 100 steps straight, then 50 steps, a checkpoint
    and a resume of 50 in the same process: bit-equal on the card."""
    r_true = ptt.random_rotations(1, torch.Generator().manual_seed(2029),
                                  device="cpu").to(dev)
    mesh, cams, lights, renderer, log_rot, target = train_setup(dev, r_true,
                                                                5)

    def run(**extra):
        return harness.optimize_pose(
            mesh, cams, lights, log_rot, renderer, [target],
            generator=torch.Generator().manual_seed(8), lr_init=TRAIN_LR,
            Niter=100, segment_size=50, **extra)

    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        torch.cuda.synchronize()
        reset_counts()
        full = run()
        killed = run(checkpoint_dir=tmp, max_segments=1)
        resumed = run(checkpoint_dir=tmp, resume=True)
        counts = dict(fr.launch_counts)
    if counts["fused_loss_grad"] != 200:
        fail(f"resume: launch counts {counts}")
    same = (torch.equal(resumed.log_rot, full.log_rot)
            and torch.equal(resumed.best_log_rot, full.best_log_rot)
            and np.array_equal(resumed.losses, full.losses)
            and np.array_equal(resumed.grad_norms, full.grad_norms))
    if killed.losses.shape != (50,) or not same:
        fail(f"resume: not bit-equal: log_rot {resumed.log_rot} vs "
             f"{full.log_rot}, losses differ at "
             f"{np.flatnonzero(resumed.losses != full.losses)[:5]}")
    report["paths"]["resume"] = dict(counts, **dict(gk.launch_counts))
    print(f"[resume] optimize_pose 100 steps (cube, 256^2, N=1, segments of "
          f"50) = 50 steps, checkpoint, resume 50: log_rot, best iterate, "
          f"100 losses and gradient norms bit-equal; loss "
          f"{full.losses[0]:.5g} -> {full.losses[-1]:.5g}, pose error "
          f"{degrees_off(log_rot, r_true):.2f} -> "
          f"{degrees_off(full.best_log_rot, r_true):.2f} deg; launches K2 "
          f"{counts['fused_loss_grad']} | {smi}", flush=True)


# The recipe of the JAX run in artifacts/config3.json: its "recipe", and
# what its commit message and NOTES.md add: the 64 -> 128 -> 256
# schedule (three refine blocks per finer size), the texture's Laplacian
# at 3e-3 and a 300-step final refit (1480 steps in all).
CONFIG3_ARGS = ["--views", "4", "--image", "256", "--schedule", "64,128,256",
                "--alternate", "8", "--refine-blocks", "3",
                "--warmup-iters", "60", "--tex-iters", "40",
                "--cam-iters", "40", "--final-tex-iters", "300",
                "--sigma0", "3e-3", "--gamma0", "3e-2", "--adapt-sigma",
                "1.2", "--adapt-gamma", "1.2", "--cam-lr-scale", "8",
                "--lr-decay", "1.25", "--lr", "5e-2", "--samples", "8",
                "--tex-smooth", "3e-3",
                "--seed", "0", "--device", "cuda"]


def phase_config3(dev, smi, report):
    """BASELINE config 3 through experiments/config3.py at the JAX run's
    recipe: the cow at 4 views, 64 -> 128 -> 256^2, S=8, K7 once per
    step; then K7's share of a synchronised scene step at 256^2, and K7
    (l1_rgb) on that step's inputs against its plain version."""
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        torch.cuda.synchronize()
        reset_counts()
        rec = config3.main(CONFIG3_ARGS + ["--out",
                                           os.path.join(tmp, "c3.json")])
        counts = dict(fr.launch_counts)
        k9b = k9b_per(report, "config3", rec["iters_total"], "step")
        counts.update(gk.launch_counts)
    steps = rec["iters_total"]
    if (counts["fused_stream_loss_grad"] != steps
            or counts["fused_loss_grad"] != 0):
        fail(f"config3: launch counts {counts} for {steps} steps")
    cam = rec["camera_err_deg_final"]
    per_view = [max(e, a) for e, a in zip(cam["elev_per_view"],
                                          cam["azim_per_view"])]
    if not (rec["loss_best"] is not None and np.isfinite(rec["loss_best"])
            and max(per_view) < 2.0
            and rec["texture_mae_vs_true_best"] <= 0.25):
        fail(f"config3: camera errors {cam}, texture MAE "
             f"{rec['texture_mae_vs_true_best']}")
    report["paths"]["config3"] = counts

    # K7's share of a step: ten synchronised scene steps at 256^2, 4
    # views, the cameras 1 degree off, the texture white.
    mesh = config3.cow(dev).extend(4)
    azim = 120.0 + 90.0 * torch.arange(4, device=dev)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), batch=4,
                                    device=dev)
    r, t = ptt.look_at_view_transform(dist=6.7, elev=30.0, azim=azim,
                                      device=dev)
    cams = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=dev)
    with torch.no_grad():
        target = harness.get_hard_rendering(mesh, cams, lights, IMAGE)[
            ..., :3]
    rend = config3.renderer(lights, IMAGE, 3e-3 / 1.2 ** 10,
                            3e-2 / 1.2 ** 10, 8, 50, dev)
    params = {"verts_rgb": torch.ones(1, mesh.max_verts, 3, device=dev),
              "deform": torch.zeros(mesh.max_verts, 3, device=dev),
              "camera_elev": torch.full((4,), 31.0, device=dev),
              "camera_azim": azim + 1.0,
              "lights_location": torch.tensor([[0.0, 2.0, -2.0]],
                                              device=dev)}
    state = [harness.SceneState.start(params, {
        "verts_rgb": True, "deform": False, "camera_elev": False,
        "camera_azim": False, "lights_location": False})]
    opt = torch.optim.Adam([state[0].params["verts_rgb"]], lr=5e-2)
    gen = torch.Generator().manual_seed(3)

    def step():
        seeds = fr.draw_seeds(4, gen, device=dev)
        state[0] = harness.scene_step(mesh, target, state[0], rend, opt,
                                      seeds, textured=True)[0]

    l1_text = scene_loss_grad_check(
        "K7", first_call("fused_stream_loss_grad", step), 1e-3)
    sp = split_times(step, 10, ("fused_stream_loss_grad",))
    print(f"[config3] experiments/config3.py at the recipe of "
          f"artifacts/config3.json (the cow, 5120 faces, 4 views, 64 -> 128 "
          f"-> 256^2, S=8, {steps} steps): camera error per view "
          f"{', '.join(f'{e:.3f}' for e in per_view)} deg (from 10 / 20; "
          f"elev {cam['elev_per_view']}, azim {cam['azim_per_view']}); "
          f"texture MAE {rec['texture_mae_vs_true_init']:.4f} -> best "
          f"{rec['texture_mae_vs_true_best']:.4f}; loss "
          f"{rec['loss_first']:.5f} -> {rec['loss_last']:.5f} (best "
          f"{rec['loss_best']:.5f}); {rec['steps_per_sec']:.2f} steps/s, "
          f"{rec['renders_per_sec']:.2f} view renders/s, wall "
          f"{rec['wall_seconds_total']:.1f} s; launches K7 "
          f"{counts['fused_stream_loss_grad']} (one per step), {k9b}; a "
          f"synchronised scene step at 256^2 (4 views): "
          f"{sp['total']:.2f} ms, K7 {sp['kernels']:.2f} ms "
          f"({sp['kernels'] / sp['total']:.1%}), the rest {sp['host']:.2f} "
          f"ms | {smi}", flush=True)
    print(f"[config3] {l1_text} (cow 256^2, S=8, 4 views, cameras 1 degree "
          f"off, white texture) | {smi}", flush=True)


def png_bytes(img):
    """An 8-bit RGB PNG (every row filter 0) of img (H, W, 3) uint8."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_shapenet_fixture(root):
    """A two-triangle model in ShapeNetCore's layout for the mug category
    (``<synset>/<model>/models/model_normalized.obj`` with its MTL and an
    8 x 8 PNG map, red left, blue right), as tests/test_structures_io.py
    builds it."""
    model = os.path.join(root, harness.SHAPENET_CATEGORIES["mug"],
                         harness.SHAPENET_MODELS["mug"], "models")
    os.makedirs(model)
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:, :4] = (255, 0, 0)
    tex[:, 4:] = (0, 0, 255)
    with open(os.path.join(model, "tex.png"), "wb") as f:
        f.write(png_bytes(tex))
    with open(os.path.join(model, "model_normalized.mtl"), "w") as f:
        f.write("newmtl m0\nKd 1.0 1.0 1.0\nmap_Kd tex.png\n")
    with open(os.path.join(model, "model_normalized.obj"), "w") as f:
        f.write("mtllib model_normalized.mtl\n"
                "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
                "vt 0.1 0.1\nvt 0.9 0.1\nvt 0.9 0.9\nvt 0.1 0.9\n"
                "usemtl m0\nf 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")


def phase_obj_io(dev, smi, report):
    """OBJ I/O: the native and the Python parser agree on the 81,920-face
    icosphere written by save_obj (parse times in host seconds); the cow
    through save_obj -> load_objs_as_meshes -> a K5 render, bit-equal to
    the render of the same vertices rounded to %.6f in memory; the
    synthetic ShapeNet model through harness.init_target (TexturesAtlas,
    the staged Hard-Phong target)."""
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        verts, faces = ptt.make_icosphere(6)
        path = os.path.join(tmp, "icosphere6.obj")
        t0 = time.perf_counter()
        ptt.save_obj(path, verts, faces)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native.library()
        build_s = time.perf_counter() - t0
        times = {}
        for name, use_native in (("native", True), ("python", False)):
            t0 = time.perf_counter()
            got = ptt.load_obj(path, use_native=use_native)
            times[name] = time.perf_counter() - t0
            if name == "native":
                nat = got
        if not (np.array_equal(nat[0], got[0])
                and np.array_equal(nat[1].verts_idx, got[1].verts_idx)
                and np.array_equal(nat[1].verts_idx, faces)
                and np.abs(nat[0] - verts).max() <= 1e-6):
            fail("obj-io: the native and the Python parser disagree on the "
                 "level-6 icosphere")

        cow = cow_mesh(dev)
        cpath = os.path.join(tmp, "cow.obj")
        ptt.save_obj(cpath, cow.verts[0], cow.faces[0])
        rounded = np.array([[float(f"{x:.6f}") for x in row]
                            for row in cow.verts[0].cpu().numpy()],
                           np.float32)
        rend = headline_renderer("gaussian", dev, 1)
        seeds = fr.draw_seeds(1, torch.Generator().manual_seed(4),
                              device=dev)
        write_shapenet_fixture(tmp)
        torch.cuda.synchronize()
        reset_counts()
        loaded = ptt.load_objs_as_meshes([cpath], device=dev)
        img = rend(loaded, seeds=seeds)
        target = harness.init_target(
            torch.Generator().manual_seed(7), category="mug",
            shapenet_path=tmp, imsize=IMAGE, device=dev)[3][0]
        torch.cuda.synchronize()
        counts = all_counts()
        k9b = k9b_per(report, "obj-io", 1, "run")
        mug = harness._load_shapenet("mug", tmp, dev)
    mem = ptt.Meshes.create(rounded, cow.faces[0], device=dev,
                            textures=ptt.TexturesVertex(torch.ones(
                                1, rounded.shape[0], 3, device=dev)))
    img_mem = rend(mem, seeds=seeds)
    if not (torch.equal(loaded.verts, mem.verts)
            and torch.equal(loaded.faces, mem.faces)
            and rend.plan(loaded).mode == "stream"
            and torch.equal(img, img_mem)
            and bool(torch.isfinite(img).all())
            and (img[..., 3] > 0.5).float().mean().item() > 0.05):
        fail(f"obj-io: the loaded cow's render differs from the in-memory "
             f"one (verts equal {torch.equal(loaded.verts, mem.verts)}, "
             f"max |d| {(img - img_mem).abs().max().item()})")
    atlas = mug.textures.atlas
    lit = int((target.sum(-1) > 0).sum().item())
    if not (isinstance(mug.textures, ptt.TexturesAtlas)
            and tuple(atlas.shape) == (1, 2, 4, 4, 3)
            and atlas[..., 0].max() > 0.9 and atlas[..., 2].max() > 0.9
            and bool(torch.isfinite(target).all()) and lit > 100):
        fail(f"obj-io: the ShapeNet fixture: textures "
             f"{type(mug.textures).__name__}, atlas {tuple(atlas.shape)}, "
             f"{lit} lit pixels")
    try:
        harness.init_target(category="mug", shapenet_path=None, device=dev)
    except FileNotFoundError:
        pass
    else:
        fail("obj-io: a ShapeNet category without shapenet_path did not "
             "raise FileNotFoundError")
    if counts["fused_stream_forward"] < 1 or counts["gather_rows_cm"] < 1:
        fail(f"obj-io: launch counts {counts}")
    report["paths"]["obj-io"] = counts
    used = {k: v for k, v in counts.items() if v}
    print(f"[obj-io] the level-6 icosphere (40,962 verts, 81,920 faces) "
          f"through save_obj ({save_s:.3f} s) and load_obj: native and "
          f"Python parsers equal; host seconds: native parse "
          f"{times['native']:.4f} s (its g++ build {build_s:.2f} s, once), "
          f"Python parse {times['python']:.4f} s "
          f"({times['python'] / times['native']:.1f}x); the cow (5120 "
          f"faces) save_obj -> load_objs_as_meshes -> K5 render at "
          f"{IMAGE}^2 bit-equal to the in-memory mesh of the same rounded "
          f"vertices; the ShapeNet fixture (mug) -> init_target: "
          f"TexturesAtlas {tuple(atlas.shape)}, Hard-Phong target {lit} lit "
          f"pixels; no shapenet_path -> FileNotFoundError; launches {used}, "
          f"{k9b} | {smi}", flush=True)


def phase_config2(dev, smi, report):
    """BASELINE config 2 through experiments/config2.py's main at 128^2:
    the level-2 icosphere's silhouette through the staged rasterizer (K9a,
    gradient K9b) and GaussianRast's perturbed Heaviside (K8a): the
    60-step scale fit from 0.7 within 0.08 of 1; the gradient-variance
    sweep over S in {4, 16, 64}, 24 seed words each, on the synthetic field
    and on the scene's own dists (falling, var(4) / var(64) > 4); the
    gumbel perturbed argmax (K8b) whose weights sum to 1 within 1e-5.
    Then the estimator kernels of the path against their plain versions at
    its own shapes, on shared noise: K8a's mean and coefficient on the
    scene's -dists (gaussian, sigma 1e-3, S=8), K8b with gumbel noise on
    the scene's z_map (gamma 1e-2, S=16); the forwards at the MC tolerance
    (``estimator_close``) and bit-equal where no draw is made, the
    coefficient within 1e-3 of its max; K8b's output bit-equal to the
    path's gumbel weights."""
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = config2.main(["--device", str(dev), "--out",
                                os.path.join(tmp, "config2.json")])
        torch.cuda.synchronize()
        counts = all_counts()
    k9b = k9b_per(report, "config2", config2.FIT_STEPS, "fit step")
    fit, var = rec["fit"], rec["variance"]
    wsum = rec["gumbel_max_abs_sum_minus_1"]
    falls = lambda v: v[0] > v[1] > v[2] and v[0] / v[2] > 4.0
    if not (fit["within_0.08"] and falls(var["field"])
            and falls(var["scene"]) and wsum <= 1e-5
            and rec["gumbel_finite"]):
        fail(f"config2: {json.dumps(rec)}")
    if (counts["gather_rows_cm"] < 1 or counts["scatter_rows_cm"] < 1
            or counts["heaviside_mean"] < 1 or counts["argmax_mean"] < 1):
        fail(f"config2: launch counts {counts}")
    report["paths"]["config2"] = counts

    from pertrenderer_tpu_torch.models import smoothagg
    mesh, cams = config2.scene(dev)
    seeds = fr.draw_seeds(1, torch.Generator().manual_seed(
        config2.GUMBEL_SEED), device=dev)
    rs, ags = seeds[:, :2].contiguous(), seeds[:, 2:].contiguous()
    with torch.no_grad():
        frags = ptt.rasterize_meshes(mesh, cams,
                                     config2.settings(config2.IMAGE))
        agg, zbuf, prob, mask = config2.gumbel_inputs(mesh, cams,
                                                      config2.IMAGE)
        z = smoothagg._z_map(agg.gamma.to(dev), agg.alpha.to(dev), agg.eps,
                             zbuf, config2.ZFAR, config2.ZNEAR, prob, mask,
                             corrected_prod=agg.corrected_prod).contiguous()
        w_path = config2.gumbel_weights(mesh, cams, config2.IMAGE, seeds)
    d = (-frags.dists).contiguous()
    sigma = torch.tensor(config2.SIGMA, device=dev)
    gamma = agg.gamma.to(dev)
    band = pk.heaviside_band(d, sigma, "gaussian")
    cand = pk.argmax_candidates(z, gamma, "gumbel")
    drawn = cand & ~(cand.sum(-1, keepdim=True) == 1)
    texts = []
    for tag, kern, plain, where in (
            ("K8a heaviside_mean",
             lambda: pk.heaviside_mean(d, sigma, rs, config2.S, "gaussian"),
             lambda: pk.heaviside_mean_plain(d, sigma, rs, config2.S,
                                             "gaussian"), band),
            ("K8a heaviside_coeff",
             lambda: pk.heaviside_coeff(d, sigma, rs, config2.S, "gaussian"),
             lambda: pk.heaviside_coeff_plain(d, sigma, rs, config2.S,
                                              "gaussian", True), band),
            ("K8b argmax_mean gumbel",
             lambda: pk.argmax_mean(z, gamma, ags, agg.nb_samples, "gumbel"),
             lambda: pk.argmax_mean_plain(z, gamma, ags, agg.nb_samples,
                                          "gumbel"), drawn)):
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        exact = torch.equal(got[~where], want[~where])
        if "coeff" in tag:
            ok, err = grad_close(got, want)
            text = f"within {err:.3g} of max"
        else:
            ok, err, dmean, flips = estimator_close(got, want)
            text = (f"max |d| {err:.3g}, mean |d| {dmean:.3g}, elements "
                    f"beyond 1e-4 {flips:.3g}")
        same = torch.equal(got, again)
        if "argmax" in tag:
            same = same and torch.equal(got, w_path)
        if not ok or not same or not exact:
            fail(f"config2 {tag} {tuple(got.shape)}: {text}, repeat and "
                 f"path bit-equal {same}, bit-equal where no draw is made "
                 f"{exact}")
        texts.append(f"{tag} {tuple(got.shape)} {text}")
    used = {k: v for k, v in counts.items() if v}
    ratio = lambda v: ", ".join(f"{x:.4g}" for x in v) + (
        f" (4 / 64: {v[0] / v[2]:.2f}x)")
    print(f"[config2] level-2 icosphere silhouette at {config2.IMAGE}^2, "
          f"K={config2.K}, GaussianRast sigma {config2.SIGMA} S={config2.S}: "
          f"scale fit 0.7 -> {fit['final_scale']:.4f} in "
          f"{config2.FIT_STEPS} steps ({fit['seconds']:.2f} s, loss "
          f"{fit['loss_first']:.4g} -> {fit['loss_last']:.4g}); gradient "
          f"variance at S = 4, 16, 64 over 24 seed words: synthetic field "
          f"{ratio(var['field'])}, the scene's dists {ratio(var['scene'])}; "
          f"gumbel weights |sum - 1| <= {wsum:.2g}; vs plain on shared "
          f"noise: {'; '.join(texts)}; bit-equal where no draw is made, "
          f"repeats bit-equal, K8b = the path's weights; launches {used}, "
          f"{k9b} | {smi}", flush=True)


def phase_config4(dev, smi, report):
    """BASELINE config 4 through experiments/config4.py's main: the cube x2
    in 16 views at 256^2, K=50 (flat route), GaussianRast + GaussianAgg
    S=4; 30 Adam steps on log_rot and the per-vertex offsets through
    render_loss (K2 at N=16, the offsets' gradient through K9b), from 20
    degrees off, twice (bit-equal); the dual path at step 0 (K2 against
    K3 + K4 with the L2 in autograd on the same seed words, 1e-3 of each
    gradient's max); both gradients finite and non-zero.  Then K2 against
    its plain version on step 0's inputs (``problem``: the 16 views at the
    start pose with step 0's seed words), tables within 1e-3 of their max
    (``tables_close``) and the loss within 1e-5."""
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        torch.cuda.synchronize()
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = config4.main(["--device", str(dev), "--out",
                                os.path.join(tmp, "config4.json")])
        torch.cuda.synchronize()
        counts = all_counts()
    steps = 2 * config4.STEPS
    k9b = k9b_per(report, "config4", steps, "step")
    dual = rec["dual_path_rel_err"]
    grads_ok = all(rec["grads_finite_nonzero"].values())
    if (rec["route"] != "flat" or max(dual.values()) > 1e-3 or not grads_ok
            or rec["dual_path_loss_rel_err"] > 1e-5
            or not rec["repeat_bit_equal"] or not rec["losses_finite"]):
        fail(f"config4: {json.dumps(rec)}")
    # K2: two runs of STEPS steps and the dual path's one call.
    if (counts["fused_loss_grad"] != steps + 1
            or counts["scatter_rows_cm"] < steps):
        fail(f"config4: launch counts {counts}")
    report["paths"]["config4"] = counts

    mesh, rend, _r, target, log_rot0, seeds0 = config4.problem(
        config4.VIEWS, config4.IMAGE, config4.K, dev)
    zero = torch.zeros(mesh.max_verts, 3, device=dev)
    cfg, ins = kernel_inputs(rend, config4.predict(mesh, log_rot0, zero),
                             seeds0)
    n = config4.VIEWS
    hw = config4.IMAGE * config4.IMAGE
    tgt = target.reshape(n, hw, 3).transpose(1, 2).contiguous()
    lscale = 1.0 / (n * hw * 3)
    loss, *got = fr.fused_loss_grad(cfg, *ins, tgt, "l2_rgb", lscale)
    want_loss, *want = fr.loss_grad_plain(cfg, *ins, tgt, "l2_rgb", lscale)
    torch.cuda.synchronize()
    ok, err, where = tables_close(got, want, 1e-3)
    lerr = ((loss - want_loss).abs() / want_loss.abs()).max().item()
    if cfg.stream or not ok or lerr > 1e-5:
        fail(f"config4 K2 vs plain at N={n}: worst table error {err} at "
             f"{where}, loss rel error {lerr}")
    pose = rec["pose_error_deg"]
    print(f"[config4] cube x2, {n} views at {config4.IMAGE}^2, "
          f"K={config4.K} (flat), GaussianRast + GaussianAgg S={config4.S}, "
          f"joint log_rot + deform ({rec['verts']} verts), {config4.STEPS} "
          f"Adam steps: {rec['step_ms']:.3f} ms a step (steps "
          f"2-{config4.STEPS}, host clock with a synchronisation), "
          f"{rec['view_renders_per_s']:.1f} view-renders/s; pose error "
          f"{pose['start']:.2f} -> {pose['end']:.2f} deg, loss "
          f"{rec['loss_first']:.5g} -> {rec['loss_last']:.5g}; dual path at "
          f"step 0 (K2 vs K3 + K4): log_rot {dual['log_rot']:.3g}, deform "
          f"{dual['deform']:.3g} of max, loss rel "
          f"{rec['dual_path_loss_rel_err']:.3g}; K2 vs plain at step 0: "
          f"worst table error {err:.3g} at {where}, loss rel {lerr:.3g}; "
          f"both gradients finite and non-zero; a second run bit-equal; "
          f"launches K2 {counts['fused_loss_grad']} (N={n}), {k9b} | {smi}",
          flush=True)


ORACLE_ARGS = ["--strips", "1", "--no-full-staged", "--device", "cuda"]


def phase_oracle_config5(dev, smi, report):
    """experiments/oracle_config5.py on one strip of 32 rows (H/4): the
    count pass and K_exact, the K ladder (K=150, K_exact untruncated), the
    stream and binned routes' forward against both rungs, the dual-path
    pose gradient (K7 / K12's loss-and-grad against forward + backward),
    the FD rows, the strip gradient against the K_exact staged oracle
    (K9a / K9b / K10a / K10b) and the binned capacity.  The stream route
    must match K_exact within 5e-5 and its strip gradient within 1e-4 of
    max; both routes' dual paths within 1e-4."""
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rec = oracle_config5.main(ORACLE_ARGS + [
                "--out", os.path.join(tmp, "oracle.json")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = all_counts()
    k9b_per(report, "oracle-config5", 1, "run")
    kx = str(rec["grad_oracle_k"])
    st, bn = rec["modes"]["stream"], rec["modes"]["binned"]
    st_fwd = max(st["forward_max_abs_err_by_oracle_k"][kx].values())
    bn_fwd = max(bn["forward_max_abs_err_by_oracle_k"][kx].values())
    finite = all(np.isfinite(v) for m in (st, bn) for v in (
        m["pose_grad_dual_path_rel_err"], m["pose_grad_strip_parity_rel_err"],
        m["step_ms"]))
    if not (finite and not rec["oracle_k_ladder"][-1]["saturated"]
            and st_fwd <= 5e-5
            and st["pose_grad_strip_parity_rel_err"] <= 1e-4
            and st["pose_grad_dual_path_rel_err"] <= 1e-4
            and bn["pose_grad_dual_path_rel_err"] <= 1e-4):
        fail(f"oracle-config5: {json.dumps(rec)}")
    need = ("fused_stream_forward", "fused_stream_backward",
            "fused_stream_loss_grad", "fused_binned_forward",
            "fused_binned_backward", "fused_binned_loss_grad",
            "gather_rows_cm", "scatter_rows_cm", "interp_rows",
            "interp_rows_backward")
    if any(counts[k] < 1 for k in need):
        fail(f"oracle-config5: launch counts {counts}")
    report["paths"]["oracle-config5"] = counts
    used = {k: v for k, v in counts.items() if v}
    cap = bn["capacity"]
    fd = lambda m: ", ".join(
        f"h={h}: cos {m['pose_grad_vs_fd_by_h'][h]['cosine']:.4f}"
        for h in ("0.003", "0.01"))
    print(f"[oracle-config5] config 5 (81,920 faces, 512^2, K=150, softras), "
          f"one strip of {rec['rows_per_strip']} rows at "
          f"{rec['strips'][0]}: count pass {rec['count_max']} candidates -> "
          f"K_exact {kx} (filled at most "
          f"{rec['oracle_k_ladder'][-1]['max_valid_slots']}); forward max "
          f"|d| vs K=150 / K_exact: stream "
          f"{max(st['forward_max_abs_err_by_oracle_k']['150'].values()):.3g}"
          f" / {st_fwd:.3g}, binned "
          f"{max(bn['forward_max_abs_err_by_oracle_k']['150'].values()):.3g}"
          f" / {bn_fwd:.3g}; pose gradient dual path stream "
          f"{st['pose_grad_dual_path_rel_err']:.3g}, binned "
          f"{bn['pose_grad_dual_path_rel_err']:.3g}; strip gradient vs the "
          f"K_exact oracle stream {st['pose_grad_strip_parity_rel_err']:.3g}"
          f", binned {bn['pose_grad_strip_parity_rel_err']:.3g}; FD stream "
          f"{fd(st)}, binned {fd(bn)}; binned capacity "
          f"{cap['max_tile_candidates']} candidates / {cap['slots']} slots, "
          f"range {cap['max_range']}; loss + grad step stream "
          f"{st['step_ms']:.1f} ms, binned {bn['step_ms']:.1f} ms; wall "
          f"{wall:.1f} s; launches {used} | {smi}", flush=True)


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


PHASES = (phase_k1, phase_k3, phase_k4, phase_k2, phase_serve,
          phase_render_grad, phase_train, phase_k5, phase_k6_k7,
          phase_stream_s128, phase_serve_stream, phase_render_grad_stream,
          phase_train_stream, phase_k9_k10, phase_target,
          phase_staged_softras, phase_k8, phase_staged_mc,
          phase_staged_uniform, phase_large, phase_k12,
          phase_capacity_binned, phase_serve_binned, phase_train_binned,
          phase_determinism, phase_k11, phase_sharded, phase_dryrun_sharded,
          phase_cli, phase_resume, phase_config3, phase_obj_io,
          phase_config2, phase_config4, phase_oracle_config5)


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

    report = {"paths": {}}
    seconds = {}
    for phase in PHASES:
        t0 = time.perf_counter()
        phase(dev, smi, report)
        seconds[phase.__name__[6:]] = round(time.perf_counter() - t0, 1)
    print(f"[phases] seconds: {json.dumps(seconds)}", flush=True)

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
            extra = {"modes": r["modes"], "ms_n1": r["ms_n1"],
                     "reference_ms": r["reference_ms"],
                     "certain": r["certain"]}
        if kname == "prng_probe":
            extra = {"device_ms": r["device_ms"],
                     "launch_floor_ms": r["launch_floor_ms"]}
        if kname in ("fused_loss_grad", "fused_stream_loss_grad"):
            extra = {"launches_by_path": {
                path: c[kname] for path, c in report["paths"].items()
                if c.get(kname)}}
        if kname == "fused_stream_forward":
            extra = {"draws_skipped": r["draws_skipped"]}
        if kname in ("sharded_prob", "sharded_det_bwd"):
            extra = {"ms_n1": r["ms_n1"]}
        if kname == "sharded_agg_bwd":
            extra = {"ms_n1": r["ms_n1"], "certain": r["certain"]}
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
