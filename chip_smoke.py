"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero before a result
is printed):

1. device — the card must be CUDA capability 9.0 (Hopper); builds the
   kernels from csrc/ with nvcc and reports the build time;
2. K1 — the hash-PRNG probe against tests/goldens/prng_goldens.npz
   (uniform bit-exact, gaussian 5e-4 abs, cauchy 1e-5 rel) and against its
   plain PyTorch version on the card;
3. K3 — the fused forward against its plain version on the card at the
   headline configuration: the cube x2, 256^2, K=50, S=8,
   GaussianRast + GaussianAgg (sigma 1e-3, gamma 1e-2), point light
   (0, 2, -2), camera dist 6.7 elev 30 azim 120, N=4 random poses.  MC
   tolerance: mean |d| <= 1e-5 and >= 99.9% of pixels within 1e-4; the
   deterministic softras pair at atol 2e-5.  Times both with CUDA events;
4. serve — 8 render requests of N=4 poses through MeshRenderer with a
   seeded torch.Generator; launch counts are reset just before and read
   just after; outputs must be finite with a plausible coverage share, and
   the first request must agree with the same request rendered on the CPU
   by the plain version.

The last two lines are the card's nvidia-smi name and power limit, then
one JSON object: {"ok": true, "device": {...}}.  The line before those is
the per-kernel report.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch import _build
from pertrenderer_tpu_torch.ops import fused_render as fr

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(HERE, "tests", "goldens", "prng_goldens.npz")
N_POSES, N_REQUESTS, IMAGE, K, S = 4, 8, 256, 50, 8
SIGMA, GAMMA = 1e-3, 1e-2


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


def timed_pair(kernel, plain, reps):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain, after one warm-up call each."""
    kernel(), plain()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def mc_close(got, want):
    """(ok, max |d|, mean |d|, share of pixels beyond 1e-4)."""
    d = (got - want).abs()
    flips = (d.amax(dim=-1) > 1e-4).float().mean().item()
    ok = (bool(torch.isfinite(got).all()) and d.mean().item() <= 1e-5
          and flips <= 1e-3)
    return ok, d.max().item(), d.mean().item(), flips


def headline_renderer(noise, device):
    """The headline scene's renderer (cameras, light, estimators)."""
    r, t = ptt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0,
                                      device=device)
    cams = ptt.PerspectiveCameras.create(
        R=r.expand(N_POSES, 3, 3), T=t.expand(N_POSES, 3), fov=60.0,
        device=device)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), device=device)
    if noise == "gaussian":
        sr = ptt.GaussianRast.create(sigma=SIGMA, nb_samples=S)
        sa = ptt.GaussianAgg.create(gamma=GAMMA, nb_samples=S)
    else:
        sr, sa = ptt.SoftRast.create(sigma=SIGMA), ptt.SoftAgg.create(
            gamma=GAMMA)
    settings = ptt.RasterizationSettings(
        image_size=IMAGE, blur_radius=float(np.log(1.0 / 1e-4 - 1.0) * SIGMA),
        faces_per_pixel=K)
    shader = ptt.RandomPhongShader.create(
        cameras=cams, lights=lights, smoothrast=sr, smoothagg=sa,
        blend_params=ptt.BlendParams(SIGMA, GAMMA, (0.0, 0.0, 0.0)),
        device=device)
    return ptt.MeshRenderer(ptt.MeshRasterizer(cams, settings), shader)


def posed_cube(generator, device):
    """The cube x2 at N_POSES random rotations drawn from ``generator``."""
    cube = ptt.load_cube(device=device).scale_verts(2.0).extend(N_POSES)
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

    # ---- K1 --------------------------------------------------------------
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
    k1_ms, k1_plain_ms = timed_pair(
        lambda: fr.prng_probe("gaussian", device=dev),
        lambda: fr.prng_probe_plain("gaussian", device=dev), 50)
    print(f"[K1] prng_probe: uniform bit-exact vs goldens, gaussian/cauchy "
          f"within 5e-4 abs / 1e-5 rel; max |kernel - plain| {k1_err:.3g}; "
          f"{k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms | {smi}",
          flush=True)

    # ---- K3 at the headline configuration -------------------------------
    k3 = {}
    for noise in ("gaussian", "softras"):
        renderer = headline_renderer(noise, dev)
        mesh = posed_cube(torch.Generator().manual_seed(0), dev)
        seeds = fr.draw_seeds(N_POSES, torch.Generator().manual_seed(1))
        cfg, ins = kernel_inputs(renderer, mesh, seeds)
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
        k_ms, p_ms = timed_pair(lambda: fr.fused_forward(cfg, *ins),
                                lambda: fr.forward_plain(cfg, *ins), 20)
        k3[noise] = dict(max_abs_err=dmax, ms=k_ms, plain_ms=p_ms)
        print(f"[K3] fused_forward {noise} 256^2 K=50 S=8 N=4 (f_pad "
              f"{cfg.f_pad}, c_zpad {cfg.c_zpad}): max |d| {dmax:.3g}, mean "
              f"|d| {dmean:.3g}, pixels beyond 1e-4 {flips:.3g}; "
              f"{k_ms:.4f} ms vs plain {p_ms:.4f} ms per render | {smi}",
              flush=True)

    # ---- serve: the main path ---------------------------------------------
    gen = torch.Generator().manual_seed(2026)
    warm = headline_renderer("gaussian", dev)
    warm(posed_cube(gen, dev), generator=gen)         # build + cache warm
    torch.cuda.synchronize()
    renderer = headline_renderer("gaussian", dev)
    first_state, first_image, lat_ms, alphas = None, None, [], []
    for k in fr.launch_counts:
        fr.launch_counts[k] = 0
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
    # The first request again on the CPU, through the plain version.
    cpu_renderer = headline_renderer("gaussian", "cpu")
    cpu_mesh = ptt.Meshes(
        verts=first_mesh.verts.cpu(), faces=first_mesh.faces.cpu(),
        num_verts=first_mesh.num_verts.cpu(),
        num_faces=first_mesh.num_faces.cpu(),
        textures=ptt.load_cube().textures.extend(N_POSES))
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
          f"{med:.3f} ms (after the first), {N_REQUESTS * N_POSES / total_s:.1f}"
          f" renders/s; vs CPU plain max |d| {dmax:.3g} | {smi}", flush=True)

    report = {"kernels": [
        {"name": "prng_probe", "route": "cuda",
         "source": "pertrenderer_tpu_torch/csrc/prng_probe.cu",
         "replaces": "pertrenderer_tpu/ops/fused_render.py:263",
         "launches": counts["prng_probe"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fused_forward", "route": "cuda",
         "source": "pertrenderer_tpu_torch/csrc/fused_forward.cu",
         "replaces": "pertrenderer_tpu/ops/fused_render.py:799",
         "launches": counts["fused_forward"],
         "max_abs_err": k3["gaussian"]["max_abs_err"],
         "ms": k3["gaussian"]["ms"], "plain_ms": k3["gaussian"]["plain_ms"]},
    ]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
