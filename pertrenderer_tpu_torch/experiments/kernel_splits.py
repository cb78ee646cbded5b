"""Where K1's, K9b's, K12's, K8a-c's, K7's, K5's, K2's, K3's, K11b's, K10b's and
K11a's time goes on the card (a tuning tool).

    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k1
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k9b
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k12
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k8c
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k8b
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k8a
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k7
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k5
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k2
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k3
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k11b
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k10b
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k11a
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits sass

``k1``: K1 (``prng_probe``, (4, 16, 256) gaussian, chip_smoke.py's
[K1]) and a kernel that does nothing (``empty_launch``, the launch
floor) in one torch.profiler session, their device times per launch; the
last line is a JSON object of the two (chip_smoke.py's [K1] reads it).

``k9b``: the row scatter at the cow's staged shapes (chip_smoke.py's
[K9b]: 13.1 M columns into 20,480 rows, D = 9), the index preparation
(``segments``) and the whole call timed apart with CUDA events, the sum
being their difference.  It only calls ``gather.segments`` and
``gather.scatter_rows_cm``, so it also times an older checkout of the
package: run it from that checkout's root with ``--root``.

``k12``: K12 on config 5 as chip_smoke.py's [K12] runs it (forward N=4,
backward and loss-and-grad N=1, gaussian and softras), then the
loss-and-grad at the pose step's sigma 6e-3 / gamma 6e-2, each call
timed with CUDA events.  With ``--profile`` the kernels are built a
second time with ``-DPT_PROFILE`` (csrc/binned_warp.cuh: lane 0's
clock64 per phase, summed over the warps' pixels) and each line gives
the call's time in that build and each phase's share of the clocks.

``k11b`` also times K11a (``fused_prob``) at the same shapes.

``k8c``: K8c (``argmax_grads``) and K8b (``argmax_mean``) at the cow's staged shapes (chip_smoke.py's [K8c]: a (4,
65536, 51) z_map, S = 8, gaussian), timed with CUDA events; with
``--profile``, in a build with ``-DPT_PROFILE`` whose K8c marks its
phases (csrc/perturbed.cu), the share of lane 0's clocks in the draws
against the rest (maxima, sums, loads and stores).

``k8b``: K8b (``argmax_mean``) at the cow's staged shapes (chip_smoke.py's
[K8b]), gaussian, cauchy and uniform, timed with CUDA events, with the
candidates per pixel where the package has ``argmax_candidates``.
``k8a``: K8a's mean and coefficient (``heaviside_mean`` /
``heaviside_coeff``) at [K8a]'s shapes, gaussian and cauchy, with the band's
share where the package has ``heaviside_band``.

``k7``: K7 at N=1 (the pose step's shape), K6 and K5 at N=4 on the cow
at 256^2 (chip_smoke.py's [K5] / [K6] / [K7]), timed with CUDA events; with
``--profile``, the share of K7's clocks (lane 0 of each warp, summed
over the warps, barrier waits included) in B1 (the replay), the post
step (both in the first kernel) and B2 (the adjoints and the slices'
sums, the second).

``k5``: K5 (``fused_stream_forward``) on the cow at 256^2, N=4 (chip_smoke.py's
[K5]), gaussian and softras at S = 8, and gaussian at S = 64 beside
S = 128, timed with CUDA events; with ``--profile``, in a build with
``-DPT_PROFILE`` whose K5 marks its phases (csrc/stream_warp.cuh's
``warp_forward_chunk``), the share of lane 0's clocks in geometry (det1
and shading), coverage draws (and z_map), aggregation draws and the rest
(alpha, softmax, winner scans).  With ``--save PATH`` it saves the images,
so two checkouts' runs can be compared bit for bit.

``k2``: K2 (``fused_loss_grad``) and K4 (``fused_backward``) on the cube
at 256^2 (chip_smoke.py's [K2] / [K4] scene), gaussian, at N=1 (the pose
step's shape) and N=4: each call timed with CUDA events, and its device
time split by kernel (torch.profiler: the memset, the pixel kernel, the
reduction), both by chip_smoke.py's ``grad_split_text``; their ptxas
lines with the resident blocks per SM those registers and that shared
memory allow.  With ``--profile`` (a build with ``-DPT_PROFILE``,
csrc/fused_grad.cuh) the share of lane 0's clocks in the forward (det1,
coverage, z_map, aggregation, blend), the adjoints and the sink.

``k3``: K3 (``fused_forward``) on the cube at 256^2 (chip_smoke.py's [K3]
scene, gaussian, S = 8), in both modes: drawn coverage and external
coverage (K3e: the sharded route's renderer, S_local 4, shard 1's seed
words, the plain group coverage, as [K3e]), each at N=4 and N=1, timed
with CUDA events (the call) and by torch.profiler (the kernel's device
time), with the counting launch's certain pixels and draws
where the package has ``fused_forward_counts``.  With ``--profile`` (a
build with ``-DPT_PROFILE``, csrc/flat_warp.cuh) the share of lane 0's
clocks in det1, the certainty tests and lists, the coverage draws, the
aggregation draws and the blend; with ``--save PATH`` the images and
weights, so two checkouts' runs can be compared bit for bit.

``k11b``: K11b (``fused_agg_bwd``) at [K11b]'s shapes, N=4 and N=1, each
call timed with CUDA events and its device time split by kernel
(torch.profiler: the pixel kernel, the gamma term's reduction), with the
counting launch's certain pixels where the package has
``agg_bwd_counts``.  With ``--profile`` (csrc/fused_grad.cuh's
``pixel_agg_grads``, csrc/sharded.cu) the share of lane 0's clocks in
det1 (geometry, z_map, the certainty test), the shading and replay, the
g_zmap stores and the warp sum.  ``--save`` as ``k3``.

``k10b``: K10b (``interp_rows_backward``) at the cow's staged shapes
(chip_smoke.py's [K10b]: a (6, 13.1 M) cotangent into 20,480 rows), each
call timed with CUDA events and its device time split by kernel
(torch.profiler: the parent's index preparation, segment sum and weight
gradient, or the tile pass, scan, fill and merge), with the
partial rows against the filled columns where the package has
``tile_partials``.

``k11a``: K11a (``fused_prob``) at [K11a]'s shapes (the sharded cube at
256^2, shard 1's seed words), gaussian and cauchy coverage, N=4 and N=1,
timed with CUDA events and by torch.profiler, with the counting launch's
geometry pairs, certain pixels and draws where the package has
``prob_counts``.  With ``--profile`` (csrc/flat_warp.cuh's
``warp_flat_prob``) the share of lane 0's clocks in det1, the certainty
tests and list, and the coverage draws.

``sass``: each kernel of the checkout's library (``--root``), its
machine code read back by ``cuobjdump -sass``: the instruction count and
a digest of the instructions, the anonymous namespaces' hashes and the
encodings left out, so two checkouts' kernels can be told the same or
not without a timing (run it on each and compare the lines).

``k9b``, ``k12``, ``k8a``, ``k8b``, ``k8c``, ``k7``, ``k5``, ``k2``,
``k3``, ``k11b``, ``k10b`` and ``k11a`` only call the
package's entry points and the checkout's chip_smoke.py, so they also
time an older checkout of it: run this file by its path from that
checkout's root with ``--root .`` (without ``--profile`` where that
checkout has no phase marks; ``k2`` needs a chip_smoke.py with
``grad_split_text`` and ``grad_call``).  Each prints the card's name and power
limit.  They need a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

PHASES = ("live rows", "shading", "coverage", "z_map", "aggregation",
          "blend", "aggregation (gradients)", "blend, loss, replay",
          "adjoints")


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1(root: str) -> None:
    sys.path.insert(0, root)
    import json

    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import fused_render as fr

    dev = torch.device("cuda", 0)
    smi = _smi()
    split = cs.device_split(lambda: (fr.prng_probe("gaussian", device=dev),
                                     fr.empty_launch(dev)), 50)
    ms = {key: sum(t for name, t in split.items() if key in name)
          for key in ("prng_probe", "empty_kernel")}
    print(f"[K1 split] {os.path.abspath(root)}: device time per launch: "
          f"prng_probe (4, 16, 256) gaussian {ms['prng_probe']:.5f} ms, "
          f"an empty kernel {ms['empty_kernel']:.5f} ms | {smi}", flush=True)
    print(json.dumps({"prng_probe_ms": ms["prng_probe"],
                      "launch_floor_ms": ms["empty_kernel"]}), flush=True)


def k9b(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import gather as gk

    dev = torch.device("cuda", 0)
    fv9, _merged, idx, _ws = cs.staged_kernel_inputs(dev)
    rows, p = fv9.shape[0], idx.shape[0]
    g9 = torch.randn(9, p, generator=torch.Generator().manual_seed(4)).to(
        dev)
    total = _cuda_ms(lambda: gk.scatter_rows_cm(g9, idx, rows), 10)
    prep = _cuda_ms(lambda: gk.segments(idx, rows), 10)
    total2 = _cuda_ms(lambda: gk.scatter_rows_cm(g9, idx, rows), 10)
    ms = (total + total2) / 2
    print(f"[K9b split] {os.path.abspath(root)}: P={p}, {rows} rows, "
          f"{int((idx >= 0).sum())} filled: scatter_rows_cm {ms:.4f} ms, "
          f"segments (preparation) {prep:.4f} ms, the rest (sum) "
          f"{ms - prep:.4f} ms | {_smi()}", flush=True)


def k12(root: str, profile: bool) -> None:
    lib, read = _profiled(root, profile, "pt_binned_profile")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import binned

    dev = torch.device("cuda", 0)
    buf = (ctypes.c_ulonglong * 16)()
    smi = _smi()

    def run(tag, fn):
        fn()
        torch.cuda.synchronize()
        if read is None:
            ms = (_cuda_ms(fn, 3) + _cuda_ms(fn, 3)) / 2
            print(f"[K12 split] {os.path.abspath(root)}: {tag}: {ms:.3f} "
                  f"ms | {smi}", flush=True)
            return
        lib.pt_binned_profile(ctypes.addressof(buf))      # reset
        ms = _cuda_ms(fn, 1)
        lib.pt_binned_profile(ctypes.addressof(buf))
        clocks = [buf[i] for i in range(len(PHASES))]
        # _cuda_ms ran fn twice (a warm-up and the timed call).
        total = sum(clocks) or 1
        print(f"[K12 phases] {tag}: {ms:.3f} ms (profiling build); " + ", ".join(
            f"{name} {100.0 * c / total:.1f}%"
            for name, c in zip(PHASES, clocks) if c) + f" | {smi}",
              flush=True)

    for noise in ("gaussian", "softras"):
        cfg, ins, _r = cs.binned_inputs(noise, dev, cs.N_POSES)
        run(f"forward {noise} N={cs.N_POSES}",
            lambda: binned.fused_binned_forward(cfg, *ins))
        cfg, ins, _r = cs.binned_inputs(noise, dev, 1, seed=3)
        hw = cfg.image_size ** 2
        g_out = torch.randn(1, cfg.image_size, cfg.image_size, 4,
                            generator=torch.Generator().manual_seed(2)).to(
                                dev)
        target = torch.rand(1, 3, hw, generator=torch.Generator()
                            .manual_seed(3)).to(dev)
        run(f"backward {noise} N=1",
            lambda: binned.fused_binned_backward(cfg, *ins, g_out))
        run(f"loss-and-grad {noise} N=1",
            lambda: binned.fused_binned_loss_grad(cfg, *ins, target,
                                                  "l2_rgb", 1.0 / (3 * hw)))
    cams, lights = cs.config5.scene(dev, 1)
    rend = cs.config5.renderer(cams, lights, "gaussian", cs.C5_TRAIN_SIGMA,
                               cs.C5_TRAIN_GAMMA, s=cs.S, device=dev)
    mesh = cs.config5.icosphere_mesh(cs.config5.LEVEL, "asymmetric", dev)
    seeds = cs.fr.draw_seeds(1, torch.Generator().manual_seed(1), device=dev)
    cfg, ins = cs.kernel_inputs(rend, mesh, seeds)
    hw = cfg.image_size ** 2
    target = torch.rand(1, 3, hw, generator=torch.Generator().manual_seed(
        3)).to(dev)
    w = cs.binned_work(cfg, ins)
    run(f"loss-and-grad gaussian N=1 at sigma {cs.C5_TRAIN_SIGMA}, gamma "
        f"{cs.C5_TRAIN_GAMMA} ({w['cand'] / w['pixels']:.1f} candidates "
        f"per pixel)",
        lambda: binned.fused_binned_loss_grad(cfg, *ins, target, "l2_rgb",
                                              1.0 / (3 * hw)))


def _profiled(root: str, profile: bool, entry: str):
    """(the kernel library of ``root``'s package, built with
    -DPT_PROFILE when ``profile``, and its phase reader or None)."""
    sys.path.insert(0, root)
    from pertrenderer_tpu_torch import _build

    if profile:
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DPT_PROFILE",)
    lib = _build.library()
    if not profile:
        return lib, None
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()

    def read(names):
        fn(ctypes.addressof(buf))
        read.raw = list(buf)
        clocks = [buf[i] for i in range(len(names))]
        total = sum(clocks) or 1
        return ", ".join(f"{n} {100.0 * c / total:.1f}%"
                         for n, c in zip(names, clocks))

    read(())                                       # reset
    return lib, read


def k8c(root: str, profile: bool) -> None:
    lib, read = _profiled(root, profile, "pt_k8c_profile")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    dev = torch.device("cuda", 0)
    _d, z, g, _sigma, gamma, _rs, ags = cs.staged_estimator_inputs(dev)
    grads = lambda: pk.argmax_grads(z, g, gamma, ags, cs.S, "gaussian")
    mean = lambda: pk.argmax_mean(z, gamma, ags, cs.S, "gaussian")
    g_ms, m_ms = _cuda_ms(grads, 10), _cuda_ms(mean, 10)
    g_ms = (g_ms + _cuda_ms(grads, 10)) / 2
    text = ""
    if read is not None:
        read(())
        grads()
        torch.cuda.synchronize()
        text = "; K8c's clocks: " + read(("draws", "the rest"))
    print(f"[K8c split] {os.path.abspath(root)}: z {tuple(z.shape)} S="
          f"{cs.S}: argmax_grads (K8c) {g_ms:.4f} ms, argmax_mean (K8b) "
          f"{m_ms:.4f} ms{' (profiling build)' if read else ''}"
          f"{text} | {_smi()}", flush=True)


def k8b(root: str) -> None:
    _profiled(root, False, "")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    dev = torch.device("cuda", 0)
    _d, z, _g, _sigma, gamma, _rs, ags = cs.staged_estimator_inputs(dev)
    for noise in ("gaussian", "cauchy", "uniform"):
        call = lambda: pk.argmax_mean(z, gamma, ags, cs.S, noise)
        ms = (_cuda_ms(call, 10) + _cuda_ms(call, 10)) / 2
        text = ""
        if hasattr(pk, "argmax_candidates"):
            per = pk.argmax_candidates(z, gamma, noise).sum(-1).float()
            text = (f" ({per.mean().item():.3f} candidates per pixel, one "
                    f"on {(per == 1).float().mean().item():.4f} of pixels)")
        print(f"[K8b split] {os.path.abspath(root)}: argmax_mean {noise} z "
              f"{tuple(z.shape)} S={cs.S}: {ms:.4f} ms{text} | {_smi()}",
              flush=True)


def k8a(root: str) -> None:
    _profiled(root, False, "")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    dev = torch.device("cuda", 0)
    d, _z, _g, sigma, _gamma, rs, _ags = cs.staged_estimator_inputs(dev)

    def timed(noise):
        mean = lambda: pk.heaviside_mean(d, sigma, rs, cs.S, noise)
        coeff = lambda: pk.heaviside_coeff(d, sigma, rs, cs.S, noise)
        return ((_cuda_ms(mean, 10) + _cuda_ms(mean, 10)) / 2,
                (_cuda_ms(coeff, 10) + _cuda_ms(coeff, 10)) / 2)

    for noise in ("gaussian", "cauchy"):
        m_ms, c_ms = timed(noise)
        text = ""
        if hasattr(pk, "heaviside_band"):
            text = (f" (band share "
                    f"{pk.heaviside_band(d, sigma, noise).float().mean().item():.4f})")
        print(f"[K8a split] {os.path.abspath(root)}: {noise} d "
              f"{tuple(d.shape)} S={cs.S}: heaviside_mean {m_ms:.4f} ms, "
              f"heaviside_coeff {c_ms:.4f} ms{text} | {_smi()}", flush=True)


def k7(root: str, profile: bool) -> None:
    lib, read = _profiled(root, profile, "pt_stream_profile")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import fused_render as fr

    dev = torch.device("cuda", 0)
    tag = " (profiling build)" if read else ""
    for kname, n in (("fused_stream_loss_grad", 1),
                     ("fused_stream_backward", cs.N_POSES)):
        cfg, args = cs.stream_inputs("gaussian", dev, n)
        call = cs.stream_grad_calls(cfg, args, cs.IMAGE)[kname][0]
        ms = _cuda_ms(call, 5)
        text = ""
        if read is not None and kname == "fused_stream_loss_grad":
            read(())
            call()
            torch.cuda.synchronize()
            text = "; clocks: " + read(("B1", "post", "B2"))
        print(f"[K7 split] {os.path.abspath(root)}: {kname} cow "
              f"{cs.IMAGE}^2 N={n}: {ms:.4f} ms{tag}{text} | {_smi()}",
              flush=True)
    cfg, args = cs.stream_inputs("gaussian", dev, cs.N_POSES)
    ms = _cuda_ms(lambda: fr.fused_stream_forward(cfg, *args), 10)
    print(f"[K7 split] {os.path.abspath(root)}: fused_stream_forward (K5) "
          f"cow {cs.IMAGE}^2 N={cs.N_POSES}: {ms:.4f} ms{tag} | {_smi()}",
          flush=True)


def _blocks_per_sm(regs, threads):
    """Resident blocks per SM on an H100 that ``regs`` registers a thread
    (allocated 256 a warp at a time) and ``threads`` a block allow."""
    warps = (threads + 31) // 32
    per_warp = -(-regs * 32 // 256) * 256
    return max(0, min(65536 // (per_warp * warps), 32, 64 // warps))


def k5(root: str, profile: bool, save: str = "") -> None:
    lib, read = _profiled(root, profile, "pt_stream_forward_profile")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import fused_render as fr

    dev = torch.device("cuda", 0)
    tag = " (profiling build)" if read else ""
    smi = _smi()
    lines = cs.ptxas_report(("stream_forward",)).get("stream_forward",
                                                      ["?"])
    print(f"[K5 split] {os.path.abspath(root)}: ptxas "
          f"{' | '.join(sorted(set(lines)))}", flush=True)
    cases = [("gaussian", cs.S), ("softras", cs.S), ("gaussian", 64),
             ("gaussian", 128)]
    times, images = {}, {}
    for noise, s in cases:
        cfg, args = cs.stream_inputs(noise, dev, cs.N_POSES, cs.IMAGE, s)
        call = lambda: fr.fused_stream_forward(cfg, *args)
        images[f"{noise}_S{s}"] = call().cpu()
        if hasattr(fr, "stream_forward_counts"):
            c = fr.stream_forward_counts(cfg, *args)[1]
            print(f"[K5 split] {os.path.abspath(root)}: {noise} S={s}: "
                  f"coverage pairs drawn {c['cover_drawn']} of "
                  f"{c['cover_need']}, aggregation pairs drawn "
                  f"{c['agg_drawn']} of {c['agg_need']}, distinct winners "
                  f"shaded {c['winners']}", flush=True)
        ms = (_cuda_ms(call, 5) + _cuda_ms(call, 5)) / 2
        times[(noise, s)] = ms
        text = ""
        if read is not None:
            read(())
            call()
            torch.cuda.synchronize()
            text = "; clocks: " + read(("geometry", "coverage draws",
                                        "aggregation draws", "the rest"))
        print(f"[K5 split] {os.path.abspath(root)}: fused_stream_forward "
              f"{noise} S={s} cow {cs.IMAGE}^2 N={cs.N_POSES}: {ms:.4f} ms"
              f"{tag}{text} | {smi}", flush=True)
    print(f"[K5 split] {os.path.abspath(root)}: S=128 / S=64 "
          f"{times[('gaussian', 128)] / times[('gaussian', 64)]:.3f}x | "
          f"{smi}", flush=True)
    if save:
        torch.save(images, save)


def k2(root: str, profile: bool) -> None:
    lib, read = _profiled(root, profile, "pt_grads_profile")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import fused_render as fr

    dev = torch.device("cuda", 0)
    tag = " (profiling build)" if read else ""
    smi = _smi()
    renderer = cs.headline_renderer("gaussian", dev)
    mesh = cs.posed_cube(torch.Generator().manual_seed(0), dev)
    seeds = fr.draw_seeds(cs.N_POSES, torch.Generator().manual_seed(1),
                          device=dev)
    cfg, ins4 = cs.kernel_inputs(renderer, mesh, seeds)
    bucket = next(b for b in (16, 32, 64, 128, 256) if cfg.f_pad <= b)
    keys = {f"fused_grad_kernelILi{bucket}ELb{int(loss)}ELb0E": name
            for loss, name in ((True, "K2"), (False, "K4"))}
    keys["grad_reduce"] = "the reduction"
    for key, lines in sorted(cs.ptxas_report(tuple(keys)).items()):
        for line in sorted(set(lines)):
            blocks = ("" if key == "grad_reduce" else
                      f"; {_blocks_per_sm(int(line.split()[0]), 128)} "
                      f"blocks of 128 threads per SM by registers")
            print(f"[K2 split] {os.path.abspath(root)}: ptxas {keys[key]}: "
                  f"{line}{blocks}", flush=True)
    for kname in ("fused_loss_grad", "fused_backward"):
        print(f"[K2 split] {os.path.abspath(root)}: {kname} cube "
              f"{cfg.image_size}^2 gaussian (f_pad {cfg.f_pad}){tag}: "
              f"{cs.grad_split_text(kname, cfg, ins4, dev)} | {smi}",
              flush=True)
    if read is None:
        return
    for n in (1, cs.N_POSES):
        call = cs.grad_call("fused_loss_grad", cfg,
                            tuple(t[:n].contiguous() for t in ins4), dev)
        call()
        read(())
        call()
        torch.cuda.synchronize()
        print(f"[K2 split] {os.path.abspath(root)}: fused_loss_grad N={n} "
              f"clocks: " + read((
                  "det1", "coverage", "aggregation forward and blend",
                  "loss and aggregation backward", "slot adjoints and sink",
                  "dead warps' exit")) + f" | {smi}", flush=True)


def _k3_cases(cs, fr, torch, dev):
    """{(mode, N): (call, its result's tensors)} of K3 at [K3]'s and
    [K3e]'s shapes."""
    cfg, ins = cs.headline_inputs("gaussian", dev)
    rend = cs.sharded_renderer(dev)
    mesh = cs.posed_cube(torch.Generator().manual_seed(0), dev)
    base = fr.draw_seeds(cs.N_POSES, torch.Generator().manual_seed(1),
                         device=dev)
    ecfg, eins = cs.kernel_inputs(rend, mesh, base)
    eins = (*eins[:6], fr.shard_seeds(ecfg, eins[6], cs.SHARD), eins[7])
    prob = fr.prob_plain(ecfg, eins[0], eins[4], eins[5], eins[6], eins[7])
    one = lambda ts: tuple(t[:1].contiguous() for t in ts)
    out = {}
    for n in (cs.N_POSES, 1):
        a = ins if n > 1 else one(ins)
        e = (eins, prob) if n > 1 else (one(eins), prob[:1].contiguous())
        out[("drawn", n)] = (cfg, a, None)
        out[("ext", n)] = (ecfg, e[0], e[1])
    return out


def k3(root: str, profile: bool, save: str = "") -> None:
    lib, read = _profiled(root, profile, "pt_fused_forward_profile")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import fused_render as fr

    dev = torch.device("cuda", 0)
    tag = " (profiling build)" if read else ""
    smi = _smi()
    lines = cs.ptxas_report(("fused_forward_kernel",)).get(
        "fused_forward_kernel", ["?"])
    print(f"[K3 split] {os.path.abspath(root)}: ptxas fused_forward_kernel: "
          f"{' | '.join(sorted(set(lines)))}", flush=True)
    saved = {}
    for (mode, n), (cfg, ins, prob) in _k3_cases(cs, fr, torch,
                                                 dev).items():
        kw = {} if prob is None else {"prob": prob}
        call = lambda: fr.fused_forward(cfg, *ins, **kw)
        res = call()
        saved[f"{mode}_N{n}"] = [t.cpu() for t in (
            res if isinstance(res, tuple) else (res,))]
        ms = (_cuda_ms(call, 10) + _cuda_ms(call, 10)) / 2
        text = "; device: " + cs.kernel_split_text(cs.device_split(call, 10))
        if hasattr(fr, "fused_forward_counts"):
            c = fr.fused_forward_counts(cfg, *ins, **kw)[1]
            text += (f"; certain pixels {c['certain']} of {c['pixels']}, "
                    f"coverage units drawn {c['cover_drawn']} of "
                    f"{c['cover_full']}, aggregation units drawn "
                    f"{c['agg_drawn']} of {c['agg_full']}")
        if read is not None:
            read(())
            call()
            torch.cuda.synchronize()
            text += "; clocks: " + read((
                "det1", "certainty tests and lists", "coverage draws",
                "aggregation draws", "blend"))
            r = read.raw
            if r[10]:
                text += (f"; warps {r[10]}, with an active pixel {r[11]}: "
                         f"clocks per warp {r[8] / r[10]:.0f} on average, "
                         f"{r[12] / max(r[11], 1):.0f} per active warp, "
                         f"{r[9]} at most")
        print(f"[K3 split] {os.path.abspath(root)}: fused_forward {mode} "
              f"coverage cube {cs.IMAGE}^2 N={n}: {ms:.4f} ms{tag}{text} | "
              f"{smi}", flush=True)
    if save:
        torch.save(saved, save)


def k11b(root: str, profile: bool, save: str = "") -> None:
    lib, read = _profiled(root, profile, "pt_sharded_profile")
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import fused_render as fr

    dev = torch.device("cuda", 0)
    tag = " (profiling build)" if read else ""
    smi = _smi()
    saved = {}
    g_out4 = torch.randn(cs.N_POSES, cs.IMAGE, cs.IMAGE, 4,
                         generator=torch.Generator().manual_seed(2)).to(dev)
    for (mode, n), (cfg, ins, prob) in _k3_cases(cs, fr, torch,
                                                 dev).items():
        if mode != "ext":
            continue
        g_out = g_out4[:n].contiguous()
        call = lambda: fr.fused_agg_bwd(cfg, *ins, prob, g_out)
        saved[f"N{n}"] = [t.cpu() for t in call()]
        again = call()
        same = all(torch.equal(a.cpu(), b) for a, b in zip(again,
                                                          saved[f"N{n}"]))
        ms = (_cuda_ms(call, 10) + _cuda_ms(call, 10)) / 2
        split = cs.kernel_split_text(cs.device_split(call, 10))
        text = ""
        if hasattr(fr, "agg_bwd_counts"):
            c = fr.agg_bwd_counts(cfg, *ins, prob, g_out)[1]
            text = (f"; certain pixels {c['certain']} of {c['pixels']}, "
                    f"replay units drawn {c['drawn']} of {c['full']}")
        if read is not None:
            read(())
            call()
            torch.cuda.synchronize()
            text += "; clocks: " + read((
                "det1 and the certainty test", "shading and replay",
                "g_zmap stores", "warp sum"))
        print(f"[K11b split] {os.path.abspath(root)}: fused_agg_bwd cube "
              f"{cs.IMAGE}^2 N={n}: {ms:.4f} ms{tag}, repeat bit-equal "
              f"{same}; device: {split}{text} | {smi}", flush=True)
        cover = (ins[0], ins[4], ins[5], ins[6], ins[7])
        call = lambda: fr.fused_prob(cfg, *cover)
        ms = (_cuda_ms(call, 10) + _cuda_ms(call, 10)) / 2
        split = cs.kernel_split_text(cs.device_split(call, 10))
        print(f"[K11a split] {os.path.abspath(root)}: fused_prob cube "
              f"{cs.IMAGE}^2 N={n}: {ms:.4f} ms{tag}; device: {split} | "
              f"{smi}", flush=True)
    if save:
        torch.save(saved, save)


def k10b(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import interp_gather as ik

    dev = torch.device("cuda", 0)
    smi = _smi()
    _fv9, merged, idx, ws = cs.staged_kernel_inputs(dev)
    rows, p = merged.shape[0], idx.shape[0]
    g6 = torch.randn(6, p, generator=torch.Generator().manual_seed(4)).to(
        dev)
    filled = int((idx >= 0).sum())
    call = lambda: ik.interp_rows_backward(merged, idx, *ws, g6)
    ms = (_cuda_ms(call, 10) + _cuda_ms(call, 10)) / 2
    split = cs.kernel_split_text(cs.device_split(call, 10))
    text = ""
    if hasattr(ik, "tile_partials"):
        parts = ik.tile_partials(idx, rows)[0].numel()
        text = (f", tiles of {ik.BWD_TILE} columns: {parts} partial rows "
                f"({parts / filled:.4f} of the filled columns)")
    print(f"[K10b split] {os.path.abspath(root)}: interp_rows_backward cow "
          f"staged (6, {p}), {rows} rows, {filled} filled{text}: {ms:.4f} "
          f"ms; device: {split} | {smi}", flush=True)


def k11a(root: str, profile: bool) -> None:
    lib, read = _profiled(root, profile, "pt_sharded_profile")
    import dataclasses

    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import fused_render as fr

    dev = torch.device("cuda", 0)
    tag = " (profiling build)" if read else ""
    smi = _smi()
    for (mode, n), (cfg, ins, _prob) in _k3_cases(cs, fr, torch,
                                                  dev).items():
        if mode != "ext":
            continue
        cover = (ins[0], ins[4], ins[5], ins[6], ins[7])
        for noise in ("gaussian", "cauchy"):
            ncfg = dataclasses.replace(cfg, rast_noise=noise)
            call = lambda: fr.fused_prob(ncfg, *cover)
            ms = (_cuda_ms(call, 20) + _cuda_ms(call, 20)) / 2
            split = cs.kernel_split_text(cs.device_split(call, 20))
            text = ""
            if hasattr(fr, "prob_counts"):
                c = fr.prob_counts(ncfg, *cover)[1]
                text = (f"; geometry at {c['near']} (face, pixel) pairs, "
                        f"certain pixels {c['certain']} of {c['pixels']}, "
                        f"coverage units drawn {c['cover_drawn']} of "
                        f"{c['cover_full']}")
            if read is not None:
                read(())
                call()
                torch.cuda.synchronize()
                text += "; clocks: " + read((
                    "det1", "certainty tests and list", "coverage draws"))
            print(f"[K11a split] {os.path.abspath(root)}: fused_prob cube "
                  f"{cs.IMAGE}^2 {noise} N={n}: {ms:.4f} ms{tag}; device: "
                  f"{split}{text} | {smi}", flush=True)


def sass(root: str) -> None:
    import hashlib
    import re

    lib, _read = _profiled(root, False, "")
    from pertrenderer_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                         text=True, check=True).stdout
    anon = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = anon.sub("", m.group(1))
            kernels[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            text = re.sub(r"/\*.*?\*/", "", line).strip()
            kernels[name].append(anon.sub("", text))
    for name in sorted(kernels):
        body = "\n".join(kernels[name])
        print(f"[sass] {os.path.abspath(root)}: {name} "
              f"{len(kernels[name])} instructions, "
              f"{hashlib.sha1(body.encode()).hexdigest()[:16]}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("k1", "k9b", "k12", "k8c", "k8b", "k8a",
                                     "k7", "k5", "k2", "k3", "k11b", "k10b",
                                     "k11a", "sass"))
    ap.add_argument("--root", default=os.getcwd(),
                    help="checkout whose package and chip_smoke.py to use "
                         "(k1, k9b, k12, k8a, k8b, k8c, k7, k5, k2, k3, "
                         "k11b, k10b, k11a, sass)")
    ap.add_argument("--save", default="",
                    help="k5, k3, k11b: save the results (a dict of CPU "
                         "tensors) to this path, to compare two checkouts' "
                         "bits")
    ap.add_argument("--profile", action="store_true",
                    help="k12, k8c, k7, k5, k2, k3, k11b, k11a: build with "
                         "-DPT_PROFILE and print the phases' shares of the "
                         "clocks")
    args = ap.parse_args(argv)
    if args.what == "k1":
        k1(args.root)
    elif args.what == "k9b":
        k9b(args.root)
    elif args.what == "k8c":
        k8c(args.root, args.profile)
    elif args.what == "k8b":
        k8b(args.root)
    elif args.what == "k8a":
        k8a(args.root)
    elif args.what == "k7":
        k7(args.root, args.profile)
    elif args.what == "k5":
        k5(args.root, args.profile, args.save)
    elif args.what == "k2":
        k2(args.root, args.profile)
    elif args.what == "k3":
        k3(args.root, args.profile, args.save)
    elif args.what == "k11b":
        k11b(args.root, args.profile, args.save)
    elif args.what == "k10b":
        k10b(args.root)
    elif args.what == "k11a":
        k11a(args.root, args.profile)
    elif args.what == "sass":
        sass(args.root)
    else:
        k12(args.root, args.profile)


if __name__ == "__main__":
    main()
