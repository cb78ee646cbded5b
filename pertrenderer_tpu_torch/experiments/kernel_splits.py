"""Where K9b's, K12's, K8c's and K7's time goes on the card (a tuning
tool).

    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k9b
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k12
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k8c
    python3 -m pertrenderer_tpu_torch.experiments.kernel_splits k7

``k9b``: the row scatter at the cow's staged shapes (chip_smoke.py's
[K9b]: 13.1 M columns into 20,480 rows, D = 9), the index preparation
(``segments``) and the whole call timed apart with CUDA events, the sum
being their difference.  It only calls ``gather.segments`` and
``gather.scatter_rows_cm``, so it also times an older checkout of the
package: run it from that checkout's root with ``--root``.

``k12``: K12's phase clocks.  The kernels are built a second time with
``-DPT_PROFILE`` (csrc/binned_warp.cuh: lane 0's clock64 per phase,
summed over the warps' pixels) and run on config 5 as chip_smoke.py's
[K12] does (forward N=4, backward and loss-and-grad N=1, gaussian and
softras), then the loss-and-grad at the pose step's sigma 6e-3 / gamma
6e-2; each line gives the call's time (CUDA events, profiling build) and
each phase's share of the clocks.

``k8c``: K8c (``argmax_grads``) and K8b (``argmax_mean``, 2 S C draws
per pixel) at the cow's staged shapes (chip_smoke.py's [K8c]: a (4,
65536, 51) z_map, S = 8, gaussian), timed with CUDA events; with
``--profile``, in a build with ``-DPT_PROFILE`` whose K8c marks its
phases (csrc/perturbed.cu), the share of lane 0's clocks in the draws
against the rest (maxima, sums, loads and stores).

``k7``: K7 at N=1 (the pose step's shape) and K6 at N=4 on the cow at
256^2 (chip_smoke.py's [K6] / [K7]), timed with CUDA events; with
``--profile``, the share of K7's clocks (lane 0 of each warp, summed
over the warps, barrier waits included) in B1 (the replay), the post
step (both in the first kernel) and B2 (the adjoints and the slices'
sums, the second).

``k9b``, ``k8c`` and ``k7`` only call the package's entry points, so they
also time an older checkout of it: run this file by its path from that
checkout's root with ``--root .`` (without ``--profile`` where that
checkout has no phase marks).  Each prints the card's name and power
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


def k12() -> None:
    from pertrenderer_tpu_torch import _build

    _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DPT_PROFILE",)
    import torch

    import chip_smoke as cs
    from pertrenderer_tpu_torch.ops import binned

    dev = torch.device("cuda", 0)
    lib = _build.library()
    lib.pt_binned_profile.argtypes = [ctypes.c_void_p]
    lib.pt_binned_profile.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    smi = _smi()

    def run(tag, fn):
        fn()
        torch.cuda.synchronize()
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
          f"{cs.S}: argmax_grads (K8c) {g_ms:.4f} ms, argmax_mean (K8b, "
          f"2 S C draws) {m_ms:.4f} ms{' (profiling build)' if read else ''}"
          f"{text} | {_smi()}", flush=True)


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("k9b", "k12", "k8c", "k7"))
    ap.add_argument("--root", default=os.getcwd(),
                    help="checkout whose package and chip_smoke.py to use "
                         "(k9b, k8c, k7)")
    ap.add_argument("--profile", action="store_true",
                    help="k8c, k7: build with -DPT_PROFILE and print the "
                         "phases' shares of the clocks")
    args = ap.parse_args(argv)
    if args.what == "k9b":
        k9b(args.root)
    elif args.what == "k8c":
        k8c(args.root, args.profile)
    elif args.what == "k7":
        k7(args.root, args.profile)
    else:
        sys.path.insert(0, os.getcwd())
        k12()


if __name__ == "__main__":
    main()
