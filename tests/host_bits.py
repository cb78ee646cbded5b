"""Compare two checkouts' kernel pipelines bit for bit on the CPU.

    python3 tests/host_bits.py OTHER_ROOT [--work DIR]

Builds the host harnesses of tests/test_torch_kernel_host.py (K3's
pixel_forward, K4 / K2's pixel_grads, the sharded K11a-c, K12's warp
pipeline) and tests/test_torch_stream_host.py (K5-K7) with g++, each
checkout's harnesses against its own csrc (OTHER_ROOT: another checkout's
root, say the parent commit's unpacked by ``git archive``), runs both on
the same small scenes (the cube at 24^2 and F = 40, the sharded cube at
16^2 and 48^2 with variance reduction on and off, the binned icosphere at
64^2, the stream cube at 16^2 with S = 2 and 128) and prints for each
output whether the two are equal bit for bit (the sign of zero
included), then the count.  Run it after editing a shared header
(fused_common.cuh, fused_grad.cuh, warp.cuh, stream_warp.cuh).
"""
import argparse
import ctypes
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)

import pytest  # noqa: E402
import torch  # noqa: E402

import test_torch_kernel_host  # noqa: E402
import test_torch_stream_host  # noqa: E402
from pertrenderer_tpu_torch.ops import fused_render as tfr  # noqa: E402
from test_torch_cuda import (_inputs, _many_faces, _renderer,  # noqa: E402
                             sharded_case)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("other", help="the other checkout's root")
ap.add_argument("--work", default="", help="build directory (a temporary "
                "one by default)")
cli = ap.parse_args()
CHECKOUTS = {"parent": os.path.abspath(cli.other), "tree": ROOT}
WORK = cli.work or tempfile.mkdtemp(prefix="host_bits")
ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
torch.set_num_threads(4)


def harnesses(root, name):
    """(kernel host module, stream host module) of the checkout at root:
    its harness sources and their callers."""
    if root == ROOT:
        return test_torch_kernel_host, test_torch_stream_host
    out = []
    for mod in ("test_torch_kernel_host", "test_torch_stream_host"):
        spec = importlib.util.spec_from_file_location(
            f"{name}_{mod}", os.path.join(root, "tests", f"{mod}.py"))
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        out.append(m)
    return tuple(out)


def build(name, src, which, stub):
    d = pathlib.Path(WORK) / f"{which}_{name}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "stub.h").write_text(stub)
    (d / "h.cpp").write_text(src)
    csrc = os.path.join(CHECKOUTS[which], "pertrenderer_tpu_torch", "csrc")
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-include", str(d / "stub.h"), "-I", csrc,
                    str(d / "h.cpp"), "-o", str(d / "l.so")], check=True)
    return ctypes.CDLL(str(d / "l.so"))


libs = {}
for which in CHECKOUTS:
    kh, sh = harnesses(CHECKOUTS[which], which)
    h = build("h", kh.HARNESS, which, kh.STUB)
    h.host_grads.argtypes = ([i32] + [ptr] * 9 + [i32] * 16 + [f32]
                             + [i32] * 5 + [f32, i32, ptr, i32, i32])
    h.host_sharded.argtypes = ([i32] + [ptr] * 13 + [i32] * 16 + [f32]
                               + [i32] * 4 + [ptr, i32, i32, i32])
    w = build("w", kh.WARP_HARNESS, which, kh.STUB)
    w.host_warp.argtypes = ([i32] + [ptr] * 10 + [i32] * 16 + [f32]
                            + [i32] * 5 + [f32, ptr, i32, i32])
    s = build("s", sh.HARNESS, which, kh.STUB)
    s.host_stream.argtypes = ([i32] + [ptr] * 11 + [i32] * 7
                              + [ptr, f32, i32, f32, ptr])
    libs[which] = dict(h=h, w=w, s=s, kh=kh, sh=sh)


def same(a, b):
    if isinstance(a, (tuple, list)):
        return all(same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) and torch.equal(torch.signbit(a),
                                             torch.signbit(b))


results = []


def check(tag, fn):
    ok = same(fn(libs["parent"]), fn(libs["tree"]))
    print(f"{tag}: {'bit-equal' if ok else 'DIFFERS'}", flush=True)
    results.append(ok)


for noise in ("gaussian", "gaussian_wovr", "cauchy", "softras", "hard",
              "uniform"):
    for many in (False, True):
        mesh, rend = _renderer(noise, "cpu", imsize=24)
        cfg, tables = _inputs(*(_many_faces(mesh, rend) if many
                                else (mesh, rend)))
        g_out = torch.randn(2, 24, 24, 4,
                            generator=torch.Generator().manual_seed(1))
        target = torch.rand(2, 3, 24 * 24,
                            generator=torch.Generator().manual_seed(2))
        t = f"{noise}{' F=40' if many else ''}"
        check(f"K3 pixel_forward {t}",
              lambda L: L["kh"].host_forward(L["h"], cfg, tables))
        check(f"K4 {t}",
              lambda L: L["kh"].host_grads(L["h"], cfg, tables, g_out))
        check(f"K2 {t}", lambda L: L["kh"].host_grads(
            L["h"], cfg, tables, target, 0, 1e-3))
for imsize, shift in ((16, None), (48, (0.0, 2.5, 0.0))):
    cfg, tables = sharded_case("cpu", imsize, shift)
    prob = tfr.prob_plain(cfg, tables[0], tables[4], tables[5], tables[6],
                          tables[7])
    want_w = tfr.forward_plain(cfg, *tables, prob)[1]
    g_out = torch.randn(2, imsize, imsize, 4,
                        generator=torch.Generator().manual_seed(1))
    want_gz = tfr.agg_bwd_plain(cfg, *tables, prob, g_out)[0]
    for vr in (True, False):
        c2 = dataclasses.replace(cfg, agg_vr=vr)
        tag = f"{imsize}^2 vr={vr}"
        run = lambda L, *a, **k: L["kh"].host_sharded(L["h"], c2, tables,
                                                      *a, **k)
        check(f"K11a {tag}", lambda L: run(L, 0))
        check(f"K3e pixel_forward {tag}", lambda L: run(L, 1, prob=prob))
        check(f"K11b {tag}", lambda L: run(L, 2, prob=prob, g_out=g_out))
        check(f"K11c {tag}", lambda L: run(L, 3, prob=prob, weights=want_w,
                                           g_zmap=want_gz, g_out=g_out))
mp = pytest.MonkeyPatch()
mp.setattr(tfr, "_COARSE_THRESHOLD", 512)
mp.setattr(tfr, "_BIN_P_TILE", 32)
for noise in ("gaussian", "softras", "cauchy", "hard"):
    mesh, rend = _renderer(noise, "cpu", imsize=64, mesh_kind="icosphere",
                           sigma=1e-2, gamma=5e-2, s=2)
    rend.rasterizer.raster_settings = dataclasses.replace(
        rend.rasterizer.raster_settings, bin_overflow="allow",
        max_faces_per_bin=32)
    cfg, tables = _inputs(mesh, rend)
    g_out = torch.randn(2, 64, 64, 4,
                        generator=torch.Generator().manual_seed(1))
    target = torch.rand(2, 3, 64 * 64,
                        generator=torch.Generator().manual_seed(2))
    warp = lambda L, *a: L["kh"].host_warp(L["w"], cfg, tables, *a)
    check(f"K12 forward {noise}", lambda L: warp(L, -1))
    check(f"K12 backward {noise}", lambda L: warp(L, 0, g_out))
    check(f"K12 loss-and-grad {noise}",
          lambda L: warp(L, 1, target, 0, 1e-4))
mp.undo()
for noise, s in (("gaussian", 2), ("gaussian", 128), ("cauchy", 2),
                 ("softras", 2), ("hard", 2)):
    mesh, rend = _renderer(noise, "cpu", imsize=16, k=4, s=s)
    cfg, (tab, scal, rows, count, active, seeds) = _inputs(mesh, rend)
    tin = (tab, rows, count, active, scal, seeds)
    g_out = torch.randn(2, 16, 16, 4,
                        generator=torch.Generator().manual_seed(1))
    target = torch.rand(2, 3, 256, generator=torch.Generator().manual_seed(2))
    stream = lambda L, *a: L["sh"].host_stream(L["s"], *a)
    check(f"K5 {noise} S={s}", lambda L: stream(L, 0, cfg, tin)[0])
    check(f"K6 {noise} S={s}", lambda L: stream(L, 1, cfg, tin, g_out)[1:])
    check(f"K7 {noise} S={s}",
          lambda L: stream(L, 2, cfg, tin, target, 0, 1e-3)[1:])
print(f"{sum(results)} of {len(results)} comparisons bit-equal")
sys.exit(0 if all(results) else 1)
