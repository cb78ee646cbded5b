"""The gradient kernels' per-pixel arithmetic, compiled for the CPU.

``csrc/fused_grad.cuh`` (the pipeline of K4 and K2) keeps its CUDA
intrinsics inside ``#ifdef __CUDACC__``; with the CUDA keywords defined
away, g++ compiles ``pixel_grads`` and ``finish_pixels``.  A host Sink adds
each pixel's slot gradients directly, so the summed result must equal the
plain versions (``backward_plain``, ``loss_grad_plain``: torch autograd
through the plain forward) on the same inputs — the hand-derived adjoints
are checked without a card.  The sum order differs from the card's warp
reduction, which only rounds differently.

Tolerances: each gradient table within 1e-4 (deterministic pairs) or
1e-3 (MC pairs, same noise) of its max |grad|; losses rtol 1e-5.  Skips
where no g++ is installed."""

import ctypes
import shutil
import subprocess

import pytest
import torch

from pertrenderer_tpu_torch import _build
from pertrenderer_tpu_torch.ops import fused_render as tfr

from test_torch_cuda import (MC_NOISES, NOISE_MENU, _inputs, _many_faces,
                             _renderer, assert_kernel_close,
                             assert_tables_close)

STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>
using std::isinf; using std::isnan; using std::max; using std::min;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
"""

HARNESS = r"""
#include "fused_grad.cuh"
using namespace ptf;

struct HostSink {
  float* part;
  bool any(bool x) { return x; }
  float* row(int off) { return part + off; }
  void add(float* row, int d, float v) { row[d] += v; }
  void add_cell(float* row, bool has, int cell, const float g[3]) {
    if (has) for (int c = 0; c < 3; ++c) row[cell * 3 + c] += g[c];
  }
};

// Table block bt (a batch element's tables, or a binned tile's) and batch
// element b's scalars, laid out as the kernels' shared memory.
Tables fill(const Params& p, std::vector<float>& buf, size_t bt, int b) {
  const int F = p.f_pad;
  float* s = buf.data();
  for (int i = 0; i < F * 9; ++i) {
    s[i] = p.fv_ndc[bt * F * 9 + i];
    s[F * 9 + i] = p.fv_world[bt * F * 9 + i];
    s[F * 18 + i] = p.fn[bt * F * 9 + i];
  }
  for (int i = 0; i < F; ++i) s[F * 27 + i] = p.valid[bt * F + i];
  for (int i = 0; i < kNS; ++i) s[F * 28 + i] = p.scal[b * kNS + i];
  for (int i = 0; i < F * p.tex_d; ++i)
    s[F * 28 + kNS + i] = p.tex[bt * F * p.tex_d + i];
  return tables_at(p, s);
}

// The pixels of block bt: every pixel (flat) or tile t's (binned).
int block_pixels(const Params& p, bool binned) {
  return binned ? p.p_tile : p.image_size * p.image_size;
}

// K4 / K2 (flat: one row per element, float accumulators) or K12's
// gradients (binned: one row per (element, tile), double accumulators and
// aggregation, as on the card).
template <int MAXF, bool LOSS, class Acc>
void run_acc(Params& p, int n, bool binned, float* rows) {
  const int F = p.f_pad, width = F * (kGeo + p.tex_d) + kNS + 1;
  const int tiles = binned ? p.nt : 1;
  std::vector<float> buf(table_floats(p));
  for (int b = 0; b < n; ++b)
    for (int t = 0; t < tiles; ++t) {
      const size_t bt = (size_t)b * tiles + t;
      const Tables T = fill(p, buf, bt, b);
      HostSink sink{rows + bt * width};
      Acc acc;
      for (int k = 0; k < kNS; ++k) acc.gsc[k] = 0.0f;
      acc.g_gal = acc.g_invgam = acc.loss = 0.0f;
      for (int i = 0; i < block_pixels(p, binned); ++i)
        pixel_grads<MAXF, LOSS>(p, T, b, binned ? t * p.p_tile + i : i,
                                true, sink, acc);
      finish_pixels(p, T, sink, acc);
    }
}

template <int MAXF, bool LOSS>
void run(Params& p, int n, bool binned, float* rows) {
  if (binned) run_acc<MAXF, LOSS, PixelAccT<double>>(p, n, binned, rows);
  else run_acc<MAXF, LOSS, PixelAcc>(p, n, binned, rows);
}

// K3 (flat) or K12's forward (binned, aggregating in double): RGBA
// (n, H * W, 4).
template <int MAXF>
void forward(Params& p, int n, bool binned, float* out) {
  const int tiles = binned ? p.nt : 1, npix = p.image_size * p.image_size;
  std::vector<float> buf(table_floats(p));
  for (int b = 0; b < n; ++b)
    for (int t = 0; t < tiles; ++t) {
      const Tables T = fill(p, buf, (size_t)b * tiles + t, b);
      for (int i = 0; i < block_pixels(p, binned); ++i) {
        const int pix = binned ? t * p.p_tile + i : i;
        float* o = out + ((size_t)b * npix + pix) * 4;
        if (binned) pixel_forward<MAXF, double>(p, T, b, pix, o);
        else pixel_forward<MAXF>(p, T, b, pix, o);
      }
    }
}

// loss: -1 runs the forward into rows (n, H * W, 4), 0 K4's gradients,
// 1 K2's; binned: the tables are per-tile (n, nt, F, .), with the tiles'
// activity bits.
extern "C" void host_grads(
    int loss, const float* fv_ndc, const float* fv_world, const float* fn,
    const float* tex, const float* valid, const float* scal,
    const int* seeds, const float* extra, float* rows, int n,
    int image_size, int f_pad, int bg_row, int c_zpad, int tex_d,
    int atlas_r, int rast_kind, int rast_noise, int rast_vr, int s_rast,
    int agg_kind, int agg_noise, int agg_vr, int s_agg, int k, float eps_bg,
    int phong, int point_light, int clip, int persp, int loss_kind,
    float lscale, int binned, const int* active, int nt, int p_tile) {
  Params p = {};
  p.fv_ndc = fv_ndc; p.fv_world = fv_world; p.fn = fn; p.tex = tex;
  p.valid = valid; p.scal = scal; p.seeds = seeds; p.extra = extra;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  p.loss_kind = loss_kind; p.lscale = lscale;
  set_tiling(p, active, nt, p_tile, 0);
  const bool bn = binned != 0;
  if (f_pad <= 16) {
    if (loss < 0) forward<16>(p, n, bn, rows);
    else if (loss) run<16, true>(p, n, bn, rows);
    else run<16, false>(p, n, bn, rows);
  } else {
    if (loss < 0) forward<64>(p, n, bn, rows);
    else if (loss) run<64, true>(p, n, bn, rows);
    else run<64, false>(p, n, bn, rows);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' pipeline for the CPU")
    d = tmp_path_factory.mktemp("host_grads")
    (d / "stub.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libhost_grads.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-include", str(d / "stub.h"), "-I", _build.CSRC,
                    str(d / "harness.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_grads.argtypes = ([i32] + [ptr] * 9 + [i32] * 16
                               + [ctypes.c_float] + [i32] * 5
                               + [ctypes.c_float, i32, ptr, i32, i32])
    return lib


def _host_call(lib, cfg, tables, extra, mode, rows, loss_id=0, lscale=0.0):
    """Run the host build: ``mode`` -1 the forward, 0 K4's pipeline, 1
    K2's; binned configurations take the tables per tile and the tiles'
    activity bits (``tables[7]``)."""
    n = tables[0].shape[0]
    active = tables[7] if cfg.binned else torch.zeros(1, dtype=torch.int32)
    lib.host_grads(mode, *(t.data_ptr() for t in tables[:7]),
                   extra.data_ptr(), rows.data_ptr(), n, *tfr._cfg_args(cfg),
                   loss_id, ctypes.c_float(lscale), int(cfg.binned),
                   active.data_ptr() if cfg.binned else None,
                   tfr._n_tiles(cfg), cfg.p_tile)
    return rows


def host_forward(lib, cfg, tables):
    """(N, H, W, 4) RGBA of the host build of the forward pipeline."""
    n, s = tables[0].shape[0], cfg.image_size
    rows = _host_call(lib, cfg, tables, torch.zeros(1), -1,
                      torch.zeros(n, s * s, 4))
    return rows.reshape(n, s, s, 4)


def host_grads(lib, cfg, tables, extra, loss_id=-1, lscale=0.0):
    """(loss (N,), g_ndc, g_world, g_fn, g_tex, g_scal) of the host build;
    ``loss_id`` -1 runs K4's pipeline (``extra`` = g_out), else K2's.
    Binned: the tables per tile, the tiles' scalar rows summed."""
    n, f = tables[0].shape[0], cfg.f_pad
    d = 27 + cfg.tex_d
    blocks = tfr._n_tiles(cfg) if cfg.binned else 1
    rows = _host_call(lib, cfg, tables, extra, int(loss_id >= 0),
                      torch.zeros(n, blocks, f * d + 34 + 1),
                      max(loss_id, 0), lscale)
    tabs = rows[..., :f * d].reshape(n, blocks, f, d)
    if not cfg.binned:
        tabs = tabs[:, 0]
    scal = rows[..., f * d:].double().sum(dim=1).float()
    return (scal[:, -1] * lscale, tabs[..., :9], tabs[..., 9:18],
            tabs[..., 18:27], tabs[..., 27:], scal[:, :34])


CASES = [(n, {}) for n in NOISE_MENU] + [
    ("gaussian", dict(textures="vertex", lights_kind="directional")),
    ("cauchy", dict(textures="atlas4", perspective_correct=True)),
    ("gaussian", dict(many_faces=True)),
]


@pytest.mark.parametrize("noise,kw", CASES)
def test_kernel_pipeline_matches_plain_on_host(noise, kw, host_lib):
    scene = _renderer(noise, "cpu", imsize=16, **{
        k: v for k, v in kw.items() if k != "many_faces"})
    cfg, tables = _inputs(*(_many_faces(*scene) if kw.get("many_faces")
                            else scene))
    assert cfg.f_pad == (40 if kw.get("many_faces") else 16)
    mc = noise in MC_NOISES
    g_out = torch.randn(2, 16, 16, 4, generator=torch.Generator()
                        .manual_seed(1))
    got = host_grads(host_lib, cfg, tables, g_out)
    assert_tables_close(got[1:], tfr.backward_plain(cfg, *tables, g_out), mc)

    target = torch.rand(2, 3, 256, generator=torch.Generator().manual_seed(2))
    lscale = 1.0 / (2 * 256 * 3)
    for loss_id, kind in enumerate(tfr.LOSS_KINDS):
        got = host_grads(host_lib, cfg, tables, target, loss_id, lscale)
        want = tfr.loss_grad_plain(cfg, *tables, target, kind, lscale)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
        assert_tables_close(got[1:], want[1:], mc)


@pytest.mark.parametrize("noise,kw", CASES)
def test_forward_pipeline_matches_plain_on_host(noise, kw, host_lib):
    """K3's per-pixel pipeline (``pixel_forward``, which K12's forward
    shares) against ``forward_plain``: atol 2e-5, or the MC pairs' image
    tolerance (shared noise)."""
    scene = _renderer(noise, "cpu", imsize=16, **{
        k: v for k, v in kw.items() if k != "many_faces"})
    cfg, tables = _inputs(*(_many_faces(*scene) if kw.get("many_faces")
                            else scene))
    assert_kernel_close(host_forward(host_lib, cfg, tables),
                        tfr.forward_plain(cfg, *tables), noise in MC_NOISES)


@pytest.fixture
def one_thread():
    """One intra-op torch thread: the binned plain versions are many small
    ops, which slow down by orders of magnitude when every test worker
    runs a full thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("noise", ["gaussian", "softras", "cauchy"])
def test_binned_pipeline_matches_plain_on_host(noise, host_lib, monkeypatch,
                                               one_thread):
    """The pipelines of K12 on per-tile tables (the icosphere at 64^2,
    tiles of 32 pixels, M = 32) against ``binned_forward_plain`` /
    ``binned_backward_plain`` / ``binned_loss_grad_plain``: images as
    above, gradients by ``checks.binned_grads_close`` against the float32
    or float64 plain version (thin faces' rows by L / h), losses rtol
    1e-5."""
    import dataclasses

    from pertrenderer_tpu_torch import checks
    from pertrenderer_tpu_torch.ops import binned as tbin

    monkeypatch.setattr(tfr, "_COARSE_THRESHOLD", 512)
    monkeypatch.setattr(tfr, "_BIN_P_TILE", 32)
    mesh, rend = _renderer(noise, "cpu", imsize=64, mesh_kind="icosphere",
                           sigma=1e-2, gamma=5e-2, s=2)
    rend.rasterizer.raster_settings = dataclasses.replace(
        rend.rasterizer.raster_settings, bin_overflow="allow",
        max_faces_per_bin=32)
    cfg, tables = _inputs(mesh, rend)
    assert cfg.binned and cfg.f_pad == 32 and int(tables[7].sum()) > 0
    mc = noise in MC_NOISES
    tol = 1e-3 if mc else 1e-4
    assert_kernel_close(host_forward(host_lib, cfg, tables),
                        tbin.binned_forward_plain(cfg, *tables), mc)
    tables64 = [t.double() if t.is_floating_point() else t for t in tables]
    g_out = torch.randn(2, 64, 64, 4, generator=torch.Generator()
                        .manual_seed(1))
    got = host_grads(host_lib, cfg, tables, g_out)
    want = tbin.binned_backward_plain(cfg, *tables, g_out)
    want64 = tbin.binned_backward_plain(cfg, *tables64, g_out.double())
    ok, err, where, _thin, _rep = checks.binned_grads_close(
        cfg, tables[:4], got[1:], want, want64, tol)
    assert ok, (err, where)
    target = torch.rand(2, 3, 64 * 64, generator=torch.Generator()
                        .manual_seed(2))
    lscale = 1.0 / (2 * 64 * 64 * 3)
    got = host_grads(host_lib, cfg, tables, target, 0, lscale)
    w_loss, *want = tbin.binned_loss_grad_plain(cfg, *tables, target,
                                                "l2_rgb", lscale)
    _l64, *want64 = tbin.binned_loss_grad_plain(cfg, *tables64,
                                                target.double(), "l2_rgb",
                                                lscale)
    torch.testing.assert_close(got[0], w_loss, rtol=1e-5, atol=0)
    ok, err, where, _thin, _rep = checks.binned_grads_close(
        cfg, tables[:4], got[1:], want, want64, tol)
    assert ok, (err, where)
