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
                             _renderer, assert_tables_close)

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

template <int MAXF, bool LOSS>
void run(Params& p, int n, float* rows) {
  const int F = p.f_pad, width = F * (kGeo + p.tex_d) + kNS + 1;
  std::vector<float> buf(table_floats(p));
  for (int b = 0; b < n; ++b) {
    float* s = buf.data();
    for (int i = 0; i < F * 9; ++i) {
      s[i] = p.fv_ndc[b * F * 9 + i];
      s[F * 9 + i] = p.fv_world[b * F * 9 + i];
      s[F * 18 + i] = p.fn[b * F * 9 + i];
    }
    for (int i = 0; i < F; ++i) s[F * 27 + i] = p.valid[b * F + i];
    for (int i = 0; i < kNS; ++i) s[F * 28 + i] = p.scal[b * kNS + i];
    for (int i = 0; i < F * p.tex_d; ++i)
      s[F * 28 + kNS + i] = p.tex[b * F * p.tex_d + i];
    const Tables T = tables_at(p, s);
    HostSink sink{rows + (size_t)b * width};
    PixelAcc acc;
    for (int k = 0; k < kNS; ++k) acc.gsc[k] = 0.0f;
    acc.g_gal = acc.g_invgam = acc.loss = 0.0f;
    for (int pix = 0; pix < p.image_size * p.image_size; ++pix)
      pixel_grads<MAXF, LOSS>(p, T, b, pix, true, sink, acc);
    finish_pixels(p, T, sink, acc);
  }
}

extern "C" void host_grads(
    int loss, const float* fv_ndc, const float* fv_world, const float* fn,
    const float* tex, const float* valid, const float* scal,
    const int* seeds, const float* extra, float* rows, int n,
    int image_size, int f_pad, int bg_row, int c_zpad, int tex_d,
    int atlas_r, int rast_kind, int rast_noise, int rast_vr, int s_rast,
    int agg_kind, int agg_noise, int agg_vr, int s_agg, int k, float eps_bg,
    int phong, int point_light, int clip, int persp, int loss_kind,
    float lscale) {
  Params p = {};
  p.fv_ndc = fv_ndc; p.fv_world = fv_world; p.fn = fn; p.tex = tex;
  p.valid = valid; p.scal = scal; p.seeds = seeds; p.extra = extra;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  p.loss_kind = loss_kind; p.lscale = lscale;
  if (f_pad <= 16) {
    if (loss) run<16, true>(p, n, rows); else run<16, false>(p, n, rows);
  } else {
    if (loss) run<64, true>(p, n, rows); else run<64, false>(p, n, rows);
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
                               + [ctypes.c_float])
    return lib


def host_grads(lib, cfg, tables, extra, loss_id=-1, lscale=0.0):
    """(loss (N,), g_ndc, g_world, g_fn, g_tex, g_scal) of the host build;
    ``loss_id`` -1 runs K4's pipeline (``extra`` = g_out), else K2's."""
    n, f = tables[0].shape[0], cfg.f_pad
    d = 27 + cfg.tex_d
    rows = torch.zeros(n, f * d + 34 + 1)
    lib.host_grads(int(loss_id >= 0), *(t.data_ptr() for t in tables[:7]),
                   extra.data_ptr(), rows.data_ptr(), n, *tfr._cfg_args(cfg),
                   max(loss_id, 0), ctypes.c_float(lscale))
    tabs = rows[:, :f * d].reshape(n, f, d)
    return (rows[:, -1] * lscale, tabs[..., :9], tabs[..., 9:18],
            tabs[..., 18:27], tabs[..., 27:], rows[:, f * d:f * d + 34])


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
