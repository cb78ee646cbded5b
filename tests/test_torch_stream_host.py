"""The stream kernels' per-pixel arithmetic, compiled for the CPU.

``csrc/stream_grad.cuh`` (the pipeline of K5, K6 and K7) keeps its CUDA
intrinsics inside ``#ifdef __CUDACC__``; with the CUDA keywords defined
away, g++ compiles ``chunk_forward``, ``stream_post``, ``chunk_grads`` and
``stream_finish``.  A host loop runs them tile by tile and pixel by pixel
over each tile's chunk list, and a host Sink adds each row's gradient
directly into the sorted table, so the result must equal the plain
versions (``stream_forward_plain``, ``stream_backward_plain``,
``stream_loss_grad_plain``) on the same inputs: the hand-derived adjoints
are checked without a card.  The sum order differs from the card's block
reduction, which only rounds differently.

Scenes: every menu pair on the cube with K=4 at 16^2 (one chunk, two
tiles), the gaussian pair on it with a 4 x 4 atlas (its cells take the
add_cell path), and the icosphere (20 chunks) with the hard pair at 48^2
(strip tiles, inactive tiles) and the affine pair at 32^2 (2-D tiles).
The libm of g++ and torch's vectorised CPU kernels round tan / log / sin /
cos differently in the last place, so the MC pairs can differ by a
threshold flip, which the MC tolerance covers.

Tolerances: forward as ``assert_image_close``; each gradient table and
each scalar gradient within 1e-4 (deterministic pairs) or 1e-3 (MC pairs)
of its own max |grad|; losses rtol 1e-5.  Skips where no g++ is
installed."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pertrenderer_tpu_torch import _build
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import (assert_image_close, build, interpret_env,
                           jax_inputs, MC_NOISES, one_torch_thread,
                           port_config, port_stream_inputs)
from test_torch_backward import assert_grads_close
from test_torch_kernel_host import STUB
from test_torch_stream_grads import split

HARNESS = r"""
#include "stream_grad.cuh"
using namespace ptf;

struct HostSink {
  float* out;
  int D;
  float* row;
  bool begin(bool cand, int r) { row = out + r * D; return cand; }
  void add(int d, float v) { row[d] += v; }
  void add_cell(int base, bool has, int cell, const float g[3]) {
    if (has) for (int c = 0; c < 3; ++c) row[base + cell * 3 + c] += g[c];
  }
  void end(int) {}
};

static void fill(Params& p, const float* tab, const int* rows,
                 const int* count, const int* active, const float* scal,
                 const int* seeds, const float* extra, int nt, int nch,
                 int p_tile, int tile_w, int rw, int dt, const int* cfg,
                 float eps_bg, int loss_kind, float lscale) {
  p.tab = tab; p.rows = rows; p.count = count; p.scal = scal;
  p.seeds = seeds; p.extra = extra;
  set_config(p, cfg[0], cfg[1], cfg[2], cfg[3], cfg[4], cfg[5], cfg[6],
             cfg[7], cfg[8], cfg[9], cfg[10], cfg[11], cfg[12], cfg[13],
             cfg[14], eps_bg, cfg[15], cfg[16], cfg[17], cfg[18]);
  set_tiling(p, active, nt, p_tile, tile_w);
  p.nch = nch; p.rw = rw; p.dt = dt;
  p.loss_kind = loss_kind; p.lscale = lscale;
}

// mode 0: forward into out (N, H, W, 4); 1: K6 (extra g_out); 2: K7.
extern "C" void host_stream(
    int mode, const float* tab, const int* rows, const int* count,
    const int* active, const float* scal, const int* seeds,
    const float* extra, float* out, float* g_tab, float* g_scal,
    float* loss, int n, int nt, int nch, int p_tile, int tile_w, int rw,
    int dt, const int* cfg, float eps_bg, int loss_kind, float lscale) {
  Params p = {};
  fill(p, tab, rows, count, active, scal, seeds, extra, nt, nch, p_tile,
       tile_w, rw, dt, cfg, eps_bg, loss_kind, lscale);
  const int D = kGeo + p.tex_d;
  std::vector<ChunkRows> Rv(1);
  std::vector<StreamState> Sv(1);
  ChunkRows& R = Rv[0];
  StreamState& st = Sv[0];
  for (int b = 0; b < n; ++b) {
    const float* sc = scal + b * kNS;
    PixelAcc acc;
    StreamAcc total;
    acc_clear(acc);
    acc_clear(total);
    for (int t = 0; t < nt; ++t) {
      const int bt = b * nt + t;
      const bool act = active[bt] > 0;
      const int* list = rows + (size_t)bt * nch;
      for (int i = 0; i < p_tile; ++i) {
        bool live;
        const int pix = tile_pixel(p, t, i, &live);
        float px, py;
        pixel_center(p.image_size, pix, &px, &py);
        const uint32_t pos = (uint32_t)pix;
        state_init(p, sc, b, pos, st);
        auto tables = [&](int cid) {
          return chunk_tables(p, tab + ((size_t)b * rw + (size_t)cid * kChunk) * dt, sc);
        };
        if (act)
          for (int q = 0; q < count[bt]; ++q) {
            if (mode == 1)
              chunk_forward<true, true>(p, tables(list[q]), b, list[q], px, py, live, pos, st, R);
            else if (mode == 2)
              chunk_forward<true, false>(p, tables(list[q]), b, list[q], px, py, live, pos, st, R);
            else
              chunk_forward<false, false>(p, tables(list[q]), b, list[q], px, py, live, pos, st, R);
          }
        if (mode == 0) {
          if (!live) continue;
          float rgb[3];
          state_rgb(p, st, rgb);
          float* o = out + ((size_t)b * p.image_size * p.image_size + pix) * 4;
          o[0] = rgb[0]; o[1] = rgb[1]; o[2] = rgb[2]; o[3] = 1.0f - st.alpha;
          continue;
        }
        if (mode == 1) stream_post<false>(p, sc, b, pix, live, act, st, acc);
        else stream_post<true>(p, sc, b, pix, live, act, st, acc);
        acc_fold(total, acc);
        if (!act) continue;
        for (int q = 0; q < count[bt]; ++q) {
          HostSink sink{g_tab + ((size_t)b * rw + (size_t)list[q] * kChunk) * D, D, nullptr};
          if (mode == 1)
            chunk_grads<true>(p, tables(list[q]), b, list[q], px, py, live, pos, st, R, sink, acc);
          else
            chunk_grads<false>(p, tables(list[q]), b, list[q], px, py, live, pos, st, R, sink, acc);
          acc_fold(total, acc);
        }
      }
    }
    // stream_finish is linear in the sums: apply once per batch element.
    stream_finish(p, sc, total);
    for (int k = 0; k < kNS; ++k) g_scal[b * kNS + k] = (float)total.gsc[k];
    loss[b] = (float)total.loss * lscale;
  }
}
"""


@pytest.fixture(autouse=True)
def _env(monkeypatch, one_torch_thread):
    interpret_env(monkeypatch)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' pipeline for the CPU")
    d = tmp_path_factory.mktemp("host_stream")
    (d / "stub.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libhost_stream.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-include", str(d / "stub.h"), "-I", _build.CSRC,
                    str(d / "harness.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_stream.argtypes = ([i32] + [ptr] * 11 + [i32] * 7
                                + [ptr, ctypes.c_float, i32,
                                   ctypes.c_float])
    return lib


def host_stream(lib, mode, cfg, tin, extra=None, loss_id=0, lscale=0.0):
    """(image, g_tab, g_scal, loss) of the host build: mode 0 the forward
    (K5), 1 the backward (K6, ``extra`` = g_out), 2 the loss-and-grad
    (K7, ``extra`` = target)."""
    tab, rows, count, active, scal, seeds = tin
    n, s, d = tab.shape[0], cfg.image_size, 27 + cfg.tex_d
    out = torch.zeros(n, s, s, 4)
    g_tab = torch.zeros(n, cfg.rw, tab.shape[2])
    g_rows = torch.zeros(n, cfg.rw, d)
    g_scal, loss = torch.zeros(n, 34), torch.zeros(n)
    args = tfr._cfg_args(cfg)
    ints = torch.tensor([int(a) for i, a in enumerate(args) if i != 15],
                        dtype=torch.int32)
    lib.host_stream(mode, tab.data_ptr(), rows.data_ptr(), count.data_ptr(),
                    active.data_ptr(), scal.data_ptr(), seeds.data_ptr(),
                    None if extra is None else extra.data_ptr(),
                    out.data_ptr(), g_rows.data_ptr(), g_scal.data_ptr(),
                    loss.data_ptr(), n, *tfr._stream_args(cfg, tab),
                    ints.data_ptr(), ctypes.c_float(cfg.eps_bg), loss_id,
                    ctypes.c_float(lscale))
    g_tab[..., :d] = g_rows
    return out, g_tab, g_scal, loss


CASES = ([(n, "cube", 16, "uv") for n in ("softras", "gaussian",
                                          "gaussian_wovr", "cauchy",
                                          "uniform", "hard")]
         + [("gaussian", "cube", 16, "atlas4"),
            ("hard", "icosphere", 48, "uv"),
            ("uniform", "icosphere", 32, "uv")])


@pytest.mark.parametrize("noise,kind,imsize,textures", CASES)
def test_stream_pipeline_matches_plain_on_host(noise, kind, imsize, textures,
                                               host_lib):
    cube = kind == "cube"
    mesh, _cams, _lights, renderer = build(
        noise, imsize=imsize, k=4 if cube else 50, s=2, mesh_kind=kind,
        textures=textures, sigma=1e-2 if cube else 1e-3,
        gamma=5e-1 if cube else 1e-2)
    jcfg, jin = jax_inputs(mesh, renderer)
    cfg = port_config(jcfg)
    tin = port_stream_inputs(jcfg, jin)
    mc = noise in MC_NOISES
    n = tin[0].shape[0]
    img = host_stream(host_lib, 0, cfg, tin)[0]
    assert_image_close(img.numpy(),
                       tfr.stream_forward_plain(cfg, *tin).numpy(), mc)

    g_out = torch.randn(n, imsize, imsize, 4,
                        generator=torch.Generator().manual_seed(1))
    got = host_stream(host_lib, 1, cfg, tin, g_out)
    want = tfr.stream_backward_plain(cfg, *tin, g_out)
    assert_grads_close(split(cfg, *got[1:3]), split(cfg, *want), mc)

    target = torch.rand(n, 3, imsize * imsize,
                        generator=torch.Generator().manual_seed(2))
    lscale = 1.0 / (n * imsize * imsize * 3)
    for loss_id, loss_kind in enumerate(tfr.LOSS_KINDS):
        got = host_stream(host_lib, 2, cfg, tin, target, loss_id, lscale)
        w_loss, *want = tfr.stream_loss_grad_plain(cfg, *tin, target,
                                                   loss_kind, lscale)
        np.testing.assert_allclose(got[3].numpy(), w_loss.numpy(),
                                   rtol=1e-5)
        assert_grads_close(split(cfg, *got[1:3]), split(cfg, *want), mc)
