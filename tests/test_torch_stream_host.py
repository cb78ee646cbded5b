"""The stream kernels' per-pixel arithmetic, compiled for the CPU.

``csrc/stream_grad.cuh`` (K5's per-thread forward and the rows shared
with the gradients) and ``csrc/stream_warp.cuh`` (K6 / K7's warp
pipeline) keep their CUDA intrinsics inside ``#ifdef __CUDACC__``; with
the CUDA keywords defined away, g++ compiles them.  A host loop runs K5's
``chunk_forward`` tile by tile and pixel by pixel; K6 / K7 run as the
card runs them, with the 32 lanes of each warp emulated as fibers
(``FIBERS``): per block of 32 pixels of a tile, four warps each taking
every fourth pixel, B1 (``warp_chunk_forward``) over the tile's chunk
list, the post step, then B2 (``warp_chunk_grads``) adding each warp's
rows into its slice and the slices in warp order into the sorted table,
the tiles and their blocks in ascending order.  The results must equal
the plain versions (``stream_forward_plain``, ``stream_backward_plain``,
``stream_loss_grad_plain``) on the same inputs: the hand-derived adjoints
are checked without a card.  The sum order differs from the plain
versions', which only rounds differently.

Scenes: every menu pair on the cube with K=4 at 16^2 (one chunk, two
tiles), the gaussian pair on it with a 4 x 4 atlas (its cells take the
slices' cell columns), and the icosphere (20 chunks) with the hard pair at 48^2
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
from test_torch_kernel_host import FIBERS, STUB
from test_torch_stream_grads import split

HARNESS = FIBERS + r"""
#include "stream_warp.cuh"
using namespace ptf;

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
  p.nch = nch; p.rw = rw; p.dt = dt; p.nsub = p_tile / kBlockPix;
  p.loss_kind = loss_kind; p.lscale = lscale;
}

// K5's per-thread forward, pixel by pixel, into out (N, H, W, 4) (MULTI:
// the kernel's instantiation above kMaxS samples).
template <bool MULTI>
static void forward(const Params& p, int n, float* out) {
  std::vector<ChunkRows> Rv(1);
  std::vector<StreamState> Sv(1);
  ChunkRows& R = Rv[0];
  StreamState& st = Sv[0];
  for (int b = 0; b < n; ++b)
    for (int t = 0; t < p.nt; ++t) {
      const int bt = b * p.nt + t;
      const int* list = p.rows + (size_t)bt * p.nch;
      const float* sc = p.scal + b * kNS;
      for (int i = 0; i < p.p_tile; ++i) {
        bool live;
        const int pix = tile_pixel(p, t, i, &live);
        float px, py;
        pixel_center(p.image_size, pix, &px, &py);
        for (int k = 0; k < (MULTI ? stream_passes(p) : 1); ++k) {
          state_init<MULTI>(p, sc, b, (uint32_t)pix, k, st);
          if (p.active[bt] > 0)
            for (int q = 0; q < p.count[bt]; ++q)
              chunk_forward<MULTI>(p, chunk_tables(p, p.tab + ((size_t)b * p.rw + (size_t)list[q] * kChunk) * p.dt, sc),
                                   b, list[q], px, py, live, (uint32_t)pix, st, R);
          if (MULTI) state_pass_end(p, st);
        }
        if (!live) continue;
        float rgb[3];
        state_rgb<MULTI>(p, st, rgb);
        float* o = out + ((size_t)b * p.image_size * p.image_size + pix) * 4;
        o[0] = rgb[0]; o[1] = rgb[1]; o[2] = rgb[2]; o[3] = 1.0f - st.alpha;
      }
    }
}

constexpr int kHostWarps = kStreamWarps;

// The block's records as the card keeps them: windows (the whole record
// in one pass) in `recs`, above kMaxS samples (MULTI) the whole records
// in `drecs` with the windows' heads.
template <bool MULTI>
struct HostRecs {
  const Params& p;
  int rf, rw, passes;
  std::vector<float> recs, drecs;
  explicit HostRecs(const Params& q)
      : p(q), rf(rec_floats(q)), rw(rec_window_floats(q)),
        passes(MULTI ? stream_passes(q) : 1), recs((size_t)kBlockPix * rw),
        drecs((size_t)kBlockPix * rf) {}
  Rec window(int i, int k) {
    return rec_pass<MULTI>(p, recs.data() + (size_t)i * rw, k);
  }
  Rec whole(int i) {
    return rec_whole<MULTI>(p, recs.data() + (size_t)i * rw,
                            drecs.data() + (size_t)i * rf);
  }
};

// K6 (LOSS false) / K7 as the card runs them: per block (32 pixels of a
// tile) kHostWarps warps of 32 fibers, each warp's pixels i = v, v + 4,
// ...; B1 (in passes of kMaxS samples) and the post step (the card's
// first kernel), then B2 (its second); each visit's slices added in warp
// order into the chunk's rows, the scalars as the block's row (the post
// step's warps, then B2's), the tiles and their blocks in ascending
// order, as the card's reductions.
template <bool LOSS, bool MULTI>
static void grads(const Params& p, int n, float* g_rows, float* g_scal,
                  float* loss) {
  const int D = kGeo + p.tex_d, ds = slice_stride(p);
  Lanes L;
  HostRecs<MULTI> H(p);
  std::vector<float> slices((size_t)kHostWarps * kChunk * ds);
  std::vector<float> scratch((size_t)kHostWarps * 4 * kChunk);
  for (int b = 0; b < n; ++b) {
    const float* sc = p.scal + b * kNS;
    StreamAcc total = {};
    for (int t = 0; t < p.nt; ++t) {
      const int bt = b * p.nt + t;
      const bool act = p.active[bt] > 0;
      const int nq = act ? p.count[bt] : 0;
      const int* list = p.rows + (size_t)bt * p.nch;
      for (int sub = 0; sub < p.nsub; ++sub) {
        double wpost[kHostWarps][kTot] = {}, wtot[kHostWarps][kTot] = {};
        auto rec = [&](int i) { return H.whole(i); };
        auto each = [&](int v, HostWarp& w, auto&& fn) {
          for (int i = v; i < kBlockPix; i += kHostWarps) {
            bool live;
            const int pix = tile_pixel(p, t, sub * kBlockPix + i, &live);
            fn(i, pix, live);
          }
        };
        for (int k = 0; k < H.passes; ++k) {
          for (int v = 0; v < kHostWarps; ++v)
            L.run([&](int lane) {
              HostWarp w{lane, &L};
              each(v, w, [&](int i, int pix, bool) {
                warp_state_init(p, sc, b, (uint32_t)pix, w, H.window(i, k));
              });
            });
          for (int q = 0; q < nq; ++q) {
            const Tables T = chunk_tables(p, p.tab + ((size_t)b * p.rw + (size_t)list[q] * kChunk) * p.dt, sc);
            for (int v = 0; v < kHostWarps; ++v)
              L.run([&](int lane) {
                HostWarp w{lane, &L};
                each(v, w, [&](int i, int pix, bool live) {
                  if (!live) return;
                  float px, py;
                  pixel_center(p.image_size, pix, &px, &py);
                  warp_chunk_forward<!LOSS, MULTI>(p, T, b, list[q], px, py, live,
                                                   (uint32_t)pix, w, H.window(i, k),
                                                   scratch.data() + (size_t)v * 4 * kChunk);
                });
              });
          }
          if (MULTI)
            for (int v = 0; v < kHostWarps; ++v)
              L.run([&](int lane) {
                HostWarp w{lane, &L};
                each(v, w, [&](int i, int, bool) {
                  rec_window_out(H.window(i, k), H.whole(i), w);
                });
              });
        }
        for (int v = 0; v < kHostWarps; ++v)
          L.run([&](int lane) {
            HostWarp w{lane, &L};
            PixelAcc acc;
            acc_clear(acc);
            each(v, w, [&](int i, int pix, bool live) {
              if (live && lane == 0)
                warp_post<LOSS>(p, sc, b, pix, act, rec(i), acc);
            });
            w.sync();
            warp_fold(w, acc, wpost[v]);
          });
        for (int q = 0; q < nq; ++q) {
          const Tables T = chunk_tables(p, p.tab + ((size_t)b * p.rw + (size_t)list[q] * kChunk) * p.dt, sc);
          std::fill(slices.begin(), slices.end(), 0.0f);
          unsigned long long mask = 0;
          for (int v = 0; v < kHostWarps; ++v) {
            float* slice = slices.data() + (size_t)v * kChunk * ds;
            L.run([&](int lane) {
              HostWarp w{lane, &L};
              PixelAcc acc;
              acc_clear(acc);
              bool any[2] = {false, false};
              each(v, w, [&](int i, int pix, bool live) {
                if (!live) return;
                float px, py;
                pixel_center(p.image_size, pix, &px, &py);
                warp_chunk_grads<!LOSS>(p, T, b, list[q], px, py, live,
                                        (uint32_t)pix, w, rec(i), slice, ds,
                                        acc, any);
              });
              const unsigned lo = w.ballot(any[0]), hi = w.ballot(any[1]);
              if (lane == 0)
                mask |= (unsigned long long)lo | ((unsigned long long)hi << 32);
              warp_fold(w, acc, wtot[v]);
            });
          }
          for (int r = 0; r < kChunk; ++r) {
            if (!((mask >> r) & 1ull)) continue;
            float* dst = g_rows + ((size_t)b * p.rw + (size_t)list[q] * kChunk + r) * D;
            for (int d = 0; d < D; ++d) {
              float s = 0.0f;
              for (int v = 0; v < kHostWarps; ++v)
                s += slices[((size_t)v * kChunk + r) * ds + d];
              dst[d] += s;
            }
          }
        }
        StreamAcc blk = {};
        for (int k = 0; k < kNS; ++k)
          for (int v = 0; v < kHostWarps; ++v) blk.gsc[k] += wpost[v][k];
        for (int v = 0; v < kHostWarps; ++v) blk.loss += wpost[v][kNS + 2];
        for (int v = 0; v < kHostWarps; ++v) {
          for (int k = 0; k < kNS; ++k) blk.gsc[k] += wtot[v][k];
          blk.g_gal += wtot[v][kNS];
          blk.g_invgam += wtot[v][kNS + 1];
          blk.loss += wtot[v][kNS + 2];
        }
        stream_finish(p, sc, blk);
        for (int k = 0; k < kNS; ++k) total.gsc[k] += blk.gsc[k];
        total.loss += blk.loss;
      }
    }
    for (int k = 0; k < kNS; ++k) g_scal[b * kNS + k] = (float)total.gsc[k];
    loss[b] = (float)total.loss * p.lscale;
  }
}

// B1's replay (K6's) into out (N, H, W, 4): each pixel's colour and alpha
// from its record once the tile's chunks are done, in every pass.
template <bool MULTI>
static void replay(const Params& p, int n, float* out) {
  Lanes L;
  HostRecs<MULTI> H(p);
  std::vector<float> scratch((size_t)kHostWarps * 4 * kChunk);
  for (int b = 0; b < n; ++b) {
    const float* sc = p.scal + b * kNS;
    for (int t = 0; t < p.nt; ++t) {
      const int bt = b * p.nt + t;
      const int nq = p.active[bt] > 0 ? p.count[bt] : 0;
      const int* list = p.rows + (size_t)bt * p.nch;
      for (int sub = 0; sub < p.nsub; ++sub)
        for (int v = 0; v < kHostWarps; ++v)
          L.run([&](int lane) {
            HostWarp w{lane, &L};
            for (int i = v; i < kBlockPix; i += kHostWarps) {
              bool live;
              const int pix = tile_pixel(p, t, sub * kBlockPix + i, &live);
              for (int k = 0; k < H.passes; ++k) {
                const Rec W = H.window(i, k);
                warp_state_init(p, sc, b, (uint32_t)pix, w, W);
                for (int q = 0; q < nq; ++q) {
                  const Tables T = chunk_tables(p, p.tab + ((size_t)b * p.rw + (size_t)list[q] * kChunk) * p.dt, sc);
                  float px, py;
                  pixel_center(p.image_size, pix, &px, &py);
                  warp_chunk_forward<true, MULTI>(p, T, b, list[q], px, py, live,
                                                  (uint32_t)pix, w, W,
                                                  scratch.data() + (size_t)v * 4 * kChunk);
                }
                if (MULTI) rec_window_out(W, H.whole(i), w);
                w.sync();
              }
              const Rec R = H.whole(i);
              if (!live || lane != 0) continue;
              float rgb[3];
              rec_rgb(p, R, rgb);
              float* o = out + ((size_t)b * p.image_size * p.image_size + pix) * 4;
              o[0] = rgb[0]; o[1] = rgb[1]; o[2] = rgb[2];
              o[3] = 1.0f - R.h[kRAlpha];
            }
          });
    }
  }
}

// mode 0: K5's forward into out (N, H, W, 4); 1: K6 (extra g_out); 2: K7;
// 3: B1's replay into out.
extern "C" void host_stream(
    int mode, const float* tab, const int* rows, const int* count,
    const int* active, const float* scal, const int* seeds,
    const float* extra, float* out, float* g_tab, float* g_scal,
    float* loss, int n, int nt, int nch, int p_tile, int tile_w, int rw,
    int dt, const int* cfg, float eps_bg, int loss_kind, float lscale) {
  Params p = {};
  fill(p, tab, rows, count, active, scal, seeds, extra, nt, nch, p_tile,
       tile_w, rw, dt, cfg, eps_bg, loss_kind, lscale);
  const bool multi = stream_passes(p) > 1;
  if (mode == 0)
    multi ? forward<true>(p, n, out) : forward<false>(p, n, out);
  else if (mode == 3)
    multi ? replay<true>(p, n, out) : replay<false>(p, n, out);
  else if (mode == 1)
    multi ? grads<false, true>(p, n, g_tab, g_scal, loss)
          : grads<false, false>(p, n, g_tab, g_scal, loss);
  else
    multi ? grads<true, true>(p, n, g_tab, g_scal, loss)
          : grads<true, false>(p, n, g_tab, g_scal, loss);
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
    (K7, ``extra`` = target), 3 the gradients' B1 replay as an image."""
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
    check_pipeline(host_lib, noise, kind, imsize, textures, 2)


@pytest.mark.parametrize("noise", ["gaussian", "cauchy"])
def test_stream_pipeline_at_128_samples_matches_plain_on_host(noise,
                                                              host_lib):
    """Above kMaxS = 64 aggregation samples K5 and B1 run two passes over
    the chunk list (B1's records in windows of 64, the whole in device
    memory): K5's image, the replay's bits and K6 / K7's gradients as at
    S = 2."""
    check_pipeline(host_lib, noise, "cube", 16, "uv", 128)


def check_pipeline(host_lib, noise, kind, imsize, textures, s):
    cube = kind == "cube"
    mesh, _cams, _lights, renderer = build(
        noise, imsize=imsize, k=4 if cube else 50, s=s, mesh_kind=kind,
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
    # K6 / K7's replay renders K5's image bit for bit (K7 = K5 + K6).
    assert torch.equal(host_stream(host_lib, 3, cfg, tin)[0], img)

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
