"""The fused kernels' per-pixel arithmetic, compiled for the CPU.

``csrc/fused_grad.cuh`` (the pipeline of K4 and K2) keeps its CUDA
intrinsics inside ``#ifdef __CUDACC__``; with the CUDA keywords defined
away, g++ compiles ``pixel_grads`` and ``finish_pixels``.  A host Sink adds
each pixel's slot gradients directly, so the summed result must equal the
plain versions (``backward_plain``, ``loss_grad_plain``: torch autograd
through the plain forward) on the same inputs — the hand-derived adjoints
are checked without a card.  The sum order differs from the card's warp
reduction, which only rounds differently.

The sharded route's pipelines are compiled the same way: K11a's coverage
(``pixel_prob``), K3 with external coverage (``pixel_forward<..., EXT>``),
K11b (``pixel_agg_grads``) and K11c (``pixel_grads<..., EXT>``), against
``prob_plain``, ``forward_plain(..., prob=)``, ``agg_bwd_plain`` and
``det_bwd_plain`` on one shard's seed words.

K12's warp pipeline (``csrc/binned_warp.cuh``: a pixel's slots across
the 32 lanes of a warp) is compiled with its lanes emulated: 32 fibers
on one thread run the same code in lock step, switching at every
shuffle, ballot and warp barrier, and a block's warps run in turn, each
into its own slice, added in warp order as on the card.  It is held
against ``binned_forward_plain`` / ``binned_backward_plain`` /
``binned_loss_grad_plain``.

Tolerances: each gradient table within 1e-4 (deterministic pairs) or
1e-3 (MC pairs, same noise) of its max |grad|; losses rtol 1e-5; MC
fields (coverage, weights) and images by the MC image rule.  Skips where
no g++ is installed."""

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
  bool all(bool x) { return x; }
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

// The sharded route's pipelines over every pixel of every element (flat
// tables; tiles of p_tile pixels, 2-D with tile_w): mode 0 K11a's coverage
// into out (n, F, P); 1 K3 with external coverage, the image into out (n,
// P, 4) and the weights into out2 (n, C, P); 2 K11b, g_zmap into out (n, C,
// P) and the gamma term into out2 (n,); 3 K11c's rows into out (n, width)
// as host_grads.
template <int MAXF>
void sharded(Params& p, int n, int mode, float* out, float* out2) {
  const int F = p.f_pad, C = p.c_zpad, npix = p.image_size * p.image_size;
  const int width = F * (kGeo + p.tex_d) + kNS + 1;
  std::vector<float> buf(table_floats(p));
  std::vector<FaceConst> fc(F);
  p.w_out = out2;
  for (int b = 0; b < n; ++b) {
    const Tables T = fill(p, buf, b, b);
    for (int i = 0; i < F; ++i) face_const(T, i, fc[i]);
    if (mode == 3) {
      HostSink sink{out + (size_t)b * width};
      PixelAcc acc;
      for (int k = 0; k < kNS; ++k) acc.gsc[k] = 0.0f;
      acc.g_gal = acc.g_invgam = acc.loss = 0.0f;
      for (int pix = 0; pix < npix; ++pix)
        pixel_grads<MAXF, false, HostSink, PixelAcc, true>(p, T, b, pix,
                                                           true, sink, acc);
      finish_pixels(p, T, sink, acc);
      continue;
    }
    for (int pix = 0; pix < npix; ++pix) {
      if (mode == 0) {
        float prob[MAXF];
        pixel_prob<MAXF>(p, T, b, pix, prob);
        for (int i = 0; i < F; ++i)
          out[((size_t)b * F + i) * npix + pix] = prob[i];
      } else if (mode == 1) {
        pixel_forward<MAXF, float, true>(p, T, b, pix,
                                         out + ((size_t)b * npix + pix) * 4);
      } else {
        float gz[MAXF + 8];
        out2[b] += pixel_agg_grads<MAXF>(p, T, fc.data(), b, pix, gz);
        for (int r = 0; r < C; ++r)
          out[((size_t)b * C + r) * npix + pix] = gz[r];
      }
    }
  }
}

extern "C" void host_sharded(
    int mode, const float* fv_ndc, const float* fv_world, const float* fn,
    const float* tex, const float* valid, const float* scal,
    const int* seeds, const float* g_out, const float* prob,
    const float* weights, const float* g_zmap, float* out, float* out2,
    int n, int image_size, int f_pad, int bg_row, int c_zpad, int tex_d,
    int atlas_r, int rast_kind, int rast_noise, int rast_vr, int s_rast,
    int agg_kind, int agg_noise, int agg_vr, int s_agg, int k, float eps_bg,
    int phong, int point_light, int clip, int persp, const int* active,
    int nt, int p_tile, int tile_w) {
  Params p = {};
  p.fv_ndc = fv_ndc; p.fv_world = fv_world; p.fn = fn; p.tex = tex;
  p.valid = valid; p.scal = scal; p.seeds = seeds; p.extra = g_out;
  p.prob_ext = prob; p.w_in = weights; p.gz_in = g_zmap;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  if (f_pad <= 16) sharded<16>(p, n, mode, out, out2);
  else sharded<64>(p, n, mode, out, out2);
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


# A warp on the CPU: 32 fibers on one thread, one per lane (an x86-64
# context switch), with the warp type of csrc/warp.cuh.  Shared by the
# host builds of the warp pipelines (K12 here, K6 / K7 in
# test_torch_stream_host.py, K8c in test_torch_perturbed_goldens.py).
FIBERS = r"""
#include <cstring>
#include <functional>
#include <vector>

// 32 fibers on one thread, one per lane, run in turn: a lane that reaches
// a warp barrier hands over to the next, so every lane has reached it
// when lane 0 resumes (the pipeline's warp primitives are all in
// converged code, as on the card).
extern "C" void pt_fiber_switch(void** save, void* load);
asm(R"(
.text
.globl pt_fiber_switch
.type pt_fiber_switch,@function
pt_fiber_switch:
    pushq %rbp
    pushq %rbx
    pushq %r12
    pushq %r13
    pushq %r14
    pushq %r15
    movq %rsp, (%rdi)
    movq %rsi, %rsp
    popq %r15
    popq %r14
    popq %r13
    popq %r12
    popq %rbx
    popq %rbp
    ret
.size pt_fiber_switch,.-pt_fiber_switch
)");

struct Lanes;
static Lanes* g_lanes = nullptr;

struct Lanes {
  static constexpr size_t kStack = 1 << 20;
  void* sp[32];
  void* main_sp = nullptr;
  std::vector<char> stack[32];
  int cur = 0, finished = 0;
  std::function<void(int)> body;
  uint64_t slot[32];

  static void trampoline() {
    Lanes* L = g_lanes;
    L->body(L->cur);
    ++L->finished;
    const int me = L->cur;
    if (L->finished == 32) pt_fiber_switch(&L->sp[me], L->main_sp);
    L->cur = me + 1;
    pt_fiber_switch(&L->sp[me], L->sp[me + 1]);
  }
  void run(std::function<void(int)> fn) {
    body = fn;
    finished = 0;
    for (int l = 0; l < 32; ++l) {
      stack[l].resize(kStack);
      uintptr_t top = ((uintptr_t)stack[l].data() + kStack) & ~(uintptr_t)15;
      void** s = (void**)top;
      *--s = nullptr;
      *--s = (void*)&trampoline;
      for (int r = 0; r < 6; ++r) *--s = nullptr;
      sp[l] = s;
    }
    g_lanes = this;
    cur = 0;
    pt_fiber_switch(&main_sp, sp[0]);
  }
  void barrier() {
    const int me = cur, nx = (me + 1) & 31;
    cur = nx;
    pt_fiber_switch(&sp[me], sp[nx]);
  }
  template <class T> T exch(int lane, T v, int src) {
    std::memcpy(&slot[lane], &v, sizeof(T));
    barrier();
    T r;
    std::memcpy(&r, &slot[src], sizeof(T));
    barrier();
    return r;
  }
  unsigned vote(int lane, bool x) {
    slot[lane] = x ? 1 : 0;
    barrier();
    unsigned m = 0;
    for (int l = 0; l < 32; ++l) m |= (slot[l] ? 1u : 0u) << l;
    barrier();
    return m;
  }
};

struct HostWarp {
  int lane;
  Lanes* L;
  template <class T> T shfl_xor(T v, int o) { return L->exch(lane, v, lane ^ o); }
  template <class T> T shfl_up(T v, int d) {
    return L->exch(lane, v, lane >= d ? lane - d : lane);
  }
  template <class T> T shfl_down(T v, int d) {
    return L->exch(lane, v, lane + d < 32 ? lane + d : lane);
  }
  template <class T> T shfl(T v, int s) { return L->exch(lane, v, s); }
  unsigned ballot(bool x) { return L->vote(lane, x); }
  void sync() { L->barrier(); }
};

"""

WARP_HARNESS = FIBERS + r"""
#include "binned_warp.cuh"
using namespace ptf;

// Tile bt's tables in K12's shared-memory layout (ndc, world, normals,
// validity, texels, scalars).
Tables fill_k12(const Params& p, std::vector<float>& buf, size_t bt, int b) {
  const int F = p.f_pad, td = p.tex_d;
  buf.assign((size_t)F * (28 + td) + kNS, 0.0f);
  float* s = buf.data();
  std::memcpy(s, p.fv_ndc + bt * F * 9, sizeof(float) * F * 9);
  std::memcpy(s + F * 9, p.fv_world + bt * F * 9, sizeof(float) * F * 9);
  std::memcpy(s + F * 18, p.fn + bt * F * 9, sizeof(float) * F * 9);
  std::memcpy(s + F * 27, p.valid + bt * F, sizeof(float) * F);
  std::memcpy(s + F * 28, p.tex + bt * F * td, sizeof(float) * F * td);
  std::memcpy(s + F * (28 + td), p.scal + (size_t)b * kNS,
              sizeof(float) * kNS);
  Tables T;
  T.ndc = s; T.world = s + F * 9; T.fn = s + F * 18; T.valid = s + F * 27;
  T.tex = s + F * 28; T.sc = s + F * (28 + td);
  T.rs_geo = 9; T.rs_tex = td; T.rs_valid = 1; T.key_valid = false;
  return T;
}

constexpr int kHostWarps = 2;    // warps per block (slices added in order)

// mode -1: K12's forward into out (n, H * W, 4); 0 / 1: K4's / K2's
// gradients, the slot rows into out (n, nt, F, 27 + tex_d) and the
// tiles' scalar rows into rows64 (n, nt, 35).
template <int MAXF>
void warp_run(Params& p, int n, int mode, float* out, double* rows64) {
  const int F = p.f_pad, D = kGeo + p.tex_d, npix = p.image_size * p.image_size;
  std::vector<float> buf;
  Lanes L;
  std::vector<double> lg(kMaxLogS + 1);
  for (int k = 0; k <= p.s_rast && k <= kMaxLogS; ++k)
    lg[k] = log_prob_mean(k, p.s_rast);
  const double* lgs = uses_log_table(p) ? lg.data() : nullptr;
  for (int b = 0; b < n; ++b)
    for (int t = 0; t < p.nt; ++t) {
      const size_t bt = (size_t)b * p.nt + t;
      const float* scg = p.scal + (size_t)b * kNS;
      const bool act = p.active[bt] > 0;
      if (!act) {
        PixelAccT<double> acc;
        zero_acc(acc);
        for (int i = 0; i < p.p_tile; ++i) {
          bool inside;
          const int pix = tile_pixel(p, t, i, &inside);
          if (!inside) continue;
          if (mode < 0) {
            float* o = out + ((size_t)b * npix + pix) * 4;
            o[0] = scg[kBg]; o[1] = scg[kBg + 1]; o[2] = scg[kBg + 2]; o[3] = 0.0f;
          } else if (mode == 0) {
            background_grads<false>(p, scg, b, pix, acc);
          } else {
            background_grads<true>(p, scg, b, pix, acc);
          }
        }
        if (mode >= 0) {
          for (int k = 0; k < kNS; ++k) rows64[bt * (kNS + 1) + k] = acc.gsc[k];
          rows64[bt * (kNS + 1) + kNS] = acc.loss;
        }
        continue;
      }
      const Tables T = fill_k12(p, buf, bt, b);
      std::vector<float> slices((size_t)kHostWarps * F * D, 0.0f);
      double stage[kHostWarps][kNS + 1];
      for (int v = 0; v < kHostWarps; ++v) {
        std::vector<int> list(F);
        std::vector<float> nzbuf(p.c_zpad);
        float* mine = slices.data() + (size_t)v * F * D;
        GradRows rows;
        rows.ndc = mine; rows.world = mine + F * 9; rows.fn = mine + F * 18;
        rows.tex = mine + F * 27; rows.tex_d = p.tex_d;
        L.run([&](int lane) {
          HostWarp w{lane, &L};
          PixelAccT<double> acc;
          zero_acc(acc);
          for (int i = v; i < p.p_tile; i += kHostWarps) {
            bool inside;
            const int pix = tile_pixel(p, t, i, &inside);
            if (!inside) continue;
            if (mode < 0) {
              float o[4];
              warp_pixel_forward<MAXF>(p, T, b, pix, w, list.data(),
                                       nzbuf.data(), lgs, o);
              if (lane == 0)
                std::memcpy(out + ((size_t)b * npix + pix) * 4, o, sizeof(o));
            } else if (mode == 0) {
              warp_pixel_grads<MAXF, false>(p, T, b, pix, w, list.data(),
                                            nzbuf.data(), lgs, rows, acc);
            } else {
              warp_pixel_grads<MAXF, true>(p, T, b, pix, w, list.data(),
                                           nzbuf.data(), lgs, rows, acc);
            }
          }
          if (mode >= 0) warp_finish(p, T.sc, acc, w, stage[v]);
        });
      }
      if (mode < 0) continue;
      // The slices in warp order, from the tables' layout to (F, D) rows.
      float* dst = out + bt * F * D;
      for (int e = 0; e < F * D; ++e) {
        float s = 0.0f;
        for (int v = 0; v < kHostWarps; ++v) s += slices[(size_t)v * F * D + e];
        int i, d;
        if (e < 27 * F) { const int g = e / (9 * F), r = e % (9 * F);
                          i = r / 9; d = g * 9 + r % 9; }
        else { const int r = e - 27 * F; i = r / p.tex_d; d = kGeo + r % p.tex_d; }
        dst[i * D + d] = s;
      }
      for (int k = 0; k <= kNS; ++k) {
        double s = 0.0;
        for (int v = 0; v < kHostWarps; ++v) s += stage[v][k];
        rows64[bt * (kNS + 1) + k] = s;
      }
    }
}

extern "C" void host_warp(
    int mode, const float* fv_ndc, const float* fv_world, const float* fn,
    const float* tex, const float* valid, const float* scal,
    const int* seeds, const float* extra, float* out, double* rows64, int n,
    int image_size, int f_pad, int bg_row, int c_zpad, int tex_d,
    int atlas_r, int rast_kind, int rast_noise, int rast_vr, int s_rast,
    int agg_kind, int agg_noise, int agg_vr, int s_agg, int k, float eps_bg,
    int phong, int point_light, int clip, int persp, int loss_kind,
    float lscale, const int* active, int nt, int p_tile) {
  Params p = {};
  p.fv_ndc = fv_ndc; p.fv_world = fv_world; p.fn = fn; p.tex = tex;
  p.valid = valid; p.scal = scal; p.seeds = seeds; p.extra = extra;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  p.loss_kind = loss_kind; p.lscale = mode == 1 ? lscale : 0.0f;
  set_tiling(p, active, nt, p_tile, 0);
  if (f_pad <= 32) warp_run<32>(p, n, mode, out, rows64);
  else warp_run<64>(p, n, mode, out, rows64);
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
    lib.host_sharded.argtypes = ([i32] + [ptr] * 13 + [i32] * 16
                                 + [ctypes.c_float] + [i32] * 4
                                 + [ptr, i32, i32, i32])
    return lib


@pytest.fixture(scope="module")
def warp_lib(tmp_path_factory):
    """K12's warp pipeline built for the CPU with its lanes emulated (an
    x86-64 fiber switch)."""
    import platform

    gxx = shutil.which("g++")
    if gxx is None or platform.machine() != "x86_64":
        pytest.skip("needs g++ on x86-64 to emulate the warp's lanes")
    d = tmp_path_factory.mktemp("host_warp")
    (d / "stub.h").write_text(STUB)
    (d / "warp.cpp").write_text(WARP_HARNESS)
    so = d / "libhost_warp.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-include", str(d / "stub.h"), "-I", _build.CSRC,
                    str(d / "warp.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.host_warp.argtypes = ([i32] + [ptr] * 10 + [i32] * 16
                              + [ctypes.c_float] + [i32] * 5
                              + [ctypes.c_float, ptr, i32, i32])
    return lib


def _host_call(lib, cfg, tables, extra, mode, rows, loss_id=0, lscale=0.0):
    """Run the host build: ``mode`` -1 the forward, 0 K4's pipeline, 1
    K2's, with the tiles' activity bits (``tables[7]``); binned
    configurations take the tables per tile."""
    n = tables[0].shape[0]
    lib.host_grads(mode, *(t.data_ptr() for t in tables[:7]),
                   extra.data_ptr(), rows.data_ptr(), n, *tfr._cfg_args(cfg),
                   loss_id, ctypes.c_float(lscale), int(cfg.binned),
                   tables[7].data_ptr(), tfr._n_tiles(cfg), cfg.p_tile)
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


@pytest.mark.parametrize("noise", ["gaussian", "gaussian_wovr", "softras",
                                   "hard"])
def test_kernel_pipeline_with_inactive_tiles_on_host(noise, host_lib):
    """K4 and K2 on the cube moved up at 48^2 (sigma 1e-3): the lower tile
    is inactive and most pixels have no candidate, so they take the
    pipeline's early exit (on the card a warp of them; here each such
    pixel): the background colour's gradient and the loss.  Without
    variance reduction the MC aggregation's gamma term runs on.  Against
    the plain versions as above."""
    mesh, renderer = _renderer(noise, "cpu", imsize=48, sigma=1e-3)
    mesh = mesh.offset_verts(torch.tensor((0.0, 2.5, 0.0))
                             .expand(mesh.verts.shape[1], 3))
    cfg, tables = _inputs(mesh, renderer)
    assert tables[7].tolist() == [[1, 0], [1, 0]]
    mc = noise in MC_NOISES
    g_out = torch.randn(2, 48, 48, 4, generator=torch.Generator()
                        .manual_seed(1))
    got = host_grads(host_lib, cfg, tables, g_out)
    assert_tables_close(got[1:], tfr.backward_plain(cfg, *tables, g_out), mc)
    target = torch.rand(2, 3, 48 * 48,
                        generator=torch.Generator().manual_seed(2))
    lscale = 1.0 / (2 * 48 * 48 * 3)
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


def host_warp(lib, cfg, tables, mode, extra=None, loss_id=0, lscale=0.0):
    """K12's warp pipeline on the host over per-tile ``tables`` (the 8
    kernel inputs): mode -1 the forward, (N, H, W, 4); 0 K4's gradients
    (``extra`` = g_out), 1 K2's (``extra`` = target): (loss (N,), g_ndc,
    g_world, g_fn, g_tex, g_scal), the tiles' scalar rows added in order
    in double."""
    n, f, s = tables[0].shape[0], cfg.f_pad, cfg.image_size
    nt, d = tfr._n_tiles(cfg), 27 + cfg.tex_d
    out = torch.zeros((n, s * s, 4) if mode < 0 else (n, nt, f, d))
    rows64 = torch.zeros(n, nt, 35, dtype=torch.float64)
    extra = torch.zeros(1) if extra is None else extra.contiguous()
    lib.host_warp(mode, *(t.data_ptr() for t in tables[:7]),
                  extra.data_ptr(), out.data_ptr(), rows64.data_ptr(), n,
                  *tfr._cfg_args(cfg), loss_id, ctypes.c_float(lscale),
                  tables[7].data_ptr(), nt, cfg.p_tile)
    if mode < 0:
        return out.reshape(n, s, s, 4)
    scal = torch.zeros(n, 35, dtype=torch.float64)
    for t in range(nt):                      # the tiles in order
        scal += rows64[:, t]
    scal = scal.float()
    return (scal[:, -1] * lscale, out[..., :9], out[..., 9:18],
            out[..., 18:27], out[..., 27:], scal[:, :34])


@pytest.mark.parametrize("noise", ["gaussian", "softras", "cauchy",
                                   "gaussian_wovr", "hard"])
def test_binned_warp_pipeline_matches_plain_on_host(noise, warp_lib, host_lib,
                                                    monkeypatch, one_thread):
    """K12's warp pipeline (the slots across a warp's lanes, emulated) on
    the icosphere at 64^2, tiles of 32 pixels, M = 32, against
    ``binned_forward_plain`` / ``binned_backward_plain`` /
    ``binned_loss_grad_plain``: images by the MC image rule or atol 2e-5,
    gradients by ``checks.binned_grads_close`` (1e-3 MC, 1e-4
    deterministic, thin rows by L / h) against the float32 or float64
    plain version, losses rtol 1e-5; a second run bit-equal.  Its image
    equals the per-pixel pipeline's (``pixel_forward<M, double>``) bit for
    bit wherever the weights are counts or one-hots (all but softras,
    whose softmax sums in another order): the draws it skips cannot
    change a result."""
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
    assert 0 < int(tables[7].sum()) < tables[7].numel()   # inactive tiles
    mc = noise in MC_NOISES
    tol = 1e-3 if mc else 1e-4
    img = host_warp(warp_lib, cfg, tables, -1)
    assert torch.equal(img, host_warp(warp_lib, cfg, tables, -1))
    if noise != "softras":
        assert torch.equal(img, host_forward(host_lib, cfg, tables))
    assert_kernel_close(img, tbin.binned_forward_plain(cfg, *tables), mc)
    tables64 = [t.double() if t.is_floating_point() else t for t in tables]
    g_out = torch.randn(2, 64, 64, 4, generator=torch.Generator()
                        .manual_seed(1))
    got = host_warp(warp_lib, cfg, tables, 0, g_out)
    want = tbin.binned_backward_plain(cfg, *tables, g_out)
    want64 = tbin.binned_backward_plain(cfg, *tables64, g_out.double())
    ok, err, where, _thin, _rep = checks.binned_grads_close(
        cfg, tables[:4], got[1:], want, want64, tol)
    assert ok, (err, where)
    target = torch.rand(2, 3, 64 * 64, generator=torch.Generator()
                        .manual_seed(2))
    lscale = 1.0 / (2 * 64 * 64 * 3)
    got = host_warp(warp_lib, cfg, tables, 1, target, 0, lscale)
    again = host_warp(warp_lib, cfg, tables, 1, target, 0, lscale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    w_loss, *want = tbin.binned_loss_grad_plain(cfg, *tables, target,
                                                "l2_rgb", lscale)
    _l64, *want64 = tbin.binned_loss_grad_plain(cfg, *tables64,
                                                target.double(), "l2_rgb",
                                                lscale)
    torch.testing.assert_close(got[0], w_loss, rtol=1e-5, atol=0)
    ok, err, where, _thin, _rep = checks.binned_grads_close(
        cfg, tables[:4], got[1:], want, want64, tol)
    assert ok, (err, where)


def host_sharded(lib, cfg, tables, mode, prob=None, weights=None,
                 g_zmap=None, g_out=None):
    """Run the host build of a sharded pipeline over flat ``tables`` (the
    8 kernel inputs): mode 0 K11a -> prob (N, F, P); 1 K3 with external
    coverage -> (image (N, H, W, 4), weights (N, C, P)); 2 K11b -> (g_zmap
    (N, C, P), gamma term (N,)); 3 K11c -> (g_ndc, g_world, g_fn, g_tex,
    g_scal)."""
    n, f, s = tables[0].shape[0], cfg.f_pad, cfg.image_size
    hw, c, d = s * s, cfg.c_zpad, 27 + cfg.tex_d
    none = torch.zeros(1)
    out = torch.zeros({0: (n, f, hw), 1: (n, hw, 4), 2: (n, c, hw),
                       3: (n, f * d + 35)}[mode])
    out2 = torch.zeros((n, c, hw) if mode == 1 else (n,))
    args = [x if x is not None else none
            for x in (g_out, prob, weights, g_zmap)]
    lib.host_sharded(mode, *(t.data_ptr() for t in tables[:7]),
                     *(t.contiguous().data_ptr() for t in args),
                     out.data_ptr(), out2.data_ptr(), n,
                     *tfr._cfg_args(cfg), tables[7].data_ptr(),
                     *tfr._tiling_args(cfg))
    if mode == 0:
        return out
    if mode == 1:
        return out.reshape(n, s, s, 4), out2
    if mode == 2:
        return out, out2
    tabs = out[:, :f * d].reshape(n, f, d)
    return (tabs[..., :9], tabs[..., 9:18], tabs[..., 18:27], tabs[..., 27:],
            out[:, f * d:f * d + 34])


@pytest.mark.parametrize("imsize,shift", [(16, None), (48, (0.0, 2.5, 0.0))])
def test_sharded_pipelines_match_plain_on_host(imsize, shift, host_lib,
                                              one_thread):
    """K11a, K3 with external coverage, K11b and K11c's per-pixel
    pipelines against their plain versions on shard 1's seed words of the
    gaussian pair: coverage, image and weights by the MC image rule; g_zmap
    and the gamma term within 1e-3 of their max; tables as K4's.  At 48^2
    the cube, moved up, leaves the lower tile inactive."""
    from test_torch_cuda import sharded_case

    cfg, tables = sharded_case("cpu", imsize, shift)
    if shift is not None:
        assert tables[7].tolist() == [[1, 0], [1, 0]]
    cover = (tables[0], tables[4], tables[5], tables[6], tables[7])
    prob = tfr.prob_plain(cfg, *cover)
    assert_fields = lambda a, b: assert_kernel_close(
        a.transpose(1, 2), b.transpose(1, 2), True)
    assert_fields(host_sharded(host_lib, cfg, tables, 0), prob)
    img, w = host_sharded(host_lib, cfg, tables, 1, prob=prob)
    want_img, want_w = tfr.forward_plain(cfg, *tables, prob)
    assert_kernel_close(img, want_img, True)
    assert_fields(w, want_w)
    g_out = torch.randn(2, imsize, imsize, 4, generator=torch.Generator()
                        .manual_seed(1))
    gz, gg = host_sharded(host_lib, cfg, tables, 2, prob=prob, g_out=g_out)
    want_gz, want_gg = tfr.agg_bwd_plain(cfg, *tables, prob, g_out)
    for got_t, want_t in ((gz, want_gz), (gg, want_gg)):
        assert ((got_t - want_t).abs().max()
                <= 1e-3 * want_t.abs().max()), (got_t, want_t)
    got = host_sharded(host_lib, cfg, tables, 3, prob=prob, weights=want_w,
                       g_zmap=want_gz, g_out=g_out)
    assert_tables_close(got, tfr.det_bwd_plain(cfg, *tables, prob, want_w,
                                               want_gz, g_out), True)
