"""K3's and K11a's warp pipelines and K11b's certain exit, compiled for
the CPU.

``csrc/flat_warp.cuh`` (K3: a thread per pixel, the warp's noise draws
packed across its lanes) is built with g++ and its 32 lanes emulated as
fibers (``FIBERS`` of test_torch_kernel_host.py), and held bit for bit
against the per-pixel reference ``pixel_forward`` of
``csrc/fused_common.cuh``, built beside it: drawn and external coverage,
every estimator pair, variance reduction on and off, inactive tiles,
warps with no candidate, S = 8 and S > 64.  K11a's (``warp_flat_prob``,
the same lane groups and draw lists) is held bit for bit against the
per-pixel ``pixel_prob``.  K11b's pixel pipeline
(``pixel_agg_grads``, which stops where only one row can win) is held
against the full replay (``mc_agg_replay`` on every pixel): g_zmap equal
up to the sign of zero and each pixel's gamma term equal.  Both
certainty rules are checked by hypothesis against every draw at margins of
exactly fl(|sigma| B) and fl(2 |gamma| B), one ulp either side.  Skips
where no g++ on x86-64 is installed."""

import ctypes
import dataclasses
import platform
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pertrenderer_tpu_torch import _build
from pertrenderer_tpu_torch.ops import fused_render as tfr

from test_torch_cuda import _inputs, _renderer, sharded_case
from test_torch_kernel_host import FIBERS, STUB

HARNESS = FIBERS + r"""
#include <type_traits>
#include "flat_warp.cuh"
#include "fused_grad.cuh"
using namespace ptf;

Tables fill(const Params& p, std::vector<float>& buf, int b) {
  const int F = p.f_pad;
  buf.assign(table_floats(p), 0.0f);
  float* s = buf.data();
  std::memcpy(s, p.fv_ndc + (size_t)b * F * 9, sizeof(float) * F * 9);
  std::memcpy(s + F * 9, p.fv_world + (size_t)b * F * 9, sizeof(float) * F * 9);
  std::memcpy(s + F * 18, p.fn + (size_t)b * F * 9, sizeof(float) * F * 9);
  std::memcpy(s + F * 27, p.valid + (size_t)b * F, sizeof(float) * F);
  std::memcpy(s + F * 28, p.scal + (size_t)b * kNS, sizeof(float) * kNS);
  std::memcpy(s + F * 28 + kNS, p.tex + (size_t)b * F * p.tex_d,
              sizeof(float) * F * p.tex_d);
  return tables_at(p, s);
}

// The faces' FaceConst, as the kernels keep them in shared memory.
std::vector<FaceConst> faces(const Params& p, const Tables& T) {
  std::vector<FaceConst> fc(p.f_pad);
  for (int i = 0; i < p.f_pad; ++i) face_const(T, i, fc[i]);
  return fc;
}

// mode 0: K3's warp pipeline over warps of 32 row-major pixels (counts:
// its FlatCounts summed; *dirty: a hit count left non-zero); 1: the
// per-pixel pixel_forward.  The image into out (n, P, 4), under EXT the
// weights into p.w_out.
template <int MAXF, bool EXT>
void flat_run(Params& p, int n, int mode, float* out,
              unsigned long long* counts, int* dirty) {
  const int npix = p.image_size * p.image_size;
  std::vector<float> buf;
  std::vector<int> scratch(flat_scratch_words<MAXF>(), 0);
  const FlatScratch S = flat_scratch<MAXF>(scratch.data());
  Lanes L;
  for (int b = 0; b < n; ++b) {
    const Tables T = fill(p, buf, b);
    if (mode == 1) {
      for (int pix = 0; pix < npix; ++pix)
        pixel_forward<MAXF, float, EXT>(p, T, b, pix,
                                        out + ((size_t)b * npix + pix) * 4);
      continue;
    }
    const std::vector<FaceConst> fc = faces(p, T);
    // Warps of 32 / kGroup pixels, kGroup lanes each, as on the card.
    constexpr int G = kGroup<MAXF>();
    for (int base = 0; base < npix; base += 32 / G) {
      L.run([&](int lane) {
        HostWarp w{lane, &L};
        const int pix = base + lane / G;
        const bool live = pix < npix;
        FlatCounts dc = {};
        float o[4];
        warp_flat_forward<MAXF, EXT>(p, T, fc.data(), b, live ? pix : 0,
                                     live, w, S, dc, o);
        if (live && lane % G == 0)
          std::memcpy(out + ((size_t)b * npix + pix) * 4, o, sizeof(o));
        const unsigned long long v[8] = {dc.pixels, dc.certain,
                                         dc.cover_full, dc.cover_drawn,
                                         dc.agg_full, dc.agg_drawn,
                                         dc.near, dc.weighted};
        for (int k = 0; k < 8; ++k) counts[k] += v[k];
      });
      for (int k = 0; k < 2 * flat_list<MAXF>(); ++k)
        if (S.hits[k] != 0) *dirty = 1;
    }
  }
}

// K11a: mode 0 its warp pipeline (warp_flat_prob) over warps of 32 /
// kGroup pixels (counts: its FlatCounts summed; *dirty: a hit count left
// non-zero); 1: the per-pixel pixel_prob.  The coverage into out (n, f_pad,
// P).
template <int MAXF>
void prob_run(Params& p, int n, int mode, float* out,
              unsigned long long* counts, int* dirty) {
  const int F = p.f_pad, U = F / 2, npix = p.image_size * p.image_size;
  std::vector<float> buf;
  std::vector<int> scratch(flat_scratch_words<MAXF>(), 0);
  const FlatScratch S = flat_scratch<MAXF>(scratch.data());
  Lanes L;
  for (int b = 0; b < n; ++b) {
    const Tables T = fill(p, buf, b);
    float* ob = out + (size_t)b * F * npix;
    if (mode == 1) {
      for (int pix = 0; pix < npix; ++pix) {
        float pr[MAXF];
        pixel_prob<MAXF>(p, T, b, pix, pr);
        for (int i = 0; i < F; ++i) ob[(size_t)i * npix + pix] = pr[i];
      }
      continue;
    }
    const std::vector<FaceConst> fc = faces(p, T);
    constexpr int G = kGroup<MAXF>(), KU = kUnits<MAXF>();
    for (int base = 0; base < npix; base += 32 / G) {
      L.run([&](int lane) {
        HostWarp w{lane, &L};
        const int pix = base + lane / G, g = lane % G;
        const bool live = pix < npix;
        FlatCounts dc = {};
        float pr[2 * KU];
        warp_flat_prob<MAXF>(p, fc.data(), T.sc, b, live ? pix : 0, live, w,
                             S, dc, pr);
        for (int j = 0; live && j < 2 * KU; ++j) {
          const int u = g + (j % KU) * G;
          if (u < U) ob[(size_t)(u + (j / KU) * U) * npix + pix] = pr[j];
        }
        const unsigned long long v[8] = {dc.pixels, dc.certain,
                                         dc.cover_full, dc.cover_drawn,
                                         dc.agg_full, dc.agg_drawn,
                                         dc.near, dc.weighted};
        for (int k = 0; k < 8; ++k) counts[k] += v[k];
      });
      for (int k = 0; k < 2 * flat_list<MAXF>(); ++k)
        if (S.hits[k] != 0) *dirty = 1;
    }
  }
}

// K11b per pixel: pixel_agg_grads (gz, term; certain: its exit taken)
// and the full replay of every pixel (gz_full, term_full), as the
// pipeline was before the exit.
template <int MAXF>
void agg_bwd_run(Params& p, int n, float* gz_out, float* term,
                 float* gz_full, float* term_full, int* certain) {
  constexpr int MAXC = MAXF + 8;
  const int F = p.f_pad, C = p.c_zpad, npix = p.image_size * p.image_size;
  std::vector<float> buf;
  for (int b = 0; b < n; ++b) {
    const Tables T = fill(p, buf, b);
    const std::vector<FaceConst> fc = faces(p, T);
    for (int pix = 0; pix < npix; ++pix) {
      const size_t at = (size_t)b * npix + pix;
      float gz[MAXC];
      bool cert = false;
      term[at] = pixel_agg_grads<MAXF>(p, T, fc.data(), b, pix, gz, &cert);
      certain[at] = cert ? 1 : 0;
      for (int r = 0; r < C; ++r) gz_out[((size_t)b * C + r) * npix + pix] = gz[r];
      float full[MAXC];
      for (int r = 0; r < C; ++r) full[r] = 0.0f;
      float t = 0.0f;
      if (pixel_active(p, b, pix)) {
        float px, py;
        pixel_center(p.image_size, pix, &px, &py);
        float dist[MAXF], zz[MAXF], mk[MAXF], prob[MAXF];
        float col0[MAXF], col1[MAXF], col2[MAXF];
        for (int i = 0; i < F; ++i) {
          float c3[3];
          face_forward(p, T, i, px, py, true, &dist[i], &zz[i], &mk[i], c3);
          col0[i] = c3[0]; col1[i] = c3[1]; col2[i] = c3[2];
          prob[i] = p.prob_ext[((size_t)b * F + i) * npix + pix];
        }
        float zinv[MAXF], zmap[MAXC], zmax_raw, gal;
        z_map_rows<MAXF, float>(p, T.sc, prob, zz, mk, zinv, &zmax_raw, &gal,
                                zmap);
        const float* go = p.extra + at * 4;
        const float g_rgb[3] = {go[0], go[1], go[2]};
        float gw[MAXC], wts[MAXC];
        blend_cotangent<MAXF, float>(p, T.sc, col0, col1, col2, g_rgb, gw);
        t = mc_agg_replay<MAXC, float>(p, T.sc, b, (uint32_t)pix, zmap, gw,
                                       first_max(zmap, C), false, true, wts,
                                       full);
      }
      term_full[at] = t;
      for (int r = 0; r < C; ++r)
        gz_full[((size_t)b * C + r) * npix + pix] = full[r];
    }
  }
}

Params params(const float* fv_ndc, const float* fv_world, const float* fn,
              const float* tex, const float* valid, const float* scal,
              const int* seeds, const float* prob, const float* g_out,
              float* w_out, int image_size, int f_pad, int bg_row,
              int c_zpad, int tex_d, int atlas_r, int rast_kind,
              int rast_noise, int rast_vr, int s_rast, int agg_kind,
              int agg_noise, int agg_vr, int s_agg, int k, float eps_bg,
              int phong, int point_light, int clip, int persp,
              const int* active, int nt, int p_tile, int tile_w) {
  Params p = {};
  p.fv_ndc = fv_ndc; p.fv_world = fv_world; p.fn = fn; p.tex = tex;
  p.valid = valid; p.scal = scal; p.seeds = seeds; p.prob_ext = prob;
  p.extra = g_out; p.w_out = w_out;
  set_config(p, image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r,
             rast_kind, rast_noise, rast_vr, s_rast, agg_kind, agg_noise,
             agg_vr, s_agg, k, eps_bg, phong, point_light, clip, persp);
  set_tiling(p, active, nt, p_tile, tile_w);
  return p;
}

#define PARAMS_ARGS                                                        \
  const float *fv_ndc, const float *fv_world, const float *fn,             \
      const float *tex, const float *valid, const float *scal,             \
      const int *seeds, const float *prob, const float *g_out, int n,      \
      int image_size, int f_pad, int bg_row, int c_zpad, int tex_d,        \
      int atlas_r, int rast_kind, int rast_noise, int rast_vr, int s_rast, \
      int agg_kind, int agg_noise, int agg_vr, int s_agg, int k,           \
      float eps_bg, int phong, int point_light, int clip, int persp,       \
      const int *active, int nt, int p_tile, int tile_w
#define PARAMS_CALL(w_out)                                                 \
  params(fv_ndc, fv_world, fn, tex, valid, scal, seeds, prob, g_out, w_out, \
         image_size, f_pad, bg_row, c_zpad, tex_d, atlas_r, rast_kind,      \
         rast_noise, rast_vr, s_rast, agg_kind, agg_noise, agg_vr, s_agg, k, \
         eps_bg, phong, point_light, clip, persp, active, nt, p_tile, tile_w)

extern "C" void host_flat(int mode, PARAMS_ARGS, float* out, float* w_out,
                          unsigned long long* counts, int* dirty) {
  Params p = PARAMS_CALL(w_out);
  const bool ext = prob != nullptr;
  // The card's slot buckets, each with its lanes per pixel and units per
  // lane (flat_warp.cuh's kGroup, kUnits).
  auto run = [&](auto bucket) {
    constexpr int M = decltype(bucket)::value;
    if (ext) flat_run<M, true>(p, n, mode, out, counts, dirty);
    else flat_run<M, false>(p, n, mode, out, counts, dirty);
  };
  if (f_pad <= 16) run(std::integral_constant<int, 16>());
  else if (f_pad <= 32) run(std::integral_constant<int, 32>());
  else if (f_pad <= 64) run(std::integral_constant<int, 64>());
  else run(std::integral_constant<int, 128>());
}

extern "C" void host_prob(int mode, PARAMS_ARGS, float* out,
                          unsigned long long* counts, int* dirty) {
  Params p = PARAMS_CALL(nullptr);
  if (f_pad <= 16) prob_run<16>(p, n, mode, out, counts, dirty);
  else if (f_pad <= 32) prob_run<32>(p, n, mode, out, counts, dirty);
  else if (f_pad <= 64) prob_run<64>(p, n, mode, out, counts, dirty);
  else prob_run<128>(p, n, mode, out, counts, dirty);
}

extern "C" void host_agg_bwd(PARAMS_ARGS, float* gz, float* term,
                             float* gz_full, float* term_full, int* certain) {
  Params p = PARAMS_CALL(nullptr);
  if (f_pad <= 16) agg_bwd_run<16>(p, n, gz, term, gz_full, term_full, certain);
  else agg_bwd_run<64>(p, n, gz, term, gz_full, term_full, certain);
}

// The aggregation rule on C rows of zmap (C <= 64): may[r] whether row r
// may reach a sample's max (agg_may_win), full[r] its >=-max count over S
// samples with every row drawn (pixel_forward's draws).
extern "C" void host_agg_rule(const float* zmap, int C, float gamma,
                              int noise, int S, uint32_t s0, uint32_t s1,
                              uint32_t pos, int* may, int* full) {
  const float gb = fabsf(gamma) * noise_bound(noise);
  const float lim = agg_lim(zmap, C, gb);
  for (int r = 0; r < C; ++r) {
    may[r] = agg_may_win(zmap[r], gb, lim) ? 1 : 0;
    full[r] = 0;
  }
  float nz[64];
  for (int s = 0; s < S; ++s) {
    draw_noise<64>(nz, C, noise, s0, s1, s, pos);
    float pert[64], mx = -INFINITY;
    for (int r = 0; r < C; ++r) {
      pert[r] = zmap[r] + gamma * nz[r];
      mx = fmaxf(mx, pert[r]);
    }
    for (int r = 0; r < C; ++r) full[r] += pert[r] >= mx ? 1 : 0;
  }
}

// The coverage rule on F rows of d (F <= 64): cert[i] cover_certain's
// verdict, full[i] the hits over S samples with every row drawn.
extern "C" void host_cover_rule(const float* d, int F, float sigma,
                                int noise, int S, uint32_t s0, uint32_t s1,
                                uint32_t pos, int* cert, int* full) {
  const float sb = fabsf(sigma) * noise_bound(noise);
  float nz[64];
  for (int i = 0; i < F; ++i) {
    cert[i] = cover_certain(d[i], sb);
    full[i] = 0;
  }
  for (int s = 0; s < S; ++s) {
    draw_noise<64>(nz, F, noise, s0, s1, s, pos);
    for (int i = 0; i < F; ++i) full[i] += -d[i] + sigma * nz[i] >= 0.0f;
  }
}
"""


@pytest.fixture(scope="module")
def flat_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None or platform.machine() != "x86_64":
        pytest.skip("needs g++ on x86-64 to emulate the warp's lanes")
    d = tmp_path_factory.mktemp("host_flat")
    (d / "stub.h").write_text(STUB)
    (d / "flat.cpp").write_text(HARNESS)
    so = d / "libhost_flat.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-include", str(d / "stub.h"), "-I", _build.CSRC,
                    str(d / "flat.cpp"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint32)
    args = [ptr] * 9 + [i32] * 16 + [f32] + [i32] * 4 + [ptr, i32, i32, i32]
    lib.host_flat.argtypes = [i32] + args + [ptr] * 4
    lib.host_prob.argtypes = [i32] + args + [ptr] * 3
    lib.host_agg_bwd.argtypes = args + [ptr] * 5
    lib.host_agg_rule.argtypes = [ptr, i32, f32, i32, i32, u32, u32, u32,
                                  ptr, ptr]
    lib.host_cover_rule.argtypes = [ptr, i32, f32, i32, i32, u32, u32, u32,
                                    ptr, ptr]
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def host_flat(lib, cfg, ins, mode, prob=None):
    """K3 on the host over the 8 kernel inputs: mode 0 the warp pipeline,
    1 pixel_forward.  Returns (image (N, H, W, 4), weights (N, C, P) or
    None, the warp pipeline's counts, whether it left a hit count)."""
    n, s = ins[0].shape[0], cfg.image_size
    out = torch.zeros(n, s * s, 4)
    w = torch.full((n, cfg.c_zpad, s * s), float("nan")) if prob is not None \
        else None
    counts = torch.zeros(8, dtype=torch.int64)
    dirty = torch.zeros(1, dtype=torch.int32)
    lib.host_flat(mode, *(t.data_ptr() for t in ins[:7]), _ptr(prob), None,
                  n, *tfr._cfg_args(cfg), ins[7].data_ptr(),
                  *tfr._tiling_args(cfg), out.data_ptr(), _ptr(w),
                  counts.data_ptr(), dirty.data_ptr())
    keys = ("pixels", "certain", "cover_full", "cover_drawn", "agg_full",
            "agg_drawn", "near", "weighted")
    return (out.reshape(n, s, s, 4), w, dict(zip(keys, counts.tolist())),
            bool(dirty.item()))


def _bits(a, b):
    """Equal bit for bit (NaN-free float32 tensors)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _active_pixels(cfg, active):
    """Pixels of the active tiles (fused_common.cuh's pixel_tile)."""
    s = cfg.image_size
    pix = torch.arange(s * s)
    if cfg.tile_w:
        th, ntx = cfg.p_tile // cfg.tile_w, s // cfg.tile_w
        tile = (pix // s // th) * ntx + (pix % s) // cfg.tile_w
    else:
        tile = pix // cfg.p_tile
    return int((active[:, tile] > 0).sum())


def _headline(noise, imsize, s, shift=None, gamma=1e-2, sigma=1e-3):
    mesh, rend = _renderer(noise, "cpu", imsize=imsize, sigma=sigma,
                           gamma=gamma, s=s)
    if shift is not None:
        mesh = mesh.offset_verts(torch.tensor(shift)
                                 .expand(mesh.verts.shape[1], 3))
    return _inputs(mesh, rend)


FLAT_CASES = [
    ("gaussian", 48, 8, None, 1e-2),
    ("gaussian", 48, 8, (0.0, 2.5, 0.0), 1e-2),     # an inactive tile
    ("gaussian_wovr", 48, 8, None, 1e-2),
    ("cauchy", 32, 8, None, 1e-2),
    ("gaussian", 32, 8, None, 5e-1),                # gamma B > the z_map gaps
    ("gaussian", 16, 96, None, 1e-2),               # S > 64
    ("gaussian", 21, 8, None, 1e-2),                # a warp half outside
    ("softras", 32, 8, None, 1e-2),
    ("hard", 32, 8, None, 1e-2),
    ("uniform", 32, 8, None, 1e-2),
]


@pytest.mark.parametrize("noise,imsize,s,shift,gamma", FLAT_CASES)
def test_flat_warp_forward_equals_pixel_forward_on_host(
        noise, imsize, s, shift, gamma, flat_lib):
    """The warp pipeline's image equals pixel_forward's bit for bit; its
    hit counts are back to zero; where the estimators are MC, some pixels
    drew nothing and some drew, and fewer units were drawn than the
    per-pixel pipeline draws."""
    cfg, ins = _headline(noise, imsize, s, shift, gamma)
    if shift is not None:
        assert 0 in ins[7].tolist()[0]
    got, _w, counts, dirty = host_flat(flat_lib, cfg, ins, 0)
    want = host_flat(flat_lib, cfg, ins, 1)[0]
    assert not dirty
    assert torch.isfinite(got).all()
    assert _bits(got, want), (got - want).abs().max()
    assert counts["pixels"] == _active_pixels(cfg, ins[7])
    # Geometry only inside the grown boxes; a weighted candidate had it.
    assert 0 < counts["near"] < counts["pixels"] * cfg.f_real
    assert 0 < counts["weighted"] <= counts["near"]
    if cfg.rast_kind == "mc":
        assert 0 < counts["certain"] < counts["pixels"]
        assert 0 < counts["cover_drawn"] < counts["cover_full"]
        assert 0 < counts["agg_drawn"] < counts["agg_full"]
    else:
        assert counts["certain"] == counts["pixels"]


@pytest.mark.parametrize("copies,f_pad", [(2, 32), (3, 40), (6, 80)])
def test_flat_warp_forward_ties_on_host(copies, f_pad, flat_lib):
    """Coincident faces (the cube's faces repeated: F = 32, 40 and 80, the
    32-, 64- and 128-slot buckets, 16 or 32 lanes a pixel, one or two
    units a lane) tie in depth and distance: several rows reach each
    sample's max, and the tied rows are all counted, as pixel_forward
    counts them."""
    from test_torch_cuda import _many_faces

    mesh, rend = _renderer("gaussian", "cpu", imsize=24, sigma=1e-3,
                           gamma=1e-2, s=8, k=128)
    cfg, ins = _inputs(*_many_faces(mesh, rend, copies))
    assert cfg.f_pad == f_pad and not cfg.stream
    got, _w, counts, dirty = host_flat(flat_lib, cfg, ins, 0)
    assert not dirty and counts["agg_drawn"] > 0
    assert _bits(got, host_flat(flat_lib, cfg, ins, 1)[0])


@pytest.mark.parametrize("imsize,shift", [(16, None), (48, (0.0, 2.5, 0.0))])
def test_flat_warp_forward_ext_equals_pixel_forward_on_host(imsize, shift,
                                                            flat_lib):
    """External coverage (the sharded route's K3) on shard 1's seed words
    with the plain group coverage: the image and the weights equal
    pixel_forward<..., EXT>'s bit for bit (the background one-hot on an
    inactive tile)."""
    cfg, ins = sharded_case("cpu", imsize, shift)
    cover = (ins[0], ins[4], ins[5], ins[6], ins[7])
    prob = tfr.prob_plain(cfg, *cover)
    img, w, counts, dirty = host_flat(flat_lib, cfg, ins, 0, prob)
    want_img, want_w, _c, _d = host_flat(flat_lib, cfg, ins, 1, prob)
    assert not dirty
    assert _bits(img, want_img) and _bits(w, want_w)
    assert counts["cover_full"] == 0 and counts["certain"] > 0


def host_prob(lib, cfg, ins, mode):
    """K11a on the host over the 8 kernel inputs: mode 0 the warp pipeline,
    1 pixel_prob.  Returns (coverage (N, F_pad, P), the warp pipeline's
    counts, whether it left a hit count)."""
    n, hw = ins[0].shape[0], cfg.image_size ** 2
    out = torch.full((n, cfg.f_pad, hw), float("nan"))
    counts = torch.zeros(8, dtype=torch.int64)
    dirty = torch.zeros(1, dtype=torch.int32)
    lib.host_prob(mode, *(t.data_ptr() for t in ins[:7]), None, None, n,
                  *tfr._cfg_args(cfg), ins[7].data_ptr(),
                  *tfr._tiling_args(cfg), out.data_ptr(), counts.data_ptr(),
                  dirty.data_ptr())
    keys = ("pixels", "certain", "cover_full", "cover_drawn", "agg_full",
            "agg_drawn", "near", "weighted")
    return out, dict(zip(keys, counts.tolist())), bool(dirty.item())


PROB_CASES = [
    ("sharded", 48, None),                          # the cube at 48^2
    ("sharded", 48, (0.0, 2.5, 0.0)),               # an inactive tile
    ("sharded-thin", 16, None),                     # nearly edge-on faces
    ("cauchy", 48, None),                           # the band: every row
    ("gaussian", 16, None),                         # S > 64
    ("softras", 32, None),                          # no draw
]


@pytest.mark.parametrize("case,imsize,shift", PROB_CASES)
def test_warp_prob_equals_pixel_prob_on_host(case, imsize, shift, flat_lib):
    """K11a's warp pipeline (warp_flat_prob: geometry only inside the grown
    boxes, draws only where a draw can change the mean, packed across the
    warp) equals the per-pixel pixel_prob bit for bit: the sharded cube on
    shard 1's seed words at 48^2 (also with an inactive tile), thin faces
    seen nearly edge-on (_slivers), Cauchy noise, S = 96 and softras's
    coverage; its hit counts are back to zero."""
    if case.startswith("sharded"):
        cfg, ins = sharded_case("cpu", imsize, shift)
        if case == "sharded-thin":
            ins = _slivers(cfg, ins)
    else:
        cfg, ins = _headline(case, imsize, 96 if case == "gaussian" else 8)
    got, counts, dirty = host_prob(flat_lib, cfg, ins, 0)
    want = host_prob(flat_lib, cfg, ins, 1)[0]
    assert not dirty and torch.isfinite(got).all()
    assert _bits(got, want), (got - want).abs().max()
    assert counts["pixels"] == _active_pixels(cfg, ins[7])
    assert 0 < counts["near"] < counts["pixels"] * cfg.f_real
    if cfg.rast_kind == "mc":
        assert 0 < counts["cover_drawn"] < counts["cover_full"]
        if case != "cauchy":
            assert 0 < counts["certain"] < counts["pixels"]
    else:
        assert counts["cover_full"] == 0
        assert counts["certain"] == counts["pixels"]
    if shift is not None:
        assert counts["pixels"] < ins[0].shape[0] * imsize ** 2


def host_agg_bwd(lib, cfg, ins, prob, g_out):
    n, hw, c = ins[0].shape[0], cfg.image_size ** 2, cfg.c_zpad
    gz, gz_full = torch.zeros(n, c, hw), torch.zeros(n, c, hw)
    term, term_full = torch.zeros(n, hw), torch.zeros(n, hw)
    certain = torch.zeros(n, hw, dtype=torch.int32)
    lib.host_agg_bwd(*(t.data_ptr() for t in ins[:7]), prob.data_ptr(),
                     g_out.data_ptr(), n, *tfr._cfg_args(cfg),
                     ins[7].data_ptr(), *tfr._tiling_args(cfg),
                     gz.data_ptr(), term.data_ptr(), gz_full.data_ptr(),
                     term_full.data_ptr(), certain.data_ptr())
    return gz, term, gz_full, term_full, certain.bool()


@pytest.mark.parametrize("imsize,shift,vr", [(16, None, True),
                                             (48, (0.0, 2.5, 0.0), True),
                                             (32, None, False)])
def test_agg_bwd_certain_exit_matches_full_replay_on_host(imsize, shift, vr,
                                                          flat_lib):
    """K11b's pixel pipeline against the full replay at every pixel: g_zmap
    equal up to the sign of zero, each pixel's gamma term equal.  Under
    variance reduction (the cube at sigma 1e-3 / gamma 1e-2) some pixels
    take the certain exit, each with a zero term; without it none does."""
    cfg, ins = sharded_case("cpu", imsize, shift)
    cfg = dataclasses.replace(cfg, agg_vr=vr)
    sc = ins[5].clone()
    sc[:, 31] = 1e-2                               # gamma, as the flagship
    ins = (*ins[:5], sc, *ins[6:])
    prob = tfr.prob_plain(cfg, ins[0], ins[4], ins[5], ins[6], ins[7])
    g_out = torch.randn(2, imsize, imsize, 4,
                        generator=torch.Generator().manual_seed(1))
    gz, term, gz_full, term_full, certain = host_agg_bwd(flat_lib, cfg, ins,
                                                         prob, g_out)
    assert torch.equal(gz, gz_full)                # +0 == -0
    assert torch.equal(term, term_full)
    if vr:
        assert certain.any() and not certain.all()
        assert (term[certain] == 0).all()
        assert (gz.transpose(1, 2)[certain] == 0).all()
    else:
        assert not certain.any()
    # And the plain version, as test_torch_kernel_host holds the pipeline.
    want_gz, want_gg = tfr.agg_bwd_plain(cfg, *ins, prob, g_out)
    assert (gz - want_gz).abs().max() <= 1e-3 * want_gz.abs().max()


def _inside_f32(v, px, py):
    """fused_common.cuh's inside test of the triangle v (3, 2) at the pixel
    centres (px, py), in float32 in the kernels' order."""
    f = np.float32
    (ax, ay), (bx, by), (cx, cy) = v.astype(f)
    inv = f(1) / ((bx - ax) * (cy - ay) - (by - ay) * (cx - ax))
    e0x, e0y = (cy - by) * inv, (cx - bx) * inv
    e1x, e1y = (ay - cy) * inv, (ax - cx) * inv
    w0 = e0y * py - e0x * px + (e0x * bx - e0y * by)
    w1 = e1y * py - e1x * px + (e1x * cx - e1y * cy)
    w2 = f(1) - w0 - w1
    return (w0 >= 0) & (w1 >= 0) & (w2 >= 0)


def _slivers(cfg, ins, count=4, seed=3):
    """ins with its first ``count`` faces made thin faces seen nearly
    edge-on, every tile active: each one float32 ulp thick along a row (or,
    every other one, a column) of pixel centres, 1e-9 to 1e-6 in area
    (depths kept).  Their barycentrics round by ~u L / h, so pixels well
    beyond a face's end along its row test inside; the function asserts
    that some pixel more than 0.4 (any blur band here) outside a face's
    bounding box does."""
    f = np.float32
    s = cfg.image_size
    j = np.arange(s, dtype=f)
    pc = (f(s) - f(1) - f(2) * j) / f(s)
    px, py = np.meshgrid(pc, pc)
    rng = np.random.default_rng(seed)
    ndc, valid = ins[0].clone(), ins[4].clone()
    far = 0
    for i in range(count):
        y = pc[rng.choice(np.flatnonzero(np.abs(pc) > 0.25))]
        y1 = np.nextafter(y, f(np.inf), dtype=f)
        xa, xc, xb = np.sort(rng.uniform(-0.9, 0.9, 3)).astype(f)
        v = np.array([[xa, y], [xb, y1], [xc, y1]], dtype=f)
        if i % 2:
            v = v[:, ::-1].copy()
        area = abs(float((v[1, 0] - v[0, 0]) * (v[2, 1] - v[0, 1])
                         - (v[1, 1] - v[0, 1]) * (v[2, 0] - v[0, 0]))) / 2
        assert 1e-9 <= area <= 1e-6, area
        ndc[:, i, [0, 1, 3, 4, 6, 7]] = torch.from_numpy(v.reshape(-1))
        valid[:, i] = 1.0
        lo, hi = v.min(0) - f(0.4), v.max(0) + f(0.4)
        out = (px < lo[0]) | (px > hi[0]) | (py < lo[1]) | (py > hi[1])
        far += int((_inside_f32(v, px, py) & out).sum())
    assert far > 0
    return (ndc, *ins[1:4], valid, *ins[5:7], torch.ones_like(ins[7]))


@pytest.mark.parametrize("mode", ["drawn", "ext"])
def test_flat_warp_forward_thin_faces_on_host(mode, flat_lib):
    """Thin faces seen nearly edge-on (_slivers), whose rounded
    barycentrics call pixels far outside their bounding boxes inside: the
    warp pipeline, which skips a face's geometry outside its grown box,
    still equals pixel_forward bit for bit (drawn coverage at 48^2, and
    external coverage on the sharded cube at 16^2, image and weights)."""
    if mode == "drawn":
        cfg, ins = _headline("gaussian", 48, 8)
        prob = None
    else:
        cfg, ins = sharded_case("cpu", 16)
    ins = _slivers(cfg, ins)
    if mode == "ext":
        prob = tfr.prob_plain(cfg, ins[0], ins[4], ins[5], ins[6], ins[7])
    img, w, counts, dirty = host_flat(flat_lib, cfg, ins, 0, prob)
    want_img, want_w, _c, _d = host_flat(flat_lib, cfg, ins, 1, prob)
    assert not dirty and torch.isfinite(img).all()
    assert _bits(img, want_img), (img - want_img).abs().max()
    if mode == "ext":
        assert _bits(w, want_w)


def test_agg_bwd_thin_faces_on_host(flat_lib):
    """K11b's pixel pipeline with the thin faces of _slivers on the
    sharded cube at 16^2: g_zmap equal to the full replay's up to the sign
    of zero, each pixel's gamma term equal."""
    cfg, ins = sharded_case("cpu", 16)
    ins = _slivers(cfg, ins)
    prob = tfr.prob_plain(cfg, ins[0], ins[4], ins[5], ins[6], ins[7])
    g_out = torch.randn(2, 16, 16, 4,
                        generator=torch.Generator().manual_seed(1))
    gz, term, gz_full, term_full, _certain = host_agg_bwd(flat_lib, cfg, ins,
                                                          prob, g_out)
    assert torch.equal(gz, gz_full)                # +0 == -0
    assert torch.equal(term, term_full)


def _ulps(x, k):
    """x moved k float32 ulps (towards +inf for k > 0)."""
    x = np.float32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else -np.inf),
                         dtype=np.float32)
    return np.float32(x)


BOUNDS = {1: 5.78, 2: 1e7}                 # hash_prng.cuh: gaussian, cauchy


@settings(max_examples=60, deadline=None)
@given(gamma=st.sampled_from([1e-2, 5e-2, 3e-3, 0.5]),
       noise=st.sampled_from([1, 2]),
       top=st.floats(-1.0, 0.0, width=32),
       k=st.integers(-1, 1), rows=st.integers(2, 24),
       seed=st.integers(0, 2 ** 31 - 1))
def test_certainty_rules_at_the_bound(flat_lib, gamma, noise, top, k, rows,
                                      seed):
    """Rows z_map gaps of exactly fl(2 |gamma| B), one ulp either side
    (and -inf padding), and coverage distances of fl(|sigma| B) one ulp
    either side: a row the aggregation rule rules out never reaches a
    sample's max over every draw, a row the rule leaves alone takes every
    sample, and a candidate the coverage rule calls certain hits in every
    sample or none, over S = 64 samples of the counter hash."""
    g32 = np.float32(gamma)
    gb = np.float32(np.abs(g32) * np.float32(BOUNDS[noise]))
    gap = _ulps(np.float32(gb + gb), k)
    z = np.full(rows + rows % 2, -np.inf, dtype=np.float32)
    z[0] = np.float32(top)
    z[1] = np.float32(z[0] - gap)
    rng = np.random.default_rng(seed)
    for r in range(2, rows):
        z[r] = np.float32(z[1] - np.float32(rng.uniform(0.0, 3.0)) * gb)
    c = z.shape[0]
    may = np.zeros(c, dtype=np.int32)
    full = np.zeros(c, dtype=np.int32)
    s0, s1, pos = (int(v) for v in rng.integers(0, 2 ** 32, 3))
    flat_lib.host_agg_rule(z.ctypes.data, c, float(g32), noise, 64, s0, s1,
                           pos, may.ctypes.data, full.ctypes.data)
    assert may[0] == 1
    assert (full[may == 0] == 0).all(), (z, may, full)
    if may.sum() == 1:
        assert full[0] == 64

    sigma = np.float32(gamma / 10)
    sb = np.float32(np.abs(sigma) * np.float32(BOUNDS[noise]))
    d = np.array([_ulps(sb, k), _ulps(-sb, k), 0.0, _ulps(sb, -k),
                  _ulps(-sb, -k), np.float32(top) * sb, 2 * sb, -2 * sb],
                 dtype=np.float32)
    cert = np.zeros(8, dtype=np.int32)
    full = np.zeros(8, dtype=np.int32)
    flat_lib.host_cover_rule(d.ctypes.data, 8, float(sigma), noise, 64, s0,
                             s1, pos, cert.ctypes.data, full.ctypes.data)
    assert (full[cert == 1] == 64).all() and (full[cert == -1] == 0).all()
    assert cert[6] == -1 and cert[7] == 1
