"""The port's Monte-Carlo estimators on its own hash draws against the
PyTorch reference's expectations (tests/goldens/reference_goldens.npz,
recorded from the reference's modules with 16.8M samples).

The draws are the kernels' own: ``csrc/perturbed.cu`` compiled for the CPU
(CUDA keywords defined away), whose ``draw`` and ``score`` a host loop
calls at the same sample count as tests/test_reference_goldens.py (4.2M
per element, S = 2**22 of one stream instead of 64 samples of 65536
replicas) and at its tolerances: forwards atol 1e-3; perturbed Heaviside
grad_dists atol 2.5e-3 and grad_sigma rtol 3e-3; perturbed argmax grad_z
atol 4e-3 and grad_gamma rtol 2e-3; the GaussianAgg chain (the port's
z_map preamble in torch, its backward by autograd) grad_zbuf atol 1e-4,
grad_gamma rtol 2e-3, grad_alpha atol 6e-3.  The chain's grad_prob is not
held to its golden: at one element (index 18, prob 0.073, golden 0.1190,
tolerance 0.0045) an estimate from 4.2M samples of another stream has a
standard deviation of 0.0053, and 50M samples over 12 seed pairs put the
mean at 0.1227, so the golden's own sampling error leaves no stream a
fair chance there (6 of 12 seed pairs miss at 4.2M samples, 2 of 3 groups
at 16.8M); the JAX test's tolerance was fitted to its own stream.  The
loop sums each sample's float32 terms in double over four threads.  The
estimators' arithmetic is held against the JAX package on shared noise in
tests/test_torch_perturbed.py.  Last, the kernels' per-element and
per-pixel functions, run by a host loop, against the plain versions on
the same seeds.  Skips where no g++ is installed.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pertrenderer_tpu_torch import _build
from pertrenderer_tpu_torch.models.smoothagg import _z_map
from test_torch_kernel_host import FIBERS, STUB

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "reference_goldens.npz")
S = 2 ** 22                    # tests/test_reference_goldens.py: B * S
THREADS = 4
SEEDS = np.array([[123456789, -987654321]], np.int32)
FAMILY = {"gaussian": 0, "cauchy": 1}

HARNESS = FIBERS + r"""
#include <thread>
#include "perturbed.cu"
using namespace ptk;

template <class F>
static void parallel(int n, int threads, F f) {
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([=] { for (int i = t; i < n; i += threads) f(i); });
  for (auto& th : pool) th.join();
}

// K8a's sums at each element e = p * C + c: mean of H(d + sigma Z), and
// the coefficient with (vr) and without the H(d) baseline.
extern "C" void mc_heaviside(const float* d, float sigma, const int* seeds,
                             int P, int C, long long S, int fam,
                             double* mean, double* cvr, double* cwo,
                             int threads) {
  parallel(P * C, threads, [=](int e) {
    const int p = e / C, c = e % C;
    const float h0 = d[e] >= 0.0f ? 1.0f : 0.0f;
    double a = 0.0, b = 0.0, w = 0.0;
    for (long long s = 0; s < S; ++s) {
      const float z = draw(fam, seeds[0], seeds[1], (int)s, c, p);
      const float h = d[e] + sigma * z >= 0.0f ? 1.0f : 0.0f;
      const float sc = score(z, fam);
      a += h;
      b += (h - h0) * sc;
      w += h * sc;
    }
    mean[e] = a / S;
    cvr[e] = b / (S * (double)sigma);
    cwo[e] = w / (S * (double)sigma);
  });
}

// K8b / K8c's sums at each pixel (C <= 64): the mean >=-max one-hot,
// grad_z and the gamma term of the cotangent g, with the first-wins
// baseline.
extern "C" void mc_argmax(const float* z, const float* g, float gamma,
                          const int* seeds, int P, int C, long long S,
                          int fam, double* fwd, double* gz, double* gterm,
                          int threads) {
  parallel(P, threads, [=](int p) {
    const float* zp = z + p * C;
    const float* gp = g + p * C;
    int w0 = 0;
    for (int c = 1; c < C; ++c)
      if (zp[c] > zp[w0]) w0 = c;
    double f[64] = {0.0}, a[64] = {0.0}, gt = 0.0;
    float e[64];
    for (long long s = 0; s < S; ++s) {
      float m = -INFINITY;
      for (int c = 0; c < C; ++c) {
        e[c] = draw(fam, seeds[0], seeds[1], (int)s, c, p);
        const float v = zp[c] + gamma * e[c];
        m = v > m ? v : m;
      }
      float dot = 0.0f, phi = 0.0f;
      for (int c = 0; c < C; ++c) {
        const float w = zp[c] + gamma * e[c] >= m ? 1.0f : 0.0f;
        f[c] += w;
        dot += gp[c] * (w - (c == w0 ? 1.0f : 0.0f));
        phi += fam == 0 ? e[c] * e[c] : score(e[c], fam) * e[c];
      }
      for (int c = 0; c < C; ++c) a[c] += dot * score(e[c], fam);
      gt += dot * (phi - 1.0f);
    }
    for (int c = 0; c < C; ++c) {
      fwd[p * C + c] = f[c] / S;
      gz[p * C + c] = a[c] / (S * (double)gamma);
    }
    gterm[p] = gt / (S * (double)gamma);
  });
}

// K8c's warp function at one pixel with its 32 lanes on fibers, at the
// card's channels per lane (ceil(C / 32) rounded up to 1, 2, 3, 4, 8, 16;
// argmax_grads_wide above 512 channels).
template <int J>
static float grads_warp(Lanes& L, const float* z, const float* g, float* gz,
                        float gamma, uint32_t s0, uint32_t s1, uint32_t p,
                        int C, int S, int fam, bool vr) {
  float t = 0.0f;
  L.run([&](int lane) {
    HostWarp w{lane, &L};
    const float v = argmax_grads_warp<J>(w, z, g, gz, gamma, s0, s1, p, C,
                                         S, fam, vr);
    if (lane == 0) t = v;
  });
  return t;
}

static float grads_pixel(Lanes& L, const float* z, const float* g,
                         float* gz, float gamma, uint32_t s0, uint32_t s1,
                         uint32_t p, int C, int S, int fam, bool vr) {
  const int J = (C + 31) / 32;
  if (J <= 1) return grads_warp<1>(L, z, g, gz, gamma, s0, s1, p, C, S, fam, vr);
  if (J == 2) return grads_warp<2>(L, z, g, gz, gamma, s0, s1, p, C, S, fam, vr);
  if (J == 3) return grads_warp<3>(L, z, g, gz, gamma, s0, s1, p, C, S, fam, vr);
  if (J == 4) return grads_warp<4>(L, z, g, gz, gamma, s0, s1, p, C, S, fam, vr);
  if (J <= 8) return grads_warp<8>(L, z, g, gz, gamma, s0, s1, p, C, S, fam, vr);
  if (J <= 16) return grads_warp<16>(L, z, g, gz, gamma, s0, s1, p, C, S, fam, vr);
  float t = 0.0f;
  L.run([&](int lane) {
    HostWarp w{lane, &L};
    const float v = argmax_grads_wide(w, z, g, gz, gamma, s0, s1, p, C, S,
                                      fam, vr);
    if (lane == 0) t = v;
  });
  return t;
}

// The kernels' own warp functions over an (N, P, C) input, the 32 lanes
// on fibers: which 0 heaviside mean, 1 its coefficient (K8a's strips of
// kStripLines 32-element lines over the flat input, their element indices
// split with 32-bit and 64-bit division in turn), 2 argmax mean (K8b), 3
// argmax grads (K8c; out2: the gamma term per pixel).
extern "C" void host_k8(int which, const float* x, const float* g,
                        float scale, const int* seeds, float* out,
                        float* out2, int n, int P, int C, int S, int fam,
                        int vr) {
  Lanes L;
  if (which < 2) {
    const long long total = (long long)n * P * C, strip = 32ll * kStripLines;
    for (long long e0 = 0; e0 < total; e0 += strip)
      for (int lane = 0; lane < 32; ++lane)
        heaviside_strip(lane, which, x, out, scale, seeds, e0,
                        std::min(total, e0 + strip), P, C, S, fam, vr != 0,
                        (e0 / strip) % 2 == 0);
    return;
  }
  int list[32];
  for (int b = 0; b < n; ++b)
    for (int p = 0; p < P; ++p) {
      const size_t q = (size_t)b * P + p;
      const uint32_t s0 = seeds[2 * b], s1 = seeds[2 * b + 1];
      if (which == 2) {
        L.run([&](int lane) {
          HostWarp w{lane, &L};
          argmax_mean_warp(w, x + q * C, out + q * C, scale, s0, s1, p, C, S,
                           fam, list);
        });
      } else {
        out2[q] = grads_pixel(L, x + q * C, g + q * C, out + q * C, scale,
                              s0, s1, p, C, S, fam, vr != 0);
      }
    }
}

// The largest |value| of a family's map over every 23-bit uniform
// (gaussian: the Box-Muller radius, which bounds both halves), and the
// kernels' bound for it.
extern "C" void draw_extent(int fam, float* max_abs, float* bound) {
  float m = 0.0f;
  for (uint32_t k = 0; k < (1u << 23); ++k) {
    const float u = ptt::uniform01(k);
    const float v = fam == ptt::kFamGaussian ? ptt::gaussian_radius(u)
                                             : ptt::uniform_value(fam, u);
    m = std::max(m, std::fabs(v));
  }
  *max_abs = m;
  *bound = ptt::family_bound(fam);
}
"""


@pytest.fixture(scope="module")
def G():
    return np.load(GOLDENS)


@pytest.fixture(scope="module")
def host_mc(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the estimators' draws for the CPU")
    d = tmp_path_factory.mktemp("host_mc")
    (d / "stub.h").write_text(STUB)
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libhost_mc.so"
    subprocess.run([gxx, "-O2", "-fno-math-errno", "-std=c++17", "-shared",
                    "-fPIC", "-pthread", "-include", str(d / "stub.h"),
                    "-I", _build.CSRC, str(d / "harness.cpp"), "-o",
                    str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mc_heaviside.argtypes = ([ptr, f32, ptr, i32, i32, ctypes.c_longlong,
                                  i32] + [ptr] * 3 + [i32])
    lib.mc_argmax.argtypes = ([ptr, ptr, f32, ptr, i32, i32,
                               ctypes.c_longlong, i32] + [ptr] * 3 + [i32])
    lib.host_k8.argtypes = [i32, ptr, ptr, f32] + [ptr] * 3 + [i32] * 6
    lib.draw_extent.argtypes = [i32, ptr, ptr]
    return lib


def _f32(x):
    return np.ascontiguousarray(x, np.float32)


_cache = {}


def heaviside_sums(lib, G, noise):
    """(mean, vr coefficient, plain coefficient) of the perturbed
    Heaviside of -dists, each (1, 4, 4, 5)."""
    if noise not in _cache:
        d = _f32(-G["dists"])
        shape = d.shape
        out = [np.zeros(d.size) for _ in range(3)]
        lib.mc_heaviside(d.ctypes.data, float(G["sigma"]), SEEDS.ctypes.data,
                         d.size // shape[-1], shape[-1], S, FAMILY[noise],
                         *(o.ctypes.data for o in out), THREADS)
        _cache[noise] = [o.reshape(shape) for o in out]
    return _cache[noise]


def argmax_sums(lib, z, g, gamma, noise):
    """(mean one-hot, grad_z, gamma term per pixel) of the perturbed
    argmax of z (..., C) for the cotangent g."""
    z, g = _f32(z), _f32(g)
    c = z.shape[-1]
    fwd, gz = np.zeros(z.size), np.zeros(z.size)
    gterm = np.zeros(z.size // c)
    lib.mc_argmax(z.ctypes.data, g.ctypes.data, float(gamma),
                  SEEDS.ctypes.data, z.size // c, c, S, FAMILY[noise],
                  fwd.ctypes.data, gz.ctypes.data, gterm.ctypes.data,
                  THREADS)
    return fwd.reshape(z.shape), gz.reshape(z.shape), gterm


@pytest.mark.parametrize("noise,vr,tag", [
    ("gaussian", True, "gaussianrast"),
    ("gaussian", False, "gaussianrast_wovr"),
    ("cauchy", True, "arctanrast"),
])
def test_port_heaviside_draws_match_reference(G, host_mc, noise, vr, tag):
    mean, cvr, cwo = heaviside_sums(host_mc, G, noise)
    coeff = cvr if vr else cwo
    w = G["w"]
    # loss = sum(perturbed_heaviside(-dists) * w): grad_dists = -coeff w,
    # grad_sigma = sum(coeff w) (the reference's overwrite).
    np.testing.assert_allclose(mean, G[f"{tag}_fwd"], atol=1e-3)
    np.testing.assert_allclose(-coeff * w, G[f"{tag}_grad_dists"],
                               atol=2.5e-3)
    np.testing.assert_allclose(np.sum(coeff * w),
                               float(G[f"{tag}_grad_sigma"]), rtol=3e-3)


@pytest.mark.parametrize("noise,tag", [("gaussian", "argmax_gaussian"),
                                       ("cauchy", "argmax_cauchy")])
def test_port_argmax_draws_match_reference(G, host_mc, noise, tag):
    fwd, gz, gterm = argmax_sums(host_mc, G["z"], G["wagg"], G["gamma"],
                                 noise)
    np.testing.assert_allclose(fwd, G[f"{tag}_fwd"], atol=1e-3)
    np.testing.assert_allclose(gz, G[f"{tag}_grad_z"], atol=4e-3)
    np.testing.assert_allclose(gterm.sum(), float(G[f"{tag}_grad_gamma"]),
                               rtol=2e-3)


def test_port_gaussianagg_chain_matches_reference(G, host_mc):
    """The whole aggregate: the port's z_map preamble (log_corrected,
    prod_corrected, the background channel), the perturbed argmax on the
    port's draws, and the gradients to zbuf, gamma and alpha (grad_prob:
    see the module docstring)."""
    t = lambda k: torch.from_numpy(_f32(G[k])).requires_grad_()
    zbuf, prob = t("zbuf"), t("prob")
    gamma = torch.tensor(float(G["agg_gamma"]), requires_grad=True)
    alpha = torch.tensor(float(G["agg_alpha"]), requires_grad=True)
    mask = torch.from_numpy(np.asarray(G["mask"]) > 0)
    z_map = _z_map(gamma, alpha, 1e-10, zbuf, float(G["zfar"]),
                   float(G["znear"]), prob, mask)
    fwd, gz, gterm = argmax_sums(host_mc, z_map.detach().numpy(),
                                 G["wagg"], float(G["agg_gamma"]),
                                 "gaussian")
    g_zbuf, g_gamma, g_alpha = torch.autograd.grad(
        z_map, [zbuf, gamma, alpha], torch.from_numpy(_f32(gz)))
    np.testing.assert_allclose(fwd, G["gaussianagg_fwd"], atol=1e-3)
    np.testing.assert_allclose(g_zbuf.numpy(), G["gaussianagg_grad_zbuf"],
                               atol=1e-4)
    np.testing.assert_allclose(g_gamma.item() + gterm.sum(),
                               float(G["gaussianagg_grad_gamma"]), rtol=2e-3)
    np.testing.assert_allclose(g_alpha.item(),
                               float(G["gaussianagg_grad_alpha"]), atol=6e-3)


@pytest.mark.parametrize("noise,vr", [
    ("gaussian", True), ("gaussian", False), ("cauchy", True),
    ("logistic", True), ("gumbel", True), ("uniform", True)])
def test_kernel_functions_match_plain_on_host(host_mc, noise, vr):
    """K8a-c's warp functions (what each warp of the kernels runs) against
    the plain versions on the same seeds: forwards within
    the MC tolerance of the card (mean |d| <= 1e-5, 99.9% within 1e-4:
    g++'s libm and torch round log / cos / tan apart in the last place, so
    a threshold may flip), gradients within 1e-3 of their max |grad|; a
    pixel of exact ties counts every tied channel in both."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    rng = np.random.default_rng(9)
    n, p, c, s = 2, 40, 7, 16
    d = torch.from_numpy((rng.standard_normal((n, p, c)) * 0.02)
                         .astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((n, p, c)).astype(np.float32))
    z[0, 0] = 0.5
    g = torch.from_numpy(rng.standard_normal((n, p, c)).astype(np.float32))
    seeds = torch.tensor([[21, -22], [23, 24]], dtype=torch.int32)
    sigma, gamma = 1e-2, 0.5
    fam = pk.NOISE_IDS[noise]

    def host(which, x, scale):
        out, out2 = torch.zeros(n, p, c), torch.zeros(n, p)
        host_mc.host_k8(which, x.data_ptr(), g.data_ptr(), scale,
                        seeds.data_ptr(), out.data_ptr(), out2.data_ptr(), n,
                        p, c, s, fam, int(vr))
        return out, out2

    def mc_close(got, want):
        dd = (got - want).abs()
        assert dd.mean() <= 1e-5 and (dd <= 1e-4).float().mean() >= 0.999

    ts, tg = torch.tensor(sigma), torch.tensor(gamma)
    mc_close(host(0, d, sigma)[0],
             pk.heaviside_mean_plain(d, ts, seeds, s, noise))
    mc_close(host(2, z, gamma)[0],
             pk.argmax_mean_plain(z, tg, seeds, s, noise))
    tied = host(2, z, gamma)[0][0, 0]
    assert tied.sum() >= 1.0 and torch.equal(
        tied, pk.argmax_mean_plain(z, tg, seeds, s, noise)[0, 0])
    if noise not in pk.GRAD_NOISES:
        return
    for got, want in (
            (host(1, d, sigma)[0],
             pk.heaviside_coeff_plain(d, ts, seeds, s, noise, vr)),
            *zip(host(3, z, gamma),
                 pk.argmax_grads_plain(z, g, tg, seeds, s, noise, vr))):
        err = (got - want).abs().max() / want.abs().max()
        assert torch.isfinite(got).all() and err <= 1e-3, err


@pytest.mark.parametrize("c,s", [(7, 3), (51, 8), (70, 13)])
@pytest.mark.parametrize("noise,vr", [
    ("gaussian", True), ("gaussian", False), ("cauchy", True),
    ("cauchy", False)])
def test_k8c_warp_matches_plain_on_host(host_mc, noise, vr, c, s):
    """K8c's warp function (a pixel's channels across the 32 emulated
    lanes: ceil(C / 32) = 1, 2, 3 channels per lane; S below, at twice and
    above three times the sample batch, with a ragged last batch) against
    ``argmax_grads_plain`` on the same seeds: grad_z and the gamma term
    within 1e-3 of their max |grad|.  Pixel 0 has every channel tied and
    pixel 1 two channels tied at its max, so the first-wins baseline and
    the >=-max one-hots meet exact ties."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    rng = np.random.default_rng(11)
    n, p = 2, 12
    z = torch.from_numpy(rng.standard_normal((n, p, c)).astype(np.float32))
    z[:, 0] = 0.25
    z[:, 1, c // 3] = z[:, 1, c - 2] = z[:, 1].max() + 1.0
    g = torch.from_numpy(rng.standard_normal((n, p, c)).astype(np.float32))
    seeds = torch.tensor([[31, -32], [33, 34]], dtype=torch.int32)
    gamma = 0.5
    gz, gterm = torch.zeros(n, p, c), torch.zeros(n, p)
    host_mc.host_k8(3, z.data_ptr(), g.data_ptr(), gamma, seeds.data_ptr(),
                    gz.data_ptr(), gterm.data_ptr(), n, p, c, s,
                    pk.NOISE_IDS[noise], int(vr))
    want = pk.argmax_grads_plain(z, g, torch.tensor(gamma), seeds, s, noise,
                                 vr)
    for got, w in zip((gz, gterm), want):
        err = (got - w).abs().max() / w.abs().max()
        assert torch.isfinite(got).all() and err <= 1e-3, err


def host_run(lib, which, x, scale, seeds, s, noise, vr=True, g=None):
    """(out, out2) of ``host_k8`` on x (N, P, C)."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    n, p, c = x.shape
    g = torch.zeros_like(x) if g is None else g
    out, out2 = torch.full_like(x, float("nan")), torch.zeros(n, p)
    lib.host_k8(which, x.data_ptr(), g.data_ptr(), scale, seeds.data_ptr(),
                out.data_ptr(), out2.data_ptr(), n, p, c, s,
                pk.NOISE_IDS[noise], int(vr))
    return out, out2


def assert_mc_close(got, want):
    """The card's MC forward tolerance (see
    test_kernel_functions_match_plain_on_host)."""
    d = (got - want).abs()
    assert torch.isfinite(got).all()
    assert d.mean() <= 1e-5 and (d <= 1e-4).float().mean() >= 0.999, d.max()


@pytest.mark.parametrize("noise", ["gaussian", "cauchy", "logistic",
                                   "gumbel", "uniform"])
def test_draw_bounds_hold_for_every_uniform(host_mc, noise):
    """Every family's map over all 2^23 uniforms the hash can give stays
    strictly below the bound that K8a / K8b (and K12, gaussian) prune by
    (cauchy's is its clamp, which holds on any libm), and the Python table
    (``NOISE_BOUNDS``) is the kernels' own."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    m, b = ctypes.c_float(), ctypes.c_float()
    host_mc.draw_extent(pk.NOISE_IDS[noise], ctypes.byref(m),
                        ctypes.byref(b))
    assert b.value == np.float32(pk.NOISE_BOUNDS[noise])
    assert 0.0 < m.value < b.value


def _argmax_scene(rng, n, p, c, gamma, noise):
    """z (n, p, c): pixels of every kind K8b meets, at the spread of its
    family's bound gb = |gamma| B: one candidate far above the rest; a few
    within gb of the top; -inf (masked) channels; every channel -inf; 40
    and 150 channels near the top where c allows."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    gb = abs(gamma) * pk.NOISE_BOUNDS[noise]
    z = rng.standard_normal((n, p, c)) * 20.0 * gb
    z[:, 0] = -np.inf
    z[:, 0, 0] = 1.0                                  # one finite channel
    z[:, 1] = -np.inf                                 # every channel masked
    z[:, 2, c // 2] = z[:, 2].max() + 10.0 * gb       # one far above
    z[:, 3, :5] = z[:, 3].max() + rng.random((n, 5)) * gb   # a few near
    z[:, 4, 1::2] = -np.inf
    for q, k in ((5, 40), (6, 150)):                  # > 32, > 128 near
        if c >= k:
            z[:, q, :k] = (z[:, q].max(-1, keepdims=True) + 1.0
                           + rng.random((n, k)) * gb)
    return torch.from_numpy(z.astype(np.float32))


@pytest.mark.parametrize("c,noise", [
    (7, "gaussian"), (51, "gaussian"), (51, "cauchy"), (51, "logistic"),
    (51, "gumbel"), (51, "uniform"), (70, "gaussian"), (200, "gaussian"),
    (200, "uniform")])
def test_k8b_warp_matches_plain_on_host(host_mc, c, noise):
    """K8b's warp function (32 emulated lanes) against
    ``argmax_mean_plain``: every channel outside the candidates
    (``argmax_candidates``) and every channel of a pixel with one candidate
    bit-equal; the rest within the MC tolerance on shared noise.  The
    scene has single-candidate pixels, -inf channels, a pixel with every
    channel -inf, and (C = 70, 200) 40 and 150 channels near the top,
    more than a warp's lanes, which take the layout over the lane's own
    channels."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    rng = np.random.default_rng(13)
    n, p, s, gamma = 2, 24, 8, 0.05
    z = _argmax_scene(rng, n, p, c, gamma, noise)
    seeds = torch.tensor([[41, -42], [43, 44]], dtype=torch.int32)
    got = host_run(host_mc, 2, z, gamma, seeds, s, noise)[0]
    want = pk.argmax_mean_plain(z, torch.tensor(gamma), seeds, s, noise)
    cand = pk.argmax_candidates(z, torch.tensor(gamma), noise)
    single = (cand.sum(-1, keepdim=True) == 1).expand_as(cand)
    exact = ~cand | single
    assert torch.equal(got[exact], want[exact])
    assert_mc_close(got, want)
    assert (cand.sum(-1) == 1).any() and (cand.sum(-1) > 1).any()
    if c >= 150:
        assert cand[:, 5].sum(-1).min() > 32 and cand[:, 6].sum(-1).min() > 128


def test_k8b_warp_counts_every_tied_channel_on_host(host_mc):
    """An exact tie at the max: at gamma 1e-12 every perturbed value
    rounds back to z, the tied channels are the candidates and every one
    of them reaches every sample's max (1.0 each), as in the plain
    version."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    z = torch.zeros(1, 3, 9)
    z[0, 0, [1, 4, 7]] = 1.0
    z[0, 1, :] = 2.0
    z[0, 2, [0, 8]] = -1.0
    seeds = torch.tensor([[5, 6]], dtype=torch.int32)
    got = host_run(host_mc, 2, z, 1e-12, seeds, 8, "gaussian")[0]
    want = pk.argmax_mean_plain(z, torch.tensor(1e-12), seeds, 8, "gaussian")
    assert torch.equal(got, want)
    assert torch.equal(got[0, 0], (z[0, 0] == 1.0).float())
    assert torch.equal(got[0, 1], torch.ones(9))


def _band_scene(rng, n, p, c, sigma, noise):
    """d (n, p, c): random in and around the band |d| <= sb = fl(|sigma|
    B) (within 12 sigma for cauchy), the elements one ulp either side of
    +-sb, empty slots at +1 and -1, and a dense run of band elements (whole
    lines drawn)."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    sb = np.float32(abs(sigma)) * np.float32(pk.NOISE_BOUNDS[noise])
    spread = min(float(sb), 6.0 * sigma)      # cauchy's band is 1e7 sigma
    d = (rng.standard_normal((n, p, c)) * 2.0 * spread).astype(np.float32)
    edge = np.array([sb, -sb], np.float32)
    ulps = np.concatenate([np.nextafter(edge, np.float32(np.inf)),
                           np.nextafter(edge, np.float32(-np.inf)), edge])
    flat = d.reshape(-1)
    flat[:ulps.size] = ulps
    flat[ulps.size:ulps.size + 40] = 1.0
    flat[ulps.size + 40:ulps.size + 50] = -1.0
    flat[200:300] = (rng.random(100) - 0.5) * spread
    return torch.from_numpy(d)


@pytest.mark.parametrize("noise,vr", [
    ("gaussian", True), ("gaussian", False), ("cauchy", True),
    ("cauchy", False), ("uniform", True), ("logistic", True)])
def test_k8a_strip_matches_plain_on_host(host_mc, noise, vr):
    """K8a's strip function (its 32 lanes in turn, strips of 4 lines
    crossing pixels and batch elements) against both plain versions, with elements
    one ulp inside and outside +-sigma B: outside the band
    (``heaviside_band``) bit-equal; inside, the mean within the MC
    tolerance and the coefficient within 1e-3 of its max; variance
    reduction on and off."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    rng = np.random.default_rng(17)
    n, p, c, s, sigma = 2, 30, 11, 8, 1e-2
    d = _band_scene(rng, n, p, c, sigma, noise)
    seeds = torch.tensor([[51, -52], [53, 54]], dtype=torch.int32)
    ts = torch.tensor(sigma)
    band = pk.heaviside_band(d, ts, noise)
    assert band.any() and (~band).any()
    got = host_run(host_mc, 0, d, sigma, seeds, s, noise)[0]
    want = pk.heaviside_mean_plain(d, ts, seeds, s, noise)
    assert torch.equal(got[~band], want[~band])
    assert_mc_close(got, want)
    if noise not in pk.GRAD_NOISES:
        return
    got = host_run(host_mc, 1, d, sigma, seeds, s, noise, vr)[0]
    want = pk.heaviside_coeff_plain(d, ts, seeds, s, noise, vr)
    drawn = pk.heaviside_band(d, ts, noise, draw_above=not vr)
    assert torch.equal(got[~drawn], want[~drawn])
    err = (got - want).abs().max() / want.abs().max()
    assert torch.isfinite(got).all() and err <= 1e-3, err


@pytest.mark.parametrize("noise,vr", [("gaussian", True),
                                      ("cauchy", False)])
def test_k8c_wide_matches_plain_on_host(host_mc, noise, vr):
    """K8c above 16 channels per lane (C = 600, argmax_grads_wide) against
    ``argmax_grads_plain``: grad_z and the gamma term within 1e-3 of their
    max |grad|."""
    from pertrenderer_tpu_torch.ops import perturbed_kernels as pk

    rng = np.random.default_rng(19)
    n, p, c, s, gamma = 1, 3, 600, 5, 0.5
    z = torch.from_numpy(rng.standard_normal((n, p, c)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, p, c)).astype(np.float32))
    seeds = torch.tensor([[61, -62]], dtype=torch.int32)
    got = host_run(host_mc, 3, z, gamma, seeds, s, noise, vr, g=g)
    want = pk.argmax_grads_plain(z, g, torch.tensor(gamma), seeds, s, noise,
                                 vr)
    for a, b in zip(got, want):
        err = (a - b).abs().max() / b.abs().max()
        assert torch.isfinite(a).all() and err <= 1e-3, err
