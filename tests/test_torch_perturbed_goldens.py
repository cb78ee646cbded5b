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
from test_torch_kernel_host import STUB

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "reference_goldens.npz")
S = 2 ** 22                    # tests/test_reference_goldens.py: B * S
THREADS = 4
SEEDS = np.array([[123456789, -987654321]], np.int32)
FAMILY = {"gaussian": 0, "cauchy": 1}

HARNESS = r"""
#include <thread>
#include <vector>
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

// The kernels' own per-element / per-pixel functions over an (N, P, C)
// input: which 0 heaviside mean, 1 its coefficient, 2 argmax mean, 3
// argmax grads (out2: the gamma term per pixel).
extern "C" void host_k8(int which, const float* x, const float* g,
                        float scale, const int* seeds, float* out,
                        float* out2, int n, int P, int C, int S, int fam,
                        int vr) {
  std::vector<float> scratch(S);
  for (int b = 0; b < n; ++b)
    for (int p = 0; p < P; ++p) {
      const size_t q = (size_t)b * P + p;
      const uint32_t s0 = seeds[2 * b], s1 = seeds[2 * b + 1];
      if (which < 2) {
        for (int c = 0; c < C; ++c)
          out[q * C + c] = heaviside_elem(which, x[q * C + c], scale, s0, s1,
                                          c, p, S, fam, vr != 0);
      } else if (which == 2) {
        argmax_mean_pixel(x + q * C, out + q * C, scale, s0, s1, p, C, S,
                          fam, scratch.data(), 1);
      } else {
        out2[q] = argmax_grads_pixel(x + q * C, g + q * C, out + q * C,
                                     scale, s0, s1, p, C, S, fam, vr != 0,
                                     scratch.data(), 1);
      }
    }
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
    """K8a-c's per-element and per-pixel functions (what each CUDA thread
    runs) against the plain versions on the same seeds: forwards within
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
