"""The staged route's Monte-Carlo estimator kernels K8a, K8b and K8c (the
counterpart of ``pertrenderer_tpu/ops/perturbed_pallas.py``).

Layout: channels last, (N, P, C) contiguous float32 — the staged route's
(N, H, W, K) coverage distances and (N, H, W, K + 1) z_map with the
pixels flattened.  The noise comes from the counter hash of K1
(``csrc/hash_prng.cuh``), keyed by the batch element's seed word pair
(``seeds`` (N, 2) int32), the sample s, the channel c (the hash row) and
the pixel p (the hash position); the backward kernels redraw the
forward's noise from the same key, so no (S, ...) noise tensor is kept.

* K8a ``heaviside_mean`` / ``heaviside_coeff`` — elementwise:
  mean_s H(d + sigma Z_s), and the score coefficient
  mean_s (H(d + sigma Z_s) - vr H(d)) score(Z_s) / sigma;
* K8b ``argmax_mean`` — per pixel: mean_s onehot(z + gamma Z_s >= max),
  every tied channel counted;
* K8c ``argmax_grads`` — per pixel, with dot_s = <g, w_s - w0> (w0 the
  first-wins one-hot of z when variance reduction is on, else 0):
  grad_z = sum_s dot_s score(Z_s) / (S gamma), and the gamma term
  sum_s dot_s (phi_s - 1) / (S gamma) with phi = sum_c Z^2 (gaussian) or
  sum_c score(Z) Z (cauchy).

Each plain version is a draw (``draws``) and an estimator that takes the
noise as an iterable of per-sample tensors shaped like the input (an
(S, ...) tensor works), so a test can feed it other noise.  A wrapper runs
its plain version only for tensors on the CPU; for a CUDA tensor it
launches its kernel (``csrc/perturbed.cu``) or raises.
"""

from __future__ import annotations

import torch

from pertrenderer_tpu_torch.ops import fused_render as _fr  # the hash

__all__ = ["heaviside_mean", "heaviside_coeff", "argmax_mean",
           "argmax_grads", "heaviside_mean_plain", "heaviside_coeff_plain",
           "argmax_mean_plain", "argmax_grads_plain", "heaviside_mean_est",
           "heaviside_coeff_est", "argmax_mean_est", "argmax_grads_est",
           "draws", "score", "NOISE_IDS", "GRAD_NOISES", "launch_counts",
           "plain_calls"]

NOISE_IDS = {"gaussian": 0, "cauchy": 1, "logistic": 2, "gumbel": 3,
             "uniform": 4}
GRAD_NOISES = ("gaussian", "cauchy")   # the families with a score function
MAX_GRAD_CHANNELS = 512   # K8c on the card: 16 channels per lane at most

launch_counts = {"heaviside_mean": 0, "heaviside_coeff": 0,
                 "argmax_mean": 0, "argmax_grads": 0}
# The wrappers' calls that took the plain version (tensors on the CPU).
plain_calls = dict.fromkeys(launch_counts, 0)


def score(noise: torch.Tensor, noise_type: str) -> torch.Tensor:
    """-d log p / d z of the noise density."""
    if noise_type == "gaussian":
        return noise
    if noise_type == "cauchy":
        return 2.0 * noise / (1.0 + noise * noise)
    raise ValueError(f"gradient for noise type {noise_type!r} not "
                     "implemented")


def draws(noise_type: str, seeds: torch.Tensor, n_samples: int, shape):
    """The kernels' noise, one (N, P, C) tensor per sample s = 0 .. S - 1,
    reshaped to ``shape`` ((N, ..., C), channels last).  ``seeds``: (N, 2)
    int32 seed words."""
    n, c = shape[0], shape[-1]
    p = 1
    for m in shape[1:-1]:
        p *= m
    dev = seeds.device
    s0, s1 = _fr._seed_words(seeds, 0), _fr._seed_words(seeds, 1)
    rows = torch.arange(c, device=dev).view(1, 1, c)
    pos = torch.arange(p, device=dev).view(1, p, 1)
    for s in range(n_samples):
        yield _fr._draw_values(noise_type, s0, s1, s, rows, pos).expand(
            n, p, c).reshape(shape)


def heaviside_mean_est(d, sigma, noise, n_samples: int) -> torch.Tensor:
    """mean_s H(d + sigma Z_s) over the per-sample noise ``noise``."""
    acc = torch.zeros_like(d)
    for z in noise:
        acc = acc + _fr._heaviside(d + sigma * z)
    return acc * (1.0 / n_samples)


def heaviside_coeff_est(d, sigma, noise, n_samples: int, noise_type: str,
                        variance_reduction: bool) -> torch.Tensor:
    """mean_s (H(d + sigma Z_s) - vr H(d)) score(Z_s) / sigma."""
    h0 = _fr._heaviside(d) if variance_reduction else torch.zeros_like(d)
    acc = torch.zeros_like(d)
    for z in noise:
        h = _fr._heaviside(d + sigma * z)
        acc = acc + (h - h0) * score(z, noise_type)
    return acc / (n_samples * sigma)


def _onehot_ge(v):
    """The draws' one-hot: every channel reaching the max (ties count)."""
    return (v >= torch.amax(v, dim=-1, keepdim=True)).to(torch.float32)


def _onehot_first(z):
    """The variance-reduction baseline: the first channel reaching the
    max (torch.argmax)."""
    return torch.nn.functional.one_hot(torch.argmax(z, dim=-1),
                                       z.shape[-1]).to(torch.float32)


def argmax_mean_est(z, gamma, noise, n_samples: int) -> torch.Tensor:
    """mean_s onehot(z + gamma Z_s >= max) over the last axis."""
    acc = torch.zeros_like(z)
    for e in noise:
        acc = acc + _onehot_ge(z + gamma * e)
    return acc * (1.0 / n_samples)


def argmax_grads_est(z, g, gamma, noise, n_samples: int, noise_type: str,
                     variance_reduction: bool):
    """(grad_z like z, the gamma term z.shape[:-1]) of the perturbed
    argmax's cotangent ``g``; grad_gamma is the gamma term's sum."""
    w0 = _onehot_first(z) if variance_reduction else torch.zeros_like(z)
    acc_z = torch.zeros_like(z)
    acc_g = torch.zeros_like(z[..., 0])
    for e in noise:
        dot = torch.sum(g * (_onehot_ge(z + gamma * e) - w0), dim=-1)
        sc = score(e, noise_type)
        acc_z = acc_z + dot[..., None] * sc
        phi = torch.sum(e * e if noise_type == "gaussian" else sc * e,
                        dim=-1)
        acc_g = acc_g + dot * (phi - 1.0)
    sg = n_samples * gamma
    return acc_z / sg, acc_g / sg


def heaviside_mean_plain(d, sigma, seeds, n_samples: int, noise_type: str):
    """K8a's plain version (forward)."""
    return heaviside_mean_est(d, sigma, draws(noise_type, seeds, n_samples,
                                              d.shape), n_samples)


def heaviside_coeff_plain(d, sigma, seeds, n_samples: int, noise_type: str,
                          variance_reduction: bool):
    """K8a's plain version (the backward's coefficient)."""
    return heaviside_coeff_est(d, sigma, draws(noise_type, seeds, n_samples,
                                               d.shape), n_samples,
                               noise_type, variance_reduction)


def argmax_mean_plain(z, gamma, seeds, n_samples: int, noise_type: str):
    """K8b's plain version."""
    return argmax_mean_est(z, gamma, draws(noise_type, seeds, n_samples,
                                           z.shape), n_samples)


def argmax_grads_plain(z, g, gamma, seeds, n_samples: int, noise_type: str,
                       variance_reduction: bool):
    """K8c's plain version."""
    return argmax_grads_est(z, g, gamma, draws(noise_type, seeds, n_samples,
                                               z.shape), n_samples,
                            noise_type, variance_reduction)


def _check(kernel: str, x: torch.Tensor, scale: torch.Tensor,
           seeds: torch.Tensor, n_samples: int, noise_type: str, *others):
    if x.dim() < 2 or x.dtype != torch.float32:
        raise ValueError(f"{kernel}: input must be float32 (N, ..., C), got "
                         f"{tuple(x.shape)} {x.dtype}")
    if seeds.shape != (x.shape[0], 2) or seeds.dtype != torch.int32:
        raise ValueError(f"{kernel}: seeds must be ({x.shape[0]}, 2) int32, "
                         f"got {tuple(seeds.shape)} {seeds.dtype}")
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError(f"{kernel}: the noise scale must be one float32")
    if noise_type not in NOISE_IDS or n_samples < 1:
        raise ValueError(f"{kernel}: noise {noise_type!r}, S={n_samples}")
    for t in (scale, seeds) + others:
        if t.device != x.device:
            raise ValueError(f"{kernel}: inputs on {t.device} and "
                             f"{x.device}")
    for t in others:
        if t.shape != x.shape or t.dtype != torch.float32:
            raise ValueError(f"{kernel}: cotangent {tuple(t.shape)} "
                             f"{t.dtype} for input {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {x.device}")


def _check_grad_noise(kernel: str, noise_type: str):
    if noise_type not in GRAD_NOISES:
        raise ValueError(f"{kernel}: noise {noise_type!r} has no score "
                         "function (forward-only family)")


def _npc(x: torch.Tensor):
    n, c = x.shape[0], x.shape[-1]
    return n, x.numel() // max(n * c, 1), c


def _launch(kernel: str, fn, *args):
    from pertrenderer_tpu_torch import _build

    dev = args[0].device
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, kernel)
    launch_counts[kernel] += 1


def _heaviside_call(kernel, mode, d, sigma, seeds, n_samples, noise_type,
                    variance_reduction):
    from pertrenderer_tpu_torch import _build

    d, sigma, seeds = d.contiguous(), sigma.contiguous(), seeds.contiguous()
    out = torch.empty_like(d)
    if d.numel():
        _launch(kernel, _build.library().pt_heaviside, d, sigma, seeds, out,
                mode, d.numel(), *_npc(d)[1:], n_samples,
                NOISE_IDS[noise_type], int(variance_reduction))
    return out


def heaviside_mean(d, sigma, seeds, n_samples: int,
                   noise_type: str = "gaussian") -> torch.Tensor:
    """K8a forward: mean_s H(d + sigma Z_s), elementwise over d (N, ...,
    C) float32 (replaces ``_ph_mean_kernel`` of
    ``pertrenderer_tpu/ops/perturbed_pallas.py``).  ``sigma``: one float32
    on d's device; ``seeds``: (N, 2) int32."""
    _check("heaviside_mean", d, sigma, seeds, n_samples, noise_type)
    if d.device.type == "cpu":
        plain_calls["heaviside_mean"] += 1
        return heaviside_mean_plain(d, sigma, seeds, n_samples, noise_type)
    return _heaviside_call("heaviside_mean", 0, d, sigma, seeds, n_samples,
                           noise_type, False)


def heaviside_coeff(d, sigma, seeds, n_samples: int,
                    noise_type: str = "gaussian",
                    variance_reduction: bool = True) -> torch.Tensor:
    """K8a backward: the coefficient mean_s (H(d + sigma Z_s) - vr H(d))
    score(Z_s) / sigma from the forward's noise (replaces
    ``_ph_coeff_kernel``); gaussian and cauchy only."""
    _check("heaviside_coeff", d, sigma, seeds, n_samples, noise_type)
    _check_grad_noise("heaviside_coeff", noise_type)
    if d.device.type == "cpu":
        plain_calls["heaviside_coeff"] += 1
        return heaviside_coeff_plain(d, sigma, seeds, n_samples, noise_type,
                                     variance_reduction)
    return _heaviside_call("heaviside_coeff", 1, d, sigma, seeds, n_samples,
                           noise_type, variance_reduction)


def argmax_mean(z, gamma, seeds, n_samples: int,
                noise_type: str = "gaussian") -> torch.Tensor:
    """K8b: mean_s onehot(z + gamma Z_s >= max) over the last axis of z
    (N, ..., C) float32 (replaces ``_pa_mean_kernel``).  ``gamma``: one
    float32 on z's device; ``seeds``: (N, 2) int32."""
    _check("argmax_mean", z, gamma, seeds, n_samples, noise_type)
    if z.device.type == "cpu":
        plain_calls["argmax_mean"] += 1
        return argmax_mean_plain(z, gamma, seeds, n_samples, noise_type)
    from pertrenderer_tpu_torch import _build

    z, gamma, seeds = z.contiguous(), gamma.contiguous(), seeds.contiguous()
    n, p, c = _npc(z)
    out = torch.empty_like(z)
    if z.numel():
        scratch = torch.empty((n_samples, n * p), dtype=torch.float32,
                              device=z.device)
        _launch("argmax_mean", _build.library().pt_argmax_mean, z, gamma,
                seeds, out, scratch, n, p, c, n_samples,
                NOISE_IDS[noise_type])
    return out


def argmax_grads(z, g, gamma, seeds, n_samples: int,
                 noise_type: str = "gaussian",
                 variance_reduction: bool = True):
    """K8c: (grad_z like z, the per-pixel gamma term z.shape[:-1]) of the
    perturbed argmax's cotangent ``g`` from the forward's noise (replaces
    ``_pa_grads_kernel``); grad_gamma is the gamma term's sum.  Gaussian
    and cauchy only.  On the card, one warp per pixel with the channels
    across its lanes (at most ``MAX_GRAD_CHANNELS``)."""
    _check("argmax_grads", z, gamma, seeds, n_samples, noise_type, g)
    _check_grad_noise("argmax_grads", noise_type)
    if z.device.type == "cpu":
        plain_calls["argmax_grads"] += 1
        return argmax_grads_plain(z, g, gamma, seeds, n_samples, noise_type,
                                  variance_reduction)
    if z.shape[-1] > MAX_GRAD_CHANNELS:
        raise ValueError(f"argmax_grads: {z.shape[-1]} channels, the kernel "
                         f"takes at most {MAX_GRAD_CHANNELS}")
    from pertrenderer_tpu_torch import _build

    z, g = z.contiguous(), g.contiguous()
    gamma, seeds = gamma.contiguous(), seeds.contiguous()
    n, p, c = _npc(z)
    gz = torch.empty_like(z)
    gterm = torch.empty(z.shape[:-1], dtype=torch.float32, device=z.device)
    if z.numel():
        _launch("argmax_grads", _build.library().pt_argmax_grads, z, g,
                gamma, seeds, gz, gterm, n, p, c, n_samples,
                NOISE_IDS[noise_type], int(variance_reduction))
    return gz, gterm
