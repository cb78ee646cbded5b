"""Fused flat-route forward render (PyTorch port of the forward half of
``pertrenderer_tpu/ops/fused_render.py``).

Two kernels, each with a plain PyTorch version beside it:

* K1 ``prng_probe`` (csrc/prng_probe.cu) — the counter-hash PRNG probe,
  pinned against ``tests/goldens/prng_goldens.npz``;
* K3 ``fused_forward`` (csrc/fused_forward.cu) — rasterize, shade, texture,
  both perturbed estimators and the blend for one pixel per thread.

A wrapper takes its plain version only for tensors on the CPU.  For a CUDA
tensor it launches its kernel or raises; there is no fallback.

Layout: the plain versions work on channel-major ``(N, rows, P)`` blocks,
rows being face slots (or z_map channels) and P the row-major pixel id of
the whole image.  The JAX package cuts P into tiles and may pack a tile's
faces into fewer rows; neither changes a pixel's value except packing,
which keys the MC noise on packed slot positions.  The port keys noise on
the unpacked slot row and the absolute pixel id, which is what the JAX
flat route draws with ``PERTRENDERER_PACK=off``.

Only the flat route is ported: every face holds a slot (F <= K and
F_pad <= MAX_SLOTS).  The stream, binned, sharded and staged routes raise
``NotImplementedError`` naming the route.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from pertrenderer_tpu_torch.ops.perturbed import log_corrected, prod_corrected
from pertrenderer_tpu_torch.ops.rasterize import _face_pixel_geometry

__all__ = ["FusedConfig", "RenderPlan", "render_plan", "try_render",
           "prng_probe", "prng_probe_plain", "fused_forward",
           "forward_plain", "draw_seeds", "launch_counts", "MAX_SLOTS"]

MAX_SLOTS = 256          # flat-mode face budget (F_pad <= MAX_SLOTS)
_CAUCHY_CLAMP = 1e7

# --- packed scalar-parameter layout (one (N, NS) f32 row per batch) -------
_S_LIGHT = 0      # light location (point) or direction (directional)
_S_LAMB = 3       # lights.ambient_color
_S_LDIFF = 6      # lights.diffuse_color
_S_LSPEC = 9      # lights.specular_color
_S_MAMB = 12      # materials.ambient_color
_S_MDIFF = 15     # materials.diffuse_color
_S_MSPEC = 18     # materials.specular_color
_S_SHIN = 21      # materials.shininess
_S_CAM = 22       # camera center
_S_BG = 25        # background color
_S_ZNEAR = 28
_S_ZFAR = 29
_S_SIGMA = 30     # smoothrast.sigma
_S_GAMMA = 31     # smoothagg.gamma
_S_ALPHA = 32     # smoothagg.alpha
_S_BLUR = 33      # blur radius
_NS = 34

# Launches of each kernel since the last reset: a wrapper adds one where it
# launches its kernel and nowhere else (plain CPU calls do not count).
launch_counts = {"prng_probe": 0, "fused_forward": 0}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """Static configuration of the flat fused forward."""

    image_size: int
    f_pad: int                 # face slots (multiple of 8)
    f_real: int                # actual face count (<= f_pad)
    k: int                     # reference faces_per_pixel
    rast_kind: str             # 'soft' | 'affine' | 'hard' | 'mc'
    rast_noise: str            # 'gaussian' | 'cauchy'
    s_rast: int
    agg_kind: str              # 'soft' | 'hard' | 'mc'
    agg_noise: str
    s_agg: int
    eps_bg: float
    shade: str                 # 'phong' | 'none'
    light_kind: str            # 'point' | 'directional'
    tex_mode: str              # 'corner' | 'atlas'
    tex_d: int                 # columns of the texel table
    atlas_r: int
    clip_bary: bool
    perspective_correct: bool

    @property
    def bg_row(self) -> int:
        """Row of the background channel in z_map.  With f_real < f_pad it
        is compacted into the first dead slot row; rows past it are -inf."""
        return self.f_real if self.f_real < self.f_pad else self.f_pad

    @property
    def c_zpad(self) -> int:
        """z_map rows: slots + background, padded to a multiple of 8."""
        return _round_up(self.bg_row + 1, 8)


# ---------------------------------------------------------------------------
# Counter-based hash PRNG (murmur3 finalizer).  The JAX package writes the
# unsigned arithmetic in int32; here it is int64 holding values in
# [0, 2^32), masked after every add and multiply, so shifts are logical.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_C_MIX1 = 0x85EBCA6B
_C_MIX2 = 0xC2B2AE35
_C_SAMPLE = 0x9E3779B9     # int32 -1640531527
_C_ROW = 0x85EBCA77        # int32 -2048144777
_C_BM = 0xBB67AE85         # int32 -1150833019
_C_CAUCHY = 0x6A09E667


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C_MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C_MIX2)
    return x ^ (x >> 16)


def _uniform01(h: torch.Tensor) -> torch.Tensor:
    """Low 23 bits -> uniform (0, 1), exactly (m + 0.5) * 2^-23."""
    return ((h & 0x7FFFFF).to(torch.float32) + 0.5) * (2.0 ** -23)


def _hash_words(seed0, seed1, s: int, rows, pos):
    """Mixed counter for (seed words, sample s, channel row, pixel pos); all
    int64 in [0, 2^32), broadcasting."""
    x = _mix(pos)
    word = (seed0 + s * _C_SAMPLE + rows * _C_ROW) & _M32
    return _mix(x ^ word) ^ seed1


def _draw_block(noise_type: str, seed0, seed1, s: int, c: int, pos):
    """(..., c, P) block of iid standard noise for sample ``s``.

    Gaussian draws hash rows 0..c/2-1 and use both Box-Muller halves: row
    r < c/2 is the cos half of hash(r), row r >= c/2 the sin half of
    hash(r - c/2) — so the noise of a row depends on the block's row count.
    ``seed0``/``seed1``: (N, 1, 1) int64; ``pos``: (1, 1, P) int64."""
    dev = pos.device
    if noise_type == "gaussian":
        rows = torch.arange(c // 2, device=dev).view(1, -1, 1)
        x = _hash_words(seed0, seed1, s, rows, pos)
        u1 = _uniform01(x)
        u2 = _uniform01(_mix((x + _C_BM) & _M32))
        r = torch.sqrt(-2.0 * torch.log(u1))
        th = (2.0 * math.pi) * u2
        return torch.cat([r * torch.cos(th), r * torch.sin(th)], dim=-2)
    rows = torch.arange(c, device=dev).view(1, -1, 1)
    x = _hash_words(seed0, seed1, s, rows, pos)
    u = _uniform01(_mix((x + _C_CAUCHY) & _M32))
    if noise_type == "cauchy":
        return torch.clamp(torch.tan(math.pi * (u - 0.5)), -_CAUCHY_CLAMP,
                           _CAUCHY_CLAMP)
    if noise_type == "uniform":
        return u
    raise ValueError(f"fused forward: noise {noise_type!r} unsupported")


_NOISE_IDS = {"uniform": 0, "gaussian": 1, "cauchy": 2}
_PROBE_SEEDS = (1234567, -987654)


def _seed_words(seeds: torch.Tensor, col: int) -> torch.Tensor:
    """Column ``col`` of int32 seed words as (N, 1, 1) int64 in [0, 2^32)."""
    return (seeds[:, col].to(torch.int64) & _M32).view(-1, 1, 1)


def prng_probe_plain(noise_type: str = "gaussian", s: int = 4, c: int = 16,
                     p: int = 256, device="cpu") -> torch.Tensor:
    """Plain version of K1: ``s`` (c, p) noise blocks for the probe seeds at
    pixel positions 7 .. p + 6."""
    seeds = torch.tensor([_PROBE_SEEDS], dtype=torch.int32, device=device)
    s0, s1 = _seed_words(seeds, 0), _seed_words(seeds, 1)
    pos = (torch.arange(p, device=device) + 7).view(1, 1, p)
    return torch.cat([_draw_block(noise_type, s0, s1, i, c, pos)
                      for i in range(s)])


def prng_probe(noise_type: str = "gaussian", s: int = 4, c: int = 16,
               p: int = 256, device="cpu") -> torch.Tensor:
    """K1: the hash-PRNG identity probe (replaces ``prng_probe`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  (s, c, p) float32."""
    device = torch.device(device)
    if device.type == "cpu":
        return prng_probe_plain(noise_type, s, c, p, device)
    if device.type != "cuda":
        raise ValueError(f"prng_probe: unsupported device {device}")
    if noise_type not in _NOISE_IDS or c % 2:
        raise ValueError(f"prng_probe: noise {noise_type!r}, c={c}")
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    seeds = torch.tensor([_PROBE_SEEDS], dtype=torch.int32, device=device)
    out = torch.empty((s, c, p), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.pt_prng_probe(seeds.data_ptr(), out.data_ptr(),
                                _NOISE_IDS[noise_type], s, c, p, stream)
    _build.check(err, "prng_probe")
    launch_counts["prng_probe"] += 1
    return out


def check_prng_stream(device) -> None:
    """Raise unless K1's uniform stage on ``device`` equals the plain
    version bit for bit.  Every MC render draws its noise from this stream
    (and the backward will replay it), so a renderer checks it once per
    device before it serves."""
    got = prng_probe("uniform", s=1, c=16, p=256, device=device)
    want = prng_probe_plain("uniform", s=1, c=16, p=256, device=device)
    if not torch.equal(got, want):
        raise RuntimeError(f"hash PRNG stream on {device} differs from the "
                           "reference bits: the kernel library is broken")


# ---------------------------------------------------------------------------
# Plain forward (the K3 reference): one channel-major pipeline over the
# whole image, batched over N.
# ---------------------------------------------------------------------------

def _pixel_coords(image_size: int, device):
    """Absolute row-major pixel id and NDC pixel-center coords, (1, 1, P)."""
    w = h = image_size
    pos = torch.arange(h * w, device=device)
    col = (pos % w).to(torch.float32)
    row = (pos // w).to(torch.float32)
    px = (w - 1.0 - 2.0 * col) / w
    py = (h - 1.0 - 2.0 * row) / h
    return pos.view(1, 1, -1), px.view(1, 1, -1), py.view(1, 1, -1)


def _det1(cfg: FusedConfig, px, py, fv_ndc, fv_world, fn, tex, valid, sc):
    """Geometry + texturing + shading -> (dist, z, c0, c1, c2, maskf), each
    (N, F_pad, P).  Colors and interpolants are masked where the slot is
    not a candidate, as the JAX kernel masks them."""
    col = lambda t, i: t[:, :, i:i + 1]
    coords = [col(fv_ndc, i) for i in range(9)]
    w0, w1, w2, z, dist, inside, degen = _face_pixel_geometry(
        px, py, *coords, cfg.clip_bary, cfg.perspective_correct)
    # Face validity plus the behind-camera cull.
    zmaxf = torch.maximum(torch.maximum(coords[2], coords[5]), coords[8])
    validb = (valid[:, :, None] > 0.5) & (zmaxf > 0)
    cand = ((inside | (dist <= sc(_S_BLUR))) & ~degen & validb & (z > 0))
    maskf = cand.to(torch.float32)

    if cfg.tex_mode == "corner":
        texel = [(w0 * col(tex, c) + w1 * col(tex, 3 + c)
                  + w2 * col(tex, 6 + c)) * maskf for c in range(3)]
    elif cfg.atlas_r == 1:
        texel = [maskf * col(tex, c) for c in range(3)]
    else:   # atlas cell from quantized (w1, w2)
        r = cfg.atlas_r
        xi = torch.clamp((torch.clamp(w1, 0.0, 1.0) * r).to(torch.int64),
                         0, r - 1)
        yi = torch.clamp((torch.clamp(w2, 0.0, 1.0) * r).to(torch.int64),
                         0, r - 1)
        cell = yi * r + xi
        texel = [maskf * torch.gather(tex, 2, cell * 3 + c)
                 for c in range(3)]

    if cfg.shade == "none":
        c0, c1, c2 = texel
        return dist, z, c0, c1, c2, maskf
    interp = lambda t, v: (w0 * col(t, v) + w1 * col(t, 3 + v)
                           + w2 * col(t, 6 + v)) * maskf
    pnt = [interp(fv_world, v) for v in range(3)]
    nrm = [interp(fn, v) for v in range(3)]       # not re-normalized
    if cfg.light_kind == "point":
        tl = [sc(_S_LIGHT + v) - pnt[v] for v in range(3)]
    else:
        tl = [(-sc(_S_LIGHT + v)).expand_as(pnt[v]) for v in range(3)]
    tln = torch.sqrt(tl[0] * tl[0] + tl[1] * tl[1] + tl[2] * tl[2])
    tl = [v / torch.clamp(tln, min=1e-8) for v in tl]
    cos = nrm[0] * tl[0] + nrm[1] * tl[1] + nrm[2] * tl[2]
    vd = [sc(_S_CAM + v) - pnt[v] for v in range(3)]
    vdn = torch.sqrt(vd[0] * vd[0] + vd[1] * vd[1] + vd[2] * vd[2])
    vd = [v / torch.clamp(vdn, min=1e-8) for v in vd]
    refl = [2.0 * cos * nrm[v] - tl[v] for v in range(3)]
    spec_a = torch.clamp(vd[0] * refl[0] + vd[1] * refl[1]
                         + vd[2] * refl[2], min=0.0)
    facing = (cos > 0.0).to(torch.float32)
    spec_pow = facing * torch.pow(spec_a, sc(_S_SHIN))
    cmax = torch.clamp(cos, min=0.0)
    out = []
    for c in range(3):
        ambient = sc(_S_MAMB + c) * sc(_S_LAMB + c)
        diffuse = cmax * sc(_S_LDIFF + c) * sc(_S_MDIFF + c)
        specular = spec_pow * sc(_S_LSPEC + c) * sc(_S_MSPEC + c)
        out.append((ambient + diffuse) * texel[c] + specular)
    return (dist, z, *out, maskf)


def _coverage(cfg: FusedConfig, dist, sc, seeds, pos):
    """Per-slot coverage probability before masking, (N, F_pad, P)."""
    sigma = sc(_S_SIGMA)
    if cfg.rast_kind == "soft":
        return torch.sigmoid(-dist / sigma)
    if cfg.rast_kind == "affine":
        p = -dist / sigma + 0.5
        p = torch.where(-dist / sigma > 0.5, torch.ones_like(p), p)
        return torch.clamp(p, min=0.0)
    if cfg.rast_kind == "hard":
        return (-dist >= 0).to(torch.float32)
    # MC: mean over samples of H(-dist + sigma * Z); the noise block has
    # f_pad rows.
    s0, s1 = _seed_words(seeds, 0), _seed_words(seeds, 1)
    d = -dist
    acc = torch.zeros_like(d)
    for s in range(cfg.s_rast):
        z = _draw_block(cfg.rast_noise, s0, s1, s, cfg.f_pad, pos)
        acc = acc + (d + sigma * z >= 0).to(torch.float32)
    return acc * (1.0 / cfg.s_rast)


def _zmap(cfg: FusedConfig, prob, z, maskf, sc):
    """The aggregation preamble: (N, c_zpad, P) z_map with the background
    channel in row bg_row and -inf padding rows."""
    z_inv = (sc(_S_ZFAR) - z) / (sc(_S_ZFAR) - sc(_S_ZNEAR)) * maskf
    z_inv_max = torch.clamp(torch.amax(z_inv, dim=1, keepdim=True),
                            min=cfg.eps_bg)
    lp = log_corrected(prob)
    if cfg.agg_kind == "hard":
        scaled = (1.0 / 1e6) * lp
    else:
        scaled = prod_corrected(sc(_S_GAMMA) / sc(_S_ALPHA), lp)
    zmap = scaled + z_inv - z_inv_max
    bg = cfg.eps_bg - z_inv_max
    if cfg.bg_row < cfg.f_pad:
        ridx = torch.arange(cfg.f_pad, device=z.device).view(1, -1, 1)
        return torch.where(ridx == cfg.bg_row, bg, zmap)
    n_pad = cfg.c_zpad - cfg.f_pad - 1
    pad = torch.full((zmap.shape[0], n_pad, zmap.shape[2]), -math.inf,
                     dtype=zmap.dtype, device=zmap.device)
    return torch.cat([zmap, bg, pad], dim=1)


def _first_onehot(zf):
    """First-wins one-hot of the row argmax (torch.max semantics)."""
    ism = zf >= torch.amax(zf, dim=1, keepdim=True)
    ridx = torch.arange(zf.shape[1], device=zf.device).view(1, -1, 1)
    first = torch.amin(torch.where(ism, ridx, 1 << 30), dim=1, keepdim=True)
    return (ridx == first).to(torch.float32)


def _weights(cfg: FusedConfig, zmap, sc, seeds, pos):
    """Aggregation weights over the z_map rows, (N, c_zpad, P)."""
    if cfg.agg_kind == "soft":
        x = prod_corrected(1.0 / sc(_S_GAMMA), zmap)
        e = torch.exp(x - torch.amax(x, dim=1, keepdim=True))
        return e / torch.sum(e, dim=1, keepdim=True)
    if cfg.agg_kind == "hard":
        return _first_onehot(zmap)
    # MC: mean over samples of the >=-max one-hot (ties may light several
    # rows) of z_map + gamma * N; the noise block has c_zpad rows.
    s0, s1 = _seed_words(seeds, 2), _seed_words(seeds, 3)
    gamma = sc(_S_GAMMA)
    acc = torch.zeros_like(zmap)
    for s in range(cfg.s_agg):
        n = _draw_block(cfg.agg_noise, s0, s1, s, cfg.c_zpad, pos)
        zp = zmap + gamma * n
        acc = acc + (zp >= torch.amax(zp, dim=1, keepdim=True)).to(
            torch.float32)
    return acc * (1.0 / cfg.s_agg)


def forward_plain(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds) -> torch.Tensor:
    """Plain version of K3 on any device: (N, H, W, 4) RGBA.

    fv_ndc / fv_world / fn: (N, F_pad, 9); tex: (N, F_pad, tex_d); valid:
    (N, F_pad); scal: (N, 34); seeds: (N, 4) int32 [rast0, rast1, agg0,
    agg1]."""
    n = fv_ndc.shape[0]
    pos, px, py = _pixel_coords(cfg.image_size, fv_ndc.device)
    sc = lambda i: scal[:, i].view(n, 1, 1)
    dist, z, c0, c1, c2, maskf = _det1(cfg, px, py, fv_ndc, fv_world, fn,
                                       tex, valid, sc)
    prob = _coverage(cfg, dist, sc, seeds, pos) * maskf
    weights = _weights(cfg, _zmap(cfg, prob, z, maskf, sc), sc, seeds, pos)
    # Blend.  In the compacted layout the background row lies inside
    # [:f_pad] but its colors are 0, so the slot sum is unaffected.
    wz = weights[:, :cfg.f_pad]
    wb = weights[:, cfg.bg_row:cfg.bg_row + 1]
    rgb = [torch.sum(wz * cc, dim=1, keepdim=True) + wb * sc(_S_BG + c)
           for c, cc in enumerate((c0, c1, c2))]
    ap = torch.ones_like(wb)
    for i in range(cfg.f_pad):
        ap = ap * (1.0 - prob[:, i:i + 1])
    out = torch.cat(rgb + [1.0 - ap], dim=1)             # (N, 4, P)
    s = cfg.image_size
    return out.transpose(1, 2).reshape(n, s, s, 4)


# ---------------------------------------------------------------------------
# K3 wrapper
# ---------------------------------------------------------------------------

_RAST_IDS = {"soft": 0, "affine": 1, "hard": 2, "mc": 3}
_AGG_IDS = {"soft": 0, "hard": 1, "mc": 2}


def _check_inputs(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds):
    n, f = fv_ndc.shape[0], cfg.f_pad
    want = {"fv_ndc": (fv_ndc, (n, f, 9), torch.float32),
            "fv_world": (fv_world, (n, f, 9), torch.float32),
            "fn": (fn, (n, f, 9), torch.float32),
            "tex": (tex, (n, f, cfg.tex_d), torch.float32),
            "valid": (valid, (n, f), torch.float32),
            "scal": (scal, (n, _NS), torch.float32),
            "seeds": (seeds, (n, 4), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if t.device != fv_ndc.device:
            raise ValueError(f"fused_forward: {name} on {t.device}, "
                             f"fv_ndc on {fv_ndc.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_forward: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_forward: {name} is not contiguous")
    if f > MAX_SLOTS or f % 8 or cfg.f_real > f:
        raise ValueError(f"fused_forward: f_pad={f}, f_real={cfg.f_real}")
    if cfg.tex_mode == "atlas" and not 1 <= cfg.atlas_r <= 8:
        raise ValueError(f"fused_forward: atlas_r={cfg.atlas_r}")


def fused_forward(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds) -> torch.Tensor:
    """K3: the flat fused forward (replaces ``_forward_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  Inputs as for
    :func:`forward_plain`; returns (N, H, W, 4) float32 RGBA."""
    _check_inputs(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds)
    dev = fv_ndc.device
    if dev.type == "cpu":
        return forward_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                             seeds)
    if dev.type != "cuda":
        raise ValueError(f"fused_forward: unsupported device {dev}")
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    n, s = fv_ndc.shape[0], cfg.image_size
    out = torch.empty((n, s, s, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pt_fused_forward(
            fv_ndc.data_ptr(), fv_world.data_ptr(), fn.data_ptr(),
            tex.data_ptr(), valid.data_ptr(), scal.data_ptr(),
            seeds.data_ptr(), out.data_ptr(),
            n, s, cfg.f_pad, cfg.bg_row, cfg.c_zpad, cfg.tex_d,
            cfg.atlas_r if cfg.tex_mode == "atlas" else 0,
            _RAST_IDS[cfg.rast_kind], _NOISE_IDS[cfg.rast_noise],
            cfg.s_rast, _AGG_IDS[cfg.agg_kind], _NOISE_IDS[cfg.agg_noise],
            cfg.s_agg, ctypes.c_float(cfg.eps_bg),
            int(cfg.shade == "phong"), int(cfg.light_kind == "point"),
            int(cfg.clip_bary), int(cfg.perspective_correct), stream)
    _build.check(err, "fused_forward")
    launch_counts["fused_forward"] += 1
    return out


class _FusedForward(torch.autograd.Function):
    """Autograd boundary of the fused forward.  The backward kernels are
    not ported yet, so a render that needs gradients fails loudly at
    ``backward`` instead of silently returning a constant image."""

    @staticmethod
    def forward(ctx, cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds):
        return fused_forward(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                             seeds)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "fused render backward: the backward kernels are not ported to "
            "PyTorch yet")


# ---------------------------------------------------------------------------
# Routing + inputs
# ---------------------------------------------------------------------------

# Estimator class -> (kind, noise).  Variance reduction changes only the
# backward, so the VR and no-VR members share a forward.
_RAST_MAP = {
    "SoftRast": ("soft", "gaussian"),
    "GaussianRast": ("mc", "gaussian"),
    "GaussianRast_wovr": ("mc", "gaussian"),
    "ArctanRast": ("mc", "cauchy"),
    "AffineRast": ("affine", "gaussian"),
    "HardRast": ("hard", "gaussian"),
}

_AGG_MAP = {
    "SoftAgg": ("soft", "gaussian"),
    "GaussianAgg": ("mc", "gaussian"),
    "GaussianAgg_wovr": ("mc", "gaussian"),
    "CauchyAgg": ("mc", "cauchy"),
    "HardAgg": ("hard", "gaussian"),
}


def _unsupported(route: str, why: str):
    raise NotImplementedError(
        f"{route} route is not ported to PyTorch yet: {why}")


def _plan(meshes, lights, smoothrast, smoothagg, settings,
          shade: str) -> FusedConfig:
    """The flat route's static configuration; raises NotImplementedError
    naming the route the JAX package would take instead."""
    from pertrenderer_tpu_torch.lights import DirectionalLights, PointLights
    from pertrenderer_tpu_torch.textures import (TexturesAtlas, TexturesUV,
                                                 TexturesVertex)

    rast_entry = _RAST_MAP.get(type(smoothrast).__name__)
    agg_entry = _AGG_MAP.get(type(smoothagg).__name__)
    if rast_entry is None or agg_entry is None:
        _unsupported("staged", "estimator pair (%s, %s) is not a fused menu "
                     "member" % (type(smoothrast).__name__,
                                 type(smoothagg).__name__))
    if (getattr(smoothrast, "sample_axis", None)
            or getattr(smoothagg, "sample_axis", None)):
        _unsupported("sharded", "the estimators shard the sample axis")
    f = int(meshes.max_faces)
    k = int(settings.faces_per_pixel)
    f_pad = _round_up(max(f, 8), 8)
    if f > k or f_pad > MAX_SLOTS:
        _unsupported("stream", "F=%d faces > faces_per_pixel=%d (or above "
                     "%d slots)" % (f, k, MAX_SLOTS))

    tex = meshes.textures
    if isinstance(tex, TexturesVertex):
        if tex.verts_features.shape[-1] != 3:
            _unsupported("staged", "TexturesVertex features must be RGB")
        tex_mode, tex_d, atlas_r = "corner", 9, 0
    elif isinstance(tex, TexturesAtlas):
        r = tex.atlas.shape[2]
        if tex.atlas.shape[-1] != 3 or r > 8:
            _unsupported("staged", "TexturesAtlas must be RGB with "
                         "resolution <= 8")
        tex_mode, tex_d, atlas_r = "atlas", r * r * 3, r
    elif isinstance(tex, TexturesUV):
        r = tex.atlas_size
        if not r or r > 8 or tex.maps.shape[-1] != 3:
            _unsupported("staged", "TexturesUV needs atlas_size in 1..8 and "
                         "RGB maps")
        tex_mode, tex_d, atlas_r = "atlas", r * r * 3, r
    else:
        _unsupported("staged", "texture type %s" % type(tex).__name__)

    if isinstance(lights, PointLights):
        light_kind = "point"
    elif isinstance(lights, DirectionalLights):
        light_kind = "directional"
    else:
        _unsupported("staged", "light type %s" % type(lights).__name__)

    (rast_kind, rast_noise), (agg_kind, agg_noise) = rast_entry, agg_entry
    return FusedConfig(
        image_size=settings.image_size, f_pad=f_pad, f_real=f, k=k,
        rast_kind=rast_kind, rast_noise=rast_noise,
        s_rast=int(getattr(smoothrast, "nb_samples", 1)),
        agg_kind=agg_kind, agg_noise=agg_noise,
        s_agg=int(getattr(smoothagg, "nb_samples", 1)),
        eps_bg=float(smoothagg.eps), shade=shade, light_kind=light_kind,
        tex_mode=tex_mode, tex_d=tex_d, atlas_r=atlas_r,
        clip_bary=settings.resolve_clip(),
        perspective_correct=bool(settings.perspective_correct))


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """Static routing report.  The port runs ``flat`` only: every face holds
    a slot (F <= faces_per_pixel); exact, no selection."""

    mode: str
    reason: str
    f: int
    k: int
    image_size: int
    slots: int = 0


def render_plan(meshes, lights, smoothrast, smoothagg, settings,
                shade: str = "phong") -> RenderPlan:
    """The route :func:`try_render` takes; raises NotImplementedError for
    routes the port does not run yet."""
    cfg = _plan(meshes, lights, smoothrast, smoothagg, settings, shade)
    return RenderPlan(
        mode="flat", f=int(meshes.max_faces), k=cfg.k,
        image_size=cfg.image_size, slots=cfg.f_pad,
        reason="every face holds a slot (F <= faces_per_pixel); exact, no "
               "selection")


def _gather_rows(table, faces):
    """(N, V, C) table, (N, F, 3) int64 faces -> (N, F, 3C)."""
    rows = torch.stack([t[f] for t, f in zip(table, faces)])
    return rows.reshape(faces.shape[0], faces.shape[1], -1)


def _pack_scal(cfg, n, cameras, lights, materials, smoothrast, smoothagg,
               blend_params, blur, device):
    """The packed (N, NS) scalar-parameter row of every batch element."""

    def b3(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=device).expand(n, 3)

    def b1(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return torch.atleast_1d(x).expand(n)[:, None]

    light_vec = (lights.location if cfg.light_kind == "point"
                 else lights.direction)
    return torch.cat([
        b3(light_vec), b3(lights.ambient_color), b3(lights.diffuse_color),
        b3(lights.specular_color), b3(materials.ambient_color),
        b3(materials.diffuse_color), b3(materials.specular_color),
        b1(materials.shininess), b3(cameras.camera_center()),
        b3(blend_params.background_color), b1(cameras.znear),
        b1(cameras.zfar), b1(smoothrast.sigma), b1(smoothagg.gamma),
        b1(smoothagg.alpha), b1(blur)], dim=1).contiguous()


def draw_seeds(n: int, generator: Optional[torch.Generator] = None,
               fixed_noise: bool = False, device="cpu") -> torch.Tensor:
    """(N, 4) int32 seed words [rast0, rast1, agg0, agg1] drawn from a CPU
    ``generator`` (seed 0 if None).  ``fixed_noise`` draws the aggregation
    words from a generator seeded 1, so every render sees the same
    aggregation noise."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    draw = lambda g, k: torch.randint(-2 ** 31, 2 ** 31, (n, k),
                                      generator=g, dtype=torch.int64)
    words = draw(generator, 4)
    if fixed_noise:
        words[:, 2:] = draw(torch.Generator().manual_seed(1), 2)
    return words.to(torch.int32).to(device)


def _prepare_inputs(cfg: FusedConfig, meshes, cameras, lights, materials,
                    smoothrast, smoothagg, blend_params, settings, seeds,
                    shade: str, blur_override=None):
    """The kernel's tensor inputs: face tables, validity, packed scalars and
    seed words (:func:`forward_plain` documents the shapes)."""
    from pertrenderer_tpu_torch.textures import TexturesUV, TexturesVertex

    n, f, dev = meshes.batch_size, meshes.max_faces, meshes.device
    blur = settings.blur_radius if blur_override is None else blur_override

    verts_ndc = cameras.transform_points_ndc(meshes.verts)
    faces = torch.clamp(meshes.faces, min=0)
    fv_ndc = _gather_rows(verts_ndc, faces)
    fv_world = _gather_rows(meshes.verts, faces)
    if shade == "phong":
        fn_world = _gather_rows(meshes.verts_normals(), faces)
    else:
        fn_world = torch.zeros_like(fv_world)

    tex = meshes.textures
    if cfg.tex_mode == "corner":
        feats = tex.verts_features.expand(
            (n,) + tuple(tex.verts_features.shape[1:]))
        tex_tab = _gather_rows(feats, faces)
    else:
        atlas = tex._bake_atlas() if isinstance(tex, TexturesUV) \
            else tex.atlas
        atlas = atlas.expand((n,) + tuple(atlas.shape[1:]))
        tex_tab = atlas.reshape(n, f, -1)

    face_ids = torch.arange(f, device=dev)
    validf = ((face_ids[None, :] < meshes.num_faces[:, None])
              & torch.all(meshes.faces >= 0, dim=-1))
    if settings.cull_backfaces:
        area = ((fv_ndc[..., 3] - fv_ndc[..., 0])
                * (fv_ndc[..., 7] - fv_ndc[..., 1])
                - (fv_ndc[..., 4] - fv_ndc[..., 1])
                * (fv_ndc[..., 6] - fv_ndc[..., 0]))
        validf = validf & (area > 0)

    pad = lambda x: torch.nn.functional.pad(
        x, (0, 0, 0, cfg.f_pad - f)).contiguous()
    valid = torch.nn.functional.pad(validf.to(torch.float32),
                                    (0, cfg.f_pad - f))
    scal = _pack_scal(cfg, n, cameras, lights, materials, smoothrast,
                      smoothagg, blend_params, blur, dev)
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.from_numpy(np.array(seeds, dtype=np.int32))
    seeds = seeds.to(device=dev, dtype=torch.int32)
    seeds = seeds.reshape(n, -1)[:, :4].contiguous()
    return (pad(fv_ndc), pad(fv_world), pad(fn_world), pad(tex_tab),
            valid.contiguous(), scal, seeds)


def try_render(meshes, cameras, lights, materials, smoothrast, smoothagg,
               blend_params, settings, shade: str, seeds=None,
               generator: Optional[torch.Generator] = None,
               blur_override=None) -> torch.Tensor:
    """Render (N, H, W, 4) RGBA through the flat fused forward (K3).

    ``seeds``: (N, 4) int32 seed words, or JAX-layout (N, 1, 8) seed rows
    whose first four columns are used; drawn from ``generator`` when None.
    A render whose inputs require grad returns an image whose backward
    raises NotImplementedError (the backward kernels are not ported)."""
    cfg = _plan(meshes, lights, smoothrast, smoothagg, settings, shade)
    if seeds is None:
        seeds = draw_seeds(meshes.batch_size, generator,
                           getattr(smoothagg, "fixed_noise", False))
    inputs = _prepare_inputs(cfg, meshes, cameras, lights, materials,
                             smoothrast, smoothagg, blend_params, settings,
                             seeds, shade, blur_override=blur_override)
    return _FusedForward.apply(cfg, *inputs)
