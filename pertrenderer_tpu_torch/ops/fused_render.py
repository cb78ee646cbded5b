"""Fused render with its gradients (PyTorch port of the flat, stream and
sample-sharded routes of ``pertrenderer_tpu/ops/fused_render.py``).

Ten kernels, each with a plain PyTorch version beside it:

* K1 ``prng_probe`` (csrc/prng_probe.cu) — the counter-hash PRNG probe,
  pinned against ``tests/goldens/prng_goldens.npz``;
* flat route (every face holds a slot, F <= faces_per_pixel): K3
  ``fused_forward`` (csrc/fused_forward.cu) — rasterize, shade, texture,
  both perturbed estimators and the blend for one pixel per thread; K4
  ``fused_backward`` (csrc/fused_backward.cu) — K3's vector-Jacobian
  product: every face-table gradient and the 34 scalar gradients; K2
  ``fused_loss_grad`` (csrc/fused_loss_grad.cu) — K4 with the image-loss
  cotangent derived in place from a target (the pose step's kernel);
* stream route (F > faces_per_pixel): the faces sorted into 64-row chunks,
  each tile walking the chunks its list names — K5 ``fused_stream_forward``
  (csrc/stream_forward.cu), K6 ``fused_stream_backward``
  (csrc/stream_backward.cu) and K7 ``fused_stream_loss_grad``
  (csrc/stream_loss_grad.cu), sharing csrc/stream_grad.cuh;
* sample-sharded flat route (estimators with a ``sample_axis``; each rank
  of a sample group draws its own slice of one sample sequence): K11a
  ``fused_prob`` — this shard's coverage mean; K3 with external coverage
  (``fused_forward(..., prob=)``, which also returns the weights); K11b
  ``fused_agg_bwd`` — the aggregation's backward on this shard's samples;
  K11c ``fused_det_bwd`` — K4 given the group's coverage, weights and
  g_zmap (csrc/sharded.cu).  ``_FusedSharded`` averages over the group
  (``parallel.sharding.axis_mean``) where the JAX package ``pmean``s.

A wrapper takes its plain version only for tensors on the CPU.  For a CUDA
tensor it launches its kernel or raises; there is no fallback.

The plain versions are the reference of the kernels: ``forward_plain``
with the score-function estimators as ``autograd.Function``s,
``backward_plain`` / ``loss_grad_plain`` as torch autograd through it, and
the stream route's chunk sweeps (``stream_forward_plain``, and the two
sweeps of ``stream_backward_plain`` / ``stream_loss_grad_plain``).  Where
autograd's tie rules differ from JAX's, the plain pipeline is written so
that they agree with JAX (``torch.maximum`` / ``torch.amax`` instead of
``torch.clamp``; see ``ops/rasterize.py``).

Layout: the flat plain versions work on channel-major ``(N, rows, P)``
blocks, rows being face slots (or z_map channels) and P the row-major
pixel id of the whole image.  The JAX package cuts P into tiles and may
pack a tile's faces into fewer rows; neither changes a pixel's value
except packing, which keys the MC noise on packed slot positions.  The
port keys noise on the unpacked slot row and the absolute pixel id, which
is what the JAX flat route draws with ``PERTRENDERER_PACK=off``.  Both
routes take JAX's tiles' activity bits (``_active_tiles``): a tile that
no face's blur band reaches gives the background image and only the
background gradient, as the JAX kernels' ``bg_only`` branch does.

The binned route (F > ``_COARSE_THRESHOLD`` with ``bin_overflow='allow'``)
renders per-tile slot tables through K12; its selection, plain versions
and kernel wrappers are ``ops/binned.py``.  Where the JAX package's
``_plan`` declines (an estimator pair outside the fused menu, an image
above 2048 pixels, a texture or light the kernels do not take), ``_plan``
returns no configuration and the reason, and ``MeshRenderer`` takes the
staged route.  Under sample-axis sharding the stream route shards only
the aggregation samples (K5 / K6 unchanged, ``_FusedStreamSharded``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from pertrenderer_tpu_torch.ops.gather import take_rows_batched
from pertrenderer_tpu_torch.parallel import sharding
from pertrenderer_tpu_torch.ops.perturbed import log_corrected, prod_corrected
from pertrenderer_tpu_torch.ops.rasterize import _face_pixel_geometry, _max

__all__ = ["FusedConfig", "RenderPlan", "render_plan", "try_render",
           "try_render_loss", "prng_probe", "prng_probe_plain",
           "fused_forward", "forward_plain", "fused_backward",
           "backward_plain", "fused_loss_grad", "loss_grad_plain",
           "fused_stream_forward", "stream_forward_plain",
           "fused_stream_backward", "stream_backward_plain",
           "fused_stream_loss_grad", "stream_loss_grad_plain",
           "fused_prob", "prob_plain", "fused_agg_bwd", "agg_bwd_plain",
           "fused_det_bwd", "det_bwd_plain", "shard_seeds", "sample_offset",
           "draw_seeds",
           "launch_counts", "MAX_SLOTS", "LOSS_KINDS"]

MAX_SLOTS = 256          # flat-mode face budget (F_pad <= MAX_SLOTS)
_CAUCHY_CLAMP = 1e7
MAX_BIN_SLOTS = 160      # the JAX binned route's per-tile slot budget
_BIN_P_TILE = 128        # its tile width, also the stream strip width
_COARSE_THRESHOLD = 8192  # F above which an opted-in mesh bins
STREAM_CHUNK = 64        # stream: sorted-table rows per chunk
_STREAM_BUCKET_ROWS = 16  # stream: y-bucket height (px) of the sort key
_STREAM_TILE = (8, 32)   # stream: 2-D tile (rows, columns)
_BIG_LO = 1e30           # stream: sort key of invalid and padding rows

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
launch_counts = {"prng_probe": 0, "fused_forward": 0, "fused_backward": 0,
                 "fused_loss_grad": 0, "fused_stream_forward": 0,
                 "fused_stream_backward": 0, "fused_stream_loss_grad": 0,
                 "fused_binned_forward": 0, "fused_binned_backward": 0,
                 "fused_binned_loss_grad": 0, "fused_forward_ext": 0,
                 "sharded_prob": 0, "sharded_agg_bwd": 0,
                 "sharded_det_bwd": 0}
LOSS_KINDS = ("l2_rgb", "l1_rgb")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """Static configuration of the flat fused render.  ``rast_vr`` /
    ``agg_vr``: the estimators' variance reduction, which changes only
    the backward."""

    image_size: int
    f_pad: int                 # face slots (multiple of 8)
    f_real: int                # actual face count (<= f_pad)
    k: int                     # reference faces_per_pixel
    rast_kind: str             # 'soft' | 'affine' | 'hard' | 'mc'
    rast_noise: str            # 'gaussian' | 'cauchy'
    rast_vr: bool
    s_rast: int
    agg_kind: str              # 'soft' | 'hard' | 'mc'
    agg_noise: str
    agg_vr: bool
    s_agg: int
    eps_bg: float
    shade: str                 # 'phong' | 'none'
    light_kind: str            # 'point' | 'directional'
    tex_mode: str              # 'corner' | 'atlas'
    tex_d: int                 # columns of the texel table
    atlas_r: int
    clip_bary: bool
    perspective_correct: bool
    p_tile: int = 0            # pixels per JAX tile
    tile_w: int = 0            # 2-D tiles of (p_tile // tile_w, tile_w)
                               # pixels; 0 = row-major strips of p_tile
    stream: bool = False       # the stream route (F > faces_per_pixel)
    binned: bool = False       # the binned route: slots are each tile's
                               # own faces (ops/binned.py), tables
                               # (N, nt, f_pad, .)
    rw: int = 0                # stream: sorted-table rows, F rounded up to
                               # the chunk; also the background noise row
    prob_ext: bool = False     # sample-axis sharding: flat, the coverage
                               # mean comes from the sample group (K11a);
                               # stream, the aggregation samples shard

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


def _draw_block(noise_type: str, seed0, seed1, s: int, c: int, pos,
                row_base: int = 0):
    """(..., c, P) block of iid standard noise for sample ``s``.

    Gaussian draws hash rows 0..c/2-1 and use both Box-Muller halves: row
    r < c/2 is the cos half of hash(r), row r >= c/2 the sin half of
    hash(r - c/2) — so the noise of a row depends on the block's row count.
    ``row_base`` offsets the hashed row ids: the stream route keys a chunk's
    rows on their absolute sorted-table rows.  ``seed0``/``seed1``:
    (N, 1, 1) int64; ``pos``: (1, 1, P) int64."""
    dev = pos.device
    if noise_type == "gaussian":
        rows = torch.arange(c // 2, device=dev).view(1, -1, 1) + row_base
        x = _hash_words(seed0, seed1, s, rows, pos)
        u1 = _uniform01(x)
        u2 = _uniform01(_mix((x + _C_BM) & _M32))
        r = torch.sqrt(-2.0 * torch.log(u1))
        th = (2.0 * math.pi) * u2
        return torch.cat([r * torch.cos(th), r * torch.sin(th)], dim=-2)
    rows = torch.arange(c, device=dev).view(1, -1, 1) + row_base
    x = _hash_words(seed0, seed1, s, rows, pos)
    u = _uniform01(_mix((x + _C_CAUCHY) & _M32))
    if noise_type == "cauchy":
        return torch.clamp(torch.tan(math.pi * (u - 0.5)), -_CAUCHY_CLAMP,
                           _CAUCHY_CLAMP)
    if noise_type == "uniform":
        return u
    raise ValueError(f"fused forward: noise {noise_type!r} unsupported")


def _draw_values(noise_type: str, seed0, seed1, s: int, rows, pos):
    """One standard value per (row, pos) word for sample ``s``: the staged
    estimators' draws (K8a-c; ``hash_prng.cuh`` ``family_draw``), with the
    maps of ``_sample`` in the JAX package's ``ops/perturbed_pallas.py``.
    Gaussian keeps the cos half of the Box-Muller pair; uniform is centred
    on [-0.5, 0.5].  ``seed0``/``seed1``, ``rows`` and ``pos`` broadcast
    (int64 in [0, 2^32))."""
    x = _hash_words(seed0, seed1, s, rows, pos)
    if noise_type == "gaussian":
        u1 = _uniform01(x)
        u2 = _uniform01(_mix((x + _C_BM) & _M32))
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            (2.0 * math.pi) * u2)
    u = _uniform01(_mix((x + _C_CAUCHY) & _M32))
    if noise_type == "cauchy":
        return torch.clamp(torch.tan(math.pi * (u - 0.5)), -_CAUCHY_CLAMP,
                           _CAUCHY_CLAMP)
    if noise_type == "logistic":
        return torch.log(u) - torch.log1p(-u)
    if noise_type == "gumbel":
        return -torch.log(-torch.log(u))
    if noise_type == "uniform":
        return u - 0.5
    raise ValueError(f"noise type {noise_type!r} not implemented")


_NOISE_IDS = {"uniform": 0, "gaussian": 1, "cauchy": 2}
_PROBE_SEEDS = (1234567, -987654)


def _seed_words(seeds: torch.Tensor, col: int) -> torch.Tensor:
    """Column ``col`` of int32 seed words as (N, 1, 1) int64 in [0, 2^32)."""
    return (seeds[:, col].to(torch.int64) & _M32).view(-1, 1, 1)


def prng_probe_plain(noise_type: str = "gaussian", s: int = 4, c: int = 16,
                     p: int = 256, device="cuda") -> torch.Tensor:
    """Plain version of K1: ``s`` (c, p) noise blocks for the probe seeds at
    pixel positions 7 .. p + 6."""
    seeds = torch.tensor([_PROBE_SEEDS], dtype=torch.int32, device=device)
    s0, s1 = _seed_words(seeds, 0), _seed_words(seeds, 1)
    pos = (torch.arange(p, device=device) + 7).view(1, 1, p)
    return torch.cat([_draw_block(noise_type, s0, s1, i, c, pos)
                      for i in range(s)])


def prng_probe(noise_type: str = "gaussian", s: int = 4, c: int = 16,
               p: int = 256, device="cuda") -> torch.Tensor:
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

    seeds = torch.tensor([_PROBE_SEEDS], dtype=torch.int32, device=device)
    out = torch.empty((s, c, p), dtype=torch.float32, device=device)
    lib = _build.library()
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
# Tile geometry and the activity prepass (``_tile_rects``, ``_active_tiles``
# and their helpers in the JAX package).  A tile whose pixel-centre
# rectangle no face's blur band reaches has no candidate face at any pixel:
# the kernels give it the background image and only the background
# gradient, as the JAX kernels' ``bg_only`` branch does.  The arithmetic is
# float32 in the JAX package's operation order, so the bits agree.
# ---------------------------------------------------------------------------

def _n_tiles(cfg: FusedConfig) -> int:
    return -(-cfg.image_size * cfg.image_size // cfg.p_tile)


def _tile_rects(cfg: FusedConfig):
    """Per-tile NDC rectangle of pixel centres (y_hi, y_lo, x_hi, x_lo),
    each (nt,) float32 numpy, for strip and 2-D tilings."""
    h = w = cfg.image_size
    p, nt = cfg.p_tile, _n_tiles(cfg)
    if cfg.tile_w:
        tw = cfg.tile_w
        th, ntx = p // tw, w // tw
        tids = np.arange(nt)
        r0 = (tids // ntx) * th
        c0 = (tids % ntx) * tw
        y_hi = (h - 1.0 - 2.0 * r0) / h
        y_lo = (h - 1.0 - 2.0 * (r0 + th - 1)) / h
        x_hi = (w - 1.0 - 2.0 * c0) / w
        x_lo = (w - 1.0 - 2.0 * (c0 + tw - 1)) / w
    else:
        starts = np.arange(nt) * p
        ends = np.minimum(starts + p, h * w) - 1
        r0, r1 = starts // w, ends // w
        y_hi = (h - 1.0 - 2.0 * r0) / h
        y_lo = (h - 1.0 - 2.0 * r1) / h
        if p < w and w % p == 0:
            c0 = starts % w
            x_hi = (w - 1.0 - 2.0 * c0) / w
            x_lo = (w - 1.0 - 2.0 * (c0 + p - 1)) / w
        else:
            x_hi = np.full(nt, (w - 1.0) / w)
            x_lo = np.full(nt, -(w - 1.0) / w)
    return (y_hi.astype(np.float32), y_lo.astype(np.float32),
            x_hi.astype(np.float32), x_lo.astype(np.float32))


def _pixel_tiles(cfg: FusedConfig, device) -> torch.Tensor:
    """(P,) tile id of every row-major pixel."""
    w = cfg.image_size
    pix = torch.arange(w * w, device=device)
    if cfg.tile_w:
        th, ntx = cfg.p_tile // cfg.tile_w, w // cfg.tile_w
        return (pix // w // th) * ntx + (pix % w) // cfg.tile_w
    return pix // cfg.p_tile


_SAT_MAX_F = 128     # the separating-axis refinement runs for F <= 128


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _tile_face_overlap_sat(fv_ndc, band, y_hi, y_lo, x_hi, x_lo):
    """Exact separating-axis overlap of each band-dilated triangle with
    each tile's pixel-centre rectangle: (N, nt, F) bool.  fv_ndc (N, F, 9),
    band (N, 1); the rectangle bounds (nt,).  The bbox axes are the
    caller's test; this adds the three edge normals (a degenerate edge
    skips its axis)."""
    tri_x, tri_y = fv_ndc[..., 0::3], fv_ndc[..., 1::3]       # (N, F, 3)
    x_lo, x_hi = x_lo[None, :, None], x_hi[None, :, None]      # (1, nt, 1)
    y_lo, y_hi = y_lo[None, :, None], y_hi[None, :, None]
    ok = None
    for e in range(3):
        j = (e + 1) % 3
        ex = tri_x[..., j] - tri_x[..., e]                      # (N, F)
        ey = tri_y[..., j] - tri_y[..., e]
        ln = torch.sqrt(ex * ex + ey * ey)
        good = ln > 1e-12
        lnc = torch.clamp(ln, min=1e-12)
        nx = torch.where(good, -ey / lnc, torch.zeros_like(ln))
        ny = torch.where(good, ex / lnc, torch.zeros_like(ln))
        tproj = tri_x * nx[..., None] + tri_y * ny[..., None]
        tmin = (torch.amin(tproj, dim=-1) - band)[:, None, :]   # (N, 1, F)
        tmax = (torch.amax(tproj, dim=-1) + band)[:, None, :]
        nx, ny = nx[:, None, :], ny[:, None, :]
        rx_min = torch.minimum(nx * x_lo, nx * x_hi)            # (N, nt, F)
        rx_max = torch.maximum(nx * x_lo, nx * x_hi)
        ry_min = torch.minimum(ny * y_lo, ny * y_hi)
        ry_max = torch.maximum(ny * y_lo, ny * y_hi)
        ax_ok = (((rx_min + ry_min) <= tmax) & ((rx_max + ry_max) >= tmin)
                 | ~good[:, None, :])
        ok = ax_ok if ok is None else (ok & ax_ok)
    return ok


def _face_validb(fv_ndc, valid) -> torch.Tensor:
    """(N, F) declared validity plus the behind-camera cull."""
    zs = fv_ndc.detach()[..., 2::3]
    return (valid > 0.5) & (torch.amax(zs, dim=-1) > 0)


def _tile_face_overlap(cfg: FusedConfig, fv_ndc, validb, blur):
    """(N, nt, F) conservative face/tile overlap: bboxes grown by the blur
    band sqrt(blur) against each tile's pixel-centre rectangle (y only for
    tiles of whole rows), refined by the separating-axis test for
    F <= 128.  fv_ndc (N, F, 9), validb (N, F), blur (N,)."""
    h = w = cfg.image_size
    p, nt = cfg.p_tile, _n_tiles(cfg)
    dev = fv_ndc.device
    fv = fv_ndc.detach()
    band = torch.sqrt(torch.clamp(blur, min=0.0)).view(-1, 1)    # (N, 1)
    ys, xs = fv[..., 1::3], fv[..., 0::3]
    fy_min = (torch.amin(ys, dim=-1) - band)[:, None, :]         # (N, 1, F)
    fy_max = (torch.amax(ys, dim=-1) + band)[:, None, :]

    def x_test(c0, ncols):
        fx_min = (torch.amin(xs, dim=-1) - band)[:, None, :]
        fx_max = (torch.amax(xs, dim=-1) + band)[:, None, :]
        x_hi = _f32((w - 1.0 - 2.0 * c0) / w, dev).view(1, -1, 1)
        x_lo = _f32((w - 1.0 - 2.0 * (c0 + ncols - 1)) / w, dev).view(
            1, -1, 1)
        return (fx_min <= x_hi) & (fx_max >= x_lo)

    if cfg.tile_w:
        tw = cfg.tile_w
        th, ntx = p // tw, w // tw
        tids = np.arange(nt)
        r0 = (tids // ntx) * th
        y_hi = _f32((h - 1.0 - 2.0 * r0) / h, dev).view(1, -1, 1)
        y_lo = _f32((h - 1.0 - 2.0 * (r0 + th - 1)) / h, dev).view(1, -1, 1)
        overlap = ((fy_min <= y_hi) & (fy_max >= y_lo)
                   & validb[:, None, :] & x_test((tids % ntx) * tw, tw))
    else:
        starts = np.arange(nt) * p
        ends = np.minimum(starts + p, h * w) - 1
        y_hi = _f32((h - 1.0 - 2.0 * (starts // w)) / h, dev).view(1, -1, 1)
        y_lo = _f32((h - 1.0 - 2.0 * (ends // w)) / h, dev).view(1, -1, 1)
        overlap = (fy_min <= y_hi) & (fy_max >= y_lo) & validb[:, None, :]
        if p < w and w % p == 0:
            overlap = overlap & x_test(starts % w, p)
    if fv.shape[1] > _SAT_MAX_F:
        return overlap
    rects = [_f32(a, dev) for a in _tile_rects(cfg)]
    return overlap & _tile_face_overlap_sat(fv, band, *rects)


def _active_tiles(cfg: FusedConfig, fv_ndc, valid, blur) -> torch.Tensor:
    """(N, nt) int32 activity bits: 0 proves that no pixel of the tile has
    a candidate face.  fv_ndc (N, F, 9), valid (N, F), blur (N,)."""
    overlap = _tile_face_overlap(cfg, fv_ndc, _face_validb(fv_ndc, valid),
                                 blur)
    return torch.any(overlap, dim=-1).to(torch.int32)


def _pixel_active(cfg: FusedConfig, active) -> torch.Tensor:
    """(N, 1, P) bool: the activity bit of each pixel's tile."""
    return (active > 0)[:, _pixel_tiles(cfg, active.device)][:, None, :]


# ---------------------------------------------------------------------------
# Plain pipeline (the reference of K3, K4 and K2): one channel-major pass
# over the whole image, batched over N.  The MC estimators are
# autograd.Functions whose backward is the reference's score-function
# estimator, replaying the forward's hash-PRNG noise.
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


def _candidates(cfg: FusedConfig, px, py, fv_ndc, valid, sc):
    """det1's geometry -> (w0, w1, w2, z, dist, maskf), each (N, F_pad, P):
    the final barycentrics, depth, signed squared edge distance and the
    candidacy mask (no gradient)."""
    coords = [fv_ndc[:, :, i:i + 1] for i in range(9)]
    w0, w1, w2, z, dist, inside, degen = _face_pixel_geometry(
        px, py, *coords, cfg.clip_bary, cfg.perspective_correct)
    # Face validity plus the behind-camera cull.
    zmaxf = torch.maximum(torch.maximum(coords[2], coords[5]), coords[8])
    validb = (valid[:, :, None] > 0.5) & (zmaxf > 0)
    cand = ((inside | (dist <= sc(_S_BLUR))) & ~degen & validb & (z > 0))
    return w0, w1, w2, z, dist, cand.to(torch.float32).detach()


def _det1(cfg: FusedConfig, px, py, fv_ndc, fv_world, fn, tex, valid, sc):
    """Geometry + texturing + shading -> (dist, z, c0, c1, c2, maskf), each
    (N, F_pad, P).  Colors and interpolants are masked where the slot is
    not a candidate, as the JAX kernel masks them.  ``maskf`` and the
    shininess carry no gradient (JAX stop-gradients both)."""
    col = lambda t, i: t[:, :, i:i + 1]
    w0, w1, w2, z, dist, maskf = _candidates(cfg, px, py, fv_ndc, valid, sc)

    if cfg.tex_mode == "corner":
        texel = [(w0 * col(tex, c) + w1 * col(tex, 3 + c)
                  + w2 * col(tex, 6 + c)) * maskf for c in range(3)]
    elif cfg.atlas_r == 1:
        texel = [maskf * col(tex, c) for c in range(3)]
    else:   # atlas cell from quantized (w1, w2); no gradient to the cell
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
    tl = [v / _max(tln, 1e-8) for v in tl]
    cos = nrm[0] * tl[0] + nrm[1] * tl[1] + nrm[2] * tl[2]
    vd = [sc(_S_CAM + v) - pnt[v] for v in range(3)]
    vdn = torch.sqrt(vd[0] * vd[0] + vd[1] * vd[1] + vd[2] * vd[2])
    vd = [v / _max(vdn, 1e-8) for v in vd]
    refl = [2.0 * cos * nrm[v] - tl[v] for v in range(3)]
    spec_a = _max(vd[0] * refl[0] + vd[1] * refl[1] + vd[2] * refl[2], 0.0)
    facing = (cos > 0.0).to(torch.float32)
    spec_pow = facing * torch.pow(spec_a, sc(_S_SHIN).detach())
    cmax = _max(cos, 0.0)
    out = []
    for c in range(3):
        ambient = sc(_S_MAMB + c) * sc(_S_LAMB + c)
        diffuse = cmax * sc(_S_LDIFF + c) * sc(_S_MDIFF + c)
        specular = spec_pow * sc(_S_LSPEC + c) * sc(_S_MSPEC + c)
        out.append((ambient + diffuse) * texel[c] + specular)
    return (dist, z, *out, maskf)


def _heaviside(x):
    return (x >= 0).to(torch.float32)


def _score(noise, noise_type: str):
    """d log p / d noise of the noise density, up to sign."""
    if noise_type == "gaussian":
        return noise
    return 2.0 * noise / (1.0 + noise * noise)          # cauchy


def _mc_rast_pass(cfg: FusedConfig, d, sigma, seeds, pos, row_base=0,
                  want_coeff=True):
    """One pass over the coverage samples: (mean of H(d + sigma * Z), the
    score coefficient mean of (H(d + sigma Z) - vr H(d)) score(Z) / sigma,
    or None without ``want_coeff``) over a noise block of d's rows (f_pad
    slots, or a stream chunk keyed from ``row_base``)."""
    s0, s1 = _seed_words(seeds, 0), _seed_words(seeds, 1)
    h0 = _heaviside(d) if cfg.rast_vr else torch.zeros_like(d)
    acc = torch.zeros_like(d)
    acc_c = torch.zeros_like(d)
    for s in range(cfg.s_rast):
        z = _draw_block(cfg.rast_noise, s0, s1, s, d.shape[1], pos, row_base)
        h = _heaviside(d + sigma * z)
        acc = acc + h
        if want_coeff:
            acc_c = acc_c + (h - h0) * _score(z, cfg.rast_noise)
    coeff = acc_c / (cfg.s_rast * sigma) if want_coeff else None
    return acc * (1.0 / cfg.s_rast), coeff


class _MCRast(torch.autograd.Function):
    """MC coverage: mean over samples of H(d + sigma * Z) (``_mc_rast_pass``).
    Backward (``_mc_rast_fwd_coeff`` of the JAX package): grad wrt d is
    coeff * g, and the sigma grad is sum(coeff * g) over slots and pixels —
    the reference's overwrite quirk, not the true derivative.  The
    coefficient shares the forward's noise pass."""

    @staticmethod
    def forward(ctx, cfg, d, sigma, seeds, pos, row_base=0):
        want = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        mean, coeff = _mc_rast_pass(cfg, d, sigma, seeds, pos, row_base,
                                    want)
        ctx.save_for_backward(coeff if want else torch.zeros_like(d))
        return mean

    @staticmethod
    def backward(ctx, g):
        (coeff,) = ctx.saved_tensors
        g_d = coeff * g
        return (None, g_d, g_d.sum(dim=(1, 2), keepdim=True), None, None,
                None)


def _coverage(cfg: FusedConfig, dist, sc, seeds, pos, row_base: int = 0):
    """Per-slot coverage probability before masking, (N, F_pad, P)."""
    sigma = sc(_S_SIGMA)
    if cfg.rast_kind == "soft":
        return torch.sigmoid(-dist / sigma)
    if cfg.rast_kind == "affine":
        p = -dist / sigma + 0.5
        p = torch.where(-dist / sigma > 0.5, torch.ones_like(p), p)
        return _max(p, 0.0)
    if cfg.rast_kind == "hard":
        return _heaviside(-dist)
    return _MCRast.apply(cfg, -dist, sigma, seeds, pos, row_base)


def _zmap(cfg: FusedConfig, prob, z, maskf, sc):
    """The aggregation preamble: (N, c_zpad, P) z_map with the background
    channel in row bg_row and -inf padding rows."""
    z_inv = (sc(_S_ZFAR) - z) / (sc(_S_ZFAR) - sc(_S_ZNEAR)) * maskf
    z_inv_max = _max(torch.amax(z_inv, dim=1, keepdim=True), cfg.eps_bg)
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


def _onehot_ge(zp):
    return (zp >= torch.amax(zp, dim=1, keepdim=True)).to(torch.float32)


class _MCAgg(torch.autograd.Function):
    """MC aggregation: mean over samples of the >=-max one-hot (ties may
    light several rows) of z_map + gamma * N over a c_zpad-row noise block.

    Backward (``_mc_agg_fwd_grads`` of the JAX package) replays the noise,
    masked to the rows that can win (slots + background, rows <= bg_row):
    the VR baseline is the first-wins one-hot; g_zmap averages
    <g_w, w - w0> * score(n); the gamma term uses phi = sum of n^2
    (gaussian) or score(n) * n (cauchy) over those rows plus the k - bg_row
    compensation for the reference's missing empty-slot channels."""

    @staticmethod
    def forward(ctx, cfg, zmap, gamma, seeds, pos):
        s0, s1 = _seed_words(seeds, 2), _seed_words(seeds, 3)
        acc = torch.zeros_like(zmap)
        for s in range(cfg.s_agg):
            n = _draw_block(cfg.agg_noise, s0, s1, s, cfg.c_zpad, pos)
            acc = acc + _onehot_ge(zmap + gamma * n)
        ctx.cfg = cfg
        ctx.save_for_backward(zmap, gamma, seeds, pos)
        return acc * (1.0 / cfg.s_agg)

    @staticmethod
    def backward(ctx, g_w):
        zmap, gamma, seeds, pos = ctx.saved_tensors
        g_zmap, g_gamma = _mc_agg_grads(ctx.cfg, zmap, gamma, seeds, pos, g_w)
        return None, g_zmap, g_gamma, None, None


def _mc_agg_grads(cfg: FusedConfig, zmap, gamma, seeds, pos, g_w):
    """The MC aggregation's backward (``_mc_agg_grads`` of the JAX
    package) for the weights' cotangent ``g_w``, replaying the forward's
    noise: (g_zmap like zmap, the gamma gradient summed over the pixels
    (N, 1, 1))."""
    s0, s1 = _seed_words(seeds, 2), _seed_words(seeds, 3)
    rows = torch.arange(cfg.c_zpad, device=zmap.device).view(1, -1, 1)
    cmask = (rows <= cfg.bg_row).to(torch.float32)
    phi_comp = float(cfg.k - cfg.bg_row)
    w0 = _first_onehot(zmap) if cfg.agg_vr else torch.zeros_like(zmap)
    acc_z = torch.zeros_like(zmap)
    acc_g = torch.zeros_like(zmap[:, :1])
    for s in range(cfg.s_agg):
        n = _draw_block(cfg.agg_noise, s0, s1, s, cfg.c_zpad, pos) * cmask
        diff = (_onehot_ge(zmap + gamma * n) - w0) * cmask
        dot = torch.sum(g_w * diff, dim=1, keepdim=True)
        score = _score(n, cfg.agg_noise)
        acc_z = acc_z + dot * score
        phi = torch.sum(score * n * cmask, dim=1, keepdim=True) + phi_comp
        acc_g = acc_g + dot * (phi - 1.0)
    g_zmap = acc_z / (cfg.s_agg * gamma)
    g_gamma = torch.sum(acc_g / (cfg.s_agg * gamma), dim=2, keepdim=True)
    return g_zmap, g_gamma


def _weights(cfg: FusedConfig, zmap, sc, seeds, pos):
    """Aggregation weights over the z_map rows, (N, c_zpad, P)."""
    if cfg.agg_kind == "soft":
        # jax.nn.softmax: the max shift carries no gradient.
        x = prod_corrected(1.0 / sc(_S_GAMMA), zmap)
        e = torch.exp(x - torch.amax(x, dim=1, keepdim=True).detach())
        return e / torch.sum(e, dim=1, keepdim=True)
    if cfg.agg_kind == "hard":
        return _first_onehot(zmap)
    return _MCAgg.apply(cfg, zmap, sc(_S_GAMMA), seeds, pos)


def _render_cm(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
               seeds, active, prob_ext=None):
    """The plain pipeline: (N, 4, P) channel-major RGBA (with ``prob_ext``,
    and the weights: ``_render_block``).  Pixels of inactive tiles give
    the background image, so their only gradient is the background
    colour's (the JAX kernels' ``bg_only``)."""
    pos, px, py = _pixel_coords(cfg.image_size, fv_ndc.device)
    return _render_block(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                         pos, px, py, _pixel_active(cfg, active),
                         prob_ext=prob_ext)


def _scalar_reader(scal, n: int):
    """sc(i): scalar column i of (N, 34) scalars as (N, 1, 1), or of one
    copy per pixel (N, 34, P) as (N, 1, P)."""
    if scal.dim() == 2:
        return lambda i: scal[:, i].view(n, 1, 1)
    return lambda i: scal[:, i:i + 1]


def _blend(cfg: FusedConfig, weights, prob, c0, c1, c2, sca, dtype):
    """det3: (N, 4, P) RGBA, the weighted colours plus the background
    (rounded to ``dtype``) and alpha = 1 - prod(1 - prob).  In the
    compacted layout the background row lies inside [:f_pad] but its
    colors are 0, so the slot sum is unaffected."""
    wz = weights[:, :cfg.f_pad]
    wb = weights[:, cfg.bg_row:cfg.bg_row + 1]
    rgb = [(torch.sum(wz * cc, dim=1, keepdim=True) + wb * sca(_S_BG + c))
           .to(dtype) for c, cc in enumerate((c0, c1, c2))]
    ap = torch.ones_like(prob[:, :1])
    for i in range(cfg.f_pad):
        ap = ap * (1.0 - prob[:, i:i + 1])
    return torch.cat(rgb + [1.0 - ap], dim=1)


def _bg_weights(cfg: FusedConfig, like) -> torch.Tensor:
    """(1, c_zpad, 1) weights of a tile with no candidate: the background
    one-hot (the JAX ``_bg_weights``)."""
    rows = torch.arange(cfg.c_zpad, device=like.device).view(1, -1, 1)
    return (rows == cfg.bg_row).to(like.dtype)


def _render_block(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds, pos, px, py, act, agg_dtype=None, prob_ext=None):
    """The plain pipeline over a block of B face tables (B, F, .) with
    their scalars (B, 34) and seed words (B, 4), at the pixels pos / px /
    py and activity act ((B or 1, 1, P)): (B, 4, P) RGBA.  ``agg_dtype``
    (float64 for the binned gradients, as K12 computes them) runs the
    aggregation and the blend's weighted sum in that type, the RGB
    rounded back to the tables' type.  Scalars (B, 34, P), one copy per
    pixel, give each pixel's share of the scalar gradients.  ``prob_ext``
    (B, F_pad, P): the sample group's coverage in place of the drawn one
    (K3 with external coverage); the aggregation weights (B, c_zpad, P)
    are then returned beside the image."""
    sc = _scalar_reader(scal, fv_ndc.shape[0])
    dist, z, c0, c1, c2, maskf = _det1(cfg, px, py, fv_ndc, fv_world, fn,
                                       tex, valid, sc)
    if prob_ext is None:
        prob = _coverage(cfg, dist, sc, seeds, pos) * maskf
    else:
        prob = prob_ext
    dt = agg_dtype or prob.dtype
    sca = lambda i: sc(i).to(dt)
    weights = _weights(cfg, _zmap(cfg, prob.to(dt), z.to(dt), maskf.to(dt),
                                  sca), sca, seeds, pos)
    out = _blend(cfg, weights, prob, c0, c1, c2, sca, prob.dtype)
    out = torch.where(act, out, _bg_image(scal, out.shape[-1]))
    if prob_ext is None:
        return out
    return out, torch.where(act, weights, _bg_weights(cfg, weights))


def _bg_image(scal, p: int) -> torch.Tensor:
    """(N, 4, P) background colour, alpha 0: the image of a tile with no
    candidate face (scalars (N, 34) or per pixel (N, 34, P))."""
    bg = torch.cat([scal[:, _S_BG:_S_BG + 3],
                    torch.zeros_like(scal[:, :1])], dim=1)
    return bg if bg.dim() == 3 else bg[:, :, None].expand(-1, -1, p)


def forward_plain(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds, active, prob=None):
    """Plain version of K3 on any device: (N, H, W, 4) RGBA.

    fv_ndc / fv_world / fn: (N, F_pad, 9); tex: (N, F_pad, tex_d); valid:
    (N, F_pad); scal: (N, 34); seeds: (N, 4) int32 [rast0, rast1, agg0,
    agg1]; active: the tiles' (N, nt) int32 activity bits
    (``_active_tiles``).  :func:`_prepare_inputs` returns them in this
    order.  With external coverage (``prob`` (N, F_pad, H * W), the sample
    group's mean of K11a; the JAX ``_pallas_forward(..., prob=)``):
    returns (RGBA, the weights (N, c_zpad, H * W))."""
    res = _render_cm(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                     active, prob)
    out = res if prob is None else res[0]
    s = cfg.image_size
    img = out.transpose(1, 2).reshape(out.shape[0], s, s, 4)
    return img if prob is None else (img, res[1])


def _grad_leaves(fv_ndc, fv_world, fn, tex, scal):
    return [t.detach().requires_grad_() for t in
            (fv_ndc, fv_world, fn, tex, scal)]


def _grads(value, leaves, g_value=None):
    """(g_ndc, g_world, g_fn, g_tex, g_scal); zeros where a table is not
    read (fv_world and fn without Phong shading)."""
    grads = torch.autograd.grad(value, leaves, g_value, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads))


def backward_plain(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                   seeds, active, g_out):
    """Plain version of K4: the vector-Jacobian product of
    :func:`forward_plain` with ``g_out`` (N, H, W, 4), alpha included.
    Returns (g_ndc, g_world, g_fn, g_tex, g_scal) shaped like the inputs;
    ``valid``, ``seeds`` and ``active`` get no gradient."""
    with torch.enable_grad():
        leaves = _grad_leaves(fv_ndc, fv_world, fn, tex, scal)
        out = forward_plain(cfg, *leaves[:4], valid, leaves[4], seeds,
                            active)
        return _grads(out, leaves, g_out)


def _image_loss(loss_kind: str, rgb_cm, target_cm, lscale: float):
    """Per batch element: lscale * sum of (rgb - target)^2 (``l2_rgb``) or
    |rgb - target| (``l1_rgb``) over the RGB channels and pixels."""
    d = rgb_cm - target_cm
    e = d * d if loss_kind == "l2_rgb" else torch.abs(d)
    return torch.sum(e, dim=(1, 2)) * lscale


def loss_grad_plain(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid,
                    scal, seeds, active, target, loss_kind: str,
                    lscale: float):
    """Plain version of K2: the image loss against ``target`` (N, 3, H*W)
    and its gradients, as ``_loss_cotangent`` of the JAX package defines
    them.  Returns (loss (N,), g_ndc, g_world, g_fn, g_tex, g_scal)."""
    with torch.enable_grad():
        leaves = _grad_leaves(fv_ndc, fv_world, fn, tex, scal)
        out = _render_cm(cfg, *leaves[:4], valid, leaves[4], seeds, active)
        loss = _image_loss(loss_kind, out[:, :3], target, lscale)
        return (loss.detach(), *_grads(loss.sum(), leaves))


# ---------------------------------------------------------------------------
# Sample-sharded flat route, plain versions (the reference of K11a, K11b
# and K11c; K3 with external coverage is ``forward_plain(..., prob=)``).
# Each rank of a sample group draws its own slice of one sample sequence
# (``shard_seeds``); the render splits where the group averages per-rank
# sample means: the coverage before the nonlinear z_map, the image and
# the weights after the blend, g_zmap after the aggregation's backward
# and the gradients at the end.  Layout: channel-major (N, rows, H * W).
# ---------------------------------------------------------------------------

def _image_cm(x) -> torch.Tensor:
    """(N, H, W, C) -> channel-major (N, C, H * W)."""
    return x.reshape(x.shape[0], -1, x.shape[-1]).transpose(1, 2)


def _blend_cotangent(cfg: FusedConfig, c0, c1, c2, g_rgb, sc):
    """The blend's weight cotangent laid out like z_map (the JAX
    ``_build_g_w``): <slot colours, g_rgb> per slot row, <background,
    g_rgb> in bg_row, zero padding.  g_rgb (N, 3, P)."""
    g = [g_rgb[:, c:c + 1] for c in range(3)]
    slots = c0 * g[0] + c1 * g[1] + c2 * g[2]
    bg = sc(_S_BG) * g[0] + sc(_S_BG + 1) * g[1] + sc(_S_BG + 2) * g[2]
    if cfg.bg_row < cfg.f_pad:
        ridx = torch.arange(cfg.f_pad, device=slots.device).view(1, -1, 1)
        return torch.where(ridx == cfg.bg_row, bg, slots)
    pad = torch.zeros_like(slots[:, :1]).expand(
        -1, cfg.c_zpad - cfg.f_pad - 1, -1)
    return torch.cat([slots, bg, pad], dim=1)


def prob_plain(cfg: FusedConfig, fv_ndc, valid, scal, seeds,
               active) -> torch.Tensor:
    """Plain version of K11a (the JAX ``_pallas_prob``): this shard's
    coverage mean (N, F_pad, H * W) over its coverage samples (seed words
    as ``shard_seeds`` offsets them), masked to the candidates, zero on
    inactive tiles."""
    pos, px, py = _pixel_coords(cfg.image_size, fv_ndc.device)
    sc = _scalar_reader(scal, fv_ndc.shape[0])
    *_w, dist, maskf = _candidates(cfg, px, py, fv_ndc, valid, sc)
    prob = _coverage(cfg, dist, sc, seeds, pos) * maskf
    return torch.where(_pixel_active(cfg, active), prob,
                       torch.zeros_like(prob))


def agg_bwd_plain(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds, active, prob, g_out):
    """Plain version of K11b (the JAX ``_pallas_agg_bwd``): the MC
    aggregation's backward on this shard's aggregation samples, given the
    group's coverage ``prob`` (N, F_pad, H * W) and the output cotangent
    ``g_out`` (N, H, W, 4).  Returns (g_zmap (N, c_zpad, H * W), the gamma
    term (N,)); an inactive tile gives zeros."""
    n = fv_ndc.shape[0]
    pos, px, py = _pixel_coords(cfg.image_size, fv_ndc.device)
    sc = _scalar_reader(scal, n)
    _dist, z, c0, c1, c2, maskf = _det1(cfg, px, py, fv_ndc, fv_world, fn,
                                        tex, valid, sc)
    zmap = _zmap(cfg, prob, z, maskf, sc)
    g_rgb = torch.where(_pixel_active(cfg, active), _image_cm(g_out)[:, :3],
                        0.0)
    g_zmap, g_gamma = _mc_agg_grads(
        cfg, zmap, sc(_S_GAMMA), seeds, pos,
        _blend_cotangent(cfg, c0, c1, c2, g_rgb, sc))
    return g_zmap, g_gamma.view(n)


def det_bwd_plain(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds, active, prob, weights, g_zmap, g_out):
    """Plain version of K11c (the JAX ``_pallas_det_bwd``): the gradients
    given the group's coverage ``prob`` (N, F_pad, H * W), weights and
    g_zmap (N, c_zpad, H * W) and the output cotangent ``g_out`` (N, H, W,
    4).  det1's adjoint, det2's VJP (g_zmap) and det3's (the blend with
    the weights held), with the coverage's score coefficient on this
    shard's coverage samples; an inactive tile gives only the background
    colour's gradient.  Returns (g_ndc, g_world, g_fn, g_tex, g_scal)
    shaped like the inputs; the aggregation's own gamma term is
    K11b's."""
    n = fv_ndc.shape[0]
    pos, px, py = _pixel_coords(cfg.image_size, fv_ndc.device)
    act = _pixel_active(cfg, active)
    g_cm = _image_cm(g_out)
    g_in = torch.where(act, g_cm, 0.0)
    g_z = torch.where(act, g_zmap, 0.0)
    with torch.enable_grad():
        leaves = _grad_leaves(fv_ndc, fv_world, fn, tex, scal)
        sc = _scalar_reader(leaves[4], n)
        dist, z, c0, c1, c2, maskf = _det1(cfg, px, py, *leaves[:4], valid,
                                           sc)
        prob_l = prob.detach().requires_grad_()
        zmap = _zmap(cfg, prob_l, z, maskf, sc)
        out = _blend(cfg, weights, prob_l, c0, c1, c2, sc, prob.dtype)
        (g_prob,) = torch.autograd.grad([out, zmap], [prob_l], [g_in, g_z],
                                        retain_graph=True)
        sigma = sc(_S_SIGMA)
        coeff = _mc_rast_pass(cfg, -dist.detach(), sigma.detach(), seeds,
                              pos)[1]
        g_d = (coeff * (g_prob * maskf)).detach()
        # The coverage's VJP: d dist = -g_d, d sigma = sum(g_d) (the
        # reference's quirk); an inactive tile's background gradient.
        bg = sum(torch.sum(torch.where(act, 0.0, g_cm[:, c:c + 1])
                           * sc(_S_BG + c)) for c in range(3))
        extra = torch.sum(g_d * (sigma - dist)) + bg
        grads = torch.autograd.grad([out, zmap, extra], leaves,
                                    [g_in, g_z, torch.ones_like(extra)],
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, grads))


# ---------------------------------------------------------------------------
# Stream route, plain versions (the reference of K5, K6 and K7).  The faces
# are sorted by a two-level (y-bucket, x) key into a table of 64-row chunks;
# each tile walks the ascending list of chunks whose blur-grown bbox meets
# its rectangle (``_stream_tables``).  Per pixel the state carries across
# chunks: the alpha product, and per aggregation sample a running
# first-wins argmax (strictly greater wins across chunks, the background
# wins ties) or an online softmax.  The plain versions loop over the
# chunks in ascending id over (N, 64, Q) blocks, Q the pixels whose tile
# lists the chunk, and update a pixel's state only where its own tile
# visits the chunk, so each pixel sees the chunks its tile sees, in order.
# ---------------------------------------------------------------------------

class _PermuteRows(torch.autograd.Function):
    """x[b, perm[b]] whose backward is the gather g[b, inv_perm[b]] (the
    JAX ``_permute_rows``), not an accumulating scatter."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return torch.gather(x, 1, perm[..., None].expand(-1, -1, x.shape[2]))

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        idx = inv_perm[..., None].expand(-1, -1, g.shape[2])
        return torch.gather(g, 1, idx), None, None


def _stream_tables(cfg: FusedConfig, merged, fv_ndc, valid, blur):
    """The stream prepass (``_stream_tables`` of the JAX package), batched.

    merged (N, F, d) = [fv_ndc | fv_world | fn | tex], fv_ndc (N, F, 9),
    valid (N, F), blur (N,).  Returns (tab (N, rw, Dt), rows (N, nt, nch)
    int32, n (N, nt) int32, perm (N, F)): the table sorted by the key
    ``y_bucket * 8 + x_min * 4`` (float32, stable argsort) and padded to
    rw rows, with the key in column d (1e30 marks invalid and padding rows)
    and Dt = d + 1 rounded up to 4; per tile the ascending ids of the chunks
    whose bbox meets the tile, listed first, and their count.  Differentiable
    in ``merged`` through the permutation gather."""
    n, f, d = merged.shape
    ch, rw = STREAM_CHUNK, cfg.rw
    nch, h, dev = rw // ch, cfg.image_size, merged.device
    fv = fv_ndc.detach()
    band = torch.sqrt(torch.clamp(blur, min=0.0)).view(n, 1)
    validb = _face_validb(fv, valid)
    ys, xs = fv[..., 1::3], fv[..., 0::3]
    lo = torch.amin(ys, dim=-1) - band
    hi = torch.amax(ys, dim=-1) + band
    xlo = torch.amin(xs, dim=-1) - band
    xhi = torch.amax(xs, dim=-1) + band
    nb = max(1, -(-h // _STREAM_BUCKET_ROWS))
    b = torch.clamp(torch.floor((1.0 - lo) * (h * 0.5 / _STREAM_BUCKET_ROWS)),
                    0.0, nb - 1.0)
    xn = torch.clamp((xlo + 2.0) * 0.25, 0.0, 1.0)
    key = torch.where(validb, b * 8.0 + xn * 4.0, _f32(_BIG_LO, dev))
    perm = torch.argsort(key, dim=1, stable=True)
    inv_perm = torch.argsort(perm, dim=1)

    def chunk_reduce(col, sentinel, red):
        pad = torch.full((n, rw - f), sentinel, dtype=col.dtype, device=dev)
        colp = torch.cat([torch.gather(col, 1, perm), pad], dim=1)
        return red(colp.view(n, nch, ch), dim=2)             # (N, nch)

    big = _f32(_BIG_LO, dev)
    anyv = chunk_reduce(validb, False, torch.any)
    clo = torch.where(anyv, chunk_reduce(lo, _BIG_LO, torch.amin), big)
    chi = torch.where(anyv, chunk_reduce(hi, -_BIG_LO, torch.amax), -big)
    cxlo = chunk_reduce(xlo, _BIG_LO, torch.amin)[:, None, :]
    cxhi = chunk_reduce(xhi, -_BIG_LO, torch.amax)[:, None, :]
    ty_hi, ty_lo, tx_hi, tx_lo = (_f32(a, dev).view(1, -1, 1)
                                  for a in _tile_rects(cfg))
    ov = ((clo[:, None, :] <= ty_hi) & (chi[:, None, :] >= ty_lo)
          & (cxlo <= tx_hi) & (cxhi >= tx_lo))               # (N, nt, nch)
    count = torch.sum(ov.to(torch.int32), dim=2).to(torch.int32)
    rows = torch.argsort((~ov).to(torch.uint8), dim=2, stable=True)

    dt = _round_up(d + 1, 4)
    merged_s = _PermuteRows.apply(merged, perm, inv_perm)
    tab = torch.cat([
        torch.cat([merged_s, merged.new_zeros(n, rw - f, d)], dim=1),
        torch.cat([torch.gather(key, 1, perm),
                   torch.full((n, rw - f), _BIG_LO, device=dev)],
                  dim=1)[..., None],
        merged.new_zeros(n, rw, dt - d - 1)], dim=2)
    return tab.contiguous(), rows.to(torch.int32), count, perm


def _stream_visits(cfg: FusedConfig, rows, count, active):
    """(N, nt, nch) bool: tile t of batch element b is active and lists
    chunk c."""
    nch = cfg.rw // STREAM_CHUNK
    pos = torch.arange(nch, device=rows.device).view(1, 1, -1)
    listed = (pos < count[..., None].to(torch.int64)).to(torch.uint8)
    vis = torch.zeros_like(listed).scatter_(2, rows.to(torch.int64), listed)
    return (vis > 0) & (active[..., None] > 0)


def _prod_rows(x):
    """Product over dim 1 by successive halving (the JAX ``_prod_rows``
    order), keepdim."""
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        lo = x[:, :half] * x[:, half:2 * half]
        x = torch.cat([lo, x[:, 2 * half:]], dim=1) if x.shape[1] % 2 else lo
    return x


def _first_hot(val):
    """(max (N, 1, Q), first row reaching it (N, 1, Q)) over dim 1."""
    m = torch.amax(val, dim=1, keepdim=True)
    ridx = torch.arange(val.shape[1], device=val.device).view(1, -1, 1)
    first = torch.amin(torch.where(val >= m, ridx, 1 << 30), dim=1,
                       keepdim=True)
    return m, first


def _stream_zmap(cfg: FusedConfig, prob, z, maskf, sc, softmax=False):
    """A chunk's (z_map, z_inv): no stabilising shift, no z_inv_max clamp
    (the JAX ``_stream_zmap``).  Dead rows (prob 0) give -inf.  With
    ``softmax`` gamma, znear and zfar are constants here: the softmax's
    backward books their gradients itself (:func:`_stream_grad_plain`)."""
    fixed = (lambda t: t.detach()) if softmax else (lambda t: t)
    zfar, znear = fixed(sc(_S_ZFAR)), fixed(sc(_S_ZNEAR))
    z_inv = (zfar - z) / (zfar - znear) * maskf
    lp = log_corrected(prob)
    if cfg.agg_kind == "hard":
        return (1.0 / 1e6) * lp + z_inv, z_inv
    return prod_corrected(fixed(sc(_S_GAMMA)) / sc(_S_ALPHA), lp) + z_inv, \
        z_inv


def _stream_chunk(cfg: FusedConfig, blk, c: int, px, py, pos, sc, seeds,
                  softmax=False):
    """det1, coverage and z_map of chunk c (blk (N, 64, Dt)) at the pixels
    (px, py, pos) (1, 1, Q): (prob, zmap, c0, c1, c2, z_inv)."""
    td = cfg.tex_d
    valid = (blk[..., 27 + td] < _BIG_LO).to(torch.float32)
    dist, z, c0, c1, c2, maskf = _det1(
        cfg, px, py, blk[..., :9], blk[..., 9:18], blk[..., 18:27],
        blk[..., 27:27 + td], valid, sc)
    prob = _coverage(cfg, dist, sc, seeds, pos, c * STREAM_CHUNK) * maskf
    zmap, z_inv = _stream_zmap(cfg, prob, z, maskf, sc, softmax)
    return prob, zmap, c0, c1, c2, z_inv


class _StreamPass:
    """The pixel set of one stream sweep: for each chunk the pixels Q whose
    tile visits it (in any batch element), their coordinates and the
    (N, 1, Q) mask of the batch elements whose tile does."""

    def __init__(self, cfg: FusedConfig, rows, count, active):
        self.cfg = cfg
        dev = rows.device
        self.pos, self.px, self.py = _pixel_coords(cfg.image_size, dev)
        vis = _stream_visits(cfg, rows, count, active)
        self.vis_px = vis[:, _pixel_tiles(cfg, dev)]          # (N, P, nch)

    def chunks(self):
        for c in range(self.vis_px.shape[2]):
            mask = self.vis_px[:, :, c]
            sel = torch.nonzero(mask.any(dim=0))[:, 0]
            if len(sel):
                yield (c, sel, mask[:, sel][:, None, :], self.pos[..., sel],
                       self.px[..., sel], self.py[..., sel])


def _bg_rows(cfg: FusedConfig, scal, seeds, pos):
    """Per aggregation sample s: the background row's value eps (+ gamma *
    its noise, drawn at row rw and keeping row 0 of a 2-row block) and the
    noise, each (N, 1, P)."""
    n = scal.shape[0]
    gamma = scal[:, _S_GAMMA].view(n, 1, 1)
    if cfg.agg_kind == "hard":
        z = torch.zeros(n, 1, pos.shape[-1], device=pos.device,
                        dtype=scal.dtype)
        return [(z + cfg.eps_bg, z)]
    s0, s1 = _seed_words(seeds, 2), _seed_words(seeds, 3)
    out = []
    for s in range(cfg.s_agg):
        nz = _draw_block(cfg.agg_noise, s0, s1, s, 2, pos, cfg.rw)[:, 0:1]
        out.append((cfg.eps_bg + gamma * nz, nz))
    return out


def _set(t, sel, mask, new):
    """t[..., sel] = where(mask, new, t[..., sel]), in place."""
    t[..., sel] = torch.where(mask, new, t[..., sel])


def _stream_sweep(cfg: FusedConfig, tab, rows, count, active, scal, seeds,
                  track_alpha: bool, replay: bool):
    """The forward sweep over every chunk (no gradient).  Returns the final
    per-pixel state: dict of (N, k, P) tensors.  ``replay`` adds what the
    backward needs (winner rows, phi, the hard-argmax control variate and
    nreal, the JAX kernel's pass B1)."""
    n, dev = tab.shape[0], tab.device
    ps = _StreamPass(cfg, rows, count, active)
    p = ps.pos.shape[-1]
    sc = lambda i: scal[:, i].view(n, 1, 1)
    gamma = sc(_S_GAMMA)
    bgc = [sc(_S_BG + c).expand(n, 1, p) for c in range(3)]
    one = lambda: torch.ones(n, 1, p, device=dev, dtype=tab.dtype)
    st = {"alpha": one(), "zcnt": 0.0 * one(), "pnz": one()}
    if cfg.agg_kind == "soft":
        st.update(m=cfg.eps_bg * (1.0 / gamma) * one(), den=one(),
                  num=torch.cat(bgc, dim=1))
    else:
        bg = _bg_rows(cfg, scal, seeds, ps.pos)
        s_agg = len(bg)
        st.update(runmax=torch.cat([r for r, _ in bg], dim=1),
                  winc=torch.stack([torch.cat(bgc, dim=1)] * s_agg, dim=1),
                  winid=torch.full((n, s_agg, p), cfg.rw, device=dev,
                                   dtype=torch.int64),
                  phi=torch.cat([nz * nz if cfg.agg_noise == "gaussian"
                                 or cfg.agg_kind == "hard"
                                 else _score(nz, cfg.agg_noise) * nz
                                 for _, nz in bg], dim=1),
                  rm0=cfg.eps_bg * one(), w0c=torch.cat(bgc, dim=1),
                  nreal=0.0 * one())
    a0, a1 = _seed_words(seeds, 2), _seed_words(seeds, 3)
    with torch.no_grad():
        for c, sel, vis, pos, px, py in ps.chunks():
            blk = tab[:, c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK]
            prob, zmap, c0, c1, c2, _zi = _stream_chunk(cfg, blk, c, px, py,
                                                        pos, sc, seeds)
            at = lambda k: st[k][..., sel]
            _set(st["alpha"], sel, vis, at("alpha") * _prod_rows(1.0 - prob))
            if track_alpha:
                ones = prob >= 1.0
                _set(st["zcnt"], sel, vis, at("zcnt") + torch.sum(
                    ones.float(), 1, keepdim=True))
                _set(st["pnz"], sel, vis, at("pnz") * _prod_rows(
                    torch.where(ones, 1.0, 1.0 - prob)))
            if cfg.agg_kind == "soft":
                x = zmap * (1.0 / gamma)
                m_old = at("m")
                m_new = torch.maximum(m_old, torch.amax(x, 1, keepdim=True))
                scale = torch.exp(m_old - m_new)
                e = torch.exp(x - m_new)
                num = torch.cat([at("num")[:, i:i + 1] * scale
                                 + torch.sum(e * ci, 1, keepdim=True)
                                 for i, ci in enumerate((c0, c1, c2))], 1)
                _set(st["den"], sel, vis,
                     at("den") * scale + torch.sum(e, 1, keepdim=True))
                _set(st["m"], sel, vis, m_new)
                _set(st["num"], sel, vis, num)
                continue
            win_cols = lambda first: torch.cat(
                [torch.gather(ci, 1, first) for ci in (c0, c1, c2)], dim=1)
            if replay:      # the hard-argmax control variate (no noise)
                m0, f0 = _first_hot(zmap)
                b0 = (m0 > at("rm0")) & vis
                _set(st["rm0"], sel, b0, m0)
                _set(st["w0c"], sel, b0, win_cols(f0))
                _set(st["nreal"], sel, vis, at("nreal") + STREAM_CHUNK)
            for s in range(st["runmax"].shape[1]):
                one_s = lambda k: st[k][:, s:s + 1]
                if cfg.agg_kind == "hard":
                    val = zmap
                else:
                    nz = _draw_block(cfg.agg_noise, a0, a1, s, STREAM_CHUNK,
                                     pos, c * STREAM_CHUNK)
                    val = zmap + gamma * nz
                    if replay:
                        ph = (nz * nz if cfg.agg_noise == "gaussian"
                              else _score(nz, cfg.agg_noise) * nz)
                        _set(one_s("phi"), sel, vis, one_s("phi")[..., sel]
                             + torch.sum(ph, 1, keepdim=True))
                m, first = _first_hot(val)
                better = (m > one_s("runmax")[..., sel]) & vis
                _set(one_s("runmax"), sel, better, m)
                _set(st["winc"][:, s], sel, better, win_cols(first))
                _set(one_s("winid"), sel, better, first + c * STREAM_CHUNK)
    return st


def _stream_rgb(cfg: FusedConfig, st):
    """(N, 3, P) colour of the swept state."""
    if cfg.agg_kind == "soft":
        return st["num"] / st["den"]
    return torch.mean(st["winc"], dim=1)


def stream_forward_plain(cfg: FusedConfig, tab, rows, count, active, scal,
                         seeds) -> torch.Tensor:
    """Plain version of K5 on any device: (N, H, W, 4) RGBA.

    tab (N, rw, Dt), rows (N, nt, nch) int32, count (N, nt) int32, active
    (N, nt) int32 (``_stream_tables``, ``_active_tiles``); scal (N, 34);
    seeds (N, 4) int32.  An inactive tile keeps its initial state, the
    background with alpha 0."""
    st = _stream_sweep(cfg, tab, rows, count, active, scal, seeds,
                       track_alpha=False, replay=False)
    out = torch.cat([_stream_rgb(cfg, st), 1.0 - st["alpha"]], dim=1)
    s = cfg.image_size
    return out.transpose(1, 2).reshape(out.shape[0], s, s, 4)


def _stream_grad_plain(cfg: FusedConfig, tab, rows, count, active, scal,
                       seeds, g_out=None, target=None, loss_kind=None,
                       lscale=0.0):
    """The two sweeps of the JAX ``_stream_grad_impl``: B1 replays the
    forward (``_stream_sweep``); B2 takes, per chunk, torch autograd through
    that chunk's det1, coverage and z_map with the aggregation cotangents
    built as the JAX kernel builds them.  Returns (loss (N,), g_tab
    (N, rw, Dt), g_scal (N, 34))."""
    n, dev = tab.shape[0], tab.device
    track_alpha = target is None
    st = _stream_sweep(cfg, tab, rows, count, active, scal, seeds,
                       track_alpha=track_alpha, replay=True)
    sc0 = lambda i: scal[:, i].view(n, 1, 1)
    gamma = sc0(_S_GAMMA)
    rgb = _stream_rgb(cfg, st)                                # (N, 3, P)
    p = rgb.shape[-1]
    if track_alpha:
        g_cm = g_out.reshape(n, p, 4).transpose(1, 2)
        g_rgb, g_alpha = g_cm[:, :3], g_cm[:, 3:4]
        loss = torch.zeros(n, device=dev)
    else:
        d = rgb - target
        if loss_kind == "l2_rgb":
            loss = torch.sum(d * d, dim=(1, 2)) * lscale
            g_rgb = 2.0 * d * lscale
        else:
            loss = torch.sum(torch.abs(d), dim=(1, 2)) * lscale
            g_rgb = torch.sign(d) * lscale
        g_alpha = None
    # The scalar gradients sum over every visited row and pixel and cancel
    # (the softmax's 1 / gamma term): accumulated in float64, as the
    # kernels do, then rounded once.
    g_scal = torch.zeros(n, _NS, device=dev, dtype=torch.float64)
    bgc = scal[:, _S_BG:_S_BG + 3, None]
    if cfg.agg_kind == "soft":
        dot_w = torch.sum(rgb * g_rgb, dim=1, keepdim=True)
        x_bg = cfg.eps_bg * (1.0 / gamma)
        w_bg = torch.exp(x_bg - st["m"]) / st["den"]
        g_scal[:, _S_BG:_S_BG + 3] += torch.sum(w_bg * g_rgb, dim=2)
        gb_x = w_bg * (torch.sum(bgc * g_rgb, 1, keepdim=True) - dot_w)
        # gamma, znear and zfar reach the softmax only through z / gamma (z
        # = eps for the background, z_inv for a row), and sum g_x = 0 over
        # both: with c the pixel's max z_map (m * gamma) and G = sum over
        # the rows of g_x (z_inv - c), which does not cancel, gamma takes
        # -(G + (eps - c) gb_x) / gamma^2, znear (G - c gb_x) / (gamma
        # zden) and zfar -(G + (1 - c) gb_x) / (gamma zden), exactly.
        zshift = st["m"] * gamma                              # (N, 1, P)
        g_rows = torch.zeros_like(zshift, dtype=torch.float64)   # G
        gz_den = (gamma * (sc0(_S_ZFAR) - sc0(_S_ZNEAR))).view(n)
        g_scal[:, _S_GAMMA] += (-torch.sum((cfg.eps_bg - zshift) * gb_x,
                                           dim=(1, 2))
                                / (gamma * gamma).view(n))
        g_scal[:, _S_ZNEAR] += -torch.sum(zshift * gb_x, dim=(1, 2)) / gz_den
        g_scal[:, _S_ZFAR] += (-torch.sum((1.0 - zshift) * gb_x, dim=(1, 2))
                               / gz_den)
    else:
        s_agg = st["runmax"].shape[1]
        dot = torch.sum((st["winc"] - st["w0c"][:, None]) * g_rgb[:, None],
                        dim=2)                                # (N, S, P)
        if cfg.agg_kind == "mc":
            comp = float(cfg.k) - st["nreal"]
            g_scal[:, _S_GAMMA] += (torch.sum(dot * (st["phi"] + comp - 1.0),
                                              dim=(1, 2))
                                    / (s_agg * gamma).view(n))
        wbg = torch.mean((st["winid"] >= cfg.rw).to(torch.float32), dim=1,
                         keepdim=True)
        g_scal[:, _S_BG:_S_BG + 3] += torch.sum(wbg * g_rgb, dim=2)

    g_tab = torch.zeros_like(tab)
    a0, a1 = _seed_words(seeds, 2), _seed_words(seeds, 3)
    ps = _StreamPass(cfg, rows, count, active)
    for c, sel, vis, pos, px, py in ps.chunks():
        rows_sl = slice(c * STREAM_CHUNK, (c + 1) * STREAM_CHUNK)
        g_sel = g_rgb[..., sel] * vis
        with torch.enable_grad():
            blk = tab[:, rows_sl].detach().requires_grad_()
            scal_l = scal.detach().requires_grad_()
            sc = lambda i: scal_l[:, i].view(n, 1, 1)
            prob, zmap, c0, c1, c2, z_inv = _stream_chunk(
                cfg, blk, c, px, py, pos, sc, seeds,
                softmax=cfg.agg_kind == "soft")
        with torch.no_grad():
            cols = (c0, c1, c2)
            if cfg.agg_kind == "soft":
                x = zmap * (1.0 / gamma)
                wgt = torch.exp(x - st["m"][..., sel]) / st["den"][..., sel]
                gwr = sum(ci * g_sel[:, i:i + 1] for i, ci in enumerate(cols))
                g_x = wgt * (gwr - dot_w[..., sel] * vis)
                g_zmap = g_x * (1.0 / gamma)
                # x = log(prob) / alpha + z_inv / gamma.  Taking gamma
                # through the z_map's gamma / alpha factor and through 1 /
                # gamma apart gives two large sums of log(prob) g_x that
                # cancel exactly, and znear / zfar through each row's z_inv
                # sums of z_inv g_x whose g_x cancel: their float32
                # rounding was the fault.  So _stream_chunk holds the three
                # constant and they come from G (above).
                zsafe = torch.where(torch.isinf(zmap), 0.0,
                                    z_inv - zshift[..., sel])
                g_rows[..., sel] += torch.sum((zsafe * g_x).double(), dim=1,
                                              keepdim=True)
                g_c = [wgt * g_sel[:, i:i + 1] for i in range(3)]
            else:
                rows_abs = (torch.arange(STREAM_CHUNK, device=dev)
                            .view(1, -1, 1) + c * STREAM_CHUNK)
                g_zmap = torch.zeros_like(zmap)
                g_c = [torch.zeros_like(zmap) for _ in range(3)]
                for s in range(st["winid"].shape[1]):
                    hit = (st["winid"][:, s:s + 1, sel] == rows_abs).float()
                    for i in range(3):
                        g_c[i] = g_c[i] + hit * g_sel[:, i:i + 1]
                    if cfg.agg_kind == "mc":
                        nz = _draw_block(cfg.agg_noise, a0, a1, s,
                                         STREAM_CHUNK, pos, c * STREAM_CHUNK)
                        g_zmap = g_zmap + (dot[:, s:s + 1, sel] * vis
                                           * _score(nz, cfg.agg_noise))
                s_agg = st["winid"].shape[1]
                g_zmap = g_zmap / (s_agg * gamma)
                g_c = [g / s_agg for g in g_c]
            outs, cots = [zmap] + list(cols), [g_zmap] + g_c
            if track_alpha:
                ones = prob >= 1.0
                zc, pz = st["zcnt"][..., sel], st["pnz"][..., sel]
                excl = torch.where(
                    ones, torch.where(zc == 1.0, pz, 0.0),
                    torch.where(zc == 0.0,
                                pz / torch.where(ones, 1.0, 1.0 - prob),
                                0.0))
                outs.append(prob)
                cots.append(g_alpha[..., sel] * vis * excl)
        keep = [i for i, o in enumerate(outs) if o.requires_grad]
        g_blk, g_sc = torch.autograd.grad(
            [outs[i] for i in keep], [blk, scal_l], [cots[i] for i in keep],
            allow_unused=True)
        if g_blk is not None:
            g_tab[:, rows_sl] += g_blk
        if g_sc is not None:
            g_scal += g_sc.double()
    if cfg.agg_kind == "soft":                        # G's share
        g = torch.sum(g_rows, dim=(1, 2))
        g_scal[:, _S_GAMMA] -= g / (gamma * gamma).view(n).double()
        g_scal[:, _S_ZNEAR] += g / gz_den.double()
        g_scal[:, _S_ZFAR] -= g / gz_den.double()
    return loss, g_tab, g_scal.to(tab.dtype)


def stream_backward_plain(cfg: FusedConfig, tab, rows, count, active, scal,
                          seeds, g_out):
    """Plain version of K6: the vector-Jacobian product of
    :func:`stream_forward_plain` with ``g_out`` (N, H, W, 4), alpha
    included.  Returns (g_tab (N, rw, Dt) in sorted order, g_scal
    (N, 34))."""
    return _stream_grad_plain(cfg, tab, rows, count, active, scal, seeds,
                              g_out=g_out)[1:]


def stream_loss_grad_plain(cfg: FusedConfig, tab, rows, count, active, scal,
                           seeds, target, loss_kind: str, lscale: float):
    """Plain version of K7: the image loss against ``target`` (N, 3, H*W)
    and its gradients, with no alpha track.  Returns (loss (N,), g_tab,
    g_scal)."""
    return _stream_grad_plain(cfg, tab, rows, count, active, scal, seeds,
                              target=target, loss_kind=loss_kind,
                              lscale=lscale)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_RAST_IDS = {"soft": 0, "affine": 1, "hard": 2, "mc": 3}
_AGG_IDS = {"soft": 0, "hard": 1, "mc": 2}


def _check(kernel: str, ref: torch.Tensor, tensors: dict):
    """Raise unless every (tensor, shape, dtype) lies on ref's device, has
    that shape and dtype and is contiguous."""
    for name, (t, shape, dtype) in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{kernel}: {name} on {t.device}, fv_ndc on "
                             f"{ref.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def _check_inputs(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds, active, kernel: str = "fused_forward"):
    n, f = fv_ndc.shape[0], cfg.f_pad
    _check(kernel, fv_ndc, {
        "active": (active, (n, _n_tiles(cfg)), torch.int32),
        "fv_ndc": (fv_ndc, (n, f, 9), torch.float32),
        "fv_world": (fv_world, (n, f, 9), torch.float32),
        "fn": (fn, (n, f, 9), torch.float32),
        "tex": (tex, (n, f, cfg.tex_d), torch.float32),
        "valid": (valid, (n, f), torch.float32),
        "scal": (scal, (n, _NS), torch.float32),
        "seeds": (seeds, (n, 4), torch.int32)})
    if f > MAX_SLOTS or f % 8 or cfg.f_real > f:
        raise ValueError(f"{kernel}: f_pad={f}, f_real={cfg.f_real}")
    if cfg.tex_mode == "atlas" and not 1 <= cfg.atlas_r <= 8:
        raise ValueError(f"{kernel}: atlas_r={cfg.atlas_r}")
    dev = fv_ndc.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    return dev


def _cfg_args(cfg: FusedConfig):
    """The static configuration as every kernel's C arguments (the order
    of ``set_config`` in csrc/fused_common.cuh)."""
    return (cfg.image_size, cfg.f_pad, cfg.bg_row, cfg.c_zpad, cfg.tex_d,
            cfg.atlas_r if cfg.tex_mode == "atlas" else 0,
            _RAST_IDS[cfg.rast_kind], _NOISE_IDS[cfg.rast_noise],
            int(cfg.rast_vr), cfg.s_rast, _AGG_IDS[cfg.agg_kind],
            _NOISE_IDS[cfg.agg_noise], int(cfg.agg_vr), cfg.s_agg, cfg.k,
            ctypes.c_float(cfg.eps_bg), int(cfg.shade == "phong"),
            int(cfg.light_kind == "point"), int(cfg.clip_bary),
            int(cfg.perspective_correct))


def _tiling_args(cfg: FusedConfig):
    """The tiling as C arguments: nt, p_tile, tile_w."""
    return (_n_tiles(cfg), cfg.p_tile, cfg.tile_w)


def _check_sharded(cfg: FusedConfig, kernel: str):
    """Raise unless ``cfg`` is the sample-sharded flat route: an MC / MC
    pair with the coverage from the sample group (``cfg.prob_ext``)."""
    if (not cfg.prob_ext or cfg.stream or cfg.binned
            or cfg.rast_kind != "mc" or cfg.agg_kind != "mc"):
        raise ValueError(f"{kernel}: the sharded kernels take the flat "
                         "route's MC / MC pairs under sample-axis sharding "
                         f"(prob_ext {cfg.prob_ext}, stream {cfg.stream}, "
                         f"binned {cfg.binned}, rast {cfg.rast_kind}, agg "
                         f"{cfg.agg_kind})")


def _pixel_rows(cfg: FusedConfig, n: int, rows: int):
    """The shape of a channel-major (N, rows, H * W) field."""
    return (n, rows, cfg.image_size * cfg.image_size)


def fused_forward(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds, active, prob=None):
    """K3: the flat fused forward (replaces ``_forward_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  Inputs as for
    :func:`forward_plain`; returns (N, H, W, 4) float32 RGBA.  With
    external coverage (``cfg.prob_ext``, the sharded route): ``prob`` (N,
    F_pad, H * W) is read in place of the drawn coverage, and the result
    is (RGBA, the weights (N, c_zpad, H * W))."""
    dev = _check_inputs(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                        active)
    n, s = fv_ndc.shape[0], cfg.image_size
    if cfg.prob_ext:
        _check_sharded(cfg, "fused_forward")
        if prob is None:
            raise ValueError("fused_forward: the sharded route's K3 takes "
                             "the sample group's coverage prob")
        _check("fused_forward", fv_ndc, {
            "prob": (prob, _pixel_rows(cfg, n, cfg.f_pad), torch.float32)})
    elif prob is not None:
        raise ValueError("fused_forward: prob is the sharded route's input "
                         "(cfg.prob_ext)")
    if dev.type == "cpu":
        return forward_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                             seeds, active, prob)
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    out = torch.empty((n, s, s, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tables = [t.data_ptr() for t in (fv_ndc, fv_world, fn, tex, valid, scal,
                                     seeds, out)]
    if cfg.prob_ext:
        weights = torch.empty(_pixel_rows(cfg, n, cfg.c_zpad),
                              dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.pt_fused_forward_ext(
                *tables, prob.data_ptr(), weights.data_ptr(), n,
                *_cfg_args(cfg), active.data_ptr(), *_tiling_args(cfg),
                stream)
        _build.check(err, "fused_forward (external coverage)")
        launch_counts["fused_forward_ext"] += 1
        return out, weights
    with torch.cuda.device(dev):
        err = lib.pt_fused_forward(*tables, n, *_cfg_args(cfg),
                                   active.data_ptr(), *_tiling_args(cfg),
                                   stream)
    _build.check(err, "fused_forward")
    launch_counts["fused_forward"] += 1
    return out


def _launch_grads(kernel: str, cfg: FusedConfig, tables, active, extra,
                  loss_args=()):
    """Launch K4 (``extra`` = (g_out,)), K2 (``extra`` = (target,),
    ``loss_args`` = (loss id, scale)) or K11c (``extra`` = (g_out, prob,
    weights, g_zmap)) and return (loss (N,), g_ndc, g_world, g_fn, g_tex,
    g_scal).  Each warp of the kernel sums its pixels into its own row of
    ``partial``; a second pass adds the rows in a fixed order, so the
    gradients are the same bits from run to run."""
    from pertrenderer_tpu_torch import _build

    fv_ndc = tables[0]
    dev, n, f = fv_ndc.device, fv_ndc.shape[0], cfg.f_pad
    lib = _build.library()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    g_ndc, g_world, g_fn = new(n, f, 9), new(n, f, 9), new(n, f, 9)
    g_tex, g_scal, loss = new(n, f, cfg.tex_d), new(n, _NS), new(n)
    warps = lib.pt_grad_partial_warps(n, cfg.image_size, f, cfg.tex_d)
    partial = new(n, warps, lib.pt_grad_partial_width(f, cfg.tex_d))
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn_c = {"fused_backward": lib.pt_fused_backward,
            "fused_loss_grad": lib.pt_fused_loss_grad,
            "sharded_det_bwd": lib.pt_sharded_det_bwd}[kernel]
    with torch.cuda.device(dev):
        err = fn_c(*(t.data_ptr() for t in tables + tuple(extra)),
                   partial.data_ptr(), warps, g_ndc.data_ptr(),
                   g_world.data_ptr(), g_fn.data_ptr(), g_tex.data_ptr(),
                   g_scal.data_ptr(), loss.data_ptr(), n, *_cfg_args(cfg),
                   *loss_args, active.data_ptr(), *_tiling_args(cfg),
                   stream)
    _build.check(err, kernel)
    launch_counts[kernel] += 1
    return loss, g_ndc, g_world, g_fn, g_tex, g_scal


def fused_backward(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid,
                   scal, seeds, active, g_out):
    """K4: the flat fused backward (replaces ``_backward_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  Inputs as for
    :func:`backward_plain`; returns (g_ndc, g_world, g_fn, g_tex,
    g_scal)."""
    dev = _check_inputs(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                        active, "fused_backward")
    s = cfg.image_size
    _check("fused_backward", fv_ndc, {
        "g_out": (g_out, (fv_ndc.shape[0], s, s, 4), torch.float32)})
    if dev.type == "cpu":
        return backward_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                              seeds, active, g_out)
    tables = (fv_ndc, fv_world, fn, tex, valid, scal, seeds)
    return _launch_grads("fused_backward", cfg, tables, active, (g_out,),
                         (0, ctypes.c_float(0.0)))[1:]


def fused_loss_grad(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid,
                    scal, seeds, active, target, loss_kind: str,
                    lscale: float):
    """K2: image loss and every gradient in one launch (replaces
    ``_loss_grad_kernel`` of ``pertrenderer_tpu/ops/fused_render.py``).
    ``target``: (N, 3, H*W) channel-major RGB.  Returns (loss (N,), g_ndc,
    g_world, g_fn, g_tex, g_scal) as :func:`loss_grad_plain`."""
    dev = _check_inputs(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                        active, "fused_loss_grad")
    hw = cfg.image_size * cfg.image_size
    _check("fused_loss_grad", fv_ndc, {
        "target": (target, (fv_ndc.shape[0], 3, hw), torch.float32)})
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"fused_loss_grad: loss_kind {loss_kind!r}, "
                         f"expected one of {LOSS_KINDS}")
    if dev.type == "cpu":
        return loss_grad_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                               seeds, active, target, loss_kind, lscale)
    tables = (fv_ndc, fv_world, fn, tex, valid, scal, seeds)
    return _launch_grads("fused_loss_grad", cfg, tables, active, (target,),
                         (LOSS_KINDS.index(loss_kind),
                          ctypes.c_float(lscale)))


def fused_prob(cfg: FusedConfig, fv_ndc, valid, scal, seeds,
               active) -> torch.Tensor:
    """K11a: this shard's coverage mean (replaces ``_prob_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  Inputs as for
    :func:`prob_plain`; returns (N, F_pad, H * W) float32."""
    _check_sharded(cfg, "sharded_prob")
    n, f = fv_ndc.shape[0], cfg.f_pad
    _check("sharded_prob", fv_ndc, {
        "active": (active, (n, _n_tiles(cfg)), torch.int32),
        "fv_ndc": (fv_ndc, (n, f, 9), torch.float32),
        "valid": (valid, (n, f), torch.float32),
        "scal": (scal, (n, _NS), torch.float32),
        "seeds": (seeds, (n, 4), torch.int32)})
    if f > MAX_SLOTS or f % 8 or cfg.f_real > f:
        raise ValueError(f"sharded_prob: f_pad={f}, f_real={cfg.f_real}")
    dev = fv_ndc.device
    if dev.type == "cpu":
        return prob_plain(cfg, fv_ndc, valid, scal, seeds, active)
    if dev.type != "cuda":
        raise ValueError(f"sharded_prob: unsupported device {dev}")
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    prob = torch.empty(_pixel_rows(cfg, n, f), dtype=torch.float32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pt_sharded_prob(
            fv_ndc.data_ptr(), valid.data_ptr(), scal.data_ptr(),
            seeds.data_ptr(), prob.data_ptr(), n, *_cfg_args(cfg),
            active.data_ptr(), *_tiling_args(cfg), stream)
    _build.check(err, "sharded_prob")
    launch_counts["sharded_prob"] += 1
    return prob


def _check_fields(kernel: str, cfg: FusedConfig, fv_ndc, fields: dict):
    """_check for the channel-major fields ({name: (tensor, rows)}) and
    g_out (N, H, W, 4)."""
    n, s = fv_ndc.shape[0], cfg.image_size
    want = {k: (t, _pixel_rows(cfg, n, r), torch.float32)
            for k, (t, r) in fields.items() if k != "g_out"}
    want["g_out"] = (fields["g_out"][0], (n, s, s, 4), torch.float32)
    _check(kernel, fv_ndc, want)


def fused_agg_bwd(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds, active, prob, g_out):
    """K11b: the MC aggregation's backward on this shard's aggregation
    samples (replaces ``_agg_bwd_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  Inputs as for
    :func:`agg_bwd_plain`; returns (g_zmap (N, c_zpad, H * W), the gamma
    term (N,)).  The kernel sums the gamma term per warp into ``partial``
    and a second pass adds the warps in order."""
    dev = _check_inputs(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                        active, "sharded_agg_bwd")
    _check_sharded(cfg, "sharded_agg_bwd")
    _check_fields("sharded_agg_bwd", cfg, fv_ndc, {
        "prob": (prob, cfg.f_pad), "g_out": (g_out, 4)})
    if dev.type == "cpu":
        return agg_bwd_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                             seeds, active, prob, g_out)
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    n, hw = fv_ndc.shape[0], cfg.image_size * cfg.image_size
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    warps = -(-hw // 128) * 4
    g_zmap, partial, g_gamma = (new(*_pixel_rows(cfg, n, cfg.c_zpad)),
                                new(n, warps), new(n))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pt_sharded_agg_bwd(
            *(t.data_ptr() for t in (fv_ndc, fv_world, fn, tex, valid, scal,
                                     seeds, prob, g_out, g_zmap, partial)),
            warps, g_gamma.data_ptr(), n, *_cfg_args(cfg), active.data_ptr(),
            *_tiling_args(cfg), stream)
    _build.check(err, "sharded_agg_bwd")
    launch_counts["sharded_agg_bwd"] += 1
    return g_zmap, g_gamma


def fused_det_bwd(cfg: FusedConfig, fv_ndc, fv_world, fn, tex, valid, scal,
                  seeds, active, prob, weights, g_zmap, g_out):
    """K11c: the gradients given the sample group's coverage, weights and
    g_zmap (replaces ``_det_bwd_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  Inputs as for
    :func:`det_bwd_plain`; returns (g_ndc, g_world, g_fn, g_tex, g_scal)
    through K4's per-warp partials and fixed-order reduction."""
    dev = _check_inputs(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                        active, "sharded_det_bwd")
    _check_sharded(cfg, "sharded_det_bwd")
    _check_fields("sharded_det_bwd", cfg, fv_ndc, {
        "prob": (prob, cfg.f_pad), "weights": (weights, cfg.c_zpad),
        "g_zmap": (g_zmap, cfg.c_zpad), "g_out": (g_out, 4)})
    if dev.type == "cpu":
        return det_bwd_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                             seeds, active, prob, weights, g_zmap, g_out)
    tables = (fv_ndc, fv_world, fn, tex, valid, scal, seeds)
    return _launch_grads("sharded_det_bwd", cfg, tables, active,
                         (g_out, prob, weights, g_zmap))[1:]


def _kernels(cfg: FusedConfig):
    """(forward, backward, loss-and-grad) wrappers of the flat route (K3,
    K4, K2) or, binned, of K12 (``ops/binned.py``)."""
    if cfg.binned:
        from pertrenderer_tpu_torch.ops import binned

        return (binned.fused_binned_forward, binned.fused_binned_backward,
                binned.fused_binned_loss_grad)
    return fused_forward, fused_backward, fused_loss_grad


class _FusedForward(torch.autograd.Function):
    """Autograd boundary of the fused render: K3 forward, K4 backward
    (binned: K12's forward and backward over per-tile tables); valid,
    seeds and the activity bits get no gradient."""

    @staticmethod
    def forward(ctx, cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                active):
        ctx.cfg = cfg
        ctx.save_for_backward(fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                              active)
        return _kernels(cfg)[0](cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                                seeds, active)

    @staticmethod
    def backward(ctx, g):
        g_ndc, g_world, g_fn, g_tex, g_scal = _kernels(ctx.cfg)[1](
            ctx.cfg, *ctx.saved_tensors, g.contiguous())
        return None, g_ndc, g_world, g_fn, g_tex, None, g_scal, None, None


class _FusedLoss(torch.autograd.Function):
    """Autograd boundary of K2 (JAX ``_fused_loss_core``; binned: K12's
    loss-and-grad): the forward returns the summed loss and keeps the
    kernel's gradients; the backward only scales them by the incoming
    gradient."""

    @staticmethod
    def forward(ctx, cfg, loss_kind, lscale, fv_ndc, fv_world, fn, tex,
                valid, scal, seeds, active, target):
        loss, *grads = _kernels(cfg)[2](cfg, fv_ndc, fv_world, fn, tex,
                                        valid, scal, seeds, active, target,
                                        loss_kind, lscale)
        ctx.save_for_backward(*grads)
        return loss.sum()

    @staticmethod
    def backward(ctx, g):
        g_ndc, g_world, g_fn, g_tex, g_scal = ctx.saved_tensors
        return (None, None, None, g * g_ndc, g * g_world, g * g_fn,
                g * g_tex, None, g * g_scal, None, None, None)


class _FusedSharded(torch.autograd.Function):
    """Autograd boundary of the sample-sharded flat route (the JAX
    ``_fused_core_sharded``): each rank of the sample group ``axis`` draws
    its own samples, and the group averages (``sharding.axis_mean``, the
    JAX ``pmean``) K11a's coverage before the nonlinear z_map, K3's image
    and weights, K11b's g_zmap and gamma term, and K11c's gradients.  Every
    average is of per-rank sample means, so the result is the folded run
    over the group's samples, up to the order of float sums."""

    @staticmethod
    def forward(ctx, cfg, axis, fv_ndc, fv_world, fn, tex, valid, scal,
                seeds, active):
        tables = (fv_ndc, fv_world, fn, tex, valid, scal, seeds, active)
        prob = sharding.axis_mean(
            fused_prob(cfg, fv_ndc, valid, scal, seeds, active), axis)
        out, weights = sharding.axis_mean(
            list(fused_forward(cfg, *tables, prob=prob)), axis)
        ctx.cfg, ctx.axis = cfg, axis
        ctx.save_for_backward(*tables, prob, weights)
        return out

    @staticmethod
    def backward(ctx, g):
        cfg, axis = ctx.cfg, ctx.axis
        *tables, prob, weights = ctx.saved_tensors
        g = g.contiguous()
        g_zmap, g_gamma = sharding.axis_mean(
            list(fused_agg_bwd(cfg, *tables, prob, g)), axis)
        g_ndc, g_world, g_fn, g_tex, g_scal = sharding.axis_mean(
            list(fused_det_bwd(cfg, *tables, prob, weights, g_zmap, g)),
            axis)
        cols = torch.arange(_NS, device=g_scal.device)
        g_scal = g_scal + torch.where(cols == _S_GAMMA, g_gamma[:, None], 0.0)
        return (None, None, g_ndc, g_world, g_fn, g_tex, None, g_scal, None,
                None)


# ---------------------------------------------------------------------------
# Stream route, kernel wrappers (K5, K6, K7) and autograd
# ---------------------------------------------------------------------------

STREAM_BLOCK_PIX = 32         # K6 / K7: pixels of a tile per block


def _check_stream(cfg: FusedConfig, tab, rows, count, active, scal, seeds,
                  kernel: str):
    n, nt, nch = tab.shape[0], _n_tiles(cfg), cfg.rw // STREAM_CHUNK
    dt = tab.shape[2] if tab.dim() == 3 else 0
    _check(kernel, tab, {
        "tab": (tab, (n, cfg.rw, dt), torch.float32),
        "rows": (rows, (n, nt, nch), torch.int32),
        "count": (count, (n, nt), torch.int32),
        "active": (active, (n, nt), torch.int32),
        "scal": (scal, (n, _NS), torch.float32),
        "seeds": (seeds, (n, 4), torch.int32)})
    if (not cfg.stream or cfg.rw % STREAM_CHUNK or dt < 28 + cfg.tex_d
            or dt % 4):
        raise ValueError(f"{kernel}: not a stream table (rw={cfg.rw}, "
                         f"Dt={dt}, tex_d={cfg.tex_d})")
    if cfg.tex_mode == "atlas" and not 1 <= cfg.atlas_r <= 8:
        raise ValueError(f"{kernel}: atlas_r={cfg.atlas_r}")
    if cfg.p_tile % 32 or cfg.p_tile > 256:
        raise ValueError(f"{kernel}: p_tile={cfg.p_tile}")
    dev = tab.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    return dev


def _stream_args(cfg: FusedConfig, tab):
    """The stream geometry as C arguments: nt, nch, p_tile, tile_w, rw,
    Dt."""
    return (_n_tiles(cfg), cfg.rw // STREAM_CHUNK, cfg.p_tile, cfg.tile_w,
            cfg.rw, tab.shape[2])


def fused_stream_forward(cfg: FusedConfig, tab, rows, count, active, scal,
                         seeds) -> torch.Tensor:
    """K5: the stream forward (replaces ``_stream_forward_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  Inputs as for
    :func:`stream_forward_plain`; returns (N, H, W, 4) float32 RGBA."""
    dev = _check_stream(cfg, tab, rows, count, active, scal, seeds,
                        "fused_stream_forward")
    if dev.type == "cpu":
        return stream_forward_plain(cfg, tab, rows, count, active, scal,
                                    seeds)
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    n, s = tab.shape[0], cfg.image_size
    out = torch.empty((n, s, s, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pt_stream_forward(
            tab.data_ptr(), rows.data_ptr(), count.data_ptr(),
            active.data_ptr(), scal.data_ptr(), seeds.data_ptr(),
            out.data_ptr(), n, *_stream_args(cfg, tab), *_cfg_args(cfg),
            stream)
    _build.check(err, "fused_stream_forward")
    launch_counts["fused_stream_forward"] += 1
    return out


def _stream_visit_index(rows, count, active):
    """The visits of the stream gradient kernels: (voff (N, nt) int32, the
    first visit of each tile; vstart (N * nch + 1) int32 and vidx (V,)
    int32, for each (batch element, chunk) its visits in ascending tile
    order; V).  Visits are numbered by (batch element, tile, list position)
    over the active tiles."""
    n, nt, nch = rows.shape
    cnt = (count * (active > 0)).to(torch.int64)
    flat = cnt.reshape(-1)
    voff = (torch.cumsum(flat, 0) - flat).view(n, nt)
    q = torch.arange(nch, device=rows.device).view(1, 1, -1)
    b, t, pos = torch.nonzero(q < cnt[..., None], as_tuple=True)
    chunk = rows[b, t, pos].to(torch.int64)
    vidx = torch.argsort((b * nch + chunk) * nt + t)
    per = torch.bincount(b * nch + chunk, minlength=n * nch)
    vstart = torch.cat([per.new_zeros(1), torch.cumsum(per, 0)])
    return (voff.to(torch.int32).contiguous(),
            vstart.to(torch.int32).contiguous(),
            vidx.to(torch.int32).contiguous(), len(b))


def _launch_stream_grads(kernel: str, cfg: FusedConfig, tab, rows, count,
                         active, scal, seeds, extra, loss_id: int,
                         lscale: float):
    """Launch K6 (``extra`` = g_out) or K7 (``extra`` = target) and return
    (loss (N,), g_tab, g_scal).  A tile is ``p_tile // STREAM_BLOCK_PIX``
    blocks; B1's kernel leaves each pixel's record in ``recs``, B2's
    writes, for each visit, the partial rows that had a candidate and
    their mask, and each block its scalar sums (no atomics); two small
    kernels add them in ascending tile order, so the gradients are the same
    bits from run to run."""
    from pertrenderer_tpu_torch import _build

    dev, n = tab.device, tab.shape[0]
    lib = _build.library()
    voff, vstart, vidx, visits = _stream_visit_index(rows, count, active)
    d, nsub = 27 + cfg.tex_d, cfg.p_tile // STREAM_BLOCK_PIX
    rec = stream_grad_shape(kernel, cfg, tab.shape[2], dev)["record_floats"]
    new = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=dev)
    recs = new(n, _n_tiles(cfg) * cfg.p_tile, rec)
    partial = new(max(visits, 1) * nsub, STREAM_CHUNK, d)
    pmask = new(max(visits, 1) * nsub, dtype=torch.int64)
    pscal = new(n, _n_tiles(cfg) * nsub, _NS + 1, dtype=torch.float64)
    g_tab, g_scal, loss = torch.zeros_like(tab), new(n, _NS), new(n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn_c = (lib.pt_stream_backward if kernel == "fused_stream_backward"
            else lib.pt_stream_loss_grad)
    with torch.cuda.device(dev):
        err = fn_c(tab.data_ptr(), rows.data_ptr(), count.data_ptr(),
                   active.data_ptr(), voff.data_ptr(), vstart.data_ptr(),
                   vidx.data_ptr(), scal.data_ptr(), seeds.data_ptr(),
                   extra.data_ptr(), recs.data_ptr(), partial.data_ptr(),
                   pmask.data_ptr(), pscal.data_ptr(), g_tab.data_ptr(),
                   g_scal.data_ptr(), loss.data_ptr(), n,
                   *_stream_args(cfg, tab), *_cfg_args(cfg), loss_id,
                   ctypes.c_float(lscale), stream)
    _build.check(err, kernel)
    launch_counts[kernel] += 1
    return loss, g_tab, g_scal


def stream_grad_shape(kernel: str, cfg: FusedConfig, dt: int, device=None):
    """The shapes of K6's (``fused_stream_backward``) or K7's two kernels at
    this configuration (needs the card): B2's warps per block, resident
    blocks per SM (the occupancy API) and dynamic shared memory in bytes,
    the same of B1's, and the floats of a pixel's record."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    return dict(zip(("warps", "blocks_per_sm", "smem", "b1_warps",
                     "b1_blocks_per_sm", "b1_smem", "record_floats"),
                    _stream_shape(kernel, dt, cfg.tex_d,
                                  _AGG_IDS[cfg.agg_kind], cfg.s_agg,
                                  dev.index or 0)))


@functools.lru_cache(maxsize=None)
def _stream_shape(kernel, dt, tex_d, agg_id, s_agg, device_index):
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    fn_c = (lib.pt_stream_backward_occupancy
            if kernel == "fused_stream_backward"
            else lib.pt_stream_loss_grad_occupancy)
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device_index):
        _build.check(fn_c(dt, tex_d, agg_id, s_agg, ctypes.addressof(out)),
                     kernel)
    return tuple(out)


def fused_stream_backward(cfg: FusedConfig, tab, rows, count, active, scal,
                          seeds, g_out):
    """K6: the stream backward (replaces ``_stream_backward_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  Returns (g_tab (N, rw, Dt)
    in sorted order, g_scal (N, 34)), as :func:`stream_backward_plain`."""
    dev = _check_stream(cfg, tab, rows, count, active, scal, seeds,
                        "fused_stream_backward")
    s = cfg.image_size
    _check("fused_stream_backward", tab, {
        "g_out": (g_out, (tab.shape[0], s, s, 4), torch.float32)})
    if dev.type == "cpu":
        return stream_backward_plain(cfg, tab, rows, count, active, scal,
                                     seeds, g_out)
    return _launch_stream_grads("fused_stream_backward", cfg, tab, rows,
                                count, active, scal, seeds, g_out, 0,
                                0.0)[1:]


def fused_stream_loss_grad(cfg: FusedConfig, tab, rows, count, active, scal,
                           seeds, target, loss_kind: str, lscale: float):
    """K7: image loss and every gradient of the stream route in one launch
    (replaces ``_stream_loss_grad_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py``).  ``target``: (N, 3, H*W).
    Returns (loss (N,), g_tab, g_scal) as :func:`stream_loss_grad_plain`."""
    dev = _check_stream(cfg, tab, rows, count, active, scal, seeds,
                        "fused_stream_loss_grad")
    hw = cfg.image_size * cfg.image_size
    _check("fused_stream_loss_grad", tab, {
        "target": (target, (tab.shape[0], 3, hw), torch.float32)})
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"fused_stream_loss_grad: loss_kind {loss_kind!r}, "
                         f"expected one of {LOSS_KINDS}")
    if dev.type == "cpu":
        return stream_loss_grad_plain(cfg, tab, rows, count, active, scal,
                                      seeds, target, loss_kind, lscale)
    return _launch_stream_grads("fused_stream_loss_grad", cfg, tab, rows,
                                count, active, scal, seeds, target,
                                LOSS_KINDS.index(loss_kind), lscale)


class _FusedStream(torch.autograd.Function):
    """Autograd boundary of the stream render: K5 forward, K6 backward.
    rows, count, active and seeds get no gradient."""

    @staticmethod
    def forward(ctx, cfg, tab, scal, rows, count, active, seeds):
        ctx.cfg = cfg
        ctx.save_for_backward(tab, scal, rows, count, active, seeds)
        return fused_stream_forward(cfg, tab, rows, count, active, scal,
                                    seeds)

    @staticmethod
    def backward(ctx, g):
        tab, scal, rows, count, active, seeds = ctx.saved_tensors
        g_tab, g_scal = fused_stream_backward(ctx.cfg, tab, rows, count,
                                              active, scal, seeds,
                                              g.contiguous())
        return None, g_tab, g_scal, None, None, None, None


class _FusedStreamLoss(torch.autograd.Function):
    """Autograd boundary of K7: the forward returns the summed loss and
    keeps K7's gradients; the backward only scales them."""

    @staticmethod
    def forward(ctx, cfg, loss_kind, lscale, tab, scal, rows, count, active,
                seeds, target):
        loss, g_tab, g_scal = fused_stream_loss_grad(
            cfg, tab, rows, count, active, scal, seeds, target, loss_kind,
            lscale)
        ctx.save_for_backward(g_tab, g_scal)
        return loss.sum()

    @staticmethod
    def backward(ctx, g):
        g_tab, g_scal = ctx.saved_tensors
        return (None, None, None, g * g_tab, g * g_scal, None, None, None,
                None, None)


class _FusedStreamSharded(torch.autograd.Function):
    """Autograd boundary of the stream route under sample-axis sharding
    (the JAX ``_fused_core_stream_sharded``): only the aggregation samples
    shard (the coverage seeds are the same on every rank), so K5's image
    and K6's gradients are each linear in per-rank sample means and the
    group averages them."""

    @staticmethod
    def forward(ctx, cfg, axis, tab, scal, rows, count, active, seeds):
        ctx.cfg, ctx.axis = cfg, axis
        ctx.save_for_backward(tab, scal, rows, count, active, seeds)
        return sharding.axis_mean(fused_stream_forward(
            cfg, tab, rows, count, active, scal, seeds), axis)

    @staticmethod
    def backward(ctx, g):
        tab, scal, rows, count, active, seeds = ctx.saved_tensors
        g_tab, g_scal = sharding.axis_mean(list(fused_stream_backward(
            ctx.cfg, tab, rows, count, active, scal, seeds, g.contiguous())),
            ctx.axis)
        return None, None, g_tab, g_scal, None, None, None, None


# ---------------------------------------------------------------------------
# Routing + inputs
# ---------------------------------------------------------------------------

# Estimator class -> (kind, noise, variance reduction).  VR changes only
# the backward, so the VR and no-VR members share a forward.
_RAST_MAP = {
    "SoftRast": ("soft", "gaussian", True),
    "GaussianRast": ("mc", "gaussian", True),
    "GaussianRast_wovr": ("mc", "gaussian", False),
    "ArctanRast": ("mc", "cauchy", True),
    "AffineRast": ("affine", "gaussian", True),
    "HardRast": ("hard", "gaussian", True),
}

_AGG_MAP = {
    "SoftAgg": ("soft", "gaussian", True),
    "GaussianAgg": ("mc", "gaussian", True),
    "GaussianAgg_wovr": ("mc", "gaussian", False),
    "CauchyAgg": ("mc", "cauchy", True),
    "HardAgg": ("hard", "gaussian", True),
}


def _plan(meshes, lights, smoothrast, smoothagg, settings, shade: str
          ) -> tuple[Optional[FusedConfig], str]:
    """(config, "") with the static configuration of the fused route the
    JAX package takes: flat (every face holds a slot), stream (F >
    faces_per_pixel) or binned (F > _COARSE_THRESHOLD with
    ``bin_overflow='allow'`` at a binnable size).  Where the JAX ``_plan``
    declines, (None, the reason): the caller takes the staged route.
    Estimators with a ``sample_axis`` plan the sharded route
    (``prob_ext``): flat for MC / MC pairs sharding one axis, stream with
    the aggregation samples sharded; the JAX package's reasons decline
    the rest."""
    from pertrenderer_tpu_torch.lights import DirectionalLights, PointLights
    from pertrenderer_tpu_torch.textures import (TexturesAtlas, TexturesUV,
                                                 TexturesVertex)

    rast_entry = _RAST_MAP.get(type(smoothrast).__name__)
    agg_entry = _AGG_MAP.get(type(smoothagg).__name__)
    if rast_entry is None or agg_entry is None:
        return None, ("estimator pair (%s, %s) is not a fused menu member"
                      % (type(smoothrast).__name__, type(smoothagg).__name__))
    # Sample-axis sharding covers the flat MC / MC pairs and the stream
    # route with an MC aggregation; both estimators shard one axis.  Other
    # combinations take the staged route, whose estimators average over the
    # sample group themselves.
    ax_r = getattr(smoothrast, "sample_axis", None)
    ax_a = getattr(smoothagg, "sample_axis", None)
    sample_axis = ax_r or ax_a
    if (sample_axis is not None and ax_r is not None and ax_a is not None
            and ax_r != ax_a):
        return None, ("sample-axis sharding requires both estimators to "
                      "shard the same mesh axis")
    if sample_axis is not None and agg_entry[0] != "mc":
        return None, ("sample-axis sharding requires an MC aggregation "
                      "estimator")
    f = int(meshes.max_faces)
    k = int(settings.faces_per_pixel)
    size = int(settings.image_size)
    hw = size * size
    f_pad = f_real = _round_up(max(f, 8), 8)
    stream, binned, rw, tile_w = False, False, 0, 0
    if f > k or f_pad > MAX_SLOTS:
        # The binned route is an approximation where a tile's candidates
        # exceed its slots, so the user opts in (the JAX package's
        # PERTRENDERER_STREAM=off, an environment switch, is not ported).
        m = min(f_pad, int(settings.max_faces_per_bin or MAX_BIN_SLOTS),
                MAX_BIN_SLOTS)
        bin_ok = m >= 8 and _BIN_P_TILE < size and size % _BIN_P_TILE == 0
        if (bin_ok and settings.bin_overflow == "allow"
                and f > _COARSE_THRESHOLD):
            if sample_axis is not None:
                return None, ("sharded fused path covers the flat and "
                              "streaming modes (binned is not sharded)")
            binned = True
            f_pad = f_real = _round_up(m, 8)     # every slot row is live
            p_tile = _BIN_P_TILE
        else:
            stream, rw = True, _round_up(f, STREAM_CHUNK)
            f_pad = f_real = STREAM_CHUNK
            th, tw = _STREAM_TILE[0], min(_STREAM_TILE[1], size)
            if (th * tw) % 128 == 0 and size % tw == 0 and size % th == 0:
                p_tile, tile_w = th * tw, tw
            else:
                p_tile = min(_BIN_P_TILE, _round_up(hw, 128))
    if size > 2048:
        return None, "image size above the 2048 fused-kernel limit"
    if sample_axis is not None and not stream:
        # Flat sharding averages both estimators' sample means (the
        # coverage before the nonlinear z_map); the stream route shards
        # the aggregation samples only.
        if ax_r != ax_a:
            return None, ("flat-mode sharding requires both estimators to "
                          "shard the same mesh axis")
        if rast_entry[0] != "mc":
            return None, ("flat-mode sharding covers the MC/MC estimator "
                          "pairs only")
    if not stream and not binned:
        p_tile = min(2048 if f_pad <= 16 else 1024, _round_up(hw, 128))
        th = p_tile // 64 if p_tile % 64 == 0 else 0
        if th > 1 and size > 64 and size % 64 == 0 and size % th == 0:
            tile_w = 64

    tex = meshes.textures
    if tex is None:
        return None, "mesh has no textures"
    if isinstance(tex, TexturesVertex):
        if tex.verts_features.shape[-1] != 3:
            return None, "TexturesVertex features must be RGB (3 channels)"
        tex_mode, tex_d, atlas_r = "corner", 9, 0
    elif isinstance(tex, TexturesAtlas):
        r = tex.atlas.shape[2]
        if tex.atlas.shape[-1] != 3 or r > 8:
            return None, "TexturesAtlas must be RGB with resolution <= 8"
        tex_mode, tex_d, atlas_r = "atlas", r * r * 3, r
    elif isinstance(tex, TexturesUV):
        r = tex.atlas_size
        if not r or r > 8 or tex.maps.shape[-1] != 3:
            return None, "TexturesUV needs atlas_size in 1..8 and RGB maps"
        tex_mode, tex_d, atlas_r = "atlas", r * r * 3, r
    else:
        return None, "unsupported texture type %s" % type(tex).__name__

    if isinstance(lights, PointLights):
        light_kind = "point"
    elif isinstance(lights, DirectionalLights):
        light_kind = "directional"
    else:
        return None, "unsupported light type %s" % type(lights).__name__

    (rast_kind, rast_noise, rast_vr), (agg_kind, agg_noise, agg_vr) = \
        rast_entry, agg_entry
    return FusedConfig(
        image_size=size, f_pad=f_pad,
        f_real=f_real if stream or binned else f, k=k,
        rast_kind=rast_kind, rast_noise=rast_noise, rast_vr=rast_vr,
        s_rast=int(getattr(smoothrast, "nb_samples", 1)),
        agg_kind=agg_kind, agg_noise=agg_noise, agg_vr=agg_vr,
        s_agg=int(getattr(smoothagg, "nb_samples", 1)),
        eps_bg=float(smoothagg.eps), shade=shade, light_kind=light_kind,
        tex_mode=tex_mode, tex_d=tex_d, atlas_r=atlas_r,
        clip_bary=settings.resolve_clip(),
        perspective_correct=bool(settings.perspective_correct),
        p_tile=p_tile, tile_w=tile_w, stream=stream, binned=binned,
        rw=rw, prob_ext=sample_axis is not None), ""


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """Static routing report.  ``flat``: every face holds a slot
    (F <= faces_per_pixel); ``stream``: the faces are sorted into 64-row
    chunks and each tile streams the chunks its list names.  Both are
    exact.  ``binned``: each tile renders its own nearest-``slots`` faces
    (opted in with ``bin_overflow='allow'``; approximate where a tile's
    candidates exceed its slots, which ``capacity_stats`` measures).
    ``staged``: the composed pipeline (rasterize, shade, blend; ``reason``
    says why the fused routes decline).  ``prob_ext``: the flat or stream
    route under sample-axis sharding."""

    mode: str
    reason: str
    f: int
    k: int
    image_size: int
    p_tile: int = 0
    tile: tuple = ()
    slots: int = 0          # flat / binned: slot rows
    table_rows: int = 0     # stream: sorted-table rows (chunk multiple)
    prob_ext: bool = False  # sample-axis sharded


def render_plan(meshes, lights, smoothrast, smoothagg, settings,
                shade: str = "phong") -> RenderPlan:
    """The route :func:`try_render` takes (``staged`` when it declines)."""
    cfg, why = _plan(meshes, lights, smoothrast, smoothagg, settings, shade)
    f = int(meshes.max_faces)
    if cfg is None:
        return RenderPlan(mode="staged", reason=why, f=f,
                          k=int(settings.faces_per_pixel),
                          image_size=int(settings.image_size))
    tile = ((cfg.p_tile // cfg.tile_w, cfg.tile_w) if cfg.tile_w
            else (1, cfg.p_tile))
    if cfg.stream:
        return RenderPlan(
            mode="stream", f=f, k=cfg.k, image_size=cfg.image_size,
            p_tile=cfg.p_tile, tile=tile, table_rows=cfg.rw,
            prob_ext=cfg.prob_ext,
            reason="F > faces_per_pixel; chunk-streamed y-sorted windows "
                   "(exact at any coverage density)")
    if cfg.binned:
        return RenderPlan(
            mode="binned", f=f, k=cfg.k, image_size=cfg.image_size,
            p_tile=cfg.p_tile, tile=tile, slots=cfg.f_pad,
            reason="explicitly opted in (bin_overflow='allow' or "
                   "PERTRENDERER_STREAM=off): per-tile nearest-%d slots "
                   "(max_faces_per_bin regime; approximate under detected "
                   "overflow)" % cfg.f_pad)
    return RenderPlan(
        mode="flat", f=f, k=cfg.k, image_size=cfg.image_size,
        p_tile=cfg.p_tile, tile=tile, slots=cfg.f_pad, prob_ext=cfg.prob_ext,
        reason="every face holds a slot (F <= faces_per_pixel); exact, no "
               "selection")


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
               fixed_noise: bool = False, device="cuda") -> torch.Tensor:
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


def sample_offset(word: torch.Tensor, index: int,
                  n_samples: int) -> torch.Tensor:
    """Seed word 0 of a rank ``index`` of a sample group drawing
    ``n_samples`` each: the hash enters the sample s as seed0 + s *
    0x9E3779B9, so adding index * S * 0x9E3779B9 gives rank d the samples
    [d S, (d + 1) S) of one sequence, and the group's draws are one run's
    at its total sample count.  Computed in int64 and wrapped to int32
    (the JAX package's int32 arithmetic)."""
    w = word.to(torch.int64) + index * n_samples * (_C_SAMPLE - (1 << 32))
    return ((w + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def shard_seeds(cfg: FusedConfig, seeds: torch.Tensor,
                index: int) -> torch.Tensor:
    """The (N, 4) seed words of rank ``index`` of a sample group
    (:func:`sample_offset`): flat, the coverage (word 0) and aggregation
    (word 2) words; stream, the aggregation word only."""
    out = seeds.to(torch.int32).clone()
    if not cfg.stream:
        out[:, 0] = sample_offset(seeds[:, 0], index, cfg.s_rast)
    out[:, 2] = sample_offset(seeds[:, 2], index, cfg.s_agg)
    return out.contiguous()


def _face_valid(meshes, fv_ndc, settings) -> torch.Tensor:
    """(N, F) bool: the mesh's real faces, less the back faces when the
    settings cull them (by the sign of the NDC area)."""
    face_ids = torch.arange(meshes.max_faces, device=fv_ndc.device)
    validf = ((face_ids[None, :] < meshes.num_faces[:, None])
              & torch.all(meshes.faces >= 0, dim=-1))
    if settings.cull_backfaces:
        area = ((fv_ndc[..., 3] - fv_ndc[..., 0])
                * (fv_ndc[..., 7] - fv_ndc[..., 1])
                - (fv_ndc[..., 4] - fv_ndc[..., 1])
                * (fv_ndc[..., 6] - fv_ndc[..., 0]))
        validf = validf & (area > 0)
    return validf


def _prepare_inputs(cfg: FusedConfig, meshes, cameras, lights, materials,
                    smoothrast, smoothagg, blend_params, settings, seeds,
                    shade: str, blur_override=None, sample_axis=None):
    """The kernels' tensor inputs.  Flat: face tables, validity, packed
    scalars, seed words and the tiles' activity bits
    (:func:`forward_plain` documents the shapes); binned: the same with
    per-tile tables (N, nt, M, .) and slot validity (N, nt, M)
    (``ops/binned.py``).  Stream: (tab, scal, rows, count, active, seeds),
    the order of the JAX package (:func:`stream_forward_plain`).  Under
    sample-axis sharding (``cfg.prob_ext``) the seed words are this rank's
    of the group ``sample_axis`` (:func:`shard_seeds`)."""
    from pertrenderer_tpu_torch.textures import TexturesUV, TexturesVertex

    n, f, dev = meshes.batch_size, meshes.max_faces, meshes.device
    blur = settings.blur_radius if blur_override is None else blur_override

    # Every per-vertex table in one row gather (K9a on the card), whose
    # backward is one deterministic segment sum (K9b), not an atomic
    # scatter: (N, F, 3, C) split into (N, F, 3 c) tables.
    tex = meshes.textures
    columns = [cameras.transform_points_ndc(meshes.verts), meshes.verts]
    if shade == "phong":
        columns.append(meshes.verts_normals())
    if cfg.tex_mode == "corner":
        columns.append(tex.verts_features.expand(
            (n,) + tuple(tex.verts_features.shape[1:])))
    corners = take_rows_batched(torch.cat(columns, dim=-1),
                                torch.clamp(meshes.faces, min=0))
    tables = [t.reshape(n, f, -1) for t in torch.split(
        corners, [c.shape[-1] for c in columns], dim=-1)]
    fv_ndc, fv_world = tables[0], tables[1]
    fn_world = tables[2] if shade == "phong" else torch.zeros_like(fv_world)
    if cfg.tex_mode == "corner":
        tex_tab = tables[-1]
    else:
        atlas = tex._bake_atlas() if isinstance(tex, TexturesUV) \
            else tex.atlas
        atlas = atlas.expand((n,) + tuple(atlas.shape[1:]))
        tex_tab = atlas.reshape(n, f, -1)

    validf = _face_valid(meshes, fv_ndc, settings)
    scal = _pack_scal(cfg, n, cameras, lights, materials, smoothrast,
                      smoothagg, blend_params, blur, dev)
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.from_numpy(np.array(seeds, dtype=np.int32))
    seeds = seeds.to(device=dev, dtype=torch.int32)
    seeds = seeds.reshape(n, -1)[:, :4].contiguous()
    if cfg.prob_ext and sample_axis is not None:
        seeds = shard_seeds(cfg, seeds, sharding.axis_info(sample_axis).index)
    if cfg.stream:
        merged = torch.cat([fv_ndc, fv_world, fn_world, tex_tab], dim=-1)
        validf = validf.to(torch.float32)
        tab, rows, count, _perm = _stream_tables(
            cfg, merged, fv_ndc, validf, scal[:, _S_BLUR])
        active = _active_tiles(cfg, fv_ndc, validf, scal[:, _S_BLUR])
        return tab, scal, rows, count, active, seeds
    if cfg.binned:
        from pertrenderer_tpu_torch.ops import binned

        merged = torch.cat([fv_ndc, fv_world, fn_world, tex_tab], dim=-1)
        tables, valid, active = binned.binned_inputs(
            cfg, merged, fv_ndc, validf.to(torch.float32), scal[:, _S_BLUR])
        return (*tables, valid, scal, seeds, active)
    pad = lambda x: torch.nn.functional.pad(
        x, (0, 0, 0, cfg.f_pad - f)).contiguous()
    valid = torch.nn.functional.pad(validf.to(torch.float32),
                                    (0, cfg.f_pad - f)).contiguous()
    fv_ndc = pad(fv_ndc)
    active = _active_tiles(cfg, fv_ndc, valid, scal[:, _S_BLUR])
    return (fv_ndc, pad(fv_world), pad(fn_world), pad(tex_tab), valid, scal,
            seeds, active)


def _sample_axis(smoothrast, smoothagg) -> Optional[str]:
    """The mesh axis the estimators shard their samples over, or None."""
    return (getattr(smoothrast, "sample_axis", None)
            or getattr(smoothagg, "sample_axis", None))


def _inputs_for(cfg, meshes, cameras, lights, materials, smoothrast,
                smoothagg, blend_params, settings, shade, seeds, generator,
                blur_override):
    if seeds is None:
        seeds = draw_seeds(meshes.batch_size, generator,
                           getattr(smoothagg, "fixed_noise", False),
                           device=meshes.device)
    return _prepare_inputs(cfg, meshes, cameras, lights, materials,
                           smoothrast, smoothagg, blend_params, settings,
                           seeds, shade, blur_override=blur_override,
                           sample_axis=_sample_axis(smoothrast, smoothagg))


def try_render(cfg: FusedConfig, meshes, cameras, lights, materials,
               smoothrast, smoothagg, blend_params, settings, shade: str,
               seeds=None, generator: Optional[torch.Generator] = None,
               blur_override=None) -> torch.Tensor:
    """Render (N, H, W, 4) RGBA through the flat fused forward (K3, its
    gradients from K4), for F > faces_per_pixel the stream forward (K5, its
    gradients from K6), or binned K12's forward (its gradients from K12's
    backward, then K9b into the face tables).  Under sample-axis sharding
    (``cfg.prob_ext``): flat K11a, K3 with external coverage, K11b and
    K11c averaged over the sample group; stream K5 / K6 with the
    aggregation samples sharded.  ``cfg`` is ``_plan``'s configuration for
    these arguments (the caller takes the staged route where it has
    none).

    ``seeds``: (N, 4) int32 seed words, or JAX-layout (N, 1, 8) seed rows
    whose first four columns are used; drawn from ``generator`` when
    None.  Sharded, every rank of a sample group passes the same words
    (the same generator state); each draws its own samples from them."""
    inputs = _inputs_for(cfg, meshes, cameras, lights, materials, smoothrast,
                         smoothagg, blend_params, settings, shade, seeds,
                         generator, blur_override)
    axis = _sample_axis(smoothrast, smoothagg)
    if cfg.stream:
        if cfg.prob_ext:
            return _FusedStreamSharded.apply(cfg, axis, *inputs)
        return _FusedStream.apply(cfg, *inputs)
    if cfg.prob_ext:
        return _FusedSharded.apply(cfg, axis, *inputs)
    return _FusedForward.apply(cfg, *inputs)


def try_render_loss(cfg: FusedConfig, meshes, cameras, lights, materials,
                    smoothrast, smoothagg, blend_params, settings,
                    shade: str, target, loss_kind: str = "l2_rgb", seeds=None,
                    generator: Optional[torch.Generator] = None,
                    blur_override=None) -> Optional[torch.Tensor]:
    """Mean image loss (``l2_rgb``: squared, ``l1_rgb``: absolute error
    over the RGB channels of every pixel and batch element) against
    ``target``, with the loss and every gradient from one launch of K2
    (flat), K7 (stream) or K12's loss-and-grad (binned).

    ``target`` broadcasts to (N, H, W, 3) and is a constant: it gets no
    gradient.  ``cfg`` and seeds as for :func:`try_render`.  None for the
    sharded route, which has no loss-and-grad kernel (the JAX package's
    rule): the caller renders and reduces the loss."""
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss_kind {loss_kind!r} (expected "
                         "'l2_rgb' or 'l1_rgb')")
    if cfg.prob_ext:
        return None
    inputs = _inputs_for(cfg, meshes, cameras, lights, materials, smoothrast,
                         smoothagg, blend_params, settings, shade, seeds,
                         generator, blur_override)
    n, s = meshes.batch_size, cfg.image_size
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=meshes.device).detach()
    target_cm = target.broadcast_to((n, s, s, 3)).permute(0, 3, 1, 2)
    target_cm = target_cm.reshape(n, 3, s * s).contiguous()
    lscale = 1.0 / (n * s * s * 3)
    if cfg.stream:
        return _FusedStreamLoss.apply(cfg, loss_kind, lscale, *inputs,
                                      target_cm)
    return _FusedLoss.apply(cfg, loss_kind, lscale, *inputs, target_cm)
