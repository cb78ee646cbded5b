"""The binned route (PyTorch port of the binned mode of
``pertrenderer_tpu/ops/fused_render.py``), with kernel K12.

A mesh above ``_COARSE_THRESHOLD`` faces whose user opts in with
``RasterizationSettings(bin_overflow='allow')`` renders through per-tile
slot tables: each tile of ``_BIN_P_TILE`` row-major pixels (a strip of a
pixel row) keeps the M <= 160 faces that ``_binned_tables_sorted`` selects
for it, covering faces first, then the faces nearest the local front.
Where a tile's candidates exceed M the farthest are dropped: an
approximation that ``capacity_stats`` measures and ``check_capacity_host``
reports under the settings' policy.

* Selection (plain PyTorch, batched over N): ``_front_rel_scores``, the
  direct per-tile nearest-M ``_bin_face_ids`` (the oracle) and the y-sorted
  contiguous-window ``_binned_tables_sorted`` the route runs.  Ties break
  by the lower index, as ``jax.lax.top_k`` and ``jnp.argsort`` do: every
  sort is ``torch.sort(..., stable=True)``, because the slot order keys
  the MC noise.  The per-tile tables are one row gather of the face table
  by face id (K9a on the card), whose backward is K9b's deterministic
  segment sum, in place of the JAX package's permutation, window slices
  and one-hot matmul.
* K12 ``fused_binned_forward`` / ``fused_binned_backward`` /
  ``fused_binned_loss_grad`` (csrc/fused_binned.cu, csrc/binned_warp.cuh):
  a warp per pixel with the tile's slots across its lanes, only the
  pixel's candidates shaded, sampled and differentiated, the tables by
  one bulk asynchronous copy, inactive tiles left at once; the
  aggregation (and the gradients' adjoints) in double; and their plain
  versions
  ``binned_forward_plain`` / ``binned_backward_plain`` /
  ``binned_loss_grad_plain``, which run the flat plain pipeline over blocks
  of tiles with the aggregation in float64.  The noise keys are the
  bin-local slot row and the absolute pixel id, as in JAX.

A wrapper takes its plain version only for tensors on the CPU.  For a CUDA
tensor it launches its kernel or raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import Optional

import numpy as np
import torch

from pertrenderer_tpu_torch.ops import fused_render as fr
from pertrenderer_tpu_torch.ops.gather import take_rows_batched

__all__ = ["capacity_stats", "check_capacity_host", "fused_binned_forward",
           "binned_forward_plain", "fused_binned_backward",
           "binned_backward_plain", "fused_binned_loss_grad",
           "binned_loss_grad_plain"]

_RANGE_GROUP = 16         # tiles per range group
_RANGE_MAX = 16384        # face rows of a group's contiguous window
TILE_BLOCK = 128          # tile tables per pass of the plain versions


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------

def _tile_y_ranges(cfg, device):
    """Each strip tile's NDC y span (y_hi, y_lo), (nt,) float32."""
    y_hi, y_lo = fr._tile_rects(cfg)[:2]
    return fr._f32(y_hi, device), fr._f32(y_lo, device)


def _x_of(w: int, c):
    """NDC x of pixel column c (float32; decreasing in c)."""
    return (w - 1.0 - 2.0 * c.to(torch.float32)) / w


def _front_rel_scores(cfg, overlap, covers, xlo, xhi, fz):
    """Selection score under slot overflow (the JAX ``_front_rel_scores``):
    covering faces first (a 1e4 tier bonus), then band-only faces, each
    tier ranked by depth relative to the front of the face's column group
    (the nearest candidate depth among the faces spanning that group, or
    the tile's).  overlap / covers (N, nt, R) bool; xlo / xhi / fz
    broadcast to it.  Returns (N, nt, R) float32, -inf off the
    candidates."""
    w = cfg.image_size
    nt, dev = overlap.shape[-2], overlap.device
    p = min(cfg.p_tile, w)
    q = max(1, min(16, p // 8))          # column groups of >= 8 px
    gw = p // q
    if cfg.p_tile < w and w % cfg.p_tile == 0:
        c0 = (torch.arange(nt, dtype=torch.int32, device=dev)
              * cfg.p_tile) % w
    else:
        c0 = torch.zeros(nt, dtype=torch.int32, device=dev)
    fz_, xlo_, xhi_ = (t.expand_as(overlap) for t in (fz, xlo, xhi))
    xc = 0.5 * (xlo_ + xhi_)
    cf = 0.5 * (w - 1.0 - w * xc)
    c0f = c0.to(torch.float32).view(1, nt, 1)
    grp = torch.clamp(((cf - c0f) / gw).to(torch.int32), 0, q - 1)
    inf = torch.full((), math.inf, device=dev)
    tile_front = torch.amin(torch.where(overlap, fz_, inf), dim=-1,
                            keepdim=True)
    front = tile_front.expand_as(overlap)
    for j in range(q):
        x_a = _x_of(w, c0 + j * gw).view(1, nt, 1)
        x_b = _x_of(w, c0 + (j + 1) * gw - 1).view(1, nt, 1)
        og = overlap & (xlo_ <= x_a) & (xhi_ >= x_b)
        fj = torch.amin(torch.where(og, fz_, inf), dim=-1, keepdim=True)
        fj = torch.where(torch.isfinite(fj), fj, tile_front)
        front = torch.where(grp == j, fj, front)
    tier = torch.where(covers, torch.full((), 1e4, device=dev),
                       torch.zeros((), device=dev))
    return torch.where(overlap, tier + front - fz_, -inf)


def _top_slots(score, m: int):
    """(values, positions) of the m largest scores along the last axis,
    ties to the lower position (``jax.lax.top_k``)."""
    vals, pos = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :m], pos[..., :m]


def _bin_face_ids(cfg, fv_ndc, valid, blur):
    """Bin-local face lists by direct per-tile selection (the JAX
    ``_bin_face_ids``): the M faces overlapping each tile nearest its
    local front.  fv_ndc (N, F, 9), valid (N, F), blur (N,).  Returns
    (ids (N, nt, M) int64, -1 padded; counts (N, nt) candidate faces)."""
    m = cfg.f_pad
    fv = fv_ndc.detach()
    n, f = fv.shape[:2]
    validb = fr._face_validb(fv, valid)
    band = torch.sqrt(torch.clamp(blur, min=0.0)).view(n, 1)
    xs = fv[..., 0::3]
    fz_min = torch.amin(fv[..., 2::3], dim=-1)
    overlap = fr._tile_face_overlap(cfg, fv, validb, blur)
    covers = fr._tile_face_overlap(cfg, fv, validb, torch.zeros_like(blur))
    counts = torch.sum(overlap.to(torch.int32), dim=-1)
    score = _front_rel_scores(
        cfg, overlap, covers, (torch.amin(xs, dim=-1) - band)[:, None, :],
        (torch.amax(xs, dim=-1) + band)[:, None, :], fz_min[:, None, :])
    top, idx = _top_slots(score, min(m, f))
    out = torch.where(torch.isfinite(top), idx, -1)
    if m > f:
        out = torch.nn.functional.pad(out, (0, m - f), value=-1)
    return out, counts


def _face_bounds(fv_ndc, valid, blur):
    """Per face: validity, the blur-grown bbox (lo, hi, xlo, xhi) and the
    nearest corner depth fz, each (N, F); the band (N, 1)."""
    fv = fv_ndc.detach()
    n = fv.shape[0]
    validb = fr._face_validb(fv, valid)
    band = torch.sqrt(torch.clamp(blur, min=0.0)).view(n, 1)
    ys, xs = fv[..., 1::3], fv[..., 0::3]
    return (validb, torch.amin(ys, dim=-1) - band,
            torch.amax(ys, dim=-1) + band, torch.amin(xs, dim=-1) - band,
            torch.amax(xs, dim=-1) + band, torch.amin(fv[..., 2::3], dim=-1),
            band)


def _group_windows(cfg, validb, lo, hi):
    """The y-sorted windows of the range groups (the JAX
    ``_binned_tables_sorted`` / ``capacity_stats``): (perm (N, F), the
    windows' true starts s_g and ends e_g (N, ng), the tile spans y_hi_t /
    y_lo_t (nt,))."""
    dev = lo.device
    nt, g = fr._n_tiles(cfg), _RANGE_GROUP
    ng = -(-nt // g)
    key = torch.where(validb, lo, torch.full((), math.inf, device=dev))
    sk, perm = torch.sort(key, dim=1, stable=True)
    maxext = torch.amax(torch.where(validb, hi - lo,
                                    torch.zeros((), device=dev)), dim=1)
    y_hi_t, y_lo_t = _tile_y_ranges(cfg, dev)
    pad_t = ng * g - nt
    y_hi_g = torch.amax(torch.nn.functional.pad(
        y_hi_t, (0, pad_t), value=-math.inf).view(ng, g), dim=1)
    y_lo_g = torch.amin(torch.nn.functional.pad(
        y_lo_t, (0, pad_t), value=math.inf).view(ng, g), dim=1)
    n = lo.shape[0]
    e_g = torch.searchsorted(sk, y_hi_g.expand(n, ng).contiguous(),
                             right=True)
    s_g = torch.searchsorted(sk, (y_lo_g[None] - maxext[:, None])
                             .contiguous(), right=False)
    return perm, s_g, e_g, y_hi_t, y_lo_t


def _binned_tables_sorted(cfg, merged, fv_ndc, valid, blur):
    """Y-sorted contiguous-window binning (the JAX
    ``_binned_tables_sorted``), batched: the faces are sorted by their
    blur-grown bbox y-min, each group of _RANGE_GROUP tiles draws its
    candidates from the window [cs_g, cs_g + rmax) of that order (its true
    range's start, clamped so the window fits; a true range longer than
    _RANGE_MAX rows is cut, which ``max_range`` shows), and each tile keeps
    its nearest-M by ``_front_rel_scores``.

    merged (N, F, D) = [fv_ndc | fv_world | fn | tex]; fv_ndc (N, F, 9);
    valid (N, F); blur (N,).  Returns (tiles (N, nt, M, D), differentiable
    in ``merged`` through one row gather by face id; ids (N, nt, M) int64,
    the sorted positions of the selected faces, -1 for empty slots; counts
    (N, nt); max_range (N,))."""
    n, f = fv_ndc.shape[:2]
    dev = fv_ndc.device
    nt, m, g = fr._n_tiles(cfg), cfg.f_pad, _RANGE_GROUP
    ng = -(-nt // g)
    w, p = cfg.image_size, cfg.p_tile
    rmax = min(_RANGE_MAX, fr._round_up(f, 8))
    validb, lo, hi, xlo, xhi, fz, band = _face_bounds(fv_ndc, valid, blur)
    perm, s_g, e_g, y_hi_t, y_lo_t = _group_windows(cfg, validb, lo, hi)
    max_range = torch.amax(torch.clamp(e_g - s_g, min=0), dim=1)
    f_rows = max(fr._round_up(f, 8), rmax)
    cs = torch.clamp(s_g, 0, f_rows - rmax)                    # (N, ng)

    # The windows' bbox / depth columns in sorted order; rows past F carry
    # sentinels that fail every overlap test.
    cols = torch.gather(torch.stack([lo, hi, xlo, xhi, fz], dim=-1), 1,
                        perm[..., None].expand(n, f, 5))
    sentinel = torch.tensor([math.inf, -math.inf, math.inf, -math.inf,
                             math.inf], device=dev)
    cols = torch.cat([cols, sentinel.expand(n, f_rows - f, 5)], dim=1)
    rows = cs[..., None] + torch.arange(rmax, device=dev)      # (N, ng, rmax)
    win = torch.gather(cols, 1, rows.reshape(n, -1, 1).expand(-1, -1, 5))
    tile_group = torch.arange(nt, device=dev) // g
    rep = lambda j: win[..., j].view(n, ng, rmax)[:, tile_group]  # (N,nt,R)
    lo_r, hi_r, xlo_r, xhi_r = rep(0), rep(1), rep(2), rep(3)
    band3 = band.view(n, 1, 1)
    y_hi, y_lo = y_hi_t.view(1, nt, 1), y_lo_t.view(1, nt, 1)
    overlap = (lo_r <= y_hi) & (hi_r >= y_lo)
    covers = (lo_r + band3 <= y_hi) & (hi_r - band3 >= y_lo)
    if p < w and w % p == 0:
        c0 = (np.arange(nt) * p) % w
        x_hi = fr._f32((w - 1.0 - 2.0 * c0) / w, dev).view(1, nt, 1)
        x_lo = fr._f32((w - 1.0 - 2.0 * (c0 + p - 1)) / w, dev).view(
            1, nt, 1)
        overlap = overlap & (xlo_r <= x_hi) & (xhi_r >= x_lo)
        covers = covers & (xlo_r + band3 <= x_hi) & (xhi_r - band3 >= x_lo)
    counts = torch.sum(overlap.to(torch.int32), dim=-1)
    score = _front_rel_scores(cfg, overlap, covers & overlap, xlo_r, xhi_r,
                              rep(4))
    top, local = _top_slots(score, min(m, rmax))
    local = torch.where(torch.isfinite(top), local, -1)
    if m > rmax:
        local = torch.nn.functional.pad(local, (0, m - rmax), value=-1)
    start = cs[:, tile_group][..., None]                       # (N, nt, 1)
    ids = torch.where(local >= 0, start + local, -1)
    faces = torch.where(
        ids >= 0, torch.gather(perm, 1, torch.clamp(ids, 0, f - 1).view(
            n, -1)).view(n, nt, -1), -1)
    tiles = take_rows_batched(merged, faces)                   # (N,nt,M,D)
    return tiles, ids, counts, max_range


def binned_inputs(cfg, merged, fv_ndc, validf, blur):
    """The binned branch of ``_prepare_inputs`` (the JAX one, y-sorted
    selection): merged (N, F, D) = [fv_ndc | fv_world | fn | tex], fv_ndc
    (N, F, 9), validf (N, F) float, blur (N,).  Returns the per-tile
    tables (fv_ndc, fv_world, fn, tex) (N, nt, M, .), the slot validity
    (N, nt, M) float32 and the tiles' activity bits (N, nt) int32 (a tile
    is active when it has a filled slot).

    JAX's render-time check (``_check_bin_overflow``) is silent under
    ``bin_overflow='allow'``, and 'allow' is the only policy under which
    the port plans this route (it has no ``PERTRENDERER_STREAM`` switch
    that forces it), so nothing is checked here and the render does not
    sync; ``capacity_stats`` and ``check_capacity_host`` measure and
    report the overflow between renders (``optimize_pose``'s probe)."""
    tiles, ids, _counts, _max_range = _binned_tables_sorted(
        cfg, merged, fv_ndc, validf, blur)
    cuts = [9, 9, 9, tiles.shape[-1] - 27]
    tables = [t.contiguous() for t in torch.split(tiles, cuts, dim=-1)]
    valid = (ids >= 0).to(torch.float32)
    return tables, valid.contiguous(), _active_tiles(valid)


def _active_tiles(valid) -> torch.Tensor:
    """(N, nt) int32 activity bits of the binned tiles (the JAX
    ``_active_tiles`` binned branch): any filled slot."""
    return torch.any(valid > 0.5, dim=-1).to(torch.int32)


def capacity_stats(meshes, cameras, settings, smoothrast=None,
                   smoothagg=None, lights=None, materials=None,
                   shade: str = "phong", blur_override=None, cfg=None):
    """Binned capacity on the current pose (the JAX ``capacity_stats``):
    None unless the scene routes to the binned kernel, else a dict of
    ``max_tile_candidates`` (the worst tile's candidate faces; the result
    is approximate beyond ``slots``), ``slots`` (M), ``max_range`` (the
    worst y-sorted group window) and ``range_limit`` (_RANGE_MAX) as host
    ints.  One device sync.  ``materials`` is taken for the JAX
    signature; the route does not depend on it."""
    if cfg is None:
        from pertrenderer_tpu_torch.lights import PointLights

        lights = lights if lights is not None else PointLights.create(
            device=meshes.device)
        cfg, _why = fr._plan(meshes, lights, smoothrast, smoothagg, settings,
                             shade)
    if cfg is None or not cfg.binned:
        return None
    dev = meshes.device
    n, f = meshes.batch_size, meshes.max_faces
    blur = torch.as_tensor(settings.blur_radius if blur_override is None
                           else blur_override, dtype=torch.float32,
                           device=dev).expand(n)
    with torch.no_grad():
        fv_ndc = take_rows_batched(cameras.transform_points_ndc(meshes.verts),
                                   torch.clamp(meshes.faces, min=0))
        fv_ndc = fv_ndc.reshape(n, f, 9)
        validf = fr._face_valid(meshes, fv_ndc, settings).to(torch.float32)
        validb = fr._face_validb(fv_ndc, validf)
        overlap = fr._tile_face_overlap(cfg, fv_ndc, validb, blur)
        mt = torch.amax(torch.sum(overlap.to(torch.int32), dim=-1))
        if f <= fr._COARSE_THRESHOLD:
            mr = torch.zeros((), dtype=torch.int64, device=dev)
        else:
            _vb, lo, hi, *_rest = _face_bounds(fv_ndc, validf, blur)
            _perm, s_g, e_g, _yh, _yl = _group_windows(cfg, validb, lo, hi)
            mr = torch.amax(torch.clamp(e_g - s_g, min=0))
        mt, mr = torch.stack([mt.to(torch.int64), mr]).tolist()
    return {"max_tile_candidates": mt, "slots": cfg.f_pad, "max_range": mr,
            "range_limit": _RANGE_MAX}


def check_capacity_host(settings, stats) -> Optional[str]:
    """Apply ``settings.bin_overflow`` to ``capacity_stats``' result (the
    JAX ``check_capacity_host``): 'allow' is silent; 'warn' (the default)
    warns and 'error' raises when a tile's candidates exceed its slots or
    a group's range exceeds the window.  Returns the message, else None."""
    if stats is None or getattr(settings, "bin_overflow", "warn") == "allow":
        return None
    msgs = []
    if int(stats["max_tile_candidates"]) > int(stats["slots"]):
        msgs.append("a tile has %d candidate faces > %d bin slots "
                    "(farthest faces dropped)"
                    % (int(stats["max_tile_candidates"]),
                       int(stats["slots"])))
    if int(stats["max_range"]) > int(stats["range_limit"]):
        msgs.append("a y-sorted group range holds %d faces > %d "
                    "(range clamped)"
                    % (int(stats["max_range"]), int(stats["range_limit"])))
    if not msgs:
        return None
    msg = ("binned fused render capacity exceeded: " + "; ".join(msgs)
           + ". Results deviate from the exact top-K semantics; use "
           "streaming mode (the default for large meshes), raise "
           "max_faces_per_bin, or set bin_overflow='allow' to accept.")
    if getattr(settings, "bin_overflow", "warn") == "error":
        raise RuntimeError(msg)
    warnings.warn(msg, stacklevel=2)
    return msg


# ---------------------------------------------------------------------------
# K12 plain versions: the flat plain pipeline over blocks of tiles, each
# tile's tables a batch element of the block (with its element's scalars
# and seed words) at that tile's pixels.
# ---------------------------------------------------------------------------

def _tile_blocks(cfg, n: int):
    """(t0, t1) of the passes over the tiles: TILE_BLOCK tables each."""
    nt = fr._n_tiles(cfg)
    step = max(1, TILE_BLOCK // max(n, 1))
    for t0 in range(0, nt, step):
        yield t0, min(nt, t0 + step)


def _block_args(cfg, tables, valid, scal, seeds, active, t0: int, t1: int):
    """Tiles t0..t1 of every element as one block of B = N (t1 - t0)
    tables for ``fr._render_block``: (tables..., valid, scal, seeds, pos,
    px, py, act).  ``tables``: those tiles' tables (N, t1 - t0, M, .)."""
    n, m = valid.shape[0], valid.shape[2]
    nc, p = t1 - t0, cfg.p_tile
    blk = lambda x: x.reshape(n * nc, m, -1)
    pos, px, py = (a[..., t0 * p:t1 * p].reshape(1, nc, p)
                   .expand(n, nc, p).reshape(n * nc, 1, p)
                   for a in fr._pixel_coords(cfg.image_size, valid.device))
    return ([blk(t) for t in tables]
            + [blk(valid[:, t0:t1])[..., 0],
               scal.repeat_interleave(nc, dim=0),
               seeds.repeat_interleave(nc, dim=0), pos, px, py,
               (active[:, t0:t1] > 0).reshape(n * nc, 1, 1)])


def _cm_block(x, n: int, t0: int, t1: int, p: int):
    """Channel-major (N, C, H*W) -> the tiles' block (N (t1 - t0), C, p)."""
    nc = t1 - t0
    return (x[..., t0 * p:t1 * p].reshape(n, -1, nc, p).transpose(1, 2)
            .reshape(n * nc, -1, p))


def binned_forward_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                         active):
    """Plain version of K12's forward on any device: (N, H, W, 4) RGBA.

    fv_ndc / fv_world / fn (N, nt, M, 9), tex (N, nt, M, tex_d), valid
    (N, nt, M), scal (N, 34), seeds (N, 4) int32, active (N, nt) int32 (the
    order of ``_prepare_inputs``)."""
    n, p, s = fv_ndc.shape[0], cfg.p_tile, cfg.image_size
    tables = (fv_ndc, fv_world, fn, tex)
    out = torch.empty(n, 4, s * s, dtype=torch.float32, device=fv_ndc.device)
    for t0, t1 in _tile_blocks(cfg, n):
        o = fr._render_block(cfg, *_block_args(
            cfg, [t[:, t0:t1] for t in tables], valid, scal, seeds, active,
            t0, t1), agg_dtype=torch.float64)
        out[..., t0 * p:t1 * p] = o.view(n, t1 - t0, 4, p).transpose(
            1, 2).reshape(n, 4, -1)
    return out.transpose(1, 2).reshape(n, s, s, 4)


def _grad_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds, active,
                g_out=None, target=None, loss_kind=None, lscale=0.0):
    """Torch autograd through the plain pipeline, block by block: (loss
    (N,), g_ndc, g_world, g_fn, g_tex (N, nt, M, .), g_scal (N, 34)).  The
    blocks' scalar sums and losses add in float64."""
    n, p = fv_ndc.shape[0], cfg.p_tile
    tables = (fv_ndc, fv_world, fn, tex)
    g_tabs = [torch.zeros_like(t) for t in tables]
    g_scal = torch.zeros(n, fr._NS, dtype=torch.float64,
                         device=fv_ndc.device)
    loss = torch.zeros(n, dtype=torch.float64, device=fv_ndc.device)
    for t0, t1 in _tile_blocks(cfg, n):
        with torch.enable_grad():
            leaves = [t[:, t0:t1].detach().requires_grad_() for t in tables]
            scal_l = scal.detach().requires_grad_()
            args = _block_args(cfg, leaves, valid, scal_l, seeds, active, t0,
                               t1)
            out = fr._render_block(cfg, *args, agg_dtype=torch.float64)
            if target is None:
                value = torch.sum(out * _cm_block(
                    g_out.reshape(n, -1, 4).transpose(1, 2), n, t0, t1, p))
            else:
                per = fr._image_loss(loss_kind, out[:, :3], _cm_block(
                    target, n, t0, t1, p), lscale)
                loss += per.detach().view(n, -1).double().sum(dim=1)
                value = per.sum()
            grads = torch.autograd.grad(value, leaves + [scal_l],
                                        allow_unused=True)
        for g_t, g in zip(g_tabs, grads[:4]):
            if g is not None:
                g_t[:, t0:t1] = g
        if grads[4] is not None:
            g_scal += grads[4].double()
    return (loss.to(torch.float32), *g_tabs, g_scal.to(torch.float32))


def binned_backward_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                          seeds, active, g_out):
    """Plain version of K12's backward: the vector-Jacobian product of
    :func:`binned_forward_plain` with ``g_out`` (N, H, W, 4).  Returns
    (g_ndc, g_world, g_fn, g_tex) (N, nt, M, .) and g_scal (N, 34)."""
    return _grad_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                       active, g_out=g_out)[1:]


def binned_loss_grad_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                           seeds, active, target, loss_kind: str,
                           lscale: float):
    """Plain version of K12's loss-and-grad: the image loss against
    ``target`` (N, 3, H*W) and its gradients.  Returns (loss (N,), g_ndc,
    g_world, g_fn, g_tex, g_scal)."""
    return _grad_plain(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                       active, target=target, loss_kind=loss_kind,
                       lscale=lscale)


# ---------------------------------------------------------------------------
# K12 kernel wrappers
# ---------------------------------------------------------------------------

def _check_binned(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                  active, kernel: str):
    n, nt, m = fv_ndc.shape[0], fr._n_tiles(cfg), cfg.f_pad
    fr._check(kernel, fv_ndc, {
        "fv_ndc": (fv_ndc, (n, nt, m, 9), torch.float32),
        "fv_world": (fv_world, (n, nt, m, 9), torch.float32),
        "fn": (fn, (n, nt, m, 9), torch.float32),
        "tex": (tex, (n, nt, m, cfg.tex_d), torch.float32),
        "valid": (valid, (n, nt, m), torch.float32),
        "scal": (scal, (n, fr._NS), torch.float32),
        "seeds": (seeds, (n, 4), torch.int32),
        "active": (active, (n, nt), torch.int32)})
    if (not cfg.binned or cfg.tile_w or m % 8 or m > fr.MAX_BIN_SLOTS
            or cfg.f_real != m):
        raise ValueError(f"{kernel}: not a binned configuration (f_pad={m}, "
                         f"f_real={cfg.f_real}, tile_w={cfg.tile_w})")
    if cfg.tex_mode == "atlas" and not 1 <= cfg.atlas_r <= 8:
        raise ValueError(f"{kernel}: atlas_r={cfg.atlas_r}")
    dev = fv_ndc.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    return dev


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its storage offset leaves it off the
    16-byte alignment of K12's bulk table copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_binned_forward(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                         active) -> torch.Tensor:
    """K12 forward (replaces ``_forward_kernel`` of
    ``pertrenderer_tpu/ops/fused_render.py`` with ``cfg.binned``): inputs
    as for :func:`binned_forward_plain`; (N, H, W, 4) float32 RGBA."""
    dev = _check_binned(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                        active, "fused_binned_forward")
    if dev.type == "cpu":
        return binned_forward_plain(cfg, fv_ndc, fv_world, fn, tex, valid,
                                    scal, seeds, active)
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    n, s = fv_ndc.shape[0], cfg.image_size
    out = torch.empty((n, s, s, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fv_ndc, fv_world, fn, tex, valid = (_aligned(t) for t in (
        fv_ndc, fv_world, fn, tex, valid))
    with torch.cuda.device(dev):
        err = lib.pt_binned_forward(
            fv_ndc.data_ptr(), fv_world.data_ptr(), fn.data_ptr(),
            tex.data_ptr(), valid.data_ptr(), scal.data_ptr(),
            seeds.data_ptr(), out.data_ptr(), n, *fr._cfg_args(cfg),
            active.data_ptr(), *fr._tiling_args(cfg), stream)
    _build.check(err, "fused_binned_forward")
    fr.launch_counts["fused_binned_forward"] += 1
    return out


def _launch_binned_grads(kernel: str, cfg, tables, active, extra,
                         loss_id: int, lscale: float):
    """Launch K12's backward (``extra`` = g_out) or loss-and-grad
    (``extra`` = target) and return (loss (N,), g_ndc, g_world, g_fn,
    g_tex, g_scal).  Each block writes its tile's gradients into the
    tile's own rows and its scalars (in double) into its own (N, nt, 35)
    row, then a second kernel adds the tiles in order: the same bits from
    run to run."""
    from pertrenderer_tpu_torch import _build

    tables = [_aligned(t) for t in tables[:5]] + list(tables[5:])
    fv_ndc = tables[0]
    dev, n = fv_ndc.device, fv_ndc.shape[0]
    lib = _build.library()
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=dev)
    g_ndc, g_world, g_fn, g_tex = (torch.zeros_like(t) for t in tables[:4])
    pscal = torch.zeros(n, fr._n_tiles(cfg), fr._NS + 1,
                        dtype=torch.float64, device=dev)
    g_scal, loss = zeros(n, fr._NS), zeros(n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn_c = (lib.pt_binned_backward if kernel == "fused_binned_backward"
            else lib.pt_binned_loss_grad)
    with torch.cuda.device(dev):
        err = fn_c(*(t.data_ptr() for t in tables), extra.data_ptr(),
                   pscal.data_ptr(), 0, g_ndc.data_ptr(), g_world.data_ptr(),
                   g_fn.data_ptr(), g_tex.data_ptr(), g_scal.data_ptr(),
                   loss.data_ptr(), n, *fr._cfg_args(cfg), loss_id,
                   ctypes.c_float(lscale), active.data_ptr(),
                   *fr._tiling_args(cfg), stream)
    _build.check(err, kernel)
    fr.launch_counts[kernel] += 1
    return loss, g_ndc, g_world, g_fn, g_tex, g_scal


def fused_binned_backward(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                          seeds, active, g_out):
    """K12 backward (replaces ``_backward_kernel`` with ``cfg.binned``):
    returns (g_ndc, g_world, g_fn, g_tex) (N, nt, M, .) and g_scal (N, 34),
    as :func:`binned_backward_plain`."""
    dev = _check_binned(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                        active, "fused_binned_backward")
    s = cfg.image_size
    fr._check("fused_binned_backward", fv_ndc, {
        "g_out": (g_out, (fv_ndc.shape[0], s, s, 4), torch.float32)})
    if dev.type == "cpu":
        return binned_backward_plain(cfg, fv_ndc, fv_world, fn, tex, valid,
                                     scal, seeds, active, g_out)
    tables = (fv_ndc, fv_world, fn, tex, valid, scal, seeds)
    return _launch_binned_grads("fused_binned_backward", cfg, tables,
                                active, g_out, 0, 0.0)[1:]


def fused_binned_loss_grad(cfg, fv_ndc, fv_world, fn, tex, valid, scal,
                           seeds, active, target, loss_kind: str,
                           lscale: float):
    """K12 loss-and-grad (replaces ``_loss_grad_kernel`` with
    ``cfg.binned``): ``target`` (N, 3, H*W).  Returns (loss (N,), g_ndc,
    g_world, g_fn, g_tex, g_scal) as :func:`binned_loss_grad_plain`."""
    dev = _check_binned(cfg, fv_ndc, fv_world, fn, tex, valid, scal, seeds,
                        active, "fused_binned_loss_grad")
    hw = cfg.image_size * cfg.image_size
    fr._check("fused_binned_loss_grad", fv_ndc, {
        "target": (target, (fv_ndc.shape[0], 3, hw), torch.float32)})
    if loss_kind not in fr.LOSS_KINDS:
        raise ValueError(f"fused_binned_loss_grad: loss_kind {loss_kind!r}, "
                         f"expected one of {fr.LOSS_KINDS}")
    if dev.type == "cpu":
        return binned_loss_grad_plain(cfg, fv_ndc, fv_world, fn, tex, valid,
                                      scal, seeds, active, target, loss_kind,
                                      lscale)
    tables = (fv_ndc, fv_world, fn, tex, valid, scal, seeds)
    return _launch_binned_grads("fused_binned_loss_grad", cfg, tables,
                                active, target, fr.LOSS_KINDS.index(
                                    loss_kind), lscale)
