"""Differentiable mesh rasterization, the staged route's first stage
(PyTorch port of ``pertrenderer_tpu/ops/rasterize.py``).

Two passes, as in the JAX package:

1. **Select** (no gradient, integer output): per pixel, the K nearest
   candidate faces — inside the face or within ``blur_radius`` of its
   edges in signed squared NDC distance, in front of the camera — found
   chunk by chunk with a stable sort of depth that carries the face ids
   (``lax.sort(num_keys=1)``).  Meshes with many faces bin the image
   (``RasterizationSettings.resolve_binning``): each bin keeps the first
   ``max_faces_per_bin`` faces whose blur-expanded box meets it and runs
   the same selection on its own pixels.
2. **Derive** (differentiable): the selected faces' corners are gathered
   per pixel (``ops/gather.py``, kernel K9a; its gradient K9b) and the
   barycentrics, depth and signed distance recomputed from the projected
   vertices, so gradients reach the vertices, the pose and the camera.

Fragments follow PyTorch3D: ``pix_to_face`` (N, H, W, K) per-mesh face ids
by ascending depth, -1 padding; ``zbuf`` view depth and ``dists`` signed
squared distance (negative inside), -1 padding.  ``PlanarFragments`` keeps
the barycentrics as three (N, H, W, K) tensors (the hot path);
``Fragments`` stacks them (N, H, W, K, 3), -1 where empty.  Coordinate
frame: NDC +x left, +y up; image pixel (0, 0) is top-left, NDC (+1, +1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pertrenderer_tpu_torch.ops.gather import (take_rows_batched,
                                               take_rows_cm_batched)

__all__ = ["Fragments", "PlanarFragments", "RasterizationSettings",
           "as_planar", "rasterize_meshes", "rasterize_planar",
           "rasterize_planar_rows"]

_INF = float("inf")


@dataclasses.dataclass
class Fragments:
    """PyTorch3D-layout fragments (the public API)."""

    pix_to_face: torch.Tensor   # (N, H, W, K) int64, per-mesh face id, -1
    zbuf: torch.Tensor          # (N, H, W, K) view depth
    bary_coords: torch.Tensor   # (N, H, W, K, 3)
    dists: torch.Tensor         # (N, H, W, K) signed squared distance


@dataclasses.dataclass
class PlanarFragments:
    """Channel-major fragments: one (N, H, W, K) tensor per barycentric."""

    pix_to_face: torch.Tensor
    zbuf: torch.Tensor
    dists: torch.Tensor
    w0: torch.Tensor
    w1: torch.Tensor
    w2: torch.Tensor

    def to_fragments(self) -> Fragments:
        bary = torch.stack([self.w0, self.w1, self.w2], dim=-1)
        empty = (self.pix_to_face < 0)[..., None]
        return Fragments(pix_to_face=self.pix_to_face, zbuf=self.zbuf,
                         bary_coords=torch.where(empty, -1.0, bary),
                         dists=self.dists)


def as_planar(fragments) -> PlanarFragments:
    """Public Fragments viewed as planar (the barycentrics unstacked)."""
    if isinstance(fragments, PlanarFragments):
        return fragments
    b = fragments.bary_coords
    return PlanarFragments(pix_to_face=fragments.pix_to_face,
                           zbuf=fragments.zbuf, dists=fragments.dists,
                           w0=b[..., 0], w1=b[..., 1], w2=b[..., 2])


@dataclasses.dataclass(frozen=True)
class RasterizationSettings:
    """Static rasterizer configuration (PyTorch3D's field names).

    ``bin_size`` / ``max_faces_per_bin`` configure the staged selection's
    binning (``resolve_binning``); ``faces_per_chunk`` its chunk of faces.
    On the fused routes, ``bin_overflow='allow'`` opts a mesh above 8192
    faces into the binned route (``ops/binned.py``: per-tile slots, at
    most ``max_faces_per_bin`` and 160; an approximation where a tile's
    candidates exceed them), whose capacity ``capacity_stats`` measures
    and ``check_capacity_host`` reports under this policy ('warn',
    'error' or 'allow'); every other mesh with more faces than
    faces_per_pixel streams."""

    image_size: int = 128
    blur_radius: float = 0.0
    faces_per_pixel: int = 1
    bin_size: Optional[int] = None
    max_faces_per_bin: Optional[int] = None
    perspective_correct: bool = False
    clip_barycentric_coords: Optional[bool] = None
    cull_backfaces: bool = False
    faces_per_chunk: int = 512
    bin_overflow: str = "warn"

    def resolve_clip(self) -> bool:
        if self.clip_barycentric_coords is None:
            return self.blur_radius > 0.0
        return self.clip_barycentric_coords

    def resolve_binning(self, num_faces: int):
        """(bin_size, max_faces_per_bin), or (0, 0) for flat selection:
        PyTorch3D's heuristic bins meshes above 2048 faces at 128^2 and
        more; ``bin_size=0`` forces flat selection."""
        if self.bin_size == 0:
            return 0, 0
        bin_size = self.bin_size
        if bin_size is None:
            if num_faces <= 2048 or self.image_size < 128:
                return 0, 0
            bin_size = 32 if self.image_size <= 256 else 64
        if self.image_size % bin_size != 0 or self.image_size <= bin_size:
            return 0, 0
        mfpb = self.max_faces_per_bin or 4096
        return bin_size, min(mfpb, num_faces)


def _max(x, c: float):
    """jnp.maximum(x, c): half the gradient to x at a tie."""
    return torch.maximum(x, x.new_tensor(c))


def _min(x, c: float):
    return torch.minimum(x, x.new_tensor(c))


def _edge_dist_sq(px, py, ax, ay, bx, by):
    """Squared distance from pixel (px, py) to segment (a, b); broadcasting.
    The per-edge constants have the face shape only."""
    ex, ey = bx - ax, by - ay
    inv_denom = 1.0 / _max(ex * ex + ey * ey, 1e-12)
    exs, eys = ex * inv_denom, ey * inv_denom
    dx, dy = px - ax, py - ay
    t = _min(_max(dx * exs + dy * eys, 0.0), 1.0)
    rx = dx - t * ex
    ry = dy - t * ey
    return rx * rx + ry * ry


def _face_pixel_geometry(px, py, ax, ay, az, bx, by, bz, cx, cy, cz,
                         clip: bool, perspective_correct: bool):
    """Per pixel x face geometry on broadcastable coordinate tensors.

    Returns (w0, w1, w2, z, dist, inside, degenerate): interpolation
    barycentrics (optionally perspective-corrected, then clipped), the
    interpolated view depth and the signed squared edge distance."""
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    degenerate = torch.abs(area) < 1e-10
    inv_area = 1.0 / torch.where(degenerate, torch.ones_like(area), area)
    e0x = (cy - by) * inv_area
    e0y = (cx - bx) * inv_area
    w0 = e0y * py - e0x * px + (e0x * bx - e0y * by)
    e1x = (ay - cy) * inv_area
    e1y = (ax - cx) * inv_area
    w1 = e1y * py - e1x * px + (e1x * cx - e1y * cy)
    w2 = 1.0 - w0 - w1
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ~degenerate

    d0 = _edge_dist_sq(px, py, ax, ay, bx, by)
    d1 = _edge_dist_sq(px, py, bx, by, cx, cy)
    d2 = _edge_dist_sq(px, py, cx, cy, ax, ay)
    min_d = torch.minimum(d0, torch.minimum(d1, d2))
    dist = torch.where(inside, -min_d, min_d)

    if perspective_correct:
        s0 = w0 / _max(az, 1e-8)
        s1 = w1 / _max(bz, 1e-8)
        s2 = w2 / _max(cz, 1e-8)
        denom = _max(s0 + s1 + s2, 1e-12)
        w0, w1, w2 = s0 / denom, s1 / denom, s2 / denom
    if clip:
        c0 = _max(w0, 0.0)
        c1 = _max(w1, 0.0)
        c2 = _max(w2, 0.0)
        denom = _max(c0 + c1 + c2, 1e-12)
        w0, w1, w2 = c0 / denom, c1 / denom, c2 / denom
    z = w0 * az + w1 * bz + w2 * cz
    return w0, w1, w2, z, dist, inside, degenerate


def _pixel_grid(h: int, w: int, device):
    """NDC coordinates of the pixel centres (xs (W,), ys (H,)); row 0 /
    column 0 is the top-left, (+1, +1)."""
    ys = (h - 1.0 - 2.0 * torch.arange(h, dtype=torch.float32,
                                       device=device)) / h
    xs = (w - 1.0 - 2.0 * torch.arange(w, dtype=torch.float32,
                                       device=device)) / w
    return xs, ys


def _face_validity(verts_ndc, faces, num_faces, cull_backfaces):
    """(fv (N, F, 3, 3), valid (N, F)): each face's projected corners and
    whether it may be drawn (a real face, front-facing if culling, not
    wholly behind the camera)."""
    fcount = faces.shape[1]
    fv = take_rows_batched(verts_ndc, torch.clamp(faces, min=0))
    face_ids = torch.arange(fcount, device=faces.device)
    valid = ((face_ids[None] < num_faces[:, None])
             & torch.all(faces >= 0, dim=-1))
    if cull_backfaces:
        x, y = fv[..., 0], fv[..., 1]
        area = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
                - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
        valid = valid & (area > 0)
    return fv, valid & (torch.amax(fv[..., 2], dim=-1) > 0)


def _select_topk_core(px, py, fv, face_ids, valid, blur_radius, k: int,
                      faces_per_chunk: int, clip: bool,
                      perspective_correct: bool) -> torch.Tensor:
    """Chunked top-K selection (the JAX ``_select_topk_core``, batched).

    px, py: pixel NDC coordinates (B or 1, *pixel shape, 1); fv (B, F, 3,
    3); face_ids (B, F) ids written to the output; valid (B, F).  Returns
    (B, *pixel shape, K) ids, ascending depth, -1 padded.  Each chunk's
    candidates are merged into the running K with a stable sort on depth,
    so equal depths keep the earlier face."""
    b, fcount = fv.shape[0], fv.shape[1]
    c = min(faces_per_chunk, fcount)
    n_chunks = -(-fcount // c)
    pad = n_chunks * c - fcount
    if pad:
        fv = torch.cat([fv, fv.new_zeros(b, pad, 3, 3)], dim=1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], dim=1)
        face_ids = torch.cat([face_ids, face_ids.new_full((b, pad), -1)],
                             dim=1)
    pix_shape = torch.broadcast_shapes(px.shape[1:-1], py.shape[1:-1])
    bshape = (b,) + (1,) * len(pix_shape) + (c,)
    z_top = fv.new_full((b,) + tuple(pix_shape) + (k,), _INF)
    idx_top = face_ids.new_full(z_top.shape, -1)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        coords = [fv[:, sl, a, j].reshape(bshape) for a in range(3)
                  for j in range(3)]
        _, _, _, z, dist, inside, degen = _face_pixel_geometry(
            px, py, *coords, clip, perspective_correct)
        candidate = ((inside | (dist <= blur_radius)) & ~degen
                     & valid[:, sl].reshape(bshape) & (z > 0))
        z_cand = torch.where(candidate, z, _INF)
        cand_ids = face_ids[:, sl].reshape(bshape).expand(z_cand.shape)
        z_all = torch.cat([z_top, z_cand], dim=-1)
        idx_all = torch.cat([idx_top, cand_ids], dim=-1)
        z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
        z_top = z_sorted[..., :k]
        idx_top = torch.gather(idx_all, -1, order[..., :k])
    return torch.where(torch.isfinite(z_top), idx_top, -1)


def _select_topk(verts_ndc, faces, num_faces, image_size, blur_radius, k,
                 faces_per_chunk, clip, perspective_correct,
                 cull_backfaces, rows=None) -> torch.Tensor:
    """Flat top-K selection: every face tested at every pixel.  Returns
    (N, H, W, K) ids; ``rows=(start, count)`` selects on that strip of
    image rows only (H = count)."""
    fv, valid = _face_validity(verts_ndc, faces, num_faces, cull_backfaces)
    xs, ys = _pixel_grid(image_size, image_size, verts_ndc.device)
    if rows is not None:
        ys = ys[rows[0]:rows[0] + rows[1]]
    face_ids = torch.arange(fv.shape[1], device=fv.device).expand(
        fv.shape[0], -1)
    return _select_topk_core(xs[None, None, :, None], ys[None, :, None, None],
                             fv, face_ids, valid, blur_radius, k,
                             faces_per_chunk, clip, perspective_correct)


def _select_topk_binned(verts_ndc, faces, num_faces, image_size,
                        blur_radius, k, bin_size, max_faces_per_bin,
                        faces_per_chunk, clip, perspective_correct,
                        cull_backfaces) -> torch.Tensor:
    """Binned top-K selection (the JAX ``_select_topk_binned``): per bin of
    bin_size^2 pixels the first ``max_faces_per_bin`` faces (ascending id)
    whose blur-expanded screen box meets the bin, gathered into bin-local
    tables (K9a, D = 9), then the chunked selection on the bin's pixels.
    Returns (N, H, W, K) ids.

    Chunks in which no bin holds a face are skipped: the selection is a
    stable sort of all candidates by depth, so faces that cannot be
    candidates change nothing (the count costs one device sync)."""
    n, fcount = faces.shape[0], faces.shape[1]
    h = w = image_size
    nb = h // bin_size
    m = min(max_faces_per_bin, fcount)
    dev = verts_ndc.device

    fv, valid = _face_validity(verts_ndc, faces, num_faces, cull_backfaces)
    band = torch.sqrt(torch.clamp(torch.as_tensor(
        blur_radius, dtype=torch.float32, device=dev), min=0.0))
    x_min = torch.amin(fv[..., 0], dim=-1) - band          # (N, F)
    x_max = torch.amax(fv[..., 0], dim=-1) + band
    y_min = torch.amin(fv[..., 1], dim=-1) - band
    y_max = torch.amax(fv[..., 1], dim=-1) + band
    start = torch.arange(nb, device=dev) * bin_size
    hi = (w - 1.0 - 2.0 * start) / w                       # first column
    lo = (w - 1.0 - 2.0 * (start + bin_size - 1)) / w
    ox = ((x_min[:, None, :] <= hi[None, :, None])
          & (x_max[:, None, :] >= lo[None, :, None]))       # (N, nb, F)
    oy = ((y_min[:, None, :] <= hi[None, :, None])
          & (y_max[:, None, :] >= lo[None, :, None]))
    overlap = (oy[:, :, None, :] & ox[:, None, :, :]
               & valid[:, None, None, :]).reshape(n, nb * nb, fcount)

    # The first m overlapping faces of each bin, ascending id.
    f_ids = torch.arange(fcount, device=dev)
    low = torch.iinfo(torch.int64).min
    score = torch.where(overlap, -f_ids, low)
    top = torch.topk(score, m, dim=-1, sorted=True).values
    bin_ids = torch.where(top == low, -1, -top)            # (N, bins, m)
    used = int(overlap.sum(dim=-1).clamp(max=m).max().item())
    bin_ids = bin_ids[..., :max(used, 1)]
    m = bin_ids.shape[-1]
    bin_fv = take_rows_batched(fv.reshape(n, fcount, 9), bin_ids)

    xs, ys = _pixel_grid(h, w, dev)
    by = torch.arange(nb, device=dev).repeat_interleave(nb)
    bx = torch.arange(nb, device=dev).repeat(nb)
    px = xs.reshape(nb, bin_size)[bx][:, None, :, None].repeat(n, 1, 1, 1)
    py = ys.reshape(nb, bin_size)[by][:, :, None, None].repeat(n, 1, 1, 1)
    ids = bin_ids.reshape(-1, m)
    idx = _select_topk_core(px, py, bin_fv.reshape(-1, m, 3, 3), ids,
                            ids >= 0, blur_radius, k, faces_per_chunk, clip,
                            perspective_correct)       # (N bins, bs, bs, K)
    idx = idx.reshape(n, nb, nb, bin_size, bin_size, k)
    return idx.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, k)


def _derive_planar(verts_ndc, faces, idx, image_size: int, clip: bool,
                   perspective_correct: bool, rows=None):
    """Differentiable fragment attributes of the selected faces: (zbuf,
    dists, w0, w1, w2), each (N, H, W, K), with -1 in zbuf and dists at
    empty slots.  The corners are gathered per pixel channel-major in one
    call: (9, N, H, W, K).  ``rows=(start, count)`` restricts the pixels to
    that strip of image rows (idx then holds ``count`` rows)."""
    n, fcount = faces.shape[0], faces.shape[1]
    face_verts = take_rows_batched(verts_ndc, torch.clamp(faces, min=0))
    fv9 = take_rows_cm_batched(face_verts.reshape(n, fcount, 9), idx)
    xs, ys = _pixel_grid(image_size, image_size, verts_ndc.device)
    if rows is not None:
        ys = ys[rows[0]:rows[0] + rows[1]]
    w0, w1, w2, z, dist, _, _ = _face_pixel_geometry(
        xs[None, None, :, None], ys[None, :, None, None], *fv9, clip,
        perspective_correct)
    empty = idx < 0
    return (torch.where(empty, -1.0, z), torch.where(empty, -1.0, dist),
            w0, w1, w2)


def rasterize_planar(meshes, cameras, settings: RasterizationSettings,
                     blur_radius=None) -> PlanarFragments:
    """Rasterize a batch of meshes with per-batch cameras into planar
    fragments.  ``blur_radius`` overrides ``settings.blur_radius`` (as
    annealing does); the binning and the barycentric clipping still follow
    the settings.  The selection runs without gradient on detached
    vertices; the derive pass carries the gradient."""
    blur = settings.blur_radius if blur_radius is None else blur_radius
    verts_ndc = cameras.transform_points_ndc(meshes.verts)
    clip = settings.resolve_clip()
    bin_size, mfpb = settings.resolve_binning(meshes.faces.shape[1])
    with torch.no_grad():
        v = verts_ndc.detach()
        if bin_size:
            idx = _select_topk_binned(
                v, meshes.faces, meshes.num_faces, settings.image_size, blur,
                settings.faces_per_pixel, bin_size, mfpb,
                settings.faces_per_chunk, clip, settings.perspective_correct,
                settings.cull_backfaces)
        else:
            idx = _select_topk(
                v, meshes.faces, meshes.num_faces, settings.image_size, blur,
                settings.faces_per_pixel, settings.faces_per_chunk, clip,
                settings.perspective_correct, settings.cull_backfaces)
    zbuf, dists, w0, w1, w2 = _derive_planar(
        verts_ndc, meshes.faces, idx, settings.image_size, clip,
        settings.perspective_correct)
    return PlanarFragments(pix_to_face=idx, zbuf=zbuf, dists=dists, w0=w0,
                           w1=w1, w2=w2)


def rasterize_planar_rows(meshes, cameras, settings: RasterizationSettings,
                          row_start: int, row_count: int,
                          blur_radius=None) -> PlanarFragments:
    """Staged rasterization of the image-row strip [row_start, row_start +
    row_count) at full-image NDC coordinates: planar fragments (N,
    row_count, W, K).

    The memory-bounded oracle path: work and residency scale with the
    strip's pixels, so a scene whose full-image staged pass would not fit
    (BASELINE config 5: 81,920 faces at 512^2, K=150) can be rendered
    strip by strip.  Selection is always flat and chunked (every face
    tested at every pixel of the strip, no binning), a code path
    independent of the fused kernels and of the binned selection; the
    derive pass gathers the corners through K9a (gradient K9b)."""
    blur = settings.blur_radius if blur_radius is None else blur_radius
    verts_ndc = cameras.transform_points_ndc(meshes.verts)
    clip = settings.resolve_clip()
    rows = (row_start, row_count)
    with torch.no_grad():
        idx = _select_topk(
            verts_ndc.detach(), meshes.faces, meshes.num_faces,
            settings.image_size, blur, settings.faces_per_pixel,
            settings.faces_per_chunk, clip, settings.perspective_correct,
            settings.cull_backfaces, rows=rows)
    zbuf, dists, w0, w1, w2 = _derive_planar(
        verts_ndc, meshes.faces, idx, settings.image_size, clip,
        settings.perspective_correct, rows=rows)
    return PlanarFragments(pix_to_face=idx, zbuf=zbuf, dists=dists, w0=w0,
                           w1=w1, w2=w2)


def rasterize_meshes(meshes, cameras, settings: RasterizationSettings,
                     blur_radius=None) -> Fragments:
    """PyTorch3D-layout rasterization (``rasterize_planar`` with the
    barycentrics stacked)."""
    return rasterize_planar(meshes, cameras, settings,
                            blur_radius=blur_radius).to_fragments()
