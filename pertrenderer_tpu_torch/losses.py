"""Mesh regularisation losses and point-cloud metrics (PyTorch port of
``pertrenderer_tpu/losses.py``, the PyTorch3D loss surface the reference
imports).

Every per-vertex sum over the edge graph is a segment sum through
``ops/gather.py`` (kernel K9b on the card, its gather K9a in the
backward): a fixed order, no float atomics, so a loss and its gradients
are the same bits on every run.  The per-face gathers that carry a
gradient go through the same row gather.  Point-cloud distances are dense
pairwise matrices.
"""

from __future__ import annotations

import torch

from pertrenderer_tpu_torch.ops.gather import (batch_index, scatter_rows,
                                               take_rows, take_rows_batched)
from pertrenderer_tpu_torch.transforms import cross3

__all__ = [
    "mesh_laplacian_smoothing", "vertex_feature_laplacian",
    "mesh_edge_loss", "mesh_normal_consistency", "chamfer_distance",
    "knn_points",
]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum x^2) over the last axis (``jnp.linalg.norm``)."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _directed_edges(edges: torch.Tensor):
    """(src, dst) (N, 6F) each of ``Meshes.edges()`` (N, 3F, 2) in both
    directions, each block of F edges followed by its reverse (the JAX
    package's order), padding clamped to vertex 0."""
    n, e3 = edges.shape[:2]
    e = torch.clamp(edges, min=0).reshape(n, 3, e3 // 3, 2)
    both = torch.stack([e, e.flip(-1)], dim=2).reshape(n, 2 * e3, 2)
    return both[..., 0], both[..., 1]


def _segment_sum(values: torch.Tensor, idx: torch.Tensor,
                 rows: int) -> torch.Tensor:
    """Row sums (rows, ...) of values (P, ...) at idx (P,), in ascending
    P within a row."""
    d = values.shape[1:]
    out = scatter_rows(values.reshape(values.shape[0], -1), idx, rows)
    return out.reshape((rows,) + tuple(d))


def _uniform_laplacian(verts: torch.Tensor, edges: torch.Tensor,
                       fmask: torch.Tensor):
    """(mean of the neighbours - x, degree) per vertex of N meshes at once:
    verts (N, V, C), edges (N, 3F, 2) of ``Meshes.edges()``, fmask
    (N, F)."""
    n, v = verts.shape[:2]
    src, dst = _directed_edges(edges)
    w = fmask.to(verts.dtype).repeat(1, 6)                   # (N, 6F)
    src_flat = batch_index(src, n, v).reshape(-1)
    nb = take_rows(verts.reshape(n * v, -1),
                   batch_index(dst, n, v).reshape(-1))       # (N 6F, C)
    acc = _segment_sum(w.reshape(-1, 1) * nb, src_flat, n * v)
    deg = _segment_sum(w.reshape(-1, 1), src_flat, n * v)[:, 0]
    acc, deg = acc.reshape(n, v, -1), deg.reshape(n, v)
    return acc / torch.clamp(deg, min=1.0)[..., None] - verts, deg


def _masked_mean(norm: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """sum(norm over valid) / max(#valid, 1) along the last axis."""
    valid = valid.to(norm.dtype)
    return (torch.sum(norm * valid, dim=-1)
            / torch.clamp(torch.sum(valid, dim=-1), min=1.0))


def vertex_feature_laplacian(meshes, features: torch.Tensor) -> torch.Tensor:
    """Uniform-Laplacian smoothness of a per-vertex field: mean over the
    vertices of || mean_{u in N(v)} f_u - f_v || on the edge graph of mesh
    0.  features (V, C) or (1, V, C); the gradient flows to ``features``
    only.  A constant field (the scene loop's white start) has a zero
    residual at every vertex, where sqrt's gradient is 0/0: the norm is
    taken through a double where, whose gradient there is the exact
    subgradient 0, so the loop's finiteness guard does not zero the whole
    texture gradient."""
    if features.dim() == 3:
        features = features[0]
    lap, deg = _uniform_laplacian(features[None], meshes.edges()[:1],
                                  meshes.faces_mask()[:1])
    sq = torch.sum(lap[0] * lap[0], dim=-1)
    pos = sq > 0.0
    norm = torch.where(pos, torch.sqrt(torch.where(pos, sq,
                                                   torch.ones_like(sq))),
                       torch.zeros_like(sq))
    return _masked_mean(norm, deg[0] > 0)


def mesh_laplacian_smoothing(meshes, method: str = "uniform") -> torch.Tensor:
    """Laplacian smoothing with PyTorch3D's three weightings, the mean over
    the batch.

    - ``uniform``: mean_v || mean_{u in N(v)} u - v ||, the reference's
      deform regulariser;
    - ``cot``: the cotangent-weighted neighbour mean, || (L x)_v /
      rowsum_v - x_v ||;
    - ``cotcurv``: the discrete mean curvature, || (L x - rowsum x)_v ||
      0.25 / A_v with A_v the summed incident face area.

    The cotangent weights are constants (PyTorch3D builds them under
    ``no_grad``): gradients flow through the smoothed positions only."""
    if method not in ("uniform", "cot", "cotcurv"):
        raise NotImplementedError(f"unknown Laplacian method {method!r}")
    verts = meshes.verts
    fmask = meshes.faces_mask()
    if method != "uniform":
        faces = torch.clamp(meshes.faces, min=0)
        return torch.mean(_cot_laplacian_smoothing(verts, faces, fmask,
                                                   method))
    lap, deg = _uniform_laplacian(verts, meshes.edges(), fmask)
    return torch.mean(_masked_mean(_norm(lap), deg > 0))


def _cot_laplacian_smoothing(verts, faces, fmask, method: str):
    """Per-mesh cotangent Laplacian smoothing (N,).  Edge (v1, v2) gets
    cot_0 / 4 from each incident face, both directions, as PyTorch3D's
    ``cot_laplacian``."""
    n, v = verts.shape[:2]
    with torch.no_grad():
        x = verts.detach()
        v0, v1, v2 = (take_rows_batched(x, faces[..., i]) for i in range(3))
        a, b, c = _norm(v1 - v2), _norm(v0 - v2), _norm(v0 - v1)
        s = 0.5 * (a + b + c)
        area = torch.sqrt(torch.clamp(s * (s - a) * (s - b) * (s - c),
                                      min=1e-12))
        a2, b2, c2 = a * a, b * b, c * c
        w = fmask.to(x.dtype)
        cot0 = (b2 + c2 - a2) / (4.0 * area) * w
        cot1 = (a2 + c2 - b2) / (4.0 * area) * w
        cot2 = (a2 + b2 - c2) / (4.0 * area) * w
        wgt = torch.cat([cot0, cot0, cot1, cot1, cot2, cot2], dim=-1)
    f0, f1, f2 = faces[..., 0], faces[..., 1], faces[..., 2]
    src = batch_index(torch.cat([f1, f2, f2, f0, f0, f1], dim=-1), n, v)
    dst = batch_index(torch.cat([f2, f1, f0, f2, f1, f0], dim=-1), n, v)
    src = src.reshape(-1)
    nb = take_rows(verts.reshape(n * v, 3), dst.reshape(-1))
    lx = _segment_sum(wgt.reshape(-1, 1) * nb, src, n * v).reshape(n, v, 3)
    with torch.no_grad():
        rowsum = _segment_sum(wgt.reshape(-1, 1), src,
                              n * v).reshape(n, v)
    if method == "cot":
        norm_w = torch.where(rowsum > 0,
                             1.0 / torch.clamp(rowsum, min=1e-30), rowsum)
        lap = lx * norm_w[..., None] - verts
    else:
        with torch.no_grad():
            aval = (area * w).repeat_interleave(3, dim=-1)   # (N, 3F)
            varea = _segment_sum(
                aval.reshape(-1, 1),
                batch_index(faces.reshape(n, -1), n, v).reshape(-1),
                n * v).reshape(n, v)
            inv_area = torch.where(varea > 0,
                                   1.0 / torch.clamp(varea, min=1e-30),
                                   torch.zeros_like(varea))
        lap = (lx - rowsum[..., None] * verts) * (0.25 * inv_area)[..., None]
    return _masked_mean(_norm(lap), rowsum != 0)


def mesh_edge_loss(meshes, target_length: float = 0.0) -> torch.Tensor:
    """Mean squared deviation of the edge lengths from ``target_length``
    (PyTorch3D's ``mesh_edge_loss``; every face's three edges, so each
    edge of a closed mesh twice, a factor the mean absorbs)."""
    faces = torch.clamp(meshes.faces, min=0)
    w = meshes.faces_mask().to(meshes.verts.dtype)
    v0, v1, v2 = (take_rows_batched(meshes.verts, faces[..., i])
                  for i in range(3))
    lengths = torch.stack([_norm(v0 - v1), _norm(v1 - v2), _norm(v2 - v0)],
                          dim=1)                             # (N, 3, F)
    sq = (lengths - target_length) ** 2 * w[:, None]
    per = (torch.sum(sq, dim=(1, 2))
           / torch.clamp(3.0 * torch.sum(w, dim=-1), min=1.0))
    return torch.mean(per)


def mesh_normal_consistency(meshes) -> torch.Tensor:
    """Mean (1 - cos) between the normals of faces that share an edge
    (PyTorch3D's ``mesh_normal_consistency``): the edges' canonical keys
    are sorted stably and equal neighbours paired, as the JAX package
    pairs them."""
    faces = torch.clamp(meshes.faces, min=0)
    fmask = meshes.faces_mask()
    big = torch.iinfo(torch.int32).max
    per = []
    for verts_n, faces_n, mask_n in zip(meshes.verts, faces, fmask):
        c0, c1, c2 = (take_rows(verts_n, faces_n[:, i]) for i in range(3))
        normals = cross3(c1 - c0, c2 - c0)
        normals = normals / torch.clamp(_norm(normals), min=1e-12)[:, None]
        f = faces_n.shape[0]
        e = torch.stack([faces_n[:, [0, 1]], faces_n[:, [1, 2]],
                         faces_n[:, [2, 0]]], dim=0).reshape(-1, 2)
        valid = mask_n.repeat(3)
        lo = torch.where(valid, torch.minimum(e[:, 0], e[:, 1]), big)
        hi = torch.where(valid, torch.maximum(e[:, 0], e[:, 1]), big)
        _, order = torch.sort(lo * (1 << 32) + hi, stable=True)
        lo_s, hi_s = lo[order], hi[order]
        face_s = torch.arange(f, device=faces_n.device).repeat(3)[order]
        pair = ((lo_s[1:] == lo_s[:-1]) & (hi_s[1:] == hi_s[:-1])
                & (lo_s[1:] != big))
        cos = torch.sum(take_rows(normals, face_s[:-1])
                        * take_rows(normals, face_s[1:]), dim=-1)
        pair = pair.to(cos.dtype)
        per.append(torch.sum((1.0 - cos) * pair)
                   / torch.clamp(torch.sum(pair), min=1.0))
    return torch.mean(torch.stack(per))


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(P1, D) x (P2, D) -> (P1, P2) squared distances through one float32
    matmul (TF32 is off in this package)."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    yy = torch.sum(y * y, dim=-1, keepdim=True)
    return torch.clamp(xx - 2.0 * (x @ y.T) + yy.T, min=0.0)


def knn_points(p1: torch.Tensor, p2: torch.Tensor, K: int = 1):
    """The K nearest p2 points of each p1 point: p1 (N, P1, D), p2 (N, P2,
    D) -> (squared distances (N, P1, K), indices (N, P1, K)), nearest
    first (PyTorch3D's ``knn_points``)."""
    dists, idx = [], []
    for a, b in zip(p1, p2):
        neg, i = torch.topk(-_pairwise_sqdist(a, b), K, dim=-1)
        dists.append(-neg)
        idx.append(i)
    return torch.stack(dists), torch.stack(idx)


def chamfer_distance(x: torch.Tensor, y: torch.Tensor):
    """Symmetric squared chamfer distance between point clouds (N, P1, 3)
    and (N, P2, 3): (loss, None), as PyTorch3D returns it."""
    dx, _ = knn_points(x, y, K=1)
    dy, _ = knn_points(y, x, K=1)
    return torch.mean(dx) + torch.mean(dy), None
