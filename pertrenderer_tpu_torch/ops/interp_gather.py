"""Barycentric interpolating gather (PyTorch port of
``pertrenderer_tpu/ops/interp_gather.py``), with kernels K10a and K10b.

``interp_rows_cm(tables, idx, w0, w1, w2)`` computes, channel-major,

    out[:, p] = w0[p] tables[idx[p], 0] + w1[p] tables[idx[p], 1]
              + w2[p] tables[idx[p], 2]

— barycentric interpolation of per-face corner attributes, the inner loop
of Phong shading and vertex / UV texture sampling.  Out-of-range indices
give zero columns; ``idx`` is integral.  Differentiable in the tables and
the weights:

* K10a ``interp_rows`` (csrc/interp_gather.cu) — one thread per column
  reads its row's (3, D) corners and writes the D interpolated values;
* K10b ``interp_rows_backward`` (csrc/interp_gather.cu) — one pass over
  the columns in tiles of BWD_TILE: the three weight gradients, and per
  tile each face's sum of w_v g in column order (the tile's filled
  columns sorted by face in shared memory); then each face adds its
  tiles' partials in tile order (``interp_rows_backward_tiles_plain`` is
  the plain mirror of that order).

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math

import torch

from pertrenderer_tpu_torch.ops.gather import batch_index

__all__ = ["interp_rows_cm", "interp_rows_cm_batched", "interp_rows",
           "interp_rows_plain", "interp_rows_backward",
           "interp_rows_backward_plain", "interp_rows_backward_tiles_plain",
           "tile_partials", "BWD_TILE", "launch_counts"]

launch_counts = {"interp_rows": 0, "interp_rows_backward": 0}

# K10b's tile of consecutive columns (csrc/interp_gather.cu's kTile): each
# tile sums its faces into one partial row apiece.
BWD_TILE = 1024


def _check(kernel: str, table, idx, ws):
    if table.dim() != 3 or table.shape[1] != 3:
        raise ValueError(f"{kernel}: table must be (F, 3, D), got "
                         f"{tuple(table.shape)}")
    if table.shape[0] < 1:
        raise ValueError(f"{kernel}: the table has no rows")
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"{kernel}: idx must be 1-D int64")
    for t in (table, *ws):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{kernel}: tables and weights must be "
                             "contiguous float32")
    for t in (idx, *ws):
        if t.device != table.device:
            raise ValueError(f"{kernel}: inputs on {t.device} and "
                             f"{table.device}")
        if t.shape[0] != idx.shape[0]:
            raise ValueError(f"{kernel}: weights and idx differ in length")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {table.device}")


def _valid_safe(idx, f):
    valid = ((idx >= 0) & (idx < f)).to(torch.float32)
    return valid, torch.clamp(idx, 0, f - 1)


def interp_rows_plain(table, idx, w0, w1, w2) -> torch.Tensor:
    """K10a's plain version (the CPU branch of the JAX ``_interp_cm_core``):
    table (F, 3, D), idx / w (P,) -> (D, P)."""
    valid, safe = _valid_safe(idx, table.shape[0])
    rows = table[safe]                                   # (P, 3, D)
    return (rows[:, 0].T * (w0 * valid)[None]
            + rows[:, 1].T * (w1 * valid)[None]
            + rows[:, 2].T * (w2 * valid)[None]).contiguous()


def interp_rows_backward_plain(table, idx, w0, w1, w2, g):
    """K10b's plain version (the CPU branch of the JAX ``_interp_bwd``):
    (d_table (F, 3, D), (dw0, dw1, dw2) each (P,))."""
    f, _, d = table.shape
    valid, safe = _valid_safe(idx, f)
    d_tables, d_ws = [], []
    for v, wv in enumerate((w0, w1, w2)):
        contrib = g * (wv * valid)[None]                 # (D, P)
        d_tables.append(torch.zeros(f, d, dtype=g.dtype, device=g.device)
                        .index_add_(0, safe, contrib.T))
        vals = table[safe][:, v].T * valid[None]
        d_ws.append(torch.sum(vals * g, dim=0))
    return torch.stack(d_tables, dim=1), tuple(d_ws)


def interp_rows(table, idx, w0, w1, w2) -> torch.Tensor:
    """K10a: the interpolating gather (replaces ``_fwd_kernel`` of
    ``pertrenderer_tpu/ops/interp_gather.py``).  table (F, 3, D), idx (P,)
    int64, w0..w2 (P,) float32 -> (D, P) float32."""
    _check("interp_rows", table, idx, (w0, w1, w2))
    if table.device.type == "cpu":
        return interp_rows_plain(table, idx, w0, w1, w2)
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    f, _, d = table.shape
    p = idx.shape[0]
    out = torch.empty((d, p), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = lib.pt_interp_rows(table.data_ptr(), idx.contiguous().data_ptr(),
                                 w0.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                 out.data_ptr(), p, f, d, stream)
    _build.check(err, "interp_rows")
    launch_counts["interp_rows"] += 1
    return out


def tile_partials(idx: torch.Tensor, f: int, tile: int = BWD_TILE):
    """K10b's partial rows: (tile of each, face of each) of the distinct
    (tile, face) pairs of the filled columns (0 <= idx < f), tiles of
    ``tile`` consecutive columns, in (tile, face) order."""
    cols = torch.nonzero((idx >= 0) & (idx < f)).flatten()
    pairs = torch.unique((cols // tile) * f + idx[cols])
    return pairs // f, pairs % f


def interp_rows_backward_tiles_plain(table, idx, w0, w1, w2, g,
                                     tile: int = BWD_TILE):
    """Plain mirror of K10b's order (csrc/interp_gather.cu), bit for bit:
    dw_v[p] = sum over the channels in order of t[idx[p], v, j] g[j, p]
    from +0 (0 where idx[p] is outside [0, F)); per tile of ``tile``
    columns each face's sum of w_v[p] g[:, p] over its columns in column
    order, then each face's partials added in tile order."""
    f, _, d = table.shape
    p = idx.shape[0]
    valid = (idx >= 0) & (idx < f)
    rows = table[torch.clamp(idx, 0, f - 1)]            # (P, 3, D)
    d_ws = []
    for v in range(3):
        acc = torch.zeros(p, dtype=g.dtype, device=g.device)
        for j in range(d):
            acc = acc + rows[:, v, j] * g[j]
        d_ws.append(torch.where(valid, acc, torch.zeros_like(acc)))
    cols = torch.nonzero(valid).flatten()
    key = (cols // tile) * f + idx[cols]
    order = torch.sort(key, stable=True).indices        # column order kept
    cols, key = cols[order], key[order]
    w = torch.stack([w0, w1, w2])                        # (3, P)
    contrib = g[:, cols].T[:, None, :] * w[:, cols].T[:, :, None]
    pairs, run = torch.unique_consecutive(key, return_inverse=True)
    part = _ordered_sums(contrib, run, len(pairs))      # (R, 3, D)
    d_table = _ordered_sums(part, pairs % f, f)         # tiles in order
    return d_table, tuple(d_ws)


def _ordered_sums(x, group, groups: int):
    """out[k] = the rows x[i] with group[i] = k, added from +0 in ascending
    i."""
    out = torch.zeros((groups,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    counts = torch.bincount(group, minlength=groups)
    order = torch.sort(group, stable=True).indices
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order), device=x.device) - start[
        group[order]]
    for r in range(int(counts.max())):
        sel = rank == r
        out[group[sel]] = out[group[sel]] + x[sel]
    return out


def interp_rows_backward(table, idx, w0, w1, w2, g, need_table=True,
                         need_weights=True):
    """K10b: the VJP of K10a for a cotangent g (D, P) (replaces
    ``_bwd_tables_kernel`` and ``_bwd_weights_kernel`` of
    ``pertrenderer_tpu/ops/interp_gather.py``).  Returns (d_table (F, 3, D)
    or None, (dw0, dw1, dw2) or None); a gradient not asked for is not
    computed."""
    _check("interp_rows_backward", table, idx, (w0, w1, w2))
    f, _, d = table.shape
    p = idx.shape[0]
    if tuple(g.shape) != (d, p) or g.dtype != torch.float32 \
            or not g.is_contiguous() or g.device != table.device:
        raise ValueError(f"interp_rows_backward: g is {tuple(g.shape)}")
    if table.device.type == "cpu":
        d_table, d_ws = interp_rows_backward_plain(table, idx, w0, w1, w2, g)
        return (d_table if need_table else None,
                d_ws if need_weights else None)
    if not (need_table or need_weights):
        return None, None
    if d == 0:
        zeros = torch.zeros(3, p, dtype=torch.float32, device=table.device)
        return (torch.zeros_like(table) if need_table else None,
                (zeros[0], zeros[1], zeros[2]) if need_weights else None)
    if p + BWD_TILE >= 2 ** 31:
        raise ValueError(f"interp_rows_backward: {p} columns")
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    dev = table.device
    new = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=dev)
    i32 = torch.int32
    slots = -(-p // BWD_TILE) * BWD_TILE
    dw = new(3, p) if need_weights else None
    d_table = part = ints = counts = None
    if need_table:
        d_table = new(f, 3, d)
        part = new(slots, 3 * d)
        ints = new(3, slots, dtype=i32)         # part_face, list, sorted
        counts = torch.zeros(3 * f + slots // BWD_TILE, dtype=i32,
                             device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    at = lambda t, k, n: None if t is None else t[k * f:k * f + n].data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pt_interp_rows_bwd(
            table.data_ptr(), idx.contiguous().data_ptr(), w0.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), g.data_ptr(), ptr(dw),
            ptr(d_table), ptr(part), *(ptr(None if ints is None else ints[k])
                                       for k in range(3)),
            None if counts is None else counts[3 * f:].data_ptr(),
            at(counts, 0, f), at(counts, 1, f), at(counts, 2, f), p, f, d,
            BWD_TILE, stream)
    _build.check(err, "interp_rows_backward")
    launch_counts["interp_rows_backward"] += 1
    return d_table, (None if dw is None else (dw[0], dw[1], dw[2]))


class _InterpRows(torch.autograd.Function):
    """The JAX ``_interp_cm_core`` with its custom VJP: K10a forward, K10b
    backward."""

    @staticmethod
    def forward(ctx, table, idx, w0, w1, w2):
        ctx.save_for_backward(table, idx, w0, w1, w2)
        return interp_rows(table, idx, w0, w1, w2)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        need_table, need_w = need[0], any(need[2:])
        if not (need_table or need_w):
            return None, None, None, None, None
        table, idx, w0, w1, w2 = ctx.saved_tensors
        d_table, d_ws = interp_rows_backward(
            table, idx, w0, w1, w2, g.contiguous(), need_table, need_w)
        d_ws = d_ws if d_ws is not None else (None, None, None)
        return (d_table, None, *d_ws)


def interp_rows_cm(tables: torch.Tensor, idx: torch.Tensor, w0, w1, w2):
    """tables (F, 3, ...) per-face corner attributes; idx, w0..w2 of one
    common shape.  Returns (D, *idx.shape), D = prod(tables.shape[2:])."""
    f = tables.shape[0]
    d = math.prod(tables.shape[2:]) if tables.dim() > 2 else 1
    table = tables.reshape(f, 3, d).to(torch.float32).contiguous()
    flat = lambda w: w.reshape(-1).to(torch.float32).contiguous()
    out = _InterpRows.apply(table, idx.reshape(-1).to(torch.int64),
                            flat(w0), flat(w1), flat(w2))
    return out.reshape((d,) + tuple(idx.shape))


def interp_rows_cm_batched(tables: torch.Tensor, idx: torch.Tensor, w0, w1,
                           w2):
    """Batched variant: tables (N, F, 3, ...), idx / w (N, ...) ->
    (D, N, ...)."""
    n, f = tables.shape[0], tables.shape[1]
    flat = tables.reshape((n * f,) + tuple(tables.shape[2:]))
    return interp_rows_cm(flat, batch_index(idx, n, f), w0, w1, w2)
