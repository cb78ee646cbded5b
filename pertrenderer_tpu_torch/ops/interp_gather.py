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
* K10b ``interp_rows_backward`` (csrc/interp_gather.cu) — the table
  gradient as K9b's deterministic segment sum over K9b's index
  preparation (ops/gather.py ``segments``), weighted by w_v, and the
  three weight gradients, one thread per column.

A wrapper takes its plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import math

import torch

from pertrenderer_tpu_torch.ops.gather import batch_index, segments

__all__ = ["interp_rows_cm", "interp_rows_cm_batched", "interp_rows",
           "interp_rows_plain", "interp_rows_backward",
           "interp_rows_backward_plain", "launch_counts"]

launch_counts = {"interp_rows": 0, "interp_rows_backward": 0}


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
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    dev = table.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    d_table = d_ws = None
    with torch.cuda.device(dev):
        if need_table:
            seg = segments(idx, f)
            partial = torch.empty((seg.n_chunks, 3 * d),
                                  dtype=torch.float32, device=dev)
            d_table = torch.empty((f, 3, d), dtype=torch.float32,
                                  device=dev)
            err = lib.pt_interp_rows_bwd_tables(
                g.data_ptr(), w0.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                seg.order.data_ptr(), seg.starts.data_ptr(),
                seg.ends.data_ptr(), seg.chunk_row.data_ptr(),
                partial.data_ptr(), d_table.data_ptr(), p, f, d,
                seg.n_chunks, stream)
            _build.check(err, "interp_rows_backward")
        if need_weights:
            dw = torch.empty((3, p), dtype=torch.float32, device=dev)
            err = lib.pt_interp_rows_bwd_weights(
                table.data_ptr(), idx.contiguous().data_ptr(), g.data_ptr(),
                dw.data_ptr(), p, f, d, stream)
            _build.check(err, "interp_rows_backward")
            d_ws = (dw[0], dw[1], dw[2])
    if need_table or need_weights:
        launch_counts["interp_rows_backward"] += 1
    return d_table, d_ws


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
