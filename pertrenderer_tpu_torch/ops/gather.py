"""Row gather and its transposed scatter (PyTorch port of
``pertrenderer_tpu/ops/gather.py``), with kernels K9a and K9b.

``take_rows_cm(table, idx)`` is ``table[idx]`` with the channels first:
(D, *idx.shape), D the product of the table's trailing dims.  Negative or
out-of-range indices give zero columns and receive no gradient; ``idx`` is
integral and gets none.  The batched forms offset batch element n's
indices by n * F and keep -1 as -1.

On the TPU the gather is a one-hot matmul on the MXU; on Hopper it is an
indexed load:

* K9a ``gather_rows_cm`` (csrc/gather.cu) — one thread per output column
  p reads row idx[p] of the row-major (F, D) table;
* K9b ``scatter_rows_cm`` (csrc/gather.cu) — the VJP, a segment sum
  ``d_table[f] = sum_{p: idx[p] = f} g[:, p]`` without float atomics: the
  indices are sorted once (a stable sort, index preparation in torch),
  each row's columns are cut into chunks of ``SCATTER_CHUNK`` in ascending
  p, one warp sums a chunk with a fixed butterfly, and a second pass adds
  a row's chunks in ascending order.  Repeated launches give the same
  bits.

``scatter_rows`` is the scatter as a differentiable function of its
values (its backward is K9a), which ``Meshes.verts_normals`` sums face
normals with.  A wrapper takes its plain version only for tensors on the
CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

__all__ = ["take_rows", "take_rows_cm", "take_rows_batched",
           "take_rows_cm_batched", "scatter_rows", "gather_rows_cm",
           "gather_rows_plain", "scatter_rows_cm", "scatter_rows_plain",
           "segments", "launch_counts", "SCATTER_CHUNK"]

SCATTER_CHUNK = 256      # sorted columns summed by one warp (K9b, K10b)

launch_counts = {"gather_rows_cm": 0, "scatter_rows_cm": 0}


def _check_idx(kernel: str, idx: torch.Tensor, f: int, ref: torch.Tensor):
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError(f"{kernel}: idx must be a 1-D int64 tensor, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != ref.device:
        raise ValueError(f"{kernel}: idx on {idx.device}, data on "
                         f"{ref.device}")
    if f < 1:
        raise ValueError(f"{kernel}: the table has no rows")
    if ref.dtype != torch.float32 or not ref.is_contiguous():
        raise ValueError(f"{kernel}: data must be contiguous float32")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {ref.device}")


def _valid_safe(idx: torch.Tensor, f: int):
    """(validity as 0/1 float32, idx clipped to [0, f))."""
    valid = ((idx >= 0) & (idx < f)).to(torch.float32)
    return valid, torch.clamp(idx, 0, f - 1)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9a's plain version (the JAX ``_masked_gather_cm``): table (F, D),
    idx (P,) int64 -> (D, P), ``table[idx[p]] * valid[p]``."""
    valid, safe = _valid_safe(idx, table.shape[0])
    return (table[safe].T * valid[None]).contiguous()


def scatter_rows_plain(g: torch.Tensor, idx: torch.Tensor,
                       f: int) -> torch.Tensor:
    """K9b's plain version (the JAX ``_masked_scatter_cm_fallback``, a
    segment sum in ascending p): g (D, P), idx (P,) -> (F, D)."""
    valid, safe = _valid_safe(idx, f)
    out = torch.zeros(f, g.shape[0], dtype=g.dtype, device=g.device)
    return out.index_add_(0, safe, (g * valid[None]).T)


def gather_rows_cm(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9a: ``out[:, p] = table[idx[p]]``, zero where idx[p] is outside
    [0, F) (replaces ``_gather_cm_kernel`` of
    ``pertrenderer_tpu/ops/gather.py``).  table (F, D) contiguous float32,
    idx (P,) int64; returns (D, P) float32."""
    _check_idx("gather_rows_cm", idx, table.shape[0], table)
    if table.dim() != 2:
        raise ValueError("gather_rows_cm: table must be (F, D)")
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    f, d = table.shape
    p = idx.shape[0]
    idx = idx.contiguous()
    out = torch.empty((d, p), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        err = lib.pt_gather_rows(table.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), p, f, d, stream)
    _build.check(err, "gather_rows_cm")
    launch_counts["gather_rows_cm"] += 1
    return out


def segments(idx: torch.Tensor, f: int):
    """Index preparation of the deterministic segment sums (K9b, K10b):
    (order, starts, chunk_begin, n_chunks).  ``order`` lists the columns
    p sorted by row, ascending p within a row (a stable sort; invalid
    indices sort last under the sentinel row f); row r owns
    order[starts[r]:starts[r + 1]], cut into chunks of SCATTER_CHUNK
    columns; its chunks are chunk_begin[r]:chunk_begin[r + 1].
    ``n_chunks`` bounds the chunk count without a device sync."""
    valid = (idx >= 0) & (idx < f)
    key = torch.where(valid, idx, torch.full_like(idx, f))
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        sorted_key, torch.arange(f + 1, dtype=torch.int64,
                                 device=idx.device))
    per_row = (starts[1:] - starts[:-1] + SCATTER_CHUNK - 1) // SCATTER_CHUNK
    chunk_begin = torch.cat([per_row.new_zeros(1), torch.cumsum(per_row, 0)])
    n_chunks = -(-idx.shape[0] // SCATTER_CHUNK) + f
    return order, starts, chunk_begin, n_chunks


def scatter_rows_cm(g: torch.Tensor, idx: torch.Tensor,
                    f: int) -> torch.Tensor:
    """K9b: ``d_table[r] = sum_{p: idx[p] = r} g[:, p]``, columns with idx
    outside [0, f) dropped (replaces ``_scatter_cm_kernel`` of
    ``pertrenderer_tpu/ops/gather.py``).  g (D, P) contiguous float32,
    idx (P,) int64; returns (f, D) float32, exact zeros in rows that no
    column names."""
    _check_idx("scatter_rows_cm", idx, f, g)
    if g.dim() != 2 or g.shape[1] != idx.shape[0]:
        raise ValueError(f"scatter_rows_cm: g is {tuple(g.shape)}, idx "
                         f"{tuple(idx.shape)}")
    if g.device.type == "cpu":
        return scatter_rows_plain(g, idx, f)
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    d, p = g.shape
    order, starts, chunk_begin, n_chunks = segments(idx, f)
    partial = torch.empty((n_chunks, d), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((f, d), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = lib.pt_scatter_rows(g.data_ptr(), order.data_ptr(),
                                  starts.data_ptr(), chunk_begin.data_ptr(),
                                  partial.data_ptr(), out.data_ptr(), p, f,
                                  d, n_chunks, SCATTER_CHUNK, stream)
    _build.check(err, "scatter_rows_cm")
    launch_counts["scatter_rows_cm"] += 1
    return out


class _TakeRows(torch.autograd.Function):
    """(F, D) table, (P,) idx -> (D, P): K9a forward, K9b backward (the
    JAX ``_take_rows_cm_2d`` with its custom VJP)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.f = table.shape[0]
        return gather_rows_cm(table, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return scatter_rows_cm(g.contiguous(), idx, ctx.f), None


class _ScatterRows(torch.autograd.Function):
    """(P, D) values, (P,) idx -> (F, D) row sums: K9b forward, K9a
    backward."""

    @staticmethod
    def forward(ctx, values, idx, f):
        ctx.save_for_backward(idx)
        return scatter_rows_cm(values.T.contiguous(), idx, f)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        return gather_rows_cm(g.contiguous(), idx).T, None, None


def _flat_table(table: torch.Tensor) -> torch.Tensor:
    f = table.shape[0]
    return table.reshape(f, -1).to(torch.float32).contiguous()


def take_rows_cm(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Channel-major differentiable gather: table (F, ...), idx any shape
    -> (D, *idx.shape), D = prod(table.shape[1:]).  Out-of-range indices
    give zero columns."""
    flat = _flat_table(table)
    out = _TakeRows.apply(flat, idx.reshape(-1).to(torch.int64))
    return out.reshape((flat.shape[1],) + tuple(idx.shape))


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-major ``table[idx]`` -> (*idx.shape, *table.shape[1:])."""
    out = torch.movedim(take_rows_cm(table, idx), 0, -1)
    return out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def batch_index(idx: torch.Tensor, n: int, f: int) -> torch.Tensor:
    """Per-element row indices idx (N, ...) into tables of f rows as
    indices into the N tables stacked (N f rows): n * f added, -1 kept.
    A batch of one table (N = 1) serves every element's indices."""
    offsets = (torch.arange(n, dtype=torch.int64, device=idx.device)
               * f).reshape((n,) + (1,) * (idx.dim() - 1))
    idx = idx.to(torch.int64)
    return torch.where(idx >= 0, idx + offsets, torch.full_like(idx, -1))


def take_rows_batched(tables: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched ``tables[n, idx[n]]``: tables (N, F, ...), idx (N, ...)."""
    n, f = tables.shape[0], tables.shape[1]
    flat = tables.reshape((n * f,) + tuple(tables.shape[2:]))
    return take_rows(flat, batch_index(idx, n, f))


def take_rows_cm_batched(tables: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Channel-major batched gather: tables (N, F, ...), idx (N, ...) ->
    (D, N, ...)."""
    n, f = tables.shape[0], tables.shape[1]
    flat = tables.reshape((n * f,) + tuple(tables.shape[2:]))
    return take_rows_cm(flat, batch_index(idx, n, f))


def scatter_rows(values: torch.Tensor, idx: torch.Tensor,
                 f: int) -> torch.Tensor:
    """Differentiable row sums: values (*idx.shape, D), idx any shape ->
    (f, D), ``out[r] = sum of values at idx == r`` in ascending flat
    position; indices outside [0, f) are dropped."""
    d = values.shape[-1]
    return _ScatterRows.apply(
        values.reshape(-1, d).to(torch.float32),
        idx.reshape(-1).to(torch.int64), f)
