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
* K9b ``scatter_rows_cm`` (csrc/gather.cu, csrc/segment_sum.cuh) — the
  VJP, a segment sum ``d_table[f] = sum_{p: idx[p] = f} g[:, p]`` without
  float atomics.  ``segments`` prepares the index on the card: the valid
  columns compacted and sorted by row with a stable LSD radix sort on
  only the key bits (the order ``torch.sort(key, stable=True)`` gives),
  each row's [start, end) and a chunk -> row table; each row's columns are
  cut into chunks of ``SCATTER_CHUNK`` in ascending p, one warp sums a
  chunk with a fixed butterfly, and a second pass adds a row's chunks in
  ascending order.  Repeated launches give the same bits.

``scatter_rows`` is the scatter as a differentiable function of its
values (its backward is K9a), which ``Meshes.verts_normals`` sums face
normals with.  A wrapper takes its plain version only for tensors on the
CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["take_rows", "take_rows_cm", "take_rows_batched",
           "take_rows_cm_batched", "scatter_rows", "gather_rows_cm",
           "gather_rows_plain", "scatter_rows_cm", "scatter_rows_plain",
           "segments", "segments_plain", "segment_sum", "segment_sum_plain",
           "Segments", "launch_counts", "SCATTER_CHUNK"]

SCATTER_CHUNK = 256      # sorted columns summed by one warp (K9b)
_SORT_TILE = 4096        # keys per radix tile (csrc/segment_sum.cuh)
_COUNTS = 258            # a pass's 256 digit totals, the valid count, the
                         # compaction's tile counter

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


class Segments(NamedTuple):
    """The index preparation of K9b's segment sums.

    ``order[:num_valid]`` lists the valid columns p (0 <= idx[p] < f)
    sorted by row, ascending p within a row; row r owns
    order[starts[r]:ends[r]] (an absent row [0, 0)).  Its columns are cut
    into chunks of SCATTER_CHUNK from its start; chunk j of row r has the
    id ``starts[r] // SCATTER_CHUNK + r + j``, increasing in (r, j) and
    below ``n_chunks = ceil(P / SCATTER_CHUNK) + f``, and
    ``chunk_row[id] = r + 1`` (0 at the ids no chunk takes).  All int32;
    ``num_valid`` a one-element tensor (no device sync)."""
    order: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    chunk_row: torch.Tensor
    num_valid: torch.Tensor
    n_chunks: int


def _sort_passes(f: int) -> int:
    """8-bit LSD passes over the key bits of rows [0, f)."""
    bits = max(f - 1, 0).bit_length()
    return max(1, -(-bits // 8))


def _n_chunks(p: int, f: int) -> int:
    return -(-p // SCATTER_CHUNK) + f


def _check_prep(idx: torch.Tensor, f: int):
    if idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError("segments: idx must be a 1-D int64 tensor")
    if not 1 <= f < 2 ** 31 or idx.shape[0] >= 2 ** 31:
        raise ValueError(f"segments: {f} rows, {idx.shape[0]} columns")


def segments_plain(idx: torch.Tensor, f: int) -> Segments:
    """Plain version of the card's index preparation, step for step: the
    valid columns compacted in ascending p, one stable counting sort per
    8-bit digit of the row (least significant first), the rows' bounds
    from the boundaries of the sorted keys, and the chunk table."""
    _check_prep(idx, f)
    dev = idx.device
    p = idx.shape[0]
    pos = torch.nonzero((idx >= 0) & (idx < f)).flatten()
    key = idx[pos]
    for q in range(_sort_passes(f)):
        digit = (key >> (8 * q)) & 255
        counts = torch.bincount(digit, minlength=256)
        bucket = torch.cumsum(counts, 0) - counts
        dest = torch.empty_like(pos)
        for d in torch.nonzero(counts).flatten().tolist():
            sel = digit == d
            dest[sel] = bucket[d] + torch.arange(int(counts[d]), device=dev)
        pos = torch.empty_like(pos).index_copy_(0, dest, pos)
        key = torch.empty_like(key).index_copy_(0, dest, key)
    n = key.shape[0]
    starts = torch.zeros(f, dtype=torch.int64, device=dev)
    ends = torch.zeros(f, dtype=torch.int64, device=dev)
    o = torch.arange(n, device=dev)
    if n:
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = key[1:] != key[:-1]
        last = torch.ones(n, dtype=torch.bool, device=dev)
        last[:-1] = key[1:] != key[:-1]
        starts[key[first]] = o[first]
        ends[key[last]] = o[last] + 1
    s = starts[key]
    head = (o - s) % SCATTER_CHUNK == 0
    ids = s // SCATTER_CHUNK + key + (o - s) // SCATTER_CHUNK
    chunk_row = torch.zeros(_n_chunks(p, f), dtype=torch.int64, device=dev)
    chunk_row[ids[head]] = key[head] + 1
    order = torch.zeros(p, dtype=torch.int64, device=dev)
    order[:n] = pos
    i32 = lambda t: t.to(torch.int32)
    return Segments(i32(order), i32(starts), i32(ends), i32(chunk_row),
                    torch.tensor([n], dtype=torch.int32, device=dev),
                    _n_chunks(p, f))


def segments(idx: torch.Tensor, f: int) -> Segments:
    """The index preparation of K9b's deterministic segment sums: on the
    card the kernels of csrc/segment_sum.cuh (the valid
    columns compacted, one stable radix pass per 8-bit digit of the row,
    the bounds and the chunk table); on the CPU :func:`segments_plain`.
    See :class:`Segments`."""
    _check_prep(idx, f)
    if idx.device.type == "cpu":
        return segments_plain(idx, f)
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    dev, p = idx.device, idx.shape[0]
    n_chunks = _n_chunks(p, f)
    tiles = -(-p // _SORT_TILE)
    n32 = _COUNTS + 2 * f + n_chunks
    # One zeroed buffer: the compaction's look-back words (int64), then the
    # int32 counts, bounds and chunk table.
    ws = torch.zeros(tiles + -(-n32 // 2), dtype=torch.int64, device=dev)
    rest = ws[tiles:].view(torch.int32)
    counts = rest[:_COUNTS]
    starts = rest[_COUNTS:_COUNTS + f]
    ends = rest[_COUNTS + f:_COUNTS + 2 * f]
    chunk_row = rest[_COUNTS + 2 * f:n32]
    tcount = torch.empty(256 * tiles, dtype=torch.int32, device=dev)
    kp = torch.empty((4, p), dtype=torch.int32, device=dev)
    idx = idx.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pt_segment_prep(idx.data_ptr(), p, f, ws.data_ptr(),
                                  counts.data_ptr(), tcount.data_ptr(),
                                  kp[0].data_ptr(), kp[1].data_ptr(),
                                  kp[2].data_ptr(), kp[3].data_ptr(),
                                  starts.data_ptr(), ends.data_ptr(),
                                  chunk_row.data_ptr(), stream)
    _build.check(err, "segments")
    order = kp[3] if _sort_passes(f) % 2 else kp[1]
    return Segments(order, starts, ends, chunk_row,
                    counts[256:257],
                    n_chunks)


def segment_sum_plain(g: torch.Tensor, seg: Segments, f: int,
                      weights=None) -> torch.Tensor:
    """Plain version of the card's segment sum over ``seg``, in its order:
    per chunk, lane l adds columns l, l + 32, ... of the chunk, an xor
    butterfly adds the lanes, and each row adds its chunks in ascending
    order.  g (D, P) float32; ``weights``: None, or (w0, w1, w2) each (P,)
    (the weighted form, K10b's table gradient before K10b's tile pass:
    (f, 3, D)).  Returns (f, D) or (f, 3, D)."""
    d, dev = g.shape[0], g.device
    order = seg.order[:int(seg.num_valid[0])].long()
    starts, ends = seg.starts.long(), seg.ends.long()
    ids = torch.nonzero(seg.chunk_row).flatten()
    rows = seg.chunk_row[ids].long() - 1
    begin = starts[rows] + (ids - starts[rows] // SCATTER_CHUNK - rows) \
        * SCATTER_CHUNK
    at = begin[:, None] + torch.arange(SCATTER_CHUNK, device=dev)[None]
    inside = at < ends[rows][:, None]
    cols = order[torch.where(inside, at, 0).clamp(max=max(len(order) - 1,
                                                          0))]
    ws = [None] if weights is None else list(weights)
    out = torch.zeros(f, len(ws), d, dtype=torch.float32, device=dev)
    for v, w in enumerate(ws):
        x = g[:, cols]                                   # (D, chunks, 256)
        if w is not None:
            x = x * w[cols][None]
        x = torch.where(inside[None], x, 0.0).view(d, -1, 8, 32)
        acc = torch.zeros_like(x[:, :, 0])
        for i in range(8):                               # ascending columns
            acc = acc + x[:, :, i]
        for off in (16, 8, 4, 2, 1):                     # the butterfly
            acc = acc + acc[..., torch.arange(32, device=dev) ^ off]
        part = acc[..., 0].T                             # (chunks, D)
        # Rows add their chunks in ascending id: a row's chunk j.
        j = ids - starts[rows] // SCATTER_CHUNK - rows
        for jj in range(int(j.max()) + 1 if len(j) else 0):
            sel = j == jj
            out[rows[sel], v] = out[rows[sel], v] + part[sel]
    return out[:, 0] if weights is None else out


def segment_sum(g: torch.Tensor, seg: Segments, f: int) -> torch.Tensor:
    """K9b's sum over a prepared index: (f, D) float32 from g (D, P)
    contiguous float32 (see :func:`scatter_rows_cm`)."""
    from pertrenderer_tpu_torch import _build

    lib = _build.library()
    d, p = g.shape
    partial = torch.empty((seg.n_chunks, d), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((f, d), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = lib.pt_scatter_rows(g.data_ptr(), seg.order.data_ptr(),
                                  seg.starts.data_ptr(), seg.ends.data_ptr(),
                                  seg.chunk_row.data_ptr(),
                                  partial.data_ptr(), out.data_ptr(), p, f,
                                  d, seg.n_chunks, stream)
    _build.check(err, "scatter_rows_cm")
    return out


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
    out = segment_sum(g, segments(idx, f), f)
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
