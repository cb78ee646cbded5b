"""Comparisons of a kernel's gradients with its plain version's, shared by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Gradient tables are held relative to their max |grad|.  The stream
route's gradients are also held against the plain version evaluated in
float64 (``stream_grads_close``): the float32 plain version rounds too.
There the rows of faces seen nearly edge-on get a tolerance that grows as
the face thins: their edge functions divide by the area and the
barycentric adjoints cancel terms that large, so a float32 gradient of
such a face carries rounding noise that grows as the face thins, whatever
the order of its arithmetic.
"""

import math

import torch


def table_errors(got, want):
    """[(where, error)]: each gradient table's max |d| over its max |want|;
    the scalar table (the fifth, (N, 34)) column by column, each scalar
    against its own max |want| over N, floored at 1e-6 of the table's max
    for columns that are 0 in the reference.  A table that is not finite
    has error inf."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(g).all()):
            out.append((f"table {i} not finite", math.inf))
            continue
        d = (g - w).abs()
        if i == 4:
            scale = w.abs().amax(dim=0)
            scale = torch.clamp(torch.maximum(scale, 1e-6 * scale.max()),
                                min=1e-30)
            col = d.amax(dim=0) / scale
            j = int(col.argmax())
            out.append((f"scalar {j}", col[j].item()))
        else:
            out.append((f"table {i}",
                        d.max().item() / max(w.abs().max().item(), 1e-30)))
    return out


def tables_close(got, want, tol):
    """(ok, worst error, where) of ``table_errors``."""
    where, worst = max(table_errors(got, want), key=lambda e: e[1])
    return worst <= tol, worst, where


def face_thinness(tab) -> torch.Tensor:
    """(N, rw) float64: the height of each sorted-table row's face over its
    longest edge, in NDC (twice the area over the longest edge squared);
    0 for a degenerate face or a dead row."""
    v = tab[..., :9].double()
    ex = [v[..., 3] - v[..., 0], v[..., 6] - v[..., 3], v[..., 0] - v[..., 6]]
    ey = [v[..., 4] - v[..., 1], v[..., 7] - v[..., 4], v[..., 1] - v[..., 7]]
    area = ex[0] * (v[..., 7] - v[..., 1]) - ey[0] * (v[..., 6] - v[..., 0])
    longest = torch.stack([a * a + b * b for a, b in zip(ex, ey)]).amax(0)
    return area.abs() / longest.clamp(min=1e-30)


# A float32 gradient of a face of height h over its longest edge L is
# resolved to about THIN_NOISE * L / h of the table max: 16 float32 ulps
# of 1, amplified by L / h.
THIN_NOISE = 2e-6
THIN_BINS = (0.0, 1e-5, 1e-4, 1e-3, 2e-3, 2e-2)


def thin_rows(tab, tol) -> torch.Tensor:
    """(N, rw) bool: rows whose faces are too thin for a float32 gradient
    to be resolved to ``tol`` of the table max: height below THIN_NOISE /
    tol of the longest edge (2e-3 at the MC tolerance 1e-3, 2e-2 at
    1e-4)."""
    return face_thinness(tab) < THIN_NOISE / tol


def split_stream(cfg, g_tab, g_scal):
    """A stream gradient (sorted table (N, rw, Dt), scalars (N, 34)) as
    ``table_errors``' five tables: ndc, world, normal, texel, scalars."""
    return (g_tab[..., :9], g_tab[..., 9:18], g_tab[..., 18:27],
            g_tab[..., 27:27 + cfg.tex_d], g_scal)


def stream_grads_close(cfg, tab, got, want, want64, tol, scalar_tol=None):
    """Hold a stream kernel's gradient against its plain version.

    ``got``, ``want``, ``want64``: (g_tab, g_scal) of the kernel, the
    float32 plain version and the plain version evaluated in float64, on
    the same inputs (``tab`` the sorted table).  Each row of the four
    tables must lie within its tolerance of the float32 or of the float64
    plain version, over the table's max |grad|: ``tol``, and for the row
    of a face of height h over its longest edge L below THIN_NOISE / tol
    (a thin row) THIN_NOISE * L / h.  Each scalar gradient likewise within
    ``tol`` of its own max over N (floored as in ``table_errors``), or
    within ``scalar_tol`` (34,) where that is larger.
    Either reference, because the float32 plain version rounds too (its
    thin faces, its scalar sums that cancel) and the two float32 versions
    may share an MC threshold decision that float64 takes the other way.

    Returns (ok, worst error outside the thin rows, where, number of thin
    rows, per bin of ``THIN_BINS``: (lo, hi, rows, kernel - float64,
    float32 plain - float64, worst share of the bound, median of the
    rows' own max |grad| over their bound)), distances over the table max
    and, per bin, the max over its rows and the four tables; the last
    number says how far below a row's own gradient its bound lies."""
    thinness = face_thinness(tab)
    thin = thinness < THIN_NOISE / tol
    bound = torch.where(thin, THIN_NOISE / thinness.clamp(min=1e-30),
                        torch.full_like(thinness, tol))
    g, w, w64 = (split_stream(cfg, *x) for x in (got, want, want64))
    ok = all(bool(torch.isfinite(t).all()) for t in g)
    worst, where = 0.0, "table 0"
    d_k64, d_p64, share, own = (torch.zeros_like(thinness) for _ in range(4))
    for i in range(4):
        scale = max(w[i].abs().max().item(), 1e-30)
        dist = lambda a, b: (a.double() - b.double()).abs().amax(-1) / scale
        k64, p64 = dist(g[i], w64[i]), dist(w[i], w64[i])
        near = torch.nan_to_num(torch.minimum(dist(g[i], w[i]), k64),
                                nan=math.inf)
        ok = ok and not bool((near > bound).any())
        if bool((~thin).any()) and near[~thin].max().item() > worst:
            worst, where = near[~thin].max().item(), f"table {i}"
        d_k64, d_p64 = torch.maximum(d_k64, k64), torch.maximum(d_p64, p64)
        share = torch.maximum(share, near / bound)
        own = torch.maximum(own, w64[i].double().abs().amax(-1) / scale
                            / bound)
    gs, ws, qs = (x[4].double() for x in (g, w, w64))
    scale = ws.abs().amax(dim=0)
    scale = torch.clamp(torch.maximum(scale, 1e-6 * scale.max()), min=1e-30)
    col = torch.nan_to_num(torch.minimum((gs - ws).abs().amax(dim=0),
                                         (gs - qs).abs().amax(dim=0)),
                           nan=math.inf) / scale
    lim = torch.full_like(col, tol)
    if scalar_tol is not None:
        lim = torch.maximum(lim, scalar_tol.to(lim))
    j = int((col / lim).argmax())
    ok = ok and col[j].item() <= lim[j].item()
    if col[j].item() > worst:
        worst, where = col[j].item(), f"scalar {j}"
    report = []
    for lo, hi in zip(THIN_BINS[:-1], THIN_BINS[1:]):
        sel = thin & (thinness >= lo) & (thinness < hi)
        if bool(sel.any()):
            report.append((lo, hi, int(sel.sum()), d_k64[sel].max().item(),
                           d_p64[sel].max().item(), share[sel].max().item(),
                           own[sel].median().item()))
    return ok, worst, where, int(thin.sum()), report


def binned_grads_close(cfg, tables, got, want, want64, tol,
                       scalar_tol=None):
    """``stream_grads_close`` for the binned route's gradients: ``tables``
    the per-tile tables (fv_ndc, fv_world, fn, tex) (N, nt, M, .) and
    got / want / want64 the (g_ndc, g_world, g_fn, g_tex, g_scal) of the
    kernel, the float32 plain version and the float64 one, each slot row
    held as a sorted-table row (its face's thinness by L / h)."""
    n = tables[0].shape[0]

    def rows(x):
        return torch.cat(list(x[:4]), dim=-1).reshape(n, -1, 27 + cfg.tex_d)

    return stream_grads_close(cfg, rows(tables), (rows(got), got[4]),
                              (rows(want), want[4]),
                              (rows(want64), want64[4]), tol, scalar_tol)


def scalars_close64(got, want64, tol):
    """(ok, worst error, where) of each scalar gradient (N, 34) against the
    plain version evaluated in float64 alone, over its own max |want64|
    over N (floored as in ``table_errors``): for a deterministic pair,
    whose float32 versions may share a rounding that float64 does not."""
    g, q = got.double(), want64.double()
    scale = q.abs().amax(dim=0)
    scale = torch.clamp(torch.maximum(scale, 1e-6 * scale.max()), min=1e-30)
    col = torch.nan_to_num((g - q).abs().amax(dim=0), nan=math.inf) / scale
    j = int(col.argmax())
    return col[j].item() <= tol, col[j].item(), f"scalar {j}"


def witness_text(report) -> str:
    """One line of ``stream_grads_close``'s per-bin report."""
    return "; ".join(f"[{lo:g}, {hi:g}): {rows} rows, kernel {ek:.3g} and "
                     f"float32 plain {ep:.3g} from float64, {sh:.2g} of the "
                     f"bound, rows' own |grad| {ow:.3g}x it"
                     for lo, hi, rows, ek, ep, sh, ow in report)
