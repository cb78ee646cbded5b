"""K9b's index preparation and segment sum (ops/gather.py) on the CPU.

``segments_plain`` follows the card's preparation step for step (the
valid columns compacted, one stable counting sort per 8-bit digit of the
row, the rows' bounds from the boundaries of the sorted keys, the chunk
table); it must give the order of ``torch.sort(key, stable=True)`` and the
row starts of ``searchsorted``.  ``segment_sum_plain`` adds in the card's
order (strided lanes, the butterfly, chunks in ascending order);
``scatter_rows_cm``'s CPU path and ``segment_sum_plain`` are held within
1e-6 of the output's max |value| (K9b's tolerance on the card: the sums
add in another order) of the JAX package's scatter:
``_masked_scatter_cm_fallback`` and the Pallas ``_pallas_scatter_rows_cm``
run in interpret mode.  Cases: -1
and out-of-range indices, empty rows, one row holding every column, P = 1,
F = 1, and key widths of 1, 15 and 17 bits.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pertrenderer_tpu.ops import gather as jg
from pertrenderer_tpu_torch.ops import gather as tg

RNG_SEED = 29

# (name, rows F, columns P, how the indices are drawn)
CASES = [
    ("mixed", 37, 3 * tg.SCATTER_CHUNK + 50, "mixed"),
    ("pile_up", 9, 2 * tg.SCATTER_CHUNK + 7, "pile_up"),
    ("all_invalid", 6, 300, "invalid"),
    ("p1", 5, 1, "mixed"),
    ("f1", 1, 400, "mixed"),
    ("bits1", 2, 700, "mixed"),
    ("bits15", 20480, 6000, "sparse"),
    ("bits17", 81920, 9000, "sparse"),
]


def _indices(rng, f, p, kind):
    if kind == "pile_up":                 # every column in row 0
        return np.zeros(p, np.int64)
    if kind == "invalid":
        return rng.choice([-1, f, f + 5], size=p).astype(np.int64)
    if kind == "sparse":                  # few rows, wide keys, gaps
        rows = rng.choice(f, size=max(1, p // 40), replace=False)
        idx = rng.choice(rows, size=p).astype(np.int64)
        idx[rng.random(p) < 0.3] = -1
        idx[rng.random(p) < 0.02] = f + 3
        return idx
    return rng.integers(-3, f + 3, size=p).astype(np.int64)


def _close(got, want):
    """Within 1e-6 of max |want| (at least 1e-6)."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(want).max(
                                   initial=0.0))))


def _reference(idx, f):
    """(order of the valid columns, starts (f + 1,)) by torch.sort and
    searchsorted, the preparation the kernels replace."""
    valid = (idx >= 0) & (idx < f)
    key = torch.where(valid, idx, torch.full_like(idx, f))
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(sorted_key, torch.arange(f + 1))
    return order[:int(valid.sum())], starts


@pytest.mark.parametrize("name,f,p,kind", CASES, ids=[c[0] for c in CASES])
def test_segments_plain_matches_sort_and_searchsorted(name, f, p, kind):
    rng = np.random.default_rng(RNG_SEED)
    idx = torch.from_numpy(_indices(rng, f, p, kind))
    seg = tg.segments_plain(idx, f)
    order, starts = _reference(idx, f)
    n = int(seg.num_valid[0])
    assert n == order.shape[0]
    assert seg.order.dtype == torch.int32 and seg.order.shape == (p,)
    assert torch.equal(seg.order[:n].long(), order)
    lengths = starts[1:] - starts[:-1]
    assert torch.equal((seg.ends - seg.starts).long(), lengths)
    filled = lengths > 0
    assert torch.equal(seg.starts.long()[filled], starts[:-1][filled])
    assert not bool(seg.starts[~filled].any() or seg.ends[~filled].any())
    # The chunk table: row r's chunks j at starts[r] // CHUNK + r + j, in
    # increasing order, below n_chunks; no other id taken.
    assert seg.n_chunks == -(-p // tg.SCATTER_CHUNK) + f
    want = torch.zeros(seg.n_chunks, dtype=torch.int64)
    for r in torch.nonzero(filled).flatten().tolist():
        base = int(seg.starts[r]) // tg.SCATTER_CHUNK + r
        n_r = -(-int(lengths[r]) // tg.SCATTER_CHUNK)
        assert (want[base:base + n_r] == 0).all()
        want[base:base + n_r] = r + 1
    assert torch.equal(seg.chunk_row.long(), want)


def _jax_scatters(g, idx, f, monkeypatch):
    """The JAX package's scatter, (F, D): the fallback segment sum and the
    Pallas kernel in interpret mode."""
    fallback = np.asarray(jg._masked_scatter_cm_fallback(
        jnp.asarray(g), jnp.asarray(idx.astype(np.int32)), f)).T
    monkeypatch.setattr(jg.pl, "pallas_call", functools.partial(
        jg.pl.pallas_call, interpret=True))
    pallas = np.asarray(jg._pallas_scatter_rows_cm(
        jnp.asarray(g), jnp.asarray(idx.astype(np.int32)), f)).T
    return fallback, pallas


# The Pallas kernel's one-hot tiles make the wide-key cases slow to
# interpret; those two are held against the fallback alone.
SMALL = [c for c in CASES if c[1] <= 64]
WIDE = [c for c in CASES if c[1] > 64]


@pytest.mark.parametrize("name,f,p,kind", SMALL, ids=[c[0] for c in SMALL])
def test_scatter_matches_jax_fallback_and_pallas(name, f, p, kind,
                                                 monkeypatch):
    rng = np.random.default_rng(RNG_SEED + 1)
    idx = _indices(rng, f, p, kind)
    g = rng.standard_normal((3, p)).astype(np.float32)
    fallback, pallas = _jax_scatters(g, idx, f, monkeypatch)
    ti = torch.from_numpy(idx)
    got = tg.scatter_rows_cm(torch.from_numpy(g), ti, f).numpy()
    ordered = tg.segment_sum_plain(torch.from_numpy(g),
                                   tg.segments_plain(ti, f), f).numpy()
    for want in (fallback, pallas):
        _close(got, want)
        _close(ordered, want)
    empty = ~np.isin(np.arange(f), idx)
    assert not ordered[empty].any() and not got[empty].any()


@pytest.mark.parametrize("name,f,p,kind", WIDE, ids=[c[0] for c in WIDE])
def test_scatter_wide_keys_match_jax_fallback(name, f, p, kind):
    rng = np.random.default_rng(RNG_SEED + 2)
    idx = _indices(rng, f, p, kind)
    g = rng.standard_normal((4, p)).astype(np.float32)
    want = np.asarray(jg._masked_scatter_cm_fallback(
        jnp.asarray(g), jnp.asarray(idx.astype(np.int32)), f)).T
    ti = torch.from_numpy(idx)
    got = tg.scatter_rows_cm(torch.from_numpy(g), ti, f).numpy()
    ordered = tg.segment_sum_plain(torch.from_numpy(g),
                                   tg.segments_plain(ti, f), f).numpy()
    _close(got, want)
    _close(ordered, want)


def test_weighted_segment_sum_matches_index_add():
    """K10b's weighted form of the ordered sum: (F, 3, D), each weight's
    table gradient within 1e-6 (of max) of index_add_ over g * w_v."""
    rng = np.random.default_rng(RNG_SEED + 3)
    f, p = 50, 2 * tg.SCATTER_CHUNK + 90
    idx = torch.from_numpy(_indices(rng, f, p, "mixed"))
    idx[:tg.SCATTER_CHUNK + 40] = 7
    g = torch.from_numpy(rng.standard_normal((2, p)).astype(np.float32))
    ws = [torch.from_numpy(rng.random(p).astype(np.float32))
          for _ in range(3)]
    got = tg.segment_sum_plain(g, tg.segments_plain(idx, f), f, ws)
    assert got.shape == (f, 3, 2)
    for v, w in enumerate(ws):
        want = tg.scatter_rows_plain(g * w[None], idx, f)
        _close(got[:, v].numpy(), want.numpy())
