"""The port's row gather and interpolating gather (kernels K9a / K9b and
K10a / K10b through their plain versions) against the JAX package's public
functions, which run their CPU reference branches here.

Forward values are compared bit for bit, -1 and out-of-range rows
included; the VJPs against ``jax.vjp`` at atol 1e-6 (the segment sums add
in another order).  Inputs come from numpy with a fixed seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pertrenderer_tpu.ops import gather as jg
from pertrenderer_tpu.ops import interp_gather as jig
from pertrenderer_tpu_torch.ops import gather as tg
from pertrenderer_tpu_torch.ops import interp_gather as tig

RNG_SEED = 11


def _idx(rng, shape, f):
    """Indices in [-3, f + 3): -1 padding and out-of-range rows included."""
    return rng.integers(-3, f + 3, size=shape).astype(np.int32)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _vjp_close(got, want, atol=1e-6):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("tail", [(), (3,), (3, 3), (1,)])
def test_take_rows_matches_jax(tail):
    rng = np.random.default_rng(RNG_SEED)
    f = 40
    table = rng.standard_normal((f,) + tail).astype(np.float32)
    idx = _idx(rng, (5, 7, 3), f)
    for name in ("take_rows", "take_rows_cm"):
        want = getattr(jg, name)(jnp.asarray(table), jnp.asarray(idx))
        got = getattr(tg, name)(_t(table), _t(idx, torch.int64))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # VJP of the channel-major gather with respect to the table.
    g = rng.standard_normal((int(np.prod(tail or (1,))), 5, 7, 3)
                            ).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jg.take_rows_cm(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    tt = _t(table).requires_grad_()
    tg.take_rows_cm(tt, _t(idx, torch.int64)).backward(_t(g))
    _vjp_close(tt.grad.numpy(), vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("cm", [False, True])
def test_take_rows_batched_matches_jax(cm):
    rng = np.random.default_rng(RNG_SEED + 1)
    n, f = 3, 25
    tables = rng.standard_normal((n, f, 2, 3)).astype(np.float32)
    idx = _idx(rng, (n, 6, 4), f)
    name = "take_rows_cm_batched" if cm else "take_rows_batched"
    jfn = lambda t: getattr(jg, name)(t, jnp.asarray(idx))
    want, vjp = jax.vjp(jfn, jnp.asarray(tables))
    tt = _t(tables).requires_grad_()
    got = getattr(tg, name)(tt, _t(idx, torch.int64))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = rng.standard_normal(got.shape).astype(np.float32)
    got.backward(_t(g))
    _vjp_close(tt.grad.numpy(), vjp(jnp.asarray(g))[0])


def test_scatter_rows_sums_in_order_and_drops_invalid():
    """K9b's plain version and ``scatter_rows``: rows with no column are
    exact zeros, -1 and out-of-range columns add nothing, and the backward
    of the differentiable scatter is the gather."""
    rng = np.random.default_rng(RNG_SEED + 2)
    f, p = 30, 400
    idx = _idx(rng, (p,), f)
    g = rng.standard_normal((4, p)).astype(np.float32)
    got = tg.scatter_rows_cm(_t(g), _t(idx, torch.int64), f).numpy()
    want = np.zeros((f, 4), np.float64)
    for col, i in enumerate(idx):
        if 0 <= i < f:
            want[i] += g[:, col]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    empty = np.setdiff1d(np.arange(f), idx)
    assert np.all(got[empty] == 0.0)
    vals = _t(g.T.copy()).requires_grad_()
    out = tg.scatter_rows(vals, _t(idx, torch.int64), f)
    cot = rng.standard_normal((f, 4)).astype(np.float32)
    out.backward(_t(cot))
    valid = (idx >= 0) & (idx < f)
    want_g = np.where(valid[:, None], cot[np.clip(idx, 0, f - 1)], 0.0)
    np.testing.assert_array_equal(vals.grad.numpy(), want_g)


def test_segments_cover_each_row_in_ascending_columns():
    """The index preparation of the segment-sum kernels: per row, its
    columns in ascending order, cut into chunks of SCATTER_CHUNK."""
    rng = np.random.default_rng(RNG_SEED + 3)
    f, p = 7, 3 * tg.SCATTER_CHUNK + 50
    idx = _idx(rng, (p,), f)
    idx[: tg.SCATTER_CHUNK + 10] = 2            # one row spans two chunks
    order, starts, chunk_begin, n_chunks = tg.segments(
        _t(idx, torch.int64), f)
    order, starts, cb = order.numpy(), starts.numpy(), chunk_begin.numpy()
    for r in range(f):
        cols = order[starts[r]:starts[r + 1]]
        np.testing.assert_array_equal(cols, np.flatnonzero(idx == r))
        assert cb[r + 1] - cb[r] == -(-len(cols) // tg.SCATTER_CHUNK)
    assert cb[-1] <= n_chunks


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("d_tail", [(), (3,), (6,)])
def test_interp_rows_matches_jax(batched, d_tail):
    rng = np.random.default_rng(RNG_SEED + 4)
    n, f = 2, 30
    shape = (n, f, 3) + d_tail if batched else (f, 3) + d_tail
    tables = rng.standard_normal(shape).astype(np.float32)
    idx = _idx(rng, (n, 5, 6, 4), f)
    ws = [rng.uniform(-0.2, 1.0, idx.shape).astype(np.float32)
          for _ in range(3)]
    name = "interp_rows_cm_batched" if batched else "interp_rows_cm"
    jfn = lambda t, a, b, c: getattr(jig, name)(t, jnp.asarray(idx), a, b, c)
    want, vjp = jax.vjp(jfn, jnp.asarray(tables),
                        *[jnp.asarray(w) for w in ws])
    leaves = [_t(x).requires_grad_() for x in (tables, *ws)]
    got = getattr(tig, name)(leaves[0], _t(idx, torch.int64), *leaves[1:])
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = rng.standard_normal(got.shape).astype(np.float32)
    got.backward(_t(g))
    for leaf, w in zip(leaves, vjp(jnp.asarray(g))):
        _vjp_close(leaf.grad.numpy(), w)


def test_interp_backward_skips_what_is_not_asked():
    rng = np.random.default_rng(RNG_SEED + 5)
    f, p = 9, 50
    table = _t(rng.standard_normal((f, 3, 2)).astype(np.float32))
    idx = _t(_idx(rng, (p,), f), torch.int64)
    ws = [_t(rng.uniform(0, 1, p).astype(np.float32)) for _ in range(3)]
    g = _t(rng.standard_normal((2, p)).astype(np.float32))
    d_table, d_ws = tig.interp_rows_backward(table, idx, *ws, g,
                                             need_weights=False)
    assert d_ws is None and d_table.shape == (f, 3, 2)
    d_table, d_ws = tig.interp_rows_backward(table, idx, *ws, g,
                                             need_table=False)
    assert d_table is None and len(d_ws) == 3


def test_wrappers_reject_bad_inputs():
    table = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="int64"):
        tg.gather_rows_cm(table, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous float32"):
        tg.gather_rows_cm(table.double(), torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError, match="no rows"):
        tg.scatter_rows_cm(torch.zeros(3, 5), torch.zeros(5,
                                                          dtype=torch.int64),
                           0)
    with pytest.raises(ValueError, match=r"\(F, 3, D\)"):
        tig.interp_rows(table, torch.zeros(5, dtype=torch.int64),
                        *[torch.zeros(5)] * 3)
