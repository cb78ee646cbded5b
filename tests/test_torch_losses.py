"""The port's mesh losses and point-cloud metrics against the JAX
package's (``pertrenderer_tpu/losses.py``).

Scenes: the level-2 icosphere, a batch of two with seeded vertex noise
(0.02 of the radius) and the last faces of the second mesh padded (-1),
and the cube.  Values and gradients to the vertices (or features) within
rtol 1e-5 / atol 1e-6.  Padding faces read vertex 0 and a vertex that only
padding faces named has no neighbours: there a norm of zero length has
the gradient 0/0, NaN in both packages, so the NaNs must sit at the same
places.  Plus ``vertex_feature_laplacian``'s exact zero subgradient at a
constant field, and ``knn_points``' indices equal on points without
ties.

The Laplacians also on a distorted icosphere (vertex noise 0.05 of the
radius), whose thin faces part both packages' float32 cotangent
gradients from float64 by up to ~1e-3 of their max (JAX's 7e-4, the
port's 1e-4): there each package is held against the port evaluated in
float64 (the same formula on float64 vertices), values rtol 1e-5 and
gradients within 1e-3 of the max |grad|, so an error of the port alone
still parts it from JAX's float32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pertrenderer_tpu as pt
import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu import losses as jl
from pertrenderer_tpu_torch import losses as tl

RTOL, ATOL = 1e-5, 1e-6
SCENES = ("icosphere", "cube")


def _arrays(kind):
    """(verts (N, V, 3), faces (N, F, 3)) float32 / int32 numpy; kind
    ``distorted``: the icosphere with vertex noise 0.05."""
    if kind == "cube":
        mesh = pt.load_cube()
        return (np.asarray(mesh.verts, np.float32),
                np.asarray(mesh.faces, np.int32))
    verts, faces = pt.make_icosphere(2)
    rng = np.random.default_rng(11)
    verts = np.asarray(verts, np.float32)
    noise = 0.05 if kind == "distorted" else 0.02
    v = np.stack([verts + noise * rng.standard_normal(verts.shape),
                  1.3 * verts + noise * rng.standard_normal(verts.shape)])
    f = np.stack([np.asarray(faces, np.int32)] * 2)
    f[1, -7:] = -1
    return v.astype(np.float32), f


def _meshes(kind):
    verts, faces = _arrays(kind)
    jmesh = pt.Meshes.create(jnp.asarray(verts), jnp.asarray(faces))
    tmesh = ptt.Meshes.create(torch.from_numpy(verts),
                              torch.from_numpy(faces.astype(np.int64)),
                              device="cpu")
    return verts, jmesh, tmesh


def _value_and_grad_pair(kind, jfn, tfn):
    """(port value, port grad, JAX value, JAX grad) of a loss of the
    vertices."""
    verts, jmesh, tmesh = _meshes(kind)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda v: jfn(jmesh.update_padded(v))))(jnp.asarray(verts))
    tv = torch.from_numpy(verts).requires_grad_()
    tval = tfn(tmesh.update_padded(tv))
    (tgrad,) = torch.autograd.grad(tval, [tv])
    return tval.item(), tgrad.numpy(), float(jval), np.asarray(jgrad)


def _assert_pair(kind, jfn, tfn):
    tval, tgrad, jval, jgrad = _value_and_grad_pair(kind, jfn, tfn)
    assert np.isfinite(tval)
    np.testing.assert_allclose(tval, jval, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tgrad, jgrad, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


@pytest.mark.parametrize("kind", SCENES)
@pytest.mark.parametrize("method", ["uniform", "cot", "cotcurv"])
def test_laplacian_smoothing_matches_jax(kind, method):
    _assert_pair(kind,
                 lambda m: jl.mesh_laplacian_smoothing(m, method=method),
                 lambda m: tl.mesh_laplacian_smoothing(m, method=method))


@pytest.mark.parametrize("method", ["uniform", "cot", "cotcurv"])
def test_laplacian_smoothing_on_a_distorted_mesh_near_float64(method):
    tval, tgrad, jval, jgrad = _value_and_grad_pair(
        "distorted",
        lambda m: jl.mesh_laplacian_smoothing(m, method=method),
        lambda m: tl.mesh_laplacian_smoothing(m, method=method))
    verts, _jmesh, tmesh = _meshes("distorted")
    v64 = torch.from_numpy(verts).double().requires_grad_()
    mesh64 = ptt.Meshes.create(v64.detach(), tmesh.faces, device="cpu")
    qval = tl.mesh_laplacian_smoothing(mesh64.update_padded(v64),
                                       method=method)
    (qgrad,) = torch.autograd.grad(qval, [v64])
    qgrad = qgrad.numpy()
    scale = np.nanmax(np.abs(qgrad))
    for val, grad in ((tval, tgrad), (jval, jgrad)):
        np.testing.assert_allclose(val, qval.item(), rtol=RTOL)
        assert np.array_equal(np.isnan(grad), np.isnan(qgrad))
        assert np.nanmax(np.abs(grad - qgrad)) <= 1e-3 * scale


@pytest.mark.parametrize("kind", SCENES)
def test_edge_loss_matches_jax(kind):
    _assert_pair(kind, lambda m: jl.mesh_edge_loss(m, target_length=0.3),
                 lambda m: tl.mesh_edge_loss(m, target_length=0.3))


@pytest.mark.parametrize("kind", SCENES)
def test_normal_consistency_matches_jax(kind):
    _assert_pair(kind, jl.mesh_normal_consistency,
                 tl.mesh_normal_consistency)


@pytest.mark.parametrize("kind", SCENES)
def test_vertex_feature_laplacian_matches_jax(kind):
    verts, jmesh, tmesh = _meshes(kind)
    feats = np.random.default_rng(4).uniform(
        size=(1, verts.shape[1], 3)).astype(np.float32)
    jval, jgrad = jax.jit(jax.value_and_grad(
        lambda f: jl.vertex_feature_laplacian(jmesh, f)))(jnp.asarray(feats))
    tf = torch.from_numpy(feats).requires_grad_()
    tval = tl.vertex_feature_laplacian(tmesh, tf)
    (tgrad,) = torch.autograd.grad(tval, [tf])
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=RTOL,
                               atol=ATOL)


def test_vertex_feature_laplacian_constant_field_has_zero_subgradient():
    """A white texture (the scene loop's start) has a zero residual at
    every vertex: the loss is 0 and its gradient exactly 0, not NaN, in
    both packages."""
    verts, jmesh, tmesh = _meshes("icosphere")
    ones = np.ones((1, verts.shape[1], 3), np.float32)
    jval, jgrad = jax.value_and_grad(          # eager: exact residuals
        lambda f: jl.vertex_feature_laplacian(jmesh, f))(jnp.asarray(ones))
    tf = torch.from_numpy(ones).requires_grad_()
    tval = tl.vertex_feature_laplacian(tmesh, tf)
    (tgrad,) = torch.autograd.grad(tval, [tf])
    assert tval.item() == 0.0 == float(jval)
    assert torch.equal(tgrad, torch.zeros_like(tgrad))
    assert np.array_equal(np.asarray(jgrad), np.zeros_like(ones))


def test_knn_points_and_chamfer_match_jax():
    """Seeded clouds whose K = 3 nearest distances are all distinct: equal
    indices, distances and the chamfer loss with its gradients within
    rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, 3)).astype(np.float32)
    y = rng.standard_normal((2, 50, 3)).astype(np.float32)
    d_all = np.sort(((x[:, :, None] - y[:, None]) ** 2).sum(-1), axis=-1)
    assert np.all(np.diff(d_all[..., :4], axis=-1) > 1e-5)   # tie-free
    jd, ji = jax.jit(lambda a, b: jl.knn_points(a, b, K=3))(
        jnp.asarray(x), jnp.asarray(y))
    td, ti = tl.knn_points(torch.from_numpy(x), torch.from_numpy(y), K=3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)

    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda a, b: jl.chamfer_distance(a, b)[0], argnums=(0, 1)))(
            jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    tval, none = tl.chamfer_distance(tx, ty)
    assert none is None
    tgrads = torch.autograd.grad(tval, [tx, ty])
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
