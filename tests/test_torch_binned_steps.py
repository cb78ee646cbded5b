"""The binned route's loss-and-grad plain version against the JAX
package's binned kernel (interpret mode) and the route through
``MeshRenderer``: the scene and tolerances of test_torch_binned.py."""

import numpy as np
import pytest
import torch

import jax

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch import convert
from pertrenderer_tpu_torch.ops import binned as tbin
from pertrenderer_tpu_torch.ops import fused_render as tfr

from _torch_parity import assert_image_close, one_torch_thread  # noqa: F401
from test_torch_binned import case, hold, jax_grads
from test_torch_binned_tables import IMAGE, _env, binned_scene  # noqa: F401


@pytest.mark.parametrize("noise,loss_kind", [("softras", "l1_rgb"),
                                             ("gaussian", "l2_rgb")])
def test_binned_loss_grad_plain_matches_jax(noise, loss_kind):
    jcfg, jin, cfg, tin = case(noise, n_views=1)
    n = tin[0].shape[0]
    target = np.random.default_rng(3).uniform(
        size=(n, 3, IMAGE * IMAGE)).astype(np.float32)
    lscale = 1.0 / (n * IMAGE * IMAGE * 3)
    loss, *got = tbin.binned_loss_grad_plain(
        cfg, *tin, torch.from_numpy(target), loss_kind, lscale)
    w_loss, *want = jax_grads(jcfg, jin, target, loss_kind, lscale)
    np.testing.assert_allclose(loss.numpy(), w_loss.numpy(), rtol=1e-5)
    hold(cfg, tin, got, want, noise != "softras",
         lambda a: tbin.binned_loss_grad_plain(cfg, *a, torch.from_numpy(
             target).double(), loss_kind, lscale))


def test_binned_renderer_end_to_end():
    """Through MeshRenderer on the CPU: plan() reports the binned route;
    the softras render equals JAX's renderer's (the two packages select
    from their own, equal-to-the-bit NDC tables); render_loss is the mean
    squared error of the render and its pose gradient equals autograd
    through the render (K12's backward, then K9b into the face tables);
    no kernel is launched on the CPU."""
    mesh, rend = binned_scene("softras", n_views=1)
    want = np.asarray(rend(mesh, key=jax.random.PRNGKey(0)))
    tmesh = convert.from_reference(mesh, device="cpu")
    trend = convert.from_reference(rend, device="cpu")
    assert trend.plan(tmesh).mode == "binned"
    before = dict(tfr.launch_counts)
    assert_image_close(trend(tmesh).detach().numpy(), want, mc=False)

    target = torch.rand(IMAGE, IMAGE, 3,
                        generator=torch.Generator().manual_seed(2))

    def posed(log_rot):
        return tmesh.update_padded(ptt.Rotate(ptt.so3_exp_map(log_rot))
                                   .transform_points(tmesh.verts))

    log_rot = torch.tensor([[0.1, 0.2, -0.1]], requires_grad=True)
    loss = trend.render_loss(posed(log_rot), target)
    (g_loss,) = torch.autograd.grad(loss, [log_rot])
    img = trend(posed(log_rot))
    mse = torch.mean((img[..., :3] - target) ** 2)
    torch.testing.assert_close(loss, mse, rtol=1e-5, atol=0)
    (g_img,) = torch.autograd.grad(mse, [log_rot])
    assert torch.isfinite(g_loss).all() and g_loss.abs().max() > 0
    torch.testing.assert_close(g_loss, g_img, rtol=0,
                               atol=1e-4 * float(g_img.abs().max()))
    assert tfr.launch_counts == before
