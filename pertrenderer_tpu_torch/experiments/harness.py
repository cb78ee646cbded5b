"""Pose optimisation through the perturbed renderer (PyTorch port of the
pose loop of ``pertrenderer_tpu/experiments/harness.py``).

One step renders the posed mesh and its image loss against the target
with ``MeshRenderer.render_loss`` — one launch of kernel K2 on the card,
which gives the loss and every gradient — then guards against exploded
gradients, takes an Adam step on the axis-angle pose ``log_rot`` and keeps
the best iterate and an EMA of the smoothing parameters' gradients.  The
steps run eagerly in segments of ``segment_size``; at a segment boundary
past step 100 the host anneals the smoothing (sigma, gamma, blur, sample
count, learning rate), as the reference's loop does.

Random numbers come from an explicit CPU ``torch.Generator``: the initial
pose perturbation, each step's estimator seed words and the guard noise.

Not ported yet (ROADMAP Queue 1): checkpoint and resume, artifacts, the
capacity probe, ``max_dispatch_steps``, ``init_target`` (it renders through
``HardPhongShader``, the unported staged route) and the scene-parameter
loop.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.ops import fused_render
from pertrenderer_tpu_torch.transforms import (Rotate, random_rotations,
                                               so3_exp_map, so3_log_map)

__all__ = ["NOISE_MENU", "make_smoothers", "init_renderers", "PoseState",
           "StepOut", "pose_step", "optimize_pose", "PoseOptResult"]

_BLUR_CONST = float(np.log(1.0 / 1e-4 - 1.0))

NOISE_MENU = ("cauchy", "gaussian", "gaussian_wovr", "uniform", "hard",
              "softras")


def make_smoothers(noise_type: str, sigma: float, gamma: float,
                   alpha: float = 1.0, nb_samples: int = 16):
    """(smoothrast, smoothagg) of the reference's noise-type menu."""
    if noise_type == "cauchy":
        return (ptt.ArctanRast.create(sigma=sigma, nb_samples=nb_samples),
                ptt.CauchyAgg.create(gamma=gamma, alpha=alpha,
                                     nb_samples=nb_samples))
    if noise_type == "gaussian":
        return (ptt.GaussianRast.create(sigma=sigma, nb_samples=nb_samples),
                ptt.GaussianAgg.create(gamma=gamma, alpha=alpha,
                                       nb_samples=nb_samples))
    if noise_type == "gaussian_wovr":
        return (ptt.GaussianRast_wovr.create(sigma=sigma,
                                             nb_samples=nb_samples),
                ptt.GaussianAgg_wovr.create(gamma=gamma, alpha=alpha,
                                            nb_samples=nb_samples))
    if noise_type == "uniform":
        return (ptt.AffineRast.create(sigma=sigma, nb_samples=nb_samples),
                ptt.HardAgg.create())
    if noise_type == "hard":
        return ptt.HardRast.create(), ptt.HardAgg.create()
    if noise_type == "softras":
        return (ptt.SoftRast.create(sigma=sigma),
                ptt.SoftAgg.create(gamma=gamma, alpha=alpha))
    raise ValueError(f"unknown noise type {noise_type!r}")


def init_renderers(camera, lights, R_true, generator=None,
                   pert_init_intensity=30.0, sigma=1e-2, gamma=5e-1,
                   alpha=1.0, nb_samples=16, noise_type=("cauchy",),
                   imsize=128, faces_per_pixel=50):
    """(log_rot_init (1, 3), renderers): the perturbed renderer bank and an
    initial pose ``pert_init_intensity`` degrees from ``R_true`` about an
    axis drawn from ``generator`` (a uniformly random pose if 0)."""
    device = camera.R.device
    if pert_init_intensity == 0.0:
        r_init = random_rotations(1, generator, device=device)
    else:
        axis = torch.randn(1, 3, generator=generator).to(device)
        angle = pert_init_intensity * math.pi / 180.0
        r_pert = so3_exp_map(
            angle * axis / torch.sqrt(torch.sum(axis * axis, dim=1,
                                                keepdim=True)))
        r_init = torch.matmul(R_true, r_pert)
    log_rot_init = so3_log_map(r_init)

    blend = ptt.BlendParams(sigma, gamma, (0.0, 0.0, 0.0))
    settings = ptt.RasterizationSettings(
        image_size=imsize, blur_radius=_BLUR_CONST * sigma,
        faces_per_pixel=faces_per_pixel, perspective_correct=False)
    alpha = 1.0   # fixed, as in the reference
    renderers = []
    for nt in noise_type:
        smoothrast, smoothagg = make_smoothers(nt, sigma, gamma, alpha,
                                               nb_samples)
        renderers.append(ptt.MeshRenderer(
            ptt.MeshRasterizer(camera, settings),
            ptt.RandomPhongShader.create(
                cameras=camera, lights=lights, blend_params=blend,
                smoothrast=smoothrast, smoothagg=smoothagg, device=device)))
    return log_rot_init, renderers


@dataclasses.dataclass
class PoseState:
    """What a pose step carries to the next: the pose (the optimizer's
    parameter), the best loss and pose so far, and the EMA of the
    (sigma, gamma, alpha) gradients that drives annealing.  Tensors stay on
    the device, so a step never waits for the card."""

    log_rot: torch.Tensor
    best_loss: torch.Tensor
    best_log_rot: torch.Tensor
    ema: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

    @classmethod
    def start(cls, log_rot) -> "PoseState":
        log_rot = log_rot.detach().clone().requires_grad_()
        zero = torch.zeros((), device=log_rot.device)
        return cls(log_rot=log_rot,
                   best_loss=torch.full((), math.inf, device=log_rot.device),
                   best_log_rot=log_rot.detach().clone(),
                   ema=(zero, zero.clone(), zero.clone()))


@dataclasses.dataclass
class StepOut:
    """One step's loss, pose-gradient norm, pose gradient (before the
    guard) and (sigma, gamma, alpha) gradients."""

    loss: torch.Tensor
    gnorm: torch.Tensor
    g_pose: torch.Tensor
    g_smooth: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def pose_loss(mesh, target, log_rot, smoothing, renderer, cameras, lights,
              seeds):
    """The L2 image loss of ``mesh`` rotated by ``log_rot`` and rendered
    with the smoothing (sigma, gamma, alpha) tensors."""
    sigma, gamma, alpha = smoothing
    renderer = renderer.replace(shader=renderer.shader.update_smoothing(
        sigma=sigma, gamma=gamma, alpha=alpha))
    rot = so3_exp_map(log_rot)
    pred = mesh.update_padded(Rotate(rot).transform_points(
        mesh.verts_padded()))
    return renderer.render_loss(pred, target, seeds=seeds, cameras=cameras,
                                lights=lights)


def pose_step(mesh, target, state: PoseState, renderer, cameras, lights,
              optimizer: torch.optim.Optimizer, seeds,
              guard_noise) -> Tuple[PoseState, StepOut]:
    """One step of the pose loop: loss and gradients (one K2 launch),
    explosion guard (a gradient norm above 1000 becomes 1e-5 * noise),
    optimizer step on ``state.log_rot``, best-iterate tracking and the
    EMA of the smoothing gradients.  ``seeds``: the estimators' (N, 4)
    seed words; ``guard_noise``: noise shaped like ``log_rot``."""
    dev = state.log_rot.device
    smoothing = [torch.as_tensor(x, dtype=torch.float32, device=dev)
                 .detach().clone().requires_grad_()
                 for x in renderer.shader.get_smoothing()]
    loss = pose_loss(mesh, target, state.log_rot, smoothing, renderer,
                     cameras, lights, seeds)
    grads = torch.autograd.grad(loss, [state.log_rot, *smoothing],
                                allow_unused=True)
    g_pose, *g_smooth = [torch.zeros_like(x) if g is None else g
                         for x, g in zip([state.log_rot, *smoothing], grads)]
    gnorm = torch.sqrt(torch.sum(g_pose * g_pose))
    guarded = torch.where(gnorm > 1000.0, 1e-5 * guard_noise.to(dev), g_pose)
    pose_before = state.log_rot.detach().clone()
    loss = loss.detach()
    optimizer.zero_grad(set_to_none=True)
    state.log_rot.grad = guarded
    optimizer.step()
    improved = loss < state.best_loss
    new = PoseState(
        log_rot=state.log_rot,
        best_loss=torch.where(improved, loss, state.best_loss),
        best_log_rot=torch.where(improved, pose_before, state.best_log_rot),
        ema=tuple(0.9 * v + 0.1 * g for v, g in zip(state.ema, g_smooth)))
    return new, StepOut(loss=loss, gnorm=gnorm.detach(), g_pose=g_pose,
                        g_smooth=tuple(g_smooth))


@dataclasses.dataclass
class PoseOptResult:
    best_log_rot: torch.Tensor
    log_rot: torch.Tensor
    losses: np.ndarray
    grad_norms: np.ndarray
    runtimes: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    images: List[np.ndarray] = dataclasses.field(default_factory=list)
    nb_samples: List[int] = dataclasses.field(default_factory=list)


def _make_optimizer(name: str, log_rot, lr: float):
    if name == "sgd":
        return torch.optim.SGD([log_rot], lr=lr, momentum=0.9)
    return torch.optim.Adam([log_rot], lr=lr)


def optimize_pose(mesh, cameras, lights, init_pose, diff_renderer,
                  target_rgb, generator: Optional[torch.Generator] = None,
                  lr_init=5e-2, Niter=100, optimizer="adam", adapt_reg=False,
                  adapt_params=(1.1, 1.5), segment_size=50,
                  collect_images=False, anneal_sample_cap=128):
    """Pose optimisation with the reference's schedule.

    ``target_rgb``: a list whose first entry is the (H, W, 3) or
    (1, H, W, 3) target; ``cameras`` a camera or a list whose first entry
    is used.  ``generator`` (CPU; seed 0 if None) draws every step's seed
    words and guard noise.  Steps run in uniform segments of
    ``segment_size``; the host reads the losses and anneals only at
    segment boundaries (with ``adapt_reg``, past step 100 and before the
    last: sigma / adapt_params[0], gamma / adapt_params[1], blur from the
    new sigma, sample count doubled up to ``anneal_sample_cap``, lr / 1.5,
    and the optimizer state and EMA reset).

    Returns a :class:`PoseOptResult`; ``runtimes`` holds each segment's
    wall time (ending in a device synchronisation), the mean per step and
    the total, and ``nb_samples`` the sample count of each segment."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    target = target_rgb[0][None] if target_rgb[0].dim() == 3 \
        else target_rgb[0]
    cameras = cameras[0] if isinstance(cameras, (list, tuple)) else cameras
    dev = mesh.device
    lr = lr_init
    renderer = diff_renderer.replace(
        rasterizer=diff_renderer.rasterizer.update_blur(
            diff_renderer.rasterizer.blur))
    state = PoseState.start(torch.as_tensor(init_pose, dtype=torch.float32,
                                            device=dev))
    opt = _make_optimizer(optimizer, state.log_rot, lr)
    fixed = getattr(renderer.shader.smoothagg, "fixed_noise", False)

    boundaries = [min(Niter, segment_size)]
    while boundaries[-1] < Niter:
        boundaries.append(min(Niter, boundaries[-1] + segment_size))

    losses: List[np.ndarray] = []
    gnorms: List[np.ndarray] = []
    seg_times: List[float] = []
    images: List[np.ndarray] = []
    samples: List[int] = []
    start = 0
    for end in boundaries:
        samples.append(renderer.shader.get_nb_samples())
        seg_loss, seg_gnorm = [], []
        t0 = time.perf_counter()
        for _ in range(end - start):
            seeds = fused_render.draw_seeds(mesh.batch_size, generator,
                                            fixed, device=dev)
            noise = torch.randn(state.log_rot.shape, generator=generator)
            state, out = pose_step(mesh, target, state, renderer, cameras,
                                   lights, opt, seeds, noise)
            seg_loss.append(out.loss)
            seg_gnorm.append(out.gnorm)
        losses.append(torch.stack(seg_loss).cpu().numpy())   # waits
        gnorms.append(torch.stack(seg_gnorm).cpu().numpy())
        seg_times.append(time.perf_counter() - t0)
        if collect_images:
            with torch.no_grad():
                rot = so3_exp_map(state.log_rot)
                pred = mesh.update_padded(Rotate(rot).transform_points(
                    mesh.verts_padded()))
                img = renderer(pred, generator=generator, cameras=cameras,
                               lights=lights)
            images.append(img[..., :3].cpu().numpy())
        start = end

        # Host-side annealing at the segment boundary.
        v_sigma, v_gamma, v_alpha = (float(x) for x in state.ema)
        if adapt_reg and 100 < end < Niter and v_gamma > 0:
            sigma, gamma, _ = renderer.shader.get_smoothing()
            new_sigma = max(float(sigma) / adapt_params[0], 5e-5)
            new_gamma = max(float(gamma) / adapt_params[1], 5e-4)
            nb = renderer.shader.get_nb_samples()
            renderer = renderer.replace(
                rasterizer=renderer.rasterizer.update_blur(
                    _BLUR_CONST * new_sigma),
                shader=renderer.shader.update_smoothing(
                    sigma=new_sigma, gamma=new_gamma)
                .update_nb_samples(min(2 * nb, anneal_sample_cap)))
            lr = max(lr / 1.5, 1e-4)
            opt = _make_optimizer(optimizer, state.log_rot, lr)
            zero = torch.zeros((), device=dev)
            state = dataclasses.replace(state,
                                        ema=(zero, zero.clone(),
                                             zero.clone()))

    total = float(sum(seg_times))
    runtimes = {"segment": seg_times, "per_iter": [total / max(Niter, 1)],
                "total": [total]}
    return PoseOptResult(
        best_log_rot=state.best_log_rot, log_rot=state.log_rot.detach(),
        losses=np.concatenate(losses) if losses else np.zeros(0),
        grad_norms=np.concatenate(gnorms) if gnorms else np.zeros(0),
        runtimes=runtimes, images=images, nb_samples=samples)
