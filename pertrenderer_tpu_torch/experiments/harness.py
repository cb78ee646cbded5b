"""Pose optimisation through the perturbed renderer (PyTorch port of the
pose loop of ``pertrenderer_tpu/experiments/harness.py``).

One step renders the posed mesh and its image loss against the target
with ``MeshRenderer.render_loss`` — one launch of kernel K2 on the card,
which gives the loss and every gradient — then guards against exploded
gradients, takes an Adam step on the axis-angle pose ``log_rot`` and keeps
the best iterate and an EMA of the smoothing parameters' gradients.  The
steps run eagerly in segments of ``segment_size``; at a segment boundary
past step 100 the host anneals the smoothing (sigma, gamma, blur, sample
count, learning rate), as the reference's loop does.  On the binned route
(an approximation the user opts into) every segment boundary also probes
the binning capacity at the current pose (``capacity_stats``) and applies
the settings' overflow policy (``check_capacity_host``).

Random numbers come from an explicit CPU ``torch.Generator``: the initial
pose perturbation, each step's estimator seed words and the guard noise.

``init_target`` builds an experiment's scene and its target image through
``get_hard_rendering`` — the reference's Hard-Phong render at K = 1, which
takes the staged route (kernels K9a and K10a on the card).

Not ported yet (ROADMAP Queue 1): checkpoint and resume, artifacts,
``max_dispatch_steps``, the ShapeNet categories (they need the dataset)
and the scene-parameter loop.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.ops import binned, fused_render
from pertrenderer_tpu_torch.transforms import (Rotate, matmul3,
                                               random_rotations, so3_exp_map,
                                               so3_log_map)

__all__ = ["NOISE_MENU", "make_smoothers", "init_renderers", "init_target",
           "get_hard_rendering", "PoseState", "StepOut", "pose_step",
           "optimize_pose", "PoseOptResult"]

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
        r_init = matmul3(R_true, r_pert)
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


def _normalize_mesh(mesh):
    """Centred on the first mesh's vertex mean and scaled to the unit box."""
    verts = mesh.verts[0]
    center = verts.mean(0)
    scale = torch.max(torch.abs(verts - center))
    return mesh.offset_verts(-center.expand_as(verts)).scale_verts(
        1.0 / scale)


def get_hard_rendering(mesh, camera, lights, imsize):
    """The reference's Hard-Phong render (K = 1, no blur, black
    background): the staged route."""
    settings = ptt.RasterizationSettings(
        image_size=imsize, blur_radius=0.0, faces_per_pixel=1,
        max_faces_per_bin=100000)
    renderer = ptt.MeshRenderer(
        ptt.MeshRasterizer(camera, settings),
        ptt.HardPhongShader.create(
            cameras=camera, lights=lights,
            blend_params=ptt.BlendParams(background_color=(0.0, 0.0, 0.0)),
            device=camera.R.device))
    return renderer(mesh, cameras=camera, lights=lights)


def init_target(generator: Optional[torch.Generator] = None,
                category: str = "cube", shapenet_path=None, imsize=128,
                R_true=None, device="cuda"):
    """An experiment's ground-truth scene and target render: (meshes,
    cameras, lights, target_rgb, R_true, elev, azim) as the JAX
    ``init_target``.  ``category`` is ``cube`` or ``sphere`` (level-3
    icosphere, white per-vertex colour, scaled x3); the true pose is
    ``R_true`` (1, 3, 3), or drawn from ``generator`` (a CPU generator,
    seed 0 if None).  ShapeNet categories need the dataset, which the
    repository does not hold: they raise."""
    if category == "cube":
        mesh = ptt.load_cube(device=device)
    elif category == "sphere":
        verts, faces = ptt.make_icosphere(3)
        mesh = ptt.Meshes.create(verts, faces, device=device,
                                 textures=ptt.TexturesVertex(torch.ones(
                                     1, verts.shape[0], 3, device=device)))
    else:
        raise FileNotFoundError(
            f"category {category!r} needs the ShapeNet dataset "
            f"(shapenet_path={shapenet_path!r}); the port renders the cube "
            "and sphere categories")
    mesh = _normalize_mesh(mesh)
    if category != "cube":
        mesh = mesh.scale_verts(3.0)
    elev = torch.linspace(30.0, 240.0, 1)
    azim = torch.linspace(120.0, 150.0, 1)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), device=device)
    r, t = ptt.look_at_view_transform(dist=6.7, elev=elev, azim=azim,
                                      device=device)
    cameras = [ptt.PerspectiveCameras.create(R=r[i:i + 1], T=t[i:i + 1],
                                             fov=60.0, device=device)
               for i in range(r.shape[0])]
    meshes = mesh.extend(len(cameras))
    if R_true is None:
        R_true = random_rotations(
            1, generator if generator is not None
            else torch.Generator().manual_seed(0), device=device)
    R_true = torch.as_tensor(R_true, dtype=torch.float32, device=device)
    rotated = meshes.update_padded(
        Rotate(R_true).transform_points(meshes.verts_padded()))
    target = get_hard_rendering(rotated, cameras[0], lights, imsize)
    target_rgb = [target[i, ..., :3] for i in range(len(cameras))]
    return meshes, cameras, lights, target_rgb, R_true, elev, azim


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
    capacity: List[dict] = dataclasses.field(default_factory=list)


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

    On the binned route each segment boundary probes the capacity at the
    current pose (``capacity_stats``; one device sync) and applies the
    settings' ``bin_overflow`` policy (``check_capacity_host``: warn,
    raise, or stay silent under 'allow').

    Returns a :class:`PoseOptResult`; ``runtimes`` holds each segment's
    wall time (ending in a device synchronisation, before the probe), the
    mean per step and the total, ``nb_samples`` the sample count of each
    segment and ``capacity`` the probe's stats at each boundary (binned
    route only)."""
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
    settings = renderer.rasterizer.raster_settings
    probe = renderer.plan(mesh, cameras=cameras,
                          lights=lights).mode == "binned"
    capacity: List[dict] = []

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
        if probe:
            with torch.no_grad():
                pred = mesh.update_padded(Rotate(so3_exp_map(
                    state.log_rot)).transform_points(mesh.verts_padded()))
                sh = renderer.shader
                stats = binned.capacity_stats(
                    pred, cameras, settings, sh.smoothrast, sh.smoothagg,
                    lights, blur_override=renderer.rasterizer.blur)
            binned.check_capacity_host(settings, stats)
            capacity.append(stats)
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
        runtimes=runtimes, images=images, nb_samples=samples,
        capacity=capacity)
