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
With a ``checkpoint_dir`` the loop saves its whole state at every segment
boundary (``utils/checkpoint.py``: the pose, the optimizer's state, the
generator's state, the best iterate, the EMA and the annealing state), and
``resume`` continues from the latest checkpoint on the uninterrupted run's
trajectory, bit for bit (the kernels' sums have a fixed order).

``optimize_scene_params`` is the scene-parameter loop: vertex colours,
vertex offsets, per-view camera elevation and azimuth and the light
location, the camera and light rebuilt inside every step from the
optimised scalars (``look_at_view_transform``), an L1 image loss from one
launch of K2 (flat) or K7 (stream) plus a uniform Laplacian of the mesh
(K9a / K9b), Adam per parameter group, annealing, checkpoints and resume.

``init_target`` builds an experiment's scene and its target image through
``get_hard_rendering`` — the reference's Hard-Phong render at K = 1, which
takes the staged route (kernels K9a and K10a on the card);
``init_base_mesh_cameras_lights`` the scene loop's source mesh and start.

The ShapeNet categories load one model each from an extracted
ShapeNetCore directory (``shapenet_path``) with its texture baked into a
4 x 4 atlas (``_load_shapenet``); without the directory they raise.

Not ported: ``max_dispatch_steps`` and the scan segments (they exist for
XLA; the port runs a plain loop).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import pertrenderer_tpu_torch as ptt
from pertrenderer_tpu_torch.losses import (mesh_laplacian_smoothing,
                                           vertex_feature_laplacian)
from pertrenderer_tpu_torch.ops import binned, fused_render
from pertrenderer_tpu_torch.transforms import (Rotate, matmul3,
                                               random_rotations, so3_exp_map,
                                               so3_log_map)
from pertrenderer_tpu_torch.utils import artifacts as _art
from pertrenderer_tpu_torch.utils import checkpoint as _ckpt

__all__ = ["NOISE_MENU", "make_smoothers", "init_renderers", "init_target",
           "init_base_mesh_cameras_lights", "get_hard_rendering",
           "PoseState", "StepOut", "pose_step", "optimize_pose",
           "PoseOptResult", "SCENE_PARAMS", "SceneState", "SceneStepOut",
           "scene_loss", "scene_step", "optimize_scene_params"]

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
                   imsize=128, faces_per_pixel=50, device="cuda"):
    """(log_rot_init (1, 3), renderers): the perturbed renderer bank and an
    initial pose ``pert_init_intensity`` degrees from ``R_true`` about an
    axis drawn from ``generator`` (a uniformly random pose if 0).  With
    ``camera`` None (the scene loop passes its cameras at every render)
    the renderers live on ``device``."""
    device = camera.R.device if camera is not None else torch.device(device)
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


def normalize_mesh(mesh, extent: float = 1.0):
    """Centred on the first mesh's vertex mean and scaled so that its
    largest |coordinate - centre| is ``extent`` (1: the unit box)."""
    verts = mesh.verts[0]
    center = verts.mean(0)
    scale = torch.max(torch.abs(verts - center))
    return mesh.offset_verts(-center.expand_as(verts)).scale_verts(
        extent / scale)


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
    seed 0 if None).  Any other category is a ShapeNet category
    (``SHAPENET_CATEGORIES``), loaded from ``shapenet_path`` by
    ``_load_shapenet`` (FileNotFoundError without it) and scaled x3."""
    if category == "cube":
        mesh = ptt.load_cube(device=device)
    elif category == "sphere":
        verts, faces = ptt.make_icosphere(3)
        mesh = ptt.Meshes.create(verts, faces, device=device,
                                 textures=ptt.TexturesVertex(torch.ones(
                                     1, verts.shape[0], 3, device=device)))
    else:
        mesh = _load_shapenet(category, shapenet_path, device)
    mesh = normalize_mesh(mesh)
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


# ShapeNetCore synset ids and the model used per category, as the
# reference's loader names them.
SHAPENET_CATEGORIES = {
    "table": "04379243", "car": "02958343", "chair": "03001627",
    "airplane": "02691156", "sofa": "04256520", "rifle": "04090263",
    "mug": "03797390", "microwave": "03761084", "mailbox": "03710193",
    "bus": "02924116", "speaker": "03691459", "display": "03211117",
    "dishwasher": "03207941", "bag": "02773838", "lamp": "03636649",
    "birdhouse": "02843684",
}
SHAPENET_MODELS = {
    "mug": "bea77759a3e5f9037ae0031c221d81a4",
    "airplane": "ffccda82ecc0d0f71740529c616cd4c7",
    "microwave": "c1851c910969d154df78375e5c76ea3d",
    "mailbox": "10e1051cbe10626e30a706157956b491",
    "bus": "7ad09b362de71bfaadcb6d6a1ff60276",
    "speaker": "1d4bb07ac73996182339c28050e32573",
    "display": "2e6204b4aa7ba83fbd28395acf9af65e",
    "dishwasher": "fb15942e4096d8f0263a7f81856f9708",
    "bag": "a55b721ea5a29d7f639ff561fa3f5bac",
    "lamp": "4a868756ae6404a5c0bc57897eddf6f",
    "birdhouse": "7f53db3b31fe08283c2748dd7bf1793a",
}


def _load_shapenet(category, shapenet_path, device="cuda"):
    """The category's ShapeNetCore model
    (``<shapenet_path>/<synset>/<model>/models/model_normalized.obj``)
    with its texture baked into a 4 x 4 atlas (``TexturesAtlas``), or
    white per-vertex colour where the model has no texture map.  Raises
    FileNotFoundError if ``shapenet_path`` is not a directory."""
    if shapenet_path is None or not os.path.isdir(shapenet_path):
        raise FileNotFoundError(
            f"ShapeNet category {category!r} requires --dataset-directory "
            f"pointing at ShapeNetCore (got {shapenet_path!r})")
    obj = os.path.join(shapenet_path, SHAPENET_CATEGORIES[category],
                       SHAPENET_MODELS[category], "models",
                       "model_normalized.obj")
    verts, faces, aux = ptt.load_obj(obj, load_textures=True,
                                     create_texture_atlas=True,
                                     texture_atlas_size=4,
                                     texture_wrap="repeat")
    if aux.texture_atlas is not None:
        textures = ptt.TexturesAtlas(torch.as_tensor(
            aux.texture_atlas[None], dtype=torch.float32, device=device))
    else:
        textures = ptt.TexturesVertex(torch.ones(
            1, verts.shape[0], 3, device=device))
    return ptt.Meshes.create(verts, faces.verts_idx, textures=textures,
                             device=device)


def init_base_mesh_cameras_lights(category="sphere", params_to_check=None,
                                  device="cuda"):
    """The scene loop's source mesh and starting scalars: (src_mesh,
    deform_init (V, 3) zeros, verts_rgb_init (1, V, 3) ones, camera_elev
    (1,), camera_azim (1,), lights_location (1, 3)), as the JAX
    package's.  The mesh is the level-3 icosphere (untextured, centred and
    scaled to a box of half-width 0.5) for ``sphere`` or when the vertices
    are optimised, else the cube; the camera starts at elev 20 / azim 100
    when it is optimised (else 30 / 120), the light at (0, 6, -1) when it
    is (else (0, 2, -2))."""
    params_to_check = params_to_check or {}
    if category == "sphere" or params_to_check.get("vertices"):
        verts, faces = ptt.make_icosphere(3)
        src_mesh = ptt.Meshes.create(verts, faces, device=device)
    else:
        src_mesh = ptt.load_cube(device=device)
    n = src_mesh.verts.shape[1]
    if category == "sphere":
        src_mesh = normalize_mesh(src_mesh, 0.5)
    deform_init = torch.zeros(n, 3, device=device)
    verts_rgb_init = torch.ones(1, n, 3, device=device)
    camera = (20.0, 100.0) if params_to_check.get("camera") else (30.0,
                                                                  120.0)
    camera_elev = torch.full((1,), camera[0], device=device)
    camera_azim = torch.full((1,), camera[1], device=device)
    light = ((0.0, 6.0, -1.0) if params_to_check.get("light")
             else (0.0, 2.0, -2.0))
    lights_location = torch.tensor([light], device=device)
    return (src_mesh, deform_init, verts_rgb_init, camera_elev, camera_azim,
            lights_location)


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


def _make_optimizer(name: str, params, lr: float):
    """Adam, or SGD with momentum 0.9, over ``params`` (a tensor or a list
    of parameter groups)."""
    params = [params] if isinstance(params, torch.Tensor) else params
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    return torch.optim.Adam(params, lr=lr)


def _boundaries(n_iter: int, segment_size: int) -> List[int]:
    """The ends of uniform segments of ``segment_size`` steps."""
    ends = [min(n_iter, segment_size)]
    while ends[-1] < n_iter:
        ends.append(min(n_iter, ends[-1] + segment_size))
    return ends


def _smoothing_state(renderer) -> dict:
    """The renderer's annealed state as Python numbers (exact: float32
    values round-trip through float64)."""
    sigma, gamma, alpha = (float(x) for x in renderer.shader.get_smoothing())
    return {"sigma": sigma, "gamma": gamma, "alpha": alpha,
            "nb_samples": int(renderer.shader.get_nb_samples()),
            "blur": float(renderer.rasterizer.blur)}


def _restore_smoothing(renderer, st: dict):
    """``renderer`` with the annealed state of a checkpoint."""
    return renderer.replace(
        rasterizer=renderer.rasterizer.update_blur(st["blur"]),
        shader=renderer.shader.update_smoothing(
            sigma=st["sigma"], gamma=st["gamma"], alpha=st["alpha"])
        .update_nb_samples(st["nb_samples"]))


def _anneal(renderer, sigma, gamma, sample_cap: int):
    """``renderer`` at the new sigma and gamma, the blur set from sigma
    and the sample count doubled up to ``sample_cap``."""
    nb = renderer.shader.get_nb_samples()
    return renderer.replace(
        rasterizer=renderer.rasterizer.update_blur(_BLUR_CONST * sigma),
        shader=renderer.shader.update_smoothing(sigma=sigma, gamma=gamma)
        .update_nb_samples(min(2 * nb, sample_cap)))


def _history(chunks: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def optimize_pose(mesh, cameras, lights, init_pose, diff_renderer,
                  target_rgb, generator: Optional[torch.Generator] = None,
                  lr_init=5e-2, Niter=100, optimizer="adam", adapt_reg=False,
                  adapt_params=(1.1, 1.5), segment_size=50,
                  collect_images=False, anneal_sample_cap=128,
                  artifacts_dir=None, checkpoint_dir=None, resume=False,
                  max_segments=None):
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

    ``checkpoint_dir``: the whole run state is saved there at every
    segment boundary (after its annealing); ``resume`` restores the latest
    checkpoint, the caller's generator included, and continues the
    uninterrupted run's trajectory.  ``max_segments`` stops after that
    many segments of this call (a killed run; its checkpoint is on disk).
    ``artifacts_dir``: the loss and gradient-norm histories
    (``loss_values.npy`` / ``gradient_values.npy``) and a grid of the
    target and the render at each boundary (``collect_images``; those
    renders draw their seed words from a generator of their own, so they
    leave the trajectory as it is).

    Returns a :class:`PoseOptResult`; ``runtimes`` holds each segment's
    wall time (ending in a device synchronisation, before the probe), the
    mean per step and the total, ``nb_samples`` the sample count of each
    segment and ``capacity`` the probe's stats at each boundary (binned
    route only)."""
    if artifacts_dir is not None:
        collect_images = True
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

    losses: List[np.ndarray] = []
    gnorms: List[np.ndarray] = []
    seg_times: List[float] = []
    images: List[np.ndarray] = []
    samples: List[int] = []
    start = 0
    if resume and checkpoint_dir is not None \
            and _ckpt.latest_step(checkpoint_dir) is not None:
        st = _ckpt.restore_checkpoint(checkpoint_dir)
        lr = st["lr"]
        renderer = _restore_smoothing(renderer, st)
        state = PoseState(log_rot=st["log_rot"].to(dev).requires_grad_(),
                          best_loss=st["best_loss"].to(dev),
                          best_log_rot=st["best_log_rot"].to(dev),
                          ema=tuple(x.to(dev) for x in st["ema"]))
        opt = _make_optimizer(optimizer, state.log_rot, lr)
        opt.load_state_dict(st["optimizer"])
        generator.set_state(st["generator"])
        losses.append(st["losses"].numpy())
        gnorms.append(st["gnorms"].numpy())
        start = st["step"]

    def save(step):
        _ckpt.save_checkpoint(checkpoint_dir, {
            "log_rot": state.log_rot.detach(), "optimizer": opt.state_dict(),
            "generator": generator.get_state(),
            "best_loss": state.best_loss, "best_log_rot": state.best_log_rot,
            "ema": list(state.ema), **_smoothing_state(renderer), "lr": lr,
            "step": step, "losses": torch.from_numpy(_history(losses)),
            "gnorms": torch.from_numpy(_history(gnorms))}, step)

    segments_run = 0
    for end in _boundaries(Niter, segment_size):
        if end <= start:
            continue
        if max_segments is not None and segments_run >= max_segments:
            break
        segments_run += 1
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
                img = renderer(pred, generator=torch.Generator().manual_seed(
                    end), cameras=cameras, lights=lights)
            images.append(img[..., :3].cpu().numpy())
        start = end

        # Host-side annealing at the segment boundary.
        v_sigma, v_gamma, v_alpha = (float(x) for x in state.ema)
        if adapt_reg and 100 < end < Niter and v_gamma > 0:
            sigma, gamma, _ = renderer.shader.get_smoothing()
            renderer = _anneal(renderer,
                               max(float(sigma) / adapt_params[0], 5e-5),
                               max(float(gamma) / adapt_params[1], 5e-4),
                               anneal_sample_cap)
            lr = max(lr / 1.5, 1e-4)
            opt = _make_optimizer(optimizer, state.log_rot, lr)
            zero = torch.zeros((), device=dev)
            state = dataclasses.replace(state,
                                        ema=(zero, zero.clone(),
                                             zero.clone()))
        if checkpoint_dir is not None:
            save(end)

    all_losses, all_gnorms = _history(losses), _history(gnorms)
    if artifacts_dir is not None:
        _art.save_histories(artifacts_dir, all_losses, all_gnorms)
        if images:
            grid = np.concatenate(
                [target.reshape((1,) + target.shape[-3:]).cpu().numpy()]
                + [im[:1] for im in images], axis=0)
            n = grid.shape[0]
            _art.image_grid(grid, artifacts_dir, rows=max(1, (n + 3) // 4),
                            cols=min(n, 4))
    total = float(sum(seg_times))
    runtimes = {"segment": seg_times, "per_iter": [total / max(Niter, 1)],
                "total": [total]}
    return PoseOptResult(
        best_log_rot=state.best_log_rot, log_rot=state.log_rot.detach(),
        losses=all_losses, grad_norms=all_gnorms,
        runtimes=runtimes, images=images, nb_samples=samples,
        capacity=capacity)


# ---------------------------------------------------------------------------
# Scene-parameter optimisation
# ---------------------------------------------------------------------------

SCENE_PARAMS = ("verts_rgb", "deform", "camera_elev", "camera_azim",
                "lights_location")


@dataclasses.dataclass
class SceneState:
    """What a scene step carries to the next: the parameters (the
    trainable ones are the optimizer's leaves), the best loss and the
    parameters that scored it."""

    params: Dict[str, torch.Tensor]
    best_loss: torch.Tensor
    best_params: Dict[str, torch.Tensor]

    @classmethod
    def start(cls, params: Dict[str, torch.Tensor],
              trainable: Dict[str, bool]) -> "SceneState":
        params = {k: v.detach().clone().requires_grad_(trainable[k])
                  for k, v in params.items()}
        dev = params["camera_elev"].device
        return cls(params=params,
                   best_loss=torch.full((), math.inf, device=dev),
                   best_params={k: v.detach().clone()
                                for k, v in params.items()})


@dataclasses.dataclass
class SceneStepOut:
    """One step's total loss, its L1 image and Laplacian terms, and the
    trainable parameters' gradients (non-finite entries zeroed)."""

    loss: torch.Tensor
    loss_rgb: torch.Tensor
    loss_lap: torch.Tensor
    grads: Dict[str, torch.Tensor]


def scene_loss(base_mesh, target, params, renderer, seeds, textured: bool,
               laplacian_weight: float = 5e-3,
               texture_smoothing_weight: float = 0.0):
    """(total, L1 image loss, Laplacian) of the scene ``params``: the
    lights and one camera per view built from the scalars through
    ``look_at_view_transform`` (dist 6.7), the mesh offset by ``deform``
    and, if ``textured``, coloured by the clipped ``verts_rgb`` shared by
    every view; the image loss and its gradients from one launch of K2 /
    K7 (``render_loss``, ``l1_rgb``) on ``seeds``, plus
    ``laplacian_weight`` times the mesh's uniform Laplacian and, if
    textured, ``texture_smoothing_weight`` times the colours' own."""
    dev = base_mesh.device
    n_views = params["camera_elev"].numel()
    lights = ptt.PointLights.create(location=params["lights_location"],
                                    batch=n_views, device=dev)
    r, t = ptt.look_at_view_transform(dist=6.7, elev=params["camera_elev"],
                                      azim=params["camera_azim"], device=dev)
    camera = ptt.PerspectiveCameras.create(R=r, T=t, device=dev)
    mesh = base_mesh.offset_verts(params["deform"])
    if textured:
        # jnp.clip's gradient: half at the bounds (the white start).
        rgb = torch.minimum(torch.maximum(params["verts_rgb"],
                                          torch.zeros((), device=dev)),
                            torch.ones((), device=dev))
        mesh = mesh.with_textures(ptt.TexturesVertex(rgb.expand(
            (base_mesh.batch_size,) + tuple(rgb.shape[1:]))))
    loss_rgb = renderer.render_loss(mesh, target, seeds=seeds,
                                    loss_kind="l1_rgb", cameras=camera,
                                    lights=lights)
    loss_lap = mesh_laplacian_smoothing(mesh)
    total = loss_rgb + laplacian_weight * loss_lap
    if texture_smoothing_weight and textured:
        total = total + texture_smoothing_weight * vertex_feature_laplacian(
            base_mesh, params["verts_rgb"])
    return total, loss_rgb, loss_lap


def scene_step(base_mesh, target, state: SceneState, renderer,
               optimizer: Optional[torch.optim.Optimizer], seeds,
               textured: bool, laplacian_weight: float = 5e-3,
               texture_smoothing_weight: float = 0.0
               ) -> Tuple[SceneState, SceneStepOut]:
    """One step of the scene loop: the loss and the gradients of the
    trainable parameters (those that require grad), non-finite entries
    zeroed, an optimizer step, best-iterate tracking.  ``seeds``: the
    estimators' (N_views, 4) seed words."""
    total, loss_rgb, loss_lap = scene_loss(
        base_mesh, target, state.params, renderer, seeds, textured,
        laplacian_weight, texture_smoothing_weight)
    train = [k for k in SCENE_PARAMS if state.params[k].requires_grad]
    grads = {}
    if train:
        raw = torch.autograd.grad(total, [state.params[k] for k in train],
                                  allow_unused=True)
        grads = {k: (torch.zeros_like(state.params[k]) if g is None
                     else torch.where(torch.isfinite(g), g,
                                      torch.zeros_like(g)))
                 for k, g in zip(train, raw)}
    before = {k: v.detach().clone() for k, v in state.params.items()}
    total = total.detach()
    if optimizer is not None:
        optimizer.zero_grad(set_to_none=True)
        for k, g in grads.items():
            state.params[k].grad = g
        optimizer.step()
    improved = total < state.best_loss
    new = SceneState(
        params=state.params,
        best_loss=torch.where(improved, total, state.best_loss),
        best_params={k: torch.where(improved, before[k], state.best_params[k])
                     for k in SCENE_PARAMS})
    return new, SceneStepOut(loss=total, loss_rgb=loss_rgb.detach(),
                             loss_lap=loss_lap.detach(), grads=grads)


def _scene_optimizer(name: str, state: SceneState, lr: float,
                     lr_scales: Dict[str, float]):
    """One parameter group for the trainable parameters without an lr
    scale, one for each scaled one (lr times its scale); None if nothing
    trains."""
    train = [k for k in SCENE_PARAMS if state.params[k].requires_grad]
    groups = [{"params": [state.params[k] for k in train
                          if k not in lr_scales], "lr": lr}]
    groups += [{"params": [state.params[k]], "lr": lr * lr_scales[k]}
               for k in sorted(lr_scales) if k in train]
    groups = [g for g in groups if g["params"]]
    return _make_optimizer(name, groups, lr) if groups else None


def optimize_scene_params(base_mesh, camera_elev_init, camera_azim_init,
                          lights_location_init, deform_init, verts_rgb_init,
                          diff_renderer, target_rgb,
                          generator: Optional[torch.Generator] = None,
                          lr_init=5e-2, Niter=100, optimizer="adam",
                          adapt_reg=False, adapt_params=(1.1, 1.5),
                          param_to_check=None, laplacian_weight=5e-3,
                          segment_size=50, checkpoint_dir=None, resume=False,
                          max_segments=None, lr_scales=None,
                          anneal_start=200, lr_decay=1.5,
                          texture_smoothing_weight=0.0):
    """Joint optimisation of the vertex colours (``textures``), vertex
    offsets (``vertices``), per-view camera elevation and azimuth
    (``camera``) and the light location (``light``), as selected by
    ``param_to_check``; the others stay frozen.

    Multi-view: ``camera_elev_init`` / ``camera_azim_init`` of shape
    (n_views,), ``base_mesh`` extended to n_views and a target (n_views,
    H, W, 3); the colours, offsets and light are shared by every view.
    ``lr_scales`` maps a parameter to a multiplier of the learning rate
    for its own Adam group (the camera scalars are in degrees, the colours
    in [0, 1]).  ``generator`` (CPU; seed 0 if None) draws every step's
    seed words.  Uniform segments of ``segment_size`` steps; with
    ``adapt_reg`` every boundary past ``anneal_start`` and before the end
    divides sigma by adapt_params[0] and gamma by adapt_params[1], sets
    the blur from sigma, doubles the sample count up to 128, divides the
    learning rate by ``lr_decay`` and starts a new optimizer.
    Checkpoints, ``resume`` and ``max_segments`` as in
    :func:`optimize_pose`.

    Returns (best_params, params, losses): the parameters of the best
    loss, the last ones and the total loss of every step."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    param_to_check = param_to_check or {"camera": False, "vertices": True,
                                        "textures": True, "light": False}
    target = target_rgb[0] if target_rgb[0].dim() == 4 else target_rgb[0][None]
    dev = base_mesh.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    params = {"verts_rgb": f32(verts_rgb_init), "deform": f32(deform_init),
              "camera_elev": f32(camera_elev_init),
              "camera_azim": f32(camera_azim_init),
              "lights_location": f32(lights_location_init)}
    group = {"verts_rgb": "textures", "deform": "vertices",
             "camera_elev": "camera", "camera_azim": "camera",
             "lights_location": "light"}
    trainable = {k: bool(param_to_check.get(group[k], False))
                 for k in SCENE_PARAMS}
    textured = trainable["verts_rgb"]
    lr_scales = lr_scales or {}
    lr = lr_init
    renderer = diff_renderer.replace(
        rasterizer=diff_renderer.rasterizer.update_blur(
            diff_renderer.rasterizer.blur))
    fixed = getattr(renderer.shader.smoothagg, "fixed_noise", False)
    state = SceneState.start(params, trainable)
    opt = _scene_optimizer(optimizer, state, lr, lr_scales)
    losses: List[np.ndarray] = []
    start = 0
    if resume and checkpoint_dir is not None \
            and _ckpt.latest_step(checkpoint_dir) is not None:
        st = _ckpt.restore_checkpoint(checkpoint_dir)
        lr = st["lr"]
        renderer = _restore_smoothing(renderer, st)
        state = SceneState(
            params={k: st["params"][k].to(dev).requires_grad_(trainable[k])
                    for k in SCENE_PARAMS},
            best_loss=st["best_loss"].to(dev),
            best_params={k: st["best_params"][k].to(dev)
                         for k in SCENE_PARAMS})
        opt = _scene_optimizer(optimizer, state, lr, lr_scales)
        if opt is not None:
            opt.load_state_dict(st["optimizer"])
        generator.set_state(st["generator"])
        losses.append(st["losses"].numpy())
        start = st["step"]

    def save(step):
        _ckpt.save_checkpoint(checkpoint_dir, {
            "params": {k: v.detach() for k, v in state.params.items()},
            "best_params": state.best_params, "best_loss": state.best_loss,
            "optimizer": None if opt is None else opt.state_dict(),
            "generator": generator.get_state(), **_smoothing_state(renderer),
            "lr": lr, "step": step,
            "losses": torch.from_numpy(_history(losses))}, step)

    segments_run = 0
    for end in _boundaries(Niter, segment_size):
        if end <= start:
            continue
        if max_segments is not None and segments_run >= max_segments:
            break
        segments_run += 1
        seg = []
        for _ in range(end - start):
            seeds = fused_render.draw_seeds(base_mesh.batch_size, generator,
                                            fixed, device=dev)
            state, out = scene_step(base_mesh, target, state, renderer, opt,
                                    seeds, textured, laplacian_weight,
                                    texture_smoothing_weight)
            seg.append(out.loss)
        losses.append(torch.stack(seg).cpu().numpy())     # waits
        start = end
        if adapt_reg and anneal_start < end < Niter:
            sigma, gamma, _ = renderer.shader.get_smoothing()
            renderer = _anneal(renderer, float(sigma) / adapt_params[0],
                               float(gamma) / adapt_params[1], 128)
            lr = lr / lr_decay
            opt = _scene_optimizer(optimizer, state, lr, lr_scales)
        if checkpoint_dir is not None:
            save(end)

    params = {k: v.detach() for k, v in state.params.items()}
    return state.best_params, params, _history(losses)
