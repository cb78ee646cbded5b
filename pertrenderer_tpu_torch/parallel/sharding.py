"""Device meshes, the sample group's average, the sharded pose step and
the multi-rank dry run (PyTorch port of
``pertrenderer_tpu/parallel/sharding.py``).

Ranks of a ``torch.distributed`` process group are laid out as a (data,
samples) ``DeviceMesh``:

* **data**: a batch of pose problems split across ranks; each rank owns
  its problems' poses and optimizer state, and the shared smoothing
  parameters (sigma, gamma, alpha) get the gradient averaged over the
  data axes;
* **samples**: the Monte-Carlo samples of both perturbed estimators
  split across ranks.  Estimators built with ``sample_axis=SAMPLE_AXIS``
  draw rank d's slice of one sample sequence and average their sample
  means over the group (``axis_mean``), inside the forward and the
  backward, which is exact because both are sample means.

The active mesh is the one ``build_mesh`` / ``make_mesh`` (or
``distributed.build_multislice_mesh``) made last in this process:
``axis_info(name)`` reads a rank's place on it, as ``axis_index`` reads a
device's inside the JAX package's ``shard_map``.

The averages run on the process group's backend.  With gloo (CPU ranks,
or several ranks sharing one GPU, where NCCL refuses two ranks per
device) a CUDA tensor is copied to the host, reduced there and copied
back: explicitly, so the path does not depend on what gloo takes.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "build_mesh", "make_mesh",
           "use_mesh", "active_mesh", "axis_info", "axis_mean",
           "make_sharded_pose_step", "dryrun_multichip", "free_port"]

DATA_AXIS = "data"
SAMPLE_AXIS = "samples"

_mesh = None        # the active DeviceMesh


def _mesh_device_type() -> str:
    """The DeviceMesh device of the default group's backend: NCCL keeps
    its tensors on the GPU, gloo on the host."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over every rank of the
    default process group (rank-major), made the active mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (start one with "
                           "torch.distributed.init_process_group or "
                           "distributed.initialize)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"make_mesh: shape {shape} does not cover the "
                         f"{dist.get_world_size()} ranks")
    return use_mesh(init_device_mesh(_mesh_device_type(), tuple(shape),
                                     mesh_dim_names=tuple(names)))


def build_mesh(n_devices: Optional[int] = None,
               samples_parallel: Optional[int] = None):
    """A (data, samples) mesh over the process group's ``n_devices``
    ranks (all of them; the default), made the active mesh.
    ``samples_parallel`` ranks split the MC samples (default: 2 when the
    rank count is even, else 1); the rest split the problem batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != n:
        raise ValueError(f"build_mesh: {n_devices} devices, but the process "
                         f"group has {n} ranks")
    if samples_parallel is None:
        samples_parallel = 2 if n % 2 == 0 and n >= 2 else 1
    if n % samples_parallel:
        raise ValueError(f"build_mesh: {n} ranks not divisible by "
                         f"samples_parallel={samples_parallel}")
    return make_mesh((n // samples_parallel, samples_parallel),
                     (DATA_AXIS, SAMPLE_AXIS))


def use_mesh(mesh):
    """Make ``mesh`` the active mesh; returns it."""
    global _mesh
    _mesh = mesh
    return mesh


def active_mesh():
    """The active mesh, or None."""
    return _mesh


@dataclasses.dataclass(frozen=True)
class AxisInfo:
    group: object       # the ProcessGroup of the axis
    index: int          # this rank's place along the axis
    size: int


def axis_info(name: str) -> AxisInfo:
    """This rank's group, index and size along the active mesh's axis
    ``name``.  Raises where there is no active mesh or no such axis (as
    JAX's ``axis_index`` outside ``shard_map``): an estimator that names a
    sample axis never runs unsharded by accident."""
    if _mesh is None:
        raise RuntimeError(f"axis {name!r}: no device mesh is active "
                           "(sharding.build_mesh or make_mesh)")
    if name not in (_mesh.mesh_dim_names or ()):
        raise ValueError(f"axis {name!r} is not an axis of the active mesh "
                         f"{_mesh.mesh_dim_names}")
    return AxisInfo(_mesh.get_group(name), _mesh.get_local_rank(name),
                    _mesh.size(_mesh.mesh_dim_names.index(name)))


def axis_mean(x: Union[torch.Tensor, Sequence[torch.Tensor]],
              names: Union[str, Sequence[str]]):
    """The mean over the ranks along the mesh axes ``names`` of a tensor,
    or of each tensor of a list (one collective for the list): a SUM
    all-reduce along each axis, then one division by the ranks' count, so
    every rank gets the same bits (gloo has no AVG).  Under gloo a CUDA
    tensor goes through the host."""
    names = (names,) if isinstance(names, str) else tuple(names)
    single = isinstance(x, torch.Tensor)
    xs = [x] if single else list(x)
    flat = torch.cat([t.reshape(-1) for t in xs])
    staged = flat.is_cuda and dist.get_backend() == "gloo"
    buf = flat.cpu() if staged else flat         # cat made a new tensor
    count = 1
    for name in names:
        info = axis_info(name)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=info.group)
        count *= info.size
    buf = buf / count
    if staged:
        buf = buf.to(flat.device)
    out, at = [], 0
    for t in xs:
        out.append(buf[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out[0] if single else out


def make_sharded_pose_step(mesh, scene_mesh, cameras, lights,
                           smoothing_lr: float = 0.0,
                           data_axes: Tuple[str, ...] = (DATA_AXIS,)):
    """The multi-rank pose step (the JAX ``make_sharded_pose_step``),
    with ``mesh`` made the active mesh.

    The returned ``step(log_rot, optimizer, targets, seeds, renderer)``
    takes this rank's problems: ``log_rot`` (B, 3), a leaf that requires
    grad and that ``optimizer`` (this rank's, e.g. Adam over [log_rot])
    updates; ``targets`` (B, H, W, 3); ``seeds`` (B, 4) int32 seed words,
    the same on every rank of a sample group; ``renderer`` built with
    ``sample_axis=SAMPLE_AXIS`` estimators.  Each problem's loss is the
    mean squared RGB error of ``scene_mesh`` turned by its pose; the step
    descends the mean of this rank's losses.  It returns (losses (B,),
    renderer).  ``smoothing_lr`` > 0 also moves the shared sigma, gamma
    and alpha by plain SGD on their gradients averaged over ``data_axes``
    (the adaptive regularization signal of the reference's eval.py)."""
    import pertrenderer_tpu_torch as ptt

    use_mesh(mesh)

    def losses_of(log_rot, renderer, targets, seeds):
        base = scene_mesh.extend(log_rot.shape[0])
        rot = ptt.so3_exp_map(log_rot)
        pred = base.update_padded(
            ptt.Rotate(rot).transform_points(base.verts))
        images = renderer(pred, seeds=seeds, cameras=cameras, lights=lights)
        d = images[..., :3] - targets
        return torch.mean(d * d, dim=(1, 2, 3))

    def step(log_rot, optimizer, targets, seeds, renderer):
        shader = renderer.shader
        smoothing = [torch.as_tensor(v, dtype=torch.float32,
                                     device=log_rot.device)
                     .detach().clone().requires_grad_()
                     for v in shader.get_smoothing()]
        posed = renderer.replace(shader=shader.update_smoothing(*smoothing))
        losses = losses_of(log_rot, posed, targets, seeds)
        grads = torch.autograd.grad(losses.mean(), [log_rot, *smoothing],
                                    allow_unused=True)
        g_pose, *g_smooth = [torch.zeros_like(v) if g is None else g
                             for v, g in zip([log_rot, *smoothing], grads)]
        # The shared smoothing parameters: the gradient averaged over every
        # axis that splits the problems (three scalars).
        g_smooth = axis_mean(g_smooth, data_axes)
        optimizer.zero_grad(set_to_none=True)
        log_rot.grad = g_pose
        optimizer.step()
        if smoothing_lr > 0.0:
            renderer = renderer.replace(shader=shader.update_smoothing(
                *(v.detach() - smoothing_lr * g
                  for v, g in zip(smoothing, g_smooth))))
        return losses.detach(), renderer

    return step


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now (for a rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, image_size: int = 16,
                     faces_per_pixel: int = 12, steps: int = 1,
                     device="cuda") -> dict:
    """Run the full sharded pose step on ``n_devices`` ranks at tiny
    shapes, as the JAX ``dryrun_multichip`` does on a device mesh.

    Spawns the ranks (``torch.multiprocessing``, start method spawn), each
    joining a gloo group at ``tcp://127.0.0.1`` and the (data, samples)
    mesh of ``build_mesh``, on ``device`` (ranks on one CUDA device share
    it).  Two phases, with GaussianRast + GaussianAgg sharding their
    samples: the cube (F <= faces_per_pixel: the flat sharded route, K11a,
    K3 with external coverage, K11b, K11c) and an 80-face icosphere (the
    stream route with the aggregation samples sharded, K5 / K6), each for
    ``steps`` steps with the smoothing parameters learnt.  Raises if a rank
    fails or a loss is not finite; returns {phase: [each problem's loss]}
    (one problem per data rank, in order)."""
    device = torch.device(device)
    if device.type == "cuda":
        from pertrenderer_tpu_torch import _build

        _build.library()        # built once, before the ranks load it
    ctx = torch.multiprocessing.get_context("spawn")
    # A SimpleQueue writes straight into its pipe (no feeder thread), and
    # each rank puts a few numbers: joining the ranks first cannot block.
    results = ctx.SimpleQueue()
    ranks = torch.multiprocessing.start_processes(
        _dryrun_rank, args=(n_devices, f"tcp://127.0.0.1:{free_port()}",
                            image_size, faces_per_pixel, steps, str(device),
                            results),
        nprocs=n_devices, join=False, start_method="spawn")
    while not ranks.join():
        pass
    rows = []
    while not results.empty():
        rows.append(results.get())
    out = {}
    for _rank, tag, losses in sorted(rows):
        out.setdefault(tag, []).extend(losses)
    return out


def _dryrun_rank(rank, n_devices, init_method, image_size, faces_per_pixel,
                 steps, device, results):
    import pertrenderer_tpu_torch as ptt

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=n_devices, rank=rank)
    try:
        mesh = build_mesh(n_devices)
        dev = torch.device(device)
        cube = ptt.load_cube(device=dev).scale_verts(2.0)
        verts, faces = ptt.make_icosphere(1)              # 80 faces
        sphere = ptt.Meshes.create(
            verts, faces, device=dev,
            textures=ptt.TexturesVertex(
                torch.full((1, verts.shape[0], 3), 0.7, device=dev))
        ).scale_verts(2.0)
        for tag, scene, k in (
                ("cube", cube, faces_per_pixel),
                ("stream/sphere", sphere, min(faces_per_pixel, 12))):
            losses = _dryrun_scene(mesh, scene, image_size, k, steps, dev,
                                   tag)
            if mesh.get_local_rank(SAMPLE_AXIS) == 0:    # one per problem
                results.put((rank, tag, losses))
    finally:
        dist.destroy_process_group()


def _dryrun_scene(mesh, scene_mesh, image_size, faces_per_pixel, steps, dev,
                  tag):
    import pertrenderer_tpu_torch as ptt
    from pertrenderer_tpu_torch.ops.fused_render import draw_seeds

    n_data = mesh.size(0)
    d_index = mesh.get_local_rank(DATA_AXIS)
    batch = n_data                          # one problem per data slice
    r, t = ptt.look_at_view_transform(dist=6.7, elev=30.0, azim=120.0,
                                      device=dev)
    cameras = ptt.PerspectiveCameras.create(R=r, T=t, fov=60.0, device=dev)
    lights = ptt.PointLights.create(location=(0.0, 2.0, -2.0), device=dev)
    sigma, gamma = 1e-3, 1e-2
    blur = float(np.log(1.0 / 1e-4 - 1.0) * sigma)
    settings = ptt.RasterizationSettings(image_size=image_size,
                                         blur_radius=blur,
                                         faces_per_pixel=faces_per_pixel)
    renderer = ptt.MeshRenderer(
        ptt.MeshRasterizer(cameras, settings),
        ptt.RandomPhongShader.create(
            cameras=cameras, lights=lights,
            blend_params=ptt.BlendParams(sigma, gamma, (0.0, 0.0, 0.0)),
            smoothrast=ptt.GaussianRast.create(sigma=sigma, nb_samples=2,
                                               sample_axis=SAMPLE_AXIS),
            smoothagg=ptt.GaussianAgg.create(gamma=gamma, nb_samples=2,
                                             sample_axis=SAMPLE_AXIS),
            device=dev))
    # Every rank draws the whole batch from one seed and keeps its slice.
    gen = torch.Generator().manual_seed(0)
    r_true = ptt.random_rotations(batch, gen, device="cpu").to(dev)
    log_rot = 0.1 * torch.randn(batch, 3, generator=gen)
    seeds = draw_seeds(batch, gen, device=dev)
    targets_mesh = scene_mesh.extend(batch)
    targets_mesh = targets_mesh.update_padded(
        ptt.Rotate(r_true).transform_points(targets_mesh.verts))
    cams_b = ptt.PerspectiveCameras.create(R=r.expand(batch, 3, 3),
                                           T=t.expand(batch, 3), fov=60.0,
                                           device=dev)
    hard = ptt.MeshRenderer(
        ptt.MeshRasterizer(cams_b, ptt.RasterizationSettings(
            image_size=image_size, faces_per_pixel=1)),
        ptt.HardPhongShader.create(
            cameras=cams_b, lights=lights,
            blend_params=ptt.BlendParams(background_color=(0.0, 0.0, 0.0)),
            device=dev))
    with torch.no_grad():
        targets = hard(targets_mesh)[..., :3]
    mine = slice(d_index, d_index + 1)
    log_rot = log_rot[mine].to(dev).requires_grad_()
    opt = torch.optim.Adam([log_rot], lr=3e-2)
    step = make_sharded_pose_step(mesh, scene_mesh, cameras, lights,
                                  smoothing_lr=1e-4)
    for _ in range(steps):
        losses, renderer = step(log_rot, opt, targets[mine], seeds[mine],
                                renderer)
    losses = losses.cpu()
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"non-finite sharded loss ({tag}): {losses}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok [{tag}]: mesh="
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} route "
              f"{renderer.plan(scene_mesh).mode} losses "
              f"{losses.tolist()}", flush=True)
    return losses.tolist()
