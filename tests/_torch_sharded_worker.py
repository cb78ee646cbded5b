"""Rank bodies of the port's sharded-route tests.

``spawn`` starts ``world`` ranks (torch.multiprocessing, start method
spawn) that join a gloo group at ``tcp://127.0.0.1`` with one torch
thread each, run one job of ``JOBS`` on a payload that the test saved
with ``torch.save``, and save their results beside it.  The ranks import
only torch and the port, not JAX or the test modules."""

import os

import torch
import torch.distributed as dist

from pertrenderer_tpu_torch.parallel import sharding


def spawn(world: int, job: str, payload: dict, out_dir) -> list:
    """Run ``job`` on ``world`` ranks; the list of their results."""
    out_dir = str(out_dir)
    torch.save(payload, os.path.join(out_dir, "payload.pt"))
    torch.multiprocessing.start_processes(
        _rank, args=(world, f"tcp://127.0.0.1:{sharding.free_port()}", job,
                     out_dir),
        nprocs=world, join=True, start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank(rank, world, init_method, job, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        payload = torch.load(os.path.join(out_dir, "payload.pt"),
                             weights_only=False)
        result = JOBS[job](payload)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def value_and_grads(case: dict) -> dict:
    """The loss of the JAX sharding tests, mean((image - target)^2), of the
    mesh turned by ``log_rot`` and its gradients with respect to
    ``log_rot``, sigma, gamma and alpha; the image; the launch counts.
    The same function runs the folded reference in one process."""
    import pertrenderer_tpu_torch as ptt
    from pertrenderer_tpu_torch.ops import fused_render as tfr

    renderer, mesh = case["renderer"], case["mesh"]
    log_rot = case["log_rot"].clone().requires_grad_()
    smoothing = [torch.tensor(v, requires_grad=True)
                 for v in case["smoothing"]]
    posed_renderer = renderer.replace(
        shader=renderer.shader.update_smoothing(*smoothing))
    rot = ptt.so3_exp_map(log_rot)
    pred = mesh.update_padded(ptt.Rotate(rot).transform_points(mesh.verts))
    before = dict(tfr.launch_counts)
    kwargs = case.get("kwargs", {})
    loss = posed_renderer.render_loss(pred, case["target"],
                                      seeds=case["seeds"], **kwargs)
    grads = torch.autograd.grad(loss, [log_rot, *smoothing])
    with torch.no_grad():
        image = posed_renderer(pred, seeds=case["seeds"], **kwargs)
    return dict(loss=loss.item(), image=image, grads=[g for g in grads],
                plan=renderer.plan(mesh, **kwargs).mode,
                launches={k: tfr.launch_counts[k] - before[k]
                          for k in before})


def sharded_cases(payload: dict) -> dict:
    """Each case of ``payload['cases']`` on a (1, world) mesh: every rank
    shards the samples."""
    sharding.build_mesh(dist.get_world_size(),
                        samples_parallel=dist.get_world_size())
    return {name: value_and_grads(case)
            for name, case in payload["cases"].items()}


def pose_step(payload: dict) -> dict:
    """One ``make_sharded_pose_step`` step on the (data, samples) mesh of
    ``payload['shape']``: each data rank takes its slice of the batch
    (``log_rot`` (B, 3), ``targets``, ``seeds``); Adam at ``lr``."""
    mesh = sharding.make_mesh(payload["shape"],
                              (sharding.DATA_AXIS, sharding.SAMPLE_AXIS))
    d = mesh.get_local_rank(sharding.DATA_AXIS)
    per = payload["log_rot"].shape[0] // mesh.size(0)
    mine = slice(d * per, (d + 1) * per)
    log_rot = payload["log_rot"][mine].clone().requires_grad_()
    opt = torch.optim.Adam([log_rot], lr=payload["lr"])
    step = sharding.make_sharded_pose_step(
        mesh, payload["mesh"], payload["cameras"], payload["lights"],
        smoothing_lr=payload["smoothing_lr"])
    losses, renderer = step(log_rot, opt, payload["targets"][mine],
                            payload["seeds"][mine], payload["renderer"])
    return dict(data=d, losses=losses, log_rot=log_rot.detach(),
                smoothing=[float(v) for v in
                           renderer.shader.get_smoothing()])


def multislice(_payload: dict) -> dict:
    """``build_multislice_mesh(2, samples_parallel=2)``: names, shape, this
    rank's slice and sample index, whether it became the active mesh, and
    whether 3 slices of the ranks were refused."""
    from pertrenderer_tpu_torch.parallel import distributed

    mesh = distributed.build_multislice_mesh(num_slices=2,
                                             samples_parallel=2)
    try:
        distributed.build_multislice_mesh(num_slices=3)
        refused = False
    except ValueError:
        refused = True
    return dict(names=mesh.mesh_dim_names, shape=tuple(mesh.shape),
                slice=mesh.get_local_rank("slice"),
                samples=sharding.axis_info(sharding.SAMPLE_AXIS).index,
                active=sharding.active_mesh() is mesh, refused=refused)


JOBS = {"sharded_cases": sharded_cases, "pose_step": pose_step,
        "multislice": multislice}
