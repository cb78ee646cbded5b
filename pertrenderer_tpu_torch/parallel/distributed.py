"""Process-group start-up and the (slice, data, samples) mesh (PyTorch
port of ``pertrenderer_tpu/parallel/distributed.py``).

:func:`initialize` starts ``torch.distributed`` from the variables that
``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``) or from its arguments, and is a no-op for a single process, so
every entry point can call it.  The JAX package also let a TPU pod's
environment markers (worker host names) start ``jax.distributed``
without a coordinator; nothing on a GPU host plays that part, so the port
has no such fallback: a multi-process run names its world.

:func:`build_multislice_mesh` lays the ranks out as (slice, data,
samples), slice-major, so that only the average of the shared smoothing
gradients (three scalars) crosses slices.  torch.distributed reports no
slice topology, so ``num_slices`` defaults to 1.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from pertrenderer_tpu_torch.parallel.sharding import (DATA_AXIS, SAMPLE_AXIS,
                                                      make_mesh)

__all__ = ["initialize", "build_multislice_mesh", "SLICE_AXIS"]

SLICE_AXIS = "slice"


def initialize(backend: str = "gloo", world_size: Optional[int] = None,
               rank: Optional[int] = None,
               init_method: Optional[str] = None) -> bool:
    """Start the default process group; True iff a multi-process group is
    running (started here or before).

    ``world_size`` / ``rank`` default to ``WORLD_SIZE`` / ``RANK``;
    ``init_method`` to ``tcp://MASTER_ADDR:MASTER_PORT``.  With a world of
    one process (or none named) it does nothing and returns False.
    ``backend``: ``gloo`` (CPU tensors, or several ranks sharing one GPU)
    or ``nccl`` (one GPU per rank)."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def build_multislice_mesh(num_slices: int = 1, samples_parallel: int = 1):
    """A (slice, data, samples) ``DeviceMesh`` over every rank, slice-major,
    made the active mesh.  Use it with ``sharding.make_sharded_pose_step(
    ..., data_axes=(SLICE_AXIS, DATA_AXIS))``: problems shard over slice x
    data together, and the smoothing-gradient average is the only traffic
    between slices."""
    n = dist.get_world_size()
    if n % num_slices:
        raise ValueError(f"{n} ranks do not split into {num_slices} slices")
    per_slice = n // num_slices
    if per_slice % samples_parallel:
        raise ValueError(f"{per_slice} ranks per slice not divisible by "
                         f"samples_parallel={samples_parallel}")
    return make_mesh((num_slices, per_slice // samples_parallel,
                      samples_parallel), (SLICE_AXIS, DATA_AXIS, SAMPLE_AXIS))
