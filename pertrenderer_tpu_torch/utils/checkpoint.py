"""Checkpoint / resume for optimisation runs (PyTorch port of
``pertrenderer_tpu/utils/checkpoint.py``).

A run's whole state — parameters, the optimizer's ``state_dict``, the
CPU generator's state, the best iterate, the annealing state and the step
— is one dict of tensors, numbers, strings and lists, saved with
``torch.save`` as ``directory/step_<N>``.  The file is written under a
temporary name and renamed, so a run killed while saving leaves the last
complete checkpoint in place.  Loading uses ``weights_only=True``: such a
dict needs no pickled code.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def save_checkpoint(directory: str, state: Dict[str, Any], step: int) -> str:
    """Save ``state`` as ``directory/step_<step>``; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = os.path.join(os.path.dirname(path), f"tmp_step_{step}")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest N of the ``step_<N>`` checkpoints under ``directory``,
    or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location="cpu") -> Dict[str, Any]:
    """The state saved by :func:`save_checkpoint` at ``step`` (the latest
    if None), its tensors on ``map_location``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return torch.load(_path(directory, step), map_location=map_location,
                      weights_only=True)
