"""Numerically corrected primitives (PyTorch port of
``pertrenderer_tpu/ops/perturbed.py:336-380``), forward only.

Their forward values are plain ``log`` and product; what makes them
"corrected" is the backward (inf/nan terms zeroed), which arrives with the
backward kernels.  The MC estimators themselves live in the fused kernel.
"""

from __future__ import annotations

import torch

__all__ = ["log_corrected", "prod_corrected"]


def log_corrected(x: torch.Tensor) -> torch.Tensor:
    """log(x); zero-coverage fragments (x = 0) map to -inf."""
    return torch.log(x)


def prod_corrected(x, y: torch.Tensor) -> torch.Tensor:
    """x * y (x scalar-like, y tensor)."""
    return x * y
