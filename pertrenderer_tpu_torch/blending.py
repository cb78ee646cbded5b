"""Blending configuration (PyTorch port of ``BlendParams`` in
``pertrenderer_tpu/blending.py``).  The staged blend functions are not
ported yet: the fused forward blends inside its kernel."""

from __future__ import annotations

from typing import NamedTuple, Tuple

__all__ = ["BlendParams"]


class BlendParams(NamedTuple):
    sigma: float = 1e-4
    gamma: float = 1e-4
    background_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
