"""Run artifacts: JSON metric dumps, npy histories, training image grids
(PyTorch port of ``pertrenderer_tpu/utils/artifacts.py``).

The layout is the JAX package's: per-run ``loss_values.npy`` /
``gradient_values.npy`` and an image grid under
``results/<exp_id>/optimization_details/<datetime>/``, and the CLI's JSON
metric files under ``results/<exp_id>/``.  The plots need matplotlib and
return None without it.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Optional

import numpy as np
import torch

__all__ = ["run_dir", "dump_json", "save_histories", "image_grid",
           "plot_solved_percentage", "device_peak_memory_mb"]


def run_dir(results_root: str, exp_id) -> str:
    stamp = datetime.now().strftime("%Y-%m-%d-%H:%M:%S")
    path = os.path.join(results_root, str(exp_id), "optimization_details",
                        stamp)
    os.makedirs(path, exist_ok=True)
    return path


def dump_json(results_root: str, exp_id, name: str, obj) -> str:
    path = os.path.join(results_root, str(exp_id))
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, name)
    with open(fname, "w") as f:
        json.dump(obj, f)
    return fname


def save_histories(path: str, losses, grad_norms) -> None:
    np.save(os.path.join(path, "loss_values.npy"), np.asarray(losses))
    np.save(os.path.join(path, "gradient_values.npy"),
            np.asarray(grad_norms))


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def image_grid(images, title: str, rows: Optional[int] = None,
               cols: Optional[int] = None, fill: bool = True,
               show_axes: bool = False, rgb: bool = True) -> Optional[str]:
    """Training-progress montage of (B, H, W, C) images saved as
    ``<title>/grid_cube.png``; returns the path, or None without
    matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    images = np.asarray(images)
    if (rows is None) != (cols is None):
        raise ValueError("Specify either both rows and cols or neither.")
    if rows is None:
        rows, cols = len(images), 1
    gridspec_kw = {"wspace": 0.0, "hspace": 0.0} if fill else {}
    fig, axarr = plt.subplots(rows, cols, gridspec_kw=gridspec_kw,
                              figsize=(15, 9))
    for ax, im in zip(np.ravel(axarr), images):
        if rgb:
            ax.imshow(np.clip(im[..., :3], 0.0, 1.0))
        else:
            ax.imshow(im[..., 3])
        if not show_axes:
            ax.set_axis_off()
    out = os.path.join(str(title), "grid_cube.png")
    plt.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_solved_percentage(results_root: str, exp_id,
                           thresholds=(1, 2, 5, 10, 15, 20, 25, 35, 45)
                           ) -> Optional[str]:
    """Solved-percentage plot from the dumped JSON metrics (each noise
    type at its grid point of lowest mean angle error), saved as
    ``results_plot.png``; returns the path, or None without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    base = os.path.join(results_root, str(exp_id))
    with open(os.path.join(base, "solved_percentage.txt")) as f:
        solved = json.load(f)
    with open(os.path.join(base, "angle_error.txt")) as f:
        mean_err = json.load(f)
    setup_path = os.path.join(base, "exp_setup.txt")
    setup = {}
    if os.path.exists(setup_path):
        with open(setup_path) as f:
            setup = json.load(f)

    fig = plt.figure(dpi=200)
    for noise, per_thresh in solved.items():
        best = int(np.argmin(mean_err[noise]))
        ys = [per_thresh[str(t) if str(t) in per_thresh else t][best]
              for t in thresholds]
        plt.plot(list(thresholds), ys, label=noise)
    title = setup.get("perturbation")
    if title is not None:
        plt.title(f"{title}\N{DEGREE SIGN} initial perturbation")
    plt.xlabel("Threshold (\N{DEGREE SIGN})")
    plt.ylabel("% of task solved")
    plt.ylim((0.0, 1.0))
    plt.legend()
    out = os.path.join(base, "results_plot.png")
    plt.savefig(out)
    plt.close(fig)
    return out


def device_peak_memory_mb(device) -> Optional[float]:
    """Peak memory the caching allocator handed out on a CUDA ``device``
    since its last ``torch.cuda.reset_peak_memory_stats``, in MB; None on
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) * 1e-6
