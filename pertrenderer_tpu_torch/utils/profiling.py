"""Timing and tracing helpers (PyTorch port of
``pertrenderer_tpu/utils/profiling.py``).

:func:`per_iteration_time` runs a ``carry -> carry`` step at two lengths
and takes the slope, so fixed costs (the first launch, the final
synchronisation) drop out: on the card the two runs are timed with CUDA
events, on the CPU with ``time.perf_counter`` after a synchronising read.
:func:`trace` wraps ``torch.profiler`` and writes a Chrome trace;
:func:`summarize_trace` sums its device kernels by name.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import time
from typing import Callable

import torch

__all__ = ["per_iteration_time", "trace", "summarize_trace"]


def _run(step_fn: Callable, carry, n: int):
    for _ in range(n):
        carry = step_fn(carry)
    return carry


def per_iteration_time(step_fn: Callable, init_carry, n1: int = 3,
                       n2: int = 23, device="cuda") -> float:
    """Seconds per iteration of ``step_fn`` (the slope between runs of
    ``n1`` and ``n2`` steps from ``init_carry``, each the faster of two
    runs, after a warm-up run) on ``device``."""
    device = torch.device(device)
    _run(step_fn, init_carry, n1)
    times = {}
    for n in (n1, n2):
        best = float("inf")
        for _ in range(2):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _run(step_fn, init_carry, n)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) * 1e-3)
            else:
                t0 = time.perf_counter()
                _run(step_fn, init_carry, n)
                best = min(best, time.perf_counter() - t0)
        times[n] = best
    return max((times[n2] - times[n1]) / (n2 - n1), 0.0)


@contextlib.contextmanager
def trace(log_dir: str = "results/trace"):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where torch sees one) and write its Chrome trace under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield log_dir
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{time.time_ns()}.json"))


def summarize_trace(log_dir: str, top: int = 20):
    """[(name, total ms, count)] of the device kernels in the newest
    trace under ``log_dir``, by total time (empty without device
    events)."""
    paths = sorted(glob.glob(os.path.join(log_dir, "trace_*.json")))
    if not paths:
        return []
    with open(paths[-1]) as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    durs, cnt = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e:
            durs[e["name"]] += e["dur"]
            cnt[e["name"]] += 1
    return [(name, d / 1000.0, cnt[name]) for name, d in durs.most_common(top)]
