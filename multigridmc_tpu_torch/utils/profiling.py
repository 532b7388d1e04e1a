"""Timing and tracing helpers.

Counterpart of ``multigridmc_tpu/utils/profiling.py``.  The reference has no
profiling framework, only wall-clock timing printed by its drivers; here:

* :func:`timed` - wall-clock a block, with ``torch.cuda.synchronize`` at its
  end on a CUDA device, so that the time holds the device's work and not only
  its enqueue;
* :func:`trace` - a ``torch.profiler`` window over the host and (on a CUDA
  device) the card, written as a Chrome trace (``chrome://tracing``, Perfetto);
* :class:`Timer` - an accumulating timer of named phases.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from .runtime import DeviceLike, resolve_device


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(label: str, results: Optional[Dict[str, float]] = None, verbose: bool = True,
          device: DeviceLike = None):
    """Wall-clock a block on ``device`` (default: the card), synchronising it
    before the clock is read at the end.  The seconds are added to
    ``results[label]`` where given and printed where ``verbose``."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    yield
    _synchronize(device)
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = results.get(label, 0.0) + dt
    if verbose:
        print(f"[{label}] {dt:.4f} s")


@contextlib.contextmanager
def trace(logdir: str, device: DeviceLike = None, filename: str = "trace.json"):
    """A ``torch.profiler`` trace of the block: host activity and, on a CUDA
    ``device`` (the default), the card's kernels; written to
    ``logdir/filename`` as a Chrome trace when the block ends.  Yields the
    profiler, whose ``key_averages()`` give the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _synchronize(device)
    prof.export_chrome_trace(os.path.join(logdir, filename))


class Timer:
    """Accumulating named-phase timer on one device."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.phases: Dict[str, float] = {}

    def phase(self, label: str, verbose: bool = False):
        return timed(label, self.phases, verbose, self.device)

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k:>24s}: {v:8.3f} s ({100 * v / total:5.1f}%)" for k, v in self.phases.items()]
        lines.append(f"{'total':>24s}: {total:8.3f} s")
        return "\n".join(lines)
