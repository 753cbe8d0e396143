"""Profiling and timing helpers.

Counterpart of ``fenris_tpu/profiling.py``: :func:`trace` captures a
``torch.profiler`` trace (host and, where there is a card, CUDA activity)
in TensorBoard's layout, :class:`Timer` accumulates wall-clock sections
that wait for a tensor's device, and :func:`benchmark` gives the
steady-state seconds per call of a function, timed with CUDA events when
it runs on the card.  Solver telemetry (CG and Newton iteration counts)
is in the solvers' result tuples.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils import _pytree as pytree

__all__ = ["trace", "Timer", "benchmark"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA activity where there is a card).

    On exit the trace is written under ``log_dir`` as
    ``<worker>.<time>.pt.trace.json`` (``tensorboard_trace_handler``), for
    TensorBoard or Perfetto.  Yields the profiler, whose ``key_averages()``
    sums the recorded events, also after the export (``acc_events``).
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)), acc_events=True
    ) as prof:
        yield prof


def _cuda_devices(tree) -> List[torch.device]:
    """The CUDA devices of the tensors in a pytree, each once."""
    devices = []
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda" and leaf.device not in devices:
            devices.append(leaf.device)
    return devices


def _synchronize(tree) -> None:
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)


@dataclass
class Timer:
    """Accumulating wall-clock timer: ``section(name, sync)`` waits for ``sync``'s device before it stops."""

    times: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time the body; with ``sync`` (a tensor or a pytree of them), first wait for the devices it lies on."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        """Mean seconds of each section."""
        return {k: sum(v) / len(v) for k, v in self.times.items()}


def benchmark(fn, *args, warmup: int = 2, iters: int = 20) -> float:
    """Steady-state seconds per call of ``fn(*args)``.

    ``warmup`` calls first, then ``iters`` calls timed together.  When the
    arguments or the result lie on the card, the time is read from CUDA
    events on the current stream of its device, after one synchronisation;
    otherwise from the host clock.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    devices = _cuda_devices((args, out))
    if devices:
        with torch.cuda.device(devices[0]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                out = fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters
