"""Stage timers and device traces (counterpart of
``gravomg_tpu/utils/profiling.py``).

``StageTimer`` records wall-clock seconds per named stage and marks each
stage as a ``torch.profiler.record_function`` span, so a trace taken
around it shows the stages by name; ``device_trace`` captures such a
trace (CPU activity, and CUDA activity when a card is present) for
TensorBoard or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


def _synchronize_on(obj) -> None:
    """Waits for the card's queued work on the devices of the CUDA
    tensors in ``obj`` (a tensor, or a list, tuple or dict of them);
    nothing on the CPU."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _synchronize_on(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _synchronize_on(v)


class StageTimer:
    """Wall-clock stage timer that also marks profiler spans.

    Usage::

        timer = StageTimer()
        with timer.stage("knn", block_on=graph_points):
            graph = knn_graph(points, k)
        print(timer.report())

    ``block_on`` (tensors) makes the stage wait for the card's work on
    their devices before it stops its clock; without it a stage of
    queued CUDA work measures the enqueue only.
    """

    def __init__(self) -> None:
        self.stages: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if block_on is not None:
                _synchronize_on(block_on)
            self.stages.append((name, time.perf_counter() - t0))

    def total(self) -> float:
        return sum(t for _, t in self.stages)

    def report(self) -> str:
        lines = [f"  {name:<28s} {t * 1000:10.2f} ms"
                 for name, t in self.stages]
        lines.append(f"  {'TOTAL':<28s} {self.total() * 1000:10.2f} ms")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, t in self.stages:
            out[name] = out.get(name, 0.0) + t
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (TensorBoard's trace format; CUDA activity when a card
    is present); a no-op when ``log_dir`` is None.  Yields the profiler,
    or None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
