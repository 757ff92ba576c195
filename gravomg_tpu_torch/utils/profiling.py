"""Spans, stage timers and device traces (counterpart of
``gravomg_tpu/utils/profiling.py``).

``span(name)`` marks the port's layers for a profiler: with one running
(``torch.profiler``: an operator's :func:`device_trace`, the
benchmark's traced run) it opens a host range named ``"gmg:" + name``,
stamped on the clock of the device activities; with none it returns one
shared no-op after a single check of the profiler's flag and formats no
string.  The range is torch's fast record function, which writes no
copy of itself on the device's timeline (``torch.profiler
.record_function`` adds a ``gpu_user_annotation`` there, which a trace
reader would count as device time).  ``stage`` adds a stage's
synchronised seconds to a caller's ``record=`` dict inside the span of
its name; ``StageTimer`` records wall-clock seconds per named stage, each
a span under the name the caller gives it; ``device_trace`` captures a
trace (CPU activity, and CUDA activity when a card is present) for
TensorBoard or ``chrome://tracing``, which shows the port's spans.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "gmg:"          # the port's spans, apart from torch's own ops
_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str, level: Optional[int] = None):
    """The span ``gmg:<name>`` (``gmg:<name><level>`` with a level
    index, formatted only while a profiler runs) as a context manager;
    the shared no-op when no profiler runs."""
    if not _profiling():
        return _OFF
    return _Range(PREFIX + name if level is None
                  else f"{PREFIX}{name}{level}")


def synchronize(dev: torch.device) -> None:
    """Waits for the card's queued work when ``dev`` is a CUDA device."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage(record: Optional[dict], name: str, dev: torch.device):
    """The span ``name`` around the enclosed stage; with a ``record``
    dict, also adds the stage's seconds, synchronised with the device
    before and after, to ``record[name]``."""
    with span(name):
        if record is None:
            yield
            return
        synchronize(dev)
        t0 = time.perf_counter()
        yield
        synchronize(dev)
        record[name] = record.get(name, 0.0) + time.perf_counter() - t0


def _synchronize_on(obj) -> None:
    """Waits for the card's queued work on the devices of the CUDA
    tensors in ``obj`` (a tensor, or a list, tuple or dict of them);
    nothing on the CPU."""
    if isinstance(obj, torch.Tensor):
        synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _synchronize_on(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _synchronize_on(v)


class StageTimer:
    """Wall-clock stage timer whose stages are profiler spans of the
    names given (without the port's prefix: the names are the caller's).

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
        with _Range(name) if _profiling() else _OFF:
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
