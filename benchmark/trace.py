"""The device trace of a traced run: torch.profiler over a steady
stretch of the window, reduced to the device's busy seconds (the union
of the intervals in which some operation ran on the device), the
device operations that took most time, and the longest idle gaps named
by what the host was doing when each began."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.deploy import synchronize

TOP = 10              # entries of each breakdown list
NAME_CHARS = 96       # of a device operation's name


class Trace(NamedTuple):
    window_s: float               # host clock, start to stop
    busy_s: Optional[float]       # None: no device activity recorded
    device_ops: List[list]        # [name, seconds], most time first
    idle_gaps: List[list]         # [host activity, seconds], longest first


class Tracer:
    """Starts the profiler at the first call boundary at least
    ``start_s`` into the window and stops it at the first boundary at
    least ``span_s`` after it started (or when :meth:`finish` is
    called).  Starting and stopping take seconds, inside the traced
    run's window and outside the traced stretch."""

    def __init__(self, device: torch.device, start_s: float, span_s: float,
                 label: str):
        self.device, self.start_s, self.span_s = device, start_s, span_s
        self.label = label
        self.prof = None
        self.t_start = self.window_s = None

    def boundary(self, elapsed: float) -> None:
        if self.prof is None and elapsed >= self.start_s:
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            synchronize(self.device)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t_start = time.perf_counter()
        elif (self.prof is not None and self.window_s is None
              and time.perf_counter() - self.t_start >= self.span_s):
            self.finish()

    def finish(self) -> None:
        if self.prof is not None and self.window_s is None:
            synchronize(self.device)
            self.window_s = time.perf_counter() - self.t_start
            self.prof.stop()

    def summary(self) -> Optional[Trace]:
        """None if the profiler never ran."""
        self.finish()
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in events:
            iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            (dev if e.device_type() == cuda else host).append(iv)
        return reduce_trace(self.window_s, dev, host, self.label)


def reduce_trace(window_s: float, dev: list, host: list,
                 label: str) -> Trace:
    """A :class:`Trace` from device and host intervals (start_ns, end_ns,
    name) on one clock."""
    if not dev:
        return Trace(window_s, None, [], [])
    per_op = defaultdict(float)
    for s, e, name in dev:
        per_op[name[:NAME_CHARS]] += (e - s) / 1e9
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9
    gaps = sorted(((merged[j + 1][0] - merged[j][1], merged[j][1])
                   for j in range(len(merged) - 1)), reverse=True)[:TOP]
    host = sorted(host)
    starts = [s for s, _, _ in host]
    idle = []
    for length, at in gaps:
        # The innermost host activity open when the gap began: the
        # latest-starting one that has not yet ended.
        name = "python"
        for j in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            if host[j][1] > at:
                name = host[j][2]
                break
        idle.append([f"{label}/{name}", length / 1e9])
    ops = sorted(([n, s] for n, s in per_op.items()), key=lambda p: -p[1])
    return Trace(window_s, busy, ops[:TOP], idle)
