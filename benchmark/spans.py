"""The port's own spans in the traced stretch: the ``gmg:`` ranges that
``gravomg_tpu_torch/utils/profiling.py::span`` opens while a profiler
runs, reduced by span name.

For every span name: its count, host wall seconds, self seconds (wall
minus its child spans), the device operations launched while it was
the innermost open span and their device seconds (a device operation's
correlation id names the runtime call that launched it on the host),
the host synchronisations made while it was innermost, the device-idle
seconds while it was the innermost open span, and the device-idle
seconds while it was open at all.  Over the stretch:
``calls`` (the entry spans, :data:`ENTRIES`, in it), ``launches``
(device operations launched inside an entry span), ``syncs`` (runtime
calls inside an entry span that block the host on the device,
:data:`SYNCS`), and the longest idle gaps, each named
``<call>/<innermost span or "-">/<innermost host activity>``.

The per-layer readers of ``benchmark/metrics/`` call :func:`of` with the
run they are handed; it finds the profiler in the harness's
``trace.Tracer`` on their caller's stack, reduces its events once,
prints the tables to stderr (``# spans ...`` lines) and keeps the
result on the run.  Without the port's spans (a program that opens
none) every reader gets ``calls == 0`` and reports nothing.
"""

from __future__ import annotations

import bisect
import re
import sys
from typing import Dict, List, NamedTuple, Optional

import torch

from benchmark.trace import NAME_CHARS, TOP, Tracer

PREFIX = "gmg:"
ENTRIES = frozenset({"mg_solve", "heat_geodesics"})
# Host runtime calls that wait for the device (cudaMemcpy without Async
# is synchronous).
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
OUTSIDE = "-"                  # no span open
_RUNTIME = re.compile(r"cu(da)?[A-Z]")     # the cuda* and cu* APIs


class Stat:
    """Totals of one span name (or of :data:`OUTSIDE`)."""
    __slots__ = ("count", "wall_s", "self_s", "device_s", "idle_s",
                 "idle_in_s", "launches", "syncs")

    def __init__(self):
        self.count = self.launches = self.syncs = 0
        self.wall_s = self.self_s = self.device_s = 0.0
        self.idle_s = self.idle_in_s = 0.0


class Spans(NamedTuple):
    stats: Dict[str, Stat]        # by span name without the prefix; "-"
    calls: int
    launches: int
    syncs: int
    device_s: float               # every device operation
    idle_s: float                 # first to last event, device idle
    on_device: bool               # the trace holds device operations
    idle_gaps: List[list]         # [label, seconds], longest first


def reduce_spans(dev: list, host: list, label: str) -> Spans:
    """:class:`Spans` from device and host events (start_ns, end_ns,
    name, correlation id) on one clock.  Device events are kernels,
    memory copies and sets; host events every host activity, the
    port's spans among them."""
    spans = sorted(((s, e, n[len(PREFIX):]) for s, e, n, _ in host
                    if n.startswith(PREFIX)), key=lambda t: (t[0], -t[1]))
    n_sp = len(spans)
    parent, entry = [-1] * n_sp, [-1] * n_sp
    ends = [e for _, e, _ in spans]
    # Boundaries of the innermost open span: from bound_t[k] until
    # bound_t[k + 1], span bound_owner[k] (-1: none) is innermost.
    bound_t, bound_owner = [float("-inf")], [-1]

    def mark(t, owner):
        if bound_t[-1] == t:
            bound_owner[-1] = owner
        else:
            bound_t.append(t)
            bound_owner.append(owner)

    stack: List[int] = []
    for i, (s, _, name) in enumerate(spans):
        while stack and ends[stack[-1]] <= s:
            j = stack.pop()
            mark(ends[j], stack[-1] if stack else -1)
        if stack:
            parent[i] = stack[-1]
            ends[i] = min(ends[i], ends[stack[-1]])
        entry[i] = i if name in ENTRIES else (
            entry[parent[i]] if parent[i] >= 0 else -1)
        mark(s, i)
        stack.append(i)
    while stack:
        j = stack.pop()
        mark(ends[j], stack[-1] if stack else -1)

    stats: Dict[str, Stat] = {OUTSIDE: Stat()}
    for s, _, name in spans:
        stats.setdefault(name, Stat())
    names = [name for _, _, name in spans] + [OUTSIDE]   # [-1]: outside
    child_s = [0.0] * n_sp
    for i, (s, _, name) in enumerate(spans):
        wall = (ends[i] - s) / 1e9
        st = stats[name]
        st.count += 1
        st.wall_s += wall
        if parent[i] >= 0:
            child_s[parent[i]] += wall
    for i, (_, _, name) in enumerate(spans):
        stats[name].self_s += (ends[i] - spans[i][0]) / 1e9 - child_s[i]

    def owner_at(t) -> int:
        return bound_owner[bisect.bisect_right(bound_t, t) - 1]

    def open_names(i) -> set:
        out = set()
        while i >= 0:
            out.add(names[i])
            i = parent[i]
        return out

    launched = {c: s for s, _, n, c in host if _RUNTIME.match(n)}
    launches = 0
    for s, e, _, corr in dev:
        at = launched.get(corr)
        i = owner_at(at) if at is not None else -1
        st = stats[names[i]]
        st.device_s += (e - s) / 1e9
        st.launches += 1
        if i >= 0 and entry[i] >= 0:
            launches += 1
    syncs = 0
    for s, _, n, _ in host:
        if n in SYNCS:
            i = owner_at(s)
            stats[names[i]].syncs += 1
            if i >= 0 and entry[i] >= 0:
                syncs += 1
    calls = sum(1 for _, _, name in spans if name in ENTRIES)
    device_s = sum(e - s for s, e, _, _ in dev) / 1e9

    # Device idle: the stretch (first event to last) less the union of
    # the device operations, split by the innermost span over time.
    merged: List[list] = []
    for s, e, _, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    times = [t for s, e, _, _ in dev + host for t in (s, e)]
    idle_s = 0.0
    if times:
        lo, hi = min(times), max(times)
        edges = [lo] + [t for iv in merged for t in iv] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            idle_s += (b - a) / 1e9
            k = bisect.bisect_right(bound_t, a) - 1
            while k < len(bound_t) and bound_t[k] < b:
                seg_end = bound_t[k + 1] if k + 1 < len(bound_t) else hi
                over = (min(seg_end, b) - max(bound_t[k], a)) / 1e9
                if over > 0:
                    i = bound_owner[k]
                    stats[names[i]].idle_s += over
                    for name in open_names(i):
                        stats[name].idle_in_s += over
                k += 1

    gaps = sorted(((merged[j + 1][0] - merged[j][1], merged[j][1])
                   for j in range(len(merged) - 1)), reverse=True)[:TOP]
    host_sorted = sorted(host)
    starts = [h[0] for h in host_sorted]
    idle_gaps = []
    for length, at in gaps:
        activity = "python"
        for j in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            if host_sorted[j][1] > at:
                activity = host_sorted[j][2]
                break
        idle_gaps.append([f"{label}/{names[owner_at(at)]}/{activity}",
                          length / 1e9])
    return Spans(stats, calls, launches, syncs, device_s, idle_s,
                 bool(dev), idle_gaps)


def events(prof) -> tuple:
    """(device events, host events) of a stopped torch.profiler as
    :func:`reduce_spans` takes them; device-side copies of host ranges
    (user annotations) are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
              e.correlation_id())
        if e.device_type() != cuda:
            host.append(iv)
        elif not e.is_user_annotation():
            dev.append(iv)
    return dev, host


def _tracer() -> Optional[Tracer]:
    """The harness's tracer, held by a caller of the reader (run.py's
    ``drive``, which hands the readers the reduced trace only)."""
    frame = sys._getframe(1)
    while frame is not None:
        for value in frame.f_locals.values():
            if isinstance(value, Tracer):
                return value
        frame = frame.f_back
    return None


def report(sp: Spans, log=sys.stderr) -> None:
    """The tables by span as ``# spans ...`` lines."""
    print(f"# spans calls {sp.calls} launches {sp.launches} syncs "
          f"{sp.syncs} device_s {sp.device_s:.6f} idle_s {sp.idle_s:.6f}",
          file=log)
    order = sorted(sp.stats.items(), key=lambda kv: -kv[1].wall_s)
    for name, st in order:
        print(f"# spans {name[:NAME_CHARS]} count {st.count} wall_s "
              f"{st.wall_s:.6f} self_s {st.self_s:.6f} device_s "
              f"{st.device_s:.6f} idle_s {st.idle_s:.6f} idle_in_s "
              f"{st.idle_in_s:.6f} launches {st.launches} syncs {st.syncs}",
              file=log)
    print(f"# spans idle_gaps {sp.idle_gaps}", file=log, flush=True)


def of(run) -> Optional[Spans]:
    """The run's :class:`Spans`, reduced once; None when the run was
    not traced."""
    if "gmg_spans" not in run.__dict__:
        tracer = _tracer()
        sp = None
        if tracer is not None and tracer.prof is not None:
            sp = reduce_spans(*events(tracer.prof), tracer.label)
            report(sp)
        run.__dict__["gmg_spans"] = sp
    return run.__dict__["gmg_spans"]
