"""``benchmark/spans.py`` on synthetic traces with hand-worked answers:
wall, self, device and idle seconds by span, ``calls``, ``launches``,
``syncs`` and the gap labels; then each reader of the port's spans on a
synthetic run, and nothing where its span is absent, where the program
opens no spans, or where the run was not traced.

Run from the repository's root: ``python -m pytest benchmark/tests``."""

import importlib.util
import os
import types

import pytest
import torch

from benchmark import spans
from benchmark.trace import Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# One mg_solve call, 0-100 ns, then a launch and a sync outside it.
HOST = [
    (0, 100, "gmg:mg_solve", 1),
    (5, 25, "gmg:mg_solve.cast", 2),
    (30, 70, "gmg:vcycle", 3),
    (32, 68, "gmg:vcycle.L0", 4),
    (40, 50, "gmg:vcycle.coarse", 5),
    (75, 95, "gmg:krylov.residual_read", 6),
    (58, 63, "aten::add", 7),
    (90, 92, "aten::mul", 101),     # an op's id equal to a launch's
    (10, 12, "cudaLaunchKernel", 101),
    (42, 44, "cudaLaunchKernel", 102),
    (60, 61, "cudaLaunchKernel", 103),
    (80, 81, "cudaMemcpyAsync", 104),
    (82, 90, "cudaStreamSynchronize", 105),
    (110, 111, "cuLaunchKernel", 106),
    (120, 125, "cudaDeviceSynchronize", 107),
]
DEV = [
    (15, 20, "cast_kernel", 101),
    (45, 48, "trsv", 102),
    (62, 66, "k1", 103),
    (84, 86, "Memcpy DtoH", 104),
    (112, 130, "outside_kernel", 106),
    (131, 133, "unlinked", 999),
]
NS = 1e-9
# name: (count, wall, self, device, idle as innermost, idle while open,
# launches, syncs), in ns but the counts.
EXPECT = {
    "mg_solve": (1, 100, 20, 0, 20, 86, 0, 0),
    "mg_solve.cast": (1, 20, 20, 5, 15, 15, 1, 0),
    "vcycle": (1, 40, 4, 0, 4, 33, 0, 0),
    "vcycle.L0": (1, 36, 26, 4, 22, 29, 1, 0),
    "vcycle.coarse": (1, 10, 10, 3, 7, 7, 1, 0),
    "krylov.residual_read": (1, 20, 20, 2, 18, 18, 1, 1),
    "-": (0, 0, 0, 20, 13, 0, 2, 1),
}
GAPS = [
    ["mg_solve/krylov.residual_read/cudaStreamSynchronize", 26 * NS],
    ["mg_solve/mg_solve.cast/gmg:mg_solve.cast", 25 * NS],
    ["mg_solve/vcycle.L0/gmg:vcycle.L0", 18 * NS],
    ["mg_solve/vcycle.coarse/gmg:vcycle.coarse", 14 * NS],
    ["mg_solve/-/python", 1 * NS],
]


def test_reduce_spans_by_hand():
    sp = spans.reduce_spans(DEV, HOST, "mg_solve")
    assert (sp.calls, sp.launches, sp.syncs, sp.on_device) == (1, 4, 1, True)
    assert sp.device_s == pytest.approx(34 * NS)
    assert sp.idle_s == pytest.approx(99 * NS)      # 133 ns less 34 busy
    assert set(sp.stats) == set(EXPECT)
    for name, (count, wall, self_, dev, idle, idle_in, launches,
               syncs) in EXPECT.items():
        st = sp.stats[name]
        assert (st.count, st.launches, st.syncs) == (
            count, launches, syncs), name
        got = (st.wall_s, st.self_s, st.device_s, st.idle_s, st.idle_in_s)
        assert got == pytest.approx(
            tuple(x * NS for x in (wall, self_, dev, idle, idle_in)),
            abs=1e-15), name
    # Every device second and every idle second lands on one name.
    assert sum(st.device_s for st in sp.stats.values()) == pytest.approx(
        sp.device_s)
    assert sum(st.idle_s for st in sp.stats.values()) == pytest.approx(
        sp.idle_s)
    assert [g[0] for g in sp.idle_gaps] == [g[0] for g in GAPS]
    assert [g[1] for g in sp.idle_gaps] == pytest.approx([g[1] for g in GAPS])


class _Event:
    """What ``spans.events`` reads of a kineto event."""

    def __init__(self, s, e, name, corr, cuda, annotation=False):
        self._v = (s, e, name, corr, cuda, annotation)

    def start_ns(self):
        return self._v[0]

    def duration_ns(self):
        return self._v[1] - self._v[0]

    def name(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[4]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._v[5]


def _profiler(host, dev):
    evs = ([_Event(*h, cuda=False) for h in host]
           + [_Event(*d, cuda=True) for d in dev]
           # a device-side copy of a host range, which no reader counts
           + [_Event(30, 70, "gmg:vcycle", 3, cuda=True, annotation=True)])
    results = types.SimpleNamespace(events=lambda: evs)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def _reader(name):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


HEAT_HOST = [
    (0, 100, "gmg:heat_geodesics", 1),
    (10, 30, "gmg:rap.L0", 2),
    (30, 35, "gmg:rap.L1", 3),
    (50, 70, "gmg:rap.L0", 4),
    (40, 48, "gmg:vcycle", 5),
]
POISSON = {"device.launches_per_call": 4.0, "host.syncs_per_call": 1.0,
           "vcycle.window_ms": 40 * NS * 1e3,
           "vcycle.idle_share": 100.0 * 33 / 40,
           "solve.cast_ms": 5 * NS * 1e3, "heat.rap_ms": None}
# No device: the device readers say nothing; no cast span: nor does
# solve.cast_ms.
HEAT = {"device.launches_per_call": None, "host.syncs_per_call": None,
        "vcycle.window_ms": 8 * NS * 1e3, "vcycle.idle_share": None,
        "solve.cast_ms": None, "heat.rap_ms": 45 * NS * 1e3}
BARE = dict.fromkeys(POISSON)       # a program that opens no spans


@pytest.mark.parametrize("host, dev, want", [
    (HOST, DEV, POISSON), (HEAT_HOST, [], HEAT),
    ([h for h in HOST if not h[2].startswith("gmg:")], DEV, BARE),
    (None, None, BARE)], ids=["poisson", "heat", "no_spans", "untraced"])
def test_readers_on_synthetic_runs(host, dev, want):
    tracer = Tracer(torch.device("cpu"), 0.0, 0.0, "call")
    if host is not None:                  # the profiler ran
        tracer.prof = _profiler(host, dev)
    run = types.SimpleNamespace()
    got = {name: _reader(name)(run) for name in want}
    for name, value in want.items():
        if value is None:
            assert got[name] is None, name
        else:
            assert got[name] == pytest.approx(value, rel=1e-9), name
