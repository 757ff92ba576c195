"""The traffic: one general generator for every mix.

A mix is a data file, ``benchmark/traffic/<mix>.json``.  Its ``call``
names the port's entry that one call drives; the entry's module,
``benchmark/calls/<call>.py``, found by name, exports ``inputs(mix)``
(the pool drawn from the seed before the window, which the calls take
in turn), ``call(mix, i)`` (one call, returning an :class:`Answer`),
``readings(...)`` (its answers against the plain reference, for
``check.py``) and ``control(mix, i)`` (the lower-precision control, for
``calibrate.py``).  In the mix, ``pool`` is the pool's size,
``compare`` the number of answers the check compares, and the rest are
the entry's arguments.  One client sends the next call when the last
has returned: a closed loop.

Every call ends when its answer is on the host's side of a device
synchronisation, so a call's time is all of its work.  The last answer
of each pool slot is kept for the check.
"""

from __future__ import annotations

import importlib
import sys
import time
import traceback
from types import ModuleType
from typing import Callable, List, NamedTuple, Optional

import torch

from benchmark.deploy import Deployment, synchronize
from benchmark.inputs import TRAFFIC, generator


class Answer(NamedTuple):
    out: tuple                    # the entry's outputs the check compares
    ok: bool                      # the entry kept its guarantee
    iters: Optional[float]        # Krylov iterations, where known
    record: Optional[dict]        # the entry's record= or its residuals


def finite(*ts: torch.Tensor) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in ts)


def load_call(name: str) -> ModuleType:
    """The module ``benchmark/calls/<name>.py``."""
    return importlib.import_module("benchmark.calls." + name)


class Mix:
    """A traffic mix on the deployment of ``config``, its inputs drawn
    from ``seed``."""

    def __init__(self, traffic: dict, config: dict, dep: Deployment,
                 seed: int, device: torch.device, traced: bool,
                 call: Optional[Callable[["Mix", int], Answer]] = None):
        self.traffic, self.config, self.dep = traffic, config, dep
        self.kind, self.pool = traffic["call"], traffic["pool"]
        self.device, self.traced = device, traced
        self.gen = generator(seed, TRAFFIC, device)
        entry = load_call(self.kind)
        self.call = call or entry.call
        self.inputs = entry.inputs(self)
        self.kept: dict = {}          # pool slot -> (call index, Answer)

    def run(self, i: int) -> Answer:
        ans = self.call(self, i)
        synchronize(self.device)
        return ans


class Window(NamedTuple):
    seconds: float                # first call's start to last call's end
    durations: List[float]        # of each call
    answers: List[Answer]         # of each call, outputs dropped
    failed: int


def closed_loop(mix: Mix, seconds: float,
                boundary: Optional[Callable[[float], None]] = None
                ) -> Window:
    """Calls back to back until ``seconds`` have passed; the last call
    ends the window.  ``boundary(elapsed)`` runs between calls.  A call
    that raises counts as failed and the loop goes on."""
    synchronize(mix.device)
    durations, answers, failed = [], [], 0
    t0 = now = time.perf_counter()
    i = 0
    while True:
        if boundary is not None:
            boundary(now - t0)
            now = time.perf_counter()
        try:
            ans = mix.run(i)
        except Exception:                      # noqa: BLE001 - counted
            traceback.print_exc(file=sys.stderr)
            ans = Answer((), False, None, None)
        end = time.perf_counter()
        durations.append(end - now)
        if not ans.ok:
            failed += 1
        if ans.out:
            mix.kept[i % mix.pool] = (i, ans)
        answers.append(ans._replace(out=()))
        now, i = end, i + 1
        if now - t0 >= seconds:
            return Window(now - t0, durations, answers, failed)
