"""Seconds of a stage, synchronised with the device, into a caller's
record dict (the ``record=`` argument of the builders and the apps)."""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def synchronize(dev: torch.device) -> None:
    """Waits for the card's queued work when ``dev`` is a CUDA device."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage(record: Optional[dict], name: str, dev: torch.device):
    """Adds the synchronised seconds of the enclosed stage to
    ``record[name]``; does nothing when ``record`` is None."""
    if record is None:
        yield
        return
    synchronize(dev)
    t0 = time.perf_counter()
    yield
    synchronize(dev)
    record[name] = record.get(name, 0.0) + time.perf_counter() - t0
