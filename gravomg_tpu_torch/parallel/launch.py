"""Start the ranks of a ``torch.distributed`` run from one Python
process, and the collectives the sharded paths use.

``run_ranks(fn, world_size, backend, device, args)`` spawns
``world_size`` processes (``torch.multiprocessing.start_processes``,
``spawn``), joins them into one process group through a ``FileStore`` in
a fresh temporary directory (no TCP port, so concurrent runs never
clash), calls ``fn(rank, world_size, device, *args)`` in each, and
returns the ranks' return values in rank order (each rank saves its own
with ``torch.save`` into that directory).  ``fn`` must be importable by
name from a module that a fresh interpreter can import: a spawned rank
starts from nothing.  Each rank uses one CPU thread.  A rank's exception
fails the caller (``RankError``, with every failed rank's traceback);
every collective and the caller's wait have a time limit, so a hang
becomes a failure.

The backend is the caller's choice, never switched here: ``gloo`` for
CPU tensors, ``nccl`` for one rank per card, ``gloo`` for CUDA tensors
when ranks share one card (NCCL refuses two ranks on one GPU).  Gloo
takes CUDA tensors in the three collectives below and moves them
through host memory itself, so no number taken over gloo measures a
link between cards.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# Seconds a collective may wait for its peers before it raises.
COLLECTIVE_TIMEOUT_S = 300.0


class RankError(RuntimeError):
    """A rank of :func:`run_ranks` failed; the message holds the
    traceback of every rank that raised."""


def _rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: a CUDA device without an index becomes
    ``cuda:<rank % device_count>`` (one rank per card, or all ranks on
    the one card there is); anything else is taken as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               device, args: Sequence[Any], workdir: str,
               timeout_s: float) -> None:
    torch.set_num_threads(1)
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world_size, dev, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        # Every rank's own traceback, for the caller: a peer of the rank
        # at fault fails too, in its collective, and may be seen first.
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, backend: str, device,
              args: Sequence[Any] = (), timeout_s: float = 600.0,
              collective_timeout_s: float = COLLECTIVE_TIMEOUT_S) -> List:
    """Runs ``fn(rank, world_size, device, *args)`` on ``world_size``
    spawned ranks of a ``backend`` process group; returns their results
    in rank order.  Raises RankError with the traceback of every rank
    that raised, or TimeoutError after ``timeout_s`` seconds, having
    killed the ranks either way."""
    workdir = tempfile.mkdtemp(prefix="gravomg_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, device, tuple(args),
                              workdir, collective_timeout_s),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks of "
                                       f"{getattr(fn, '__name__', fn)} "
                                       f"still running after {timeout_s} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errs = []
            for r in range(world_size):
                path = os.path.join(workdir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
            raise RankError("\n".join(errs) or str(e)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The rank-ordered concatenation along dim 0 of every rank's ``x``
    (equal shapes).  ``all_gather_single`` where this torch has it, else
    ``all_gather_into_tensor`` (the same collective under its older
    name)."""
    ws = dist.get_world_size(group)
    out = x.new_empty((ws * x.shape[0],) + tuple(x.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


def all_to_all(buf: torch.Tensor, group=None) -> torch.Tensor:
    """Equal-split all-to-all along dim 0: slice o of ``buf`` goes to
    rank o, and slice o of the result came from rank o (dim 0 a multiple
    of the world size)."""
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``x``; every rank receives the same
    value (the stopping tests of the sharded solves read it)."""
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x
