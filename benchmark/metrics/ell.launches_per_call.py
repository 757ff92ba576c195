"""Launches of the port's ELL kernel a call: device kernels whose name
holds ``ell_spmv`` (``gravomg_tpu_torch/csrc/ell_spmv.cu``) in the traced
stretch, over the entry spans in it (``gmg:heat_geodesics`` and
``gmg:laplace_eigs``, counted here by name).  Read from the device
trace, not from the wrapper's counter: a replayed CUDA graph launches
the kernel without passing through Python.  ``benchmark/spans.py``
reduces the trace by span, not by kernel, so the events are read from
its tracer.  The stretch starts and stops at call boundaries, so it
holds whole calls.  Nothing off the card, where the program opens no
entry span, or where no such kernel ran (a program without the
kernel)."""

from benchmark import spans

KERNEL = "ell_spmv"
CALLS = ("heat_geodesics", "laplace_eigs")


def read(run):
    sp = spans.of(run)
    if sp is None or not sp.on_device:
        return None
    calls = sum(sp.stats[name].count for name in CALLS if name in sp.stats)
    tracer = spans._tracer()
    if not calls or tracer is None or tracer.prof is None:
        return None
    dev, _ = spans.events(tracer.prof)
    launches = sum(1 for _, _, name, _ in dev if KERNEL in name)
    return launches / calls if launches else None
