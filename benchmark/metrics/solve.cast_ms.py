"""Device milliseconds a call spends on ``mg_solve``'s bf16 cast of the
slab and uniform forms (``solve/vcycle.py::cast_fast_operators``): the
device operations launched inside ``gmg:mg_solve.cast`` in the traced
stretch, over the calls in it (``benchmark/spans.py``).  Nothing off the
card, where the solve casts nothing (below ``cfg.bf16_threshold`` rows
or without fast forms), or where the program opens no spans."""

from benchmark import spans


def read(run):
    sp = spans.of(run)
    st = sp.stats.get("mg_solve.cast") if sp is not None else None
    if st is None or not sp.calls or not sp.on_device:
        return None
    return 1e3 * st.device_s / sp.calls
