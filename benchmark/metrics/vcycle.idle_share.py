"""Percent of the V-cycles' time in which the device is idle: the
device-idle seconds while a ``gmg:vcycle`` span
(``solve/vcycle.py::v_cycle``) is open, over those spans' host wall
seconds, in the traced stretch (``benchmark/spans.py``).  Nothing off
the card, or where the program opens no such span."""

from benchmark import spans


def read(run):
    sp = spans.of(run)
    st = sp.stats.get("vcycle") if sp is not None else None
    if st is None or not st.wall_s or not sp.on_device:
        return None
    return 100.0 * st.idle_in_s / st.wall_s
