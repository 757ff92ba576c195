"""Milliseconds of one V-cycle as the window's calls run it: the mean
host wall time of the ``gmg:vcycle`` spans
(``solve/vcycle.py::v_cycle``) in the traced stretch
(``benchmark/spans.py``), beside ``vcycle.ms``'s chained cycles after
the window.  Nothing where the program opens no such span."""

from benchmark import spans


def read(run):
    sp = spans.of(run)
    st = sp.stats.get("vcycle") if sp is not None else None
    if st is None or not st.count:
        return None
    return 1e3 * st.wall_s / st.count
