"""Milliseconds a call spends in the refit's Galerkin products
(``apps/heat.py::refit_hierarchy``, ``solve/rap.py::galerkin_rap``): the
host wall time of the ``gmg:rap.L<l>`` spans in the traced stretch, over
the calls in it (``benchmark/spans.py``).  Nothing where the program
opens no such span."""

from benchmark import spans


def read(run):
    sp = spans.of(run)
    if sp is None or not sp.calls:
        return None
    rap = [st for name, st in sp.stats.items() if name.startswith("rap.L")]
    if not rap:
        return None
    return 1e3 * sum(st.wall_s for st in rap) / sp.calls
