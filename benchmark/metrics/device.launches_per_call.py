"""Device operations (kernels, memory copies and sets) a call launches:
those whose runtime launch lies inside an entry span (``gmg:mg_solve``,
``gmg:heat_geodesics``) in the traced stretch, over the entry spans in
it (``benchmark/spans.py``).  Nothing off the card, or where the
program opens no spans."""

from benchmark import spans


def read(run):
    sp = spans.of(run)
    if sp is None or not sp.calls or not sp.on_device:
        return None
    return sp.launches / sp.calls
