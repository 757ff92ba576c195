"""Device operations (kernels, memory copies and sets) a LOBPCG step
launches: those whose runtime launch lies inside any of the port's
spans in the traced stretch, over the ``gmg:lobpcg.step`` spans in it
(``benchmark/spans.py``; ``laplace_eigs``' own set-up and final residual
count with its steps).  Nothing off the card, or where the program opens
no such span."""

from benchmark import spans


def read(run):
    sp = spans.of(run)
    st = sp.stats.get("lobpcg.step") if sp is not None else None
    if st is None or not st.count or not sp.on_device:
        return None
    inside = sum(s.launches for name, s in sp.stats.items()
                 if name != spans.OUTSIDE)
    return inside / st.count
