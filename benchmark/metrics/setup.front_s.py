"""Seconds of set-up's front end: grid kNN, Laplacian and
screened-Poisson operator (``geometry/gridknn.py``, ``apps/poisson.py``),
on the synchronised host clock around the calls."""


def read(run):
    return run.spans.get("front")
