"""Krylov iterations a call takes (``solve/cg.py``): ``mg_solve``'s
returned count, or for ``heat_geodesics`` the sum of its two solves'
``record`` counts; the mean over the window's calls."""

import statistics


def read(run):
    its = [a.iters for a in run.window.answers if a.iters is not None]
    return statistics.fmean(its) if its else None
