"""LOBPCG steps a call takes (``apps/spectral.py::laplace_eigs``): the
mean over the window's calls of ``record["iters"]``, which every call of
an eigenpairs mix passes."""

import statistics


def read(run):
    its = [a.record["iters"] for a in run.window.answers
           if a.record and "orth_fallbacks" in a.record]
    return statistics.fmean(its) if its else None
