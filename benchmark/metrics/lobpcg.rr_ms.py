"""Milliseconds of a LOBPCG step's Rayleigh-Ritz solve
(``apps/spectral.py::_rayleigh_ritz_host``: the Grams to the host, the
f64 pencil's ``eigh`` there, the rotation back to the card): the mean
over every step of the window's calls of the ``rr_s`` stage, which a
``record`` times synchronised with the card before and after."""

import statistics


def read(run):
    steps = [s["rr_s"] for a in run.window.answers
             if a.record and "orth_fallbacks" in a.record
             for s in a.record["steps"]]
    return 1e3 * statistics.fmean(steps) if steps else None
