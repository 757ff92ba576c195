"""Milliseconds of a LOBPCG step's device half
(``apps/spectral.py::_lobpcg_block``: residual, the (V, k) V-cycle, the
orthonormalisations, the search block's product with L and its f64
Grams): the mean over every step of the window's calls of the
``block_s`` stage, which a ``record`` times synchronised with the card
before and after."""

import statistics


def read(run):
    steps = [s["block_s"] for a in run.window.answers
             if a.record and "orth_fallbacks" in a.record
             for s in a.record["steps"]]
    return 1e3 * statistics.fmean(steps) if steps else None
