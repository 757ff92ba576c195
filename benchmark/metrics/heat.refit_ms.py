"""Milliseconds a call spends refitting the hierarchy to its two
operators (``apps/heat.py::refit_hierarchy``: RAP on every level and a
new coarse factor), the mean over the traced window's calls of
``record["refit_heat_s"] + record["refit_poisson_s"]``."""

import statistics


def read(run):
    recs = [a.record for a in run.window.answers
            if a.record and "refit_heat_s" in a.record]
    if not recs:
        return None
    return 1e3 * statistics.fmean(r["refit_heat_s"] + r["refit_poisson_s"]
                                  for r in recs)
