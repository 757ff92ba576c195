"""Seconds of set-up's fast forms (``solve/vcycle.py::attach_operators``:
slab forms, ``ops/slab.py``, then uniform forms), on the synchronised
host clock around the call; nothing where the configuration attaches
none."""


def read(run):
    return run.spans.get("forms")
