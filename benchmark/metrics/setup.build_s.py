"""Seconds of set-up's hierarchy build
(``hierarchy.py::build_hierarchy_device``), on the synchronised host
clock around the call."""


def read(run):
    return run.spans.get("build")
