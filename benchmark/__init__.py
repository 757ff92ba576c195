"""The benchmark of the PyTorch and CUDA port, ``gravomg_tpu_torch``.

``BENCHMARK.json`` at the root of the repository names its cells; each
part of a cell is a file of its own that the harness (``run.py``) finds
by name: a configuration in ``configs/`` (its cloud's generator in
``clouds/``), a traffic mix in ``traffic/`` (the port's entry it drives,
with that entry's check and control, in ``calls/``), a per-layer
metric's reader in ``metrics/``, a cell's limits in ``limits/``.
``reference/`` is the plain reference the answers are judged by;
``calibrate.py`` takes the readings the limits are set from.
"""
