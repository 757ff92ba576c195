"""The port imports neither JAX nor the JAX package: every module of
``gravomg_tpu_torch`` is imported in a fresh interpreter in which
``jax``, ``gravomg_tpu`` and the repo's root-level JAX drivers
(``__graft_entry__``, ``bench``) cannot be imported."""

import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "gravomg_tpu", "__graft_entry__", "bench")
for name in BLOCKED:
    sys.modules[name] = None      # a later import of it raises ImportError
import gravomg_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    gravomg_tpu_torch.__path__, "gravomg_tpu_torch."))
for name in names:
    importlib.import_module(name)
loaded = [k for k, v in sys.modules.items() if v is not None
          and k.split(".")[0] in BLOCKED]
print(len(names), loaded)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, loaded = proc.stdout.split(" ", 1)
    assert loaded.strip() == "[]"
    # Every subpackage and module of the port, the driver surfaces too.
    assert int(count) >= 60
