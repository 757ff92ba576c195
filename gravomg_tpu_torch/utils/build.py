"""Compile the package's native sources into shared libraries at first
use, into ``gravomg_tpu_torch/_build/`` (listed in .gitignore)."""

from __future__ import annotations

import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def build_shared(compile_argv, src: str, name: str,
                 force: bool = False) -> str:
    """``compile_argv + ["-o", <so>, src]`` unless the library exists
    (or ``force``); returns its path.  Compiles to a temporary name and
    renames atomically, so concurrent builds (parallel test workers)
    never load a half-written file."""
    so = os.path.join(BUILD_DIR, name)
    if os.path.exists(so) and not force:
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*compile_argv, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compile_argv[0]} failed on {src}:\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so
