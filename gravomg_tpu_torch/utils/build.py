"""Compile the package's native sources into shared libraries at first
use, into ``gravomg_tpu_torch/_build/`` (listed in .gitignore)."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


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


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the package's CUDA kernels are "
                       "built from source on a machine with the CUDA "
                       "toolkit")


class CudaLibrary:
    """One kernel source of ``gravomg_tpu_torch/csrc/`` with a plain C
    interface: built with nvcc (sm_90a) at first use and loaded with
    ctypes.  ``functions`` maps each exported name to its argtypes; every
    export returns an int (a cudaError_t, 0 on success)."""

    def __init__(self, source: str, functions: dict):
        self.src = os.path.join(PKG_DIR, "csrc", source)
        self.name = "libgmg_" + os.path.splitext(source)[0] + ".so"
        self.functions = functions
        self._lib = None
        self._lock = threading.Lock()

    def build(self, force: bool = False) -> str:
        return build_shared([nvcc(), *NVCC_FLAGS], self.src, self.name,
                            force)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for name, argtypes in self.functions.items():
                    fn = getattr(lib, name)
                    fn.restype = ctypes.c_int
                    fn.argtypes = argtypes
                self._lib = lib
        return self._lib
