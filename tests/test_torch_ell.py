"""PyTorch port vs the JAX package: fixture loading and the ELL
operations (spmv, residual, prolong, restrict, restrict_gather) on the
two shipped solver fixtures.

Tolerances: f64 at rtol 1e-12 (the same operations in another framework;
only the summation order may differ), f32 at atol 1e-6 * max|y|.

Each test module of the port holds at most two tests: pytest-xdist
queues files by test count, so small files run after the JAX package's
own files and leave their scheduling as it was.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.prolong import operator as jop
from gravomg_tpu.solve import spmv as jspmv

from gravomg_tpu_torch.io.serialization import load_solver, solver_from_numpy
from gravomg_tpu_torch.prolong import operator as top
from gravomg_tpu_torch.solve import spmv as tspmv

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
FIXTURES = ["entry_hierarchy.npz", "halo_hierarchy.npz"]


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _both(name, tmp_path, dtype):
    """(JAX hierarchy, torch hierarchy) of a fixture at ``dtype``."""
    with np.load(os.path.join(ASSETS, name)) as z:
        arrays = {k: (z[k].astype(dtype) if z[k].dtype.kind == "f" else z[k])
                  for k in z.files}
    path = tmp_path / f"h_{np.dtype(dtype).name}.npz"
    np.savez(path, **arrays)
    return jax_load_solver(str(path)), solver_from_numpy(arrays, device="cpu")


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_load_solver_identical_arrays():
    for name in FIXTURES:
        hj = jax_load_solver(os.path.join(ASSETS, name))
        ht = load_solver(os.path.join(ASSETS, name), device="cpu")
        assert len(hj.levels) == len(ht.levels)
        np.testing.assert_array_equal(_np(ht.coarse_chol),
                                      _np(hj.coarse_chol))
        for lj, lt in zip(hj.levels, ht.levels):
            for a, b in ((lt.op.neighbors, lj.op.neighbors),
                         (lt.op.offdiag, lj.op.offdiag),
                         (lt.op.diag, lj.op.diag)):
                assert _np(a).dtype == _np(b).dtype
                np.testing.assert_array_equal(_np(a), _np(b))
            assert (lt.u is None) == (lj.u is None)
            if lt.u is not None:
                assert lt.u.n_coarse == lj.u.n_coarse
                np.testing.assert_array_equal(_np(lt.u.cols),
                                              _np(lj.u.cols))
                np.testing.assert_array_equal(_np(lt.u.weights),
                                              _np(lj.u.weights))
                # Derived U^T tables: same cap, order and weights.
                np.testing.assert_array_equal(_np(lt.ut.rows),
                                              _np(lj.ut.rows))
                np.testing.assert_array_equal(_np(lt.ut.weights),
                                              _np(lj.ut.weights))
            assert (lt.cheb is None) == (lj.cheb is None)
            if lt.cheb is not None:
                assert lt.cheb.lam_min == float(lj.cheb.lam_min)
                assert lt.cheb.lam_max == float(lj.cheb.lam_max)


@jax.jit
def _jax_ell_ops(lvl, x, xm, b, xc):
    out = [jspmv.spmv(lvl.op, x), jspmv.spmv(lvl.op, xm),
           jspmv.residual(lvl.op, x, b)]
    if lvl.u is not None:
        out += [jop.prolong(lvl.u, xc), jop.restrict(lvl.u, x),
                jop.restrict(lvl.u, xm), jop.restrict_gather(lvl.ut, x)]
    return out


def _torch_ell_ops(lvl, x, xm, b, xc):
    out = [tspmv.spmv(lvl.op, x), tspmv.spmv(lvl.op, xm),
           tspmv.residual(lvl.op, x, b)]
    if lvl.u is not None:
        out += [top.prolong(lvl.u, xc), top.restrict(lvl.u, x),
                top.restrict(lvl.u, xm), top.restrict_gather(lvl.ut, x)]
    return out


def test_ell_operations_match(tmp_path):
    """Every level of both fixtures, at f64 and at f32; 1-D and (n, 3)
    inputs."""
    for name, dtype in [(n, d) for n in FIXTURES
                        for d in (np.float64, np.float32)]:
        hj, ht = _both(name, tmp_path, dtype)
        rng = np.random.default_rng(7)
        for lj, lt in zip(hj.levels, ht.levels):
            n = lt.op.num_vertices
            nc = lt.u.n_coarse if lt.u is not None else 1
            args = [rng.normal(size=s).astype(dtype)
                    for s in (n, (n, 3), n, nc)]
            got = _torch_ell_ops(lt, *map(torch.as_tensor, args))
            want = _jax_ell_ops(lj, *map(jnp.asarray, args))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                _close(a, b, dtype)
            if lt.u is not None:
                # Gather and scatter forms of U^T agree with each other.
                _close(got[6], got[4], dtype)
