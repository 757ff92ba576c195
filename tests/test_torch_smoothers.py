"""PyTorch port vs the JAX package: smoothers, Chebyshev bounds and the
coarse Cholesky solve at f64 on the two shipped solver fixtures.

Tolerances: smoothers and bounds at rtol 1e-12, the coarse factor and
solve at 1e-10 (Cholesky of another LAPACK build).  The zero-guess skip
is exact (``torch.equal``) against the explicit-zero path.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.solve import coarse as jcoarse
from gravomg_tpu.solve import smoothers as jsm

from gravomg_tpu_torch.io.serialization import solver_from_numpy
from gravomg_tpu_torch.solve import coarse as tcoarse
from gravomg_tpu_torch.solve import smoothers as tsm
from gravomg_tpu_torch.types import EllOperator

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
FIXTURES = ["entry_hierarchy.npz", "halo_hierarchy.npz"]


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _both64(name, tmp_path):
    """(JAX hierarchy, torch hierarchy) of a fixture at f64."""
    with np.load(os.path.join(ASSETS, name)) as z:
        arrays = {k: (z[k].astype(np.float64) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    path = tmp_path / f"{name}_64.npz"
    np.savez(path, **arrays)
    return jax_load_solver(str(path)), solver_from_numpy(arrays, device="cpu")


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@jax.jit
def _jax_smooth(op, x, b, p):
    return (jsm.chebyshev(op, x, b, p, 4),
            jsm.weighted_jacobi(op, x, b, 3),
            jsm.chebyshev(op, jnp.zeros_like(b), b, p, 4, x0_zero=True))


def test_smoothers_match_f64(tmp_path):
    rng = np.random.default_rng(3)
    for name in FIXTURES:
        hj, ht = _both64(name, tmp_path)
        for lj, lt in zip(hj.levels, ht.levels):
            n = lt.op.num_vertices
            x = rng.normal(size=n)
            b = rng.normal(size=n)
            np.testing.assert_allclose(
                float(tsm.gershgorin_lambda_max(lt.op)),
                float(jsm.gershgorin_lambda_max(lj.op)), rtol=1e-12)
            pt = tsm.ChebyshevParams.from_operator(lt.op, 16.0)
            pj = jsm.ChebyshevParams.from_operator(lj.op, 16.0)
            np.testing.assert_allclose(
                [pt.lam_min, pt.lam_max],
                [float(pj.lam_min), float(pj.lam_max)], rtol=1e-12)
            xt, bt = torch.as_tensor(x), torch.as_tensor(b)
            zt = torch.zeros_like(bt)
            got = (tsm.chebyshev(lt.op, xt, bt, pt, 4),
                   tsm.weighted_jacobi(lt.op, xt, bt, 3),
                   tsm.chebyshev(lt.op, zt, bt, pt, 4, x0_zero=True))
            want = _jax_smooth(lj.op, jnp.asarray(x), jnp.asarray(b), pj)
            for a, w in zip(got, want):
                _close(a, w, 1e-12)
            assert torch.equal(
                tsm.chebyshev(lt.op, zt, bt, pt, 4, x0_zero=True),
                tsm.chebyshev(lt.op, zt, bt, pt, 4))
            assert torch.equal(
                tsm.weighted_jacobi(lt.op, zt, bt, 3, x0_zero=True),
                tsm.weighted_jacobi(lt.op, zt, bt, 3))


def test_coarse_solve_matches_f64(tmp_path):
    """Factor and solve on both fixtures' coarsest level; the shift
    escalation and its failure."""
    for name in FIXTURES:
        hj, ht = _both64(name, tmp_path)
        opt, opj = ht.levels[-1].op, hj.levels[-1].op
        lt = tcoarse.factor_coarse(opt)
        lj = jcoarse.factor_coarse(opj)
        _close(lt, lj, 1e-10)
        b = np.random.default_rng(5).normal(size=opt.num_vertices)
        xt = tcoarse.coarse_solve(lt, torch.as_tensor(b))
        _close(xt, jcoarse.coarse_solve(lj, jnp.asarray(b)), 1e-10)
        # And it solves the symmetrised system.
        a = opt.as_dense()
        a = 0.5 * (a + a.T)
        r = a @ xt - torch.as_tensor(b)
        assert float(r.norm() / np.linalg.norm(b)) < 1e-6

    # A singular operator takes a positive shift; an indefinite one
    # escalates through every shift and raises.
    nbr = torch.tensor([[1], [0]], dtype=torch.int32)
    one = torch.tensor([1.0, 1.0], dtype=torch.float64)
    # [[1, -1], [-1, 1]]: singular, factorable after a shift.
    lap = EllOperator(nbr, -one[:, None], one)
    assert torch.isfinite(tcoarse.factor_coarse(lap)).all()
    bad = EllOperator(nbr, 3 * one[:, None], one)
    with pytest.raises(RuntimeError, match="positive definite"):
        tcoarse.factor_coarse(bad)
