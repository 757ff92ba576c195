"""The ELL product's plain twin and the dispatch to the kernel E1 on the
CPU (``solve/spmv.py``, ``ops/ell_cuda.py``; the kernel itself runs in
``tests/test_torch_ell_card.py``), and the row-major, checked tables that
``io/serialization.py`` loads for it.

``spmv_plain`` is the former ``spmv``, moved unchanged, kept as the
kernel's twin and the CPU path.  The dispatch sends only one operator
with float32 values and a float32 x on the card to the kernel; on the
CPU everything takes the twin.
"""

import os
import types

import numpy as np
import pytest
import torch

from gravomg_tpu_torch.io.serialization import load_solver, solver_from_numpy
from gravomg_tpu_torch.ops import ell_cuda
from gravomg_tpu_torch.ops.ell_cuda import ell_spmv_cuda
from gravomg_tpu_torch.solve import spmv as spmv_module
from gravomg_tpu_torch.solve.spmv import spmv, spmv_plain
from gravomg_tpu_torch.types import INVALID_INDEX, EllOperator

torch.set_num_threads(2)
V, K = 500, 12
HALO = os.path.join(os.path.dirname(__file__), os.pardir, "assets",
                    "halo_hierarchy.npz")


def _dense(op):
    """The operator (or each of a stack) as a dense float64 matrix: its
    real slots summed into their columns, the diagonal added."""
    nbr, off, diag = op.neighbors, op.offdiag.double(), op.diag.double()
    mask = nbr != INVALID_INDEX
    flat = nbr.reshape(-1, *nbr.shape[-2:])
    a = torch.zeros(flat.shape[0], V, V, dtype=torch.float64)
    for b in range(flat.shape[0]):
        m = mask.reshape(flat.shape)[b]
        rows = torch.arange(V)[:, None].expand(V, K)[m]
        a[b].index_put_((rows, flat[b][m].long()),
                        off.reshape(flat.shape)[b][m], accumulate=True)
        a[b] += torch.diag(diag.reshape(flat.shape[:2])[b])
    return a if nbr.ndim == 3 else a[0]


def _operator(rng, v=V, k=K, dtype=torch.float32, batch=None):
    """A random ELL operator whose padding slots sit anywhere in a row
    (the first row has one in the middle of real slots) and carry
    nonzero values, which no product may use."""
    shape = (v, k) if batch is None else (batch, v, k)
    nbr = rng.integers(0, v, size=shape).astype(np.int32)
    pad = rng.random(shape) < 0.3
    pad[..., 0, :] = False
    pad[..., 0, k // 2] = True
    nbr[pad] = INVALID_INDEX
    off = rng.normal(size=shape)
    diag = rng.normal(size=shape[:-1]) + 4.0
    return EllOperator(torch.as_tensor(nbr), torch.as_tensor(off, dtype=dtype),
                       torch.as_tensor(diag, dtype=dtype))


@pytest.mark.parametrize("case", ["1-D", "D=1", "D=3", "D=12", "D=36",
                                  "stack", "f64"])
def test_plain_twin_is_the_former_spmv(case):
    """``spmv_plain`` on a 1-D x, (V, D) blocks, a stack of operators and
    f64 values equals the operator's dense product, each entry within
    1e-6 (f64: 1e-12) of its row's sum of absolute terms; the operator
    has a padding slot in the middle of its first row, and the padding
    slots' values count for nothing.  ``spmv`` on the CPU is the twin, bit
    for bit, and launches nothing."""
    rng = np.random.default_rng(21)
    dtype = torch.float64 if case == "f64" else torch.float32
    op = _operator(rng, dtype=dtype, batch=2 if case == "stack" else None)
    assert case == "stack" or int(op.neighbors[0, K // 2]) == INVALID_INDEX
    if case in ("1-D", "f64"):
        shape = (V,)
    elif case == "stack":
        shape = (2, V)
    else:
        shape = (V, int(case[2:]))
    x = torch.as_tensor(rng.normal(size=shape), dtype=dtype)
    got = spmv_plain(op, x)
    a, x64 = _dense(op), x.double()
    if case == "stack":
        want = torch.einsum("bvw,bw->bv", a, x64)
        mag = torch.einsum("bvw,bw->bv", a.abs(), x64.abs())
    else:
        want, mag = a @ x64, a.abs() @ x64.abs()
    tol = 1e-12 if case == "f64" else 1e-6
    assert got.dtype == dtype and got.shape == x.shape
    assert bool(((got.double() - want).abs() <= tol * mag).all()), case
    before = ell_spmv_cuda.launches
    assert torch.equal(spmv(op, x), got)
    assert ell_spmv_cuda.launches == before
    # The padding slots' values count for nothing.
    clean = op._replace(offdiag=torch.where(op.mask, op.offdiag,
                                            torch.zeros_like(op.offdiag)))
    assert torch.equal(spmv_plain(clean, x), got)


def test_dispatch_and_wrapper_checks(monkeypatch):
    """Stand-ins for x that claim to be CUDA tensors show the dispatch's
    routes: one float32 operator with a 1-D or 2-D float32 x goes to the
    kernel as it is; a stack, f64 values, an f64 x and a CPU x take the
    twin.  The wrapper refuses int64 neighbors, other value dtypes, a
    stack, a non-contiguous table or x and a wrong length, then a CPU x
    that passes every other check.  A hierarchy loaded from a file saved
    column-major comes row-major, and one with a neighbour index outside
    its level's rows is refused at load."""
    rng = np.random.default_rng(22)
    op = _operator(rng)
    stack = _operator(rng, batch=2)
    op64 = op._replace(offdiag=op.offdiag.double(), diag=op.diag.double())
    routes, sent = [], []
    monkeypatch.setattr(spmv_module, "ell_spmv_cuda",
                        lambda o, x: (routes.append("kernel"), sent.append(o)))
    monkeypatch.setattr(spmv_module, "spmv_plain",
                        lambda o, x: routes.append("plain"))

    def stand_in(ndim, dtype, cuda=True):
        x = types.SimpleNamespace(is_cuda=cuda, ndim=ndim, dtype=dtype)
        x.contiguous = lambda: x
        return x

    for o, x in ((op, stand_in(1, torch.float32)),
                 (op, stand_in(2, torch.float32)),
                 (stack, stand_in(2, torch.float32)),
                 (op64, stand_in(1, torch.float64)),
                 (op, stand_in(1, torch.float64)),
                 (op64, stand_in(1, torch.float32)),
                 (op, stand_in(1, torch.float32, cuda=False))):
        spmv_module.spmv(o, x)
    assert routes == ["kernel", "kernel", "plain", "plain", "plain",
                      "plain", "plain"]
    assert sent[0] is op and sent[1] is op

    x = torch.randn(V, 12)
    with pytest.raises(ValueError, match="int32"):
        ell_spmv_cuda(op._replace(neighbors=op.neighbors.long()), x)
    with pytest.raises(ValueError, match="float32"):
        ell_spmv_cuda(op64, x)
    with pytest.raises(ValueError, match="one operator"):
        ell_spmv_cuda(stack, x)
    with pytest.raises(ValueError, match="contiguous, on one device"):
        ell_spmv_cuda(op._replace(offdiag=op.offdiag.t().contiguous().t()),
                      x)
    for bad in (torch.randn(12, V).t(), x[:-1], x.double(),
                torch.randn(V, 2, 2)):
        with pytest.raises(ValueError, match=f"with V={V} rows"):
            ell_spmv_cuda(op, bad)
    before = ell_spmv_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ell_spmv_cuda(op, x)
    with pytest.raises(ValueError, match="CUDA"):
        ell_spmv_cuda(op, x[:, 0].contiguous())
    assert ell_spmv_cuda.launches == before
    # A checked operator is checked again when its values change.
    assert ell_cuda._device(op) == torch.device("cpu")
    with pytest.raises(ValueError, match="float32"):
        ell_cuda._device(op._replace(offdiag=op.offdiag.half()))

    # The fixture's tables are stored column-major; loaded, row-major.
    with np.load(HALO) as z:
        arrays = dict(z)
    assert not arrays["l0_nbr"].flags["C_CONTIGUOUS"]
    h = load_solver(HALO, device="cpu")
    assert all(t.is_contiguous() for lvl in h.levels for t in lvl.op)
    bad = arrays["l1_nbr"].copy()
    bad[3, 0] = bad.shape[0]
    with pytest.raises(ValueError, match=r"level 1: a neighbour index "
                       r"outside \[0, 3584\)"):
        solver_from_numpy({**arrays, "l1_nbr": bad}, device="cpu")
