"""The byte count of ``slab_matvec.roofline`` reads the operator's own
nonzeros: padding slots and stored zeros do not count, and no form's
windows enter it."""

import importlib.util
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _reader():
    path = os.path.join(ROOT, "benchmark", "metrics",
                        "slab_matvec.roofline.py")
    spec = importlib.util.spec_from_file_location("roofline_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_roofline_bytes_by_hand():
    mod = _reader()
    # 4 rows, 3 slots a row: 7 nonzeros off the diagonal, 3 padding
    # slots, 2 stored zeros.
    nbr = torch.tensor([[1, 2, 3], [0, 2, -1], [0, 1, 3], [2, -1, -1]])
    off = torch.tensor([[-1.0, -2.0, 0.0], [-1.0, -0.5, 0.0],
                        [-2.0, -0.5, 0.0], [-1.0, 0.0, 0.0]])
    valid = nbr >= 0
    vectors = 3 * 4 * 4                      # x, y, the diagonal
    assert mod.operator_bytes(nbr, off, valid, 4) == 7 * (4 + 4) + vectors
    assert mod.operator_bytes(nbr, off, valid, 2) == 7 * (2 + 4) + vectors


def test_bench_roofline_bytes_ignore_the_form():
    """Two tables of one operator, one padded four times wider, count
    the same bytes."""
    mod = _reader()
    g = torch.Generator().manual_seed(0)
    v, d = 64, 6
    nbr = torch.randint(0, v, (v, d), generator=g)
    off = -torch.rand((v, d), generator=g) - 0.1
    wide_nbr = torch.cat([nbr, torch.full((v, 3 * d), -1)], dim=1)
    wide_off = torch.cat([off, torch.zeros((v, 3 * d))], dim=1)
    a = mod.operator_bytes(nbr, off, nbr >= 0, 4)
    b = mod.operator_bytes(wide_nbr, wide_off, wide_nbr >= 0, 4)
    assert a == b == v * d * 8 + 3 * v * 4
