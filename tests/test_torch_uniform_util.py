"""Shared by the tests of the uniform kernel (``csrc/uniform_matvec.cu``):
uniform block-window forms that reach every branch of the kernel, and
the uniform forms of a hierarchy.  Imports neither JAX nor the JAX
package, so the card-only tests that use it run without JAX."""

import numpy as np
import torch

from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              blockdense_from_ell,
                                              padded_length, trim_escape)


def _ell(rng, r, k, nc, spread=80, far_p=0.03):
    """Locality-ordered ELL columns with a far-column tail (the escape
    chute's entries when the windows are few)."""
    base = (np.arange(r) * nc // r)[:, None]
    cols = np.clip(base + rng.integers(-spread, spread, size=(r, k)), 0,
                   nc - 1)
    far = rng.random((r, k)) < far_p
    cols = np.where(far, rng.integers(0, nc, size=(r, k)), cols)
    vals = rng.normal(size=(r, k)).astype(np.float32)
    valid = rng.random((r, k)) < 0.9
    return cols.astype(np.int32), vals, valid


def _form(rng, device, r, nc, k=8, diag=False, spread=80, far_p=0.03,
          **kw) -> BlockDenseOperator:
    cols, vals, valid = _ell(rng, r, k, nc, spread, far_p)
    d = (rng.normal(size=r) + 5).astype(np.float32) if diag else None
    op, overflow = blockdense_from_ell(
        torch.as_tensor(cols, device=device),
        torch.as_tensor(vals, device=device),
        torch.as_tensor(valid, device=device), nc,
        diag=None if d is None else torch.as_tensor(d, device=device), **kw)
    assert not overflow
    return trim_escape(op)


def _with_escape(op: BlockDenseOperator, rows, cols, weights):
    """``op`` with its chute replaced by these slots (sorted by row) and
    8 padding slots pointing at row n_rows."""
    dev = op.m.device
    pad = 8
    rows = list(rows) + [op.n_rows] * pad
    cols = list(cols) + [0] * pad
    weights = list(weights) + [0.0] * pad
    return op._replace(
        esc_rows=torch.tensor(rows, dtype=torch.int32, device=dev),
        esc_cols=torch.tensor(cols, dtype=torch.int32, device=dev),
        esc_w=torch.tensor(weights, dtype=torch.float32, device=dev))


def random_forms(device, seed: int = 0):
    """[(label, form, x)] of f32 uniform forms and right-hand sides:
    escape chutes and none, nw 4, 6 and 24, a last block padded past
    n_rows, 128-aligned windows that run past x's end, window starts
    that clamp at both edges, rows whose bytes are no multiple of 16,
    one row with a run of 40 escape slots, and a form whose staged
    windows need more than 48 KB of shared memory."""
    rng = np.random.default_rng(seed)
    out = []
    rect = _form(rng, device, 700, 900, block=64, window=128, nw=4,
                 window0=256, escape_cap=4096)
    assert rect.esc_w.shape[0] and 700 % 64
    out.append(("escape, nw 4, rectangular, padded last block", rect))
    square = _form(rng, device, 1000, 1000, diag=True, block=64,
                   window=128, nw=6, window0=384, escape_cap=4096)
    out.append(("escape, nw 6, diagonal", square))
    local = _form(rng, device, 600, 600, diag=True, spread=60, far_p=0.0,
                  block=32, window=16, nw=24, window0=48, escape_cap=4096)
    assert local.esc_w.shape[0] == 0
    out.append(("no escape, nw 24", local))
    out.append(("128-aligned, windows past x's end",
                _form(rng, device, 700, 900, block=64, window=128, nw=4,
                      window0=128, escape_cap=4096, align=128)))
    xlen = padded_length(square, square.n_cols)
    ws = rng.integers(-300, xlen + 300, size=tuple(square.win_start.shape))
    out.append(("starts clamped at both edges", square._replace(
        win_start=torch.as_tensor(ws, dtype=torch.int32, device=device))))
    out.append(("rows of 934 columns", _form(
        rng, device, 2000, 550, block=256, window=128, nw=4, window0=550,
        escape_cap=4096)))
    out.append(("a row with 40 escape slots", _with_escape(
        square, [3] * 40 + [500, 500, 999],
        rng.integers(0, 1000, size=43).tolist(),
        rng.normal(size=43).tolist())))
    out.append(("staged windows of 67 KB", _form(
        rng, device, 96, 20000, block=32, window=128, nw=4, window0=16384,
        escape_cap=4096)))
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(label, op, torch.randn(op.n_cols, generator=gen, device=device))
            for label, op in out]


def uniform_forms(h):
    """[(label, form)] of every uniform form of a hierarchy."""
    return [(f"L{li} {label}", getattr(lvl, field))
            for li, lvl in enumerate(h.levels)
            for field, label in (("banded", "A"), ("uw", "U"), ("utw", "U^T"))
            if isinstance(getattr(lvl, field), BlockDenseOperator)]
