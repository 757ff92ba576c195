"""PyTorch port vs the JAX package: the uniform block-window format
(window placement, m, escape chute, trim, plain matvec) and the greedy
per-block window counts.

Converted arrays are compared exactly; matvecs at atol 1e-6 * max|y|
(summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import torch

from gravomg_tpu.ops import blockdense as jbd
from gravomg_tpu.ops import slab as jslab

from gravomg_tpu_torch.ops import blockdense as tbd
from gravomg_tpu_torch.ops import slab as tslab

torch.set_num_threads(2)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tailed_ell(rng, r, k, nc, far_p=0.03):
    """Locality-ordered ELL columns with a far-column tail."""
    base = (np.arange(r) * nc // r)[:, None]
    cols = np.clip(base + rng.integers(-80, 80, size=(r, k)), 0, nc - 1)
    far = rng.random((r, k)) < far_p
    cols = np.where(far, rng.integers(0, nc, size=(r, k)),
                    cols).astype(np.int32)
    vals = rng.normal(size=(r, k)).astype(np.float32)
    valid = rng.random((r, k)) < 0.9
    return cols, vals, valid


def _assert_same(bt, bj):
    for f in ("m", "win_start", "esc_rows", "esc_cols", "esc_w"):
        np.testing.assert_array_equal(_np(getattr(bt, f)),
                                      _np(getattr(bj, f)), err_msg=f)
    for f in ("n_rows", "n_cols", "block", "window", "window0", "align"):
        assert getattr(bt, f) == getattr(bj, f), f


def test_blockdense_from_ell_matches_jax():
    """Scaled-diagonal anchors, unaligned and 128-aligned starts, a
    rectangular and a square operator."""
    rng = np.random.default_rng(11)
    cols, vals, valid = _tailed_ell(rng, r=700, k=8, nc=900)
    diag = (rng.normal(size=700) + 5).astype(np.float32)
    x = rng.normal(size=900).astype(np.float32)
    for align in (0, 128):
        kw = dict(block=16, window=128, nw=4, escape_cap=2048, window0=256,
                  align=align)
        for c, n_cols, d in ((cols, 900, None),
                             (np.minimum(cols, 699), 700, diag)):
            bt, ovt = tbd.blockdense_from_ell(
                torch.as_tensor(c), torch.as_tensor(vals),
                torch.as_tensor(valid), n_cols,
                diag=None if d is None else torch.as_tensor(d), **kw)
            bj, ovj = jbd.blockdense_from_ell(
                jnp.asarray(c), jnp.asarray(vals), jnp.asarray(valid),
                n_cols, diag=None if d is None else jnp.asarray(d), **kw)
            assert ovt == bool(ovj)
            _assert_same(bt, bj)
            bt, bj = tbd.trim_escape(bt), jbd.trim_escape(bj)
            _assert_same(bt, bj)
            yt = _np(tbd.blockdense_matvec(bt, torch.as_tensor(x[:n_cols])))
            yj = _np(jbd.blockdense_matvec(bj, jnp.asarray(x[:n_cols])))
            np.testing.assert_allclose(yt, yj, atol=1e-6 * np.abs(yj).max())


def test_window_counts_match_jax():
    rng = np.random.default_rng(2)
    cols, _, valid = _tailed_ell(rng, r=512, k=6, nc=700)
    for align in (0, 128):
        ct, ft, ot = tslab.window_counts(torch.as_tensor(cols),
                                         torch.as_tensor(valid), 8, 128,
                                         align=align)
        cj, fj, oj = jslab.window_counts(jnp.asarray(cols),
                                         jnp.asarray(valid), 8, 128,
                                         align=align)
        np.testing.assert_array_equal(_np(ct), _np(cj))
        np.testing.assert_array_equal(_np(ft), _np(fj))
        assert ot == bool(oj)
