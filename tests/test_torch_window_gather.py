"""The gather probes' windowed ELL SpMV (``ops/window_gather.py``) and
the probe function of ``probes/gather.py`` against a numpy transcription
of the TPU kernels' body (``scripts/profile_pltake.py``: ``make_variant``
with ``body_take``; ``scripts/profile_gather2.py``: ``pl_take``).  The
scripts run on import and the JAX package has no test of them, so the
transcription is the reference: per row block, the window of x at the
block's start (clamped as ``lax.dynamic_slice`` clamps it), then
acc += w[:, k] * window[lidx[:, k]] for k in order, in f32.

At V = 12,000 (11 blocks) P2's starts from block 4 on run past x[:NB*B]
and are clamped.  Tolerance rtol 1e-6 (the same products, summed in the
same order; only the final scale-and-add may round differently).
"""

import numpy as np
import pytest

from gravomg_tpu_torch.probes.gather import B, K, WD, probe, probe_inputs

V = 12_000


def _reference(x, starts, lidx, w):
    out = np.empty((starts.shape[0], B), np.float32)
    for b, s in enumerate(starts):
        s = min(max(int(s), 0), x.shape[0] - WD)
        win = x[s:s + WD]
        acc = np.zeros((B,), np.float32)
        for k in range(K):
            acc = acc + w[b, :, k] * win[lidx[b, :, k]]
        out[b] = acc
    return out.reshape(-1) * np.float32(1e-3) + x


@pytest.mark.parametrize("name", ["P1", "P2"])
def test_probe_matches_numpy_transcription(name):
    x, starts, lidx, w = probe_inputs(V, device="cpu")
    st = starts[name].numpy()
    assert x.shape == (V // B * B,) and lidx.shape == (V // B, B, K)
    # P1 shifts the starts back by WD/4; P2's run off the end of x.
    if name == "P1":
        assert st[0] == 0 and st[-1] == V - WD - WD // 4
    else:
        assert st[-1] == V - WD and st[-1] + WD > x.shape[0]
    want = _reference(x.numpy(), st, lidx.numpy(), w.numpy())
    got = probe(x, starts[name], lidx, w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
