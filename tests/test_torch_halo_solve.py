"""The halo-exchange path (``parallel/halo.py``) on gloo ranks spawned
on the CPU (``run_ranks``; the rank bodies are in
tests/test_torch_dist_ranks.py), in f64.

(a) The 24k Chebyshev fixture, padded for the halo path, on 4 ranks:
every level's A, U and U^T through ``halo_matvec``, for a 1-D and an
(n, 3) x, equal the port's unsharded products at 1e-12 of their largest
entry, and one ``halo_v_cycle`` equals the port's ``v_cycle`` on the
same ELL forms at 1e-12.

(b) The entry fixture (2,562 rows, Jacobi) on 2 and 4 ranks against the
JAX package's ``halo_v_cycle`` and ``halo_solve`` on ``make_mesh`` of
the same size: the cycle at 1e-9 of its largest entry; MG-PCG and
MG-FCG take JAX's iteration counts, their x at 1e-9 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gravomg_tpu import MultigridConfig as JaxConfig
from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.parallel import halo as jhalo
from gravomg_tpu.parallel import sharding as jshard

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.prolong.operator import prolong, restrict_gather

import test_torch_dist_ranks as ranks

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")


def _f64_copy(name, tmp_path):
    """The fixture with every float array in f64, for both packages."""
    with np.load(os.path.join(ASSETS, name)) as z:
        arrays = {k: (z[k].astype(np.float64) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    path = str(tmp_path / name)
    np.savez(path, **arrays)
    return path


def _close(got, want, rtol):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=rtol * scale)


def test_halo_products_and_cycle_match_unsharded(tmp_path):
    nd = 4
    path = _f64_copy("halo_hierarchy.npz", tmp_path)
    cfg = gt.MultigridConfig(smoother="chebyshev")
    hp = gt.pad_solver_levels(gt.load_solver(path, device="cpu"), nd,
                              pad_coarse=True)
    rng = np.random.default_rng(11)
    inputs, wants = [], []
    for lvl in hp.levels:
        xs, want = {}, {}
        sizes = {"A": lvl.op.num_vertices}
        if lvl.u is not None:
            sizes.update(U=lvl.u.n_coarse, Ut=lvl.ut.n_fine)
        for name, n in sizes.items():
            xs[name] = [rng.normal(size=n), rng.normal(size=(n, 3))]
            fn = {"A": lambda x, l=lvl: gt.spmv(l.op, x),
                  "U": lambda x, l=lvl: prolong(l.u, x),
                  "Ut": lambda x, l=lvl: restrict_gather(l.ut, x)}[name]
            want[name] = [fn(torch.as_tensor(x)) for x in xs[name]]
        inputs.append(xs)
        wants.append(want)
    b = np.zeros(hp.levels[0].op.num_vertices)
    b[:24000] = rng.normal(size=24000)
    res = gt.run_ranks(ranks.halo_products, nd, "gloo", "cpu",
                       (path, inputs, b, cfg), timeout_s=240)
    for li, want in enumerate(wants):
        for name, ws in want.items():
            for i, w in enumerate(ws):
                got = torch.cat([r["products"][li][name][i] for r in res])
                assert got.shape == w.shape
                _close(got, w, 1e-12)
    bt = torch.as_tensor(b)
    x = torch.cat([r["cycle"] for r in res])
    _close(x, gt.v_cycle(hp, torch.zeros_like(bt), bt, cfg), 1e-12)
    # Every rank holds the same plans: the fine level's cut is small.
    assert len({tuple(r["halo_frac"]) for r in res}) == 1
    assert res[0]["halo_frac"][0] < 0.25


def test_halo_cycle_and_solves_match_jax(tmp_path):
    path = _f64_copy("entry_hierarchy.npz", tmp_path)
    cfg, jcfg = gt.MultigridConfig(smoother="jacobi"), JaxConfig(
        smoother="jacobi")
    hj = jax_load_solver(path)
    b = np.random.default_rng(12).normal(size=2562)
    for nd in (2, 4):
        mesh = jshard.make_mesh(nd)
        hh = jhalo.halo_shard_solver(
            jshard.pad_solver_levels(hj, nd, pad_coarse=True), mesh)
        bp = jnp.zeros((hh.levels[0].op.n_rows,)).at[:2562].set(b)
        cycle = jax.jit(lambda hs, r: jhalo.halo_v_cycle(
            hs, jnp.zeros_like(r), r, jcfg, mesh, x0_zero=True))
        want_cycle = torch.as_tensor(np.array(cycle(hh, bp)))
        res = gt.run_ranks(ranks.halo_runs, nd, "gloo", "cpu",
                           (path, b, cfg), timeout_s=240)
        _close(torch.cat([r["cycle"] for r in res]), want_cycle, 1e-9)
        for method in ("mg_pcg", "mg_fcg"):
            xj, relj, itj = jhalo.halo_solve(hh, jnp.asarray(b), jcfg, mesh,
                                             method=method)
            xj = torch.as_tensor(np.array(xj))
            assert {r[method][2] for r in res} == {int(itj)}, method
            assert {r[method][1] for r in res} == {res[0][method][1]}
            assert res[0][method][1] <= cfg.tolerance
            x = torch.cat([r[method][0] for r in res])
            assert x.shape == (2562,)
            assert float((x - xj).norm() / xj.norm()) <= 1e-9, method
    jax.clear_caches()
