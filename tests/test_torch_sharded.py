"""The all-gather vertex sharding (``parallel/sharding.py``) on gloo
ranks spawned on the CPU (``run_ranks``; the rank bodies are in
tests/test_torch_dist_ranks.py), in f64 on the entry fixture (2,562
rows, Jacobi).

(a) On 2 and 4 ranks against the JAX package on ``make_mesh`` of the
same size: ``sharded_solve`` by MG-PCG and MG-FCG takes JAX's iteration
counts, its x at 1e-9 relative; one ``vertex_sharded_cg_step`` equals
JAX's at 1e-12 of each output's largest entry; ``batched_vcycle`` of 4
right-hand sides equals JAX's at 1e-9.

(b) Uniform block-dense forms attached after padding, with 8 blocks a
level split over the ranks by ``shard_fast_operator``: the forms hold
only this rank's rows and escape entries (their counts add up to the
whole form's), their product equals the whole form's rows, and the
sharded solve converges within 2 iterations of the ELL one, as
tests/test_sharded_solve.py holds JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gravomg_tpu import MultigridConfig as JaxConfig
from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.parallel import sharding as jshard

import gravomg_tpu_torch as gt

import test_torch_dist_ranks as ranks

torch.set_num_threads(2)

ENTRY = os.path.join(os.path.dirname(__file__), "..", "assets",
                     "entry_hierarchy.npz")


def _f64_entry(tmp_path):
    with np.load(ENTRY) as z:
        arrays = {k: (z[k].astype(np.float64) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    path = str(tmp_path / "entry64.npz")
    np.savez(path, **arrays)
    return path


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rtol * float(want.abs().max()))


def test_sharded_solves_step_and_batch_match_jax(tmp_path):
    path = _f64_entry(tmp_path)
    cfg, jcfg = gt.MultigridConfig(smoother="jacobi"), JaxConfig(
        smoother="jacobi")
    hj = jax_load_solver(path)
    rng = np.random.default_rng(21)
    b = rng.normal(size=2562)
    xs, bs = rng.normal(size=(4, 2562)), rng.normal(size=(4, 2562))
    for nd in (2, 4):
        mesh = jshard.make_mesh(nd)
        hpj = jshard.pad_solver_levels(hj, nd)
        vp = hpj.levels[0].op.num_vertices
        step_in = tuple(rng.normal(size=vp) for _ in range(3)) + (
            np.float64(1.7),)
        res = gt.run_ranks(ranks.sharded_runs, nd, "gloo", "cpu",
                           (path, b, step_in, xs, bs, cfg), timeout_s=240)
        hsj = jshard.shard_solver(hpj, mesh)
        for method in ("mg_pcg", "mg_fcg"):
            xj, _, itj = jshard.sharded_solve(hsj, jnp.asarray(b), jcfg,
                                              mesh, method=method)
            assert {r[method][2] for r in res} == {int(itj)}, method
            assert res[0][method][1] <= cfg.tolerance
            x, xj = torch.cat([r[method][0] for r in res]), _t(xj)
            assert x.shape == (2562,)
            assert float((x - xj).norm() / xj.norm()) <= 1e-9, method
        step = jshard.vertex_sharded_cg_step(hpj, jcfg, mesh)
        want = step(*(jnp.asarray(a) for a in step_in))
        for i in range(3):
            _close(torch.cat([r["step"][i] for r in res]), _t(want[i]),
                   1e-12)
        for r in res:
            _close(r["step"][3], _t(want[3]), 1e-12)
        batched = jshard.batched_vcycle(hj, jcfg, mesh)
        want = _t(batched(jnp.asarray(xs), jnp.asarray(bs)))
        got = torch.cat([r["batched"] for r in res])
        assert got.shape == (4, 2562)
        _close(got, want, 1e-9)
    jax.clear_caches()


def test_sharded_uniform_forms():
    cfg = gt.MultigridConfig(smoother="jacobi")
    b = np.random.default_rng(22).normal(size=2562)
    for nd in (2, 4):
        res = gt.run_ranks(ranks.sharded_fast_runs, nd, "gloo", "cpu",
                           (ENTRY, b, cfg), timeout_s=240)
        rows = -(-2562 // (8 * nd)) * 8 * nd
        for r in res:
            # A's and U's forms hold a rank's rows; U^T's 704 coarse rows
            # in blocks of 64 do not split into 8 blocks, so it stays
            # whole, as JAX replicates it.
            assert r["rows"] == [rows // nd, rows // nd, 704]
            assert torch.equal(r["A"][0], r["A"][1])
            _, rel_ell, it_ell = r["ell"]
            _, rel, it = r["fast"]
            assert rel <= cfg.tolerance and rel_ell <= cfg.tolerance
            assert abs(it - it_ell) <= 2
        whole = {r["escapes"][1] for r in res}
        assert len(whole) == 1
        assert sum(r["escapes"][0] for r in res) == whole.pop() > 0
