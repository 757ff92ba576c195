"""Lowest Laplace eigenpairs by block LOBPCG preconditioned with one
multigrid V-cycle (counterpart of ``gravomg_tpu/apps/spectral.py``).

Solves L v = lam M v (L the graph Laplacian, M the lumped mass, diagonal)
for the k smallest pairs.  Each step preconditions the whole residual
block with one V-cycle on a (V, k) right-hand side (the ELL path), forms
the search block S = [X, W, P], and solves the Rayleigh-Ritz problem of
S in f64: the Grams are accumulated in f64 on the block's device, and the
small m x m pencil (m <= 3k) is solved on the host, where the loop
already waits every iteration for its stopping test.

Degenerate directions of S (it becomes nearly M-rank-deficient as pairs
converge) are whitened with the Gram's eigendecomposition and pinned to
a huge Ritz value, so the k-smallest selection never picks them; W and P
are made M-orthogonal to X before they enter S.

On the card a step's device work, some 750 launches (most of them the
V-cycle's), runs as three CUDA graphs between the host's reads of the
two whitening Grams and of the Rayleigh-Ritz pencil, and a fourth for
the Ritz rotation: each is captured at its second use in a call and
replayed from then on, so the host's speed no longer paces the step.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Union

import numpy as np
import torch

# spectral_alpha lives beside the shift modes of the Poisson operator and
# is re-exported here, where the eigensolver's callers look for it.
from gravomg_tpu_torch.apps.poisson import poisson_hierarchy, spectral_alpha
from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.hierarchy import Hierarchy
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.solve.vcycle import SolverHierarchy, v_cycle
from gravomg_tpu_torch.types import EllOperator, Graph
from gravomg_tpu_torch.utils.profiling import span, stage

# Pinned Ritz value of a degenerate search direction: far above any
# Laplacian eigenvalue, far below f32 overflow.
_DEGENERATE = 1e12
# Relative Gram eigenvalue below which a direction counts as degenerate.
_RANK_TOL = 1e-6
# This thread's stream and graph pools on the card (:func:`_side_stream`,
# :func:`_graph_pool`).
_LOCAL = threading.local()


def _whitening(g: torch.Tensor, counts: Optional[dict] = None
               ) -> torch.Tensor:
    """The k x k transform that whitens the float64 Gram ``g``:
    eigenvectors over the square roots of their eigenvalues, symmetrised
    first; near-null directions (below ``_RANK_TOL`` of the largest) get
    a unit scale.  Where the device's ``eigh`` fails to converge on the
    Gram, LAPACK's on the host takes over (counted in
    ``counts["orth_fallbacks"]``)."""
    g = 0.5 * (g + g.T)
    try:
        d, q = torch.linalg.eigh(g)
    except torch.linalg.LinAlgError:
        d, q = (t.to(g.device) for t in torch.linalg.eigh(g.cpu()))
        if counts is not None:
            counts["orth_fallbacks"] += 1
    dsafe = torch.where(d > _RANK_TOL * torch.max(d), d, torch.ones_like(d))
    return q * torch.rsqrt(dsafe)


def _gram(mass: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """V^T M V, summed over V rows in float64."""
    v64 = v.double()
    return v64.T @ (mass.double()[:, None] * v64)


def _b_orthonormalize(mass: torch.Tensor, v: torch.Tensor,
                      counts: Optional[dict] = None) -> torch.Tensor:
    """An M-orthonormal basis of span(v), whitened by the Gram's
    eigendecomposition (:func:`_whitening`); near-null directions get a
    unit scale (harmless near-zero columns).  The Gram sums over V rows
    in float64, as the Rayleigh-Ritz Grams do: an f32 Gram of a nearly
    rank-deficient block can defeat f32 ``eigh`` on the card.  Column
    order is not kept: for the W and P blocks only, never for the Ritz
    block X."""
    with span("lobpcg.orth"):
        return v @ _whitening(_gram(mass, v), counts).to(v.dtype)


def _project_out(mass: torch.Tensor, basis: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """v without its M-projection onto ``basis`` (M-orthonormal)."""
    return v - basis @ (basis.T @ (mass[:, None] * v))


def _rayleigh_ritz_host(ga: torch.Tensor, gb: torch.Tensor, k: int,
                        counts: Optional[dict] = None):
    """The k smallest eigenpairs of the pencil (ga, gb), gb PSD, in f64
    on the host; returns (theta (k,), vectors (m, k)) as f64 CPU tensors.

    The pencil's eigenvalue error is about eps * lam_max of the pencil
    (1e5-1e6 at 100k vertices), so an f32 solve would move the low Ritz
    values by O(0.1-1).  Directions with a Gram eigenvalue under
    ``_RANK_TOL`` of the largest are pinned to ``_DEGENERATE`` (counted
    in ``counts["rr_pinned"]``).  The 3k x 3k solve runs in numpy, whose
    LAPACK takes one thread at this size; torch's CPU ``eigh`` would
    wake its pool of intra-op threads, which costs more than the solve
    and keeps spinning on the cores of the thread that launches the next
    step's device work."""
    ga = ga.detach().cpu().double().numpy()
    gb = gb.detach().cpu().double().numpy()
    d, q = np.linalg.eigh(gb)
    good = d > _RANK_TOL * d.max()
    if counts is not None:
        counts["rr_pinned"] += int((~good).sum())
    wh = q / np.sqrt(np.where(good, d, 1.0))
    c = (wh.T @ ga @ wh) * np.outer(good, good)
    c += np.diag(np.where(good, 0.0, _DEGENERATE))
    theta, y = np.linalg.eigh(c)
    return (torch.from_numpy(np.ascontiguousarray(theta[:k])),
            torch.from_numpy(np.ascontiguousarray((wh @ y)[:, :k])))


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    """This thread's stream for the iteration on ``dev``: CUDA graphs
    capture only off the default stream, and the allocator caches freed
    blocks by stream, so one stream a thread keeps its cache to one
    call's working set."""
    streams = _LOCAL.__dict__.setdefault("streams", {})
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(dev)
    return streams[dev]


def _graph_pool(dev: torch.device, role: str) -> dict:
    """This thread's memory pool for the graphs of ``role`` on ``dev``:
    ``{"pool": its handle, "graph": the graph captured into it last}``.
    Each call's graph of a role captures into the same pool, which the
    last one keeps alive, so the pool holds one call's working set; a
    graph's own pool would stay reserved, out of the allocator's reach,
    until its cache is emptied.  One pool a role: a graph replayed later
    in a step could otherwise overwrite the outputs of one captured
    after it."""
    pools = _LOCAL.__dict__.setdefault("pools", {})
    if (dev, role) not in pools:
        pools[dev, role] = {"pool": torch.cuda.graph_pool_handle()}
    return pools[dev, role]


class _Replayed:
    """``fn`` (CUDA tensors in, a tuple of CUDA tensors out, no host
    read inside) replayed as a CUDA graph.  For each signature (the
    arguments' shapes and dtypes) the first call runs ``fn`` as it is,
    which loads and sets up what it launches; the second captures it on
    the current stream, which must not be the default one, from copies
    of its arguments, into the pool of ``role`` (:func:`_graph_pool`),
    and replays it; every later call copies its arguments into the
    captured ones and replays.  A replay launches the same kernels as
    ``fn`` in the same order, so it computes the same numbers; its
    outputs are the captured tensors, which the next replay overwrites,
    and its kernels pass through no Python wrapper (launch counters of
    the wrappers count the first two calls only).  Off the card, ``fn``
    runs as it is."""

    def __init__(self, fn, role: str):
        self.fn, self.role, self.graphs = fn, role, {}

    def __call__(self, *args):
        if not args[0].is_cuda:
            return self.fn(*args)
        key = tuple((a.shape, a.dtype) for a in args)
        if key not in self.graphs:
            self.graphs[key] = None
            return self.fn(*args)
        entry = self.graphs[key]
        if entry is None:
            pool = _graph_pool(args[0].device, self.role)
            ins = tuple(a.clone() for a in args)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool["pool"],
                                capture_error_mode="thread_local")
            try:
                outs = self.fn(*ins)
            finally:
                graph.capture_end()
            pool["graph"] = graph
            entry = self.graphs[key] = (graph, ins, outs)
        else:
            for dst, a in zip(entry[1], args):
                dst.copy_(a)
        entry[0].replay()
        return entry[2]


def _precondition(hs: SolverHierarchy, lap: EllOperator, mass: torch.Tensor,
                  cfg: MultigridConfig, x: torch.Tensor):
    """X's residual norms, its V-cycle W made M-orthogonal to X, and W's
    Gram: (resnorm, w, gram).

    The Rayleigh quotients and the Grams sum over V rows in f64: in f32
    their rounding (about 1e-6 * ||L|| * sqrt(V)) floors the block
    residual near 5e-2 at 20k vertices."""
    ax = spmv(lap, x)
    lam = torch.sum(x.double() * ax.double(), dim=0).to(x.dtype)
    r = ax - (mass[:, None] * x) * lam[None, :]
    # Relative to the largest Ritz value: the nullspace pair has lam ~ 0.
    resnorm = torch.linalg.norm(r, dim=0) / torch.clamp(
        torch.max(torch.abs(lam)), min=1e-12)
    w = v_cycle(hs, torch.zeros_like(r), r, cfg, x0_zero=True)
    w = _project_out(mass, x, w)
    return resnorm, w, _gram(mass, w)


def _add_p(mass: torch.Tensor, x: torch.Tensor, p: torch.Tensor,
           w: torch.Tensor, tw: torch.Tensor):
    """W whitened by ``tw``, P made M-orthogonal to X and W, and P's
    Gram: (w, p, gram)."""
    w = w @ tw.to(w.dtype)
    pb = _project_out(mass, x, p)
    pb = pb - w @ (w.T @ (mass[:, None] * pb))
    return w, pb, _gram(mass, pb)


def _search(lap: EllOperator, mass: torch.Tensor, *blocks: torch.Tensor):
    """The search block S = [blocks..., v @ t] for ``blocks`` ending in
    (v, t), t v's whitening, and S's f64 Grams: (s, S^T L S, S^T M S)."""
    *head, v, t = blocks
    s = torch.cat([*head, v @ t.to(v.dtype)], dim=1)
    as_ = spmv(lap, s)
    s64 = s.double()
    ga = s64.T @ as_.double()
    gb = s64.T @ (mass.double()[:, None] * s64)
    return s, ga, gb


class _Block:
    """The device half of one step: the three stretches between the
    host's reads (:func:`_precondition`, :func:`_add_p` and
    :func:`_search`, each :class:`_Replayed`) and the two whitenings
    (:func:`_whitening`) that read a Gram back.  ``counts`` as
    :func:`_whitening` takes it."""

    def __init__(self, hs: SolverHierarchy, lap: EllOperator,
                 mass: torch.Tensor, cfg: MultigridConfig,
                 counts: Optional[dict] = None):
        self.counts = counts
        self.precondition = _Replayed(
            functools.partial(_precondition, hs, lap, mass, cfg),
            "precondition")
        self.add_p = _Replayed(functools.partial(_add_p, mass), "add_p")
        self.search = _Replayed(functools.partial(_search, lap, mass),
                                "search")

    def whiten(self, g: torch.Tensor) -> torch.Tensor:
        with span("lobpcg.orth"):
            return _whitening(g, self.counts)

    def __call__(self, x: torch.Tensor, p: torch.Tensor, use_p: bool):
        resnorm, w, gw = self.precondition(x)
        tw = self.whiten(gw)
        if use_p:
            w, pb, gp = self.add_p(x, p, w, tw)
            s, ga, gb = self.search(x, w, pb, self.whiten(gp))
        else:
            s, ga, gb = self.search(x, w, tw)
        return s, ga, gb, resnorm


def _lobpcg_block(hs: SolverHierarchy, lap: EllOperator, mass: torch.Tensor,
                  x: torch.Tensor, p: torch.Tensor, cfg: MultigridConfig,
                  use_p: bool, counts: Optional[dict] = None):
    """The device half of one step, run once as it is: residual, V-cycle
    preconditioner, search block S = [X, W, (P)] with W and P
    M-orthonormalised as :func:`_b_orthonormalize` does, and S's Grams
    in f64.  Returns (s, ga, gb, resnorm); ``counts`` as
    :func:`_b_orthonormalize` takes it."""
    return _Block(hs, lap, mass, cfg, counts)(x, p, use_p)


def _lobpcg_update(s: torch.Tensor, y: torch.Tensor, k: int):
    """The Ritz rotation: X = S y (gb-orthonormal already; orthonormalising
    again would scramble the column-eigenvalue order) and P = the W and P
    part of it (the three-term recurrence drops X's)."""
    y_tail = y.clone()
    y_tail[:k] = 0.0
    return s @ y, s @ y_tail


def _lobpcg_step(block: _Block, update: _Replayed, x: torch.Tensor,
                 p: torch.Tensor, k: int, use_p: bool,
                 record: Optional[dict] = None):
    """One preconditioned Rayleigh-Ritz step on [X, W, (P)]; x (V, k)
    M-orthonormal, p (V, k) the previous step; ``update`` replays
    :func:`_lobpcg_update`.  Returns (x_new, p_new, Ritz values,
    residual norms), all of x's dtype.  ``record`` (a dict) receives the
    seconds of the device block (``block_s``) and of the Rayleigh-Ritz
    solve with its transfers (``rr_s``); the block's ``counts`` the host
    fallbacks of the orthonormalisations (``orth_fallbacks``) and the
    directions the Rayleigh-Ritz solve pinned (``rr_pinned``)."""
    dev = x.device
    with stage(record, "block_s", dev):
        s, ga, gb, resnorm = block(x, p, use_p)
    with stage(record, "rr_s", dev):
        theta, y = _rayleigh_ritz_host(ga, gb, k, block.counts)
        y = y.to(device=dev, dtype=s.dtype)
    x_new, p_new = update(s, y)
    return x_new, p_new, theta.to(device=dev, dtype=x.dtype), resnorm


def laplace_eigs(graph: Graph, k: int = 8,
                 cfg: MultigridConfig = MultigridConfig(),
                 h: Optional[Union[Hierarchy, SolverHierarchy]] = None,
                 alpha="spectral", weighting: str = "invdist",
                 iters: int = 40, tol: float = 1e-5, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 record: Optional[dict] = None):
    """The k smallest eigenpairs of (L, M) on a kNN graph, on the
    graph's device.  Returns (eigenvalues (k,), M-orthonormal
    eigenvectors (V, k), residual norms (k,)); the first pair is the
    nullspace (lam ~ 0, constants).

    The preconditioner is the hierarchy of L + alpha M: ``h`` (a
    :class:`Hierarchy` or :class:`SolverHierarchy`), else one built by
    :func:`poisson_hierarchy` with ``alpha`` ("spectral":
    :func:`spectral_alpha`).  The start block is standard normal from
    ``generator`` (a CPU generator seeded with ``seed`` if None), with
    column 0 set to ones.  Stops when every residual norm
    ||L v - lam M v|| / lam_max is below ``tol`` or after ``iters``
    steps.  ``record`` (a dict) receives ``iters``, ``orth_fallbacks``
    (orthonormalisations whose Gram the host's LAPACK decomposed after
    the device's ``eigh`` failed), ``rr_pinned`` (degenerate directions
    the Rayleigh-Ritz solves pinned, summed over the steps) and, per
    step, the seconds of the device block and of the Rayleigh-Ritz
    solve.  Spans: ``laplace_eigs``, ``lobpcg.step``, ``lobpcg.orth``,
    ``block_s`` and ``rr_s`` (the spans inside a step's device work,
    such as the cycle's, open only in the steps that do not replay it).
    On the card the iteration runs on a stream of its own, which the
    caller's current stream waits for on return."""
    with span("laplace_eigs"):
        lap, mass = graph_laplacian(graph, weighting)
        if h is None:
            h = poisson_hierarchy(graph, alpha=alpha, cfg=cfg,
                                  lap_mass=(lap, mass))
        solver = h.solver if isinstance(h, Hierarchy) else h
        dev = lap.diag.device
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        if dev.type != "cuda":
            return _lobpcg(solver, lap, mass, cfg, k, iters, tol, generator,
                           record)
        caller, side = torch.cuda.current_stream(dev), _side_stream(dev)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            out = _lobpcg(solver, lap, mass, cfg, k, iters, tol, generator,
                          record)
        caller.wait_stream(side)
        for t in out:
            t.record_stream(caller)
        return out


def _lobpcg(hs: SolverHierarchy, lap: EllOperator, mass: torch.Tensor,
            cfg: MultigridConfig, k: int, iters: int, tol: float,
            generator: torch.Generator, record: Optional[dict]):
    """:func:`laplace_eigs`' iteration on the current stream, from a
    start block drawn from ``generator``: (theta, x, resnorm).  Each
    stretch of a step's device work is a :class:`_Replayed`, so on the
    card the steps from the third on replay CUDA graphs and their
    launches cost the host one call a stretch."""
    dev, dtype = lap.diag.device, lap.diag.dtype
    x = torch.randn((lap.num_vertices, k), generator=generator,
                    dtype=dtype, device=generator.device).to(dev)
    x[:, 0] = 1.0                              # the nullspace direction
    counts = {"orth_fallbacks": 0, "rr_pinned": 0}
    x = _b_orthonormalize(mass, x, counts)
    p = torch.zeros_like(x)
    theta = torch.zeros((k,), dtype=dtype, device=dev)
    block = _Block(hs, lap, mass, cfg, counts)
    update = _Replayed(functools.partial(_lobpcg_update, k=k), "update")
    it = 0
    while it < iters:
        rec = None if record is None else {}
        with span("lobpcg.step"):
            x, p, theta, resnorm = _lobpcg_step(block, update, x, p, k,
                                                it > 0, rec)
            it += 1
            done = bool(torch.max(resnorm) < tol)
        if record is not None:
            record.setdefault("steps", []).append(rec)
        if done:
            break
    if record is not None:
        record["iters"] = it
        record.update(counts)
    # The in-step residual is that of the block the step started from;
    # recompute it for the returned pairs.  x leaves the graphs' memory.
    x = x.clone()
    r = spmv(lap, x) - (mass[:, None] * x) * theta[None, :]
    resnorm = torch.linalg.norm(r, dim=0) / torch.clamp(
        torch.max(torch.abs(theta)), min=1e-12)
    return theta, x, resnorm
