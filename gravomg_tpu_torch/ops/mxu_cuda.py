"""The transposed-tile SpMV kernel (``csrc/mxu_matvec.cu``): its work
table, its wrappers, its plain torch twins and the dispatch between them.

The kernel replaces the TPU kernel ``_mxu_kernel`` of
``gravomg_tpu/ops/pallas_blockdense.py`` (launched by
``mxu_matvec_pallas``).  For one bucket of a transposed-tile slab form
(``slab_from_ell(..., mxu=True)``), with ``m`` of shape
(NBLK, NSEG, 128, 128) and window starts ``win_start`` (NBLK, NSEG),

    y[b*128 + r] = sum_s sum_l rnd(xpad[win_start[b, s] + l]) * m[b, s, l, r]

where rnd rounds x to m's dtype, as the Pallas kernel and the JAX
package's XLA path (``_mxu_bucket_matvec_xla``) both do, and the sum is
taken in f32.

On the card one launch applies all buckets of a slab form.  It reads the
buckets' arrays where they lie and is steered by an :class:`MxuPlan`, a
small table of work items built once per form (:func:`mxu_plan`): per
item a bucket, a block, a range of segments and the original block its
128 sums belong to, so y comes out in row order.  Blocks of more than
``MXU_SPLIT`` segments are cut into several items; their sums meet in a
scratch buffer and are added in part order (no float atomics: two runs
give bitwise the same y).  :func:`mxu_slab_matvec_plain` walks the same
table in torch; :func:`mxu_matvec_plain` is the per-bucket twin.

:func:`mxu_slab_matvec_fast` dispatches on the device of x: a CUDA
tensor goes to :func:`mxu_slab_matvec_cuda`, which launches the kernel
or raises; a CPU tensor goes to :func:`mxu_slab_matvec_plain`.  The
escape chute is added here in torch, as ``slab_matvec``'s caller does in
the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              add_escape, pad_x,
                                              padded_length, slab_escape)
from gravomg_tpu_torch.utils.build import CudaLibrary

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
LIBRARY = CudaLibrary("mxu_matvec.cu", {"gmg_mxu_slab_matvec_f32": _ARGS,
                                        "gmg_mxu_slab_matvec_bf16": _ARGS})
MAX_BUCKETS = 12            # base pointers the kernel takes
MXU_SPLIT = 4               # segments (128x128 tiles) of one work item


class MxuPlan(NamedTuple):
    """The work items of one launch over the buckets of a form.

    items:  (NI, 4) int32, longest first: bucket, block within the
      bucket, ``s0 | s1 << 16`` (the item's segments [s0, s1)) and the
      destination: d >= 0 is the output block (y[d*128 : d*128 + 128]);
      d < 0 is scratch row ``-d - 1``, for an item of a cut block.
    splits: (NS, 4) int32, one row per cut block: output block, first
      scratch row, number of parts (its rows are consecutive, in part
      order), 0.
    shapes: ((NBLK, NSEG) per bucket) the plan was built for.
    n_out:  output blocks; n_slots: scratch rows.
    """

    items: torch.Tensor
    splits: torch.Tensor
    shapes: Tuple[Tuple[int, int], ...]
    n_out: int
    n_slots: int


def mxu_plan(shapes: Sequence[Tuple[int, int]],
             out_blocks: Sequence[np.ndarray], device) -> MxuPlan:
    """Work items for buckets of ``shapes`` (NBLK, NSEG).  ``out_blocks``
    gives, per bucket, each block's output block (distinct, covering
    0..n_out-1), or -1 for a padding block, which gets no item; a
    bucket's real blocks come first."""
    if not 0 < len(shapes) <= MAX_BUCKETS:
        raise ValueError(f"the kernel takes 1 to {MAX_BUCKETS} buckets, got "
                         f"{len(shapes)}")
    rows, split_rows = [], []
    slot = 0
    for k, ((nblk, nseg), out) in enumerate(zip(shapes, out_blocks)):
        out = np.asarray(out, np.int64)
        n = int((out >= 0).sum())
        if out.shape != (nblk,) or (out[:n] < 0).any() or nseg < 1:
            raise ValueError("out_blocks must hold one entry per block, "
                             "real blocks first")
        if n == 0:
            continue
        parts = -(-nseg // MXU_SPLIT)
        cuts = [(p * nseg) // parts for p in range(parts + 1)]
        for p in range(parts):
            if parts == 1:
                dst = out[:n]
            else:
                dst = -(slot + np.arange(n) * parts + p) - 1
            rows.append(np.stack([np.full(n, k), np.arange(n),
                                  np.full(n, cuts[p]),
                                  np.full(n, cuts[p + 1]), dst], axis=1))
        if parts > 1:
            split_rows.append(np.stack(
                [out[:n], slot + np.arange(n) * parts, np.full(n, parts),
                 np.zeros(n, np.int64)], axis=1))
            slot += n * parts
    table = np.concatenate(rows)
    # Longest first.  The sort is stable, so the items of one bucket and
    # part (equal lengths, made together) stay consecutive, blocks
    # ascending: the plain walk applies such a run with one product.
    table = table[np.argsort(-(table[:, 3] - table[:, 2]), kind="stable")]
    outs = np.concatenate([np.asarray(o)[np.asarray(o) >= 0]
                           for o in out_blocks])
    n_out = len(outs)
    if not np.array_equal(np.sort(outs), np.arange(n_out)):
        raise ValueError("out_blocks must cover 0..n_out-1 exactly once")
    items = np.stack([table[:, 0], table[:, 1],
                      table[:, 2] | (table[:, 3] << 16), table[:, 4]],
                     axis=1).astype(np.int32)
    splits = (np.concatenate(split_rows) if split_rows
              else np.zeros((0, 4), np.int64)).astype(np.int32)
    return MxuPlan(items=torch.as_tensor(items, device=device),
                   splits=torch.as_tensor(splits, device=device),
                   shapes=tuple((int(a), int(b)) for a, b in shapes),
                   n_out=n_out, n_slots=slot)


def bucket_plan(op: BlockDenseOperator) -> MxuPlan:
    """The plan of one bucket alone: every block, padding included, in
    the bucket's own order."""
    nblk, nseg = op.win_start.shape
    return mxu_plan([(nblk, nseg)], [np.arange(nblk)], op.m.device)


def plan_table(plan: MxuPlan) -> np.ndarray:
    """The item table on the host, unpacked: (NI, 5) int64 columns
    bucket, block, s0, s1, destination."""
    t = plan.items.cpu().numpy().astype(np.int64)
    return np.stack([t[:, 0], t[:, 1], t[:, 2] & 0xffff, t[:, 2] >> 16,
                     t[:, 3]], axis=1)


def plan_bytes(buckets: Sequence[BlockDenseOperator], plan: MxuPlan) -> dict:
    """Bytes one launch by ``plan`` moves, by part: ``tiles`` (the tiles
    of m its items name; a padding block has no item and is not read),
    ``win_start`` (one entry per such tile), ``tables`` (the item and
    split tables), ``x`` (padded x, once), ``y`` (written once) and
    ``scratch`` (the rows of cut blocks, written and read back).
    ``io`` sums all but the scratch rows: every input once, the output
    once."""
    t = plan_table(plan)
    n_tiles = int((t[:, 3] - t[:, 2]).sum())
    b0 = buckets[0]
    out = {"tiles": n_tiles * 128 * 128 * b0.m.element_size(),
           "win_start": n_tiles * 4,
           "tables": 16 * (plan.items.shape[0] + plan.splits.shape[0]),
           "x": 4 * padded_length(b0, b0.n_cols),
           "y": plan.n_out * 128 * 4,
           "scratch": 2 * plan.n_slots * 128 * 4}
    out["io"] = sum(v for k, v in out.items() if k != "scratch")
    return out


def _check_tile_op(op: BlockDenseOperator) -> None:
    if (op.m.ndim != 4 or tuple(op.m.shape[2:]) != (128, 128)
            or op.block != 128 or op.align != 128 or op.window != 128
            or op.window0 != 128 or op.diag is not None):
        raise ValueError("the transposed-tile kernel takes a bucket of "
                         "slab_from_ell(..., mxu=True): m (NBLK, NSEG, 128, "
                         "128), 128-aligned windows, no diagonal")


def _check_plan(buckets: Sequence[BlockDenseOperator], plan: MxuPlan) -> None:
    shapes = tuple(tuple(b.win_start.shape) for b in buckets)
    if shapes != plan.shapes:
        raise ValueError(f"the work table was built for buckets of shapes "
                         f"{plan.shapes}, not {shapes}")


def _tiles_plain(buckets: Sequence[BlockDenseOperator], plan: MxuPlan,
                 xp: torch.Tensor) -> torch.Tensor:
    """(n_out*128,): the kernel's sums, by the same items, the same
    segment ranges and the same order of combination."""
    for b in buckets:
        _check_tile_op(b)
    _check_plan(buckets, plan)
    if xp.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("the plain twin needs full-f32 matrix products: "
                         "set torch.backends.cuda.matmul.allow_tf32 = False")
    x2 = xp.view(-1, 128)
    dev = xp.device
    acc = torch.promote_types(buckets[0].m.dtype, torch.float32)
    part = torch.empty((plan.items.shape[0], 128), dtype=acc, device=dev)
    # Runs of items on consecutive blocks of one bucket and one segment
    # range: one product each.
    t = plan_table(plan)
    same = ((t[1:, [0, 2, 3]] == t[:-1, [0, 2, 3]]).all(axis=1)
            & (t[1:, 1] == t[:-1, 1] + 1))
    bounds = np.concatenate([[0], np.flatnonzero(~same) + 1, [len(t)]])
    for start, end in zip(bounds[:-1], bounds[1:]):
        k, b0, s0, s1, _ = (int(v) for v in t[start])
        b, n = buckets[k], int(end - start)
        rows = (s1 - s0) * 128
        wins = x2[b.win_start[b0:b0 + n, s0:s1].long() // 128]
        wins = wins.to(b.m.dtype).to(acc).reshape(n, 1, rows)
        tiles = b.m[b0:b0 + n, s0:s1].reshape(n, rows, 128).to(acc)
        part[start:end] = torch.bmm(wins, tiles).reshape(n, 128)
    dst = plan.items[:, 3].long()
    y = torch.empty((plan.n_out, 128), dtype=acc, device=dev)
    direct = dst >= 0
    y[dst[direct]] = part[direct]
    if plan.n_slots:
        scratch = torch.empty((plan.n_slots, 128), dtype=acc, device=dev)
        scratch[-dst[~direct] - 1] = part[~direct]
        out, first, parts = (plan.splits[:, c].long() for c in range(3))
        acc_y = scratch[first]
        max_parts = max(-(-nseg // MXU_SPLIT) for _, nseg in plan.shapes)
        for p in range(1, max_parts):
            more = (parts > p)[:, None]
            rows_p = torch.clamp(first + p, max=plan.n_slots - 1)
            acc_y = torch.where(more, acc_y + scratch[rows_p], acc_y)
        y[out] = acc_y
    return y.reshape(-1)


def _tiles_cuda(buckets: Sequence[BlockDenseOperator], plan: MxuPlan,
                x: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """(n_out*128,) f32 from one launch of the kernel.  Raises on
    anything it does not take; launches on the current stream and counts
    the launch in ``mxu_matvec_cuda.launches``."""
    dev = x.device
    dtype = buckets[0].m.dtype
    if not x.is_cuda:
        raise ValueError("the transposed-tile kernel needs CUDA tensors")
    if x.dtype != torch.float32 or x.ndim != 1:
        raise ValueError(f"x must be 1-D float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"m must be float32 or bfloat16, got {dtype}")
    _check_plan(buckets, plan)
    for b in buckets:
        _check_tile_op(b)
        m, ws = b.m, b.win_start
        if x.shape[0] != b.n_cols:
            raise ValueError(f"x must have length n_cols={b.n_cols}, got "
                             f"{x.shape[0]}")
        if m.dtype != dtype:
            raise ValueError("the buckets' m must share one dtype")
        if ws.dtype != torch.int32 or tuple(ws.shape) != tuple(m.shape[:2]):
            raise ValueError("win_start must be int32 (NBLK, NSEG)")
        if not (m.is_contiguous() and ws.is_contiguous()):
            raise ValueError("m and win_start must be contiguous")
        if m.data_ptr() % 16 or m.device != dev or ws.device != dev:
            raise ValueError("m must be 16-byte aligned, on x's device")
    for name, t in (("items", plan.items), ("splits", plan.splits)):
        if (t.dtype != torch.int32 or t.ndim != 2 or t.shape[1] != 4
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"the work table's {name} must be int32 "
                             f"(N, 4), contiguous, on x's device")
    if not (xp.dtype == torch.float32 and xp.ndim == 1
            and xp.is_contiguous() and xp.device == dev
            and xp.data_ptr() % 16 == 0
            and xp.shape[0] >= padded_length(buckets[0], buckets[0].n_cols)):
        raise ValueError("xp must be x zero-padded by pad_x (1-D float32, "
                         "contiguous, on x's device)")
    lib = LIBRARY.load()
    fn = (lib.gmg_mxu_slab_matvec_f32 if dtype == torch.float32
          else lib.gmg_mxu_slab_matvec_bf16)
    nb = len(buckets)
    mt = (ctypes.c_void_p * nb)(*(b.m.data_ptr() for b in buckets))
    ws = (ctypes.c_void_p * nb)(*(b.win_start.data_ptr() for b in buckets))
    nseg = (ctypes.c_int * nb)(*(s[1] for s in plan.shapes))
    y = torch.empty((plan.n_out * 128,), dtype=torch.float32, device=dev)
    scratch = torch.empty((max(plan.n_slots, 1) * 128,),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(mt, ws, nseg, nb, plan.items.data_ptr(),
                 plan.items.shape[0], plan.splits.data_ptr(),
                 plan.splits.shape[0], xp.data_ptr(), y.data_ptr(),
                 scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mxu_matvec kernel launch failed: cudaError "
                           f"{err}")
    mxu_matvec_cuda.launches += 1
    return y


def mxu_matvec_plain(op: BlockDenseOperator, x: torch.Tensor,
                     xp: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel on one bucket (one batched product
    over all of the bucket's segments), plus the escape chute.  ``xp`` is
    x as :func:`pad_x` pads it.  On the card it needs full-f32 matrix
    products (``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's
    default)."""
    _check_tile_op(op)
    if xp.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("mxu_matvec_plain needs full-f32 matrix products: "
                         "set torch.backends.cuda.matmul.allow_tf32 = False")
    nblk, nseg = op.win_start.shape
    acc = torch.promote_types(op.m.dtype, torch.float32)
    segs = op.win_start.long() // 128
    wins = xp.view(-1, 128)[segs].to(op.m.dtype).to(acc)
    y = torch.bmm(wins.reshape(nblk, 1, nseg * 128),
                  op.m.reshape(nblk, nseg * 128, 128).to(acc))
    return add_escape(op, y.reshape(-1).to(x.dtype), x)


def mxu_matvec_cuda(op: BlockDenseOperator, x: torch.Tensor,
                    xp: torch.Tensor, plan: MxuPlan) -> torch.Tensor:
    """The kernel on one bucket, by a table of one bucket (``plan``:
    :func:`bucket_plan`, which the caller builds once and keeps), plus
    the escape chute.  ``xp`` is x as :func:`pad_x` pads it.  Raises on
    anything the kernel does not take; ``mxu_matvec_cuda.launches``
    counts every launch of the kernel, through this wrapper or through
    :func:`mxu_slab_matvec_cuda`."""
    _check_tile_op(op)
    y = _tiles_cuda((op,), plan, x, xp)
    return add_escape(op, y, x)


mxu_matvec_cuda.launches = 0


def _plan_of(op) -> MxuPlan:
    if op.plan is None:
        raise ValueError("the slab form carries no work table (plan): "
                         "build it with slab_from_ell(..., mxu=True)")
    return op.plan


def mxu_slab_matvec_plain(op, x: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the one-launch kernel on a transposed-tile
    ``SlabOperator``: (n_rows,) without the diagonal."""
    xp = pad_x(op.buckets[0], x)
    y = _tiles_plain(op.buckets, _plan_of(op), xp).to(x.dtype)
    return slab_escape(op, y, x)[:op.n_rows]


def mxu_slab_matvec_cuda(op, x: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel over all buckets of a transposed-tile
    ``SlabOperator``: (n_rows,) in row order, without the diagonal."""
    xp = pad_x(op.buckets[0], x)
    y = _tiles_cuda(op.buckets, _plan_of(op), x, xp)
    return slab_escape(op, y, x)[:op.n_rows]


def mxu_slab_matvec_fast(op, x: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA x, its plain twin for a CPU x."""
    if x.is_cuda:
        return mxu_slab_matvec_cuda(op, x)
    return mxu_slab_matvec_plain(op, x)
