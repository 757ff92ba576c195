"""Shared by the tests of K1 and B1 (``csrc/blockdense_matvec.cu``,
``csrc/blockdense_matmat.cu``): the per-bucket twin route of a slab
matvec.  Imports neither JAX nor the JAX package, so the card-only tests
that use it run without JAX."""

import torch

from gravomg_tpu_torch.ops.blockdense import pad_x
from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matmat_plain,
                                                   blockdense_matvec_plain)


def per_bucket_twin(sop, x: torch.Tensor) -> torch.Tensor:
    """The route before one launch, without the diagonal: the twin per
    bucket (K1's for x (n_cols,), B1's for x (n_cols, D)), the buckets'
    blocks laid end to end, un-permuted by ``inv_block_perm``."""
    xp = pad_x(sop.buckets[0], x)
    tail = tuple(x.shape[1:])
    twin = blockdense_matmat_plain if x.ndim == 2 else blockdense_matvec_plain
    parts = [twin(b, x, xp).reshape(-1, 8, *tail) for b in sop.buckets]
    y = torch.cat(parts)[sop.inv_block_perm.long()]
    return y.reshape(-1, *tail)[:sop.n_rows]
