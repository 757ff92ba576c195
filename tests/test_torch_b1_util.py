"""Shared by the tests of B1 (``csrc/blockdense_matmat.cu``): the
per-bucket twin route of a (V, D) slab matvec.  Imports neither JAX nor
the JAX package, so the card-only tests that use it run without JAX."""

import torch

from gravomg_tpu_torch.ops.blockdense import pad_x
from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matmat_plain


def per_bucket_twin(sop, x: torch.Tensor) -> torch.Tensor:
    """The (V, D) route before one launch, without the diagonal: B1's
    twin per bucket, the buckets' blocks laid end to end, un-permuted by
    ``inv_block_perm``."""
    xp = pad_x(sop.buckets[0], x)
    parts = [blockdense_matmat_plain(b, x, xp).reshape(-1, 8, x.shape[1])
             for b in sop.buckets]
    y = torch.cat(parts)[sop.inv_block_perm.long()]
    return y.reshape(-1, x.shape[1])[:sop.n_rows]
