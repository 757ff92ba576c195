"""Where the package's entry points put the tensors they make."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.

    The package runs on the card unless the caller asks for the CPU
    (``device="cpu"``): with ``device=None`` and no CUDA device this
    raises instead of stepping down to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: gravomg_tpu_torch puts its tensors on the card "
            "by default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
