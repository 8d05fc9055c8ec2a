"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there
    is no usable card.  Entry points default to ``"cuda"`` and run on the
    CPU only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
