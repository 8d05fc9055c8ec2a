"""Image-quality metrics (counterpart of ``codenerf_tpu/core/metrics.py``)."""

from __future__ import annotations

import torch


def mse2psnr(mse) -> torch.Tensor:
    """PSNR from MSE with the reference's zero guard (util.py:224-227)."""
    mse = torch.as_tensor(mse)
    safe = torch.where(mse == 0, torch.full_like(mse, 1e-5), mse)
    return -10.0 * torch.log10(safe)
