"""Encoding, camera geometry, image metrics and the SO(3) / SE(3) maps of
``core.lie`` (counterpart of ``codenerf_tpu/core``)."""

from codenerf_tpu_torch.core.encoding import (  # noqa: F401
    frequency_bands, positional_encoding, encoding_dim)
from codenerf_tpu_torch.core.geometry import (  # noqa: F401
    pixel_directions, ray_bundle, pose_spherical, select_ray_indices)
from codenerf_tpu_torch.core.metrics import mse2psnr  # noqa: F401
