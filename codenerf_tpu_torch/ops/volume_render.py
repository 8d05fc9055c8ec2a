"""Alpha compositing along the sample axis (counterpart of
``codenerf_tpu/ops/volume_render.py``; reference volumetric_render.py).

The activation constants set PSNR parity with the reference:

  * sigma = softplus(raw - 1)
  * rgb   = sigmoid(raw) * (1 + 2e-3) - 1e-3
  * the last sample's distance is 1e10
  * transmittance = exp(-exclusive_cumsum(sigma * delta))
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def widened_sigmoid(x, eps: float = 1e-3):
    return torch.sigmoid(x) * (1.0 + 2.0 * eps) - eps


def shifted_softplus(x):
    return F.softplus(x - 1.0)


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor      # [R, 3] composited color
    disp: torch.Tensor     # [R]    disparity
    acc: torch.Tensor      # [R]    accumulated weight (opacity)
    weights: torch.Tensor  # [R, S] per-sample compositing weights
    depth: torch.Tensor    # [R]    expected depth


def volume_render(radiance_field, depth_values, ray_directions,
                  white_background: bool = False) -> RenderOutputs:
    """Composite raw [R, S, 4] at depths [R, S] along rays [R, 3] (whose
    norm scales depth spacing into distance)."""
    dists = depth_values[..., 1:] - depth_values[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    delta = dists * torch.linalg.norm(ray_directions, dim=-1)[..., None]
    sigma_delta = shifted_softplus(radiance_field[..., 3]) * delta
    rgb = widened_sigmoid(radiance_field[..., :3])
    # exclusive prefix sum in f32; the 1e10 tail term enters no prefix
    accum = torch.cat([torch.zeros_like(sigma_delta[..., :1]),
                       torch.cumsum(sigma_delta[..., :-1], dim=-1)], dim=-1)
    weights = (1.0 - torch.exp(-sigma_delta)) * torch.exp(-accum)
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * depth_values, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)
