"""Full-image rendering in fixed-size ray chunks (counterpart of
``codenerf_tpu/eval/render.py``; reference nerf/__init__.py:137-226).

The H*W rays are padded once to a whole number of chunks (directions
padded with 1.0, so padded rays stay finite) and rendered chunk by chunk
with the fine model's colour, deterministic sampling (perturb off), as the
reference does for validation renders.  The renderer serves through
``serving_settings``: fc_out as separate sigma and feature products on the
ray-structured path, as JAX's does; K1 serves under ``use_pallas``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from codenerf_tpu_torch.core.geometry import ray_bundle
from codenerf_tpu_torch.device import resolve_device
from codenerf_tpu_torch.pipeline import RenderSettings, render_rays


def serving_settings(settings: RenderSettings) -> RenderSettings:
    """The grad-free variant of ``settings``: ``split_fc_out`` on both
    models (JAX eval/render.py:25-33)."""
    return dataclasses.replace(
        settings,
        coarse_cfg=dataclasses.replace(settings.coarse_cfg,
                                       split_fc_out=True),
        fine_cfg=dataclasses.replace(settings.fine_cfg, split_fc_out=True))


def make_image_renderer(settings: RenderSettings, height: int, width: int,
                        chunksize: int = 4096, device="cuda") -> Callable:
    """Build a full-image renderer on ``device``.

    Returned signature: ``render_image(models, directions, pose, z_s, z_t)
    -> rgb [H*W, 3]`` with ``models`` {"coarse", "fine"} on ``device``,
    ``directions`` [H, W, 3], ``pose`` [4, 4] and codes [1, C].
    """
    dev = resolve_device(device)
    settings = serving_settings(settings)
    num_rays = height * width
    num_chunks = -(-num_rays // chunksize)
    pad = num_chunks * chunksize - num_rays

    @torch.no_grad()
    def render_image(models, directions, pose, z_s, z_t):
        ro, rd = ray_bundle(directions.to(dev), pose.to(dev)[None])
        ro = torch.nn.functional.pad(ro.reshape(num_rays, 3), (0, 0, 0, pad))
        rd = torch.nn.functional.pad(rd.reshape(num_rays, 3), (0, 0, 0, pad),
                                     value=1.0)
        zs = z_s.to(dev).expand(chunksize, z_s.shape[-1])
        zt = z_t.to(dev).expand(chunksize, z_t.shape[-1])
        rgb = []
        for i in range(num_chunks):
            sl = slice(i * chunksize, (i + 1) * chunksize)
            _, out_f = render_rays(models, settings, ro[sl], rd[sl], zs, zt)
            rgb.append(out_f.rgb)
        return torch.cat(rgb)[:num_rays]

    return render_image
