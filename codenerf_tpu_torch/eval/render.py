"""Full-image rendering in fixed-size ray chunks (counterpart of
``codenerf_tpu/eval/render.py``; reference nerf/__init__.py:137-226).

The H*W rays are padded once to a whole number of chunks (directions
padded with 1.0, so padded rays stay finite) and rendered chunk by chunk
with the fine model's colour, deterministic sampling (perturb off), as the
reference does for validation renders.  The renderer serves through
``serving_settings``: fc_out as separate sigma and feature products on the
ray-structured path, as JAX's does; K1 serves under ``use_pallas``.

With a ``world`` (``parallel.mesh``) the chunk size is rounded down to a
multiple of its size, each rank renders its slice of every chunk and
``all_gather_rays`` puts the chunk back together, so every rank returns
the whole image (JAX render.py:53-76).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from codenerf_tpu_torch.core.geometry import ray_bundle
from codenerf_tpu_torch.device import resolve_device
from codenerf_tpu_torch.models.mlp import CodeNeRFConfig
from codenerf_tpu_torch.parallel.mesh import (World, all_gather_rays,
                                              shard_rays, world_size)
from codenerf_tpu_torch.pipeline import RenderSettings, render_rays


def serving_settings(settings: RenderSettings) -> RenderSettings:
    """The grad-free variant of ``settings``: ``split_fc_out`` on CodeNeRF
    models (JAX eval/render.py:25-33); a FlexibleNeRF has no fc_out
    split."""
    def split(cfg):
        if isinstance(cfg, CodeNeRFConfig):
            return dataclasses.replace(cfg, split_fc_out=True)
        return cfg
    return dataclasses.replace(settings, coarse_cfg=split(settings.coarse_cfg),
                               fine_cfg=split(settings.fine_cfg))


def make_image_renderer(settings: RenderSettings, height: int, width: int,
                        chunksize: int = 4096, device="cuda",
                        world: Optional[World] = None) -> Callable:
    """Build a full-image renderer on ``device``, each chunk split over
    the ranks of ``world`` (None: one device).

    Returned signature: ``render_image(models, directions, pose, z_s, z_t)
    -> rgb [H*W, 3]`` with ``models`` {"coarse", "fine"} on ``device``,
    ``directions`` [H, W, 3], ``pose`` [4, 4] and codes [1, C] (None for
    a FlexibleNeRF).
    """
    dev = resolve_device(device)
    settings = serving_settings(settings)
    num_rays = height * width
    W = world_size(world)
    # every chunk splits evenly over the ranks
    chunksize = max(W, chunksize // W * W)
    num_chunks = -(-num_rays // chunksize)
    pad = num_chunks * chunksize - num_rays

    @torch.no_grad()
    def render_image(models, directions, pose, z_s, z_t):
        ro, rd = ray_bundle(directions.to(dev), pose.to(dev)[None])
        ro = torch.nn.functional.pad(ro.reshape(num_rays, 3), (0, 0, 0, pad))
        rd = torch.nn.functional.pad(rd.reshape(num_rays, 3), (0, 0, 0, pad),
                                     value=1.0)
        zs = zt = None
        if z_s is not None:
            zs = z_s.to(dev).expand(chunksize // W, z_s.shape[-1])
            zt = z_t.to(dev).expand(chunksize // W, z_t.shape[-1])
        rgb = []
        for i in range(num_chunks):
            sl = slice(i * chunksize, (i + 1) * chunksize)
            _, out_f = render_rays(models, settings,
                                   *shard_rays(world, ro[sl], rd[sl]), zs, zt)
            rgb.append(all_gather_rays(world, out_f.rgb))
        return torch.cat(rgb)[:num_rays]

    return render_image
