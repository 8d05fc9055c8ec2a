"""One training step: rays -> render -> loss -> grads -> update
(counterpart of ``codenerf_tpu/train/step.py``; reference
train.py:70-114).

As in the JAX package, each step consumes the whole ray batch
(B images x num_random_rays) with one optimizer step; ``ray_chunks > 1``
walks the batch in chunks and accumulates the gradient, which gives the
same loss and the same update.  Ray selection runs on the device from a
``torch.Generator``.  The step returns its metrics as tensors, so it never
waits for the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from codenerf_tpu_torch.core.geometry import ray_bundle, select_ray_indices
from codenerf_tpu_torch.core.metrics import mse2psnr
from codenerf_tpu_torch.models.codes import code_table_norms, lookup_codes
from codenerf_tpu_torch.pipeline import RenderSettings, render_rays_train
from codenerf_tpu_torch.train.state import TrainState


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    loss_coarse: torch.Tensor
    loss_fine: torch.Tensor
    loss_embedding: torch.Tensor
    psnr: torch.Tensor


def gather_ray_batch(directions, pose, pixels, object_ids,
                     generator: Optional[torch.Generator],
                     num_random_rays: int, inds=None):
    """Rays and target pixels for a batch of images, on the device.

    directions [H, W, 3]; pose [B, 4, 4]; pixels [B, H, W, C]; object_ids
    [B].  ``inds`` [B, n] picks the pixels; without it they are drawn
    from ``generator``.  Returns ro, rd [B*n, 3], target [B*n, C] and ids
    [B*n].
    """
    B = pose.shape[0]
    H, W = directions.shape[:2]
    ro, rd = ray_bundle(directions, pose)
    ro, rd = ro.reshape(B, H * W, 3), rd.reshape(B, H * W, 3)
    flat_pix = pixels.reshape(B, H * W, -1)
    if inds is None:
        inds = select_ray_indices(generator, H * W, num_random_rays, B)
    inds = inds.to(device=ro.device, dtype=torch.long)

    def take(a):
        return torch.gather(a, 1, inds[..., None].expand(-1, -1, a.shape[-1])
                            ).reshape(B * num_random_rays, -1)

    ids = object_ids.to(ro.device).repeat_interleave(num_random_rays)
    return take(ro), take(rd), take(flat_pix), ids


def make_train_step(settings: RenderSettings, state: TrainState,
                    num_random_rays: int, regularizer_lambda: float,
                    perturb: bool, ray_chunks: int = 1) -> Callable:
    """Build the train step over ``state``.

    Returned signature: ``train_step(directions, pose, pixels, object_ids,
    generator, inds=None, draws=None) -> StepMetrics``; it updates
    ``state`` in place (parameters, optimizer, scheduler, step).  ``inds``
    and ``draws`` (a list of ``render_rays_train`` draws, one per chunk)
    replace the generator's draws in tests.
    """
    models, tables = state.models, state.tables

    def train_step(directions, pose, pixels, object_ids, generator,
                   inds=None, draws=None) -> StepMetrics:
        state.optimizer.zero_grad(set_to_none=True)
        ro, rd, target, ids = gather_ray_batch(
            directions, pose, pixels, object_ids, generator,
            num_random_rays, inds)
        R = ro.shape[0]
        if R % ray_chunks:
            raise ValueError(f"ray batch {R} not divisible by ray_chunks="
                             f"{ray_chunks}")
        rc = R // ray_chunks
        ss_c = ss_f = torch.zeros((), device=ro.device)
        for i in range(ray_chunks):
            sl = slice(i * rc, (i + 1) * rc)
            z_s, z_t = lookup_codes(tables, ids[sl])
            out_c, out_f = render_rays_train(
                models, settings, ro[sl], rd[sl], z_s, z_t, generator,
                perturb, settings.noise_std,
                None if draws is None else draws[i])
            c = torch.sum((out_c.rgb - target[sl, :3]) ** 2)
            f = torch.sum((out_f.rgb - target[sl, :3]) ** 2)
            ((c + f) / (R * 3)).backward()
            ss_c, ss_f = ss_c + c.detach(), ss_f + f.detach()
        loss_c, loss_f = ss_c / (R * 3), ss_f / (R * 3)
        # losses per reference train.py:103-108
        if regularizer_lambda > 0:
            ns, nt = code_table_norms(tables)
            loss_e = regularizer_lambda * (ns + nt)
            loss_e.backward()
            loss_e = loss_e.detach()
        else:
            loss_e = torch.zeros_like(loss_c)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return StepMetrics(loss=loss_c + loss_f + loss_e, loss_coarse=loss_c,
                           loss_fine=loss_f, loss_embedding=loss_e,
                           psnr=mse2psnr(loss_f))

    return train_step
