"""One training step: rays -> render -> loss -> grads -> update
(counterpart of ``codenerf_tpu/train/step.py``; reference
train.py:70-114).

As in the JAX package, each step consumes the whole ray batch
(B images x num_random_rays) with one optimizer step; ``ray_chunks > 1``
walks the batch in chunks and accumulates the gradient, which gives the
same loss and the same update.  A vanilla model (``state.tables`` None)
looks up no codes and adds no embedding loss (JAX step.py:93-99, 144).
Ray selection runs on the device from a
``torch.Generator``.  The step returns its metrics as tensors, so it never
waits for the device.

With a ``world`` (``parallel.mesh``) the step is JAX's step on a mesh
(``codenerf_tpu/train/step.py:119-137``): every rank draws the same
global ray batch and render draws (``pipeline.draw_train_randoms``, in
the order ``render_rays_train`` draws them), renders its slice of the
ray axis (of each chunk under ``ray_chunks > 1``), backpropagates
``sum((rgb - target)^2) / (R_global * 3)``, and one ``all_reduce_grads``
sums the gradients.  The code regularizer's gradient is added after it
on every rank, once, and the metrics are summed over the ranks, so
every rank logs the global loss and takes the same update.

``use_checkify`` is the counterpart of the JAX step's
``checkify.float_checks`` (``codenerf_tpu/train/step.py:165-177``): after
the backward the loss and every gradient, after the update every
parameter, must be finite, else the step raises ``FloatingPointError``
naming the first bad leaf.  Each check waits for the device once; without
the flag the step has none.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from codenerf_tpu_torch.core.geometry import ray_bundle, select_ray_indices
from codenerf_tpu_torch.core.metrics import mse2psnr
from codenerf_tpu_torch.models.codes import code_table_norms, lookup_codes
from codenerf_tpu_torch.parallel.mesh import (World, all_reduce_,
                                              all_reduce_grads,
                                              shard_chunked_rays, shard_rays)
from codenerf_tpu_torch.pipeline import (RenderSettings, draw_train_randoms,
                                         render_rays_train)
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


def _named_leaves(state: TrainState, grads: bool) -> list:
    """(name, tensor) of every parameter, or of its gradient."""
    out = []
    for prefix, module in state.modules().items():
        for name, p in module.named_parameters():
            t = p.grad if grads else p
            if t is not None:
                out.append((f"{prefix}.{name}{'.grad' if grads else ''}",
                            t.detach()))
    return out


def _check_finite(leaves: list) -> None:
    """Raise ``FloatingPointError`` naming the first of ``leaves``
    ((name, tensor) pairs) that holds a nan or an inf; one wait for the
    device."""
    flags = torch.stack([torch.stack([torch.isnan(t).any(),
                                      torch.isinf(t).any()])
                         for _, t in leaves]).cpu()
    for (name, _), (nan, inf) in zip(leaves, flags.tolist()):
        if nan or inf:
            raise FloatingPointError(
                f"non-finite value in {name}: {'nan' if nan else 'inf'}")


def make_train_step(settings: RenderSettings, state: TrainState,
                    num_random_rays: int, regularizer_lambda: float,
                    perturb: bool, ray_chunks: int = 1,
                    use_checkify: bool = False,
                    world: Optional[World] = None) -> Callable:
    """Build the train step over ``state``, on this rank's share of the
    rays of ``world`` (None: one device).

    Returned signature: ``train_step(directions, pose, pixels, object_ids,
    generator, inds=None, draws=None) -> StepMetrics``; it updates
    ``state`` in place (parameters, optimizer, scheduler, step).  ``inds``
    and ``draws`` (a list of ``render_rays_train`` draws for the global
    rays of each chunk) replace the generator's draws in tests.
    """
    models, tables = state.models, state.tables
    params = [p for m in state.modules().values() for p in m.parameters()]

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
        ro, rd, target, ids = shard_chunked_rays(
            world, *(a.reshape(ray_chunks, rc, *a.shape[1:])
                     for a in (ro, rd, target, ids)))
        ss = torch.zeros(2, device=ro.device)           # coarse, fine
        for i in range(ray_chunks):
            d = (draws[i] if draws is not None else draw_train_randoms(
                settings, rc, generator, perturb, settings.noise_std,
                ro.dtype, ro.device))
            z_s = z_t = None
            if tables is not None:
                z_s, z_t = lookup_codes(tables, ids[i])
            out_c, out_f = render_rays_train(
                models, settings, ro[i], rd[i], z_s, z_t, None, perturb,
                settings.noise_std,
                {k: shard_rays(world, v) for k, v in d.items()})
            c = torch.sum((out_c.rgb - target[i, :, :3]) ** 2)
            f = torch.sum((out_f.rgb - target[i, :, :3]) ** 2)
            ((c + f) / (R * 3)).backward()
            ss = ss + torch.stack([c.detach(), f.detach()])
        all_reduce_grads(world, params)
        all_reduce_(world, [ss])
        loss_c, loss_f = ss[0] / (R * 3), ss[1] / (R * 3)
        # losses per reference train.py:103-108; the regularizer's
        # gradient is added after the all-reduce, once on every rank
        if tables is not None and regularizer_lambda > 0:
            ns, nt = code_table_norms(tables)
            loss_e = regularizer_lambda * (ns + nt)
            loss_e.backward()
            loss_e = loss_e.detach()
        else:
            loss_e = torch.zeros_like(loss_c)
        if use_checkify:
            _check_finite([("loss", loss_c + loss_f + loss_e)]
                         + _named_leaves(state, grads=True))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        if use_checkify:
            _check_finite(_named_leaves(state, grads=False))
        return StepMetrics(loss=loss_c + loss_f + loss_e, loss_coarse=loss_c,
                           loss_fine=loss_f, loss_embedding=loss_e,
                           psnr=mse2psnr(loss_f))

    return train_step
