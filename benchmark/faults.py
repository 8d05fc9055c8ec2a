"""Faults planted underneath the timed path, to show that ``correct``
catches them (the tests under ``tests/`` and ``calibrate.py`` on the
chip).  Each is a context manager that patches the port where the fault
would be made:

  * ``unchanged``: the optimizer's step returns with the state as it was;
  * ``half``: half of each batch's rays left out, the mean taken over
    the rest;
  * ``altered``: every composited colour offset by 0.05 where the
    compositing produces it.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    """``obj.name`` set to ``value`` inside the block; afterwards as it
    was (an attribute ``obj`` inherited is deleted again, not pinned)."""
    own = vars(obj)
    had, old = name in own, own.get(name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


@contextlib.contextmanager
def planted(fault):
    """The port with ``fault`` (one of ``FAULTS``, or None: none)."""
    if fault is None:
        yield
        return
    from codenerf_tpu_torch import pipeline
    from codenerf_tpu_torch.eval import tto
    from codenerf_tpu_torch.train import step
    if fault == "unchanged":
        with _patched(torch.optim.Adam, "step", lambda self, *a, **k: None), \
                _patched(torch.optim.AdamW, "step",
                         lambda self, *a, **k: None):
            yield
    elif fault == "half":
        gather, shard, losses = (step.gather_ray_batch, step.shard_rays,
                                 tto._object_losses)

        def half_gather(directions, pose, pixels, ids, gen, n, inds=None):
            return gather(directions, pose, pixels, ids, gen, n // 2,
                          None if inds is None else inds[:, :n // 2])

        def half_draws(world, v):
            return shard(world, v[:v.shape[0] // 2])

        def half_losses(models, settings, poses, z_s, z_t, directions,
                        images, generator, n, perturb, inds, draws, world):
            K = inds.shape[0]
            draws = {k: v.reshape(K, n, -1)[:, :n // 2].reshape(
                K * (n // 2), -1) for k, v in draws.items()}
            return losses(models, settings, poses, z_s, z_t, directions,
                          images, generator, n // 2, perturb,
                          inds[:, :n // 2], draws, world)

        with _patched(step, "gather_ray_batch", half_gather), \
                _patched(step, "shard_rays", half_draws), \
                _patched(tto, "_object_losses", half_losses):
            yield
    elif fault == "altered":
        render = pipeline.volume_render

        def altered(*args, **kwargs):
            out = render(*args, **kwargs)
            return out._replace(rgb=out.rgb + 0.05)

        with _patched(pipeline, "volume_render", altered):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r} (have {FAULTS})")
