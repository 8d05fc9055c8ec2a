"""Device-memory capacity model for batched test-time optimization
(counterpart of ``codenerf_tpu/eval/capacity.py``).

``harness.validate_category`` solves the category's objects in groups of
K.  Two defenses keep a group from running the card out of memory:

1. ``max_batch_objects`` clamps the requested K before any step runs, on
   the estimate

       peak_bytes ~= K * R * (S_coarse + S_union) * ACT_FACTORS[path]
                     * hidden * itemsize

   with R rays per object, S_union = S_coarse + S_fine samples in the
   fine pass, and ``path`` the trunk's path (``pipeline.trunk_path``):
   each path keeps a different number of hidden-wide tensors alive at
   the backward's peak.
2. ``is_oom_error`` recognises the allocator's out-of-memory error, so
   the category loop halves K and redoes the group instead of dying.

The JAX package's factor (5.9) was fitted to an XLA compile failure on a
TPU and does not carry over.  ``ACT_FACTORS`` are the slopes of
``torch.cuda.max_memory_allocated`` over one batched TTO step at K = 1
and K = 2 at the flagship shape (``fit_act_factor``), measured by
``chip_smoke.py``'s eval phase on the card named in ``CALIBRATED_ON``.

The budget is what the process can still allocate on the card
(``device_memory_budget``); on the CPU it is unknown (None) and K is not
clamped.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from codenerf_tpu_torch.pipeline import trunk_path

# hidden-wide tensors alive at one batched TTO step's peak, per sample
# point of the coarse and fine passes, by trunk path; the slope of
# max_memory_allocated from K = 1 to K = 2 at the flagship shape (4096
# rays, 32 + 160 samples, hidden 256, bf16), measured by chip_smoke.py:
# 3.246 GB per object fused, 4.435 fused_recompute, 3.920 hybrid, 4.249
# rays (the ray-structured path with remat)
ACT_FACTORS = {"fused": 8.062, "fused_recompute": 11.01, "hybrid": 9.737,
               "rays": 10.55}
# the card and power limit the factors were measured on
# (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)
CALIBRATED_ON = "NVIDIA H100 80GB HBM3, 700.00 W"
# headroom below the budget: the image renderer and the allocator's
# fragmentation share the card with the step
SAFETY = 0.95


def device_memory_budget(device="cuda") -> Optional[int]:
    """Bytes the process can still allocate on ``device``: the card's free
    memory plus what PyTorch's caching allocator holds unused; None on
    the CPU (unknown).

    ``CODENERF_HBM_BUDGET_BYTES`` overrides it, as in the JAX package:
    tests pin the capacity logic with it, and a user whose card is shared
    can cap the port's share.
    """
    env = os.environ.get("CODENERF_HBM_BUDGET_BYTES")
    if env:
        return int(env)
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    held = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int(free + held)


def _points_and_width(settings, num_random_rays: int, K: int):
    s_coarse = settings.num_coarse
    s_union = settings.num_coarse + settings.num_fine
    hidden = max(settings.coarse_cfg.hidden_size,
                 settings.fine_cfg.hidden_size)
    # bytes from the activation dtype the model computes in
    itemsize = (settings.coarse_cfg.cdtype or torch.float32).itemsize
    return K * num_random_rays * (s_coarse + s_union), hidden * itemsize


def tto_group_bytes(settings, num_random_rays: int, K: int) -> int:
    """Estimated peak device bytes of one K-object batched TTO step."""
    points, width = _points_and_width(settings, num_random_rays, K)
    return int(points * ACT_FACTORS[trunk_path(settings)] * width)


def fit_act_factor(settings, num_random_rays: int, peak_k1: int,
                   peak_k2: int) -> float:
    """The activation factor of ``settings``' trunk path from the peak
    bytes of one batched TTO step at K = 1 and K = 2: the slope per
    object over the sample points' hidden-wide bytes."""
    points, width = _points_and_width(settings, num_random_rays, 1)
    return (peak_k2 - peak_k1) / (points * width)


def max_batch_objects(settings, num_random_rays: int, requested: int,
                      budget: Optional[int] = None, device="cuda") -> int:
    """Largest K <= requested whose estimated peak fits the budget
    (default: ``device_memory_budget(device)``).

    Returns ``requested`` unchanged when the budget is unknown (the CPU);
    the runtime out-of-memory halving still covers that case.  Never
    returns less than 1.
    """
    if requested <= 1:
        return max(1, requested)
    if budget is None:
        budget = device_memory_budget(device)
    if budget is None:
        return requested
    per_object = tto_group_bytes(settings, num_random_rays, 1)
    if per_object <= 0:
        return requested
    return max(1, min(requested, int(budget * SAFETY // per_object)))


def is_oom_error(err: BaseException) -> bool:
    """True for PyTorch's CUDA out-of-memory error, and for a
    ``RuntimeError`` whose message says the card ran out of memory (a
    kernel wrapper reports cudaErrorMemoryAllocation as "out of memory").
    Only the ``RuntimeError`` family counts: a ``ValueError`` or
    ``AssertionError`` whose message merely mentions memory surfaces
    instead of halving K, as in the JAX package."""
    if isinstance(err, torch.cuda.OutOfMemoryError):
        return True
    if not isinstance(err, RuntimeError):
        return False
    msg = str(err)
    return "out of memory" in msg or "Out of memory" in msg
