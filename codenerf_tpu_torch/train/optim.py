"""Optimizer construction with the reference's parameter-group semantics
(counterpart of ``codenerf_tpu/train/optim.py``; reference util.py:147-172
and eval.py:133-138).

Each builder makes one ``torch.optim`` optimizer, chosen by name as the
reference's ``getattr(torch.optim, type)``, with one param group per
learning rate.  Training has three groups — coarse MLP and fine MLP at
``lr``, the code tables at ``embedding_lr`` — under a LambdaLR continuous
exponential decay ``gamma ** (step / step_size)``; the scheduler is
stepped once after each optimizer step, so the first update uses lr(0),
as optax's schedules count.  Test-time optimization (TTO) has no
schedule: codes at ``val_lr``, angles at ``angle_lr`` and the radius at
``radius_lr`` (``build_tto_optimizer``), or codes and the SE(3) tangent
xi (``build_se3_refine_optimizer``), all of type ``val_type``.
"""

from __future__ import annotations

import torch

from codenerf_tpu_torch.config import OptimizerConfig

# torch names the train step cannot drive: LBFGS needs a closure that
# re-evaluates the loss for its line search
_UNSUPPORTED = {"LBFGS": "use a first-order optimizer"}


def _optimizer_class(name: str):
    """The ``torch.optim`` class called ``name``; raises ``ValueError``
    for LBFGS and for names that are not an optimizer."""
    if name in _UNSUPPORTED:
        raise ValueError(f"optimizer type {name} is not supported: "
                         f"{_UNSUPPORTED[name]}")
    cls = getattr(torch.optim, name, None)
    if not (isinstance(cls, type) and issubclass(cls, torch.optim.Optimizer)):
        raise ValueError(f"unknown optimizer type: {name}")
    return cls


def build_optimizer(opt_cfg: OptimizerConfig, models: dict, tables=None):
    """(optimizer, scheduler) over ``models`` {"coarse", "fine"} and the
    code tables.  AdamW runs at torch's defaults (weight decay 1e-2),
    which is ``optax.adamw(lr, weight_decay=1e-2)``."""
    cls = _optimizer_class(opt_cfg.type)
    groups = [{"params": list(models["coarse"].parameters()),
               "lr": opt_cfg.lr},
              {"params": list(models["fine"].parameters()),
               "lr": opt_cfg.lr}]
    if tables is not None:
        groups.append({"params": list(tables.parameters()),
                       "lr": opt_cfg.resolved_embedding_lr})
    optimizer = cls(groups, lr=opt_cfg.lr)
    gamma, step_size = opt_cfg.scheduler_gamma, opt_cfg.scheduler_step_size
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: gamma ** (step / step_size))
    return optimizer, scheduler


def _grouped(opt_cfg: OptimizerConfig, variables: dict, lrs: dict):
    """One ``resolved_val_type`` optimizer over ``variables``, a group per
    entry of ``lrs`` {lr: names}, in that order."""
    cls = _optimizer_class(opt_cfg.resolved_val_type)
    groups = [{"params": [variables[n] for n in names], "lr": lr}
              for lr, names in lrs]
    return cls(groups, lr=opt_cfg.val_lr)


def build_tto_optimizer(opt_cfg: OptimizerConfig, variables: dict):
    """The TTO optimizer over ``variables`` {"z_s", "z_t", "theta", "phi",
    "rho"}: codes at ``val_lr``, (theta, phi) at ``resolved_angle_lr``,
    rho at ``resolved_radius_lr``; no schedule (reference eval.py:133-138).
    AdamW's weight decay of 1e-2 applies to the pose leaves too, as
    optax's does."""
    return _grouped(opt_cfg, variables, (
        (opt_cfg.val_lr, ("z_s", "z_t")),
        (opt_cfg.resolved_angle_lr, ("theta", "phi")),
        (opt_cfg.resolved_radius_lr, ("rho",))))


def build_se3_refine_optimizer(opt_cfg: OptimizerConfig, variables: dict):
    """The SE(3) refine stage's optimizer over ``variables`` {"z_s",
    "z_t", "xi"}: codes at ``val_lr``, xi at ``se3_refine_lr``; no
    schedule."""
    return _grouped(opt_cfg, variables, (
        (opt_cfg.val_lr, ("z_s", "z_t")),
        (opt_cfg.se3_refine_lr, ("xi",))))
