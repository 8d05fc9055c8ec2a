"""Optimizer construction with the reference's parameter-group semantics
(counterpart of ``codenerf_tpu/train/optim.py``; reference util.py:147-172).

One ``torch.optim`` optimizer, chosen by name as the reference's
``getattr(torch.optim, type)``, with three param groups — coarse MLP and
fine MLP at ``lr``, the code tables at ``embedding_lr`` — under a LambdaLR
continuous exponential decay ``gamma ** (step / step_size)``.  The
scheduler is stepped once after each optimizer step, so the first update
uses lr(0), as optax's schedules count.
"""

from __future__ import annotations

import torch

from codenerf_tpu_torch.config import OptimizerConfig

# torch names the train step cannot drive: LBFGS needs a closure that
# re-evaluates the loss for its line search
_UNSUPPORTED = {"LBFGS": "use a first-order optimizer"}


def build_optimizer(opt_cfg: OptimizerConfig, models: dict, tables=None):
    """(optimizer, scheduler) over ``models`` {"coarse", "fine"} and the
    code tables.  AdamW runs at torch's defaults (weight decay 1e-2),
    which is ``optax.adamw(lr, weight_decay=1e-2)``."""
    if opt_cfg.type in _UNSUPPORTED:
        raise ValueError(f"optimizer type {opt_cfg.type} is not supported: "
                         f"{_UNSUPPORTED[opt_cfg.type]}")
    cls = getattr(torch.optim, opt_cfg.type, None)
    if not (isinstance(cls, type) and issubclass(cls, torch.optim.Optimizer)):
        raise ValueError(f"unknown optimizer type: {opt_cfg.type}")
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
