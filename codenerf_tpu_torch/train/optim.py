"""Optimizer construction with the reference's parameter-group semantics
(counterpart of ``codenerf_tpu/train/optim.py``; reference util.py:147-172
and eval.py:133-138).

Each builder makes one optimizer, chosen by name as the reference's
``getattr(torch.optim, type)`` and computing what the JAX package's
optax transformation of that name computes (``OPTIMIZERS``), with one
param group per learning rate.  Adam, AdamW (weight decay 1e-2), SGD,
Adamax and Adadelta are torch's own classes, which compute optax's
update; ASGD is plain SGD and SparseAdam is Adam, as in JAX.  Adagrad,
RMSprop, Rprop, NAdam and RAdam are the small ``torch.optim.Optimizer``
subclasses below, each performing its optax transformation's update
(torch's classes place eps, start accumulators or decay momentum
otherwise).  Their per-parameter state holds tensors of the parameter's
shape and a 0-d step count, so ``eval/tto.py::select_per_object`` can
rebuild them as ``cls(groups)`` and merge their state object by object.

Training has three groups — coarse MLP and fine MLP at ``lr``, the code
tables at ``embedding_lr`` — or, for a vanilla model without codes, one
group of the coarse and then the fine MLP's parameters at ``lr`` (JAX's
single transformation, optim.py:83-84), under a LambdaLR continuous
exponential decay ``gamma ** (step / step_size)``; the scheduler is stepped once
after each optimizer step, so the first update uses lr(0), as optax's
schedules count.  Rprop takes its learning rate once, as its first step
size (JAX evaluates the schedule at step 0).  Test-time optimization
(TTO) has no schedule: codes at ``val_lr``, angles at ``angle_lr`` and
the radius at ``radius_lr`` (``build_tto_optimizer``), or codes and the
SE(3) tangent xi (``build_se3_refine_optimizer``), all of type
``val_type``.
"""

from __future__ import annotations

import math

import torch

from codenerf_tpu_torch.config import OptimizerConfig


class _OptaxRule(torch.optim.Optimizer):
    """An optimizer whose update is one optax transformation followed by
    ``scale_by_learning_rate``: ``p += -lr * direction``.  A subclass
    gives ``_init(p, group)`` (the state tensors, of the parameter's shape) and
    ``_direction(g, state, count, lr)`` (updates its state in place)."""

    def __init__(self, params, lr: float = 1e-3):
        super().__init__(params, {"lr": lr})

    def _init(self, p, group) -> dict:
        raise NotImplementedError

    def _direction(self, g, state, count, lr):
        raise NotImplementedError

    def _update(self, g, state, count, lr):
        return -lr * self._direction(g, state, count, lr)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state.update(self._init(p, group))
                state["step"] += 1
                p.add_(self._update(p.grad, state, int(state["step"]),
                                    group["lr"]))
        return loss


class Adagrad(_OptaxRule):
    """``optax.adagrad``: the sum of squares starts at 0.1 and the
    direction is g / sqrt(sum + 1e-7) (0 where the sum is 0)."""
    INITIAL, EPS = 0.1, 1e-7

    def _init(self, p, group):
        return {"sum": torch.full_like(p, self.INITIAL,
                                       memory_format=torch.preserve_format)}

    def _direction(self, g, state, count, lr):
        s = state["sum"]
        s.add_(g * g)
        return torch.where(s > 0, torch.rsqrt(s + self.EPS),
                           torch.zeros((), device=g.device)) * g


class RMSprop(_OptaxRule):
    """``optax.rmsprop(decay=0.99, eps=1e-8)``: nu = 0.99 nu + 0.01 g^2
    from 0, direction g / sqrt(nu + eps) (eps inside the root)."""
    DECAY, EPS = 0.99, 1e-8

    def _init(self, p, group):
        return {"nu": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _direction(self, g, state, count, lr):
        nu = state["nu"]
        nu.copy_((1 - self.DECAY) * g ** 2 + self.DECAY * nu)
        return torch.rsqrt(nu + self.EPS) * g


class Rprop(_OptaxRule):
    """``optax.rprop`` at its first learning rate: per-element step sizes
    from lr, times 1.2 where the gradient keeps its sign against the last
    update and 0.5 where it flips (clipped to [1e-6, 50]); the update is
    the previous step's sign step, zeroed where the sign flipped, as
    optax computes it."""
    ETA_MINUS, ETA_PLUS, MIN_STEP, MAX_STEP = 0.5, 1.2, 1e-6, 50.0

    def _init(self, p, group):
        return {"step_size": torch.full_like(
                    p, group["lr"], memory_format=torch.preserve_format),
                "prev": torch.zeros_like(p,
                                         memory_format=torch.preserve_format)}

    def _direction(self, g, state, count, lr):
        prev, size = state["prev"], state["step_size"]
        sign = g * prev
        grown = torch.clamp(
            size * torch.where(sign > 0, self.ETA_PLUS, self.ETA_MINUS),
            min=self.MIN_STEP, max=self.MAX_STEP)
        size.copy_(torch.where(sign == 0, size, grown))
        zero = torch.zeros((), device=g.device)
        update = torch.where(sign < 0, zero, prev)
        prev.copy_(torch.where(sign < 0, zero, size * torch.sign(g)))
        return update

    def _update(self, g, state, count, lr):
        # optax.rprop's update is the direction itself, negated; the
        # learning rate only seeded the step sizes
        return -self._direction(g, state, count, lr)


class _AdamMoments(_OptaxRule):
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def _init(self, p, group):
        z = torch.zeros_like(p, memory_format=torch.preserve_format)
        return {"mu": z, "nu": z.clone()}

    def _moments(self, g, state):
        mu, nu = state["mu"], state["nu"]
        mu.copy_((1 - self.B1) * g + self.B1 * mu)
        nu.copy_((1 - self.B2) * g ** 2 + self.B2 * nu)
        return mu, nu

    def _bc(self, decay, count):
        # optax's bias correction: 1 - decay ** count, in f32
        return float(torch.tensor(1.0) - torch.tensor(decay) ** count)


class NAdam(_AdamMoments):
    """``optax.nadam``: Adam with the Nesterov first moment, mu_hat =
    b1 mu / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t), and no momentum
    decay schedule (torch's NAdam has one)."""

    def _direction(self, g, state, count, lr):
        mu, nu = self._moments(g, state)
        mu_hat = (self.B1 * (mu / self._bc(self.B1, count + 1))
                  + (1 - self.B1) * (g / self._bc(self.B1, count)))
        nu_hat = nu / self._bc(self.B2, count)
        return mu_hat / (torch.sqrt(nu_hat) + self.EPS)


class RAdam(_AdamMoments):
    """``optax.radam``: while the variance estimate is intractable (rho_t
    < 5) the bias-corrected momentum alone, after it the rectified
    mu_hat / (sqrt(nu_hat) + eps), eps outside the bias-corrected root
    (torch's RAdam adds eps before the bias correction)."""
    THRESHOLD = 5.0

    def _direction(self, g, state, count, lr):
        mu, nu = self._moments(g, state)
        b2t = float(torch.tensor(self.B2) ** count)
        ro_inf = 2.0 / (1.0 - self.B2) - 1.0
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        mu_hat = mu / self._bc(self.B1, count)
        if ro < self.THRESHOLD:
            return mu_hat
        nu_hat = nu / self._bc(self.B2, count)
        r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                      / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        return r * mu_hat / (torch.sqrt(nu_hat) + self.EPS)


# every name the JAX package maps to optax (codenerf_tpu/train/optim.py
# _OPTIMIZERS), to the class that computes the same update
OPTIMIZERS = {
    "AdamW": torch.optim.AdamW,         # weight decay 1e-2 by default
    "Adam": torch.optim.Adam,
    "Adamax": torch.optim.Adamax,
    "NAdam": NAdam,
    "RAdam": RAdam,
    "Adagrad": Adagrad,
    "Adadelta": torch.optim.Adadelta,
    "SGD": torch.optim.SGD,
    "ASGD": torch.optim.SGD,            # plain SGD, as in JAX
    "RMSprop": RMSprop,
    "Rprop": Rprop,
    "SparseAdam": torch.optim.Adam,     # gradients are dense
}

# names the train step cannot drive: LBFGS needs a closure that
# re-evaluates the loss for its line search
_UNSUPPORTED = {"LBFGS": "use a first-order optimizer"}


def _optimizer_class(name: str):
    """The class ``OPTIMIZERS`` maps ``name`` to; raises ``ValueError``
    for LBFGS and for names the JAX package does not map."""
    if name in _UNSUPPORTED:
        raise ValueError(f"optimizer type {name} is not supported: "
                         f"{_UNSUPPORTED[name]}")
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer type: {name} "
                         f"(available: {sorted(OPTIMIZERS)})")
    return OPTIMIZERS[name]


def lr_at_step(base_lr: float, gamma: float, step_size: int,
               step: int) -> float:
    """The scheduler's learning rate after ``step`` steps."""
    return base_lr * gamma ** (step / step_size)


def build_optimizer(opt_cfg: OptimizerConfig, models: dict, tables=None):
    """(optimizer, scheduler) over ``models`` {"coarse", "fine"} and the
    code tables (None: a vanilla model, one group).  AdamW runs at
    torch's defaults (weight decay 1e-2), which is ``optax.adamw(lr,
    weight_decay=1e-2)``."""
    cls = _optimizer_class(opt_cfg.type)
    coarse = list(models["coarse"].parameters())
    fine = list(models["fine"].parameters())
    if tables is None:
        groups = [{"params": coarse + fine, "lr": opt_cfg.lr}]
    else:
        groups = [{"params": coarse, "lr": opt_cfg.lr},
                  {"params": fine, "lr": opt_cfg.lr},
                  {"params": list(tables.parameters()),
                   "lr": opt_cfg.resolved_embedding_lr}]
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
