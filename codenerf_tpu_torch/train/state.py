"""Training state and its initialization (counterpart of
``codenerf_tpu/train/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from codenerf_tpu_torch.config import Config
from codenerf_tpu_torch.models import CodeNeRFConfig, CodeTables, build_model
from codenerf_tpu_torch.parallel.mesh import World, broadcast_
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train.optim import build_optimizer
from codenerf_tpu_torch.utils import trace


def has_codes(settings: RenderSettings) -> bool:
    """Whether the models take per-object codes: CodeNeRF does, vanilla
    NeRF (FlexibleNeRF) does not (JAX state.py:32)."""
    return isinstance(settings.coarse_cfg, CodeNeRFConfig)


@dataclass
class TrainState:
    """Everything a train step updates.  ``step`` counts optimizer steps,
    the scheduler's position; ``tables`` is None for a vanilla model."""
    models: dict           # {"coarse": module, "fine": module}
    tables: Optional[CodeTables]
    optimizer: Any
    scheduler: Any
    step: int = 0

    def modules(self) -> dict:
        """{"coarse", "fine"} and, with codes, "tables": every module the
        optimizer updates, in its parameter order."""
        out = dict(self.models)
        if self.tables is not None:
            out["tables"] = self.tables
        return out


def init_train_state(cfg: Config, settings: RenderSettings,
                     num_objects: int, seed: int = 0,
                     device="cuda") -> TrainState:
    """Models (and, for CodeNeRF, code tables) drawn on the CPU from
    ``seed`` and moved to ``device``, with the optimizer and scheduler
    over them, timed as the span ``setup.state``.  To start from the JAX
    package's parameters, follow with ``weights.params_from_jax`` before
    the first step."""
    with trace.span("setup.state"):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        models = {"coarse": build_model(settings.coarse_cfg, device, gen),
                  "fine": build_model(settings.fine_cfg, device, gen)}
        tables = None
        if has_codes(settings):
            emb = cfg.models.embedding
            tables = CodeTables(num_objects, emb.shape_code_size,
                                emb.texture_code_size, device, gen)
        optimizer, scheduler = build_optimizer(cfg.optimizer, models, tables)
    return TrainState(models, tables, optimizer, scheduler)


def broadcast_train_state(world: Optional[World], state: TrainState) -> None:
    """Make ``state`` on every rank of ``world`` rank 0's: every parameter,
    every optimizer-state tensor and the step, in place (JAX's
    ``replicated_sharding`` put after an init or a restore,
    ``codenerf_tpu/train/loop.py:42-46``).  Every rank must hold a state
    of the same structure, as the same init and the same checkpoint give
    it."""
    if world is None:
        return
    tensors = [p for m in state.modules().values() for p in m.parameters()]
    for p in (p for g in state.optimizer.param_groups for p in g["params"]):
        tensors += [v for _, v in sorted(state.optimizer.state.get(
            p, {}).items()) if torch.is_tensor(v)]
    step = torch.tensor([state.step], dtype=torch.int64)
    broadcast_(world, tensors + [step])
    state.step = int(step)
