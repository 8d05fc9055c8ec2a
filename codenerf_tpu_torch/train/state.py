"""Training state and its initialization (counterpart of
``codenerf_tpu/train/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from codenerf_tpu_torch.config import Config
from codenerf_tpu_torch.models import CodeNeRF, CodeTables
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train.optim import build_optimizer


@dataclass
class TrainState:
    """Everything a train step updates.  ``step`` counts optimizer steps,
    the scheduler's position."""
    models: dict           # {"coarse": CodeNeRF, "fine": CodeNeRF}
    tables: CodeTables
    optimizer: Any
    scheduler: Any
    step: int = 0


def init_train_state(cfg: Config, settings: RenderSettings,
                     num_objects: int, seed: int = 0,
                     device="cuda") -> TrainState:
    """Models and code tables drawn on the CPU from ``seed`` and moved to
    ``device``, with the optimizer and scheduler over them.  To start from
    the JAX package's parameters, follow with ``weights.params_from_jax``
    before the first step."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    models = {"coarse": CodeNeRF(settings.coarse_cfg, device, gen),
              "fine": CodeNeRF(settings.fine_cfg, device, gen)}
    emb = cfg.models.embedding
    tables = CodeTables(num_objects, emb.shape_code_size,
                        emb.texture_code_size, device, gen)
    optimizer, scheduler = build_optimizer(cfg.optimizer, models, tables)
    return TrainState(models, tables, optimizer, scheduler)
