"""Training state and its initialization (counterpart of
``codenerf_tpu/train/state.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from codenerf_tpu_torch.config import Config
from codenerf_tpu_torch.models import CodeNeRFConfig, CodeTables, build_model
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train.optim import build_optimizer


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
    over them.  To start from the JAX package's parameters, follow with
    ``weights.params_from_jax`` before the first step."""
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
