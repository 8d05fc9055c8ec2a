"""Checkpoints in the reference's ``.ckpt`` layout (counterpart of
``codenerf_tpu/train/checkpoint.py``; reference train.py:129-138,
util.py:175-213).

A checkpoint is one ``torch.save`` file, ``<directory>/<step>.ckpt``,
holding the reference's keys (``codenerf_tpu/train/torch_import.py:3-5``)
plus the scheduler:

  * ``iter``: the step;
  * ``model_nerf_coarse_state_dict``, ``model_nerf_fine_state_dict``,
    ``model_embedding_state_dict``: the modules' own state dicts, which
    carry the reference's names; the embedding's is ``{}`` for a vanilla
    model, as JAX's exporter writes it (torch_import.py:281-285);
  * ``optimizer_state_dict``: the torch optimizer's, three param groups
    [coarse, fine, embedding] (one, coarse then fine, for a vanilla
    model), each module's parameters in definition order, which is the
    order the JAX package's importer
    (``torch_import.py::_torch_param_order``) reads;
  * ``scheduler_state_dict``: the LambdaLR's.

The reference resets the LR schedule on resume (train.py:130-136); here,
as in the JAX package, the schedule continues from ``iter``.  LambdaLR
pickles its step, not its lambda, so a restore rebuilds nothing: the
state's own scheduler, built from the config, loads the step.  The three
newest checkpoints are kept.  A file whose ``optimizer_state_dict`` is
empty (the JAX package's ``export_torch_checkpoint`` writes one) restores
the weights with fresh moments, and the schedule at ``iter``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

from codenerf_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^(\d+)\.ckpt$")


def _steps(directory: Path) -> list:
    if not directory.is_dir():
        return []
    return sorted(int(m.group(1)) for p in directory.iterdir()
                  if (m := _NAME.match(p.name)))


def checkpoint_path(directory, step: int) -> Path:
    return Path(directory) / f"{step}.ckpt"


def state_dict(state: TrainState) -> dict:
    """The checkpoint dict of ``state``."""
    return {
        "iter": int(state.step),
        "model_nerf_coarse_state_dict": state.models["coarse"].state_dict(),
        "model_nerf_fine_state_dict": state.models["fine"].state_dict(),
        "model_embedding_state_dict": ({} if state.tables is None
                                       else state.tables.state_dict()),
        "optimizer_state_dict": state.optimizer.state_dict(),
        "scheduler_state_dict": state.scheduler.state_dict(),
    }


def save_checkpoint(directory: str | Path, state: TrainState,
                    max_to_keep: int = 3) -> Path:
    """Write ``<directory>/<step>.ckpt`` (through a temporary file, so a
    kill leaves no partial checkpoint) and delete all but the
    ``max_to_keep`` newest."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = checkpoint_path(directory, state.step)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(state_dict(state), tmp)
    os.replace(tmp, path)
    for step in _steps(directory)[:-max_to_keep]:
        checkpoint_path(directory, step).unlink()
    return path


def latest_step(directory: str | Path) -> Optional[int]:
    """The newest step saved in ``directory``, None if there is none."""
    steps = _steps(Path(directory))
    return steps[-1] if steps else None


def _strip_ddp_prefix(sd: dict) -> dict:
    # reference DDP checkpoints prefix every key (util.py:204-210)
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def _place_schedule(scheduler, step: int) -> None:
    """Put a LambdaLR at ``step`` as ``step`` calls of ``step()`` would."""
    scheduler.last_epoch = step
    scheduler._step_count = step + 1
    lrs = [base * lam(step) for base, lam in zip(scheduler.base_lrs,
                                                scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs


def restore_file(path: str | Path, state: TrainState) -> TrainState:
    """Load the checkpoint file ``path`` into ``state`` in place; shapes
    must match the state's (``load_state_dict`` with ``strict=True``)."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
    for key in ("coarse", "fine"):
        state.models[key].load_state_dict(
            _strip_ddp_prefix(ckpt[f"model_nerf_{key}_state_dict"]))
    if state.tables is not None:
        state.tables.load_state_dict(
            _strip_ddp_prefix(ckpt["model_embedding_state_dict"]))
    step = int(ckpt.get("iter", 0))
    opt_sd = ckpt.get("optimizer_state_dict") or {}
    if opt_sd:
        state.optimizer.load_state_dict(opt_sd)
    else:
        state.optimizer.state.clear()
    sched_sd = ckpt.get("scheduler_state_dict")
    if sched_sd:
        state.scheduler.load_state_dict(sched_sd)
    else:
        _place_schedule(state.scheduler, step)
    state.step = step
    return state


def restore_checkpoint(directory: str | Path, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Restore step ``step`` (default: the newest) of ``directory`` into
    ``state`` in place."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    return restore_file(checkpoint_path(directory, step), state)


def load_checkpoint(path: str | Path, state: TrainState) -> TrainState:
    """``runtime.load_checkpoint``: a directory (its newest step) or one
    ``.ckpt`` file, into ``state`` in place."""
    path = Path(path)
    if path.is_dir():
        return restore_checkpoint(path, state)
    return restore_file(path, state)
