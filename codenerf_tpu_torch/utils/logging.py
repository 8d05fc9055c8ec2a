"""Metrics logging: console lines, metrics.jsonl and TensorBoard where it
can be imported (counterpart of ``codenerf_tpu/utils/logging.py``;
reference util.py:238-264).

The console format and the JSONL records are the JAX package's
(``[TRAIN ]`` / ``[VAL   ]`` / ``[VALOPT]`` prefixes).  Output is written
by rank 0 only: the rank of ``torch.distributed`` when it is initialised,
else 0.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def process_index() -> int:
    """This process's rank: ``torch.distributed``'s when initialised, else
    0.  It decides only who writes (the console, ``metrics.jsonl``,
    checkpoints).  It seeds nothing: every rank of a world draws from the
    same seeds, as every device of JAX's one-host mesh does (JAX's
    ``process_index`` is the host, not the device)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return process_index() == 0


_PREFIX = {"train": "[TRAIN ]", "val": "[VAL   ]", "val-optim": "[VALOPT]"}


class MetricLogger:
    """Scalars to metrics.jsonl and TensorBoard (if it imports); images to
    TensorBoard."""

    def __init__(self, logdir: str | Path, enable_tensorboard: bool = True):
        self.logdir = Path(logdir)
        self._tb = None
        self._jsonl = None
        if not is_main_process():
            return
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self._tb = SummaryWriter(str(self.logdir))

    def log_scalars(self, mode: str, step: int, scalars: dict,
                    time_taken: Optional[float] = None,
                    learning_rate: Optional[float] = None) -> str:
        """Log and return the formatted console line (reference
        log_losses)."""
        line = (f"{_PREFIX.get(mode, '[' + mode.upper()[:6].ljust(6) + ']')}"
                f" Iter: {step:>8} ")
        if time_taken is not None:
            line += f"Time taken: {time_taken:>4.4f} "
        if learning_rate is not None:
            line += f"Learning rate: {learning_rate:0.8f} "
        for key, val in scalars.items():
            line += f"{key}: {float(val):>4.4f} "
        if self._jsonl is not None:
            rec = {"mode": mode, "step": step,
                   **{k: float(v) for k, v in scalars.items()}}
            if learning_rate is not None:
                rec["learning_rate"] = learning_rate
            if time_taken is not None:
                rec["time_taken"] = time_taken
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for key, val in scalars.items():
                self._tb.add_scalar(f"{mode}/{key}", float(val), step)
            if learning_rate is not None:
                self._tb.add_scalar("train/learning_rate", learning_rate,
                                    step)
        return line

    def log_image(self, tag: str, step: int, image) -> None:
        """image: [H, W, 3] floats in [0, 1], an array or a tensor."""
        if self._tb is not None:
            if torch.is_tensor(image):
                image = image.detach().cpu().numpy()
            self._tb.add_image(tag, np.asarray(image), step,
                               dataformats="HWC")

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
