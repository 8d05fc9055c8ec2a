"""The CodeNeRF train step (counterpart of ``codenerf_tpu/train``):
optimizer, state and one step over a ray batch."""

from codenerf_tpu_torch.train.optim import build_optimizer  # noqa: F401
from codenerf_tpu_torch.train.state import (  # noqa: F401
    TrainState, init_train_state)
from codenerf_tpu_torch.train.step import (  # noqa: F401
    StepMetrics, gather_ray_batch, make_train_step)
