"""The CodeNeRF and vanilla NeRF train step (counterpart of
``codenerf_tpu/train``): optimizer, state, one step over a ray batch,
checkpoints and the train loop (``train.loop``, imported on its own: it
builds on the harness)."""

from codenerf_tpu_torch.train.optim import (  # noqa: F401
    build_optimizer, lr_at_step)
from codenerf_tpu_torch.train.state import (  # noqa: F401
    TrainState, has_codes, init_train_state)
from codenerf_tpu_torch.train.step import (  # noqa: F401
    StepMetrics, gather_ray_batch, make_train_step)
from codenerf_tpu_torch.train import checkpoint  # noqa: F401
