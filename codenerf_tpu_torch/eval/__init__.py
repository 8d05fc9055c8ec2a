"""Full-image serving render and test-time optimization (counterpart of
``codenerf_tpu/eval``)."""

from codenerf_tpu_torch.eval.render import make_image_renderer  # noqa: F401
from codenerf_tpu_torch.eval.tto import (  # noqa: F401
    BatchedTTOMetrics, TTOMetrics, TTOState, init_batched_tto_state,
    init_multiview_se3_refine_state, init_multiview_tto_state,
    init_se3_refine_state, init_tto_state, make_batched_tto_step,
    make_multiview_se3_refine_step, make_multiview_tto_step,
    make_se3_refine_step, make_tto_step, select_per_object)
