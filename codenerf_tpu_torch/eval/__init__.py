"""Full-image serving render (counterpart of ``codenerf_tpu/eval``)."""

from codenerf_tpu_torch.eval.render import make_image_renderer  # noqa: F401
