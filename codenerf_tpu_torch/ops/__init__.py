"""Sampling, compositing and the fused trunk (counterpart of
``codenerf_tpu/ops``).  The CUDA kernels are built and loaded on first
use (``ops/_build.py``), never at import."""

import contextlib


@contextlib.contextmanager
def plain_versions():
    """Rebind the kernels' wrappers (``fused.trunk_forward``,
    ``fused.trunk_backward``, ``layer_bwd.linear_relu_bwd``,
    ``layer_fwd.linear_relu_fwd``) to their plain versions, so that the
    port's own entry points run the same path on CUDA tensors without the
    kernels: the references ``chip_smoke.py`` and ``tools/gpu_selftest.py``
    hold the kernels against."""
    from codenerf_tpu_torch.ops import fused, layer_bwd, layer_fwd
    saved = (fused.trunk_forward, fused.trunk_backward,
             layer_bwd.linear_relu_bwd, layer_fwd.linear_relu_fwd)
    fused.trunk_forward = fused.trunk_forward_plain
    fused.trunk_backward = fused.trunk_backward_plain
    layer_bwd.linear_relu_bwd = layer_bwd.linear_relu_bwd_plain
    layer_fwd.linear_relu_fwd = layer_fwd.linear_relu_fwd_plain
    try:
        yield
    finally:
        (fused.trunk_forward, fused.trunk_backward,
         layer_bwd.linear_relu_bwd, layer_fwd.linear_relu_fwd) = saved
