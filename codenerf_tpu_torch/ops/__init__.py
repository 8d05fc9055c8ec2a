"""Sampling, compositing and the fused trunk (counterpart of
``codenerf_tpu/ops``).  The CUDA kernels are built and loaded on first
use (``ops/_build.py``), never at import."""
