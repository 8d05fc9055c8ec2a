"""codenerf_tpu_torch — the PyTorch/CUDA port of ``codenerf_tpu``.

The package mirrors the JAX package's layout (``core/``, ``models/``,
``ops/``, ``eval/``, ``pipeline.py``) so that each module has an obvious
counterpart, but it imports only torch, numpy and the standard library:
never ``jax``, ``yaml``, ``triton`` or any module of ``codenerf_tpu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  The
hand-written CUDA kernels (``ops/csrc/``) run for CUDA tensors; their plain
PyTorch versions run for CPU tensors, which is how the CPU tests hold the
port against the JAX package.
"""

__version__ = "0.1.0"
