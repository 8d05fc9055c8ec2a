"""codenerf_tpu_torch — the PyTorch/CUDA port of ``codenerf_tpu``.

The package mirrors the JAX package's layout (``config/``, ``core/``,
``data/``, ``models/``, ``ops/``, ``eval/``, ``train/``, ``utils/``,
``pipeline.py``, ``harness.py``; ``train_cli.py`` and ``eval_cli.py``
are ``train.py``'s and ``eval.py``'s counterparts, ``tools/`` the root
``tools/``'s) so that each module has an obvious counterpart, but it
imports only torch, numpy and the standard library: never ``jax``,
``imageio``, ``PIL``, ``triton`` or any module of ``codenerf_tpu`` or the
root ``tools/``, and ``yaml`` only inside ``config.load_config``, which
reads with ``yaml_lite`` where PyYAML is missing.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  The
hand-written CUDA kernels (``ops/csrc/``) run for CUDA tensors; their plain
PyTorch versions run for CPU tensors, which is how the CPU tests hold the
port against the JAX package.
"""

__version__ = "0.1.0"
