"""Tools around the CLIs (counterparts of the JAX package's ``tools/``);
each runs as ``python3 -m codenerf_tpu_torch.tools.<name>``."""
