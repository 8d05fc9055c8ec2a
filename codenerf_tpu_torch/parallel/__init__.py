"""Data parallelism over rays through ``torch.distributed`` (counterpart
of ``codenerf_tpu/parallel``); ``parallel.launch`` starts the ranks."""

from codenerf_tpu_torch.parallel.mesh import (  # noqa: F401
    World, all_gather_rays, all_reduce_, all_reduce_grads, barrier,
    broadcast_, close_world, init_world, shard_chunked_rays, shard_rays,
    world_size)
