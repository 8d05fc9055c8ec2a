"""Data parallelism over rays (counterpart of
``codenerf_tpu/parallel/mesh.py``; reference train.py:145-177,
util.py:139-142).

JAX runs one program over a device mesh: the ray axis is sharded over
the mesh's "data" axis, parameters are replicated, and XLA inserts the
gradient all-reduce.  The port runs one process per GPU instead, each a
rank of a ``torch.distributed`` process group, and says each of those
steps explicitly:

  * every rank builds the same global ray batch (the same seeds) and
    takes its contiguous slice of the ray axis (``shard_rays``, or
    ``shard_chunked_rays`` for [C, Rc] chunked batches: each chunk split
    over the ranks, the chunks walked in lockstep);
  * parameters are replicated: equal on every rank from the same seed,
    and made so by ``broadcast_`` from rank 0 after a restore;
  * gradients are summed by ``all_reduce_grads`` after the backward, in
    one flat buffer per dtype;
  * a rendered chunk comes back in ray order by ``all_gather_rays``.

A ``World`` says who this rank is.  ``None`` means one device, as JAX's
``mesh=None`` does; every function here is then the identity.  A world
of size 1 runs the same code path as a larger one (its collectives are
identities), so it computes what no world computes, bit for bit.

The collectives are explicit and are not ``DistributedDataParallel``'s:
the train step backpropagates once per ray chunk and once more for the
code regularizer, which must not be summed over the ranks, and the
models are reached through functions, not through one module's forward.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Iterable, Optional

import torch
import torch.distributed as dist

# a collective that waits longer than this raises (gloo and NCCL)
TIMEOUT = timedelta(minutes=10)
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class World:
    """This process's rank of ``size`` ranks and the device it computes
    on."""
    rank: int
    size: int
    device: torch.device


_current: Optional[World] = None


def world_size(world: Optional[World]) -> int:
    return 1 if world is None else world.size


def init_world(num_devices: int = 0, backend: Optional[str] = None,
               device=None) -> Optional[World]:
    """Join this process's process group and return its ``World``.

    Returns the world already joined, if any.  Otherwise, with torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) it joins that group; without it, ``num_devices`` 0
    or 1 means one device and returns None, and more raises: the ranks
    must be started first (``train_cli -g N``, or torchrun).
    ``num_devices`` > 0 is a cap that must equal the world's size, as
    ``runtime.num_devices`` caps JAX's mesh.  The backend defaults to
    ``nccl`` on CUDA and ``gloo`` on the CPU, the device to
    ``cuda:LOCAL_RANK`` (``device="cuda"`` means the same; ``"cpu"`` the
    CPU).  Both are taken as given: two gloo ranks may share ``cuda:0``.
    """
    global _current
    if _current is not None:
        _check_cap(num_devices, _current.size)
        return _current
    if not all(k in os.environ for k in _ENV):
        if num_devices > 1:
            raise RuntimeError(
                f"{num_devices} devices asked for, but no process group: "
                f"start {num_devices} ranks with `train_cli -g "
                f"{num_devices}`, or under torchrun")
        return None
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    _check_cap(num_devices, size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device is None or torch.device(device) == torch.device("cuda"):
        device = torch.device("cuda", local_rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=size, timeout=TIMEOUT, **kwargs)
    _current = World(rank, size, dev)
    return _current


def _check_cap(num_devices: int, size: int) -> None:
    if num_devices and num_devices != size:
        raise RuntimeError(f"runtime.num_devices={num_devices} in a world "
                           f"of {size} ranks")


def close_world() -> None:
    """Leave the process group ``init_world`` joined."""
    global _current
    if _current is not None:
        dist.destroy_process_group()
        _current = None


def _slice(world: Optional[World], n: int) -> slice:
    if world is None:
        return slice(0, n)
    if n % world.size:
        raise ValueError(f"{n} rays do not split over {world.size} ranks")
    per = n // world.size
    return slice(world.rank * per, (world.rank + 1) * per)


def _one_or_tuple(out: tuple):
    return out if len(out) > 1 else out[0]


def shard_rays(world: Optional[World], *arrays):
    """This rank's contiguous slice of the leading (ray) axis of global
    [R, ...] arrays (``None`` passes through); raises if the world's
    size does not divide R."""
    out = tuple(None if a is None else a[_slice(world, a.shape[0])]
                for a in arrays)
    return _one_or_tuple(out)


def shard_chunked_rays(world: Optional[World], *arrays):
    """This rank's slice of each chunk of [C, Rc, ...] chunked ray arrays:
    axis 1 split over the ranks, the chunk axis kept (JAX mesh.py:40-50)."""
    out = tuple(None if a is None else a[:, _slice(world, a.shape[1])]
                for a in arrays)
    return _one_or_tuple(out)


@torch.no_grad()
def _coalesced(world: World, tensors: list, collective) -> None:
    """Run ``collective`` on one flat buffer per dtype on the world's
    device and copy the result back into ``tensors``."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = torch.cat([t.detach().reshape(-1).to(world.device)
                          for t in group])
        collective(flat)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_(world: Optional[World], tensors: Iterable[torch.Tensor],
                op=dist.ReduceOp.SUM) -> None:
    """Reduce ``tensors`` over the ranks (a sum unless ``op`` says
    otherwise), in place."""
    if world is None:
        return
    _coalesced(world, [t for t in tensors],
               lambda flat: dist.all_reduce(flat, op=op))


def all_reduce_grads(world: Optional[World],
                     params: Iterable[torch.Tensor]) -> None:
    """Sum the gradients of ``params`` over the ranks, in one flat buffer
    per dtype.  Parameters without a gradient are skipped: every rank runs
    the same code, so the same ones have none."""
    all_reduce_(world, [p.grad for p in params if p.grad is not None])


def broadcast_(world: Optional[World], tensors: Iterable[torch.Tensor]
               ) -> None:
    """Overwrite ``tensors`` with rank 0's, in place (any device: each
    passes through the world's device)."""
    if world is None:
        return
    _coalesced(world, [t for t in tensors],
               lambda flat: dist.broadcast(flat, src=0))


def all_gather_rays(world: Optional[World], x: torch.Tensor
                    ) -> torch.Tensor:
    """Every rank's [n, ...] slice of the ray axis, concatenated in rank
    (ray) order: [W * n, ...] on every rank."""
    if world is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def barrier(world: Optional[World]) -> None:
    if world is not None:
        dist.barrier()
