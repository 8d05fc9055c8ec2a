"""Start a world of ranks on one machine: the entry module of every
spawned rank (the reference's ``mp.spawn``, train.py:145-177, in the
one-process-per-GPU idiom).

``spawn(fn, nprocs, args)`` starts ``nprocs`` processes with
``torch.multiprocessing``'s spawn method (never fork: a forked child
inherits the parent's CUDA state), each of which joins the group at a
free localhost port as torchrun's environment would describe it, runs
``fn(world, *args)`` and leaves the group.  Rank r computes on
``devices[r]``.  The parent waits with a deadline: when a rank raises,
the others are terminated (none is left waiting in a collective) and the
rank's traceback is raised; past the deadline every rank is terminated
and ``TimeoutError`` is raised.  Each rank's return value comes back
through a file in a temporary directory.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp

from codenerf_tpu_torch.parallel import mesh


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def devices_for(nprocs: int, device="cuda") -> list:
    """One device per rank: ``cuda:0..N-1`` for "cuda", else ``device``
    for every rank (the CPU, or one card shared by gloo ranks)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", r) for r in range(nprocs)]
    return [dev] * nprocs


def _rank_main(rank: int, fn: Callable, nprocs: int, port: int,
               backend: Optional[str], devices: list, args: tuple,
               out_dir: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    if devices[rank].type == "cpu":
        # the ranks share the machine's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // nprocs))
    world = mesh.init_world(nprocs, backend=backend, device=devices[rank])
    try:
        result = fn(world, *args)
    finally:
        mesh.close_world()
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          backend: Optional[str] = None, devices: Optional[list] = None,
          timeout: float = 3600.0) -> list:
    """Run ``fn(world, *args)`` on ``nprocs`` spawned ranks and return
    their results in rank order.  ``fn`` and ``args`` must pickle (a
    module-level function).  ``devices`` defaults to ``cuda:0..N-1``;
    ``backend`` to ``nccl`` on CUDA and ``gloo`` on the CPU."""
    devices = [torch.device(d) for d in (devices or devices_for(nprocs))]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
    with tempfile.TemporaryDirectory(prefix="codenerf_ranks_") as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, free_port(), backend, devices,
                              tuple(args), out_dir),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout} s; killed")
        return [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False)
                for r in range(nprocs)]
