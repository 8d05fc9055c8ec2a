"""Train a CodeNeRF or vanilla NeRF model with the port (counterpart of
``train.py``):

    python3 -m codenerf_tpu_torch.train_cli -c configs/srn-cars-code.yml \\
        [--load-checkpoint DIR_OR_CKPT] [--max-steps N] [--device cuda] \\
        [overrides like optimizer.lr=3e-4 ...]

Every config in ``configs/`` runs: CodeNeRF on SRN, and vanilla NeRF
(FlexibleNeRF) on Blender (``lego.yml``), LLFF with NDC rays
(``fern.yml``) and SRN (``srn-cars.yml``, ``srn-chairs.yml``).

The flags are ``train.py``'s, with ``--device`` (default ``cuda``; it
raises without a card unless ``--device cpu`` is given) in place of
``--platform``.  ``-g N`` is the data-parallel world's size, as it caps
``train.py``'s mesh: with N > 1 outside torchrun the CLI starts N ranks
(``parallel.launch.spawn``: spawned processes, one per card on
``cuda:0..N-1``, NCCL; or N gloo ranks under ``--device cpu``), each of
which trains on its share of every ray batch; under torchrun
(``torchrun --nproc-per-node N -m codenerf_tpu_torch.train_cli ...``)
each process joins torchrun's group.  ``--multihost`` (``train.py``'s
flag, which calls ``jax.distributed.initialize()``) joins torchrun's
group as ``eval_cli --multihost`` does: without torchrun's environment
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) it raises,
and together with ``-g N`` it raises rather than spawn.  Rank 0 writes
the checkpoints and the logs, and its metrics are returned.
``--distributed`` is a no-op, as in ``train.py``.  The overrides
``runtime.int8_serving=true`` and ``runtime.int8_encode=true`` add the
int8 serving render to each validation.  Checkpoints are
``<logdir>/<id>/checkpoints/<step>.ckpt`` in the reference's layout.
"""

import argparse
import dataclasses
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a (Code)NeRF model with the PyTorch port.")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="Path to (.yml) config file.")
    parser.add_argument("--load-checkpoint", type=str, default="",
                        help="Checkpoint directory or .ckpt file to resume "
                             "from.")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="Cap the number of training steps (smoke runs).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to train on (cuda or cpu).")
    parser.add_argument("-g", "--gpus", type=int, default=0,
                        help="Cap the number of devices used (reference -g "
                             "flag; 0 = all).")
    parser.add_argument("--distributed", action="store_true",
                        help="Compat no-op (reference flag).")
    parser.add_argument("--multihost", action="store_true",
                        help="Join torchrun's process group: the ranks "
                             "split every step's rays.")
    parser.add_argument("overrides", nargs="*",
                        help="Dotted config overrides, e.g. optimizer.lr=3e-4")
    args = parser.parse_args(argv)

    from codenerf_tpu_torch.config import load_config
    from codenerf_tpu_torch.parallel import close_world, init_world, launch
    from codenerf_tpu_torch.train.loop import run_training

    torchrun = "WORLD_SIZE" in os.environ
    if args.multihost and not all(k in os.environ for k in (
            "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")):
        raise RuntimeError(
            "--multihost joins torchrun's process group: run it under "
            "torchrun (WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT "
            "are not set)")
    cfg = load_config(args.config, overrides=args.overrides)
    if args.load_checkpoint:
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(
                cfg.runtime, load_checkpoint=args.load_checkpoint))
    if args.gpus:
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime,
                                             num_devices=args.gpus))
    if args.gpus > 1 and not torchrun:
        devices = launch.devices_for(args.gpus, args.device)
        if devices[0].type == "cuda":
            import torch
            from codenerf_tpu_torch.device import resolve_device
            resolve_device(devices[0])
            if torch.cuda.device_count() < args.gpus:
                raise RuntimeError(f"-g {args.gpus}: "
                                   f"{torch.cuda.device_count()} CUDA "
                                   "devices visible")
        return launch.spawn(_train_rank, args.gpus, (cfg, args.max_steps),
                            devices=devices)[0]
    try:
        if args.multihost:
            init_world(device=args.device)
        return run_training(cfg, max_steps=args.max_steps,
                            device=args.device)
    finally:
        close_world()


def _train_rank(world, cfg, max_steps):
    """One spawned rank of ``-g N``: ``run_training`` in ``world``."""
    from codenerf_tpu_torch.train.loop import run_training
    return run_training(cfg, max_steps=max_steps, device=world.device)


if __name__ == "__main__":
    main()
