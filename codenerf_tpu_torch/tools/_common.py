"""The set-up the checkpoint tools share: the config with its dotted
overrides, the harness on the requested device and a train state restored
from a reference-layout ``.ckpt`` (``train/checkpoint.py``)."""

from __future__ import annotations

import argparse


def checkpoint_args(ap: argparse.ArgumentParser) -> None:
    """The flags of a tool that restores a checkpoint: ``-c``,
    ``--load-checkpoint``, ``--num-objects``, ``--device`` and the
    trailing dotted overrides."""
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--load-checkpoint", required=True,
                    help="a .ckpt file, or a directory (its newest step)")
    ap.add_argument("--num-objects", type=int, default=None,
                    help="rows of the checkpoint's code tables when the "
                         "train split does not hold that many objects")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; it raises without a "
                         "card unless --device cpu is given)")
    ap.add_argument("overrides", nargs="*",
                    help="dotted config overrides, e.g. dataset.basedir=...")


def restore(args):
    """(cfg, harness, state): the config, the harness on ``args.device``
    and a train state with ``args.load_checkpoint`` loaded into it."""
    from codenerf_tpu_torch.config import load_config
    from codenerf_tpu_torch.harness import Harness
    from codenerf_tpu_torch.train.checkpoint import load_checkpoint
    from codenerf_tpu_torch.train.state import init_train_state

    cfg = load_config(args.config, overrides=args.overrides)
    harness = Harness.from_config(cfg, device=args.device)
    state = init_train_state(
        cfg, harness.settings,
        args.num_objects or harness.train_dataset.num_objects,
        device=harness.device)
    load_checkpoint(args.load_checkpoint, state)
    return cfg, harness, state
