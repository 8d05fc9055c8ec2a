"""Evaluate a trained model with the port (counterpart of ``eval.py``;
reference eval.py:245-266): CodeNeRF by test-time optimization, vanilla
NeRF by the render at each validation view's ground-truth pose:

    python3 -m codenerf_tpu_torch.eval_cli -c configs/srn-cars-code.yml \\
        --load-checkpoint DIR_OR_CKPT [--all-objects] [--batch-objects K] \\
        [--tto-views V] [--num-objects N] [--rounds N] [--device cuda] \\
        [overrides like dataset.basedir=... ...]

The flags are ``eval.py``'s, with ``--device`` (default ``cuda``; it
raises without a card unless ``--device cpu`` is given) in place of
``--platform``.  ``--load-checkpoint`` takes a reference-layout ``.ckpt``
file or a checkpoint directory (its newest step).  ``--all-objects`` runs
the category protocol (``harness.validate_category``), ``--batch-objects``
alone one batched group (``validate_batched``), neither the reference's
``validate`` rounds (the only mode of a vanilla model: the other two
refuse it, as JAX's do).  ``--num-objects`` sizes the code tables from the
checkpoint when the val split's train directory holds none (TTO starts
from the tables' mean).  ``--multihost`` joins torchrun's process group
(``torchrun --nproc-per-node N -m codenerf_tpu_torch.eval_cli --multihost
...``): every rank solves the same objects on its share of the rays,
with the state broadcast from rank 0, and rank 0 prints the results.
With ``runtime.int8_serving=true`` (and ``runtime.int8_encode=true``)
among the overrides, every mode also renders through the int8 serving
path and reports its PSNR and SSIM (the category table's ``int8 PSNR``
column).
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate a trained CodeNeRF model by test-time "
                    "optimization with the PyTorch port.")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="Path to (.yml) config file.")
    parser.add_argument("--load-checkpoint", type=str, required=True,
                        help="Checkpoint .ckpt file or directory (its newest "
                             "step).")
    parser.add_argument("--rounds", type=int, default=None,
                        help="Number of validation rounds (default: "
                             "iterations // val_batch_size as the reference).")
    parser.add_argument("--batch-objects", type=int, default=0,
                        help="Solve this many val objects' TTO problems in "
                             "one batched step stream (0 = the reference's "
                             "per-object rounds).")
    parser.add_argument("--all-objects", action="store_true",
                        help="Category protocol: TTO and render for every "
                             "distinct val object in --batch-objects groups, "
                             "with a per-object table and the means.")
    parser.add_argument("--tto-views", type=int, default=1,
                        help="Multi-view TTO: optimize each object's codes "
                             "against this many val views jointly.")
    parser.add_argument("--num-objects", type=int, default=None,
                        help="Rows of the checkpoint's code tables when they "
                             "differ from the train split's object count.")
    parser.add_argument("--multihost", action="store_true",
                        help="Join torchrun's process group: the ranks "
                             "split every step's rays.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to evaluate on (cuda or cpu).")
    parser.add_argument("overrides", nargs="*",
                        help="Dotted config overrides, e.g. "
                             "dataset.basedir=data/srn_cars")
    args = parser.parse_args(argv)

    from codenerf_tpu_torch.parallel import close_world, init_world

    if args.multihost:
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "--multihost joins torchrun's process group: run it under "
                "torchrun (WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT "
                "are not set)")
        init_world(device=args.device)
    try:
        return _evaluate(args)
    finally:
        close_world()


def _evaluate(args):
    from codenerf_tpu_torch.config import load_config
    from codenerf_tpu_torch.harness import (Harness, validate,
                                            validate_batched,
                                            validate_category)
    from codenerf_tpu_torch.train.checkpoint import load_checkpoint
    from codenerf_tpu_torch.train.state import (broadcast_train_state,
                                                init_train_state)
    from codenerf_tpu_torch.utils.logging import MetricLogger, is_main_process

    cfg = load_config(args.config, overrides=args.overrides)
    harness = Harness.from_config(cfg, device=args.device)
    logger = MetricLogger(harness.logdir)
    state = init_train_state(
        cfg, harness.settings,
        args.num_objects or harness.train_dataset.num_objects,
        seed=cfg.experiment.randomseed, device=harness.device)
    state = load_checkpoint(args.load_checkpoint, state)
    broadcast_train_state(harness.world, state)
    if is_main_process():
        print(f"Restored checkpoint at step {state.step}")
    params = {**state.models, "codes": state.tables}

    if args.all_objects:
        out = validate_category(harness, params, logger,
                                args.batch_objects or 4,
                                tto_views=args.tto_views)
    elif args.batch_objects:
        out = validate_batched(harness, params, logger, args.batch_objects,
                               tto_views=args.tto_views)
    else:
        rounds = args.rounds
        if rounds is None:
            rounds = max(1, cfg.experiment.iterations
                         // max(1, cfg.dataset.val_batch_size))
        out = [validate(harness, params, logger, i) for i in range(rounds)]
    logger.close()
    return out

if __name__ == "__main__":
    main()
