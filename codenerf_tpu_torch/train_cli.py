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
``--platform``.  ``-g`` caps the devices as in ``train.py``; the port
trains on one, so a cap above 1 raises until multi-GPU lands.
``--distributed`` is a no-op, as in ``train.py``.  The overrides
``runtime.int8_serving=true`` and ``runtime.int8_encode=true`` add the
int8 serving render to each validation.  Checkpoints are
``<logdir>/<id>/checkpoints/<step>.ckpt`` in the reference's layout.
"""

import argparse
import dataclasses


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
    parser.add_argument("overrides", nargs="*",
                        help="Dotted config overrides, e.g. optimizer.lr=3e-4")
    args = parser.parse_args(argv)

    from codenerf_tpu_torch.config import load_config
    from codenerf_tpu_torch.train.loop import run_training

    cfg = load_config(args.config, overrides=args.overrides)
    if args.load_checkpoint:
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(
                cfg.runtime, load_checkpoint=args.load_checkpoint))
    if args.gpus:
        cfg = dataclasses.replace(
            cfg, runtime=dataclasses.replace(cfg.runtime,
                                             num_devices=args.gpus))
    return run_training(cfg, max_steps=args.max_steps, device=args.device)


if __name__ == "__main__":
    main()
