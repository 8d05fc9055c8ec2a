"""The training loop (counterpart of ``codenerf_tpu/train/loop.py``;
reference train.py:19-142).

Line for line the JAX package's loop: the step count from the config,
restore from ``runtime.load_checkpoint`` or auto-resume from the newest
checkpoint, a clean save-and-exit on SIGTERM / SIGINT, console and JSONL
lines every ``print_every`` steps, checkpoints every ``save_every`` steps
and at the end, ``validate`` every ``validate_every`` steps, batches
decoded and shipped to the device by a ``PrefetchIterator`` of depth 2.

Seeds, as the JAX package's on one host: the models and code tables are
drawn from ``randomseed + 1``, and the ray generator is seeded the same
way at every launch, as JAX re-splits its key from the seed at every
launch; no generator state is saved.  In a world (the harness's, JAX's
mesh) every rank uses these seeds, so every rank draws the same batch
and rays and splits them; the state is broadcast from rank 0 after the
init and the restore, every rank validates with the world, and rank 0
alone writes checkpoints and logs, with a barrier before the call
returns.
``runtime.profile_dir`` records a ``torch.profiler`` trace of steps
[start + 5, start + 10) as a Chrome trace, the counterpart of
``jax.profiler``, with the port's spans (``utils/trace.py``: the steps'
phases, the loader's, and this loop's ``loop.log``, ``loop.checkpoint``
and ``loop.validate``) recorded over the same steps and written into it
as ``program_span`` events on the trace's clock.
"""

from __future__ import annotations

import json
import os
import signal
import time
from pathlib import Path
from typing import Optional

import torch

from codenerf_tpu_torch.config import Config
from codenerf_tpu_torch.data import PrefetchIterator
from codenerf_tpu_torch.harness import Harness, validate
from codenerf_tpu_torch.parallel.mesh import barrier
from codenerf_tpu_torch.train import checkpoint
from codenerf_tpu_torch.train.optim import lr_at_step
from codenerf_tpu_torch.train.state import (broadcast_train_state,
                                            init_train_state)
from codenerf_tpu_torch.train.step import make_train_step
from codenerf_tpu_torch.utils import trace
from codenerf_tpu_torch.utils.logging import MetricLogger, is_main_process


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    trace.enable()
    return prof


def _stop_profiler(prof, device: torch.device, profile_dir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    trace.disable()
    out = Path(profile_dir) / "trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    doc = json.loads(out.read_text())
    doc["traceEvents"] += trace.chrome_events(
        trace.drain(), doc["baseTimeNanoseconds"], os.getpid())
    out.write_text(json.dumps(doc))
    print(f"profiler trace written to {out}")


def run_training(cfg: Config, max_steps: Optional[int] = None,
                 harness: Optional[Harness] = None,
                 device="cuda") -> dict:
    """Train per the config on ``device``; returns the last logged
    metrics (and ``val_*`` ones after a validation).

    ``max_steps`` caps the steps this call takes (for smoke runs).
    """
    harness = harness or Harness.from_config(cfg, device=device)
    dev = harness.device
    logger = MetricLogger(harness.logdir)

    seed = cfg.experiment.randomseed + 1
    state = init_train_state(cfg, harness.settings,
                             harness.train_dataset.num_objects, seed=seed,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    ckpt_dir = harness.logdir / "checkpoints"
    if cfg.runtime.load_checkpoint:
        checkpoint.load_checkpoint(cfg.runtime.load_checkpoint, state)
    elif checkpoint.latest_step(ckpt_dir) is not None:
        checkpoint.restore_checkpoint(ckpt_dir, state)
    broadcast_train_state(harness.world, state)

    train_step = make_train_step(
        harness.settings, state,
        num_random_rays=cfg.nerf.ray_sampler.num_random_rays,
        regularizer_lambda=cfg.experiment.regularizer_lambda,
        perturb=cfg.nerf.point_sampler.perturb,
        ray_chunks=cfg.runtime.ray_chunks,
        use_checkify=cfg.runtime.checkify, world=harness.world)

    # one step consumes a whole image batch, so the reference's dataloader
    # count is the step count (train.py:61-62)
    total_steps = cfg.experiment.iterations // max(
        1, cfg.dataset.train_batch_size)
    if max_steps is not None:
        total_steps = min(total_steps, state.step + max_steps)

    # on SIGTERM / SIGINT: finish the step, save, exit; the next launch
    # resumes from the checkpoint
    interrupted = {"flag": False}

    def _request_stop(signum, frame):
        interrupted["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _request_stop)
        except ValueError:
            pass  # not the main thread (e.g. under a test runner)

    start_step = state.step
    metrics_out = {}
    rays_per_step = (cfg.nerf.ray_sampler.num_random_rays
                     * cfg.dataset.train_batch_size)
    train_stream = PrefetchIterator(harness.train_iter, depth=2, device=dev)
    prof_start = start_step + 5 if cfg.runtime.profile_dir else -1
    prof_stop = prof_start + 5
    prof = None
    then = time.time()
    try:
        for step_idx in range(start_step, total_steps):
            if step_idx == prof_start:
                prof = _start_profiler(dev)
            elif step_idx == prof_stop and prof is not None:
                _stop_profiler(prof, dev, cfg.runtime.profile_dir)
                prof = None
            batch = next(train_stream)
            metrics = train_step(harness.directions, batch["pose"],
                                 batch["color"], batch["object_id"], gen)

            i = step_idx + 1
            if is_main_process() and i % cfg.experiment.print_every == 0:
                with trace.span("loop.log"):
                    m = {k: float(v) for k, v in metrics._asdict().items()}
                    dt = time.time() - then
                    lr = lr_at_step(cfg.optimizer.lr,
                                    cfg.optimizer.scheduler_gamma,
                                    cfg.optimizer.scheduler_step_size, i)
                    line = logger.log_scalars("train", i, {
                        "nerf_loss_coarse": m["loss_coarse"],
                        "nerf_loss_fine": m["loss_fine"],
                        "embedding_loss": m["loss_embedding"],
                        "total_loss": m["loss"],
                        "psnr": m["psnr"],
                        "rays_per_sec": rays_per_step
                        * cfg.experiment.print_every / max(dt, 1e-9)},
                        time_taken=dt, learning_rate=lr)
                    print(line)
                    # target-image panel, as the reference logs
                    # (train.py:126)
                    logger.log_image("train/target_image", i,
                                     batch["color"][0][..., :3])
                then = time.time()
                metrics_out = m

            if is_main_process() and (i % cfg.experiment.save_every == 0
                                      or i == total_steps):
                with trace.span("loop.checkpoint"):
                    checkpoint.save_checkpoint(ckpt_dir, state)
                print("================== Saved Checkpoint "
                      "=================")

            if i % cfg.experiment.validate_every == 0 and i < total_steps:
                with trace.span("loop.validate"):
                    val_m = validate(harness, {**state.models,
                                               "codes": state.tables},
                                     logger, i)
                metrics_out.update({f"val_{k}": v for k, v in val_m.items()})

            if interrupted["flag"]:
                if is_main_process():
                    checkpoint.save_checkpoint(ckpt_dir, state)
                    print(f"=== interrupted: checkpoint saved at step {i}; "
                          "relaunch to resume ===")
                break
    finally:
        train_stream.close()
        if prof is not None:
            _stop_profiler(prof, dev, cfg.runtime.profile_dir)
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        logger.close()
    # rank 0's last checkpoint is on disk before any rank goes on
    barrier(harness.world)
    return metrics_out
