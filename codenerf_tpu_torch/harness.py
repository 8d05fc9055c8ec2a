"""Experiment harness: the shared set-up of the train entry point and its
validation pass (counterpart of ``codenerf_tpu/harness.py``; reference
train.py:19-58, eval.py:82-205, util.py:44-144).

``Harness.from_config`` holds the config, the datasets and their seeded
batch streams, the camera's direction grid, the render settings and the
logdir.  ``validate`` is the single-object validation the train loop
runs: test-time optimization (TTO) of codes and pose on a fixed
validation view, then a full-image render, its PSNR and SSIM.

The port runs on one device.  ``runtime.num_devices > 1`` (ROADMAP
Queue 1 item 6), ``runtime.int8_serving`` (item 5) and the Blender /
LLFF datasets with their NDC rays (item 4, ``data/loader.py``) raise
``NotImplementedError``.  The batched and category validators wait for
item 3.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from codenerf_tpu_torch.config import Config, dump_config
from codenerf_tpu_torch.core.geometry import pixel_directions, pose_spherical
from codenerf_tpu_torch.core.metrics import mse2psnr, ssim
from codenerf_tpu_torch.data import BatchIterator, build_dataset
from codenerf_tpu_torch.device import resolve_device
from codenerf_tpu_torch.eval.render import make_image_renderer
from codenerf_tpu_torch.eval.tto import (TTOState, init_se3_refine_state,
                                         init_tto_state,
                                         make_se3_refine_step, make_tto_step,
                                         se3_refined_poses)
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train.optim import build_tto_optimizer
from codenerf_tpu_torch.utils.logging import (MetricLogger, is_main_process,
                                              process_index)


def _refuse_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a runtime the port cannot run
    yet, naming its ROADMAP Queue 1 item."""
    if cfg.runtime.num_devices > 1:
        raise NotImplementedError(
            f"runtime.num_devices={cfg.runtime.num_devices}: the port trains "
            "on one device; multi-GPU data parallelism is ROADMAP Queue 1 "
            "item 6")
    if cfg.runtime.int8_serving:
        raise NotImplementedError(
            "runtime.int8_serving: the int8 serving path is ROADMAP Queue 1 "
            "item 5")


def generator(device, *entropy) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``entropy``
    (independent streams for distinct tuples, as ``jax.random.fold_in``
    gives the JAX package)."""
    seed = int(np.random.SeedSequence(list(entropy)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


@dataclass
class Harness:
    cfg: Config
    settings: RenderSettings
    train_dataset: object
    val_dataset: object
    train_iter: BatchIterator
    val_iter: BatchIterator
    height: int
    width: int
    directions: torch.Tensor
    logdir: Path
    device: torch.device

    @classmethod
    def from_config(cls, cfg: Config, device="cuda") -> "Harness":
        dev = resolve_device(device)
        _refuse_unported(cfg)
        # experiment dir + resolved-config dump (reference util.py:44-56)
        logdir = Path(cfg.experiment.logdir) / cfg.experiment.id
        if is_main_process():
            logdir.mkdir(parents=True, exist_ok=True)
            dump_config(cfg, logdir / "config.yml")

        train_ds = build_dataset(cfg.dataset, "train")
        val_ds = build_dataset(cfg.dataset, "val")

        # the JAX package's seeds: a train stream per process, one shared
        # validation stream
        seed = cfg.experiment.randomseed
        train_iter = BatchIterator(train_ds, cfg.dataset.train_batch_size,
                                   seed=seed + 1 + process_index())
        val_iter = BatchIterator(val_ds, cfg.dataset.val_batch_size,
                                 seed=seed)

        # one direction grid from one probe (reference train.py:51-55):
        # refuse a split whose objects carry different intrinsics rather
        # than mis-render all but the probed one
        for ds, name in ((train_ds, "train"), (val_ds, "val")):
            if len(ds) and not ds.intrinsics_homogeneous():
                raise ValueError(
                    f"the {name} split has per-object (heterogeneous) "
                    f"intrinsics; the harness builds one pixel-direction "
                    f"grid from a single probe, which would silently "
                    f"mis-render every other object.  Re-render the data "
                    f"with shared intrinsics, or evaluate per object with "
                    f"its own directions grid.")
        probe = val_ds[0] if len(val_ds) else train_ds[0]
        height, width = probe["color"].shape[:2]
        directions = pixel_directions(
            height, width, torch.from_numpy(probe["intrinsic"])).to(dev)
        return cls(cfg=cfg, settings=RenderSettings.from_config(cfg),
                   train_dataset=train_ds, val_dataset=val_ds,
                   train_iter=train_iter, val_iter=val_iter, height=height,
                   width=width, directions=directions, logdir=logdir,
                   device=dev)


def _log_every(vi: int, n: int, every: int) -> bool:
    return is_main_process() and ((vi != 0 and vi % every == 0)
                                  or vi == n - 1)


def validate(harness: Harness, params: dict, logger: MetricLogger,
             iteration: int, val_iterations: Optional[int] = None) -> dict:
    """Validation pass (reference eval.py:82-205): TTO of codes and pose
    on the 6th validation batch's first view, then a full-image render
    and its PSNR / SSIM.

    ``params``: {"coarse", "fine"} models and {"codes"} tables on the
    harness's device.  The TTO stages follow the config: multi-start pose
    probes (``pose_restarts``), the azimuth-flip rescue
    (``pose_flip_steps``) and the SE(3) refine (``se3_refine_steps``).
    Draws come from generators seeded by ``experiment.randomseed``.
    Returns {"loss", "psnr", "ssim"}.
    """
    cfg = harness.cfg
    dev = harness.device
    opt_cfg = cfg.optimizer
    n_rays = cfg.nerf.ray_sampler.num_random_rays
    lam = cfg.experiment.regularizer_lambda
    perturb = cfg.nerf.point_sampler.perturb
    seed = cfg.experiment.randomseed
    dirs = harness.directions
    # the reference always validates on the 6th val batch (eval.py:108-109)
    val_data = harness.val_iter.fixed_batch(start=5)
    target = torch.from_numpy(val_data["color"][0]).to(dev)
    pose_gt = torch.from_numpy(val_data["pose"][0]).to(dev)

    render = make_image_renderer(harness.settings, harness.height,
                                 harness.width,
                                 chunksize=cfg.nerf.validation.chunksize,
                                 device=dev)
    models = {"coarse": params["coarse"], "fine": params["fine"]}
    codes = params["codes"]

    tto, tto_opt = init_tto_state(codes, opt_cfg, device=dev)
    tto_step = make_tto_step(harness.settings, tto_opt, n_rays, lam, perturb,
                             device=dev)
    gen = generator(dev, seed)
    n_iters = (cfg.experiment.val_iterations if val_iterations is None
               else val_iterations)

    # multi-start pose TTO: probe azimuth inits briefly, continue from the
    # lowest probe loss; restart 0 is exactly the reference init
    restarts = max(1, opt_cfg.pose_restarts)
    if restarts > 1:
        probe_steps = max(1, min(opt_cfg.pose_restart_steps, n_iters))
        best = None
        for r in range(restarts):
            phi0 = 2.0 * math.pi * r / restarts
            phi0 = (phi0 + math.pi) % (2.0 * math.pi) - math.pi
            th0 = 1.57 if r == 0 else opt_cfg.pose_restart_theta
            cand, _ = init_tto_state(codes, opt_cfg, pose_init=(th0, phi0,
                                                                1.30),
                                     device=dev)
            cgen = generator(dev, seed, r)
            for _ in range(probe_steps):
                cand, m = tto_step(cand, models, dirs, target, pose_gt, cgen)
            probe_loss = float(m.loss)
            if best is None or probe_loss < best[0]:
                best = (probe_loss, cand, r)
        tto = best[1]
        if is_main_process():
            print(f"[VALOPT] pose multi-start: continuing from init "
                  f"{best[2]}/{restarts} (probe loss {best[0]:.5f})")
    then = time.time()
    for vi in range(n_iters):
        tto, m = tto_step(tto, models, dirs, target, pose_gt, gen)
        if _log_every(vi, n_iters, cfg.experiment.val_print_every):
            line = logger.log_scalars("val-optim", vi, {
                "nerf_loss_coarse": m.loss_coarse,
                "nerf_loss_fine": m.loss_fine,
                "embedding_loss": m.loss_embedding,
                "pose_error": m.pose_error,
                "total_loss": m.loss,
                "psnr": m.psnr}, time_taken=time.time() - then)
            print(line)
            then = time.time()

    # azimuth-flip rescue: retry from phi + pi with the converged codes
    # and fresh moments, judge both basins on one ray draw
    flip_steps = opt_cfg.pose_flip_steps
    if flip_steps > 0:
        v = tto.variables
        with torch.no_grad():
            flip_vars = {k: x.detach().clone() for k, x in v.items()}
            flip_vars["phi"] = ((v["phi"] + 2.0 * math.pi) % (2.0 * math.pi)
                                - math.pi)
        flip_vars = {k: x.requires_grad_() for k, x in flip_vars.items()}
        flip = TTOState(flip_vars, build_tto_optimizer(opt_cfg, flip_vars))
        fgen = generator(dev, seed, 0xF11)
        for _ in range(flip_steps):
            flip, _ = tto_step(flip, models, dirs, target, pose_gt, fgen)
        cmp_seed = (seed, 0xC3B, tto.step)
        tto, m_base = tto_step(tto, models, dirs, target, pose_gt,
                               generator(dev, *cmp_seed))
        flip, m_flip = tto_step(flip, models, dirs, target, pose_gt,
                                generator(dev, *cmp_seed))
        base_loss, flip_loss = float(m_base.loss), float(m_flip.loss)
        if flip_loss < base_loss:
            tto = flip
        if is_main_process():
            print(f"[VALOPT] azimuth-flip rescue ({flip_steps} steps): "
                  f"{'flip' if flip_loss < base_loss else 'base'} basin wins "
                  f"(losses {base_loss:.5f} base / {flip_loss:.5f} flip)")

    v = tto.variables
    with torch.no_grad():
        cam_pose = pose_spherical(v["theta"], v["phi"], v["rho"])[0]
    z_s, z_t = v["z_s"].detach(), v["z_t"].detach()

    # the SE(3)-tangent refinement, the single object lifted to K = 1
    refine_steps = opt_cfg.se3_refine_steps
    if refine_steps > 0:
        ref, ref_opt, base_poses = init_se3_refine_state(tto, opt_cfg)
        ref_step = make_se3_refine_step(harness.settings, ref_opt, n_rays,
                                        lam, perturb, device=dev)
        then = time.time()
        for vi in range(refine_steps):
            ref, m = ref_step(ref, models, dirs, target[None], base_poses,
                              pose_gt[None], gen)
            if _log_every(vi, refine_steps, cfg.experiment.val_print_every):
                line = logger.log_scalars("val-se3", vi, {
                    "nerf_loss_fine": m.loss_fine[0],
                    "pose_error": m.pose_error[0],
                    "psnr": m.psnr[0]}, time_taken=time.time() - then)
                print(f"{line}(SE3 refine)")
                then = time.time()
        with torch.no_grad():
            cam_pose = se3_refined_poses(ref.variables, base_poses)[0]
        z_s = ref.variables["z_s"].detach()
        z_t = ref.variables["z_t"].detach()

    rgb = render(models, dirs, cam_pose, z_s, z_t)
    return _finish_validation(harness, target, rgb, logger, iteration)


def _finish_validation(harness, target, rgb, logger, iteration,
                       tag: str = "val") -> dict:
    target_flat = target.reshape(-1, target.shape[-1])
    mse = float(torch.mean((rgb - target_flat[..., :3]) ** 2))
    psnr = float(mse2psnr(torch.tensor(mse)))
    rgb_img = torch.clamp(rgb.reshape(harness.height, harness.width, 3),
                          0.0, 1.0)
    ssim_val = float(ssim(rgb_img, torch.clamp(target[..., :3], 0.0, 1.0)))
    out = {"loss": mse, "psnr": psnr, "ssim": ssim_val}
    if is_main_process():
        print(logger.log_scalars(tag, iteration, out))
        logger.log_image(f"{tag}/rgb_image", iteration, rgb_img)
        logger.log_image(f"{tag}/target_image", iteration, target[..., :3])
    return out
