"""Experiment harness: the shared set-up of the train entry point and its
validation pass (counterpart of ``codenerf_tpu/harness.py``; reference
train.py:19-58, eval.py:82-205, util.py:44-144).

``Harness.from_config`` holds the config, the datasets and their seeded
batch streams, the camera's direction grid, the render settings and the
logdir; a train split may be empty (an existing directory with no
objects), as for evaluation on a val split alone.  For an LLFF scene
(unless ``dataset.no_ndc``) the render settings take NDC rays with near 0,
far 1 and ``lindisp`` spacing, as JAX's do.  ``validate`` is the
single-object validation the train loop runs: for CodeNeRF, test-time
optimization (TTO) of codes and pose on a fixed validation view, then a
full-image render, its PSNR and SSIM; for a vanilla model (no codes),
the render at the view's ground-truth pose.  ``validate_batched`` solves
K objects' TTO in one step stream, with the per-object multi-start
probe, the azimuth-flip rescue, the SE(3) refine and multi-view TTO, and
renders each object from its recovered and its ground-truth camera;
``validate_category`` runs it over every distinct val object in groups
of K (the eval CLI's ``--all-objects``), with the capacity clamp and the
out-of-memory halving of ``eval/capacity.py``.  Under
``runtime.int8_serving`` each of them also renders the image through the
int8 serving path (``models/quantized.py``, calibrated by
``int8_render_params`` at the render pose; ``runtime.int8_encode``
quantizes the encode stream too) and reports its PSNR and SSIM.

Data parallelism (JAX's mesh, harness.py:91-93): ``from_config`` joins
the world of ``runtime.num_devices`` ranks (``parallel.mesh.init_world``:
0 takes every rank torchrun or ``train_cli -g`` started, a larger number
must equal their count; without ranks, one device) and keeps it with its
device.  Every rank of a world draws from the same seeds, JAX's one-host
seeds (``randomseed + 1`` for the train stream, ``randomseed`` for
validation), and runs every validation with the world: the TTO steps and
the renders split their rays over the ranks, and every rank gets the
same metrics and images.  Rank 0 alone prints and logs.
``validate_batched`` and ``validate_category`` refuse a vanilla model,
as JAX's assert.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from codenerf_tpu_torch.config import Config, dump_config
from codenerf_tpu_torch.core.geometry import (pixel_directions,
                                              pose_spherical, ray_bundle)
from codenerf_tpu_torch.core.metrics import mse2psnr, ssim
from codenerf_tpu_torch.data import BatchIterator, LLFFDataset, build_dataset
from codenerf_tpu_torch.device import resolve_device
from codenerf_tpu_torch.eval.render import make_image_renderer
from codenerf_tpu_torch.eval import capacity
from codenerf_tpu_torch.eval.tto import (BatchedTTOMetrics, TTOState,
                                         init_batched_tto_state,
                                         init_multiview_se3_refine_state,
                                         init_multiview_tto_state,
                                         init_se3_refine_state,
                                         init_tto_state,
                                         make_batched_tto_step,
                                         make_se3_refine_step, make_tto_step,
                                         se3_refined_poses, select_per_object)
from codenerf_tpu_torch.models.quantized import quantize_for_serving
from codenerf_tpu_torch.parallel.mesh import (World, all_reduce_, init_world,
                                              world_size)
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train.optim import build_tto_optimizer
from codenerf_tpu_torch.train.state import has_codes
from codenerf_tpu_torch.utils.logging import MetricLogger, is_main_process


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
    world: Optional[World] = None

    @classmethod
    def from_config(cls, cfg: Config, device="cuda") -> "Harness":
        world = init_world(cfg.runtime.num_devices, device=device)
        dev = world.device if world is not None else resolve_device(device)
        # experiment dir + resolved-config dump (reference util.py:44-56)
        logdir = Path(cfg.experiment.logdir) / cfg.experiment.id
        if is_main_process():
            logdir.mkdir(parents=True, exist_ok=True)
            dump_config(cfg, logdir / "config.yml")

        train_ds = build_dataset(cfg.dataset, "train")
        val_ds = build_dataset(cfg.dataset, "val")

        # the JAX package's one-host seeds: every rank of a world draws
        # the same train batches and splits their rays
        seed = cfg.experiment.randomseed
        train_iter = BatchIterator(train_ds, cfg.dataset.train_batch_size,
                                   seed=seed + 1)
        val_iter = BatchIterator(val_ds, cfg.dataset.val_batch_size,
                                 seed=seed)

        # one direction grid from one probe (reference train.py:51-55):
        # refuse a split whose objects carry different intrinsics rather
        # than mis-render all but the probed one
        for ds, name in ((train_ds, "train"), (val_ds, "val")):
            homogeneous = getattr(ds, "intrinsics_homogeneous", None)
            if homogeneous is not None and len(ds) and not homogeneous():
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
        settings = RenderSettings.from_config(cfg)
        # NDC for forward-facing scenes (JAX harness.py:96-108): sampling in
        # NDC t over [0, 1]; the reference's "lindisp" label is the
        # linear-in-depth branch, linear in world disparity under NDC
        if isinstance(train_ds, LLFFDataset) and not cfg.dataset.no_ndc:
            focal = float(probe["intrinsic"][0, 0])
            settings = dataclasses.replace(
                settings, ndc=(float(height), float(width), focal),
                near=0.0, far=1.0, spacing_mode="lindisp")
        return cls(cfg=cfg, settings=settings,
                   train_dataset=train_ds, val_dataset=val_ds,
                   train_iter=train_iter, val_iter=val_iter, height=height,
                   width=width, directions=directions, logdir=logdir,
                   device=dev, world=world)

    @property
    def has_codes(self) -> bool:
        """Whether the models take per-object codes (CodeNeRF)."""
        return has_codes(self.settings)


def _log_every(vi: int, n: int, every: int) -> bool:
    return is_main_process() and ((vi != 0 and vi % every == 0)
                                  or vi == n - 1)


def validate(harness: Harness, params: dict, logger: MetricLogger,
             iteration: int, val_iterations: Optional[int] = None) -> dict:
    """Validation pass (reference eval.py:82-205) on the 6th validation
    batch's first view: for CodeNeRF, TTO of codes and pose, then a
    full-image render from the recovered camera; for a vanilla model, the
    render at the view's ground-truth pose (JAX harness.py:120-145,
    273-274).  Then the image's PSNR / SSIM, and under
    ``runtime.int8_serving`` the int8 image's, logged as "val-int8"
    (JAX harness.py:276-283).

    ``params``: {"coarse", "fine"} models and, for CodeNeRF, {"codes"}
    tables on the harness's device.  The TTO stages follow the config:
    multi-start pose probes (``pose_restarts``), the azimuth-flip rescue
    (``pose_flip_steps``) and the SE(3) refine (``se3_refine_steps``).
    Draws come from generators seeded by ``experiment.randomseed``.
    Returns {"loss", "psnr", "ssim"} (and "psnr_int8", "ssim_int8").
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
                                 device=dev, world=harness.world)
    models = {"coarse": params["coarse"], "fine": params["fine"]}
    if not harness.has_codes:
        return _validation_images(harness, render, models, target, pose_gt,
                                  None, None, logger, iteration)
    codes = params["codes"]

    tto, tto_opt = init_tto_state(codes, opt_cfg, device=dev)
    tto_step = make_tto_step(harness.settings, tto_opt, n_rays, lam, perturb,
                             device=dev, world=harness.world)
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
                                        lam, perturb, device=dev,
                                        world=harness.world)
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

    return _validation_images(harness, render, models, target, cam_pose, z_s,
                              z_t, logger, iteration)


def _validation_images(harness, render, models, target, cam_pose, z_s, z_t,
                       logger, iteration) -> dict:
    """The full-precision image's scores and, under
    ``runtime.int8_serving``, the int8 image's ("val-int8")."""
    rgb = render(models, harness.directions, cam_pose, z_s, z_t)
    out = _finish_validation(harness, target, rgb, logger, iteration)
    if harness.cfg.runtime.int8_serving:
        qmodels = int8_render_params(harness, models, cam_pose, z_s, z_t)
        rgb_q = render(qmodels, harness.directions, cam_pose, z_s, z_t)
        q = _finish_validation(harness, target, rgb_q, logger, iteration,
                               tag="val-int8")
        out.update({"psnr_int8": q["psnr"], "ssim_int8": q["ssim"]})
    return out


def int8_render_params(harness: Harness, models: dict, cam_pose, z_s, z_t,
                       n_rays: int = 16384) -> dict:
    """``models`` calibrated and quantized for int8 serving
    (``models/quantized.py::quantize_for_serving``) on rays cast from the
    render pose itself, the activation ranges the int8 render will see
    (JAX harness.py:287-312): ``n_rays`` pixels (every pixel of a 128x128
    view) drawn by ``np.random.default_rng(0)`` as JAX draws them, the
    codes [1, C] broadcast to every ray (None for a vanilla model), and
    ``runtime.int8_encode`` for the encode stream.  The draw does not
    depend on the rank, and a world's parameters are rank 0's, so every
    rank of a world calibrates to the same buffers and serves its slice
    of the image with the same int8 model."""
    dirs = harness.directions.reshape(-1, 3)
    n = min(n_rays, dirs.shape[0])
    idx = np.random.default_rng(0).choice(dirs.shape[0], n, replace=False)
    sel = torch.from_numpy(idx).to(dirs.device)
    ro, rd = ray_bundle(dirs[sel][None], cam_pose[None])
    zs = zt = None
    if z_s is not None:
        zs = z_s.reshape(1, -1).expand(n, -1)
        zt = z_t.reshape(1, -1).expand(n, -1)
    qmodels = quantize_for_serving(
        models, harness.settings, ro.reshape(n, 3), rd.reshape(n, 3), zs, zt,
        encode_stream=harness.cfg.runtime.int8_encode)
    return qmodels


def _ssim_of(harness, rgb, target) -> float:
    rgb_img = torch.clamp(rgb.reshape(harness.height, harness.width, 3),
                          0.0, 1.0)
    return float(ssim(rgb_img, torch.clamp(target[..., :3], 0.0, 1.0)))


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


def _distinct_val_objects(harness: Harness) -> list:
    """First held-out view of every distinct object in the val split, in
    dataset order."""
    ds = harness.val_dataset
    picked, seen = [], set()
    for i in range(len(ds)):
        s = ds[i]
        oid = int(s.get("object_id", i))
        if oid in seen:
            continue
        seen.add(oid)
        picked.append(s)
    return picked


def _collect_val_objects(harness: Harness, num_objects: int) -> list:
    """First held-out view of up to ``num_objects`` distinct objects of the
    val split, wrapping to later views when the split has fewer objects."""
    ds = harness.val_dataset
    n = len(ds)
    picked = _distinct_val_objects(harness)[:num_objects]
    i = 0
    while len(picked) < num_objects and n:
        picked.append(ds[i % n])
        i += 1
    return picked


def _collect_views(harness: Harness, object_id: int, num_views: int) -> list:
    """Up to ``num_views`` val views of one object, in dataset order,
    repeated round-robin when the split has fewer."""
    ds = harness.val_dataset
    views = []
    for i in range(len(ds)):
        s = ds[i]
        if int(s.get("object_id", -1)) == object_id:
            views.append(s)
            if len(views) == num_views:
                break
    i = 0
    while views and len(views) < num_views:
        views.append(views[i % len(views)])
        i += 1
    return views


def _stack(samples, key, dev) -> torch.Tensor:
    return torch.from_numpy(np.stack([s[key] for s in samples])).to(dev)


def _psnr_of(rgb, target) -> float:
    tflat = target.reshape(-1, target.shape[-1])
    return float(mse2psnr(torch.mean((rgb - tflat[..., :3]) ** 2)))


def _require_codes(harness: Harness, what: str) -> None:
    """Refuse a vanilla model where TTO of codes is the point (JAX
    asserts, harness.py:410 and :712)."""
    if not harness.has_codes:
        raise ValueError(f"{what} requires a CodeNeRF model")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def validate_batched(harness: Harness, params: dict, logger: MetricLogger,
                     num_objects: int, val_iterations: Optional[int] = None,
                     samples: Optional[list] = None, iteration: int = 0,
                     tto_views: int = 1,
                     return_recovered: bool = False) -> dict:
    """Batched multi-object TTO validation (``codenerf_tpu/harness.py::
    validate_batched``): K objects' TTO in one step stream, the
    multi-start pose probe selected per object, the azimuth-flip rescue
    judged per object on one shared ray draw, the SE(3) refine, then each
    object's full-image render from its recovered camera and from its
    ground-truth camera (the equivalence row: ``delta_psnr_gt_pose`` ~ 0
    at a large pose error shows a symmetry of the object, a large
    positive delta a pose TTO failed to find).

    ``tto_views > 1`` is multi-view TTO: V val views of each object share
    its codes, each view its own camera; renders and PSNR are on view 0,
    the pose error the mean over views.  Under ``runtime.int8_serving``
    each row also holds the int8 image's ``psnr_int8`` and ``ssim_int8``
    at the recovered camera (JAX harness.py:649-661).  Draws come from
    generators seeded by ``experiment.randomseed`` (the main stream, one
    per probe r, one for the flip candidate, one shared by the two
    basins' comparison step).  Returns the aggregate metrics with the
    per-object rows and objects per minute; with ``return_recovered``
    also the recovered codes, cameras and spherical parameters (view 0).
    """
    _require_codes(harness, "batched TTO")
    cfg = harness.cfg
    dev = harness.device
    opt_cfg = cfg.optimizer
    K = num_objects
    V = max(1, tto_views)
    lam = cfg.experiment.regularizer_lambda
    perturb = cfg.nerf.point_sampler.perturb
    seed = cfg.experiment.randomseed
    dirs = harness.directions
    codes = params["codes"]
    models = {"coarse": params["coarse"], "fine": params["fine"]}
    if samples is None:
        samples = _collect_val_objects(harness, K)
    if len(samples) != K:
        raise ValueError(f"validate_batched needs {K} samples, got "
                         f"{len(samples)}")
    rays = cfg.nerf.ray_sampler.num_random_rays
    if V > 1:
        view_sets = [_collect_views(harness, int(s.get("object_id", -1)), V)
                     for s in samples]
        targets = torch.stack([_stack(vs, "color", dev) for vs in view_sets])
        poses_gt = torch.stack([_stack(vs, "pose", dev) for vs in view_sets])
        if opt_cfg.tto_view_ray_split:
            # constant total ray budget: R // V rays per view
            rays = max(1, rays // V)
            if is_main_process():
                print(f"[VALOPT] tto_view_ray_split: {rays} rays/view x {V} "
                      f"views (constant total budget)")

        def init(pose_init=(1.57, 0.0, 1.30)):
            return init_multiview_tto_state(codes, opt_cfg, K, V,
                                            pose_init=pose_init, device=dev)
    else:
        targets = _stack(samples, "color", dev)
        poses_gt = _stack(samples, "pose", dev)

        def init(pose_init=(1.57, 0.0, 1.30)):
            return init_batched_tto_state(codes, opt_cfg, K,
                                          pose_init=pose_init, device=dev)
    tto, tto_opt = init()
    tto_step = make_batched_tto_step(harness.settings, tto_opt, rays, lam,
                                     perturb, device=dev,
                                     world=harness.world)
    gen = generator(dev, seed)
    n_iters = (cfg.experiment.val_iterations if val_iterations is None
               else val_iterations)
    t_start = time.time()

    def step(state, g):
        return tto_step(state, models, dirs, targets, poses_gt, g)

    # multi-start pose probing, selected per object (cf. validate)
    restarts = max(1, opt_cfg.pose_restarts)
    if restarts > 1:
        probe_steps = max(1, min(opt_cfg.pose_restart_steps, n_iters))
        best_loss = best = None
        for r in range(restarts):
            phi0 = 2.0 * math.pi * r / restarts
            phi0 = (phi0 + math.pi) % (2.0 * math.pi) - math.pi
            th0 = 1.57 if r == 0 else opt_cfg.pose_restart_theta
            cand, _ = init((th0, phi0, 1.30))
            cgen = generator(dev, seed, r)
            for _ in range(probe_steps):
                cand, m = step(cand, cgen)
            probe_loss = m.loss.cpu().numpy()              # [K]
            if best is None:
                best_loss, best = probe_loss, cand
            else:
                mask = torch.from_numpy(probe_loss < best_loss)
                best = select_per_object(mask, cand, best)
                best_loss = np.minimum(probe_loss, best_loss)
        tto = best
        if is_main_process():
            print(f"[VALOPT] batched pose multi-start over {restarts} inits: "
                  f"per-object probe losses "
                  f"{np.array2string(best_loss, precision=4)}")

    then = time.time()
    for vi in range(n_iters):
        tto, m = step(tto, gen)
        if _log_every(vi, n_iters, cfg.experiment.val_print_every):
            line = logger.log_scalars("val-optim", vi, {
                "nerf_loss_coarse": m.loss_coarse.mean(),
                "nerf_loss_fine": m.loss_fine.mean(),
                "embedding_loss": m.loss_embedding.mean(),
                "pose_error": m.pose_error.mean(),
                "total_loss": m.loss.sum(),
                "psnr": m.psnr.mean()}, time_taken=time.time() - then)
            print(f"{line}(mean over {K} objects)")
            then = time.time()

    # azimuth-flip rescue: retry from phi + pi with the converged codes and
    # fresh moments, then keep each object's basin with the lower loss on
    # one shared ray draw.  The steps update in place, so the candidate
    # starts from copies.
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
            flip, _ = step(flip, fgen)
        cmp_seed = (seed, 0xC3B, tto.step)
        tto, m_base = step(tto, generator(dev, *cmp_seed))
        flip, m_flip = step(flip, generator(dev, *cmp_seed))
        mask = m_flip.loss < m_base.loss
        tto = select_per_object(mask.cpu(), flip, tto)
        # the metrics merged per object as the states are
        m = BatchedTTOMetrics(*(torch.where(mask, a, b)
                                for a, b in zip(m_flip, m_base)))
        if is_main_process():
            print(f"[VALOPT] azimuth-flip rescue ({flip_steps} steps): "
                  f"flip wins on {int(mask.sum())}/{K} objects, per-object "
                  f"losses {np.array2string(m.loss.cpu().numpy(), precision=4)}")

    # SE(3)-tangent refinement: codes plus a 6-DOF correction per camera
    # (per view when V > 1), cam_pose = se3_exp(xi) @ spherical result
    refine_steps = opt_cfg.se3_refine_steps
    if refine_steps > 0:
        init_ref = (init_multiview_se3_refine_state if V > 1
                    else init_se3_refine_state)
        ref, ref_opt, base_poses = init_ref(tto, opt_cfg)
        ref_step = make_se3_refine_step(harness.settings, ref_opt, rays, lam,
                                        perturb, device=dev,
                                        world=harness.world)
        then = time.time()
        for vi in range(refine_steps):
            ref, m = ref_step(ref, models, dirs, targets, base_poses,
                              poses_gt, gen)
            if _log_every(vi, refine_steps, cfg.experiment.val_print_every):
                line = logger.log_scalars("val-se3", vi, {
                    "nerf_loss_fine": m.loss_fine.mean(),
                    "pose_error": m.pose_error.mean(),
                    "psnr": m.psnr.mean()}, time_taken=time.time() - then)
                print(f"{line}(SE3 refine, mean over {K} objects)")
                then = time.time()
        with torch.no_grad():
            final_poses = se3_refined_poses(ref.variables, base_poses)
        z_s_all = ref.variables["z_s"].detach()
        z_t_all = ref.variables["z_t"].detach()
    else:
        v = tto.variables
        with torch.no_grad():
            final_poses = pose_spherical(v["theta"], v["phi"], v["rho"])
        z_s_all, z_t_all = v["z_s"].detach(), v["z_t"].detach()
    if V > 1:
        final_poses = final_poses[:, 0]       # render / report on view 0
    _sync(dev)
    tto_secs = time.time() - t_start
    targets_r = targets[:, 0] if V > 1 else targets
    poses_gt_r = poses_gt[:, 0] if V > 1 else poses_gt

    # per-object full-image renders, from the recovered camera and from
    # the ground-truth one
    render = make_image_renderer(harness.settings, harness.height,
                                 harness.width,
                                 chunksize=cfg.nerf.validation.chunksize,
                                 device=dev, world=harness.world)
    pose_err = m.pose_error.cpu().numpy()
    per_object = []
    for kk in range(K):
        zs, zt = z_s_all[kk:kk + 1], z_t_all[kk:kk + 1]
        target = targets_r[kk]
        rgb = render(models, dirs, final_poses[kk], zs, zt)
        row = {"psnr": _psnr_of(rgb, target),
               "ssim": _ssim_of(harness, rgb, target),
               "pose_error": float(pose_err[kk])}
        rgb_gt = render(models, dirs, poses_gt_r[kk], zs, zt)
        row["psnr_gt_pose"] = _psnr_of(rgb_gt, target)
        row["delta_psnr_gt_pose"] = row["psnr"] - row["psnr_gt_pose"]
        if cfg.runtime.int8_serving:
            qmodels = int8_render_params(harness, models, final_poses[kk],
                                         zs, zt)
            rgb_q = render(qmodels, dirs, final_poses[kk], zs, zt)
            row["psnr_int8"] = _psnr_of(rgb_q, target)
            row["ssim_int8"] = _ssim_of(harness, rgb_q, target)
        per_object.append(row)
        if is_main_process():
            logger.log_image(f"val/rgb_image_obj{kk}", iteration,
                             torch.clamp(rgb.reshape(harness.height,
                                                     harness.width, 3),
                                         0.0, 1.0))
    out = {
        "num_objects": K,
        "psnr_mean": float(np.mean([o["psnr"] for o in per_object])),
        "ssim_mean": float(np.mean([o["ssim"] for o in per_object])),
        "tto_seconds": tto_secs,
        "objects_per_min": 60.0 * K / max(tto_secs, 1e-9),
        "per_object": per_object,
    }
    if return_recovered:
        tv = tto.variables

        def view0(x):
            x = x.detach()
            return (x[:, 0] if V > 1 else x).cpu().numpy()
        out["recovered"] = {
            "z_s": z_s_all.cpu().numpy(), "z_t": z_t_all.cpu().numpy(),
            "final_poses": final_poses.cpu().numpy(),
            "theta": view0(tv["theta"]), "phi": view0(tv["phi"]),
            "rho": view0(tv["rho"]),
            "targets": targets_r.cpu().numpy(),
            "poses_gt": poses_gt_r.cpu().numpy(),
        }
    if is_main_process():
        logger.log_scalars("val", iteration, {
            "psnr_mean": out["psnr_mean"], "ssim_mean": out["ssim_mean"],
            "objects_per_min": out["objects_per_min"]})
        print(f"[VAL   ] batched TTO: {K} objects in {tto_secs:.1f}s "
              f"({out['objects_per_min']:.1f} obj/min), "
              f"PSNR mean {out['psnr_mean']:.2f}, "
              f"SSIM mean {out['ssim_mean']:.3f}")
    return out


def validate_category(harness: Harness, params: dict, logger: MetricLogger,
                      batch_objects: int,
                      val_iterations: Optional[int] = None,
                      tto_views: int = 1) -> dict:
    """Category evaluation (``codenerf_tpu/harness.py::validate_category``):
    TTO and render for every distinct val object, in batched groups of
    ``batch_objects``.  K is first clamped to what the card's memory
    admits (``capacity.max_batch_objects``, V views multiplying the rays);
    a short last group is padded by repeating its first object, and the
    pads are left out of the report.  A group that runs out of device
    memory (``capacity.is_oom_error``) is redone at half the K, with the
    rows already done kept; every other error is raised, and so is an
    out-of-memory error in a world of more than one rank.  Prints the
    per-object table and the category means (with the int8 PSNR column
    and ``psnr_int8_mean`` / ``ssim_int8_mean`` under
    ``runtime.int8_serving``, JAX harness.py:761-787); returns them, with
    the K the groups ran at, the TTO seconds of all groups and objects
    per minute.  In a world each rank clamps K by its own device, as
    JAX's reads device 0, and the ranks run the least of their Ks.  A
    rank that runs out of memory there stops inside a group whose
    collectives the other ranks have entered, so no later agreement can
    line the ranks' collectives up again: it raises, and the launcher
    (``parallel.launch.spawn``, torchrun) brings the world down.
    """
    _require_codes(harness, "category evaluation")
    cfg = harness.cfg
    K = max(1, batch_objects)
    V = max(1, tto_views)
    fit = capacity.max_batch_objects(
        harness.settings, cfg.nerf.ray_sampler.num_random_rays * V, K,
        device=harness.device)
    # each rank's device sets its own K; the world runs the least
    fit_t = torch.tensor([fit])
    all_reduce_(harness.world, [fit_t], op=torch.distributed.ReduceOp.MIN)
    fit = int(fit_t)
    if fit < K and is_main_process():
        print(f"[VAL   ] batch-objects {K} exceeds the device memory budget "
              f"at these shapes; auto-splitting into groups of {fit} "
              f"(eval/capacity.py)")
    K = fit
    objects = _distinct_val_objects(harness)
    rows = []
    g0 = 0
    tto_secs = 0.0
    # a monotonic group counter for the logger's iteration: one derived
    # from g0 and the mutable K would collide after a halving
    group_idx = 0
    while g0 < len(objects):
        group = objects[g0:g0 + K]
        real = len(group)
        padded = group + [group[0]] * (K - real)
        try:
            out = validate_batched(harness, params, logger, K,
                                   val_iterations=val_iterations,
                                   samples=padded, iteration=group_idx,
                                   tto_views=V)
        except Exception as err:
            if (K <= 1 or not capacity.is_oom_error(err)
                    or world_size(harness.world) > 1):
                raise
            K = max(1, K // 2)
            if harness.device.type == "cuda":
                torch.cuda.empty_cache()
            if is_main_process():
                print(f"[VAL   ] batched TTO step ran out of device memory; "
                      f"retrying the remaining objects in groups of {K}")
            continue
        rows.extend(out["per_object"][:real])
        tto_secs += out["tto_seconds"]
        g0 += real
        group_idx += 1
    summary = {
        "num_objects": len(rows),
        "batch_objects": K,
        "groups": group_idx,
        "tto_seconds": tto_secs,
        "objects_per_min": 60.0 * len(rows) / max(tto_secs, 1e-9),
        "psnr_mean": float(np.mean([r["psnr"] for r in rows])),
        "ssim_mean": float(np.mean([r["ssim"] for r in rows])),
        "pose_error_mean": float(np.mean([r["pose_error"] for r in rows])),
        "delta_psnr_gt_pose_mean": float(np.mean(
            [r["delta_psnr_gt_pose"] for r in rows])),
        "per_object": rows,
    }
    int8 = bool(rows) and all("psnr_int8" in r for r in rows)
    if int8:
        summary["psnr_int8_mean"] = float(np.mean([r["psnr_int8"]
                                                   for r in rows]))
        summary["ssim_int8_mean"] = float(np.mean([r["ssim_int8"]
                                                   for r in rows]))
    if is_main_process():
        print(f"[VAL   ] category evaluation over {len(rows)} objects "
              f"(groups of {K}" + (f", {V} views/object" if V > 1 else "")
              + "):")
        # dPSNR(GT pose): the recovered-pose render less the GT-pose render
        # of the same recovered codes
        print("  object |   PSNR |  SSIM | pose err | dPSNR(GT pose)"
              + (" | int8 PSNR" if int8 else ""))
        for i, r in enumerate(rows):
            print(f"  {i:6d} | {r['psnr']:6.2f} | {r['ssim']:.3f} "
                  f"| {r['pose_error']:8.3f} "
                  f"| {r['delta_psnr_gt_pose']:+14.2f}"
                  + (f" | {r['psnr_int8']:6.2f}" if int8 else ""))
        print(f"  mean   | {summary['psnr_mean']:6.2f} "
              f"| {summary['ssim_mean']:.3f} "
              f"| {summary['pose_error_mean']:8.3f} "
              f"| {summary['delta_psnr_gt_pose_mean']:+14.2f}"
              + (f" | {summary['psnr_int8_mean']:6.2f}" if int8 else ""))
    return summary
