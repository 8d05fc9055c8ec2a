"""Test-time optimization (TTO): recover latent codes AND camera pose for
an unseen object by gradient descent through the renderer (counterpart
of ``codenerf_tpu/eval/tto.py``; reference eval.py:122-168).

Semantics as in JAX (tto.py:5-17):

  * codes start at the mean of the learned tables (eval.py:126-127);
  * the pose is spherical (theta, phi, rho), from 1.57 / 0 / 1.30
    (eval.py:129-131);
  * codes at val_lr, angles at angle_lr, radius at radius_lr
    (``train/optim.py::build_tto_optimizer``);
  * loss = mse_c + mse_f + lambda (||z_s|| + ||z_t||), the norm of the
    per-ray-expanded codes, sqrt(R) ||code|| (eval.py:157-163);
  * pose error = ||SE3 log(inv(pose_gt) @ pose)|| at the pose the step
    rendered from (eval.py:161-162);
  * the models are frozen: gradients flow pose -> rays -> render.

Beyond the reference, as in JAX: K objects in one step
(``make_batched_tto_step``; K = 1 reproduces the single step), V views
of each object with shared codes (``make_multiview_tto_step``), and a
second stage that refines a full 6-DOF pose in the SE(3) tangent space
from the spherical result (``make_se3_refine_step`` and its multi-view
form).  ``select_per_object`` merges two batched states object by
object.

PyTorch idiom: ``variables`` is a dict of leaf tensors on the device, and
``TTOState`` holds them with their ``torch.optim`` optimizer and the step
count.  The builders keep JAX's arguments; their ``optimizer`` is the
one ``init_*`` returned, and a step steps ``state.optimizer`` (a state
from ``select_per_object`` has a new one).  A step keeps JAX's
arguments, with a ``torch.Generator`` in place of the key, updates the
state in place and returns it with its metrics, as tensors (it never
waits for the device).  The multi-view and refine steps are the batched
step's code on [K, V] pose leaves or an SE(3) pose.  It draws, in this order, the
ray indices, the coarse jitter and the fine u; ``inds`` and ``draws``
(``pipeline.render_rays_train``'s) replace the draws in tests.  While a
step renders and backpropagates, every model parameter has
``requires_grad`` off (restored after), so the models get no ``.grad``
and the ray-structured path skips its weight-gradient products; K2 and
K3 still compute theirs, which nothing reads.

Each ``make_*`` step takes JAX's ``mesh`` as ``world``
(``parallel.mesh``; JAX tto.py:84, 178, 290, 409, 517): each rank makes
the pose, the rays of every pixel, the global indices and draws,
renders its slice of the K*V*R rays and backpropagates its part of
each object's mean; one all-reduce sums the codes', pose's and xi's
gradients and the metrics.  The code regularizer keeps the global R
(sqrt(R) ||z|| in the batched steps, the norm of codes expanded to R
rows in the single step); its gradient is added after the all-reduce,
once on every rank.

Spans (``utils/trace.py``, recorded only while tracing is on): each
step's root ``tto.step`` with the state's step, and under it
``tto.forward``, ``tto.backward`` (the data loss's, then the
regularizer's), ``tto.allreduce`` with a world and ``tto.optimizer``;
``setup.state`` around each ``init_*tto_state``.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from codenerf_tpu_torch.core import lie
from codenerf_tpu_torch.core.geometry import pose_spherical
from codenerf_tpu_torch.core.metrics import mse2psnr
from codenerf_tpu_torch.device import resolve_device
from codenerf_tpu_torch.models.codes import mean_codes
from codenerf_tpu_torch.parallel.mesh import (World, all_reduce_,
                                              all_reduce_grads, shard_rays)
from codenerf_tpu_torch.pipeline import (RenderSettings, draw_train_randoms,
                                         render_rays_train)
from codenerf_tpu_torch.train.optim import (build_se3_refine_optimizer,
                                            build_tto_optimizer)
from codenerf_tpu_torch.train.step import gather_ray_batch
from codenerf_tpu_torch.utils import trace

POSE_INIT = (1.57, 0.0, 1.30)


@dataclass
class TTOState:
    """What a TTO step updates: ``variables`` {"z_s", "z_t", "theta",
    "phi", "rho"} (or {"z_s", "z_t", "xi"} for the SE(3) stage), leaf
    tensors that ``optimizer`` steps, and the step count."""
    variables: dict
    optimizer: Any
    step: int = 0


class TTOMetrics(NamedTuple):
    loss: torch.Tensor
    loss_coarse: torch.Tensor
    loss_fine: torch.Tensor
    loss_embedding: torch.Tensor
    psnr: torch.Tensor
    pose_error: torch.Tensor


class BatchedTTOMetrics(NamedTuple):
    """Per-object [K] metrics of one batched, multi-view or SE(3) step."""
    loss: torch.Tensor
    loss_coarse: torch.Tensor
    loss_fine: torch.Tensor
    loss_embedding: torch.Tensor
    psnr: torch.Tensor
    pose_error: torch.Tensor


def _leaf(x) -> torch.Tensor:
    return x.detach().clone().requires_grad_()


def _pose_leaves(pose_init, shape, dev) -> dict:
    """theta, phi, rho of ``shape`` from scalars or broadcastable arrays."""
    return {k: _leaf(torch.as_tensor(v, dtype=torch.float32,
                                     device=dev).expand(shape))
            for k, v in zip(("theta", "phi", "rho"), pose_init)}


def _code_leaves(code_tables, num_objects, dev) -> dict:
    """The tables' mean codes, [1, C] for the single step (``None``) or
    repeated to [K, C]."""
    out = {}
    for k, z in zip(("z_s", "z_t"), mean_codes(code_tables)):
        z = z.detach().to(dev)
        out[k] = _leaf(z if num_objects is None
                       else z.expand(num_objects, z.shape[-1]))
    return out


def init_tto_state(code_tables, opt_cfg, pose_init=POSE_INIT,
                   device="cuda"):
    """(state, optimizer): codes = table means [1, C], pose =
    ``pose_init`` (theta, phi, rho) as [1] tensors (eval.py:126-131), on
    ``device``."""
    with trace.span("setup.state"):
        dev = resolve_device(device)
        variables = _code_leaves(code_tables, None, dev)
        variables.update(_pose_leaves(pose_init, (1,), dev))
        optimizer = build_tto_optimizer(opt_cfg, variables)
    return TTOState(variables, optimizer), optimizer


def init_batched_tto_state(code_tables, opt_cfg, num_objects: int,
                           pose_init=POSE_INIT, device="cuda"):
    """(state, optimizer) for K objects: codes [K, C], pose [K] each.
    ``pose_init`` entries are scalars (a shared init) or [K] arrays."""
    with trace.span("setup.state"):
        dev = resolve_device(device)
        variables = _code_leaves(code_tables, num_objects, dev)
        variables.update(_pose_leaves(pose_init, (num_objects,), dev))
        optimizer = build_tto_optimizer(opt_cfg, variables)
    return TTOState(variables, optimizer), optimizer


def init_multiview_tto_state(code_tables, opt_cfg, num_objects: int,
                             num_views: int, pose_init=POSE_INIT,
                             device="cuda"):
    """(state, optimizer) for K objects x V views: codes [K, C] per
    object, pose [K, V] per view.  ``pose_init`` entries are scalars or
    arrays broadcast to [K, V] as JAX broadcasts them (a 1-D array runs
    along the last axis)."""
    with trace.span("setup.state"):
        dev = resolve_device(device)
        variables = _code_leaves(code_tables, num_objects, dev)
        variables.update(_pose_leaves(pose_init, (num_objects, num_views),
                                      dev))
        optimizer = build_tto_optimizer(opt_cfg, variables)
    return TTOState(variables, optimizer), optimizer


@contextlib.contextmanager
def frozen(models: dict):
    """Every parameter of ``models`` at ``requires_grad=False`` inside the
    block, its flag restored after."""
    params = [p for m in models.values() for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def _object_losses(models, settings, poses, z_s, z_t, directions, images,
                   generator, num_random_rays, perturb, inds, draws, world):
    """(loss_c, loss_f) per object [K] for K objects' codes [K, C] and
    their K*V views: poses [K*V, 4, 4], images [K*V, H, W, C].  Each view
    draws ``num_random_rays`` pixels (``inds`` [K*V, R] replaces the
    draw); the losses are means over each object's V*R rays, of which
    this rank of ``world`` renders its slice (its part of each mean; the
    other rays count as zero)."""
    K, KV, R = z_s.shape[0], poses.shape[0], num_random_rays
    N = KV * R
    ids = torch.zeros(KV, dtype=torch.long, device=poses.device)
    ro, rd, target, _ = gather_ray_batch(directions, poses, images, ids,
                                         generator, R, inds)
    if draws is None:
        draws = draw_train_randoms(settings, N, generator, perturb, 0.0,
                                   ro.dtype, ro.device)

    def per_ray(z):
        return z[:, None, :].expand(K, KV // K * R, z.shape[-1]).reshape(
            N, z.shape[-1])

    ro, rd, target, zs, zt = shard_rays(world, ro, rd, target, per_ray(z_s),
                                        per_ray(z_t))
    out_c, out_f = render_rays_train(
        models, settings, ro, rd, zs, zt, None, perturb, 0.0,
        {k: shard_rays(world, v) for k, v in draws.items()})
    lo = 0 if world is None else world.rank * ro.shape[0]

    def mean(rgb):
        err = torch.nn.functional.pad((rgb - target[:, :3]) ** 2,
                                      (0, 0, lo, N - lo - rgb.shape[0]))
        return torch.mean(err.reshape(K, -1), dim=1)

    return mean(out_c.rgb), mean(out_f.rgb)


def _object_code_norms(variables, num_random_rays, regularizer_lambda):
    """lambda sqrt(R) (||z_s[k]|| + ||z_t[k]||), [K]: the norm of each
    object's codes expanded over its R rays (tto.py:223-227)."""
    return regularizer_lambda * math.sqrt(num_random_rays) * (
        torch.linalg.norm(variables["z_s"], dim=-1)
        + torch.linalg.norm(variables["z_t"], dim=-1))


def _update(state, data_loss, losses, loss_e, world):
    """Backpropagate this rank's ``data_loss``, sum the variables'
    gradients and the ``losses`` over ``world``'s ranks, add the
    regularizer ``loss_e``'s gradient, and step the state's optimizer."""
    with trace.span("tto.backward"):
        data_loss.backward()
    if world is not None:
        with trace.span("tto.allreduce"):
            all_reduce_grads(world, state.variables.values())
            all_reduce_(world, losses)
    with trace.span("tto.backward"):
        loss_e.backward()
    with trace.span("tto.optimizer"):
        state.optimizer.step()
    state.step += 1


def _batched_metrics(loss_c, loss_f, loss_e, pose_err):
    loss_c, loss_f, loss_e = loss_c.detach(), loss_f.detach(), loss_e.detach()
    return BatchedTTOMetrics(loss=loss_c + loss_f + loss_e,
                             loss_coarse=loss_c, loss_fine=loss_f,
                             loss_embedding=loss_e, psnr=mse2psnr(loss_f),
                             pose_error=pose_err)


def make_tto_step(settings: RenderSettings, optimizer,
                  num_random_rays: int, regularizer_lambda: float,
                  perturb: bool, device="cuda",
                  world: Optional[World] = None) -> Callable:
    """Build the single-object TTO step on ``device``, on this rank's
    share of the rays of ``world`` (None: one device).

    Returned signature: ``tto_step(state, models, directions,
    target_image, pose_gt, generator, inds=None, draws=None) -> (state,
    TTOMetrics)``, with ``state`` from ``init_tto_state``, ``models``
    {"coarse", "fine"}, ``target_image`` [H, W, C], ``pose_gt`` [4, 4]
    (metric only), ``inds`` [R] and ``draws`` a ``render_rays_train``
    draws dict.
    """
    dev = resolve_device(device)
    R = num_random_rays

    def tto_step(state, models, directions, target_image, pose_gt,
                 generator, inds=None, draws=None):
        with trace.span("tto.step", step=state.step):
            return _tto_step(state, models, directions, target_image,
                             pose_gt, generator, inds, draws)

    def _tto_step(state, models, directions, target_image, pose_gt,
                  generator, inds, draws):
        v = state.variables
        state.optimizer.zero_grad(set_to_none=True)
        with frozen(models):
            with trace.span("tto.forward"):
                cam_pose = pose_spherical(v["theta"], v["phi"], v["rho"])
                loss_c, loss_f = _object_losses(
                    models, settings, cam_pose, v["z_s"], v["z_t"],
                    directions.to(dev), target_image.to(dev)[None],
                    generator, R, perturb,
                    None if inds is None else inds.reshape(1, R), draws,
                    world)
                # reference eval.py:160 regularizes the expanded [R, C]
                # codes
                loss_e = regularizer_lambda * (
                    torch.linalg.norm(v["z_s"].expand(R, -1))
                    + torch.linalg.norm(v["z_t"].expand(R, -1)))
                losses = torch.cat([loss_c, loss_f]).detach()
            _update(state, loss_c[0] + loss_f[0], [losses], loss_e, world)
        perr = lie.pose_error(pose_gt.to(dev), cam_pose[0].detach())
        loss_c, loss_f = losses
        loss_e = loss_e.detach()
        return state, TTOMetrics(
            loss=loss_c + loss_f + loss_e, loss_coarse=loss_c,
            loss_fine=loss_f, loss_embedding=loss_e,
            psnr=mse2psnr(loss_f), pose_error=perr)

    return tto_step


def _make_batched_step(settings, num_random_rays, regularizer_lambda,
                       perturb, device, refine, world):
    """The step of every batched kind: K objects ([K] pose leaves) or K
    objects x V views ([K, V]), spherical or, with ``refine``, SE(3)
    refined from base poses."""
    dev = resolve_device(device)
    R = num_random_rays

    def run(state, models, directions, target_images, base_poses, poses_gt,
            generator, inds, draws):
        with trace.span("tto.step", step=state.step):
            return _run(state, models, directions, target_images, base_poses,
                        poses_gt, generator, inds, draws)

    def _run(state, models, directions, target_images, base_poses, poses_gt,
             generator, inds, draws):
        v = state.variables
        state.optimizer.zero_grad(set_to_none=True)
        with frozen(models):
            with trace.span("tto.forward"):
                if refine:
                    cam_poses = se3_refined_poses(v, base_poses.to(dev))
                else:
                    cam_poses = pose_spherical(v["theta"], v["phi"],
                                               v["rho"])
                lead = cam_poses.shape[:-2]              # [K] or [K, V]
                loss_c, loss_f = _object_losses(
                    models, settings, cam_poses.reshape(-1, 4, 4), v["z_s"],
                    v["z_t"], directions.to(dev),
                    target_images.to(dev).flatten(0, len(lead) - 1),
                    generator, R, perturb, inds, draws, world)
                loss_e = _object_code_norms(v, R, regularizer_lambda)
                losses = torch.stack([loss_c, loss_f]).detach()
            _update(state, torch.sum(loss_c + loss_f), [losses],
                    torch.sum(loss_e), world)
            loss_c, loss_f = losses
        perr = lie.pose_error(poses_gt.to(dev), cam_poses.detach())
        if len(lead) == 2:
            perr = perr.mean(1)
        return state, _batched_metrics(loss_c, loss_f, loss_e, perr)

    if refine:
        def refine_step(state, models, directions, target_images,
                        base_poses, poses_gt, generator, inds=None,
                        draws=None):
            return run(state, models, directions, target_images, base_poses,
                       poses_gt, generator, inds, draws)
        return refine_step

    def tto_step(state, models, directions, target_images, poses_gt,
                 generator, inds=None, draws=None):
        return run(state, models, directions, target_images, None, poses_gt,
                   generator, inds, draws)
    return tto_step


def make_batched_tto_step(settings: RenderSettings, optimizer,
                          num_random_rays: int, regularizer_lambda: float,
                          perturb: bool, device="cuda",
                          world: Optional[World] = None) -> Callable:
    """Build the K-object TTO step on ``device``: each object draws its
    own pixels from its own target under its own pose, the K ray batches
    render as one, and the K losses are summed for the backward (object
    k's loss depends on its own variables only).

    Returned signature: ``step(state, models, directions, target_images,
    poses_gt, generator, inds=None, draws=None) -> (state,
    BatchedTTOMetrics)``, with ``state`` from ``init_batched_tto_state``,
    ``target_images`` [K, H, W, C], ``poses_gt`` [K, 4, 4] (metric only)
    and ``inds`` [K, R].

    With a state from ``init_multiview_tto_state`` (pose [K, V]) it is
    the multi-view step: ``target_images`` [K, V, H, W, C], ``poses_gt``
    [K, V, 4, 4], ``inds`` [K*V, R]; each view draws its own R pixels,
    codes are shared by an object's views, each object's losses are means
    over its V*R rays and its pose error the mean over its views.
    """
    return _make_batched_step(settings, num_random_rays, regularizer_lambda,
                              perturb, device, refine=False, world=world)


# JAX's name for the K-object, V-view step: the batched step on a
# multi-view state
make_multiview_tto_step = make_batched_tto_step


def _se3_refine_state(tto_state, opt_cfg, xi_shape):
    v = tto_state.variables
    with torch.no_grad():
        base_poses = pose_spherical(v["theta"], v["phi"], v["rho"])
    variables = {
        # copies, not aliases: the refine stage steps its own leaves
        "z_s": _leaf(v["z_s"]), "z_t": _leaf(v["z_t"]),
        "xi": torch.zeros(xi_shape, dtype=torch.float32,
                          device=v["z_s"].device, requires_grad=True),
    }
    optimizer = build_se3_refine_optimizer(opt_cfg, variables)
    return TTOState(variables, optimizer), optimizer, base_poses


def init_se3_refine_state(tto_state: TTOState, opt_cfg):
    """From a finished batched TTO state: (refine_state, optimizer,
    base_poses [K, 4, 4]).  The codes are copied; xi [K, 6] starts at
    zero, which continues exactly from the spherical solution."""
    K = tto_state.variables["z_s"].shape[0]
    return _se3_refine_state(tto_state, opt_cfg, (K, 6))


def init_multiview_se3_refine_state(tto_state: TTOState, opt_cfg):
    """From a finished multi-view TTO state (theta [K, V]):
    (refine_state, optimizer, base_poses [K, V, 4, 4]).  Codes stay per
    object; xi [K, V, 6] is one 6-DOF correction per view, from zero."""
    K, V = tto_state.variables["theta"].shape
    return _se3_refine_state(tto_state, opt_cfg, (K, V, 6))


def se3_refined_poses(variables: dict, base_poses: torch.Tensor):
    """cam_pose = se3_exp(xi) @ base_pose over every leading axis."""
    return lie.se3_exp(variables["xi"]) @ base_poses


# the multi-view stage composes the same way over [K, V]
multiview_se3_refined_poses = se3_refined_poses


def make_se3_refine_step(settings: RenderSettings, optimizer,
                         num_random_rays: int, regularizer_lambda: float,
                         perturb: bool, device="cuda",
                         world: Optional[World] = None) -> Callable:
    """Build the K-object SE(3) refinement step on ``device``: the
    batched step's ray draw and losses with cam_pose = se3_exp(xi) @
    base_pose.

    Returned signature: ``step(state, models, directions, target_images,
    base_poses, poses_gt, generator, inds=None, draws=None) -> (state,
    BatchedTTOMetrics)``, with ``target_images`` [K, H, W, C] and
    ``base_poses`` / ``poses_gt`` [K, 4, 4].  With a state from
    ``init_multiview_se3_refine_state`` it is the multi-view refinement:
    ``target_images`` [K, V, H, W, C], ``base_poses`` / ``poses_gt``
    [K, V, 4, 4], ``inds`` [K*V, R], per-object metrics averaged over the
    views.
    """
    return _make_batched_step(settings, num_random_rays, regularizer_lambda,
                              perturb, device, refine=True, world=world)


# JAX's name for the K-object, V-view refinement step
make_multiview_se3_refine_step = make_se3_refine_step


def select_per_object(mask: torch.Tensor, winner: TTOState,
                      other: TTOState) -> TTOState:
    """Per-object merge of two batched TTO states of the same kind: where
    ``mask[k]``, object k from ``winner``, else from ``other``.  Every
    variable and every optimizer-state tensor with a leading [K] axis (the
    moments) is selected object-wise; the rest (AdamW's ``step``, the step
    count) comes from ``winner``.  Returns a new state whose optimizer, of
    ``winner``'s class and hyperparameters, holds the merged tensors.
    """
    K = mask.shape[0]

    def pick(a, b):
        if torch.is_tensor(a) and a.dim() >= 1 and a.shape[0] == K:
            m = mask.to(a.device).reshape((K,) + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)
        return a.clone() if torch.is_tensor(a) else a

    variables = {n: _leaf(pick(w.detach(), other.variables[n].detach()))
                 for n, w in winner.variables.items()}

    def names_of(state):
        return {id(p): n for n, p in state.variables.items()}

    def named_state(state):
        names = names_of(state)
        return {names[id(p)]: s for p, s in state.optimizer.state.items()}

    won, lost = named_state(winner), named_state(other)
    if won.keys() != lost.keys():
        raise ValueError("select_per_object needs two states stepped alike: "
                         f"optimizer state for {sorted(won)} against "
                         f"{sorted(lost)}")
    names = names_of(winner)
    groups = [dict(g, params=[variables[names[id(p)]] for p in g["params"]])
              for g in winner.optimizer.param_groups]
    optimizer = type(winner.optimizer)(groups)
    for n, s in won.items():
        optimizer.state[variables[n]] = {k: pick(a, lost[n][k])
                                         for k, a in s.items()}
    return TTOState(variables, optimizer, winner.step)
