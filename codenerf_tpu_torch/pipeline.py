"""The render pipeline: coarse -> importance -> fine (counterpart of
``codenerf_tpu/pipeline.py``; reference nerf/__init__.py:74-134).

``render_rays`` is the grad-free serving render (``perturb=False``);
``render_rays_train`` is the train-mode render with gradients, stratified
and inverse-CDF jitter and the sigma-noise regularizer.

The trunk's path follows JAX's gates (pipeline.py:200-248, remat at
:296-306), picked by the runtime flags alone (``trunk_path``):

  use_pallas + pallas_backward   "fused": K1 forward, K2 backward
  use_pallas                     "fused_recompute": K1 forward, autograd
                                 through the ray-structured forward,
                                 recomputed
  pallas_hybrid                  "hybrid": plain forward storing the
                                 activations, K3 backward
  none of these                  "rays": ``apply_codenerf_rays``, each relu
                                 layer's backward K4 under
                                 ``pallas_layer_bwd``; under ``remat`` each
                                 pass's forward is recomputed in the
                                 backward (``torch.utils.checkpoint``)

JAX's ``default_backend() == "tpu"`` clause becomes the port's one rule:
within a path, CUDA tensors run the kernels and CPU tensors their plain
versions.  No path is picked after a kernel fails.  K1-K4 compute in
bf16 or f32, so every path runs an f32 config on the card as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from codenerf_tpu_torch.config import Config, EmbedderConfig, ModelSpec
from codenerf_tpu_torch.core.encoding import positional_encoding
from codenerf_tpu_torch.models.mlp import CodeNeRF, CodeNeRFConfig
from codenerf_tpu_torch.models.ray_structured import apply_codenerf_rays
from codenerf_tpu_torch.ops.fused import recompute_codenerf, train_codenerf
from codenerf_tpu_torch.ops.sampling import (base_z_vals, sample_pdf,
                                             sample_stratified)
from codenerf_tpu_torch.ops.volume_render import RenderOutputs, volume_render


def model_config_from_spec(spec: ModelSpec, embedder: EmbedderConfig,
                           shape_code_size: int, texture_code_size: int,
                           compute_dtype: Optional[str] = None,
                           pallas_layer_bwd: bool = False,
                           split_fc_out: bool = False,
                           fc_out_tail_sigma: bool = False
                           ) -> CodeNeRFConfig:
    if spec.type != "CodeNeRFModel":
        raise NotImplementedError(
            f"model type {spec.type}: the port has CodeNeRF only so far")
    return CodeNeRFConfig(
        hidden_size=spec.hidden_size,
        shape_code_size=shape_code_size,
        texture_code_size=texture_code_size,
        num_encoding_fn_xyz=embedder.num_encoding_fn_xyz,
        num_encoding_fn_dir=embedder.num_encoding_fn_dir,
        include_input_xyz=embedder.include_input_xyz,
        include_input_dir=embedder.include_input_dir,
        compute_dtype=compute_dtype,
        pallas_layer_bwd=pallas_layer_bwd,
        split_fc_out=split_fc_out,
        fc_out_tail_sigma=fc_out_tail_sigma)


@dataclass(frozen=True)
class RenderSettings:
    """Render-pipeline configuration."""
    num_coarse: int
    num_fine: int
    near: float
    far: float
    spacing_mode: str
    num_encoding_fn_xyz: int
    include_input_xyz: bool
    log_sampling_xyz: bool
    use_viewdirs: bool
    num_encoding_fn_dir: int
    include_input_dir: bool
    log_sampling_dir: bool
    coarse_cfg: CodeNeRFConfig
    fine_cfg: CodeNeRFConfig
    white_background: bool = False
    # train-stage sigma-noise regularizer (render_rays_train only)
    noise_std: float = 0.0
    # the trunk's path (trunk_path)
    remat: bool = False
    use_pallas: bool = False
    pallas_backward: bool = False
    pallas_hybrid: bool = False
    # NDC rays: not ported yet
    ndc: Optional[Tuple[float, float, float]] = None

    @staticmethod
    def from_config(cfg: Config, compute_dtype: Optional[str] = None
                    ) -> "RenderSettings":
        ps, emb = cfg.nerf.point_sampler, cfg.nerf.embedder
        dt = compute_dtype if compute_dtype is not None else (
            cfg.runtime.compute_dtype or None)
        if dt == "float32":
            dt = None
        emb_sizes = cfg.models.embedding
        rt = cfg.runtime

        def mk(spec):
            return model_config_from_spec(
                spec, emb, emb_sizes.shape_code_size,
                emb_sizes.texture_code_size, dt,
                pallas_layer_bwd=rt.pallas_layer_bwd,
                split_fc_out=rt.split_fc_out,
                fc_out_tail_sigma=rt.fc_out_tail_sigma)

        return RenderSettings(
            num_coarse=ps.num_coarse, num_fine=ps.num_fine,
            near=ps.near_limit, far=ps.far_limit,
            spacing_mode=ps.spacing_mode,
            num_encoding_fn_xyz=emb.num_encoding_fn_xyz,
            include_input_xyz=emb.include_input_xyz,
            log_sampling_xyz=emb.log_sampling_xyz,
            use_viewdirs=emb.use_viewdirs,
            num_encoding_fn_dir=emb.num_encoding_fn_dir,
            include_input_dir=emb.include_input_dir,
            log_sampling_dir=emb.log_sampling_dir,
            coarse_cfg=mk(cfg.models.nerf_coarse),
            fine_cfg=mk(cfg.models.nerf_fine),
            white_background=cfg.nerf.white_background,
            noise_std=cfg.nerf.train.radiance_field_noise_std,
            remat=rt.remat, use_pallas=rt.use_pallas,
            pallas_backward=rt.pallas_backward,
            pallas_hybrid=rt.pallas_hybrid)


def trunk_path(settings: RenderSettings) -> str:
    """The trunk's path for ``settings``: "fused", "fused_recompute",
    "hybrid" or "rays" (module docstring)."""
    if settings.use_pallas:
        return "fused" if settings.pallas_backward else "fused_recompute"
    if settings.pallas_hybrid:
        return "hybrid"
    return "rays"


def remat_active(settings: RenderSettings) -> bool:
    """Whether the train render recomputes each pass's forward in the
    backward: ``remat`` on the "rays" path only, as in JAX (the Pallas
    modes' Functions already recompute or store)."""
    return settings.remat and trunk_path(settings) == "rays"


def _forward(model: CodeNeRF, model_cfg: CodeNeRFConfig,
             settings: RenderSettings, pts, rd, z_s, z_t):
    """encode -> CodeNeRF over [R, S] samples on the trunk's path, the
    ray-structured products under ``model_cfg`` (the settings' config of
    this model).  Under ``torch.no_grad`` the paths' Functions run their
    forwards only."""
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dir_enc = positional_encoding(viewdirs, settings.num_encoding_fn_dir,
                                  settings.include_input_dir,
                                  settings.log_sampling_dir)
    path = trunk_path(settings)
    if path == "rays":
        xyz_enc = positional_encoding(pts, settings.num_encoding_fn_xyz,
                                      settings.include_input_xyz,
                                      settings.log_sampling_xyz)
        return apply_codenerf_rays(model, xyz_enc, dir_enc, z_s, z_t,
                                   model_cfg)
    kw = dict(num_freq_xyz=settings.num_encoding_fn_xyz,
              log_sampling_xyz=settings.log_sampling_xyz)
    if path == "fused_recompute":
        return recompute_codenerf(model, pts, dir_enc, z_s, z_t,
                                  cfg=model_cfg, **kw)
    return train_codenerf(model, pts, dir_enc, z_s, z_t,
                          hybrid=path == "hybrid", **kw)


@torch.no_grad()
def render_rays(models: dict, settings: RenderSettings, ro, rd, z_s, z_t,
                perturb: bool = False, noise_std: float = 0.0
                ) -> Tuple[RenderOutputs, RenderOutputs]:
    """Coarse -> importance -> fine render of a ray batch, grad-free.

    models: {"coarse": CodeNeRF, "fine": CodeNeRF}; ro, rd: [R, 3]; z_s,
    z_t: [R, C] per-ray codes.  Returns (coarse, fine) RenderOutputs.
    """
    if perturb or noise_std > 0.0:
        raise NotImplementedError(
            "stratified jitter and the sigma-noise regularizer belong to "
            "render_rays_train; the serving render uses perturb=False")
    if settings.ndc is not None:
        raise NotImplementedError("NDC rays are not ported yet")
    if not settings.use_viewdirs:
        raise ValueError("CodeNeRF needs view directions (use_viewdirs)")

    z_grid = base_z_vals(settings.num_coarse, settings.near, settings.far,
                         settings.spacing_mode, dtype=ro.dtype,
                         device=ro.device)
    pts_c, z_c = sample_stratified(ro, rd, z_grid)
    raw_c = _forward(models["coarse"], settings.coarse_cfg, settings, pts_c,
                     rd, z_s, z_t)
    out_c = volume_render(raw_c, z_c, rd,
                          white_background=settings.white_background)
    # interior-weight slice per reference nerf/__init__.py:87
    pts_f, z_f = sample_pdf(ro, rd, out_c.weights[..., 1:-1], z_c,
                            settings.num_fine)
    raw_f = _forward(models["fine"], settings.fine_cfg, settings, pts_f, rd,
                     z_s, z_t)
    out_f = volume_render(raw_f, z_f, rd,
                          white_background=settings.white_background)
    return out_c, out_f


def add_sigma_noise(raw, noise):
    """raw with ``noise`` [R, S] added to the sigma channel (JAX
    pipeline.py:312-318)."""
    return torch.cat([raw[..., :3], raw[..., 3:] + noise[..., None]], dim=-1)


def render_rays_train(models: dict, settings: RenderSettings, ro, rd, z_s,
                      z_t, generator: Optional[torch.Generator] = None,
                      perturb: bool = True, noise_std: float = 0.0,
                      draws: Optional[dict] = None
                      ) -> Tuple[RenderOutputs, RenderOutputs]:
    """Coarse -> importance -> fine render with gradients (JAX
    ``render_rays``, pipeline.py:252-334).

    With ``perturb`` the depths are jittered and, when ``noise_std > 0``,
    N(0, noise_std) is added to each raw sigma (the reference's
    ``radiance_field_noise_std``).  The draws come from ``generator`` in
    the order coarse jitter, coarse noise, fine u, fine noise, or from
    ``draws`` ({"t_rand", "u", "noise_c", "noise_f"}) so that a test can
    feed JAX's.  The trunk takes ``trunk_path(settings)``, under
    ``remat_active(settings)`` through ``torch.utils.checkpoint``.
    """
    if settings.ndc is not None:
        raise NotImplementedError("NDC rays are not ported yet")
    if not settings.use_viewdirs:
        raise ValueError("CodeNeRF needs view directions (use_viewdirs)")
    draws = draws or {}
    noisy = noise_std > 0.0 and perturb

    def forward(model, model_cfg, pts):
        if remat_active(settings):
            return checkpoint(_forward, model, model_cfg, settings, pts, rd,
                              z_s, z_t, use_reentrant=False)
        return _forward(model, model_cfg, settings, pts, rd, z_s, z_t)

    def noise(key, shape):
        if key in draws:
            return noise_std * draws[key].to(ro.device, ro.dtype)
        return noise_std * torch.randn(shape, generator=generator,
                                       dtype=ro.dtype, device=ro.device)

    z_grid = base_z_vals(settings.num_coarse, settings.near, settings.far,
                         settings.spacing_mode, dtype=ro.dtype,
                         device=ro.device)
    pts_c, z_c = sample_stratified(ro, rd, z_grid, perturb, generator,
                                   draws.get("t_rand"))
    raw_c = forward(models["coarse"], settings.coarse_cfg, pts_c)
    if noisy:
        raw_c = add_sigma_noise(raw_c, noise("noise_c", raw_c.shape[:-1]))
    out_c = volume_render(raw_c, z_c, rd,
                          white_background=settings.white_background)
    # interior-weight slice per reference nerf/__init__.py:87
    pts_f, z_f = sample_pdf(ro, rd, out_c.weights[..., 1:-1], z_c,
                            settings.num_fine, perturb, generator,
                            draws.get("u"))
    raw_f = forward(models["fine"], settings.fine_cfg, pts_f)
    if noisy:
        raw_f = add_sigma_noise(raw_f, noise("noise_f", raw_f.shape[:-1]))
    out_f = volume_render(raw_f, z_f, rd,
                          white_background=settings.white_background)
    return out_c, out_f
