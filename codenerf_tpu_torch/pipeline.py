"""The render pipeline: coarse -> importance -> fine (counterpart of
``codenerf_tpu/pipeline.py``; reference nerf/__init__.py:74-134).

``render_rays`` is the grad-free serving render (``perturb=False``);
``render_rays_train`` is the train-mode render with gradients, stratified
and inverse-CDF jitter and the sigma-noise regularizer.  The JAX package's
TPU gates (``_pallas_active`` / ``_hybrid_active``) become one rule here:
the CodeNeRF trunk runs its kernels for CUDA tensors and their plain
versions for CPU tensors (``ops/fused.py``).  Training runs one of the JAX
package's two Pallas modes: fused (K1 forward, K2 backward) by default, or
hybrid (plain forward that stores the activations, K3 backward) under
``runtime.pallas_hybrid``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from codenerf_tpu_torch.config import Config, EmbedderConfig, ModelSpec
from codenerf_tpu_torch.core.encoding import positional_encoding
from codenerf_tpu_torch.models.mlp import CodeNeRF, CodeNeRFConfig
from codenerf_tpu_torch.ops.fused import fused_codenerf, train_codenerf
from codenerf_tpu_torch.ops.sampling import (base_z_vals, sample_pdf,
                                             sample_stratified)
from codenerf_tpu_torch.ops.volume_render import RenderOutputs, volume_render


def model_config_from_spec(spec: ModelSpec, embedder: EmbedderConfig,
                           shape_code_size: int, texture_code_size: int,
                           compute_dtype: Optional[str] = None
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
        compute_dtype=compute_dtype)


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
    # train mode: hybrid (K3 backward) instead of fused (K2 backward)
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

        def mk(spec):
            return model_config_from_spec(
                spec, emb, emb_sizes.shape_code_size,
                emb_sizes.texture_code_size, dt)

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
            pallas_hybrid=cfg.runtime.pallas_hybrid)


def _forward(model: CodeNeRF, settings: RenderSettings, pts, rd, z_s, z_t,
             mode=None):
    """encode -> CodeNeRF over [R, S] samples through the fused trunk:
    grad-free (``mode`` None), or with gradients in ``mode`` "fused" or
    "hybrid"."""
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dir_enc = positional_encoding(viewdirs, settings.num_encoding_fn_dir,
                                  settings.include_input_dir,
                                  settings.log_sampling_dir)
    kw = dict(num_freq_xyz=settings.num_encoding_fn_xyz,
              log_sampling_xyz=settings.log_sampling_xyz)
    if mode is None:
        return fused_codenerf(model, pts, dir_enc, z_s, z_t, **kw)
    return train_codenerf(model, pts, dir_enc, z_s, z_t,
                          hybrid=mode == "hybrid", **kw)


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
    raw_c = _forward(models["coarse"], settings, pts_c, rd, z_s, z_t)
    out_c = volume_render(raw_c, z_c, rd,
                          white_background=settings.white_background)
    # interior-weight slice per reference nerf/__init__.py:87
    pts_f, z_f = sample_pdf(ro, rd, out_c.weights[..., 1:-1], z_c,
                            settings.num_fine)
    raw_f = _forward(models["fine"], settings, pts_f, rd, z_s, z_t)
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
    feed JAX's.  The trunk runs in fused mode, or hybrid mode when
    ``settings.pallas_hybrid``.
    """
    if settings.ndc is not None:
        raise NotImplementedError("NDC rays are not ported yet")
    if not settings.use_viewdirs:
        raise ValueError("CodeNeRF needs view directions (use_viewdirs)")
    draws = draws or {}
    noisy = noise_std > 0.0 and perturb
    mode = "hybrid" if settings.pallas_hybrid else "fused"

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
    raw_c = _forward(models["coarse"], settings, pts_c, rd, z_s, z_t,
                     mode=mode)
    if noisy:
        raw_c = add_sigma_noise(raw_c, noise("noise_c", raw_c.shape[:-1]))
    out_c = volume_render(raw_c, z_c, rd,
                          white_background=settings.white_background)
    # interior-weight slice per reference nerf/__init__.py:87
    pts_f, z_f = sample_pdf(ro, rd, out_c.weights[..., 1:-1], z_c,
                            settings.num_fine, perturb, generator,
                            draws.get("u"))
    raw_f = _forward(models["fine"], settings, pts_f, rd, z_s, z_t,
                     mode=mode)
    if noisy:
        raw_f = add_sigma_noise(raw_f, noise("noise_f", raw_f.shape[:-1]))
    out_f = volume_render(raw_f, z_f, rd,
                          white_background=settings.white_background)
    return out_c, out_f
