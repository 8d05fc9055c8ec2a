"""The render pipeline: coarse -> importance -> fine (counterpart of
``codenerf_tpu/pipeline.py``; reference nerf/__init__.py:74-134).

This slice serves the grad-free render (``perturb=False``).  The JAX
package's TPU gates (``_pallas_active`` / ``_hybrid_active``) become one
rule here: the CodeNeRF trunk runs K1 for CUDA tensors and its plain
version for CPU tensors (``ops/fused.py::trunk_forward``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from codenerf_tpu_torch.config import Config, EmbedderConfig, ModelSpec
from codenerf_tpu_torch.core.encoding import positional_encoding
from codenerf_tpu_torch.models.mlp import CodeNeRF, CodeNeRFConfig
from codenerf_tpu_torch.ops.fused import fused_codenerf, trunk_forward
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
    # train-stage sigma-noise regularizer and NDC rays: training slice
    noise_std: float = 0.0
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
            noise_std=cfg.nerf.train.radiance_field_noise_std)


def _forward(model: CodeNeRF, settings: RenderSettings, pts, rd, z_s, z_t,
             trunk):
    """encode -> CodeNeRF over [R, S] samples through the fused trunk."""
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dir_enc = positional_encoding(viewdirs, settings.num_encoding_fn_dir,
                                  settings.include_input_dir,
                                  settings.log_sampling_dir)
    return fused_codenerf(model, pts, dir_enc, z_s, z_t,
                          num_freq_xyz=settings.num_encoding_fn_xyz,
                          log_sampling_xyz=settings.log_sampling_xyz,
                          trunk=trunk)


@torch.no_grad()
def render_rays(models: dict, settings: RenderSettings, ro, rd, z_s, z_t,
                perturb: bool = False, noise_std: float = 0.0,
                trunk=trunk_forward) -> Tuple[RenderOutputs, RenderOutputs]:
    """Coarse -> importance -> fine render of a ray batch, grad-free.

    models: {"coarse": CodeNeRF, "fine": CodeNeRF}; ro, rd: [R, 3]; z_s,
    z_t: [R, C] per-ray codes.  ``trunk`` is K1's wrapper; the chip smoke
    passes its plain version to render the same image without the kernel.
    Returns (coarse, fine) RenderOutputs.
    """
    if perturb or noise_std > 0.0:
        raise NotImplementedError(
            "stratified jitter and the sigma-noise regularizer belong to "
            "the training slice; the port renders with perturb=False")
    if settings.ndc is not None:
        raise NotImplementedError("NDC rays belong to the training slice")
    if not settings.use_viewdirs:
        raise ValueError("CodeNeRF needs view directions (use_viewdirs)")

    z_grid = base_z_vals(settings.num_coarse, settings.near, settings.far,
                         settings.spacing_mode, dtype=ro.dtype,
                         device=ro.device)
    pts_c, z_c = sample_stratified(ro, rd, z_grid)
    raw_c = _forward(models["coarse"], settings, pts_c, rd, z_s, z_t, trunk)
    out_c = volume_render(raw_c, z_c, rd,
                          white_background=settings.white_background)
    # interior-weight slice per reference nerf/__init__.py:87
    pts_f, z_f = sample_pdf(ro, rd, out_c.weights[..., 1:-1], z_c,
                            settings.num_fine)
    raw_f = _forward(models["fine"], settings, pts_f, rd, z_s, z_t, trunk)
    out_f = volume_render(raw_f, z_f, rd,
                          white_background=settings.white_background)
    return out_c, out_f
