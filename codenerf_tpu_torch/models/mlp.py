"""The CodeNeRF and vanilla NeRF (FlexibleNeRF) MLPs as ``nn.Module``s
(counterpart of ``codenerf_tpu/models/mlp.py``; reference model.py:6-76
and 123-194).

The ``nn.Linear`` layers carry the reference state-dict names
(``codenerf_tpu/train/torch_import.py::codenerf_state_dict`` and
``flexible_state_dict``), so a reference checkpoint loads with
``strict=True``.  Weights are in torch's ``[out, in]`` layout; the JAX
package keeps ``[in, out]`` (``weights.py`` converts).  The forwards are
the ray-structured applies of ``models/ray_structured.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from codenerf_tpu_torch.device import resolve_device

LAYER_NAMES = ("layer_xyz1", "layer_xyz2", "fc_out", "shape_code_layer1",
               "shape_code_layer2", "texture_code_layer1", "layer_dir1",
               "layer_dir2", "fc_rgb")


@dataclass(frozen=True)
class CodeNeRFConfig:
    """Mirror of the reference CodeNeRFModel arguments (model.py:124-134)."""
    hidden_size: int = 128
    shape_code_size: int = 128
    texture_code_size: int = 128
    num_encoding_fn_xyz: int = 6
    num_encoding_fn_dir: int = 4
    include_input_xyz: bool = True
    include_input_dir: bool = True
    # bf16 products with f32 accumulation; None = full f32
    compute_dtype: str | None = None
    # each relu layer's backward through K4 (ops/layer_bwd.py)
    pallas_layer_bwd: bool = False
    # fc_out as separate sigma and feature products (the image renderer
    # sets it)
    split_fc_out: bool = False
    # fc_out as one product with its columns permuted to [feat | sigma]
    fc_out_tail_sigma: bool = False

    @property
    def dim_xyz(self) -> int:
        return (3 if self.include_input_xyz else 0) + 6 * self.num_encoding_fn_xyz

    @property
    def dim_dir(self) -> int:
        return (3 if self.include_input_dir else 0) + 6 * self.num_encoding_fn_dir

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype) if self.compute_dtype else None


def _init_linear(fan_in: int, fan_out: int, generator) -> nn.Linear:
    """``nn.Linear``'s default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from ``generator`` (weight, then bias)."""
    layer = nn.Linear(fan_in, fan_out)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class CodeNeRF(nn.Module):
    """CodeNeRF MLP (layer widths per model.py:145-156).

    Initialization is ``nn.Linear``'s default, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weight and bias, drawn on the CPU from
    ``generator`` (a CPU ``torch.Generator``) when one is given and then
    moved to ``device``, so a seed gives the same weights on every device.
    """

    def __init__(self, cfg: CodeNeRFConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, s, t = cfg.hidden_size, cfg.shape_code_size, cfg.texture_code_size
        dims = {
            "layer_xyz1": (cfg.dim_xyz, h),
            "layer_xyz2": (h + s, h),
            "fc_out": (h + s, s + 1),
            "shape_code_layer1": (s, s),
            "shape_code_layer2": (s, s),
            # the reference sizes this by shape_code_size on both sides
            # (model.py:151); texture_code_size is right when they differ
            "texture_code_layer1": (t, t),
            "layer_dir1": (cfg.dim_dir + s, h),
            "layer_dir2": (h, h),
            "fc_rgb": (h + t, 3),
        }
        dev = resolve_device(device)
        for name in LAYER_NAMES:
            setattr(self, name, _init_linear(*dims[name], generator))
        self.to(dev)

    def forward(self, xyz_enc, dir_enc, z_s, z_t):
        """raw [R, S, 4] from xyz_enc [R, S, dim_xyz], dir_enc [R, dim_dir]
        and codes [R, C]."""
        from codenerf_tpu_torch.models.ray_structured import (
            apply_codenerf_rays)
        return apply_codenerf_rays(self, xyz_enc, dir_enc, z_s, z_t)


@dataclass(frozen=True)
class FlexibleNeRFConfig:
    """Mirror of the reference FlexibleNeRFModel arguments (model.py:6-16)
    and of JAX's ``FlexibleNeRFConfig``."""
    num_layers: int = 4
    hidden_size: int = 128
    skip_connect_ids: tuple = (4,)
    num_encoding_fn_xyz: int = 6
    num_encoding_fn_dir: int = 4
    include_input_xyz: bool = True
    include_input_dir: bool = True
    use_viewdirs: bool = True
    # bf16 products with f32 accumulation; None = full f32
    compute_dtype: str | None = None
    # each non-skip trunk layer's, fc_feat's and layer_dir1's backward
    # through K4 (ops/layer_bwd.py)
    pallas_layer_bwd: bool = False

    @property
    def dim_xyz(self) -> int:
        return (3 if self.include_input_xyz else 0) + 6 * self.num_encoding_fn_xyz

    @property
    def dim_dir(self) -> int:
        if not self.use_viewdirs:
            return 0
        return (3 if self.include_input_dir else 0) + 6 * self.num_encoding_fn_dir

    @property
    def cdtype(self):
        return getattr(torch, self.compute_dtype) if self.compute_dtype else None


class FlexibleNeRF(nn.Module):
    """The vanilla NeRF MLP (layer widths per model.py:27-47): ``layer1``
    dim_xyz -> h; ``layers_xyz[i]`` (dim_xyz + h if i is a skip id, else
    h) -> h for the num_layers - 1 trunk layers (a skip id at or past
    their count is inert, as in JAX); with view directions ``fc_feat``
    h -> h, ``layers_dir.0`` dim_dir + h -> h/2, ``fc_alpha`` h -> 1 and
    ``fc_rgb`` h/2 -> 3, else ``fc_out`` h -> 4.  Initialized as
    ``CodeNeRF``, from ``generator`` on the CPU in definition order."""

    def __init__(self, cfg: FlexibleNeRFConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        h, dx = cfg.hidden_size, cfg.dim_xyz
        dev = resolve_device(device)
        self.layer1 = _init_linear(dx, h, generator)
        self.layers_xyz = nn.ModuleList(
            _init_linear(dx + h if i in cfg.skip_connect_ids else h, h,
                         generator)
            for i in range(cfg.num_layers - 1))
        if cfg.use_viewdirs:
            self.fc_feat = _init_linear(h, h, generator)
            self.layers_dir = nn.ModuleList(
                [_init_linear(cfg.dim_dir + h, h // 2, generator)])
            self.fc_alpha = _init_linear(h, 1, generator)
            self.fc_rgb = _init_linear(h // 2, 3, generator)
        else:
            self.fc_out = _init_linear(h, 4, generator)
        self.to(dev)

    def forward(self, xyz_enc, dir_enc=None):
        """raw [R, S, 4] from xyz_enc [R, S, dim_xyz] and dir_enc
        [R, dim_dir] (None without view directions)."""
        from codenerf_tpu_torch.models.ray_structured import (
            apply_flexible_rays)
        return apply_flexible_rays(self, xyz_enc, dir_enc)


def build_model(cfg, device="cuda", generator=None) -> nn.Module:
    """The module of a model config: ``CodeNeRF`` or ``FlexibleNeRF``."""
    if isinstance(cfg, FlexibleNeRFConfig):
        return FlexibleNeRF(cfg, device, generator)
    return CodeNeRF(cfg, device, generator)
