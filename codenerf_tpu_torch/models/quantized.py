"""Int8 serving: CodeNeRF and FlexibleNeRF forwards with int8 weights and
activations (counterpart of ``codenerf_tpu/models/quantized.py``).

Scheme (JAX quantized.py:1-36): symmetric per-input-channel activation
scales, calibrated statically from one deterministic render forward, are
folded into the weight rows, and the folded weight is quantized per
output column:

    x ~= xq * s_ch        (xq = round(x / s_ch), one s_ch per channel)
    y  = x @ W = xq @ (diag(s_ch) W) ~= (xq @ Wq') * sw'[out]

Only the per-sample trunk products are quantized; the per-ray
conditioning halves (``per_ray_conditioning``), ``layer_xyz1`` (unless
``encode_stream``), FlexibleNeRF's ``layer1`` and its skip layers'
xyz-encoding halves stay on the float path.  Quantization is not
differentiable: this is a serving path, and training and TTO never
touch it.

The s8 x s8 -> s32 products are ``torch._int_mm`` (cuBLASLt's int8
tensor-core GEMM on the card), where JAX has ``jnp.dot(...,
preferred_element_type=jnp.int32)`` outside any Pallas kernel.  On CUDA
it takes more than 16 rows and K and N in multiples of 8, so the weights
are zero-padded once, when they are quantized (``QLinear``), and an
activation's K and rows per call (``_qdot``); zero padding is exact in
int32.  The padding runs on every device, so the CPU runs the card's
shapes.  A refused ``_int_mm`` raises: nothing falls back to a float
product.

``quantize_for_serving`` returns ``{"coarse", "fine"}`` modules
(``QuantizedCodeNeRF`` / ``QuantizedFlexibleNeRF``) that
``pipeline.render_rays`` and ``eval/render.py::make_image_renderer`` take
in place of the float models.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from codenerf_tpu_torch.models.mlp import CodeNeRFConfig
from codenerf_tpu_torch.models.ray_structured import (apply_codenerf_rays,
                                                      apply_flexible_rays,
                                                      _lin_relu, _mmc, _w,
                                                      per_ray_conditioning)
from codenerf_tpu_torch.ops.sampling import (base_z_vals, sample_pdf,
                                             sample_stratified)
from codenerf_tpu_torch.ops.volume_render import volume_render

# Activations captured for calibration, in trunk order: each is the input
# of one or more quantized products (fc_out's sigma and feature products
# share x2); "x0", the encode stream, only under encode_stream
ACT_NAMES = ("x1", "x2", "feat", "v1", "v2")
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
MIN_ROWS = 17
ALIGN = 8


def _up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def quantize_tensor(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8: round(x / scale) (half to even) clipped to
    [-127, 127].  ``scale`` is a scalar or per last-axis channel."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """Per-output-column symmetric int8 of w [in, out]: (wq int8 [in,
    out], sw f32 [out])."""
    amax = w.float().abs().amax(dim=0)
    sw = torch.clamp_min(amax, 1e-12) / 127.0
    return quantize_tensor(w, sw[None, :]), sw


def _qdot(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor):
    """xq [..., K] int8 @ wq [K', N'] int8 summed in int32, then f32 times
    ``scale`` [N] (the per-column sw of the activation-folded weight; the
    activation scales are already in wq's rows).  wq may be zero-padded
    (K' >= K, N' >= N): xq's K and its rows (to ``MIN_ROWS``) are
    zero-padded here and the product's first N columns kept.  Counts its
    ``torch._int_mm`` calls in ``_qdot.calls``."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    x = xq.reshape(-1, k)
    m = x.shape[0]
    if k > wq.shape[0]:
        raise ValueError(f"activation K {k} > the weight's {wq.shape[0]}")
    rows = max(m, MIN_ROWS)
    if (rows, wq.shape[0]) != (m, k):
        x = F.pad(x, (0, wq.shape[0] - k, 0, rows - m))
    y = torch._int_mm(x, wq)
    _qdot.calls += 1
    n = scale.shape[0]
    return (y[:m, :n].float() * scale).reshape(*lead, n)


_qdot.calls = 0


class QLinear(nn.Module):
    """One quantized per-sample product: int8 weight ``wq`` [in, out] and
    its f32 per-column ``scale`` [out].  The weight is held zero-padded to
    multiples of 8 as ``wq_t`` [out8, in8], so that ``wq_t.t()`` is the
    column-major operand cuBLASLt's int8 GEMM takes."""

    def __init__(self, wq: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        k, n = wq.shape
        self.in_features, self.out_features = k, n
        wt = wq.new_zeros(_up(n), _up(k))
        wt[:n, :k] = wq.t()
        self.register_buffer("wq_t", wt)
        self.register_buffer("scale", scale.float().contiguous())

    @property
    def wq(self) -> torch.Tensor:
        """The unpadded weight [in, out] (a view)."""
        return self.wq_t[:self.out_features, :self.in_features].t()

    def forward(self, xq):
        return _qdot(xq, self.wq_t.t(), self.scale)


class _Scales(nn.Module):
    """The per-channel activation scales ``s_act`` as named buffers."""

    def __init__(self, scales: dict):
        super().__init__()
        for k, v in scales.items():
            self.register_buffer(k, v.float().contiguous())

    def __getitem__(self, key) -> torch.Tensor:
        return self._buffers[key]

    def keys(self):
        return self._buffers.keys()


class _Quantized(nn.Module):
    """A frozen copy of the float model (``model``: the layers that stay
    on the float path), the activation scales ``s_act`` and the quantized
    products ``quant`` (a ``QLinear`` per JAX "quant" key; a list for
    FlexibleNeRF's ``layers_xyz``).  No parameter requires a gradient."""

    def __init__(self, model: nn.Module, s_act: dict, layers: dict):
        super().__init__()
        self.model = copy.deepcopy(model).requires_grad_(False)
        self.s_act = _Scales(s_act)
        self.quant = nn.ModuleDict({
            k: (nn.ModuleList(QLinear(*p) for p in v) if isinstance(v, list)
                else QLinear(*v)) for k, v in layers.items()})

    @property
    def cfg(self):
        return self.model.cfg


class QuantizedCodeNeRF(_Quantized):
    """Int8 serving form of a ``CodeNeRF`` (``quantize_codenerf``).
    ``quant`` holds layer_xyz2_top, fc_out_sigma, fc_out_feat,
    layer_dir1_top, layer_dir2 and fc_rgb_top, and layer_xyz1 when the
    encode stream is quantized."""


class QuantizedFlexibleNeRF(_Quantized):
    """Int8 serving form of a ``FlexibleNeRF`` (``quantize_flexible``):
    ``quant`` holds layers_xyz (skip layers' hidden halves only) and
    fc_feat, fc_alpha, layer_dir1_top, fc_rgb with view directions, else
    fc_out."""


def _amax(x) -> torch.Tensor:
    """Per-channel amax over every leading axis, in f32 (exact in x's own
    dtype, so taken there)."""
    return x.abs().amax(dim=tuple(range(x.ndim - 1))).float()


@torch.no_grad()
def trunk_activation_amax(model, cfg: CodeNeRFConfig, xyz_enc, dir_enc,
                          z_s, z_t) -> dict:
    """Per-channel amax of every quantized product's input ("x0" x1 x2
    feat v1 v2) over the trunk under ``cfg``'s compute dtype (JAX
    quantized.py:83-117): the ray-structured forward's products."""
    cd = cfg.cdtype
    h = cfg.hidden_size
    if cd is not None:
        xyz_enc = xyz_enc.to(cd)
    zs1, zs2, dir_part, _ = per_ray_conditioning(model, dir_enc, z_s, z_t,
                                                 cfg)
    amax = {"x0": _amax(xyz_enc)}
    x1 = _lin_relu(model.layer_xyz1, xyz_enc, cd)
    amax["x1"] = _amax(x1)
    x2 = torch.relu(_mmc(x1, _w(model.layer_xyz2)[:h], cd)
                    + zs1[:, None, :])
    amax["x2"] = _amax(x2)
    out = _mmc(x2, _w(model.fc_out)[:h], cd) + zs2[:, None, :]
    feat = out[..., 1:]
    amax["feat"] = _amax(feat)
    v1 = torch.relu(_mmc(feat, _w(model.layer_dir1)[:cfg.shape_code_size],
                         cd) + dir_part[:, None, :])
    amax["v1"] = _amax(v1)
    amax["v2"] = _amax(_lin_relu(model.layer_dir2, v1, cd))
    return amax


def _scales(amax: dict, names) -> dict:
    return {k: torch.clamp_min(amax[k].float(), 1e-12) / 127.0
            for k in names}


def _folded(w, s_ch):
    """(wq, sw) of w [in, out] with the input-channel scales folded into
    its rows."""
    return quantize_weight(w.float() * s_ch[:, None])


@torch.no_grad()
def quantize_codenerf(model, cfg: CodeNeRFConfig, amax: dict,
                      encode_stream: bool = False) -> QuantizedCodeNeRF:
    """The int8 serving module of one CodeNeRF (JAX quantized.py:120-162):
    the six per-sample products' weights with the activation scales
    folded into their rows, and layer_xyz1's under ``encode_stream``
    (its input, the positional encoding, then quantized too)."""
    h = cfg.hidden_size
    names = ACT_NAMES + (("x0",) if encode_stream else ())
    s_act = _scales(amax, names)
    wo_top = _w(model.fc_out)[:h]
    layers = {
        "layer_xyz2_top": _folded(_w(model.layer_xyz2)[:h], s_act["x1"]),
        "fc_out_sigma": _folded(wo_top[:, :1], s_act["x2"]),
        "fc_out_feat": _folded(wo_top[:, 1:], s_act["x2"]),
        "layer_dir1_top": _folded(_w(model.layer_dir1)[:cfg.shape_code_size],
                                  s_act["feat"]),
        "layer_dir2": _folded(_w(model.layer_dir2), s_act["v1"]),
        "fc_rgb_top": _folded(_w(model.fc_rgb)[:h], s_act["v2"]),
    }
    if encode_stream:
        layers["layer_xyz1"] = _folded(_w(model.layer_xyz1), s_act["x0"])
    return QuantizedCodeNeRF(model, s_act, layers)


def apply_codenerf_rays_q(qmodel: QuantizedCodeNeRF, xyz_enc, dir_enc, z_s,
                          z_t, cfg=None) -> torch.Tensor:
    """raw [R, S, 4] in f32 from the int8 trunk (JAX quantized.py:165-220),
    under ``cfg`` (default the model's): the per-ray rows and
    layer_xyz1 (without the encode stream) in the compute dtype, each
    product's int32 sum to f32, times its scale, plus its bias or per-ray
    rows, relu, requantized for the next product."""
    cfg = cfg or qmodel.cfg
    cd = cfg.cdtype
    model, q, s = qmodel.model, qmodel.quant, qmodel.s_act
    if cd is not None:
        xyz_enc = xyz_enc.to(cd)
    zs1, zs2, dir_part, zt1 = per_ray_conditioning(model, dir_enc, z_s, z_t,
                                                   cfg)
    if "layer_xyz1" in q:
        x1 = torch.relu(q["layer_xyz1"](quantize_tensor(xyz_enc, s["x0"]))
                        + model.layer_xyz1.bias.float())
    else:
        x1 = _lin_relu(model.layer_xyz1, xyz_enc, cd)
    x2 = torch.relu(q["layer_xyz2_top"](quantize_tensor(x1, s["x1"]))
                    + zs1[:, None, :].float())
    x2q = quantize_tensor(x2, s["x2"])
    zs2 = zs2[:, None, :].float()
    sigma = q["fc_out_sigma"](x2q) + zs2[..., :1]
    feat = q["fc_out_feat"](x2q) + zs2[..., 1:]
    v1 = torch.relu(q["layer_dir1_top"](quantize_tensor(feat, s["feat"]))
                    + dir_part[:, None, :].float())
    v2 = torch.relu(q["layer_dir2"](quantize_tensor(v1, s["v1"]))
                    + model.layer_dir2.bias.float())
    rgb = (q["fc_rgb_top"](quantize_tensor(v2, s["v2"]))
           + zt1[:, None, :].float())
    return torch.cat([rgb, sigma], dim=-1)


@torch.no_grad()
def flexible_trunk_amax(model, cfg, xyz_enc, dir_enc) -> dict:
    """Per-channel amax of the vanilla trunk's quantized inputs (JAX
    quantized.py:228-263): t{i} (the input of layers_xyz[i]), "last" (of
    fc_feat / fc_out) and, with view directions, "feat" (of fc_alpha and
    layer_dir1's top) and "v1" (of fc_rgb)."""
    cd = cfg.cdtype
    h = cfg.hidden_size
    if cd is not None:
        xyz_enc = xyz_enc.to(cd)
        if dir_enc is not None:
            dir_enc = dir_enc.to(cd)
    amax = {}
    out = _lin_relu(model.layer1, xyz_enc, cd)
    for i, layer in enumerate(model.layers_xyz):
        amax[f"t{i}"] = _amax(out)
        if i in cfg.skip_connect_ids:
            w = _w(layer)
            y = _mmc(out, w[:h], cd) + _mmc(xyz_enc, w[h:], cd)
            out = torch.relu(y + layer.bias.to(y.dtype))
        else:
            out = _lin_relu(layer, out, cd)
    amax["last"] = _amax(out)
    if cfg.use_viewdirs:
        feat = _lin_relu(model.fc_feat, out, cd)
        amax["feat"] = _amax(feat)
        layer_dir1 = model.layers_dir[0]
        wd = _w(layer_dir1)
        dp = _mmc(dir_enc, wd[h:], cd)
        dir_part = dp + layer_dir1.bias.to(dp.dtype)
        amax["v1"] = _amax(torch.relu(_mmc(feat, wd[:h], cd)
                                      + dir_part[:, None, :]))
    return amax


@torch.no_grad()
def quantize_flexible(model, cfg, amax: dict) -> QuantizedFlexibleNeRF:
    """The int8 serving module of one FlexibleNeRF (JAX
    quantized.py:266-297): every trunk layer's weight (a skip layer's
    hidden half only) and the heads', activation scales folded in."""
    h = cfg.hidden_size
    s_act = _scales(amax, amax)
    layers = {"layers_xyz": [
        _folded(_w(layer)[:h] if i in cfg.skip_connect_ids else _w(layer),
                s_act[f"t{i}"]) for i, layer in enumerate(model.layers_xyz)]}
    if cfg.use_viewdirs:
        layers["fc_feat"] = _folded(_w(model.fc_feat), s_act["last"])
        layers["fc_alpha"] = _folded(_w(model.fc_alpha), s_act["feat"])
        layers["layer_dir1_top"] = _folded(_w(model.layers_dir[0])[:h],
                                           s_act["feat"])
        layers["fc_rgb"] = _folded(_w(model.fc_rgb), s_act["v1"])
    else:
        layers["fc_out"] = _folded(_w(model.fc_out), s_act["last"])
    return QuantizedFlexibleNeRF(model, s_act, layers)


def apply_flexible_rays_q(qmodel: QuantizedFlexibleNeRF, xyz_enc,
                          dir_enc=None, cfg=None) -> torch.Tensor:
    """raw [R, S, 4] in f32 from the int8 vanilla trunk (JAX
    quantized.py:300-345): layer1 and the skip layers' xyz_enc @ w_bot
    halves, and layer_dir1's per-ray rows, in the compute dtype."""
    cfg = cfg or qmodel.cfg
    cd = cfg.cdtype
    h = cfg.hidden_size
    model, q, s = qmodel.model, qmodel.quant, qmodel.s_act
    if cd is not None:
        xyz_enc = xyz_enc.to(cd)
        if dir_enc is not None:
            dir_enc = dir_enc.to(cd)
    out = _lin_relu(model.layer1, xyz_enc, cd)
    for i, layer in enumerate(model.layers_xyz):
        y = q["layers_xyz"][i](quantize_tensor(out, s[f"t{i}"]))
        if i in cfg.skip_connect_ids:
            y = y + _mmc(xyz_enc, _w(layer)[h:], cd).float()
        out = torch.relu(y + layer.bias.float())
    lastq = quantize_tensor(out, s["last"])
    if not cfg.use_viewdirs:
        return q["fc_out"](lastq) + model.fc_out.bias.float()
    feat = torch.relu(q["fc_feat"](lastq) + model.fc_feat.bias.float())
    featq = quantize_tensor(feat, s["feat"])
    sigma = q["fc_alpha"](featq) + model.fc_alpha.bias.float()
    layer_dir1 = model.layers_dir[0]
    dp = _mmc(dir_enc, _w(layer_dir1)[h:], cd)
    dir_part = dp + layer_dir1.bias.to(dp.dtype)
    v1 = torch.relu(q["layer_dir1_top"](featq)
                    + dir_part[:, None, :].float())
    rgb = q["fc_rgb"](quantize_tensor(v1, s["v1"])) + model.fc_rgb.bias.float()
    return torch.cat([rgb, sigma], dim=-1)


def _trunk_amax(model, cfg, xyz_enc, dir_enc, z_s, z_t) -> dict:
    if isinstance(cfg, CodeNeRFConfig):
        return trunk_activation_amax(model, cfg, xyz_enc, dir_enc, z_s, z_t)
    return flexible_trunk_amax(model, cfg, xyz_enc, dir_enc)


def _quantize_model(model, cfg, amax: dict, encode_stream: bool):
    if isinstance(cfg, CodeNeRFConfig):
        return quantize_codenerf(model, cfg, amax, encode_stream)
    # FlexibleNeRF's encode stays on the float path (skip layers read it)
    return quantize_flexible(model, cfg, amax)


@torch.no_grad()
def quantize_for_serving(models: dict, settings, ro, rd, z_s, z_t,
                         encode_stream: bool = False) -> dict:
    """Calibrate and quantize ``{"coarse", "fine"}`` on a ray batch (ro, rd
    [R, 3]; per-ray codes [R, C], None for FlexibleNeRF) by one
    deterministic forward (JAX quantized.py:361-417): coarse samples with
    perturb off, the coarse amax and raw from the float ray-structured
    forward under ``settings.coarse_cfg`` (whatever the trunk's path),
    the composite, inverse-CDF fine samples, the fine amax.  As JAX's
    calibrator, it samples world-space rays between ``settings.near`` and
    ``far`` and never applies ``settings.ndc`` (an LLFF model is
    calibrated on world points at depths 0 to 1).  Returns ``{"coarse",
    "fine"}`` quantized modules."""
    from codenerf_tpu_torch.pipeline import encode_inputs
    z_grid = base_z_vals(settings.num_coarse, settings.near, settings.far,
                         settings.spacing_mode, dtype=ro.dtype,
                         device=ro.device)
    pts_c, z_c = sample_stratified(ro, rd, z_grid)
    xyz_c, dir_enc = encode_inputs(settings, pts_c, rd)
    coarse, ccfg = models["coarse"], settings.coarse_cfg
    amax_c = _trunk_amax(coarse, ccfg, xyz_c, dir_enc, z_s, z_t)
    if isinstance(ccfg, CodeNeRFConfig):
        raw_c = apply_codenerf_rays(coarse, xyz_c, dir_enc, z_s, z_t, ccfg)
    else:
        raw_c = apply_flexible_rays(coarse, xyz_c, dir_enc, ccfg)
    out_c = volume_render(raw_c, z_c, rd)
    pts_f, _ = sample_pdf(ro, rd, out_c.weights[..., 1:-1], z_c,
                          settings.num_fine)
    xyz_f, _ = encode_inputs(settings, pts_f, rd)
    amax_f = _trunk_amax(models["fine"], settings.fine_cfg, xyz_f, dir_enc,
                         z_s, z_t)
    return {"coarse": _quantize_model(coarse, ccfg, amax_c, encode_stream),
            "fine": _quantize_model(models["fine"], settings.fine_cfg,
                                    amax_f, encode_stream)}
