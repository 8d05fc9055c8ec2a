"""Bridge from the JAX package's parameter pytrees to the port's state
dicts.

The inputs are numpy views of the JAX pytrees (``{layer: {"w", "b"}}``
with ``w`` as ``[in, out]``, FlexibleNeRF's ``layers_xyz`` a list of
them, and ``{"shape", "texture"}`` code tables);
nothing here imports JAX.  The outputs use the reference state-dict
names, as ``codenerf_tpu/train/torch_import.py`` writes them.  TTO
variables ({"z_s", "z_t", "theta", "phi", "rho"} or {"z_s", "z_t",
"xi"}) carry over as leaf tensors, and a JAX ``quantize_for_serving``
result becomes the port's int8 serving modules.
"""

from __future__ import annotations

import numpy as np
import torch

from codenerf_tpu_torch.device import resolve_device
from codenerf_tpu_torch.models.mlp import LAYER_NAMES, FlexibleNeRF
from codenerf_tpu_torch.models.quantized import (QuantizedCodeNeRF,
                                                 QuantizedFlexibleNeRF)


def _linear(out: dict, name: str, layer_np: dict) -> None:
    w = np.asarray(layer_np["w"], np.float32)
    b = np.asarray(layer_np["b"], np.float32)
    out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
    out[f"{name}.bias"] = torch.from_numpy(b.copy())


def codenerf_from_jax(params_np: dict) -> dict:
    """CodeNeRF pytree -> ``CodeNeRF`` state dict ([in, out] -> [out, in])."""
    out = {}
    for name in LAYER_NAMES:
        _linear(out, name, params_np[name])
    return out


def flexible_from_jax(params_np: dict) -> dict:
    """FlexibleNeRF pytree -> ``FlexibleNeRF`` state dict, with the names
    JAX's ``flexible_state_dict`` writes (``layer_dir1`` as
    ``layers_dir.0``)."""
    out = {}
    _linear(out, "layer1", params_np["layer1"])
    for i, layer in enumerate(params_np["layers_xyz"]):
        _linear(out, f"layers_xyz.{i}", layer)
    if "fc_feat" in params_np:
        for name, key in (("fc_feat", "fc_feat"),
                          ("layers_dir.0", "layer_dir1"),
                          ("fc_alpha", "fc_alpha"), ("fc_rgb", "fc_rgb")):
            _linear(out, name, params_np[key])
    else:
        _linear(out, "fc_out", params_np["fc_out"])
    return out


def codes_from_jax(codes_np: dict) -> dict:
    """Code tables -> ``CodeTables`` state dict."""
    return {
        "shape_embedding.weight": torch.from_numpy(
            np.array(codes_np["shape"], np.float32)),
        "texture_embedding.weight": torch.from_numpy(
            np.array(codes_np["texture"], np.float32)),
    }


def params_from_jax(state, params_np: dict) -> None:
    """Load the JAX package's ``{"coarse", "fine", "codes"?}`` parameters
    (numpy views) into a ``TrainState``'s models (``CodeNeRF`` or
    ``FlexibleNeRF``) and code tables, in place, so that both packages
    start from the same weights."""
    for key in ("coarse", "fine"):
        model = state.models[key]
        convert = (flexible_from_jax if isinstance(model, FlexibleNeRF)
                   else codenerf_from_jax)
        dev = next(model.parameters()).device
        model.load_state_dict({k: v.to(dev) for k, v in
                               convert(params_np[key]).items()}, strict=True)
    if state.tables is None:
        return
    dev = state.tables.shape_embedding.weight.device
    state.tables.load_state_dict(
        {k: v.to(dev) for k, v in codes_from_jax(params_np["codes"]).items()},
        strict=True)


def tto_variables_from_jax(variables_np: dict, device="cuda") -> dict:
    """A JAX TTO ``variables`` dict (numpy views) -> the port's TTO
    variables: f32 leaf tensors on ``device`` that require grad, ready
    for ``train.optim.build_tto_optimizer`` or
    ``build_se3_refine_optimizer``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev,
                            requires_grad=True)
            for k, v in variables_np.items()}


def quantized_from_jax(qparams_np: dict, models: dict) -> dict:
    """A JAX ``quantize_for_serving`` result (numpy views of ``{"coarse",
    "fine"}``, each with its ``"quant"`` subtree: ``s_act`` and ``{"wq",
    "scale"}`` per product, FlexibleNeRF's ``layers_xyz`` a list) -> the
    port's ``QuantizedCodeNeRF`` / ``QuantizedFlexibleNeRF`` around
    ``models``' float models (the port's, with the same weights), on
    their device, holding JAX's int8 buffers unchanged."""
    out = {}
    for key in ("coarse", "fine"):
        model = models[key]
        dev = next(model.parameters()).device
        quant = qparams_np[key]["quant"]

        def t(a, dtype):
            return torch.from_numpy(np.array(a, dtype)).to(dev)

        def pair(layer):
            return t(layer["wq"], np.int8), t(layer["scale"], np.float32)
        s_act = {k: t(v, np.float32) for k, v in quant["s_act"].items()}
        layers = {k: ([pair(x) for x in v] if isinstance(v, (list, tuple))
                      else pair(v))
                  for k, v in quant.items() if k != "s_act"}
        cls = (QuantizedFlexibleNeRF if isinstance(model, FlexibleNeRF)
               else QuantizedCodeNeRF)
        out[key] = cls(model, s_act, layers)
    return out
