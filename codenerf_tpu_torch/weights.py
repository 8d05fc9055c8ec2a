"""Bridge from the JAX package's parameter pytrees to the port's state
dicts.

The inputs are numpy views of the JAX pytrees (``{layer: {"w", "b"}}``
with ``w`` as ``[in, out]``, and ``{"shape", "texture"}`` code tables);
nothing here imports JAX.  The outputs use the reference state-dict
names, as ``codenerf_tpu/train/torch_import.py`` writes them.  TTO
variables ({"z_s", "z_t", "theta", "phi", "rho"} or {"z_s", "z_t",
"xi"}) carry over as leaf tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from codenerf_tpu_torch.device import resolve_device
from codenerf_tpu_torch.models.mlp import LAYER_NAMES


def codenerf_from_jax(params_np: dict) -> dict:
    """CodeNeRF pytree -> ``CodeNeRF`` state dict ([in, out] -> [out, in])."""
    out = {}
    for name in LAYER_NAMES:
        w = np.asarray(params_np[name]["w"], np.float32)
        b = np.asarray(params_np[name]["b"], np.float32)
        out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
        out[f"{name}.bias"] = torch.from_numpy(b.copy())
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
    """Load the JAX package's ``{"coarse", "fine", "codes"}`` parameters
    (numpy views) into a ``TrainState``'s models and code tables, in
    place, so that both packages start from the same weights."""
    for key in ("coarse", "fine"):
        model = state.models[key]
        sd = codenerf_from_jax(params_np[key])
        model.load_state_dict({k: v.to(model.layer_xyz1.weight.device)
                               for k, v in sd.items()}, strict=True)
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
