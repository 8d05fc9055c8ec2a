"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Builds the JAX package's CodeNeRF parameters and the port's module from
one seed: the JAX init draws the weights, ``weights.codenerf_from_jax``
carries them over.  Inputs are made with numpy and handed to both sides.
"""

import numpy as np
import jax
import torch

from codenerf_tpu.models import CodeNeRFConfig as JaxCodeNeRFConfig
from codenerf_tpu.models import init_codenerf
from codenerf_tpu_torch.models import CodeNeRF, CodeNeRFConfig
from codenerf_tpu_torch.weights import codenerf_from_jax

# small widths: hidden 32, codes 16, 4 xyz bands
SMALL = dict(hidden_size=32, shape_code_size=16, texture_code_size=16,
             num_encoding_fn_xyz=4, num_encoding_fn_dir=4)
# bf16 rounds at different points in the two frameworks' orders of
# summation; one bf16 ulp is 2^-8 relative, so compare by relRMS
BF16_REL_RMS = 1e-2
F32_ATOL = 1e-5


def configs(compute_dtype=None, **overrides):
    kw = dict(SMALL, compute_dtype=compute_dtype, **overrides)
    return JaxCodeNeRFConfig(**kw), CodeNeRFConfig(**kw)


def jax_and_port_models(jcfg, tcfg, seed=0):
    params = init_codenerf(jax.random.PRNGKey(seed), jcfg)
    model = CodeNeRF(tcfg, device="cpu")
    model.load_state_dict(
        codenerf_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return params, model


def rel_rms(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def t(a):
    """numpy/JAX array -> f32 CPU tensor."""
    return torch.from_numpy(np.array(a, np.float32))
