"""Port parity: codenerf_tpu_torch.ops.sampling and volume_render against
the JAX package, f32 on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from codenerf_tpu.ops import sampling as jsamp
from codenerf_tpu.ops.volume_render import volume_render as j_volume_render
from codenerf_tpu_torch.ops.sampling import (base_z_vals, sample_pdf,
                                             sample_stratified)
from codenerf_tpu_torch.ops.volume_render import volume_render
from tests.torch_port_helpers import F32_ATOL, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)


def _rays(R, seed):
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(R, 3)).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    return ro, rd


@pytest.mark.parametrize("mode", ["lindepth", "lindisp"])
def test_base_z_vals(mode):
    got = base_z_vals(32, 0.8, 1.8, mode).numpy()
    want = np.asarray(jsamp.base_z_vals(32, 0.8, 1.8, mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sample_stratified_deterministic():
    ro, rd = _rays(6, 0)
    z = base_z_vals(8, 0.8, 1.8, "lindepth")
    pts, zz = sample_stratified(t(ro), t(rd), z)
    jpts, jz = jsamp.sample_stratified(None, jnp.asarray(ro), jnp.asarray(rd),
                                       jnp.asarray(z.numpy()), False)
    np.testing.assert_allclose(zz.numpy(), np.asarray(jz), atol=F32_ATOL)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=F32_ATOL)


@pytest.mark.parametrize("S,NF", [(8, 8), (32, 128)])
@pytest.mark.parametrize("kind", ["random", "peaked", "zero"])
def test_sample_pdf_selects_the_jax_depths(kind, S, NF):
    """Deterministic inverse-CDF depths equal JAX's within 1e-6, at the
    small size and at the flagship's 32 coarse + 128 fine samples."""
    R = 16
    rng = np.random.default_rng(2)
    ro, rd = _rays(R, 3)
    z = np.sort(rng.uniform(0.8, 1.8, (R, S)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (R, S - 2)).astype(np.float32)
    if kind == "peaked":
        w = np.where(w > 0.8, w * 50, 0).astype(np.float32)
    elif kind == "zero":
        w[:] = 0
    pts, zu = sample_pdf(t(ro), t(rd), t(w), t(z), NF)
    jpts, jzu = jsamp.sample_pdf(None, jnp.asarray(ro), jnp.asarray(rd),
                                 jnp.asarray(w), jnp.asarray(z), NF, False)
    assert zu.shape == (R, S + NF)
    np.testing.assert_allclose(zu.numpy(), np.asarray(jzu), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=F32_ATOL)


def test_sample_pdf_rejects_uninterior_weights():
    ro, rd = _rays(2, 4)
    z = torch.sort(torch.rand(2, 8), dim=-1).values
    with pytest.raises(ValueError, match="interior"):
        sample_pdf(t(ro), t(rd), torch.ones(2, 8), z, 4)


@pytest.mark.parametrize("white_background", [False, True])
def test_volume_render(white_background):
    R, S = 8, 12
    rng = np.random.default_rng(5)
    raw = rng.normal(0, 3, (R, S, 4)).astype(np.float32)
    raw[0, :, 3] = 40.0                  # opaque ray: softplus far from 0
    z = np.sort(rng.uniform(0.8, 1.8, (R, S)), axis=-1).astype(np.float32)
    _, rd = _rays(R, 6)
    got = volume_render(t(raw), t(z), t(rd), white_background)
    want = j_volume_render(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                           white_background)
    for name in ("rgb", "disp", "acc", "weights", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=F32_ATOL, rtol=1e-5, err_msg=name)
