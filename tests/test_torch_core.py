"""Port parity: codenerf_tpu_torch.core and config against the JAX
package, f32 on the CPU (atol 1e-5)."""

import numpy as np
import pytest
import jax.numpy as jnp

from codenerf_tpu.core import encoding as jenc
from codenerf_tpu.core import geometry as jgeo
from codenerf_tpu.core.metrics import mse2psnr as j_mse2psnr
from codenerf_tpu_torch.config import (SRN_CARS_CODE, Config,
                                       config_from_dict)
from codenerf_tpu_torch.core import (encoding_dim, frequency_bands,
                                     mse2psnr, pixel_directions,
                                     pose_spherical, positional_encoding,
                                     ray_bundle)
from tests.torch_port_helpers import F32_ATOL, t


@pytest.mark.parametrize("log_sampling", [True, False])
def test_frequency_bands(log_sampling):
    got = frequency_bands(10, log_sampling).numpy()
    want = np.asarray(jenc.frequency_bands(10, log_sampling))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("include_input", [True, False])
@pytest.mark.parametrize("log_sampling", [True, False])
def test_positional_encoding(include_input, log_sampling):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (5, 7, 3))
    got = positional_encoding(t(x), 4, include_input, log_sampling)
    want = jenc.positional_encoding(jnp.asarray(x, jnp.float32), 4,
                                    include_input, log_sampling)
    assert got.shape[-1] == encoding_dim(3, 4, include_input)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=0)


def test_pixel_directions():
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 10.0
    K[0, 2], K[1, 2] = 4.0, 3.0
    got = pixel_directions(6, 8, t(K)).numpy()
    want = np.asarray(jgeo.pixel_directions(6, 8, jnp.asarray(K)))
    assert got.shape == (6, 8, 3)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_ray_bundle():
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(4, 5, 3)).astype(np.float32)
    poses = np.stack([np.asarray(jgeo.pose_spherical(1.2 + b, 0.3 * b, 1.3))
                      for b in range(2)])
    ro, rd = ray_bundle(t(dirs), t(poses))
    jro, jrd = jgeo.ray_bundle(jnp.asarray(dirs), jnp.asarray(poses))
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=F32_ATOL)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=F32_ATOL)


@pytest.mark.parametrize("theta,phi,rho", [(1.57, 0.0, 1.3),
                                           (0.3, -2.0, 0.9),
                                           (-1.1, 3.0, 2.5)])
def test_pose_spherical(theta, phi, rho):
    got = pose_spherical(theta, phi, rho).numpy()
    want = np.asarray(jgeo.pose_spherical(theta, phi, rho))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_mse2psnr_matches_including_zero_guard():
    mse = np.array([0.0, 1e-3, 0.25, 1.0], np.float32)
    np.testing.assert_allclose(mse2psnr(t(mse)).numpy(),
                               np.asarray(j_mse2psnr(jnp.asarray(mse))),
                               rtol=1e-6)


def test_config_from_dict_reads_nested_fields_and_ignores_the_rest():
    cfg = config_from_dict({"nerf": {"point_sampler": {"num_fine": 7},
                                     "unknown": 1},
                            "experiment": {"id": "x"}})
    assert cfg.nerf.point_sampler.num_fine == 7
    assert cfg.nerf.point_sampler.num_coarse == Config().nerf.point_sampler.num_coarse
    flag = config_from_dict(SRN_CARS_CODE)
    assert flag.models.nerf_fine.hidden_size == 256
    assert flag.nerf.validation.chunksize == 4096
    assert flag.runtime.compute_dtype == "bfloat16"
