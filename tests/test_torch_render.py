"""Port parity for the whole slice: codenerf_tpu_torch's pipeline and
image renderer on the CPU against the JAX package's (XLA path), at 8
coarse + 8 fine samples and an 8x8 image (f32 atol 1e-5; bf16 relRMS
1e-2).  The port serves through the fused trunk, K1's plain version here,
named by its runtime flag ``use_pallas``; the YAML's own flags serve
through the ray-structured path (``tests/test_torch_xla_path.py``)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.config.schema import (Config, EmbeddingSpec,
                                        EmbedderConfig, ModelsConfig,
                                        ModelSpec, NerfConfig,
                                        PointSamplerConfig, RuntimeConfig)
from codenerf_tpu.core.geometry import pixel_directions as j_pixel_dirs
from codenerf_tpu.core.geometry import pose_spherical as j_pose
from codenerf_tpu.eval.render import make_image_renderer as j_renderer
from codenerf_tpu.models import init_codenerf
from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
from codenerf_tpu.pipeline import render_rays as j_render_rays
from codenerf_tpu_torch.config import config_from_dict
from codenerf_tpu_torch.core import pixel_directions, pose_spherical
from codenerf_tpu_torch.eval import make_image_renderer
from codenerf_tpu_torch.models import CodeNeRF
from codenerf_tpu_torch.ops.fused import trunk_forward
from codenerf_tpu_torch.pipeline import RenderSettings, render_rays
from codenerf_tpu_torch.weights import codenerf_from_jax
from tests.torch_port_helpers import BF16_REL_RMS, F32_ATOL, rel_rms, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

H = W = 8


def _configs(compute_dtype):
    """The same small configuration for both packages."""
    jax_cfg = Config(
        models=ModelsConfig(
            nerf_coarse=ModelSpec(hidden_size=32),
            nerf_fine=ModelSpec(hidden_size=32),
            embedding=EmbeddingSpec(shape_code_size=16, texture_code_size=16)),
        nerf=NerfConfig(
            point_sampler=PointSamplerConfig(num_coarse=8, num_fine=8),
            embedder=EmbedderConfig(num_encoding_fn_xyz=4)),
        runtime=RuntimeConfig(compute_dtype=compute_dtype, use_pallas=True))
    port_cfg = config_from_dict({
        "models": {"nerf_coarse": {"hidden_size": 32},
                   "nerf_fine": {"hidden_size": 32},
                   "embedding": {"shape_code_size": 16,
                                 "texture_code_size": 16}},
        "nerf": {"point_sampler": {"num_coarse": 8, "num_fine": 8},
                 "embedder": {"num_encoding_fn_xyz": 4}},
        "runtime": {"compute_dtype": compute_dtype, "use_pallas": True}})
    return (JRenderSettings.from_config(jax_cfg),
            RenderSettings.from_config(port_cfg))


def _setup(compute_dtype, seed=0):
    js, ps = _configs(compute_dtype)
    kc, kf = jax.random.split(jax.random.PRNGKey(seed))
    params = {"coarse": init_codenerf(kc, js.coarse_cfg),
              "fine": init_codenerf(kf, js.fine_cfg)}
    models = {}
    for name, cfg in (("coarse", ps.coarse_cfg), ("fine", ps.fine_cfg)):
        models[name] = CodeNeRF(cfg, device="cpu")
        models[name].load_state_dict(codenerf_from_jax(
            jax.tree.map(np.asarray, params[name])), strict=True)
    rng = np.random.default_rng(seed)
    z_s = rng.normal(size=(1, 16)).astype(np.float32)
    z_t = rng.normal(size=(1, 16)).astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 10.0
    K[0, 2] = K[1, 2] = 4.0
    return js, ps, params, models, z_s, z_t, K


def test_settings_match_jax():
    js, ps = _configs("bfloat16")
    for f in dataclasses.fields(ps):
        if f.name in ("coarse_cfg", "fine_cfg"):
            for g in dataclasses.fields(getattr(ps, f.name)):
                assert (getattr(getattr(ps, f.name), g.name)
                        == getattr(getattr(js, f.name), g.name)), g.name
        else:
            assert getattr(ps, f.name) == getattr(js, f.name), f.name


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_render_rays_matches_jax(compute_dtype):
    js, ps, params, models, z_s, z_t, K = _setup(compute_dtype, seed=1)
    rng = np.random.default_rng(1)
    R = 16
    ro = (rng.normal(size=(R, 3)) * 0.1 + [0, 0, 1.3]).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32) * 0.2
    rd[:, 2] = -1.0
    zs = np.repeat(z_s, R, 0)
    zt = np.repeat(z_t, R, 0)
    jc, jf = j_render_rays(params, js, jnp.asarray(ro), jnp.asarray(rd),
                           jnp.asarray(zs), jnp.asarray(zt), None, False)
    pc, pf = render_rays(models, ps, t(ro), t(rd), t(zs), t(zt))
    for got, want in ((pc, jc), (pf, jf)):
        for name in ("rgb", "acc", "depth", "weights"):
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            if compute_dtype == "float32":
                np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=0,
                                           err_msg=name)
            else:
                assert rel_rms(g, w) <= BF16_REL_RMS, name


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_image_renderer_matches_jax(compute_dtype):
    js, ps, params, models, z_s, z_t, K = _setup(compute_dtype)
    pose = np.asarray(j_pose(1.2, 0.4, 1.3))
    want = j_renderer(js, H, W, chunksize=16)(
        params, j_pixel_dirs(H, W, jnp.asarray(K)), jnp.asarray(pose),
        jnp.asarray(z_s), jnp.asarray(z_t))
    before = trunk_forward.launches
    got = make_image_renderer(ps, H, W, chunksize=16, device="cpu")(
        models, pixel_directions(H, W, t(K)), t(pose), t(z_s), t(z_t))
    assert trunk_forward.launches == before     # the CPU runs no kernel
    assert got.shape == (H * W, 3)
    if compute_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL, rtol=0)
    else:
        assert rel_rms(got.numpy(), want) <= BF16_REL_RMS


def test_image_renderer_padding_keeps_the_image():
    """A chunk size that does not divide H*W pads the last chunk (rd with
    1.0) without changing any pixel."""
    _, ps, _, models, z_s, z_t, K = _setup("float32", seed=2)
    dirs, pose = pixel_directions(H, W, t(K)), pose_spherical(1.0, 0.2, 1.3)
    a = make_image_renderer(ps, H, W, chunksize=64, device="cpu")(
        models, dirs, pose, t(z_s), t(z_t))
    b = make_image_renderer(ps, H, W, chunksize=24, device="cpu")(
        models, dirs, pose, t(z_s), t(z_t))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_training_options_are_refused():
    _, ps, _, models, z_s, z_t, _ = _setup("float32")
    ro = torch.zeros(4, 3)
    rd = torch.ones(4, 3)
    zs, zt = t(z_s).expand(4, -1), t(z_t).expand(4, -1)
    with pytest.raises(NotImplementedError, match="perturb"):
        render_rays(models, ps, ro, rd, zs, zt, perturb=True)
    with pytest.raises(NotImplementedError):
        render_rays(models, ps, ro, rd, zs, zt, noise_std=0.1)
    # NDC rays are ported (held against JAX in test_torch_ndc.py): the
    # serving render takes them
    out_c, out_f = render_rays(
        models, dataclasses.replace(ps, ndc=(8.0, 8.0, 10.0), near=0.0,
                                    far=1.0, spacing_mode="lindisp"),
        ro, rd, zs, zt)
    assert out_f.rgb.shape == (4, 3)
    assert bool(torch.isfinite(out_c.rgb).all() & torch.isfinite(
        out_f.rgb).all())


def test_renderer_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ps = _configs("bfloat16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_image_renderer(ps, H, W)
