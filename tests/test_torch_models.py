"""Port parity: codenerf_tpu_torch.models and weights against the JAX
package (f32 atol 1e-5; bf16 relRMS 1e-2)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.models import init_code_tables, init_codenerf
from codenerf_tpu.models import codes as jcodes
from codenerf_tpu.models import ray_structured as jrs
from codenerf_tpu.train.torch_import import (codenerf_state_dict,
                                             codes_state_dict)
from codenerf_tpu_torch.models import (CodeNeRF, CodeTables, lookup_codes,
                                       mean_codes)
from codenerf_tpu_torch.models.ray_structured import (apply_codenerf_rays,
                                                      per_ray_conditioning)
from codenerf_tpu_torch.weights import codenerf_from_jax, codes_from_jax
from tests.torch_port_helpers import (BF16_REL_RMS, F32_ATOL, configs,
                                      jax_and_port_models, rel_rms, t)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)


def _ray_inputs(cfg, R=6, S=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(R, S, cfg.dim_xyz)).astype(np.float32),
            rng.normal(size=(R, cfg.dim_dir)).astype(np.float32),
            rng.normal(size=(R, cfg.shape_code_size)).astype(np.float32),
            rng.normal(size=(R, cfg.texture_code_size)).astype(np.float32))


def test_state_dict_bridge_matches_torch_import():
    """codenerf_from_jax equals the reference-format export and loads
    into the port's module with strict=True."""
    jcfg, tcfg = configs(texture_code_size=8)
    params = jax.tree.map(np.asarray,
                          init_codenerf(jax.random.PRNGKey(3), jcfg))
    ours = codenerf_from_jax(params)
    ref = codenerf_state_dict(params)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    model = CodeNeRF(tcfg, device="cpu")
    model.load_state_dict(ref, strict=True)
    assert model.texture_code_layer1.weight.shape == (8, 8)


def test_codes_bridge_matches_torch_import():
    codes = jax.tree.map(np.asarray, init_code_tables(
        jax.random.PRNGKey(1), 5, 16, 12))
    ours, ref = codes_from_jax(codes), codes_state_dict(codes)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    tables = CodeTables(5, 16, 12, device="cpu")
    tables.load_state_dict(ours, strict=True)
    ids = np.array([4, 0, 2, 2])
    zs, zt = lookup_codes(tables, torch.from_numpy(ids))
    jzs, jzt = jcodes.lookup_codes(codes, jnp.asarray(ids))
    np.testing.assert_array_equal(zs.detach().numpy(), np.asarray(jzs))
    np.testing.assert_array_equal(zt.detach().numpy(), np.asarray(jzt))
    ms, mt = mean_codes(tables)
    jms, jmt = jcodes.mean_codes(codes)
    np.testing.assert_allclose(ms.detach().numpy(), np.asarray(jms),
                               atol=F32_ATOL)
    np.testing.assert_allclose(mt.detach().numpy(), np.asarray(jmt),
                               atol=F32_ATOL)


def test_seeded_init_is_reproducible_and_torch_default_bounded():
    _, tcfg = configs()
    a = CodeNeRF(tcfg, "cpu", torch.Generator().manual_seed(7))
    b = CodeNeRF(tcfg, "cpu", torch.Generator().manual_seed(7))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    bound = 1 / np.sqrt(tcfg.dim_xyz)
    assert float(a.layer_xyz1.weight.detach().abs().max()) <= bound


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodeNeRF(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CodeTables(2, 4, 4)


@pytest.mark.parametrize("include_input", [True, False])
def test_apply_codenerf_rays_f32(include_input):
    jcfg, tcfg = configs(include_input_xyz=include_input)
    params, model = jax_and_port_models(jcfg, tcfg, seed=1)
    xyz, dirs, zs, zt = _ray_inputs(jcfg, seed=1)
    with torch.no_grad():
        got = apply_codenerf_rays(model, t(xyz), t(dirs), t(zs), t(zt))
        assert torch.equal(got, model(t(xyz), t(dirs), t(zs), t(zt)))
    want = jrs.apply_codenerf_rays(params, jcfg, *map(jnp.asarray,
                                                      (xyz, dirs, zs, zt)))
    assert got.dtype == torch.float32 and got.shape == (6, 5, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL,
                               rtol=0)


def test_apply_codenerf_rays_bf16():
    jcfg, tcfg = configs("bfloat16")
    params, model = jax_and_port_models(jcfg, tcfg, seed=2)
    xyz, dirs, zs, zt = _ray_inputs(jcfg, seed=2)
    with torch.no_grad():
        got = apply_codenerf_rays(model, t(xyz), t(dirs), t(zs), t(zt))
    want = jrs.apply_codenerf_rays(params, jcfg, *map(jnp.asarray,
                                                      (xyz, dirs, zs, zt)))
    assert got.dtype == torch.float32
    assert rel_rms(got.numpy(), want) <= BF16_REL_RMS


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_per_ray_conditioning(compute_dtype):
    jcfg, tcfg = configs(compute_dtype)
    params, model = jax_and_port_models(jcfg, tcfg, seed=3)
    _, dirs, zs, zt = _ray_inputs(jcfg, seed=3)
    with torch.no_grad():
        got = per_ray_conditioning(model, t(dirs), t(zs), t(zt))
    want = jrs.per_ray_conditioning(params, jcfg, *map(jnp.asarray,
                                                       (dirs, zs, zt)))
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        if compute_dtype is None:
            np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=0)
        else:
            assert rel_rms(g, w) <= BF16_REL_RMS
