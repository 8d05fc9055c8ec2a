"""Port parity: K1's plain version (codenerf_tpu_torch.ops.fused) against
the JAX package's Pallas trunk, run in interpret mode on the CPU as
tests/test_fused.py runs it (f32 atol 1e-5; bf16 relRMS 1e-2)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from codenerf_tpu.ops import fused as jfused
from codenerf_tpu_torch.ops import _build
from codenerf_tpu_torch.ops.fused import (fused_codenerf, kernel_weights,
                                          per_ray_parts, trunk_forward,
                                          trunk_forward_plain)
from tests.torch_port_helpers import (BF16_REL_RMS, F32_ATOL, configs,
                                      jax_and_port_models, rel_rms, t)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU."""
    orig = jfused.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfused.pl, "pallas_call", interp)


def _inputs(cfg, R=8, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32),
            rng.normal(size=(R, cfg.dim_dir)).astype(np.float32),
            rng.normal(size=(R, cfg.shape_code_size)).astype(np.float32),
            rng.normal(size=(R, cfg.texture_code_size)).astype(np.float32))


def _both(compute_dtype, include_input=True, log_sampling=True, seed=0):
    jcfg, tcfg = configs(compute_dtype, include_input_xyz=include_input)
    params, model = jax_and_port_models(jcfg, tcfg, seed=seed)
    pts, dirs, zs, zt = _inputs(jcfg, seed=seed)
    jax_fn = jfused.make_fused_codenerf(jcfg, jcfg.num_encoding_fn_xyz,
                                        include_input, log_sampling,
                                        tile_rows=64)
    want = jax_fn(params, *map(jnp.asarray, (pts, dirs, zs, zt)))
    with torch.no_grad():
        got = fused_codenerf(model, t(pts), t(dirs), t(zs), t(zt),
                             num_freq_xyz=tcfg.num_encoding_fn_xyz,
                             log_sampling_xyz=log_sampling)
    return got, np.asarray(want)


@pytest.mark.parametrize("include_input", [True, False])
@pytest.mark.parametrize("log_sampling", [True, False])
def test_plain_trunk_matches_pallas_f32(include_input, log_sampling):
    got, want = _both(None, include_input, log_sampling)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("include_input", [True, False])
@pytest.mark.parametrize("log_sampling", [True, False])
def test_plain_trunk_matches_pallas_bf16(include_input, log_sampling):
    got, want = _both("bfloat16", include_input, log_sampling, seed=1)
    assert got.dtype == torch.float32
    assert rel_rms(got.numpy(), want) <= BF16_REL_RMS


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_per_ray_parts_and_kernel_weights(compute_dtype):
    jcfg, tcfg = configs(compute_dtype)
    params, model = jax_and_port_models(jcfg, tcfg, seed=2)
    _, dirs, zs, zt = _inputs(jcfg, seed=2)
    with torch.no_grad():
        got = per_ray_parts(model, t(dirs), t(zs), t(zt))
        wts = kernel_weights(model, jcfg.num_encoding_fn_xyz, True)
    want = jfused._per_ray_parts(params, jcfg, *map(jnp.asarray,
                                                    (dirs, zs, zt)))
    for k, w in want.items():
        if compute_dtype is None:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                       atol=F32_ATOL, err_msg=k)
        else:
            assert rel_rms(got[k].float().numpy(), w) <= BF16_REL_RMS, k
    jw = jfused._kernel_weights(params, jcfg, jcfg.num_encoding_fn_xyz, True)
    for k, w in jw.items():
        # the weight layout carries over exactly: same values, same dtype
        np.testing.assert_array_equal(
            wts[k].float().numpy(), np.asarray(w, np.float32), err_msg=k)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    jcfg, tcfg = configs("bfloat16")
    _, model = jax_and_port_models(jcfg, tcfg, seed=3)
    pts, dirs, zs, zt = _inputs(jcfg, seed=3)
    with torch.no_grad():
        per_ray = per_ray_parts(model, t(dirs), t(zs), t(zt))
        wts = kernel_weights(model, jcfg.num_encoding_fn_xyz, True)
        before = trunk_forward.launches
        got = trunk_forward(t(pts), per_ray, wts, compute_dtype=torch.bfloat16)
        want = trunk_forward_plain(t(pts), per_ray, wts,
                                   compute_dtype=torch.bfloat16)
    assert trunk_forward.launches == before
    assert torch.equal(got, want)


def test_build_finds_no_nvcc_and_raises(monkeypatch):
    """The kernel build needs nvcc; without one it raises instead of
    falling back."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


def test_library_is_named_by_source_and_flags():
    path = _build.library_path("trunk_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_kernels")
    assert path.name.startswith("libtrunk_fwd-") and path.suffix == ".so"
    assert path == _build.library_path("trunk_fwd")
    src = (_build.CSRC / "trunk_fwd.cu").read_text()
    assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    assert "__sinf" not in src.replace("__sinf /", "")


def test_header_edit_changes_the_library_name(tmp_path, monkeypatch):
    """K1 and K2 / K3 share trunk_common.cuh: an edited header must name
    (and so build) a new library for both, never load a stale one."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in ("trunk_fwd", "trunk_bwd")}
    header = csrc / "trunk_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        after = _build.library_path(name)
        assert after != path and after.name.startswith(f"lib{name}-")
