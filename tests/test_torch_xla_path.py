"""Port parity for the flagship YAML's own train path: the ray-structured
path that ``runtime.use_pallas: false`` selects
(configs/srn-cars-code.yml:76-83), with ``remat``, K4's plain version
under ``pallas_layer_bwd``, the K1-forward/recompute path
(``use_pallas`` without ``pallas_backward``) and the serving image, on
the CPU against the JAX package at the small size of
``tests/test_torch_train.py`` (hidden 32, codes 16, 16 coarse + 8 fine
samples, 2 images of 8x8, 16 rays each).

Tolerances as there: f32 atol 1e-5 per gradient leaf and loss rtol 1e-5;
bf16 relRMS <= 1e-2 per leaf and loss rtol 1e-3.  Here the port's bf16
step is held against JAX's XLA path itself: both round at the same
points.  The ``pallas_layer_bwd`` and K1 steps are held against JAX with
``jax.default_backend`` patched to "tpu" and Pallas in interpret mode, so
that JAX takes the same path.
"""

from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.core.geometry import pixel_directions as j_pixel_dirs
from codenerf_tpu.core.geometry import pose_spherical as j_pose
from codenerf_tpu.core.geometry import select_ray_indices as j_select
from codenerf_tpu.eval.render import make_image_renderer as j_renderer
from codenerf_tpu.ops import fused as jfused
from codenerf_tpu.ops import layer_bwd as jlb
from codenerf_tpu_torch import pipeline
from codenerf_tpu_torch.config import SRN_CARS_CODE, config_from_dict
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.core import pixel_directions
from codenerf_tpu_torch.eval import make_image_renderer
from codenerf_tpu_torch.eval.render import serving_settings
from codenerf_tpu_torch.models import CodeNeRF
from codenerf_tpu_torch.ops import layer_bwd
from codenerf_tpu_torch.ops.fused import trunk_forward
from codenerf_tpu_torch.pipeline import (RenderSettings, remat_active,
                                         render_rays_train, trunk_path)
from tests.test_torch_train import (H, W, N_RAYS, _both, _cfg_dict, _data,
                                    _port_grads, _port_step,
                                    step_against_jax)
from tests.torch_port_helpers import BF16_REL_RMS, F32_ATOL, rel_rms, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def jax_on_tpu(monkeypatch):
    """Let JAX take its TPU paths on the CPU: its gates ask for a TPU
    backend, and pallas_call runs in interpret mode."""
    for mod in (jfused, jlb):
        orig = mod.pl.pallas_call

        def interp(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", interp)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


@pytest.fixture
def k4_calls(monkeypatch):
    """Count the calls of ``layer_bwd.linear_relu_bwd``, the wrapper that
    launches K4 on CUDA tensors."""
    calls = []
    orig = layer_bwd.linear_relu_bwd

    def counted(*args):
        calls.append(args[0].shape)
        return orig(*args)

    monkeypatch.setattr(layer_bwd, "linear_relu_bwd", counted)
    return calls


# ---- which path the config selects ----

def test_flagship_values_select_the_ray_structured_path_with_remat():
    s = RenderSettings.from_config(config_from_dict(SRN_CARS_CODE))
    assert trunk_path(s) == "rays" and remat_active(s)
    assert not (s.use_pallas or s.pallas_backward or s.pallas_hybrid)
    for cfg in (s.coarse_cfg, s.fine_cfg):
        assert cfg.fc_out_tail_sigma and not cfg.pallas_layer_bwd
        assert not cfg.split_fc_out and cfg.compute_dtype == "bfloat16"
    serve = serving_settings(s)
    assert serve.fine_cfg.split_fc_out and trunk_path(serve) == "rays"


def test_f32_config_selects_the_ray_structured_path():
    """configs/synth-smoke.yml (f32, no Pallas flag) takes the
    ray-structured path, as in JAX."""
    s = RenderSettings.from_config(load_config(ROOT / "configs"
                                               / "synth-smoke.yml"))
    assert trunk_path(s) == "rays" and not remat_active(s)
    assert s.fine_cfg.compute_dtype is None and s.fine_cfg.cdtype is None


@pytest.mark.parametrize("flags,path,function", [
    ({"use_pallas": True, "pallas_backward": True}, "fused",
     "TrunkFunctionBackward"),
    ({"use_pallas": True}, "fused_recompute",
     "RecomputeTrunkFunctionBackward"),
    ({"pallas_hybrid": True}, "hybrid", "HybridTrunkFunctionBackward"),
    ({"use_pallas": True, "pallas_backward": True, "pallas_hybrid": True},
     "fused", "TrunkFunctionBackward"),
    ({}, "rays", None),
    ({"pallas_layer_bwd": True}, "rays", None),
    ({"pallas_layer_bwd": True, "remat": False}, "rays", None),
])
def test_each_flag_combination_selects_its_function(flags, path, function,
                                                      k4_calls, monkeypatch):
    ps = RenderSettings.from_config(config_from_dict(
        _cfg_dict("bfloat16", mode="yaml", **flags)))
    assert trunk_path(ps) == path
    remat = path == "rays" and flags.get("remat", True)
    assert remat_active(ps) == remat
    checkpoints, grad_fns = [], []
    orig_ckpt, orig_fwd = pipeline.checkpoint, pipeline._forward

    def ckpt(fn, *args, **kwargs):
        checkpoints.append(fn)
        return orig_ckpt(fn, *args, **kwargs)

    def fwd(*args):
        raw = orig_fwd(*args)
        grad_fns.append(type(raw.grad_fn).__name__)
        return raw

    monkeypatch.setattr(pipeline, "checkpoint", ckpt)
    monkeypatch.setattr(pipeline, "_forward", fwd)
    gen = torch.Generator().manual_seed(0)
    models = {k: CodeNeRF(getattr(ps, f"{k}_cfg"), "cpu", gen)
              for k in ("coarse", "fine")}
    rng = np.random.default_rng(0)
    ro = t(rng.normal(size=(4, 3)) * 0.1 + [0.0, 0.0, 1.3])
    rd = t(rng.normal(size=(4, 3)) * 0.2 - [0.0, 0.0, 1.0])
    zs = t(rng.normal(size=(4, 16))).requires_grad_()
    zt = t(rng.normal(size=(4, 16))).requires_grad_()
    out_c, out_f = render_rays_train(models, ps, ro, rd, zs, zt, gen)
    (out_c.rgb.sum() + out_f.rgb.sum()).backward()
    assert len(checkpoints) == (2 if remat else 0)
    if function is not None:
        assert grad_fns == [function, function]
    # layer_xyz2, layer_dir1 and layer_dir2 of both passes
    assert len(k4_calls) == (6 if flags.get("pallas_layer_bwd") else 0)
    assert zs.grad is not None and zt.grad is not None


# ---- one train step against JAX ----

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_xla_path_step_matches_jax(compute_dtype):
    """The flagship runtime (use_pallas false, remat, fc_out_tail_sigma)
    against JAX's XLA path on the CPU, no backend patch."""
    _, js, ps, jstate, _, state = _both(compute_dtype, seed=3, mode="yaml")
    assert trunk_path(ps) == "rays" and remat_active(ps)
    step_against_jax(js, ps, jstate, state, compute_dtype)


def test_remat_gives_the_same_grads():
    data = _data(7)
    inds = np.array(j_select(jax.random.PRNGKey(2), H * W, N_RAYS, 2))
    results = []
    for remat in (False, True):
        *_, ps, _, _, state = _both("bfloat16", seed=6, mode="yaml",
                                    remat=remat)
        assert remat_active(ps) == remat
        m = _port_step(ps, state, data, inds)
        results.append((float(m.loss), _port_grads(state)))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        np.testing.assert_array_equal(results[1][1][k], v, err_msg=k)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_layer_bwd_step_matches_jax(compute_dtype, jax_on_tpu, k4_calls):
    """pallas_layer_bwd: every dar layer's backward through K4's wrapper
    (its plain version here) against JAX's Pallas layer backward."""
    _, js, ps, jstate, _, state = _both(compute_dtype, seed=4, mode="yaml",
                                        pallas_layer_bwd=True)
    assert ps.fine_cfg.pallas_layer_bwd and trunk_path(ps) == "rays"
    step_against_jax(js, ps, jstate, state, compute_dtype)
    assert len(k4_calls) == 6


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_k1_forward_recompute_step_matches_jax(compute_dtype, jax_on_tpu):
    """use_pallas without pallas_backward: K1's forward and autograd
    through the recomputed ray-structured forward, against JAX's
    ``make_fused_codenerf`` without ``pallas_backward``."""
    _, js, ps, jstate, _, state = _both(compute_dtype, seed=5, mode="yaml",
                                        use_pallas=True)
    assert trunk_path(ps) == "fused_recompute" and not remat_active(ps)
    step_against_jax(js, ps, jstate, state, compute_dtype)


# ---- serving under the YAML's flags ----

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_serving_image_matches_jax_under_the_yaml_flags(compute_dtype):
    _, js, ps, jstate, _, state = _both(compute_dtype, seed=8, mode="yaml")
    assert trunk_path(ps) == "rays"
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 10.0
    K[0, 2] = K[1, 2] = 4.0
    pose = np.asarray(j_pose(1.2, 0.4, 1.3))
    codes = jstate.params["codes"]
    z_s, z_t = (np.asarray(codes[k][1:2]) for k in ("shape", "texture"))
    params = {k: jstate.params[k] for k in ("coarse", "fine")}
    want = j_renderer(js, H, W, chunksize=16)(
        params, j_pixel_dirs(H, W, jnp.asarray(K)), jnp.asarray(pose),
        jnp.asarray(z_s), jnp.asarray(z_t))
    before = trunk_forward.launches
    got = make_image_renderer(ps, H, W, chunksize=16, device="cpu")(
        state.models, pixel_directions(H, W, t(K)), t(pose), t(z_s), t(z_t))
    assert trunk_forward.launches == before
    if compute_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_ATOL, rtol=0)
    else:
        assert rel_rms(got.numpy(), want) <= BF16_REL_RMS
