"""Port parity for vanilla NeRF (FlexibleNeRF) on the CPU against the JAX
package: the module and ``apply_flexible_rays`` against JAX's
``apply_flexible_rays`` and ``apply_flexible_nerf`` (view directions on
and off, a skip id inside and outside the trunk), ``_DotAddReluPL`` at
layer_dir1's per-ray shape (N = h/2) against JAX's
``linear_relu_bwd_pallas`` in interpret mode, and one train step of
``configs/lego.yml`` cut to hidden 32 on the ray-structured path (f32 and
bf16) and under ``pallas_layer_bwd``, with ``jax.default_backend``
patched to "tpu" so that JAX takes its K4 path too.

Tolerances as in ``tests/test_torch_train.py``: f32 atol 1e-5 (loss rtol
1e-5); bf16 relRMS <= 1e-2 per output and per gradient leaf (loss rtol
1e-3), but for two bias leaves of each pass, fc_alpha's and the skip
layer's, held at 5e-2: each is a sum of R S bf16 cotangents, rounded to
bf16, that nearly cancels at this seed's init, so one flipped rounding of
a cotangent moves it by a few bf16 ulps.  Measured: JAX's own bf16
gradient of fine.fc_alpha.bias is 7.5e-2 (relRMS) from its f32 gradient,
and the port's bf16 ones are at most 2.7e-2 from JAX's.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.config.schema import config_from_dict as j_config_from_dict
from codenerf_tpu.core.geometry import select_ray_indices as j_select
from codenerf_tpu.models.mlp import FlexibleNeRFConfig as JFlexCfg
from codenerf_tpu.models.mlp import apply_flexible_nerf, init_flexible_nerf
from codenerf_tpu.models.ray_structured import (_dot_add_relu,
                                                apply_flexible_rays as
                                                j_apply_flexible_rays)
from codenerf_tpu.ops import layer_bwd as jlb
from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
from codenerf_tpu.pipeline import render_rays as j_render_rays
from codenerf_tpu.train.state import init_train_state as j_init_state
from codenerf_tpu.train.step import gather_ray_batch as j_gather
from codenerf_tpu_torch.config import config_from_dict, yaml_lite
from codenerf_tpu_torch.models import FlexibleNeRF, FlexibleNeRFConfig
from codenerf_tpu_torch.models.ray_structured import _DotAddReluPL
from codenerf_tpu_torch.pipeline import RenderSettings, trunk_path
from codenerf_tpu_torch.train import init_train_state, make_train_step
from codenerf_tpu_torch.weights import flexible_from_jax, params_from_jax
from tests.test_torch_train import H, W, N_RAYS, _data
from tests.test_torch_xla_path import jax_on_tpu  # noqa: F401 (fixture)
from tests.torch_port_helpers import BF16_REL_RMS, F32_ATOL, rel_rms, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CDS = {"f32": None, "bf16": "bfloat16"}
CANCELLING_REL_RMS = 5e-2      # two near-cancelling bias sums (docstring)


def vanilla_dict(yml="lego.yml", compute_dtype="float32", hidden=32,
                 **runtime):
    """``configs/<yml>`` at a small size: hidden 32, 8 + 8 samples, 4 / 2
    bands, lr 1e-2; ``runtime`` overrides single runtime flags."""
    d = yaml_lite.safe_load((ROOT / "configs" / yml).read_text())
    d = copy.deepcopy(d)
    for k in ("nerf_coarse", "nerf_fine"):
        d["models"][k]["hidden_size"] = hidden
    d["nerf"]["point_sampler"].update(num_coarse=8, num_fine=8)
    d["nerf"]["embedder"].update(num_encoding_fn_xyz=4,
                                 num_encoding_fn_dir=2)
    d["nerf"]["ray_sampler"]["num_random_rays"] = N_RAYS
    d["optimizer"].update(lr=1e-2, scheduler_step_size=2)
    d["runtime"].update(compute_dtype=compute_dtype, **runtime)
    return d


def vanilla_both(d, seed=0):
    """JAX and port configs, settings and states from one dict, the port
    loaded with the JAX parameters."""
    jcfg, pcfg = j_config_from_dict(d), config_from_dict(d)
    js, ps = JRenderSettings.from_config(jcfg), RenderSettings.from_config(
        pcfg)
    jstate, jopt = j_init_state(jax.random.PRNGKey(seed), jcfg, js, 1)
    state = init_train_state(pcfg, ps, 1, seed=seed, device="cpu")
    params_from_jax(state, jax.tree.map(np.asarray, jstate.params))
    return js, ps, jstate, jopt, state


def port_grads(state) -> dict:
    """Every gradient of the port's state under its state-dict name."""
    return {f"{k}.{n}": p.grad.numpy() for k, m in state.models.items()
            for n, p in m.named_parameters()}


def jax_grads(grads) -> dict:
    """JAX's gradient pytree under the port's state-dict names."""
    return {f"{k}.{n}": v.numpy() for k in ("coarse", "fine")
            for n, v in flexible_from_jax(
                jax.tree.map(np.asarray, grads[k])).items()}


def close(got, want, compute_dtype, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    if compute_dtype is None:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0,
                                   err_msg=name)
    else:
        assert rel_rms(got, want) <= BF16_REL_RMS, name


# ---- the module ----

@pytest.mark.parametrize("viewdirs", [True, False], ids=["dirs", "nodirs"])
@pytest.mark.parametrize("layers,skip", [(6, (2,)), (4, (4,))],
                         ids=["skip-inside", "skip-outside"])
@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_flexible_forward_matches_jax(viewdirs, layers, skip, compute_dtype):
    kw = dict(num_layers=layers, hidden_size=32, skip_connect_ids=skip,
              num_encoding_fn_xyz=4, num_encoding_fn_dir=2,
              use_viewdirs=viewdirs, compute_dtype=compute_dtype)
    jcfg, cfg = JFlexCfg(**kw), FlexibleNeRFConfig(**kw)
    params = init_flexible_nerf(jax.random.PRNGKey(layers), jcfg)
    model = FlexibleNeRF(cfg, "cpu")
    model.load_state_dict(flexible_from_jax(jax.tree.map(np.asarray,
                                                         params)))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    rng = np.random.default_rng(layers)
    R, S = 6, 5
    xyz = rng.normal(size=(R, S, cfg.dim_xyz)).astype(np.float32)
    dirs = (rng.normal(size=(R, cfg.dim_dir)).astype(np.float32)
            if viewdirs else None)
    want = j_apply_flexible_rays(params, jcfg, jnp.asarray(xyz),
                                 None if dirs is None else jnp.asarray(dirs))
    x = xyz if dirs is None else np.concatenate(
        [xyz, np.broadcast_to(dirs[:, None], (R, S, cfg.dim_dir))], -1)
    want_plain = apply_flexible_nerf(params, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = model(t(xyz), None if dirs is None else t(dirs))
    assert got.dtype == torch.float32 and got.shape == (R, S, 4)
    close(got, want, compute_dtype, "rays")
    close(got, np.asarray(want_plain, np.float32), compute_dtype, "plain")


def test_flexible_init_draws_reference_shapes_from_the_generator():
    cfg = FlexibleNeRFConfig(num_layers=8, hidden_size=16,
                             skip_connect_ids=(4,))
    a = FlexibleNeRF(cfg, "cpu", torch.Generator().manual_seed(1))
    b = FlexibleNeRF(cfg, "cpu", torch.Generator().manual_seed(1))
    sa = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sa.items())
    assert list(sa) == [
        "layer1.weight", "layer1.bias",
        *[f"layers_xyz.{i}.{p}" for i in range(7) for p in ("weight",
                                                            "bias")],
        "fc_feat.weight", "fc_feat.bias", "layers_dir.0.weight",
        "layers_dir.0.bias", "fc_alpha.weight", "fc_alpha.bias",
        "fc_rgb.weight", "fc_rgb.bias"]
    assert sa["layers_xyz.4.weight"].shape == (16, 16 + cfg.dim_xyz)
    assert sa["layers_dir.0.weight"].shape == (8, 16 + cfg.dim_dir)


# ---- K4 at layer_dir1's per-ray shape ----

@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_dot_add_relu_pl_per_ray_half_width_matches_jax(compute_dtype,
                                                        jax_on_tpu):  # noqa: F811
    """layer_dir1's backward: x [R, S, h], w [h, h/2], per-ray rows
    [R, 1, h/2], through the port's ``_DotAddReluPL`` (K4's plain version
    on the CPU) and JAX's ``linear_relu_bwd_pallas`` in interpret mode."""
    h, R, S = 32, 4, 8
    cd = getattr(torch, compute_dtype) if compute_dtype else None
    jcd = jnp.dtype(compute_dtype) if compute_dtype else None
    rng = np.random.default_rng(7)
    x = rng.normal(size=(R, S, h)).astype(np.float32)
    w = (rng.normal(size=(h, h // 2)) / np.sqrt(h)).astype(np.float32)
    b = rng.normal(size=(R, 1, h // 2)).astype(np.float32)
    g = rng.normal(size=(R, S, h // 2)).astype(np.float32)
    xt, wt, bt = (t(a).requires_grad_() for a in (x, w, b))
    y = _DotAddReluPL.apply(xt.to(cd) if cd else xt, wt, bt, cd)
    y.backward(t(g).to(y.dtype))
    jx = jnp.asarray(x).astype(jcd) if jcd else jnp.asarray(x)
    jy = _dot_add_relu(jx, jnp.asarray(w), jnp.asarray(b), jcd)
    close(y.detach().float(), jy.astype(jnp.float32), compute_dtype, "y")
    want = jlb.linear_relu_bwd_pallas(
        jx, jnp.asarray(w), jnp.asarray(b), jy,
        jnp.asarray(g).astype(jy.dtype), jcd, tile_rows=16, vmem_limit=None)
    for name, got, e in zip(("dx", "dw", "db"),
                            (xt.grad, wt.grad, bt.grad), want):
        close(got, np.asarray(e.astype(jnp.float32)), compute_dtype, name)


# ---- the train step ----

def _jax_vanilla_loss_and_grads(js, params, data, k_sel):
    dirs, pose, pixels, ids = map(jnp.asarray, data)

    def loss_fn(p):
        ro, rd, target, _ = j_gather(dirs, pose, pixels, ids, k_sel, N_RAYS)
        c, f = j_render_rays(p, js, ro, rd, None, None, None, False)
        R = ro.shape[0]
        lc = jnp.sum((c.rgb - target[:, :3]) ** 2) / (R * 3)
        lf = jnp.sum((f.rgb - target[:, :3]) ** 2) / (R * 3)
        return lc + lf, (lc, lf)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return (float(loss), *map(float, aux)), jax_grads(grads)


def vanilla_step_against_jax(js, ps, jstate, state, compute_dtype, seed=4):
    """One port step and JAX's loss and grads from the same state, data and
    ray indices (perturb off)."""
    data = _data(seed)
    k_sel = jax.random.PRNGKey(11)
    (loss, lc, lf), want = _jax_vanilla_loss_and_grads(js, jstate.params,
                                                       data, k_sel)
    inds = np.array(j_select(k_sel, H * W, N_RAYS, 2))
    dirs, pose, pixels, ids = data
    step = make_train_step(ps, state, N_RAYS, 0.0, False)
    m = step(t(dirs), t(pose), t(pixels), torch.from_numpy(ids), None,
             inds=torch.from_numpy(inds))
    rtol = 1e-5 if compute_dtype is None else 1e-3
    np.testing.assert_allclose(
        [float(m.loss), float(m.loss_coarse), float(m.loss_fine)],
        [loss, lc, lf], rtol=rtol, atol=1e-6)
    assert float(m.loss_embedding) == 0.0 and state.tables is None
    got = port_grads(state)
    assert got.keys() == want.keys()
    if compute_dtype is None:
        for k in want:
            close(got[k], want[k], compute_dtype, k)
    assert state.step == 1
    assert len(state.optimizer.param_groups) == 1
    return got, want
    assert state.step == 1
    assert len(state.optimizer.param_groups) == 1


@pytest.mark.parametrize("compute_dtype,layer_bwd", [
    (None, False), ("bfloat16", False), (None, True), ("bfloat16", True)],
    ids=["f32-xla", "bf16-xla", "f32-layer_bwd", "bf16-layer_bwd"])
def test_vanilla_train_step_matches_jax(compute_dtype, layer_bwd, request,
                                        monkeypatch):
    d = vanilla_dict(compute_dtype=compute_dtype or "float32",
                     pallas_layer_bwd=layer_bwd)
    js, ps, jstate, _, state = vanilla_both(d, seed=3)
    assert trunk_path(ps) == "rays"
    calls = []
    if layer_bwd:
        request.getfixturevalue("jax_on_tpu")
        orig = jlb.linear_relu_bwd_pallas

        def counted(*args, **kwargs):
            calls.append(args[1].shape)
            return orig(*args, **kwargs)

        monkeypatch.setattr(jlb, "linear_relu_bwd_pallas", counted)
    got, want = vanilla_step_against_jax(js, ps, jstate, state,
                                         compute_dtype)
    if compute_dtype is not None:
        cancelling = {"fc_alpha.bias", "layers_xyz.4.bias"}
        for k in want:
            bound = (CANCELLING_REL_RMS if k.split(".", 1)[1] in cancelling
                     else BF16_REL_RMS)
            assert rel_rms(got[k], want[k]) <= bound, k
    # JAX's K4 ran for every layer the port sends through _DotAddReluPL:
    # 6 trunk layers and fc_feat (bias), layer_dir1 (per-ray), per pass
    if layer_bwd:
        assert sorted(calls) == sorted(2 * ([(32, 32)] * 7 + [(32, 16)]))
