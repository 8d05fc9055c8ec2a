"""The port's int8 serving path (``codenerf_tpu_torch/models/quantized.py``)
on the CPU against the JAX package's ``codenerf_tpu/models/quantized.py``,
at ``tests/test_quantized.py``'s widths: hidden 32, codes 24 / 20, 4 xyz
and 2 direction bands; FlexibleNeRF with 6 layers and a skip at 2.

  * The primitives bit for bit: round half to even, saturation at
    +-127, per-channel scales; ``_qdot`` at the padded shapes the card's
    ``torch._int_mm`` needs (N = 1, 3, 4; K = 63; 8 rows) against an
    int64 product, exactly (int32 sums below 2^24 convert to f32 exactly).
  * Calibration and quantization of both families against JAX's on the
    same weights: amax and scales within 1e-6 of each tensor's largest
    value in f32 (a near-cancelled channel of 0.006 differed by 2.4e-6
    of its own value); ``wq``
    equal in >= 99.9% of entries and never off by more than 1 (the
    amaxes come from float products summed in other orders, so a
    folded weight can sit on the other side of a rounding tie); from
    JAX's own amax, bit-identical.
  * The int8 forwards on JAX's own buffers (``weights.
    quantized_from_jax``): f32 max abs <= 1e-3, bf16 relRMS <= 1e-2.
  * ``quantize_for_serving`` with ``render_rays`` and the image renderer
    against JAX's, also on an NDC scene (whose calibration, as JAX's,
    never applies NDC): >= 60 dB in f32.  The int8 image against the
    port's own full-precision one: >= 35 dB, JAX's own bound.

Measured on the CPU when the tolerances were set: the forwards on JAX's
buffers agree to 3.0e-8 max abs in f32 and exactly in bf16; amax and
scales to 2.4e-7 of each tensor's largest value; ``wq`` from each
package's own calibration was identical; the renders against JAX's at
>= 146.1 dB, the int8 renders against full precision at >= 76.6 dB.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.core.geometry import pixel_directions as j_pixel_directions
from codenerf_tpu.eval.render import make_image_renderer as j_image_renderer
from codenerf_tpu.models import quantized as jq
from codenerf_tpu.models.mlp import CodeNeRFConfig as JCodeNeRFConfig
from codenerf_tpu.models.mlp import FlexibleNeRFConfig as JFlexibleConfig
from codenerf_tpu.models.mlp import init_codenerf, init_flexible_nerf
from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
from codenerf_tpu.pipeline import render_rays as j_render_rays
from codenerf_tpu_torch.core.geometry import pixel_directions
from codenerf_tpu_torch.eval.render import make_image_renderer
from codenerf_tpu_torch.models import quantized as q
from codenerf_tpu_torch.models.mlp import (CodeNeRF, CodeNeRFConfig,
                                           FlexibleNeRF, FlexibleNeRFConfig)
from codenerf_tpu_torch.pipeline import RenderSettings, render_rays
from codenerf_tpu_torch.weights import (codenerf_from_jax, flexible_from_jax,
                                        quantized_from_jax)
from tests.torch_port_helpers import BF16_REL_RMS, rel_rms, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

CODE = dict(hidden_size=32, shape_code_size=24, texture_code_size=20,
            num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
FLEX = dict(num_layers=6, hidden_size=32, skip_connect_ids=(2,),
            num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
CDS = {"f32": None, "bf16": "bfloat16"}
SCALE_RTOL = 1e-6
WQ_EQUAL = 0.999
F32_MAX_ABS = 1e-3
RENDER_PSNR = 60.0
INT8_VS_FP_PSNR = 35.0
NDC = (24.0, 32.0, 28.0)


def np_(x):
    return np.asarray(x)


def _code_pair(seed=0, compute_dtype=None):
    jcfg = JCodeNeRFConfig(compute_dtype=compute_dtype, **CODE)
    pcfg = CodeNeRFConfig(compute_dtype=compute_dtype, **CODE)
    params = init_codenerf(jax.random.PRNGKey(seed), jcfg)
    model = CodeNeRF(pcfg, device="cpu")
    model.load_state_dict(codenerf_from_jax(jax.tree.map(np_, params)))
    return jcfg, pcfg, params, model


def _flex_pair(seed=1, compute_dtype=None, use_viewdirs=True):
    jcfg = JFlexibleConfig(compute_dtype=compute_dtype,
                           use_viewdirs=use_viewdirs, **FLEX)
    pcfg = FlexibleNeRFConfig(compute_dtype=compute_dtype,
                              use_viewdirs=use_viewdirs, **FLEX)
    params = init_flexible_nerf(jax.random.PRNGKey(seed), jcfg)
    model = FlexibleNeRF(pcfg, device="cpu")
    model.load_state_dict(flexible_from_jax(jax.tree.map(np_, params)))
    return jcfg, pcfg, params, model


def _inputs(cfg, R=16, S=8, seed=0):
    rng = np.random.default_rng(seed)
    out = {"xyz": rng.normal(size=(R, S, cfg.dim_xyz)).astype(np.float32),
           "dir": rng.normal(size=(R, cfg.dim_dir)).astype(np.float32)}
    if isinstance(cfg, JCodeNeRFConfig):
        out["zs"] = (rng.normal(size=(R, cfg.shape_code_size)) * 0.3
                     ).astype(np.float32)
        out["zt"] = (rng.normal(size=(R, cfg.texture_code_size)) * 0.3
                     ).astype(np.float32)
    return out


def _psnr(got, want):
    mse = np.mean((np.asarray(got, np.float64)
                   - np.asarray(want, np.float64)) ** 2)
    return -10.0 * np.log10(max(mse, 1e-30))


# ---- the primitives ----

def test_quantize_tensor_matches_jax_bit_for_bit():
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.5,
                     -127.5, 300.0, -1e9, 0.0], np.float32)
    got = q.quantize_tensor(torch.from_numpy(ties), 1.0)
    want = np.asarray(jq.quantize_tensor(jnp.asarray(ties), 1.0))
    np.testing.assert_array_equal(got.numpy(), want)
    # half to even, saturation at +-127
    assert got.tolist()[:10] == [0, 2, 2, 0, -2, -2, 126, -126, 127, -127]
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 40)) * rng.uniform(0.01, 30, 40)).astype(
        np.float32)
    scale = (np.abs(x).max(0) / 127.0 * rng.uniform(0.5, 1.0, 40)).astype(
        np.float32)
    got = q.quantize_tensor(torch.from_numpy(x), torch.from_numpy(scale))
    want = np.asarray(jq.quantize_tensor(jnp.asarray(x), jnp.asarray(scale)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.abs(want) == 127).any()


def test_quantize_weight_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 24)).astype(np.float32)
    w[:, 5] = 0.0                                   # an all-zero column
    wq, sw = q.quantize_weight(torch.from_numpy(w))
    jwq, jsw = jq.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))


@pytest.mark.parametrize("m,k,n", [(8, 63, 1), (8, 32, 3), (40, 63, 4),
                                   (17, 27, 24), (300, 256, 257)])
def test_qdot_padded_shapes_match_an_int64_product(m, k, n):
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, n), dtype=np.int8)
    scale = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    layer = q.QLinear(torch.from_numpy(wq), torch.from_numpy(scale))
    assert layer.wq_t.shape == (-(-n // 8) * 8, -(-k // 8) * 8)
    assert torch.equal(layer.wq, torch.from_numpy(wq))
    before = q._qdot.calls
    got = layer(torch.from_numpy(xq).reshape(m, 1, k))
    assert q._qdot.calls == before + 1
    want = (xq.astype(np.int64) @ wq.astype(np.int64)).astype(
        np.float32) * scale
    assert got.dtype == torch.float32 and got.shape == (m, 1, n)
    np.testing.assert_array_equal(got.reshape(m, n).numpy(), want)


# ---- calibration and quantization ----

def _close_scales(got, want):
    """Within ``SCALE_RTOL`` of the tensor's largest value: a channel's
    amax is a sum of products whose rounding scales with the layer's
    inputs, not with that channel's own (possibly near-cancelled)
    value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= SCALE_RTOL * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


def _wq_close(got, want, name):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape, name
    assert np.mean(got == want) >= WQ_EQUAL, name
    assert np.abs(got - want).max() <= 1, name


def _check_layers(port_q, jquant, exact):
    """Every QLinear of ``port_q`` against JAX's "quant" subtree."""
    for name, layer in port_q.quant.items():
        jl = jquant[name]
        pairs = (zip(layer, jl) if isinstance(layer, torch.nn.ModuleList)
                 else [(layer, jl)])
        for i, (pl, jlayer) in enumerate(pairs):
            label = f"{name}[{i}]"
            if exact:
                np.testing.assert_array_equal(pl.wq.numpy(),
                                              np.asarray(jlayer["wq"]))
                np.testing.assert_array_equal(pl.scale.numpy(),
                                              np.asarray(jlayer["scale"]))
            else:
                _wq_close(pl.wq.numpy(), jlayer["wq"], label)
                _close_scales(pl.scale.numpy(), jlayer["scale"])


@pytest.mark.parametrize("encode_stream", [False, True],
                         ids=["trunk", "encode"])
def test_codenerf_amax_and_buffers_match_jax(encode_stream):
    jcfg, pcfg, params, model = _code_pair()
    x = _inputs(jcfg)
    jamax = jq.trunk_activation_amax(params, jcfg, jnp.asarray(x["xyz"]),
                                     jnp.asarray(x["dir"]),
                                     jnp.asarray(x["zs"]),
                                     jnp.asarray(x["zt"]))
    amax = q.trunk_activation_amax(model, pcfg, t(x["xyz"]), t(x["dir"]),
                                   t(x["zs"]), t(x["zt"]))
    assert set(amax) == set(jamax) == {"x0", *q.ACT_NAMES}
    for k in amax:
        _close_scales(amax[k], jamax[k])
    jquant = jq.quantize_codenerf(params, jcfg, jamax, encode_stream)["quant"]
    got = q.quantize_codenerf(model, pcfg, amax, encode_stream)
    assert set(got.quant) == set(jquant) - {"s_act"}
    assert ("layer_xyz1" in got.quant) == encode_stream
    assert set(got.s_act.keys()) == set(jquant["s_act"])
    for k in got.s_act.keys():
        _close_scales(got.s_act[k], jquant["s_act"][k])
    _check_layers(got, jquant, exact=False)
    # from JAX's own amax the buffers are JAX's, bit for bit
    same = q.quantize_codenerf(model, pcfg, {k: t(v) for k, v in
                                             jamax.items()}, encode_stream)
    _check_layers(same, jquant, exact=True)
    assert not any(p.requires_grad for p in got.parameters())
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("use_viewdirs", [True, False],
                         ids=["dirs", "nodirs"])
def test_flexible_amax_and_buffers_match_jax(use_viewdirs):
    jcfg, pcfg, params, model = _flex_pair(use_viewdirs=use_viewdirs)
    x = _inputs(jcfg)
    jdir = jnp.asarray(x["dir"]) if use_viewdirs else None
    pdir = t(x["dir"]) if use_viewdirs else None
    jamax = jq.flexible_trunk_amax(params, jcfg, jnp.asarray(x["xyz"]), jdir)
    amax = q.flexible_trunk_amax(model, pcfg, t(x["xyz"]), pdir)
    assert set(amax) == set(jamax)
    for k in amax:
        _close_scales(amax[k], jamax[k])
    jquant = jq.quantize_flexible(params, jcfg, jamax)["quant"]
    got = q.quantize_flexible(model, pcfg, amax)
    assert set(got.quant) == set(jquant) - {"s_act"}
    # the skip layer quantizes its hidden half only
    assert got.quant["layers_xyz"][2].wq.shape == (32, 32)
    _check_layers(got, jquant, exact=False)
    same = q.quantize_flexible(model, pcfg, {k: t(v) for k, v in
                                             jamax.items()})
    _check_layers(same, jquant, exact=True)


# ---- the int8 forwards on JAX's buffers ----

def _agree(got, want, compute_dtype, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got)), name
    if compute_dtype is None:
        assert np.abs(got - want).max() <= F32_MAX_ABS, (
            name, np.abs(got - want).max())
    else:
        assert rel_rms(got, want) <= BF16_REL_RMS, (name, rel_rms(got, want))


def _as_pair(jqparams, model):
    """JAX's quantized pytree of one model as ``quantized_from_jax``
    carries it, with the port's model under both keys."""
    np_q = jax.tree.map(np_, {"coarse": jqparams, "fine": jqparams})
    return quantized_from_jax(np_q, {"coarse": model, "fine": model})["fine"]


@pytest.mark.parametrize("encode_stream", [False, True],
                         ids=["trunk", "encode"])
@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_codenerf_q_forward_on_jax_buffers(compute_dtype, encode_stream):
    jcfg, pcfg, params, model = _code_pair(compute_dtype=compute_dtype)
    x = _inputs(jcfg)
    jargs = [jnp.asarray(x[k]) for k in ("xyz", "dir", "zs", "zt")]
    jqp = jq.quantize_codenerf(params, jcfg,
                               jq.trunk_activation_amax(params, jcfg, *jargs),
                               encode_stream)
    want = jq.apply_codenerf_rays_q(jqp, jcfg, *jargs)
    qmodel = _as_pair(jqp, model)
    assert isinstance(qmodel, q.QuantizedCodeNeRF)
    assert ("layer_xyz1" in qmodel.quant) == encode_stream
    got = q.apply_codenerf_rays_q(qmodel, t(x["xyz"]), t(x["dir"]),
                                  t(x["zs"]), t(x["zt"]))
    assert got.dtype == torch.float32
    _agree(got, want, compute_dtype)


@pytest.mark.parametrize("use_viewdirs", [True, False],
                         ids=["dirs", "nodirs"])
@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_flexible_q_forward_on_jax_buffers(compute_dtype, use_viewdirs):
    jcfg, pcfg, params, model = _flex_pair(compute_dtype=compute_dtype,
                                           use_viewdirs=use_viewdirs)
    x = _inputs(jcfg)
    jdir = jnp.asarray(x["dir"]) if use_viewdirs else None
    jxyz = jnp.asarray(x["xyz"])
    jqp = jq.quantize_flexible(params, jcfg,
                               jq.flexible_trunk_amax(params, jcfg, jxyz,
                                                      jdir))
    want = jq.apply_flexible_rays_q(jqp, jcfg, jxyz, jdir)
    qmodel = _as_pair(jqp, model)
    assert isinstance(qmodel, q.QuantizedFlexibleNeRF)
    got = q.apply_flexible_rays_q(qmodel, t(x["xyz"]),
                                  t(x["dir"]) if use_viewdirs else None)
    _agree(got, want, compute_dtype)


# ---- calibration, render_rays and the image renderer ----

def _settings(jcfg, pcfg, **kw):
    common = dict(num_coarse=8, num_fine=8, near=0.8, far=1.8,
                  spacing_mode="lindepth",
                  num_encoding_fn_xyz=jcfg.num_encoding_fn_xyz,
                  include_input_xyz=True, log_sampling_xyz=True,
                  use_viewdirs=True,
                  num_encoding_fn_dir=jcfg.num_encoding_fn_dir,
                  include_input_dir=True, log_sampling_dir=True)
    common.update(kw)
    return (JRenderSettings(coarse_cfg=jcfg, fine_cfg=jcfg, **common),
            RenderSettings(coarse_cfg=pcfg, fine_cfg=pcfg, **common))


def _scene(family, ndc=False, encode_stream=False):
    """(JAX settings, params, port settings, models, rays, codes) of a
    two-model scene."""
    if family == "code":
        (jcfg, pcfg, jc, mc), (_, _, jf, mf) = _code_pair(3), _code_pair(4)
    else:
        (jcfg, pcfg, jc, mc), (_, _, jf, mf) = _flex_pair(11), _flex_pair(12)
    kw = (dict(ndc=NDC, near=0.0, far=1.0, spacing_mode="lindisp") if ndc
          else {})
    js, ps = _settings(jcfg, pcfg, **kw)
    rng = np.random.default_rng(5)
    if ndc:
        ro = (rng.normal(size=(32, 3)) * 0.05).astype(np.float32)
        rd = np.concatenate([rng.uniform(-0.4, 0.4, (32, 2)),
                             -np.ones((32, 1))], -1).astype(np.float32)
    else:
        ro = (rng.normal(size=(32, 3)) * 0.1).astype(np.float32)
        rd_ = rng.normal(size=(32, 3))
        rd = (rd_ / np.linalg.norm(rd_, axis=-1, keepdims=True)).astype(
            np.float32)
    codes = (None, None)
    if family == "code":
        codes = ((rng.normal(size=(1, 24)) * 0.3).astype(np.float32),
                 (rng.normal(size=(1, 20)) * 0.3).astype(np.float32))
    return js, {"coarse": jc, "fine": jf}, ps, {"coarse": mc, "fine": mf}, \
        ro, rd, codes


def _ray_codes(codes, n, jax_side):
    if codes[0] is None:
        return None, None
    if jax_side:
        return tuple(jnp.broadcast_to(jnp.asarray(c), (n, c.shape[-1]))
                     for c in codes)
    return tuple(t(c).expand(n, -1) for c in codes)


CASES = {"code": ("code", False, False), "code-encode": ("code", False, True),
         "vanilla": ("flex", False, False), "vanilla-ndc": ("flex", True,
                                                            False)}


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_quantize_for_serving_and_render_rays_match_jax(case):
    family, ndc, encode_stream = case
    js, jparams, ps, models, ro, rd, codes = _scene(family, ndc)
    jzs, jzt = _ray_codes(codes, 32, True)
    pzs, pzt = _ray_codes(codes, 32, False)
    jqp = jq.quantize_for_serving(jparams, js, jnp.asarray(ro),
                                  jnp.asarray(rd), jzs, jzt, encode_stream)
    qm = q.quantize_for_serving(models, ps, t(ro), t(rd), pzs, pzt,
                                encode_stream)
    for key in ("coarse", "fine"):
        for k in qm[key].s_act.keys():
            _close_scales(qm[key].s_act[k], jqp[key]["quant"]["s_act"][k])
        _check_layers(qm[key], jqp[key]["quant"], exact=False)
    _, jf = j_render_rays(jqp, js, jnp.asarray(ro), jnp.asarray(rd), jzs,
                          jzt, None, False)
    _, pf = render_rays(qm, ps, t(ro), t(rd), pzs, pzt)
    assert _psnr(pf.rgb.numpy(), jf.rgb) >= RENDER_PSNR
    # the int8 render against the port's own full-precision render
    _, ff = render_rays(models, ps, t(ro), t(rd), pzs, pzt)
    assert _psnr(pf.rgb.numpy(), ff.rgb.numpy()) >= INT8_VS_FP_PSNR


@pytest.mark.parametrize("family", ["code", "flex"])
def test_image_renderer_with_int8_models_matches_jax(family):
    js, jparams, ps, models, ro, rd, codes = _scene(family)
    jzs, jzt = _ray_codes(codes, 32, True)
    pzs, pzt = _ray_codes(codes, 32, False)
    jqp = jq.quantize_for_serving(jparams, js, jnp.asarray(ro),
                                  jnp.asarray(rd), jzs, jzt)
    qm = quantized_from_jax(jax.tree.map(np_, jqp), models)
    H, W = 6, 8
    intr = np.array([[8.0, 0, 4.0, 0], [0, 8.0, 3.0, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 1.3
    jz = (None, None) if codes[0] is None else tuple(jnp.asarray(c)
                                                      for c in codes)
    pz = (None, None) if codes[0] is None else tuple(t(c) for c in codes)
    want = j_image_renderer(js, H, W, chunksize=16)(
        jqp, j_pixel_directions(H, W, jnp.asarray(intr)), jnp.asarray(pose),
        *jz)
    before = q._qdot.calls
    got = make_image_renderer(ps, H, W, chunksize=16, device="cpu")(
        qm, pixel_directions(H, W, t(intr)), t(pose), *pz)
    # 3 chunks x 2 passes x the model's products
    per_pass = 6 if family == "code" else 5 + 4
    assert q._qdot.calls - before == 3 * 2 * per_pass
    assert _psnr(got.numpy(), want) >= RENDER_PSNR


def test_int8_dispatch_comes_before_the_trunk_path(monkeypatch):
    """A quantized model takes its int8 forward whatever the runtime flags
    pick for the float model, and a failed int8 product raises."""
    js, jparams, ps, models, ro, rd, codes = _scene("code")
    pzs, pzt = _ray_codes(codes, 32, False)
    qm = q.quantize_for_serving(models, ps, t(ro), t(rd), pzs, pzt)
    _, plain = render_rays(qm, ps, t(ro), t(rd), pzs, pzt)
    fused = dataclasses.replace(ps, use_pallas=True, pallas_backward=True)
    _, got = render_rays(qm, fused, t(ro), t(rd), pzs, pzt)
    assert torch.equal(got.rgb, plain.rgb)

    def refuse(*args):
        raise RuntimeError("int8 GEMM refused")
    monkeypatch.setattr(torch, "_int_mm", refuse)
    with pytest.raises(RuntimeError, match="int8 GEMM refused"):
        render_rays(qm, ps, t(ro), t(rd), pzs, pzt)


def test_quantized_module_moves_and_copies_its_float_model():
    _, pcfg, _, model = _code_pair()
    x = _inputs(JCodeNeRFConfig(**CODE))
    qm = q.quantize_codenerf(model, pcfg, q.trunk_activation_amax(
        model, pcfg, t(x["xyz"]), t(x["dir"]), t(x["zs"]), t(x["zt"])))
    want = q.apply_codenerf_rays_q(qm, t(x["xyz"]), t(x["dir"]), t(x["zs"]),
                                   t(x["zt"]))
    with torch.no_grad():
        model.fc_rgb.weight.add_(1.0)          # the copy does not see it
    moved = qm.to(torch.float32)
    assert moved.quant["fc_rgb_top"].wq_t.dtype == torch.int8
    got = q.apply_codenerf_rays_q(moved, t(x["xyz"]), t(x["dir"]),
                                  t(x["zs"]), t(x["zt"]))
    assert torch.equal(got, want)
    names = {n for n, _ in qm.named_buffers()}
    assert {"s_act.x1", "quant.layer_xyz2_top.wq_t",
            "quant.layer_xyz2_top.scale"} <= names
