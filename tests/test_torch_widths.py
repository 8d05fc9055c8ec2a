"""Widths the port's kernels once refused: hidden and code widths that are
not multiples of 32 (16 for K4), bf16 K1 wider than 256 or with more than
10 xyz bands, and bf16 K4 wider than 256.

The wrappers zero-pad widths to the kernels' multiples
(``ops/fused.py::pad_trunk``, ``ops/layer_bwd.py::pad_layer``) and the
plans pick a kernel by shape before any launch (``ops/plan.py::k1_plan``,
``k4_layout``).  On the CPU: the plans accept the widths; the plain
versions on the padded inputs equal the unpadded ones (a padded unit adds
exact zeros): bit for bit in bf16, and in f32 to 8 ulps (2^-20) of each
output's scale, since torch's CPU sums over rows vectorise by the row's
width and so add in another order (measured: 2.6e-7 of the scale at
most, in bd2, a sum over 48 rows); and at
hidden 48 / codes 40 the padded
plain versions match the JAX package's Pallas functions in interpret mode
at the tolerances of ``tests/test_torch_fused*.py`` and
``tests/test_torch_layer_bwd.py`` (f32 atol 1e-5; bf16 relRMS 1e-2).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from codenerf_tpu.ops import fused as jfused
from codenerf_tpu.ops import layer_bwd as jlb
from codenerf_tpu_torch.ops import plan
from codenerf_tpu_torch.ops.fused import (PER_RAY_KEYS, hybrid_forward_plain,
                                          kernel_weights, pad_trunk,
                                          per_ray_parts, trunk_backward_plain,
                                          trunk_forward_plain,
                                          unpad_trunk_grads)
from codenerf_tpu_torch.ops.layer_bwd import linear_relu_bwd_plain, pad_layer
from tests.torch_port_helpers import (BF16_REL_RMS, F32_ATOL, configs,
                                      jax_and_port_models, rel_rms, t)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

N_SM = 132                     # an H100 SXM
H, SC = 48, 40                 # neither a multiple of 32
WIDE = dict(hidden_size=H, shape_code_size=SC, texture_code_size=SC)
CDS = {"f32": None, "bf16": "bfloat16"}


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU."""
    for mod in (jfused, jlb):
        orig = mod.pl.pallas_call

        def interp(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", interp)


# ---- the plans ----

@pytest.mark.parametrize("widths,elem,route,padded", [
    ((48, 40, 4), 2, "wgmma", (64, 64)),
    ((48, 40, 4), 4, "rows", (64, 64)),
    ((288, 256, 10), 2, "rows", (288, 256)),
    ((256, 80, 12), 2, "rows", (256, 96)),
    ((288, 80, 12), 4, "rows", (288, 96)),
])
def test_k1_plan_accepts_the_widths(widths, elem, route, padded):
    Hw, SCw, F = widths
    p = plan.k1_plan(4096, 32, Hw, SCw, F, elem, N_SM)
    assert p["route"] == route and (p["h"], p["sc"]) == padded
    assert p["smem"] <= plan.SMEM_LIMIT
    # K2 / K3 plan the padded widths their wrapper runs
    b = plan.trunk_bwd_plan(4096, 32, *padded, F, True, elem, N_SM, False)
    assert b["rows"]["smem"] <= plan.SMEM_LIMIT


@pytest.mark.parametrize("KN,elem,padded,w_in_smem", [
    ((40, 24), 2, (48, 32), True),
    ((48, 288), 2, (48, 288), False),
    ((288, 40), 2, (288, 48), False),
    ((40, 24), 4, (48, 32), False),
])
def test_k4_layout_accepts_the_widths(KN, elem, padded, w_in_smem):
    k, n, smem_w = plan.k4_layout(*KN, elem)
    assert (k, n) == padded and smem_w is w_in_smem
    p = plan.layer_bwd_plan(64 * 8, 8, k, n, True, elem, N_SM, smem_w)
    assert p["rows"]["tile_rows"] == (64 if w_in_smem else 32)
    assert p["rows"]["smem"] <= plan.SMEM_LIMIT


# hidden 864: past the 832 a full row tile held; K4's N 1760: past 1744
WIDER = dict(hidden_size=864, shape_code_size=864, texture_code_size=864)


@pytest.mark.parametrize("elem,rows", [(2, (32, 32)), (4, (16, 16))],
                         ids=["bf16", "f32"])
def test_row_tiles_shrink_with_the_width(elem, rows):
    """Widths whose full row tile shared memory cannot hold run a half or a
    quarter tile (``plan.row_tile``), up to the widths where JAX's own
    kernels stop: at a padded width of 3552 its fused trunk's four
    [h, h] bf16 weights alone fill its 100 MB VMEM limit."""
    f = plan.k1_plan(4096, 32, 864, 864, 6, elem, N_SM)
    b = plan.trunk_bwd_plan(4096, 32, 864, 864, 6, True, elem, N_SM, False)
    assert f["route"] == "rows"
    assert (f["tile_rows"], b["rows"]["tile_rows"]) == rows
    assert f["tile_rows"] < plan.tile_rows(elem)
    # hidden 1760 and K4's N 3520 take a quarter tile
    quarter = plan.tile_rows(elem) // 4
    assert plan.k1_plan(64, 8, 1760, 1760, 6, elem, N_SM)["tile_rows"] == \
        quarter
    assert plan.trunk_bwd_plan(64, 8, 1760, 1760, 6, True, elem, N_SM,
                               False)["rows"]["tile_rows"] == quarter
    assert plan.layer_bwd_plan(64, 8, 16, 3520, True, elem, N_SM,
                               False)["rows"]["tile_rows"] == 8
    for h in range(32, 3553, 32):
        assert plan.k1_plan(64, 8, h, h, 10, elem, N_SM)["smem"] <= \
            plan.SMEM_LIMIT
        b = plan.trunk_bwd_plan(64, 8, h, h, 10, True, elem, N_SM, True)
        assert b["rows"]["smem"] <= plan.SMEM_LIMIT
        assert b["rows"]["tile_rows"] in {plan.tile_rows(elem) >> i
                                         for i in range(3)}
    k, n, w_in_smem = plan.k4_layout(16, 1760, elem)
    p = plan.layer_bwd_plan(64 * 8, 8, k, n, True, elem, N_SM, w_in_smem)
    assert (n, w_in_smem, p["rows"]["tile_rows"]) == (1760, False, 16)
    assert p["rows"]["smem"] <= plan.SMEM_LIMIT
    for n in range(16, 6449, 16):
        k, n, w_in_smem = plan.k4_layout(16, n, elem)
        assert plan.layer_bwd_plan(64, 8, k, n, False, elem, N_SM,
                                   w_in_smem)["rows"]["smem"] <= \
            plan.SMEM_LIMIT


def test_shared_memory_still_bounds_the_width():
    """What stays refused: a quarter row tile that shared memory cannot
    hold (past JAX's own kernels' VMEM, see ``test_row_tiles_shrink_with_the_width``)."""
    with pytest.raises(ValueError, match=r"h=4096, s=4096"):
        plan.k1_plan(64, 8, 4090, 4090, 10, 2, N_SM)
    with pytest.raises(ValueError, match=r"w \(16, 8192\)"):
        plan.k4_layout(16, 8192, 2)


# ---- padding is exact ----

def _trunk_inputs(compute_dtype, R=6, S=8, seed=0, widths=WIDE):
    """The trunk's inputs as the JAX VJP sees them at ``widths`` (hidden 48
    / codes 40 by default), numpy f32."""
    jcfg, tcfg = configs(compute_dtype, **widths)
    params, _ = jax_and_port_models(jcfg, tcfg, seed=seed)
    rng = np.random.default_rng(seed)
    sc = jcfg.shape_code_size
    pts = rng.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, jcfg.dim_dir)).astype(np.float32)
    zs = rng.normal(size=(R, sc)).astype(np.float32)
    zt = rng.normal(size=(R, sc)).astype(np.float32)
    g = rng.normal(size=(R, S, 4)).astype(np.float32)
    per_ray = jfused._per_ray_parts(params, jcfg, *map(jnp.asarray,
                                                       (dirs, zs, zt)))
    weights = jfused._kernel_weights(params, jcfg, jcfg.num_encoding_fn_xyz,
                                     True, cast=False)
    per_ray = {k: np.asarray(v, np.float32) for k, v in per_ray.items()}
    weights = {k: None if v is None else np.asarray(v, np.float32)
               for k, v in weights.items()}
    return pts, per_ray, weights, g


def _torch(per_ray, weights):
    return ({k: t(v) for k, v in per_ray.items()},
            {k: None if v is None else t(v) for k, v in weights.items()})


def _cd(compute_dtype):
    return torch.bfloat16 if compute_dtype else None


def _same(got, want, compute_dtype, name=""):
    """Bit for bit in bf16; in f32 within 8 ulps (2^-20) of the output's
    largest magnitude (another order of the same f32 sums)."""
    if compute_dtype:
        assert torch.equal(got, want), name
    else:
        bound = 2.0 ** -20 * float(want.abs().max())
        assert float((got - want).abs().max()) <= bound, name


@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_padded_k1_plain_equals_unpadded(compute_dtype):
    pts, per_ray, weights, _ = _trunk_inputs(compute_dtype)
    tr, tw = _torch(per_ray, weights)
    want = trunk_forward_plain(t(pts), tr, tw,
                               compute_dtype=_cd(compute_dtype))
    pr, pw, _, _ = pad_trunk(tr, tw, None, None, 64, 64)
    assert pw["w2"].shape == (64, 64) and pr["featp"].shape[-1] == 64
    got = trunk_forward_plain(t(pts), pr, pw,
                              compute_dtype=_cd(compute_dtype))
    _same(got, want, compute_dtype)


@pytest.mark.parametrize("stored", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_padded_k2_k3_plain_equals_unpadded(compute_dtype, stored):
    pts, per_ray, weights, g = _trunk_inputs(compute_dtype, seed=1)
    tr, tw = _torch(per_ray, weights)
    cd = _cd(compute_dtype)
    acts = (hybrid_forward_plain(t(pts), tr, tw, compute_dtype=cd)[1]
            if stored else None)
    want = trunk_backward_plain(t(pts), tr, tw["b1"], tw, t(g), acts,
                                compute_dtype=cd)
    pr, pw, pb1, pacts = pad_trunk(tr, tw, tw["b1"], acts, 64, 64)
    got = unpad_trunk_grads(trunk_backward_plain(
        t(pts), pr, pb1, pw, t(g), pacts, compute_dtype=cd), H, SC)
    _same(got[0], want[0], compute_dtype, "g_pts")
    _same(got[2], want[2], compute_dtype, "db1")
    for k in PER_RAY_KEYS:
        _same(got[1][k], want[1][k], compute_dtype, k)
    for k, v in want[3].items():
        _same(got[3][k], v, compute_dtype, k)


def _layer_inputs(K, N, bf16, seed=0, R=6, S=8):
    rng = np.random.default_rng(seed)
    dt = torch.bfloat16 if bf16 else torch.float32
    x = t(rng.normal(size=(R, S, K))).to(dt)
    w = t(rng.normal(size=(K, N)) / np.sqrt(K))
    b = t(rng.normal(size=(R, 1, N)))
    y = t(np.maximum(rng.normal(size=(R, S, N)), 0.0)).to(dt)
    g = t(rng.normal(size=(R, S, N))).to(dt)
    return x, w, b, y, g, (torch.bfloat16 if bf16 else None)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_padded_k4_plain_equals_unpadded(bf16):
    x, w, b, y, g, cd = _layer_inputs(SC, 24, bf16)
    want = linear_relu_bwd_plain(x, w, b, y, g, cd)
    px, pw, pb, py, pg = pad_layer(x, w, b, y, g, 48, 32)
    got = linear_relu_bwd_plain(px, pw, pb, py, pg, cd)
    _same(got[0][..., :SC], want[0], bf16, "dx")
    _same(got[1][:SC, :24], want[1], bf16, "dw")
    _same(got[2][..., :24], want[2], bf16, "db")
    assert not got[0][..., SC:].any() and not got[1][SC:].any()


# ---- against JAX at hidden 48 / codes 40 ----

def _close(got, want, compute_dtype, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    if compute_dtype is None:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0,
                                   err_msg=name)
    else:
        assert rel_rms(got, want) <= BF16_REL_RMS, name


@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_padded_trunk_forward_matches_jax_pallas(compute_dtype):
    jcfg, tcfg = configs(compute_dtype, **WIDE)
    params, model = jax_and_port_models(jcfg, tcfg, seed=2)
    rng = np.random.default_rng(2)
    R, S, F = 8, 16, jcfg.num_encoding_fn_xyz
    pts = rng.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, jcfg.dim_dir)).astype(np.float32)
    zs, zt = (rng.normal(size=(R, SC)).astype(np.float32) for _ in "st")
    want = jfused.make_fused_codenerf(jcfg, F, True, True, tile_rows=64)(
        params, *map(jnp.asarray, (pts, dirs, zs, zt)))
    with torch.no_grad():
        per_ray = per_ray_parts(model, t(dirs), t(zs), t(zt))
        weights = kernel_weights(model, F, True)
        pr, pw, _, _ = pad_trunk(per_ray, weights, None, None, 64, 64)
        got = trunk_forward_plain(t(pts), pr, pw, compute_dtype=model.cfg.cdtype)
    _close(got, want, compute_dtype, "raw")


@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_padded_trunk_backward_matches_jax_pallas(compute_dtype):
    pts, per_ray, weights, g = _trunk_inputs(compute_dtype, seed=3)
    tr, tw = _torch(per_ray, weights)
    pr, pw, pb1, _ = pad_trunk(tr, tw, tw["b1"], None, 64, 64)
    got = unpad_trunk_grads(trunk_backward_plain(
        t(pts), pr, pb1, pw, t(g), compute_dtype=_cd(compute_dtype)), H, SC)
    want = jfused._trunk_bwd_pallas(
        jnp.asarray(pts), {k: jnp.asarray(v) for k, v in per_ray.items()},
        jnp.asarray(weights["b1"]),
        {k: None if v is None else jnp.asarray(v) for k, v in weights.items()},
        jnp.asarray(g), S=pts.shape[1], T=2,
        compute_dtype=jnp.bfloat16 if compute_dtype else jnp.float32)
    _close(got[0], want[0], compute_dtype, "g_pts")
    _close(got[2], want[2], compute_dtype, "db1")
    for k in PER_RAY_KEYS:
        _close(got[1][k], want[1][k], compute_dtype, k)
    for k, v in got[3].items():
        if v is not None:
            _close(v, want[3][k], compute_dtype, k)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_padded_k4_plain_matches_jax_pallas(bf16):
    x, w, b, y, g, cd = _layer_inputs(SC, 24, bf16, seed=4)
    jdt = jnp.bfloat16 if bf16 else jnp.float32

    def j(a):
        return jnp.asarray(a.float().numpy()).astype(
            jdt if a.dtype == torch.bfloat16 else jnp.float32)
    want = jlb.linear_relu_bwd_pallas(j(x), j(w), j(b), j(y), j(g),
                                      jdt if bf16 else None, tile_rows=16,
                                      vmem_limit=None)
    px, pw, pb, py, pg = pad_layer(x, w, b, y, g, 48, 32)
    dx, dw, db = linear_relu_bwd_plain(px, pw, pb, py, pg, cd)
    _close(dx[..., :SC].float(), want[0], cd, "dx")
    _close(dw[:SC, :24], want[1], None, "dw")
    _close(db[..., :24], want[2], None, "db")


@pytest.mark.parametrize("compute_dtype", CDS.values(), ids=CDS.keys())
def test_wide_trunk_backward_matches_jax_pallas(compute_dtype):
    """K2's plain version at hidden 864 (a half or quarter row tile on the
    card) against JAX's Pallas backward, small R."""
    pts, per_ray, weights, g = _trunk_inputs(compute_dtype, R=2, S=4,
                                             seed=5, widths=WIDER)
    tr, tw = _torch(per_ray, weights)
    got = trunk_backward_plain(t(pts), tr, tw["b1"], tw, t(g),
                               compute_dtype=_cd(compute_dtype))
    want = jfused._trunk_bwd_pallas(
        jnp.asarray(pts), {k: jnp.asarray(v) for k, v in per_ray.items()},
        jnp.asarray(weights["b1"]),
        {k: None if v is None else jnp.asarray(v) for k, v in weights.items()},
        jnp.asarray(g), S=pts.shape[1], T=2,
        compute_dtype=jnp.bfloat16 if compute_dtype else jnp.float32)
    _close(got[0], want[0], compute_dtype, "g_pts")
    for k in PER_RAY_KEYS:
        _close(got[1][k], want[1][k], compute_dtype, k)
    for k, v in got[3].items():
        if v is not None:
            _close(v, want[3][k], compute_dtype, k)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_wide_k4_plain_matches_jax_pallas(bf16):
    """K4's plain version at N = 1760 (a 16-row tile on the card) against
    JAX's Pallas backward."""
    x, w, b, y, g, cd = _layer_inputs(16, 1760, bf16, seed=6, R=2, S=8)
    g = g * 1e-2        # a cotangent of a loss's scale: dx sums 1760 terms
    jdt = jnp.bfloat16 if bf16 else jnp.float32

    def j(a):
        return jnp.asarray(a.float().numpy()).astype(
            jdt if a.dtype == torch.bfloat16 else jnp.float32)
    want = jlb.linear_relu_bwd_pallas(j(x), j(w), j(b), j(y), j(g),
                                      jdt if bf16 else None, tile_rows=16,
                                      vmem_limit=None)
    got = linear_relu_bwd_plain(x, w, b, y, g, cd)
    for name, a, e in zip(("dx", "dw", "db"), got, want):
        _close(a.float(), e, cd, name)
