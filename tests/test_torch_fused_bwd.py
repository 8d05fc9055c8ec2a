"""Port parity for the trunk backward: K2's and K3's plain versions
(codenerf_tpu_torch.ops.fused.trunk_backward_plain) against the JAX
package's Pallas backward ``_trunk_bwd_pallas`` in interpret mode, and
torch autograd through ``TrunkFunction`` / ``HybridTrunkFunction`` against
``jax.grad`` through ``make_fused_codenerf(pallas_backward=True)`` and
``make_hybrid_codenerf``.

Tolerances:
  * f32: atol 1e-5 on every output.  g_pts sums the band-scaled encode
    cotangents, sum_k f_k * g_scaled[3k + c] with f_k up to 2^(F-1), so
    it could amplify rounding; at F = 4 the measured worst difference is
    7e-8 against values up to 0.55 (the other outputs: 7e-7), so it
    needs no looser bound.
  * bf16: relRMS <= 1e-2 per output.  One bf16 ulp is 2^-8 relative; the
    two frameworks sum products in different orders, so a relu mask or a
    rounding may flip at an ulp.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.models.ray_structured import _dot_lp as j_dot_lp
from codenerf_tpu.ops import fused as jfused
from codenerf_tpu_torch.models.ray_structured import _mm
from codenerf_tpu_torch.ops.fused import (PER_RAY_KEYS, hybrid_forward_plain,
                                          train_codenerf, trunk_backward,
                                          trunk_backward_plain)
from tests.torch_port_helpers import (BF16_REL_RMS, F32_ATOL, configs,
                                      jax_and_port_models, rel_rms, t)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

WEIGHT_GRADS = ("w1s", "w1c", "w2", "wof", "wos", "wd", "wd2", "bd2", "wr")


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU."""
    orig = jfused.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfused.pl, "pallas_call", interp)


def _trunk_inputs(compute_dtype, include_input, R, S, seed):
    """The trunk's inputs as the JAX VJP sees them: per-ray rows from
    ``_per_ray_parts``, f32 kernel weights (``cast=False``), pts and a
    cotangent g, all numpy."""
    jcfg, _ = configs(compute_dtype, include_input_xyz=include_input)
    params, _ = jax_and_port_models(*configs(
        compute_dtype, include_input_xyz=include_input), seed=seed)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, jcfg.dim_dir)).astype(np.float32)
    zs = rng.normal(size=(R, jcfg.shape_code_size)).astype(np.float32)
    zt = rng.normal(size=(R, jcfg.texture_code_size)).astype(np.float32)
    g = rng.normal(size=(R, S, 4)).astype(np.float32)
    per_ray = jfused._per_ray_parts(params, jcfg, *map(jnp.asarray,
                                                       (dirs, zs, zt)))
    weights = jfused._kernel_weights(params, jcfg, jcfg.num_encoding_fn_xyz,
                                     True, cast=False)
    per_ray = {k: np.asarray(v, np.float32) for k, v in per_ray.items()}
    weights = {k: None if v is None else np.asarray(v, np.float32)
               for k, v in weights.items()}
    return pts, per_ray, weights, g


def _flat(g_pts, g_per_ray, db1, dw):
    out = {"g_pts": g_pts, "db1": db1}
    out.update({f"g_{k}": g_per_ray[k] for k in PER_RAY_KEYS})
    out.update({f"d{k}": dw[k] for k in WEIGHT_GRADS})
    if dw["w1x"] is not None:
        out["dw1x"] = dw["w1x"]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _compare(got, want, compute_dtype):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        if compute_dtype is None:
            np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL,
                                       rtol=0, err_msg=k)
        else:
            assert rel_rms(got[k], want[k]) <= BF16_REL_RMS, k


def _both_bwd(compute_dtype, include_input, T, stored, R=6, S=8, seed=0):
    pts, per_ray, weights, g = _trunk_inputs(compute_dtype, include_input,
                                             R, S, seed)
    cd_t = torch.bfloat16 if compute_dtype else None
    tw = {k: None if v is None else t(v) for k, v in weights.items()}
    tr = {k: t(v) for k, v in per_ray.items()}
    acts = None
    if stored:
        # the same stored activations for both sides
        _, acts = hybrid_forward_plain(t(pts), tr, tw, compute_dtype=cd_t)
    got = trunk_backward_plain(t(pts), tr, tw["b1"], tw, t(g), acts,
                               compute_dtype=cd_t)
    jacts = None if acts is None else {
        k: jnp.asarray(v.float().numpy()).astype(
            jnp.bfloat16 if compute_dtype else jnp.float32)
        for k, v in acts.items()}
    want = jfused._trunk_bwd_pallas(
        jnp.asarray(pts), {k: jnp.asarray(v) for k, v in per_ray.items()},
        jnp.asarray(weights["b1"]),
        {k: None if v is None else jnp.asarray(v) for k, v in weights.items()},
        jnp.asarray(g), S=S, T=T,
        compute_dtype=jnp.bfloat16 if compute_dtype else jnp.float32,
        acts=jacts)
    return _flat(*[x for x in got]), _flat(*want)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("include_input", [True, False])
@pytest.mark.parametrize("T", [6, 2])
def test_k2_plain_matches_pallas_backward(compute_dtype, include_input, T):
    got, want = _both_bwd(compute_dtype, include_input, T, stored=False)
    _compare(got, want, compute_dtype)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("include_input", [True, False])
def test_k3_plain_matches_pallas_backward(compute_dtype, include_input):
    got, want = _both_bwd(compute_dtype, include_input, 2, stored=True,
                          seed=1)
    _compare(got, want, compute_dtype)


def _whole_grads(compute_dtype, hybrid, seed=2, R=6, S=8):
    jcfg, tcfg = configs(compute_dtype)
    params, model = jax_and_port_models(jcfg, tcfg, seed=seed)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, jcfg.dim_dir)).astype(np.float32)
    zs = rng.normal(size=(R, jcfg.shape_code_size)).astype(np.float32)
    zt = rng.normal(size=(R, jcfg.texture_code_size)).astype(np.float32)
    wgt = rng.normal(size=(R, S, 4)).astype(np.float32)
    F = jcfg.num_encoding_fn_xyz
    if hybrid:
        fn = jfused.make_hybrid_codenerf(jcfg, F, True, True,
                                         tile_rows_bwd=16, vmem_limit=None)
    else:
        fn = jfused.make_fused_codenerf(jcfg, F, True, True, tile_rows=16,
                                        pallas_backward=True)

    def loss(p, pt, de, a, b):
        return jnp.sum(jnp.asarray(wgt) * fn(p, pt, de, a, b))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        params, *map(jnp.asarray, (pts, dirs, zs, zt)))
    ins = [t(a).requires_grad_() for a in (pts, dirs, zs, zt)]
    raw = train_codenerf(model, *ins, num_freq_xyz=F, log_sampling_xyz=True,
                         hybrid=hybrid)
    (raw * t(wgt)).sum().backward()
    got = {f"{n}.{p}": getattr(getattr(model, n),
                               "weight" if p == "w" else "bias").grad
           for n in params for p in ("w", "b")}
    got = {k: (v.t() if k.endswith(".w") else v).numpy()
           for k, v in got.items()}
    want_flat = {f"{n}.{p}": np.asarray(want[0][n][p]) for n in params
                 for p in ("w", "b")}
    for name, a, b in zip(("pts", "dir_enc", "z_s", "z_t"), ins, want[1:]):
        got[name] = a.grad.numpy()
        want_flat[name] = np.asarray(b)
    return got, want_flat


@pytest.mark.parametrize("hybrid", [False, True])
def test_whole_function_grads_f32(hybrid):
    got, want = _whole_grads(None, hybrid)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("hybrid", [False, True])
def test_whole_function_grads_bf16(hybrid):
    got, want = _whole_grads("bfloat16", hybrid, seed=3)
    for k in want:
        assert rel_rms(got[k], want[k]) <= BF16_REL_RMS, k


def test_fused_and_hybrid_modes_agree_on_cpu():
    """Fused and hybrid mode compute the same function: in f32 the
    gradients agree to f32 rounding."""
    a, _ = _whole_grads(None, False, seed=4)
    b, _ = _whole_grads(None, True, seed=4)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def _dot_lp_inputs(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 6, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 16)) / 6).astype(np.float32)
    g = rng.normal(size=(4, 6, 16)).astype(np.float32)
    def jloss(x_, w_):
        return jnp.sum(j_dot_lp(x_, w_, jnp.bfloat16).astype(jnp.float32)
                       * jnp.asarray(g))
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return x, w, g, np.asarray(jdx), np.asarray(jdw)


def _torch_grads(mm, x, w, g):
    tx, tw = t(x).requires_grad_(), t(w).requires_grad_()
    (mm(tx, tw).float() * t(g)).sum().backward()
    return tx.grad.numpy(), tw.grad.numpy()


def test_dot_lp_grads_match_jax():
    """``_mm`` keeps dx of an f32 x and dw in f32, as JAX ``_dot_lp``
    does (f32 sums of bf16 products in another order: rtol 1e-5)."""
    x, w, g, jdx, jdw = _dot_lp_inputs()
    dx, dw = _torch_grads(lambda a, b: _mm(a, b, torch.bfloat16), x, w, g)
    np.testing.assert_allclose(dx, jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw, jdw, rtol=1e-5, atol=1e-5)


def test_plain_autograd_through_the_casts_rounds_the_grads():
    """The fault the Function repairs: plain autograd through
    ``(x.to(cd).float() @ w.to(cd).float()).to(cd)`` rounds dw and dx of
    an f32 x to bf16, far outside the tolerance the Function meets."""
    x, w, g, jdx, jdw = _dot_lp_inputs()
    bf = torch.bfloat16
    dx, dw = _torch_grads(
        lambda a, b: (a.to(bf).float() @ b.to(bf).float()).to(bf), x, w, g)
    assert not np.allclose(dw, jdw, rtol=1e-5, atol=1e-5)
    assert not np.allclose(dx, jdx, rtol=1e-5, atol=1e-5)
    # the rounding is bf16's: within 2^-8 relative
    assert rel_rms(dw, jdw) <= 2.0 ** -8


def test_backward_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    pts, per_ray, weights, g = _trunk_inputs("bfloat16", True, 4, 8, 6)
    tw = {k: None if v is None else t(v) for k, v in weights.items()}
    tr = {k: t(v) for k, v in per_ray.items()}
    _, acts = hybrid_forward_plain(t(pts), tr, tw,
                                   compute_dtype=torch.bfloat16)
    before = (trunk_backward.launches_recompute,
              trunk_backward.launches_stored)
    for a in (None, acts):
        got = trunk_backward(t(pts), tr, tw["b1"], tw, t(g), a,
                             compute_dtype=torch.bfloat16)
        want = trunk_backward_plain(t(pts), tr, tw["b1"], tw, t(g), a,
                                    compute_dtype=torch.bfloat16)
        for k, v in _flat(*want).items():
            np.testing.assert_array_equal(_flat(*got)[k], v, err_msg=k)
    assert (trunk_backward.launches_recompute,
            trunk_backward.launches_stored) == before
