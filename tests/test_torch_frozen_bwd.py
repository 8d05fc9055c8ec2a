"""The trunk backward of a frozen model: no weight-gradient work.

TTO and validation freeze the model (``eval/tto.py::frozen``), so nothing
reads K2's or K3's weight grads there.  ``trunk_backward`` and
``trunk_backward_plain`` take ``need_dw``; ``TrunkFunction`` and
``HybridTrunkFunction`` derive it from ``ctx.needs_input_grad`` over b1 and
the weights and return None for those.  g_pts and the per-ray grads come
from the same code with and without it.

These tests hold the frozen call to the full call (equal: the same
arithmetic) and both to the JAX package's Pallas backward
``_trunk_bwd_pallas`` in interpret mode, at ``test_torch_fused_bwd.py``'s
tolerances (f32: atol 1e-5; bf16: relRMS <= 1e-2, one bf16 ulp is 2^-8
and the frameworks sum in other orders), and the Functions under
``frozen`` to the same Functions with a trainable model.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from codenerf_tpu.ops import fused as jfused
from codenerf_tpu_torch.eval.tto import frozen
from codenerf_tpu_torch.ops import fused
from codenerf_tpu_torch.ops.fused import (PER_RAY_KEYS, hybrid_forward_plain,
                                          train_codenerf, trunk_backward,
                                          trunk_backward_plain)
from tests.test_torch_fused_bwd import _flat, _trunk_inputs
from tests.torch_port_helpers import (BF16_REL_RMS, F32_ATOL, configs,
                                      jax_and_port_models, rel_rms, t)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

PER_RAY_GRADS = ("g_pts", *(f"g_{k}" for k in PER_RAY_KEYS))


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU."""
    orig = jfused.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfused.pl, "pallas_call", interp)


def _ray_grads(g_pts, g_per_ray):
    out = {"g_pts": g_pts}
    out.update({f"g_{k}": g_per_ray[k] for k in PER_RAY_KEYS})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("include_input", [True, False])
@pytest.mark.parametrize("stored", [False, True], ids=["K2", "K3"])
def test_frozen_plain_equals_the_full_call_and_jax(compute_dtype,
                                                   include_input, stored):
    R, S = 6, 8
    pts, per_ray, weights, g = _trunk_inputs(compute_dtype, include_input,
                                             R, S, seed=7)
    cd = torch.bfloat16 if compute_dtype else None
    tw = {k: None if v is None else t(v) for k, v in weights.items()}
    tr = {k: t(v) for k, v in per_ray.items()}
    acts = (hybrid_forward_plain(t(pts), tr, tw, compute_dtype=cd)[1]
            if stored else None)
    full = trunk_backward_plain(t(pts), tr, tw["b1"], tw, t(g), acts,
                                compute_dtype=cd)
    cold = trunk_backward_plain(t(pts), tr, tw["b1"], tw, t(g), acts,
                                compute_dtype=cd, need_dw=False)
    assert cold[2] is None and cold[3] is None
    got, want_full = _ray_grads(*cold[:2]), _ray_grads(*full[:2])
    for k in PER_RAY_GRADS:
        np.testing.assert_array_equal(got[k], want_full[k], err_msg=k)

    jacts = None if acts is None else {
        k: jnp.asarray(v.float().numpy()).astype(
            jnp.bfloat16 if compute_dtype else jnp.float32)
        for k, v in acts.items()}
    want = _flat(*jfused._trunk_bwd_pallas(
        jnp.asarray(pts), {k: jnp.asarray(v) for k, v in per_ray.items()},
        jnp.asarray(weights["b1"]),
        {k: None if v is None else jnp.asarray(v) for k, v in weights.items()},
        jnp.asarray(g), S=S, T=2,
        compute_dtype=jnp.bfloat16 if compute_dtype else jnp.float32,
        acts=jacts))
    for k in PER_RAY_GRADS:
        assert got[k].shape == want[k].shape, k
        if compute_dtype is None:
            np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL,
                                       rtol=0, err_msg=k)
        else:
            assert rel_rms(got[k], want[k]) <= BF16_REL_RMS, k


def test_frozen_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    pts, per_ray, weights, g = _trunk_inputs("bfloat16", True, 4, 8, 6)
    tw = {k: None if v is None else t(v) for k, v in weights.items()}
    tr = {k: t(v) for k, v in per_ray.items()}
    before = (trunk_backward.launches_recompute,
              trunk_backward.launches_stored)
    got = trunk_backward(t(pts), tr, tw["b1"], tw, t(g),
                         compute_dtype=torch.bfloat16, need_dw=False)
    want = trunk_backward_plain(t(pts), tr, tw["b1"], tw, t(g),
                                compute_dtype=torch.bfloat16, need_dw=False)
    assert got[2] is None and got[3] is None
    for k, v in _ray_grads(*want[:2]).items():
        np.testing.assert_array_equal(_ray_grads(*got[:2])[k], v, err_msg=k)
    assert (trunk_backward.launches_recompute,
            trunk_backward.launches_stored) == before


def _function_grads(compute_dtype, hybrid, freeze, monkeypatch, seed=11,
                    R=5, S=8):
    """Grads of pts, dir_enc and the codes through ``train_codenerf`` and
    the model's .grad, with the model ``frozen`` or not, and the
    ``need_dw`` each backward call was given."""
    jcfg, tcfg = configs(compute_dtype)
    _, model = jax_and_port_models(jcfg, tcfg, seed=seed)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (R, S, 3)).astype(np.float32)
    dirs = rng.normal(size=(R, jcfg.dim_dir)).astype(np.float32)
    zs = rng.normal(size=(R, jcfg.shape_code_size)).astype(np.float32)
    zt = rng.normal(size=(R, jcfg.texture_code_size)).astype(np.float32)
    wgt = rng.normal(size=(R, S, 4)).astype(np.float32)
    calls = []
    real = fused.trunk_backward

    def spy(*args, **kwargs):
        calls.append(kwargs["need_dw"])
        return real(*args, **kwargs)

    monkeypatch.setattr(fused, "trunk_backward", spy)
    ins = [t(a).requires_grad_() for a in (pts, dirs, zs, zt)]
    ctx = frozen({"m": model}) if freeze else torch.enable_grad()
    with ctx:
        raw = train_codenerf(model, *ins,
                             num_freq_xyz=jcfg.num_encoding_fn_xyz,
                             log_sampling_xyz=True, hybrid=hybrid)
        (raw * t(wgt)).sum().backward()
    monkeypatch.setattr(fused, "trunk_backward", real)
    grads = {n: a.grad.numpy() for n, a in
             zip(("pts", "dir_enc", "z_s", "z_t"), ins)}
    params = {n: p.grad for n, p in model.named_parameters()}
    return grads, params, calls


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["fused", "hybrid"])
def test_functions_under_frozen_skip_the_weight_grads(compute_dtype, hybrid,
                                                      monkeypatch):
    got, params, calls = _function_grads(compute_dtype, hybrid, True,
                                         monkeypatch)
    want, want_params, want_calls = _function_grads(compute_dtype, hybrid,
                                                    False, monkeypatch)
    assert calls == [False] and want_calls == [True]
    # the frozen model gets no grads; the trainable one gets every one
    assert all(g is None for g in params.values())
    assert all(g is not None for g in want_params.values())
    # the code and point grads (the pose's, through pts) are the same
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
