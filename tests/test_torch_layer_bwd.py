"""Port parity for K4's plain version and the ray-structured training
Functions: ``codenerf_tpu_torch.ops.layer_bwd.linear_relu_bwd_plain``
against the JAX Pallas kernel ``linear_relu_bwd_pallas`` in interpret
mode, and ``_DotAddRelu``, ``_DotAddReluPL`` and ``_FcOutTail`` against
JAX's custom VJPs.

Tolerances: f32 rtol = atol = 1e-5 (the two sum in different orders);
bf16 dx at relRMS <= 1e-2 (one bf16 ulp is 2^-8 relative), dw and db,
which both keep in f32, at the f32 tolerance.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.models import ray_structured as jrs
from codenerf_tpu.ops import layer_bwd as jlb
from codenerf_tpu_torch.models import ray_structured as rs
from codenerf_tpu_torch.ops import layer_bwd
from codenerf_tpu_torch.ops.layer_bwd import (linear_relu_bwd,
                                              linear_relu_bwd_plain)
from tests.torch_port_helpers import BF16_REL_RMS, rel_rms, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Run pallas_call in interpreter mode on the CPU."""
    orig = jlb.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jlb.pl, "pallas_call", interp)


def _inputs(shape, K, N, per_ray, dtype, seed):
    """x [*shape, K], w [K, N] f32, b ([N] or per-ray [R, 1, N], f32), y =
    relu of a draw (about half the mask live) and g, x / y / g in
    ``dtype``, as numpy f32 arrays."""
    rng = np.random.default_rng(seed)

    def cast(a):
        return np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))

    x = cast(rng.normal(size=(*shape, K)))
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(size=(shape[0], 1, N) if per_ray else (N,)).astype(
        np.float32)
    y = cast(np.maximum(rng.normal(size=(*shape, N)), 0.0))
    g = cast(rng.normal(size=(*shape, N)))
    return x, w, b, y, g


def _compare(got, want, bf16):
    (dx, dw, db), (jdx, jdw, jdb) = got, want
    assert dw.dtype == db.dtype == torch.float32
    if bf16:
        assert dx.dtype == torch.bfloat16
        assert rel_rms(dx.float(), np.asarray(jdx, np.float32)) <= BF16_REL_RMS
    else:
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=F32_TOL,
                                   atol=F32_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("shape,K,N,tile_rows", [
    ((6, 8), 32, 16, 8192),          # one tile
    ((6, 8), 16, 48, 16),            # three tiles of two rays
    ((10, 12), 48, 32, 24),          # five tiles of two rays, S = 12
])
def test_plain_matches_pallas(shape, K, N, tile_rows, per_ray, bf16):
    x, w, b, y, g = _inputs(shape, K, N, per_ray,
                            jnp.bfloat16 if bf16 else jnp.float32,
                            seed=K + N + per_ray)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                            torch.float32)
    cd_j, cd_t = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = jlb.linear_relu_bwd_pallas(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(y, jdt), jnp.asarray(g, jdt), cd_j,
        tile_rows=tile_rows, vmem_limit=None)
    got = linear_relu_bwd_plain(t(x).to(tdt), t(w), t(b), t(y).to(tdt),
                                t(g).to(tdt), cd_t)
    assert got[2].shape == b.shape
    _compare(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_plain_matches_pallas_2d_input(bf16):
    """x [M, K] with a bias, as the per-ray code layers call it."""
    x, w, b, y, g = _inputs((40,), 32, 16, False,
                            jnp.bfloat16 if bf16 else jnp.float32, seed=7)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                            torch.float32)
    cd_j, cd_t = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = jlb.linear_relu_bwd_pallas(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
        jnp.asarray(y, jdt), jnp.asarray(g, jdt), cd_j, tile_rows=16,
        vmem_limit=None)
    got = linear_relu_bwd_plain(t(x).to(tdt), t(w), t(b), t(y).to(tdt),
                                t(g).to(tdt), cd_t)
    _compare(got, want, bf16)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    x, w, b, y, g = _inputs((4, 8), 16, 32, True, jnp.bfloat16, seed=3)
    args = (t(x).bfloat16(), t(w), t(b), t(y).bfloat16(), t(g).bfloat16(),
            torch.bfloat16)
    before = linear_relu_bwd.launches
    for a, e in zip(linear_relu_bwd(*args), linear_relu_bwd_plain(*args)):
        assert torch.equal(a, e)
    assert linear_relu_bwd.launches == before
    with pytest.raises(ValueError, match="no K4"):
        linear_relu_bwd(*(a.to("meta") if isinstance(a, torch.Tensor)
                          else a for a in args))


@pytest.mark.parametrize("w_shape,b_shape,match", [
    ((16, 8192), (8192,), "shared memory"),
    ((16, 32), (5, 32), r"\[N\] or \[R, 1, N\]"),
    ((16, 32), (3, 1, 32), r"per-ray b must be \[R, 1, N\]"),
])
def test_kernel_refuses_shapes_it_does_not_take(w_shape, b_shape, match):
    """K4's wrapper names the shape it refuses before it touches the
    card."""
    K, N = w_shape
    x = torch.zeros(4, 8, K, dtype=torch.bfloat16)
    y = g = torch.zeros(4, 8, N, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        layer_bwd._layer_bwd_cuda(x, torch.zeros(w_shape), torch.zeros(
            b_shape), y, g, torch.bfloat16)


# ---- the training Functions against JAX's custom VJPs ----

def _vjp_pair(jop, top, x, w, b, g, cd):
    """Grads of sum(op(x, w, b) * g) in both packages: (port, JAX)."""
    jcd = None if cd is None else jnp.bfloat16
    tcd = None if cd is None else torch.bfloat16
    jdt = jnp.float32 if cd is None else jnp.bfloat16

    def jloss(x_, w_, b_):
        return jnp.sum(jop(x_, w_, b_, jcd).astype(jnp.float32)
                       * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b))
    tx = t(x).to(tcd or torch.float32).requires_grad_()
    tw, tb = t(w).requires_grad_(), t(b).requires_grad_()
    out = top(tx, tw, tb, tcd)
    (out.float() * t(g)).sum().backward()
    return (tx.grad, tw.grad, tb.grad), want


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("pl", [False, True])
def test_dot_add_relu_grads_match_jax(pl, per_ray, cd):
    rng = np.random.default_rng(11 + per_ray)
    x = rng.normal(size=(5, 8, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 16)) / 6).astype(np.float32)
    b = rng.normal(size=(5, 1, 16) if per_ray else (16,)).astype(np.float32)
    g = rng.normal(size=(5, 8, 16)).astype(np.float32)
    jop = jrs._dot_add_relu_pl if pl else jrs._dot_add_relu
    top = (rs._DotAddReluPL if pl else rs._DotAddRelu).apply
    got, want = _vjp_pair(jop, top, x, w, b, g, cd)
    for name, a, e in zip(("dx", "dw", "db"), got, want):
        e = np.asarray(e, np.float32)
        if cd is None or name != "dx":
            np.testing.assert_allclose(a.float().numpy(), e, rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=name)
        else:
            assert rel_rms(a.float(), e) <= BF16_REL_RMS, name


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_fc_out_tail_grads_match_jax(cd):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(5, 8, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 17)) / 6).astype(np.float32)
    b = rng.normal(size=(5, 17)).astype(np.float32)
    g = rng.normal(size=(5, 8, 17)).astype(np.float32)
    got, want = _vjp_pair(jrs._fc_out_tail, rs._FcOutTail.apply, x, w, b, g,
                          cd)
    for name, a, e in zip(("dx", "dw", "db"), got, want):
        e = np.asarray(e, np.float32)
        if cd is None or name != "dx":
            np.testing.assert_allclose(a.float().numpy(), e, rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=name)
        else:
            assert rel_rms(a.float(), e) <= BF16_REL_RMS, name


def test_plain_autograd_rounds_the_bias_sum():
    """The fault ``_DotAddRelu`` repairs: plain autograd through
    ``relu(mm + b.to(cd))`` sums the bias grad in bf16, far outside the
    f32 tolerance ``_DotAddRelu`` meets against JAX."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(6, 12, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 16)) / 6).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    g = rng.normal(size=(6, 12, 16)).astype(np.float32)

    def plain(x_, w_, b_, cd):
        y = (x_.to(cd).float() @ w_.to(cd).float()).to(cd)
        return torch.relu(y + b_.to(cd))

    fixed, want = _vjp_pair(jrs._dot_add_relu, rs._DotAddRelu.apply, x, w, b,
                            g, "bfloat16")
    rounded, _ = _vjp_pair(jrs._dot_add_relu, plain, x, w, b, g, "bfloat16")
    jdb = np.asarray(want[2])
    np.testing.assert_allclose(fixed[2].numpy(), jdb, rtol=F32_TOL,
                               atol=F32_TOL)
    assert not np.allclose(rounded[2].numpy(), jdb, rtol=F32_TOL,
                           atol=F32_TOL)
    # the rounding is bf16's: within 2^-8 relative
    assert rel_rms(rounded[2].numpy(), jdb) <= 2.0 ** -8
    assert rounded[2].dtype == fixed[2].dtype == torch.float32
