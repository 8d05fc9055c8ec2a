"""Port parity for ``core/lie.py`` and the batched ``pose_spherical``:
every Lie function of codenerf_tpu_torch on seeded numpy inputs against
the JAX package's, over leading batch dimensions (JAX under ``vmap``
where its function is unbatched), at generic angles, in the Taylor
branch (theta < 0.05, theta = 1e-3, theta = 0) and near pi.

Tolerances: f32 atol 1e-5 on matrices, twists and gradients (the two
evaluate the same formulas in the same order; near pi the axis recovery
divides by 1 - cos theta ~ 2, so it stays well conditioned).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.core import lie as jlie
from codenerf_tpu.core.geometry import pose_spherical as j_pose
from codenerf_tpu_torch.core import lie, pose_spherical
from tests.torch_port_helpers import F32_ATOL, t


def _axis_angles(rng, n, angles):
    """n random unit axes scaled to ``angles`` [n]."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return (axes * np.asarray(angles)[:, None]).astype(np.float32)


def _twists(rng, angles):
    w = _axis_angles(rng, len(angles), angles)
    v = rng.normal(size=(len(angles), 3)).astype(np.float32)
    return np.concatenate([v, w], axis=-1)


# generic, Taylor branch (< 0.05), 1e-3, 0, and near pi
ANGLES = {
    "generic": [0.3, 1.0, 2.0, 2.9],
    "taylor": [0.049, 0.02, 1e-3, 1e-5],
    "zero": [0.0, 0.0],
    "near_pi": [np.pi - 5e-4, np.pi - 1e-4, np.pi],
}


def close(got, want, atol=F32_ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(
        got) else got), np.asarray(want), atol=atol, rtol=0)


def test_hat_and_vee():
    w = np.random.default_rng(0).normal(size=(2, 5, 3)).astype(np.float32)
    close(lie.hat(t(w)), jlie.hat(jnp.asarray(w)))
    close(lie.vee(lie.hat(t(w))), w)
    close(lie.vee(t(np.asarray(jlie.hat(jnp.asarray(w))))),
          jlie.vee(jlie.hat(jnp.asarray(w))))


@pytest.mark.parametrize("branch", ["generic", "taylor", "zero"])
def test_sinc_coeffs(branch):
    theta = np.asarray(ANGLES[branch], np.float32)
    got = lie._sinc_coeffs(t(theta ** 2))
    want = jlie._sinc_coeffs(jnp.asarray(theta ** 2))
    for g, w in zip(got, want):
        close(g, w, atol=1e-6)


@pytest.mark.parametrize("branch", ["generic", "taylor", "zero", "near_pi"])
def test_so3_exp_and_log(branch):
    rng = np.random.default_rng(1)
    w = _axis_angles(rng, len(ANGLES[branch]), ANGLES[branch])
    R = lie.so3_exp(t(w))
    jR = jlie.so3_exp(jnp.asarray(w))
    close(R, jR)
    # log on the same rotation matrices
    Rn = np.asarray(jR)
    close(lie.so3_log(t(Rn)), jlie.so3_log(jnp.asarray(Rn)))


@pytest.mark.parametrize("branch", ["generic", "taylor", "zero"])
def test_V_matrices_and_inv_vecs_Xg_ig(branch):
    rng = np.random.default_rng(2)
    w = _axis_angles(rng, len(ANGLES[branch]), ANGLES[branch])
    close(lie._V_matrix(t(w)), jlie._V_matrix(jnp.asarray(w)))
    close(lie._V_inv_matrix(t(w)), jlie._V_inv_matrix(jnp.asarray(w)))
    close(lie.inv_vecs_Xg_ig(t(w)), jlie.inv_vecs_Xg_ig(jnp.asarray(w)))
    # V^-1 V = I
    close(lie._V_inv_matrix(t(w)) @ lie._V_matrix(t(w)),
          np.broadcast_to(np.eye(3), (len(w), 3, 3)))


@pytest.mark.parametrize("branch", ["generic", "taylor", "zero", "near_pi"])
def test_se3_exp_log_inverse(branch):
    rng = np.random.default_rng(3)
    xi = _twists(rng, ANGLES[branch]).reshape(-1, 1, 6)       # [n, 1, 6]
    T = lie.se3_exp(t(xi))
    jT = jax.vmap(jax.vmap(jlie.se3_exp))(jnp.asarray(xi))
    assert T.shape == (len(xi), 1, 4, 4)
    close(T, jT)
    Tn = np.asarray(jT)
    close(lie.se3_inverse(t(Tn)), jlie.se3_inverse(jnp.asarray(Tn)))
    close(lie.se3_inverse(t(Tn)) @ t(Tn),
          np.broadcast_to(np.eye(4), Tn.shape), atol=1e-5)
    close(lie.se3_log(t(Tn)), jlie.se3_log(jnp.asarray(Tn)))


def test_se3_exp_gradient_at_zero_is_finite_and_matches_jax():
    """The SE(3) refine step's first step differentiates se3_exp at
    xi = 0, inside the Taylor branch of _sinc_coeffs."""
    rng = np.random.default_rng(4)
    G = rng.normal(size=(3, 4, 4)).astype(np.float32)
    xi = torch.zeros(3, 6, requires_grad=True)
    (lie.se3_exp(xi) * t(G)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jax.vmap(jlie.se3_exp)(x)
                                      * jnp.asarray(G)))(jnp.zeros((3, 6)))
    assert bool(torch.isfinite(xi.grad).all())
    close(xi.grad, want)
    # and at a small nonzero twist (theta = 1e-3), inside the branch too
    x0 = _twists(rng, [1e-3, 0.02, 0.7])
    xt = t(x0).requires_grad_()
    (lie.se3_exp(xt) * t(G)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(jax.vmap(jlie.se3_exp)(x)
                                      * jnp.asarray(G)))(jnp.asarray(x0))
    close(xt.grad, want)


def test_pose_error_batched():
    rng = np.random.default_rng(5)
    gt = np.stack([np.asarray(j_pose(1.2 + 0.1 * i, 0.4 * i, 1.3))
                   for i in range(6)]).reshape(2, 3, 4, 4)
    xi = _twists(rng, [0.3, 1e-3, 0.0, 2.0, np.pi - 1e-4, 0.02]) * 0.5
    pert = np.asarray(jax.vmap(jlie.se3_exp)(jnp.asarray(xi)))
    pose = (pert @ gt.reshape(6, 4, 4)).reshape(2, 3, 4, 4)
    got = lie.pose_error(t(gt), t(pose))
    want = jax.vmap(jax.vmap(jlie.pose_error))(jnp.asarray(gt),
                                               jnp.asarray(pose))
    assert got.shape == (2, 3)
    close(got, want)
    # arccos at 1 turns an f32 ulp of the trace into ~5e-4 of angle
    close(lie.pose_error(t(gt), t(gt)), np.zeros((2, 3)), atol=1e-3)


@pytest.mark.parametrize("shape", [(), (4,), (2, 3)])
def test_pose_spherical_batched_and_its_gradient(shape):
    rng = np.random.default_rng(6)
    th, ph, rh = (rng.uniform(lo, hi, shape).astype(np.float32)
                  for lo, hi in ((0.2, 1.5), (-3, 3), (0.8, 2.0)))
    G = rng.normal(size=shape + (4, 4)).astype(np.float32)
    leaves = [t(a).requires_grad_() for a in (th, ph, rh)]
    P = pose_spherical(*leaves)
    assert P.shape == shape + (4, 4)
    (P * t(G)).sum().backward()

    fn = j_pose
    for _ in shape:
        fn = jax.vmap(fn)
    close(P, fn(*map(jnp.asarray, (th, ph, rh))))
    want = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * jnp.asarray(G)),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (th, ph, rh)))
    for leaf, w in zip(leaves, want):
        close(leaf.grad, w)


def test_pose_spherical_keeps_scalar_calls_and_broadcasts():
    one = pose_spherical(1.2, 0.3, 1.3)
    assert one.shape == (4, 4)
    close(one, j_pose(1.2, 0.3, 1.3))
    row = pose_spherical(torch.tensor([1.2, 1.2]), 0.3, 1.3)
    assert row.shape == (2, 4, 4)
    close(row[1], one)
