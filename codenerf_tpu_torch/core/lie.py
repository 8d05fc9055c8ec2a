"""SO(3) / SE(3) exponential and logarithm maps (counterpart of
``codenerf_tpu/core/lie.py``; reference view_synthesis/utils/
lieutils.py:453-743).

The stable formulas are written once with guarded ``where`` branches and
differentiated by autograd.  Every function works over leading batch
dimensions ``[...]``, which takes the place of JAX's ``vmap``.  Two
reference bugs stay fixed, as in JAX: the ``torh.sign`` typo in the
SO3.Log small-angle branch (lieutils.py:553) and the wrong entry of
SE3.hat (lieutils.py:644).

``torch.where`` passes the unselected branch's gradient through as
``jnp.where`` does (zero times its local derivative, so a NaN or an
infinity there poisons the sum).  Each transcendental therefore gets a
sanitized argument (the "double where" of ``_sinc_coeffs``): the SE(3)
refine step differentiates ``se3_exp`` at xi = 0 on its first step.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8
# Below this angle (radians) Taylor series replace the closed forms.
_SMALL = 1e-4
# Branch threshold for the sinc-family coefficients, in theta^2: they
# divide quantities like (1 - cos theta) by theta^2, which cancels
# catastrophically in f32 near 0 (at theta = 1e-3 the closed form of B
# carries ~10% noise).  theta < 0.05 takes the Taylor heads, whose
# truncation error is below f32 resolution there.
_SINC_SMALL_SQ = 2.5e-3


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat: [..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    w1, w2, w3 = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(w1)
    return torch.stack([torch.stack([zero, -w3, w2], dim=-1),
                        torch.stack([w3, zero, -w1], dim=-1),
                        torch.stack([-w2, w1, zero], dim=-1)], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of ``hat``: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """A = sin(t)/t, B = (1-cos(t))/t^2, C = (1 - A)/t^2 with Taylor
    guards.  All three are even in theta, so writing them in theta^2 keeps
    their gradients finite at 0: the closed forms see theta^2 = 1 where
    the Taylor head is taken."""
    small = theta_sq < _SINC_SMALL_SQ
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    A = torch.where(small, 1.0 - theta_sq / 6.0 + theta_sq ** 2 / 120.0,
                    torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0 + theta_sq ** 2 / 720.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    C = torch.where(small,
                    1.0 / 6.0 - theta_sq / 120.0 + theta_sq ** 2 / 5040.0,
                    (1.0 - torch.sin(theta) / theta) / safe_sq)
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    A, B, _ = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return (_eye3(w) + A[..., None, None] * W
            + B[..., None, None] * (W @ W))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3].  Stable for theta in
    [0, pi]: below ``_SMALL`` a Taylor branch, within 1e-3 of pi the axis
    from the symmetric part (the antisymmetric part vanishes there)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    # w_vec = vee(R - R^T) = 2 sin(theta) * axis
    w_vec = vee(R - R.transpose(-1, -2))

    small = theta < _SMALL
    near_pi = theta > math.pi - 1e-3

    # generic: theta / (2 sin theta) * vee(R - R^T)
    safe_sin = torch.where(small | near_pi, torch.ones_like(theta),
                           torch.sin(theta))
    generic = (theta / (2.0 * safe_sin))[..., None] * w_vec
    # small angle: 0.5 * (1 + theta^2 / 6) * vee(R - R^T)
    small_branch = 0.5 * (1.0 + theta[..., None] ** 2 / 6.0) * w_vec
    # near pi: (R + R^T)/2 = cos I + (1 - cos) a a^T
    sym = 0.5 * (R + R.transpose(-1, -2))
    one_minus_cos = torch.where(near_pi, 1.0 - cos_theta,
                                torch.ones_like(theta))
    aaT = ((sym - cos_theta[..., None, None] * _eye3(R))
           / one_minus_cos[..., None, None])
    axis_abs = torch.sqrt(torch.clamp(torch.diagonal(aaT, dim1=-2, dim2=-1),
                                      0.0, 1.0))
    # signs from the column of a a^T at its largest diagonal entry
    idx = torch.argmax(axis_abs, dim=-1, keepdim=True)          # [..., 1]
    col = torch.gather(aaT, -1, idx[..., None, :].expand(
        *aaT.shape[:-1], 1))[..., 0]
    denom = torch.gather(axis_abs, -1, idx)
    denom = torch.where(denom < _EPS, torch.ones_like(denom), denom)
    axis = col / denom
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.where(norm < _EPS, torch.ones_like(norm), norm)
    pi_branch = theta[..., None] * axis

    return torch.where(small[..., None], small_branch,
                       torch.where(near_pi[..., None], pi_branch, generic))


def _V_matrix(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V(w) = I + B W + C W^2, used by ``se3_exp``."""
    _, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return (_eye3(w) + B[..., None, None] * W
            + C[..., None, None] * (W @ W))


def _V_inv_matrix(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian V^-1 = I - W/2 + D W^2 with
    D = (1 - A/(2B)) / theta^2 (Taylor 1/12 + theta^2/720 at 0)."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    small = theta_sq < _SINC_SMALL_SQ
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    D = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - A / (2.0 * B)) / safe_sq)
    W = hat(w)
    return _eye3(w) - 0.5 * W + D[..., None, None] * (W @ W)


def inv_vecs_Xg_ig(w: torch.Tensor) -> torch.Tensor:
    """The inverse left SO(3) Jacobian under the reference's name
    (lieutils.py:569-582): ``_V_inv_matrix``."""
    return _V_inv_matrix(w)


def _se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] from a rotation [..., 3, 3] and a translation [..., 3]."""
    top = torch.cat([R, t[..., None]], dim=-1)                  # [..., 3, 4]
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [..., 6] in (v, w) order -> SE(3) matrix [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    t = (_V_matrix(w) @ v[..., None])[..., 0]
    return _se3_matrix(so3_exp(w), t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) matrix [..., 4, 4] -> twist [..., 6] in (v, w) order."""
    w = so3_log(T[..., :3, :3])
    v = (_V_inv_matrix(w) @ T[..., :3, 3, None])[..., 0]
    return torch.cat([v, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of an SE(3) matrix without a general solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _se3_matrix(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def pose_error(pose_gt: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """|| log(inv(pose_gt) @ pose) ||_2 over leading dimensions — the
    reference's pose-error metric (eval.py:161-162)."""
    rel = se3_inverse(pose_gt) @ pose
    return torch.linalg.norm(se3_log(rel), dim=-1)
