"""Coarse and inverse-CDF point sampling along rays (counterpart of
``codenerf_tpu/ops/sampling.py``; reference point_sampler.py:7-120).

The reference's ``spacing_mode`` labels are inverted with respect to the
usual NeRF convention, and kept so on purpose (point_sampler.py:40-43):

  * ``"lindisp"``  is linear in *depth*:      z = near (1-t) + far t
  * ``"lindepth"`` is linear in *disparity*:  z = 1 / (1/near (1-t) + 1/far t)

Depths carry no gradient (the reference detaches them; JAX
``stop_gradient``).  With ``perturb`` the coarse depths are jittered within
their stratification bins and the inverse CDF is taken at uniform random
u; the draws are passed in (``t_rand``, ``u``: the port's
``pipeline.draw_train_randoms``, or JAX's in a test).
"""

from __future__ import annotations

import torch


def base_z_vals(num_samples: int, near: float, far: float,
                spacing_mode: str, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """The deterministic per-ray depth grid [S] (point_sampler.py:33-43)."""
    t = torch.linspace(0.0, 1.0, num_samples, dtype=dtype, device=device)
    if spacing_mode == "lindisp":
        return near * (1.0 - t) + far * t
    return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)


def stratified_bins(z_vals):
    """Lower/upper stratification bin edges (point_sampler.py:45-47)."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    return lower, upper


def _uniform(given, like, name):
    if given is None:
        raise ValueError(f"perturb=True needs the draws {name}")
    return given.to(dtype=like.dtype, device=like.device)


def sample_stratified(ro, rd, z_vals, perturb: bool = False, t_rand=None):
    """Coarse samples (point_sampler.py:49-71): ro, rd [R, 3] and z_vals
    [S] -> pts [R, S, 3], z [R, S].  With ``perturb`` each depth is
    uniform in its bin, from the uniform draws ``t_rand`` [R, S]."""
    num_rays, num_samples = ro.shape[-2], z_vals.shape[-1]
    if perturb:
        lower, upper = stratified_bins(z_vals)
        t = _uniform(t_rand, ro, "t_rand")
        z = lower + (upper - lower) * t
    else:
        z = z_vals.expand(num_rays, num_samples)
    z = z.detach()
    pts = ro[..., None, :] + rd[..., None, :] * z[..., :, None]
    return pts, z


# The CDF is summed in the order XLA sums it on the CPU, so that the port
# selects the JAX reference's fine depths: one ulp in the CDF can flip the
# inversion's clamp to the last bin or its ``denom < 1e-5`` rule and move a
# depth by a whole bin.  torch's own sum and cumsum use other orders (f64
# accumulation on the CPU, parallel trees on CUDA).  Both helpers are
# chains of elementwise adds, so they give the same bits on every device.


def _ordered_sum(x):
    """Sum over the last axis, left to right in f32 (``jnp.sum`` on the
    CPU for the <= 30 terms of the flagship's interior weights)."""
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return total[..., None]


def _prefix_sum(x, block: int = 16):
    """Inclusive prefix sum over the last axis as ``jnp.cumsum`` computes
    it on the CPU: left to right within blocks of 16, each block offset by
    the previous block's last sum."""
    n = x.shape[-1]
    nb = -(-n // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - n)).unflatten(
        -1, (nb, block))
    cols = [xb[..., 0]]
    for i in range(1, block):
        cols.append(cols[-1] + xb[..., i])
    within = torch.stack(cols, dim=-1)                      # [..., nb, block]
    out = [within[..., 0, :]]
    for b in range(1, nb):
        out.append(out[-1][..., -1:] + within[..., b, :])
    return torch.cat(out, dim=-1)[..., :n]


@torch.no_grad()
def _pdf_depths(weights, z_vals, num_fine, u=None):
    num_coarse = z_vals.shape[-1]
    if weights.shape[-1] != num_coarse - 2:
        raise ValueError(
            f"weights last dim {weights.shape[-1]} must equal num_coarse-2 "
            f"({num_coarse - 2}); pass the interior slice weights[..., 1:-1]")
    bins = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])          # [R, S-1]
    w = weights + 1e-5
    pdf = w / _ordered_sum(w)
    cdf = _prefix_sum(pdf)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, num_fine, dtype=weights.dtype,
                           device=weights.device).expand(
                               cdf.shape[:-1] + (num_fine,))
    u = u.contiguous()
    # right-bracket inversion: above = first j with cdf[j] > u, clamped to
    # the last bin; below = the entry before it (cdf[0] = 0 <= u always)
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = above - 1
    above = above.clamp(max=cdf.shape[-1] - 1)
    cdf_below, cdf_above = cdf.gather(-1, below), cdf.gather(-1, above)
    bins_below, bins_above = bins.gather(-1, below), bins.gather(-1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    samples = bins_below + t * (bins_above - bins_below)
    return torch.sort(torch.cat([z_vals, samples], dim=-1), dim=-1).values


def sample_pdf(ro, rd, weights, z_vals, num_fine: int, perturb: bool = False,
               u=None):
    """Hierarchical importance resampling by CDF inversion
    (point_sampler.py:73-120): at evenly spaced u, or with ``perturb`` at
    the uniform draws ``u`` [R, num_fine].

    weights: [R, S-2] interior coarse compositing weights (the caller
    passes ``weights[..., 1:-1]``, reference nerf/__init__.py:87);
    z_vals: [R, S] coarse depths.  Returns pts [R, S+num_fine, 3] and the
    sorted union of coarse and fine depths [R, S+num_fine].
    """
    if perturb:
        u = _uniform(u, weights, "u")
    else:
        u = None
    z_union = _pdf_depths(weights, z_vals, num_fine, u)
    pts = ro[..., None, :] + rd[..., None, :] * z_union[..., :, None]
    return pts, z_union
