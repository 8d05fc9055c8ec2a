"""Camera and ray geometry (counterpart of ``codenerf_tpu/core/geometry.py``).

Convention as in the reference (ray_sampler.py:44-51): x right, y up, the
camera looks down -z.
"""

from __future__ import annotations

import torch


def pixel_directions(height: int, width: int,
                     intrinsic: torch.Tensor) -> torch.Tensor:
    """Camera-frame ray directions [H, W, 3] (unnormalized).  ``intrinsic``
    is 4x4 with focal [0,0] and cx/cy at [0,2]/[1,2]."""
    focal, cx, cy = intrinsic[0, 0], intrinsic[0, 2], intrinsic[1, 2]
    kw = dict(dtype=intrinsic.dtype, device=intrinsic.device)
    jj, ii = torch.meshgrid(torch.arange(height, **kw),
                            torch.arange(width, **kw), indexing="ij")
    return torch.stack([(ii - cx) / focal, -(jj - cy) / focal,
                        -torch.ones_like(ii)], dim=-1)


def ray_bundle(directions: torch.Tensor, pose_c2w: torch.Tensor):
    """World-frame (ro, rd), each [B, H, W, 3], for poses [B, 4, 4]:
    rd[b] = R_b @ dir, ro[b] = t_b broadcast (ray_sampler.py:84-99)."""
    rot = pose_c2w[..., :3, :3]
    rd = torch.einsum("hwi,bji->bhwj", directions, rot)
    ro = pose_c2w[..., :3, 3][:, None, None, :].expand(rd.shape)
    return ro, rd


def ndc_rays(ro: torch.Tensor, rd: torch.Tensor, height: float,
             width: float, focal: float, near: float = 1.0):
    """(ro_ndc, rd_ndc), each [..., 3]: the rays moved to the near plane
    z = -near and mapped to normalized device coordinates, the standard
    NeRF parametrization of forward-facing (LLFF) scenes (JAX
    ``ndc_rays``).  The ray parameter t in ro_ndc + t rd_ndc spans [0, 1]
    from the near plane to infinity, so callers sample t linearly in
    [0, 1].  Differentiable in ro and rd, so pose gradients flow through
    it."""
    t = -(near + ro[..., 2]) / rd[..., 2]
    ro = ro + t[..., None] * rd
    ox, oy, oz = ro.unbind(-1)
    dx, dy, dz = rd.unbind(-1)
    sx = -2.0 * focal / width
    sy = -2.0 * focal / height
    o = torch.stack([sx * ox / oz, sy * oy / oz, 1.0 + 2.0 * near / oz],
                    dim=-1)
    d = torch.stack([sx * (dx / dz - ox / oz), sy * (dy / dz - oy / oz),
                     -2.0 * near / oz], dim=-1)
    return o, d


def pose_spherical(theta, phi, rho, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """Camera-to-world poses on a sphere looking at the origin, in the
    reference's matrix layout (eval.py:33-38), differentiable in theta,
    phi and rho.  Scalars give [4, 4]; tensors broadcast to one leading
    shape [...] and give [..., 4, 4] (JAX ``vmap(pose_spherical)``).
    ``device`` defaults to the first tensor argument's."""
    if device is None:
        device = next((v.device for v in (theta, phi, rho)
                       if torch.is_tensor(v)), None)
    theta, phi, rho = torch.broadcast_tensors(*(
        torch.as_tensor(v, dtype=dtype, device=device)
        for v in (theta, phi, rho)))
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    zero, one = torch.zeros_like(st), torch.ones_like(st)
    c0 = torch.stack([-sp, cp, zero, zero], dim=-1)
    c1 = torch.stack([-st * cp, -st * sp, ct, zero], dim=-1)
    c2 = torch.stack([ct * cp, ct * sp, st, zero], dim=-1)
    c3 = torch.stack([rho * ct * cp, rho * ct * sp, rho * st, one], dim=-1)
    return torch.stack([c0, c1, c2, c3], dim=-1)


def select_ray_indices(generator: torch.Generator, num_pixels: int,
                       sample_size: int, batch_size: int) -> torch.Tensor:
    """``sample_size`` distinct pixel indices per batch element, [B, n]
    int64, drawn on the generator's device (JAX ``select_ray_indices``;
    reference ray_sampler.py:71-75)."""
    assert 0 < sample_size <= num_pixels, (
        f"sample_size ({sample_size}) must be in (0, num_pixels="
        f"{num_pixels}]; reduce nerf.ray_sampler.num_random_rays or use "
        f"larger images")
    return torch.stack([
        torch.randperm(num_pixels, generator=generator,
                       device=generator.device)[:sample_size]
        for _ in range(batch_size)])
