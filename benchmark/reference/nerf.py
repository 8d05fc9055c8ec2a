"""Plain float32 reference of what the benchmark's cells compute.

CodeNeRF (Jang & Agapito, ICCV 2021) and vanilla NeRF (Mildenhall et al.
2020) in the layer order of akashsharma02/code-nerf's ``model.py``, with
its sampler (``point_sampler.py``), compositing (``volumetric_render.py``)
and losses (``train.py``, ``eval.py``).  Parameters are a dict of tensors
under the reference's state-dict names (``layer_xyz1.weight`` [out, in],
...), so the benchmark can hand one set of weights to the program and to
this file.  Every concat layer is computed as a concat: nothing here is
factored, fused or cast.

``prec`` selects the products' precision: "f32" (TF32 off: the caller
sets ``torch.backends.cuda.matmul.allow_tf32 = False``) or "fp8", the
control, the step below the bfloat16 that the configurations state, in
the usual float8 training recipe: every product's operands rounded with
one scale per tensor (its amax to the format's largest value), float8
e4m3 for activations and weights in the forward, e5m2 for the incoming
gradient in both backward products.

Imports torch and the standard library only.
"""

from __future__ import annotations

import math

import torch


def fp8_round(t: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to the float8 format ``fmt`` under a per-tensor scale
    (amax to the format's largest value), as float32."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (t / scale).to(fmt).float() * scale


class Fp8Matmul(torch.autograd.Function):
    """x @ w^T with e4m3 operands; backward dx = g8 @ w8, dw = g8^T @ x8
    with the gradient g in e5m2."""

    @staticmethod
    def forward(ctx, x, w):
        x8, w8 = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(x8, w8)
        return x8 @ w8.t()

    @staticmethod
    def backward(ctx, g):
        x8, w8 = ctx.saved_tensors
        g8 = fp8_round(g, torch.float8_e5m2)
        return g8 @ w8, (g8.reshape(-1, g8.shape[-1]).t()
                         @ x8.reshape(-1, x8.shape[-1]))


def linear(p: dict, name: str, x: torch.Tensor, prec: str) -> torch.Tensor:
    w = p[f"{name}.weight"]
    if prec == "fp8":
        return Fp8Matmul.apply(x, w) + p[f"{name}.bias"]
    return x @ w.t() + p[f"{name}.bias"]


def relu_linear(p, name, x, prec):
    return torch.relu(linear(p, name, x, prec))


def encode(x: torch.Tensor, num_freq: int, include_input: bool = True
           ) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(F-1) x), cos(2^(F-1) x)]
    (position_embed.py, log sampling)."""
    parts = [x] if include_input else []
    for k in range(num_freq):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------- models

def codenerf_shapes(h: int, s: int, t: int, dim_xyz: int, dim_dir: int
                    ) -> dict:
    """{name: (fan_out, fan_in)} of CodeNeRF's linear layers
    (model.py:145-156)."""
    return {"layer_xyz1": (h, dim_xyz), "layer_xyz2": (h, h + s),
            "fc_out": (s + 1, h + s), "shape_code_layer1": (s, s),
            "shape_code_layer2": (s, s), "texture_code_layer1": (t, t),
            "layer_dir1": (h, s + dim_dir), "layer_dir2": (h, h),
            "fc_rgb": (3, h + t)}


def flexible_shapes(h: int, num_layers: int, skips, dim_xyz: int,
                    dim_dir: int) -> dict:
    """{name: (fan_out, fan_in)} of FlexibleNeRF with view directions
    (model.py:27-47)."""
    out = {"layer1": (h, dim_xyz)}
    for i in range(num_layers - 1):
        out[f"layers_xyz.{i}"] = (h, h + dim_xyz if i in skips else h)
    out.update({"fc_feat": (h, h), "layers_dir.0": (h // 2, h + dim_dir),
                "fc_alpha": (1, h), "fc_rgb": (3, h // 2)})
    return out


def codenerf(p: dict, xyz_enc, dir_enc, z_s, z_t, prec: str = "f32"):
    """raw [R, S, 4] (rgb logits, sigma logit) from xyz_enc [R, S, Dx],
    dir_enc [R, Dd] and per-ray codes [R, C] (model.py:158-194)."""
    S = xyz_enc.shape[1]

    def per_sample(a):
        return a[:, None, :].expand(-1, S, -1)

    zs1 = relu_linear(p, "shape_code_layer1", z_s, prec)
    zs2 = relu_linear(p, "shape_code_layer2", z_s, prec)
    zt1 = relu_linear(p, "texture_code_layer1", z_t, prec)
    x = relu_linear(p, "layer_xyz1", xyz_enc, prec)
    x = relu_linear(p, "layer_xyz2", torch.cat([x, per_sample(zs1)], -1),
                    prec)
    out = linear(p, "fc_out", torch.cat([x, per_sample(zs2)], -1), prec)
    sigma, feat = out[..., :1], out[..., 1:]
    v = relu_linear(p, "layer_dir1",
                    torch.cat([feat, per_sample(dir_enc)], -1), prec)
    v = relu_linear(p, "layer_dir2", v, prec)
    rgb = linear(p, "fc_rgb", torch.cat([v, per_sample(zt1)], -1), prec)
    return torch.cat([rgb, sigma], -1)


def flexible(p: dict, xyz_enc, dir_enc, skips, num_layers: int,
             prec: str = "f32"):
    """raw [R, S, 4] of FlexibleNeRF with view directions (model.py:49-76)."""
    S = xyz_enc.shape[1]
    out = relu_linear(p, "layer1", xyz_enc, prec)
    for i in range(num_layers - 1):
        inp = torch.cat([out, xyz_enc], -1) if i in skips else out
        out = relu_linear(p, f"layers_xyz.{i}", inp, prec)
    feat = relu_linear(p, "fc_feat", out, prec)
    alpha = linear(p, "fc_alpha", feat, prec)
    v = relu_linear(p, "layers_dir.0", torch.cat(
        [feat, dir_enc[:, None, :].expand(-1, S, -1)], -1), prec)
    rgb = linear(p, "fc_rgb", v, prec)
    return torch.cat([rgb, alpha], -1)


# ------------------------------------------------------------ geometry

def pixel_directions(h: int, w: int, focal: float, device) -> torch.Tensor:
    """Camera-frame directions [H*W, 3]: x right, y up, looking down -z
    (ray_sampler.py:44-51), pixel index j * W + i."""
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    d = torch.stack([(i - w / 2) / focal, -(j - h / 2) / focal,
                     -torch.ones_like(i)], -1)
    return d.reshape(-1, 3)


def pose_spherical(theta, phi, rho) -> torch.Tensor:
    """Camera-to-world [..., 4, 4] on a sphere of radius rho looking at the
    origin, elevation theta, azimuth phi (eval.py:33-38)."""
    st, ct, sp, cp = (torch.sin(theta), torch.cos(theta), torch.sin(phi),
                      torch.cos(phi))
    zero, one = torch.zeros_like(st), torch.ones_like(st)
    rows = [[-sp, -st * cp, ct * cp, rho * ct * cp],
            [cp, -st * sp, ct * sp, rho * ct * sp],
            [zero, ct, st, rho * st],
            [zero, zero, zero, one]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rays(dirs: torch.Tensor, pose: torch.Tensor, pix: torch.Tensor):
    """(ro, rd) [n, 3] of the pixels ``pix`` [n] of one camera pose
    [4, 4]."""
    rd = dirs[pix] @ pose[:3, :3].t()
    return pose[:3, 3].expand_as(rd), rd


# ------------------------------------------------------------- sampling

def depth_grid(n: int, near: float, far: float, device) -> torch.Tensor:
    """The reference's "lindepth" grid, linear in disparity."""
    t = torch.linspace(0.0, 1.0, n, device=device)
    return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)


def stratified(grid: torch.Tensor, t_rand: torch.Tensor) -> torch.Tensor:
    """Each depth uniform in its bin at the draws t_rand [R, S]."""
    mids = 0.5 * (grid[1:] + grid[:-1])
    upper = torch.cat([mids, grid[-1:]])
    lower = torch.cat([grid[:1], mids])
    return lower + (upper - lower) * t_rand


@torch.no_grad()
def importance(z: torch.Tensor, weights: torch.Tensor, u: torch.Tensor
               ) -> torch.Tensor:
    """Inverse-CDF samples at u [R, Nf] from the interior weights
    [R, S-2] over the bins between the depths z [R, S], merged with z and
    sorted (point_sampler.py:73-120)."""
    bins = 0.5 * (z[:, 1:] + z[:, :-1])
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    above = torch.searchsorted(cdf, u.contiguous(), right=True)
    below = above - 1
    above = above.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins.gather(1, below), bins.gather(1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    fine = b0 + (u - c0) / denom * (b1 - b0)
    return torch.sort(torch.cat([z, fine], -1), -1).values


def composite(raw: torch.Tensor, z: torch.Tensor, rd: torch.Tensor):
    """(rgb [R, 3], weights [R, S]): sigma = softplus(raw - 1), rgb =
    sigmoid widened by 1e-3 on each side, the last distance 1e10
    (volumetric_render.py)."""
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(rd, dim=-1, keepdim=True)
    sd = torch.nn.functional.softplus(raw[..., 3] - 1.0) * dists
    alpha = 1.0 - torch.exp(-sd)
    trans = torch.exp(-torch.cat([torch.zeros_like(sd[:, :1]),
                                  torch.cumsum(sd[:, :-1], -1)], -1))
    weights = alpha * trans
    rgb = torch.sigmoid(raw[..., :3]) * (1.0 + 2e-3) - 1e-3
    return (weights[..., None] * rgb).sum(1), weights


def render(model, ro, rd, draws: dict, near: float, far: float,
           num_coarse: int, noise_std: float, bands: int, dir_bands: int):
    """(rgb_coarse, rgb_fine) [R, 3] of the coarse -> importance -> fine
    render with stratified jitter (t_rand), inverse-CDF draws (u) and,
    with ``noise_std``, sigma noise (noise_c, noise_f)
    (nerf/__init__.py:74-134).  ``model(net, xyz_enc, dir_enc)`` is the
    network of ``net`` ("coarse" or "fine")."""
    grid = depth_grid(num_coarse, near, far, ro.device)
    z_c = stratified(grid, draws["t_rand"])
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dir_enc = encode(viewdirs, dir_bands)

    def field(net, z, noise_key):
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        raw = model(net, encode(pts, bands), dir_enc)
        if noise_std > 0:
            raw = torch.cat([raw[..., :3], raw[..., 3:]
                             + noise_std * draws[noise_key][..., None]], -1)
        return composite(raw, z, rd)

    rgb_c, w_c = field("coarse", z_c, "noise_c")
    z_f = importance(z_c, w_c[:, 1:-1].detach(), draws["u"])
    rgb_f, _ = field("fine", z_f, "noise_f")
    return rgb_c, rgb_f


def init_params(shapes: dict, generator: torch.Generator, device
                ) -> dict:
    """``nn.Linear``'s default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weight and bias, drawn in one call on ``device``."""
    total = sum(o * i + o for o, i in shapes.values())
    flat = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, (o, i) in shapes.items():
        bound = 1.0 / math.sqrt(i)
        out[f"{name}.weight"] = flat[at:at + o * i].view(o, i) * bound
        at += o * i
        out[f"{name}.bias"] = flat[at:at + o] * bound
        at += o
    return out
