"""Ray-structured CodeNeRF forward (counterpart of
``codenerf_tpu/models/ray_structured.py``).

A concat matmul factors exactly, ``concat(a, b) @ W == a @ W_top +
b @ W_bottom``, so every layer that reads [per-sample | per-ray] input
splits into a per-sample product over [R, S, .] and a per-ray product over
[R, .] that is broadcast-added.  The cast points are the JAX XLA path's:
inputs are cast to the compute dtype, each product is the f32 sum of f32
products of compute-dtype values rounded back to the compute dtype, bias
and relu run in the compute dtype, and the radiance leaves in f32.
"""

from __future__ import annotations

import torch

from codenerf_tpu_torch.models.mlp import CodeNeRF


def _w(layer) -> torch.Tensor:
    """A Linear's weight in the JAX package's [in, out] layout (a view)."""
    return layer.weight.t()


class _DotLP(torch.autograd.Function):
    """x @ w with ``cd`` inputs, f32 accumulation and a ``cd`` result, and
    JAX ``_dot_lp``'s backward: dx = g_cd @ w_cd^T accumulated in f32 and
    cast to x's dtype, dw = x_cd^T @ g_cd accumulated in f32 and kept in
    w's dtype.  Plain autograd through the casts would round dw (and dx
    of an f32 x) to ``cd`` on the way back."""

    @staticmethod
    def forward(ctx, x, w, cd):
        ctx.save_for_backward(x, w)
        ctx.cd = cd
        return (x.to(cd).float() @ w.to(cd).float()).to(cd)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cd = ctx.cd
        gc = g.to(cd).float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (gc @ w.to(cd).float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (x.to(cd).float().reshape(-1, x.shape[-1]).t()
                  @ gc.reshape(-1, g.shape[-1])).to(w.dtype)
        return dx, dw, None


def _mm(x, w, cd):
    """x @ w with ``cd`` inputs, f32 accumulation and a ``cd`` result
    (JAX ``_dot_lp``, forward and backward); plain f32 when ``cd`` is
    None."""
    if cd is None:
        return x @ w
    return _DotLP.apply(x, w, cd)


def _lin(layer, x, cd, w=None):
    y = _mm(x, _w(layer) if w is None else w, cd)
    return y + layer.bias.to(y.dtype)


def per_ray_conditioning(model: CodeNeRF, dir_enc, z_s, z_t):
    """The per-ray halves of every factored concat layer.

    Returns (zs1_part [R, h], zs2_part [R, s+1], dir_part [R, h],
    zt1_part [R, 3]) in the compute dtype.
    """
    cfg = model.cfg
    cd = cfg.cdtype
    h = cfg.hidden_size
    if cd is not None:
        dir_enc, z_s, z_t = dir_enc.to(cd), z_s.to(cd), z_t.to(cd)
    zs1 = torch.relu(_lin(model.shape_code_layer1, z_s, cd))
    zs2 = torch.relu(_lin(model.shape_code_layer2, z_s, cd))
    zt1 = torch.relu(_lin(model.texture_code_layer1, z_t, cd))
    zs1_part = _lin(model.layer_xyz2, zs1, cd, _w(model.layer_xyz2)[h:])
    zs2_part = _lin(model.fc_out, zs2, cd, _w(model.fc_out)[h:])
    dir_part = _lin(model.layer_dir1, dir_enc, cd,
                    _w(model.layer_dir1)[cfg.shape_code_size:])
    zt1_part = _lin(model.fc_rgb, zt1, cd, _w(model.fc_rgb)[h:])
    return zs1_part, zs2_part, dir_part, zt1_part


def apply_codenerf_rays(model: CodeNeRF, xyz_enc, dir_enc, z_s, z_t):
    """raw [R, S, 4] (rgb logits, sigma logit) in f32 from xyz_enc
    [R, S, dim_xyz], dir_enc [R, dim_dir] and codes [R, C]."""
    cfg = model.cfg
    cd = cfg.cdtype
    h = cfg.hidden_size
    if cd is not None:
        xyz_enc = xyz_enc.to(cd)
    zs1_part, zs2_part, dir_part, zt1_part = per_ray_conditioning(
        model, dir_enc, z_s, z_t)

    x = torch.relu(_lin(model.layer_xyz1, xyz_enc, cd))
    x = torch.relu(_mm(x, _w(model.layer_xyz2)[:h], cd)
                   + zs1_part[:, None, :])
    out = _mm(x, _w(model.fc_out)[:h], cd) + zs2_part[:, None, :]
    sigma, feat = out[..., :1], out[..., 1:]
    v = torch.relu(_mm(feat, _w(model.layer_dir1)[:cfg.shape_code_size], cd)
                   + dir_part[:, None, :])
    v = torch.relu(_lin(model.layer_dir2, v, cd))
    rgb = _mm(v, _w(model.fc_rgb)[:h], cd) + zt1_part[:, None, :]
    return torch.cat([rgb, sigma], dim=-1).float()
