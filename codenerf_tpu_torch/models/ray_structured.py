"""Ray-structured CodeNeRF and FlexibleNeRF forwards (counterpart of
``codenerf_tpu/models/ray_structured.py``).

A concat matmul factors exactly, ``concat(a, b) @ W == a @ W_top +
b @ W_bottom``, so every layer that reads [per-sample | per-ray] input
splits into a per-sample product over [R, S, .] and a per-ray product over
[R, .] that is broadcast-added.  The cast points are the JAX XLA path's:
inputs are cast to the compute dtype, each product is the f32 sum of the
exact products of compute-dtype values rounded back to the compute dtype
(``ops/products.py::_dot``: on the tensor cores for CUDA tensors), bias
and relu run in the compute dtype, and the radiance leaves in f32.

The training Functions are JAX's custom VJPs with their cast points:
``_DotLP`` (``_dot_lp``), ``_DotAddRelu`` (``_dot_add_relu``: the relu
mask from the stored output, weight and bias grads summed in f32; its
forward one kernel, ``ops/layer_fwd.py``, where the call fits it),
``_DotAddReluPL`` (``_dot_add_relu_pl``: the same, its backward K4,
``ops/layer_bwd.py``) and ``_FcOutTail`` (``_fc_out_tail``).
"""

from __future__ import annotations

import torch

from codenerf_tpu_torch.models.mlp import CodeNeRF, FlexibleNeRF
from codenerf_tpu_torch.ops import layer_bwd, layer_fwd
from codenerf_tpu_torch.ops.products import _dot, _dw, _mmc


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
        return _mmc(x, w, cd)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        cd = ctx.cd
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dot(g, w.to(cd).t(), cd, x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, g, cd).to(w.dtype)
        return dx, dw, None


def _mm(x, w, cd):
    """x @ w with ``cd`` inputs, f32 accumulation and a ``cd`` result
    (JAX ``_dot_lp``, forward and backward); plain f32 when ``cd`` is
    None."""
    if cd is None:
        return x @ w
    return _DotLP.apply(x, w, cd)


def _dar_backward(ctx, g, bwd):
    """(dx, dw, db) from ``bwd`` (a ``layer_bwd`` function), cast to the
    inputs' dtypes.  Reads the saved tensors once, as
    ``torch.utils.checkpoint`` requires."""
    x, w, b, y = ctx.saved_tensors
    dx, dw, db = bwd(x, w, b, y, g, ctx.cd)
    return dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype), None


class _DotAddRelu(torch.autograd.Function):
    """relu(x @ w + b) that saves only x, w, b and the output y (JAX
    ``_dot_add_relu``).  ``b`` is a bias [N] or per-ray rows [R, 1, N].
    The forward is one kernel (``layer_fwd.linear_relu_fwd``: the product
    with its round-bias-relu epilogue) for a call ``layer_fwd.fused_route``
    takes (CUDA tensors, a bf16 ``cd``, widths in the kernel's plan), else
    the product, bias add and relu of ``layer_fwd.linear_relu_fwd_plain``;
    ``routes`` counts the calls by route (``fused``, ``eager``).  The
    backward takes the relu mask from y > 0 and is
    ``layer_bwd.linear_relu_bwd_plain``: dx in x's dtype, dw and the bias
    sum in f32, cast to w's and b's dtypes.  Plain autograd through
    ``relu(mm + b.to(cd))`` would round the bias sum to ``cd``."""

    routes = {"fused": 0, "eager": 0}

    @staticmethod
    def forward(ctx, x, w, b, cd):
        fused = layer_fwd.fused_route(x, w, b, cd)
        _DotAddRelu.routes["fused" if fused else "eager"] += 1
        y = (layer_fwd.linear_relu_fwd if fused
             else layer_fwd.linear_relu_fwd_plain)(x, w, b, cd)
        ctx.save_for_backward(x, w, b, y)
        ctx.cd = cd
        return y

    @staticmethod
    def backward(ctx, g):
        return _dar_backward(ctx, g, layer_bwd.linear_relu_bwd_plain)


class _DotAddReluPL(_DotAddRelu):
    """``_DotAddRelu`` with its backward through ``layer_bwd.
    linear_relu_bwd``: K4 for CUDA tensors, the plain version for CPU
    tensors (JAX ``_dot_add_relu_pl``)."""

    @staticmethod
    def backward(ctx, g):
        return _dar_backward(ctx, g, layer_bwd.linear_relu_bwd)


class _FcOutTail(torch.autograd.Function):
    """fc_out with its columns in [feat | sigma] order: ``x @ w`` plus the
    per-ray rows ``b_rows`` [R, N] (JAX ``_fc_out_tail``).  The backward
    splits the cotangent at the last column: dx = g_feat @ w_feat^T +
    g_sigma w_sigma (a rank-1 term, in f32), dw and db as two column
    blocks, sums in f32."""

    @staticmethod
    def forward(ctx, x, w, b_rows, cd):
        ctx.save_for_backward(x, w, b_rows)
        ctx.cd = cd
        y = _mmc(x, w, cd)
        return y + b_rows[:, None, :].to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, b_rows = ctx.saved_tensors
        cd = ctx.cd
        ct = cd or torch.float32
        gc = g.to(ct)
        gf, gs = gc[..., :-1], gc[..., -1:]
        wc = w.to(ct)
        dxf = (gf.float() @ wc[:, :-1].float().t() if cd is None
               else _dot(gf, wc[:, :-1].contiguous().t(), cd))
        dx = (dxf + gs.float() * wc[:, -1].float()).to(x.dtype)
        xc = x.to(ct)
        dw = torch.cat([_dw(xc, gf, cd), _dw(xc, gs, cd)],
                       dim=1).to(w.dtype)
        db = torch.cat([gf.float().sum(dim=1), gs.float().sum(dim=1)],
                       dim=-1).to(b_rows.dtype)
        return dx, dw, db, None


def _lin(layer, x, cd, w=None):
    y = _mm(x, _w(layer) if w is None else w, cd)
    return y + layer.bias.to(y.dtype)


def _lin_relu(layer, x, cd):
    """relu(linear) through the single-residual ``_DotAddRelu``."""
    return _DotAddRelu.apply(x, _w(layer), layer.bias, cd)


def per_ray_conditioning(model: CodeNeRF, dir_enc, z_s, z_t, cfg=None):
    """The per-ray halves of every factored concat layer, under ``cfg``
    (default ``model.cfg``).

    Returns (zs1_part [R, h], zs2_part [R, s+1], dir_part [R, h],
    zt1_part [R, 3]) in the compute dtype.
    """
    cfg = cfg or model.cfg
    cd = cfg.cdtype
    h = cfg.hidden_size
    if cd is not None:
        dir_enc, z_s, z_t = dir_enc.to(cd), z_s.to(cd), z_t.to(cd)
    zs1 = _lin_relu(model.shape_code_layer1, z_s, cd)
    zs2 = _lin_relu(model.shape_code_layer2, z_s, cd)
    zt1 = _lin_relu(model.texture_code_layer1, z_t, cd)
    zs1_part = _lin(model.layer_xyz2, zs1, cd, _w(model.layer_xyz2)[h:])
    zs2_part = _lin(model.fc_out, zs2, cd, _w(model.fc_out)[h:])
    dir_part = _lin(model.layer_dir1, dir_enc, cd,
                    _w(model.layer_dir1)[cfg.shape_code_size:])
    zt1_part = _lin(model.fc_rgb, zt1, cd, _w(model.fc_rgb)[h:])
    return zs1_part, zs2_part, dir_part, zt1_part


def apply_codenerf_rays(model: CodeNeRF, xyz_enc, dir_enc, z_s, z_t,
                        cfg=None):
    """raw [R, S, 4] (rgb logits, sigma logit) in f32 from xyz_enc
    [R, S, dim_xyz], dir_enc [R, dim_dir] and codes [R, C], under ``cfg``
    (default ``model.cfg``; the pipeline passes its settings' model
    config, as JAX's ``_forward`` does), with JAX's branches
    (ray_structured.py:314-357): layer_xyz2, layer_dir1 and layer_dir2
    through ``_DotAddReluPL`` under ``pallas_layer_bwd``, else
    ``_DotAddRelu``; fc_out as separate sigma and feature products under
    ``pallas_layer_bwd`` or ``split_fc_out``, else ``_FcOutTail`` under
    ``fc_out_tail_sigma``, else one product and a slice."""
    cfg = cfg or model.cfg
    cd = cfg.cdtype
    h = cfg.hidden_size
    if cd is not None:
        xyz_enc = xyz_enc.to(cd)
    zs1_part, zs2_part, dir_part, zt1_part = per_ray_conditioning(
        model, dir_enc, z_s, z_t, cfg)
    w2_top = _w(model.layer_xyz2)[:h]
    wo_top = _w(model.fc_out)[:h]
    wd_top = _w(model.layer_dir1)[:cfg.shape_code_size]
    wr_top = _w(model.fc_rgb)[:h]
    dar = (_DotAddReluPL if cfg.pallas_layer_bwd else _DotAddRelu).apply

    # layer_xyz1 stays on _DotAddRelu under pallas_layer_bwd too, as in
    # JAX; its dx carries the pose gradient back to the samples in TTO
    x = _lin_relu(model.layer_xyz1, xyz_enc, cd)
    x = dar(x, w2_top, zs1_part[:, None, :], cd)
    if cfg.pallas_layer_bwd or cfg.split_fc_out:
        sigma = _mm(x, wo_top[:, :1], cd) + zs2_part[:, None, :1]
        feat = _mm(x, wo_top[:, 1:], cd) + zs2_part[:, None, 1:]
    elif cfg.fc_out_tail_sigma:
        wo_r = torch.cat([wo_top[:, 1:], wo_top[:, :1]], dim=1)
        zs2_r = torch.cat([zs2_part[:, 1:], zs2_part[:, :1]], dim=1)
        out = _FcOutTail.apply(x, wo_r, zs2_r, cd)
        feat, sigma = out[..., :-1], out[..., -1:]
    else:
        out = _mm(x, wo_top, cd) + zs2_part[:, None, :]
        sigma, feat = out[..., :1], out[..., 1:]
    v = dar(feat, wd_top, dir_part[:, None, :], cd)
    v = dar(v, _w(model.layer_dir2), model.layer_dir2.bias, cd)
    rgb = _mm(v, wr_top, cd) + zt1_part[:, None, :]
    return torch.cat([rgb, sigma], dim=-1).float()


def apply_flexible_rays(model: FlexibleNeRF, xyz_enc, dir_enc=None,
                        cfg=None):
    """raw [R, S, 4] in f32 from xyz_enc [R, S, dim_xyz] and dir_enc
    [R, dim_dir] (None without view directions), under ``cfg`` (default
    ``model.cfg``), with JAX's branches (ray_structured.py:360-399): the
    skip layer as two per-sample products ``out @ w_top + xyz_enc @
    w_bot`` (no concat); layer1 and the skip layer on plain autograd;
    every other trunk layer and fc_feat through ``_DotAddReluPL`` (K4,
    bias b) under ``pallas_layer_bwd``, else ``_DotAddRelu``; layer_dir1
    as ``feat @ w_top`` plus the per-ray rows ``dir_enc @ w_bot + b``
    through the same Function."""
    cfg = cfg or model.cfg
    cd = cfg.cdtype
    h = cfg.hidden_size
    if cd is not None:
        xyz_enc = xyz_enc.to(cd)
        if dir_enc is not None:
            dir_enc = dir_enc.to(cd)
    dar = (_DotAddReluPL if cfg.pallas_layer_bwd else _DotAddRelu).apply

    # layer1 stays on _DotAddRelu under pallas_layer_bwd, as in JAX
    out = _lin_relu(model.layer1, xyz_enc, cd)
    for i, layer in enumerate(model.layers_xyz):
        if i in cfg.skip_connect_ids:
            w = _w(layer)
            y = _mm(out, w[:h], cd) + _mm(xyz_enc, w[h:], cd)
            out = torch.relu(y + layer.bias.to(y.dtype))
        else:
            out = dar(out, _w(layer), layer.bias, cd)
    if not cfg.use_viewdirs:
        return _lin(model.fc_out, out, cd).float()
    feat = dar(out, _w(model.fc_feat), model.fc_feat.bias, cd)
    sigma = _lin(model.fc_alpha, feat, cd)
    layer_dir1 = model.layers_dir[0]
    wd = _w(layer_dir1)
    dp = _mm(dir_enc, wd[h:], cd)
    dir_part = dp + layer_dir1.bias.to(dp.dtype)
    v = dar(feat, wd[:h], dir_part[:, None, :], cd)
    rgb = _lin(model.fc_rgb, v, cd)
    return torch.cat([rgb, sigma], dim=-1).float()
