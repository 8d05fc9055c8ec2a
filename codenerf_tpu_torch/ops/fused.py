"""The fused CodeNeRF trunk (counterpart of ``codenerf_tpu/ops/fused.py``,
forward only).

The per-ray halves of every concat layer (code and view-direction
conditioning) are computed outside the kernel as [R, .] products
(``per_ray_parts``) and enter it as per-ray rows broadcast over the S
samples.  The per-sample chain — positional encode, six products, bias,
per-ray rows and relus — is one kernel, K1 (``csrc/trunk_fwd.cu``), that
keeps every intermediate on chip.

``trunk_forward`` launches K1 for CUDA tensors and runs
``trunk_forward_plain``, which repeats the kernel's arithmetic and cast
points in plain PyTorch, for CPU tensors.  It counts its launches in
``trunk_forward.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from codenerf_tpu_torch.core.encoding import frequency_bands
from codenerf_tpu_torch.models.mlp import CodeNeRF
from codenerf_tpu_torch.models.ray_structured import _mm, _w
from codenerf_tpu_torch.ops import _build

# row layout of K1's per-ray inputs, in the kernel's argument order
PER_RAY_KEYS = ("zs1p", "featp", "sigp", "dirp", "zt1p")
WEIGHT_KEYS = ("w2", "wof", "wos", "wd", "wd2", "bd2", "wr")


def encode_matrix(num_freq: int, log_sampling: bool, device=None):
    """E [3, 3F] with E[c, 3k+c] = band_k: ``pts @ E`` is every
    (band, coordinate) argument of the encode."""
    bands = frequency_bands(num_freq, log_sampling, torch.float32, device)
    eye3 = torch.eye(3, device=device)
    return (bands[None, :, None] * eye3[:, None, :]).reshape(3, 3 * num_freq)


def split_layer1(model: CodeNeRF):
    """layer_xyz1's rows as (x | sin | cos) blocks in the encode matrix's
    column order; the reference row order is [x(3), sin f0(3), cos f0(3),
    sin f1(3), ...].  Returns (w1x or None, w1s, w1c, b1)."""
    cfg = model.cfg
    w1 = _w(model.layer_xyz1)                                  # [dim_xyz, h]
    off = 3 if cfg.include_input_xyz else 0
    sin_rows = torch.tensor([off + 6 * f + c
                             for f in range(cfg.num_encoding_fn_xyz)
                             for c in range(3)], device=w1.device)
    return (w1[:off] if off else None, w1[sin_rows], w1[sin_rows + 3],
            model.layer_xyz1.bias)


def per_ray_parts(model: CodeNeRF, dir_enc, z_s, z_t) -> dict:
    """The per-ray rows K1 adds: [R, .] halves of every concat layer, with
    the JAX ``_per_ray_parts`` cast points (bf16 products, f32 biases)."""
    cfg = model.cfg
    cd = cfg.cdtype
    h = cfg.hidden_size

    def lin_relu(layer, x):
        return torch.relu(_mm(x, _w(layer), cd) + layer.bias)

    zs1 = lin_relu(model.shape_code_layer1, z_s)
    zs2 = lin_relu(model.shape_code_layer2, z_s)
    zt1 = lin_relu(model.texture_code_layer1, z_t)
    zs1p = _mm(zs1, _w(model.layer_xyz2)[h:], cd) + model.layer_xyz2.bias
    out_part = _mm(zs2, _w(model.fc_out)[h:], cd) + model.fc_out.bias
    dirp = (_mm(dir_enc, _w(model.layer_dir1)[cfg.shape_code_size:], cd)
            + model.layer_dir1.bias)
    zt1p = _mm(zt1, _w(model.fc_rgb)[h:], cd) + model.fc_rgb.bias
    return {"zs1p": zs1p, "featp": out_part[..., 1:],
            "sigp": out_part[..., :1], "dirp": dirp, "zt1p": zt1p}


def kernel_weights(model: CodeNeRF, num_freq_xyz: int,
                   log_sampling_xyz: bool) -> dict:
    """The trunk's weights in K1's layout ([in, out], the compute dtype;
    biases stay f32 and are rounded where they are added).  Detached: K1
    is forward only."""
    cfg = model.cfg
    cd = cfg.cdtype or torch.float32
    h = cfg.hidden_size

    def wc(a):
        return None if a is None else a.detach().to(cd).contiguous()

    w1x, w1s, w1c, b1 = split_layer1(model)
    wo = _w(model.fc_out)[:h]
    return {
        "w1x": wc(w1x), "w1s": wc(w1s), "w1c": wc(w1c), "b1": b1.detach(),
        "E": wc(encode_matrix(num_freq_xyz, log_sampling_xyz,
                              b1.device)),
        "w2": wc(_w(model.layer_xyz2)[:h]),
        "wof": wc(wo[:, 1:]), "wos": wc(wo[:, :1]),
        "wd": wc(_w(model.layer_dir1)[:cfg.shape_code_size]),
        "wd2": wc(_w(model.layer_dir2)),
        "bd2": model.layer_dir2.bias.detach(),
        "wr": wc(_w(model.fc_rgb)[:h]),
    }


def trunk_forward_plain(pts, per_ray: dict, weights: dict, *,
                        compute_dtype=None):
    """K1 in plain PyTorch: pts [R, S, 3] f32 -> raw [R, S, 4] f32, with
    ``_trunk_kernel``'s arithmetic and cast points (fused.py:88-126)."""
    cd = compute_dtype or torch.float32

    def mm(x, w):
        return (x.to(cd).float() @ w.to(cd).float()).to(cd)

    def rep(name):
        return per_ray[name][:, None, :].to(cd)

    R, S = pts.shape[:2]
    # pts @ E at full f32 precision: E has one nonzero per column, so each
    # argument is exactly one f32 product x_c * band_k, column j = 3k + c
    bands = weights["E"][0, 0::3].float()
    scaled = (pts[..., None, :] * bands[:, None]).reshape(R, S, -1)
    h = mm(torch.sin(scaled), weights["w1s"]) + mm(torch.cos(scaled),
                                                   weights["w1c"])
    if weights["w1x"] is not None:
        h = h + mm(pts, weights["w1x"])
    h = torch.relu(h + weights["b1"].to(cd))
    h = torch.relu(mm(h, weights["w2"]) + rep("zs1p"))
    feat = mm(h, weights["wof"]) + rep("featp")
    sigma = mm(h, weights["wos"]).float() + rep("sigp").float()
    v = torch.relu(mm(feat, weights["wd"]) + rep("dirp"))
    v = torch.relu(mm(v, weights["wd2"]) + weights["bd2"].to(cd))
    rgb = mm(v, weights["wr"]).float() + rep("zt1p").float()
    return torch.cat([rgb, sigma], dim=-1)


@functools.cache
def _kernel_lib():
    """K1's library, built on first use, with every entry point typed."""
    lib = _build.load("trunk_fwd")
    lib.trunk_fwd.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
    lib.trunk_fwd.restype = ctypes.c_int
    lib.trunk_fwd_kp.argtypes = [ctypes.c_int]
    lib.trunk_fwd_kp.restype = ctypes.c_int
    lib.trunk_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.trunk_fwd_smem_bytes.restype = ctypes.c_int
    lib.trunk_fwd_error_string.argtypes = [ctypes.c_int]
    lib.trunk_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _operand(t, dtype, shape, name, device):
    """Check one kernel operand; product operands must be 32-byte aligned
    for the tensor-core fragment loads."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 32):
        raise ValueError(
            f"K1 operand {name}: want a contiguous, 32-byte aligned {dtype} "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
    return t


def _padded(w, rows):
    out = torch.zeros((rows, w.shape[1]), dtype=w.dtype, device=w.device)
    out[:w.shape[0]] = w
    return out


def _trunk_cuda(pts, per_ray, weights, compute_dtype):
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"K1 computes in bfloat16, not {compute_dtype}")
    bf = torch.bfloat16
    dev = pts.device
    if pts.dim() != 3 or pts.shape[-1] != 3:
        raise ValueError(f"pts must be [R, S, 3], got {tuple(pts.shape)}")
    R, S = pts.shape[:2]
    h, sc = weights["wof"].shape
    F = weights["w1s"].shape[0] // 3
    if h % 32 or sc % 32:
        raise ValueError(f"K1 needs hidden and code widths that are "
                         f"multiples of 32, got {h} and {sc}")
    lib = _kernel_lib()
    smem = lib.trunk_fwd_smem_bytes(h, sc, F)
    if smem > 232448:
        raise ValueError(f"K1 at h={h}, s={sc}, F={F} needs {smem} B of "
                         f"shared memory per block, above the 227 KB limit")
    kp = lib.trunk_fwd_kp(F)
    _operand(pts, torch.float32, (R, S, 3), "pts", dev)
    rows = {k: _operand(per_ray[k].to(bf).contiguous(), bf,
                        (R, {"featp": sc, "sigp": 1, "zt1p": 3}.get(k, h)),
                        k, dev) for k in PER_RAY_KEYS}
    wts = {k: _operand(weights[k], bf, shape, k, dev) for k, shape in (
        ("w2", (h, h)), ("wof", (h, sc)), ("wos", (h, 1)), ("wd", (sc, h)),
        ("wd2", (h, h)), ("wr", (h, 3)))}
    wts["bd2"] = _operand(weights["bd2"].to(bf).contiguous(), bf, (h,),
                          "bd2", dev)
    b1 = _operand(weights["b1"].to(bf).contiguous(), bf, (h,), "b1", dev)
    w1s = _operand(_padded(weights["w1s"], kp), bf, (kp, h), "w1s", dev)
    w1c = _operand(_padded(weights["w1c"], kp), bf, (kp, h), "w1c", dev)
    w1x = (None if weights["w1x"] is None else
           _operand(_padded(weights["w1x"], 16), bf, (16, h), "w1x", dev))
    bands = weights["E"][0, 0::3].float().contiguous()
    out = torch.empty((R, S, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.trunk_fwd(
            pts.data_ptr(), *(rows[k].data_ptr() for k in PER_RAY_KEYS),
            b1.data_ptr(), None if w1x is None else w1x.data_ptr(),
            w1s.data_ptr(), w1c.data_ptr(), bands.data_ptr(),
            *(wts[k].data_ptr() for k in WEIGHT_KEYS),
            out.data_ptr(), R, S, h, sc, F, stream)
    if err:
        raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                           f"({lib.trunk_fwd_error_string(err).decode()})")
    trunk_forward.launches += 1
    return out


def trunk_forward(pts, per_ray: dict, weights: dict, *, compute_dtype=None):
    """raw [R, S, 4] f32 from pts [R, S, 3], the per-ray rows of
    ``per_ray_parts`` and the weights of ``kernel_weights``.  Launches K1
    for CUDA tensors (bf16 compute only) and runs the plain version for CPU
    tensors."""
    if pts.device.type == "cuda":
        return _trunk_cuda(pts, per_ray, weights, compute_dtype)
    if pts.device.type == "cpu":
        return trunk_forward_plain(pts, per_ray, weights,
                                   compute_dtype=compute_dtype)
    raise ValueError(f"no K1 for device {pts.device}")


trunk_forward.launches = 0


def fused_codenerf(model: CodeNeRF, pts, dir_enc, z_s, z_t, *,
                   num_freq_xyz: int, log_sampling_xyz: bool,
                   trunk=trunk_forward):
    """CodeNeRF raw [R, S, 4] through the fused trunk (the forward of JAX
    ``make_fused_codenerf``): per-ray rows, kernel weights, then
    ``trunk`` (K1's wrapper unless the caller passes its plain version)."""
    per_ray = per_ray_parts(model, dir_enc, z_s, z_t)
    weights = kernel_weights(model, num_freq_xyz, log_sampling_xyz)
    return trunk(pts, per_ray, weights, compute_dtype=model.cfg.cdtype)
