"""The fused CodeNeRF trunk (counterpart of ``codenerf_tpu/ops/fused.py``).

The per-ray halves of every concat layer (code and view-direction
conditioning) are computed outside the kernels as [R, .] products
(``per_ray_parts``) and enter them as per-ray rows broadcast over the S
samples.  The per-sample chain — positional encode, six products, bias,
per-ray rows and relus — is one kernel, K1 (``csrc/trunk_fwd.cu``), that
keeps every intermediate on chip.  Its backward is K2 (recompute the
forward, then backpropagate) or K3 (backpropagate through activations the
forward stored), one template in ``csrc/trunk_bwd.cu``.

``trunk_forward`` launches K1 for CUDA tensors and runs
``trunk_forward_plain``, which repeats the kernel's arithmetic and cast
points in plain PyTorch, for CPU tensors; ``trunk_backward`` does the same
for K2 / K3 and ``trunk_backward_plain``.  The kernels compute in bf16 or
f32, with the launch plan of ``ops/plan.py``.  K2 / K3 are a row pass
(K2's runs the forward again) and the weight-gradient products
(``csrc/xtg.cuh``).  Each wrapper counts its launches, one per call
(``trunk_forward.launches``, ``trunk_backward.launches_recompute`` and
``.launches_stored``).

Training runs through three autograd Functions, the Pallas modes of the
JAX package: ``TrunkFunction`` (K1 forward, K2 backward;
``make_fused_codenerf(pallas_backward=True)``), ``RecomputeTrunkFunction``
(K1 forward, autograd through the recomputed ray-structured forward;
``make_fused_codenerf`` without ``pallas_backward``) and
``HybridTrunkFunction`` (a plain forward that stores the bf16
activations, K3 backward; ``make_hybrid_codenerf``).

``fused_codenerf`` and the Functions reach the wrappers through this
module's names ``trunk_forward`` and ``trunk_backward`` when they run, so
a caller that rebinds those names to the plain versions runs the same
path on CUDA tensors without the kernels (``chip_smoke.py`` does, to
compare).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from codenerf_tpu_torch.core.encoding import (frequency_bands,
                                              positional_encoding)
from codenerf_tpu_torch.models.mlp import CodeNeRF
from codenerf_tpu_torch.models.ray_structured import (_mm, _w,
                                                      apply_codenerf_rays)
from codenerf_tpu_torch.ops import _build, plan

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
                   log_sampling_xyz: bool, train: bool = False) -> dict:
    """The trunk's weights in K1's layout ([in, out]; biases stay f32 and
    are rounded where they are added).  For serving they are detached and
    cast to the compute dtype.  With ``train`` they are the f32 views of
    the parameters, neither detached nor cast (JAX ``cast=False``), so the
    trunk Functions' weight grads flow back through the slicing into each
    ``nn.Linear``; the Functions cast them where the kernels do."""
    cfg = model.cfg
    cd = cfg.cdtype or torch.float32
    h = cfg.hidden_size

    def wc(a):
        if a is None or train:
            return a
        return a.detach().to(cd).contiguous()

    w1x, w1s, w1c, b1 = split_layer1(model)
    wo = _w(model.fc_out)[:h]
    bias = (lambda b: b) if train else (lambda b: b.detach())
    return {
        "w1x": wc(w1x), "w1s": wc(w1s), "w1c": wc(w1c), "b1": bias(b1),
        "E": wc(encode_matrix(num_freq_xyz, log_sampling_xyz,
                              b1.device)),
        "w2": wc(_w(model.layer_xyz2)[:h]),
        "wof": wc(wo[:, 1:]), "wos": wc(wo[:, :1]),
        "wd": wc(_w(model.layer_dir1)[:cfg.shape_code_size]),
        "wd2": wc(_w(model.layer_dir2)),
        "bd2": bias(model.layer_dir2.bias),
        "wr": wc(_w(model.fc_rgb)[:h]),
    }


def _plain_chain(pts, per_ray: dict, weights: dict, cd, head_rows_in_cd):
    """The trunk in plain PyTorch: (raw [R, S, 4] f32, activations).  K1
    adds the sigma and rgb per-ray rows after a round to ``cd``; the JAX
    hybrid forward (``xla_trunk``) adds them in f32."""

    def mm(x, w):
        return (x.to(cd).float() @ w.to(cd).float()).to(cd)

    def rep(name):
        return per_ray[name][:, None, :].to(cd)

    def head_row(name):
        row = rep(name) if head_rows_in_cd else per_ray[name][:, None, :]
        return row.float()

    R, S = pts.shape[:2]
    # pts @ E at full f32 precision: E has one nonzero per column, so each
    # argument is exactly one f32 product x_c * band_k, column j = 3k + c
    bands = weights["E"][0, 0::3].float()
    scaled = (pts[..., None, :] * bands[:, None]).reshape(R, S, -1)
    h = mm(torch.sin(scaled), weights["w1s"]) + mm(torch.cos(scaled),
                                                   weights["w1c"])
    if weights["w1x"] is not None:
        h = h + mm(pts, weights["w1x"])
    h1 = torch.relu(h + weights["b1"].to(cd))
    h2 = torch.relu(mm(h1, weights["w2"]) + rep("zs1p"))
    feat = mm(h2, weights["wof"]) + rep("featp")
    sigma = mm(h2, weights["wos"]).float() + head_row("sigp")
    v1 = torch.relu(mm(feat, weights["wd"]) + rep("dirp"))
    v2 = torch.relu(mm(v1, weights["wd2"]) + weights["bd2"].to(cd))
    rgb = mm(v2, weights["wr"]).float() + head_row("zt1p")
    acts = {"h1": h1, "h2": h2, "feat": feat, "v1": v1, "v2": v2}
    return torch.cat([rgb, sigma], dim=-1), acts


def trunk_forward_plain(pts, per_ray: dict, weights: dict, *,
                        compute_dtype=None):
    """K1 in plain PyTorch: pts [R, S, 3] f32 -> raw [R, S, 4] f32, with
    ``_trunk_kernel``'s arithmetic and cast points (fused.py:88-126)."""
    return _plain_chain(pts, per_ray, weights,
                        compute_dtype or torch.float32, True)[0]


def hybrid_forward_plain(pts, per_ray: dict, weights: dict, *,
                         compute_dtype=None):
    """The JAX hybrid forward ``xla_trunk`` (fused.py:683-719) in plain
    PyTorch: raw [R, S, 4] f32 and the activations h1 h2 feat v1 v2, each
    [R*S, .] in the compute dtype, that K3 reads."""
    raw, acts = _plain_chain(pts, per_ray, weights,
                             compute_dtype or torch.float32, False)
    return raw, {k: v.reshape(-1, v.shape[-1]) for k, v in acts.items()}


def trunk_backward_plain(pts, per_ray: dict, b1, weights: dict, g,
                         acts: dict | None = None, *, compute_dtype=None):
    """K2 (or, with ``acts``, K3) in plain PyTorch: ``_trunk_bwd_impl``'s
    arithmetic and cast points (fused.py:183-346), step by step.

    Returns (g_pts [R, S, 3], per-ray grads {zs1p featp sigp dirp zt1p},
    each [R, .], db1 [h], weight grads {w1x w1s w1c w2 wof wos wd wd2 bd2
    wr}), all f32.
    """
    cd = compute_dtype or torch.float32
    f32 = torch.float32
    R, S = pts.shape[:2]
    N = R * S

    def mm_t(x, w):
        # x @ w^T (the cotangent through y = x @ w): cd in, f32 sums, cd out
        return (x.to(cd).float() @ w.to(cd).float().t()).to(cd)

    def d_w(x, y):
        # x^T @ y over all rows, cd in, f32 sums and result
        return x.to(cd).float().t() @ y.to(cd).float()

    def ray_sum(x):
        return x.float().reshape(R, S, -1).sum(dim=1)

    def live(a):
        return a.float() > 0

    bands = weights["E"][0, 0::3].float()
    scaled = (pts[..., None, :] * bands[:, None]).reshape(N, -1)
    sn, cs = torch.sin(scaled), torch.cos(scaled)
    if acts is None:
        _, a = _plain_chain(pts, per_ray, dict(weights, b1=b1), cd, True)
        acts = {k: v.reshape(N, -1) for k, v in a.items()}
    h1, h2, feat, v1, v2 = (acts[k] for k in ("h1", "h2", "feat", "v1",
                                              "v2"))
    zero = torch.zeros((), dtype=cd, device=pts.device)

    g = g.reshape(N, 4).to(f32)
    g_rgb, g_sig = g[:, :3], g[:, 3:]
    g_v2 = torch.where(live(v2), mm_t(g_rgb, weights["wr"]), zero)
    g_v1 = torch.where(live(v1), mm_t(g_v2, weights["wd2"]), zero)
    g_feat = mm_t(g_v1, weights["wd"])
    g_h2 = torch.where(live(h2), mm_t(g_feat, weights["wof"])
                       + mm_t(g_sig, weights["wos"]), zero)
    g_h1 = torch.where(live(h1), mm_t(g_h2, weights["w2"]), zero)

    g_sn = mm_t(g_h1, weights["w1s"]).float()
    g_cs = mm_t(g_h1, weights["w1c"]).float()
    g_scaled = (g_sn * cs - g_cs * sn).reshape(N, -1, 3)
    # f32 products and sums in band order: the bands reach 2^(F-1)
    g_pts = torch.zeros((N, 3), dtype=f32, device=pts.device)
    for k in range(bands.shape[0]):
        g_pts = g_pts + bands[k] * g_scaled[:, k]
    if weights["w1x"] is not None:
        g_pts = g_pts + mm_t(g_h1, weights["w1x"]).float()

    g_per_ray = {"zs1p": ray_sum(g_h2), "featp": ray_sum(g_feat),
                 "sigp": ray_sum(g_sig), "dirp": ray_sum(g_v1),
                 "zt1p": ray_sum(g_rgb)}
    dweights = {
        "w1x": (None if weights["w1x"] is None else
                d_w(pts.reshape(N, 3), g_h1)),
        "w1s": d_w(sn, g_h1), "w1c": d_w(cs, g_h1), "w2": d_w(h1, g_h2),
        "wof": d_w(h2, g_feat), "wos": d_w(h2, g_sig), "wd": d_w(feat, g_v1),
        "wd2": d_w(v1, g_v2), "bd2": g_v2.float().sum(dim=0),
        "wr": d_w(v2, g_rgb)}
    return (g_pts.reshape(R, S, 3), g_per_ray, g_h1.float().sum(dim=0),
            dweights)


@functools.cache
def _kernel_lib():
    """K1's library, built on first use, with every entry point typed."""
    lib = _build.load("trunk_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.trunk_fwd_bf16.argtypes = [ptr, ptr, ptr, ptr]
    lib.trunk_fwd_bf16.restype = i32
    lib.trunk_fwd_f32.argtypes = [ptr, ptr, ptr, ptr]
    lib.trunk_fwd_f32.restype = i32
    lib.trunk_fwd_error_string.argtypes = [i32]
    lib.trunk_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _operand(t, dtype, shape, name, device, kernel="K1"):
    """Check one kernel operand; product operands must be 32-byte aligned
    for the tensor-core fragment loads."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % 32):
        raise ValueError(
            f"{kernel} operand {name}: want a contiguous, 32-byte aligned {dtype} "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
    return t


def _padded(w, rows):
    out = torch.zeros((rows, w.shape[1]), dtype=w.dtype, device=w.device)
    out[:w.shape[0]] = w
    return out


def _compute_type(name, compute_dtype):
    cd = compute_dtype or torch.float32
    if cd not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} computes in bfloat16 or float32, not {cd}")
    return cd


# the forward's weights, which the kernels also take transposed
_FWD_KEYS = ("w1x", "w1s", "w1c", "w2", "wof", "wd", "wd2")
# the trunk kernels' inputs, in their argument order
_IN_KEYS = ("pts", *PER_RAY_KEYS, "b1", "w1x", "w1s", "w1c", "bands",
            *WEIGHT_KEYS, *(k + "T" for k in _FWD_KEYS))


def _row_inputs(name, pts, per_ray, b1, weights, cd):
    """The trunk kernels' inputs other than the product weights, by name,
    checked and in the compute type: pts [R, S, 3] f32, the per-ray rows,
    b1, the f32 bands, bd2 and the heads' weights wos and wr."""
    dev = pts.device
    R, S = pts.shape[:2]
    h, sc = weights["wof"].shape

    def op(t, dtype, shape, key):
        return _operand(t, dtype, shape, key, dev, name)

    ins = {"pts": op(pts, torch.float32, (R, S, 3), "pts")}
    for k in PER_RAY_KEYS:
        ins[k] = op(per_ray[k].to(cd).contiguous(), cd,
                    (R, {"featp": sc, "sigp": 1, "zt1p": 3}.get(k, h)), k)
    ins["b1"] = op(b1.to(cd).contiguous(), cd, (h,), "b1")
    ins["bands"] = weights["E"][0, 0::3].float().contiguous()
    for k, shape in (("wos", (h, 1)), ("bd2", (h,)), ("wr", (h, 3))):
        ins[k] = op(weights[k].to(cd).contiguous(), cd, shape, k)
    return ins


def _trunk_inputs(name, pts, per_ray, b1, weights, cd, kp):
    """The inputs of f32 K1, K2 and K3 by name, checked and in the compute
    type: ``_row_inputs``, the weights (w1s / w1c zero-padded to kp rows,
    w1x to 16), and the forward's weights transposed (``<key>T``, [out,
    in])."""
    dev = pts.device
    h, sc = weights["wof"].shape

    def op(t, dtype, shape, key):
        return _operand(t, dtype, shape, key, dev, name)

    ins = _row_inputs(name, pts, per_ray, b1, weights, cd)
    ins["w1x"] = (None if weights["w1x"] is None else
                  op(_padded(weights["w1x"].to(cd), 16), cd, (16, h), "w1x"))
    ins["w1s"] = op(_padded(weights["w1s"].to(cd), kp), cd, (kp, h), "w1s")
    ins["w1c"] = op(_padded(weights["w1c"].to(cd), kp), cd, (kp, h), "w1c")
    for k, shape in (("w2", (h, h)), ("wof", (h, sc)), ("wd", (sc, h)),
                     ("wd2", (h, h))):
        ins[k] = op(weights[k].to(cd).contiguous(), cd, shape, k)
    for k in _FWD_KEYS:
        ins[k + "T"] = None if ins[k] is None else ins[k].t().contiguous()
    return ins


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def _check(err, name, error_string, what):
    if err:
        raise RuntimeError(f"{name} {what} failed: CUDA error {err} "
                           f"({error_string(err).decode()})")


# the sources of bf16 K1's weight images ([in, out] each), in order
_K1_SOURCES = ("w1s", "w1c", "w1x", "w2", "wof", "wd", "wd2")


@functools.lru_cache(maxsize=None)
def k1_image_index(H: int, SC: int, F: int, has_x: bool) -> np.ndarray:
    """Where each element of bf16 K1's weight images comes from: an index
    into the flat concatenation of ``_K1_SOURCES`` (w1x only with the
    input term) followed by one zero.

    The images follow ``plan.k1_chunks``: the first layer's [w1s^T |
    w1c^T | w1x^T] at the encode's columns (sin at 0, cos at 32, x at
    64; zero elsewhere, and all of x's without the input term), then
    w2^T, wof^T, wd^T, wd2^T.  Each transposed weight [N, K] is
    zero-padded to the wgmma widths in N and K and laid out K-major with
    the 128-byte swizzle of ``csrc/hopper.cuh``: chunk c holds the rows'
    columns [64 c, 64 c + 64), 128 bytes a row, and the 16-byte piece q of
    row n sits at piece position q ^ (n % 8)."""
    shapes = {"w1s": (3 * F, H), "w1c": (3 * F, H), "w1x": (3, H),
              "w2": (H, H), "wof": (H, SC), "wd": (SC, H), "wd2": (H, H)}
    offset, total = {}, 0
    for k in _K1_SOURCES:
        if k != "w1x" or has_x:
            offset[k] = total
            total += shapes[k][0] * shapes[k][1]

    def image(n_pad, k_pad, parts):
        idx = np.full((n_pad, k_pad), total, dtype=np.int64)
        for key, k0 in parts:
            rows, N = shapes[key]
            n, k = np.arange(N)[:, None], np.arange(rows)[None, :]
            idx[n, k0 + k] = offset[key] + k * N + n     # W^T[n, k] = W[k, n]
        kc = k_pad // plan.K1_CHUNK_K
        pieces = idx.reshape(n_pad, kc, 8, 8).transpose(1, 0, 2, 3)
        n = np.arange(n_pad)[:, None]
        return pieces[:, n, np.arange(8)[None, :] ^ (n % 8)].reshape(-1)

    nh, ns = plan.k1_wgmma_width(H), plan.k1_wgmma_width(SC)
    first = [("w1s", 0), ("w1c", 32)] + ([("w1x", 64)] if has_x else [])
    return np.concatenate([
        image(nh, 128, first), image(nh, nh, [("w2", 0)]),
        image(ns, nh, [("wof", 0)]), image(nh, ns, [("wd", 0)]),
        image(nh, nh, [("wd2", 0)])])


@functools.lru_cache(maxsize=None)
def _k1_index_on(H, SC, F, has_x, device):
    return torch.from_numpy(k1_image_index(H, SC, F, has_x)).to(device)


def k1_images(weights: dict, pl: dict, cd=torch.bfloat16):
    """bf16 K1's weight images, packed once per call (``k1_image_index``):
    one concatenation of the weights in ``cd`` and one gather."""
    h, sc = weights["wof"].shape
    F = weights["w1s"].shape[0] // 3
    has_x = weights["w1x"] is not None
    srcs = [weights[k].detach().to(cd).reshape(-1) for k in _K1_SOURCES
            if weights[k] is not None]
    flat = torch.cat(srcs + [srcs[0].new_zeros(1)])
    img = flat[_k1_index_on(h, sc, F, has_x, flat.device)]
    if img.numel() * img.element_size() != pl["image_bytes"]:
        raise ValueError(f"K1's weight images hold "
                         f"{img.numel() * img.element_size()} B, the plan "
                         f"{pl['image_bytes']} B")
    return img


# bf16 K1's inputs before the images, in its argument order
_BF16_KEYS = ("pts", *PER_RAY_KEYS, "b1", "bd2", "wos", "wr", "bands")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# bf16 K1's plan by shape (read only): the render and the step ask for the
# same few shapes every call
_k1_plan = functools.lru_cache(maxsize=64)(plan.trunk_fwd_wgmma_plan)


def trunk_forward_launcher(pts, per_ray: dict, weights: dict, *,
                           compute_dtype=None):
    """K1's inputs for CUDA tensors, checked, cast and packed: (out,
    launch), where each ``launch()`` runs K1 on them into ``out`` [R, S, 4]
    f32 and counts the launch.  ``trunk_forward`` launches once; a timing
    loop launches again without repacking."""
    cd = _compute_type("K1", compute_dtype)
    dev = pts.device
    if pts.dim() != 3 or pts.shape[-1] != 3:
        raise ValueError(f"pts must be [R, S, 3], got {tuple(pts.shape)}")
    R, S = pts.shape[:2]
    h, sc = weights["wof"].shape
    F = weights["w1s"].shape[0] // 3
    lib = _kernel_lib()
    out = torch.empty((R, S, 4), dtype=torch.float32, device=dev)
    if cd == torch.bfloat16:
        pl = _k1_plan(R, S, h, sc, F, _sm_count(dev.index))
        ins = _row_inputs("K1", pts, per_ray, weights["b1"], weights, cd)
        ins["img"] = k1_images(weights, pl, cd)
        dims = (ctypes.c_longlong * 12)(
            R, S, h, sc, F, pl["tile_rows"], pl["smem"], pl["grid"],
            pl["tiles"], pl["image_bytes"], pl["nh"], pl["ns"])
        entry, ptrs = lib.trunk_fwd_bf16, _ptrs(
            [ins[k] for k in (*_BF16_KEYS, "img")])
    else:
        pl = plan.trunk_fwd_plan(R, S, h, sc, F, cd.itemsize)
        ins = _trunk_inputs("K1", pts, per_ray, weights["b1"], weights, cd,
                            pl["kp"])
        dims = (ctypes.c_int * 7)(R, S, h, sc, F, pl["smem"],
                                  pl["tile_rows"])
        entry, ptrs = lib.trunk_fwd_f32, _ptrs([ins[k] for k in _IN_KEYS])

    def launch():
        with torch.cuda.device(dev):
            err = entry(ptrs, out.data_ptr(), dims,
                        torch.cuda.current_stream(dev).cuda_stream)
        _check(err, "K1", lib.trunk_fwd_error_string, "launch")
        trunk_forward.launches += 1

    launch.inputs = ins       # keeps the packed inputs alive with launch
    return out, launch


def trunk_forward(pts, per_ray: dict, weights: dict, *, compute_dtype=None):
    """raw [R, S, 4] f32 from pts [R, S, 3], the per-ray rows of
    ``per_ray_parts`` and the weights of ``kernel_weights``.  Launches K1
    for CUDA tensors (bf16: the persistent wgmma kernel, widths at most
    ``plan.K1_MAX_WIDTH``; f32: the CUDA-core kernel) and runs the plain
    version for CPU tensors."""
    if pts.device.type == "cuda":
        out, launch = trunk_forward_launcher(pts, per_ray, weights,
                                             compute_dtype=compute_dtype)
        launch()
        return out
    if pts.device.type == "cpu":
        return trunk_forward_plain(pts, per_ray, weights,
                                   compute_dtype=compute_dtype)
    raise ValueError(f"no K1 for device {pts.device}")


trunk_forward.launches = 0


@functools.cache
def _bwd_lib():
    """K2 / K3's library, built on first use, with every entry point
    typed."""
    lib = _build.load("trunk_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.trunk_bwd_rows.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.trunk_bwd_rows.restype = i32
    lib.trunk_bwd_xtg.argtypes = [ptr, i32, i32, ptr]
    lib.trunk_bwd_xtg.restype = i32
    lib.trunk_bwd_sum.argtypes = [ptr, i32, ptr]
    lib.trunk_bwd_sum.restype = i32
    lib.trunk_bwd_error_string.argtypes = [i32]
    lib.trunk_bwd_error_string.restype = ctypes.c_char_p
    return lib


ACT_KEYS = ("h1", "h2", "feat", "v1", "v2")


def _trunk_bwd_cuda(pts, per_ray, b1, weights, g, acts, compute_dtype):
    name = "K3" if acts is not None else "K2"
    cd = _compute_type(name, compute_dtype)
    f32 = torch.float32
    dev = pts.device
    if pts.dim() != 3 or pts.shape[-1] != 3:
        raise ValueError(f"pts must be [R, S, 3], got {tuple(pts.shape)}")
    R, S = pts.shape[:2]
    h, sc = weights["wof"].shape
    F = weights["w1s"].shape[0] // 3
    has_x = weights["w1x"] is not None
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pl = plan.trunk_bwd_plan(R, S, h, sc, F, has_x, cd.itemsize, n_sm,
                             stored=acts is not None)
    ins = _trunk_inputs(name, pts, per_ray, b1, weights, cd, pl["kp"])
    M, EW, G = R * S, pl["enc_width"], pl["rows"]["grid"]
    ins["g"] = _operand(g.to(f32).contiguous(), f32, (R, S, 4), "g", dev,
                        name)
    # the backward's three encode products as one: [w1s; w1c; w1x]
    ins["w1b"] = torch.cat([ins[k] for k in ("w1s", "w1c", "w1x")
                            if ins[k] is not None])
    width = {k: sc if k == "feat" else h for k in ACT_KEYS}
    lib = _bwd_lib()
    f32_flag = int(cd == f32)

    def new(*shape, dtype=cd):
        return torch.empty(shape, dtype=dtype, device=dev)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if acts is None:
            # K2's row pass runs the forward again and stores h1 h2 feat v1
            # for the dW products
            acts = {k: None if k == "v2" else new(M, width[k])
                    for k in ACT_KEYS}
        else:
            acts = {k: _operand(acts[k], cd, (M, width[k]), k, dev, name)
                    for k in ACT_KEYS}
        outs = {"g_pts": new(R, S, 3, dtype=f32),
                "zs1p": new(R, h, dtype=f32), "featp": new(R, sc, dtype=f32),
                "sigp": new(R, 1, dtype=f32), "dirp": new(R, h, dtype=f32),
                "zt1p": new(R, 3, dtype=f32), "enc": new(M, EW)}
        cot = {k: new(M, width[k]) for k in ACT_KEYS}
        small = new(G, pl["small_width"], dtype=f32)
        rp = pl["rows"]
        err = lib.trunk_bwd_rows(
            _ptrs([ins[k] for k in (*_IN_KEYS, "w1b", "g")]
                  + [acts[k] for k in ACT_KEYS]),
            _ptrs(list(outs.values()) + [cot[k] for k in ACT_KEYS]
                  + [small]),
            (ctypes.c_int * 9)(R, S, h, sc, F, rp["smem"], rp["tile_rows"],
                               G, EW), f32_flag, int(pl["recompute"]), stream)
        _check(err, name, lib.trunk_bwd_error_string, "row pass launch")

        # the dW products: [sin | cos | x]^T g_h1, h1^T g_h2, h2^T g_feat,
        # feat^T g_v1, v1^T g_v2
        gemm = pl["gemm"]
        pairs = ((outs["enc"], EW, cot["h1"], h),
                 (acts["h1"], h, cot["h2"], h),
                 (acts["h2"], h, cot["feat"], sc),
                 (acts["feat"], sc, cot["v1"], h),
                 (acts["v1"], h, cot["v2"], h))
        dws = [new(p["kd"], p["nd"], dtype=f32) for p in gemm["products"]]
        part = new(gemm["part_floats"], dtype=f32)
        rows = plan.xtg_rows(gemm, [(a.data_ptr(), lda, b.data_ptr(), ldb,
                                     d.data_ptr()) for (a, lda, b, ldb), d
                                    in zip(pairs, dws)], part.data_ptr())
        err = lib.trunk_bwd_xtg((ctypes.c_longlong * len(rows))(*rows),
                                len(dws), f32_flag, stream)
        _check(err, name, lib.trunk_bwd_error_string, "dW product launch")
        narrow = new(pl["small_width"], dtype=f32)
        err = lib.trunk_bwd_sum((ctypes.c_longlong * 4)(
            small.data_ptr(), narrow.data_ptr(), G, pl["small_width"]), 1,
            stream)
        _check(err, name, lib.trunk_bwd_error_string, "slab sum launch")
    if name == "K3":
        trunk_backward.launches_stored += 1
    else:
        trunk_backward.launches_recompute += 1

    # the encode product's rows: sin, cos, x, then the ones' row (db1)
    kp, F3 = pl["kp"], 3 * F
    w1 = dws[0]
    dw = {"w1s": w1[:F3], "w1c": w1[kp:kp + F3],
          "w1x": w1[2 * kp:2 * kp + 3] if has_x else None,
          "w2": dws[1], "wof": dws[2], "wd": dws[3], "wd2": dws[4],
          "wos": narrow[:h].view(h, 1), "wr": narrow[h:4 * h].view(h, 3),
          "bd2": narrow[4 * h:5 * h]}
    db1 = w1[2 * kp + 3]
    g_per_ray = {k: outs[k] for k in PER_RAY_KEYS}
    return outs["g_pts"], g_per_ray, db1, dw


def trunk_backward(pts, per_ray: dict, b1, weights: dict, g,
                   acts: dict | None = None, *, compute_dtype=None):
    """Grads of the trunk for the cotangent g [R, S, 4]: (g_pts, per-ray
    grads, db1, weight grads), as ``trunk_backward_plain`` returns them.
    Launches K2, or K3 when the forward's activations ``acts`` are given,
    for CUDA tensors (bf16 or f32 compute), and runs the plain version for
    CPU tensors."""
    if pts.device.type == "cuda":
        return _trunk_bwd_cuda(pts, per_ray, b1, weights, g, acts,
                               compute_dtype)
    if pts.device.type == "cpu":
        return trunk_backward_plain(pts, per_ray, b1, weights, g, acts,
                                    compute_dtype=compute_dtype)
    raise ValueError(f"no K2 / K3 for device {pts.device}")


trunk_backward.launches_recompute = 0
trunk_backward.launches_stored = 0

# the trunk Functions' tensor arguments after pts, in order
_FN_KEYS = (*PER_RAY_KEYS, "b1", "w1x", "w1s", "w1c", "E", *WEIGHT_KEYS)


def _split_args(args):
    named = dict(zip(_FN_KEYS, args))
    per_ray = {k: named[k] for k in PER_RAY_KEYS}
    return per_ray, named


def _cast_weights(named, cd):
    """The weights as the kernels read them: products in ``cd``; biases
    and the encode matrix as given (they are rounded where they are
    added)."""
    out = {}
    for k in ("b1", "w1x", "w1s", "w1c", "E", *WEIGHT_KEYS):
        v = named[k]
        if v is not None:
            v = v.detach()
            if k not in ("b1", "E", "bd2"):
                v = v.to(cd or torch.float32).contiguous()
        out[k] = v
    return out


def _grads(per_ray, named, g_pts, g_per_ray, db1, dw):
    """The Functions' backward outputs, one per forward argument."""
    out = [None, g_pts]
    out += [g_per_ray[k].to(per_ray[k].dtype) for k in PER_RAY_KEYS]
    for k in _FN_KEYS[len(PER_RAY_KEYS):]:
        if k == "b1":
            out.append(db1)
        elif k == "E" or named[k] is None:
            out.append(None)
        else:
            out.append(dw[k].reshape(named[k].shape))
    return tuple(out)


class TrunkFunction(torch.autograd.Function):
    """The fused trunk with JAX ``make_fused_codenerf(pallas_backward=True)``
    semantics: K1 forward, K2 backward (their plain versions for CPU
    tensors).  Grads flow to pts, the five per-ray rows, b1 and the
    weights; the encode matrix E gets none."""

    @staticmethod
    def forward(ctx, cd, pts, *args):
        per_ray, named = _split_args(args)
        weights = _cast_weights(named, cd)
        out = trunk_forward(pts, per_ray, weights, compute_dtype=cd)
        ctx.cd = cd
        ctx.save_for_backward(pts, *args)
        return out

    @staticmethod
    def backward(ctx, g):
        pts, *args = ctx.saved_tensors
        per_ray, named = _split_args(args)
        weights = _cast_weights(named, ctx.cd)
        res = trunk_backward(pts, per_ray, weights["b1"], weights, g,
                             compute_dtype=ctx.cd)
        return _grads(per_ray, named, *res)


class HybridTrunkFunction(torch.autograd.Function):
    """The trunk with JAX ``make_hybrid_codenerf`` semantics: the plain
    forward of ``xla_trunk``, which stores h1 h2 feat v1 v2 in the compute
    dtype, and K3 backward through them (its plain version for CPU
    tensors)."""

    @staticmethod
    def forward(ctx, cd, pts, *args):
        per_ray, named = _split_args(args)
        weights = _cast_weights(named, cd)
        with torch.no_grad():
            out, acts = hybrid_forward_plain(pts, per_ray, weights,
                                             compute_dtype=cd)
        ctx.cd = cd
        ctx.save_for_backward(pts, *args, *(acts[k] for k in ACT_KEYS))
        return out

    @staticmethod
    def backward(ctx, g):
        pts, *rest = ctx.saved_tensors
        args, act_list = rest[:len(_FN_KEYS)], rest[len(_FN_KEYS):]
        per_ray, named = _split_args(args)
        weights = _cast_weights(named, ctx.cd)
        acts = dict(zip(ACT_KEYS, act_list))
        res = trunk_backward(pts, per_ray, weights["b1"], weights, g, acts,
                             compute_dtype=ctx.cd)
        return _grads(per_ray, named, *res)


def fused_codenerf(model: CodeNeRF, pts, dir_enc, z_s, z_t, *,
                   num_freq_xyz: int, log_sampling_xyz: bool):
    """CodeNeRF raw [R, S, 4] through the fused trunk (the forward of JAX
    ``make_fused_codenerf``): per-ray rows, kernel weights, then
    ``trunk_forward``."""
    per_ray = per_ray_parts(model, dir_enc, z_s, z_t)
    weights = kernel_weights(model, num_freq_xyz, log_sampling_xyz)
    return trunk_forward(pts, per_ray, weights,
                         compute_dtype=model.cfg.cdtype)


def train_codenerf(model: CodeNeRF, pts, dir_enc, z_s, z_t, *,
                   num_freq_xyz: int, log_sampling_xyz: bool,
                   hybrid: bool = False):
    """CodeNeRF raw [R, S, 4] with gradients to the model's parameters,
    pts and the per-ray inputs: fused mode (``TrunkFunction``, K1 + K2) or,
    with ``hybrid``, hybrid mode (``HybridTrunkFunction``, K3)."""
    per_ray = per_ray_parts(model, dir_enc, z_s, z_t)
    weights = kernel_weights(model, num_freq_xyz, log_sampling_xyz,
                             train=True)
    named = dict(per_ray, **weights)
    fn = HybridTrunkFunction if hybrid else TrunkFunction
    return fn.apply(model.cfg.cdtype, pts, *(named[k] for k in _FN_KEYS))


class RecomputeTrunkFunction(torch.autograd.Function):
    """The fused trunk with JAX ``make_fused_codenerf`` semantics without
    ``pallas_backward`` (fused.py:638-651): K1 forward
    (``fused_codenerf``); the backward recomputes the ray-structured
    forward (encode, then ``apply_codenerf_rays`` under ``cfg``) and
    backpropagates through it with autograd.  Grads flow to pts, dir_enc,
    the codes and the model's parameters, which follow the four tensors
    as arguments."""

    @staticmethod
    def forward(ctx, model, cfg, num_freq_xyz, log_sampling_xyz, pts,
                dir_enc, z_s, z_t, *params):
        ctx.model, ctx.cfg = model, cfg
        ctx.enc = (num_freq_xyz, log_sampling_xyz)
        ctx.save_for_backward(pts, dir_enc, z_s, z_t)
        return fused_codenerf(model, pts, dir_enc, z_s, z_t,
                              num_freq_xyz=num_freq_xyz,
                              log_sampling_xyz=log_sampling_xyz)

    @staticmethod
    def backward(ctx, g):
        model = ctx.model
        num_freq, log_sampling = ctx.enc
        needs = ctx.needs_input_grad[4:]
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, needs)]
        leaves = ins + list(model.parameters())
        with torch.enable_grad():
            xyz_enc = positional_encoding(ins[0], num_freq,
                                          model.cfg.include_input_xyz,
                                          log_sampling)
            raw = apply_codenerf_rays(model, xyz_enc, *ins[1:], cfg=ctx.cfg)
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(raw, wanted, g, allow_unused=True))
        return (None, None, None, None,
                *(next(grads) if need else None for need in needs))


def recompute_codenerf(model: CodeNeRF, pts, dir_enc, z_s, z_t, *,
                       num_freq_xyz: int, log_sampling_xyz: bool, cfg=None):
    """CodeNeRF raw [R, S, 4] through ``RecomputeTrunkFunction``: K1
    forward, autograd through the ray-structured forward under ``cfg``
    (default ``model.cfg``), recomputed."""
    return RecomputeTrunkFunction.apply(
        model, cfg or model.cfg, num_freq_xyz, log_sampling_xyz, pts,
        dir_enc, z_s, z_t, *model.parameters())
