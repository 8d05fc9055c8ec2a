"""The single-pass backward of one linear + relu layer, K4 (counterpart
of ``codenerf_tpu/ops/layer_bwd.py::linear_relu_bwd_pallas``).

For ``y = relu(x @ w + b)`` and the cotangent ``g`` of ``y``:

    gp = where(y > 0, g, 0) in the compute dtype
    dx = gp @ w_cd^T        (f32 sums, cast to x's dtype)
    dw = x_cd^T @ gp        (f32 sums over every leading axis, f32)
    db = sum(float(gp))     over the axes b does not carry (f32): [N] for
                            a bias, per-ray sums over each ray's S samples
                            [R, 1, N] for per-ray rows with x [R, S, K]

Plain autograd makes three passes over the [rows, N] arrays (the mask,
the dx product and the dw product each read gp); K4
(``csrc/layer_bwd.cu``) reads x, y and g once and keeps gp on chip.

``linear_relu_bwd`` launches K4 for CUDA tensors and runs
``linear_relu_bwd_plain`` for CPU tensors; it counts its launches
(``linear_relu_bwd.launches``).  ``models/ray_structured.py`` reaches it
through this module's name when a backward runs, so a caller that rebinds
``linear_relu_bwd`` to the plain version runs the same path on CUDA
tensors without the kernel (``chip_smoke.py`` does, to compare).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from codenerf_tpu_torch.ops import _build


def _unbroadcast(gb, shape):
    """Sum ``gb`` over the axes a tensor of ``shape`` broadcasts."""
    lead = gb.dim() - len(shape)
    if lead:
        gb = gb.sum(dim=tuple(range(lead)))
    keep = tuple(i for i, n in enumerate(shape)
                 if n == 1 and gb.shape[i] != 1)
    if keep:
        gb = gb.sum(dim=keep, keepdim=True)
    return gb


def linear_relu_bwd_plain(x, w, b, y, g, cd=None):
    """(dx, dw, db) of ``y = relu(x @ w + b)`` in plain PyTorch, with JAX
    ``_dot_add_relu_bwd``'s cast points (ray_structured.py:129-144): dx in
    x's dtype, dw and db in f32.  ``b`` is any shape that broadcasts
    against y's."""
    ct = cd or y.dtype
    gp = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device)).to(ct)
    gpf = gp.float()
    dx = (gpf @ w.to(ct).float().t()).to(x.dtype)
    dw = (x.to(ct).float().reshape(-1, x.shape[-1]).t()
          @ gpf.reshape(-1, gp.shape[-1]))
    return dx, dw, _unbroadcast(gpf, b.shape)


@functools.cache
def _kernel_lib():
    """K4's library, built on first use, with every entry point typed."""
    lib = _build.load("layer_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.layer_bwd_grid.argtypes = [i32] * 6 + [ptr]
    lib.layer_bwd_grid.restype = i32
    lib.layer_bwd.argtypes = [ptr] * 4 + [ptr] * 4 + [i32] * 6 + [ptr]
    lib.layer_bwd.restype = i32
    lib.layer_bwd_error_string.argtypes = [i32]
    lib.layer_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _operand(t, dtype, shape, name, device):
    """One K4 operand: contiguous, on ``device``, 16-byte aligned for the
    kernel's vector loads (an unaligned view is copied)."""
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    if t.device != device or tuple(t.shape) != shape:
        raise ValueError(f"K4 operand {name}: want {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t


def _layer_bwd_cuda(x, w, b, y, g, cd):
    dev = x.device
    ct = cd or x.dtype
    if ct not in (torch.bfloat16, torch.float32) or x.dtype != ct:
        raise ValueError(f"K4 takes bfloat16 (cd=bfloat16) or float32 "
                         f"(cd=None) operands, got x {x.dtype}, cd {cd}")
    if w.dim() != 2:
        raise ValueError(f"K4: w must be [K, N], got {tuple(w.shape)}")
    K, N = w.shape
    if K % 16 or N % 16:
        raise ValueError(f"K4 needs K and N that are multiples of 16, got "
                         f"w {tuple(w.shape)}")
    if x.shape[-1] != K or y.shape != x.shape[:-1] + (N,) or (
            g.shape != y.shape):
        raise ValueError(f"K4: x {tuple(x.shape)}, w {tuple(w.shape)}, y "
                         f"{tuple(y.shape)} and g {tuple(g.shape)} do not "
                         f"match")
    per_ray = b.dim() == 3
    M = x.numel() // K
    if per_ray:
        if x.dim() != 3 or tuple(b.shape) != (x.shape[0], 1, N):
            raise ValueError(f"K4: per-ray b must be [R, 1, N] with x "
                             f"[R, S, K], got b {tuple(b.shape)}, x "
                             f"{tuple(x.shape)}")
        R, S = x.shape[:2]
    elif tuple(b.shape) == (N,):
        R, S = M, 1
    else:
        raise ValueError(f"K4: b must be [N] or [R, 1, N], got "
                         f"{tuple(b.shape)}")
    if M == 0:
        raise ValueError("K4 needs at least one row")
    xf = _operand(x, ct, tuple(x.shape), "x", dev)
    yf = _operand(y, ct, tuple(y.shape), "y", dev)
    gf = _operand(g, ct, tuple(g.shape), "g", dev)
    wc = _operand(w, ct, (K, N), "w", dev)
    lib = _kernel_lib()
    bf = int(ct == torch.bfloat16)
    grid = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = lib.layer_bwd_grid(bf, int(per_ray), M, S, K, N,
                                 ctypes.byref(grid))
        if err:
            raise RuntimeError(
                f"K4 grid query failed: CUDA error {err} "
                f"({lib.layer_bwd_error_string(err).decode()})")
        G = grid.value
        stride = K * N + (0 if per_ray else N)
        dx = torch.empty_like(xf)
        slabs = torch.empty((G, stride), dtype=torch.float32, device=dev)
        flat = torch.empty((stride,), dtype=torch.float32, device=dev)
        db_rows = (torch.empty((R, N), dtype=torch.float32, device=dev)
                   if per_ray else None)
        err = lib.layer_bwd(
            xf.data_ptr(), wc.data_ptr(), yf.data_ptr(), gf.data_ptr(),
            dx.data_ptr(), slabs.data_ptr(), flat.data_ptr(),
            None if db_rows is None else db_rows.data_ptr(),
            bf, M, S, K, N, G, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"K4 launch failed: CUDA error {err} "
                           f"({lib.layer_bwd_error_string(err).decode()})")
    linear_relu_bwd.launches += 1
    dw = flat[:K * N].view(K, N)
    db = db_rows.view(R, 1, N) if per_ray else flat[K * N:]
    return dx, dw, db


def linear_relu_bwd(x, w, b, y, g, cd=None):
    """(dx, dw, db) of ``y = relu(x @ w + b)``, as
    ``linear_relu_bwd_plain`` returns them, for x [..., K], w [K, N] and
    b [N] or per-ray [R, 1, N] with x [R, S, K].  Launches K4 for CUDA
    tensors (bf16 operands with ``cd`` bfloat16, or f32 with ``cd``
    None; K and N multiples of 16) and runs the plain version for CPU
    tensors."""
    if x.device.type == "cuda":
        return _layer_bwd_cuda(x, w, b, y, g, cd)
    if x.device.type == "cpu":
        return linear_relu_bwd_plain(x, w, b, y, g, cd)
    raise ValueError(f"no K4 for device {x.device}")


linear_relu_bwd.launches = 0
