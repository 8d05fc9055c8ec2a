"""The backward of one linear + relu layer, K4 (counterpart
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
(``csrc/layer_bwd.cu``) makes two: a row pass reads y and g once and
writes gp, dx and db, then a tall split-K product (``csrc/xtg.cuh``)
reads x and gp once for dw.  Its launch plan is
``ops/plan.py::layer_bwd_plan`` in the layout ``plan.k4_layout`` picks
by shape before the launch: K and N
that are not multiples of 16 run zero-padded (``pad_layer``), and bf16
wider than ``plan.K4_MAX_WIDTH`` runs the row pass with w read from
global memory, f32's layout, instead of keeping w in shared memory.

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

from codenerf_tpu_torch.ops import _build, plan, products


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
    x's dtype, dw and db in f32, the products through
    ``products._dot`` with a ``cd``.  ``b`` is any shape that
    broadcasts against y's."""
    ct = cd or y.dtype
    gp = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device)).to(ct)
    gpf = gp.float()
    if cd is None:
        dx = (gpf @ w.to(ct).float().t()).to(x.dtype)
    else:
        dx = products._dot(gp, w.to(cd).t(), cd, x.dtype)
    dw = products._dw(x.to(ct), gp, cd)
    return dx, dw, _unbroadcast(gpf, b.shape)


def pad_layer(x, w, b, y, g, k: int, n: int):
    """K4's operands at widths ``k`` (x's last axis, w's rows) and ``n``
    (w's columns, b, y and g), zero-padded.  Padding is exact: a padded
    input column meets zero weight rows, and a padded output column has
    y = 0, so its gp, dw column and db are 0."""
    K, N = w.shape
    F = torch.nn.functional
    return (F.pad(x, (0, k - K)), F.pad(w, (0, n - N, 0, k - K)),
            F.pad(b, (0, n - N)), F.pad(y, (0, n - N)), F.pad(g, (0, n - N)))


@functools.cache
def _kernel_lib():
    """K4's library, built on first use, with every entry point typed."""
    lib = _build.load("layer_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.layer_bwd_rows.argtypes = [ptr, ptr, i32, ptr]
    lib.layer_bwd_rows.restype = i32
    lib.layer_bwd_xtg.argtypes = [ptr, i32, i32, ptr]
    lib.layer_bwd_xtg.restype = i32
    lib.layer_bwd_sum.argtypes = [ptr, i32, ptr]
    lib.layer_bwd_sum.restype = i32
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
    K0, N0 = K, N
    K, N, w_in_smem = plan.k4_layout(K0, N0, ct.itemsize)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pl = plan.layer_bwd_plan(M, S, K, N, per_ray, ct.itemsize, n_sm,
                             w_in_smem)
    if (K, N) != (K0, N0):
        x, w, b, y, g = pad_layer(x, w, b, y, g, K, N)
    xf = _operand(x, ct, tuple(x.shape), "x", dev)
    yf = _operand(y, ct, tuple(y.shape), "y", dev)
    gf = _operand(g, ct, tuple(g.shape), "g", dev)
    wc = _operand(w, ct, (K, N), "w", dev)
    lib = _kernel_lib()
    f32 = torch.float32
    rp, gemm = pl["rows"], pl["gemm"]
    G = rp["grid"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        dx = torch.empty_like(xf)
        gp = torch.empty((M, N), dtype=ct, device=dev)
        db_rows = (torch.empty((R, N), dtype=f32, device=dev) if per_ray
                   else None)
        db_part = (None if per_ray else
                   torch.empty((G, N), dtype=f32, device=dev))
        ptrs = (ctypes.c_void_p * 7)(*(
            None if t is None else t.data_ptr()
            for t in (wc, yf, gf, gp, dx, db_rows, db_part)))
        dims = (ctypes.c_longlong * 8)(M, S, K, N, G, rp["smem"],
                                       rp["tile_rows"], int(rp["w_in_smem"]))
        f32_flag = int(ct == f32)
        _check(lib, lib.layer_bwd_rows(ptrs, dims, f32_flag, stream),
               "row pass launch")
        # dw = x^T gp over all rows
        dw = torch.empty((K, N), dtype=f32, device=dev)
        part = torch.empty((gemm["part_floats"],), dtype=f32, device=dev)
        rows = plan.xtg_rows(gemm, [(xf.data_ptr(), K, gp.data_ptr(), N,
                                     dw.data_ptr())], part.data_ptr())
        _check(lib, lib.layer_bwd_xtg((ctypes.c_longlong * len(rows))(*rows),
                                      1, f32_flag, stream),
               "dw product launch")
        if not per_ray:
            db = torch.empty((N,), dtype=f32, device=dev)
            _check(lib, lib.layer_bwd_sum((ctypes.c_longlong * 4)(
                db_part.data_ptr(), db.data_ptr(), G, N), 1, stream),
                   "db sum launch")
    linear_relu_bwd.launches += 1
    db = db_rows.view(R, 1, N) if per_ray else db
    return dx[..., :K0], dw[:K0, :N0], db[..., :N0]


def _check(lib, err, what):
    if err:
        raise RuntimeError(f"K4 {what} failed: CUDA error {err} "
                           f"({lib.layer_bwd_error_string(err).decode()})")


def linear_relu_bwd(x, w, b, y, g, cd=None):
    """(dx, dw, db) of ``y = relu(x @ w + b)``, as
    ``linear_relu_bwd_plain`` returns them, for x [..., K], w [K, N] and
    b [N] or per-ray [R, 1, N] with x [R, S, K].  Launches K4 for CUDA
    tensors (bf16 operands with ``cd`` bfloat16, or f32 with ``cd``
    None; any K and N, see ``plan.k4_layout``) and runs the plain version
    for CPU tensors."""
    if x.device.type == "cuda":
        return _layer_bwd_cuda(x, w, b, y, g, cd)
    if x.device.type == "cpu":
        return linear_relu_bwd_plain(x, w, b, y, g, cd)
    raise ValueError(f"no K4 for device {x.device}")


linear_relu_bwd.launches = 0
