"""The forward of one linear + relu layer as one kernel
(``csrc/layer_fwd.cu``), for JAX ``_dot_add_relu``'s forward
(``codenerf_tpu/models/ray_structured.py``).

For x [..., K], w [K, N] and b a bias [N] or per-ray rows [R, 1, N] with
x [R, S, K], in the compute dtype ``cd``:

    y   = cd(x_cd @ w_cd)          f32 sums, rounded once
    out = relu(cd(y + b_cd))       the bias added in ``cd``

``linear_relu_fwd_plain`` is that in plain PyTorch: three launches on the
card (the product, a broadcast add, a relu), each a full pass over the
[rows, N] result.  The kernel computes the product on the tensor cores and
applies both roundings and the relu in its epilogue, before its one store:
x is read once and the output written once.

``fused_route`` decides from the inputs alone whether a call can take the
kernel: CUDA tensors, a bf16 ``cd``, and widths in its plan
(``plan.layer_fwd_fits``).  ``models/ray_structured.py::_DotAddRelu``
sends those calls to ``linear_relu_fwd`` (through this module's name, so
``ops.plain_versions`` can rebind it) and every other call to the plain
version.  ``linear_relu_fwd`` launches the kernel for CUDA tensors, runs
the plain version for CPU tensors, and counts its launches
(``linear_relu_fwd.launches``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from codenerf_tpu_torch.ops import _build, plan, products


def linear_relu_fwd_plain(x, w, b, cd):
    """relu(x @ w + b) with JAX ``_dot_add_relu``'s cast points: the
    product through ``products._mmc`` (a ``cd`` result; plain f32
    when ``cd`` is None), then the bias added in the result's dtype."""
    y = products._mmc(x, w, cd)
    return torch.relu(y + b.to(y.dtype))


def fused_route(x, w, b, cd) -> bool:
    """Whether ``linear_relu_fwd`` launches the kernel for these inputs:
    CUDA tensors, ``cd`` bfloat16, and shapes the kernel's plan takes."""
    return (x.device.type == "cuda" and cd == torch.bfloat16
            and plan.layer_fwd_fits(tuple(x.shape), tuple(w.shape),
                                    tuple(b.shape)))


@functools.cache
def _kernel_lib():
    """The kernel's library, built on first use, with its entry typed."""
    lib = _build.load("layer_fwd")
    ptr = ctypes.c_void_p
    lib.layer_fwd.argtypes = [ptr, ptr, ptr]
    lib.layer_fwd.restype = ctypes.c_int
    lib.layer_fwd_error_string.argtypes = [ctypes.c_int]
    lib.layer_fwd_error_string.restype = ctypes.c_char_p
    return lib


def padded_wt(w, cd, k_pad: int):
    """w [K, N] as the kernel reads it: w^T [N, k_pad] in ``cd``,
    contiguous, zero past K (a padded column of x meets zero weights, so
    the padding is exact)."""
    wt = w.t().to(cd)
    if k_pad != w.shape[0]:
        wt = F.pad(wt, (0, k_pad - w.shape[0]))
    return wt.contiguous()


def _aligned(t):
    """``t`` contiguous and 16-byte aligned, for the kernel's vector loads
    (an unaligned view is copied)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _layer_fwd_cuda(x, w, b, cd):
    if not fused_route(x, w, b, cd):
        raise ValueError(f"the fused linear + relu forward takes CUDA "
                         f"tensors, cd bfloat16 and widths in its plan, got "
                         f"x {tuple(x.shape)} on {x.device}, w "
                         f"{tuple(w.shape)}, b {tuple(b.shape)}, cd {cd}")
    dev = x.device
    K, N = w.shape
    M = x.numel() // K
    per_ray = b.dim() == 3
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pl = plan.layer_fwd_plan(M, K, N, n_sm)
    xc = _aligned(x.to(cd))
    wt = _aligned(padded_wt(w, cd, pl["k_pad"]))
    bc = _aligned(b.to(cd))
    for name, t in (("w", wt), ("b", bc)):
        if t.device != dev:
            raise ValueError(f"the fused forward's {name} is on {t.device}, "
                             f"x on {dev}")
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        y = torch.empty((*x.shape[:-1], N), dtype=cd, device=dev)
        ptrs = (ctypes.c_void_p * 4)(xc.data_ptr(), wt.data_ptr(),
                                     bc.data_ptr(), y.data_ptr())
        dims = (ctypes.c_longlong * 9)(M, x.shape[1] if per_ray else 1, K,
                                       pl["k_pad"], N, pl["grid"],
                                       pl["smem"], int(per_ray),
                                       pl["stages"])
        err = lib.layer_fwd(ptrs, dims,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"the fused linear + relu forward failed to "
                           f"launch: CUDA error {err} "
                           f"({lib.layer_fwd_error_string(err).decode()})")
    linear_relu_fwd.launches += 1
    return y


def linear_relu_fwd(x, w, b, cd):
    """relu(x @ w + b) as ``linear_relu_fwd_plain`` computes it: the kernel
    for CUDA tensors (a call ``fused_route`` takes; any other raises), the
    plain version for CPU tensors."""
    if x.device.type == "cuda":
        return _layer_fwd_cuda(x, w, b, cd)
    if x.device.type == "cpu":
        return linear_relu_fwd_plain(x, w, b, cd)
    raise ValueError(f"no fused linear + relu forward for device {x.device}")


linear_relu_fwd.launches = 0
