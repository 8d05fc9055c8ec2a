"""The products of the ray-structured trunk and its layer kernels' plain
versions (``models/ray_structured.py``, ``ops/layer_fwd.py``,
``ops/layer_bwd.py``): JAX ``jnp.dot`` of compute-dtype operands with
``preferred_element_type=jnp.float32``, the f32 sums of the exact
products rounded once.  ``_dot`` runs them on the tensor cores for CUDA
tensors with a 16-bit compute dtype and as the f32 product of the upcast
operands otherwise; ``_mmc`` and ``_dw`` are its forward and weight-grad
forms.
"""

from __future__ import annotations

import torch


# cuBLAS's switch (get, set) that lets a 16-bit product reduce partial
# sums in its output dtype: (allow reduced precision, allow split-K)
_REDUCTION = {
    torch.bfloat16: (
        torch._C._get_cublas_allow_bf16_reduced_precision_reduction,
        torch._C._set_cublas_allow_bf16_reduced_precision_reduction),
    torch.float16: (
        torch._C._get_cublas_allow_fp16_reduced_precision_reduction,
        torch._C._set_cublas_allow_fp16_reduced_precision_reduction),
}


def _f32_reduction_mm(a, b):
    """a @ b of 16-bit [M, K] and [K, N] with a 16-bit result, every sum
    in f32: cuBLAS's reduced-precision (split-K) reduction is off for the
    call, so the result is the f32 sum rounded once."""
    get, put = _REDUCTION[a.dtype]
    saved = get()
    put(False, saved[1])
    try:
        return torch.mm(a, b)
    finally:
        put(*saved)


def _dot(a, b, cd, dtype=torch.float32):
    """a [..., K] @ b [K, N] of operands rounded to ``cd``, with f32 sums
    and the result in ``dtype``, rounded once (JAX ``jnp.dot(a_cd, b_cd,
    preferred_element_type=jnp.float32)``).  CUDA tensors with a 16-bit
    ``cd`` run on the tensor cores: ``torch.mm(...,
    out_dtype=torch.float32)``, or a ``cd`` result straight from
    ``_f32_reduction_mm``.  Other tensors run the f32 product of the
    upcast operands, the same sums of the same exact products.
    ``_dot.routes`` counts the products by route."""
    a, b = a.to(cd), b.to(cd)
    if not (a.is_cuda and cd in _REDUCTION):
        _dot.routes["upcast"] += 1
        return (a.float() @ b.float()).to(dtype)
    _dot.routes["tensor_core"] += 1
    a2 = a.reshape(-1, a.shape[-1])
    if dtype == cd:
        y = _f32_reduction_mm(a2, b)
    else:
        y = torch.mm(a2, b, out_dtype=torch.float32).to(dtype)
    return y.reshape(*a.shape[:-1], b.shape[-1])


_dot.routes = {"tensor_core": 0, "upcast": 0}


def _mmc(x, w, cd):
    """x @ w: ``cd`` inputs, f32 sums, a ``cd`` result; plain f32 when
    ``cd`` is None."""
    if cd is None:
        return x @ w
    return _dot(x, w, cd, cd)


def _dw(x, g, cd):
    """x^T @ g over every leading axis, f32 sums and result, of ``cd``
    operands (plain f32 when ``cd`` is None)."""
    x2, g2 = x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1])
    if cd is None:
        return x2.float() @ g2.float()
    return _dot(x2, g2, cd)
