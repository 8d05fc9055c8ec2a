"""Work of the port's kernels and of the model, from shapes alone.

Frozen copies of ``chip_smoke.py``'s ``k1_cost``, ``bwd_cost``,
``k4_cost`` and ``bound_ms`` (written against shapes instead of packed
weight tensors, with the same counts), a frozen-trunk K2 case, and the
model FLOPs behind ``train_mfu`` and ``tto_mfu``.  Each byte is counted
once: inputs read once, outputs written once.  Peaks are NVIDIA's H100
SXM data sheet (dense): 989 TFLOP/s bf16, 67 TFLOP/s f32 outside the
tensor cores, 3.35 TB/s HBM3.

Shapes: ``h`` hidden width, ``s`` shape-code width (fc_out's feature
columns), ``F`` xyz bands, ``R`` rays, ``S`` samples per ray.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# the device kernels of each port kernel, by name substring (chip_smoke's
# PROFILE_LABELS): K2 a row pass plus the dW products of xtg.cuh, K4 a row
# pass plus the same products
XTG = ("xtg_wgmma_kernel", "xtg_simt_kernel", "xtg_reduce")
KERNELS = {
    "K1": ("trunk_fwd_kernel",),
    "K2": ("trunk_bwd_rows_wgmma", "trunk_bwd_rows_kernel", *XTG),
    "K4": ("layer_bwd_rows", *XTG),
}


def _weight_bytes(h: int, s: int, F: int, has_x: bool = True) -> int:
    """K1's trunk weights in bf16 (w1s, w1c, w1x, w2, wof, wos, wd, wd2,
    wr), b1 and bd2 in bf16, the f32 bands."""
    n = (2 * 3 * F * h + (3 * h if has_x else 0) + h * h + h * s + h
         + s * h + h * h + h * 3)
    return 2 * n + 2 * (2 * h) + 4 * F


def _row_width(h: int, s: int) -> int:
    """Per-ray rows K1 adds: zs1p (h), featp (s), sigp (1), dirp (h),
    zt1p (3)."""
    return 2 * h + s + 4


def k1_cost(R: int, S: int, h: int, s: int, F: int, has_x: bool = True
            ) -> dict:
    """One K1 launch: bf16 product FLOPs, f32 encode operations (a
    multiply, a sin and a cos per argument) and bytes."""
    macs = (2 * 3 * F * h + (3 * h if has_x else 0) + h * h + h * s + h
            + s * h + h * h + 3 * h)
    rows = R * S
    return {"bf16_flops": 2 * macs * rows, "f32_ops": 9 * F * rows,
            "bytes": rows * 12 + rows * 16 + _row_width(h, s) * R * 2
            + _weight_bytes(h, s, F, has_x)}


def bwd_cost(R: int, S: int, h: int, s: int, F: int, stored: bool = False,
             need_dw: bool = True, has_x: bool = True) -> dict:
    """One K2 (``stored``: K3) launch: the dx and, with ``need_dw``, dW
    products, plus K2's recompute of K1's hidden layers; f32 encode and
    g_pts operations; bytes (weight grads written only with
    ``need_dw``: a frozen trunk's call writes none)."""
    x = 3 * h if has_x else 0
    hidden = 2 * 3 * F * h + x + h * h + h * s + s * h + h * h
    dx = 3 * h + h * h + h * s + s * h + h + h * h + 2 * 3 * F * h + x
    dw = 3 * h + h + h * h + s * h + h * s + h * h + 2 * 3 * F * h + x
    macs = dx + (dw if need_dw else 0) + (0 if stored else hidden)
    rows = R * S
    grad_bytes = 4 * (2 * 3 * F * h + x + 2 * h * h + 2 * h * s + h
                      + 3 * h + 2 * h) if need_dw else 0
    act_bytes = rows * (4 * h + s) * 2 if stored else 0
    return {"bf16_flops": 2 * macs * rows,
            "f32_ops": (2 * 9 * F + 5 * 3 * F) * rows,
            "bytes": rows * (12 + 16 + 12) + act_bytes
            + R * _row_width(h, s) * 6 + _weight_bytes(h, s, F, has_x)
            + grad_bytes}


def k4_cost(M: int, R: int, K: int, N: int, per_ray: bool, es: int = 2
            ) -> dict:
    """One K4 launch over M rows: the dx and dw products (bf16 FLOPs, or
    f32 operations for 4-byte operands) and bytes: x, y, g and w read
    once, dx, dw and db written once."""
    flops = 4 * M * K * N
    db = R * N * 4 if per_ray else N * 4
    return {"bf16_flops": flops if es == 2 else 0,
            "f32_ops": flops if es == 4 else 0,
            "bytes": M * (2 * K + 2 * N) * es + K * N * es + K * N * 4 + db}


def total(costs) -> dict:
    costs = list(costs)
    return {k: sum(c[k] for c in costs) for k in costs[0]}


def bound_ms(cost: dict) -> tuple:
    """(least ms on the card, "operations" or "bytes")."""
    t_ops = max(cost["bf16_flops"] / PEAK_BF16, cost["f32_ops"] / PEAK_F32)
    t_bytes = cost["bytes"] / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ------------------------------------------------ per step, from a cell

def k1_step(sh: dict) -> dict:
    """K1's work in one step: one launch per pass at the step's rays."""
    return total(k1_cost(sh["rays"], S, sh["h"], sh["s"], sh["F"])
                 for S in sh["samples"])


def k2_step(sh: dict, need_dw: bool = True) -> dict:
    """K2's work in one step: one launch per pass; a frozen trunk (TTO)
    has no dW work."""
    return total(bwd_cost(sh["rays"], S, sh["h"], sh["s"], sh["F"],
                          need_dw=need_dw) for S in sh["samples"])


def _skips(sh: dict) -> list:
    """The skip layers that exist: a skip id at or past the trunk's
    num_layers - 1 layers is inert, as in the reference."""
    return [i for i in sh["skips"] if i < sh["num_layers"] - 1]


def k4_step(sh: dict) -> dict:
    """K4's work in one vanilla-NeRF step: in each pass of each ray chunk,
    every non-skip trunk layer after the first and fc_feat (a bias, K = N
    = h) and layer_dir1's feature half (per-ray rows, N = h / 2)."""
    h, rc = sh["h"], sh["rays"] // sh["chunks"]
    bias = sh["num_layers"] - 1 - len(_skips(sh)) + 1
    per_pass = [(k4_cost(rc * S, rc, h, h, False), bias)
                for S in sh["samples"]]
    per_pass += [(k4_cost(rc * S, rc, h, h // 2, True), 1)
                 for S in sh["samples"]]
    return {k: sh["chunks"] * sum(n * c[k] for c, n in per_pass)
            for k in per_pass[0][0]}


def codenerf_macs(sh: dict) -> tuple:
    """(per-sample, per-ray) multiply-adds of CodeNeRF's forward in its
    ray-structured form: every concat layer as a per-sample product plus
    a per-ray product broadcast over the samples."""
    h, s, t, dx, dd = sh["h"], sh["s"], sh["t"], sh["dim_xyz"], sh["dim_dir"]
    per_sample = dx * h + h * h + h * (s + 1) + s * h + h * h + h * 3
    per_ray = (s * s + s * s + t * t + s * h + s * (s + 1) + dd * h
               + t * 3)
    return per_sample, per_ray


def flexible_macs(sh: dict) -> tuple:
    """(per-sample, per-ray) multiply-adds of vanilla NeRF's forward:
    the trunk, the skip layer's extra input, fc_feat, fc_alpha, the
    feature half of layer_dir1 and fc_rgb per sample; the direction half
    of layer_dir1 per ray."""
    h, dx, dd = sh["h"], sh["dim_xyz"], sh["dim_dir"]
    per_sample = (dx * h + (sh["num_layers"] - 1) * h * h
                  + len(_skips(sh)) * dx * h + h * h + h + h * (h // 2)
                  + (h // 2) * 3)
    return per_sample, dd * (h // 2)


def model_flops(sh: dict, weight_grads: bool = True) -> float:
    """Model FLOPs of one step over both networks and every pass: the
    forward, the input grads and, with ``weight_grads``, the weight
    grads, 2 FLOPs a multiply-add each.  Recomputation is not counted."""
    macs = codenerf_macs if sh["model"] == "codenerf" else flexible_macs
    per_sample, per_ray = macs(sh)
    fwd = sum(sh["rays"] * (S * per_sample + per_ray) for S in sh["samples"])
    return 2 * fwd * (3 if weight_grads else 2)
