#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``codenerf_tpu_torch``).

Drives the port's serving render, train step and test-time optimization
(TTO) on one NVIDIA card at the flagship width of
``configs/srn-cars-code.yml`` (values from ``SRN_CARS_CODE``, so no YAML
is read) with random weights from a seed:

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile K1 (``ops/csrc/trunk_fwd.cu``), K2 / K3
               (``ops/csrc/trunk_bwd.cu``) and K4 (``ops/csrc/layer_bwd.cu``)
               with one nvcc each, started together, into
               ``build/torch_kernels/``; print ptxas's registers and spills.
  3. kernels — K1, K2, K3 and K4 against their plain PyTorch versions on
               the card at the main paths' shapes (the render's R = 4096
               rays and the train step's R = 16384, S = 32 and 160; K4 also
               at R = 1000, S = 24, a masked tail tile): max abs error and
               relRMS of every output (gate 1e-2 in bf16), K1-K4
               bit-identical across two calls; K1-K4 also in f32 (gate
               1e-4: both sum in f32, in other orders); kernel, plain and
               library times (CUDA events around back-to-back calls)
               beside the bound (K1: the kernel on inputs packed once, and
               its wrapper, which packs them every call; its share of the
               bf16 peak).
  4. render  — one 128x128 image through ``make_image_renderer`` on CUDA
               with K1 (``use_pallas``; K1's launch count must rise by
               exactly 8), the same image with the plain trunk (PSNR gate
               40 dB), and a 16x16 image on the card against the port's
               CPU path (40 dB); then the same image with the YAML's own
               flags, through the ray-structured forward (ms per image,
               PSNR against the K1 image; 16x16 card against CPU, 40 dB).
  5. profile — one more render under ``torch.profiler``: device busy
               time by kernel, K1's share, the idle share.
  6. train   — the flagship train step from a seeded student with 8
               objects on 4 targets a seeded teacher renders, in four modes
               named by their runtime flags: fused (``use_pallas`` +
               ``pallas_backward``: K1 + K2), hybrid (``pallas_hybrid``:
               K3), xla (the YAML's own runtime: the ray-structured path
               with remat) and layer_bwd (the same with
               ``pallas_layer_bwd``: K4).  (a) one step of 4 x 4096 rays
               with the kernels against the same step on the plain
               versions (gradient relRMS gate 1e-2 per leaf; layer_bwd also
               against the xla step), (b) 30 steps of 4 x 4096 rays
               (launches per step, ms per step, rays/s; the fine loss must
               fall), (c) one fused, one hybrid and one layer_bwd step
               under ``torch.profiler`` (a kernel's device time sums all of
               its launches: K2 / K3 are a row pass and the dW products,
               K4 a row pass and the dw product); then f32: one step each
               in fused and hybrid mode against the plain-version step
               (gradient relRMS gate 1e-4 per leaf, finite loss) and one
               step on the ray-structured path (finite loss).
  7. tto     — test-time optimization of codes and pose with the seeded
               model frozen, from the mean codes of a 2458-object table
               (the SRN cars train count), on 4 targets the model renders
               at theta 1.2, phi linspace(-2, 2, 4), rho 1.3, from 1.57 /
               0 / 1.30: in each train mode, (a) one batched step of 4 x
               4096 rays with the kernels against the same step on the
               plain versions (the loss within 1e-3, the z_s, z_t, theta,
               phi and rho gradients at relRMS <= 1e-2; layer_bwd also
               against xla), (b) 30 steps (ms per step, rays/s, TTO steps/s,
               launches per step, the fine loss must fall, the mean pose
               error), (c) fused, hybrid and layer_bwd profiles (K2 / K3
               split into the row pass and the dW products nobody reads);
               single TTO of 4096 rays (ms per step, a profile) and batched
               K = 1
               against it from one generator (rtol 2e-5 on the codes, 1e-5
               on theta, the loss and the pose error); f32 fused and hybrid
               steps against the plain versions (gate 1e-4); 5 multi-view
               steps (2 objects x 2 views), then 5 SE(3) refine steps from
               the fused run's state and 5 multi-view SE(3) refine steps
               (xi starts at 0, every loss finite).
  8. result  — the kernel table as one JSON line (with each kernel's
               launches per TTO step), the card line, and the last line
               ``{"ok": true, "device": {...}}``.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Any failure
raises and exits nonzero without the last line.  Imports only torch, numpy,
the standard library and ``codenerf_tpu_torch``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from codenerf_tpu_torch.config import SRN_CARS_CODE, config_from_dict
from codenerf_tpu_torch.core import mse2psnr, pixel_directions, pose_spherical
from codenerf_tpu_torch.eval import (
    init_batched_tto_state, init_multiview_se3_refine_state,
    init_multiview_tto_state, init_se3_refine_state, init_tto_state,
    make_batched_tto_step, make_image_renderer,
    make_multiview_se3_refine_step, make_multiview_tto_step,
    make_se3_refine_step, make_tto_step)
from codenerf_tpu_torch.models import CodeNeRF, CodeTables, lookup_codes
from codenerf_tpu_torch.ops import _build, fused, layer_bwd
from codenerf_tpu_torch.ops.fused import (PER_RAY_KEYS, hybrid_forward_plain,
                                          kernel_weights, per_ray_parts,
                                          trunk_backward,
                                          trunk_backward_plain, trunk_forward,
                                          trunk_forward_plain)
from codenerf_tpu_torch.ops.layer_bwd import (linear_relu_bwd,
                                              linear_relu_bwd_plain)
from codenerf_tpu_torch.core.encoding import positional_encoding
from codenerf_tpu_torch.pipeline import RenderSettings, trunk_path
from codenerf_tpu_torch.train import init_train_state, make_train_step

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# outside them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
REL_RMS_GATE = 1e-2
F32_REL_RMS_GATE = 1e-4     # f32 kernels against f32 plain versions
PSNR_GATE = 40.0
SRN_FOCAL_128 = 131.25      # SRN cars intrinsics at 128x128, cx = cy = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


@contextlib.contextmanager
def plain_versions():
    """Rebind the kernels' wrappers to their plain versions, so that the
    port's own entry points run the same path on the card without the
    kernels."""
    saved = (fused.trunk_forward, fused.trunk_backward,
             layer_bwd.linear_relu_bwd)
    fused.trunk_forward = fused.trunk_forward_plain
    fused.trunk_backward = fused.trunk_backward_plain
    layer_bwd.linear_relu_bwd = linear_relu_bwd_plain
    try:
        yield
    finally:
        (fused.trunk_forward, fused.trunk_backward,
         layer_bwd.linear_relu_bwd) = saved


def launch_counts() -> dict:
    return {"K1": trunk_forward.launches,
            "K2": trunk_backward.launches_recompute,
            "K3": trunk_backward.launches_stored,
            "K4": linear_relu_bwd.launches}


def reset_launch_counts():
    trunk_forward.launches = 0
    trunk_backward.launches_recompute = 0
    trunk_backward.launches_stored = 0
    linear_relu_bwd.launches = 0


def time_ms(fn, calls=10, repeats=5, warmup=3) -> float:
    """Device time of one call of ``fn`` in ms: CUDA events around
    ``calls`` back-to-back calls (so the host's enqueue hides behind the
    device's work), the median of ``repeats`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def k1_cost(R, S, weights, per_ray, F) -> dict:
    """Work of one K1 launch on these inputs: bf16 product FLOPs, f32
    encode operations (a multiply, a sin and a cos per argument), and the
    bytes it must move (each input read once, the output written once)."""
    h, sc = weights["wof"].shape
    has_x = weights["w1x"] is not None
    macs = (2 * 3 * F * h + (3 * h if has_x else 0) + h * h + h * sc + h
            + sc * h + h * h + 3 * h)
    rows = R * S
    weight_bytes = sum(w.numel() * 2 for k, w in weights.items()
                       if k not in ("E", "b1", "bd2") and w is not None)
    weight_bytes += 2 * (2 * h) + 4 * F        # b1, bd2 in bf16; f32 bands
    row_bytes = sum(per_ray[k].shape[-1] for k in per_ray) * R * 2
    return {"bf16_flops": 2 * macs * rows, "f32_ops": 9 * F * rows,
            "bytes": rows * 12 + rows * 16 + row_bytes + weight_bytes}


def bound_ms(cost) -> tuple:
    t_ops = max(cost["bf16_flops"] / PEAK_BF16, cost["f32_ops"] / PEAK_F32)
    t_bytes = cost["bytes"] / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def profile_call(fn, args, unprofiled_ms, kernels: dict) -> dict:
    """Device time by kernel over one call of ``fn`` under
    ``torch.profiler`` (one stream, so the sum of kernel times is the busy
    time), and for each label of ``kernels`` the time of every device
    kernel whose name holds one of its substrings (a port kernel that runs
    as several launches, such as K2's row pass and dW products, counts
    them all).  Only device-side entries count: an operator's own entry
    repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    busy = sum(by_name.values())
    kernel_ms = {label: sum(v for k, v in by_name.items()
                            if any(sub in k for sub in subs))
                 for label, subs in kernels.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "unprofiled_ms": unprofiled_ms,
            "idle_share": (1 - busy / unprofiled_ms) if busy else None,
            "kernel_ms": kernel_ms,
            "kernel_share_of_busy": {k: v / busy if busy else None
                                     for k, v in kernel_ms.items()},
            "n_kernel_names": len(by_name),
            "top": [[k[:80], v] for k, v in top]}


def profile_step(label, step, args, step_ms, labels, card) -> dict:
    """``profile_call`` over one step, printed as the ``<label> profile``
    line and a JSON line."""
    prof = profile_call(step, args, step_ms, labels)
    if prof["device_busy_ms"]:
        print(f"{label} profile: device busy {prof['device_busy_ms']:.6g} ms "
              f"per step against the unprofiled {step_ms:.6g} ms (idle share "
              f"{prof['idle_share']:.4g}); kernel ms {prof['kernel_ms']}, "
              f"share of busy {prof['kernel_share_of_busy']} on {card}",
              flush=True)
    else:
        print(f"{label} profile: torch.profiler recorded no device time: "
              f"the breakdown is not measured", flush=True)
    print(json.dumps({f"{label.replace(' ', '_')}_profile": prof}),
          flush=True)
    return prof


def trunk_forward_library(pts, per_ray, weights):
    """The library yardstick of K1: the plain chain of
    ``trunk_forward_plain`` with every product a bf16 cuBLAS GEMM (f32
    accumulation, bf16 out) and the same elementwise ops.  Timed only;
    nothing on the port's path calls it."""
    bf = torch.bfloat16
    R, S = pts.shape[:2]
    N = R * S

    def mm(x, w):
        return x.to(bf) @ w.to(bf)

    def rep(k):
        return per_ray[k].to(bf).repeat_interleave(S, dim=0)

    bands = weights["E"][0, 0::3].float()
    scaled = (pts[..., None, :] * bands[:, None]).reshape(N, -1)
    h = mm(torch.sin(scaled), weights["w1s"]) + mm(torch.cos(scaled),
                                                   weights["w1c"])
    if weights["w1x"] is not None:
        h = h + mm(pts.reshape(N, 3), weights["w1x"])
    h1 = torch.relu(h + weights["b1"].to(bf))
    h2 = torch.relu(mm(h1, weights["w2"]) + rep("zs1p"))
    feat = mm(h2, weights["wof"]) + rep("featp")
    sigma = mm(h2, weights["wos"]).float() + rep("sigp").float()
    v1 = torch.relu(mm(feat, weights["wd"]) + rep("dirp"))
    v2 = torch.relu(mm(v1, weights["wd2"]) + weights["bd2"].to(bf))
    rgb = mm(v2, weights["wr"]).float() + rep("zt1p").float()
    return torch.cat([rgb, sigma], dim=-1).reshape(R, S, 4)


def bwd_cost(R, S, weights, per_ray, F, stored) -> dict:
    """Work of one K2 (or, ``stored``, K3) launch on these inputs: bf16
    product FLOPs (the dx and dW products, plus K2's recompute of K1's
    hidden layers), f32 encode and g_pts operations, and the bytes it must
    move (each input read once, each output written once; the per-block
    slabs are scratch)."""
    h, sc = weights["wof"].shape
    x = 3 * h if weights["w1x"] is not None else 0
    hidden = 2 * 3 * F * h + x + h * h + h * sc + sc * h + h * h
    dx = 3 * h + h * h + h * sc + sc * h + h + h * h + 2 * 3 * F * h + x
    dw = 3 * h + h + h * h + sc * h + h * sc + h * h + 2 * 3 * F * h + x
    macs = dx + dw + (0 if stored else hidden)
    rows = R * S
    weight_bytes = sum(w.numel() * 2 for k, w in weights.items()
                       if k not in ("E", "b1", "bd2") and w is not None)
    weight_bytes += 2 * (2 * h) + 4 * F
    grad_bytes = 4 * (2 * 3 * F * h + x + 2 * h * h + 2 * h * sc + h
                      + 3 * h + 2 * h)
    row_width = sum(per_ray[k].shape[-1] for k in per_ray)
    act_bytes = rows * (4 * h + sc) * 2 if stored else 0
    return {"bf16_flops": 2 * macs * rows,
            "f32_ops": (2 * 9 * F + 5 * 3 * F) * rows,
            "bytes": rows * (12 + 16 + 12) + act_bytes + R * row_width * 6
            + weight_bytes + grad_bytes}


def trunk_backward_library(pts, per_ray, b1, weights, g, acts=None):
    """The library yardstick of K2 (K3 with ``acts``): the plain chain of
    ``trunk_backward_plain`` with every product a bf16 cuBLAS GEMM (f32
    accumulation, bf16 out) and the same elementwise ops.  Timed only;
    nothing on the port's path calls it."""
    bf, f32 = torch.bfloat16, torch.float32
    R, S = pts.shape[:2]
    N = R * S

    def mm(x, w):
        return x.to(bf) @ w.to(bf)

    def mm_t(x, w):
        return x.to(bf) @ w.to(bf).t()

    def d_w(x, y):
        return x.to(bf).t() @ y.to(bf)

    def zero_dead(a, v):
        return torch.where(a > 0, v,
                           torch.zeros((), dtype=bf, device=a.device))

    bands = weights["E"][0, 0::3].float()
    scaled = (pts[..., None, :] * bands[:, None]).reshape(N, -1)
    sn, cs = torch.sin(scaled), torch.cos(scaled)
    pts2 = pts.reshape(N, 3)
    if acts is None:
        def rep(k):
            return per_ray[k].to(bf).repeat_interleave(S, dim=0)
        h = mm(sn, weights["w1s"]) + mm(cs, weights["w1c"])
        if weights["w1x"] is not None:
            h = h + mm(pts2, weights["w1x"])
        h1 = torch.relu(h + b1.to(bf))
        h2 = torch.relu(mm(h1, weights["w2"]) + rep("zs1p"))
        feat = mm(h2, weights["wof"]) + rep("featp")
        v1 = torch.relu(mm(feat, weights["wd"]) + rep("dirp"))
        v2 = torch.relu(mm(v1, weights["wd2"]) + weights["bd2"].to(bf))
    else:
        h1, h2, feat, v1, v2 = (acts[k] for k in ("h1", "h2", "feat", "v1",
                                                  "v2"))
    g = g.reshape(N, 4).to(f32)
    g_rgb, g_sig = g[:, :3], g[:, 3:]
    g_v2 = zero_dead(v2, mm_t(g_rgb, weights["wr"]))
    g_v1 = zero_dead(v1, mm_t(g_v2, weights["wd2"]))
    g_feat = mm_t(g_v1, weights["wd"])
    g_h2 = zero_dead(h2, mm_t(g_feat, weights["wof"])
                     + mm_t(g_sig, weights["wos"]))
    g_h1 = zero_dead(h1, mm_t(g_h2, weights["w2"]))
    g_scaled = (mm_t(g_h1, weights["w1s"]).float() * cs
                - mm_t(g_h1, weights["w1c"]).float() * sn).reshape(N, -1, 3)
    g_pts = (g_scaled * bands[:, None]).sum(dim=1)
    if weights["w1x"] is not None:
        g_pts = g_pts + mm_t(g_h1, weights["w1x"]).float()

    def ray_sum(x):
        return x.float().reshape(R, S, -1).sum(dim=1)

    per = [ray_sum(v) for v in (g_h2, g_feat, g_sig, g_v1, g_rgb)]
    dws = [d_w(sn, g_h1), d_w(cs, g_h1), d_w(h1, g_h2), d_w(h2, g_feat),
           d_w(h2, g_sig), d_w(feat, g_v1), d_w(v1, g_v2), d_w(v2, g_rgb),
           g_v2.float().sum(dim=0), g_h1.float().sum(dim=0)]
    if weights["w1x"] is not None:
        dws.append(d_w(pts2, g_h1))
    return g_pts, per, dws


def bwd_outputs(res) -> dict:
    """The outputs of a trunk backward, by name."""
    g_pts, g_per_ray, db1, dw = res
    out = {"g_pts": g_pts, "db1": db1}
    out.update({f"g_{k}": g_per_ray[k] for k in PER_RAY_KEYS})
    out.update({f"d{k}": v for k, v in dw.items() if v is not None})
    return out


def check_bwd(settings, model, ro, rd, zs, zt, card) -> dict:
    """K2 and K3 against their plain version on the card: every output at
    R = 4096 rays and at the train step's R = len(ro) rays, S = 32 and 160
    (relRMS gate, bit-identity across two calls), and kernel, plain and
    library (``trunk_backward_library``) times at the train step's R."""
    cfg = model.cfg
    F = settings.num_encoding_fn_xyz
    R_step = ro.shape[0]
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dir_enc = positional_encoding(viewdirs, settings.num_encoding_fn_dir,
                                  settings.include_input_dir,
                                  settings.log_sampling_dir)
    with torch.no_grad():
        per_ray_all = per_ray_parts(model, dir_enc, zs, zt)
        weights = kernel_weights(model, F, settings.log_sampling_xyz)
    b1 = weights["b1"]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    out = {"K2": [], "K3": []}
    for S in (settings.num_coarse, settings.num_coarse + settings.num_fine):
        z = torch.sort(settings.near + (settings.far - settings.near)
                       * torch.rand(R_step, S, generator=gen), dim=-1).values
        pts_all = (ro[:, None, :] + rd[:, None, :]
                   * z.cuda()[..., None]).contiguous()
        g_all = torch.randn(R_step, S, 4, generator=gen).cuda()
        for R in sorted({min(4096, R_step), R_step}):
            pts, g = pts_all[:R].contiguous(), g_all[:R].contiguous()
            per_ray = {k: v[:R] for k, v in per_ray_all.items()}
            with torch.no_grad():
                _, acts = hybrid_forward_plain(pts, per_ray, weights,
                                               compute_dtype=cfg.cdtype)
            for name, a in (("K2", None), ("K3", acts)):
                def kern():
                    return trunk_backward(pts, per_ray, b1, weights, g, a,
                                          compute_dtype=cfg.cdtype)

                def plain():
                    return trunk_backward_plain(pts, per_ray, b1, weights,
                                                g, a,
                                                compute_dtype=cfg.cdtype)

                got, again, want = (bwd_outputs(f())
                                    for f in (kern, kern, plain))
                torch.cuda.synchronize()
                errs = {}
                for k, w in want.items():
                    d = got[k] - w
                    errs[k] = (float(d.abs().max()),
                               float(torch.linalg.norm(d)
                                     / torch.linalg.norm(w)))
                    if not bool(torch.isfinite(got[k]).all()):
                        raise RuntimeError(f"{name} {k} is not finite at "
                                           f"R={R}, S={S}")
                    if not torch.equal(got[k], again[k]):
                        raise RuntimeError(f"{name} {k} differs between "
                                           f"two calls at R={R}, S={S}")
                worst = max(errs, key=lambda k: errs[k][1])
                print(f"{name} R={R} S={S}: every output bit-identical "
                      f"across two calls; max_abs_err / rel_rms: "
                      + ", ".join(f"{k} {v[0]:.3g}/{v[1]:.3g}"
                                  for k, v in errs.items()), flush=True)
                if not errs[worst][1] <= REL_RMS_GATE:
                    raise RuntimeError(
                        f"{name} disagrees with its plain version at R={R}, "
                        f"S={S}: {worst} relRMS {errs[worst][1]} > "
                        f"{REL_RMS_GATE}")
                row = {"R": R, "S": S,
                       "max_abs_err": max(v[0] for v in errs.values()),
                       "rel_rms": errs[worst][1], "worst": worst}
                del got, again, want
                if R == R_step:
                    def library():
                        return trunk_backward_library(pts, per_ray, b1,
                                                      weights, g, a)

                    ms = time_ms(kern, calls=3, repeats=5, warmup=1)
                    plain_ms = time_ms(plain, calls=1, repeats=3, warmup=1)
                    library_ms = time_ms(library, calls=3, repeats=5,
                                         warmup=1)
                    cost = bwd_cost(R, S, weights, per_ray, F, a is not None)
                    b_ms, b_by = bound_ms(cost)
                    row.update({"ms": ms, "plain_ms": plain_ms,
                                "library_ms": library_ms,
                                "bound_ms": b_ms, "bound_by": b_by,
                                "cost": cost})
                    print(f"{name} R={R} S={S}: ms={ms:.6g} "
                          f"plain_ms={plain_ms:.6g} "
                          f"library_ms={library_ms:.6g} bound_ms={b_ms:.6g} "
                          f"({b_by}) achieved="
                          f"{cost['bf16_flops'] / ms / 1e9:.6g} TFLOP/s "
                          f"on {card}", flush=True)
                out[name].append(row)
            del acts
            torch.cuda.empty_cache()
    return out


def check_f32(settings, model, ro, rd, zs, zt, R) -> dict:
    """K1, K2 and K3 in f32 (``model`` computes in float32) against their
    plain versions at R rays, S = 32 and 160: every output at relRMS <=
    ``F32_REL_RMS_GATE`` and bit-identical across two calls."""
    F = settings.num_encoding_fn_xyz
    cd = model.cfg.cdtype
    if cd is not None:
        raise RuntimeError(f"check_f32 needs an f32 model, got {cd}")
    ro, rd, zs, zt = ro[:R], rd[:R], zs[:R], zt[:R]
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dir_enc = positional_encoding(viewdirs, settings.num_encoding_fn_dir,
                                  settings.include_input_dir,
                                  settings.log_sampling_dir)
    with torch.no_grad():
        per_ray = per_ray_parts(model, dir_enc, zs, zt)
        weights = kernel_weights(model, F, settings.log_sampling_xyz)
    b1 = weights["b1"]
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    out = {"K1": [], "K2": [], "K3": []}
    for S in (settings.num_coarse, settings.num_coarse + settings.num_fine):
        z = torch.sort(settings.near + (settings.far - settings.near)
                       * torch.rand(R, S, generator=gen), dim=-1).values
        pts = (ro[:, None, :] + rd[:, None, :]
               * z.cuda()[..., None]).contiguous()
        g = torch.randn(R, S, 4, generator=gen).cuda()
        with torch.no_grad():
            _, acts = hybrid_forward_plain(pts, per_ray, weights,
                                           compute_dtype=cd)
        cases = (("K1", lambda: {"raw": trunk_forward(
                    pts, per_ray, weights, compute_dtype=cd)},
                  lambda: {"raw": trunk_forward_plain(
                      pts, per_ray, weights, compute_dtype=cd)}),)
        for name, a in (("K2", None), ("K3", acts)):
            cases += ((name,
                       lambda a=a: bwd_outputs(trunk_backward(
                           pts, per_ray, b1, weights, g, a,
                           compute_dtype=cd)),
                       lambda a=a: bwd_outputs(trunk_backward_plain(
                           pts, per_ray, b1, weights, g, a,
                           compute_dtype=cd))),)
        for name, kern, plain in cases:
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            errs = {}
            for k, w in want.items():
                if not torch.equal(got[k], again[k]):
                    raise RuntimeError(f"f32 {name} {k} differs between two "
                                       f"calls at R={R}, S={S}")
                d = got[k] - w
                errs[k] = (float(d.abs().max()),
                           float(torch.linalg.norm(d) / torch.linalg.norm(w)))
            worst = max(errs, key=lambda k: errs[k][1])
            print(f"{name} f32 R={R} S={S}: every output bit-identical across "
                  f"two calls; worst {worst} max_abs_err "
                  f"{errs[worst][0]:.3g} rel_rms {errs[worst][1]:.3g}",
                  flush=True)
            if not errs[worst][1] <= F32_REL_RMS_GATE:
                raise RuntimeError(f"f32 {name} disagrees with its plain "
                                   f"version at R={R}, S={S}: {worst} relRMS "
                                   f"{errs[worst][1]} > {F32_REL_RMS_GATE}")
            out[name].append({"R": R, "S": S, "worst": worst,
                              "max_abs_err": max(v[0] for v in errs.values()),
                              "rel_rms": errs[worst][1]})
            del got, again, want
        del acts
        torch.cuda.empty_cache()
    return out


def k4_cost(M, R, K, N, per_ray, es) -> dict:
    """Work of one K4 launch on these inputs: the dx and dw products
    (bf16 FLOPs, or f32 operations for f32 operands), and the bytes it
    must move: x, y, g and w read once, dx, dw and db written once."""
    flops = 4 * M * K * N
    db = R * N * 4 if per_ray else N * 4
    return {"bf16_flops": flops if es == 2 else 0,
            "f32_ops": flops if es == 4 else 0,
            "bytes": M * (2 * K + 2 * N) * es + K * N * es + K * N * 4 + db}


# K4's cases: (name, R, S, per_ray, dtype); the coarse and fine shapes are
# the flagship step's (layer_xyz2 and layer_dir1 per-ray, layer_dir2 a
# bias), f32 the synth-smoke config's type, odd a masked tail tile
K4_CASES = (("coarse per-ray", 16384, 32, True, torch.bfloat16),
            ("coarse bias", 16384, 32, False, torch.bfloat16),
            ("fine per-ray", 16384, 160, True, torch.bfloat16),
            ("fine bias", 16384, 160, False, torch.bfloat16),
            ("f32 per-ray", 1024, 32, True, torch.float32),
            ("f32 bias", 1024, 32, False, torch.float32),
            ("odd per-ray", 1000, 24, True, torch.bfloat16),
            ("odd bias", 1000, 24, False, torch.bfloat16))


def check_k4(K, N, card) -> list:
    """K4 against its plain version on the card: dx, dw and db at relRMS
    <= 1e-2 (1e-4 in f32) and bit-identical across two calls, at every case of
    ``K4_CASES``; kernel, plain and library times at the flagship step's
    shapes."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 6)
    rows = []
    for name, R, S, per_ray, dt in K4_CASES:
        cd = torch.bfloat16 if dt == torch.bfloat16 else None
        bound = 1.0 / K ** 0.5
        x = torch.relu(torch.randn(R, S, K, generator=gen)).to(dt).cuda()
        w = ((torch.rand(K, N, generator=gen) * 2 - 1) * bound).cuda()
        y = torch.relu(torch.randn(R, S, N, generator=gen)).to(dt).cuda()
        g = (torch.randn(R, S, N, generator=gen) * 1e-3).to(dt).cuda()
        b = (torch.zeros(R, 1, N, dtype=dt) if per_ray
             else torch.zeros(N)).cuda()

        def kern():
            return linear_relu_bwd(x, w, b, y, g, cd)

        def plain():
            return linear_relu_bwd_plain(x, w, b, y, g, cd)

        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        errs = {}
        for key, a, a2, e in zip(("dx", "dw", "db"), got, again, want):
            if a.shape != e.shape or a.dtype != e.dtype:
                raise RuntimeError(f"K4 {name}: {key} {a.dtype} "
                                   f"{tuple(a.shape)}, plain {e.dtype} "
                                   f"{tuple(e.shape)}")
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"K4 {name}: {key} is not finite")
            if not torch.equal(a, a2):
                raise RuntimeError(f"K4 {name}: {key} differs between two "
                                   f"calls")
            d = a.float() - e.float()
            errs[key] = (float(d.abs().max()),
                         float(torch.linalg.norm(d)
                               / torch.linalg.norm(e.float())))
        del got, again, want
        worst = max(errs, key=lambda k: errs[k][1])
        row = {"case": name, "R": R, "S": S, "per_ray": per_ray,
               "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": max(v[0] for v in errs.values()),
               "rel_rms": errs[worst][1], "worst": worst}
        line = (f"K4 {name} R={R} S={S} {row['dtype']}: every output "
                f"bit-identical across two calls; max_abs_err / rel_rms: "
                + ", ".join(f"{k} {v[0]:.3g}/{v[1]:.3g}"
                            for k, v in errs.items()))
        gate = REL_RMS_GATE if dt == torch.bfloat16 else F32_REL_RMS_GATE
        if not errs[worst][1] <= gate:
            raise RuntimeError(f"K4 disagrees with its plain version in "
                               f"case {name}: {worst} relRMS "
                               f"{errs[worst][1]} > {gate}")
        if R == 16384:
            wc = w.to(dt)

            def library():
                # the same function from library calls: the mask, two
                # cuBLAS products, a column or segment sum
                gp = torch.where(y > 0, g, torch.zeros((), dtype=dt,
                                                       device="cuda"))
                gp2 = gp.view(-1, N)
                dx = gp2 @ wc.t()
                dw = x.view(-1, K).t() @ gp2
                db = gp.float().sum(dim=1 if per_ray else (0, 1))
                return dx, dw, db

            ms = time_ms(kern, calls=3, repeats=5, warmup=1)
            plain_ms = time_ms(plain, calls=1, repeats=3, warmup=1)
            library_ms = time_ms(library, calls=3, repeats=5, warmup=1)
            cost = k4_cost(R * S, R, K, N, per_ray, x.element_size())
            b_ms, b_by = bound_ms(cost)
            row.update({"ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "cost": cost})
            line += (f"; ms={ms:.6g} plain_ms={plain_ms:.6g} "
                     f"library_ms={library_ms:.6g} bound_ms={b_ms:.6g} "
                     f"({b_by}) achieved="
                     f"{cost['bytes'] / ms / 1e9:.6g} TB/s on {card}")
        print(line, flush=True)
        rows.append(row)
        del x, w, y, g, b
        torch.cuda.empty_cache()
    return rows


def phase(name, t0):
    print(f"phase {name}: done in {time.perf_counter() - t0:.2f} s",
          flush=True)


def check_k1(settings, model, ro, rd, zs, zt, chunk, card) -> dict:
    """K1 vs its plain version on the card at the main paths' shapes: the
    render's R = ``chunk`` rays and the train step's R = len(ro)."""
    cfg = model.cfg
    F = settings.num_encoding_fn_xyz
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dir_enc = positional_encoding(viewdirs, settings.num_encoding_fn_dir,
                                  settings.include_input_dir,
                                  settings.log_sampling_dir)
    with torch.no_grad():
        per_ray_all = per_ray_parts(model, dir_enc, zs, zt)
        weights = kernel_weights(model, F, settings.log_sampling_xyz)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    R_step = ro.shape[0]
    shapes = []
    for S in (settings.num_coarse, settings.num_coarse + settings.num_fine):
        z = torch.sort(settings.near + (settings.far - settings.near)
                       * torch.rand(R_step, S, generator=gen), dim=-1).values
        pts_all = (ro[:, None, :] + rd[:, None, :] * z.cuda()[..., None])
        for R in sorted({chunk, R_step}):
            pts = pts_all[:R].contiguous()
            per_ray = {k: v[:R] for k, v in per_ray_all.items()}

            def kern():
                return trunk_forward(pts, per_ray, weights,
                                     compute_dtype=cfg.cdtype)

            def plain():
                return trunk_forward_plain(pts, per_ray, weights,
                                           compute_dtype=cfg.cdtype)

            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"K1 output is not finite at R={R}, "
                                   f"S={S}")
            if not torch.equal(got, again):
                raise RuntimeError(f"K1 output differs between two calls "
                                   f"at R={R}, S={S}")
            err = (got - want).abs()
            rel_rms = float(torch.linalg.norm(got - want)
                            / torch.linalg.norm(want))
            del got, again, want
            # the kernel alone: launches on inputs the wrapper packed once;
            # the wrapper: checks, casts and packs the inputs every call
            _, launch = fused.trunk_forward_launcher(
                pts, per_ray, weights, compute_dtype=cfg.cdtype)
            ms, wrapper_ms = time_ms(launch), time_ms(kern)
            del launch
            plain_ms = time_ms(plain, calls=3)
            library_ms = time_ms(lambda: trunk_forward_library(
                pts, per_ray, weights), calls=3)
            cost = k1_cost(R, S, weights, per_ray, F)
            b_ms, b_by = bound_ms(cost)
            row = {"R": R, "S": S, "max_abs_err": float(err.max()),
                   "rel_rms": rel_rms, "ms": ms, "wrapper_ms": wrapper_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bf16_peak_share": cost["bf16_flops"] / (ms * 1e-3)
                   / PEAK_BF16, "cost": cost}
            print(f"K1 R={R} S={S}: max_abs_err={row['max_abs_err']:.6g} "
                  f"rel_rms={rel_rms:.6g}, bit-identical across two calls; "
                  f"ms={ms:.6g} wrapper_ms={wrapper_ms:.6g} "
                  f"plain_ms={plain_ms:.6g} library_ms={library_ms:.6g} "
                  f"bound_ms={b_ms:.6g} ({b_by}) "
                  f"achieved={cost['bf16_flops'] / ms / 1e9:.6g} TFLOP/s "
                  f"({row['bf16_peak_share']:.4g} of the bf16 peak) "
                  f"on {card}", flush=True)
            if not rel_rms <= REL_RMS_GATE:
                raise RuntimeError(f"K1 disagrees with its plain version at "
                                   f"R={R}, S={S}: relRMS {rel_rms} > "
                                   f"{REL_RMS_GATE}")
            shapes.append(row)
    return {"shapes": shapes}


TRAIN_STEPS = 30

# the train modes, named by their runtime flags over the YAML's own
# runtime (use_pallas false, remat true); the launches each step must make
TRAIN_MODES = {
    "fused": ({"use_pallas": True, "pallas_backward": True},
              {"K1": 2, "K2": 2, "K3": 0, "K4": 0}),
    "hybrid": ({"pallas_hybrid": True}, {"K1": 0, "K2": 0, "K3": 2, "K4": 0}),
    "xla": ({}, {"K1": 0, "K2": 0, "K3": 0, "K4": 0}),
    "layer_bwd": ({"pallas_layer_bwd": True},
                  {"K1": 0, "K2": 0, "K3": 0, "K4": 6}),
}


# the device kernels of each port kernel, by name substring, in the modes
# that are profiled: K2 and K3 are a row pass, the dW products (xtg.cuh)
# and two sums; K4 a row pass, the dw product and its sums
XTG = ("xtg_wgmma_kernel", "xtg_simt_kernel", "xtg_reduce")
PROFILE_LABELS = {
    "fused": {"K1": ("trunk_fwd_kernel",),
              "K2": ("trunk_bwd_rows_kernel", *XTG),
              "K2 row pass": ("trunk_bwd_rows_kernel",), "K2 dW": XTG},
    "hybrid": {"K3": ("trunk_bwd_rows_kernel", *XTG),
               "K3 row pass": ("trunk_bwd_rows_kernel",), "K3 dW": XTG},
    "layer_bwd": {"K4": ("layer_bwd_rows", *XTG),
                  "K4 row pass": ("layer_bwd_rows",), "K4 dw": XTG},
}


def mode_config(flags: dict):
    """(cfg, settings) of the flagship values with ``flags`` set in the
    runtime section."""
    d = copy.deepcopy(SRN_CARS_CODE)
    d["runtime"].update(flags)
    cfg = config_from_dict(d)
    return cfg, RenderSettings.from_config(cfg)


def grads_of(state) -> dict:
    named = [(f"{k}.{n}", p) for k, m in state.models.items()
             for n, p in m.named_parameters()]
    named += [(f"codes.{n}", p) for n, p in state.tables.named_parameters()]
    return {n: p.grad.detach().clone() for n, p in named}


def grad_rel_rms(got: dict, want: dict) -> dict:
    return {n: float(torch.linalg.norm(got[n] - g) / torch.linalg.norm(g))
            for n, g in want.items() if float(g.norm()) > 0}


def train_phase(size, dirs, teacher, tables, card) -> dict:
    """The flagship train step on the card (phase 6) in each mode of
    ``TRAIN_MODES``, and one f32 step."""
    cfg, k1_settings = mode_config(TRAIN_MODES["fused"][0])
    chunk = cfg.nerf.validation.chunksize
    B = cfg.dataset.train_batch_size
    n_rays = cfg.nerf.ray_sampler.num_random_rays
    lam = cfg.experiment.regularizer_lambda
    n_objects = 8
    poses = torch.stack([pose_spherical(0.5 + 0.25 * i, 0.9 * i, 1.3,
                                        device="cuda") for i in range(B)])
    ids = torch.arange(B, device="cuda")
    render = make_image_renderer(k1_settings, size, size, chunk, "cuda")
    with torch.no_grad():
        pixels = torch.stack([
            render(teacher, dirs, poses[i],
                   *lookup_codes(tables, ids[i:i + 1])).reshape(size, size, 3)
            for i in range(B)])
    print(f"train: {B} targets of {size}x{size} from the seeded teacher; "
          f"student of {n_objects} objects, {B} x {n_rays} rays a step, "
          f"regularizer {lam}", flush=True)

    def one_step(settings, plain=False):
        """One step from the seeded student: (state, grads, loss,
        launches)."""
        st = init_train_state(cfg, settings, n_objects, seed=SEED + 2,
                              device="cuda")
        step = make_train_step(settings, st, n_rays, lam, True)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        before = launch_counts()
        with plain_versions() if plain else contextlib.nullcontext():
            m = step(dirs, poses, pixels, ids, gen)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        return st, grads_of(st), float(m.loss), launched

    results = {}
    xla_grads = None
    for mode, (flags, want_launches) in TRAIN_MODES.items():
        _, settings = mode_config(flags)
        torch.cuda.reset_peak_memory_stats()
        kernels = any(want_launches.values())
        # (a) one step of B x n_rays rays with the kernels and one on the
        # plain versions, from the same state and generator seed
        student, grads, loss, launched = one_step(settings)
        if launched != want_launches:
            raise RuntimeError(f"train {mode} (a): launched {launched}, "
                               f"expected {want_launches}")
        row = {"path": trunk_path(settings), "loss_step_a": loss}
        if mode == "xla":
            xla_grads = grads
        if kernels:
            st, plain_grads, plain_loss, launched = one_step(settings, True)
            del st
            if any(launched.values()):
                raise RuntimeError(f"train {mode} (a): the plain step "
                                   f"launched {launched}")
            rel = grad_rel_rms(grads, plain_grads)
            worst = max(rel, key=rel.get)
            print(f"train {mode} (a): {B * n_rays} rays: loss kernels="
                  f"{loss:.8g} plain={plain_loss:.8g}; gradient relRMS over "
                  f"{len(rel)} leaves: worst {worst} {rel[worst]:.4g}, "
                  f"median {statistics.median(rel.values()):.4g}; peak "
                  f"memory of the mode so far "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3g} GiB",
                  flush=True)
            if not rel[worst] <= REL_RMS_GATE:
                raise RuntimeError(f"train {mode}: {worst} gradient relRMS "
                                   f"{rel[worst]} > {REL_RMS_GATE}")
            if not abs(loss - plain_loss) <= 1e-3 * plain_loss:
                raise RuntimeError(f"train {mode}: loss {loss} vs plain "
                                   f"{plain_loss}")
            row["grad_rel_rms_worst"] = [worst, rel[worst]]
            del plain_grads
        if mode == "layer_bwd":
            # the xla mode's step: the same math, summed in another order
            rel = grad_rel_rms(grads, xla_grads)
            worst = max(rel, key=rel.get)
            print(f"train layer_bwd (a) vs xla: gradient relRMS over "
                  f"{len(rel)} leaves: worst {worst} {rel[worst]:.4g}, "
                  f"median {statistics.median(rel.values()):.4g}",
                  flush=True)
            if not rel[worst] <= REL_RMS_GATE:
                raise RuntimeError(f"train layer_bwd vs xla: {worst} "
                                   f"gradient relRMS {rel[worst]} > "
                                   f"{REL_RMS_GATE}")
            row["grad_rel_rms_worst_vs_xla"] = [worst, rel[worst]]
            del xla_grads
        del grads
        torch.cuda.empty_cache()

        # (b) TRAIN_STEPS steps at B x n_rays rays, jitter on
        step = make_train_step(settings, student, n_rays, lam, True)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
        torch.cuda.synchronize()
        reset_launch_counts()
        ms, fine, total = [], [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            m = step(dirs, poses, pixels, ids, gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            fine.append(m.loss_fine)
            total.append(m.loss)
        counts = launch_counts()
        fine = [float(v) for v in fine]
        total = [float(v) for v in total]
        step_ms = statistics.median(ms)
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items()}
        print(f"train {mode} (b): {TRAIN_STEPS} steps of {B * n_rays} rays: "
              f"median {step_ms:.6g} ms/step ({B * n_rays / step_ms * 1e3:.6g}"
              f" rays/s), first {ms[0]:.6g} ms; launches per step "
              f"{per_step}; fine loss {fine[0]:.6g} -> {fine[-1]:.6g} "
              f"(loss {total[0]:.6g} -> {total[-1]:.6g}); peak memory of "
              f"the mode {torch.cuda.max_memory_allocated() / 2**30:.3g} GiB "
              f"on {card}", flush=True)
        if per_step != want_launches:
            raise RuntimeError(f"train {mode}: launches per step {per_step},"
                               f" expected {want_launches}")
        if not all(map(lambda v: v == v and abs(v) != float("inf"), total)):
            raise RuntimeError(f"train {mode}: a loss is not finite")
        first, last = statistics.mean(fine[:10]), statistics.mean(fine[-10:])
        if not last < first:
            raise RuntimeError(f"train {mode}: the fine loss did not fall "
                               f"({first} -> {last})")
        row.update({"step_ms": step_ms, "step_ms_all": ms,
                    "rays_per_s": B * n_rays / step_ms * 1e3,
                    "launches": counts, "launches_per_step": per_step,
                    "loss_fine": fine, "loss": total})
        results[mode] = row

        # (c) one step under torch.profiler
        if mode in PROFILE_LABELS:
            row["profile"] = profile_step(
                f"train {mode}", step, (dirs, poses, pixels, ids, gen),
                step_ms, PROFILE_LABELS[mode], card)
        del student, step
        torch.cuda.empty_cache()

    # f32 in the kernel modes: one step with K1 + K2 (fused) or K3 (hybrid)
    # against the same step on the plain versions
    for mode in ("fused", "hybrid"):
        flags, want_launches = TRAIN_MODES[mode]
        _, s32 = mode_config({**flags, "compute_dtype": "float32"})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, grads, loss, launched = one_step(s32)
        step_ms = (time.perf_counter() - t0) * 1e3
        del st
        st, plain_grads, plain_loss, plain_launched = one_step(s32, True)
        del st
        if launched != want_launches or any(plain_launched.values()):
            raise RuntimeError(f"train f32 {mode}: launched {launched} (plain "
                               f"{plain_launched}), expected {want_launches}")
        if not loss == loss or abs(loss) == float("inf"):
            raise RuntimeError(f"train f32 {mode}: the loss is not finite "
                               f"({loss})")
        rel = grad_rel_rms(grads, plain_grads)
        worst = max(rel, key=rel.get)
        print(f"train f32 {mode}: one step of {B * n_rays} rays: loss "
              f"kernels={loss:.8g} plain={plain_loss:.8g}; gradient relRMS "
              f"over {len(rel)} leaves: worst {worst} {rel[worst]:.4g}, "
              f"median {statistics.median(rel.values()):.4g}; launches "
              f"{launched}; "
              f"{step_ms:.6g} ms with set-up on {card}", flush=True)
        if not rel[worst] <= F32_REL_RMS_GATE:
            raise RuntimeError(f"train f32 {mode}: {worst} gradient relRMS "
                               f"{rel[worst]} > {F32_REL_RMS_GATE}")
        if not abs(loss - plain_loss) <= 1e-4 * plain_loss:
            raise RuntimeError(f"train f32 {mode}: loss {loss} vs plain "
                               f"{plain_loss}")
        results[f"f32_{mode}"] = {"loss": loss, "plain_loss": plain_loss,
                                  "grad_rel_rms_worst": [worst, rel[worst]],
                                  "ms_with_setup": step_ms,
                                  "launches": launched}
        del grads, plain_grads
        torch.cuda.empty_cache()

    # one f32 step at the flagship width, the YAML's runtime
    f32_cfg, f32_settings = mode_config({"compute_dtype": "float32"})
    if trunk_path(f32_settings) != "rays":
        raise RuntimeError("the f32 settings do not take the ray-structured "
                           "path")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, _, loss, launched = one_step(f32_settings)
    f32_ms = (time.perf_counter() - t0) * 1e3
    print(f"train f32: one step of {B * n_rays} rays on the ray-structured "
          f"path: loss {loss:.8g}, launches {launched}, {f32_ms:.6g} ms "
          f"with set-up; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3g} GiB on {card}",
          flush=True)
    if not loss == loss or abs(loss) == float("inf"):
        raise RuntimeError(f"train f32: the loss is not finite ({loss})")
    results["f32"] = {"loss": loss, "ms_with_setup": f32_ms,
                      "launches": launched}
    del st
    torch.cuda.empty_cache()
    return results


TTO_STEPS = 30
TTO_OBJECTS = 4
# the SRN cars train split's object count (bench.py's code table), so TTO
# starts from the mean codes of a real-sized table
SRN_CARS_TRAIN_OBJECTS = 2458
TTO_KEYS = ("z_s", "z_t", "theta", "phi", "rho")
# multi-view and SE(3) refine: objects, views and steps
MV_OBJECTS, MV_VIEWS, REFINE_STEPS = 2, 2, 5


def finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def timed_steps(step, state, args, n) -> tuple:
    """``n`` TTO steps from ``state``: (state, ms per step, metrics)."""
    ms, metrics = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, *args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    return state, ms, metrics


def tto_phase(size, dirs, models, card) -> dict:
    """Test-time optimization on the card (phase 7): batched TTO of
    ``TTO_OBJECTS`` targets in each mode of ``TRAIN_MODES``, single TTO
    and K = 1 against it, f32 fused and hybrid steps, multi-view TTO and
    the SE(3) refine stages, all with the frozen seeded ``models``."""
    cfg, k1_settings = mode_config(TRAIN_MODES["fused"][0])
    n_rays = cfg.nerf.ray_sampler.num_random_rays
    lam = cfg.experiment.regularizer_lambda
    perturb = cfg.nerf.point_sampler.perturb
    opt_cfg = cfg.optimizer
    emb = cfg.models.embedding
    K = TTO_OBJECTS
    tables = CodeTables(SRN_CARS_TRAIN_OBJECTS, emb.shape_code_size,
                        emb.texture_code_size, "cuda",
                        torch.Generator(device="cpu").manual_seed(SEED + 9))
    phis = torch.linspace(-2.0, 2.0, K, device="cuda")
    poses = pose_spherical(torch.full_like(phis, 1.2), phis, 1.3)
    render = make_image_renderer(k1_settings, size, size,
                                 cfg.nerf.validation.chunksize, "cuda")

    def targets_of(ids):
        return torch.stack([render(models, dirs, poses[i],
                                   *lookup_codes(tables, ids[i:i + 1]))
                            .reshape(size, size, 3) for i in range(K)])

    with torch.no_grad():
        targets = targets_of(torch.arange(K, device="cuda"))
        # multi-view: objects 0 and 1, two views each, at the same poses
        mv_targets = targets_of(torch.tensor([0, 0, 1, 1], device="cuda")
                                ).reshape(MV_OBJECTS, MV_VIEWS, size, size, 3)
    mv_poses = poses.reshape(MV_OBJECTS, MV_VIEWS, 4, 4)
    print(f"tto: {K} targets of {size}x{size} rendered from table codes at "
          f"theta 1.2, phi {[round(float(p), 4) for p in phis]}, rho 1.3; "
          f"codes from the mean of a {SRN_CARS_TRAIN_OBJECTS}-object table; "
          f"{K} x {n_rays} rays a step, {opt_cfg.resolved_val_type} "
          f"val_lr {opt_cfg.val_lr}, regularizer {lam}, perturb {perturb}",
          flush=True)
    args = (models, dirs, targets, poses)

    def one_step(settings, mods, plain=False):
        """One batched step from the initial state: (state, grads, loss
        [K], launches)."""
        st, opt = init_batched_tto_state(tables, opt_cfg, K)
        step = make_batched_tto_step(settings, opt, n_rays, lam, perturb)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
        before = launch_counts()
        with plain_versions() if plain else contextlib.nullcontext():
            st, m = step(st, mods, dirs, targets, poses, gen)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        grads = {k: st.variables[k].grad.detach().clone() for k in TTO_KEYS}
        return st, grads, m.loss.detach().clone(), launched

    def check_against_plain(label, settings, mods, want_launches, gate):
        st, grads, loss, launched = one_step(settings, mods)
        _, p_grads, p_loss, p_launched = one_step(settings, mods, True)
        if launched != want_launches or any(p_launched.values()):
            raise RuntimeError(f"{label}: launched {launched} (plain "
                               f"{p_launched}), expected {want_launches}")
        rel = grad_rel_rms(grads, p_grads)
        worst = max(rel, key=rel.get)
        loss_rel = float((loss - p_loss).abs().max() / p_loss.abs().min())
        print(f"{label}: {K * n_rays} rays: loss kernels "
              f"{[round(float(v), 8) for v in loss]} plain "
              f"{[round(float(v), 8) for v in p_loss]}; gradient relRMS "
              + ", ".join(f"{k} {v:.4g}" for k, v in rel.items())
              + f" (worst {worst}); launches {launched}", flush=True)
        if not rel[worst] <= gate:
            raise RuntimeError(f"{label}: {worst} gradient relRMS "
                               f"{rel[worst]} > {gate}")
        if not loss_rel <= gate / 10:
            raise RuntimeError(f"{label}: loss {loss.tolist()} vs plain "
                               f"{p_loss.tolist()}")
        return st, grads, {"grad_rel_rms": rel, "worst": [worst, rel[worst]],
                           "loss_rel": loss_rel}

    results = {}
    xla_grads = fused_state = None
    for mode, (flags, want_launches) in TRAIN_MODES.items():
        _, settings = mode_config(flags)
        torch.cuda.reset_peak_memory_stats()
        # (a) one step with the kernels against the same step on the plain
        # versions, from the same state and generator seed
        if any(want_launches.values()):
            st, grads, row = check_against_plain(
                f"tto {mode} (a)", settings, models, want_launches,
                REL_RMS_GATE)
        else:
            st, grads, loss, launched = one_step(settings, models)
            if any(launched.values()):
                raise RuntimeError(f"tto {mode} (a): launched {launched}")
            row = {"loss": loss.tolist()}
        row["path"] = trunk_path(settings)
        if mode == "xla":
            xla_grads = grads
        if mode == "layer_bwd":
            rel = grad_rel_rms(grads, xla_grads)
            worst = max(rel, key=rel.get)
            print(f"tto layer_bwd (a) vs xla: gradient relRMS worst {worst} "
                  f"{rel[worst]:.4g}", flush=True)
            if not rel[worst] <= REL_RMS_GATE:
                raise RuntimeError(f"tto layer_bwd vs xla: {worst} gradient "
                                   f"relRMS {rel[worst]} > {REL_RMS_GATE}")
            row["grad_rel_rms_worst_vs_xla"] = [worst, rel[worst]]
        del grads

        # (b) TTO_STEPS steps on from the state of (a)
        step = make_batched_tto_step(settings, st.optimizer, n_rays, lam,
                                     perturb)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        torch.cuda.synchronize()
        reset_launch_counts()
        st, ms, mets = timed_steps(step, st, (*args, gen), TTO_STEPS)
        counts = launch_counts()
        fine = [float(m.loss_fine.mean()) for m in mets]
        total = [float(m.loss.mean()) for m in mets]
        perr = [float(m.pose_error.mean()) for m in mets]
        step_ms = statistics.median(ms)
        per_step = {k: v / TTO_STEPS for k, v in counts.items()}
        print(f"tto {mode} (b): {TTO_STEPS} batched steps of {K} x {n_rays} "
              f"rays: median {step_ms:.6g} ms/step "
              f"({K * n_rays / step_ms * 1e3:.6g} rays/s, "
              f"{1e3 / step_ms:.6g} TTO steps/s, "
              f"{K * 1e3 / step_ms:.6g} objects x steps/s), first "
              f"{ms[0]:.6g} ms; launches per step {per_step}; fine loss "
              f"{fine[0]:.6g} -> {fine[-1]:.6g} (loss {total[0]:.6g} -> "
              f"{total[-1]:.6g}); mean pose error {perr[0]:.6g} -> "
              f"{perr[-1]:.6g}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3g} GiB on "
              f"{card}", flush=True)
        if per_step != want_launches:
            raise RuntimeError(f"tto {mode}: launches per step {per_step}, "
                               f"expected {want_launches}")
        if not finite(total + perr):
            raise RuntimeError(f"tto {mode}: a loss or pose error is not "
                               f"finite")
        first, last = statistics.mean(fine[:10]), statistics.mean(fine[-10:])
        if not last < first:
            raise RuntimeError(f"tto {mode}: the fine loss did not fall "
                               f"({first} -> {last})")
        row.update({"step_ms": step_ms, "step_ms_all": ms,
                    "rays_per_s": K * n_rays / step_ms * 1e3,
                    "steps_per_s": 1e3 / step_ms,
                    "object_steps_per_s": K * 1e3 / step_ms,
                    "launches": counts, "launches_per_step": per_step,
                    "loss_fine": fine, "loss": total,
                    "pose_error_first_last": [perr[0], perr[-1]],
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30})

        # (c) one step under torch.profiler
        if mode in PROFILE_LABELS:
            row["profile"] = profile_step(
                f"tto {mode}", step, (st, *args, gen), step_ms,
                PROFILE_LABELS[mode], card)
        results[mode] = row
        if mode == "fused":
            fused_state = st
        del st, step
        torch.cuda.empty_cache()

    # single TTO at n_rays rays, fused mode; then K = 1 batched against it
    single, opt = init_tto_state(tables, opt_cfg)
    step1 = make_tto_step(k1_settings, opt, n_rays, lam, perturb)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    one = (models, dirs, targets[0], poses[0], gen)
    single, ms, mets = timed_steps(step1, single, one, 12)
    single_ms = statistics.median(ms[2:])
    if not finite([float(m.loss) for m in mets]):
        raise RuntimeError("tto single: a loss is not finite")
    single_prof = profile_step("tto single", step1, (single, *one),
                               single_ms, PROFILE_LABELS["fused"], card)
    runs = {}
    for kind in ("single", "batched"):
        if kind == "single":
            st, opt = init_tto_state(tables, opt_cfg)
            step = make_tto_step(k1_settings, opt, n_rays, lam, perturb)
            data = (targets[0], poses[0])
        else:
            st, opt = init_batched_tto_state(tables, opt_cfg, 1)
            step = make_batched_tto_step(k1_settings, opt, n_rays, lam,
                                         perturb)
            data = (targets[:1], poses[:1])
        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
        st, _, mets = timed_steps(step, st, (models, dirs, *data, gen), 3)
        runs[kind] = ({k: v.detach() for k, v in st.variables.items()},
                      mets[-1])
    (vs, ms_), (vb, mb) = runs["single"], runs["batched"]
    # (largest difference, its tolerance) of each quantity
    k1_diff = {
        "z_s": (float((vb["z_s"][0] - vs["z_s"][0]).abs().max()),
                float(2e-5 * vs["z_s"][0].abs().max() + 1e-7)),
        "theta": (abs(float(vb["theta"][0] - vs["theta"][0])),
                  1e-5 * abs(float(vs["theta"][0]))),
        "loss": (abs(float(mb.loss[0]) - float(ms_.loss)),
                 1e-5 * abs(float(ms_.loss))),
        "pose_error": (abs(float(mb.pose_error[0]) - float(ms_.pose_error)),
                       1e-5 * abs(float(ms_.pose_error))),
    }
    z_ok = bool(((vb["z_s"][0] - vs["z_s"][0]).abs()
                 <= 2e-5 * vs["z_s"][0].abs() + 1e-7).all())
    print(f"tto single: {n_rays} rays, fused: median {single_ms:.6g} ms/step "
          f"({n_rays / single_ms * 1e3:.6g} rays/s, {1e3 / single_ms:.6g} "
          f"steps/s) on {card}; batched K=1 vs single after 3 steps from one "
          f"generator, (difference, tolerance): {k1_diff}", flush=True)
    if not (z_ok and all(d <= tol for k, (d, tol) in k1_diff.items()
                         if k != "z_s")):
        raise RuntimeError(f"tto batched K=1 differs from single: {k1_diff}")
    results["single"] = {"step_ms": single_ms, "step_ms_all": ms,
                         "rays_per_s": n_rays / single_ms * 1e3,
                         "k1_vs_single": k1_diff,
                         "profile": single_prof}
    del single, runs, vs, vb
    torch.cuda.empty_cache()

    # f32: one fused and one hybrid batched step against the plain versions
    for mode in ("fused", "hybrid"):
        flags, want_launches = TRAIN_MODES[mode]
        _, s32 = mode_config({**flags, "compute_dtype": "float32"})
        models32 = {}
        for k, m in models.items():
            models32[k] = CodeNeRF(getattr(s32, f"{k}_cfg"), "cuda")
            models32[k].load_state_dict(m.state_dict())
        _, _, row = check_against_plain(f"tto f32 {mode}", s32, models32,
                                        want_launches, F32_REL_RMS_GATE)
        results[f"f32_{mode}"] = row
        del models32
        torch.cuda.empty_cache()

    # multi-view, then the SE(3) refine stages, fused mode
    mv, opt = init_multiview_tto_state(tables, opt_cfg, MV_OBJECTS, MV_VIEWS)
    step = make_multiview_tto_step(k1_settings, opt, n_rays, lam, perturb)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    mv, mv_ms, mets = timed_steps(step, mv, (models, dirs, mv_targets,
                                             mv_poses, gen), REFINE_STEPS)
    stages = {"multiview": (mv_ms, mets, MV_OBJECTS * MV_VIEWS * n_rays)}
    for kind, start, init, make, data in (
            ("se3_refine", fused_state, init_se3_refine_state,
             make_se3_refine_step, (targets, poses)),
            ("multiview_se3_refine", mv, init_multiview_se3_refine_state,
             make_multiview_se3_refine_step, (mv_targets, mv_poses))):
        ref, opt, base = init(start, opt_cfg)
        if float(ref.variables["xi"].detach().abs().max()) != 0.0:
            raise RuntimeError(f"tto {kind}: xi does not start at 0")
        step = make(k1_settings, opt, n_rays, lam, perturb)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
        _, ms, mets = timed_steps(step, ref, (models, dirs, data[0], base,
                                              data[1], gen), REFINE_STEPS)
        stages[kind] = (ms, mets, base.shape[:-2].numel() * n_rays)
    for kind, (ms, mets, rays) in stages.items():
        losses = [m.loss.tolist() for m in mets]
        perr = [float(m.pose_error.mean()) for m in mets]
        med = statistics.median(ms)
        print(f"tto {kind}: {REFINE_STEPS} steps of {rays} rays, fused: "
              f"median {med:.6g} ms/step ({rays / med * 1e3:.6g} rays/s); "
              f"mean loss {statistics.mean(losses[0]):.6g} -> "
              f"{statistics.mean(losses[-1]):.6g}; mean pose error "
              f"{perr[0]:.6g} -> {perr[-1]:.6g} on {card}", flush=True)
        if not finite([v for row in losses for v in row] + perr):
            raise RuntimeError(f"tto {kind}: a loss is not finite")
        results[kind] = {"step_ms": med, "step_ms_all": ms, "loss": losses,
                         "rays_per_step": rays,
                         "pose_error_first_last": [perr[0], perr[-1]]}
    return results


def main():
    t_all = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")

    t0 = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | cards {torch.cuda.device_count()}",
          flush=True)
    phase("device", t0)

    t0 = time.perf_counter()
    # one nvcc for each source, started together
    sources = ("trunk_fwd", "trunk_bwd", "layer_bwd")
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = dict(zip(sources, pool.map(_build.build, sources)))
    for name, built in builds.items():
        ptxas = [ln.strip() for ln in built["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "serialized" in ln
                 or "Function properties" in ln]
        print(f"build: {name} {built['path'].name} in "
              f"{built['seconds']:.2f} s; " + " | ".join(ptxas), flush=True)
    phase("build", t0)

    cfg = config_from_dict(SRN_CARS_CODE)
    settings = RenderSettings.from_config(cfg)
    # the render serves through K1, named by its runtime flag
    k1_settings = dataclasses.replace(settings, use_pallas=True)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    models = {"coarse": CodeNeRF(settings.coarse_cfg, "cuda", gen),
              "fine": CodeNeRF(settings.fine_cfg, "cuda", gen)}
    emb = cfg.models.embedding
    tables = CodeTables(8, emb.shape_code_size, emb.texture_code_size,
                        "cuda", gen)
    z_s, z_t = lookup_codes(tables, torch.tensor([3], device="cuda"))
    z_s, z_t = z_s.detach(), z_t.detach()
    size = cfg.dataset.image_size
    chunk = cfg.nerf.validation.chunksize
    pose = pose_spherical(1.2, 0.6, 1.3, device="cuda")

    def directions(n):
        K = torch.eye(4, device="cuda")
        K[0, 0] = K[1, 1] = SRN_FOCAL_128 * n / 128
        K[0, 2] = K[1, 2] = n / 2
        return pixel_directions(n, n, K)

    t0 = time.perf_counter()
    dirs = directions(size)
    rd_all = torch.einsum("hwi,ji->hwj", dirs, pose[:3, :3]).reshape(-1, 3)
    ro_all = pose[:3, 3].expand_as(rd_all)
    n_step = (cfg.dataset.train_batch_size
              * cfg.nerf.ray_sampler.num_random_rays)
    if n_step > len(rd_all):
        raise RuntimeError(f"the kernel checks take the train step's "
                           f"{n_step} rays from one {size}x{size} image")
    k1 = check_k1(settings, models["fine"], ro_all[:n_step].contiguous(),
                  rd_all[:n_step].contiguous(), z_s.expand(n_step, -1),
                  z_t.expand(n_step, -1), chunk, card)
    bwd = check_bwd(settings, models["fine"], ro_all[:n_step].contiguous(),
                    rd_all[:n_step].contiguous(), z_s.expand(n_step, -1),
                    z_t.expand(n_step, -1), card)
    h = settings.fine_cfg.hidden_size
    k4 = check_k4(h, h, card)
    # the f32 instantiations of K1-K3, on an f32 model from its own seed
    _, f32_settings = mode_config({"compute_dtype": "float32"})
    model32 = CodeNeRF(f32_settings.fine_cfg, "cuda",
                       torch.Generator(device="cpu").manual_seed(SEED + 7))
    f32_cases = check_f32(f32_settings, model32, ro_all[:n_step].contiguous(),
                    rd_all[:n_step].contiguous(), z_s.expand(n_step, -1),
                    z_t.expand(n_step, -1), chunk)
    del model32
    phase("kernels", t0)

    t0 = time.perf_counter()
    render = make_image_renderer(k1_settings, size, size, chunk, "cuda")
    render(models, dirs, pose, z_s, z_t)                     # warm-up
    torch.cuda.synchronize()
    trunk_forward.launches = 0
    t_r = time.perf_counter()
    img = render(models, dirs, pose, z_s, z_t)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t_r) * 1e3
    launches = trunk_forward.launches
    n_chunks = -(-size * size // chunk)
    if launches != 2 * n_chunks:
        raise RuntimeError(f"the render launched K1 {launches} times, "
                           f"expected {2 * n_chunks}")
    if tuple(img.shape) != (size * size, 3) or not bool(
            torch.isfinite(img).all()):
        raise RuntimeError(f"bad image: shape {tuple(img.shape)}")
    if not (float(img.min()) >= -1e-3 and float(img.max()) <= 1 + 1e-3):
        raise RuntimeError("image values outside the widened sigmoid range")
    img_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        render(models, dirs, pose, z_s, z_t)
        torch.cuda.synchronize()
        img_ms.append((time.perf_counter() - t_r) * 1e3)
    ms_img = statistics.median(img_ms)

    plain_ms_img = []
    before = trunk_forward.launches
    with plain_versions():
        for _ in range(3):
            torch.cuda.synchronize()
            t_r = time.perf_counter()
            img_plain = render(models, dirs, pose, z_s, z_t)
            torch.cuda.synchronize()
            plain_ms_img.append((time.perf_counter() - t_r) * 1e3)
    if trunk_forward.launches != before:
        raise RuntimeError("the plain-trunk render launched K1")
    psnr = float(mse2psnr(torch.mean((img - img_plain) ** 2)))
    print(f"render {size}x{size}: K1 launches={launches} "
          f"first={first_ms:.6g} ms median={ms_img:.6g} ms/image "
          f"({size * size / ms_img * 1e3:.6g} rays/s); plain trunk "
          f"median={statistics.median(plain_ms_img):.6g} ms/image; "
          f"PSNR(K1 vs plain)={psnr:.6g} dB on {card}", flush=True)
    if not psnr >= PSNR_GATE:
        raise RuntimeError(f"K1 image vs plain image: {psnr} dB < "
                           f"{PSNR_GATE}")

    small = 16
    img_gpu = make_image_renderer(k1_settings, small, small, 256, "cuda")(
        models, directions(small), pose, z_s, z_t)
    cpu_models = {k: copy.deepcopy(m).to("cpu") for k, m in models.items()}
    img_cpu = make_image_renderer(k1_settings, small, small, 256, "cpu")(
        cpu_models, directions(small).cpu(), pose.cpu(), z_s.cpu(),
        z_t.cpu())
    psnr_cpu = float(mse2psnr(torch.mean((img_gpu.cpu() - img_cpu) ** 2)))
    print(f"render {small}x{small}: PSNR(card K1 vs CPU plain)="
          f"{psnr_cpu:.6g} dB", flush=True)
    if not psnr_cpu >= PSNR_GATE:
        raise RuntimeError(f"card vs CPU image: {psnr_cpu} dB < "
                           f"{PSNR_GATE}")

    # the YAML's own flags serve through the ray-structured forward
    rays_render = make_image_renderer(settings, size, size, chunk, "cuda")
    rays_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        img_rays = rays_render(models, dirs, pose, z_s, z_t)
        torch.cuda.synchronize()
        rays_ms.append((time.perf_counter() - t_r) * 1e3)
    if tuple(img_rays.shape) != (size * size, 3) or not bool(
            torch.isfinite(img_rays).all()):
        raise RuntimeError(f"bad ray-structured image: shape "
                           f"{tuple(img_rays.shape)}")
    img_gpu = make_image_renderer(settings, small, small, 256, "cuda")(
        models, directions(small), pose, z_s, z_t)
    img_cpu = make_image_renderer(settings, small, small, 256, "cpu")(
        cpu_models, directions(small).cpu(), pose.cpu(), z_s.cpu(),
        z_t.cpu())
    psnr_rays = float(mse2psnr(torch.mean((img_gpu.cpu() - img_cpu) ** 2)))
    psnr_k1 = float(mse2psnr(torch.mean((img_rays - img) ** 2)))
    print(f"render {size}x{size} ray-structured (the YAML's flags): median "
          f"{statistics.median(rays_ms):.6g} ms/image; PSNR(vs K1 image)="
          f"{psnr_k1:.6g} dB; {small}x{small} PSNR(card vs CPU)="
          f"{psnr_rays:.6g} dB on {card}", flush=True)
    if not psnr_rays >= PSNR_GATE:
        raise RuntimeError(f"ray-structured card vs CPU image: {psnr_rays} "
                           f"dB < {PSNR_GATE}")
    phase("render", t0)

    t0 = time.perf_counter()
    prof = profile_call(render, (models, dirs, pose, z_s, z_t), ms_img,
                        {"K1": ("trunk_fwd_kernel",)})
    if prof["device_busy_ms"]:
        print(f"profile: device busy {prof['device_busy_ms']:.6g} ms per "
              f"image against the unprofiled {ms_img:.6g} ms (idle share "
              f"{prof['idle_share']:.4g}); K1 "
              f"{prof['kernel_ms']['K1']:.6g} ms "
              f"({prof['kernel_share_of_busy']['K1']:.4g} of busy) on "
              f"{card}", flush=True)
    else:
        print("profile: torch.profiler recorded no device time: the "
              "breakdown is not measured", flush=True)
    print(json.dumps({"profile": prof}), flush=True)
    phase("profile", t0)

    t0 = time.perf_counter()
    train = train_phase(size, dirs, models, tables, card)
    phase("train", t0)

    t0 = time.perf_counter()
    tto = tto_phase(size, dirs, models, card)
    phase("tto", t0)

    # one image runs each S once per chunk at R = chunk; one train step
    # runs each S once at R = n_step
    def per_call(R):
        rows = [s for s in k1["shapes"] if s["R"] == R]
        cost = {k: sum(s["cost"][k] for s in rows) for k in rows[0]["cost"]}
        return ({k: sum(s[k] for s in rows)
                 for k in ("ms", "wrapper_ms", "plain_ms", "library_ms")},
                cost)

    image, image_cost = per_call(chunk)
    image_cost = {k: n_chunks * v for k, v in image_cost.items()}
    image_bound_ms, image_bound_by = bound_ms(image_cost)
    step_k1, step_k1_cost = per_call(n_step)
    kernels = [{
        "name": "K1 trunk_fwd",
        "route": "cuda",
        "source": "codenerf_tpu_torch/ops/csrc/trunk_fwd.cu",
        "replaces": "codenerf_tpu/ops/fused.py:75",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in k1["shapes"]),
        "rel_rms": max(s["rel_rms"] for s in k1["shapes"]),
        "ms": n_chunks * image["ms"],
        "plain_ms": n_chunks * image["plain_ms"],
        "bound_ms": image_bound_ms,
        "bound_by": image_bound_by,
        "library_ms": n_chunks * image["library_ms"],
        "library_note": "the plain chain with bf16 cuBLAS products "
                        "(f32 accumulation) and the same elementwise ops "
                        "(trunk_forward_library)",
        "wrapper_ms": n_chunks * image["wrapper_ms"],
        "bf16_peak_share": image_cost["bf16_flops"]
        / (n_chunks * image["ms"] * 1e-3) / PEAK_BF16,
        "ms_note": "CUDA events around back-to-back launches of the kernel "
                   "on inputs packed once; wrapper_ms times trunk_forward, "
                   "which checks, casts and packs them every call",
        "per": f"one {size}x{size} image: {n_chunks} launches at each S of "
               f"{sorted({s['S'] for s in k1['shapes']})}, R={chunk}",
        "launches_per_train_step": train["fused"]["launches_per_step"]["K1"],
        "tto_launches": tto["fused"]["launches"]["K1"],
        "launches_per_tto_step": tto["fused"]["launches_per_step"]["K1"],
        "train_step_ms": step_k1["ms"],
        "train_step_wrapper_ms": step_k1["wrapper_ms"],
        "train_step_plain_ms": step_k1["plain_ms"],
        "train_step_library_ms": step_k1["library_ms"],
        "train_step_bound_ms": bound_ms(step_k1_cost)[0],
        "shapes": k1["shapes"],
        "f32": f32_cases["K1"],
    }]
    for name, mode in (("K2", "fused"), ("K3", "hybrid")):
        rows = [r for r in bwd[name] if r["R"] == n_step]
        cost = {k: sum(r["cost"][k] for r in rows) for k in rows[0]["cost"]}
        b_ms, b_by = bound_ms(cost)
        kernels.append({
            "name": f"{name} trunk_bwd<{'true' if name == 'K3' else 'false'}>",
            "route": "cuda",
            "source": "codenerf_tpu_torch/ops/csrc/trunk_bwd.cu",
            "replaces": "codenerf_tpu/ops/fused.py:183",
            "launches": train[mode]["launches"][name],
            "launches_per_train_step": train[mode]["launches_per_step"][name],
            "tto_launches": tto[mode]["launches"][name],
            "launches_per_tto_step": tto[mode]["launches_per_step"][name],
            "max_abs_err": max(r["max_abs_err"] for r in bwd[name]),
            "rel_rms": max(r["rel_rms"] for r in bwd[name]),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": sum(r["library_ms"] for r in rows),
            "library_note": "the plain chain with bf16 cuBLAS products "
                            "(f32 accumulation) and the same elementwise ops "
                            "(trunk_backward_library)",
            "per": f"one flagship train step ({mode} mode): one launch at "
                   f"each S of {[r['S'] for r in rows]}, R={rows[0]['R']}; "
                   f"launches counted over {TRAIN_STEPS} steps",
            "shapes": bwd[name],
            "f32": f32_cases[name],
            "f32_train_step": train[f"f32_{mode}"],
        })
    # one layer_bwd step: layer_xyz2 and layer_dir1 (per-ray rows) and
    # layer_dir2 (a bias) at each pass's S
    step_cases = {"coarse per-ray": 2, "coarse bias": 1, "fine per-ray": 2,
                  "fine bias": 1}
    step_rows = [(r, step_cases[r["case"]]) for r in k4
                 if r["case"] in step_cases]
    cost = {k: sum(n * r["cost"][k] for r, n in step_rows)
            for k in step_rows[0][0]["cost"]}
    b_ms, b_by = bound_ms(cost)
    kernels.append({
        "name": "K4 layer_bwd",
        "route": "cuda",
        "source": "codenerf_tpu_torch/ops/csrc/layer_bwd.cu",
        "replaces": "codenerf_tpu/ops/layer_bwd.py:55",
        "launches": train["layer_bwd"]["launches"]["K4"],
        "launches_per_train_step":
            train["layer_bwd"]["launches_per_step"]["K4"],
        "tto_launches": tto["layer_bwd"]["launches"]["K4"],
        "launches_per_tto_step": tto["layer_bwd"]["launches_per_step"]["K4"],
        "max_abs_err": max(r["max_abs_err"] for r in k4),
        "rel_rms": max(r["rel_rms"] for r in k4),
        "ms": sum(n * r["ms"] for r, n in step_rows),
        "plain_ms": sum(n * r["plain_ms"] for r, n in step_rows),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": sum(n * r["library_ms"] for r, n in step_rows),
        "library_note": "torch.where + two bf16 cuBLAS products + a "
                        "column or segment sum, at each launch's shape",
        "per": f"one flagship train step (layer_bwd mode): "
               f"{sum(step_cases.values())} launches, "
               f"{', '.join(f'{n} x {c}' for c, n in step_cases.items())} "
               f"at R={n_step}; launches counted over {TRAIN_STEPS} steps",
        "shapes": k4,
    })
    for name, results in (("train", train), ("tto", tto)):
        print(json.dumps({name: {m: {k: v for k, v in r.items()
                                     if k != "profile"}
                                 for m, r in results.items()}}), flush=True)
    print(f"wall: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
