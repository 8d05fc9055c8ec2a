#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``codenerf_tpu_torch``).

Drives the port's serving render (full precision and int8), train step,
test-time optimization (TTO), train entry point, data parallelism over
rays and eval entry point on one NVIDIA card at the flagship width of ``configs/srn-cars-code.yml``
(values from ``SRN_CARS_CODE``; the cli and eval phases read the file
itself), and
vanilla NeRF at the widths of ``configs/lego.yml``, ``fern.yml`` and
``srn-cars.yml``, with random weights from a seed, and the eval phase
with the committed trained weights:

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile K1 (``ops/csrc/trunk_fwd.cu``), K2 / K3
               (``ops/csrc/trunk_bwd.cu``), K4 (``ops/csrc/layer_bwd.cu``)
               and LF (``ops/csrc/layer_fwd.cu``) with one nvcc each, started together, into
               ``build/torch_kernels/``; print ptxas's registers and spills.
  3. kernels — K1, K2, K3 and K4 against their plain PyTorch versions on
               the card at the main paths' shapes (the render's R = 4096
               rays and the train step's R = 16384, S = 32 and 160; K4 also
               at R = 1000, S = 24, a masked tail tile): max abs error and
               relRMS of every output (gate 1e-2 in bf16), K1-K4
               bit-identical across two calls (K2 / K3 also: the route
               ``plan.k2_plan`` took, the wgmma row pass at these bf16
               shapes, and a frozen-trunk call, ``need_dw=False``, whose
               g_pts and per-ray grads equal the full call's bit for bit,
               timed beside it); K1-K4 also in f32 (gate
               1e-4: both sum in f32, in other orders); kernel, plain and
               library times (CUDA events around back-to-back calls)
               beside the bound (K1: the kernel on inputs packed once, and
               its wrapper, which packs them every call; its share of the
               bf16 peak); then widths past the limits the kernels once
               had, against the plain versions at the same gates: K1 / K2
               / K3 at hidden 288, codes 80, 12 xyz bands (bf16 K1's
               row-tile route) and at hidden 48, codes 40 (zero-padded to
               64; bf16 and f32), K4 at w (48, 288) in bf16 (w read from
               global memory) and w (40, 24) (padded; bf16 and f32); and
               past what a full row tile holds: K1-K3 at hidden and codes
               864 (bf16 and f32, half tiles) and 1760 (quarter tiles),
               K4 at w (64, 1760) (a half tile) and (16, 3520) (a
               quarter); LF, the fused linear + relu forward, at lego's
               relu layers (R = 16384, S = 64 and 192): every element
               within its product's rounding, at most ``LAYER_FWD_DIFFER``
               differing from the plain version, bit-identical across two
               calls, timed beside the plain version, the cuBLAS product
               alone and the bound.
  4. render  — one 128x128 image through ``make_image_renderer`` on CUDA
               with K1 (``use_pallas``; K1's launch count must rise by
               exactly 8), the same image with the plain trunk (PSNR gate
               40 dB), and a 16x16 image on the card against the port's
               CPU path (40 dB); then the same image with the YAML's own
               flags, through the ray-structured forward (ms per image,
               PSNR against the K1 image; 16x16 card against CPU, 40 dB).
  4b. int8  — int8 serving (``models/quantized.py``; its products are
               ``torch._int_mm``) of the same models, without and with the
               encode stream: calibration by ``harness.int8_render_params``'
               draw on the card (ms), the 128x128 image (``_int_mm`` calls
               per image, ms per image beside the K1 image's and the YAML
               flags' image's, PSNR against the K1 image), gated card
               against CPU: a 16x16 image from the same quantized buffers
               moved to the CPU (40 dB) and the calibration of 1024 rays on
               each (``s_act`` relRMS 1e-2); a profile of one int8 image
               (busy, idle, the int8 GEMMs' share).
  5. profile — one more render under ``torch.profiler``: device busy
               time by kernel, K1's share, the idle share.
  6. train   — the flagship train step from a seeded student with 8
               objects on 4 targets a seeded teacher renders, in four modes
               named by their runtime flags: fused (``use_pallas`` +
               ``pallas_backward``: K1 + K2), hybrid (``pallas_hybrid``:
               K3), xla (the YAML's own runtime: the ray-structured path
               with remat) and layer_bwd (the same with
               ``pallas_layer_bwd``: K4); both ray-structured modes launch
               LF, 28 a step.  (a) one step of 4 x 4096 rays
               with the kernels against the same step on the plain
               versions (gradient relRMS gate 1e-2 per leaf; layer_bwd also
               against the xla step), (b) 30 steps of 4 x 4096 rays
               (launches per step, ms per step, rays/s; the fine loss must
               fall), (c) one fused, one hybrid and one layer_bwd step
               under ``torch.profiler`` (a kernel's device time sums all of
               its launches: K2 / K3 are a row pass and the dW products,
               K4 a row pass and the dw product; no row-tile pass may
               run at the flagship's bf16 shapes); then f32: one step each
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
               split into the row pass and the dW products, which a frozen
               model must not launch, nor the row-tile pass);
               single TTO of 4096 rays (ms per step, a profile) and batched
               K = 1
               against it from one generator (rtol 2e-5 on the codes, 1e-5
               on theta, the loss and the pose error); f32 fused and hybrid
               steps against the plain versions (gate 1e-4); 5 multi-view
               steps (2 objects x 2 views), then 5 SE(3) refine steps from
               the fused run's state and 5 multi-view SE(3) refine steps
               (xi starts at 0, every loss finite).
  8. cli     — the train entry point: an SRN-layout tree (8 train
               objects x 5 views, 2 val x 6, 128x128) the seeded teacher
               renders through K1, written as PNGs by
               ``data.png.write_png``, which filters rows as adaptive
               encoders do (mostly Paeth and Up), and read back equal, and
               timed, by ``data.png.read_png``; leg 1
               ``train.loop.run_training`` of ``configs/srn-cars-code.yml``
               (read by ``yaml_lite``: no PyYAML here) at its full widths
               for 10 steps with ``runtime.use_pallas`` and
               ``pallas_backward`` (K1 and K2 launched in training and in
               the validation at step 5, counted apart); the step-10
               checkpoint restored into a fresh state A, saved and
               restored into B: every tensor bit-identical, the LRs at
               ``lr_at_step(10)``, one more step from each bit-identical;
               leg 2 ``python3 -m codenerf_tpu_torch.train_cli`` resumes it
               to step 20 (exit 0, no yaml / imageio import, its
               ``config.yml`` read back by ``yaml_lite``); ms per step from
               the logged ``time_taken``, validation ms, PSNR and SSIM.
  8b. dist   — data parallelism over rays (``parallel/``) at the flagship
               width, on the cli phase's tree: (a) a world of one NCCL
               rank on ``cuda:0`` in this process: 6 fused train steps of
               4 x 4096 rays through the distributed code path,
               bit-identical to the same steps without a world (step 1's
               gradients, every parameter and moment after), ms beside the
               step without a world, the bytes all-reduced per step, and a
               ``torch.profiler`` step that must record NCCL's all_reduce;
               (b) two gloo ranks sharing ``cuda:0``
               (``parallel.launch.spawn``; 8,192 rays a rank): 3 fused
               train steps from the train phase's seeded student with the
               one-process draws (step 1's summed gradients at relRMS
               <= 1e-2 per leaf against the one-process step, parameters
               bit-identical across ranks, a falling fine loss), one
               batched fused TTO step of 4 x 4096 rays (loss within 1e-3,
               z_s / z_t / theta / phi / rho gradients at 1e-2), the
               128x128 image through K1 and the int8 image (40 dB against
               the one-process images; bit-identity printed; the int8
               buffers each rank calibrates bit-identical), and 10 steps
               of ``run_training`` of the flagship YAML with K1 + K2 and a
               validation at step 5 (rank 0 alone writes the checkpoint,
               parameters bit-identical across ranks, K1 and K2 launched on
               each rank); every number's ms beside the one-process one,
               on a line that says the two ranks share one card; (c) the
               same over NCCL with one card per rank where the machine has
               two, and one more train step per rank whose profile must
               hold NCCL's all-reduce kernel, else one line saying why it
               did not run.
  9. eval    — the eval entry point: first each trunk path's activation
               factor for ``eval/capacity.py`` (the slope of
               ``max_memory_allocated`` over one batched TTO step at K = 1
               and K = 2 of the flagship shape); then the v4 lineage's val
               split regenerated with its arguments by the port's generator
               (``python3 -m codenerf_tpu_torch.tools.make_synth_data``)
               beside an empty train split, and ``python3 -m
               codenerf_tpu_torch.eval_cli --all-objects --batch-objects 4``
               in a subprocess (yaml and imageio unimportable) on the
               committed ``fixtures/flagship-v4-cars-42100.ckpt`` with the
               campaign's protocol (8 restarts, 300 TTO steps, a 300-step
               flip rescue) through K1 + K2 (``use_pallas`` +
               ``pallas_backward``): the per-object table, the means beside
               JAX's 26.57 / 0.823 / 0.479 for the same checkpoint
               (RESULTS.md), the K capacity chose, objects per minute and
               the launches the subprocess counted; gates: exit 0, 8 finite
               rows, K1 and K2 launched, mean PSNR >= 22 dB; and the
               port's SSIM on the card against the CPU's (1e-4).  With
               ``runtime.int8_serving`` every object is also rendered
               through the int8 serving path: the trained-weights A/B,
               8 finite int8 rows, the int8 mean PSNR >= the full-precision
               mean - 1 dB (RESULTS.md's TPU A/B: -0.28 dB on the cars
               category mean).
  9b. tools  — the port's tools (``codenerf_tpu_torch/tools/``), each in
               a subprocess with yaml, imageio and PIL unimportable (the
               five processes run together), on the
               eval phase's split and committed checkpoint and the cli
               phase's tree and checkpoint: (a) the native SRN loader
               (``data/native.py``) built here by g++, the path the cli
               phase's training took (``native.status()``: native), every
               train view of the cli tree bit-identical to the
               ``read_png`` path, ms per image of both; (b)
               ``render_views`` of object 3, 4 turntable views through K1
               (8 launches a view) and 2 through ``--int8``, read back,
               view 0 against the same view through the plain trunk in
               this process (40 dB), the int8 views' PSNR against full
               precision; (c) ``phi_sweep`` of val object 0 at a cut
               protocol (50 TTO steps, 2 restarts, a 20-step flip, 36
               azimuths; K1 and K2 launched, a finite profile, the
               verdict); (d) ``diag_fine`` of the cli checkpoint's train
               view 0 through K1 (finite PSNRs, 3 PNGs); (e)
               ``gpu_selftest`` of every family (exit 0, each family's
               error and gate); (f) the sha256 of the eval split's decoded
               pixels beside the JAX-era tool's on a CPU machine.
 10. vanilla — vanilla NeRF (FlexibleNeRF) at the full widths of
               ``configs/lego.yml``, ``fern.yml`` and ``srn-cars.yml``, K4
               under ``pallas_layer_bwd``: K4 against its plain version at
               the lego and fern steps' shapes (bias b at K = N = 256 and
               64, per-ray b at N = h/2; S = 64 and 192; bf16 1e-2 and f32
               1e-4, bit-identical, timed with the plain and library
               versions); a Blender tree (16 train and 4 val RGBA views,
               256x256 written, 128x128 read) a seeded teacher renders,
               then (a) one lego step of 1 x 16384 rays with K4 against the
               plain-version step and the xla step (gradient relRMS 1e-2
               per leaf), (b) 10 steps in each runtime (xla, layer_bwd: 16
               K4 launches a step in layer_bwd, 36 LF launches a step in
               both; ms, rays/s, a falling fine loss), a
               profile of the K4 step, (c) one f32 step against the plain
               versions (1e-4); an LLFF tree (poses_bounds.npy, 20 PNGs of
               504x378 in images_8/) rendered in NDC, 5 fern steps (10 K4
               launches a step, the loss falls) and a 32x24 NDC image on
               the card against the CPU (40 dB); fern JPEG: the committed
               JPEG fixtures (``codenerf_tpu_torch/fixtures/jpeg/``)
               decoded by ``data/jpeg.py`` bit-equal to imageio's pixels
               (the 4032x3024 one by sha256), then an LLFF tree of 20
               copies of the 4032x3024 fixture in ``images/`` (no
               ``images_8/``), decoded and box-downsampled 8x by the
               loader (ms per decoded image on one thread and on
               ``read_jpegs``' threads, the harness's construction time;
               view 0 equal to the fixture's, NDC as the PNG tree's), 5
               steps (10 K4 launches a step) beside the PNG tree's, and
               the train CLI on it (2 steps, K4; yaml, imageio, PIL and
               TensorBoard unimportable); the train CLI on lego.yml
               in a subprocess at the YAML's 16 x 16384 rays in 16 ray
               chunks with K4 (3 steps, a validation, a checkpoint; yaml
               and imageio unimportable; peak memory), its checkpoint
               restored bit-identically, the eval CLI on it (finite PSNR);
               and 3 steps of srn-cars.yml on the cli phase's SRN tree.
               Each scene's teacher also renders an int8 image (lego
               128x128, fern 504x378 in NDC; calibrated as JAX's
               calibrator does, without NDC): ms and PSNR against full
               precision, gated card against CPU (40 dB) from the same
               buffers on a 16x16 / 32x24 image.
 11. result  — the kernel table as one JSON line (with each kernel's
               launches per TTO step, in the cli legs, in the eval, in
               each tool and in the vanilla steps), the card line, and the
               last line
               ``{"ok": true, "device": {...}}``.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Any failure
raises and exits nonzero without the last line.  ``python3 chip_smoke.py
--dist-only`` runs phases 1, 2 and 8b alone (on the cli phase's tree),
for a machine with two or more cards, where (c) runs.  Imports only torch, numpy,
the standard library and ``codenerf_tpu_torch``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from codenerf_tpu_torch.config import (SRN_CARS_CODE, config_from_dict,
                                       load_config, yaml_lite)
from codenerf_tpu_torch.data import (BatchIterator, SRNDataset, native,
                                     read_jpeg, read_jpegs, read_png,
                                     write_png)
from codenerf_tpu_torch.data.blender import box_downsample
from codenerf_tpu_torch.core import (mse2psnr, pixel_directions,
                                     pose_spherical, ssim)
from codenerf_tpu_torch.eval import (
    init_batched_tto_state, init_multiview_se3_refine_state,
    init_multiview_tto_state, init_se3_refine_state, init_tto_state,
    make_batched_tto_step, make_image_renderer,
    make_multiview_se3_refine_step, make_multiview_tto_step,
    make_se3_refine_step, make_tto_step)
from codenerf_tpu_torch.models import (CodeNeRF, CodeNeRFConfig, CodeTables,
                                       build_model, lookup_codes)
from codenerf_tpu_torch.ops import (_build, fused, layer_bwd, plain_versions,
                                    plan)
from codenerf_tpu_torch.ops.fused import (PER_RAY_KEYS, hybrid_forward_plain,
                                          kernel_weights, per_ray_parts,
                                          trunk_backward,
                                          trunk_backward_plain, trunk_forward,
                                          trunk_forward_plain)
from codenerf_tpu_torch.ops.layer_bwd import (linear_relu_bwd,
                                              linear_relu_bwd_plain)
from codenerf_tpu_torch.ops.layer_fwd import (linear_relu_fwd,
                                              linear_relu_fwd_plain)
from codenerf_tpu_torch.ops.products import _mmc
from codenerf_tpu_torch.core.encoding import positional_encoding
from codenerf_tpu_torch.pipeline import RenderSettings, trunk_path
from codenerf_tpu_torch.train import (checkpoint, init_train_state,
                                      lr_at_step, make_train_step)
from codenerf_tpu_torch.train import loop
from codenerf_tpu_torch.eval import capacity
from codenerf_tpu_torch.harness import Harness, int8_render_params
from codenerf_tpu_torch.parallel import close_world, init_world, launch
from codenerf_tpu_torch.models import quantized
from codenerf_tpu_torch.utils.logging import MetricLogger

SEED = 0
ROOT = Path(__file__).resolve().parent
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


def launch_counts() -> dict:
    return {"K1": trunk_forward.launches,
            "K2": trunk_backward.launches_recompute,
            "K3": trunk_backward.launches_stored,
            "K4": linear_relu_bwd.launches,
            "LF": linear_relu_fwd.launches}


def reset_launch_counts():
    trunk_forward.launches = 0
    trunk_backward.launches_recompute = 0
    trunk_backward.launches_stored = 0
    linear_relu_bwd.launches = 0
    linear_relu_fwd.launches = 0


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


def profile_step(label, step, args, step_ms, labels, card,
                 absent=()) -> dict:
    """``profile_call`` over one step, printed as the ``<label> profile``
    line and a JSON line; each label of ``absent`` (a kernel the step must
    not launch) must have no device time."""
    prof = profile_call(step, args, step_ms, labels)
    ran = [k for k in absent if prof["kernel_ms"][k]]
    if ran:
        raise RuntimeError(f"{label} profile: {ran} launched: "
                           f"{prof['kernel_ms']}")
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
    """The outputs of a trunk backward, by name (db1 and the weight grads
    only where it computed them)."""
    g_pts, g_per_ray, db1, dw = res
    out = {"g_pts": g_pts}
    out.update({f"g_{k}": g_per_ray[k] for k in PER_RAY_KEYS})
    if dw is not None:
        out["db1"] = db1
        out.update({f"d{k}": v for k, v in dw.items() if v is not None})
    return out


def check_bwd(settings, model, ro, rd, zs, zt, card) -> dict:
    """K2 and K3 against their plain version on the card: every output at
    R = 4096 rays and at the train step's R = len(ro) rays, S = 32 and 160
    (relRMS gate, bit-identity across two calls), the route
    ``plan.k2_plan`` took, a frozen-trunk call (``need_dw=False``) that
    must return the full call's g_pts and per-ray grads bit for bit, and
    kernel, frozen, plain and library (``trunk_backward_library``) times
    at the train step's R."""
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
                def kern(need_dw=True):
                    return trunk_backward(pts, per_ray, b1, weights, g, a,
                                          compute_dtype=cfg.cdtype,
                                          need_dw=need_dw)

                def frozen():
                    return kern(need_dw=False)

                def plain():
                    return trunk_backward_plain(pts, per_ray, b1, weights,
                                                g, a,
                                                compute_dtype=cfg.cdtype)

                got = bwd_outputs(kern())
                route = fused.trunk_backward.route
                again, cold, want = (bwd_outputs(f())
                                     for f in (kern, frozen, plain))
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
                if set(cold) != {"g_pts", *(f"g_{k}" for k in PER_RAY_KEYS)}:
                    raise RuntimeError(f"{name} need_dw=False returned "
                                       f"{sorted(cold)}")
                for k, v in cold.items():
                    if not torch.equal(v, got[k]):
                        raise RuntimeError(f"{name} {k} with need_dw=False "
                                           f"differs from the full call at "
                                           f"R={R}, S={S}")
                worst = max(errs, key=lambda k: errs[k][1])
                print(f"{name} R={R} S={S} ({route} route): every output "
                      f"bit-identical across two calls, the frozen call's "
                      f"({', '.join(cold)}) bit-identical to the full "
                      f"call's; max_abs_err / rel_rms: "
                      + ", ".join(f"{k} {v[0]:.3g}/{v[1]:.3g}"
                                  for k, v in errs.items()), flush=True)
                if not errs[worst][1] <= REL_RMS_GATE:
                    raise RuntimeError(
                        f"{name} disagrees with its plain version at R={R}, "
                        f"S={S}: {worst} relRMS {errs[worst][1]} > "
                        f"{REL_RMS_GATE}")
                row = {"R": R, "S": S, "route": route,
                       "max_abs_err": max(v[0] for v in errs.values()),
                       "rel_rms": errs[worst][1], "worst": worst}
                del got, again, cold, want
                if R == R_step:
                    def library():
                        return trunk_backward_library(pts, per_ray, b1,
                                                      weights, g, a)

                    ms = time_ms(kern, calls=3, repeats=5, warmup=1)
                    frozen_ms = time_ms(frozen, calls=3, repeats=5, warmup=1)
                    plain_ms = time_ms(plain, calls=1, repeats=3, warmup=1)
                    library_ms = time_ms(library, calls=3, repeats=5,
                                         warmup=1)
                    cost = bwd_cost(R, S, weights, per_ray, F, a is not None)
                    b_ms, b_by = bound_ms(cost)
                    row.update({"ms": ms, "frozen_ms": frozen_ms,
                                "plain_ms": plain_ms,
                                "library_ms": library_ms,
                                "bound_ms": b_ms, "bound_by": b_by,
                                "cost": cost})
                    print(f"{name} R={R} S={S}: ms={ms:.6g} "
                          f"frozen_ms={frozen_ms:.6g} "
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


# K4's cases: (name, R, S, per_ray, dtype, K, N); the coarse and fine
# shapes are the flagship step's (layer_xyz2 and layer_dir1 per-ray,
# layer_dir2 a bias), f32 the synth-smoke config's type, odd a masked tail
# tile; bf16 cases at R >= 4096 (the steps' rays) are timed
K4_CASES = (("coarse per-ray", 16384, 32, True, torch.bfloat16, 256, 256),
            ("coarse bias", 16384, 32, False, torch.bfloat16, 256, 256),
            ("fine per-ray", 16384, 160, True, torch.bfloat16, 256, 256),
            ("fine bias", 16384, 160, False, torch.bfloat16, 256, 256),
            ("f32 per-ray", 1024, 32, True, torch.float32, 256, 256),
            ("f32 bias", 1024, 32, False, torch.float32, 256, 256),
            ("odd per-ray", 1000, 24, True, torch.bfloat16, 256, 256),
            ("odd bias", 1000, 24, False, torch.bfloat16, 256, 256))
# K4 at the FlexibleNeRF steps' shapes: lego.yml (hidden 256: trunk layers
# and fc_feat a bias at K = N = 256, layer_dir1 per-ray at N = h/2 = 128;
# 16384 rays, S = 64 coarse and 192 fine) and fern.yml (hidden 64, N = 32
# per-ray; 4096 rays), in bf16 and in f32
K4_VANILLA_CASES = (
    ("lego coarse bias", 16384, 64, False, torch.bfloat16, 256, 256),
    ("lego fine bias", 16384, 192, False, torch.bfloat16, 256, 256),
    ("lego coarse per-ray", 16384, 64, True, torch.bfloat16, 256, 128),
    ("lego fine per-ray", 16384, 192, True, torch.bfloat16, 256, 128),
    ("fern coarse bias", 4096, 64, False, torch.bfloat16, 64, 64),
    ("fern fine bias", 4096, 192, False, torch.bfloat16, 64, 64),
    ("fern coarse per-ray", 4096, 64, True, torch.bfloat16, 64, 32),
    ("fern fine per-ray", 4096, 192, True, torch.bfloat16, 64, 32),
    ("f32 lego bias", 1024, 192, False, torch.float32, 256, 256),
    ("f32 lego per-ray", 1024, 192, True, torch.float32, 256, 128),
    ("f32 fern bias", 1024, 192, False, torch.float32, 64, 64),
    ("f32 fern per-ray", 1024, 192, True, torch.float32, 64, 32))


def check_k4(cases, card, seed=SEED + 6) -> list:
    """K4 against its plain version on the card: dx, dw and db at relRMS
    <= 1e-2 (1e-4 in f32) and bit-identical across two calls, at every case of
    ``cases``; kernel, plain and library times at the steps' shapes."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = []
    for name, R, S, per_ray, dt, K, N in cases:
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
        row = {"case": name, "R": R, "S": S, "K": K, "N": N,
               "per_ray": per_ray, "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": max(v[0] for v in errs.values()),
               "rel_rms": errs[worst][1], "worst": worst}
        line = (f"K4 {name} R={R} S={S} w ({K}, {N}) {row['dtype']}: every "
                f"output "
                f"bit-identical across two calls; max_abs_err / rel_rms: "
                + ", ".join(f"{k} {v[0]:.3g}/{v[1]:.3g}"
                            for k, v in errs.items()))
        gate = REL_RMS_GATE if dt == torch.bfloat16 else F32_REL_RMS_GATE
        if not errs[worst][1] <= gate:
            raise RuntimeError(f"K4 disagrees with its plain version in "
                               f"case {name}: {worst} relRMS "
                               f"{errs[worst][1]} > {gate}")
        if R >= 4096 and dt == torch.bfloat16:
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


# the fused linear + relu forward at lego.yml's relu layers: layer1 (K = 63),
# the trunk and fc_feat (a bias, K = N = 256), layer_dir1 (per-ray rows,
# N = h/2); 16384 rays, S = 64 coarse and 192 fine.  (name, S, per_ray, K, N)
LAYER_FWD_CASES = tuple(
    (f"{name} {pass_}", S, per_ray, K, N)
    for pass_, S in (("coarse", 64), ("fine", 192))
    for name, per_ray, K, N in (("layer1", False, 63, 256),
                                ("trunk", False, 256, 256),
                                ("layer_dir1", True, 256, 128)))
# the share of the fused forward's elements that may differ from the plain
# version (an H100 showed 0 at K = 256 and ~1.4e-6 at K = 63)
LAYER_FWD_DIFFER = 1e-5
# lego's relu layer-passes a chunk-step, by case name without its pass:
# layer1, 7 bias layers (6 trunk layers and fc_feat), layer_dir1, each in
# the forward and its remat recompute
LEGO_LF_PASSES = {"layer1": 2, "trunk": 14, "layer_dir1": 2}


def bf16_step(t, step):
    """The bf16 value ``step`` ulps from each element of bf16 ``t``."""
    i = t.view(torch.int16).int()
    o = torch.where(i < 0, -(i & 0x7FFF), i) + step
    return torch.where(o < 0, (-o) | 0x8000, o).to(torch.int16).view(
        torch.bfloat16)


def layer_fwd_off(x, w, b, got):
    """Elements of the fused forward's ``got`` that its product's f32 sums
    in another order cannot explain (the card test's rule): each must be
    relu(bf16(y' + b)) for a y' within one bf16 ulp of the eager product
    y, or, where y's sum cancels so far that 2 K 2^-24 (|x| @ |w|) passes
    half an ulp of y, lie within that bound of the eager output."""
    y = _mmc(x, w, torch.bfloat16)
    want = torch.relu(y + b)
    near = got == want
    for step in (-1, 1):
        near |= got == torch.relu(bf16_step(y, step) + b)
    if bool(near.all()):
        return near.logical_not()
    k = x.shape[-1]
    bound = (2 * k * 2.0 ** -24 * (x.float().abs().reshape(-1, k)
                                   @ w.to(torch.bfloat16).float().abs())
             ).reshape(y.shape)
    gap = (got.float() - want.float()).abs()
    slack = 2 * bound + 2.0 ** -7 * (y.float().abs() + want.float().abs())
    return ~near & ~((bound > y.float().abs() * 2.0 ** -9) & (gap <= slack))


def check_layer_fwd(card, rays=16384, seed=SEED + 36) -> list:
    """The fused linear + relu forward against its plain version (the
    cuBLAS product, a bias add, a relu) at lego's shapes: every element
    within the product's rounding (``layer_fwd_off``), at most
    ``LAYER_FWD_DIFFER`` of them differing, bit-identical across two calls;
    kernel, plain and product-alone (cuBLAS, ``_mmc``) times beside the
    bound, rows (K + N) 2 bytes at the card's byte rate."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = []
    for name, S, per_ray, K, N in LAYER_FWD_CASES:
        x = torch.randn(rays, S, K, generator=gen).to(torch.bfloat16).cuda()
        w = (torch.randn(N, K, generator=gen) * K ** -0.5).cuda().t()
        b = (torch.randn((rays, 1, N) if per_ray else (N,), generator=gen)
             * 0.5).to(torch.bfloat16).cuda()

        def kern():
            return linear_relu_fwd(x, w, b, torch.bfloat16)

        def plain():
            return linear_relu_fwd_plain(x, w, b, torch.bfloat16)

        def library():
            return _mmc(x, w, torch.bfloat16)

        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise RuntimeError(f"layer_fwd {name}: two calls differ")
        off = int(layer_fwd_off(x, w, b, got).sum())
        differ = float((got != want).float().mean())
        if off or not differ <= LAYER_FWD_DIFFER:
            raise RuntimeError(f"layer_fwd {name}: {off} elements outside "
                               f"the product's rounding, {differ:.3g} of "
                               f"them differ from the plain version")
        del got, again, want
        ms = time_ms(kern, calls=5, repeats=5, warmup=2)
        plain_ms = time_ms(plain, calls=5, repeats=5, warmup=2)
        library_ms = time_ms(library, calls=5, repeats=5, warmup=2)
        M = rays * S
        cost = {"bf16_flops": 2 * M * K * N, "f32_ops": 0,
                "bytes": M * (K + N) * 2 + K * N * 2}
        b_ms, b_by = bound_ms(cost)
        row = {"case": name, "R": rays, "S": S, "K": K, "N": N,
               "per_ray": per_ray, "differ": differ, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": b_ms, "bound_by": b_by, "cost": cost}
        print(f"layer_fwd {name} R={rays} S={S} w ({K}, {N}) "
              f"{'per-ray' if per_ray else 'bias'}: every element within "
              f"the product's rounding, {differ:.3g} of them differ from "
              f"plain, bit-identical across two calls; ms={ms:.6g} "
              f"plain_ms={plain_ms:.6g} library_ms={library_ms:.6g} "
              f"bound_ms={b_ms:.6g} ({b_by}, {b_ms / ms:.1%} of it) on "
              f"{card}", flush=True)
        rows.append(row)
        del x, w, b
        torch.cuda.empty_cache()
    return rows


# widths past the limits the kernels once had (plan.py): hidden and code
# widths that are not multiples of 32 run zero-padded; bf16 K1 wider than
# K1_MAX_WIDTH or with more than K1_MAX_BANDS bands runs the row-tile
# forward; bf16 K4 wider than K4_MAX_WIDTH reads w from global memory;
# rows too wide for a full row tile run a half or a quarter tile
# (plan.row_tile: hidden 864 a half and 1760 a quarter in K1-K3; N = 1760
# a half and 3520 a quarter in K4).  The last field is R
WIDTH_CASES = (("h288 s80 F12", 288, 80, 12, torch.bfloat16, 2048),
               ("h48 s40 F10", 48, 40, 10, torch.bfloat16, 2048),
               ("h48 s40 F10 f32", 48, 40, 10, torch.float32, 2048),
               ("h864 s864 F6", 864, 864, 6, torch.bfloat16, 128),
               ("h864 s864 F6 f32", 864, 864, 6, torch.float32, 128),
               ("h1760 s1760 F6", 1760, 1760, 6, torch.bfloat16, 64),
               ("h1760 s1760 F6 f32", 1760, 1760, 6, torch.float32, 64))
K4_WIDTH_CASES = (("w (48, 288)", 48, 288, torch.bfloat16, 2048),
                  ("w (40, 24)", 40, 24, torch.bfloat16, 2048),
                  ("w (40, 24) f32", 40, 24, torch.float32, 2048),
                  ("w (64, 1760)", 64, 1760, torch.bfloat16, 256),
                  ("w (16, 3520)", 16, 3520, torch.bfloat16, 64))
WIDTH_S = 64


def _errs(got: dict, again: dict, want: dict, label: str) -> dict:
    """(max abs, relRMS) of every output against its plain version; each
    output finite and bit-identical across two calls."""
    errs = {}
    for k, w in want.items():
        a = got[k]
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{label}: {k} is not finite")
        if not torch.equal(a, again[k]):
            raise RuntimeError(f"{label}: {k} differs between two calls")
        d = a.float() - w.float()
        errs[k] = (float(d.abs().max()),
                   float(torch.linalg.norm(d) / torch.linalg.norm(w.float())))
    return errs


def _gate_widths(label, errs, gate) -> dict:
    worst = max(errs, key=lambda k: errs[k][1])
    print(f"{label}: every output bit-identical across two calls; "
          f"max_abs_err / rel_rms: "
          + ", ".join(f"{k} {v[0]:.3g}/{v[1]:.3g}" for k, v in errs.items()),
          flush=True)
    if not errs[worst][1] <= gate:
        raise RuntimeError(f"{label} disagrees with its plain version: "
                           f"{worst} relRMS {errs[worst][1]} > {gate}")
    return {"case": label, "max_abs_err": max(v[0] for v in errs.values()),
            "rel_rms": errs[worst][1], "worst": worst}


def check_widths(card) -> dict:
    """K1, K2, K3 and K4 at widths past the limits the kernels once had,
    against their plain versions at each case's R, S = 64 (K4: M = R S
    rows, per-ray rows), with the gates of the kernels phase (relRMS 1e-2
    in bf16, 1e-4 in f32) and bit-identity across two calls.  K1's route
    and every row pass's tile rows are the ones the plans picked."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 13)
    out = {"K1": [], "K2": [], "K3": [], "K4": []}
    S = WIDTH_S
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, H, SC, F, cd, R in WIDTH_CASES:
        gate = REL_RMS_GATE if cd == torch.bfloat16 else F32_REL_RMS_GATE
        cfg = CodeNeRFConfig(hidden_size=H, shape_code_size=SC,
                             texture_code_size=SC, num_encoding_fn_xyz=F,
                             compute_dtype=str(cd).replace("torch.", ""))
        model = CodeNeRF(cfg, "cuda", gen)
        pts = ((torch.rand(R, S, 3, generator=gen) * 2 - 1)).cuda()
        dir_enc = torch.randn(R, cfg.dim_dir, generator=gen).cuda()
        zs = torch.randn(R, SC, generator=gen).cuda()
        zt = torch.randn(R, SC, generator=gen).cuda()
        g = torch.randn(R, S, 4, generator=gen).cuda()
        with torch.no_grad():
            per_ray = per_ray_parts(model, dir_enc, zs, zt)
            weights = kernel_weights(model, F, True)
        _, launch = fused.trunk_forward_launcher(pts, per_ray, weights,
                                                 compute_dtype=cd)
        route = launch.route
        es = 2 if cd == torch.bfloat16 else 4
        k1_rows = plan.k1_plan(R, S, H, SC, F, es, n_sm)["tile_rows"]
        bwd_pl = plan.k2_plan(R, S, H, SC, F, True, es, n_sm, False)
        bwd_route, bwd_rows = bwd_pl["route"], bwd_pl["rows"]["tile_rows"]
        before = trunk_forward.launches
        got, again = (trunk_forward(pts, per_ray, weights, compute_dtype=cd)
                      for _ in range(2))
        want = trunk_forward_plain(pts, per_ray, weights, compute_dtype=cd)
        torch.cuda.synchronize()
        if trunk_forward.launches != before + 2:
            raise RuntimeError(f"K1 {name}: launched "
                               f"{trunk_forward.launches - before} times")
        out["K1"].append(dict(_gate_widths(
            f"widths K1 {name} R={R} ({route} route, {k1_rows}-row tiles)",
            _errs({"raw": got}, {"raw": again}, {"raw": want},
                  f"K1 {name}"), gate), route=route, tile_rows=k1_rows))
        _, acts = hybrid_forward_plain(pts, per_ray, weights,
                                       compute_dtype=cd)
        for kname, a in (("K2", None), ("K3", acts)):
            got, again, want = (bwd_outputs(f(pts, per_ray, weights["b1"],
                                              weights, g, a,
                                              compute_dtype=cd))
                                for f in (trunk_backward, trunk_backward,
                                          trunk_backward_plain))
            torch.cuda.synchronize()
            out[kname].append(dict(_gate_widths(
                f"widths {kname} {name} R={R} ({bwd_route} route, "
                f"{bwd_rows}-row tiles)",
                _errs(got, again, want, f"{kname} {name}"), gate),
                route=bwd_route, tile_rows=bwd_rows))
        del model, acts
    for name, K, N, dt, R in K4_WIDTH_CASES:
        gate = REL_RMS_GATE if dt == torch.bfloat16 else F32_REL_RMS_GATE
        cd = torch.bfloat16 if dt == torch.bfloat16 else None
        x = torch.relu(torch.randn(R, S, K, generator=gen)).to(dt).cuda()
        w = ((torch.rand(K, N, generator=gen) * 2 - 1) / K ** 0.5).cuda()
        y = torch.relu(torch.randn(R, S, N, generator=gen)).to(dt).cuda()
        gg = (torch.randn(R, S, N, generator=gen) * 1e-3).to(dt).cuda()
        b = torch.zeros(R, 1, N, dtype=dt).cuda()
        k, n, w_in_smem = plan.k4_layout(K, N, x.element_size())
        k4_rows = plan.layer_bwd_plan(R * S, S, k, n, True, x.element_size(),
                                      n_sm, w_in_smem)["rows"]["tile_rows"]
        got, again, want = (dict(zip(("dx", "dw", "db"),
                                     f(x, w, b, y, gg, cd)))
                            for f in (linear_relu_bwd, linear_relu_bwd,
                                      linear_relu_bwd_plain))
        torch.cuda.synchronize()
        layout = "w in shared memory" if w_in_smem else "w from global memory"
        out["K4"].append(dict(_gate_widths(
            f"widths K4 {name} R={R} (padded to ({k}, {n}), {layout}, "
            f"{k4_rows}-row tiles)",
            _errs(got, again, want, f"K4 {name}"), gate),
            layout=layout, tile_rows=k4_rows))
    torch.cuda.empty_cache()
    print(f"widths: K1 K2 K3 K4 past the old limits agree with their plain "
          f"versions on {card}", flush=True)
    return out


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
# (LF, the fused linear + relu forward, in the ray-structured modes: 7 relu
# layers x 2 networks x the forward and its remat recompute, in TTO too)
TRAIN_MODES = {
    "fused": ({"use_pallas": True, "pallas_backward": True},
              {"K1": 2, "K2": 2, "K3": 0, "K4": 0, "LF": 0}),
    "hybrid": ({"pallas_hybrid": True},
               {"K1": 0, "K2": 0, "K3": 2, "K4": 0, "LF": 0}),
    "xla": ({}, {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "LF": 28}),
    "layer_bwd": ({"pallas_layer_bwd": True},
                  {"K1": 0, "K2": 0, "K3": 0, "K4": 6, "LF": 28}),
}


# the device kernels of each port kernel, by name substring, in the modes
# that are profiled: K2 and K3 are a row pass (bf16 at the flagship: the
# wgmma row pass; f32 and wider shapes: the row-tile pass), the dW products
# (xtg.cuh) and two sums; K4 a row pass, the dw product and its sums
XTG = ("xtg_wgmma_kernel", "xtg_simt_kernel", "xtg_reduce")
ROWS = ("trunk_bwd_rows_wgmma", "trunk_bwd_rows_kernel")
PROFILE_LABELS = {
    "fused": {"K1": ("trunk_fwd_kernel",),
              "K2": (*ROWS, *XTG), "K2 row pass": ROWS, "K2 dW": XTG,
              "K2 row-tile pass": ("trunk_bwd_rows_kernel",)},
    "hybrid": {"K3": (*ROWS, *XTG), "K3 row pass": ROWS, "K3 dW": XTG,
               "K3 row-tile pass": ("trunk_bwd_rows_kernel",)},
    "layer_bwd": {"K4": ("layer_bwd_rows", *XTG),
                  "K4 row pass": ("layer_bwd_rows",), "K4 dw": XTG,
                  "LF": ("layer_fwd_wgmma",)},
}
# what a profiled flagship step must not launch: the row-tile pass (bf16
# takes the wgmma row pass there) and, in TTO (a frozen model), the dW
# products
TRAIN_ABSENT = {"fused": ("K2 row-tile pass",),
                "hybrid": ("K3 row-tile pass",)}
TTO_ABSENT = {"fused": ("K2 row-tile pass", "K2 dW"),
              "hybrid": ("K3 row-tile pass", "K3 dW")}


def mode_config(flags: dict):
    """(cfg, settings) of the flagship values with ``flags`` set in the
    runtime section."""
    d = copy.deepcopy(SRN_CARS_CODE)
    d["runtime"].update(flags)
    cfg = config_from_dict(d)
    return cfg, RenderSettings.from_config(cfg)


def grads_of(state) -> dict:
    named = [(f"{'codes' if k == 'tables' else k}.{n}", p)
             for k, m in state.modules().items()
             for n, p in m.named_parameters()]
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
                step_ms, PROFILE_LABELS[mode], card,
                TRAIN_ABSENT.get(mode, ()))
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
                PROFILE_LABELS[mode], card, TTO_ABSENT.get(mode, ()))
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
                               single_ms, PROFILE_LABELS["fused"], card,
                               TTO_ABSENT["fused"])
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


# the cli phase: an SRN-layout tree the seeded teacher renders through K1
CLI_SPLITS = (("train", 8, 5), ("val", 2, 6))      # objects, views
CLI_STEPS = 10
CLI_YAML = "configs/srn-cars-code.yml"
# ``python3 -m codenerf_tpu_torch.train_cli`` with yaml and imageio
# unimportable (None in sys.modules); its last line lists the modules of
# yaml, imageio, jax or codenerf_tpu that were loaded
REFUSED = ("yaml", "imageio", "jax", "codenerf_tpu")


def cli_runner(blocked=("yaml", "imageio")) -> str:
    """The train CLI's runner with the modules ``blocked`` unimportable;
    its last line lists the loaded modules of the packages ``REFUSED``
    and ``blocked`` name."""
    refused = REFUSED + tuple(m for m in blocked
                              if "." not in m and m not in REFUSED)
    return ("import json, runpy, sys, torch; "
            f"sys.modules.update(dict.fromkeys({blocked!r})); "
            "runpy.run_module('codenerf_tpu_torch.train_cli', "
            "run_name='__main__', alter_sys=True); "
            "from codenerf_tpu_torch.ops.layer_bwd import linear_relu_bwd; "
            "print('stats ' + json.dumps({'peak_bytes': "
            "torch.cuda.max_memory_allocated(), "
            "'K4': linear_relu_bwd.launches})); "
            "print('loaded ' + json.dumps(sorted("
            "m for m, v in sys.modules.items() if v is not None and "
            f"m.split('.')[0] in {refused!r})))")


CLI_RUNNER = cli_runner()
OPENGL_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


def make_srn_tree(root: Path, size, dirs, teacher, tables) -> dict:
    """The layout of ``tools/make_synth_data.py``: ``<root>/cars_<stage>/
    obj<k>/{intrinsics.txt, pose/*.txt, rgb/*.png}``, each view rendered
    through K1 by ``teacher`` with its object's codes (train objects take
    rows 0-7 of ``tables``, val objects 8-9) from a spherical pose, the
    pose stored before the loader's OpenGL flip.  Every PNG is read back
    with ``read_png`` and must equal the bytes written.  Returns the
    number of images, the rows of each filter and the ms of each
    ``read_png``."""
    _, k1_settings = mode_config(TRAIN_MODES["fused"][0])
    render = make_image_renderer(k1_settings, size, size, 4096, "cuda")
    rng = np.random.default_rng(SEED + 12)
    row, n_images = 0, 0
    filters, decode_ms = np.zeros(5, np.int64), []
    for stage, n_obj, n_views in CLI_SPLITS:
        for o in range(n_obj):
            d = root / f"cars_{stage}" / f"obj{o:03d}"
            (d / "rgb").mkdir(parents=True)
            (d / "pose").mkdir()
            (d / "intrinsics.txt").write_text(
                f"{SRN_FOCAL_128} {size / 2} {size / 2} 0.\n0. 0. 0.\n1.\n"
                f"{size} {size}\n")
            codes = lookup_codes(tables, torch.tensor([row], device="cuda"))
            row += 1
            for v in range(n_views):
                theta = (rng.uniform(0.45, 1.95) if stage == "train"
                         else rng.uniform(0.95, 1.45))
                pose = pose_spherical(theta, rng.uniform(0.0, 2 * np.pi),
                                      1.3, device="cuda")
                with torch.no_grad():
                    img = render(teacher, dirs, pose, *codes)
                u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8).reshape(
                    size, size, 3).cpu().numpy()
                path = d / "rgb" / f"{v:06d}.png"
                kinds = write_png(path, u8)
                filters += np.bincount(kinds, minlength=5)
                t_read = time.perf_counter()
                back = read_png(path)
                decode_ms.append((time.perf_counter() - t_read) * 1e3)
                if not np.array_equal(back, u8):
                    raise RuntimeError(f"read_png({path}) differs from the "
                                       "pixels written")
                np.savetxt(d / "pose" / f"{v:06d}.txt",
                           (pose.double().cpu().numpy()
                            @ OPENGL_FLIP).reshape(1, 16))
                n_images += 1
    return {"images": n_images, "filters": filters.tolist(),
            "decode_ms": decode_ms}


def state_tensors(state) -> dict:
    """Every tensor of a train state by name (optimizer moments and steps
    under their parameter's name), the LRs and the steps."""
    params = {f"{k}.{n}": p for k, m in state.modules().items()
              for n, p in m.named_parameters()}
    out = {n: p.detach() for n, p in params.items()}
    names = {id(p): n for n, p in params.items()}
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"{names[id(p)]}.{k}"] = v
    out["lr"] = torch.tensor([g["lr"] for g in state.optimizer.param_groups],
                             dtype=torch.float64)
    sched = state.scheduler.state_dict()
    out["steps"] = torch.tensor([sched["last_epoch"], sched["_step_count"],
                                 state.step])
    return out


def bit_identical(a: dict, b: dict) -> list:
    """Names whose tensors differ (dtype, shape or any bit)."""
    if a.keys() != b.keys():
        return sorted(set(a) ^ set(b))
    return [k for k in a if a[k].dtype != b[k].dtype
            or not torch.equal(a[k], b[k])]


def jsonl(path: Path) -> list:
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def cli_tables() -> CodeTables:
    """The codes of the cli phase's SRN tree's 10 objects."""
    emb = SRN_CARS_CODE["models"]["embedding"]
    return CodeTables(10, emb["shape_code_size"], emb["texture_code_size"],
                      "cuda",
                      torch.Generator(device="cpu").manual_seed(SEED + 11))


def cli_phase(size, dirs, teacher, fused_ms, card, then=None,
              keep=False) -> dict:
    """The train entry point on the card (phase 8): an SRN tree made on
    the card, ``run_training`` of the flagship YAML at its full widths for
    ``CLI_STEPS`` steps with K1 and K2 (``use_pallas`` +
    ``pallas_backward``, validation every 5 steps), the step-10 checkpoint
    restored bit-identically, and the train CLI in a subprocess resuming
    it to step 20.  ``fused_ms`` is the train phase's fused step, printed
    beside the CLI's.  ``then(root, work)``, if given, runs on the SRN
    tree before it is removed; its result is under "then".  With ``keep``
    the tree and the checkpoints stay (under "work", "root", "ckpt"), and
    the caller removes "work"."""
    tables = cli_tables()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        t0 = time.perf_counter()
        root = work / "srn_cars"
        tree = make_srn_tree(root, size, dirs, teacher, tables)
        # the first read builds read_png's predictor table
        decode_ms = statistics.median(tree["decode_ms"][1:])
        print(f"cli: wrote {tree['images']} PNGs of {size}x{size} (8 train "
              f"objects x 5 views, 2 val x 6) rendered through K1, rows "
              f"filtered adaptively (None / Sub / Up / Average / Paeth: "
              f"{tree['filters']}), read back equal by read_png in a median "
              f"{decode_ms:.6g} ms per image (first {tree['decode_ms'][0]:.6g}"
              f" ms), in {time.perf_counter() - t0:.4g} s", flush=True)
        # the loop validates when i % validate_every == 0 and i < the last
        # step, so validate_every = 10 would never validate in a 10-step
        # leg: 5 validates at step 5 (leg 1) and 15 (leg 2)
        overrides = [f"dataset.basedir={root}", f"experiment.logdir={work}",
                     "experiment.id=cli", "experiment.save_every=10",
                     "experiment.validate_every=5",
                     "experiment.val_iterations=10",
                     "experiment.print_every=5", "runtime.use_pallas=True",
                     "runtime.pallas_backward=True"]
        cfg = load_config(ROOT / CLI_YAML, overrides)
        logdir = work / "cli"

        # leg 1, in this process; validate is wrapped to count its launches
        val_runs = []
        validate = loop.validate

        def counted_validate(*args, **kwargs):
            torch.cuda.synchronize()
            before, t_v = launch_counts(), time.perf_counter()
            out = validate(*args, **kwargs)
            torch.cuda.synchronize()
            val_runs.append({
                "ms": (time.perf_counter() - t_v) * 1e3,
                "launches": {k: v - before[k]
                             for k, v in launch_counts().items()},
                "metrics": out})
            return out

        loop.validate = counted_validate
        torch.cuda.synchronize()
        reset_launch_counts()
        t_leg = time.perf_counter()
        try:
            loop.run_training(cfg, max_steps=CLI_STEPS)
        finally:
            loop.validate = validate
        torch.cuda.synchronize()
        leg1_s = time.perf_counter() - t_leg
        total = launch_counts()
        if len(val_runs) != 1:
            raise RuntimeError(f"leg 1 validated {len(val_runs)} times, "
                               "expected once (step 5)")
        val = val_runs[0]
        train_launches = {k: total[k] - val["launches"][k] for k in total}
        for name in ("K1", "K2"):
            if not (train_launches[name] > 0 and val["launches"][name] > 0):
                raise RuntimeError(f"cli leg 1: {name} launched "
                                   f"{train_launches[name]} times in "
                                   f"training, {val['launches'][name]} in "
                                   "validation")
        recs = jsonl(logdir / "metrics.jsonl")
        train_recs = {r["step"]: r for r in recs if r["mode"] == "train"}
        if sorted(train_recs) != [5, 10]:
            raise RuntimeError(f"leg 1 logged steps {sorted(train_recs)}")
        # the step-10 window holds the validation at step 5
        step_ms = (train_recs[10]["time_taken"] * 1e3 - val["ms"]) / 5
        vm = val["metrics"]
        if not finite([vm["psnr"], vm["ssim"], train_recs[5]["nerf_loss_fine"],
                       train_recs[10]["nerf_loss_fine"]]):
            raise RuntimeError(f"cli leg 1: not finite: {vm}, {train_recs}")
        rays = (cfg.dataset.train_batch_size
                * cfg.nerf.ray_sampler.num_random_rays)
        print(f"cli leg 1: run_training({CLI_YAML}, max_steps={CLI_STEPS}) "
              f"in {leg1_s:.4g} s: steps 6-10 {step_ms:.6g} ms/step "
              f"({rays / step_ms * 1e3:.6g} rays/s; steps 1-5 with warm-up "
              f"{train_recs[5]['time_taken'] * 1e3 / 5:.6g} ms/step); fine "
              f"loss step 5 {train_recs[5]['nerf_loss_fine']:.6g}, step 10 "
              f"{train_recs[10]['nerf_loss_fine']:.6g}; validation at step "
              f"5 ({cfg.experiment.val_iterations} TTO steps + the "
              f"{val_image(cfg)} image) {val['ms']:.6g} ms, PSNR "
              f"{vm['psnr']:.6g} dB, SSIM {vm['ssim']:.6g}; launches "
              f"training {train_launches}, validation {val['launches']}",
              flush=True)

        # restore the step-10 checkpoint into A, save A, restore it into B
        ckdir = logdir / "checkpoints"
        if checkpoint.latest_step(ckdir) != CLI_STEPS:
            raise RuntimeError(f"leg 1 left step "
                               f"{checkpoint.latest_step(ckdir)}")
        settings = RenderSettings.from_config(cfg)
        n_obj = CLI_SPLITS[0][1]
        a = init_train_state(cfg, settings, n_obj, seed=SEED + 20,
                             device="cuda")
        checkpoint.restore_checkpoint(ckdir, a, step=CLI_STEPS)
        checkpoint.save_checkpoint(work / "copy", a)
        b = init_train_state(cfg, settings, n_obj, seed=SEED + 21,
                             device="cuda")
        checkpoint.restore_checkpoint(work / "copy", b)
        differ = bit_identical(state_tensors(a), state_tensors(b))
        opt = cfg.optimizer
        want_lr = [lr_at_step(lr, opt.scheduler_gamma,
                              opt.scheduler_step_size, CLI_STEPS)
                   for lr in (opt.lr, opt.lr, opt.resolved_embedding_lr)]
        got_lr = [g["lr"] for g in a.optimizer.param_groups]
        if differ or got_lr != want_lr or not a.optimizer.state:
            raise RuntimeError(f"restore: differ {differ}, lr {got_lr} "
                               f"against {want_lr}")
        ds = SRNDataset(str(root), "train")
        batch = BatchIterator(ds, cfg.dataset.train_batch_size,
                              seed=SEED).fixed_batch()
        K = torch.from_numpy(ds[0]["intrinsic"]).cuda()
        h, w = batch["color"].shape[1:3]
        inputs = (pixel_directions(h, w, K),
                  torch.from_numpy(batch["pose"]).cuda(),
                  torch.from_numpy(batch["color"]).cuda(),
                  torch.from_numpy(batch["object_id"]).cuda())
        for st in (a, b):
            make_train_step(settings, st, cfg.nerf.ray_sampler.num_random_rays,
                            cfg.experiment.regularizer_lambda, True)(
                *inputs, torch.Generator(device="cuda").manual_seed(SEED))
        differ_step = bit_identical(state_tensors(a), state_tensors(b))
        if differ_step:
            raise RuntimeError(f"one step from A and B: {differ_step} differ")
        print(f"cli restore: step {CLI_STEPS} -> state A -> save -> state B: "
              f"{len(state_tensors(a))} tensors bit-identical (moments and "
              f"scheduler included), LRs {got_lr} = lr_at_step; one more "
              f"step from each with the same draws: bit-identical",
              flush=True)
        # the validation again, warm (leg 1's was the process's first
        # SSIM and first single-object TTO); its TTO share from the log
        warm_dir = work / "warm"
        logger = MetricLogger(warm_dir, enable_tensorboard=False)
        torch.cuda.synchronize()
        t_v = time.perf_counter()
        loop.validate(Harness.from_config(cfg), {**a.models,
                                                 "codes": a.tables},
                      logger, CLI_STEPS + 1)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t_v) * 1e3
        logger.close()
        tto_ms = {name: [r["time_taken"] * 1e3 for r in jsonl(path)
                         if r["mode"] == "val-optim"][-1]
                  for name, path in (("leg 1", logdir / "metrics.jsonl"),
                                     ("warm", warm_dir / "metrics.jsonl"))}
        print(f"cli validation: leg 1 {val['ms']:.6g} ms (its "
              f"{cfg.experiment.val_iterations} TTO steps "
              f"{tto_ms['leg 1']:.6g} ms), warm {warm_ms:.6g} ms (TTO "
              f"{tto_ms['warm']:.6g} ms) on {card}", flush=True)
        del a, b

        # leg 2: the train CLI in a subprocess resumes the checkpoint, with
        # yaml and imageio made unimportable (this machine may have PyYAML,
        # which load_config would prefer), so it runs on the stand-ins
        cmd = [sys.executable, "-c", CLI_RUNNER,
               "-c", CLI_YAML, *overrides, "--max-steps", str(CLI_STEPS)]
        t_leg = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        leg2_s = time.perf_counter() - t_leg
        if proc.returncode != 0:
            raise RuntimeError(f"train CLI exited {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        refused = json.loads(proc.stdout.splitlines()[-1][len("loaded "):])
        last = checkpoint.latest_step(ckdir)
        dumped = config_from_dict(yaml_lite.safe_load(
            (logdir / "config.yml").read_text()))
        recs = jsonl(logdir / "metrics.jsonl")
        leg2 = {r["step"]: r for r in recs if r["mode"] == "train"
                and r["step"] > CLI_STEPS}
        leg2_val = [r for r in recs if r["mode"] == "val"
                    and r["step"] > CLI_STEPS]
        if (refused or last != 2 * CLI_STEPS or dumped != cfg
                or sorted(leg2) != [15, 20] or len(leg2_val) != 1
                or not finite([leg2_val[0]["psnr"], leg2_val[0]["ssim"]])):
            raise RuntimeError(f"train CLI: imported {refused}, latest step "
                               f"{last}, config.yml equal {dumped == cfg}, "
                               f"train records {sorted(leg2)}, val "
                               f"{leg2_val}")
        print(f"cli leg 2: python3 -m codenerf_tpu_torch.train_cli -c "
              f"{CLI_YAML} --max-steps {CLI_STEPS} (yaml and imageio "
              f"unimportable): exit 0 in {leg2_s:.4g} s, "
              f"resumed at {CLI_STEPS}, latest step {last}; fine loss step "
              f"15 {leg2[15]['nerf_loss_fine']:.6g}, step 20 "
              f"{leg2[20]['nerf_loss_fine']:.6g}; validation at 15 PSNR "
              f"{leg2_val[0]['psnr']:.6g} dB SSIM {leg2_val[0]['ssim']:.6g}; "
              f"no module of {', '.join(REFUSED)} loaded; config.yml read "
              f"back by yaml_lite equal", flush=True)
        after = then(root, work) if then else None
        print(f"cli: {step_ms:.6g} ms/step (fused train step {fused_ms:.6g}),"
              f" {rays / step_ms * 1e3:.6g} rays/s, validation "
              f"{val['ms']:.6g} ms, read_png {decode_ms:.6g} ms per image on "
              f"{card}", flush=True)
        return {"step_ms": step_ms, "rays_per_s": rays / step_ms * 1e3,
                "fused_step_ms": fused_ms, "read_png_ms": decode_ms,
                "png_filters": tree["filters"],
                "first5_ms_per_step": train_recs[5]["time_taken"] * 1e3 / 5,
                "validation_ms": val["ms"], "validation_warm_ms": warm_ms,
                "validation_tto_ms": tto_ms, "val_psnr": vm["psnr"],
                "val_ssim": vm["ssim"],
                "fine_loss": {s: train_recs[s]["nerf_loss_fine"]
                              for s in (5, 10)}
                | {s: leg2[s]["nerf_loss_fine"] for s in (15, 20)},
                "train_launches": train_launches,
                "val_launches": val["launches"], "leg1_s": leg1_s,
                "leg2_s": leg2_s, "images": tree["images"], "then": after,
                **({"work": work, "root": root, "ckpt": ckdir} if keep
                   else {})}
    finally:
        if not keep or sys.exc_info()[0] is not None:
            shutil.rmtree(work, ignore_errors=True)


# the int8 serving path (models/quantized.py): its products are
# torch._int_mm, cuBLASLt's int8 GEMM; the profile counts every device
# kernel whose name holds one of these as an int8 GEMM (the H100 showed
# cutlass_80_tensorop_i16832gemm_s8_128x64_128x3_tn_align16)
INT8_GEMM_NAMES = ("gemm_s8", "s8s8", "i8i8", "imma", "igemm")
INT8_CHECK_RAYS = 1024      # the calibration held card against CPU
INT8_RENDERS = 10


def cpu_copy(models: dict) -> dict:
    """The {"coarse", "fine"} modules copied to the CPU."""
    return {k: copy.deepcopy(m).to("cpu") for k, m in models.items()}


def int8_harness(cfg, settings, dirs, encode_stream):
    """What ``harness.int8_render_params`` reads of a ``Harness``: the
    direction grid, the settings and the config with int8 serving on."""
    rt = dataclasses.replace(cfg.runtime, int8_serving=True,
                             int8_encode=encode_stream)
    return types.SimpleNamespace(directions=dirs, settings=settings,
                                 cfg=dataclasses.replace(cfg, runtime=rt))


def timed_renders(render, args, n) -> list:
    """ms of ``n`` synchronised calls of ``render(*args)``."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def s_act_rel_rms(got: dict, want: dict) -> float:
    """The worst relRMS over both models' activation scales."""
    worst = 0.0
    for key in ("coarse", "fine"):
        for name in want[key].s_act.keys():
            a = got[key].s_act[name].cpu().double()
            b = want[key].s_act[name].cpu().double()
            worst = max(worst, float(torch.linalg.norm(a - b)
                                     / torch.linalg.norm(b)))
    return worst


def int8_phase(cfg, settings, models, cpu_models, z_s, z_t, pose, dirs,
               small_dirs, k1_img, k1_ms, rays_ms, card) -> dict:
    """Int8 serving of the flagship model (phase 4b), without and with the
    encode stream: calibration on the card by ``int8_render_params``' draw
    (16,384 pixels of the 128x128 view, median of 3 calls), the image
    through ``make_image_renderer`` (``_int_mm`` calls per image; median
    of ``INT8_RENDERS`` synchronised renders; PSNR against the K1 image),
    gated card against CPU: a 16x16 image from the same quantized
    buffers moved to the CPU (40 dB) and the calibration of
    ``INT8_CHECK_RAYS`` rays on both (``s_act`` relRMS 1e-2); a profile
    of one image."""
    size, small = dirs.shape[0], small_dirs.shape[0]
    chunk = cfg.nerf.validation.chunksize
    render = make_image_renderer(settings, size, size, chunk, "cuda")
    n_chunks = -(-size * size // chunk)
    out = {}
    for encode in (False, True):
        label = "int8 encode" if encode else "int8"
        on_card = int8_harness(cfg, settings, dirs, encode)
        calib_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qm = int8_render_params(on_card, models, pose, z_s, z_t)
            torch.cuda.synchronize()
            calib_ms.append((time.perf_counter() - t0) * 1e3)
        render(qm, dirs, pose, z_s, z_t)                   # warm-up
        torch.cuda.synchronize()
        quantized._qdot.calls = 0
        img = render(qm, dirs, pose, z_s, z_t)
        torch.cuda.synchronize()
        calls = quantized._qdot.calls
        want_calls = 2 * n_chunks * (7 if encode else 6)
        if calls != want_calls or tuple(img.shape) != (size * size, 3) or \
                not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"{label}: {calls} _int_mm calls (want "
                               f"{want_calls}), image {tuple(img.shape)}")
        ms = timed_renders(render, (qm, dirs, pose, z_s, z_t), INT8_RENDERS)
        int8_ms = statistics.median(ms)
        psnr_k1 = float(mse2psnr(torch.mean((img - k1_img) ** 2)))
        # card against CPU: one 16x16 image from the same buffers, and the
        # calibration of INT8_CHECK_RAYS rays on each
        q_cpu = cpu_copy(qm)
        img_gpu = make_image_renderer(settings, small, small, 256, "cuda")(
            qm, small_dirs, pose, z_s, z_t)
        img_cpu = make_image_renderer(settings, small, small, 256, "cpu")(
            q_cpu, small_dirs.cpu(), pose.cpu(), z_s.cpu(), z_t.cpu())
        psnr_cpu = float(mse2psnr(torch.mean((img_gpu.cpu() - img_cpu)
                                             ** 2)))
        q_g = int8_render_params(on_card, models, pose, z_s, z_t,
                                 n_rays=INT8_CHECK_RAYS)
        q_c = int8_render_params(
            int8_harness(cfg, settings, dirs.cpu(), encode), cpu_models,
            pose.cpu(), z_s.cpu(), z_t.cpu(), n_rays=INT8_CHECK_RAYS)
        calib_rel = s_act_rel_rms(q_g, q_c)
        row = {"ms": int8_ms, "ms_all": ms,
               "rays_per_s": size * size / int8_ms * 1e3,
               "calibration_ms": statistics.median(calib_ms),
               "calibration_ms_all": calib_ms, "int_mm_per_image": calls,
               "psnr_vs_k1": psnr_k1, "psnr_card_vs_cpu": psnr_cpu,
               "s_act_rel_rms_card_vs_cpu": calib_rel,
               "k1_ms": k1_ms, "rays_ms": rays_ms}
        print(f"{label} {size}x{size}: median {int8_ms:.6g} ms/image "
              f"({size * size / int8_ms * 1e3:.6g} rays/s) against K1 "
              f"{k1_ms:.6g} and the YAML's flags {rays_ms:.6g} in this call; "
              f"calibration {statistics.median(calib_ms):.6g} ms (first "
              f"{calib_ms[0]:.6g}); {calls} _int_mm calls per image; "
              f"PSNR(vs K1 image)={psnr_k1:.6g} dB; {small}x{small} "
              f"PSNR(card vs CPU, same buffers)={psnr_cpu:.6g} dB; "
              f"calibration of {INT8_CHECK_RAYS} rays card vs CPU s_act "
              f"relRMS {calib_rel:.4g} on {card}", flush=True)
        if not psnr_cpu >= PSNR_GATE:
            raise RuntimeError(f"{label} card vs CPU image: {psnr_cpu} dB < "
                               f"{PSNR_GATE}")
        if not calib_rel <= REL_RMS_GATE:
            raise RuntimeError(f"{label} calibration card vs CPU: s_act "
                               f"relRMS {calib_rel} > {REL_RMS_GATE}")
        if not encode:
            prof = profile_call(render, (qm, dirs, pose, z_s, z_t), int8_ms,
                                {"int8 GEMM": INT8_GEMM_NAMES})
            row["profile"] = prof
            if prof["device_busy_ms"]:
                print(f"{label} profile: device busy "
                      f"{prof['device_busy_ms']:.6g} ms per image against "
                      f"the unprofiled {int8_ms:.6g} ms (idle share "
                      f"{prof['idle_share']:.4g}); int8 GEMMs "
                      f"{prof['kernel_ms']['int8 GEMM']:.6g} ms "
                      f"({prof['kernel_share_of_busy']['int8 GEMM']:.4g} of "
                      f"busy); top kernels {prof['top']} on {card}",
                      flush=True)
            else:
                print(f"{label} profile: torch.profiler recorded no device "
                      f"time: the breakdown is not measured", flush=True)
        out["encode" if encode else "trunk"] = row
        del qm, q_cpu, q_g, q_c
        torch.cuda.empty_cache()
    return out


def vanilla_int8(label, harness, models, pose, small, card) -> dict:
    """A vanilla model's int8 image at the harness's size and settings
    (calibrated by ``int8_render_params`` at ``pose``): ms per image
    (median of 5) beside the full-precision image's (median of 3), the
    PSNR between them; gated card against CPU on ``small`` = (settings,
    h, w, directions) from the same quantized buffers (40 dB)."""
    s, h, w = harness.settings, harness.height, harness.width
    render = make_image_renderer(s, h, w, harness.cfg.nerf.validation.
                                 chunksize, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qm = int8_render_params(harness, models, pose, None, None)
    torch.cuda.synchronize()
    calib_ms = (time.perf_counter() - t0) * 1e3
    img_fp = render(models, harness.directions, pose, None, None)
    img_q = render(qm, harness.directions, pose, None, None)
    fp_ms = statistics.median(timed_renders(
        render, (models, harness.directions, pose, None, None), 3))
    q_ms = statistics.median(timed_renders(
        render, (qm, harness.directions, pose, None, None), 5))
    if not bool(torch.isfinite(img_q).all()):
        raise RuntimeError(f"{label} int8 image is not finite")
    psnr_fp = float(mse2psnr(torch.mean((img_q - img_fp) ** 2)))
    ss, sh, sw, sdirs = small
    img_gpu = make_image_renderer(ss, sh, sw, 256, "cuda")(
        qm, sdirs, pose, None, None)
    img_cpu = make_image_renderer(ss, sh, sw, 256, "cpu")(
        cpu_copy(qm), sdirs.cpu(), pose.cpu(), None, None)
    psnr_cpu = float(mse2psnr(torch.mean((img_gpu.cpu() - img_cpu) ** 2)))
    print(f"vanilla {label} int8 {w}x{h}: median {q_ms:.6g} ms/image "
          f"({h * w / q_ms * 1e3:.6g} rays/s) against full precision "
          f"{fp_ms:.6g} ms; calibration {calib_ms:.6g} ms; PSNR(int8 vs "
          f"full precision)={psnr_fp:.6g} dB; {sw}x{sh} PSNR(card vs CPU, "
          f"same buffers)={psnr_cpu:.6g} dB on {card}", flush=True)
    if not psnr_cpu >= PSNR_GATE:
        raise RuntimeError(f"vanilla {label} int8 card vs CPU image: "
                           f"{psnr_cpu} dB < {PSNR_GATE}")
    return {"ms": q_ms, "fp_ms": fp_ms, "calibration_ms": calib_ms,
            "psnr_vs_fp": psnr_fp, "psnr_card_vs_cpu": psnr_cpu}


# the eval phase: the committed flagship-v4-cars-42100 weights on the v4
# lineage's own val split, regenerated here with the lineage's arguments
# (RESULTS.md "Session 13", tools/run_campaign.sh), by the campaign's
# category protocol (tools/run_campaign.sh: 8 restarts, K = 4, 300 TTO
# steps, a 300-step flip rescue) through K1 + K2, every image rendered
# again through the int8 serving path (the trained-weights A/B)
EVAL_DATA = ("--name", "cars", "--style", "proc", "--objects", "400",
             "--val-objects", "8", "--views", "50", "--val-views", "10",
             "--size", "128", "--seed", "7", "--only-stage", "val")
EVAL_CKPT = "codenerf_tpu_torch/fixtures/flagship-v4-cars-42100.ckpt"
EVAL_FLAGS = ("--num-objects", "400", "--all-objects", "--batch-objects",
              "4")
EVAL_OVERRIDES = ("optimizer.pose_restarts=8",
                  "optimizer.pose_flip_steps=300", "runtime.use_pallas=True",
                  "runtime.pallas_backward=True", "runtime.int8_serving=True")
EVAL_OBJECTS = 8
EVAL_PSNR_GATE = 22.0
# the int8 category mean may sit this far under full precision (RESULTS.md
# "int8 serving quality matrix (hardware, session 6)": the worst family
# -0.39 dB, the cars category mean -0.28)
EVAL_INT8_DROP_DB = 1.0
JAX_INT8_CARS_DELTA_DB = -0.28
# the same checkpoint by the same protocol in the JAX package
# (RESULTS.md, "Session 14 (round 5)")
JAX_CATEGORY = {"psnr": 26.57, "ssim": 0.823, "pose_error": 0.479}
# the trunk paths whose activation factor eval/capacity.py keeps, by the
# runtime flags that pick them
CAPACITY_MODES = {"fused": {"use_pallas": True, "pallas_backward": True},
                  "fused_recompute": {"use_pallas": True},
                  "hybrid": {"pallas_hybrid": True}, "rays": {}}
# ``eval_cli.main`` with yaml and imageio unimportable; the last line holds
# its summary, the launch counts of its process, and the modules of yaml,
# imageio, jax or codenerf_tpu that were loaded
EVAL_RUNNER = (
    "import json, sys; "
    "sys.modules.update(dict.fromkeys(('yaml', 'imageio'))); "
    "from codenerf_tpu_torch import eval_cli; "
    "from codenerf_tpu_torch.ops.fused import trunk_forward, trunk_backward; "
    "from codenerf_tpu_torch.ops.layer_bwd import linear_relu_bwd; "
    "from codenerf_tpu_torch.models.quantized import _qdot; "
    "out = eval_cli.main(sys.argv[1:]); "
    "print('result ' + json.dumps({'summary': out, 'launches': {"
    "'K1': trunk_forward.launches, "
    "'K2': trunk_backward.launches_recompute, "
    "'K3': trunk_backward.launches_stored, "
    "'K4': linear_relu_bwd.launches}, 'int_mm': _qdot.calls, 'loaded': "
    "sorted("
    "m for m, v in sys.modules.items() if v is not None and "
    f"m.split('.')[0] in {REFUSED!r})}}))")


def capacity_factors(models, tables, dirs, card) -> dict:
    """The activation factor of each trunk path (``eval/capacity.py``):
    the peak of ``torch.cuda.max_memory_allocated`` over one batched TTO
    step at K = 1 and K = 2 of the flagship shape (after a K = 1 warm-up
    step), above what was allocated before it; the slope per object over
    the sample points' hidden-wide bytes (``capacity.fit_act_factor``)."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for path, flags in CAPACITY_MODES.items():
        cfg, settings = mode_config(flags)
        if trunk_path(settings) != path:
            raise RuntimeError(f"flags {flags} pick {trunk_path(settings)}")
        n_rays = cfg.nerf.ray_sampler.num_random_rays
        peaks = []
        for K in (1, 1, 2):
            st, opt = init_batched_tto_state(tables, cfg.optimizer, K)
            step = make_batched_tto_step(
                settings, opt, n_rays, cfg.experiment.regularizer_lambda,
                cfg.nerf.point_sampler.perturb)
            targets = torch.rand(K, *dirs.shape[:2], 3, device="cuda",
                                 generator=gen)
            phis = torch.linspace(-1.0, 1.0, K, device="cuda")
            poses = pose_spherical(torch.full_like(phis, 1.2), phis, 1.3)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(st, models, dirs, targets, poses, gen)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
            del st, opt, step, targets
        peak1, peak2 = peaks[1:]
        factor = capacity.fit_act_factor(settings, n_rays, peak1, peak2)
        out[path] = {"peak_k1_bytes": peak1, "peak_k2_bytes": peak2,
                     "bytes_per_object": peak2 - peak1, "factor": factor,
                     "module_factor": capacity.ACT_FACTORS[path]}
        print(f"eval capacity {path}: one batched TTO step of {n_rays} rays "
              f"an object, peak above the start K=1 {peak1} B, K=2 {peak2} "
              f"B: {peak2 - peak1} B per object, fitted factor "
              f"{factor:.6g} (capacity.ACT_FACTORS {capacity.ACT_FACTORS[path]}"
              f") on {card}", flush=True)
        torch.cuda.empty_cache()
    return out


def eval_phase(models, tables, dirs, card, keep=False) -> dict:
    """The eval entry point on the card (phase 9): the capacity factors,
    then the v4 val split regenerated by the port's generator
    (``python3 -m codenerf_tpu_torch.tools.make_synth_data``) beside an
    empty train split, and ``python3 -m codenerf_tpu_torch.eval_cli
    --all-objects`` on it with the committed checkpoint, the campaign's
    protocol and K1 + K2 (``use_pallas`` + ``pallas_backward``), and
    ``runtime.int8_serving``: each object's image also through the int8
    serving path; gated on 8 finite rows (int8 columns too), K1 and K2
    launched, the category mean PSNR, and the int8 mean within
    ``EVAL_INT8_DROP_DB`` of it.  With ``keep`` the split is left in place
    for the tools phase (under "work", "data"), and the caller removes
    "work"."""
    cap = capacity_factors(models, tables, dirs, card)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_"))
    try:
        data = work / "srn_cars"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "codenerf_tpu_torch.tools.make_synth_data",
             "--out", str(data), *EVAL_DATA], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"make_synth_data exited {proc.returncode}:\n"
                               f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        # --only-stage val writes no train directory; the loader, as the
        # JAX package's, needs one (empty: the tables come from the
        # checkpoint through --num-objects)
        (data / "cars_train").mkdir()
        n_png = len(list((data / "cars_val").glob("*/rgb/*.png")))
        gen_s = time.perf_counter() - t0
        print(f"eval: v4 val split regenerated (python3 -m "
              f"codenerf_tpu_torch.tools.make_synth_data {' '.join(EVAL_DATA)}"
              f") in {gen_s:.4g} s: {n_png} PNGs", flush=True)
        overrides = [f"dataset.basedir={data}", f"experiment.logdir={work}",
                     *EVAL_OVERRIDES]
        cmd = [sys.executable, "-c", EVAL_RUNNER, "-c", CLI_YAML,
               "--load-checkpoint", EVAL_CKPT, *EVAL_FLAGS, *overrides]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=900)
        wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"eval CLI exited {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        res = json.loads(lines[-1][len("result "):])
        for line in lines[:-1]:
            if not line.startswith("[VALOPT] Iter"):
                print(f"eval | {line}", flush=True)
        summary, launches = res["summary"], res["launches"]
        rows = summary["per_object"]
        values = [v for r in rows for v in r.values()]
        cfg = load_config(ROOT / CLI_YAML, overrides)
        opt = cfg.optimizer
        n_iters = cfg.experiment.val_iterations
        steps = (opt.pose_restarts * max(1, min(opt.pose_restart_steps,
                                                n_iters))
                 + n_iters + opt.pose_flip_steps + 2)
        K = summary["batch_objects"]
        steps_per_s = steps * summary["groups"] / summary["tto_seconds"]
        print(f"eval: {len(rows)} objects, mean PSNR "
              f"{summary['psnr_mean']:.4f} / SSIM {summary['ssim_mean']:.4f} "
              f"/ pose error {summary['pose_error_mean']:.4f} rad / "
              f"dPSNR(GT pose) {summary['delta_psnr_gt_pose_mean']:+.4f}; "
              f"JAX on the same checkpoint and protocol (RESULTS.md, "
              f"Session 14 (round 5)): {JAX_CATEGORY['psnr']} / "
              f"{JAX_CATEGORY['ssim']} / {JAX_CATEGORY['pose_error']}",
              flush=True)
        print(f"eval: capacity chose K={K} (groups {summary['groups']}); "
              f"TTO {summary['tto_seconds']:.6g} s for {steps} steps a group "
              f"({steps_per_s:.6g} TTO steps/s, {K * steps_per_s:.6g} "
              f"object-steps/s, {summary['objects_per_min']:.6g} objects/"
              f"min); the CLI in {wall_s:.4g} s; launches K1 "
              f"{launches['K1']}, K2 {launches['K2']}, K3 {launches['K3']}, "
              f"K4 {launches['K4']} on {card}", flush=True)
        if (res["loaded"] or len(rows) != EVAL_OBJECTS or not finite(values)
                or not (launches["K1"] > 0 and launches["K2"] > 0)):
            raise RuntimeError(f"eval: {len(rows)} rows, finite "
                               f"{finite(values)}, launches {launches}, "
                               f"loaded {res['loaded']}")
        if not summary["psnr_mean"] >= EVAL_PSNR_GATE:
            raise RuntimeError(f"eval: mean PSNR {summary['psnr_mean']} < "
                               f"{EVAL_PSNR_GATE}")
        int8_rows = [(r["psnr_int8"], r["ssim_int8"]) for r in rows
                     if "psnr_int8" in r and "ssim_int8" in r]
        drop = summary.get("psnr_int8_mean", float("nan")) - \
            summary["psnr_mean"]
        print(f"eval int8: {len(int8_rows)} objects rendered through the "
              f"int8 serving path ({res['int_mm']} _int_mm calls): mean PSNR "
              f"{summary.get('psnr_int8_mean', float('nan')):.4f} / SSIM "
              f"{summary.get('ssim_int8_mean', float('nan')):.4f} against "
              f"full precision {summary['psnr_mean']:.4f} / "
              f"{summary['ssim_mean']:.4f}: {drop:+.4f} dB; JAX on the TPU "
              f"(RESULTS.md, int8 serving quality matrix, session 6, cars "
              f"category mean of another checkpoint): "
              f"{JAX_INT8_CARS_DELTA_DB:+.2f} dB on {card}", flush=True)
        if len(int8_rows) != EVAL_OBJECTS or not finite(
                [v for r in int8_rows for v in r]) or not (
                drop >= -EVAL_INT8_DROP_DB):
            raise RuntimeError(f"eval int8: {len(int8_rows)} rows, int8 mean "
                               f"{drop:+.4f} dB from full precision (gate "
                               f"-{EVAL_INT8_DROP_DB})")
        # the eval's SSIM is f32 on the card: a val target against a
        # blurred, noisy copy, on the card and on the CPU
        target = torch.from_numpy(
            SRNDataset(str(data), "val")[0]["color"][..., :3]).float()
        noisy = (torch.nn.functional.avg_pool2d(
            target.permute(2, 0, 1)[None], 3, 1, 1)[0].permute(1, 2, 0)
            + 0.03 * torch.randn(target.shape, generator=torch.Generator(
                ).manual_seed(SEED + 15))).clamp(0, 1)
        ssim_card = float(ssim(noisy.cuda(), target.cuda()))
        ssim_cpu = float(ssim(noisy, target))
        print(f"eval: SSIM of a val target against a noisy copy: card "
              f"{ssim_card:.6f}, CPU {ssim_cpu:.6f}", flush=True)
        if not abs(ssim_card - ssim_cpu) <= 1e-4:
            raise RuntimeError(f"eval: SSIM on the card {ssim_card} against "
                               f"{ssim_cpu} on the CPU")
        return {"summary": summary, "launches": launches, "capacity": cap,
                "int_mm": res["int_mm"], "int8_drop_db": drop,
                "steps_per_group": steps, "tto_steps_per_s": steps_per_s,
                "cli_s": wall_s, "data_s": gen_s, "jax": JAX_CATEGORY,
                **({"work": work, "data": data} if keep else {})}
    finally:
        if not keep or sys.exc_info()[0] is not None:
            shutil.rmtree(work, ignore_errors=True)


# the tools phase: the port's tools (codenerf_tpu_torch/tools/) on the eval
# phase's split and the committed checkpoint, and on the cli phase's tree
# and checkpoint, each in a subprocess with yaml, imageio and PIL
# unimportable; its last line holds the tool's return value, the launch
# counts of its process and the modules of TOOL_REFUSED that were loaded
TOOL_REFUSED = REFUSED + ("PIL",)
TOOL_RUNNER = (
    "import importlib, json, sys; "
    "sys.modules.update(dict.fromkeys(('yaml', 'imageio', 'PIL'))); "
    "tool = importlib.import_module('codenerf_tpu_torch.tools.' "
    "+ sys.argv[1]); "
    "from codenerf_tpu_torch.ops.fused import trunk_forward, trunk_backward; "
    "from codenerf_tpu_torch.ops.layer_bwd import linear_relu_bwd; "
    "from codenerf_tpu_torch.models.quantized import _qdot; "
    "out = tool.main(sys.argv[2:]); "
    "print('result ' + json.dumps({'out': out, 'launches': {"
    "'K1': trunk_forward.launches, "
    "'K2': trunk_backward.launches_recompute, "
    "'K3': trunk_backward.launches_stored, "
    "'K4': linear_relu_bwd.launches}, 'int_mm': _qdot.calls, "
    "'loaded': sorted(m for m, v in sys.modules.items() if v is not None "
    f"and m.split('.')[0] in {TOOL_REFUSED!r})}}, default=lambda o: "
    "o.tolist() if getattr(o, 'size', 1 << 30) <= 4096 "
    "else repr(getattr(o, 'shape', type(o))))); "
    "sys.exit(out if isinstance(out, int) else 0)")
TOOL_TIMEOUT = 300
# render_views: the committed checkpoint's object 3, turntable views
RV_OBJECT = 3
RV_VIEWS, RV_INT8_VIEWS = 4, 2
# phi_sweep's cut protocol on one val object
PHI_OBJECT = 0
PHI_SWEEP = 36
PHI_OVERRIDES = ("experiment.val_iterations=50", "optimizer.pose_restarts=2",
                 "optimizer.pose_flip_steps=20", "runtime.use_pallas=true",
                 "runtime.pallas_backward=true")
# the v4 val split's decoded pixels (split_sha256) as tools/
# make_synth_data.py with imageio wrote them on a CPU machine (numpy 2.0.2)
EVAL_SPLIT_SHA256_CPU = ("a0bda810b7f5e73c3b9ef9f0a0b69200"
                         "e03642569a507a0131a5dd7b9b7a0e9c")


def run_tool(name: str, args) -> dict:
    """``python3 -m codenerf_tpu_torch.tools.<name> args`` through
    ``TOOL_RUNNER``: its result, the launches its process counted, its
    printed lines and wall seconds; raises unless it exits 0 having loaded
    none of ``TOOL_REFUSED``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TOOL_RUNNER, name,
                           *map(str, args)], cwd=ROOT, capture_output=True,
                          text=True, timeout=TOOL_TIMEOUT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"tools.{name} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    res = json.loads(lines[-1][len("result "):])
    if res["loaded"]:
        raise RuntimeError(f"tools.{name} loaded {res['loaded']}")
    return {**res, "lines": lines[:-1], "seconds": seconds}


def split_sha256(root: Path) -> str:
    """sha256 of an SRN tree's decoded val pixels, each PNG's path under
    ``root`` then its pixels, in sorted path order."""
    h = hashlib.sha256()
    for path in sorted(root.glob("cars_val/*/rgb/*.png")):
        h.update(str(path.relative_to(root)).encode())
        h.update(read_png(path).tobytes())
    return h.hexdigest()


def native_loader(root: Path, card) -> dict:
    """(a) The native SRN loader (``data/native.py``): built on this host,
    the path ``SRNDataset.load_views`` took in the cli phase's training
    (``native.status()``), and a batch of every train view of the cli tree
    bit-identical to the ``read_png`` path, with ms per image of each."""
    from codenerf_tpu_torch.ops import _build
    built = _build.build_host(native.SOURCE, native.LIBS)
    status = native.status()
    if status["path"] != "native" or not status["batches"]["native"]:
        raise RuntimeError(f"tools (a): the native loader did not serve the "
                           f"cli phase's training: {status}")
    fast = SRNDataset(str(root), "train")
    slow = SRNDataset(str(root), "train", use_native=False)
    idx = list(range(len(fast)))
    ms = {}
    for name, ds in (("native", fast), ("read_png", slow)):
        ds.load_views(idx[:1])                               # warm-up
        t0 = time.perf_counter()
        batch = ds.load_views(idx)
        ms[name] = (time.perf_counter() - t0) * 1e3 / len(idx)
        ms[f"{name}_batch"] = batch
    a, b = ms.pop("native_batch"), ms.pop("read_png_batch")
    differ = [k for k in b if a[k].dtype != b[k].dtype
              or not np.array_equal(a[k], b[k])]
    if list(a) != list(b) or differ:
        raise RuntimeError(f"tools (a): native batch differs from the "
                           f"read_png path in {differ or list(a)}")
    h, w, c = native.probe(fast.rgb_files[0][1])
    print(f"tools (a) native loader: {Path(built['path']).name} "
          f"(g++ -O3, zlib), served {status['batches']['native']} batches of "
          f"the cli phase's training; {len(idx)} views ({h}x{w}x{c} files, "
          f"cropped to {a['color'].shape[1]}x{a['color'].shape[2]}) "
          f"bit-identical to the read_png path: {ms['native']:.6g} ms per "
          f"image native (8 threads), {ms['read_png']:.6g} ms read_png on "
          f"{card}", flush=True)
    return {"library": Path(built["path"]).name, "status": status,
            "views": len(idx), "file_hwc": [h, w, c], **ms}


def psnr_u8(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2)) / 255.0 ** 2
    return float("inf") if mse == 0 else -10.0 * float(np.log10(mse))


def tools_phase(cli_root: Path, cli_ckpt: Path, data: Path, work: Path,
                card) -> dict:
    """The port's tools on the card (phase 9b): (a) the native loader on
    the cli tree, (b) ``render_views`` of the committed checkpoint (4
    turntable views through K1, 2 through ``--int8``; view 0 against the
    same view through the plain trunk, 40 dB), (c) ``phi_sweep`` of one val
    object at a cut protocol (K1 and K2 launched, a finite profile), (d)
    ``diag_fine`` of the cli checkpoint's train view 0 (finite PSNRs, K1
    launched), (e) ``gpu_selftest`` of every family (exit 0), (f) the
    sha256 of the eval split's decoded pixels.  The tools' five processes
    run together."""
    from codenerf_tpu_torch.tools import render_views
    out = {"native": native_loader(cli_root, card)}

    ckpt_args = ["-c", CLI_YAML, "--load-checkpoint", EVAL_CKPT,
                 "--num-objects", "400"]
    rv_args = [*ckpt_args, "--object-id", RV_OBJECT, "--turntable"]
    rv_over = [f"dataset.basedir={data}", f"experiment.logdir={work}",
               "runtime.use_pallas=true"]
    # the tools' processes run together: each is mostly start-up on the
    # host, and none is timed here
    runs = {
        "k1": ("render_views", [*rv_args, "--num-views", RV_VIEWS, "--out",
                                work / "views", *rv_over]),
        "int8": ("render_views", [*rv_args, "--num-views", RV_INT8_VIEWS,
                                  "--int8", "--out", work / "views_int8",
                                  *rv_over]),
        "phi": ("phi_sweep", [*ckpt_args, "--objects", PHI_OBJECT,
                              "--sweep", PHI_SWEEP, f"dataset.basedir={data}",
                              f"experiment.logdir={work}", *PHI_OVERRIDES]),
        "diag": ("diag_fine", ["-c", CLI_YAML, "--load-checkpoint", cli_ckpt,
                               "--out", work / "diag",
                               f"dataset.basedir={cli_root}",
                               f"experiment.logdir={work}",
                               "runtime.use_pallas=true"]),
        "selftest": ("gpu_selftest", []),
    }
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {k: pool.submit(run_tool, *v) for k, v in runs.items()}
        res = {k: f.result() for k, f in futures.items()}
    k1, q = res["k1"], res["int8"]
    views = [read_png(p) for p in sorted((work / "views").glob("*.png"))]
    views_q = [read_png(p) for p in sorted((work / "views_int8").glob(
        "*.png"))]
    with plain_versions():
        plain = render_views.main(list(map(str, [
            *rv_args, "--num-views", 1, "--out", work / "views_plain",
            *rv_over])))
    side = views[0].shape[0] if views else 0
    chunk = load_config(ROOT / CLI_YAML).nerf.validation.chunksize
    chunks = -(-side * side // chunk)
    psnr_plain = psnr_u8(views[0], plain["images"][0])
    # int8 view i is the turntable angle of full-precision view 2 i
    step = RV_VIEWS // RV_INT8_VIEWS
    psnr_q = [psnr_u8(v, views[step * i]) for i, v in enumerate(views_q)]
    print(f"tools (b) render_views: object {RV_OBJECT} of {EVAL_CKPT}, "
          f"{len(views)} turntable views of {side}x{side} through K1 "
          f"({k1['launches']['K1']} launches, {k1['seconds']:.4g} s) and "
          f"{len(views_q)} through --int8 ({q['int_mm']} _int_mm calls, "
          f"{q['seconds']:.4g} s); view 0 against the plain trunk "
          f"{psnr_plain:.6g} dB; int8 views against full precision "
          f"{', '.join(f'{p:.6g}' for p in psnr_q)} dB on {card}",
          flush=True)
    if (len(views) != RV_VIEWS or len(views_q) != RV_INT8_VIEWS
            or any(v.shape != (side, side, 3) for v in views + views_q)
            or k1["launches"]["K1"] != 2 * chunks * RV_VIEWS
            or not q["int_mm"] > 0):
        raise RuntimeError(f"tools (b): {len(views)} + {len(views_q)} views, "
                           f"K1 {k1['launches']}, _int_mm {q['int_mm']}")
    if not psnr_plain >= PSNR_GATE:
        raise RuntimeError(f"tools (b): K1 view against the plain trunk "
                           f"{psnr_plain} dB < {PSNR_GATE}")
    out["render_views"] = {"launches": k1["launches"],
                           "int8_launches": q["launches"],
                           "int_mm": q["int_mm"], "psnr_plain": psnr_plain,
                           "psnr_int8": psnr_q, "seconds": k1["seconds"],
                           "int8_seconds": q["seconds"]}

    phi = res["phi"]
    rec = phi["out"][0]
    print(f"tools (c) phi_sweep: val object {PHI_OBJECT} ({', '.join(
        PHI_OVERRIDES)}, --sweep {PHI_SWEEP}) in {phi['seconds']:.4g} s: "
          f"pose error {rec['pose_error']:.6g} rad, separation "
          f"{rec['separation']:.6g} rad, minima {rec['minima']}, ratio "
          f"rec/GT {rec['ratio']:.6g} ({rec['verdict']}); launches "
          f"{phi['launches']} on {card}", flush=True)
    if (len(rec["losses"]) != PHI_SWEEP or not finite(rec["losses"])
            or not (phi["launches"]["K1"] > 0 and phi["launches"]["K2"] > 0)):
        raise RuntimeError(f"tools (c): {len(rec['losses'])} losses, finite "
                           f"{finite(rec['losses'])}, {phi['launches']}")
    out["phi_sweep"] = {k: rec[k] for k in ("pose_error", "separation",
                                            "ratio", "verdict")} | {
        "launches": phi["launches"], "seconds": phi["seconds"]}

    diag = res["diag"]
    d = diag["out"]
    print(f"tools (d) diag_fine: cli checkpoint step {d['step']}, train view "
          f"0: coarse PSNR {d['psnr_coarse']:.6g}, fine {d['psnr_fine']:.6g}"
          f" dB, acc {d['acc_coarse_mean']:.4g} / {d['acc_fine_mean']:.4g}; "
          f"launches {diag['launches']} in {diag['seconds']:.4g} s",
          flush=True)
    if (not finite([d["psnr_coarse"], d["psnr_fine"]])
            or not diag["launches"]["K1"] > 0
            or len(list(work.glob("diag_*.png"))) != 3):
        raise RuntimeError(f"tools (d): {d}, {diag['launches']}")
    out["diag_fine"] = {**d, "launches": diag["launches"],
                        "seconds": diag["seconds"]}

    st = res["selftest"]
    for line in st["lines"]:
        print(f"tools (e) gpu_selftest | {line}", flush=True)
    out["gpu_selftest"] = {"launches": st["launches"],
                           "int_mm": st["int_mm"],
                           "seconds": st["seconds"]}

    sha = split_sha256(data)
    print(f"tools (f) the eval's v4 val split written by the port's "
          f"generator: sha256 of its decoded pixels {sha} (the JAX-era tool "
          f"with imageio on a CPU machine: {EVAL_SPLIT_SHA256_CPU}, "
          f"{'equal' if sha == EVAL_SPLIT_SHA256_CPU else 'different'})",
          flush=True)
    out["split_sha256"] = sha
    return out


# the vanilla phase: lego.yml (Blender), fern.yml (LLFF, NDC) and
# srn-cars.yml (SRN) at their full widths, K4 under pallas_layer_bwd
LEGO_YAML, FERN_YAML = "configs/lego.yml", "configs/fern.yml"
SRN_CARS_YAML = "configs/srn-cars.yml"
LEGO_SPLITS = (("train", 16), ("val", 4))
LEGO_SIZE = 256                 # written; read at resolution_level 2
LEGO_ANGLE_X = 0.6911112070083618   # nerf_synthetic lego's camera_angle_x
LEGO_RADIUS = 4.0               # inside lego.yml's near 2 / far 6
FERN_VIEWS = 20
FERN_HW = (378, 504)            # fern's images_8 size
FERN_HWF0 = (3024.0, 4032.0, 3260.0)   # the poses' full-size H, W, focal
VANILLA_STEPS = 10
FERN_STEPS = 5
VANILLA_K4 = {"lego": 16, "fern": 10}  # launches per step and ray chunk
# the fused forward's: lego's 9 relu layers x 2 networks x the forward and
# its remat recompute, in both bf16 runtimes; fern's hidden 64 is outside
# its plan and runs eager
VANILLA_LF = {"lego": 36, "fern": 0}
# the fern JPEG tree: FERN_VIEWS copies of the committed 4032x3024 fixture
# in images/, no images_8/; its train CLI with yaml, imageio and PIL
# unimportable, and TensorBoard too: its image summaries import PIL (the
# loggers then write metrics.jsonl alone)
JPEG_FIXTURES = ROOT / "codenerf_tpu_torch" / "fixtures" / "jpeg"
JPEG_FULL = "fern_4032x3024_q80_420"
JPEG_CLI_STEPS = 2
JPEG_CLI_RUNNER = cli_runner(("yaml", "imageio", "PIL",
                              "torch.utils.tensorboard"))
VANILLA_CLI_STEPS = 3
VANILLA_RUNTIMES = {"xla": {}, "layer_bwd": {"pallas_layer_bwd": True}}


def vanilla_teacher(settings, seed):
    """A seeded FlexibleNeRF pair at ``settings``' widths."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return {k: build_model(getattr(settings, f"{k}_cfg"), "cuda", gen)
            for k in ("coarse", "fine")}


def centred_dirs(h, w, focal):
    K = torch.eye(4, device="cuda")
    K[0, 0] = K[1, 1] = focal
    K[0, 2], K[1, 2] = w / 2, h / 2
    return pixel_directions(h, w, K)


def write_checked_png(path: Path, img: np.ndarray) -> None:
    """``img`` written to ``path`` by ``write_png``, read back equal by
    ``read_png``."""
    write_png(path, img)
    if not np.array_equal(read_png(path), img):
        raise RuntimeError(f"read_png({path}) differs from the pixels "
                           "written")


def to_u8(rgb, h, w) -> np.ndarray:
    return (rgb.clamp(0, 1) * 255).round().to(torch.uint8).reshape(
        h, w, 3).cpu().numpy()


def write_blender_tree(root: Path, settings, teacher) -> int:
    """nerf_synthetic's layout, ``transforms_{train,val}.json`` and RGBA
    PNGs of ``LEGO_SIZE``, rendered by ``teacher`` from poses on a sphere
    of radius ``LEGO_RADIUS`` (alpha 255)."""
    n = LEGO_SIZE
    focal = 0.5 * n / np.tan(0.5 * LEGO_ANGLE_X)
    render = make_image_renderer(settings, n, n, 8192, "cuda")
    dirs = centred_dirs(n, n, focal)
    rng = np.random.default_rng(SEED + 30)
    count = 0
    for stage, views in LEGO_SPLITS:
        (root / stage).mkdir(parents=True)
        frames = []
        for v in range(views):
            pose = pose_spherical(rng.uniform(0.3, 1.3),
                                  rng.uniform(0.0, 2 * np.pi), LEGO_RADIUS,
                                  device="cuda")
            with torch.no_grad():
                rgb = to_u8(render(teacher, dirs, pose, None, None), n, n)
            alpha = np.full((n, n, 1), 255, np.uint8)
            write_checked_png(root / stage / f"r_{v}.png",
                              np.concatenate([rgb, alpha], -1))
            frames.append({"file_path": f"./{stage}/r_{v}",
                           "transform_matrix": pose.cpu().tolist()})
            count += 1
        (root / f"transforms_{stage}.json").write_text(json.dumps(
            {"camera_angle_x": LEGO_ANGLE_X, "frames": frames}))
    return count


def write_llff_tree(root: Path, cfg, seed) -> tuple:
    """LLFF's layout, ``poses_bounds.npy`` and ``images_8/`` PNGs at
    ``FERN_HW``: forward-facing cameras near the origin looking down -z,
    stored as [down right back | t | hwf] with ``FERN_HWF0``; each view
    rendered in NDC by a teacher in the frame the loader recentres the
    poses to.  Returns (views, teacher, NDC settings)."""
    from codenerf_tpu_torch.data.llff import _recenter_poses
    rng = np.random.default_rng(SEED + 31)
    c2w = np.tile(np.eye(4), (FERN_VIEWS, 1, 1))
    for v in range(FERN_VIEWS):
        a, b = rng.uniform(-0.08, 0.08, 2)
        ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
        c2w[v, :3, :3] = (np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
                          @ np.array([[cb, 0, sb], [0, 1, 0],
                                      [-sb, 0, cb]]))
        c2w[v, :3, 3] = [*rng.uniform(-0.15, 0.15, 2),
                         rng.uniform(-0.05, 0.05)]
    pb = np.zeros((FERN_VIEWS, 17))
    for v in range(FERN_VIEWS):
        right, up, back, t = c2w[v, :3, 0], c2w[v, :3, 1], c2w[v, :3, 2], \
            c2w[v, :3, 3]
        stored = np.stack([-up, right, back, t], axis=1)
        pb[v, :15] = np.concatenate(
            [stored, np.array(FERN_HWF0).reshape(3, 1)], axis=1).ravel()
        pb[v, 15:] = [1.0, 20.0]
    root.mkdir(parents=True)
    np.save(root / "poses_bounds.npy", pb)
    poses = _recenter_poses(c2w)             # what the loader will read
    h, w = FERN_HW
    focal = FERN_HWF0[2] * w / FERN_HWF0[1]
    settings = dataclasses.replace(
        RenderSettings.from_config(cfg), ndc=(float(h), float(w), focal),
        near=0.0, far=1.0, spacing_mode="lindisp")
    teacher = vanilla_teacher(settings, seed)
    render = make_image_renderer(settings, h, w, 16384, "cuda")
    dirs = centred_dirs(h, w, focal)
    (root / "images_8").mkdir()
    for v in range(FERN_VIEWS):
        pose = torch.tensor(poses[v], dtype=torch.float32, device="cuda")
        with torch.no_grad():
            rgb = to_u8(render(teacher, dirs, pose, None, None), h, w)
        write_checked_png(root / "images_8" / f"img_{v:03d}.png", rgb)
    return FERN_VIEWS, teacher, settings


def vanilla_batch(harness, n_images):
    """The first ``n_images`` train views as card tensors: (dirs, pose,
    pixels, ids)."""
    batch = BatchIterator(harness.train_dataset, n_images,
                          seed=SEED).fixed_batch()
    return (harness.directions,
            torch.from_numpy(batch["pose"]).cuda(),
            torch.from_numpy(batch["color"]).cuda(),
            torch.from_numpy(batch["object_id"]).cuda())


def vanilla_step(cfg, settings, batch, seed, plain=False, state=None):
    """One train step from a state drawn from ``seed`` (or ``state``):
    (state, grads, loss, fine loss, launches)."""
    st = state or init_train_state(cfg, settings, 1, seed=seed,
                                   device="cuda")
    step = make_train_step(settings, st,
                           cfg.nerf.ray_sampler.num_random_rays, 0.0, True)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    before = launch_counts()
    with plain_versions() if plain else contextlib.nullcontext():
        m = step(*batch, gen)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    return st, grads_of(st), float(m.loss), float(m.loss_fine), launched


def gate_grads(label, grads, want, gate) -> list:
    rel = grad_rel_rms(grads, want)
    worst = max(rel, key=rel.get)
    print(f"{label}: gradient relRMS over {len(rel)} leaves: worst {worst} "
          f"{rel[worst]:.4g}, median {statistics.median(rel.values()):.4g}",
          flush=True)
    if not rel[worst] <= gate:
        raise RuntimeError(f"{label}: {worst} gradient relRMS {rel[worst]} "
                           f"> {gate}")
    return [worst, rel[worst]]


def run_steps(step, batch, gen, n) -> tuple:
    """``n`` steps: (ms per step, fine losses, losses, launches)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    ms, fine, total = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        m = step(*batch, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        fine.append(m.loss_fine)
        total.append(m.loss)
    return (ms, [float(v) for v in fine], [float(v) for v in total],
            launch_counts())


def lego_phase(work: Path, card) -> dict:
    """lego.yml's model at full width on a Blender tree (phase 10a): one
    step of 1 x 16384 rays with K4 against the plain versions and the
    YAML's own xla runtime, ``VANILLA_STEPS`` timed steps in each
    runtime, a profile of the K4 step, one f32 step against the plain
    versions."""
    root = work / "lego"
    base = [f"dataset.basedir={root}", f"experiment.logdir={work}",
            "experiment.id=lego_phase"]
    cfg = load_config(ROOT / LEGO_YAML, base)
    teacher = vanilla_teacher(RenderSettings.from_config(cfg), SEED + 32)
    t0 = time.perf_counter()
    n_img = write_blender_tree(root, RenderSettings.from_config(cfg),
                               teacher)
    harness = Harness.from_config(cfg, device="cuda")
    n_rays = cfg.nerf.ray_sampler.num_random_rays
    print(f"vanilla lego: wrote {n_img} RGBA PNGs of {LEGO_SIZE}x{LEGO_SIZE} "
          f"(16 train, 4 val) rendered by a seeded FlexibleNeRF teacher, "
          f"read at resolution_level {cfg.dataset.resolution_level} as "
          f"{harness.height}x{harness.width}, in "
          f"{time.perf_counter() - t0:.4g} s; the train batch cut from "
          f"{cfg.dataset.train_batch_size} images to 1 ({n_rays} rays a "
          f"step)", flush=True)
    # the teacher's int8 image at the first val view's pose
    val = harness.val_dataset[0]
    small = 16
    focal = float(val["intrinsic"][0, 0]) * small / harness.width
    int8 = vanilla_int8("lego", harness, teacher,
                        torch.from_numpy(val["pose"]).cuda(),
                        (harness.settings, small, small,
                         centred_dirs(small, small, focal)), card)
    del teacher
    batch = vanilla_batch(harness, 1)
    out = {}
    grads = {}
    for mode, flags in VANILLA_RUNTIMES.items():
        mcfg = load_config(ROOT / LEGO_YAML, base + [
            f"runtime.{k}={v}" for k, v in flags.items()])
        settings = RenderSettings.from_config(mcfg)
        if trunk_path(settings) != "rays":
            raise RuntimeError(f"lego {mode}: path {trunk_path(settings)}")
        torch.cuda.reset_peak_memory_stats()
        st, grads[mode], loss, fine, launched = vanilla_step(
            mcfg, settings, batch, SEED + 33)
        want = VANILLA_K4["lego"] if mode == "layer_bwd" else 0
        if launched["K4"] != want or launched["K1"] + launched["K2"] + \
                launched["K3"] or launched["LF"] != VANILLA_LF["lego"]:
            raise RuntimeError(f"lego {mode} (a): launched {launched}")
        row = {"loss_step_a": loss}
        if mode == "layer_bwd":
            _, plain_grads, plain_loss, _, plain_launched = vanilla_step(
                mcfg, settings, batch, SEED + 33, plain=True)
            if any(plain_launched.values()):
                raise RuntimeError(f"lego plain step launched "
                                   f"{plain_launched}")
            print(f"vanilla lego layer_bwd (a): {n_rays} rays: loss kernels="
                  f"{loss:.8g} plain={plain_loss:.8g}; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3g} GiB",
                  flush=True)
            row["grad_rel_rms_worst"] = gate_grads(
                "vanilla lego layer_bwd (a) vs plain", grads[mode],
                plain_grads, REL_RMS_GATE)
            row["grad_rel_rms_worst_vs_xla"] = gate_grads(
                "vanilla lego layer_bwd (a) vs xla", grads[mode],
                grads["xla"], REL_RMS_GATE)
            if not abs(loss - plain_loss) <= 1e-3 * plain_loss:
                raise RuntimeError(f"lego layer_bwd: loss {loss} vs plain "
                                   f"{plain_loss}")
            del plain_grads
        # (b) timed steps from the state of (a)
        step = make_train_step(settings, st, n_rays, 0.0, True)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 34)
        torch.cuda.reset_peak_memory_stats()
        ms, fine, total, counts = run_steps(step, batch, gen, VANILLA_STEPS)
        step_ms = statistics.median(ms)
        per_step = {k: v / VANILLA_STEPS for k, v in counts.items()}
        print(f"vanilla lego {mode} (b): {VANILLA_STEPS} steps of {n_rays} "
              f"rays (1 image): median {step_ms:.6g} ms/step "
              f"({n_rays / step_ms * 1e3:.6g} rays/s), first {ms[0]:.6g} ms; "
              f"launches per step {per_step}; fine loss {fine[0]:.6g} -> "
              f"{fine[-1]:.6g}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3g} GiB on "
              f"{card}", flush=True)
        if per_step["K4"] != want or per_step["LF"] != VANILLA_LF["lego"] \
                or not finite(total):
            raise RuntimeError(f"lego {mode}: launches per step {per_step}, "
                               f"losses {total}")
        if not statistics.mean(fine[-3:]) < statistics.mean(fine[:3]):
            raise RuntimeError(f"lego {mode}: the fine loss did not fall "
                               f"({fine})")
        row.update({"step_ms": step_ms, "step_ms_all": ms,
                    "rays_per_s": n_rays / step_ms * 1e3,
                    "launches_per_step": per_step, "loss_fine": fine,
                    "peak_bytes": torch.cuda.max_memory_allocated()})
        if mode == "layer_bwd":
            row["profile"] = profile_step(
                "vanilla lego layer_bwd", step, (*batch, gen), step_ms,
                PROFILE_LABELS["layer_bwd"], card)
        out[mode] = row
        del st, step
        torch.cuda.empty_cache()
    del grads
    # (c) f32 with K4 against the plain versions
    f32_cfg = load_config(ROOT / LEGO_YAML, base + [
        "runtime.compute_dtype=float32", "runtime.pallas_layer_bwd=True"])
    settings = RenderSettings.from_config(f32_cfg)
    _, g32, loss32, _, launched = vanilla_step(f32_cfg, settings, batch,
                                               SEED + 35)
    _, p32, plain32, _, _ = vanilla_step(f32_cfg, settings, batch, SEED + 35,
                                         plain=True)
    print(f"vanilla lego f32 layer_bwd: loss kernels={loss32:.8g} "
          f"plain={plain32:.8g}; launches {launched}", flush=True)
    out["f32"] = {"loss": loss32, "plain_loss": plain32,
                  "launches": launched,
                  "grad_rel_rms_worst": gate_grads(
                      "vanilla lego f32 vs plain", g32, p32,
                      F32_REL_RMS_GATE)}
    if launched["K4"] != VANILLA_K4["lego"] or launched["LF"] or not (
            abs(loss32 - plain32) <= 1e-4 * plain32):
        raise RuntimeError(f"lego f32: launches {launched}, loss {loss32} "
                           f"vs {plain32}")
    del g32, p32
    torch.cuda.empty_cache()
    out["images"] = n_img
    out["int8"] = int8
    return out


def fern_phase(work: Path, card) -> dict:
    """fern.yml's model on an LLFF tree (phase 10b): ``FERN_STEPS`` steps
    with K4 on NDC rays, and a 32x24 NDC image on the card against the
    port's CPU path."""
    root = work / "fern"
    cfg = load_config(ROOT / FERN_YAML, [
        f"dataset.basedir={root}", f"experiment.logdir={work}",
        "experiment.id=fern_phase", "runtime.pallas_layer_bwd=True"])
    t0 = time.perf_counter()
    n_img, teacher, teacher_settings = write_llff_tree(root, cfg, SEED + 36)
    harness = Harness.from_config(cfg, device="cuda")
    s = harness.settings
    # the harness takes the focal from the f32 intrinsic
    if not np.allclose(s.ndc, teacher_settings.ndc, rtol=1e-6) or (
            s.near, s.far, s.spacing_mode) != (0.0, 1.0, "lindisp"):
        raise RuntimeError(f"fern: harness NDC {s.ndc} {s.near} {s.far} "
                           f"{s.spacing_mode}, tree {teacher_settings.ndc}")
    n_rays = cfg.nerf.ray_sampler.num_random_rays
    print(f"vanilla fern: wrote poses_bounds.npy and {n_img} PNGs of "
          f"{FERN_HW[1]}x{FERN_HW[0]} in images_8/ in "
          f"{time.perf_counter() - t0:.4g} s; llffhold "
          f"{cfg.dataset.llffhold}: {len(harness.train_dataset)} train, "
          f"{len(harness.val_dataset)} val; NDC {s.ndc}", flush=True)
    st = init_train_state(cfg, s, 1, seed=SEED + 37, device="cuda")
    step = make_train_step(s, st, n_rays, 0.0, True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 38)
    ms, fine, total, counts = run_steps(step, vanilla_batch(harness, 1), gen,
                                        FERN_STEPS)
    per_step = {k: v / FERN_STEPS for k, v in counts.items()}
    print(f"vanilla fern layer_bwd: {FERN_STEPS} steps of {n_rays} NDC rays: "
          f"median {statistics.median(ms):.6g} ms/step, first {ms[0]:.6g} "
          f"ms; launches per step {per_step}; fine loss {fine} on {card}",
          flush=True)
    if per_step["K4"] != VANILLA_K4["fern"] or \
            per_step["LF"] != VANILLA_LF["fern"] or not finite(total):
        raise RuntimeError(f"fern: launches per step {per_step}, losses "
                           f"{total}")
    if not fine[-1] < fine[0]:
        raise RuntimeError(f"fern: the fine loss did not fall ({fine})")
    del st, step
    # a small NDC image on the card and on the CPU
    h, w = 24, 32
    focal = s.ndc[2] * w / FERN_HW[1]
    small = dataclasses.replace(s, ndc=(float(h), float(w), focal))
    pose = torch.tensor(harness.val_dataset[0]["pose"], device="cuda")
    img_gpu = make_image_renderer(small, h, w, 256, "cuda")(
        teacher, centred_dirs(h, w, focal), pose, None, None)
    cpu_models = {k: copy.deepcopy(m).to("cpu") for k, m in teacher.items()}
    img_cpu = make_image_renderer(small, h, w, 256, "cpu")(
        cpu_models, centred_dirs(h, w, focal).cpu(), pose.cpu(), None, None)
    psnr = float(mse2psnr(torch.mean((img_gpu.cpu() - img_cpu) ** 2)))
    print(f"vanilla fern render {w}x{h} NDC: PSNR(card vs CPU)={psnr:.6g} dB",
          flush=True)
    if not psnr >= PSNR_GATE:
        raise RuntimeError(f"fern NDC card vs CPU image: {psnr} dB < "
                           f"{PSNR_GATE}")
    # the teacher's int8 image at the val pose, calibrated as JAX's
    # calibrator does (world-space points, no NDC)
    int8 = vanilla_int8("fern NDC", harness, teacher, pose,
                        (small, h, w, centred_dirs(h, w, focal)), card)
    del teacher, cpu_models, harness
    jpeg = fern_jpeg(work, cfg, statistics.median(ms), s, card)
    return {"step_ms": statistics.median(ms), "step_ms_all": ms,
            "launches_per_step": per_step, "loss_fine": fine,
            "ndc_psnr_card_vs_cpu": psnr, "images": n_img, "int8": int8,
            "jpeg": jpeg}


def jpeg_fixtures() -> dict:
    """Every committed JPEG fixture decoded by ``data/jpeg.py``: the small
    ones bit-equal to ``pixels.npz``, the full-size one's pixels to the
    sha256 its JSON holds (both imageio's pixels on a CPU machine)."""
    want = np.load(JPEG_FIXTURES / "pixels.npz")
    differ = [name for name in want.files if not np.array_equal(
        read_jpeg(JPEG_FIXTURES / f"{name}.jpg"), want[name])]
    meta = json.loads((JPEG_FIXTURES / f"{JPEG_FULL}.json").read_text())
    full = read_jpeg(JPEG_FIXTURES / meta["file"])
    sha = hashlib.sha256(full.tobytes()).hexdigest()
    if differ or list(full.shape) != meta["shape"] or sha != meta["sha256"]:
        raise RuntimeError(f"JPEG fixtures: {differ} differ from their "
                           f"pixels; full size {full.shape} sha256 {sha}, "
                           f"want {meta}")
    return {"small": len(want.files), "full_shape": list(full.shape),
            "full_sha256": sha, "full": full}


def fern_jpeg(work: Path, cfg, png_step_ms, png_settings, card) -> dict:
    """The fern JPEG part of phase 10b: the committed fixtures decoded
    bit-equal; an LLFF tree of ``FERN_VIEWS`` copies of the 4032x3024
    fixture in ``images/`` (the PNG tree's ``poses_bounds.npy``, no
    ``images_8/``), which the loader decodes and box-downsamples 8x at
    construction; ``FERN_STEPS`` steps with K4 beside the PNG tree's; the
    train CLI on it in a subprocess (yaml, imageio and PIL unimportable)."""
    t0 = time.perf_counter()
    fixtures = jpeg_fixtures()
    full = fixtures.pop("full")
    fixture_s = time.perf_counter() - t0
    root = work / "fern_jpeg"
    (root / "images").mkdir(parents=True)
    shutil.copy(work / "fern" / "poses_bounds.npy", root / "poses_bounds.npy")
    src = JPEG_FIXTURES / f"{JPEG_FULL}.jpg"
    files = [root / "images" / f"img_{v:03d}.jpg" for v in range(FERN_VIEWS)]
    for f in files:
        shutil.copy(src, f)
    one_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        read_jpeg(src)
        one_ms.append((time.perf_counter() - t1) * 1e3)
    t1 = time.perf_counter()
    decoded = read_jpegs(files)
    batch_ms = (time.perf_counter() - t1) * 1e3
    if any(not np.array_equal(d, full) for d in decoded):
        raise RuntimeError("fern JPEG: read_jpegs differs from read_jpeg")
    del decoded
    jcfg = dataclasses.replace(cfg, dataset=dataclasses.replace(
        cfg.dataset, basedir=str(root)), experiment=dataclasses.replace(
            cfg.experiment, id="fern_jpeg"))
    t1 = time.perf_counter()
    harness = Harness.from_config(jcfg, device="cuda")
    build_s = time.perf_counter() - t1
    s = harness.settings
    view0 = harness.train_dataset[0]["color"]
    want0 = box_downsample(full.astype(np.float32) / 255.0,
                           cfg.dataset.downsample_factor)
    if view0.shape != (*FERN_HW, 3) or not np.array_equal(view0, want0):
        raise RuntimeError(f"fern JPEG: view 0 {view0.shape} is not the "
                           f"fixture box-downsampled to {FERN_HW}")
    if (s.ndc, s.near, s.far, s.spacing_mode) != (
            png_settings.ndc, png_settings.near, png_settings.far,
            png_settings.spacing_mode):
        raise RuntimeError(f"fern JPEG: NDC {s.ndc} {s.near} {s.far} "
                           f"{s.spacing_mode}, PNG tree {png_settings.ndc}")
    views = len(harness.train_dataset) + len(harness.val_dataset)
    print(f"vanilla fern JPEG: {fixtures['small']} small fixtures bit-equal "
          f"to imageio's pixels, the {full.shape[1]}x{full.shape[0]} 4:2:0 "
          f"fixture ({src.stat().st_size} bytes) to its sha256, in "
          f"{fixture_s:.4g} s; decode {full.shape[1]}x{full.shape[0]}: "
          f"median {statistics.median(one_ms):.6g} ms on one thread, "
          f"read_jpegs of {FERN_VIEWS} views {batch_ms:.6g} ms "
          f"({batch_ms / FERN_VIEWS:.6g} ms per image on its default "
          f"threads); Harness.from_config on images/ (no images_8/: "
          f"{views} views decoded and box-downsampled "
          f"{cfg.dataset.downsample_factor}x to {FERN_HW[1]}x{FERN_HW[0]}) "
          f"in {build_s:.4g} s; view 0 equal to the fixture's; NDC {s.ndc} "
          f"as the PNG tree's on {card}", flush=True)
    n_rays = cfg.nerf.ray_sampler.num_random_rays
    st = init_train_state(cfg, s, 1, seed=SEED + 37, device="cuda")
    step = make_train_step(s, st, n_rays, 0.0, True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 38)
    ms, fine, total, counts = run_steps(step, vanilla_batch(harness, 1), gen,
                                        FERN_STEPS)
    per_step = {k: v / FERN_STEPS for k, v in counts.items()}
    print(f"vanilla fern JPEG layer_bwd: {FERN_STEPS} steps of {n_rays} NDC "
          f"rays on images/ JPEGs: median {statistics.median(ms):.6g} "
          f"ms/step (PNG tree {png_step_ms:.6g} ms/step), first "
          f"{ms[0]:.6g} ms; launches per step {per_step}; fine loss {fine} "
          f"on {card}", flush=True)
    if per_step["K4"] != VANILLA_K4["fern"] or not finite(total):
        raise RuntimeError(f"fern JPEG: launches per step {per_step}, "
                           f"losses {total}")
    del st, step, harness
    torch.cuda.empty_cache()
    # the train CLI on the JPEG tree
    cmd = [sys.executable, "-c", JPEG_CLI_RUNNER, "-c", FERN_YAML,
           f"dataset.basedir={root}", f"experiment.logdir={work}",
           "experiment.id=fern_jpeg_cli", "experiment.print_every=1",
           "runtime.pallas_layer_bwd=True", "--max-steps",
           str(JPEG_CLI_STEPS)]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t1
    if proc.returncode != 0:
        raise RuntimeError(f"fern JPEG train CLI exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    loaded = json.loads(lines[-1][len("loaded "):])
    stats = json.loads(lines[-2][len("stats "):])
    train = {r["step"]: r for r in jsonl(work / "fern_jpeg_cli"
                                         / "metrics.jsonl")
             if r["mode"] == "train"}
    want_k4 = VANILLA_K4["fern"] * JPEG_CLI_STEPS
    cli_fine = [train[i]["nerf_loss_fine"] for i in sorted(train)]
    print(f"vanilla fern JPEG cli: python3 -m codenerf_tpu_torch.train_cli "
          f"-c {FERN_YAML} on images/ ({FERN_VIEWS} 4032x3024 JPEGs, "
          f"downsample_factor {cfg.dataset.downsample_factor}; "
          f"pallas_layer_bwd; yaml, imageio, PIL and TensorBoard "
          f"unimportable): exit 0 in "
          f"{cli_s:.4g} s; step 2 {train[JPEG_CLI_STEPS]['time_taken'] * 1e3:.6g}"
          f" ms; fine loss {cli_fine}; K4 launches {stats['K4']}; modules "
          f"loaded {loaded} on {card}", flush=True)
    if (loaded or sorted(train) != list(range(1, JPEG_CLI_STEPS + 1))
            or stats["K4"] != want_k4 or not finite(cli_fine)):
        raise RuntimeError(f"fern JPEG train CLI: loaded {loaded}, train "
                           f"{sorted(train)}, K4 {stats['K4']} (want "
                           f"{want_k4}), fine loss {cli_fine}")
    return {**fixtures, "decode_ms_one_thread": statistics.median(one_ms),
            "decode_ms_one_thread_all": one_ms,
            "read_jpegs_ms": batch_ms, "read_jpegs_ms_per_image":
            batch_ms / FERN_VIEWS, "harness_s": build_s, "views": views,
            "step_ms": statistics.median(ms), "step_ms_all": ms,
            "png_step_ms": png_step_ms, "launches_per_step": per_step,
            "loss_fine": fine, "cli_s": cli_s, "cli_K4": stats["K4"],
            "cli_step_ms": train[JPEG_CLI_STEPS]["time_taken"] * 1e3,
            "cli_loss_fine": cli_fine}


def vanilla_cli(work: Path, card) -> dict:
    """The train CLI on lego.yml in a subprocess (phase 10c, yaml and
    imageio unimportable) at the YAML's batch with K4 and 16 ray chunks,
    its checkpoint restored bit-identically here, then the eval CLI on
    it."""
    root = work / "lego"
    overrides = [f"dataset.basedir={root}", f"experiment.logdir={work}",
                 "experiment.id=lego_cli", "experiment.print_every=1",
                 "experiment.validate_every=2",
                 f"experiment.save_every={VANILLA_CLI_STEPS}",
                 "runtime.pallas_layer_bwd=True", "runtime.ray_chunks=16"]
    cmd = [sys.executable, "-c", CLI_RUNNER, "-c", LEGO_YAML, *overrides,
           "--max-steps", str(VANILLA_CLI_STEPS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"lego train CLI exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    refused = json.loads(lines[-1][len("loaded "):])
    stats = json.loads(lines[-2][len("stats "):])
    logdir = work / "lego_cli"
    recs = jsonl(logdir / "metrics.jsonl")
    train = {r["step"]: r for r in recs if r["mode"] == "train"}
    val = [r for r in recs if r["mode"] == "val"]
    ckdir = logdir / "checkpoints"
    cfg = load_config(ROOT / LEGO_YAML, overrides)
    rays = cfg.dataset.train_batch_size * cfg.nerf.ray_sampler.num_random_rays
    want_k4 = VANILLA_K4["lego"] * cfg.runtime.ray_chunks * VANILLA_CLI_STEPS
    if (refused or sorted(train) != [1, 2, 3] or len(val) != 1
            or checkpoint.latest_step(ckdir) != VANILLA_CLI_STEPS
            or stats["K4"] != want_k4
            or not finite([r["nerf_loss_fine"] for r in train.values()]
                          + [val[0]["psnr"]])):
        raise RuntimeError(f"lego train CLI: imported {refused}, train "
                           f"{sorted(train)}, val {val}, K4 {stats['K4']} "
                           f"(want {want_k4}), latest "
                           f"{checkpoint.latest_step(ckdir)}")
    # step 2 is warm and holds no validation (that runs after its log)
    step_ms = train[2]["time_taken"] * 1e3
    print(f"vanilla cli: python3 -m codenerf_tpu_torch.train_cli -c "
          f"{LEGO_YAML} ({cfg.dataset.train_batch_size} x "
          f"{cfg.nerf.ray_sampler.num_random_rays} = {rays} rays a step in "
          f"{cfg.runtime.ray_chunks} chunks, pallas_layer_bwd; yaml and "
          f"imageio unimportable): exit 0 in {cli_s:.4g} s; step 1 "
          f"{train[1]['time_taken'] * 1e3:.6g} ms, step 2 {step_ms:.6g} ms "
          f"({rays / step_ms * 1e3:.6g} rays/s); fine loss "
          f"{[round(train[i]['nerf_loss_fine'], 6) for i in (1, 2, 3)]}; "
          f"validation at 2 PSNR {val[0]['psnr']:.6g} dB; K4 launches "
          f"{stats['K4']}; peak memory {stats['peak_bytes'] / 2**30:.4g} GiB "
          f"on {card}", flush=True)
    # the step-3 checkpoint restored into A, saved, restored into B
    settings = RenderSettings.from_config(cfg)
    a = init_train_state(cfg, settings, 1, seed=SEED + 40, device="cuda")
    checkpoint.restore_checkpoint(ckdir, a, step=VANILLA_CLI_STEPS)
    checkpoint.save_checkpoint(work / "lego_copy", a)
    b = init_train_state(cfg, settings, 1, seed=SEED + 41, device="cuda")
    checkpoint.restore_checkpoint(work / "lego_copy", b)
    differ = bit_identical(state_tensors(a), state_tensors(b))
    want_lr = [lr_at_step(cfg.optimizer.lr, cfg.optimizer.scheduler_gamma,
                          cfg.optimizer.scheduler_step_size,
                          VANILLA_CLI_STEPS)]
    got_lr = [g["lr"] for g in a.optimizer.param_groups]
    if differ or got_lr != want_lr or not a.optimizer.state or a.tables:
        raise RuntimeError(f"lego restore: differ {differ}, lr {got_lr} "
                           f"against {want_lr}")
    harness = Harness.from_config(cfg, device="cuda")
    batch = vanilla_batch(harness, 1)
    for st in (a, b):
        make_train_step(settings, st, cfg.nerf.ray_sampler.num_random_rays,
                        0.0, True)(
            *batch, torch.Generator(device="cuda").manual_seed(SEED))
    differ_step = bit_identical(state_tensors(a), state_tensors(b))
    if differ_step:
        raise RuntimeError(f"lego: one step from A and B: {differ_step}")
    print(f"vanilla cli restore: step {VANILLA_CLI_STEPS} -> A -> save -> B: "
          f"{len(state_tensors(a))} tensors bit-identical, LR {got_lr} = "
          f"lr_at_step, no code tables; one more step from each: "
          f"bit-identical", flush=True)
    del a, b
    torch.cuda.empty_cache()
    # the eval CLI on the checkpoint: validate renders at the true pose
    cmd = [sys.executable, "-c", EVAL_RUNNER, "-c", LEGO_YAML,
           "--load-checkpoint", str(ckdir), "--rounds", "1",
           f"dataset.basedir={root}", f"experiment.logdir={work}",
           "experiment.id=lego_eval"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    eval_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"lego eval CLI exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.splitlines()[-1][len("result "):])
    psnr = result["summary"][0]["psnr"]
    print(f"vanilla cli eval: python3 -m codenerf_tpu_torch.eval_cli -c "
          f"{LEGO_YAML} --load-checkpoint <step {VANILLA_CLI_STEPS}> "
          f"--rounds 1: exit 0 in {eval_s:.4g} s, PSNR {psnr:.6g} dB at the "
          f"val view's true pose; modules loaded {result['loaded']}",
          flush=True)
    if not finite([psnr]) or result["loaded"]:
        raise RuntimeError(f"lego eval CLI: {result}")
    return {"cli_s": cli_s, "step1_ms": train[1]["time_taken"] * 1e3,
            "step_ms": step_ms, "rays_per_step": rays,
            "rays_per_s": rays / step_ms * 1e3,
            "peak_bytes": stats["peak_bytes"], "train_launches_K4":
            stats["K4"], "val_psnr": val[0]["psnr"], "eval_s": eval_s,
            "eval_psnr": psnr,
            "loss_fine": [train[i]["nerf_loss_fine"] for i in (1, 2, 3)]}


def srn_cars_steps(root: Path, work: Path, card) -> dict:
    """``VANILLA_CLI_STEPS`` in-process steps of srn-cars.yml (vanilla NeRF
    on SRN) on the cli phase's SRN tree, the YAML's own runtime."""
    cfg = load_config(ROOT / SRN_CARS_YAML, [
        f"dataset.basedir={root}", f"experiment.logdir={work}",
        "experiment.id=srn_vanilla", "experiment.print_every=1",
        "experiment.save_every=1000", "experiment.validate_every=1000"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run_training(cfg, max_steps=VANILLA_CLI_STEPS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    recs = [r for r in jsonl(work / "srn_vanilla" / "metrics.jsonl")
            if r["mode"] == "train"]
    fine = [r["nerf_loss_fine"] for r in recs]
    rays = cfg.dataset.train_batch_size * cfg.nerf.ray_sampler.num_random_rays
    print(f"vanilla srn-cars: run_training({SRN_CARS_YAML}, max_steps="
          f"{VANILLA_CLI_STEPS}) on the cli tree in {secs:.4g} s: {rays} "
          f"rays a step, step 2 {recs[1]['time_taken'] * 1e3:.6g} ms; fine "
          f"loss {fine} on {card}", flush=True)
    if len(recs) != VANILLA_CLI_STEPS or not finite(fine):
        raise RuntimeError(f"srn-cars: {recs}")
    return {"loss_fine": fine, "step_ms": recs[1]["time_taken"] * 1e3,
            "seconds": secs}


def vanilla_phase(card) -> dict:
    """Phase 10: lego.yml, fern.yml and their entry points."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_vanilla_"))
    try:
        t0 = time.perf_counter()
        lego = lego_phase(work, card)
        fern = fern_phase(work, card)
        cli = vanilla_cli(work, card)
        print(f"vanilla: lego step xla {lego['xla']['step_ms']:.6g} ms, "
              f"layer_bwd {lego['layer_bwd']['step_ms']:.6g} ms (1 x 16384 "
              f"rays); full-batch CLI step {cli['step_ms']:.6g} ms, peak "
              f"{cli['peak_bytes'] / 2**30:.4g} GiB; fern step "
              f"{fern['step_ms']:.6g} ms (JPEG tree "
              f"{fern['jpeg']['step_ms']:.6g} ms); phase "
              f"{time.perf_counter() - t0:.4g} s on {card}", flush=True)
        return {"lego": lego, "fern": fern, "cli": cli}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# data parallelism over rays (parallel/): two ranks per world, each
# spawned by parallel.launch.spawn; three gated train steps, one TTO step,
# the images and 10 steps of run_training per world
DIST_RANKS = 2
DIST_STEPS = 3
DIST_WORLD1_STEPS = 6
DIST_CLI_STEPS = 10
DIST_TIMEOUT = 600
# TTO steps and images timed after the gated one (median)
DIST_TIMED = 5
NO_NCCL_KERNEL = "none: NCCL runs no kernel for a one-rank in-place sum"


def dist_inputs(size, dirs, teacher) -> dict:
    """What the dist phase's ranks and its one-process references start
    from, on the CPU: 4 train targets and 4 TTO targets the seeded
    teacher renders at the train and TTO phases' poses from codes of its
    own tables, the 2458-object table TTO starts from, the teacher and
    the image's codes and pose."""
    cfg, k1_settings = mode_config(TRAIN_MODES["fused"][0])
    emb = cfg.models.embedding
    B, K = cfg.dataset.train_batch_size, TTO_OBJECTS
    gen = torch.Generator(device="cpu").manual_seed(SEED + 40)
    tables = CodeTables(8, emb.shape_code_size, emb.texture_code_size,
                        "cuda", gen)
    tto_tables = CodeTables(SRN_CARS_TRAIN_OBJECTS, emb.shape_code_size,
                            emb.texture_code_size, "cuda", gen)
    render = make_image_renderer(k1_settings, size, size,
                                 cfg.nerf.validation.chunksize, "cuda")
    poses = torch.stack([pose_spherical(0.5 + 0.25 * i, 0.9 * i, 1.3,
                                        device="cuda") for i in range(B)])
    phis = torch.linspace(-2.0, 2.0, K, device="cuda")
    tto_poses = pose_spherical(torch.full_like(phis, 1.2), phis, 1.3)
    with torch.no_grad():
        pixels = torch.stack([render(teacher, dirs, poses[i], *lookup_codes(
            tables, torch.tensor([i], device="cuda"))).reshape(size, size, 3)
            for i in range(B)])
        targets = torch.stack([render(teacher, dirs, tto_poses[i],
                                      *lookup_codes(tto_tables, torch.tensor(
                                          [i], device="cuda"))).reshape(
                                              size, size, 3)
                               for i in range(K)])
        z_s, z_t = lookup_codes(tables, torch.tensor([3], device="cuda"))

    def cpu(x):
        return x.detach().cpu()

    return {"dirs": cpu(dirs), "poses": cpu(poses), "pixels": cpu(pixels),
            "ids": torch.arange(B), "tto_targets": cpu(targets),
            "tto_poses": cpu(tto_poses),
            "tto_tables": {k: cpu(v) for k, v in
                           tto_tables.state_dict().items()},
            "teacher": {k: {n: cpu(v) for n, v in m.state_dict().items()}
                        for k, m in teacher.items()},
            "z": (cpu(z_s), cpu(z_t)),
            "pose": cpu(pose_spherical(1.2, 0.6, 1.3)), "size": size}


def _on(device, inputs, *keys):
    return [inputs[k].to(device) for k in keys]


def dist_train(world, inputs, steps) -> dict:
    """``steps`` fused train steps of 4 x 4096 rays from the seeded
    student of the train phase, in ``world`` (None: one process): the
    first step's gradients, each step's fine loss and ms, the launches
    and the parameters at the end (on the CPU)."""
    dev = torch.device("cuda") if world is None else world.device
    cfg, settings = mode_config(TRAIN_MODES["fused"][0])
    st = init_train_state(cfg, settings, 8, seed=SEED + 2, device=dev)
    step = make_train_step(settings, st, cfg.nerf.ray_sampler.num_random_rays,
                           cfg.experiment.regularizer_lambda, True,
                           world=world)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    args = _on(dev, inputs, "dirs", "poses", "pixels", "ids")
    out = {"fine_loss": [], "ms": []}
    before = launch_counts()
    for i in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        m = step(*args, gen)
        torch.cuda.synchronize(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["fine_loss"].append(float(m.loss_fine))
        if i == 0:
            out["grads"] = {k: v.cpu() for k, v in grads_of(st).items()}
            out["metrics"] = [float(v) for v in m]
    out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    out["params"] = {k: v.cpu() for k, v in state_tensors(st).items()}
    out["bytes_all_reduced"] = 4 * (sum(p.numel() for m in
                                        st.modules().values()
                                        for p in m.parameters()) + 2)
    return out


def dist_tto(world, inputs) -> dict:
    """One batched fused TTO step of 4 x 4096 rays from the mean codes of
    the 2458-object table, the teacher frozen, in ``world``: the loss
    [K] and the variables' gradients (on the CPU), the ms."""
    dev = torch.device("cuda") if world is None else world.device
    cfg, settings = mode_config(TRAIN_MODES["fused"][0])
    emb = cfg.models.embedding
    tables = CodeTables(SRN_CARS_TRAIN_OBJECTS, emb.shape_code_size,
                        emb.texture_code_size, dev)
    tables.load_state_dict(inputs["tto_tables"])
    models = dist_models(settings, inputs, dev)
    st, opt = init_batched_tto_state(tables, cfg.optimizer, TTO_OBJECTS,
                                     device=dev)
    step = make_batched_tto_step(settings, opt,
                                 cfg.nerf.ray_sampler.num_random_rays,
                                 cfg.experiment.regularizer_lambda,
                                 cfg.nerf.point_sampler.perturb, dev,
                                 world=world)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    args = (models, *_on(dev, inputs, "dirs", "tto_targets", "tto_poses"),
            gen)
    st, m = step(st, *args)
    out = {"loss": m.loss.cpu(),
           "grads": {k: st.variables[k].grad.cpu() for k in TTO_KEYS}}
    torch.cuda.synchronize(dev)
    _, ms, _ = timed_steps(step, st, args, DIST_TIMED)
    out["ms"] = statistics.median(ms)
    return out


def dist_models(settings, inputs, dev) -> dict:
    models = {k: CodeNeRF(getattr(settings, f"{k}_cfg"), dev)
              for k in ("coarse", "fine")}
    for k, m in models.items():
        m.load_state_dict(inputs["teacher"][k])
    return models


def dist_images(world, inputs) -> dict:
    """The 128x128 image through K1 and the int8 image (calibrated by
    ``int8_render_params`` at the render pose, on every rank of a world),
    in ``world``, their ms, and the int8 modules' buffers."""
    dev = torch.device("cuda") if world is None else world.device
    cfg, k1_settings = mode_config({"use_pallas": True})
    _, settings = mode_config({})
    size = inputs["size"]
    models = dist_models(settings, inputs, dev)
    dirs, pose = _on(dev, inputs, "dirs", "pose")
    z_s, z_t = (z.to(dev) for z in inputs["z"])
    harness = types.SimpleNamespace(
        directions=dirs, settings=settings,
        cfg=dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, int8_serving=True)))
    out = {}
    for name, s in (("k1", k1_settings), ("int8", settings)):
        render = make_image_renderer(s, size, size,
                                     cfg.nerf.validation.chunksize, dev,
                                     world=world)
        mods = (models if name == "k1" else
                int8_render_params(harness, models, pose, z_s, z_t))
        out[name] = render(mods, dirs, pose, z_s, z_t).cpu()  # warm-up
        out[f"{name}_ms"] = statistics.median(timed_renders(
            render, (mods, dirs, pose, z_s, z_t), DIST_TIMED))
    out["int8_buffers"] = [b.cpu() for m in mods.values()
                           for b in m.buffers()]
    return out


def dist_training(world, root, work) -> dict:
    """``run_training`` of the flagship YAML on the cli phase's tree for
    ``DIST_CLI_STEPS`` steps with K1 + K2 in ``world``, validating at
    step 5: this rank's launches, checkpoint writes and parameters."""
    overrides = [f"dataset.basedir={root}", f"experiment.logdir={work}",
                 "experiment.id=dist", f"experiment.save_every="
                 f"{DIST_CLI_STEPS}", "experiment.validate_every=5",
                 "experiment.val_iterations=10", "experiment.print_every=5",
                 "runtime.use_pallas=True", "runtime.pallas_backward=True"]
    cfg = load_config(ROOT / CLI_YAML, overrides)
    saves, states = [], []
    save, init = checkpoint.save_checkpoint, loop.init_train_state

    def counted_save(*args, **kwargs):
        saves.append(args[1].step)
        return save(*args, **kwargs)

    def kept_init(*args, **kwargs):
        states.append(init(*args, **kwargs))
        return states[-1]

    checkpoint.save_checkpoint, loop.init_train_state = counted_save, kept_init
    before = launch_counts()
    try:
        loop.run_training(cfg, max_steps=DIST_CLI_STEPS, device=world.device)
    finally:
        checkpoint.save_checkpoint, loop.init_train_state = save, init
    return {"launches": {k: v - before[k] for k, v in launch_counts().items()},
            "saves": saves,
            "params": {k: v.cpu()
                       for k, v in state_tensors(states[0]).items()}}


def dist_rank(world, inputs, root, work) -> dict:
    """One rank of the dist phase's worlds (``parallel.launch``); under
    NCCL also one more train step's profile."""
    out = {"train": dist_train(world, inputs, DIST_STEPS),
           "tto": dist_tto(world, inputs),
           "images": dist_images(world, inputs),
           "cli": dist_training(world, root, work)}
    if torch.distributed.get_backend() == "nccl":
        out["profile"] = nccl_profile(world, inputs)
    return out


def nccl_all_reduce_kernels(prof) -> dict:
    """The device records of a ``nccl_profile`` that are NCCL's
    all-reduce kernels (``ncclDevKernel_AllReduce_...``), with their
    ms."""
    return {k: v for k, v in prof["card_ms"].items()
            if "allreduce" in k.lower().replace("_", "")}


@contextlib.contextmanager
def world_of_one(backend):
    """A world of one rank on ``cuda:0`` in this process, as torchrun's
    environment would describe it; left, and the environment restored,
    after."""
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(launch.free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield init_world(1, backend=backend, device="cuda:0")
    finally:
        close_world()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def nccl_profile(world, inputs) -> dict:
    """One more train step in ``world`` under ``torch.profiler``: the
    records whose names hold "nccl", on the host and on the card."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        dist_train(world, inputs, 1)
        torch.cuda.synchronize()
    host, card = set(), {}
    for e in prof.key_averages():
        if "nccl" not in e.key.lower():
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            card[e.key] = getattr(e, "device_time_total", 0.0) / 1e3
        else:
            host.add(e.key)
    return {"host": sorted(host), "card_ms": card}


def check_world(label, results, ref, card, shared) -> dict:
    """Gate one world's ranks against the one-process references ``ref``
    and print their numbers."""
    ranks = len(results)
    note = ("two ranks share one card: the ms are the collectives' cost, "
            "not scaling" if shared else "one card per rank")
    out = {"note": note}
    # train: step 1's summed gradients, bit-identical ranks, falling loss
    rel = {r: grad_rel_rms(res["train"]["grads"], ref["train"]["grads"])
           for r, res in enumerate(results)}
    worst = max(((r, k, v) for r, d in rel.items() for k, v in d.items()),
                key=lambda x: x[2])
    differ = [k for r in range(1, ranks) for k in bit_identical(
        results[0]["train"]["params"], results[r]["train"]["params"])]
    loss = results[0]["train"]["fine_loss"]
    print(f"dist {label} train: {ranks} ranks x "
          f"{4 * 4096 // ranks} rays a step, step 1 gradient relRMS against "
          f"the one-process step: worst rank {worst[0]} {worst[1]} "
          f"{worst[2]:.4g} ({len(rel[0])} leaves); parameters after "
          f"{DIST_STEPS} steps bit-identical across ranks: {not differ}; "
          f"fine loss {[round(x, 6) for x in loss]}; ms per step "
          f"{[[round(x, 3) for x in res['train']['ms']] for res in results]} "
          f"(step 1 with each process's warm-up; one process: median of "
          f"steps 2-{DIST_WORLD1_STEPS} "
          f"{statistics.median(ref['train']['ms'][1:]):.6g} ms); launches "
          f"per rank "
          f"{[res['train']['launches'] for res in results]}; {note}; on "
          f"{card}", flush=True)
    if not worst[2] <= REL_RMS_GATE or differ or not loss[-1] < loss[0]:
        raise RuntimeError(f"dist {label} train: relRMS {worst}, differ "
                           f"{differ}, fine loss {loss}")
    # TTO: the loss within 1e-3, the variables' gradients at 1e-2
    tto_rel = {(r, k): float(torch.linalg.norm(res["tto"]["grads"][k]
                                               - ref["tto"]["grads"][k])
                             / torch.linalg.norm(ref["tto"]["grads"][k]))
               for r, res in enumerate(results) for k in TTO_KEYS}
    tto_loss = max(float((res["tto"]["loss"] - ref["tto"]["loss"]).abs().max()
                         / ref["tto"]["loss"].abs().max()) for res in results)
    w = max(tto_rel, key=tto_rel.get)
    print(f"dist {label} tto: batched K = {TTO_OBJECTS} x 4096 rays, "
          f"{ranks} ranks: loss relative difference {tto_loss:.4g} (gate "
          f"1e-3), worst gradient relRMS {w} {tto_rel[w]:.4g} (gate "
          f"{REL_RMS_GATE}); ms per step (median of {DIST_TIMED} after "
          f"it) {[round(r['tto']['ms'], 3) for r in results]} (one process "
          f"{ref['tto']['ms']:.6g}); {note}; on {card}",
          flush=True)
    if not (tto_loss <= 1e-3 and tto_rel[w] <= REL_RMS_GATE):
        raise RuntimeError(f"dist {label} tto: loss {tto_loss}, {w} "
                           f"{tto_rel[w]}")
    # images: >= 40 dB against the one-process images
    psnr = {}
    for name in ("k1", "int8"):
        for r, res in enumerate(results):
            psnr[(name, r)] = float(mse2psnr(torch.mean(
                (res["images"][name] - ref["images"][name]) ** 2)))
    same = {name: all(torch.equal(res["images"][name], ref["images"][name])
                      for res in results) for name in ("k1", "int8")}
    # every rank calibrates its int8 buffers itself: they must agree
    first = results[0]["images"]["int8_buffers"]
    buffers_same = all(
        len(bufs) == len(first)
        and all(torch.equal(a, b) for a, b in zip(bufs, first))
        for bufs in (res["images"]["int8_buffers"] for res in results[1:]))
    print(f"dist {label} images: 128x128 through K1 and int8 on {ranks} "
          f"ranks: PSNR against the one-process image K1 "
          f"{min(v for (n, _), v in psnr.items() if n == 'k1'):.6g} dB, "
          f"int8 {min(v for (n, _), v in psnr.items() if n == 'int8'):.6g} "
          f"dB; bit-identical {same}; int8 buffers bit-identical across "
          f"ranks: {buffers_same}; ms per image (median of "
          f"{DIST_TIMED}) K1 "
          f"{[round(r['images']['k1_ms'], 3) for r in results]} (one "
          f"process {ref['images']['k1_ms']:.6g}), int8 "
          f"{[round(r['images']['int8_ms'], 3) for r in results]} (one "
          f"process {ref['images']['int8_ms']:.6g}); {note}; on {card}",
          flush=True)
    if not (min(psnr.values()) >= PSNR_GATE and buffers_same):
        raise RuntimeError(f"dist {label} images: {psnr}, int8 buffers "
                           f"bit-identical {buffers_same}")
    # run_training: rank 0 alone saves, equal parameters, K1 and K2 on
    # every rank
    cli = [res["cli"] for res in results]
    differ = [k for r in range(1, ranks) for k in bit_identical(
        cli[0]["params"], cli[r]["params"])]
    print(f"dist {label} run_training: {DIST_CLI_STEPS} steps of "
          f"{CLI_YAML} (K1 + K2, validation at step 5) on {ranks} ranks: "
          f"checkpoint writes per rank {[c['saves'] for c in cli]}; "
          f"parameters bit-identical across ranks: {not differ}; launches "
          f"per rank {[c['launches'] for c in cli]}; {note}; on {card}",
          flush=True)
    if (cli[0]["saves"] != [DIST_CLI_STEPS] or any(c["saves"] for c in cli[1:])
            or differ or any(not (c["launches"]["K1"] > 0
                                  and c["launches"]["K2"] > 0) for c in cli)):
        raise RuntimeError(f"dist {label} run_training: saves "
                           f"{[c['saves'] for c in cli]}, differ {differ}, "
                           f"launches {[c['launches'] for c in cli]}")
    out.update(train_ms=[r["train"]["ms"] for r in results],
               train_worst_rel_rms=worst[2], tto_ms=[r["tto"]["ms"]
                                                     for r in results],
               tto_loss_rel=tto_loss, tto_worst_rel_rms=tto_rel[w],
               image_psnr={f"{n} rank {r}": v for (n, r), v in psnr.items()},
               image_bit_identical=same,
               k1_image_ms=[r["images"]["k1_ms"] for r in results],
               int8_image_ms=[r["images"]["int8_ms"] for r in results],
               cli_launches=[c["launches"] for c in cli],
               train_launches=[r["train"]["launches"] for r in results])
    return out


def dist_phase(size, dirs, teacher, root, work, card) -> dict:
    """Data parallelism over rays on the card (phase 8b): (a) a world of
    one NCCL rank against no world, (b) two gloo ranks sharing
    ``cuda:0``, (c) NCCL over two cards where the machine has them."""
    t0 = time.perf_counter()
    inputs = dist_inputs(size, dirs, teacher)
    # the one-process references (and the world of one's comparison)
    ref = {"train": dist_train(None, inputs, DIST_WORLD1_STEPS),
           "tto": dist_tto(None, inputs), "images": dist_images(None, inputs)}
    with world_of_one("nccl") as world:
        one = dist_train(world, inputs, DIST_WORLD1_STEPS)
        prof = nccl_profile(world, inputs)
    differ = bit_identical(one["params"], ref["train"]["params"]) + [
        k for k in ref["train"]["grads"]
        if not torch.equal(one["grads"][k], ref["train"]["grads"][k])]
    world_ms = statistics.median(one["ms"][1:])
    plain_ms = statistics.median(ref["train"]["ms"][1:])
    print(f"dist (a) NCCL world of 1 on cuda:0: fused train step of 4 x "
          f"4096 rays through the distributed code path, "
          f"{DIST_WORLD1_STEPS} steps: bit-identical to the step without a "
          f"world: {not differ} (gradients of step 1, every parameter and "
          f"moment after); median of steps 2-{DIST_WORLD1_STEPS} "
          f"{world_ms:.6g} ms against {plain_ms:.6g} ms without a world; "
          f"{one['bytes_all_reduced']} bytes all-reduced per step; "
          f"profile: NCCL host records {prof['host']}, NCCL device time "
          f"{prof['card_ms'] or NO_NCCL_KERNEL}"
          f" on {card}", flush=True)
    if differ or one["metrics"] != ref["train"]["metrics"]:
        raise RuntimeError(f"dist (a): world of one differs: {differ}, "
                           f"{one['metrics']} against "
                           f"{ref['train']['metrics']}")
    if "nccl:all_reduce" not in prof["host"]:
        raise RuntimeError(f"dist (a): no NCCL all_reduce in the profile: "
                           f"{prof}")
    out = {"a": {"world_ms": world_ms, "plain_ms": plain_ms,
                 "bytes_all_reduced": one["bytes_all_reduced"],
                 "profile": prof}}
    t_b = time.perf_counter()
    results = launch.spawn(dist_rank, DIST_RANKS,
                           (inputs, str(root), str(work / "dist_b")),
                           backend="gloo", devices=["cuda:0"] * DIST_RANKS,
                           timeout=DIST_TIMEOUT)
    out["b"] = check_world("(b) gloo, 2 ranks on cuda:0", results, ref,
                           card, shared=True)
    out["b"]["seconds"] = time.perf_counter() - t_b
    if torch.cuda.device_count() >= DIST_RANKS:
        results = launch.spawn(dist_rank, DIST_RANKS,
                               (inputs, str(root), str(work / "dist_c")),
                               backend="nccl", timeout=DIST_TIMEOUT)
        out["c"] = check_world("(c) NCCL, one card per rank", results, ref,
                               card, shared=False)
        kernels = [nccl_all_reduce_kernels(r["profile"]) for r in results]
        out["c"]["nccl_all_reduce_ms"] = kernels
        print(f"dist (c) NCCL all-reduce kernels on the card, per rank, in "
              f"one profiled train step: {kernels} on {card}", flush=True)
        if not all(kernels):
            raise RuntimeError(f"dist (c): no NCCL all-reduce kernel in a "
                               f"rank's profile: "
                               f"{[r['profile'] for r in results]}")
    else:
        out["c"] = (f"not run: the machine has {torch.cuda.device_count()} "
                    f"card; NCCL over two ranks needs a card each")
        print(f"dist (c) {out['c']}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"dist: (b) {out['b']['seconds']:.4g} s with its ranks' "
          f"start-up, on {card}", flush=True)
    phase("dist", t0)
    return out


def dist_launches(dist, name) -> dict:
    """A kernel's launches on each rank of the dist phase's (b) world."""
    return {f"{DIST_STEPS} train steps": [
                r[name] for r in dist["b"]["train_launches"]],
            f"run_training {DIST_CLI_STEPS} steps": [
                r[name] for r in dist["b"]["cli_launches"]]}


def tool_launches(tools: dict, name: str) -> dict:
    """Kernel ``name``'s launches in each tool's process."""
    runs = {"render_views": tools["render_views"]["launches"],
            "render_views_int8": tools["render_views"]["int8_launches"],
            "phi_sweep": tools["phi_sweep"]["launches"],
            "diag_fine": tools["diag_fine"]["launches"],
            "gpu_selftest": tools["gpu_selftest"]["launches"]}
    return {tool: launches[name] for tool, launches in runs.items()}


def val_image(cfg) -> str:
    crop = cfg.dataset.image_size - 2 * (cfg.dataset.image_size // 8)
    return f"{crop}x{crop}"


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
    sources = ("trunk_fwd", "trunk_bwd", "layer_bwd", "layer_fwd")
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
    if sys.argv[1:] == ["--dist-only"]:
        # the dist phase alone (on a machine with two or more cards for
        # its (c)), on the cli phase's SRN tree
        work = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
        try:
            make_srn_tree(work / "srn_cars", size, dirs, models,
                          cli_tables())
            dist = dist_phase(size, dirs, models, work / "srn_cars", work,
                              card)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"dist": dist}), flush=True)
        print(f"wall: {time.perf_counter() - t_all:.2f} s", flush=True)
        return
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
    k4 = check_k4(K4_CASES, card)
    lf = check_layer_fwd(card)
    # the f32 instantiations of K1-K3, on an f32 model from its own seed
    _, f32_settings = mode_config({"compute_dtype": "float32"})
    model32 = CodeNeRF(f32_settings.fine_cfg, "cuda",
                       torch.Generator(device="cpu").manual_seed(SEED + 7))
    f32_cases = check_f32(f32_settings, model32, ro_all[:n_step].contiguous(),
                    rd_all[:n_step].contiguous(), z_s.expand(n_step, -1),
                    z_t.expand(n_step, -1), chunk)
    del model32
    widths = check_widths(card)
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
    int8 = int8_phase(cfg, settings, models, cpu_models, z_s, z_t, pose,
                      dirs, directions(small), img, ms_img,
                      statistics.median(rays_ms), card)
    phase("int8", t0)

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

    t0 = time.perf_counter()

    def on_the_tree(root, work):
        return {"srn_cars": srn_cars_steps(root, work, card),
                "dist": dist_phase(size, dirs, models, root, work, card)}

    cli = cli_phase(size, dirs, models, train["fused"]["step_ms"], card,
                    then=on_the_tree, keep=True)
    dist = cli["then"].pop("dist")
    phase("cli", t0)

    try:
        t0 = time.perf_counter()
        ev = eval_phase(models, tables, dirs, card, keep=True)
        phase("eval", t0)
        try:
            t0 = time.perf_counter()
            tools = tools_phase(cli["root"], cli["ckpt"], ev["data"],
                                ev["work"], card)
            phase("tools", t0)
        finally:
            shutil.rmtree(ev.pop("work"), ignore_errors=True)
            ev.pop("data")
    finally:
        shutil.rmtree(cli.pop("work"), ignore_errors=True)
        cli.pop("root"), cli.pop("ckpt")

    t0 = time.perf_counter()
    k4_vanilla = check_k4(K4_VANILLA_CASES, card, seed=SEED + 29)
    vanilla = vanilla_phase(card)
    vanilla["srn_cars"] = cli.pop("then")["srn_cars"]
    phase("vanilla", t0)

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
        "cli_train_launches": cli["train_launches"]["K1"],
        "cli_val_launches": cli["val_launches"]["K1"],
        "eval_launches": ev["launches"]["K1"],
        "tools_launches": tool_launches(tools, "K1"),
        "dist_launches_per_rank": dist_launches(dist, "K1"),
        "launches_per_tto_step": tto["fused"]["launches_per_step"]["K1"],
        "train_step_ms": step_k1["ms"],
        "train_step_wrapper_ms": step_k1["wrapper_ms"],
        "train_step_plain_ms": step_k1["plain_ms"],
        "train_step_library_ms": step_k1["library_ms"],
        "train_step_bound_ms": bound_ms(step_k1_cost)[0],
        "shapes": k1["shapes"],
        "f32": f32_cases["K1"],
        "widths": widths["K1"],
    }]
    for name, mode in (("K2", "fused"), ("K3", "hybrid")):
        rows = [r for r in bwd[name] if r["R"] == n_step]
        cost = {k: sum(r["cost"][k] for r in rows) for k in rows[0]["cost"]}
        b_ms, b_by = bound_ms(cost)
        kernels.append({
            "name": f"{name} trunk_bwd_rows_wgmma<"
                    f"{'false' if name == 'K3' else 'true'}> + xtg",
            "route": "cuda",
            "source": "codenerf_tpu_torch/ops/csrc/trunk_bwd.cu",
            "row_pass": sorted({r["route"] for r in rows}),
            "replaces": "codenerf_tpu/ops/fused.py:183",
            "launches": train[mode]["launches"][name],
            "launches_per_train_step": train[mode]["launches_per_step"][name],
            "tto_launches": tto[mode]["launches"][name],
            "launches_per_tto_step": tto[mode]["launches_per_step"][name],
            "cli_train_launches": cli["train_launches"][name],
            "cli_val_launches": cli["val_launches"][name],
            "eval_launches": ev["launches"][name],
            "tools_launches": tool_launches(tools, name),
            "dist_launches_per_rank": dist_launches(dist, name),
            "max_abs_err": max(r["max_abs_err"] for r in bwd[name]),
            "rel_rms": max(r["rel_rms"] for r in bwd[name]),
            "ms": sum(r["ms"] for r in rows),
            "frozen_ms": sum(r["frozen_ms"] for r in rows),
            "frozen_note": "need_dw=False, a frozen trunk's call (TTO, "
                           "validation): no dW operand, no dW product",
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
            "widths": widths[name],
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
    # one vanilla step's K4 launches (each pass: 7 bias + 1 per-ray on
    # lego, 4 + 1 on fern), from the timed cases at the step's shapes
    counts = {"lego": {"bias": 7, "per-ray": 1},
              "fern": {"bias": 4, "per-ray": 1}}
    vanilla_k4_steps = {
        scene: [(r, n) for r in k4_vanilla for kind, n in kinds.items()
                if r["case"].startswith(scene) and r["case"].endswith(kind)]
        for scene, kinds in counts.items()}
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
        "shapes": k4 + k4_vanilla,
        "eval_launches": ev["launches"]["K4"],
        "tools_launches": tool_launches(tools, "K4"),
        "widths": widths["K4"],
        "vanilla_launches": {
            "lego_per_step": vanilla["lego"]["layer_bwd"][
                "launches_per_step"]["K4"],
            "fern_per_step": vanilla["fern"]["launches_per_step"]["K4"],
            "fern_jpeg_per_step": vanilla["fern"]["jpeg"][
                "launches_per_step"]["K4"],
            "fern_jpeg_cli_train": vanilla["fern"]["jpeg"]["cli_K4"],
            "lego_cli_train": vanilla["cli"]["train_launches_K4"]},
        "vanilla_step_ms": {k: sum(n * r["ms"] for r, n in rows)
                            for k, rows in vanilla_k4_steps.items()},
        "vanilla_step_plain_ms": {
            k: sum(n * r["plain_ms"] for r, n in rows)
            for k, rows in vanilla_k4_steps.items()},
        "vanilla_step_library_ms": {
            k: sum(n * r["library_ms"] for r, n in rows)
            for k, rows in vanilla_k4_steps.items()},
        "vanilla_step_bound_ms": {
            k: bound_ms({c: sum(n * r["cost"][c] for r, n in rows)
                         for c in rows[0][0]["cost"]})[0]
            for k, rows in vanilla_k4_steps.items()},
    })
    # one lego chunk-step of the fused forward: each case's time by its
    # layer-passes (LEGO_LF_PASSES)
    lf_steps = [(r, LEGO_LF_PASSES[r["case"].split()[0]]) for r in lf]
    lf_cost = {c: sum(n * r["cost"][c] for r, n in lf_steps)
               for c in lf[0]["cost"]}
    lf_bound_ms, lf_bound_by = bound_ms(lf_cost)
    kernels.append({
        "name": "LF layer_fwd",
        "route": "cuda",
        "source": "codenerf_tpu_torch/ops/csrc/layer_fwd.cu",
        "replaces": "codenerf_tpu/models/ray_structured.py:90",
        "launches": train["layer_bwd"]["launches"]["LF"],
        "launches_per_train_step":
            train["layer_bwd"]["launches_per_step"]["LF"],
        "launches_per_tto_step": tto["layer_bwd"]["launches_per_step"]["LF"],
        "launches_per_lego_step": {
            m: vanilla["lego"][m]["launches_per_step"]["LF"]
            for m in VANILLA_RUNTIMES},
        "differ": max(r["differ"] for r in lf),
        "ms": sum(n * r["ms"] for r, n in lf_steps),
        "plain_ms": sum(n * r["plain_ms"] for r, n in lf_steps),
        "library_ms": sum(n * r["library_ms"] for r, n in lf_steps),
        "library_note": "the bf16 cuBLAS product alone (_mmc, f32 sums "
                        "rounded once), without the bias add and relu",
        "bound_ms": lf_bound_ms,
        "bound_by": lf_bound_by,
        "per": f"one lego chunk-step of {lf[0]['R']} rays: "
               f"{sum(n for _, n in lf_steps)} launches, "
               + ", ".join(f"{n} x {r['case']}" for r, n in lf_steps),
        "shapes": lf,
    })
    print(json.dumps({"cli": cli}), flush=True)
    print(json.dumps({"int8": {
        **int8, "lego": vanilla["lego"]["int8"],
        "fern": vanilla["fern"]["int8"], "eval_int_mm": ev["int_mm"],
        "eval_drop_db": ev["int8_drop_db"]}}), flush=True)
    print(json.dumps({"vanilla": {
        k: ({m: ({kk: vv for kk, vv in r.items() if kk != "profile"}
                 if isinstance(r, dict) else r)
             for m, r in v.items()} if k == "lego" else v)
        for k, v in vanilla.items()}}), flush=True)
    print(json.dumps({"eval": {k: v for k, v in ev.items()
                               if k != "summary"}
                      | {"summary": {k: v for k, v in ev["summary"].items()
                                     if k != "per_object"}}}), flush=True)
    print(json.dumps({"dist": dist}), flush=True)
    print(json.dumps({"tools": tools}, default=str), flush=True)
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
