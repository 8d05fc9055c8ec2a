#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``codenerf_tpu_torch``).

Drives the port's serving path on one NVIDIA card at the flagship width
of ``configs/srn-cars-code.yml`` (values from ``SRN_CARS_CODE``, so no
YAML is read) with random weights from a seed:

  1. device  — require CUDA; print the card's name and power limit.
  2. build   — compile K1 (``ops/csrc/trunk_fwd.cu``) with nvcc into
               ``build/torch_kernels/``.
  3. kernels — K1 against its plain PyTorch version on the card at the
               main path's shapes (R = 4096 rays, S = 32 and 160); max abs
               error, relRMS (gate 1e-2), kernel and plain times (CUDA
               events around back-to-back calls) beside the bound.
  4. render  — one 128x128 image through ``make_image_renderer`` on CUDA
               with K1 (K1's launch count must rise by exactly 8), the same
               image with the plain trunk (PSNR gate 40 dB), and a 16x16
               image on the card against the port's CPU path (40 dB).
  5. profile — one more render under ``torch.profiler``: device busy
               time by kernel, K1's share, the idle share.
  6. result  — the kernel table as one JSON line, the card line, and the
               last line ``{"ok": true, "device": {...}}``.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Any failure
raises and exits nonzero without the last line.  Imports only torch, numpy,
the standard library and ``codenerf_tpu_torch``.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import torch

from codenerf_tpu_torch.config import SRN_CARS_CODE, config_from_dict
from codenerf_tpu_torch.core import mse2psnr, pixel_directions, pose_spherical
from codenerf_tpu_torch.eval import make_image_renderer
from codenerf_tpu_torch.models import CodeNeRF, CodeTables, lookup_codes
from codenerf_tpu_torch.ops import _build
from codenerf_tpu_torch.ops.fused import (kernel_weights, per_ray_parts,
                                          trunk_forward, trunk_forward_plain)
from codenerf_tpu_torch.core.encoding import positional_encoding
from codenerf_tpu_torch.pipeline import RenderSettings

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32
# outside them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
REL_RMS_GATE = 1e-2
PSNR_GATE = 40.0
SRN_FOCAL_128 = 131.25      # SRN cars intrinsics at 128x128, cx = cy = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


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


def profile_render(render, args, unprofiled_ms) -> dict:
    """Device time by kernel over one render under ``torch.profiler``
    (one stream, so the sum of kernel times is the busy time).  Only
    device-side entries count: an operator's own entry repeats the time of
    the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            by_name[e.key] = (by_name.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    busy = sum(by_name.values())
    k1 = sum(v for k, v in by_name.items() if "trunk_fwd" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "unprofiled_ms": unprofiled_ms,
            "idle_share": (1 - busy / unprofiled_ms) if busy else None,
            "k1_ms": k1, "k1_share_of_busy": k1 / busy if busy else None,
            "n_kernel_names": len(by_name),
            "top": [[k[:80], v] for k, v in top]}


def phase(name, t0):
    print(f"phase {name}: done in {time.perf_counter() - t0:.2f} s",
          flush=True)


def check_k1(settings, model, ro, rd, zs, zt, card) -> dict:
    """K1 vs its plain version on the card at the main path's shapes."""
    cfg = model.cfg
    F = settings.num_encoding_fn_xyz
    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    dir_enc = positional_encoding(viewdirs, settings.num_encoding_fn_dir,
                                  settings.include_input_dir,
                                  settings.log_sampling_dir)
    with torch.no_grad():
        per_ray = per_ray_parts(model, dir_enc, zs, zt)
        weights = kernel_weights(model, F, settings.log_sampling_xyz)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    R = ro.shape[0]
    shapes = []
    for S in (settings.num_coarse, settings.num_coarse + settings.num_fine):
        z = torch.sort(settings.near + (settings.far - settings.near)
                       * torch.rand(R, S, generator=gen), dim=-1).values
        pts = (ro[:, None, :] + rd[:, None, :] * z.cuda()[..., None])
        pts = pts.contiguous()

        def kern():
            return trunk_forward(pts, per_ray, weights,
                                 compute_dtype=cfg.cdtype)

        def plain():
            return trunk_forward_plain(pts, per_ray, weights,
                                       compute_dtype=cfg.cdtype)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"K1 output is not finite at S={S}")
        err = (got - want).abs()
        rel_rms = float(torch.linalg.norm(got - want)
                        / torch.linalg.norm(want))
        ms, plain_ms = time_ms(kern), time_ms(plain, calls=3)
        cost = k1_cost(R, S, weights, per_ray, F)
        b_ms, b_by = bound_ms(cost)
        row = {"R": R, "S": S, "max_abs_err": float(err.max()),
               "rel_rms": rel_rms, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "cost": cost}
        print(f"K1 R={R} S={S}: max_abs_err={row['max_abs_err']:.6g} "
              f"rel_rms={rel_rms:.6g} ms={ms:.6g} plain_ms={plain_ms:.6g} "
              f"bound_ms={b_ms:.6g} ({b_by}) "
              f"achieved={cost['bf16_flops'] / ms / 1e9:.6g} TFLOP/s "
              f"on {card}", flush=True)
        if not rel_rms <= REL_RMS_GATE:
            raise RuntimeError(f"K1 disagrees with its plain version at "
                               f"S={S}: relRMS {rel_rms} > {REL_RMS_GATE}")
        shapes.append(row)
    return {"shapes": shapes}


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
    built = _build.build("trunk_fwd")
    ptxas = [ln.strip() for ln in built["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: K1 {built['path'].name} in {built['seconds']:.2f} s; "
          + " | ".join(ptxas), flush=True)
    phase("build", t0)

    cfg = config_from_dict(SRN_CARS_CODE)
    settings = RenderSettings.from_config(cfg)
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
    k1 = check_k1(settings, models["fine"], ro_all[:chunk].contiguous(),
                  rd_all[:chunk].contiguous(),
                  z_s.expand(chunk, -1), z_t.expand(chunk, -1), card)
    phase("kernels", t0)

    t0 = time.perf_counter()
    render = make_image_renderer(settings, size, size, chunk, "cuda")
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

    render_plain = make_image_renderer(settings, size, size, chunk, "cuda",
                                       trunk=trunk_forward_plain)
    plain_ms_img = []
    for _ in range(3):
        torch.cuda.synchronize()
        t_r = time.perf_counter()
        img_plain = render_plain(models, dirs, pose, z_s, z_t)
        torch.cuda.synchronize()
        plain_ms_img.append((time.perf_counter() - t_r) * 1e3)
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
    img_gpu = make_image_renderer(settings, small, small, 256, "cuda")(
        models, directions(small), pose, z_s, z_t)
    cpu_models = {k: copy.deepcopy(m).to("cpu") for k, m in models.items()}
    img_cpu = make_image_renderer(settings, small, small, 256, "cpu")(
        cpu_models, directions(small).cpu(), pose.cpu(), z_s.cpu(),
        z_t.cpu())
    psnr_cpu = float(mse2psnr(torch.mean((img_gpu.cpu() - img_cpu) ** 2)))
    print(f"render {small}x{small}: PSNR(card K1 vs CPU plain)="
          f"{psnr_cpu:.6g} dB", flush=True)
    if not psnr_cpu >= PSNR_GATE:
        raise RuntimeError(f"card vs CPU image: {psnr_cpu} dB < "
                           f"{PSNR_GATE}")
    phase("render", t0)

    t0 = time.perf_counter()
    prof = profile_render(render, (models, dirs, pose, z_s, z_t), ms_img)
    if prof["device_busy_ms"]:
        print(f"profile: device busy {prof['device_busy_ms']:.6g} ms per "
              f"image against the unprofiled {ms_img:.6g} ms (idle share "
              f"{prof['idle_share']:.4g}); K1 {prof['k1_ms']:.6g} ms "
              f"({prof['k1_share_of_busy']:.4g} of busy) on {card}",
              flush=True)
    else:
        print("profile: torch.profiler recorded no device time: the "
              "breakdown is not measured", flush=True)
    print(json.dumps({"profile": prof}), flush=True)
    phase("profile", t0)

    # one image runs each shape once per chunk
    def per_image(key):
        return n_chunks * sum(s[key] for s in k1["shapes"])

    image_cost = {k: n_chunks * sum(s["cost"][k] for s in k1["shapes"])
                  for k in k1["shapes"][0]["cost"]}
    image_bound_ms, image_bound_by = bound_ms(image_cost)
    kernels = [{
        "name": "K1 trunk_fwd",
        "route": "cuda",
        "source": "codenerf_tpu_torch/ops/csrc/trunk_fwd.cu",
        "replaces": "codenerf_tpu/ops/fused.py:75",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in k1["shapes"]),
        "ms": per_image("ms"),
        "plain_ms": per_image("plain_ms"),
        "bound_ms": image_bound_ms,
        "bound_by": image_bound_by,
        "library_ms": None,
        "per": f"one {size}x{size} image: {n_chunks} launches at each S of "
               f"{[s['S'] for s in k1['shapes']]}, R={chunk}",
        "shapes": k1["shapes"],
    }]
    print(f"wall: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
