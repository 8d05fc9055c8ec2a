"""Kernel self-test on the card: every kernel family against its plain
version, in one process (the port's counterpart of
``tools/tpu_selftest.py``).

The CPU tests reach only the kernels' plain versions; this tool runs the
CUDA kernels themselves, each family through the module the runtime flag
selects:

  fused_fwd  -- K1 (``use_pallas``): ``ops.fused.fused_codenerf``
  fused_bwd  -- K1 + K2 (``pallas_backward``): gradients through
                ``ops.fused.train_codenerf``
  hybrid     -- K3 (``pallas_hybrid``): the plain forward, K3 backward
  layer_bwd  -- K4 (``pallas_layer_bwd``): ``ops.layer_bwd.linear_relu_bwd``
  int8       -- the int8 trunk (``int8_serving``; ``torch._int_mm``)
                against the float trunk

The gate calibrates itself (the JAX tool's): for each family,

  err  = the worst leaf's relRMS of the bf16 kernel against an f32 plain
         version of the same computation,
  gate = max(1.5 x the bf16 plain version's own worst-leaf relRMS against
         that reference, 1e-4),

so a kernel passes when it stays within the rounding noise the bf16 plain
path itself pays.  int8 is approximate by design and is judged on the
relative RMS energy of its output against the float trunk, at 0.05.  The
families must launch their kernels (the wrappers' launch counts); the
plain versions run only as the references, never in a kernel's place, and
on a machine without a card the tool raises.

    python3 -m codenerf_tpu_torch.tools.gpu_selftest [--families fused_fwd,int8]

Exit code 0 if every requested family passes.
"""

import argparse
import sys
import time
import traceback

import numpy as np

from codenerf_tpu_torch.ops import plain_versions

NOISE_MULT = 1.5
FLOOR = 1e-4
INT8_TOL = 0.05


def _rel_rms(a, b) -> float:
    a = a.detach().double().cpu().reshape(-1)
    b = b.detach().double().cpu().reshape(-1)
    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-12))


def _worst(got, want) -> float:
    return max(_rel_rms(a, b) for a, b in zip(got, want)
               if a is not None and b is not None)


def launch_counts() -> dict:
    from codenerf_tpu_torch.models.quantized import _qdot
    from codenerf_tpu_torch.ops import fused, layer_bwd
    return {"K1": fused.trunk_forward.launches,
            "K2": fused.trunk_backward.launches_recompute,
            "K3": fused.trunk_backward.launches_stored,
            "K4": layer_bwd.linear_relu_bwd.launches,
            "int_mm": _qdot.calls}


class Problem:
    """A bf16 CodeNeRF and its f32 twin (the same weights) on ``device``,
    and seeded inputs: pts [R, S, 3], dir_enc [R, dim_dir], codes."""

    def __init__(self, hidden, R, S, seed, device):
        import torch

        from codenerf_tpu_torch.models import CodeNeRF, CodeNeRFConfig
        # 10 xyz bands reach the high encode bands
        kw = dict(hidden_size=hidden, shape_code_size=64,
                  texture_code_size=64, num_encoding_fn_xyz=10,
                  num_encoding_fn_dir=4)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        self.bf16 = CodeNeRF(CodeNeRFConfig(**kw, compute_dtype="bfloat16"),
                             device, gen)
        self.f32 = CodeNeRF(CodeNeRFConfig(**kw), device)
        self.f32.load_state_dict(self.bf16.state_dict())
        rng = np.random.default_rng(seed)
        cfg = self.bf16.cfg

        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)
        self.pts = t(rng.uniform(-1, 1, size=(R, S, 3)))
        self.dir_enc = t(rng.normal(size=(R, cfg.dim_dir)))
        self.z_s = t(rng.normal(size=(R, cfg.shape_code_size)) * 0.3)
        self.z_t = t(rng.normal(size=(R, cfg.texture_code_size)) * 0.3)
        self.F = cfg.num_encoding_fn_xyz


def check_fused_fwd(args, device):
    import torch

    from codenerf_tpu_torch.ops import fused
    p = Problem(args.hidden, args.rays, args.samples, 0, device)

    def run(model):
        with torch.no_grad():
            return fused.fused_codenerf(model, p.pts, p.dir_enc, p.z_s,
                                        p.z_t, num_freq_xyz=p.F,
                                        log_sampling_xyz=True)
    got = run(p.bf16)
    with plain_versions():
        plain, want = run(p.bf16), run(p.f32)
    return _rel_rms(got, want), _rel_rms(plain, want)


def _grad_family(args, device, hybrid):
    import torch

    from codenerf_tpu_torch.ops import fused
    p = Problem(args.hidden, args.rays, args.samples, 1, device)
    wgt = torch.as_tensor(np.random.default_rng(9).normal(
        size=(args.rays, args.samples, 4)), dtype=torch.float32,
        device=device)

    def grads(model):
        ins = [x.clone().requires_grad_() for x in (p.pts, p.dir_enc,
                                                    p.z_s, p.z_t)]
        raw = fused.train_codenerf(model, *ins, num_freq_xyz=p.F,
                                   log_sampling_xyz=True, hybrid=hybrid)
        leaves = ins + list(model.parameters())
        return torch.autograd.grad((wgt * raw).sum(), leaves,
                                   allow_unused=True)
    got = grads(p.bf16)
    with plain_versions():
        plain, want = grads(p.bf16), grads(p.f32)
    return _worst(got, want), _worst(plain, want)


def check_fused_bwd(args, device):
    return _grad_family(args, device, hybrid=False)


def check_hybrid(args, device):
    return _grad_family(args, device, hybrid=True)


def check_layer_bwd(args, device):
    import torch

    from codenerf_tpu_torch.ops import layer_bwd
    rng = np.random.default_rng(3)
    R, S, K, N = args.rays, args.samples, 128, 128

    def t(a, dt=torch.float32):
        return torch.as_tensor(a, dtype=torch.float32,
                               device=device).to(dt)
    x = t(rng.normal(size=(R, S, K)))
    w = t(rng.normal(size=(K, N)) * 0.2)
    b = t(rng.normal(size=(N,)))
    g = t(rng.normal(size=(R, S, N)))
    y = torch.relu(x @ w + b)
    bf = torch.bfloat16
    xb, yb, gb = x.to(bf), y.to(bf), g.to(bf)
    got = layer_bwd.linear_relu_bwd(xb, w, b, yb, gb, bf)
    plain = layer_bwd.linear_relu_bwd_plain(xb, w, b, yb, gb, bf)
    want = layer_bwd.linear_relu_bwd_plain(x, w, b, y, g)
    return _worst(got, want), _worst(plain, want)


def check_int8(args, device):
    import torch

    from codenerf_tpu_torch.core.encoding import positional_encoding
    from codenerf_tpu_torch.models.quantized import (apply_codenerf_rays_q,
                                                     quantize_codenerf,
                                                     trunk_activation_amax)
    from codenerf_tpu_torch.models.ray_structured import apply_codenerf_rays
    p = Problem(args.hidden, args.rays, args.samples, 2, device)
    cfg = p.f32.cfg
    xyz_enc = positional_encoding(p.pts, cfg.num_encoding_fn_xyz,
                                  cfg.include_input_xyz, True)
    with torch.no_grad():
        amax = trunk_activation_amax(p.f32, cfg, xyz_enc, p.dir_enc, p.z_s,
                                     p.z_t)
        qmodel = quantize_codenerf(p.f32, cfg, amax)
        got = apply_codenerf_rays_q(qmodel, xyz_enc, p.dir_enc, p.z_s, p.z_t)
        want = apply_codenerf_rays(p.f32, xyz_enc, p.dir_enc, p.z_s, p.z_t)
    return _rel_rms(got, want)


# family -> (check, the launch counts that must rise)
FAMILIES = {
    "fused_fwd": (check_fused_fwd, ("K1",)),
    "fused_bwd": (check_fused_bwd, ("K1", "K2")),
    "hybrid": (check_hybrid, ("K3",)),
    "layer_bwd": (check_layer_bwd, ("K4",)),
    "int8": (check_int8, ("int_mm",)),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="comma-separated subset of: %s" % ",".join(FAMILIES))
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64)
    args = ap.parse_args(argv)
    names = [f.strip() for f in args.families.split(",") if f.strip()]
    unknown = [n for n in names if n not in FAMILIES]
    if unknown:
        ap.error(f"unknown families {unknown}; have {list(FAMILIES)}")

    import torch

    from codenerf_tpu_torch.device import resolve_device
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)

    failures, results = [], {}
    for name in names:
        check, kernels = FAMILIES[name]
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            res = check(args, "cuda")
            torch.cuda.synchronize()
        except Exception:  # a build, launch or shape failure fails the family
            print(f"[{name}] ERROR after {time.perf_counter() - t0:.1f}s:\n"
                  f"{traceback.format_exc()}", flush=True)
            failures.append(name)
            continue
        secs = time.perf_counter() - t0
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in kernels}
        launched = all(n > 0 for n in launches.values())
        if name == "int8":
            err, gate = res, INT8_TOL
            detail = f"rel_rms_energy={err:.3e} tol={gate:.0e}"
        else:
            err, noise = res
            gate = max(NOISE_MULT * noise, FLOOR)
            detail = (f"rel_rms={err:.3e} plain_bf16={noise:.3e} "
                      f"gate={gate:.3e}")
        ok = launched and err <= gate
        print(f"[{name}] {detail} launches={launches} "
              f"{'OK' if ok else 'FAIL'} ({secs:.1f}s)", flush=True)
        results[name] = {"err": err, "gate": gate, "launches": launches,
                         "ok": ok}
        if not ok:
            failures.append(name)
    if failures:
        print("SELFTEST FAIL:", ",".join(failures), flush=True)
        return 1
    print("SELFTEST PASS", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
