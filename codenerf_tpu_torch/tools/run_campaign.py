"""The quality campaign from a cold machine: dataset, then training from
scratch, then the category evaluation (the port's counterpart of
``tools/run_campaign.sh``), as three stages of subprocesses:

  1. ``python3 -m codenerf_tpu_torch.tools.make_synth_data``: the seeded
     procedural dataset (50 train objects x 50 views and 8 held-out val
     objects x 10 views at 128 px for the v3 lineage), written into
     ``<dir>.partial`` and renamed when whole, skipped if ``<dir>`` exists;
  2. ``python3 -m codenerf_tpu_torch.train_cli``: the category's YAML with
     the campaign's learning rates (5e-4, codes 5e-3), a checkpoint every
     2000 steps and no validation during training;
  3. ``python3 -m codenerf_tpu_torch.eval_cli --all-objects``: batched TTO
     of every val object in groups of K = 4 with 8 pose restarts and a
     300-step flip rescue.

    python3 -m codenerf_tpu_torch.tools.run_campaign [cars|chairs] [STEPS]
        [DEVICE] [OBJECTS] [--data-root data] [--log-root logs]
        [dotted overrides for both CLIs ...]

Defaults: cars, 10000 steps, cuda, 50 objects (v3; 400 is v4, 2458 v5,
other counts ``o<N>``).  DEVICE=cpu is the cut smoke of the same
pipeline: 64 px, 60 steps, 8 objects, 512 rays and 16 + 16 samples a
step, 50 TTO steps, 2 restarts, a 10-step flip, one round.  The trailing
overrides go to both CLIs after the campaign's own, so they win: on the
card ``runtime.use_pallas=true runtime.pallas_backward=true`` trains and
evaluates through K1 + K2 (the YAML's own runtime is the ray-structured
path).  The generation runs in one process per core, up to 8, split by
object (``--only-stage`` / ``--obj-start`` / ``--obj-end``), which writes
the same files as one process.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# category -> (seed, config, nerf.train.radiance_field_noise_std): chairs
# need the noise against the near-plane density collapse; the recorded v3
# cars run used none (RESULTS.md, the v3 cars headline)
CATEGORIES = {"cars": (7, "configs/srn-cars-code.yml", "0.0"),
              "chairs": (11, "configs/srn-chairs-code.yml", "0.05")}
# training objects -> dataset lineage
LINEAGES = {50: "v3", 400: "v4", 2458: "v5"}
VAL_OBJECTS, VIEWS, VAL_VIEWS = 8, 50, 10
CPU_SMOKE = ("nerf.ray_sampler.num_random_rays=512",
             "nerf.point_sampler.num_coarse=16",
             "nerf.point_sampler.num_fine=16",
             "experiment.val_iterations=50")


def plan(category="cars", steps=10000, device="cuda", objects=50,
         data_root="data", log_root="logs", overrides=(), jobs=1) -> dict:
    """The campaign's paths and the command lines of its three stages:
    {"data", "logdir", "id", "generate": [argv, ...], "train": argv,
    "eval": argv}."""
    if category not in CATEGORIES:
        raise ValueError(f"unknown category: {category}")
    seed, cfg, noise = CATEGORIES[category]
    ver = LINEAGES.get(objects, f"o{objects}")
    data = Path(data_root) / f"synth{ver}_{category}"
    logs = Path(log_root)
    run_id = f"flagship-{ver}-{category}"
    size, smoke = 128, ()
    restarts, k, flip_steps, rounds = 8, 4, 300, ()
    if device.split(":")[0] == "cpu":
        size, steps, objects, smoke = 64, 60, 8, CPU_SMOKE
        # the category stays the last underscore token: SRNDataset takes
        # the on-disk name from it
        data = Path(data_root) / f"smoke_synthv3_{category}"
        logs = Path(log_root) / "campaign_smoke"
        restarts, k, flip_steps, rounds = 2, 8, 10, ("--rounds", "1")
    py = sys.executable
    partial = f"{data}.partial"
    gen = [py, "-m", "codenerf_tpu_torch.tools.make_synth_data", "--out",
           partial, "--name", category, "--style", "proc", "--objects",
           str(objects), "--val-objects", str(VAL_OBJECTS), "--views",
           str(VIEWS), "--val-views", str(VAL_VIEWS), "--size", str(size),
           "--seed", str(seed)]
    if jobs > 1:
        bounds = [objects * j // jobs for j in range(jobs + 1)]
        generate = [gen + ["--only-stage", "train", "--obj-start", str(a),
                           "--obj-end", str(b)]
                    for a, b in zip(bounds, bounds[1:]) if b > a]
        generate.append(gen + ["--only-stage", "val"])
    else:
        generate = [gen]
    common = [f"dataset.basedir={data}", f"experiment.logdir={logs}"]
    train = [py, "-m", "codenerf_tpu_torch.train_cli", "-c", cfg,
             "--max-steps", str(steps), "--device", device, *smoke,
             f"nerf.train.radiance_field_noise_std={noise}", *common,
             f"experiment.id={run_id}", "experiment.save_every=2000",
             "experiment.validate_every=1000000", "optimizer.lr=5e-4",
             "optimizer.embedding_lr=5e-3", *overrides]
    evaluate = [py, "-m", "codenerf_tpu_torch.eval_cli", "-c", cfg,
                "--device", device, *rounds, "--load-checkpoint",
                str(logs / run_id / "checkpoints"), "--all-objects",
                "--batch-objects", str(k), *smoke, *common,
                f"optimizer.pose_restarts={restarts}",
                f"optimizer.pose_flip_steps={flip_steps}", *overrides]
    return {"data": data, "logdir": logs, "id": run_id,
            "generate": generate, "train": train, "eval": evaluate}


def train_summary(metrics_path, window: int = 1000) -> dict:
    """From the train log's ``metrics.jsonl``: the mean logged train PSNR
    of each ``window`` steps (steps in (k * window, (k + 1) * window]) and
    the median ms per step (each record's ``time_taken`` over the steps
    since the previous record)."""
    import json
    import statistics
    rows = [json.loads(ln) for ln in Path(metrics_path).read_text(
        ).splitlines() if ln.strip()]
    train = [r for r in rows if r.get("mode") == "train"]
    windows = {}
    for r in train:
        k = (r["step"] - 1) // window
        windows.setdefault(k, []).append(r["psnr"])
    ms = [1e3 * b["time_taken"] / (b["step"] - a["step"])
          for a, b in zip(train, train[1:])]
    return {"psnr": {f"{k * window + 1}-{(k + 1) * window}":
                     statistics.fmean(v) for k, v in sorted(windows.items())},
            "ms_per_step": statistics.median(ms) if ms else None}


def _run(argvs: list) -> None:
    """Start every command of ``argvs`` together; raise if any fails."""
    procs = [subprocess.Popen(a, cwd=ROOT) for a in argvs]
    codes = [p.wait() for p in procs]
    bad = [(a, c) for a, c in zip(argvs, codes) if c != 0]
    if bad:
        raise RuntimeError(f"{len(bad)} command(s) failed: {bad[0][0]} "
                           f"exited {bad[0][1]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("category", nargs="?", default="cars",
                    choices=sorted(CATEGORIES))
    ap.add_argument("steps", nargs="?", type=int, default=10000)
    ap.add_argument("device", nargs="?", default="cuda")
    ap.add_argument("objects", nargs="?", type=int, default=50)
    ap.add_argument("--data-root", default="data")
    ap.add_argument("--log-root", default="logs")
    args, overrides = ap.parse_known_args(argv)
    bad = [o for o in overrides if o.startswith("-") or "=" not in o]
    if bad:
        ap.error(f"unrecognized arguments: {' '.join(bad)}")
    if args.device.split(":")[0] == "cuda":
        from codenerf_tpu_torch.device import resolve_device
        resolve_device(args.device)
    p = plan(args.category, args.steps, args.device, args.objects,
             args.data_root, args.log_root, overrides,
             jobs=min(8, os.cpu_count() or 1))
    walls = {}
    t0 = time.perf_counter()
    if not (ROOT / p["data"]).is_dir():
        partial = ROOT / f"{p['data']}.partial"
        shutil.rmtree(partial, ignore_errors=True)
        _run(p["generate"])
        os.replace(partial, ROOT / p["data"])
    walls["data_s"] = time.perf_counter() - t0
    print(f"campaign: data {p['data']} ready in {walls['data_s']:.1f} s",
          flush=True)
    for stage in ("train", "eval"):
        t0 = time.perf_counter()
        _run([p[stage]])
        walls[f"{stage}_s"] = time.perf_counter() - t0
        print(f"campaign: {stage} done in {walls[f'{stage}_s']:.1f} s",
              flush=True)
    summary = train_summary(ROOT / p["logdir"] / p["id"] / "metrics.jsonl")
    print("campaign: mean train PSNR by window: " + ", ".join(
        f"{k} {v:.4f}" for k, v in summary["psnr"].items())
        + f"; median {summary['ms_per_step']} ms a step", flush=True)
    print(f"campaign: {p['id']} in {sum(walls.values()):.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in walls.items())}); "
          f"logs in {p['logdir'] / p['id']}", flush=True)
    return {**walls, **summary}


if __name__ == "__main__":
    main()
