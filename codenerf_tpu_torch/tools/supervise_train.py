"""A training supervisor that restarts a stalled run (the port's counterpart
of ``tools/supervise_train.py``).

  1. the steps left are the target less the newest checkpoint's step
     (``train_cli --max-steps`` counts the steps of one run), read from
     the ``<step>.ckpt`` files of ``--checkpoint-dir``;
  2. ``python3 -m codenerf_tpu_torch.train_cli --max-steps <left> ...``
     runs with its output appended to ``--log``, whose mtime is the
     liveness signal;
  3. if the log stays silent for ``--stall-seconds``, the exact child is
     sent SIGTERM (the train loop saves a checkpoint and exits), then
     after ``--grace-seconds`` its process group SIGKILL, and the run is
     relaunched from 1;
  4. the supervisor exits 0 once the newest checkpoint reaches the target,
     1 when ``--max-restarts`` relaunches did not get there.

    python3 -m codenerf_tpu_torch.tools.supervise_train --target-steps 10000 \\
        --checkpoint-dir logs/flagship-v3-cars/checkpoints \\
        --log logs/train_v3.log [--stall-seconds 300] \\
        -- -c configs/srn-cars-code.yml dataset.basedir=... ...

Everything after ``--`` goes to ``train_cli`` as given; the supervisor
owns ``--max-steps``.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def latest_step(ckpt_dir) -> int:
    """The newest checkpoint's step in ``ckpt_dir`` (0 if none)."""
    from codenerf_tpu_torch.train.checkpoint import latest_step as newest
    return newest(ckpt_dir) or 0


def train_command(remaining: int, train_args) -> list:
    return [sys.executable, "-m", "codenerf_tpu_torch.train_cli",
            "--max-steps", str(remaining), *train_args]


def _stop(proc: subprocess.Popen, grace: float) -> None:
    """SIGTERM the child, then SIGKILL its process group after ``grace``
    seconds."""
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def supervise(target: int, ckpt_dir, log, command, stall: float = 300.0,
              grace: float = 30.0, max_restarts: int = 10,
              poll: float = 30.0, restart_delay: float = 5.0) -> int:
    """Run ``command(remaining)`` (an argv) until the newest checkpoint in
    ``ckpt_dir`` reaches ``target``, killing and relaunching it whenever
    ``log`` stays silent for ``stall`` seconds; returns the exit code."""
    ckpt_dir, log = Path(ckpt_dir), Path(log)
    restarts = 0
    while True:
        done = latest_step(ckpt_dir)
        remaining = target - done
        if remaining <= 0:
            print(f"supervise_train: target {target} reached (checkpoint "
                  f"{done})", flush=True)
            return 0
        cmd = command(remaining)
        print(f"supervise_train: launching from checkpoint {done}, "
              f"{remaining} steps to go: {' '.join(cmd)}", flush=True)
        with open(log, "ab") as sink:
            proc = subprocess.Popen(cmd, cwd=ROOT, stdout=sink,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        started = time.time()
        stalled = False
        while True:
            try:
                proc.wait(timeout=poll)
                break
            except subprocess.TimeoutExpired:
                pass
            try:
                last = max(log.stat().st_mtime, started)
            except OSError:
                last = started
            silent = time.time() - last
            if silent > stall:
                print(f"supervise_train: log silent {silent:.0f} s > "
                      f"{stall:.0f} s; stopping pid {proc.pid}", flush=True)
                stalled = True
                _stop(proc, grace)
                break
        final = latest_step(ckpt_dir)
        if final >= target:
            print(f"supervise_train: complete at checkpoint {final}",
                  flush=True)
            return 0
        if proc.returncode == 0 and not stalled:
            print(f"supervise_train: train exited 0 at checkpoint {final} "
                  f"< target {target}; relaunching", flush=True)
        restarts += 1
        if restarts > max_restarts:
            print("supervise_train: restart budget exhausted", flush=True)
            return 1
        time.sleep(restart_delay)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target-steps", type=int, required=True,
                    help="absolute step count to reach (not steps-this-run)")
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--log", required=True,
                    help="train output sink; its mtime is the liveness "
                         "signal")
    ap.add_argument("--stall-seconds", type=float, default=300.0)
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--grace-seconds", type=float, default=30.0,
                    help="SIGTERM -> SIGKILL grace (lets a live process "
                         "finish its step and save)")
    ap.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="-- then train_cli arguments (without --max-steps)")
    args = ap.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    if "--max-steps" in train_args:
        ap.error("the supervisor owns --max-steps")
    return supervise(args.target_steps, args.checkpoint_dir, args.log,
                     lambda remaining: train_command(remaining, train_args),
                     stall=args.stall_seconds, grace=args.grace_seconds,
                     max_restarts=args.max_restarts)


if __name__ == "__main__":
    sys.exit(main())
