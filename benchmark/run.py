"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared beside its
limit, which also close standard error.  Exits non-zero, printing no
result, without as many CUDA cards as the cell asks for, or if JAX or
the JAX package (``codenerf_tpu``) was loaded.
"""

import time

LAUNCHED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, leads the import path
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import cells, drive
    cell = cells.cell(cells.load(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = drive.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         LAUNCHED)
    found = drive.forbidden_modules()
    if found:
        print(f"loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    out = drive.result(cell, run, bool(args.trace))
    print(f"card: {drive.card_line()}", file=sys.stderr)
    print("set-up, seconds from launch at the end of each phase: "
          + json.dumps(run["setup_phases"]), file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
