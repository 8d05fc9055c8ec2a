"""Readings that set a cell's correctness limits, on the chip at the
cell's own size, in one process:

  * the program's numbers on each of ``--seeds`` (sound runs: the lower
    readings);
  * the control's: the plain reference in float8 products put in
    the program's place, on each of ``--control-seeds``;
  * each fault of ``--faults`` (``faults.py``) planted in the program,
    on each of ``--fault-seeds``.

    python3 benchmark/calibrate.py --workload cars-train --seeds 100-111 \\
        --control-seeds 200-202 --fault-seeds 300-302 --faults half,altered

Writes one JSON line per reading to ``--out`` and prints a summary: per
number, the largest sound reading and the smallest of the control and
of each fault.  The benchmark's own runs never run this.
"""

import time

LAUNCHED = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def seed_list(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from benchmark import cells, compare, drive
    cell = cells.cell(cells.load(ROOT), args.workload)
    rows = []

    def emit(kind, seed, nums, readings, extra=None):
        row = {"workload": args.workload, "kind": kind, "seed": seed,
               **nums, **(extra or {})}
        rows.append(row)
        low, ref = readings.values()
        worst = {k: sorted(v.items(), key=lambda kv: -kv[1])[:3]
                 for k, v in compare.leaf_gaps(low, ref).items()}
        row["elem_gaps"] = compare.elem_gaps(low["grad_vec"],
                                             ref["grad_vec"])
        print(json.dumps({**row, "worst_leaves": worst}), flush=True)
        if args.out:
            kept = {k: {n: v for n, v in r.items() if n != "grad_vec"}
                    for k, r in readings.items()}
            with open(args.out, "a") as f:
                f.write(json.dumps({**row, "readings": kept}) + "\n")

    seeds = seed_list(args.seeds)
    if seeds:
        t = time.monotonic()
        for s, r in zip(seeds, drive.run_seeds(cell, seeds, None, False,
                                                LAUNCHED)):
            emit("program", s, r["numbers"], r["readings"],
                 {"peak": r["peak"]})
        print(f"program: {len(seeds)} seeds in {time.monotonic() - t:.1f} s",
              flush=True)
    for s in seed_list(args.control_seeds):
        t = time.monotonic()
        nums, readings = drive.control_numbers(cell, s)
        emit("control", s, nums, readings,
             {"seconds": time.monotonic() - t})
    fault_seeds = seed_list(args.fault_seeds)
    for fault in filter(None, args.faults.split(",")):
        for s, r in zip(fault_seeds, drive.run_seeds(
                cell, fault_seeds, None, False, LAUNCHED, fault)):
            emit(fault, s, r["numbers"], r["readings"])
    summary = {}
    for name in compare.NAMES:
        by_kind = {}
        for r in rows:
            by_kind.setdefault(r["kind"], []).append(r[name])
        summary[name] = {k: (max(v) if k == "program" else min(v))
                         for k, v in by_kind.items()}
    print("summary " + json.dumps({"workload": args.workload, **summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
