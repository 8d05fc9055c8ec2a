"""The port's spans against the device trace, in one cell.

    python3 benchmark/span_probe.py --workload <cell> --seed <n>
        [--slices 4] [--out <dir>]

Builds the cell's program as a benchmark run does (``drive.Program``)
with the spans on from the start, so that ``setup.state`` is caught,
drives it through the checked first steps and one short traced slice
that warms the profiler up, then runs ``--slices`` traced slices of the
cell's ``trace_seconds`` each (``torch.profiler``, CUDA activity only,
as ``profiling.traced``), with the spans on, off, off, on, and so on.  Each slice gives the benchmark's
existing per-layer metrics through their committed readers, its ms per
step and idle share; a slice with spans on also gives what
``spans.read`` reads from them and the clock offset between the spans
and the device trace, measured on the slice's closing synchronisation
(printed on standard error; the spans are shifted by it above 50 us).
Last, two steps under ``torch.cuda.set_sync_debug_mode("warn")`` name
the lines of code that synchronise the host with the card, and the host
cost of one span, off and on, is timed alone (``span_ns``).  Prints one
JSON line; ``--out`` keeps the first traced slice with spans on there as
``<cell>.trace.json.gz``.

The benchmark's own runs (``run.py``) never turn the spans on; this
script is how their per-layer readings are taken until its harness reads
them.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # the checkout's root, not this folder, leads the import path
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import cells, drive, profiling, spans, workload  # noqa: E402
from codenerf_tpu_torch.utils import trace  # noqa: E402

ALIGN_US = 50.0


def _events(prof) -> dict:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="span_probe_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def traced_slice(prog, cell: dict, spans_on: bool, device,
                 seconds: float) -> tuple:
    """One traced slice of at least 2 steps and ``seconds``: (readings,
    the trace with the spans merged in)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    sp = prog.sp
    prog.loader_wait_s = 0.0
    drive._sync(device)
    if spans_on:
        trace.enable()
    with profile(activities=[activity]) as prof:
        t0 = time.monotonic()
        steps = 0
        while steps < 2 or time.monotonic() - t0 < seconds:
            prog.step()
            steps += 1
        with trace.span(spans.ANCHOR):
            drive._sync(device)
        wall = time.monotonic() - t0
    trace.disable()
    recorded = trace.drain()
    doc = _events(prof)
    events = doc["traceEvents"]
    summary = profiling.summarize(events, wall)
    readings = drive.Readings(sp["kind"], workload.shapes(sp), steps, wall,
                              summary["busy_s"], summary["kernel_s"],
                              prog.loader_wait_s)
    out = {"spans": spans_on, "steps": steps, "window_s": wall,
           "ms_per_step": wall / steps * 1e3,
           "busy_ms_per_step": summary["busy_s"] / steps * 1e3,
           "idle_share": (1 - summary["busy_s"] / wall) * 100,
           "existing": {m["name"]: cells.reader(cell, m["name"])(readings)
                        for m in cell["per_layer"]},
           "breakdown": summary["breakdown"]}
    if spans_on:
        events += trace.chrome_events(recorded, doc["baseTimeNanoseconds"],
                                      os.getpid())
        offset = spans.anchor_offset_us(events)
        out["clock_offset_us"] = offset
        if offset is not None:
            print(f"{cell['name']}: device trace - spans = {offset:.1f} us",
                  file=sys.stderr)
            if abs(offset) > ALIGN_US:
                spans.shift(events, offset)
                out["clock_offset_after_us"] = spans.anchor_offset_us(events)
        out.update(spans.read(events, sp["kind"]))
        out["threads"] = threads(events)
    return out, doc


def threads(events: list) -> list:
    """Each thread that recorded spans: its ids (``spans.thread_ids``),
    its spans' prefixes and how many CUDA runtime calls the trace gives
    under those ids: the check that the loader's rule finds its calls."""
    calls = collections.Counter(e.get("tid") for e in events
                                if e.get("cat") in profiling.HOST_CATS)
    out = {}
    for s in spans.program_spans(events):
        t = out.setdefault(s["tid"], {"ids": spans.thread_ids(s),
                                      "spans": set()})
        t["spans"].add(s["name"].split(".")[0])
    return [{"ids": sorted(t["ids"]), "spans": sorted(t["spans"]),
             "calls": sum(calls[i] for i in t["ids"])}
            for t in out.values()]


def sync_sites(prog, device, steps: int = 2) -> dict:
    """{the innermost frames of this checkout's code, innermost first:
    count} of the synchronising operations PyTorch flags over ``steps``
    steps."""
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if str(ROOT) in f.filename]
        if all(Path(f.filename).resolve() == Path(__file__).resolve()
               for f in frames):
            return          # this script's own calls, not a step's
        sites[" <- ".join(f"{Path(f.filename).relative_to(ROOT)}:{f.lineno}"
                          for f in reversed(frames[-4:]))] += 1

    drive._sync(device)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                prog.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    drive._sync(device)
    return {k: v / steps for k, v in sites.most_common()}


def span_ns(n: int = 100_000) -> dict:
    """Host nanoseconds of one ``with trace.span(...)`` block, tracing off
    and on."""
    out = {}
    for on in (False, True):
        if on:
            trace.enable()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with trace.span("bench.cost"):
                pass
        out["on" if on else "off"] = (time.perf_counter_ns() - t0) / n
        trace.disable()
        trace.drain()
    return out


def probe(cell: dict, seed: int, slices: int, out_dir=None) -> dict:
    device = torch.device(cell.get("device", "cuda:0"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    sp = workload.spec(cell)
    trace.enable()
    t0 = time.monotonic()
    prog = drive.Program(cell, sp, seed, device)
    prog.first_steps(sp["check_steps"])
    drive._sync(device)
    setup_s = time.monotonic() - t0
    trace.disable()
    setup = trace.drain()
    result = {"workload": cell["name"], "seed": seed,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "setup_s": setup_s,
              "setup_state_s": sum((s.end_ns - s.start_ns) for s in setup
                                   if s.name == "setup.state") / 1e9,
              "slices": []}
    seconds = cell["traffic_file"]["trace_seconds"]
    try:
        traced_slice(prog, cell, False, device, 0.0)
        for i in range(slices):
            out, doc = traced_slice(prog, cell, i % 4 in (0, 3), device,
                                    seconds)
            result["slices"].append(out)
            if out_dir is not None and i == 0:
                path = Path(out_dir) / f"{cell['name']}.trace.json.gz"
                path.parent.mkdir(parents=True, exist_ok=True)
                with gzip.open(path, "wt") as f:
                    json.dump(doc, f)
        if device.type == "cuda":
            result["sync_sites_per_step"] = sync_sites(prog, device)
        result["span_ns"] = span_ns()
    finally:
        prog.close()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = cells.cell(cells.load(ROOT), args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 3
    result = probe(cell, args.seed, args.slices, args.out)
    print(f"card: {drive.card_line()}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
