"""The traced slice: ``torch.profiler`` over a few steady steps, its
Chrome trace written under the run's TMPDIR, read back and deleted.

Only the device is traced (CUDA activity, with the CUDA runtime calls
CUPTI records beside it): tracing every host operator as well slowed a
flagship step by a fifth on the H100 and read that host time as idle.
From the trace's own timeline: the union of the device's activity
(kernels, copies, sets) is the busy time; the gaps between them are the
idle time, each named by the CUDA call the host was in when it began
("host" when none); kernel time is summed by name.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, window_s: float, top: int = 10) -> dict:
    """Busy seconds, kernel seconds by name and the breakdown from Chrome
    trace events (``ts`` and ``dur`` in microseconds)."""
    device, host, kernels = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            device.append((s, s + d))
            if e["cat"] == "kernel":
                kernels[e["name"]] = kernels.get(e["name"], 0.0) + d * 1e-6
        elif e.get("cat") in HOST_CATS:
            host.append((s, s + d, e["name"]))
    merged = _merge(device)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:top]

    def during(t):
        inner = [h for h in host if h[0] <= t < h[1]]
        return max(inner)[2] if inner else "host"

    return {"busy_s": busy, "window_s": window_s, "kernel_s": kernels,
            "breakdown": {
                "device_ops": [[k[:120], v] for k, v in sorted(
                    kernels.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[during(t), g * 1e-6] for g, t in gaps]}}


def traced(run_step, min_steps: int, seconds: float, device) -> dict:
    """Run ``run_step()`` under the profiler until ``seconds`` have passed
    and at least ``min_steps`` steps ran; the summary of the trace, with
    the steps and the slice's wall time (host clock, between two
    synchronisations)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        steps = 0
        while steps < min_steps or time.monotonic() - t0 < seconds:
            run_step()
            steps += 1
        torch.cuda.synchronize(device)
        wall = time.monotonic() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = summarize(events, wall)
    out["steps"] = steps
    return out
