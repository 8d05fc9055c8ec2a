"""The port's spans (``codenerf_tpu_torch/utils/trace.py``) read against a
traced slice's device timeline.

Input: the events of a ``torch.profiler`` Chrome trace (CUDA activity,
with the runtime and driver calls CUPTI records beside it) and the
slice's spans as ``program_span`` events on the same clock
(``trace.chrome_events``).  Rules:

- a moment of the step belongs to the innermost span that the step's
  thread (the thread of the root spans) had open then; judged by time,
  not by thread, so the kernels that autograd launches from its own
  thread during ``train.backward`` are the backward's;
- calls on the loader's worker thread (the thread of the ``loader.load``
  and ``loader.ship`` spans) are the loader's, never a step's.  CUPTI
  names a runtime call's thread by the low 32 bits of its
  ``pthread_self`` (a span's ``args.ident``) read as a signed number, and
  the trace writes its magnitude (seen on an H100 with torch 2.11: a
  thread whose ident ends ``0xdbfff6c0`` has its calls under
  ``0x24000940``); a trace that names it by the native id, the span's
  ``tid``, is read as well;
- an idle gap of the device is named ``<innermost span>:<CUDA call the
  host was in, or host>``, or as ``profiling.summarize`` names it when
  no span was open.

``anchor_offset_us`` checks the two clocks against each other: a span
the benchmark opens around the slice's closing ``torch.cuda.synchronize``
against the ``cudaDeviceSynchronize`` that CUPTI recorded for it.
"""

from __future__ import annotations

import bisect

from benchmark.profiling import DEVICE_CATS, HOST_CATS, _merge

ROOTS = {"train": "train.step", "tto": "tto.step"}
LOADER = ("loader.load", "loader.ship")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
ANCHOR = "bench.anchor"
OUTSIDE = "outside spans"


def program_spans(events: list) -> list:
    return [e for e in events if e.get("cat") == "program_span"]


def shift(events: list, offset_us: float) -> None:
    """Move every ``program_span`` event by ``offset_us``, in place."""
    for e in program_spans(events):
        e["ts"] += offset_us


class Timeline:
    """The innermost of ``spans`` (properly nested, one thread) open at
    each moment."""

    def __init__(self, spans: list):
        bounds = sorted([(s["ts"] + s["dur"], 0, i) for i, s in
                         enumerate(spans)]
                        + [(s["ts"], 1, i) for i, s in enumerate(spans)])
        self.times, self.names = [], []
        stack = []
        for t, is_start, i in bounds:
            if is_start:
                stack.append(i)
            else:
                stack.remove(i)
            name = spans[stack[-1]]["name"] if stack else None
            if self.times and self.times[-1] == t:
                self.names[-1] = name
            else:
                self.times.append(t)
                self.names.append(name)

    def at(self, t: float):
        i = bisect.bisect_right(self.times, t) - 1
        return self.names[i] if i >= 0 else None

    def split(self, a: float, b: float):
        """(innermost span or None, microseconds) over [a, b)."""
        i = bisect.bisect_right(self.times, a) - 1
        t = a
        while t < b:
            name = self.names[i] if i >= 0 else None
            nxt = self.times[i + 1] if i + 1 < len(self.times) else b
            end = min(nxt, b)
            if end > t:
                yield name, end - t
            t, i = end, i + 1


def thread_ids(span: dict) -> set:
    """The ids a trace may give the calls of ``span``'s thread: its native
    id and the magnitude of its ident's low 32 bits as a signed number."""
    low = span.get("args", {}).get("ident", span["tid"]) & 0xFFFFFFFF
    return {span["tid"], (1 << 32) - low if low >= 1 << 31 else low}


def _calls(events: list) -> list:
    return sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"], e.get("tid"))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS),
                  key=lambda c: c[0])


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def read(events: list, kind: str, top: int = 10) -> dict:
    """The step's readings from the spans of one slice: per step its
    launches, host syncs and host issue time (the root's duration less
    its ``loader.wait`` and its synchronising calls), the loader's queue
    wait (train), where the syncs sit, idle time by span and the longest
    idle gaps named.  {} without a root span of ``kind``."""
    spans = program_spans(events)
    roots = sorted((s for s in spans if s["name"] == ROOTS[kind]),
                   key=lambda s: s["ts"])
    if not roots:
        return {}
    step_tid = roots[0]["tid"]
    loader = set().union(*(thread_ids(s) for s in spans
                           if s["name"] in LOADER))
    own = [s for s in spans if s["tid"] == step_tid
           and s["name"] != ANCHOR]
    timeline = Timeline(own)
    calls = [c for c in _calls(events) if c[3] not in loader]
    starts = [c[0] for c in calls]
    waits = [(s["ts"], s["ts"] + s["dur"]) for s in own
             if s["name"] == "loader.wait"]
    launches = syncs = 0
    issue_us = 0.0
    for r in roots:
        a, b = r["ts"], r["ts"] + r["dur"]
        inside = calls[bisect.bisect_left(starts, a):
                       bisect.bisect_left(starts, b)]
        launches += sum(c[2].startswith(LAUNCHES) for c in inside)
        held = [c for c in inside if c[2] in SYNCS]
        syncs += len(held)
        issue_us += (b - a
                     - sum(_overlap(a, b, c[0], c[1]) for c in held)
                     - sum(_overlap(a, b, w0, w1) for w0, w1 in waits))
    n = len(roots)
    first, last = roots[0]["ts"], roots[-1]["ts"] + roots[-1]["dur"]
    sync_spans = {}
    for c in calls:
        if c[2] in SYNCS and first <= c[0] < last:
            key = f"{timeline.at(c[0]) or OUTSIDE}:{c[2]}"
            sync_spans[key] = sync_spans.get(key, 0) + 1
    out = {f"launches.{kind}": launches / n,
           f"host_syncs.{kind}": syncs / n,
           f"host_issue_ms.{kind}": issue_us / n / 1e3,
           "steps": n, "syncs_by_span": sync_spans}
    if kind == "train":
        out["loader_queue_wait_ms.train"] = sum(
            w1 - w0 for w0, w1 in waits) / n / 1e3
    out.update(idle(events, timeline, top))
    return out


def idle(events: list, timeline: Timeline, top: int = 10) -> dict:
    """The device's idle gaps split by the innermost span open on the
    step's thread (ms, and the share of all idle time), and the ``top``
    longest gaps named ``<span>:<call or host>``."""
    device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("ph") == "X" and "dur" in e
              and e.get("cat") in DEVICE_CATS]
    merged = _merge(device)
    host = [c[:3] for c in _calls(events)]
    by_span, total = {}, 0.0
    gaps = []
    for (_, g0), (g1, _) in zip(merged, merged[1:]):
        gaps.append((g1 - g0, g0))
        for name, us in timeline.split(g0, g1):
            key = name or OUTSIDE
            by_span[key] = by_span.get(key, 0.0) + us
            total += us

    def during(t):
        inner = [h for h in host if h[0] <= t < h[1]]
        call = max(inner)[2] if inner else "host"
        name = timeline.at(t)
        return f"{name}:{call}" if name else call

    gaps.sort(reverse=True)
    return {"idle_ms_by_span": {k: v / 1e3 for k, v in sorted(
                by_span.items(), key=lambda kv: -kv[1])},
            "idle_share_by_span": {k: v / total for k, v in sorted(
                by_span.items(), key=lambda kv: -kv[1])} if total else {},
            "idle_gaps": [[during(t), g * 1e-6] for g, t in gaps[:top]]}


def anchor_offset_us(events: list):
    """How far the device trace's clock runs ahead of the spans', in
    microseconds: the centre of the ``cudaDeviceSynchronize`` call that
    overlaps the last ``bench.anchor`` span most, less the span's centre.
    None without both."""
    anchors = [s for s in program_spans(events) if s["name"] == ANCHOR]
    if not anchors:
        return None
    a = max(anchors, key=lambda s: s["ts"])
    a0, a1 = a["ts"], a["ts"] + a["dur"]
    calls = [c for c in _calls(events) if c[2] == "cudaDeviceSynchronize"]
    if not calls:
        return None
    c0, c1, _, _ = max(calls, key=lambda c: (_overlap(a0, a1, c[0], c[1]),
                                             -abs(c[0] - a0)))
    return ((c0 + c1) - (a0 + a1)) / 2
