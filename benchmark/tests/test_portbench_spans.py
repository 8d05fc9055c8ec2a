"""``spans.py`` on a small synthetic Chrome trace with the port's spans:
launches, host syncs, host issue time and the loader's wait per step;
the thread rule for autograd's and the loader's threads; idle gaps named
by span; the clock anchor; nothing read outside the trace's kind.  And
``span_probe.py`` through a tiny cell on the CPU."""

import copy

import pytest

from benchmark import span_probe, spans
from benchmark.tests.conftest import tiny_cell

STEP, AUTOGRAD, LOADER = 1, 2, 3
# the loader thread's pthread_self; its calls appear under the magnitude
# of its low 32 bits read as a signed number
LOADER_IDENT = 0x7F52_9C21_D640


def _span(name, t0, t1, tid=STEP, step=None, ident=None):
    ident = ident or (LOADER_IDENT if tid == LOADER
                      else 0x7F52_0000_0000 + tid)
    return {"ph": "X", "cat": "program_span", "name": name, "pid": 0,
            "tid": tid, "ts": t0, "dur": t1 - t0,
            "args": {"step": step, "ident": ident}}


def _call(name, t0, t1, tid=STEP):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 0,
            "tid": tid, "ts": t0, "dur": t1 - t0}


def _kernel(t0, t1):
    return {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
            "ts": t0, "dur": t1 - t0}


def trace_events(loader_calls=LOADER, loader_ident=LOADER_IDENT):
    """Two train steps (us): step 0 [0, 100), the loader's wait [100, 105)
    and a harness sync [106, 108) between, step 1 [110, 210), then the
    slice's closing synchronisation in the anchor [215, 240).  The
    loader's calls carry ``loader_calls`` as their thread."""
    return [
        _span("train.step", 0, 100, step=0),
        _span("train.rays", 0, 10, step=0),
        _span("train.forward", 10, 40, step=0),
        _span("train.backward", 40, 70, step=0),
        _span("train.optimizer", 70, 95, step=0),
        _span("loader.wait", 100, 105),
        _span("train.step", 110, 210, step=1),
        _span("train.forward", 110, 150, step=1),
        _span("train.backward", 150, 180, step=1),
        _span("train.optimizer", 180, 205, step=1),
        _span("loader.load", 20, 60, tid=LOADER, ident=loader_ident),
        _span("loader.ship", 60, 65, tid=LOADER, ident=loader_ident),
        _span(spans.ANCHOR, 215, 240),
        _call("cudaLaunchKernel", 12, 14), _call("cudaLaunchKernel", 20, 22),
        _call("cudaLaunchKernel", 30, 32),
        _call("cudaLaunchKernel", 45, 47, AUTOGRAD),
        _call("cudaLaunchKernel", 50, 52, AUTOGRAD),
        _call("cudaStreamSynchronize", 75, 90),
        _call("cudaMemcpyAsync", 61, 62, loader_calls),
        _call("cudaLaunchKernel", 62, 63, loader_calls),
        _call("cudaStreamSynchronize", 63, 64, loader_calls),
        _call("cudaStreamSynchronize", 106, 108),
        _call("cudaLaunchKernel", 115, 117), _call("cudaLaunchKernel", 120, 122),
        _call("cudaLaunchKernelExC", 155, 157, AUTOGRAD),
        _call("cudaStreamSynchronize", 185, 200),
        _call("cudaDeviceSynchronize", 220, 236),
        _kernel(14, 30), _kernel(32, 44), _kernel(52, 80), _kernel(90, 100),
        _kernel(118, 140), _kernel(160, 170), _kernel(200, 205),
        _kernel(212, 214), _kernel(234, 235),
    ]


@pytest.mark.parametrize("loader_calls", [
    (1 << 32) - (LOADER_IDENT & 0xFFFFFFFF), 0x2400_0940, LOADER],
    ids=["cupti-high-bit", "cupti", "native"])
def test_counts_per_step_and_the_thread_rule(loader_calls):
    ident = (0x7F52_2400_0940 if loader_calls == 0x2400_0940
             else LOADER_IDENT)
    got = spans.read(trace_events(loader_calls, ident), "train")
    assert got["steps"] == 2
    # 3 + 2 of autograd's thread, then 2 + 1; the loader's launch and the
    # harness's calls between the steps are not a step's
    assert got["launches.train"] == 4.0
    assert got["host_syncs.train"] == 1.0
    # 100 us a step less its 15 us in cudaStreamSynchronize
    assert got["host_issue_ms.train"] == pytest.approx(0.085)
    assert got["loader_queue_wait_ms.train"] == pytest.approx(0.0025)
    assert got["syncs_by_span"] == {
        "train.optimizer:cudaStreamSynchronize": 2,
        "outside spans:cudaStreamSynchronize": 1}


def test_idle_gaps_named_by_span():
    events = trace_events()
    got = spans.read(events, "train")
    names = dict((name, s * 1e6) for name, s in got["idle_gaps"])
    assert names["train.optimizer:cudaStreamSynchronize"] == pytest.approx(
        10)
    assert names["loader.wait:host"] == pytest.approx(18)   # [100, 118)
    assert names["train.step:host"] == pytest.approx(7)     # [205, 212)
    assert names["host"] == pytest.approx(20)               # [214, 234)
    assert names["train.forward:cudaLaunchKernel"] == pytest.approx(2)
    # every gap, split where the innermost span changes
    ms = got["idle_ms_by_span"]
    assert ms["loader.wait"] == pytest.approx(0.005)
    assert ms["train.forward"] == pytest.approx((2 + 8 + 10) / 1e3)
    assert ms["train.backward"] == pytest.approx((8 + 10 + 10) / 1e3)
    assert ms["outside spans"] == pytest.approx((5 + 2 + 20) / 1e3)
    assert sum(ms.values()) == pytest.approx(
        (2 + 8 + 10 + 18 + 20 + 30 + 7 + 20) / 1e3)
    assert sum(got["idle_share_by_span"].values()) == pytest.approx(1)


def test_nothing_read_outside_its_kind():
    assert spans.read(trace_events(), "tto") == {}
    tto = [dict(e, name=e["name"].replace("train.", "tto."))
           for e in trace_events()]
    got = spans.read(tto, "tto")
    assert got["launches.tto"] == 4.0 and got["host_syncs.tto"] == 1.0
    assert "loader_queue_wait_ms.train" not in got
    assert spans.read([e for e in trace_events()
                       if e["cat"] != "program_span"], "train") == {}


def test_anchor_offset_and_shift():
    events = trace_events()
    assert spans.anchor_offset_us(events) == pytest.approx(0.5)
    late = copy.deepcopy(events)
    spans.shift(late, -300.0)
    off = spans.anchor_offset_us(late)
    assert off == pytest.approx(300.5)
    spans.shift(late, off)
    assert spans.anchor_offset_us(late) == pytest.approx(0.0)
    assert spans.read(late, "train")["launches.train"] == 4.0
    assert spans.anchor_offset_us(
        [e for e in events if e["name"] != "cudaDeviceSynchronize"]) is None


def test_timeline_innermost_and_split():
    tl = spans.Timeline([_span("a", 0, 10), _span("b", 2, 5),
                         _span("c", 5, 10)])
    assert [tl.at(t) for t in (-1, 0, 2, 4.9, 5, 9.9, 10)] == [
        None, "a", "b", "b", "c", "c", None]
    assert list(tl.split(1, 12)) == [("a", 1), ("b", 3), ("c", 5),
                                     (None, 2)]


@pytest.mark.parametrize("name", ["cars-train", "cars-tto"])
def test_probe_runs_a_tiny_cell_on_the_cpu(name):
    cell = tiny_cell(name)
    cell["traffic_file"]["trace_seconds"] = 0.2
    got = span_probe.probe(cell, 2147483700, 2)
    kind = cell["traffic_file"]["kind"]
    # the train state's set-up, and for TTO the TTO state's
    assert got["setup_state_s"] > 0
    on, off = got["slices"]
    assert on["spans"] and not off["spans"]
    assert on["steps"] >= 2
    assert on[f"launches.{kind}"] == 0 == on[f"host_syncs.{kind}"]
    assert 0 < on[f"host_issue_ms.{kind}"] <= on["ms_per_step"]
    assert (kind == "train") == ("loader_queue_wait_ms.train" in on)
    assert f"launches.{kind}" not in off
    assert on["existing"].keys() == off["existing"].keys()
    assert 0 < got["span_ns"]["off"] < got["span_ns"]["on"]
