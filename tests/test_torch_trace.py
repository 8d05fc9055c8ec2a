"""The port's span recorder (``codenerf_tpu_torch/utils/trace.py``) and
the spans at its layer boundaries, on the CPU: nothing recorded and
nothing allocated with tracing off; the same losses and parameters, to
the bit, with it on; one root span a step with its children under it;
the loader's spans on their threads; the drained clock; the cap."""

import ast
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.core.geometry import pixel_directions, pose_spherical
from codenerf_tpu_torch.data.loader import PrefetchIterator
from codenerf_tpu_torch.eval.tto import (init_batched_tto_state,
                                         make_batched_tto_step)
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train import init_train_state, make_train_step
from codenerf_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
TINY = ["models.nerf_coarse.hidden_size=16",
        "models.nerf_fine.hidden_size=16",
        "models.embedding.shape_code_size=8",
        "models.embedding.texture_code_size=8",
        "nerf.point_sampler.num_coarse=8", "nerf.point_sampler.num_fine=8",
        "nerf.embedder.num_encoding_fn_xyz=4",
        "nerf.embedder.num_encoding_fn_dir=2"]
B, K, R, H = 2, 3, 32, 8
STEPS = 2
CHILDREN = {"train": {"train.rays", "train.forward", "train.backward",
                      "train.optimizer"},
            "tto": {"tto.forward", "tto.backward", "tto.optimizer"}}


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _run(kind: str, steps: int = STEPS):
    """``steps`` train steps (2 ray chunks) or batched TTO steps (K
    objects) of a tiny CodeNeRF from seed 0; (losses, final leaves)."""
    cfg = load_config(ROOT / "configs" / "synth-smoke.yml", overrides=TINY)
    settings = RenderSettings.from_config(cfg)
    state = init_train_state(cfg, settings, 4, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    intrinsic = torch.eye(4)
    intrinsic[0, 0] = intrinsic[1, 1] = 10.0
    intrinsic[0, 2] = intrinsic[1, 2] = H / 2
    dirs = pixel_directions(H, H, intrinsic)
    n = B if kind == "train" else K
    poses = pose_spherical(torch.rand(n, generator=g) + 0.5,
                           6 * torch.rand(n, generator=g),
                           torch.full((n,), 1.3))
    images = torch.rand(n, H, H, 3, generator=g)
    lam = cfg.experiment.regularizer_lambda
    losses = []
    if kind == "train":
        fn = make_train_step(settings, state, R, lam, True, ray_chunks=2)
        for _ in range(steps):
            losses.append(fn(dirs, poses, images, torch.tensor([0, 3]),
                             g).loss)
        leaves = [p for m in state.modules().values() for p in m.parameters()]
        return losses, leaves
    tto, opt = init_batched_tto_state(state.tables, cfg.optimizer, K,
                                      device="cpu")
    fn = make_batched_tto_step(settings, opt, R, lam, True, device="cpu")
    for _ in range(steps):
        tto, m = fn(tto, state.models, dirs, images, poses, g)
        losses.append(m.loss)
    return losses, list(tto.variables.values())


def test_off_records_nothing():
    with trace.span("train.step", step=0):
        with trace.span("train.forward"):
            pass
    _run("train", 1)
    assert trace.drain() == []


@pytest.mark.parametrize("kind", ["train", "tto"])
def test_steps_bit_identical_on_and_off(kind):
    loss_off, leaves_off = _run(kind)
    trace.enable()
    loss_on, leaves_on = _run(kind)
    trace.disable()
    assert trace.drain()
    for a, b in zip(loss_off + leaves_off, loss_on + leaves_on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["train", "tto"])
def test_one_root_a_step_and_its_children(kind):
    trace.enable()
    _run(kind)
    spans = trace.drain()
    root_name = f"{kind}.step"
    roots = [s for s in spans if s.name == root_name]
    assert [s.step for s in roots] == list(range(STEPS))
    assert all(s.parent == -1 for s in roots)
    # the train state's set-up, and the TTO state's after it
    setup = [s for s in spans if s.name == "setup.state"]
    assert len(setup) == (1 if kind == "train" else 2)
    assert all(s.parent == -1 and s.step is None for s in setup)
    children = [s for s in spans if s.name.startswith(f"{kind}.")
                and s.name != root_name]
    assert {s.name for s in children} == CHILDREN[kind]
    for s in children:
        root = spans[s.parent]
        assert root.name == root_name and s.step == root.step
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for r in roots:
        names = [s.name for s in children if s.step == r.step]
        if kind == "train":   # 2 chunks, then the regularizer's backward
            assert names == ["train.rays", "train.forward", "train.backward",
                             "train.forward", "train.backward",
                             "train.backward", "train.optimizer"]
        else:                 # the data loss's backward, the codes' norm's
            assert names == ["tto.forward", "tto.backward", "tto.backward",
                             "tto.optimizer"]


def test_loader_spans_sit_on_their_threads():
    batches = iter([{"pose": np.full((2, 4, 4), i, np.float32),
                     "color": np.zeros((2, 4, 4, 3), np.float32),
                     "object_id": np.arange(2)} for i in range(6)])
    trace.enable()
    it = PrefetchIterator(batches, depth=2, device="cpu")
    try:
        got = [float(next(it)["pose"][0, 0, 0]) for _ in range(3)]
    finally:
        it.close()
    assert not it._thread.is_alive()
    trace.disable()
    spans = trace.drain()
    assert got == [0.0, 1.0, 2.0]
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, set()).add(s.tid)
    assert by_name["loader.wait"] == {threading.get_native_id()}
    assert by_name["loader.load"] == by_name["loader.ship"] == {
        it._thread.native_id}
    assert {s.ident for s in spans if s.name == "loader.wait"} == {
        threading.get_ident()}
    assert {s.ident for s in spans if s.name == "loader.load"} == {
        it._thread.ident}
    waits = [s for s in spans if s.name == "loader.wait"]
    assert len(waits) == 3 and all(s.step is None for s in waits)


def test_drain_empties_and_lands_on_the_unix_clock():
    before = time.time_ns()
    trace.enable()
    for i in range(5):
        with trace.span("tto.step", step=i):
            with trace.span("tto.forward"):
                time.sleep(0.001)
    spans = trace.drain()
    after = time.time_ns()
    assert trace.drain() == []
    assert len(spans) == 10
    starts = [s.start_ns for s in spans]
    assert starts == sorted(starts)
    for s in spans:
        assert s.start_ns <= s.end_ns
        assert before - 10_000_000 <= s.start_ns <= after + 10_000_000
        assert before - 10_000_000 <= s.end_ns <= after + 10_000_000
    base = before - 12_345_678
    events = trace.chrome_events(spans, base, 7)
    assert [e["name"] for e in events] == [s.name for s in spans]
    for e, s in zip(events, spans):
        assert e["cat"] == "program_span" and e["tid"] == s.tid
        assert e["args"]["ident"] == s.ident == threading.get_ident()
        assert abs(e["ts"] * 1e3 - (s.start_ns - base)) < 1
        assert abs(e["dur"] * 1e3 - (s.end_ns - s.start_ns)) < 1


def test_cap_holds(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    trace.enable()
    for i in range(8):
        with trace.span("train.step", step=i):
            pass
    with pytest.warns(RuntimeWarning, match="3 spans past the cap of 5"):
        spans = trace.drain()
    assert [s.step for s in spans] == [0, 1, 2, 3, 4]


def test_off_span_allocates_nothing():
    for _ in range(100):
        with trace.span("train.step", step=1):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with trace.span("train.step", step=1):
                with trace.span("train.forward"):
                    pass
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before < 1024          # under a byte per span
    assert trace.drain() == []


def test_recorder_imports_the_standard_library_alone():
    """No torch, so no CUDA call can be made from it, on or off."""
    import codenerf_tpu_torch.utils.trace as mod
    tree = ast.parse(Path(mod.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "contextlib", "threading", "time",
                     "typing", "warnings"}, names
