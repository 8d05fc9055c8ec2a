"""The port's train entry point end to end on the CPU, on a
``tools/make_synth_data.py`` tree with ``tests/test_loop.py``'s tiny
overrides (f32): ``run_training`` saves, resumes and survives a SIGTERM;
``checkify`` raises on NaN; ``validate`` with every TTO stage; ``ssim``
against JAX's (atol 1e-5); the harness's refusals; the CLI's device
default; and the loss curve of 40 steps against the JAX loop's from the
same exported weights (the last 10 logged fine losses' means within 15%).
"""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.config import load_config as j_load_config
from codenerf_tpu.core.metrics import ssim as j_ssim
from codenerf_tpu_torch import train_cli
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.core.metrics import ssim
from codenerf_tpu_torch.data.loader import PrefetchIterator
from codenerf_tpu_torch.harness import Harness, validate
from codenerf_tpu_torch.train import checkpoint, init_train_state
from codenerf_tpu_torch.train import make_train_step
from codenerf_tpu_torch.train.loop import run_training
from codenerf_tpu_torch.utils import trace as trace_spans
from codenerf_tpu_torch.utils.logging import MetricLogger
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
BASE = ROOT / "configs" / "synth-smoke.yml"


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth") / "srn_cars"
    subprocess.run(
        [sys.executable, "tools/make_synth_data.py", "--out", str(root),
         "--objects", "2", "--views", "4", "--val-views", "2",
         "--size", "16"],
        check=True, cwd=ROOT, capture_output=True)
    return root


def _overrides(synth_root, logdir, **extra):
    """``tests/test_loop.py``'s tiny overrides."""
    return [
        f"dataset.basedir={synth_root}",
        f"experiment.logdir={logdir}",
        "experiment.id=looptest",
        "experiment.iterations=100000",
        "experiment.print_every=2",
        "experiment.save_every=4",
        "experiment.validate_every=1000000",
        "experiment.val_iterations=3",
        "experiment.val_print_every=2",
        "dataset.train_batch_size=2",
        "nerf.ray_sampler.num_random_rays=32",
        "nerf.point_sampler.num_coarse=8",
        "nerf.point_sampler.num_fine=8",
        "models.nerf_coarse.hidden_size=16",
        "models.nerf_fine.hidden_size=16",
        "models.embedding.shape_code_size=8",
        "models.embedding.texture_code_size=8",
        "nerf.embedder.num_encoding_fn_xyz=4",
        "nerf.embedder.num_encoding_fn_dir=2",
        "nerf.validation.chunksize=64",
        "runtime.compute_dtype=float32",
    ] + [f"{k}={v}" for k, v in extra.items()]


def _cfg(synth_root, logdir, **extra):
    return load_config(BASE, overrides=_overrides(synth_root, logdir,
                                                  **extra))


def _logged(path: Path, key="nerf_loss_fine"):
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    return [r[key] for r in recs if r["mode"] == "train"]


def _hold_close_for_the_windows_load(monkeypatch):
    """The loader thread's load after the window's one batch is taken
    races the step's end: ``close`` would stop the thread before it is
    scheduled.  Once tracing is on, hold ``PrefetchIterator.close`` until
    that load has begun, so that its ``loader.load`` span is recorded."""
    opened, loading = threading.Event(), threading.Event()
    enable, span = trace_spans.enable, trace_spans.span
    close = PrefetchIterator.close

    def traced_enable():
        enable()
        opened.set()

    def traced_span(name, step=None):
        if name == "loader.load" and opened.is_set():
            loading.set()
        return span(name, step)

    def patient_close(self, timeout=10.0):
        if opened.is_set():
            loading.wait(60)
        close(self, timeout)

    monkeypatch.setattr(trace_spans, "enable", traced_enable)
    monkeypatch.setattr(trace_spans, "span", traced_span)
    monkeypatch.setattr(PrefetchIterator, "close", patient_close)


def test_trains_checkpoints_and_resumes(synth_root, tmp_path, monkeypatch):
    cfg = _cfg(synth_root, tmp_path, **{"runtime.profile_dir":
                                        tmp_path / "prof"})
    metrics = run_training(cfg, max_steps=5, device="cpu")
    assert np.isfinite(metrics["loss"])
    ckdir = tmp_path / "looptest" / "checkpoints"
    assert checkpoint.latest_step(ckdir) == 5
    assert sorted(p.name for p in ckdir.iterdir()) == ["4.ckpt", "5.ckpt"]
    assert load_config(tmp_path / "looptest" / "config.yml") == cfg
    assert len(_logged(tmp_path / "looptest" / "metrics.jsonl")) == 2
    metrics2 = run_training(cfg, max_steps=2, device="cpu")
    assert checkpoint.latest_step(ckdir) == 7
    assert np.isfinite(metrics2["loss"])
    # a profiler window opens 5 steps into a run: the two runs above end
    # before it, the next (7 -> 13) opens it at 12 and closes it at its end
    assert not (tmp_path / "prof" / "trace.json").exists()
    _hold_close_for_the_windows_load(monkeypatch)
    run_training(cfg, max_steps=6, device="cpu")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    # the port's spans of the window's steps, on the trace's clock: each
    # step's root holds the step's CPU operators
    spans = [e for e in trace["traceEvents"]
             if e.get("cat") == "program_span"]
    roots = [e for e in spans if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in roots] == [12]
    assert {"train.rays", "train.forward", "train.backward",
            "train.optimizer", "loader.wait", "loader.load",
            "loop.checkpoint"} <= {e["name"] for e in spans}
    ops = [e for e in trace["traceEvents"] if e.get("cat") == "cpu_op"
           and e["tid"] == roots[0]["tid"]]
    lo, hi = roots[0]["ts"], roots[0]["ts"] + roots[0]["dur"]
    assert sum(lo <= e["ts"] < hi for e in ops) > 100


def test_sigterm_saves_and_exits_then_resumes(synth_root, tmp_path):
    args = [sys.executable, "-u", "-m", "codenerf_tpu_torch.train_cli",
            "-c", str(BASE), "--device", "cpu", "--max-steps", "100000"]
    ov = _overrides(synth_root, tmp_path, **{"experiment.print_every": 1,
                                             "experiment.save_every": 1000})
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(args + ov, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        for line in proc.stdout:
            if "Iter:        2 " in line:
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    saved = [ln for ln in out.splitlines() if "interrupted" in ln]
    assert saved, out
    step = int(saved[0].split("at step ")[1].split(";")[0])
    ckdir = tmp_path / "looptest" / "checkpoints"
    assert 2 <= step < 100000 and checkpoint.latest_step(ckdir) == step
    train_cli.main(["-c", str(BASE), "--device", "cpu", "--max-steps", "2"]
                   + ov)
    assert checkpoint.latest_step(ckdir) == step + 2


def _state(cfg, harness, seed=0):
    return init_train_state(cfg, harness.settings,
                            harness.train_dataset.num_objects, seed=seed,
                            device="cpu")


def test_checkify_raises_on_nan(synth_root, tmp_path):
    """runtime.checkify: the counterpart of JAX's checkify.float_checks
    (tests/test_train.py::test_checkify_catches_nan_params)."""
    cfg = _cfg(synth_root, tmp_path)
    harness = Harness.from_config(cfg, device="cpu")
    batch = harness.train_iter.fixed_batch()
    args = (harness.directions, torch.from_numpy(batch["pose"]),
            torch.from_numpy(batch["color"]),
            torch.from_numpy(batch["object_id"]), torch.Generator())
    state = _state(cfg, harness)
    step = make_train_step(harness.settings, state, 32, 1e-5, True,
                           use_checkify=True)
    step(*args)                                    # finite: no error
    with torch.no_grad():
        for m in state.models.values():
            for p in m.parameters():
                p.mul_(float("nan"))
    with pytest.raises(FloatingPointError, match="(?i)nan") as err:
        step(*args)
    assert "loss" in str(err.value)
    # a NaN in a code row no ray reads, without the regularizer: the loss
    # and gradients are finite, the update keeps the NaN
    state = _state(cfg, harness)
    step = make_train_step(harness.settings, state, 32, 0.0, True,
                           use_checkify=True)
    with torch.no_grad():
        state.tables.texture_embedding.weight[1] = float("nan")
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(FloatingPointError,
                       match=r"tables\.texture_embedding\.weight: nan"):
        step(*args[:3], ids, torch.Generator())


@pytest.mark.parametrize("stages", [{}, {"pose_restarts": 2,
                                         "pose_restart_steps": 1,
                                         "pose_flip_steps": 2,
                                         "se3_refine_steps": 2}],
                         ids=["plain", "restarts_flip_se3"])
def test_validate_is_finite(synth_root, tmp_path, capsys, stages):
    cfg = _cfg(synth_root, tmp_path,
               **{f"optimizer.{k}": v for k, v in stages.items()})
    harness = Harness.from_config(cfg, device="cpu")
    state = _state(cfg, harness)
    logger = MetricLogger(tmp_path / "val", enable_tensorboard=False)
    out = validate(harness, {**state.models, "codes": state.tables}, logger,
                   iteration=0)
    logger.close()
    assert set(out) == {"loss", "psnr", "ssim"}
    assert np.isfinite(out["psnr"]) and np.isfinite(out["ssim"])
    printed = capsys.readouterr().out
    assert "[VAL   ]" in printed
    if stages:
        assert "pose multi-start" in printed
        assert "azimuth-flip rescue" in printed
        assert "SE3 refine" in printed


@pytest.mark.parametrize("shape", [(24, 20, 3), (8, 6, 3), (16, 16, 1)])
def test_ssim_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(
        np.float32)
    for x, y in ((a, b), (a, a), (np.zeros(shape, np.float32), b)):
        got = float(ssim(torch.from_numpy(x), torch.from_numpy(y)))
        want = float(j_ssim(jnp.asarray(x), jnp.asarray(y)))
        assert abs(got - want) <= 1e-5, (got, want)


def test_harness_refusals(synth_root, tmp_path):
    # two devices need two ranks, started by train_cli -g 2 or torchrun
    cfg = load_config(BASE, _overrides(synth_root, tmp_path)
                      + ["runtime.num_devices=2"])
    with pytest.raises(RuntimeError, match="start 2 ranks"):
        Harness.from_config(cfg, device="cpu")
    # int8 serving is ported: the harness takes it
    cfg = load_config(BASE, _overrides(synth_root, tmp_path)
                      + ["runtime.int8_serving=True",
                         "runtime.int8_encode=True"])
    assert Harness.from_config(cfg, device="cpu").cfg.runtime.int8_encode
    # LLFF is ported: on the SRN tree its loader finds no poses_bounds.npy
    cfg = load_config(BASE, _overrides(synth_root, tmp_path)
                      + ["dataset.type=llff"])
    with pytest.raises(FileNotFoundError, match="poses_bounds.npy"):
        Harness.from_config(cfg, device="cpu")
    jittered = tmp_path / "jit" / "srn_cars"
    subprocess.run(
        [sys.executable, "tools/make_synth_data.py", "--out", str(jittered),
         "--objects", "2", "--views", "1", "--val-views", "1", "--size",
         "16", "--focal-jitter", "0.1"],
        check=True, cwd=ROOT, capture_output=True)
    with pytest.raises(ValueError, match="heterogeneous"):
        Harness.from_config(_cfg(jittered, tmp_path), device="cpu")


def test_cli_defaults_to_cuda_and_refuses_devices(synth_root, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-c", str(BASE)] + _overrides(synth_root, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(argv)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(argv + ["-g", "2"])
    # -g 2 on the card takes two cards, one rank each
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="-g 2: 1 CUDA devices visible"):
        train_cli.main(argv + ["-g", "2"])


def test_loss_tracks_the_jax_loop(synth_root, tmp_path):
    """Both loops start from JAX's step-0 state (the port's through its
    ``.ckpt`` export) and draw the same image batches; the ray draws
    differ (JAX keys against a torch generator)."""
    from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
    from codenerf_tpu.train import checkpoint as jcheckpoint
    from codenerf_tpu.train.loop import run_training as j_run_training
    from codenerf_tpu.train.state import init_train_state as j_init_state
    from codenerf_tpu.train.torch_import import export_torch_checkpoint

    extra = {"experiment.save_every": 1000}
    jcfg = j_load_config(BASE, _overrides(synth_root, tmp_path, **extra))
    js = JRenderSettings.from_config(jcfg)
    jstate, _ = j_init_state(jax.random.PRNGKey(3), jcfg, js, 2)
    jcheckpoint.save_checkpoint(tmp_path / "init", jstate)
    export_torch_checkpoint(str(tmp_path / "init"), jcfg, js,
                            str(tmp_path / "init.ckpt"))

    j_run_training(j_load_config(BASE, _overrides(
        synth_root, tmp_path, **extra, **{
            "experiment.id": "jax",
            "runtime.load_checkpoint": tmp_path / "init"})), max_steps=40)
    run_training(load_config(BASE, _overrides(
        synth_root, tmp_path, **extra, **{
            "experiment.id": "port",
            "runtime.load_checkpoint": tmp_path / "init.ckpt"})),
        max_steps=40, device="cpu")
    jl = _logged(tmp_path / "jax" / "metrics.jsonl")
    pl = _logged(tmp_path / "port" / "metrics.jsonl")
    assert len(jl) == len(pl) == 20
    j_tail, p_tail = np.mean(jl[-10:]), np.mean(pl[-10:])
    print(f"fine loss, first logged / mean of the last 10: JAX {jl[0]:.5f} "
          f"/ {j_tail:.5f}, port {pl[0]:.5f} / {p_tail:.5f}, gap "
          f"{abs(p_tail - j_tail) / j_tail:.4f}")
    assert j_tail < jl[0] and p_tail < pl[0]
    assert abs(p_tail - j_tail) <= 0.15 * j_tail
