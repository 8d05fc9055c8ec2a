"""The port's tools (``codenerf_tpu_torch/tools/``) on the CPU against the
JAX package, on ``tests/test_torch_eval.py``'s tree and widths (16 px, 12
x 12 after the crop, hidden 32, codes 16, f32, perturbation off) with a
checkpoint of the JAX package's parameters written by the port.

  * ``render_views``: its PNGs against JAX's ``make_image_renderer`` on
    the same weights and poses, within one 8-bit step (1/255); with
    ``--int8`` its image against JAX's int8 render (``int8_render_params``)
    at >= 60 dB, ``tests/test_torch_quantized.py``'s bound.
  * ``phi_sweep``: the azimuth profile (``azimuth_losses``) against JAX's
    renderer losses at the same codes and pose (rtol 1e-4); the verdict's
    thresholds as the JAX tool's; the whole tool on the CPU.
  * ``diag_fine``: coarse and fine PSNR against the same render through
    JAX's ``render_rays`` (1e-3 dB).
  * ``run_campaign``: its three command lines against the ones
    ``tools/run_campaign.sh`` runs, recorded by a stub ``python``, in the
    default and the ``cpu`` modes.
  * ``supervise_train``: the steps it asks for after a stalled child is
    killed (SIGTERM ignored, so SIGKILL), with a stub child.
  * ``gpu_selftest``: each family's arithmetic on the CPU, and the tool
    raises without a card; every checkpoint tool does too unless given
    ``--device cpu``.
"""

import json
import math
import os
import re
import stat
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codenerf_tpu import harness as jharness
from codenerf_tpu.config import load_config as j_load_config
from codenerf_tpu.core.geometry import pose_spherical as j_pose_spherical
from codenerf_tpu.core.geometry import ray_bundle as j_ray_bundle
from codenerf_tpu.eval.render import make_image_renderer as j_image_renderer
from codenerf_tpu.pipeline import render_rays as j_render_rays
from codenerf_tpu.train.state import init_train_state as j_init_state
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.data.png import read_png
from codenerf_tpu_torch.eval.render import make_image_renderer
from codenerf_tpu_torch.harness import Harness
from codenerf_tpu_torch.train import checkpoint, init_train_state
from codenerf_tpu_torch.tools import (diag_fine, gpu_selftest, phi_sweep,
                                      render_views, run_campaign,
                                      supervise_train)
from codenerf_tpu_torch.weights import params_from_jax
from tests.test_torch_eval import (BASE, NUM_OBJECTS, _overrides,  # noqa: F401
                                   synth_root)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
RENDER_PSNR = 60.0          # tests/test_torch_quantized.py's bound


@pytest.fixture(scope="module")
def exported(synth_root, tmp_path_factory):
    """(JAX harness, JAX params, overrides, the port's .ckpt of JAX's
    parameters)."""
    tmp = tmp_path_factory.mktemp("tools")
    ov = _overrides(synth_root, tmp)
    jcfg = j_load_config(str(BASE), overrides=ov)
    jh = jharness.Harness.from_config(jcfg, make_devices_mesh=False)
    jstate, _ = j_init_state(jax.random.PRNGKey(3), jcfg, jh.settings,
                             NUM_OBJECTS)
    cfg = load_config(BASE, overrides=ov)
    h = Harness.from_config(cfg, device="cpu")
    state = init_train_state(cfg, h.settings, NUM_OBJECTS, device="cpu")
    params_from_jax(state, jax.tree.map(np.asarray, jstate.params))
    state.step = 11
    path = checkpoint.save_checkpoint(tmp / "ckpt", state)
    return types.SimpleNamespace(jh=jh, jparams=jstate.params, ov=ov,
                                 ckpt=path, h=h, state=state)


def _ckpt_args(ex, *extra):
    return ["-c", str(BASE), "--load-checkpoint", str(ex.ckpt), "--device",
            "cpu", *map(str, extra), *ex.ov]


def _j_models(ex):
    return {"coarse": ex.jparams["coarse"], "fine": ex.jparams["fine"]}


def _j_codes(ex, oid):
    codes = ex.jparams["codes"]
    return codes["shape"][oid][None], codes["texture"][oid][None]


def _psnr(a, b):
    return float(-10 * np.log10(np.mean((np.asarray(a, np.float64)
                                         - np.asarray(b, np.float64)) ** 2)))


@pytest.mark.parametrize("turntable", [True, False],
                         ids=["turntable", "theta-arc"])
def test_render_views_matches_jax(exported, tmp_path, turntable):
    ex = exported
    out = render_views.main(_ckpt_args(
        ex, "--object-id", 1, "--num-views", 3, "--out", tmp_path,
        *(["--turntable"] if turntable else [])))
    assert out["step"] == 11
    jh = ex.jh
    render = j_image_renderer(jh.settings, jh.height, jh.width,
                              chunksize=jh.cfg.nerf.validation.chunksize)
    # the JAX tool's angles (tools/render_views.py:68-76)
    if turntable:
        angles = [(0.5 * (1.0 + 2.1), p) for p in np.linspace(
            0.0, 2.0 * np.pi, 3, endpoint=False)]
    else:
        angles = [(t, 0.0) for t in np.linspace(1.0, 2.1, 3)]
    z_s, z_t = _j_codes(ex, 1)
    for i, (theta, phi) in enumerate(angles):
        rgb = render(_j_models(ex), jh.directions,
                     j_pose_spherical(float(theta), float(phi), 1.30), z_s,
                     z_t)
        img = np.clip(np.asarray(rgb).reshape(jh.height, jh.width, 3), 0, 1)
        want = (img * 255).astype(np.uint8)
        got = read_png(tmp_path / f"view_{i:03d}.png")
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1, i
        np.testing.assert_allclose(out["rgb"][i], img, atol=1e-5)


def test_render_views_int8_matches_jax(exported, tmp_path):
    ex = exported
    out = render_views.main(_ckpt_args(ex, "--object-id", 0, "--num-views",
                                       2, "--turntable", "--int8", "--out",
                                       tmp_path))
    jh = ex.jh
    render = j_image_renderer(jh.settings, jh.height, jh.width,
                              chunksize=jh.cfg.nerf.validation.chunksize)
    z_s, z_t = _j_codes(ex, 0)
    theta = 0.5 * (1.0 + 2.1)
    qparams = jharness.int8_render_params(
        jh, _j_models(ex), j_pose_spherical(theta, 0.0, 1.30), z_s, z_t)
    for i, phi in enumerate(np.linspace(0.0, 2.0 * np.pi, 2,
                                        endpoint=False)):
        rgb = render(qparams, jh.directions,
                     j_pose_spherical(theta, float(phi), 1.30), z_s, z_t)
        img = np.clip(np.asarray(rgb).reshape(jh.height, jh.width, 3), 0, 1)
        assert _psnr(out["rgb"][i], img) >= RENDER_PSNR
        assert len(list(tmp_path.glob("*.png"))) == 2


def test_phi_sweep_profile_matches_jax_renderer(exported):
    ex, jh = exported, exported.jh
    rng = np.random.default_rng(4)
    z_s = rng.normal(size=(1, 16)).astype(np.float32) * 0.5
    z_t = rng.normal(size=(1, 16)).astype(np.float32) * 0.5
    target = ex.h.val_dataset[1]["color"]
    theta, rho = 1.17, 1.27
    phis = np.linspace(-math.pi, math.pi, 12, endpoint=False)
    render = make_image_renderer(ex.h.settings, ex.h.height, ex.h.width,
                                 ex.h.cfg.nerf.validation.chunksize, "cpu")
    got = phi_sweep.azimuth_losses(
        render, ex.state.models, ex.h.directions, torch.from_numpy(target),
        torch.from_numpy(z_s), torch.from_numpy(z_t), theta, rho, phis)
    # the JAX tool's loss_at (tools/phi_sweep.py:108-112)
    j_render = j_image_renderer(jh.settings, jh.height, jh.width,
                                chunksize=jh.cfg.nerf.validation.chunksize)
    tflat = target.reshape(-1, target.shape[-1])
    want = [float(jnp.mean((j_render(
        _j_models(ex), jh.directions,
        j_pose_spherical(jnp.asarray(theta), jnp.asarray(p),
                         jnp.asarray(rho)), jnp.asarray(z_s),
        jnp.asarray(z_t)) - tflat[..., :3]) ** 2)) for p in phis]
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("ratio, verdict", [
    (0.5, "NOT MISLOCALIZATION"), (1.149, "NOT MISLOCALIZATION"),
    (1.3, "ambiguous"), (1.51, "MISLOCALIZATION")])
def test_phi_sweep_verdict_thresholds(ratio, verdict):
    phis = np.linspace(-math.pi, math.pi, 8, endpoint=False)
    losses = np.array([3.0, 1.0, 2.0, 4.0, 3.0, 0.5, 2.0, 3.0])
    rep = phi_sweep.basin_report(phis, losses, ratio * 2.0, 2.0)
    assert rep["verdict"] == verdict
    assert rep["ratio"] == pytest.approx(ratio)
    # the JAX tool's circular minima and spacing (tools/phi_sweep.py:115-125)
    minima = np.where((losses < np.roll(losses, 1))
                      & (losses <= np.roll(losses, -1)))[0]
    np.testing.assert_array_equal(rep["minima"], phis[minima])
    np.testing.assert_allclose(rep["spacing"],
                               np.sort(np.diff(np.sort(phis[minima]))))


def test_phi_sweep_runs_on_the_cpu(exported, capsys):
    ex = exported
    res = phi_sweep.main(_ckpt_args(ex, "--objects", 0, 2, "--sweep", 8)
                         + ["optimizer.pose_restarts=2",
                            "optimizer.pose_flip_steps=2"])
    printed = capsys.readouterr().out
    assert [r["object"] for r in res] == [0, 2]
    for r in res:
        assert len(r["losses"]) == 8 and np.isfinite(r["losses"]).all()
        assert r["ratio"] == pytest.approx(r["loss_rec"] / r["loss_gt"])
    assert printed.count("[PHI-SWEEP] object") == 2
    assert "basin ratio rec/GT" in printed and '"profile"' not in printed


def test_diag_fine_matches_jax(exported, tmp_path):
    ex, jh = exported, exported.jh
    out = diag_fine.main(_ckpt_args(ex, "--view", 1, "--out",
                                    tmp_path / "d"))
    sample = jh.train_dataset[1]
    target = np.asarray(sample["color"])[..., :3]
    ro, rd = j_ray_bundle(jh.directions, jnp.asarray(sample["pose"])[None])
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    z_s, z_t = _j_codes(ex, int(sample["object_id"]))
    n = ro.shape[0]
    out_c, out_f = j_render_rays(_j_models(ex), jh.settings, ro, rd,
                                 jnp.broadcast_to(z_s, (n, 16)),
                                 jnp.broadcast_to(z_t, (n, 16)), None, False)
    shape = target.shape
    assert out["object"] == int(sample["object_id"])
    assert out["psnr_coarse"] == pytest.approx(
        _psnr(np.asarray(out_c.rgb).reshape(shape), target), abs=1e-3)
    assert out["psnr_fine"] == pytest.approx(
        _psnr(np.asarray(out_f.rgb).reshape(shape), target), abs=1e-3)
    assert out["acc_fine_mean"] == pytest.approx(
        float(np.mean(out_f.acc)), abs=1e-5)
    for tag in ("coarse", "fine", "target"):
        assert read_png(tmp_path / f"d_{tag}.png").shape == (*shape[:2], 3)


@pytest.mark.parametrize("tool", ["render_views", "diag_fine", "phi_sweep"])
def test_checkpoint_tools_default_to_cuda(exported, tmp_path, monkeypatch,
                                          tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"render_views": render_views, "diag_fine": diag_fine,
           "phi_sweep": phi_sweep}[tool]
    extra = {"render_views": ["--out", str(tmp_path)], "diag_fine": [],
             "phi_sweep": ["--objects", "0", "--sweep", "4"]}[tool]
    args = _ckpt_args(exported, *extra)
    args.remove("--device"), args.remove("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(args)


# ---- run_campaign against tools/run_campaign.sh ----

STUB_PYTHON = '''#!{exe}
import json, os, sys
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if "--out" in sys.argv:
    os.makedirs(sys.argv[sys.argv.index("--out") + 1], exist_ok=True)
'''


def _sh_commands(tmp_path, *args):
    """The argv of each ``python`` command ``tools/run_campaign.sh`` runs,
    with its data and log directories (the ``DATA=`` and ``LOGS=``
    assignments) moved under ``tmp_path``."""
    (tmp_path / "tools").mkdir()
    script = (ROOT / "tools" / "run_campaign.sh").read_text()
    for pattern, repl in ((r"^(\s*)DATA=\S*?/(synth|smoke_)",
                           rf"\1DATA={tmp_path}/data/\2"),
                          (r"^(\s*)LOGS=\S*campaign_logs$",
                           rf"\1LOGS={tmp_path}/logs/campaign_smoke"),
                          (r"^(\s*)LOGS=/(?!\S*campaign)\S*$",
                           rf"\1LOGS={tmp_path}/logs")):
        script, n = re.subn(pattern, repl, script, flags=re.M)
        assert n >= 1, pattern
    (tmp_path / "tools" / "run_campaign.sh").write_text(script)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text(STUB_PYTHON.format(exe=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               STUB_LOG=str(tmp_path / "calls.jsonl"))
    subprocess.run(["sh", str(tmp_path / "tools" / "run_campaign.sh"),
                    *args], check=True, env=env, cwd=tmp_path,
                   capture_output=True, timeout=60)
    return [json.loads(ln) for ln in
            (tmp_path / "calls.jsonl").read_text().splitlines()]


def _without_device(argv):
    out = list(argv)
    for flag in ("--platform", "--device"):
        while flag in out:
            i = out.index(flag)
            del out[i:i + 2]
    return out


@pytest.mark.parametrize("mode", [("cars", "10000", "", "50"),
                                  ("chairs", "300", "cpu", "400"),
                                  ("cars", "5000", "", "400")],
                         ids=["default", "cpu", "v4"])
def test_run_campaign_runs_the_scripts_commands(tmp_path, mode):
    cat, steps, dev, objects = mode
    sh_gen, sh_train, sh_eval = _sh_commands(tmp_path, *mode)
    plan = run_campaign.plan(cat, int(steps), dev or "cuda", int(objects),
                             f"{tmp_path}/data", f"{tmp_path}/logs")
    (gen,), train, ev = plan["generate"], plan["train"], plan["eval"]
    assert sh_gen[0] == "tools/make_synth_data.py"
    assert gen[1:3] == ["-m", "codenerf_tpu_torch.tools.make_synth_data"]
    assert gen[3:] == sh_gen[1:]
    assert sh_train[0] == "train.py" and sh_eval[0] == "eval.py"
    assert train[1:3] == ["-m", "codenerf_tpu_torch.train_cli"]
    assert ev[1:3] == ["-m", "codenerf_tpu_torch.eval_cli"]
    assert _without_device(train[3:]) == _without_device(sh_train[1:])
    assert _without_device(ev[3:]) == _without_device(sh_eval[1:])
    # --platform cpu becomes --device cpu; the card is the default
    for port, sh in ((train, sh_train), (ev, sh_eval)):
        want = "cpu" if dev == "cpu" else "cuda"
        assert port[port.index("--device") + 1] == want
        assert ("--platform" in sh) == (dev == "cpu")
    assert str(plan["data"]) == next(
        a for a in sh_train if a.startswith("dataset.basedir=")).split(
        "=", 1)[1]


def test_run_campaign_overrides_and_shards(tmp_path):
    over = ["runtime.use_pallas=true", "runtime.pallas_backward=true"]
    plan = run_campaign.plan(overrides=over, jobs=3)
    assert plan["train"][-2:] == over and plan["eval"][-2:] == over
    shards = plan["generate"]
    assert len(shards) == 4 and shards[-1][-2:] == ["--only-stage", "val"]
    bounds = [(int(s[s.index("--obj-start") + 1]),
               int(s[s.index("--obj-end") + 1])) for s in shards[:-1]]
    assert bounds[0][0] == 0 and bounds[-1][1] == 50
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    summary = run_campaign.train_summary(
        ROOT / "assets" / "metrics_cars_v3_40k.jsonl")
    assert summary["psnr"]["4001-5000"] == pytest.approx(21.37, abs=5e-3)
    assert summary["psnr"]["9001-10000"] == pytest.approx(23.75, abs=5e-3)


# ---- supervise_train ----

STUB_CHILD = textwrap.dedent('''
    import pathlib, signal, sys, time
    remaining, ckpt, hang_at = int(sys.argv[1]), pathlib.Path(sys.argv[2]), \\
        int(sys.argv[3])
    signal.signal(signal.SIGTERM, signal.SIG_IGN)     # a wedged process
    ckpt.mkdir(parents=True, exist_ok=True)
    steps = [int(p.stem) for p in ckpt.glob("*.ckpt")]
    start = max(steps, default=0)
    for step in range(start + 1, start + remaining + 1):
        (ckpt / f"{step}.ckpt").write_text("")
        print("step", step, flush=True)
        if step == hang_at:
            time.sleep(600)
''')


def test_supervise_train_relaunches_with_the_steps_left(tmp_path, capsys):
    ckpt, log = tmp_path / "checkpoints", tmp_path / "train.log"
    asked = []

    def command(remaining):
        asked.append(remaining)
        return [sys.executable, "-c", STUB_CHILD, str(remaining), str(ckpt),
                "4"]
    rc = supervise_train.supervise(10, ckpt, log, command, stall=1.0,
                                   grace=0.5, poll=0.2, restart_delay=0.0)
    assert rc == 0
    # the first child hangs after step 4 and ignores SIGTERM: killed, then
    # relaunched for the 6 steps left
    assert asked == [10, 6]
    assert supervise_train.latest_step(ckpt) == 10
    printed = capsys.readouterr().out
    assert "log silent" in printed and "complete at checkpoint 10" in printed
    assert "step 4" in log.read_text()
    # at the target nothing is launched
    asked.clear()
    assert supervise_train.supervise(10, ckpt, log, command, poll=0.2) == 0
    assert asked == []


def test_supervise_train_owns_max_steps(tmp_path):
    with pytest.raises(SystemExit):
        supervise_train.main(["--target-steps", "5", "--checkpoint-dir",
                              str(tmp_path), "--log", str(tmp_path / "l"),
                              "--", "--max-steps", "3"])
    assert supervise_train.train_command(7, ["-c", "x.yml"])[1:] == [
        "-m", "codenerf_tpu_torch.train_cli", "--max-steps", "7", "-c",
        "x.yml"]


# ---- gpu_selftest ----

def test_gpu_selftest_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpu_selftest.main(["--families", "fused_fwd"])
    with pytest.raises(SystemExit):
        gpu_selftest.main(["--families", "fused_fwd,bogus"])


@pytest.mark.parametrize("family", list(gpu_selftest.FAMILIES))
def test_gpu_selftest_families_compute_on_the_cpu(family):
    """On CPU tensors the wrappers run the plain versions, so each
    family's error equals its bf16 plain version's and sits under the
    gate; int8 stays under its energy tolerance."""
    args = types.SimpleNamespace(hidden=32, rays=48, samples=8)
    check, _ = gpu_selftest.FAMILIES[family]
    res = check(args, "cpu")
    if family == "int8":
        assert 0 < res <= gpu_selftest.INT8_TOL
    else:
        err, noise = res
        assert 0 < err == noise <= 0.2
