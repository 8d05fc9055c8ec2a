"""The port's eval entry point on the CPU against the JAX package: the
batched and category validators (``harness.validate_batched``,
``validate_category``), their collect helpers, ``eval/capacity.py`` and
the eval CLI, on a ``tools/make_synth_data.py`` tree at 16 px (12 x 12
after the crop) with a small f32 model (hidden 32, codes 16) loaded with
the JAX package's parameters.

Perturbation and sigma noise are off and every TTO step draws all 144
pixels (``num_random_rays = H * W``), so the ray set is every pixel and
the fine samples are deterministic: the two packages' different random
streams draw the same rays, in another order.  ``validate_batched`` with
the multi-start probe, the flip rescue and the SE(3) refine, single- and
multi-view, matches JAX's: per-object PSNR and GT-pose PSNR within 1e-3
dB, pose errors within 1e-4, the recovered spherical pose within 1e-4
and the same flip count.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from codenerf_tpu import harness as jharness
from codenerf_tpu.config import load_config as j_load_config
from codenerf_tpu.train.state import init_train_state as j_init_state
from codenerf_tpu.utils.logging import MetricLogger as JMetricLogger
from codenerf_tpu_torch import eval_cli, harness
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.eval import capacity
from codenerf_tpu_torch.harness import Harness
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train import checkpoint, init_train_state
from codenerf_tpu_torch.utils.logging import MetricLogger
from codenerf_tpu_torch.weights import params_from_jax
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
BASE = ROOT / "configs" / "synth-smoke.yml"
GIB = 1024 ** 3
NUM_OBJECTS = 2
STAGES = {"pose_restarts": 2, "pose_restart_steps": 2, "pose_flip_steps": 2,
          "se3_refine_steps": 2}


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """2 train objects, 3 val objects of 2 views each, 16 px."""
    root = tmp_path_factory.mktemp("synth") / "srn_cars"
    subprocess.run(
        [sys.executable, "tools/make_synth_data.py", "--out", str(root),
         "--objects", "2", "--val-objects", "3", "--views", "2",
         "--val-views", "2", "--size", "16"],
        check=True, cwd=ROOT, capture_output=True)
    return root


def _overrides(synth_root, logdir, **optimizer):
    return [
        f"dataset.basedir={synth_root}",
        f"experiment.logdir={logdir}",
        "experiment.id=evaltest",
        "experiment.val_iterations=3",
        "experiment.val_print_every=2",
        "nerf.ray_sampler.num_random_rays=144",
        "nerf.point_sampler.num_coarse=8",
        "nerf.point_sampler.num_fine=8",
        "nerf.point_sampler.perturb=False",
        "nerf.train.radiance_field_noise_std=0.0",
        "models.nerf_coarse.hidden_size=32",
        "models.nerf_fine.hidden_size=32",
        "models.embedding.shape_code_size=16",
        "models.embedding.texture_code_size=16",
        "nerf.embedder.num_encoding_fn_xyz=4",
        "nerf.embedder.num_encoding_fn_dir=2",
        "nerf.validation.chunksize=64",
        "runtime.compute_dtype=float32",
    ] + [f"optimizer.{k}={v}" for k, v in optimizer.items()]


def _both(synth_root, logdir, **optimizer):
    """(JAX harness, JAX params, port harness, port params) on the same
    tree and weights."""
    ov = _overrides(synth_root, logdir, **optimizer)
    jcfg = j_load_config(str(BASE), overrides=ov)
    jh = jharness.Harness.from_config(jcfg, make_devices_mesh=False)
    jstate, _ = j_init_state(jax.random.PRNGKey(0), jcfg, jh.settings,
                             NUM_OBJECTS)
    cfg = load_config(BASE, overrides=ov)
    h = Harness.from_config(cfg, device="cpu")
    state = init_train_state(cfg, h.settings, NUM_OBJECTS, device="cpu")
    params_from_jax(state, jax.tree.map(np.asarray, jstate.params))
    return jh, jstate.params, h, {**state.models, "codes": state.tables}


def _flip_count(printed):
    line = next(x for x in printed.splitlines() if "flip wins on" in x)
    return line.split("flip wins on ")[1].split()[0]


@pytest.mark.parametrize("views", [1, 2], ids=["single", "multiview"])
def test_validate_batched_matches_jax(synth_root, tmp_path, capsys, views):
    jh, jparams, h, params = _both(synth_root, tmp_path, **STAGES)
    want = jharness.validate_batched(
        jh, jparams, JMetricLogger(tmp_path / "j", enable_tensorboard=False),
        2, tto_views=views, return_recovered=True)
    jflips = _flip_count(capsys.readouterr().out)
    got = harness.validate_batched(
        h, params, MetricLogger(tmp_path / "p", enable_tensorboard=False), 2,
        tto_views=views, return_recovered=True)
    printed = capsys.readouterr().out
    assert "batched pose multi-start over 2 inits" in printed
    assert "SE3 refine" in printed
    assert _flip_count(printed) == jflips
    assert got["num_objects"] == 2 and len(got["per_object"]) == 2
    for g, w in zip(got["per_object"], want["per_object"]):
        assert set(g) == set(w)
        for k in ("psnr", "psnr_gt_pose", "delta_psnr_gt_pose"):
            assert abs(g[k] - w[k]) <= 1e-3, (k, g[k], w[k])
        assert abs(g["pose_error"] - w["pose_error"]) <= 1e-4
        assert abs(g["ssim"] - w["ssim"]) <= 1e-4
    for k in ("theta", "phi", "rho", "final_poses"):
        np.testing.assert_allclose(got["recovered"][k],
                                   want["recovered"][k], atol=1e-4,
                                   err_msg=k)
    for k in ("targets", "poses_gt"):
        np.testing.assert_array_equal(got["recovered"][k],
                                      want["recovered"][k])


def test_collect_helpers_match_jax(synth_root, tmp_path):
    jh, _, h, _ = _both(synth_root, tmp_path)

    def key(samples):
        return [(int(s["object_id"]), s["pose"].tobytes()) for s in samples]
    assert key(harness._distinct_val_objects(h)) == key(
        jharness._distinct_val_objects(jh))
    assert len(harness._distinct_val_objects(h)) == 3
    # five objects from a split of three wrap to later views
    assert key(harness._collect_val_objects(h, 5)) == key(
        jharness._collect_val_objects(jh, 5))
    # three views of an object with two repeat the first
    for oid in range(3):
        got = harness._collect_views(h, oid, 3)
        assert key(got) == key(jharness._collect_views(jh, oid, 3))
        assert key(got)[2] == key(got)[0]


def _category(synth_root, tmp_path, capsys=None):
    _, _, h, params = _both(synth_root, tmp_path)
    logger = MetricLogger(tmp_path / "cat", enable_tensorboard=False)
    return h, params, logger


def test_validate_category_pads_the_last_group(synth_root, tmp_path, capsys,
                                               monkeypatch):
    h, params, logger = _category(synth_root, tmp_path)
    calls = []
    real = harness.validate_batched

    def spy(harness_, params_, logger_, K, samples=None, **kw):
        calls.append([int(s["object_id"]) for s in samples])
        return real(harness_, params_, logger_, K, samples=samples, **kw)

    monkeypatch.setattr(harness, "validate_batched", spy)
    out = harness.validate_category(h, params, logger, 2, val_iterations=1)
    # one full group and one padded by repeating its first object
    assert calls == [[0, 1], [2, 2]]
    assert out["num_objects"] == 3 and len(out["per_object"]) == 3
    assert out["batch_objects"] == 2
    printed = capsys.readouterr().out
    assert "category evaluation over 3 objects (groups of 2)" in printed
    assert "  mean   |" in printed
    assert all(np.isfinite(r["psnr"]) for r in out["per_object"])


def test_out_of_memory_halves_the_group_and_keeps_rows(synth_root, tmp_path,
                                                       capsys, monkeypatch):
    h, params, logger = _category(synth_root, tmp_path)
    real = harness.validate_batched
    calls = []

    def flaky(harness_, params_, logger_, K, **kw):
        calls.append(K)
        if K > 1 and len(calls) > 1:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 16.00 GiB")
        return real(harness_, params_, logger_, K, **kw)

    monkeypatch.setattr(harness, "validate_batched", flaky)
    out = harness.validate_category(h, params, logger, 2, val_iterations=1)
    # the first group ran at K = 2; the second ran out and was redone at 1
    assert calls == [2, 2, 1]
    assert out["num_objects"] == 3 and out["batch_objects"] == 1
    assert "ran out of device memory" in capsys.readouterr().out


@pytest.mark.parametrize("err", [ValueError("out of memory in a shape"),
                                 AssertionError("CUDA out of memory")])
def test_other_errors_are_raised(synth_root, tmp_path, monkeypatch, err):
    h, params, logger = _category(synth_root, tmp_path)

    def broken(*args, **kw):
        raise err

    monkeypatch.setattr(harness, "validate_batched", broken)
    with pytest.raises(type(err)):
        harness.validate_category(h, params, logger, 2, val_iterations=1)


def test_analytic_clamp_auto_splits(synth_root, tmp_path, capsys,
                                    monkeypatch):
    """A budget that admits only K = 1 splits a batch of 2 into singles."""
    h, params, logger = _category(synth_root, tmp_path)
    per_obj = capacity.tto_group_bytes(
        h.settings, h.cfg.nerf.ray_sampler.num_random_rays, 1)
    monkeypatch.setenv("CODENERF_HBM_BUDGET_BYTES",
                       str(int(per_obj / capacity.SAFETY) + 1))
    out = harness.validate_category(h, params, logger, 2, val_iterations=1)
    assert out["num_objects"] == 3 and out["batch_objects"] == 1
    assert "auto-splitting into groups of 1" in capsys.readouterr().out


# ---- capacity, as tests/test_capacity.py pins JAX's ----

def _flagship_settings(compute_dtype="bfloat16", **runtime):
    from codenerf_tpu_torch.config import SRN_CARS_CODE, config_from_dict
    import copy
    d = copy.deepcopy(SRN_CARS_CODE)
    d["runtime"].update(compute_dtype=compute_dtype, **runtime)
    return RenderSettings.from_config(config_from_dict(d))


def test_max_batch_objects_clamps():
    s = _flagship_settings()
    per_obj = capacity.tto_group_bytes(s, 4096, 1)
    assert capacity.tto_group_bytes(s, 4096, 4) == pytest.approx(
        4 * per_obj, rel=1e-9)
    budget = int(4.5 * per_obj / capacity.SAFETY)
    assert capacity.max_batch_objects(s, 4096, 8, budget=budget) == 4
    assert capacity.max_batch_objects(s, 4096, 3, budget=budget) == 3
    # a tiny budget still returns a runnable group size
    assert capacity.max_batch_objects(s, 4096, 8, budget=1) == 1
    assert capacity.max_batch_objects(s, 4096, 0, budget=1) == 1


def test_unknown_budget_passes_through(monkeypatch):
    monkeypatch.delenv("CODENERF_HBM_BUDGET_BYTES", raising=False)
    assert capacity.device_memory_budget("cpu") is None
    assert capacity.max_batch_objects(_flagship_settings(), 4096, 8,
                                      device="cpu") == 8
    monkeypatch.setattr(capacity, "device_memory_budget",
                        lambda device="cuda": None)
    assert capacity.max_batch_objects(_flagship_settings(), 4096, 8) == 8


def test_env_budget_override(monkeypatch):
    monkeypatch.setenv("CODENERF_HBM_BUDGET_BYTES", str(4 * GIB))
    assert capacity.device_memory_budget() == 4 * GIB
    assert capacity.device_memory_budget("cpu") == 4 * GIB


def test_is_oom_error():
    assert capacity.is_oom_error(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert capacity.is_oom_error(RuntimeError(
        "K2 row pass launch failed: CUDA error 2 (out of memory)"))
    assert not capacity.is_oom_error(RuntimeError("shape mismatch"))
    # only the RuntimeError family: another error that mentions memory
    # surfaces instead of halving K
    assert not capacity.is_oom_error(
        ValueError("path '/data/out of memory test' not found"))
    assert not capacity.is_oom_error(
        AssertionError("expected 'CUDA out of memory' in log"))


def test_itemsize_and_path_factor():
    """f32 sizes activations at 4 bytes; each trunk path has its factor,
    and ``fit_act_factor`` inverts the estimate."""
    s16, s32 = _flagship_settings(), _flagship_settings("float32")
    assert capacity.tto_group_bytes(s32, 4096, 4) == pytest.approx(
        2 * capacity.tto_group_bytes(s16, 4096, 4), rel=1e-9)
    fused = _flagship_settings(use_pallas=True, pallas_backward=True)
    for s, path in ((s16, "rays"), (fused, "fused")):
        b1, b2 = (capacity.tto_group_bytes(s, 4096, k) for k in (1, 2))
        assert capacity.fit_act_factor(s, 4096, b1, b2) == pytest.approx(
            capacity.ACT_FACTORS[path], rel=1e-6)
    assert set(capacity.ACT_FACTORS) == {"fused", "fused_recompute",
                                         "hybrid", "rays"}


# ---- the CLI ----

def _saved_checkpoint(synth_root, tmp_path):
    cfg = load_config(BASE, overrides=_overrides(synth_root, tmp_path))
    h = Harness.from_config(cfg, device="cpu")
    state = init_train_state(cfg, h.settings, NUM_OBJECTS, device="cpu")
    state.step = 7
    checkpoint.save_checkpoint(tmp_path / "ckpt", state)
    return tmp_path / "ckpt"


def test_eval_cli_all_objects_on_the_cpu(synth_root, tmp_path, capsys):
    ckpt = _saved_checkpoint(synth_root, tmp_path)
    argv = ["-c", str(BASE), "--load-checkpoint", str(ckpt), "--device",
            "cpu", "--all-objects", "--batch-objects", "2",
            "--num-objects", str(NUM_OBJECTS)] + _overrides(
        synth_root, tmp_path, pose_restarts=2, pose_restart_steps=1)
    out = eval_cli.main(argv)
    printed = capsys.readouterr().out
    assert "Restored checkpoint at step 7" in printed
    assert "category evaluation over 3 objects" in printed
    assert "  object |   PSNR |  SSIM | pose err | dPSNR(GT pose)" in printed
    assert out["num_objects"] == 3


def test_eval_cli_subprocess_exits_zero(synth_root, tmp_path):
    ckpt = _saved_checkpoint(synth_root, tmp_path)
    ov = _overrides(synth_root, tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "codenerf_tpu_torch.eval_cli", "-c",
         str(BASE), "--load-checkpoint", str(ckpt), "--device", "cpu",
         "--batch-objects", "2"] + ov,
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "batched TTO: 2 objects" in res.stdout


def test_eval_cli_defaults_to_cuda_and_refuses_multihost(synth_root,
                                                         tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = _saved_checkpoint(synth_root, tmp_path)
    argv = ["-c", str(BASE), "--load-checkpoint", str(ckpt)] + _overrides(
        synth_root, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.main(argv)
    # --multihost joins torchrun's group, and refuses to run without it
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        eval_cli.main(argv + ["--device", "cpu", "--multihost"])
