"""Int8 serving through the port's entry points on the CPU, against the
JAX package: ``harness.validate`` (CodeNeRF and a vanilla model),
``validate_batched`` and ``validate_category`` with
``runtime.int8_serving`` on ``tests/test_torch_eval.py``'s 12 x 12 tree
(every TTO step draws every pixel, so both packages optimise the same
problem), the eval CLI in-process with the override, and the committed
``flagship-v4-cars-42100`` weights.

  * The int8 keys, the table's ``int8 PSNR`` column and the "val-int8"
    records are JAX's; ``psnr_int8`` within 0.05 dB of JAX's and
    ``ssim_int8`` within 1e-3 (measured: <= 2.3e-5 dB and 1.4e-6).
  * 1024 rays of the trained weights at the flagship YAML's settings
    (bf16), rendered through the int8 path by both packages from JAX's
    calibration and buffers (``weights.quantized_from_jax``): >= 60 dB
    coarse and fine (measured: 105.42 and 88.87 dB).
"""

import json
import tarfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu import harness as jharness
from codenerf_tpu.config import load_config as j_load_config
from codenerf_tpu.core.geometry import ray_bundle as j_ray_bundle
from codenerf_tpu.models.quantized import quantize_for_serving as j_quantize
from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
from codenerf_tpu.pipeline import render_rays as j_render_rays
from codenerf_tpu.train.checkpoint import restore_checkpoint as j_restore
from codenerf_tpu.train.state import init_train_state as j_init_state
from codenerf_tpu.utils.logging import MetricLogger as JMetricLogger
from codenerf_tpu_torch import eval_cli, harness
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.core.geometry import (pixel_directions,
                                              pose_spherical, ray_bundle)
from codenerf_tpu_torch.harness import Harness
from codenerf_tpu_torch.models import quantized
from codenerf_tpu_torch.pipeline import RenderSettings, render_rays
from codenerf_tpu_torch.train import init_train_state
from codenerf_tpu_torch.train.checkpoint import load_checkpoint
from codenerf_tpu_torch.utils.logging import MetricLogger
from codenerf_tpu_torch.weights import params_from_jax, quantized_from_jax
from tests.test_torch_eval import (BASE, NUM_OBJECTS, ROOT, _both,
                                   _overrides, _saved_checkpoint,
                                   synth_root)  # noqa: F401 (a fixture)
from tests.test_torch_trained import CONFIG, FIXTURE, TAR
from tests.test_torch_trained import NUM_OBJECTS as TRAINED_OBJECTS
from tests.torch_port_helpers import t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

INT8 = ["runtime.int8_serving=True"]
PSNR_DB = 0.05
SSIM_ABS = 1e-3
TRAINED_PSNR = 60.0
N_RAYS = 1024


def _loggers(tmp_path):
    return (JMetricLogger(tmp_path / "j", enable_tensorboard=False),
            MetricLogger(tmp_path / "p", enable_tensorboard=False))


def _modes(path):
    return [json.loads(x)["mode"] for x in
            (path / "metrics.jsonl").read_text().splitlines()]


def _int8_both(synth_root, tmp_path, *extra):
    """``tests/test_torch_eval.py``'s ``_both`` with int8 serving on (and
    ``extra`` overrides) in both harnesses."""
    _, jparams, _, params = _both(synth_root, tmp_path)
    ov = _overrides(synth_root, tmp_path) + INT8 + list(extra)
    return (jharness.Harness.from_config(
                j_load_config(str(BASE), overrides=ov),
                make_devices_mesh=False), jparams,
            Harness.from_config(load_config(BASE, overrides=ov),
                                device="cpu"), params)


def _int8_close(got, want):
    assert abs(got["psnr_int8"] - want["psnr_int8"]) <= PSNR_DB, (
        got["psnr_int8"], want["psnr_int8"])
    assert abs(got["ssim_int8"] - want["ssim_int8"]) <= SSIM_ABS, (
        got["ssim_int8"], want["ssim_int8"])
    assert np.isfinite(got["psnr_int8"])


@pytest.mark.parametrize("extra", [[], ["runtime.int8_encode=True"]],
                         ids=["trunk", "encode"])
def test_validate_int8_matches_jax(synth_root, tmp_path, extra):
    jh, jparams, h, params = _int8_both(synth_root, tmp_path, *extra)
    jlog, plog = _loggers(tmp_path)
    want = jharness.validate(jh, jparams, jlog, 0)
    got = harness.validate(h, params, plog, 0)
    jlog.close()
    plog.close()
    assert set(got) == set(want) == {"loss", "psnr", "ssim", "psnr_int8",
                                     "ssim_int8"}
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    _int8_close(got, want)
    assert _modes(tmp_path / "p") == _modes(tmp_path / "j")
    assert _modes(tmp_path / "p")[-2:] == ["val", "val-int8"]


def test_validate_int8_vanilla_matches_jax(synth_root, tmp_path):
    """srn-cars.yml (FlexibleNeRF on the SRN tree) renders at the val
    view's true pose, full precision and int8."""
    ov = [f"dataset.basedir={synth_root}", f"experiment.logdir={tmp_path}",
          "experiment.id=vanilla", "models.nerf_coarse.hidden_size=32",
          "models.nerf_fine.hidden_size=32",
          "nerf.point_sampler.num_coarse=8", "nerf.point_sampler.num_fine=8",
          "nerf.embedder.num_encoding_fn_xyz=4",
          "nerf.embedder.num_encoding_fn_dir=2",
          "nerf.validation.chunksize=64", "runtime.compute_dtype=float32",
          *INT8]
    yml = ROOT / "configs" / "srn-cars.yml"
    jcfg = j_load_config(str(yml), overrides=ov)
    jh = jharness.Harness.from_config(jcfg, make_devices_mesh=False)
    jstate, _ = j_init_state(jax.random.PRNGKey(2), jcfg, jh.settings, 1)
    cfg = load_config(yml, overrides=ov)
    h = Harness.from_config(cfg, device="cpu")
    state = init_train_state(cfg, h.settings, 1, device="cpu")
    params_from_jax(state, jax.tree.map(np.asarray, jstate.params))
    jlog, plog = _loggers(tmp_path)
    want = jharness.validate(jh, jstate.params, jlog, 0)
    got = harness.validate(h, dict(state.models), plog, 0)
    assert not h.has_codes
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    _int8_close(got, want)
    plog.close()
    assert _modes(tmp_path / "p") == ["val", "val-int8"]


def test_validate_batched_int8_matches_jax(synth_root, tmp_path):
    jh, jparams, h, params = _int8_both(synth_root, tmp_path)
    jlog, plog = _loggers(tmp_path)
    want = jharness.validate_batched(jh, jparams, jlog, 2)
    got = harness.validate_batched(h, params, plog, 2)
    for g, w in zip(got["per_object"], want["per_object"]):
        assert set(g) == set(w) and {"psnr_int8", "ssim_int8"} <= set(g)
        assert abs(g["psnr"] - w["psnr"]) <= 1e-3
        _int8_close(g, w)


def test_validate_category_int8_matches_jax(synth_root, tmp_path, capsys):
    jh, jparams, h, params = _int8_both(synth_root, tmp_path)
    jlog, plog = _loggers(tmp_path)
    want = jharness.validate_category(jh, jparams, jlog, 2, val_iterations=1)
    jprinted = capsys.readouterr().out
    got = harness.validate_category(h, params, plog, 2, val_iterations=1)
    printed = capsys.readouterr().out
    header = ("  object |   PSNR |  SSIM | pose err | dPSNR(GT pose) "
              "| int8 PSNR")
    assert header in printed and header in jprinted
    assert got["num_objects"] == want["num_objects"] == 3
    for k in ("psnr_int8_mean", "ssim_int8_mean"):
        assert k in got and k in want
    _int8_close({"psnr_int8": got["psnr_int8_mean"],
                 "ssim_int8": got["ssim_int8_mean"]},
                {"psnr_int8": want["psnr_int8_mean"],
                 "ssim_int8": want["ssim_int8_mean"]})
    for g, w in zip(got["per_object"], want["per_object"]):
        _int8_close(g, w)


def test_eval_cli_int8_in_process(synth_root, tmp_path, capsys):
    ckpt = _saved_checkpoint(synth_root, tmp_path)
    before = quantized._qdot.calls
    out = eval_cli.main(
        ["-c", str(BASE), "--load-checkpoint", str(ckpt), "--device", "cpu",
         "--all-objects", "--batch-objects", "2", "--num-objects",
         str(NUM_OBJECTS)] + _overrides(synth_root, tmp_path) + INT8
        + ["runtime.int8_encode=True", "experiment.val_iterations=1"])
    printed = capsys.readouterr().out
    assert "| int8 PSNR" in printed
    assert out["num_objects"] == 3
    assert np.isfinite(out["psnr_int8_mean"])
    assert all(np.isfinite(r["ssim_int8"]) for r in out["per_object"])
    # 4 objects (one group padded) x 2 passes x 7 products (encode stream)
    # x 3 chunks of 64 rays
    assert quantized._qdot.calls - before == 4 * 2 * 7 * 3


@pytest.fixture(scope="module")
def trained_weights(tmp_path_factory):
    """JAX's restored flagship parameters and the port's models from the
    committed fixture, on the CPU."""
    tmp = tmp_path_factory.mktemp("trained_int8")
    with tarfile.open(TAR) as tar:
        tar.extractall(tmp / "ckpt", filter="data")
    jcfg = j_load_config(str(CONFIG))
    js = JRenderSettings.from_config(jcfg)
    jstate, _ = j_init_state(jax.random.PRNGKey(0), jcfg, js,
                             TRAINED_OBJECTS)
    jstate = j_restore(str(tmp / "ckpt"), jstate)
    pcfg = load_config(str(CONFIG))
    ps = RenderSettings.from_config(pcfg)
    state = init_train_state(pcfg, ps, TRAINED_OBJECTS, device="cpu")
    load_checkpoint(FIXTURE, state)
    return js, jstate.params, ps, state


def test_int8_render_matches_jax_on_trained_weights(trained_weights):
    """1024 rays of a 128 x 128 SRN camera at theta 1.2, phi 0.6, rho 1.3
    with code row 3: JAX calibrates and quantizes on them, both packages
    render through the int8 path from those buffers."""
    js, params, ps, state = trained_weights
    intr = torch.eye(4)
    intr[0, 0] = intr[1, 1] = 131.25
    intr[0, 2] = intr[1, 2] = 64.0
    dirs = pixel_directions(128, 128, intr).numpy()
    pick = np.random.default_rng(0).choice(128 * 128, N_RAYS, replace=False)
    d = dirs.reshape(-1, 3)[pick]
    pose = pose_spherical(1.2, 0.6, 1.3).numpy()
    jro, jrd = j_ray_bundle(jnp.asarray(d)[None], jnp.asarray(pose)[None])
    jro, jrd = jro.reshape(-1, 3), jrd.reshape(-1, 3)
    codes = params["codes"]
    zs = jnp.broadcast_to(codes["shape"][3], (N_RAYS, 256))
    zt = jnp.broadcast_to(codes["texture"][3], (N_RAYS, 256))
    jqp = j_quantize({"coarse": params["coarse"], "fine": params["fine"]},
                     js, jro, jrd, zs, zt)
    jc, jf = j_render_rays(jqp, js, jro, jrd, zs, zt, None, False)
    qm = quantized_from_jax(jax.tree.map(np.asarray, jqp), state.models)
    ro, rd = ray_bundle(t(d)[None], t(pose)[None])
    tables = state.tables
    pzs = tables.shape_embedding.weight[3].detach().expand(N_RAYS, 256)
    pzt = tables.texture_embedding.weight[3].detach().expand(N_RAYS, 256)
    pc, pf = render_rays(qm, ps, ro.reshape(-1, 3), rd.reshape(-1, 3), pzs,
                         pzt)
    for name, got, want in (("coarse", pc.rgb, jc.rgb),
                            ("fine", pf.rgb, jf.rgb)):
        got, want = got.numpy(), np.asarray(want, np.float64)
        assert np.all(np.isfinite(got)), name
        mse = np.mean((got.astype(np.float64) - want) ** 2)
        psnr = -10.0 * np.log10(max(mse, 1e-30))
        assert psnr >= TRAINED_PSNR, (name, psnr)
