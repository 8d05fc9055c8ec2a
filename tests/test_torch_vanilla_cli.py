"""The port's vanilla NeRF entry points on the CPU: ``train_cli`` on
``configs/lego.yml`` (Blender), ``fern.yml`` (LLFF, NDC), ``srn-cars.yml``
and ``srn-chairs.yml`` (SRN) at the tiny widths of ``tests/test_cli.py``
with a validation and a checkpoint, then ``eval_cli`` on lego's
checkpoint;
lego's loss curve over 20 steps against the JAX loop's from one exported
state (the means of the last 10 fine losses within 15%, as in
``tests/test_torch_loop.py``); and vanilla checkpoints across the
packages both ways: the port's ``.ckpt`` read by JAX's
``params_from_torch_checkpoint(model_type="FlexibleNeRFModel")`` (and
its Adam moments by ``moments_from_torch_optimizer``), JAX's
``export_torch_checkpoint`` restored by the port, with equal forwards
(f32, atol 1e-5).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.config import load_config as j_load_config
from codenerf_tpu.models.ray_structured import (apply_flexible_rays as
                                                j_apply_flexible_rays)
from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
from codenerf_tpu.train.torch_import import (moments_from_torch_optimizer,
                                             params_from_torch_checkpoint)
from codenerf_tpu_torch import eval_cli, train_cli
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train import checkpoint, init_train_state
from codenerf_tpu_torch.train.loop import run_training
from tests.torch_port_helpers import F32_ATOL, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["nerf.ray_sampler.num_random_rays=16",
        "nerf.point_sampler.num_coarse=4", "nerf.point_sampler.num_fine=4",
        "models.nerf_coarse.hidden_size=8", "models.nerf_fine.hidden_size=8",
        "nerf.embedder.num_encoding_fn_xyz=2",
        "nerf.embedder.num_encoding_fn_dir=2", "runtime.compute_dtype=float32"]


def _synth(out: Path, *args) -> Path:
    subprocess.run([sys.executable, "tools/make_synth_data.py", "--out",
                    str(out), "--size", "16", *args],
                   check=True, cwd=ROOT, capture_output=True)
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("vanilla")
    return {"lego": _synth(base / "lego", "--format", "blender", "--views",
                           "3", "--val-views", "2"),
            "fern": _synth(base / "fern", "--format", "llff", "--views",
                           "6"),
            "srn-cars": _synth(base / "srn_cars", "--objects", "2",
                               "--views", "3", "--val-views", "2"),
            "srn-chairs": _synth(base / "srn_chairs", "--name", "chairs",
                                 "--objects", "2", "--views", "3",
                                 "--val-views", "2")}


def _records(path: Path, mode: str) -> list:
    return [r for r in map(json.loads, path.read_text().splitlines())
            if r["mode"] == mode]


@pytest.mark.parametrize("name", ["lego", "fern", "srn-cars", "srn-chairs"])
def test_train_cli_runs_the_vanilla_configs(name, trees, tmp_path):
    extra = ["dataset.downsample_factor=1"] if name == "fern" else []
    argv = ["-c", str(ROOT / "configs" / f"{name}.yml"), "--device", "cpu",
            "--max-steps", "3", f"dataset.basedir={trees[name]}",
            f"experiment.logdir={tmp_path}", "experiment.id=v",
            "experiment.print_every=1", "experiment.save_every=3",
            "experiment.validate_every=2", *TINY, *extra]
    train_cli.main(argv)
    train = _records(tmp_path / "v" / "metrics.jsonl", "train")
    val = _records(tmp_path / "v" / "metrics.jsonl", "val")
    assert [r["step"] for r in train] == [1, 2, 3] and len(val) == 1
    assert all(np.isfinite(r["nerf_loss_fine"]) and r["embedding_loss"] == 0
               for r in train)
    assert np.isfinite(val[0]["psnr"])
    assert checkpoint.latest_step(tmp_path / "v" / "checkpoints") == 3
    if name == "lego":
        out = eval_cli.main(argv[:4] + ["--load-checkpoint", str(
            tmp_path / "v" / "checkpoints"), "--rounds", "1"] + argv[6:])
        assert len(out) == 1 and np.isfinite(out[0]["psnr"])
        with pytest.raises(ValueError, match="CodeNeRF"):
            eval_cli.main(argv[:4] + ["--load-checkpoint", str(
                tmp_path / "v" / "checkpoints"), "--all-objects"]
                + argv[6:])


def _lego_overrides(tree, logdir, **extra):
    return [f"dataset.basedir={tree}", f"experiment.logdir={logdir}",
            "experiment.print_every=1", "experiment.save_every=1000",
            "experiment.validate_every=1000000",
            "dataset.train_batch_size=2",
            "nerf.ray_sampler.num_random_rays=32",
            "nerf.point_sampler.num_coarse=8",
            "nerf.point_sampler.num_fine=8",
            "models.nerf_coarse.hidden_size=16",
            "models.nerf_fine.hidden_size=16",
            "nerf.embedder.num_encoding_fn_xyz=4",
            "nerf.embedder.num_encoding_fn_dir=2",
            "optimizer.lr=0.005", "runtime.compute_dtype=float32"] + [
        f"{k}={v}" for k, v in extra.items()]


def _exported_jax_state(tree, tmp_path):
    """A JAX lego state at step 0 saved by orbax and exported to the
    reference ``.ckpt`` layout: (jcfg, js, params, ckpt path)."""
    from codenerf_tpu.train import checkpoint as jcheckpoint
    from codenerf_tpu.train.state import init_train_state as j_init_state
    from codenerf_tpu.train.torch_import import export_torch_checkpoint
    yml = ROOT / "configs" / "lego.yml"
    jcfg = j_load_config(yml, _lego_overrides(tree, tmp_path))
    js = JRenderSettings.from_config(jcfg)
    jstate, _ = j_init_state(jax.random.PRNGKey(3), jcfg, js, 1)
    jcheckpoint.save_checkpoint(tmp_path / "init", jstate)
    export_torch_checkpoint(str(tmp_path / "init"), jcfg, js,
                            str(tmp_path / "init.ckpt"))
    return jcfg, js, jstate.params, tmp_path / "init.ckpt"


def test_lego_loss_tracks_the_jax_loop(trees, tmp_path):
    """Both loops start from JAX's step-0 state (the port's through its
    ``.ckpt`` export) and draw the same image batches; the ray draws
    differ."""
    from codenerf_tpu.train.loop import run_training as j_run_training
    yml = ROOT / "configs" / "lego.yml"
    _, _, _, ckpt = _exported_jax_state(trees["lego"], tmp_path)
    j_run_training(j_load_config(yml, _lego_overrides(
        trees["lego"], tmp_path, **{"experiment.id": "jax",
                                    "runtime.load_checkpoint":
                                        tmp_path / "init"})), max_steps=20)
    run_training(load_config(yml, _lego_overrides(
        trees["lego"], tmp_path, **{"experiment.id": "port",
                                    "runtime.load_checkpoint": ckpt})),
        max_steps=20, device="cpu")
    jl = [r["nerf_loss_fine"] for r in _records(
        tmp_path / "jax" / "metrics.jsonl", "train")]
    pl = [r["nerf_loss_fine"] for r in _records(
        tmp_path / "port" / "metrics.jsonl", "train")]
    assert len(jl) == len(pl) == 20
    j_tail, p_tail = np.mean(jl[-10:]), np.mean(pl[-10:])
    print(f"lego fine loss, first / mean of the last 10: JAX {jl[0]:.5f} / "
          f"{j_tail:.5f}, port {pl[0]:.5f} / {p_tail:.5f}")
    assert j_tail < jl[0] and p_tail < pl[0]
    assert abs(p_tail - j_tail) <= 0.15 * j_tail


def _forward_both(params, js, models, seed=0):
    """Both packages' fine forwards on one input."""
    rng = np.random.default_rng(seed)
    cfg = js.fine_cfg
    xyz = rng.normal(size=(4, 5, cfg.dim_xyz)).astype(np.float32)
    dirs = rng.normal(size=(4, cfg.dim_dir)).astype(np.float32)
    want = j_apply_flexible_rays(params["fine"], cfg, jnp.asarray(xyz),
                                 jnp.asarray(dirs))
    with torch.no_grad():
        got = models["fine"](t(xyz), t(dirs))
    return got.numpy(), np.asarray(want)


def test_vanilla_checkpoints_cross_both_ways(trees, tmp_path):
    yml = ROOT / "configs" / "lego.yml"
    # JAX -> port: JAX's exporter, restored by the port
    jcfg, js, jparams, ckpt = _exported_jax_state(trees["lego"], tmp_path)
    cfg = load_config(yml, _lego_overrides(trees["lego"], tmp_path))
    ps = RenderSettings.from_config(cfg)
    state = init_train_state(cfg, ps, 1, seed=9, device="cpu")
    checkpoint.load_checkpoint(ckpt, state)
    assert state.tables is None and not state.optimizer.state
    np.testing.assert_allclose(*_forward_both(jparams, js, state.models),
                               atol=F32_ATOL)

    # port -> JAX: two Adam steps, the port's .ckpt, JAX's importer
    gen = torch.Generator().manual_seed(0)
    for p in (q for m in state.models.values() for q in m.parameters()):
        p.grad = torch.randn(p.shape, generator=gen)
    for _ in range(2):
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
    path = checkpoint.save_checkpoint(tmp_path / "port", state)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert raw["model_embedding_state_dict"] == {}
    assert len(raw["optimizer_state_dict"]["param_groups"]) == 1
    params, step = params_from_torch_checkpoint(
        raw, model_type="FlexibleNeRFModel")
    assert step == 2
    np.testing.assert_allclose(*_forward_both(params, js, state.models, 1),
                               atol=F32_ATOL)
    mu, nu = moments_from_torch_optimizer(raw["optimizer_state_dict"],
                                          params, "FlexibleNeRFModel")
    adam = state.optimizer.state[state.models["fine"].layers_xyz[4].weight]
    np.testing.assert_allclose(np.asarray(mu["fine"]["layers_xyz"][4]["w"]),
                               adam["exp_avg"].numpy().T, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(nu["fine"]["layer_dir1"]["w"]),
                               state.optimizer.state[
                                   state.models["fine"].layers_dir[0].weight
                               ]["exp_avg_sq"].numpy().T, rtol=1e-6)
    # and the port resumes its own checkpoint bit for bit
    again = init_train_state(cfg, ps, 1, seed=10, device="cpu")
    checkpoint.restore_checkpoint(tmp_path / "port", again)
    for a, b in zip(state.models["fine"].parameters(),
                    again.models["fine"].parameters()):
        assert torch.equal(a, b)
    assert again.step == 2 and again.optimizer.state
