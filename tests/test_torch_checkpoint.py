"""Port checkpoints in the reference ``.ckpt`` layout, held against the
JAX package's importer and exporter (``train/torch_import.py``) at the
small widths of ``tests/test_torch_train.py``, f32 on the CPU.

  * port -> JAX: the JAX importer reads a port checkpoint's parameters
    and Adam moments back exactly (transposed as it transposes them);
  * JAX -> port: a JAX Orbax checkpoint exported to ``.ckpt`` restores
    into the port with equal weights, fresh moments and the schedule at
    its step, and one step from there agrees with JAX's step at
    ``test_torch_train.py``'s tolerance (losses rtol 1e-5, gradients atol
    1e-5);
  * a save / restore round trip continues bit-identically;
  * ``max_to_keep`` and ``latest_step``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.core.geometry import select_ray_indices as j_select
from codenerf_tpu.train import checkpoint as jcheckpoint
from codenerf_tpu.train.optim import lr_at_step as j_lr_at_step
from codenerf_tpu.train.step import make_train_step as j_make_train_step
from codenerf_tpu.train.torch_import import (export_torch_checkpoint,
                                             moments_from_torch_optimizer,
                                             params_from_torch_checkpoint)
from codenerf_tpu_torch.config import config_from_dict
from codenerf_tpu_torch.models.mlp import LAYER_NAMES
from codenerf_tpu_torch.train import checkpoint, init_train_state
from codenerf_tpu_torch.train import lr_at_step, make_train_step
from tests.test_torch_train import (H, LAMBDA, N_RAYS, NUM_OBJECTS, W,
                                    _both, _cfg_dict, _data,
                                    _jax_loss_and_grads, _port_grads,
                                    check_step)
from tests.torch_port_helpers import t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)


def _inputs(seed=6):
    dirs, pose, pixels, ids = _data(seed)
    return t(dirs), t(pose), t(pixels), torch.from_numpy(ids)


def _port_state(seed=0):
    cfg = config_from_dict(_cfg_dict("float32"))
    from codenerf_tpu_torch.pipeline import RenderSettings
    settings = RenderSettings.from_config(cfg)
    return settings, init_train_state(cfg, settings, NUM_OBJECTS, seed=seed,
                                      device="cpu")


def _steps(settings, state, n, perturb=True, seed=0):
    step = make_train_step(settings, state, N_RAYS, LAMBDA, perturb)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n):
        m = step(*_inputs(), gen)
    return m


def _tensors(state) -> dict:
    """Every tensor of a train state, by name, and the scalars."""
    out = {f"{k}.{n}": p.detach() for k, mod in
           {**state.models, "tables": state.tables}.items()
           for n, p in mod.named_parameters()}
    for i, (p, s) in enumerate(state.optimizer.state.items()):
        for k, v in s.items():
            out[f"opt.{i}.{k}"] = v
    out["lr"] = torch.tensor([g["lr"] for g in state.optimizer.param_groups],
                             dtype=torch.float64)
    sched = state.scheduler.state_dict()
    out["sched"] = torch.tensor([sched["last_epoch"], sched["_step_count"],
                                 state.step])
    return out


def _assert_bit_identical(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_port_checkpoint_reads_back_through_the_jax_importer(tmp_path):
    settings, state = _port_state(seed=1)
    _steps(settings, state, 3)
    path = checkpoint.save_checkpoint(tmp_path, state)
    assert path == tmp_path / "3.ckpt"
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert set(ckpt) == {"iter", "model_nerf_coarse_state_dict",
                         "model_nerf_fine_state_dict",
                         "model_embedding_state_dict",
                         "optimizer_state_dict", "scheduler_state_dict"}
    params, it = params_from_torch_checkpoint(ckpt, "CodeNeRFModel")
    assert it == 3
    mu, nu = moments_from_torch_optimizer(ckpt["optimizer_state_dict"],
                                          params, "CodeNeRFModel")
    opt_state = state.optimizer.state
    for key in ("coarse", "fine"):
        for name in LAYER_NAMES:
            layer = getattr(state.models[key], name)
            for leaf, p in (("w", layer.weight), ("b", layer.bias)):
                want = p.detach().numpy()
                m = opt_state[p]["exp_avg"].numpy()
                v = opt_state[p]["exp_avg_sq"].numpy()
                if leaf == "w":
                    want, m, v = want.T, m.T, v.T
                np.testing.assert_array_equal(
                    np.asarray(params[key][name][leaf]), want)
                np.testing.assert_array_equal(
                    np.asarray(mu[key][name][leaf]), m)
                np.testing.assert_array_equal(
                    np.asarray(nu[key][name][leaf]), v)
    for leaf, p in (("shape", state.tables.shape_embedding.weight),
                    ("texture", state.tables.texture_embedding.weight)):
        np.testing.assert_array_equal(np.asarray(params["codes"][leaf]),
                                      p.detach().numpy())
        np.testing.assert_array_equal(np.asarray(mu["codes"][leaf]),
                                      opt_state[p]["exp_avg"].numpy())
        np.testing.assert_array_equal(np.asarray(nu["codes"][leaf]),
                                      opt_state[p]["exp_avg_sq"].numpy())


def test_jax_export_restores_into_the_port_and_steps_alike(tmp_path):
    jcfg, js, ps, jstate, jopt, _ = _both("float32", seed=5)
    jstep = j_make_train_step(js, jopt, N_RAYS, LAMBDA, False)
    data = tuple(map(jnp.asarray, _data(6)))
    for k in range(2):
        jstate, _ = jstep(jstate, *data, jax.random.PRNGKey(20 + k))
    jcheckpoint.save_checkpoint(tmp_path / "orbax", jstate)
    (tmp_path / "port").mkdir()
    assert export_torch_checkpoint(str(tmp_path / "orbax"), jcfg, js,
                                   str(tmp_path / "port" / "2.ckpt")) == 2

    _, state = _port_state(seed=99)
    checkpoint.restore_checkpoint(tmp_path / "port", state)
    assert state.step == 2 and not state.optimizer.state
    params = jax.tree.map(np.asarray, jstate.params)
    for key in ("coarse", "fine"):
        for name in LAYER_NAMES:
            layer = getattr(state.models[key], name)
            np.testing.assert_array_equal(layer.weight.detach().numpy().T,
                                          params[key][name]["w"])
            np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                          params[key][name]["b"])
    np.testing.assert_array_equal(
        state.tables.shape_embedding.weight.detach().numpy(),
        params["codes"]["shape"])
    opt = jcfg.optimizer
    lrs = [g["lr"] for g in state.optimizer.param_groups]
    assert lrs == [j_lr_at_step(lr, opt.scheduler_gamma,
                                opt.scheduler_step_size, 2)
                   for lr in (opt.lr, opt.lr, opt.resolved_embedding_lr)]

    # one step from the restored weights: JAX's loss and gradients
    k_sel, k_render = jax.random.split(jax.random.PRNGKey(13))
    np_data = _data(7)
    losses, want = _jax_loss_and_grads(js, jstate.params, np_data, k_sel,
                                       k_render)
    inds = np.array(j_select(k_sel, H * W, N_RAYS, 2))
    dirs, pose, pixels, ids = np_data
    m = make_train_step(ps, state, N_RAYS, LAMBDA, False)(
        t(dirs), t(pose), t(pixels), torch.from_numpy(ids), None,
        inds=torch.from_numpy(inds))
    check_step(m, losses, _port_grads(state), want, "float32")
    assert state.step == 3


def test_save_restore_continues_bit_identically(tmp_path):
    settings, a = _port_state(seed=1)
    _steps(settings, a, 3)
    checkpoint.save_checkpoint(tmp_path, a)
    _, b = _port_state(seed=2)
    checkpoint.restore_checkpoint(tmp_path, b)
    _assert_bit_identical(_tensors(a), _tensors(b))
    opt = config_from_dict(_cfg_dict("float32")).optimizer
    assert b.optimizer.param_groups[0]["lr"] == lr_at_step(
        opt.lr, opt.scheduler_gamma, opt.scheduler_step_size, 3)
    # one more step each, with jitter, from identically seeded generators
    _steps(settings, a, 1, seed=7)
    _steps(settings, b, 1, seed=7)
    _assert_bit_identical(_tensors(a), _tensors(b))


def test_max_to_keep_latest_step_and_load_checkpoint(tmp_path):
    settings, state = _port_state(seed=3)
    assert checkpoint.latest_step(tmp_path / "missing") is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(tmp_path, state)
    step = make_train_step(settings, state, N_RAYS, LAMBDA, True)
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        step(*_inputs(), gen)
        checkpoint.save_checkpoint(tmp_path, state)
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == [
        "3.ckpt", "4.ckpt", "5.ckpt"]
    assert checkpoint.latest_step(tmp_path) == 5
    _, other = _port_state(seed=4)
    checkpoint.load_checkpoint(tmp_path / "4.ckpt", other)
    assert other.step == 4
    checkpoint.load_checkpoint(tmp_path, other)
    _assert_bit_identical(_tensors(state), _tensors(other))


def test_reference_ddp_prefix_and_shape_mismatch(tmp_path):
    _, state = _port_state(seed=5)
    ckpt = checkpoint.state_dict(state)
    fine = ckpt["model_nerf_fine_state_dict"]
    ckpt["model_nerf_fine_state_dict"] = {f"module.{k}": v
                                          for k, v in fine.items()}
    # the reference's own layout: no scheduler, the optimizer left out
    ckpt["iter"] = 7
    ckpt["optimizer_state_dict"] = {}
    del ckpt["scheduler_state_dict"]
    torch.save(ckpt, tmp_path / "7.ckpt")
    _, other = _port_state(seed=6)
    checkpoint.load_checkpoint(tmp_path / "7.ckpt", other)
    assert other.step == 7 and other.scheduler.last_epoch == 7
    torch.testing.assert_close(other.models["fine"].fc_rgb.weight,
                               state.models["fine"].fc_rgb.weight,
                               rtol=0, atol=0)
    ckpt["model_embedding_state_dict"]["shape_embedding.weight"] = \
        torch.zeros(NUM_OBJECTS + 1, 16)
    torch.save(ckpt, tmp_path / "8.ckpt")
    with pytest.raises(RuntimeError, match="size mismatch"):
        checkpoint.load_checkpoint(tmp_path / "8.ckpt", other)
