"""The port on trained weights: the committed checkpoint
``assets/checkpoints/flagship-v4-cars-42100.tar.gz`` (the JAX package's
flagship CodeNeRF, hidden 256, 400-row code tables, 42.1k steps), through
its reference ``.ckpt`` export, against the JAX package.

  * The fixture ``codenerf_tpu_torch/fixtures/flagship-v4-cars-42100.ckpt``
    (the file the card's eval runs) equals a fresh export tensor for
    tensor.
  * 1024 rays of a val object of the v4 lineage's generator, rendered at
    the flagship YAML's settings (bf16, the ray-structured path): port
    against JAX, coarse and fine, max abs <= 2e-3 and >= 80 dB PSNR.
  * One batched TTO step (K = 2, 256 rays each, AdamW at val_lr) with
    JAX's draws fed through ``inds=`` / ``draws=``: the loss within 1e-3
    relative and the step's gradients and variable updates at
    ``tests/test_torch_tto.py``'s bf16 relRMS 1e-2.
"""

import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from codenerf_tpu.config import load_config as j_load_config
from codenerf_tpu.core.geometry import ray_bundle as j_ray_bundle
from codenerf_tpu.core.geometry import select_ray_indices as j_select
from codenerf_tpu.data import build_dataset as j_build_dataset
from codenerf_tpu.eval import tto as jtto
from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
from codenerf_tpu.pipeline import render_rays as j_render_rays
from codenerf_tpu.train.checkpoint import restore_checkpoint as j_restore
from codenerf_tpu.train.state import init_train_state as j_init_state
from codenerf_tpu.train.torch_import import export_torch_checkpoint
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.core.geometry import pixel_directions, ray_bundle
from codenerf_tpu_torch.eval import tto
from codenerf_tpu_torch.pipeline import RenderSettings, render_rays
from codenerf_tpu_torch.train import init_train_state
from codenerf_tpu_torch.train.checkpoint import load_checkpoint
from codenerf_tpu_torch.train.optim import build_tto_optimizer
from codenerf_tpu_torch.weights import tto_variables_from_jax
from tests.torch_port_helpers import BF16_REL_RMS, rel_rms, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TAR = ROOT / "assets/checkpoints/flagship-v4-cars-42100.tar.gz"
FIXTURE = ROOT / "codenerf_tpu_torch/fixtures/flagship-v4-cars-42100.ckpt"
CONFIG = ROOT / "configs/srn-cars-code.yml"
NUM_OBJECTS = 400
N_RAYS = 1024
TTO_RAYS = 256


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX config, settings, params; port config, settings, state; the
    fresh export's path; a val dataset of the v4 generator) on the CPU."""
    tmp = tmp_path_factory.mktemp("trained")
    with tarfile.open(TAR) as tar:
        tar.extractall(tmp / "ckpt", filter="data")
    data = tmp / "data" / "srn_cars"
    subprocess.run(
        [sys.executable, "tools/make_synth_data.py", "--out", str(data),
         "--name", "cars", "--style", "proc", "--objects", "2",
         "--val-objects", "2", "--views", "1", "--val-views", "1",
         "--size", "128", "--seed", "7", "--only-stage", "val"],
        check=True, cwd=ROOT, capture_output=True)
    overrides = [f"dataset.basedir={data}"]
    jcfg = j_load_config(str(CONFIG), overrides=overrides)
    js = JRenderSettings.from_config(jcfg)
    out = tmp / "export.ckpt"
    step = export_torch_checkpoint(str(tmp / "ckpt"), jcfg, js, str(out))
    assert step == 42100
    jstate, _ = j_init_state(jax.random.PRNGKey(0), jcfg, js, NUM_OBJECTS)
    jstate = j_restore(str(tmp / "ckpt"), jstate)
    pcfg = load_config(str(CONFIG), overrides=overrides)
    ps = RenderSettings.from_config(pcfg)
    state = init_train_state(pcfg, ps, NUM_OBJECTS, device="cpu")
    load_checkpoint(FIXTURE, state)
    val = j_build_dataset(jcfg.dataset, "val")
    return {"jcfg": jcfg, "js": js, "params": jstate.params, "pcfg": pcfg,
            "ps": ps, "state": state, "export": out, "val": val}


def test_fixture_equals_a_fresh_export(trained):
    want = torch.load(trained["export"], map_location="cpu",
                      weights_only=True)
    got = torch.load(FIXTURE, map_location="cpu", weights_only=True)
    assert got.keys() == want.keys() and got["iter"] == want["iter"] == 42100
    for key in ("model_nerf_coarse_state_dict", "model_nerf_fine_state_dict",
                "model_embedding_state_dict"):
        assert got[key].keys() == want[key].keys(), key
        for name, v in want[key].items():
            assert torch.equal(got[key][name], v), (key, name)
    assert trained["state"].step == 42100
    assert trained["state"].tables.shape_embedding.weight.shape == (
        NUM_OBJECTS, 256)


def _psnr(got, want):
    mse = np.mean((np.asarray(got, np.float64)
                   - np.asarray(want, np.float64)) ** 2)
    return -10.0 * np.log10(max(mse, 1e-30))


def test_render_matches_jax_on_trained_weights(trained):
    """1024 rays of val object 0 from its own camera, codes of table row
    3, at the flagship YAML's settings."""
    sample = trained["val"][0]
    rng = np.random.default_rng(0)
    dirs = np.asarray(pixel_directions(
        *sample["color"].shape[:2], t(sample["intrinsic"])))
    pick = rng.choice(dirs.shape[0] * dirs.shape[1], N_RAYS, replace=False)
    d = dirs.reshape(-1, 3)[pick]
    pose = sample["pose"].astype(np.float32)
    jro, jrd = j_ray_bundle(jnp.asarray(d)[None], jnp.asarray(pose)[None])
    codes = trained["params"]["codes"]
    zs = jnp.broadcast_to(codes["shape"][3], (N_RAYS, 256))
    zt = jnp.broadcast_to(codes["texture"][3], (N_RAYS, 256))
    jc, jf = j_render_rays(trained["params"], trained["js"],
                           jro.reshape(-1, 3), jrd.reshape(-1, 3), zs, zt,
                           None, False)
    ro, rd = ray_bundle(t(d)[None], t(pose)[None])
    tables = trained["state"].tables
    pzs = tables.shape_embedding.weight[3].detach().expand(N_RAYS, 256)
    pzt = tables.texture_embedding.weight[3].detach().expand(N_RAYS, 256)
    pc, pf = render_rays(trained["state"].models, trained["ps"],
                         ro.reshape(-1, 3), rd.reshape(-1, 3), pzs, pzt)
    for name, got, want in (("coarse", pc.rgb, jc.rgb),
                            ("fine", pf.rgb, jf.rgb)):
        got, want = got.numpy(), np.asarray(want, np.float32)
        assert np.all(np.isfinite(got)), name
        assert np.max(np.abs(got - want)) <= 2e-3, name
        assert _psnr(got, want) >= 80.0, (name, _psnr(got, want))


def _jax_draws(js, key, K, H, W):
    """The port's ``inds`` [K, R] and ``draws`` from a batched TTO step's
    key, split as the JAX step splits it."""
    k_sel, k_render = jax.random.split(key)
    inds = np.array(j_select(k_sel, H * W, TTO_RAYS, K))
    k1, k2 = jax.random.split(k_render)
    n = K * TTO_RAYS
    draws = {"t_rand": t(jax.random.uniform(k1, (n, js.num_coarse))),
             "u": t(jax.random.uniform(k2, (n, js.num_fine)))}
    return torch.from_numpy(inds).long(), draws


def _grad_catcher():
    """An optax transformation whose state is the gradient it was given
    (``tests/test_torch_tto.py``'s)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def test_batched_tto_step_matches_jax_on_trained_weights(trained):
    jcfg, js, params = trained["jcfg"], trained["js"], trained["params"]
    lam = jcfg.experiment.regularizer_lambda
    val = trained["val"]
    samples = [val[i] for i in range(2)]
    targets = np.stack([s["color"] for s in samples]).astype(np.float32)
    poses = np.stack([s["pose"] for s in samples]).astype(np.float32)
    H, W = targets.shape[1:3]
    dirs = np.asarray(pixel_directions(H, W, t(samples[0]["intrinsic"])))
    key = jax.random.PRNGKey(11)
    args = (jnp.asarray(dirs), jnp.asarray(targets), jnp.asarray(poses), key)

    jst, jopt = jtto.init_batched_tto_state(params["codes"], jcfg.optimizer,
                                            2)
    jvars = jax.tree.map(np.asarray, jst.variables)
    jnew, jm = jtto.make_batched_tto_step(js, jopt, TTO_RAYS, lam, True)(
        jst, params, *args)
    catcher = _grad_catcher()
    cst = jtto.TTOState(jax.tree.map(jnp.array, jst.variables),
                        catcher.init(jst.variables), jnp.zeros((), jnp.int32))
    jgrads, _ = jtto.make_batched_tto_step(js, catcher, TTO_RAYS, lam, True)(
        cst, params, *args)
    jgrads = jax.tree.map(np.asarray, jgrads.opt_state)

    variables = tto_variables_from_jax(jvars, "cpu")
    st = tto.TTOState(variables, build_tto_optimizer(
        trained["pcfg"].optimizer, variables))
    inds, draws = _jax_draws(js, key, 2, H, W)
    step = tto.make_batched_tto_step(trained["ps"], st.optimizer, TTO_RAYS,
                                     lam, True, "cpu")
    before = {k: v.detach().clone() for k, v in st.variables.items()}
    st, m = step(st, trained["state"].models, t(dirs), t(targets), t(poses),
                 None, inds=inds, draws=draws)
    np.testing.assert_allclose(m.loss.numpy(), np.asarray(jm.loss),
                               rtol=1e-3)
    for k, v in st.variables.items():
        grad = v.grad.numpy()
        assert np.all(np.isfinite(grad)), k
        assert rel_rms(grad, jgrads[k]) <= BF16_REL_RMS, (
            k, rel_rms(grad, jgrads[k]))
        upd = (v.detach() - before[k]).numpy()
        want = np.asarray(jnew.variables[k]) - jvars[k]
        assert rel_rms(upd, want) <= BF16_REL_RMS, (k, rel_rms(upd, want))
