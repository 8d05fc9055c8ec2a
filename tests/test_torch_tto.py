"""Port parity for test-time optimization (``eval/tto.py``): the single
and batched TTO steps of codenerf_tpu_torch on the CPU against the JAX
package's, at hidden 32, codes 16, 4 xyz bands, 16 coarse + 8 fine
samples, 8x8 targets and 32 rays, jitter on.

Both sides take the same draws: the port is fed JAX's ray indices and
jitter (split from the step's key as JAX splits it).  The JAX gradients
are exact: its step runs with an optimizer whose state is the gradient
it was given (``_grad_catcher``), so nothing is read back through an
update.  The trunk paths are named by their runtime flags, as in
``tests/test_torch_train.py``: fused (K1 + K2), hybrid (K3),
fused_recompute (``use_pallas`` alone), yaml (the ray-structured path
with remat) and layer_bwd (``pallas_layer_bwd``, K4's plain version).
In bf16 the JAX side takes the same Pallas path in interpret mode, with
``jax.default_backend`` patched; in f32 the Pallas modes are held
against JAX's XLA path, which computes the same function (layer_bwd is
patched in both, as ``tests/test_torch_xla_path.py`` does).

Tolerances as the train tests state them: f32 atol 1e-5 per gradient
leaf, losses rtol 1e-5; bf16 relRMS <= 1e-2 per leaf, losses rtol 1e-3.
f32 gradient leaves are also held at relRMS <= 1e-4, the card's f32
gate, because a pose leaf's gradient can be smaller than 1e-5 (measured
worst: 1e-6).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from codenerf_tpu.config.schema import config_from_dict as j_config_from_dict
from codenerf_tpu.core.geometry import pixel_directions as j_pixel_dirs
from codenerf_tpu.core.geometry import pose_spherical as j_pose
from codenerf_tpu.core.geometry import select_ray_indices as j_select
from codenerf_tpu.eval import tto as jtto
from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
from codenerf_tpu.train.state import init_train_state as j_init_state
from codenerf_tpu_torch.config import OptimizerConfig, config_from_dict
from codenerf_tpu_torch.eval import tto
from codenerf_tpu_torch.pipeline import (RenderSettings, remat_active,
                                         trunk_path)
from codenerf_tpu_torch.train import init_train_state
from codenerf_tpu_torch.train.optim import (build_se3_refine_optimizer,
                                            build_tto_optimizer)
from codenerf_tpu_torch.weights import params_from_jax, tto_variables_from_jax
from tests.test_torch_train import _cfg_dict
from tests.test_torch_xla_path import jax_on_tpu  # noqa: F401
from tests.torch_port_helpers import BF16_REL_RMS, F32_ATOL, rel_rms, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

H = W = 8
R = 32
NUM_OBJECTS = 3
LAMBDA = 1e-2
POSE_GT = (1.8, 0.3, 1.5)
F32_REL_RMS = 1e-4

# trunk path -> runtime flags over _cfg_dict's "yaml" mode
MODES = {
    "fused": {"use_pallas": True, "pallas_backward": True},
    "hybrid": {"pallas_hybrid": True},
    "fused_recompute": {"use_pallas": True},
    "yaml": {},
    "layer_bwd": {"pallas_layer_bwd": True},
}
PATHS = {"fused": "fused", "hybrid": "hybrid",
         "fused_recompute": "fused_recompute", "yaml": "rays",
         "layer_bwd": "rays"}


class Setup:
    """JAX and port configs, settings, models and code tables from one
    dict, the port loaded with the JAX parameters; the targets and
    directions of the tests."""

    def __init__(self, compute_dtype="float32", mode="yaml", seed=0,
                 optimizer=None):
        d = _cfg_dict(compute_dtype, mode="yaml", **MODES[mode])
        d["optimizer"].update(optimizer or {})
        self.jcfg, self.pcfg = j_config_from_dict(d), config_from_dict(d)
        self.js = JRenderSettings.from_config(self.jcfg)
        self.ps = RenderSettings.from_config(self.pcfg)
        assert trunk_path(self.ps) == PATHS[mode]
        assert remat_active(self.ps) == (PATHS[mode] == "rays")
        jstate, _ = j_init_state(jax.random.PRNGKey(seed), self.jcfg,
                                 self.js, NUM_OBJECTS)
        self.params = jstate.params
        self.state = init_train_state(self.pcfg, self.ps, NUM_OBJECTS,
                                      seed=seed, device="cpu")
        params_from_jax(self.state, jax.tree.map(np.asarray, self.params))
        self.models = self.state.models
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = K[1, 1] = 10.0
        K[0, 2] = K[1, 2] = 4.0
        self.dirs = np.asarray(j_pixel_dirs(H, W, jnp.asarray(K)))

    def targets(self, K, seed=1):
        rng = np.random.default_rng(seed)
        return rng.uniform(0.1, 0.9, (K, H, W, 3)).astype(np.float32)


def poses_gt(K):
    return np.stack([np.asarray(j_pose(POSE_GT[0] - 0.2 * k,
                                       POSE_GT[1] + 0.5 * k, POSE_GT[2]))
                     for k in range(K)])


def jax_draws(js, key, num_views, num_rays=R):
    """The port's ``inds`` [V, R] and ``draws`` from a TTO step's key, as
    the JAX step splits it: indices from k_sel, coarse jitter and fine u
    from k_render."""
    k_sel, k_render = jax.random.split(key)
    inds = np.array(j_select(k_sel, H * W, num_rays, num_views))
    k1, k2 = jax.random.split(k_render)
    n = num_views * num_rays
    draws = {"t_rand": t(jax.random.uniform(k1, (n, js.num_coarse))),
             "u": t(jax.random.uniform(k2, (n, js.num_fine)))}
    return torch.from_numpy(inds), draws


def _grad_catcher():
    """An optax transformation whose new state is the gradient it was
    given and whose update is zero: a JAX TTO step run with it returns
    its exact gradients as ``opt_state``."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def jax_step_grads(make_step, js, params, jvars, args, key, **kw):
    """(metrics, grads) of one JAX TTO step of ``make_step``'s kind."""
    catcher = _grad_catcher()
    jvars = jax.tree.map(jnp.array, jvars)
    state = jtto.TTOState(jvars, catcher.init(jvars), jnp.zeros((),
                                                                 jnp.int32))
    step = make_step(js, catcher, R, LAMBDA, True, **kw)
    new, m = step(state, params, *args, key)
    return m, jax.tree.map(np.asarray, new.opt_state)


def port_state(jvars, opt_cfg, se3=False):
    """A port TTO state on the CPU from JAX's variables."""
    variables = tto_variables_from_jax(jax.tree.map(np.asarray, jvars),
                                       "cpu")
    build = build_se3_refine_optimizer if se3 else build_tto_optimizer
    return tto.TTOState(variables, build(opt_cfg, variables))


def port_grads(state):
    return {k: v.grad.numpy() for k, v in state.variables.items()}


def check(m, jm, got, want, compute_dtype):
    """A port step's metrics and gradient leaves against JAX's."""
    rtol = 1e-5 if compute_dtype == "float32" else 1e-3
    for name in ("loss", "loss_coarse", "loss_fine", "loss_embedding",
                 "psnr", "pose_error"):
        np.testing.assert_allclose(
            np.asarray(getattr(m, name)), np.asarray(getattr(jm, name)),
            rtol=rtol, atol=1e-6, err_msg=name)
    assert set(got) == set(want)
    for k in want:
        assert np.all(np.isfinite(got[k])), k
        if compute_dtype == "float32":
            np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL,
                                       rtol=0, err_msg=k)
            # the pose leaves' gradients can be far below the atol
            assert rel_rms(got[k], want[k]) <= F32_REL_RMS, k
        else:
            assert rel_rms(got[k], want[k]) <= BF16_REL_RMS, (
                k, rel_rms(got[k], want[k]))


# ---- initialization and the optimizers ----

def test_init_tto_states_match_jax():
    s = Setup()
    jst, _ = jtto.init_tto_state(s.params["codes"], s.jcfg.optimizer)
    st, opt = tto.init_tto_state(s.state.tables, s.pcfg.optimizer,
                                 device="cpu")
    assert opt is st.optimizer and st.step == 0
    for k, v in jst.variables.items():
        assert st.variables[k].shape == v.shape and st.variables[k].is_leaf
        np.testing.assert_allclose(st.variables[k].detach().numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-7)
    jb, _ = jtto.init_batched_tto_state(s.params["codes"], s.jcfg.optimizer,
                                        4, pose_init=(jnp.arange(4.0), 0.0,
                                                      1.3))
    b, _ = tto.init_batched_tto_state(s.state.tables, s.pcfg.optimizer, 4,
                                      pose_init=(torch.arange(4.0), 0.0,
                                                 1.3), device="cpu")
    for k, v in jb.variables.items():
        np.testing.assert_allclose(b.variables[k].detach().numpy(),
                                   np.asarray(v), rtol=1e-6, atol=1e-7)
    with pytest.raises(RuntimeError, match="CUDA"):
        tto.init_tto_state(s.state.tables, s.pcfg.optimizer)


def test_step_builders_default_to_the_card():
    s = Setup()
    for make in (tto.make_tto_step, tto.make_batched_tto_step,
                 tto.make_multiview_tto_step, tto.make_se3_refine_step,
                 tto.make_multiview_se3_refine_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(s.ps, None, R, LAMBDA, True)


def test_tto_optimizer_groups_and_refusals():
    cfg = OptimizerConfig(type="Adam", val_type="AdamW", val_lr=0.01,
                          angle_lr=0.02, radius_lr=None, se3_refine_lr=3e-3)
    v = {k: torch.zeros(2, requires_grad=True)
         for k in ("z_s", "z_t", "theta", "phi", "rho", "xi")}
    opt = build_tto_optimizer(cfg, v)
    assert isinstance(opt, torch.optim.AdamW)
    assert [g["lr"] for g in opt.param_groups] == [0.01, 0.02, 0.01]
    assert [len(g["params"]) for g in opt.param_groups] == [2, 2, 1]
    assert opt.param_groups[1]["params"][0] is v["theta"]
    assert all(g["weight_decay"] == 1e-2 for g in opt.param_groups)
    se3 = build_se3_refine_optimizer(cfg, v)
    assert [g["lr"] for g in se3.param_groups] == [0.01, 3e-3]
    assert se3.param_groups[1]["params"] == [v["xi"]]
    assert isinstance(build_tto_optimizer(OptimizerConfig(type="SGD"), v),
                      torch.optim.SGD)
    for name in ("LBFGS", "NoSuchOptimizer"):
        for build in (build_tto_optimizer, build_se3_refine_optimizer):
            with pytest.raises(ValueError):
                build(OptimizerConfig(val_type=name), v)


# ---- one step's loss and gradients against JAX ----

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_tto_step_loss_and_grads_match_jax(mode, compute_dtype, request):
    """One single-object TTO step: loss terms, psnr, pose error and the
    gradients of z_s, z_t, theta, phi and rho, on every trunk path."""
    if compute_dtype == "bfloat16" or mode == "layer_bwd":
        request.getfixturevalue("jax_on_tpu")
    s = Setup(compute_dtype, mode, seed=2)
    jvars, _ = jtto.init_tto_state(s.params["codes"], s.jcfg.optimizer)
    jvars = jvars.variables
    target, pose = s.targets(1)[0], poses_gt(1)[0]
    key = jax.random.PRNGKey(5)
    jm, want = jax_step_grads(
        jtto.make_tto_step, s.js, s.params, jvars,
        (jnp.asarray(s.dirs), jnp.asarray(target), jnp.asarray(pose)), key)
    st = port_state(jvars, s.pcfg.optimizer)
    inds, draws = jax_draws(s.js, key, 1)
    step = tto.make_tto_step(s.ps, st.optimizer, R, LAMBDA, True, "cpu")
    st2, m = step(st, s.models, t(s.dirs), t(target), t(pose), None,
                  inds=inds[0], draws=draws)
    assert st2 is st and st.step == 1
    check(m, jm, port_grads(st), want, compute_dtype)


@pytest.mark.parametrize("mode", ["fused", "yaml"])
def test_batched_tto_step_matches_jax(mode):
    """One K = 2 batched step (f32): per-object metrics and gradients."""
    s = Setup("float32", mode, seed=3)
    jst, _ = jtto.init_batched_tto_state(s.params["codes"],
                                         s.jcfg.optimizer, 2)
    targets, poses = s.targets(2), poses_gt(2)
    key = jax.random.PRNGKey(6)
    jm, want = jax_step_grads(
        jtto.make_batched_tto_step, s.js, s.params, jst.variables,
        (jnp.asarray(s.dirs), jnp.asarray(targets), jnp.asarray(poses)), key)
    st = port_state(jst.variables, s.pcfg.optimizer)
    inds, draws = jax_draws(s.js, key, 2)
    step = tto.make_batched_tto_step(s.ps, st.optimizer, R, LAMBDA, True,
                                     "cpu")
    _, m = step(st, s.models, t(s.dirs), t(targets), t(poses), None,
                inds=inds, draws=draws)
    assert m.loss.shape == (2,)
    check(m, jm, port_grads(st), want, "float32")


def _variables_close(st, jvars, atol):
    for k, v in jvars.items():
        np.testing.assert_allclose(st.variables[k].detach().numpy(),
                                   np.asarray(v), atol=atol, rtol=0,
                                   err_msg=k)


def test_sgd_step_matches_make_tto_step():
    """val_type SGD: the update is -lr g, so the variables after one step
    of each package's own step hold the gradients themselves."""
    s = Setup("float32", "yaml", seed=4,
              optimizer={"val_type": "SGD", "val_lr": 0.5,
                         "angle_lr": 0.25})
    jst, jopt = jtto.init_tto_state(s.params["codes"], s.jcfg.optimizer)
    st = port_state(jst.variables, s.pcfg.optimizer)
    assert isinstance(st.optimizer, torch.optim.SGD)
    target, pose = s.targets(1)[0], poses_gt(1)[0]
    key = jax.random.PRNGKey(8)
    jstep = jtto.make_tto_step(s.js, jopt, R, LAMBDA, True)
    jst, jm = jstep(jst, s.params, jnp.asarray(s.dirs), jnp.asarray(target),
                    jnp.asarray(pose), key)
    inds, draws = jax_draws(s.js, key, 1)
    step = tto.make_tto_step(s.ps, st.optimizer, R, LAMBDA, True, "cpu")
    _, m = step(st, s.models, t(s.dirs), t(target), t(pose), None,
                inds=inds[0], draws=draws)
    _variables_close(st, jst.variables, F32_ATOL)
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-5)


def test_three_adamw_steps_match_make_tto_step():
    s = Setup("float32", "fused", seed=5)
    jst, jopt = jtto.init_tto_state(s.params["codes"], s.jcfg.optimizer)
    st = port_state(jst.variables, s.pcfg.optimizer)
    assert isinstance(st.optimizer, torch.optim.AdamW)
    target, pose = s.targets(1)[0], poses_gt(1)[0]
    jstep = jtto.make_tto_step(s.js, jopt, R, LAMBDA, True)
    step = tto.make_tto_step(s.ps, st.optimizer, R, LAMBDA, True, "cpu")
    key = jax.random.PRNGKey(9)
    for _ in range(3):
        key, k = jax.random.split(key)
        jst, jm = jstep(jst, s.params, jnp.asarray(s.dirs),
                        jnp.asarray(target), jnp.asarray(pose), k)
        inds, draws = jax_draws(s.js, k, 1)
        _, m = step(st, s.models, t(s.dirs), t(target), t(pose), None,
                    inds=inds[0], draws=draws)
        _variables_close(st, jst.variables, F32_ATOL)
        for name in ("loss", "loss_fine", "pose_error"):
            np.testing.assert_allclose(float(getattr(m, name)),
                                       float(getattr(jm, name)), rtol=1e-5,
                                       err_msg=name)
    assert st.step == 3 and int(jst.step) == 3


# ---- the port's own semantics ----

def _generator_steps(s, make, state, targets, poses, seed, n):
    step = make(s.ps, state.optimizer, R, LAMBDA, True, "cpu")
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        state, m = step(state, s.models, t(s.dirs), t(targets), t(poses),
                        gen)
        out.append(m)
    return state, out


def test_batched_k1_matches_single():
    """A K = 1 batched step from the same generator reproduces the single
    step (tolerances of tests/test_eval.py:72-102)."""
    s = Setup("float32", "fused", seed=6)
    target, pose = s.targets(1), poses_gt(1)
    single, _ = tto.init_tto_state(s.state.tables, s.pcfg.optimizer,
                                   device="cpu")
    batched, _ = tto.init_batched_tto_state(s.state.tables,
                                            s.pcfg.optimizer, 1,
                                            device="cpu")
    single, ms = _generator_steps(s, tto.make_tto_step, single, target[0],
                                  pose[0], 7, 3)
    batched, mb = _generator_steps(s, tto.make_batched_tto_step, batched,
                                   target, pose, 7, 3)
    np.testing.assert_allclose(batched.variables["z_s"][0].detach(),
                               single.variables["z_s"][0].detach(),
                               rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(float(batched.variables["theta"][0].detach()),
                               float(single.variables["theta"][0].detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mb[-1].loss[0]), float(ms[-1].loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mb[-1].pose_error[0]),
                               float(ms[-1].pose_error), rtol=1e-5)


def test_objects_are_independent():
    """Changing object 1's target must not change object 0's update
    (tests/test_eval.py:104-131)."""
    s = Setup("float32", "fused", seed=7)
    poses = poses_gt(2)
    t0 = np.full((H, W, 3), 0.4, np.float32)
    outs = []
    for other in (0.7, 0.1):
        targets = np.stack([t0, np.full((H, W, 3), other, np.float32)])
        st, _ = tto.init_batched_tto_state(s.state.tables, s.pcfg.optimizer,
                                           2, device="cpu")
        outs.append(_generator_steps(s, tto.make_batched_tto_step, st,
                                     targets, poses, 3, 1))
    (sa, (ma,)), (sb, (mb,)) = outs
    np.testing.assert_allclose(sa.variables["z_s"][0].detach(),
                               sb.variables["z_s"][0].detach(), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(float(ma.loss[0]), float(mb.loss[0]),
                               rtol=1e-6)
    assert abs(float(ma.loss[1]) - float(mb.loss[1])) > 1e-4


def test_tto_optimizes_codes_and_pose():
    s = Setup("float32", "yaml", seed=8)
    st, _ = tto.init_tto_state(s.state.tables, s.pcfg.optimizer,
                               device="cpu")
    theta0 = float(st.variables["theta"][0].detach())
    target = np.full((H, W, 3), 0.4, np.float32)
    st, ms = _generator_steps(s, tto.make_tto_step, st, target,
                              poses_gt(1)[0], 1, 20)
    assert float(st.variables["theta"][0].detach()) != theta0
    assert float(ms[-1].loss) < float(ms[0].loss)
    assert all(np.isfinite(float(m.pose_error)) for m in ms)
    assert st.step == 20


@pytest.mark.parametrize("mode", ["fused", "hybrid", "yaml", "layer_bwd"])
def test_models_stay_frozen(mode):
    """After a step the models' weights are bit-identical, no parameter
    has a .grad, and every requires_grad flag is restored."""
    s = Setup("bfloat16", mode, seed=9)
    before = {f"{k}.{n}": p.detach().clone()
              for k, m in s.models.items() for n, p in m.named_parameters()}
    st, _ = tto.init_batched_tto_state(s.state.tables, s.pcfg.optimizer, 2,
                                       device="cpu")
    st, (m,) = _generator_steps(s, tto.make_batched_tto_step, st,
                                s.targets(2), poses_gt(2), 4, 1)
    assert bool(torch.isfinite(m.loss).all())
    for k, model in s.models.items():
        for n, p in model.named_parameters():
            assert p.grad is None and p.requires_grad, f"{k}.{n}"
            assert torch.equal(p.detach(), before[f"{k}.{n}"]), f"{k}.{n}"
    assert all(v.grad is not None for v in st.variables.values())


def test_select_per_object_merges_variables_and_moments():
    s = Setup("float32", "yaml", seed=10)
    targets, poses = s.targets(3), poses_gt(3)
    runs = []
    for i, pose_init in enumerate(((1.57, 0.0, 1.3), (1.2, 2.0, 1.4))):
        st, _ = tto.init_batched_tto_state(s.state.tables, s.pcfg.optimizer,
                                           3, pose_init=pose_init,
                                           device="cpu")
        runs.append(_generator_steps(s, tto.make_batched_tto_step, st,
                                     targets, poses, 11 + i, 2 + i)[0])
    a, b = runs
    mask = torch.tensor([True, False, True])
    merged = tto.select_per_object(mask, a, b)
    assert merged is not a and merged.step == a.step == 2
    assert isinstance(merged.optimizer, torch.optim.AdamW)
    names = {id(p): n for n, p in merged.variables.items()}
    for g_m, g_a in zip(merged.optimizer.param_groups,
                        a.optimizer.param_groups):
        assert g_m["lr"] == g_a["lr"]
        assert [names[id(p)] for p in g_m["params"]] == [
            n for p in g_a["params"] for n, q in a.variables.items()
            if q is p]
    for n, v in merged.variables.items():
        assert v.is_leaf and v.requires_grad
        want = torch.where(mask.reshape((3,) + (1,) * (v.dim() - 1)),
                           a.variables[n], b.variables[n]).detach()
        assert torch.equal(v.detach(), want), n
        sm = merged.optimizer.state[v]
        sa = a.optimizer.state[a.variables[n]]
        sb = b.optimizer.state[b.variables[n]]
        for k in ("exp_avg", "exp_avg_sq"):
            w = torch.where(mask.reshape((3,) + (1,) * (v.dim() - 1)),
                            sa[k], sb[k])
            assert torch.equal(sm[k], w), (n, k)
            assert sm[k] is not sa[k]
        assert float(sm["step"]) == float(sa["step"]) == 2.0
    # the merged state steps on
    merged, (m,) = _generator_steps(s, tto.make_batched_tto_step, merged,
                                    targets, poses, 20, 1)
    assert merged.step == 3 and bool(torch.isfinite(m.loss).all())
    fresh, _ = tto.init_batched_tto_state(s.state.tables, s.pcfg.optimizer,
                                          3, device="cpu")
    with pytest.raises(ValueError, match="stepped alike"):
        tto.select_per_object(mask, a, fresh)
