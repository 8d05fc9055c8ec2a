"""Port parity for multi-view TTO and the SE(3)-tangent refinement
(``eval/tto.py``), at the small size of ``tests/test_torch_tto.py``
(hidden 32, codes 16, 8x8 targets, 32 rays a view), against the JAX
package with JAX's draws and exact JAX gradients (its step run with
``_grad_catcher``).  The refine stages of both packages start from one
state, carried across by ``weights.tto_variables_from_jax``.

Tolerances as there: f32 atol 1e-5 and relRMS 1e-4 per gradient leaf,
losses rtol 1e-5; bf16 relRMS <= 1e-2 per leaf, losses rtol 1e-3.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.eval import tto as jtto
from codenerf_tpu_torch.eval import tto
from tests.test_torch_tto import (LAMBDA, R, Setup, _generator_steps,
                                  check, jax_draws, jax_step_grads,
                                  port_grads, port_state, poses_gt)
from tests.test_torch_xla_path import jax_on_tpu  # noqa: F401
from tests.torch_port_helpers import t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

K, V = 2, 2


def multiview_data(s):
    targets = s.targets(K * V, seed=3).reshape(K, V, *s.targets(1).shape[1:])
    poses = poses_gt(K * V).reshape(K, V, 4, 4)
    return targets, poses


def test_init_multiview_state_matches_jax():
    s = Setup()
    # scalars, 1-D arrays (broadcast along the views, as JAX does) and
    # [K, V] arrays
    for pose_init in ((1.57, 0.0, 1.3), ([1.0, 1.2], 0.5, [1.3, 1.4]),
                      (np.full((K, V), 1.1), np.arange(4.0).reshape(K, V),
                       1.3)):
        jst, _ = jtto.init_multiview_tto_state(
            s.params["codes"], s.jcfg.optimizer, K, V,
            pose_init=tuple(jnp.asarray(v, jnp.float32) for v in pose_init))
        st, _ = tto.init_multiview_tto_state(
            s.state.tables, s.pcfg.optimizer, K, V,
            pose_init=tuple(torch.as_tensor(np.asarray(v, np.float32))
                            for v in pose_init), device="cpu")
        for k, v in jst.variables.items():
            assert st.variables[k].shape == v.shape, k
            np.testing.assert_allclose(st.variables[k].detach().numpy(),
                                       np.asarray(v), rtol=1e-6, atol=1e-7)


def test_multiview_with_one_view_matches_batched():
    """V = 1 draws and renders exactly as the batched step."""
    s = Setup("float32", "fused", seed=11)
    targets, poses = s.targets(K), poses_gt(K)
    mv, _ = tto.init_multiview_tto_state(s.state.tables, s.pcfg.optimizer,
                                         K, 1, device="cpu")
    b, _ = tto.init_batched_tto_state(s.state.tables, s.pcfg.optimizer, K,
                                      device="cpu")
    mv, mm = _generator_steps(s, tto.make_multiview_tto_step, mv,
                              targets[:, None], poses[:, None], 5, 3)
    b, mb = _generator_steps(s, tto.make_batched_tto_step, b, targets, poses,
                             5, 3)
    for k in ("z_s", "z_t"):
        np.testing.assert_allclose(mv.variables[k].detach(),
                                   b.variables[k].detach(), rtol=2e-5,
                                   atol=1e-7)
    for k in ("theta", "phi", "rho"):
        np.testing.assert_allclose(mv.variables[k][:, 0].detach(),
                                   b.variables[k].detach(), rtol=1e-5)
    for name in ("loss", "loss_fine", "pose_error"):
        np.testing.assert_allclose(getattr(mm[-1], name),
                                   getattr(mb[-1], name), rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("compute_dtype,mode", [("float32", "yaml"),
                                                ("bfloat16", "fused")])
def test_multiview_step_matches_jax(compute_dtype, mode, request):
    if compute_dtype == "bfloat16":
        request.getfixturevalue("jax_on_tpu")
    s = Setup(compute_dtype, mode, seed=12)
    targets, poses = multiview_data(s)
    jst, _ = jtto.init_multiview_tto_state(
        s.params["codes"], s.jcfg.optimizer, K, V,
        pose_init=(jnp.asarray([1.5, 1.3]), jnp.asarray([[0.0, 0.6],
                                                         [1.0, -0.5]]), 1.3))
    key = jax.random.PRNGKey(13)
    jm, want = jax_step_grads(
        jtto.make_multiview_tto_step, s.js, s.params, jst.variables,
        (jnp.asarray(s.dirs), jnp.asarray(targets), jnp.asarray(poses)), key)
    st = port_state(jst.variables, s.pcfg.optimizer)
    inds, draws = jax_draws(s.js, key, K * V)
    step = tto.make_multiview_tto_step(s.ps, st.optimizer, R, LAMBDA, True,
                                       "cpu")
    _, m = step(st, s.models, t(s.dirs), t(targets), t(poses), None,
                inds=inds, draws=draws)
    assert m.loss.shape == (K,) and st.variables["theta"].grad.shape == (K, V)
    check(m, jm, port_grads(st), want, compute_dtype)


def _spherical_result(s, multiview):
    """A JAX spherical TTO state after two AdamW steps: the refine
    stages' common start."""
    if multiview:
        jst, jopt = jtto.init_multiview_tto_state(
            s.params["codes"], s.jcfg.optimizer, K, V)
        make, (targets, poses) = jtto.make_multiview_tto_step, \
            multiview_data(s)
    else:
        jst, jopt = jtto.init_batched_tto_state(s.params["codes"],
                                                s.jcfg.optimizer, K)
        make, targets, poses = (jtto.make_batched_tto_step, s.targets(K),
                                poses_gt(K))
    step = make(s.js, jopt, R, LAMBDA, True)
    key = jax.random.PRNGKey(14)
    for _ in range(2):
        key, k = jax.random.split(key)
        jst, _ = step(jst, s.params, jnp.asarray(s.dirs),
                      jnp.asarray(targets), jnp.asarray(poses), k)
    return jst, targets, poses


@pytest.mark.parametrize("multiview", [False, True])
def test_se3_refine_init_matches_jax(multiview):
    s = Setup("float32", "yaml", seed=15)
    jst, *_ = _spherical_result(s, multiview)
    j_init = (jtto.init_multiview_se3_refine_state if multiview
              else jtto.init_se3_refine_state)
    p_init = (tto.init_multiview_se3_refine_state if multiview
              else tto.init_se3_refine_state)
    jref, _, jbase = j_init(jst, s.jcfg.optimizer)
    spherical = port_state(jst.variables, s.pcfg.optimizer)
    ref, opt, base = p_init(spherical, s.pcfg.optimizer)
    assert opt is ref.optimizer and ref.step == 0
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.param_groups[1]["lr"] == s.pcfg.optimizer.se3_refine_lr
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), atol=1e-6)
    assert not base.requires_grad
    for k, v in jref.variables.items():
        assert ref.variables[k].shape == v.shape and ref.variables[k].is_leaf
        np.testing.assert_allclose(ref.variables[k].detach().numpy(),
                                   np.asarray(v), atol=0, rtol=0)
    assert float(ref.variables["xi"].detach().abs().max()) == 0.0
    # copies, not aliases
    with torch.no_grad():
        ref.variables["z_s"].add_(1.0)
    np.testing.assert_array_equal(spherical.variables["z_s"].detach(),
                                  np.asarray(jst.variables["z_s"]))


@pytest.mark.parametrize("xi", ["zero", "random"])
@pytest.mark.parametrize("multiview", [False, True])
def test_se3_refine_step_matches_jax(multiview, xi):
    """One refine step from the same state in both packages: at xi = 0
    (the stage's first step, inside the Taylor branch) and at a random
    xi."""
    s = Setup("float32", "fused", seed=16)
    jst, targets, poses = _spherical_result(s, multiview)
    j_init, j_make = ((jtto.init_multiview_se3_refine_state,
                       jtto.make_multiview_se3_refine_step) if multiview
                      else (jtto.init_se3_refine_state,
                            jtto.make_se3_refine_step))
    jref, _, jbase = j_init(jst, s.jcfg.optimizer)
    jvars = dict(jref.variables)
    if xi == "random":
        rng = np.random.default_rng(17)
        jvars["xi"] = jnp.asarray(
            rng.normal(size=jvars["xi"].shape) * 0.05, jnp.float32)
    key = jax.random.PRNGKey(18)
    jm, want = jax_step_grads(
        j_make, s.js, s.params, jvars,
        (jnp.asarray(s.dirs), jnp.asarray(targets), jbase,
         jnp.asarray(poses)), key)
    ref = port_state(jvars, s.pcfg.optimizer, se3=True)
    make = (tto.make_multiview_se3_refine_step if multiview
            else tto.make_se3_refine_step)
    step = make(s.ps, ref.optimizer, R, LAMBDA, True, "cpu")
    inds, draws = jax_draws(s.js, key, K * (V if multiview else 1))
    _, m = step(ref, s.models, t(s.dirs), t(targets), t(np.asarray(jbase)),
                t(poses), None, inds=inds, draws=draws)
    assert set(want) == {"z_s", "z_t", "xi"}
    assert bool(torch.isfinite(ref.variables["xi"].grad).all())
    assert float(ref.variables["xi"].grad.abs().max()) > 0
    check(m, jm, port_grads(ref), want, "float32")
    assert ref.step == 1


def test_refine_steps_run_on_from_a_port_state():
    """Spherical TTO, then SE(3) refine, all in the port with a
    generator: finite losses, xi leaves zero, the codes carry over."""
    s = Setup("bfloat16", "hybrid", seed=19)
    targets, poses = s.targets(K), poses_gt(K)
    st, _ = tto.init_batched_tto_state(s.state.tables, s.pcfg.optimizer, K,
                                       device="cpu")
    st, _ = _generator_steps(s, tto.make_batched_tto_step, st, targets,
                             poses, 21, 2)
    ref, _, base = tto.init_se3_refine_state(st, s.pcfg.optimizer)
    assert torch.equal(ref.variables["z_s"].detach(),
                       st.variables["z_s"].detach())
    step = tto.make_se3_refine_step(s.ps, ref.optimizer, R, LAMBDA, True,
                                    "cpu")
    gen = torch.Generator().manual_seed(22)
    for _ in range(3):
        ref, m = step(ref, s.models, t(s.dirs), t(targets), base, t(poses),
                      gen)
        assert bool(torch.isfinite(m.loss).all())
    assert float(ref.variables["xi"].detach().abs().max()) > 0
    np.testing.assert_allclose(
        tto.se3_refined_poses(ref.variables, base).detach().numpy(),
        (tto.lie.se3_exp(ref.variables["xi"].detach()) @ base).numpy())
