"""Port parity for the optimizer names: every name the JAX package maps to
optax (``codenerf_tpu/train/optim.py::_OPTIMIZERS``) computes, through
the port's train builder (three groups under the LambdaLR decay) and its
TTO builder (codes, angles and radius groups), what the optax
transformation computes over 3 steps from the same f32 parameters and
gradients.

Tolerance rtol 1e-6 / atol 1e-7: the same f32 update arithmetic, with
rsqrt and the powers rounded by two libraries.  Parameters start at the
scale of the models' initial weights (0.1), where an f32 ulp is 7.5e-9.
The names whose update divides by Adam's second-moment bias correction
1 - 0.999^t (Adam, AdamW, SparseAdam, NAdam) take atol 1e-6, the gate
``tests/test_torch_train.py`` holds AdamW to: optax rounds 0.999^t in
f32, so one ulp of it (6e-8) moves 1 - 0.999^t by 6e-5 relative at t = 1
and the update by half that (measured: 3.9e-7 after three steps at lr
2e-2, against torch's float64 correction).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import optax
import torch

from codenerf_tpu.config.schema import OptimizerConfig as JOptimizerConfig
from codenerf_tpu.train.optim import _OPTIMIZERS
from codenerf_tpu.train.optim import build_optimizer as j_build_optimizer
from codenerf_tpu.train.optim import build_tto_optimizer as j_build_tto
from codenerf_tpu_torch.config import OptimizerConfig
from codenerf_tpu_torch.eval.tto import TTOState, select_per_object
from codenerf_tpu_torch.train.optim import (OPTIMIZERS, build_optimizer,
                                            build_tto_optimizer)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

NAMES = sorted(_OPTIMIZERS)
RTOL, ATOL = 1e-6, 1e-7
ADAM_ATOL = 1e-6
ADAM_FAMILY = ("Adam", "AdamW", "SparseAdam", "NAdam")


def _atol(name):
    return ADAM_ATOL if name in ADAM_FAMILY else ATOL
# a decay the three steps see: lr(t) = lr * 0.5 ** (t / 2)
OPT = dict(lr=3e-2, embedding_lr=5e-2, val_lr=2e-2, angle_lr=4e-2,
           radius_lr=1e-2, scheduler_gamma=0.5, scheduler_step_size=2)


def _configs(name):
    return (JOptimizerConfig(type=name, **OPT),
            OptimizerConfig(type=name, **OPT))


def _leaves(rng):
    """{"coarse": {"w", "b"}, "fine": {...}, "codes": {"shape",
    "texture"}} of f32 numpy arrays."""
    def draw(*shape):
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    def lin():
        return {"w": draw(5, 4), "b": draw(4)}
    return {"coarse": lin(), "fine": lin(),
            "codes": {"shape": draw(3, 6), "texture": draw(3, 6)}}


def _grads_like(tree, rng):
    if isinstance(tree, dict):
        return {k: _grads_like(v, rng) for k, v in tree.items()}
    return rng.normal(size=tree.shape).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("name", NAMES)
def test_train_builder_tracks_optax(name):
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(0)
    values = _leaves(rng)
    tensors = {k: torch.nn.ParameterDict({
        n: torch.nn.Parameter(torch.from_numpy(a.copy()))
        for n, a in v.items()}) for k, v in values.items()}
    optimizer, scheduler = build_optimizer(
        tcfg, {"coarse": tensors["coarse"], "fine": tensors["fine"]},
        tensors["codes"])
    opt = j_build_optimizer(jcfg)
    params = {k: {n: jnp.asarray(a) for n, a in v.items()}
              for k, v in values.items()}
    state = opt.init(params)
    for _ in range(3):
        grads = _grads_like(values, rng)
        for k, v in grads.items():
            for n, a in v.items():
                tensors[k][n].grad = torch.from_numpy(a)
        updates, state = opt.update(
            {k: {n: jnp.asarray(a) for n, a in v.items()}
             for k, v in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        optimizer.step()
        scheduler.step()
        want = _flat(params)
        for k, v in tensors.items():
            for n, p in v.items():
                np.testing.assert_allclose(p.detach().numpy(),
                                           want[f"{k}/{n}"], rtol=RTOL,
                                           atol=_atol(name),
                                           err_msg=f"{k}/{n}")


TTO_SHAPES = {"z_s": (2, 6), "z_t": (2, 6), "theta": (2,), "phi": (2,),
              "rho": (2,)}


def _tto_run(name, rng, steps=3):
    """(port TTOState, JAX params) after ``steps`` TTO updates from the
    same values and gradients."""
    jcfg, tcfg = _configs(name)
    values = {k: (0.1 * rng.normal(size=s)).astype(np.float32)
              for k, s in TTO_SHAPES.items()}
    variables = {k: torch.from_numpy(a.copy()).requires_grad_()
                 for k, a in values.items()}
    optimizer = build_tto_optimizer(tcfg, variables)
    opt = j_build_tto(jcfg)
    params = {k: jnp.asarray(a) for k, a in values.items()}
    state = opt.init(params)
    for _ in range(steps):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in TTO_SHAPES.items()}
        for k, g in grads.items():
            variables[k].grad = torch.from_numpy(g)
        updates, state = opt.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        optimizer.step()
    return TTOState(variables, optimizer, steps), params


@pytest.mark.parametrize("name", NAMES)
def test_tto_builder_tracks_optax(name):
    tto, params = _tto_run(name, np.random.default_rng(1))
    for k, v in tto.variables.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(params[k]),
                                   rtol=RTOL, atol=_atol(name), err_msg=k)


def test_sparse_adam_runs_as_adam():
    """SparseAdam is Adam over the dense gradients, as in JAX."""
    assert OPTIMIZERS["SparseAdam"] is torch.optim.Adam
    tto, _ = _tto_run("SparseAdam", np.random.default_rng(2), steps=1)
    assert all(torch.isfinite(v).all() for v in tto.variables.values())


@pytest.mark.parametrize("name", ["NAdam", "Rprop"])
def test_select_per_object_merges_custom_optimizers(name):
    """Two states of a port subclass merge object by object: variables
    and per-parameter state tensors from the winner where the mask holds;
    the merged optimizer steps as each source would have."""
    a, _ = _tto_run(name, np.random.default_rng(3))
    b, _ = _tto_run(name, np.random.default_rng(4))
    mask = torch.tensor([True, False])
    merged = select_per_object(mask, a, b)
    assert type(merged.optimizer) is type(a.optimizer)
    for k in TTO_SHAPES:
        got = merged.variables[k].detach()
        torch.testing.assert_close(got[0], a.variables[k].detach()[0])
        torch.testing.assert_close(got[1], b.variables[k].detach()[1])
        st = merged.optimizer.state[merged.variables[k]]
        sa = a.optimizer.state[a.variables[k]]
        sb = b.optimizer.state[b.variables[k]]
        for key, val in st.items():
            if val.dim():
                torch.testing.assert_close(val[0], sa[key][0])
                torch.testing.assert_close(val[1], sb[key][1])
    # one more step with the same gradient: object 0 moves as in a, 1 as b
    g = {k: torch.from_numpy(np.random.default_rng(5).normal(
        size=s).astype(np.float32)) for k, s in TTO_SHAPES.items()}
    for st in (merged, a, b):
        for k, v in st.variables.items():
            v.grad = g[k].clone()
        st.optimizer.step()
    for k in TTO_SHAPES:
        got = merged.variables[k].detach()
        torch.testing.assert_close(got[0], a.variables[k].detach()[0])
        torch.testing.assert_close(got[1], b.variables[k].detach()[1])


@pytest.mark.parametrize("which", ["train", "tto"])
def test_lbfgs_raises_in_both_packages(which):
    jcfg, tcfg = _configs("LBFGS")
    with pytest.raises(ValueError, match="LBFGS"):
        (j_build_optimizer if which == "train" else j_build_tto)(jcfg).init(
            {"coarse": {}, "fine": {}, "codes": {}} if which == "train"
            else {"z_s": jnp.zeros(1)})
    with pytest.raises(ValueError, match="LBFGS"):
        if which == "train":
            build_optimizer(tcfg, {"coarse": torch.nn.Linear(2, 2),
                                   "fine": torch.nn.Linear(2, 2)})
        else:
            build_tto_optimizer(tcfg, {
                k: torch.zeros(s, requires_grad=True)
                for k, s in TTO_SHAPES.items()})
