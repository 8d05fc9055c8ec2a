"""The port's data parallelism over rays (``parallel/``) in the train
step, on the CPU against the JAX package's meshed step.

Each case holds three results from one state, the same data and the
same ray indices (perturb off): the port's step on a world of two gloo
ranks (spawned once for every case, ``tests/torch_parallel_ranks.py``),
JAX's step on ``make_mesh(2)`` over two of conftest's 8 virtual CPU
devices, and the port's step on one device.  JAX's gradients are exact:
its step runs with ``_grad_catcher``'s transformation.  Sizes are those
of ``tests/test_torch_train.py`` (hidden 32, codes 16, 4 xyz bands, 16 +
8 samples, 2 images of 8x8, 16 rays each): 32 rays, 16 a rank, 8 a rank
in each of 2 ray chunks.  Cases: f32 and bf16, fused mode (``use_pallas``
+ ``pallas_backward``, JAX's Pallas in interpret mode) and the YAML's
rays path, ``ray_chunks`` 1 and 2.

Tolerances: f32 atol 1e-5 per gradient leaf, losses rtol 1e-5; bf16
relRMS 1e-2 per leaf, losses rtol 1e-3 (``tests/torch_port_helpers.py``).
The two ranks' parameters after two steps are bit-identical, and a world
of one rank is bit-identical to no world.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from codenerf_tpu.core.geometry import select_ray_indices as j_select
from codenerf_tpu.ops import fused as jfused
from codenerf_tpu.parallel.mesh import make_mesh
from codenerf_tpu.train.step import make_train_step as j_make_train_step
from codenerf_tpu_torch.models import code_table_norms
from codenerf_tpu_torch.parallel import close_world, init_world, launch
from codenerf_tpu_torch.pipeline import draw_train_randoms, render_rays_train
from codenerf_tpu_torch.train import make_train_step
from tests import torch_parallel_ranks as ranks
from tests.test_torch_train import (H, LAMBDA, N_RAYS, NUM_OBJECTS, W, _both,
                                    _cfg_dict, _data, check_step)
from tests.torch_port_helpers import t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

# (compute dtype, trunk mode by its flags, ray_chunks)
CASES = [("float32", "fused", 1), ("float32", "fused", 2),
         ("bfloat16", "fused", 1), ("float32", "yaml", 1),
         ("bfloat16", "yaml", 2)]
IDS = [f"{d[:4]}-{m}-chunks{c}" for d, m, c in CASES]
SPAWN_TIMEOUT = 300


def _grad_catcher():
    """An optax transformation whose state is the gradient it was given
    and whose update is zero."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _flat(grads) -> dict:
    out = {f"{k}.{n}.{p}": np.asarray(grads[k][n][p])
           for k in ("coarse", "fine") for n in grads[k] for p in ("w", "b")}
    out["codes.shape"] = np.asarray(grads["codes"]["shape"])
    out["codes.texture"] = np.asarray(grads["codes"]["texture"])
    return out


def _interpret_pallas(mp):
    orig = jfused.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    mp.setattr(jfused.pl, "pallas_call", interp)
    mp.setattr(jax, "default_backend", lambda: "tpu")


def _case(compute_dtype, mode, chunks, seed):
    """A case for the ranks (config dict, JAX parameters, data, indices of
    two steps) and JAX's meshed step's metrics and gradients."""
    d = _cfg_dict(compute_dtype, mode=mode)
    jcfg, js, _, jstate, _, _ = _both(compute_dtype, seed=seed, mode=mode)
    data = _data(seed + 1)
    keys = jax.random.split(jax.random.PRNGKey(seed + 2))
    inds = [np.array(j_select(jax.random.split(k)[0], H * W, N_RAYS, 2))
            for k in keys]
    catcher = _grad_catcher()
    step = j_make_train_step(js, catcher, N_RAYS, LAMBDA, False,
                             mesh=make_mesh(2), ray_chunks=chunks)
    jstate = jstate._replace(opt_state=catcher.init(jstate.params))
    params = jax.tree.map(np.asarray, jstate.params)
    new, jm = step(jstate, *map(jnp.asarray, data), keys[0])
    return ({"cfg": d, "params": params, "num_objects": NUM_OBJECTS,
             "num_random_rays": N_RAYS, "lambda": LAMBDA,
             "ray_chunks": chunks, "data": data, "inds": inds},
            {"metrics": jm, "grads": _flat(new.opt_state)})


@pytest.fixture(scope="module")
def results():
    """Every case's JAX reference, one-device port step and two-rank port
    steps (one spawned world for all cases)."""
    cases, jax_out = [], []
    for i, (dtype, mode, chunks) in enumerate(CASES):
        with pytest.MonkeyPatch.context() as mp:
            if dtype == "bfloat16" and mode == "fused":
                _interpret_pallas(mp)
            case, want = _case(dtype, mode, chunks, seed=10 + i)
        cases.append(case)
        jax_out.append(want)
    one = ranks.train_steps(None, cases)
    two = launch.spawn(ranks.train_steps, 2, (cases,), devices=["cpu"] * 2,
                       timeout=SPAWN_TIMEOUT)
    return cases, jax_out, one, two


class _Metrics:
    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, torch.from_numpy(np.asarray(v)))


@pytest.mark.parametrize("index", range(len(CASES)), ids=IDS)
def test_two_ranks_match_jax_mesh_and_one_device(results, index):
    cases, jax_out, one, two = results
    dtype = CASES[index][0]
    want = jax_out[index]
    jm = want["metrics"]
    losses = (float(jm.loss), float(jm.loss_coarse), float(jm.loss_fine),
              float(jm.loss_embedding))
    for rank in range(2):
        got = two[rank][index]
        check_step(_Metrics(got["metrics"]), losses, got["grads"],
                   want["grads"], dtype)
        # the port's one-device step, held alike
        check_step(_Metrics(got["metrics"]),
                   tuple(float(one[index]["metrics"][k]) for k in (
                       "loss", "loss_coarse", "loss_fine",
                       "loss_embedding")),
                   got["grads"], one[index]["grads"], dtype)
    check_step(_Metrics(one[index]["metrics"]), losses, one[index]["grads"],
               want["grads"], dtype)
    # both ranks took the same two updates
    assert two[0][index]["step"] == two[1][index]["step"] == 2
    for name, p in two[0][index]["params"].items():
        assert np.array_equal(p, two[1][index]["params"][name]), name
        assert np.all(np.isfinite(p)), name


def test_regularizer_counted_once(results):
    """The code tables' gradient holds the regularizer's once: counted
    twice (summed over the two ranks) it would move the f32 leaves by far
    more than the tolerance."""
    cases, _, one, two = results
    case = cases[0]
    _, state = ranks.train_state(case)
    ns, nt = code_table_norms(state.tables)
    (LAMBDA * (ns + nt)).backward()
    reg = state.tables.shape_embedding.weight.grad.numpy()
    assert np.abs(reg).max() > 100 * 1e-5
    got = two[0][0]["grads"]["codes.shape"]
    np.testing.assert_allclose(got, one[0]["grads"]["codes.shape"],
                               atol=1e-5, rtol=0)
    assert not np.allclose(got + reg, one[0]["grads"]["codes.shape"],
                           atol=1e-5, rtol=0)


def test_draws_are_render_rays_trains_own(results):
    """``render_rays_train`` given only a generator draws what
    ``draw_train_randoms`` draws from it, all four draws (jitter and
    noise): the render is bit-identical."""
    cases, *_ = results
    case = dict(cases[0])
    case["cfg"] = _cfg_dict("float32", noise_std=0.3, mode="fused")
    settings, state = ranks.train_state(case)
    rng = np.random.default_rng(3)
    ro = t(rng.normal(size=(12, 3)) * 0.1 + [0.0, 0.0, 1.3])
    rd = t(rng.normal(size=(12, 3)))
    z = state.tables.shape_embedding.weight[:1].expand(12, -1)
    outs = []
    for given in (False, True):
        gen = torch.Generator().manual_seed(5)
        draws = (draw_train_randoms(settings, 12, gen, True, 0.3)
                 if given else None)
        outs.append(render_rays_train(state.models, settings, ro, rd, z, z,
                                      gen, True, 0.3, draws))
    assert set(draws) == {"t_rand", "noise_c", "u", "noise_f"}
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a.rgb, b.rgb) and torch.equal(a.depth, b.depth)


def test_one_rank_world_is_bit_identical_to_no_world(results, monkeypatch):
    """Jitter and sigma noise from the generator, 2 ray chunks: one step
    in a world of one gloo rank (this process) against no world."""
    cases, *_ = results
    case = dict(cases[1])
    case["cfg"] = _cfg_dict("float32", noise_std=0.3, mode="fused")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(launch.free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    outs = []
    for world in (None, "gloo"):
        if world:
            world = init_world(1, backend="gloo", device="cpu")
            assert world.size == 1
        try:
            settings, state = ranks.train_state(case)
            step = make_train_step(settings, state, N_RAYS, LAMBDA, True, 2,
                                   world=world)
            d = case["data"]
            m = step(t(d[0]), t(d[1]), t(d[2]), torch.from_numpy(d[3]),
                     torch.Generator().manual_seed(7))
            outs.append((ranks.metrics_of(m), ranks.named_grads(state),
                         ranks.named_params(state)))
        finally:
            close_world()
    for a, b in zip(outs[0], outs[1]):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
