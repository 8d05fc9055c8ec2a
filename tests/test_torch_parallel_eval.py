"""The port's data parallelism over rays (``parallel/``) in test-time
optimization and the image renderer, on the CPU against the JAX
package's meshed counterparts.

One world of two gloo ranks (``tests/torch_parallel_ranks.py``) runs
every case; JAX runs in this process on ``make_mesh(2)`` over two of
conftest's 8 virtual CPU devices, with JAX's draws fed to the port
(``inds=`` / ``draws=``) and JAX's exact gradients from
``_grad_catcher``, as ``tests/test_torch_tto.py`` does.  Sizes are that
file's: hidden 32, codes 16, 16 + 8 samples, 8x8 targets, 32 rays a
view, f32.  Cases: the single TTO step, the batched step (K = 2), the
multi-view step (K = 2 x V = 2), the SE(3) refine step and its
multi-view form, each also against the port's one-device step; the
image renderer at a chunk size the world does not divide (25, rounded
down to 24 as JAX rounds it); the int8 image under one and two ranks;
and ``eval/capacity.py``'s K, which stays per device.

Tolerances: f32 atol 1e-5 and relRMS 1e-4 per gradient leaf, losses
rtol 1e-5 (``tests/test_torch_tto.py::check``); images f32 atol 1e-5;
the int8 images rtol 1e-5, atol 1e-6, as JAX's test of its meshed int8
image holds them.
"""

import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from codenerf_tpu.eval import tto as jtto
from codenerf_tpu.eval.render import make_image_renderer as j_renderer
from codenerf_tpu.parallel.mesh import make_mesh
from codenerf_tpu_torch.eval import capacity
from codenerf_tpu_torch.parallel import launch
from tests import torch_parallel_ranks as ranks
from tests.test_torch_train import _cfg_dict
from tests.test_torch_tto import (H, LAMBDA, MODES, NUM_OBJECTS, R, W, Setup,
                                  check, jax_draws, jax_step_grads, poses_gt)
from tests.test_torch_tto_multiview import multiview_data
from tests.torch_port_helpers import F32_ATOL, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

K, V = 2, 2
KINDS = ["single", "batched", "multiview", "se3", "multiview_se3"]
CHUNK = 25
BUDGET = 3 * 10 ** 6
SPAWN_TIMEOUT = 300


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(mode):
    """``Setup``'s config dict."""
    return _cfg_dict("float32", mode="yaml", **MODES[mode])


def _tto_case(kind, seed):
    """A TTO case for the ranks and JAX's meshed step's metrics and
    gradients."""
    mode = "yaml" if kind == "multiview" else "fused"
    s = Setup("float32", mode, seed=seed)
    mesh = make_mesh(2)
    key = jax.random.PRNGKey(seed + 1)
    dirs = jnp.asarray(s.dirs)
    if kind == "single":
        jst, _ = jtto.init_tto_state(s.params["codes"], s.jcfg.optimizer)
        args = (dirs, jnp.asarray(s.targets(1)[0]),
                jnp.asarray(poses_gt(1)[0]))
        make, views = jtto.make_tto_step, 1
    elif kind == "batched":
        jst, _ = jtto.init_batched_tto_state(s.params["codes"],
                                             s.jcfg.optimizer, K)
        args = (dirs, jnp.asarray(s.targets(K)), jnp.asarray(poses_gt(K)))
        make, views = jtto.make_batched_tto_step, K
    elif kind == "multiview":
        jst, _ = jtto.init_multiview_tto_state(s.params["codes"],
                                               s.jcfg.optimizer, K, V)
        targets, poses = multiview_data(s)
        args = (dirs, jnp.asarray(targets), jnp.asarray(poses))
        make, views = jtto.make_multiview_tto_step, K * V
    else:
        # the refine stage from the initial spherical state
        multiview = kind == "multiview_se3"
        if multiview:
            jst, _ = jtto.init_multiview_tto_state(
                s.params["codes"], s.jcfg.optimizer, K, V,
                pose_init=(1.4, 0.3, 1.3))
            targets, poses = multiview_data(s)
        else:
            jst, _ = jtto.init_batched_tto_state(
                s.params["codes"], s.jcfg.optimizer, K,
                pose_init=(1.4, 0.3, 1.3))
            targets, poses = s.targets(K), poses_gt(K)
        j_init, make = ((jtto.init_multiview_se3_refine_state,
                         jtto.make_multiview_se3_refine_step) if multiview
                        else (jtto.init_se3_refine_state,
                              jtto.make_se3_refine_step))
        jst, _, base = j_init(jst, s.jcfg.optimizer)
        args = (dirs, jnp.asarray(targets), base, jnp.asarray(poses))
        views = K * (V if multiview else 1)
    jm, want = jax_step_grads(make, s.js, s.params, jst.variables, args,
                              key, mesh=mesh)
    inds, draws = jax_draws(s.js, key, views)
    inds = inds.numpy()
    case = {"kind": kind, "cfg": _cfg(mode), "params": _np(s.params),
            "num_objects": NUM_OBJECTS, "num_random_rays": R,
            "lambda": LAMBDA, "variables": _np(jst.variables),
            "args": [np.asarray(a) for a in args],
            "inds": inds[0] if kind == "single" else inds,
            "draws": {k: v.numpy() for k, v in draws.items()}}
    return case, {"metrics": jm, "grads": want}


def _render_cases(seed):
    """The f32 image at chunk size 25 (with JAX's meshed image) and the
    int8 image, calibrated on 16 of its rays by ``int8_render_params``."""
    s = Setup("float32", "fused", seed=seed)
    pose = np.asarray(poses_gt(1)[0])
    z = np.asarray(s.params["codes"]["shape"][1:2])
    want = j_renderer(s.js, H, W, chunksize=CHUNK, mesh=make_mesh(2))(
        {"coarse": s.params["coarse"], "fine": s.params["fine"]},
        jnp.asarray(s.dirs), jnp.asarray(pose), jnp.asarray(z),
        jnp.asarray(z))
    case = {"cfg": _cfg("fused"), "params": _np(s.params),
            "num_objects": NUM_OBJECTS, "height": H, "width": W,
            "chunksize": CHUNK, "dirs": s.dirs, "pose": pose, "z_s": z,
            "z_t": z}
    return [case, dict(case, int8=True)], np.asarray(want)


@pytest.fixture(scope="module")
def results():
    """Every case's JAX reference, one-device port result and two-rank
    port results (one spawned world for every case)."""
    tto_cases, tto_want = zip(*(_tto_case(kind, 30 + i)
                                for i, kind in enumerate(KINDS)))
    render_cases, image_want = _render_cases(40)
    cap_cases = [dict(render_cases[0], num_random_rays=4096, requested=64)]
    jobs = [("tto_steps", list(tto_cases)), ("renders", render_cases),
            ("capacities", cap_cases)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CODENERF_HBM_BUDGET_BYTES", str(BUDGET))
        one = ranks.all_of(None, jobs)
        two = launch.spawn(ranks.all_of, 2, (jobs,), devices=["cpu"] * 2,
                           timeout=SPAWN_TIMEOUT)
    return {"tto_want": tto_want, "image_want": image_want, "one": one,
            "two": two, "cap_cases": cap_cases}


def _m(d):
    return types.SimpleNamespace(**d)


@pytest.mark.parametrize("index", range(len(KINDS)), ids=KINDS)
def test_tto_step_on_two_ranks_matches_jax_mesh(results, index):
    want = results["tto_want"][index]
    one = results["one"][0][index]
    for rank in range(2):
        got = results["two"][rank][0][index]
        check(_m(got["metrics"]), want["metrics"], got["grads"],
              want["grads"], "float32")
        check(_m(got["metrics"]), _m(one["metrics"]), got["grads"],
              one["grads"], "float32")
    check(_m(one["metrics"]), want["metrics"], one["grads"], want["grads"],
          "float32")
    # the ranks hold the same summed gradients
    for k, g in results["two"][0][0][index]["grads"].items():
        assert np.array_equal(g, results["two"][1][0][index]["grads"][k]), k


def test_image_on_two_ranks_matches_jax_mesh(results):
    want = results["image_want"]
    assert want.shape == (H * W, 3)
    for rank in range(2):
        got = results["two"][rank][1][0]["image"]
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
        np.testing.assert_array_equal(got, results["two"][0][1][0]["image"])
    np.testing.assert_allclose(results["one"][1][0]["image"], want,
                               atol=F32_ATOL, rtol=0)


def test_int8_image_equal_under_one_and_two_ranks(results):
    """Equal as ``tests/test_quantized.py:223`` holds JAX's meshed int8
    image (rtol 1e-5, atol 1e-6): a ray's f32 epilogue may round once
    differently in a chunk of half the rows.  Every rank calibrates to
    the one-device int8 buffers, bit for bit."""
    one = results["one"][1][1]
    assert one["image"].shape == (H * W, 3)
    assert np.all(np.isfinite(one["image"])) and one["buffers"]
    for rank in range(2):
        got = results["two"][rank][1][1]
        np.testing.assert_allclose(got["image"], one["image"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["image"],
                                      results["two"][0][1][1]["image"])
        assert len(got["buffers"]) == len(one["buffers"])
        for a, b in zip(got["buffers"], one["buffers"]):
            np.testing.assert_array_equal(a, b)


def test_capacity_stays_per_device(results):
    """Each rank clamps K by its own device's budget, as JAX's reads
    device 0's: the world's size does not change it."""
    case = results["cap_cases"][0]
    settings, _ = ranks.train_state(case)
    want = capacity.max_batch_objects(settings, case["num_random_rays"],
                                      case["requested"], budget=BUDGET)
    assert 1 <= want < case["requested"]
    assert results["one"][2] == [want]
    assert [r[2] for r in results["two"]] == [[want], [want]]
