"""The rank side of the port's data-parallel tests
(``tests/test_torch_parallel*.py``).

Each function runs on every rank of a world that
``codenerf_tpu_torch.parallel.launch.spawn`` started, as
``fn(world, cases)``: it rebuilds each case's state from the JAX
parameters it was handed (numpy), runs the port's step or renderer with
the world and returns numpy results.  The module imports torch, numpy
and the port only, so that a spawned rank loads neither JAX nor a test
module.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from codenerf_tpu_torch.config import config_from_dict
from codenerf_tpu_torch.eval import capacity, tto
from codenerf_tpu_torch.eval.render import make_image_renderer
from codenerf_tpu_torch.harness import int8_render_params
from codenerf_tpu_torch.models.mlp import LAYER_NAMES
from codenerf_tpu_torch.pipeline import RenderSettings
from codenerf_tpu_torch.train import init_train_state, make_train_step
from codenerf_tpu_torch.train.optim import (build_se3_refine_optimizer,
                                            build_tto_optimizer)
from codenerf_tpu_torch.weights import params_from_jax, tto_variables_from_jax


def t(a, device="cpu"):
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def train_state(case, device="cpu"):
    """(settings, state) of a case: its config dict, loaded with its JAX
    parameters."""
    cfg = config_from_dict(case["cfg"])
    settings = RenderSettings.from_config(cfg)
    state = init_train_state(cfg, settings, case["num_objects"], seed=0,
                             device=device)
    params_from_jax(state, case["params"])
    return settings, state


def named_grads(state) -> dict:
    """Every gradient leaf under the JAX names (w as [in, out])."""
    out = {}
    for key in ("coarse", "fine"):
        for name in LAYER_NAMES:
            layer = getattr(state.models[key], name)
            out[f"{key}.{name}.w"] = layer.weight.grad.numpy().T
            out[f"{key}.{name}.b"] = layer.bias.grad.numpy()
    out["codes.shape"] = state.tables.shape_embedding.weight.grad.numpy()
    out["codes.texture"] = state.tables.texture_embedding.weight.grad.numpy()
    return out


def named_params(state) -> dict:
    return {f"{k}.{n}": p.detach().numpy().copy()
            for k, m in state.modules().items()
            for n, p in m.named_parameters()}


def metrics_of(m) -> dict:
    return {k: np.asarray(v.detach().cpu()) for k, v in m._asdict().items()}


def train_step_case(case, world):
    """Two port train steps of a case in ``world`` (None: one device):
    the first step's metrics and gradients, the parameters after the
    second."""
    settings, state = train_state(case)
    step = make_train_step(settings, state, case["num_random_rays"],
                           case["lambda"], False, case["ray_chunks"],
                           world=world)
    data = [t(case["data"][0]), t(case["data"][1]), t(case["data"][2]),
            torch.from_numpy(case["data"][3])]
    m = step(*data, None, inds=torch.from_numpy(case["inds"][0]))
    out = {"metrics": metrics_of(m), "grads": named_grads(state)}
    step(*data, None, inds=torch.from_numpy(case["inds"][1]))
    out["params"] = named_params(state)
    out["step"] = state.step
    return out


def train_steps(world, cases):
    return [train_step_case(c, world) for c in cases]


def tto_step_case(case, world):
    """One port TTO step of a case's kind in ``world``: its metrics and
    the variables' gradients."""
    settings, state = train_state(case)
    build = (build_se3_refine_optimizer if case["kind"].endswith("se3")
             else build_tto_optimizer)
    variables = tto_variables_from_jax(case["variables"], "cpu")
    st = tto.TTOState(variables,
                      build(config_from_dict(case["cfg"]).optimizer,
                            variables))
    make = {"single": tto.make_tto_step, "batched": tto.make_batched_tto_step,
            "multiview": tto.make_multiview_tto_step,
            "se3": tto.make_se3_refine_step,
            "multiview_se3": tto.make_multiview_se3_refine_step}[case["kind"]]
    step = make(settings, st.optimizer, case["num_random_rays"],
                case["lambda"], True, "cpu", world=world)
    args = [t(a) for a in case["args"]]
    draws = {k: t(v) for k, v in case["draws"].items()}
    _, m = step(st, state.models, *args, None,
                inds=torch.from_numpy(case["inds"]), draws=draws)
    return {"metrics": metrics_of(m),
            "grads": {k: v.grad.numpy() for k, v in st.variables.items()}}


def tto_steps(world, cases):
    return [tto_step_case(c, world) for c in cases]


def render_case(case, world):
    """A case's image through ``make_image_renderer`` in ``world`` and,
    with ``int8``, the int8 image of the same models calibrated by
    ``harness.int8_render_params`` on 16 of the view's rays, with the
    int8 modules' buffers."""
    settings, state = train_state(case)
    models, buffers = state.models, []
    dirs, pose = t(case["dirs"]), t(case["pose"])
    if case.get("int8"):
        # what int8_render_params reads of a Harness
        harness = types.SimpleNamespace(directions=dirs, settings=settings,
                                        cfg=config_from_dict(case["cfg"]))
        models = int8_render_params(harness, models, pose, t(case["z_s"]),
                                    t(case["z_t"]), n_rays=16)
        buffers = [b.numpy() for m in models.values() for b in m.buffers()]
    render = make_image_renderer(settings, case["height"], case["width"],
                                 case["chunksize"], "cpu", world=world)
    rgb = render(models, dirs, pose, t(case["z_s"]), t(case["z_t"]))
    return {"image": rgb.numpy(), "buffers": buffers}


def renders(world, cases):
    return [render_case(c, world) for c in cases]


def capacities(world, cases):
    """``capacity.max_batch_objects`` of each case's settings on this
    rank (the budget from ``CODENERF_HBM_BUDGET_BYTES``)."""
    return [capacity.max_batch_objects(train_state(c)[0],
                                       c["num_random_rays"], c["requested"],
                                       device="cpu") for c in cases]


def recorded(world, fn, *args):
    """``fn(world, *args)`` (``train_cli``'s rank), recording what this
    rank drew: the initial parameters (before rank 0's broadcast), each
    step's image batch and ray indices, and the parameters at the end (no
    TensorBoard: metrics.jsonl alone).  Returns fn's result and the
    record."""
    import sys
    sys.modules["torch.utils.tensorboard"] = None
    from codenerf_tpu_torch.train import loop
    from codenerf_tpu_torch.train import step as step_module

    record = {"batches": [], "inds": []}
    states = []

    def init(*args, **kwargs):
        states.append(init_train_state(*args, **kwargs))
        record["init"] = named_params(states[-1])
        return states[-1]

    def select(*args, **kwargs):
        inds = select_ray_indices(*args, **kwargs)
        record["inds"].append(inds.numpy().copy())
        return inds

    def make(*args, **kwargs):
        train_step = make_train_step(*args, **kwargs)

        def recorded_step(directions, pose, pixels, object_ids, *rest, **kw):
            record["batches"].append((pose.numpy().copy(),
                                      object_ids.numpy().copy()))
            return train_step(directions, pose, pixels, object_ids, *rest,
                              **kw)
        return recorded_step

    select_ray_indices = step_module.select_ray_indices
    loop.init_train_state, loop.make_train_step = init, make
    step_module.select_ray_indices = select
    result = fn(world, *args)
    record["final"] = named_params(states[0])
    return {"result": result, "record": record}


def category_out_of_memory(world, argv, marker):
    """``eval_cli.main(argv)`` (the category protocol) on every rank,
    with rank 1's batched TTO running out of device memory at every
    group it starts, each start recorded as a line of ``marker`` (no
    TensorBoard: metrics.jsonl alone)."""
    import sys
    sys.modules["torch.utils.tensorboard"] = None
    from codenerf_tpu_torch import eval_cli, harness

    def out_of_memory(*args, **kwargs):
        with open(marker, "a") as f:
            f.write("group\n")
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    if world.rank == 1:
        harness.validate_batched = out_of_memory
    return eval_cli.main(argv)


def all_of(world, jobs):
    """Every (function name, cases) job in order, on one world."""
    return [globals()[name](world, cases) for name, cases in jobs]
