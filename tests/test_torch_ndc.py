"""NDC rays on the CPU against the JAX package: ``core.geometry.ndc_rays``
(values, and gradients into the world-space rays, which carry TTO's pose
gradients), the serving render and the train render of
``configs/fern.yml`` cut to hidden 32 under NDC settings as
``Harness.from_config`` makes them (near 0, far 1, ``lindisp``), the
train render fed JAX's jitter and noise draws.  f32, atol 1e-5.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from codenerf_tpu.core.geometry import ndc_rays as j_ndc_rays
from codenerf_tpu.pipeline import render_rays as j_render_rays
from codenerf_tpu_torch.core import ndc_rays
from codenerf_tpu_torch.pipeline import render_rays, render_rays_train
from tests.test_torch_flexible import (jax_grads, port_grads, vanilla_both,
                                       vanilla_dict)
from tests.torch_port_helpers import F32_ATOL, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

NDC = (24.0, 32.0, 28.0)         # H, W, focal in pixels


def _rays(n, seed):
    """Forward-facing rays: origins near the world origin, directions
    down -z with a spread."""
    rng = np.random.default_rng(seed)
    ro = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)),
                         -np.ones((n, 1))], -1).astype(np.float32)
    return ro, rd


def _ndc_both(seed=0):
    js, ps, jstate, _, state = vanilla_both(vanilla_dict("fern.yml"), seed)
    kw = dict(ndc=NDC, near=0.0, far=1.0, spacing_mode="lindisp")
    return (dataclasses.replace(js, **kw), dataclasses.replace(ps, **kw),
            jstate, state)


def test_ndc_rays_and_their_gradients_match_jax():
    ro, rd = _rays(10, 0)
    rng = np.random.default_rng(1)
    wo, wd = (rng.normal(size=(10, 3)).astype(np.float32) for _ in "od")

    def jloss(a, b):
        o, d = j_ndc_rays(a, b, *NDC)
        return jnp.sum(o * wo) + jnp.sum(d * wd)

    (jo, jd) = j_ndc_rays(jnp.asarray(ro), jnp.asarray(rd), *NDC)
    gro, grd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ro),
                                               jnp.asarray(rd))
    tro, trd = t(ro).requires_grad_(), t(rd).requires_grad_()
    o, d = ndc_rays(tro, trd, *NDC)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=F32_ATOL, rtol=1e-6)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd),
                               atol=F32_ATOL, rtol=1e-6)
    # the origins land on the near plane: NDC z = -1
    np.testing.assert_allclose(o[:, 2].detach().numpy(), -1.0, atol=1e-6)
    (torch.sum(o * t(wo)) + torch.sum(d * t(wd))).backward()
    np.testing.assert_allclose(tro.grad.numpy(), np.asarray(gro),
                               atol=F32_ATOL, rtol=1e-5)
    np.testing.assert_allclose(trd.grad.numpy(), np.asarray(grd),
                               atol=F32_ATOL, rtol=1e-5)


def test_serving_render_with_ndc_matches_jax():
    js, ps, jstate, state = _ndc_both(seed=1)
    ro, rd = _rays(12, 2)
    jc, jf = jax.jit(lambda p: j_render_rays(
        p, js, jnp.asarray(ro), jnp.asarray(rd), None, None, None, False))(
        jstate.params)
    oc, of = render_rays(state.models, ps, t(ro), t(rd), None, None)
    for got, want in ((oc, jc), (of, jf)):
        for name in ("rgb", "depth", "acc", "weights"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                atol=F32_ATOL, err_msg=name)


def test_train_render_with_ndc_matches_jax():
    """perturb on, sigma noise on: the port fed JAX's draws renders the
    same colours and depths, and a loss on them gives the same
    parameter gradients."""
    js, ps, jstate, state = _ndc_both(seed=2)
    ro, rd = _rays(12, 3)
    key = jax.random.PRNGKey(5)
    noise = 0.5
    w = np.random.default_rng(4).normal(size=(12, 3)).astype(np.float32)

    def jloss(p):
        c, f = j_render_rays(p, js, jnp.asarray(ro), jnp.asarray(rd), None,
                             None, key, True, noise_std=noise)
        return jnp.sum((c.rgb + f.rgb) * w), (c, f)

    (_, (jc, jf)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jstate.params)
    k1, k2, kc, kf = jax.random.split(key, 4)
    n_c, n_f = js.num_coarse, js.num_coarse + js.num_fine
    draws = {"t_rand": jax.random.uniform(k1, (12, n_c)),
             "u": jax.random.uniform(k2, (12, js.num_fine)),
             "noise_c": jax.random.normal(kc, (12, n_c)),
             "noise_f": jax.random.normal(kf, (12, n_f))}
    oc, of = render_rays_train(state.models, ps, t(ro), t(rd), None, None,
                               None, True, noise,
                               draws={k: t(v) for k, v in draws.items()})
    for got, want in ((oc, jc), (of, jf)):
        np.testing.assert_allclose(got.rgb.detach().numpy(),
                                   np.asarray(want.rgb), atol=F32_ATOL)
        np.testing.assert_allclose(got.depth.detach().numpy(),
                                   np.asarray(want.depth), atol=F32_ATOL)
    torch.sum((oc.rgb + of.rgb) * t(w)).backward()
    got, want = port_grads(state), jax_grads(jg)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL, rtol=0,
                                   err_msg=k)
