"""Port parity for the train step: codenerf_tpu_torch's sampling jitter,
volume-render and code-norm gradients, ray gathering, optimizer and whole
train step on the CPU against the JAX package (XLA path), at hidden 32,
codes 16, 4 xyz bands, 16 coarse + 8 fine samples, 2 images of 8x8 and
16 rays each.

Tolerances: f32 atol 1e-5 (the two sum in different orders); the
optimizer 1e-6 (the same f32 update arithmetic); bf16 relRMS 1e-2 per
gradient leaf (one bf16 ulp is 2^-8 relative, and a rounding or a relu
mask may flip at an ulp).

The steps here run the port's Pallas modes, named by their runtime
flags: fused (``use_pallas`` + ``pallas_backward``) unless a test asks
for hybrid (``pallas_hybrid``).  In f32 the port's train step is held
against the JAX XLA path, which computes the same function.  In bf16 it
is held against the JAX Pallas mode it ports, run in interpret mode: the
XLA path rounds to bf16 at other points, and at this size its gradients
differ from JAX's own fused Pallas mode by up to 13% relRMS in the deep
sigma-path leaves (measured), while the port differs from the fused
Pallas mode by 2.5e-4.  The flagship YAML's own path, the ray-structured
one, is held against JAX's XLA path in ``tests/test_torch_xla_path.py``.
"""

import copy

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
from codenerf_tpu.core.metrics import mse2psnr as j_mse2psnr
from codenerf_tpu.models.codes import code_table_norms as j_code_norms
from codenerf_tpu.models.codes import lookup_codes as j_lookup
from codenerf_tpu.ops import fused as jfused
from codenerf_tpu.ops import sampling as jsamp
from codenerf_tpu.ops.volume_render import volume_render as j_volume_render
from codenerf_tpu.pipeline import RenderSettings as JRenderSettings
from codenerf_tpu.pipeline import render_rays as j_render_rays
from codenerf_tpu.train.optim import build_optimizer as j_build_optimizer
from codenerf_tpu.train.state import init_train_state as j_init_state
from codenerf_tpu.train.step import gather_ray_batch as j_gather
from codenerf_tpu.train.step import make_train_step as j_make_train_step
from codenerf_tpu_torch.config import SRN_CARS_CODE, config_from_dict
from codenerf_tpu_torch.core import (pixel_directions, pose_spherical,
                                     select_ray_indices)
from codenerf_tpu_torch.models import CodeTables, code_table_norms
from codenerf_tpu_torch.models.mlp import LAYER_NAMES
from codenerf_tpu_torch.ops.sampling import (base_z_vals, sample_pdf,
                                             sample_stratified)
from codenerf_tpu_torch.ops.volume_render import volume_render
from codenerf_tpu_torch.pipeline import (RenderSettings, draw_train_randoms,
                                         render_rays_train)
from codenerf_tpu_torch.train import (gather_ray_batch, init_train_state,
                                      make_train_step)
from codenerf_tpu_torch.weights import codes_from_jax, params_from_jax
from tests.torch_port_helpers import BF16_REL_RMS, F32_ATOL, rel_rms, t
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

H = W = 8
N_RAYS = 16
NUM_OBJECTS = 3
LAMBDA = 1e-2


def _cfg_dict(compute_dtype, noise_std=0.0, mode="fused", **runtime):
    """The small config in the YAML's layout.  ``mode`` names the trunk's
    path by its runtime flags: "fused" (``use_pallas`` +
    ``pallas_backward``), "hybrid" (``pallas_hybrid``) or "yaml" (the
    YAML's own runtime, the ray-structured path); ``runtime`` overrides
    single flags."""
    d = copy.deepcopy(SRN_CARS_CODE)
    for k in ("nerf_coarse", "nerf_fine"):
        d["models"][k]["hidden_size"] = 32
    d["models"]["embedding"] = {"shape_code_size": 16,
                                "texture_code_size": 16}
    d["nerf"]["point_sampler"].update(num_coarse=16, num_fine=8)
    d["nerf"]["embedder"]["num_encoding_fn_xyz"] = 4
    d["nerf"]["train"]["radiance_field_noise_std"] = noise_std
    d["runtime"].update(compute_dtype=compute_dtype)
    if mode == "hybrid":
        d["runtime"].update(pallas_hybrid=True)
    elif mode == "fused":
        d["runtime"].update(use_pallas=True, pallas_backward=True)
    d["runtime"].update(runtime)
    d["optimizer"].update(lr=1e-2, embedding_lr=5e-2, scheduler_step_size=2)
    return d


def _both(compute_dtype, seed=0, **kw):
    """JAX and port configs, settings and states from one dict, the port
    loaded with the JAX parameters."""
    d = _cfg_dict(compute_dtype, **kw)
    jcfg, pcfg = j_config_from_dict(d), config_from_dict(d)
    js, ps = JRenderSettings.from_config(jcfg), RenderSettings.from_config(
        pcfg)
    jstate, jopt = j_init_state(jax.random.PRNGKey(seed), jcfg, js,
                                NUM_OBJECTS)
    state = init_train_state(pcfg, ps, NUM_OBJECTS, seed=seed, device="cpu")
    params_from_jax(state, jax.tree.map(np.asarray, jstate.params))
    return jcfg, js, ps, jstate, jopt, state


def _data(seed=0):
    rng = np.random.default_rng(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 10.0
    K[0, 2] = K[1, 2] = 4.0
    dirs = np.asarray(j_pixel_dirs(H, W, jnp.asarray(K)))
    pose = np.stack([np.asarray(j_pose(1.2, 0.7 * i, 1.3)) for i in range(2)])
    pixels = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    ids = np.array([0, 2], np.int32)
    return dirs, pose, pixels, ids


# ---- sampling, compositing, codes, rays ----

def test_sample_stratified_jitter_matches_jax():
    rng = np.random.default_rng(1)
    ro, rd = (rng.normal(size=(6, 3)).astype(np.float32) for _ in range(2))
    z = base_z_vals(8, 0.8, 1.8, "lindepth")
    key = jax.random.PRNGKey(3)
    jpts, jz = jsamp.sample_stratified(key, jnp.asarray(ro), jnp.asarray(rd),
                                       jnp.asarray(z.numpy()), True)
    t_rand = jax.random.uniform(key, (6, 8), dtype=jnp.float32)
    pts, zz = sample_stratified(t(ro), t(rd), z, True, t_rand=t(t_rand))
    np.testing.assert_allclose(zz.numpy(), np.asarray(jz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=F32_ATOL)


def test_sample_pdf_jitter_matches_jax():
    rng = np.random.default_rng(2)
    ro, rd = (rng.normal(size=(6, 3)).astype(np.float32) for _ in range(2))
    z_c = np.sort(rng.uniform(0.8, 1.8, (6, 16)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (6, 14)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jpts, jz = jsamp.sample_pdf(key, jnp.asarray(ro), jnp.asarray(rd),
                                jnp.asarray(w), jnp.asarray(z_c), 8, True)
    u = jax.random.uniform(key, (6, 8), dtype=jnp.float32)
    pts, z = sample_pdf(t(ro), t(rd), t(w), t(z_c), 8, True, u=t(u))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-6, rtol=0)
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=F32_ATOL)


def test_jitter_draws_from_the_generator():
    ps = RenderSettings.from_config(config_from_dict(_cfg_dict("float32")))
    ro = torch.zeros(5, 3)
    rd = torch.ones(5, 3)
    z = base_z_vals(ps.num_coarse, 0.8, 1.8, "lindepth")
    lower = torch.cat([z[:1], 0.5 * (z[1:] + z[:-1])])
    a, b = (sample_stratified(ro, rd, z, True, draw_train_randoms(
        ps, 5, torch.Generator().manual_seed(0))["t_rand"]) for _ in "ab")
    assert torch.equal(a[1], b[1]) and not a[1].requires_grad
    assert bool((a[1] >= lower).all()) and not torch.equal(a[1][0], z)
    with pytest.raises(ValueError, match="generator"):
        draw_train_randoms(ps, 5, None)
    with pytest.raises(ValueError, match="t_rand"):
        sample_stratified(ro, rd, z, True)


def test_volume_render_grads_match_jax():
    rng = np.random.default_rng(5)
    raw = rng.normal(size=(6, 8, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.8, 1.8, (6, 8)), axis=-1).astype(np.float32)
    rd = rng.normal(size=(6, 3)).astype(np.float32)
    gw = [rng.normal(size=s).astype(np.float32)
          for s in ((6, 3), (6, 8), (6,), (6,))]

    def jloss(r, d):
        o = j_volume_render(r, jnp.asarray(z), d)
        return (jnp.sum(o.rgb * gw[0]) + jnp.sum(o.weights * gw[1])
                + jnp.sum(o.depth * gw[2]) + jnp.sum(o.acc * gw[3]))

    jr, jd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(raw), jnp.asarray(rd))
    tr, td = t(raw).requires_grad_(), t(rd).requires_grad_()
    o = volume_render(tr, t(z), td)
    (torch.sum(o.rgb * t(gw[0])) + torch.sum(o.weights * t(gw[1]))
     + torch.sum(o.depth * t(gw[2])) + torch.sum(o.acc * t(gw[3]))
     ).backward()
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jr), atol=F32_ATOL)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jd), atol=F32_ATOL)


def test_code_table_norms_grads_match_jax():
    rng = np.random.default_rng(1)
    jt = {"shape": jnp.asarray(rng.normal(size=(3, 16)), jnp.float32),
          "texture": jnp.asarray(rng.normal(size=(3, 8)), jnp.float32)}
    want = jax.grad(lambda c: (lambda n: 2.0 * n[0] + 3.0 * n[1])(
        j_code_norms(c)))(jt)
    tables = CodeTables(3, 16, 8, device="cpu")
    tables.load_state_dict(codes_from_jax(jax.tree.map(np.asarray, jt)))
    ns, nt = code_table_norms(tables)
    jns, jnt = j_code_norms(jt)
    np.testing.assert_allclose([float(ns.detach()), float(nt.detach())],
                               [jns, jnt], rtol=1e-6)
    (2.0 * ns + 3.0 * nt).backward()
    np.testing.assert_allclose(tables.shape_embedding.weight.grad,
                               np.asarray(want["shape"]), atol=1e-7)
    np.testing.assert_allclose(tables.texture_embedding.weight.grad,
                               np.asarray(want["texture"]), atol=1e-7)


def test_select_ray_indices_distinct_and_bounded():
    gen = torch.Generator().manual_seed(0)
    inds = select_ray_indices(gen, 64, 16, 3)
    assert inds.shape == (3, 16)
    for row in inds:
        assert len(set(row.tolist())) == 16
        assert 0 <= int(row.min()) and int(row.max()) < 64
    with pytest.raises(AssertionError):
        select_ray_indices(gen, 64, 65, 1)


def test_gather_ray_batch_matches_jax():
    dirs, pose, pixels, ids = _data(3)
    key = jax.random.PRNGKey(9)
    want = j_gather(*map(jnp.asarray, (dirs, pose, pixels, ids)), key, N_RAYS)
    inds = np.array(j_select(key, H * W, N_RAYS, 2))
    got = gather_ray_batch(t(dirs), t(pose), t(pixels),
                           torch.from_numpy(ids), None, N_RAYS,
                           torch.from_numpy(inds))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_ATOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


# ---- optimizer ----

def test_optimizer_matches_optax_over_three_steps():
    jcfg, _, _, jstate, _, state = _both(None, seed=2)
    opt = j_build_optimizer(jcfg.optimizer)
    params = jstate.params
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
            params)
        for key in ("coarse", "fine"):
            for name in LAYER_NAMES:
                layer = getattr(state.models[key], name)
                layer.weight.grad = t(np.asarray(grads[key][name]["w"]).T)
                layer.bias.grad = t(grads[key][name]["b"])
        state.tables.shape_embedding.weight.grad = t(grads["codes"]["shape"])
        state.tables.texture_embedding.weight.grad = t(
            grads["codes"]["texture"])
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        state.optimizer.step()
        state.scheduler.step()
        for key in ("coarse", "fine"):
            for name in LAYER_NAMES:
                layer = getattr(state.models[key], name)
                np.testing.assert_allclose(
                    layer.weight.detach().numpy().T,
                    np.asarray(params[key][name]["w"]), atol=1e-6, rtol=0)
                np.testing.assert_allclose(
                    layer.bias.detach().numpy(),
                    np.asarray(params[key][name]["b"]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            state.tables.shape_embedding.weight.detach().numpy(),
            np.asarray(params["codes"]["shape"]), atol=1e-6, rtol=0)


def test_optimizer_refuses_lbfgs_and_unknown_names():
    from codenerf_tpu_torch.config import OptimizerConfig
    from codenerf_tpu_torch.train import build_optimizer
    *_, state = _both(None)
    for name in ("LBFGS", "NoSuchOptimizer"):
        with pytest.raises(ValueError):
            build_optimizer(OptimizerConfig(type=name), state.models,
                            state.tables)


# ---- the train step ----

def _port_grads(state):
    out = {}
    for key in ("coarse", "fine"):
        for name in LAYER_NAMES:
            layer = getattr(state.models[key], name)
            out[f"{key}.{name}.w"] = layer.weight.grad.numpy().T
            out[f"{key}.{name}.b"] = layer.bias.grad.numpy()
    out["codes.shape"] = state.tables.shape_embedding.weight.grad.numpy()
    out["codes.texture"] = state.tables.texture_embedding.weight.grad.numpy()
    return out


def _jax_loss_and_grads(js, params, data, k_sel, k_render):
    dirs, pose, pixels, ids = map(jnp.asarray, data)

    def loss_fn(p):
        ro, rd, target, rids = j_gather(dirs, pose, pixels, ids, k_sel,
                                        N_RAYS)
        z_s, z_t = j_lookup(p["codes"], rids)
        c, f = j_render_rays({"coarse": p["coarse"], "fine": p["fine"]}, js,
                             ro, rd, z_s, z_t, k_render, False)
        R = ro.shape[0]
        lc = jnp.sum((c.rgb - target[:, :3]) ** 2) / (R * 3)
        lf = jnp.sum((f.rgb - target[:, :3]) ** 2) / (R * 3)
        ns, nt = j_code_norms(p["codes"])
        le = LAMBDA * (ns + nt)
        return lc + lf + le, (lc, lf, le)

    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    flat = {}
    for key in ("coarse", "fine"):
        for name in LAYER_NAMES:
            for p in ("w", "b"):
                flat[f"{key}.{name}.{p}"] = np.asarray(grads[key][name][p])
    flat["codes.shape"] = np.asarray(grads["codes"]["shape"])
    flat["codes.texture"] = np.asarray(grads["codes"]["texture"])
    return (float(loss), *map(float, aux)), flat


def _port_step(ps, state, data, inds, ray_chunks=1):
    dirs, pose, pixels, ids = data
    step = make_train_step(ps, state, N_RAYS, LAMBDA, False, ray_chunks)
    return step(t(dirs), t(pose), t(pixels), torch.from_numpy(ids), None,
                inds=torch.from_numpy(inds))


@pytest.fixture
def jax_pallas_modes(monkeypatch):
    """Let the JAX pipeline take its Pallas modes on the CPU: its gates
    ask for a TPU backend, and pallas_call runs in interpret mode."""
    orig = jfused.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jfused.pl, "pallas_call", interp)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def check_step(m, losses, got, want, compute_dtype):
    """A port step's metrics and gradient leaves against JAX's."""
    loss, lc, lf, le = losses
    # a loss is a mean over many bf16-rounded values, so it agrees to well
    # under one bf16 ulp (2^-8 = 3.9e-3 relative)
    rtol = 1e-5 if compute_dtype == "float32" else 1e-3
    np.testing.assert_allclose(
        [float(m.loss), float(m.loss_coarse), float(m.loss_fine),
         float(m.loss_embedding)], [loss, lc, lf, le], rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(float(m.psnr), float(j_mse2psnr(lf)),
                               rtol=rtol)
    for k in want:
        if compute_dtype == "float32":
            np.testing.assert_allclose(got[k], want[k], atol=F32_ATOL,
                                       rtol=0, err_msg=k)
        else:
            assert rel_rms(got[k], want[k]) <= BF16_REL_RMS, k


def step_against_jax(js, ps, jstate, state, compute_dtype, seed=4):
    """One port step and JAX's loss and grads from the same state, data
    and ray indices (perturb off), checked by ``check_step``."""
    data = _data(seed)
    k_sel, k_render = jax.random.split(jax.random.PRNGKey(11))
    losses, want = _jax_loss_and_grads(js, jstate.params, data, k_sel,
                                       k_render)
    inds = np.array(j_select(k_sel, H * W, N_RAYS, 2))
    m = _port_step(ps, state, data, inds)
    check_step(m, losses, _port_grads(state), want, compute_dtype)
    assert state.step == 1


@pytest.mark.parametrize("compute_dtype,hybrid", [
    ("float32", False), ("float32", True), ("bfloat16", False),
    ("bfloat16", True)])
def test_train_step_loss_and_grads_match_jax(compute_dtype, hybrid,
                                             request):
    _, js, ps, jstate, _, state = _both(
        compute_dtype, seed=3, mode="hybrid" if hybrid else "fused")
    if compute_dtype == "bfloat16":
        request.getfixturevalue("jax_pallas_modes")
    step_against_jax(js, ps, jstate, state, compute_dtype)


def test_make_train_step_metrics_match_jax():
    """One call of each package's make_train_step, from the same state and
    the same ray indices (f32, perturb off)."""
    _, js, ps, jstate, jopt, state = _both("float32", seed=5)
    data = _data(6)
    key = jax.random.PRNGKey(13)
    inds = np.array(j_select(jax.random.split(key)[0], H * W, N_RAYS, 2))
    m = _port_step(ps, state, data, inds)
    jstep = j_make_train_step(js, jopt, N_RAYS, LAMBDA, False)
    _, jm = jstep(jstate, *map(jnp.asarray, data), key)
    for name in ("loss", "loss_coarse", "loss_fine", "loss_embedding",
                 "psnr"):
        assert isinstance(getattr(m, name), torch.Tensor)
        np.testing.assert_allclose(float(getattr(m, name)),
                                   float(getattr(jm, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_chunked_step_gives_the_same_grads():
    data = _data(7)
    inds = np.array(j_select(jax.random.PRNGKey(2), H * W, N_RAYS, 2))
    results = []
    for chunks in (1, 2):
        *_, ps, _, _, state = _both("float32", seed=6)
        m = _port_step(ps, state, data, inds, ray_chunks=chunks)
        results.append((float(m.loss), _port_grads(state)))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-6)
    for k, v in results[0][1].items():
        np.testing.assert_allclose(results[1][1][k], v, atol=1e-7, err_msg=k)


def test_train_render_with_jitter_and_noise_matches_jax():
    """perturb=True with the sigma-noise regularizer: the port fed JAX's
    draws (split into coarse / fine jitter and noise as JAX splits its key)
    renders the same colours and depths (f32)."""
    _, js, ps, jstate, _, state = _both("float32", seed=8, noise_std=0.5)
    rng = np.random.default_rng(8)
    ro, rd = (rng.normal(size=(12, 3)).astype(np.float32) for _ in range(2))
    ro = ro * 0.1 + np.array([0.0, 0.0, 1.3], np.float32)
    ids = np.array([0, 1, 2] * 4, np.int32)
    key = jax.random.PRNGKey(21)
    z_s, z_t = j_lookup(jstate.params["codes"], jnp.asarray(ids))
    jc, jf = j_render_rays(
        {"coarse": jstate.params["coarse"], "fine": jstate.params["fine"]},
        js, jnp.asarray(ro), jnp.asarray(rd), z_s, z_t, key, True,
        noise_std=0.5)
    k1, k2, kc, kf = jax.random.split(key, 4)
    n_c, n_f = js.num_coarse, js.num_coarse + js.num_fine
    draws = {"t_rand": jax.random.uniform(k1, (12, n_c)),
             "u": jax.random.uniform(k2, (12, js.num_fine)),
             "noise_c": jax.random.normal(kc, (12, n_c)),
             "noise_f": jax.random.normal(kf, (12, n_f))}
    tids = torch.from_numpy(ids).long()
    oc, of = render_rays_train(
        state.models, ps, t(ro), t(rd),
        state.tables.shape_embedding.weight[tids],
        state.tables.texture_embedding.weight[tids], None, True, 0.5,
        draws={k: t(v) for k, v in draws.items()})
    for got, want in ((oc, jc), (of, jf)):
        np.testing.assert_allclose(got.rgb.detach().numpy(),
                                   np.asarray(want.rgb), atol=F32_ATOL)
        np.testing.assert_allclose(got.depth.detach().numpy(),
                                   np.asarray(want.depth), atol=F32_ATOL)
