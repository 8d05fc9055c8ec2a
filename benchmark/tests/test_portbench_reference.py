"""The plain reference (``benchmark/reference/``) against the port at
small widths on the CPU, in float32: each piece against the port's
function, then whole steps of every cell through the harness, which
must judge them correct with the committed limits."""

import math
import time

import pytest
import torch

from benchmark import compare, drive
from benchmark.reference import nerf, steps
from benchmark.tests.conftest import tiny_cell

from codenerf_tpu_torch.core import encoding, geometry
from codenerf_tpu_torch.models.mlp import (CodeNeRF, CodeNeRFConfig,
                                           FlexibleNeRF, FlexibleNeRFConfig)
from codenerf_tpu_torch.models.ray_structured import (apply_codenerf_rays,
                                                      apply_flexible_rays)
from codenerf_tpu_torch.ops import sampling, volume_render

GEN = 7


def _close(a, b, tol=1e-5):
    assert torch.allclose(a, b, rtol=tol, atol=tol), float((a - b).abs().max())


def test_encoding_and_pose_match_the_port():
    g = torch.Generator().manual_seed(GEN)
    x = torch.randn(5, 7, 3, generator=g)
    _close(nerf.encode(x, 10), encoding.positional_encoding(x, 10))
    ang = torch.rand(3, 4, generator=g) * 3
    _close(nerf.pose_spherical(*ang), geometry.pose_spherical(*ang))


def test_sampling_and_composite_match_the_port():
    g = torch.Generator().manual_seed(GEN)
    R, S, Sf = 64, 16, 24
    grid = nerf.depth_grid(S, 0.8, 1.8, "cpu")
    _close(grid, sampling.base_z_vals(S, 0.8, 1.8, "lindepth"))
    t = torch.rand(R, S, generator=g)
    ro, rd = torch.randn(R, 3, generator=g), torch.randn(R, 3, generator=g)
    z = nerf.stratified(grid, t)
    _close(z, sampling.sample_stratified(ro, rd, grid, True, t)[1])
    raw = torch.randn(R, S, 4, generator=g)
    rgb, w = nerf.composite(raw, z, rd)
    out = volume_render.volume_render(raw, z, rd)
    _close(rgb, out.rgb)
    _close(w, out.weights)
    u = torch.rand(R, Sf, generator=g)
    _close(nerf.importance(z, w[:, 1:-1], u),
           sampling.sample_pdf(ro, rd, w[:, 1:-1], z, Sf, True, u)[1],
           1e-4)


def _load(module, params):
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(params[name])


@pytest.mark.parametrize("family", ["codenerf", "flexible"])
def test_forward_matches_the_port(family):
    g = torch.Generator().manual_seed(GEN)
    R, S, h, c = 6, 5, 32, 16
    xyz = nerf.encode(torch.randn(R, S, 3, generator=g), 10)
    dirs = nerf.encode(torch.randn(R, 3, generator=g), 4)
    if family == "codenerf":
        cfg = CodeNeRFConfig(hidden_size=h, shape_code_size=c,
                             texture_code_size=c, num_encoding_fn_xyz=10)
        model = CodeNeRF(cfg, "cpu")
        p = nerf.init_params(nerf.codenerf_shapes(h, c, c, 63, 27), g, "cpu")
        _load(model, p)
        zs, zt = torch.randn(R, c, generator=g), torch.randn(R, c,
                                                            generator=g)
        want = apply_codenerf_rays(model, xyz, dirs, zs, zt)
        got = nerf.codenerf(p, xyz, dirs, zs, zt)
    else:
        cfg = FlexibleNeRFConfig(num_layers=8, hidden_size=h,
                                 num_encoding_fn_xyz=10)
        model = FlexibleNeRF(cfg, "cpu")
        p = nerf.init_params(nerf.flexible_shapes(h, 8, (4,), 63, 27), g,
                             "cpu")
        _load(model, p)
        want = apply_flexible_rays(model, xyz, dirs)
        got = nerf.flexible(p, xyz, dirs, (4,), 8)
    _close(got, want)


@pytest.mark.parametrize("name, decay", [("AdamW", 1e-2), ("Adam", 0.0)])
def test_adam_matches_torch(name, decay):
    g = torch.Generator().manual_seed(GEN)
    a = torch.randn(40, generator=g).requires_grad_()
    b = a.detach().clone().requires_grad_()
    ours = steps.Adam({"a": a}, decay)
    theirs = getattr(torch.optim, name)([b], lr=0.01)
    for _ in range(3):
        grad = torch.randn(40, generator=g)
        a.grad, b.grad = grad.clone(), grad.clone()
        ours.step({"a": 0.01})
        theirs.step()
    _close(a, b, 1e-6)


@pytest.mark.parametrize("name", ["cars-train", "lego-train", "cars-tto"])
def test_whole_steps_match_the_port(name):
    cell = tiny_cell(name)
    run = drive.run_cell(cell, 2**31 + 11, 0.2, False, time.monotonic())
    for v in run["numbers"].values():
        assert math.isfinite(v) and v < 1e-3, run["numbers"]
    correct, check = compare.judge(run["numbers"], cell["limits"])
    assert correct, check
    assert run["attempted"] >= 1 and run["failed"] == 0
