"""``benchmark/costs.py`` against the bounds PERF.md's kernel table
records (chip_smoke.py's cost functions at the smoke's shapes) and
model FLOPs counted by hand."""

import pytest

from benchmark import costs

FLAGSHIP = dict(h=256, s=256, F=10)


def k1_image():
    """One 128x128 image: 4 chunks of 4096 rays at S = 32 and 160."""
    return costs.total(costs.k1_cost(4096, S, **FLAGSHIP)
                       for S in (32, 160) for _ in range(4))


def bwd_step(stored):
    return costs.total(costs.bwd_cost(16384, S, **FLAGSHIP, stored=stored)
                       for S in (32, 160))


def k4_flagship():
    """A flagship layer_bwd step: layer_xyz2 and layer_dir1 (per-ray rows)
    and layer_dir2 (a bias) in each pass, R = 16384."""
    return costs.total(costs.k4_cost(16384 * S, 16384, 256, 256, per_ray)
                       for S in (32, 160) for per_ray in (True, True, False))


def k4_vanilla(rays, h, layers):
    return costs.k4_step(dict(rays=rays, h=h, chunks=1, num_layers=layers,
                              skips=(4,), samples=[64, 192]))


@pytest.mark.parametrize("cost, ms, by", [
    (k1_image, 1.777, "operations"),
    (lambda: bwd_step(False), 5.324, "operations"),
    (lambda: bwd_step(True), 3.553, "operations"),
    (k4_flagship, 5.790, "bytes"),
    (lambda: k4_vanilla(16384, 256, 8), 19.88, "bytes"),
    (lambda: k4_vanilla(4096, 64, 4), 0.762, "bytes"),
], ids=["K1", "K2", "K3", "K4", "K4-lego", "K4-fern"])
def test_bounds_match_the_kernel_table(cost, ms, by):
    got, got_by = costs.bound_ms(cost())
    assert got == pytest.approx(ms, abs=6e-4 * max(1.0, ms))
    assert got_by == by


def test_step_costs_sum_their_launches():
    sh = dict(rays=16384, samples=[32, 160], **FLAGSHIP)
    assert costs.k2_step(sh) == bwd_step(False)
    frozen = costs.k2_step(sh, need_dw=False)
    assert frozen["bf16_flops"] < bwd_step(False)["bf16_flops"]
    assert costs.bound_ms(frozen)[0] == pytest.approx(3.547, abs=1e-3)
    lego = dict(rays=16 * 16384, h=256, chunks=16, num_layers=8, skips=(4,),
                samples=[64, 192])
    assert costs.bound_ms(costs.k4_step(lego))[0] == pytest.approx(
        16 * 19.879, rel=1e-4)


@pytest.mark.parametrize("model, weight_grads, flops", [
    # CodeNeRF: per sample 63*256 + 256*256 + 256*257 + 256*256 + 256*256
    # + 256*3, per ray 3*256*256 + 256*256 + 256*257 + 27*256 + 256*3
    ("codenerf", True,
     6 * 16384 * (192 * 279296 + 2 * 335616)),
    ("codenerf", False,
     4 * 16384 * (192 * 279296 + 2 * 335616)),
    # vanilla: per sample 63*256 + 7*256*256 + 63*256 + 256*256 + 256
    # + 256*128 + 128*3, per ray 27*128
    ("flexible", True,
     6 * 262144 * (256 * 589952 + 2 * 3456)),
])
def test_model_flops(model, weight_grads, flops):
    if model == "codenerf":
        sh = dict(model=model, rays=16384, h=256, s=256, t=256, dim_xyz=63,
                  dim_dir=27, samples=[32, 160])
    else:
        sh = dict(model=model, rays=262144, h=256, dim_xyz=63, dim_dir=27,
                  num_layers=8, skips=(4,), samples=[64, 192])
    assert costs.model_flops(sh, weight_grads) == flops
