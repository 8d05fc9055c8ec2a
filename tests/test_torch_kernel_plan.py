"""The launch plans of the port's CUDA kernels (``ops/plan.py``), on the CPU.

The kernels check the plan they are given against their own layouts and
refuse a mismatch, so these tests pin what the card runs: shared memory
within the per-block limit, every sample row (and every ray, whole) owned
by exactly one block, the split-K row ranges of the dW products covering
every row chunk once, in a fixed order, and the partial sums laid out
without overlap.  Widths: the flagship's (h = s = 256, F = 10) and
``configs/synth-smoke.yml``'s (h = 64, s = 32, F = 6), in bf16 and f32.
"""

import copy

import pytest
import torch

from codenerf_tpu_torch.config import SRN_CARS_CODE, config_from_dict
from codenerf_tpu_torch.ops import fused, plan
from codenerf_tpu_torch.pipeline import RenderSettings, trunk_path
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

N_SM = 132                     # an H100 SXM
WIDTHS = {"flagship": (256, 256, 10), "synth-smoke": (64, 32, 6)}
ELEMS = {"bf16": 2, "f32": 4}
# (R, S) of the flagship train step's passes, and a ragged one
SHAPES = ((16384, 32), (16384, 160), (1000, 24))


def _covers_once(ranges, total):
    """Consecutive, non-empty-or-empty ranges that tile [0, total)."""
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a0 <= a1
    return True


@pytest.mark.parametrize("elem", ELEMS.values(), ids=ELEMS.keys())
@pytest.mark.parametrize("widths", WIDTHS.values(), ids=WIDTHS.keys())
@pytest.mark.parametrize("R,S", SHAPES)
def test_trunk_forward_plan_covers_every_row_once(R, S, widths, elem):
    H, SC, F = widths
    p = plan.trunk_fwd_plan(R, S, H, SC, F, elem)
    assert p["smem"] <= plan.SMEM_LIMIT
    assert p["tile_rows"] == (64 if elem == 2 else 32)
    # block b owns rows [b * tile, (b + 1) * tile) ∩ [0, R S)
    assert (p["blocks"] - 1) * p["tile_rows"] < R * S <= (
        p["blocks"] * p["tile_rows"])
    # two blocks share an SM, as the kernel's launch bounds ask
    assert plan.blocks_per_sm(p["smem"], 2) == 2


@pytest.mark.parametrize("stored", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("elem", ELEMS.values(), ids=ELEMS.keys())
@pytest.mark.parametrize("widths", WIDTHS.values(), ids=WIDTHS.keys())
@pytest.mark.parametrize("R,S", SHAPES)
def test_trunk_backward_plan(R, S, widths, elem, stored):
    H, SC, F = widths
    p = plan.trunk_bwd_plan(R, S, H, SC, F, True, elem, N_SM, stored)
    rows = p["rows"]
    assert p["recompute"] is not stored
    assert rows["smem"] <= plan.SMEM_LIMIT
    assert plan.blocks_per_sm(rows["smem"], 2) == 2
    assert rows["grid"] == min(R, 2 * N_SM)
    # every ray, whole, in exactly one block: its rows with it
    assert len(rows["ray_ranges"]) == rows["grid"]
    assert _covers_once(rows["ray_ranges"], R)
    assert all(r1 > r0 for r0, r1 in rows["ray_ranges"])
    # the encode operand: sin | cos (kp each) | x (3) and the ones (db1)
    assert p["enc_width"] == 2 * plan.kp_of(F) + plan.KX
    assert p["small_width"] == 5 * H
    gemm = p["gemm"]
    assert gemm["smem"] <= plan.SMEM_LIMIT
    assert [q["name"] for q in gemm["products"]] == ["w1", "w2", "wof", "wd",
                                                     "wd2"]
    assert [(q["kd"], q["nd"]) for q in gemm["products"]] == [
        (p["enc_width"], H), (H, H), (H, SC), (SC, H), (H, H)]


@pytest.mark.parametrize("elem", ELEMS.values(), ids=ELEMS.keys())
@pytest.mark.parametrize("products", [
    [(16384 * 160, 256, 256)],
    [(16384 * 32, 80, 256), (16384 * 32, 256, 256), (16384 * 32, 256, 256),
     (16384 * 32, 256, 256), (16384 * 32, 256, 256)],
    [(1000, 80, 64), (1000, 64, 64), (1000, 64, 32), (1000, 32, 64)],
    [(40, 16, 16)],
], ids=["K4", "trunk", "synth-smoke", "tiny"])
def test_split_k_plan_covers_every_chunk_once_in_a_fixed_order(products,
                                                                elem):
    g = plan.xtg_plan(products, elem, N_SM)
    bk, bn = plan.XTG_TILE[elem]
    assert g["tile"] == (bk, bn) and g["smem"] <= plan.SMEM_LIMIT
    first, part = 0, 0
    for (M, kd, nd), q in zip(products, g["products"]):
        chunks = -(-M // plan.XTG_ROWS)
        assert q["tiles_k"] == -(-kd // bk) and q["tiles_n"] == -(-nd // bn)
        assert 1 <= q["splits"] <= chunks
        # the splits cut the chunks into consecutive ranges; the partials
        # are summed in split order, so the order is the ranges' order
        assert len(q["chunk_ranges"]) == q["splits"]
        assert _covers_once(q["chunk_ranges"], chunks)
        assert q["first_block"] == first
        assert q["blocks"] == q["tiles_k"] * q["tiles_n"] * q["splits"]
        assert q["part_offset"] == part
        first += q["blocks"]
        part += q["splits"] * kd * nd
    assert g["blocks"] == first and g["part_floats"] == part
    # about one block per SM in bf16 (its 197,632 B of shared memory)
    if elem == 2 and g["blocks"] > 1:
        assert g["blocks"] <= N_SM
    # the same inputs give the same plan
    assert plan.xtg_plan(products, elem, N_SM) == g


def test_split_k_rows_are_what_the_kernel_reads():
    g = plan.xtg_plan([(100, 16, 32), (100, 32, 16)], 2, N_SM)
    rows = plan.xtg_rows(g, [(1000, 16, 2000, 32, 3000),
                             (4000, 32, 5000, 16, 6000)], 7000)
    assert len(rows) == 2 * 12 + 1 and rows[-1] == g["blocks"]
    first, second = rows[:12], rows[12:24]
    assert first == [1000, 2000, 7000, 3000, 100, 16, 16, 32, 32,
                     g["products"][0]["splits"], 0, 1]
    assert second[2] == 7000 + 4 * g["products"][1]["part_offset"]
    assert second[10] == g["products"][0]["blocks"]


@pytest.mark.parametrize("elem", ELEMS.values(), ids=ELEMS.keys())
@pytest.mark.parametrize("K,N", [(256, 256), (64, 64), (32, 64)])
@pytest.mark.parametrize("per_ray", [True, False], ids=["per-ray", "bias"])
@pytest.mark.parametrize("R,S", SHAPES)
def test_layer_backward_plan_owns_whole_rays(R, S, K, N, per_ray, elem):
    M = R * S
    p = plan.layer_bwd_plan(M, S, K, N, per_ray, elem, N_SM)
    rows = p["rows"]
    assert rows["smem"] <= plan.SMEM_LIMIT
    assert len(rows["row_ranges"]) == rows["grid"]
    assert _covers_once(rows["row_ranges"], M)
    unit = S if per_ray else rows["tile_rows"]
    # block boundaries fall on whole rays (whole tiles for a bias)
    assert all(r0 % unit == 0 for r0, _ in rows["row_ranges"])
    assert rows["grid"] <= N_SM * (1 if elem == 2 else 2)
    (q,) = p["gemm"]["products"]
    assert (q["M"], q["kd"], q["nd"]) == (M, K, N)


@pytest.mark.parametrize("call,match", [
    (lambda: plan.layer_bwd_plan(64, 8, 24, 32, True, 2, N_SM),
     "multiples of 16"),
    (lambda: plan.layer_bwd_plan(64, 8, 512, 256, True, 2, N_SM),
     "at most 256"),
    (lambda: plan.layer_bwd_plan(60, 8, 32, 32, True, 2, N_SM),
     "whole rays"),
    (lambda: plan.trunk_fwd_plan(4, 8, 48, 32, 10, 2), "multiples of 32"),
    (lambda: plan.trunk_fwd_plan(4, 8, 4096, 4096, 10, 2),
     "shared memory"),
    (lambda: plan.xtg_plan([(10, 12, 16)], 2, N_SM), "multiples of 8"),
    (lambda: plan.xtg_plan([], 2, N_SM), "products"),
])
def test_plans_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_layer_backward_f32_takes_wider_layers_than_bf16():
    """bf16 K4 keeps w in shared memory (K, N <= 256); f32 does not."""
    p = plan.layer_bwd_plan(64 * 8, 8, 512, 512, True, 4, N_SM)
    assert p["rows"]["smem"] <= plan.SMEM_LIMIT


@pytest.mark.parametrize("flags", [
    {"use_pallas": True, "pallas_backward": True},
    {"pallas_hybrid": True},
], ids=["fused", "hybrid"])
def test_f32_kernel_modes_build_their_cuda_plan(flags):
    """f32 in ``use_pallas`` + ``pallas_backward`` (K1 + K2) and
    ``pallas_hybrid`` (K3): the wrappers' plans and kernel inputs, as the
    card would get them, are built without raising."""
    d = copy.deepcopy(SRN_CARS_CODE)
    d["runtime"].update(flags, compute_dtype="float32")
    settings = RenderSettings.from_config(config_from_dict(d))
    assert trunk_path(settings) in ("fused", "hybrid")
    cfg = settings.fine_cfg
    cd = fused._compute_type("K2", cfg.cdtype)
    assert cd == torch.float32
    h = cfg.hidden_size
    F = settings.num_encoding_fn_xyz
    gen = torch.Generator().manual_seed(0)
    from codenerf_tpu_torch.models import CodeNeRF
    model = CodeNeRF(cfg, "cpu", gen)
    R, S = 4, 8
    weights = fused.kernel_weights(model, F, settings.log_sampling_xyz)
    dir_enc = torch.zeros(R, cfg.dim_dir)
    per_ray = fused.per_ray_parts(model, dir_enc, torch.zeros(
        R, cfg.shape_code_size), torch.zeros(R, cfg.texture_code_size))
    pts = torch.zeros(R, S, 3)
    stored = trunk_path(settings) == "hybrid"
    p = plan.trunk_bwd_plan(R, S, h, weights["wof"].shape[1], F,
                            weights["w1x"] is not None, cd.itemsize, N_SM,
                            stored)
    assert p["rows"]["tile_rows"] == 32
    fwd = plan.trunk_fwd_plan(R, S, h, weights["wof"].shape[1], F,
                              cd.itemsize)
    ins = fused._trunk_inputs("K2", pts, per_ray, weights["b1"], weights, cd,
                              fwd["kp"])
    assert set(ins) == set(fused._IN_KEYS)
    assert all(v is None or v.dtype == torch.float32 for v in ins.values())
    assert ins["w2T"].shape == (h, h) and ins["w1sT"].shape == (h, fwd["kp"])


def test_compute_types_the_kernels_take():
    assert fused._compute_type("K1", None) == torch.float32
    assert fused._compute_type("K1", torch.bfloat16) == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused._compute_type("K1", torch.float16)
