"""bf16 K1's launch plan and weight images, on the CPU.

The persistent wgmma K1 (``ops/csrc/trunk_fwd.cu``) takes its grid, tile
ranges, shared memory and weight-image size from
``ops/plan.py::trunk_fwd_wgmma_plan`` and refuses a plan that does not
match its own layout; it reads the weights from the images that
``ops/fused.py::k1_images`` packs.  These tests pin both: every sample row
owned by exactly one block, shared memory within the per-block limit, the
widths the kernel takes, and the packed images read back, through the
128-byte swizzle that ``csrc/hopper.cuh`` describes, as the transposed
weights themselves.
"""

import numpy as np
import pytest
import torch

from codenerf_tpu_torch.models import CodeNeRF
from codenerf_tpu_torch.models.mlp import CodeNeRFConfig
from codenerf_tpu_torch.ops import fused, plan
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

N_SM = 132                     # an H100 SXM
# (H, SC, F): srn-cars-code*.yml, srn-cars.yml, and the tests' narrow widths
WIDTHS = {"256/256": (256, 256, 10), "256/128": (256, 128, 10),
          "64/32": (64, 32, 6), "32/32": (32, 32, 4), "96/160": (96, 160, 10)}
# R * S from one row to the fused train step's fine pass
ROWS = ((1, 1), (1, 32), (3, 7), (2, 64), (1000, 24), (4096, 32),
        (4096, 160), (16384, 32), (16384, 160))


@pytest.mark.parametrize("R,S", ROWS)
def test_every_row_owned_by_exactly_one_block(R, S):
    p = plan.trunk_fwd_wgmma_plan(R, S, 256, 256, 10, N_SM)
    M = R * S
    assert p["tile_rows"] == plan.K1_TILE == 128
    assert p["tiles"] == -(-M // 128)
    assert p["grid"] == min(N_SM, p["tiles"]) == len(p["row_ranges"])
    rows = p["row_ranges"]
    assert rows[0][0] == 0 and rows[-1][1] == M
    for (a0, a1), (b0, b1) in zip(rows, rows[1:]):
        assert a1 == b0
    # every block owns whole tiles, at least one, and no more than one
    # tile above any other block
    sizes = [t1 - t0 for t0, t1 in p["tile_ranges"]]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert all(r0 % 128 == 0 for r0, _ in rows)


@pytest.mark.parametrize("widths", WIDTHS.values(), ids=WIDTHS.keys())
def test_shared_memory_within_the_limit(widths):
    H, SC, F = widths
    p = plan.trunk_fwd_wgmma_plan(4096, 32, H, SC, F, N_SM)
    assert p["smem"] <= plan.SMEM_LIMIT == 232_448
    # the ring, two activation buffers, the heads' images, the points, the
    # biases, the staged per-ray rows and the barriers, as the kernel lays
    # them out
    nm = max(p["nh"], p["ns"])
    assert p["nh"] >= H and p["ns"] >= SC and {p["nh"], p["ns"]} <= {128, 256}
    assert p["smem"] == (plan.K1_STAGES * nm * 128 + 2 * 64 * nm * 2
                         + 2 * 1024 * p["nh"] // 64 + 2 * 64 * 12
                         + 4 * p["nh"]
                         + 4 * plan.K1_RAYS * (2 * p["nh"] + p["ns"])
                         + 16 * plan.K1_STAGES + 1024)


def test_flagship_streams_eighteen_chunks_of_32_kb():
    p = plan.trunk_fwd_wgmma_plan(4096, 32, 256, 256, 10, N_SM)
    assert [c[0] for c in p["chunks"]] == (["w1"] * 2 + ["w2"] * 4
                                           + ["wof"] * 4 + ["wd"] * 4
                                           + ["wd2"] * 4)
    assert {c[2] for c in p["chunks"]} == {256 * 128}
    assert p["image_bytes"] == 18 * 32768
    offs = [c[1] for c in p["chunks"]]
    assert offs == sorted(offs) and all(o % 1024 == 0 for o in offs)


@pytest.mark.parametrize("H,SC", [(288, 256), (256, 512), (48, 32),
                                  (256, 100), (0, 32)])
def test_widths_the_kernel_does_not_take_raise(H, SC):
    with pytest.raises(ValueError, match="K1_MAX_WIDTH"):
        plan.trunk_fwd_wgmma_plan(64, 32, H, SC, 10, N_SM)


@pytest.mark.parametrize("F", [0, 11, 16])
def test_band_counts_the_encode_does_not_hold_raise(F):
    with pytest.raises(ValueError, match="K1_MAX_BANDS"):
        plan.trunk_fwd_wgmma_plan(64, 32, 256, 256, F, N_SM)


def _unswizzle(img16, offset, n_pad, N, K):
    """wT [N, K] read back from the image at byte ``offset`` as the
    kernel's wgmma descriptors read it: chunk c of 64 reduction columns
    holds n_pad rows of 128 bytes; element (n, k) sits in 16-byte piece
    q = (k % 64) / 8 of row n, at piece position q ^ (n % 8)."""
    out = np.zeros((N, K), dtype=np.uint16)
    base = offset // 2
    for n in range(N):
        for k in range(K):
            c, q = k // 64, (k % 64) // 8
            out[n, k] = img16[base + c * n_pad * 64 + n * 64
                              + 8 * (q ^ (n % 8)) + k % 8]
    return out


def _bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("include_x", [True, False], ids=["x", "no-x"])
@pytest.mark.parametrize("widths", [(64, 32, 6), (256, 128, 10),
                                    (96, 160, 4)],
                         ids=["64/32", "256/128", "96/160"])
def test_images_read_back_as_the_transposed_weights(widths, include_x):
    H, SC, F = widths
    cfg = CodeNeRFConfig(hidden_size=H, shape_code_size=SC,
                         texture_code_size=SC, num_encoding_fn_xyz=F,
                         num_encoding_fn_dir=4, include_input_xyz=include_x,
                         compute_dtype="bfloat16")
    model = CodeNeRF(cfg, "cpu", torch.Generator().manual_seed(3))
    weights = fused.kernel_weights(model, F, True)
    p = plan.trunk_fwd_wgmma_plan(4, 8, H, SC, F, N_SM)
    img = fused.k1_images(weights, p)
    assert img.dtype == torch.bfloat16
    assert img.numel() * 2 == p["image_bytes"]
    img16 = _bits(img)
    nh, ns = p["nh"], p["ns"]
    # every image [N, K] padded to the wgmma widths; the first layer's K
    # is the encode's 128 columns: sin from 0, cos from 32, x from 64
    w1 = torch.zeros(nh, 128, dtype=torch.bfloat16)
    w1[:H, :3 * F] = weights["w1s"].t()
    w1[:H, 32:32 + 3 * F] = weights["w1c"].t()
    if include_x:
        w1[:H, 64:67] = weights["w1x"].t()

    def padded(w, n, k):
        out = torch.zeros(n, k, dtype=torch.bfloat16)
        out[:w.shape[1], :w.shape[0]] = w.t()
        return out

    wanted = {"w1": w1, "w2": padded(weights["w2"], nh, nh),
              "wof": padded(weights["wof"], ns, nh),
              "wd": padded(weights["wd"], nh, ns),
              "wd2": padded(weights["wd2"], nh, nh)}
    for name, wT in wanted.items():
        chunks = [c for c in p["chunks"] if c[0] == name]
        N, K = wT.shape
        assert chunks[0][2] == N * 128 and len(chunks) == K // 64
        got = _unswizzle(img16, chunks[0][1], N, N, K)
        np.testing.assert_array_equal(got, _bits(wT), err_msg=name)
