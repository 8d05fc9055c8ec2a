"""The bf16 wgmma row pass's launch plan and weight images, on the CPU.

K2's and K3's row pass takes its route from ``ops/plan.py::k2_plan``: bf16
at padded widths up to ``K1_MAX_WIDTH`` with at most ``K1_MAX_BANDS``
bands runs ``trunk_bwd_rows_wgmma`` (``ops/csrc/trunk_bwd.cu``), whose
grid, warpgroup ray ranges, shared memory, weight chunks and image bytes
come from ``trunk_bwd_wgmma_plan``; the kernel refuses a plan that does not
match its own layout.  It reads the cotangent products' weights from the
images ``ops/fused.py::k2_images`` packs.  These tests pin the route, the
shared memory within the per-block limit at every width the route takes,
the chunk order the chain reads, every ray owned by one warpgroup, and the
images read back through the 128-byte swizzle of ``csrc/hopper.cuh`` as the
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
ROWS = ((1, 1), (1, 32), (3, 7), (2, 64), (1000, 24), (4096, 32),
        (4096, 160), (16384, 32), (16384, 160))


@pytest.mark.parametrize("stored", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("case", [
    # (H, SC, F, elem, route): bf16 at K1's widths takes the wgmma row pass
    (256, 256, 10, 2, "wgmma"), (256, 128, 10, 2, "wgmma"),
    (32, 32, 1, 2, "wgmma"), (48, 40, 10, 2, "wgmma"),
    # f32, wider bf16 and more bands take the row-tile pass
    (256, 256, 10, 4, "rows"), (48, 40, 10, 4, "rows"),
    (288, 80, 10, 2, "rows"), (256, 264, 10, 2, "rows"),
    (256, 256, 11, 2, "rows"), (864, 864, 6, 2, "rows")],
    ids=lambda c: f"h{c[0]}-s{c[1]}-F{c[2]}-{'bf16' if c[3] == 2 else 'f32'}")
def test_route_by_dtype_width_and_bands(case, stored):
    H, SC, F, elem, route = case
    p = plan.k2_plan(4096, 32, H, SC, F, True, elem, N_SM, stored)
    assert p["route"] == route
    assert p["recompute"] is (not stored)
    assert (p["h"], p["sc"]) == (plan.padded(H, 32), plan.padded(SC, 32))
    assert p["rows"]["smem"] <= plan.SMEM_LIMIT
    if route == "wgmma":
        # the dW encode is K1's: sin at 0, cos at 32, x at 64, ones at 67
        assert (p["enc_width"], p["kp"]) == (plan.K2_ENC, 32) == (80, 32)
        assert p["small_rows"] == 2 * p["rows"]["grid"]
    else:
        assert p["rows"] == plan.trunk_bwd_plan(
            4096, 32, p["h"], p["sc"], F, True, elem, N_SM, stored)["rows"]


def _smem(H, SC, recompute):
    nh, ns = plan.k1_wgmma_width(H), plan.k1_wgmma_width(SC)
    nm = max(nh, ns)
    fwd = 4 * nh + 4 * plan.K1_RAYS * (2 * nh + ns) if recompute else 0
    # the ring, two activation buffers, the points, g, wr and wos in f32,
    # three relu masks of NH bits a row, K2's biases and staged rows, the
    # barriers and the alignment slack
    return (plan.K2_STAGES * nm * 128 + 2 * 64 * nm * 2 + 2 * 64 * 12
            + 2 * 64 * 16 + 16 * nh + 2 * 3 * 64 * nh // 8 + fwd
            + 16 * plan.K2_STAGES + 1024)


@pytest.mark.parametrize("stored", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("has_x", [True, False], ids=["x", "no-x"])
def test_shared_memory_within_the_limit_at_every_width_the_route_takes(
        has_x, stored):
    widths = range(32, 257, 32)
    for H in widths:
        for SC in widths:
            for F in range(1, 11):
                p = plan.k2_plan(1024, 32, H, SC, F, has_x, 2, N_SM, stored)
                assert p["route"] == "wgmma", (H, SC, F)
                smem = p["rows"]["smem"]
                assert smem == _smem(H, SC, not stored), (H, SC, F)
                assert smem <= plan.SMEM_LIMIT == 232_448, (H, SC, F)


def test_flagship_shared_memory():
    k2 = plan.k2_plan(16384, 160, 256, 256, 10, True, 2, N_SM, False)
    k3 = plan.k2_plan(16384, 160, 256, 256, 10, True, 2, N_SM, True)
    assert k2["rows"]["smem"] == 198_192
    assert k3["rows"]["smem"] == 184_880
    # under the 196 KB carve-out: twice K1's L1 for the consumers' spills
    assert k2["rows"]["smem"] + plan.SMEM_RESERVED <= 196 * 1024
    # K1's layout with its heads but without g, wr and wos
    assert plan.k1_smem(256, 256) == 220_736


@pytest.mark.parametrize("widths", [(256, 256), (256, 128), (128, 256),
                                    (64, 32)], ids=lambda w: f"{w[0]}/{w[1]}")
def test_chunks_in_the_order_the_chain_reads_them(widths):
    H, SC = widths
    nh, ns = plan.k1_wgmma_width(H), plan.k1_wgmma_width(SC)
    k2 = plan.k2_chunks(H, SC, True)
    k3 = plan.k2_chunks(H, SC, False)
    fwd = plan.k1_chunks(H, SC)
    # K2 streams K1's chunks first, then the same chunks as K3
    assert k2[:len(fwd)] == fwd
    base = fwd[-1][1] + fwd[-1][2]
    assert [(n, o - base, b) for n, o, b in k2[len(fwd):]] == k3
    # each cotangent product's B = w [N, K] in chunks of 64 reduction
    # columns: g_v1 (wd2), g_feat (wd), g_h2 (wof), g_h1 (w2), the encode
    want = ([("d_wd2", nh)] * (nh // 64) + [("d_wd", ns)] * (nh // 64)
            + [("d_wof", nh)] * (ns // 64) + [("d_w2", nh)] * (nh // 64)
            + [("d_w1", 80)] * (nh // 64))
    assert [(n, b // 128) for n, _, b in k3] == want
    offs = [o for _, o, _ in k2]
    assert offs == sorted(offs) and all(o % 1024 == 0 for o in offs)
    assert all(o + b == o2 for (_, o, b), (_, o2, _) in zip(k2, k2[1:]))
    p = plan.trunk_bwd_wgmma_plan(64, 32, H, SC, 10, N_SM, False)
    assert p["rows"]["chunks"] == k2
    assert p["rows"]["image_bytes"] == k2[-1][1] + k2[-1][2]


def test_flagship_streams_thirty_eight_chunks():
    k2 = plan.trunk_bwd_wgmma_plan(16384, 160, 256, 256, 10, N_SM, False)
    k3 = plan.trunk_bwd_wgmma_plan(16384, 160, 256, 256, 10, N_SM, True)
    assert len(k2["rows"]["chunks"]) == 38 and len(k3["rows"]["chunks"]) == 20
    assert k2["rows"]["image_bytes"] == 18 * 32768 + 16 * 32768 + 4 * 10240
    assert k3["rows"]["image_bytes"] == 16 * 32768 + 4 * 10240


@pytest.mark.parametrize("R,S", ROWS)
def test_every_ray_owned_by_exactly_one_warpgroup(R, S):
    p = plan.trunk_bwd_wgmma_plan(R, S, 256, 256, 10, N_SM, False)["rows"]
    G = p["grid"]
    assert G == min(N_SM, R) and p["tile_rows"] == 64
    lanes = p["ray_ranges"]
    assert len(lanes) == 2 * G
    assert lanes[0][0] == 0 and lanes[-1][1] == R
    for (a0, a1), (b0, b1) in zip(lanes, lanes[1:]):
        assert a1 == b0 and a0 <= a1
    # the lanes of block b are block b's whole-ray range of the row-tile
    # pass's split
    for b, (r0, r1) in enumerate(plan.even_ranges(R, G)):
        assert (lanes[2 * b][0], lanes[2 * b + 1][1]) == (r0, r1)
    assert p["lane_tiles"] == [-(-(r1 - r0) * S // 64) for r0, r1 in lanes]
    assert p["tiles"] == [max(p["lane_tiles"][2 * b], p["lane_tiles"][2 * b + 1])
                          for b in range(G)]
    # the two warpgroups of a block differ by at most one ray
    assert max(abs((a1 - a0) - (b1 - b0))
               for (a0, a1), (b0, b1) in zip(lanes[::2], lanes[1::2])) <= 1


@pytest.mark.parametrize("H,SC,F", [(288, 256, 10), (256, 512, 10),
                                    (48, 32, 10), (256, 256, 11),
                                    (256, 256, 0)])
def test_shapes_the_kernel_does_not_take_raise(H, SC, F):
    with pytest.raises(ValueError, match="K1_MAX_WIDTH|K1_MAX_BANDS"):
        plan.trunk_bwd_wgmma_plan(64, 32, H, SC, F, N_SM, False)


def _unswizzle(img16, offset, n_pad, N, K):
    """B [N, K] read back from the image at byte ``offset`` as the
    kernel's wgmma descriptors read it: chunk c of 64 reduction columns
    holds n_pad rows of 128 bytes; element (n, k) sits in 16-byte piece
    q = (k % 64) / 8 of row n, at piece position q ^ (n % 8)."""
    n = np.arange(N)[:, None]
    k = np.arange(K)[None, :]
    c, q = k // 64, (k % 64) // 8
    idx = offset // 2 + c * n_pad * 64 + n * 64 + 8 * (q ^ (n % 8)) + k % 8
    return img16[idx]


def _bits(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("stored", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("include_x", [True, False], ids=["x", "no-x"])
@pytest.mark.parametrize("widths", [(64, 32, 6), (256, 128, 10),
                                    (96, 160, 4)],
                         ids=["64/32", "256/128", "96/160"])
def test_images_read_back_as_the_weights(widths, include_x, stored):
    H, SC, F = widths
    cfg = CodeNeRFConfig(hidden_size=H, shape_code_size=SC,
                         texture_code_size=SC, num_encoding_fn_xyz=F,
                         num_encoding_fn_dir=4, include_input_xyz=include_x,
                         compute_dtype="bfloat16")
    model = CodeNeRF(cfg, "cpu", torch.Generator().manual_seed(5))
    weights = fused.kernel_weights(model, F, True)
    p = plan.trunk_bwd_wgmma_plan(4, 8, H, SC, F, N_SM, stored)
    rows = p["rows"]
    img = fused.k2_images(weights, p)
    assert img.dtype == torch.bfloat16
    assert img.numel() * 2 == rows["image_bytes"]
    img16 = _bits(img)
    if not stored:
        # K2's images start with K1's, as K1 packs them
        k1 = plan.trunk_fwd_wgmma_plan(4, 8, H, SC, F, N_SM)
        np.testing.assert_array_equal(
            img16[:k1["image_bytes"] // 2],
            _bits(fused.k1_images(weights, k1)))
    nh, ns = rows["nh"], rows["ns"]

    def padded(w, n, k):
        out = torch.zeros(n, k, dtype=torch.bfloat16)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    # each cotangent product's B = w as stored [N, K], padded to the wgmma
    # widths; the encode product's rows: w1s from 0, w1c from 32, w1x
    # from 64 of 80
    w1 = torch.zeros(80, nh, dtype=torch.bfloat16)
    w1[:3 * F, :H] = weights["w1s"]
    w1[32:32 + 3 * F, :H] = weights["w1c"]
    if include_x:
        w1[64:67, :H] = weights["w1x"]
    wanted = {"d_wd2": padded(weights["wd2"], nh, nh),
              "d_wd": padded(weights["wd"], ns, nh),
              "d_wof": padded(weights["wof"], nh, ns),
              "d_w2": padded(weights["w2"], nh, nh), "d_w1": w1}
    for name, B in wanted.items():
        chunks = [c for c in rows["chunks"] if c[0] == name]
        N, K = B.shape
        assert chunks[0][2] == N * 128 and len(chunks) == K // 64
        got = _unswizzle(img16, chunks[0][1], N, N, K)
        np.testing.assert_array_equal(got, _bits(B), err_msg=name)
