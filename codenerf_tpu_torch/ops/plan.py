"""Launch plans of the port's CUDA kernels, in plain Python.

Each wrapper (``ops/fused.py``, ``ops/layer_bwd.py``) asks this module how
to launch its kernels: rows per tile, shared memory per block, the grid,
which rays or rows each block owns, and how the weight-gradient products
(``csrc/xtg.cuh``) cut their rows into split-K ranges.  The CUDA sources
check the numbers they are given against their own layouts and refuse a
plan that does not match, so the CPU tests of these functions
(``tests/test_torch_kernel_plan.py``) test what the card runs.  Nothing
here imports torch.
"""

from __future__ import annotations

SMEM_LIMIT = 232_448        # dynamic shared memory one block may use
SMEM_PER_SM = 233_472       # shared memory of one SM
SMEM_RESERVED = 1_024       # the runtime's share per resident block
PAD = 8                     # shared-memory row padding of the trunk, elements
KX = 16                     # K of the trunk's x block
XTG_ROWS = 64               # rows per chunk of the dW products
XTG_TILE = {2: (128, 256), 4: (64, 64)}   # (kd, nd) per tile by element size
XTG_SMEM = {2: 4 * 64 * (128 + 256) * 2 + 1024, 4: 32 * (64 + 64) * 4}
XTG_MAX_PRODUCTS = 8
K4_MAX_WIDTH = 256          # bf16 K4 keeps w [K, N] in shared memory
K1_MAX_WIDTH = 256          # bf16 K1: a wgmma's N, and one layer's output
                            # held in a warpgroup's registers
K1_TILE = 128               # bf16 K1: rows per tile, 64 per warpgroup
K1_STAGES = 4               # bf16 K1: weight chunks in flight
K1_CHUNK_K = 64             # bf16 K1: reduction columns per weight chunk
K1_RAYS = 4                 # bf16 K1: rays of per-ray rows staged per tile
K1_MAX_BANDS = 10           # bf16 K1: the encode's 3 F arguments fit 32
                            # columns (sin at 0, cos at 32, x at 64)


def tile_rows(elem: int) -> int:
    """Sample rows per tile: 64 in bf16, 32 in f32 (the same bytes)."""
    return 64 if elem == 2 else 32


def kp_of(F: int) -> int:
    """Rows of the zero-padded sin / cos weight blocks."""
    return (3 * F + 15) // 16 * 16


def ld_of(H: int, SC: int) -> int:
    return max(H, SC) + PAD


def blocks_per_sm(smem: int, cap: int) -> int:
    """Resident blocks of one SM for ``smem`` bytes each, at most ``cap``
    (the kernel's launch bounds)."""
    return max(1, min(cap, SMEM_PER_SM // (smem + SMEM_RESERVED)))


def _check_smem(name: str, smem: int):
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name} needs {smem} B of shared memory per block, "
                         f"above the {SMEM_LIMIT} B limit")


def even_ranges(units: int, parts: int) -> list:
    """[(u0, u1)] for ``parts`` consecutive, nearly equal ranges of
    ``units``: part b owns [b * units // parts, (b + 1) * units // parts),
    as the kernels compute it."""
    return [(b * units // parts, (b + 1) * units // parts)
            for b in range(parts)]


def _trunk_tiles(H: int, SC: int, F: int, elem: int) -> int:
    # two activation buffers, the sin and cos blocks and the x block
    tm, ld, ldk = tile_rows(elem), ld_of(H, SC), kp_of(F) + PAD
    return (2 * tm * ld + 2 * tm * ldk + tm * (KX + PAD)) * elem


def trunk_fwd_smem(H: int, SC: int, F: int, elem: int) -> int:
    # + pts [TM, 3], sigma [TM] and the ray of each row [TM]
    tm = tile_rows(elem)
    return _trunk_tiles(H, SC, F, elem) + tm * 3 * 4 + tm * 4 + tm * 4


def trunk_rows_smem(H: int, SC: int, F: int, elem: int) -> int:
    # + pts [TM, 3], g [TM, 4] and the ray of each row [TM]
    tm = tile_rows(elem)
    return _trunk_tiles(H, SC, F, elem) + tm * 3 * 4 + tm * 4 * 4 + tm * 4


def trunk_fwd_plan(R: int, S: int, H: int, SC: int, F: int, elem: int) -> dict:
    """f32 K1 and K2's recompute chain (both elements): one block per tile
    of consecutive sample rows."""
    if H % 32 or SC % 32:
        raise ValueError(f"the trunk kernels need hidden and code widths "
                         f"that are multiples of 32, got {H} and {SC}")
    tm = tile_rows(elem)
    smem = trunk_fwd_smem(H, SC, F, elem)
    _check_smem(f"K1 at h={H}, s={SC}, F={F}", smem)
    return {"tile_rows": tm, "smem": smem, "blocks": -(-R * S // tm),
            "kp": kp_of(F)}


def k1_wgmma_width(n: int) -> int:
    """The wgmma N that bf16 K1 runs a layer of output width n at: 128 or
    256.  A narrower layer runs zero-padded to it: its weight images have
    zero rows and columns there, so the padded activations are zero."""
    return 128 if n <= 128 else 256


def k1_chunks(H: int, SC: int) -> list:
    """The weight chunks bf16 K1 streams for every tile, in the order the
    chain reads them: (layer, byte offset in the packed image, bytes).  A
    layer's image is its transposed weight [N, K], both padded to the
    wgmma widths, cut into chunks of 64 reduction columns, each N rows of
    128 bytes.  The first layer's K is the encode's 128 columns:
    [w1s^T (32) | w1c^T (32) | w1x^T (16) | 0]."""
    nh, ns = k1_wgmma_width(H), k1_wgmma_width(SC)
    layers = (("w1", nh, 2 * K1_CHUNK_K), ("w2", nh, nh), ("wof", ns, nh),
              ("wd", nh, ns), ("wd2", nh, nh))
    out, off = [], 0
    for name, n, k in layers:
        for _ in range(k // K1_CHUNK_K):
            out.append((name, off, n * 128))
            off += n * 128
    return out


def k1_smem(H: int, SC: int) -> int:
    """bf16 K1's shared memory, in the kernel's order: the weight ring,
    one activation buffer per warpgroup (64 rows, K-major, 128-byte
    swizzled; the encode and every layer's input in turn), the sigma and
    rgb heads' images ([8, NH] each, in 1 KB chunks of 64 columns), each
    warpgroup's 64 points (f32), b1 and bd2 (bf16 [NH] each), each
    warpgroup's staged per-ray rows (zs1p, featp and dirp of ``K1_RAYS``
    rays, bf16), the ring's full and empty mbarriers, and the slack that
    aligns the ring to 1024 bytes."""
    nh, ns = k1_wgmma_width(H), k1_wgmma_width(SC)
    nm = max(nh, ns)
    return (K1_STAGES * nm * 128 + 2 * 64 * nm * 2 + 2 * (nh // 64) * 1024
            + 2 * 64 * 3 * 4 + 2 * nh * 2 + 2 * K1_RAYS * (2 * nh + ns) * 2
            + 2 * K1_STAGES * 8 + 1024)


def trunk_fwd_wgmma_plan(R: int, S: int, H: int, SC: int, F: int,
                         n_sm: int) -> dict:
    """bf16 K1: a persistent grid of at most one block per SM, each
    walking a range of consecutive 128-row tiles (``even_ranges`` over the
    tiles; block b owns rows [row_ranges[b])), with the weight chunks of
    ``k1_chunks`` streamed through a ring of ``K1_STAGES`` stages."""
    for name, n in (("hidden", H), ("code", SC)):
        if n % 32 or not 32 <= n <= K1_MAX_WIDTH:
            raise ValueError(
                f"K1 in bfloat16 needs a {name} width that is a multiple of "
                f"32 and at most {K1_MAX_WIDTH} (K1_MAX_WIDTH), got {n}")
    if not 1 <= F <= K1_MAX_BANDS:
        raise ValueError(f"K1 in bfloat16 encodes at most {K1_MAX_BANDS} "
                         f"bands (K1_MAX_BANDS), got {F}")
    if R < 0 or S < 1:
        raise ValueError(f"K1 needs R >= 0 and S >= 1, got R={R}, S={S}")
    smem = k1_smem(H, SC)
    _check_smem(f"K1 at h={H}, s={SC}", smem)
    chunks = k1_chunks(H, SC)
    M = R * S
    tiles = -(-M // K1_TILE)
    grid = min(n_sm, tiles)
    ranges = even_ranges(tiles, grid) if grid else []
    return {"tile_rows": K1_TILE, "smem": smem, "grid": grid,
            "tiles": tiles, "tile_ranges": ranges,
            "row_ranges": [(t0 * K1_TILE, min(t1 * K1_TILE, M))
                           for t0, t1 in ranges],
            "nh": k1_wgmma_width(H), "ns": k1_wgmma_width(SC),
            "chunks": chunks,
            "image_bytes": chunks[-1][1] + chunks[-1][2]}


def xtg_plan(products, elem: int, n_sm: int) -> dict:
    """The split-K plan of tall products C[kd, nd] = A^T B over M rows.

    ``products`` is a list of (M, kd, nd).  Each output tile of the
    element type's tile shape is cut into ``splits`` ranges of 64-row
    chunks (``even_ranges`` over the chunks), one block a (tile, range),
    about one block per SM (bf16; four in f32) over all products.  Blocks
    are numbered product by product, tile-major; each product's partials
    [splits, kd, nd] follow each other in one f32 buffer and are summed in
    split order."""
    if not 1 <= len(products) <= XTG_MAX_PRODUCTS:
        raise ValueError(f"xtg takes 1 to {XTG_MAX_PRODUCTS} products, got "
                         f"{len(products)}")
    bk, bn = XTG_TILE[elem]
    tiles = []
    for M, kd, nd in products:
        if M < 1 or kd < 1 or nd < 1 or kd % 8 or nd % 8:
            raise ValueError(f"xtg needs M >= 1 and kd, nd multiples of 8, "
                             f"got M={M}, kd={kd}, nd={nd}")
        tiles.append((-(-kd // bk), -(-nd // bn)))
    target = n_sm * (1 if elem == 2 else 4)
    per_tile = max(1, target // sum(tk * tn for tk, tn in tiles))
    out, first, part_off = [], 0, 0
    for (M, kd, nd), (tk, tn) in zip(products, tiles):
        chunks = -(-M // XTG_ROWS)
        splits = min(per_tile, chunks)
        out.append({"M": M, "kd": kd, "nd": nd, "tiles_k": tk, "tiles_n": tn,
                    "splits": splits, "first_block": first,
                    "blocks": tk * tn * splits, "part_offset": part_off,
                    "chunk_ranges": even_ranges(chunks, splits)})
        first += tk * tn * splits
        part_off += splits * kd * nd
    smem = XTG_SMEM[elem]
    _check_smem("xtg", smem)
    return {"products": out, "blocks": first, "part_floats": part_off,
            "smem": smem, "tile": (bk, bn)}


def trunk_bwd_plan(R: int, S: int, H: int, SC: int, F: int, has_x: bool,
                   elem: int, n_sm: int, stored: bool) -> dict:
    """K2 (``stored`` False) or K3: the row pass (K2's runs the forward
    again first), then the dW products.  The row pass is a persistent grid of
    whole-ray ranges; its dW operands are the encode [sin | cos | x 1]
    (the ones give db1) and h1 h2 feat v1 against g_h1 g_h2 g_feat g_v1
    g_v2.  dwos, dwr and dbd2 are per-block sums (``small_width``
    floats a block)."""
    if R < 1 or S < 1:
        raise ValueError(f"the trunk backward needs at least one sample, got "
                         f"R={R}, S={S}")
    trunk_fwd_plan(R, S, H, SC, F, elem)      # the widths K1's chain takes
    smem = trunk_rows_smem(H, SC, F, elem)
    _check_smem(f"the trunk backward at h={H}, s={SC}, F={F}", smem)
    grid = min(R, n_sm * blocks_per_sm(smem, 2))
    kp = kp_of(F)
    enc_width = 2 * kp + KX     # sin | cos | x (3) and a column of ones
    M = R * S
    names = ("w1", "w2", "wof", "wd", "wd2")
    shapes = ((enc_width, H), (H, H), (H, SC), (SC, H), (H, H))
    gemm = xtg_plan([(M, kd, nd) for kd, nd in shapes], elem, n_sm)
    for name, p in zip(names, gemm["products"]):
        p["name"] = name
    return {"recompute": not stored,
            "rows": {"tile_rows": tile_rows(elem), "smem": smem, "grid": grid,
                     "ray_ranges": even_ranges(R, grid)},
            "enc_width": enc_width, "kp": kp, "small_width": 5 * H,
            "gemm": gemm}


def layer_bwd_smem(K: int, N: int, elem: int) -> int:
    if elem == 2:
        # w and gp in 64-column blocks, the dx tile, db, alignment slack
        ncb = -(-N // 64)
        return (ncb * (K4_MAX_WIDTH * 128 + 64 * 128) + 64 * (K + 8) * 2
                + N * 4 + 1024)
    # the gp tile (row stride N + 4) and db
    return tile_rows(4) * (N + 4) * 4 + N * 4


def layer_bwd_plan(M: int, S: int, K: int, N: int, per_ray: bool, elem: int,
                   n_sm: int) -> dict:
    """K4: the row pass (mask, dx, db) as a persistent grid whose blocks
    own whole rays (whole tiles for a bias), then dw = x^T gp."""
    if K % 16 or N % 16:
        raise ValueError(f"K4 needs K and N that are multiples of 16, got "
                         f"w ({K}, {N})")
    if elem == 2 and (K > K4_MAX_WIDTH or N > K4_MAX_WIDTH):
        raise ValueError(f"K4 in bfloat16 keeps w in shared memory: K and N "
                         f"at most {K4_MAX_WIDTH}, got w ({K}, {N})")
    if M < 1 or (per_ray and M % S):
        raise ValueError(f"K4 needs whole rays, got M={M}, S={S}")
    tm = tile_rows(elem)
    smem = layer_bwd_smem(K, N, elem)
    _check_smem(f"K4 at N={N}", smem)
    units = M // S if per_ray else -(-M // tm)
    grid = min(units, n_sm * blocks_per_sm(smem, 1 if elem == 2 else 2))
    unit = S if per_ray else tm
    rows = [(u0 * unit, min(u1 * unit, M))
            for u0, u1 in even_ranges(units, grid)]
    return {"rows": {"tile_rows": tm, "smem": smem, "grid": grid,
                     "row_ranges": rows},
            "gemm": xtg_plan([(M, K, N)], elem, n_sm)}


def xtg_rows(gemm: dict, operands, part_ptr: int) -> list:
    """The flat int64 plan ``csrc/xtg.cuh::run`` reads: for each product
    a, b, part, out (addresses), M, lda, kd, ldb, nd, splits, first_block,
    tiles_n, then the grid's blocks.  ``operands`` holds (a, lda, b, ldb,
    out) per product; ``part_ptr`` is the f32 partial buffer."""
    rows = []
    for p, (a, lda, b, ldb, out) in zip(gemm["products"], operands,
                                        strict=True):
        rows += [a, b, part_ptr + 4 * p["part_offset"], out, p["M"], lda,
                 p["kd"], ldb, p["nd"], p["splits"], p["first_block"],
                 p["tiles_n"]]
    return rows + [gemm["blocks"]]
