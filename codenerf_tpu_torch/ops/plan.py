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
TRUNK_MULTIPLE = 32         # K1-K3 take hidden and code widths that are
                            # multiples of this; the wrappers zero-pad
K4_MULTIPLE = 16            # K4 takes K and N that are multiples of this
K4_GLOBAL_ROWS = 32         # rows per tile of K4's global-memory-w layout
                            # (16 or 8 when N is wider: k4_global_rows)
K4_MAX_WIDTH = 256          # bf16 K4 keeps w [K, N] in shared memory up to
                            # this width; wider, it takes the layout of f32
                            # K4 (w read from global memory), chosen by
                            # shape in ``k4_layout``
K1_MAX_WIDTH = 256          # bf16 K1: a wgmma's N, and one layer's output
                            # held in a warpgroup's registers; wider, K1
                            # runs the row-tile forward of trunk_common.cuh
                            # in bf16, chosen by shape in ``k1_plan``
K1_TILE = 128               # bf16 K1: rows per tile, 64 per warpgroup
K1_STAGES = 4               # bf16 K1: weight chunks in flight
K1_CHUNK_K = 64             # bf16 K1: reduction columns per weight chunk
K1_RAYS = 4                 # bf16 K1: rays of per-ray rows staged per tile
K1_MAX_BANDS = 10           # bf16 K1: the encode's 3 F arguments fit 32
                            # columns (sin at 0, cos at 32, x at 64); more
                            # bands take the row-tile forward, as above
K2_STAGES = 3               # bf16 K2 / K3 row pass: weight chunks in
                            # flight (shared memory under 196 KB)
K2_ENC = 80                 # bf16 K2 / K3 row pass: the encode product's
                            # N and the dW encode's columns, K1's layout
                            # (sin at 0, cos at 32, x at 64, ones at 67)
LAYER_FWD_N = (128, 256)    # the fused linear + relu forward's output
                            # widths: two 64 x 128 accumulators cover a
                            # 64-row tile at 256, a 128-row tile at 128
LAYER_FWD_MAX_K = 256       # its widest K (w^T held in shared memory)
LAYER_FWD_MULTIPLE = 16     # w^T's K, zero-padded to a wgmma step
LAYER_FWD_STAGES = 4        # x tiles in flight by TMA, at most (as many
                            # as shared memory holds); 1 on the register
                            # route of a K that is not a multiple of 8


def padded(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple``: the width a kernel
    runs a layer at, zero-padded (zero weights, biases and per-ray rows,
    so padded units stay 0 through every relu and their gradients are 0)."""
    return -(-n // multiple) * multiple


def tile_rows(elem: int) -> int:
    """Sample rows of a full tile: 64 in bf16, 32 in f32 (the same
    bytes)."""
    return 64 if elem == 2 else 32


def row_tile(full: int, smem_of) -> int:
    """The rows of a row pass's tile: ``full``, or a half or a quarter of
    it when ``smem_of(rows)`` bytes of shared memory would not fit a block
    (the kernels are built for these three heights).  The quarter when
    none fits, so that ``_check_smem`` names the widths."""
    for tm in (full, full // 2):
        if smem_of(tm) <= SMEM_LIMIT:
            return tm
    return full // 4


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


def _trunk_tiles(H: int, SC: int, F: int, elem: int, tm: int) -> int:
    # two activation buffers, the sin and cos blocks and the x block
    ld, ldk = ld_of(H, SC), kp_of(F) + PAD
    return (2 * tm * ld + 2 * tm * ldk + tm * (KX + PAD)) * elem


def trunk_fwd_smem(H: int, SC: int, F: int, elem: int, tm: int) -> int:
    # + pts [TM, 3], sigma [TM] and the ray of each row [TM]
    return _trunk_tiles(H, SC, F, elem, tm) + tm * 3 * 4 + tm * 4 + tm * 4


def trunk_rows_smem(H: int, SC: int, F: int, elem: int, tm: int) -> int:
    # + pts [TM, 3], g [TM, 4] and the ray of each row [TM]
    return _trunk_tiles(H, SC, F, elem, tm) + tm * 3 * 4 + tm * 4 * 4 + tm * 4


def trunk_fwd_plan(R: int, S: int, H: int, SC: int, F: int, elem: int) -> dict:
    """f32 K1 and K2's recompute chain (both elements): one block per tile
    of consecutive sample rows, a full tile or, for widths whose buffers
    it cannot hold, a half or a quarter of one (``row_tile``)."""
    if H % 32 or SC % 32:
        raise ValueError(f"the trunk kernels need hidden and code widths "
                         f"that are multiples of 32, got {H} and {SC}")
    tm = row_tile(tile_rows(elem),
                  lambda t: trunk_fwd_smem(H, SC, F, elem, t))
    smem = trunk_fwd_smem(H, SC, F, elem, tm)
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


def k1_plan(R: int, S: int, H: int, SC: int, F: int, elem: int,
            n_sm: int) -> dict:
    """K1's launch, chosen by shape before any launch: the widths padded
    to ``TRUNK_MULTIPLE`` ("h", "sc"), and the route.  bf16 at padded
    widths up to ``K1_MAX_WIDTH`` and at most ``K1_MAX_BANDS`` bands runs
    the persistent wgmma kernel ("wgmma", ``trunk_fwd_wgmma_plan``);
    everything else, f32 and the wider bf16 shapes, the row-tile forward
    of ``trunk_common.cuh`` ("rows", ``trunk_fwd_plan``), which K2's
    recompute also runs and which rounds where bf16 K1 rounds."""
    h, sc = padded(H, TRUNK_MULTIPLE), padded(SC, TRUNK_MULTIPLE)
    if (elem == 2 and max(h, sc) <= K1_MAX_WIDTH
            and 1 <= F <= K1_MAX_BANDS):
        return dict(trunk_fwd_wgmma_plan(R, S, h, sc, F, n_sm),
                    route="wgmma", h=h, sc=sc)
    return dict(trunk_fwd_plan(R, S, h, sc, F, elem), route="rows", h=h,
                sc=sc)


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


def _dw_gemm(R: int, S: int, H: int, SC: int, enc_width: int, elem: int,
             n_sm: int) -> dict:
    """The five dW products of K2 / K3 (``xtg_plan``): the encode against
    g_h1, then h1 h2 feat v1 against g_h2 g_feat g_v1 g_v2."""
    names = ("w1", "w2", "wof", "wd", "wd2")
    shapes = ((enc_width, H), (H, H), (H, SC), (SC, H), (H, H))
    gemm = xtg_plan([(R * S, kd, nd) for kd, nd in shapes], elem, n_sm)
    for name, p in zip(names, gemm["products"]):
        p["name"] = name
    return gemm


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
    tm = row_tile(tile_rows(elem),
                  lambda t: trunk_rows_smem(H, SC, F, elem, t))
    smem = trunk_rows_smem(H, SC, F, elem, tm)
    _check_smem(f"the trunk backward at h={H}, s={SC}, F={F}", smem)
    grid = min(R, n_sm * blocks_per_sm(smem, 2))
    kp = kp_of(F)
    enc_width = 2 * kp + KX     # sin | cos | x (3) and a column of ones
    return {"recompute": not stored,
            "rows": {"tile_rows": tm, "smem": smem, "grid": grid,
                     "ray_ranges": even_ranges(R, grid)},
            "enc_width": enc_width, "kp": kp, "small_width": 5 * H,
            "small_rows": grid,
            "gemm": _dw_gemm(R, S, H, SC, enc_width, elem, n_sm)}


def k2_chunks(H: int, SC: int, recompute: bool) -> list:
    """The weight chunks the bf16 wgmma row pass streams for every tile, in
    the order its chain reads them: (layer, byte offset in the packed
    image, bytes).  K2 first streams K1's (``k1_chunks``, its forward
    again); then K2 and K3 stream the cotangent products g @ w^T, each
    with B = w as stored [N, K] (N the product's output width), padded to
    the wgmma widths and cut into chunks of 64 reduction columns, N rows of
    128 bytes: wd2 (g_v1), wd (g_feat), wof (g_h2), w2 (g_h1) and the
    stacked [w1s; w1c; w1x] (g_sn, g_cs, g_x at rows 0, 32 and 64 of
    ``K2_ENC``)."""
    nh, ns = k1_wgmma_width(H), k1_wgmma_width(SC)
    out = k1_chunks(H, SC) if recompute else []
    off = out[-1][1] + out[-1][2] if out else 0
    layers = (("d_wd2", nh, nh), ("d_wd", ns, nh), ("d_wof", nh, ns),
              ("d_w2", nh, nh), ("d_w1", K2_ENC, nh))
    for name, n, k in layers:
        for _ in range(k // K1_CHUNK_K):
            out.append((name, off, n * 128))
            off += n * 128
    return out


def k2_smem(H: int, SC: int, recompute: bool) -> int:
    """The bf16 wgmma row pass's shared memory, in the kernel's order: the
    weight ring (``K2_STAGES`` of K1's stages), one activation buffer per
    warpgroup (every
    operand of the chain in turn, the encode, the cotangents and the
    encode product's [g_sn | g_cs | g_x]), each warpgroup's 64 points
    (f32) and 64 rows of g (f32 [64, 4]), wr's three columns and wos (f32
    [4, NH]), each warpgroup's relu masks of h1, h2 and v1 (bits, NH / 64
    words a thread each; v2's stays in registers); K2 also b1 and bd2 and
    the staged per-ray rows, as K1; the ring's mbarriers and the
    1024-byte alignment slack."""
    nh, ns = k1_wgmma_width(H), k1_wgmma_width(SC)
    nm = max(nh, ns)
    fwd = 2 * nh * 2 + 2 * K1_RAYS * (2 * nh + ns) * 2 if recompute else 0
    masks = 2 * 3 * (nh // 64) * 128 * 4
    return (K2_STAGES * nm * 128 + 2 * 64 * nm * 2 + 2 * 64 * 3 * 4
            + 2 * 64 * 16 + 4 * nh * 4 + masks + fwd + 2 * K2_STAGES * 8
            + 1024)


def trunk_bwd_wgmma_plan(R: int, S: int, H: int, SC: int, F: int,
                         n_sm: int, stored: bool) -> dict:
    """bf16 K2 (``stored`` False) or K3 at padded widths up to
    ``K1_MAX_WIDTH`` and at most ``K1_MAX_BANDS`` bands: the wgmma row pass
    (a persistent grid of at most one block per SM; the block's two
    consumer warpgroups each own whole rays, ``even_ranges(R, 2 grid)``
    [2 b + w], walked in 64-row tiles, ``lane_tiles`` of them, the block's
    ``tiles`` the larger count of its two), then the dW products of
    ``xtg_plan`` (with ``need_dw``).  The dW encode is K1's: ``K2_ENC``
    columns, sin at 0, cos at ``kp`` = 32, x at 64 and the ones at 67."""
    for name, n in (("hidden", H), ("code", SC)):
        if n % 32 or not 32 <= n <= K1_MAX_WIDTH:
            raise ValueError(
                f"the wgmma row pass needs a {name} width that is a multiple "
                f"of 32 and at most {K1_MAX_WIDTH} (K1_MAX_WIDTH), got {n}")
    if not 1 <= F <= K1_MAX_BANDS:
        raise ValueError(f"the wgmma row pass encodes at most {K1_MAX_BANDS} "
                         f"bands (K1_MAX_BANDS), got {F}")
    if R < 1 or S < 1:
        raise ValueError(f"the trunk backward needs at least one sample, got "
                         f"R={R}, S={S}")
    recompute = not stored
    smem = k2_smem(H, SC, recompute)
    _check_smem(f"the wgmma row pass at h={H}, s={SC}", smem)
    grid = min(n_sm, R)
    lanes = even_ranges(R, 2 * grid)
    rows = K1_TILE // 2         # a warpgroup's tile
    lane_tiles = [-(-(r1 - r0) * S // rows) for r0, r1 in lanes]
    chunks = k2_chunks(H, SC, recompute)
    kp = 32                     # the encode's sin block (K1's)
    return {"recompute": recompute, "route": "wgmma",
            "rows": {"tile_rows": rows, "smem": smem, "grid": grid,
                     "ray_ranges": lanes, "lane_tiles": lane_tiles,
                     "tiles": [max(lane_tiles[2 * b], lane_tiles[2 * b + 1])
                               for b in range(grid)],
                     "nh": k1_wgmma_width(H), "ns": k1_wgmma_width(SC),
                     "chunks": chunks,
                     "image_bytes": chunks[-1][1] + chunks[-1][2]},
            "enc_width": K2_ENC, "kp": kp, "small_width": 5 * H,
            "small_rows": 2 * grid,
            "gemm": _dw_gemm(R, S, H, SC, K2_ENC, 2, n_sm)}


def k2_plan(R: int, S: int, H: int, SC: int, F: int, has_x: bool, elem: int,
            n_sm: int, stored: bool) -> dict:
    """K2's (K3's with ``stored``) launch, chosen by shape before any
    launch, as ``k1_plan`` chooses K1's: the widths padded to
    ``TRUNK_MULTIPLE`` ("h", "sc"), and the route.  bf16 at padded widths
    up to ``K1_MAX_WIDTH`` with at most ``K1_MAX_BANDS`` bands runs the
    wgmma row pass ("wgmma", ``trunk_bwd_wgmma_plan``); f32 and the wider
    bf16 shapes the row-tile pass of ``trunk_bwd_rows_kernel`` ("rows",
    ``trunk_bwd_plan``)."""
    h, sc = padded(H, TRUNK_MULTIPLE), padded(SC, TRUNK_MULTIPLE)
    if (elem == 2 and max(h, sc) <= K1_MAX_WIDTH
            and 1 <= F <= K1_MAX_BANDS):
        return dict(trunk_bwd_wgmma_plan(R, S, h, sc, F, n_sm, stored),
                    h=h, sc=sc)
    return dict(trunk_bwd_plan(R, S, h, sc, F, has_x, elem, n_sm, stored),
                route="rows", h=h, sc=sc)


def layer_bwd_smem(K: int, N: int, elem: int, w_in_smem: bool,
                   tm: int) -> int:
    if w_in_smem:
        # w and gp in 64-column blocks, the dx tile, db, alignment slack
        ncb = -(-N // 64)
        return (ncb * (K4_MAX_WIDTH * 128 + 64 * 128) + 64 * (K + 8) * 2
                + N * 4 + 1024)
    # the f32 gp tile of tm rows (row stride N + 4) and db, in either
    # element type
    return tm * (N + 4) * 4 + N * 4


def k4_global_rows(N: int) -> int:
    """Rows per tile of K4's global-memory-w layout: 32, or 16 or 8 for
    an N whose 32-row gp tile shared memory cannot hold."""
    return row_tile(K4_GLOBAL_ROWS,
                    lambda t: layer_bwd_smem(0, N, 4, False, t))


def layer_bwd_plan(M: int, S: int, K: int, N: int, per_ray: bool, elem: int,
                   n_sm: int, w_in_smem: bool | None = None) -> dict:
    """K4: the row pass (mask, dx, db) as a persistent grid whose blocks
    own whole rays (whole tiles for a bias), then dw = x^T gp.  The row
    pass keeps w in shared memory for ``wgmma`` (``w_in_smem``, bf16 only,
    K and N at most ``K4_MAX_WIDTH``; the default in bf16) or reads it
    from global memory on the CUDA cores (f32, and the default there)."""
    if w_in_smem is None:
        w_in_smem = elem == 2
    if K % K4_MULTIPLE or N % K4_MULTIPLE:
        raise ValueError(f"K4 needs K and N that are multiples of 16, got "
                         f"w ({K}, {N})")
    if w_in_smem and (elem != 2 or K > K4_MAX_WIDTH or N > K4_MAX_WIDTH):
        raise ValueError(f"K4 in bfloat16 keeps w in shared memory: K and N "
                         f"at most {K4_MAX_WIDTH}, got w ({K}, {N})")
    if M < 1 or (per_ray and M % S):
        raise ValueError(f"K4 needs whole rays, got M={M}, S={S}")
    tm = tile_rows(2) if w_in_smem else k4_global_rows(N)
    smem = layer_bwd_smem(K, N, elem, w_in_smem, tm)
    _check_smem(f"K4 at w ({K}, {N})", smem)
    units = M // S if per_ray else -(-M // tm)
    grid = min(units, n_sm * blocks_per_sm(smem, 1 if w_in_smem else 2))
    unit = S if per_ray else tm
    rows = [(u0 * unit, min(u1 * unit, M))
            for u0, u1 in even_ranges(units, grid)]
    return {"rows": {"tile_rows": tm, "smem": smem, "grid": grid,
                     "row_ranges": rows, "w_in_smem": w_in_smem},
            "gemm": xtg_plan([(M, K, N)], elem, n_sm)}


def k4_layout(K: int, N: int, elem: int) -> tuple:
    """(k, n, w_in_smem): K4's widths padded to ``K4_MULTIPLE`` and its
    row-pass layout, chosen by shape: w in shared memory in bf16 up to
    ``K4_MAX_WIDTH``, else read from global memory.  Raises
    ``ValueError`` naming the widths when shared memory cannot hold the
    row pass's tile even then."""
    k, n = padded(K, K4_MULTIPLE), padded(N, K4_MULTIPLE)
    w_in_smem = elem == 2 and max(k, n) <= K4_MAX_WIDTH
    _check_smem(f"K4 at w ({K}, {N})",
                layer_bwd_smem(k, n, elem, w_in_smem,
                               K4_GLOBAL_ROWS if w_in_smem
                               else k4_global_rows(n)))
    return k, n, w_in_smem


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


def layer_fwd_fits(x_shape: tuple, w_shape: tuple, b_shape: tuple) -> bool:
    """Whether the fused linear + relu forward (``csrc/layer_fwd.cu``)
    takes x [..., K] @ w [K, N] plus b, from the shapes alone: K at most
    ``LAYER_FWD_MAX_K``, N in ``LAYER_FWD_N``, 1 to 2^31 - 1 rows, and b a
    bias [N] or per-ray rows [R, 1, N] with x [R, S, K]."""
    if len(w_shape) != 2 or not x_shape:
        return False
    K, N = w_shape
    rows = 1
    for n in x_shape[:-1]:
        rows *= n
    if not (1 <= K <= LAYER_FWD_MAX_K and N in LAYER_FWD_N
            and x_shape[-1] == K and 0 < rows < 2 ** 31):
        return False
    return b_shape == (N,) or (len(x_shape) == 3
                               and b_shape == (x_shape[0], 1, N))


def layer_fwd_tile_rows(N: int) -> int:
    """Rows of the fused forward's tile: 64 at N = 256, 128 at N = 128."""
    return 64 * 256 // N


def layer_fwd_smem(K: int, N: int, stages: int) -> int:
    """w^T and ``stages`` x tiles in 64-column blocks, the output tile, the
    stages' barriers, alignment slack."""
    ncb = -(-padded(K, LAYER_FWD_MULTIPLE) // 64)
    tm = layer_fwd_tile_rows(N)
    return (ncb * N * 128 + stages * ncb * tm * 128 + tm * N * 2
            + 8 * LAYER_FWD_STAGES + 1024)


def layer_fwd_plan(M: int, K: int, N: int, n_sm: int) -> dict:
    """The fused forward over M rows: a persistent grid of one block per
    SM (at most one per tile), block b owning tiles [b T / G, (b + 1) T /
    G) of T; x's tiles by TMA in as many stages as shared memory
    holds, up to ``LAYER_FWD_STAGES``, or, for a K that is not a multiple
    of 8 (rows TMA cannot address), one tile at a time through registers;
    w^T's K padded to ``LAYER_FWD_MULTIPLE``."""
    if not layer_fwd_fits((M, K), (K, N), (N,)):
        raise ValueError(f"the fused linear + relu forward takes K <= "
                         f"{LAYER_FWD_MAX_K}, N in {LAYER_FWD_N} and 1 to "
                         f"2^31 - 1 rows, got M={M}, w ({K}, {N})")
    stages = 1
    if K % 8 == 0:
        stages = max(s for s in range(1, LAYER_FWD_STAGES + 1)
                     if s == 1 or layer_fwd_smem(K, N, s) <= SMEM_LIMIT)
    smem = layer_fwd_smem(K, N, stages)
    _check_smem(f"the fused forward at w ({K}, {N})", smem)
    tm = layer_fwd_tile_rows(N)
    tiles = -(-M // tm)
    grid = min(tiles, n_sm)
    return {"tile_rows": tm, "smem": smem, "grid": grid, "stages": stages,
            "k_pad": padded(K, LAYER_FWD_MULTIPLE)}
