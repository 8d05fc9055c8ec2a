"""The fused linear + relu forward (``ops/layer_fwd.py``,
``csrc/layer_fwd.cu``) and the route ``_DotAddRelu`` takes to it.

On the CPU: the route check from shapes alone (a CUDA tensor is stood in
for by its shape and device), the ``routes`` counter, the forward against
JAX ``_dot_add_relu`` bit for bit, the kernel's zero padding of K, its
plan, and its kernel names against the benchmark's kernel labels.  Inputs
for the bit-for-bit checks lie on a grid whose products and f32 sums are
exact, so every summation order gives the same sums: they hold the cast
points (the product rounded to bf16, the bias added in bf16, the relu), not
the order of the sums.

On the card (tests marked ``card``; ``python -m pytest --noconftest -m card
tests/test_torch_dar_fused.py``, as ``tests/conftest.py`` imports JAX,
which the card's machine lacks): the kernel against the eager product,
bias add and relu at lego's shapes.  JAX is imported only inside the CPU
test that needs it.
"""

from __future__ import annotations

import re
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import costs
from codenerf_tpu_torch.models import ray_structured as rs
from codenerf_tpu_torch.ops import _build, layer_fwd, plan
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

BF = torch.bfloat16
# lego's relu layers: layer1, the trunk and fc_feat, layer_dir1
LEGO = [(63, 256), (256, 256), (256, 128)]
FORMS = ["bias", "per_ray"]


def _like(shape, device="cuda"):
    """A stand-in for a tensor: its shape and device are all the route
    check reads."""
    return types.SimpleNamespace(shape=torch.Size(shape),
                                 device=torch.device(device))


def _shapes(k, n, form, rays=16, samples=8):
    b = (n,) if form == "bias" else (rays, 1, n)
    return (rays, samples, k), (k, n), b


def _grid_inputs(k, n, form, rays=16, samples=8, seed=0):
    """x in bf16 on a grid of eighths in [-1, 1], w [K, N] f32 on a grid of
    64ths in [-1, 1] (exact in bf16): every product is a multiple of 2^-9
    and every sum of K <= 256 of them stays under 2^8, so f32 holds every
    partial sum exactly.  b f32, a bias or per-ray rows."""
    gen = torch.Generator().manual_seed(seed * 1000 + k * 7 + n)
    x = (torch.randint(-8, 9, (rays, samples, k), generator=gen) / 8).to(BF)
    w = torch.randint(-64, 65, (k, n), generator=gen) / 64
    b = torch.randn((n,) if form == "bias" else (rays, 1, n),
                    generator=gen)
    return x, w, b


# ---- the route, from shapes alone ----

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k,n", LEGO)
def test_route_takes_lego_widths(k, n, form):
    xs, ws, bs = _shapes(k, n, form)
    assert plan.layer_fwd_fits(xs, ws, bs)
    assert layer_fwd.fused_route(_like(xs), _like(ws), _like(bs), BF)


REFUSED = {
    # case: (device, cd, x shape, w shape, b shape)
    "cpu": ("cpu", BF, (16, 8, 256), (256, 256), (256,)),
    "cd_none": ("cuda", None, (16, 8, 256), (256, 256), (256,)),
    "cd_f32": ("cuda", torch.float32, (16, 8, 256), (256, 256), (256,)),
    "cd_f16": ("cuda", torch.float16, (16, 8, 256), (256, 256), (256,)),
    "n64": ("cuda", BF, (16, 8, 256), (256, 64), (64,)),
    "n3": ("cuda", BF, (16, 8, 256), (256, 3), (3,)),
    "k283": ("cuda", BF, (16, 8, 283), (283, 128), (128,)),
    "k_mismatch": ("cuda", BF, (16, 8, 128), (256, 256), (256,)),
    "rows_2d_bias": ("cuda", BF, (16, 8, 256), (256, 256), (16, 256)),
    "per_ray_wrong_rays": ("cuda", BF, (16, 8, 256), (256, 256),
                           (8, 1, 256)),
    "no_rows": ("cuda", BF, (0, 8, 256), (256, 256), (256,)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_route_refuses(case):
    dev, cd, xs, ws, bs = REFUSED[case]
    assert not layer_fwd.fused_route(_like(xs, dev), _like(ws, dev),
                                     _like(bs, dev), cd)


def test_routes_count_eager_on_cpu():
    x, w, b = _grid_inputs(256, 256, "bias")
    before = dict(rs._DotAddRelu.routes)
    launches = layer_fwd.linear_relu_fwd.launches
    rs._DotAddRelu.apply(x, w, b, BF)
    rs._DotAddReluPL.apply(x, w, b, BF)
    rs._DotAddRelu.apply(x.float(), w, b, None)
    assert rs._DotAddRelu.routes == {"fused": before["fused"],
                                     "eager": before["eager"] + 3}
    assert layer_fwd.linear_relu_fwd.launches == launches


# ---- the forward on the CPU ----

@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k,n", LEGO)
def test_cpu_forward_bit_equal_to_jax(k, n, form):
    import jax.numpy as jnp

    from codenerf_tpu.models import ray_structured as jrs

    x, w, b = _grid_inputs(k, n, form)
    got = rs._DotAddRelu.apply(x, w, b, BF)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want = jrs._dot_add_relu(xj, jnp.asarray(w.numpy()),
                             jnp.asarray(b.numpy()), jnp.bfloat16)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the wrapper's CPU route is the same function
    assert torch.equal(layer_fwd.linear_relu_fwd(x, w, b, BF), got)


@pytest.mark.parametrize("form", FORMS)
def test_zero_padding_k_is_exact(form):
    """lego's first layer, K = 63: the kernel reads w^T padded with zero
    columns to the plan's K (64) and x's tile zero past K; the padded
    product gives the same bits."""
    x, w, b = _grid_inputs(63, 256, form)
    k_pad = plan.layer_fwd_plan(x.numel() // 63, 63, 256, 132)["k_pad"]
    assert k_pad == 64
    wt = layer_fwd.padded_wt(w, BF, k_pad)
    assert wt.shape == (256, 64) and wt.dtype == BF and wt.is_contiguous()
    assert not wt[:, 63:].any()
    padded = layer_fwd.linear_relu_fwd_plain(F.pad(x, (0, k_pad - 63)),
                                             wt.t(), b, BF)
    assert torch.equal(padded, layer_fwd.linear_relu_fwd_plain(x, w, b, BF))


@pytest.mark.parametrize("rows", [1, 63, 16384 * 64, 16384 * 192])
@pytest.mark.parametrize("k,n", LEGO)
def test_plan(k, n, rows):
    """One block per SM at most, and no more blocks than tiles; x by TMA
    in as many stages as fit when K's rows are 16-byte multiples, else
    one; shared memory under the limit."""
    pl = plan.layer_fwd_plan(rows, k, n, 132)
    tm = pl["tile_rows"]
    assert tm * n == 64 * 256
    assert pl["grid"] == min(132, -(-rows // tm))
    assert pl["smem"] == plan.layer_fwd_smem(k, n, pl["stages"])
    assert pl["smem"] <= plan.SMEM_LIMIT
    if k % 8:
        assert pl["stages"] == 1
    else:
        assert pl["stages"] == 2 and plan.layer_fwd_smem(
            k, n, 3) > plan.SMEM_LIMIT


def test_plan_refuses_widths_outside():
    for k, n in ((257, 256), (256, 64), (0, 256)):
        with pytest.raises(ValueError):
            plan.layer_fwd_plan(64, k, n, 132)


def test_kernel_names_outside_benchmark_labels():
    """The benchmark's kernel metrics match device kernels by name
    substring (``benchmark/costs.py::KERNELS``); a name of this kernel that
    held one would be counted as K1, K2 or K4."""
    source = (_build.CSRC / "layer_fwd.cu").read_text()
    names = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        source)
    assert names == ["layer_fwd_wgmma"]
    labels = {s for subs in costs.KERNELS.values() for s in subs}
    assert labels >= {"trunk_fwd_kernel", "layer_bwd_rows",
                      "xtg_wgmma_kernel"}
    assert not [(nm, s) for nm in names for s in labels if s in nm]


# ---- the card: the kernel against the eager product, bias add and relu ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused forward is a CUDA "
                    "kernel with no CPU version")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _card_inputs(k, n, form, samples, rays=16384, seed=0):
    """x [R, S, K] bf16 from a normal draw, w [K, N] as a Linear's
    transposed f32 weight (``_w``'s view), b a bias or per-ray rows in
    bf16, as the pipeline hands them over."""
    gen = torch.Generator(device="cuda").manual_seed(seed * 1000 + k + n)
    x = torch.randn(rays, samples, k, device="cuda", generator=gen).to(BF)
    lin_w = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
    shape = (n,) if form == "bias" else (rays, 1, n)
    b = (torch.randn(shape, device="cuda", generator=gen) * 0.5).to(BF)
    return x, lin_w.t(), b


def _ordered(t):
    """bf16 bit patterns as integers in the order of their values (-0 and
    +0 both 0)."""
    i = t.view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _neighbour(t, step):
    """The bf16 value ``step`` ulps from each element of ``t``."""
    o = _ordered(t) + step
    bits = torch.where(o < 0, (-o) | 0x8000, o)
    return bits.to(torch.int16).view(BF)


def _round_bias_relu(y, b):
    return torch.relu(y + b)


def _check_against_eager(x, w, b, got):
    """``got`` is the eager layer with its product's f32 sums in another
    order: every element is relu(bf16(y' + b)) for a y' within one bf16 ulp
    of the eager product y, or, where y's f32 sum cancels so far that its
    rounding error passes half an ulp of y, within the sums' bound; at most
    0.1% of elements differ from the eager output, and the relu masks agree
    wherever the outputs do."""
    y = rs._mmc(x, w, BF)
    want = _round_bias_relu(y, b)
    near = got == want
    for step in (-1, 1):
        near |= got == _round_bias_relu(_neighbour(y, step), b)
    if not bool(near.all()):
        # 2 K u (|x| @ |w|): how far two f32 sums of the same products
        # can lie apart
        k = x.shape[-1]
        bound = (2 * k * 2.0 ** -24 * (x.float().abs().reshape(-1, k)
                                       @ w.to(BF).float().abs())
                 ).reshape(y.shape)
        far = ~near
        cancels = bound > y.float().abs() * 2.0 ** -9
        gap = (got.float() - want.float()).abs()
        slack = 2 * bound + 2.0 ** -7 * (y.float().abs() + want.float().abs())
        assert bool((cancels & (gap <= slack))[far].all()), (
            int(far.sum()), float(gap[far].max()))
    differ = got != want
    assert differ.float().mean().item() <= 1e-3, differ.float().mean().item()
    assert torch.equal((got > 0) & ~differ, (want > 0) & ~differ)


@pytest.mark.card
@pytest.mark.parametrize("samples", [64, 192])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k,n", LEGO)
def test_kernel_against_eager_on_card(card, k, n, form, samples):
    x, w, b = _card_inputs(k, n, form, samples)
    before = dict(rs._DotAddRelu.routes)
    launches = layer_fwd.linear_relu_fwd.launches
    got = rs._DotAddRelu.apply(x, w, b, BF)
    assert rs._DotAddRelu.routes["fused"] == before["fused"] + 1
    assert layer_fwd.linear_relu_fwd.launches == launches + 1
    assert got.shape == (*x.shape[:-1], n) and got.dtype == BF
    assert torch.equal(got, layer_fwd.linear_relu_fwd(x, w, b, BF))
    _check_against_eager(x, w, b, got)


@pytest.mark.card
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k,n", LEGO)
def test_kernel_bit_equal_on_grid_inputs(card, k, n, form):
    """With every f32 sum exact, the kernel and the eager layer agree bit
    for bit, the tail tile (rows not a multiple of the tile) included."""
    x, w, b = (t.cuda() for t in _grid_inputs(k, n, form, rays=37,
                                              samples=45))
    got = layer_fwd.linear_relu_fwd(x, w, b, BF)
    assert torch.equal(got, layer_fwd.linear_relu_fwd_plain(x, w, b, BF))


@pytest.mark.card
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k,n", LEGO)
def test_kernel_propagates_nan(card, k, n, form):
    x, w, b = _card_inputs(k, n, form, samples=64, rays=256)
    x[3, 5, k // 2] = float("nan")
    x[200, 0, 0] = float("nan")
    if form == "per_ray":
        b[7, 0, n - 1] = float("nan")
    else:
        b[n // 3] = float("nan")
    got = layer_fwd.linear_relu_fwd(x, w, b, BF)
    want = layer_fwd.linear_relu_fwd_plain(x, w, b, BF)
    assert bool(want.isnan().any())
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(got[3, 5].isnan().all()) and bool(got[200, 0].isnan().all())
    keep = ~want.isnan()
    assert (got[keep] != want[keep]).float().mean().item() <= 1e-3
