"""The ray-structured trunk's products (``models/ray_structured.py::_dot``).

On the CPU every site that multiplies ``cd`` operands returns bit for bit
what the f32 product of upcast operands returned before, at lego's widths;
on the card (tests marked ``card``) the tensor-core route agrees with that
upcast form to summation order.  No JAX here: the card's machine has
none.  On the card: ``python -m pytest --noconftest -m card
tests/test_torch_products.py`` (``tests/conftest.py`` imports JAX).
"""

from __future__ import annotations

import pytest
import torch

from codenerf_tpu_torch.models import ray_structured as rs
from codenerf_tpu_torch.ops import layer_bwd

BF = torch.bfloat16
# lego's widths: K of layer1 / the trunk / the view-direction layer, N of
# fc_alpha / fc_rgb / layer_dir1 / the trunk
WIDTHS = [(k, n) for k in (63, 256, 283) for n in (1, 3, 128, 256)]
CDS = [BF, None]


# ---- the upcast forms every site had before the tensor-core route ----

def old_mmc(x, w, cd):
    if cd is None:
        return x @ w
    return (x.to(cd).float() @ w.to(cd).float()).to(cd)


def old_dw(x, g):
    return (x.float().reshape(-1, x.shape[-1]).t()
            @ g.float().reshape(-1, g.shape[-1]))


def old_dotlp_bwd(x, w, g, cd):
    gc = g.to(cd).float()
    dx = (gc @ w.to(cd).float().t()).to(x.dtype)
    return dx, old_dw(x.to(cd), gc).to(w.dtype)


def old_fc_out_tail_bwd(x, w, b_rows, g, cd):
    ct = cd or torch.float32
    gc = g.to(ct)
    gf, gs = gc[..., :-1], gc[..., -1:]
    wc = w.to(ct)
    dx = (gf.float() @ wc[:, :-1].float().t()
          + gs.float() * wc[:, -1].float()).to(x.dtype)
    xc = x.to(ct)
    dw = torch.cat([old_dw(xc, gf), old_dw(xc, gs)], dim=1).to(w.dtype)
    db = torch.cat([gf.float().sum(dim=1), gs.float().sum(dim=1)],
                   dim=-1).to(b_rows.dtype)
    return dx, dw, db


def old_linear_relu_bwd_plain(x, w, b, y, g, cd=None):
    ct = cd or y.dtype
    gp = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device)).to(ct)
    gpf = gp.float()
    dx = (gpf @ w.to(ct).float().t()).to(x.dtype)
    dw = (x.to(ct).float().reshape(-1, x.shape[-1]).t()
          @ gpf.reshape(-1, gp.shape[-1]))
    return dx, dw, layer_bwd._unbroadcast(gpf, b.shape)


# ---- inputs ----

def _inputs(k, n, cd, device="cpu", rays=16, samples=8, seed=0):
    """x [R, S, K] in ``cd`` (f32 without one), w [K, N] as a Linear's
    transposed f32 weight (``_w``'s view), a bias, per-ray rows, the
    relu output y and a cotangent g, seeded."""
    gen = torch.Generator().manual_seed(seed * 1000 + k * 7 + n)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    x = rnd(rays, samples, k).to(cd or torch.float32)
    lin_w = rnd(n, k, scale=k ** -0.5)
    w = lin_w.t()
    b = rnd(n, scale=0.1)
    b_rows = rnd(rays, n, scale=0.1)
    y = torch.relu(old_mmc(x, w, cd) + b.to(cd or torch.float32))
    g = rnd(rays, samples, n).to(cd or torch.float32)
    return x, w, b, b_rows, y, g


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# ---- CPU: bit for bit against the upcast forms ----

@pytest.mark.parametrize("cd", CDS, ids=["bf16", "f32"])
@pytest.mark.parametrize("k,n", WIDTHS)
def test_mmc_bit_equal(k, n, cd):
    x, w, *_ = _inputs(k, n, cd)
    _bits(rs._mmc(x, w, cd), old_mmc(x, w, cd))
    # a block of rows of the transposed weight, as the per-ray halves take
    _bits(rs._mmc(x[..., :k // 2 + 1], w[:k // 2 + 1], cd),
          old_mmc(x[..., :k // 2 + 1], w[:k // 2 + 1], cd))


@pytest.mark.parametrize("cd", CDS, ids=["bf16", "f32"])
@pytest.mark.parametrize("k,n", WIDTHS)
def test_dw_bit_equal(k, n, cd):
    x, _, _, _, _, g = _inputs(k, n, cd)
    _bits(rs._dw(x, g, cd), old_dw(x, g))


@pytest.mark.parametrize("x_dtype", [BF, torch.float32], ids=["x_bf16",
                                                             "x_f32"])
@pytest.mark.parametrize("k,n", WIDTHS)
def test_dotlp_bit_equal(k, n, x_dtype):
    x, w, _, _, _, g = _inputs(k, n, BF)
    x = x.to(x_dtype)
    xl, wl = _leaf(x), _leaf(w)
    out = rs._DotLP.apply(xl, wl, BF)
    _bits(out, old_mmc(x, w, BF))
    out.backward(g)
    dx, dw = old_dotlp_bwd(x, w, g, BF)
    _bits(xl.grad, dx)
    _bits(wl.grad, dw)


@pytest.mark.parametrize("cd", CDS, ids=["bf16", "f32"])
@pytest.mark.parametrize("k,n", [(k, n) for k, n in WIDTHS if n > 1])
def test_fc_out_tail_bit_equal(k, n, cd):
    x, w, _, b_rows, _, g = _inputs(k, n, cd)
    xl, wl, bl = _leaf(x), _leaf(w), _leaf(b_rows)
    out = rs._FcOutTail.apply(xl, wl, bl, cd)
    y = old_mmc(x, w, cd)
    _bits(out, y + b_rows[:, None, :].to(y.dtype))
    out.backward(g)
    dx, dw, db = old_fc_out_tail_bwd(x, w, b_rows, g, cd)
    _bits(xl.grad, dx)
    _bits(wl.grad, dw)
    _bits(bl.grad, db)


@pytest.mark.parametrize("per_ray", [False, True], ids=["bias", "per_ray"])
@pytest.mark.parametrize("cd", CDS, ids=["bf16", "f32"])
@pytest.mark.parametrize("k,n", WIDTHS)
def test_linear_relu_bwd_plain_bit_equal(k, n, cd, per_ray):
    x, w, b, b_rows, y, g = _inputs(k, n, cd)
    bb = b_rows[:, None, :] if per_ray else b
    got = layer_bwd.linear_relu_bwd_plain(x, w, bb, y, g, cd)
    want = old_linear_relu_bwd_plain(x, w, bb, y, g, cd)
    for a, b_ in zip(got, want):
        _bits(a, b_)


def test_counter_counts_upcast_on_cpu():
    x, w, _, _, _, g = _inputs(256, 256, BF)
    before = dict(rs._dot.routes)
    rs._mmc(x, w, BF)
    rs._dw(x, g, BF)
    rs._mmc(x.float(), w, None)          # f32 configurations: no _dot
    assert rs._dot.routes["upcast"] == before["upcast"] + 2
    assert rs._dot.routes["tensor_core"] == before["tensor_core"]


# ---- the card: the tensor-core route against the upcast form ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tensor-core route runs only "
                    "on CUDA tensors")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _f32_close(got, want):
    assert got.dtype == torch.float32 == want.dtype
    err = ((got - want).norm() / want.norm()).item()
    assert err <= 1e-5, err


def _ulps(a, b):
    """Distance in units in the last place of two bf16 tensors."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def _sum_bound(a, b):
    """Elementwise bound on how far two f32 sums of a @ b's exact
    products, taken in any two orders, can lie apart: 2 K u (|a| @ |b|)
    with u = 2^-24."""
    k = a.shape[-1]
    return 2 * k * 2.0 ** -24 * (a.double().abs() @ b.double().abs())


def _bf16_close(got, want, bound):
    """``got`` and ``want`` are f32 sums of the same exact products, each
    rounded once to bf16: at most 0.1% of elements differ, and each
    differs by at most one bf16 ulp, or by no more than the sums'
    ``bound`` where the sum cancels (there a bf16 ulp of the result is
    finer than the f32 sums' rounding)."""
    assert got.dtype == BF == want.dtype
    d = _ulps(got, want)
    off = (d > 1) & ((got.double() - want.double()).abs() > bound)
    share = (d > 0).float().mean().item()
    assert not off.any() and share <= 1e-3, (d.max().item(), share,
                                             off.sum().item())


@pytest.mark.card
@pytest.mark.parametrize("k,n", WIDTHS)
def test_tensor_core_route_on_card(card, k, n):
    x, w, b, b_rows, y, g = _inputs(k, n, BF, card, rays=64, samples=64)
    before = dict(rs._dot.routes)
    _bf16_close(rs._mmc(x, w, BF), old_mmc(x, w, BF),
                _sum_bound(x, w.to(BF)))
    _f32_close(rs._dw(x, g, BF), old_dw(x, g))
    assert rs._dot.routes["tensor_core"] == before["tensor_core"] + 2
    assert rs._dot.routes["upcast"] == before["upcast"]

    xl, wl = _leaf(x), _leaf(w)
    rs._DotLP.apply(xl, wl, BF).backward(g)
    dx, dw = old_dotlp_bwd(x, w, g, BF)
    wt = w.to(BF).t()
    _bf16_close(xl.grad, dx, _sum_bound(g, wt))
    _f32_close(wl.grad, dw)

    for bb in (b, b_rows[:, None, :]):
        got = layer_bwd.linear_relu_bwd_plain(x, w, bb, y, g, BF)
        want = old_linear_relu_bwd_plain(x, w, bb, y, g, BF)
        gp = torch.where(y > 0, g, torch.zeros_like(g))
        _bf16_close(got[0], want[0], _sum_bound(gp, wt))
        _f32_close(got[1], want[1])
        _bits(got[2], want[2])

    if n > 1:
        xl, wl, bl = _leaf(x), _leaf(w), _leaf(b_rows)
        rs._FcOutTail.apply(xl, wl, bl, BF).backward(g)
        dx, dw, db = old_fc_out_tail_bwd(x, w, b_rows, g, BF)
        _bf16_close(xl.grad, dx, _sum_bound(g[..., :-1], wt[:-1]))
        _f32_close(wl.grad, dw)
        _bits(bl.grad, db)


@pytest.mark.card
@pytest.mark.parametrize("k,n", WIDTHS)
def test_cd_result_is_f32_result_rounded_once(card, k, n):
    """A ``cd`` result straight from cuBLAS, with its reduced-precision
    reduction off, is the f32-result route rounded once."""
    x, w, *_ = _inputs(k, n, BF, card, rays=64, samples=64)
    a, b = x.reshape(-1, k), w.to(BF)
    _bits(rs._f32_reduction_mm(a, b),
          torch.mm(a, b, out_dtype=torch.float32).to(BF))
