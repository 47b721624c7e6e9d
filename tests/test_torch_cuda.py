"""The CUDA kernels (the TCN block's forward and its gLN and cLN backwards,
the TCN block pair's forward and gLN backward, the DPT sublayers' forwards
and backwards) against their plain twins, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine with only torch and the
CUDA toolkit (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bars: relative L2 <= 4e-2 in bf16 and <= 2e-3 in f32 for the forward,
those of the JAX package's Pallas probe gate (``tcn_block.py``
``_numerics_tol``); twice that, 8e-2 and 4e-3, for the backward, the
JAX train gate (``tcn_block.py:1148``); 1.5x the forward's, 6e-2 and
3e-3, for the block pair's forward, the JAX pair gate
(``tcn_block_pair.py`` ``_pair_numerics_tol``). The DPT backward kernels hold
every cotangent against the exact f32 cotangents of their twins: in f32
within DPT_BWD_TOL, in bf16 within 4e-2 of the bf16 twin and no further
from exact than max(4e-2, 1.25x the bf16 twin's own distance).
"""

import os

import numpy as np
import pytest
import torch

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.conv_tasnet import PAIR_ENV, ConvTasNet
from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra
from convtasnet_tpu_torch.ops.cuda import tcn_block as port
from convtasnet_tpu_torch.ops.cuda import tcn_block_bwd as port_bwd
from convtasnet_tpu_torch.ops.cuda import tcn_block_pair as pair
from convtasnet_tpu_torch.ops.cuda import tcn_block_pair_bwd as pair_bwd

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-3, torch.bfloat16: 4e-2}
BWD_TOL = {torch.float32: 4e-3, torch.bfloat16: 8e-2}
PAIR_TOL = {k: 1.5 * v for k, v in TOL.items()}
# the DPT kernels in f32 differ from their twins only in summation order
# (<= 4e-7 at the quality default's widths); 2e-3 would let erf-GELU for
# tanh-GELU (~1e-4) through
DPT_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}
# the DPT backward kernels in f32 against the exact twin differ in summation
# order only (<= 1.5e-6 at the quality default's widths): 1e-5, under the
# JAX package's VJP gate of 1e-4
DPT_BWD_TOL = 1e-5
# B6 against its twin at its own rounding points: summation order only
# (~4.5e-5 in bf16 at the paper widths, emulated on the CPU; 3.6e-3 with
# g2 folded into W_out)
TP_ORDER_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
NAMES = ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2",
         "dg1", "db1", "dg2", "db2")
CASES = [
    (norm, causal, d)
    for norm, causal in [("gLN", False), ("gLN", True), ("cLN", False),
                         ("cLN", True), ("BN", False), ("BN", True)]
    for d in (1, 4, 128)
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _block_args(device, dtype, norm_type, m=2, k=300, b=64, h=128, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    args = (t(rng.standard_normal((m, k, b)), dtype),
            t(rng.standard_normal((b, h)) / np.sqrt(b), dtype),
            t(rng.standard_normal((3, h)), dtype),
            t(rng.standard_normal((h, b)) / np.sqrt(h), dtype),
            t(0.25), t(0.3),
            t(rng.standard_normal(h)), t(rng.standard_normal(h)),
            t(rng.standard_normal(h)), t(rng.standard_normal(h)))
    bn = None
    if norm_type == "BN":
        bn = tuple(t(np.abs(rng.standard_normal(h)) + 0.5) for _ in range(4))
    return args, bn


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _tcn_launches(before=None):
    """Launch counts of the TCN kernels B1, B2, B4, B5; with ``before``,
    the launches since."""
    now = {"b1": port.fused_tcn_block.launches,
           "b2": port_bwd.fused_tcn_block_bwd.launches,
           "b4": pair.fused_tcn_block_pair.launches,
           "b5": pair_bwd.fused_tcn_block_pair_bwd.launches}
    return now if before is None else {k: now[k] - before[k] for k in now}


class _pair_switch:
    """CONVTASNET_PAIR_FUSION set to 1 (pairs) or 0 inside the block."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import os
        self.old = os.environ.get(PAIR_ENV)
        os.environ[PAIR_ENV] = "1" if self.on else "0"

    def __exit__(self, *exc):
        import os
        if self.old is None:
            os.environ.pop(PAIR_ENV, None)
        else:
            os.environ[PAIR_ENV] = self.old


# B1's two products at the paper shape, [M*K, B] @ [B, H] and [M*K, H] @
# [H, B] (M=8, K=3199, B=256, H=512), as (rows, depth, columns)
WG_SHAPES = [(25592, 256, 512), (25592, 512, 256)]


def _wg_lib_call(name, *args):
    from convtasnet_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    assert err == 0, lib.ctn_error_string(err).decode()
    torch.cuda.synchronize()


@pytest.mark.parametrize("ta,tb", [(0, 0), (0, 1), (1, 0), (1, 1)])
@pytest.mark.parametrize("rows,depth,cols", WG_SHAPES)
def test_wgmma_core_matches_matmul(cuda, rows, depth, cols, ta, tb):
    """The Hopper product core (csrc/hopper_gemm.cuh) alone against exact
    f32 products of the same bf16 operands, each operand K-major (ta, tb
    0) or MN-major (1: read through wgmma's transpose bit): a swizzle or
    descriptor fault shows here first. Only summation order differs."""
    gen = torch.Generator(device="cuda").manual_seed(rows + depth + cols)
    a = torch.randn(rows, depth, device=cuda, generator=gen).bfloat16()
    b = torch.randn(depth, cols, device=cuda, generator=gen).bfloat16()
    a_st = a.t().contiguous() if ta else a
    b_st = b if tb else b.t().contiguous()
    c = torch.empty(rows, cols, device=cuda)
    _wg_lib_call("ctn_wg_matmul_check", a_st.data_ptr(), b_st.data_ptr(),
                 c.data_ptr(), rows, cols, depth, ta, tb)
    assert _rel_l2(c, a.float() @ b.float()) <= 1e-5


@pytest.mark.parametrize("ca,cb", [(512, 256), (256, 512)])
def test_wgmma_wgrad_core_matches_matmul(cuda, ca, cb):
    """The weight gradients' split-row product on the core, a^T @ b over
    M*K = 25592 rows in chunks of 1024 (the last one ragged), against the
    exact f32 product: dW_out = hn2^T g (ca = H) and dW_in = x^T dh_pre
    (ca = B)."""
    rows, chunk = 25592, 1024
    gen = torch.Generator(device="cuda").manual_seed(ca)
    a = torch.randn(rows, ca, device=cuda, generator=gen).bfloat16()
    b = torch.randn(rows, cb, device=cuda, generator=gen).bfloat16()
    part = torch.empty(-(-rows // chunk), ca, cb, device=cuda)
    _wg_lib_call("ctn_wg_wgrad_check", a.data_ptr(), b.data_ptr(), rows, ca,
                 cb, chunk, part.data_ptr())
    assert _rel_l2(part.sum(0), a.float().t() @ b.float()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm_type,causal,dilation", CASES)
def test_kernel_matches_twin(cuda, dtype, norm_type, causal, dilation):
    """K=300 is not a multiple of any tile; d=128 reaches past both ends."""
    args, bn = _block_args(cuda, dtype, norm_type)
    kw = dict(dilation=dilation, causal=causal, norm_type=norm_type,
              bn_stats=bn)
    before = port.fused_tcn_block.launches
    got = port.fused_tcn_block(*args, **kw)
    torch.cuda.synchronize()
    assert port.fused_tcn_block.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    want = port.fused_tcn_block_reference(*args, **kw)
    assert _rel_l2(got, want) <= TOL[dtype]


def _samples_apart(x):
    """x with sample i smoothed over 4**i frames, at scale 2**i and offset
    i / 2: each sample's norm statistics far from its neighbours' (the
    smoothing survives norm1, so the dilated conv gives y, and norm2, a
    different spread per sample), so a statistic that a kernel reads from
    another sample's slots shows."""
    out = []
    for i, xi in enumerate(x.float()):
        w = 4 ** i
        if w > 1:   # a moving average over w frames, back to unit spread
            xi = torch.nn.functional.avg_pool1d(
                xi.t()[None], w, 1, padding=w // 2,
                count_include_pad=False)[0, :, :xi.shape[0]].t()
            xi = xi / xi.std()
        out.append(xi * 2.0 ** i + 0.5 * i)
    return torch.stack(out).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
def test_kernel_matches_twin_with_samples_apart(cuda, dtype, norm_type):
    """Three samples whose statistics differ by factors of 2 and 4, each
    sample held against its twin on its own at the forward bar."""
    args, _ = _block_args(cuda, dtype, norm_type, m=3)
    args = (_samples_apart(args[0]), *args[1:])
    kw = dict(dilation=4, causal=norm_type == "cLN", norm_type=norm_type)
    got = port.fused_tcn_block(*args, **kw)
    want = port.fused_tcn_block_reference(*args, **kw)
    for i in range(3):
        assert _rel_l2(got[i], want[i]) <= TOL[dtype], i


def _b1_at_its_rounding_points(x, w_in, dw, w_out, a1, a2, g1, b1, g2, b2,
                               *, dilation, causal, norm_type="gLN"):
    """The bf16 gLN or cLN block as csrc/tcn_block_hopper.cuh rounds it: h
    = bf16(PReLU(x W_in)), norm1 from the f32 PReLU outputs inside the taps
    (out-of-range taps skipped), y = PReLU(conv) with norm2 from the f32
    values; gLN: y and W_eff = bf16(g2 W_out) rounded, the fold out =
    bf16(x + rs2 (y W_eff - mu2 g2 W_out) + b2 W_out); cLN: the normalised
    row rounded, out = bf16(x + bf16(norm2(y)) W_out), as the Pallas
    kernel's cLN path rounds it; products and sums in f64."""
    from convtasnet_tpu_torch.ops.conv import depthwise_conv1d

    f64, bf = torch.float64, torch.bfloat16
    dims = (1, 2) if norm_type == "gLN" else (2,)

    def stats(v):
        n = v[0].numel() if norm_type == "gLN" else v.shape[2]
        s1 = v.sum(dim=dims, keepdim=True)
        s2 = (v * v).sum(dim=dims, keepdim=True)
        mean = s1 / n
        return mean, torch.rsqrt((s2 / n - mean * mean).clamp_min(0) + 1e-8)

    def prelu(t, a):
        return torch.where(t >= 0, t, a.to(f64) * t)

    v = prelu(x.to(f64) @ w_in.to(f64), a1)
    h = v.float().to(bf).to(f64)
    mean1, rs1 = stats(v.float().to(f64))
    hn = h * (rs1 * g1.to(f64)) + (b1.to(f64) - mean1 * rs1 * g1.to(f64))
    y = prelu(depthwise_conv1d(hn, dw.to(f64), dilation, causal), a2)
    mean2, rs2 = stats(y.float().to(f64))
    if norm_type == "cLN":
        yn = (y - mean2) * rs2 * g2.to(f64) + b2.to(f64)
        o = yn.float().to(bf).to(f64) @ w_out.to(f64)
        return (x.to(f64) + o).to(bf)
    w_eff = (w_out.to(f64) * g2.to(f64)[:, None]).float().to(bf).to(f64)
    o = rs2 * (y.float().to(bf).to(f64) @ w_eff
               - mean2 * w_eff.sum(dim=0)) + b2.to(f64) @ w_out.to(f64)
    return (x.to(f64) + o).to(bf)


def test_kernel_at_its_rounding_points(cuda):
    """bf16 gLN B1 against its twin at its own rounding points
    (``_b1_at_its_rounding_points``), sample by sample within 1e-3
    (summation order only), on the samples-apart input with its middle
    sample near-constant per channel: norm1 renormalises every sample, so
    norm2's statistics differ little between samples (a statistic read
    from the neighbouring sample's slots moves the output ~3%, under the
    forward bar of 4e-2) and only this bar sees such a fault."""
    args, _ = _block_args(cuda, torch.bfloat16, "gLN", m=3)
    x = _samples_apart(args[0]).float()
    rng = np.random.default_rng(11)
    x[1] = torch.from_numpy(rng.standard_normal((1, x.shape[2])).astype(
        np.float32)).to(cuda) + 0.05 * x[1]
    args = (x.to(torch.bfloat16), *args[1:])
    kw = dict(dilation=4, causal=False)
    got = port.fused_tcn_block(*args, norm_type="gLN", **kw)
    want = _b1_at_its_rounding_points(*args, **kw)
    for i in range(3):
        assert _rel_l2(got[i], want[i]) <= TP_ORDER_TOL[torch.bfloat16], i


@pytest.mark.parametrize("causal,dilation", [(True, 4), (False, 16)])
def test_cln_kernel_at_its_rounding_points(cuda, causal, dilation):
    """bf16 cLN B1 against its twin at its own rounding points, where the
    Pallas kernel's cLN path rounds (the normalised y, times W_out, no
    fold), sample by sample within 1e-3 (summation order only), on the
    samples-apart input with its middle sample near-constant per channel."""
    args, _ = _block_args(cuda, torch.bfloat16, "cLN", m=3)
    x = _samples_apart(args[0]).float()
    rng = np.random.default_rng(11)
    x[1] = torch.from_numpy(rng.standard_normal((1, x.shape[2])).astype(
        np.float32)).to(cuda) + 0.05 * x[1]
    args = (x.to(torch.bfloat16), *args[1:])
    kw = dict(dilation=dilation, causal=causal)
    got = port.fused_tcn_block(*args, norm_type="cLN", **kw)
    want = _b1_at_its_rounding_points(*args, norm_type="cLN", **kw)
    for i in range(3):
        assert _rel_l2(got[i], want[i]) <= TP_ORDER_TOL[torch.bfloat16], i


@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
@pytest.mark.parametrize("b,h", [(64, 192), (576, 128)])
def test_bf16_kernels_at_other_widths(cuda, norm_type, b, h):
    """bf16 widths the Hopper stages do not take (H not a power of two,
    B above 512) run the first design's launches: B1 against its twin at
    the forward bar, its backward against exact f32 as
    test_kernels_with_five_taps holds it."""
    args, _ = _block_args(cuda, torch.bfloat16, norm_type, b=b, h=h)
    kw = dict(dilation=4, causal=norm_type == "cLN", norm_type=norm_type)
    got = port.fused_tcn_block(*args, **kw)
    assert _rel_l2(got, port.fused_tcn_block_reference(*args, **kw)) <= \
        TOL[torch.bfloat16]
    bargs, g = _bwd_args(cuda, torch.bfloat16, b=b, h=h, norm_type=norm_type)
    got = port_bwd.fused_tcn_block_bwd(bargs[0], g, *bargs[1:], **kw)
    torch.cuda.synchronize()
    _check_against_exact(got, bargs, g, kw, torch.bfloat16)


def test_kernel_is_deterministic(cuda):
    args, _ = _block_args(cuda, torch.bfloat16, "gLN", m=4, k=1000)
    kw = dict(dilation=8, causal=False, norm_type="gLN")
    a = port.fused_tcn_block(*args, **kw)
    b = port.fused_tcn_block(*args, **kw)
    assert torch.equal(a, b)


def test_kernel_rejects_untiled_widths(cuda):
    """Widths off the 64-column tile are padded, not refused: B = 32 and
    H = 96 run the kernel zero-padded to 64 and 128, with the norms taken
    over the block's own 96 channels, within the forward bar of the twin
    in every norm and dtype; more than 16 taps are still refused."""
    for dtype in (torch.float32, torch.bfloat16):
        for norm_type in ("gLN", "cLN", "BN"):
            args, bn = _block_args(cuda, dtype, norm_type, b=32, h=96)
            kw = dict(dilation=4, causal=norm_type == "cLN",
                      norm_type=norm_type, bn_stats=bn)
            before = port.fused_tcn_block.launches
            got = port.fused_tcn_block(*args, **kw)
            assert port.fused_tcn_block.launches == before + 1
            want = port.fused_tcn_block_reference(*args, **kw)
            assert got.shape == want.shape
            err = _rel_l2(got, want)
            assert err <= TOL[dtype], (dtype, norm_type, err)
    args, _ = _block_args(cuda, torch.float32, "gLN")
    dw17 = torch.zeros(17, args[2].shape[1], device=cuda)
    with pytest.raises(ValueError, match="kernel size"):
        port.fused_tcn_block(args[0], args[1], dw17, *args[3:], dilation=1,
                             causal=True, norm_type="gLN")


def test_kernel_path_refuses_autograd(cuda):
    """``fused_tcn_block`` launches the forward kernel only; with grad
    enabled and an operand that requires grad it raises instead of
    returning an output that carries no gradient (training goes through
    ``fused_tcn_block_ad``)."""
    args, _ = _block_args(cuda, torch.float32, "gLN")
    args = (args[0], args[1].requires_grad_(True), *args[2:])
    with pytest.raises(NotImplementedError, match="forward only"):
        port.fused_tcn_block(*args, dilation=1, causal=False,
                             norm_type="gLN")


def _bwd_args(device, dtype, m=2, k=300, b=64, h=128, seed=0,
              norm_type="gLN"):
    """Block operands with a2 < 0 (the sign flip of PReLU'), and a
    cotangent."""
    args, _ = _block_args(device, dtype, norm_type, m=m, k=k, b=b, h=h,
                          seed=seed)
    args = list(args)
    args[5] = torch.tensor(-0.1, device=device)
    g = torch.randn(m, k, b, generator=torch.Generator().manual_seed(seed))
    return args, g.to(device, dtype)


def _check_cotangents(got, want, dtype):
    assert len(got) == len(want) == 10
    for name, q, w in zip(NAMES, got, want):
        assert q.shape == w.shape and q.dtype == w.dtype, name
        assert torch.isfinite(q).all(), name
        err = _rel_l2(q, w)
        assert err <= BWD_TOL[dtype], f"{name}: rel_l2 {err:.3e}"


def _check_against_exact(got, args, g, kw, dtype):
    """The ten cotangents against the exact f32 ones: in f32 within B2's
    bar, in bf16 no further than max(bar, 1.25x the bf16 twin's own
    distance), for the slope gradients that the bf16 twin itself carries
    far from exact. Returns (exact, twin)."""
    f32 = [t.float() for t in args]
    exact = port_bwd.fused_tcn_block_bwd_reference(f32[0], g.float(),
                                                   *f32[1:], **kw)
    twin = port_bwd.fused_tcn_block_bwd_reference(args[0], g, *args[1:],
                                                  **kw)
    for name, q, e, w in zip(NAMES, got, exact, twin):
        assert torch.isfinite(q).all(), name
        bar = BWD_TOL[dtype]
        if dtype == torch.bfloat16:
            bar = max(bar, 1.25 * _rel_l2(w, e))
        assert _rel_l2(q, e) <= bar, f"{name}: rel_l2 {_rel_l2(q, e):.3e}"
    return exact, twin


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,dilation", [
    (False, 1), (False, 4), (False, 128), (True, 2), (True, 128)])
def test_bwd_kernel_matches_twin(cuda, dtype, causal, dilation):
    """All ten cotangents; K=300 is not a multiple of any tile and d=128
    reaches past both ends."""
    args, g = _bwd_args(cuda, dtype)
    kw = dict(dilation=dilation, causal=causal)
    before = port_bwd.fused_tcn_block_bwd.launches
    got = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    torch.cuda.synchronize()
    assert port_bwd.fused_tcn_block_bwd.launches == before + 1
    want = port_bwd.fused_tcn_block_bwd_reference(args[0], g, *args[1:],
                                                  norm_type="gLN", **kw)
    _check_cotangents(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
def test_kernels_with_five_taps(cuda, dtype, norm_type, causal):
    """A depthwise kernel of P = 5 taps: the bf16 kernels' general depthwise
    walk and their E2' that forms dc at every tap (the P = 3 paths keep the
    taps in registers and dc in shared memory); d = 64 reaches past both
    ends of K = 300. The forward against its twin; the ten cotangents
    against the exact f32 ones, in f32 within B2's bar, in bf16 no further
    than max(bar, 1.25x the bf16 twin's own distance): here the bf16 twin's
    slope gradient da1 reads up to 0.19 from exact (cLN), the kernel's
    0.02."""
    args, g = _bwd_args(cuda, dtype, norm_type=norm_type)
    rng = np.random.default_rng(7)
    args[2] = torch.from_numpy(rng.standard_normal((5, 128)).astype(
        np.float32)).to(cuda, dtype)
    kw = dict(dilation=64, causal=causal, norm_type=norm_type)
    got = port.fused_tcn_block(*args, **kw)
    assert _rel_l2(got, port.fused_tcn_block_reference(*args, **kw)) <= TOL[
        dtype]
    got = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    torch.cuda.synchronize()
    _check_against_exact(got, args, g, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
def test_bwd_kernel_matches_twin_with_samples_apart(cuda, dtype, norm_type,
                                                    causal):
    """The backward on three samples whose statistics differ by factors of 2
    and 4: dx sample by sample, and the ten cotangents as
    test_kernels_with_five_taps holds them against exact f32."""
    args, g = _bwd_args(cuda, dtype, m=3, norm_type=norm_type)
    args[0] = _samples_apart(args[0])
    kw = dict(dilation=4, causal=causal, norm_type=norm_type)
    got = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    torch.cuda.synchronize()
    exact, twin = _check_against_exact(got, args, g, kw, dtype)
    for i in range(3):
        bar = BWD_TOL[dtype]
        if dtype == torch.bfloat16:
            bar = max(bar, 1.25 * _rel_l2(twin[0][i], exact[0][i]))
        assert _rel_l2(got[0][i], exact[0][i]) <= bar, f"dx of sample {i}"


def test_bwd_kernel_is_deterministic(cuda):
    args, g = _bwd_args(cuda, torch.bfloat16, m=4, k=1000)
    a = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], dilation=8,
                                     causal=False)
    b = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], dilation=8,
                                     causal=False)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_bwd_kernel_rejects_untiled_widths(cuda):
    """B2 at widths off the tile (B = 32, H = 96), padded as the forward
    pads them: every cotangent at the block's own widths, against the
    exact f32 ones as test_bf16_kernels_at_other_widths holds them."""
    for dtype in (torch.float32, torch.bfloat16):
        args, g = _bwd_args(cuda, dtype, b=32, h=96)
        kw = dict(dilation=4, causal=False, norm_type="gLN")
        got = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
        torch.cuda.synchronize()
        assert [q.shape for q in got] == [a.shape for a in args]
        _check_against_exact(got, args, g, kw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_ad_gradients(cuda, dtype):
    """Autograd through the forward and backward kernels against autograd
    through the plain block, for x and all nine weights (f32 weights, as
    the model keeps them)."""
    args, g = _bwd_args(cuda, dtype, seed=3)
    prims = [args[0]] + [t.float() for t in args[1:]]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in prims]
        out = fn(*leaves, dilation=4, causal=False, norm_type="gLN")
        out.backward(g)
        return out, [t.grad for t in leaves]

    f0 = port.fused_tcn_block.launches
    b0 = port_bwd.fused_tcn_block_bwd.launches
    out, got = grads(port.fused_tcn_block_ad)
    torch.cuda.synchronize()
    assert port.fused_tcn_block.launches == f0 + 1
    assert port_bwd.fused_tcn_block_bwd.launches == b0 + 1
    ref_out, want = grads(port.fused_tcn_block_reference)
    assert out.dtype == dtype
    assert _rel_l2(out, ref_out) <= TOL[dtype]
    _check_cotangents(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,dilation", [
    (True, 1), (True, 4), (True, 128), (False, 2), (False, 128)])
def test_cln_bwd_kernel_matches_twin(cuda, dtype, causal, dilation):
    """B3, all ten cotangents, at B2's bars; K=300 is not a multiple of any
    tile and d=128 reaches past both ends."""
    args, g = _bwd_args(cuda, dtype, norm_type="cLN")
    kw = dict(dilation=dilation, causal=causal, norm_type="cLN")
    before = port_bwd.fused_tcn_block_bwd.cln_launches
    gln_before = port_bwd.fused_tcn_block_bwd.launches
    got = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    torch.cuda.synchronize()
    assert port_bwd.fused_tcn_block_bwd.cln_launches == before + 1
    assert port_bwd.fused_tcn_block_bwd.launches == gln_before
    want = port_bwd.fused_tcn_block_bwd_reference(args[0], g, *args[1:],
                                                  **kw)
    _check_cotangents(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cln_bwd_kernel_is_deterministic(cuda, dtype):
    """Two calls of B3 agree bit for bit (fixed-order partial sums)."""
    args, g = _bwd_args(cuda, dtype, m=4, k=1000, norm_type="cLN")
    kw = dict(dilation=8, causal=True, norm_type="cLN")
    a = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    b = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_cln_bwd_kernel_checks_shapes(cuda):
    """B3 pads widths off the tile (B = 32, H = 96; every cotangent
    against the exact f32 ones) and refuses an even tap count outside the
    causal mode."""
    args, g = _bwd_args(cuda, torch.float32, b=32, h=96, norm_type="cLN")
    kw = dict(dilation=2, causal=True, norm_type="cLN")
    got = port_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
    assert [q.shape for q in got] == [a.shape for a in args]
    _check_against_exact(got, args, g, kw, torch.float32)
    args, g = _bwd_args(cuda, torch.float32, norm_type="cLN")
    dw4 = torch.zeros(4, args[2].shape[1], device=cuda)
    with pytest.raises(ValueError, match="kernel size"):
        port_bwd.fused_tcn_block_bwd(args[0], g, args[1], dw4, *args[3:],
                                     dilation=1, causal=False,
                                     norm_type="cLN")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cln_fused_block_ad_gradients(cuda, dtype):
    """Autograd through B1 (cLN) and B3 against autograd through the plain
    block, causal, for x and all nine weights."""
    args, g = _bwd_args(cuda, dtype, seed=3, norm_type="cLN")
    prims = [args[0]] + [t.float() for t in args[1:]]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in prims]
        out = fn(*leaves, dilation=4, causal=True, norm_type="cLN")
        out.backward(g)
        return out, [t.grad for t in leaves]

    f0 = port.fused_tcn_block.launches
    b0 = port_bwd.fused_tcn_block_bwd.cln_launches
    out, got = grads(port.fused_tcn_block_ad)
    torch.cuda.synchronize()
    assert port.fused_tcn_block.launches == f0 + 1
    assert port_bwd.fused_tcn_block_bwd.cln_launches == b0 + 1
    ref_out, want = grads(port.fused_tcn_block_reference)
    assert out.dtype == dtype
    assert _rel_l2(out, ref_out) <= TOL[dtype]
    _check_cotangents(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cln_model_train_grads_kernel_vs_plain(cuda, dtype):
    """One training forward/backward of a small causal cLN model: every
    block runs B1 and B3 (and never B2), at the bars of the gLN model
    test."""
    from convtasnet_tpu_torch.losses.pit import pit_si_snr

    gen = torch.Generator().manual_seed(4)
    mix = torch.randn(2, 8000, generator=gen).to(cuda)
    src = torch.randn(2, 2, 8000, generator=gen).to(cuda)
    lengths = torch.full((2,), 8000, device=cuda)

    def grads(compute_dtype, use):
        cfg = ConvTasNetConfig(n_filters=64, bottleneck=64, hidden=128,
                               num_blocks=4, num_repeats=2, norm_type="cLN",
                               causal=True, compute_dtype=compute_dtype)
        model = ConvTasNet(cfg, use_pallas=use, device=cuda).train()
        f0 = port.fused_tcn_block.launches
        b0 = port_bwd.fused_tcn_block_bwd.cln_launches
        g0 = port_bwd.fused_tcn_block_bwd.launches
        snr, _ = pit_si_snr(src, model(mix), lengths)
        (-snr.mean()).backward()
        n = cfg.num_blocks * cfg.num_repeats if use else 0
        assert port.fused_tcn_block.launches - f0 == n
        assert port_bwd.fused_tcn_block_bwd.cln_launches - b0 == n
        assert port_bwd.fused_tcn_block_bwd.launches == g0
        return torch.cat([p.grad.reshape(-1) for p in model.parameters()])

    kernel, plain = grads(dtype, True), grads(dtype, False)
    assert torch.isfinite(kernel).all()
    if dtype == "float32":
        assert _rel_l2(kernel, plain) <= BWD_TOL[torch.float32]
    else:
        exact = grads("float32", False)
        assert _rel_l2(kernel, exact) <= max(
            BWD_TOL[torch.bfloat16], 1.25 * _rel_l2(plain, exact))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_train_grads_kernel_vs_plain(cuda, dtype):
    """One training forward/backward of a small gLN model: every block
    runs both kernels, and the gradients agree with the plain path's as
    chip_smoke.py holds them: in f32 to 4e-3 globally; in bf16, where
    either path is far from the f32 gradient, the kernel path no further
    from it than max(8e-2, 1.25x the plain bf16 path)."""
    from convtasnet_tpu_torch.losses.pit import pit_si_snr

    gen = torch.Generator().manual_seed(2)
    mix = torch.randn(2, 8000, generator=gen).to(cuda)
    src = torch.randn(2, 2, 8000, generator=gen).to(cuda)
    lengths = torch.full((2,), 8000, device=cuda)

    def grads(compute_dtype, use, pairs=True):
        cfg = ConvTasNetConfig(n_filters=64, bottleneck=64, hidden=128,
                               num_blocks=4, num_repeats=2,
                               compute_dtype=compute_dtype)
        model = ConvTasNet(cfg, use_pallas=use, device=cuda).train()
        before = _tcn_launches()
        with _pair_switch(pairs):
            snr, _ = pit_si_snr(src, model(mix), lengths)
            (-snr.mean()).backward()
        n = cfg.num_blocks * cfg.num_repeats if use else 0
        # pairs on: blocks (0, 1) and (2, 3) of each repeat as pairs
        want = {"b1": 0 if pairs else n, "b2": 0 if pairs else n,
                "b4": n // 2 if pairs else 0, "b5": n // 2 if pairs else 0}
        assert _tcn_launches(before) == want
        return torch.cat([p.grad.reshape(-1) for p in model.parameters()])

    plain = grads(dtype, False)
    exact = grads("float32", False) if dtype == "bfloat16" else None
    for pairs in (True, False):
        kernel = grads(dtype, True, pairs)
        assert torch.isfinite(kernel).all()
        if dtype == "float32":
            assert _rel_l2(kernel, plain) <= BWD_TOL[torch.float32]
        else:
            assert _rel_l2(kernel, exact) <= max(
                BWD_TOL[torch.bfloat16], 1.25 * _rel_l2(plain, exact))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_kernel_path_matches_plain_path(cuda, dtype):
    cfg = ConvTasNetConfig(n_filters=64, bottleneck=64, hidden=128,
                           num_blocks=4, num_repeats=2, compute_dtype=dtype)
    mix = torch.randn(2, 8000, generator=torch.Generator().manual_seed(1))
    mix = mix.to(cuda)
    outs = {}
    n = cfg.num_blocks * cfg.num_repeats
    for use, pairs in ((True, True), (True, False), (False, True)):
        model = ConvTasNet(cfg, use_pallas=use, device=cuda).eval()
        before = _tcn_launches()
        with torch.inference_mode(), _pair_switch(pairs):
            outs[use, pairs] = model(mix)
        # pairs on: blocks (0, 1) and (2, 3) of each repeat through B4
        b4 = n // 2 if use and pairs else 0
        assert _tcn_launches(before) == {
            "b1": n if use and not pairs else 0, "b2": 0, "b4": b4, "b5": 0}
    assert outs[True, True].dtype == torch.float32
    for pairs in (True, False):
        assert _rel_l2(outs[True, pairs], outs[False, True]) <= TOL[
            getattr(torch, dtype)]
    # a pair runs B1's stages of its dtype and widths on the same
    # operands: the same bits in bf16 and f32
    assert torch.equal(outs[True, True], outs[True, False])


def _pair_args(device, dtype, m=2, k=300, b=64, h=128, seed=0):
    """A pair's input, its two blocks' parameters (the products' weights in
    dtype, slopes and affines f32; block 2's second slope negative, the
    sign flip of PReLU') and a cotangent."""
    args_a, _ = _block_args(device, dtype, "gLN", m=m, k=k, b=b, h=h,
                            seed=seed)
    args_b, _ = _block_args(device, dtype, "gLN", m=m, k=k, b=b, h=h,
                            seed=seed + 1)
    pa, pb = list(args_a[1:]), list(args_b[1:])
    pb[4] = torch.tensor(-0.1, device=device)
    g = torch.randn(m, k, b, generator=torch.Generator().manual_seed(seed))
    return args_a[0], pa, pb, g.to(device, dtype)


PAIR_NAMES = ("dW_in", "d_dw", "dW_out", "da1", "da2", "dg1", "db1", "dg2",
              "db2")


def _check_pair_cotangents(got, want, dtype):
    """All 19 cotangents of a pair at B2's bar: dx and the 14 weight and
    affine gradients each, the four PReLU-slope gradients as one vector
    (as tests/test_torch_train.py holds a model's): each slope gradient is
    a sum of M*K*H cancelling terms, block 1's taken through block 2's
    backward, and alone one reads up to 0.21 from the bf16 twin here while
    the pair equalled chained B2 calls to the bit. With every slope at 1 they
    are held one by one (the next test)."""
    (dx, ga, gb), (wdx, wa, wb) = got, want
    assert len(ga) == len(gb) == 9
    slope = [i for i, n in enumerate(PAIR_NAMES) if n in ("da1", "da2")]
    pairs = [("dx", dx, wdx)] + [
        (f"{blk} {n}", q, w) for blk, qs, ws in (("a", ga, wa), ("b", gb, wb))
        for i, (n, q, w) in enumerate(zip(PAIR_NAMES, qs, ws))
        if i not in slope]
    pairs.append(("the slopes",
                  torch.stack([qs[i].reshape(()) for qs in (ga, gb)
                               for i in slope]),
                  torch.stack([ws[i].reshape(()) for ws in (wa, wb)
                               for i in slope])))
    for name, q, w in pairs:
        assert q.shape == w.shape and q.dtype == w.dtype, name
        assert torch.isfinite(q).all(), name
        err = _rel_l2(q, w)
        assert err <= BWD_TOL[dtype], f"{name}: rel_l2 {err:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm_type,causal", [
    ("gLN", False), ("gLN", True), ("cLN", False), ("cLN", True)])
@pytest.mark.parametrize("d1", [1, 64])
def test_pair_kernel_matches_twin(cuda, dtype, norm_type, causal, d1):
    """B4 at the JAX pair gate; K=300 is not a multiple of any tile and
    d2=128 reaches past both ends."""
    x, pa, pb, _ = _pair_args(cuda, dtype)
    kw = dict(d1=d1, d2=2 * d1, causal=causal, norm_type=norm_type)
    before = _tcn_launches()
    got = pair.fused_tcn_block_pair(x, pa, pb, **kw)
    torch.cuda.synchronize()
    assert _tcn_launches(before) == {"b1": 0, "b2": 0, "b4": 1, "b5": 0}
    assert got.dtype == dtype and torch.isfinite(got).all()
    want = pair.fused_tcn_block_pair_reference(x, pa, pb, **kw)
    assert _rel_l2(got, want) <= PAIR_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
def test_pair_kernel_equals_two_blocks(cuda, dtype, norm_type):
    """B4 runs B1's stages of its dtype and widths on the same operands (in
    bf16 the Hopper stages of csrc/tcn_block_hopper.cuh, in f32 the first
    design's launches): two chained B1 calls give the same bits."""
    x, pa, pb, _ = _pair_args(cuda, dtype, m=3, k=500, seed=5)
    got = pair.fused_tcn_block_pair(x, pa, pb, d1=4, d2=8, causal=True,
                                    norm_type=norm_type)
    x1 = port.fused_tcn_block(x, *pa, dilation=4, causal=True,
                              norm_type=norm_type)
    want = port.fused_tcn_block(x1, *pb, dilation=8, causal=True,
                                norm_type=norm_type)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,d1", [(False, 1), (False, 64), (True, 2)])
def test_pair_bwd_kernel_matches_twin(cuda, dtype, causal, d1):
    """B5, all 19 cotangents at B2's bars."""
    x, pa, pb, g = _pair_args(cuda, dtype, seed=7)
    kw = dict(d1=d1, d2=2 * d1, causal=causal)
    before = _tcn_launches()
    got = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
    torch.cuda.synchronize()
    assert _tcn_launches(before) == {"b1": 0, "b2": 0, "b4": 0, "b5": 1}
    want = pair_bwd.fused_tcn_block_pair_bwd_reference(x, g, pa, pb, **kw)
    _check_pair_cotangents(got, want, dtype)


@pytest.mark.parametrize("causal,d1", [(False, 1), (True, 16)])
def test_pair_bwd_kernel_each_slope_with_slopes_at_one(cuda, causal, d1):
    """B5 in f32 with every PReLU slope at 1: PReLU is the identity, so a
    pre-activation within rounding of 0 moves no slope gradient whichever
    branch it takes, and all 19 cotangents, each slope gradient alone, hold
    B2's f32 bar against the twin."""
    x, pa, pb, g = _pair_args(cuda, torch.float32, seed=15)
    for p in (pa, pb):
        p[3] = p[4] = torch.ones_like(p[3])
    kw = dict(d1=d1, d2=2 * d1, causal=causal)
    got = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
    want = pair_bwd.fused_tcn_block_pair_bwd_reference(x, g, pa, pb, **kw)
    flat = [("dx", got[0], want[0])] + [
        (f"{blk} {n}", q, w) for blk, qs, ws in (("a", got[1], want[1]),
                                                 ("b", got[2], want[2]))
        for n, q, w in zip(PAIR_NAMES, qs, ws)]
    assert len(flat) == 19
    for name, q, w in flat:
        assert q.shape == w.shape and torch.isfinite(q).all(), name
        err = _rel_l2(q, w)
        assert err <= BWD_TOL[torch.float32], f"{name}: rel_l2 {err:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_bwd_kernel_equals_chained_blocks(cuda, dtype):
    """B5 runs B1's and B2's stages of its dtype and widths on the same
    operands: block 2's backward at the forward's x1, then block 1's at its
    cotangent, give the same bits in bf16 and f32."""
    x, pa, pb, g = _pair_args(cuda, dtype, m=3, k=500, seed=9)
    dx, ga, gb = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, d1=2, d2=4,
                                                   causal=False)
    x1 = port.fused_tcn_block(x, *pa, dilation=2, causal=False,
                              norm_type="gLN")
    dx1, *wb = port_bwd.fused_tcn_block_bwd(x1, g, *pb, dilation=4,
                                            causal=False)
    dx0, *wa = port_bwd.fused_tcn_block_bwd(x, dx1, *pa, dilation=2,
                                            causal=False)
    assert torch.equal(dx, dx0)
    assert all(torch.equal(u, v) for u, v in zip((*ga, *gb), (*wa, *wb)))


@pytest.mark.parametrize("dtype,b,h", [
    (torch.bfloat16, 64, 192), (torch.bfloat16, 128, 512),
    (torch.float32, 128, 512)])
def test_pairs_equal_chained_blocks_at_each_width(cuda, dtype, b, h):
    """A pair runs the design a single block of its dtype and widths runs:
    in bf16 at H = 192 (outside the Hopper stages) the first design's
    launches, at H = 512 the Hopper stages, in f32 the first design. B4
    equals two chained B1 calls (gLN and cLN) and B5 chained B1 + B2 + B2
    to the bit at each. Block 1's slopes are off the powers of two, where
    a PReLU output rounded before or after the slope is the same number,
    so that a rounding of h that differs from B1's shows."""
    x, pa, pb, g = _pair_args(cuda, dtype, m=2, k=333, b=b, h=h, seed=13)
    pa[3] = torch.tensor(0.3, device=cuda)
    pa[4] = torch.tensor(0.2, device=cuda)
    for norm_type in ("gLN", "cLN"):
        got = pair.fused_tcn_block_pair(x, pa, pb, d1=2, d2=4, causal=False,
                                        norm_type=norm_type)
        x1 = port.fused_tcn_block(x, *pa, dilation=2, causal=False,
                                  norm_type=norm_type)
        want = port.fused_tcn_block(x1, *pb, dilation=4, causal=False,
                                    norm_type=norm_type)
        assert torch.equal(got, want), norm_type
    dx, ga, gb = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, d1=2, d2=4,
                                                   causal=True)
    x1 = port.fused_tcn_block(x, *pa, dilation=2, causal=True,
                              norm_type="gLN")
    dx1, *wb = port_bwd.fused_tcn_block_bwd(x1, g, *pb, dilation=4,
                                            causal=True)
    dx0, *wa = port_bwd.fused_tcn_block_bwd(x, dx1, *pa, dilation=2,
                                            causal=True)
    assert torch.equal(dx, dx0)
    assert all(torch.equal(u, v) for u, v in zip((*ga, *gb), (*wa, *wb)))


def test_pair_bwd_kernel_is_deterministic(cuda):
    x, pa, pb, g = _pair_args(cuda, torch.bfloat16, m=4, k=1000, seed=11)
    a = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, d1=8, d2=16,
                                          causal=False)
    b = pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, d1=8, d2=16,
                                          causal=False)
    leaves = [a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]
    assert all(torch.equal(u, v) for u, v in zip(*leaves))


def test_pair_kernels_check_shapes(cuda):
    """B4 and B5 pad widths off the tile (B = 32, H = 96) as a block does,
    within the pair bars of their twins; a norm or weights they do not
    take raise."""
    x, pa, pb, g = _pair_args(cuda, torch.float32, b=32, h=96)
    kw = dict(d1=1, d2=2, causal=False)
    got = pair.fused_tcn_block_pair(x, pa, pb, **kw, norm_type="gLN")
    want = pair.fused_tcn_block_pair_reference(x, pa, pb, **kw,
                                               norm_type="gLN")
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= PAIR_TOL[torch.float32]
    _check_pair_cotangents(
        pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw),
        pair_bwd.fused_tcn_block_pair_bwd_reference(x, g, pa, pb, **kw),
        torch.float32)
    x, pa, pb, g = _pair_args(cuda, torch.float32)
    with pytest.raises(ValueError, match="gLN and cLN"):
        pair.fused_tcn_block_pair(x, pa, pb, **kw, norm_type="BN")
    with pytest.raises(ValueError, match="gLN only"):
        pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw,
                                          norm_type="cLN")
    with pytest.raises(ValueError, match="do not fit"):
        pair.fused_tcn_block_pair(x, pa, pb[:1] + [pb[1][:2]] + pb[2:],
                                  **kw, norm_type="gLN")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_pair_ad_gradients(cuda, dtype):
    """Autograd through B4 and B5 against autograd through the plain
    blocks, for x and all 18 weights (f32 weights, as the model keeps
    them)."""
    x, pa, pb, g = _pair_args(cuda, dtype, seed=13)
    prims = [x] + [t.float() for t in (*pa, *pb)]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in prims]
        out = fn(leaves[0], leaves[1:10], leaves[10:], d1=4, d2=8,
                 causal=False, norm_type="gLN")
        out.backward(g)
        return out, [t.grad for t in leaves]

    before = _tcn_launches()
    out, got = grads(pair.fused_tcn_block_pair_ad)
    torch.cuda.synchronize()
    assert _tcn_launches(before) == {"b1": 0, "b2": 0, "b4": 1, "b5": 1}
    ref_out, want = grads(pair.fused_tcn_block_pair_reference)
    assert out.dtype == dtype
    assert _rel_l2(out, ref_out) <= PAIR_TOL[dtype]
    _check_pair_cotangents((got[0], got[1:10], got[10:]),
                           (want[0], want[1:10], want[10:]), dtype)


def test_model_pair_routing(cuda):
    """A small model with an odd X (blocks 0-1 pair, block 2 singly): a
    gLN forward runs B4 and B1, a gLN train step B4+B5 and B1+B2, a cLN
    train step B1+B3 only, a BN forward B1 only."""
    mix = torch.randn(2, 8000, generator=torch.Generator().manual_seed(6))
    mix = mix.to(cuda)
    for norm in ("gLN", "cLN", "BN"):
        cfg = ConvTasNetConfig(n_filters=64, bottleneck=64, hidden=128,
                               num_blocks=3, num_repeats=2, norm_type=norm,
                               causal=norm == "cLN")
        model = ConvTasNet(cfg, use_pallas=True, device=cuda)
        before = _tcn_launches()
        with torch.inference_mode(), _pair_switch(True):
            model.eval()(mix)
        pairs = 0 if norm == "BN" else 2
        assert _tcn_launches(before) == {"b1": 6 - 2 * pairs, "b2": 0,
                                         "b4": pairs, "b5": 0}, norm
        if norm == "BN":
            continue
        c0 = port_bwd.fused_tcn_block_bwd.cln_launches
        before = _tcn_launches()
        with _pair_switch(True):
            model.train()(mix).square().mean().backward()
        torch.cuda.synchronize()
        got = _tcn_launches(before)
        if norm == "gLN":
            assert got == {"b1": 2, "b2": 2, "b4": 2, "b5": 2}
        else:
            assert got == {"b1": 6, "b2": 0, "b4": 0, "b5": 0}
            assert port_bwd.fused_tcn_block_bwd.cln_launches - c0 == 6


DPT_FNS = {
    "inter": (dpt_attention.fused_inter_attention,
              dpt_attention.inter_attention_reference),
    "intra": (dpt_intra.fused_intra_attention,
              dpt_intra.intra_attention_reference),
    "ffn": (dpt_ffn.fused_ffn, dpt_ffn.ffn_reference),
}


def _dpt_args(device, dtype, kind, n, masked, M=2, S=32, B=128, heads=4,
              F=256, seed=0):
    """Seeded operands of one DPT sublayer; with ``masked`` the last 13
    frames (all but 10 when n = 1) are padding. -> (args, kwargs, valid)."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    K = (10 if n == 1 else n * S - 13) if masked else n * S
    valid = torch.arange(n * S, device=device).reshape(n, S) < K
    x = t(rng.standard_normal((M, n, S, B)), dtype)
    gamma, beta = t(1 + 0.1 * rng.standard_normal(B)), t(
        0.1 * rng.standard_normal(B))
    if kind == "ffn":
        return ((x.reshape(M, n * S, B), gamma, beta,
                 t(rng.standard_normal((B, F)) / np.sqrt(B), dtype),
                 t(0.1 * rng.standard_normal(F)),
                 t(rng.standard_normal((F, B)) / np.sqrt(F), dtype),
                 t(0.1 * rng.standard_normal(B))), {}, valid)
    bias = torch.where(valid, 0.0, -1e9) if masked else None
    return ((x, gamma, beta,
             t(rng.standard_normal((B, 3 * B)) / np.sqrt(B), dtype),
             t(rng.standard_normal((B, B)) / np.sqrt(B), dtype), bias),
            dict(n_heads=heads), valid)


def _valid_rows(out, valid, B):
    return out.reshape(out.shape[0], -1, B)[:, valid.reshape(-1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
@pytest.mark.parametrize("n,masked", [(1, True), (1, False), (25, True),
                                      (25, False), (94, True), (94, False)])
def test_dpt_kernel_matches_twin(cuda, dtype, kind, n, masked):
    """n = 1 with 10 real frames puts every inter key at s >= 10 under the
    mask (a uniform softmax); n = 94 is a 15 s utterance's chunk count, more
    than one inter key tile."""
    fused, twin = DPT_FNS[kind]
    args, kw, valid = _dpt_args(cuda, dtype, kind, n, masked)
    before = fused.launches
    with torch.inference_mode():
        got = fused(*args, **kw)
        torch.cuda.synchronize()
        want = twin(*args, **kw)
    assert fused.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    got, want = _valid_rows(got, valid, 128), _valid_rows(want, valid, 128)
    assert torch.isfinite(got).all()
    assert _rel_l2(got, want) <= DPT_TOL[dtype]


@pytest.mark.parametrize("kind", ["inter", "intra"])
@pytest.mark.parametrize("S,heads", [(16, 2), (48, 4)])
def test_dpt_attention_other_shapes(cuda, kind, S, heads):
    """Head width 64 (2 heads of B=128) and chunk lengths 16 and 48."""
    fused, twin = DPT_FNS[kind]
    args, kw, valid = _dpt_args(cuda, torch.bfloat16, kind, 5, True, S=S,
                                heads=heads, seed=1)
    with torch.inference_mode():
        got, want = fused(*args, **kw), twin(*args, **kw)
    assert _rel_l2(_valid_rows(got, valid, 128),
                   _valid_rows(want, valid, 128)) <= TOL[torch.bfloat16]


def test_dpt_kernels_are_deterministic_and_check_shapes(cuda):
    for kind in DPT_FNS:
        fused, _ = DPT_FNS[kind]
        args, kw, _ = _dpt_args(cuda, torch.bfloat16, kind, 7, True, seed=2)
        with torch.inference_mode():
            assert torch.equal(fused(*args, **kw), fused(*args, **kw))
    args, kw, _ = _dpt_args(cuda, torch.float32, "intra", 3, True, B=96,
                            heads=3)
    with pytest.raises(ValueError, match="multiple of 64"):
        dpt_intra.fused_intra_attention(*args, **kw)
    args, kw, _ = _dpt_args(cuda, torch.float32, "inter", 3, True, heads=8)
    with pytest.raises(ValueError, match="head width"):
        dpt_attention.fused_inter_attention(*args, **kw)
    # a chunk off the 16-row tile runs padded with masked frames
    args, kw, valid = _dpt_args(cuda, torch.float32, "intra", 3, True, S=24)
    with torch.inference_mode():
        got = dpt_intra.fused_intra_attention(*args, **kw)
        want = dpt_intra.intra_attention_reference(*args, **kw)
    assert got.shape == want.shape
    assert _rel_l2(_valid_rows(got, valid, 128),
                   _valid_rows(want, valid, 128)) <= DPT_TOL[torch.float32]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dpt_model_kernel_path_matches_plain_path(cuda, dtype):
    """A small DPT model (B=128, 4 heads, 2 layers) serving a 1.3 s
    mixture: every sublayer launches its kernel, the output within the
    forward bars of the plain path's; and a backward through the kernel
    path launches each sublayer's backward kernel."""
    cfg = ConvTasNetConfig(n_filters=64, bottleneck=128, separator="dpt",
                           dpt_chunk=32, dpt_layers=2, dpt_ff=256,
                           compute_dtype=dtype)
    mix = torch.randn(2, 10400, generator=torch.Generator().manual_seed(4))
    mix = mix.to(cuda)
    outs = {}
    for use in (True, False):
        model = ConvTasNet(cfg, use_pallas=use, device=cuda).eval()
        before = [DPT_FNS[k][0].launches for k in DPT_FNS]
        with torch.inference_mode():
            outs[use] = model(mix)
        launched = [DPT_FNS[k][0].launches - b
                    for k, b in zip(DPT_FNS, before)]
        assert launched == ([2, 2, 4] if use else [0, 0, 0])
    assert torch.isfinite(outs[True]).all()
    assert _rel_l2(outs[True], outs[False]) <= TOL[getattr(torch, dtype)]
    model = ConvTasNet(cfg, use_pallas=True, device=cuda).train()
    before = [DPT_BWD_FNS[k][0].launches for k in DPT_BWD_FNS]
    model(mix).square().mean().backward()
    torch.cuda.synchronize()
    assert [DPT_BWD_FNS[k][0].launches - b
            for k, b in zip(DPT_BWD_FNS, before)] == [2, 2, 4]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


DPT_BWD_FNS = {
    "inter": (dpt_attention.fused_inter_attention_bwd,
              dpt_attention.inter_attention_bwd_reference),
    "intra": (dpt_intra.fused_intra_attention_bwd,
              dpt_intra.intra_attention_bwd_reference),
    "ffn": (dpt_ffn.fused_ffn_bwd, dpt_ffn.ffn_bwd_reference),
}
DPT_AD = {
    "inter": (dpt_attention.fused_inter_attention_ad,
              dpt_attention.inter_attention_reference),
    "intra": (dpt_intra.fused_intra_attention_ad,
              dpt_intra.intra_attention_reference),
    "ffn": (dpt_ffn.fused_ffn_ad, dpt_ffn.ffn_reference),
}


def _dpt_bwd_args(device, dtype, kind, n, masked, **kw):
    """``_dpt_args`` with f32 weights (as the model keeps them) and a
    random cotangent, zero on the padded rows. -> (x, g, weights, kwargs,
    valid)."""
    args, kwargs, valid = _dpt_args(device, dtype, kind, n, masked, **kw)
    x = args[0]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(n))
    g = g.to(device).reshape(x.shape[0], -1, x.shape[-1]) * valid.reshape(
        1, -1, 1)
    weights = [None if a is None else a.float() for a in args[1:]]
    return x, g.reshape(x.shape).to(dtype), weights, kwargs, valid


def _check_dpt_cotangents(got, exact, same, valid, dtype):
    assert len(got) == len(exact) == len(same)
    for i, (q, e, t) in enumerate(zip(got, exact, same)):
        assert q.shape == t.shape and q.dtype == t.dtype, i
        if i == 0:
            q, e, t = (_valid_rows(v, valid, v.shape[-1]) for v in (q, e, t))
        assert torch.isfinite(q).all(), i
        if dtype == torch.float32:
            assert _rel_l2(q, e) <= DPT_BWD_TOL, (i, _rel_l2(q, e))
        else:
            assert _rel_l2(q, t) <= DPT_TOL[dtype], (i, _rel_l2(q, t))
            assert _rel_l2(q, e) <= max(DPT_TOL[dtype],
                                        1.25 * _rel_l2(t, e)), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
@pytest.mark.parametrize("n,masked", [(1, True), (25, True), (25, False),
                                      (94, True)])
def test_dpt_bwd_kernel_matches_twin(cuda, dtype, kind, n, masked):
    """Every cotangent of the backward kernels B8, B10 and B12 (dx on the
    valid rows); n = 1 with 10 real frames, n = 94 more than one inter
    tile of 32 chunks."""
    fused, twin = DPT_BWD_FNS[kind]
    x, g, w, kw, valid = _dpt_bwd_args(cuda, dtype, kind, n, masked)
    before = fused.launches
    got = fused(x, g, *w, **kw)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    exact = twin(x.float(), g.float(), *w, **kw)
    same = twin(x, g, *w, **kw)
    _check_dpt_cotangents(got, exact, same, valid, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_dpt_bwd_kernel_matches_twin_at_full_width(cuda, dtype, kind):
    """The DPT quality default's widths (B=256, 8 heads, S=128, F=1024) at
    n = 25 with a masked tail, as chip_smoke.py holds them."""
    fused, twin = DPT_BWD_FNS[kind]
    x, g, w, kw, valid = _dpt_bwd_args(cuda, dtype, kind, 25, True, M=4,
                                       S=128, B=256, heads=8, F=1024)
    got = fused(x, g, *w, **kw)
    exact = twin(x.float(), g.float(), *w, **kw)
    same = twin(x, g, *w, **kw)
    _check_dpt_cotangents(got, exact, same, valid, dtype)


def _ffn_bwd_args(device, B, F, M=2, K=700, seed=0):
    """Seeded bf16 FFN operands at width B and hidden width F over M x K
    rows, the biases off 0, and a random cotangent."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    x = t(rng.standard_normal((M, K, B)), torch.bfloat16)
    g = t(rng.standard_normal((M, K, B)), torch.bfloat16)
    w = (t(1 + 0.1 * rng.standard_normal(B)), t(0.1 * rng.standard_normal(B)),
         t(rng.standard_normal((B, F)) / np.sqrt(B)),
         t(0.3 * rng.standard_normal(F)),
         t(rng.standard_normal((F, B)) / np.sqrt(F)),
         t(0.3 * rng.standard_normal(B)))
    return x, g, w


@pytest.mark.parametrize("B", [64, 128, 192, 256])
@pytest.mark.parametrize("m", [1, 2, 4])
def test_ffn_bwd_wgmma_design_matches_twin(cuda, B, m):
    """B12 (m = 1) and B12p (the last shard of m) in bf16 on the wgmma
    design at B in {64, 128, 192, 256}, F = 1024 / m, over 2 x 700 rows
    (the last 128-row tile holds 120 rows), b_up and b_down off 0: all
    seven cotangents within DPT_TOL of the bf16 twin and no further from
    exact than max(DPT_TOL, 1.25x the twin's own distance); db_down zero in
    partial mode; two calls the same bits."""
    x, g, w = _ffn_bwd_args(cuda, B, 1024)
    partial = m > 1
    if partial:
        x, *w = _shard((x, *w), "ffn", m, m - 1)
    before = (dpt_ffn.fused_ffn_bwd.launches,
              dpt_ffn.fused_ffn_bwd.partial_launches)
    got = dpt_ffn.fused_ffn_bwd(x, g, *w, partial=partial)
    again = dpt_ffn.fused_ffn_bwd(x, g, *w, partial=partial)
    torch.cuda.synchronize()
    after = (dpt_ffn.fused_ffn_bwd.launches,
             dpt_ffn.fused_ffn_bwd.partial_launches)
    assert after == ((before[0], before[1] + 2) if partial
                     else (before[0] + 2, before[1]))
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    exact = dpt_ffn.ffn_bwd_reference(x.float(), g.float(), *w,
                                      partial=partial)
    same = dpt_ffn.ffn_bwd_reference(x, g, *w, partial=partial)
    if partial:
        assert not got[-1].any()
        got, exact, same = got[:-1], exact[:-1], same[:-1]
    valid = torch.ones(x.shape[1], dtype=torch.bool, device=cuda)
    _check_dpt_cotangents(got, exact, same, valid, torch.bfloat16)


@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_dpt_ad_sublayer_on_the_card(cuda, kind):
    """Autograd through each ``_ad`` sublayer (forward kernel, backward
    kernel, one launch each) against autograd through the plain forward,
    in f32; the key bias gets no gradient."""
    ad, plain = DPT_AD[kind]
    x, g, w, kw, valid = _dpt_bwd_args(cuda, torch.float32, kind, 5, True)
    prims = [x, *w] if kind == "ffn" else [x, *w[:-1]]
    const = [] if kind == "ffn" else [w[-1]]

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in prims]
        fn(*leaves, *const, **kw).backward(g)
        return [t.grad for t in leaves]

    f0, b0 = DPT_FNS[kind][0].launches, DPT_BWD_FNS[kind][0].launches
    got = grads(ad)
    torch.cuda.synchronize()
    assert DPT_FNS[kind][0].launches == f0 + 1
    assert DPT_BWD_FNS[kind][0].launches == b0 + 1
    want = grads(plain)
    got[0], want[0] = (_valid_rows(t, valid, t.shape[-1])
                       for t in (got[0], want[0]))
    for q, r in zip(got, want):
        assert q.dtype == r.dtype and _rel_l2(q, r) <= DPT_BWD_TOL


def test_dpt_bwd_kernels_are_deterministic_and_check_shapes(cuda):
    for kind, (fused, _) in DPT_BWD_FNS.items():
        x, g, w, kw, _ = _dpt_bwd_args(cuda, torch.bfloat16, kind, 7, True)
        a, b = fused(x, g, *w, **kw), fused(x, g, *w, **kw)
        assert all(torch.equal(u, v) for u, v in zip(a, b)), kind
    # a chunk longer than 256 frames (every S <= 256 runs, its tiles
    # spilling to the workspace where shared memory cannot hold them)
    x, g, w, kw, _ = _dpt_bwd_args(cuda, torch.float32, "intra", 2, True,
                                   S=272, heads=2)
    with pytest.raises(ValueError, match="at most 256"):
        dpt_intra.fused_intra_attention_bwd(x, g, *w, **kw)
    x, g, w, kw, _ = _dpt_bwd_args(cuda, torch.float32, "inter", 3, True)
    with pytest.raises(ValueError, match="shape"):
        dpt_attention.fused_inter_attention_bwd(x, g[:, :2], *w, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dpt_model_train_grads_kernel_vs_plain(cuda, dtype):
    """One training forward/backward of a small DPT model (B=128, 4 heads,
    2 layers, a padded tail): every sublayer runs both kernels, and the
    gradients agree with the plain path's as chip_smoke.py holds them: in
    f32 to 4e-3 globally (batch seed 6); in bf16 over batch seeds 0-7 the
    median distance of the kernel path from the f32 gradient no larger
    than max(8e-2, 1.25x the plain bf16 path's median), as the smoke holds
    its S = 320 step: at random init each seed's distance is one draw of
    1 / c of the least correlated (estimate, source) pair (PERF.md §6), and
    a single seed reads the kernel/plain ratio from 0.65 to 1.46."""
    from convtasnet_tpu_torch.losses.pit import pit_si_snr

    def batch(seed):
        gen = torch.Generator().manual_seed(seed)
        mix = torch.randn(2, 10400, generator=gen).to(cuda)
        src = torch.randn(2, 2, 10400, generator=gen).to(cuda)
        return mix, src, torch.full((2,), 10400, device=cuda)

    def grads(compute_dtype, use, data):
        mix, src, lengths = data
        cfg = ConvTasNetConfig(n_filters=64, bottleneck=128, separator="dpt",
                               dpt_chunk=32, dpt_layers=2, dpt_ff=256,
                               compute_dtype=compute_dtype)
        model = ConvTasNet(cfg, use_pallas=use, device=cuda).train()
        before = [DPT_BWD_FNS[k][0].launches for k in DPT_BWD_FNS]
        snr, _ = pit_si_snr(src, model(mix), lengths)
        (-snr.mean()).backward()
        launched = [DPT_BWD_FNS[k][0].launches - b
                    for k, b in zip(DPT_BWD_FNS, before)]
        assert launched == ([2, 2, 4] if use else [0, 0, 0])
        return torch.cat([p.grad.reshape(-1) for p in model.parameters()])

    if dtype == "float32":
        data = batch(6)
        kernel, plain = grads(dtype, True, data), grads(dtype, False, data)
        assert torch.isfinite(kernel).all()
        assert _rel_l2(kernel, plain) <= BWD_TOL[torch.float32]
        return
    dists = []
    for seed in range(8):
        data = batch(seed)
        kernel = grads(dtype, True, data)
        assert torch.isfinite(kernel).all(), seed
        exact = grads("float32", False, data)
        dists.append((_rel_l2(kernel, exact),
                      _rel_l2(grads(dtype, False, data), exact)))
    k_med = float(np.median([k for k, _ in dists]))
    p_med = float(np.median([p for _, p in dists]))
    assert k_med <= max(BWD_TOL[torch.bfloat16], 1.25 * p_med), dists


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [4, 2])
def test_dpt_intra_bwd_long_chunk(cuda, dtype, heads):
    """The intra backward at S = 256, as a ``--dpt-chunk 256`` model trains
    it: its [S, S] tiles no longer fit in shared memory beside the rest and
    go to the device workspace; every cotangent at the DPT bars. Head
    widths 32 and 64 (bf16 at 64 runs with fewer warps per block; f32 at
    64 spills its four [S, d] tiles too)."""
    fused, twin = DPT_BWD_FNS["intra"]
    x, g, w, kw, valid = _dpt_bwd_args(cuda, dtype, "intra", 2, True, S=256,
                                       heads=heads)
    got = fused(x, g, *w, **kw)
    torch.cuda.synchronize()
    exact = twin(x.float(), g.float(), *w, **kw)
    same = twin(x, g, *w, **kw)
    _check_dpt_cotangents(got, exact, same, valid, dtype)


def test_dpt_model_trains_with_256_frame_chunks(cuda):
    """One bf16 training forward/backward of a small DPT model with
    256-frame chunks: the intra backward kernel runs at S = 256 in each
    layer, and the gradient is no further from the f32 plain gradient
    than max(8e-2, 1.25x the plain bf16 path's)."""
    from convtasnet_tpu_torch.losses.pit import pit_si_snr

    gen = torch.Generator().manual_seed(8)
    mix = torch.randn(2, 12000, generator=gen).to(cuda)
    src = torch.randn(2, 2, 12000, generator=gen).to(cuda)
    lengths = torch.full((2,), 12000, device=cuda)

    def grads(compute_dtype, use):
        cfg = ConvTasNetConfig(n_filters=64, bottleneck=128, separator="dpt",
                               dpt_chunk=256, dpt_layers=2, dpt_ff=256,
                               compute_dtype=compute_dtype)
        model = ConvTasNet(cfg, use_pallas=use, device=cuda).train()
        before = DPT_BWD_FNS["intra"][0].launches
        snr, _ = pit_si_snr(src, model(mix), lengths)
        (-snr.mean()).backward()
        assert DPT_BWD_FNS["intra"][0].launches - before == (2 if use else 0)
        return torch.cat([p.grad.reshape(-1) for p in model.parameters()])

    kernel, plain = grads("bfloat16", True), grads("bfloat16", False)
    exact = grads("float32", False)
    assert torch.isfinite(kernel).all()
    assert _rel_l2(kernel, exact) <= max(
        BWD_TOL[torch.bfloat16], 1.25 * _rel_l2(plain, exact))


@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_dpt_kernels_on_low_variance_rows(cuda, kind):
    """f32 rows of variance ~1e-3, where an LN eps of 1e-5 put for 1e-6
    would move the normalised rows by ~4.5e-3 (at unit variance by
    4.5e-6, under the f32 bar): the forward kernels hold their twins at
    the f32 DPT bar there too."""
    fused, twin = DPT_FNS[kind]
    args, kw, valid = _dpt_args(cuda, torch.float32, kind, 3, True)
    args = (args[0] * 0.0316, *args[1:])
    got = fused(*args, **kw)
    want = twin(*args, **kw)
    B = args[0].shape[-1]
    err = _rel_l2(_valid_rows(got, valid, B), _valid_rows(want, valid, B))
    assert err <= DPT_TOL[torch.float32], err


@pytest.mark.parametrize("S", [192, 240, 256])
def test_dpt_intra_f32_head_width_64_long_chunks(cuda, S):
    """The intra forward (B9) and backward (B10) in f32 with a head width
    of 64 at chunks whose [S, d] tiles do not fit in shared memory (B9
    above S = 176, B10 above 208): the tiles go to the device workspace,
    and both kernels hold the exact twin at the DPT f32 bar of 1e-5."""
    fused, twin = DPT_FNS["intra"]
    args, kw, valid = _dpt_args(cuda, torch.float32, "intra", 2, True, S=S,
                                heads=2, seed=3)
    with torch.inference_mode():
        got, want = fused(*args, **kw), twin(*args, **kw)
    assert torch.isfinite(got).all()
    assert _rel_l2(_valid_rows(got, valid, 128),
                   _valid_rows(want, valid, 128)) <= DPT_TOL[torch.float32]
    fused_b, twin_b = DPT_BWD_FNS["intra"]
    x, g, w, kw, valid = _dpt_bwd_args(cuda, torch.float32, "intra", 2, True,
                                       S=S, heads=2, seed=4)
    got = fused_b(x, g, *w, **kw)
    torch.cuda.synchronize()
    exact = twin_b(x, g, *w, **kw)
    _check_dpt_cotangents(got, exact, exact, valid, torch.float32)
    assert all(torch.equal(u, v)
               for u, v in zip(got, fused_b(x, g, *w, **kw)))


# The bf16 design of B8 and B10 (csrc/dpt_attn_bwd_wg.cuh): (kind, the
# attended length) at the intra chunk lengths 16, 100 (run padded to 112)
# and 256 and the inter chunk counts 1, 25 and 94
ATTN_WG_LENGTHS = [("intra", 16), ("intra", 100), ("intra", 256),
                   ("inter", 1), ("inter", 25), ("inter", 94)]


def _attn_wg_args(device, kind, length, d, m, seed):
    """bf16 operands of an attention sublayer at B = 128 with heads of
    width d, on shard m - 1 of m (m = 1: the full sublayer): a masked tail
    in the next-to-last chunk and the whole last chunk masked (where there
    is more than one), the key bias of the real frames drawn from
    [-1, 1], LN beta off 0, and a cotangent zero on the masked rows.
    -> (x, g, weights, kwargs, valid)."""
    rng = np.random.default_rng(seed)
    M, B = 2, max(128, d * m)   # d = 128 on a shard of two: B = 256
    n, S = (3, length) if kind == "intra" else (length, 24)
    valid = np.ones((n, S), bool)
    if n > 1:
        valid[-1] = False
        valid[-2, S // 2:] = False
    else:
        valid[0, S - 5:] = False

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    bias = np.where(valid, rng.uniform(-1, 1, (n, S)), -1e9)
    x = t(rng.standard_normal((M, n, S, B)), torch.bfloat16)
    g = t(rng.standard_normal((M, n, S, B)) * valid[None, :, :, None],
          torch.bfloat16)
    args = (x, t(1 + 0.2 * rng.standard_normal(B)),
            t(0.5 + 0.3 * rng.standard_normal(B)),
            t(rng.standard_normal((B, 3 * B)) / np.sqrt(B)),
            t(rng.standard_normal((B, B)) / np.sqrt(B)), t(bias))
    kw = dict(n_heads=B // d)
    if m > 1:
        args = _shard(args, kind, m, m - 1)
        kw = dict(n_heads=B // d // m, partial=True)
    return args[0], g, list(args[1:]), kw, torch.from_numpy(valid).to(device)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("d", [32, 64, 16, 128])
@pytest.mark.parametrize("kind,length", ATTN_WG_LENGTHS,
                         ids=[f"{k}-{n}" for k, n in ATTN_WG_LENGTHS])
def test_dpt_attn_bwd_bf16_design_matches_twin(cuda, kind, length, d, m):
    """B8 and B10 in bf16 (m = 1) and B8p and B10p on the last shard of two
    (m = 2) at head widths 16, 32, 64 and 128 (the core's instances; at
    d = 128 its key side walks the queries twice), over masked frames and a masked
    chunk with the key bias and LN beta off 0: every cotangent at the DPT
    bars against the exact f32 twin and the bf16 twin, launched once in
    the wrapper's count of its mode; two calls give the same bits."""
    fused, twin = DPT_BWD_FNS[kind]
    x, g, w, kw, valid = _attn_wg_args(cuda, kind, length, d, m,
                                       seed=length + d + m)
    counter = "partial_launches" if m > 1 else "launches"
    before = getattr(fused, counter)
    got = fused(x, g, *w, **kw)
    torch.cuda.synchronize()
    assert getattr(fused, counter) == before + 1
    exact = twin(x.float(), g.float(), *w, **kw)
    same = twin(x, g, *w, **kw)
    _check_dpt_cotangents(got, exact, same, valid, torch.bfloat16)
    assert all(torch.equal(u, v)
               for u, v in zip(got, fused(x, g, *w, **kw)))


@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_dpt_attn_bwd_bf16_at_its_rounding_points(cuda, kind):
    """B8 and B10 in bf16 at the quality default's widths, with LN gamma 3
    (sharper attention), against the bf16 twin, which rounds where the
    kernels round: they differ in summation order only (the CPU model of
    the core's schedule reads 1e-5 to 9e-5), so every cotangent holds
    1e-3 (B6's order bar, TP_ORDER_TOL), which a rowsum of round(p) in
    place of p (4.5e-3 in that model) does not."""
    fused, twin = DPT_BWD_FNS[kind]
    x, g, w, kw, valid = _dpt_bwd_args(cuda, torch.bfloat16, kind, 25, True,
                                       M=4, S=128, B=256, heads=8)
    w[0] = 3.0 * w[0]
    got = fused(x, g, *w, **kw)
    same = twin(x, g, *w, **kw)
    for i, (q, t) in enumerate(zip(got, same)):
        if i == 0:
            q, t = (_valid_rows(v, valid, 256) for v in (q, t))
        assert _rel_l2(q, t) <= TP_ORDER_TOL[torch.bfloat16], (
            i, _rel_l2(q, t))


# B7, B9 and B11 (and B7p, B9p, B11p) in bf16 run the Hopper forward
# designs (csrc/dpt_attn_bwd_wg.cuh's forward frame with either gather,
# csrc/dpt_ffn.cu's ffn_wg_kernel): (kind, chunk length S for intra, chunk
# count n for inter, hidden width F for the FFN)
FWD_WG_SIZES = [("intra", 16), ("intra", 100), ("intra", 128),
                ("intra", 320), ("ffn", 1000), ("ffn", 1024),
                ("inter", 1), ("inter", 25), ("inter", 94)]


def _fwd_rounded(kind, args, kw):
    """The forward at the bf16 kernels' rounding points: the FFN's bf16
    twin rounds where the kernel rounds; the attention's rounds the scores
    too, so ``attention_rounded_reference`` stands in for it."""
    if kind == "ffn":
        return dpt_ffn.ffn_reference(*args, **kw)
    return dpt_attention.attention_rounded_reference(
        *args, attend_axis=1 if kind == "inter" else 2, **kw)


def _fwd_wg_args(device, kind, size, m, seed, M=2, B=256):
    """bf16 operands of a forward at B = 256 (8 heads of 32; F = size),
    on shard m - 1 of m (m = 1: the full sublayer): for intra three chunks
    of S = size frames, for inter n = size chunks of 24 frames (one of 24,
    the last 5 masked), the next-to-last half masked and the last one
    masked whole, the real frames' key bias drawn from [-1, 1]; LN beta
    and the biases off 0. -> (args, kwargs, valid rows [K])."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    gamma, beta = (t(1 + 0.2 * rng.standard_normal(B)),
                   t(0.5 + 0.3 * rng.standard_normal(B)))
    if kind == "ffn":
        K = 777
        args = (t(rng.standard_normal((M, K, B)), torch.bfloat16), gamma,
                beta, t(rng.standard_normal((B, size)) / np.sqrt(B)),
                t(0.3 * rng.standard_normal(size)),
                t(rng.standard_normal((size, B)) / np.sqrt(size)),
                t(0.3 * rng.standard_normal(B)))
        valid = torch.ones(K, dtype=torch.bool, device=device)
        kw = {}
    else:
        n, S = (3, size) if kind == "intra" else (size, 24)
        ok = np.ones((n, S), bool)
        if n > 1:
            ok[-1] = False
            ok[-2, S // 2:] = False
        else:
            ok[0, S - 5:] = False
        args = (t(rng.standard_normal((M, n, S, B)), torch.bfloat16), gamma,
                beta, t(rng.standard_normal((B, 3 * B)) / np.sqrt(B)),
                t(rng.standard_normal((B, B)) / np.sqrt(B)),
                t(np.where(ok, rng.uniform(-1, 1, (n, S)), -1e9)))
        valid = torch.from_numpy(ok.reshape(-1)).to(device)
        kw = dict(n_heads=8)
    if m > 1:
        args = _shard(args, kind, m, m - 1)
        kw = dict(_partial_kw(kind, m), partial=True)
    return args, kw, valid


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("kind,size", FWD_WG_SIZES,
                         ids=[f"{k}-{n}" for k, n in FWD_WG_SIZES])
def test_dpt_fwd_bf16_design_matches_twin(cuda, kind, size, m):
    """B9, B11 and B7 in bf16 (m = 1) and B9p, B11p and B7p on the last
    shard of m = 2 and 4: chunks of 16, 100 (padded to 112), 128 and 320
    frames (any S in bf16), 1, 25 and 94 chunks (any n), with masked
    frames and a masked chunk and the key bias off 0, and hidden widths
    1000 (padded to 1024) and 1024, on the valid
    rows within 4e-2 of the bf16 twin and within 1e-3 of the forward at
    the kernels' rounding points (summation order only), launched once in
    the wrapper's count of its mode; two calls give the same bits."""
    fused = DPT_FNS[kind][0]
    args, kw, valid = _fwd_wg_args(cuda, kind, size, m, seed=size + m)
    counter = "partial_launches" if m > 1 else "launches"
    before = getattr(fused, counter)
    with torch.inference_mode():
        got = fused(*args, **kw)
        torch.cuda.synchronize()
        assert getattr(fused, counter) == before + 1
        same = DPT_FNS[kind][1](*args, **kw)
        rounded = _fwd_rounded(kind, args, kw)
        assert torch.equal(got, fused(*args, **kw))
    assert got.dtype == torch.bfloat16 and got.shape == same.shape
    got, same, rounded = (_valid_rows(v, valid, 256)
                          for v in (got, same, rounded))
    assert torch.isfinite(got).all()
    assert _rel_l2(got, same) <= DPT_TOL[torch.bfloat16], _rel_l2(got, same)
    assert _rel_l2(got, rounded) <= TP_ORDER_TOL[torch.bfloat16], (
        _rel_l2(got, rounded))


@pytest.mark.parametrize("B", [64, 128, 192])
@pytest.mark.parametrize("kind", ["intra", "ffn"])
def test_dpt_fwd_bf16_design_at_other_widths(cuda, kind, B):
    """B9 and B11 in bf16 at the other widths they take (heads of 32; at
    B = 192 the out and down products run a 256-wide tile with its last
    64 columns zero, and F1 64-wide column tiles): within 4e-2 of the bf16
    twin and 1e-3 of the forward at their rounding points."""
    fused, twin = DPT_FNS[kind]
    args, kw, valid = _dpt_args(cuda, torch.bfloat16, kind, 4, True, M=2,
                                S=48, B=B, heads=B // 32, F=320, seed=B)
    with torch.inference_mode():
        got = fused(*args, **kw)
        same, rounded = twin(*args, **kw), _fwd_rounded(kind, args, kw)
    got, same, rounded = (_valid_rows(v, valid, B)
                          for v in (got, same, rounded))
    assert torch.isfinite(got).all()
    assert _rel_l2(got, same) <= DPT_TOL[torch.bfloat16], _rel_l2(got, same)
    assert _rel_l2(got, rounded) <= TP_ORDER_TOL[torch.bfloat16], (
        _rel_l2(got, rounded))


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("kind", ["intra", "ffn", "inter"])
def test_dpt_fwd_bf16_at_its_rounding_points(cuda, kind, m):
    """B9, B11 and B7 (m = 1) and B9p, B11p and B7p (m = 2) in bf16 at the quality
    default's widths ([4, 25, 128, 256], 8 heads, F = 1024) with LN gamma
    3 (sharper attention, wider GELU inputs), against the forward that
    rounds where the kernels round: they differ in summation order and in
    the fast exponential only, so the output holds 1e-3 (B6's order bar),
    which h used unrounded, or round(p) skipped, does not."""
    fused = DPT_FNS[kind][0]
    args, kw, valid = _dpt_args(cuda, torch.bfloat16, kind, 25, True, M=4,
                                S=128, B=256, heads=8, F=1024, seed=5)
    args = list(args)
    args[1] = 3.0 * args[1]
    if m > 1:
        args = _shard(args, kind, m, m - 1)
        kw = dict(_partial_kw(kind, m), partial=True)
    with torch.inference_mode():
        got = fused(*args, **kw)
        want = _fwd_rounded(kind, args, kw)
    got, want = (_valid_rows(v, valid, 256) for v in (got, want))
    assert _rel_l2(got, want) <= TP_ORDER_TOL[torch.bfloat16], (
        _rel_l2(got, want))


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_dpt_fwd_bf16_head_widths_16_and_128(cuda, kind, d, m):
    """B7 and B9 (m = 1) and B7p and B9p (the last shard of two) in bf16 at
    B = 256 with 16 heads (d = 16) and 2 (d = 128): within 4e-2 of the
    bf16 twin and 1e-3 of the forward at the rounding points, on the valid
    rows; f32 refuses these widths before any launch, naming the rule."""
    fused, twin = DPT_FNS[kind]
    args, kw, valid = _dpt_args(cuda, torch.bfloat16, kind, 25 if kind ==
                                "inter" else 3, True, M=2, S=64, B=256,
                                heads=256 // d, seed=d + m)
    if m > 1:
        args = _shard(args, kind, m, m - 1)
        kw = dict(n_heads=256 // d // m, partial=True)
    with torch.inference_mode():
        got = fused(*args, **kw)
        same, rounded = twin(*args, **kw), _fwd_rounded(kind, args, kw)
    got, same, rounded = (_valid_rows(v, valid, 256)
                          for v in (got, same, rounded))
    assert torch.isfinite(got).all()
    assert _rel_l2(got, same) <= DPT_TOL[torch.bfloat16], _rel_l2(got, same)
    assert _rel_l2(got, rounded) <= TP_ORDER_TOL[torch.bfloat16], (
        _rel_l2(got, rounded))
    f32 = [a.float() if a is not None and a.dtype == torch.bfloat16 else a
           for a in args]
    before = (fused.launches, fused.partial_launches)
    with pytest.raises(ValueError, match=r"the float32 kernel needs a head "
                       r"width in \(32, 64\)"):
        with torch.inference_mode():
            fused(*f32, **kw)
    assert (fused.launches, fused.partial_launches) == before


def test_dpt_intra_bf16_takes_chunks_past_256(cuda):
    """bf16 chunks of 320 frames run through B9 and B10 (neither keeps a
    per-chunk tile), within the DPT bars of their twins; f32 at S = 320
    raises before any launch, naming its rule."""
    fused, twin = DPT_FNS["intra"]
    args, kw, valid = _dpt_args(cuda, torch.bfloat16, "intra", 2, True,
                                S=320)
    with torch.inference_mode():
        got = fused(*args, **kw)
        want = twin(*args, **kw)
    assert _rel_l2(_valid_rows(got, valid, 128),
                   _valid_rows(want, valid, 128)) <= DPT_TOL[torch.bfloat16]
    bwd, bwd_twin = DPT_BWD_FNS["intra"]
    x, g, w, kw, valid = _dpt_bwd_args(cuda, torch.bfloat16, "intra", 2,
                                       True, S=320)
    got = bwd(x, g, *w, **kw)
    _check_dpt_cotangents(got, bwd_twin(x.float(), g.float(), *w, **kw),
                          bwd_twin(x, g, *w, **kw), valid, torch.bfloat16)
    args, kw, _ = _dpt_args(cuda, torch.float32, "intra", 2, True, S=320)
    counts = (fused.launches, bwd.launches)
    with pytest.raises(ValueError, match="chunk length S of at most 256"):
        with torch.inference_mode():
            fused(*args, **kw)
    x, g, w, kw, _ = _dpt_bwd_args(cuda, torch.float32, "intra", 2, True,
                                   S=320)
    with pytest.raises(ValueError, match="chunk length S of at most 256"):
        bwd(x, g, *w, **kw)
    assert (fused.launches, bwd.launches) == counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_dpt_bwd_kernels_on_low_variance_rows(cuda, dtype, kind):
    """Rows of variance ~1e-6, where the LN's eps of 1e-6 halves the
    normalised rows' scale: the backward kernels (B8, B10, B12; their LN
    statistics in LQ, UG or the first design's rows) hold their twins at
    the DPT bars there, which an LN without its eps (or with another)
    cannot."""
    fused, twin = DPT_BWD_FNS[kind]
    x, g, w, kw, valid = _dpt_bwd_args(cuda, dtype, kind, 3, True)
    x = (x.float() * 1e-3).to(dtype)
    got = fused(x, g, *w, **kw)
    exact = twin(x.float(), g.float(), *w, **kw)
    same = twin(x, g, *w, **kw)
    _check_dpt_cotangents(got, exact, same, valid, dtype)


# --------------------------------------------------------------------------
# Kernel B6: stage 2 of a TCN block under tensor parallelism
# --------------------------------------------------------------------------

def _tp2_args(device, dtype, Hs, seed=0, M=8, K=3199, B=256, P=3):
    """Seeded stage-2 operands of one shard at the paper shape: h as
    stage 1 leaves it (PReLU output), the whole width's gLN-1 statistics
    of a mean ~0.3, rs ~1.2, f32 weights as the model keeps them."""
    g = torch.Generator(device=device).manual_seed(100 + seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    h = torch.nn.functional.leaky_relu(rn(M, K, Hs), 0.25).to(dtype)
    stats1 = torch.stack([0.3 + 0.05 * rn(M), 1.2 + 0.1 * rn(M)], dim=-1)
    return (h, stats1, rn(P, Hs) * (2.0 / (P + Hs * P)) ** 0.5,
            rn(Hs, B) * (2.0 / (2 * Hs)) ** 0.5, torch.tensor(0.25,
                                                            device=device),
            1.0 + 0.1 * rn(Hs), 0.1 * rn(Hs), 1.0 + 0.1 * rn(Hs))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hs", [256, 128])
@pytest.mark.parametrize("dilation", [1, 16, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tp_stage2_kernel_matches_twin(cuda, dtype, Hs, dilation, causal):
    """B6 at [8, 3199, Hs] (Hs 256 for two shards of H = 512, 128 for
    four): z and the gLN-2 sums against the twin at the forward bars, and
    against the twin at B6's own rounding points (``rounding="pallas"``)
    within TP_ORDER_TOL, where a kernel that rounds y g2 otherwise (g2
    folded into W_out reads ~3.6e-3 in bf16) fails."""
    from convtasnet_tpu_torch.ops.cuda import tcn_block_tp as tp

    args = _tp2_args(cuda, dtype, Hs, seed=dilation)
    kw = dict(dilation=dilation, causal=causal)
    before = tp.fused_tp_stage2.launches
    with torch.inference_mode():
        z, sums = tp.fused_tp_stage2(*args, **kw)
        torch.cuda.synchronize()
        z_want, s_want = tp.tp_stage2_reference(*args, **kw)
    assert tp.fused_tp_stage2.launches == before + 1
    assert z.dtype == dtype and z.shape == z_want.shape
    assert sums.dtype == torch.float32 and sums.shape == (8, 2)
    assert torch.isfinite(z).all() and torch.isfinite(sums).all()
    assert _rel_l2(z, z_want) <= TOL[dtype], _rel_l2(z, z_want)
    assert _rel_l2(sums, s_want) <= TOL[dtype], _rel_l2(sums, s_want)
    with torch.inference_mode():
        z_ord, s_ord = tp.tp_stage2_reference(*args, **kw, rounding="pallas")
    assert _rel_l2(z, z_ord) <= TP_ORDER_TOL[dtype], _rel_l2(z, z_ord)
    assert _rel_l2(sums, s_ord) <= TP_ORDER_TOL[dtype], _rel_l2(sums, s_ord)


def test_tp_stage2_kernel_is_deterministic_and_refuses(cuda):
    """Two calls give the same bits; a shard width off the 64-column tile
    runs padded; a shard wider than 512, more than 16 taps and a norm
    other than gLN are refused."""
    from convtasnet_tpu_torch.ops.cuda import tcn_block_tp as tp

    args = _tp2_args(cuda, torch.bfloat16, 128, seed=5, M=2, K=700)
    kw = dict(dilation=4, causal=False)
    with torch.inference_mode():
        a, b = tp.fused_tp_stage2(*args, **kw), tp.fused_tp_stage2(*args, **kw)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        # shard and bottleneck widths off the tile run padded
        narrow = _tp2_args(cuda, torch.bfloat16, 96, M=2, K=700, B=96)
        z, sums = tp.fused_tp_stage2(*narrow, **kw)
        z_want, s_want = tp.tp_stage2_reference(*narrow, **kw)
        assert z.shape == z_want.shape
        assert _rel_l2(z, z_want) <= TOL[torch.bfloat16]
        assert _rel_l2(sums, s_want) <= TOL[torch.bfloat16]
        wide = _tp2_args(cuda, torch.bfloat16, 576, M=2, K=700)
        with pytest.raises(ValueError, match="at most 512"):
            tp.fused_tp_stage2(*wide, **kw)
        taps = _tp2_args(cuda, torch.bfloat16, 128, M=2, K=700, P=17)
        with pytest.raises(ValueError, match="P=17"):
            tp.fused_tp_stage2(*taps, dilation=1, causal=True)
        with pytest.raises(ValueError, match="gLN only"):
            tp.fused_tp_stage2(*args, **kw, norm_type="cLN")


@pytest.mark.parametrize("Hs", [64, 128, 256, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dilation", [1, 16, 128])
def test_tp_stage2_wgmma_stage_matches_twin(cuda, Hs, causal, dilation):
    """B6 in bf16 on its wgmma stage, at every shard width the stage takes
    (Hs 64 to 512, B = 256), at K = 1199 (the last 128-row tile holds 47
    rows): z and the gLN-2 sums against the twin at the forward bars and
    at B6's rounding points within TP_ORDER_TOL, and two calls the same
    bits."""
    from convtasnet_tpu_torch.ops.cuda import tcn_block_tp as tp

    args = _tp2_args(cuda, torch.bfloat16, Hs, seed=Hs + dilation, M=4,
                     K=1199)
    kw = dict(dilation=dilation, causal=causal)
    with torch.inference_mode():
        z, sums = tp.fused_tp_stage2(*args, **kw)
        z2, sums2 = tp.fused_tp_stage2(*args, **kw)
        torch.cuda.synchronize()
        z_want, s_want = tp.tp_stage2_reference(*args, **kw)
        z_ord, s_ord = tp.tp_stage2_reference(*args, **kw, rounding="pallas")
    assert torch.equal(z, z2) and torch.equal(sums, sums2)
    assert torch.isfinite(z).all() and torch.isfinite(sums).all()
    assert _rel_l2(z, z_want) <= TOL[torch.bfloat16], _rel_l2(z, z_want)
    assert _rel_l2(sums, s_want) <= TOL[torch.bfloat16]
    assert _rel_l2(z, z_ord) <= TP_ORDER_TOL[torch.bfloat16], \
        _rel_l2(z, z_ord)
    assert _rel_l2(sums, s_ord) <= TP_ORDER_TOL[torch.bfloat16], \
        _rel_l2(sums, s_ord)


@pytest.mark.parametrize("dtype,Hs", [(torch.float32, 192),
                                      (torch.bfloat16, 192),
                                      (torch.float32, 512)])
def test_tp_stage2_first_design_widths(cuda, dtype, Hs):
    """B6 where it runs its first design (f32, and bf16 at a shard width
    the wgmma stage does not take) against the twin at both rounding
    points, at K = 1199."""
    from convtasnet_tpu_torch.ops.cuda import tcn_block_tp as tp

    args = _tp2_args(cuda, dtype, Hs, seed=7, M=4, K=1199)
    kw = dict(dilation=8, causal=False)
    with torch.inference_mode():
        z, sums = tp.fused_tp_stage2(*args, **kw)
        torch.cuda.synchronize()
        z_want, s_want = tp.tp_stage2_reference(*args, **kw)
        z_ord, s_ord = tp.tp_stage2_reference(*args, **kw, rounding="pallas")
    assert _rel_l2(z, z_want) <= TOL[dtype], _rel_l2(z, z_want)
    assert _rel_l2(sums, s_want) <= TOL[dtype]
    assert _rel_l2(z, z_ord) <= TP_ORDER_TOL[dtype], _rel_l2(z, z_ord)
    assert _rel_l2(sums, s_ord) <= TP_ORDER_TOL[dtype]


def _tp_launches(before=None):
    from convtasnet_tpu_torch.ops.cuda import tcn_block_tp as tp

    now = {**_tcn_launches(), "b6": tp.fused_tp_stage2.launches}
    return now if before is None else {k: now[k] - before[k] for k in now}


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("pairs", [False, True])
def test_tp_forward_launches_b6_only(cuda, n_model, pairs):
    """``tp_forward`` of the paper config (gLN, 32 blocks) over m shards on
    the card: 32 m launches of B6 and none of B1 or B4 in either pair
    switch state, within the forward bars of the unsharded kernel path in
    bf16 and f32; a TP train step launches B6 32 m times too."""
    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import (
        make_tcn_tp_train_step,
        tp_forward,
    )
    from convtasnet_tpu_torch.train.train_step import create_train_state

    devices = shard_devices(n_model, cuda)
    assert devices == [torch.device("cuda", s % torch.cuda.device_count())
                       for s in range(n_model)]
    mix = torch.randn(2, 16000, generator=torch.Generator().manual_seed(
        n_model)).to(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        cfg = ConvTasNetConfig(compute_dtype=str(dtype).split(".")[-1])
        model = ConvTasNet(cfg, device=cuda).eval()
        with torch.inference_mode(), _pair_switch(pairs):
            want = model(mix)
            before = _tp_launches()
            got = tp_forward(cfg, model.state_dict(), mix, devices)
            torch.cuda.synchronize()
            assert _tp_launches(before) == {"b1": 0, "b2": 0, "b4": 0,
                                            "b5": 0, "b6": 32 * n_model}
        assert torch.isfinite(got).all() and got.shape == want.shape
        assert _rel_l2(got, want) <= TOL[dtype], _rel_l2(got, want)
    state = create_train_state(cfg, SolverConfig(), device=cuda)
    step = make_tcn_tp_train_step(cfg, devices)
    batch = (mix, torch.full((2,), 16000, device=cuda),
             torch.randn(2, 2, 16000, device=cuda), torch.ones(2, device=cuda))
    before = _tp_launches()
    with _pair_switch(pairs):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert _tp_launches(before) == {"b1": 0, "b2": 0, "b4": 0, "b5": 0,
                                    "b6": 32 * n_model}
    assert np.isfinite(float(metrics["loss"]))


# the DPT quality default's widths (B=256, 8 heads of 32, F=1024), split
# into m shards as dual-path tensor parallelism splits them
SHARDS = (2, 4)


def _shard(args, kind, m, s):
    """Shard s of m of a full sublayer's operands: q, k and v columns of
    head group s, the rows of W_out; or the hidden slice s of the FFN."""
    if kind == "ffn":
        x, g_, b_, w_up, b_up, w_down, b_down = args
        fq = w_up.shape[1] // m
        cut = slice(s * fq, (s + 1) * fq)
        return (x, g_, b_, w_up[:, cut].contiguous(), b_up[cut].contiguous(),
                w_down[cut].contiguous(), b_down)
    x, g_, b_, w_qkv, w_out, bias = args
    B = x.shape[-1]
    bq = B // m
    cut = slice(s * bq, (s + 1) * bq)
    q, k, v = w_qkv.split(B, dim=1)
    return (x, g_, b_, torch.cat([q[:, cut], k[:, cut], v[:, cut]], dim=1),
            w_out[cut].contiguous(), bias)


def _partial_kw(kind, m):
    return {} if kind == "ffn" else dict(n_heads=8 // m)


def _full_width_args(device, dtype, kind, seed=0):
    return _dpt_args(device, dtype, kind, 5, True, S=128, B=256, heads=8,
                     F=1024, seed=seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
@pytest.mark.parametrize("m", SHARDS)
def test_dpt_partial_kernel_matches_twin(cuda, dtype, kind, m):
    """Kernels B7p, B9p and B11p on the last shard of m at the quality
    default's widths (Bq 128 with 4 heads and F/m 512 at m = 2; Bq 64, 2
    heads and 256 at m = 4) against their partial twins; a partial launch
    counts in ``partial_launches`` only."""
    fused, twin = DPT_FNS[kind]
    args, _, valid = _full_width_args(cuda, dtype, kind)
    args, kw = _shard(args, kind, m, m - 1), _partial_kw(kind, m)
    before = (fused.launches, fused.partial_launches)
    with torch.inference_mode():
        got = fused(*args, **kw, partial=True)
        torch.cuda.synchronize()
        want = twin(*args, **kw, partial=True)
    assert (fused.launches, fused.partial_launches) == (before[0],
                                                        before[1] + 1)
    assert got.dtype == dtype and got.shape == want.shape
    got, want = _valid_rows(got, valid, 256), _valid_rows(want, valid, 256)
    assert torch.isfinite(got).all()
    assert _rel_l2(got, want) <= DPT_TOL[dtype], _rel_l2(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
@pytest.mark.parametrize("m", SHARDS)
def test_dpt_partial_bwd_kernel_matches_twin(cuda, dtype, kind, m):
    """Kernels B8p, B10p and B12p on the last shard of m: every cotangent
    against the partial twin's (dx with no residual term); the FFN's
    db_down is zero."""
    fused, twin = DPT_BWD_FNS[kind]
    x, g, w, _, valid = _dpt_bwd_args(cuda, dtype, kind, 5, True, S=128,
                                      B=256, heads=8, F=1024)
    x, *w = _shard((x, *w), kind, m, m - 1)
    kw = dict(_partial_kw(kind, m), partial=True)
    before = fused.partial_launches
    got = fused(x, g, *w, **kw)
    torch.cuda.synchronize()
    assert fused.partial_launches == before + 1
    exact = twin(x.float(), g.float(), *w, **kw)
    same = twin(x, g, *w, **kw)
    if kind == "ffn":
        assert not got[-1].any()
        got, exact, same = got[:-1], exact[:-1], same[:-1]
    _check_dpt_cotangents(got, exact, same, valid, dtype)


@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
@pytest.mark.parametrize("m", SHARDS)
def test_dpt_partial_kernels_sum_to_the_full_kernel(cuda, kind, m):
    """The Megatron identity in f32: the m shards' partial kernels summed,
    plus the residual (plus b_down), equal the full kernel within 1e-5; and
    their backwards' dx summed plus g, dgamma and dbeta summed, equal the
    full backward's."""
    fused, _ = DPT_FNS[kind]
    fused_b, _ = DPT_BWD_FNS[kind]
    args, kw, valid = _full_width_args(cuda, torch.float32, kind, seed=3)
    x = args[0]
    with torch.inference_mode():
        full = fused(*args, **kw)
        parts = [fused(*_shard(args, kind, m, s), **_partial_kw(kind, m),
                       partial=True) for s in range(m)]
    acc = x + sum(parts) + (args[-1] if kind == "ffn" else 0)
    assert _rel_l2(_valid_rows(acc, valid, 256),
                   _valid_rows(full, valid, 256)) <= DPT_TOL[torch.float32]
    xb, g, w, _, valid = _dpt_bwd_args(cuda, torch.float32, kind, 5, True,
                                       S=128, B=256, heads=8, F=1024)
    full = fused_b(xb, g, *w, **kw)
    parts = [fused_b(xb, g, *_shard((xb, *w), kind, m, s)[1:],
                     **_partial_kw(kind, m), partial=True) for s in range(m)]
    dx = g + sum(p[0] for p in parts)
    assert _rel_l2(_valid_rows(dx, valid, 256),
                   _valid_rows(full[0], valid, 256)) <= DPT_BWD_TOL
    for i in (1, 2):
        assert _rel_l2(sum(p[i] for p in parts), full[i]) <= DPT_BWD_TOL, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_dpt_full_and_partial_modes_share_their_arithmetic(cuda, dtype,
                                                           kind):
    """The full kernel is the partial kernel of one shard with the residual
    (and b_down) added at its rounding points, to the bit: for the
    attention round(x + partial), for the FFN round(x + round(partial +
    round(b_down)))."""
    fused, _ = DPT_FNS[kind]
    args, kw, _ = _full_width_args(cuda, dtype, kind, seed=5)
    with torch.inference_mode():
        full = fused(*args, **kw)
        part = fused(*args, **kw, partial=True)
    x = args[0].float()
    if kind == "ffn":
        part = (part.float() + args[-1].to(dtype).float()).to(dtype)
    assert torch.equal(full, (x + part.float()).to(dtype))


def test_dpt_partial_kernels_refuse_widths_they_do_not_take(cuda,
                                                            monkeypatch):
    """On CUDA tensors the partial wrappers launch or raise: a shard width
    that is not a multiple of 64 (eight shards of B=256) names the shard
    counts that fit, a head width outside the bf16 kernels' {16, 32, 64,
    128} (8: 16 heads on a shard of 128 channels) raises, a shard's
    weights without ``partial=True`` raise, and with the kernel library
    made to fail the wrapper raises and counts no launch; F/m off the
    128-column tile (F/16 = 64) runs padded. ``dpt_tp_forward`` over eight
    shards raises, under auto as with ``use_pallas=True``, before any
    launch."""
    from convtasnet_tpu_torch.ops.cuda import build
    from convtasnet_tpu_torch.parallel.dpt_tp import dpt_tp_forward
    from convtasnet_tpu_torch.parallel.mesh import shard_devices

    args, kw, _ = _full_width_args(cuda, torch.bfloat16, "inter")
    with pytest.raises(ValueError, match=r"fit: \[1, 2, 4\]"):
        dpt_attention.fused_inter_attention(*_shard(args, "inter", 8, 0),
                                            n_heads=1, partial=True)
    with pytest.raises(ValueError, match="head width"):
        dpt_intra.fused_intra_attention(*_shard(args, "intra", 2, 0),
                                        n_heads=16, partial=True)
    with pytest.raises(ValueError, match="partial=True"):
        dpt_attention.fused_inter_attention(*_shard(args, "inter", 2, 0),
                                            n_heads=4)
    fargs, _, valid = _full_width_args(cuda, torch.bfloat16, "ffn")
    narrow = _shard(fargs, "ffn", 16, 0)
    with torch.inference_mode():
        got = dpt_ffn.fused_ffn(*narrow, partial=True)
        want = dpt_ffn.ffn_reference(*narrow, partial=True)
    assert _rel_l2(_valid_rows(got, valid, 256), _valid_rows(
        want, valid, 256)) <= DPT_TOL[torch.bfloat16]
    cfg = ConvTasNetConfig(separator="dpt", dpt_layers=1)
    mix = torch.randn(1, 8000, generator=torch.Generator().manual_seed(4))
    mix = mix.to(cuda)
    before = _partial_launches()
    for use_pallas in (True, None):
        with pytest.raises(ValueError, match=r"fit: \[1, 2, 4\]"):
            dpt_tp_forward(cfg, {}, mix, shard_devices(8, cuda),
                           use_pallas=use_pallas)
    assert not any(_partial_launches(before).values())

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    for mod in (build, dpt_attention, dpt_ffn):
        monkeypatch.setattr(mod, "load_library", broken_loader)
    for kind, (fused, _) in DPT_FNS.items():
        a, _, _ = _full_width_args(cuda, torch.bfloat16, kind)
        before = fused.partial_launches
        with torch.inference_mode(), pytest.raises(RuntimeError,
                                                   match="unavailable"):
            fused(*_shard(a, kind, 2, 0), **_partial_kw(kind, 2),
                  partial=True)
        assert fused.partial_launches == before


def _partial_launches(before=None):
    now = {f"{k}{'' if i == 0 else '_bwd'}": fns[k][0].partial_launches
           for i, fns in enumerate((DPT_FNS, DPT_BWD_FNS)) for k in fns}
    full = sum(fns[k][0].launches for fns in (DPT_FNS, DPT_BWD_FNS)
               for k in fns)
    now["full"] = full
    return now if before is None else {k: now[k] - before[k] for k in now}


@pytest.mark.parametrize("n_model", SHARDS)
def test_dpt_tp_forward_and_step_launch_the_partial_kernels(cuda, n_model):
    """``dpt_tp_forward`` of a two-layer model at the quality default's
    widths (its biases and norm affines moved off their init, so a down
    bias added once per shard shows) over m shards on the card: per
    forward m x (2 B7p, 2 B9p, 4 B11p) and no full-mode launch, within
    4e-2 (bf16) and 1e-5 (f32) of the unsharded kernel path; a TP train
    step launches the partial backwards m x (2, 2, 4) times, finite."""
    from convtasnet_tpu_torch import SolverConfig
    from convtasnet_tpu_torch.parallel.dpt_tp import (
        dpt_tp_forward,
        make_dpt_tp_train_step,
    )
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.train.train_step import create_train_state

    devices = shard_devices(n_model, cuda)
    mix = torch.randn(2, 16000, generator=torch.Generator().manual_seed(
        n_model)).to(cuda)
    per = {"inter": 2, "intra": 2, "ffn": 4}
    for dtype in (torch.bfloat16, torch.float32):
        cfg = ConvTasNetConfig(separator="dpt", dpt_layers=2,
                               compute_dtype=str(dtype).split(".")[-1])
        model = ConvTasNet(cfg, device=cuda).eval()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith(("bias", "gamma", "beta")):
                    p.add_(0.1 * torch.randn(p.shape, device=cuda))
        with torch.inference_mode():
            want = model(mix)
            before = _partial_launches()
            got = dpt_tp_forward(cfg, model.state_dict(), mix, devices)
            torch.cuda.synchronize()
        counts = _partial_launches(before)
        assert counts == {**{k: n_model * v for k, v in per.items()},
                          **{f"{k}_bwd": 0 for k in per}, "full": 0}
        assert torch.isfinite(got).all() and got.shape == want.shape
        bar = TOL[dtype] if dtype == torch.bfloat16 else DPT_TOL[dtype]
        assert _rel_l2(got, want) <= bar, _rel_l2(got, want)
    state = create_train_state(cfg, SolverConfig(), device=cuda)
    batch = (mix, torch.full((2,), 16000, device=cuda),
             torch.randn(2, 2, 16000, device=cuda), torch.ones(2, device=cuda))
    before = _partial_launches()
    state, metrics = make_dpt_tp_train_step(cfg, devices)(state, batch)
    torch.cuda.synchronize()
    counts = _partial_launches(before)
    assert counts == {**{k: n_model * v for k, v in per.items()},
                      **{f"{k}_bwd": n_model * v for k, v in per.items()},
                      "full": 0}
    assert np.isfinite(float(metrics["loss"]))


# --------------------------------------------------------------------------
# Auto mode: widths off the kernels' tiles run padded through the kernels;
# a shape no kernel takes raises before any launch
# --------------------------------------------------------------------------

# a TCN at B = H = 96 and a DPT with 100-frame chunks and F = 192, all of
# which JAX runs with its kernels on
AUTO_PADDED = {
    "tcn": dict(n_filters=64, kernel_size=16, bottleneck=96, hidden=96,
                num_blocks=2, num_repeats=1),
    "dpt": dict(separator="dpt", n_filters=64, kernel_size=16,
                bottleneck=64, dpt_chunk=100, dpt_layers=1, dpt_heads=2,
                dpt_ff=192),
}
# (config, the rule the error names): 17 causal taps, a DPT wider than 256
AUTO_REFUSED = {
    "tcn": (dict(n_filters=64, kernel_size=16, bottleneck=64, hidden=128,
                 conv_kernel=17, causal=True, num_blocks=2, num_repeats=1),
            "P=17"),
    "dpt": (dict(separator="dpt", n_filters=64, kernel_size=16,
                 bottleneck=320, dpt_layers=1, dpt_heads=5, dpt_ff=256),
            "at most 256"),
}


def _dpt_launch_counts(before=None):
    now = {f"{k}{sfx}": fns[k][0].launches
           for sfx, fns in (("", DPT_FNS), ("_bwd", DPT_BWD_FNS)) for k in fns}
    return now if before is None else {k: now[k] - before[k] for k in now}


@pytest.mark.parametrize("family", ["tcn", "dpt"])
def test_auto_mode_runs_padded_widths_through_the_kernels(cuda, family):
    """Under use_pallas=None on the card, one model serves a batch and
    trains a step at widths off the kernels' tiles (a TCN at B = H = 96, a
    DPT with 100-frame chunks and F = 192): every block or sublayer
    launches its kernel, the served output is within the f32 forward bar
    of the plain model and the step's loss is finite."""
    from convtasnet_tpu_torch.config import SolverConfig
    from convtasnet_tpu_torch.train import train_step as ts

    cfg = ConvTasNetConfig(**AUTO_PADDED[family])
    gen = torch.Generator().manual_seed(3)
    mix = torch.randn(2, 8000, generator=gen).to(cuda)
    data = (mix, torch.full((2,), 8000, dtype=torch.int32, device=cuda),
            torch.randn(2, 2, 8000, generator=gen).to(cuda),
            torch.ones(2, device=cuda))
    plain = ConvTasNet(cfg, use_pallas=False, device=cuda).eval()
    state = ts.create_train_state(cfg, SolverConfig(), device=cuda)
    state.model.load_state_dict(plain.state_dict())
    tcn0, dpt0 = _tcn_launches(), _dpt_launch_counts()
    state.model.eval()
    with torch.inference_mode():
        got, want = state.model(mix), plain(mix)
    state, metrics = ts.make_train_step()(state, data)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert _rel_l2(got, want) <= TOL[torch.float32], _rel_l2(got, want)
    tcn, dpt = _tcn_launches(tcn0), _dpt_launch_counts(dpt0)
    if family == "tcn":   # serve 2 B1, step 2 B1 + 2 B2
        assert tcn == {"b1": 4, "b2": 2, "b4": 0, "b5": 0}, tcn
        assert not any(dpt.values()), dpt
    else:
        assert not any(tcn.values()), tcn
        assert dpt == {"inter": 2, "intra": 2, "ffn": 4, "inter_bwd": 1,
                       "intra_bwd": 1, "ffn_bwd": 2}, dpt


@pytest.mark.parametrize("family", ["tcn", "dpt"])
def test_auto_mode_raises_where_no_kernel_takes_the_shape(cuda, family):
    """A shape no kernel takes (a TCN with 17 causal taps, a DPT at
    B = 320) raises under auto on the card as with
    use_pallas=True, naming the rule, before any launch; use_pallas=False
    serves it through the plain ops."""
    kw, rule = AUTO_REFUSED[family]
    cfg = ConvTasNetConfig(**kw)
    mix = torch.randn(2, 8000, generator=torch.Generator().manual_seed(3))
    mix = mix.to(cuda)
    tcn0, dpt0 = _tcn_launches(), _dpt_launch_counts()
    for use_pallas in (None, True):
        model = ConvTasNet(cfg, use_pallas=use_pallas, device=cuda).eval()
        with torch.inference_mode(), pytest.raises(ValueError, match=rule):
            model(mix)
    assert not any(_tcn_launches(tcn0).values())
    assert not any(_dpt_launch_counts(dpt0).values())
    with torch.inference_mode():
        out = ConvTasNet(cfg, use_pallas=False, device=cuda).eval()(mix)
    assert out.shape == (2, 2, 8000) and torch.isfinite(out).all()


def test_tp_forward_pads_untiled_shard_widths(cuda):
    """``tp_forward`` of a gLN TCN whose shard width is off the tile (H =
    192 over two shards: Hs = 96) under auto: B6 launches for every block
    and shard, padded, within the f32 forward bar of the unsharded plain
    model."""
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward

    cfg = ConvTasNetConfig(n_filters=64, kernel_size=16, bottleneck=64,
                           hidden=192, num_blocks=2, num_repeats=1)
    model = ConvTasNet(cfg, use_pallas=False, device=cuda).eval()
    mix = torch.randn(2, 8000, generator=torch.Generator().manual_seed(5))
    mix = mix.to(cuda)
    before = _tp_launches()
    with torch.inference_mode():
        got = tp_forward(cfg, model.state_dict(), mix, shard_devices(2, cuda))
        want = model(mix)
    assert _tp_launches(before) == {"b1": 0, "b2": 0, "b4": 0, "b5": 0,
                                    "b6": 2 * 2}
    assert _rel_l2(got, want) <= TOL[torch.float32], _rel_l2(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dpt_kernels_pad_untiled_widths(cuda, dtype):
    """A chunk of S = 100 frames (off the intra kernels' 16-row tile) and
    an FFN hidden width of F = 192 (off the 128-column tile) run B9, B10
    and B11, B12 padded: the forwards within DPT_TOL of their twins on the
    valid rows, every cotangent as test_dpt_bwd_kernel_matches_twin holds
    it."""
    for kind, extra in (("intra", dict(S=100)), ("ffn", dict(F=192))):
        fused, twin = DPT_FNS[kind]
        args, kw, valid = _dpt_args(cuda, dtype, kind, 3, True, **extra)
        with torch.inference_mode():
            got, want = fused(*args, **kw), twin(*args, **kw)
        assert got.shape == want.shape, kind
        assert _rel_l2(_valid_rows(got, valid, 128), _valid_rows(
            want, valid, 128)) <= DPT_TOL[dtype], kind
        fused_bwd, twin_bwd = DPT_BWD_FNS[kind]
        x, g, w, kw, valid = _dpt_bwd_args(cuda, dtype, kind, 3, True,
                                           **extra)
        got = fused_bwd(x, g, *w, **kw)
        _check_dpt_cotangents(got, twin_bwd(x.float(), g.float(), *w, **kw),
                              twin_bwd(x, g, *w, **kw), valid, dtype)


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


@pytest.mark.parametrize("name", ["tcn", "dpt"])
def test_jax_fixture_served_through_the_kernels(cuda, name):
    """A committed JAX training checkpoint (``scripts/make_jax_fixtures.py``,
    f32) loaded as ``separate`` loads it and served on the card: the plain
    path within 5e-4 and the kernel path within 2e-3 (max abs) of the JAX
    estimates stored beside it, the kernels launched once per block, or
    per sublayer."""
    from convtasnet_tpu_torch.train.checkpoint import (
        load_params_for_inference,
    )

    z = np.load(os.path.join(FIXTURES, "jax_fixtures.npz"))
    cfg, sd = load_params_for_inference(
        os.path.join(FIXTURES, f"jax_{name}.ckpt"), device=cuda)
    mix = torch.from_numpy(z["mixture"]).to(cuda)
    want = torch.from_numpy(z[f"{name}_est"]).to(cuda)
    fns = ([DPT_FNS[k][0] for k in ("inter", "intra", "ffn")]
           if name == "dpt" else [port.fused_tcn_block])
    for flag, bar in ((False, 5e-4), (None, 2e-3)):
        model = ConvTasNet(cfg, use_pallas=flag, device=cuda)
        model.load_state_dict(sd)
        before = [fn.launches for fn in fns]
        with _pair_switch(False), torch.inference_mode():
            est = model.eval()(mix)
        launched = [fn.launches - b for fn, b in zip(fns, before)]
        if flag is None:
            assert launched == ([cfg.dpt_layers, cfg.dpt_layers,
                                 2 * cfg.dpt_layers] if name == "dpt"
                                else [cfg.num_blocks * cfg.num_repeats])
        else:
            assert launched == [0] * len(fns)
        assert (est - want).abs().max().item() <= bar, (flag, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type,causal", [("gLN", False), ("cLN", True)])
def test_imported_reference_package_through_b1(cuda, tmp_path, dtype,
                                               norm_type, causal):
    """A reference-layout package (``tests/torch_oracle.make_state_dict``)
    through ``import_to_checkpoint`` and served on the card through B1,
    once per block, within the forward bars of ``torch_oracle.forward`` on
    the card."""
    import dataclasses

    from convtasnet_tpu_torch.models.torch_import import import_to_checkpoint
    from convtasnet_tpu_torch.train.checkpoint import (
        load_params_for_inference,
    )
    import importlib.util

    # from its file: another package named ``tests`` may sit on the path
    spec = importlib.util.spec_from_file_location("torch_oracle", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "torch_oracle.py"))
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    cfg = ConvTasNetConfig(n_filters=64, kernel_size=16, bottleneck=64,
                           hidden=128, num_blocks=4, num_repeats=1,
                           norm_type=norm_type, causal=causal)
    ref = oracle.make_state_dict(cfg, seed=4)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"N": cfg.n_filters, "L": cfg.kernel_size,
                "B": cfg.bottleneck, "H": cfg.hidden, "P": cfg.conv_kernel,
                "X": cfg.num_blocks, "R": cfg.num_repeats,
                "C": cfg.num_speakers, "norm_type": cfg.norm_type,
                "causal": cfg.causal, "mask_nonlinear": cfg.mask_nonlinear,
                "state_dict": ref}, path)
    pkg = str(tmp_path / "imported.pt")
    import_to_checkpoint(path, pkg)
    got_cfg, sd = load_params_for_inference(pkg, device=cuda)
    model = ConvTasNet(dataclasses.replace(got_cfg, compute_dtype=dtype),
                       device=cuda)
    model.load_state_dict(sd)
    mix = torch.randn(2, 16000, generator=torch.Generator().manual_seed(3))
    mix = mix.to(cuda)
    before = _tcn_launches()
    with _pair_switch(False), torch.inference_mode():
        est = model.eval()(mix)
    assert _tcn_launches(before) == {"b1": cfg.num_blocks, "b2": 0, "b4": 0,
                                     "b5": 0}
    with torch.no_grad():
        want = oracle.forward({k: v.to(cuda) for k, v in ref.items()}, cfg,
                              mix)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    assert _rel_l2(est, want) <= TOL[dt], _rel_l2(est, want)
