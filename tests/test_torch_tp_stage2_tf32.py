"""A numpy model of kernel B6's f32 route (TP stage 2 on the 3xTF32 core,
``csrc/tcn_block_tp.cu``) against the port's twin and the JAX package.

The route's arithmetic, as the model follows it:

- the depthwise stage: gLN-1's scale sc = rs1 g1 and shift sh = b1 -
  mean1 sc per channel, then per element hn = h sc + sh and acc = dw[q]
  hn + acc as f32 FMAs (each evaluated in float64 and rounded once) in
  the tap order q = 0..P-1, a tap outside [0, K) adding nothing (its
  share of the shift included); y = PReLU_a2(acc) and y g2 rounded to
  f32; the gLN-2 sums of y;
- the product z = (y g2) @ W_out_s in 32-deep slabs: each operand split
  into tf32 hi and lo (``tests/test_torch_tf32_split.py``'s rule), each
  slab's lo*hi + hi*lo + hi*hi summed in float64 and rounded to f32, the
  slabs joined by f32 adds.

The model is held within 1e-5 (B6's bar at its rounding points,
``TP_ORDER_TOL``) of ``tp_stage2_reference(rounding="pallas")`` and of the
Pallas ``fused_tp_stage2`` in interpret mode (run as
``tests/test_torch_tcn_tp.py`` runs it); the same model with the lo terms
dropped (one TF32 product) reads outside that bar; and a shard padded
with zero channels (no taps, no gLN-1 affine) to the next 64 gives the
model's z bit for bit, which the card test
``test_tp_stage2_wide_route_zero_channels_same_bits`` holds the kernel to.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import tcn_block_tp as jtp
from convtasnet_tpu_torch.ops.cuda import tcn_block_tp as port
from tests.test_torch_tf32_split import split

M, K, B, P = 2, 300, 64, 3   # K is no multiple of 64 or 128
SLAB = 32                    # the core's slab depth (kSlabF)
BAR = 1e-5                   # TP_ORDER_TOL in f32
ORDER = ("h", "stats1", "dw", "w_out", "a2", "g1", "b1", "g2")
# (Hs, dilation, causal): Hs 128 on dw_rows_f32, 192 one channel a thread
CASES = [(hs, d, causal) for hs in (128, 192) for d in (1, 16)
         for causal in (False, True)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(Hs: int, seed: int) -> dict:
    """Seeded f32 stage-2 operands: h as stage 1 leaves it (a PReLU
    output), gLN-1 statistics near its own, paper-init weight scales."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((M, K, Hs))
    h = np.where(h >= 0, h, 0.25 * h)
    arrs = dict(
        h=h,
        stats1=np.stack([0.3 + 0.05 * rng.standard_normal(M),
                         1.2 + 0.1 * rng.standard_normal(M)], -1),
        dw=rng.standard_normal((P, Hs)) / np.sqrt(P),
        w_out=rng.standard_normal((Hs, B)) / np.sqrt(Hs),
        a2=np.array(0.25),
        g1=1.0 + 0.1 * rng.standard_normal(Hs),
        b1=0.1 * rng.standard_normal(Hs),
        g2=1.0 + 0.1 * rng.standard_normal(Hs),
    )
    return {k: v.astype(np.float32) for k, v in arrs.items()}


def _f32(v):
    return np.asarray(v, np.float64).astype(np.float32)


def _fma(a, b, c):
    """a b + c as an f32 FMA: in float64, rounded once to f32."""
    return _f32(np.asarray(a, np.float64) * b + c)


def _depthwise(a: dict, dilation: int, causal: bool):
    """y g2 [M, K, Hs] in f32 and the gLN-2 sums [M, 2], as B6's depthwise
    stage computes them."""
    h, dw = a["h"], a["dw"]
    left = (P - 1) * dilation if causal else ((P - 1) * dilation) // 2
    mean1 = a["stats1"][:, 0][:, None, None]
    rs1 = a["stats1"][:, 1][:, None, None]
    sc = _f32(np.float64(1) * rs1 * a["g1"])
    sh = _fma(-mean1, sc, a["b1"])
    acc = np.zeros(h.shape, np.float32)
    rows = np.arange(K)
    for q in range(P):
        src = rows + q * dilation - left
        ok = ((src >= 0) & (src < K))[None, :, None]
        hv = h[:, np.clip(src, 0, K - 1)]
        acc = np.where(ok, _fma(dw[q], _fma(hv, sc, sh), acc), acc)
    y = np.where(acc >= 0, acc, _f32(np.float64(a["a2"]) * acc))
    yd = y.astype(np.float64)
    sums = _f32(np.stack([yd.sum(axis=(1, 2)), (yd * yd).sum(axis=(1, 2))],
                         -1))
    return _f32(yd * a["g2"]), sums


def _product(a, w, lo: bool = True):
    """a [R, D] @ w [D, N] in the core's 3xTF32 (``lo=False``: one TF32
    product, hi*hi), 32-deep slabs joined by f32 adds."""
    (ah, al), (wh, wl) = split(a), split(w)
    f = np.float64
    z = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], SLAB):
        s = slice(k0, k0 + SLAB)
        part = ah[:, s].astype(f) @ wh[s].astype(f)
        if lo:
            part = (al[:, s].astype(f) @ wh[s].astype(f)
                    + ah[:, s].astype(f) @ wl[s].astype(f) + part)
        z = _f32(z.astype(f) + _f32(part))
    return z


def _model(a: dict, dilation: int, causal: bool, lo: bool = True):
    """(z [M, K, B], sums [M, 2]) of B6's f32 route."""
    yg, sums = _depthwise(a, dilation, causal)
    Hs = yg.shape[-1]
    z = _product(yg.reshape(M * K, Hs), a["w_out"], lo)
    return z.reshape(M, K, B), sums


def _zero_channels(a: dict, to: int, seed: int) -> dict:
    """``a`` widened to ``to`` channels whose dw, g1 and b1 are zero (their
    h, W_out rows and g2 random): each such channel's y is 0."""
    rng = np.random.default_rng(seed)
    extra = to - a["h"].shape[-1]

    def rn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(
        a, h=np.concatenate([a["h"], rn(M, K, extra)], -1),
        dw=np.pad(a["dw"], ((0, 0), (0, extra))),
        w_out=np.concatenate([a["w_out"], rn(extra, B)], 0),
        g1=np.pad(a["g1"], (0, extra)), b1=np.pad(a["b1"], (0, extra)),
        g2=np.concatenate([a["g2"], 1.0 + rn(extra)]))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"Hs{hs}-d{d}-causal{int(c)}" for hs, d, c in CASES])
def case(request):
    """One case's inputs, the model, the port's twin at B6's rounding
    points and the interpret-mode Pallas stage 2 (under jax.jit)."""
    Hs, d, causal = request.param
    a = _inputs(Hs, seed=Hs + d + int(causal))
    twin = port.tp_stage2_reference(
        *(torch.from_numpy(a[n]) for n in ORDER), dilation=d, causal=causal,
        rounding="pallas")
    pallas = jax.jit(functools.partial(
        jtp.fused_tp_stage2, dilation=d, causal=causal, tile=128,
        interpret=True))
    return {"case": request.param, "a": a, "model": _model(a, d, causal),
            "twin": [t.numpy() for t in twin],
            "pallas": jax.device_get(pallas(*(jnp.asarray(a[n])
                                              for n in ORDER)))}


def test_model_matches_the_twin_and_the_pallas_kernel(case):
    """The model's z and gLN-2 sums within 1e-5 of the twin at B6's
    rounding points and of the Pallas kernel in interpret mode."""
    z, sums = case["model"]
    assert z.shape == (M, K, B) and np.isfinite(z).all()
    for ref in ("twin", "pallas"):
        z_ref, s_ref = case[ref]
        assert _rel(z, z_ref) <= BAR, (ref, _rel(z, z_ref))
        assert _rel(sums, s_ref) <= BAR, (ref, _rel(sums, s_ref))


@pytest.mark.parametrize("Hs", [128, 192])
def test_one_tf32_product_reads_outside_the_bar(Hs):
    """With the lo terms dropped (one TF32 product, 10 bits of each
    operand's mantissa) the model's z is outside 1e-5 of the twin, where
    the 3xTF32 model is within a tenth of it: the bar sees the split."""
    a = _inputs(Hs, seed=5)
    z_ref, _ = port.tp_stage2_reference(
        *(torch.from_numpy(a[n]) for n in ORDER), dilation=1, causal=False,
        rounding="pallas")
    z3, _ = _model(a, 1, False)
    z1, _ = _model(a, 1, False, lo=False)
    assert _rel(z3, z_ref.numpy()) <= BAR / 10, _rel(z3, z_ref.numpy())
    assert _rel(z1, z_ref.numpy()) > 10 * BAR, _rel(z1, z_ref.numpy())


@pytest.mark.parametrize("Hs,d,causal", [(128, 1, False), (192, 16, True)])
def test_zero_channels_give_the_same_z_bits(Hs, d, causal):
    """A shard padded with zero channels to the next 64 (128 -> 192 runs
    the depthwise stage one channel a thread, 192 -> 256 on dw_rows_f32)
    gives the narrow shard's z bit for bit: each zero channel's y g2 is 0
    and its slabs add exact zeros; its gLN-2 sums add 0."""
    a = _inputs(Hs, seed=Hs + d)
    z, sums = _model(a, d, causal)
    zw, sw = _model(_zero_channels(a, Hs + 64, seed=Hs), d, causal)
    assert np.abs(z).max() > 0
    assert np.array_equal(zw, z)
    assert _rel(sw, sums) <= 1e-7, _rel(sw, sums)
