"""The port's dual-path sublayers above 512 channels, on the CPU against the
JAX package, with inputs from numpy seeds.

The CUDA kernels B7-B12 and their partial modes B7p-B12p take every B:
above 512 they run routes beside their resident tiles, chosen by B alone
(``csrc/dpt_attn_bwd_wg.cuh``'s streamed LQ and F1, ``dpt_bwd_common.cuh``'s
``launch_qkv_rows`` and ``ln_bwd_wide_kernel``; the f32 inter cores stage
fewer key chunks above Bq = 512); the card holds them against the twins
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here:

- the twins at B = 576 (18 heads of 32), which JAX's model sends through
  XLA (576 % 128 != 0), against ``xla_inter_attention`` /
  ``xla_intra_attention`` / ``xla_ffn`` and ``jax.vjp`` of them, and at
  B = 640 (10 heads of 64), which it runs on its Pallas kernels, against
  those in interpret mode; full and on one head-group or hidden shard of
  two, f32 and bf16, forward and backward;
- a one-layer DPT at B = 576, the port's plain path against the JAX model
  on the same weights (``jax_params``), f32, within 5e-4;
- a plain model of ``ln_bwd_wide_kernel``'s order of summation (per row a
  lane-strided pass, then the butterfly; per column the rows of each warp
  in order, then the warps in order; the tiles in order in f64) at
  B = 1024, and at B = 1024 padded from 1000 with its statistics over the
  first Bn = 1000 columns, against the FFN backward's twin.

Bars (relative L2; dx and the attention output on the valid rows), those
of ``tests/test_torch_dpt_wide.py``: 1e-4 in f32, 4e-2 in bf16.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu.ops.pallas import dpt_ffn as jax_ffn
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.ops.cuda import dpt_ffn as port_ffn
from convtasnet_tpu_torch.ops.cuda import shapes
from convtasnet_tpu_torch.ops.norm import LN_EPS
from tests.test_torch_dpt_wide import (
    ATTN,
    _butterfly,
    _check,
    _fma,
    _jax_variables,
    _rel,
    _run,
)

LANES = 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_wider_twins_match_xla(kind, m, dtype):
    """At B = 576 the twins against JAX's XLA sublayers, the forward and
    ``jax.vjp`` of it (the primals' cotangents, x's on the valid rows),
    full and on the last shard of two (288 channels, 9 heads; F / 2)."""
    B = 576
    j, t, kw = _run(kind, B, m, dtype, seed=B + m)
    x, g, *w = t
    jx, jg, *jw = j
    if kind == "ffn":
        fn = functools.partial(jax_ffn.xla_ffn, partial=m > 1)
        primals = jw
        got = port_ffn.fused_ffn(x, *w, **kw)
        got_bwd = port_ffn.fused_ffn_bwd(x, g, *w, **kw)
    else:
        _, _, xla, fwd, bwd = ATTN[kind]
        fn = functools.partial(
            lambda f, bias, *a: f(*a, bias), functools.partial(xla, **kw),
            jw[4])
        primals = jw[:4]
        got = fwd(x, *w, **kw)
        got_bwd = bwd(x, g, *w, **kw)

    @jax.jit   # one compile of the whole function and its VJP
    def forward_and_vjp(x, g, *p):
        out, vjp = jax.vjp(fn, x, *p)
        return out, vjp(g)

    want, want_bwd = forward_and_vjp(jx, jg, *primals)
    if kind == "ffn" and m > 1:   # b_down is unused: its cotangent is 0
        want_bwd = (*want_bwd[:-1], jnp.zeros_like(jw[-1]))
    _check(kind, got, want, dtype)
    _check(kind, got_bwd, want_bwd, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_wider_twins_match_pallas_interpret(kind, m, dtype):
    """At B = 640 (10 heads of 64: the Pallas bodies' interpret mode runs
    a head at a time, and 20 heads of 32 take twice as long; the XLA case
    at 576 holds 18 heads of 32) the twins of B7-B12 (m = 1) and of
    B7p-B12p (the last shard of two: 320 channels, 5 heads) against the
    JAX package's Pallas kernels in interpret mode: the forward and every
    cotangent."""
    B = 640
    j, t, kw = _run(kind, B, m, dtype, seed=B + m)
    if kind != "ffn":
        kw["n_heads"] = B // 64 // m
    x, g, *w = t
    jx, jg, *jw = j
    if kind == "ffn":
        want = jax_ffn.fused_ffn(jx, *jw, interpret=True, **kw)
        want_bwd = jax_ffn.fused_ffn_bwd(jx, jg, *jw, interpret=True, **kw)
        got, got_bwd = port_ffn.fused_ffn(x, *w, **kw), \
            port_ffn.fused_ffn_bwd(x, g, *w, **kw)
    else:
        jfwd, jbwd, _, fwd, bwd = ATTN[kind]
        want = jfwd(jx, *jw, interpret=True, **kw)
        want_bwd = jbwd(jx, jg, *jw, interpret=True, **kw)
        got, got_bwd = fwd(x, *w, **kw), bwd(x, g, *w, **kw)
    assert got.dtype == getattr(torch, dtype)
    _check(kind, got, want, dtype)
    _check(kind, got_bwd, want_bwd, dtype)


def test_wider_dpt_model_matches_jax():
    """A one-layer DPT at B = 576 (18 heads of 32, F = 1152, 16-frame
    chunks), which the kernels take (no refusal) and JAX runs through XLA:
    the port's plain path against the JAX model on the same weights, in
    f32, within 5e-4; 199 frames, so the padded tail and its key mask are
    on the path."""
    cfg = ConvTasNetConfig(n_filters=32, kernel_size=8, bottleneck=576,
                           separator="dpt", dpt_chunk=16, dpt_layers=1,
                           dpt_ff=1152)
    assert cfg.dpt_num_heads == 18 and shapes.refusals(cfg) == {}
    variables = _jax_variables(cfg)
    model = ConvTasNet(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    mix = np.random.default_rng(2).standard_normal((2, 800)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mix)).numpy()
    jcfg = dataclasses.replace(JaxConfig(**cfg.to_dict()), use_pallas=False)
    apply = jax.jit(functools.partial(jmodel.ConvTasNet(jcfg).apply,
                                      train=False))
    want = np.asarray(apply(variables, jnp.asarray(mix)))
    assert got.shape == want.shape == (2, 2, 800)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


# ---- the order of ln_bwd_wide_kernel, as a plain model ----

def _strided_sums(terms, fma_with=None, width=None):
    """A warp's row sums as ln_bwd_wide_kernel takes them: lane l over the
    columns l, l + 32, ... below ``width`` (all of them where None) in
    order, one FMA each where ``fma_with`` gives the other factor, then
    the butterfly; terms [R, B] f32 -> [R]."""
    R, B = terms.shape
    width = B if width is None else width
    acc = np.zeros((R, LANES), np.float32)
    for c0 in range(0, width, LANES):
        cols = np.arange(c0, min(c0 + LANES, width))
        lanes = cols - c0
        t = terms[:, cols]
        acc[:, lanes] = (acc[:, lanes] + t if fma_with is None
                         else _fma(t, fma_with[:, cols], acc[:, lanes]))
    return _butterfly(acc)


def ln_bwd_wide_model(x, g, dy, gamma, Bn, residual, round_dx):
    """ln_bwd_wide_kernel's order. Phase 1, per row (one warp): the LN
    statistics over the first Bn columns (ln_row_stats: the mean, then the
    squares of x - mean, each a lane-strided sum and the butterfly), s1 =
    sum dy gamma and s2 = sum dy gamma xhat over all B columns (a padded
    column adds an exact zero), dx = g + rs (dy gamma - s1 / Bn - xhat
    s2 / Bn) (rounded by ``round_dx``). Phase 2, per 64-row tile and
    column: the rows warp w took (w, w + 8, ...) summed in order from
    zero, dy xhat by FMA, then the 8 warps' sums in order; the tiles' in
    order in f64. Returns (dx, dgamma, dbeta)."""
    R, B = x.shape
    mean = (_strided_sums(x, width=Bn) / np.float32(Bn)).astype(np.float32)
    d = (x - mean[:, None]).astype(np.float32)
    var = (_strided_sums(d, d, width=Bn) / np.float32(Bn)).astype(np.float32)
    rs = (1.0 / np.sqrt(var.astype(np.float64) + LN_EPS)).astype(np.float32)
    xh = (d * rs[:, None]).astype(np.float32)
    dxh = (dy * gamma[None]).astype(np.float32)
    mean_d = (_strided_sums(dxh) / np.float32(Bn)).astype(np.float32)
    mean_xd = (_strided_sums(dxh, xh) / np.float32(Bn)).astype(np.float32)
    inner = _fma(-xh, mean_xd[:, None], (dxh - mean_d[:, None]).astype(
        np.float32))
    dx = (_fma(rs[:, None], inner, g) if residual
          else (rs[:, None] * inner).astype(np.float32))
    dx = round_dx(dx)
    tiles = -(-R // 64)
    part = np.zeros((tiles, 2, B), np.float32)
    for tile in range(tiles):
        for w in range(8):
            cg = np.zeros(B, np.float32)
            cb = np.zeros(B, np.float32)
            for r in range(tile * 64 + w, min(R, tile * 64 + 64), 8):
                cg = _fma(dy[r], xh[r], cg)
                cb = (cb + dy[r]).astype(np.float32)
            part[tile, 0] = (part[tile, 0] + cg).astype(np.float32)
            part[tile, 1] = (part[tile, 1] + cb).astype(np.float32)
    total = part.astype(np.float64).sum(axis=0).astype(np.float32)
    return dx, total[0], total[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Bn,partial", [(1024, False), (1024, True),
                                        (1000, False)])
def test_ln_bwd_wide_order_matches_twin(dtype, Bn, partial):
    """At B = 1024 (F = 256, 136 rows: three 64-row tiles, the last one
    part full) the model of the wide LN backward (``ln_bwd_wide_model``)
    on the dy that the FFN backward's twin forms (dpre W_up^T, dpre rounded
    where the kernels round it) against the twin's (dx, dgamma, dbeta): in
    f32 within 1e-6 (the two differ in the order of their sums only), in
    bf16 dx within 1e-3 (an element's one rounding may land one bf16 step
    apart) and dgamma, dbeta within 1e-6. With ``partial`` dx has no
    residual; at Bn = 1000 the sublayer is 1000 wide, zero-padded to 1024
    as the wrappers pad it (zero columns of x, gamma, beta and the weights
    that meet them), and the statistics and both means span the first
    1000 columns."""
    B, F, R = 1024, 256, 136
    rng = np.random.default_rng(91 + partial + Bn)
    dt = getattr(torch, dtype)
    real = torch.arange(B) < Bn

    def arr(shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rng.standard_normal(shape))
                                .astype(np.float32))

    x = (arr((1, R, B)) * real).to(dt)
    g = arr((1, R, B)).to(dt)
    gamma = arr(B, 0.1, 1.0) * real
    beta = arr(B, 0.1) * real
    w_up = arr((B, F), 1 / np.sqrt(Bn)) * real[:, None]
    b_up = arr(F, 0.1)
    w_down = arr((F, B), 1 / np.sqrt(F)) * real
    b_down = arr(B, 0.1) * real
    dx, dgamma, dbeta, *_ = port_ffn.ffn_bwd_reference(
        x, g, gamma, beta, w_up, b_up, w_down, b_down, partial=partial,
        Bn=Bn)

    def rnd(t):
        return t.to(dt).float()

    # the twin's dy, by its own ops (ffn_bwd_reference)
    xf = x.float().reshape(-1, B)
    xr = xf[:, :Bn]
    mean = xr.mean(-1, keepdim=True)
    rs = torch.rsqrt((xr - mean).square().mean(-1, keepdim=True) + LN_EPS)
    y = rnd((xf - mean) * rs * gamma + beta)
    pre = rnd(rnd(y @ rnd(w_up)) + rnd(b_up))
    _, dgelu = port_ffn._gelu_and_grad(pre)
    dpre = rnd((g.float().reshape(-1, B) @ rnd(w_down).T) * dgelu)
    dy = (dpre @ rnd(w_up).T).numpy()
    assert not dy[:, Bn:].any()

    got = ln_bwd_wide_model(x.float().reshape(-1, B).numpy(),
                            g.float().reshape(-1, B).numpy(), dy,
                            gamma.numpy(), Bn, residual=not partial,
                            round_dx=lambda v: torch.from_numpy(v).to(dt)
                            .float().numpy())
    twin = (dx.float().reshape(-1, B).numpy(), dgamma.numpy(), dbeta.numpy())
    bars = (1e-6 if dtype == "float32" else 1e-3, 1e-6, 1e-6)
    for name, q, w, bar in zip(("dx", "dgamma", "dbeta"), got, twin, bars):
        assert np.isfinite(q).all(), name
        assert _rel(q[..., :Bn], w[..., :Bn]) <= bar, (
            name, _rel(q[..., :Bn], w[..., :Bn]))
