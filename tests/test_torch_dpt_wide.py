"""The port's dual-path sublayers at widths above 256, on the CPU against
the JAX package, with inputs from numpy seeds.

The CUDA kernels B7-B12 and their partial modes B7p-B12p take B = 320,
384, 448 and 512 (10 to 16 heads of 32) on their wide routes
(``csrc/dpt_attn_bwd_wg.cuh``, ``dpt_ffn.cu``, ``dpt_ffn_bwd.cu``,
``dpt_bwd_common.cuh``); the card holds them against the twins
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here:

- the twins at B = 384 and 512, which JAX's model runs on its Pallas
  kernels (B % 128 == 0), against those kernels in interpret mode, full
  and on one head-group or hidden shard of two, f32 and bf16, forward and
  backward;
- the twins at B = 320 and 448, which JAX's model sends through XLA,
  against ``xla_inter_attention`` / ``xla_intra_attention`` / ``xla_ffn``
  and ``jax.vjp`` of them, full and on one shard of five or seven (64
  channels, 2 heads);
- a one-layer DPT at B = 384 (12 heads), the port's plain path against
  the JAX model on the same weights (``jax_params``), f32, within 5e-4;
- a plain model of the order in which DN's wide route sums (above 256 the
  bf16 backwards write dy to device memory and ``ln_bwd_kernel`` finishes
  each row: per lane over its columns, then a butterfly over the lanes;
  the 64-row tiles' (dgamma, dbeta) partials by warp, then in tile order
  in double) at B = 512, against the FFN backward's twin.

Bars (relative L2; dx and the attention output on the valid rows), those
of ``tests/test_torch_dpt_ops.py`` and ``tests/test_torch_dpt_bwd.py`` for
the same comparisons: 1e-4 in f32, 4e-2 in bf16.
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
from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu.ops.pallas import dpt_ffn as jax_ffn
from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_attn
from convtasnet_tpu_torch.ops.cuda import dpt_ffn as port_ffn
from convtasnet_tpu_torch.ops.cuda import dpt_intra as port_intra
from convtasnet_tpu_torch.ops.cuda import shapes
from convtasnet_tpu_torch.ops.norm import LN_EPS

TOL = {"float32": 1e-4, "bfloat16": 4e-2}
M, N_CHUNKS, S = 1, 2, 16
VALID = np.arange(N_CHUNKS * S).reshape(N_CHUNKS, S) < N_CHUNKS * S - 11
FFN_ROWS = 16
# the shard of each width: the least m > 1 whose shard is a multiple of 64
SHARDS = {320: 5, 384: 2, 448: 7, 512: 2}
ATTN = {"inter": (jax_inter.fused_inter_attention,
                  jax_inter.fused_inter_attention_bwd,
                  jax_inter.xla_inter_attention,
                  port_attn.fused_inter_attention,
                  port_attn.fused_inter_attention_bwd),
        "intra": (jax_intra.fused_intra_attention,
                  jax_intra.fused_intra_attention_bwd,
                  jax_intra.xla_intra_attention,
                  port_intra.fused_intra_attention,
                  port_intra.fused_intra_attention_bwd)}


def _rel(got, want):
    g = np.asarray(got, np.float32).ravel()
    w = np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


def _operands(kind, B, m, seed):
    """Numpy operands of one sublayer at width B (B / 32 heads; F = 2B),
    a cotangent zero on the padded rows, and with m > 1 the weights of the
    last shard of m, as parallel/dpt_tp.py cuts them; -> (arrays in the
    wrappers' order, the local head count)."""
    rng = np.random.default_rng(seed)
    heads = B // 32
    if kind == "ffn":
        F = 2 * B
        arrs = [rng.standard_normal((M, FFN_ROWS, B)),
                rng.standard_normal((M, FFN_ROWS, B)),
                1 + 0.1 * rng.standard_normal(B), 0.1 * rng.standard_normal(B),
                rng.standard_normal((B, F)) / np.sqrt(B),
                0.1 * rng.standard_normal(F),
                rng.standard_normal((F, B)) / np.sqrt(F),
                0.1 * rng.standard_normal(B)]
        if m > 1:
            cut = slice(F - F // m, F)
            arrs[4], arrs[5], arrs[6] = arrs[4][:, cut], arrs[5][cut], \
                arrs[6][cut]
        return [a.astype(np.float32) for a in arrs], None
    g = rng.standard_normal((M, N_CHUNKS, S, B)) * VALID[None, :, :, None]
    w_qkv = rng.standard_normal((B, 3 * B)) / np.sqrt(B)
    w_out = rng.standard_normal((B, B)) / np.sqrt(B)
    if m > 1:
        bq = B // m
        w_qkv = np.concatenate([w_qkv[:, i * B + B - bq:(i + 1) * B]
                                for i in range(3)], axis=1)
        w_out = w_out[B - bq:]
        heads //= m
    arrs = [rng.standard_normal((M, N_CHUNKS, S, B)), g,
            1 + 0.1 * rng.standard_normal(B), 0.1 * rng.standard_normal(B),
            w_qkv, w_out, np.where(VALID, 0.0, -1e9)]
    return [a.astype(np.float32) for a in arrs], heads


def _both(arrs, dtype):
    """The arrays for JAX and for torch: x and g in ``dtype``, the rest
    f32, as the model keeps its parameters."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    j = [jnp.asarray(a, jdt if i < 2 else jnp.float32)
         for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(getattr(torch, dtype) if i < 2
                                else torch.float32)
         for i, a in enumerate(arrs)]
    return j, t


def _check(kind, got, want, dtype):
    """Every output by relative L2 within TOL; an attention output or dx
    on the valid rows; a zero (db_down of a partial backward) exactly."""
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want)
    for i, (q, w) in enumerate(zip(got, want)):
        q = q.float().numpy()
        w = np.asarray(w, np.float32)
        assert q.shape == w.shape, i
        if i == 0 and kind != "ffn":
            q, w = q[:, VALID], w[:, VALID]
        assert np.isfinite(q).all(), i
        if not w.any():
            assert not q.any(), i
            continue
        assert _rel(q, w) <= TOL[dtype], (i, _rel(q, w))


def _run(kind, B, m, dtype, seed):
    """(JAX operands, torch operands, wrapper kwargs, JAX kwargs)."""
    arrs, heads = _operands(kind, B, m, seed)
    j, t = _both(arrs, dtype)
    kw = dict(partial=m > 1)
    if kind != "ffn":
        kw["n_heads"] = heads
    return j, t, kw


CASES = [(kind, B, m, dtype) for kind in ("inter", "intra", "ffn")
         for B in (384, 512) for m in (1, SHARDS[B])
         for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("kind,B,m,dtype", CASES)
def test_wide_twins_match_pallas_interpret(kind, B, m, dtype):
    """At B = 384 and 512 the twins of B7-B12 (m = 1) and of B7p-B12p (the
    last shard of two) against the JAX package's Pallas kernels in
    interpret mode: the forward and every cotangent."""
    j, t, kw = _run(kind, B, m, dtype, seed=B + m)
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


XLA_CASES = [(kind, B, m, dtype) for kind in ("inter", "intra", "ffn")
             for B in (320, 448) for m in (1, SHARDS[B])
             for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("kind,B,m,dtype", XLA_CASES)
def test_wide_twins_match_xla(kind, B, m, dtype):
    """At B = 320 and 448 the twins against JAX's XLA sublayers, the
    forward and ``jax.vjp`` of it (the primals' cotangents, x's on the
    valid rows), full and on one shard of 64 channels."""
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
        fn = functools.partial(xla, **kw)
        primals = jw[:4]
        got = fwd(x, *w, **kw)
        got_bwd = bwd(x, g, *w, **kw)[:5]
        fn = functools.partial(lambda f, bias, *a: f(*a, bias), fn, jw[4])
    @jax.jit   # one compile of the whole function and its VJP
    def forward_and_vjp(x, g, *p):
        out, vjp = jax.vjp(fn, x, *p)
        return out, vjp(g)

    want, want_bwd = forward_and_vjp(jx, jg, *primals)
    if kind == "ffn" and m > 1:   # b_down is unused: its cotangent is 0
        want_bwd = (*want_bwd[:-1], jnp.zeros_like(jw[-1]))
    _check(kind, got, want, dtype)
    _check(kind, got_bwd, want_bwd, dtype)


def _jax_variables(cfg, seed=0):
    """The JAX model's variables tree filled with seeded numpy weights,
    every LN affine and bias moved off its init."""
    tree = jax.eval_shape(
        lambda k: jmodel.init_params(JaxConfig(**cfg.to_dict()), k,
                                     example_len=400),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        r = rng.standard_normal(s.shape).astype(np.float32)
        if name == "gamma":
            return (1.0 + 0.1 * r).astype(np.float32)
        if name in ("beta", "bias"):
            return 0.1 * r
        return r / np.float32(np.sqrt(s.shape[0]))

    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_wide_dpt_model_matches_jax():
    """A one-layer DPT at B = 384 (12 heads of 32, F = 768, 16-frame
    chunks), which the kernels take (no refusal): the port's plain path
    against the JAX model (XLA) on the same weights, in f32, within
    5e-4; 199 frames, so the padded tail and its key mask are on the
    path."""
    cfg = ConvTasNetConfig(n_filters=32, kernel_size=8, bottleneck=384,
                           separator="dpt", dpt_chunk=16, dpt_layers=1,
                           dpt_ff=768)
    assert cfg.dpt_num_heads == 12 and shapes.refusals(cfg) == {}
    variables = _jax_variables(cfg)
    model = ConvTasNet(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    mix = np.random.default_rng(1).standard_normal((2, 800)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(mix)).numpy()
    jcfg = dataclasses.replace(JaxConfig(**cfg.to_dict()), use_pallas=False)
    apply = jax.jit(functools.partial(jmodel.ConvTasNet(jcfg).apply,
                                      train=False))
    want = np.asarray(apply(variables, jnp.asarray(mix)))
    assert got.shape == want.shape == (2, 2, 800)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


# ---- the order of DN's wide route (ln_bwd_kernel), as a plain model ----

LANES = 32


def _fma(a, b, c):
    """f32 fmaf: the product and the add in f64, rounded once."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _butterfly(v):
    """warp_sum: v += shfl_xor(v, o) for o = 16, 8, 4, 2, 1 over the last
    axis (the 32 lanes), in f32; every lane ends with the same sum."""
    lane = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lane ^ o]).astype(np.float32)
    return v[..., 0]


def _lane_sums(terms, fma_with=None):
    """Each lane's sum over its columns l, l + 32, ... in order (one FMA
    each where ``fma_with`` gives the other factor), then the butterfly;
    terms [R, B] f32 -> [R]."""
    R, B = terms.shape
    t = terms.reshape(R, B // LANES, LANES)
    f = None if fma_with is None else fma_with.reshape(R, B // LANES, LANES)
    acc = np.zeros((R, LANES), np.float32)
    for i in range(B // LANES):
        acc = (acc + t[:, i] if f is None
               else _fma(t[:, i], f[:, i], acc)).astype(np.float32)
    return _butterfly(acc)


def ln_bwd_model(x, g, dy, gamma, residual, round_dx):
    """DN's wide route after the product: ln_bwd_kernel's order. Per row
    (one warp): the LN statistics (ln_row_stats), s1 = sum dy gamma and
    s2 = sum dy gamma xhat over the lanes' columns then the butterfly, dx
    = g + rs (dy gamma - s1 / B - xhat s2 / B) (rounded by ``round_dx``);
    per 64-row tile each warp's column sums of dy xhat and dy over its 8
    rows in order, the 8 warps' added in warp order; the tiles' added in
    order in f64. Returns (dx, dgamma, dbeta)."""
    R, B = x.shape
    mean = (_lane_sums(x) / np.float32(B)).astype(np.float32)
    d = (x - mean[:, None]).astype(np.float32)
    var = (_lane_sums(d, d) / np.float32(B)).astype(np.float32)
    rs = (1.0 / np.sqrt(var.astype(np.float64) + LN_EPS)).astype(np.float32)
    xh = (d * rs[:, None]).astype(np.float32)
    dxh = (dy * gamma[None]).astype(np.float32)
    mean_d = (_lane_sums(dxh) / np.float32(B)).astype(np.float32)
    mean_xd = (_lane_sums(dxh, xh) / np.float32(B)).astype(np.float32)
    inner = _fma(-xh, mean_xd[:, None], (dxh - mean_d[:, None]).astype(
        np.float32))
    dx = (_fma(rs[:, None], inner, g) if residual
          else (rs[:, None] * inner).astype(np.float32))
    dx = round_dx(dx)
    tiles = -(-R // 64)
    part = np.zeros((tiles, 2, B), np.float32)
    for tile in range(tiles):
        warps = np.zeros((8, 2, B), np.float32)
        for w in range(8):
            for r in range(tile * 64 + w, min(R, tile * 64 + 64), 8):
                warps[w, 0] = _fma(dy[r], xh[r], warps[w, 0])
                warps[w, 1] = (warps[w, 1] + dy[r]).astype(np.float32)
        for w in range(8):
            part[tile] = (part[tile] + warps[w]).astype(np.float32)
    total = part.astype(np.float64).sum(axis=0).astype(np.float32)
    return dx, total[0], total[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("partial", [False, True])
def test_dn_wide_route_order_matches_twin(dtype, partial):
    """At B = 512 (F = 1024, 200 rows: four 64-row tiles, the last one
    half full) the model of DN's wide route (``ln_bwd_model``) on the dy
    that the FFN backward's twin forms (dpre W_up^T, dpre rounded where
    the kernels round it) against the twin's (dx, dgamma, dbeta): in f32
    within 1e-6 (the two differ in the order of their sums only), in bf16
    dx within 1e-3 (an element's one rounding may land one bf16 step
    apart) and dgamma, dbeta within 1e-6; with ``partial`` (the backward
    of a hidden shard's forward) dx has no residual."""
    B, F, R = 512, 1024, 200
    rng = np.random.default_rng(71 + partial)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((1, R, B)).astype(
        np.float32)).to(dt)
    g = torch.from_numpy(rng.standard_normal((1, R, B)).astype(
        np.float32)).to(dt)
    gamma, beta = (torch.from_numpy((c + 0.1 * rng.standard_normal(B))
                                    .astype(np.float32)) for c in (1, 0))
    w_up = torch.from_numpy((rng.standard_normal((B, F)) / np.sqrt(B))
                            .astype(np.float32))
    b_up = torch.from_numpy(0.1 * rng.standard_normal(F).astype(np.float32))
    w_down = torch.from_numpy((rng.standard_normal((F, B)) / np.sqrt(F))
                              .astype(np.float32))
    b_down = torch.from_numpy(0.1 * rng.standard_normal(B).astype(
        np.float32))
    dx, dgamma, dbeta, *_ = port_ffn.ffn_bwd_reference(
        x, g, gamma, beta, w_up, b_up, w_down, b_down, partial=partial)

    def rnd(t):
        return t.to(dt).float()

    # the twin's dy, by its own ops (ffn_bwd_reference)
    xf = x.float().reshape(-1, B)
    mean = xf.mean(-1, keepdim=True)
    rs = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + LN_EPS)
    y = rnd((xf - mean) * rs * gamma + beta)
    pre = rnd(rnd(y @ rnd(w_up)) + rnd(b_up))
    _, dgelu = port_ffn._gelu_and_grad(pre)
    dpre = rnd((g.float().reshape(-1, B) @ rnd(w_down).T) * dgelu)
    dy = (dpre @ rnd(w_up).T).numpy()

    got = ln_bwd_model(x.float().reshape(-1, B).numpy(),
                       g.float().reshape(-1, B).numpy(), dy, gamma.numpy(),
                       residual=not partial,
                       round_dx=lambda v: torch.from_numpy(v).to(dt)
                       .float().numpy())
    twin = (dx.float().reshape(-1, B).numpy(), dgamma.numpy(), dbeta.numpy())
    bars = (1e-6 if dtype == "float32" else 1e-3, 1e-6, 1e-6)
    for name, q, w, bar in zip(("dx", "dgamma", "dbeta"), got, twin, bars):
        assert np.isfinite(q).all(), name
        assert _rel(q, w) <= bar, (name, _rel(q, w))


def test_dn_model_sums_by_lane_then_butterfly():
    """The model's row sums are the kernel's order and not a plain one:
    at B = 512 (16 columns a lane) they differ from a sequential f32 sum
    over the row in some rows' last bits, and equal the f64 sum within
    f32 rounding."""
    rng = np.random.default_rng(5)
    terms = rng.standard_normal((64, 512)).astype(np.float32)
    by_lane = _lane_sums(terms)
    seq = np.zeros(64, np.float32)
    for c in range(512):
        seq = (seq + terms[:, c]).astype(np.float32)
    exact = terms.astype(np.float64).sum(axis=1)
    assert (by_lane != seq).any()
    np.testing.assert_allclose(by_lane, exact, rtol=0, atol=1e-4)
