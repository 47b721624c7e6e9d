"""The schedules of the bf16 DPT forward kernels B11 (the FFN sublayer,
``csrc/dpt_ffn.cu``'s ``ffn_wg_kernel``), B9 and B7 (the intra- and
inter-chunk attention sublayers, ``csrc/dpt_attn_bwd_wg.cuh``'s forward
frame and core with either row gather), and of their partial modes, as
plain PyTorch models, against the port's twins (``ffn_reference``,
``attention_reference``, and the forward at the kernels' rounding points
``attention_rounded_reference``) and the JAX package's Pallas kernels
(``_ffn_kernel``, ``_intra_kernel``, ``_inter_kernel``) in interpret mode,
on the CPU, with inputs from a numpy seed.

The FFN model walks the hidden width in slabs of 64 columns (F zero-padded
to a multiple of 128, as the wrapper pads it): pre = round(round(y W_up) +
round(b_up)) and h = round(gelu(pre)) per slab, with tanh through the
exponential as the kernel computes it, and the down product summed in f32
across the slabs, rounded once in the epilogue. The attention model
gathers each problem's rows from qkv [R, 3Bq] as the core's ``Gather``
does (intra: the S rows of chunk c, contiguous, the key bias [c, key];
inter: the row of each of the n chunks at position s, S rows apart, the
key bias [key chunk, s]), takes per (problem, head) the queries in tiles
of 16 and walks the keys in tiles of 16 of staged blocks of up to 256
keys, the keys past the problem's length in its last tile masked with a
bias of -inf: pass 1 the row max and denominator online, pass 2 p =
exp(s - max) / den and a = round(sum round(p) v) in f32. Head widths 16
to 128 (B = 128 with 8 heads and with 1) run as the bf16 core takes them.
The card holds the kernels themselves against the twins
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Bars, by relative L2 over the valid rows: f32 within 1e-5 of the f32 twin
and of JAX's f32 kernel (summation order only); bf16 within 4e-2 of the
bf16 twin and of JAX's bf16 kernel, and within 1e-3 of the forward that
rounds where the kernels round. Faults planted in the models are seen:
the stats of the next query row in pass 2, b_up added unrounded, and on
the inter gather the intra key bias indexing, the keys past n unmasked
and round(p) skipped.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu.ops.pallas import dpt_ffn as jax_ffn
from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_attn
from convtasnet_tpu_torch.ops.cuda import dpt_ffn as port_ffn
from convtasnet_tpu_torch.ops.norm import LN_EPS

TILE = 16        # the core's query and key tiles
BLOCK = 256      # keys staged at once, at most
SLAB = 64        # the FFN's hidden columns per slab
B = 64           # small, so that interpret mode stays fast
TOL = {"float32": 1e-5, "bfloat16": 4e-2}
ROUNDED_TOL = 1e-3   # bf16 against the forward at the kernels' rounding points


def _rel(got, want):
    g = np.asarray(got, np.float32).ravel()
    w = np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


def _ln(x, gamma, beta, rnd):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rs = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + LN_EPS)
    return rnd((xf - mean) * rs * gamma + beta)


def gelu_exp(v):
    """tanh-GELU with tanh(u) = 1 - 2 / (exp(2u) + 1), as the bf16 kernels
    compute it."""
    u = math.sqrt(2.0 / math.pi) * (v + 0.044715 * v * v * v)
    return v * (0.5 * (1.0 + (1.0 - 2.0 / (torch.exp(2.0 * u) + 1.0))))


def ffn_schedule(x, gamma, beta, w_up, b_up, w_down, b_down, *,
                 partial=False, fault=None):
    """B11's output as its schedule computes it (the top note); ``fault``
    "b_up_unrounded" adds b_up in f32."""
    dt = x.dtype

    def rnd(t):
        return t.to(dt).float()

    w_up, b_up, w_down = port_ffn.pad_hidden(w_up, b_up, w_down)
    y = _ln(x, gamma, beta, rnd)
    wu, wd = rnd(w_up.float()), rnd(w_down.float())
    out = torch.zeros(x.shape, dtype=torch.float32)
    for f0 in range(0, wu.shape[1], SLAB):
        s = slice(f0, f0 + SLAB)
        bu = b_up[s].float() if fault == "b_up_unrounded" else rnd(b_up[s])
        pre = rnd(rnd(y @ wu[:, s]) + bu)
        out = out + rnd(gelu_exp(pre)) @ wd[s]
    if partial:
        return out.to(dt)
    return rnd(x.float() + rnd(rnd(out) + rnd(b_down.float()))).to(dt)


def core_schedule(q, k, v, bias, scale, rnd, fault=None):
    """a [P, L, d] of P problems as the forward core computes it: q, k, v
    [P, L, d] in f32 (values of the compute dtype), bias [P, L] the key
    bias, ``rnd`` the rounding to the compute dtype; ``fault``
    "stats_of_next_row" takes each query row's max and denominator from
    the next row in pass 2, "keys_unmasked" gives the keys past L a bias
    of 0, "p_unrounded" mixes v with p unrounded."""
    L = q.shape[1]
    Lp = -(-L // TILE) * TILE
    T = min(Lp, BLOCK)

    def pad(t):
        return torch.nn.functional.pad(t, (0, 0, 0, Lp - L))

    q, k, v = map(pad, (q, k, v))
    kb = torch.nn.functional.pad(
        bias, (0, Lp - L),
        value=0.0 if fault == "keys_unmasked" else -math.inf)
    tiles = [slice(j, min(j + TILE, b0 + T))
             for b0 in range(0, Lp, T)
             for j in range(b0, min(b0 + T, Lp), TILE)]

    def logits(j):   # the queries against key tile j
        return q @ k[:, j].transpose(1, 2) * scale + kb[:, None, j]

    # pass 1: the row max and denominator, online over the key tiles
    mx = torch.full(q.shape[:2] + (1,), -math.inf)
    den = torch.zeros_like(mx)
    for j in tiles:
        s = logits(j)
        mn = torch.maximum(mx, s.amax(-1, keepdim=True))
        den = den * torch.exp(mx - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        mx = mn
    if fault == "stats_of_next_row":
        mx, den = mx.roll(-1, dims=1), den.roll(-1, dims=1)
    inv = 1.0 / den
    # pass 2: a = round(sum round(p) v) in f32
    a = torch.zeros_like(q)
    for j in tiles:
        p = torch.exp(logits(j) - mx) * inv
        a = a + (p if fault == "p_unrounded" else rnd(p)) @ v[:, j]
    return rnd(a[:, :L])


def gather(kind, M, n, S, fault=None):
    """The core's ``Gather`` for every problem of its grid (blockIdx.x,
    blockIdx.y = m): the global rows [M, X, L] of each problem's positions
    0 .. L - 1 and their keys' indices into the flat key bias [n * S].
    Intra: X = n chunks of L = S contiguous rows, the bias [chunk, key];
    inter: X = S positions, L = n rows S apart, the bias [key chunk,
    position]. ``fault`` "intra_bias_on_inter" indexes the inter bias as
    the intra gather does ([blockIdx.x, key])."""
    m = torch.arange(M)[:, None, None]
    if kind == "intra":
        c, i = torch.arange(n)[None, :, None], torch.arange(S)[None, None, :]
        return (m * n + c) * S + i, (c * S + i).expand(M, n, S)
    s, i = torch.arange(S)[None, :, None], torch.arange(n)[None, None, :]
    bias_idx = s * S + i if fault == "intra_bias_on_inter" else i * S + s
    return (m * n + i) * S + s, bias_idx.expand(M, S, n)


def attention_schedule(x, gamma, beta, w_qkv, w_out, key_bias, *, n_heads,
                       kind, partial=False, fault=None):
    """B9's (``kind`` "intra") or B7's ("inter") output as the three
    launches compute it: qkv = round(LN(x) W_qkv) [R, 3Bq], the core of
    ``core_schedule`` per (problem, head) on the rows of ``gather``, a
    [R, Bq] stored back at the same rows, and x + round(a W_out) (partial:
    round(a W_out))."""
    dt = x.dtype
    M, n, S, Bx = x.shape
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    d = Bq // h

    def rnd(t):
        return t.to(dt).float()

    y = _ln(x, gamma, beta, rnd)
    qkv = rnd(y @ rnd(w_qkv.float())).reshape(-1, 3 * Bq)
    rows, bias_idx = gather(kind, M, n, S, fault)
    L = rows.shape[-1]
    flat_bias = key_bias.float().reshape(-1)
    # an index past the bias reads what lies beyond it: zeros here
    flat_bias = torch.nn.functional.pad(flat_bias, (0, S * S))
    bias = flat_bias[bias_idx]                              # [M, X, L]
    g = qkv[rows.reshape(-1)].reshape(*rows.shape, 3, h, d)

    def heads(t):   # [M, X, L, h, d] -> [M X h, L, d]
        return t.permute(0, 1, 3, 2, 4).reshape(-1, L, d)

    q, k, v = (heads(g[..., i, :, :]) for i in range(3))
    bias = bias[:, :, None, :].expand(-1, -1, h, -1).reshape(-1, L)
    a = core_schedule(q, k, v, bias, 1.0 / math.sqrt(d), rnd,
                      None if fault == "intra_bias_on_inter" else fault)
    a_rows = torch.zeros(M * n * S, Bq)
    a_rows[rows.reshape(-1)] = a.reshape(*rows.shape[:2], h, L, d).permute(
        0, 1, 3, 2, 4).reshape(-1, Bq)
    proj = rnd(a_rows.reshape(M, n, S, Bq) @ rnd(w_out.float()))
    return (proj if partial else rnd(x.float() + proj)).to(dt)


def _shard_ffn(w_up, b_up, w_down, m):
    """The last hidden slice of m, as ``parallel/dpt_tp.py`` cuts it."""
    f = w_up.shape[1] // m
    return w_up[:, -f:], b_up[-f:], w_down[-f:]


def _shard_attn(w_qkv, w_out, m):
    """The last head group of m: its q, k and v columns and W_out's rows."""
    bq = B // m
    cols = np.concatenate([np.arange((i + 1) * B - bq, (i + 1) * B)
                           for i in range(3)])
    return w_qkv[:, cols], w_out[-bq:]


def _ffn_case(F, m, seed):
    rng = np.random.default_rng(seed)
    M, K = 2, 37
    arrs = dict(x=rng.standard_normal((M, K, B)),
                gamma=1 + 0.2 * rng.standard_normal(B),
                beta=0.3 * rng.standard_normal(B),
                w_up=rng.standard_normal((B, F)) / np.sqrt(B),
                b_up=0.5 * rng.standard_normal(F),
                w_down=rng.standard_normal((F, B)) / np.sqrt(F),
                b_down=0.5 * rng.standard_normal(B))
    if m > 1:
        arrs["w_up"], arrs["b_up"], arrs["w_down"] = _shard_ffn(
            arrs["w_up"], arrs["b_up"], arrs["w_down"], m)
    return {k_: v_.astype(np.float32) for k_, v_ in arrs.items()}


FFN_NAMES = ("x", "gamma", "beta", "w_up", "b_up", "w_down", "b_down")
# (F, shards m): a padded hidden width and a partial shard
FFN_CASES = [(1000, 1), (256, 2)]


def _to(arrs, names, dtype, lib):
    if lib == "torch":
        return [torch.from_numpy(arrs[k]).to(dtype if k == "x" else
                                             torch.float32) for k in names]
    return [jnp.asarray(arrs[k], dtype if k == "x" else jnp.float32)
            for k in names]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("F,m", FFN_CASES, ids=["F1000", "F256-partial"])
def test_ffn_schedule_matches_twin_and_pallas(F, m, dtype):
    arrs = _ffn_case(F, m, seed=F + m)
    t = _to(arrs, FFN_NAMES, getattr(torch, dtype), "torch")
    kw = dict(partial=m > 1)
    got = ffn_schedule(*t, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == t[0].shape
    assert _rel(got.float(), port_ffn.ffn_reference(*t, **kw).float()) <= \
        TOL[dtype]
    j = _to(arrs, FFN_NAMES, getattr(jnp, dtype), "jax")
    want = jax_ffn.fused_ffn(*j, interpret=True, **kw)
    assert _rel(got.float(), np.asarray(want, np.float32)) <= TOL[dtype]
    if dtype == "bfloat16":   # its bf16 twin rounds where the kernel does
        assert _rel(got.float(), port_ffn.ffn_reference(*t, **kw).float()
                    ) <= ROUNDED_TOL


def _intra_case(S, m, seed):
    """numpy operands of one intra sublayer at B = 64 (two heads of 32, or
    the last one of m = 2): x [1, 2, S, B], the key bias of a masked tail
    of 3 frames in the last chunk and of real frames off 0."""
    rng = np.random.default_rng(seed)
    n = 2
    valid = np.arange(n * S).reshape(n, S) < n * S - 3
    arrs = dict(x=rng.standard_normal((1, n, S, B)),
                gamma=1 + 0.2 * rng.standard_normal(B),
                beta=0.3 * rng.standard_normal(B),
                w_qkv=rng.standard_normal((B, 3 * B)) / np.sqrt(B),
                w_out=rng.standard_normal((B, B)) / np.sqrt(B),
                bias=np.where(valid, rng.uniform(-1, 1, (n, S)), -1e9))
    h = 2
    if m > 1:
        arrs["w_qkv"], arrs["w_out"] = _shard_attn(arrs["w_qkv"],
                                                   arrs["w_out"], m)
        h //= m
    return {k_: v_.astype(np.float32) for k_, v_ in arrs.items()}, h, valid


ATTN_NAMES = ("x", "gamma", "beta", "w_qkv", "w_out", "bias")
# (S, shards m): a chunk on the tile, one whose last key tile holds 4
# frames and 12 masked keys, one of two staged key blocks (256 + 64), a
# partial shard
INTRA_CASES = [(128, 1), (100, 1), (320, 1), (48, 2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,m", INTRA_CASES,
                         ids=["S128", "S100-padded", "S320", "S48-partial"])
def test_intra_schedule_matches_twin_and_pallas(S, m, dtype):
    arrs, h, valid = _intra_case(S, m, seed=S + m)
    t = _to(arrs, ATTN_NAMES, getattr(torch, dtype), "torch")
    kw = dict(n_heads=h, partial=m > 1)
    got = attention_schedule(*t, kind="intra", **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == t[0].shape
    rows = got.float()[:, valid]
    twin = port_attn.attention_reference(*t, attend_axis=2, **kw)
    assert _rel(rows, twin.float()[:, valid]) <= TOL[dtype]
    j = _to(arrs, ATTN_NAMES, getattr(jnp, dtype), "jax")
    want = np.asarray(jax_intra.fused_intra_attention(*j, interpret=True,
                                                      **kw), np.float32)
    assert _rel(rows, want[:, valid]) <= TOL[dtype]
    if dtype == "bfloat16":
        rounded = port_attn.attention_rounded_reference(*t, attend_axis=2,
                                                        **kw)
        assert _rel(rows, rounded.float()[:, valid]) <= ROUNDED_TOL


def _attn_case(kind, n, S, Bw, heads, m, seed):
    """numpy operands of one attention sublayer at width Bw with ``heads``
    heads (the last head group of m with m > 1): x [1, n, S, Bw], the
    last 3 frames masked (at n = 1 every key of those positions), the key
    bias of the real frames drawn from [-1, 1]. -> (arrs, local heads,
    valid [n, S])."""
    rng = np.random.default_rng(seed)
    valid = np.arange(n * S).reshape(n, S) < n * S - 3
    arrs = dict(x=rng.standard_normal((1, n, S, Bw)),
                gamma=1 + 0.2 * rng.standard_normal(Bw),
                beta=0.3 * rng.standard_normal(Bw),
                w_qkv=rng.standard_normal((Bw, 3 * Bw)) / np.sqrt(Bw),
                w_out=rng.standard_normal((Bw, Bw)) / np.sqrt(Bw),
                bias=np.where(valid, rng.uniform(-1, 1, (n, S)), -1e9))
    if m > 1:
        bq = Bw // m
        cols = np.concatenate([np.arange((i + 1) * Bw - bq, (i + 1) * Bw)
                               for i in range(3)])
        arrs["w_qkv"], arrs["w_out"] = arrs["w_qkv"][:, cols], \
            arrs["w_out"][-bq:]
        heads //= m
    return {k_: v_.astype(np.float32) for k_, v_ in arrs.items()}, heads, \
        valid


def _check_attention(kind, arrs, h, valid, m, dtype):
    """The schedule against the twin, JAX's Pallas kernel of ``kind`` in
    interpret mode and, in bf16, the forward at the rounding points."""
    axis = 2 if kind == "intra" else 1
    t = _to(arrs, ATTN_NAMES, getattr(torch, dtype), "torch")
    kw = dict(n_heads=h, partial=m > 1)
    got = attention_schedule(*t, kind=kind, **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == t[0].shape
    rows = got.float()[:, valid]
    twin = port_attn.attention_reference(*t, attend_axis=axis, **kw)
    assert _rel(rows, twin.float()[:, valid]) <= TOL[dtype]
    j = _to(arrs, ATTN_NAMES, getattr(jnp, dtype), "jax")
    fused = (jax_intra.fused_intra_attention if kind == "intra"
             else jax_inter.fused_inter_attention)
    want = np.asarray(fused(*j, interpret=True, **kw), np.float32)
    assert _rel(rows, want[:, valid]) <= TOL[dtype]
    if dtype == "bfloat16":
        rounded = port_attn.attention_rounded_reference(*t, attend_axis=axis,
                                                        **kw)
        assert _rel(rows, rounded.float()[:, valid]) <= ROUNDED_TOL


INTER_S = 8      # positions per chunk: each is one inter problem per head


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 3, 25])
def test_inter_schedule_matches_twin_and_pallas(n, m, dtype):
    """B7 (m = 1) and B7p (the last head group of m = 2, 4) at B = 128, 4
    heads of 32: one chunk (p = 1 at every position, its last 3 masked
    too), 3 chunks (13 masked keys in the 16-key tile) and 25 (a second
    key tile of 9), a padded tail and the key bias off 0."""
    arrs, h, valid = _attn_case("inter", n, INTER_S, 128, 4, m,
                                seed=100 + 10 * n + m)
    _check_attention("inter", arrs, h, valid, m, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [8, 1], ids=["d16", "d128"])
@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_schedule_at_head_widths_16_and_128(kind, heads, dtype):
    """Both gathers at the head widths the bf16 core takes beyond 32 and
    64: B = 128 with 8 heads (d = 16, one 16-deep fragment step) and with
    1 (d = 128), against JAX's kernels at the same heads."""
    n, S = (25, INTER_S) if kind == "inter" else (2, 48)
    arrs, h, valid = _attn_case(kind, n, S, 128, heads, 1,
                                seed=200 + heads)
    _check_attention(kind, arrs, h, valid, 1, dtype)


def test_rounded_reference_is_the_twin_in_f32():
    """In f32 the forward at the kernels' rounding points rounds nothing:
    it is the twin, up to summation order."""
    arrs, h, valid = _intra_case(32, 1, seed=4)
    t = _to(arrs, ATTN_NAMES, torch.float32, "torch")
    for partial in (False, True):
        got = port_attn.attention_rounded_reference(
            *t, n_heads=h, attend_axis=2, partial=partial)
        want = port_attn.attention_reference(*t, n_heads=h, attend_axis=2,
                                             partial=partial)
        assert _rel(got, want) <= 1e-6


def test_planted_faults_are_seen():
    """The checks above see a fault planted in either model: pass 2 with
    the stats of the next query row (f32, against the twin), and b_up
    added unrounded (bf16 partial, against the forward at the rounding
    points, where the residual does not hide it)."""
    arrs, h, valid = _intra_case(128, 1, seed=7)
    t = _to(arrs, ATTN_NAMES, torch.float32, "torch")
    got = attention_schedule(*t, n_heads=h, kind="intra",
                             fault="stats_of_next_row")
    twin = port_attn.attention_reference(*t, n_heads=h, attend_axis=2)
    assert _rel(got[:, valid], twin[:, valid]) > TOL["float32"]
    arrs = _ffn_case(256, 2, seed=8)
    t = _to(arrs, FFN_NAMES, torch.bfloat16, "torch")
    got = ffn_schedule(*t, partial=True, fault="b_up_unrounded")
    want = port_ffn.ffn_reference(*t, partial=True)
    assert _rel(got.float(), want.float()) > ROUNDED_TOL


@pytest.mark.parametrize("fault", ["intra_bias_on_inter", "keys_unmasked",
                                   "p_unrounded"])
def test_planted_inter_faults_are_seen(fault):
    """Faults planted in the inter schedule fail the checks that hold the
    inter tests above, and the model without them passes: the intra key
    bias indexing ([position, key] for [key chunk, position]) and keys
    past n unmasked (f32, against the twin), round(p) skipped (bf16
    partial on one shard of 2, against the forward at the rounding
    points)."""
    dtype = "bfloat16" if fault == "p_unrounded" else "float32"
    m = 2 if fault == "p_unrounded" else 1
    arrs, h, valid = _attn_case("inter", 25, INTER_S, 128, 4, m, seed=9)
    t = _to(arrs, ATTN_NAMES, getattr(torch, dtype), "torch")
    kw = dict(n_heads=h, partial=m > 1)
    if fault == "p_unrounded":
        want, bar = port_attn.attention_rounded_reference(
            *t, attend_axis=1, **kw), ROUNDED_TOL
    else:
        want, bar = port_attn.attention_reference(
            *t, attend_axis=1, **kw), TOL[dtype]
    errs = [_rel(attention_schedule(*t, kind="inter", fault=f, **kw)
                 .float()[:, valid], want.float()[:, valid])
            for f in (None, fault)]
    assert errs[0] <= bar < errs[1], errs
