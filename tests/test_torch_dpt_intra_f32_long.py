"""The order of summation of the f32 intra-chunk attention core for chunks
above 256 frames (``csrc/dpt_intra_rowstat.cuh``: kernel B9's forward
core, ``rs_core_kernel<D, false>``, and B10's backward core,
``rs_core_kernel<D, true>``, and their partial modes) as a plain PyTorch
model, against the port's twins ``attention_reference`` /
``attention_bwd_reference`` and the JAX package's Pallas intra kernels in
interpret mode, on the CPU, with inputs from a numpy seed.

Per (m, chunk, head) the core runs the S rows of the chunk (S padded to a
multiple of 16 with masked frames, as the wrappers pad it). A warp owns 16
query rows; the keys are staged in blocks of T rows and walked in tiles of
32, a lane per key, so lane l sees keys l, l + 32, ... in order. Each
dot product sums over the head width in order, one FMA each. Pass 1 keeps
each lane's running max and denominator of each row, online (one
exponential per key, exp(-|s - max|)), and combines the 32 lanes' pairs
by a butterfly (xor 16, 8, 4, 2, 1); pass 2 takes p = exp(s - max) / den
and a = sum p v over the keys in order (one FMA each), and the backward's
rowsum = sum p dp per lane, then by a butterfly; pass 3 ds = p (dp -
rowsum) scale and dq = sum ds k. The key side rebuilds p and ds from the
queries' statistics with the same arithmetic (so the same values) and
sums dv = sum p^T dA and dk = sum ds^T q over the queries in order. The
blocks of T rows and the 16-row tiles move no sum's order: a row's sums
run over the keys in order whichever warp holds it. An FMA is modelled
as an f64 product and add rounded to f32 once. Around the core the frame
computes qkv, dA, the weight gradients and the LN backward as the twin
does. The card holds the kernels themselves against the twins
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Bars (relative L2, dx and the output on the valid rows): the model within
1e-6 of the f32 twin (the two differ in summation order only) and within
1e-5 of JAX's f32 kernels (the f32 DPT kernel bar, PERF.md section 2).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_attn
from convtasnet_tpu_torch.ops.norm import LN_EPS

TWIN_TOL = 1e-6
PALLAS_TOL = 1e-5
LANES = 32
NAMES = ("x", "g", "gamma", "beta", "w_qkv", "w_out", "bias")
GRADS = ("dx", "dgamma", "dbeta", "dw_qkv", "dw_out")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The model runs thousands of elementwise ops of ~1e5 elements: on
    one thread each takes microseconds, where a parallel region per op
    stalls when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fma(a, b, c):
    """f32 fmaf: the product and the add in f64, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def dots(a, b):
    """[P, La, Lb]: every row of a against every row of b ([P, L, d]),
    summed over d in order, one FMA each (rs_dots; its product is
    symmetric, so the key side's k . q is the query side's q . k)."""
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[1])
    for t in range(a.shape[-1]):
        acc = fma(a[:, :, None, t], b[:, None, :, t], acc)
    return acc


def mix(w, rows):
    """[P, L, d] = w [P, L, K] @ rows [P, K, d], each element summed over
    the K rows in order, one FMA each (rs_mix)."""
    acc = torch.zeros(w.shape[0], w.shape[1], rows.shape[-1])
    for k in range(w.shape[-1]):
        acc = fma(w[:, :, k, None], rows[:, None, k, :], acc)
    return acc


def by_lane(t):
    """[P, L, K] -> [P, L, sweeps, 32]: key k at lane k % 32 of sweep
    k // 32, and a mask of the keys that exist."""
    P, L, K = t.shape
    sweeps = -(-K // LANES)
    pad = sweeps * LANES - K
    out = torch.nn.functional.pad(t, (0, pad)).reshape(P, L, sweeps, LANES)
    ok = torch.arange(sweeps * LANES).reshape(sweeps, LANES) < K
    return out, ok


def butterfly(v, combine):
    """The 32 lanes' values (last axis) combined by xor 16, 8, 4, 2, 1, as
    every lane ends with them; lane 0's."""
    lane = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = combine(v, tuple(t[..., lane ^ o] for t in v))
    return tuple(t[..., 0] for t in v)


def row_stats(logit):
    """Pass 1: each lane's running max and denominator over its keys
    (rs_online), then the butterfly (rs_combine)."""
    lg, ok = by_lane(logit)
    P, L = logit.shape[:2]
    mx = torch.full((P, L, LANES), -math.inf)
    den = torch.zeros(P, L, LANES)
    for j in range(lg.shape[2]):
        s, live = lg[:, :, j], ok[j]
        e = torch.exp(-(s - mx).abs())
        gt = (s > mx) & live
        den = torch.where(gt, fma(den, e, torch.ones(())),
                          torch.where(live, den + e, den))
        mx = torch.where(gt, s, mx)

    def combine(a, b):
        mn = torch.maximum(a[0], b[0])
        return mn, a[1] * torch.exp(a[0] - mn) + b[1] * torch.exp(b[0] - mn)

    return butterfly((mx, den), combine)


def core_model(q, k, v, dA, bias, scale):
    """a, dq, dk, dv [P, S, d] of P problems as the f32 row-statistics core
    computes them: q, k, v, dA [P, S, d] f32, bias [P, S] the key bias."""
    logit = fma(dots(q, k), torch.tensor(scale), bias[:, None, :])
    mx, den = row_stats(logit)
    p = torch.exp(logit - mx[..., None]) / den[..., None]
    a = mix(p, v)
    dp = dots(dA, v)
    terms, _ = by_lane(p)
    dterms, _ = by_lane(dp)
    rsum = torch.zeros(p.shape[0], p.shape[1], LANES)
    for j in range(terms.shape[2]):
        rsum = fma(terms[:, :, j], dterms[:, :, j], rsum)
    (rowsum,) = butterfly((rsum,), lambda a, b: (a[0] + b[0],))
    ds = p * (dp - rowsum[..., None]) * scale
    dq = mix(ds, k)
    dv = mix(p.transpose(1, 2), dA)
    dk = mix(ds.transpose(1, 2), q)
    return a, dq, dk, dv


def modelled(x, g, gamma, beta, w_qkv, w_out, key_bias, *, n_heads,
             partial=False):
    """The intra sublayer, f32, with the core of ``core_model`` on chunks
    padded to a multiple of 16 with masked frames (``pad_chunks``, as the
    wrappers run the kernels): its forward output and ``(dx, dgamma,
    dbeta, dw_qkv, dw_out)`` on the unpadded frames."""
    M, n, S_in, B = x.shape
    Sp = -(-S_in // port_attn.INTRA_ROWS) * port_attn.INTRA_ROWS
    x, key_bias = port_attn.pad_chunks(x, key_bias, Sp)
    g = torch.nn.functional.pad(g, (0, 0, 0, Sp - S_in))
    S = Sp
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    d = Bq // h
    mean = x.mean(-1, keepdim=True)
    rs = torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + LN_EPS)
    xhat = (x - mean) * rs
    y = xhat * gamma + beta
    qkv = y @ w_qkv
    dA_rows = g @ w_out.T

    def heads(t):   # [M, n, S, Bq] -> problems (m, chunk, head) over S rows
        return t.reshape(M, n, S, h, d).permute(0, 1, 3, 2, 4).reshape(
            -1, S, d)

    def unheads(t):
        return t.reshape(M, n, h, S, d).permute(0, 1, 3, 2, 4).reshape(
            M, n, S, Bq)

    q, k, v = (heads(t) for t in qkv.split(Bq, dim=-1))
    bias = key_bias[None, :, None, :].expand(M, n, h, S).reshape(-1, S)
    a, dq, dk, dv = core_model(q, k, v, heads(dA_rows), bias,
                               1.0 / math.sqrt(d))
    a = unheads(a)
    proj = a @ w_out
    out = proj if partial else x + proj
    dqkv = torch.cat([unheads(t) for t in (dq, dk, dv)], dim=-1)
    dy = dqkv @ w_qkv.T
    dxhat = dy * gamma
    dx_ln = rs * (dxhat - dxhat.mean(-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dx = dx_ln if partial else g + dx_ln
    return out[:, :, :S_in], (
        dx[:, :, :S_in], (dy * xhat).sum(dim=(0, 1, 2)),
        dy.sum(dim=(0, 1, 2)),
        y.reshape(-1, B).T @ dqkv.reshape(-1, 3 * Bq),
        a.reshape(-1, Bq).T @ g.reshape(-1, B))


def _case(S, d, partial, seed):
    """numpy operands of one intra sublayer over n = 2 chunks of S frames,
    M = 1: B = 64 (d = 16, 32, 64) or 128 (d = 128), or with ``partial``
    the last shard of m = 2 of B = 128 (two heads of 32), as
    parallel/dpt_tp.py cuts it; the last 13 frames masked; the heads; the
    valid frames."""
    rng = np.random.default_rng(seed)
    M, n = 1, 2
    B = 128 if partial or d == 128 else 64
    h = B // d
    valid = np.arange(n * S).reshape(n, S) < n * S - 13
    w_qkv = rng.standard_normal((B, 3 * B)) / np.sqrt(B)
    w_out = rng.standard_normal((B, B)) / np.sqrt(B)
    if partial:
        bq = B // 2
        w_qkv = np.concatenate([w_qkv[:, i * B + bq:(i + 1) * B]
                                for i in range(3)], axis=1)
        w_out = w_out[bq:]
        h //= 2
    arrs = dict(
        x=rng.standard_normal((M, n, S, B)),
        g=rng.standard_normal((M, n, S, B)) * valid[None, :, :, None],
        gamma=1 + 0.1 * rng.standard_normal(B),
        beta=0.1 * rng.standard_normal(B),
        w_qkv=w_qkv, w_out=w_out, bias=np.where(valid, 0.0, -1e9))
    return {k_: v_.astype(np.float32) for k_, v_ in arrs.items()}, h, valid


def _rel(got, want):
    g = np.asarray(got, np.float32).ravel()
    w = np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


def _compare(got, want, names, valid, tol, against):
    for name, q, w in zip(names, got, want):
        q = np.asarray(q.numpy() if torch.is_tensor(q) else q, np.float32)
        w = np.asarray(w.numpy() if torch.is_tensor(w) else w, np.float32)
        assert q.shape == w.shape, (against, name)
        if name in ("out", "dx"):
            q, w = q[:, valid], w[:, valid]
        assert np.isfinite(q).all(), (against, name)
        err = _rel(q, w)
        assert err <= tol, f"{against} {name}: rel_l2 {err:.3e}"


# (chunk length S, head width d, partial): S = 264 (padded to 272, its
# last 16-row tile half a lane sweep) and 320, every head width
CASES = [(S, d, False) for S in (264, 320) for d in (16, 32, 64, 128)]
CASES += [(320, 32, True)]


@pytest.mark.parametrize("S,d,partial", CASES,
                         ids=[f"S{S}-d{d}-{'partial' if p else 'full'}"
                              for S, d, p in CASES])
def test_intra_long_core_order_matches_twin(S, d, partial):
    arrs, h, valid = _case(S, d, partial, seed=S + d)
    t = [torch.from_numpy(arrs[k]) for k in NAMES]
    kw = dict(n_heads=h, partial=partial)
    out, grads = modelled(*t, **kw)
    fwd = [t[0], *t[2:]]
    want = port_attn.attention_reference(*fwd, attend_axis=2, **kw)
    _compare([out], [want], ("out",), valid, TWIN_TOL, "twin")
    want = port_attn.attention_bwd_reference(*t, attend_axis=2, **kw)
    _compare(grads, want, GRADS, valid, TWIN_TOL, "twin")


@pytest.mark.parametrize("S,d,partial", [(264, 32, False), (320, 128, False),
                                         (320, 32, True)])
def test_intra_long_core_order_matches_pallas(S, d, partial):
    """The padded chunk, the widest head and a shard against JAX's f32
    Pallas intra kernels, forward and backward, in interpret mode."""
    arrs, h, valid = _case(S, d, partial, seed=7 + S + d)
    t = [torch.from_numpy(arrs[k]) for k in NAMES]
    kw = dict(n_heads=h, partial=partial)
    out, grads = modelled(*t, **kw)
    j = [jnp.asarray(arrs[k]) for k in NAMES]
    want = jax_intra.fused_intra_attention(j[0], *j[2:], interpret=True, **kw)
    _compare([out], [want], ("out",), valid, PALLAS_TOL, "pallas")
    want = jax_intra.fused_intra_attention_bwd(*j, interpret=True, **kw)
    _compare(grads, want, GRADS, valid, PALLAS_TOL, "pallas")


def test_lane_statistics_change_only_the_order():
    """The per-lane online statistics combined by the butterfly are the
    softmax's max and denominator up to f32 rounding, and not the same
    bits as one running sum over the keys in order: the model takes the
    core's order."""
    rng = np.random.default_rng(3)
    logit = torch.from_numpy(
        (4 * rng.standard_normal((2, 16, 300))).astype(np.float32))
    mx, den = row_stats(logit)
    assert torch.equal(mx, logit.max(-1).values)
    exact = torch.exp(logit.double() - mx.double()[..., None]).sum(-1)
    assert torch.allclose(den.double(), exact, rtol=1e-5, atol=0)
    one = torch.zeros(2, 16)
    for kk in range(300):
        one = one + torch.exp(logit[..., kk] - mx)
    assert torch.allclose(one.double(), exact, rtol=1e-5, atol=0)
    assert not torch.equal(den, one)
