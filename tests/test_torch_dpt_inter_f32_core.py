"""The order of summation of the f32 inter-chunk attention cores
(``csrc/dpt_attention.cu::inter_core_kernel``, kernel B7, and
``csrc/dpt_attention_bwd.cu::inter_bwd_core_kernel``, kernel B8, and their
partial modes) as a plain PyTorch model, against the port's twins
``attention_reference`` / ``attention_bwd_reference`` and the JAX
package's Pallas kernels in interpret mode, on the CPU, with inputs from a
numpy seed.

Per (m, position s, head) the cores attend over the n chunks, one query
(or key) chunk per lane. At head widths up to 64 a lane holds a whole row
of the head and sums each dot product over its d values in turn; at d = 128
two lanes share a chunk (``InterLanes`` in ``csrc/dpt_common.cuh``), each
sums its 64 values in turn and one shuffle adds the two halves. Each
multiply-add of the model is one f32 FMA (an f64 product and add rounded
to f32 once). The query side runs the online max and denominator over the
keys, then p = exp(score - max) / sum, a = sum p v (B7, and the B8 query
side with rowsum = sum p dp and dq = sum ds k); the B8 key side rebuilds p
and ds from the per-query statistics and sums dv and dk over the queries.
Around the core the frame computes qkv, dA, the weight gradients and the
LN backward as the twin does. The card holds the kernels themselves
against the twins (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Bars (relative L2, dx on the valid rows): the model within 1e-6 of the f32
twin (the two differ in summation order only) and within 1e-5 of JAX's f32
kernel (the f32 DPT kernel bar, PERF.md section 2).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_attn
from convtasnet_tpu_torch.ops.norm import LN_EPS

TWIN_TOL = 1e-6
PALLAS_TOL = 1e-5
NAMES = ("x", "g", "gamma", "beta", "w_qkv", "w_out", "bias")
GRADS = ("dx", "dgamma", "dbeta", "dw_qkv", "dw_out")


def lanes(d):
    """(G, DL): lanes per chunk and dimensions per lane (InterLanes)."""
    g = d // 64 if d > 64 else 1
    return g, d // g


def fma(a, b, c):
    """f32 fmaf: the product and the add in f64, rounded once."""
    return (a.double() * b.double() + c.double()).float()


def dot(a, b):
    """The cores' dot product over the last axis: each of G lanes sums its
    DL values in turn by FMA, then the lanes' sums are added."""
    g, dl = lanes(a.shape[-1])
    total = None
    for lane in range(g):
        acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
        for t in range(lane * dl, (lane + 1) * dl):
            acc = fma(a[..., t], b[..., t], acc)
        total = acc if total is None else total + acc
    return total


def core_model(q, k, v, dA, bias, scale):
    """a, dq, dk, dv [P, n, d] of P problems as the f32 inter cores compute
    them (B7's a is B8's query side's): q, k, v, dA [P, n, d] f32, bias
    [P, n] the key bias."""
    P, n, d = q.shape
    keys = range(n)

    def score(j):   # every query against key j: [P, n]
        return dot(q, k[:, None, j]) * scale + bias[:, None, j]

    # query side, pass 1: the row max and denominator, online over the keys
    mx = torch.full((P, n), -math.inf)
    den = torch.zeros(P, n)
    for j in keys:
        sc = score(j)
        mn = torch.maximum(mx, sc)
        den = den * torch.exp(mx - mn) + torch.exp(sc - mn)
        mx = mn
    # pass 2 (B7's second pass): a, and B8's rowsum = sum p dp
    a = torch.zeros(P, n, d)
    rowsum = torch.zeros(P, n)
    for j in keys:
        pj = torch.exp(score(j) - mx) / den
        a = fma(pj[..., None], v[:, None, j], a)
        rowsum = fma(pj, dot(dA, v[:, None, j]), rowsum)
    # pass 3: dq = sum ds k
    dq = torch.zeros(P, n, d)
    for j in keys:
        pj = torch.exp(score(j) - mx) / den
        ds = pj * (dot(dA, v[:, None, j]) - rowsum) * scale
        dq = fma(ds[..., None], k[:, None, j], dq)
    # key side: every key against query i, from query i's statistics
    dk = torch.zeros(P, n, d)
    dv = torch.zeros(P, n, d)
    for i in keys:
        pj = torch.exp(dot(q[:, None, i], k) * scale + bias
                       - mx[:, i, None]) / den[:, i, None]
        ds = pj * (dot(dA[:, None, i], v) - rowsum[:, i, None]) * scale
        dv = fma(pj[..., None], dA[:, None, i], dv)
        dk = fma(ds[..., None], q[:, None, i], dk)
    return a, dq, dk, dv


def modelled(x, g, gamma, beta, w_qkv, w_out, key_bias, *, n_heads,
             partial=False):
    """The inter sublayer, f32, with the core of ``core_model``: its forward
    output and ``(dx, dgamma, dbeta, dw_qkv, dw_out)``."""
    M, n, S, B = x.shape
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    d = Bq // h
    mean = x.mean(-1, keepdim=True)
    rs = torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + LN_EPS)
    xhat = (x - mean) * rs
    y = xhat * gamma + beta
    qkv = y @ w_qkv
    dA_rows = g @ w_out.T

    def heads(t):   # [M, n, S, Bq] -> problems (m, s, head) over n chunks
        return t.reshape(M, n, S, h, d).permute(0, 2, 3, 1, 4).reshape(
            -1, n, d)

    def unheads(t):
        return t.reshape(M, S, h, n, d).permute(0, 3, 1, 2, 4).reshape(
            M, n, S, Bq)

    q, k, v = (heads(t) for t in qkv.split(Bq, dim=-1))
    kb = torch.zeros(n, S) if key_bias is None else key_bias
    bias = kb.T[None, :, None, :].expand(M, S, h, n).reshape(-1, n)
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
    return out, ((dx_ln if partial else g + dx_ln),
                 (dy * xhat).sum(dim=(0, 1, 2)), dy.sum(dim=(0, 1, 2)),
                 y.reshape(-1, B).T @ dqkv.reshape(-1, 3 * Bq),
                 a.reshape(-1, Bq).T @ g.reshape(-1, B))


def _case(n, d, partial, seed):
    """numpy operands of one inter sublayer over n chunks of S = 4 frames:
    B = 128 (one head at d = 128), or with ``partial`` the last shard of
    m = 2 of B = 256 (one head of 128, or 8 of 16), as parallel/dpt_tp.py
    cuts it; the last 3 frames masked; the heads; the valid frames."""
    rng = np.random.default_rng(seed)
    M, S = 2, 4
    B = 256 if partial else 128
    h = B // d
    valid = np.arange(n * S).reshape(n, S) < n * S - 3
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


# (chunks n, head width d, partial): n = 1 (every row one key), 5, and 33
# (more than one of the cores' 32-chunk key tiles)
CASES = [(n, d, False) for n in (1, 5, 33) for d in (16, 32, 64, 128)]
CASES += [(5, 16, True), (5, 128, True)]


@pytest.mark.parametrize("n,d,partial", CASES,
                         ids=[f"n{n}-d{d}-{'partial' if p else 'full'}"
                              for n, d, p in CASES])
def test_inter_core_order_matches_twin(n, d, partial):
    arrs, h, valid = _case(n, d, partial, seed=10 * n + d)
    t = [torch.from_numpy(arrs[k]) for k in NAMES]
    kw = dict(n_heads=h, partial=partial)
    out, grads = modelled(*t, **kw)
    fwd = [t[0], *t[2:]]
    want = port_attn.attention_reference(*fwd, attend_axis=1, **kw)
    _compare([out], [want], ("out",), valid, TWIN_TOL, "twin")
    want = port_attn.attention_bwd_reference(*t, attend_axis=1, **kw)
    _compare(grads, want, GRADS, valid, TWIN_TOL, "twin")


@pytest.mark.parametrize("d,partial", [(128, False), (16, False),
                                       (128, True)])
def test_inter_core_order_matches_pallas(d, partial):
    """The d = 128 lane split (and d = 16, eight or four heads a shard)
    against JAX's f32 Pallas kernels, forward and backward, in interpret
    mode."""
    arrs, h, valid = _case(5, d, partial, seed=7 + d)
    t = [torch.from_numpy(arrs[k]) for k in NAMES]
    kw = dict(n_heads=h, partial=partial)
    out, grads = modelled(*t, **kw)
    j = [jnp.asarray(arrs[k]) for k in NAMES]
    want = jax_inter.fused_inter_attention(j[0], *j[2:], interpret=True, **kw)
    _compare([out], [want], ("out",), valid, PALLAS_TOL, "pallas")
    want = jax_inter.fused_inter_attention_bwd(*j, interpret=True, **kw)
    _compare(grads, want, GRADS, valid, PALLAS_TOL, "pallas")


def test_lane_split_changes_only_the_order():
    """At d = 128 the split dot product (two lanes of 64, then their sum)
    is the plain dot product up to f32 rounding, and not the same bits as
    one lane's run over all 128 values: the model does take the kernels'
    order; at d = 64 it is that one lane's run."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32)) for _ in range(2))
    split = dot(a, b)
    one = torch.zeros(64)
    for t in range(128):
        one = fma(a[:, t], b[:, t], one)
    exact = (a.double() * b.double()).sum(-1)
    assert torch.allclose(split.double(), exact, rtol=0, atol=1e-4)
    assert torch.allclose(one.double(), exact, rtol=0, atol=1e-4)
    assert not torch.equal(split, one)
    one = torch.zeros(64)
    for t in range(64):
        one = fma(a[:, t], b[:, t], one)
    assert torch.equal(dot(a[:, :64], b[:, :64]), one)
