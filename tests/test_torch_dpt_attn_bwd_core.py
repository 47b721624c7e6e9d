"""The schedule of the bf16 attention backward core (``csrc/dpt_attn_bwd_wg.cuh``,
kernels B8 and B10 and their partial modes) as a plain PyTorch model,
against the port's twin ``attention_bwd_reference`` and the JAX package's
Pallas backwards (``_intra_bwd_kernel``, ``_inter_bwd_kernel``) in
interpret mode, on the CPU, with inputs from a numpy seed.

The model follows the core step by step: the rows of a problem (one chunk,
or one position across the chunks, for one head) padded to a multiple of
the 16-row tile, keys beyond the length masked with a bias of -inf and
queries beyond it with stats (+inf, 0, 0); the query side walks key tiles
of 16 (pass 1 the row max and denominator online, pass 2 a and rowsum =
sum p dp in f32, pass 3 ds and dq) and leaves (max, denominator, rowsum)
per row; the key side rebuilds p and ds from those stats for its own key
rows and accumulates dv and dk over query tiles of 16. Its rounding points
are the Pallas body's. Around it, the frame computes qkv, dA, the weight
gradients and the LN backward as the twin does. The card holds the kernel
itself against the twin (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Every cotangent by relative L2, dx on the valid rows: f32 within 1e-5 of
the f32 twin and of JAX's f32 kernel (the model sums in another order,
online over the key tiles), bf16 within 4e-2 of the bf16 twin and of
JAX's bf16 kernel.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_attn
from convtasnet_tpu_torch.ops.norm import LN_EPS

TILE = 16                       # the core's row and key tiles
WIDTH = 64                      # small, so that interpret mode stays fast
TOL = {"float32": 1e-5, "bfloat16": 4e-2}
GRADS = ("dx", "dgamma", "dbeta", "dw_qkv", "dw_out")
# (kind, attended length): intra chunks of S frames, inter n chunks
LENGTHS = [("intra", 16), ("intra", 40), ("intra", 144),
           ("inter", 1), ("inter", 5), ("inter", 33)]


def _rel(got, want):
    g = np.asarray(got, np.float32).ravel()
    w = np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


def core_schedule(q, k, v, dA, bias, scale, rnd):
    """a, dq, dk, dv [P, L, d] of P problems as the core computes them:
    q, k, v, dA [P, L, d] in f32 (values of the compute dtype), bias [P, L]
    the key bias, ``rnd`` the rounding to the compute dtype."""
    L = q.shape[1]
    Lp = -(-L // TILE) * TILE

    def pad(t):
        return torch.nn.functional.pad(t, (0, 0, 0, Lp - L))

    q, k, v, dA = map(pad, (q, k, v, dA))
    kb = torch.nn.functional.pad(bias, (0, Lp - L), value=-math.inf)
    tiles = [slice(j, j + TILE) for j in range(0, Lp, TILE)]

    def logits(j):   # queries x the keys of tile j
        return q @ k[:, j].transpose(1, 2) * scale + kb[:, None, j]

    # query side, pass 1: the row max and denominator, online
    mx = torch.full(q.shape[:2] + (1,), -math.inf)
    den = torch.zeros_like(mx)
    for j in tiles:
        s = logits(j)
        mn = torch.maximum(mx, s.amax(-1, keepdim=True))
        den = den * torch.exp(mx - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        mx = mn
    inv = 1.0 / den
    # pass 2: a = round(round(p) v), rowsum = sum p dp in f32
    a = torch.zeros_like(q)
    rowsum = torch.zeros_like(mx)
    for j in tiles:
        p = torch.exp(logits(j) - mx) * inv
        a = a + rnd(p) @ v[:, j]
        rowsum = rowsum + (p * (dA @ v[:, j].transpose(1, 2))).sum(
            -1, keepdim=True)
    # pass 3: ds = round(p (dp - rowsum) scale), dq = round(ds k)
    dq = torch.zeros_like(q)
    for j in tiles:
        p = torch.exp(logits(j) - mx) * inv
        dp = dA @ v[:, j].transpose(1, 2)
        dq = dq + rnd(p * (dp - rowsum) * scale) @ k[:, j]
    # the per-row stats the key side reads: (+inf, 0, 0) beyond L
    valid = (torch.arange(Lp) < L)[None, :, None]
    mx = torch.where(valid, mx, math.inf)
    inv = torch.where(valid, inv, 0.0)
    rowsum = torch.where(valid, rowsum, 0.0)
    # key side: each key row over the query tiles
    dk, dv = torch.zeros_like(q), torch.zeros_like(q)
    for j in tiles:
        st = [t[:, j].transpose(1, 2) for t in (mx, inv, rowsum)]
        s_t = k @ q[:, j].transpose(1, 2) * scale + kb[:, :, None]
        p = torch.exp(s_t - st[0]) * st[1]
        ds = rnd(p * (v @ dA[:, j].transpose(1, 2) - st[2]) * scale)
        dv = dv + rnd(p) @ dA[:, j]
        dk = dk + ds @ q[:, j]
    return [rnd(t[:, :L]) for t in (a, dq, dk, dv)]


def scheduled_bwd(x, g, gamma, beta, w_qkv, w_out, key_bias, *, n_heads,
                  attend_axis, partial=False):
    """The attention sublayer backward with the core of ``core_schedule``
    and the frame's arithmetic: ``(dx, dgamma, dbeta, dw_qkv, dw_out)``."""
    dt = x.dtype
    M, n, S, Bx = x.shape
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    d = Bq // h

    def rnd(t):
        return t.to(dt).float()

    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rs = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + LN_EPS)
    xhat = (xf - mean) * rs
    y = rnd(xhat * gamma + beta)
    wq, wo = rnd(w_qkv.float()), rnd(w_out.float())
    gf = g.float()
    qkv = rnd(y @ wq)
    dA = rnd(gf @ wo.T)
    # problems x heads: intra (m, chunk, head) over S, inter (m, s, head)
    # over n
    perm = (0, 1, 3, 2, 4) if attend_axis == 2 else (0, 2, 3, 1, 4)
    inv_perm = (0, 1, 3, 2, 4) if attend_axis == 2 else (0, 3, 1, 2, 4)

    def heads(t):
        t = t.reshape(M, n, S, h, d).permute(perm)
        return t.reshape(-1, t.shape[3], d), t.shape

    def unheads(t, shape):
        return t.reshape(shape).permute(inv_perm).reshape(M, n, S, h * d)

    (q, shape), (k, _), (v, _), (da, _) = (
        heads(t) for t in (*qkv.split(Bq, dim=-1), dA))
    kb = torch.zeros(n, S) if key_bias is None else key_bias.float()
    kb = kb if attend_axis == 2 else kb.T          # [problems per m, L]
    bias = kb[None, :, None, :].expand(M, -1, h, -1).reshape(-1, kb.shape[1])
    a, dq, dk, dv = core_schedule(q, k, v, da, bias, 1.0 / math.sqrt(d), rnd)
    dqkv = torch.cat([unheads(t, shape) for t in (dq, dk, dv)],
                     dim=-1).reshape(-1, 3 * Bq)
    a = unheads(a, shape).reshape(-1, Bq)
    y2, g2 = y.reshape(-1, Bx), gf.reshape(-1, Bx)
    dy = (dqkv @ wq.T).reshape(x.shape)
    dxhat = dy * gamma
    dx_ln = rs * (dxhat - dxhat.mean(-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return ((dx_ln if partial else gf + dx_ln).to(dt),
            (dy * xhat).sum(dim=(0, 1, 2)), dy.sum(dim=(0, 1, 2)),
            y2.T @ dqkv, a.T @ g2)


def _case(kind, length, d, partial, seed):
    """numpy operands of one sublayer: x [M, n, S, B], its cotangent (zero
    on the masked tail), the LN affine off 1 and 0, the weights (one
    shard's of m = 2 with ``partial``) and the key bias of a masked tail;
    the heads of the (sharded) weights; the valid frames [n, S]."""
    rng = np.random.default_rng(seed)
    M, n, S = (1, 2, length) if kind == "intra" else (1, length, 6)
    B = max(WIDTH, d)   # one head of 128 at d = 128
    h = B // d
    frames = n * S - (3 if n * S > 3 else 0)
    valid = np.arange(n * S).reshape(n, S) < frames
    w_qkv = rng.standard_normal((B, 3 * B)) / np.sqrt(B)
    w_out = rng.standard_normal((B, B)) / np.sqrt(B)
    if partial:   # the last shard of m = 2, as parallel/dpt_tp.py cuts it
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
        w_qkv=w_qkv, w_out=w_out,
        bias=np.where(valid, 0.0, -1e9))
    return {k_: v_.astype(np.float32) for k_, v_ in arrs.items()}, h, valid


NAMES = ("x", "g", "gamma", "beta", "w_qkv", "w_out", "bias")


def _compare(got, want, dtype, valid, against):
    for name, q, w in zip(GRADS, got, want):
        q = np.asarray(q.float().numpy() if torch.is_tensor(q) else q,
                       np.float32)
        w = np.asarray(w.float().numpy() if torch.is_tensor(w) else w,
                       np.float32)
        assert q.shape == w.shape, (against, name)
        if name == "dx":
            q, w = q[:, valid], w[:, valid]
        assert np.isfinite(q).all(), (against, name)
        err = _rel(q, w)
        assert err <= TOL[dtype], f"{against} {name}: rel_l2 {err:.3e}"


# (head width, partial): B = 64 holds one head of 64, which no shard of
# m = 2 splits, so the partial mode runs at d = 32 and 16; d = 128 at
# B = 128 (the bf16 core's other widths)
MODES = [(32, False), (64, False), (32, True), (16, False), (16, True),
         (128, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,partial", MODES,
                         ids=["d32-full", "d64-full", "d32-partial",
                              "d16-full", "d16-partial", "d128-full"])
@pytest.mark.parametrize("kind,length", LENGTHS,
                         ids=[f"{k}-{n}" for k, n in LENGTHS])
def test_core_schedule_matches_twin_and_pallas(kind, length, d, partial,
                                               dtype):
    arrs, h, valid = _case(kind, length, d, partial, seed=length + d)
    tdt = getattr(torch, dtype)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    t = [torch.from_numpy(arrs[k]).to(tdt if k in ("x", "g") else
                                      torch.float32) for k in NAMES]
    axis = 2 if kind == "intra" else 1
    kw = dict(n_heads=h, partial=partial)
    got = scheduled_bwd(*t, attend_axis=axis, **kw)
    assert got[0].dtype == tdt
    twin = port_attn.attention_bwd_reference(*t, attend_axis=axis, **kw)
    _compare(got, twin, dtype, valid, "twin")
    j = [jnp.asarray(arrs[k], jdt if k in ("x", "g") else jnp.float32)
         for k in NAMES]
    jax_bwd = (jax_intra.fused_intra_attention_bwd if kind == "intra"
               else jax_inter.fused_inter_attention_bwd)
    want = jax_bwd(*j, interpret=True, **kw)
    _compare(got, want, dtype, valid, "pallas")


def test_core_schedule_is_the_softmax_backward():
    """In f32, with no rounding, the schedule is the plain softmax
    attention backward of the same problems, at a length that leaves 11
    masked rows in its last 16-row tile: keys beyond L take no weight and
    queries beyond L give no gradient."""
    rng = np.random.default_rng(3)
    P, L, d = 3, 21, 32
    ops = [torch.from_numpy(rng.standard_normal((P, L, d)).astype(np.float32))
           for _ in range(4)]
    bias = torch.from_numpy(rng.standard_normal((P, L)).astype(np.float32))

    def rnd(t):
        return t

    base = core_schedule(*ops, bias, 0.2, rnd)
    # the plain softmax attention backward of the same problems
    s = ops[0] @ ops[1].transpose(1, 2) * 0.2 + bias[:, None, :]
    p = torch.softmax(s, dim=-1)
    dp = ops[3] @ ops[2].transpose(1, 2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * 0.2
    want = (p @ ops[2], ds @ ops[1], ds.transpose(1, 2) @ ops[0],
            p.transpose(1, 2) @ ops[3])
    for got_t, want_t in zip(base, want):
        assert _rel(got_t.numpy(), want_t.numpy()) <= 1e-5
