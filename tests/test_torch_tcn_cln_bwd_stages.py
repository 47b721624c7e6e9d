"""A plain model of the f32 cLN block backward's stage split (kernel B3 on
the 3xTF32 stages, ``csrc/tcn_block_bwd_tf32.cuh``) against the port's
twin and the JAX package.

The stages take each norm statistic over one row's Hn channels, and the
model follows their split on CPU tensors in float64:

- R1 / R2': hp = x W_in and c = dwconv(cLN1(PReLU(hp))), each row's
  (mean, rs) as E[h^2] - mean^2 over its Hn real channels;
- G1': e = g W_out^T, hn2, each row's t1 = sum g2 e / n and t2 = sum g2 e
  hhat2 / n (n = Hn), dg2, db2 per channel, dW_out = hn2^T g;
- E2' (E1 folded in): dc = rs2 (g2 e - t1 - hhat2 t2) PReLU'(c) formed at
  each row a tap reads, with that row's mean2, rs2, t1 and t2 (a tap
  outside [0, K) skipped), dhn1 = sum_q dw[q] dc, d_dw, dg1, db1, da2, and
  each row's u1 = sum g1 dhn1 / n, u2 = sum g1 dhn1 hhat1 / n;
- G2b' (G2a folded in): dh_pre = rs1 (g1 dhn1 - u1 - hhat1 u2) PReLU'(hp)
  from the row's rs1, u1 and u2, da1, dx = g + dh_pre W_in^T and dW_in.

It is held against ``fused_tcn_block_bwd_reference`` (autograd through
the twin) and against JAX: the Pallas ``fused_tcn_block_bwd(norm_type=
"cLN")`` in interpret mode where it takes the taps (P <= 8), ``jax.vjp``
of ``_xla_block`` at P = 17. At B = H = 96 the model runs as the kernels
do, zero-padded to 128 with the norms over Hn = 96. Three planted faults
of the model (a tap's dc formed with the reading row's statistics, a mean
over the padded H, t1 not divided by n) each fail the bar. The kernel
itself is held on the card in ``tests/test_torch_cuda.py``
(``-k f32_stages_backward_cln``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import tcn_block as jax_tcn
from convtasnet_tpu.ops.pallas import tcn_block_bwd as jax_bwd
from convtasnet_tpu_torch.ops.conv import prelu
from convtasnet_tpu_torch.ops.cuda import tcn_block_bwd as port_bwd
from convtasnet_tpu_torch.ops.cuda.tcn_block import pad_block, padded
from convtasnet_tpu_torch.ops.norm import EPS

M, K = 2, 150   # K is no multiple of 128
ORDER = ("x", "w_in", "dw", "w_out", "a1", "a2", "g1", "b1", "g2", "b2")
NAMES = ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2",
         "dg1", "db1", "dg2", "db2")
# (B, H, P, dilation, causal): causal at d = 1, 4 and 64 (past both ends of
# K = 150), non-causal at d = 2, 17 taps, and B = H = 96 run padded to 128
CASES = [(64, 128, 3, 1, True), (64, 128, 3, 4, True),
         (64, 128, 3, 64, True), (64, 128, 3, 2, False),
         (64, 128, 17, 2, True), (96, 96, 3, 1, True),
         (96, 96, 3, 2, False)]
# each cotangent scaled by its largest entry, as tests/test_pallas.py holds
# the Pallas backward against autodiff: the model is float64, the twin and
# JAX float32, so the bar is f32 rounding through the norms' backward
BAR = 5e-5


def _inputs(B, H, P, seed):
    """Seeded f32 block operands and an output cotangent; slopes 0.3 and
    -0.2 (a2 < 0 flips PReLU'; neither a power of two)."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.standard_normal((M, K, B)),
        w_in=rng.standard_normal((B, H)) / np.sqrt(B),
        dw=rng.standard_normal((P, H)),
        w_out=rng.standard_normal((H, B)) / np.sqrt(H),
        a1=np.array(0.3), a2=np.array(-0.2),
        g1=1.0 + 0.3 * rng.standard_normal(H), b1=rng.standard_normal(H),
        g2=1.0 + 0.3 * rng.standard_normal(H), b2=rng.standard_normal(H),
    )
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return arrs, rng.standard_normal((M, K, B)).astype(np.float32)


def _shift(v, s):
    """v[:, k + s] at row k along dim 1, zero where k + s is outside [0, K)."""
    out = torch.zeros_like(v)
    if s >= 0:
        out[:, :v.shape[1] - s] = v[:, s:]
    else:
        out[:, -s:] = v[:, :s]
    return out


def _row_stats(h, n):
    """Each row's (mean, rs) over its channels divided by n, the variance as
    E[h^2] - mean^2 (the stages' rule), clamped at 0."""
    mean = h.sum(-1, keepdim=True) / n
    var = (h.square().sum(-1, keepdim=True) / n - mean.square()).clamp_min(0)
    return mean, torch.rsqrt(var + EPS)


def stage_model(x, g, w_in, dw, w_out, a1, a2, g1, b1, g2, b2, *, dilation,
                causal, Hn, fault=None):
    """The ten cotangents of one cLN block by the f32 stages' split (the top
    note), on H = w_in.shape[1] channels of which the first Hn are real."""
    H, P, d = w_in.shape[1], dw.shape[0], dilation
    left = (P - 1) * d if causal else (P - 1) * d // 2
    n = H if fault == "padded_mean" else Hn
    # R1, R2'
    hp = x @ w_in
    h1 = prelu(hp, a1)
    mean1, rs1 = _row_stats(h1, n)
    hn1 = (h1 - mean1) * rs1 * g1 + b1
    c = sum(dw[q] * _shift(hn1, q * d - left) for q in range(P))
    h2 = prelu(c, a2)
    mean2, rs2 = _row_stats(h2, n)
    # G1'
    e = g @ w_out.T
    hhat2 = (h2 - mean2) * rs2
    hn2 = g2 * hhat2 + b2
    t1 = (g2 * e).sum(-1, keepdim=True)
    t1 = t1 if fault == "t1_undivided" else t1 / n
    t2 = (g2 * e * hhat2).sum(-1, keepdim=True) / n
    dg2, db2 = (e * hhat2).sum((0, 1)), e.sum((0, 1))
    dw_out = hn2.reshape(-1, H).T @ g.reshape(-1, g.shape[-1])

    # E2': dc of row k + s formed from that row's c, e and statistics
    # (fault "reading_row": the statistics of row k, which reads it)
    def dc_at(s):
        valid = _shift(torch.ones_like(mean2), s)
        cs, es = _shift(c, s), _shift(e, s)
        stats = (mean2, rs2, t1, t2)
        if fault != "reading_row" or s == 0:
            stats = tuple(_shift(v, s) for v in stats)
        m2, r2, u, v = stats
        hh = (prelu(cs, a2) - m2) * r2
        dh2 = valid * r2 * (g2 * es - u - hh * v)
        return torch.where(cs >= 0, dh2, a2 * dh2), dh2

    dc0, dh2 = dc_at(0)
    dhn1 = sum(dw[q] * dc_at(left - q * d)[0] for q in range(P))
    d_dw = torch.stack([(dc0 * _shift(hn1, q * d - left)).sum((0, 1))
                        for q in range(P)])
    hhat1 = (h1 - mean1) * rs1
    dg1, db1 = (dhn1 * hhat1).sum((0, 1)), dhn1.sum((0, 1))
    da2 = (dh2 * c.clamp(max=0)).sum()
    u1 = (g1 * dhn1).sum(-1, keepdim=True) / n
    u2 = (g1 * dhn1 * hhat1).sum(-1, keepdim=True) / n
    # G2b'
    dh1 = rs1 * (g1 * dhn1 - u1 - hhat1 * u2)
    dh_pre = torch.where(hp >= 0, dh1, a1 * dh1)
    da1 = (dh1 * hp.clamp(max=0)).sum()
    dx = g + dh_pre @ w_in.T
    dw_in = x.reshape(-1, x.shape[-1]).T @ dh_pre.reshape(-1, H)
    return dx, dw_in, d_dw, dw_out, da1, da2, dg1, db1, dg2, db2


def _model_grads(arrs, g, P, dilation, causal, fault=None):
    """The model in float64 at the widths the kernels run (B and H padded
    to 128 with zero weights, the norms over the block's own H), cut back
    to the block's widths."""
    t = {k: torch.from_numpy(v).double() for k, v in arrs.items()}
    B, H = t["w_in"].shape
    Bp, Hp = padded(B), padded(H)
    (w_in, dw, w_out), vecs = pad_block(
        (t["w_in"], t["dw"], t["w_out"]),
        [t["g1"], t["b1"], t["g2"], t["b2"]])
    pad = torch.nn.functional.pad
    x = pad(t["x"], (0, Bp - B))
    gg = pad(torch.from_numpy(g).double(), (0, Bp - B))
    out = stage_model(x, gg, w_in, dw, w_out, t["a1"], t["a2"], *vecs,
                      dilation=dilation, causal=causal, Hn=H, fault=fault)
    dx, dw_in, d_dw, dw_out, da1, da2, dg1, db1, dg2, db2 = out
    return [q.numpy() for q in (
        dx[..., :B], dw_in[:B, :H], d_dw[:, :H], dw_out[:H, :B], da1, da2,
        dg1[:H], db1[:H], dg2[:H], db2[:H])]


def _twin_grads(arrs, g, dilation, causal):
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    grads = port_bwd.fused_tcn_block_bwd_reference(
        args[0], torch.from_numpy(g), *args[1:], dilation=dilation,
        causal=causal, norm_type="cLN")
    return [q.numpy() for q in grads]


def _jax_grads(arrs, g, P, dilation, causal):
    """JAX's cLN backward: the Pallas kernel in interpret mode where it
    takes the taps (P <= 8), else jax.vjp of _xla_block."""
    prims = [jnp.asarray(arrs[n]) for n in ORDER]
    if P <= 8:
        return jax_bwd.fused_tcn_block_bwd(
            prims[0], jnp.asarray(g), *prims[1:], dilation=dilation,
            causal=causal, norm_type="cLN", tile=128, interpret=True)
    H = arrs["w_in"].shape[1]

    def block(*a):
        return jax_tcn._xla_block((dilation, causal, "cLN"), *a,
                                  jnp.zeros(H), jnp.ones(H), jnp.zeros(H),
                                  jnp.ones(H))

    _, vjp = jax.vjp(block, *prims)
    return vjp(jnp.asarray(g))


def _distance(got, want):
    """The largest distance over the ten cotangents, each scaled by its
    largest entry, and the cotangent that gives it."""
    worst = (0.0, None)
    for name, q, w in zip(NAMES, got, want):
        w = np.asarray(w, np.float64)
        assert np.shape(q) == w.shape, name
        dist = np.max(np.abs(np.asarray(q) - w)) / (np.max(np.abs(w)) + 1e-9)
        worst = max(worst, (float(dist), name))
    return worst


@pytest.mark.parametrize("ref", ["twin", "jax"])
@pytest.mark.parametrize("b,h,p,dilation,causal", CASES)
def test_stage_model_matches(ref, b, h, p, dilation, causal):
    arrs, g = _inputs(b, h, p, seed=10 * dilation + p)
    got = _model_grads(arrs, g, p, dilation, causal)
    want = (_twin_grads(arrs, g, dilation, causal) if ref == "twin"
            else _jax_grads(arrs, g, p, dilation, causal))
    dist, name = _distance(got, want)
    assert dist <= BAR, (name, dist)


@pytest.mark.parametrize("fault,case", [
    ("reading_row", (64, 128, 3, 1, True)),
    ("padded_mean", (96, 96, 3, 1, True)),
    ("t1_undivided", (64, 128, 3, 4, True)),
])
def test_planted_model_fault_fails_the_bar(fault, case):
    """Each fault of the model parts from the twin by more than the bar."""
    b, h, p, dilation, causal = case
    arrs, g = _inputs(b, h, p, seed=10 * dilation + p)
    got = _model_grads(arrs, g, p, dilation, causal, fault=fault)
    dist, name = _distance(got, _twin_grads(arrs, g, dilation, causal))
    assert dist > 10 * BAR, (fault, name, dist)
