"""The port's DPT attention at every head width the JAX package runs, on the
CPU against the JAX package, with inputs from numpy seeds.

The attention kernels (B7-B10 and their partial modes) run a head on a
core of width D in {16, 32, 64, 128}, or above 128 on a route beside the
cores (``csrc/dpt_attn_wide_head.cuh``). The wrappers widen a head of
another width d to D = ``core_head_width(d)`` with zero columns of q, k
and v and zero rows of W_out (``pad_attention``), and the kernels take the
real d beside their operands, so the softmax scale stays 1 / sqrt(d). The
card holds the kernels against their twins (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here the twins, which take the same real ``d``, run
the padded operands, so the padded path is held on the CPU:

- each attention sublayer (inter and intra, full and on the last
  head-group shard of two) at d = 8, 24, 48 and 96 (widened to 16, 32, 64
  and 128) and d = 192 and 256 (the route's widths), forward and
  backward, in f32: the unpadded twin against the JAX package as its
  model's gate sends it (the Pallas kernel in interpret mode where B %
  128 == 0: d = 8 at B = 128 with 16 heads, d = 256 at B = 256 with one,
  and the shards of B = 384 and 512; else ``xla_*_attention`` and
  ``jax.vjp`` of it), within 5e-4; the padded twin (``pad_attention``,
  the twin with ``Bn`` and ``d``, ``unpad_attention_grads``) against the
  unpadded one within 1e-5;
- whole models at ``--B 96 --dpt-heads 2`` (d = 48) and ``--B 256
  --dpt-heads 1`` (d = 256), which the kernels now take: the forward
  through the kernels' CPU twins against the JAX model within 5e-4, and
  one train step's gradients leaf by leaf against ``jax.grad`` within
  1e-5, as ``tests/test_torch_dpt_train.py`` holds them.

Bars are relative L2 (the attention output and dx on the valid rows).
"""

import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig as JaxConfig
from convtasnet_tpu.models import conv_tasnet as jmodel
from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu.train import train_step as jts
from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.models.jax_params import state_dict_from_jax
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_attn
from convtasnet_tpu_torch.ops.cuda import dpt_intra as port_intra
from convtasnet_tpu_torch.ops.cuda import shapes
from convtasnet_tpu_torch.train import train_step as pts
from tests.test_torch_dpt_train import SOLVER, _assert_grads_match, _batch
from tests.test_torch_dpt_wide import _jax_variables

JAX_TOL, PAD_TOL = 5e-4, 1e-5
M, N_CHUNKS, S = 1, 3, 16
VALID = np.arange(N_CHUNKS * S).reshape(N_CHUNKS, S) < N_CHUNKS * S - 11
# head width d -> (B, heads) of the full sublayer; its shard of two runs
# at twice the width with twice the heads where one head has no shard
WIDTHS = {8: (128, 16), 24: (48, 2), 48: (96, 2), 96: (192, 2),
          192: (192, 1), 256: (256, 1)}
JAX = {"inter": (jax_inter.fused_inter_attention,
                 jax_inter.fused_inter_attention_bwd,
                 jax_inter.xla_inter_attention),
       "intra": (jax_intra.fused_intra_attention,
                 jax_intra.fused_intra_attention_bwd,
                 jax_intra.xla_intra_attention)}
PORT = {"inter": (port_attn.fused_inter_attention,
                  port_attn.fused_inter_attention_bwd,
                  port_attn.inter_attention_reference,
                  port_attn.inter_attention_bwd_reference),
        "intra": (port_intra.fused_intra_attention,
                  port_intra.fused_intra_attention_bwd,
                  port_intra.intra_attention_reference,
                  port_intra.intra_attention_bwd_reference)}


def _rel(got, want):
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-30))


def _operands(d, m, seed):
    """Numpy operands of one attention sublayer with heads of width d
    (``WIDTHS``; with m = 2 the last head-group shard of two, as
    parallel/dpt_tp.py cuts it) and a cotangent zero on the padded rows ->
    (x, g, gamma, beta, w_qkv, w_out, key bias), the local head count and
    B."""
    B, heads = WIDTHS[d]
    if m > 1 and heads % m:
        B, heads = B * m, heads * m
    rng = np.random.default_rng(seed)
    w_qkv = rng.standard_normal((B, 3 * B)) / np.sqrt(B)
    w_out = rng.standard_normal((B, B)) / np.sqrt(B)
    if m > 1:
        bq = B // m
        w_qkv = np.concatenate([w_qkv[:, i * B + B - bq:(i + 1) * B]
                                for i in range(3)], axis=1)
        w_out = w_out[B - bq:]
    arrs = [rng.standard_normal((M, N_CHUNKS, S, B)),
            rng.standard_normal((M, N_CHUNKS, S, B)) * VALID[None, :, :, None],
            1 + 0.1 * rng.standard_normal(B), 0.1 * rng.standard_normal(B),
            w_qkv, w_out, np.where(VALID, 0.0, -1e9)]
    return [a.astype(np.float32) for a in arrs], heads // m, B


def _jax_reference(kind, arrs, heads, m):
    """The JAX sublayer's output and its (dx, dgamma, dbeta, dw_qkv,
    dw_out), as its model's gate sends it: the Pallas kernel (interpret
    mode) where B % 128 == 0, else the XLA sublayer and ``jax.vjp``."""
    jfwd, jbwd, xla = JAX[kind]
    kw = dict(n_heads=heads, partial=m > 1)

    @jax.jit   # one compile of the forward and its backward
    def run(x, g, *w):
        if x.shape[-1] % 128 == 0:
            return (jfwd(x, *w, interpret=True, **kw),
                    jbwd(x, g, *w, interpret=True, **kw))
        out, vjp = jax.vjp(lambda *p: xla(*p, w[4], **kw), x, *w[:4])
        return out, vjp(g)

    return run(*(jax.numpy.asarray(a) for a in arrs))


def _padded_twin(kind, t, heads, m, B):
    """The padded path of the kernels on their twins: ``pad_attention``
    (each head widened to ``core_head_width(d)``, the widths to the tile),
    the twin with the LN over the B real columns and the real d's scale,
    and the cotangents sliced back by ``unpad_attention_grads``."""
    _, _, ref, ref_bwd = PORT[kind]
    x, g, gamma, beta, w_qkv, w_out, bias = t
    Bq = w_qkv.shape[1] // 3
    d = Bq // heads
    xp, gp, bp, wq, wo, hp = port_attn.pad_attention(x, gamma, beta, w_qkv,
                                                     w_out, heads)
    Bp, Bqp = xp.shape[-1], wq.shape[1] // 3
    assert Bqp % 64 == 0 and Bqp <= Bp and Bp % 64 == 0
    assert Bqp // hp == port_attn.core_head_width(d)
    kw = dict(n_heads=hp, partial=m > 1, Bn=B, d=d)
    out = ref(xp, gp, bp, wq, wo, bias, **kw)[..., :B]
    g_p = torch.nn.functional.pad(g, (0, Bp - B))
    grads = ref_bwd(xp, g_p, gp, bp, wq, wo, bias, **kw)
    return out, port_attn.unpad_attention_grads(grads, B, Bq, heads)


def _check(got, want, tol):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want)
    for i, (q, w) in enumerate(zip(got, want)):
        q = q.detach().numpy() if isinstance(q, torch.Tensor) else q
        q, w = np.asarray(q, np.float32), np.asarray(w, np.float32)
        assert q.shape == w.shape, (i, q.shape, w.shape)
        if i == 0:
            q, w = q[:, VALID], w[:, VALID]
        assert np.isfinite(q).all(), i
        assert _rel(q, w) <= tol, (i, _rel(q, w))


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("d", sorted(WIDTHS))
@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_head_width_twins_match_jax(kind, d, m):
    """At head width d, full and on the last shard of two, in f32: the
    kernels' rule takes the sublayer; the twin (unpadded, as the wrappers
    run CPU tensors) against the JAX package (5e-4), forward and every
    cotangent; the padded path against the unpadded twin (1e-5)."""
    arrs, heads, B = _operands(d, m, seed=100 * d + m)
    Bq = arrs[4].shape[1] // 3
    assert Bq // heads == d
    assert port_attn.shape_refusal(kind, B, S, Bq, heads) is None
    fwd, bwd, _, _ = PORT[kind]
    t = [torch.from_numpy(a) for a in arrs]
    kw = dict(n_heads=heads, partial=m > 1)
    x, g, *w = t
    got, got_bwd = fwd(x, *w, **kw), bwd(x, g, *w, **kw)
    want, want_bwd = _jax_reference(kind, arrs, heads, m)
    _check(got, want, JAX_TOL)
    _check(got_bwd, want_bwd, JAX_TOL)
    padded, padded_bwd = _padded_twin(kind, t, heads, m, B)
    _check(padded, got, PAD_TOL)
    _check(padded_bwd, got_bwd, PAD_TOL)


MODELS = {"B96-h2": dict(bottleneck=96, dpt_heads=2, dpt_ff=192),
          "B256-h1": dict(bottleneck=256, dpt_heads=1, dpt_ff=256)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_head_width_models_match_jax(name):
    """One-layer DPTs at ``--B 96 --dpt-heads 2`` (d = 48) and ``--B 256
    --dpt-heads 1`` (d = 256), which no kernel rule refuses: the forward
    through the kernels' CPU twins against the JAX model (XLA, as its own
    CPU tests run the DPT) within 5e-4 on the same weights, 16-frame
    chunks and 199 frames (the padded tail and its key mask on the path);
    and one train step's gradients, leaf by leaf, against ``jax.grad`` at
    the same weights within 1e-5."""
    cfg = ConvTasNetConfig(n_filters=16, kernel_size=8, separator="dpt",
                           dpt_chunk=16, dpt_layers=1, **MODELS[name])
    assert shapes.refusals(cfg) == {}
    assert shapes.refusals(dataclasses.replace(cfg,
                                               compute_dtype="bfloat16")) == {}
    variables = _jax_variables(cfg)
    model = ConvTasNet(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    mix = np.random.default_rng(1).standard_normal((2, 800)).astype(
        np.float32)
    with torch.no_grad():
        w = model.encoder(torch.from_numpy(mix))
        got = model.decoder(w, model.separator(w, True)).numpy()
    jcfg = dataclasses.replace(JaxConfig(**cfg.to_dict()), use_pallas=False)
    apply = jax.jit(functools.partial(jmodel.ConvTasNet(jcfg).apply,
                                      train=False))
    want = np.asarray(apply(variables, jax.numpy.asarray(mix)))
    assert got.shape == want.shape == (2, 2, 800)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)

    # the step's gradients at the same weights (the variables above)
    js = types.SimpleNamespace(params=variables["params"],
                               batch_stats=variables.get("batch_stats", {}))
    ps = pts.create_train_state(jcfg, SOLVER, state_dict=state_dict_from_jax(
        variables, cfg), use_pallas=False)
    jm = jmodel.ConvTasNet(jcfg)
    grads = jax.jit(lambda p, s, b: jts._loss_and_grads(jm, p, s, b, 0)[2])
    _assert_grads_match(js, ps, _batch(71, T=800), jcfg, grads)
