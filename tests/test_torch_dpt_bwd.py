"""The port's dual-path sublayer backwards against the JAX package's Pallas
backward kernels, run in interpret mode on the CPU, on the same numpy
inputs.

``fused_inter_attention_bwd``, ``fused_intra_attention_bwd`` and
``fused_ffn_bwd`` run their plain twins on CPU tensors, and so do the
differentiable ``_ad`` sublayers; the CUDA kernels B8, B10 and B12 are
held against the twins on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). The cotangent is random and zero on the padded rows,
as the model delivers it. Every cotangent is compared by relative L2:
<= 1e-4 in f32 (the JAX package's own VJP gate, ``tests/test_dpt_pallas.py``)
and <= 4e-2 in bf16; dx on the valid rows (all rows when nothing is
masked), the parameter cotangents whole.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu.ops.pallas import dpt_ffn as jax_ffn
from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_inter
from convtasnet_tpu_torch.ops.cuda import dpt_ffn as port_ffn
from convtasnet_tpu_torch.ops.cuda import dpt_intra as port_intra

B, H_HEADS, F = 128, 4, 256
TOL = {"float32": 1e-4, "bfloat16": 4e-2}
# (M, n, S, valid frames), as tests/test_torch_dpt_ops.py: a masked tail in
# the last chunk, no mask, and one chunk of which the first 5 frames are real
SHAPES = [(2, 3, 16, 3 * 16 - 11), (2, 3, 16, None), (1, 1, 16, 5)]
SHAPE_IDS = ["masked", "unmasked", "shorter-than-a-chunk"]
ATTN_GRADS = ("dx", "dgamma", "dbeta", "dw_qkv", "dw_out")
FFN_GRADS = ("dx", "dgamma", "dbeta", "dw_up", "db_up", "dw_down", "db_down")
KINDS = {
    "inter": (jax_inter.fused_inter_attention_bwd,
              port_inter.fused_inter_attention_bwd,
              port_inter.fused_inter_attention_ad,
              port_inter.inter_attention_reference),
    "intra": (jax_intra.fused_intra_attention_bwd,
              port_intra.fused_intra_attention_bwd,
              port_intra.fused_intra_attention_ad,
              port_intra.intra_attention_reference),
}


def _rel(got, want):
    g = np.asarray(got, np.float32).ravel()
    w = np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


def _inputs(M, n, S, valid_frames, seed):
    """Attention operands, a cotangent zeroed on the padded rows, and the
    valid-frame mask [n, S] (None when nothing is masked)."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.standard_normal((M, n, S, B)),
        g=rng.standard_normal((M, n, S, B)),
        gamma=1 + 0.1 * rng.standard_normal(B),
        beta=0.1 * rng.standard_normal(B),
        w_qkv=rng.standard_normal((B, 3 * B)) / np.sqrt(B),
        w_out=rng.standard_normal((B, B)) / np.sqrt(B))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    valid = None
    if valid_frames is not None:
        valid = np.arange(n * S).reshape(n, S) < valid_frames
        arrs["bias"] = np.where(valid, 0.0, -1e9).astype(np.float32)
        arrs["g"] = arrs["g"] * valid[None, :, :, None]
    return arrs, valid


def _both(arrs, dtype, names):
    """The same arrays for JAX and torch: x and g in ``dtype``, the rest
    f32 (as the model keeps its parameters)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    act = ("x", "g")
    j = [None if arrs.get(k) is None else
         jnp.asarray(arrs[k], jdt if k in act else jnp.float32) for k in names]
    t = [None if arrs.get(k) is None else
         torch.from_numpy(arrs[k]).to(tdt if k in act else torch.float32)
         for k in names]
    return j, t


def _check(got, want, names, dtype, valid):
    assert len(got) == len(want) == len(names)
    for name, q, w in zip(names, got, want):
        q = q.float().numpy()
        w = np.asarray(w, np.float32)
        assert q.shape == w.shape, name
        if name == "dx" and valid is not None:
            q, w = q[:, valid], w[:, valid]
        assert np.isfinite(q).all(), name
        err = _rel(q, w)
        assert err <= TOL[dtype], f"{name}: rel_l2 {err:.3e}"


ATTN = ("x", "g", "gamma", "beta", "w_qkv", "w_out", "bias")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_attention_bwd_twin_matches_pallas_interpret(kind, shape, dtype):
    M, n, S, vf = shape
    arrs, valid = _inputs(M, n, S, vf, seed=10 + n)
    j, t = _both(arrs, dtype, ATTN)
    jax_bwd, port_bwd, _, _ = KINDS[kind]
    want = jax_bwd(*j, n_heads=H_HEADS, interpret=True)
    got = port_bwd(*t, n_heads=H_HEADS)
    assert got[0].dtype == getattr(torch, dtype)
    assert all(q.dtype == torch.float32 for q in got[1:])
    _check(got, want, ATTN_GRADS, dtype, valid)


def _ffn_inputs(rows, seed):
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.standard_normal((2, rows, B)),
        g=rng.standard_normal((2, rows, B)),
        gamma=1 + 0.1 * rng.standard_normal(B),
        beta=0.1 * rng.standard_normal(B),
        w_up=rng.standard_normal((B, F)) / np.sqrt(B),
        b_up=0.1 * rng.standard_normal(F),
        w_down=rng.standard_normal((F, B)) / np.sqrt(F),
        b_down=0.1 * rng.standard_normal(B))
    return {k: v.astype(np.float32) for k, v in arrs.items()}


FFN = ("x", "g", "gamma", "beta", "w_up", "b_up", "w_down", "b_down")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [48, 5], ids=["rows48", "rows5"])
def test_ffn_bwd_twin_matches_pallas_interpret(rows, dtype):
    """The FFN is row-local: no mask, every row compared."""
    j, t = _both(_ffn_inputs(rows, seed=20 + rows), dtype, FFN)
    want = jax_ffn.fused_ffn_bwd(*j, interpret=True)
    got = port_ffn.fused_ffn_bwd(*t)
    assert got[0].dtype == getattr(torch, dtype)
    _check(got, want, FFN_GRADS, dtype, None)


def _grads(fn, prims, const, g, **kw):
    leaves = [p.detach().clone().requires_grad_(True) for p in prims]
    fn(*leaves, *const, **kw).backward(g)
    return [p.grad for p in leaves]


@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_ad_sublayers_match_autograd_of_the_forward_twins(kind):
    """In f32 the backward twins are the exact derivatives of the forward
    twins: autograd through each ``_ad`` sublayer (its CPU path runs the
    twins) against autograd through the plain forward, to 1e-5, with the
    gradients in each primal's dtype and none for the key bias."""
    if kind == "ffn":
        _, t = _both(_ffn_inputs(24, seed=30), "float32", FFN)
        x, g, *w = t
        prims, const, kw = [x, *w], [], {}
        ad, plain = port_ffn.fused_ffn_ad, port_ffn.ffn_reference
    else:
        arrs, _ = _inputs(2, 3, 16, 3 * 16 - 7, seed=31)
        _, t = _both(arrs, "float32", ATTN)
        x, g, *w, bias = t
        bias.requires_grad_(True)
        prims, const, kw = [x, *w], [bias], dict(n_heads=H_HEADS)
        _, _, ad, plain = KINDS[kind]
    got = _grads(ad, prims, const, g, **kw)
    if const:
        assert bias.grad is None
        bias.requires_grad_(False)
    want = _grads(plain, prims, const, g, **kw)
    for q, r in zip(got, want):
        assert q.dtype == r.dtype == torch.float32
        assert _rel(q.numpy(), r.numpy()) <= 1e-5


@pytest.mark.parametrize("kind", ["inter", "intra", "ffn"])
def test_bwd_cuda_branch_has_no_fallback(monkeypatch, kind):
    """On CPU tensors the backward wrappers run their twins and count no
    launch; their CUDA branch builds the library or raises, and never drops
    back to the twin."""
    from convtasnet_tpu_torch.ops.cuda import build

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    for mod in (build, port_inter, port_ffn):
        monkeypatch.setattr(mod, "load_library", broken_loader)
    if kind == "ffn":
        _, t = _both(_ffn_inputs(5, seed=40), "float32", FFN)
        fused, cuda_branch, kw = (port_ffn.fused_ffn_bwd,
                                  port_ffn._launch_cuda_bwd, {})
    else:
        arrs, _ = _inputs(1, 2, 16, 20, seed=41)
        _, t = _both(arrs, "float32", ATTN)
        fused = KINDS[kind][1]
        kw = dict(n_heads=H_HEADS)

        def cuda_branch(*a, **k):
            return port_inter.launch_attention_bwd(kind, *a, **k)

    before = fused.launches
    fused(*t, **kw)
    assert fused.launches == before
    with pytest.raises(RuntimeError, match="unavailable"):
        cuda_branch(*t, **kw)
    assert fused.launches == before
