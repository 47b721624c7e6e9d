"""The port's dual-path sublayer twins against the JAX package's Pallas
kernels, run in interpret mode on the CPU, on the same numpy inputs.

``fused_inter_attention``, ``fused_intra_attention`` and ``fused_ffn`` run
their plain twins on CPU tensors; the CUDA kernels themselves are held
against the twins on the card (``tests/test_torch_cuda.py``). Bars:
relative L2 <= 1e-4 in f32 and <= 4e-2 in bf16 (the Pallas probe gate).
Each case runs with the key mask and without it, and with a tail shorter
than one chunk (n = 1 and only part of its frames real).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import dpt_attention as jax_inter
from convtasnet_tpu.ops.pallas import dpt_ffn as jax_ffn
from convtasnet_tpu.ops.pallas import dpt_intra as jax_intra
from convtasnet_tpu_torch.ops.cuda import build
from convtasnet_tpu_torch.ops.cuda import dpt_attention as port_inter
from convtasnet_tpu_torch.ops.cuda import dpt_ffn as port_ffn
from convtasnet_tpu_torch.ops.cuda import dpt_intra as port_intra

B, H_HEADS, F = 128, 4, 256
TOL = {"float32": 1e-4, "bfloat16": 4e-2}
# (M, n, S, valid frames): a masked tail in the last chunk, no mask, and one
# chunk of which only the first 5 frames are real (every key at s >= 5 of
# the inter sublayer masked)
SHAPES = [(2, 3, 16, 3 * 16 - 11), (2, 3, 16, None), (1, 1, 16, 5)]
SHAPE_IDS = ["masked", "unmasked", "shorter-than-a-chunk"]


def _rel(got, want):
    g = np.asarray(got, np.float32).ravel()
    w = np.asarray(want, np.float32).ravel()
    return float(np.linalg.norm(g - w) / (np.linalg.norm(w) + 1e-12))


def _attention_inputs(M, n, S, valid_frames, seed):
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.standard_normal((M, n, S, B)),
        gamma=1 + 0.1 * rng.standard_normal(B),
        beta=0.1 * rng.standard_normal(B),
        w_qkv=rng.standard_normal((B, 3 * B)) / np.sqrt(B),
        w_out=rng.standard_normal((B, B)) / np.sqrt(B))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    valid = None
    if valid_frames is not None:
        valid = np.arange(n * S).reshape(n, S) < valid_frames
        arrs["bias"] = np.where(valid, 0.0, -1e9).astype(np.float32)
    return arrs, valid


def _both(arrs, dtype, names):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    j = [None if arrs.get(k) is None else
         jnp.asarray(arrs[k], jdt if k == "x" else jnp.float32) for k in names]
    t = [None if arrs.get(k) is None else
         torch.from_numpy(arrs[k]).to(tdt if k == "x" else torch.float32)
         for k in names]
    return j, t


ATTN = ("x", "gamma", "beta", "w_qkv", "w_out", "bias")


def _check(got, want, dtype, valid):
    """Holds the valid rows (all rows when nothing is masked)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if valid is not None:
        got, want = got[:, valid], want[:, valid]
    assert np.isfinite(got).all()
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_inter_twin_matches_pallas_interpret(shape, dtype):
    M, n, S, vf = shape
    arrs, valid = _attention_inputs(M, n, S, vf, seed=0)
    j, t = _both(arrs, dtype, ATTN)
    want = jax_inter.fused_inter_attention(*j, n_heads=H_HEADS,
                                           interpret=True)
    got = port_inter.fused_inter_attention(*t, n_heads=H_HEADS)
    assert got.dtype == getattr(torch, dtype)
    _check(got, want, dtype, valid)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_intra_twin_matches_pallas_interpret(shape, dtype):
    M, n, S, vf = shape
    arrs, valid = _attention_inputs(M, n, S, vf, seed=1)
    j, t = _both(arrs, dtype, ATTN)
    want = jax_intra.fused_intra_attention(*j, n_heads=H_HEADS,
                                           interpret=True)
    got = port_intra.fused_intra_attention(*t, n_heads=H_HEADS)
    assert got.dtype == getattr(torch, dtype)
    _check(got, want, dtype, valid)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [48, 5], ids=["rows48", "rows5"])
def test_ffn_twin_matches_pallas_interpret(rows, dtype):
    rng = np.random.default_rng(2)
    arrs = dict(
        x=rng.standard_normal((2, rows, B)),
        gamma=1 + 0.1 * rng.standard_normal(B),
        beta=0.1 * rng.standard_normal(B),
        w_up=rng.standard_normal((B, F)) / np.sqrt(B),
        b_up=0.1 * rng.standard_normal(F),
        w_down=rng.standard_normal((F, B)) / np.sqrt(F),
        b_down=0.1 * rng.standard_normal(B))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    names = ("x", "gamma", "beta", "w_up", "b_up", "w_down", "b_down")
    j, t = _both(arrs, dtype, names)
    want = jax_ffn.fused_ffn(*j, interpret=True)
    got = port_ffn.fused_ffn(*t)
    assert got.dtype == getattr(torch, dtype)
    _check(got, want, dtype, None)


def test_twins_use_gelu_tanh_and_match_xla():
    """The FFN twin is tanh-GELU (jax.nn.gelu's default; torch's default is
    erf), and both attention twins match the XLA sublayers in f32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 7, 64)).astype(np.float32) * 3
    ones, zeros = np.ones(64, np.float32), np.zeros(64, np.float32)
    eye = np.eye(64, dtype=np.float32)
    got = port_ffn.ffn_reference(*(torch.from_numpy(a) for a in
                                   (x, ones, zeros, eye, zeros, eye, zeros)))
    want = jax_ffn.xla_ffn(*(jnp.asarray(a) for a in
                             (x, ones, zeros, eye, zeros, eye, zeros)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    arrs, valid = _attention_inputs(2, 3, 16, 40, seed=4)
    j, t = _both(arrs, "float32", ATTN)
    for port_fn, jax_fn in (
            (port_inter.inter_attention_reference,
             jax_inter.xla_inter_attention),
            (port_intra.intra_attention_reference,
             jax_intra.xla_intra_attention)):
        got = port_fn(*t, n_heads=H_HEADS)
        np.testing.assert_allclose(
            got.numpy()[:, valid], np.asarray(jax_fn(*j, n_heads=H_HEADS))
            [:, valid], rtol=1e-4, atol=1e-4)


def test_pad_content_invariance():
    """Padded frames may hold anything: the valid outputs of each
    attention twin do not change when the pad content does."""
    arrs, valid = _attention_inputs(1, 4, 16, 4 * 16 - 9, seed=5)
    _, t = _both(arrs, "float32", ATTN)
    x2 = t[0].clone()
    x2[:, ~torch.from_numpy(valid)] = 37.0
    for fn in (port_inter.fused_inter_attention,
               port_intra.fused_intra_attention):
        out1 = fn(*t, n_heads=H_HEADS)
        out2 = fn(x2, *t[1:], n_heads=H_HEADS)
        torch.testing.assert_close(out1[:, valid], out2[:, valid],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("wrapper", ["inter", "intra", "ffn"])
def test_cuda_branch_has_no_fallback_and_refuses_autograd(monkeypatch,
                                                          wrapper):
    """On the CPU the wrappers run their twins and count no launch; their
    CUDA branch refuses operands that need a gradient (a bare forward's
    output carries none: training goes through the ``_ad`` sublayers) and
    otherwise builds the library or raises: it never drops back to the
    twin."""

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    for mod in (build, port_inter, port_ffn):
        monkeypatch.setattr(mod, "load_library", broken_loader)
    arrs, _ = _attention_inputs(1, 2, 16, 20, seed=6)
    _, t = _both(arrs, "float32", ATTN)
    if wrapper == "ffn":
        rng = np.random.default_rng(7)
        t = [t[0].reshape(1, 32, B), t[1], t[2],
             torch.from_numpy(rng.standard_normal((B, 64)).astype(np.float32)),
             torch.zeros(64),
             torch.from_numpy(rng.standard_normal((64, B)).astype(np.float32)),
             torch.zeros(B)]
        fused, counter, cuda_branch = (port_ffn.fused_ffn, port_ffn.fused_ffn,
                                       port_ffn._launch_cuda)
        kw = {}
    else:
        fused = (port_inter.fused_inter_attention if wrapper == "inter"
                 else port_intra.fused_intra_attention)
        counter = fused

        def cuda_branch(*a, **k):
            return port_inter.launch_attention(wrapper, *a, **k)

        kw = dict(n_heads=H_HEADS)
    before = counter.launches
    fused(*t, **kw)
    assert counter.launches == before
    t[3].requires_grad_(True)
    with pytest.raises(NotImplementedError, match=f"{wrapper}.*_ad"):
        cuda_branch(*t, **kw)
    with torch.no_grad(), pytest.raises(RuntimeError, match="unavailable"):
        cuda_branch(*t, **kw)
    assert counter.launches == before
