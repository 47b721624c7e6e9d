"""The port's gLN and cLN block backwards against the JAX package's.

``fused_tcn_block_bwd_reference`` (the plain twin of the CUDA backward
kernels, B2 for gLN and B3 for cLN) is held against ``jax.vjp`` of
``_xla_block`` and against the Pallas ``fused_tcn_block_bwd`` run in
interpret mode (``_bwd_kernel`` and ``_bwd_kernel_cln``), on all ten
cotangents, and the differentiable ``fused_tcn_block_ad`` against the JAX
``fused_tcn_block_ad`` on CPU tensors, for both norms. The kernels
themselves are held against the twin on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.ops.pallas import tcn_block as jax_tcn
from convtasnet_tpu.ops.pallas import tcn_block_bwd as jax_bwd
from convtasnet_tpu_torch.ops.cuda import tcn_block as port
from convtasnet_tpu_torch.ops.cuda import tcn_block_bwd as port_bwd

M, K, B, H, P = 2, 300, 32, 64, 3   # K is not a multiple of any tile
ORDER = ("x", "w_in", "dw", "w_out", "a1", "a2", "g1", "b1", "g2", "b2")
NAMES = ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2",
         "dg1", "db1", "dg2", "db2")


def _inputs(seed=0):
    """Seeded f32 block operands and an output cotangent; a2 < 0 exercises
    the sign flip of PReLU' (as tests/test_pallas.py does)."""
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.standard_normal((M, K, B)),
        w_in=rng.standard_normal((B, H)) / np.sqrt(B),
        dw=rng.standard_normal((P, H)),
        w_out=rng.standard_normal((H, B)) / np.sqrt(H),
        a1=np.array(0.25), a2=np.array(-0.1),
        g1=1.0 + 0.3 * rng.standard_normal(H), b1=rng.standard_normal(H),
        g2=1.0 + 0.3 * rng.standard_normal(H), b2=rng.standard_normal(H),
    )
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    g = rng.standard_normal((M, K, B)).astype(np.float32)
    return arrs, g


def _port_grads(arrs, g, causal, d, norm_type):
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    grads = port_bwd.fused_tcn_block_bwd(
        args[0], torch.from_numpy(g), *args[1:], dilation=d, causal=causal,
        norm_type=norm_type)
    return [t.numpy() for t in grads]


def _assert_cotangents(got, want, atol):
    """Each cotangent scaled by its largest entry, as tests/test_pallas.py
    compares the Pallas backward with autodiff."""
    assert len(got) == len(want) == 10
    for name, q, w in zip(NAMES, got, want):
        w = np.asarray(w)
        assert q.shape == w.shape, name
        scale = np.max(np.abs(w)) + 1e-9
        np.testing.assert_allclose(q / scale, w / scale, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
@pytest.mark.parametrize("causal,dilation", [
    (False, 1), (False, 16), (False, 128), (True, 4), (True, 128)])
def test_twin_matches_jax_vjp(causal, dilation, norm_type):
    """d=128 reaches past both ends of K=300 (SAME) or the start (causal)."""
    arrs, g = _inputs(seed=dilation)
    got = _port_grads(arrs, g, causal, dilation, norm_type)

    def block(*a):
        return jax_tcn._xla_block((dilation, causal, norm_type), *a,
                                  jnp.zeros(H), jnp.ones(H),
                                  jnp.zeros(H), jnp.ones(H))

    _, vjp = jax.vjp(block, *[jnp.asarray(arrs[n]) for n in ORDER])
    # f32 autodiff of the same math on both sides: the bar is rounding
    _assert_cotangents(got, vjp(jnp.asarray(g)), atol=2e-5)


@pytest.mark.parametrize("norm_type", ["gLN", "cLN"])
@pytest.mark.parametrize("causal,dilation", [(False, 4), (True, 2),
                                             (False, 64)])
def test_twin_matches_pallas_interpret(causal, dilation, norm_type):
    arrs, g = _inputs(seed=100 + dilation)
    got = _port_grads(arrs, g, causal, dilation, norm_type)
    want = jax_bwd.fused_tcn_block_bwd(
        jnp.asarray(arrs["x"]), jnp.asarray(g),
        *[jnp.asarray(arrs[n]) for n in ORDER[1:]], dilation=dilation,
        causal=causal, norm_type=norm_type, tile=128, interpret=True)
    # the bar of tests/test_pallas.py for the Pallas backward against
    # autodiff (it takes its statistics as E[h^2]-mean^2 in one pass)
    _assert_cotangents(got, want, atol=5e-5)


# cLN takes seed 8: at seed 7 its da1 nearly cancels, and JAX's own two
# evaluations (Pallas and _xla_block) part by 6.6e-5 of it
@pytest.mark.parametrize("norm_type,causal,seed", [("gLN", False, 7),
                                                   ("cLN", True, 8)])
def test_fused_block_ad_matches_jax(norm_type, causal, seed):
    """Gradients of a scalar loss through the differentiable block, with
    respect to x and all nine weights, against JAX's fused_tcn_block_ad
    (Pallas forward and backward in interpret mode)."""
    arrs, w = _inputs(seed=seed)
    d = 8

    def jax_loss(*a):
        out = jax_tcn.fused_tcn_block_ad(
            *a, dilation=d, causal=causal, norm_type=norm_type, tile=128,
            interpret=True, bwd="store")
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jax_loss, argnums=tuple(range(10)))(
        *[jnp.asarray(arrs[n]) for n in ORDER])
    prims = [torch.from_numpy(arrs[n]).requires_grad_(True) for n in ORDER]
    out = port.fused_tcn_block_ad(*prims, dilation=d, causal=causal,
                                  norm_type=norm_type)
    (out * torch.from_numpy(w)).sum().backward()
    got = [p.grad.numpy() for p in prims]
    assert out.dtype == torch.float32 and out.shape == (M, K, B)
    _assert_cotangents(got, want, atol=5e-5)


def test_wrapper_uses_twin_on_cpu_tensors():
    arrs, g = _inputs(seed=2)
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    before = port_bwd.fused_tcn_block_bwd.launches
    got = port_bwd.fused_tcn_block_bwd(args[0], torch.from_numpy(g),
                                       *args[1:], dilation=2, causal=False)
    want = port_bwd.fused_tcn_block_bwd_reference(
        args[0], torch.from_numpy(g), *args[1:], dilation=2, causal=False,
        norm_type="gLN")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert port_bwd.fused_tcn_block_bwd.launches == before


def test_cuda_branch_has_no_fallback(monkeypatch):
    """With the kernel library unavailable the CUDA branch raises: it never
    drops back to the twin, and counts no launch."""

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port_bwd, "load_library", broken_loader)
    arrs, g = _inputs(seed=3)
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    before = port_bwd.fused_tcn_block_bwd.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        port_bwd._launch_cuda(args[0], torch.from_numpy(g), *args[1:],
                              dilation=1, causal=False)
    assert port_bwd.fused_tcn_block_bwd.launches == before


@pytest.mark.parametrize("norm_type", ["cLN", "BN"])
def test_backward_takes_gln_only(norm_type):
    """The backward takes gLN and cLN: on CPU tensors the cLN wrapper is
    its twin, with no launch counted; BN raises in the wrapper and in the
    differentiable block."""
    arrs, g = _inputs(seed=4)
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    kw = dict(dilation=1, causal=True, norm_type=norm_type)
    if norm_type == "cLN":
        before = port_bwd.fused_tcn_block_bwd.cln_launches
        got = port_bwd.fused_tcn_block_bwd(args[0], torch.from_numpy(g),
                                           *args[1:], **kw)
        want = port_bwd.fused_tcn_block_bwd_reference(
            args[0], torch.from_numpy(g), *args[1:], **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert port_bwd.fused_tcn_block_bwd.cln_launches == before
        return
    with pytest.raises(NotImplementedError, match="BN blocks train"):
        port_bwd.fused_tcn_block_bwd(args[0], torch.from_numpy(g), *args[1:],
                                     **kw)
    with pytest.raises(NotImplementedError, match="BN blocks train"):
        port.fused_tcn_block_ad(*args, **kw)


@pytest.mark.parametrize("norm_type,strict,route", [
    ("gLN", True, "kernel"), ("gLN", False, "kernel"),
    ("cLN", True, "kernel"), ("cLN", False, "kernel"),
    ("BN", True, "plain"), ("BN", False, "plain"),
])
def test_block_training_route_by_norm(monkeypatch, norm_type, strict, route):
    """A block in training with the kernels in use: gLN and cLN run
    fused_tcn_block_ad (here on CPU tensors, i.e. the twins), BN trains
    through the plain ops with batch statistics; the gradients equal the
    plain path's. A model with use_pallas=True (``strict``) needs CUDA
    tensors for any norm."""
    from convtasnet_tpu.config import ConvTasNetConfig
    from convtasnet_tpu_torch.models import conv_tasnet as pmodel

    cfg = ConvTasNetConfig(bottleneck=B, hidden=H, norm_type=norm_type,
                           causal=norm_type == "cLN")
    calls = []
    real = pmodel.fused_tcn_block_ad
    monkeypatch.setattr(pmodel, "fused_tcn_block_ad",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.from_numpy(_inputs(seed=9)[0]["x"])

    def grads(use_kernel):
        block = pmodel.TemporalBlock(cfg, 4, torch.Generator().manual_seed(1))
        block.train()
        block(x, use_kernel).square().mean().backward()
        return [p.grad for p in block.parameters()]

    if strict:
        tiny = ConvTasNetConfig(n_filters=16, kernel_size=8, bottleneck=B,
                                hidden=H, num_blocks=1, num_repeats=1,
                                norm_type=norm_type)
        model = pmodel.ConvTasNet(tiny, use_pallas=True).train()
        mixture = torch.from_numpy(
            np.random.default_rng(9).standard_normal((2, 64)).astype(
                np.float32))
        with pytest.raises(ValueError, match="CUDA tensors"):
            model(mixture)      # the kernels need the card, as in eval
    got = grads(True)
    assert len(calls) == (route == "kernel")
    for g, w in zip(got, grads(False)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
