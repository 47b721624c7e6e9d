"""The port's TCN-block module against the JAX package's block.

``fused_tcn_block_reference`` (the plain twin of the CUDA kernel) is held
against the JAX ``_xla_block`` math and against the Pallas kernel
``fused_tcn_block`` run in interpret mode, on the same numpy inputs. On CPU
tensors the port's ``fused_tcn_block`` is the twin; its CUDA branch
launches the kernel or raises, with no fallback (checked here with the
library loader made to fail). The kernel itself is held against the twin
on the card in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig
from convtasnet_tpu.ops.pallas import tcn_block as jax_tcn
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.ops.cuda import tcn_block as port

M, K, B, H, P = 2, 300, 32, 64, 3   # K is not a multiple of any tile

CASES = [
    (norm, causal, d)
    for norm, causal in [("gLN", False), ("gLN", True), ("cLN", False),
                         ("cLN", True), ("BN", False)]
    for d in (1, 4, 16)
]
# The interpret-mode Pallas kernel is slow on the CPU: one dilation per
# norm, so that d = 1, 4 and 16 each still appear.
INTERPRET_CASES = [("gLN", False, 16), ("gLN", True, 4), ("cLN", False, 1),
                   ("cLN", True, 16), ("BN", False, 4)]


def _inputs(norm_type, seed=0):
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.standard_normal((M, K, B)),
        w_in=rng.standard_normal((B, H)) / np.sqrt(B),
        dw=rng.standard_normal((P, H)),
        w_out=rng.standard_normal((H, B)) / np.sqrt(H),
        a1=np.array(0.25), a2=np.array(0.3),
        g1=rng.standard_normal(H), b1=rng.standard_normal(H),
        g2=rng.standard_normal(H), b2=rng.standard_normal(H),
    )
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    bn = None
    if norm_type == "BN":
        bn = tuple((np.abs(rng.standard_normal(H)) + 0.5).astype(np.float32)
                   for _ in range(4))
    return arrs, bn


ORDER = ("x", "w_in", "dw", "w_out", "a1", "a2", "g1", "b1", "g2", "b2")


def _port_block(arrs, bn, norm_type, causal, d):
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    bn_t = None if bn is None else tuple(torch.from_numpy(s) for s in bn)
    return port.fused_tcn_block_reference(
        *args, dilation=d, causal=causal, norm_type=norm_type,
        bn_stats=bn_t).numpy()


@pytest.mark.parametrize("norm_type,causal,dilation", CASES)
def test_twin_matches_jax_xla_block(norm_type, causal, dilation):
    arrs, bn = _inputs(norm_type)
    got = _port_block(arrs, bn, norm_type, causal, dilation)
    stats = bn if bn is not None else (np.zeros(H, np.float32),
                                       np.ones(H, np.float32)) * 2
    want = jax_tcn._xla_block(
        (dilation, causal, norm_type),
        *[jnp.asarray(arrs[n]) for n in ORDER],
        *[jnp.asarray(s) for s in stats])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("norm_type,causal,dilation", INTERPRET_CASES)
def test_twin_matches_pallas_interpret(norm_type, causal, dilation):
    arrs, bn = _inputs(norm_type, seed=1)
    got = _port_block(arrs, bn, norm_type, causal, dilation)
    want = jax_tcn.fused_tcn_block(
        *[jnp.asarray(arrs[n]) for n in ORDER], dilation=dilation,
        causal=causal, norm_type=norm_type,
        bn_stats=None if bn is None else tuple(jnp.asarray(s) for s in bn),
        tile=128, interpret=True)
    # The bar of tests/test_pallas.py: the Pallas kernel computes its norm
    # statistics as E[h^2]-mean^2 in one pass and folds gLN into the conv
    # taps and W_out, so it rounds differently from the two-pass plain math.
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-2, atol=2e-2)


def test_wrapper_uses_twin_on_cpu_tensors():
    arrs, _ = _inputs("gLN", seed=2)
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    before = port.fused_tcn_block.launches
    got = port.fused_tcn_block(*args, dilation=2, causal=False,
                               norm_type="gLN")
    want = port.fused_tcn_block_reference(*args, dilation=2, causal=False,
                                          norm_type="gLN")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert port.fused_tcn_block.launches == before


def test_cuda_branch_has_no_fallback(monkeypatch):
    """With the kernel library unavailable the CUDA branch raises: it never
    drops back to the plain twin, and counts no launch."""

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port, "load_library", broken_loader)
    arrs, _ = _inputs("gLN", seed=3)
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    before = port.fused_tcn_block.launches
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        port._launch_cuda(*args, dilation=1, causal=False, norm_type="gLN",
                          bn_stats=None)
    assert port.fused_tcn_block.launches == before


def test_cuda_branch_refuses_autograd(monkeypatch):
    """The kernel has no backward yet: with grad enabled and an operand
    that requires grad, the CUDA branch raises before it builds or
    launches; under no_grad it goes on to the (here broken) loader."""

    def broken_loader():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(port, "load_library", broken_loader)
    arrs, _ = _inputs("gLN", seed=4)
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    args[1].requires_grad_(True)
    kw = dict(dilation=1, causal=False, norm_type="gLN", bn_stats=None)
    with pytest.raises(NotImplementedError, match="forward only"):
        port._launch_cuda(*args, **kw)
    with torch.no_grad(), pytest.raises(RuntimeError, match="unavailable"):
        port._launch_cuda(*args, **kw)


def test_model_with_kernel_forced_raises_on_cpu():
    cfg = ConvTasNetConfig(n_filters=16, kernel_size=8, bottleneck=8,
                           hidden=16, num_blocks=2, num_repeats=1)
    mix = torch.zeros(1, 800)
    with pytest.raises(ValueError, match="CUDA"):
        ConvTasNet(dataclasses.replace(cfg, use_pallas=True))(mix)
    with pytest.raises(ValueError, match="CUDA"):
        ConvTasNet(cfg, use_pallas=True)(mix)


def test_wrapper_rejects_unknown_norm():
    arrs, _ = _inputs("gLN")
    args = [torch.from_numpy(arrs[n]) for n in ORDER]
    with pytest.raises(ValueError, match="norm_type"):
        port.fused_tcn_block(*args, dilation=1, causal=False, norm_type="LN")
    with pytest.raises(ValueError, match="bn_stats"):
        port.fused_tcn_block(*args, dilation=1, causal=False, norm_type="BN")
