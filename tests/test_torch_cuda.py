"""The CUDA TCN-block kernel against its plain twin, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs on a machine with only torch and the
CUDA toolkit (``tests/conftest.py`` imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bars: relative L2 <= 4e-2 in bf16 and <= 2e-3 in f32, those of the JAX
package's Pallas probe gate (``tcn_block.py`` ``_numerics_tol``).
"""

import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
from convtasnet_tpu_torch.ops.cuda import tcn_block as port

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-3, torch.bfloat16: 4e-2}
CASES = [
    (norm, causal, d)
    for norm, causal in [("gLN", False), ("gLN", True), ("cLN", False),
                         ("cLN", True), ("BN", False), ("BN", True)]
    for d in (1, 4, 128)
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _block_args(device, dtype, norm_type, m=2, k=300, b=64, h=128, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    args = (t(rng.standard_normal((m, k, b)), dtype),
            t(rng.standard_normal((b, h)) / np.sqrt(b), dtype),
            t(rng.standard_normal((3, h)), dtype),
            t(rng.standard_normal((h, b)) / np.sqrt(h), dtype),
            t(0.25), t(0.3),
            t(rng.standard_normal(h)), t(rng.standard_normal(h)),
            t(rng.standard_normal(h)), t(rng.standard_normal(h)))
    bn = None
    if norm_type == "BN":
        bn = tuple(t(np.abs(rng.standard_normal(h)) + 0.5) for _ in range(4))
    return args, bn


def _rel_l2(got, want):
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm_type,causal,dilation", CASES)
def test_kernel_matches_twin(cuda, dtype, norm_type, causal, dilation):
    """K=300 is not a multiple of any tile; d=128 reaches past both ends."""
    args, bn = _block_args(cuda, dtype, norm_type)
    kw = dict(dilation=dilation, causal=causal, norm_type=norm_type,
              bn_stats=bn)
    before = port.fused_tcn_block.launches
    got = port.fused_tcn_block(*args, **kw)
    torch.cuda.synchronize()
    assert port.fused_tcn_block.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got).all()
    want = port.fused_tcn_block_reference(*args, **kw)
    assert _rel_l2(got, want) <= TOL[dtype]


def test_kernel_is_deterministic(cuda):
    args, _ = _block_args(cuda, torch.bfloat16, "gLN", m=4, k=1000)
    kw = dict(dilation=8, causal=False, norm_type="gLN")
    a = port.fused_tcn_block(*args, **kw)
    b = port.fused_tcn_block(*args, **kw)
    assert torch.equal(a, b)


def test_kernel_rejects_untiled_widths(cuda):
    args, _ = _block_args(cuda, torch.float32, "gLN", b=32, h=64)
    with pytest.raises(ValueError, match="multiples"):
        port.fused_tcn_block(*args, dilation=1, causal=False,
                             norm_type="gLN")


def test_kernel_path_refuses_autograd(cuda):
    """The kernel is forward only; with grad enabled the model raises
    instead of returning an output that carries no gradient."""
    cfg = ConvTasNetConfig(n_filters=64, bottleneck=64, hidden=128,
                           num_blocks=2, num_repeats=1)
    model = ConvTasNet(cfg, use_pallas=True, device=cuda)
    with pytest.raises(NotImplementedError, match="forward only"):
        model(torch.zeros(1, 800, device=cuda))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_kernel_path_matches_plain_path(cuda, dtype):
    cfg = ConvTasNetConfig(n_filters=64, bottleneck=64, hidden=128,
                           num_blocks=4, num_repeats=2, compute_dtype=dtype)
    mix = torch.randn(2, 8000, generator=torch.Generator().manual_seed(1))
    mix = mix.to(cuda)
    outs = {}
    for use in (True, False):
        model = ConvTasNet(cfg, use_pallas=use, device=cuda).eval()
        before = port.fused_tcn_block.launches
        with torch.inference_mode():
            outs[use] = model(mix)
        launched = port.fused_tcn_block.launches - before
        assert launched == (cfg.num_blocks * cfg.num_repeats if use else 0)
    assert outs[True].dtype == torch.float32
    assert _rel_l2(outs[True], outs[False]) <= TOL[getattr(torch, dtype)]
