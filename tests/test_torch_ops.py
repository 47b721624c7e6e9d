"""The port's ops and block math against the JAX package's, at rtol 1e-5.

Each case feeds the same seeded numpy arrays to the JAX function and to its
PyTorch counterpart (f32 on CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convtasnet_tpu.config import ConvTasNetConfig
from convtasnet_tpu.models import functional as jfn
from convtasnet_tpu.ops import conv as jconv
from convtasnet_tpu.ops import frames as jframes
from convtasnet_tpu.ops import norm as jnorm
from convtasnet_tpu_torch.models import functional as tfn
from convtasnet_tpu_torch.ops import conv as tconv
from convtasnet_tpu_torch.ops import frames as tframes
from convtasnet_tpu_torch.ops import norm as tnorm

RTOL, ATOL = 1e-5, 1e-6


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("length,step", [(20, 10), (16, 4), (10, 4), (9, 6)])
def test_frames_and_overlap_add(length, step):
    """(20,10) and (16,4): hop divides the frame; (10,4) and (9,6): the
    gather and gcd-subframe paths."""
    x = _rand(2, 3, 203)
    _close(tframes.frame_signal(torch.from_numpy(x), length, step),
           jframes.frame_signal(jnp.asarray(x), length, step))
    f = _rand(2, 3, 41, length, seed=1)
    _close(tframes.overlap_and_add(torch.from_numpy(f), step),
           jframes.overlap_and_add(jnp.asarray(f), step))


def test_frames_reject_bad_shapes():
    with pytest.raises(ValueError):
        tframes.frame_signal(torch.zeros(5), 20, 10)
    with pytest.raises(ValueError):
        tframes.overlap_and_add(torch.zeros(3, 4), 5)


@pytest.mark.parametrize("dilation,causal", [(1, False), (4, False),
                                             (2, True), (16, True)])
def test_depthwise_conv(dilation, causal):
    x, w = _rand(2, 50, 8), _rand(3, 8, seed=1)
    _close(tconv.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                  dilation, causal),
           jconv.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w), dilation,
                                  causal))


def test_pointwise_prelu_xavier():
    x, w = _rand(2, 30, 8), _rand(8, 12, seed=1)
    _close(tconv.pointwise_conv(torch.from_numpy(x), torch.from_numpy(w)),
           jconv.pointwise_conv(jnp.asarray(x), jnp.asarray(w)))
    _close(tconv.prelu(torch.from_numpy(x), torch.tensor(0.25)),
           jconv.prelu(jnp.asarray(x), jnp.float32(0.25)))
    assert tconv.torch_conv_xavier_normal(512, 1, 3) == \
        jconv.torch_conv_xavier_normal(512, 1, 3)
    with pytest.raises(ValueError):
        tconv.depthwise_conv1d(torch.zeros(1, 5, 2), torch.zeros(2, 2), 1,
                               False)


@pytest.mark.parametrize("norm_type", ["gLN", "cLN", "BN"])
def test_norms(norm_type):
    x = 3.0 + _rand(2, 40, 16)
    g, b = _rand(16, seed=1), _rand(16, seed=2)
    m, v = _rand(16, seed=3), np.abs(_rand(16, seed=4)) + 0.5
    t = [torch.from_numpy(a) for a in (x, g, b, m, v)]
    j = [jnp.asarray(a) for a in (x, g, b, m, v)]
    if norm_type == "gLN":
        _close(tnorm.global_layer_norm(*t[:3]), jnorm.global_layer_norm(*j[:3]))
    elif norm_type == "cLN":
        _close(tnorm.channelwise_layer_norm(*t[:3]),
               jnorm.channelwise_layer_norm(*j[:3]))
    else:
        _close(tnorm.batch_norm(*t), jnorm.batch_norm(*j))


CFG = ConvTasNetConfig(n_filters=16, kernel_size=8, bottleneck=12, hidden=20,
                       num_blocks=3, num_repeats=2, num_speakers=3,
                       mask_nonlinear="softmax")


def test_encode_decode_and_masks():
    frames = _rand(2, 30, 8)
    enc = _rand(8, 16, seed=1)
    _close(tfn.encode_frames({"w": torch.from_numpy(enc)},
                             torch.from_numpy(frames)),
           jfn.encode_frames({"w": jnp.asarray(enc)}, jnp.asarray(frames)))
    mw, mask, dec = _rand(2, 30, 16, seed=2), _rand(2, 30, 3, 16, seed=3), \
        _rand(16, 8, seed=4)
    _close(tfn.decode_frames({"w": torch.from_numpy(dec)},
                             torch.from_numpy(mw), torch.from_numpy(mask)),
           jfn.decode_frames({"w": jnp.asarray(dec)}, jnp.asarray(mw),
                             jnp.asarray(mask)))
    score = _rand(2, 30, 48, seed=5)
    for cfg in (CFG, ConvTasNetConfig(n_filters=16, num_speakers=3)):
        _close(tfn.mask_from_scores(cfg, torch.from_numpy(score)),
               jfn.mask_from_scores(cfg, jnp.asarray(score)))
    assert tfn.block_names(CFG) == jfn.block_names(CFG)


def test_separator_forward():
    """The separator skeleton the model runs, with gLN blocks, on the same
    weights."""
    rng = np.random.default_rng(7)
    N, B, H, P = CFG.n_filters, CFG.bottleneck, CFG.hidden, CFG.conv_kernel
    sep = {"bottleneck": rng.standard_normal((N, B)) / 4,
           "mask_conv": rng.standard_normal((B, 3 * N)) / 4}
    for name, _ in jfn.block_names(CFG):
        sep[name] = {"conv1x1": rng.standard_normal((B, H)) / 4,
                     "prelu1": np.array(0.25), "prelu2": np.array(0.1),
                     "dwconv": rng.standard_normal((P, H)),
                     "pwconv": rng.standard_normal((H, B)) / 4}
    sep = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), sep)
    mw = np.abs(_rand(2, 30, N, seed=8))
    ones, zeros = np.ones(H, np.float32), np.zeros(H, np.float32)

    def block_ops(mod_conv, d, gln):
        return dict(
            dwconv=lambda h, w: mod_conv.depthwise_conv1d(h, w, d, False),
            norm1=gln, norm2=gln)

    def run(mod_fn, mod_conv, mod_norm, to):
        gln = lambda h: mod_norm.global_layer_norm(h, to(ones), to(zeros))
        params = jax.tree_util.tree_map(to, sep)
        block_kw = {}
        if mod_fn is tfn:   # the port runs each block through a callable
            block_kw["run_block"] = lambda name, d, y: tfn.block_forward(
                params[name], y, **block_ops(mod_conv, d, gln))
        else:
            block_kw["make_block_ops"] = lambda name, d: block_ops(
                mod_conv, d, gln)
        return mod_fn.separator_forward(
            CFG, params, to(mw),
            input_norm=lambda y: mod_norm.channelwise_layer_norm(
                y, to(np.ones(N, np.float32)), to(np.zeros(N, np.float32))),
            **block_kw)

    got = run(tfn, tconv, tnorm, torch.from_numpy)
    want = run(jfn, jconv, jnorm, jnp.asarray)
    _close(got, want)
