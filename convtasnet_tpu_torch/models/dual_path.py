"""The dual-path attention separator (``cfg.separator == "dpt"``) in PyTorch.

Counterpart of ``convtasnet_tpu/models/dual_path.py``: encoder frames
[M, K, N] -> input LN -> bottleneck N->B -> pad K to n*S frames and view
them as n chunks [M, n, S, B] -> sinusoidal encodings of the position in
the chunk and of the chunk index -> ``dpt_layers`` dual-path layers (each
an intra-chunk attention, an FFN, an inter-chunk attention and an FFN
sublayer, all pre-LN with a residual) -> output LN -> drop the padded
frames -> ReLU -> mask head -> masks [M, K, C, N]. Padded frames are masked
out of every softmax with an additive -1e9 key bias, so the valid outputs
do not depend on the pad content.

Each parameter's state_dict name is its flax path
(``separator.layer_{i}.intra_att.qkv.kernel``, ``...intra_ffn.up.bias``,
``separator.mask_conv``, ...), so ``models/jax_params.py`` carries weights
over one leaf at a time. With ``use_kernel`` the sublayers run the CUDA
kernels (``ops/cuda/dpt_{intra,attention,ffn}.py``): the bare forward
kernels when no gradient is needed, and when one is, the differentiable
``fused_{intra_attention,inter_attention,ffn}_ad``, whose backwards are the
kernels B10, B8 and B12. Without it they run their plain twins.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.functional import mask_from_scores
from convtasnet_tpu_torch.ops.conv import pointwise_conv
from convtasnet_tpu_torch.ops.cuda.dpt_attention import (
    NEG_INF,
    fused_inter_attention,
    fused_inter_attention_ad,
    inter_attention_reference,
    needs_grad,
)
from convtasnet_tpu_torch.ops.cuda.dpt_ffn import (
    ffn_reference,
    fused_ffn,
    fused_ffn_ad,
)
from convtasnet_tpu_torch.ops.cuda.dpt_intra import (
    fused_intra_attention,
    fused_intra_attention_ad,
    intra_attention_reference,
)
from convtasnet_tpu_torch.ops.norm import layer_norm

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def sinusoid_encoding(length: int, dim: int) -> np.ndarray:
    """Fixed sin/cos positional table [length, dim] (f32)."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / dim)
    enc = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return enc.astype(np.float32)


def _lecun_normal(shape, generator: torch.Generator, device) -> nn.Parameter:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=generator)
    return nn.Parameter((w / (math.sqrt(shape[0]) * _TRUNC_STD)).to(device))


class _LayerNorm(nn.Module):
    """Pre-LN over the last axis, f32 statistics, eps 1e-6; gamma 1,
    beta 0."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(features, device=device))
        self.beta = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.beta)


class _Kernel(nn.Module):
    """One projection matrix under the flax name ``<name>.kernel``."""

    def __init__(self, shape, generator, device=None):
        super().__init__()
        self.kernel = _lecun_normal(shape, generator, device)


class _Dense(_Kernel):
    """A projection matrix and its bias: ``<name>.kernel``, ``<name>.bias``
    (bias 0)."""

    def __init__(self, shape, generator, device=None):
        super().__init__(shape, generator, device)
        self.bias = nn.Parameter(torch.zeros(shape[1], device=device))


# each sublayer's (plain twin, forward kernel, differentiable kernel pair)
_SUBLAYER_FNS = {
    "intra": (intra_attention_reference, fused_intra_attention,
              fused_intra_attention_ad),
    "inter": (inter_attention_reference, fused_inter_attention,
              fused_inter_attention_ad),
    "ffn": (ffn_reference, fused_ffn, fused_ffn_ad),
}


def sublayer_fn(kind: str, use_kernel: bool, args):
    """What runs one sublayer (``kind`` "intra", "inter" or "ffn") on
    ``args``: its plain twin, or with ``use_kernel`` its CUDA kernel, the
    differentiable ``fused_*_ad`` where a gradient is needed."""
    plain, fused, fused_ad = _SUBLAYER_FNS[kind]
    return (plain if not use_kernel
            else fused_ad if needs_grad(*args) else fused)


class _AttentionSublayer(nn.Module):
    """Pre-LN multi-head self-attention + residual on [M, n, S, B]:
    ``attend_axis`` 2 mixes within each chunk (intra), 1 across chunks at
    each in-chunk position (inter)."""

    def __init__(self, features: int, n_heads: int, attend_axis: int,
                 generator, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.attend_axis = attend_axis
        self.norm = _LayerNorm(features, device)
        self.qkv = _Kernel((features, 3 * features), generator, device)
        self.out = _Kernel((features, features), generator, device)

    def forward(self, x, key_bias, use_kernel: bool):
        args = (x, self.norm.gamma, self.norm.beta, self.qkv.kernel,
                self.out.kernel, key_bias)
        kind = "intra" if self.attend_axis == 2 else "inter"
        return sublayer_fn(kind, use_kernel, args)(*args,
                                                   n_heads=self.n_heads)


class _FFNSublayer(nn.Module):
    """Pre-LN GELU (tanh) MLP + residual on [M, n, S, B]."""

    def __init__(self, features: int, ff: int, generator, device=None):
        super().__init__()
        self.norm = _LayerNorm(features, device)
        self.up = _Dense((features, ff), generator, device)
        self.down = _Dense((ff, features), generator, device)

    def forward(self, x, use_kernel: bool):
        M, n, S, B = x.shape
        args = (x.reshape(M, n * S, B), self.norm.gamma, self.norm.beta,
                self.up.kernel, self.up.bias, self.down.kernel,
                self.down.bias)
        return sublayer_fn("ffn", use_kernel, args)(*args).reshape(
            M, n, S, B)


class DualPathLayer(nn.Module):
    """Intra-chunk attention, FFN, inter-chunk attention, FFN."""

    def __init__(self, features: int, n_heads: int, ff: int, generator,
                 device=None):
        super().__init__()
        self.intra_att = _AttentionSublayer(features, n_heads, 2, generator,
                                            device)
        self.intra_ffn = _FFNSublayer(features, ff, generator, device)
        self.inter_att = _AttentionSublayer(features, n_heads, 1, generator,
                                            device)
        self.inter_ffn = _FFNSublayer(features, ff, generator, device)

    def forward(self, x, key_bias, use_kernel: bool):
        x = self.intra_att(x, key_bias, use_kernel)
        x = self.intra_ffn(x, use_kernel)
        x = self.inter_att(x, key_bias, use_kernel)
        return self.inter_ffn(x, use_kernel)


class DualPathSeparator(nn.Module):
    """Encoder frames [M, K, N] -> masks [M, K, C, N]; the contract of
    ``TemporalConvNet``."""

    def __init__(self, cfg: ConvTasNetConfig, generator, device=None):
        super().__init__()
        self.cfg = cfg
        N, B, C = cfg.n_filters, cfg.bottleneck, cfg.num_speakers
        self.input_norm = _LayerNorm(N, device)
        self.bottleneck = _Kernel((N, B), generator, device)
        for i in range(cfg.dpt_layers):
            self.add_module(f"layer_{i}", DualPathLayer(
                B, cfg.dpt_num_heads, cfg.dpt_ff, generator, device))
        self.output_norm = _LayerNorm(B, device)
        w = torch.randn((B, C * N), generator=generator) * math.sqrt(
            2.0 / (B + C * N))
        self.mask_conv = nn.Parameter(w.to(device))

    def forward(self, mixture_w: torch.Tensor,
                use_kernel: bool) -> torch.Tensor:
        leaves = {name: p for name, p in self.named_parameters()
                  if not name.startswith("layer_")}
        return dual_path_forward(
            self.cfg, leaves, mixture_w,
            lambda i, x, key_bias: getattr(self, f"layer_{i}")(
                x, key_bias, use_kernel))


def dual_path_forward(cfg: ConvTasNetConfig, leaves, mixture_w: torch.Tensor,
                      run_layer) -> torch.Tensor:
    """The separator around its layers: encoder frames [M, K, N] -> masks
    [M, K, C, N]. ``leaves`` maps the separator's own leaves
    (``input_norm.gamma``, ``bottleneck.kernel``, ``output_norm.beta``,
    ``mask_conv``, ...); ``run_layer(i, x, key_bias)`` runs dual-path layer
    i on x [M, n, S, B], whole (``DualPathSeparator``) or split over shards
    (``parallel/dpt_tp.py``)."""
    B, S = cfg.bottleneck, cfg.dpt_chunk
    M, K, _ = mixture_w.shape
    y = layer_norm(mixture_w, leaves["input_norm.gamma"],
                   leaves["input_norm.beta"])
    y = y @ leaves["bottleneck.kernel"].to(y.dtype)
    n = -(-K // S)
    Kp = n * S
    y = torch.nn.functional.pad(y, (0, 0, 0, Kp - K))
    x = y.reshape(M, n, S, B)
    dev = x.device
    valid = torch.arange(Kp, device=dev).reshape(n, S) < K
    key_bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    intra_pos = torch.from_numpy(sinusoid_encoding(S, B)).to(dev, x.dtype)
    inter_pos = torch.from_numpy(sinusoid_encoding(n, B)).to(dev, x.dtype)
    x = x + intra_pos[None, None] + inter_pos[None, :, None]
    for i in range(cfg.dpt_layers):
        x = run_layer(i, x, key_bias)
    x = layer_norm(x, leaves["output_norm.gamma"],
                   leaves["output_norm.beta"]).reshape(M, Kp, B)[:, :K]
    score = pointwise_conv(torch.relu(x), leaves["mask_conv"].to(x.dtype))
    return mask_from_scores(cfg, score)
