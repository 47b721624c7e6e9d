"""Convolutions on channels-last ``[..., K, C]`` tensors.

Counterpart of ``convtasnet_tpu/ops/conv.py``: a 1x1 conv is a matmul over
the channel axis, the depthwise dilated conv is P shifted multiply-adds
(causal pads on the left only), and PReLU has one shared slope.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pointwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1x1 conv: ``[..., K, Cin] @ [Cin, Cout] -> [..., K, Cout]``."""
    return x @ w


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, dilation: int,
                     causal: bool) -> torch.Tensor:
    """Depthwise dilated conv with SAME output length.

    x: [..., K, C]; w: [P, C] per-channel taps. Causal pads (P-1)*d on the
    left; otherwise (P-1)*d//2 on each side (P odd).
    """
    P = w.shape[0]
    K = x.shape[-2]
    halo = (P - 1) * dilation
    if causal:
        pad = (halo, 0)
    else:
        if (P - 1) % 2 != 0:
            raise ValueError("non-causal SAME padding requires odd kernel size")
        pad = (halo // 2, halo // 2)
    xp = F.pad(x, (0, 0, *pad))
    out = xp[..., 0:K, :] * w[0]
    for p in range(1, P):
        out = out + xp[..., p * dilation: p * dilation + K, :] * w[p]
    return out


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with a scalar (or per-channel) slope."""
    return torch.where(x >= 0, x, alpha * x)


def torch_conv_xavier_normal(out_ch: int, in_ch_per_group: int,
                             kernel_w: int) -> float:
    """Std of ``nn.init.xavier_normal_`` on a conv weight
    ``[out_ch, in_ch/groups, kW]``: sqrt(2 / (fan_in + fan_out))."""
    fan_in = in_ch_per_group * kernel_w
    fan_out = out_ch * kernel_w
    return math.sqrt(2.0 / (fan_in + fan_out))
