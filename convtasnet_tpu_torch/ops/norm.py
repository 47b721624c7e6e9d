"""Normalisations on channels-last ``[..., K, N]`` tensors.

Counterpart of ``convtasnet_tpu/ops/norm.py``: eps is added to the biased
variance E[(x-mean)^2] before the square root (1e-8 for cLN/gLN), and BN
uses given statistics with eps 1e-5. ``layer_norm`` is the dual-path
separator's pre-LN (``models/dual_path._LayerNorm``): eps 1e-6, statistics
in float32 whatever the input's dtype.
"""

from __future__ import annotations

import torch

EPS = 1e-8
BN_EPS = 1e-5
LN_EPS = 1e-6


def channelwise_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """cLN: each timestep normalised over its channels."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def global_layer_norm(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """gLN: normalised over channels and time jointly."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = (x - mean).square().mean(dim=(-2, -1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor,
               eps: float = BN_EPS) -> torch.Tensor:
    """Affine batch norm with given per-channel statistics."""
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def layer_norm(x: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """LN over the last axis with f32 statistics, returned in x's dtype."""
    out = channelwise_layer_norm(x.float(), gamma.float(), beta.float(),
                                 eps=LN_EPS)
    return out.to(x.dtype)
