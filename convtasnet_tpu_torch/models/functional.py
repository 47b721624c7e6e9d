"""Conv-TasNet block and separator math on plain tensors.

Counterpart of ``convtasnet_tpu/models/functional.py``. The model
(``models/conv_tasnet.py``) runs its separator through
``separator_forward``; its plain blocks and the kernel's plain twin
(``ops/cuda/tcn_block.py``) both run through ``block_forward``, each caller
supplying how the depthwise conv and the two norms see their input.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from convtasnet_tpu_torch.ops.conv import pointwise_conv, prelu


def block_names(cfg) -> list:
    """Block names and dilations in order: ``[("block_r{r}_x{x}", 2**x)]``."""
    return [
        (f"block_r{r}_x{x}", 2 ** x)
        for r in range(cfg.num_repeats)
        for x in range(cfg.num_blocks)
    ]


def encode_frames(enc_params: Dict[str, Any],
                  frames: torch.Tensor) -> torch.Tensor:
    """Framed mixture ``[..., K, L]`` -> encoder output ``[..., K, N]``:
    the learned analysis filterbank and ReLU as one matmul."""
    return torch.relu(frames @ enc_params["w"].to(frames.dtype))


def block_forward(
    blk: Dict[str, Any],
    y: torch.Tensor,
    *,
    dwconv: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    norm1: Callable[[torch.Tensor], torch.Tensor],
    norm2: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """One residual TCN block: 1x1 (B->H) -> PReLU -> norm -> depthwise
    dilated -> PReLU -> norm -> 1x1 (H->B), residual add."""
    h = pointwise_conv(y, blk["conv1x1"].to(y.dtype))
    h = prelu(h, blk["prelu1"].to(h.dtype))
    h = norm1(h)
    h = dwconv(h, blk["dwconv"].to(h.dtype))
    h = prelu(h, blk["prelu2"].to(h.dtype))
    h = norm2(h)
    return y + pointwise_conv(h, blk["pwconv"].to(h.dtype))


def mask_from_scores(cfg, score: torch.Tensor) -> torch.Tensor:
    """Mask head output ``[..., K, C*N]`` -> masks ``[..., K, C, N]``
    (relu, or softmax over the speakers)."""
    C, N = cfg.num_speakers, cfg.n_filters
    score = score.reshape(*score.shape[:-1], C, N)
    if cfg.mask_nonlinear == "softmax":
        return torch.softmax(score, dim=-2)
    if cfg.mask_nonlinear == "relu":
        return torch.relu(score)
    raise ValueError(f"unsupported mask nonlinearity: {cfg.mask_nonlinear}")


def separator_forward(
    cfg,
    sep: Dict[str, Any],
    mixture_w: torch.Tensor,
    *,
    input_norm: Callable[[torch.Tensor], torch.Tensor],
    run_block: Callable[[str, int, torch.Tensor], torch.Tensor],
    run_pair: Optional[Callable[[str, str, int, torch.Tensor],
                                torch.Tensor]] = None,
) -> torch.Tensor:
    """TCN separator: cLN input norm -> 1x1 bottleneck -> R x X dilated
    blocks -> mask head -> nonlinearity. ``sep`` holds ``bottleneck`` and
    ``mask_conv``; ``run_block(name, dilation, y)`` runs one block, through
    ``block_forward`` or the CUDA kernel. ``run_pair(name_a, name_b,
    dilation, y)``, where given, runs blocks x and x+1 of each repeat as
    one pair (dilations d and 2d) for even x with x+1 < X, as the JAX
    separator's ``pair_variant`` pairs them; an odd last block runs
    singly."""
    y = input_norm(mixture_w)
    y = pointwise_conv(y, sep["bottleneck"].to(y.dtype))
    names = block_names(cfg)
    i = 0
    while i < len(names):
        name, dilation = names[i]
        x = i % cfg.num_blocks
        if run_pair is not None and x % 2 == 0 and x + 1 < cfg.num_blocks:
            y = run_pair(name, names[i + 1][0], dilation, y)
            i += 2
        else:
            y = run_block(name, dilation, y)
            i += 1
    score = pointwise_conv(y, sep["mask_conv"].to(y.dtype))
    return mask_from_scores(cfg, score)


def decode_frames(dec_params: Dict[str, Any], mixture_w: torch.Tensor,
                  est_mask: torch.Tensor) -> torch.Tensor:
    """(encoder output ``[..., K, N]``, masks ``[..., K, C, N]``) ->
    per-speaker frames ``[..., C, K, L]``: the masked basis times the
    decoder matrix."""
    w = dec_params["w"].to(mixture_w.dtype)
    frames = (mixture_w.unsqueeze(-2) * est_mask) @ w   # [..., K, C, L]
    return frames.transpose(-3, -2)
