"""Conv-TasNet in PyTorch: the TCN separator here, the dual-path (DPT)
separator in ``models/dual_path.py``, behind one encoder and decoder.

Counterpart of ``convtasnet_tpu/models/conv_tasnet.py``.
Layout, parameter names and shapes are the JAX model's:
channels-last ``[batch, time, channels]``, 1x1 convs as ``x @ w``, and
state_dict keys such as ``encoder.w [L,N]``,
``separator.block_r{r}_x{x}.conv1x1 [B,H]``, ``.dwconv [P,H]``,
``.pwconv [H,B]``, ``.norm1.gamma [H]``, ``separator.mask_conv [B,C*N]`` and
``decoder.w [N,L]``, so weights move between the two packages one leaf at a
time (``models/jax_params.py``).

Parameters are stored in float32; the forward runs in ``cfg.compute_dtype``
with weights cast at use, norm statistics in float32, and returns float32.

``use_pallas`` keeps the JAX meaning, "run each TCN block (or DPT
sublayer) through the hand-written kernels" (``ops/cuda/``): ``None``
(auto) runs the kernels for CUDA tensors and the plain ops for CPU tensors;
``True`` needs CUDA tensors and raises on CPU ones; ``False`` runs the
plain ops anywhere. ``cfg.use_pallas=True`` acts as ``use_pallas=True``.

With the kernels in use and ``CONVTASNET_PAIR_FUSION=1``
(``pair_fusion_enabled``; off by default: a pair gives the bits of two
single blocks, but its backward reruns block 1's forward, so a training
step with pairs trades time for memory), blocks (x, x+1) of each repeat,
for even x
with x+1 < X, run as one block pair, as the JAX separator's
``pair_variant`` runs them: gLN and cLN forwards without gradients through
the pair kernel B4 (``fused_tcn_block_pair``), gLN with gradients through
B4 and the pair backward B5 (``fused_tcn_block_pair_ad``). The rule is
fixed in code, with no probe.

Every other block runs singly. Training (``model.train()`` with
gradients) with the kernels in use: gLN and cLN single blocks run the
forward kernel B1 and the backward kernel of their norm (B2 for gLN, B3 for
cLN) through ``fused_tcn_block_ad``, so cLN trains as single blocks, as in
JAX (its pair train gate takes gLN only); BN blocks train through the plain
ops with batch statistics, as the JAX model's do (its fused train branch
takes only gLN/cLN). An odd last block and the plain path run singly.
Parameters stay per block under their names, paired or not.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn

from convtasnet_tpu_torch.config import ConvTasNetConfig
from convtasnet_tpu_torch.models.dual_path import DualPathSeparator
from convtasnet_tpu_torch.models.functional import (
    block_forward,
    block_names,
    decode_frames,
    encode_frames,
    separator_forward,
)
from convtasnet_tpu_torch.ops.conv import (
    depthwise_conv1d,
    torch_conv_xavier_normal,
)
from convtasnet_tpu_torch.ops.cuda.tcn_block import (
    fused_tcn_block,
    fused_tcn_block_ad,
)
from convtasnet_tpu_torch.ops.cuda.tcn_block_pair import (
    fused_tcn_block_pair,
    fused_tcn_block_pair_ad,
)
from convtasnet_tpu_torch.ops.frames import frame_signal, overlap_and_add
from convtasnet_tpu_torch.ops.norm import (
    batch_norm,
    channelwise_layer_norm,
    global_layer_norm,
)


PAIR_ENV = "CONVTASNET_PAIR_FUSION"


def pair_fusion_enabled() -> bool:
    """Whether the separator runs blocks (x, x+1) as pairs where the
    kernels are in use: when ``CONVTASNET_PAIR_FUSION`` is set and not
    ``0``, as in the JAX package, which reads it at each forward too. Off
    by default: on the card a pair gives the bits of two single blocks and
    its forward saves a launch, but its backward (B5, which keeps only the
    pair input) reruns block 1's forward, so a training step with pairs
    saves memory and costs time where the card is busy (PERF.md)."""
    return os.environ.get(PAIR_ENV, "0") != "0"


def _xavier(shape, std: float, generator: torch.Generator, device):
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return nn.Parameter(w.to(device))


class Norm(nn.Module):
    """gLN / cLN / BN over the last axis. gamma=1, beta=0; BN keeps its
    running ``mean``/``var`` as buffers. In training mode BN normalises
    with the batch statistics over every axis but the last, the variance
    as E[x^2]-mean^2, and updates the buffers with momentum 0.1 and the
    unbiased variance (torch ``BatchNorm1d``, as the JAX ``Norm`` does with
    ``train=True``); in eval mode it uses the buffers."""

    MOMENTUM = 0.1

    def __init__(self, norm_type: str, features: int, device=None):
        super().__init__()
        if norm_type not in ("gLN", "cLN", "BN"):
            raise ValueError(f"unsupported norm_type: {norm_type}")
        self.norm_type = norm_type
        self.gamma = nn.Parameter(torch.ones(features, device=device))
        self.beta = nn.Parameter(torch.zeros(features, device=device))
        if norm_type == "BN":
            self.register_buffer("mean", torch.zeros(features, device=device))
            self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.norm_type == "gLN":
            out = global_layer_norm(xf, self.gamma, self.beta)
        elif self.norm_type == "cLN":
            out = channelwise_layer_norm(xf, self.gamma, self.beta)
        elif self.training:
            axes = tuple(range(xf.dim() - 1))
            mean = xf.mean(dim=axes)
            var = xf.square().mean(dim=axes) - mean.square()
            with torch.no_grad():
                n = xf.numel() // xf.shape[-1]
                unbiased = var * (n / max(n - 1, 1))
                self.mean.mul_(1 - self.MOMENTUM).add_(self.MOMENTUM * mean)
                self.var.mul_(1 - self.MOMENTUM).add_(self.MOMENTUM * unbiased)
            out = batch_norm(xf, self.gamma, self.beta, mean, var)
        else:
            out = batch_norm(xf, self.gamma, self.beta, self.mean, self.var)
        return out.to(x.dtype)


class Encoder(nn.Module):
    """Learned analysis filterbank: mixture [M, T] -> frames [M, K, L]
    -> @ w [L, N] -> ReLU -> [M, K, N]."""

    def __init__(self, cfg: ConvTasNetConfig, generator, device=None):
        super().__init__()
        self.cfg = cfg
        self.w = _xavier((cfg.kernel_size, cfg.n_filters),
                         torch_conv_xavier_normal(cfg.n_filters, 1,
                                                  cfg.kernel_size),
                         generator, device)

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        frames = frame_signal(mixture, self.cfg.kernel_size, self.cfg.stride)
        return encode_frames({"w": self.w}, frames)


class Decoder(nn.Module):
    """Masked basis reconstruction and overlap-add:
    (mixture_w [M,K,N], masks [M,K,C,N]) -> [M,C,K,L] -> [M,C,T]."""

    def __init__(self, cfg: ConvTasNetConfig, generator, device=None):
        super().__init__()
        self.cfg = cfg
        self.w = _xavier((cfg.n_filters, cfg.kernel_size),
                         torch_conv_xavier_normal(cfg.kernel_size,
                                                  cfg.n_filters, 1),
                         generator, device)

    def forward(self, mixture_w: torch.Tensor,
                est_mask: torch.Tensor) -> torch.Tensor:
        est_frames = decode_frames({"w": self.w}, mixture_w, est_mask)
        return overlap_and_add(est_frames, self.cfg.stride)


class TemporalBlock(nn.Module):
    """One residual TCN block: 1x1 (B->H) -> PReLU -> norm -> depthwise
    dilated (P taps) -> PReLU -> norm -> 1x1 (H->B), residual add."""

    def __init__(self, cfg: ConvTasNetConfig, dilation: int, generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dilation = dilation
        B, H, P = cfg.bottleneck, cfg.hidden, cfg.conv_kernel
        self.conv1x1 = _xavier((B, H), torch_conv_xavier_normal(H, B, 1),
                               generator, device)
        self.prelu1 = nn.Parameter(torch.tensor(0.25, device=device))
        self.dwconv = _xavier((P, H), torch_conv_xavier_normal(H, 1, P),
                              generator, device)
        self.prelu2 = nn.Parameter(torch.tensor(0.25, device=device))
        self.pwconv = _xavier((H, B), torch_conv_xavier_normal(B, H, 1),
                              generator, device)
        self.norm1 = Norm(cfg.norm_type, H, device)
        self.norm2 = Norm(cfg.norm_type, H, device)

    def forward(self, x: torch.Tensor, use_kernel: bool) -> torch.Tensor:
        """``use_kernel``: run the CUDA kernels where this block's norm has
        them."""
        cfg = self.cfg
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if use_kernel and needs_grad and cfg.norm_type != "BN":
            out = fused_tcn_block_ad(
                x.reshape(-1, *x.shape[-2:]), self.conv1x1, self.dwconv,
                self.pwconv, self.prelu1, self.prelu2,
                self.norm1.gamma, self.norm1.beta,
                self.norm2.gamma, self.norm2.beta,
                dilation=self.dilation, causal=cfg.causal,
                norm_type=cfg.norm_type)
            return out.reshape(x.shape)
        if use_kernel and cfg.norm_type == "BN" and (needs_grad
                                                    or self.training):
            use_kernel = False     # BN trains through the plain ops
        if use_kernel:
            bn_stats = None
            if cfg.norm_type == "BN":
                bn_stats = (self.norm1.mean, self.norm1.var,
                            self.norm2.mean, self.norm2.var)
            out = fused_tcn_block(
                x.reshape(-1, *x.shape[-2:]), self.conv1x1, self.dwconv,
                self.pwconv, self.prelu1, self.prelu2,
                self.norm1.gamma, self.norm1.beta,
                self.norm2.gamma, self.norm2.beta, dilation=self.dilation,
                causal=cfg.causal, norm_type=cfg.norm_type, bn_stats=bn_stats)
            return out.reshape(x.shape)
        blk = {"conv1x1": self.conv1x1, "prelu1": self.prelu1,
               "dwconv": self.dwconv, "prelu2": self.prelu2,
               "pwconv": self.pwconv}
        return block_forward(
            blk, x,
            dwconv=lambda h, w: depthwise_conv1d(h, w, self.dilation,
                                                 cfg.causal),
            norm1=self.norm1, norm2=self.norm2)


class TemporalConvNet(nn.Module):
    """TCN separator -> masks: cLN input norm -> 1x1 bottleneck N->B ->
    R repeats x X blocks (dilation 2**x) -> 1x1 B->C*N -> relu/softmax masks
    [M, K, C, N]."""

    def __init__(self, cfg: ConvTasNetConfig, generator, device=None):
        super().__init__()
        self.cfg = cfg
        N, B, C = cfg.n_filters, cfg.bottleneck, cfg.num_speakers
        self.input_norm = Norm("cLN", N, device)
        self.bottleneck = _xavier((N, B), torch_conv_xavier_normal(B, N, 1),
                                  generator, device)
        for name, dilation in block_names(cfg):
            self.add_module(name, TemporalBlock(cfg, dilation, generator,
                                                device))
        self.mask_conv = _xavier((B, C * N),
                                 torch_conv_xavier_normal(C * N, B, 1),
                                 generator, device)

    def forward(self, mixture_w: torch.Tensor,
                use_kernel: bool) -> torch.Tensor:
        return separator_forward(
            self.cfg,
            {"bottleneck": self.bottleneck, "mask_conv": self.mask_conv},
            mixture_w, input_norm=self.input_norm,
            run_block=lambda name, _, y: getattr(self, name)(y, use_kernel),
            run_pair=self._pair_runner(mixture_w) if use_kernel else None)

    def _pair_runner(self, mixture_w: torch.Tensor):
        """How blocks pair with the kernels in use: ``None`` (every block
        singly) for BN, with the switch off, or for cLN with gradients;
        else a ``run_pair`` for ``separator_forward``."""
        cfg = self.cfg
        if cfg.norm_type not in ("gLN", "cLN") or not pair_fusion_enabled():
            return None
        needs_grad = torch.is_grad_enabled() and (
            mixture_w.requires_grad
            or any(p.requires_grad for p in self.parameters()))
        if needs_grad and cfg.norm_type != "gLN":
            return None
        pair = fused_tcn_block_pair_ad if needs_grad else fused_tcn_block_pair

        def run_pair(name_a: str, name_b: str, dilation: int,
                     y: torch.Tensor) -> torch.Tensor:
            blocks = getattr(self, name_a), getattr(self, name_b)
            params = [(b.conv1x1, b.dwconv, b.pwconv, b.prelu1, b.prelu2,
                       b.norm1.gamma, b.norm1.beta, b.norm2.gamma,
                       b.norm2.beta) for b in blocks]
            out = pair(y.reshape(-1, *y.shape[-2:]), *params, d1=dilation,
                       d2=blocks[1].dilation, causal=cfg.causal,
                       norm_type=cfg.norm_type)
            return out.reshape(y.shape)

        return run_pair


class ConvTasNet(nn.Module):
    """Full model: ``forward(mixture [M, T]) -> est_source [M, C, T]`` in
    float32, right-padded with zeros back to the input length.

    ``generator`` seeds the initial weights (default: seed 0); ``device``
    is where the parameters live.
    """

    def __init__(self, cfg: ConvTasNetConfig, *,
                 use_pallas: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        separators = {"tcn": TemporalConvNet, "dpt": DualPathSeparator}
        if cfg.separator not in separators:
            raise ValueError(f"unsupported separator family: {cfg.separator}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.use_pallas = True if use_pallas is None and cfg.use_pallas \
            else use_pallas
        self.encoder = Encoder(cfg, generator, device)
        self.separator = separators[cfg.separator](cfg, generator, device)
        self.decoder = Decoder(cfg, generator, device)

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        use_kernel = mixture.is_cuda if self.use_pallas is None \
            else self.use_pallas
        if use_kernel and not mixture.is_cuda:
            raise ValueError(
                "use_pallas=True runs the CUDA kernels and needs CUDA "
                f"tensors; the mixture is on {mixture.device}")
        x = mixture.to(getattr(torch, cfg.compute_dtype))
        mixture_w = self.encoder(x)
        est_mask = self.separator(mixture_w, use_kernel)
        est_source = self.decoder(mixture_w, est_mask)
        T_origin = mixture.shape[-1]
        T_conv = est_source.shape[-1]
        if T_conv < T_origin:
            est_source = torch.nn.functional.pad(
                est_source, (0, T_origin - T_conv))
        return est_source.float()


def init_params(cfg: ConvTasNetConfig,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Freshly initialised weights as a state_dict (CPU, float32):
    Xavier-normal convs, PReLU 0.25, norms 1/0, BN statistics 0/1."""
    return ConvTasNet(cfg, generator=generator).state_dict()
