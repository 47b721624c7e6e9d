"""The dual-path intra-chunk attention sublayer: the hand-written CUDA
kernel and its plain twin.

Counterpart of ``convtasnet_tpu/ops/pallas/dpt_intra.py`` (the Pallas
``_intra_kernel`` behind ``fused_intra_attention``, and
``xla_intra_attention`` as its plain math). The kernel is
``csrc/dpt_intra.cu``; its design note is there. It shares its launcher,
checks and twin with the inter-chunk sublayer (``dpt_attention.py``); the
key bias [n, S] is indexed by the key's chunk and its position in it.

On CPU tensors ``fused_intra_attention`` runs the plain twin; on CUDA
tensors it launches the kernel or raises, with no fallback.
``fused_intra_attention.launches`` counts the calls that launched it.

The backward is kernel B10 (``csrc/dpt_intra_bwd.cu``) behind
``fused_intra_attention_bwd``, with the twin
``intra_attention_bwd_reference``; ``fused_intra_attention_ad`` joins the
two kernels in the autograd Function ``dpt_attention.AttentionFn``.

``partial=True`` runs a tensor-parallel head-group shard, as in
``dpt_attention.py``; its launches count in ``partial_launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from convtasnet_tpu_torch.ops.cuda.dpt_attention import (
    AttentionFn,
    attention_bwd_reference,
    attention_reference,
    count_launch,
    launch_attention,
    launch_attention_bwd,
)


def intra_attention_reference(x, gamma, beta, w_qkv, w_out, key_bias, *,
                              n_heads: int, partial: bool = False
                              ) -> torch.Tensor:
    """The intra-chunk sublayer's plain twin (``xla_intra_attention``)."""
    return attention_reference(x, gamma, beta, w_qkv, w_out, key_bias,
                               n_heads=n_heads, attend_axis=2,
                               partial=partial)


def fused_intra_attention(
    x: torch.Tensor,                    # [M, n, S, B]
    gamma: torch.Tensor,                # [B]
    beta: torch.Tensor,                 # [B]
    w_qkv: torch.Tensor,                # [B, 3Bq] (Bq == B unless partial)
    w_out: torch.Tensor,                # [Bq, B]
    key_bias: Optional[torch.Tensor],   # [n, S] f32 additive, or None
    *,
    n_heads: int,
    partial: bool = False,
) -> torch.Tensor:
    """Intra-chunk attention sublayer -> [M, n, S, B] in x's dtype."""
    if x.device.type == "cpu":
        return intra_attention_reference(x, gamma, beta, w_qkv, w_out,
                                         key_bias, n_heads=n_heads,
                                         partial=partial)
    out = launch_attention("intra", x, gamma, beta, w_qkv, w_out, key_bias,
                           n_heads=n_heads, partial=partial)
    count_launch(fused_intra_attention, partial)
    return out


fused_intra_attention.launches = 0
fused_intra_attention.partial_launches = 0


def intra_attention_bwd_reference(x, g, gamma, beta, w_qkv, w_out, key_bias,
                                  *, n_heads: int, partial: bool = False):
    """The intra-chunk sublayer backward's plain twin."""
    return attention_bwd_reference(x, g, gamma, beta, w_qkv, w_out,
                                   key_bias, n_heads=n_heads, attend_axis=2,
                                   partial=partial)


def fused_intra_attention_bwd(
    x: torch.Tensor,                    # [M, n, S, B] sublayer input
    g: torch.Tensor,                    # [M, n, S, B] output cotangent
    gamma: torch.Tensor, beta: torch.Tensor,
    w_qkv: torch.Tensor, w_out: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    *,
    n_heads: int,
    partial: bool = False,
):
    """Backward of the intra-chunk sublayer -> ``(dx, dgamma, dbeta,
    dw_qkv, dw_out)`` in the primals' dtypes."""
    args = (x, g, gamma, beta, w_qkv, w_out, key_bias)
    if x.device.type == "cpu":
        return intra_attention_bwd_reference(*args, n_heads=n_heads,
                                             partial=partial)
    grads = launch_attention_bwd("intra", *args, n_heads=n_heads,
                                 partial=partial)
    count_launch(fused_intra_attention_bwd, partial)
    return grads


fused_intra_attention_bwd.launches = 0
fused_intra_attention_bwd.partial_launches = 0


def fused_intra_attention_ad(x, gamma, beta, w_qkv, w_out, key_bias, *,
                             n_heads: int, partial: bool = False
                             ) -> torch.Tensor:
    """Differentiable intra-chunk sublayer -> [M, n, S, B] in x's dtype:
    ``fused_intra_attention`` forward, ``fused_intra_attention_bwd``
    backward. Gradients come back in each primal's dtype."""
    return AttentionFn.apply(x, gamma, beta, w_qkv, w_out, key_bias,
                             fused_intra_attention, fused_intra_attention_bwd,
                             n_heads, partial)
