"""The dual-path inter-chunk attention sublayer: the hand-written CUDA
kernel and its plain twin, and the pieces both attention sublayers share.

Counterpart of ``convtasnet_tpu/ops/pallas/dpt_attention.py`` (the Pallas
``_inter_kernel`` behind ``fused_inter_attention``, and
``xla_inter_attention`` as its plain math). The kernel is
``csrc/dpt_attention.cu``; its design note is there. The intra-chunk
sublayer (``dpt_intra.py``) runs through ``attention_reference`` and
``launch_attention`` here with ``attend_axis=2``.

``fused_inter_attention`` takes the JAX wrapper's arguments in the same
order and layout: x [M, n, S, B], LN gamma/beta [B], w_qkv [B, 3B],
w_out [B, B] and the additive key bias [n, S] in f32 (0 for a real frame,
-1e9 for a padded one; None for no mask). On CPU tensors it runs the plain
twin; on CUDA tensors it launches the kernel or raises, with no fallback.
``fused_inter_attention.launches`` counts the calls that launched it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.norm import layer_norm

NEG_INF = -1e9
TILE = 64            # B must be a multiple of the GEMM tile
MAX_WIDTH = 256      # B at most this (the kernels' shared-memory tiles)
HEAD_DIMS = (32, 64)
_ENTRY = {
    "inter": {torch.float32: "ctn_dpt_inter_f32",
              torch.bfloat16: "ctn_dpt_inter_bf16"},
    "intra": {torch.float32: "ctn_dpt_intra_f32",
              torch.bfloat16: "ctn_dpt_intra_bf16"},
}


def attention_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w_qkv: torch.Tensor,
                        w_out: torch.Tensor,
                        key_bias: Optional[torch.Tensor], *, n_heads: int,
                        attend_axis: int) -> torch.Tensor:
    """The pre-LN MHA sublayer + residual in plain PyTorch (the math of
    ``xla_inter_attention`` / ``xla_intra_attention``): products in x's
    dtype, LN statistics and the softmax in f32. ``attend_axis`` 2 mixes
    within each chunk (over S), 1 across chunks (over n)."""
    M, n, S, B = x.shape
    h = n_heads
    d = B // h
    y = layer_norm(x, gamma, beta)
    q, k, v = (t.reshape(M, n, S, h, d)
               for t in (y @ w_qkv.to(x.dtype)).split(B, dim=-1))
    if attend_axis == 2:
        logits = torch.einsum("mnqhd,mnkhd->mnhqk", q, k).float() / math.sqrt(d)
        if key_bias is not None:
            logits = logits + key_bias.float()[None, :, None, None, :]
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        a = torch.einsum("mnhqk,mnkhd->mnqhd", w, v)
    elif attend_axis == 1:
        logits = torch.einsum("mqshd,mkshd->mshqk", q, k).float() / math.sqrt(d)
        if key_bias is not None:
            logits = logits + key_bias.float().T[None, :, None, None, :]
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        a = torch.einsum("mshqk,mkshd->mqshd", w, v)
    else:
        raise ValueError(f"attend_axis must be 1 or 2, got {attend_axis}")
    return x + a.reshape(M, n, S, B) @ w_out.to(x.dtype)


def inter_attention_reference(x, gamma, beta, w_qkv, w_out, key_bias, *,
                              n_heads: int) -> torch.Tensor:
    """The inter-chunk sublayer's plain twin (``xla_inter_attention``)."""
    return attention_reference(x, gamma, beta, w_qkv, w_out, key_bias,
                               n_heads=n_heads, attend_axis=1)


def fused_inter_attention(
    x: torch.Tensor,                    # [M, n, S, B]
    gamma: torch.Tensor,                # [B]
    beta: torch.Tensor,                 # [B]
    w_qkv: torch.Tensor,                # [B, 3B]
    w_out: torch.Tensor,                # [B, B]
    key_bias: Optional[torch.Tensor],   # [n, S] f32 additive, or None
    *,
    n_heads: int,
) -> torch.Tensor:
    """Inter-chunk attention sublayer -> [M, n, S, B] in x's dtype."""
    if x.device.type == "cpu":
        return inter_attention_reference(x, gamma, beta, w_qkv, w_out,
                                         key_bias, n_heads=n_heads)
    out = launch_attention("inter", x, gamma, beta, w_qkv, w_out, key_bias,
                           n_heads=n_heads)
    fused_inter_attention.launches += 1
    return out


fused_inter_attention.launches = 0


def launch_attention(kind: str, x, gamma, beta, w_qkv, w_out, key_bias, *,
                     n_heads: int) -> torch.Tensor:
    """The CUDA branch of both attention wrappers (``kind`` "inter" or
    "intra"): builds the kernels at first use, checks, allocates, launches
    on the current stream, and raises on anything the kernel does not
    take."""
    name = f"fused_{kind}_attention"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, gamma, beta, w_qkv, w_out, key_bias)):
        raise NotImplementedError(
            f"{name} launches the CUDA sublayer kernel forward only: its "
            "output carries no gradient. The DPT backward kernels (B8, B10, "
            "B12) are not ported yet (ROADMAP A7, DPT training); run "
            "inference under torch.inference_mode() or torch.no_grad()")
    lib = load_library()
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _ENTRY[kind]:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [M, n, S, B], got {tuple(x.shape)}")
    M, n, S, B = x.shape
    if B % TILE or B > MAX_WIDTH:
        raise ValueError(f"the kernel needs B a multiple of {TILE} and at "
                         f"most {MAX_WIDTH}, got B={B}")
    if B % n_heads or B // n_heads not in HEAD_DIMS:
        raise ValueError(f"the kernel needs a head width in {HEAD_DIMS}, got "
                         f"B={B} with {n_heads} heads")
    if kind == "intra" and (S % 16 or S > 256):
        raise ValueError(f"the intra kernel needs a chunk length S that is a "
                         f"multiple of 16 and at most 256, got S={S}")
    if tuple(w_qkv.shape) != (B, 3 * B) or tuple(w_out.shape) != (B, B):
        raise ValueError(f"weight shapes {tuple(w_qkv.shape)}, "
                         f"{tuple(w_out.shape)} do not fit x {tuple(x.shape)}")
    if key_bias is not None and tuple(key_bias.shape) != (n, S):
        raise ValueError(f"key_bias must be [n, S] = {(n, S)}, got "
                         f"{tuple(key_bias.shape)}")
    dt = x.dtype
    x = x.contiguous()
    w_qkv, w_out = (t.to(dt).contiguous() for t in (w_qkv, w_out))
    gamma, beta = (t.to(torch.float32).reshape(-1).contiguous()
                   for t in (gamma, beta))
    if key_bias is not None:
        key_bias = key_bias.to(torch.float32).contiguous()
    for t in (w_qkv, w_out, gamma, beta, key_bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on "
                             f"{t.device}")
    if gamma.numel() != B or beta.numel() != B:
        raise ValueError("LN gamma and beta must be [B]")
    for t in (x, w_qkv, w_out):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x, w_qkv, w_out")

    R = M * n * S
    qkv = torch.empty((R, 3 * B), dtype=dt, device=x.device)
    a = torch.empty((R, B), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[kind][dt])(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_qkv.data_ptr(),
            w_out.data_ptr(), None if key_bias is None else key_bias.data_ptr(),
            qkv.data_ptr(), a.data_ptr(), out.data_ptr(), M, n, S, B, n_heads,
            stream)
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"dpt {kind} attention kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    return out
