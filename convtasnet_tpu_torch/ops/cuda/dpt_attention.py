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

The backward (kernel B8, ``csrc/dpt_attention_bwd.cu``; the intra
sublayer's B10 shares its launcher) is ``fused_inter_attention_bwd``, the
counterpart of the JAX wrapper of the same name: ``(dx, dgamma, dbeta,
dw_qkv, dw_out)`` in the primals' dtypes, the twin
``inter_attention_bwd_reference`` on CPU tensors (the explicit math of
the Pallas body, with its rounding points), the kernel on CUDA tensors.
``fused_inter_attention_ad`` is the differentiable sublayer (the
counterpart of the JAX function of the same name): forward kernel,
backward kernel, only the primals saved.

Every function here takes ``partial``, as the JAX wrappers do: with
``partial=True`` the weights are a tensor-parallel head-group shard
(``parallel/dpt_tp.py``), w_qkv [B, 3Bq] and w_out [Bq, B] with
Bq = B / m and ``n_heads`` the shard's heads, and the sublayer returns the
output projection alone, with no residual; its backward's dx has no
residual term. The same kernels run both modes (their design note is in
``csrc/dpt_common.cuh``); a partial launch counts in the wrapper's
``partial_launches``, a full one in ``launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.norm import LN_EPS, layer_norm

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
_BWD_ENTRY = {
    "inter": {torch.float32: "ctn_dpt_inter_bwd_f32",
              torch.bfloat16: "ctn_dpt_inter_bwd_bf16"},
    "intra": {torch.float32: "ctn_dpt_intra_bwd_f32",
              torch.bfloat16: "ctn_dpt_intra_bwd_bf16"},
}
_KERNEL_NO = {"inter": "B8", "intra": "B10"}


def fitting_shards(B: int, n_heads: int, ff: Optional[int] = None) -> list:
    """The shard counts m whose partial kernels take a sublayer of width B
    with ``n_heads`` heads (and an FFN of hidden width ``ff``): m divides
    the heads, B / m is a multiple of 64 and F / m one of 128."""
    return [m for m in range(1, n_heads + 1)
            if n_heads % m == 0 and B % m == 0 and (B // m) % TILE == 0
            and (ff is None or (ff % m == 0 and (ff // m) % (2 * TILE) == 0))]


def attention_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w_qkv: torch.Tensor,
                        w_out: torch.Tensor,
                        key_bias: Optional[torch.Tensor], *, n_heads: int,
                        attend_axis: int, partial: bool = False
                        ) -> torch.Tensor:
    """The pre-LN MHA sublayer + residual in plain PyTorch (the math of
    ``xla_inter_attention`` / ``xla_intra_attention``): products in x's
    dtype, LN statistics and the softmax in f32. ``attend_axis`` 2 mixes
    within each chunk (over S), 1 across chunks (over n). ``partial``:
    a head-group shard's projection alone (w_qkv [B, 3Bq], w_out [Bq, B])."""
    M, n, S, B = x.shape
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    d = Bq // h
    y = layer_norm(x, gamma, beta)
    q, k, v = (t.reshape(M, n, S, h, d)
               for t in (y @ w_qkv.to(x.dtype)).split(Bq, dim=-1))
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
    proj = a.reshape(M, n, S, Bq) @ w_out.to(x.dtype)
    return proj if partial else x + proj


def inter_attention_reference(x, gamma, beta, w_qkv, w_out, key_bias, *,
                              n_heads: int, partial: bool = False
                              ) -> torch.Tensor:
    """The inter-chunk sublayer's plain twin (``xla_inter_attention``)."""
    return attention_reference(x, gamma, beta, w_qkv, w_out, key_bias,
                               n_heads=n_heads, attend_axis=1,
                               partial=partial)


def fused_inter_attention(
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
    """Inter-chunk attention sublayer -> [M, n, S, B] in x's dtype."""
    if x.device.type == "cpu":
        return inter_attention_reference(x, gamma, beta, w_qkv, w_out,
                                         key_bias, n_heads=n_heads,
                                         partial=partial)
    out = launch_attention("inter", x, gamma, beta, w_qkv, w_out, key_bias,
                           n_heads=n_heads, partial=partial)
    count_launch(fused_inter_attention, partial)
    return out


fused_inter_attention.launches = 0
fused_inter_attention.partial_launches = 0


def count_launch(wrapper, partial: bool) -> None:
    """One launch of ``wrapper``'s kernel, in full or partial mode."""
    if partial:
        wrapper.partial_launches += 1
    else:
        wrapper.launches += 1


def needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _prepare(name: str, kind: str, x, gamma, beta, w_qkv, w_out, key_bias,
             n_heads: int, partial: bool):
    """Checks the operands of either attention kernel (forward or backward)
    and returns them as the kernels take them: x and the weights contiguous
    in x's dtype, gamma, beta and the bias contiguous in f32, and the
    heads' width Bq. Raises on anything the kernels do not take."""
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
    Bq = w_qkv.shape[-1] // 3
    if (tuple(w_qkv.shape) != (B, 3 * Bq) or tuple(w_out.shape) != (Bq, B)
            or not 0 < Bq <= B or (Bq != B and not partial)):
        raise ValueError(f"weight shapes {tuple(w_qkv.shape)}, "
                         f"{tuple(w_out.shape)} do not fit x {tuple(x.shape)}"
                         + ("" if partial else " (a head-group shard's "
                            "weights need partial=True)"))
    if Bq % n_heads or Bq // n_heads not in HEAD_DIMS:
        raise ValueError(f"the kernel needs a head width in {HEAD_DIMS}, got "
                         f"{Bq} channels with {n_heads} heads")
    if Bq % TILE:
        m = B // Bq if B % Bq == 0 else None
        fits = fitting_shards(B, n_heads * m) if m else []
        raise ValueError(
            f"the partial kernel needs the shard's width B/m a multiple of "
            f"{TILE}, got {Bq} of B={B}; shard counts that fit: {fits}")
    if kind == "intra" and (S % 16 or S > 256):
        raise ValueError(f"the intra kernel needs a chunk length S that is a "
                         f"multiple of 16 and at most 256, got S={S}")
    if key_bias is not None and tuple(key_bias.shape) != (n, S):
        raise ValueError(f"key_bias must be [n, S] = {(n, S)}, got "
                         f"{tuple(key_bias.shape)}")
    dt = x.dtype
    x = x.detach().contiguous()
    w_qkv, w_out = (t.detach().to(dt).contiguous() for t in (w_qkv, w_out))
    gamma, beta = (t.detach().to(torch.float32).reshape(-1).contiguous()
                   for t in (gamma, beta))
    if key_bias is not None:
        key_bias = key_bias.detach().to(torch.float32).contiguous()
    for t in (w_qkv, w_out, gamma, beta, key_bias):
        if t is not None and t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on "
                             f"{t.device}")
    if gamma.numel() != B or beta.numel() != B:
        raise ValueError("LN gamma and beta must be [B]")
    for t in (x, w_qkv, w_out):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x, w_qkv, w_out")
    return x, gamma, beta, w_qkv, w_out, key_bias, Bq


def raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def launch_attention(kind: str, x, gamma, beta, w_qkv, w_out, key_bias, *,
                     n_heads: int, partial: bool = False) -> torch.Tensor:
    """The CUDA branch of both attention wrappers (``kind`` "inter" or
    "intra"): builds the kernels at first use, checks, allocates, launches
    on the current stream, and raises on anything the kernel does not
    take."""
    name = f"fused_{kind}_attention"
    if needs_grad(x, gamma, beta, w_qkv, w_out, key_bias):
        raise NotImplementedError(
            f"{name} launches the CUDA sublayer kernel forward only: its "
            f"output carries no gradient. Train through {name}_ad, whose "
            f"backward is the {_KERNEL_NO[kind]} kernel, or run inference "
            "under torch.inference_mode() or torch.no_grad()")
    lib = load_library()
    x, gamma, beta, w_qkv, w_out, key_bias, Bq = _prepare(
        name, kind, x, gamma, beta, w_qkv, w_out, key_bias, n_heads, partial)
    M, n, S, B = x.shape
    R = M * n * S
    n_spill = ctypes.c_longlong(0)
    if kind == "intra":   # its q, k, v tiles, where shared memory cannot hold them
        lib.ctn_dpt_intra_workspace(M, n, S, Bq, n_heads, x.element_size(),
                                    ctypes.byref(n_spill))
        if n_spill.value < 0:
            raise ValueError(f"the intra kernel does not fit one block's "
                             f"shared memory at S={S} with head width "
                             f"{Bq // n_heads} in {x.dtype}")
    qkv = torch.empty((R, 3 * Bq), dtype=x.dtype, device=x.device)
    a = torch.empty(R * Bq + n_spill.value, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[kind][x.dtype])(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_qkv.data_ptr(),
            w_out.data_ptr(), None if key_bias is None else key_bias.data_ptr(),
            qkv.data_ptr(), a.data_ptr(), out.data_ptr(), M, n, S, B, n_heads,
            Bq, int(partial), stream)
    raise_on_error(lib, err, f"dpt {kind} attention kernel")
    return out


def attention_bwd_reference(x, g, gamma, beta, w_qkv, w_out, key_bias, *,
                            n_heads: int, attend_axis: int,
                            partial: bool = False):
    """The attention sublayer's backward in plain PyTorch: the explicit math
    of the Pallas bodies (``_inter_bwd_kernel``, ``_intra_bwd_kernel``) with
    their rounding points. Every product is taken in f32 on values of x's
    dtype and rounded once where the kernels round: qkv, round(p) before
    the mix and before dv, a, dA, ds = round(p (dp - rowsum) scale), dq,
    dk, dv; scores, p, dp, dy and the LN backward stay in f32, and
    dx = round(g + dx_ln), or with ``partial`` (the backward of a
    head-group shard's projection) round(dx_ln). Returns ``(dx, dgamma,
    dbeta, dw_qkv, dw_out)`` in the primals' dtypes."""
    if attend_axis not in (1, 2):
        raise ValueError(f"attend_axis must be 1 or 2, got {attend_axis}")
    dt = x.dtype
    M, n, S, B = x.shape
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    d = Bq // h
    scale = 1.0 / math.sqrt(d)

    def rnd(t):
        return t.to(dt).float()

    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rs = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + LN_EPS)
    xhat = (xf - mean) * rs
    y = rnd(xhat * gamma.float() + beta.float())
    wq, wo = rnd(w_qkv.float()), rnd(w_out.float())
    gf = g.float()
    # heads out: [M, n, S, h, d] -> the attended axis next to last
    perm = (0, 1, 3, 2, 4) if attend_axis == 2 else (0, 2, 3, 1, 4)
    q, k, v = (t.reshape(M, n, S, h, d).permute(perm)
               for t in rnd(y @ wq).split(Bq, dim=-1))
    dA = rnd(gf @ wo.T).reshape(M, n, S, h, d).permute(perm)
    logits = q @ k.transpose(-1, -2) * scale
    if key_bias is not None:
        kb = key_bias.float()
        logits = logits + (kb[None, :, None, None, :] if attend_axis == 2
                           else kb.T[None, :, None, None, :])
    p = torch.softmax(logits, dim=-1)
    pc = rnd(p)
    a = rnd(pc @ v)
    dp = dA @ v.transpose(-1, -2)
    dv = rnd(pc.transpose(-1, -2) @ dA)
    ds = rnd(p * (dp - (p * dp).sum(-1, keepdim=True)) * scale)
    dq, dk = rnd(ds @ k), rnd(ds.transpose(-1, -2) @ q)
    inv = (0, 1, 3, 2, 4) if attend_axis == 2 else (0, 3, 1, 2, 4)
    dqkv = torch.cat([t.permute(inv).reshape(M, n, S, Bq)
                      for t in (dq, dk, dv)], dim=-1).reshape(-1, 3 * Bq)
    a = a.permute(inv).reshape(-1, Bq)
    y2, g2 = y.reshape(-1, B), gf.reshape(-1, B)
    dw_qkv = y2.T @ dqkv
    dw_out = a.T @ g2
    dy = (dqkv @ wq.T).reshape(M, n, S, B)
    dgamma = (dy * xhat).sum(dim=(0, 1, 2))
    dbeta = dy.sum(dim=(0, 1, 2))
    dxhat = dy * gamma.float()
    dx_ln = rs * (dxhat - dxhat.mean(-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return ((dx_ln if partial else gf + dx_ln).to(dt), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype), dw_qkv.to(w_qkv.dtype),
            dw_out.to(w_out.dtype))


def inter_attention_bwd_reference(x, g, gamma, beta, w_qkv, w_out, key_bias,
                                  *, n_heads: int, partial: bool = False):
    """The inter-chunk sublayer backward's plain twin."""
    return attention_bwd_reference(x, g, gamma, beta, w_qkv, w_out,
                                   key_bias, n_heads=n_heads, attend_axis=1,
                                   partial=partial)


def fused_inter_attention_bwd(
    x: torch.Tensor,                    # [M, n, S, B] sublayer input
    g: torch.Tensor,                    # [M, n, S, B] output cotangent
    gamma: torch.Tensor, beta: torch.Tensor,
    w_qkv: torch.Tensor, w_out: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    *,
    n_heads: int,
    partial: bool = False,
):
    """Backward of the inter-chunk sublayer -> ``(dx, dgamma, dbeta,
    dw_qkv, dw_out)`` in the primals' dtypes."""
    args = (x, g, gamma, beta, w_qkv, w_out, key_bias)
    if x.device.type == "cpu":
        return inter_attention_bwd_reference(*args, n_heads=n_heads,
                                             partial=partial)
    grads = launch_attention_bwd("inter", *args, n_heads=n_heads,
                                 partial=partial)
    count_launch(fused_inter_attention_bwd, partial)
    return grads


fused_inter_attention_bwd.launches = 0
fused_inter_attention_bwd.partial_launches = 0


def launch_attention_bwd(kind: str, x, g, gamma, beta, w_qkv, w_out,
                         key_bias, *, n_heads: int, partial: bool = False):
    """The CUDA branch of both attention backward wrappers: builds the
    kernels at first use, checks, allocates the workspace and the outputs,
    launches on the current stream, and raises on anything the kernel does
    not take."""
    name = f"fused_{kind}_attention_bwd"
    lib = load_library()
    prims = _prepare(name, kind, x, gamma, beta, w_qkv, w_out, key_bias,
                     n_heads, partial)
    xc, gamma_c, beta_c, w_qkv_c, w_out_c, bias_c, Bq = prims
    M, n, S, B = xc.shape
    if tuple(g.shape) != tuple(xc.shape):
        raise ValueError(f"g must have x's shape {tuple(xc.shape)}, got "
                         f"{tuple(g.shape)}")
    g = g.detach().to(xc.dtype).contiguous()
    if g.device != xc.device or g.data_ptr() % 16:
        raise ValueError(f"g must be a 16-byte aligned tensor on {xc.device}")
    n_act, n_f32 = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ctn_dpt_attn_bwd_workspace(M, n, S, B, n_heads, Bq,
                                   xc.element_size(), ctypes.byref(n_act),
                                   ctypes.byref(n_f32))
    n_spill = ctypes.c_longlong(0)
    if kind == "intra":   # its tiles, where shared memory cannot hold them
        lib.ctn_dpt_intra_bwd_spill(M, n, S, Bq, n_heads, xc.element_size(),
                                    ctypes.byref(n_spill))
        if n_spill.value < 0:
            raise ValueError(f"the intra backward kernel does not fit one "
                             f"block's shared memory at S={S} with head "
                             f"width {Bq // n_heads} in {xc.dtype}")
    f32 = dict(dtype=torch.float32, device=xc.device)
    ws_act = torch.empty(n_act.value + n_spill.value, dtype=xc.dtype,
                         device=xc.device)
    ws_f32 = torch.empty(n_f32.value, **f32)
    dx = torch.empty_like(xc)
    dgb = torch.empty((2, B), **f32)
    dw_qkv = torch.empty((B, 3 * Bq), **f32)
    dw_out = torch.empty((Bq, B), **f32)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = getattr(lib, _BWD_ENTRY[kind][xc.dtype])(
            xc.data_ptr(), g.data_ptr(), gamma_c.data_ptr(),
            beta_c.data_ptr(), w_qkv_c.data_ptr(), w_out_c.data_ptr(),
            None if bias_c is None else bias_c.data_ptr(), ws_act.data_ptr(),
            ws_f32.data_ptr(), dx.data_ptr(), dgb.data_ptr(),
            dw_qkv.data_ptr(), dw_out.data_ptr(), M, n, S, B, n_heads, Bq,
            int(partial), stream)
    raise_on_error(lib, err, f"dpt {kind} attention backward kernel")
    return (dx, dgb[0].to(gamma.dtype), dgb[1].to(beta.dtype),
            dw_qkv.to(w_qkv.dtype), dw_out.to(w_out.dtype))


class AttentionFn(torch.autograd.Function):
    """One attention sublayer, forward kernel + backward kernel (``fwd``
    and ``bwd``, the inter or intra wrappers); saves only the primals and
    recomputes the rest in the backward (remat, as the JAX rules
    ``_fused_{inter,intra}_fwd`` do). ``key_bias`` gets no gradient;
    ``partial`` runs both kernels in their partial mode."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_qkv, w_out, key_bias, fwd, bwd,
                n_heads, partial):
        ctx.save_for_backward(x, gamma, beta, w_qkv, w_out, key_bias)
        ctx.bwd, ctx.n_heads, ctx.partial = bwd, n_heads, partial
        return fwd(x, gamma, beta, w_qkv, w_out, key_bias, n_heads=n_heads,
                   partial=partial)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w_qkv, w_out, key_bias = ctx.saved_tensors
        grads = ctx.bwd(x, g.contiguous(), gamma, beta, w_qkv, w_out,
                        key_bias, n_heads=ctx.n_heads, partial=ctx.partial)
        return (*grads, None, None, None, None, None)


def fused_inter_attention_ad(x, gamma, beta, w_qkv, w_out, key_bias, *,
                             n_heads: int, partial: bool = False
                             ) -> torch.Tensor:
    """Differentiable inter-chunk sublayer -> [M, n, S, B] in x's dtype:
    ``fused_inter_attention`` forward, ``fused_inter_attention_bwd``
    backward. Gradients come back in each primal's dtype."""
    return AttentionFn.apply(x, gamma, beta, w_qkv, w_out, key_bias,
                             fused_inter_attention, fused_inter_attention_bwd,
                             n_heads, partial)
