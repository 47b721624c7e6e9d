"""One TCN block backward, gLN or cLN: the hand-written CUDA kernels and
their twin.

Counterpart of ``convtasnet_tpu/ops/pallas/tcn_block_bwd.py`` (the Pallas
``_bwd_kernel`` (gLN) and ``_bwd_kernel_cln`` (cLN) behind
``fused_tcn_block_bwd``). Both kernels are ``csrc/tcn_block_bwd.cu``, one
template on the norm; its design note is there.

``fused_tcn_block_bwd`` takes the JAX wrapper's arguments in the same order
and returns the same ten cotangents ``(dx, dW_in, d_dw, dW_out, da1, da2,
dgamma1, dbeta1, dgamma2, dbeta2)``, each in its primal's dtype. On CPU
tensors it runs the plain twin ``fused_tcn_block_bwd_reference`` (autograd
through the forward twin, the block's explicit math for either norm); on
CUDA tensors it launches the kernel or raises, with no fallback.
``fused_tcn_block_bwd.launches`` counts the calls that launched the gLN
kernel (B2), ``fused_tcn_block_bwd.cln_launches`` those that launched the
cLN kernel (B3). BN blocks train through the plain ops with batch
statistics, as the JAX package's do, so BN raises here.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.cuda.tcn_block import (
    NORM_CODES,
    fused_tcn_block_reference,
    pad_block,
    padded,
    shape_refusal,
)

_ENTRY = {("gLN", torch.float32): "ctn_tcn_block_bwd_f32",
          ("gLN", torch.bfloat16): "ctn_tcn_block_bwd_bf16",
          ("cLN", torch.float32): "ctn_tcn_block_bwd_cln_f32",
          ("cLN", torch.bfloat16): "ctn_tcn_block_bwd_cln_bf16"}


def fused_tcn_block_bwd_reference(
    x: torch.Tensor, g: torch.Tensor, w_in: torch.Tensor,
    dw: torch.Tensor, w_out: torch.Tensor, a1: torch.Tensor,
    a2: torch.Tensor, gamma1: torch.Tensor, beta1: torch.Tensor,
    gamma2: torch.Tensor, beta2: torch.Tensor,
    *, dilation: int, causal: bool, norm_type: str,
) -> Tuple[torch.Tensor, ...]:
    """The ten cotangents by autograd through ``fused_tcn_block_reference``
    (as the JAX tests take ``jax.vjp`` of ``_xla_block``)."""
    prims = [t.detach().requires_grad_(True)
             for t in (x, w_in, dw, w_out, a1, a2, gamma1, beta1, gamma2,
                       beta2)]
    with torch.enable_grad():
        out = fused_tcn_block_reference(*prims, dilation=dilation,
                                        causal=causal, norm_type=norm_type)
        return torch.autograd.grad(out, prims, grad_outputs=g.to(out.dtype))


def fused_tcn_block_bwd(
    x: torch.Tensor,          # [M, K, B] block input
    g: torch.Tensor,          # [M, K, B] cotangent of the block output
    w_in: torch.Tensor,       # [B, H]
    dw: torch.Tensor,         # [P, H]
    w_out: torch.Tensor,      # [H, B]
    a1: torch.Tensor, a2: torch.Tensor,
    gamma1: torch.Tensor, beta1: torch.Tensor,
    gamma2: torch.Tensor, beta2: torch.Tensor,
    *,
    dilation: int,
    causal: bool,
    norm_type: str = "gLN",
) -> Tuple[torch.Tensor, ...]:
    """Backward of one gLN or cLN block -> ``(dx, dW_in, d_dw, dW_out,
    da1, da2, dgamma1, dbeta1, dgamma2, dbeta2)`` in the primals' dtypes."""
    if norm_type not in ("gLN", "cLN"):
        raise NotImplementedError(
            f"the block backward kernels take gLN and cLN, got {norm_type}: "
            "BN blocks train through the plain ops with batch statistics")
    args = (x, g, w_in, dw, w_out, a1, a2, gamma1, beta1, gamma2, beta2)
    kw = dict(dilation=dilation, causal=causal, norm_type=norm_type)
    if x.device.type == "cpu":
        return fused_tcn_block_bwd_reference(*args, **kw)
    return _launch_cuda(*args, **kw)


fused_tcn_block_bwd.launches = 0        # B2, the gLN kernel
fused_tcn_block_bwd.cln_launches = 0    # B3, the cLN kernel


def _launch_cuda(x, g, w_in, dw, w_out, a1, a2, gamma1, beta1, gamma2,
                 beta2, *, dilation, causal, norm_type="gLN"):
    """The CUDA branch of ``fused_tcn_block_bwd``: builds the kernel at
    first use, checks, allocates, launches on the current stream, and
    raises on anything the kernel does not take."""
    lib = load_library()
    if x.device.type != "cuda":
        raise ValueError(f"fused_tcn_block_bwd runs on CPU or CUDA tensors, "
                         f"got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the backward kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 3 or tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"x and g must both be [M, K, B], got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    M, K, B = x.shape
    P, H = dw.shape
    if tuple(w_in.shape) != (B, H) or tuple(w_out.shape) != (H, B):
        raise ValueError(f"weight shapes {tuple(w_in.shape)}, {tuple(dw.shape)}, "
                         f"{tuple(w_out.shape)} do not fit x {tuple(x.shape)}")
    refusal = shape_refusal(B, H, P, causal)
    if refusal:
        raise ValueError(refusal)
    dt = x.dtype
    x = x.contiguous()
    g = g.to(dt).contiguous()
    w_in_c, dw_c, w_out_c = (t.detach().to(dt).contiguous()
                             for t in (w_in, dw, w_out))
    vecs = [t.detach().to(torch.float32).reshape(-1).contiguous()
            for t in (a1, a2, gamma1, beta1, gamma2, beta2)]
    for t in (g, w_in_c, dw_c, w_out_c, *vecs):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, "
                             f"one is on {t.device}")
    if any(v.numel() != 1 for v in vecs[:2]) or any(
            v.numel() != H for v in vecs[2:]):
        raise ValueError("PReLU slopes must be scalars and norm vectors [H]")
    B_in, Hn = B, H
    if (padded(B), padded(H)) != (B, H):   # as the forward runs it
        (w_in_c, dw_c, w_out_c), vecs[2:] = pad_block(
            (w_in_c, dw_c, w_out_c), vecs[2:])
        B, H = padded(B), padded(H)
        x, g = (torch.nn.functional.pad(t, (0, B - B_in)) for t in (x, g))
    for t in (x, g, w_in_c, w_out_c):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x, g, w_in, "
                             "w_out")

    n_act, n_f32 = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ctn_tcn_block_bwd_workspace(M, K, B, H, P, x.element_size(),
                                    NORM_CODES[norm_type],
                                    ctypes.byref(n_act), ctypes.byref(n_f32))
    f32 = dict(dtype=torch.float32, device=x.device)
    ws_act = torch.empty(n_act.value, dtype=dt, device=x.device)
    ws_f32 = torch.empty(n_f32.value, **f32)
    dx = torch.empty_like(x)
    dwin = torch.empty((B, H), **f32)
    dwout = torch.empty((H, B), **f32)
    aux = torch.empty((P + 6) * H + 2, **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[norm_type, dt])(
            x.data_ptr(), g.data_ptr(), w_in_c.data_ptr(), dw_c.data_ptr(),
            w_out_c.data_ptr(), *[v.data_ptr() for v in vecs],
            ws_act.data_ptr(), ws_f32.data_ptr(), dx.data_ptr(),
            dwin.data_ptr(), dwout.data_ptr(), aux.data_ptr(),
            M, K, B, H, Hn, P, dilation, int(causal), stream)
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"tcn_block_bwd kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    if norm_type == "cLN":
        fused_tcn_block_bwd.cln_launches += 1
    else:
        fused_tcn_block_bwd.launches += 1
    rows = aux[: (P + 6) * H].view(P + 6, H)[:, :Hn]
    da1, da2 = aux[(P + 6) * H:]
    return (
        dx if B == B_in else dx[..., :B_in].contiguous(),
        dwin[:B_in, :Hn].to(w_in.dtype),
        rows[:P].to(dw.dtype),
        dwout[:Hn, :B_in].to(w_out.dtype),
        da1.reshape(a1.shape).to(a1.dtype),
        da2.reshape(a2.shape).to(a2.dtype),
        rows[P].to(gamma1.dtype),
        rows[P + 1].to(beta1.dtype),
        rows[P + 2].to(gamma2.dtype),
        rows[P + 3].to(beta2.dtype),
    )
