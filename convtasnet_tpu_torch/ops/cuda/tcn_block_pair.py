"""Two consecutive TCN blocks forward: the hand-written CUDA kernel (B4)
and its plain twin.

Counterpart of ``convtasnet_tpu/ops/pallas/tcn_block_pair.py`` (the Pallas
``_kernel_pair`` behind ``fused_tcn_block_pair``). The kernel is
``csrc/tcn_block_pair.cu``; its design note is there.

``fused_tcn_block_pair`` takes the JAX wrapper's arguments in the same order:
the pair input and one 9-tuple ``(w_in, dw, w_out, a1, a2, g1, b1, g2, b2)``
per block. On CPU tensors it runs the plain twin
``fused_tcn_block_pair_reference``; on CUDA tensors it launches the kernel
or raises, with no fallback. gLN and cLN, as JAX's; BN raises.
``fused_tcn_block_pair.launches`` counts the calls that launched the kernel.

``fused_tcn_block_pair_ad`` is the differentiable pair (the counterpart of
``_fused_pair_ad``): its forward is ``fused_tcn_block_pair`` and saves only
the pair input and the 18 parameters; its backward recomputes the rest from
the pair input in ``ops/cuda/tcn_block_pair_bwd.fused_tcn_block_pair_bwd``
(kernel B5 on CUDA tensors, the twin on CPU ones). gLN only, as JAX's.

Which blocks run as pairs is the model's rule
(``models/conv_tasnet.py``, ``pair_fusion_enabled``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.cuda.tcn_block import (
    NORM_CODES,
    fused_tcn_block_reference,
    pad_block,
    padded,
    shape_refusal as block_shape_refusal,
)


def shape_refusal(B: int, H: int, P: int, causal: bool) -> Optional[str]:
    """Why the pair kernels (B4, B5) refuse a pair of blocks of these
    widths, or None where they take it: the single block's rules (each
    block of a pair runs through the single block's launchers)."""
    return block_shape_refusal(B, H, P, causal)


_ENTRY = {torch.float32: "ctn_tcn_block_pair_f32",
          torch.bfloat16: "ctn_tcn_block_pair_bf16"}


def _check_norm(norm_type: str) -> None:
    if norm_type not in ("gLN", "cLN"):
        raise ValueError(f"the fused block pair takes gLN and cLN, got "
                         f"{norm_type}: BN blocks run singly")


def fused_tcn_block_pair_reference(
    x: torch.Tensor, params_a: Sequence[torch.Tensor],
    params_b: Sequence[torch.Tensor], *, d1: int, d2: int, causal: bool,
    norm_type: str,
) -> torch.Tensor:
    """Two chained ``fused_tcn_block_reference`` calls; x1 between them in
    x's dtype, as the Pallas kernel's ``x2_buf`` holds it."""
    _check_norm(norm_type)
    x1 = fused_tcn_block_reference(x, *params_a, dilation=d1, causal=causal,
                                   norm_type=norm_type)
    return fused_tcn_block_reference(x1, *params_b, dilation=d2,
                                     causal=causal, norm_type=norm_type)


def fused_tcn_block_pair(
    x: torch.Tensor,                      # [M, K, B]
    params_a: Sequence[torch.Tensor],     # (w_in, dw, w_out, a1, a2,
    params_b: Sequence[torch.Tensor],     #  g1, b1, g2, b2) per block
    *,
    d1: int,
    d2: int,
    causal: bool,
    norm_type: str,
) -> torch.Tensor:
    """Forward of two consecutive blocks (dilations d1, d2) -> [M, K, B] in
    x's dtype."""
    _check_norm(norm_type)
    kw = dict(d1=d1, d2=d2, causal=causal, norm_type=norm_type)
    if x.device.type == "cpu":
        return fused_tcn_block_pair_reference(x, params_a, params_b, **kw)
    return _launch_cuda(x, params_a, params_b, **kw)


fused_tcn_block_pair.launches = 0


def prepare_pair(name: str, x: torch.Tensor, params_a, params_b,
                 causal: bool) -> Tuple[torch.Tensor, list, int]:
    """Checks a pair's operands for the CUDA kernels (B4, B5) and returns x
    contiguous, the 18 parameters as the kernels take them (the products'
    weights contiguous in x's dtype, the slopes and norm affines
    contiguous in f32), both at the widths the kernels run them
    (``tcn_block.pad_block``), and the blocks' own H. Raises on anything
    the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [M, K, B], got {tuple(x.shape)}")
    if len(params_a) != 9 or len(params_b) != 9:
        raise ValueError("each block takes 9 parameters (w_in, dw, w_out, "
                         "a1, a2, g1, b1, g2, b2)")
    M, K, B = x.shape
    P, H = params_a[1].shape
    for w_in, dw, w_out in (params_a[:3], params_b[:3]):
        if (tuple(w_in.shape) != (B, H) or tuple(dw.shape) != (P, H)
                or tuple(w_out.shape) != (H, B)):
            raise ValueError(f"weight shapes {tuple(w_in.shape)}, "
                             f"{tuple(dw.shape)}, {tuple(w_out.shape)} do not "
                             f"fit x {tuple(x.shape)} and P={P}, H={H}")
    refusal = shape_refusal(B, H, P, causal)
    if refusal:
        raise ValueError(refusal)
    dt = x.dtype
    x = x.detach().contiguous()
    prepared = []
    for params in (params_a, params_b):
        mats = [t.detach().to(dt).contiguous() for t in params[:3]]
        vecs = [t.detach().to(torch.float32).reshape(-1).contiguous()
                for t in params[3:]]
        if any(v.numel() != 1 for v in vecs[:2]) or any(
                v.numel() != H for v in vecs[2:]):
            raise ValueError("PReLU slopes must be scalars and norm vectors "
                             "[H]")
        if (padded(B), padded(H)) != (B, H):
            mats, vecs[2:] = pad_block(mats, vecs[2:])
        prepared += mats + vecs
    for t in prepared:
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on "
                             f"{t.device}")
    x = torch.nn.functional.pad(x, (0, padded(B) - B)) if padded(B) != B else x
    for t in (x, *prepared[0:3:2], *prepared[9:12:2]):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x, w_in, w_out")
    return x, prepared, H


def _launch_cuda(x, params_a, params_b, *, d1, d2, causal, norm_type):
    """The CUDA branch of ``fused_tcn_block_pair``: builds the kernel at
    first use, checks, allocates, launches on the current stream, and
    raises on anything the kernel does not take."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in (*params_a, *params_b))):
        raise NotImplementedError(
            "fused_tcn_block_pair launches the CUDA block-pair kernel forward "
            "only: its output carries no gradient. Train through "
            "fused_tcn_block_pair_ad, whose backward is the pair backward "
            "kernel, or run inference under torch.inference_mode() or "
            "torch.no_grad()")
    lib = load_library()
    B_in = x.shape[-1]
    x, prepared, Hn = prepare_pair("fused_tcn_block_pair", x, params_a,
                                   params_b, causal)
    M, K, B = x.shape
    P, H = prepared[1].shape
    n_act, n_f32 = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ctn_tcn_block_pair_workspace(M, K, B, H, x.element_size(),
                                     NORM_CODES[norm_type],
                                     ctypes.byref(n_act), ctypes.byref(n_f32))
    ws_act = torch.empty(n_act.value, dtype=x.dtype, device=x.device)
    ws_f32 = torch.empty(n_f32.value, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), *[t.data_ptr() for t in prepared],
            ws_act.data_ptr(), ws_f32.data_ptr(), out.data_ptr(),
            M, K, B, H, Hn, P, d1, d2, int(causal), NORM_CODES[norm_type],
            stream)
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"tcn_block_pair kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    fused_tcn_block_pair.launches += 1
    return out if B == B_in else out[..., :B_in].contiguous()


class _FusedPairFn(torch.autograd.Function):
    """Pair forward kernel + pair backward kernel; saves only the pair
    input and the 18 parameters and recomputes both blocks (and x1) in the
    backward, as ``_fused_pair_fwd`` does."""

    @staticmethod
    def forward(ctx, x, kw, *p18):
        ctx.save_for_backward(x, *p18)
        ctx.kw = kw
        return fused_tcn_block_pair(x, p18[:9], p18[9:], **kw)

    @staticmethod
    def backward(ctx, g):
        # imported here: tcn_block_pair_bwd imports this module for the twin
        from convtasnet_tpu_torch.ops.cuda.tcn_block_pair_bwd import (
            fused_tcn_block_pair_bwd,
        )

        x, *p18 = ctx.saved_tensors
        dx, grads_a, grads_b = fused_tcn_block_pair_bwd(
            x, g.contiguous(), p18[:9], p18[9:], **ctx.kw)
        return (dx, None, *grads_a, *grads_b)


def fused_tcn_block_pair_ad(
    x: torch.Tensor, params_a: Sequence[torch.Tensor],
    params_b: Sequence[torch.Tensor], *, d1: int, d2: int, causal: bool,
    norm_type: str = "gLN",
) -> torch.Tensor:
    """Differentiable gLN block pair -> [M, K, B] in x's dtype. Gradients
    come back in each primal's dtype (f32 weights, x's dtype for dx)."""
    if norm_type != "gLN":
        raise ValueError(f"the pair train path takes gLN only, got "
                         f"{norm_type}: cLN blocks train singly")
    return _FusedPairFn.apply(
        x, dict(d1=d1, d2=d2, causal=causal, norm_type=norm_type),
        *params_a, *params_b)
