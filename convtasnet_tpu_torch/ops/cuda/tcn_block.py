"""One TCN block forward: the hand-written CUDA kernel and its plain twin.

Counterpart of ``convtasnet_tpu/ops/pallas/tcn_block.py`` (the Pallas
``_kernel`` behind ``fused_tcn_block``, and ``_xla_block`` as its plain
math). The kernel is ``csrc/tcn_block.cu``; its design note is there.

``fused_tcn_block`` takes the JAX wrapper's arguments in the same order and
layout. On CPU tensors it runs the plain twin
``fused_tcn_block_reference``; on CUDA tensors it launches the kernel or
raises, with no fallback. ``fused_tcn_block.launches`` counts the calls
that launched the kernel.

``fused_tcn_block_ad`` is the differentiable block (the counterpart of
``_fused_block_ad``): its forward is ``fused_tcn_block`` and saves only the
block inputs; its backward recomputes the rest in
``ops/cuda/tcn_block_bwd.fused_tcn_block_bwd`` (the backward kernel of
the block's norm on CUDA tensors, B2 for gLN and B3 for cLN; the twin on
CPU ones). gLN and cLN, as those kernels are; BN blocks train through the
plain ops with batch statistics.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from convtasnet_tpu_torch.models.functional import block_forward
from convtasnet_tpu_torch.ops.conv import depthwise_conv1d
from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.norm import (
    batch_norm,
    channelwise_layer_norm,
    global_layer_norm,
)

NORM_CODES = {"gLN": 0, "cLN": 1, "BN": 2}
_ENTRY = {torch.float32: "ctn_tcn_block_f32",
          torch.bfloat16: "ctn_tcn_block_bf16"}
TILE = 64          # the kernels run B and H at multiples of the GEMM tile
                   # (kBM = kBN); other widths are zero-padded up to one


def shape_refusal(B: int, H: int, P: int, causal: bool) -> Optional[str]:
    """Why the TCN block kernels (B1, and the backwards B2 and B3, which
    take the same widths) refuse a block of bottleneck width B, hidden
    width H and P depthwise taps, or None where they take it: any B and H
    (``pad_block``) and any P the JAX package runs, P >= 1 when causal and
    odd otherwise (``ops/conv.py`` refuses an even P outside the causal
    mode in the same words). The kernels run P <= 16 on their first
    routes and more taps in chunks of 16 beside them. The wrappers raise
    it on a CUDA tensor; ``ops/cuda/shapes.py`` applies it to a whole
    configuration."""
    return taps_refusal(P, causal)


def taps_refusal(P: int, causal: bool) -> Optional[str]:
    """The depthwise taps' rule of B1-B6: an even P outside the causal
    mode has no SAME padding, as ``ops/conv.py`` says of it."""
    if not causal and P % 2 == 0:
        return f"non-causal SAME padding requires odd kernel size, got P={P}"
    return None


def padded(n: int) -> int:
    """n rounded up to a multiple of the GEMM tile."""
    return -(-n // TILE) * TILE


def pad_block(mats, vecs):
    """One block's operands at the widths the kernels run it: ``mats`` =
    (w_in [B, H], dw [P, H], w_out [H, B]) zero-padded to ``padded(B)``
    and ``padded(H)``, and each of ``vecs`` (norm affines, BN statistics,
    all [H]) to ``padded(H)``. A padded hidden channel has no weights, so
    its activations are 0 and add nothing to the norms' sums, which the
    kernels divide by the block's own H (their ``Hn``): the real channels
    see the unpadded block's statistics. A padded bottleneck channel has no
    weights either; its output is 0, and the caller drops it."""
    w_in, dw, w_out = mats
    B, H = w_in.shape
    db, dh = padded(B) - B, padded(H) - H
    pad = torch.nn.functional.pad
    return ([pad(w_in, (0, dh, 0, db)), pad(dw, (0, dh)),
             pad(w_out, (0, db, 0, dh))], [pad(v, (0, dh)) for v in vecs])


def fused_tcn_block_reference(
    x: torch.Tensor, w_in: torch.Tensor, dw: torch.Tensor,
    w_out: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    gamma1: torch.Tensor, beta1: torch.Tensor,
    gamma2: torch.Tensor, beta2: torch.Tensor,
    *, dilation: int, causal: bool, norm_type: str,
    bn_stats: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """The block in plain PyTorch (the math of ``_xla_block``): products in
    x's dtype, norm statistics in f32."""
    m1, v1, m2, v2 = bn_stats if norm_type == "BN" else (None,) * 4

    def make_norm(g, b, m, v):
        def norm(h):
            hf = h.float()
            if norm_type == "gLN":
                out = global_layer_norm(hf, g.float(), b.float())
            elif norm_type == "cLN":
                out = channelwise_layer_norm(hf, g.float(), b.float())
            else:
                out = batch_norm(hf, g.float(), b.float(), m.float(), v.float())
            return out.to(h.dtype)

        return norm

    blk = {"conv1x1": w_in, "prelu1": a1, "dwconv": dw,
           "prelu2": a2, "pwconv": w_out}
    return block_forward(
        blk, x,
        dwconv=lambda h, w: depthwise_conv1d(h, w, dilation, causal),
        norm1=make_norm(gamma1, beta1, m1, v1),
        norm2=make_norm(gamma2, beta2, m2, v2),
    )


def fused_tcn_block(
    x: torch.Tensor,          # [M, K, B]
    w_in: torch.Tensor,       # [B, H]
    dw: torch.Tensor,         # [P, H]
    w_out: torch.Tensor,      # [H, B]
    a1: torch.Tensor,         # scalar
    a2: torch.Tensor,         # scalar
    gamma1: torch.Tensor, beta1: torch.Tensor,   # [H]
    gamma2: torch.Tensor, beta2: torch.Tensor,   # [H]
    *,
    dilation: int,
    causal: bool,
    norm_type: str,
    bn_stats: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """Forward of one TCN block -> [M, K, B] in x's dtype.

    ``bn_stats`` = (mean1, var1, mean2, var2) running statistics, for BN.
    """
    if norm_type not in NORM_CODES:
        raise ValueError(f"unsupported norm_type: {norm_type}")
    if norm_type == "BN" and bn_stats is None:
        raise ValueError("norm_type='BN' needs bn_stats")
    args = (x, w_in, dw, w_out, a1, a2, gamma1, beta1, gamma2, beta2)
    kw = dict(dilation=dilation, causal=causal, norm_type=norm_type,
              bn_stats=bn_stats)
    if x.device.type == "cpu":
        return fused_tcn_block_reference(*args, **kw)
    return _launch_cuda(*args, **kw)


fused_tcn_block.launches = 0


@functools.lru_cache(maxsize=64)
def _stores_y(B: int, H: int, bf16: bool) -> bool:
    """Whether the kernel at these widths keeps y in device memory (the
    first design and the f32 Hopper stages) or recomputes it (the bf16
    Hopper stages; which widths they take lives in tcn_block.cu)."""
    return bool(load_library().ctn_tcn_block_stores_y(B, H, int(bf16)))


@functools.lru_cache(maxsize=64)
def _weights(B: int, H: int, bf16: bool) -> int:
    """Elements of the w_eff buffer the kernel at these widths takes: W_eff
    [H, B], or the f32 stages' W_in^T and W_eff^T as tf32 hi and lo
    copies (tcn_block_tf32.cuh)."""
    return int(load_library().ctn_tcn_block_weights(B, H, int(bf16)))


@functools.lru_cache(maxsize=64)
def _partials(K: int, H: int, norm_code: int) -> Tuple[int, int]:
    """(sum, sum of squares) partials per sample (gLN) or per row (cLN)
    that launches A and B write; the tile sizes live in tcn_block.cu."""
    n_a, n_b = ctypes.c_longlong(), ctypes.c_longlong()
    load_library().ctn_tcn_block_partials(K, H, norm_code, ctypes.byref(n_a),
                                          ctypes.byref(n_b))
    return n_a.value, n_b.value


def _launch_cuda(x, w_in, dw, w_out, a1, a2, gamma1, beta1, gamma2, beta2,
                 *, dilation, causal, norm_type, bn_stats):
    """The CUDA branch of ``fused_tcn_block``: builds the kernel at first
    use, checks, allocates, launches on the current stream, and raises on
    anything the kernel does not take."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_in, dw, w_out, a1, a2, gamma1,
                                      beta1, gamma2, beta2)):
        raise NotImplementedError(
            "fused_tcn_block launches the CUDA TCN-block kernel forward only: "
            "its output carries no gradient. Train through "
            "fused_tcn_block_ad, whose backward is the block backward "
            "kernel, or run inference under torch.inference_mode() or "
            "torch.no_grad()")
    lib = load_library()
    if x.device.type != "cuda":
        raise ValueError(f"fused_tcn_block runs on CPU or CUDA tensors, "
                         f"got {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_tcn_block kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [M, K, B], got {tuple(x.shape)}")
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
    w_in, dw, w_out = (t.to(dt).contiguous() for t in (w_in, dw, w_out))
    vecs = [t.to(torch.float32).reshape(-1).contiguous()
            for t in (a1, a2, gamma1, beta1, gamma2, beta2)]
    if norm_type == "BN":
        vecs += [t.to(torch.float32).reshape(-1).contiguous() for t in bn_stats]
    for t in (w_in, dw, w_out, *vecs):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, "
                             f"one is on {t.device}")
    if any(v.numel() != 1 for v in vecs[:2]) or any(
            v.numel() != H for v in vecs[2:]):
        raise ValueError("PReLU slopes must be scalars and norm vectors [H]")
    B_in, Hn = B, H
    if (padded(B), padded(H)) != (B, H):
        (w_in, dw, w_out), vecs[2:] = pad_block((w_in, dw, w_out), vecs[2:])
        B, H = padded(B), padded(H)
        x = torch.nn.functional.pad(x, (0, B - B_in))
    for t in (x, w_in, dw, w_out):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x, w_in, dw, "
                             "w_out")

    code = NORM_CODES[norm_type]
    n_a, n_b = _partials(K, H, code)
    rows = M if norm_type == "gLN" else M * K   # partials per sample or row
    f32 = dict(dtype=torch.float32, device=x.device)
    h = torch.empty((M, K, H), dtype=dt, device=x.device)
    # the bf16 Hopper stages recompute y inside the output launch
    y = (torch.empty((M, K, H), dtype=dt, device=x.device)
         if _stores_y(B, H, dt == torch.bfloat16) else None)
    w_eff = torch.empty(_weights(B, H, dt == torch.bfloat16), dtype=dt,
                        device=x.device)
    # the column sums g2 @ W_out and b2 @ W_out, per 64-row block in bf16
    wsum = torch.empty(2 * B * (H // TILE), **f32)
    part_a = torch.empty(2 * rows * n_a, **f32) if n_a else None
    part_b = torch.empty(2 * rows * n_b, **f32) if n_b else None
    out = torch.empty_like(x)
    bn_ptrs = ([v.data_ptr() for v in vecs[6:]] if norm_type == "BN"
               else [None] * 4)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[dt])(
            x.data_ptr(), w_in.data_ptr(), dw.data_ptr(), w_out.data_ptr(),
            *[v.data_ptr() for v in vecs[:6]], *bn_ptrs,
            h.data_ptr(), ptr(y), w_eff.data_ptr(), wsum.data_ptr(),
            ptr(part_a), ptr(part_b), out.data_ptr(),
            M, K, B, H, Hn, P, dilation, int(causal), code, stream)
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"tcn_block kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    fused_tcn_block.launches += 1
    return out if B == B_in else out[..., :B_in].contiguous()


class _FusedBlockFn(torch.autograd.Function):
    """Forward kernel + backward kernel; saves only the block inputs and
    recomputes the intermediates in the backward (remat, as
    ``_fused_block_fwd`` does)."""

    @staticmethod
    def forward(ctx, x, w_in, dw, w_out, a1, a2, gamma1, beta1, gamma2,
                beta2, kw):
        ctx.save_for_backward(x, w_in, dw, w_out, a1, a2, gamma1, beta1,
                              gamma2, beta2)
        ctx.kw = kw
        return fused_tcn_block(x, w_in, dw, w_out, a1, a2, gamma1, beta1,
                               gamma2, beta2, **kw)

    @staticmethod
    def backward(ctx, g):
        # imported here: tcn_block_bwd imports this module for the twin
        from convtasnet_tpu_torch.ops.cuda.tcn_block_bwd import (
            fused_tcn_block_bwd,
        )

        x, *weights = ctx.saved_tensors
        grads = fused_tcn_block_bwd(x, g.contiguous(), *weights, **ctx.kw)
        return (*grads, None)


def fused_tcn_block_ad(
    x: torch.Tensor, w_in: torch.Tensor, dw: torch.Tensor,
    w_out: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    gamma1: torch.Tensor, beta1: torch.Tensor,
    gamma2: torch.Tensor, beta2: torch.Tensor,
    *, dilation: int, causal: bool, norm_type: str = "gLN",
) -> torch.Tensor:
    """Differentiable gLN or cLN block -> [M, K, B] in x's dtype.
    Gradients come back in each primal's dtype (f32 weights, x's dtype for
    dx)."""
    if norm_type not in ("gLN", "cLN"):
        raise NotImplementedError(
            f"fused_tcn_block_ad takes gLN and cLN, got {norm_type}: BN "
            "blocks train through the plain ops with batch statistics")
    return _FusedBlockFn.apply(x, w_in, dw, w_out, a1, a2, gamma1, beta1,
                               gamma2, beta2,
                               dict(dilation=dilation, causal=causal,
                                    norm_type=norm_type))
