"""A TCN block under tensor (channel) parallelism, split at its two gLN
statistics: the pieces around the stage-2 kernel B6 and the kernel itself.

Counterpart of ``convtasnet_tpu/ops/pallas/tcn_block_tp.py``. One block
per shard of the hidden width (Hs = H / m), gLN:

- ``tp_stage1``: h = PReLU(x @ W_in_s) and the shard's partial gLN-1 sums;
- the caller sums them over the shards (``stats_from_sums``);
- ``fused_tp_stage2``: gLN-1 applied inside the dilated depthwise conv,
  PReLU, the shard's partial gLN-2 sums and its partial out product
  z = round(y g2) @ W_out_s: kernel B6 (``csrc/tcn_block_tp.cu``, design
  note there) on CUDA tensors, its plain twin ``tp_stage2_reference`` (the
  math of ``xla_tp_stage2``) on CPU tensors; no fallback on CUDA tensors.
  ``fused_tp_stage2.launches`` counts the calls that launched the kernel;
- the caller sums z, the gLN-2 sums and g2 @ W_out, b2 @ W_out over the
  shards, and ``tp_epilogue`` folds gLN-2 and the residual in.

Stage 1, the statistics and the epilogue are plain tensor ops here, as
JAX leaves them to XLA outside any kernel.

``tp_stage2_ad`` is stage 2 under autograd, the counterpart of the JAX
``tp_stage2_ad``: its forward is ``fused_tp_stage2`` and saves only the
inputs; its backward recomputes through autograd of the twin at those
inputs, as JAX's ``_tp_stage2_bwd`` differentiates ``xla_tp_stage2``. The
JAX package has no backward kernel for stage 2, so neither has the port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from convtasnet_tpu_torch.ops.conv import depthwise_conv1d
from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.cuda.tcn_block import padded, taps_refusal
from convtasnet_tpu_torch.ops.norm import EPS

_ENTRY = {torch.float32: "ctn_tcn_block_tp2_f32",
          torch.bfloat16: "ctn_tcn_block_tp2_bf16"}


def shape_refusal(Hs: int, B: int, P: int, causal: bool) -> Optional[str]:
    """Why B6 refuses stage 2 of a gLN block at shard width Hs (H / m),
    bottleneck width B and P taps, or None where it takes it: any Hs and
    B, and any P the JAX package runs (``taps_refusal``; its depthwise
    walks take any P). (B6 is gLN only; ``fused_tp_stage2`` refuses
    another norm on any device.) Hs and B need not be multiples of 64: the
    wrapper zero-pads them, and a padded channel (no gLN-1 affine, no taps,
    no weights) adds 0 to z and to the gLN-2 sums. In f32 every padded Hs
    runs one route, y g2 through device memory into a 3xTF32 product; in
    bf16 a padded Hs up to 512 keeps its tile of y in shared memory and a
    wider one runs the wide route (``csrc/tcn_block_tp.cu``)."""
    return taps_refusal(P, causal)


def pad_shard(h: torch.Tensor, dw: torch.Tensor, w_out: torch.Tensor,
              gamma1: torch.Tensor, beta1: torch.Tensor,
              gamma2: torch.Tensor):
    """Stage 2's operands with Hs and B zero-padded up to multiples of
    64, as B6 runs them: h [M, K, Hs], dw [P, Hs], w_out [Hs, B] and the
    affines [Hs]. A padded channel has no gLN-1 affine and no taps, so its
    y is 0: it adds nothing to z or to the gLN-2 sums; a padded column of
    z is dropped."""
    Hs, B = w_out.shape
    dh, db = padded(Hs) - Hs, padded(B) - B
    if not dh and not db:
        return h, dw, w_out, gamma1, beta1, gamma2
    pad = torch.nn.functional.pad
    return (pad(h, (0, dh)), pad(dw, (0, dh)), pad(w_out, (0, db, 0, dh)),
            *(pad(v, (0, dh)) for v in (gamma1, beta1, gamma2)))


def tp_stage1(x: torch.Tensor, w_in: torch.Tensor,
              a1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h = PReLU(x @ W_in_s)`` and its per-sample partial gLN-1 sums.

    x: [M, K, B]; w_in: [B, Hs] (this shard's columns). Returns ``(h [M, K,
    Hs] in x's dtype, sums [M, 2] f32)``: the product of x's dtype operands
    taken in f32, PReLU and the sums in f32, then h rounded."""
    h = x.float() @ w_in.to(x.dtype).float()
    h = torch.where(h >= 0, h, a1.float() * h)
    sums = torch.stack([h.sum(dim=(1, 2)), (h * h).sum(dim=(1, 2))], dim=-1)
    return h.to(x.dtype), sums


def stats_from_sums(sums: torch.Tensor, n: int) -> torch.Tensor:
    """Shard-summed ``[M, 2]`` (sum, sum of squares) -> ``[M, 2]`` (mean,
    rsqrt(var + eps)), ``n`` the element count per sample over the whole
    hidden width (K * H), the variance E[v^2] - mean^2."""
    mean = sums[:, 0] / n
    var = sums[:, 1] / n - mean * mean
    return torch.stack([mean, torch.rsqrt(var + EPS)], dim=-1)


def tp_epilogue(x: torch.Tensor, z: torch.Tensor, stats2: torch.Tensor,
                w1: torch.Tensor, w0: torch.Tensor) -> torch.Tensor:
    """``x + rs2 z - mean2 rs2 w1 + w0`` with z, w1 = g2 @ W_out and
    w0 = b2 @ W_out ([B], f32) summed over the shards."""
    mean2 = stats2[:, 0][:, None, None]
    rs2 = stats2[:, 1][:, None, None]
    out = rs2 * z.float() - (mean2 * rs2) * w1 + w0
    return x + out.to(x.dtype)


def tp_stage2_reference(
    h: torch.Tensor, stats1: torch.Tensor, dw: torch.Tensor,
    w_out: torch.Tensor, a2: torch.Tensor, gamma1: torch.Tensor,
    beta1: torch.Tensor, gamma2: torch.Tensor, *, dilation: int,
    causal: bool, rounding: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 in plain PyTorch (the math of ``xla_tp_stage2``): gLN-1 in
    f32 rounded to h's dtype, the depthwise conv in h's dtype, PReLU and
    the gLN-2 sums in f32, round(y g2) @ W_out in f32 rounded to h's
    dtype. Returns ``(z [M, K, B], sums [M, 2] f32)``.

    ``rounding="pallas"`` rounds where the Pallas kernel and B6 do
    instead: the normalised input and the conv output stay in f32, so
    only y g2 and z are rounded; in bf16 B6 differs from it by summation
    order alone, which a rounding fault does not."""
    if rounding not in ("xla", "pallas"):
        raise ValueError(f"rounding must be 'xla' or 'pallas', got "
                         f"{rounding!r}")
    dt = h.dtype
    mean1 = stats1[:, 0][:, None, None]
    rs1 = stats1[:, 1][:, None, None]
    n1 = (h.float() - mean1) * rs1 * gamma1.float() + beta1.float()
    if rounding == "xla":
        yf = depthwise_conv1d(n1.to(dt), dw.to(dt), dilation,
                              causal).float()
    else:
        yf = depthwise_conv1d(n1, dw.to(dt).float(), dilation, causal)
    yf = torch.where(yf >= 0, yf, a2.float() * yf)
    sums = torch.stack([yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))],
                       dim=-1)
    yg = (yf * gamma2.float()).to(dt)
    z = (yg.float() @ w_out.to(dt).float()).to(dt)
    return z, sums


def fused_tp_stage2(
    h: torch.Tensor,        # [M, K, Hs]
    stats1: torch.Tensor,   # [M, 2] f32: mean1, rs1 of the whole width
    dw: torch.Tensor,       # [P, Hs]
    w_out: torch.Tensor,    # [Hs, B]
    a2: torch.Tensor,       # scalar
    gamma1: torch.Tensor, beta1: torch.Tensor, gamma2: torch.Tensor,  # [Hs]
    *,
    dilation: int,
    causal: bool,
    norm_type: str = "gLN",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 of one shard's block -> ``(z [M, K, B] in h's dtype, sums
    [M, 2] f32)``, at any shard width Hs and bottleneck width B (the kernel
    runs them zero-padded to multiples of 64; in f32 four launches through
    a workspace of W_out_s's tf32 split and y g2 [M, K, Hs] at every width,
    in bf16 a padded Hs above 512 on its wide route, three launches through
    a workspace of [M, K, Hs]). gLN only, as the Pallas kernel: cLN and BN
    blocks take the per-norm path (``parallel/tensor_parallel.py``)."""
    if norm_type != "gLN":
        raise ValueError(f"the TP stage-2 kernel (B6) is gLN only, got "
                         f"{norm_type}: cLN and BN blocks take the per-norm "
                         "tensor-parallel path")
    args = (h, stats1, dw, w_out, a2, gamma1, beta1, gamma2)
    if h.device.type == "cpu":
        return tp_stage2_reference(*args, dilation=dilation, causal=causal)
    return _launch_cuda(*args, dilation=dilation, causal=causal)


fused_tp_stage2.launches = 0


def _launch_cuda(h, stats1, dw, w_out, a2, gamma1, beta1, gamma2, *,
                 dilation, causal):
    """The CUDA branch of ``fused_tp_stage2``: builds the kernel at first
    use, checks, allocates, launches on the current stream, and raises on
    anything the kernel does not take."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, stats1, dw, w_out, a2, gamma1,
                                      beta1, gamma2)):
        raise NotImplementedError(
            "fused_tp_stage2 launches the CUDA stage-2 kernel forward only: "
            "its outputs carry no gradient. Train through tp_stage2_ad, or "
            "run inference under torch.inference_mode() or torch.no_grad()")
    lib = load_library()
    if h.device.type != "cuda":
        raise ValueError(f"fused_tp_stage2 runs on CPU or CUDA tensors, got "
                         f"{h.device}")
    if h.dtype not in _ENTRY:
        raise TypeError(f"the TP stage-2 kernel takes float32 or bfloat16, "
                        f"got {h.dtype}")
    if h.dim() != 3:
        raise ValueError(f"h must be [M, K, Hs], got {tuple(h.shape)}")
    M, K, Hs = h.shape
    P = dw.shape[0]
    B = w_out.shape[-1]
    if (tuple(dw.shape) != (P, Hs) or tuple(w_out.shape) != (Hs, B)
            or tuple(stats1.shape) != (M, 2)):
        raise ValueError(f"shapes dw {tuple(dw.shape)}, w_out "
                         f"{tuple(w_out.shape)}, stats1 "
                         f"{tuple(stats1.shape)} do not fit h "
                         f"{tuple(h.shape)}")
    refusal = shape_refusal(Hs, B, P, causal)
    if refusal:
        raise ValueError(refusal)
    dt = h.dtype
    h = h.contiguous()
    dw, w_out = (t.to(dt).contiguous() for t in (dw, w_out))
    vecs = [t.to(torch.float32).reshape(-1).contiguous()
            for t in (stats1, a2, gamma1, beta1, gamma2)]
    for t in (dw, w_out, *vecs):
        if t.device != h.device:
            raise ValueError(f"all operands must be on {h.device}, one is on "
                             f"{t.device}")
    if vecs[1].numel() != 1 or any(v.numel() != Hs for v in vecs[2:]):
        raise ValueError("the PReLU slope must be a scalar and the norm "
                         "vectors [Hs]")
    B_in = B
    h, dw, w_out, g1, b1, g2 = pad_shard(h, dw, w_out, *vecs[2:])
    vecs[2:] = [g1, b1, g2]
    Hs, B = w_out.shape
    if w_out.data_ptr() % 16:
        raise ValueError("the kernel needs a 16-byte aligned w_out")
    f32 = dict(dtype=torch.float32, device=h.device)
    z = torch.empty((M, K, B), dtype=dt, device=h.device)
    n_part, n_y = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ctn_tcn_block_tp2_workspace(M, K, Hs, B, h.element_size(),
                                    ctypes.byref(n_part), ctypes.byref(n_y))
    part = torch.empty(n_part.value, **f32)
    sums = torch.empty((M, 2), **f32)
    # f32: W_out_s's tf32 split and y g2; bf16: the wide route's round(y
    # g2), allocated only where it runs
    yw = (torch.empty(n_y.value, dtype=dt, device=h.device) if n_y.value
          else None)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = getattr(lib, _ENTRY[dt])(
            h.data_ptr(), vecs[0].data_ptr(), dw.data_ptr(),
            w_out.data_ptr(), *(v.data_ptr() for v in vecs[1:]),
            z.data_ptr(), part.data_ptr(), sums.data_ptr(),
            None if yw is None else yw.data_ptr(),
            M, K, Hs, B, P, dilation, int(causal), stream)
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"tcn_block_tp kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    fused_tp_stage2.launches += 1
    return (z if B == B_in else z[..., :B_in].contiguous()), sums


class _TpStage2Fn(torch.autograd.Function):
    """Stage-2 forward through ``fused_tp_stage2``; saves only the inputs
    and differentiates the twin at them in the backward (the remat
    backward of ``_tp_stage2_bwd``)."""

    @staticmethod
    def forward(ctx, h, stats1, dw, w_out, a2, gamma1, beta1, gamma2, kw):
        ctx.save_for_backward(h, stats1, dw, w_out, a2, gamma1, beta1, gamma2)
        ctx.kw = kw
        return fused_tp_stage2(h, stats1, dw, w_out, a2, gamma1, beta1,
                               gamma2, **kw)

    @staticmethod
    def backward(ctx, gz, gsums):
        prims = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            z, sums = tp_stage2_reference(*prims, **ctx.kw)
        grads = torch.autograd.grad((z, sums), prims, (gz, gsums))
        return (*grads, None)


def tp_stage2_ad(
    h: torch.Tensor, stats1: torch.Tensor, dw: torch.Tensor,
    w_out: torch.Tensor, a2: torch.Tensor, gamma1: torch.Tensor,
    beta1: torch.Tensor, gamma2: torch.Tensor, *, dilation: int,
    causal: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable stage 2 -> ``(z, sums)`` as ``fused_tp_stage2``;
    gradients come back in each input's dtype."""
    return _TpStage2Fn.apply(h, stats1, dw, w_out, a2, gamma1, beta1, gamma2,
                             dict(dilation=dilation, causal=causal))
