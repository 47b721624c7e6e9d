"""The dual-path FFN sublayer: the hand-written CUDA kernel and its plain
twin.

Counterpart of ``convtasnet_tpu/ops/pallas/dpt_ffn.py`` (the Pallas
``_ffn_kernel`` behind ``fused_ffn``, and ``xla_ffn`` as its plain math).
The kernel is ``csrc/dpt_ffn.cu``; its design note is there.

``fused_ffn`` takes the JAX wrapper's arguments in the same order and
layout: x [M, K, B] (positions flattened), LN gamma/beta [B],
w_up [B, F], b_up [F], w_down [F, B], b_down [B]. The activation is GELU's
tanh approximation, ``jax.nn.gelu``'s default. On CPU tensors it runs the
plain twin; on CUDA tensors it launches the kernel or raises, with no
fallback. ``fused_ffn.launches`` counts the calls that launched it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.cuda.dpt_attention import MAX_WIDTH, TILE
from convtasnet_tpu_torch.ops.norm import layer_norm

_ENTRY = {torch.float32: "ctn_dpt_ffn_f32", torch.bfloat16: "ctn_dpt_ffn_bf16"}


def ffn_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w_up: torch.Tensor, b_up: torch.Tensor,
                  w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """The pre-LN GELU MLP + residual in plain PyTorch (the math of
    ``xla_ffn``): products and bias adds in x's dtype, LN statistics in
    f32."""
    dt = x.dtype
    y = layer_norm(x, gamma, beta)
    y = y @ w_up.to(dt) + b_up.to(dt)
    y = F.gelu(y, approximate="tanh")
    y = y @ w_down.to(dt) + b_down.to(dt)
    return x + y


def fused_ffn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w_up: torch.Tensor, b_up: torch.Tensor, w_down: torch.Tensor,
              b_down: torch.Tensor) -> torch.Tensor:
    """FFN sublayer -> [M, K, B] in x's dtype."""
    args = (x, gamma, beta, w_up, b_up, w_down, b_down)
    if x.device.type == "cpu":
        return ffn_reference(*args)
    out = _launch_cuda(*args)
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0


def _launch_cuda(x, gamma, beta, w_up, b_up, w_down, b_down):
    """The CUDA branch of ``fused_ffn``: builds the kernels at first use,
    checks, allocates, launches on the current stream, and raises on
    anything the kernel does not take."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta, w_up, b_up, w_down,
                                      b_down)):
        raise NotImplementedError(
            "fused_ffn launches the CUDA FFN kernel forward only: its output "
            "carries no gradient. The DPT backward kernels (B8, B10, B12) "
            "are not ported yet (ROADMAP A7, DPT training); run inference "
            "under torch.inference_mode() or torch.no_grad()")
    lib = load_library()
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_ffn kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [M, K, B], got {tuple(x.shape)}")
    M, K, B = x.shape
    Fw = w_up.shape[-1]
    if B % TILE or B > MAX_WIDTH or Fw % (2 * TILE):
        raise ValueError(f"the kernel needs B a multiple of {TILE} and at "
                         f"most {MAX_WIDTH}, and F a multiple of {2 * TILE}, "
                         f"got B={B} F={Fw}")
    if tuple(w_up.shape) != (B, Fw) or tuple(w_down.shape) != (Fw, B):
        raise ValueError(f"weight shapes {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not fit x {tuple(x.shape)}")
    dt = x.dtype
    x = x.contiguous()
    w_up, w_down = (t.to(dt).contiguous() for t in (w_up, w_down))
    vecs = [t.to(torch.float32).reshape(-1).contiguous()
            for t in (gamma, beta, b_up, b_down)]
    if [v.numel() for v in vecs] != [B, B, Fw, B]:
        raise ValueError("gamma, beta, b_down must be [B] and b_up [F]")
    for t in (w_up, w_down, *vecs):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on "
                             f"{t.device}")
    for t in (x, w_up, w_down):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x, w_up, w_down")

    g, b, bu, bd = vecs
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[dt])(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w_up.data_ptr(),
            bu.data_ptr(), w_down.data_ptr(), bd.data_ptr(), out.data_ptr(),
            M * K, B, Fw, stream)
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"dpt ffn kernel launch failed: CUDA error {err} "
                           f"({msg})")
    return out
