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

The backward is kernel B12 (``csrc/dpt_ffn_bwd.cu``) behind
``fused_ffn_bwd``, the counterpart of the JAX wrapper of the same name:
``(dx, dgamma, dbeta, dw_up, db_up, dw_down, db_down)`` in the primals'
dtypes, the twin ``ffn_bwd_reference`` on CPU tensors. ``fused_ffn_ad``
joins the two kernels in an autograd Function that saves only the
primals.

Every function here takes ``partial``, as the JAX wrappers do: with
``partial=True`` the weights are a tensor-parallel shard of the hidden
width (w_up [B, F/m], b_up [F/m], w_down [F/m, B]; ``parallel/dpt_tp.py``)
and the sublayer returns the down projection alone, with neither the down
bias nor the residual; in its backward dx has no residual term and
db_down is zero. A partial launch counts in ``partial_launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.cuda.dpt_attention import (
    MAX_WIDTH,
    TILE,
    count_launch,
    needs_grad,
    raise_on_error,
)
from convtasnet_tpu_torch.ops.norm import LN_EPS, layer_norm

_ENTRY = {torch.float32: "ctn_dpt_ffn_f32", torch.bfloat16: "ctn_dpt_ffn_bf16"}
_BWD_ENTRY = {torch.float32: "ctn_dpt_ffn_bwd_f32",
              torch.bfloat16: "ctn_dpt_ffn_bwd_bf16"}
_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715


def ffn_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w_up: torch.Tensor, b_up: torch.Tensor,
                  w_down: torch.Tensor, b_down: torch.Tensor,
                  partial: bool = False) -> torch.Tensor:
    """The pre-LN GELU MLP + residual in plain PyTorch (the math of
    ``xla_ffn``): products and bias adds in x's dtype, LN statistics in
    f32. ``partial``: a hidden-width shard's down projection alone
    (``b_down`` unused)."""
    dt = x.dtype
    y = layer_norm(x, gamma, beta)
    y = y @ w_up.to(dt) + b_up.to(dt)
    y = F.gelu(y, approximate="tanh")
    if partial:
        return y @ w_down.to(dt)
    y = y @ w_down.to(dt) + b_down.to(dt)
    return x + y


def fused_ffn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w_up: torch.Tensor, b_up: torch.Tensor, w_down: torch.Tensor,
              b_down: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """FFN sublayer -> [M, K, B] in x's dtype."""
    args = (x, gamma, beta, w_up, b_up, w_down, b_down)
    if x.device.type == "cpu":
        return ffn_reference(*args, partial=partial)
    out = _launch_cuda(*args, partial=partial)
    count_launch(fused_ffn, partial)
    return out


fused_ffn.launches = 0
fused_ffn.partial_launches = 0


def _prepare(name, x, gamma, beta, w_up, b_up, w_down, b_down):
    """Checks the operands of the FFN kernels (forward or backward) and
    returns them as the kernels take them: x and the weights contiguous in
    x's dtype, the LN affines and biases contiguous in f32. Raises on
    anything the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be [M, K, B], got {tuple(x.shape)}")
    M, K, B = x.shape
    Fw = w_up.shape[-1]
    if B % TILE or B > MAX_WIDTH or Fw % (2 * TILE):
        raise ValueError(f"the kernel needs B a multiple of {TILE} and at "
                         f"most {MAX_WIDTH}, and F (F/m for a shard of m) a "
                         f"multiple of {2 * TILE}, got B={B} F={Fw}")
    if tuple(w_up.shape) != (B, Fw) or tuple(w_down.shape) != (Fw, B):
        raise ValueError(f"weight shapes {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not fit x {tuple(x.shape)}")
    dt = x.dtype
    x = x.detach().contiguous()
    w_up, w_down = (t.detach().to(dt).contiguous() for t in (w_up, w_down))
    vecs = [t.detach().to(torch.float32).reshape(-1).contiguous()
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
    g_, b_, bu, bd = vecs
    return x, g_, b_, w_up, bu, w_down, bd


def _launch_cuda(x, gamma, beta, w_up, b_up, w_down, b_down,
                 partial: bool = False):
    """The CUDA branch of ``fused_ffn``: builds the kernels at first use,
    checks, allocates, launches on the current stream, and raises on
    anything the kernel does not take."""
    if needs_grad(x, gamma, beta, w_up, b_up, w_down, b_down):
        raise NotImplementedError(
            "fused_ffn launches the CUDA FFN kernel forward only: its output "
            "carries no gradient. Train through fused_ffn_ad, whose backward "
            "is the B12 kernel, or run inference under "
            "torch.inference_mode() or torch.no_grad()")
    lib = load_library()
    x, g, b, w_up, bu, w_down, bd = _prepare("fused_ffn", x, gamma, beta,
                                             w_up, b_up, w_down, b_down)
    M, K, B = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w_up.data_ptr(),
            bu.data_ptr(), w_down.data_ptr(), bd.data_ptr(), out.data_ptr(),
            M * K, B, w_up.shape[1], int(partial), stream)
    raise_on_error(lib, err, "dpt ffn kernel")
    return out


def _gelu_and_grad(v: torch.Tensor):
    """tanh-GELU and its derivative in f32 (``_gelu_and_grad`` of the
    Pallas backward)."""
    t = torch.tanh(_GELU_C * (v + _GELU_A * v * v * v))
    return (0.5 * v * (1.0 + t),
            0.5 * (1.0 + t)
            + 0.5 * v * (1.0 - t * t) * _GELU_C * (1.0 + 3 * _GELU_A * v * v))


def ffn_bwd_reference(x, g, gamma, beta, w_up, b_up, w_down, b_down,
                      partial: bool = False):
    """The FFN sublayer's backward in plain PyTorch: the explicit math of
    the Pallas body ``_ffn_bwd_kernel`` with its rounding points. Products
    in f32 on values of x's dtype; pre = round(round(y W_up) +
    round(b_up)), h = round(gelu(pre)), dpre = round(dh gelu'(pre)) with
    the tanh-GELU and its derivative in f32; dh, dy and the LN backward in
    f32, dx = round(g + dx_ln). With ``partial`` (the backward of a shard's
    down projection alone) dx = round(dx_ln) and db_down is zero. Returns
    ``(dx, dgamma, dbeta, dw_up, db_up, dw_down, db_down)`` in the primals'
    dtypes."""
    dt = x.dtype
    B = x.shape[-1]

    def rnd(t):
        return t.to(dt).float()

    xf = x.float().reshape(-1, B)
    mean = xf.mean(-1, keepdim=True)
    rs = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + LN_EPS)
    xhat = (xf - mean) * rs
    y = rnd(xhat * gamma.float() + beta.float())
    wu, wd = rnd(w_up.float()), rnd(w_down.float())
    pre = rnd(rnd(y @ wu) + rnd(b_up.float()))
    h, dgelu = _gelu_and_grad(pre)
    h = rnd(h)
    gf = g.float().reshape(-1, B)
    dpre = rnd((gf @ wd.T) * dgelu)
    dy = dpre @ wu.T
    dxhat = dy * gamma.float()
    dx_ln = rs * (dxhat - dxhat.mean(-1, keepdim=True)
                  - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    db_down = torch.zeros_like(gf[0]) if partial else gf.sum(0)
    return ((dx_ln if partial else gf + dx_ln).to(dt).reshape(x.shape),
            (dy * xhat).sum(0).to(gamma.dtype), dy.sum(0).to(beta.dtype),
            (y.T @ dpre).to(w_up.dtype), dpre.sum(0).to(b_up.dtype),
            (h.T @ gf).to(w_down.dtype), db_down.to(b_down.dtype))


def fused_ffn_bwd(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
                  w_down: torch.Tensor, b_down: torch.Tensor,
                  partial: bool = False):
    """Backward of the FFN sublayer (x, g [M, K, B]) -> ``(dx, dgamma,
    dbeta, dw_up, db_up, dw_down, db_down)`` in the primals' dtypes."""
    args = (x, g, gamma, beta, w_up, b_up, w_down, b_down)
    if x.device.type == "cpu":
        return ffn_bwd_reference(*args, partial=partial)
    grads = _launch_cuda_bwd(*args, partial=partial)
    count_launch(fused_ffn_bwd, partial)
    return grads


fused_ffn_bwd.launches = 0
fused_ffn_bwd.partial_launches = 0


def _launch_cuda_bwd(x, g, gamma, beta, w_up, b_up, w_down, b_down,
                     partial: bool = False):
    """The CUDA branch of ``fused_ffn_bwd``: builds the kernels at first
    use, checks, allocates the workspace and the outputs, launches on the
    current stream, and raises on anything the kernel does not take."""
    lib = load_library()
    xc, g_, b_, w_up_c, bu, w_down_c, bd = _prepare(
        "fused_ffn_bwd", x, gamma, beta, w_up, b_up, w_down, b_down)
    M, K, B = xc.shape
    Fw = w_up_c.shape[1]
    if tuple(g.shape) != tuple(xc.shape):
        raise ValueError(f"g must have x's shape {tuple(xc.shape)}, got "
                         f"{tuple(g.shape)}")
    g = g.detach().to(xc.dtype).contiguous()
    if g.device != xc.device or g.data_ptr() % 16:
        raise ValueError(f"g must be a 16-byte aligned tensor on {xc.device}")
    n_act, n_f32 = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ctn_dpt_ffn_bwd_workspace(M * K, B, Fw, xc.element_size(),
                                  ctypes.byref(n_act), ctypes.byref(n_f32))
    f32 = dict(dtype=torch.float32, device=xc.device)
    ws_act = torch.empty(n_act.value, dtype=xc.dtype, device=xc.device)
    ws_f32 = torch.empty(n_f32.value, **f32)
    dx = torch.empty_like(xc)
    dgb = torch.empty((2, B), **f32)
    dw_up = torch.empty((B, Fw), **f32)
    db_up = torch.empty(Fw, **f32)
    dw_down = torch.empty((Fw, B), **f32)
    db_down = torch.empty(B, **f32)
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = getattr(lib, _BWD_ENTRY[xc.dtype])(
            xc.data_ptr(), g.data_ptr(), g_.data_ptr(), b_.data_ptr(),
            w_up_c.data_ptr(), bu.data_ptr(), w_down_c.data_ptr(),
            ws_act.data_ptr(), ws_f32.data_ptr(), dx.data_ptr(),
            dgb.data_ptr(), dw_up.data_ptr(), db_up.data_ptr(),
            dw_down.data_ptr(), db_down.data_ptr(), M * K, B, Fw,
            int(partial), stream)
    raise_on_error(lib, err, "dpt ffn backward kernel")
    return (dx, dgb[0].to(gamma.dtype), dgb[1].to(beta.dtype),
            dw_up.to(w_up.dtype), db_up.reshape(b_up.shape).to(b_up.dtype),
            dw_down.to(w_down.dtype),
            db_down.reshape(b_down.shape).to(b_down.dtype))


class _FusedFfnFn(torch.autograd.Function):
    """The FFN sublayer, forward kernel + backward kernel; saves only the
    primals and recomputes the rest in the backward (remat, as the JAX rule
    ``_fused_ffn_fwd`` does); ``partial`` runs both in their partial
    mode."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w_up, b_up, w_down, b_down, partial):
        ctx.save_for_backward(x, gamma, beta, w_up, b_up, w_down, b_down)
        ctx.partial = partial
        return fused_ffn(x, gamma, beta, w_up, b_up, w_down, b_down,
                         partial=partial)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        return (*fused_ffn_bwd(x, g.contiguous(), *weights,
                               partial=ctx.partial), None)


def fused_ffn_ad(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w_up: torch.Tensor, b_up: torch.Tensor, w_down: torch.Tensor,
                 b_down: torch.Tensor, partial: bool = False) -> torch.Tensor:
    """Differentiable FFN sublayer -> [M, K, B] in x's dtype: ``fused_ffn``
    forward, ``fused_ffn_bwd`` backward. Gradients come back in each
    primal's dtype."""
    return _FusedFfnFn.apply(x, gamma, beta, w_up, b_up, w_down, b_down,
                             partial)
