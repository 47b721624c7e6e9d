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

A width B off the kernels' 64-column tile runs zero-padded (``pad_ffn``),
with the kernels' LN over the sublayer's own B (their ``Bn``; the twins
take the same ``Bn``), and the outputs and cotangents sliced back
(``unpad_ffn_grads``), as in ``dpt_attention.py``. Every B runs (above
256 through a workspace, above 512 with the LN backward's rows on a
kernel of their own; ``csrc/dpt_ffn.cu``, ``csrc/dpt_ffn_bwd.cu``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.cuda.dpt_attention import (
    TILE,
    count_launch,
    ln_stats,
    needs_grad,
    padded,
    pre_ln,
    raise_on_error,
    row_mean,
)

_ENTRY = {torch.float32: "ctn_dpt_ffn_f32", torch.bfloat16: "ctn_dpt_ffn_bf16"}
_BWD_ENTRY = {torch.float32: "ctn_dpt_ffn_bwd_f32",
              torch.bfloat16: "ctn_dpt_ffn_bwd_bf16"}
F_TILE = 2 * TILE   # the kernels run F at a multiple of this (zero-padded)
_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715


def shape_refusal(B: int) -> Optional[str]:
    """Why the FFN kernels (B11, B12, and their partial modes) refuse a
    sublayer of width B, or None where they take it: they take every B > 0,
    zero-padded up to a multiple of 64 (``pad_ffn``; above 256 B11 runs
    three launches through a workspace, ``csrc/dpt_ffn.cu``), and any
    hidden width F (F / m for a shard of m): the wrappers zero-pad it to a
    multiple of ``F_TILE`` (``pad_hidden``)."""
    if B <= 0:
        return f"the kernel needs a width B > 0, got B={B}"
    return None


def ffn_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w_up: torch.Tensor, b_up: torch.Tensor,
                  w_down: torch.Tensor, b_down: torch.Tensor,
                  partial: bool = False,
                  Bn: Optional[int] = None) -> torch.Tensor:
    """The pre-LN GELU MLP + residual in plain PyTorch (the math of
    ``xla_ffn``): products and bias adds in x's dtype, LN statistics in
    f32. ``partial``: a hidden-width shard's down projection alone
    (``b_down`` unused). ``Bn``: the LN's statistics over the first Bn
    columns alone (the operands of ``pad_ffn``; None: all of them)."""
    dt = x.dtype
    y = pre_ln(x, gamma, beta, Bn)
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


def pad_hidden(w_up: torch.Tensor, b_up: torch.Tensor,
               w_down: torch.Tensor):
    """(w_up [B, F], b_up [F], w_down [F, B]) with F zero-padded up to a
    multiple of ``F_TILE``, as the kernels run it: a padded hidden unit
    has pre = 0, h = gelu(0) = 0 and dpre = 0, so it adds nothing to the
    output or to any gradient, and its own gradients are dropped."""
    df = -w_up.shape[-1] % F_TILE
    if not df:
        return w_up, b_up, w_down
    return (F.pad(w_up, (0, df)), F.pad(b_up, (0, df)),
            F.pad(w_down, (0, 0, 0, df)))


def pad_ffn(x, gamma, beta, w_up, w_down, b_down):
    """One FFN sublayer's operands at the width the kernels run it: x
    [..., B], gamma, beta and b_down [B] with zero columns up to Bp =
    ``padded(B)``, w_up [B, F] with zero rows and w_down [F, B] with zero
    columns to match. A padded column of x is zero, and with gamma and
    beta zero there so is y; it meets only zero weights, so every real
    output and cotangent is the unpadded sublayer's, given an LN whose
    statistics span the first B columns alone (the kernels' Bn, the
    twins' ``Bn``); the padded columns' own outputs are zero and dropped."""
    db = padded(x.shape[-1]) - x.shape[-1]
    if not db:
        return x, gamma, beta, w_up, w_down, b_down
    return (F.pad(x, (0, db)), F.pad(gamma, (0, db)), F.pad(beta, (0, db)),
            F.pad(w_up, (0, 0, 0, db)), F.pad(w_down, (0, db)),
            F.pad(b_down, (0, db)))


def unpad_ffn_grads(grads, B: int):
    """The backward's ``(dx, dgamma, dbeta, dw_up, db_up, dw_down,
    db_down)`` at the padded width of ``pad_ffn``, sliced back to the B
    real columns and rows."""
    dx, dgamma, dbeta, dw_up, db_up, dw_down, db_down = grads
    if dx.shape[-1] == B:
        return grads
    return (dx[..., :B], dgamma[:B], dbeta[:B], dw_up[:B], db_up,
            dw_down[:, :B], db_down[:B])


def _prepare(name, x, gamma, beta, w_up, b_up, w_down, b_down,
             Bn: Optional[int] = None):
    """Checks the operands of the FFN kernels (forward or backward) and
    returns them as the kernels take them: x and the weights contiguous in
    x's dtype, the LN affines and biases contiguous in f32, B zero-padded
    to the tile (``pad_ffn``) and F to ``F_TILE`` (``pad_hidden``); then
    the LN's width Bn (the real B, or the ``Bn`` given for operands that
    come zero-padded already). Raises on anything the kernels do not
    take."""
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
    refusal = shape_refusal(B)
    if refusal:
        raise ValueError(refusal)
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
    if Bn is not None and not 0 < Bn <= B:
        raise ValueError(f"the LN's width Bn must be in [1, B={B}], got {Bn}")
    for t in (w_up, w_down, *vecs):
        if t.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, one is on "
                             f"{t.device}")
    g_, b_, bu, bd = vecs
    w_up, bu, w_down = pad_hidden(w_up, bu, w_down)
    x, g_, b_, w_up, w_down, bd = pad_ffn(x, g_, b_, w_up, w_down, bd)
    for t in (x, w_up, w_down):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x, w_up, w_down")
    return x, g_, b_, w_up, bu, w_down, bd, B if Bn is None else Bn


def _launch_cuda(x, gamma, beta, w_up, b_up, w_down, b_down,
                 partial: bool = False, Bn: Optional[int] = None):
    """The CUDA branch of ``fused_ffn``: builds the kernels at first use,
    checks, allocates, launches on the current stream, and raises on
    anything the kernel does not take. ``Bn``: the LN's width where the
    operands come zero-padded already (a check of the padded routes; the
    output keeps its first Bn columns); None: x's width."""
    if needs_grad(x, gamma, beta, w_up, b_up, w_down, b_down):
        raise NotImplementedError(
            "fused_ffn launches the CUDA FFN kernel forward only: its output "
            "carries no gradient. Train through fused_ffn_ad, whose backward "
            "is the B12 kernel, or run inference under "
            "torch.inference_mode() or torch.no_grad()")
    lib = load_library()
    x, g, b, w_up, bu, w_down, bd, Bn = _prepare(
        "fused_ffn", x, gamma, beta, w_up, b_up, w_down, b_down, Bn)
    M, K, B = x.shape
    Fw = w_up.shape[1]
    n_ws = ctypes.c_longlong()   # y and h above B = 256; none below
    lib.ctn_dpt_ffn_workspace(M * K, B, Fw, ctypes.byref(n_ws))
    ws = torch.empty(n_ws.value, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), w_up.data_ptr(),
            bu.data_ptr(), w_down.data_ptr(), bd.data_ptr(), out.data_ptr(),
            ws.data_ptr(), M * K, B, Bn, Fw, int(partial), stream)
    raise_on_error(lib, err, "dpt ffn kernel")
    return out if B == Bn else out[..., :Bn].contiguous()


def _gelu_and_grad(v: torch.Tensor):
    """tanh-GELU and its derivative in f32 (``_gelu_and_grad`` of the
    Pallas backward)."""
    t = torch.tanh(_GELU_C * (v + _GELU_A * v * v * v))
    return (0.5 * v * (1.0 + t),
            0.5 * (1.0 + t)
            + 0.5 * v * (1.0 - t * t) * _GELU_C * (1.0 + 3 * _GELU_A * v * v))


def ffn_bwd_reference(x, g, gamma, beta, w_up, b_up, w_down, b_down,
                      partial: bool = False, Bn: Optional[int] = None):
    """The FFN sublayer's backward in plain PyTorch: the explicit math of
    the Pallas body ``_ffn_bwd_kernel`` with its rounding points. Products
    in f32 on values of x's dtype; pre = round(round(y W_up) +
    round(b_up)), h = round(gelu(pre)), dpre = round(dh gelu'(pre)) with
    the tanh-GELU and its derivative in f32; dh, dy and the LN backward in
    f32, dx = round(g + dx_ln). With ``partial`` (the backward of a shard's
    down projection alone) dx = round(dx_ln) and db_down is zero. ``Bn``:
    the LN's statistics and the means of its backward over the first Bn
    columns (``ffn_reference``). Returns ``(dx, dgamma, dbeta, dw_up,
    db_up, dw_down, db_down)`` in the primals' dtypes."""
    dt = x.dtype
    B = x.shape[-1]

    def rnd(t):
        return t.to(dt).float()

    xf = x.float().reshape(-1, B)
    mean, rs = ln_stats(xf, Bn)
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
    dx_ln = rs * (dxhat - row_mean(dxhat, Bn)
                  - xhat * row_mean(dxhat * xhat, Bn))
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
                     partial: bool = False, Bn: Optional[int] = None):
    """The CUDA branch of ``fused_ffn_bwd``: builds the kernels at first
    use, checks, allocates the workspace and the outputs, launches on the
    current stream, and raises on anything the kernel does not take.
    ``Bn`` as in ``_launch_cuda`` (the cotangents keep the first Bn columns
    and rows)."""
    lib = load_library()
    xc, g_, b_, w_up_c, bu, w_down_c, bd, Bn = _prepare(
        "fused_ffn_bwd", x, gamma, beta, w_up, b_up, w_down, b_down, Bn)
    M, K, B = xc.shape
    Fw = w_up_c.shape[1]
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"g must have x's shape {tuple(x.shape)}, got "
                         f"{tuple(g.shape)}")
    g = g.detach().to(xc.dtype)
    if B != g.shape[-1]:
        g = F.pad(g, (0, B - g.shape[-1]))
    g = g.contiguous()
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
            dw_down.data_ptr(), db_down.data_ptr(), M * K, B, Bn, Fw,
            int(partial), stream)
    raise_on_error(lib, err, "dpt ffn backward kernel")
    F_in = w_up.shape[-1]
    dx, dgamma, dbeta, dw_up_, db_up_, dw_down_, db_down = unpad_ffn_grads(
        (dx, dgb[0], dgb[1], dw_up[:, :F_in], db_up[:F_in],
         dw_down[:F_in], db_down), Bn)
    return (dx.contiguous(), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw_up_.to(w_up.dtype), db_up_.reshape(b_up.shape).to(b_up.dtype),
            dw_down_.to(w_down.dtype),
            db_down.reshape(*b_down.shape[:-1], -1).to(b_down.dtype))


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
