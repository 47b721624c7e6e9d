"""Two consecutive gLN TCN blocks backward: the hand-written CUDA kernel
(B5) and its twin.

Counterpart of ``convtasnet_tpu/ops/pallas/tcn_block_pair_bwd.py`` (the
Pallas ``_pair_bwd_kernel`` behind ``fused_tcn_block_pair_bwd``). The kernel
is ``csrc/tcn_block_pair_bwd.cu``; its design note is there.

``fused_tcn_block_pair_bwd`` takes the JAX wrapper's arguments in the same
order and returns ``(dx, grads_a, grads_b)``, each ``grads_*`` the 9-tuple
``(dW_in, d_dw, dW_out, da1, da2, dgamma1, dbeta1, dgamma2, dbeta2)`` in the
primals' dtypes. On CPU tensors it runs the plain twin
``fused_tcn_block_pair_bwd_reference`` (autograd through the forward twin);
on CUDA tensors it launches the kernel or raises, with no fallback.
``fused_tcn_block_pair_bwd.launches`` counts the calls that launched it.
gLN only, as JAX's: a cLN pair trains as two single blocks.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.cuda.tcn_block_pair import (
    fused_tcn_block_pair_reference,
    prepare_pair,
)

_ENTRY = {torch.float32: "ctn_tcn_block_pair_bwd_f32",
          torch.bfloat16: "ctn_tcn_block_pair_bwd_bf16"}
Grads = Tuple[torch.Tensor, ...]


def fused_tcn_block_pair_bwd_reference(
    x: torch.Tensor, g: torch.Tensor, params_a: Sequence[torch.Tensor],
    params_b: Sequence[torch.Tensor], *, d1: int, d2: int, causal: bool,
    norm_type: str = "gLN",
) -> Tuple[torch.Tensor, Grads, Grads]:
    """All 19 cotangents by autograd through
    ``fused_tcn_block_pair_reference``."""
    prims = [t.detach().requires_grad_(True)
             for t in (x, *params_a, *params_b)]
    with torch.enable_grad():
        out = fused_tcn_block_pair_reference(
            prims[0], prims[1:10], prims[10:], d1=d1, d2=d2, causal=causal,
            norm_type=norm_type)
        grads = torch.autograd.grad(out, prims, grad_outputs=g.to(out.dtype))
    return grads[0], tuple(grads[1:10]), tuple(grads[10:])


def fused_tcn_block_pair_bwd(
    x: torch.Tensor,                      # [M, K, B] pair input
    g: torch.Tensor,                      # [M, K, B] cotangent of its output
    params_a: Sequence[torch.Tensor],     # (w_in, dw, w_out, a1, a2,
    params_b: Sequence[torch.Tensor],     #  g1, b1, g2, b2) per block
    *,
    d1: int,
    d2: int,
    causal: bool,
    norm_type: str = "gLN",
) -> Tuple[torch.Tensor, Grads, Grads]:
    """Backward of a gLN block pair -> ``(dx, grads_a, grads_b)``."""
    if norm_type != "gLN":
        raise ValueError(f"the fused pair backward takes gLN only, got "
                         f"{norm_type}")
    kw = dict(d1=d1, d2=d2, causal=causal)
    if x.device.type == "cpu":
        return fused_tcn_block_pair_bwd_reference(x, g, params_a, params_b,
                                                  **kw)
    return _launch_cuda(x, g, params_a, params_b, **kw)


fused_tcn_block_pair_bwd.launches = 0


def _launch_cuda(x, g, params_a, params_b, *, d1, d2, causal):
    """The CUDA branch of ``fused_tcn_block_pair_bwd``: builds the kernel at
    first use, checks, allocates, launches on the current stream, and
    raises on anything the kernel does not take."""
    lib = load_library()
    xc, prepared = prepare_pair("fused_tcn_block_pair_bwd", x, params_a,
                                params_b, causal)
    if tuple(g.shape) != tuple(xc.shape):
        raise ValueError(f"x and g must both be [M, K, B], got "
                         f"{tuple(xc.shape)} and {tuple(g.shape)}")
    g = g.detach().to(xc.dtype).contiguous()
    if g.device != xc.device or g.data_ptr() % 16:
        raise ValueError(f"g must be a 16-byte aligned tensor on {xc.device}")
    M, K, B = xc.shape
    P, H = prepared[1].shape
    n_act, n_f32 = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ctn_tcn_block_pair_bwd_workspace(M, K, B, H, P, xc.element_size(),
                                         ctypes.byref(n_act),
                                         ctypes.byref(n_f32))
    f32 = dict(dtype=torch.float32, device=xc.device)
    ws_act = torch.empty(n_act.value, dtype=xc.dtype, device=xc.device)
    ws_f32 = torch.empty(n_f32.value, **f32)
    dx = torch.empty_like(xc)
    outs = []
    for _ in range(2):
        outs += [torch.empty((B, H), **f32), torch.empty((H, B), **f32),
                 torch.empty((P + 6) * H + 2, **f32)]
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = getattr(lib, _ENTRY[xc.dtype])(
            xc.data_ptr(), g.data_ptr(), *[t.data_ptr() for t in prepared],
            ws_act.data_ptr(), ws_f32.data_ptr(), dx.data_ptr(),
            *[t.data_ptr() for t in outs], M, K, B, H, P, d1, d2,
            int(causal), stream)
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"tcn_block_pair_bwd kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    fused_tcn_block_pair_bwd.launches += 1
    return (dx, _unpack(outs[:3], params_a, P, H),
            _unpack(outs[3:], params_b, P, H))


def _unpack(out, params, P: int, H: int) -> Grads:
    """One block's (dw_in, dw_out, aux) as JAX's 9-tuple in the primals'
    dtypes; aux as B2's: d_dw [P, H], dg1, db1, dg2, db2, the per-channel
    slope parts, then da1 and da2."""
    dwin, dwout, aux = out
    w_in, dw, w_out, a1, a2, g1, b1, g2, b2 = params
    rows = aux[: (P + 6) * H].view(P + 6, H)
    da1, da2 = aux[(P + 6) * H:]
    return (dwin.to(w_in.dtype), rows[:P].to(dw.dtype),
            dwout.to(w_out.dtype),
            da1.reshape(a1.shape).to(a1.dtype),
            da2.reshape(a2.shape).to(a2.dtype),
            rows[P].to(g1.dtype), rows[P + 1].to(b1.dtype),
            rows[P + 2].to(g2.dtype), rows[P + 3].to(b2.dtype))
