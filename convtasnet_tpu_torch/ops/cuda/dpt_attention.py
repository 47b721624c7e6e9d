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
sublayer's B10 shares its launcher, and in bf16 its design,
``csrc/dpt_attn_bwd_wg.cuh``: six launches around one tensor-core
attention core) is ``fused_inter_attention_bwd``, the
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

The kernels run B and Bq at multiples of their 64-column tile and each
head at a width D their cores take: 16, 32, 64 or 128 (``HEAD_DIMS``,
the cores' template), or above 128 a multiple of 64 on a route beside
the cores (``csrc/dpt_attn_wide_head.cuh``: the logits through a device
workspace, hand-written FMA products). Other widths are zero-padded by
the wrappers (``pad_attention``): each head of q, k and v from its real
width d to D = ``core_head_width(d)`` with zero columns (and W_out's rows
to match), the heads' width with whole zero heads of D up to the next
multiple of 64, B with zero columns up to the next multiple of 64 (and
at least the heads' padded width), and the kernels take the real d beside
their operands, so the softmax scale is 1 / sqrt(d); their LN takes the
sublayer's own width (their ``Bn``) apart from the padded one, so its
statistics span the real columns alone. Outputs and cotangents are sliced
back (``unpad_attention_grads``). The twins take the same ``Bn`` (an LN
over the first Bn columns) and ``d`` (the scale of heads padded from d),
so the padded plain path can be held against the unpadded one on the CPU.

Any B and any head width run: above 512 the kernels take routes beside
their resident tiles (chosen in ``csrc/`` by B alone; the f32 inter cores'
staging by Bq), above a head width of 128 the route beside the cores
(chosen by D alone), so the shape rule is the shard count alone.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from convtasnet_tpu_torch.ops.cuda.build import load_library
from convtasnet_tpu_torch.ops.cuda.tcn_block import padded
from convtasnet_tpu_torch.ops.norm import LN_EPS, layer_norm

NEG_INF = -1e9
TILE = 64            # the kernels run B and Bq at multiples of the GEMM
                     # tile; the wrappers zero-pad other widths up to one
# the head widths the attention cores are built for, in either compute
# dtype: the bf16 designs share one tensor-core core, templated on the
# width; the f32 first designs are templated on it too. A head of another
# width runs zero-padded to the next of them, or above 128 on the route
# beside the cores at a multiple of 64 (core_head_width)
HEAD_DIMS = (16, 32, 64, 128)
WIDE_HEAD_TILE = 64  # above 128 a head pads to a multiple of this
INTRA_ROWS = 16      # the intra kernels' row tile: S pads up to a multiple
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


def fitting_shards(B: int, n_heads: int) -> list:
    """The shard counts m whose partial attention kernels take a sublayer
    of width B with ``n_heads`` heads: m divides the heads (and so B). A
    shard's width B / m off 64 runs with zero heads (``pad_attention``)."""
    return [m for m in range(1, n_heads + 1)
            if n_heads % m == 0 and B % m == 0]


def core_head_width(d: int) -> int:
    """The width D >= d at which the kernels run a head of width d: the
    narrowest core width of ``HEAD_DIMS`` that holds it, or above 128 d
    rounded up to a multiple of ``WIDE_HEAD_TILE`` (the route beside the
    cores). The head's columns past d are zero; its scale stays 1 /
    sqrt(d)."""
    for D in HEAD_DIMS:
        if d <= D:
            return D
    return -(-d // WIDE_HEAD_TILE) * WIDE_HEAD_TILE


def shape_refusal(kind: str, B: int, S: int, Bq: int, n_heads: int,
                  dtype="float32") -> Optional[str]:
    """Why the attention kernels of ``kind`` ("inter": B7, B8; "intra": B9,
    B10; and their partial modes) refuse a sublayer of width B over chunks
    of S frames whose heads, ``n_heads`` of them, span Bq channels (Bq ==
    B, or B / m for a head-group shard of m), in the compute ``dtype`` (a
    torch dtype or its name), or None where they take it: Bq dividing B
    (m a whole shard count) into ``n_heads`` heads, the rule the JAX
    package's head-group split keeps too. Any head width runs (16, 32, 64
    and 128 on the cores, others zero-padded to the next of them, above
    128 on the route beside the cores); any B runs (up to 256 on tiles as
    wide as the row, up to 512 on one resident tile, above that on routes
    that stream the row); B and Bq off 64 run zero-padded
    (``pad_attention``). Any S runs (the f32 intra kernels above 256
    frames on their row-statistics core, ``csrc/dpt_intra_rowstat.cuh``).
    ``kind`` and ``dtype`` take no part in the rule since every head width
    runs in either."""
    if not 0 < Bq <= B or B % Bq:
        return (f"the partial kernel needs the shard's width B/m to divide "
                f"B, got {Bq} of B={B}")
    if n_heads <= 0 or Bq % n_heads:
        return (f"the kernels need the {n_heads} heads to split the "
                f"{Bq} channels evenly")
    return None


def ln_stats(xf: torch.Tensor, Bn: Optional[int] = None):
    """The pre-LN's f32 (mean, rs) of each row of ``xf`` over its first Bn
    columns (all of them where Bn is None): the kernels' statistics over
    the sublayer's own width, whatever columns were padded after it."""
    xr = xf if Bn is None else xf[..., :Bn]
    mean = xr.mean(-1, keepdim=True)
    return mean, torch.rsqrt((xr - mean).square().mean(-1, keepdim=True)
                             + LN_EPS)


def row_mean(t: torch.Tensor, Bn: Optional[int] = None) -> torch.Tensor:
    """Each row's mean over its first Bn columns (all where Bn is None)."""
    return (t if Bn is None else t[..., :Bn]).mean(-1, keepdim=True)


def pre_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           Bn: Optional[int] = None) -> torch.Tensor:
    """The pre-LN (``layer_norm``) with its statistics over the first Bn
    columns, applied to every column, in x's dtype."""
    if Bn is None or Bn == x.shape[-1]:
        return layer_norm(x, gamma, beta)
    xf = x.float()
    mean, rs = ln_stats(xf, Bn)
    return ((xf - mean) * rs * gamma.float() + beta.float()).to(x.dtype)


def pad_heads(w_qkv, w_out, n_heads: int, D: int):
    """w_qkv [B, 3Bq] and w_out [Bq, B] with each of the ``n_heads``
    heads of q, k and v (and its rows of W_out) widened from its width
    d = Bq / n_heads to D with zero columns (zero rows): [B, 3 n_heads D]
    and [n_heads D, B]. A zero column of q and of k adds nothing to a
    logit; a zero column of v gives a zero column of the head's output,
    which the zero rows of W_out drop."""
    B = w_qkv.shape[0]
    d = w_qkv.shape[-1] // (3 * n_heads)
    if D == d:
        return w_qkv, w_out
    qkv = F.pad(w_qkv.reshape(B, 3, n_heads, d), (0, D - d))
    out = F.pad(w_out.reshape(n_heads, d, -1), (0, 0, 0, D - d))
    return qkv.reshape(B, 3 * n_heads * D), out.reshape(n_heads * D, -1)


def unpad_heads(dw_qkv, dw_out, n_heads: int, d: int):
    """The inverse of ``pad_heads``: of dw_qkv [B, 3 n_heads D] and dw_out
    [n_heads D, B], the first d columns of each of the ``n_heads`` heads
    of q, k and v (the first d rows of each head of dW_out)."""
    B = dw_qkv.shape[0]
    D = dw_qkv.shape[-1] // (3 * n_heads)
    if D == d:
        return dw_qkv, dw_out
    qkv = dw_qkv.reshape(B, 3, n_heads, D)[..., :d]
    out = dw_out.reshape(n_heads, D, -1)[:, :d]
    return qkv.reshape(B, 3 * n_heads * d), out.reshape(n_heads * d, -1)


def pad_attention(x, gamma, beta, w_qkv, w_out, n_heads: int):
    """One attention sublayer's operands at the widths the kernels run it:
    each head of q, k and v (and W_out's rows) widened from its real width
    d = Bq / n_heads to D = ``core_head_width(d)`` with zero columns
    (``pad_heads``), the heads' width n_heads D then taken to Bqp =
    ``padded`` (a multiple of 64) with whole zero heads of D inside each
    of q, k and v; x [..., B], gamma and beta [B] with zero columns up to
    Bp = max(``padded(B)``, Bqp); w_qkv with zero rows up to Bp; w_out
    with zero rows up to Bqp and zero columns up to Bp. Returns those and
    the padded head count Bqp / D; the kernels take the real d beside them
    (its scale).

    Where d is a core's width (16, 32, 64 or 128) no head widens and the
    64 - Bq % 64 padded channels are whole heads, as before: d divides 64
    up to d = 64, and Bq is a multiple of 128 at d = 128. A padded column
    of x is zero, and with gamma and beta zero there so is y. A zero head's
    q, k and v are zero: it scores 0 against every key and averages v = 0,
    and its W_out rows are zero, so it adds nothing to the output, and
    its cotangents are zero. Every real output and cotangent is the
    unpadded sublayer's, given an LN whose statistics span the first B
    columns alone (the kernels' Bn, the twins' ``Bn``) and the real d's
    softmax scale (the kernels' d, the twins' ``d``)."""
    B = x.shape[-1]
    D = core_head_width(w_qkv.shape[-1] // (3 * n_heads))
    w_qkv, w_out = pad_heads(w_qkv, w_out, n_heads, D)
    Bq = n_heads * D
    Bqp = padded(Bq)
    db, dq = max(padded(B), Bqp) - B, Bqp - Bq
    if not (db or dq):
        return x, gamma, beta, w_qkv, w_out, n_heads
    qkv = torch.cat([F.pad(t, (0, dq, 0, db))
                     for t in w_qkv.split(Bq, dim=-1)], dim=-1)
    return (F.pad(x, (0, db)), F.pad(gamma, (0, db)), F.pad(beta, (0, db)),
            qkv, F.pad(w_out, (0, db, 0, dq)), n_heads + dq // D)


def unpad_attention_grads(grads, B: int, Bq: int, n_heads: int):
    """The backward's ``(dx, dgamma, dbeta, dw_qkv, dw_out)`` at the
    padded widths of ``pad_attention``, sliced back to the B real columns
    and rows and the Bq real channels of each of q, k and v: the first
    d = Bq / n_heads columns (rows of dW_out) of each of the ``n_heads``
    heads widened to ``core_head_width(d)`` (``unpad_heads``)."""
    dx, dgamma, dbeta, dw_qkv, dw_out = grads
    Bqp = dw_qkv.shape[-1] // 3
    if dx.shape[-1] == B and Bqp == Bq:
        return grads
    Bqw = n_heads * core_head_width(Bq // n_heads)
    qkv = torch.cat([t[:B, :Bqw] for t in dw_qkv.split(Bqp, dim=-1)], dim=-1)
    dw_qkv, dw_out = unpad_heads(qkv, dw_out[:Bqw, :B], n_heads,
                                 Bq // n_heads)
    return dx[..., :B], dgamma[:B], dbeta[:B], dw_qkv, dw_out


def pad_chunks(x: torch.Tensor, key_bias: Optional[torch.Tensor],
               Sp: int):
    """x [M, n, S, B] with zero frames appended to each chunk up to Sp, and
    the key bias [n, Sp] with the appended frames masked (``NEG_INF``):
    what the intra backwards and the f32 intra forward run where S is not
    a multiple of their row tile (the bf16 forward masks the keys of its
    last 16-row tile itself). An appended frame takes no weight as a key,
    so the real frames' outputs and every gradient are the unpadded
    sublayer's; its own output rows are dropped."""
    n, S = x.shape[1], x.shape[2]
    if key_bias is None:
        key_bias = torch.zeros((n, S), dtype=torch.float32, device=x.device)
    return (torch.nn.functional.pad(x, (0, 0, 0, Sp - S)),
            torch.nn.functional.pad(key_bias, (0, Sp - S), value=NEG_INF))


def attention_reference(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w_qkv: torch.Tensor,
                        w_out: torch.Tensor,
                        key_bias: Optional[torch.Tensor], *, n_heads: int,
                        attend_axis: int, partial: bool = False,
                        Bn: Optional[int] = None,
                        d: Optional[int] = None) -> torch.Tensor:
    """The pre-LN MHA sublayer + residual in plain PyTorch (the math of
    ``xla_inter_attention`` / ``xla_intra_attention``): products in x's
    dtype, LN statistics and the softmax in f32. ``attend_axis`` 2 mixes
    within each chunk (over S), 1 across chunks (over n). ``partial``:
    a head-group shard's projection alone (w_qkv [B, 3Bq], w_out [Bq, B]).
    ``Bn``: the LN's statistics over the first Bn columns alone (the
    operands of ``pad_attention``; None: all of them). ``d``: the heads'
    real width, whose 1 / sqrt(d) scales the logits, where each head comes
    widened with zero columns (``pad_attention``; None: Bq / n_heads)."""
    M, n, S, B = x.shape
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    D = Bq // h
    root = math.sqrt(d or D)
    y = pre_ln(x, gamma, beta, Bn)
    q, k, v = (t.reshape(M, n, S, h, D)
               for t in (y @ w_qkv.to(x.dtype)).split(Bq, dim=-1))
    if attend_axis == 2:
        logits = torch.einsum("mnqhd,mnkhd->mnhqk", q, k).float() / root
        if key_bias is not None:
            logits = logits + key_bias.float()[None, :, None, None, :]
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        a = torch.einsum("mnhqk,mnkhd->mnqhd", w, v)
    elif attend_axis == 1:
        logits = torch.einsum("mqshd,mkshd->mshqk", q, k).float() / root
        if key_bias is not None:
            logits = logits + key_bias.float().T[None, :, None, None, :]
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        a = torch.einsum("mshqk,mkshd->mqshd", w, v)
    else:
        raise ValueError(f"attend_axis must be 1 or 2, got {attend_axis}")
    proj = a.reshape(M, n, S, Bq) @ w_out.to(x.dtype)
    return proj if partial else x + proj


def inter_attention_reference(x, gamma, beta, w_qkv, w_out, key_bias, *,
                              n_heads: int, partial: bool = False,
                              Bn: Optional[int] = None,
                              d: Optional[int] = None) -> torch.Tensor:
    """The inter-chunk sublayer's plain twin (``xla_inter_attention``)."""
    return attention_reference(x, gamma, beta, w_qkv, w_out, key_bias,
                               n_heads=n_heads, attend_axis=1,
                               partial=partial, Bn=Bn, d=d)


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
             n_heads: int, partial: bool, Bn: Optional[int] = None,
             d: Optional[int] = None):
    """Checks the operands of either attention kernel (forward or backward)
    and returns them as the kernels take them: x and the weights contiguous
    in x's dtype, gamma, beta and the bias contiguous in f32, each head
    widened to a width the kernels run, and B and Bq zero-padded up to the
    tile (``pad_attention``); then the heads' padded width Bq, their padded
    count, the LN's width Bn (the real B, or the ``Bn`` given for operands
    that come zero-padded already) and the heads' real width d (Bq /
    n_heads of the operands given, or the ``d`` given for heads that come
    widened already). Raises on anything the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _ENTRY[kind]:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [M, n, S, B], got {tuple(x.shape)}")
    M, n, S, B = x.shape
    Bq = w_qkv.shape[-1] // 3
    if (tuple(w_qkv.shape) != (B, 3 * Bq) or tuple(w_out.shape) != (Bq, B)
            or not 0 < Bq <= B or (Bq != B and not partial)):
        raise ValueError(f"weight shapes {tuple(w_qkv.shape)}, "
                         f"{tuple(w_out.shape)} do not fit x {tuple(x.shape)}"
                         + ("" if partial else " (a head-group shard's "
                            "weights need partial=True)"))
    refusal = shape_refusal(kind, B, S, Bq, n_heads, x.dtype)
    if refusal:
        raise ValueError(refusal)
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
    if Bn is not None and not 0 < Bn <= B:
        raise ValueError(f"the LN's width Bn must be in [1, B={B}], got {Bn}")
    if d is not None and not 0 < d <= Bq // n_heads:
        raise ValueError(f"the heads' real width d must be in [1, "
                         f"{Bq // n_heads}], got {d}")
    d = Bq // n_heads if d is None else d
    x, gamma, beta, w_qkv, w_out, n_heads = pad_attention(
        x, gamma, beta, w_qkv, w_out, n_heads)
    for t in (x, w_qkv, w_out):
        if t.data_ptr() % 16:
            raise ValueError("the kernel needs 16-byte aligned x, w_qkv, w_out")
    return (x, gamma, beta, w_qkv, w_out, key_bias, w_qkv.shape[1] // 3,
            n_heads, B if Bn is None else Bn, d)


def wide_head_workspace(lib, kind: str, M: int, n: int, S: int, Bq: int,
                        n_heads: int, bwd: bool, device):
    """The f32 workspace the attention kernels of ``kind`` take beside
    their operands at the padded head width Bq / n_heads: the logits of the
    route above 128 (``ctn_dpt_attn_wide_workspace``), or None where the
    cores run."""
    n_floats = ctypes.c_longlong(0)
    raise_on_error(lib, lib.ctn_dpt_attn_wide_workspace(
        int(kind == "inter"), M, n, S, Bq, n_heads, int(bwd),
        ctypes.byref(n_floats)), "dpt attention wide-head workspace query")
    if not n_floats.value:
        return None
    return torch.empty(n_floats.value, dtype=torch.float32, device=device)


def raise_on_error(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ctn_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def launch_attention(kind: str, x, gamma, beta, w_qkv, w_out, key_bias, *,
                     n_heads: int, partial: bool = False,
                     Bn: Optional[int] = None,
                     d: Optional[int] = None) -> torch.Tensor:
    """The CUDA branch of both attention wrappers (``kind`` "inter" or
    "intra"): builds the kernels at first use, checks, allocates, launches
    on the current stream, and raises on anything the kernel does not
    take. ``Bn``: the LN's width where the operands come zero-padded
    already (a check of the padded routes against the narrow ones; the
    output keeps its first Bn columns); None: x's width, as the wrappers
    call it. ``d``: the heads' real width where each head comes widened
    with zero columns already (``pad_heads``; the kernels take its scale);
    None: Bq / n_heads, as the wrappers call it."""
    name = f"fused_{kind}_attention"
    if needs_grad(x, gamma, beta, w_qkv, w_out, key_bias):
        raise NotImplementedError(
            f"{name} launches the CUDA sublayer kernel forward only: its "
            f"output carries no gradient. Train through {name}_ad, whose "
            f"backward is the {_KERNEL_NO[kind]} kernel, or run inference "
            "under torch.inference_mode() or torch.no_grad()")
    lib = load_library()
    x, gamma, beta, w_qkv, w_out, key_bias, Bq, n_heads, Bn, d = _prepare(
        name, kind, x, gamma, beta, w_qkv, w_out, key_bias, n_heads, partial,
        Bn, d)
    S_in = x.shape[2]
    if kind == "intra" and S_in % INTRA_ROWS and x.dtype != torch.bfloat16:
        x, key_bias = pad_chunks(x, key_bias, -(-S_in // INTRA_ROWS)
                                 * INTRA_ROWS)
    M, n, S, B = x.shape
    R = M * n * S
    n_spill = ctypes.c_longlong(0)
    if kind == "intra":   # its q, k, v tiles, where shared memory cannot hold them
        raise_on_error(lib, lib.ctn_dpt_intra_workspace(
            M, n, S, Bq, n_heads, x.element_size(), ctypes.byref(n_spill)),
            "dpt intra workspace query")
        if n_spill.value < 0:
            raise ValueError(f"the intra kernel does not fit one block's "
                             f"shared memory at S={S} with head width "
                             f"{Bq // n_heads} in {x.dtype}")
    qkv = torch.empty((R, 3 * Bq), dtype=x.dtype, device=x.device)
    a = torch.empty(R * Bq + n_spill.value, dtype=x.dtype, device=x.device)
    wide = wide_head_workspace(lib, kind, M, n, S, Bq, n_heads, False,
                               x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[kind][x.dtype])(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w_qkv.data_ptr(),
            w_out.data_ptr(), None if key_bias is None else key_bias.data_ptr(),
            qkv.data_ptr(), a.data_ptr(), out.data_ptr(), M, n, S, B, Bn,
            n_heads, Bq, int(partial), d,
            None if wide is None else wide.data_ptr(), stream)
    raise_on_error(lib, err, f"dpt {kind} attention kernel")
    if (S, B) == (S_in, Bn):
        return out
    return out[:, :, :S_in, :Bn].contiguous()


def _rounded_attention(x, gamma, beta, w_qkv, key_bias, n_heads: int,
                       attend_axis: int, Bn: Optional[int] = None,
                       d: Optional[int] = None):
    """The forward pieces of the kernels' rounding points, in f32 on values
    of x's dtype: the LN's (xhat, rs) over the first Bn columns, y, the
    rounded W_qkv, q, k, v with the attended axis next to last, p (f32,
    the logits scaled by 1 / sqrt(d), d the heads' real width: Bq /
    n_heads where None) and the permutation back."""
    if attend_axis not in (1, 2):
        raise ValueError(f"attend_axis must be 1 or 2, got {attend_axis}")
    dt = x.dtype
    M, n, S, B = x.shape
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    D = Bq // h

    def rnd(t):
        return t.to(dt).float()

    xf = x.float()
    mean, rs = ln_stats(xf, Bn)
    xhat = (xf - mean) * rs
    y = rnd(xhat * gamma.float() + beta.float())
    wq = rnd(w_qkv.float())
    # heads out: [M, n, S, h, d] -> the attended axis next to last
    perm = (0, 1, 3, 2, 4) if attend_axis == 2 else (0, 2, 3, 1, 4)
    q, k, v = (t.reshape(M, n, S, h, D).permute(perm)
               for t in rnd(y @ wq).split(Bq, dim=-1))
    logits = q @ k.transpose(-1, -2) * (1.0 / math.sqrt(d or D))
    if key_bias is not None:
        kb = key_bias.float()
        logits = logits + (kb[None, :, None, None, :] if attend_axis == 2
                           else kb.T[None, :, None, None, :])
    p = torch.softmax(logits, dim=-1)
    inv = (0, 1, 3, 2, 4) if attend_axis == 2 else (0, 3, 1, 2, 4)
    return xhat, rs, y, wq, q, k, v, p, inv


def attention_rounded_reference(x, gamma, beta, w_qkv, w_out, key_bias, *,
                                n_heads: int, attend_axis: int,
                                partial: bool = False,
                                Bn: Optional[int] = None,
                                d: Optional[int] = None) -> torch.Tensor:
    """The sublayer forward in plain PyTorch with the rounding points of
    the Pallas bodies and of the bf16 forward kernels' Hopper design: every
    product in f32 on values of x's dtype, rounded once (qkv, round(p)
    before the mix, a, the out product); the scores and the softmax in f32.
    The bf16 twin (``attention_reference``) also rounds the scores. Returns
    x + round(a @ W_out), or with ``partial`` round(a @ W_out), in x's
    dtype; ``Bn`` and ``d`` as in ``attention_reference``."""
    dt = x.dtype
    M, n, S, B = x.shape
    *_, v, p, inv = _rounded_attention(x, gamma, beta, w_qkv, key_bias,
                                       n_heads, attend_axis, Bn, d)
    a = (p.to(dt).float() @ v).to(dt).float()
    a = a.permute(inv).reshape(M, n, S, -1)
    proj = (a @ w_out.to(dt).float()).to(dt)
    return proj if partial else (x.float() + proj.float()).to(dt)


def attention_bwd_reference(x, g, gamma, beta, w_qkv, w_out, key_bias, *,
                            n_heads: int, attend_axis: int,
                            partial: bool = False, Bn: Optional[int] = None,
                            d: Optional[int] = None):
    """The attention sublayer's backward in plain PyTorch: the explicit math
    of the Pallas bodies (``_inter_bwd_kernel``, ``_intra_bwd_kernel``) with
    their rounding points. Every product is taken in f32 on values of x's
    dtype and rounded once where the kernels round: qkv, round(p) before
    the mix and before dv, a, dA, ds = round(p (dp - rowsum) scale), dq,
    dk, dv; scores, p, dp, dy and the LN backward stay in f32, and
    dx = round(g + dx_ln), or with ``partial`` (the backward of a
    head-group shard's projection) round(dx_ln). ``Bn``: the LN's
    statistics and the means of its backward over the first Bn columns
    (``attention_reference``), ``d`` the heads' real width (the scale's;
    ``attention_reference``). Returns ``(dx, dgamma, dbeta, dw_qkv,
    dw_out)`` in the primals' dtypes."""
    dt = x.dtype
    M, n, S, B = x.shape
    h = n_heads
    Bq = w_qkv.shape[1] // 3
    D = Bq // h
    scale = 1.0 / math.sqrt(d or D)

    def rnd(t):
        return t.to(dt).float()

    xhat, rs, y, wq, q, k, v, p, inv = _rounded_attention(
        x, gamma, beta, w_qkv, key_bias, n_heads, attend_axis, Bn, d)
    wo = rnd(w_out.float())
    gf = g.float()
    perm = (0, 1, 3, 2, 4) if attend_axis == 2 else (0, 2, 3, 1, 4)
    dA = rnd(gf @ wo.T).reshape(M, n, S, h, D).permute(perm)
    pc = rnd(p)
    a = rnd(pc @ v)
    dp = dA @ v.transpose(-1, -2)
    dv = rnd(pc.transpose(-1, -2) @ dA)
    ds = rnd(p * (dp - (p * dp).sum(-1, keepdim=True)) * scale)
    dq, dk = rnd(ds @ k), rnd(ds.transpose(-1, -2) @ q)
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
    dx_ln = rs * (dxhat - row_mean(dxhat, Bn)
                  - xhat * row_mean(dxhat * xhat, Bn))
    return ((dx_ln if partial else gf + dx_ln).to(dt), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype), dw_qkv.to(w_qkv.dtype),
            dw_out.to(w_out.dtype))


def inter_attention_bwd_reference(x, g, gamma, beta, w_qkv, w_out, key_bias,
                                  *, n_heads: int, partial: bool = False,
                                  Bn: Optional[int] = None,
                                  d: Optional[int] = None):
    """The inter-chunk sublayer backward's plain twin."""
    return attention_bwd_reference(x, g, gamma, beta, w_qkv, w_out,
                                   key_bias, n_heads=n_heads, attend_axis=1,
                                   partial=partial, Bn=Bn, d=d)


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
                         key_bias, *, n_heads: int, partial: bool = False,
                         Bn: Optional[int] = None, d: Optional[int] = None):
    """The CUDA branch of both attention backward wrappers: builds the
    kernels at first use, checks, allocates the workspace and the outputs,
    launches on the current stream, and raises on anything the kernel does
    not take. ``Bn`` and ``d`` as in ``launch_attention`` (the cotangents
    keep the first Bn columns and rows, and the widths the heads come
    in)."""
    name = f"fused_{kind}_attention_bwd"
    lib = load_library()
    heads_in, Bq_in = n_heads, w_qkv.shape[-1] // 3
    prims = _prepare(name, kind, x, gamma, beta, w_qkv, w_out, key_bias,
                     n_heads, partial, Bn, d)
    xc, gamma_c, beta_c, w_qkv_c, w_out_c, bias_c, Bq, n_heads, Bn, d = prims
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"g must have x's shape {tuple(x.shape)}, got "
                         f"{tuple(g.shape)}")
    g = g.detach().to(xc.dtype)
    if xc.shape[-1] != g.shape[-1]:
        g = F.pad(g, (0, xc.shape[-1] - g.shape[-1]))
    g = g.contiguous()
    if g.device != xc.device or g.data_ptr() % 16:
        raise ValueError(f"g must be a 16-byte aligned tensor on {xc.device}")
    S_in = xc.shape[2]
    if kind == "intra" and S_in % INTRA_ROWS:
        Sp = -(-S_in // INTRA_ROWS) * INTRA_ROWS
        xc, bias_c = pad_chunks(xc, bias_c, Sp)
        g = torch.nn.functional.pad(g, (0, 0, 0, Sp - S_in))
    M, n, S, B = xc.shape
    n_act, n_f32 = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ctn_dpt_attn_bwd_workspace(M, n, S, B, n_heads, Bq,
                                   xc.element_size(), ctypes.byref(n_act),
                                   ctypes.byref(n_f32))
    n_spill = ctypes.c_longlong(0)
    if kind == "intra":   # f32: its tiles, where shared memory cannot hold
        # them; the bf16 design keeps no [S, S] tile (0)
        raise_on_error(lib, lib.ctn_dpt_intra_bwd_spill(
            M, n, S, Bq, n_heads, xc.element_size(), ctypes.byref(n_spill)),
            "dpt intra backward workspace query")
        if n_spill.value < 0:
            raise ValueError(f"the intra backward kernel does not fit one "
                             f"block's shared memory at S={S} with head "
                             f"width {Bq // n_heads} in {xc.dtype}")
    f32 = dict(dtype=torch.float32, device=xc.device)
    ws_act = torch.empty(n_act.value + n_spill.value, dtype=xc.dtype,
                         device=xc.device)
    ws_f32 = torch.empty(n_f32.value, **f32)
    wide = wide_head_workspace(lib, kind, M, n, S, Bq, n_heads, True,
                               xc.device)
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
            dw_qkv.data_ptr(), dw_out.data_ptr(), M, n, S, B, Bn, n_heads,
            Bq, int(partial), d, None if wide is None else wide.data_ptr(),
            stream)
    raise_on_error(lib, err, f"dpt {kind} attention backward kernel")
    dx, dgamma, dbeta, dw_qkv, dw_out = unpad_attention_grads(
        (dx[:, :, :S_in], dgb[0], dgb[1], dw_qkv, dw_out), Bn, Bq_in,
        heads_in)
    return (dx.contiguous(), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
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
