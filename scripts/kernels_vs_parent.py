#!/usr/bin/env python3
"""The port's kernels in this tree against those of another checkout, on
one NVIDIA GPU.

    python3 scripts/kernels_vs_parent.py --other DIR \\
        [--time [all|dpt-forward|f32|f32-attention|padded|taps|tp]] \\
        [--out FILE]

DIR holds another checkout's ``convtasnet_tpu_torch/`` (for example the
parent commit, unpacked with ``git archive HEAD convtasnet_tpu_torch``).
Each tree's package runs in a subprocess of its own, builds its kernels
from its own sources and writes its outputs at shapes both trees take:
the DPT sublayer kernels in full mode (B7-B12) and in partial mode over
m = 2 and 4 shards (B7p-B12p) at the quality default's widths ([8, 25,
128, 256], 8 heads, F=1024, the real key mask), forwards and backwards in
bf16 and f32, the f32 attention kernels also at 4 heads (head width 64),
the intra kernels also at other chunk lengths, and every DPT kernel also
at B = 128 and 192 (B / 32 heads, F = 4B, full and on the last shard of
2 and 3: the widths below 256 whose out and DN tiles are 128 wide, or 256
wide with the columns past B zero) and at B = 320 and 512 (their wide
routes; on the last shard of 5 and 2); the TCN TP
stage 2 (B6) at [8, 3199, Hs], Hs = 256, 128, 512 and 448 (each route a
shard up to 512 wide takes); the TCN block forward (B1, gLN and cLN
causal), the gLN block backward (B2) and the cLN one (B3) at the paper
shape [8, 3199, 256], H=512, d = 1, 16, 128 (and at P =
5 and 16 taps, d = 1 and 128, with B5 at (d, 2 d): every P <= 16 runs the
first routes, which the routes past 16 taps leave as they were); the block
pair forward (B4, gLN and cLN causal) and the gLN pair backward (B5),
(d1, d2) = (1, 2), (16, 32), (64, 128); bf16 and f32.

- by distance: the bf16 forward of B7 (and of B7p), whose Hopper design
  sums in another order than the first design: each tree's distance from
  the forward at the kernel's rounding points (``twin``, held within
  1e-3, B6's order bar ``chip_smoke.TP_ORDER_TOL``; the attention's is
  ``attention_rounded_reference``, and a tree older than it holds only
  its bf16 twin) and from its bf16 twin (``bf16 twin``, within 4e-2),
  and the relative L2 between the two trees; and every f32 output of B1,
  B2, B3, B4 and B5 here (all at the paper widths, which the f32 3xTF32
  stages take) and of B6 (its one f32 route on the same core at every
  shard width: ``F32_BY_DISTANCE``), each within its twin's bar (2e-3
  forward, 3e-3 pair forward, 4e-3 backward; B6 1e-5 of the twin at its
  own rounding points, ``chip_smoke.TP_ORDER_TOL``);
- bit for bit (``torch.equal``): every other output. A change to the
  kernels' shared pieces must leave these bits as they were. Where a
  tree carries a twin distance for one of them (the B1-B6 and backward
  twins), both trees' distances are printed beside it.

A last line counts the outputs, those held by distance too, that are the
other tree's bits ("n of n outputs in all the same bits").

``--time`` then times both trees in turns (other, this, this, other; one
subprocess each, on the same card), in bf16: first the DPT forwards B7,
B9 and B11 (and their partial modes on one shard of m = 2 and 4) at
[8, 25, 128, 256] with the real key mask (B11 at [8, 3200, 256],
F=1024), with ``scaled_dot_product_attention``'s forward at B7's and B9's
cores' shapes beside them (a yardstick; no kernel calls it), and the DPT
quality default's forward at B=8 x 4 s; ``--time dpt-forward`` stops
there, with ``torch.matmul`` at the forwards' products' shapes.
``--time f32-attention`` times only B7-B10 in f32 (their first designs)
at [8, 25, 128, 256] with the real key mask at head widths 16, 32, 64 and
128, forward and backward, each width a tree takes (a width only one tree
takes is printed for that tree alone); then B9 and B10 in f32 at d = 32
at [8, 13, 256, 256] (the first design) and above 256 frames, on the
row-statistics core, at [8, 10, 320, 256] and [8, 7, 512, 256], each with
its bound (FMA products at 67 TFLOP/s, the larger of that and its bytes at
3.35 TB/s) and ``scaled_dot_product_attention`` in f32 at its core's
shapes ([8 n, 8, S, 32], no mask; forward, and forward + backward) as the
library time. ``--time padded`` times only B7-B12 in bf16 and f32 at
[8, 25, 128, 96] (3 heads of 32, F = 384: B and the heads run padded to
128 with each LN over the real 96 columns) beside [8, 25, 128, 128] (4
heads, F = 512), and B7p-B12p on one shard of two at B = 192 (96
channels, 3 heads, padded to 128) beside B = 256 (128 channels), forward
and backward, with each one's device time per call and per kernel (a
width a tree refuses is printed for the other alone), and by CUDA events
what the padding copies add per call (the operands padded as the
wrappers pad them, the output, or the cotangents, sliced back).
``--time taps`` times only B1 (gLN, cLN causal, BN), B2, B3, B4, B5 and
B6 (Hs = 256) in bf16 and f32 at the paper shape at P = 3, 17 and 33 taps
and d = 1 and 128, by CUDA events and in device time, each beside its
bound (its FLOP at the dtype's peak, 989 TFLOP/s bf16 or 67 TFLOP/s f32,
or its bytes at 3.35 TB/s where that is larger); a tree that refuses P >
16 is timed at P = 3 alone.
``--time f32`` times only B1 (gLN, cLN causal, BN), B2, B3 (cLN causal),
B4 and B5 in f32 at the paper shape, d = 1 (their 3xTF32 stages; the
first design's in an older tree), each beside its bound at the 3xTF32
rate (495 / 3 TFLOP/s) and at the f32 FMA rate (67 TFLOP/s), the larger
of that and its bytes at 3.35 TB/s, by CUDA events and in device time
with each kernel's share; the paper config's f32 forward and its gLN and
causal cLN train steps at B=8 x 4 s (pairs off), events and device time;
the 3xTF32 core alone at B1's product shapes; and torch.matmul at the
kernels' product shapes and B6's at Hs = 256, in f32 with TF32 off and on
and in bf16, in device time.
``--time tp`` times only B6 at [8, 3199, Hs], B = 256, in bf16 and f32:
Hs = 256 and 128 at d = 1, 16 and 128, and at Hs = 576, 768 and 1024 (bf16
on its wide route), d = 1 (a tree that refuses a shard wider than 512 is
timed at 256 and 128 alone), by CUDA events and in device time per call
and per launch, each width beside its bound (``bound b6``: bf16 at 989
TFLOP/s, f32 at the 3xTF32 rate, or its bytes where that is larger), with
``torch.matmul``'s device time at each product's shape ([8 x 3199, Hs] @
[Hs, 256]; f32 with TF32 off and on), and the f32 paper config's
``tp_forward`` over two shards at B=8 x 4 s (64 B6 launches), by CUDA
events and in device time with each kernel's share.
``--time``
(all) goes on, at the paper shape unless named: B1 (gLN and cLN causal),
B2 and B3 per dilation 1..128; B4 (gLN and cLN causal) and B5 per pair
of dilations (1, 2) .. (64, 128), and beside each in the same turn two
chained B1 calls and B1 + 2 x B2; the gLN B4 and B5 beside the same also
in f32 ("f32": the 3xTF32 stages; an older tree's first design) and in
bf16 at H=192 ("H=192", the first design's launches); B6 at [8, 3199, Hs], Hs = 256 and 128, per dilation;
B12 at [8, 3200, 256], F=1024, and B12p on one shard of m = 2 and 4; B8
and B10 at [8, 25, 128, 256], 8 heads, the real key mask, B8p and B10p on
one shard of m = 2 and 4, B10 also at S = 256 (n = 13) and B8 at n = 94
(15 s), each with ``scaled_dot_product_attention`` forward and backward
at its core's shapes beside it; the paper-config forward and gLN train
step at B=8 and B=24 x 4 s with pairs on and off, with the peak device
memory of each, and the cLN causal step at B=8; the paper config's
forward over two shards (``tp_forward``), and the DPT quality default's
train step unsharded and over two shards, at B=8 x 4 s; and
``torch.matmul`` at each of the kernels' products' shapes (a yardstick of
the product core alone; no kernel calls it). ``--out`` writes every
number as JSON. Every timed kernel also reads its device time per call
from ``torch.profiler`` ("device ...") with each kernel's share. Exits
nonzero if a bit-for-bit output differs or an output held by distance is
further from a twin than its bar.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (kind, dtype, S, heads at B = 256, run the forward, run the backward):
# every sublayer at the quality default (head width 32), the f32 attention
# kernels also at head width 64 (4 heads), and the intra kernels at shapes
# whose tiles fitted in shared memory before the workspace spill of the
# [S, d] tiles, or spilled only the backward's [S, S] tiles, and the f32
# ones at S = 256 (the longest chunk of their first designs)
CASES = [(kind, dtype, 128, 8, True, True)
         for kind in ("inter", "intra", "ffn")
         for dtype in ("bfloat16", "float32")]
CASES += [(kind, "float32", 128, 4, True, True)
          for kind in ("inter", "intra")]
CASES += [("intra", "bfloat16", 256, 4, True, True),
          ("intra", "float32", 176, 4, True, True),
          ("intra", "float32", 208, 4, False, True),
          ("intra", "float32", 256, 8, True, True)]
# the DPT kernels at the other widths both trees take, B / 32 heads:
# B = 128 (out's and DN's tiles 128 wide) and 192 (out's and DN's 256-wide
# tiles with the columns past B zero), and 320 and 512 (the wide routes),
# forward and backward, full and on the last shard of m (m = 2 at 128; 3
# at 192 and 5 at 320, a 64-channel shard; 2 at 512)
WIDTH_CASES = [(kind, dtype, B, m)
               for kind in ("inter", "intra", "ffn")
               for dtype in ("bfloat16", "float32")
               for B, m in ((128, 2), (192, 3), (320, 5), (512, 2))]
# B6 at every route a shard width up to 512 takes: Hs = 256, 128 and 512
# (bf16 on the wgmma stage, f32's depthwise stage on dw_rows_f32) and 448
# (bf16 on the first design, f32's depthwise stage one channel a thread)
B6_CASES = [(dtype, hs, d) for dtype in ("bfloat16", "float32")
            for hs in (256, 128, 512, 448) for d in (1, 128)]
# B5's four PReLU slope gradients among its 19 outputs (dx, then each
# block's dW_in, d_dw, dW_out, da1, da2, ...): sums of millions of cancelling
# terms, one f32 evaluation ~1e-2 from another's on one slope alone, so an
# output held by distance holds them as one vector (chip_smoke.py's
# phase_pair_bwd_vs_twin does the same)
B5_SLOPES = (4, 5, 13, 14)
# --time tp: (Hs, dilations); the widths past 512 run bf16 B6's wide route
# (f32's one route at every width), and a tree that refuses them is timed
# at the others alone
B6_TIMED = ((256, (1, 16, 128)), (128, (1, 16, 128)), (576, (1,)),
            (768, (1,)), (1024, (1,)))
# the partial modes: one shard of m of the quality default's widths
PARTIAL_SHARDS = (2, 4)
# (kernel, norm, causal): B1 gLN and cLN causal, B2 gLN, B3 cLN causal
TCN_KERNELS = [("b1", "gLN", False), ("b1", "cLN", True),
               ("b2", "gLN", False), ("b3", "cLN", True)]
TCN_CASES = [(kern, norm, causal, dtype, d)
             for kern, norm, causal in TCN_KERNELS
             for dtype in ("bfloat16", "float32") for d in (1, 16, 128)]
# the same at P = 5 and 16 taps (every P <= 16 runs the first routes, in
# both trees; an even P only causal), and B5 at (16, 32): (kernel, norm,
# causal, dtype, d, P)
TCN_TAPS_CASES = [(kern, norm, causal or P % 2 == 0, dtype, d, P)
                  for P in (5, 16)
                  for kern, norm, causal in TCN_KERNELS + [("b5", "gLN",
                                                            False)]
                  for dtype in ("bfloat16", "float32") for d in (1, 128)]
# (kernel, norm, causal): B4 gLN and cLN causal, B5 gLN
PAIR_KERNELS = [("b4", "gLN", False), ("b4", "cLN", True),
                ("b5", "gLN", False)]
PAIR_CASES = [(kern, norm, causal, dtype, d1)
              for kern, norm, causal in PAIR_KERNELS
              for dtype in ("bfloat16", "float32") for d1 in (1, 16, 64)]
# the twin bars: the forward's and the backward's (the JAX probe and train
# gates), the pair forward at 1.5x the block's (the JAX pair gate); B6 at
# its own rounding points (chip_smoke.TP_ORDER_TOL), B12 in bf16
# against its bf16 twin (chip_smoke.DPT_TOL)
TCN_TOL = {("b1", "bfloat16"): 4e-2, ("b1", "float32"): 2e-3,
           ("b4", "bfloat16"): 6e-2, ("b4", "float32"): 3e-3,
           ("bwd", "bfloat16"): 8e-2, ("bwd", "float32"): 4e-3,
           ("b6", "bfloat16"): 1e-3, ("b6", "float32"): 1e-5,
           ("dpt", "bfloat16"): 4e-2,
           ("dpt forward", "bfloat16"): 1e-3}
# outputs held by distance against the other tree (every other output bit
# for bit): the bf16 forward of B7 and of its partial mode, whose Hopper
# design sums in another order than the first design; each within 1e-3 of
# the forward at its rounding points ("twin", B6's order bar) and within
# 4e-2 of its bf16 twin ("bf16 twin")
FWD_BY_DISTANCE = ("dpt inter bfloat16 ",)
# and every f32 output of B1, B2, B3, B4 and B5 at the widths the f32
# 3xTF32 stages take (csrc/tcn_block_tf32.cuh, tcn_block_bwd_tf32.cuh;
# every TCN case here is at the paper widths B = 256, H = 512), and of B6
# at every shard width (its one f32 route on the same core,
# csrc/tcn_block_tp.cu): their products sum in another order than the
# first design's FMA tile, each within its twin's bar (TCN_TOL; B6 at its
# own rounding points, 1e-5).
F32_BY_DISTANCE = ("b1 float32 ", "b2 float32 ", "b3 float32 ",
                   "b4 float32 ", "b5 float32 ", "b6 float32 ")
TWINS = ("twin ", "bf16 twin ")
# distances from the f64 block (f32 B2 at the paper shape, d = 1), printed
# beside the other tree's and held by nothing
F64 = "f64 "
GRAD_NAMES = ("dx", "dW_in", "d_dw", "dW_out", "da1", "da2", "dg1", "db1",
              "dg2", "db2")


def bitwise(key: str) -> bool:
    """Whether an output is held bit for bit against the other tree."""
    if key.startswith(F32_BY_DISTANCE):
        return False
    return not (key.startswith(FWD_BY_DISTANCE) and key.endswith(" forward"))


def _shard(args, kind: str, m: int, s: int):
    """Shard s of m of a full sublayer's operands, as
    ``parallel/dpt_tp.dpt_tp_variables`` cuts the weights."""
    import torch

    if kind == "ffn":
        x, g_, b_, w_up, b_up, w_down, b_down = args
        fq = w_up.shape[1] // m
        cut = slice(s * fq, (s + 1) * fq)
        return (x, g_, b_, w_up[:, cut].contiguous(), b_up[cut].contiguous(),
                w_down[cut].contiguous(), b_down)
    x, g_, b_, w_qkv, w_out, bias = args
    bq = x.shape[-1] // m
    cut = slice(s * bq, (s + 1) * bq)
    q, k, v = w_qkv.split(x.shape[-1], dim=1)
    return (x, g_, b_, torch.cat([q[:, cut], k[:, cut], v[:, cut]], dim=1),
            w_out[cut].contiguous(), bias)
DILATIONS = [2 ** i for i in range(8)]
PAIRS = [(2 ** i, 2 ** (i + 1)) for i in range(0, 8, 2)]
M, K, B, H, P = 8, 3199, 256, 512, 3
# the blocks' products as (rows, depth, columns) of a row-major [rows,
# depth] @ [depth, columns]: B1's two, then B2's three others (g W_out^T
# has B1's first shape, dh_pre W_in^T its second) and the weight
# gradients hn2^T g and x^T dh_pre
PRODUCTS = {"x @ W_in, g @ W_out^T": (M * K, B, H),
            "y @ W_eff, dh_pre @ W_in^T": (M * K, H, B),
            "hn2^T @ g": (H, M * K, B),
            "x^T @ dh_pre": (B, M * K, H)}
# B6's product round(y g2) @ W_out_s over two and four shards of H, and
# B12's five at [8, 3200, 256], F = 1024 / m for one shard of m: y @ W_up
# and g @ W_down^T, dpre @ W_up^T, h^T @ g, y^T @ dpre
R_DPT, F_DPT = 8 * 3200, 1024
PRODUCTS.update({f"b6 (y g2) @ W_out Hs={hs}": (M * K, hs, B)
                 for hs in (256, 128)})
# the attention forwards' two products (B7, B9: y @ W_qkv, a @ W_out) and
# B8's and B10's 11 projection products at [8, 25, 128, 256], Bq = 256 / m
# for one shard of m: y @ W_qkv (recomputed), g @ W_out^T, y^T @ dqkv,
# a^T @ g and dqkv @ W_qkv^T; B11's two are B12's first two shapes
R_ATTN = 8 * 25 * 128
for _m in (1, 2, 4):
    _f, _t = F_DPT // _m, "" if _m == 1 else f" m={_m}"
    PRODUCTS.update({f"b11/b12 y @ W_up, g @ W_down^T{_t}": (R_DPT, B, _f),
                     f"b11/b12 h @ W_down, dpre @ W_up^T{_t}": (R_DPT, _f, B),
                     f"b12 h^T @ g{_t}": (_f, R_DPT, B),
                     f"b12 y^T @ dpre{_t}": (B, R_DPT, _f)})
    _q = B // _m
    PRODUCTS.update({f"b7/b9 a @ W_out{_t}": (R_ATTN, _q, B),
                     f"b7-b10 y @ W_qkv{_t}": (R_ATTN, B, 3 * _q),
                     f"b8/b10 g @ W_out^T{_t}": (R_ATTN, B, _q),
                     f"b8/b10 y^T @ dqkv{_t}": (B, R_ATTN, 3 * _q),
                     f"b8/b10 a^T @ g{_t}": (_q, R_ATTN, B),
                     f"b8/b10 dqkv @ W_qkv^T{_t}": (R_ATTN, 3 * _q, B)})
# the forwards timed: (kernel, kind, shards m; 1 = full), at [8, 25, 128,
# 256] (the FFN at [8, 3200, 256], F = 1024)
FWD_TIMED = [(f"{name}{'p' if m > 1 else ''}", kind, m)
             for m in (1, 2, 4)
             for name, kind in (("b7", "inter"), ("b9", "intra"),
                                ("b11", "ffn"))]
# the attention backwards timed: (kernel, kind, n, S, shards m; 1 = full)
ATTN_TIMED = [("b10", "intra", 25, 128, 1), ("b8", "inter", 25, 128, 1),
              ("b10p", "intra", 25, 128, 2), ("b8p", "inter", 25, 128, 2),
              ("b10p", "intra", 25, 128, 4), ("b8p", "inter", 25, 128, 4),
              ("b10", "intra", 13, 256, 1), ("b8", "inter", 94, 128, 1)]


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def _tcn_tol(key: str) -> float:
    kern, dtype = key.split()[:2]
    if kern == "dpt":
        at = "dpt forward" if key.endswith(" forward") else "dpt"
        return TCN_TOL[at, key.split()[2]]
    return TCN_TOL[kern if kern in ("b1", "b4", "b6") else "bwd", dtype]


def _f64_block_grads(torch, args, g, dilation: int):
    """The ten cotangents of one gLN block (non-causal) with every product
    and statistic in float64: autograd through the block's math on f64
    copies of the operands."""
    from convtasnet_tpu_torch.ops.conv import depthwise_conv1d, prelu
    from convtasnet_tpu_torch.ops.norm import global_layer_norm

    prims = [t.detach().double().requires_grad_(True) for t in args]
    x, w_in, dw, w_out, a1, a2, g1, b1, g2, b2 = prims
    with torch.enable_grad():
        h = global_layer_norm(prelu(x @ w_in, a1), g1, b1)
        h = global_layer_norm(
            prelu(depthwise_conv1d(h, dw, dilation, False), a2), g2, b2)
        return torch.autograd.grad(x + h @ w_out, prims, g.double())


def f64_lines(mine: dict, other: dict) -> list:
    """Lines for the f64 distances both trees carry: each cotangent's
    distance of this tree's kernel, the other tree's and the f32 twin's."""
    lines = []
    for key in sorted(k for k in mine
                      if k.startswith(F64) and not k.startswith(F64 + "twin")):
        name = key[len(F64):]
        theirs = other.get(key)
        lines.append(f"{name}: from the f64 block, this tree {mine[key]:.3e}"
                     + ("" if theirs is None else f", other {theirs:.3e}")
                     + f", the f32 twin {mine[F64 + 'twin ' + name]:.3e}")
    return lines


def _twins(out: dict, key: str, got, want) -> None:
    """Each output of a TCN case (a tensor or a sequence of them, ``key``
    and ``key i``) into ``out``, and where the case's outputs are held by
    distance (``bitwise`` false) its distance from ``want``'s as ``twin
    key``."""
    pairs = ([(key, got, want)] if not isinstance(got, (list, tuple))
             else [(f"{key} {i}", q, w) for i, (q, w)
                   in enumerate(zip(got, want))])
    for k, q, w in pairs:
        out[k] = q.cpu()
        if not bitwise(k):
            out[f"twin {k}"] = rel_l2(q, w)


def compare(mine: dict, other: dict):
    """Lines to print and the keys at fault: the ``bitwise`` outputs (all
    but the bf16 forward of B7 and its partial mode) must
    equal the other tree's bit for bit; every other output reports its
    relative L2 to the other tree's, and is at fault when this tree's
    distance from a twin (the ``twin `` and ``bf16 twin `` entries)
    exceeds its bar. Every output with a twin entry prints the distances
    from its twins of both trees that have them."""
    lines, bad = [], []
    for key in sorted(k for k in other if not k.startswith(TWINS + (F64,))):
        if key not in mine:
            lines.append(f"{key}: missing in this tree")
            bad.append(key)
            continue
        twin, far = "", False
        for prefix in TWINS:
            if f"{prefix}{key}" not in mine:
                continue
            bar = (_tcn_tol(key) if prefix == "twin "
                   else TCN_TOL["dpt", "bfloat16"])
            mt = mine[f"{prefix}{key}"]
            ot = other.get(f"{prefix}{key}")
            twin += (f"; from the {prefix}this tree {mt:.3e}"
                     + ("" if ot is None else f", other {ot:.3e}")
                     + f" (bar {bar:.0e})")
            far = far or not mt <= bar
        if bitwise(key):
            same = mine[key].shape == other[key].shape and bool(
                (mine[key] == other[key]).all())
            lines.append(f"{key}: {'same bits' if same else 'DIFFERENT'}"
                         + twin)
            if not same:
                bad.append(key)
            continue
        lines.append(f"{key}: trees apart rel_l2 "
                     f"{rel_l2(mine[key], other[key]):.3e}" + twin)
        if far or f"twin {key}" not in mine:
            bad.append(key)
    return lines, bad


def same_bits(mine: dict, other: dict):
    """(n, of): how many of the other tree's outputs, those held by
    distance too (the twin distances aside), this tree gives bit for
    bit."""
    keys = [k for k in other if not k.startswith(TWINS + (F64,))]
    n = sum(1 for k in keys if k in mine and mine[k].shape == other[k].shape
            and bool((mine[k] == other[k]).all()))
    return n, len(keys)


def summarize(turns: list) -> list:
    """Lines for the timed turns [(tree, {metric: ms}), ...] in the order
    run: each metric's times per tree in turn order, the means and the
    ratio this / other."""
    lines = []
    metrics = dict.fromkeys(m for _, res in turns for m in res
                            if not m.startswith("kernels "))
    for metric in metrics:
        per = {}
        for tree, res in turns:
            if metric in res:
                per.setdefault(tree, []).append(res[metric])
        unit = "GiB" if metric.startswith("peak ") else "ms"
        if set(per) != {"this", "other"}:   # a shape one tree refuses
            for tree, v in per.items():
                lines.append(f"{metric}: {tree} tree only "
                             f"{' '.join(f'{t:.4f}' for t in v)} {unit}")
            continue
        mean = {t: sum(v) / len(v) for t, v in per.items()}
        lines.append(f"{metric}: other {' '.join(f'{v:.4f}' for v in per['other'])}"
                     f" | this {' '.join(f'{v:.4f}' for v in per['this'])} "
                     f"{unit}; means {mean['other']:.4f} -> "
                     f"{mean['this']:.4f} (x{mean['this'] / mean['other']:.3f})")
    series = [(m, [f"d={d}" for d in DILATIONS])
              for m in ("b1 gLN", "b1 cLN causal", "b2 gLN", "b3 cLN causal")]
    series += [(m, [f"d=({d1},{d2})" for d1, d2 in PAIRS])
               for m in ("b4 gLN", "2 x b1 gLN", "b4 cLN causal",
                         "2 x b1 cLN causal", "b5 gLN", "b1 + 2 x b2 gLN")]
    series += [(f"{m}{tag}", [f"d=({d1},{d2})" for d1, d2 in PAIRS])
               for tag in (" f32", " H=192")
               for m in ("b4 gLN", "2 x b1 gLN", "b5 gLN", "b1 + 2 x b2 gLN")]
    series += [(f"b6 Hs={hs}", [f"d={d}" for d in DILATIONS])
               for hs in (256, 128)]
    series += [(f"device b6 Hs={hs}", [f"d={d}" for d in (1, 16, 128)])
               for hs in (256, 128)]
    for tree in ("other", "this"):   # each tree's kernels, by name
        per = {}
        for t, res in turns:
            if t == tree:
                for key, us in res.items():
                    if key.startswith("kernels "):
                        per.setdefault(key, []).append(us)
        for key, v in per.items():
            head, kernel = key[len("kernels "):].split(" :: ", 1)
            kernel, count = kernel.rsplit(" x", 1)
            lines.append(f"{head} :: {kernel[:60]} x{count} ({tree}): "
                         f"{sum(v) / len(v):.1f} us per call")
    for metric, at in series:
        for tree in ("other", "this"):
            vals = [res[f"{metric} {a}"] for t, res in turns if t == tree
                    for a in at if f"{metric} {a}" in res]
            if vals:
                lines.append(f"{metric} mean over "
                             f"{'pairs' if '(' in at[0] else 'd'}, {tree}: "
                             f"{sum(vals) / len(vals):.4f} ms")
    return lines


def _block_inputs(torch, dtype, seed: int, norm: str, H=H, P=P):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    dt = getattr(torch, dtype)
    args = (rn(M, K, B).to(dt), rn(B, H, scale=B ** -0.5).to(dt),
            rn(P, H).to(dt), rn(H, B, scale=H ** -0.5).to(dt),
            torch.tensor(0.25, device="cuda"),
            torch.tensor(-0.1, device="cuda"),
            1.0 + 0.1 * rn(H), 0.1 * rn(H), 1.0 + 0.1 * rn(H), 0.1 * rn(H))
    return args, rn(M, K, B).to(dt)


def dump(path: str) -> None:
    import torch

    from convtasnet_tpu_torch.ops.cuda import (
        dpt_attention,
        dpt_ffn,
        dpt_intra,
        tcn_block,
        tcn_block_bwd,
        tcn_block_pair,
        tcn_block_pair_bwd,
        tcn_block_tp,
    )

    fns = {"inter": (dpt_attention.fused_inter_attention,
                     dpt_attention.fused_inter_attention_bwd),
           "intra": (dpt_intra.fused_intra_attention,
                     dpt_intra.fused_intra_attention_bwd),
           "ffn": (dpt_ffn.fused_ffn, dpt_ffn.fused_ffn_bwd)}

    twins = {"inter": dpt_attention.inter_attention_bwd_reference,
             "intra": dpt_intra.intra_attention_bwd_reference,
             "ffn": dpt_ffn.ffn_bwd_reference}
    fwd_twins = {"inter": dpt_attention.inter_attention_reference,
                 "intra": dpt_intra.intra_attention_reference,
                 "ffn": dpt_ffn.ffn_reference}
    # the attention forward at its rounding points (a tree older than the
    # Hopper forward designs has none: it holds its forwards by bits)
    rounded_attn = getattr(dpt_attention, "attention_rounded_reference", None)

    def forward(kind, key, x, w, **kw):
        """A forward's output; a bf16 output (full or partial) also its
        distances from the forward at its rounding points and from its
        bf16 twin."""
        with torch.inference_mode():
            got = fns[kind][0](x, *w, **kw)
            if x.dtype == torch.bfloat16 and kind in fwd_twins:
                same = fwd_twins[kind](x, *w, **kw)
                if kind == "ffn":   # its bf16 twin rounds where it rounds
                    out[f"twin {key} forward"] = rel_l2(got, same)
                elif rounded_attn is not None:
                    out[f"twin {key} forward"] = rel_l2(got, rounded_attn(
                        x, *w, attend_axis=1 if kind == "inter" else 2,
                        **kw))
                out[f"bf16 twin {key} forward"] = rel_l2(got, same)
        out[f"{key} forward"] = got.cpu()

    def bwd_twins(kind, key, got, x, gr, w, **kw):
        """A bf16 DPT backward's distance from its bf16 twin, per cotangent
        (its outputs are held by distance)."""
        if x.dtype != torch.bfloat16:
            return
        want = twins[kind](x, gr, *w, **kw)
        for i, (q, t) in enumerate(zip(got, want)):
            if t.any():
                out[f"twin {key} backward {i}"] = rel_l2(q, t)
            else:   # db_down of a partial backward: zero in both
                out[f"twin {key} backward {i}"] = float(q.any())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    cases = [(kind, dtype, S, heads, fwd, bwd, 256, None)
             for kind, dtype, S, heads, fwd, bwd in CASES]
    cases += [(kind, dtype, 128, B // 32, True, True, B, m)
              for kind, dtype, B, m in WIDTH_CASES]
    for kind, dtype, S, heads, fwd, bwd, Bd, width_m in cases:
        g = torch.Generator(device="cuda").manual_seed(
            S + heads + (0 if Bd == 256 else Bd))

        def rn(*shape, scale=1.0):
            return torch.randn(*shape, generator=g, device="cuda") * scale

        F, n = 4 * Bd, 3199 // S + 1
        dt = getattr(torch, dtype)
        valid = torch.arange(n * S, device="cuda").reshape(n, S) < 3199
        x = rn(M, n, S, Bd).to(dt)
        if kind == "ffn":
            x = x.reshape(M, n * S, Bd)
            w = (1.0 + 0.1 * rn(Bd), 0.1 * rn(Bd), rn(Bd, F, scale=Bd ** -0.5),
                 0.1 * rn(F), rn(F, Bd, scale=F ** -0.5), 0.1 * rn(Bd))
            kw = {}
        else:
            w = (1.0 + 0.1 * rn(Bd), 0.1 * rn(Bd),
                 rn(Bd, 3 * Bd, scale=Bd ** -0.5), rn(Bd, Bd, scale=Bd ** -0.5),
                 torch.where(valid, 0.0, -1e9).to(torch.float32))
            kw = dict(n_heads=heads)
        key = f"dpt {kind} {dtype} S={S} heads={heads}"
        if Bd != 256:
            key = f"dpt {kind} {dtype} B={Bd} S={S} heads={heads}"
        fused_bwd = fns[kind][1]
        if fwd:
            forward(kind, key, x, w, **kw)
        if bwd:
            gr = (rn(M, n * S, Bd) * valid.reshape(1, -1, 1)).reshape(
                x.shape).to(dt)
            got = fused_bwd(x, gr, *w, **kw)
            for i, t in enumerate(got):
                out[f"{key} backward {i}"] = t.cpu()
            bwd_twins(kind, key, got, x, gr, w, **kw)
            # the partial modes on the last shard of m (S = 128 only)
            for m in ((width_m,) if width_m else
                      PARTIAL_SHARDS if S == 128 else ()):
                xs, *ws = _shard((x, *w), kind, m, m - 1)
                pkw = dict(kw, partial=True)
                if kind != "ffn":
                    pkw["n_heads"] = heads // m
                pkey = f"{key} partial m={m}"
                forward(kind, pkey, xs, ws, **pkw)
                got = fused_bwd(xs, gr, *ws, **pkw)
                for i, t in enumerate(got):
                    out[f"{pkey} backward {i}"] = t.cpu()
                bwd_twins(kind, pkey, got, xs, gr, ws, **pkw)
        torch.cuda.synchronize()
    for dtype, hs, d in B6_CASES:
        g = torch.Generator(device="cuda").manual_seed(hs + d)

        def rn(*shape):
            return torch.randn(*shape, generator=g, device="cuda")

        h = torch.nn.functional.leaky_relu(rn(M, K, hs), 0.25).to(
            getattr(torch, dtype))
        stats1 = torch.stack([0.1 * rn(M), 1.0 + 0.1 * rn(M)], dim=-1)
        args = (h, stats1, rn(P, hs) * 0.1, rn(hs, B) * hs ** -0.5,
                torch.tensor(0.25, device="cuda"), 1.0 + 0.1 * rn(hs),
                0.1 * rn(hs), 1.0 + 0.1 * rn(hs))
        key = f"b6 {dtype} Hs={hs} d={d}"
        with torch.inference_mode():
            z, sums = tcn_block_tp.fused_tp_stage2(*args, dilation=d,
                                                   causal=False)
            zw, sw = tcn_block_tp.tp_stage2_reference(
                *args, dilation=d, causal=False, rounding="pallas")
        out[f"{key} z"] = z.cpu()
        out[f"{key} sums"] = sums.cpu()
        # at B6's rounding points: bf16's bar, and f32's by distance
        out[f"twin {key} z"] = rel_l2(z, zw)
        out[f"twin {key} sums"] = rel_l2(sums, sw)
    for kern, norm, causal, dtype, d in TCN_CASES:
        args, g = _block_inputs(torch, dtype, 100 + d, norm)
        kw = dict(dilation=d, causal=causal, norm_type=norm)
        key = f"{kern} {dtype} {norm} causal={int(causal)} d={d}"
        if kern == "b1":
            with torch.inference_mode():
                got = tcn_block.fused_tcn_block(*args, **kw)
                want = tcn_block.fused_tcn_block_reference(*args, **kw)
            out[key] = got.cpu()
            out[f"twin {key}"] = rel_l2(got, want)
            continue
        got = tcn_block_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
        want = tcn_block_bwd.fused_tcn_block_bwd_reference(
            args[0], g, *args[1:], **kw)
        # dx and the weight gradients; the slope gradients (sums of
        # millions of cancelling terms) are held by the smoke's gates
        for name, i in (("dx", 0), ("dW_in", 1), ("d_dw", 2), ("dW_out", 3),
                        ("dg1", 6), ("db1", 7), ("dg2", 8), ("db2", 9)):
            out[f"{key} {name}"] = got[i].cpu()
            out[f"twin {key} {name}"] = rel_l2(got[i], want[i])
        if kern == "b2" and dtype == "float32" and d == 1:
            # all ten cotangents' distances from the f64 block, this
            # tree's kernel and the f32 twin (printed, not held)
            exact = _f64_block_grads(torch, args, g, d)
            for i, name in enumerate(GRAD_NAMES):
                out[f"f64 {key} {name}"] = rel_l2(got[i].double(), exact[i])
                out[f"f64 twin {key} {name}"] = rel_l2(want[i].double(),
                                                       exact[i])
        torch.cuda.synchronize()
    for kern, norm, causal, dtype, d, taps in TCN_TAPS_CASES:
        args, g = _block_inputs(torch, dtype, 150 + d + taps, norm, P=taps)
        key = f"{kern} {dtype} {norm} causal={int(causal)} d={d} P={taps}"
        # the f32 twins (exact f32) of the outputs held by distance
        held = not bitwise(key)
        if kern == "b5":
            pb, _ = _block_inputs(torch, dtype, 160 + d + taps, norm, P=taps)
            kw = dict(d1=d, d2=2 * d, causal=causal)
            got = tcn_block_pair_bwd.fused_tcn_block_pair_bwd(
                args[0], g, list(args[1:]), list(pb[1:]), **kw)
            want = (tcn_block_pair_bwd.fused_tcn_block_pair_bwd_reference(
                args[0], g, list(args[1:]), list(pb[1:]), **kw)
                if held else got)
            flat = (got[0], *got[1], *got[2])
            flat_want = (want[0], *want[1], *want[2])
            _twins(out, key, flat, flat_want)
            if held:   # the four slopes as one vector, as the smoke holds them
                slopes = B5_SLOPES
                dist = rel_l2(torch.stack([flat[i] for i in slopes]),
                              torch.stack([flat_want[i] for i in slopes]))
                for i in slopes:
                    out[f"twin {key} {i}"] = dist
            continue
        kw = dict(dilation=d, causal=causal, norm_type=norm)
        if kern == "b1":
            with torch.inference_mode():
                got = tcn_block.fused_tcn_block(*args, **kw)
                want = (tcn_block.fused_tcn_block_reference(*args, **kw)
                        if held else got)
            _twins(out, key, got, want)
            continue
        got = tcn_block_bwd.fused_tcn_block_bwd(args[0], g, *args[1:], **kw)
        want = (tcn_block_bwd.fused_tcn_block_bwd_reference(
            args[0], g, *args[1:], **kw) if held else got)
        _twins(out, key, got, want)
        torch.cuda.synchronize()
    for kern, norm, causal, dtype, d1 in PAIR_CASES:
        pa, g = _block_inputs(torch, dtype, 200 + d1, norm)
        pb, _ = _block_inputs(torch, dtype, 300 + d1, norm)
        x, pa, pb = pa[0], list(pa[1:]), list(pb[1:])
        key = f"{kern} {dtype} {norm} causal={int(causal)} d=({d1},{2 * d1})"
        kw = dict(d1=d1, d2=2 * d1, causal=causal)
        if kern == "b4":
            with torch.inference_mode():
                got = tcn_block_pair.fused_tcn_block_pair(
                    x, pa, pb, norm_type=norm, **kw)
                want = tcn_block_pair.fused_tcn_block_pair_reference(
                    x, pa, pb, norm_type=norm, **kw)
            out[key] = got.cpu()
            out[f"twin {key}"] = rel_l2(got, want)
            continue
        got = tcn_block_pair_bwd.fused_tcn_block_pair_bwd(x, g, pa, pb, **kw)
        # the twin in exact f32, as the smoke holds B5 with a random
        # cotangent: a bf16 twin is itself ~8e-2 from it in dW_in
        want = tcn_block_pair_bwd.fused_tcn_block_pair_bwd_reference(
            x.float(), g.float(), [t.float() for t in pa],
            [t.float() for t in pb], **kw)
        # dx and each block's weight gradients, as for B2 above
        outs = [("dx", got[0], want[0])] + [
            (f"{blk} {name}", q[i], w[i])
            for blk, q, w in (("a", got[1], want[1]), ("b", got[2], want[2]))
            for name, i in (("dW_in", 0), ("d_dw", 1), ("dW_out", 2),
                            ("dg1", 5), ("db1", 6), ("dg2", 7), ("db2", 8))]
        for name, q, w in outs:
            out[f"{key} {name}"] = q.cpu()
            out[f"twin {key} {name}"] = rel_l2(q, w)
        torch.cuda.synchronize()
    torch.save(out, path)


def _ms(torch, fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, res: dict, name: str, fn, iters: int = 20) -> None:
    """The device time of one call of fn (its kernels' durations summed,
    from torch.profiler, so the host's time between launches is left
    out) under ``device <name>``, and each kernel's share under
    ``kernels <name> :: <kernel>`` (us per call)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0
            and "#" not in e.key]
    res[f"device {name}"] = sum(e.self_device_time_total
                                for e in rows) / iters / 1e3
    for e in rows:   # keyed by the whole name: templates share a prefix
        res[f"kernels {name} :: {e.key} x{e.count / iters:g}"] = (
            e.self_device_time_total / iters)


def _peak_gib(torch, fn) -> float:
    """The peak device memory of one call of fn, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _time_pairs(torch, res: dict, tag: str, x, g, pa, pb, norms) -> None:
    """Times B4 (each of norms: (label, norm, causal)) beside two chained
    B1 calls, and B5 beside B1 + 2 x B2, per pair of dilations, into res
    under names that end in tag."""
    from convtasnet_tpu_torch.ops.cuda import (
        tcn_block,
        tcn_block_bwd,
        tcn_block_pair,
        tcn_block_pair_bwd,
    )

    for d1, d2 in PAIRS:
        at = f"d=({d1},{d2})"
        for label, norm, causal in norms:
            with torch.inference_mode():
                res[f"b4 {label}{tag} {at}"] = _ms(
                    torch, lambda: tcn_block_pair.fused_tcn_block_pair(
                        x, pa, pb, d1=d1, d2=d2, causal=causal,
                        norm_type=norm), 20)
                res[f"2 x b1 {label}{tag} {at}"] = _ms(
                    torch, lambda: tcn_block.fused_tcn_block(
                        tcn_block.fused_tcn_block(
                            x, *pa, dilation=d1, causal=causal,
                            norm_type=norm),
                        *pb, dilation=d2, causal=causal, norm_type=norm), 20)
        res[f"b5 gLN{tag} {at}"] = _ms(
            torch, lambda: tcn_block_pair_bwd.fused_tcn_block_pair_bwd(
                x, g, pa, pb, d1=d1, d2=d2, causal=False), 20)

        def chained():
            with torch.no_grad():
                x1 = tcn_block.fused_tcn_block(x, *pa, dilation=d1,
                                               causal=False, norm_type="gLN")
            dx1 = tcn_block_bwd.fused_tcn_block_bwd(
                x1, g, *pb, dilation=d2, causal=False)[0]
            tcn_block_bwd.fused_tcn_block_bwd(x, dx1, *pa, dilation=d1,
                                              causal=False)

        res[f"b1 + 2 x b2 gLN{tag} {at}"] = _ms(torch, chained, 20)


def _time_attention_bwd(torch, res: dict, rn) -> None:
    """B8, B10 and their partial modes at ``ATTN_TIMED``'s shapes in bf16
    with the real key mask (3199 frames of 4 s, 11999 of 15 s at n = 94), a
    cotangent zero on the padded rows, and beside each
    ``scaled_dot_product_attention`` forward + backward at its core's
    shapes (problems x heads, attended length, d = 32; no mask)."""
    from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_intra

    bwd = {"inter": dpt_attention.fused_inter_attention_bwd,
           "intra": dpt_intra.fused_intra_attention_bwd}
    for name, kind, n, S, m in ATTN_TIMED:
        frames = 3199 if n * S < 11999 else 11999
        valid = torch.arange(n * S, device="cuda").reshape(n, S) < frames
        x = rn(M, n, S, B).bfloat16()
        gr = (rn(M, n * S, B) * valid.reshape(1, -1, 1)).reshape(
            x.shape).bfloat16()
        w = (1.0 + 0.1 * rn(B), 0.1 * rn(B), rn(B, 3 * B, scale=B ** -0.5),
             rn(B, B, scale=B ** -0.5),
             torch.where(valid, 0.0, -1e9).to(torch.float32))
        kw = dict(n_heads=8)
        if m > 1:
            w = _shard((x, *w), kind, m, m - 1)[1:]
            kw = dict(n_heads=8 // m, partial=True)
        at = f"{name} [8,{n},{S},256]" + (f" m={m}" if m > 1 else "")
        res[at] = _ms(torch, lambda: bwd[kind](x, gr, *w, **kw), 20)
        _device_ms(torch, res, at, lambda: bwd[kind](x, gr, *w, **kw))
        problems, length = (M * n, S) if kind == "intra" else (M * S, n)
        qkv = [rn(problems, 8 // m, length, 32).bfloat16().requires_grad_()
               for _ in range(3)]
        go = rn(problems, 8 // m, length, 32).bfloat16()

        def sdpa():
            out = torch.nn.functional.scaled_dot_product_attention(*qkv)
            torch.autograd.grad(out, qkv, go)

        res[f"sdpa fwd+bwd {at}"] = _ms(torch, sdpa, 20)


def _time_f32_attention(torch, res: dict, rn) -> None:
    """B7-B10 in f32 (their first designs) at [8, 25, 128, 256] with the
    real key mask, a cotangent zero on the padded rows, at head widths 16,
    32, 64 and 128 (16, 8, 4 and 2 heads), forward and backward, each with
    its device time per call and per kernel; a width the tree refuses is
    left out."""
    from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_intra

    fns = {"inter": (dpt_attention.fused_inter_attention,
                     dpt_attention.fused_inter_attention_bwd),
           "intra": (dpt_intra.fused_intra_attention,
                     dpt_intra.fused_intra_attention_bwd)}
    n, S = 25, 128
    valid = torch.arange(n * S, device="cuda").reshape(n, S) < 3199
    x = rn(M, n, S, B)
    gr = (rn(M, n * S, B) * valid.reshape(1, -1, 1)).reshape(x.shape)
    w = (1.0 + 0.1 * rn(B), 0.1 * rn(B), rn(B, 3 * B, scale=B ** -0.5),
         rn(B, B, scale=B ** -0.5),
         torch.where(valid, 0.0, -1e9).to(torch.float32))
    for name, kind in (("b7/b8", "inter"), ("b9/b10", "intra")):
        fwd, bwd = fns[kind]
        for heads in (16, 8, 4, 2):
            kw = dict(n_heads=heads)
            try:
                with torch.inference_mode():
                    fwd(x, *w, **kw)
            except ValueError:   # a head width this tree does not take
                continue
            at = f"[8,{n},{S},256] f32 d={B // heads}"
            with torch.inference_mode():
                res[f"{name} forward {at}"] = _ms(
                    torch, lambda: fwd(x, *w, **kw), 10)
                _device_ms(torch, res, f"{name} forward {at}",
                           lambda: fwd(x, *w, **kw), 10)
            res[f"{name} backward {at}"] = _ms(
                torch, lambda: bwd(x, gr, *w, **kw), 5)
            _device_ms(torch, res, f"{name} backward {at}",
                       lambda: bwd(x, gr, *w, **kw), 5)


def _time_dpt_forwards(torch, res: dict, rn) -> None:
    """B7, B9, B11 and their partial modes (``FWD_TIMED``) in bf16 with the
    real key mask (3199 frames of 4 s), each with its device time per call
    and per kernel; beside B7 and B9 (and their partial modes)
    ``scaled_dot_product_attention``'s forward at its core's shapes
    (problems x heads, attended length, d = 32; no mask; CUDA events and
    device time), a yardstick no kernel calls; and the DPT quality
    default's forward at B=8 x 4 s."""
    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra

    fwd = {"inter": dpt_attention.fused_inter_attention,
           "intra": dpt_intra.fused_intra_attention,
           "ffn": dpt_ffn.fused_ffn}
    n, S = 25, 128
    valid = torch.arange(n * S, device="cuda").reshape(n, S) < 3199
    x = rn(M, n, S, B).bfloat16()
    attn = (1.0 + 0.1 * rn(B), 0.1 * rn(B), rn(B, 3 * B, scale=B ** -0.5),
            rn(B, B, scale=B ** -0.5),
            torch.where(valid, 0.0, -1e9).to(torch.float32))
    ffn = (1.0 + 0.1 * rn(B), 0.1 * rn(B), rn(B, F_DPT, scale=B ** -0.5),
           0.1 * rn(F_DPT), rn(F_DPT, B, scale=F_DPT ** -0.5), 0.1 * rn(B))
    with torch.inference_mode():
        for name, kind, m in FWD_TIMED:
            xs, w = ((x.reshape(M, n * S, B), ffn) if kind == "ffn"
                     else (x, attn))
            kw = {} if kind == "ffn" else dict(n_heads=8)
            if m > 1:
                w = _shard((xs, *w), kind, m, m - 1)[1:]
                kw = dict(kw, partial=True)
                if kind != "ffn":
                    kw["n_heads"] = 8 // m
            at = (f"{name} [8,{n},{S},256]" if kind != "ffn"
                  else f"{name} [8,3200,256] F={F_DPT // m}")
            at += f" m={m}" if m > 1 else ""
            res[at] = _ms(torch, lambda: fwd[kind](xs, *w, **kw), 20)
            _device_ms(torch, res, at, lambda: fwd[kind](xs, *w, **kw))
            if kind == "ffn":
                continue
            problems, length = (M * n, S) if kind == "intra" else (M * S, n)
            q, k, v = (rn(problems, 8 // m, length, 32).bfloat16()
                       for _ in range(3))
            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v)

            res[f"sdpa fwd {at}"] = _ms(torch, sdpa, 20)
            _device_ms(torch, res, f"sdpa fwd {at}", sdpa)
        cfg = ConvTasNetConfig(separator="dpt", compute_dtype="bfloat16")
        model = ConvTasNet(cfg, device="cuda").eval()
        mix = rn(M, 4 * 8000)
        res["dpt forward B=8 x 4 s"] = _ms(torch, lambda: model(mix), 10)
        del model


def _time_tp_and_ffn(torch, res: dict) -> None:
    """B6 at [8, 3199, Hs], Hs = 256 and 128, per dilation; B12 at [8,
    3200, 256], F = 1024, and B12p on the last shard of m = 2 and 4; the
    paper config's forward over two shards; the DPT quality default's
    train step, unsharded and over two shards; bf16, B=8 x 4 s."""
    from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.ops.cuda import dpt_ffn, tcn_block_tp
    from convtasnet_tpu_torch.parallel.dpt_tp import make_dpt_tp_train_step
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward
    from convtasnet_tpu_torch.train import train_step as ts

    g = torch.Generator(device="cuda").manual_seed(31)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    for hs in (256, 128):
        args = (torch.nn.functional.leaky_relu(rn(M, K, hs), 0.25).bfloat16(),
                torch.stack([0.1 * rn(M), 1.0 + 0.1 * rn(M)], dim=-1),
                rn(P, hs, scale=0.1), rn(hs, B, scale=hs ** -0.5),
                torch.tensor(0.25, device="cuda"), 1.0 + 0.1 * rn(hs),
                0.1 * rn(hs), 1.0 + 0.1 * rn(hs))
        for d in DILATIONS:
            with torch.inference_mode():
                res[f"b6 Hs={hs} d={d}"] = _ms(
                    torch, lambda: tcn_block_tp.fused_tp_stage2(
                        *args, dilation=d, causal=False), 20)
                if d in (1, 16, 128):
                    _device_ms(torch, res, f"b6 Hs={hs} d={d}",
                               lambda: tcn_block_tp.fused_tp_stage2(
                                   *args, dilation=d, causal=False))
    _time_attention_bwd(torch, res, rn)
    x = rn(M, R_DPT // M, B).bfloat16()
    gr = rn(M, R_DPT // M, B).bfloat16()
    w = (1.0 + 0.1 * rn(B), 0.1 * rn(B), rn(B, F_DPT, scale=B ** -0.5),
         0.1 * rn(F_DPT), rn(F_DPT, B, scale=F_DPT ** -0.5), 0.1 * rn(B))
    res["b12 [8,3200,256] F=1024"] = _ms(
        torch, lambda: dpt_ffn.fused_ffn_bwd(x, gr, *w), 20)
    _device_ms(torch, res, "b12 [8,3200,256] F=1024",
               lambda: dpt_ffn.fused_ffn_bwd(x, gr, *w))
    for m in (2, 4):
        ws = _shard((x, *w), "ffn", m, m - 1)[1:]
        name = f"b12p m={m} [8,3200,256] F={F_DPT // m}"
        res[name] = _ms(
            torch, lambda: dpt_ffn.fused_ffn_bwd(x, gr, *ws, partial=True),
            20)
        _device_ms(torch, res, name, lambda: dpt_ffn.fused_ffn_bwd(
            x, gr, *ws, partial=True))
    T = 4 * 8000
    gen = torch.Generator(device="cuda").manual_seed(32)
    mix = torch.randn(M, T, generator=gen, device="cuda")
    data = (mix, torch.full((M,), T, dtype=torch.int32, device="cuda"),
            torch.randn(M, 2, T, generator=gen, device="cuda"),
            torch.ones(M, device="cuda"))
    cfg = ConvTasNetConfig(compute_dtype="bfloat16")
    sd = ConvTasNet(cfg, device="cuda").state_dict()
    with torch.inference_mode():
        res["tcn tp forward m=2 B=8 x 4 s"] = _ms(
            torch, lambda: tp_forward(cfg, sd, mix, shard_devices(2, "cuda")),
            5)
    del sd
    dcfg = ConvTasNetConfig(separator="dpt", compute_dtype="bfloat16")
    state = ts.create_train_state(dcfg, SolverConfig(), device="cuda",
                                  use_pallas=True)
    step = ts.make_train_step()
    res["dpt train step B=8 x 4 s"] = _ms(torch, lambda: step(state, data),
                                          10)
    tp_step = make_dpt_tp_train_step(dcfg, shard_devices(2, "cuda"))
    res["dpt tp train step m=2 B=8 x 4 s"] = _ms(
        torch, lambda: tp_step(state, data), 5)
    del state


# the f32 intra kernels' chunk lengths timed: the first design's longest
# (n = 13 chunks of 4 s) and the row-statistics core's (n = 10, 7)
F32_INTRA_LONG = ((13, 256), (10, 320), (7, 512))
PEAK_F32_FMA = 67e12     # an H100 SXM's f32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12


def _f32_intra_bound_ms(n: int, S: int, bwd: bool) -> float:
    """The least time of B9 (or B10) in f32 at [8, n, S, 256], 8 heads of
    32: its products (QKV, the core's q k^T and p v, out; the backward's
    11 projection products and 6 core products, QKV recomputed) at the f32
    FMA rate, or its x in and out (and g, dx) at the HBM rate."""
    R, core = M * n * S, 2.0 * M * n * 8 * S * S * 32
    flops = (11 * 2.0 * R * B * B + 6 * core if bwd
             else 2.0 * R * B * 4 * B + 2 * core)
    nbytes = (3 if bwd else 2) * R * B * 4
    return max(flops / PEAK_F32_FMA, nbytes / PEAK_BYTES_S) * 1e3


def _time_f32_intra_long(torch, res: dict, rn) -> None:
    """B9 and B10 in f32 at d = 32 at ``F32_INTRA_LONG``'s shapes with the
    real key mask, their bounds, and ``scaled_dot_product_attention`` in
    f32 at their cores' shapes; a shape the tree refuses is left out
    (the bound and the library time are printed all the same)."""
    from convtasnet_tpu_torch.ops.cuda import dpt_intra

    fwd, bwd = (dpt_intra.fused_intra_attention,
                dpt_intra.fused_intra_attention_bwd)
    kw = dict(n_heads=8)
    for n, S in F32_INTRA_LONG:
        valid = torch.arange(n * S, device="cuda").reshape(n, S) < 3199
        x = rn(M, n, S, B)
        gr = (rn(M, n * S, B) * valid.reshape(1, -1, 1)).reshape(x.shape)
        w = (1.0 + 0.1 * rn(B), 0.1 * rn(B), rn(B, 3 * B, scale=B ** -0.5),
             rn(B, B, scale=B ** -0.5),
             torch.where(valid, 0.0, -1e9).to(torch.float32))
        at = f"[8,{n},{S},256] f32 d=32"
        res[f"bound b9 forward {at}"] = _f32_intra_bound_ms(n, S, False)
        res[f"bound b10 backward {at}"] = _f32_intra_bound_ms(n, S, True)
        qkv = [rn(M * n, 8, S, 32).requires_grad_() for _ in range(3)]
        go = rn(M * n, 8, S, 32)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(*qkv)

        def sdpa_bwd():
            torch.autograd.grad(sdpa(), qkv, go)

        with torch.inference_mode():
            _device_ms(torch, res, f"sdpa f32 forward [{8 * n},8,{S},32]",
                       sdpa, 10)
        _device_ms(torch, res, f"sdpa f32 fwd+bwd [{8 * n},8,{S},32]",
                   sdpa_bwd, 5)
        del qkv, go
        try:
            with torch.inference_mode():
                fwd(x, *w, **kw)
        except ValueError:   # a chunk length this tree does not take
            continue
        with torch.inference_mode():
            res[f"b9 forward {at}"] = _ms(torch, lambda: fwd(x, *w, **kw), 10)
            _device_ms(torch, res, f"b9 forward {at}",
                       lambda: fwd(x, *w, **kw), 10)
        res[f"b10 backward {at}"] = _ms(
            torch, lambda: bwd(x, gr, *w, **kw), 5)
        _device_ms(torch, res, f"b10 backward {at}",
                   lambda: bwd(x, gr, *w, **kw), 5)


# the padded widths timed beside the next one on the tile: (B, shards m),
# B / 32 heads, F = 4B
PADDED_TIMED = [(96, 1), (128, 1), (192, 2), (256, 2)]


def _time_padded(torch, res: dict, rn) -> None:
    """B7-B12 (``PADDED_TIMED``: full at B = 96 and 128, on one shard of
    two at B = 192 and 256) in bf16 and f32 at [8, 25, 128, B] with the
    real key mask (the FFN at [8, 3200, B]), forward and backward, each
    with its device time per call and per kernel; a width the tree refuses
    is left out. Where the tree pads (``pad_attention``, ``pad_ffn``), the
    padding copies alone by CUDA events: the forward's (the operands
    padded, the output sliced back) and the backward's (the operands and
    the cotangent padded, the cotangents sliced back)."""
    import torch.nn.functional as F

    from convtasnet_tpu_torch.ops.cuda import dpt_attention, dpt_ffn, dpt_intra

    fns = {"inter": (dpt_attention.fused_inter_attention,
                     dpt_attention.fused_inter_attention_bwd),
           "intra": (dpt_intra.fused_intra_attention,
                     dpt_intra.fused_intra_attention_bwd),
           "ffn": (dpt_ffn.fused_ffn, dpt_ffn.fused_ffn_bwd)}
    names = {"inter": "b7/b8", "intra": "b9/b10", "ffn": "b11/b12"}
    pads = hasattr(dpt_attention, "pad_attention")
    n, S = 25, 128
    valid = torch.arange(n * S, device="cuda").reshape(n, S) < 3199
    for dtype in (torch.bfloat16, torch.float32):
        for Bd, m in PADDED_TIMED:
            heads, F_ = Bd // 32, 4 * Bd
            x = rn(M, n, S, Bd).to(dtype)
            gr = (rn(M, n * S, Bd) * valid.reshape(1, -1, 1)).reshape(
                x.shape).to(dtype)
            w_attn = (1.0 + 0.1 * rn(Bd), 0.1 * rn(Bd),
                      rn(Bd, 3 * Bd, scale=Bd ** -0.5),
                      rn(Bd, Bd, scale=Bd ** -0.5),
                      torch.where(valid, 0.0, -1e9).to(torch.float32))
            w_ffn = (1.0 + 0.1 * rn(Bd), 0.1 * rn(Bd),
                     rn(Bd, F_, scale=Bd ** -0.5), 0.1 * rn(F_),
                     rn(F_, Bd, scale=F_ ** -0.5), 0.1 * rn(Bd))
            for kind in ("inter", "intra", "ffn"):
                fwd, bwd = fns[kind]
                xs, gs, w = ((x.reshape(M, n * S, Bd),
                              gr.reshape(M, n * S, Bd), w_ffn)
                             if kind == "ffn" else (x, gr, w_attn))
                kw = {} if kind == "ffn" else dict(n_heads=heads // m)
                if m > 1:
                    w = _shard((xs, *w), kind, m, m - 1)[1:]
                    kw["partial"] = True
                try:
                    with torch.inference_mode():
                        fwd(xs, *w, **kw)
                except ValueError:   # a width this tree does not take
                    continue
                name = str(dtype).split(".")[-1]
                at = (f"[8,3200,{Bd}] F={F_ // m}" if kind == "ffn"
                      else f"[8,{n},{S},{Bd}]")
                shard = f" m={m}" if m > 1 else ""
                at = f"{names[kind]} {{}} {at}{shard} {name}"
                with torch.inference_mode():
                    res[at.format("forward")] = _ms(
                        torch, lambda: fwd(xs, *w, **kw), 10)
                    _device_ms(torch, res, at.format("forward"),
                               lambda: fwd(xs, *w, **kw), 10)
                res[at.format("backward")] = _ms(
                    torch, lambda: bwd(xs, gs, *w, **kw), 5)
                _device_ms(torch, res, at.format("backward"),
                           lambda: bwd(xs, gs, *w, **kw), 5)
                Bp = -(-Bd // 64) * 64
                Bq = Bd // m
                if not pads or (Bp == Bd and (kind == "ffn" or Bq % 64 == 0)):
                    continue   # this tree, or this sublayer, pads nothing
                # the copies the wrappers add: the operands as _prepare
                # hands them to the pad (weights in x's dtype, the LN
                # affines and biases in f32), then the outputs' slices
                if kind == "ffn":
                    g_, b_, w_up, _, w_down, b_down = w
                    w_up, w_down = w_up.to(dtype), w_down.to(dtype)

                    def pad():
                        return dpt_ffn.pad_ffn(xs, g_, b_, w_up, w_down,
                                               b_down)
                    out_p = torch.empty(M, n * S, Bp, dtype=dtype,
                                        device="cuda")
                    grads_p = (out_p, torch.empty(Bp, device="cuda"),
                               torch.empty(Bp, device="cuda"),
                               torch.empty(Bp, F_ // m, device="cuda"),
                               torch.empty(F_ // m, device="cuda"),
                               torch.empty(F_ // m, Bp, device="cuda"),
                               torch.empty(Bp, device="cuda"))

                    def unpad():
                        return [t.contiguous() for t in
                                dpt_ffn.unpad_ffn_grads(grads_p, Bd)]
                else:
                    g_, b_, w_qkv, w_out, _ = w
                    w_qkv, w_out = w_qkv.to(dtype), w_out.to(dtype)

                    def pad():
                        return dpt_attention.pad_attention(
                            xs, g_, b_, w_qkv, w_out, kw["n_heads"])
                    Bqp = -(-Bq // 64) * 64
                    out_p = torch.empty(M, n, S, Bp, dtype=dtype,
                                        device="cuda")
                    grads_p = (out_p, torch.empty(Bp, device="cuda"),
                               torch.empty(Bp, device="cuda"),
                               torch.empty(Bp, 3 * Bqp, device="cuda"),
                               torch.empty(Bqp, Bp, device="cuda"))

                    # a tree that widens no head slices without the
                    # head count
                    unpad_kw = ({"n_heads": kw["n_heads"]} if "n_heads" in
                                inspect.signature(dpt_attention
                                                  .unpad_attention_grads)
                                .parameters else {})

                    def unpad():
                        return [t.contiguous() for t in
                                dpt_attention.unpad_attention_grads(
                                    grads_p, Bd, Bq, **unpad_kw)]

                def fwd_copies():
                    pad()
                    return out_p[..., :Bd].contiguous()

                def bwd_copies():
                    pad()
                    if Bp != Bd:
                        F.pad(gs, (0, Bp - Bd))
                    return unpad()

                res[at.format("forward padding copies")] = _ms(
                    torch, fwd_copies, 20)
                res[at.format("backward padding copies")] = _ms(
                    torch, bwd_copies, 20)


# --time taps: B1-B6 at the paper shape per P and dilation, bf16 and f32
TAPS_TIMED = [(taps, d) for taps in (3, 17, 33) for d in (1, 128)]
# an H100 SXM's published peaks (chip_smoke.py's): bf16 tensor cores, f32
# FMA outside them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12


def _taps_bound_ms(dtype: str, products: float, conv: float,
                   nbytes: float) -> float:
    """The least time of a TCN kernel's work: the larger of its FLOP (the
    products and the depthwise taps) at the dtype's peak and its bytes
    (each input read once, each output written once) at the HBM rate."""
    return 1e3 * max((products + conv) / PEAK_FLOPS[dtype],
                     nbytes / PEAK_BYTES_S)


def _time_taps(torch, res: dict) -> None:
    """B1 (gLN, cLN causal, BN), B2 (gLN), B3 (cLN causal), B4 and B5
    (gLN, (d1, d2) = (d, 2 d)) and B6 (Hs = 256) at the paper shape
    [8, 3199, 256], H = 512, at P = 3, 17 and 33 taps and d = 1 and 128
    (``TAPS_TIMED``), bf16 and f32: each call's time by CUDA events and its
    device time by torch.profiler, and beside it its bound
    (``_taps_bound_ms``; 2 FLOP per multiply-add: B1 two products of
    2 M K B H and one depthwise pass of 2 M K H P, B2 and B3 five products
    and three depthwise passes, as chip_smoke.tcn_bwd_work counts them, a
    pair twice its blocks', B6 one product of 2 M K Hs B and its
    depthwise pass). A shape the tree refuses (P > 16 on a tree older than
    the routes past 16 taps) is left out."""
    from convtasnet_tpu_torch.ops.cuda import (
        tcn_block,
        tcn_block_bwd,
        tcn_block_pair,
        tcn_block_pair_bwd,
        tcn_block_tp,
    )

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def timed(key, fn, iters, bound):
        try:
            fn()
        except ValueError:   # a P this tree refuses
            return
        res[key] = _ms(torch, fn, iters)
        _device_ms(torch, res, key, fn, iters)
        res[f"bound {key}"] = bound

    bn = tuple(torch.rand(H, device="cuda") + 0.5 for _ in range(4))
    for dtype in ("bfloat16", "float32"):
        for taps, d in TAPS_TIMED:
            at = f"[8,3199,256] H=512 P={taps} d={d} {dtype}"
            prod, conv = 2 * M * K * B * H, 2 * M * K * H * taps
            for label, norm, causal in (("b1 gLN", "gLN", False),
                                        ("b1 cLN causal", "cLN", True),
                                        ("b1 BN", "BN", False)):
                args, g = _block_inputs(torch, dtype, taps + d, norm, P=taps)
                kw = dict(dilation=d, causal=causal, norm_type=norm,
                          bn_stats=bn if norm == "BN" else None)
                with torch.inference_mode():
                    timed(f"{label} {at}",
                          lambda: tcn_block.fused_tcn_block(*args, **kw), 20,
                          _taps_bound_ms(dtype, 2 * prod, conv,
                                         nbytes(*args, args[0])))
            for label, norm, causal in (("b2 gLN", "gLN", False),
                                        ("b3 cLN causal", "cLN", True)):
                args, g = _block_inputs(torch, dtype, taps + d, norm, P=taps)
                fn = functools.partial(
                    tcn_block_bwd.fused_tcn_block_bwd, args[0], g, *args[1:],
                    dilation=d, causal=causal, norm_type=norm)
                try:
                    out = fn()
                except ValueError:
                    continue
                timed(f"{label} {at}", fn, 10, _taps_bound_ms(
                    dtype, 5 * prod, 3 * conv, nbytes(*args, g, *out)))
            pa, g = _block_inputs(torch, dtype, 40 + taps + d, "gLN", P=taps)
            pb, _ = _block_inputs(torch, dtype, 50 + taps + d, "gLN", P=taps)
            x, pa, pb = pa[0], list(pa[1:]), list(pb[1:])
            kw = dict(d1=d, d2=2 * d, causal=False)
            with torch.inference_mode():
                timed(f"b4 gLN {at}",
                      lambda: tcn_block_pair.fused_tcn_block_pair(
                          x, pa, pb, norm_type="gLN", **kw), 20,
                      _taps_bound_ms(dtype, 4 * prod, 2 * conv,
                                     nbytes(x, *pa, *pb, x)))
            fn = functools.partial(
                tcn_block_pair_bwd.fused_tcn_block_pair_bwd, x, g, pa, pb,
                **kw)
            try:
                out = fn()
            except ValueError:
                out = None
            if out is not None:
                timed(f"b5 gLN {at}", fn, 10, _taps_bound_ms(
                    dtype, 2 * 5 * prod, 2 * 3 * conv,
                    nbytes(x, g, *pa, *pb, out[0], *out[1], *out[2])))
            hs = 256
            gen = torch.Generator(device="cuda").manual_seed(taps + d)

            def rn(*shape):
                return torch.randn(*shape, generator=gen, device="cuda")

            h = torch.nn.functional.leaky_relu(rn(M, K, hs), 0.25).to(
                getattr(torch, dtype))
            targs = (h, torch.stack([0.1 * rn(M), 1.0 + 0.1 * rn(M)], -1),
                     rn(taps, hs) * 0.1, rn(hs, B) * hs ** -0.5,
                     torch.tensor(0.25, device="cuda"), 1.0 + 0.1 * rn(hs),
                     0.1 * rn(hs), 1.0 + 0.1 * rn(hs))
            z_bytes = M * K * B * h.element_size()
            with torch.inference_mode():
                timed(f"b6 Hs={hs} {at}",
                      lambda: tcn_block_tp.fused_tp_stage2(
                          *targs, dilation=d, causal=False), 20,
                      _taps_bound_ms(dtype, 2 * M * K * hs * B,
                                     2 * M * K * hs * taps,
                                     nbytes(*targs) + z_bytes))


# --time f32: the f32 TCN kernels' bound at the 3xTF32 rate (three TF32
# tensor-core products a product, 495 / 3 TFLOP/s), and beside it the f32
# FMA rate (PEAK_FLOPS) that bounded the first design
PEAK_3XTF32 = 495e12 / 3
# the products timed in f32 (torch.matmul, tf32 off and on): B1's two,
# B2's three others
F32_PRODUCTS = ("x @ W_in, g @ W_out^T", "y @ W_eff, dh_pre @ W_in^T",
                "hn2^T @ g", "x^T @ dh_pre")


def _time_f32(torch, res: dict) -> None:
    """``--time f32``: B1 (gLN, cLN causal, BN), B2, B3 (cLN causal), B4
    and B5 (gLN, (1, 2)) in f32 at the paper shape [8, 3199, 256], H = 512,
    d = 1: each call by
    CUDA events and in device time with its kernels' shares, beside its
    bound at the 3xTF32 rate (``bound``) and at the f32 FMA rate (``fma
    bound``; each the larger of its FLOP, counted as ``_time_taps`` counts
    them, and its bytes at the HBM rate); the paper config's f32 forward
    and its gLN and causal cLN train steps at B = 8 x 4 s (pairs off),
    device time and idle share; the 3xTF32 core alone at B1's two product
    shapes (``ctn_tf32_matmul_check``, its weight split included; a tree
    without it leaves it out); and torch.matmul at each of the kernels'
    product shapes and at B6's at Hs = 256, in f32 with TF32 off and on
    and in bf16 (a yardstick; the port never calls it)."""
    from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import PAIR_ENV, ConvTasNet
    from convtasnet_tpu_torch.ops.cuda import (
        tcn_block,
        tcn_block_bwd,
        tcn_block_pair,
        tcn_block_pair_bwd,
    )
    from convtasnet_tpu_torch.train import train_step as ts

    def nbytes(*ts_):
        return sum(t.numel() * t.element_size() for t in ts_)

    def timed(key, fn, iters, flops, n):
        res[key] = _ms(torch, fn, iters)
        _device_ms(torch, res, key, fn, iters)
        res[f"bound {key}"] = 1e3 * max(flops / PEAK_3XTF32, n / PEAK_BYTES_S)
        res[f"fma bound {key}"] = 1e3 * max(flops / PEAK_FLOPS["float32"],
                                            n / PEAK_BYTES_S)

    at = "[8,3199,256] H=512 d=1 float32"
    prod, conv = 2 * M * K * B * H, 2 * M * K * H * P
    bn = tuple(torch.rand(H, device="cuda") + 0.5 for _ in range(4))
    for label, norm, causal in (("b1 gLN", "gLN", False),
                                ("b1 cLN causal", "cLN", True),
                                ("b1 BN", "BN", False)):
        args, _ = _block_inputs(torch, "float32", 1, norm)
        kw = dict(dilation=1, causal=causal, norm_type=norm,
                  bn_stats=bn if norm == "BN" else None)
        with torch.inference_mode():
            timed(f"{label} {at}",
                  lambda: tcn_block.fused_tcn_block(*args, **kw), 20,
                  2 * prod + conv, nbytes(*args, args[0]))
    for label, norm, causal in (("b2 gLN", "gLN", False),
                                ("b3 cLN causal", "cLN", True)):
        args, g = _block_inputs(torch, "float32", 1, norm)
        fn = functools.partial(tcn_block_bwd.fused_tcn_block_bwd, args[0], g,
                               *args[1:], dilation=1, causal=causal,
                               norm_type=norm)
        timed(f"{label} {at}", fn, 10, 5 * prod + 3 * conv,
              nbytes(*args, g, *fn()))
    pa, g = _block_inputs(torch, "float32", 41, "gLN")
    pb, _ = _block_inputs(torch, "float32", 51, "gLN")
    x, pa, pb = pa[0], list(pa[1:]), list(pb[1:])
    kw = dict(d1=1, d2=2, causal=False)
    with torch.inference_mode():
        timed(f"b4 gLN {at}", lambda: tcn_block_pair.fused_tcn_block_pair(
            x, pa, pb, norm_type="gLN", **kw), 20, 4 * prod + 2 * conv,
            nbytes(x, *pa, *pb, x))
    fn = functools.partial(tcn_block_pair_bwd.fused_tcn_block_pair_bwd, x, g,
                           pa, pb, **kw)
    out = fn()
    timed(f"b5 gLN {at}", fn, 10, 2 * (5 * prod + 3 * conv),
          nbytes(x, g, *pa, *pb, out[0], *out[1], *out[2]))
    del out
    os.environ[PAIR_ENV] = "0"
    T = 4 * 8000
    cfg = ConvTasNetConfig(compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(21)
    mix = torch.randn(8, T, generator=gen, device="cuda")
    data = (mix, torch.full((8,), T, dtype=torch.int32, device="cuda"),
            torch.randn(8, 2, T, generator=gen, device="cuda"),
            torch.ones(8, device="cuda"))
    model = ConvTasNet(cfg, device="cuda").eval()
    with torch.inference_mode():
        key = "forward f32 gLN B=8 x 4 s"
        res[key] = _ms(torch, lambda: model(mix), 10)
        _device_ms(torch, res, key, lambda: model(mix), 10)
    del model
    step = ts.make_train_step()
    for norm in ("gLN", "cLN"):
        cfg = ConvTasNetConfig(compute_dtype="float32", norm_type=norm,
                               causal=norm == "cLN")
        state = ts.create_train_state(cfg, SolverConfig(), device="cuda",
                                      use_pallas=True)
        key = f"train step f32 {norm} B=8 x 4 s"
        res[key] = _ms(torch, lambda: step(state, data), 5)
        _device_ms(torch, res, key, lambda: step(state, data), 5)
        del state
    from convtasnet_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    if hasattr(lib, "ctn_tf32_matmul_check"):   # the core alone (this tree)
        for name in F32_PRODUCTS[:2]:
            r, k, n = PRODUCTS[name]
            a = torch.randn(r, k, device="cuda")
            b = torch.randn(n, k, device="cuda")
            ws = torch.empty(3 * n * k, device="cuda")
            c = torch.empty(r, n, device="cuda")
            _device_ms(torch, res, f"3xTF32 core {name} [{r},{k}]x[{k},{n}]",
                       lambda: lib.ctn_tf32_matmul_check(
                           a.data_ptr(), b.data_ptr(), ws.data_ptr(),
                           c.data_ptr(), r, n, k,
                           torch.cuda.current_stream().cuda_stream))
    for name in (*F32_PRODUCTS, "b6 (y g2) @ W_out Hs=256"):
        r, k, n = PRODUCTS[name]
        a = torch.randn(r, k, device="cuda")
        b = torch.randn(k, n, device="cuda")
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            _device_ms(torch, res, f"torch.matmul f32 tf32={int(tf32)} "
                       f"{name} [{r},{k}]x[{k},{n}]",
                       lambda: torch.matmul(a, b))
        torch.backends.cuda.matmul.allow_tf32 = False
        a, b = a.bfloat16(), b.bfloat16()
        _device_ms(torch, res, f"torch.matmul bf16 {name} [{r},{k}]x[{k},{n}]",
                   lambda: torch.matmul(a, b))


def _time_tp(torch, res: dict) -> None:
    """``--time tp``: B6 at ``B6_TIMED`` in bf16 and f32 (the widths this
    tree's rule takes), by CUDA events and device time, each width's bound
    (bf16 at 989 TFLOP/s, f32 at the 3xTF32 rate, or the bytes of h, the
    weights and z, the larger), and torch.matmul at each product's shape
    (f32 with TF32 off and on); then the f32 paper config's ``tp_forward``
    over two shards at B=8 x 4 s, events and device time."""
    from convtasnet_tpu_torch.ops.cuda import tcn_block_tp

    g = torch.Generator(device="cuda").manual_seed(31)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for hs, dilations in B6_TIMED:
            if tcn_block_tp.shape_refusal(hs, B, P, False):
                continue
            args = (torch.nn.functional.leaky_relu(rn(M, K, hs), 0.25).to(dt),
                    torch.stack([0.1 * rn(M), 1.0 + 0.1 * rn(M)], dim=-1),
                    rn(P, hs, scale=0.1), rn(hs, B, scale=hs ** -0.5),
                    torch.tensor(0.25, device="cuda"), 1.0 + 0.1 * rn(hs),
                    0.1 * rn(hs), 1.0 + 0.1 * rn(hs))
            for d in dilations:
                name = f"b6 {dtype} Hs={hs} d={d}"

                def call():
                    return tcn_block_tp.fused_tp_stage2(*args, dilation=d,
                                                        causal=False)

                with torch.inference_mode():
                    res[name] = _ms(torch, call, 20)
                    _device_ms(torch, res, name, call)
            n = sum(t.numel() * t.element_size() for t in args) \
                + M * K * B * args[0].element_size() + 2 * M * 4
            flops = 2 * M * K * hs * (B + P)
            res[f"bound b6 {dtype} Hs={hs}"] = 1e3 * max(
                flops / (PEAK_3XTF32 if dtype == "float32" else 989e12),
                n / PEAK_BYTES_S)
            a, w = rn(M * K, hs).to(dt), args[3].to(dt)
            for tf32 in ((False, True) if dtype == "float32" else (False,)):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                _device_ms(torch, res, f"torch.matmul {dtype}"
                           + (f" tf32={int(tf32)}" if dtype == "float32"
                              else "") + f" [{M * K},{hs}]x[{hs},{B}]",
                           lambda: torch.matmul(a, w))
            torch.backends.cuda.matmul.allow_tf32 = False
            del args, a, w
    # the f32 paper config's forward over two shards (64 B6 launches; f32
    # is the default dtype), by CUDA events and in device time
    from convtasnet_tpu_torch import ConvTasNetConfig
    from convtasnet_tpu_torch.models.conv_tasnet import ConvTasNet
    from convtasnet_tpu_torch.parallel.mesh import shard_devices
    from convtasnet_tpu_torch.parallel.tensor_parallel import tp_forward

    cfg = ConvTasNetConfig(compute_dtype="float32")
    sd = ConvTasNet(cfg, device="cuda").state_dict()
    mix = torch.randn(M, 4 * 8000, generator=g, device="cuda")
    devs = shard_devices(2, "cuda")
    name = "tcn tp forward float32 m=2 B=8 x 4 s"
    with torch.inference_mode():
        res[name] = _ms(torch, lambda: tp_forward(cfg, sd, mix, devs), 5)
        _device_ms(torch, res, name, lambda: tp_forward(cfg, sd, mix, devs),
                   5)


def time_tree(path: str, what: str) -> None:
    """Times one tree into path: everything (``what`` "all") or the DPT
    forwards alone ("dpt-forward": ``_time_dpt_forwards`` and the
    forwards' products)."""
    import torch

    from convtasnet_tpu_torch import ConvTasNetConfig, SolverConfig
    from convtasnet_tpu_torch.models.conv_tasnet import PAIR_ENV, ConvTasNet
    from convtasnet_tpu_torch.ops.cuda import tcn_block, tcn_block_bwd
    from convtasnet_tpu_torch.train import train_step as ts

    os.environ[PAIR_ENV] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(33)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    if what == "f32-attention":
        _time_f32_attention(torch, res, rn)
        _time_f32_intra_long(torch, res, rn)
        torch.save(res, path)
        return
    if what == "padded":
        _time_padded(torch, res, rn)
        torch.save(res, path)
        return
    if what == "taps":
        _time_taps(torch, res)
        torch.save(res, path)
        return
    if what == "tp":
        _time_tp(torch, res)
        torch.save(res, path)
        return
    if what == "f32":
        _time_f32(torch, res)
        torch.save(res, path)
        return
    _time_dpt_forwards(torch, res, rn)
    if what == "dpt-forward":
        _time_products(torch, res, ("b7/b9 ", "b7-b10 ", "b11/b12 y", "b11/b12 h"))
        torch.save(res, path)
        return
    args, g = _block_inputs(torch, "bfloat16", 7, "gLN")
    for d in DILATIONS:
        for label, norm, causal in (("b1 gLN", "gLN", False),
                                    ("b1 cLN causal", "cLN", True)):
            with torch.inference_mode():
                res[f"{label} d={d}"] = _ms(
                    torch, lambda: tcn_block.fused_tcn_block(
                        *args, dilation=d, causal=causal, norm_type=norm), 20)
        for label, norm, causal in (("b2 gLN", "gLN", False),
                                    ("b3 cLN causal", "cLN", True)):
            res[f"{label} d={d}"] = _ms(
                torch, lambda: tcn_block_bwd.fused_tcn_block_bwd(
                    args[0], g, *args[1:], dilation=d, causal=causal,
                    norm_type=norm), 20)
    pb = list(_block_inputs(torch, "bfloat16", 8, "gLN")[0][1:])
    _time_pairs(torch, res, "", args[0], g, list(args[1:]), pb,
                (("gLN", "gLN", False), ("cLN causal", "cLN", True)))
    # f32 (its 3xTF32 stages), and bf16 at a width the Hopper stages do
    # not take (the first design's launches)
    f32 = [t.float() for t in (args[0], g)]
    _time_pairs(torch, res, " f32", *f32, [t.float() for t in args[1:]],
                [t.float() for t in pb], (("gLN", "gLN", False),))
    narrow, g192 = _block_inputs(torch, "bfloat16", 9, "gLN", H=192)
    pb192 = list(_block_inputs(torch, "bfloat16", 10, "gLN", H=192)[0][1:])
    _time_pairs(torch, res, " H=192", narrow[0], g192, list(narrow[1:]),
                pb192, (("gLN", "gLN", False),))
    T = 4 * 8000
    cfg = ConvTasNetConfig(compute_dtype="bfloat16")
    for batch in (8, 24):
        gen = torch.Generator(device="cuda").manual_seed(21)
        mix = torch.randn(batch, T, generator=gen, device="cuda")
        data = (mix, torch.full((batch,), T, dtype=torch.int32,
                                device="cuda"),
                torch.randn(batch, 2, T, generator=gen, device="cuda"),
                torch.ones(batch, device="cuda"))
        for pairs in ("off", "on"):
            os.environ[PAIR_ENV] = "1" if pairs == "on" else "0"
            at = f"B={batch} x 4 s pairs {pairs}"
            model = ConvTasNet(cfg, device="cuda").eval()
            with torch.inference_mode():
                res[f"forward {at}"] = _ms(torch, lambda: model(mix), 10)
                res[f"peak GiB forward {at}"] = _peak_gib(
                    torch, lambda: model(mix))
            del model
            state = ts.create_train_state(cfg, SolverConfig(), device="cuda",
                                          use_pallas=True)
            step = ts.make_train_step()
            res[f"train step gLN {at}"] = _ms(
                torch, lambda: step(state, data), 10)
            res[f"peak GiB train step gLN {at}"] = _peak_gib(
                torch, lambda: step(state, data))
            del state
        os.environ[PAIR_ENV] = "0"
        if batch == 8:
            state = ts.create_train_state(ConvTasNetConfig(
                compute_dtype="bfloat16", norm_type="cLN", causal=True),
                SolverConfig(), device="cuda", use_pallas=True)
            step = ts.make_train_step()
            res["train step cLN causal B=8 x 4 s"] = _ms(
                torch, lambda: step(state, data), 10)
            del state
    _time_tp_and_ffn(torch, res)
    _time_products(torch, res, ("",))
    torch.save(res, path)


def _time_products(torch, res: dict, prefixes: tuple) -> None:
    """torch.matmul at the shapes of the ``PRODUCTS`` whose names start
    with one of prefixes."""
    for name, (r, k, n) in PRODUCTS.items():
        if not name.startswith(prefixes):
            continue
        a = torch.randn(r, k, device="cuda").bfloat16()
        b = torch.randn(k, n, device="cuda").bfloat16()
        res[f"torch.matmul {name} [{r},{k}]x[{k},{n}]"] = _ms(
            torch, lambda: torch.matmul(a, b), 20)


def _run(mode: str, root: str, path: str, cwd: str, *extra) -> None:
    subprocess.run([sys.executable, os.path.abspath(__file__), mode, path,
                    *extra], check=True, cwd=cwd,
                   env=dict(os.environ, PYTHONPATH=root))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="directory holding the other checkout's "
                                    "convtasnet_tpu_torch/")
    ap.add_argument("--time", nargs="?", const="all",
                    choices=["all", "dpt-forward", "f32", "f32-attention",
                             "padded", "taps", "tp"],
                    help="also time both trees in turns: everything (the "
                         "default), the DPT forwards alone, the f32 "
                         "attention kernels at every head width, the DPT "
                         "kernels at widths off 64 beside the next one on "
                         "the tile, the TCN kernels at 3, 17 and 33 taps, "
                         "B6 at shard widths 128 to 1024, or the f32 TCN "
                         "kernels and model on their 3xTF32 stages")
    ap.add_argument("--out", help="write every number here as JSON")
    ap.add_argument("--dump", help=argparse.SUPPRESS)
    ap.add_argument("--time-dump", help=argparse.SUPPRESS)
    ap.add_argument("--time-what", default="all", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.dump:
        dump(a.dump)
        return 0
    if a.time_dump:
        time_tree(a.time_dump, a.time_what)
        return 0
    import torch

    roots = {"this": REPO, "other": os.path.abspath(a.other)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    report = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        outs = {}
        for tree in ("this", "other"):
            path = os.path.join(tmp, f"{tree}.pt")
            _run("--dump", roots[tree], path, tmp)
            outs[tree] = torch.load(path)
        lines, bad = compare(outs["this"], outs["other"])
        for line in lines:
            print(f"kernels vs the other checkout, {line}", flush=True)
        n_bits = sum(1 for k in outs["other"]
                     if bitwise(k) and not k.startswith(TWINS + (F64,)))
        n_diff = sum(1 for k in bad if bitwise(k))
        print(f"{n_bits - n_diff} of {n_bits} bit-for-bit outputs the same "
              f"bits; {len(bad) - n_diff} outputs held by distance past "
              f"their bars", flush=True)
        n_same, n_all = same_bits(outs["this"], outs["other"])
        print(f"{n_same} of {n_all} outputs in all the same bits", flush=True)
        for line in f64_lines(outs["this"], outs["other"]):
            print(f"kernels vs the other checkout, {line}", flush=True)
        report["compare"] = lines
        if a.time:
            turns = []
            for i, tree in enumerate(("other", "this", "this", "other")):
                path = os.path.join(tmp, f"time{i}.pt")
                _run("--time-dump", roots[tree], path, tmp, "--time-what",
                     a.time)
                turns.append((tree, torch.load(path)))
            for line in summarize(turns):
                print(f"timing: {line}", flush=True)
            report["turns"] = turns
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
